"""Train, validate and test the LibriSpeechMix ``scratch`` recipe on
tsasr_torch (the Conformer speaker encoder trained jointly).

    python -m tsasr_torch.train_librispeechmix_scratch \\
        tsasr_torch/hparams/LibriSpeechMix/conformer-t_scratch.yaml \\
        --data_folder <dir> [--device cpu] [--<hparam> <value> ...]

Runs on the card unless ``--device cpu`` is given. A second invocation
with the same output folder recovers the newest checkpoint and
continues (``--num_epochs`` larger to train on).
"""

import sys

from tsasr_torch.recipes.librispeechmix import run_experiment


def main(argv=None):
    run_experiment(variant="scratch", argv=argv)


if __name__ == "__main__":
    main(sys.argv[1:])
