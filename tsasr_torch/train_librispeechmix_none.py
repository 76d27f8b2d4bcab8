"""Train, validate and test the LibriSpeechMix ``none`` recipe on
tsasr_torch: a plain transducer on the mixtures, no speaker
conditioning.

    python -m tsasr_torch.train_librispeechmix_none \\
        tsasr_torch/hparams/LibriSpeechMix/conformer-t_none.yaml \\
        --data_folder <dir> [--device cpu] [--<hparam> <value> ...]

Runs on the card unless ``--device cpu`` is given. A second invocation
with the same output folder recovers the newest checkpoint and
continues.
"""

import sys

from tsasr_torch.recipes.librispeechmix import run_experiment


def main(argv=None):
    run_experiment(variant="none", argv=argv)


if __name__ == "__main__":
    main(sys.argv[1:])
