"""Train, validate and test the LibriSpeechMix ``pretrained`` recipe on
tsasr_torch: the transducer conditioned on d-vectors of a frozen WavLM
x-vector model, computed from the enrollments on the device in every
step.

    python -m tsasr_torch.train_librispeechmix_pretrained \\
        tsasr_torch/hparams/LibriSpeechMix/conformer-t_wavlm.yaml \\
        --data_folder <dir> --speaker_encoder_path <checkpoint dir> \\
        [--device cpu] [--<hparam> <value> ...]

``--speaker_encoder_path`` is a local HF ``WavLMForXVector`` checkpoint
directory (``config.json`` + ``model.safetensors`` or
``pytorch_model.bin``), e.g. a copy of microsoft/wavlm-base-sv; a hub id
raises before anything runs. Runs on the card unless ``--device cpu`` is
given.
"""

import sys

from tsasr_torch.recipes.librispeechmix import run_experiment


def main(argv=None):
    run_experiment(variant="pretrained", argv=argv)


if __name__ == "__main__":
    main(sys.argv[1:])
