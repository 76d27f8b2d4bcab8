"""TS-ASR on PyTorch and CUDA: the port of the JAX package to one NVIDIA H100.

The JAX package stays the reference; this package keeps its module names
(its ``X`` maps to ``tsasr_torch.X``) so each piece has a named
counterpart, and imports nothing of it. What is ported so far is the
offline serving path, the three LibriSpeechMix recipes' experiments end
to end with train-time augmentation (``python -m
tsasr_torch.train_librispeechmix_{scratch,none,pretrained}``) and
decoding as the recipes configure it (the batched and exact beams, LM
fusion, checkpoint loading and the transcription tools):

- ``tsasr_torch.ops``        Fbank features, input normalization, masks,
                             dropout, SpecAugment and speed perturbation,
                             the RNN-T loss (fused joint).
- ``tsasr_torch.kernels``    hand-written CUDA kernels (fused rel-pos
                             attention, the RNN-T lattice), each with its
                             plain PyTorch version.
- ``tsasr_torch.models``     the TS-Conformer transducer as ``nn.Module``s;
                             the WavLM x-vector speaker encoder.
- ``tsasr_torch.decoding``   greedy search, the batched and the exact
                             transducer beams.
- ``tsasr_torch.lm``         backoff n-gram LMs, ARPA, the dense fusion
                             table; ``models.lm`` holds the RNN-LM.
- ``tsasr_torch.data``       manifests, mixing, tokenizers, dynamic
                             batching and the checkpointable loader.
- ``tsasr_torch.training``   the Brain's loop, AdamW, Noam, checkpoints,
                             the experiment CLI.
- ``tsasr_torch.recipes``    the LibriSpeechMix recipe (``none``,
                             ``scratch``, ``pretrained`` with its frozen
                             speaker encoder).
- ``tsasr_torch.inference``  ``TSASRTranscriber`` (``from_experiment``,
                             ``transcribe_file``).
- ``tsasr_torch.tools``      the synthetic corpus, ``transcribe``,
                             ``average_checkpoints``, ``train_ngram_lm``.
- ``tsasr_torch.convert``    flax params -> ``state_dict`` and back (the
                             transducer; the RNN-LM and WavLM one way).

Entry points run on ``device="cuda"`` unless the caller asks for the CPU,
and raise when CUDA is asked for and absent (``tsasr_torch.device``).
"""

__version__ = "0.1.0"

from tsasr_torch.device import resolve_device  # noqa: F401
