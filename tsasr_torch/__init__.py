"""TS-ASR on PyTorch and CUDA: the port of the JAX package to one NVIDIA H100.

The JAX package stays the reference; this package keeps its module names
(its ``X`` maps to ``tsasr_torch.X``) so each piece has a named
counterpart, and imports nothing of it. What is ported so far is the
offline serving path and the ``scratch`` recipe's experiment end to end
(``python -m tsasr_torch.train_librispeechmix_scratch``):

- ``tsasr_torch.ops``        Fbank features, input normalization, masks,
                             dropout, the RNN-T loss (fused joint).
- ``tsasr_torch.kernels``    hand-written CUDA kernels (fused rel-pos
                             attention, the RNN-T lattice), each with its
                             plain PyTorch version.
- ``tsasr_torch.models``     the TS-Conformer transducer as ``nn.Module``s.
- ``tsasr_torch.decoding``   greedy transducer search.
- ``tsasr_torch.data``       manifests, mixing, tokenizers, dynamic
                             batching and the checkpointable loader.
- ``tsasr_torch.training``   the Brain's loop, AdamW, Noam, checkpoints,
                             the experiment CLI.
- ``tsasr_torch.recipes``    the LibriSpeechMix recipe (``scratch``).
- ``tsasr_torch.inference``  ``TSASRTranscriber``.
- ``tsasr_torch.convert``    flax params -> ``state_dict`` and back.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU,
and raise when CUDA is asked for and absent (``tsasr_torch.device``).
"""

__version__ = "0.1.0"

from tsasr_torch.device import resolve_device  # noqa: F401
