"""Device resolution for the port's entry points.

The port runs on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and asking for CUDA on a host without it raises
instead of falling back. In a launched run a bare ``"cuda"`` is the
rank's own card, ``cuda:{LOCAL_RANK}`` (``parallel.distributed``).
"""

import torch

from tsasr_torch.parallel.distributed import rank_device


def resolve_device(device="cuda"):
    """Turn ``device`` into a ``torch.device``; raise if CUDA is absent.

    On CUDA this also turns TF32 off for matmuls and cuDNN convolutions:
    the slice runs in full f32 like the reference, and a TF32 STFT
    visibly moves the log-mel features. It also keeps cuBLAS from
    reducing bf16 products in bf16 (split-K): XLA sums a bf16 product in
    f32, and so does a bf16 model here.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was asked for but CUDA is not "
                "available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        device = rank_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return device
