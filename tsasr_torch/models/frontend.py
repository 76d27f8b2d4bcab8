"""Convolutional subsampling frontend.

Counterpart of the JAX package's ``models/frontend.py`` (``ConvBlock``,
``ConvolutionFrontEnd``) with one conv per block, as the recipes use:
"same" padding, causal padding, and streaming through per-block caches
of the last ``kernel_size - 1`` input rows. The public layout is JAX's
channels-last (B, T, F, C), so the encoder's flatten to F*C orders
features as the reference does; convolutions run in NCHW inside. Traps
kept:

- ``same`` padding is REFLECT padding of k//2 on time and frequency;
- ``causal`` padding is ZERO padding of k-1 rows before the first frame
  and k//2 on frequency (JAX's deviation from the reference's reflect,
  so that a zero-initialised stream cache is exactly the offline left
  padding); the recipe's ``frontend_padding`` picks it
  (``causal_from_padding``);
- the LayerNorm normalizes (F, C) jointly with a per-(F, C) affine and
  eps 1e-5;
- the 1x1 residual conv has the block's stride;
- the activation is leaky_relu with slope 0.01;
- dropout follows the activation and the residual sum, as in the JAX
  ``ConvBlock``; ``forward`` takes the JAX ``deterministic`` switch and
  the step's ``generator``.

``dtype`` is the compute dtype: in bf16 the f32 features are cast to bf16
at the first convolution, and the convolutions and LayerNorms return
bf16 (``models.layers``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from tsasr_torch.models.layers import Conv2d, LayerNorm
from tsasr_torch.ops.dropout import Dropout
from tsasr_torch.utils.precision import cast


FRONTEND_PADDINGS = {"same": False, "causal": True}


def causal_from_padding(padding):
    """The recipe's ``frontend_padding`` ("same" or "causal") as the
    model's ``frontend_causal``; any other value raises."""
    if padding not in FRONTEND_PADDINGS:
        raise ValueError(f"frontend_padding {padding!r} is not one of "
                         f"{sorted(FRONTEND_PADDINGS)}")
    return FRONTEND_PADDINGS[padding]


class ConvBlock(nn.Module):
    """conv -> LN(F, C) -> leaky_relu, plus a strided 1x1 residual."""

    def __init__(self, in_channels, out_channels, freq_in, kernel_size=3,
                 stride=1, residual=True, dropout=0.0, dropout_bits=32,
                 causal=False, dtype=torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.causal = causal
        self.dtype = dtype
        self.pad = kernel_size // 2 if stride > 1 else (kernel_size - 1) // 2
        freq_out = -(-freq_in // stride)
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=stride, compute_dtype=dtype)
        self.norm = LayerNorm((freq_out, out_channels), eps=1e-5,
                              compute_dtype=dtype)
        self.dropout = Dropout(dropout, dropout_bits)
        self.residual_conv = self.residual_norm = None
        if residual:
            self.residual_conv = Conv2d(in_channels, out_channels, 1,
                                        stride=stride, compute_dtype=dtype)
            self.residual_norm = LayerNorm((freq_out, out_channels),
                                           eps=1e-5, compute_dtype=dtype)

    def forward(self, x, deterministic=True, generator=None,
                block_cache=None):
        """x: (B, T, F, C) -> (B, ceil(T/s), ceil(F/s), C_out).

        Streaming (causal): ``block_cache`` (B, kernel_size - 1, F, C)
        holds the input rows before x (zeros at the start), x a multiple
        of the stride of new rows; returns (out, new cache)."""
        x = cast(x, self.dtype)
        x_nchw = x.permute(0, 3, 1, 2)
        freq_pad = (self.pad, self.pad)
        if block_cache is not None:
            ext = torch.cat([block_cache, x], dim=1)
            y = F.pad(ext.permute(0, 3, 1, 2), freq_pad)
        elif self.causal:
            y = F.pad(x_nchw, freq_pad + (self.kernel_size - 1, 0))
        else:
            y = F.pad(x_nchw, (self.pad,) * 4, mode="reflect")
        y = self.conv(y).permute(0, 2, 3, 1)
        out = self.dropout(F.leaky_relu(self.norm(y), 0.01), deterministic,
                           generator)
        if self.residual_conv is not None:
            res = self.residual_conv(x_nchw).permute(0, 2, 3, 1)
            out = self.dropout(out + self.residual_norm(res), deterministic,
                               generator)
        if block_cache is not None:
            return out, ext[:, ext.shape[1] - (self.kernel_size - 1):]
        return out


class ConvolutionFrontEnd(nn.Module):
    """Stack of ConvBlocks; (B, T, F) features gain a channel axis."""

    def __init__(self, n_mels=80, out_channels=(128, 128),
                 kernel_sizes=(3, 3), strides=(2, 2),
                 residuals=(True, True), dropout=0.0, dropout_bits=32,
                 causal=False, dtype=torch.float32):
        super().__init__()
        blocks = []
        ch, freq = 1, n_mels
        for out_ch, k, s, r in zip(out_channels, kernel_sizes, strides,
                                   residuals):
            blocks.append(ConvBlock(ch, out_ch, freq, k, s, r, dropout,
                                    dropout_bits, causal, dtype))
            ch, freq = out_ch, -(-freq // s)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, deterministic=True, generator=None,
                stream_caches=None):
        """x: (B, T, F) features -> (B, T', F', C). Streaming (causal):
        ``stream_caches`` holds each block's cache, x a multiple of the
        strides' product of new frames; returns (out, new caches)."""
        if x.dim() == 3:
            x = x[..., None]
        if stream_caches is None:
            for block in self.blocks:
                x = block(x, deterministic, generator)
            return x
        caches = []
        for block, cache in zip(self.blocks, stream_caches):
            x, cache = block(x, block_cache=cache)
            caches.append(cache)
        return x, caches

    @staticmethod
    def output_length(in_length, strides=(2, 2)):
        """Subsampled length for 'same' padding (ceil division chain)."""
        out = in_length
        for s in strides:
            out = -(-out // s)
        return out
