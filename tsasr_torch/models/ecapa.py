"""ECAPA-TDNN speaker encoder: the ``speaker_encoder_type: ecapa`` branch.

Counterpart of the JAX package's ``models/ecapa.py`` (``TDNNBlock``,
``Res2NetBlock``, ``_masked_mean``, ``SEBlock``,
``AttentiveStatisticsPooling``, ``SERes2NetBlock``, ``ECAPAConfig``,
``ECAPA_TDNN``) with the flax module names. Inputs and outputs are
channels-last as in JAX ((B, T, F) features in, (B, 1, E) embeddings
out); the convolutions run on torch's (B, C, T) inside. Traps kept from
the reference:

- a TDNN block is a reflect-padded ("same") dilated conv -> ReLU ->
  BatchNorm;
- the Res2Net cascade runs its chunks in split order, chunk 0 passed
  through, chunk i > 1 added to block i-1's output first;
- ``_masked_mean`` takes ``round(rel * T)`` frames (the speaker pool of
  the Conformer branch takes the ceiling), with at least one;
- attentive statistics pooling clamps the variance at 1e-12 before the
  square root and masks padded frames with -1e30 before the softmax.

BatchNorm runs on its running statistics, in training too
(``FrozenBatchNorm``), and the port holds them fixed: they are buffers,
which no gradient and no optimizer step reaches, so a ``state_dict`` (and
a checkpoint) carries them unchanged; ``convert`` maps them to flax's
``batch_stats``. This is a deliberate deviation from the JAX package.
The JAX model calls ECAPA with ``train=False`` (its "frozen-BN
convention"), so its BatchNorm never updates the statistics from batch
moments; but the JAX recipe's ``_init_params`` returns the whole
``model.init`` tree and its train step differentiates all of it, so
there the statistics get gradients, count in the clip norm and take
AdamW steps, weight decay included, which pulls the variances towards 0
with nothing to keep them above -eps. The port keeps what the JAX
comment intends (``tests/test_torch_ecapa.py::
test_statistics_get_gradients_in_jax_and_stay_fixed_in_the_port``).

``dtype`` is the compute dtype: the convolutions run in it, the
BatchNorm in f32 with one rounding (flax's ``_normalize`` with f32
statistics), the pooling's statistics in it.

Also here, off the recipe's path and served by
``inference.speaker`` / ``inference.classifier``: the cosine
``CosineClassifier`` head and the classic ``Xvector`` TDNN, each
inference-only (BatchNorm on running statistics, ``FrozenBatchNorm``).
``CosineClassifier`` takes its input width at construction, where flax
infers it; ``Xvector``'s Gaussian noise on the pooled mean (the JAX
``noise_rng``) draws from an explicit ``torch.Generator``.
"""

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tsasr_torch.models.layers import Conv1d, Linear
from tsasr_torch.ops.masks import relative_to_absolute_lengths
from tsasr_torch.utils.precision import cast

NEG = -1e30
BN_EPS = 1e-5


class FrozenBatchNorm(nn.Module):
    """BatchNorm on running statistics only, over the channel axis 1:
    ``(x - mean) * rsqrt(var + eps) * weight + bias`` in f32, rounded to
    ``dtype`` once."""

    def __init__(self, channels, eps=BN_EPS, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.var + self.eps) * self.weight
        y = (x.to(mul.dtype) - self.mean.view(shape)) * mul.view(shape) \
            + self.bias.view(shape)
        return cast(y, self.dtype)


class TDNNBlock(nn.Module):
    """Reflect-padded dilated Conv1d -> ReLU -> BatchNorm on (B, C, T)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, dilation=1,
                 groups=1, dtype=torch.float32):
        super().__init__()
        self.pad = dilation * (kernel_size - 1) // 2
        self.conv = Conv1d(in_channels, out_channels, kernel_size,
                           dilation=dilation, groups=groups,
                           compute_dtype=dtype)
        self.norm = FrozenBatchNorm(out_channels, dtype=dtype)

    def forward(self, x):
        if self.pad:
            x = F.pad(x, (self.pad, self.pad), mode="reflect")
        return self.norm(torch.relu(self.conv(x)))


class Res2NetBlock(nn.Module):
    """Split the channels into ``scale`` chunks; chunk 0 passes, chunk i
    goes through TDNN block i-1 (after adding block i-2's output)."""

    def __init__(self, channels, scale=8, kernel_size=3, dilation=1,
                 dtype=torch.float32):
        super().__init__()
        self.scale = scale
        hidden = channels // scale
        self.blocks = nn.ModuleList(
            TDNNBlock(hidden, hidden, kernel_size, dilation, dtype=dtype)
            for _ in range(scale - 1))

    def forward(self, x):
        chunks = x.chunk(self.scale, dim=1)
        outs, y = [chunks[0]], None
        for i, block in enumerate(self.blocks, start=1):
            y = block(chunks[i] if i == 1 else chunks[i] + y)
            outs.append(y)
        return torch.cat(outs, dim=1)


def _masked_mean(x, rel_lengths):
    """(B, C, T) -> (mean over the valid frames (B, C, 1), mask (B, 1, T)
    or None); ``round(rel * T)`` valid frames, at least one counted."""
    T = x.shape[-1]
    if rel_lengths is None:
        return x.mean(dim=-1, keepdim=True), None
    abs_len = torch.round(rel_lengths * T).to(torch.int32)
    mask = (torch.arange(T, device=x.device)[None, :]
            < abs_len[:, None])[:, None, :]
    total = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1)
    return (x * mask).sum(dim=-1, keepdim=True) / total, mask


class SEBlock(nn.Module):
    """Squeeze-excitation with the masked mean as the squeeze."""

    def __init__(self, in_channels, se_channels, out_channels,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv1d(in_channels, se_channels, 1, compute_dtype=dtype)
        self.conv2 = Conv1d(se_channels, out_channels, 1, compute_dtype=dtype)

    def forward(self, x, rel_lengths=None):
        s, _ = _masked_mean(x, rel_lengths)
        s = torch.sigmoid(self.conv2(torch.relu(self.conv1(s))))
        return s * x


class AttentiveStatisticsPooling(nn.Module):
    """(B, C, T) -> attention-weighted mean and std (B, 2C, 1), the
    attention fed the global masked mean and std (``global_context``)."""

    def __init__(self, channels, attention_channels=128, global_context=True,
                 eps=1e-12, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.global_context = global_context
        self.tdnn = TDNNBlock(3 * channels if global_context else channels,
                              attention_channels, 1, 1, dtype=dtype)
        self.conv = Conv1d(attention_channels, channels, 1,
                           compute_dtype=dtype)

    def _stats(self, values, weights):
        mean = (weights * values).sum(dim=-1, keepdim=True)
        var = (weights * (values - mean) ** 2).sum(dim=-1, keepdim=True)
        return mean, torch.sqrt(torch.clamp(var, min=self.eps))

    def forward(self, x, rel_lengths=None):
        B, C, T = x.shape
        if rel_lengths is None:
            rel_lengths = torch.ones(B, dtype=x.dtype, device=x.device)
        abs_len = torch.round(rel_lengths * T).to(torch.int32)
        mask = (torch.arange(T, device=x.device)[None, :]
                < abs_len[:, None])[:, None, :]
        if self.global_context:
            total = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1)
            mean, std = self._stats(x, mask / total)
            attn = torch.cat([x, mean.expand(B, C, T), std.expand(B, C, T)],
                             dim=1)
        else:
            attn = x
        attn = self.conv(torch.tanh(self.tdnn(attn)))
        attn = torch.softmax(attn.masked_fill(~mask, NEG), dim=-1)
        mean, std = self._stats(x, attn)
        return torch.cat([mean, std], dim=1)


class SERes2NetBlock(nn.Module):
    """1x1 TDNN -> Res2Net -> 1x1 TDNN -> SE, plus the residual (a 1x1
    ``shortcut`` conv when the widths differ)."""

    def __init__(self, in_channels, out_channels, res2net_scale=8,
                 se_channels=128, kernel_size=1, dilation=1, groups=1,
                 dtype=torch.float32):
        super().__init__()
        self.shortcut = Conv1d(in_channels, out_channels, 1,
                               compute_dtype=dtype) \
            if in_channels != out_channels else None
        self.tdnn1 = TDNNBlock(in_channels, out_channels, 1, 1, groups, dtype)
        self.res2net = Res2NetBlock(out_channels, res2net_scale, kernel_size,
                                    dilation, dtype)
        self.tdnn2 = TDNNBlock(out_channels, out_channels, 1, 1, groups,
                               dtype)
        self.se = SEBlock(out_channels, se_channels, out_channels, dtype)

    def forward(self, x, rel_lengths=None):
        residual = x if self.shortcut is None else self.shortcut(x)
        x = self.tdnn2(self.res2net(self.tdnn1(x)))
        return self.se(x, rel_lengths) + residual


@dataclass(frozen=True)
class ECAPAConfig:
    input_size: int = 80
    lin_neurons: int = 192
    channels: Sequence[int] = (512, 512, 512, 512, 1536)
    kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1)
    dilations: Sequence[int] = (1, 2, 3, 4, 1)
    attention_channels: int = 128
    res2net_scale: int = 8
    se_channels: int = 128
    global_context: bool = True
    dtype: torch.dtype = torch.float32


class ECAPA_TDNN(nn.Module):
    """Features (B, T, F) + relative lengths -> embeddings (B, 1, E).

    ``blocks``: the first TDNN block, then the SE-Res2Net blocks (flax's
    ``block_0`` .. ``block_{n-2}``); ``mfa`` aggregates the SE-Res2Net
    outputs, ``asp`` pools, ``asp_bn`` normalises and ``fc`` projects."""

    def __init__(self, config=None):
        super().__init__()
        c = config or ECAPAConfig()
        self.config = c
        ch, dt = tuple(c.channels), c.dtype
        blocks = [TDNNBlock(c.input_size, ch[0], c.kernel_sizes[0],
                            c.dilations[0], dtype=dt)]
        for i in range(1, len(ch) - 1):
            blocks.append(SERes2NetBlock(
                ch[i - 1], ch[i], c.res2net_scale, c.se_channels,
                c.kernel_sizes[i], c.dilations[i], dtype=dt))
        self.blocks = nn.ModuleList(blocks)
        self.mfa = TDNNBlock(sum(ch[1:-1]), ch[-1], c.kernel_sizes[-1],
                             c.dilations[-1], dtype=dt)
        self.asp = AttentiveStatisticsPooling(
            ch[-1], c.attention_channels, c.global_context, dtype=dt)
        self.asp_bn = FrozenBatchNorm(2 * ch[-1], dtype=dt)
        self.fc = Conv1d(2 * ch[-1], c.lin_neurons, 1, compute_dtype=dt)

    def forward(self, x, rel_lengths=None):
        x = self.blocks[0](x.transpose(1, 2))
        outs = []
        for block in self.blocks[1:]:
            x = block(x, rel_lengths)
            outs.append(x)
        x = self.mfa(torch.cat(outs, dim=1))
        x = self.asp_bn(self.asp(x, rel_lengths))
        return self.fc(x).transpose(1, 2)


class CosineClassifier(nn.Module):
    """The reference ECAPA ``Classifier``: ``lin_blocks`` of BatchNorm ->
    Linear, then the cosine of the features against each class weight
    (both L2-normalised, the norms clamped at 1e-12). Features (..., E)
    -> scores (..., out_neurons); flax's ``norm_{i}``, ``linear_{i}`` are
    ``norms.{i}``, ``linears.{i}``."""

    def __init__(self, input_size, out_neurons, lin_blocks=0,
                 lin_neurons=192, dtype=torch.float32):
        super().__init__()
        widths = [input_size] + [lin_neurons] * lin_blocks
        self.norms = nn.ModuleList(FrozenBatchNorm(w, dtype=dtype)
                                   for w in widths[:-1])
        self.linears = nn.ModuleList(
            Linear(a, b, compute_dtype=dtype)
            for a, b in zip(widths[:-1], widths[1:]))
        self.weight = nn.Parameter(torch.empty(out_neurons, widths[-1]))
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x):
        for norm, linear in zip(self.norms, self.linears):
            x = linear(norm(x.movedim(-1, 1)).movedim(1, -1))
        weight = cast(self.weight, x.dtype)
        return F.normalize(x, dim=-1, eps=1e-12) \
            @ F.normalize(weight, dim=-1, eps=1e-12).t()


@dataclass(frozen=True)
class XvectorConfig:
    in_channels: int = 40
    tdnn_blocks: int = 5
    tdnn_channels: Sequence[int] = (512, 512, 512, 512, 1500)
    tdnn_kernel_sizes: Sequence[int] = (5, 3, 3, 1, 1)
    tdnn_dilations: Sequence[int] = (1, 2, 3, 1, 1)
    lin_neurons: int = 512
    dtype: torch.dtype = torch.float32


class Xvector(nn.Module):
    """The classic x-vector TDNN (reference ``lobes/models/Xvector.py``):
    ``tdnn_blocks`` of reflect-padded ("same") dilated Conv1d ->
    LeakyReLU -> BatchNorm, statistics pooling over the valid frames
    (``round(rel * T)``, at least one: the mean and the unbiased std,
    plus 1e-5), then a Linear. Features (B, T, F) -> (B, 1, lin_neurons).
    ``generator`` adds Gaussian noise of scale 1e-5 to the mean, as the
    reference does in training; without it the output is deterministic.
    Flax's ``conv_{i}``, ``norm_{i}`` are ``convs.{i}``, ``norms.{i}``."""

    def __init__(self, config=None):
        super().__init__()
        c = config or XvectorConfig()
        self.config = c
        widths = [c.in_channels, *c.tdnn_channels[:c.tdnn_blocks]]
        self.convs = nn.ModuleList(
            Conv1d(a, b, k, dilation=d, padding=d * (k - 1) // 2,
                   padding_mode="reflect", compute_dtype=c.dtype)
            for a, b, k, d in zip(widths[:-1], widths[1:],
                                  c.tdnn_kernel_sizes, c.tdnn_dilations))
        self.norms = nn.ModuleList(FrozenBatchNorm(w, dtype=c.dtype)
                                   for w in widths[1:])
        self.out = Linear(2 * widths[-1], c.lin_neurons,
                          compute_dtype=c.dtype)

    def forward(self, x, rel_lengths=None, generator=None):
        x = x.transpose(1, 2)
        for conv, norm in zip(self.convs, self.norms):
            x = norm(F.leaky_relu(conv(x), 0.01))
        T = x.shape[-1]
        if rel_lengths is None:
            mean, std = x.mean(dim=-1), x.std(dim=-1, correction=1)
        else:
            abs_len = relative_to_absolute_lengths(rel_lengths, T)
            mask = (torch.arange(T, device=x.device)[None, :]
                    < abs_len[:, None])[:, None, :]
            count = torch.clamp(mask.sum(dim=-1), min=1).to(x.dtype)
            mean = (x * mask).sum(dim=-1) / count
            var = ((x - mean[..., None]) ** 2 * mask).sum(dim=-1) \
                / torch.clamp(count - 1.0, min=1.0)
            std = torch.sqrt(var)
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=generator.device)
            mean = mean + noise.to(mean) * 1e-5
        stats = torch.cat([mean, std + 1e-5], dim=-1)[:, None, :]
        return self.out(stats)
