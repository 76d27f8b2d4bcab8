"""Conformer encoder with target-speaker embedding injection.

Counterpart of the JAX package's ``models/conformer.py`` (``FeedForward``,
``ConvolutionModule``, ``ConformerEncoderLayer``, ``TSConformerEncoder``)
with every injection mode (``prod``, ``sum``, ``cat``,
``cross_attention`` and ``None``), rematerialized layers (``remat``),
causal (``causal``: the lookahead mask and a left-padded depthwise
conv), with a bounded
attention context (``att_context_size``) and streaming (``stream_states``:
per layer a KV cache and the conv's last ``kernel_size - 1`` frames).
Dropout sits where the JAX modules put it: inside each FFN, after each
half-FFN, after the conv module, on the attention probabilities and
after ``input_proj``; every ``forward`` takes the JAX ``deterministic``
switch and the step's ``generator``. Traps kept from
the reference:

- the FFNs and the conv module use leaky_relu (slope 0.01): the encoder
  overrides the layer's swish default;
- every LayerNorm has eps 1e-6 (flax's default, not torch's 1e-5);
- the GLU is ``a * sigmoid(b)``; the depthwise conv zero-pads "same",
  or ``kernel_size - 1`` frames on the left when causal;
- the conv module's output is zeroed on padded frames;
- the key-padding mask comes from ``round(rel * T')``;
- ``cat`` broadcasts the speaker vector over time, concatenates, then
  projects 2D -> D with ``cat_proj``;
- ``cross_attention``'s key mask comes from ``round(rel * S)`` of the
  speaker frames' relative lengths.

One difference from the JAX module: the streaming conv cache holds the
last ``kernel_size - 1`` frames after the GLU, the depthwise conv's own
input, where the JAX module caches the module's input and runs the
LayerNorm, ``pointwise_in`` and the GLU over it again. Zeros in the
JAX cache become LN bias -> pointwise -> GLU, not zeros, so its stream
matches the offline causal encode only while those biases are zero (as
at init); zeros in the port's cache are the offline zero left padding
exactly, for any weights.

``dtype`` is the compute dtype (flax's ``dtype``): in bf16 every Linear,
the depthwise conv and every LayerNorm return bf16 (``models.layers``),
so the residual stream, the GLU, the macaron halves and ``cat_proj``
compute in bf16, as the JAX modules do with ``dtype=bfloat16``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from tsasr_torch.models.attention import (CrossAttention, RelPosMHAXL,
                                         rel_pos_encoding)
from tsasr_torch.models.layers import Conv1d, LayerNorm, Linear, linear
from tsasr_torch.ops.dropout import Dropout
from tsasr_torch.ops.masks import (length_to_mask, lookahead_mask,
                                   relative_to_absolute_lengths)
from tsasr_torch.parallel.tensor_parallel import (copy_to_model,
                                                  rank_slice, row_linear,
                                                  tp_layer_norm)
from tsasr_torch.utils.precision import cast

LN_EPS = 1e-6


def _act(x):
    return F.leaky_relu(x, 0.01)


class FeedForward(nn.Module):
    """Linear(d_ffn) -> leaky_relu -> dropout -> Linear(d_model).

    Split over a model axis (``tp``, ``parallel.tensor_parallel``): the
    rank's rows of ``w1`` and columns of ``w2``; ``w2``'s bias is added
    once, after the all-reduce."""

    TP_SPLIT = ("w1.weight", "w2.weight")
    TP_PARTS = ("w1.bias",)
    tp = None

    def __init__(self, d_model, d_ffn, dropout=0.0, dropout_bits=32,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.w1 = Linear(d_model, d_ffn, compute_dtype=dtype)
        self.w2 = Linear(d_ffn, d_model, compute_dtype=dtype)
        self.dropout = Dropout(dropout, dropout_bits)

    def forward(self, x, deterministic=True, generator=None):
        if self.tp is None:
            return self.w2(self.dropout(_act(self.w1(x)), deterministic,
                                        generator))
        tp, dt = self.tp, self.dtype
        width = self.w1.weight.shape[0] * tp.size
        cols = rank_slice(width, tp)
        h = _act(linear(copy_to_model(x, tp), self.w1.weight,
                        self.w1.bias[cols], dt))
        h = self.dropout(h, deterministic, generator,
                         part=(h.dim() - 1, cols.start, width))
        return row_linear(self.w2, h, tp)


class ConvolutionModule(nn.Module):
    """LN -> pointwise(2D) -> GLU -> depthwise -> LN -> act -> pointwise
    -> dropout.

    Split over a model axis (``tp``): the rank's channels of each GLU
    half, so the GLU, the depthwise conv and the activation stay on the
    rank; ``norm_mid`` all-reduces its two moments over the axis
    (``tensor_parallel.tp_layer_norm``), and ``pointwise_out``'s partial
    products are summed before its bias."""

    TP_SPLIT = ("pointwise_in.weight", "pointwise_out.weight")
    TP_PARTS = ("pointwise_in.bias", "depthwise.weight", "depthwise.bias",
                "norm_mid.weight", "norm_mid.bias")
    tp = None

    def __init__(self, d_model, kernel_size=31, dropout=0.0, dropout_bits=32,
                 causal=False, dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.dtype = dtype
        self.kernel_size = kernel_size
        self.causal = causal
        self.norm_in = LayerNorm(d_model, eps=LN_EPS, compute_dtype=dtype)
        self.pointwise_in = Linear(d_model, 2 * d_model, compute_dtype=dtype)
        self.depthwise = Conv1d(d_model, d_model, kernel_size,
                                padding=0 if causal
                                else (kernel_size - 1) // 2,
                                groups=d_model, compute_dtype=dtype)
        self.norm_mid = LayerNorm(d_model, eps=LN_EPS, compute_dtype=dtype)
        self.pointwise_out = Linear(d_model, d_model, compute_dtype=dtype)
        self.dropout = Dropout(dropout, dropout_bits)

    def forward(self, x, pad_mask=None, deterministic=True, generator=None,
                conv_cache=None, mask_conv_input=False):
        """x: (B, T, D); pad_mask: (B, T) bool, True = padding.

        Streaming (causal): ``conv_cache`` (B, kernel_size - 1, D) holds
        the depthwise conv's input frames before x, zeros at the start;
        returns (out, new cache).

        ``mask_conv_input`` also zeroes the padded rows after the GLU,
        before the depthwise conv (the JAX module's switch). A causal
        conv's valid rows never see a later row, so it changes none of
        them, and masked rows to the left become the offline zero left
        padding: the sequence-parallel halo needs that
        (``parallel.seq_parallel``)."""
        if self.tp is not None and conv_cache is not None:
            raise NotImplementedError("a split conv module does not "
                                      "stream; serve the whole model")
        a, b = self._pointwise_in(self.norm_in(x)).chunk(2, dim=-1)
        glu = a * torch.sigmoid(b)
        if mask_conv_input and pad_mask is not None:
            glu = glu.masked_fill(pad_mask[..., None], 0.0)
        if conv_cache is not None:
            glu = torch.cat([conv_cache, glu], dim=1)
        elif self.causal:
            glu = F.pad(glu, (0, 0, self.kernel_size - 1, 0))
        out = self._depthwise(glu.transpose(1, 2)).transpose(1, 2)
        if self.tp is None:
            out = self.pointwise_out(_act(self.norm_mid(out)))
        else:
            out = row_linear(self.pointwise_out, _act(tp_layer_norm(
                out, *self._channels(self.norm_mid), self.norm_mid.eps,
                self.d_model, self.tp, self.dtype)), self.tp)
        out = self.dropout(out, deterministic, generator)
        if pad_mask is not None:
            out = out.masked_fill(pad_mask[..., None], 0.0)
        if conv_cache is not None:
            return out, glu[:, glu.shape[1] - (self.kernel_size - 1):]
        return out


    def check_tensor_parallel(self, tp):
        """The GLU's halves split alike: ``tp`` must divide d_model."""
        if self.d_model % tp:
            raise ValueError(f"a model axis of {tp} does not divide the "
                             f"conv module's {self.d_model} channels")

    def _channels(self, module):
        """(weight, bias) of ``module`` in the rank's channels."""
        cols = rank_slice(self.d_model, self.tp)
        return module.weight[cols], module.bias[cols]

    def _pointwise_in(self, x):
        if self.tp is None:
            return self.pointwise_in(x)
        cols = rank_slice(self.d_model, self.tp)
        bias = self.pointwise_in.bias
        return linear(copy_to_model(x, self.tp), self.pointwise_in.weight,
                      torch.cat([bias[:self.d_model][cols],
                                 bias[self.d_model:][cols]]), self.dtype)

    def _depthwise(self, x):
        """The depthwise conv on (B, channels, T): all of them, or the
        rank's."""
        conv = self.depthwise
        if self.tp is None:
            return conv(x)
        weight, bias = self._channels(conv)
        return F.conv1d(cast(x, self.dtype), cast(weight, self.dtype),
                        cast(bias, self.dtype), padding=conv.padding,
                        groups=weight.shape[0])


class ConformerEncoderLayer(nn.Module):
    """Macaron half-FFN -> rel-pos MHSA -> conv module -> half-FFN -> LN."""

    def __init__(self, d_model, d_ffn, nhead, kernel_size=31, dropout=0.0,
                 dropout_bits=32, fused_attention=False, causal=False,
                 att_context_size=0, dtype=torch.float32):
        super().__init__()
        self.norm_ffn1 = LayerNorm(d_model, eps=LN_EPS, compute_dtype=dtype)
        self.ffn1 = FeedForward(d_model, d_ffn, dropout, dropout_bits, dtype)
        self.norm_mha = LayerNorm(d_model, eps=LN_EPS, compute_dtype=dtype)
        self.mha = RelPosMHAXL(d_model, nhead, dropout, dropout_bits,
                               fused=fused_attention, mask_pos_future=causal,
                               att_context_size=att_context_size, dtype=dtype)
        self.conv = ConvolutionModule(d_model, kernel_size, dropout,
                                      dropout_bits, causal, dtype)
        self.norm_ffn2 = LayerNorm(d_model, eps=LN_EPS, compute_dtype=dtype)
        self.ffn2 = FeedForward(d_model, d_ffn, dropout, dropout_bits, dtype)
        self.norm_out = LayerNorm(d_model, eps=LN_EPS, compute_dtype=dtype)
        self.dropout = Dropout(dropout, dropout_bits)

    def forward(self, x, pos_emb, key_padding_mask=None, attn_mask=None,
                deterministic=True, generator=None, layer_state=None,
                return_attn=False, mask_conv_input=False):
        """Returns (x, the attention probabilities, or None from the fused
        path; ``return_attn`` takes the plain path for them). Streaming:
        ``layer_state`` = {"attn": KV cache, "conv": conv cache} takes x
        as new frames after the cached ones and the return is (x, attn,
        new state). ``mask_conv_input``: the conv module's switch."""
        drop = (deterministic, generator)
        ff1 = self.ffn1(self.norm_ffn1(x), *drop)
        x = x + 0.5 * self.dropout(ff1, *drop)
        if layer_state is None:
            attn_out, attn = self.mha(self.norm_mha(x), pos_emb,
                                      key_padding_mask, attn_mask, *drop,
                                      return_attn=return_attn)
            x = x + attn_out
            x = x + self.conv(x, key_padding_mask, *drop,
                              mask_conv_input=mask_conv_input)
        else:
            (attn_out, attn), kv = self.mha(self.norm_mha(x), None,
                                            kv_cache=layer_state["attn"])
            x = x + attn_out
            conv_out, conv = self.conv(x, conv_cache=layer_state["conv"])
            x = x + conv_out
        ff2 = self.ffn2(self.norm_ffn2(x), *drop)
        x = self.norm_out(x + 0.5 * self.dropout(ff2, *drop))
        if layer_state is None:
            return x, attn
        return x, attn, {"attn": kv, "conv": conv}


INJECTION_MODES = (None, "prod", "sum", "cat", "cross_attention")
REMAT_POLICIES = ("full", "dots")
# what the ``dots`` policy keeps from the forward: the matmul outputs
# (the JAX ``dots_saveable``); everything else is recomputed
_DOTS = ("mm", "addmm", "bmm")


def _dots_context():
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = {getattr(torch.ops.aten, name).default for name in _DOTS}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return create_selective_checkpoint_contexts(policy)


def rematerialized(fn, generator, policy="full"):
    """``fn`` run under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward instead of being kept (``full``), or all
    but the matmul outputs (``dots``).

    The port's dropout masks and attention seeds come from ``generator``,
    which checkpoint's ``preserve_rng_state`` does not cover. So the
    generator's state is saved before the forward, the recompute runs from
    it and the state is put back where the recompute found it: the
    recompute draws the forward's masks, and the generator ends where a
    step without remat leaves it."""
    from torch.utils.checkpoint import checkpoint
    start = None if generator is None else generator.get_state()
    calls = []

    def run(*args):
        if not calls or generator is None:
            calls.append(True)
            return fn(*args)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*args)
        finally:
            generator.set_state(now)

    def wrapped(*args):
        kwargs = {"context_fn": _dots_context} if policy == "dots" else {}
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return wrapped


class TSConformerEncoder(nn.Module):
    """Conformer encoder; the speaker embedding is injected after the
    layers listed in ``injection_after`` (-1: before layer 0).

    ``injection_mode``: ``prod`` and ``sum`` multiply or add the speaker
    vector (B, 1, D); ``cat`` concatenates it to every frame and projects
    back with ``cat_proj``; ``cross_attention`` attends from every frame
    over the speaker frames (B, S, D) with ``speaker_attn``, the padded
    ones masked by ``round(speaker_embs_length * S)``; None injects
    nothing. One ``cat_proj`` / ``speaker_attn`` serves every injection
    point, as in JAX.

    ``remat`` recomputes each layer in the backward (``remat_policy``
    ``full``, or ``dots``: keep the matmul outputs), off while streaming;
    see ``rematerialized``."""

    def __init__(self, input_size, d_model=256, nhead=4, num_layers=12,
                 d_ffn=2048, kernel_size=31, dropout=0.0, dropout_bits=32,
                 injection_mode=None, injection_after=(0,),
                 fused_attention=False, causal=False, att_context_size=0,
                 remat=False, remat_policy="full", dtype=torch.float32):
        super().__init__()
        if injection_mode not in INJECTION_MODES:
            raise ValueError(f"injection_mode {injection_mode!r} is not one "
                             f"of {INJECTION_MODES}")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        self.d_model = d_model
        self.causal = causal
        self.kernel_size = kernel_size
        self.att_context_size = att_context_size
        self.dtype = dtype
        self.injection_mode = injection_mode
        self.injection_after = tuple(injection_after) \
            if isinstance(injection_after, (list, tuple)) \
            else (injection_after,)
        self.remat = remat
        self.remat_policy = remat_policy
        self.input_proj = Linear(input_size, d_model, compute_dtype=dtype)
        self.layers = nn.ModuleList(
            ConformerEncoderLayer(d_model, d_ffn, nhead, kernel_size,
                                  dropout, dropout_bits, fused_attention,
                                  causal, att_context_size, dtype)
            for _ in range(num_layers))
        self.cat_proj = Linear(2 * d_model, d_model, compute_dtype=dtype) \
            if injection_mode == "cat" else None
        self.speaker_attn = CrossAttention(
            d_model, nhead, dropout, dropout_bits, dtype) \
            if injection_mode == "cross_attention" else None
        self.norm = LayerNorm(d_model, eps=LN_EPS, compute_dtype=dtype)
        self.dropout = Dropout(dropout, dropout_bits)

    def _inject(self, x, speaker_embs, speaker_mask, deterministic,
                generator):
        mode = self.injection_mode
        if mode == "prod":
            return x * speaker_embs
        if mode == "sum":
            return x + speaker_embs
        if mode == "cat":
            expanded = speaker_embs.expand(x.shape[0], x.shape[1], -1)
            return self.cat_proj(torch.cat([x, expanded], dim=-1))
        if mode == "cross_attention":
            return self.speaker_attn(x, speaker_embs, speaker_mask,
                                     deterministic, generator)
        return x

    @staticmethod
    def speaker_mask(speaker_embs, speaker_embs_length):
        """``cross_attention``'s key mask over the speaker frames, True =
        padding, from their relative lengths; None without them."""
        if speaker_embs is None or speaker_embs_length is None:
            return None
        S = speaker_embs.shape[1]
        return ~length_to_mask(
            relative_to_absolute_lengths(speaker_embs_length, S), S)

    def apply_layer(self, i, x, pos_emb, key_padding_mask, attn_mask,
                    deterministic=True, generator=None,
                    mask_conv_input=False, params=None):
        """Layer ``i`` on ``x``, rematerialized under ``remat`` when a
        gradient is being taken. ``params`` ({leaf name in the layer:
        tensor}) stand in for the layer's own leaves, in the recompute
        too (the whole leaves a tensor-parallel rank gathers,
        ``parallel.tensor_parallel.gather_layers``)."""
        layer = self.layers[i]

        def run(h):
            args = (h, pos_emb, key_padding_mask, attn_mask, deterministic,
                    generator)
            kwargs = {"mask_conv_input": mask_conv_input}
            if params:
                return torch.func.functional_call(layer, params, args,
                                                  kwargs)[0]
            return layer(*args, **kwargs)[0]
        if self.remat and torch.is_grad_enabled():
            return rematerialized(run, generator, self.remat_policy)(x)
        return run(x)

    def forward(self, src, rel_lengths=None, speaker_embs=None,
                deterministic=True, generator=None, stream_states=None,
                speaker_embs_length=None, return_attn=False):
        """src: (B, T, F) or (B, T, F1, F2) (flattened to F1*F2);
        rel_lengths: (B,) in (0, 1]; speaker_embs: (B, 1, D), or (B, S, D)
        for ``cross_attention`` with ``speaker_embs_length`` (B,) their
        relative lengths.

        ``return_attn``: also every layer's attention probabilities
        (B, H, T, T), through the plain attention path (the JAX encoder
        turns its fused path off for them); returns (out, [probs]).

        Streaming (causal models): ``stream_states`` holds each layer's
        state, src the new frames; returns (out, new states)."""
        if src.dim() == 4:
            src = src.reshape(src.shape[0], src.shape[1], -1)
        T = src.shape[1]
        streaming = stream_states is not None
        key_padding_mask = attn_mask = pos_emb = None
        if rel_lengths is not None:
            abs_len = relative_to_absolute_lengths(rel_lengths, T)
            key_padding_mask = ~length_to_mask(abs_len, T)
        speaker_mask = self.speaker_mask(speaker_embs, speaker_embs_length)

        x = self.dropout(self.input_proj(src), deterministic, generator)
        inject = speaker_embs is not None
        drop = (deterministic, generator)
        if inject and -1 in self.injection_after:
            x = self._inject(x, speaker_embs, speaker_mask, *drop)
        if not streaming:
            pos_emb = rel_pos_encoding(T, self.d_model, device=x.device,
                                       dtype=self.dtype)
            if self.causal:
                attn_mask = lookahead_mask(T, device=x.device)
        remat = self.remat and not streaming and not return_attn \
            and torch.is_grad_enabled()
        new_states, attns = [], []
        for i, layer in enumerate(self.layers):
            if streaming:
                x, _, state = layer(x, None, layer_state=stream_states[i])
                new_states.append(state)
            elif remat:
                x = self.apply_layer(i, x, pos_emb, key_padding_mask,
                                     attn_mask, *drop)
            else:
                x, attn = layer(x, pos_emb, key_padding_mask, attn_mask,
                                *drop, return_attn=return_attn)
                attns.append(attn)
            if inject and i in self.injection_after:
                x = self._inject(x, speaker_embs, speaker_mask, *drop)
        if streaming:
            return self.norm(x), new_states
        if return_attn:
            return self.norm(x), attns
        return self.norm(x)
