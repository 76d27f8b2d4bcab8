"""Pipeline parallelism: the encoder's layers split over the ranks of the
mesh's ``pipe`` axis.

The port of the JAX package's ``parallel/pp_parallel.py``. Rank p of a
pipeline group runs the contiguous layers ``p·L/P .. (p+1)·L/P - 1``;
its rows of the batch go through as ``n_micro`` micro-batches (default
P) on the GPipe schedule: stage p takes micro-batch m from stage p - 1,
runs its layers on it and hands the block to stage p + 1
(``parallel.hop.send`` / ``recv``), so micro-batch m is on stage p at
tick m + p of the n_micro + P - 1 ticks. The first stage applies
``input_proj``, its dropout and an injection at -1 (every mode) before
the pipeline; mid-stack ``prod`` / ``sum`` injection is a flag of the
layer it follows, on whichever stage holds it, with that stage's own
copy of the speaker embedding; the last stage applies the final
LayerNorm. Mid-stack ``cat`` / ``cross_attention`` (one parameter bank
for every injection point) and a layer count that the axis does not
divide raise JAX's ``ValueError``s.

Where JAX writes the schedule as a ``lax.scan`` over ticks with a
``ppermute`` each (idle stages computing on zeros) and lets AD
transpose it, the port runs it in one autograd function
(``_Pipeline``): its forward runs the stage's micro-batches in order,
keeping each one's autograd graph, and its backward runs them in
reverse, taking each block's cotangent from stage p + 1 and sending the
input's to stage p - 1. Every rank calls its hops in one fixed order, so
a transport that matches messages by order (NCCL) pairs them as gloo
does; no stage computes on an empty slot.

Dropout draws per layer and micro-batch from the step's generator
folded by both; the pre-pipeline ops fold it by L.
"""

import contextlib

import torch

from tsasr_torch.models.attention import rel_pos_encoding
from tsasr_torch.ops.dropout import fold_generator
from tsasr_torch.ops.masks import (length_to_mask, lookahead_mask,
                                   relative_to_absolute_lengths)
from tsasr_torch.parallel import hop


def check_config(encoder, pp, injection_after):
    """Raise unless ``pp`` divides the layers and every mid-stack
    injection is elementwise."""
    num_layers = len(encoder.layers)
    if num_layers % pp != 0:
        raise ValueError(
            f"num_layers ({num_layers}) must be divisible by the 'pipe' "
            f"axis size ({pp})")
    mid = [i for i in injection_after if i >= 0]
    if mid and encoder.injection_mode in ("cat", "cross_attention"):
        raise ValueError(
            "pipeline parallelism supports mid-stack injection only for "
            "the elementwise modes ('prod'/'sum'); "
            f"injection_mode={encoder.injection_mode!r} shares its "
            f"injection parameters across points {mid}; inject at -1 "
            "instead or use the sequence-parallel path")


class _Stage:
    """One rank's part of the pipeline: its layers, the masks of the
    whole sequence, and where its blocks come from and go."""

    def __init__(self, encoder, axis, n_micro, rows, pos_emb, key_padding,
                 attn_mask, deterministic, generator, inject_mode, grad,
                 layer_params):
        per = len(encoder.layers) // axis.size
        self.encoder, self.axis = encoder, axis
        self.layers = range(axis.index * per, (axis.index + 1) * per)
        self.n_micro, self.block = n_micro, rows // n_micro
        self.pos_emb, self.key_padding, self.attn_mask = (
            pos_emb, key_padding, attn_mask)
        self.deterministic, self.generator = deterministic, generator
        self.inject_mode, self.grad = inject_mode, grad
        self.layer_params = layer_params
        self.first = axis.index == 0
        self.last = axis.index == axis.size - 1
        self.graphs = []

    def rows(self, m):
        return slice(m * self.block, (m + 1) * self.block)

    def __call__(self, x, spk, m):
        """The stage's layers on micro-batch ``m``'s block ``x``."""
        encoder = self.encoder
        for i in self.layers:
            generator = None if self.deterministic else \
                fold_generator(self.generator, i, m)
            x = encoder.apply_layer(i, x, self.pos_emb,
                                    self.key_padding[self.rows(m)],
                                    self.attn_mask, self.deterministic,
                                    generator,
                                    params=self.layer_params.get(i))
            if self.inject_mode and i in encoder.injection_after:
                x = x * spk if self.inject_mode == "prod" else x + spk
        return x


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule of one stage: ``x`` is the first stage's input
    (an empty tensor elsewhere), ``spk`` the mid-stack injection's
    embedding (empty without one), ``params`` the stage's trainable
    leaves as its layers use them (a gathered whole leaf in its shard's
    place). Returns the last stage's output, an empty tensor on the
    others."""

    @staticmethod
    def forward(ctx, stage, x, spk, *params):
        outs, sends = [], []
        d = stage.encoder.d_model
        T = stage.key_padding.shape[1]
        for m in range(stage.n_micro):
            rows = stage.rows(m)
            if stage.first:
                xin = x[rows]
            else:
                xin = hop.recv((stage.block, T, d), x.dtype, x.device,
                               stage.axis.neighbour(-1))
            xin = xin.detach().requires_grad_(stage.grad)
            spk_m = spk[rows].detach().requires_grad_(stage.grad) \
                if stage.inject_mode else None
            with torch.enable_grad() if stage.grad else \
                    contextlib.nullcontext():
                y = stage(xin, spk_m, m)
            if stage.last:
                outs.append(y.detach())
            else:
                sends.append(hop.send(y, stage.axis.neighbour(1)))
            if stage.grad:
                stage.graphs.append((xin, spk_m, y))
        for sent in sends:
            sent.wait()
        ctx.stage, ctx.params = stage, params
        return torch.cat(outs) if stage.last else x.new_empty(0)

    @staticmethod
    def backward(ctx, grad_out):
        stage, params = ctx.stage, list(ctx.params)
        g_params = [None] * len(params)
        g_x, g_spk, sends = [], [], []
        for m in reversed(range(stage.n_micro)):
            xin, spk_m, y = stage.graphs[m]
            if stage.last:
                g = grad_out[stage.rows(m)]
            else:
                g = hop.recv(y.shape, y.dtype, y.device,
                             stage.axis.neighbour(1))
            inputs = [xin] + ([spk_m] if spk_m is not None else []) + params
            grads = torch.autograd.grad(y, inputs, g, allow_unused=True)
            g_in = torch.zeros_like(xin) if grads[0] is None else grads[0]
            if stage.first:
                g_x.append(g_in)
            else:
                sends.append(hop.send(g_in, stage.axis.neighbour(-1)))
            if spk_m is not None:
                g_spk.append(torch.zeros_like(spk_m) if grads[1] is None
                             else grads[1])
            for j, g_p in enumerate(grads[len(inputs) - len(params):]):
                if g_p is not None:
                    g_params[j] = g_p if g_params[j] is None \
                        else g_params[j] + g_p
        for sent in sends:
            sent.wait()
        stage.graphs = []
        return (None, torch.cat(g_x[::-1]) if stage.first else None,
                torch.cat(g_spk[::-1]) if g_spk else None, *g_params)


def pp_encoder_apply(encoder, src, rel_lengths, axis, speaker_embs=None,
                     speaker_embs_length=None, deterministic=True,
                     generator=None, n_micro=None, layer_params=None):
    """A ``TSConformerEncoder`` with its layers split over ``axis`` (a
    ``distributed.Axis``) on the GPipe schedule.

    src : (B, T, F) or (B, T, F1, F2), this data shard's rows (every
        rank of the axis holds them; only the first stage reads them).
        B must divide ``n_micro`` (default: the axis's size).
    layer_params : {i: {leaf name: tensor}} standing in for layer i's own
        leaves on the stage that holds it (``TSConformerEncoder.
        apply_layer``'s ``params``).

    Returns, on the axis's last rank, (B, T, d_model) after the
    encoder's final LayerNorm; on the others an empty tensor that holds
    the pipeline's autograd history (``hop.BroadcastFrom`` takes it)."""
    if src.dim() == 4:
        src = src.reshape(src.shape[0], src.shape[1], -1)
    B, T, _ = src.shape
    n_micro = n_micro or axis.size
    after = encoder.injection_after
    check_config(encoder, axis.size, after)
    if B % n_micro:
        raise ValueError(f"per-shard batch ({B}) must be divisible by "
                         f"n_micro ({n_micro})")
    device, L = src.device, len(encoder.layers)
    if rel_lengths is not None:
        key_padding = ~length_to_mask(
            relative_to_absolute_lengths(rel_lengths, T), T)
    else:
        key_padding = torch.zeros(B, T, dtype=torch.bool, device=device)
    attn_mask = lookahead_mask(T, device=device) if encoder.causal else None
    pos_emb = rel_pos_encoding(T, encoder.d_model, device=device,
                               dtype=encoder.dtype)
    mode = encoder.injection_mode
    inject = speaker_embs is not None
    inject_mode = mode if (inject and mode in ("prod", "sum")
                           and any(i >= 0 for i in after)) else None

    if axis.index == 0:
        drop = (deterministic, fold_generator(generator, L))
        x = encoder.dropout(encoder.input_proj(src), *drop)
        if inject and -1 in after:
            x = encoder._inject(
                x, speaker_embs,
                encoder.speaker_mask(speaker_embs, speaker_embs_length),
                *drop)
    else:
        x = encoder.input_proj.weight.new_empty(0, dtype=encoder.dtype)
    spk = speaker_embs if inject_mode else x.new_empty(0)
    layer_params = layer_params or {}
    params = [layer_params.get(i, {}).get(name, p)
              for i in range(axis.index * L // axis.size,
                             (axis.index + 1) * L // axis.size)
              for name, p in encoder.layers[i].named_parameters()
              if p.requires_grad]
    grad = torch.is_grad_enabled() and (
        x.requires_grad or spk.requires_grad or bool(params))
    stage = _Stage(encoder, axis, n_micro, B, pos_emb, key_padding,
                   attn_mask, deterministic, generator, inject_mode, grad,
                   layer_params)
    out = _Pipeline.apply(stage, x, spk, *params)
    return encoder.norm(out) if stage.last else out
