"""Transformer-XL style relative-position multi-head self-attention.

Counterpart of the JAX package's ``models/attention.py`` (``rel_pos_encoding``,
``_rel_shift``, ``RelPosMHAXL``, ``_past_pos_encoding``, ``CrossAttention``),
causal and streaming paths included. Traps kept from the reference:

- the positional encoding is symmetric in distance;
- ``qkv_proj`` has no bias and splits per head, (B, T, H, 3*Dh);
- scores are scaled by 1/sqrt(embed_dim), not 1/sqrt(head_dim);
- masks are a -1e9 fill and the softmax runs in f32.

``fused=True`` sends the attention core to
``kernels.relpos_attention.fused_relpos_attention``: on CUDA that is the
hand-written kernel for every T (the JAX module's 128-frame gate is a
TPU memory bound that does not apply here), on the CPU its plain
version. In training (``deterministic=False``) the probabilities are
dropped out: the unfused path draws a ``dropout_bits``-wide mask from
the step's generator, the fused path draws one seed per call from it
(as the JAX module draws ``randint(0, 2**23)`` from its rng stream) and
the kernels' Philox mask follows from that seed.

A causal model (``mask_pos_future``) gets the lookahead mask from its
encoder; the plain path also zeroes the future half of the shifted
positional scores, as the JAX ``_rel_shift`` does (a triangle that lies
past the ``klen`` columns kept, so it changes no score), and the fused
path relies on the mask alone, as the JAX ``_fused_attention`` does.
``att_context_size > 0`` hides keys that many frames or more in the
past: on the fused path as part of ``am_add``, which the CUDA kernels
take as they take any additive mask.

``dtype`` is the compute dtype (flax's ``dtype``): in bf16 the
projections, the positional encoding and ``q + pos_bias`` are bf16; the
plain path takes the scores in bf16 and the softmax in f32, rounds the
probabilities back to bf16 and drops them out in bf16, as the JAX module
does; the fused path sends bf16 operands to the bf16 kernels (the masks
stay f32). An f32 module computes in its tensors' own dtype.

Streaming (``kv_cache``): Q new frames attend over the cached keys and
values plus their own, with the positional scores looked up by distance
(the shift trick needs qlen == klen). Plain PyTorch, as the JAX module
computes it outside any Pallas kernel. Two differences from the JAX
module: the cache's ``count`` is one host int for the whole batch (every
row of a stream advances together; JAX writes at the batch's max count
anyway), and a stream that would run past the buffer's capacity raises,
where JAX's clamped ``dynamic_update_slice`` overwrites the last slots.
The buffers are written in place, and only the keys a query can see
(``count + Q`` of them, within ``att_context_size``) enter the products.
"""

import math

import torch
from torch import nn

from tsasr_torch.kernels.relpos_attention import fused_relpos_attention
from tsasr_torch.kernels.relpos_attention import rel_shift as _rel_shift
from tsasr_torch.models.layers import Linear, linear
from tsasr_torch.ops.dropout import Dropout
from tsasr_torch.parallel.tensor_parallel import (copy_to_model,
                                                  rank_slice, row_linear)
from tsasr_torch.utils.precision import cast, f32_or_wider

ATTN_FILL = -1e9


def rel_pos_encoding(seq_len, emb_dim, device=None, dtype=torch.float32):
    """Relative positional encoding (1, 2*seq_len-1, emb_dim); index j is
    relative position (T-1) - j, encoded by its absolute distance;
    computed in f32 and returned in ``dtype``."""
    inv_freq = torch.exp(
        torch.arange(0, emb_dim, 2, dtype=torch.float32, device=device)
        * -(math.log(10000.0) / emb_dim))
    j = torch.arange(2 * seq_len - 1, dtype=torch.float32, device=device)
    angles = torch.abs(j - (seq_len - 1))[:, None] * inv_freq[None, :]
    pe = torch.zeros(2 * seq_len - 1, emb_dim, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return cast(pe[None], dtype)


def _past_pos_encoding(n, emb_dim, device=None):
    """enc(d) for distances d = 0..n-1 (n, emb_dim): the past half of the
    symmetric relative encoding."""
    return rel_pos_encoding(n, emb_dim, device)[0, n - 1:]


class RelPosMHAXL(nn.Module):
    """Relative-position multi-head self-attention.

    Split over a model axis (``tp``, ``parallel.tensor_parallel``): the
    rank computes heads [h0, h0 + H/T) (its rows of ``qkv_proj``, of
    ``pos_proj`` and of the position biases), with the whole model's
    score scale and dropout counted from ``h0``, and ``out_proj``'s
    partial products are summed before its bias."""

    TP_SPLIT = ("qkv_proj.weight", "out_proj.weight")
    TP_PARTS = ("pos_proj.weight", "pos_bias_u", "pos_bias_v")
    tp = None

    def __init__(self, embed_dim, num_heads, dropout=0.0, dropout_bits=32,
                 fused=False, mask_pos_future=False, att_context_size=0,
                 dtype=torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.fused = fused
        self.mask_pos_future = mask_pos_future
        self.att_context_size = att_context_size
        self.dtype = dtype
        self.dropout = Dropout(dropout, dropout_bits)
        head_dim = embed_dim // num_heads
        self.qkv_proj = Linear(embed_dim, 3 * embed_dim, bias=False,
                               compute_dtype=dtype)
        self.pos_proj = Linear(embed_dim, embed_dim, bias=False,
                               compute_dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, head_dim))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, head_dim))
        self.out_proj = Linear(embed_dim, embed_dim, compute_dtype=dtype)

    def check_tensor_parallel(self, tp):
        """A rank holds whole heads: ``tp`` must divide them."""
        if self.num_heads % tp:
            raise ValueError(f"a model axis of {tp} does not divide "
                             f"{self.num_heads} heads")

    def heads(self):
        """(h0, n): the first of the heads this module computes and their
        count; all of them, or a split module's rank's."""
        if self.tp is None:
            return 0, self.num_heads
        n = self.num_heads // self.tp.size
        return self.tp.index * n, n

    def forward(self, x, pos_emb, key_padding_mask=None, attn_mask=None,
                deterministic=True, generator=None, kv_cache=None,
                return_attn=False):
        """x: (B, T, D); pos_emb: (1, 2T-1, D); key_padding_mask: (B, T)
        bool, True = padding; attn_mask: (T, T) bool, True = masked;
        ``generator`` draws the dropout when ``deterministic`` is False.

        Returns (out (B, T, D), attention probs or None when fused).
        ``return_attn`` takes the plain path on a fused module too, so the
        probabilities are there (the JAX encoder turns the fused path off
        for ``return_attn``). With ``kv_cache`` ({"k", "v": (B, C, H, Dh),
        "count": int}), x holds the new frames and the return is ((out,
        probs), new cache).
        """
        B, T, D = x.shape
        h0, H = self.heads()
        Dh = self.embed_dim // self.num_heads
        if self.tp is not None:
            if kv_cache is not None:
                raise NotImplementedError("a split attention does not "
                                          "stream; serve the whole model")
            x = copy_to_model(x, self.tp)
        q, k, v = self.qkv_proj(x).reshape(B, T, H, 3 * Dh).split(Dh, dim=-1)
        bias_u, bias_v = self.pos_bias_u, self.pos_bias_v
        if self.tp is not None:     # a whole slice still costs a backward
            bias_u, bias_v = bias_u[h0:h0 + H], bias_v[h0:h0 + H]
        q_u = q + cast(bias_u, self.dtype)
        q_v = q + cast(bias_v, self.dtype)
        scale = 1.0 / math.sqrt(self.embed_dim)
        if kv_cache is not None:
            return self._streaming_attention(q_u, q_v, k, v, kv_cache, scale)
        if self.tp is None:
            p_k = self.pos_proj(pos_emb)
        else:
            p_k = linear(pos_emb, self.pos_proj.weight[h0 * Dh:(h0 + H) * Dh],
                         None, self.dtype)
        p_k = p_k.reshape(-1, H, Dh)                        # (2T-1, H, Dh)
        if self.att_context_size > 0:
            pos = torch.arange(T, device=x.device)
            far = (pos[:, None] - pos[None, :]) >= self.att_context_size
            attn_mask = far if attn_mask is None else attn_mask | far

        if self.fused and not return_attn:
            rate = 0.0 if deterministic else self.dropout.rate
            seed = 0
            if rate > 0.0:
                if generator is None:
                    raise ValueError("train-mode dropout needs a "
                                     "torch.Generator")
                seed = torch.randint(0, 1 << 23, (1,), generator=generator,
                                     device=generator.device)
            out = self._fused_attention(q_u, q_v, k, v, p_k,
                                        key_padding_mask, attn_mask, scale,
                                        seed, rate, h0)
            return self._out_proj(out), None

        ac = torch.einsum("bthd,bshd->bhts", q_u, k)
        bd = _rel_shift(torch.einsum("bthd,shd->bhts", q_v, p_k), klen=T,
                        causal=self.mask_pos_future)
        scores = (ac + bd) * scale
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask[None, None], ATTN_FILL)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        ATTN_FILL)
        attn = torch.softmax(scores, dim=-1, dtype=f32_or_wider(scores))
        attn = self.dropout(cast(attn, self.dtype), deterministic, generator,
                            None if self.tp is None
                            else (1, h0, self.num_heads))
        out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, H * Dh)
        return self._out_proj(out), attn

    def _out_proj(self, out):
        if self.tp is None:
            return self.out_proj(out)
        return row_linear(self.out_proj, out, self.tp)

    @staticmethod
    def _fused_attention(q_u, q_v, k, v, p_k, key_padding_mask, attn_mask,
                         scale, seed, rate, h0=0):
        B, T, H, Dh = q_u.shape
        zero = torch.zeros((), device=q_u.device)
        fill = torch.full((), ATTN_FILL, device=q_u.device)
        kp_add = torch.zeros(B, T, device=q_u.device) \
            if key_padding_mask is None \
            else torch.where(key_padding_mask, fill, zero)
        am_add = torch.zeros(T, T, device=q_u.device) if attn_mask is None \
            else torch.where(attn_mask, fill, zero)
        out = fused_relpos_attention(
            *(t.transpose(1, 2).contiguous() for t in (q_u, q_v, k, v)),
            p_k.transpose(0, 1).contiguous(), kp_add, am_add, seed=seed,
            scale=scale, rate=rate, h0=h0)
        return out.transpose(1, 2).reshape(B, T, H * Dh)

    def _streaming_attention(self, q_u, q_v, k_new, v_new, kv_cache, scale):
        """Q new frames over the cache plus themselves, causally."""
        B, Q, H, Dh = q_u.shape
        k_buf, v_buf, count = kv_cache["k"], kv_cache["v"], kv_cache["count"]
        capacity = k_buf.shape[1]
        n = count + Q
        if n > capacity:
            raise RuntimeError(
                f"KV cache overflow: {count} cached + {Q} new frames > "
                f"capacity {capacity}; raise kv_capacity_seconds")
        k_buf[:, count:n] = k_new
        v_buf[:, count:n] = v_new
        # keys a query can see: all n, or the att_context_size last
        lo = max(0, count - self.att_context_size + 1) \
            if self.att_context_size > 0 else 0
        dev = q_u.device
        dist = ((count + torch.arange(Q, device=dev))[:, None]
                - torch.arange(lo, n, device=dev)[None, :])      # (Q, S)
        hidden = dist < 0
        if self.att_context_size > 0:
            hidden = hidden | (dist >= self.att_context_size)
        p = self.pos_proj(_past_pos_encoding(n, self.embed_dim, dev))
        p = p.reshape(n, H, Dh)                                 # enc(d)
        keys, values = k_buf[:, lo:n], v_buf[:, lo:n]
        ac = torch.einsum("bqhd,bshd->bhqs", q_u, keys)         # (B,H,Q,S)
        bd_all = torch.einsum("bqhd,rhd->bhqr", q_v, p)         # (B,H,Q,n)
        index = dist.clamp(0, n - 1).expand(B, H, Q, n - lo)
        bd = torch.gather(bd_all, -1, index)
        scores = ((ac + bd) * scale).masked_fill(hidden, ATTN_FILL)
        attn = cast(torch.softmax(scores, dim=-1,
                                  dtype=f32_or_wider(scores)), self.dtype)
        out = torch.einsum("bhqs,bshd->bqhd", attn, values).reshape(
            B, Q, H * Dh)
        return (self.out_proj(out), attn), {"k": k_buf, "v": v_buf,
                                            "count": n}


class CrossAttention(nn.Module):
    """Plain multi-head attention of ``query`` over ``key_value``: the
    ``cross_attention`` speaker injection (the JAX ``CrossAttention``).
    Projections ``q_proj``, ``k_proj``, ``v_proj`` and ``out_proj`` with
    biases; scores scaled by 1/sqrt(head_dim); padded keys filled with
    ``ATTN_FILL``; the softmax in f32, the probabilities rounded to the
    compute dtype and then dropped out. The JAX module computes it with
    einsums outside any Pallas kernel, and so does this one.

    Split over a model axis (``tp``), as the JAX split rule has it: only
    ``out_proj``, by its input columns; every rank computes the whole
    attention and its block of it enters ``out_proj``."""

    TP_SPLIT = ("out_proj.weight",)
    TP_PARTS = ()
    tp = None

    def __init__(self, embed_dim, num_heads, dropout=0.0, dropout_bits=32,
                 dtype=torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.dtype = dtype
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Linear(embed_dim, embed_dim,
                                       compute_dtype=dtype))
        self.dropout = Dropout(dropout, dropout_bits)

    def forward(self, query, key_value, key_padding_mask=None,
                deterministic=True, generator=None):
        """query (B, Tq, D), key_value (B, S, D); key_padding_mask (B, S)
        bool, True = padding -> (B, Tq, D)."""
        B, Tq, D = query.shape
        S, H = key_value.shape[1], self.num_heads
        Dh = D // H
        q = self.q_proj(query).reshape(B, Tq, H, Dh)
        k = self.k_proj(key_value).reshape(B, S, H, Dh)
        v = self.v_proj(key_value).reshape(B, S, H, Dh)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(Dh)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        ATTN_FILL)
        attn = torch.softmax(scores, dim=-1, dtype=f32_or_wider(scores))
        attn = self.dropout(cast(attn, self.dtype), deterministic, generator)
        out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, Tq, D)
        if self.tp is None:
            return self.out_proj(out)
        out = copy_to_model(out, self.tp)[..., rank_slice(D, self.tp)]
        return row_linear(self.out_proj, out, self.tp)
