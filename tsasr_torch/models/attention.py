"""Transformer-XL style relative-position multi-head self-attention.

Counterpart of the JAX package's ``models/attention.py`` (``rel_pos_encoding``,
``_rel_shift``, ``RelPosMHAXL``) for the non-streaming paths. Traps kept
from the reference:

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
"""

import math

import torch
from torch import nn

from tsasr_torch.kernels.relpos_attention import fused_relpos_attention
from tsasr_torch.kernels.relpos_attention import rel_shift as _rel_shift
from tsasr_torch.ops.dropout import Dropout
from tsasr_torch.utils.precision import f32_or_wider

ATTN_FILL = -1e9


def rel_pos_encoding(seq_len, emb_dim, device=None):
    """Relative positional encoding (1, 2*seq_len-1, emb_dim); index j is
    relative position (T-1) - j, encoded by its absolute distance."""
    inv_freq = torch.exp(
        torch.arange(0, emb_dim, 2, dtype=torch.float32, device=device)
        * -(math.log(10000.0) / emb_dim))
    j = torch.arange(2 * seq_len - 1, dtype=torch.float32, device=device)
    angles = torch.abs(j - (seq_len - 1))[:, None] * inv_freq[None, :]
    pe = torch.zeros(2 * seq_len - 1, emb_dim, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe[None]


class RelPosMHAXL(nn.Module):
    """Relative-position multi-head self-attention (non-streaming)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, dropout_bits=32,
                 fused=False):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.fused = fused
        self.dropout = Dropout(dropout, dropout_bits)
        head_dim = embed_dim // num_heads
        self.qkv_proj = nn.Linear(embed_dim, 3 * embed_dim, bias=False)
        self.pos_proj = nn.Linear(embed_dim, embed_dim, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, head_dim))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, head_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x, pos_emb, key_padding_mask=None, attn_mask=None,
                deterministic=True, generator=None):
        """x: (B, T, D); pos_emb: (1, 2T-1, D); key_padding_mask: (B, T)
        bool, True = padding; attn_mask: (T, T) bool, True = masked;
        ``generator`` draws the dropout when ``deterministic`` is False.

        Returns (out (B, T, D), attention probs or None when fused).
        """
        B, T, D = x.shape
        H = self.num_heads
        Dh = D // H
        q, k, v = self.qkv_proj(x).reshape(B, T, H, 3 * Dh).split(Dh, dim=-1)
        q_u = q + self.pos_bias_u
        q_v = q + self.pos_bias_v
        p_k = self.pos_proj(pos_emb).reshape(-1, H, Dh)     # (2T-1, H, Dh)
        scale = 1.0 / math.sqrt(self.embed_dim)

        if self.fused:
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
                                        seed, rate)
            return self.out_proj(out), None

        ac = torch.einsum("bthd,bshd->bhts", q_u, k)
        bd = _rel_shift(torch.einsum("bthd,shd->bhts", q_v, p_k), klen=T)
        scores = (ac + bd) * scale
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask[None, None], ATTN_FILL)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        ATTN_FILL)
        attn = torch.softmax(scores, dim=-1, dtype=f32_or_wider(scores))
        attn = self.dropout(attn, deterministic, generator)
        out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, D)
        return self.out_proj(out), attn

    @staticmethod
    def _fused_attention(q_u, q_v, k, v, p_k, key_padding_mask, attn_mask,
                         scale, seed, rate):
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
            scale=scale, rate=rate)
        return out.transpose(1, 2).reshape(B, T, H * Dh)
