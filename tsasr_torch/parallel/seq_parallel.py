"""Sequence parallelism: the encoder's time axis split over the ranks
of the mesh's ``seq`` axis.

The port of the JAX package's ``parallel/seq_parallel.py``. Each rank
of a sequence group holds one contiguous block of the encoder's frames.
Before every Conformer layer it takes the last ``halo`` frames of its
left neighbour's block (``parallel.hop.NeighbourHop``, one hop to rank
+1 of the axis; rank 0 receives zeros), prepends them, runs the
unmodified layer on the extended block and drops the halo rows. The
extended block is masked by global positions (before the stream's start
or past the utterance's length), with the lookahead mask and the
relative positions of its own length, and the layer zeroes masked rows
before its depthwise conv (``mask_conv_input``), so the halo of rank 0
is the offline zero left padding. With ``halo`` at least
``required_halo`` the kept rows are what the whole encoder computes.

Only causal encoders with a bounded attention context qualify: each
layer's left receptive field is then finite (``att_context_size - 1``
frames for the attention, ``kernel_size - 1`` for the conv); others
raise JAX's ``ValueError``. A block shorter than the halo raises too.

Dropout inside the block draws from the step's generator folded by the
rank's index on the axis (JAX folds its key per shard), so the blocks'
masks differ. The backward needs no code of its own: the hop's backward
sends each halo's cotangent back to its left neighbour.
"""

import torch

from tsasr_torch.models.attention import rel_pos_encoding
from tsasr_torch.ops.dropout import fold_generator
from tsasr_torch.ops.masks import lookahead_mask
from tsasr_torch.parallel.hop import NeighbourHop


def required_halo(att_context_size, kernel_size):
    """Frames of left context one layer consumes: the attention reaches
    ``att_context_size - 1`` keys back, the causal depthwise conv another
    ``kernel_size - 1``."""
    return att_context_size - 1 + kernel_size - 1


def fetch_left_halo(x, halo, axis):
    """The last ``halo`` frames of the left neighbour's block ``x``
    (zeros on the axis's first rank, which the caller masks by global
    position)."""
    return NeighbourHop.apply(x[:, -halo:].contiguous(), axis.neighbour(-1),
                              axis.neighbour(1))


def check_config(encoder, halo, block):
    """Raise unless ``encoder`` is causal with a bounded context and the
    ``halo`` fits one ``block`` of frames."""
    if not (encoder.causal and encoder.att_context_size > 0):
        raise ValueError(
            "sequence parallelism needs a causal encoder with bounded "
            "attention context (causal=True, att_context_size > 0); "
            f"got causal={encoder.causal}, "
            f"att_context_size={encoder.att_context_size}. Non-causal full "
            "attention would need every layer's keys and values from every "
            "rank. Use a causal banded config for the 'seq' axis, or the "
            "data or pipeline axes for offline full-attention models.")
    if halo > block:
        raise ValueError(
            f"halo ({halo}) exceeds the per-rank block ({block} frames): "
            "use fewer 'seq' ranks or a smaller att_context_size")


def sp_encoder_apply(encoder, src, rel_lengths, axis, speaker_embs=None,
                     speaker_embs_length=None, deterministic=True,
                     generator=None, halo=None, layer_params=None):
    """This rank's block of a causal banded ``TSConformerEncoder``'s
    output, its time axis split over ``axis`` (a ``distributed.Axis``).

    src : (B, T, F) or (B, T, F1, F2), the whole sequence (every rank of
        the axis holds it); T must divide the axis's size.
    rel_lengths : (B,) relative lengths of the whole sequence.
    layer_params : {i: {leaf name: tensor}} standing in for layer i's own
        leaves (``TSConformerEncoder.apply_layer``'s ``params``).

    Returns (B, T / size, d_model): frames ``index * T / size`` on, after
    the encoder's final LayerNorm."""
    if src.dim() == 4:
        src = src.reshape(src.shape[0], src.shape[1], -1)
    B, T, _ = src.shape
    if T % axis.size:
        raise ValueError(f"T ({T}) must divide the seq axis ({axis.size})")
    block = T // axis.size
    if halo is None:
        halo = required_halo(encoder.att_context_size, encoder.kernel_size)
    check_config(encoder, halo, block)
    device = src.device
    abs_len = torch.round(rel_lengths * T).to(torch.int32)
    offset = axis.index * block
    T_ext = halo + block
    pos = offset - halo + torch.arange(T_ext, device=device)
    key_padding_mask = (pos[None, :] < 0) | (pos[None, :] >= abs_len[:, None])
    attn_mask = lookahead_mask(T_ext, device=device)
    pos_emb = rel_pos_encoding(T_ext, encoder.d_model, device=device,
                               dtype=encoder.dtype)
    generator = fold_generator(generator, axis.index)
    drop = (deterministic, generator)
    speaker_mask = encoder.speaker_mask(speaker_embs, speaker_embs_length)
    inject = speaker_embs is not None

    x = src[:, offset:offset + block]
    x = encoder.dropout(encoder.input_proj(x), *drop)
    if inject and -1 in encoder.injection_after:
        x = encoder._inject(x, speaker_embs, speaker_mask, *drop)
    for i in range(len(encoder.layers)):
        x_ext = torch.cat([fetch_left_halo(x, halo, axis), x], dim=1)
        x_ext = encoder.apply_layer(i, x_ext, pos_emb, key_padding_mask,
                                    attn_mask, *drop, mask_conv_input=True,
                                    params=(layer_params or {}).get(i))
        x = x_ext[:, halo:]
        if inject and i in encoder.injection_after:
            x = encoder._inject(x, speaker_embs, speaker_mask, *drop)
    return encoder.norm(x)
