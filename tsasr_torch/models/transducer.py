"""Transducer model assembly: TS-Conformer encoder + LSTM predictor + joint.

Counterpart of the JAX package's ``models/transducer.py`` for the serving
path and the training forward of the three recipes' speaker paths:

    mixture feats -> ConvFrontEnd -> TSConformer(+inject) -> encoder_proj
    enroll feats  -> ConvFrontEnd -> TSConformer -> ceil-length mean pool
                  -> speaker_proj                      (scratch)
                  (unpooled (B, S, D) frames for cross_attention)
    enroll feats  -> ECAPA-TDNN -> speaker_proj        (speaker_encoder_type
                                                        ecapa)
    external d-vectors (B, 1, E) or frames (B, S, E) -> speaker_proj
                                                       (pretrained)
    no speaker branch, injection_mode None             (none)
    tokens_bos    -> one-hot (V -> V-1, blank row zero) -> LSTM
                  -> decoder_proj
    logits = transducer_head(joiner(enc, dec)),
    joiner: leaky_relu(enc + dec) (sum) or
            leaky_relu(joint_network([enc, dec])) (concat)

``forward`` with ``band_width`` evaluates the joint on a diagonal band
of label positions only (``joint_logits_banded``, the band of
``ops.rnnt_loss_banded.band_centers``). The frontend, encoder, predictor
and joiner classes can be swapped from the config by a registered name or
a dotted path (``models.registry``, which states the keyword contract).
The speaker frames' relative lengths (``speaker_rel_lens``: the
enrollment's) mask the ``cross_attention`` keys.

Methods take the JAX ``deterministic`` switch; with
``deterministic=False`` dropout draws from the step's ``generator``.
A causal model (``causal_encoder``, ``frontend_causal``) also encodes in
chunks: ``init_stream_state`` and ``encode_stream`` carry the frontend's
rows and each layer's KV and conv caches (in the compute dtype) from one
chunk to the next, and give the offline causal encode's frames. The
speaker branch stays non-causal: the enrollment is whole before the
stream starts. ``encode_with_attn`` also gives each encoder layer's
attention probabilities.

``TSTransducerConfig.dtype`` is the compute dtype (the JAX config's
``dtype``): a bf16 model computes in bf16 throughout, its parameters f32,
and the one-hot embedding, the speaker pool's mask and the projections
follow it; the features (fbank, normalization, augmentation) stay f32
and are cast at the frontend's first convolution. The same f32
``state_dict`` loads into either precision.

The machine that runs the port has no JAX to make weights with, so
``TSTransducer.init_weights`` draws them from a seeded
``torch.Generator``; ``tsasr_torch.convert`` brings in trained flax
weights instead.
"""

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from tsasr_torch.models.attention import RelPosMHAXL
from tsasr_torch.models.conformer import TSConformerEncoder
from tsasr_torch.models.ecapa import ECAPA_TDNN, ECAPAConfig, FrozenBatchNorm
from tsasr_torch.models.frontend import ConvolutionFrontEnd
from tsasr_torch.models.layers import Linear
from tsasr_torch.models.registry import resolve
from tsasr_torch.models.rnn import LSTM
from tsasr_torch.ops.dropout import fold_generator
from tsasr_torch.ops.masks import (length_to_mask,
                                   relative_to_absolute_lengths)
from tsasr_torch.ops.rnnt_loss_banded import band_centers
from tsasr_torch.parallel.hop import BroadcastFrom, GatherBlocks
from tsasr_torch.parallel.pp_parallel import pp_encoder_apply
from tsasr_torch.parallel.seq_parallel import sp_encoder_apply
from tsasr_torch.parallel.tensor_parallel import gather_layers
from tsasr_torch.utils.precision import cast

SPEAKER_ENCODERS = ("conformer", "ecapa")
JOINT_MODES = ("sum", "concat")


@dataclass(frozen=True)
class TSTransducerConfig:
    """Model hyperparameters; keys and defaults mirror the JAX config."""

    vocab_size: int = 29
    blank_index: int = 0
    n_mels: int = 80
    d_model: int = 256
    nhead: int = 4
    encoder_num_layers: int = 12
    d_ffn: int = 2048
    kernel_size: int = 31
    dropout: float = 0.1
    # random-bit width per dropout mask element (ops/dropout.py)
    dropout_bits: int = 32
    frontend_channels: Sequence[int] = (128, 128)
    frontend_strides: Sequence[int] = (2, 2)
    injection_mode: Optional[str] = "cat"
    injection_after: Union[int, Sequence[int]] = 0
    use_speaker_encoder: bool = True
    speaker_encoder_type: str = "conformer"   # "conformer" | "ecapa"
    speaker_encoder_layers: int = 6
    ecapa_channels: Sequence[int] = (512, 512, 512, 512, 1536)
    ecapa_lin_neurons: int = 192
    # width of external speaker embeddings (the pretrained recipe's frozen
    # WavLM d-vectors); None: speaker_proj takes d_model
    speaker_embedding_dim: Optional[int] = None
    decoder_neurons: int = 512
    decoder_num_layers: int = 1
    joint_dim: int = 640
    joint_mode: str = "sum"
    # recompute encoder layers in the backward ("full"; "dots" keeps the
    # matmul outputs): activation memory for long utterances
    remat: bool = False
    remat_policy: str = "full"
    fused_attention: bool = False
    causal_encoder: bool = False
    att_context_size: int = 0   # >0: bounded left attention context
    frontend_causal: bool = False
    # swapped component classes (models/registry.py): a registered name or
    # a dotted import path; None: the built-in
    frontend_class: Optional[str] = None
    encoder_class: Optional[str] = None
    predictor_class: Optional[str] = None
    joiner_class: Optional[str] = None
    # the compute dtype: float32, or bfloat16 (the recipe's precision bf16)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {self.dtype} is not float32 or "
                             "bfloat16")
        for key, value, allowed in (
                ("speaker_encoder_type", self.speaker_encoder_type,
                 SPEAKER_ENCODERS),
                ("joint_mode", self.joint_mode, JOINT_MODES),
                ("remat_policy", self.remat_policy, ("full", "dots"))):
            if value not in allowed:
                raise ValueError(f"{key} {value!r} is not one of {allowed}")


def scratch_config(**overrides):
    """The ``scratch`` recipe's model
    (``hparams/LibriSpeechMix/conformer-t_scratch.yaml``, model section)
    with the fused attention kernel on."""
    values = dict(
        vocab_size=29, blank_index=0, n_mels=80, d_model=256, nhead=4,
        encoder_num_layers=12, d_ffn=2048, kernel_size=31, dropout=0.1,
        dropout_bits=8,
        frontend_channels=(128, 128), frontend_strides=(2, 2),
        injection_mode="cat", injection_after=0, use_speaker_encoder=True,
        speaker_encoder_layers=6, decoder_neurons=512, decoder_num_layers=1,
        joint_dim=640, fused_attention=True)
    values.update(overrides)
    return TSTransducerConfig(**values)


class OneHotEmbedding(nn.Module):
    """Fixed one-hot embedding V -> V-1: token i maps to the unit vector
    at i-1 (i above blank) or i (below); blank maps to zeros."""

    def __init__(self, num_embeddings, blank_id=0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        V = num_embeddings
        table = torch.zeros(V, V - 1)
        for i in range(V):
            if i != blank_id:
                table[i, i - 1 if i > blank_id else i] = 1.0
        self.register_buffer("table", table, persistent=False)

    def forward(self, tokens):
        return cast(self.table, self.dtype)[tokens]


class Predictor(nn.Module):
    """Prediction network: one-hot embed -> LSTM -> joint projection."""

    def __init__(self, vocab_size, blank_index=0, hidden_size=512,
                 num_layers=1, joint_dim=640, dtype=torch.float32):
        super().__init__()
        self.embedding = OneHotEmbedding(vocab_size, blank_index, dtype)
        self.decoder = LSTM(vocab_size - 1, hidden_size, num_layers, dtype)
        self.decoder_proj = Linear(hidden_size, joint_dim,
                                   compute_dtype=dtype)

    def forward(self, tokens_bos, initial_state=None):
        """tokens_bos (B, U+1) int -> (dec_proj (B, U+1, J), state)."""
        out, state = self.decoder(self.embedding(tokens_bos), initial_state)
        return self.decoder_proj(out), state

    def step(self, token, state):
        """token (B,) int -> (dec_proj (B, J), state)."""
        out, state = self.decoder.step(self.embedding(token), state)
        return self.decoder_proj(out), state


class Joiner(nn.Module):
    """The transducer joint before the head: ``leaky_relu(enc + dec)``
    (``sum``), or ``leaky_relu(joint_network(concat(enc, dec)))``
    (``concat``), enc (..., 1, J) and dec (..., U, J) broadcast."""

    def __init__(self, joint_dim=640, mode="sum", dtype=torch.float32):
        super().__init__()
        if mode not in JOINT_MODES:
            raise ValueError(f"joint mode {mode!r} is not one of "
                             f"{JOINT_MODES}")
        self.joint_network = Linear(2 * joint_dim, joint_dim,
                                    compute_dtype=dtype) \
            if mode == "concat" else None

    def forward(self, enc, dec):
        if self.joint_network is None:
            return F.leaky_relu(enc + dec, 0.01)
        shape = torch.broadcast_shapes(enc.shape[:-1], dec.shape[:-1])
        joint = torch.cat([enc.expand(*shape, -1), dec.expand(*shape, -1)],
                          dim=-1)
        return F.leaky_relu(self.joint_network(joint), 0.01)


class TSTransducer(nn.Module):
    """Target-speaker transducer: the JAX model's inference methods and
    its training forward (``encode_predict``, ``forward``)."""

    # the modules whose gradients the ranks of a sequence or pipeline
    # axis compute in parts (each its block's, or its stage's) under
    # ``encode_predict``'s ``axes``, to be summed over the axis; the
    # others' every rank computes whole
    MODEL_PARALLEL_PARTIAL = ("frontend", "encoder", "encoder_proj",
                              "speaker_frontend", "speaker_encoder",
                              "speaker_proj")
    # the modules that run whole on their leaves gathered over a model
    # axis beside a sequence or pipeline axis (the encoder's layers, which
    # JAX's shard_maps take whole), keeping their shards as storage
    # (``parallel.tensor_parallel.shard_model``'s ``gathered``)
    MODEL_PARALLEL_GATHERED = ("encoder.layers",)

    def __init__(self, config=None):
        super().__init__()
        c = config or TSTransducerConfig()
        self.config = c
        freq = c.n_mels
        for s in c.frontend_strides:
            freq = -(-freq // s)
        enc_in = freq * c.frontend_channels[-1]
        after = tuple(c.injection_after) \
            if isinstance(c.injection_after, (list, tuple)) \
            else (c.injection_after,)
        speaker_branch = c.injection_mode is not None
        ecapa = speaker_branch and c.use_speaker_encoder \
            and c.speaker_encoder_type == "ecapa"
        if ecapa and c.injection_mode == "cross_attention":
            raise ValueError("speaker_encoder_type 'ecapa' pools over time; "
                             "use the conformer branch for cross_attention")
        frontend_kwargs = dict(
            n_mels=c.n_mels, out_channels=tuple(c.frontend_channels),
            strides=tuple(c.frontend_strides), dropout=c.dropout,
            dropout_bits=c.dropout_bits, dtype=c.dtype)
        encoder_kwargs = dict(
            input_size=enc_in, d_model=c.d_model, nhead=c.nhead,
            d_ffn=c.d_ffn, kernel_size=c.kernel_size, dropout=c.dropout,
            dropout_bits=c.dropout_bits, fused_attention=c.fused_attention,
            remat=c.remat, remat_policy=c.remat_policy, dtype=c.dtype)

        self.frontend = (resolve("frontend", c.frontend_class)
                         or ConvolutionFrontEnd)(
            causal=c.frontend_causal, **frontend_kwargs)
        self.encoder = (resolve("encoder", c.encoder_class)
                        or TSConformerEncoder)(
            num_layers=c.encoder_num_layers, injection_mode=c.injection_mode,
            injection_after=after, causal=c.causal_encoder,
            att_context_size=c.att_context_size, **encoder_kwargs)
        self.encoder_proj = Linear(c.d_model, c.joint_dim,
                                   compute_dtype=c.dtype)
        self.predictor = (resolve("predictor", c.predictor_class)
                          or Predictor)(
            vocab_size=c.vocab_size, blank_index=c.blank_index,
            hidden_size=c.decoder_neurons, num_layers=c.decoder_num_layers,
            joint_dim=c.joint_dim, dtype=c.dtype)
        self.transducer_head = Linear(c.joint_dim, c.vocab_size,
                                      compute_dtype=c.dtype)
        self.joiner = (resolve("joiner", c.joiner_class) or Joiner)(
            joint_dim=c.joint_dim, mode=c.joint_mode, dtype=c.dtype)
        self.speaker_frontend = self.speaker_encoder = None
        self.speaker_proj = None
        if speaker_branch:
            # projects the own speaker encoder's output, or the external
            # embeddings when there is no speaker encoder
            proj_in = c.speaker_embedding_dim or c.d_model
            if ecapa:
                self.speaker_encoder = ECAPA_TDNN(ECAPAConfig(
                    input_size=c.n_mels, channels=tuple(c.ecapa_channels),
                    lin_neurons=c.ecapa_lin_neurons, dtype=c.dtype))
                proj_in = c.ecapa_lin_neurons
            elif c.use_speaker_encoder:
                self.speaker_frontend = ConvolutionFrontEnd(
                    causal=False, **frontend_kwargs)
                self.speaker_encoder = TSConformerEncoder(
                    num_layers=c.speaker_encoder_layers, **encoder_kwargs)
                proj_in = c.d_model
            self.speaker_proj = Linear(proj_in, c.d_model,
                                       compute_dtype=c.dtype)

    # ----------------------------------------------------------- speaker
    def extract_speaker(self, enroll_feats, enroll_rel_lens,
                        deterministic=True, generator=None):
        """Enrollment features (B, T, n_mels) -> speaker embedding
        (B, 1, d_model), or the unpooled frames (B, S, d_model) of the
        conformer branch for ``cross_attention``. The ECAPA branch runs
        its BatchNorms on their running statistics and draws no
        dropout."""
        if self.config.speaker_encoder_type == "ecapa":
            return self.speaker_proj(self.speaker_encoder(enroll_feats,
                                                          enroll_rel_lens))
        x = self.speaker_frontend(enroll_feats, deterministic, generator)
        x = self.speaker_encoder(x, enroll_rel_lens, None, deterministic,
                                 generator)
        if self.config.injection_mode != "cross_attention":
            x = self.pool_speaker(x, enroll_rel_lens)
        return self.speaker_proj(x)

    def project_external_speaker(self, speaker_embs):
        """External speaker embeddings, pooled (B, 1, E) (WavLM
        d-vectors) or frames (B, S, E) for ``cross_attention``, ->
        (B, 1 or S, d_model)."""
        return self.speaker_proj(speaker_embs)

    @staticmethod
    def pool_speaker(x, rel_lens):
        """Masked mean over time with ceil lengths."""
        S = x.shape[-2]
        abs_len = torch.clamp(torch.ceil(rel_lens * S), max=S).to(torch.int32)
        mask = length_to_mask(abs_len, S)[..., None].to(x.dtype)
        return (x * mask).sum(dim=-2, keepdim=True) \
            / mask.sum(dim=-2, keepdim=True)

    # ----------------------------------------------------------- encoder
    def encode(self, feats, rel_lens, speaker_embs=None,
               speaker_rel_lens=None, deterministic=True, generator=None):
        """Mixture features (B, T, n_mels) -> (B, T', joint_dim);
        ``speaker_rel_lens`` mask the speaker frames of
        ``cross_attention``."""
        x = self.frontend(feats, deterministic, generator)
        x = self.encoder(x, rel_lens, speaker_embs, deterministic, generator,
                         speaker_embs_length=speaker_rel_lens)
        return self.encoder_proj(x)

    def encode_seq_parallel(self, feats, rel_lens, axis, speaker_embs=None,
                            speaker_rel_lens=None, deterministic=True,
                            generator=None, halo=None, model_axis=None):
        """``encode`` with the Conformer's time axis split over ``axis``
        (a ``parallel.distributed.Axis``; ``parallel.seq_parallel``:
        causal banded encoders only). The frontend runs whole on each
        rank of the axis, which takes its block of the frames; the rank's
        block goes through the encoder and ``encoder_proj``, and the
        blocks are gathered: every rank returns (B, T', joint_dim). The
        frame count must divide the axis's size (the recipe's
        ``pad_feats_to`` sees to it). Dropout: the frontend draws from
        ``generator`` folded by 2, the encoder from its fold by 3, folded
        again by the rank's block. ``model_axis``: the encoder's layers
        that hold shards over it run whole on their leaves gathered once
        (``parallel.tensor_parallel.gather_layers``)."""
        x = self.frontend(feats, deterministic, fold_generator(generator, 2))
        layers = range(len(self.encoder.layers))
        x = sp_encoder_apply(self.encoder, x, rel_lens, axis, speaker_embs,
                             speaker_rel_lens, deterministic,
                             fold_generator(generator, 3), halo,
                             self._gathered(layers, model_axis))
        return GatherBlocks.apply(self.encoder_proj(x), axis, 1)

    def encode_pipeline(self, feats, rel_lens, axis, speaker_embs=None,
                        speaker_rel_lens=None, deterministic=True,
                        generator=None, n_micro=None, model_axis=None):
        """``encode`` with the Conformer's layers split over ``axis``
        (``parallel.pp_parallel``: the GPipe schedule of ``n_micro``
        micro-batches, default the axis's size, which must divide the
        rows). The frontend runs on each rank of the axis (the first
        stage's output is used); the last stage applies ``encoder_proj``
        and broadcasts: every rank returns (B, T', joint_dim). Dropout:
        the frontend draws from ``generator`` folded by 2, the encoder
        from its fold by 3, folded again per layer and micro-batch.
        ``model_axis``: as ``encode_seq_parallel``'s, each stage gathering
        its own layers."""
        x = self.frontend(feats, deterministic, fold_generator(generator, 2))
        per = len(self.encoder.layers) // axis.size
        y = pp_encoder_apply(self.encoder, x, rel_lens, axis, speaker_embs,
                             speaker_rel_lens, deterministic,
                             fold_generator(generator, 3), n_micro,
                             self._gathered(range(axis.index * per,
                                                  (axis.index + 1) * per),
                                            model_axis))
        if axis.index == axis.size - 1:
            y = self.encoder_proj(y)
        return BroadcastFrom.apply(
            y, axis, axis.ranks[-1],
            (x.shape[0], x.shape[1], self.config.joint_dim),
            self.config.dtype)

    def _gathered(self, layers, model_axis):
        """The whole leaves of the encoder's ``layers`` that hold shards
        over ``model_axis`` (None: no model axis)."""
        if model_axis is None or model_axis.size == 1:
            return None
        return gather_layers(self.encoder, layers, model_axis)

    def encode_with_attn(self, feats, rel_lens, speaker_embs=None,
                         speaker_rel_lens=None):
        """Like ``encode`` (deterministic), and also every encoder
        layer's attention probabilities (B, H, T', T'), from the plain
        attention path: the recipe's ``plot_attentions``."""
        x = self.frontend(feats)
        x, attns = self.encoder(x, rel_lens, speaker_embs,
                                speaker_embs_length=speaker_rel_lens,
                                return_attn=True)
        return self.encoder_proj(x), attns

    def encode_stream(self, feats_new, stream_state, speaker_embs=None,
                      speaker_rel_lens=None):
        """New feature frames (B, n, n_mels), n a multiple of the
        frontend's strides' product, against the cached state ->
        (encoder_proj frames (B, n / 4, joint_dim), new state)."""
        x, frontend = self.frontend(feats_new,
                                    stream_caches=stream_state["frontend"])
        x, encoder = self.encoder(x, speaker_embs=speaker_embs,
                                  stream_states=stream_state["encoder"],
                                  speaker_embs_length=speaker_rel_lens)
        return self.encoder_proj(x), {"frontend": frontend,
                                      "encoder": encoder}

    def init_stream_state(self, batch_size, capacity, device=None):
        """The zero streaming state; ``capacity`` is the number of encoder
        frames the attention KV buffers hold. Every cache is in the
        compute dtype, as the JAX ``init_stream_state`` builds them in
        ``c.dtype``: a bf16 model streams in bf16, its caches holding
        what its offline encode rounds to bf16 at the same points (the
        frontend's cast input rows, the projected keys and values, the
        GLU outputs)."""
        c = self.config
        kv = dict(device=device, dtype=c.dtype)
        frontend = []
        freq, ch = c.n_mels, 1
        for block in self.frontend.blocks:
            frontend.append(torch.zeros(batch_size, block.kernel_size - 1,
                                        freq, ch, **kv))
            freq = -(-freq // block.conv.stride[0])
            ch = block.conv.out_channels
        H, Dh = c.nhead, c.d_model // c.nhead
        encoder = [{"attn": {"k": torch.zeros(batch_size, capacity, H, Dh,
                                              **kv),
                             "v": torch.zeros(batch_size, capacity, H, Dh,
                                              **kv),
                             "count": 0},
                    "conv": torch.zeros(batch_size, c.kernel_size - 1,
                                        c.d_model, **kv)}
                   for _ in range(c.encoder_num_layers)]
        return {"frontend": frontend, "encoder": encoder}

    # --------------------------------------------------------- predictor
    def predict(self, tokens_bos, initial_state=None):
        return self.predictor(tokens_bos, initial_state)

    def predict_step(self, token, state):
        return self.predictor.step(token, state)

    def predictor_initial_state(self, batch_size, device=None):
        return self.predictor.decoder.initial_state(batch_size, device)

    # -------------------------------------------------------------- joint
    def joint_logits(self, enc, dec):
        """enc (..., 1, J), dec (..., U, J) -> logits (..., U, V)."""
        return self.transducer_head(self.joiner(enc, dec))

    def joint_logits_banded(self, enc_out, dec_out, centers, band_width):
        """The joint and head on a diagonal band of label positions only:
        enc_out (B, T, J), dec_out (B, U+1, J), ``centers`` (B, T) the
        band starts (``ops.rnnt_loss_banded.band_centers``) -> logits
        (B, T, band_width, V); positions past U repeat row U."""
        B, U1, _ = dec_out.shape
        idx = torch.clamp(centers[:, :, None].long() + torch.arange(
            band_width, device=centers.device), 0, U1 - 1)   # (B, T, W)
        rows = torch.arange(B, device=centers.device)[:, None, None]
        return self.joint_logits(enc_out[:, :, None, :], dec_out[rows, idx])

    # ---------------------------------------------------------- training
    def speaker_condition(self, enroll_feats=None, enroll_rel_lens=None,
                          external_speaker_embs=None, deterministic=True,
                          generator=None):
        """(speaker_embs, their relative lengths) that ``encode`` takes:
        the projected ``external_speaker_embs`` if given, else the
        speaker branch's embedding of ``enroll_feats``; (None, None)
        without injection or without either input."""
        if self.config.injection_mode is None:
            return None, None
        if external_speaker_embs is not None:
            return (self.project_external_speaker(external_speaker_embs),
                    enroll_rel_lens)
        if enroll_feats is not None:
            return (self.extract_speaker(enroll_feats, enroll_rel_lens,
                                         deterministic, generator),
                    enroll_rel_lens)
        return None, None

    def encode_predict(self, feats, rel_lens, tokens_bos, enroll_feats=None,
                       enroll_rel_lens=None, external_speaker_embs=None,
                       deterministic=True, generator=None, axes=None):
        """Forward up to (excluding) the joint: (enc_out (B, T', J),
        dec_out (B, U+1, J)). The fused loss takes these plus the head's
        parameters, so the (B, T', U+1, J) joint is never stored.
        ``external_speaker_embs`` (B, 1, E) or (B, S, E) take precedence
        over ``enroll_feats``; without injection both are ignored.
        ``enroll_rel_lens`` are the speaker frames' relative lengths.

        ``axes`` (a ``parallel.distributed.Layout``) routes the encoder
        as the JAX ``encode_predict`` routes it: a ``seq`` axis above 1
        to ``encode_seq_parallel``, else a ``pipe`` axis above 1 to
        ``encode_pipeline``. Then the speaker branch and the frontend
        draw dropout from the step's generator folded by 1 and 2, the
        same on every rank of the axis, and the encoder from its fold by
        3 (folded again per block or per layer and micro-batch); the
        predictor keeps the generator. Which parameters' gradients come
        split over the axis: ``MODEL_PARALLEL_PARTIAL``. Beside a model
        axis the encoder's layers run whole on gathered leaves
        (``MODEL_PARALLEL_GATHERED``), the speaker branch split."""
        axis = None if axes is None else axes.encoder_axis
        if axis is None:
            speaker_embs, speaker_rel = self.speaker_condition(
                enroll_feats, enroll_rel_lens, external_speaker_embs,
                deterministic, generator)
            enc_out = self.encode(feats, rel_lens, speaker_embs,
                                  speaker_rel, deterministic, generator)
        else:
            speaker_embs, speaker_rel = self.speaker_condition(
                enroll_feats, enroll_rel_lens, external_speaker_embs,
                deterministic, fold_generator(generator, 1))
            encode = self.encode_seq_parallel if axis.name == "seq" \
                else self.encode_pipeline
            enc_out = encode(feats, rel_lens, axis, speaker_embs,
                             speaker_rel, deterministic, generator,
                             model_axis=axes.model)
        dec_out, _ = self.predict(tokens_bos)
        return enc_out, dec_out

    def forward(self, feats, rel_lens, tokens_bos, enroll_feats=None,
                enroll_rel_lens=None, external_speaker_embs=None,
                deterministic=True, generator=None, band_width=None,
                token_rel_lens=None, axes=None):
        """Training/eval forward -> (logits (B, T', U+1, V), enc_out).
        With ``band_width`` (and ``token_rel_lens``) the joint runs on the
        band only and the logits are (B, T', band_width, V); the loss
        recomputes the same ``band_centers`` from the lengths. ``axes``:
        see ``encode_predict``."""
        enc_out, dec_out = self.encode_predict(
            feats, rel_lens, tokens_bos, enroll_feats, enroll_rel_lens,
            external_speaker_embs, deterministic, generator, axes)
        if band_width is None:
            return self.joint_logits(enc_out[:, :, None, :],
                                     dec_out[:, None, :, :]), enc_out
        T, U = enc_out.shape[1], tokens_bos.shape[1] - 1
        centers = band_centers(relative_to_absolute_lengths(rel_lens, T),
                               relative_to_absolute_lengths(token_rel_lens,
                                                            U),
                               T, band_width)
        return self.joint_logits_banded(enc_out, dec_out, centers,
                                        band_width), enc_out

    # ------------------------------------------------------------- init
    @torch.no_grad()
    def init_weights(self, seed=0):
        """Random weights from a seeded CPU generator, the same on every
        device: xavier-normal matrices and kernels, zero biases, unit
        LayerNorm and BatchNorm scales, BatchNorm statistics 0 and 1,
        LSTM uniform(+-1/sqrt(H)) as in the reference."""
        g = torch.Generator().manual_seed(seed)

        def fill(param, draw):
            value = torch.empty(param.shape)
            draw(value)
            param.copy_(value)

        for module in self.modules():
            if isinstance(module, (nn.LayerNorm, FrozenBatchNorm)):
                module.weight.fill_(1.0)
                module.bias.zero_()
                if isinstance(module, FrozenBatchNorm):
                    module.mean.zero_()
                    module.var.fill_(1.0)
            elif isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                fill(module.weight,
                     lambda t: nn.init.xavier_normal_(t, generator=g))
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, RelPosMHAXL):
                for p in (module.pos_bias_u, module.pos_bias_v):
                    fill(p, lambda t: nn.init.xavier_normal_(t, generator=g))
            elif isinstance(module, LSTM):
                bound = 1.0 / math.sqrt(module.hidden_size)
                for p in module.parameters():
                    fill(p, lambda t: t.uniform_(-bound, bound, generator=g))
        return self
