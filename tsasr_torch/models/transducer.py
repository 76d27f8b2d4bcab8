"""Transducer model assembly: TS-Conformer encoder + LSTM predictor + joint.

Counterpart of the JAX package's ``models/transducer.py`` for the serving
path and the training forward of the three recipes' speaker paths:

    mixture feats -> ConvFrontEnd -> TSConformer(+cat inject) -> encoder_proj
    enroll feats  -> ConvFrontEnd -> TSConformer -> ceil-length mean pool
                  -> speaker_proj                      (scratch)
    external d-vectors (B, 1, E) -> speaker_proj       (pretrained)
    no speaker branch, injection_mode None             (none)
    tokens_bos    -> one-hot (V -> V-1, blank row zero) -> LSTM
                  -> decoder_proj
    logits = transducer_head(leaky_relu(enc + dec))

Methods take the JAX ``deterministic`` switch; with
``deterministic=False`` dropout draws from the step's ``generator``.
A causal model (``causal_encoder``, ``frontend_causal``) also encodes in
chunks: ``init_stream_state`` and ``encode_stream`` carry the frontend's
rows and each layer's KV and conv caches from one chunk to the next, and
give the offline causal encode's frames. The speaker branch stays
non-causal: the enrollment is whole before the stream starts.

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
from tsasr_torch.models.frontend import ConvolutionFrontEnd
from tsasr_torch.models.layers import Linear
from tsasr_torch.models.rnn import LSTM
from tsasr_torch.ops.masks import length_to_mask
from tsasr_torch.utils.precision import cast


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
    speaker_encoder_layers: int = 6
    # width of external speaker embeddings (the pretrained recipe's frozen
    # WavLM d-vectors); None: speaker_proj takes d_model
    speaker_embedding_dim: Optional[int] = None
    decoder_neurons: int = 512
    decoder_num_layers: int = 1
    joint_dim: int = 640
    fused_attention: bool = False
    causal_encoder: bool = False
    att_context_size: int = 0   # >0: bounded left attention context
    frontend_causal: bool = False
    # keys of the JAX config that the recipe's yaml passes; the port runs
    # their defaults only, and any other value raises (__post_init__)
    remat: bool = False
    remat_policy: str = "full"
    frontend_class: Optional[str] = None
    encoder_class: Optional[str] = None
    predictor_class: Optional[str] = None
    joiner_class: Optional[str] = None
    speaker_encoder_type: str = "conformer"
    # the compute dtype: float32, or bfloat16 (the recipe's precision bf16)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {self.dtype} is not float32 or "
                             "bfloat16")
        not_ported = {
            "remat": (self.remat, False),
            "frontend_class": (self.frontend_class, None),
            "encoder_class": (self.encoder_class, None),
            "predictor_class": (self.predictor_class, None),
            "joiner_class": (self.joiner_class, None),
            "speaker_encoder_type": (self.speaker_encoder_type,
                                     "conformer"),
        }
        for key, (value, ported) in not_ported.items():
            if value != ported:
                raise NotImplementedError(
                    f"{key}={value!r} is not ported yet; the port runs "
                    f"{key}={ported!r}")
        # the policy only chooses what remat recomputes
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")


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


class TSTransducer(nn.Module):
    """Target-speaker transducer: the JAX model's inference methods and
    its training forward (``encode_predict``, ``forward``)."""

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

        def frontend(causal):
            return ConvolutionFrontEnd(
                c.n_mels, tuple(c.frontend_channels),
                strides=tuple(c.frontend_strides), dropout=c.dropout,
                dropout_bits=c.dropout_bits, causal=causal, dtype=c.dtype)

        self.frontend = frontend(c.frontend_causal)
        self.encoder = TSConformerEncoder(
            enc_in, c.d_model, c.nhead, c.encoder_num_layers, c.d_ffn,
            c.kernel_size, c.dropout, c.dropout_bits, c.injection_mode, after,
            c.fused_attention, c.causal_encoder, c.att_context_size, c.dtype)
        self.encoder_proj = Linear(c.d_model, c.joint_dim,
                                   compute_dtype=c.dtype)
        self.predictor = Predictor(c.vocab_size, c.blank_index,
                                   c.decoder_neurons, c.decoder_num_layers,
                                   c.joint_dim, c.dtype)
        self.transducer_head = Linear(c.joint_dim, c.vocab_size,
                                      compute_dtype=c.dtype)
        self.speaker_frontend = self.speaker_encoder = None
        self.speaker_proj = None
        if c.injection_mode is not None:
            if c.use_speaker_encoder:
                self.speaker_frontend = frontend(False)
                self.speaker_encoder = TSConformerEncoder(
                    enc_in, c.d_model, c.nhead, c.speaker_encoder_layers,
                    c.d_ffn, c.kernel_size, c.dropout, c.dropout_bits, None,
                    fused_attention=c.fused_attention, dtype=c.dtype)
            # projects the own speaker encoder's output, or the external
            # embeddings when there is no speaker encoder
            proj_in = c.d_model if c.use_speaker_encoder \
                else (c.speaker_embedding_dim or c.d_model)
            self.speaker_proj = Linear(proj_in, c.d_model,
                                       compute_dtype=c.dtype)

    # ----------------------------------------------------------- speaker
    def extract_speaker(self, enroll_feats, enroll_rel_lens,
                        deterministic=True, generator=None):
        """Enrollment features (B, T, n_mels) -> speaker embedding
        (B, 1, d_model)."""
        x = self.speaker_frontend(enroll_feats, deterministic, generator)
        x = self.speaker_encoder(x, enroll_rel_lens, None, deterministic,
                                 generator)
        return self.speaker_proj(self.pool_speaker(x, enroll_rel_lens))

    def project_external_speaker(self, speaker_embs):
        """External pooled speaker embeddings (B, 1, E), e.g. WavLM
        d-vectors, -> (B, 1, d_model)."""
        if speaker_embs.dim() != 3 or speaker_embs.shape[1] != 1:
            raise NotImplementedError(
                "frame-level external speaker embeddings (B, S, E) belong "
                "to injection_mode cross_attention, which is not ported "
                f"yet; got shape {tuple(speaker_embs.shape)}")
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
    def encode(self, feats, rel_lens, speaker_embs=None, deterministic=True,
               generator=None):
        """Mixture features (B, T, n_mels) -> (B, T', joint_dim)."""
        x = self.frontend(feats, deterministic, generator)
        x = self.encoder(x, rel_lens, speaker_embs, deterministic, generator)
        return self.encoder_proj(x)

    def encode_stream(self, feats_new, stream_state, speaker_embs=None):
        """New feature frames (B, n, n_mels), n a multiple of the
        frontend's strides' product, against the cached state ->
        (encoder_proj frames (B, n / 4, joint_dim), new state)."""
        x, frontend = self.frontend(feats_new,
                                    stream_caches=stream_state["frontend"])
        x, encoder = self.encoder(x, speaker_embs=speaker_embs,
                                  stream_states=stream_state["encoder"])
        return self.encoder_proj(x), {"frontend": frontend,
                                      "encoder": encoder}

    def init_stream_state(self, batch_size, capacity, device=None):
        """The zero streaming state; ``capacity`` is the number of encoder
        frames the attention KV buffers hold. f32 models only: the
        caches of a bf16 stream are not ported (the JAX streamer has no
        precision switch either)."""
        c = self.config
        if c.dtype != torch.float32:
            raise NotImplementedError(
                f"streaming a {c.dtype} model is not ported; stream the f32 "
                "model (its state_dict loads into either precision)")
        frontend = []
        freq, ch = c.n_mels, 1
        for block in self.frontend.blocks:
            frontend.append(torch.zeros(batch_size, block.kernel_size - 1,
                                        freq, ch, device=device))
            freq = -(-freq // block.conv.stride[0])
            ch = block.conv.out_channels
        H, Dh = c.nhead, c.d_model // c.nhead
        encoder = [{"attn": {"k": torch.zeros(batch_size, capacity, H, Dh,
                                              device=device),
                             "v": torch.zeros(batch_size, capacity, H, Dh,
                                              device=device),
                             "count": 0},
                    "conv": torch.zeros(batch_size, c.kernel_size - 1,
                                        c.d_model, device=device)}
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
        return self.transducer_head(F.leaky_relu(enc + dec, 0.01))

    # ---------------------------------------------------------- training
    def encode_predict(self, feats, rel_lens, tokens_bos, enroll_feats=None,
                       enroll_rel_lens=None, external_speaker_embs=None,
                       deterministic=True, generator=None):
        """Forward up to (excluding) the joint: (enc_out (B, T', J),
        dec_out (B, U+1, J)). The fused loss takes these plus the head's
        parameters, so the (B, T', U+1, J) joint is never stored.
        ``external_speaker_embs`` (B, 1, E) take precedence over
        ``enroll_feats``; without injection both are ignored."""
        speaker_embs = None
        if self.config.injection_mode is not None:
            if external_speaker_embs is not None:
                speaker_embs = self.project_external_speaker(
                    external_speaker_embs)
            elif enroll_feats is not None:
                speaker_embs = self.extract_speaker(
                    enroll_feats, enroll_rel_lens, deterministic, generator)
        enc_out = self.encode(feats, rel_lens, speaker_embs, deterministic,
                              generator)
        dec_out, _ = self.predict(tokens_bos)
        return enc_out, dec_out

    def forward(self, feats, rel_lens, tokens_bos, enroll_feats=None,
                enroll_rel_lens=None, external_speaker_embs=None,
                deterministic=True, generator=None):
        """Training/eval forward -> (logits (B, T', U+1, V), enc_out)."""
        enc_out, dec_out = self.encode_predict(
            feats, rel_lens, tokens_bos, enroll_feats, enroll_rel_lens,
            external_speaker_embs, deterministic, generator)
        logits = self.joint_logits(enc_out[:, :, None, :],
                                   dec_out[:, None, :, :])
        return logits, enc_out

    # ------------------------------------------------------------- init
    @torch.no_grad()
    def init_weights(self, seed=0):
        """Random weights from a seeded CPU generator, the same on every
        device: xavier-normal matrices and kernels, zero biases, unit
        LayerNorm scales, LSTM uniform(+-1/sqrt(H)) as in the reference."""
        g = torch.Generator().manual_seed(seed)

        def fill(param, draw):
            value = torch.empty(param.shape)
            draw(value)
            param.copy_(value)

        for module in self.modules():
            if isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
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
