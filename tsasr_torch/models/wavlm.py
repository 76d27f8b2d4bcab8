"""WavLM + x-vector speaker encoder (the pretrained recipe's frozen
d-vector model).

Counterpart of the JAX package's ``models/wavlm.py``, the HF
``WavLMForXVector`` architecture:

- conv feature encoder (group norm on the first conv only, or a layer
  norm after every conv), exact GELU;
- feature projection (LayerNorm -> Linear);
- grouped positional conv embedding (weight norm folded into one weight;
  an even kernel drops its last frame);
- transformer encoder with WavLM's gated relative-position bias (T5-style
  log buckets, a gate computed from the raw hidden states per head; the
  first layer computes the bias and passes it on), post-norm or stable
  (pre-norm) layers;
- x-vector head: softmax-weighted sum of the embeddings and every
  layer's output, projector, dilated TDNN stack with ReLU, masked mean
  and Bessel-corrected std over the valid TDNN frames, embedding Linear,
  classifier.

Module names are HF's, so an HF ``state_dict`` maps straight onto them
(``convert_hf_xvector_state_dict``; the only change is the positional
conv's weight norm, folded). Padding is handled as in the JAX module:
a key-padding mask after the CNN and mask-aware pooling after the TDNN,
no dynamic shapes. The encoder runs frozen (no dropout anywhere).

``load_pretrained_xvector`` reads an HF checkpoint directory
(``config.json`` and ``model.safetensors`` through the port's own
reader, or ``pytorch_model.bin``); ``save_pretrained_xvector`` writes
one in HF key names (the weight norm unfolded, its norm in f64 so that
folding it again gives the weight back bit for bit).
"""

import dataclasses
import json
import math
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tsasr_torch.utils import safetensors_io


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """The HF WavLMConfig fields this module consumes (the defaults are
    microsoft/wavlm-base-plus-sv's, the base widths of wavlm-base-sv)."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"        # "group" | "layer"
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    do_stable_layer_norm: bool = False
    layer_norm_eps: float = 1e-5
    use_weighted_layer_sum: bool = True
    tdnn_dim: Sequence[int] = (512, 512, 512, 512, 1500)
    tdnn_kernel: Sequence[int] = (5, 3, 3, 1, 1)
    tdnn_dilation: Sequence[int] = (1, 2, 3, 1, 1)
    xvector_output_dim: int = 512

    @classmethod
    def from_hf_dict(cls, d):
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in d.items() if k in fields}
        return cls(**kwargs)

    def to_hf_dict(self):
        """HF ``config.json`` content: every field, plus what HF needs to
        build the model."""
        d = {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in dataclasses.asdict(self).items()}
        d.update(model_type="wavlm", architectures=["WavLMForXVector"],
                 num_feat_extract_layers=len(self.conv_dim))
        return d

    def feat_extract_output_length(self, input_length):
        """Frames after the CNN (ints or integer tensors)."""
        for k, s in zip(self.conv_kernel, self.conv_stride):
            input_length = (input_length - k) // s + 1
        return input_length

    def tdnn_output_length(self, input_length):
        for k in self.tdnn_kernel:
            input_length = input_length - k + 1
        return input_length


class WavLMConvLayer(nn.Module):
    """One conv of the feature encoder, its norm (``norm``: None,
    "group" or "layer") and exact GELU, on (B, C, T)."""

    def __init__(self, in_dim, out_dim, kernel, stride, bias, norm):
        super().__init__()
        self.conv = nn.Conv1d(in_dim, out_dim, kernel, stride=stride,
                              bias=bias)
        self.norm = norm
        if norm == "group":
            # torch GroupNorm(C, C): per-channel norm over time
            self.layer_norm = nn.GroupNorm(out_dim, out_dim, eps=1e-5)
        elif norm == "layer":
            self.layer_norm = nn.LayerNorm(out_dim, eps=1e-5)

    def forward(self, x):
        x = self.conv(x)
        if self.norm == "group":
            x = self.layer_norm(x)
        elif self.norm == "layer":
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        return F.gelu(x, approximate="none")


class WavLMFeatureEncoder(nn.Module):
    """Raw waveform (B, L) -> conv features (B, T, conv_dim[-1])."""

    def __init__(self, cfg):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            WavLMConvLayer(dims[i], dims[i + 1], k, s, cfg.conv_bias,
                           "group" if cfg.feat_extract_norm == "group"
                           and i == 0 else
                           "layer" if cfg.feat_extract_norm == "layer"
                           else None)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel,
                                           cfg.conv_stride)))

    def forward(self, x):
        h = x[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class WavLMFeatureProjection(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1],
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class WavLMPositionalConvEmbedding(nn.Module):
    """Grouped conv over time, weight norm folded into ``conv.weight``;
    an even kernel drops its last output frame."""

    def __init__(self, cfg):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                              padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.drop_last = k % 2 == 0

    def forward(self, h):
        out = self.conv(h.transpose(1, 2))
        if self.drop_last:
            out = out[:, :, :-1]
        return F.gelu(out, approximate="none").transpose(1, 2)


def _relative_positions_bucket(relative_positions, num_buckets,
                               max_distance):
    """HF ``WavLMAttention._relative_positions_bucket``: T5-style buckets
    of relative positions (an integer tensor), the log in f32 and the
    truncating integer cast as in the JAX module."""
    num_buckets = num_buckets // 2
    relative_buckets = (relative_positions > 0).to(torch.int64) \
        * num_buckets
    relative_positions = relative_positions.abs()
    max_exact = num_buckets // 2
    is_small = relative_positions < max_exact
    rel_large = torch.log(relative_positions.to(torch.float32)
                          / max_exact + 1e-20)
    rel_large = rel_large / math.log(max_distance / max_exact)
    rel_large = rel_large * (num_buckets - max_exact)
    rel_large = (max_exact + rel_large).to(torch.int64)
    rel_large = torch.clamp(rel_large, max=num_buckets - 1)
    return relative_buckets + torch.where(is_small, relative_positions,
                                          rel_large)


class WavLMAttention(nn.Module):
    """Self-attention with WavLM's gated relative-position bias."""

    def __init__(self, cfg, has_relative_position_bias=False):
        super().__init__()
        E, H = cfg.hidden_size, cfg.num_attention_heads
        self.cfg = cfg
        self.num_heads, self.head_dim = H, E // H
        self.q_proj = nn.Linear(E, E)
        self.k_proj = nn.Linear(E, E)
        self.v_proj = nn.Linear(E, E)
        self.out_proj = nn.Linear(E, E)
        self.gru_rel_pos_linear = nn.Linear(self.head_dim, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H, 1, 1))
        self.rel_attn_embed = nn.Embedding(cfg.num_buckets, H) \
            if has_relative_position_bias else None

    def position_bias(self, T, device):
        """(H, T, T) bias of the relative positions key - query."""
        pos = torch.arange(T, device=device)
        buckets = _relative_positions_bucket(
            pos[None, :] - pos[:, None], self.cfg.num_buckets,
            self.cfg.max_bucket_distance)
        return self.rel_attn_embed.weight[buckets].permute(2, 0, 1)

    def forward(self, h, key_mask=None, position_bias=None):
        B, T, E = h.shape
        H, D = self.num_heads, self.head_dim
        if position_bias is None:
            if self.rel_attn_embed is None:
                raise ValueError("the first layer must compute the "
                                 "position bias")
            position_bias = self.position_bias(T, h.device)

        def heads(x):
            return x.reshape(B, T, H, D).transpose(1, 2)

        # the gate is computed from the raw hidden states split per head
        # (HF modeling_wavlm.py:167-179)
        proj = self.gru_rel_pos_linear(heads(h))
        gates = torch.sigmoid(proj.reshape(B, H, T, 2, 4).sum(-1))
        gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
        gate_out = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0
        gated_bias = gate_out * position_bias[None]         # (B, H, T, T)

        q, k, v = (heads(self.q_proj(h)), heads(self.k_proj(h)),
                   heads(self.v_proj(h)))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
        scores = scores + gated_bias
        if key_mask is not None:
            scores = scores.masked_fill(~key_mask[:, None, None, :],
                                        torch.finfo(scores.dtype).min)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        out = self.out_proj(out.transpose(1, 2).reshape(B, T, E))
        return out, position_bias


class WavLMFeedForward(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size,
                                      cfg.hidden_size)

    def forward(self, h):
        return self.output_dense(
            F.gelu(self.intermediate_dense(h), approximate="none"))


class WavLMEncoderLayer(nn.Module):
    """Post-norm layer (``do_stable_layer_norm=False``, the -sv models)."""

    def __init__(self, cfg, has_relative_position_bias=False):
        super().__init__()
        self.attention = WavLMAttention(cfg, has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.feed_forward = WavLMFeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, h, key_mask=None, position_bias=None):
        attn_out, position_bias = self.attention(h, key_mask, position_bias)
        h = self.layer_norm(h + attn_out)
        h = self.final_layer_norm(h + self.feed_forward(h))
        return h, position_bias


class WavLMEncoderLayerStableLayerNorm(WavLMEncoderLayer):
    """Pre-norm layer (``do_stable_layer_norm=True``, the -large models);
    the same modules as the post-norm layer."""

    def forward(self, h, key_mask=None, position_bias=None):
        attn_out, position_bias = self.attention(
            self.layer_norm(h), key_mask, position_bias)
        h = h + attn_out
        h = h + self.feed_forward(self.final_layer_norm(h))
        return h, position_bias


class WavLMEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.pos_conv_embed = WavLMPositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        layer_cls = (WavLMEncoderLayerStableLayerNorm if self.stable
                     else WavLMEncoderLayer)
        self.layers = nn.ModuleList(
            layer_cls(cfg, has_relative_position_bias=(i == 0))
            for i in range(cfg.num_hidden_layers))

    def forward(self, h, key_mask=None):
        """(last hidden state, [the embeddings and every layer's
        output])."""
        if key_mask is not None:
            h = torch.where(key_mask[:, :, None], h, 0.0)
        h = h + self.pos_conv_embed(h)
        if not self.stable:
            h = self.layer_norm(h)
        hidden_states = [h]
        position_bias = None
        for layer in self.layers:
            h, position_bias = layer(h, key_mask, position_bias)
            hidden_states.append(h)
        if self.stable:
            h = self.layer_norm(h)
            hidden_states[-1] = h
        return h, hidden_states


class WavLMModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.feature_extractor = WavLMFeatureEncoder(cfg)
        self.feature_projection = WavLMFeatureProjection(cfg)
        self.encoder = WavLMEncoder(cfg)

    def forward(self, input_values, feat_mask=None):
        h = self.feature_projection(self.feature_extractor(input_values))
        return self.encoder(h, feat_mask)


class TDNNLayer(nn.Module):
    """HF's TDNN layer: a Linear over (in * kernel) run as a dilated
    convolution, then ReLU."""

    def __init__(self, in_dim, out_dim, kernel, dilation):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.kernel_size, self.dilation = kernel, dilation
        self.kernel = nn.Linear(in_dim * kernel, out_dim)

    def forward(self, h):
        weight = self.kernel.weight.view(
            self.out_dim, self.kernel_size, self.in_dim).transpose(1, 2)
        out = F.conv1d(h.transpose(1, 2), weight, self.kernel.bias,
                       dilation=self.dilation)
        return torch.relu(out.transpose(1, 2))


class WavLMForXVector(nn.Module):
    """HF ``WavLMForXVector`` (modeling_wavlm.py:1554-1692).

    ``forward(input_values (B, L), lengths (B,) int or None)`` -> dict
    with ``embeddings`` (B, xvector_output_dim), ``logits``,
    ``last_hidden_state`` (B, T, hidden) and ``hidden_states`` (a list of
    num_hidden_layers + 1)."""

    def __init__(self, config=None):
        super().__init__()
        cfg = config or WavLMConfig()
        self.config = cfg
        self.wavlm = WavLMModel(cfg)
        if cfg.use_weighted_layer_sum:
            n = cfg.num_hidden_layers + 1
            self.layer_weights = nn.Parameter(torch.full((n,), 1.0 / n))
        self.projector = nn.Linear(cfg.hidden_size, cfg.tdnn_dim[0])
        dims = (cfg.tdnn_dim[0],) + tuple(cfg.tdnn_dim)
        self.tdnn = nn.ModuleList(
            TDNNLayer(dims[i], dims[i + 1], k, d)
            for i, (k, d) in enumerate(zip(cfg.tdnn_kernel,
                                           cfg.tdnn_dilation)))
        self.feature_extractor = nn.Linear(2 * cfg.tdnn_dim[-1],
                                           cfg.xvector_output_dim)
        self.classifier = nn.Linear(cfg.xvector_output_dim,
                                    cfg.xvector_output_dim)

    def forward(self, input_values, lengths=None):
        cfg = self.config
        T = cfg.feat_extract_output_length(input_values.shape[1])
        feat_mask = feat_lengths = None
        if lengths is not None:
            feat_lengths = cfg.feat_extract_output_length(lengths)
            feat_mask = torch.arange(T, device=input_values.device)[None, :] \
                < feat_lengths[:, None]
        last, hidden_states = self.wavlm(input_values, feat_mask)

        if cfg.use_weighted_layer_sum:
            norm_w = torch.softmax(self.layer_weights, dim=-1)
            h = sum(w * s for w, s in zip(norm_w, hidden_states))
        else:
            h = last
        h = self.projector(h)
        for layer in self.tdnn:
            h = layer(h)

        if lengths is None:
            mean = h.mean(dim=1)
            var = h.var(dim=1, correction=1)
        else:
            tdnn_len = cfg.tdnn_output_length(feat_lengths)
            t_mask = (torch.arange(h.shape[1], device=h.device)[None, :]
                      < tdnn_len[:, None])[..., None]
            cnt = torch.clamp(tdnn_len, min=1).to(h.dtype)[:, None]
            mean = (h * t_mask).sum(dim=1) / cnt
            var = ((h - mean[:, None]) ** 2 * t_mask).sum(dim=1) \
                / torch.clamp(cnt - 1.0, min=1.0)
        stats = torch.cat([mean, torch.sqrt(var)], dim=-1)
        embeddings = self.feature_extractor(stats)
        return {"embeddings": embeddings,
                "logits": self.classifier(embeddings),
                "last_hidden_state": last,
                "hidden_states": hidden_states}

    @torch.no_grad()
    def init_weights(self, seed=0):
        """Random weights from a seeded CPU generator, as HF initializes
        the model: Linear and embedding weights normal(0, 0.02), the CNN
        kaiming-normal, the positional conv normal(0, 2 / sqrt(k * C)),
        zero biases, unit norm scales, the gate constants 1 and the layer
        weights uniform."""
        g = torch.Generator().manual_seed(seed)
        pos_conv = self.wavlm.encoder.pos_conv_embed.conv

        def normal(param, std):
            param.copy_(torch.empty(param.shape).normal_(0.0, std,
                                                         generator=g))

        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                normal(module.weight, 0.02)
            elif module is pos_conv:
                k, c = module.kernel_size[0], module.in_channels
                normal(module.weight, 2 * math.sqrt(1 / (k * c)))
            elif isinstance(module, nn.Conv1d):
                fan_in = module.in_channels * module.kernel_size[0]
                normal(module.weight, math.sqrt(2.0 / fan_in))
            elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
                module.weight.fill_(1.0)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
        return self


# =================================================== HF checkpoints

POS_CONV = "wavlm.encoder.pos_conv_embed.conv"
# HF's two namings of the positional conv's weight norm: (g, v)
WEIGHT_NORM_NAMES = {
    "weight_g": (f"{POS_CONV}.weight_g", f"{POS_CONV}.weight_v"),
    "parametrizations": (f"{POS_CONV}.parametrizations.weight.original0",
                         f"{POS_CONV}.parametrizations.weight.original1"),
}


def _weight_norm(v):
    """torch weight_norm(dim=2)'s norm of v over dims 0 and 1, in f64."""
    v = v.to(torch.float64)
    return torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))


def convert_hf_xvector_state_dict(state_dict, config):
    """HF ``WavLMForXVector`` state dict (name -> numpy array or tensor)
    -> the port's state dict, in f32: every key the port's module has,
    taken as it is, except the positional conv's weight norm (either
    naming), folded to its weight ``g * v / ||v||`` in f64. Other HF keys
    (the training objective, the masked-spec embedding) are dropped."""
    sd = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
          for k, v in state_dict.items()}
    with torch.device("meta"):
        keys = WavLMForXVector(config).state_dict().keys()
    out = {}
    for key in keys:
        if key == f"{POS_CONV}.weight":
            names = next((n for n in WEIGHT_NORM_NAMES.values()
                          if n[0] in sd), WEIGHT_NORM_NAMES["weight_g"])
            g, v = sd[names[0]], sd[names[1]]
            out[key] = (g.to(torch.float64) * v.to(torch.float64)
                        / _weight_norm(v)).to(torch.float32)
        else:
            out[key] = sd[key].to(torch.float32)
    return out


def hf_xvector_state_dict(state_dict, naming="weight_g"):
    """The port's state dict -> HF key names, the inverse of
    ``convert_hf_xvector_state_dict``: the positional conv's weight as
    ``v`` = the weight and ``g`` = its norm in f64 (``naming``: one of
    ``WEIGHT_NORM_NAMES``), so that folding gives the weight back bit for
    bit."""
    out = {k: v.detach().cpu() for k, v in state_dict.items()}
    w = out.pop(f"{POS_CONV}.weight")
    g_name, v_name = WEIGHT_NORM_NAMES[naming]
    out[g_name], out[v_name] = _weight_norm(w), w
    return out


def load_pretrained_xvector(model_path):
    """An HF ``WavLMForXVector`` checkpoint directory -> (config, model
    on the CPU in eval mode). Reads ``config.json`` and
    ``model.safetensors`` (the port's reader) or ``pytorch_model.bin``
    (``torch.load(weights_only=True)``)."""
    with open(os.path.join(model_path, "config.json")) as f:
        config = WavLMConfig.from_hf_dict(json.load(f))
    st_path = os.path.join(model_path, "model.safetensors")
    if os.path.exists(st_path):
        sd = safetensors_io.load_file(st_path)
    else:
        sd = torch.load(os.path.join(model_path, "pytorch_model.bin"),
                        map_location="cpu", weights_only=True)
    model = WavLMForXVector(config)
    model.load_state_dict(convert_hf_xvector_state_dict(sd, config))
    return config, model.eval()


def save_pretrained_xvector(model, model_path, naming="weight_g"):
    """Write ``model`` as an HF checkpoint directory: ``config.json``
    from its ``WavLMConfig`` and ``model.safetensors`` in HF key names
    (``hf_xvector_state_dict``)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "config.json"), "w") as f:
        json.dump(model.config.to_hf_dict(), f, indent=2)
    safetensors_io.save_file(
        hf_xvector_state_dict(model.state_dict(), naming),
        os.path.join(model_path, "model.safetensors"))
