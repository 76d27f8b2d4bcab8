"""Flax ``TSTransducer`` params <-> the port's ``state_dict``.

``params_from_flax`` takes the flax parameter tree as a nested dict of
numpy arrays (``{"params": ...}`` or the inner dict) and returns a
``state_dict`` for ``tsasr_torch.models.TSTransducer``;
``params_to_flax`` is its inverse (a ``state_dict``, or any dict of
tensors under the same names such as gradients, to the inner flax tree
of numpy arrays). Layout changes:

- a Dense kernel (in, out) becomes a Linear weight (out, in);
- a Conv2d kernel (kh, kw, in, out) becomes (out, in, kh, kw);
- the depthwise Conv1d kernel (K, 1, D) becomes (D, 1, K);
- a LayerNorm ``scale`` becomes ``weight``; the (F, C) frontend norms
  keep their shape;
- LSTM ``l{n}_w_ih`` (F, 4H) / ``l{n}_w_hh`` (H, 4H) are transposed to
  ``weight_ih_l{n}`` / ``weight_hh_l{n}``; the fused ``l{n}_b`` stays one
  bias, ``bias_l{n}``;
- the ECAPA speaker encoder's Conv1d kernels (k, in, out) become
  (out, in, k), a BatchNorm's ``scale`` its ``weight``, and its
  ``batch_stats`` (``mean``, ``var``, in the flax variables' second
  collection) its buffers of the same names; flax's ``block_{i}`` is
  ``blocks.{i}``.

Tensor parallelism (``parallel.tensor_parallel``): ``shard_state_dict``
takes a whole ``state_dict`` to rank r's of a model axis of T ranks
(each leaf the split rule names, ``parallel.mesh.param_split_dims``,
becomes its r-th block; the rest stays whole), and
``gather_state_dicts`` joins the T ranks' back. ``pointwise_in``'s
output rows are the GLU's two halves (a, b): a rank's block is its block
of each half, so the GLU stays on the rank, where a contiguous split
(JAX's layout at T 2) would put a on rank 0 and b on rank 1. Together
with ``params_from_flax``, a rank's weights come from the JAX package's
numpy parameters.

``params_from_flax`` takes the whole variables dict (``{"params": ...,
"batch_stats": ...}``) where the model has an ECAPA branch;
``params_to_flax`` leaves the statistics out and ``batch_stats_to_flax``
gives them.

The speaker-recognition models go both ways too:
``ecapa_params_{from,to}_flax`` for a standalone ``ECAPA_TDNN`` (and
``save_ecapa_from_flax``, the port's ECAPA file from a JAX payload), and
``head_params_{from,to}_flax`` for ``Xvector`` and
``CosineClassifier``, params and ``batch_stats`` together.

``lm_params_from_flax`` does the same for the flax ``RNNLM``
(``embedding``, ``rnn``, ``dnn``, ``out``) into ``models.lm.RNNLM``, and
``wavlm_params_from_flax`` for the flax ``WavLMForXVector`` into
``models.wavlm.WavLMForXVector`` (HF's module names): Conv1d kernels
(k, in, out) become (out, in, k), and a TDNN kernel (k, in, out) becomes
HF's Linear weight (out, k * in).
"""

import numpy as np
import torch

from tsasr_torch.parallel.mesh import param_split_dims


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(out, prefix, tree):
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _norm(out, prefix, tree):
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def _conv2d(out, prefix, tree):
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]
                                            ).transpose(3, 2, 0, 1))
    out[f"{prefix}.bias"] = _t(tree["bias"])


def _frontend(out, prefix, tree):
    for name, block in tree.items():
        i = int(name.split("_")[1])
        p = f"{prefix}.blocks.{i}"
        _conv2d(out, f"{p}.conv", block["conv_0"])
        _norm(out, f"{p}.norm", block["norm_0"])
        if "residual_conv" in block:
            _conv2d(out, f"{p}.residual_conv", block["residual_conv"])
            _norm(out, f"{p}.residual_norm", block["residual_norm"])


def _layer(out, p, tree):
    _norm(out, f"{p}.norm_ffn1", tree["LayerNorm_0"])
    _norm(out, f"{p}.norm_mha", tree["norm_mha"])
    _norm(out, f"{p}.norm_ffn2", tree["LayerNorm_1"])
    _norm(out, f"{p}.norm_out", tree["norm_out"])
    for ffn in ("ffn1", "ffn2"):
        _dense(out, f"{p}.{ffn}.w1", tree[ffn]["Dense_0"])
        _dense(out, f"{p}.{ffn}.w2", tree[ffn]["Dense_1"])
    mha = tree["mha"]
    for name in ("qkv_proj", "pos_proj", "out_proj"):
        _dense(out, f"{p}.mha.{name}", mha[name])
    out[f"{p}.mha.pos_bias_u"] = _t(mha["pos_bias_u"])
    out[f"{p}.mha.pos_bias_v"] = _t(mha["pos_bias_v"])
    conv = tree["conv"]
    _norm(out, f"{p}.conv.norm_in", conv["LayerNorm_0"])
    _dense(out, f"{p}.conv.pointwise_in", conv["pointwise_in"])
    out[f"{p}.conv.depthwise.weight"] = _t(
        np.asarray(conv["depthwise"]["kernel"]).transpose(2, 1, 0))
    out[f"{p}.conv.depthwise.bias"] = _t(conv["depthwise"]["bias"])
    _norm(out, f"{p}.conv.norm_mid", conv["LayerNorm_1"])
    _dense(out, f"{p}.conv.pointwise_out", conv["pointwise_out"])


def _encoder(out, prefix, tree):
    _dense(out, f"{prefix}.input_proj", tree["input_proj"])
    _norm(out, f"{prefix}.norm", tree["norm"])
    if "cat_proj" in tree:
        _dense(out, f"{prefix}.cat_proj", tree["cat_proj"])
    for name, node in tree.get("speaker_attn", {}).items():
        _dense(out, f"{prefix}.speaker_attn.{name}", node)
    for name, layer in tree.items():
        if name.startswith("layer_"):
            _layer(out, f"{prefix}.layers.{int(name[6:])}", layer)


def _lstm(out, prefix, lstm):
    n_layers = sum(1 for k in lstm if k.endswith("_w_ih"))
    for n in range(n_layers):
        out[f"{prefix}.weight_ih_l{n}"] = _t(np.asarray(lstm[f"l{n}_w_ih"]).T)
        out[f"{prefix}.weight_hh_l{n}"] = _t(np.asarray(lstm[f"l{n}_w_hh"]).T)
        out[f"{prefix}.bias_l{n}"] = _t(lstm[f"l{n}_b"])


def _predictor(out, prefix, tree):
    _dense(out, f"{prefix}.decoder_proj", tree["decoder_proj"])
    _lstm(out, f"{prefix}.decoder", tree["decoder"])


def _join(prefix, name):
    return f"{prefix}.{name}" if prefix else name


def _ecapa(out, prefix, tree):
    """ECAPA params or batch_stats, walked by name."""
    for name, node in tree.items():
        key = f"blocks.{name[6:]}" if name.startswith("block_") else name
        if isinstance(node, dict):
            _ecapa(out, _join(prefix, key), node)
        elif name == "kernel":
            out[_join(prefix, "weight")] = _t(
                np.asarray(node).transpose(2, 1, 0))
        elif name == "scale":
            out[_join(prefix, "weight")] = _t(node)
        else:                                       # bias, mean, var
            out[_join(prefix, name)] = _t(node)


def params_from_flax(tree):
    """Flax ``TSTransducer`` variables or params (nested numpy dict) ->
    state_dict."""
    stats = tree.get("batch_stats", {})
    tree = tree.get("params", tree)
    out = {}
    for name in ("frontend", "speaker_frontend"):
        if name in tree:
            _frontend(out, name, tree[name])
    _encoder(out, "encoder", tree["encoder"])
    if "block_0" in tree.get("speaker_encoder", {}):
        _ecapa(out, "speaker_encoder", tree["speaker_encoder"])
        _ecapa(out, "speaker_encoder", stats["speaker_encoder"])
    elif "speaker_encoder" in tree:
        _encoder(out, "speaker_encoder", tree["speaker_encoder"])
    for name in ("encoder_proj", "speaker_proj", "transducer_head"):
        if name in tree:
            _dense(out, name, tree[name])
    if "joint_network" in tree.get("joiner", {}):
        _dense(out, "joiner.joint_network", tree["joiner"]["joint_network"])
    _predictor(out, "predictor", tree["predictor"])
    return out


def lm_params_from_flax(tree):
    """Flax ``RNNLM`` params (nested numpy dict) -> state_dict of the
    port's ``RNNLM``."""
    tree = tree.get("params", tree)
    out = {"embedding.weight": _t(tree["embedding"]["embedding"])}
    _lstm(out, "rnn", tree["rnn"])
    _dense(out, "dnn", tree["dnn"])
    _dense(out, "out", tree["out"])
    return out


def _conv1d(out, prefix, tree):
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]
                                            ).transpose(2, 1, 0))
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def wavlm_params_from_flax(tree):
    """Flax ``WavLMForXVector`` params (nested numpy dict) -> state_dict
    of the port's ``WavLMForXVector``."""
    tree = tree.get("params", tree)
    out = {}
    wavlm = tree["wavlm"]
    fe = "wavlm.feature_extractor.conv_layers"
    for name, node in wavlm["feature_extractor"].items():
        if name.startswith("conv_"):
            _conv1d(out, f"{fe}.{name[5:]}.conv", node)
        elif name == "group_norm":
            _norm(out, f"{fe}.0.layer_norm", node)
        else:                                       # layer_norm_{i}
            _norm(out, f"{fe}.{name[11:]}.layer_norm", node)
    _norm(out, "wavlm.feature_projection.layer_norm", wavlm["fp_layer_norm"])
    _dense(out, "wavlm.feature_projection.projection",
           wavlm["fp_projection"])
    enc = wavlm["encoder"]
    _conv1d(out, "wavlm.encoder.pos_conv_embed.conv",
            enc["pos_conv_embed"]["conv"])
    _norm(out, "wavlm.encoder.layer_norm", enc["layer_norm"])
    for name, layer in enc.items():
        if not name.startswith("layers_"):
            continue
        p = f"wavlm.encoder.layers.{name[7:]}"
        att = layer["attention"]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj",
                     "gru_rel_pos_linear"):
            _dense(out, f"{p}.attention.{proj}", att[proj])
        out[f"{p}.attention.gru_rel_pos_const"] = _t(att["gru_rel_pos_const"])
        if "rel_attn_embed" in att:
            out[f"{p}.attention.rel_attn_embed.weight"] = _t(
                att["rel_attn_embed"])
        _norm(out, f"{p}.layer_norm", layer["layer_norm"])
        _norm(out, f"{p}.final_layer_norm", layer["final_layer_norm"])
        for dense in ("intermediate_dense", "output_dense"):
            _dense(out, f"{p}.feed_forward.{dense}",
                   layer["feed_forward"][dense])
    if "layer_weights" in tree:
        out["layer_weights"] = _t(tree["layer_weights"])
    for name in ("projector", "feature_extractor", "classifier"):
        _dense(out, name, tree[name])
    for name, node in tree.items():
        if name.startswith("tdnn_"):
            k, c_in, c_out = np.asarray(node["kernel"]).shape
            out[f"tdnn.{name[5:]}.kernel.weight"] = _t(
                np.asarray(node["kernel"]).transpose(2, 0, 1).reshape(
                    c_out, k * c_in))
            out[f"tdnn.{name[5:]}.kernel.bias"] = _t(node["bias"])
    return out


# --------------------------------------------- tensor-parallel shards
def _halves(name):
    """The blocks a split leaf's dim is made of: the GLU's two halves of
    ``pointwise_in``, else one."""
    return 2 if name.endswith("pointwise_in.weight") else 1


def shard_tensor(name, full, dim, index, tp):
    """Rank ``index``'s block of leaf ``name`` split along ``dim`` over
    ``tp`` ranks (its block of each GLU half for ``pointwise_in``)."""
    n = _halves(name)
    parts = full.unflatten(dim, (n, -1)).chunk(tp, dim + 1)
    return parts[index].flatten(dim, dim + 1)


def gather_tensors(name, shards, dim):
    """The inverse of ``shard_tensor``: the ranks' blocks of ``name`` in
    rank order -> the whole leaf."""
    n = _halves(name)
    return torch.cat([s.unflatten(dim, (n, -1)) for s in shards],
                     dim + 1).flatten(dim, dim + 1)


def shard_state_dict(state_dict, index, tp, splits=None):
    """Rank ``index``'s state of a whole ``state_dict`` on a model axis of
    ``tp`` ranks; ``splits`` ({name: dim or None}) defaults to the split
    rule on ``state_dict``'s own shapes. Leaves ``splits`` does not name
    stay whole."""
    if splits is None:
        splits = param_split_dims(state_dict, tp)
    return {k: v if splits.get(k) is None
            else shard_tensor(k, v, splits[k], index, tp).clone()
            for k, v in state_dict.items()}


def gather_state_dicts(states, splits):
    """The whole state of the ranks' ``states`` (in rank order), the
    split leaves joined by ``splits`` (the whole model's
    ``param_split_dims``), the others rank 0's."""
    return {k: v if splits.get(k) is None
            else gather_tensors(k, [s[k] for s in states], splits[k])
            for k, v in states[0].items()}


# torch module names -> flax module names, per path segment
_SEGMENTS = {
    "norm_ffn1": "LayerNorm_0", "norm_ffn2": "LayerNorm_1",
    "norm_in": "LayerNorm_0", "norm_mid": "LayerNorm_1",
    "w1": "Dense_0", "w2": "Dense_1",
}


def _flax_path(key):
    """('frontend', 'blocks', '0', 'conv', 'weight') -> flax path and leaf
    kind (dense, norm, conv2d, depthwise, lstm_w, plain)."""
    parts = key.split(".")
    leaf = parts.pop()
    path, i = [], 0
    while i < len(parts):
        part = parts[i]
        if part in ("blocks", "layers") and i + 1 < len(parts):
            path.append(("block_" if part == "blocks" else "layer_")
                        + parts[i + 1])
            i += 2
            continue
        path.append(_SEGMENTS.get(part, part))
        i += 1
    in_frontend = path[0] in ("frontend", "speaker_frontend")
    if in_frontend and path[-1] in ("conv", "norm"):
        path[-1] += "_0"
    if leaf in ("pos_bias_u", "pos_bias_v"):
        return path + [leaf], "plain"
    if path[-1] == "decoder":                        # LSTM
        kind, n = leaf.rsplit("_l", 1)
        name = {"weight_ih": "w_ih", "weight_hh": "w_hh", "bias": "b"}[kind]
        return path + [f"l{n}_{name}"], "lstm_w" if name != "b" else "plain"
    is_norm = "norm" in path[-1] or path[-1].startswith("LayerNorm") \
        or path[-1] == "asp_bn"
    if leaf in BATCH_STATS:
        return path + [leaf], "plain"
    if is_norm:
        return path + ["scale" if leaf == "weight" else "bias"], "plain"
    if leaf == "bias":
        return path + ["bias"], "plain"
    if path[-1] == "depthwise":
        return path + ["kernel"], "depthwise"
    if in_frontend:
        return path + ["kernel"], "conv2d"
    return path + ["kernel"], "dense"


_TO_FLAX = {
    "plain": lambda x: x,
    "dense": lambda x: x.T,
    "lstm_w": lambda x: x.T,
    "conv2d": lambda x: x.transpose(2, 3, 1, 0),
    "depthwise": lambda x: x.transpose(2, 1, 0),
}
# ECAPA's BatchNorm statistics: buffers here, flax's batch_stats
BATCH_STATS = ("mean", "var")


def params_to_flax(state_dict):
    """The port's ``state_dict`` (or gradients under the same names) ->
    the inner flax parameter tree, nested dicts of f32 numpy arrays.
    ECAPA's statistics are left out (``batch_stats_to_flax``)."""
    return _to_flax({k: v for k, v in state_dict.items()
                     if k.rsplit(".", 1)[-1] not in BATCH_STATS})


def batch_stats_to_flax(state_dict):
    """ECAPA's BatchNorm statistics of a ``state_dict`` -> flax's
    ``batch_stats`` tree ({} without an ECAPA branch)."""
    return _to_flax({k: v for k, v in state_dict.items()
                     if k.rsplit(".", 1)[-1] in BATCH_STATS})


def _to_flax(state_dict):
    tree = {}
    for key, value in state_dict.items():
        path, kind = _flax_path(key)
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        array = np.asarray(value.detach().cpu().numpy()
                           if isinstance(value, torch.Tensor) else value,
                           dtype=np.float32)
        if kind == "dense" and array.ndim == 3:         # ECAPA's Conv1d
            kind = "depthwise"
        node[path[-1]] = np.ascontiguousarray(_TO_FLAX[kind](array))
    return tree


# ------------------------------------------- the speaker-recognition models
def ecapa_params_from_flax(variables):
    """A standalone flax ``ECAPA_TDNN``'s variables (``{"params": ...,
    "batch_stats": ...}``, nested numpy dicts) -> state_dict of the port's
    ``models.ecapa.ECAPA_TDNN``."""
    out = {}
    _ecapa(out, "", variables["params"])
    _ecapa(out, "", variables.get("batch_stats", {}))
    return out


def ecapa_params_to_flax(state_dict):
    """The port's ``ECAPA_TDNN`` state_dict -> flax's ``{"params": ...,
    "batch_stats": ...}``."""
    return {"params": params_to_flax(state_dict),
            "batch_stats": batch_stats_to_flax(state_dict)}


def save_ecapa_from_flax(payload, path):
    """A JAX ECAPA payload's tree (``{"config": {...}, "params": ...,
    "batch_stats": ...}``, the msgpack file the JAX package's speaker
    verification tool reads, restored to nested numpy dicts) -> the
    port's ECAPA file at ``path``: ``torch.save`` of ``{"config": the
    ECAPAConfig keywords, "state_dict": ...}``, which
    ``tsasr_torch.tools.eval_speaker_verification --backend ecapa``
    reads."""
    config = {k: [int(x) for x in v] if isinstance(v, (list, tuple))
              else v.item() if isinstance(v, np.generic) else v
              for k, v in dict(payload.get("config", {})).items()}
    variables = {k: v for k, v in payload.items() if k != "config"}
    torch.save({"config": config,
                "state_dict": ecapa_params_from_flax(variables)}, path)


# flax's numbered modules of Xvector and CosineClassifier -> the port's
# ModuleLists
_LISTS = {"conv": "convs", "norm": "norms", "linear": "linears"}
_LISTS_BACK = {v: k for k, v in _LISTS.items()}


def _head(out, prefix, tree):
    for name, node in tree.items():
        base, _, index = name.rpartition("_")
        key = f"{_LISTS[base]}.{index}" if base in _LISTS else name
        if isinstance(node, dict):
            _head(out, _join(prefix, key), node)
        elif name == "kernel":                      # Conv (k, in, out)
            kernel = np.asarray(node)               # or Dense (in, out)
            out[_join(prefix, "weight")] = _t(
                kernel.transpose(2, 1, 0) if kernel.ndim == 3 else kernel.T)
        elif name == "scale":
            out[_join(prefix, "weight")] = _t(node)
        else:                       # bias, mean, var, the class weights
            out[_join(prefix, name)] = _t(node)


def head_params_from_flax(variables):
    """A flax ``Xvector`` or ``CosineClassifier``'s variables
    (``{"params": ..., "batch_stats": ...}``) -> state_dict of the port's
    module: ``conv_{i}`` / ``norm_{i}`` / ``linear_{i}`` become
    ``convs.{i}`` / ``norms.{i}`` / ``linears.{i}``, a Conv kernel
    (k, in, out) the weight (out, in, k), a Dense kernel its transpose, a
    BatchNorm's ``scale`` its ``weight`` and its ``batch_stats`` its
    buffers; the classifier's class ``weight`` (out, in) is kept."""
    out = {}
    _head(out, "", variables["params"])
    _head(out, "", variables.get("batch_stats", {}))
    return out


def head_params_to_flax(state_dict):
    """The inverse of ``head_params_from_flax``: a port ``Xvector`` or
    ``CosineClassifier`` state_dict -> ``{"params": ..., "batch_stats":
    ...}`` of f32 numpy arrays."""
    trees = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        *parts, leaf = key.split(".")
        path = []
        while parts:
            name = parts.pop(0)
            path.append(f"{_LISTS_BACK[name]}_{parts.pop(0)}"
                        if name in _LISTS_BACK else name)
        array = np.asarray(value.detach().cpu().numpy(), np.float32)
        if leaf == "weight" and path:
            if path[-1].startswith("norm"):
                leaf = "scale"
            else:
                leaf = "kernel"
                array = array.transpose(2, 1, 0) if array.ndim == 3 \
                    else array.T
        node = trees["batch_stats" if leaf in BATCH_STATS else "params"]
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(array)
    return trees
