"""Component registry: swap a piece of the model graph from the yaml.

Counterpart of the JAX package's ``models/registry.py``.
``TSTransducerConfig.{frontend,encoder,predictor,joiner}_class`` take a
registered name (``@register("encoder", "my_encoder")``) or a dotted
import path (``mypkg.mymod.MyEncoder``), plain yaml strings that the CLI
overrides like any key (``--encoder_class mypkg.MyEncoder``).
``TSTransducer`` resolves each through ``resolve`` and builds it with the
keyword arguments it gives the built-in it replaces. Those keywords are
the swap contract:

- ``frontend``: ``n_mels``, ``out_channels``, ``strides``, ``dropout``,
  ``dropout_bits``, ``causal``, ``dtype``;
- ``encoder``: ``input_size``, ``d_model``, ``nhead``, ``num_layers``,
  ``d_ffn``, ``kernel_size``, ``dropout``, ``dropout_bits``,
  ``injection_mode``, ``injection_after``, ``fused_attention``,
  ``causal``, ``att_context_size``, ``remat``, ``remat_policy``,
  ``dtype``;
- ``predictor``: ``vocab_size``, ``blank_index``, ``hidden_size``,
  ``num_layers``, ``joint_dim``, ``dtype``;
- ``joiner``: ``joint_dim``, ``mode``, ``dtype``.

A swapped class is an ``nn.Module`` with the built-in's calls too
(``models.frontend.ConvolutionFrontEnd``, ``models.conformer.
TSConformerEncoder``, ``models.transducer.Predictor`` and ``Joiner``).
Where a flax module takes its randomness from the apply's rng streams,
the port's modules take the step's ``torch.Generator`` as the
``generator`` argument of their forward (with ``deterministic``), and
tensors come on the caller's device: a replacement follows both. The
speaker branch keeps the built-in frontend and encoder, as in JAX.
"""

import importlib

_REGISTRY = {}


def register(kind, name):
    """Decorator: ``@register("encoder", "my_encoder")``."""

    def deco(cls):
        _REGISTRY.setdefault(kind, {})[name] = cls
        return cls

    return deco


def available(kind):
    """Registered names for one component kind."""
    return sorted(_REGISTRY.get(kind, {}))


def resolve(kind, spec):
    """Registry name / dotted path / class -> class (None passes through).

    Raises ValueError with the registered names on an unknown name."""
    if spec is None or not isinstance(spec, str):
        return spec
    table = _REGISTRY.get(kind, {})
    if spec in table:
        return table[spec]
    if "." in spec:
        module, _, attr = spec.rpartition(".")
        try:
            return getattr(importlib.import_module(module), attr)
        except (ImportError, AttributeError) as e:
            raise ValueError(
                f"cannot import {kind} class {spec!r}: {e}") from e
    raise ValueError(
        f"unknown {kind} class {spec!r}; registered: {available(kind)} "
        f"(or pass a dotted import path)")
