"""HyperPyYAML-compatible hyperparameter loading.

The reference's entire config layer is HyperPyYAML (SURVEY.md §1 L7): the
YAML file *is* the object graph, with tags

- ``!ref <key>``            reference (or arithmetic/string interpolation
                            over) previously-defined keys
- ``!new:module.Class``     instantiate with args (sequence) or kwargs
                            (mapping)
- ``!name:module.func``     partial application
- ``!apply:module.func``    call at load time
- ``!PLACEHOLDER``          must be overridden (e.g. --data_folder)
- ``!tuple (a, b)``         literal tuples

plus command-line overrides where any ``--key value`` replaces the
top-level key before resolution. This module is a fresh implementation of
that contract on PyYAML (the external hyperpyyaml dependency is not
vendored): two-phase load (parse with marker objects, apply overrides,
resolve in dependency order with cycle detection), arithmetic evaluation
of interpolated refs via a restricted AST.
"""

import ast
import copy
import importlib
import operator
import re
from functools import partial

import yaml


class Ref:
    def __init__(self, expr):
        self.expr = expr

    def __repr__(self):
        return f"Ref({self.expr!r})"


class Copy(Ref):
    pass


class New:
    def __init__(self, path, payload):
        self.path = path
        self.payload = payload


class Name(New):
    pass


class Apply(New):
    pass


class Placeholder:
    def __repr__(self):
        return "!PLACEHOLDER"


def _make_loader():
    class HpLoader(yaml.SafeLoader):
        pass

    def construct_any(loader, node):
        if isinstance(node, yaml.MappingNode):
            return loader.construct_mapping(node, deep=True)
        if isinstance(node, yaml.SequenceNode):
            return loader.construct_sequence(node, deep=True)
        return loader.construct_scalar(node)

    def ref_constructor(loader, node):
        return Ref(loader.construct_scalar(node))

    def copy_constructor(loader, node):
        return Copy(loader.construct_scalar(node))

    def placeholder_constructor(loader, node):
        return Placeholder()

    def multi(cls):
        def constructor(loader, tag_suffix, node):
            return cls(tag_suffix, construct_any(loader, node))
        return constructor

    def tuple_constructor(loader, node):
        string = loader.construct_scalar(node)
        return tuple(yaml.safe_load(string.replace("(", "[")
                                    .replace(")", "]")))

    HpLoader.add_constructor("!ref", ref_constructor)
    HpLoader.add_constructor("!copy", copy_constructor)
    HpLoader.add_constructor("!PLACEHOLDER", placeholder_constructor)
    HpLoader.add_constructor("!tuple", tuple_constructor)
    HpLoader.add_multi_constructor("!new:", multi(New))
    HpLoader.add_multi_constructor("!name:", multi(Name))
    HpLoader.add_multi_constructor("!apply:", multi(Apply))
    # bare python tuples written as "(a, b)" strings stay strings; the
    # reference writes tuples like out_channels: (128, 128) — resolve at
    # instantiation time via _maybe_tuple.
    return HpLoader


_REF_PATTERN = re.compile(r"<([^<>]*)>")

_ALLOWED_BINOPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod, ast.Pow: operator.pow,
}


def _safe_arith(expr):
    """Evaluate a pure-arithmetic expression; raise on anything else."""

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(
                node.value, (int, float)):
            return node.value
        if isinstance(node, ast.BinOp) and type(node.op) in _ALLOWED_BINOPS:
            return _ALLOWED_BINOPS[type(node.op)](ev(node.left),
                                                  ev(node.right))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev(node.operand)
        raise ValueError("not arithmetic")

    return ev(ast.parse(expr, mode="eval"))


def _import_path(path):
    module, _, attr = path.rpartition(".")
    if not module:
        raise ImportError(f"Cannot import '{path}': no module part")
    return getattr(importlib.import_module(module), attr)


def _maybe_tuple(value):
    """The reference YAMLs write tuples as strings: "(128, 128)"."""
    if isinstance(value, str) and value.startswith("(") \
            and value.endswith(")"):
        try:
            inner = yaml.safe_load("[" + value[1:-1] + "]")
            return tuple(inner)
        except yaml.YAMLError:
            return value
    return value


class _Resolver:
    def __init__(self, tree):
        self.tree = tree
        self.resolved = {}
        self.in_progress = set()

    def top(self, key):
        if key in self.resolved:
            return self.resolved[key]
        if key not in self.tree:
            raise KeyError(f"!ref to unknown key: <{key}>")
        if key in self.in_progress:
            raise RuntimeError(f"Circular !ref involving <{key}>")
        self.in_progress.add(key)
        try:
            self.resolved[key] = self.value(self.tree[key])
        finally:
            self.in_progress.discard(key)
        return self.resolved[key]

    def value(self, node):
        if isinstance(node, Copy):
            return copy.deepcopy(self._resolve_ref(node.expr))
        if isinstance(node, Ref):
            return self._resolve_ref(node.expr)
        if isinstance(node, Placeholder):
            raise ValueError(
                "A !PLACEHOLDER value was not overridden (pass it on the "
                "command line, e.g. --data_folder=...)")
        if isinstance(node, Apply):
            return self._call(node, immediately=True)
        if isinstance(node, Name):
            return self._call(node, immediately=False)
        if isinstance(node, New):
            return self._instantiate(node)
        if isinstance(node, dict):
            return {k: self.value(v) for k, v in node.items()}
        if isinstance(node, list):
            return [self.value(v) for v in node]
        return node

    def _resolve_ref(self, expr):
        refs = _REF_PATTERN.findall(expr)
        if not refs:
            return expr
        whole = f"<{refs[0]}>"
        if len(refs) == 1 and expr.strip() == whole:
            return self._lookup(refs[0])

        def substitute(match):
            return str(self._lookup(match.group(1)))

        substituted = _REF_PATTERN.sub(substitute, expr)
        try:
            return _safe_arith(substituted)
        except (ValueError, SyntaxError):
            return substituted

    def _lookup(self, dotted):
        """<key> or <key[sub][keys]> style lookup (top-level + indexing)."""
        parts = dotted.split("[")
        value = self.top(parts[0].strip())
        for p in parts[1:]:
            idx = p.rstrip("]")
            value = value[int(idx)] if idx.lstrip("-").isdigit() \
                else value[idx]
        return value

    def _payload_to_args(self, payload):
        if payload is None or payload == "":
            return (), {}
        resolved = self.value(payload)
        if isinstance(resolved, dict):
            return (), {k: _maybe_tuple(v) for k, v in resolved.items()}
        if isinstance(resolved, (list, tuple)):
            return tuple(_maybe_tuple(v) for v in resolved), {}
        return (resolved,), {}

    def _instantiate(self, node):
        cls = _import_path(node.path)
        args, kwargs = self._payload_to_args(node.payload)
        return cls(*args, **kwargs)

    def _call(self, node, immediately):
        func = _import_path(node.path)
        args, kwargs = self._payload_to_args(node.payload)
        if immediately:
            return func(*args, **kwargs)
        if args or kwargs:
            return partial(func, *args, **kwargs)
        return func


def hparams_getter(hparams):
    """A ``get(key, default=None)`` over dict or namespace hparams."""
    if hasattr(hparams, "get"):
        return hparams.get
    return lambda k, d=None: getattr(hparams, k, d)


def parse_overrides(overrides):
    """Overrides: dict, YAML string, or None -> dict."""
    if overrides is None:
        return {}
    if isinstance(overrides, str):
        return yaml.load(overrides, Loader=_make_loader()) or {}
    return dict(overrides)


def load_hyperpyyaml(stream, overrides=None, overrides_must_match=True):
    """Load a hparams YAML with object instantiation + overrides.

    Mirrors the public contract of ``hyperpyyaml.load_hyperpyyaml`` for the
    tag subset the reference recipes use.
    """
    if hasattr(stream, "read"):
        stream = stream.read()
    tree = yaml.load(stream, Loader=_make_loader()) or {}
    if not isinstance(tree, dict):
        raise ValueError("hparams root must be a mapping")
    for key, value in parse_overrides(overrides).items():
        if overrides_must_match and key not in tree:
            raise KeyError(f"Override for unknown hparam: {key}")
        tree[key] = value
    resolver = _Resolver(tree)
    return {key: resolver.top(key) for key in tree}


def dump_resolved_yaml(hparams_path, overrides, out_path):
    """Write the hparams file with overrides applied (textually), like the
    reference's resolved ``hyperparams.yaml`` in the experiment dir."""
    with open(hparams_path, encoding="utf-8") as f:
        text = f.read()
    ov = parse_overrides(overrides)
    if ov:
        text += "\n# --- Overrides ---\n"
        for key, value in ov.items():
            text += f"{key}: {value}\n"
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(text)
