"""Import and device hygiene of tsasr_torch: it imports no JAX, flax,
tsasr_tpu, HF transformers or the safetensors package, its entry points
default to CUDA and raise without it, and its kernel modules import (and
run on the CPU) without nvcc."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tsasr_torch
from tsasr_torch.data.tokenizer import CharTokenizer
from tsasr_torch.device import resolve_device
from tsasr_torch.inference import TSASRTranscriber
from tsasr_torch.kernels import _build, relpos_attention
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.training.brain import onednn_off_on_cpu

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "tsasr_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        tsasr_torch.__path__, "tsasr_torch."))


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)


def test_every_module_imports_without_jax():
    mods = _modules()
    for name in ("kernels.relpos_attention", "ops.augment", "models.wavlm",
                 "recipes.speaker_embeddings", "utils.safetensors_io",
                 "train_librispeechmix_none",
                 "train_librispeechmix_pretrained"):
        assert f"tsasr_torch.{name}" in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tsasr_tpu', 'transformers', "
        "'safetensors'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = _run(code)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|"
                         r"transformers|safetensors)\b|tsasr_tpu",
                         re.MULTILINE)
    offenders = [str(path.relative_to(REPO))
                 for path in PACKAGE.rglob("*")
                 if path.suffix in (".py", ".cu")
                 and pattern.search(path.read_text(encoding="utf-8"))]
    assert offenders == []


def test_onednn_is_off_only_inside_a_cpu_training_step():
    """Resolving the CPU leaves oneDNN alone; the training step's context
    turns it off on the CPU only, and restores it."""
    before = torch.backends.mkldnn.enabled
    resolve_device("cpu")
    assert torch.backends.mkldnn.enabled == before
    with onednn_off_on_cpu("cpu"):
        assert not torch.backends.mkldnn.enabled
    assert torch.backends.mkldnn.enabled == before
    with onednn_off_on_cpu("cuda"):
        assert torch.backends.mkldnn.enabled == before


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    model = TSTransducer(TSTransducerConfig(
        d_model=16, nhead=2, encoder_num_layers=1, d_ffn=16,
        speaker_encoder_layers=1, decoder_neurons=8, joint_dim=8,
        frontend_channels=(4, 4)))
    tok = CharTokenizer(["<unk>", "▁", "a"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSASRTranscriber(model, None, tok)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSASRTranscriber(model, None, tok, device="cuda:0")


def test_kernel_module_imports_and_runs_on_cpu_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    code = (
        "import torch\n"
        "from tsasr_torch.kernels import _build, relpos_attention as ra\n"
        "B, H, T, D = 1, 2, 5, 4\n"
        "q = torch.randn(B, H, T, D)\n"
        "out = ra.fused_relpos_attention(q, q, q, q, torch.randn(H, 2*T-1, D),"
        " torch.zeros(B, T), torch.zeros(T, T), seed=0, scale=0.5, rate=0.0)\n"
        "assert out.shape == q.shape and ra.launches == 0\n"
        "assert not _build._libs and not _build.build_log\n"
        "try:\n"
        "    _build._nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('NO NVCC:', e)\n")
    res = _run(code, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NO NVCC" in res.stdout


def test_build_names_library_by_source_and_flags():
    path = _build.library_path(relpos_attention.SOURCE)
    assert path.parent == REPO / "build" / "tsasr_torch"
    assert path.name.startswith("librelpos_attention_fwd-")
    assert (_build.CSRC / "relpos_attention_fwd.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    gitignore = (REPO / ".gitignore").read_text().split()
    assert "build/" in gitignore


def test_transcriber_keeps_cpu_when_asked():
    model = TSTransducer(TSTransducerConfig(
        d_model=16, nhead=2, encoder_num_layers=1, d_ffn=16,
        speaker_encoder_layers=1, decoder_neurons=8, joint_dim=8,
        frontend_channels=(4, 4), vocab_size=3)).init_weights(seed=1)
    tr = TSASRTranscriber(model, None, CharTokenizer(["<unk>", "▁", "a"]),
                          device="cpu")
    wav = np.random.default_rng(0).normal(size=4000).astype(np.float32)
    out = tr.transcribe_batch([wav, wav[:3000]], [wav, wav])
    assert len(out) == 2 and all(set(t) <= {"a", " "} for t in out)
    assert all(p.device.type == "cpu" for p in tr.model.parameters())
