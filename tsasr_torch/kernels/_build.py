"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``tsasr_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on first use for ``sm_90a`` into ``build/tsasr_torch/`` at the
root of the checkout (listed in ``.gitignore``). The library's file name
carries a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source is rebuilt and an unchanged one is loaded as
it is. ``build`` starts one
``nvcc`` per missing source, all at once, and waits for all of them.
Nothing here runs at import time: the CPU tests import every module on
hosts without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tsasr_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"seconds": build time, "log": nvcc's output (ptxas report)}
build_log = {}
_libs = {}
_lock = threading.Lock()


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc was not found (CUDA_HOME/bin or PATH); it is needed to "
            "build the CUDA kernels of tsasr_torch")
    return found


def library_path(name):
    """Path of the built library for ``csrc/<name>.cu`` (may not exist)."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names):
    """Compile every ``csrc/<name>.cu`` not built yet, in parallel.

    Raises ``RuntimeError`` with nvcc's output if a build fails.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))


def check_launch(err, name):
    """Raise if a launcher returned a CUDA error code other than 0."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
