"""ctypes binding for the native host runtime (``native/tsasr_native.cpp``).

The port's own copy of the JAX package's ``native.py``. It compiles the
same repo source with ``g++`` on first use, into
``build/tsasr_torch/libtsasr_native-<hash>.so`` at the root of the
checkout (listed in ``.gitignore``); the file name carries a hash of the
source and the flags, so an edited source is rebuilt. Every entry point
returns None when the library is unavailable, and its caller then takes
the pure Python path that the JAX package takes without its library:
the WAV and FLAC decoders and the resampler of ``tsasr_torch.data``.
These are host code for the data loader, not device kernels.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_LIB = None
_TRIED = False
_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "tsasr_native.cpp"
BUILD_DIR = _ROOT / "build" / "tsasr_torch"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")


def library_path():
    """Path of the built library for the current source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtsasr_native-{digest}.so"


def build(force=False):
    """Compile the native library (no-op if present and current)."""
    path = library_path()
    if path.exists() and not force:
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    result = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                            capture_output=True, text=True, check=False)
    if result.returncode != 0:
        raise RuntimeError(f"native build failed:\n{result.stderr}")
    os.replace(tmp, path)
    return path


def get_lib(auto_build=True):
    """The loaded library, or None when unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not SOURCE.exists():
        return None
    path = library_path()
    if not path.exists() and auto_build:
        try:
            build()
        except (RuntimeError, OSError) as e:
            logger.info("native library unavailable (%s); using Python "
                        "paths", e)
            return None
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    _bind(lib)
    _LIB = lib
    return _LIB


def _bind(lib):
    lib.tsasr_wav_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
    lib.tsasr_wav_read.restype = ctypes.c_int
    lib.tsasr_flac_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
    lib.tsasr_flac_read.restype = ctypes.c_int
    lib.tsasr_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64)]
    lib.tsasr_resample.restype = ctypes.c_int
    lib.tsasr_free.argtypes = [ctypes.c_void_p]


def _take_floats(lib, ptr, n):
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.tsasr_free(ptr)
    return arr


def wav_read(path):
    """Native WAV decode -> (float32 (L,), sr); None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    rc = lib.tsasr_wav_read(path.encode(), ctypes.byref(out),
                            ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        return None
    return _take_floats(lib, out, n.value), sr.value


def flac_read(path):
    """Native FLAC decode -> (float32 (L,), sr); None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    rc = lib.tsasr_flac_read(path.encode(), ctypes.byref(out),
                             ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        return None
    return _take_floats(lib, out, n.value), sr.value


def resample(waveform, orig_freq, new_freq):
    """Native polyphase resample; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    wav = np.ascontiguousarray(waveform, np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.tsasr_resample(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(wav),
        int(orig_freq), int(new_freq), ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        return None
    return _take_floats(lib, out, n.value)
