"""ctypes bindings of the native host DSP library (counterpart of
serenade_tpu/native/__init__.py).

``native/serenade_native.cpp`` at the repository's root holds C++
versions of YIN, Harvest, CheapTrick, band aperiodicity and SPTK's freqt,
the role pyworld's and pysptk's C code plays in the reference, for hosts
that run the analysis without a card.  The port builds its own copy at
first use:

    g++ -O3 -fPIC -shared -std=c++17 -Wall \\
        -o build/serenade_tpu_torch/libserenade_native-<hash>.so \\
        native/serenade_native.cpp

into the kernels' build directory (``ops/_cuda.build_dir``), the name
hashed by the source, so an edited source is rebuilt and a stale library
never loaded.  Nothing falls back: a library that cannot be built or
loaded raises with the cause.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from serenade_tpu_torch.ops._cuda import build_dir
from serenade_tpu_torch.ops.world import band_edges

SOURCE = Path(__file__).resolve().parent.parent / "native" / \
    "serenade_native.cpp"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "sn_yin_f0": (ctypes.c_int, [_F32P, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_double, ctypes.c_double,
                                 ctypes.c_double, ctypes.c_double, _F32P,
                                 _F32P]),
    "sn_harvest_f0": (ctypes.c_int, [_F32P, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_double, ctypes.c_double,
                                     ctypes.c_double, _F32P, _F32P]),
    "sn_cheaptrick": (ctypes.c_int, [_F32P, ctypes.c_int64, ctypes.c_int,
                                     _F32P, ctypes.c_int, ctypes.c_double,
                                     ctypes.c_double, ctypes.c_int, _F64P]),
    "sn_band_aperiodicity": (ctypes.c_int, [_F32P, ctypes.c_int64,
                                            ctypes.c_int, _F32P,
                                            ctypes.c_int, ctypes.c_double,
                                            _F32P]),
    "sn_freqt": (None, [_F64P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_double, _F64P]),
}


def _target() -> Path:
    if not SOURCE.exists():
        raise RuntimeError(f"the native library's source {SOURCE} is missing")
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return build_dir() / f"libserenade_native-{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    ``RuntimeError`` naming the cause (no source, no C++ compiler, the
    compiler's errors)."""
    out = _target()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("building the native library needs a C++ "
                           "compiler (g++); none is on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, "-O3", "-fPIC", "-shared", "-std=c++17",
                               "-Wall", "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"building {SOURCE.name}: cannot run the C++ "
                           f"compiler {cxx!r}: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built on first use, every entry's argument and
    result types declared."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _LIB = lib
        return _LIB


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1), np.float32)


def yin_f0_native(audio: np.ndarray, fs: int = 24000,
                  f0_floor: float = 60.0, f0_ceil: float = 1100.0,
                  frame_period_ms: float = 10.0, threshold: float = 0.12
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Native YIN; the contract of ``ops/f0.yin_f0`` for one waveform."""
    audio = _f32(audio)
    n_frames = 1 + len(audio) // int(fs * frame_period_ms / 1000.0)
    f0 = np.zeros(n_frames, np.float32)
    vuv = np.zeros(n_frames, np.float32)
    ret = library().sn_yin_f0(
        audio.ctypes.data_as(_F32P), len(audio), fs, f0_floor, f0_ceil,
        frame_period_ms, threshold, f0.ctypes.data_as(_F32P),
        vuv.ctypes.data_as(_F32P))
    if ret != n_frames:
        raise RuntimeError(f"sn_yin_f0 failed (ret={ret})")
    return f0, vuv


def harvest_f0_native(audio: np.ndarray, fs: int = 24000,
                      f0_floor: float = 60.0, f0_ceil: float = 1100.0,
                      frame_period_ms: float = 10.0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Native Harvest-class F0; the contract (and algorithm) of
    ``ops/harvest.harvest_f0`` for one waveform, on the host."""
    audio = _f32(audio)
    n_frames = 1 + len(audio) // int(fs * frame_period_ms / 1000.0)
    f0 = np.zeros(n_frames, np.float32)
    vuv = np.zeros(n_frames, np.float32)
    ret = library().sn_harvest_f0(
        audio.ctypes.data_as(_F32P), len(audio), fs, f0_floor, f0_ceil,
        frame_period_ms, f0.ctypes.data_as(_F32P),
        vuv.ctypes.data_as(_F32P))
    if ret != n_frames:
        raise RuntimeError(f"sn_harvest_f0 failed (ret={ret})")
    return f0, vuv


def cheaptrick_native(audio: np.ndarray, f0: np.ndarray, fs: int = 24000,
                      f0_floor: float = 71.0, frame_period_ms: float = 5.0,
                      fft_size: Optional[int] = None) -> np.ndarray:
    """Native CheapTrick envelope ``(T, fft_size // 2 + 1)`` f64; the
    contract of ``ops/world.cheaptrick``.  Raises where the F0 track is
    longer than the waveform supports."""
    if fft_size is None:
        fft_size = 1 << math.ceil(math.log2(3.0 * fs / f0_floor + 1.0))
    audio, f0 = _f32(audio), _f32(f0)
    out = np.zeros((len(f0), fft_size // 2 + 1), np.float64)
    ret = library().sn_cheaptrick(
        audio.ctypes.data_as(_F32P), len(audio), fs,
        f0.ctypes.data_as(_F32P), len(f0), f0_floor, frame_period_ms,
        fft_size, out.ctypes.data_as(_F64P))
    if ret != 0:
        raise RuntimeError(f"sn_cheaptrick failed (ret={ret})")
    return out


def band_aperiodicity_native(audio: np.ndarray, f0: np.ndarray,
                             fs: int = 24000,
                             frame_period_ms: float = 5.0) -> np.ndarray:
    """Native coarse band aperiodicity in dB ``(T, n_bands)`` f32; the
    contract of ``ops/world.band_aperiodicity``."""
    audio, f0 = _f32(audio), _f32(f0)
    n_bands = len(band_edges(fs))
    out = np.zeros((len(f0), n_bands), np.float32)
    ret = library().sn_band_aperiodicity(
        audio.ctypes.data_as(_F32P), len(audio), fs,
        f0.ctypes.data_as(_F32P), len(f0), frame_period_ms,
        out.ctypes.data_as(_F32P))
    if ret != n_bands:
        raise RuntimeError(f"sn_band_aperiodicity failed (ret={ret})")
    return out


def freqt_native(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Native SPTK freqt; the contract of ``ops/sptk.freqt``."""
    c = np.ascontiguousarray(c, np.float64)
    squeeze = c.ndim == 1
    if squeeze:
        c = c[None]
    out = np.zeros((c.shape[0], order + 1), np.float64)
    library().sn_freqt(c.ctypes.data_as(_F64P), c.shape[0], c.shape[1],
                       order, alpha, out.ctypes.data_as(_F64P))
    return out[0] if squeeze else out
