"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/serenade_tpu_torch/lib<name>-<hash>.so \\
         csrc/<name>.cu -lcuda

The file name carries a hash of the source and of every ``csrc/*.cuh``
header, so an edited kernel or header is rebuilt and a stale library is
never loaded.  Each library links libcuda (``-lcuda``) for the TMA
descriptors that K1 and K7 encode at launch.  Builds go to
``build/serenade_tpu_torch/`` beside the package (``SERENADE_TORCH_BUILD_DIR``
overrides it).  Nothing here runs at import time: ``library(name)`` builds
on first use, and ``build_all()`` starts one ``nvcc`` per source at once.
Builds hold an ``fcntl`` lock on the build directory and compile into a
temporary file named by the process, so several processes (the ranks of
a parallel layout, test workers) starting on one fresh directory build
each library once, and none loads a half-written one.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Dict, List

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
SOURCES = ("flash_fwd", "flash_bwd", "block1d_fwd", "block1d_bwd",
           "resblock_branch", "viterbi_f0")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    forced = os.environ.get("SERENADE_TORCH_BUILD_DIR")
    if forced:
        return Path(forced)
    return _PKG_DIR.parent / "build" / "serenade_tpu_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit")


def _target(name: str, csrc: Path = CSRC_DIR) -> Path:
    """The library of ``<name>.cu``, named by a hash of that source and of
    every header in ``csrc`` (any of them may be included)."""
    digest = hashlib.sha1((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> List[str]:
    """The ``nvcc`` command that compiles ``<name>.cu`` into ``out``."""
    nvcc = _nvcc()
    # libcuda, for cuTensorMapEncodeTiled (TMA descriptors); the toolkit's
    # stub satisfies the link, the installed libcuda is loaded at run time
    home = Path(nvcc).resolve().parent.parent
    stubs = [f"-L{d}" for d in (home / "lib64" / "stubs",
                                home / "targets" / "x86_64-linux" / "lib"
                                / "stubs") if d.is_dir()]
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-I", str(CSRC_DIR),
            "-o", str(out), str(CSRC_DIR / f"{name}.cu"),
            *stubs[:1], "-lcuda"]


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` process per source,
    all started together.  Returns each compiled source's ptxas report
    (registers, shared memory, spills); raises with the compiler's output
    on failure."""
    build_dir().mkdir(parents=True, exist_ok=True)
    with open(build_dir() / ".build.lock", "w") as lock:
        # one builder at a time: a process that waited finds the libraries
        # built and compiles nothing
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build(names)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build(names) -> Dict[str, str]:
    procs = {}
    for name in names:
        out = _target(name)
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs[name] = (out, tmp, subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(out))
            _LIBS[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The multiprocessors of a CUDA device, which the launch plans read."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def _stamp(t: torch.Tensor) -> tuple:
    # an inference tensor keeps no version counter (and cannot be changed
    # in place outside inference mode)
    return (-1 if t.is_inference() else t._version, t.data_ptr(), t.dtype,
            t.device, tuple(t.shape))


class VersionCache:
    """Operands a kernel derives from its weights (a relayout, a split into
    parts), made once per version of the weight tensors instead of once a
    call.  An entry is reused while every source tensor is the same live
    object with the same version counter (bumped by every in-place
    update, the optimizer's ``torch._foreach_*`` ones included), storage,
    type and shape; it is dropped when a source tensor is freed.  Writes
    through ``tensor.data`` bypass the version counter and are not seen:
    update weights in place under ``torch.no_grad()`` instead."""

    def __init__(self, make):
        self._make = make
        self._entries = {}

    def __call__(self, *tensors):
        key = tuple(map(id, tensors))
        stamp = tuple(map(_stamp, tensors))
        hit = self._entries.get(key)
        if (hit is not None and hit[1] == stamp
                and all(ref() is t for ref, t in zip(hit[0], tensors))):
            return hit[2]
        value = self._make(*tensors)
        drop = functools.partial(self._drop, key)
        self._entries[key] = (tuple(weakref.ref(t, drop) for t in tensors),
                              stamp, value)
        return value

    def _drop(self, key, _ref):
        self._entries.pop(key, None)

    def __len__(self):
        return len(self._entries)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
