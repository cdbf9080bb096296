"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/serenade_tpu_torch/lib<name>-<hash>.so

The file name carries a hash of the source, so an edited kernel is rebuilt
and a stale library is never loaded.  Builds go to
``build/serenade_tpu_torch/`` beside the package (``SERENADE_TORCH_BUILD_DIR``
overrides it).  Nothing here runs at import time: ``library(name)`` builds
on first use, and ``build_all()`` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
SOURCES = ("flash_fwd", "flash_bwd", "block1d_fwd", "block1d_bwd",
           "resblock_branch")

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


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    common = (CSRC_DIR / "common.cuh").read_bytes()
    digest = hashlib.sha1(src + common).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def _command(name: str, out: Path) -> List[str]:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-I", str(CSRC_DIR),
            "-o", str(out) + ".tmp", str(CSRC_DIR / f"{name}.cu")]


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` process per source,
    all started together.  Returns each compiled source's ptxas report
    (registers, shared memory, spills); raises with the compiler's output
    on failure."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if not out.exists():
            procs[name] = (out, subprocess.Popen(
                _command(name, out), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{logs[name]}")
        else:
            os.replace(str(out) + ".tmp", out)
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
