"""PyTorch/CUDA port of ``serenade_tpu`` for one NVIDIA H100.

The JAX package ``serenade_tpu`` stays the reference; this package mirrors
its file names and its channels-last ``(B, T, C)`` layout at every public
function.  It imports ``torch``, ``numpy`` and ``scipy`` only.  The three
TPU kernels on the conversion path (flash attention, fused Block1D,
HiFiGAN residual branch) and the Viterbi trellis of F0 extraction are
CUDA C++ kernels under ``csrc/``, built with ``nvcc`` at first use
(``ops/_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def upload(a, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array on ``device``.  On CUDA it goes through pinned memory
    without blocking: a pageable copy would wait for everything queued on
    the stream, so the next batch's inputs could not overlap the running
    batch's compute."""
    t = torch.from_numpy(np.array(a, dtype))  # a copy: ``a`` may be read-only
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
