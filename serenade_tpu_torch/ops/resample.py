"""Polyphase resampling on the device (counterpart of
serenade_tpu/ops/resample.py): ``scipy.signal.resample_poly`` per row.

The raw-audio path resamples the 24 kHz waveform to ContentVec's 16 kHz on
the card, so one (int16) upload feeds both the signal features and
ContentVec.  The taps are scipy's (a kaiser-5.0-windowed sinc of half
length ``10 * max(up, down)``, scaled by ``up``); the filter is
zero-stuffing by ``up`` and a strided convolution by ``down``, as JAX's
``conv_general_dilated`` with ``lhs_dilation=up`` at
``serenade_tpu/ops/resample.py:72``, written as windows times the taps
(``ops/conv_f32.py``: f32, no cuDNN).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from serenade_tpu_torch.ops.conv_f32 import conv1d_f32


@functools.lru_cache(maxsize=None)
def resample_poly_taps(up: int, down: int) -> np.ndarray:
    """The FIR scipy.signal.resample_poly builds for (up, down)."""
    from scipy.signal import firwin

    g = math.gcd(up, down)
    up, down = up // g, down // g
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return (h * up).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _taps(up: int, down: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(resample_poly_taps(up, down), dtype=torch.float32,
                        device=device)


def resample_device(x, up: int, down: int):
    """``(B, n)`` f32 or int16 -> ``(B, ceil(n * up / down))`` f32, each row
    as ``scipy.signal.resample_poly(row, up, down)``.  int16 input is
    dequantized here (``/ 32768``, read_wav's PCM16 convention)."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if not x.is_floating_point():
        x = x.float() / 32768.0
    x = x.float()
    if up == down:
        return x
    h = _taps(up, down, x.device)
    half_len = (len(h) - 1) // 2
    b, n = x.shape
    target = (n * up + down - 1) // down
    # zero-stuffed signal with JAX's padding: half_len before, and after
    # it enough that the strided windows reach ``target`` outputs
    pad_r = half_len + up + down
    stuffed = x.new_zeros((b, half_len + (n - 1) * up + 1 + pad_r))
    stuffed[:, half_len:half_len + (n - 1) * up + 1:up] = x
    y = conv1d_f32(stuffed[:, :, None], h.view(1, 1, -1), stride=down)
    return y[:, :target, 0]
