"""Mel-cepstral analysis on the host (copied from serenade_tpu/ops/sptk.py).

Counterparts of pysptk's ``sp2mc``, ``mc2sp`` and ``freqt``, in f64
numpy; the frequency-warping recursion is vectorized over all frames at
once.  With alpha the all-pass warping constant (0.466 at 24 kHz):

  sp2mc:  mc = freqt(c, order, alpha) with c the real cepstrum of
          log(powerspec), c[0] halved (one-sided correction);
  mc2sp:  sp = exp(Re(rfft(c2))) with c2 the two-sided mirror of
          freqt(mc, fftlen//2, -alpha) (index 0 doubled back).
"""

from __future__ import annotations

import numpy as np

# all-pass warping constants by sampling rate
ALPHA = {
    8000: 0.312,
    12000: 0.369,
    16000: 0.410,
    22050: 0.455,
    24000: 0.466,
    32000: 0.504,
    44100: 0.544,
    48000: 0.554,
}


def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Frequency-warp cepstra ``c`` (..., L) to order+1 coefficients."""
    c = np.asarray(c, np.float64)
    batch_shape = c.shape[:-1]
    L = c.shape[-1]
    g = np.zeros(batch_shape + (order + 1,), np.float64)
    for i in range(L - 1, -1, -1):
        d = g.copy()
        g[..., 0] = c[..., i] + alpha * d[..., 0]
        if order >= 1:
            g[..., 1] = (1.0 - alpha**2) * d[..., 0] + alpha * d[..., 1]
        for m in range(2, order + 1):
            g[..., m] = d[..., m - 1] + alpha * (d[..., m] - g[..., m - 1])
    return g


def sp2mc(powerspec: np.ndarray, order: int, alpha: float,
          log_input: bool = False) -> np.ndarray:
    """Power spectrum (..., fftlen//2+1) -> mel-cepstrum (..., order+1);
    ``log_input`` takes an already-log power spectrum."""
    if log_input:
        logsp = np.asarray(powerspec, np.float64)
    else:
        logsp = np.log(np.maximum(np.asarray(powerspec, np.float64), 1e-300))
    c = np.fft.irfft(logsp, axis=-1)  # (..., fftlen) real cepstrum
    c = c[..., : logsp.shape[-1]]     # one-sided
    c[..., 0] *= 0.5
    return freqt(c, order, alpha)


def mc2sp(mc: np.ndarray, alpha: float, fftlen: int) -> np.ndarray:
    """Mel-cepstrum -> power spectrum (..., fftlen//2+1)."""
    c = freqt(mc, fftlen // 2, -alpha)
    c[..., 0] *= 2.0
    sym = np.zeros(mc.shape[:-1] + (fftlen,), np.float64)
    sym[..., : fftlen // 2 + 1] = c
    sym[..., fftlen // 2 + 1:] = c[..., 1:fftlen // 2][..., ::-1]
    spec = np.fft.rfft(sym, axis=-1).real
    return np.exp(spec)
