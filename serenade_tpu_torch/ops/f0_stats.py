"""F0 statistics and key-shift transposition (copied from
serenade_tpu/ops/f0_stats.py).

Log-F0 mean/std estimation and conversion (`F0Statistics`), C4-based
Hz<->cent conversion, and the asymmetric `linear_midi_shift` the decode
writes beside each conversion: the source melody transposed toward the
reference register (up-shifts scaled by 1.4, down-shifts by 5/7, rounded
to whole semitones).
"""

from __future__ import annotations

import numpy as np

C4_HZ = 440.0 * (2.0 ** (3 / 12)) / 2.0  # 261.63 Hz
C4_CENT = 4800.0


class F0Statistics:
    def estimate(self, f0list):
        """List of F0 tracks -> [mean, std] of pooled voiced log-F0."""
        pooled = np.concatenate(
            [np.log(f0[np.nonzero(f0)]) for f0 in f0list]
        )
        return np.array([np.mean(pooled), np.std(pooled)])

    def convert(self, f0, org_stats, tar_stats):
        """Gaussian-normalized log-F0 conversion; zeros stay zero."""
        f0 = np.asarray(f0)
        out = np.zeros(len(f0))
        voiced = f0 > 0
        out[voiced] = np.exp(
            (tar_stats[1] / org_stats[1]) * (np.log(f0[voiced]) - org_stats[0])
            + tar_stats[0]
        )
        return out


def hz_to_cent_c4(hz):
    out = np.array(hz, dtype=np.float64, copy=True)
    voiced = out > 0
    out[voiced] = 1200.0 * np.log2(out[voiced] / C4_HZ) + C4_CENT
    return out


def cent_to_hz_c4(cent):
    out = np.array(cent, dtype=np.float64, copy=True)
    voiced = out > 0
    out[voiced] = np.exp2((out[voiced] - C4_CENT) / 1200.0) * C4_HZ
    return out


def linear_midi_shift(src_f0, ref_f0):
    """Shift the source F0 toward the reference register (whole semitones,
    up-shifts scaled 1.4×, down-shifts 5/7×) — reference
    ssc_decode.py:133-154.  Returns a new array (the reference mutates its
    input in place; we don't)."""
    src_f0 = np.array(src_f0, dtype=np.float64, copy=True)
    stats = F0Statistics()
    src_mean = stats.estimate([src_f0])[0]
    ref_mean = stats.estimate([ref_f0])[0]

    src_cent = 1200.0 * np.log2(np.exp(src_mean) / C4_HZ) + C4_CENT
    ref_cent = 1200.0 * np.log2(np.exp(ref_mean) / C4_HZ) + C4_CENT
    delta = ref_cent - src_cent
    scale = 1.4 if delta >= 0 else 5.0 / 7.0
    shift = round(delta * scale / 100.0) * 100.0

    voiced = src_f0 > 0
    cents = hz_to_cent_c4(src_f0[voiced])
    cents = np.maximum(0.0, cents + shift)
    src_f0[voiced] = cent_to_hz_c4(cents)
    return src_f0
