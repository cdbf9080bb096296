"""ContentVec content features for extraction (counterpart of
``make_content_fn`` in serenade_tpu/bin/preprocess.py).

The preprocessing CLI (wav.scp -> h5 dumps) is not ported: it writes h5,
which the card's machine cannot, and waits for the decode slice.  This
module holds the content function that feature extraction and the
raw-audio serving path call.
"""

from __future__ import annotations

import numpy as np
import torch

from serenade_tpu_torch import resolve_device, upload
from serenade_tpu_torch.collaters.ssc import next_pow2
from serenade_tpu_torch.configs import CONTENTVEC_CONFIG
from serenade_tpu_torch.modules.contentvec import (
    ContentVecEncoder, load_contentvec_params,
)
from serenade_tpu_torch.ops.resample import resample_device

BUCKET_16K = 32000   # 2 s at 16 kHz: one batch shape per bucket
BUCKET_24K = 48000   # the same 2 s at 24 kHz, which the 2/3 resample maps
                     # onto BUCKET_16K exactly


def _frames(n16: int) -> int:
    """ContentVec frames of ``n16`` 16 kHz samples (the conv stack's
    receptive field), at least 1."""
    return max((n16 - 400) // 160 + 1, 1)


def make_content_fn(ckpt=None, batch_size: int = 8, *, config=None,
                    device=None, seed: int = 0):
    """A content function over ContentVec at ``config`` (default: the
    full width, ``configs.CONTENTVEC_CONFIG``) on ``device`` (CUDA unless
    named), with weights from ``ckpt``: a ``.pt`` Hugging Face
    ``HubertModel`` state dict (path or dict), a flax tree of the JAX
    encoder, or None for seeded weights (``seed``; the JAX function
    returns None there, having no weights to draw).

    ``content_fn(audio16k)`` -> ``(frames, dim)`` numpy; its ``batch``
    (16 kHz waveforms) and ``batch24`` (24 kHz, resampled on the device)
    return tensors on the device, row slices of one batched forward per
    group of waveforms in one 2 s bucket, the group padded to a power of
    two by repeating its last waveform, as the JAX function groups them.
    """
    device = resolve_device(device)
    model = ContentVecEncoder(**dict(config or CONTENTVEC_CONFIG))
    model = load_contentvec_params(model, ckpt, seed).to(device).eval()

    def infer(wav: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(wav)

    def _bucket(audio16k):
        n = len(audio16k)
        padded = -(-n // BUCKET_16K) * BUCKET_16K
        wav = np.pad(np.asarray(audio16k, np.float32), (0, padded - n))
        return wav, _frames(n)

    def content_fn(audio16k):
        wav, n_frames = _bucket(audio16k)
        out = infer(upload(wav[None], device))
        return out[0, :n_frames].cpu().numpy()

    def _run_grouped(prepped, run_infer):
        """One forward per bucket and per chunk of ``batch_size``, the
        chunk padded to a power of two; each row sliced to its frames."""
        groups = {}
        for i, rec in enumerate(prepped):
            groups.setdefault(rec[0].shape[0], []).append(i)
        results = [None] * len(prepped)
        for idxs in groups.values():
            for lo in range(0, len(idxs), batch_size):
                chunk = idxs[lo:lo + batch_size]
                run = chunk + [chunk[-1]] * (next_pow2(len(chunk))
                                             - len(chunk))
                out = run_infer(run)
                for j, i in enumerate(chunk):
                    results[i] = out[j, :prepped[i][1]]
        return results

    def batch(audios16k):
        """Tensors on the device, one a waveform (the conversion pack
        takes them there: the 768-d features never come to the host)."""
        prepped = [_bucket(a) for a in audios16k]
        return _run_grouped(prepped, lambda run: infer(upload(
            np.stack([prepped[i][0] for i in run]), device)))

    def _bucket24(audio24k, wire_dtype):
        n = len(audio24k)
        padded = -(-n // BUCKET_24K) * BUCKET_24K
        wav = np.pad(np.asarray(audio24k, np.float32), (0, padded - n))
        if wire_dtype == "int16":
            wav = np.clip(np.round(wav * 32768.0),
                          -32768, 32767).astype(np.int16)
        n16 = (n * 2 + 2) // 3   # len(resample_poly(x, 2, 3))
        return wav, _frames(n16), n16

    def _infer24(w24: torch.Tensor, n16: torch.Tensor) -> torch.Tensor:
        # zero past each row's 16 kHz length: host resampling pads with
        # exact zeros, where resampling the padded signal leaves the
        # filter's ring-out, and the transformer attends to the tail
        y16 = resample_device(w24, 2, 3)
        keep = torch.arange(y16.shape[-1], device=y16.device) < n16[:, None]
        return infer(torch.where(keep, y16, 0.0))

    def batch24(audios24k, wire_dtype: str = "float32"):
        """``batch`` from 24 kHz waveforms: one upload (int16 on the
        ``"int16"`` wire, dequantized on the device), the 2/3 resample on
        the device, then ContentVec."""
        prepped = [_bucket24(a, wire_dtype) for a in audios24k]
        return _run_grouped(prepped, lambda run: _infer24(
            upload(np.stack([prepped[i][0] for i in run]), device),
            upload(np.asarray([prepped[i][2] for i in run], np.int64),
                   device)))

    content_fn.batch = batch
    content_fn.batch24 = batch24
    return content_fn
