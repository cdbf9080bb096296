"""GAN losses of vocoder training (counterpart of
serenade_tpu/vocoder/losses.py): LSGAN adversarial terms, feature
matching, the multi-resolution log-mel L1 and SiFiGAN's source
regularization.

Discriminator outputs are lists of ``(score, fmaps)`` pairs.  Every term
is a mean over elements, so the layout of the scores and the feature maps
does not enter.  Waveforms are ``(B, T)`` (``(B, T, 1)`` for
``residual_loss``); the STFTs are the port's DFT-basis products
(``ops/stft.py``), CheapTrick is the port's (``ops/world.py``, its sums
in f64).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from serenade_tpu_torch.ops.mel import _on_device, mel_filterbank
from serenade_tpu_torch.ops.stft import stft_magnitude
from serenade_tpu_torch.ops.world import cheaptrick

MEL_RESOLUTIONS = ((512, 120, 480), (1024, 240, 960), (2048, 480, 1920))


def generator_adversarial_loss(disc_outputs: Sequence) -> torch.Tensor:
    """mean((1 - D(G(z)))^2), averaged over the discriminators."""
    losses = [torch.mean(torch.square(1.0 - s)) for s, _ in disc_outputs]
    return sum(losses) / len(losses)


def discriminator_adversarial_loss(real_outputs: Sequence,
                                   fake_outputs: Sequence) -> torch.Tensor:
    """Real to 1 and fake to 0, averaged over the discriminators."""
    losses = [torch.mean(torch.square(1.0 - real))
              + torch.mean(torch.square(fake))
              for (real, _), (fake, _) in zip(real_outputs, fake_outputs)]
    return sum(losses) / len(losses)


def feature_matching_loss(fake_outputs: Sequence,
                          real_outputs: Sequence) -> torch.Tensor:
    """L1 between the fake and real feature maps, averaged over all."""
    terms = [torch.mean(torch.abs(ff - fr))
             for (_, fmaps_fake), (_, fmaps_real) in zip(fake_outputs,
                                                         real_outputs)
             for ff, fr in zip(fmaps_fake, fmaps_real)]
    return sum(terms) / max(len(terms), 1)


def _basis(sr: int, fft_size: int, n_mels: int, fmin: float, fmax: float,
           device) -> torch.Tensor:
    return _on_device(mel_filterbank, (sr, fft_size, n_mels, float(fmin),
                                       float(fmax)), device)


def multi_resolution_mel_loss(
        wav_hat, wav, sampling_rate: int = 24000,
        resolutions: Tuple[Tuple[int, int, int], ...] = MEL_RESOLUTIONS,
        num_mels: int = 80, fmin: float = 0.0,
        fmax: Optional[float] = None) -> torch.Tensor:
    """L1 log-mel distance at several STFT resolutions, over ``(T,)`` or
    ``(B, T)`` waveforms: each resolution's mean over the batch, averaged
    (JAX's per-item means of equal-length items, summed and divided)."""
    fmax = fmax or sampling_rate / 2.0
    if wav_hat.dim() == 1:
        wav_hat, wav = wav_hat[None], wav[None]
    total = 0.0
    for fft_size, hop, win in resolutions:
        basis = _basis(sampling_rate, fft_size, num_mels, fmin, fmax,
                       wav.device).to(wav.dtype)

        def logmel(w):
            mag = stft_magnitude(w, fft_size, hop, win, dtype=w.dtype)
            return torch.log(torch.clamp_min(mag @ basis, 1e-5))

        total = total + torch.mean(torch.abs(logmel(wav_hat) - logmel(wav)))
    return total / len(resolutions)


def residual_loss(source_hat, wav, cf0, *, sampling_rate: int = 24000,
                  fft_size: int = 2048, hop_size: int = 120,
                  n_mels: int = 80, fmin: float = 0.0,
                  fmax: Optional[float] = None, f0_floor: float = 100.0,
                  f0_ceil: float = 840.0) -> torch.Tensor:
    """SiFiGAN's source regularization (the ``lambda_reg`` term): the MSE
    between the log-mels of the excitation's STFT magnitude and of the
    natural waveform's magnitude divided by its CheapTrick envelope
    (0th cepstrum eliminated, F0 clipped to [f0_floor, f0_ceil]).

    Args:
        source_hat: ``(B, T, 1)`` source-network excitation.
        wav: ``(B, T, 1)`` natural waveform.
        cf0: ``(B, n_frames)`` continuous F0 in Hz at ``hop_size`` frames.
    """
    fmax = fmax or sampling_rate / 2.0
    basis = _basis(sampling_rate, fft_size, n_mels, fmin, fmax,
                   wav.device).to(wav.dtype)
    n = cf0.shape[1]
    y, s = wav[..., 0], source_hat[..., 0]
    with torch.no_grad():
        f0 = torch.clamp(cf0.to(wav.dtype), f0_floor, f0_ceil)
        env = cheaptrick(y, f0, fs=sampling_rate, f0_floor=f0_floor,
                         frame_period_ms=1000.0 * hop_size / sampling_rate,
                         elim_0th=True, fft_size=fft_size, dtype=y.dtype)
        mag_y = stft_magnitude(y, fft_size, hop_size, dtype=y.dtype)[:, :n]
        target = mag_y * torch.rsqrt(torch.clamp_min(env, 1e-12))
        lm_t = torch.log(torch.clamp_min(target @ basis, 1e-5))
    mag_s = stft_magnitude(s, fft_size, hop_size, dtype=s.dtype)[:, :n]
    lm_s = torch.log(torch.clamp_min(mag_s @ basis, 1e-5))
    return torch.mean(torch.square(lm_s - lm_t))
