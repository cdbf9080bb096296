"""Vocoder GAN training (counterpart of
serenade_tpu/trainers/vocoder_trainer.py): one step updates the
discriminator (LSGAN real and fake), then the generator (adversarial,
feature matching and multi-resolution mel terms, plus SiFiGAN's source
regularization where ``reg_loss_fn`` is given), each by its own
optimizer.

The order is JAX's: the discriminator's loss on the generator's output
computed without a gradient, its update, then the generator's loss
against the *updated* discriminator.  Gradients are taken by
``torch.autograd.grad`` with respect to the network being updated only,
so neither step leaves gradients in the other's parameters.  The
optimizers are the port's optax chains (``trainers.train_step.
Optimizer``), which update the modules' parameters in place.

The generators train with ``resblock_backend="conv"``: the residual
blocks as a differentiable conv chain, as JAX trains through its
``conv`` lowering (K3, the inference kernel, has no backward).  The
segment samplers and the SiFiGAN analysis are host numpy with the
caller's ``numpy.random.Generator``, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from serenade_tpu_torch.trainers.train_step import Optimizer
from serenade_tpu_torch.vocoder.losses import (
    discriminator_adversarial_loss, feature_matching_loss,
    generator_adversarial_loss, multi_resolution_mel_loss,
)


@dataclasses.dataclass
class VocoderTrainState:
    gen_params: Dict[str, nn.Parameter]    # the generator's own
    gen_opt: Dict[str, Any]
    disc_params: Dict[str, nn.Parameter]   # the discriminator's own
    disc_opt: Dict[str, Any]
    step: int = 0


def adamw_chain(lr: float) -> Optimizer:
    """``optax.chain(clip_by_global_norm(10), adamw(lr, b1=0.8,
    b2=0.99))``, optax's defaults otherwise (eps 1e-8, weight decay
    1e-4): the optimizer of each network in JAX's vocoder CLI."""
    return Optimizer("AdamW", lambda _: lr, grad_norm=10.0, b1=0.8, b2=0.99,
                     weight_decay=1e-4)


def create_vocoder_state(generator: nn.Module, discriminator: nn.Module,
                         gen_opt: Optimizer, disc_opt: Optimizer
                         ) -> VocoderTrainState:
    gen = dict(generator.named_parameters())
    disc = dict(discriminator.named_parameters())
    return VocoderTrainState(gen, gen_opt.init(gen), disc,
                             disc_opt.init(disc))


def _grads(loss, params: Mapping[str, torch.Tensor]):
    """d loss / d params by name; a parameter the loss does not reach
    gets zeros, as JAX's gradient of it is zero."""
    names = list(params)
    gs = torch.autograd.grad(loss, [params[n] for n in names],
                             allow_unused=True)
    return {n: torch.zeros_like(params[n]) if g is None else g
            for n, g in zip(names, gs)}


def build_vocoder_train_step(generator: nn.Module, discriminator: nn.Module,
                             gen_opt: Optimizer, disc_opt: Optimizer, *,
                             sampling_rate: int = 24000,
                             lambda_adv: float = 1.0, lambda_fm: float = 2.0,
                             lambda_mel: float = 45.0,
                             lambda_reg: float = 0.0,
                             gen_forward: Optional[Callable] = None,
                             reg_loss_fn: Optional[Callable] = None
                             ) -> Callable:
    """``(state, batch) -> (state, metrics)``, the metrics as tensors on
    the device (read them when they are logged).

    ``batch``: ``{"mel": (B, T, n_mels), "wav": (B, T * hop, 1)}`` tensors
    for the default (HiFiGAN) forward; ``gen_forward(batch)`` (e.g.
    :func:`sifigan_forward`) for other conditioning.  ``reg_loss_fn(aux,
    batch)`` adds a ``lambda_reg``-weighted term; ``gen_forward`` then
    returns ``(waveform, aux)``.
    """
    if gen_forward is None:
        def gen_forward(batch):
            return generator(batch["mel"])

    def run_gen(batch):
        out = gen_forward(batch)
        return out if isinstance(out, tuple) else (out, None)

    def step_fn(state: VocoderTrainState, batch: Mapping[str, Any]):
        wav = batch["wav"]
        with torch.no_grad():
            wav_hat, _ = run_gen(batch)
        d_loss = discriminator_adversarial_loss(discriminator(wav),
                                                discriminator(wav_hat))
        disc_opt.update(state.disc_params,
                        _grads(d_loss, state.disc_params), state.disc_opt)

        wav_hat, aux = run_gen(batch)
        outs_fake = discriminator(wav_hat)
        with torch.no_grad():
            outs_real = discriminator(wav)
        adv = generator_adversarial_loss(outs_fake)
        fm = feature_matching_loss(outs_fake, outs_real)
        mel = multi_resolution_mel_loss(wav_hat[..., 0], wav[..., 0],
                                        sampling_rate=sampling_rate)
        loss = lambda_adv * adv + lambda_fm * fm + lambda_mel * mel
        metrics = {"train/adv_loss": adv, "train/fm_loss": fm,
                   "train/mel_loss": mel}
        if reg_loss_fn is not None:
            if aux is None:
                raise ValueError("reg_loss_fn requires a gen_forward that "
                                 "returns (waveform, aux)")
            reg = reg_loss_fn(aux, batch)
            loss = loss + lambda_reg * reg
            metrics["train/reg_loss"] = reg
        gen_opt.update(state.gen_params, _grads(loss, state.gen_params),
                       state.gen_opt)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["train/disc_loss"] = d_loss.detach()
        metrics["train/gen_loss"] = loss.detach()
        state.step += 1
        return state, metrics

    return step_fn


def sample_mel_wav_segments(dataset_items, rng: np.random.Generator,
                            batch_size: int, segment_frames: int,
                            hop_size: int):
    """Random aligned (mel, wav) crops of feature-dump items (``logmel``
    and ``wave``), zero-padded at the end of a short item."""
    mels, wavs = [], []
    for _ in range(batch_size):
        item = dataset_items[rng.integers(len(dataset_items))]
        mel = np.asarray(item["logmel"])
        wav = np.asarray(item["wave"]).reshape(-1)
        # the window starting at exactly L - S is a valid crop
        s = int(rng.integers(max(mel.shape[0] - segment_frames + 1, 1)))
        mel_seg = mel[s:s + segment_frames]
        wav_seg = wav[s * hop_size:(s + segment_frames) * hop_size]
        if mel_seg.shape[0] < segment_frames:
            mel_seg = np.pad(mel_seg, ((0, segment_frames - mel_seg.shape[0]),
                                       (0, 0)))
        need = segment_frames * hop_size
        if wav_seg.shape[0] < need:
            wav_seg = np.pad(wav_seg, (0, need - wav_seg.shape[0]))
        mels.append(mel_seg)
        wavs.append(wav_seg[:, None])
    return {"mel": np.stack(mels).astype(np.float32),
            "wav": np.stack(wavs).astype(np.float32)}


def sifigan_forward(generator: nn.Module, with_excitation: bool = False):
    """``gen_forward`` of a SiFiGAN generator: the batch carries the sine
    excitation, the aux features and each level's dense dilation factors
    (stage 9's conditioning).  ``with_excitation`` returns ``(waveform,
    source excitation)`` for the residual loss."""

    def fwd(batch):
        wav_hat, excitation = generator(batch["sine"], batch["c"],
                                        list(batch["dfs"]))
        return (wav_hat, excitation) if with_excitation else wav_hat

    return fwd


def prepare_sifigan_utterance(wav, fs: int, *, frame_period_ms: float = 5.0,
                              mcep_dim: int = 39,
                              dense_factors=(0.5, 1, 4, 8),
                              upsample_scales=(5, 4, 3, 2),
                              f0_floor: float = 70.0, f0_ceil: float = 800.0,
                              signal_types=("sine",), device=None):
    """One training utterance analysed into SiFiGAN's streams, as stage 9
    conditions synthesis: YIN F0 (median-smoothed) and its continuous
    track, mel-cepstrum and band aperiodicity, the sine excitation and
    the dense factors.  Returns ``{"c": (T, D), "sine": (T*hop, S), "dfs":
    [(T*cum_i,)...], "wav": (T*hop,), "cf0": (T,)}``, or None without a
    voiced frame.  YIN and the analysis run on ``device`` (the card unless
    named)."""
    from serenade_tpu_torch import resolve_device
    from serenade_tpu_torch.bin.ssc_postprocessing import (
        convert_continuous_f0,
    )
    from serenade_tpu_torch.ops.f0 import smooth_f0_median, yin_f0
    from serenade_tpu_torch.sifigan.features import (
        SignalGenerator, dense_factors_per_level, world_mcep_bap,
    )

    dev = resolve_device(device)
    wav = np.asarray(wav, np.float32).reshape(-1)
    hop = int(fs * frame_period_ms / 1000.0)
    f0, _ = yin_f0(torch.from_numpy(wav).to(dev), fs=fs, f0_floor=f0_floor,
                   f0_ceil=f0_ceil, frame_period_ms=frame_period_ms)
    f0 = smooth_f0_median(f0).cpu().numpy()
    _, cf0, ok = convert_continuous_f0(f0)
    if not ok:
        return None
    mcep, bap, _ = world_mcep_bap(wav, f0, fs, frame_period_ms, mcep_dim,
                                  device=dev)
    c = np.concatenate([mcep, bap], axis=1).astype(np.float32)
    n = min(c.shape[0], len(wav) // hop)
    c, cf0 = c[:n], cf0[:n]
    sine = SignalGenerator(fs, hop, signal_types=signal_types)(cf0)
    dfs = dense_factors_per_level(cf0, fs, dense_factors, upsample_scales)
    return {"c": c, "sine": sine[:n * hop],
            "dfs": [d[:n * int(cum)] for d, cum in
                    zip(dfs, np.cumprod(upsample_scales))],
            "wav": wav[:n * hop],
            # the residual loss follows the envelope along it
            "cf0": np.asarray(cf0, np.float32)}


def sample_sifigan_segments(items, rng: np.random.Generator,
                            batch_size: int, segment_frames: int,
                            hop_size: int, upsample_scales=(5, 4, 3, 2)):
    """Random aligned (c, sine, dfs, wav, cf0) crops of prepared
    utterances (:func:`prepare_sifigan_utterance`)."""
    cum = np.cumprod(upsample_scales)
    cs, sines, wavs, cf0s = [], [], [], []
    dfs_lv = [[] for _ in cum]
    for _ in range(batch_size):
        it = items[rng.integers(len(items))]
        s = int(rng.integers(max(it["c"].shape[0] - segment_frames + 1, 1)))
        e = s + segment_frames
        cs.append(it["c"][s:e])
        sines.append(it["sine"][s * hop_size:e * hop_size])
        wavs.append(it["wav"][s * hop_size:e * hop_size, None])
        cf0s.append(it["cf0"][s:e])
        for i, cm in enumerate(cum):
            dfs_lv[i].append(it["dfs"][i][s * int(cm):e * int(cm)])
    return {"c": np.stack(cs).astype(np.float32),
            "sine": np.stack(sines).astype(np.float32),
            "wav": np.stack(wavs).astype(np.float32),
            "cf0": np.stack(cf0s).astype(np.float32),
            "dfs": tuple(np.stack(d).astype(np.float32) for d in dfs_lv)}


def batch_to_device(batch: Mapping[str, Any], dev: torch.device) -> dict:
    """A sampled batch's arrays on ``dev`` (``dfs`` stays a tuple)."""
    from serenade_tpu_torch.trainers.train_step import to_device

    return {k: (tuple(to_device(x, dev) for x in v) if isinstance(v, tuple)
                else to_device(v, dev)) for k, v in batch.items()}
