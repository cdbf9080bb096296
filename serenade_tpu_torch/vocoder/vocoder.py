"""Vocoder wrapper: stats denorm/renorm around the HiFiGAN generator
(counterpart of serenade_tpu/vocoder/vocoder.py ``Vocoder``).

Mels from the conversion model are denormalized by the model's target
statistics and renormalized by the vocoder's own training statistics
before synthesis.  Statistics and parameters come in as arrays
(``Vocoder``), or as the files a recipe names (``Vocoder.from_files``:
the upstream torch pickle, its YAML config and ``stats.h5``).  The
generator is the HiFiGAN of the config's ``generator_params``, or the
checkpoint-free Griffin-Lim inversion where ``generator_type`` is
``GriffinLim`` (``vocoder/griffin_lim.py``).  The checkpoint is the
upstream torch pickle or a ``checkpoint-<N>steps`` directory of the
port's vocoder trainer (``bin/vocoder_train.py``); an Orbax directory of
the JAX package's trainer is refused by name (``checkpoint.py``), and its
parameters cross through the param bridge.
"""

from __future__ import annotations

import logging
import os
from typing import Mapping, Optional

import numpy as np
import torch

from serenade_tpu_torch import resolve_device, upload
from serenade_tpu_torch.convert import load_params
from serenade_tpu_torch.models.layers import init_params_
from serenade_tpu_torch.vocoder.griffin_lim import GriffinLimSynth
from serenade_tpu_torch.vocoder.hifigan import HiFiGANGenerator

_CHECKPOINT_FREE_GENERATORS = ("griffinlim", "griffin_lim")


def is_griffin_lim(config: Mapping) -> bool:
    return str(config.get("generator_type", "")).lower() in \
        _CHECKPOINT_FREE_GENERATORS


def generator_from_config(config: Mapping):
    """The generator a vocoder config describes: ``GriffinLimSynth`` for
    ``generator_type: GriffinLim`` (the keys JAX's ``load_vocoder``
    reads), else ``HiFiGANGenerator`` on K3 (``fused``)."""
    gp = dict(config.get("generator_params", {}))
    if is_griffin_lim(config):
        return GriffinLimSynth(
            sampling_rate=int(config.get("sampling_rate", 24000)),
            fft_size=int(gp.get("fft_size", 512)),
            hop_size=int(gp.get("hop_size", 240)),
            win_length=int(gp.get("win_length", 480)),
            num_mels=int(gp.get("num_mels", gp.get("in_channels", 80))),
            fmin=float(gp.get("fmin", 63.0)),
            fmax=float(gp.get("fmax", 12000.0)),
            n_iter=int(gp.get("n_iter", 32)),
            log_base=float(gp.get("log_base", 10.0)))
    if "upsample_kernal_sizes" in gp:   # the reference config's typo
        gp["upsample_kernel_sizes"] = gp.pop("upsample_kernal_sizes")
    return HiFiGANGenerator(
        in_channels=gp.get("in_channels", 80),
        out_channels=gp.get("out_channels", 1),
        channels=gp.get("channels", 512),
        kernel_size=gp.get("kernel_size", 7),
        upsample_scales=tuple(gp.get("upsample_scales", (8, 8, 2, 2))),
        upsample_kernel_sizes=tuple(
            gp.get("upsample_kernel_sizes", (16, 16, 4, 4))),
        resblock_kernel_sizes=tuple(
            gp.get("resblock_kernel_sizes", (3, 7, 11))),
        resblock_dilations=tuple(
            tuple(d) for d in gp.get("resblock_dilations", ((1, 3, 5),) * 3)),
        use_additional_convs=gp.get("use_additional_convs", True))


logger = logging.getLogger(__name__)


def generator_layout(config: Mapping) -> dict:
    """The layout arguments of ``vocoder.convert`` for a vocoder config."""
    gp = dict(config.get("generator_params", {}))
    return {"num_upsamples": len(gp.get("upsample_scales", (8, 8, 2, 2))),
            "num_blocks": len(gp.get("resblock_kernel_sizes", (3, 7, 11))),
            "resblock_dilations": tuple(tuple(d) for d in gp.get(
                "resblock_dilations", ((1, 3, 5),) * 3)),
            "use_additional_convs": gp.get("use_additional_convs", True)}


def vocoder_available(voc_cfg: Optional[Mapping]) -> bool:
    """Whether a ``vocoder:`` config section can synthesize: its
    checkpoint exists, or its config names a checkpoint-free generator."""
    from serenade_tpu_torch.config import load_config

    voc_cfg = voc_cfg or {}
    ckpt = voc_cfg.get("checkpoint")
    if ckpt and os.path.exists(str(ckpt)):
        return True
    cfg_path = voc_cfg.get("config")
    if cfg_path and os.path.exists(str(cfg_path)):
        return is_griffin_lim(load_config(cfg_path) or {})
    return False


def load_vocoder(checkpoint: str, config: Mapping) -> dict:
    """The generator's state dict: none for Griffin-Lim; the generator of
    a ``checkpoint-<N>steps`` directory of ``bin/vocoder_train.py``
    (``checkpoint.restore_generator_params``, which refuses an Orbax
    directory by name); or the upstream torch pickle at ``checkpoint``,
    converted for the layout ``config`` describes."""
    from serenade_tpu_torch.vocoder.convert import (
        convert_hifigan_generator, load_torch_vocoder_checkpoint,
    )

    if is_griffin_lim(config):
        return {}
    if os.path.isdir(checkpoint):
        from serenade_tpu_torch.checkpoint import restore_generator_params

        return restore_generator_params(checkpoint)
    return convert_hifigan_generator(
        load_torch_vocoder_checkpoint(checkpoint), **generator_layout(config))


def read_vocoder_stats(path: str) -> dict:
    """The ``{"mean", "scale"}`` a vocoder was trained with, from an
    ``.npz`` or from a ``stats.h5`` (``h5py``)."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return {"mean": z["mean"], "scale": z["scale"]}
    from serenade_tpu_torch.utils.h5 import read_hdf5

    return {"mean": read_hdf5(path, "mean"), "scale": read_hdf5(path, "scale")}


def _stats(stats, what: str):
    if stats is None or stats.get("mean") is None or stats.get("scale") is None:
        raise FileNotFoundError(f"{what} missing or incomplete")
    return (np.asarray(stats["mean"], np.float32),
            np.asarray(stats["scale"], np.float32))


class Vocoder:
    """HiFiGAN or Griffin-Lim synthesis with the SSC model's normalization
    contract.

    Args:
        config: vocoder config dict (``generator_params``, ``sampling_rate``,
            ``generator_type``).
        params: flax tree or state dict of the generator; None draws
            seeded random weights (``seed``); Griffin-Lim has none.
        stats: ``{"mean", "scale"}`` arrays the vocoder was trained with.
        trg_stats: the SSC model's logmel ``{"mean", "scale"}``, required
            when ``take_norm_feat``.
    """

    def __init__(self, config: Mapping, params, stats: Optional[Mapping],
                 trg_stats: Optional[Mapping] = None,
                 take_norm_feat: bool = True, device=None, seed: int = 0):
        if take_norm_feat and trg_stats is None:
            raise ValueError("trg_stats required when take_norm_feat=True")
        self.device = resolve_device(device)
        self.take_norm_feat = take_norm_feat
        mean, scale = _stats(stats, "vocoder stats")
        self.stats = {"mean": torch.from_numpy(mean).to(self.device),
                      "scale": torch.from_numpy(scale).to(self.device)}
        if take_norm_feat:
            tmean, tscale = _stats(trg_stats, "target stats")
            self.trg_stats = {"mean": torch.from_numpy(tmean).to(self.device),
                              "scale": torch.from_numpy(tscale).to(self.device)}
        self.config = dict(config)
        self.sampling_rate = int(self.config.get("sampling_rate", 24000))
        model = generator_from_config(self.config)
        if params is None:
            init_params_(model, seed)
        else:
            load_params(model, params)
        self.model = model.to(self.device).eval()
        self.mesh = None

    def place_on_mesh(self, mesh) -> None:
        """Run :meth:`decode_batch_device` data-parallel over ``mesh``'s
        devices (``parallel.make_mesh(devices=...)``): each replica
        vocodes its own rows, with no collective.  The server calls this
        once when its Converter runs with ``data_mesh``."""
        from serenade_tpu_torch.parallel.mesh import replicate

        self.mesh = mesh
        self._replicas = replicate(self.model, mesh)

    @classmethod
    def from_files(cls, checkpoint: str, config: str, stats: str,
                   trg_stats: Optional[Mapping] = None,
                   device=None) -> "Vocoder":
        """The vocoder a recipe names: the upstream torch pickle or a
        trained checkpoint directory (none for Griffin-Lim), its YAML
        config and the ``stats.h5`` (``mean``, ``scale``) it was trained
        with (serenade_tpu/vocoder/vocoder.py ``Vocoder``), or an ``.npz``
        of them (:func:`read_vocoder_stats`)."""
        from serenade_tpu_torch.config import load_config

        cfg = load_config(config)
        return cls(cfg, load_vocoder(checkpoint, cfg),
                   read_vocoder_stats(stats), trg_stats=trg_stats,
                   device=device)

    def _normalize(self, c: torch.Tensor) -> torch.Tensor:
        c = c.float()
        if self.take_norm_feat:
            c = c * self.trg_stats["scale"] + self.trg_stats["mean"]
        return (c - self.stats["mean"]) / self.stats["scale"]

    @torch.no_grad()
    def synthesize(self, c: torch.Tensor) -> torch.Tensor:
        """``(B, T, mels)`` normalized mels on the device -> ``(B, T*hop)``
        f32 waveforms on the device."""
        return self.model(self._normalize(c.to(self.device)))[..., 0].float()

    def decode(self, c: np.ndarray):
        """One ``(T, mels)`` mel -> ``(T * hop,)`` f32 waveform, rate."""
        y = self.synthesize(upload(c, self.device, np.float32)[None])[0]
        return y.cpu().numpy(), self.sampling_rate

    def decode_batch(self, c: np.ndarray) -> np.ndarray:
        """``(B, T, mels)`` -> ``(B, T * hop)`` f32 waveforms."""
        return self.synthesize(upload(c, self.device, np.float32)).cpu().numpy()

    @torch.no_grad()
    def decode_batch_device(self, c: torch.Tensor, lengths) -> torch.Tensor:
        """The serving tail: ``(B, T, mels)`` mels still on the device and
        each row's true frame count -> an int16 ``(B, T * hop)`` tensor on
        the device.  Each row is edge-padded past its length (its last real
        frame repeated: zeros in normalized mel space are average energy,
        audible through the convolutions' reach, and would make a row's
        waveform depend on its neighbours' lengths), denormalized, run
        through the generator and rounded as PCM16 (``torch.round`` rounds
        half to even, as ``jnp.round`` does)."""
        b, t, mels = c.shape
        lens = upload(np.asarray(lengths, np.int64), self.device)
        idx = torch.minimum(torch.arange(t, device=self.device)[None, :],
                            (lens - 1)[:, None])
        c = self._normalize(torch.gather(c, 1, idx[:, :, None].expand(
            b, t, mels)))
        if self.mesh is None:
            y = self.model(c)
        else:
            # after place_on_mesh: each replica vocodes its rows
            from serenade_tpu_torch.parallel.mesh import (
                run_replicas, split_rows,
            )

            parts = split_rows(c, self.mesh.size)
            devices = self.mesh.devices.reshape(-1)
            y = torch.cat([p.to(self.device) for p in run_replicas(
                self.mesh, lambda i, part: self._replicas[i](
                    part.to(devices[i])), parts)])
        y = y[..., 0].float()
        return torch.round(torch.clamp(y, -1.0, 1.0) * 32767.0).to(
            torch.int16)


def vocoder_from_section(voc_cfg: Optional[Mapping], trg_stats: Mapping,
                         device=None) -> Optional[Vocoder]:
    """The vocoder of an experiment config's ``vocoder:`` section
    (``checkpoint``, ``config``, ``stats``), or None where it cannot
    synthesize; a configured checkpoint that does not exist is logged, as
    mel-only output would otherwise go unnoticed downstream."""
    voc_cfg = voc_cfg or {}
    if not vocoder_available(voc_cfg):
        if voc_cfg.get("checkpoint"):
            logger.warning("configured vocoder checkpoint %s does not exist; "
                           "conversions will return mel only",
                           voc_cfg["checkpoint"])
        return None
    return Vocoder.from_files(voc_cfg.get("checkpoint") or "",
                              voc_cfg["config"], voc_cfg["stats"],
                              trg_stats=trg_stats, device=device)
