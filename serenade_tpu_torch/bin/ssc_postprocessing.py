"""Recipe stage 9, SiFiGAN post-processing (counterpart of
serenade_tpu/bin/ssc_postprocessing.py).

Every converted wav is analysed again: F0 by Harvest with the voice
type's range (``--f0-backend yin`` takes YIN + Viterbi, ``harvest_native``
the C++ host library), the envelope by CheapTrick, the aperiodicity by
band aperiodicity or D4C (``--ap-backend``), the envelope coded as a
mel-cepstrum; then the SiFiGAN generator resynthesises it from the
decode-written ``lf0`` (an h5 beside each wav) as ``*_sifigan.wav``.
``--anasyn [--f0-factors 0.5,1.0,2.0]`` conditions each wav on its own
analysed F0, scaled per factor, as ``*_anasyn[_fX.XX].wav``.

Two phases, as in JAX: analysis per utterance on the device, then
synthesis of same-bucket utterances together (``--synth-frame-bucket``
frames, edge-padded: continued F0 and the last aux frame repeated;
batches of up to ``--synth-batch-size`` padded to a power of two), each
output cut at its length.  ``postprocess_core`` holds the work after the
reads, on arrays; ``main`` reads the wavs, the lf0 h5s (h5py), the YAML
config (pyyaml) and the aux scalers (joblib), each imported where it is
read.

``--checkpoint-path`` is a released SiFiGAN ``.pkl`` or a
``checkpoint-<N>steps`` directory of the port's vocoder trainer
(``bin/vocoder_train.py --vocoder-type sifigan``), whose generator was
trained on raw mcep/bap (give no ``--stats`` unless it was trained with
that normalization).  Refused by name: an Orbax directory of the JAX
package (``checkpoint.py``; its parameters cross through the param
bridge).  A ``--checkpoint-path`` or ``--stats`` that does not exist is
an error, where the JAX CLI falls back to random weights or no scaler.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from serenade_tpu_torch import resolve_device
from serenade_tpu_torch.collaters.ssc import pad_pow2
from serenade_tpu_torch.features import _bucketed
from serenade_tpu_torch.models.layers import init_params_
from serenade_tpu_torch.ops.f0 import smooth_f0_median, yin_f0
from serenade_tpu_torch.ops.harvest import harvest_f0
from serenade_tpu_torch.ops.sptk import ALPHA, sp2mc
from serenade_tpu_torch.ops.world import aperiodicity_spectrum
from serenade_tpu_torch.sifigan.features import (
    ANALYSIS_BACKENDS, AP_BACKENDS, SignalGenerator, dense_factors_per_level,
    world_mcep_bap,
)
from serenade_tpu_torch.sifigan.generator import (
    SiFiGANDirectGenerator, SiFiGANGenerator,
)

logger = logging.getLogger(__name__)

# voice-type F0 ranges (reference ssc_postprocessing.py:121-137)
VOICE_RANGES = {
    "Soprano": (261, 1046),
    "Alto": (196, 700),
    "Tenor": (130, 440),
    "Bass": (82, 330),
}
DEFAULT_RANGE = (80, 1100)
F0_BACKENDS = ("harvest", "harvest_native", "yin")
# markers of files stage 9 does not take (on the file name only)
SKIPPED = ("_reference", "_gt", "_sifigan", "_anasyn")

DEFAULT_CONFIG = dict(
    sample_rate=24000,
    frame_period=5.0,
    mcep_dim=39,
    mcap_dim=19,
    aux_feats=["mcep", "bap"],
    dense_factors=[0.5, 1, 4, 8],
    df_f0_type="cf0",
    sine_amp=0.1,
    noise_amp=0.003,
    sine_f0_type="cf0",
    signal_types=["sine"],
    seed=100,
    generator=dict(
        in_channels=43,
        out_channels=1,
        channels=512,
        kernel_size=7,
        upsample_scales=[5, 4, 3, 2],
        upsample_kernel_sizes=[10, 8, 6, 4],
    ),
)


def convert_continuous_f0(f0: np.ndarray):
    """Linear interpolation through unvoiced gaps, edges extended
    (reference ssc_postprocessing.py:51-72).  Returns (uv, cont_f0, ok)."""
    f0 = np.asarray(f0, np.float64).reshape(-1)
    uv = (f0 != 0).astype(np.float32)
    if (f0 == 0).all():
        logger.warning("all F0 values are zero")
        return uv, f0, False
    nz = np.nonzero(f0)[0]
    cont = f0.copy()
    cont[:nz[0]] = f0[nz[0]]
    cont[nz[-1]:] = f0[nz[-1]]
    nz2 = np.nonzero(cont)[0]
    cont = np.interp(np.arange(len(cont)), nz2, cont[nz2])
    return uv, cont, True


def voice_range_for(path: str):
    for name, rng in VOICE_RANGES.items():
        if name in path:
            return rng
    logger.warning("unknown voice type for %s", path)
    return DEFAULT_RANGE


def build_generator(config: Dict):
    """The generator a config's ``generator`` section names (the hydra
    keys of the vendored sifigan_config; ``_target_`` ending in
    ``SiFiGANDirectGenerator`` selects the Direct variant), unloaded."""
    gen_cfg = dict(config["generator"])
    direct = str(gen_cfg.pop("_target_", "")).endswith(
        "SiFiGANDirectGenerator")
    sn_cfg = dict(gen_cfg.get("source_network_params", {}))
    fn_cfg = dict(gen_cfg.get("filter_network_params", {}))
    cls = SiFiGANDirectGenerator if direct else SiFiGANGenerator
    return cls(
        in_channels=gen_cfg.get("in_channels", 43),
        out_channels=gen_cfg.get("out_channels", 1),
        channels=gen_cfg.get("channels", 512),
        kernel_size=gen_cfg.get("kernel_size", 7),
        upsample_scales=tuple(gen_cfg.get("upsample_scales", (5, 4, 3, 2))),
        upsample_kernel_sizes=tuple(
            gen_cfg.get("upsample_kernel_sizes", (10, 8, 6, 4))),
        source_resblock_kernel_size=sn_cfg.get("resblock_kernel_size", 3),
        source_resblock_dilations=tuple(tuple(d) for d in sn_cfg.get(
            "resblock_dilations", ((1,), (1, 2), (1, 2, 4), (1, 2, 4, 8)))),
        source_use_additional_convs=sn_cfg.get("use_additional_convs", True),
        filter_resblock_kernel_sizes=tuple(
            fn_cfg.get("resblock_kernel_sizes", (3, 5, 7))),
        filter_resblock_dilations=tuple(tuple(d) for d in fn_cfg.get(
            "resblock_dilations", ((1, 3, 5),) * 3)),
        filter_use_additional_convs=fn_cfg.get("use_additional_convs",
                                               False),
        share_upsamples=gen_cfg.get("share_upsamples", False),
        share_downsamples=(False if direct
                           else gen_cfg.get("share_downsamples", False)))


def load_generator(config: Dict, checkpoint: Optional[str] = None,
                   device=None):
    """The generator on ``device`` (the card unless named), in eval mode,
    f32 as JAX's CLI runs it: from a released SiFiGAN ``.pkl``, from a
    checkpoint directory of ``bin/vocoder_train.py``, or random weights
    from seed 0 without a checkpoint.  An Orbax directory is refused by
    name (``checkpoint.restore_checkpoint``)."""
    dev = resolve_device(device)
    model = build_generator(config)
    if checkpoint is None:
        init_params_(model, 0)
        logger.warning("using RANDOM SiFiGAN weights (no checkpoint)")
    elif os.path.isdir(checkpoint):
        from serenade_tpu_torch.checkpoint import restore_generator_params

        model.load_state_dict(restore_generator_params(checkpoint),
                              strict=True)
        logger.info("loaded the trained SiFiGAN checkpoint %s", checkpoint)
    elif not os.path.exists(checkpoint):
        raise FileNotFoundError(f"no SiFiGAN checkpoint {checkpoint}")
    else:
        from serenade_tpu_torch.sifigan.convert import load_sifigan_checkpoint

        model.load_state_dict(load_sifigan_checkpoint(checkpoint, model),
                              strict=True)
    return model.to(dev).eval()


def _analysis_f0(x: np.ndarray, f0_range, f0_backend: str, sr: int,
                 fp: float, dev: torch.device) -> np.ndarray:
    """The re-analysis F0 of one waveform, median-smoothed: Harvest or
    YIN on the device over the 128-hop bucket, or Harvest on the host."""
    hop = int(sr * fp / 1000.0)
    f0_floor, f0_ceil = (float(v) for v in f0_range)
    x_b, n_frames = _bucketed(np.asarray(x, np.float32), hop)
    if f0_backend == "harvest_native":
        from serenade_tpu_torch.native import harvest_f0_native

        f0 = torch.from_numpy(harvest_f0_native(
            x, fs=sr, f0_floor=f0_floor, f0_ceil=f0_ceil,
            frame_period_ms=fp)[0])
    else:
        estimate = harvest_f0 if f0_backend == "harvest" else yin_f0
        f0 = estimate(torch.as_tensor(x_b, device=dev), fs=sr,
                      f0_floor=f0_floor, f0_ceil=f0_ceil,
                      frame_period_ms=fp)[0]
    return smooth_f0_median(f0).cpu().numpy()[:n_frames]


def analyze(utt: Dict, config: Dict, *, f0_backend: str, ap_backend: str,
            analysis_backend: str, anasyn: bool,
            f0_factors: Sequence[float], scaler=None, device=None
            ) -> List[Dict]:
    """Phase 1 for one utterance ``{"key", "wav", "lf0", "f0_range"}``:
    its synthesis inputs, one item per F0 factor (none where its F0 is
    unvoiced throughout)."""
    dev = resolve_device(device)
    sr = int(config["sample_rate"])
    fp = float(config["frame_period"])
    x = np.asarray(utt["wav"], np.float32)
    f0_cvt = _analysis_f0(x, utt["f0_range"], f0_backend, sr, fp, dev)
    n_frames = len(f0_cvt)
    if anasyn:
        lf0 = np.asarray(f0_cvt, np.float64)
    else:
        lf0 = np.asarray(utt["lf0"]).reshape(-1)
        if len(lf0) != n_frames:
            grid = np.linspace(0, len(lf0) - 1, n_frames)
            lf0 = np.maximum(np.interp(grid, np.arange(len(lf0)), lf0), 0.0)
    mcep, bap, sp = world_mcep_bap(
        x, lf0.astype(np.float32), sr, fp, int(config["mcep_dim"]),
        ap_backend=ap_backend, analysis_backend=analysis_backend,
        device=dev)
    uv, cf0, ok = convert_continuous_f0(lf0)
    if not ok:
        return []
    feats = {"f0": lf0[:, None], "cf0": cf0[:, None], "uv": uv[:, None],
             "mcep": mcep, "bap": bap}
    if "mcap" in config["aux_feats"]:
        # mel-cepstral aperiodicity (reference ssc_postprocessing.py:170)
        ap = aperiodicity_spectrum(bap, sr, (sp.shape[1] - 1) * 2)
        feats["mcap"] = sp2mc(np.maximum(ap, 1e-10),
                              order=int(config["mcap_dim"]), alpha=ALPHA[sr])
    cols = []
    for name in config["aux_feats"]:
        v = feats[name]
        if scaler is not None and name in scaler:
            v = scaler[name].transform(v)
        cols.append(v)
    c = np.concatenate(cols, axis=1).astype(np.float32)
    df_f0 = cf0 if config["df_f0_type"] == "cf0" else lf0
    sine_f0 = cf0 if config["sine_f0_type"] == "cf0" else lf0
    items = []
    for fac in f0_factors:
        # the excitation's F0 streams scale, the aux features stay
        if anasyn:
            suffix = "_anasyn" if fac == 1.0 else f"_anasyn_f{fac:.2f}"
        else:
            suffix = "_sifigan"
        items.append({"key": utt["key"], "suffix": suffix, "c": c,
                      "df_f0": np.asarray(df_f0, np.float64) * fac,
                      "sine_f0": np.asarray(sine_f0, np.float64) * fac,
                      "n_frames": len(lf0)})
    return items


def synthesize(items: Sequence[Dict], model, config: Dict,
               signal_gen: SignalGenerator, *, frame_bucket: int = 128,
               batch_size: int = 8) -> Iterator[tuple]:
    """Phase 2: the items' waveforms, same-bucket items in one generator
    call (buckets in ascending order, items in order within one; batches
    padded to a power of two by repeating the last item, whose
    excitation is drawn too, as JAX draws it).  Yields (item, waveform
    ``(n_frames * hop,)`` numpy)."""
    sr = int(config["sample_rate"])
    hop = int(sr * float(config["frame_period"]) / 1000.0)
    bucket = max(int(frame_bucket), 0)
    max_batch = max(int(batch_size), 1) if bucket else 1
    dev = next(model.parameters()).device

    def padded_frames(t: int) -> int:
        return max(-(-t // bucket) * bucket, bucket) if bucket else t

    groups: Dict[int, List[Dict]] = {}
    for item in items:
        groups.setdefault(padded_frames(item["n_frames"]), []).append(item)
    for t_b in sorted(groups):
        group = groups[t_b]
        for lo in range(0, len(group), max_batch):
            real = group[lo:lo + max_batch]
            cs, sines, dfs_rows = [], [], []
            for it in pad_pow2(real):
                pad = t_b - it["n_frames"]
                cs.append(np.pad(it["c"], ((0, pad), (0, 0)), mode="edge"))
                sines.append(signal_gen(np.pad(it["sine_f0"], (0, pad),
                                               mode="edge")))
                dfs_rows.append(dense_factors_per_level(
                    np.pad(it["df_f0"], (0, pad), mode="edge"), sr,
                    config["dense_factors"], model.upsample_scales))
            with torch.no_grad():
                y, _ = model(
                    torch.from_numpy(np.stack(sines)).to(dev),
                    torch.from_numpy(np.stack(cs)).to(dev),
                    [torch.from_numpy(np.stack([r[i] for r in dfs_rows]))
                     .to(dev) for i in range(len(dfs_rows[0]))])
            y = y.float().cpu().numpy()
            for row, it in zip(y, real):
                yield it, row[:it["n_frames"] * hop, 0]


def postprocess_core(model, utterances: Sequence[Dict], config: Dict, *,
                     f0_backend: str = "harvest", ap_backend: str = "bandap",
                     analysis_backend: str = "device",
                     synth_batch_size: int = 8, synth_frame_bucket: int = 128,
                     anasyn: bool = False,
                     f0_factors: Sequence[float] = (1.0,), scaler=None,
                     device=None) -> Iterator[tuple]:
    """Stage 9 after the reads: analysis of each utterance
    (``{"key", "wav" at the config's rate, "lf0" (None with ``anasyn``),
    "f0_range"}``), then bucketed synthesis with ``model``.  Yields (key,
    suffix, waveform) in synthesis order; the excitation's noise comes
    from the config's seed, drawn in that order."""
    if f0_backend not in F0_BACKENDS:
        raise ValueError(f"unknown f0_backend {f0_backend!r}")
    if not anasyn and tuple(f0_factors) != (1.0,):
        raise ValueError("F0 factors apply with anasyn only: the SSC flow's "
                         "target F0 is the decode-written lf0")
    sr = int(config["sample_rate"])
    hop = int(sr * float(config["frame_period"]) / 1000.0)
    items = []
    for utt in utterances:
        if not anasyn and utt.get("lf0") is None:
            raise ValueError(f"{utt['key']}: no lf0 (the SSC flow needs the "
                             "decode-written target F0)")
        items += analyze(utt, config, f0_backend=f0_backend,
                         ap_backend=ap_backend,
                         analysis_backend=analysis_backend, anasyn=anasyn,
                         f0_factors=f0_factors, scaler=scaler,
                         device=device)
    signal_gen = SignalGenerator(
        sample_rate=sr, hop_size=hop, sine_amp=config["sine_amp"],
        noise_amp=config["noise_amp"], signal_types=config["signal_types"],
        seed=config["seed"])
    for it, wav in synthesize(items, model, config, signal_gen,
                              frame_bucket=synth_frame_bucket,
                              batch_size=synth_batch_size):
        yield it["key"], it["suffix"], wav


# -- the file shell ---------------------------------------------------------


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SiFiGAN post-processing")
    p.add_argument("--config", default=None, help="yaml config")
    p.add_argument("--in-dir", required=True)
    p.add_argument("--stats", default=None,
                   help="joblib scalers of the aux features (SiFiGAN "
                        "training stats); identity normalization when "
                        "absent")
    p.add_argument("--checkpoint-path", default=None,
                   help="a released SiFiGAN torch .pkl (converted on the "
                        "fly) or a checkpoint directory of vocoder_train "
                        "--vocoder-type sifigan; seeded random weights when "
                        "absent (smoke and testing only)")
    p.add_argument("--f0-backend", default="harvest", choices=F0_BACKENDS,
                   help="re-analysis F0: Harvest (the reference's), "
                        "'harvest_native' on the host, or YIN + Viterbi")
    p.add_argument("--ap-backend", default="bandap",
                   choices=tuple(AP_BACKENDS),
                   help="aperiodicity: band autocorrelation or WORLD's D4C")
    p.add_argument("--analysis-backend", default="device",
                   choices=ANALYSIS_BACKENDS,
                   help="CheapTrick and aperiodicity: on the device, or the "
                        "C++ host library ('native', band aperiodicity "
                        "only)")
    p.add_argument("--synth-batch-size", type=int, default=8,
                   help="most utterances a generator call; same-bucket "
                        "utterances batch, padded to a power of two")
    p.add_argument("--synth-frame-bucket", type=int, default=128,
                   help="pad synthesis inputs to this frame multiple (edge "
                        "values; the output cut at the true length); 0 = "
                        "exact lengths, one utterance a call")
    p.add_argument("--anasyn", action="store_true",
                   help="analysis-synthesis: condition on each wav's own "
                        "analysed F0 (no lf0 h5), scaled by --f0-factors; "
                        "writes *_anasyn[_fX.XX].wav")
    p.add_argument("--f0-factors", default=None,
                   help="comma list of F0 factors for --anasyn (default "
                        "'1.0')")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions)")
    p.add_argument("--verbose", type=int, default=1)
    return p


def main(argv=None):
    p = build_argparser()
    args = p.parse_args(argv)
    if args.f0_factors and not args.anasyn:
        p.error("--f0-factors only applies with --anasyn (the SSC flow's "
                "target F0 comes from the decode-written lf0 h5)")
    if args.analysis_backend == "native" and args.ap_backend != "bandap":
        p.error("--analysis-backend native supports --ap-backend bandap "
                "only (there is no native D4C)")
    logging.basicConfig(
        level=logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: "
               "%(message)s")

    from serenade_tpu_torch.utils.audio import (
        read_wav, resample, to_mono, write_wav,
    )

    config = dict(DEFAULT_CONFIG)
    if args.config:
        from serenade_tpu_torch.config import load_config

        config.update(load_config(args.config))
    dev = resolve_device(args.device)
    model = load_generator(config, args.checkpoint_path, device=dev)
    scaler = None
    if args.stats and args.checkpoint_path and os.path.isdir(
            args.checkpoint_path):
        logger.warning(
            "--stats given with a trained checkpoint directory: the trainer "
            "conditions on raw mcep/bap (no scaler); a released model's "
            "scaler mis-scales the aux features")
    if args.stats:
        if not os.path.exists(args.stats):
            raise FileNotFoundError(f"no aux-feature stats {args.stats}")
        from serenade_tpu_torch.utils.scalers import load_scalers

        scaler = load_scalers(args.stats)

    sr = int(config["sample_rate"])
    wav_paths = [w for w in glob.glob(os.path.join(args.in_dir, "**", "*.wav"),
                                      recursive=True)
                 if not any(m in os.path.basename(w) for m in SKIPPED)]
    logger.info("processing %d wavs from %s", len(wav_paths), args.in_dir)
    utterances = []
    for path in wav_paths:
        x, in_sr = read_wav(path)
        x = to_mono(x)
        if in_sr != sr:
            x = resample(x, in_sr, sr)
        lf0 = None
        if not args.anasyn:
            from serenade_tpu_torch.utils.h5 import read_hdf5

            lf0 = read_hdf5(path.replace(".wav", ".h5"), "lf0")
            if lf0 is None:
                logger.warning("no lf0 h5 beside %s; skipping", path)
                continue
        utterances.append({"key": path, "wav": x, "lf0": lf0,
                           "f0_range": voice_range_for(path)})
    f0_factors = ([float(s) for s in (args.f0_factors or "1.0").split(",")]
                  if args.anasyn else [1.0])
    for key, suffix, wav in postprocess_core(
            model, utterances, config, f0_backend=args.f0_backend,
            ap_backend=args.ap_backend,
            analysis_backend=args.analysis_backend,
            synth_batch_size=args.synth_batch_size,
            synth_frame_bucket=args.synth_frame_bucket, anasyn=args.anasyn,
            f0_factors=f0_factors, scaler=scaler, device=dev):
        out = key.replace(".wav", f"{suffix}.wav")
        write_wav(out, wav, sr)
        logger.info("wrote %s", out)


if __name__ == "__main__":
    main()
