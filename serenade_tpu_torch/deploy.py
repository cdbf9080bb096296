"""Deployment artifacts: the conversion as exported programs (counterpart of
serenade_tpu/deploy.py).

``export_converter`` writes the hot path of a conversion (feature
normalization, the packed reference‖source CFM inference and, with a
vocoder, HiFiGAN) into one directory: a manifest and one batch-1 program a
``(source, reference)`` frame bucket and platform, saved by
``torch.export.save`` with the weights and the normalization statistics
baked in.  ``ExportedConverter`` (``load``) runs it without the model code,
the config registry, the checkpoint machinery or the scaler pickles: it
imports the module that registers the custom ops (``ops/custom_ops.py``)
and nothing of ``models/``, ``api``, ``checkpoint``, ``config`` or
``utils/scalers``.

The JAX package exports StableHLO and forces the portable paths (XLA
attention, the conv lowering of the resblocks) because Pallas calls do
not serialize.  Here the kernels K1, K2 and K3 are ``torch.library``
custom ops inside the program: it launches the hand-written kernels on
the card and runs their plain versions on the CPU.  A program is exported
for one device; ``platforms`` defaults to the Converter's device and the
CPU, as JAX's defaults to the current backend and the CPU.

JAX's programs take threefry key data; these take the noise ``x0``
(already scaled by the temperature) and, for the F0-fluctuation variant,
the two shifts.  ``ExportedConverter`` draws them from its own
``torch.Generator(seed)`` in the order the live Converter draws them, so
``load(art, seed=s)`` and a ``Converter(seed=s)`` of the same weights
convert alike at a bucket both pick.  With ``quantize="int8"`` the
program's constants are the int8 weights and their scales, dequantized
inside the program once per call.
"""

from __future__ import annotations

import copy
import importlib
import json
import logging
import os
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from serenade_tpu_torch import resolve_device, upload

logger = logging.getLogger(__name__)

_MANIFEST = "manifest.json"
_FORMAT_VERSION = 1
KIND = "serenade_tpu_torch.converter"
OPS_MODULE = "serenade_tpu_torch.ops.custom_ops"


def _bucket_name(ts: int, tr: int) -> str:
    return f"convert_s{ts}_r{tr}"


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class _Program(nn.Module):
    """One bucket's conversion, batch 1: raw (un-normalized, h5-layout)
    features padded to ``(ts, tr)`` frames, the noise ``x0`` ``(1, tr + ts,
    mels)`` and, for the variant, ``shifts`` ``(2,)`` in; the normalized
    mel ``(1, ts, mels)`` and, with a vocoder, the waveform ``(1, ts *
    hop)`` out."""

    def __init__(self, conv, ts: int, tr: int, solver: str):
        super().__init__()
        self.ts, self.tr, self.solver = ts, tr, solver
        self.n_timesteps = conv.n_timesteps
        self.variant_new = conv.variant_new
        self.model = conv.model
        sc, dev = conv.scaler, conv.device
        for name in ("hubert", "logmel"):
            for stat in ("mean", "scale"):
                self.register_buffer(f"{name}_{stat}",
                                     _f32(sc[name][stat], dev))
        for name in ("score", "loud"):
            self.register_buffer(f"{name}_min", _f32(sc[name]["min"], dev))
            self.register_buffer(f"{name}_rng", _f32(
                np.float32(sc[name]["max"]) - np.float32(sc[name]["min"]),
                dev))
        # "int8": the weights' int8 values and scales, dequantized in the
        # program into the dtypes the live Converter binds them in
        self._qnames = list(conv._qweights)
        self._qdtypes = [dt for _, dt in conv._qweights.values()]
        for i, (qt, _) in enumerate(conv._qweights.values()):
            self.register_buffer(f"q{i}", qt.q)
            self.register_buffer(f"q{i}_scale", qt.scale)
        voc = conv.vocoder
        self.generator = None if voc is None else voc.model
        if voc is not None:
            self.take_norm_feat = voc.take_norm_feat
            for key in ("mean", "scale"):
                self.register_buffer(f"voc_{key}", voc.stats[key])
                if voc.take_norm_feat:
                    self.register_buffer(f"trg_{key}", voc.trg_stats[key])

    def _weights(self) -> Dict[str, torch.Tensor]:
        return {name: (getattr(self, f"q{i}").float()
                       * getattr(self, f"q{i}_scale")).to(dtype)
                for i, (name, dtype) in enumerate(zip(self._qnames,
                                                      self._qdtypes))}

    def forward(self, src_x, src_len, src_score, src_loud, src_fluc,
                ref_x, ref_len, ref_logmel, ref_score, ref_loud, ref_fluc,
                x0, shifts: Optional[torch.Tensor] = None):
        from serenade_tpu_torch.quantize import bound_parameters

        ts, tr = self.ts, self.tr
        # padding is zero in NORMALIZED space (the collater pads after the
        # scaler): padded frames are zeroed again after normalizing, so
        # the boundary convolutions see what the live path sees
        m_src = (torch.arange(ts, device=src_x.device)[None, :, None]
                 < src_len[:, None, None]).float()
        m_ref = (torch.arange(tr, device=ref_x.device)[None, :, None]
                 < ref_len[:, None, None]).float()

        def std(a, name, m):
            return (a - getattr(self, f"{name}_mean")) / getattr(
                self, f"{name}_scale") * m

        def minmax(a, name, m):
            return (a - getattr(self, f"{name}_min")) / getattr(
                self, f"{name}_rng") * m

        args = [std(src_x, "hubert", m_src), src_len,
                minmax(src_score, "score", m_src),
                minmax(src_loud, "loud", m_src)]
        if self.variant_new:
            args.append(src_fluc * m_src)
        args += [std(ref_x, "hubert", m_ref), ref_len,
                 std(ref_logmel, "logmel", m_ref),
                 minmax(ref_score, "score", m_ref),
                 minmax(ref_loud, "loud", m_ref)]
        extra = {}
        if self.variant_new:
            args.append(ref_fluc * m_ref)
            extra["shifts"] = shifts
        with bound_parameters(self.model, self._weights()) as model:
            mel = model.inference(*args, n_timesteps=self.n_timesteps,
                                  solver=self.solver, x0=x0, **extra)
        if self.generator is None:
            return (mel,)
        # edge-pad past the true length before vocoding: zeros in
        # normalized mel space are average energy, audible through the
        # convolutions' reach (as Vocoder.decode_batch_device pads)
        idx = torch.minimum(torch.arange(ts, device=mel.device)[None, :],
                            (src_len - 1)[:, None])
        c = torch.gather(mel, 1, idx[:, :, None].expand(*mel.shape))
        if self.take_norm_feat:
            c = c * self.trg_scale + self.trg_mean
        c = (c - self.voc_mean) / self.voc_scale
        return mel, self.generator(c)[..., 0].float()


def _example_inputs(ts, tr, content_dim, mel_dim, variant_new, device):
    f32 = dict(dtype=torch.float32, device=device)

    def lengths():   # one tensor each: export ties an input given twice
        return torch.ones((1,), dtype=torch.int32, device=device)

    out = [torch.zeros((1, ts, content_dim), **f32), lengths(),
           torch.zeros((1, ts, 1), **f32), torch.zeros((1, ts, 1), **f32),
           torch.zeros((1, ts, 1), **f32),
           torch.zeros((1, tr, content_dim), **f32), lengths(),
           torch.zeros((1, tr, mel_dim), **f32),
           torch.zeros((1, tr, 1), **f32), torch.zeros((1, tr, 1), **f32),
           torch.zeros((1, tr, 1), **f32),
           torch.zeros((1, tr + ts, mel_dim), **f32)]
    if variant_new:
        out.append(torch.zeros((2,), dtype=torch.int64, device=device))
    return tuple(out)


def program_ops(module) -> Dict[str, int]:
    """The custom-op call sites of a program (an exported or loaded graph
    module), by op, over its graph and the ODE loop's body: a site in the
    body counts once, however many steps run it."""
    counts: Dict[str, int] = {}
    for gm in module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            target = str(node.target)
            if node.op == "call_function" and target.startswith("serenade."):
                op = target.split(".")[1]
                counts[op] = counts.get(op, 0) + 1
    return counts


def export_converter(conv, out_dir: str,
                     buckets: Sequence[Tuple[int, int]] = ((1024, 512),),
                     platforms: Optional[Sequence[str]] = None,
                     solver: Optional[str] = None) -> dict:
    """Export ``conv`` (an ``api.Converter``) for the given ``(src_frames,
    ref_frames)`` buckets and ``platforms`` (``"cuda"``, ``"cpu"``;
    default the Converter's device and the CPU).  ``solver`` defaults to
    the Converter's own.  Returns the manifest, which records each
    program's custom-op sites (``program_ops``)."""
    from serenade_tpu_torch.ops import custom_ops  # noqa: F401 (registers)

    if conv.quantize == "int8_compute":
        raise ValueError("export takes quantize=None or 'int8' (JAX's "
                         "export CLI takes --quantize int8 only)")
    solver = solver or conv.solver
    if platforms is None:
        platforms = ((conv.device.type, "cpu") if conv.device.type != "cpu"
                     else ("cpu",))
    platforms = tuple(dict.fromkeys(platforms))
    os.makedirs(out_dir, exist_ok=True)
    content_dim = int(conv.scaler["hubert"]["mean"].shape[0])
    mel_dim = int(conv.scaler["logmel"]["mean"].shape[0])
    files: Dict[str, Dict[str, str]] = {}
    seconds: Dict[str, Dict[str, float]] = {}
    ops: Dict[str, Dict[str, Dict[str, int]]] = {}
    for ts, tr in buckets:
        ts, tr = int(ts), int(tr)
        name = _bucket_name(ts, tr)
        program = _Program(conv, ts, tr, solver).eval()
        files[name], seconds[name], ops[name] = {}, {}, {}
        for platform in platforms:
            start = time.perf_counter()
            prog = (program if platform == conv.device.type
                    else copy.deepcopy(program).to(platform))
            args = _example_inputs(ts, tr, content_dim, mel_dim,
                                   conv.variant_new, torch.device(platform))
            with torch.no_grad():
                exported = torch.export.export(prog, args, strict=False)
            # the trace's source lines, repeated for each node of the ODE
            # step's subgraph, make most of a saved program and its load
            for gm in exported.graph_module.modules():
                if isinstance(gm, torch.fx.GraphModule):
                    for node in gm.graph.nodes:
                        node.meta.pop("stack_trace", None)
            fname = f"{name}.{platform}.pt2"
            torch.export.save(exported, os.path.join(out_dir, fname))
            files[name][platform] = fname
            ops[name][platform] = program_ops(exported.graph_module)
            seconds[name][platform] = time.perf_counter() - start
            logger.info("exported %s for %s (%d bytes)", name, platform,
                        os.path.getsize(os.path.join(out_dir, fname)))
    voc = conv.vocoder
    hop_s = conv.config.get("hop_size")
    sr_s = conv.config.get("sampling_rate")
    manifest = {
        "format_version": _FORMAT_VERSION,
        "kind": KIND,
        # the feature frame shift in seconds: the artifact server's audio
        # seconds (/healthz) and request cap
        "frame_shift_s": (float(hop_s) / float(sr_s)
                          if hop_s and sr_s else None),
        "buckets": [[int(ts), int(tr)] for ts, tr in buckets],
        "files": files,
        "platforms": list(platforms),
        "variant_new": bool(conv.variant_new),
        "n_timesteps": int(conv.n_timesteps),
        "solver": solver,
        "temperature": float(conv.temperature),
        "num_mels": mel_dim,
        "content_dim": content_dim,
        "has_vocoder": voc is not None,
        "quantize": conv.quantize,
        "hop_size": (int(np.prod(voc.model.upsample_scales))
                     if voc is not None else None),
        "sample_rate": voc.sampling_rate if voc is not None else None,
        "torch_version": torch.__version__,
        "ops_module": OPS_MODULE,
        # K1, K2 and K3's sites in each program; a shape a kernel refuses
        # is routed, and counted, when the program runs
        "custom_ops": ops,
        # each program's export and save, host seconds
        "export_seconds": seconds,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ExportedConverter:
    """Run an artifact directory: raw features in, mel (and waveform) out,
    with ``api.Converter.convert_features``'s padding and normalization
    (baked into the programs) and no model code.  Runs on CUDA unless
    ``device`` says otherwise; refuses an artifact exported for other
    platforms."""

    def __init__(self, art_dir: str, seed: int = 0, device=None):
        self.device = resolve_device(device)
        with open(os.path.join(art_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("kind") != KIND:
            raise ValueError(f"{art_dir} is not a converter artifact of "
                             "this package")
        platform = self.device.type
        if platform not in self.manifest["platforms"]:
            raise RuntimeError(
                f"artifact exported for {self.manifest['platforms']}, "
                f"current device is {platform}")
        importlib.import_module(self.manifest["ops_module"])
        self.programs = {
            name: torch.export.load(os.path.join(art_dir, per[platform]))
            .module()
            for name, per in self.manifest["files"].items()}
        self.generator = torch.Generator(self.device).manual_seed(seed)
        # a server converts from several threads: one conversion at a time
        # (a program's launches come from the calling thread, so threads
        # running programs side by side only take turns at the
        # interpreter), its draws in the order the runs go
        self._lock = threading.Lock()

    @property
    def sample_rate(self) -> Optional[int]:
        return self.manifest["sample_rate"]

    def _pick_bucket(self, t_src: int, t_ref: int) -> Tuple[int, int]:
        fits = [(ts, tr) for ts, tr in self.manifest["buckets"]
                if ts >= t_src and tr >= t_ref]
        if not fits:
            raise ValueError(
                f"no exported bucket fits src={t_src}/ref={t_ref} frames "
                f"(buckets: {self.manifest['buckets']})")
        # least padded work: the packed CFM sequence is ts + tr frames
        return min(fits, key=lambda b: (b[0] + b[1], b[0], b[1]))

    def _pad(self, a, t: int) -> torch.Tensor:
        a = np.asarray(a, np.float32)
        if a.ndim == 1:
            a = a[:, None]
        out = np.zeros((1, t, a.shape[1]), np.float32)
        out[0, : min(t, a.shape[0])] = a[:t]
        return upload(out, self.device)

    def convert_features(self, src_feats, ref_feats
                         ) -> Tuple[np.ndarray, Optional[np.ndarray],
                                    Optional[int]]:
        """Raw (un-normalized, h5-layout) feature dicts -> (mel, waveform
        or None, rate or None).  src needs hubert, score and loud (and
        f0_fluc for the variant); ref also logmel."""
        man = self.manifest
        t_src = int(np.asarray(src_feats["hubert"]).shape[0])
        t_ref = int(np.asarray(ref_feats["hubert"]).shape[0])
        ts, tr = self._pick_bucket(t_src, t_ref)
        prog = self.programs[_bucket_name(ts, tr)]
        fluc_s, fluc_r = src_feats.get("f0_fluc"), ref_feats.get("f0_fluc")
        if man["variant_new"] and (fluc_s is None or fluc_r is None):
            raise ValueError("F0-fluctuation artifact needs f0_fluc features")
        lengths = [upload(np.asarray([t], np.int32), self.device)
                   for t in (t_src, t_ref)]
        inputs = [
            self._pad(src_feats["hubert"], ts), lengths[0],
            self._pad(src_feats["score"], ts),
            self._pad(src_feats["loud"], ts),
            self._pad(fluc_s if fluc_s is not None else np.zeros(t_src), ts),
            self._pad(ref_feats["hubert"], tr), lengths[1],
            self._pad(ref_feats["logmel"], tr),
            self._pad(ref_feats["score"], tr),
            self._pad(ref_feats["loud"], tr),
            self._pad(fluc_r if fluc_r is not None else np.zeros(t_ref), tr)]
        with self._lock, torch.no_grad():
            # the live Converter's draws, in its order: the noise, then
            # the variant's shifts
            x0 = torch.randn((1, tr + ts, man["num_mels"]),
                             generator=self.generator, dtype=torch.float32,
                             device=self.device)
            if man["variant_new"]:
                inputs.append(torch.randint(0, max(ts, 1), (2,),
                                            generator=self.generator,
                                            device=self.device))
            inputs.insert(11, x0 * man["temperature"])
            out = prog(*inputs)
            mel = out[0][0, :t_src].cpu().numpy()
            wav = (out[1][0, : t_src * man["hop_size"]].cpu().numpy()
                   if man["has_vocoder"] else None)
        if wav is None:
            return mel, None, None
        return mel, wav, man["sample_rate"]


def load(art_dir: str, seed: int = 0, device=None) -> ExportedConverter:
    return ExportedConverter(art_dir, seed=seed, device=device)


class ArtifactService:
    """Serve an artifact through ``serving.make_server``: HTTP conversion
    on a host with no model code, checkpoints or scaler pickles
    (``bin/serve.py --artifact DIR``).

    Duck-types the ``BatchingConverter`` surface the handler uses: POST
    /convert_features and /register_reference work (the programs are
    batch 1, so requests run in the handler's thread, with no batching
    queue) and GET /healthz reports the counters.  /convert_wav and the
    stream endpoints answer 400: feature extraction and ContentVec are not
    in the program (serve with ``--expdir`` for them)."""

    def __init__(self, art_dir: str, seed: int = 0, max_references: int = 64,
                 max_request_seconds: float = 600.0, device=None):
        self._exp = ExportedConverter(art_dir, seed=seed, device=device)
        self.device = self._exp.device
        self._max_references = max_references
        self.max_request_seconds = float(max_request_seconds)
        shift = self.manifest.get("frame_shift_s")
        self._max_frames = (int(self.max_request_seconds / float(shift))
                            if shift else None)
        self._lock = threading.Lock()
        self._raw_refs: Dict[str, Dict[str, np.ndarray]] = {}
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "audio_sec": 0.0, "compute_sec": 0.0}

    @property
    def manifest(self) -> dict:
        return self._exp.manifest

    @property
    def converter(self):
        """The stream handlers ask for the live Converter first; an
        artifact has none, so they answer 400."""
        raise ValueError(
            "streaming endpoints need a live model (serve --expdir); the "
            "exported artifact serves pre-extracted features only "
            "(/convert_features)")

    def _on_device(self):
        return torch.no_grad()

    def reference_names(self):
        return sorted(self._raw_refs)

    def register_reference(self, name: str, ref_feats) -> None:
        """Keep a style's raw features on the host: its normalization is
        inside the program, so there is nothing to pack."""
        from serenade_tpu_torch.serving import check_registry_capacity

        feats = {k: np.asarray(v) for k, v in ref_feats.items()}
        self._validate(feats, "ref", with_mel=True)
        with self._lock:   # check and insert at once: handlers race here
            check_registry_capacity(self._raw_refs, name,
                                    self._max_references)
            self._raw_refs[name] = feats

    def raw_reference(self, name: str):
        if name not in self._raw_refs:
            raise KeyError(f"unknown reference style {name!r}; "
                           f"registered: {self.reference_names()}")
        return self._raw_refs[name]

    def packed_reference(self, name: str):
        raise ValueError("streaming endpoints are not supported by the "
                         "artifact server; serve with --expdir")

    def _validate(self, feats, what: str, with_mel: bool) -> None:
        from serenade_tpu_torch.serving import validate_feature_dict

        man = self.manifest
        validate_feature_dict(feats, what, with_mel,
                              content_dim=int(man["content_dim"]),
                              num_mels=int(man["num_mels"]),
                              variant_new=bool(man["variant_new"]),
                              max_frames=self._max_frames)

    def convert(self, src_feats, ref, timeout: float = 300.0):
        """(mel, waveform or None, rate or None), the /convert_features
        contract; ``ref`` is a feature dict or a registered style's name."""
        import time

        del timeout   # synchronous: the program runs in the caller
        try:
            self._validate(src_feats, "src", with_mel=False)
            if isinstance(ref, str):
                ref = self.raw_reference(ref)
            else:
                self._validate(ref, "ref", with_mel=True)
            t0 = time.perf_counter()
            mel, wav, sr = self._exp.convert_features(src_feats, ref)
            dt = time.perf_counter() - t0
        except Exception:
            with self._lock:
                self.stats["errors"] += 1
            raise
        shift = self.manifest.get("frame_shift_s") or 0.0
        with self._lock:
            self.stats["requests"] += 1
            self.stats["batches"] += 1
            self.stats["compute_sec"] += dt
            self.stats["audio_sec"] += mel.shape[0] * shift
        return mel, wav, sr

    def convert_wav(self, src_wav, sr, ref, timeout: float = 300.0,
                    f0_range=None):
        raise ValueError(
            "/convert_wav needs feature extraction on the server; the "
            "exported artifact serves pre-extracted features only: serve "
            "with --expdir and --contentvec-ckpt for raw audio")

    def close(self, join_timeout: float = 5.0) -> None:
        """No worker threads to stop."""
