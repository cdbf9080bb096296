"""Conversion API (counterpart of serenade_tpu/api.py ``Converter``:
``convert_features``, ``pack_reference`` and ``convert_features_batch``;
from raw audio, ``extract_from_wav``, ``extract_from_wav_batch``,
``convert_wav`` and ``style_embedding``; long-form and streaming,
``convert_features_long``, ``convert_features_stream``,
``convert_wav_stream`` and ``convert_wav_stream_live``; from a trained
experiment directory, ``Converter.from_expdir``).  The F0-fluctuation
variant (``model_type="SerenadeNew"``) takes ``f0_fluc`` through every
entry point, as the JAX Converter's ``variant_new`` does.  ``quantize=
"int8"`` or ``"int8_compute"`` serves int8 weights (``quantize.py``), and
``deploy.export_converter`` exports a Converter as an artifact.

Everything comes in as data: model, vocoder and ContentVec configs as
dicts (``configs.py`` holds the full-width ones), parameters as a flax
tree of numpy arrays or a state dict (None draws seeded random weights;
ContentVec also takes a Hugging Face ``HubertModel`` state dict), scaler
statistics as arrays::

    scaler = {"hubert": {"mean": m, "scale": s},
              "score": {"min": lo, "max": hi},
              "loud": {"min": lo, "max": hi},
              "logmel": {"mean": m, "scale": s}}

(sklearn's ``mean_``/``scale_`` and ``data_min_``/``data_max_``;
``utils.scalers.load_stats`` reads them from a ``stats.joblib`` or an
``.npz``).
"""

from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from serenade_tpu_torch import resolve_device, upload
from serenade_tpu_torch.collaters.ssc import bucket_length, next_pow2, pad_to
from serenade_tpu_torch.config import resolve
from serenade_tpu_torch.configs import FEATURE_CONFIG
from serenade_tpu_torch.convert import load_params
from serenade_tpu_torch.features import (
    FeatureConfig, _prepare_audio, extract_features, extract_features_batch,
    extract_stream_window, stream_total_frames, validate_waveform,
)
from serenade_tpu_torch.models.layers import (
    compute_weight_dtypes,
    init_params_,
    store_compute_weights_,
)
from serenade_tpu_torch.models.serenade import Serenade
from serenade_tpu_torch.ops.longform import (
    StreamStitcher, convert_in_chunks, convert_in_chunks_stream,
    split_chunks_ramp, stitch_mel_stream,
)
from serenade_tpu_torch.parallel.mesh import (
    make_mesh, replica_devices, replicate, run_replicas, split_rows,
)
from serenade_tpu_torch.quantize import (
    bound_parameters, quantize_dense_tree, quantize_tree, remove_parameters_,
    split_quantized,
)
from serenade_tpu_torch.vocoder.vocoder import Vocoder

SRC_KEYS = ("hubert", "score", "loud")
REF_KEYS = SRC_KEYS + ("logmel",)
FLUC = ("f0_fluc",)   # the F0-fluctuation variant's stream, unscaled
QUANTIZE_MODES = ("int8", "int8_compute")


def load_checkpoint_params(checkpoint: str, model_params: Mapping,
                           model_cls=Serenade) -> Tuple[dict, dict]:
    """(state dict, model arguments) of a checkpoint: a port checkpoint
    directory (``checkpoint.restore_params_only``), or a reference torch
    ``.pkl`` converted for ``model_cls(**model_params)``, whose GST then
    runs the checkpoint's BatchNorm statistics (``gst_norm_type=
    "frozen_batch"``)."""
    model_params = dict(model_params)
    if str(checkpoint).endswith(".pkl"):
        from serenade_tpu_torch.models.convert_serenade import (
            convert_serenade, load_torch_serenade_checkpoint,
        )

        model_params["gst_norm_type"] = "frozen_batch"
        return convert_serenade(load_torch_serenade_checkpoint(checkpoint),
                                model_params, model_cls), model_params
    from serenade_tpu_torch.checkpoint import restore_params_only

    return restore_params_only(checkpoint), model_params


def _check_quantize(quantize: Optional[str]) -> None:
    if quantize not in (None,) + QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r} (supported: "
                         f"{', '.join(QUANTIZE_MODES)})")


class Converter:
    def __init__(self, model_config: Mapping, params, scaler: Mapping, *,
                 vocoder_config: Optional[Mapping] = None,
                 vocoder_params=None, vocoder_stats: Optional[Mapping] = None,
                 contentvec_config: Optional[Mapping] = None,
                 contentvec_params=None, n_timesteps: int = 10,
                 solver: str = "euler", temperature: float = 0.667,
                 seed: int = 0, device=None, model_type: str = "Serenade",
                 quantize: Optional[str] = None,
                 data_mesh: Optional[int] = None, mesh_devices=None):
        """``model_type``: the registry's model (``"SerenadeNew"``, the
        F0-fluctuation variant, takes ``f0_fluc`` in every feature dict).
        ``quantize="int8"`` keeps the model's weights int8 per channel on
        the device, dequantized once per conversion; ``"int8_compute"``
        quantizes only the estimator's Dense weights, whose products then
        run int8 x int8 (``quantize.py``; the vocoder and ContentVec stay
        float, as in the JAX Converter).
        ``vocoder_config`` None converts to mel only.
        ``contentvec_config`` (``configs.CONTENTVEC_CONFIG`` at full width)
        turns on the raw-audio entry points, with ``contentvec_params`` a
        Hugging Face ``HubertModel`` state dict (or a path to one), a flax
        tree, or None for weights from ``seed + 2``.  Runs on CUDA unless
        ``device`` says otherwise.

        ``data_mesh=N`` converts each batch data-parallel over N devices
        (``cuda:0`` .. ``cuda:N-1``, or N replicas of the CPU), or over
        ``mesh_devices`` where given (which may name one card twice): each
        replica converts its rows on its own device (replicas on one
        device share its weights and a stream), batches pad to a multiple
        of N, and the host joins the mels, as the JAX Converter shards a
        batch over its ``data_mesh``."""
        _check_quantize(quantize)
        mesh_devices = (list(mesh_devices) if mesh_devices else
                        replica_devices(data_mesh, device or "cuda")
                        if data_mesh and data_mesh > 1 else None)
        self.device = resolve_device(device)
        # feature extraction's settings (the recipe's), and the frame rate
        # a server counts audio seconds by
        self.config = dict(FEATURE_CONFIG)
        model_cls = resolve("model", model_type)
        # the variant threads the F0 fluctuation through inference: a
        # capability of the class, as in the JAX Converter
        self.variant_new = bool(getattr(model_cls, "uses_f0_fluc", False))
        self._src_keys = SRC_KEYS + (FLUC if self.variant_new else ())
        self._ref_keys = REF_KEYS + (FLUC if self.variant_new else ())
        model = model_cls(**model_config)
        if params is None:
            init_params_(model, seed)
        else:
            load_params(model, params)
        # quantized from the f32 parameters, before they are stored in the
        # dtypes their layers compute in
        self.quantize = quantize
        self._qweights = {}
        if quantize == "int8":
            dtypes = compute_weight_dtypes(model)
            self._qweights = {
                name: (qt.to(self.device), dtypes.get(name, torch.float32))
                for name, qt in split_quantized(quantize_tree(model)).items()}
            remove_parameters_(model, self._qweights)
        elif quantize == "int8_compute":
            for name, qt in split_quantized(
                    quantize_dense_tree(model)).items():
                model.get_submodule(name.rpartition(".")[0]).use_int8_(qt)
        self.model = store_compute_weights_(model.to(self.device).eval())
        self.mesh = None
        if mesh_devices:
            if quantize == "int8" and any(
                    torch.device(d) != self.device for d in mesh_devices):
                raise ValueError("quantize='int8' binds its weights on one "
                                 "device: its data mesh must name only "
                                 f"{self.device}")
            self.mesh = make_mesh(data=len(mesh_devices), model=1,
                                  devices=mesh_devices)
            self._replicas = replicate(self.model, self.mesh)
        self._weights_lock = threading.Lock()
        self.scaler = {k: {kk: np.asarray(vv, np.float32)
                           for kk, vv in v.items()} for k, v in scaler.items()}
        self.n_timesteps, self.solver = n_timesteps, solver
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # a server converts from several threads: each noise draw advances
        # the generator atomically (serenade_tpu/api.py ``_next_key``)
        self._noise_lock = threading.Lock()
        self.vocoder = None
        if vocoder_config is not None:
            self.vocoder = Vocoder(
                vocoder_config, vocoder_params, vocoder_stats,
                trg_stats=self.scaler["logmel"], device=self.device,
                seed=seed + 1)
        self._content_fn = None
        if contentvec_config is not None:
            from serenade_tpu_torch.bin.preprocess import make_content_fn

            self._content_fn = make_content_fn(
                contentvec_params, config=contentvec_config,
                device=self.device, seed=seed + 2)
        # the content features' statistics on the device, for features
        # that stay there (raw-audio extraction's ContentVec output)
        self._hubert_stats = tuple(
            upload(self.scaler["hubert"][k], self.device)
            for k in ("mean", "scale"))

    @classmethod
    def from_expdir(cls, expdir: str, stats: str,
                    checkpoint: Optional[str] = None,
                    contentvec_ckpt: Optional[str] = None,
                    n_timesteps: Optional[int] = None,
                    solver: Optional[str] = None, temperature: float = 0.667,
                    seed: int = 0, device=None,
                    data_mesh: Optional[int] = None,
                    quantize: Optional[str] = None,
                    config: Optional[str] = None,
                    params: Optional[Mapping] = None) -> "Converter":
        """A Converter for a trained experiment directory, as the JAX
        package's ``Converter(expdir, stats, ...)`` builds it: its
        ``config.yml`` (or the file ``config`` names), ``checkpoint`` or
        else the latest ``checkpoint-<N>steps`` under ``expdir`` (a
        reference torch ``.pkl`` is converted, see
        :func:`load_checkpoint_params`) unless ``params``, a state dict
        already loaded (an average of checkpoints), stands in for it, the
        statistics file ``stats`` (``stats.joblib`` or ``.npz``), the
        vocoder of the config's ``vocoder:`` section, and ContentVec from
        ``contentvec_ckpt`` (a Hugging Face ``HubertModel`` state dict),
        with the weights quantized as ``quantize`` says (see ``__init__``).
        ``n_timesteps`` and ``solver`` default to the config's
        ``inference_n_timesteps`` / ``inference_solver``, else Euler-10.
        Needs ``pyyaml``, ``h5py`` for the vocoder's statistics unless
        they are an ``.npz``, and ``joblib`` for a ``stats.joblib``.  Runs on CUDA unless ``device`` says
        otherwise."""
        from serenade_tpu_torch.checkpoint import find_latest_checkpoint
        from serenade_tpu_torch.config import load_config
        from serenade_tpu_torch.utils.scalers import load_stats
        from serenade_tpu_torch.vocoder.vocoder import vocoder_from_section

        if data_mesh and data_mesh > 1:    # refused before anything loads
            replica_devices(data_mesh, device or "cuda")
        _check_quantize(quantize)
        config = load_config(config or os.path.join(expdir, "config.yml"))
        model_type = config["model_type"]
        model_cls = resolve("model", model_type)   # raises on an unknown
        model_params = dict(config.get("model_params", {}))
        if params is None:
            ckpt = checkpoint or find_latest_checkpoint(expdir)
            if ckpt is None:
                raise FileNotFoundError(f"no checkpoint under {expdir}")
            params, model_params = load_checkpoint_params(ckpt, model_params,
                                                          model_cls)
        if n_timesteps is None:
            n_timesteps = int(config.get("inference_n_timesteps", 10))
        if solver is None:
            solver = str(config.get("inference_solver", "euler"))
        extra = {}
        if contentvec_ckpt:
            from serenade_tpu_torch.configs import CONTENTVEC_CONFIG

            extra = dict(contentvec_config=CONTENTVEC_CONFIG,
                         contentvec_params=contentvec_ckpt)
        conv = cls(model_params, params, load_stats(stats),
                   n_timesteps=n_timesteps, solver=solver,
                   temperature=temperature, seed=seed, device=device,
                   model_type=model_type, quantize=quantize,
                   data_mesh=data_mesh, **extra)
        conv.config = dict(FEATURE_CONFIG, **config)
        conv.vocoder = vocoder_from_section(config.get("vocoder"),
                                            conv.scaler["logmel"],
                                            device=conv.device)
        return conv

    @contextlib.contextmanager
    def weights(self):
        """The model with every weight in place, for one conversion.  In
        ``"int8"`` mode the int8 weights are dequantized (each into the
        dtype its layer computes in, the values casting the f32 result at
        use gives) and bound for the duration, so the ODE's steps share
        one dequantization; conversions from several threads take turns
        binding them."""
        if not self._qweights:
            yield self.model
            return
        with self._weights_lock, torch.no_grad():
            dequantized = {name: qt.dequantize().to(dtype)
                           for name, (qt, dtype) in self._qweights.items()}
            with bound_parameters(self.model, dequantized) as model:
                yield model

    @property
    def output_sample_rate(self) -> Optional[int]:
        return self.vocoder.sampling_rate if self.vocoder else None

    def _normalize_src(self, feats: Mapping[str, np.ndarray]):
        s = self.scaler

        def minmax(x, st):
            return (x - st["min"]) / (st["max"] - st["min"])

        hub = feats["hubert"]
        mean, scale = (self._hubert_stats if torch.is_tensor(hub) else
                       (s["hubert"]["mean"], s["hubert"]["scale"]))
        out = {"hubert": (hub - mean) / scale,
               "score": minmax(feats["score"], s["score"]),
               "loud": minmax(feats["loud"], s["loud"])}
        if self.variant_new:
            out["f0_fluc"] = feats["f0_fluc"]   # unscaled, as dumped
        return out

    def _normalize_ref(self, feats: Mapping[str, np.ndarray]):
        out = self._normalize_src(feats)
        s = self.scaler["logmel"]
        out["logmel"] = (feats["logmel"] - s["mean"]) / s["scale"]
        return out

    def _stack(self, feats_list, keys, T: int) -> Dict[str, torch.Tensor]:
        """Normalized feature dicts -> ``(B, T, C)`` tensors on the device,
        zero-padded to ``T``, and their ``lengths``.  A feature that is
        already a tensor on the device (extracted content features) is
        padded and stacked there."""
        def pad(a):
            a = np.asarray(a, np.float32)
            if a.ndim == 1:
                a = a[:, None]
            return pad_to(a, T)

        def pad_dev(a):
            if not torch.is_tensor(a):
                a = upload(pad(a), self.device)
            a = a[:T]
            return torch.nn.functional.pad(a, (0, 0, 0, T - a.shape[0]))

        out = {}
        for k in keys:
            vals = [f[k] for f in feats_list]
            if any(torch.is_tensor(v) for v in vals):
                out[k] = torch.stack([pad_dev(v) for v in vals])
            else:
                out[k] = upload(np.stack([pad(v) for v in vals]),
                                self.device)
        out["lengths"] = upload(np.asarray(
            [f["hubert"].shape[0] for f in feats_list], np.int32),
            self.device)
        return out

    def draw_noise(self, b: int, t: int) -> torch.Tensor:
        """The next ``(b, t, mels)`` draw of the Converter's generator on
        its device, scaled by the temperature: the ``x0`` a conversion
        given none starts from."""
        with self._noise_lock:
            x0 = torch.randn((b, t, self.model.output_dim),
                             generator=self.generator, dtype=torch.float32,
                             device=self.device)
        return x0 * self.temperature

    def draw_shifts(self, ts: int) -> torch.Tensor:
        """The variant's next two time shifts from the Converter's
        generator, in ``[0, max(ts, 1))`` for a source bucket of ``ts``
        frames: a ``(2,)`` int64 tensor on the device (no host sync), the
        ``shifts`` a conversion given none rolls by."""
        from serenade_tpu_torch.models.serenade_new import draw_shifts

        with self._noise_lock:
            return draw_shifts(ts, self.generator, self.device)

    def _infer(self, src, ref, x0, shifts=None) -> torch.Tensor:
        """``Serenade.inference`` from the noise ``x0`` (already scaled by
        the temperature; an array or a tensor), drawn here when None; the
        variant's ``shifts`` likewise."""
        b, ts, _ = src["hubert"].shape
        t = ref["hubert"].shape[1] + ts
        if x0 is None:
            x0 = self.draw_noise(b, t)
        elif torch.is_tensor(x0):
            x0 = x0.to(self.device, torch.float32)
        else:
            x0 = upload(x0, self.device, np.float32)
        args = [src["hubert"], src["lengths"], src["score"], src["loud"]]
        ref_args = [ref["hubert"], ref["lengths"], ref["logmel"],
                    ref["score"], ref["loud"]]
        extra = {}
        if self.variant_new:
            args.append(src["f0_fluc"])
            ref_args.append(ref["f0_fluc"])
            extra["shifts"] = (self.draw_shifts(ts) if shifts is None
                               else shifts)
        kwargs = dict(n_timesteps=self.n_timesteps,
                      temperature=self.temperature, solver=self.solver)
        with self.weights() as model:
            if self.mesh is None:
                return model.inference(*args, *ref_args, x0=x0, **kwargs,
                                       **extra)
            # each replica converts its rows on its device
            n = self.mesh.size
            devices = self.mesh.devices.reshape(-1)
            rows = [split_rows(a, n) for a in args + ref_args + [x0]]

            def one(i, _):
                dev = devices[i]
                replica = (model if self._replicas[i] is self.model
                           else self._replicas[i])
                mine = [r[i].to(dev) for r in rows]
                return replica.inference(
                    *mine[:-1], x0=mine[-1], **kwargs,
                    **{k: v.to(dev) for k, v in extra.items()})

            return torch.cat([m.to(self.device) for m in run_replicas(
                self.mesh, one, range(n))])

    def convert_features(self, src_feats: Mapping[str, np.ndarray],
                         ref_feats: Mapping[str, np.ndarray],
                         x0: Optional[np.ndarray] = None, shifts=None
                         ) -> Tuple[np.ndarray, Optional[np.ndarray],
                                    Optional[int]]:
        """Conversion from extracted, un-normalized features.

        src_feats needs hubert/score/loud; ref_feats additionally logmel;
        both ``f0_fluc`` for the variant.  ``x0`` ``(1, T_ref_bucket +
        T_src_bucket, mels)`` replaces the noise draw (already scaled by
        the temperature), ``shifts`` (two ints or a ``(2,)`` tensor) the
        variant's shift draw.

        Returns (mel ``(t_src, mels)``, waveform or None, rate or None).
        """
        mel, (t_src,) = self.convert_features_batch(
            [src_feats], [ref_feats], x0=x0, shifts=shifts,
            return_device=True)
        mel = mel[:, :t_src]
        if self.vocoder is None:
            return mel[0].cpu().numpy(), None, None
        wav = self.vocoder.synthesize(mel)[0]
        return (mel[0].cpu().numpy(), wav.cpu().numpy(),
                self.vocoder.sampling_rate)

    def pack_reference(self, ref_feats: Mapping[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
        """One reference normalized, padded to its bucket and placed on the
        device (batch dim 1).  ``convert_features_batch(packed_ref=...)``
        takes it again and again with no upload: a registered style."""
        ref = self._normalize_ref(ref_feats)
        return self._stack([ref], self._ref_keys,
                           bucket_length(ref["hubert"].shape[0]))

    def convert_features_batch(self, src_list, ref_list=None,
                               ts: Optional[int] = None,
                               tr: Optional[int] = None, packed_ref=None,
                               pad_batch_pow2: bool = False,
                               return_device: bool = False,
                               x0: Optional[np.ndarray] = None,
                               shifts=None):
        """Batched conversion: N (src, ref) pairs padded to shared
        ``(ts, tr)`` buckets (the largest of the requests' where not
        given) in one ``Serenade.inference``.  Pass either one reference a
        request in ``ref_list`` or one ``packed_ref`` from
        :meth:`pack_reference` for the whole batch.

        ``pad_batch_pow2`` pads the batch to the next power of two by
        repeating the last request (serving: a few batch shapes per bucket
        pair); a data mesh pads it on to a multiple of its replicas.  ``x0`` ``(B_padded, tr + ts, mels)`` replaces the noise
        draw and ``shifts`` the variant's shift draw, as in
        :meth:`convert_features`.

        Returns the N mels trimmed to their lengths, or with
        ``return_device`` the ``(B_padded, ts, mels)`` tensor on the device
        and the N lengths.
        """
        b = len(src_list)
        target = next_pow2(b) if pad_batch_pow2 else b
        if self.mesh is not None:   # every replica needs rows
            target += (-target) % self.mesh.size
        pad = target - b
        src_list = list(src_list) + [src_list[-1]] * pad
        ts = ts or max(bucket_length(f["hubert"].shape[0]) for f in src_list)
        src = self._stack([self._normalize_src(f) for f in src_list],
                          self._src_keys, ts)
        if packed_ref is not None:
            # a real tile: the kernels' wrappers take contiguous operands,
            # and expand() alone would hand them a batch stride of 0
            ref = {k: v.expand(b + pad, *v.shape[1:]).contiguous()
                   for k, v in packed_ref.items()}
        else:
            ref_list = list(ref_list) + [ref_list[-1]] * pad
            tr = tr or max(bucket_length(f["hubert"].shape[0])
                           for f in ref_list)
            ref = self._stack([self._normalize_ref(f) for f in ref_list],
                              self._ref_keys, tr)
        mels = self._infer(src, ref, x0, shifts)
        lens = [f["hubert"].shape[0] for f in src_list[:b]]
        if return_device:
            return mels, lens
        host = mels.cpu().numpy()
        return [host[i, :n] for i, n in enumerate(lens)]

    # -- raw audio --------------------------------------------------------

    def _require_content_fn(self):
        if self._content_fn is None:
            raise RuntimeError(
                "raw-audio conversion needs ContentVec: construct the "
                "Converter with contentvec_config (and contentvec_params); "
                "use convert_features with extracted features otherwise")

    def extract_from_wav(self, wav: np.ndarray, sr: int, name: str = "utt",
                         f0_range: Optional[Tuple[float, float]] = None
                         ) -> Dict[str, np.ndarray]:
        """Features of one waveform (log-mel, loudness, F0, ContentVec and
        the estimated score as ``score``), in the dict form every
        ``convert_*`` method takes.  ``f0_range=(minf0, maxf0)`` narrows
        the F0 search to the singer's range (default 70-1100 Hz).  The
        variant's features carry ``f0_fluc``."""
        self._require_content_fn()
        f = extract_features(name, np.asarray(wav), sr,
                             FeatureConfig.from_dict(self.config),
                             content_fn=self._content_fn, f0_range=f0_range,
                             with_f0_fluc=self.variant_new,
                             device=self.device)
        if f is None:
            raise ValueError(f"feature extraction failed for {name}")
        f["score"] = f["est_lf0_score"]
        return f

    def extract_from_wav_batch(self, wavs, srs, f0_ranges=None) -> list:
        """Features of N waveforms, batched: one signal pass per length
        bucket and F0 range, one ContentVec forward per 2 s bucket, PCM16
        uploads with the 24 -> 16 kHz resample on the device.  A list of
        feature dicts (None where extraction failed); ``hubert`` stays on
        the device, a tensor, for the conversion to take there."""
        self._require_content_fn()
        names = [f"req{i}" for i in range(len(wavs))]
        feats = extract_features_batch(
            [(n, np.asarray(w), sr, None)
             for n, w, sr in zip(names, wavs, srs)],
            FeatureConfig.from_dict(self.config),
            content_fn=self._content_fn, with_f0_fluc=self.variant_new,
            pad_group_pow2=True, wire_dtype="int16", f0_ranges=f0_ranges,
            device=self.device)
        out = []
        for n in names:
            f = feats.get(n)
            if f is not None:
                f["score"] = f["est_lf0_score"]
            out.append(f)
        return out

    def convert_wav(self, src_wav: np.ndarray, ref_wav: np.ndarray, sr: int,
                    x0: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, Optional[np.ndarray],
                               Optional[int]]:
        """Raw-audio conversion: features extracted from both waveforms,
        then :meth:`convert_features` (``x0`` as there)."""
        return self.convert_features(
            self.extract_from_wav(src_wav, sr, "src"),
            self.extract_from_wav(ref_wav, sr, "ref"), x0=x0)

    def style_embedding(self, wav: Optional[np.ndarray] = None,
                        sr: Optional[int] = None,
                        logmel: Optional[np.ndarray] = None) -> np.ndarray:
        """GST style embedding ``(embed_dim,)`` of a waveform or of an
        un-normalized ``(T, num_mels)`` log-mel: the model's own measure of
        singing style."""
        from serenade_tpu_torch.ops.mel import logmelfilterbank
        from serenade_tpu_torch.utils.audio import resample, to_mono

        if logmel is None:
            fc = FeatureConfig.from_dict(self.config)
            wav = to_mono(np.asarray(wav, np.float32))
            if sr is not None and sr != fc.sampling_rate:
                wav = resample(wav, sr, fc.sampling_rate)
            with torch.no_grad():
                logmel = logmelfilterbank(
                    upload(wav, self.device), fc.sampling_rate,
                    fft_size=fc.fft_size, hop_size=fc.hop_size,
                    win_length=fc.win_length, num_mels=fc.num_mels,
                    fmin=fc.fmin, fmax=fc.fmax, eps=fc.eps,
                    log_base=fc.log_base).cpu().numpy()
        s = self.scaler["logmel"]
        mel_n = (np.asarray(logmel) - s["mean"]) / s["scale"]
        t = mel_n.shape[0]
        mel = upload(pad_to(mel_n.astype(np.float32), bucket_length(t))[None],
                     self.device)
        with torch.no_grad(), self.weights() as model:
            emb = model.gst(mel, upload(np.asarray([t]), self.device))
        return emb[0].float().cpu().numpy()

    # -- long-form and streaming -----------------------------------------

    def convert_features_long(self, src_feats: Mapping[str, np.ndarray],
                              ref_feats, chunk_frames: int = 2048,
                              overlap_frames: int = 256):
        """Long-form conversion: overlapped chunks crossfaded into one mel
        (sources may exceed the 3000-frame training cap).  ``ref_feats``
        is a feature dict or a :meth:`pack_reference` handle.  Returns
        (mel, waveform or None, rate or None)."""
        mel = convert_in_chunks(self._source_frame_feats(src_feats),
                                self._chunk_converter(ref_feats),
                                chunk_frames=chunk_frames,
                                overlap_frames=overlap_frames)
        if self.vocoder is None:
            return mel, None, None
        return (mel,) + self.vocoder.decode(mel)

    def convert_features_stream(self, src_feats: Mapping[str, np.ndarray],
                                ref_feats, chunk_frames: int = 2048,
                                overlap_frames: int = 256,
                                vocoder_context_frames: int = 32):
        """Streaming long-form conversion: yields ``(start_frame,
        mel_segment, wav_segment or None)`` as each region finalizes, the
        first after one chunk.  The waveform's rate is
        :attr:`output_sample_rate`, known before iteration.  Each region
        is vocoded with ``vocoder_context_frames`` of final left context
        (synthesized again and cut off), so the generator's receptive
        field sees real history at the joins."""
        yield from self._vocode_segments(
            convert_in_chunks_stream(
                self._source_frame_feats(src_feats),
                self._chunk_converter(ref_feats),
                chunk_frames=chunk_frames, overlap_frames=overlap_frames),
            vocoder_context_frames)

    def convert_wav_stream(self, src_wav: np.ndarray, sr: int, ref_feats,
                           chunk_frames: int = 2048, overlap_frames: int = 256,
                           first_chunk_frames: int = 512,
                           extract_ctx_frames: int = 256,
                           vocoder_context_frames: int = 32,
                           f0_range: Optional[Tuple[float, float]] = None):
        """Streaming long-form conversion from raw audio, extracted window
        by window: yields as :meth:`convert_features_stream` does, but the
        features (signal features and ContentVec) are extracted for each
        chunk from a context-padded window, so the first audio waits for
        one window's extraction, not the whole source's.  The next window
        is extracted on a worker thread while the current chunk converts,
        and the chunks ramp from ``first_chunk_frames`` up to
        ``chunk_frames``.

        The worker runs on the caller's CUDA stream with gradients off, so
        the ContentVec output it leaves on the device is ordered before
        the conversion that reads it."""
        self._require_content_fn()
        fc = FeatureConfig.from_dict(self.config)
        audio = _prepare_audio("stream_src", src_wav, sr, fc)
        spans = split_chunks_ramp(stream_total_frames(len(audio), fc),
                                  chunk_frames, overlap_frames,
                                  first_chunk_frames)
        convert_chunk = self._chunk_converter(ref_feats)
        minf0, maxf0 = f0_range or (70.0, 1100.0)

        def mels():
            # the worker enters this thread's CUDA stream, with gradients
            # off: both are per thread in PyTorch
            stream = (torch.cuda.current_stream(self.device)
                      if self.device.type == "cuda" else None)

            def extract(span):
                with torch.no_grad(), (
                        contextlib.nullcontext() if stream is None
                        else torch.cuda.stream(stream)):
                    return extract_stream_window(
                        audio, span, fc, minf0, maxf0,
                        content_fn=self._content_fn,
                        ctx_frames=extract_ctx_frames,
                        with_f0_fluc=self.variant_new, device=self.device)

            # one window ahead: window i+1 is extracted while chunk i
            # converts and its mel comes down
            with ThreadPoolExecutor(max_workers=1) as ex:
                fut = ex.submit(extract, spans[0])
                for i in range(len(spans)):
                    feats = fut.result()
                    if i + 1 < len(spans):
                        fut = ex.submit(extract, spans[i + 1])
                    yield convert_chunk(feats)

        yield from self._vocode_segments(stitch_mel_stream(spans, mels()),
                                         vocoder_context_frames)

    def convert_wav_stream_live(self, audio_chunks, sr: int, ref_feats,
                                chunk_frames: int = 64,
                                overlap_frames: int = 16,
                                extract_ctx_frames: int = 32,
                                vocoder_context_frames: int = 32,
                                f0_range: Optional[Tuple[float,
                                                         float]] = None):
        """Live streaming: consume an iterator of waveform pieces as they
        arrive (a microphone, a chunked upload) and yield ``(start_frame,
        mel_segment, wav_segment or None)`` while the source is still
        being produced.

        A span converts once ``chunk_frames + extract_ctx_frames`` frames
        of audio past its start have arrived, so the output trails the
        input by about ``(chunk + ctx + overlap) x 10 ms`` plus the
        compute.  Fed the whole waveform as one piece, it yields what
        :meth:`convert_wav_stream` yields with a uniform (unramped)
        schedule.  The pieces must be at the model's rate already; each
        is validated as it arrives, so a bad piece faults the stream at
        once.  Memory stays bounded: audio no span reads again is
        dropped as the stream advances."""
        self._require_content_fn()
        fc = FeatureConfig.from_dict(self.config)
        if sr != fc.sampling_rate:
            raise ValueError(
                f"live streaming needs {fc.sampling_rate} Hz audio, got "
                f"{sr}; resample the pieces before sending them")
        convert_chunk = self._chunk_converter(ref_feats)
        minf0, maxf0 = f0_range or (70.0, 1100.0)
        hop = fc.hop_size

        def extract(audio, span):
            return extract_stream_window(
                audio, span, fc, minf0, maxf0, content_fn=self._content_fn,
                ctx_frames=extract_ctx_frames,
                with_f0_fluc=self.variant_new, device=self.device)

        def segments():
            stitcher = StreamStitcher()
            it = iter(audio_chunks)
            buf = np.zeros(0, np.float32)
            # base: the absolute frame of buf[0].  Samples left of
            # s - ctx are read by no later span and are dropped, so an
            # endless source runs in bounded memory (and each piece's
            # concatenate copies a window, not the whole session)
            s, base, done = 0, 0, False
            while True:
                new_base = max(base, s - extract_ctx_frames)
                if new_base > base:
                    buf = buf[(new_base - base) * hop:]
                    base = new_base
                e = s + chunk_frames
                # audio for the span, its right context and the content
                # and STFT tails
                need = (e - base + extract_ctx_frames) * hop + fc.fft_size
                while not done and len(buf) < need:
                    try:
                        piece = validate_waveform(next(it), "live chunk")
                    except StopIteration:
                        done = True
                        break
                    buf = np.concatenate([buf, np.asarray(piece,
                                                          np.float32)])
                if done:
                    break
                mel = convert_chunk(extract(buf, (s - base, e - base)))
                yield from stitcher.add((s, e), mel,
                                        next_start=e - overlap_frames)
                s = e - overlap_frames
            # the source ended: the reflect pad _prepare_audio gives a
            # file, then the remaining spans
            if base == 0 and len(buf) < fc.fft_size:
                raise ValueError(
                    f"live stream ended after {len(buf)} samples: too "
                    "short to analyze")
            audio = np.pad(buf, (0, fc.fft_size), mode="reflect")
            n = stream_total_frames(base * hop + len(audio), fc)
            if n <= s:
                return
            while s < n:
                e = min(s + chunk_frames, n)
                mel = convert_chunk(extract(audio, (s - base, e - base)))
                last = e >= n
                yield from stitcher.add(
                    (s, e), mel,
                    next_start=None if last else e - overlap_frames)
                if last:
                    return
                s = e - overlap_frames

        yield from self._vocode_segments(segments(), vocoder_context_frames)

    def _vocode_segments(self, segments, vocoder_context_frames: int):
        """(start, mel_seg) stream -> (start, mel_seg, wav_seg or None):
        each finalized region is vocoded with ``vocoder_context_frames``
        of already-final left context (synthesized again and cut off) so
        the generator's receptive field sees real history at the joins."""
        mel_tail = None  # the last ctx frames of the mel already yielded
        for start, seg in segments:
            wav_seg = None
            if self.vocoder is not None:
                ctx = 0 if mel_tail is None else mel_tail.shape[0]
                mel_in = seg if ctx == 0 else np.concatenate(
                    [mel_tail, seg], axis=0)
                wav, _ = self.vocoder.decode(mel_in)
                hop = len(wav) // mel_in.shape[0]
                wav_seg = wav[ctx * hop:]
            # seg[-0:] is the whole segment, not "no context"
            mel_tail = (seg[-vocoder_context_frames:]
                        if vocoder_context_frames > 0 else None)
            yield start, seg, wav_seg

    def _source_frame_feats(self, src_feats):
        """The frame-aligned source streams the long-form paths chunk.
        Tensors (content features extracted on the device) stay there:
        the chunker only slices them."""
        return {k: src_feats[k] if torch.is_tensor(src_feats[k])
                else np.asarray(src_feats[k]) for k in self._src_keys}

    def _chunk_converter(self, ref_feats):
        """A per-chunk mel converter with the reference normalized, packed
        and uploaded once (it conditions every chunk alike).  ``ref_feats``
        may be a :meth:`pack_reference` handle already on the device (a
        server's registered style): it has ``lengths``, which no feature
        dict has.  One noise draw a chunk."""
        ref_packed = (ref_feats if "lengths" in ref_feats
                      else self.pack_reference(ref_feats))

        def convert_chunk(chunk):
            return self.convert_features_batch([chunk],
                                               packed_ref=ref_packed)[0]

        return convert_chunk
