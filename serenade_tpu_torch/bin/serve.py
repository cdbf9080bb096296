"""The port's conversion server (counterpart of serenade_tpu/bin/serve.py).

Serves request-batched conversions over HTTP on one GPU; see
``serenade_tpu_torch/serving.py`` for the dispatcher and the wire format
(npz bodies, the JAX server's keys; client helpers
``serving.encode_request`` and ``serving.decode_response``)::

    python -m serenade_tpu_torch.bin.serve --stats stats.npz \\
        --vocoder-stats vocoder_stats.npz --ref-dict styles.json \\
        --host 0.0.0.0 --port 8571 --max-batch 8 --max-wait-ms 10

The model comes from a trained experiment directory, as the JAX server
takes it (``pyyaml``, ``h5py``, and ``joblib`` for a ``stats.joblib``)::

    python -m serenade_tpu_torch.bin.serve --expdir exp/serenade \\
        --stats dump/train/stats.joblib --ref-dict styles.json

* ``--expdir``: ``config.yml`` and the latest ``checkpoint-<N>steps``
  (or ``--checkpoint``: a checkpoint directory or a reference ``.pkl``),
  and the vocoder of the config's ``vocoder:`` section
  (``Converter.from_expdir``);

or from files that need none of those packages:

* ``--model-config``: JSON of ``Serenade`` arguments (default: the recipe
  at full width, ``configs.serenade_config()``), and ``--model-type
  SerenadeNew`` for the F0-fluctuation variant;
* ``--params``: a ``.pt`` state dict of the port's ``Serenade`` (default:
  random weights from seed 0, which the server logs);
* ``--vocoder-stats`` (``mean``, ``scale``) turns the vocoder on, with
  ``--vocoder-config`` (JSON, default the recipe's HiFiGAN) and
  ``--vocoder-params`` (``.pt``, default random weights).

In both forms:

* ``--stats``: a ``stats.joblib`` of fitted scalers, or an ``.npz`` of
  the scaler arrays ``hubert_mean``, ``hubert_scale``, ``score_min``,
  ``score_max``, ``loud_min``, ``loud_max``, ``logmel_mean``,
  ``logmel_scale`` (``utils.scalers.load_stats``);
* ``--ref-dict``: JSON mapping a style name to its reference features,
  an ``.npz`` (``hubert``, ``score``, ``loud``, ``logmel``, and
  ``f0_fluc`` for the variant) or an h5 dump (its score from
  ``--score-type``), each registered on the device at start;
* ``--contentvec-ckpt`` turns on raw audio (``/convert_wav``, raw bodies
  of ``/convert_stream``, ``/convert_stream_live``): a ``.pt``
  Hugging Face ``HubertModel`` state dict (ContentVec), read with
  ``weights_only=True``;
* ``--f0-table``: JSON of per-voice-type F0 ranges for ``?voice_type=``
  (``{"Tenor": {"minf0": 130, "maxf0": 440}, ...}``; the JAX server reads
  the same table as YAML, ``conf/f0.yaml``).

``--quantize int8`` serves int8 weights dequantized once per
conversion, ``--quantize int8_compute`` runs the estimator's Dense
products int8 x int8 (``quantize.py``).  ``--data-axis N`` converts
each batch, and vocodes it, on N replicas (``cuda:0`` .. ``cuda:N-1``;
N CPU replicas with ``--device cpu``), each its own rows, as the JAX
server shards a batch over its data mesh (refused with ``--artifact``,
as there).

Endpoints: POST ``/convert_features``, ``/register_reference``,
``/convert_stream`` (feature or raw-audio bodies, a chunked stream of
npz blocks back), ``/convert_wav`` and ``/convert_stream_live`` (chunked
PCM16 in; both with ``--contentvec-ckpt``); GET ``/healthz``,
``/metrics``.  Runs on CUDA unless ``--device cpu``.

Deployment: ``--artifact DIR`` serves an exported artifact
(``bin/export.py``) with no model code, checkpoints or scaler pickles:
/convert_features and /register_reference (``--ref-dict`` registers its
styles), while /convert_wav and the stream endpoints answer 400.  The
flags an export fixes (the model, its statistics, steps, solver,
temperature, quantization) are refused beside it::

    python -m serenade_tpu_torch.bin.serve --artifact exp/export \
        --ref-dict styles.json --port 8571
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description="SSC conversion server (PyTorch)")
    p.add_argument("--artifact", default=None,
                   help="serve an exported artifact directory "
                        "(bin/export.py) instead of a live model: "
                        "/convert_features and /register_reference only")
    p.add_argument("--expdir", default=None,
                   help="trained experiment directory (config.yml and "
                        "checkpoint-<N>steps); replaces --model-config, "
                        "--params and --vocoder-*")
    p.add_argument("--checkpoint", default=None,
                   help="with --expdir: a checkpoint directory or a "
                        "reference torch .pkl (default: the latest under "
                        "--expdir)")
    p.add_argument("--model-config", default=None,
                   help="JSON of Serenade arguments (default: the recipe's "
                        "full width)")
    p.add_argument("--model-type", default="Serenade",
                   choices=("Serenade", "SerenadeNew"),
                   help="without --expdir: the model (SerenadeNew, the "
                        "F0-fluctuation variant, needs f0_fluc in every "
                        "feature request and style)")
    p.add_argument("--params", default=None,
                   help=".pt state dict of the model (default: random "
                        "weights from seed 0)")
    p.add_argument("--stats", default=None,
                   help="stats.joblib of fitted scalers, or an .npz of the "
                        "scaler arrays (<feature>_<stat>); required but "
                        "with --artifact")
    p.add_argument("--vocoder-config", default=None,
                   help="JSON vocoder config (default: the recipe's HiFiGAN)")
    p.add_argument("--vocoder-params", default=None,
                   help=".pt state dict of the generator (default: random "
                        "weights from seed 1)")
    p.add_argument("--vocoder-stats", default=None,
                   help=".npz (or stats.h5) with mean and scale; turns "
                        "the vocoder on")
    p.add_argument("--ref-dict", default=None,
                   help="JSON: style name -> .npz of reference features "
                        "or an h5 dump, each registered on the device at "
                        "start")
    p.add_argument("--score-type", default="est_lf0_score",
                   help="the h5 dataset of a --ref-dict dump's score")
    p.add_argument("--contentvec-ckpt", default=None,
                   help=".pt Hugging Face HubertModel state dict "
                        "(ContentVec, loaded with weights_only=True); turns "
                        "on /convert_wav")
    p.add_argument("--f0-table", default=None,
                   help="JSON of per-voice-type F0 ranges for "
                        "/convert_wav?voice_type=, e.g. {\"Tenor\": "
                        "{\"minf0\": 130, \"maxf0\": 440}} (JSON; the JAX "
                        "server reads it as YAML)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=10.0)
    p.add_argument("--busy-hold-ms", type=float, default=2000.0,
                   help="extra time a non-full window may stay open while "
                        "a batch is in flight, or 0 for latency-first "
                        "serving")
    p.add_argument("--max-request-seconds", type=float, default=600.0,
                   help="refuse single requests longer than this")
    p.add_argument("--data-axis", type=int, default=1,
                   help="convert each batch data-parallel over N replicas "
                        "(cuda:0 .. cuda:N-1; N replicas of the CPU with "
                        "--device cpu), the vocoder tail too")
    p.add_argument("--n-timesteps", type=int, default=None,
                   help="CFM ODE steps (default: --expdir's "
                        "inference_n_timesteps, else 10)")
    p.add_argument("--solver", default=None,
                   choices=["euler", "midpoint", "ab2"],
                   help="CFM ODE solver (default: --expdir's "
                        "inference_solver, else euler)")
    p.add_argument("--temperature", type=float, default=None,
                   help="noise temperature (default 0.667)")
    p.add_argument("--quantize", default=None,
                   choices=("int8", "int8_compute"),
                   help="int8: int8 model weights on the device, "
                        "dequantized once per conversion; int8_compute: "
                        "the estimator's Dense products run int8 x int8")
    p.add_argument("--warmup", action="append", default=[],
                   metavar="SRC:REF[:B]",
                   help="run this (src_frames, ref_frames) shape at "
                        "concurrency B (default max-batch) before taking "
                        "traffic; repeatable")
    p.add_argument("--warmup-raw", action="append", default=[],
                   metavar="SRC:REF[:B]",
                   help="as --warmup, through /convert_wav's extraction "
                        "(tones of those frame counts); needs "
                        "--contentvec-ckpt")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--verbose", type=int, default=1)
    return p


def _json(path, default):
    if path is None:
        return default
    with open(path) as f:
        return json.load(f)


def _state_dict(path, what: str, seed: int):
    """The state dict at ``path``; None (random weights from ``seed``,
    as ``Converter`` draws them) where no path is given."""
    if path is None:
        logging.warning("no %s given: using random weights from seed %d",
                        what, seed)
        return None
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def reference_features(path: str, score_type: str,
                       with_fluc: bool = False) -> dict:
    """A registered style's features from an ``.npz`` or an h5 dump, with
    its ``f0_fluc`` for the F0-fluctuation variant (``with_fluc``)."""
    keys = ("hubert", "score", "loud", "logmel") + (
        ("f0_fluc",) if with_fluc else ())
    if path.endswith(".npz"):
        with np.load(path) as z:
            missing = [k for k in keys if k not in z.files]
            if missing:
                raise SystemExit(f"--ref-dict: {path} lacks {missing}")
            return {k: z[k] for k in keys}
    from serenade_tpu_torch.utils.h5 import read_hdf5_many

    names = ("hubert", "logmel", "loud", score_type) + keys[4:]
    raw = read_hdf5_many(path, names)
    missing = [k for k, v in raw.items() if v is None]
    if missing:
        raise SystemExit(f"--ref-dict: {path} lacks {missing}")
    out = {"hubert": raw["hubert"], "logmel": raw["logmel"],
           "loud": np.asarray(raw["loud"]).reshape(-1, 1),
           "score": np.asarray(raw[score_type]).reshape(-1, 1)}
    if with_fluc:
        out["f0_fluc"] = np.asarray(raw["f0_fluc"]).reshape(-1, 1)
    return out


def _converter(args):
    """The Converter the flags describe: from ``--expdir``, or from the
    JSON, ``.pt`` and ``.npz`` files."""
    from serenade_tpu_torch import configs
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.utils.scalers import load_stats
    from serenade_tpu_torch.vocoder.vocoder import read_vocoder_stats

    if not args.stats:
        raise SystemExit("need --stats (or --artifact)")
    temperature = 0.667 if args.temperature is None else args.temperature
    if args.expdir:
        files = [flag for flag, v in (
            ("--model-config", args.model_config), ("--params", args.params),
            ("--vocoder-config", args.vocoder_config),
            ("--vocoder-params", args.vocoder_params),
            ("--vocoder-stats", args.vocoder_stats)) if v]
        if files:
            raise SystemExit(f"--expdir replaces {', '.join(files)}")
        return Converter.from_expdir(
            args.expdir, args.stats, checkpoint=args.checkpoint,
            contentvec_ckpt=args.contentvec_ckpt,
            n_timesteps=args.n_timesteps, solver=args.solver,
            temperature=temperature, device=args.device,
            quantize=args.quantize, data_mesh=args.data_axis)
    if args.checkpoint:
        raise SystemExit("--checkpoint needs --expdir")
    voc_given = args.vocoder_config or args.vocoder_params
    if voc_given and not args.vocoder_stats:
        raise SystemExit("--vocoder-config/--vocoder-params need "
                         "--vocoder-stats (the vocoder's mean and scale)")
    extra = {}
    if args.vocoder_stats:
        extra = dict(
            vocoder_config=_json(args.vocoder_config, configs.VOCODER_CONFIG),
            vocoder_params=_state_dict(args.vocoder_params, "vocoder params",
                                       1),
            vocoder_stats=read_vocoder_stats(args.vocoder_stats))
    if args.contentvec_ckpt:
        extra.update(contentvec_config=configs.CONTENTVEC_CONFIG,
                     contentvec_params=args.contentvec_ckpt)
    return Converter(
        _json(args.model_config, configs.serenade_config()),
        _state_dict(args.params, "model params", 0),
        load_stats(args.stats), n_timesteps=args.n_timesteps or 10,
        solver=args.solver or "euler", temperature=temperature,
        device=args.device, model_type=args.model_type,
        quantize=args.quantize, data_mesh=args.data_axis, **extra)


def _warmup_shapes(specs, max_batch: int, flag: str = "--warmup"):
    out = []
    for spec in specs:
        parts = spec.split(":")
        if len(parts) not in (2, 3):
            raise SystemExit(f"{flag} wants SRC:REF[:B], got {spec!r}")
        out.append((int(parts[0]), int(parts[1]),
                    int(parts[2]) if len(parts) == 3 else max_batch))
    return out


def _artifact_service(args):
    """The ArtifactService of ``--artifact``, refusing the flags an export
    fixes: silently ignoring them would serve another program than the
    one asked for."""
    from serenade_tpu_torch.deploy import ArtifactService

    fixed = {"--expdir": args.expdir, "--stats": args.stats,
             "--checkpoint": args.checkpoint,
             "--contentvec-ckpt": args.contentvec_ckpt,
             "--n-timesteps": args.n_timesteps, "--solver": args.solver,
             "--temperature": args.temperature, "--quantize": args.quantize,
             "--f0-table": args.f0_table,
             "--model-config": args.model_config, "--params": args.params,
             "--vocoder-config": args.vocoder_config,
             "--vocoder-params": args.vocoder_params,
             "--vocoder-stats": args.vocoder_stats}
    bad = [flag for flag, v in fixed.items() if v is not None]
    if args.model_type != "Serenade":
        bad.append("--model-type")
    if args.data_axis != 1:
        bad.append("--data-axis")
    if bad:
        raise SystemExit(
            f"{', '.join(bad)} cannot apply to an exported artifact (they "
            "are fixed when it is exported); export again with the desired "
            "settings or serve with --expdir")
    if args.warmup or args.warmup_raw:
        raise SystemExit("--warmup applies to a live model; an artifact's "
                         "programs are exported already")
    return ArtifactService(args.artifact,
                           max_request_seconds=args.max_request_seconds,
                           device=args.device)


def build_app(args):
    """(server, batching) from parsed args: the whole CLI but
    ``serve_forever``, so tests run the real entry path on port 0."""
    from serenade_tpu_torch.serving import (
        BatchingConverter, make_server, warmup_server,
    )

    if args.artifact:
        batching = _artifact_service(args)
        variant_new = bool(batching.manifest["variant_new"])
    else:
        if args.warmup_raw and not args.contentvec_ckpt:
            raise SystemExit("--warmup-raw needs --contentvec-ckpt")
        conv = _converter(args)
        batching = BatchingConverter(
            conv, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            busy_hold_ms=args.busy_hold_ms,
            max_request_seconds=args.max_request_seconds)
        variant_new = conv.variant_new
    try:
        for style, path in _json(args.ref_dict, {}).items():
            batching.register_reference(
                style, reference_features(path, args.score_type,
                                          variant_new))
            logging.info("registered reference style %r (%s)", style, path)
        if args.warmup:
            warmup_server(batching, _warmup_shapes(args.warmup,
                                                   args.max_batch))
        if args.warmup_raw:
            warmup_server(batching, _warmup_shapes(
                args.warmup_raw, args.max_batch, "--warmup-raw"),
                raw_audio=True)
        server = make_server(batching, host=args.host, port=args.port,
                             f0_table=_json(args.f0_table, None))
    except BaseException:
        batching.close()
        raise
    return server, batching


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s (%(module)s) %(levelname)s: %(message)s")
    server, batching = build_app(args)
    if args.artifact:
        logging.info("serving %s on %s:%d (device %s)", args.artifact,
                     args.host, server.server_address[1], batching.device)
    else:
        logging.info("serving on %s:%d (device %s, max_batch=%d, "
                     "wait=%.0fms)", args.host, server.server_address[1],
                     batching.converter.device, args.max_batch,
                     args.max_wait_ms)

    # SIGTERM drains like Ctrl-C: stop accepting, fault queued requests
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logging.info("shutting down: draining the dispatch queue")
    finally:
        server.server_close()
        batching.close()


if __name__ == "__main__":
    main()
