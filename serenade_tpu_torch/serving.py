"""Online serving: the request-batching conversion server (counterpart of
serenade_tpu/serving.py: ``BatchingConverter``, the npz wire format,
``warmup_server`` and ``make_server``).

* ``BatchingConverter`` wraps :class:`serenade_tpu_torch.api.Converter`
  with a submission queue and a dispatcher thread that groups concurrent
  requests by (source bucket, reference bucket or registered style) and
  runs each group as one batched conversion and one batched vocoder tail.
  Registered styles stay on the device.  Raw-audio requests
  (``convert_wav``) are extracted first, the whole window's waveforms in
  one batched extraction (``Converter.extract_from_wav_batch``); their
  content features stay on the device for the conversion.
* ``make_server``: a stdlib ``ThreadingHTTPServer``.  POST
  ``/convert_features`` and ``/register_reference`` with ``.npz`` bodies
  (the JAX server's keys, so a client of either works with the other),
  POST ``/convert_wav`` with a RIFF body and ``?style=<name>`` or an npz
  body (``encode_wav_request``), GET ``/healthz`` and ``/metrics``.
  POST ``/convert_stream`` (a feature npz, RIFF with ``?style=``, or an
  npz with ``src_wav``) answers a chunked stream of length-prefixed npz
  blocks as long-form regions finalize; POST ``/convert_stream_live``
  takes a chunked PCM16 upload and streams back while it arrives.  Every
  stream ends with a ``{done: 1}`` or ``{error: msg}`` block;
  ``iter_stream_blocks`` reads them.

On CUDA the dispatcher thread runs every conversion on the server's own
stream with gradients off (both are per thread in PyTorch) and only
launches work: inputs go up from pinned memory without blocking, results
come down into pinned memory, and the finisher thread waits on a CUDA
event recorded after them.  So the next window's uploads and launches
overlap this window's compute, as JAX's asynchronous dispatch lets them.
The streams bypass the queue: each runs the Converter on its handler
thread, on the same server stream with gradients off.  One stream orders
everything the threads launch, so an operand a kernel's weight cache
(``ops/_cuda.py`` ``VersionCache``) made on one thread is ready before
another thread's kernel reads it.

A request that fails (bad payload, feature mismatch) fails alone: the
dispatcher catches a batch's error and faults only that batch's requests.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import queue
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from serenade_tpu_torch.collaters.ssc import bucket_length
from serenade_tpu_torch.features import validate_waveform

logger = logging.getLogger(__name__)


def validate_feature_dict(feats, what: str, with_mel: bool,
                          content_dim: int, num_mels: int,
                          variant_new: bool = False,
                          max_frames: int | None = None) -> None:
    """The submit-time feature contract: reject a malformed dict before it
    reaches a batched dispatch, so a bad payload fails alone.
    ``variant_new`` (the F0-fluctuation variant) needs ``f0_fluc`` too.
    ``max_frames`` caps a request's duration (an over-long request pads
    every co-batched neighbour to its bucket)."""
    need = ["hubert", "score", "loud"] + (["logmel"] if with_mel else [])
    if variant_new:
        need.append("f0_fluc")
    for k in need:
        if k not in feats:
            raise ValueError(f"{what} missing feature {k!r}")
    hub = feats["hubert"]
    if not torch.is_tensor(hub):   # extracted features stay on the device
        hub = np.asarray(hub)
    if hub.ndim != 2 or hub.shape[1] != content_dim:
        raise ValueError(
            f"{what} hubert must be (T, {content_dim}); got {hub.shape}")
    if max_frames is not None and hub.shape[0] > max_frames:
        raise ValueError(
            f"{what} is {hub.shape[0]} frames, over the server's "
            f"per-request cap of {max_frames} (max_request_seconds)")
    if with_mel:
        mel = np.asarray(feats["logmel"])
        if mel.ndim != 2 or mel.shape[1] != num_mels:
            raise ValueError(
                f"{what} logmel must be (T, {num_mels}); got {mel.shape}")


def check_registry_capacity(refs, name: str, max_references: int) -> None:
    """Reference-registry cap (call under the registry lock): each
    registration pins features on the device, so an unbounded registry
    is a memory-exhaustion vector on a reachable port.  Re-registering an
    existing name is always allowed."""
    if name not in refs and len(refs) >= max_references:
        raise ValueError(
            f"reference registry full ({max_references}); "
            "re-register an existing name or raise max_references")


def check_f0_range(f0_range):
    """Validate an optional (minf0, maxf0) Hz pair at submit time (a bad
    range would fault inside a batched extraction)."""
    if f0_range is None:
        return None
    lo, hi = float(f0_range[0]), float(f0_range[1])
    if not (0.0 < lo < hi <= 4000.0):
        raise ValueError(
            f"f0_range must satisfy 0 < minf0 < maxf0 <= 4000 Hz; "
            f"got ({lo}, {hi})")
    return (lo, hi)


@dataclass
class _Request:
    src: Optional[Dict[str, np.ndarray]]
    # a feature dict (ad-hoc reference) or a registered style name
    ref: object
    # raw audio: (wav, sr), extracted by the dispatcher with its window
    raw_src: Optional[tuple] = None
    raw_ref: Optional[tuple] = None
    f0_range: Optional[tuple] = None   # (minf0, maxf0) for the extraction
    done: threading.Event = field(default_factory=threading.Event)
    mel: Optional[np.ndarray] = None
    wav: Optional[np.ndarray] = None
    sr: Optional[int] = None
    error: Optional[Exception] = None


class BatchingConverter:
    """Groups concurrent conversion requests into batched dispatches.

    Args:
        converter: a :class:`serenade_tpu_torch.api.Converter`.
        max_batch: largest group per dispatch.
        max_wait_ms: how long the dispatcher holds a non-full window open
            for stragglers; the latency floor of a lone request.
        max_references: cap on registered styles.
        busy_hold_ms: how much longer a non-full window may stay open
            while a launched batch is still in flight (waiting is free
            then: the card is busy).
        max_request_seconds: requests longer than this are refused at
            submit.
    """

    def __init__(self, converter, max_batch: int = 8,
                 max_wait_ms: float = 10.0, max_references: int = 64,
                 busy_hold_ms: float = 2000.0,
                 max_request_seconds: float = 600.0):
        self._conv = converter
        voc = converter.vocoder
        if getattr(converter, "mesh", None) is not None and voc is not None \
                and voc.mesh is None:
            # the tail runs data-parallel over the conversion's replicas
            voc.place_on_mesh(converter.mesh)
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1000.0
        self._busy_hold = busy_hold_ms / 1000.0
        self._max_references = max_references
        self.max_request_seconds = float(max_request_seconds)
        cfg = converter.config
        self._frames_per_sec = (float(cfg["sampling_rate"])
                                / float(cfg["hop_size"]))
        dev = converter.device
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._inflight = 0  # launched-but-unfinished batches (see _lock)
        self._dispatcher_done = False  # set when _dispatch_loop exits
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # compute_sec: launch to results on the host, a batch's latency;
        # launch_sec: the dispatcher's own time launching, the host cost
        # that bounds the batches a second; extract_sec: its time
        # extracting raw-audio windows (the extraction waits for the
        # device: the score needs F0 on the host)
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "audio_sec": 0.0, "compute_sec": 0.0,
                      "launch_sec": 0.0, "extract_sec": 0.0}
        self._refs: Dict[str, Dict[str, torch.Tensor]] = {}
        self._raw_refs: Dict[str, Dict[str, np.ndarray]] = {}
        # launched batches waiting for their results, bounded to keep a
        # few batches of device memory in flight (back-pressure on launch)
        self._completions: "queue.Queue" = queue.Queue(maxsize=4)
        self._finisher = threading.Thread(target=self._finish_loop,
                                          daemon=True, name="ssc-finisher")
        self._finisher.start()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True, name="ssc-dispatcher")
        self._thread.start()

    def _on_device(self):
        """Gradients off and the server's stream current, for the calling
        thread (both are per thread in PyTorch)."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        if self._stream is not None:
            stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    # -- client side ----------------------------------------------------

    def register_reference(self, name: str, ref_feats) -> None:
        """Register a named style reference.  Its normalized features are
        packed once and kept on the device; requests that pass the name
        skip the reference upload.  Capped at ``max_references`` distinct
        styles.  The copy is queued on the server's stream, ahead of any
        batch that can name the style."""
        self._validate_feats(ref_feats, "ref", with_mel=True)
        with self._on_device():
            packed = self._conv.pack_reference(ref_feats)
        raw = {k: np.asarray(v) for k, v in ref_feats.items()}
        with self._lock:  # check+insert atomic: handler threads race here
            check_registry_capacity(self._refs, name, self._max_references)
            # raw first: _refs gates availability
            self._raw_refs[name] = raw
            self._refs[name] = packed

    def reference_names(self):
        return sorted(self._refs)

    @property
    def converter(self):
        return self._conv

    def _require_style(self, name: str) -> None:
        if name not in self._refs:
            raise KeyError(f"unknown reference style {name!r}; "
                           f"registered: {self.reference_names()}")

    def raw_reference(self, name: str):
        """A registered style's feature dict as it was registered."""
        self._require_style(name)
        return self._raw_refs[name]

    def packed_reference(self, name: str):
        """A registered style's packed tensors on the device."""
        self._require_style(name)
        return self._refs[name]

    def _validate_feats(self, feats, what: str, with_mel: bool,
                        cap_duration: bool = True) -> None:
        """Reject a malformed feature dict at submit time: a payload that
        failed only inside the batched dispatch would fault every request
        batched with it.  ``cap_duration=False`` skips the
        max_request_seconds cap (a stream converts in bounded chunks, off
        the queue)."""
        sc = self._conv.scaler
        validate_feature_dict(
            feats, what, with_mel,
            content_dim=sc["hubert"]["mean"].shape[0],
            num_mels=sc["logmel"]["mean"].shape[0],
            variant_new=self._conv.variant_new,
            max_frames=(int(self.max_request_seconds * self._frames_per_sec)
                        if cap_duration else None))

    def _check_open(self) -> None:
        if self._stop.is_set():
            raise RuntimeError("server shutting down")

    def convert(self, src_feats, ref, timeout: float = 300.0):
        """Blocking submit; returns (mel, wav or None, rate or None).

        ``ref`` is a feature dict (ad-hoc) or a registered style name.
        Thread-safe: concurrent callers batch together.
        """
        self._check_open()
        try:
            self._validate_feats(src_feats, "src", with_mel=False)
            if isinstance(ref, str):
                self._require_style(ref)
            else:
                self._validate_feats(ref, "ref", with_mel=True)
        except (ValueError, KeyError):
            with self._lock:
                self.stats["errors"] += 1
            raise
        req = _Request(src=src_feats, ref=ref)
        self._queue.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("conversion timed out")
        if req.error is not None:
            raise req.error
        return req.mel, req.wav, req.sr

    def convert_wav(self, src_wav, sr: int, ref, timeout: float = 300.0,
                    f0_range=None):
        """Raw-audio submit; returns (mel, wav or None, rate or None).  The
        dispatcher extracts the features of every raw request in its window
        in one batched extraction, then converts as usual.  ``ref`` is a
        registered style name or a ``(ref_wav, ref_sr)`` tuple;
        ``f0_range=(minf0, maxf0)`` narrows the F0 search of both."""
        self._check_open()
        try:
            f0_range = check_f0_range(f0_range)
            # checked here so a malformed waveform faults alone, before it
            # joins a batched extraction
            src_wav = self._checked_wav(src_wav, sr, "src_wav")
            if isinstance(ref, str):
                self._require_style(ref)
                raw_ref = None
            else:
                raw_ref = (self._checked_wav(ref[0], ref[1], "ref_wav"),
                           ref[1])
        except (ValueError, KeyError):
            with self._lock:
                self.stats["errors"] += 1
            raise
        req = _Request(src=None, ref=ref if raw_ref is None else None,
                       raw_src=(src_wav, sr), raw_ref=raw_ref,
                       f0_range=f0_range)
        self._queue.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("conversion timed out")
        if req.error is not None:
            raise req.error
        return req.mel, req.wav, req.sr

    def _checked_wav(self, wav, sr: int, what: str) -> np.ndarray:
        wav = validate_waveform(wav, what)
        if len(wav) > self.max_request_seconds * sr:
            raise ValueError(
                f"{what} is {len(wav) / sr:.0f}s, over the server's "
                f"per-request cap of {self.max_request_seconds:.0f}s "
                "(max_request_seconds)")
        return wav

    def close(self, join_timeout: float = 5.0):
        self._stop.set()
        self._thread.join(timeout=join_timeout)
        self._finisher.join(timeout=join_timeout)
        if self._thread.is_alive() or self._finisher.is_alive():
            # a dispatch or a fetch outlived the join: fault everything
            # still queued so blocked callers fail now
            logger.warning(
                "dispatcher still busy after %.1fs; faulting queued requests",
                join_timeout)
            for q in (self._queue, self._completions):
                while True:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                    if isinstance(item, tuple):
                        reqs = item[0]
                        with self._lock:
                            self._inflight -= 1
                    else:
                        reqs = [item]
                    for req in reqs:
                        req.error = RuntimeError("server shutting down")
                        req.done.set()

    # -- dispatcher side ------------------------------------------------

    def _bucket(self, req: _Request):
        ts = bucket_length(req.src["hubert"].shape[0])
        if isinstance(req.ref, str):
            return (ts, req.ref)
        return (ts, bucket_length(req.ref["hubert"].shape[0]))

    def _dispatch_loop(self):
        with self._on_device():
            self._dispatch()

    def _dispatch(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            pending = [first]
            deadline = time.monotonic() + self._max_wait
            # while a launched batch is in flight waiting costs nothing:
            # hold the window past max_wait for a fuller batch, capped by
            # busy_hold
            hard_deadline = deadline + self._busy_hold
            while len(pending) < self._max_batch:
                if self._stop.is_set():
                    break
                now = time.monotonic()
                if now >= deadline:
                    with self._lock:
                        busy = self._inflight > 0
                    if not busy or now >= hard_deadline:
                        break
                    timeout = min(0.005, hard_deadline - now)
                else:
                    timeout = deadline - now
                try:
                    pending.append(self._queue.get(timeout=timeout))
                except queue.Empty:
                    pass
            pending = self._materialize_raw(pending)
            groups = defaultdict(list)
            for req in pending:
                try:
                    key = self._bucket(req)
                except Exception as e:  # noqa: BLE001 — malformed request
                    req.error = e
                    req.done.set()
                    with self._lock:
                        self.stats["errors"] += 1
                    continue
                groups[key].append(req)
            for (ts, tr), reqs in groups.items():
                self._run_group(reqs, ts, tr)
        # shutdown: fault anything still queued
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.error = RuntimeError("server shutting down")
            req.done.set()
        # everything this thread will launch is now in _completions
        self._dispatcher_done = True

    def _materialize_raw(self, pending):
        """Extract the features of the window's raw-audio requests in one
        batched extraction; a request whose extraction fails faults alone,
        and if the extraction itself fails, the raw requests fault and the
        others go on."""
        raws = [r for r in pending if r.raw_src is not None]
        if not raws:
            return pending
        t0 = time.monotonic()
        wavs, srs, owners, ranges = [], [], [], []
        for r in raws:
            for slot, raw in (("src", r.raw_src), ("ref", r.raw_ref)):
                if raw is not None:
                    wavs.append(raw[0])
                    srs.append(raw[1])
                    owners.append((r, slot))
                    ranges.append(r.f0_range)
        try:
            feats = self._conv.extract_from_wav_batch(wavs, srs,
                                                      f0_ranges=ranges)
        except Exception as e:  # noqa: BLE001 — fault the raw subset
            logger.exception("raw-audio extraction failed for %d requests",
                             len(raws))
            feats = [None] * len(wavs)
            for r in raws:
                r.error = e
        for (r, slot), f in zip(owners, feats):
            if r.error is not None:
                continue
            if f is None:
                r.error = ValueError(f"feature extraction failed ({slot})")
            elif slot == "src":
                r.src = f
            else:
                r.ref = f
        out = []
        for r in pending:
            if r.error is None:
                out.append(r)
                continue
            with self._lock:
                self.stats["errors"] += 1
            r.done.set()
        with self._lock:
            self.stats["extract_sec"] += time.monotonic() - t0
        return out

    def _fetch(self, tensors: Dict[str, torch.Tensor]):
        """Results on the device -> host tensors and the event to wait on
        before reading them (None on the CPU, where they are ready)."""
        if self._stream is None:
            return tensors, None
        host = {}
        for k, t in tensors.items():
            host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host[k].copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._stream)
        return host, done

    def _run_group(self, reqs, ts: int, tr):
        """Launch a group's conversion and vocoder tail and hand the wait
        for its results to the finisher thread."""
        try:
            t0 = time.monotonic()
            # pow2 batch padding: a few batch shapes per bucket pair
            common = dict(ts=ts, pad_batch_pow2=True, return_device=True)
            if isinstance(tr, str):  # registered style: on the device
                mels, lens = self._conv.convert_features_batch(
                    [r.src for r in reqs], packed_ref=self._refs[tr],
                    **common)
            else:
                mels, lens = self._conv.convert_features_batch(
                    [r.src for r in reqs], [r.ref for r in reqs], tr=tr,
                    **common)
            b, bp = len(reqs), mels.shape[0]
            voc = self._conv.vocoder
            out = {"mel": mels[:b]}
            if voc is not None:
                # the tail on the device: the mel is never re-uploaded and
                # the waveform comes down as PCM16, half the bytes
                out["wav"] = voc.decode_batch_device(
                    mels, lens + [lens[-1]] * (bp - b))[:b]
            host, done = self._fetch(out)
            with self._lock:
                self.stats["launch_sec"] += time.monotonic() - t0
        except Exception as e:  # noqa: BLE001 — fault the batch, not the server
            logger.exception("batch of %d failed at launch", len(reqs))
            with self._lock:
                self.stats["errors"] += len(reqs)
            for r in reqs:
                r.error = e
                r.done.set()
            return

        def finish():
            if done is not None:
                done.synchronize()
            mel = host["mel"].numpy()
            wav = host["wav"].numpy() if "wav" in host else None
            for i, r in enumerate(reqs):
                r.mel = np.array(mel[i, : lens[i]])
                if wav is not None:
                    hop = wav.shape[1] // mels.shape[1]
                    r.wav = (wav[i, : lens[i] * hop].astype(np.float32)
                             / 32767.0)
                    r.sr = voc.sampling_rate
            # overlapped batches count their shared time twice
            compute = time.monotonic() - t0
            frame_sec = float(self._conv.config["shiftms"]) / 1000.0
            with self._lock:
                self.stats["requests"] += b
                self.stats["batches"] += 1
                self.stats["compute_sec"] += compute
                self.stats["audio_sec"] += sum(lens) * frame_sec

        with self._lock:
            self._inflight += 1
        self._completions.put((reqs, finish))

    def _finish_loop(self):
        """Wait for launched batches and hand their results to the
        callers.  A failure faults its batch only.  On shutdown whatever
        was launched still completes; the thread exits once the
        dispatcher has exited and nothing is in flight."""
        while True:
            with self._lock:
                drained = self._inflight == 0
            if (self._stop.is_set() and self._dispatcher_done and drained
                    and self._completions.empty()):
                break
            try:
                reqs, finish = self._completions.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                finish()
            except Exception as e:  # noqa: BLE001 — fault the batch only
                logger.exception("batch of %d failed at fetch", len(reqs))
                with self._lock:
                    self.stats["errors"] += len(reqs)
                for r in reqs:
                    r.error = e
            finally:
                # decrement before waking callers: a woken client
                # resubmits at once, and a stale busy flag would hold its
                # window against an idle pipeline
                with self._lock:
                    self._inflight -= 1
                for r in reqs:
                    r.done.set()


# ---------------------------------------------------------------------------
# the wire format (keys as serenade_tpu/serving.py writes and reads them)
# ---------------------------------------------------------------------------

# seconds a refused live upload may sit idle while it is read off
_DRAIN_IDLE_S = 5.0

_SRC_KEYS = ("hubert", "score", "loud")
_REF_KEYS = _SRC_KEYS + ("logmel",)


class _PayloadTooLarge(ValueError):
    """POST body exceeds the server's max_body_bytes cap (HTTP 413)."""


class _UnreadBody(ValueError):
    """Request body cannot be consumed on this endpoint (HTTP 411)."""


def _ref_from_npz(z) -> dict:
    ref = {k: z[f"ref_{k}"] for k in _REF_KEYS}
    if "ref_f0_fluc" in z.files:
        ref["f0_fluc"] = z["ref_f0_fluc"]
    return ref


def _feats_from_npz(z):
    src = {k: z[f"src_{k}"] for k in _SRC_KEYS}
    if "src_f0_fluc" in z.files:
        src["f0_fluc"] = z["src_f0_fluc"]
    ref = str(z["ref_name"]) if "ref_name" in z.files else _ref_from_npz(z)
    return src, ref


def _parse_npz(body: bytes):
    with np.load(io.BytesIO(body)) as z:
        return _feats_from_npz(z)


def _parse_ref_npz(body: bytes):
    with np.load(io.BytesIO(body)) as z:
        return _ref_from_npz(z)


def _encode_feats(prefix: str, feats, keys) -> dict:
    arrays = {f"{prefix}_{k}": np.asarray(feats[k]) for k in keys}
    if "f0_fluc" in feats:
        arrays[f"{prefix}_f0_fluc"] = np.asarray(feats["f0_fluc"])
    return arrays


def encode_request(src_feats, ref) -> bytes:
    """Client-side helper: the POST body of /convert_features.  ``ref`` is
    a feature dict or a registered style name."""
    buf = io.BytesIO()
    arrays = _encode_feats("src", src_feats, _SRC_KEYS)
    if isinstance(ref, str):
        arrays["ref_name"] = np.asarray(ref)
    else:
        arrays.update(_encode_feats("ref", ref, _REF_KEYS))
    np.savez(buf, **arrays)
    return buf.getvalue()


def encode_reference(ref_feats) -> bytes:
    """Client-side helper: body for POST /register_reference?name=<style>."""
    buf = io.BytesIO()
    np.savez(buf, **_encode_feats("ref", ref_feats, _REF_KEYS))
    return buf.getvalue()


def decode_response(body: bytes):
    """Client-side helper: unpack a /convert_features response."""
    with np.load(io.BytesIO(body)) as z:
        mel = z["mel"]
        wav = z["wav"] if "wav" in z.files else None
        sr = int(z["sr"]) if "sr" in z.files else None
    return mel, wav, sr


def encode_wav_request(src_wav, sr: int, ref, f0_range=None) -> bytes:
    """Client-side helper: the npz body of POST /convert_wav.  ``ref`` is
    a registered style name or a ``(ref_wav, ref_sr)`` tuple (RIFF bytes
    with ``?style=<name>`` work too).  ``f0_range=(minf0, maxf0)`` narrows
    the F0 search, as ``?f0_min=&f0_max=`` does."""
    arrays = {"src_wav": np.asarray(src_wav, np.float32),
              "sr": np.int64(sr)}
    if isinstance(ref, str):
        arrays["ref_name"] = np.asarray(ref)
    else:
        arrays["ref_wav"] = np.asarray(ref[0], np.float32)
        arrays["ref_sr"] = np.int64(ref[1])
    if f0_range is not None:
        arrays["f0_min"] = np.float64(f0_range[0])
        arrays["f0_max"] = np.float64(f0_range[1])
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _f0_range_from(query, files=None, f0_table=None) -> Optional[tuple]:
    """(minf0, maxf0) from the npz keys ``f0_min``/``f0_max`` (which win),
    the ``?f0_min=&f0_max=`` query, or ``?voice_type=<key>`` looked up in
    the server's F0 table; None when none is given."""
    if files is not None and ("f0_min" in files.files
                              or "f0_max" in files.files):
        if not ("f0_min" in files.files and "f0_max" in files.files):
            raise ValueError("f0_min and f0_max must be given together")
        return check_f0_range((float(files["f0_min"]),
                               float(files["f0_max"])))
    lo = query.get("f0_min", [None])[0]
    hi = query.get("f0_max", [None])[0]
    if lo is None and hi is None:
        vt = query.get("voice_type", [None])[0]
        if vt is None:
            return None
        if not f0_table or vt not in f0_table:
            raise ValueError(
                f"unknown voice_type {vt!r}; the server's --f0-table "
                f"knows: {sorted(f0_table or {})}")
        row = f0_table[vt]
        return check_f0_range((float(row["minf0"]), float(row["maxf0"])))
    if lo is None or hi is None:
        raise ValueError("f0_min and f0_max must be given together")
    return check_f0_range((float(lo), float(hi)))


def _extract_or_raise(conv, wavs, srs, f0_ranges=None):
    """Batched extraction on the device (the PCM16 wire /convert_wav
    uses); an utterance whose extraction fails raises instead of
    streaming nothing."""
    feats = conv.extract_from_wav_batch(wavs, srs, f0_ranges=f0_ranges)
    for f in feats:
        if f is None:
            raise ValueError("feature extraction failed for stream audio")
    return feats


class _RawSource:
    """A /convert_stream source that arrived as raw audio.  The handler
    streams it through windowed extraction (``Converter.
    convert_wav_stream``), so the first audio waits for one window's
    extraction, not the whole utterance's; ``?windowed=0`` extracts the
    whole source first and runs ``convert_features_stream``."""

    def __init__(self, wav, sr: int):
        self.wav = wav
        self.sr = int(sr)


def _parse_stream_body(body: bytes, query, batching, f0_table=None):
    """/convert_stream input: extracted features (npz ``src_*`` with
    ``ref_*`` or ``ref_name``), raw audio (RIFF bytes with ``?style=``,
    or an npz with ``src_wav``/``sr`` and ``ref_name`` or
    ``ref_wav``/``ref_sr``), or a raw source with a feature reference
    (``src_wav`` with ``ref_*`` arrays).  A raw source comes back as a
    :class:`_RawSource` (its extraction waits for the windowed stream); a
    raw reference is extracted here (it is short).  Raw audio needs the
    Converter's ContentVec.

    Returns ``(src, ref, f0_range)``, the F0 range from the body's npz
    keys where present, else from the query, so that a range sent with
    the audio applies to the source's extraction too.

    The source is not capped by ``max_request_seconds``: a stream converts
    in bounded chunks outside the batching queue, so no co-batched
    request pads to its bucket, and long sources are what the endpoint
    is for.  An ad-hoc raw reference, extracted in one dispatch, keeps
    the cap."""
    conv = batching.converter
    if body[:4] == b"RIFF":
        from serenade_tpu_torch.utils.audio import read_wav

        src_wav, sr = read_wav(io.BytesIO(body))
        style = query.get("style", [""])[0]
        if not style:
            raise ValueError("RIFF body needs ?style=<registered name>")
        return (_RawSource(validate_waveform(src_wav, "src_wav"), sr),
                batching.packed_reference(style),
                _f0_range_from(query, f0_table=f0_table))
    with np.load(io.BytesIO(body)) as z:
        f0_range = _f0_range_from(query, files=z, f0_table=f0_table)
        if "src_wav" not in z.files:
            src, ref = _feats_from_npz(z)
            batching._validate_feats(src, "src", with_mel=False,
                                     cap_duration=False)
            if isinstance(ref, str):
                ref = batching.packed_reference(ref)
            return src, ref, f0_range
        src_wav, sr = z["src_wav"], int(z["sr"])
        if "ref_name" in z.files:
            ref = batching.packed_reference(str(z["ref_name"]))
        elif "ref_wav" in z.files:
            ref_sr = int(z["ref_sr"])
            ref = _extract_or_raise(
                conv, [batching._checked_wav(z["ref_wav"], ref_sr,
                                             "ref_wav")],
                [ref_sr], f0_ranges=[f0_range])[0]
        else:   # a raw source with an extracted reference
            ref = _ref_from_npz(z)
    return _RawSource(validate_waveform(src_wav, "src_wav"), sr), ref, f0_range


def warmup_server(batching, shapes, raw_audio: bool = False,
                  seed: int = 0) -> None:
    """Drive synthetic requests through the dispatcher before real traffic
    (the first batch of a new shape pays for cuDNN's plans, the kernels'
    weight layouts and the allocator's first blocks).

    ``shapes``: ``(src_frames, ref_frames, concurrency)`` triples;
    concurrency B submits B requests at once so the dispatcher packs a
    B-batch window.  ``raw_audio=True`` sends tones of those lengths
    through ``convert_wav`` instead (the Converter needs ContentVec).
    Failures raise.  The stats counters are restored afterwards; call
    before taking traffic."""
    conv = batching.converter
    stats_before = dict(batching.stats)
    rng = np.random.default_rng(seed)
    content_dim = conv.scaler["hubert"]["mean"].shape[0]
    n_mels = conv.scaler["logmel"]["mean"].shape[0]

    sr, hop = int(conv.config["sampling_rate"]), int(conv.config["hop_size"])

    def feats(t: int, with_mel: bool):
        f = {"hubert": rng.normal(size=(t, content_dim)).astype(np.float32),
             "score": np.full((t, 1), 5.0, np.float32),
             "loud": (rng.normal(size=(t, 1)).astype(np.float32) - 30.0)}
        if with_mel:
            f["logmel"] = rng.normal(size=(t, n_mels)).astype(np.float32)
        if conv.variant_new:
            f["f0_fluc"] = np.zeros((t, 1), np.float32)
        return f

    def wav(t: int, f0: float):
        x = np.arange(t * hop, dtype=np.float32) / sr
        return (0.2 * np.sin(2 * np.pi * f0 * x)).astype(np.float32)

    for ts, tr, b in shapes:
        t0 = time.monotonic()
        errs = []

        def one(i):
            try:
                if raw_audio:
                    batching.convert_wav(wav(ts, 200.0 + 7 * i), sr,
                                         (wav(tr, 300.0 + 5 * i), sr))
                else:
                    batching.convert(feats(ts, False), feats(tr, True))
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(b)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errs:
            raise RuntimeError(
                f"warmup failed at shape ({ts}, {tr}, b={b})") from errs[0]
        logger.info("warmup %s (%d, %d) x%d: %.1fs",
                    "raw" if raw_audio else "features", ts, tr, b,
                    time.monotonic() - t0)
    with batching._lock:
        batching.stats.update(stats_before)


def _frame_block(arrays: dict) -> bytes:
    """One length-prefixed npz block of the /convert_stream wire."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    return len(payload).to_bytes(4, "big") + payload


def iter_stream_blocks(read):
    """Client-side helper: parse a /convert_stream or /convert_stream_live
    body (a file-like, or a callable ``read(n)``) into dicts of arrays, in
    order.

    The server ends every stream with a marker block, ``{done: 1}`` on
    success or ``{error: msg}`` after a failure mid-stream, so a cut
    stream is told apart from a complete one.  The marker is consumed,
    not yielded: on ``error`` this raises RuntimeError, and a stream that
    ends without a marker raises too."""
    read = read.read if hasattr(read, "read") else read

    def read_exact(n):
        out = b""
        while len(out) < n:
            chunk = read(n - len(out))
            if not chunk:
                return out
            out += chunk
        return out

    while True:
        head = read_exact(4)
        if len(head) < 4:
            raise RuntimeError(
                "stream ended without a terminal marker (truncated)")
        size = int.from_bytes(head, "big")
        body = read_exact(size)
        if len(body) < size:
            raise RuntimeError("stream ended mid-block (truncated)")
        with np.load(io.BytesIO(body)) as z:
            blk = {k: z[k] for k in z.files}
        if "error" in blk:
            read(1)  # read to EOF so the connection can be reused
            raise RuntimeError(f"server stream failed: {blk['error']}")
        if "done" in blk:
            # read the end of the stream, so that a file-like (a chunked
            # http.client response) sees EOF and the connection is reusable
            read(1)
            return
        yield blk


def make_server(batching: BatchingConverter, host: str = "127.0.0.1",
                port: int = 8571, max_body_bytes: int = 256 << 20,
                f0_table: Optional[dict] = None):
    """Build (not start) a ThreadingHTTPServer around a BatchingConverter.

    ``max_body_bytes`` caps every POST body (413 beyond it).
    ``f0_table`` maps a ``?voice_type=`` of /convert_wav to its F0 search
    range (``{"Tenor": {"minf0": 130, "maxf0": 440}, ...}``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            logger.debug("http: " + fmt, *args)

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _read_body(self) -> bytes:
            if self.headers.get("Content-Length") is None and (
                    "chunked" in (self.headers.get(
                        "Transfer-Encoding") or "").lower()):
                # the body would stay on the socket and desync keep-alive
                raise _UnreadBody("endpoint requires Content-Length")
            n = int(self.headers.get("Content-Length", "0"))
            if n > max_body_bytes:
                raise _PayloadTooLarge(
                    f"body of {n} bytes exceeds the server cap of "
                    f"{max_body_bytes}")
            return self.rfile.read(n)

        def _fault(self, e: Exception):
            code = (413 if isinstance(e, _PayloadTooLarge)
                    else 411 if isinstance(e, _UnreadBody) else 400)
            if code != 400:
                # the body was never read off the socket: the next request
                # on this connection would start mid-body
                self.close_connection = True
            return self._send_json(code, {"error": str(e)})

        def do_GET(self):
            s = dict(batching.stats)
            rtf = (s["compute_sec"] / s["audio_sec"]
                   if s["audio_sec"] else None)
            if self.path == "/metrics":
                # Prometheus text exposition of the /healthz counters
                lines = []
                for name, kind, val, help_ in (
                    ("requests_total", "counter", s["requests"],
                     "Completed conversion requests."),
                    ("batches_total", "counter", s["batches"],
                     "Device dispatch windows executed."),
                    ("errors_total", "counter", s["errors"],
                     "Requests that faulted."),
                    ("audio_seconds_total", "counter", s["audio_sec"],
                     "Audio-seconds converted."),
                    ("compute_seconds_total", "counter", s["compute_sec"],
                     "Launch-to-result seconds spent."),
                    ("launch_seconds_total", "counter", s["launch_sec"],
                     "Seconds the dispatcher spent launching batches."),
                    ("extract_seconds_total", "counter", s["extract_sec"],
                     "Seconds the dispatcher spent extracting raw audio."),
                    ("rtf", "gauge", rtf or 0.0,
                     "Server-side real-time factor (compute/audio)."),
                    ("registered_references", "gauge",
                     len(batching.reference_names()),
                     "Device-resident registered styles."),
                ):
                    lines.append(f"# HELP serenade_{name} {help_}")
                    lines.append(f"# TYPE serenade_{name} {kind}")
                    lines.append(f"serenade_{name} {val}")
                return self._send(200, ("\n".join(lines) + "\n").encode(),
                                  "text/plain; version=0.0.4")
            if self.path != "/healthz":
                return self._send_json(404, {})
            self._send_json(200, {"ok": True, **s, "rtf": rtf,
                                  "references": batching.reference_names()})

        def _convert_wav(self, query):
            """Raw audio in, audio out: RIFF wav bytes with
            ``?style=<registered>``, or an npz from
            ``encode_wav_request``.  Answers with RIFF wav bytes when a
            vocoder is loaded, else an npz with the mel."""
            from serenade_tpu_torch.utils.audio import read_wav, write_wav

            body = self._read_body()
            if body[:4] == b"RIFF":
                src_wav, sr = read_wav(io.BytesIO(body))
                ref = query.get("style", [""])[0]
                if not ref:
                    raise ValueError("RIFF body needs ?style=<registered name>")
                f0_range = _f0_range_from(query, f0_table=f0_table)
            else:
                with np.load(io.BytesIO(body)) as z:
                    src_wav, sr = z["src_wav"], int(z["sr"])
                    ref = (str(z["ref_name"]) if "ref_name" in z.files
                           else (z["ref_wav"], int(z["ref_sr"])))
                    f0_range = _f0_range_from(query, files=z,
                                              f0_table=f0_table)
            mel, wav, out_sr = batching.convert_wav(src_wav, sr, ref,
                                                    f0_range=f0_range)
            buf = io.BytesIO()
            if wav is not None:
                write_wav(buf, wav, out_sr)
                return self._send(200, buf.getvalue(), "audio/wav")
            np.savez(buf, mel=mel)
            self._send(200, buf.getvalue(), "application/octet-stream")

        def _convert_stream(self, query):
            """A chunked stream of length-prefixed npz blocks (``start``,
            ``mel``, and ``wav``, ``sr`` with a vocoder) as long-form
            regions finalize; read it with ``iter_stream_blocks``.  It
            bypasses the batching queue: the path is for the time to first
            audio, not throughput.  Query: chunk_frames, overlap_frames,
            windowed, first_chunk_frames, extract_ctx_frames.  Bodies:
            ``_parse_stream_body``."""
            with batching._on_device():
                try:
                    src, ref, f0_range = _parse_stream_body(
                        self._read_body(), query, batching,
                        f0_table=f0_table)
                    conv = batching.converter
                    chunk_frames = int(query.get("chunk_frames",
                                                 ["2048"])[0])
                    overlap_frames = int(query.get("overlap_frames",
                                                   ["256"])[0])
                    windowed = query.get("windowed", ["1"])[0] not in (
                        "0", "false")
                    if isinstance(src, _RawSource) and windowed:
                        gen = conv.convert_wav_stream(
                            src.wav, src.sr, ref, chunk_frames=chunk_frames,
                            overlap_frames=overlap_frames,
                            first_chunk_frames=int(query.get(
                                "first_chunk_frames", ["512"])[0]),
                            extract_ctx_frames=int(query.get(
                                "extract_ctx_frames", ["256"])[0]),
                            f0_range=f0_range)
                    else:
                        if isinstance(src, _RawSource):
                            src = _extract_or_raise(
                                conv, [src.wav], [src.sr],
                                f0_ranges=[f0_range])[0]
                        gen = conv.convert_features_stream(
                            src, ref, chunk_frames=chunk_frames,
                            overlap_frames=overlap_frames)
                    # the first segment before the 200: the generator is
                    # lazy, and an error here is a real 400, not an empty
                    # stream that ends "successfully"
                    first = next(gen, None)
                except Exception as e:  # noqa: BLE001 — per-request fault
                    return self._fault(e)
                self._emit_stream(gen, first, conv.output_sample_rate)

        def _emit_stream(self, gen, first, sr, upload=None):
            """A 200 with a chunked body of length-prefixed npz blocks,
            ending with the ``{done}`` or ``{error}`` marker
            (``iter_stream_blocks``).  ``upload``: the live request's
            body, still arriving; on a fault it is read off
            (``_drain``) and the connection closed."""
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(b: bytes):
                self.wfile.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")

            def emit(seg):
                start, mel_seg, wav_seg = seg
                arrays = {"start": np.int64(start), "mel": mel_seg}
                if wav_seg is not None:
                    arrays["wav"] = wav_seg
                    arrays["sr"] = np.int64(sr)
                chunk(_frame_block(arrays))

            # every stream ends with a marker block before the chunked
            # terminator, or a cut conversion would read as a whole one
            try:
                if first is not None:
                    emit(first)
                for seg in gen:
                    emit(seg)
                chunk(_frame_block({"done": np.int64(1)}))
            except Exception as e:  # noqa: BLE001 — fault mid-stream
                logger.exception("stream conversion failed mid-flight")
                try:
                    chunk(_frame_block({"error": np.asarray(str(e))}))
                    self.wfile.write(b"0\r\n\r\n")
                except Exception:  # noqa: BLE001 — the socket is gone
                    pass
                if upload is not None:
                    self._drain(upload)
                return
            self.wfile.write(b"0\r\n\r\n")

        def _drain(self, upload):
            """Read off what is left of a live upload the server gave up
            on, up to ``max_body_bytes`` (``_iter_chunked_body``'s cap),
            then close.  Closing with the client's data unread would reset
            the connection, and a client still sending lost the answer."""
            self.close_connection = True
            self.connection.settimeout(_DRAIN_IDLE_S)
            try:
                for _ in upload:
                    pass
            except Exception:  # noqa: BLE001 — the upload is refused anyway
                pass

        def _iter_chunked_body(self):
            """Decode a ``Transfer-Encoding: chunked`` request body piece
            by piece (``BaseHTTPRequestHandler`` does not), so the live
            endpoint converts while the client uploads.  The total is
            capped at ``max_body_bytes``."""
            total = 0
            while True:
                line = self.rfile.readline(1024)
                if line == b"":
                    # EOF between chunks is a disconnect, not the end of
                    # the body: a cut upload must not end with {done: 1}
                    raise ValueError("chunked upload disconnected "
                                     "mid-stream")
                if not line.endswith(b"\n"):
                    # the rest of a longer size line would be read as data
                    raise ValueError("oversized chunk-size line")
                size = int(line.split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    while True:  # skip trailers up to the blank line
                        t = self.rfile.readline(1024)
                        if t in (b"\r\n", b"\n", b""):
                            return
                total += size
                if total > max_body_bytes:
                    raise _PayloadTooLarge(
                        f"chunked body exceeds the server cap of "
                        f"{max_body_bytes}")
                data = b""
                while len(data) < size:
                    got = self.rfile.read(size - len(data))
                    if not got:
                        raise ValueError("truncated chunked body")
                    data += got
                self.rfile.read(2)  # the chunk's closing CRLF
                yield data

        def _convert_stream_live(self, query):
            """Live conversion: PCM16 mono audio uploads as a chunked
            request body, and converted segments stream back on the same
            connection while the source still arrives.  Query: ``style``
            (registered, required), ``sr`` (the model's rate),
            chunk_frames, overlap_frames, extract_ctx_frames (defaults
            64/16/32), and the F0 range as /convert_wav takes it.  A
            Content-Length body is taken as one piece.  The answer is the
            /convert_stream block wire."""
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            # lazy: a refused upload is read off by _drain, not reset
            byte_iter = (self._iter_chunked_body() if "chunked" in te
                         else iter(()))
            with batching._on_device():
                try:
                    if "chunked" not in te:
                        byte_iter = iter([self._read_body()])
                    conv = batching.converter
                    style = query.get("style", [""])[0]
                    if not style:
                        raise ValueError(
                            "live stream needs ?style=<registered name>")
                    ref = batching.packed_reference(style)
                    sr = int(query.get("sr", ["24000"])[0])

                    def audio_iter():
                        carry = b""
                        for piece in byte_iter:
                            data = carry + piece
                            cut = len(data) - (len(data) % 2)
                            carry = data[cut:]
                            if cut:
                                yield (np.frombuffer(data[:cut], "<i2")
                                       .astype(np.float32) / 32768.0)
                        if carry:
                            raise ValueError(
                                "odd trailing byte in PCM16 live body")

                    gen = conv.convert_wav_stream_live(
                        audio_iter(), sr, ref,
                        chunk_frames=int(query.get("chunk_frames",
                                                   ["64"])[0]),
                        overlap_frames=int(query.get("overlap_frames",
                                                     ["16"])[0]),
                        extract_ctx_frames=int(query.get(
                            "extract_ctx_frames", ["32"])[0]),
                        f0_range=_f0_range_from(query, f0_table=f0_table))
                    first = next(gen, None)
                except Exception as e:  # noqa: BLE001 — per-request fault
                    self._fault(e)
                    return self._drain(byte_iter)
                self._emit_stream(gen, first, conv.output_sample_rate,
                                  upload=byte_iter)

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path == "/convert_stream":
                return self._convert_stream(parse_qs(parsed.query))
            if parsed.path == "/convert_stream_live":
                return self._convert_stream_live(parse_qs(parsed.query))
            try:
                if parsed.path == "/register_reference":
                    name = parse_qs(parsed.query).get("name", [""])[0]
                    if not name:
                        raise ValueError("missing ?name=<style>")
                    batching.register_reference(
                        name, _parse_ref_npz(self._read_body()))
                    return self._send_json(200, {"ok": True, "name": name})
                if parsed.path == "/convert_wav":
                    return self._convert_wav(parse_qs(parsed.query))
                if parsed.path != "/convert_features":
                    return self._send_json(404, {})
                src, ref = _parse_npz(self._read_body())
                mel, wav, sr = batching.convert(src, ref)
                out = {"mel": mel}
                if wav is not None:
                    out["wav"], out["sr"] = wav, np.int64(sr)
                buf = io.BytesIO()
                np.savez(buf, **out)
                self._send(200, buf.getvalue(), "application/octet-stream")
            except Exception as e:  # noqa: BLE001 — per-request fault
                self._fault(e)

    return ThreadingHTTPServer((host, port), Handler)
