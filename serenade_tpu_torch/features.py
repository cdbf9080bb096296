"""Per-utterance feature extraction (counterpart of serenade_tpu/features.py).

The signal features (log-mel, loudness, F0) of a group of same-length
waveforms run as one batched pass on the device: the STFTs as DFT-basis
matmuls, YIN's CMND by FFT, the Viterbi trellis as one kernel launch
(``ops/viterbi_cuda.py``).  The host resamples sources at other rates,
segments the F0 track into the estimated score (``ops/midi.py``) and
aligns the streams.  Content features come from a ContentVec content
function (``bin/preprocess.py``), whose batched forms leave them on the
device.  Everything is f32 but the DFT products' sums (``ops/stft.py``
states the precision).

Padding decides the numbers, so it is JAX's: signals pad to multiples of
128 hops (``_bucketed``), groups to powers of two by repeating their last
waveform, ContentVec to 2 s buckets; the loudness clip and ContentVec's
attention and first GroupNorm see each row's padding, as in JAX.

Long-form streams extract window by window (``stream_total_frames``,
``extract_stream_window``): each conversion chunk's source features come
from a context-padded window of the waveform.

``with_f0_fluc`` adds the F0-fluctuation variant's ``f0_fluc``: the F0
track over ``maxf0`` less its smoothing spline (scipy's
``UnivariateSpline``, f64 on the host, ``compute_f0_fluctuation``).

F0 backends: "viterbi" (YIN + Viterbi, the default), "yin" and
"harvest" (``ops/harvest.py``) on the device; "native" and
"harvest_native" run YIN or Harvest per waveform on the host
(``native.py``, the C++ library built by g++), the log-mel, loudness and
smoothing on the device.

The estimated score comes from F0 note segmentation, or from the
phoneme-MIDI transcriber where ``midi_transcribe_fn`` is given
(``modules/phoneme_midi``, ``load_transcriber``: ``(audio, fs) ->
(notes, intervals in seconds)``), as in JAX.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from serenade_tpu_torch import resolve_device, upload
from serenade_tpu_torch.collaters.ssc import next_pow2
from serenade_tpu_torch.ops.f0 import smooth_f0_median, yin_f0, yin_f0_viterbi
from serenade_tpu_torch.ops.harvest import harvest_f0
from serenade_tpu_torch.ops.mel import logmelfilterbank, loudness_extract
from serenade_tpu_torch.ops.midi import (
    f0_to_note_events, midi_note_array_to_hz, note_seq_to_frames,
    notes_to_frames,
)
from serenade_tpu_torch.utils.audio import resample, to_mono

logger = logging.getLogger(__name__)

F0_BACKENDS = {"viterbi": yin_f0_viterbi, "yin": yin_f0,
               "harvest": harvest_f0}
# F0 on the host, one waveform at a time (the native library)
HOST_F0_BACKENDS = ("native", "harvest_native")


@dataclasses.dataclass
class FeatureConfig:
    sampling_rate: int = 24000
    fft_size: int = 512
    hop_size: int = 240
    win_length: int = 480
    window: str = "hann"
    num_mels: int = 80
    fmin: float = 63.0
    fmax: float = 12000.0
    eps: float = 1e-6
    log_base: float = 10.0
    shiftms: float = 10.0

    @classmethod
    def from_dict(cls, d: Dict):
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def spk_id_from_utt(utt_id: str) -> str:
    """GTSinger utt_id -> the speaker key of the F0-range table."""
    try:
        return utt_id.split("_")[3].split("-")[1]
    except IndexError:
        return utt_id


def f0_range_for(utt_id: str, f0_table: Optional[Dict]) -> tuple:
    spk = spk_id_from_utt(utt_id)
    if f0_table and spk in f0_table:
        return float(f0_table[spk]["minf0"]), float(f0_table[spk]["maxf0"])
    logger.info("no f0 range for %s; using defaults", spk)
    return 70.0, 1100.0


def check_f0_backend(f0_backend: str, host: bool = True) -> None:
    """Raise on an F0 backend the caller cannot run: an unknown name, or a
    host backend where ``host`` is False (the batched device analyses)."""
    known = tuple(F0_BACKENDS) + (HOST_F0_BACKENDS if host else ())
    if f0_backend not in known:
        raise ValueError(f"unknown f0_backend {f0_backend!r}; this path "
                         f"takes {known}")


def _host_f0(f0_backend: str):
    from serenade_tpu_torch.native import harvest_f0_native, yin_f0_native

    return (harvest_f0_native if f0_backend == "harvest_native"
            else yin_f0_native)


def compute_f0_fluctuation(f0: np.ndarray, maxf0: float,
                           shiftms: float = 10.0) -> np.ndarray:
    """The F0 track over ``maxf0`` less its smoothing spline
    (``UnivariateSpline(s=10)`` over the frame times, in f64), as f32.
    Raises where the track is too short for the spline."""
    from scipy.interpolate import UnivariateSpline

    t = np.arange(len(f0)) * shiftms / 1000.0
    f0_normed = np.asarray(f0, np.float64) / maxf0
    spline = UnivariateSpline(t, f0_normed, s=10)
    return (f0_normed - spline(t)).astype(np.float32)


def _bucketed(audio: np.ndarray, hop_size: int) -> Tuple[np.ndarray, int]:
    """Pad to a multiple of 128 hops (JAX's length bucket).  Returns
    (padded audio, true frame count)."""
    n_frames = 1 + len(audio) // hop_size
    bucket = 128 * hop_size
    padded_len = ((len(audio) + bucket - 1) // bucket) * bucket
    return np.pad(audio, (0, padded_len - len(audio))), n_frames


def extract_signal_features_group(
    audios_b: Sequence[np.ndarray],
    config: FeatureConfig,
    minf0: float,
    maxf0: float,
    f0_backend: str = "viterbi",
    wire_dtype: str = "float32",
    device=None,
) -> List[Dict[str, np.ndarray]]:
    """Log-mel, loudness and median-smoothed F0 of same-length bucketed
    waveforms sharing an F0 search range, in one batched pass on the
    device.  Full padded-length outputs (callers slice to each
    utterance's frames), on the host.

    ``wire_dtype="int16"`` uploads PCM16 (``/ 32768`` on the device, as
    read_wav decodes): half the bytes, lossless for PCM16 sources."""
    check_f0_backend(f0_backend)
    dev = resolve_device(device)
    if wire_dtype == "int16":
        batch = np.stack([np.clip(np.round(np.asarray(a) * 32768.0),
                                  -32768, 32767).astype(np.int16)
                          for a in audios_b])
        wav = upload(batch, dev).float() / 32768.0
    else:
        wav = upload(np.stack(audios_b), dev, np.float32)
    fs = config.sampling_rate
    logmel = logmelfilterbank(
        wav, fs, fft_size=config.fft_size, hop_size=config.hop_size,
        win_length=config.win_length, num_mels=config.num_mels,
        fmin=config.fmin, fmax=config.fmax, eps=config.eps,
        log_base=config.log_base)
    loud = loudness_extract(wav, fs, config.hop_size)
    if f0_backend in HOST_F0_BACKENDS:
        f0_raw = upload(np.stack([_host_f0(f0_backend)(
            np.asarray(a, np.float32), fs=fs, f0_floor=minf0, f0_ceil=maxf0,
            frame_period_ms=config.shiftms)[0] for a in audios_b]), dev)
    else:
        f0_raw, _ = F0_BACKENDS[f0_backend](
            wav, fs=fs, f0_floor=minf0, f0_ceil=maxf0,
            frame_period_ms=config.shiftms)
    f0 = smooth_f0_median(f0_raw)
    # one download: the host needs F0 for the score
    host = torch.cat([logmel, loud[..., None], f0[..., None]],
                     dim=-1).cpu().numpy()
    return [{"logmel": host[i, :, :-2], "loud": host[i, :, -2],
             "f0": host[i, :, -1]} for i in range(len(audios_b))]


def extract_features(
    utt_id: str,
    audio: np.ndarray,
    fs: int,
    config: FeatureConfig,
    *,
    f0_table: Optional[Dict] = None,
    gt_note_seq: Optional[list] = None,
    content_fn=None,
    midi_transcribe_fn=None,
    with_f0_fluc: bool = False,
    f0_backend: str = "viterbi",
    f0_range: Optional[tuple] = None,
    device=None,
) -> Optional[Dict[str, np.ndarray]]:
    """The per-utterance feature dict (wave, hubert, logmel, loud,
    gt_lf0_score, est_lf0_score, f0, vuv, midi[, f0_fluc]), None where
    the F0 track gives no note.  ``f0_range=(minf0, maxf0)`` overrides the
    voice-type table."""
    check_f0_backend(f0_backend)
    audio = _prepare_audio(utt_id, audio, fs, config)
    audio_b, n_frames = _bucketed(audio, config.hop_size)
    minf0, maxf0 = f0_range or f0_range_for(utt_id, f0_table)
    sig = extract_signal_features_group(
        [audio_b], config, minf0, maxf0, f0_backend, device=device)[0]
    return _finalize_utt(utt_id, audio, config, sig, n_frames, maxf0,
                         gt_note_seq=gt_note_seq, content_fn=content_fn,
                         midi_transcribe_fn=midi_transcribe_fn,
                         with_f0_fluc=with_f0_fluc)


def validate_waveform(audio, name: str = "audio") -> np.ndarray:
    """Reject a malformed waveform on the host (a server checks each at
    submit, so a bad one faults alone).  Returns the mono float array."""
    audio = to_mono(np.asarray(audio))
    if audio.size == 0:
        raise ValueError(f"{name}: empty waveform")
    if not np.isfinite(audio).all():
        raise ValueError(f"{name}: non-finite samples")
    if np.abs(audio).max() > 1.0:
        raise ValueError(f"{name}: audio not normalized to [-1, 1]")
    return audio


def _prepare_audio(utt_id, audio, fs, config: FeatureConfig) -> np.ndarray:
    audio = validate_waveform(audio, utt_id)
    if fs != config.sampling_rate:
        audio = resample(audio, fs, config.sampling_rate)
    # length alignment pad (reference preprocess.py:430-432)
    return np.pad(audio, (0, config.fft_size), mode="reflect")


def _finalize_utt(utt_id, audio, config: FeatureConfig, sig, n_frames: int,
                  maxf0: float, *, gt_note_seq=None, content_fn=None,
                  midi_transcribe_fn=None, with_f0_fluc: bool = False,
                  hubert=None) -> Optional[Dict[str, np.ndarray]]:
    """The host's tail of an utterance: content features (``hubert``
    when the batch path computed them), the estimated score (from
    ``midi_transcribe_fn`` where given, else from the F0 track),
    ``f0_fluc``, and every frame stream cut to the shortest."""
    logmel = sig["logmel"][:n_frames]
    loud = sig["loud"][:n_frames, None]
    f0 = sig["f0"][:n_frames, None]
    vuv = (f0 != 0).astype(np.float32)

    if hubert is None and content_fn is not None:
        hubert = np.asarray(content_fn(
            resample(audio, config.sampling_rate, 16000)))

    total_seconds = audio.shape[-1] / config.sampling_rate
    if midi_transcribe_fn is not None:
        notes, intervals = midi_transcribe_fn(audio, config.sampling_rate)
    else:
        notes, intervals = f0_to_note_events(
            f0[:, 0], frame_shift_s=config.shiftms / 1000.0)
    if not notes:
        logger.info("skipping %s: no MIDI information", utt_id)
        return None
    midi = notes_to_frames(notes, intervals, total_seconds,
                           shift_ms=config.shiftms)
    est_lf0_score = midi_note_array_to_hz(midi, log_f0=True)[:, None]
    if gt_note_seq is not None:
        gt_midi = note_seq_to_frames(gt_note_seq, config.shiftms / 1000.0)
        gt_lf0_score = midi_note_array_to_hz(gt_midi, log_f0=True)[:, None]
    else:
        gt_lf0_score = est_lf0_score.copy()

    feats = {
        "wave": audio.astype(np.float32),
        "logmel": logmel.astype(np.float32),
        "loud": loud.astype(np.float32),
        "f0": f0.astype(np.float32),
        "vuv": vuv,
        "midi": midi[:, None].astype(np.float32),
        "est_lf0_score": est_lf0_score.astype(np.float32),
        "gt_lf0_score": gt_lf0_score.astype(np.float32),
    }
    if hubert is not None:
        # a tensor on the device from the batch path, else numpy
        feats["hubert"] = (hubert.float() if torch.is_tensor(hubert)
                           else hubert.astype(np.float32))
    if with_f0_fluc:
        feats["f0_fluc"] = compute_f0_fluctuation(
            f0[:, 0], maxf0, config.shiftms)[:, None]
    frame_keys = [k for k in feats if k != "wave"]
    min_len = min(feats[k].shape[0] for k in frame_keys)
    for k in frame_keys:
        feats[k] = feats[k][:min_len]
    return feats


def stream_total_frames(audio_len: int, config: FeatureConfig) -> int:
    """Frames a streamed conversion of a ``_prepare_audio``'d waveform of
    ``audio_len`` samples produces: the fewest of the streams' counts, as
    :func:`_finalize_utt` cuts them (mel ``1 + L // hop``; the score
    ``ceil(seconds / shift)``; ContentVec ``(L16 - 400) // 160 + 1`` after
    the 16 kHz resample)."""
    n = 1 + audio_len // config.hop_size
    n = min(n, int(np.ceil(
        audio_len / config.sampling_rate / (config.shiftms / 1000.0))))
    n16 = (audio_len * 16000 + config.sampling_rate - 1) \
        // config.sampling_rate
    return min(n, (n16 - 400) // 160 + 1)


def extract_stream_window(
    audio: np.ndarray,
    span: Tuple[int, int],
    config: FeatureConfig,
    minf0: float,
    maxf0: float,
    *,
    content_fn,
    ctx_frames: int = 256,
    with_f0_fluc: bool = False,
    device=None,
) -> Dict[str, np.ndarray]:
    """Source features (``hubert``, ``score``, ``loud``, ``f0``
    [, ``f0_fluc``, the spline fitted over the window's F0]) of frames
    ``[s, e)`` of an already ``_prepare_audio``'d waveform, extracted from
    a window padded with ``ctx_frames`` of context on each side: the
    streaming form of :func:`extract_features`, whose first chunk is ready
    after one window's work instead of the whole utterance's.

    The window starts on a frame boundary (``(s - lc) * hop`` samples, an
    exact 16 kHz sample too at 24 kHz), so window frame ``lc + i`` is
    global frame ``s + i``.  Inside the span the windowed mel, loudness
    and F0 equal full-utterance extraction but for two deviations: the
    loudness clip is relative to the window's peak, and ContentVec attends
    within the window only.  Notes for the score are segmented over the
    whole window, context included, so a note across the span's edge
    keeps its extent.  F0 is Viterbi's; the window goes up once on the
    int16 wire, as JAX sends it, and ``content_fn.batch24`` (a 24 kHz
    config) resamples it for ContentVec on the device, where ``hubert``
    stays."""
    s, e = span
    hop = config.hop_size
    n = e - s
    # ContentVec's 400-sample receptive field costs about 2 frames at the
    # window's tail ((K*160-400)//160+1 = K-2): with less context every
    # interior window would come up short
    ctx_frames = max(ctx_frames, 2)
    lc = min(s, ctx_frames)
    start = (s - lc) * hop
    if start >= len(audio):
        raise ValueError(
            f"span {span} starts past the waveform "
            f"({len(audio)} samples); respect stream_total_frames")
    win = audio[start: min(len(audio), (e + ctx_frames) * hop)]
    win_b, n_frames_w = _bucketed(win, hop)
    sig = extract_signal_features_group(
        [win_b], config, minf0, maxf0, "viterbi", wire_dtype="int16",
        device=device)[0]
    if lc + n > n_frames_w:
        raise ValueError(
            f"span {span} exceeds the window's {n_frames_w} frames "
            f"(total frames bound the caller should respect: "
            f"stream_total_frames)")
    f0_w = np.asarray(sig["f0"][:n_frames_w])

    shift_s = config.shiftms / 1000.0
    notes, intervals = f0_to_note_events(f0_w, frame_shift_s=shift_s)
    if notes:
        midi_w = notes_to_frames(notes, intervals,
                                 len(win) / config.sampling_rate,
                                 shift_ms=config.shiftms)
    else:
        midi_w = np.zeros(n_frames_w, np.int32)
    if midi_w.shape[0] < lc + n:  # ceil rounding at the stream's tail
        midi_w = np.pad(midi_w, (0, lc + n - midi_w.shape[0]))
    score = midi_note_array_to_hz(midi_w[lc:lc + n], log_f0=True)[:, None]

    hub = content_fn.batch24([win], wire_dtype="int16")[0]
    if hub.shape[0] < lc + n:
        raise ValueError(
            f"content window produced {hub.shape[0]} frames, span {span} "
            f"needs {lc + n}: the caller exceeded stream_total_frames")
    feats = {
        "loud": np.asarray(sig["loud"][lc:lc + n])[:, None]
        .astype(np.float32),
        "f0": f0_w[lc:lc + n, None].astype(np.float32),
        "score": score.astype(np.float32),
        # a slice on the device: the chunk's pack takes it there
        "hubert": hub[lc:lc + n],
    }
    if with_f0_fluc:
        feats["f0_fluc"] = compute_f0_fluctuation(
            f0_w, maxf0, config.shiftms)[lc:lc + n, None]
    return feats


def extract_features_batch(
    items: Sequence[Tuple[str, np.ndarray, int, Optional[list]]],
    config: FeatureConfig,
    *,
    f0_table: Optional[Dict] = None,
    content_fn=None,
    midi_transcribe_fn=None,
    with_f0_fluc: bool = False,
    f0_backend: str = "viterbi",
    max_group: int = 8,
    pad_group_pow2: bool = False,
    wire_dtype: str = "float32",
    f0_ranges: Optional[Sequence[Optional[tuple]]] = None,
    device=None,
) -> Dict[str, Optional[Dict[str, np.ndarray]]]:
    """Batched extraction over ``(utt_id, audio, fs, gt_note_seq)`` items:
    utterances of one length bucket and F0 range share one signal pass,
    each ContentVec bucket one forward.  Per utterance the same numbers as
    :func:`extract_features` (same padded shapes).  Returns ``{utt_id:
    feats or None}``; an item that fails (a bad waveform, no note) is
    None alone.

    ``pad_group_pow2`` pads each group to a power of two by repeating its
    last waveform (serving: a few batch shapes per bucket).
    ``wire_dtype="int16"`` uploads PCM16 and, with a 24 kHz config and a
    content function that has ``batch24``, resamples for ContentVec on the
    device from that one upload.  ``f0_ranges``: per-item ``(minf0,
    maxf0)`` overrides (None falls back to the table).  A clip too short
    for the ``f0_fluc`` spline is None alone, with a warning."""
    check_f0_backend(f0_backend)
    out: Dict[str, Optional[Dict[str, np.ndarray]]] = {}
    prepared = []
    for j, (utt_id, audio, fs, gt_note_seq) in enumerate(items):
        try:
            audio_p = _prepare_audio(utt_id, audio, fs, config)
        except Exception as e:  # noqa: BLE001 — a bad item skips alone
            logger.warning("skipping %s: %s", utt_id, e)
            out[utt_id] = None
            continue
        audio_b, n_frames = _bucketed(audio_p, config.hop_size)
        override = f0_ranges[j] if f0_ranges is not None else None
        minf0, maxf0 = override or f0_range_for(utt_id, f0_table)
        prepared.append((utt_id, audio_p, audio_b, n_frames, minf0, maxf0,
                         gt_note_seq))

    groups: Dict[tuple, list] = {}
    for i, rec in enumerate(prepared):
        groups.setdefault((rec[2].shape[0], rec[4], rec[5]), []).append(i)

    huberts: Dict[int, torch.Tensor] = {}
    if content_fn is not None and prepared:
        if wire_dtype == "int16" and config.sampling_rate == 24000:
            huberts = dict(enumerate(content_fn.batch24(
                [rec[1] for rec in prepared], wire_dtype=wire_dtype)))
        else:
            huberts = dict(enumerate(content_fn.batch(
                [resample(rec[1], config.sampling_rate, 16000)
                 for rec in prepared])))

    for (_, minf0, maxf0), idxs in groups.items():
        for lo in range(0, len(idxs), max_group):
            chunk = idxs[lo:lo + max_group]
            run = chunk
            if pad_group_pow2:
                run = chunk + [chunk[-1]] * (next_pow2(len(chunk))
                                             - len(chunk))
            sigs = extract_signal_features_group(
                [prepared[i][2] for i in run], config, minf0, maxf0,
                f0_backend, wire_dtype=wire_dtype, device=device)
            for i, sig in zip(chunk, sigs):
                utt_id, audio_p, _, n_frames, _, mx, gt_note_seq = \
                    prepared[i]
                try:
                    out[utt_id] = _finalize_utt(
                        utt_id, audio_p, config, sig, n_frames, mx,
                        gt_note_seq=gt_note_seq, content_fn=content_fn,
                        midi_transcribe_fn=midi_transcribe_fn,
                        with_f0_fluc=with_f0_fluc, hubert=huberts.get(i))
                except Exception as e:  # noqa: BLE001 — skips alone
                    logger.warning("skipping %s: %s", utt_id, e)
                    out[utt_id] = None
    return out
