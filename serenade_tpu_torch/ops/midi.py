"""Frame-level MIDI score utilities, host-side numpy (copied from
serenade_tpu/ops/midi.py): note events from an F0 track and note events
to frame arrays.  Index scatters on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

A4_HZ = 440.0
A4_MIDI = 69


def midi_to_hz(midi):
    """MIDI note number -> Hz (librosa convention)."""
    return A4_HZ * np.power(2.0, (np.asarray(midi, np.float64) - A4_MIDI) / 12.0)


def hz_to_midi(freq):
    freq = np.asarray(freq, np.float64)
    with np.errstate(divide="ignore"):
        return 12.0 * np.log2(np.maximum(freq, 1e-12) / A4_HZ) + A4_MIDI


def midi_note_array_to_hz(x, log_f0: bool = False):
    """Elementwise MIDI -> Hz keeping zeros at rests; optional natural
    log."""
    x = np.asarray(x, np.float64)
    z = np.zeros_like(x)
    voiced = x > 0
    z[voiced] = midi_to_hz(x[voiced])
    if log_f0:
        z[voiced] = np.log(z[voiced])
    return z


def note_seq_to_frames(note_seq: Sequence[dict], frame_shift_s: float):
    """GTSinger-style JSON note list -> frame MIDI array.  Each dict holds
    parallel lists ``note``, ``note_start``, ``note_end``; later notes
    overwrite earlier ones on overlapping frames."""
    max_time = max(entry["note_end"][-1] for entry in note_seq)
    n_frames = int(np.ceil(max_time / frame_shift_s))
    frames = np.zeros(n_frames)
    for entry in note_seq:
        for note, start, end in zip(entry["note"], entry["note_start"],
                                    entry["note_end"]):
            frames[int(start / frame_shift_s):int(end / frame_shift_s)] = note
    return frames


def notes_to_frames(midi_values, time_intervals, total_seconds: float,
                    shift_ms: float = 10.0):
    """Note-level (pitch, [start, end)) events -> int frame array."""
    shift_s = shift_ms / 1000.0
    n_frames = int(np.ceil(total_seconds / shift_s))
    frames = np.zeros(n_frames, np.int32)
    for midi, (start, end) in zip(midi_values, time_intervals):
        s = int(np.floor(start / shift_s))
        e = min(int(np.ceil(end / shift_s)), n_frames)
        frames[s:e] = midi
    return frames


def f0_to_note_events(f0, frame_shift_s: float = 0.01,
                      min_note_frames: int = 5,
                      merge_gap_frames: int = 2
                      ) -> Tuple[List[int], List[Tuple[float, float]]]:
    """Segment an F0 track into note events by semitone quantization:
    voiced runs split where the quantized semitone changes, gaps of up to
    ``merge_gap_frames`` unvoiced frames bridged, fragments shorter than
    ``min_note_frames`` dropped.  Returns (midi_numbers, [(start_s,
    end_s), ...])."""
    f0 = np.asarray(f0).reshape(-1)
    semis = np.where(f0 > 0, np.round(hz_to_midi(np.maximum(f0, 1e-6))), 0)
    notes, intervals = [], []
    i, n = 0, len(semis)
    while i < n:
        if semis[i] <= 0:
            i += 1
            continue
        j = i
        gap = 0
        while j < n:
            if semis[j] == semis[i]:
                gap = 0
            elif semis[j] <= 0 and gap < merge_gap_frames:
                gap += 1
            else:
                break
            j += 1
        seg = slice(i, j)
        if (j - i) >= min_note_frames:
            voiced = f0[seg][f0[seg] > 0]
            pitch = int(np.round(np.median(hz_to_midi(voiced))))
            notes.append(pitch)
            intervals.append((i * frame_shift_s, j * frame_shift_s))
        i = j
    return notes, intervals
