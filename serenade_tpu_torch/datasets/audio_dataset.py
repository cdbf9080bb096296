"""Kaldi ``wav.scp`` audio dataset (counterpart of
serenade_tpu/datasets/audio_dataset.py ``AudioSCPDataset``).

``wav.scp`` lines are ``utt_id path`` (a piped ``... |`` entry is
refused); an optional Kaldi ``segments`` file (``seg_id utt_id start
end``, seconds) cuts sub-utterances.  PCM reads normalized to [-1, 1]
(``utils.audio.read_wav``), mono.  Iterating yields
``(utt_id, (audio, fs))``.
"""

from __future__ import annotations

from typing import Optional

from serenade_tpu_torch.utils.audio import read_wav, to_mono


class AudioSCPDataset:
    def __init__(self, wav_scp: str, segments: Optional[str] = None):
        wav_map = {}
        with open(wav_scp) as f:
            for line in f:
                parts = line.strip().split(maxsplit=1)
                if not parts:
                    continue
                utt_id, path = parts
                if path.endswith("|"):
                    raise ValueError(
                        "pipe-style wav.scp entries are not supported; "
                        f"materialize the wav first: {line.strip()}")
                wav_map[utt_id] = path
        if segments is not None:
            self.entries = []
            with open(segments) as f:
                for line in f:
                    seg_id, utt_id, start, end = line.strip().split()
                    self.entries.append((seg_id, wav_map[utt_id],
                                         float(start), float(end)))
        else:
            self.entries = [(u, p, None, None) for u, p in wav_map.items()]

    @property
    def utt_ids(self):
        return [e[0] for e in self.entries]

    def __iter__(self):
        for utt_id, path, start, end in self.entries:
            audio, fs = read_wav(path)
            audio = to_mono(audio)
            if start is not None:
                audio = audio[int(start * fs):int(end * fs)]
            yield utt_id, (audio, fs)
