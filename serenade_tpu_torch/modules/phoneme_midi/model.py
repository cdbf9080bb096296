"""The audio-to-MIDI transcription network (counterpart of
serenade_tpu/modules/phoneme_midi/model.py): a phoneme-recognition
branch (conv stack and BiLSTM to 39 phones) and a pitch branch (the conv
stack with its first conv dilated 2 in time), joined by a combined BiLSTM
into three frame logits (onset, offset, activation).

The conv stacks run channels-first ``(B, C, T, F)``, the upstream
layout, and flatten ``(B, T, C, F)`` in C-major order, as JAX does to
match it.  The BatchNorms are frozen (running statistics).  The BiLSTMs
are ``torch.nn.LSTM(bidirectional=True)``, gate order i, f, g, o, as
JAX's ``lax.scan`` BiLSTM and the upstream state dict have it; on the
card they run cuDNN's LSTM, as JAX runs its scan outside Pallas.  The
mel frontend is the port's DFT-basis STFT (``ops/stft.py``) and mel
basis.  Full width: ``n_mels`` 229, ``model_size`` 768
(``model_complexity`` 48 x 16), 39 phones.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from serenade_tpu_torch.models.gst import FrozenBatchNorm2d
from serenade_tpu_torch.models.layers import Conv2d, Dense

# inference BatchNorm with running statistics (mean, var, scale, bias)
FrozenBatchNorm = FrozenBatchNorm2d


class _ConvStack(nn.Module):
    """conv 3x3 (time dilation ``first_dilation``) → BN → ReLU → conv →
    BN → ReLU → max-pool (1, 2) → conv → BN → ReLU → max-pool (1, 2) →
    Dense over the flattened (channels, bins)."""

    def __init__(self, output_features: int, input_features: int,
                 first_dilation: int = 1):
        super().__init__()
        c = output_features // 16
        d = first_dilation
        self.conv0 = Conv2d(1, c, (3, 3), padding=(2 if d == 2 else 1, 1),
                            dilation=(d, 1))
        self.bn0 = FrozenBatchNorm(c)
        self.conv1 = Conv2d(c, c, (3, 3), padding=(1, 1))
        self.bn1 = FrozenBatchNorm(c)
        self.conv2 = Conv2d(c, output_features // 8, (3, 3), padding=(1, 1))
        self.bn2 = FrozenBatchNorm(output_features // 8)
        self.fc = Dense((output_features // 8) * (input_features // 4),
                        output_features)

    def forward(self, x):
        """x ``(B, T, F)`` -> ``(B, T, output_features)``."""
        h = x[:, None]
        h = F.relu(self.bn0(self.conv0(h)))
        h = F.relu(self.bn1(self.conv1(h)))
        h = F.max_pool2d(h, (1, 2))
        h = F.relu(self.bn2(self.conv2(h)))
        h = F.max_pool2d(h, (1, 2))
        return self.fc(h.transpose(1, 2).flatten(2))


class BiLSTM(nn.LSTM):
    """One bidirectional LSTM layer, batch first; returns the
    concatenated forward and backward outputs ``(B, T, 2 hidden)``."""

    def __init__(self, input_features: int, hidden: int):
        super().__init__(input_features, hidden, batch_first=True,
                         bidirectional=True)

    def forward(self, x):
        return super().forward(x)[0]


class PhonemeRecognitionModel(nn.Module):
    """Mel frames -> 39 phone logits."""

    def __init__(self, n_mels: int = 229, model_size: int = 768,
                 num_phones: int = 39):
        super().__init__()
        self.conv_stack = _ConvStack(model_size, n_mels)
        self.rnn = BiLSTM(model_size, model_size // 2)
        self.fc = Dense(model_size, num_phones)

    def forward(self, mel_db):
        return self.fc(self.rnn(self.conv_stack(mel_db)))


class TranscriptionModel(nn.Module):
    """Mel (dB) ``(B, T, n_mels)`` -> ``(B, T, 3)`` frame logits: the phone
    logits (all but the last, as the upstream model feeds 38) through
    their own conv stack and BiLSTM, beside the dilated pitch stack's,
    joined by a BiLSTM and a Dense."""

    def __init__(self, n_mels: int = 229, model_size: int = 768,
                 num_phones: int = 39):
        super().__init__()
        self.num_phones = num_phones
        self.lang_model = PhonemeRecognitionModel(n_mels, model_size,
                                                  num_phones)
        self.lang_conv_stack = _ConvStack(model_size, num_phones - 1)
        self.lang_rnn = BiLSTM(model_size, model_size // 2)
        self.pitch_conv_stack = _ConvStack(model_size, n_mels,
                                           first_dilation=2)
        self.pitch_rnn = BiLSTM(model_size, model_size // 2)
        self.combined_rnn = BiLSTM(2 * model_size, model_size // 2)
        self.combined_fc = Dense(model_size, 3)

    def forward(self, mel_db):
        lang = self.lang_model(mel_db)[..., :self.num_phones - 1]
        x_lang = self.lang_rnn(self.lang_conv_stack(lang))
        x_pitch = self.pitch_rnn(self.pitch_conv_stack(mel_db))
        x = self.combined_rnn(torch.cat([x_pitch, x_lang], dim=-1))
        return self.combined_fc(x)


def mel_db_frontend(audio, sr: int, win_length: int, hop_length: int,
                    n_mels: int, fmin: float, fmax: float):
    """Power mel in dB of ``(..., N)`` waveforms, clamped 80 dB under its
    maximum over the whole input (as JAX's)."""
    from serenade_tpu_torch.ops.mel import _on_device, mel_filterbank
    from serenade_tpu_torch.ops.stft import stft_power

    power = stft_power(audio, win_length, hop_length, win_length)
    basis = _on_device(mel_filterbank, (sr, win_length, n_mels, float(fmin),
                                        float(fmax)), audio.device)
    db = 10.0 * torch.log10(torch.clamp_min(power @ basis, 1e-10))
    return torch.maximum(db, db.max() - 80.0)


def load_transcriber(ckpt_path: str, device=None):
    """A ``transcribe_fn(audio, fs) -> (notes, intervals)`` from an upstream
    ``midi_model.pt`` (``{"config", "model_state_dict"}``, read with
    ``weights_only=True``): the audio resampled to the model's rate, its
    dB mel, the frame logits, and the decoder's notes (MIDI numbers,
    rounded) and intervals in seconds.  Runs on ``device`` (the card
    unless named)."""
    from serenade_tpu_torch import resolve_device
    from serenade_tpu_torch.modules.phoneme_midi.convert import (
        load_upstream_state_dict,
    )
    from serenade_tpu_torch.modules.phoneme_midi.decoding import (
        FramewiseDecoder,
    )
    from serenade_tpu_torch.utils.audio import resample

    dev = resolve_device(device)
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    config = ckpt["config"]
    model = TranscriptionModel(n_mels=config["n_mels"],
                               model_size=config["model_complexity"] * 16)
    model.load_state_dict(load_upstream_state_dict(ckpt["model_state_dict"]),
                          strict=True)
    model = model.to(dev).eval()
    decoder = FramewiseDecoder(config, device=dev)

    @torch.no_grad()
    def transcribe_fn(audio, fs):
        sr = config["sample_rate"]
        wav = resample(np.asarray(audio, np.float32), fs, sr)
        mel = mel_db_frontend(torch.from_numpy(wav).to(dev), sr,
                              config["win_length"], config["hop_length"],
                              config["n_mels"], config["fmin"],
                              config["fmax"])
        pred = model(mel[None])[0].float().cpu().numpy()
        pitches, frame_intervals = decoder.decode(pred, audio=wav)
        scale = config["hop_length"] / config["sample_rate"]
        intervals = [(s * scale, e * scale) for s, e in frame_intervals]
        return [int(round(p)) for p in pitches], intervals

    transcribe_fn.model = model
    return transcribe_fn
