"""Serenade style conversion by infilling (counterpart of
serenade_tpu/models/serenade.py ``Serenade.inference``).

The reference clip with its conditioning mel is packed time-adjacent
before the zero-conditioned source, the CFM samples the joint sequence and
the source part is returned.  Batch rows may have different reference
lengths.  The training losses and ReFlow pair generation wait for the
training slice; the F0-fluctuation variant (``fluc_channels > 0``) is not
ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from serenade_tpu_torch.models.cfm import CFM
from serenade_tpu_torch.models.conv1d_resnet import Conv1dResnet
from serenade_tpu_torch.models.gst import StyleEncoder
from serenade_tpu_torch.models.layers import as_dtype
from serenade_tpu_torch.ops.sequence import pack_pair_time, unpack_suffix_time
from serenade_tpu_torch.utils.masking import length_mask

# accepted for config compatibility; they only act in training
_TRAINING_ONLY = ("mask_size", "cfg_prob", "dropout", "remat")


class Serenade(nn.Module):
    def __init__(self, input_dim: int = 768, output_dim: int = 80,
                 encoder_channels: int = 80, encoder_hidden_dim: int = 512,
                 decoder_channels: int = 512, gst_embed_dim: int = 256,
                 decoder_attention_head_dim: int = 512,
                 fluc_channels: int = 0,
                 gst_norm_type: str = "masked_group", gst_tokens: int = 50,
                 gst_conv_chans: Tuple[int, ...] = (128, 128, 256, 256, 512,
                                                    512),
                 gst_gru_units: int = 128, dtype="bfloat16", **training):
        super().__init__()
        unknown = set(training) - set(_TRAINING_ONLY)
        if unknown:
            raise TypeError(f"unknown Serenade parameters {sorted(unknown)}")
        if fluc_channels:
            raise NotImplementedError("the F0-fluctuation variant is not "
                                      "ported yet")
        self.output_dim = output_dim
        self.dtype = as_dtype(dtype)
        conditioning_dim = encoder_channels + 1 + 1 + output_dim
        self.encoder = Conv1dResnet(input_dim, encoder_channels,
                                    encoder_hidden_dim, num_layers=2,
                                    dtype=dtype)
        self.gst = StyleEncoder(idim=output_dim, gst_tokens=gst_tokens,
                                gst_token_dim=gst_embed_dim,
                                conv_chans=tuple(gst_conv_chans),
                                gru_units=gst_gru_units,
                                norm_type=gst_norm_type, dtype=dtype)
        self.cfm_decoder = CFM(
            in_channels=conditioning_dim + output_dim, out_channels=output_dim,
            spk_embed_dim=gst_embed_dim,
            decoder_channels=(decoder_channels, decoder_channels),
            decoder_attention_head_dim=decoder_attention_head_dim,
            dtype=dtype)

    @torch.no_grad()
    def inference(self, x, lengths, midi, loud,
                  ref_x, ref_lengths, ref_logmel, ref_midi, ref_loud, *,
                  generator: Optional[torch.Generator] = None,
                  n_timesteps: int = 10, temperature: float = 0.667,
                  solver: str = "euler", x0: Optional[torch.Tensor] = None):
        """Batched style conversion.

        ``x0`` (``(B, Tr+Ts, output_dim)``, already scaled by temperature)
        replaces the ODE's noise draw from ``generator``.

        Returns ``(B, Ts, output_dim)`` f32 mels; frames beyond ``lengths``
        are padding.
        """
        b, ts, _ = x.shape
        tr = ref_x.shape[1]
        dt = self.dtype
        enc_src = self.encoder(x, lengths)
        enc_ref = self.encoder(ref_x, ref_lengths)
        spk = self.gst(ref_logmel, ref_lengths)

        zero_cond = torch.zeros((b, ts, self.output_dim), dtype=dt,
                                device=x.device)
        src_mu = torch.cat([p.to(dt) for p in (enc_src, midi, loud)]
                           + [zero_cond], dim=-1)
        ref_mu = torch.cat([p.to(dt) for p in (enc_ref, ref_midi, ref_loud,
                                               ref_logmel)], dim=-1)
        mu, total = pack_pair_time(ref_mu, ref_lengths, src_mu, lengths)
        mask = length_mask(total, tr + ts)[..., None]
        mel = self.cfm_decoder.inference(
            mu, mask, spk, n_timesteps=n_timesteps, temperature=temperature,
            generator=generator, solver=solver, x0=x0)
        return unpack_suffix_time(mel, ref_lengths, ts)
