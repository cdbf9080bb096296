"""Serenade: flow-matching style conversion by infilling (counterpart of
serenade_tpu/models/serenade.py).

Training (``forward``) is masked segment infilling: a random contiguous
segment of 10-50 % of the batch's longest length is the CFM target and
the conditioning mel is zeroed inside it; a Gaussian prior loss ties the
content encoder to the mel.  Inference packs the reference clip with its
conditioning mel time-adjacent before the zero-conditioned source, the CFM
samples the joint sequence and the source part is returned; batch rows may
have different reference lengths.  ReFlow pair generation and the
F0-fluctuation variant (``fluc_channels > 0``) are not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from serenade_tpu_torch.models.cfm import CFM
from serenade_tpu_torch.models.conv1d_resnet import Conv1dResnet
from serenade_tpu_torch.models.gst import StyleEncoder
from serenade_tpu_torch.models.layers import as_dtype
from serenade_tpu_torch.ops.sequence import pack_pair_time, unpack_suffix_time
from serenade_tpu_torch.utils.masking import length_mask

# accepted for config compatibility: cfg_prob is unused by the reference
# too, and remat is not ported
_ACCEPTED = ("cfg_prob", "remat")
LOG_2PI = math.log(2.0 * math.pi)


class Serenade(nn.Module):
    def __init__(self, input_dim: int = 768, output_dim: int = 80,
                 encoder_channels: int = 80, encoder_hidden_dim: int = 512,
                 decoder_channels: int = 512, gst_embed_dim: int = 256,
                 decoder_attention_head_dim: int = 512,
                 fluc_channels: int = 0,
                 gst_norm_type: str = "masked_group", gst_tokens: int = 50,
                 gst_conv_chans: Tuple[int, ...] = (128, 128, 256, 256, 512,
                                                    512),
                 gst_gru_units: int = 128,
                 mask_size: Tuple[float, float] = (0.1, 0.5),
                 dropout: float = 0.05, dtype="bfloat16", **accepted):
        super().__init__()
        unknown = set(accepted) - set(_ACCEPTED)
        if unknown:
            raise TypeError(f"unknown Serenade parameters {sorted(unknown)}")
        if fluc_channels:
            raise NotImplementedError("the F0-fluctuation variant is not "
                                      "ported yet")
        self.output_dim = output_dim
        self.mask_size = tuple(mask_size)
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
            dropout=dropout, dtype=dtype)

    def forward(self, x, lengths, logmel, midi, loud, *,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """Training losses (``serenade_tpu/models/serenade.py:100-166``).

        x ``(B, T, input_dim)``, lengths ``(B,)``, logmel
        ``(B, T, output_dim)`` normalized target mels, midi and loud
        ``(B, T, 1)``.  The segment fraction and start, the flow times and
        the noise come from ``draws`` (``frac``, ``start`` scalars in
        [0, 1), ``t`` ``(B,)``, ``z`` ``(B, T, output_dim)``) where given,
        else from ``generator``, which also draws the dropout masks.

        Returns ``cfm_loss``, ``prior_loss``, ``gauss_mel`` (the encoder
        output) and ``loss``.
        """
        b, T, _ = x.shape
        dev = x.device
        draws = draws or {}
        enc_outs = self.encoder(x, lengths)
        spk = self.gst(logmel, lengths)
        mask = length_mask(lengths, T)[..., None]

        # random contiguous infill segment, scaled by the batch max length
        maxlen = lengths.max()
        lo, hi = self.mask_size
        frac = draws.get("frac")
        if frac is None:
            frac = lo + (hi - lo) * torch.rand((), generator=generator,
                                               device=dev)
        start = draws.get("start")
        if start is None:
            start = torch.rand((), generator=generator, device=dev)
        frac = torch.as_tensor(frac, dtype=torch.float32, device=dev)
        start = torch.as_tensor(start, dtype=torch.float32, device=dev)
        seg_len = torch.floor(frac * maxlen).to(torch.int32)
        seg_start = torch.floor(start * (maxlen - seg_len + 1)).to(
            torch.int32)
        pos = torch.arange(T, device=dev)[None, :, None]
        in_seg = ((pos >= seg_start) & (pos < seg_start + seg_len)).to(
            mask.dtype)
        mask_l = mask * in_seg           # loss mask: inside the segment
        mask_c = mask * (1.0 - in_seg)   # conditioning: outside it

        logmel_f = logmel.float()
        prior = 0.5 * (torch.square(logmel_f - enc_outs.float()) + LOG_2PI)
        prior_loss = (prior * mask).sum() / (
            torch.clamp(mask.sum(), min=1.0) * self.output_dim)

        dt = self.dtype
        mu = torch.cat([p.to(dt) for p in (enc_outs, midi, loud,
                                           logmel_f * mask_c)], dim=-1)
        cfm_loss, _ = self.cfm_decoder.compute_loss(
            logmel_f * mask_l, mask, mu, spk, mask_l=mask_l,
            t=draws.get("t"), z=draws.get("z"), generator=generator,
            train=True)
        return {"cfm_loss": cfm_loss, "prior_loss": prior_loss,
                "gauss_mel": enc_outs, "loss": cfm_loss + prior_loss}

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
