"""NUSVC: the legacy NU SVCC T13 voice-conversion model (counterpart of
serenade_tpu/models/nusvc.py), the model the SSC system grew from.

The Conv1dResnet encoder (771 -> 384), a 1x1 conv to the mel's 80
channels, a GST style vector from the mel and a CFM(160 -> 80) whose UNet
runs at 256 channels with 4 heads of head dim 256: in bf16 its
self-attention takes K1 in inference and K4, K5 in the loss's backward,
at head dim 256.  As elsewhere in the port, the flow's times and noise
come in explicitly (``t``, ``z``, ``x0``) where a test holds it against
JAX's key; otherwise they are drawn from ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from serenade_tpu_torch.models.cfm import CFM
from serenade_tpu_torch.models.conv1d_resnet import Conv1dResnet
from serenade_tpu_torch.models.gst import StyleEncoder
from serenade_tpu_torch.models.layers import Conv1d, as_dtype
from serenade_tpu_torch.parallel.mesh import batch_sum
from serenade_tpu_torch.utils.masking import length_mask


class NUSVC(nn.Module):
    def __init__(self, input_dim: int = 771, output_dim: int = 80,
                 encoder_channels: int = 384, decoder_channels: int = 256,
                 gst_embed_dim: int = 256,
                 decoder_attention_head_dim: int = 256, dtype="bfloat16"):
        super().__init__()
        self.output_dim = output_dim
        self.dtype = as_dtype(dtype)
        self.encoder = Conv1dResnet(input_dim, encoder_channels,
                                    hidden_dim=512, num_layers=2,
                                    dtype=dtype)
        self.post_encoder = Conv1d(encoder_channels, output_dim, 1,
                                   padding=0, dtype=dtype)
        self.gst = StyleEncoder(idim=output_dim, gst_tokens=50,
                                gst_token_dim=gst_embed_dim,
                                conv_chans=(128, 128, 256, 256, 512, 512),
                                dtype=dtype)
        self.cfm_decoder = CFM(
            in_channels=output_dim * 2, out_channels=output_dim,
            spk_embed_dim=gst_embed_dim,
            decoder_channels=(decoder_channels, decoder_channels),
            decoder_attention_head_dim=decoder_attention_head_dim,
            dtype=dtype)

    def forward(self, x, lengths, logmel, *,
                t: Optional[torch.Tensor] = None,
                z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = True) -> Dict[str, torch.Tensor]:
        """Training losses (``serenade_tpu/models/nusvc.py:56-70``): x
        ``(B, T, input_dim)``, lengths ``(B,)``, logmel ``(B, T,
        output_dim)``; the flow times ``t`` ``(B,)`` and noise ``z`` of
        logmel's shape where given, else drawn from ``generator``, which
        also draws the dropout masks under ``train``.  Returns
        ``cfm_loss``, ``prior_loss`` (the masked Gaussian prior on the
        projected encoder output, in f32) and ``loss``."""
        T = x.shape[1]
        enc = self.post_encoder(self.encoder(x, lengths))
        spk = self.gst(logmel, lengths)
        mask = length_mask(lengths, T)[..., None]
        logmel_f = logmel.float()
        prior_loss = (0.5 * torch.square(logmel_f - enc.float()) * mask
                      ).sum() / (torch.clamp(batch_sum(mask.sum()), min=1.0)
                                 * self.output_dim)
        cfm_loss, _ = self.cfm_decoder.compute_loss(
            logmel_f, mask, enc, spk, t=t, z=z, generator=generator,
            train=train)
        return {"cfm_loss": cfm_loss, "prior_loss": prior_loss,
                "loss": cfm_loss + prior_loss}

    @torch.no_grad()
    def inference(self, x, lengths, ref_logmel, ref_lengths, *,
                  n_timesteps: int = 10, temperature: float = 0.667,
                  solver: str = "euler",
                  generator: Optional[torch.Generator] = None,
                  x0: Optional[torch.Tensor] = None):
        """Conversion of x ``(B, T, input_dim)`` into the style of
        ``ref_logmel`` ``(B, Tr, output_dim)``: the ODE from ``x0`` (``(B,
        T, output_dim)``, already scaled by temperature) or from noise
        drawn from ``generator``.  Returns ``(B, T, output_dim)`` f32 mels,
        valid under ``lengths``."""
        T = x.shape[1]
        enc = self.post_encoder(self.encoder(x, lengths))
        spk = self.gst(ref_logmel, ref_lengths)
        mask = length_mask(lengths, T)[..., None]
        return self.cfm_decoder.inference(
            enc, mask, spk, n_timesteps=n_timesteps, temperature=temperature,
            generator=generator, solver=solver, x0=x0)
