"""1-D UNet flow estimator (counterpart of serenade_tpu/models/unet.py).

Channels-last, T even, masks halve as ``m[:, ::2]``.  With
``channels=(512, 512)`` one evaluation runs 13 Block1Ds and 6 transformer
blocks.  Block1D goes through the fused Block1D wrapper: the CUDA kernel
on the card, its plain version on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from serenade_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    Dense,
    NormParams,
    SpeakerAdaLayerNorm,
    TimestepEmbedding,
    as_dtype,
    mish,
    sinusoidal_time_embedding,
)
from serenade_tpu_torch.models.transformer import BasicTransformerBlock
from serenade_tpu_torch.ops.block1d_cuda import block1d


class Block1D(nn.Module):
    """conv(k3) → masked GroupNorm(8) → Mish, masked."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv1d(dim_in, dim_out, 3, dtype=dtype)
        self.norm = NormParams(dim_out)
        self.groups = groups
        self.dtype = as_dtype(dtype)

    def forward(self, x, mask):
        dt = self.dtype
        return block1d(x.to(dt), mask, self.conv.weight, self.conv.bias,
                       self.norm.scale, self.norm.bias, groups=self.groups)


class ResnetBlock1D(nn.Module):
    """Two Block1Ds with a time-embedding injection, a 1x1 residual conv
    and SpeakerAdapter conditioning of the output."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int,
                 spk_dim: int, groups: int = 8, dtype=torch.float32):
        super().__init__()
        self.block1 = Block1D(dim_in, dim_out, groups, dtype=dtype)
        self.time_mlp = Dense(time_dim, dim_out, dtype=dtype)
        self.block2 = Block1D(dim_out, dim_out, groups, dtype=dtype)
        self.res_conv = Conv1d(dim_in, dim_out, 1, padding=0, dtype=dtype)
        self.speaker_adapter = SpeakerAdaLayerNorm(dim_out, spk_dim,
                                                   dtype=dtype)

    def forward(self, x, mask, t_emb, spk):
        h = self.block1(x, mask)
        h = h + self.time_mlp(mish(t_emb))[:, None, :]
        h = self.block2(h, mask)
        out = h + self.res_conv(x * mask)
        return self.speaker_adapter(out, spk)


class Decoder(nn.Module):
    """``(x, mask, mu, t, spk) -> v``: x ``(B,T,out)``, mask ``(B,T,1)``,
    mu ``(B,T,in-out)``, t ``(B,)`` or scalar, spk ``(B,spk_dim)``.
    ``act_fn`` is every transformer block's FFN activation ("snakebeta",
    or GEGLU for anything else)."""

    def __init__(self, in_channels: int, out_channels: int,
                 channels: Tuple[int, ...] = (512, 512),
                 attention_head_dim: int = 512, num_heads: int = 4,
                 num_mid_blocks: int = 2, spk_dim: int = 256,
                 dropout: float = 0.05, act_fn: str = "snake",
                 dtype=torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.dtype = as_dtype(dtype)
        time_dim = channels[0] * 4
        self.time_mlp = TimestepEmbedding(in_channels, time_dim, dtype=dtype)
        self.n_levels = len(channels)
        self.num_mid_blocks = num_mid_blocks

        def tx(dim):
            return BasicTransformerBlock(dim, num_heads, attention_head_dim,
                                         dropout=dropout,
                                         activation_fn=act_fn, dtype=dtype)

        def resnet(cin, cout):
            return ResnetBlock1D(cin, cout, time_dim, spk_dim, dtype=dtype)

        cin = in_channels
        for i, ch in enumerate(channels):
            is_last = i == len(channels) - 1
            setattr(self, f"down{i}_resnet", resnet(cin, ch))
            setattr(self, f"down{i}_tx0", tx(ch))
            setattr(self, f"down{i}_downsample",
                    Conv1d(ch, ch, 3, dtype=dtype) if is_last else
                    Conv1d(ch, ch, 3, stride=2, padding=1, dtype=dtype))
            cin = ch
        for i in range(num_mid_blocks):
            setattr(self, f"mid{i}_resnet", resnet(channels[-1], channels[-1]))
            setattr(self, f"mid{i}_tx0", tx(channels[-1]))
        up = tuple(reversed(channels)) + (channels[0],)
        for i in range(len(up) - 1):
            is_last = i == len(up) - 2
            ch = up[i + 1]
            setattr(self, f"up{i}_resnet",
                    resnet(up[i] + channels[-1 - i], ch))
            setattr(self, f"up{i}_tx0", tx(ch))
            setattr(self, f"up{i}_upsample",
                    Conv1d(ch, ch, 3, dtype=dtype) if is_last else
                    ConvTranspose1d(ch, ch, 4, stride=2, padding=1,
                                    dtype=dtype))
        self.final_block = Block1D(up[-1], up[-1], dtype=dtype)
        self.final_proj = Conv1d(up[-1], out_channels, 1, padding=0,
                                 dtype=dtype)

    def forward(self, x, mask, mu, t, spk, *, train: bool = False,
                generator=None):
        """``train`` turns on the transformer blocks' dropout, its masks
        drawn from ``generator``."""
        b, T, _ = x.shape
        drop = dict(train=train, generator=generator)
        assert T % 2 == 0, "bucketed time must be even for the UNet downsample"
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        t_emb = self.time_mlp(
            sinusoidal_time_embedding(t.expand(b), self.in_channels))
        h = torch.cat([x, mu.to(x.dtype)], dim=-1).to(self.dtype)

        masks, hiddens = [mask], []
        for i in range(self.n_levels):
            m = masks[-1]
            h = getattr(self, f"down{i}_resnet")(h, m, t_emb, spk)
            h = getattr(self, f"down{i}_tx0")(h, key_mask=m[:, :, 0], **drop)
            hiddens.append(h)
            h = getattr(self, f"down{i}_downsample")(h * m)
            if i < self.n_levels - 1:
                masks.append(m[:, ::2, :])
        m = masks[-1]
        for i in range(self.num_mid_blocks):
            h = getattr(self, f"mid{i}_resnet")(h, m, t_emb, spk)
            h = getattr(self, f"mid{i}_tx0")(h, key_mask=m[:, :, 0], **drop)
        for i in range(self.n_levels):
            m = masks.pop()
            h = torch.cat([h, hiddens.pop()], dim=-1)
            h = getattr(self, f"up{i}_resnet")(h, m, t_emb, spk)
            h = getattr(self, f"up{i}_tx0")(h, key_mask=m[:, :, 0], **drop)
            h = getattr(self, f"up{i}_upsample")(h * m)
        h = self.final_block(h, mask)
        out = self.final_proj(h * mask)
        return (out * mask).float()
