"""Global Style Token encoder (counterpart of serenade_tpu/models/gst.py).

Six stride-2 conv2d + norm + ReLU over the (time, mel) plane, a masked GRU
(or masked attention pooling) over time, then 50 style tokens attended by
the reference embedding with 4 heads.  The conv stack runs NCHW inside;
the flattened features follow the JAX package's (time, freq, channel)
order so converted GRU weights apply unchanged.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from serenade_tpu_torch.models.layers import (
    Conv2d, Dense, NormParams, as_dtype,
)
from serenade_tpu_torch.ops.attention import multi_head_attention


class MaskedGRU(nn.Module):
    """Unidirectional GRU that freezes its state at padded steps; returns
    the hidden state at each sequence's last valid step.  Runs in f32 with
    torch's gate layout (r, z, n).  Like flax's ``GRUCell`` the hidden
    projection has a bias for the n gate only (``bias_hn``), so training
    updates the same degrees of freedom as JAX."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.bias_hn = nn.Parameter(torch.zeros(hidden))
        self.hidden = hidden

    def forward(self, x, mask):
        """x ``(B, T, C)``; mask ``(B, T)`` 1=valid. Returns ``(B, hidden)``."""
        gi_all = F.linear(x.float(), self.weight_ih, self.bias_ih)
        h = x.new_zeros((x.shape[0], self.hidden), dtype=torch.float32)
        for t in range(x.shape[1]):
            gi = gi_all[:, t]
            gh = F.linear(h, self.weight_hh)
            i_r, i_z, i_n = gi.chunk(3, dim=-1)
            h_r, h_z, h_n = gh.chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * (h_n + self.bias_hn))
            new = (1.0 - z) * n + z * h
            keep = mask[:, t, None].float()
            h = new * keep + h * (1.0 - keep)
        return h


class MaskedGroupNorm2d(NormParams):
    """GroupNorm over (time, freq, C/group) with padded time excluded."""

    def __init__(self, features: int, num_groups: int, epsilon: float = 1e-5,
                 dtype=torch.float32):
        super().__init__(features)
        self.num_groups, self.epsilon = num_groups, epsilon
        self.dtype = as_dtype(dtype)

    def forward(self, x, t_len):
        """x ``(B, C, T, F)``; t_len ``(B,)`` valid time steps."""
        b, c, t, f = x.shape
        g = self.num_groups
        xf = x.float().reshape(b, g, c // g, t, f)
        m = (torch.arange(t, device=x.device)[None, :] < t_len[:, None]
             ).float()[:, None, None, :, None]
        denom = torch.clamp(m.sum(dim=(1, 2, 3, 4), keepdim=True)
                            * f * (c // g), min=1.0)
        mean = (xf * m).sum(dim=(2, 3, 4), keepdim=True) / denom
        var = (torch.square(xf - mean) * m).sum(dim=(2, 3, 4),
                                                keepdim=True) / denom
        y = ((xf - mean) * torch.rsqrt(var + self.epsilon)).reshape(b, c, t, f)
        y = y * self.scale[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class FrozenBatchNorm2d(nn.Module):
    """Inference BatchNorm2d with running statistics (torch-checkpoint
    mode, ``norm_type='frozen_batch'``)."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.epsilon = epsilon
        self.dtype = as_dtype(dtype)

    def forward(self, x, t_len=None):
        rstd = torch.rsqrt(self.var + self.epsilon)
        inv = (self.scale * rstd).to(self.dtype)
        shift = (self.bias - self.mean * self.scale * rstd).to(self.dtype)
        return x * inv[:, None, None] + shift[:, None, None]


class ReferenceEncoder(nn.Module):
    def __init__(self, idim: int = 80,
                 conv_chans: Tuple[int, ...] = (128, 128, 256, 256, 512, 512),
                 kernel_size: int = 3, stride: int = 2, gru_units: int = 128,
                 norm_type: str = "masked_group", pooling: str = "gru",
                 dtype=torch.float32):
        super().__init__()
        self.dtype = as_dtype(dtype)
        self.stride, self.pooling = stride, pooling
        self.n_convs = len(conv_chans)
        cin, freq = 1, idim
        for i, ch in enumerate(conv_chans):
            # bias-free, stride 2, same padding
            setattr(self, f"conv{i}", Conv2d(
                cin, ch, (kernel_size,) * 2, stride=(stride,) * 2,
                padding=((kernel_size - 1) // 2,) * 2, bias=False,
                dtype=dtype))
            setattr(self, f"norm{i}",
                    FrozenBatchNorm2d(ch, dtype=dtype)
                    if norm_type == "frozen_batch" else
                    MaskedGroupNorm2d(ch, min(8, ch), dtype=dtype))
            cin = ch
            freq = (freq + stride - 1) // stride
        feat = freq * conv_chans[-1]
        if pooling == "attention":
            self.pool_proj = Dense(feat, gru_units, dtype=dtype)
            self.pool_score = Dense(feat, 1)
        else:
            self.gru = MaskedGRU(feat, gru_units)

    def forward(self, mel, lengths=None):
        """mel ``(B, T, idim)`` -> ``(B, gru_units)``."""
        b, T, _ = mel.shape
        x = mel.to(self.dtype)[:, None]            # (B, 1, T, F)
        t_len = (lengths.long() if lengths is not None else
                 torch.full((b,), T, dtype=torch.long, device=mel.device))
        for i in range(self.n_convs):
            x = getattr(self, f"conv{i}")(x)
            t_len = (t_len + self.stride - 1) // self.stride
            x = torch.relu(getattr(self, f"norm{i}")(x, t_len))
        bt = x.shape[2]
        feats = x.permute(0, 2, 3, 1).reshape(b, bt, -1)   # (B, T', F'*C)
        step_mask = (torch.arange(bt, device=mel.device)[None, :]
                     < t_len[:, None]).float()
        if self.pooling == "attention":
            h = self.pool_proj(feats)
            logits = self.pool_score(feats)[..., 0]
            logits = torch.where(step_mask > 0, logits,
                                 torch.full_like(logits, -1e30))
            w = torch.softmax(logits, dim=1)
            return torch.einsum("bt,btc->bc", w.to(h.dtype), h)
        return self.gru(feats, step_mask)


class StyleTokenLayer(nn.Module):
    def __init__(self, ref_embed_dim: int = 128, gst_tokens: int = 50,
                 gst_token_dim: int = 256, gst_heads: int = 4,
                 dtype=torch.float32):
        super().__init__()
        token_dim = gst_token_dim // gst_heads
        self.gst_embs = nn.Parameter(torch.empty(gst_tokens, token_dim))
        self.gst_heads = gst_heads
        self.dtype = as_dtype(dtype)
        self.linear_q = Dense(ref_embed_dim, gst_token_dim, dtype=dtype)
        self.linear_k = Dense(token_dim, gst_token_dim, dtype=dtype)
        self.linear_v = Dense(token_dim, gst_token_dim, dtype=dtype)
        self.linear_out = Dense(gst_token_dim, gst_token_dim, dtype=dtype)

    def forward(self, ref_embs):
        """``(B, ref_embed_dim) -> (B, gst_token_dim)``."""
        b = ref_embs.shape[0]
        keys = torch.tanh(self.gst_embs)[None].expand(b, -1, -1)
        q = self.linear_q(ref_embs[:, None, :])
        out = multi_head_attention(q, self.linear_k(keys),
                                   self.linear_v(keys),
                                   num_heads=self.gst_heads)
        return self.linear_out(out)[:, 0, :]


class StyleEncoder(nn.Module):
    """mel ``(B, T, idim)`` -> style embedding ``(B, gst_token_dim)``."""

    def __init__(self, idim: int = 80, gst_tokens: int = 50,
                 gst_token_dim: int = 256, gst_heads: int = 4,
                 conv_chans: Tuple[int, ...] = (128, 128, 256, 256, 512, 512),
                 gru_units: int = 128, norm_type: str = "masked_group",
                 pooling: str = "gru", dtype=torch.float32):
        super().__init__()
        self.ref_enc = ReferenceEncoder(idim, tuple(conv_chans),
                                        gru_units=gru_units,
                                        norm_type=norm_type, pooling=pooling,
                                        dtype=dtype)
        self.stl = StyleTokenLayer(gru_units, gst_tokens, gst_token_dim,
                                   gst_heads, dtype=dtype)

    def forward(self, mel, lengths=None):
        return self.stl(self.ref_enc(mel, lengths))
