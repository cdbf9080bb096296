"""Transformer block of the CFM UNet (counterpart of
serenade_tpu/models/transformer.py): pre-LN self-attention + GEGLU FFN,
with dropout after the GEGLU and after the attention output projection
when ``train`` is set.

With the shipped config the block has no cross-attention and ``act_fn``
"snake" resolves to GEGLU, as in the JAX package; the ``snakebeta`` and
style cross-attention options are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from serenade_tpu_torch.models.layers import Dense, LayerNorm, dropout
from serenade_tpu_torch.ops.attention import multi_head_attention


class GEGLU(nn.Module):
    """value ⊙ gelu(gate) with exact (erf) GELU, which PyTorch computes in
    f32 for bf16 inputs."""

    def __init__(self, dim: int, features: int, dtype=torch.float32):
        super().__init__()
        self.proj = Dense(dim, features * 2, dtype=dtype)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.act = GEGLU(dim, dim * mult, dtype=dtype)
        self.out = Dense(dim * mult, dim, dtype=dtype)
        self.dropout = dropout

    def forward(self, x, *, train: bool = False, generator=None):
        h = self.act(x)
        if train:
            h = dropout(h, self.dropout, generator)
        return self.out(h)


class Attention(nn.Module):
    """Self-attention head stack: no qkv bias, ``to_out`` with a bias."""

    def __init__(self, query_dim: int, heads: int = 4, head_dim: int = 512,
                 dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.dropout = dropout
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)

    def forward(self, x, key_mask=None, *, train: bool = False,
                generator=None):
        out = multi_head_attention(self.to_q(x), self.to_k(x), self.to_v(x),
                                   num_heads=self.heads, key_mask=key_mask)
        out = self.to_out(out)
        return dropout(out, self.dropout, generator) if train else out


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_attention_heads: int = 4,
                 attention_head_dim: int = 512, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn1 = Attention(dim, num_attention_heads, attention_head_dim,
                               dropout=dropout, dtype=dtype)
        self.norm3 = LayerNorm(dim, dtype=dtype)
        self.ff = FeedForward(dim, dropout=dropout, dtype=dtype)

    def forward(self, x, key_mask=None, *, train: bool = False,
                generator=None):
        x = x + self.attn1(self.norm1(x), key_mask=key_mask, train=train,
                           generator=generator)
        return x + self.ff(self.norm3(x), train=train, generator=generator)
