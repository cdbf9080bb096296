"""Transformer block of the CFM UNet (counterpart of
serenade_tpu/models/transformer.py): pre-LN self-attention + FFN, with
dropout after the activation and after the attention output projection
when ``train`` is set.

With the shipped config the block has no cross-attention and ``act_fn``
"snake" resolves to GEGLU, as in the JAX package.  The options:
``activation_fn="snakebeta"`` (a real SnakeBeta), ``use_style_cross_attn``
(``norm2`` and ``attn2`` over the style vector as a one-token context)
and the fused QKV projection (``SERENADE_FUSE_QKV=1``, read by
``default_fuse_qkv`` as JAX reads it).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from serenade_tpu_torch.models.layers import Dense, LayerNorm, dropout
from serenade_tpu_torch.ops.attention import multi_head_attention


def default_fuse_qkv() -> bool:
    """The opt-in fused QKV projection (``SERENADE_FUSE_QKV=1``): the three
    self-attention projections run as one ``(C, 3·inner)`` product whose
    q, k and v are views of the result, with the parameters unchanged
    (``to_q``, ``to_k``, ``to_v``)."""
    return os.environ.get("SERENADE_FUSE_QKV", "0") == "1"


class SnakeBeta(nn.Module):
    """``x + sin²(αx) / β`` after a linear projection, with log-scale
    learnable α and β, in f32 (``serenade_tpu/models/transformer.py:58``)."""

    def __init__(self, dim: int, features: int, dtype=torch.float32):
        super().__init__()
        self.proj = Dense(dim, features, dtype=dtype)
        self.alpha = nn.Parameter(torch.zeros(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = self.proj(x).float()
        a, b = torch.exp(self.alpha.float()), torch.exp(self.beta.float())
        y = xf + (1.0 / (b + 1e-9)) * torch.square(torch.sin(xf * a))
        return y.to(self.proj.dtype)


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
    """4x-wide FFN: ``activation_fn`` "snakebeta" selects SnakeBeta,
    anything else (the reference's "snake" included) GEGLU, as in JAX."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 activation_fn: str = "geglu", dtype=torch.float32):
        super().__init__()
        act = SnakeBeta if activation_fn == "snakebeta" else GEGLU
        self.act = act(dim, dim * mult, dtype=dtype)
        self.out = Dense(dim * mult, dim, dtype=dtype)
        self.dropout = dropout

    def forward(self, x, *, train: bool = False, generator=None):
        h = self.act(x)
        if train:
            h = dropout(h, self.dropout, generator)
        return self.out(h)


class Attention(nn.Module):
    """Self- or cross-attention head stack: no qkv bias, ``to_out`` with a
    bias.  Self-attention under ``default_fuse_qkv()`` takes one product
    of x and the three weights side by side, unless the weights are int8
    (the three int8 products then run unfused, as JAX's ``QTensor``
    branch does)."""

    def __init__(self, query_dim: int, heads: int = 4, head_dim: int = 512,
                 dropout: float = 0.0, context_dim: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.dropout = dropout
        context_dim = context_dim or query_dim
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)

    def forward(self, x, key_mask=None, *, context=None, train: bool = False,
                generator=None):
        if (context is None and default_fuse_qkv()
                and self.to_q.weight_q is None):
            dt = self.to_q.dtype
            w = torch.cat([self.to_q.weight, self.to_k.weight,
                           self.to_v.weight]).to(dt)
            q, k, v = F.linear(x.to(dt), w).chunk(3, dim=-1)
        else:
            ctx = x if context is None else context
            q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        out = multi_head_attention(q, k, v, num_heads=self.heads,
                                   key_mask=key_mask)
        out = self.to_out(out)
        return dropout(out, self.dropout, generator) if train else out


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention, then (``use_style_cross_attn``) attention to
    the style vector of ``style_dim`` channels (default ``dim``), then the
    FFN, each residual."""

    def __init__(self, dim: int, num_attention_heads: int = 4,
                 attention_head_dim: int = 512, dropout: float = 0.0,
                 activation_fn: str = "snake",
                 use_style_cross_attn: bool = False,
                 style_dim: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn1 = Attention(dim, num_attention_heads, attention_head_dim,
                               dropout=dropout, dtype=dtype)
        if use_style_cross_attn:
            self.norm2 = LayerNorm(dim, dtype=dtype)
            self.attn2 = Attention(dim, num_attention_heads,
                                   attention_head_dim, dropout=dropout,
                                   context_dim=style_dim, dtype=dtype)
        self.use_style_cross_attn = use_style_cross_attn
        self.norm3 = LayerNorm(dim, dtype=dtype)
        self.ff = FeedForward(dim, dropout=dropout,
                              activation_fn=activation_fn, dtype=dtype)

    def forward(self, x, key_mask=None, *, style=None, train: bool = False,
                generator=None):
        """``style`` ``(B, C_style)``: the context of the style
        cross-attention, a single token (non-square attention, which
        takes the plain route uncounted)."""
        drop = dict(train=train, generator=generator)
        x = x + self.attn1(self.norm1(x), key_mask=key_mask, **drop)
        if self.use_style_cross_attn and style is not None:
            x = x + self.attn2(self.norm2(x), context=style[:, None, :],
                               **drop)
        return x + self.ff(self.norm3(x), **drop)
