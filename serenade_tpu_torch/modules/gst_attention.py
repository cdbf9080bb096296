"""Multi-head attention variants of the GST module family (counterpart of
serenade_tpu/modules/gst_attention.py):

* ``MultiHeadedAttention``: q/k/v projections from inputs of their own
  widths to ``n_feat`` (the style token layer's dimension-adapting
  form), through ``ops.attention.multi_head_attention``;
* ``RelPositionMultiHeadedAttention``: Transformer-XL relative-position
  self-attention with the u/v bias vectors; the score of query q and key
  k takes the positional term at ``k - q + T - 1`` of a ``(1, 2T-1, C)``
  relative encoding;
* ``LegacyRelPositionMultiHeadedAttention``: the older ESPnet form, whose
  ``(1, T, C)`` positional matrix is read left-aligned, without the shift.

Nothing on the SSC path calls them (no kernel of the port runs here:
the relative-position scores are plain products in f32).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from serenade_tpu_torch.models.layers import Dense
from serenade_tpu_torch.ops.attention import multi_head_attention

NEG_INF = -1e30


class MultiHeadedAttention(nn.Module):
    def __init__(self, n_head: int = 4, n_feat: int = 256,
                 query_dim: Optional[int] = None,
                 key_dim: Optional[int] = None,
                 value_dim: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.n_head = n_head
        self.linear_q = Dense(query_dim or n_feat, n_feat, dtype=dtype)
        self.linear_k = Dense(key_dim or n_feat, n_feat, dtype=dtype)
        self.linear_v = Dense(value_dim or n_feat, n_feat, dtype=dtype)
        self.linear_out = Dense(n_feat, n_feat, dtype=dtype)

    def forward(self, query, key, value, key_mask=None):
        """query ``(B, Tq, query_dim)``, key/value ``(B, Tk, *_dim)``,
        key_mask ``(B, Tk)`` 1=valid -> ``(B, Tq, n_feat)``."""
        out = multi_head_attention(self.linear_q(query), self.linear_k(key),
                                   self.linear_v(value), num_heads=self.n_head,
                                   key_mask=key_mask)
        return self.linear_out(out)


class RelPositionMultiHeadedAttention(nn.Module):
    """Self-attention with relative positional encoding (u/v bias form)."""

    def __init__(self, n_head: int = 4, n_feat: int = 256,
                 dtype=torch.float32):
        super().__init__()
        self.n_head, self.n_feat = n_head, n_feat
        d = n_feat // n_head
        self.linear_q = Dense(n_feat, n_feat, dtype=dtype)
        self.linear_k = Dense(n_feat, n_feat, dtype=dtype)
        self.linear_v = Dense(n_feat, n_feat, dtype=dtype)
        self.linear_out = Dense(n_feat, n_feat, dtype=dtype)
        self.linear_pos = Dense(n_feat, n_feat, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, d))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, d))

    def _heads(self, x, pos_emb):
        """q ``(B, T, H, d)``; k, v and the projected positions ``(B|1, H,
        T|P, d)``."""
        b, t, _ = x.shape
        h, d = self.n_head, self.n_feat // self.n_head
        q = self.linear_q(x).reshape(b, t, h, d)
        k, v = (lin(x).reshape(b, t, h, d).transpose(1, 2)
                for lin in (self.linear_k, self.linear_v))
        p = self.linear_pos(pos_emb).reshape(
            pos_emb.shape[0], -1, h, d).transpose(1, 2)
        return q, k, v, p

    def _attend(self, ac, bd, v, key_mask):
        """softmax((ac + bd) / sqrt(d) + key bias) V, merged to
        ``(B, T, n_feat)`` and projected."""
        b, _, t, _ = v.shape
        scores = (ac + bd) * (self.n_feat // self.n_head) ** -0.5
        if key_mask is not None:
            scores = scores + (1.0 - key_mask.float())[:, None, None, :] \
                * NEG_INF
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
        return self.linear_out(out.transpose(1, 2).reshape(b, t,
                                                           self.n_feat))

    def forward(self, x, pos_emb, key_mask=None):
        """x ``(B, T, C)``; pos_emb ``(1, 2T-1, C)`` relative positions."""
        b, t, _ = x.shape
        q, k, v, p = self._heads(x, pos_emb)
        q_u = (q + self.pos_bias_u).transpose(1, 2)   # (B, H, T, d), f32
        q_v = (q + self.pos_bias_v).transpose(1, 2)
        ac = torch.einsum("bhqd,bhkd->bhqk", q_u, k.to(q_u.dtype))
        bd = torch.einsum("bhqd,bhpd->bhqp", q_v, p.to(q_v.dtype))
        # rel[q, k] = bd[q, k - q + T - 1]
        pos = torch.arange(t, device=x.device)
        idx = (pos[None, :] - pos[:, None] + t - 1).expand(
            b, self.n_head, t, t)
        return self._attend(ac, bd.gather(3, idx), v, key_mask)


class LegacyRelPositionMultiHeadedAttention(RelPositionMultiHeadedAttention):
    """Legacy ESPnet variant: pos_emb ``(1, T, C)``, left-aligned, no
    shift."""

    def forward(self, x, pos_emb, key_mask=None):
        t = x.shape[1]
        q, k, v, p = self._heads(x, pos_emb)
        q_u = (q + self.pos_bias_u).transpose(1, 2)
        q_v = (q + self.pos_bias_v).transpose(1, 2)
        ac = torch.einsum("bhqd,bhkd->bhqk", q_u, k.to(q_u.dtype))
        bd = torch.einsum("bhqd,bhkd->bhqk", q_v,
                          p[:, :, :t].to(q_v.dtype))
        return self._attend(ac, bd, v, key_mask)
