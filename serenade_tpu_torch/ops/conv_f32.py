"""1-D convolution as windows times a matrix, for the feature path.

The feature path (``ops/resample.py``, ``modules/contentvec.py``) computes
in f32 as the JAX package does.  On the card PyTorch runs a float32
matmul in full f32 by default (``torch.get_float32_matmul_precision()`` is
"highest"), while a float32 convolution goes through cuDNN in TF32
(``torch.backends.cudnn.allow_tf32`` defaults to True).  Both switches are
process-wide, shared by a server's dispatcher and HTTP threads, so the
feature path sets neither: its convolutions are written here as strided
windows of the input times the kernel as a matrix, which is a matmul.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# bytes of the window copy one matmul may take: long inputs go in chunks
# of time
MAX_WINDOW_BYTES = 1 << 28


def conv1d_f32(x, weight, bias=None, *, stride: int = 1,
               padding=(0, 0), groups: int = 1):
    """Convolution (cross-correlation, as flax's ``nn.Conv`` and XLA's
    ``conv_general_dilated``) of ``x`` ``(B, T, Cin)`` by ``weight``
    ``(Cout, Cin/groups, K)``, ``padding`` zeros before and after;
    returns ``(B, T', Cout)`` in f32."""
    if padding != (0, 0):
        x = F.pad(x, (0, 0, padding[0], padding[1]))
    b, t, c = x.shape
    o, cg, k = weight.shape
    g = groups
    n_out = (t - k) // stride + 1
    # (g, cg * K, o / g): rows ordered (input channel, tap) as the windows
    wmat = (weight.float().reshape(g, o // g, cg * k).transpose(1, 2))
    windows = x.float().unfold(1, k, stride)            # (B, n_out, C, K)
    rows = max(1, MAX_WINDOW_BYTES // (b * c * k * 4))
    outs = []
    for s in range(0, n_out, rows):
        w = windows[:, s:s + rows]
        r = w.shape[1]
        a = w.reshape(b * r, g, cg * k).transpose(0, 1)  # (g, B*r, cg*K)
        y = torch.bmm(a, wmat)                          # (g, B*r, o/g)
        outs.append(y.transpose(0, 1).reshape(b, r, o))
    y = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return y if bias is None else y + bias.float()
