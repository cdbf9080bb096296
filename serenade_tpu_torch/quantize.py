"""int8 quantization for inference serving (counterpart of
serenade_tpu/quantize.py).

Per-output-channel symmetric int8 of the large weights, with JAX's
arithmetic in f32: ``scale = max(absmax, 1e-12) / 127`` over every axis
but the channel's, ``q = clip(round(w / scale), -127, 127)`` (round half
to even).  Two modes, as the JAX Converter has them:

- ``"int8"`` (``quantize_tree``): every floating weight of two or more
  dimensions and at least ``MIN_QUANT_SIZE`` elements.  The Converter keeps
  the int8 values and scales on the device and dequantizes them once per
  conversion (``api.Converter.weights``); an exported artifact holds them
  as int8 constants and dequantizes inside its program (``deploy.py``).
- ``"int8_compute"`` (``quantize_dense_tree``): only the estimator's 2-D
  Dense weights, which then stay int8 inside the ODE: ``int8_dot``
  quantizes the activations per row and contracts int8 x int8 into int32.

Eligibility and the channel axis are decided per flax leaf of the JAX
package's tree, through the parameter bridge (``convert.flax_leaf_layout``):
a fused GRU weight holds three flax gate kernels, and each transposed
layout keeps JAX's output channel on its own axis.  So the leaves chosen
and ``quantized_bytes`` equal JAX's on the same parameters.

On CUDA ``int8_dot``'s product is ``torch._int_mm`` (JAX computes it with
``lax.dot_general`` outside any Pallas kernel); the shapes it refuses (16
rows or fewer, a contraction or output width not a multiple of 8) take the
exact plain version and count in ``routed``.  The plain version, on the
CPU and for those shapes, multiplies in f64, which holds every int8 x int8
sum exactly up to 2^53 (an f32 product would not: the sums reach 16,129
times the contraction length).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Union

import torch

# tensors smaller than this stay float: norms, biases and small tables
# move few bytes and are sensitive to quantization
MIN_QUANT_SIZE = 4096

# int8_dot calls since the last reset that ran torch._int_mm on CUDA, and
# those on CUDA whose shape it refuses (sent to the plain version)
launches = 0
routed = 0


class QTensor:
    """int8 values and f32 per-channel scales (symmetric, zero point 0).
    ``scale`` keeps the weight's rank with size-1 axes everywhere but the
    channel's, so ``q * scale`` broadcasts back to the weight's shape."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):  # what it dequantizes to (for shape and dtype probes)
        return torch.float32

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return self.q.to(dtype) * self.scale.to(dtype)

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device))

    def __repr__(self):
        return f"QTensor(shape={tuple(self.q.shape)}, int8)"


State = Dict[str, Union[torch.Tensor, QTensor]]


def quantize_leaf(w, axis: int = -1) -> QTensor:
    """Symmetric int8 of one weight per channel along ``axis`` (JAX's
    flax layouts put the output channel last, hence the default)."""
    w = torch.as_tensor(w).float()
    axis %= w.dim()
    absmax = torch.amax(w.abs(), dim=[d for d in range(w.dim()) if d != axis],
                        keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def _eligible(w: torch.Tensor, n_leaves: int, min_size: int) -> bool:
    """JAX's rule, applied to each of the ``n_leaves`` flax leaves ``w``
    is made of: floating, two or more dimensions, ``min_size`` elements."""
    return (w.is_floating_point() and w.dim() >= 2
            and w.numel() // n_leaves >= min_size)


def quantize_tree(module: torch.nn.Module) -> State:
    """``module``'s state dict with every eligible weight replaced by its
    :class:`QTensor`."""
    from serenade_tpu_torch.convert import flax_leaf_layout

    layout = flax_leaf_layout(module)
    out = {}
    for name, w in module.state_dict().items():
        axis, n_leaves = layout[name]
        out[name] = (quantize_leaf(w, axis)
                     if _eligible(w, n_leaves, MIN_QUANT_SIZE) else w)
    return out


def quantize_dense_tree(module: torch.nn.Module, subtree: str = "estimator",
                        min_size: int = MIN_QUANT_SIZE) -> State:
    """The ``int8_compute`` mode: only the 2-D ``kernel`` leaves under
    ``subtree`` (the UNet estimator's Dense weights, which
    ``models.layers.Dense.use_int8_`` turns into int8 products) become
    :class:`QTensor`\\ s; everything else stays float."""
    from serenade_tpu_torch.convert import flax_leaf_layout, flax_paths

    layout = flax_leaf_layout(module)
    paths = flax_paths(module)
    out = {}
    for name, w in module.state_dict().items():
        parts = paths[name][0].split("/")
        axis, n_leaves = layout[name]
        take = (subtree in parts and parts[-1] == "kernel" and w.dim() == 2
                and _eligible(w, n_leaves, min_size))
        out[name] = quantize_leaf(w, axis) if take else w
    return out


def dequantize_tree(state: Mapping, dtype=torch.float32) -> dict:
    """A float state dict from a (partly) quantized one; the identity on
    float tensors."""
    return {k: v.dequantize(dtype) if isinstance(v, QTensor) else v
            for k, v in state.items()}


def quantized_bytes(state: Mapping) -> int:
    """Parameter bytes as stored: int8 values and f32 scales of each
    :class:`QTensor`, the rest at their own width."""
    return sum(v.q.numel() + v.scale.numel() * 4 if isinstance(v, QTensor)
               else v.numel() * v.element_size() for v in state.values())


def quantize_rows(x: torch.Tensor):
    """Dynamic per-row int8 of activations: (``xq`` int8, ``s_x`` f32 of
    shape ``x.shape[:-1] + (1,)``)."""
    xf = x.float()
    s_x = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
    xq = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    return xq, s_x


def int8_matmul_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (m, k) @ w (n, k)ᵀ`` of int8 operands as exact int32 sums, on
    any device (an f64 product: every partial sum is an integer below
    2^53)."""
    return torch.matmul(a.double(), w.double().t()).to(torch.int32)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int32 ``a (m, k) @ w (n, k)ᵀ``: ``torch._int_mm`` on CUDA where it
    takes the shape, else the plain version (counted in ``routed`` on
    CUDA)."""
    global launches, routed
    if not a.is_cuda:
        return int8_matmul_plain(a, w)
    m, k = a.shape
    if m > 16 and k % 8 == 0 and w.shape[0] % 8 == 0:
        launches += 1
        return torch._int_mm(a.contiguous(), w.t())
    routed += 1
    return int8_matmul_plain(a, w)


def int8_dot(x: torch.Tensor, qt: QTensor, dtype=torch.float32):
    """``x (..., in)`` against a quantized Dense weight ``(out, in)`` (the
    port's layout; scales ``(out, 1)``): the activations quantized per row,
    an int8 x int8 product into int32, rescaled by ``s_x ⊗ w_scale`` in
    f32, as JAX's ``int8_dot`` computes it; returned in ``dtype``."""
    assert qt.q.dim() == 2, f"int8_dot wants a 2-D weight, got {qt.shape}"
    xq, s_x = quantize_rows(x)
    y = int8_matmul(xq.reshape(-1, xq.shape[-1]), qt.q)
    y = y.reshape(*x.shape[:-1], -1)
    return (y.float() * s_x * qt.scale.reshape(-1)).to(dtype)


def split_quantized(state: Mapping) -> Dict[str, QTensor]:
    """The :class:`QTensor` entries of a (partly) quantized state."""
    return {k: v for k, v in state.items() if isinstance(v, QTensor)}


def remove_parameters_(module: torch.nn.Module, names) -> None:
    """Drop the named parameters' float storage (their QTensors hold them);
    ``bound_parameters`` puts tensors in their place for a call."""
    for name in names:
        mod_name, _, key = name.rpartition(".")
        module.get_submodule(mod_name)._parameters[key] = None


@contextlib.contextmanager
def bound_parameters(module: torch.nn.Module, tensors: Mapping):
    """Bind each ``name -> tensor`` as a parameter of ``module`` (one that
    ``remove_parameters_`` dropped) for the duration, then drop it again.
    Not thread-safe: the caller holds a lock around it."""
    slots = []
    for name, t in tensors.items():
        mod_name, _, key = name.rpartition(".")
        slots.append((module.get_submodule(mod_name)._parameters, key))
        slots[-1][0][key] = t
    try:
        yield module
    finally:
        for params, key in slots:
            params[key] = None
