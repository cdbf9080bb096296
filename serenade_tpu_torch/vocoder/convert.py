"""Reference torch HiFiGAN checkpoints → the port's generator state dict
(counterpart of serenade_tpu/vocoder/convert.py).

The released GTSinger vocoder is a torch pickle of the reference's
``HiFiGANGenerator`` (``{"model": {"generator": state_dict}}``).  Its
weight norm is folded, ``w = v * (g / ||v||)`` with the norm over every
axis but the first (the reference's own ``remove_weight_norm()`` before
inference), and its modules are renamed:

  input_conv                  -> input_conv
  upsamples.{i}.1             -> upsample_{i}
  blocks.{i*nb+j}.convs1.{d}.1 -> block_{i}_{j}.conv1_{d} (convs2: conv2_)
  output_conv.1               -> output_conv

The port's convolutions keep torch's layouts, so the weights are copied
as they are.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


def _modules(num_upsamples, num_blocks, resblock_dilations,
             use_additional_convs):
    """(port module, reference module) of every convolution."""
    yield "input_conv", "input_conv"
    for i in range(num_upsamples):
        yield f"upsample_{i}", f"upsamples.{i}.1"
        for j in range(num_blocks):
            flat = i * num_blocks + j
            for d in range(len(resblock_dilations[j])):
                yield (f"block_{i}_{j}.conv1_{d}",
                       f"blocks.{flat}.convs1.{d}.1")
                if use_additional_convs:
                    yield (f"block_{i}_{j}.conv2_{d}",
                           f"blocks.{flat}.convs2.{d}.1")
    yield "output_conv", "output_conv.1"


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=tuple(range(1, v.ndim)),
                                    keepdim=True)


def _fold_weight_norm(sd: Mapping, prefix: str) -> torch.Tensor:
    """The effective weight of a (possibly weight-normed) convolution."""
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"].float()
    g = sd[f"{prefix}.weight_g"].float()
    v = sd[f"{prefix}.weight_v"].float()
    return v * (g / _norm(v).clamp_min(1e-12))


def convert_hifigan_generator(state_dict: Mapping, *, num_upsamples: int = 4,
                              num_blocks: int = 3,
                              resblock_dilations=((1, 3, 5),) * 3,
                              use_additional_convs: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """A reference HiFiGANGenerator state dict -> the state dict of the
    port's ``HiFiGANGenerator`` with the same layout (f32)."""
    out = {}
    for port, ref in _modules(num_upsamples, num_blocks, resblock_dilations,
                              use_additional_convs):
        out[f"{port}.weight"] = _fold_weight_norm(state_dict, ref).detach()
        out[f"{port}.bias"] = state_dict[f"{ref}.bias"].detach().float()
    return {k: v.cpu() for k, v in out.items()}


def to_reference_generator_state_dict(state_dict: Mapping, *,
                                      num_upsamples: int = 4,
                                      num_blocks: int = 3,
                                      resblock_dilations=((1, 3, 5),) * 3,
                                      use_additional_convs: bool = True
                                      ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_hifigan_generator`: the port's
    weights in the reference's names, in weight-norm form as torch's
    ``weight_norm`` sets it up (``weight_v`` the weight, ``weight_g`` its
    norm), which folds back to the same weights."""
    out = {}
    for port, ref in _modules(num_upsamples, num_blocks, resblock_dilations,
                              use_additional_convs):
        w = state_dict[f"{port}.weight"].detach().float()
        out[f"{ref}.weight_g"] = _norm(w)
        out[f"{ref}.weight_v"] = w.clone()
        out[f"{ref}.bias"] = state_dict[f"{port}.bias"].detach().clone()
    return out


def load_torch_vocoder_checkpoint(path: str) -> Dict:
    """The generator state dict of a reference torch pickle
    (``{"model": {"generator": sd}}``, ``{"model": sd}`` or a raw state
    dict).  The pickle is trusted: it is loaded with
    ``weights_only=False``, as the JAX package loads it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        model = ckpt["model"]
        if isinstance(model, dict) and "generator" in model:
            return model["generator"]
        return model
    return ckpt
