"""Released SiFiGAN checkpoints -> the port's generator state dict
(counterpart of serenade_tpu/sifigan/convert.py).

The upstream ``sifigan`` package saves its generator as a torch pickle,
``{"model": {"generator": state_dict}}``, with weight-normed convs in
``sn``/``fn`` ModuleDicts.  Weight norm is folded, ``w = v (g / ||v||)``
with the norm over every axis but the first (``vocoder/convert.py``), and
the modules renamed:

  input_conv                  -> input_conv
  sn.emb, fn.emb              -> sn_emb, fn_emb (Direct)
  sn.upsamples.{i}            -> sn_up{i}   (fn: fn_up{i})
  sn.downsamples.{i}          -> sn_down{i} (fn: fn_down{i})
  sn.blocks.{i}.convs{C,P,F,A}.{j} -> sn_block{i}.conv{C,P,F,A}{j}
  fn.blocks.{i*nb+j}.convs1.{d}    -> fn_block{i}_{j}.conv1_{d} (convs2)
  sn.output_conv, fn.output_conv   -> sn_output_conv, fn_output_conv

A conv inside an ``nn.Sequential`` is found at index 0, 1 or 2, so where
the package puts its activations cannot break the lookup, and every key
of the checkpoint must be consumed: a leftover raises with its names.
The port's convolutions keep torch's layouts, so weights copy as they
are.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from serenade_tpu_torch.vocoder.convert import (
    _fold_weight_norm, load_torch_vocoder_checkpoint,
)


def _locate(sd: Mapping, prefix: str) -> str:
    for cand in (prefix, f"{prefix}.0", f"{prefix}.1", f"{prefix}.2"):
        if f"{cand}.weight" in sd or f"{cand}.weight_v" in sd:
            return cand
    raise KeyError(f"no conv parameters under {prefix!r} (available: "
                   f"{sorted(k for k in sd if k.startswith(prefix))})")


def _modules(model):
    """(port module, released module prefix) of every convolution of
    ``model`` (a port ``SiFiGANGenerator`` or ``SiFiGANDirectGenerator``)."""
    yield "input_conv", "input_conv"
    yield "sn_emb", "sn.emb"
    if model.direct:
        yield "fn_emb", "fn.emb"
    yield "sn_output_conv", "sn.output_conv"
    yield "fn_output_conv", "fn.output_conv"
    n_up = len(model.upsample_scales)
    n_blocks = len(model.filter_resblock_kernel_sizes)
    for i in range(n_up):
        yield f"sn_up{i}", f"sn.upsamples.{i}"
        if not model.share_upsamples:
            yield f"fn_up{i}", f"fn.upsamples.{i}"
        for j in range(len(model.source_resblock_dilations[i])):
            for tap in "CPF":
                yield f"sn_block{i}.conv{tap}{j}", f"sn.blocks.{i}.convs{tap}.{j}"
            if model.source_use_additional_convs:
                yield f"sn_block{i}.convA{j}", f"sn.blocks.{i}.convsA.{j}"
        for j in range(n_blocks):
            flat = i * n_blocks + j
            for d in range(len(model.filter_resblock_dilations[j])):
                yield (f"fn_block{i}_{j}.conv1_{d}",
                       f"fn.blocks.{flat}.convs1.{d}")
                if model.filter_use_additional_convs:
                    yield (f"fn_block{i}_{j}.conv2_{d}",
                           f"fn.blocks.{flat}.convs2.{d}")
    for i in range(n_up - 1):
        yield f"sn_down{i}", f"sn.downsamples.{i}"
        if not model.share_downsamples:
            yield f"fn_down{i}", f"fn.downsamples.{i}"


def convert_sifigan_generator(state_dict: Mapping, model
                              ) -> Dict[str, torch.Tensor]:
    """A released SiFiGAN generator state dict -> the state dict of
    ``model`` (f32, on the CPU).  Raises ``KeyError`` on a missing conv
    and ``ValueError`` on checkpoint keys no module consumed."""
    used = set()
    out = {}
    for port, ref in _modules(model):
        p = _locate(state_dict, ref)
        keys = [k for k in (f"{p}.weight", f"{p}.weight_g", f"{p}.weight_v",
                            f"{p}.bias") if k in state_dict]
        used.update(keys)
        out[f"{port}.weight"] = _fold_weight_norm(state_dict, p).detach()
        if f"{p}.bias" in state_dict:
            out[f"{port}.bias"] = state_dict[f"{p}.bias"].detach().float()
    leftovers = sorted(k for k in state_dict if k not in used
                       and not k.endswith("num_batches_tracked"))
    if leftovers:
        raise ValueError("checkpoint keys no module of the generator takes "
                         "(naming drift?): " + ", ".join(leftovers[:40]))
    return {k: v.cpu() for k, v in out.items()}


def load_sifigan_checkpoint(path: str, model) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` from a released SiFiGAN pickle
    (``{"model": {"generator": sd}}`` or a bare state dict; trusted, read
    with ``weights_only=False`` as the JAX package reads it)."""
    return convert_sifigan_generator(load_torch_vocoder_checkpoint(path),
                                     model)
