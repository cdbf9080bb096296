#!/usr/bin/env python3
"""Parameter counts of a registered model or a saved checkpoint
(counterpart of serenade_tpu/bin/param_count.py)::

    python -m serenade_tpu_torch.bin.param_count --config conf.yml [--json]
    python -m serenade_tpu_torch.bin.param_count \\
        --checkpoint exp/checkpoint-<N>steps [--json]

``--config`` builds ``config["model_type"]`` from the registry with its
``model_params`` on ``torch.device("meta")``: shapes only, no storage and
no arithmetic (JAX's ``jax.eval_shape`` of ``init``).  ``--checkpoint``
reads a port checkpoint's parameters (``checkpoint.restore_params_only``).
Parameters are counted, not buffers.  A tensor's path is that of the flax
tree its JAX twin has: a model's state-dict key under ``params``, with
``/`` for ``.`` (a checkpoint of nested state dicts, as the vocoder
trainer's ``{"generator", "discriminator"}``, keeps its own top levels).
Prints the count of each group of the first two path levels, the total,
and the resident size in f32, bf16 and int8.
"""

from __future__ import annotations

import argparse
import json
from typing import Iterator, Mapping, Tuple

import torch


def _leaves(tree, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], int]]:
    for key, value in tree.items():
        path = prefix + tuple(str(key).split("."))
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        elif torch.is_tensor(value):
            yield path, value.numel()


def count_tree(tree: Mapping) -> dict:
    """``total`` and ``per_module`` (the first two path levels) of a tree
    of tensors; a flat state dict is read as the ``params`` collection."""
    if tree and all(torch.is_tensor(v) for v in tree.values()):
        tree = {"params": tree}
    per, total = {}, 0
    for path, n in _leaves(tree):
        total += n
        group = "/".join(path[:2])
        per[group] = per.get(group, 0) + n
    return {"total": total, "per_module": dict(sorted(per.items()))}


def config_tree(config: Mapping) -> dict:
    """The parameters of ``config``'s registered model, built on the meta
    device."""
    from serenade_tpu_torch.config import resolve

    cls = resolve("model", config["model_type"])
    with torch.device("meta"):
        model = cls(**dict(config.get("model_params", {})))
    return {"params": dict(model.named_parameters())}


def build_argparser():
    p = argparse.ArgumentParser(description="parameter counts (PyTorch)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if (args.checkpoint is None) == (args.config is None):
        raise SystemExit("give exactly one of --checkpoint / --config")
    if args.checkpoint:
        from serenade_tpu_torch.checkpoint import restore_params_only

        tree = restore_params_only(args.checkpoint)
        src = args.checkpoint
    else:
        from serenade_tpu_torch.config import load_config

        config = load_config(args.config)
        tree = config_tree(config)
        src = f"{config['model_type']} ({args.config})"

    out = count_tree(tree)
    out["source"] = src
    out["size_mb"] = {"float32": round(out["total"] * 4 / 1e6, 1),
                      "bfloat16": round(out["total"] * 2 / 1e6, 1),
                      "int8": round(out["total"] / 1e6, 1)}
    if args.json:
        print(json.dumps(out, indent=2))
        return out
    print(f"source: {out['source']}")
    for mod, n in out["per_module"].items():
        print(f"  {mod:<40s} {n / 1e6:10.3f} M")
    print(f"total: {out['total'] / 1e6:.3f} M params "
          f"(f32 {out['size_mb']['float32']} MB / "
          f"bf16 {out['size_mb']['bfloat16']} MB / "
          f"int8 {out['size_mb']['int8']} MB)")
    return out


if __name__ == "__main__":
    main()
