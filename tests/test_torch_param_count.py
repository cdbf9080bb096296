"""``python -m serenade_tpu_torch.bin.param_count`` against the JAX
package's parameter trees, on the CPU: ``--config`` builds the model on
the meta device, and its total and per-module counts equal the element
counts of JAX's ``jax.eval_shape`` of ``init`` (computed here, not
through JAX's CLI); ``--checkpoint`` reads a port checkpoint."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from serenade_tpu.models.nusvc import NUSVC as JaxNUSVC
from serenade_tpu.models.serenade import Serenade as JaxSerenade

from serenade_tpu_torch.bin import param_count
from serenade_tpu_torch.checkpoint import save_checkpoint
from serenade_tpu_torch.config import dump_config
from serenade_tpu_torch.models.nusvc import NUSVC

SERENADE = dict(input_dim=768, output_dim=80, encoder_channels=80,
                decoder_channels=32, gst_embed_dim=32,
                decoder_attention_head_dim=32)
NUSVC_SMALL = dict(input_dim=12, output_dim=8, encoder_channels=12,
                   decoder_channels=16, gst_embed_dim=16,
                   decoder_attention_head_dim=16)
T = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree(model_type, params):
    """JAX's parameter tree of the model, by shape only."""
    if model_type == "Serenade":
        model = JaxSerenade(**params)
        args = (jnp.zeros((1, T, params["input_dim"])), jnp.array([T]),
                jnp.zeros((1, T, params["output_dim"])), jnp.zeros((1, T, 1)),
                jnp.zeros((1, T, 1)))
    else:
        model = JaxNUSVC(**params)
        args = (jnp.zeros((1, T, params["input_dim"])), jnp.array([T]),
                jnp.zeros((1, T, params["output_dim"])))
    return jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0)}, *args, rng=jax.random.key(1),
        deterministic=True))


def _jax_counts(tree):
    per, total = {}, 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        n = int(np.prod(leaf.shape))
        total += n
        group = "/".join(str(k.key) for k in path[:2])
        per[group] = per.get(group, 0) + n
    return total, per


def _run(capsys, *argv):
    out = param_count.main([*argv, "--json"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    return out


@pytest.mark.parametrize("model_type,params", [("Serenade", SERENADE),
                                               ("NUSVC", NUSVC_SMALL)])
def test_config_counts_equal_jax(tmp_path, capsys, model_type, params):
    path = tmp_path / "config.yml"
    dump_config({"model_type": model_type, "model_params": params},
                str(path))
    out = _run(capsys, "--config", str(path))
    total, per = _jax_counts(_jax_tree(model_type, params))
    assert out["total"] == total
    # the port's groups are JAX's: a tensor's path is its flax path
    assert out["per_module"] == per
    assert out["source"] == f"{model_type} ({path})"


def test_checkpoint_counts_parameters(tmp_path, capsys):
    """A port checkpoint written by ``save_checkpoint``: the model's
    parameter count, in its top modules, with the sizes and keys JAX's
    CLI prints."""
    model = NUSVC(**NUSVC_SMALL, dtype="float32")
    ckpt = save_checkpoint(str(tmp_path), 7, model.state_dict())
    out = _run(capsys, "--checkpoint", ckpt)
    n = sum(p.numel() for p in model.parameters())
    assert set(out) == {"total", "per_module", "source", "size_mb"}
    assert out["total"] == n and out["source"] == ckpt
    assert set(out["per_module"]) == {"params/encoder", "params/post_encoder",
                                      "params/gst", "params/cfm_decoder"}
    assert sum(out["per_module"].values()) == n
    assert out["size_mb"] == {"float32": round(n * 4 / 1e6, 1),
                              "bfloat16": round(n * 2 / 1e6, 1),
                              "int8": round(n / 1e6, 1)}


def test_text_output_and_arguments(tmp_path, capsys):
    path = tmp_path / "config.yml"
    dump_config({"model_type": "NUSVC", "model_params": NUSVC_SMALL},
                str(path))
    out = param_count.main(["--config", str(path)])
    text = capsys.readouterr().out
    assert text.startswith(f"source: NUSVC ({path})")
    assert f"total: {out['total'] / 1e6:.3f} M params" in text
    assert "params/cfm_decoder" in text
    with pytest.raises(SystemExit):
        param_count.main([])
    with pytest.raises(SystemExit):
        param_count.main(["--config", str(path), "--checkpoint", "x"])
