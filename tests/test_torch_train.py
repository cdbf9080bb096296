"""The port's training slice against the JAX package, on the CPU.

``Serenade.forward`` (the training losses), the optimizers and schedules,
and ``build_train_step`` of ``serenade_tpu_torch`` against
``JaxSerenade.apply`` under ``jax.value_and_grad``, optax, and
``serenade_tpu.trainers.build_train_step``, with the same parameters (JAX's
seeded init through ``convert.py``), the same numpy inputs and JAX's own
segment, flow-time and noise draws handed to the port.  Small widths, f32
(the tests pin JAX's matmul precision to float32), dropout 0 on both sides:
torch cannot draw the TPU's dropout bits, so dropout is tested on its own.
"""

from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from serenade_tpu.models.serenade import Serenade as JaxSerenade
from serenade_tpu.trainers import build_optimizer as jax_build_optimizer
from serenade_tpu.trainers import build_train_step as jax_build_train_step
from serenade_tpu.trainers import create_train_state as jax_create_state

from serenade_tpu_torch import configs
from serenade_tpu_torch.convert import load_params, state_dict_from_flax
from serenade_tpu_torch.models.layers import dropout, init_params_
from serenade_tpu_torch.models.serenade import Serenade
from serenade_tpu_torch.models.transformer import BasicTransformerBlock
from serenade_tpu_torch.trainers import (
    build_optimizer,
    build_train_step,
    create_train_state,
)

REPO = Path(__file__).resolve().parent.parent

# tests/test_torch_slice.py's small config, with the encoder as wide as the
# mel: the prior loss compares the two (as at full width, 80 and 80)
CFG = dict(input_dim=32, output_dim=80, encoder_channels=80,
           encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
           decoder_attention_head_dim=32, gst_tokens=10,
           gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16, dropout=0.0)
B, T, LENGTHS = 2, 64, (64, 45)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _batch(rng, lengths, t=T):
    b = len(lengths)
    return {"x": rng.normal(size=(b, t, 32)).astype(np.float32),
            "lengths": np.asarray(lengths, np.int32),
            "logmel": rng.normal(size=(b, t, 80)).astype(np.float32),
            "midi": rng.uniform(size=(b, t, 1)).astype(np.float32),
            "loud": rng.uniform(size=(b, t, 1)).astype(np.float32)}


def _draws(key, b, t=T, mask_size=(0.1, 0.5)):
    """JAX's segment, flow-time and noise draws for one model call with
    ``rng=key`` (serenade.py:117-130, cfm.py:81-84), for the port."""
    k_seg, k_start, k_cfm = jax.random.split(key, 3)
    kt, kz = jax.random.split(k_cfm)
    return {
        "frac": _t(jax.random.uniform(k_seg, (), minval=mask_size[0],
                                      maxval=mask_size[1])),
        "start": _t(jax.random.uniform(k_start, ())),
        "t": _t(jax.random.uniform(kt, (b, 1, 1), dtype=jnp.float32)
                ).reshape(b),
        "z": _t(jax.random.normal(kz, (b, t, 80), dtype=jnp.float32))}


def _model_args(batch):
    return (batch["x"], batch["lengths"], batch["logmel"], batch["midi"],
            batch["loud"])


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model and its seeded parameters (numpy), shared by the
    tests of this module."""
    jmodel = JaxSerenade(**CFG, dtype=jnp.float32)
    batch = _batch(np.random.default_rng(0), LENGTHS)
    key = jax.random.key(0)
    params = _np(jax.jit(lambda *a: jmodel.init(key, *a, rng=key))(
        *(jnp.asarray(a) for a in _model_args(batch))))
    # jitter every leaf so zero biases, unit scales and the identity
    # SpeakerAdapter are exercised too
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        params)
    return jmodel, params


def _port(params, device="cpu"):
    return load_params(Serenade(**CFG, dtype="float32"), params).to(device)


def _rel_close(got, want, tol, name=""):
    """max |got - want| <= tol * max(1e-3, max |want|) for one tensor."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1e-3, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: {err:.3g} > {tol} x {scale:.3g}"


def test_losses_and_every_gradient_match_jax(jax_model):
    """One loss, one backward: the three losses, the encoder output and
    the gradient of every parameter.  f32; 2e-4 of each tensor's largest
    value covers the summation order through the UNet, the GRU loop and
    the GST stack (the largest seen is about 3e-5)."""
    jmodel, params = jax_model
    batch = _batch(np.random.default_rng(2), LENGTHS)
    key = jax.random.key(3)

    def loss_fn(p):
        out = jmodel.apply(p, *(jnp.asarray(a) for a in _model_args(batch)),
                           rng=key, deterministic=False,
                           rngs={"dropout": jax.random.fold_in(key, 1)})
        return out["loss"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    model = _port(params)
    out = model(*(torch.as_tensor(a) for a in _model_args(batch)),
                draws=_draws(key, B))
    out["loss"].backward()
    for name in ("cfm_loss", "prior_loss", "loss"):
        np.testing.assert_allclose(out[name].item(), float(jout[name]),
                                   rtol=1e-5, err_msg=name)
    _rel_close(out["gauss_mel"].detach(), jout["gauss_mel"], 1e-5)
    want = state_dict_from_flax(model, _np(jgrads))
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        _rel_close(p.grad, want[name], 2e-4, name)


CONFIG = {"optimizer_type": "AdamW",
          "optimizer_params": {"lr": 1e-2},
          "scheduler_type": "MultiStepLR",
          "scheduler_params": {"gamma": 0.5, "milestones": [2]},
          "grad_norm": 1.0}


@pytest.mark.parametrize("kind,mu_dtype,grad_scale", [
    ("AdamW", "float32", 0.1),     # norm below 1: no clipping
    ("AdamW", "float32", 10.0),    # clipped
    ("AdamW", "bfloat16", 0.1),
    ("AdamW", "bfloat16", 10.0),
    ("Adam", "bfloat16", 10.0),
    ("SGD", None, 10.0),
])
def test_optimizer_matches_optax(kind, mu_dtype, grad_scale):
    """The same gradient arrays into the port's optimizer and optax's for
    4 updates (lr 1e-2, MultiStepLR milestone 2: updates 1, 2 and 3 are
    m-1, m and m+1).  Parameters and the norm before clipping within f32
    rounding (1e-6 relative)."""
    opt_params = {"lr": 1e-2}
    if kind == "SGD":
        opt_params["momentum"] = 0.9
    else:
        opt_params["mu_dtype"] = mu_dtype
    config = dict(CONFIG, optimizer_type=kind, optimizer_params=opt_params)
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (grad_scale * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]

    tx, jschedule = jax_build_optimizer(config)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    opt, schedule = build_optimizer(config)
    tparams = [_t(params[k]) for k in shapes]
    state = opt.init(tparams)
    for step, g in enumerate(grads):
        assert schedule(step) == pytest.approx(float(jschedule(step)),
                                               rel=1e-6)
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = opt.update(tparams, [_t(g[k]) for k in shapes], state)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        for k, p in zip(shapes, tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} after update {step}")
    assert schedule(1) == 1e-2 and schedule(2) == schedule(3) == 5e-3


def test_three_train_steps_match_jax(jax_model):
    """3 steps of build_train_step against JAX's with grad_accum 2 (each
    micro-batch its own draws) and prior_loss_start_steps 1 (step 0 leaves
    the prior out; the gate is strict, so step 1 does too).  AdamW eps is
    1e-3 here: with 1e-8, a gradient near zero whose sign is only rounding
    moves its weight by the full learning rate on one side and not the
    other.  Metrics within 1e-4.  The first moment is stored in bf16, as
    in the recipe, so a gradient difference at f32 rounding can flip an
    element's bf16 rounding and move its update by 2^-8: parameters within
    3 updates x lr x 2^-8 = 1.2e-5."""
    jmodel, params = jax_model
    config = dict(CONFIG, optimizer_params={"lr": 1e-3, "eps": 1e-3,
                                            "mu_dtype": "bfloat16"})
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        micro = [_batch(rng, LENGTHS), _batch(rng, (50, 64))]
        batches.append({k: np.stack([m[k] for m in micro])
                        for k in micro[0]})

    tx, _ = jax_build_optimizer(config)
    jstep = jax_build_train_step(jmodel, tx, prior_loss_start_steps=1,
                                 grad_accum=2, donate=False)
    jstate = jax_create_state(jax.tree_util.tree_map(jnp.asarray, params),
                              tx)
    model = _port(params)
    opt, _ = build_optimizer(config)
    state = create_train_state(model, opt)
    step = build_train_step(model, opt, prior_loss_start_steps=1,
                            grad_accum=2, device="cpu")
    for i, batch in enumerate(batches):
        key = jax.random.key(100 + i)
        jstate, jmetrics = jstep(
            jstate, jax.tree_util.tree_map(jnp.asarray, batch), key)
        draws = [_draws(k, B) for k in jax.random.split(key, 2)]
        state, metrics = step(state, batch, None, draws=draws)
        for name, value in jmetrics.items():
            np.testing.assert_allclose(float(metrics[name]), float(value),
                                       rtol=1e-4, err_msg=f"{name} step {i}")
    assert state.step == 3 and int(jstate.step) == 3
    assert float(metrics["train/loss"]) > float(metrics["train/vector_loss"])
    want = state_dict_from_flax(model, _np(jstate.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1.2e-5, err_msg=name)


def test_dropout_rate_scale_and_none_in_inference():
    """The port's dropout keeps a 1 - p share of elements, scaled by
    1 / (1 - p), and draws the same mask from the same seed; a transformer
    block applies it only with ``train`` set."""
    p = 0.25
    x = torch.ones(200_000)
    y = dropout(x, p, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    assert torch.equal(y, dropout(x, p, torch.Generator().manual_seed(0)))
    assert dropout(x, 0.0, None) is x

    block = init_params_(BasicTransformerBlock(16, 2, 8, dropout=0.5), 3)
    h = torch.randn(2, 6, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = block(h)
        assert torch.equal(block(h, train=False,
                                 generator=torch.Generator().manual_seed(2)),
                           ref)
        trained = block(h, train=True,
                        generator=torch.Generator().manual_seed(2))
    assert not torch.allclose(trained, ref)


def test_training_config_matches_recipe():
    """configs.TRAIN_CONFIG carries the recipe's optimizer, scheduler,
    clipping and batch size (the card's machine has no pyyaml)."""
    with open(REPO / "egs" / "gtsinger" / "ssc1" / "conf"
              / "serenade.yaml") as f:
        ssc = yaml.safe_load(f)
    for key in ("optimizer_type", "optimizer_params", "grad_norm",
                "scheduler_type", "scheduler_params", "batch_size",
                "gradient_accumulate_steps"):
        assert configs.TRAIN_CONFIG[key] == ssc[key], key
    opt, schedule = build_optimizer(configs.TRAIN_CONFIG)
    assert opt.kind == "AdamW" and opt.mu_dtype == torch.bfloat16
    assert schedule(99_999) == 8e-4 and schedule(100_000) == 4e-4
