"""The port's mixture-of-experts FFN against the JAX package's, on the CPU
(tests/test_moe.py, case for case): routing against the per-token oracle,
capacity overflow through the residual, per-group queues, gradients, the
capacity helper, and expert parallelism on four spawned ranks (expert 2 x
data 2, one spawn a test session, ``tests/torch_parallel_worker.py``)
against JAX's one-device run, forward and gradients.  JAX's seeded
parameters cross by ``convert.stacked_from_flax``; f32, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serenade_tpu.parallel.moe import init_moe_params as jax_init
from serenade_tpu.parallel.moe import moe_ffn as jax_moe_ffn

import torch_parallel_worker as worker
from serenade_tpu_torch.convert import stacked_from_flax
from serenade_tpu_torch.parallel.moe import moe_capacity, moe_ffn
from test_moe import _reference_moe

WORLD = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(b=2, t=16, d=8, d_ff=16, e=4, seed=0):
    """JAX's seeded parameters and input (tests/test_moe.py ``_setup``),
    as numpy, and the port's tensors of them."""
    kp, kx = jax.random.split(jax.random.key(seed))
    jparams = jax.tree_util.tree_map(np.asarray, jax_init(kp, e, d, d_ff))
    x = np.array(jax.random.normal(kx, (b, t, d)))
    return jparams, x, stacked_from_flax(jparams), torch.from_numpy(x)


def test_moe_matches_per_token_oracle():
    jparams, x, params, xt = _setup()
    y, aux = moe_ffn(params, xt, capacity_factor=8.0)  # no overflow
    np.testing.assert_allclose(y.numpy(), _reference_moe(jparams, x, 8.0),
                               atol=1e-5)
    _, jaux = jax.jit(lambda p, xx: jax_moe_ffn(p, xx, capacity_factor=8.0))(
        jparams, jnp.asarray(x))
    assert float(aux) == pytest.approx(float(jaux), abs=1e-5)
    assert 0.99 < float(aux) < 4.0


def test_moe_capacity_overflow_passes_residual():
    jparams, x, params, xt = _setup(b=1, t=32)
    y, _ = moe_ffn(params, xt, capacity_factor=1e-9)
    np.testing.assert_allclose(y.numpy(), _reference_moe(jparams, x, 1e-9),
                               atol=1e-5)
    changed = np.abs(y.numpy() - x).max(-1) > 1e-7
    assert changed.sum() <= params["wi"].shape[0]  # <= E routed tokens


def test_moe_group_queues_are_independent():
    jparams, x, params, xt = _setup(b=2, t=32)
    y, _ = moe_ffn(params, xt, capacity_factor=1.0)
    np.testing.assert_allclose(y.numpy(), _reference_moe(jparams, x, 1.0),
                               atol=1e-5)
    changed = np.abs(y.numpy() - x).max(-1) > 1e-7
    cap = moe_capacity(32, params["wi"].shape[0], 1.0)
    for row in changed:
        assert row.sum() <= cap * params["wi"].shape[0]


def _jax_grads(jparams, x, capacity_factor=2.0):
    def loss(p, xx):
        y, aux = jax_moe_ffn(p, xx, capacity_factor=capacity_factor)
        return jnp.sum(y ** 2) + 0.01 * aux

    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(
        jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(x)))


def test_moe_is_differentiable():
    """Finite gradients, the router's through the gate (Switch), equal to
    JAX's within 1e-5."""
    jparams, x, params, xt = _setup()
    for v in params.values():
        v.requires_grad_()
    y, aux = moe_ffn(params, xt, capacity_factor=2.0)
    (torch.sum(y ** 2) + 0.01 * aux).backward()
    want = _jax_grads(jparams, x)
    for k, v in params.items():
        assert torch.isfinite(v.grad).all(), k
        np.testing.assert_allclose(v.grad.numpy(), want[k], atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    assert params["router"].grad.abs().max() > 0


def test_moe_capacity_helper():
    assert moe_capacity(64, 4, 1.0) == 16
    assert moe_capacity(64, 4, 1.25) == 20
    assert moe_capacity(3, 4, 1.0) == 1


def _ep(root):
    jparams, x, _, _ = _setup(b=4, t=32, d=16, d_ff=32, e=4)
    procs = worker.spawn("moe", WORLD, str(root),
                         {"params": jparams, "x": x})
    y, aux = jax.jit(lambda p, xx: jax_moe_ffn(p, xx, capacity_factor=2.0))(
        jparams, jnp.asarray(x))
    ref = {"y": np.asarray(y), "aux": float(aux),
           "grads": _jax_grads(jparams, x)}
    return ref, worker.collect(procs, str(root))


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    """The ranks' results and JAX's one-device run, once a session."""
    return worker.shared(tmp_path_factory, "torch_moe", _ep)


def test_moe_ep_sharded_matches_single_device(ep):
    """Expert 2 x data 2: each rank holds 2 of the 4 experts and one of
    the 4 groups; dispatch and combine cross by all-to-all.  Output, aux
    loss and the gradients (the router's summed over every rank, each
    expert's over the data ranks) equal the one-device run's."""
    ref, ranks = ep
    for got in (r["scenario_moe"] for r in ranks):
        assert got["local"] == {"router": (16, 4), "wi": (2, 16, 32),
                                "wo": (2, 32, 16)}
        np.testing.assert_allclose(got["y"], ref["y"], atol=1e-5)
        assert got["aux"] == pytest.approx(ref["aux"], abs=1e-5)
        np.testing.assert_allclose(got["grad_router"], ref["grads"]["router"],
                                   atol=1e-5, rtol=1e-5)
        for k in ("wi", "wo"):
            np.testing.assert_allclose(got["grads"][k], ref["grads"][k],
                                       atol=1e-5, rtol=1e-5, err_msg=k)
