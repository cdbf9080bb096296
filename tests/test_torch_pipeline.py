"""The port's pipeline and composed dp x tp x pp layouts against the JAX
package's, on the CPU (tests/test_pipeline.py and
tests/test_composed_mesh.py, case for case).

Eight spawned ranks in a gloo group (``tests/torch_parallel_worker.py``,
one spawn a test session, on a ``file://`` store) run ``gpipe`` over a
4-way ``pipe`` axis (forward, gradients, M < S, a sqrt stage, the
transformer block as stages), dp x pp on pipe 4 x data 2, and the
composed step on pipe 2 x data 2 x model 2 (forward, gradients, three
Adam steps).  While they run, this process computes JAX's sequential
references from the same seeded stage weights, carried across by
``convert.stacked_from_flax``.  f32; forward and gradients within 1e-6
to 2e-5, as the JAX tests hold the mesh to one device.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serenade_tpu.models.transformer import (
    BasicTransformerBlock as JaxBlock,
)
from serenade_tpu.parallel import composed as jcomposed
from serenade_tpu.parallel.mesh import composed_mesh as jax_composed_mesh
from serenade_tpu.parallel.pipeline import microbatch as jax_microbatch
from serenade_tpu.parallel.pipeline import (
    stack_stage_params as jax_stack,
)

import torch_parallel_worker as worker
from serenade_tpu_torch.convert import stacked_from_flax
from serenade_tpu_torch.models.transformer import BasicTransformerBlock
from serenade_tpu_torch.parallel.mesh import Mesh
from serenade_tpu_torch.parallel.pipeline import gpipe, microbatch

WORLD = 8
S, D = 4, 32
CD, INNER, CB, CT, CM = 32, 64, 8, 6, 4     # the composed case's sizes


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_stages(key):
    ks = jax.random.split(key, S)
    return [{"w": jax.random.normal(k, (D, D)) * (0.5 / np.sqrt(D)),
             "b": jax.random.normal(jax.random.fold_in(k, 1), (D,)) * 0.1}
            for k in ks]


def _toy_stage_fn(p, a):
    return jnp.tanh(a @ p["w"] + p["b"])


def _sqrt_stage_fn(p, a):
    return jnp.sqrt(jnp.abs(a @ p["w"]))


def _sequential(stages, x, fn=_toy_stage_fn):
    for p in stages:
        x = fn(p, x)
    return x


def _np_stack(stages):
    return {k: np.asarray(v) for k, v in jax_stack(stages).items()}


def _inputs():
    """The seeded stage weights and inputs, as numpy (jax.random draws;
    the transformer blocks' from a jitted init)."""
    inp = {}
    for name, (ks, kx, shape) in {
            "fwd": (0, 1, (8, 6, D)), "grad": (2, 3, (8, 4, D)),
            "dp": (5, 6, (8, 4, D)), "few": (11, 12, (2, 3, D))}.items():
        inp[f"stages_{name}"] = _np_stack(_toy_stages(jax.random.key(ks)))
        inp[f"x_{name}"] = np.asarray(jax.random.normal(jax.random.key(kx),
                                                        shape))
    inp["tgt_grad"] = np.asarray(jax.random.normal(jax.random.key(4),
                                                   (8, 4, D)))
    inp["stages_sqrt"] = _np_stack(_toy_stages(jax.random.key(20)))
    inp["x_sqrt"] = np.asarray(jnp.abs(jax.random.normal(
        jax.random.key(21), (8, 6, D))) + 0.5)
    x = jax.random.normal(jax.random.key(7), (4, 12, 16)) * 0.3
    init = jax.jit(lambda k: JaxBlock(
        dim=16, num_attention_heads=2, attention_head_dim=8,
        activation_fn="gelu").init(k, x[:1]))
    params = [init(jax.random.key(10 + i)) for i in range(S)]
    block = BasicTransformerBlock(dim=16, num_attention_heads=2,
                                  attention_head_dim=8, activation_fn="gelu")
    inp["jax_block"] = jax.tree_util.tree_map(np.asarray, jax_stack(params))
    inp["stages_block"] = {k: v.numpy() for k, v in stacked_from_flax(
        inp["jax_block"], block).items()}
    inp["x_block"] = np.asarray(x)
    cstacked = jax_stack(jcomposed.init_ffn_stages(jax.random.key(0), 2, CD,
                                                   INNER))
    inp["jax_composed"] = jax.tree_util.tree_map(np.asarray, cstacked)
    inp["composed_stages"] = {k: v.numpy() for k, v in stacked_from_flax(
        inp["jax_composed"]).items()}
    for name, key in (("composed_x", 1), ("composed_target", 2),
                      ("composed_target3", 3)):
        inp[name] = np.asarray(jax.random.normal(jax.random.key(key),
                                                 (CB, CT, CD)))
    return inp


def _refs(inp):
    """JAX's sequential references (jitted) of the same weights."""
    def stages(name):
        st = inp[f"stages_{name}"]
        return [{k: jnp.asarray(v[i]) for k, v in st.items()}
                for i in range(S)]

    seq = jax.jit(_sequential, static_argnums=2)
    ref = {n: np.asarray(seq(stages(n), inp[f"x_{n}"], _toy_stage_fn))
           for n in ("fwd", "dp", "few")}
    ref["forward"] = ref.pop("fwd")
    ref["sqrt"] = np.asarray(seq(stages("sqrt"), inp["x_sqrt"],
                                 _sqrt_stage_fn))

    def loss_seq(st, xx):
        y = _sequential([jax.tree_util.tree_map(lambda leaf: leaf[i], st)
                         for i in range(S)], xx)
        return jnp.mean((y - inp["tgt_grad"]) ** 2)

    loss, (gp, gx) = jax.jit(jax.value_and_grad(loss_seq, argnums=(0, 1)))(
        inp["stages_grad"], inp["x_grad"])
    ref.update(grad_loss=float(loss), grads=jax.tree_util.tree_map(
        np.asarray, gp), grad_x=np.asarray(gx))

    jblock = JaxBlock(dim=16, num_attention_heads=2, attention_head_dim=8,
                      activation_fn="gelu")

    @jax.jit
    def block_stack(stacked, x):
        for i in range(S):
            x = jblock.apply(jax.tree_util.tree_map(lambda a: a[i], stacked),
                             x, deterministic=True)
        return x

    ref["block"] = np.asarray(block_stack(inp["jax_block"], inp["x_block"]))
    cstacked = inp["jax_composed"]
    x, target = inp["composed_x"], inp["composed_target"]

    def composed_full(st, xx):
        ps = [jax.tree_util.tree_map(lambda leaf: leaf[i], st)
              for i in range(2)]
        return _sequential(ps, xx, jcomposed.ffn_stage_full)

    ref["composed_forward"] = np.asarray(jax.jit(composed_full)(cstacked, x))
    ref["composed_grads"] = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax.grad(lambda st: jnp.mean((composed_full(st, x) - target) ** 2)))(
            cstacked))
    ref["composed_losses"] = _jax_composed_losses(
        jax.tree_util.tree_map(jnp.asarray, cstacked), jnp.asarray(x),
        jnp.asarray(inp["composed_target3"]))
    return ref


def _jax_composed_losses(cstacked, x, target3):
    mesh = jax_composed_mesh(data=2, model=2, pipe=2)
    stacked = jcomposed.place_composed_params(cstacked, mesh)
    tx, step_fn = jcomposed.build_composed_step(mesh, lr=1e-2)
    opt_state = tx.init(stacked)
    xmb, tmb = jax_microbatch(x, CM), jax_microbatch(target3, CM)
    losses = []
    for _ in range(3):
        stacked, opt_state, loss = step_fn(stacked, opt_state, xmb, tmb)
        losses.append(float(loss))
    return losses


def _run(root):
    inp = _inputs()
    procs = worker.spawn("pipeline", WORLD, str(root), inp)
    ref = _refs(inp)      # while the ranks run
    return {"ref": ref, "ranks": worker.collect(procs, str(root))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results and JAX's references, once a session."""
    return worker.shared(tmp_path_factory, "torch_pipeline", _run)


def _gpipe(run, rank):
    return run["ranks"][rank]["scenario_gpipe"]


def test_gpipe_forward_matches_sequential(run):
    for rank in range(S):
        got = _gpipe(run, rank)
        # the memory point: each rank holds exactly one stage's weights
        assert got["placed_shape"] == (1, D, D)
        np.testing.assert_allclose(got["forward"].reshape(8, 6, D),
                                   run["ref"]["forward"], atol=1e-6)


def test_gpipe_grad_matches_sequential(run):
    """Autograd through the ticks (the shifts run backward in reverse)
    equals the sequential backward, for the stacked weights and x."""
    got = _gpipe(run, 0)
    assert got["grad_loss"] == pytest.approx(run["ref"]["grad_loss"],
                                             rel=1e-6)
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g, run["ref"]["grads"][k], atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["grad_x"], run["ref"]["grad_x"],
                               atol=1e-6)


def test_gpipe_composes_with_data_parallel(run):
    for rank in range(WORLD):
        np.testing.assert_allclose(
            _gpipe(run, rank)["dp"].reshape(8, 4, D), run["ref"]["dp"],
            atol=1e-6)


def test_gpipe_transformer_stack(run):
    """The transformer block (the UNet mid-block's geometry) runs as
    stages unchanged, its weights carried from JAX's stacked trees."""
    np.testing.assert_allclose(_gpipe(run, 0)["block"].reshape(4, 12, 16),
                               run["ref"]["block"], atol=2e-5, rtol=1e-5)


def test_gpipe_fewer_microbatches_than_stages(run):
    np.testing.assert_allclose(_gpipe(run, 0)["few"], run["ref"]["few"],
                               atol=1e-6)


def test_gpipe_grad_finite_with_sqrt_stage(run):
    """Warm-up ticks run on real data: a discarded warm-up output's zero
    gradient through sqrt would otherwise be NaN."""
    for rank in range(S):
        got = _gpipe(run, rank)
        assert got["sqrt_grads_finite"]
        np.testing.assert_allclose(got["sqrt_forward"].reshape(8, 6, D),
                                   run["ref"]["sqrt"], atol=1e-6)


def _composed(run, rank):
    return run["ranks"][rank]["scenario_composed"]


def test_composed_forward_matches_sequential(run):
    for rank in range(WORLD):
        got = _composed(run, rank)
        # one stage and half of every kernel on each rank
        assert got["local_shapes"] == {"g": (1, CD), "wv": (1, CD, INNER // 2),
                                       "wg": (1, CD, INNER // 2),
                                       "wo": (1, INNER // 2, CD)}
        err = np.abs(got["forward"].reshape(CB, CT, CD)
                     - run["ref"]["composed_forward"]).max()
        assert err < 1e-5, err


def test_composed_gradients_match_sequential(run):
    got = _composed(run, 0)["grads"]
    for k, want in run["ref"]["composed_grads"].items():
        err = np.abs(got[k] - want).max()
        assert err < 1e-5, (k, err)


def test_composed_train_step_loss_decreases_and_placement_holds(run):
    want = run["ref"]["composed_losses"]
    for rank in range(WORLD):
        got = _composed(run, rank)
        assert all(np.isfinite(got["losses"])) and got["losses"][2] < \
            got["losses"][0]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        assert got["after_shapes"] == got["local_shapes"]
        assert got["moment_shapes"] == got["local_shapes"]


def test_gpipe_stage_count_mismatch_is_loud():
    """8 stacked stages on a 4-way pipe axis raise before anything runs,
    instead of running every second stage."""
    mesh = Mesh(np.arange(S, dtype=object).reshape(1, S), ("data", "pipe"))
    rng = np.random.default_rng(8)
    stacked = {"w": torch.from_numpy(rng.normal(size=(8, D, D))),
               "b": torch.from_numpy(rng.normal(size=(8, D)))}
    with pytest.raises(ValueError, match="stage axis 8"):
        gpipe(worker._toy_stage, stacked,
              microbatch(torch.zeros(4, 2, D, dtype=torch.float64), 2), mesh)
