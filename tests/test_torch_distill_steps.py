"""The endpoint and reflow steps of the port's ``trainers/distill.py``
against ``serenade_tpu.trainers.distill.build_distill_step``, on the CPU:
two steps each from the same parameters, batches and JAX's own draws
(``test_torch_distill.py``'s widths and helpers), and the variant's steps
with its unrolled ``f0_fluc``.  JAX traces each step program once, about
15 s apiece; they sit in a file of their own so that they run beside
``test_torch_distill.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serenade_tpu.trainers import build_optimizer as jax_build_optimizer
from serenade_tpu.trainers import create_train_state as jax_create_state
from serenade_tpu.trainers import distill as jdistill

from serenade_tpu_torch.convert import state_dict_from_flax
from serenade_tpu_torch.trainers import build_optimizer, create_train_state
from serenade_tpu_torch.trainers.distill import (
    build_distill_step, distill_trainable_mask, frozen_teacher,
)
from test_torch_distill import (  # noqa: F401 (fixtures)
    OPT, TEACHER_STEPS, _batch, _port, _step_draws, jax_models,
    one_torch_thread,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["endpoint", "reflow"])
def test_two_distill_steps_match_jax(jax_models, mode):
    """Two steps of ``build_distill_step`` against JAX's with the same
    draws (student 2 Euler steps, teacher 3): the loss and the norm of
    all gradients within 1e-4, every parameter after two steps within
    1e-4 relative (AdamW eps 1e-3, f32 moments).  The encoder and the GST
    stay equal to the teacher's bit for bit, the estimator moves, and the
    teacher module is never written."""
    jmodel, params = jax_models["Serenade"]
    rng = np.random.default_rng(4)
    batches = [_batch(rng) for _ in range(2)]

    teacher = jax.tree_util.tree_map(jnp.asarray, params)
    tx, _ = jax_build_optimizer(
        OPT, trainable_mask=jdistill.distill_trainable_mask(teacher))
    jstate = jax_create_state(jax.tree_util.tree_map(jnp.copy, teacher), tx)
    jstep = jdistill.build_distill_step(
        jmodel, teacher, tx, mode=mode, student_steps=2,
        n_teacher_steps=TEACHER_STEPS, donate=False)

    pteacher = frozen_teacher(_port("Serenade", params))
    before = {k: v.clone() for k, v in pteacher.state_dict().items()}
    student = _port("Serenade", params)
    opt, _ = build_optimizer(
        OPT, trainable_mask=distill_trainable_mask(student))
    state = create_train_state(student, opt)
    step = build_distill_step(student, pteacher, opt, mode=mode,
                              student_steps=2,
                              n_teacher_steps=TEACHER_STEPS, device="cpu")
    for i, batch in enumerate(batches):
        key = jax.random.key(100 + i)
        jstate, jmetrics = jstep(
            jstate, jax.tree_util.tree_map(jnp.asarray, batch), key)
        state, metrics = step(state, batch, None, draws=_step_draws(key))
        assert set(metrics) == set(jmetrics)
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=1e-4, err_msg=f"{k} step {i}")
    want = state_dict_from_flax(student, jax.tree_util.tree_map(
        np.asarray, jstate.params))
    moved = 0
    for name, p in student.named_parameters():
        got = p.detach()
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        if name.startswith(("encoder.", "gst.")):
            assert torch.equal(got, before[name]), name
        else:
            moved += not torch.equal(got, before[name])
    assert moved > 0
    for name, v in pteacher.state_dict().items():
        assert torch.equal(v, before[name]), name


def test_variant_steps_freeze_like_the_main_model(jax_models):
    """SerenadeNew distills with its unrolled ``f0_fluc`` as the batch
    adapter hands it: one step of each mode from the generator's draws
    (no JAX counterpart runs, see ``test_make_reflow_batch_matches_jax``),
    finite losses, a frozen encoder and GST, an untouched teacher."""
    _, params = jax_models["SerenadeNew"]
    teacher = frozen_teacher(_port("SerenadeNew", params))
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    student = _port("SerenadeNew", params)
    opt, _ = build_optimizer(
        OPT, trainable_mask=distill_trainable_mask(student))
    state = create_train_state(student, opt)
    batch = _batch(np.random.default_rng(5), with_fluc=True)
    gen = torch.Generator().manual_seed(0)
    for mode in ("endpoint", "reflow"):
        step = build_distill_step(student, teacher, opt, mode=mode,
                                  n_teacher_steps=TEACHER_STEPS,
                                  device="cpu")
        state, metrics = step(state, batch, gen)
        assert all(np.isfinite(float(v)) for v in metrics.values())
    for name, v in student.state_dict().items():
        if name.startswith(("encoder.", "gst.")):
            assert torch.equal(v, before[name]), name
    for name, v in teacher.state_dict().items():
        assert torch.equal(v, before[name]), name
    with pytest.raises(ValueError, match="shares storage"):
        build_distill_step(teacher, teacher, opt, device="cpu")
    with pytest.raises(ValueError, match="unknown distillation mode"):
        build_distill_step(student, teacher, opt, mode="dmd", device="cpu")
