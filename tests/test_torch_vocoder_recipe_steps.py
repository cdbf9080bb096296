"""Two whole vocoder GAN steps per family against the JAX package's
``build_vocoder_train_step``, on the CPU, with each recipe's adversary:
HiFiGAN against the multi-scale + multi-period discriminator, SiFiGAN
against UnivNet's multi-resolution spectral + multi-period one, with the
residual loss on the source network's excitation (``lambda_reg`` 1,
``reg_loss_fn`` on ``sifigan_forward(with_excitation=True)``).  Both
sides run in f64 (flax modules of ``dtype`` and ``param_dtype`` f64
under ``jax.enable_x64``, the port's modules in f64): in f32, JAX's STFT
at fft 2048 and its CheapTrick drift from their own f64 values by more
than a step's tolerance (``test_torch_vocoder_steps``,
``test_torch_vocoder_losses``).  The adversaries are the composite
classes themselves, each period and scale discriminator in them narrowed
on both sides (their composites fix them at 66M and 41M parameters,
which take minutes and gigabytes in f64 here); the generators narrow.
In a file of their own, so that the test workers spread them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from serenade_tpu.sifigan import SiFiGANGenerator as JaxSiFiGAN
from serenade_tpu.trainers import vocoder_trainer as jtrainer
from serenade_tpu.vocoder import hifigan as jhifi
from serenade_tpu.vocoder import losses as jlosses
from serenade_tpu.vocoder.hifigan import (
    HiFiGANGenerator as JaxHiFiGAN,
    MultiScaleMultiPeriodDiscriminator as JaxMSDMPD,
)
from serenade_tpu.vocoder.univnet import (
    UnivNetMultiResolutionMultiPeriodDiscriminator as JaxUnivNet,
)

from serenade_tpu_torch.convert import state_dict_from_flax
from serenade_tpu_torch.sifigan.generator import SiFiGANGenerator
from serenade_tpu_torch.trainers import vocoder_trainer as ptrainer
from serenade_tpu_torch.trainers.train_step import Optimizer
from serenade_tpu_torch.vocoder import hifigan as phifi
from serenade_tpu_torch.vocoder import losses as plosses
from serenade_tpu_torch.vocoder.hifigan import (
    HiFiGANGenerator, MultiScaleMultiPeriodDiscriminator,
)
from serenade_tpu_torch.vocoder.univnet import (
    UnivNetMultiResolutionMultiPeriodDiscriminator,
)
from test_torch_vocoder_losses import random_flax_params
from test_torch_vocoder_steps import HIFI, LR, SIFI, SR, UP, _optax
from test_torch_vocoder_train import _singing_wav

F64 = dict(dtype=jnp.float64, param_dtype=jnp.float64)
# the widths the composites' period and scale discriminators take here
NARROW = {"PeriodDiscriminator": dict(channels=4, max_downsample_channels=32),
          "ScaleDiscriminator": dict(channels=16, max_downsample_channels=64)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(module):
    """``module`` computing in f64: its parameters, and the dtype its
    layers cast to."""
    module.double()
    for m in module.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return module


def _family(name):
    """(JAX generator, JAX discriminator, port generator, port
    discriminator, JAX step keywords, port step keywords, the batch in
    f64) of one family."""
    rng = np.random.default_rng(7)
    if name == "hifigan":
        t = np.arange(32 * 8) / SR
        wav = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                        0.3 * np.sin(2 * np.pi * 330 * t)])[..., None]
        batch = {"mel": rng.normal(size=(2, 32, 8)), "wav": wav}
        return (JaxHiFiGAN(**HIFI, **F64), JaxMSDMPD(**F64),
                HiFiGANGenerator(**HIFI, resblock_backend="conv"),
                MultiScaleMultiPeriodDiscriminator(), {}, {}, batch)
    # noise 60 dB under the tone, as a recording carries: above a pure
    # tone's four harmonics CheapTrick's envelope rests on its power
    # floor, where rounding alone moves its log by 0.1 between any two
    # implementations (the port's f32 and f64 among them)
    wav = _singing_wav() + 1e-3 * rng.normal(size=SR).astype(np.float32)
    item = jtrainer.prepare_sifigan_utterance(
        wav, SR, mcep_dim=10, upsample_scales=UP)
    # 24 frames: the 2,880 samples UnivNet's VALID stacks take
    batch = ptrainer.sample_sifigan_segments(
        [item], rng, 2, 24, 120, upsample_scales=UP)
    batch = {k: (tuple(np.float64(d) for d in v) if k == "dfs"
                 else np.float64(v)) for k, v in batch.items()}
    jgen = JaxSiFiGAN(**SIFI, **F64)
    pgen = SiFiGANGenerator(**SIFI, resblock_backend="conv")
    reg = dict(sampling_rate=SR, hop_size=120)
    return (jgen, JaxUnivNet(**F64), pgen,
            UnivNetMultiResolutionMultiPeriodDiscriminator(),
            dict(lambda_reg=1.0, gen_forward=jtrainer.sifigan_forward(
                jgen, with_excitation=True),
                reg_loss_fn=lambda aux, b: jlosses.residual_loss(
                    aux, b["wav"], b["cf0"], **reg)),
            dict(lambda_reg=1.0, gen_forward=ptrainer.sifigan_forward(
                pgen, with_excitation=True),
                reg_loss_fn=lambda aux, b: plosses.residual_loss(
                    aux, b["wav"], b["cf0"], **reg)),
            batch)


@pytest.fixture
def narrow(monkeypatch):
    """The composites build their period and scale discriminators by
    name from their module, on both sides: those names at NARROW's
    widths."""
    for module in (jhifi, phifi):
        for name, kw in NARROW.items():
            monkeypatch.setattr(module, name, functools.partial(
                getattr(module, name), **kw))


@pytest.mark.parametrize("family", ["hifigan", "sifigan"])
def test_two_recipe_gan_steps_match_jax_in_f64(family, narrow):
    """Two alternating steps from the same random parameters: every
    metric (the residual loss's among them) within 1e-6 relative (4e-7
    measured, UnivNet's adversarial loss), every parameter of both
    networks within 2 x lr x 1e-3 of JAX's, the tolerance of
    ``test_torch_vocoder_steps`` (2.0e-6 measured, SiFiGAN's), and no
    gradient left in a ``.grad``.  The optimizers are ``adamw_chain``'s
    but for AdamW's eps, 1e-3 on both sides, as there."""
    jgen, jdisc, pgen, pdisc, jkw, pkw, batch = _family(family)
    with jax.enable_x64(True):
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
        if family == "hifigan":
            gparams = random_flax_params(jgen, jbatch["mel"], seed=1,
                                         dtype=np.float64)
        else:
            gparams = random_flax_params(jgen, jbatch["sine"], jbatch["c"],
                                         list(jbatch["dfs"]), seed=1,
                                         dtype=np.float64)
        dparams = random_flax_params(jdisc, jbatch["wav"], seed=2,
                                     dtype=np.float64)
        gen_tx, disc_tx = _optax(1e-3), _optax(1e-3)
        jstate = jtrainer.create_vocoder_state(gparams, dparams, gen_tx,
                                               disc_tx)
        jstep = jtrainer.build_vocoder_train_step(
            jgen, jdisc, gen_tx, disc_tx, sampling_rate=SR, donate=False,
            **jkw)
        jms = []
        for i in range(2):
            jstate, jm = jstep(jstate, jbatch, jax.random.key(i))
            jms.append({k: float(v) for k, v in jm.items()})
        want = [state_dict_from_flax(module, jax.tree_util.tree_map(
            np.asarray, tree)) for module, tree in (
            (pgen, jstate.gen_params), (pdisc, jstate.disc_params))]
        jstep_count = int(jstate.step)
        del jstate, jstep

    pgen.load_state_dict(state_dict_from_flax(pgen, gparams), strict=True)
    pdisc.load_state_dict(state_dict_from_flax(pdisc, dparams), strict=True)
    _f64(pgen)
    _f64(pdisc)
    gopt, dopt = (Optimizer("AdamW", lambda _: LR, grad_norm=10.0, b1=0.8,
                            b2=0.99, eps=1e-3, weight_decay=1e-4)
                  for _ in range(2))
    state = ptrainer.create_vocoder_state(pgen, pdisc, gopt, dopt)
    step = ptrainer.build_vocoder_train_step(pgen, pdisc, gopt, dopt,
                                             sampling_rate=SR, **pkw)
    pbatch = ptrainer.batch_to_device(batch, torch.device("cpu"))
    for i in range(2):
        state, pm = step(state, pbatch)
        assert set(pm) == set(jms[i])
        for k, v in jms[i].items():
            np.testing.assert_allclose(float(pm[k]), v, rtol=1e-6,
                                       err_msg=f"{k} step {i}")
    assert state.step == jstep_count == 2
    for module, w in zip((pgen, pdisc), want):
        for name, p in module.named_parameters():
            assert p.dtype == torch.float64, name
            np.testing.assert_allclose(p.detach().numpy(), w[name].numpy(),
                                       rtol=0, atol=2 * LR * 1e-3,
                                       err_msg=name)
            assert p.grad is None, name
