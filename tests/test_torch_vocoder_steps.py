"""Two whole vocoder GAN steps through the port against the JAX
package's ``build_vocoder_train_step``, on the CPU, per family: HiFiGAN
(mel in) and SiFiGAN (sine, aux features and dense factors in, stage 9's
conditioning), from the same random parameters (flax's shapes, carried
across by the param bridge), with optax's AdamW chain.  In a file of
their own: JAX traces each family's step program once, 10-20 s on this
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from serenade_tpu.sifigan import SiFiGANGenerator as JaxSiFiGAN
from serenade_tpu.trainers import vocoder_trainer as jtrainer
from serenade_tpu.vocoder.hifigan import (
    HiFiGANGenerator as JaxHiFiGAN,
    MultiPeriodDiscriminator as JaxMPD,
)

from serenade_tpu_torch.convert import state_dict_from_flax
from serenade_tpu_torch.sifigan.generator import SiFiGANGenerator
from serenade_tpu_torch.trainers import vocoder_trainer as ptrainer
from serenade_tpu_torch.trainers.train_step import Optimizer
from serenade_tpu_torch.vocoder.hifigan import (
    HiFiGANGenerator, MultiPeriodDiscriminator,
)
from test_torch_vocoder_losses import random_flax_params
from test_torch_vocoder_train import _singing_wav

SR = 24000
UP = (5, 4, 3, 2)        # SiFiGAN's hop 120 (5 ms)
HIFI = dict(in_channels=8, channels=16, upsample_scales=(4, 2),
            upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
            resblock_dilations=((1, 3),))
SIFI = dict(in_channels=14, channels=32, upsample_scales=UP,
            upsample_kernel_sizes=tuple(2 * u for u in UP),
            filter_resblock_kernel_sizes=(3,),
            filter_resblock_dilations=((1, 3),))
LR = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _optax(eps):
    return optax.chain(optax.clip_by_global_norm(10.0),
                       optax.adamw(LR, b1=0.8, b2=0.99, eps=eps))


def _family(name, item):
    """(JAX generator, JAX discriminator, port generator, port
    discriminator, JAX forward, port forward, batch) of one family."""
    rng = np.random.default_rng(7)
    if name == "hifigan":
        mel = rng.normal(size=(2, 16, 8)).astype(np.float32)
        t = np.arange(16 * 8) / SR
        wav = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                        0.3 * np.sin(2 * np.pi * 330 * t)])[..., None]
        batch = {"mel": mel, "wav": wav.astype(np.float32)}
        return (JaxHiFiGAN(**HIFI), JaxMPD(periods=(2, 3)),
                HiFiGANGenerator(**HIFI, resblock_backend="conv"),
                MultiPeriodDiscriminator(periods=(2, 3)), None, None, batch)
    batch = ptrainer.sample_sifigan_segments(
        [item], rng, 2, 8, 120, upsample_scales=UP)
    jgen = JaxSiFiGAN(**SIFI)
    pgen = SiFiGANGenerator(**SIFI, resblock_backend="conv")
    return (jgen, JaxMPD(periods=(2, 3)), pgen,
            MultiPeriodDiscriminator(periods=(2, 3)),
            jtrainer.sifigan_forward(jgen), ptrainer.sifigan_forward(pgen),
            batch)


@pytest.mark.parametrize("family", ["hifigan", "sifigan"])
def test_two_gan_steps_match_jax(family):
    """Two alternating steps (the discriminator, then the generator
    against the updated discriminator) from the same random parameters,
    against the multi-period discriminator: every metric within 1e-3
    relative (1.6e-4 measured, SiFiGAN's adversarial loss after the
    first update), every parameter of both networks within 2 x lr x 1e-3 of
    JAX's.  The optimizers are ``adamw_chain``'s but for AdamW's eps, 1e-3
    on both sides: with 1e-8 a gradient near
    zero whose sign is only rounding moves its weight by the full rate on
    one side and not the other.  Here in f32, against the multi-period
    discriminator and without the residual loss: JAX's f32 STFT at fft
    2048 puts UnivNet's first update 0.9 % of a step from the port's (f64
    sums), which Adam compounds to a whole step by the second, and JAX's
    f32 residual loss is far from its own f64 one
    (``test_torch_vocoder_losses``).  The recipes' adversaries and the
    residual loss take whole steps in f64 in
    ``test_torch_vocoder_recipe_steps``."""
    item = (jtrainer.prepare_sifigan_utterance(
        _singing_wav(), SR, mcep_dim=10, upsample_scales=UP)
        if family == "sifigan" else None)
    jgen, jdisc, pgen, pdisc, jfwd, pfwd, batch = _family(family, item)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    if family == "hifigan":
        gparams = random_flax_params(jgen, jbatch["mel"], seed=1)
    else:
        gparams = random_flax_params(jgen, jbatch["sine"], jbatch["c"],
                                     list(jbatch["dfs"]), seed=1)
    dparams = random_flax_params(jdisc, jbatch["wav"], seed=2)
    gen_tx, disc_tx = _optax(1e-3), _optax(1e-3)
    jstate = jtrainer.create_vocoder_state(gparams, dparams, gen_tx, disc_tx)
    jstep = jtrainer.build_vocoder_train_step(
        jgen, jdisc, gen_tx, disc_tx, sampling_rate=SR, donate=False,
        gen_forward=jfwd)

    pgen.load_state_dict(state_dict_from_flax(pgen, gparams), strict=True)
    pdisc.load_state_dict(state_dict_from_flax(pdisc, dparams), strict=True)
    gopt, dopt = (Optimizer("AdamW", lambda _: LR, grad_norm=10.0, b1=0.8,
                            b2=0.99, eps=1e-3, weight_decay=1e-4)
                  for _ in range(2))
    state = ptrainer.create_vocoder_state(pgen, pdisc, gopt, dopt)
    step = ptrainer.build_vocoder_train_step(pgen, pdisc, gopt, dopt,
                                             sampling_rate=SR,
                                             gen_forward=pfwd)
    pbatch = ptrainer.batch_to_device(batch, torch.device("cpu"))
    for i in range(2):
        jstate, jm = jstep(jstate, jbatch, jax.random.key(i))
        state, pm = step(state, pbatch)
        for k, v in jm.items():
            np.testing.assert_allclose(float(pm[k]), float(v), rtol=1e-3,
                                       err_msg=f"{k} step {i}")
    assert state.step == int(jstate.step) == 2
    for module, tree in ((pgen, jstate.gen_params),
                         (pdisc, jstate.disc_params)):
        want = state_dict_from_flax(module, jax.tree_util.tree_map(
            np.asarray, tree))
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=0, atol=2 * LR * 1e-3,
                                       err_msg=name)
            assert p.grad is None, name
