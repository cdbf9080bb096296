"""The port's vocoder discriminators and GAN losses against the JAX
package's, on the CPU, in values and in gradients.

``vocoder/hifigan.py`` (period, multi-period, scale, multi-scale and
multi-scale + multi-period discriminators) and ``vocoder/univnet.py``
(spectral, multi-resolution spectral and UnivNet + multi-period) on
random parameters of flax's shapes (``jax.eval_shape``) carried across by
the param bridge: each family's scores and feature maps, and for a
period, a scale and a spectral discriminator the gradients of an
adversarial + feature-matching loss with respect to the parameters and
to the waveform, against ``jax.value_and_grad`` of the same loss.  ``vocoder/losses.py``: the adversarial, feature-matching and
multi-resolution mel losses, and ``residual_loss`` against JAX's under
``jax.enable_x64`` (the port's CheapTrick sums in f64) and, more
loosely, in f32.  Waveforms of 3,001 samples: no multiple of any period,
so the period discriminators reflect-pad, and 13 frames at UnivNet's
hop 240, the fewest its VALID stack takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serenade_tpu.vocoder import hifigan as jhifi
from serenade_tpu.vocoder import losses as jlosses
from serenade_tpu.vocoder import univnet as juniv

from serenade_tpu_torch.convert import state_dict_from_flax
from serenade_tpu_torch.vocoder import hifigan as phifi
from serenade_tpu_torch.vocoder import losses as plosses
from serenade_tpu_torch.vocoder import univnet as puniv

SR, T = 24000, 3001
SPECTRAL = dict(fft_size=512, hop_size=120, win_length=240, channels=8)
# single discriminators: (JAX's, the port's)
SINGLE = {
    "period": (lambda: jhifi.PeriodDiscriminator(period=7),
               lambda: phifi.PeriodDiscriminator(period=7)),
    "scale": (jhifi.ScaleDiscriminator, phifi.ScaleDiscriminator),
    "spectral": (lambda: juniv.SpectralDiscriminator(**SPECTRAL),
                 lambda: puniv.SpectralDiscriminator(**SPECTRAL)),
}
# the adversaries made of them: HiFiGAN's and UnivNet's
COMPOSITE = {
    "msd_mpd": (jhifi.MultiScaleMultiPeriodDiscriminator,
                phifi.MultiScaleMultiPeriodDiscriminator),
    "univnet": (juniv.UnivNetMultiResolutionMultiPeriodDiscriminator,
                puniv.UnivNetMultiResolutionMultiPeriodDiscriminator),
}
# f32 through up to eight conv layers (the port's STFT sums in f64), each
# tensor against its largest magnitude: values; the single
# discriminators' gradients (measured within 1e-5)
REL_TOL, GRAD_TOL = 2e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_flax_params(module, *args, seed=0, dtype=np.float32):
    """Random leaves of flax ``init``'s shapes in ``dtype``: kernels
    N(0, 1/fan_in), biases N(0, 0.05^2) (no compile of ``init``)."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
                dtype)
        return (0.05 * rng.normal(size=s.shape)).astype(dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _t(a):
    return torch.from_numpy(np.array(a))


def _wavs(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / SR
    tone = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(
        2 * np.pi * 660.0 * t)
    real = (tone + 0.01 * rng.normal(size=T)).astype(np.float32)
    fake = (0.2 * rng.normal(size=T)).astype(np.float32)
    return (np.stack([real, real[::-1]])[..., None].copy(),
            np.stack([fake, 0.5 * real])[..., None].copy())


def assert_rel_close(got, want, tol=REL_TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, (what, err)


def _port_layout(a):
    """A JAX feature map in the port's layout: NHWC -> NCHW (2-D convs);
    1-D maps are channels-last on both sides."""
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def _outs(outs):
    return outs if isinstance(outs, list) else [outs]


def _run_both(make_jax, make_port, grads: bool):
    """JAX's and the port's outputs on ``_wavs``' fake batch, from the
    same random parameters; with ``grads``, the loss ``adv(D(y)) +
    fm(D(y), D(x))`` (the real batch's maps held constant) and its
    gradients with respect to the parameters and to ``y``."""
    jdisc, pdisc = make_jax(), make_port()
    real, fake = _wavs()
    params = random_flax_params(jdisc, jnp.asarray(real))
    pdisc.load_state_dict(state_dict_from_flax(pdisc, params), strict=True)
    y = _t(fake).requires_grad_(grads)
    outs_y = _outs(pdisc(y))
    if not grads:
        jouts = _outs(jax.jit(jdisc.apply)(params, jnp.asarray(fake)))
        return jouts, outs_y, None

    def jloss(p, y, x):
        outs_y = _outs(jdisc.apply(p, y))
        outs_x = jax.lax.stop_gradient(_outs(jdisc.apply(p, x)))
        loss = (jlosses.generator_adversarial_loss(outs_y)
                + jlosses.feature_matching_loss(outs_y, outs_x))
        return loss, outs_y

    (jl, jouts), (jg_p, jg_y) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(fake),
                                              jnp.asarray(real))
    with torch.no_grad():
        outs_x = _outs(pdisc(_t(real)))
    loss = (plosses.generator_adversarial_loss(outs_y)
            + plosses.feature_matching_loss(outs_y, outs_x))
    loss.backward()
    assert_rel_close(loss.detach(), jl, 1e-5, "loss")
    assert_rel_close(y.grad, jg_y, GRAD_TOL, "d/dy")
    want = state_dict_from_flax(pdisc, jax.tree_util.tree_map(np.asarray,
                                                              jg_p))
    for name, p in pdisc.named_parameters():
        assert_rel_close(p.grad, want[name], GRAD_TOL, name)
    return jouts, outs_y, pdisc


def _assert_outputs_close(jouts, pouts):
    assert len(pouts) == len(jouts)
    for k, ((ps, pf), (js, jf)) in enumerate(zip(pouts, jouts)):
        assert_rel_close(ps.detach(), _port_layout(js), what=f"score {k}")
        assert len(pf) == len(jf)
        for i, (a, b) in enumerate(zip(pf, jf)):
            assert_rel_close(a.detach(), _port_layout(b),
                             what=f"fmap {k}.{i}")


@pytest.mark.parametrize("family", sorted(SINGLE))
def test_discriminator_matches_jax_in_values_and_gradients(family):
    """A period (period 7: the waveform reflect-padded), a scale (its
    grouped convs) and a spectral discriminator: scores, feature maps,
    the loss and its gradients against ``jax.value_and_grad``."""
    _assert_outputs_close(*_run_both(*SINGLE[family], grads=True)[:2])


@pytest.mark.parametrize("family", sorted(COMPOSITE))
def test_adversary_matches_jax(family):
    """HiFiGAN's multi-scale + multi-period adversary (three scale
    discriminators on average-pooled waveforms, five periods) and
    UnivNet's (three STFT resolutions, five periods): every
    discriminator's score and feature maps, in JAX's order.  Their
    gradients are the sums of their parts', held above."""
    jouts, pouts, _ = _run_both(*COMPOSITE[family], grads=False)
    assert len(pouts) == 8
    _assert_outputs_close(jouts, pouts)


def test_spectral_discriminator_refuses_short_segments():
    disc = puniv.SpectralDiscriminator(fft_size=512, hop_size=120,
                                       win_length=240, channels=8)
    with pytest.raises(ValueError, match="segment too short"):
        disc(torch.zeros(1, 120 * 11, 1))


def test_adversarial_and_feature_matching_losses_match_jax():
    """LSGAN generator and discriminator losses and feature matching on
    seeded (score, fmaps) lists, and their gradients."""
    rng = np.random.default_rng(3)

    def outs():
        return [(rng.normal(size=(2, 5, 1)).astype(np.float32),
                 [rng.normal(size=(2, 7, 4)).astype(np.float32)
                  for _ in range(3)]) for _ in range(4)]

    real, fake = outs(), outs()

    def jall(fake):
        return (jlosses.generator_adversarial_loss(fake)
                + 2.0 * jlosses.discriminator_adversarial_loss(real, fake)
                + 3.0 * jlosses.feature_matching_loss(fake, real))

    jl, jg = jax.value_and_grad(jall)(fake)
    pfake = [(_t(s).requires_grad_(True), [_t(f).requires_grad_(True)
                                           for f in fm]) for s, fm in fake]
    preal = [(_t(s), [_t(f) for f in fm]) for s, fm in real]
    assert_rel_close(plosses.generator_adversarial_loss(pfake).detach(),
                     jlosses.generator_adversarial_loss(fake), 1e-6, "adv")
    assert_rel_close(plosses.feature_matching_loss(pfake, preal).detach(),
                     jlosses.feature_matching_loss(fake, real), 1e-6, "fm")
    pl = (plosses.generator_adversarial_loss(pfake)
          + 2.0 * plosses.discriminator_adversarial_loss(preal, pfake)
          + 3.0 * plosses.feature_matching_loss(pfake, preal))
    pl.backward()
    assert_rel_close(pl.detach(), jl, 1e-6, "loss")
    for (ps, pf), (js, jf) in zip(pfake, jg):
        assert_rel_close(ps.grad, js, 1e-6, "d/dscore")
        for a, b in zip(pf, jf):
            assert_rel_close(a.grad, b, 1e-6, "d/dfmap")


def test_multi_resolution_mel_loss_matches_jax():
    """The three-resolution log-mel L1 and its gradient with respect to
    the generated waveforms (batched, and one waveform)."""
    real, fake = (w[..., 0] for w in _wavs(4))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda a, b: jlosses.multi_resolution_mel_loss(a, b, SR)))(
        jnp.asarray(fake), jnp.asarray(real))
    y = _t(fake).requires_grad_(True)
    loss = plosses.multi_resolution_mel_loss(y, _t(real), SR)
    loss.backward()
    assert_rel_close(loss.detach(), jl, 1e-5, "loss")
    assert_rel_close(y.grad, jg, 1e-3, "d/dy")
    one = plosses.multi_resolution_mel_loss(_t(fake[0]), _t(real[0]), SR)
    assert_rel_close(one, jlosses.multi_resolution_mel_loss(
        jnp.asarray(fake[0]), jnp.asarray(real[0]), SR), 1e-5, "one")


def test_residual_loss_matches_jax():
    """SiFiGAN's source regularization (fft 2048, hop 120, CheapTrick
    with the 0th cepstrum eliminated) on a sung tone with a continuous F0
    track, and its gradient with respect to the excitation: against
    JAX's run in f64 within 1e-4 (value) and 2e-3 (gradient, each
    against its largest element).  JAX's f32 run is far from its own f64
    one (13.20 against 8.87 here: at fft 2048 its f32 CheapTrick's log
    envelope errs by up to 17, 2.7 on average), the port at least ten
    times nearer."""
    n_frames, hop = 40, 120
    t = np.arange(n_frames * hop) / SR
    f0 = 220.0 * (1 + 0.03 * np.sin(2 * np.pi * 3 * np.arange(n_frames)
                                    / n_frames))
    phase = 2 * np.pi * np.cumsum(np.repeat(f0, hop)) / SR
    wav = sum((0.3 / h) * np.sin(h * phase) for h in range(1, 6))
    rng = np.random.default_rng(6)
    wav = (wav + 1e-3 * rng.normal(size=t.size))[None, :, None]
    src = (0.1 * np.sin(phase) + 0.01 * rng.normal(size=t.size))[None, :,
                                                                  None]
    cf0 = f0[None]
    with jax.enable_x64(True):
        exact, exact_g = jax.value_and_grad(jlosses.residual_loss)(
            jnp.asarray(src, jnp.float64), jnp.asarray(wav, jnp.float64),
            jnp.asarray(cf0, jnp.float64), sampling_rate=SR, hop_size=hop)
    f32 = float(jax.jit(lambda s, w, c: jlosses.residual_loss(
        s, w, c, sampling_rate=SR, hop_size=hop))(
        *(jnp.asarray(a, jnp.float32) for a in (src, wav, cf0))))
    s = _t(src.astype(np.float32)).requires_grad_(True)
    loss = plosses.residual_loss(s, _t(wav.astype(np.float32)),
                                 _t(cf0.astype(np.float32)),
                                 sampling_rate=SR, hop_size=hop)
    loss.backward()
    assert_rel_close(loss.detach(), exact, 1e-4, "loss")
    assert_rel_close(s.grad, exact_g, 2e-3, "d/dsource")
    assert 10 * abs(float(loss.detach()) - float(exact)) < abs(f32 - float(exact))
