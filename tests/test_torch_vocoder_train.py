"""Vocoder training through the port against the JAX package, on the CPU.

``trainers/vocoder_trainer.py``: the segment samplers draw for draw
and ``prepare_sifigan_utterance``; ``bin/sifigan_extract_features.py``
against JAX's CLI; the networks ``bin/vocoder_train.py`` builds; and the
residual block's ``conv`` training backend against its ``fused`` one.
Two whole GAN steps per family are in ``tests/test_torch_vocoder_steps.py``,
the training CLI's runs in ``tests/test_torch_vocoder_cli.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serenade_tpu.trainers import vocoder_trainer as jtrainer
from serenade_tpu.utils import h5 as jh5
from serenade_tpu.utils.audio import write_wav

from serenade_tpu_torch.bin import sifigan_extract_features as pextract
from serenade_tpu_torch.bin import vocoder_train as ptrain
from serenade_tpu_torch.trainers import vocoder_trainer as ptrainer
from serenade_tpu_torch.vocoder.layers import HiFiGANResidualBlock
import torch_parallel_worker as worker

SR = 24000
UP = (5, 4, 3, 2)        # SiFiGAN's hop 120 (5 ms)
HIFI = dict(in_channels=8, channels=16, upsample_scales=(4, 2),
            upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
            resblock_dilations=((1, 3),))
LR = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _singing_wav(dur=1.0, f0=220.0):
    t = np.arange(int(SR * dur)) / SR
    f0t = f0 * (1 + 0.02 * np.sin(2 * np.pi * 5.0 * t))
    ph = 2 * np.pi * np.cumsum(f0t) / SR
    return sum((0.4 / h) * np.sin(h * ph) for h in range(1, 5)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def sifigan_item():
    """One sung utterance prepared by each side (mcep order 10)."""
    wav = _singing_wav()
    kw = dict(mcep_dim=10, upsample_scales=UP)
    return (ptrainer.prepare_sifigan_utterance(wav, SR, device="cpu", **kw),
            jtrainer.prepare_sifigan_utterance(wav, SR, **kw))


def test_segment_samplers_match_jax(sifigan_item):
    """The same crops as JAX's from the same numpy seed, for (mel, wav)
    and for the SiFiGAN streams (JAX's prepared item on both sides)."""
    items = [{"logmel": np.arange(100 * 4).reshape(100, 4).astype(
        np.float32), "wave": np.arange(100 * 240).astype(np.float32)},
        {"logmel": np.ones((20, 4), np.float32),
         "wave": np.ones(20 * 240 - 7, np.float32)}]
    got = ptrainer.sample_mel_wav_segments(
        items, np.random.default_rng(0), 5, 24, 240)
    want = jtrainer.sample_mel_wav_segments(
        items, np.random.default_rng(0), 5, 24, 240)
    for k in ("mel", "wav"):
        np.testing.assert_array_equal(got[k], want[k])
    item = sifigan_item[1]
    got = ptrainer.sample_sifigan_segments(
        [item], np.random.default_rng(1), 3, 8, 120, upsample_scales=UP)
    want = jtrainer.sample_sifigan_segments(
        [item], np.random.default_rng(1), 3, 8, 120, upsample_scales=UP)
    for k in ("c", "sine", "wav", "cf0"):
        np.testing.assert_array_equal(got[k], want[k])
    for g, w in zip(got["dfs"], want["dfs"]):
        np.testing.assert_array_equal(g, w)


def _f64_mcep_bap(wav, n_frames, mcep_dim=10):
    """JAX's ops in f64 (``jax.enable_x64``) on the bucket-padded input
    the port analyses, from JAX's smoothed YIN F0: the mel-cepstrum of
    CheapTrick and band aperiodicity, as ``tests/test_torch_sifigan.py``
    holds ``world_mcep_bap``."""
    from serenade_tpu.ops import world as jworld
    from serenade_tpu.ops.f0 import smooth_f0_median, yin_f0
    from serenade_tpu.ops.sptk import sp2mc

    f0 = np.asarray(smooth_f0_median(yin_f0(
        jnp.asarray(wav), fs=SR, f0_floor=70.0, f0_ceil=800.0,
        frame_period_ms=5.0)[0]))
    padded = 128 * 120 * -(-len(wav) // (128 * 120))
    with jax.enable_x64(True):
        args = (jnp.asarray(np.pad(wav, (0, padded - len(wav))), jnp.float64),
                jnp.asarray(np.pad(f0, (0, 1 + padded // 120 - len(f0))),
                            jnp.float64))
        sp = np.asarray(jworld.cheaptrick(*args, fs=SR))[:n_frames]
        bap = np.asarray(jworld.band_aperiodicity(*args, fs=SR))[:n_frames]
    return sp2mc(sp, mcep_dim, 0.466), bap


def test_prepare_sifigan_utterance_matches_jax(sifigan_item):
    """Each stream of one utterance: the same frame count and waveform,
    the continuous F0 within 1e-4 relative, the excitation within 1e-3
    (its phase is the F0's running sum), the dense factors within 1e-3
    relative; the aux features against JAX's ops in f64 (JAX's f32
    CheapTrick puts its mel-cepstrum of this noiseless tone whole units
    from its own f64 one, 2.6 at the second frame).  On the noiseless
    tone the spectral valleys and the top aperiodicity band are empty and
    the port's f32 spectra round there: the mel-cepstrum within 1e-2
    (4.5e-3 measured) and band aperiodicity within 0.25 dB (0.238 in the
    top band).  With breath noise (0.01), the mel-cepstrum within 1e-4
    and band aperiodicity within 1e-2 dB (7.7e-3 measured)."""
    got, want = sifigan_item
    n = want["c"].shape[0]
    assert got["c"].shape == want["c"].shape == (n, 14)
    np.testing.assert_array_equal(got["wav"], want["wav"])
    np.testing.assert_allclose(got["cf0"], want["cf0"], rtol=1e-4)
    np.testing.assert_allclose(got["sine"], want["sine"], atol=1e-3)
    for g, w in zip(got["dfs"], want["dfs"]):
        np.testing.assert_allclose(g, w, rtol=1e-3)
    mcep, bap = _f64_mcep_bap(_singing_wav(), n)
    np.testing.assert_allclose(got["c"][:, :11], mcep, atol=1e-2, rtol=0)
    np.testing.assert_allclose(got["c"][:, 11:], bap, atol=0.25, rtol=0)
    noisy = _singing_wav() + 0.01 * np.random.default_rng(0).standard_normal(
        SR).astype(np.float32)
    got = ptrainer.prepare_sifigan_utterance(noisy, SR, mcep_dim=10,
                                             upsample_scales=UP,
                                             device="cpu")
    mcep, bap = _f64_mcep_bap(noisy, got["c"].shape[0])
    np.testing.assert_allclose(got["c"][:, :11], mcep, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["c"][:, 11:], bap, atol=1e-2, rtol=0)


def test_conv_backend_equals_fused_on_the_cpu():
    """The training backend (a differentiable conv chain) computes what
    the inference backend's plain version computes, with and without
    additional convs; an unknown backend is refused."""
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(2, 50, 16)).astype(np.float32))
    for add in (True, False):
        fused = HiFiGANResidualBlock(5, 16, (1, 3), add)
        conv = HiFiGANResidualBlock(5, 16, (1, 3), add, backend="conv")
        from serenade_tpu_torch.models.layers import init_params_

        init_params_(fused, 4)
        conv.load_state_dict(fused.state_dict())
        with torch.no_grad():
            np.testing.assert_allclose(conv(x).numpy(), fused(x).numpy(),
                                       rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="backend"):
        HiFiGANResidualBlock(backend="pallas")


def _run_jax_cli(main, argv):
    old, sys.argv = sys.argv, ["prog"] + argv
    try:
        main()
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """A tiny feature dump (``wave``, ``logmel`` 8 mels at hop 48) of two
    sung utterances, and their wav.scp; written once a test run."""
    return worker.shared(tmp_path_factory, "torch_vocoder_dump", _make_dump)


def _make_dump(root):
    lines = []
    for i, f0 in enumerate((220.0, 330.0)):
        wav = _singing_wav(1.0, f0)
        h5 = str(root / "dump" / f"utt{i}.h5")
        jh5.write_hdf5(h5, "wave", wav)
        jh5.write_hdf5(h5, "logmel", np.random.default_rng(i).normal(
            size=(len(wav) // 48, 8)).astype(np.float32))
        path = root / f"utt{i}.wav"
        write_wav(str(path), wav, SR)
        lines.append(f"utt{i} {path}\n")
    (root / "wav.scp").write_text("".join(lines))
    return root


def test_extract_features_cli_matches_jax(dump, tmp_path):
    """``bin/sifigan_extract_features.py`` against JAX's CLI on the same
    wav.scp: the same files and keys, each stream but ``c`` within the
    tolerances of ``test_prepare_sifigan_utterance_matches_jax``, and
    ``c`` (where JAX's f32 analysis errs on these noiseless tones) equal
    to the port's ``prepare_sifigan_utterance``; ``load_precomputed``
    reads the dumps back for the trainer."""
    from serenade_tpu.bin.sifigan_extract_features import main as jmain

    from serenade_tpu_torch.utils.audio import read_wav

    argv = ["--wav-scp", str(dump / "wav.scp"), "--mcep-dim", "10",
            "--verbose", "0"]
    _run_jax_cli(jmain, argv + ["--dumpdir", str(tmp_path / "jax")])
    pextract.main(argv + ["--dumpdir", str(tmp_path / "port"), "--device",
                          "cpu"])
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        os.listdir(tmp_path / "port")) == ["utt0.h5", "utt1.h5"]
    got = pextract.load_precomputed(str(tmp_path / "port"))
    want = pextract.load_precomputed(str(tmp_path / "jax"))
    for g, w, f0 in zip(got, want, (220.0, 330.0)):
        assert g["c"].shape == w["c"].shape and len(g["dfs"]) == 4
        np.testing.assert_array_equal(g["wav"], w["wav"])
        np.testing.assert_allclose(g["cf0"], w["cf0"], rtol=1e-4)
        np.testing.assert_allclose(g["sine"], w["sine"], atol=1e-3)
        for a, b in zip(g["dfs"], w["dfs"]):
            np.testing.assert_allclose(a, b, rtol=1e-3)
        item = ptrainer.prepare_sifigan_utterance(
            read_wav(str(dump / f"utt{f0 == 330.0:d}.wav"))[0], SR,
            mcep_dim=10, device="cpu")
        np.testing.assert_array_equal(g["c"], item["c"])


def test_cli_builds_jax_clis_networks():
    """The CLI's generators (on the conv backend) and adversaries are the
    JAX CLI's: HiFiGAN (8, 6, 5) at hop 240 against the multi-scale +
    multi-period discriminators, SiFiGAN at hop 120 against UnivNet's; a
    product of scales that is not the hop is refused."""
    from serenade_tpu_torch.vocoder.hifigan import (
        MultiScaleMultiPeriodDiscriminator,
    )
    from serenade_tpu_torch.vocoder.univnet import (
        UnivNetMultiResolutionMultiPeriodDiscriminator,
    )

    gen, hop = ptrain.build_generator({}, "hifigan")
    assert hop == 240 and gen.upsample_scales == (8, 6, 5)
    assert all(b.backend == "conv" for b in gen.modules()
               if isinstance(b, HiFiGANResidualBlock))
    gen, hop = ptrain.build_generator({"mcep_dim": 39}, "sifigan")
    assert hop == 120 and gen.input_conv.weight.shape[1] == 43
    assert isinstance(ptrain.build_discriminator("msd_mpd"),
                      MultiScaleMultiPeriodDiscriminator)
    assert isinstance(ptrain.build_discriminator("univnet"),
                      UnivNetMultiResolutionMultiPeriodDiscriminator)
    with pytest.raises(SystemExit, match="must equal hop"):
        ptrain.build_generator({"hop_size": 256}, "hifigan")
