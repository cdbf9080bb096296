"""``bin/vocoder_train.py`` through the port, on the CPU: both families
trained on a tiny dump (HiFiGAN from ``logmel``/``wave``, SiFiGAN from the
streams of ``bin/sifigan_extract_features.py``, with the residual loss),
``--resume`` continuing a run exactly, and the trained checkpoint
directories read by ``load_vocoder`` and by stage 9
(``bin/ssc_postprocessing.py``), where the port refused them.  Small
widths: generator channels 16-32.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from serenade_tpu.utils import h5 as jh5
from serenade_tpu.utils.audio import write_wav

from serenade_tpu_torch import checkpoint as pckpt
from serenade_tpu_torch.bin import sifigan_extract_features as pextract
from serenade_tpu_torch.bin import ssc_postprocessing as post
from serenade_tpu_torch.bin import vocoder_train as ptrain
from serenade_tpu_torch.vocoder.vocoder import Vocoder, load_vocoder
import torch_parallel_worker as worker
from test_torch_vocoder_train import (  # noqa: F401 (fixtures)
    SR, _singing_wav, _t, dump, one_torch_thread,
)


def _voc_config(tmp_path, family):
    if family == "hifigan":
        # UnivNet's adversary (its VALID stack takes 2,880 samples, 60
        # frames): the default multi-scale one holds 40M parameters, whose
        # AdamW updates alone take 1.5 s a step on one CPU thread
        cfg = dict(sampling_rate=SR, num_mels=8, hop_size=48,
                   segment_frames=60, vocoder_batch_size=2,
                   discriminator_type="univnet",
                   generator_params=dict(channels=16, in_channels=8,
                                         upsample_scales=[8, 6],
                                         upsample_kernel_sizes=[16, 12]))
    else:
        cfg = dict(sampling_rate=SR, mcep_dim=10, segment_frames=24,
                   vocoder_batch_size=2, lambda_reg=1.0,
                   generator_params=dict(channels=32, in_channels=14))
    cfg.update(vocoder_train_max_steps=2, save_interval_steps=1,
               log_interval_steps=1)
    path = tmp_path / f"{family}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def trained(dump, tmp_path_factory):
    """Both families trained 2 steps by the CLI from the dump (the
    SiFiGAN from the extracted streams, with the residual loss), saving
    at each step, each against UnivNet's adversary: {family: (outdir,
    argv without --outdir)}.  HiFiGAN's default adversary is chosen by
    ``build_discriminator``, held below, and runs in
    ``test_torch_vocoder_losses`` and on the card.  Once a test run."""
    return worker.shared(tmp_path_factory, "torch_vocoder_trained",
                         lambda root: _train(dump, root))


def _train(dump, root):
    out = {}
    for family in ("hifigan", "sifigan"):
        argv = ["--train-dumpdir", str(dump / "dump"), "--config",
                str(_voc_config(root, family)), "--vocoder-type", family,
                "--device", "cpu", "--verbose", "0"]
        if family == "sifigan":
            feats = str(root / "feats")
            pextract.main(["--wav-scp", str(dump / "wav.scp"), "--dumpdir",
                           feats, "--mcep-dim", "10", "--device", "cpu",
                           "--verbose", "0"])
            argv += ["--sifigan-feats-dir", feats]
        ptrain.main(argv + ["--outdir", str(root / family)])
        out[family] = (str(root / family), argv)
    return out


@pytest.mark.parametrize("family", ["hifigan", "sifigan"])
def test_vocoder_train_cli_resumes(family, trained, tmp_path):
    """``bin/vocoder_train.py``: 2 steps straight, and 1 step then
    ``--resume`` to 2, give the same generator, discriminator and
    optimizer states exactly (the resumed run's sampler restored from the
    checkpoint's ``meta``); the HiFiGAN run writes identity ``stats.h5`` and its
    ``config.yml``."""
    straight, argv = trained[family]
    cfg = argv[argv.index("--config") + 1]
    short = tmp_path / "short.yml"
    short.write_text(yaml.safe_dump(dict(
        yaml.safe_load(open(cfg)), vocoder_train_max_steps=1)))
    argv1 = [str(short) if a == cfg else a for a in argv]
    resumed = str(tmp_path / "resumed")
    ptrain.main(argv1 + ["--outdir", resumed])
    assert sorted(os.listdir(resumed)) == (
        ["checkpoint-1steps", "config.yml", "stats.h5"]
        if family == "hifigan" else ["checkpoint-1steps"])
    ptrain.main(argv + ["--outdir", resumed, "--resume", "latest"])
    a = pckpt.restore_checkpoint(os.path.join(straight, "checkpoint-2steps"))
    b = pckpt.restore_checkpoint(os.path.join(resumed, "checkpoint-2steps"))
    assert a["meta"]["step"] == b["meta"]["step"] == 2
    assert a["meta"]["sampler_state"] == b["meta"]["sampler_state"]
    for net in ("generator", "discriminator"):
        for k, v in a["params"][net].items():
            torch.testing.assert_close(b["params"][net][k], v, rtol=0,
                                       atol=0)
        assert a["opt_state"][net]["count"] == 2
        for m in ("mu", "nu"):
            for k, v in a["opt_state"][net][m].items():
                torch.testing.assert_close(b["opt_state"][net][m][k], v,
                                           rtol=0, atol=0)
    if family == "hifigan":
        np.testing.assert_array_equal(
            jh5.read_hdf5(os.path.join(straight, "stats.h5"), "scale"),
            np.ones(8, np.float32))


def test_trained_hifigan_loads_into_the_vocoder(trained):
    """``load_vocoder`` reads the trained directory (where it refused
    one); ``Vocoder.from_files`` over the directory's own config and
    identity stats synthesizes what the trained generator computes on
    the raw log-mel.  An Orbax directory is refused by name."""
    d = trained["hifigan"][0]
    ckpt = os.path.join(d, "checkpoint-2steps")
    cfg = yaml.safe_load(open(os.path.join(d, "config.yml")))
    sd = load_vocoder(ckpt, cfg)
    assert sd.keys() == pckpt.restore_checkpoint(ckpt)["params"][
        "generator"].keys()
    voc = Vocoder.from_files(ckpt, os.path.join(d, "config.yml"),
                             os.path.join(d, "stats.h5"), device="cpu",
                             trg_stats={"mean": np.zeros(8, np.float32),
                                        "scale": np.ones(8, np.float32)})
    mel = np.random.default_rng(0).normal(size=(10, 8)).astype(np.float32)
    y, sr = voc.decode(mel)
    gen = ptrain.build_generator(cfg, "hifigan")[0]
    gen.load_state_dict(sd)
    with torch.no_grad():
        want = gen(_t(mel[None]))[0, :, 0].numpy()
    assert sr == SR and y.shape == (10 * 48,)
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-6)
    orbax = os.path.join(d, "orbax")
    os.makedirs(orbax)
    open(os.path.join(orbax, "_CHECKPOINT_METADATA"), "w").close()
    with pytest.raises(ValueError, match="Orbax"):
        load_vocoder(orbax, cfg)


def test_trained_sifigan_loads_into_stage_9(trained, tmp_path):
    """Stage 9 (``--anasyn``) with the trained SiFiGAN directory as
    ``--checkpoint-path`` (where it refused one): the wav equals
    ``postprocess_core`` with the generator loaded from the checkpoint's
    params; an Orbax directory is refused by name."""
    ckpt = os.path.join(trained["sifigan"][0], "checkpoint-2steps")
    config = dict(sample_rate=SR, mcep_dim=10, generator=dict(
        in_channels=14, channels=32))
    cfg = tmp_path / "post.yml"
    cfg.write_text(yaml.safe_dump(config))
    d = tmp_path / "in"
    d.mkdir()
    wav = _singing_wav(0.5, 262.0)
    write_wav(str(d / "utt_a_Alto.wav"), wav, SR)
    post.main(["--in-dir", str(d), "--config", str(cfg), "--checkpoint-path",
               ckpt, "--anasyn", "--device", "cpu", "--verbose", "0"])
    from serenade_tpu_torch.utils.audio import read_wav

    got = read_wav(str(d / "utt_a_Alto_anasyn.wav"))[0]
    model = post.build_generator(dict(post.DEFAULT_CONFIG, **config))
    model.load_state_dict(pckpt.restore_generator_params(ckpt))
    path = str(d / "utt_a_Alto.wav")
    utt = {"key": "u", "wav": read_wav(path)[0], "lf0": None,
           "f0_range": post.voice_range_for(path)}
    (_, _, want), = list(post.postprocess_core(
        model.eval(), [utt], dict(post.DEFAULT_CONFIG, **config),
        anasyn=True, device="cpu"))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2.0 / 32767
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("")
    with pytest.raises(ValueError, match="Orbax"):
        post.load_generator(config, str(orbax), device="cpu")
