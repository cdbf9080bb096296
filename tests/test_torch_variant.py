"""The F0-fluctuation variant (``SerenadeNew``) through the port, against
the JAX package on the CPU.

The model's training losses and gradients and its inference (f32 and
bf16) from the same parameters and JAX's own draws (the shifts from the
first two keys of ``split(rng, 3)``, the segment, flow times and noise
from the third); ``compute_f0_fluctuation`` and extraction with
``with_f0_fluc``; ``FeatsDatasetNew``, ``SSCCollaterNew`` and the
device-resident corpus; the Converter's conversions and streams; a
reference-layout SerenadeNew ``.pkl``; the preprocess CLIs key by key; the
decode CLIs on one dump; the train CLI's chain; the server's ``f0_fluc``
contract.  Small widths, f32 unless stated, on the CPU.  The JAX
parameters are random leaves of the shapes ``init`` gives
(``jax.eval_shape``), which saves compiling ``init``.
"""

import json
import os
import sys

import joblib
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from serenade_tpu import features as jfeat
from serenade_tpu.collaters.ssc import SSCCollaterNew as JaxCollaterNew
from serenade_tpu.bin.ssc_train import _batch_adapter as jax_batch_adapter
from serenade_tpu.datasets.feats_dataset import (
    FeatsDatasetNew as JaxDatasetNew,
)
from serenade_tpu.datasets.loader import ShardedBatchLoader as JaxLoader
from serenade_tpu.models.convert_serenade import (
    convert_serenade as jax_convert_serenade,
)
from serenade_tpu.models.serenade_new import SerenadeNew as JaxSerenadeNew
from serenade_tpu.models.serenade_new import tile_to_length as jax_tile
from serenade_tpu.ops import longform as jlf
from serenade_tpu.trainers import SSCTrainerNew as JaxTrainerNew
from serenade_tpu.trainers import build_optimizer as jax_build_optimizer
from serenade_tpu.trainers import build_train_step as jax_build_train_step
from serenade_tpu.trainers import create_train_state as jax_create_state
from serenade_tpu.utils import h5 as jh5
from serenade_tpu.utils import scalers as jscalers

from serenade_tpu_torch import checkpoint as pckpt
from serenade_tpu_torch import configs, features, serving
from serenade_tpu_torch.api import Converter
from serenade_tpu_torch.bin import compute_statistics as pstats
from serenade_tpu_torch.bin import preprocess as ppre
from serenade_tpu_torch.bin import preprocess_new as ppre_new
from serenade_tpu_torch.bin import ssc_decode as pdecode
from serenade_tpu_torch.bin import ssc_decode_new as pdecode_new
from serenade_tpu_torch.bin import ssc_train_new as ptrain_new
from serenade_tpu_torch.bin.serve import reference_features
from serenade_tpu_torch.collaters.ssc import SSCCollaterNew
from serenade_tpu_torch.config import resolve
from serenade_tpu_torch.convert import load_params, state_dict_from_flax
from serenade_tpu_torch.datasets.device_cache import DeviceResidentData
from serenade_tpu_torch.datasets.feats_dataset import FeatsDatasetNew
from serenade_tpu_torch.datasets.loader import ShardedBatchLoader
from serenade_tpu_torch.models.convert_serenade import (
    convert_serenade, to_reference_state_dict,
)
from serenade_tpu_torch.models.layers import init_params_
from serenade_tpu_torch.models.serenade_new import (
    SerenadeNew, roll_time, tile_to_length,
)
from serenade_tpu_torch.trainers import (
    build_optimizer, build_train_step, create_train_state,
)
from serenade_tpu_torch.trainers.ssc import SSCTrainerNew
from serenade_tpu_torch.utils.scalers import load_scalers
from test_torch_features import (
    FC, SR, assert_f0_agrees, assert_features_agree, sung,
)
from test_torch_models import assert_bf16_parity
from test_torch_train import CFG as TRAIN_CFG
from test_torch_train import _draws, _rel_close
from test_torch_train_loop import _same_scalars, _Writer

# test_torch_train's widths (the encoder as wide as the mel, 80, so the
# first UNet convolution takes 80 + 1 + 1 + 2 + 80 + 80 = 244 channels, as
# at full width) with the reference's six GST convolutions, which JAX's
# converter of reference checkpoints expects
CFG = dict(TRAIN_CFG, gst_conv_chans=(8, 8, 16, 16, 32, 32))
B, T, LENGTHS = 2, 64, (64, 45)
TEMP, STEPS = 0.667, 2
# the inference batch: reference buckets 128 with unequal lengths, source
# bucket 192 (not a multiple of 128), so the tile cuts a copy
TS, TR, SRC_LENS, REF_LENS = 192, 128, (192, 150), (100, 70)
# stream chunks at the source bucket, so every JAX inference of this file
# but bf16's is one compiled program, (2, TS) over (2, TR)
CHUNK, OVERLAP = TS, 32
SCALER = {"hubert": {"mean": np.linspace(-0.5, 0.5, 32),
                     "scale": np.linspace(1.0, 2.0, 32)},
          "score": {"min": 30.0, "max": 90.0},
          "loud": {"min": -80.0, "max": 0.0},
          "logmel": {"mean": np.linspace(-4.0, -2.0, 80),
                     "scale": np.linspace(0.5, 2.0, 80)}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU ops beside JAX's thread pools: torch's intra-op threads
    only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _seeded_tree(shapes, seed):
    """Random leaves of ``init``'s shapes: matrices N(0, 1/fan_in), scales
    1 + N(0, 0.05^2), other vectors N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name in ("scale", "g") else 0.0
        return (base + 0.05 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _fluc(rng, b, t):
    return (0.05 * rng.normal(size=(b, t, 1))).astype(np.float32)


def _batch(rng):
    return {"x": rng.normal(size=(B, T, 32)).astype(np.float32),
            "lengths": np.asarray(LENGTHS, np.int32),
            "logmel": rng.normal(size=(B, T, 80)).astype(np.float32),
            "midi": rng.uniform(size=(B, T, 1)).astype(np.float32),
            "loud": rng.uniform(size=(B, T, 1)).astype(np.float32),
            "f0_fluc": _fluc(rng, B, T)}


ARGS = ("x", "lengths", "logmel", "midi", "loud", "f0_fluc")


@pytest.fixture(scope="module")
def jax_model():
    """The JAX SerenadeNew at ``CFG`` (dropout 0) and random parameters of
    its shapes."""
    jmodel = JaxSerenadeNew(**CFG, dtype=jnp.float32)
    batch = _batch(np.random.default_rng(0))
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda *a: jmodel.init(key, *a, rng=key),
                            *(jnp.asarray(batch[k]) for k in ARGS))
    return jmodel, _seeded_tree(shapes, 1)


def _shifts(key, high):
    """JAX's two shifts for ``rng=key``: ``randint`` in ``[0, max(high,
    1))`` from the first two keys of ``split(key, 3)``."""
    k1, k2, _ = jax.random.split(key, 3)
    return [int(jax.random.randint(k, (), 0, max(high, 1)))
            for k in (k1, k2)]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_roll_and_tile_match_jax():
    """The gathers against ``jnp.roll`` and JAX's ``tile_to_length``,
    shifts past the length included, and with a shift held in a tensor."""
    x = np.random.default_rng(2).normal(size=(2, 7, 3)).astype(np.float32)
    for s in (0, 3, 6, 7, 11):
        want = np.roll(x, s, axis=1)
        np.testing.assert_array_equal(roll_time(_t(x), s).numpy(), want)
        np.testing.assert_array_equal(
            roll_time(_t(x), torch.tensor(s)).numpy(), want)
    for n in (3, 7, 16):
        np.testing.assert_array_equal(tile_to_length(_t(x), n).numpy(),
                                      np.asarray(jax_tile(jnp.asarray(x), n)))


def test_forward_losses_and_every_gradient_match_jax(jax_model):
    """One loss and one backward from JAX's draws: the losses within 1e-5,
    the encoder output and every gradient within 1e-4 of each tensor's
    largest value (f32)."""
    jmodel, params = jax_model
    batch = _batch(np.random.default_rng(3))
    key = jax.random.key(4)

    def loss_fn(p):
        out = jmodel.apply(p, *(jnp.asarray(batch[k]) for k in ARGS),
                           rng=key, deterministic=False,
                           rngs={"dropout": jax.random.fold_in(key, 1)})
        return out["loss"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    draws = _draws(jax.random.split(key, 3)[2], B)
    draws["s1"], draws["s2"] = (torch.tensor(s) for s in _shifts(key, T - 2))
    model = load_params(SerenadeNew(**CFG, dtype="float32"), params)
    out = model(*(torch.as_tensor(batch[k]) for k in ARGS), draws=draws)
    out["loss"].backward()
    for name in ("cfm_loss", "prior_loss", "loss"):
        np.testing.assert_allclose(out[name].item(), float(jout[name]),
                                   rtol=1e-5, err_msg=name)
    _rel_close(out["gauss_mel"].detach(), jout["gauss_mel"], 1e-4)
    want = state_dict_from_flax(model, _np(jgrads))
    for name, p in model.named_parameters():
        _rel_close(p.grad, want[name], 1e-4, name)


def _inference_inputs(rng):
    def part(t, lens, c):
        a = rng.normal(size=(2, t, c)).astype(np.float32)
        for i, n in enumerate(lens):
            a[i, n:] = 0.0
        return a

    src = [part(TS, SRC_LENS, 32), np.asarray(SRC_LENS, np.int32),
           part(TS, SRC_LENS, 1), part(TS, SRC_LENS, 1),
           part(TS, SRC_LENS, 1) * 0.05]
    ref = [part(TR, REF_LENS, 32), np.asarray(REF_LENS, np.int32),
           part(TR, REF_LENS, 80), part(TR, REF_LENS, 1),
           part(TR, REF_LENS, 1), part(TR, REF_LENS, 1) * 0.05]
    return src + ref


_JAX_INFER = {}


def _jax_infer(dtype):
    """One jitted ``SerenadeNew.apply(method="inference")`` a dtype, at
    ``STEPS`` Euler steps."""
    if dtype not in _JAX_INFER:
        _JAX_INFER[dtype] = jax.jit(
            lambda p, key, temp, *a: JaxSerenadeNew(**CFG, dtype=dtype).apply(
                p, *a, rng=key, n_timesteps=STEPS, temperature=temp,
                method="inference"))
    return _JAX_INFER[dtype]


def _x0(key, b, t):
    """JAX's noise for ``rng=key``: the CFM's normal draw from the third
    key, scaled by the temperature."""
    k_rest = jax.random.split(key, 3)[2]
    return np.asarray(jax.random.normal(k_rest, (b, t, 80), jnp.float32)
                      * TEMP)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inference_matches_jax(jax_model, dtype):
    """Both shifts, reference lengths 100 and 70 in one batch, a source
    bucket of 192 over a reference bucket of 128: the mels' valid frames
    within 2e-4 in f32, by ``assert_bf16_parity`` in bf16."""
    _, params = jax_model
    args = _inference_inputs(np.random.default_rng(5))
    key = jax.random.key(6)
    shifts = _shifts(key, TS)
    assert all(0 < s < TS for s in shifts) and shifts[0] != shifts[1]

    def jax_mel(jdtype):
        return np.asarray(_jax_infer(jdtype)(params, key, TEMP, *args),
                          np.float32)

    model = load_params(SerenadeNew(**CFG, dtype=dtype), params)
    got = model.inference(*(torch.as_tensor(a) for a in args),
                          n_timesteps=STEPS, temperature=TEMP,
                          x0=_t(_x0(key, 2, TR + TS)),
                          shifts=torch.tensor(shifts)).float().numpy()
    valid = np.arange(TS)[None, :] < np.asarray(SRC_LENS)[:, None]
    if dtype == "float32":
        np.testing.assert_allclose(got[valid], jax_mel(jnp.float32)[valid],
                                   rtol=2e-4, atol=2e-4)
    else:
        assert_bf16_parity(got[valid], jax_mel(jnp.bfloat16)[valid],
                           jax_mel(jnp.float32)[valid])


def test_shifts_are_drawn_when_not_given(jax_model):
    """Without ``draws`` or ``shifts`` the generator draws them: a seed
    repeats its losses and mels, and the shifts move them."""
    _, params = jax_model
    model = load_params(SerenadeNew(**CFG, dtype="float32"), params)
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(np.random.default_rng(7)).items()}

    def loss(seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model(*(batch[k] for k in ARGS), generator=gen)["loss"]

    assert torch.equal(loss(1), loss(1)) and not torch.equal(loss(1),
                                                             loss(2))
    args = [torch.as_tensor(a) for a in _inference_inputs(
        np.random.default_rng(8))]
    kw = dict(x0=torch.zeros(2, TR + TS, 80), n_timesteps=1)
    a = model.inference(*args, shifts=(3, 5), **kw)
    b = model.inference(*args, shifts=(4, 5), **kw)
    assert not torch.equal(a, b)
    gen = torch.Generator().manual_seed(3)
    drawn = model.inference(*args, generator=gen, **kw)
    want = torch.randint(0, TS, (2,), generator=torch.Generator()
                         .manual_seed(3))
    assert torch.equal(drawn, model.inference(*args, shifts=want, **kw))


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------


def test_compute_f0_fluctuation_matches_jax():
    """Equal to JAX's on sung tracks with unvoiced runs; a track too short
    for the spline raises on both sides."""
    rng = np.random.default_rng(9)
    for frames, maxf0 in ((40, 800.0), (300, 1100.0)):
        f0 = (220 * 2 ** (rng.normal(size=frames).cumsum() / 60)).astype(
            np.float32)
        f0[: frames // 5] = 0.0
        got = features.compute_f0_fluctuation(f0, maxf0, 10.0)
        want = jfeat.compute_f0_fluctuation(f0, maxf0, 10.0)
        assert got.dtype == np.float32 and got.shape == (frames,)
        np.testing.assert_array_equal(got, want)
    for fn in (features.compute_f0_fluctuation,
               jfeat.compute_f0_fluctuation):
        with pytest.raises(Exception) as err:
            fn(np.full(3, 200.0, np.float32), 800.0)
        assert type(err.value).__name__ in ("ValueError", "error")


def assert_fluc_agrees(got, want, maxf0=1100.0):
    """The port's ``f0_fluc`` equals JAX's ``compute_f0_fluctuation`` of
    the port's own F0 track (as the port cuts it), and JAX's within 2e-3
    (its F0 agrees within 1e-3 relative, ``assert_f0_agrees``; over
    ``maxf0`` and less a smooth spline the residuals move less)."""
    assert got["f0_fluc"].shape == np.asarray(want["f0_fluc"]).shape
    assert got["f0_fluc"].dtype == np.float32
    assert np.abs(got["f0_fluc"] - np.asarray(want["f0_fluc"])).max() <= 2e-3


def test_extract_features_with_f0_fluc_matches_jax():
    """``extract_features`` with ``with_f0_fluc``: every key as
    ``test_torch_features`` holds it, and ``f0_fluc`` exactly JAX's
    function of the port's F0 track and within 2e-3 of JAX's own."""
    cfg, jcfg = (features.FeatureConfig.from_dict(FC),
                 jfeat.FeatureConfig.from_dict(FC))
    wav = sung(1.1, 12)
    got = features.extract_features("utt", wav, SR, cfg, with_f0_fluc=True,
                                    f0_range=(70.0, 800.0), device="cpu")
    want = jfeat.extract_features("utt", wav, SR, jcfg, with_f0_fluc=True,
                                  f0_range=(70.0, 800.0))
    assert_features_agree(got, want, hubert=False)
    np.testing.assert_array_equal(got["f0_fluc"][:, 0],
                                  jfeat.compute_f0_fluctuation(
                                      got["f0"][:, 0], 800.0))
    assert_fluc_agrees(got, want)


def test_extract_features_batch_skips_a_clip_the_spline_refuses(monkeypatch):
    """The batch path: each utterance's ``f0_fluc`` as alone, and a clip
    whose spline fails is None alone, with the others extracted, on both
    sides.  The spline is wrapped to refuse tracks under 100 frames, so
    the 0.8 s clip stands for one too short for it."""
    import scipy.interpolate

    spline = scipy.interpolate.UnivariateSpline

    def picky(x, y, **kw):
        if len(x) < 100:
            raise ValueError("too few frames for the spline")
        return spline(x, y, **kw)

    monkeypatch.setattr(scipy.interpolate, "UnivariateSpline", picky)
    items = [("a", sung(1.1, 14), SR, None), ("short", sung(0.8, 15), SR,
                                                None),
             ("b", sung(1.3, 16, 330.0), SR, None)]
    got = features.extract_features_batch(
        items, features.FeatureConfig.from_dict(FC), with_f0_fluc=True,
        device="cpu")
    want = jfeat.extract_features_batch(
        items, jfeat.FeatureConfig.from_dict(FC), with_f0_fluc=True)
    assert got["short"] is None and want["short"] is None
    for k in ("a", "b"):
        assert_features_agree(got[k], want[k], hubert=False)
        assert_fluc_agrees(got[k], want[k])


def test_extract_stream_window_fluc_is_the_windows_spline():
    """The window's ``f0_fluc`` is the spline over the window's F0 (with
    its context), sliced to the span, not a slice of the utterance's."""
    cfg = features.FeatureConfig.from_dict(FC)
    audio = features._prepare_audio("s", sung(2.0, 17), SR, cfg)
    n = features.stream_total_frames(len(audio), cfg)
    span, ctx = (64, 160), 32
    calls = []

    class Content:
        def batch24(self, wavs, wire_dtype):
            calls.append(len(wavs[0]))
            return [torch.zeros(len(wavs[0]) // 240, 64)]

    got = features.extract_stream_window(
        audio, span, cfg, 70.0, 1100.0, content_fn=Content(), ctx_frames=ctx,
        with_f0_fluc=True, device="cpu")
    win = features.extract_stream_window(
        audio, (0, n), cfg, 70.0, 1100.0, content_fn=Content(),
        ctx_frames=ctx, device="cpu")
    assert got["f0_fluc"].shape == (96, 1) and got["f0_fluc"].dtype == \
        np.float32
    # the window's own F0 track, from the same extraction
    sig = features.extract_signal_features_group(
        [features._bucketed(audio[(64 - ctx) * 240:(160 + ctx) * 240],
                            240)[0]], cfg, 70.0, 1100.0, "viterbi",
        wire_dtype="int16", device="cpu")[0]
    n_w = features._bucketed(audio[(64 - ctx) * 240:(160 + ctx) * 240],
                             240)[1]
    want = features.compute_f0_fluctuation(sig["f0"][:n_w], 1100.0)
    np.testing.assert_array_equal(got["f0_fluc"][:, 0],
                                  want[ctx:ctx + 96])
    whole = features.compute_f0_fluctuation(win["f0"][:, 0], 1100.0)
    assert not np.allclose(got["f0_fluc"][:, 0], whole[64:160])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

UTTS = (("EN_s1_song0_Breathy_Group_0", 100),
        ("EN_s1_song1_Breathy_Group_0", 90),
        ("EN_s1_song2_Falsetto_Group_0", 100),
        ("EN_s1_song3_Falsetto_Group_0", 70))
MODEL_PARAMS = dict(CFG, dtype="float32")


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """Four utterances with every dumped key, ``f0_fluc`` among them, and
    their statistics."""
    root = tmp_path_factory.mktemp("variant")
    rng = np.random.default_rng(10)
    for utt, t in UTTS:
        h5 = str(root / "dump" / f"{utt}.h5")
        f0 = (220 * 2 ** (rng.normal(size=t).cumsum() / 60)).astype(
            np.float32)
        f0[: t // 8] = 0.0
        for key, value in (
                ("wave", (rng.normal(size=t * 240) * 0.1)),
                ("hubert", rng.normal(size=(t, 32)) * 2 + 1),
                ("logmel", rng.normal(size=(t, 80)) - 3),
                ("loud", rng.uniform(-60, 0, (t, 1))),
                ("est_lf0_score", rng.uniform(40, 80, (t, 1))),
                ("midi", rng.uniform(40, 80, t)), ("f0", f0[:, None]),
                ("f0_fluc", jfeat.compute_f0_fluctuation(f0, 800.0)[:, None])):
            jh5.write_hdf5(h5, key, np.asarray(value, np.float32))
    scaler = {"hubert": jscalers.StandardScaler(),
              "logmel": jscalers.StandardScaler(),
              "score": jscalers.MinMaxScaler(),
              "loud": jscalers.MinMaxScaler()}
    for utt, _ in UTTS:
        for feat, key in (("hubert", "hubert"), ("logmel", "logmel"),
                          ("score", "est_lf0_score"), ("loud", "loud")):
            scaler[feat].partial_fit(jh5.read_hdf5(
                str(root / "dump" / f"{utt}.h5"), key))
    stats = str(root / "stats.joblib")
    joblib.dump(scaler, stats)
    return dict(root=root, dir=str(root / "dump"), stats=stats,
                scaler=scaler)


def test_dataset_collater_and_device_cache_match_jax(dump):
    """``FeatsDatasetNew`` items equal JAX's (``f0_fluc`` unscaled, 2-D),
    scaled and not; ``SSCCollaterNew`` pads ``f0_flucs`` as JAX's does;
    the card-resident corpus gathers ``f0_fluc`` with the rest."""
    for scaled in (False, True):
        got = FeatsDatasetNew(dump["dir"], return_utt_id=True,
                              scaler=load_scalers(dump["stats"])
                              if scaled else None)
        want = JaxDatasetNew(dump["dir"], return_utt_id=True,
                             scaler=dump["scaler"] if scaled else None)
        for i in range(len(want)):
            (gu, gi), (wu, wi) = got[i], want[i]
            assert gu == wu and set(gi) == set(wi)
            for k in wi:
                np.testing.assert_array_equal(gi[k], wi[k], err_msg=k)
            assert gi["f0_fluc"].shape == (UTTS[i][1], 1)
    items = [FeatsDatasetNew(dump["dir"])[i] for i in range(len(UTTS))]
    got = SSCCollaterNew()(items)
    want = JaxCollaterNew()(items)
    assert set(got) == set(want) and "f0_flucs" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    dr = DeviceResidentData(FeatsDatasetNew(dump["dir"]), pad_frames_to=96,
                            batch_size=2, device="cpu")
    batch = dr.gather([3, 0])
    assert set(batch) == {"x", "logmel", "midi", "loud", "f0_fluc",
                          "lengths"}
    assert batch["lengths"].tolist() == [70, 96]
    np.testing.assert_array_equal(batch["f0_fluc"][0, :70].numpy(),
                                  items[3]["f0_fluc"])
    np.testing.assert_array_equal(batch["f0_fluc"][1].numpy(),
                                  items[0]["f0_fluc"][:96])
    assert not batch["f0_fluc"][0, 70:].any()


def test_registry_builds_the_variant():
    """The four types resolve, and the variant's model at full width
    takes 244 channels into its first UNet convolution."""
    assert resolve("model", "SerenadeNew") is SerenadeNew
    assert resolve("trainer", "SSCTrainerNew") is SSCTrainerNew
    assert resolve("collater", "SSCCollaterNew") is SSCCollaterNew
    assert resolve("dataset", "FeatsDatasetNew") is FeatsDatasetNew
    with torch.device("meta"):
        model = SerenadeNew(**configs.serenade_config())
    wide = {n: tuple(p.shape) for n, p in model.named_parameters()
            if p.dim() == 3 and p.shape[1] == 244}
    assert wide == {
        "cfm_decoder.estimator.down0_resnet.block1.conv.weight":
            (512, 244, 3),
        "cfm_decoder.estimator.down0_resnet.res_conv.weight": (512, 244, 1)}


# ---------------------------------------------------------------------------
# the Converter
# ---------------------------------------------------------------------------


def _feats(rng, t, with_mel):
    f = {"hubert": rng.normal(size=(t, 32)) * 2 + 1,
         "score": rng.uniform(40, 80, size=(t, 1)),
         "loud": rng.uniform(-60, 0, size=(t, 1)),
         "f0_fluc": 0.05 * rng.normal(size=(t, 1))}
    if with_mel:
        f["logmel"] = rng.normal(size=(t, 80)) - 3
    return f


def _jax_inputs(srcs, refs, ts, tr):
    """serenade_tpu/api.py's normalization and padding of a batch."""
    sc = SCALER

    def norm(f, with_mel):
        out = {"x": (f["hubert"] - sc["hubert"]["mean"])
               / sc["hubert"]["scale"],
               "midi": (f["score"] - 30.0) / 60.0,
               "loud": (f["loud"] + 80.0) / 80.0, "f0_fluc": f["f0_fluc"]}
        if with_mel:
            out["logmel"] = ((f["logmel"] - sc["logmel"]["mean"])
                             / sc["logmel"]["scale"])
        return out

    def stack(fs, keys, t):
        return [np.stack([np.pad(np.asarray(f[k], np.float32),
                                 ((0, t - f[k].shape[0]), (0, 0)))
                          for f in fs]) for k in keys]

    s = [norm(f, False) for f in srcs]
    r = [norm(f, True) for f in refs]
    x, midi, loud, fl = stack(s, ("x", "midi", "loud", "f0_fluc"), ts)
    rx, rmel, rmidi, rloud, rfl = stack(
        r, ("x", "logmel", "midi", "loud", "f0_fluc"), tr)
    lens = np.asarray([f["hubert"].shape[0] for f in srcs], np.int32)
    rlens = np.asarray([f["hubert"].shape[0] for f in refs], np.int32)
    return (x, lens, midi, loud, fl, rx, rlens, rmel, rmidi, rloud, rfl)


def _converter(params, temperature=TEMP):
    return Converter(MODEL_PARAMS, params, SCALER, n_timesteps=STEPS,
                     temperature=temperature, device="cpu",
                     model_type="SerenadeNew")


def test_convert_features_batch_matches_jax(jax_model):
    """Two requests with their own references (lengths 150 and 192 at
    bucket 192, references 100 and 70 at 128): each row within 2e-4 of
    JAX's batched inference from the same noise and shifts; a request
    alone from its noise row and the batch's shifts, as its row."""
    _, params = jax_model
    rng = np.random.default_rng(11)
    srcs = [_feats(rng, 150, False), _feats(rng, 192, False)]
    refs = [_feats(rng, 100, True), _feats(rng, 70, True)]
    key = jax.random.key(12)
    shifts = _shifts(key, TS)
    x0 = _x0(key, 2, TR + TS)
    want = np.asarray(_jax_infer(jnp.float32)(
        params, key, TEMP, *_jax_inputs(srcs, refs, TS, TR)))
    conv = _converter(params)
    assert conv.variant_new
    got = conv.convert_features_batch(srcs, refs, x0=x0, shifts=shifts)
    for i, f in enumerate(srcs):
        n = f["hubert"].shape[0]
        np.testing.assert_allclose(got[i], want[i, :n], rtol=2e-4,
                                   atol=2e-4)
    alone = conv.convert_features_batch([srcs[0]], [refs[0]], ts=TS, tr=TR,
                                        x0=x0[:1], shifts=shifts)[0]
    np.testing.assert_allclose(alone, got[0], rtol=1e-5, atol=1e-5)


def test_convert_features_and_stream_match_jax(jax_model):
    """One request through ``convert_features`` (source at bucket 192,
    reference at 128) against JAX's inference, and a 320-frame source
    through ``convert_features_stream`` and ``convert_features_long`` at
    temperature 0 (chunks of 192 with 32 overlapping, the last one
    padded, one reference tiled into each) against JAX's longform helpers
    on JAX's model, each chunk rolled by JAX's shifts for its key.  JAX
    converts each as row 0 of a batch of two equal rows (its noise row 0
    is the port's ``x0``)."""
    _, params = jax_model
    rng = np.random.default_rng(13)
    src, ref = _feats(rng, 320, False), _feats(rng, 100, True)
    key = jax.random.key(14)
    first = {k: v[:CHUNK] for k, v in src.items()}
    infer = _jax_infer(jnp.float32)
    want = np.asarray(infer(params, key, TEMP, *_jax_inputs(
        [first] * 2, [ref] * 2, CHUNK, TR)))[0]
    conv = _converter(params)
    mel, wav, sr = conv.convert_features(
        first, ref, x0=_x0(key, 2, TR + CHUNK)[:1],
        shifts=_shifts(key, CHUNK))
    assert wav is None and sr is None
    np.testing.assert_allclose(mel, want, rtol=2e-4, atol=2e-4)

    def jax_chunk(chunk):
        t = chunk["hubert"].shape[0]
        return np.asarray(infer(params, key, 0.0, *_jax_inputs(
            [chunk] * 2, [ref] * 2, CHUNK, TR)))[0, :t]

    conv = _converter(params, temperature=0.0)
    conv.draw_shifts = lambda ts: torch.tensor(_shifts(key, ts))
    kw = dict(chunk_frames=CHUNK, overlap_frames=OVERLAP)
    segs = list(conv.convert_features_stream(src, ref, **kw))
    want = list(jlf.convert_in_chunks_stream(src, jax_chunk, **kw))
    assert [s for s, _, _ in segs] == [s for s, _ in want]
    for (_, m, w), (_, m_j) in zip(segs, want):
        assert w is None
        np.testing.assert_allclose(m, m_j, rtol=2e-4, atol=2e-4)
    long, _, _ = conv.convert_features_long(src, ref, **kw)
    np.testing.assert_allclose(long, jlf.convert_in_chunks(
        src, jax_chunk, **kw), rtol=2e-4, atol=2e-4)


def test_convert_serenade_variant_pkl_matches_jax():
    """A reference-layout SerenadeNew state dict (its first UNet conv
    wider by the two fluctuation channels) through the port's converter
    equals JAX's converter through the param bridge, and maps back to the
    reference's names exactly."""
    params = dict(MODEL_PARAMS)
    model = init_params_(SerenadeNew(**params, gst_norm_type="frozen_batch"),
                         seed=3)
    sd = to_reference_state_dict(model.state_dict(), params, SerenadeNew)
    got = convert_serenade(sd, params, SerenadeNew)
    want = state_dict_from_flax(model, _np(jax_convert_serenade(sd)))
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        torch.testing.assert_close(got[k], model.state_dict()[k], rtol=0,
                                   atol=0)
    first = [v for k, v in sd.items() if k.endswith("down_blocks.0.0."
                                                    "block1.block.0.weight")]
    # encoder 80 + midi + loudness + 2 fluctuation + mel 80, and x 80
    assert first and first[0].shape[1] == 244


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _run_jax_cli(main, argv):
    old, sys.argv = sys.argv, ["prog"] + argv
    try:
        main()
    finally:
        sys.argv = old


def test_preprocess_clis_match_jax(tmp_path):
    """``preprocess`` and ``preprocess_new`` against JAX's on a tiny
    wav.scp (no ContentVec): the same dumps, key by key as
    ``test_torch_features`` holds them, ``f0_fluc`` by
    ``assert_fluc_agrees``; ``--f0-backend jax`` is the port's YIN."""
    from serenade_tpu.bin.preprocess import main as jax_pre
    from serenade_tpu.bin.preprocess_new import main as jax_pre_new

    wavs = tmp_path / "wav"
    wavs.mkdir()
    scp = tmp_path / "wav.scp"
    lines = []
    for i, (seconds, f0) in enumerate(((1.0, 220.0), (1.2, 330.0))):
        path = wavs / f"u{i}.wav"
        wavfile.write(str(path), SR, (sung(seconds, 20 + i, f0) * 32767)
                      .astype(np.int16))
        lines.append(f"u{i} {path}\n")
    scp.write_text("".join(lines))
    cfg = tmp_path / "conf.yml"
    cfg.write_text(yaml.safe_dump(FC))
    for name, jmain, pmain, fluc in (("pre", jax_pre, ppre.main, False),
                                     ("new", jax_pre_new, ppre_new.main,
                                      True)):
        out = {}
        for side, fn in (("jax", jmain), ("port", pmain)):
            argv = ["--wav-scp", str(scp), "--dumpdir",
                    str(tmp_path / name / side), "--config", str(cfg),
                    "--allow-missing-hubert", "true", "--verbose", "0"]
            if side == "jax":
                _run_jax_cli(fn, argv)
            else:
                fn(argv + ["--device", "cpu"])
            out[side] = tmp_path / name / side
        assert sorted(os.listdir(out["jax"])) == sorted(
            os.listdir(out["port"])) == ["u0.h5", "u1.h5"]
        for f in ("u0.h5", "u1.h5"):
            keys = ("wave", "logmel", "loud", "f0", "vuv", "midi",
                    "est_lf0_score", "gt_lf0_score", "f0_fluc", "hubert")
            got = {k: v for k, v in jh5.read_hdf5_many(
                str(out["port"] / f), keys).items() if v is not None}
            want = {k: v for k, v in jh5.read_hdf5_many(
                str(out["jax"] / f), keys).items() if v is not None}
            assert ("f0_fluc" in want) == fluc and "hubert" not in want
            assert_features_agree(got, want, hubert=False)
            if fluc:
                assert_fluc_agrees(got, want)
    ppre.main(["--wav-scp", str(scp), "--dumpdir", str(tmp_path / "yin"),
               "--config", str(cfg), "--allow-missing-hubert", "true",
               "--f0-backend", "jax", "--device", "cpu", "--verbose", "0"])
    _run_jax_cli(jax_pre, ["--wav-scp", str(scp), "--dumpdir",
                           str(tmp_path / "jyin"), "--config", str(cfg),
                           "--allow-missing-hubert", "true",
                           "--f0-backend", "jax", "--verbose", "0"])
    for f in ("u0.h5", "u1.h5"):
        got = jh5.read_hdf5(str(tmp_path / "yin" / f), "f0")
        want = jh5.read_hdf5(str(tmp_path / "jyin" / f), "f0")
        assert_f0_agrees(got, got > 0, want, want > 0)


@pytest.fixture(scope="module")
def variant_pkl(dump):
    """A reference-layout SerenadeNew ``.pkl`` (frozen-BatchNorm GST) from
    a seed, beside a config.yml naming the variant."""
    root = dump["root"]
    model = init_params_(SerenadeNew(**MODEL_PARAMS,
                                     gst_norm_type="frozen_batch"), seed=5)
    pkl = root / "exp" / "checkpoint-100steps.pkl"
    pkl.parent.mkdir()
    torch.save({"model": to_reference_state_dict(model.state_dict(),
                                                 MODEL_PARAMS, SerenadeNew)},
               str(pkl))
    (pkl.parent / "config.yml").write_text(yaml.safe_dump({
        "sampling_rate": 24000, "model_type": "SerenadeNew",
        "model_params": MODEL_PARAMS}))
    return pkl


def test_decode_new_clis_match(dump, variant_pkl, tmp_path, monkeypatch):
    """``ssc_decode_new`` against JAX's on the dump with the variant's
    ``.pkl`` (no vocoder, temperature 0, Euler-2, batch 2, two styles):
    the same files, equal lf0, mels within 2e-4; the port's shifts are
    JAX's (its decode key chain: one split a chunk, the shifts from the
    first two keys of the chunk's split)."""
    from serenade_tpu.bin.ssc_decode_new import main as jax_main

    chain = {"key": jax.random.key(0)}

    def jax_shifts(ts):
        chain["key"], sub = jax.random.split(chain["key"])
        return torch.tensor(_shifts(sub, ts))

    monkeypatch.setattr(Converter, "draw_shifts",
                        lambda self, ts: jax_shifts(ts))
    styles = tmp_path / "styles.json"
    styles.write_text(json.dumps({
        "Breathy": os.path.join(dump["dir"], f"{UTTS[0][0]}.h5"),
        "Mixed_Voice": os.path.join(dump["dir"], f"{UTTS[3][0]}.h5")}))
    outs = {}
    for side in ("jax", "port"):
        out = str(tmp_path / side)
        argv = ["--dumpdir", dump["dir"], "--stats", dump["stats"],
                "--outdir", out, "--checkpoint", str(variant_pkl),
                "--temperature", "0", "--n-timesteps", "2",
                "--batch-size", "2", "--ref-dict", str(styles)]
        if side == "jax":
            _run_jax_cli(jax_main, argv)
        else:
            pdecode_new.main(argv + ["--device", "cpu"])
        outs[side] = out
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"]))
    assert sum(n.endswith(".h5") for n in names) == 6
    for n in names:
        if n.endswith(".h5"):
            j, p = f"{outs['jax']}/{n}", f"{outs['port']}/{n}"
            np.testing.assert_array_equal(jh5.read_hdf5(p, "lf0"),
                                          jh5.read_hdf5(j, "lf0"))
            np.testing.assert_allclose(jh5.read_hdf5(p, "mel"),
                                       jh5.read_hdf5(j, "mel"), rtol=2e-4,
                                       atol=2e-4, err_msg=n)
    # the checkpoint's config decides the variant: one CLI, two names
    assert pdecode_new.main is pdecode.main


def test_train_new_cli_chain(dump, tmp_path):
    """Statistics, 2 steps of ``ssc_train_new`` (the config's ``*New``
    types; an eval sample at 2), then ``ssc_decode_new`` on its latest
    checkpoint: finite mels of the sources' lengths."""
    config = {"sampling_rate": 24000, "model_type": "SerenadeNew",
              "model_params": MODEL_PARAMS, "trainer_type": "SSCTrainerNew",
              "collater_type": "SSCCollaterNew", "batch_size": 2,
              "optimizer_type": "AdamW", "optimizer_params": {"lr": 1e-3},
              "grad_norm": 1.0, "train_max_steps": 2,
              "save_interval_steps": 2, "eval_interval_steps": 2,
              "log_interval_steps": 1, "num_save_intermediate_results": 1,
              "collater_params": {"pad_frames_to": 128}}
    cfg = tmp_path / "c.yml"
    cfg.write_text(yaml.safe_dump(config))
    pstats.main(["--rootdir", dump["dir"], "--dumpdir", str(tmp_path),
                 "--config", str(cfg)])
    exp = tmp_path / "exp"
    ptrain_new.main(["--train-dumpdir", dump["dir"], "--dev-dumpdir",
                     dump["dir"], "--stats", str(tmp_path / "stats.joblib"),
                     "--outdir", str(exp), "--config", str(cfg),
                     "--device", "cpu"])
    ckpt = pckpt.find_latest_checkpoint(str(exp))
    assert ckpt.endswith("checkpoint-2steps")
    assert "sample0_mel.png" in os.listdir(exp / "predictions" / "2steps")
    params = pckpt.restore_params_only(ckpt)
    assert set(params) == set(SerenadeNew(**MODEL_PARAMS).state_dict())
    out = tmp_path / "decoded"
    pdecode_new.main(["--dumpdir", dump["dir"], "--stats",
                      str(tmp_path / "stats.joblib"), "--outdir", str(out),
                      "--checkpoint", ckpt, "--n-timesteps", "2",
                      "--device", "cpu"])
    frames = dict(UTTS)
    decoded = sorted(f for f in os.listdir(out) if f.endswith(".h5"))
    assert decoded
    for name in decoded:
        mel = jh5.read_hdf5(str(out / name), "mel")
        utt = next(u for u in frames if name.startswith(u))
        assert mel.shape == (frames[utt], 80) and np.isfinite(mel).all()


# the dump's 4 utterances at batch 2: 2 steps an epoch, so 3 steps cross
# into the second; every batch padded (or cut) to 96 frames, so JAX
# compiles its step once
T_LOOP = 96
LOOP = {"batch_size": 2, "train_max_steps": 3, "log_interval_steps": 1,
        "save_interval_steps": 1000, "eval_interval_steps": 1000,
        "optimizer_type": "AdamW",
        "optimizer_params": {"lr": 1e-3, "eps": 1e-3}, "grad_norm": 1.0,
        "collater_params": {"pad_frames_to": T_LOOP}}
SEED = 11


class _JaxDrawsNew:
    """The port's step, fed JAX's draws: the trainer's key chain from
    ``key(SEED + 2)``, split once a step, as JAX's SSCTrainer splits it;
    each step's shifts from the first two keys of the step key's
    ``split(key, 3)``, the rest from the third."""

    def __init__(self, step):
        self.step = step
        self.rng = jax.random.key(SEED + 2)

    def __call__(self, state, batch, generator):
        self.rng, key = jax.random.split(self.rng)
        b, t = batch["x"].shape[:2]
        draws = _draws(jax.random.split(key, 3)[2], b, t)
        draws["s1"], draws["s2"] = (torch.tensor(s)
                                    for s in _shifts(key, t - 2))
        return self.step(state, batch, None, draws=draws)


def test_trainer_new_logs_what_jax_logs(jax_model, dump, tmp_path):
    """``SSCTrainerNew`` over ``SSCCollaterNew`` batches of the dump
    (``FeatsDatasetNew``, scaled, the port's loader) against JAX's
    ``SSCTrainerNew`` over its own loader, collater and dataset, with the
    JAX CLI's batch adapter, for 3 steps across an epoch boundary, from
    the same parameters (the param bridge) and JAX's draws: every logged
    loss and gradient norm within 1e-4, parameters within 2e-5 after."""
    jmodel, params = jax_model
    tx, _ = jax_build_optimizer(LOOP)
    jstep = jax_build_train_step(jmodel, tx, donate=False,
                                 batch_to_model_args=jax_batch_adapter(LOOP))
    jloader = JaxLoader(JaxDatasetNew(dump["dir"], scaler=dump["scaler"]),
                        JaxCollaterNew(pad_frames_to=T_LOOP), batch_size=2,
                        seed=SEED, process_index=0, process_count=1)
    jwriter = _Writer()
    jtrainer = JaxTrainerNew(
        LOOP, jstep,
        jax_create_state(jax.tree_util.tree_map(jnp.asarray, params), tx),
        jloader, writer=jwriter, outdir=str(tmp_path / "jax"),
        rng=jax.random.key(SEED + 2))
    # an Orbax save costs seconds here and changes no logged number
    jtrainer.save = lambda steps: None
    jtrainer.run()

    model = load_params(SerenadeNew(**CFG, dtype="float32"), params)
    opt, _ = build_optimizer(LOOP)
    loader = ShardedBatchLoader(
        FeatsDatasetNew(dump["dir"], scaler=load_scalers(dump["stats"])),
        SSCCollaterNew(pad_frames_to=T_LOOP), batch_size=2, seed=SEED)
    writer = _Writer()
    trainer = SSCTrainerNew(
        LOOP, _JaxDrawsNew(build_train_step(model, opt, device="cpu")),
        create_train_state(model, opt), loader, writer=writer,
        outdir=str(tmp_path / "port"))
    trainer.run()
    assert jtrainer.steps == trainer.steps == 3
    assert jtrainer.epochs == trainer.epochs == 2
    assert {s for _, s in writer.scalars} == {1, 2, 3}
    _same_scalars(writer.scalars, jwriter.scalars)
    want = state_dict_from_flax(model, _np(jtrainer.state.params))
    for name, p in trainer.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=2e-5, err_msg=name)


def test_train_step_feeds_f0_fluc(jax_model):
    """``build_train_step`` hands the batch's ``f0_fluc`` to the model:
    its first losses (the prior joins after step 0) equal
    ``SerenadeNew.forward``'s on the same batch and draws, and a batch
    without it is refused."""
    _, params = jax_model
    batch = _batch(np.random.default_rng(15))
    key = jax.random.key(16)
    draws = _draws(jax.random.split(key, 3)[2], B)
    draws["s1"], draws["s2"] = (torch.tensor(s) for s in _shifts(key, T - 2))
    model = load_params(SerenadeNew(**CFG, dtype="float32"), params)
    with torch.no_grad():
        want = model(*(torch.as_tensor(batch[k]) for k in ARGS),
                     draws=draws)
    opt, _ = build_optimizer({"optimizer_type": "AdamW"})
    step = build_train_step(model, opt, device="cpu")
    state = create_train_state(model, opt)
    _, metrics = step(state, batch, None, draws=draws)
    for name, key in (("train/vector_loss", "cfm_loss"),
                      ("train/prior_loss", "prior_loss"),
                      ("train/loss", "cfm_loss")):
        torch.testing.assert_close(metrics[name], want[key], rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="f0_fluc"):
        step(state, {k: v for k, v in batch.items() if k != "f0_fluc"},
             None, draws=draws)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_server_requires_f0_fluc(jax_model, dump, tmp_path):
    """The variant's server: a style registers with its ``f0_fluc`` (an
    npz or an h5 dump through ``bin/serve``'s reader), a request with its
    ``f0_fluc`` converts as the Converter does, and one without is
    refused alone; the warm-up feeds zeros for it."""
    _, params = jax_model
    h5 = os.path.join(dump["dir"], f"{UTTS[2][0]}.h5")
    style = reference_features(h5, "est_lf0_score", with_fluc=True)
    np.testing.assert_array_equal(style["f0_fluc"],
                                  jh5.read_hdf5(h5, "f0_fluc"))
    assert style["f0_fluc"].shape == (UTTS[2][1], 1)
    rng = np.random.default_rng(17)
    ref = _feats(rng, 100, True)
    conv = _converter(params, temperature=0.0)
    batching = serving.BatchingConverter(conv, max_batch=2, max_wait_ms=1)
    try:
        np.savez(tmp_path / "style.npz", **ref)
        style = reference_features(str(tmp_path / "style.npz"),
                                   "est_lf0_score", with_fluc=True)
        assert set(style) == set(ref)
        batching.register_reference("s", style)
        src = _feats(rng, 80, False)
        conv.draw_shifts = lambda ts: torch.tensor([5, 9])
        mel, _, _ = batching.convert(src, "s")
        want, _, _ = conv.convert_features(src, ref, shifts=[5, 9])
        np.testing.assert_allclose(mel, want, rtol=1e-5, atol=1e-5)
        bad = {k: v for k, v in src.items() if k != "f0_fluc"}
        with pytest.raises(ValueError, match="f0_fluc"):
            batching.convert(bad, "s")
        with pytest.raises(ValueError, match="f0_fluc"):
            batching.register_reference(
                "t", {k: v for k, v in ref.items() if k != "f0_fluc"})
        serving.warmup_server(batching, [(64, 64, 1)])
        with pytest.raises(SystemExit, match="f0_fluc"):
            np.savez(tmp_path / "bare.npz",
                     **{k: v for k, v in ref.items() if k != "f0_fluc"})
            reference_features(str(tmp_path / "bare.npz"), "est_lf0_score",
                               with_fluc=True)
    finally:
        batching.close()
    with pytest.raises(ValueError, match="f0_fluc"):
        serving.validate_feature_dict(
            {k: v for k, v in ref.items() if k != "f0_fluc"}, "ref", True,
            32, 80, variant_new=True)
    serving.validate_feature_dict(ref, "ref", True, 32, 80,
                                  variant_new=True)
