"""The port's conversion slice as a whole, and the rules it keeps.

``Converter.convert_features`` of ``serenade_tpu_torch`` against the JAX
package's ``Serenade.apply(..., method="inference")`` followed by
``HiFiGANGenerator.apply``, with the same parameters (JAX's seeded init
through ``convert.py``), the same normalization and JAX's own noise draw
handed to the port as ``x0``.  Small widths, f32, on the CPU.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from serenade_tpu.collaters.ssc import bucket_length, pad_to
from serenade_tpu.models.serenade import Serenade as JaxSerenade
from serenade_tpu.vocoder.hifigan import HiFiGANGenerator as JaxHiFiGAN

from serenade_tpu_torch import configs
from serenade_tpu_torch.api import Converter
from serenade_tpu_torch.vocoder.vocoder import Vocoder
from test_torch_models import assert_bf16_parity

REPO = Path(__file__).resolve().parent.parent

CFG = dict(input_dim=32, output_dim=80, encoder_channels=16,
           encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
           decoder_attention_head_dim=32, gst_tokens=10,
           gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16)
VOC = dict(in_channels=80, channels=32, upsample_scales=(2, 3),
           upsample_kernel_sizes=(4, 6))
TEMP, STEPS = 0.667, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(rng, frames, with_mel):
    feats = {"hubert": rng.normal(size=(frames, 32)) * 2 + 1,
             "score": rng.uniform(40, 80, size=frames),
             "loud": rng.uniform(-60, 0, size=frames)}
    if with_mel:
        feats["logmel"] = rng.normal(size=(frames, 80)) - 3
    return feats


def _scaler(rng):
    return {"hubert": {"mean": rng.normal(size=32),
                       "scale": rng.uniform(1, 3, size=32)},
            "score": {"min": 30.0, "max": 90.0},
            "loud": {"min": -80.0, "max": 0.0},
            "logmel": {"mean": rng.normal(size=80) - 3,
                       "scale": rng.uniform(0.5, 2, size=80)}}


def _jax_side(sc, src, ref):
    """serenade_tpu/api.py's normalization and bucketing, then the JAX
    model; returns the inputs of Serenade.inference."""
    def norm(f, with_mel):
        out = [(f["hubert"] - sc["hubert"]["mean"]) / sc["hubert"]["scale"],
               (f["score"] - 30.0) / 60.0, (f["loud"] + 80.0) / 80.0]
        if with_mel:
            out.append((f["logmel"] - sc["logmel"]["mean"])
                       / sc["logmel"]["scale"])
        t = f["hubert"].shape[0]
        padded = [jnp.asarray(pad_to(np.asarray(a, np.float32).reshape(t, -1),
                                     bucket_length(t)))[None] for a in out]
        return padded, jnp.asarray([t])

    (x, midi, loud), lengths = norm(src, False)
    (rx, rmidi, rloud, rmel), rlengths = norm(ref, True)
    return (x, lengths, midi, loud, rx, rlengths, rmel, rmidi, rloud)


@pytest.fixture(scope="module")
def jax_conversion():
    """One seeded init of the JAX model, its normalized inputs, its f32
    mel and its noise draw scaled as the port's ``x0``, shared by the f32
    and bf16 conversion tests."""
    rng = np.random.default_rng(0)
    sc = _scaler(rng)
    src, ref = _features(rng, 150, False), _features(rng, 100, True)
    vstats = {"mean": rng.normal(size=80) - 3,
              "scale": rng.uniform(0.5, 2, size=80)}
    args = _jax_side(sc, src, ref)
    jmodel = JaxSerenade(**CFG, dtype=jnp.float32)
    k_init, k_noise = jax.random.split(jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda *a: jmodel.init(k_init, *a, rng=k_noise, n_timesteps=1,
                               method="inference"))(*args))
    t_packed = args[0].shape[1] + args[4].shape[1]
    x0 = np.asarray(jax.random.normal(k_noise, (1, t_packed, 80),
                                      jnp.float32) * TEMP)

    def mel(dtype):
        out = jax.jit(lambda p, *a: JaxSerenade(**CFG, dtype=dtype).apply(
            p, *a, rng=k_noise, n_timesteps=STEPS, temperature=TEMP,
            method="inference"))(params, *args)
        return np.asarray(out, np.float32)[0, :150]

    return dict(sc=sc, src=src, ref=ref, vstats=vstats, params=params,
                x0=x0, mel=mel)


def test_convert_features_matches_jax(jax_conversion):
    """Mel within 2e-4 (two Euler steps of the UNet after the encoder and
    GST stacks, f32) and waveform within 1e-4."""
    jc = jax_conversion
    sc, vstats = jc["sc"], jc["vstats"]
    mel_j = jc["mel"](jnp.float32)
    jgen = JaxHiFiGAN(**VOC)
    vparams = jax.tree_util.tree_map(np.asarray, jax.jit(jgen.init)(
        jax.random.key(1), jnp.zeros((1, 8, 80))))
    c = mel_j * sc["logmel"]["scale"] + sc["logmel"]["mean"]
    c = (c - vstats["mean"]) / vstats["scale"]
    wav_j = np.asarray(jax.jit(jgen.apply)(
        vparams, jnp.asarray(c, jnp.float32)[None]))[0, :, 0]

    conv = Converter(
        dict(CFG, dtype="float32"), jc["params"], sc,
        vocoder_config={"sampling_rate": 24000, "generator_params": VOC},
        vocoder_params=vparams, vocoder_stats=vstats, n_timesteps=STEPS,
        temperature=TEMP, device="cpu")
    mel, wav, sr = conv.convert_features(jc["src"], jc["ref"], x0=jc["x0"])
    assert sr == 24000 and wav.shape == (150 * 6,)
    np.testing.assert_allclose(mel, mel_j, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(wav, wav_j, rtol=1e-4, atol=1e-4)


def test_serenade_inference_bf16_matches_jax(jax_conversion):
    """``Serenade.inference`` in bf16 compute (f32 parameters), two Euler
    steps with JAX's noise as ``x0``: the mel held against JAX's bf16 mel
    relative to JAX's own bf16 - f32 gap, as
    ``test_torch_models.assert_bf16_parity`` states."""
    jc = jax_conversion
    conv = Converter(dict(CFG, dtype="bfloat16"), jc["params"], jc["sc"],
                     n_timesteps=STEPS, temperature=TEMP, device="cpu")
    mel, _, _ = conv.convert_features(jc["src"], jc["ref"], x0=jc["x0"])
    assert_bf16_parity(mel, jc["mel"](jnp.bfloat16), jc["mel"](jnp.float32))


def test_converter_draws_its_own_noise_reproducibly():
    rng = np.random.default_rng(1)
    sc = _scaler(rng)
    src, ref = _features(rng, 70, False), _features(rng, 64, True)
    mels = [Converter(dict(CFG, dtype="float32"), None, sc, n_timesteps=1,
                      seed=3, device="cpu").convert_features(src, ref)[0]
            for _ in range(2)]
    assert mels[0].shape == (70, 80) and np.isfinite(mels[0]).all()
    np.testing.assert_array_equal(mels[0], mels[1])


def test_params_as_state_dict_or_flax_tree():
    """A state dict loads as it is; a flax tree with a leaf missing is
    refused by name rather than loaded partly."""
    from serenade_tpu_torch.convert import load_params, state_dict_from_flax
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.vocoder.hifigan import HiFiGANGenerator

    src = init_params_(HiFiGANGenerator(**VOC), seed=4)
    dst = load_params(HiFiGANGenerator(**VOC), src.state_dict())
    for (name, a), (_, b) in zip(src.state_dict().items(),
                                 dst.state_dict().items()):
        assert torch.equal(a, b), name
    jgen = JaxHiFiGAN(**VOC)
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(jgen.init)(
        jax.random.key(2), jnp.zeros((1, 8, 80))))
    del tree["params"]["block_1_2"]["conv2_1"]["bias"]
    with pytest.raises(KeyError, match="block_1_2.conv2_1.bias"):
        state_dict_from_flax(HiFiGANGenerator(**VOC), tree)


# ---------------------------------------------------------------------------
# rules of the port
# ---------------------------------------------------------------------------

FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "optax", "ml_dtypes",
             "serenade_tpu", "sklearn"}
# readers of the recipe's files (h5 dumps, stats.joblib, YAML configs) and
# the training loop's optional outputs (mel plots, tensorboard scalars):
# imported only inside the functions that use them, so the port's
# runtime imports and runs without them; chip_smoke.py needs none
READERS = {"h5py", "joblib", "yaml", "matplotlib", "tensorboardX"}


def _imported_roots(path: Path):
    """(root package, imported inside a function) of every import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    in_function = {id(node) for fn in ast.walk(tree)
                   if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                   for node in ast.walk(fn)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            yield name.split(".")[0], id(node) in in_function


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "serenade_tpu_torch").rglob("*.py"))
    # distillation, evaluation and deployment among them (their CLIs read
    # h5py, joblib and pyyaml inside functions only)
    walked = {p.relative_to(REPO / "serenade_tpu_torch").as_posix()
              for p in files}
    assert {"trainers/distill.py", "bin/distill.py", "metrics.py",
            "bin/evaluate.py", "ops/world.py", "ops/sptk.py", "quantize.py",
            "deploy.py", "bin/export.py", "ops/custom_ops.py",
            "ops/primitives.py", "ops/harvest.py", "ops/world_synth.py",
            "utils/signal.py", "native.py", "sifigan/features.py",
            "sifigan/generator.py", "sifigan/convert.py",
            "bin/ssc_postprocessing.py", "models/nusvc.py",
            "modules/gst_attention.py", "bin/param_count.py",
            "utils/plot.py", "utils/types.py"} <= walked
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = {f"{p.relative_to(REPO)}: {root}" for p in files
           for root, lazy in _imported_roots(p)
           if root in FORBIDDEN or (root in READERS and (
               not lazy or p.name == "chip_smoke.py"))}
    assert not bad, sorted(bad)


def test_full_width_configs_match_recipe():
    conf = REPO / "egs" / "gtsinger" / "ssc1" / "conf"
    with open(conf / "serenade.yaml") as f:
        ssc = yaml.safe_load(f)
    with open(conf / "vocoder_hifigan.yaml") as f:
        voc = yaml.safe_load(f)
    assert configs.SERENADE_MODEL_PARAMS == ssc["model_params"]
    assert configs.SERENADE_DTYPE == "bfloat16"
    assert configs.VOCODER_CONFIG["generator_params"] == voc["generator_params"]
    for key in ("sampling_rate", "num_mels", "hop_size"):
        assert configs.VOCODER_CONFIG[key] == voc[key]
    assert configs.VOCODER_CONFIG["sampling_rate"] == ssc["sampling_rate"]
    assert configs.VOCODER_TRAIN_CONFIG == voc
    for name, cfg in (("vocoder_sifigan.yaml", configs.SIFIGAN_TRAIN_CONFIG),
                      ("vocoder_griffin_lim.yaml",
                       configs.GRIFFIN_LIM_CONFIG)):
        with open(conf / name) as f:
            assert cfg == yaml.safe_load(f), name
    with open(conf / "serenade_fullbudget.yaml") as f:
        assert yaml.safe_load(f)["vocoder"]["config"].endswith(
            "vocoder_griffin_lim.yaml")


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = _scaler(np.random.default_rng(2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Converter(dict(CFG, dtype="float32"), None, sc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Vocoder({"generator_params": VOC}, None,
                {"mean": np.zeros(80), "scale": np.ones(80)},
                take_norm_feat=False)
    from serenade_tpu_torch.models.serenade import Serenade
    from serenade_tpu_torch.trainers import build_optimizer, build_train_step

    model = Serenade(**dict(CFG, dtype="float32"))
    opt, _ = build_optimizer({"optimizer_type": "AdamW"})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_train_step(model, opt)
    build_train_step(model, opt, device="cpu")
    from serenade_tpu_torch import metrics
    from serenade_tpu_torch.bin import evaluate
    from serenade_tpu_torch.trainers.distill import build_distill_step

    teacher = Serenade(**dict(CFG, dtype="float32"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_distill_step(model, teacher, opt)
    build_distill_step(model, teacher, opt, device="cpu")
    wav = np.zeros(2400, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        metrics.extract_eval_feats(wav, 24000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(["--converted-dir", ".", "--target-dir", "."])
    from serenade_tpu_torch import deploy

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deploy.load("artifact")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Converter(dict(CFG, dtype="float32"), None, sc, quantize="int8")
    from serenade_tpu_torch.bin import ssc_postprocessing
    from serenade_tpu_torch.sifigan.features import world_mcep_bap
    from serenade_tpu_torch.utils.signal import world_extract

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ssc_postprocessing.load_generator(ssc_postprocessing.DEFAULT_CONFIG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ssc_postprocessing.main(["--in-dir", "."])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        world_mcep_bap(wav, np.zeros(21, np.float32), 24000, 5.0, 39)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        world_extract(wav, 24000)


@pytest.mark.parametrize("stats", [None, {"mean": np.zeros(80)},
                                   {"mean": None, "scale": np.ones(80)}])
def test_vocoder_raises_on_missing_stats(stats):
    with pytest.raises(FileNotFoundError):
        Vocoder({"generator_params": VOC}, None, stats,
                take_norm_feat=False, device="cpu")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card (and in a directory holding nothing else of the
    repository) the smoke test exits non-zero and prints no result."""
    import subprocess
    import sys

    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
