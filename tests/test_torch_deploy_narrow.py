"""Deployment artifacts of a narrow F0-fluctuation variant
(``SerenadeNew``) from seeded weights, in f32 and in int8: each against
the live Converter of the same weights, mode and seed (the variant's
shifts drawn after the noise, as the live Converter draws them), and the
int8 artifact's size against the f32 one.  The widths make the weights,
and not the saved graph, most of an artifact.  Beside
``tests/test_torch_deploy.py`` (the test workers run the two files side
by side).  Small widths, f32, on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from serenade_tpu_torch import deploy
from serenade_tpu_torch.api import Converter
from serenade_tpu_torch.collaters.ssc import bucket_length
import torch_parallel_worker as worker

CFG = dict(input_dim=32, output_dim=80, encoder_channels=16,
           encoder_hidden_dim=64, decoder_channels=128, gst_embed_dim=64,
           decoder_attention_head_dim=32, gst_tokens=10,
           gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16, dtype="float32")
SCALER = {"hubert": {"mean": np.linspace(-0.5, 0.5, 32),
                     "scale": np.linspace(1.0, 2.0, 32)},
          "score": {"min": 30.0, "max": 90.0},
          "loud": {"min": -80.0, "max": 0.0},
          "logmel": {"mean": np.linspace(-4, -2, 80),
                     "scale": np.linspace(0.5, 2.0, 80)}}
SRC_T, REF_T = 150, 100
MODES = {"f32": None, "int8": "int8"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feats(rng, t, mel):
    out = {"hubert": rng.normal(size=(t, 32)) * 2 + 0.3,
           "score": rng.uniform(40, 80, t), "loud": rng.uniform(-60, 0, t),
           "f0_fluc": rng.normal(size=(t, 1)) * 0.1}
    if mel:
        out["logmel"] = rng.normal(size=(t, 80)) - 3
    return out


def _converter(quantize):
    """The variant's Converter, weights from seed 11 (and its noise from
    11 until reseeded)."""
    return Converter(CFG, None, SCALER, n_timesteps=2, seed=11,
                     device="cpu", quantize=quantize,
                     model_type="SerenadeNew")


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """The f32 and int8 artifacts of the one set of weights, each at the
    buckets of a 150-frame source and a 100-frame reference, once a test
    run."""
    def export(root):
        out = {}
        for name, quantize in MODES.items():
            out[name] = str(root / name)
            deploy.export_converter(
                _converter(quantize), out[name],
                buckets=((bucket_length(SRC_T), bucket_length(REF_T)),))
        return out

    return worker.shared(tmp_path_factory, "torch_deploy_narrow_arts",
                         export)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_variant_artifact_matches_live(arts, mode):
    """Two conversions in turn, each within 1e-4 of the live Converter's
    at the same seed; the variant's artifact refuses features without
    ``f0_fluc``."""
    rng = np.random.default_rng(3)
    src, ref = _feats(rng, SRC_T, False), _feats(rng, REF_T, True)
    live = _converter(MODES[mode])
    live.generator.manual_seed(23)
    exp = deploy.load(arts[mode], seed=23, device="cpu")
    assert exp.manifest["quantize"] == MODES[mode]
    assert exp.manifest["variant_new"] and not exp.manifest["has_vocoder"]
    mels = []
    for _ in range(2):      # the second draws the next noise and shifts
        mel_l, _, _ = live.convert_features(src, ref)
        mel_e, wav_e, _ = exp.convert_features(src, ref)
        assert wav_e is None and mel_e.shape == (SRC_T, 80)
        np.testing.assert_allclose(mel_e, mel_l, rtol=1e-4, atol=1e-4)
        mels.append(mel_e)
    assert np.abs(mels[1] - mels[0]).max() > 1e-3
    with pytest.raises(ValueError, match="f0_fluc"):
        exp.convert_features({k: v for k, v in src.items()
                              if k != "f0_fluc"}, ref)


def test_int8_artifact_is_smaller(arts):
    """int8 constants in the program: the int8 artifact under 0.45x the f32
    one of the same weights (``tests/test_quantize.py``'s bound)."""
    def size(art):
        return sum(os.path.getsize(os.path.join(art, f))
                   for f in os.listdir(art) if f.endswith(".pt2"))

    q, f = size(arts["int8"]), size(arts["f32"])
    assert q < 0.45 * f, (q, f)
