"""Exported programs of the midpoint and Adams-Bashforth 2 solvers
(``CFM._rollout_for_export``'s other two ``while_loop`` bodies) against
the live Converter's rollout at three steps and one seed.  The head dim,
16, is one the flash kernel refuses, so each program also shows a refused
shape routed and counted when it runs, as the live path counts it.
Beside ``tests/test_torch_deploy.py`` (the test workers run the files
side by side).  Small widths, f32, on the CPU.
"""

import numpy as np
import pytest
import torch

from serenade_tpu_torch import deploy
from serenade_tpu_torch.api import Converter
from serenade_tpu_torch.collaters.ssc import bucket_length
from serenade_tpu_torch.ops import block1d_cuda, flash_cuda

CFG = dict(input_dim=32, output_dim=80, encoder_channels=16,
           encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
           decoder_attention_head_dim=16, gst_tokens=10,
           gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16, dtype="float32")
SCALER = {"hubert": {"mean": np.linspace(-0.5, 0.5, 32),
                     "scale": np.linspace(1.0, 2.0, 32)},
          "score": {"min": 30.0, "max": 90.0},
          "loud": {"min": -80.0, "max": 0.0},
          "logmel": {"mean": np.linspace(-4, -2, 80),
                     "scale": np.linspace(0.5, 2.0, 80)}}
SRC_T, REF_T = 120, 90
STEPS = 3


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
           "score": rng.uniform(40, 80, t), "loud": rng.uniform(-60, 0, t)}
    if mel:
        out["logmel"] = rng.normal(size=(t, 80)) - 3
    return out


@pytest.mark.parametrize("solver", ["midpoint", "ab2"])
def test_solver_program_matches_live_rollout(solver, tmp_path):
    """The program's mel within 1e-4 of the live Converter's at the same
    seed and solver, two conversions in turn; each conversion routes the
    same attention calls as the live one, and more than none."""
    conv = Converter(CFG, None, SCALER, n_timesteps=STEPS, solver=solver,
                     seed=5, device="cpu")
    art_dir = str(tmp_path / solver)
    bucket = (bucket_length(SRC_T), bucket_length(REF_T))
    man = deploy.export_converter(conv, art_dir, buckets=(bucket,))
    assert (man["solver"], man["n_timesteps"]) == (solver, STEPS)
    exp = deploy.load(art_dir, seed=17, device="cpu")
    name = "convert_s%d_r%d" % bucket
    assert man["custom_ops"][name]["cpu"] == deploy.program_ops(
        exp.programs[name])
    conv.generator.manual_seed(17)
    rng = np.random.default_rng(4)
    src, ref = _feats(rng, SRC_T, False), _feats(rng, REF_T, True)
    mels = []
    for _ in range(2):      # the second draws the next noise
        out = []
        for run in (conv, exp):
            flash_cuda.routed = block1d_cuda.routed = 0
            mel = run.convert_features(src, ref)[0]
            out.append((mel, flash_cuda.routed, block1d_cuda.routed))
        (mel_l, *live), (mel_e, *art) = out
        np.testing.assert_allclose(mel_e, mel_l, rtol=1e-4, atol=1e-4)
        assert art == live and live[0] > 0, (art, live)
        mels.append(mel_e)
    assert np.abs(mels[1] - mels[0]).max() > 1e-3
