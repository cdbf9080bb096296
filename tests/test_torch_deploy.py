"""Deployment artifacts of the port (``serenade_tpu_torch/deploy.py``,
``bin/export.py``, ``bin/serve.py --artifact``): the exported programs
against JAX's live Converter and the port's own, the artifact server, the
CLI contracts, and a loader that imports no model code.

The experiment is the decode tests' (``tests/test_torch_decode.py``),
exported through the CLI at the config's Euler-2 (the int8 artifact and
the F0-fluctuation variant's are in ``tests/test_torch_deploy_narrow.py``,
which the test workers run beside this file).  No JAX program is
exported.  Small widths, f32, on the CPU.
"""

import http.client
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from serenade_tpu_torch import deploy
from serenade_tpu_torch.api import Converter
from serenade_tpu_torch.bin import export as pexport
from serenade_tpu_torch.bin import serve as pserve
from serenade_tpu_torch.collaters.ssc import bucket_length
from serenade_tpu_torch.serving import (
    decode_response, encode_reference, encode_request, encode_wav_request,
)
import torch_parallel_worker as worker
from tests.test_torch_decode import (  # noqa: F401 (fixtures)
    MEL_TOL, UTTS, WAV_TOL, _dump_feats, expdirs, files,
)

REPO = Path(__file__).resolve().parent.parent
HOP = 4             # the decode tests' vocoder: upsample scales (2, 2)
EDGE = 16           # frames near the end the edge-pad may change


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cli_art(files, expdirs, tmp_path_factory):
    """The experiment exported by the CLI for the CPU at the dump pair's
    buckets, steps and solver from the config, once a test run."""
    def export(root):
        art = str(root / "cli")
        ts = bucket_length(expdirs["src"]["hubert"].shape[0])
        tr = bucket_length(expdirs["ref"]["hubert"].shape[0])
        pexport.main(["--expdir", str(expdirs["pdir"]), "--stats",
                      files["stats"], "--out-dir", art, "--buckets",
                      f"{ts}x{tr}", "--device", "cpu", "--verbose", "0"])
        return art

    return worker.shared(tmp_path_factory, "torch_deploy_cli_art", export)


@pytest.fixture(scope="module")
def loaded(cli_art):
    """The CLI artifact loaded once; each test seeds its generator."""
    return deploy.load(cli_art, device="cpu")


def test_export_cli_manifest(cli_art, expdirs):
    """JAX's manifest keys, the steps and solver of the config, the module
    that registers the custom ops, one program a bucket and platform."""
    with open(os.path.join(cli_art, "manifest.json")) as f:
        man = json.load(f)
    assert man["kind"] == "serenade_tpu_torch.converter"
    assert (man["n_timesteps"], man["solver"]) == (2, "euler")
    assert man["platforms"] == ["cpu"] and man["quantize"] is None
    assert man["has_vocoder"] and man["hop_size"] == HOP
    assert man["sample_rate"] == 24000 and man["frame_shift_s"] == 0.01
    assert man["ops_module"] == "serenade_tpu_torch.ops.custom_ops"
    assert "torch_version" in man and "jax_version" not in man
    (name, per), = man["files"].items()
    assert list(per) == ["cpu"]
    # K1 and K2 once in the ODE loop's body, K3 once a residual branch
    ops = man["custom_ops"][name]["cpu"]
    assert set(ops) == {"flash_fwd", "block1d_fwd", "resblock_branch"}
    assert min(ops.values()) > 0
    assert os.path.getsize(os.path.join(cli_art, per["cpu"])) > 1000


def test_artifact_matches_jax_at_temperature_0(loaded, expdirs):
    """The artifact at temperature 0 against JAX's live Converter on the
    same experiment: mel within the decode tests' tolerance, the waveform
    too away from the last frames (the artifact edge-pads its bucket
    before vocoding, JAX's live path vocodes the true length)."""
    temperature = loaded.manifest["temperature"]
    loaded.manifest["temperature"] = 0.0
    try:
        mel, wav, sr = loaded.convert_features(expdirs["src"],
                                               expdirs["ref"])
    finally:
        loaded.manifest["temperature"] = temperature
    assert sr == expdirs["sr"] == 24000
    assert mel.shape == expdirs["mel"].shape and wav.shape == \
        expdirs["wav"].shape
    np.testing.assert_allclose(mel, expdirs["mel"], rtol=MEL_TOL,
                               atol=MEL_TOL)
    cut = (mel.shape[0] - EDGE) * HOP
    np.testing.assert_allclose(wav[:cut], expdirs["wav"][:cut], rtol=WAV_TOL,
                               atol=WAV_TOL)


def test_artifact_matches_live_converter(loaded, files, expdirs):
    """At one nonzero-temperature seed the artifact draws the live
    Converter's noise: mel within 1e-4, waveform away from the edge within
    1e-3 (``tests/test_deploy.py``'s bounds).  The generator advances per
    call, and a request past every bucket is refused."""
    live = Converter.from_expdir(str(expdirs["pdir"]), files["stats"],
                                 seed=7, device="cpu")
    exp = loaded
    exp.generator.manual_seed(7)
    src, ref = expdirs["src"], expdirs["ref"]
    mel_l, wav_l, _ = live.convert_features(src, ref)
    mel_e, wav_e, _ = exp.convert_features(src, ref)
    np.testing.assert_allclose(mel_e, mel_l, rtol=1e-4, atol=1e-4)
    cut = (mel_l.shape[0] - EDGE) * HOP
    np.testing.assert_allclose(wav_e[:cut], wav_l[:cut], atol=1e-3)
    mel_e2, _, _ = exp.convert_features(src, ref)
    assert np.abs(mel_e2 - mel_e).max() > 1e-3
    big = {k: np.repeat(np.asarray(v), 8, axis=0) for k, v in src.items()}
    with pytest.raises(ValueError, match="no exported bucket"):
        exp.convert_features(big, ref)


def test_pick_bucket_minimizes_padded_work():
    exp = deploy.ExportedConverter.__new__(deploy.ExportedConverter)
    exp.manifest = {"buckets": [[512, 4096], [1024, 512], [2048, 2048]]}
    # a near fit of (1024, 512) beats the smaller-first (512, 4096): least
    # packed frames win
    assert exp._pick_bucket(400, 400) == (1024, 512)
    assert exp._pick_bucket(1500, 1000) == (2048, 2048)
    with pytest.raises(ValueError, match="no exported bucket"):
        exp._pick_bucket(4000, 100)


def test_artifact_refuses_another_platform(cli_art):
    """A program is exported for one device: loading it for another names
    both."""
    man_path = os.path.join(cli_art, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    other = os.path.join(os.path.dirname(cli_art), "cuda_only")
    os.makedirs(other, exist_ok=True)
    with open(os.path.join(other, "manifest.json"), "w") as f:
        json.dump(dict(man, platforms=["cuda"]), f)
    with pytest.raises(RuntimeError, match=r"\['cuda'\].*cpu"):
        deploy.load(other, device="cpu")


# -- the artifact server -----------------------------------------------------


def _post(conn, path, body):
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    return resp.status, resp.read()


def test_artifact_server(cli_art, files, expdirs):
    """``bin/serve.py --artifact`` on an ephemeral port: --ref-dict styles
    registered raw, /convert_features (its first answer the live
    Converter's at seed 0), /register_reference and a request by name;
    /convert_wav and /convert_stream answer 400; /healthz counts."""
    styles = files["root"] / "styles_artifact.json"
    styles.write_text(json.dumps(
        {"Falsetto": str(files["dump"] / f"{UTTS[3][0]}.h5")}))
    server, service = pserve.build_app(pserve.build_argparser().parse_args(
        ["--artifact", cli_art, "--ref-dict", str(styles), "--port", "0",
         "--device", "cpu"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert service.reference_names() == ["Falsetto"]
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=120)
        src, ref = expdirs["src"], expdirs["ref"]
        code, body = _post(conn, "/convert_features",
                           encode_request(src, ref))
        assert code == 200, body
        mel, wav, sr = decode_response(body)
        live = Converter.from_expdir(str(expdirs["pdir"]), files["stats"],
                                     seed=0, device="cpu")
        mel_l, _, _ = live.convert_features(src, ref)
        np.testing.assert_allclose(mel, mel_l, rtol=1e-4, atol=1e-4)
        assert sr == 24000 and wav.shape == (mel.shape[0] * HOP,)
        code, _ = _post(conn, "/register_reference?name=Breathy",
                        encode_reference(_dump_feats(files["dump"],
                                                     UTTS[1][0])))
        assert code == 200
        for style in ("Breathy", "Falsetto"):
            code, body = _post(conn, "/convert_features",
                               encode_request(src, style))
            assert code == 200, body
            assert np.isfinite(decode_response(body)[0]).all()
        code, body = _post(conn, "/convert_wav", encode_wav_request(
            np.zeros(2400, np.float32), 24000, "Breathy"))
        assert code == 400 and b"expdir" in body
        code, body = _post(conn, "/convert_stream",
                           encode_request(src, "Breathy"))
        assert code == 400 and b"convert_features" in body
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["requests"] == 3 and health["references"] == [
            "Breathy", "Falsetto"]
    finally:
        server.shutdown()
        server.server_close()
        service.close()


# the flags an export fixes, each refused beside --artifact
FIXED = {
    "expdir": ["--expdir", "exp"], "stats": ["--stats", "s.joblib"],
    "checkpoint": ["--checkpoint", "c.pkl"],
    "contentvec_ckpt": ["--contentvec-ckpt", "cv.pt"],
    "n_timesteps": ["--n-timesteps", "4"], "solver": ["--solver", "ab2"],
    "temperature": ["--temperature", "0.5"],
    "quantize": ["--quantize", "int8"], "f0_table": ["--f0-table", "f.json"],
    "model_config": ["--model-config", "m.json"],
    "params": ["--params", "p.pt"],
    "vocoder_stats": ["--vocoder-stats", "v.npz"],
    "model_type": ["--model-type", "SerenadeNew"],
    "warmup": ["--warmup", "128:128"], "warmup_raw": ["--warmup-raw",
                                                      "128:128"],
}


@pytest.mark.parametrize("flag", sorted(FIXED))
def test_serve_artifact_refuses_fixed_flags(flag):
    args = pserve.build_argparser().parse_args(
        ["--artifact", "art", "--device", "cpu", *FIXED[flag]])
    match = "--warmup" if flag.startswith("warmup") else FIXED[flag][0]
    with pytest.raises(SystemExit, match=match):
        pserve.build_app(args)


def test_serve_needs_stats_without_artifact():
    with pytest.raises(SystemExit, match="--stats"):
        pserve.build_app(pserve.build_argparser().parse_args(
            ["--device", "cpu"]))


def test_loading_imports_no_model_code(cli_art, expdirs, tmp_path):
    """In a fresh interpreter, loading the artifact and converting leaves
    no module of ``models/``, ``api``, ``checkpoint``, ``config`` or
    ``utils/scalers`` imported: the custom ops' module is all it needs."""
    feats = tmp_path / "pair.npz"
    np.savez(feats, **{f"src_{k}": v for k, v in expdirs["src"].items()},
             **{f"ref_{k}": v for k, v in expdirs["ref"].items()})
    code = f"""
import sys
import numpy as np
from serenade_tpu_torch.deploy import load
z = np.load({str(feats)!r})
pick = lambda p: {{k[4:]: z[k] for k in z.files if k.startswith(p)}}
mel, wav, sr = load({cli_art!r}, device="cpu").convert_features(
    pick("src_"), pick("ref_"))
assert np.isfinite(mel).all() and np.isfinite(wav).all()
banned = ("serenade_tpu_torch.models", "serenade_tpu_torch.api",
          "serenade_tpu_torch.checkpoint", "serenade_tpu_torch.config",
          "serenade_tpu_torch.utils.scalers", "serenade_tpu.", "jax")
loaded = [m for m in sys.modules if m.startswith(banned)
          or m in ("serenade_tpu", "jax")]
assert not loaded, loaded
assert "serenade_tpu_torch.ops.custom_ops" in sys.modules
print("LOADED_CLEAN")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0 and "LOADED_CLEAN" in proc.stdout, \
        proc.stderr[-3000:]
