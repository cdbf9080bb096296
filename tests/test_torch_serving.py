"""The port's serving slice: batched conversion, the vocoder tail, the
request-batching server, its wire format and its CLI.

``Converter.convert_features_batch`` and ``Vocoder.decode_batch_device`` of
``serenade_tpu_torch`` against the JAX package on the same parameters (JAX's
seeded init through ``convert.py``), the same stacked inputs and JAX's own
noise as ``x0``; ``serving.py`` and ``bin/serve.py`` on the CPU at small
width.
"""

import io
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from serenade_tpu import serving as jax_serving
from serenade_tpu.collaters.ssc import pad_to
from serenade_tpu.models.serenade import Serenade as JaxSerenade
from serenade_tpu.vocoder.hifigan import HiFiGANGenerator as JaxHiFiGAN

from serenade_tpu_torch import serving
from serenade_tpu_torch.api import Converter
from serenade_tpu_torch.bin import serve
from serenade_tpu_torch.collaters.ssc import next_pow2
from serenade_tpu_torch.vocoder.vocoder import Vocoder
from test_torch_models import assert_bf16_parity
from test_torch_slice import CFG, STEPS, TEMP, VOC, _features, _scaler

# three requests in two source buckets (192, 128), padded to batch 4
SRC_FRAMES, REF_FRAMES = (150, 100, 70), (100, 64, 90)
TS, TR = 192, 128
VOC_CONFIG = {"sampling_rate": 24000, "generator_params": VOC}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_inputs(sc, srcs, refs, ts, tr):
    """The stacked, normalized inputs of JAX's ``Serenade.inference``, the
    last request repeated to a power-of-two batch as
    serenade_tpu/api.py ``convert_features_batch`` pads it."""
    srcs = list(srcs) + [srcs[-1]] * (next_pow2(len(srcs)) - len(srcs))
    refs = list(refs) + [refs[-1]] * (len(srcs) - len(refs))

    def stack(feats, with_mel, T):
        cols = [[(f["hubert"] - sc["hubert"]["mean"]) / sc["hubert"]["scale"],
                 (f["score"] - 30.0) / 60.0, (f["loud"] + 80.0) / 80.0]
                + ([(f["logmel"] - sc["logmel"]["mean"])
                    / sc["logmel"]["scale"]] if with_mel else [])
                for f in feats]
        arrays = [jnp.asarray(np.stack([
            pad_to(np.asarray(c[j], np.float32).reshape(
                f["hubert"].shape[0], -1), T) for c, f in zip(cols, feats)]))
            for j in range(len(cols[0]))]
        return arrays, jnp.asarray([f["hubert"].shape[0] for f in feats])

    (x, midi, loud), lengths = stack(srcs, False, ts)
    (rx, rmidi, rloud, rmel), rlengths = stack(refs, True, tr)
    return (x, lengths, midi, loud, rx, rlengths, rmel, rmidi, rloud)


@pytest.fixture(scope="module")
def jax_batch():
    """One seeded init of the JAX model, three requests and their shared
    reference, and JAX's batched mels with its noise as ``x0``."""
    rng = np.random.default_rng(10)
    sc = _scaler(rng)
    srcs = [_features(rng, n, False) for n in SRC_FRAMES]
    refs = [_features(rng, n, True) for n in REF_FRAMES]
    k_init, k_noise = jax.random.split(jax.random.key(7))
    args = _jax_inputs(sc, srcs, refs, TS, TR)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda *a: JaxSerenade(**CFG, dtype=jnp.float32).init(
            k_init, *a, rng=k_noise, n_timesteps=1,
            method="inference"))(*args))
    x0 = np.asarray(jax.random.normal(k_noise, (4, TS + TR, 80),
                                      jnp.float32) * TEMP)
    infer = {dtype: jax.jit(lambda p, *a, dtype=dtype: JaxSerenade(
        **CFG, dtype=dtype).apply(p, *a, rng=k_noise, n_timesteps=STEPS,
                                  temperature=TEMP, method="inference"))
        for dtype in (jnp.float32, jnp.bfloat16)}

    def mels(dtype, form):
        ref_rows = refs if form == "ref_list" else [refs[0]] * 3
        out = np.asarray(infer[dtype](
            params, *_jax_inputs(sc, srcs, ref_rows, TS, TR)), np.float32)
        return [out[i, :n] for i, n in enumerate(SRC_FRAMES)]

    return dict(sc=sc, srcs=srcs, refs=refs, params=params, x0=x0,
                mels=mels)


def _port(jb, dtype):
    return Converter(dict(CFG, dtype=dtype), jb["params"], jb["sc"],
                     n_timesteps=STEPS, temperature=TEMP, device="cpu")


def _convert_batch(conv, jb, form):
    if form == "ref_list":
        kw = dict(ref_list=jb["refs"])
    else:
        kw = dict(packed_ref=conv.pack_reference(jb["refs"][0]))
    return conv.convert_features_batch(jb["srcs"], pad_batch_pow2=True,
                                       x0=jb["x0"], **kw)


@pytest.mark.parametrize("form", ["ref_list", "packed_ref"])
def test_convert_features_batch_matches_jax(jax_batch, form):
    """f32: each request's mel within 2e-4 of JAX's row of the same
    padded batch (two Euler steps after the encoder and GST stacks)."""
    jb = jax_batch
    got = _convert_batch(_port(jb, "float32"), jb, form)
    want = jb["mels"](jnp.float32, form)
    assert [m.shape for m in got] == [(n, 80) for n in SRC_FRAMES]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("form", ["ref_list", "packed_ref"])
def test_convert_features_batch_bf16_matches_jax(jax_batch, form):
    """bf16 compute: the batch's valid frames held against JAX's bf16 mel
    relative to JAX's own bf16 - f32 gap (``assert_bf16_parity``)."""
    jb = jax_batch
    got = np.concatenate(_convert_batch(_port(jb, "bfloat16"), jb, form))
    assert_bf16_parity(got, np.concatenate(jb["mels"](jnp.bfloat16, form)),
                       np.concatenate(jb["mels"](jnp.float32, form)))


def test_batched_rows_stay_independent(jax_batch):
    """Row i of a batched conversion equals request i converted alone at
    the same buckets from the same noise row: per-row lengths in the
    packing, the key masks and the masked GroupNorm leak nothing between
    rows."""
    jb = jax_batch
    conv = _port(jb, "float32")
    batch = _convert_batch(conv, jb, "ref_list")
    for i, (src, ref) in enumerate(zip(jb["srcs"], jb["refs"])):
        alone, = conv.convert_features_batch(
            [src], [ref], ts=TS, tr=TR, x0=jb["x0"][i:i + 1])
        np.testing.assert_allclose(batch[i], alone, rtol=1e-5, atol=1e-5)


def test_packed_reference_stays_on_device_and_tiles_contiguously(jax_batch):
    jb = jax_batch
    conv = _port(jb, "float32")
    packed = conv.pack_reference(jb["refs"][1])
    assert packed["hubert"].shape == (1, 64, 32)
    assert packed["logmel"].shape == (1, 64, 80)
    assert packed["lengths"].tolist() == [64]
    seen = {}
    inference = conv.model.inference

    def spy(*args, **kw):
        seen["strides"] = [a.stride() for a in args[4:9]]
        return inference(*args, **kw)

    conv.model.inference = spy
    conv.convert_features_batch(jb["srcs"], packed_ref=packed,
                                pad_batch_pow2=True)
    # the reference reaches the model as a real tile, batch stride > 0
    assert all(s[0] > 0 for s in seen["strides"]), seen


def _jax_generator(seed=1):
    jgen = JaxHiFiGAN(**VOC)
    return jgen, jax.tree_util.tree_map(np.asarray, jax.jit(jgen.init)(
        jax.random.key(seed), jnp.zeros((1, 8, 80))))


def test_vocoder_tail_matches_jax():
    """``decode_batch_device`` against the JAX tail of
    serenade_tpu/vocoder/vocoder.py written out (edge pad past each
    row's length, denormalize, generator, PCM16) within one int16 step;
    frames past a row's length do not reach its waveform; ``decode`` and
    ``decode_batch`` within 1e-4 of the generator."""
    rng = np.random.default_rng(11)
    trg = {"mean": rng.normal(size=80) - 3, "scale": rng.uniform(0.5, 2, 80)}
    stats = {"mean": rng.normal(size=80) - 3,
             "scale": rng.uniform(0.5, 2, 80)}
    jgen, vparams = _jax_generator()
    voc = Vocoder(VOC_CONFIG, vparams, stats, trg_stats=trg, device="cpu")
    c = rng.normal(size=(4, 64, 80)).astype(np.float32)
    lengths = np.array([64, 40, 17, 40])

    def jax_tail(c):
        idx = jnp.minimum(jnp.arange(64)[None, :], (lengths - 1)[:, None])
        c = jnp.take_along_axis(jnp.asarray(c), idx[:, :, None], axis=1)
        c = c * trg["scale"] + trg["mean"]
        c = ((c - stats["mean"]) / stats["scale"]).astype(jnp.float32)
        y = jgen.apply(vparams, c)[..., 0]
        return np.asarray(jnp.round(jnp.clip(y, -1.0, 1.0) * 32767.0)
                          .astype(jnp.int16))

    got = voc.decode_batch_device(torch.from_numpy(c), lengths.tolist())
    assert got.dtype == torch.int16 and got.shape == (4, 64 * 6)
    want = jax_tail(c)
    assert np.abs(got.numpy().astype(np.int32) - want).max() <= 1
    # garbage past each row's length changes nothing
    noisy = c.copy()
    for i, n in enumerate(lengths):
        noisy[i, n:] = rng.normal(size=(64 - n, 80)) * 5
    again = voc.decode_batch_device(torch.from_numpy(noisy),
                                    lengths.tolist())
    assert torch.equal(again, got)

    def jax_wav(c):
        c = c * trg["scale"] + trg["mean"]
        c = ((c - stats["mean"]) / stats["scale"]).astype(np.float32)
        return np.asarray(jgen.apply(vparams, jnp.asarray(c)))[..., 0]

    wav, sr = voc.decode(c[1, :40])
    assert sr == 24000 and wav.shape == (240,)
    np.testing.assert_allclose(wav, jax_wav(c[1:2, :40])[0], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(voc.decode_batch(c), jax_wav(c), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the batching server on the CPU
# ---------------------------------------------------------------------------

def _converter(rng, vocoder=True, **kw):
    vkw = dict(vocoder_config=VOC_CONFIG, vocoder_stats={
        "mean": np.zeros(80), "scale": np.ones(80)}) if vocoder else {}
    return Converter(dict(CFG, dtype="float32"), None, _scaler(rng),
                     n_timesteps=1, device="cpu", **vkw, **kw)


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(12)
    return dict(conv=_converter(rng), src=_features(rng, 70, False),
                ref=_features(rng, 64, True), src2=_features(rng, 150, False))


def _concurrently(fn, n):
    results, errors = [None] * n, []

    def call(i):
        try:
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — asserted by the caller
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def test_batching_converter_groups_concurrent_requests(small, monkeypatch):
    """Four concurrent requests of one bucket pair go out as one batch,
    run by the dispatcher thread with gradients off."""
    conv = small["conv"]
    seen = []
    run = conv.convert_features_batch

    def spy(*args, **kw):
        seen.append((threading.current_thread().name,
                     torch.is_grad_enabled()))
        return run(*args, **kw)

    monkeypatch.setattr(conv, "convert_features_batch", spy)
    b = serving.BatchingConverter(conv, max_batch=4, max_wait_ms=500.0)
    try:
        results, errors = _concurrently(
            lambda i: b.convert(small["src"], small["ref"]), 4)
        assert not errors
        assert b.stats["requests"] == 4 and b.stats["batches"] == 1, b.stats
        assert seen == [("ssc-dispatcher", False)]
        for mel, wav, sr in results:
            assert mel.shape == (70, 80) and np.isfinite(mel).all()
            assert wav.shape == (70 * 6,) and sr == 24000
            assert np.abs(wav).max() <= 1.0
        assert b.stats["audio_sec"] == pytest.approx(4 * 0.7)
    finally:
        b.close()


def test_batching_converter_faults_bad_requests_alone(small, monkeypatch):
    """Malformed features are refused at submit; a batch that fails in the
    dispatcher faults its own requests only; the server keeps serving."""
    conv = small["conv"]
    b = serving.BatchingConverter(conv, max_batch=4, max_wait_ms=300.0)
    try:
        with pytest.raises(ValueError, match="hubert must be"):
            b.convert({**small["src"], "hubert": np.zeros((4, 3))},
                      small["ref"])
        with pytest.raises(ValueError, match="missing feature"):
            b.convert({"hubert": np.zeros((4, 32))}, small["ref"])
        with pytest.raises(ValueError, match="logmel must be"):
            b.convert(small["src"], {**small["ref"],
                                     "logmel": np.zeros((4, 2))})
        # a fault in one bucket's batch (source bucket 128): the request of
        # the other bucket (192) in the same window converts
        run = conv.convert_features_batch

        def faulty(src_list, *args, ts, **kw):
            if ts == 128:
                raise RuntimeError("injected fault")
            return run(src_list, *args, ts=ts, **kw)

        monkeypatch.setattr(conv, "convert_features_batch", faulty)
        results, errors = _concurrently(
            lambda i: b.convert(small["src"] if i == 0 else small["src2"],
                                small["ref"]), 2)
        assert [str(e) for e in errors] == ["injected fault"]
        assert results[1][0].shape == (150, 80)
        assert b.stats["errors"] == 4 and b.stats["requests"] == 1
        assert b.stats["batches"] == 1
        monkeypatch.undo()
        mel, _, _ = b.convert(small["src"], small["ref"])
        assert np.isfinite(mel).all()
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="shutting down"):
        b.convert(small["src"], small["ref"])


def test_registered_styles_and_caps_refuse_at_submit(small):
    b = serving.BatchingConverter(small["conv"], max_references=1,
                                  max_request_seconds=1.0, max_wait_ms=1.0)
    try:
        b.register_reference("breathy", small["ref"])
        b.register_reference("breathy", small["ref"])  # re-register: fine
        with pytest.raises(ValueError, match="registry full"):
            b.register_reference("falsetto", small["ref"])
        assert b.reference_names() == ["breathy"]
        assert b.packed_reference("breathy")["hubert"].shape == (1, 64, 32)
        np.testing.assert_array_equal(
            b.raw_reference("breathy")["logmel"], small["ref"]["logmel"])
        with pytest.raises(KeyError, match="unknown reference style"):
            b.convert(small["src"], "mixed")
        # 1 s at 100 frames a second: 150 frames are over the cap
        with pytest.raises(ValueError, match="per-request cap"):
            b.convert(small["src2"], "breathy")
        with pytest.raises(ValueError, match="per-request cap"):
            b.register_reference("breathy", {**small["ref"], **{
                k: np.zeros((101,) + np.shape(v)[1:])
                for k, v in small["ref"].items()}})
        mel, wav, _ = b.convert(small["src"], "breathy")
        assert mel.shape == (70, 80) and wav.shape == (420,)
        assert b.stats["errors"] == 2
    finally:
        b.close()


def test_close_faults_queued_requests_on_a_stuck_dispatcher(small):
    b = serving.BatchingConverter(small["conv"], max_wait_ms=1.0)
    release = threading.Event()
    run = b._run_group

    def slow_run(reqs, ts, tr):
        release.wait(30.0)
        run(reqs, ts, tr)

    b._run_group = slow_run
    b._queue.put(serving._Request(src=small["src"], ref=small["ref"]))
    time.sleep(0.3)
    queued = serving._Request(src=small["src"], ref=small["ref"])
    b._queue.put(queued)
    t0 = time.monotonic()
    b.close(join_timeout=0.5)
    assert time.monotonic() - t0 < 5.0
    assert queued.done.is_set() and isinstance(queued.error, RuntimeError)
    release.set()
    b._thread.join(timeout=30)
    assert not b._thread.is_alive()


def test_wire_format_is_the_jax_servers():
    """Bodies the JAX package's client helpers build parse here, and the
    port's parse there; a response either server writes decodes with
    either's ``decode_response``.  serenade_tpu/serving.py itself imports
    no JAX."""
    rng = np.random.default_rng(13)
    src, ref = _features(rng, 20, False), _features(rng, 30, True)

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    for encode, parse in ((jax_serving.encode_request, serving._parse_npz),
                          (serving.encode_request, jax_serving._parse_npz)):
        s, r = parse(encode(src, ref))
        same(s, src)
        same(r, ref)
        s, r = parse(encode(src, "breathy"))
        same(s, src)
        assert r == "breathy"
    for encode, parse in ((jax_serving.encode_reference,
                           serving._parse_ref_npz),
                          (serving.encode_reference,
                           jax_serving._parse_ref_npz)):
        same(parse(encode(ref)), ref)
    mel, wav = rng.normal(size=(20, 80)), rng.normal(size=120)
    buf = io.BytesIO()
    np.savez(buf, mel=mel, wav=wav, sr=np.int64(24000))
    for decode in (serving.decode_response, jax_serving.decode_response):
        m, w, sr = decode(buf.getvalue())
        np.testing.assert_array_equal(m, mel)
        np.testing.assert_array_equal(w, wav)
        assert sr == 24000
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, serenade_tpu.serving; "
         "assert 'jax' not in sys.modules"], capture_output=True, text=True,
        timeout=60)
    assert proc.returncode == 0, proc.stderr


def _cli_files(tmp_path, rng):
    sc = _scaler(rng)
    stats = tmp_path / "stats.npz"
    np.savez(stats, **{f"{feat}_{stat}": np.asarray(v, np.float32)
                       for feat, d in sc.items() for stat, v in d.items()})
    np.savez(tmp_path / "vstats.npz", mean=np.zeros(80), scale=np.ones(80))
    (tmp_path / "model.json").write_text(json.dumps(
        dict(CFG, dtype="float32")))
    (tmp_path / "voc.json").write_text(json.dumps(VOC_CONFIG))
    np.savez(tmp_path / "breathy.npz", **_features(rng, 64, True))
    (tmp_path / "styles.json").write_text(json.dumps(
        {"breathy": str(tmp_path / "breathy.npz")}))
    return ["--model-config", str(tmp_path / "model.json"),
            "--stats", str(stats),
            "--vocoder-config", str(tmp_path / "voc.json"),
            "--vocoder-stats", str(tmp_path / "vstats.npz"),
            "--ref-dict", str(tmp_path / "styles.json"),
            "--n-timesteps", "1", "--port", "0", "--max-wait-ms", "1"]


def test_serve_cli_http_round_trip(tmp_path):
    """``bin/serve.py``'s app from a JSON config and ``.npz`` statistics on
    port 0: /healthz, /metrics, /convert_features (a body built by the JAX
    package's client, its response read by the JAX package's
    ``decode_response``), /register_reference, and the streams:
    /convert_stream answers a block stream that JAX's client reads to its
    done marker, /convert_stream_live a 400 without ContentVec."""
    rng = np.random.default_rng(14)
    args = serve.build_argparser().parse_args(
        _cli_files(tmp_path, rng) + ["--device", "cpu", "--warmup", "70:64:2"])
    server, batching = serve.build_app(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(base + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        # warm-up ran and left the counters as they were
        assert health["ok"] and health["requests"] == 0
        assert health["references"] == ["breathy"]
        src, ref = _features(rng, 70, False), _features(rng, 90, True)
        status, body = post("/convert_features",
                            jax_serving.encode_request(src, "breathy"))
        mel, wav, sr = jax_serving.decode_response(body)
        assert status == 200 and mel.shape == (70, 80)
        assert wav.shape == (420,) and sr == 24000
        status, body = post("/register_reference?name=mixed",
                            jax_serving.encode_reference(ref))
        assert status == 200 and json.loads(body)["name"] == "mixed"
        _, body = post("/convert_features", serving.encode_request(src, ref))
        assert serving.decode_response(body)[0].shape == (70, 80)
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            metrics = r.read().decode()
        assert "serenade_requests_total 2" in metrics
        assert "serenade_registered_references 2" in metrics
        # the streams: features in answer a block stream ending with its
        # done marker; live audio needs ContentVec, which this server lacks
        req = urllib.request.Request(
            base + "/convert_stream?chunk_frames=64&overlap_frames=16",
            data=serving.encode_request(src, "breathy"), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            blocks = list(jax_serving.iter_stream_blocks(r))
        assert [int(b["start"]) for b in blocks] == [0, 48]
        assert sum(b["mel"].shape[0] for b in blocks) == 70
        with pytest.raises(urllib.error.HTTPError) as exc:
            post("/convert_stream_live?style=breathy", b"\0\0" * 4800)
        assert exc.value.code == 400
        assert "ContentVec" in json.loads(exc.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            post("/convert_features", serving.encode_request(src, "nope"))
        assert exc.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        batching.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_http_body_size_cap(small):
    """A body over ``max_body_bytes`` is refused with 413 before it is
    read, and the connection is closed."""
    b = serving.BatchingConverter(small["conv"])
    server = serving.make_server(b, port=0, max_body_bytes=1000)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/convert_features",
            data=serving.encode_request(small["src"], small["ref"]))
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 413
        assert "exceeds the server cap" in json.loads(
            exc.value.read())["error"]
        assert b.stats["requests"] == 0
    finally:
        server.shutdown()
        server.server_close()
        b.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_serve_cli_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.build_argparser().parse_args(
        _cli_files(tmp_path, np.random.default_rng(15)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_app(args)
    args = serve.build_argparser().parse_args(
        ["--stats", "s.npz", "--vocoder-params", "v.pt"])
    with pytest.raises(SystemExit, match="need --vocoder-stats"):
        serve.build_app(args)


def test_converter_config_is_the_recipes():
    import yaml

    from serenade_tpu_torch.configs import FEATURE_CONFIG
    from test_torch_slice import REPO

    with open(REPO / "egs" / "gtsinger" / "ssc1" / "conf"
              / "serenade.yaml") as f:
        recipe = yaml.safe_load(f)
    assert FEATURE_CONFIG == {k: recipe[k] for k in FEATURE_CONFIG}
    assert next_pow2(1) == 1 and next_pow2(3) == 4 and next_pow2(8) == 8
