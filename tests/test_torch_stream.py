"""The port's long-form and streaming slice against the JAX package on the
CPU.

``serenade_tpu_torch.ops.longform`` against ``serenade_tpu.ops.longform``
(exact); windowed extraction (``stream_total_frames``,
``extract_stream_window``) against JAX's; the Converter's stream paths
against JAX's long-form helpers and windowed extraction driving JAX's
``Serenade.inference`` and HiFiGAN on the same parameters at temperature
0 (both sides then integrate from x0 = 0, so the port's noise draws,
which never coincide with JAX's keys, drop out); the live path against
the windowed one; the block wire against ``serenade_tpu.serving``; and
both stream endpoints over HTTP on port 0.  The narrow ContentVec (2 x
64) and the ``CFG64`` model of ``tests/test_torch_features.py``, f32.

Run alone: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_stream.py -q``.
"""

import http.client
import io
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from serenade_tpu import features as jfeat
from serenade_tpu import serving as jserving
from serenade_tpu.models.serenade import Serenade as JaxSerenade
from serenade_tpu.ops import longform as jlf
from serenade_tpu.vocoder.hifigan import HiFiGANGenerator as JaxHiFiGAN

from serenade_tpu_torch import features, serving
from serenade_tpu_torch.api import Converter
from serenade_tpu_torch.ops import longform as plf
from test_torch_features import (  # noqa: F401 (fixtures)
    CFG64, CV, FC, SR, _narrow_scaler, assert_f0_agrees, content_fns,
    contentvec, sung,
)
from test_torch_slice import STEPS, VOC, _jax_side

CHUNK, OVERLAP, CTX = 128, 32, 32   # windows of at most 1.92 s: one 2 s
                                    # ContentVec bucket


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside JAX's thread pools and the other test
    workers: torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream_setup(contentvec, content_fns):
    """One seeded JAX init of the ``CFG64`` model and the HiFiGAN, the
    JAX side's per-chunk converter and vocoder, and the port's Converter
    on the same parameters at temperature 0."""
    jax_fn, _ = content_fns
    rng = np.random.default_rng(60)
    sc = _narrow_scaler(rng)
    vstats = {"mean": rng.normal(size=80) - 3,
              "scale": rng.uniform(0.5, 2, size=80)}
    ref = {"hubert": rng.normal(size=(100, 64)),
           "score": rng.uniform(40, 80, size=(100, 1)),
           "loud": rng.uniform(-60, 0, size=(100, 1)),
           "logmel": rng.normal(size=(100, 80)) - 3}
    jmodel = JaxSerenade(**CFG64, dtype=jnp.float32)
    k_init, k_noise = jax.random.split(jax.random.key(61))
    args = _jax_side(sc, {k: ref[k][:CHUNK] for k in ("hubert", "score",
                                                      "loud")}, ref)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda *a: jmodel.init(k_init, *a, rng=k_noise, n_timesteps=1,
                               method="inference"))(*args))
    infer = jax.jit(lambda p, *a: jmodel.apply(
        p, *a, rng=k_noise, n_timesteps=STEPS, temperature=0.0,
        method="inference"))
    jgen = JaxHiFiGAN(**VOC)
    vparams = jax.tree_util.tree_map(np.asarray, jax.jit(jgen.init)(
        jax.random.key(62), jnp.zeros((1, 8, 80))))
    synth = jax.jit(jgen.apply)

    def jax_chunk(chunk):
        src = {k: np.asarray(chunk[k], np.float64) for k in ("hubert",
                                                             "score", "loud")}
        t = src["hubert"].shape[0]
        return np.asarray(infer(params, *_jax_side(sc, src, ref)))[0, :t]

    def jax_vocode(mel):
        c = mel * sc["logmel"]["scale"] + sc["logmel"]["mean"]
        c = (c - vstats["mean"]) / vstats["scale"]
        return np.asarray(synth(vparams, jnp.asarray(c, jnp.float32)[None])
                          )[0, :, 0]

    conv = Converter(
        dict(CFG64, dtype="float32"), params, sc,
        vocoder_config={"sampling_rate": SR, "generator_params": VOC},
        vocoder_params=vparams, vocoder_stats=vstats,
        contentvec_config=CV, contentvec_params=contentvec["params"],
        n_timesteps=STEPS, temperature=0.0, device="cpu")
    return dict(conv=conv, ref=ref, jax_chunk=jax_chunk,
                jax_vocode=jax_vocode, jax_fn=jax_fn)


def _jax_vocode_segments(segments, vocode, ctx=32):
    """``serenade_tpu/api.py``'s ``_vocode_segments`` on JAX's HiFiGAN."""
    tail, out = None, []
    for start, seg in segments:
        k = 0 if tail is None else tail.shape[0]
        mel_in = seg if k == 0 else np.concatenate([tail, seg])
        wav = vocode(mel_in)
        out.append((start, seg, wav[k * (len(wav) // mel_in.shape[0]):]))
        tail = seg[-ctx:]
    return out


def assert_streams_agree(got, want):
    """The same starts and lengths; mel within 2e-4 and waveform within
    1e-4 (``test_convert_wav_matches_jax``'s tolerances)."""
    assert [s for s, _, _ in got] == [s for s, _, _ in want]
    for (_, mel, wav), (_, mel_j, wav_j) in zip(got, want):
        assert mel.shape == mel_j.shape and wav.shape == wav_j.shape
        np.testing.assert_allclose(mel, mel_j, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(wav, wav_j, rtol=1e-4, atol=1e-4)


def assert_contiguous(segs, n):
    starts = [s for s, _, _ in segs]
    lens = [m.shape[0] for _, m, _ in segs]
    assert starts == [0] + list(np.cumsum(lens)[:-1]) and sum(lens) == n
    for _, mel, wav in segs:
        assert np.isfinite(mel).all() and np.isfinite(wav).all()
        assert wav.shape == (mel.shape[0] * 6,)


# ---------------------------------------------------------------------------
# ops/longform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn, args", [
    ("split_chunks", (6000, 2048, 256)),
    ("split_chunks", (300, 128, 32)),
    ("split_chunks", (100, 128, 32)),
    ("split_chunks", (1000, 300, 299)),
    ("split_chunks", (1000, 300, 300)),     # overlap >= chunk: refused
    ("split_chunks_ramp", (6000, 2048, 256, 512)),
    ("split_chunks_ramp", (300, 128, 32, 64)),
    ("split_chunks_ramp", (300, 128, 32, None)),
    ("split_chunks_ramp", (300, 128, 32, 256)),
    ("split_chunks_ramp", (300, 128, 32, 32)),  # first <= overlap: refused
])
def test_span_helpers_match_jax(fn, args):
    """The span lists equal JAX's, and an argument JAX refuses raises the
    same ValueError."""
    try:
        want = getattr(jlf, fn)(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            getattr(plf, fn)(*args)
        return
    assert getattr(plf, fn)(*args) == want


@pytest.mark.parametrize("chunk, overlap", [(256, 64), (128, 127), (900, 8)])
def test_stitching_matches_jax(chunk, overlap):
    """``convert_in_chunks_stream`` and ``convert_in_chunks`` with a
    converter whose chunks disagree (an offset a call), and
    ``StreamStitcher`` fed spans one by one: bit for bit JAX's."""
    feats = {"hubert": np.random.default_rng(63).normal(
        size=(900, 4)).astype(np.float32)}

    def convert_fn():
        calls = []

        def fn(c):
            calls.append(1)
            return c["hubert"] * 3.0 + len(calls)
        return fn

    got = list(plf.convert_in_chunks_stream(feats, convert_fn(), chunk,
                                            overlap))
    want = list(jlf.convert_in_chunks_stream(feats, convert_fn(), chunk,
                                             overlap))
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        plf.convert_in_chunks(feats, convert_fn(), chunk, overlap),
        jlf.convert_in_chunks(feats, convert_fn(), chunk, overlap))
    spans = plf.split_chunks(900, chunk, overlap)
    mine, theirs = plf.StreamStitcher(), jlf.StreamStitcher()
    for i, (s, e) in enumerate(spans):
        nxt = spans[i + 1][0] if i + 1 < len(spans) else None
        mel = feats["hubert"][s:e] - i
        for (s1, a), (s2, b) in zip(mine.add((s, e), mel, nxt),
                                    theirs.add((s, e), mel, nxt)):
            assert s1 == s2
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# windowed extraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("samples", [0, 1, 239, 240, 24000, 72512, 1440512])
def test_stream_total_frames_matches_jax(samples):
    assert features.stream_total_frames(
        samples, features.FeatureConfig.from_dict(FC)) == \
        jfeat.stream_total_frames(samples, jfeat.FeatureConfig.from_dict(FC))


@pytest.mark.parametrize("where", ["first", "interior", "tail"])
def test_extract_stream_window_matches_jax(content_fns, where):
    """One span's window features, the port's against JAX's on the int16
    wire with the same ContentVec: loudness within 1e-4, F0 by
    ``assert_f0_agrees``, the score equal, ContentVec within 1e-4 of
    max(1, |JAX|); ``hubert`` stays a tensor (on the device on a card)."""
    jax_fn, port_fn = content_fns
    cfg, jcfg = (features.FeatureConfig.from_dict(FC),
                 jfeat.FeatureConfig.from_dict(FC))
    audio = jfeat._prepare_audio("s", sung(3.0, 64), SR, jcfg)
    n = jfeat.stream_total_frames(len(audio), jcfg)
    span = {"first": (0, CHUNK), "interior": (96, 224),
            "tail": (n - 100, n)}[where]
    got = features.extract_stream_window(
        audio, span, cfg, 70.0, 1100.0, content_fn=port_fn, ctx_frames=CTX,
        device="cpu")
    want = jfeat.extract_stream_window(audio, span, jcfg, 70.0, 1100.0,
                                       content_fn=jax_fn, ctx_frames=CTX)
    assert set(got) == set(want) == {"hubert", "score", "loud", "f0"}
    t = span[1] - span[0]
    for k in want:
        assert tuple(got[k].shape) == np.asarray(want[k]).shape
        assert got[k].shape[0] == t
    assert np.abs(got["loud"] - want["loud"]).max() <= 1e-4
    assert_f0_agrees(got["f0"], got["f0"] > 0, want["f0"], want["f0"] > 0)
    np.testing.assert_array_equal(got["score"], want["score"])
    h, h_j = got["hubert"].numpy(), np.asarray(want["hubert"])
    assert np.abs(h - h_j).max() <= 1e-4 * max(1.0, np.abs(h_j).max())
    # the F0 fluctuation: the spline over the window's F0, sliced to the
    # span, within 2e-3 of JAX's (their F0 tracks agree as above)
    got = features.extract_stream_window(
        audio, span, cfg, 70.0, 1100.0, content_fn=port_fn, ctx_frames=CTX,
        with_f0_fluc=True, device="cpu")
    want = jfeat.extract_stream_window(
        audio, span, jcfg, 70.0, 1100.0, content_fn=jax_fn, ctx_frames=CTX,
        with_f0_fluc=True)
    assert got["f0_fluc"].shape == np.asarray(want["f0_fluc"]).shape == (t, 1)
    assert np.abs(got["f0_fluc"] - want["f0_fluc"]).max() <= 2e-3


# ---------------------------------------------------------------------------
# the Converter's stream paths
# ---------------------------------------------------------------------------

def test_convert_features_stream_and_long_match_jax(stream_setup):
    """Features in: 300 frames at chunk 128 / overlap 32 through
    ``convert_features_stream`` against JAX's ``convert_in_chunks_stream``
    on JAX's model and vocoder; ``convert_features_long`` against JAX's
    ``convert_in_chunks`` and one vocoder pass."""
    ss = stream_setup
    rng = np.random.default_rng(65)
    src = {"hubert": rng.normal(size=(300, 64)),
           "score": rng.uniform(40, 80, size=(300, 1)),
           "loud": rng.uniform(-60, 0, size=(300, 1))}
    kw = dict(chunk_frames=CHUNK, overlap_frames=OVERLAP)
    got = list(ss["conv"].convert_features_stream(src, ss["ref"], **kw))
    want = _jax_vocode_segments(
        jlf.convert_in_chunks_stream(src, ss["jax_chunk"], **kw),
        ss["jax_vocode"])
    assert_contiguous(got, 300)
    assert_streams_agree(got, want)
    mel, wav, sr = ss["conv"].convert_features_long(src, ss["ref"], **kw)
    mel_j = jlf.convert_in_chunks(src, ss["jax_chunk"], **kw)
    assert sr == SR and mel.shape == (300, 80)
    np.testing.assert_allclose(mel, mel_j, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(wav, ss["jax_vocode"](mel_j), rtol=1e-4,
                               atol=1e-4)


def test_convert_wav_stream_matches_jax(stream_setup):
    """Raw audio in: 3 s ramping 64 -> 128 through ``convert_wav_stream``
    against JAX's ``split_chunks_ramp``, ``extract_stream_window`` (the
    same ContentVec, the int16 wire) and ``stitch_mel_stream`` on JAX's
    model and vocoder."""
    ss = stream_setup
    wav = sung(3.0, 66)
    kw = dict(chunk_frames=CHUNK, overlap_frames=OVERLAP,
              extract_ctx_frames=CTX)
    got = list(ss["conv"].convert_wav_stream(wav, SR, ss["ref"],
                                             first_chunk_frames=64, **kw))
    jcfg = jfeat.FeatureConfig.from_dict(FC)
    audio = jfeat._prepare_audio("s", wav, SR, jcfg)
    n = jfeat.stream_total_frames(len(audio), jcfg)
    spans = jlf.split_chunks_ramp(n, CHUNK, OVERLAP, 64)
    assert len(spans) == 4
    mels = (ss["jax_chunk"](jfeat.extract_stream_window(
        audio, span, jcfg, 70.0, 1100.0, content_fn=ss["jax_fn"],
        ctx_frames=CTX)) for span in spans)
    want = _jax_vocode_segments(jlf.stitch_mel_stream(spans, mels),
                                ss["jax_vocode"])
    assert_contiguous(got, n)
    assert got[0][1].shape[0] == 64 - OVERLAP   # first audio: one chunk
    assert_streams_agree(got, want)


def test_live_stream_equals_windowed_and_its_pieces(stream_setup):
    """``convert_wav_stream_live`` fed the whole waveform equals
    ``convert_wav_stream`` on a uniform schedule, and fed 20 ms pieces it
    equals being fed whole (defaults 64 / 16 / 32)."""
    ss = stream_setup
    conv, ref = ss["conv"], ss["ref"]
    wav = sung(2.5, 67)
    uniform = list(conv.convert_wav_stream(
        wav, SR, ref, chunk_frames=64, overlap_frames=16,
        first_chunk_frames=None, extract_ctx_frames=32))
    whole = list(conv.convert_wav_stream_live(iter([wav]), SR, ref))
    pieces = list(conv.convert_wav_stream_live(
        iter(np.array_split(wav, len(wav) // 480)), SR, ref))
    n = features.stream_total_frames(len(wav) + 512,
                                     features.FeatureConfig.from_dict(FC))
    assert_contiguous(whole, n)
    for a, b in ((whole, uniform), (pieces, whole)):
        assert [s for s, _, _ in a] == [s for s, _, _ in b]
        for (_, m1, w1), (_, m2, w2) in zip(a, b):
            np.testing.assert_array_equal(m1, m2)
            np.testing.assert_array_equal(w1, w2)


def test_live_stream_faults_on_a_bad_piece_at_once(stream_setup):
    """A NaN piece faults the stream when it arrives (nothing after it is
    read); a source too short to analyze and a rate other than the
    model's are refused."""
    ss = stream_setup
    conv, ref = ss["conv"], ss["ref"]
    read = []

    def source():
        for piece in (sung(0.3, 68), np.full(480, np.nan, np.float32),
                      sung(0.3, 69)):
            read.append(1)
            yield piece

    with pytest.raises(ValueError, match="non-finite"):
        list(conv.convert_wav_stream_live(source(), SR, ref))
    assert len(read) == 2
    with pytest.raises(ValueError, match="too short"):
        list(conv.convert_wav_stream_live(iter([np.zeros(100)]), SR, ref))
    with pytest.raises(ValueError, match="Hz audio"):
        list(conv.convert_wav_stream_live(iter([sung(0.5, 70)]), 16000, ref))


def test_packed_style_equals_its_raw_features(stream_setup):
    """A registered style's packed tensors condition a stream exactly as
    its feature dict does (``pack_reference``'s handle is told apart by
    its ``lengths``)."""
    ss = stream_setup
    conv, ref = ss["conv"], ss["ref"]
    b = serving.BatchingConverter(conv, max_batch=2)
    try:
        b.register_reference("S", ref)
        wav = sung(1.5, 71)
        kw = dict(chunk_frames=CHUNK, overlap_frames=OVERLAP,
                  first_chunk_frames=64, extract_ctx_frames=CTX)
        raw = list(conv.convert_wav_stream(wav, SR, ref, **kw))
        packed = list(conv.convert_wav_stream(wav, SR,
                                              b.packed_reference("S"), **kw))
    finally:
        b.close()
    assert len(raw) == len(packed) == 2
    for (s1, m1, w1), (s2, m2, w2) in zip(raw, packed):
        assert s1 == s2
        np.testing.assert_array_equal(m1, m2)
        np.testing.assert_array_equal(w1, w2)


def test_stream_at_nonzero_temperature(stream_setup):
    """At temperature 0.667 each chunk draws its own noise: the stream is
    finite and contiguous, its chunks differ from the noiseless ones, and
    ``convert_features_long`` covers the source."""
    ss = stream_setup
    conv = ss["conv"]
    rng = np.random.default_rng(72)
    src = {"hubert": rng.normal(size=(200, 64)),
           "score": rng.uniform(40, 80, size=(200, 1)),
           "loud": rng.uniform(-60, 0, size=(200, 1))}
    kw = dict(chunk_frames=CHUNK, overlap_frames=OVERLAP)
    cold = list(conv.convert_features_stream(src, ss["ref"], **kw))
    conv.temperature = 0.667
    try:
        warm = list(conv.convert_features_stream(src, ss["ref"], **kw))
        mel, wav, _ = conv.convert_features_long(src, ss["ref"], **kw)
    finally:
        conv.temperature = 0.0
    assert_contiguous(warm, 200)
    assert not np.allclose(warm[0][1], cold[0][1])
    assert mel.shape == (200, 80) and np.isfinite(mel).all()
    assert wav.shape == (1200,) and np.isfinite(wav).all()


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def test_block_wire_is_the_jax_servers():
    """``_frame_block`` byte for byte JAX's; ``iter_stream_blocks`` reads
    a stream up to its ``done`` marker, raises on ``error``, and raises on
    a cut stream, as JAX's client does."""
    seg = {"start": np.int64(96), "mel": np.ones((3, 80), np.float32),
           "wav": np.zeros(18, np.float32), "sr": np.int64(SR)}
    for arrays in (seg, {"done": np.int64(1)},
                   {"error": np.asarray("boom")}):
        assert serving._frame_block(arrays) == jserving._frame_block(arrays)
    block = serving._frame_block(seg)
    done = serving._frame_block({"done": np.int64(1)})
    err = serving._frame_block({"error": np.asarray("boom")})
    blocks = list(serving.iter_stream_blocks(io.BytesIO(block * 2 + done)))
    assert len(blocks) == 2 and int(blocks[1]["start"]) == 96
    np.testing.assert_array_equal(blocks[0]["mel"], seg["mel"])
    with pytest.raises(RuntimeError, match="server stream failed: boom"):
        list(serving.iter_stream_blocks(io.BytesIO(block + err)))
    for cut in (block, block + done[:3], block + done[:-1]):
        with pytest.raises(RuntimeError, match="truncated"):
            list(serving.iter_stream_blocks(io.BytesIO(cut)))
        with pytest.raises(RuntimeError, match="truncated"):
            list(jserving.iter_stream_blocks(io.BytesIO(cut)))
    # JAX's client reads the port's wire
    assert len(list(jserving.iter_stream_blocks(
        io.BytesIO(block + done)))) == 1


def test_stream_sources_skip_the_duration_cap(stream_setup):
    """``_validate_feats(cap_duration=False)``: a stream's source is not
    held to max_request_seconds, a queued request is, and so is an ad-hoc
    raw reference of a stream."""
    ss = stream_setup
    conv = ss["conv"]
    b = serving.BatchingConverter(conv, max_request_seconds=1.0)
    try:
        rng = np.random.default_rng(73)
        src = {"hubert": rng.normal(size=(150, 64)),
               "score": np.full((150, 1), 60.0),
               "loud": np.full((150, 1), -20.0)}
        b._validate_feats(src, "src", with_mel=False, cap_duration=False)
        with pytest.raises(ValueError, match="max_request_seconds"):
            b._validate_feats(src, "src", with_mel=False)
        body = serving.encode_request(src, ss["ref"])
        got, ref, f0_range = serving._parse_stream_body(body, {}, b)
        assert got["hubert"].shape == (150, 64) and f0_range is None
        buf = io.BytesIO()
        np.savez(buf, src_wav=sung(1.5, 74), sr=np.int64(SR),
                 ref_wav=sung(1.2, 75), ref_sr=np.int64(SR))
        with pytest.raises(ValueError, match="ref_wav is 1s, over"):
            serving._parse_stream_body(buf.getvalue(), {}, b)
        buf = io.BytesIO()
        np.savez(buf, src_wav=sung(1.5, 74), sr=np.int64(SR),
                 ref_wav=sung(0.8, 75), ref_sr=np.int64(SR))
        src, ref, _ = serving._parse_stream_body(buf.getvalue(), {}, b)
        assert isinstance(src, serving._RawSource) and len(src.wav) == 36000
        assert ref["hubert"].shape == (80, 64)
    finally:
        b.close()


def _live_post(host, port, path, pieces):
    """POST ``pieces`` as a chunked body through http.client, one chunk a
    send, as a live client uploads.  Returns the status, the response's
    blocks (or body) and the seconds to the first block."""
    chunks = [f"{len(p):X}\r\n".encode() + p + b"\r\n" for p in pieces]
    c = http.client.HTTPConnection(host, port, timeout=120)
    try:
        c.putrequest("POST", path)
        c.putheader("Transfer-Encoding", "chunked")
        c.endheaders()
        for chunk in chunks + [b"0\r\n\r\n"]:
            c.send(chunk)
        t0 = time.perf_counter()
        r = c.getresponse()
        if r.status != 200:
            return r.status, r.read(), None
        blocks = list(serving.iter_stream_blocks(r))
        return 200, blocks, time.perf_counter() - t0
    finally:
        c.close()


def test_stream_endpoints_over_http(stream_setup):
    """Both endpoints on port 0: ``/convert_stream`` with a feature npz
    (a registered style), a RIFF body with ``?style=`` (windowed) and an
    npz with its own raw reference (``?windowed=0``);
    ``/convert_stream_live`` with a chunked PCM16 upload.  Every stream
    ends with its ``done`` marker and covers its source; a body without a
    style and an unknown style are answered 400."""
    from serenade_tpu_torch.utils.audio import write_wav

    ss = stream_setup
    conv = ss["conv"]
    b = serving.BatchingConverter(conv, max_batch=2)
    server = serving.make_server(b, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"

    def post(path, body):
        req = urllib.request.Request(base + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return list(serving.iter_stream_blocks(r))

    def covers(blocks, seconds):
        n = features.stream_total_frames(
            int(round(seconds * SR)) + 512,
            features.FeatureConfig.from_dict(FC))
        assert [int(x["start"]) for x in blocks] == [0] + list(np.cumsum(
            [x["mel"].shape[0] for x in blocks])[:-1])
        assert sum(x["mel"].shape[0] for x in blocks) == n
        for x in blocks:
            assert x["wav"].shape == (x["mel"].shape[0] * 6,)
            assert int(x["sr"]) == SR and np.isfinite(x["wav"]).all()

    try:
        b.register_reference("S", ss["ref"])
        rng = np.random.default_rng(76)
        src = {"hubert": rng.normal(size=(200, 64)),
               "score": rng.uniform(40, 80, size=(200, 1)),
               "loud": rng.uniform(-60, 0, size=(200, 1))}
        blocks = post("/convert_stream?chunk_frames=128&overlap_frames=32",
                      serving.encode_request(src, "S"))
        assert sum(x["mel"].shape[0] for x in blocks) == 200
        assert len(blocks) == 2 and int(blocks[1]["start"]) == 96
        want = list(conv.convert_features_stream(src, ss["ref"], 128, 32))
        for x, (_, mel, wav) in zip(blocks, want):
            np.testing.assert_array_equal(x["mel"], mel)
        riff = io.BytesIO()
        write_wav(riff, sung(1.2, 77), SR)
        covers(post("/convert_stream?style=S&chunk_frames=128&overlap_frames"
                    "=32&first_chunk_frames=64&extract_ctx_frames=32",
                    riff.getvalue()), 1.2)
        buf = io.BytesIO()
        np.savez(buf, src_wav=sung(1.0, 78), sr=np.int64(SR),
                 ref_wav=sung(0.6, 79), ref_sr=np.int64(SR))
        covers(post("/convert_stream?windowed=0", buf.getvalue()), 1.0)
        pcm = (np.clip(sung(1.0, 80), -1, 1) * 32767).astype("<i2").tobytes()
        status, blocks, first_s = _live_post(
            host, port, "/convert_stream_live?style=S",
            [pcm[i:i + 961] for i in range(0, len(pcm), 961)])
        assert status == 200 and first_s is not None
        covers(blocks, 1.0)
        for path, body in (("/convert_stream", riff.getvalue()),
                           ("/convert_stream?style=nope", riff.getvalue())):
            with pytest.raises(urllib.error.HTTPError) as exc:
                post(path, body)
            assert exc.value.code == 400
        status, body, _ = _live_post(
            host, port, "/convert_stream_live",
            [pcm[i:i + 961] for i in range(0, len(pcm), 961)])
        assert status == 400 and b"needs ?style=" in body
    finally:
        server.shutdown()
        server.server_close()
        b.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_refused_live_upload_is_answered(stream_setup):
    """A live upload the server refuses before reading it (no
    ``?style=``), sent piece by piece as a live client sends it, 100
    times: every try gets its 400.  The server reads the upload off before
    it closes; closed with the client's data unread, the connection is
    reset, and a client still sending loses the answer."""
    b = serving.BatchingConverter(stream_setup["conv"])
    server = serving.make_server(b, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    pcm = (np.clip(sung(1.0, 81), -1, 1) * 32767).astype("<i2").tobytes()
    pieces = [pcm[i:i + 961] for i in range(0, len(pcm), 961)]
    lost = []
    try:
        for _ in range(100):
            try:
                status, body, _ = _live_post(
                    host, port, "/convert_stream_live", pieces)
                if status != 400 or b"needs ?style=" not in body:
                    lost.append(status)
            except (OSError, http.client.HTTPException) as e:
                lost.append(type(e).__name__)
    finally:
        server.shutdown()
        server.server_close()
        b.close()
    thread.join(timeout=10)
    assert not lost, (f"{len(lost)} of 100 refused uploads lost their "
                      f"400: {lost[:5]}")
