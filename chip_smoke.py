#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``serenade_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build    -- compile the CUDA kernels from ``serenade_tpu_torch/csrc``;
2. kernels  -- each kernel against its plain PyTorch version on the card,
               at one small f32 shape and at the conversion path's shapes,
               with times, the roofline bound and a PyTorch yardstick;
3. main     -- a full-width Converter (seeded random weights) answers four
               requests through Euler-10 and the HiFiGAN vocoder; the
               launch counters must show every kernel ran; then one more
               (1024, 512) request under torch.profiler gives the device's
               busy time and the kernels that took it;
4. parity   -- one small f32 conversion on the CPU (plain versions) and on
               the card (kernels) with the same weights and noise.

Then the card's name and power limit, one line listing the kernels, and
``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero, with
no result, when CUDA is absent, the package is missing, or any phase fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

PEAK_BF16 = 989e12     # H100 SXM dense tensor-core FLOP/s
PEAK_F32 = 67e12       # H100 SXM FP32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
SR, HOP = 24000, 240


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(torch, got, ref) -> tuple:
    """(max |got - ref|, that over max(1, max |ref|))."""
    diff = (got.float() - ref.float()).abs().max().item()
    return diff, diff / max(1.0, ref.float().abs().max().item())


def bound_ms(flops: float, nbytes: float, bf16: bool) -> tuple:
    t_ops = flops / (PEAK_BF16 if bf16 else PEAK_F32)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(torch, dev):
    import torch.nn.functional as F

    from serenade_tpu_torch.ops import flash_cuda as K

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []

    def case(b, h, t, d, dtype, valid, tol, timed):
        q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        mask = (torch.arange(t, device=dev)[None, :]
                < torch.tensor(valid, device=dev)[:, None]).float()
        scale = d ** -0.5
        out, lse = K.flash_attention(q, k, v, mask, scale, return_lse=True)
        ref, ref_lse = K.flash_attention_plain(q, k, v, mask, scale)
        torch.cuda.synchronize()
        err, rel = rel_err(torch, out, ref)
        lse_err, lse_rel = rel_err(torch, lse, ref_lse)
        ok = rel <= tol and lse_rel <= tol
        row = {"shape": [b, h, t, d], "dtype": str(dtype)[6:],
               "max_abs_err": err, "lse_max_abs_err": lse_err, "tol": tol,
               "ok": ok}
        if timed:
            nbytes = (4 * b * h * t * d * q.element_size() + 4 * b * h * t
                      + 4 * b * t)
            row["bound_ms"], row["bound_by"] = bound_ms(
                4.0 * b * h * t * t * d, nbytes, dtype == torch.bfloat16)
            row["ms"] = cuda_ms(torch, lambda: K.flash_attention(
                q, k, v, mask, scale), 20)
            row["plain_ms"] = cuda_ms(torch, lambda: K.flash_attention_plain(
                q, k, v, mask, scale), 20)
            bmask = mask.bool()[:, None, None, :]
            row["library_ms"] = cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bmask, scale=scale), 20)
        rows.append(row)
        return row

    case(2, 2, 75, 32, torch.float32, [75, 40], 1e-4, False)
    main = case(1, 4, 1536, 512, torch.bfloat16, [1536], 2e-2, True)
    case(1, 4, 768, 512, torch.bfloat16, [768], 2e-2, True)
    case(2, 4, 200, 512, torch.bfloat16, [200, 131], 2e-2, False)
    return main, rows


def check_block1d(torch, dev):
    from serenade_tpu_torch.ops import block1d_cuda as K

    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []

    def case(b, t, cin, cout, dtype, lengths, tol, timed):
        x = torch.randn((b, t, cin), generator=gen, device=dev).to(dtype)
        w = (torch.randn((cout, cin, 3), generator=gen, device=dev)
             / math.sqrt(3 * cin)).to(dtype)
        bias, gamma, beta = (0.1 * torch.randn((cout,), generator=gen,
                                               device=dev) for _ in range(3))
        gamma = gamma + 1.0
        mask = (torch.arange(t, device=dev)[None, :]
                < torch.tensor(lengths, device=dev)[:, None]).float()[..., None]
        out = K.block1d(x, mask, w, bias, gamma, beta)
        ref = K.block1d_plain(x, mask, w, bias, gamma, beta)
        torch.cuda.synchronize()
        err, rel = rel_err(torch, out, ref)
        row = {"shape": [b, t, cin, cout], "dtype": str(dtype)[6:],
               "max_abs_err": err, "tol": tol, "ok": rel <= tol}
        if timed:
            es = x.element_size()
            nbytes = es * (b * t * (cin + cout) + 3 * cin * cout) + 12 * cout
            row["bound_ms"], row["bound_by"] = bound_ms(
                2.0 * b * t * 3 * cin * cout, nbytes, dtype == torch.bfloat16)
            row["ms"] = cuda_ms(torch, lambda: K.block1d(
                x, mask, w, bias, gamma, beta), 20)
            row["plain_ms"] = cuda_ms(torch, lambda: K.block1d_plain(
                x, mask, w, bias, gamma, beta), 20)
            row["library_ms"] = None
        rows.append(row)
        return row

    case(2, 70, 20, 64, torch.float32, [70, 33], 1e-4, False)
    main = case(1, 1536, 1024, 512, torch.bfloat16, [1536], 2e-2, True)
    for t, cin in ((1536, 242), (1536, 512), (768, 512), (768, 1024)):
        case(1, t, cin, 512, torch.bfloat16, [t - 5], 2e-2, True)
    return main, rows


def check_resblock(torch, dev):
    from serenade_tpu_torch.ops import resblock_cuda as K

    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    dils = (1, 3, 5)

    def case(b, t, c, k, dtype, tol, timed):
        x = torch.randn((b, t, c), generator=gen, device=dev).to(dtype)
        ws = [(torch.randn((3, c, c, k), generator=gen, device=dev)
               / math.sqrt(k * c)).to(dtype) for _ in range(2)]
        bs = [0.1 * torch.randn((3, c), generator=gen, device=dev)
              for _ in range(2)]
        args = (x, ws[0], bs[0], ws[1], bs[1])
        out = K.resblock_branch(*args, kernel_size=k, dilations=dils)
        ref = K.resblock_branch_plain(
            x, ws[0], bs[0].to(dtype), ws[1], bs[1].to(dtype),
            kernel_size=k, dilations=dils)
        torch.cuda.synchronize()
        err, rel = rel_err(torch, out, ref)
        row = {"shape": [b, t, c, k], "dtype": str(dtype)[6:],
               "max_abs_err": err, "tol": tol, "ok": rel <= tol}
        if timed:
            es = x.element_size()
            nbytes = es * (2 * b * t * c + 2 * 3 * k * c * c) + 24 * c
            row["bound_ms"], row["bound_by"] = bound_ms(
                3 * 2 * 2.0 * b * t * k * c * c, nbytes,
                dtype == torch.bfloat16)
            row["ms"] = cuda_ms(torch, lambda: K.resblock_branch(
                *args, kernel_size=k, dilations=dils), 5)
            row["plain_ms"] = cuda_ms(torch, lambda: K.resblock_branch_plain(
                x, ws[0], bs[0].to(dtype), ws[1], bs[1].to(dtype),
                kernel_size=k, dilations=dils), 5)
            row["library_ms"] = None
        rows.append(row)
        return row

    case(1, 300, 32, 3, torch.float32, 1e-4, False)
    case(2, 150, 128, 11, torch.float32, 1e-4, False)
    main = case(1, 8192, 256, 11, torch.float32, 1e-4, True)
    for t, c in ((8192, 256), (49152, 128), (245760, 64)):
        for k in (3, 7, 11):
            if (t, c, k) != (8192, 256, 11):
                case(1, t, c, k, torch.float32, 1e-4, True)
    case(1, 8192, 256, 11, torch.bfloat16, 3e-2, True)
    return main, rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the conversion path
# ---------------------------------------------------------------------------


def _features(np, rng, frames, with_mel, input_dim=768, mels=80):
    feats = {"hubert": rng.normal(size=(frames, input_dim)),
             "score": rng.random(frames), "loud": rng.random(frames)}
    if with_mel:
        feats["logmel"] = rng.normal(size=(frames, mels))
    return feats


def _scaler(np, input_dim=768, mels=80):
    return {"hubert": {"mean": np.zeros(input_dim),
                       "scale": np.ones(input_dim)},
            "score": {"min": 0.0, "max": 1.0},
            "loud": {"min": 0.0, "max": 1.0},
            "logmel": {"mean": np.zeros(mels), "scale": np.ones(mels)}}


def main_path(torch, np, dev, counters):
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.configs import VOCODER_CONFIG, serenade_config

    t0 = time.time()
    conv = Converter(serenade_config(), None, _scaler(np),
                     vocoder_config=VOCODER_CONFIG,
                     vocoder_stats={"mean": np.zeros(80), "scale": np.ones(80)},
                     n_timesteps=10, solver="euler", seed=0, device=dev)
    setup_s = time.time() - t0
    rng = np.random.default_rng(0)
    requests = [(1024, 512), (700, 300), (450, 512), (1200, 200)]
    feats = [(_features(np, rng, s, False), _features(np, rng, r, True))
             for s, r in requests]
    conv.convert_features(*feats[0])          # warm-up (cuDNN plans, build)
    torch.cuda.synchronize()

    for mod in counters.values():
        mod.launches = 0
    results = []
    for (s, r), (src, ref) in zip(requests, feats):
        start = time.time()
        mel, wav, sr = conv.convert_features(src, ref)
        torch.cuda.synchronize()
        wall = time.time() - start
        ok = (mel.shape == (s, 80) and wav.shape == (s * HOP,)
              and bool(np.isfinite(mel).all()) and bool(np.isfinite(wav).all()))
        results.append({"src_frames": s, "ref_frames": r, "wall_s": wall,
                        "rtf": wall / (s * HOP / SR), "ok": ok})
    launches = {name: mod.launches for name, mod in counters.items()}
    n = len(requests)
    want = {"flash_fwd": 60 * n, "block1d_fwd": 130 * n}
    counts_ok = (all(launches[k] == v for k, v in want.items())
                 and launches["resblock_branch"] >= 9 * n)
    emit({"phase": "main", "setup_s": setup_s, "requests": results,
          "launches": launches, "launches_expected": dict(
              want, resblock_branch=f">= {9 * n}"),
          "ok": counts_ok and all(r["ok"] for r in results)})
    prof = device_time(torch, lambda: (conv.convert_features(*feats[0]),
                                       torch.cuda.synchronize()))
    # idle share against the unprofiled wall time of the same request
    prof["device_idle_share"] = 1.0 - prof["device_busy_s"] / results[0][
        "wall_s"]
    emit(dict(phase="profile", request=list(requests[0]), **prof))
    return counts_ok and all(r["ok"] for r in results), launches


def device_time(torch, fn) -> dict:
    """One run of ``fn`` under torch.profiler: the device's busy time (the
    sum of its kernel and copy times; one stream, so they do not overlap)
    and the kernels that took the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    return {"device_busy_s": sum(us for us, _, _ in rows) / 1e6,
            "device_launches": sum(count for _, _, count in rows),
            "top": [{"kernel": key[:60], "ms": us / 1e3, "count": count}
                    for us, key, count in rows[:10]]}


def slice_parity(torch, np, dev):
    from serenade_tpu_torch.api import Converter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(input_dim=32, output_dim=80, encoder_channels=16,
               encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
               decoder_attention_head_dim=32, gst_tokens=10,
               gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16,
               dtype="float32")
    voc = {"sampling_rate": SR, "generator_params": {
        "channels": 64, "upsample_scales": [4, 3],
        "upsample_kernel_sizes": [8, 6]}}
    rng = np.random.default_rng(4)
    src = _features(np, rng, 150, False, input_dim=32)
    ref = _features(np, rng, 100, True, input_dim=32)
    x0 = 0.667 * rng.normal(size=(1, 128 + 192, 80))
    mels, wavs = [], []
    for device in ("cpu", dev):
        conv = Converter(cfg, None, _scaler(np, input_dim=32),
                         vocoder_config=voc,
                         vocoder_stats={"mean": np.zeros(80),
                                        "scale": np.ones(80)},
                         n_timesteps=4, seed=5, device=device)
        mel, wav, _ = conv.convert_features(src, ref, x0=x0)
        mels.append(mel)
        wavs.append(wav)
    tol = 1e-3
    mel_err = float(np.abs(mels[0] - mels[1]).max())
    wav_err = float(np.abs(wavs[0] - wavs[1]).max())
    scale = max(1.0, float(np.abs(mels[0]).max()))
    ok = mel_err / scale <= tol and wav_err <= tol
    emit({"phase": "parity", "mel_max_abs_err": mel_err,
          "wav_max_abs_err": wav_err, "mel_scale": scale, "tol": tol,
          "ok": ok})
    return ok


# ---------------------------------------------------------------------------


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from serenade_tpu_torch.ops import (
            _cuda, block1d_cuda, flash_cuda, resblock_cuda,
        )
    except ImportError as exc:
        print(f"chip_smoke: the serenade_tpu_torch package is missing: {exc}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    # f32 stays f32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    logs = _cuda.build_all()
    ptxas = [line.strip() for log in logs.values()
             for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.time() - t0, "ptxas": ptxas})

    ok = True
    entries = []
    sources = {
        "flash_fwd": ("serenade_tpu_torch/csrc/flash_fwd.cu",
                      "serenade_tpu/ops/flash_pallas.py:106", check_flash),
        "block1d_fwd": ("serenade_tpu_torch/csrc/block1d_fwd.cu",
                        "serenade_tpu/ops/block1d_pallas.py:255",
                        check_block1d),
        "resblock_branch": ("serenade_tpu_torch/csrc/resblock_branch.cu",
                            "serenade_tpu/ops/resblock_pallas.py:154",
                            check_resblock),
    }
    for name, (src, replaces, check) in sources.items():
        main_row, rows = check(torch, dev)
        emit({"phase": "kernels", "kernel": name, "cases": rows})
        ok &= all(r["ok"] for r in rows)
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None,
            "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": main_row["shape"], "dtype": main_row["dtype"]})

    counters = {"flash_fwd": flash_cuda, "block1d_fwd": block1d_cuda,
                "resblock_branch": resblock_cuda}
    main_ok, launches = main_path(torch, np, dev, counters)
    ok &= main_ok
    for e in entries:
        e["launches"] = launches[e["name"]]
    ok &= slice_parity(torch, np, dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
