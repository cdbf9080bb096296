#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``serenade_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. build    -- compile the CUDA kernels from ``serenade_tpu_torch/csrc``;
2. kernels  -- each kernel (forward K1-K3, backward K4-K7) against its
               plain PyTorch version on the card, at small f32 shapes and
               at the conversion and training paths' shapes, with times,
               the roofline bound and a PyTorch yardstick;
3. main     -- a full-width Converter (seeded random weights) answers four
               requests through Euler-10 and the HiFiGAN vocoder; the
               launch counters must show every forward kernel ran; then one
               more (1024, 512) request under torch.profiler gives the
               device's busy time and the kernels that took it;
4. parity   -- one small f32 conversion on the CPU (plain versions) and on
               the card (kernels) with the same weights and noise;
5. train    -- a full-width Serenade and the recipe's optimizer take 2
               warm-up and 5 timed steps at B 16 x T 512; losses finite,
               every parameter with a nonzero gradient and changed, the
               launch counters at 6 (K1, K4, K5) and 13 (K2, K6, K7) a
               step; then one step under torch.profiler;
6. train_parity -- one small f32 train step on the CPU and on the card
               from the same weights, batch and draws.

Then the card's name and power limit, one line listing the kernels, and
``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero, with
no result, when CUDA is absent, the package is missing, or any phase
fails.
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
            row["ms"] = cuda_ms(torch, lambda: K._flash_cuda(
                q, k, v, mask, scale), 20)
            row["plain_ms"] = cuda_ms(torch, lambda: K.flash_attention_plain(
                q, k, v, mask, scale), 20)
            bmask = mask.bool()[:, None, None, :]
            row["library_ms"] = cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bmask, scale=scale), 20)
            row["plain_scope"], row["library_scope"] = ["out", "lse"], ["out"]
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
            args = K.prepare_forward(x, mask, w, bias, gamma, beta)
            row["ms"] = cuda_ms(torch, lambda: K._block1d_cuda(
                *args, 8, 1e-5), 20)
            row["plain_ms"] = cuda_ms(torch, lambda: K.block1d_plain(
                x, mask, w, bias, gamma, beta), 20)
            row["library_ms"] = None
            row["plain_scope"], row["library_scope"] = ["out"], None
        rows.append(row)
        return row

    case(2, 70, 20, 64, torch.float32, [70, 33], 1e-4, False)
    main = case(1, 1536, 1024, 512, torch.bfloat16, [1536], 2e-2, True)
    for t, cin in ((1536, 242), (1536, 512), (768, 512), (768, 1024)):
        case(1, t, cin, 512, torch.bfloat16, [t - 5], 2e-2, True)
    return main, rows


def _heads(torch, gen, dev, b, h, t, d, dtype):
    """A (B, H, T, D) view of a (B, T, H, D) buffer, as the attention's
    head split makes them."""
    return (torch.randn((b, t, h, d), generator=gen, device=dev)
            .to(dtype).transpose(1, 2))


def sdpa_backward_ms(torch, q, k, v, bmask, scale):
    """(ms, backend): the backward of one scaled_dot_product_attention call
    (forward + backward minus forward) and the backend PyTorch picks for
    it, or (None, reason) if no backend takes the shape."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    qq, kk, vv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    try:
        choice = torch._fused_sdp_choice(qq, kk, vv, bmask, 0.0, False,
                                         scale=scale)
        names = {int(m.value): n for n, m in SDPBackend.__members__.items()}
        backend = names.get(int(choice), str(choice))
        out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=bmask,
                                             scale=scale)
        grad = torch.randn_like(out)

        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qq, kk, vv, attn_mask=bmask,
                                               scale=scale)

        def fwd_bwd():
            o = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=bmask,
                                               scale=scale)
            torch.autograd.grad(o, (qq, kk, vv), grad)

        return cuda_ms(torch, fwd_bwd, 10) - cuda_ms(torch, fwd, 10), backend
    except RuntimeError as exc:
        return None, f"none: {str(exc)[:80]}"


def check_flash_bwd(torch, dev):
    """K4 and K5 against flash_attention_backward_plain on the same q, k,
    v, dO and K1's O and L."""
    from serenade_tpu_torch.ops import flash_cuda as K

    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []

    def case(b, h, t, d, dtype, valid, tol, timed):
        q, k, v, g = (_heads(torch, gen, dev, b, h, t, d, dtype)
                      for _ in range(4))
        mask = (torch.arange(t, device=dev)[None, :]
                < torch.tensor(valid, device=dev)[:, None]).float()
        scale = d ** -0.5
        out, lse = K._flash_cuda(q, k, v, mask, scale)
        g, dsum = K.flash_bwd_prepare(out, g, dtype)
        dq = K.flash_bwd_dq(q, k, v, mask, g, lse, dsum, scale)
        dk, dv = K.flash_bwd_dkv(q, k, v, mask, g, lse, dsum, scale)
        refs = K.flash_attention_backward_plain(q, k, v, mask, out, lse, g,
                                                scale)
        torch.cuda.synchronize()
        errs = {n: rel_err(torch, got, ref) for n, got, ref in
                zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
        row = {"shape": [b, h, t, d], "dtype": str(dtype)[6:],
               "max_abs_err": {n: e[0] for n, e in errs.items()},
               "tol": tol, "ok": all(e[1] <= tol for e in errs.values())}
        if timed:
            es = q.element_size()
            bhtd, bht = b * h * t * d, b * h * t
            # inputs q, k, v, dO, L, D and the key mask read once; K4 writes
            # dQ, K5 dK and dV
            nbytes_in = 4 * bhtd * es + 8 * bht + 4 * b * t
            bf16 = dtype == torch.bfloat16
            row["dq"] = dict(zip(("bound_ms", "bound_by"), bound_ms(
                6.0 * bhtd * t, nbytes_in + bhtd * es, bf16)))
            row["dkv"] = dict(zip(("bound_ms", "bound_by"), bound_ms(
                8.0 * bhtd * t, nbytes_in + 2 * bhtd * es, bf16)))
            row["dq"]["ms"] = cuda_ms(torch, lambda: K.flash_bwd_dq(
                q, k, v, mask, g, lse, dsum, scale), 10)
            row["dkv"]["ms"] = cuda_ms(torch, lambda: K.flash_bwd_dkv(
                q, k, v, mask, g, lse, dsum, scale), 10)
            # the plain version and SDPA's backward compute dq, dk and dv
            # together: each stands beside K4 and K5 with that scope
            row["plain_ms"] = cuda_ms(
                torch, lambda: K.flash_attention_backward_plain(
                    q, k, v, mask, out, lse, g, scale), 5)
            row["plain_scope"] = row["library_scope"] = ["dq", "dk", "dv"]
            row["library_ms"], row["library_backend"] = sdpa_backward_ms(
                torch, q, k, v, mask.bool()[:, None, None, :], scale)
        rows.append(row)
        return row

    case(2, 2, 75, 32, torch.float32, [75, 40], 1e-4, False)
    case(2, 2, 130, 128, torch.float32, [130, 77], 1e-4, False)
    case(2, 4, 200, 512, torch.bfloat16, [200, 131], 2e-2, False)
    main = case(16, 4, 512, 512, torch.bfloat16, [512] + [475] * 15, 2e-2,
                True)
    case(16, 4, 256, 512, torch.bfloat16, [256] + [219] * 15, 2e-2, True)
    return main, rows


def check_block1d_bwd(torch, dev):
    """K6 and K7 against block1d_backward_plain on the same x, weights,
    output cotangent and K2's y and statistics.  K7's yardstick is cuDNN's
    conv1d weight gradient on the same x·mask and dy."""
    from torch.nn.grad import conv1d_weight

    from serenade_tpu_torch.ops import block1d_cuda as K

    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []

    def case(b, t, cin, cout, dtype, lengths, tol, timed):
        x = torch.randn((b, t, cin), generator=gen, device=dev).to(dtype)
        w = (torch.randn((cout, cin, 3), generator=gen, device=dev)
             / math.sqrt(3 * cin)).to(dtype)
        bias, gamma, beta = (0.1 * torch.randn((cout,), generator=gen,
                                               device=dev) for _ in range(3))
        gamma = gamma + 1.0
        g = torch.randn((b, t, cout), generator=gen, device=dev).to(dtype)
        mask = (torch.arange(t, device=dev)[None, :]
                < torch.tensor(lengths, device=dev)[:, None]).float()[..., None]
        _, lens, _, bias_c, _, _ = K.prepare_forward(x, mask, w, bias, gamma,
                                                      beta)
        _, y, stats = K._block1d_cuda(x, lens, w, bias_c, gamma, beta, 8,
                                      1e-5)
        dx, dy, (dgam, dbet, db) = K.block1d_bwd_data(
            x, lens, w, gamma, beta, y, stats, g)
        dw = K.block1d_bwd_weight(x, lens, dy)
        refs = K.block1d_backward_plain(x, mask, w, bias, gamma, beta, g)
        torch.cuda.synchronize()
        names = ("dx", "dw", "dbias", "dgamma", "dbeta")
        errs = {n: rel_err(torch, got, ref) for n, got, ref in
                zip(names, (dx, dw, db, dgam, dbet), refs)}
        row = {"shape": [b, t, cin, cout], "dtype": str(dtype)[6:],
               "max_abs_err": {n: e[0] for n, e in errs.items()},
               "tol": tol, "ok": all(e[1] <= tol for e in errs.values())}
        if timed:
            es = x.element_size()
            btc_in, btc_out = b * t * cin, b * t * cout
            bf16 = dtype == torch.bfloat16
            # K6 reads y (f32), g, the weight, the statistics and the
            # affine, writes dy, dx and three (Cout,) sums; K7 reads x and
            # dy and writes dW (f32)
            row["data"] = dict(zip(("bound_ms", "bound_by"), bound_ms(
                2.0 * btc_out * 3 * cin,
                4 * btc_out + es * (2 * btc_out + btc_in + 3 * cin * cout)
                + 16 * b * 8 + 20 * cout, bf16)))
            row["weight"] = dict(zip(("bound_ms", "bound_by"), bound_ms(
                2.0 * btc_out * 3 * cin,
                es * (btc_in + btc_out) + 12 * cin * cout, bf16)))
            row["data"]["ms"] = cuda_ms(torch, lambda: K.block1d_bwd_data(
                x, lens, w, gamma, beta, y, stats, g), 10)
            row["weight"]["ms"] = cuda_ms(
                torch, lambda: K.block1d_bwd_weight(x, lens, dy), 10)
            # the plain version computes all five gradients together, its
            # weight part dW alone; no single call computes K6's outputs
            row["data"]["plain_ms"] = cuda_ms(
                torch, lambda: K.block1d_backward_plain(
                    x, mask, w, bias, gamma, beta, g), 5)
            row["data"]["plain_scope"] = list(names)
            row["data"]["library_ms"] = None
            row["weight"]["plain_ms"] = cuda_ms(
                torch, lambda: K.block1d_weight_grad_plain(x, mask, dy), 5)
            row["weight"]["plain_scope"] = ["dw"]
            # cuDNN's weight gradient of conv1d (k 3, padding 1) on the same
            # x·mask and dy, both (B, C, T) as cuDNN takes them
            xm_bct = (x * mask).to(dtype).transpose(1, 2).contiguous()
            dy_bct = dy.transpose(1, 2).contiguous()
            lib = conv1d_weight(xm_bct, (cout, cin, 3), dy_bct, padding=1)
            torch.cuda.synchronize()
            row["weight"]["library_max_abs_err"], lib_rel = rel_err(
                torch, lib, refs[1])
            row["ok"] &= lib_rel <= tol
            row["weight"]["library_ms"] = cuda_ms(
                torch, lambda: conv1d_weight(xm_bct, (cout, cin, 3), dy_bct,
                                             padding=1), 10)
            row["weight"]["library_scope"] = ["dw"]
        rows.append(row)
        return row

    case(2, 70, 20, 64, torch.float32, [70, 33], 1e-4, False)
    case(3, 130, 96, 128, torch.float32, [130, 100, 1], 1e-4, False)
    case(2, 150, 242, 512, torch.bfloat16, [150, 77], 2e-2, False)
    main = case(16, 512, 1024, 512, torch.bfloat16, [512] + [475] * 15,
                2e-2, True)
    for t, cin in ((512, 242), (256, 512), (256, 1024)):
        case(16, t, cin, 512, torch.bfloat16,
             [t] + [t - (37 if t == 512 else 18)] * 15, 2e-2, True)
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
            row["plain_scope"], row["library_scope"] = ["out"], None
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

    counters.reset()
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
    launches = counters.read()
    n = len(requests)
    want = {"flash_fwd": 60 * n, "block1d_fwd": 130 * n, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "block1d_bwd_data": 0,
            "block1d_bwd_weight": 0}
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


# ---------------------------------------------------------------------------
# phases 5 and 6: the training step
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_T = 16, 512
TRAIN_LENGTHS = [512] + [475] * 15
# per train step: 6 transformer blocks and 13 Block1Ds, forward and backward
TRAIN_LAUNCHES = {"flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
                  "block1d_fwd": 13, "block1d_bwd_data": 13,
                  "block1d_bwd_weight": 13, "resblock_branch": 0}


def _train_batch(torch, dev, b, t, lengths, input_dim, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"x": torch.randn((b, t, input_dim), generator=g, device=dev),
            "lengths": torch.tensor(lengths, device=dev),
            "logmel": torch.randn((b, t, 80), generator=g, device=dev),
            "midi": torch.rand((b, t, 1), generator=g, device=dev),
            "loud": torch.rand((b, t, 1), generator=g, device=dev)}


def train_path(torch, np, dev, counters):
    """A full-width Serenade (bf16 compute, f32 master weights, seeded
    random weights) and the recipe's optimizer take 2 warm-up and 5 timed
    steps on a B 16 x T 512 batch; then one more step under
    torch.profiler."""
    from serenade_tpu_torch.configs import TRAIN_CONFIG, serenade_config
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.models.serenade import Serenade
    from serenade_tpu_torch.trainers import (
        build_optimizer, build_train_step, create_train_state,
    )

    t0 = time.time()
    cfg = serenade_config()
    b, t, lengths, steps = TRAIN_B, TRAIN_T, TRAIN_LENGTHS, 5
    model = init_params_(Serenade(**cfg), seed=0).to(dev)
    opt, _ = build_optimizer(TRAIN_CONFIG)
    state = create_train_state(model, opt)
    step = build_train_step(model, opt, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = _train_batch(torch, dev, b, t, lengths, cfg["input_dim"], 1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for _ in range(2):
        state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    # the repair of PR 1's dropped gradients: every parameter gets one
    no_grad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(p.grad.abs().amax() > 0)]

    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    records, walls = [], []
    for _ in range(steps):
        start = time.time()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.time() - start)
        records.append({k: float(v) for k, v in metrics.items()})
    launches = counters.read()
    peak = torch.cuda.max_memory_allocated()
    unchanged = [n for n, p in model.named_parameters()
                 if torch.equal(p.detach(), before[n])]
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    finite = all(math.isfinite(v) for r in records for v in r.values())
    ok = (finite and not no_grad and not unchanged and launches == want)
    step_s = sum(walls) / len(walls)
    emit({"phase": "train", "batch": [b, t], "lengths": lengths,
          "params": sum(p.numel() for p in model.parameters()),
          "setup_s": setup_s, "steps": records, "step_s": walls,
          "mean_step_s": step_s, "steps_per_s": 1.0 / step_s,
          "frames_per_s": sum(lengths) / step_s,
          "peak_memory_gb": peak / 1e9, "params_without_grad": no_grad,
          "params_unchanged": unchanged, "launches": launches,
          "launches_expected": want, "ok": ok})
    prof = device_time(torch, lambda: (step(state, batch, gen),
                                       torch.cuda.synchronize()))
    prof["device_idle_share"] = 1.0 - prof["device_busy_s"] / step_s
    emit(dict(phase="train_profile", **prof))
    return ok, launches


def train_parity(torch, np, dev):
    """One small f32 train step on the CPU (plain versions) and on the card
    (kernels) from the same weights, batch and draws, dropout 0."""
    from serenade_tpu_torch.configs import TRAIN_CONFIG
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.models.serenade import Serenade
    from serenade_tpu_torch.trainers import (
        build_optimizer, build_train_step, create_train_state,
    )

    cfg = dict(input_dim=32, output_dim=80, encoder_channels=80,
               encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
               decoder_attention_head_dim=32, gst_tokens=10,
               gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16, dropout=0.0,
               dtype="float32")
    # eps 1e-3: with 1e-8 a gradient whose sign is only rounding becomes a
    # step of the full learning rate on one side
    config = dict(TRAIN_CONFIG, optimizer_params=dict(
        TRAIN_CONFIG["optimizer_params"], eps=1e-3))
    rng = np.random.default_rng(6)
    b, t = 2, 64
    batch = {"x": rng.normal(size=(b, t, 32)), "lengths": np.array([64, 45]),
             "logmel": rng.normal(size=(b, t, 80)),
             "midi": rng.uniform(size=(b, t, 1)),
             "loud": rng.uniform(size=(b, t, 1))}
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v
             for k, v in batch.items()}
    draws = {"frac": 0.3, "start": 0.4, "t": np.array([0.2, 0.7]),
             "z": rng.normal(size=(b, t, 80))}
    out = []
    for device in ("cpu", dev):
        model = init_params_(Serenade(**cfg), seed=3).to(device)
        opt, _ = build_optimizer(config)
        state = create_train_state(model, opt)
        step = build_train_step(model, opt, device=device)
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
             for k, v in draws.items()}
        _, metrics = step(state, batch, None, draws=d)
        out.append(({k: float(v) for k, v in metrics.items()},
                    {n: p.detach().cpu()
                     for n, p in model.named_parameters()}))
    (m_cpu, p_cpu), (m_dev, p_dev) = out
    metric_err = max(abs(m_cpu[k] - m_dev[k]) / max(1.0, abs(m_cpu[k]))
                     for k in m_cpu)
    param_err = max(float((p_cpu[n] - p_dev[n]).abs().max()) for n in p_cpu)
    # metrics: f32 summation order; parameters: one update of lr 8e-4 whose
    # bf16 first moment may round the other way (2^-8 of 8e-4 = 3.1e-6)
    ok = metric_err <= 1e-4 and param_err <= 1e-5
    emit({"phase": "train_parity", "metrics_cpu": m_cpu, "metrics_card":
          m_dev, "metric_rel_err": metric_err, "param_max_abs_err":
          param_err, "tol": {"metrics": 1e-4, "params": 1e-5}, "ok": ok})
    return ok


# kernel name -> (source, the Pallas call it replaces, counter module and
# attribute)
KERNELS = {
    "flash_fwd": ("serenade_tpu_torch/csrc/flash_fwd.cu",
                  "serenade_tpu/ops/flash_pallas.py:106", "flash_cuda",
                  "launches"),
    "flash_bwd_dq": ("serenade_tpu_torch/csrc/flash_bwd.cu",
                     "serenade_tpu/ops/flash_pallas.py:267", "flash_cuda",
                     "dq_launches"),
    "flash_bwd_dkv": ("serenade_tpu_torch/csrc/flash_bwd.cu",
                      "serenade_tpu/ops/flash_pallas.py:291", "flash_cuda",
                      "dkv_launches"),
    "block1d_fwd": ("serenade_tpu_torch/csrc/block1d_fwd.cu",
                    "serenade_tpu/ops/block1d_pallas.py:255", "block1d_cuda",
                    "launches"),
    "block1d_bwd_data": ("serenade_tpu_torch/csrc/block1d_bwd.cu",
                         "serenade_tpu/ops/block1d_pallas.py:296",
                         "block1d_cuda", "data_launches"),
    "block1d_bwd_weight": ("serenade_tpu_torch/csrc/block1d_bwd.cu",
                           "serenade_tpu/ops/block1d_pallas.py:343",
                           "block1d_cuda", "weight_launches"),
    "resblock_branch": ("serenade_tpu_torch/csrc/resblock_branch.cu",
                        "serenade_tpu/ops/resblock_pallas.py:154",
                        "resblock_cuda", "launches"),
}
# what each forward kernel writes, and the gradients each backward kernel
# writes
FORWARD_OUTPUTS = {"flash_fwd": ("out", "lse"), "block1d_fwd": ("out",),
                   "resblock_branch": ("out",)}
OUTPUTS = {"flash_bwd_dq": ("dq",), "flash_bwd_dkv": ("dk", "dv"),
           "block1d_bwd_data": ("dx", "dbias", "dgamma", "dbeta"),
           "block1d_bwd_weight": ("dw",)}


class Counters:
    """Every kernel's launch counter, read and reset by name."""

    def __init__(self, modules):
        self.modules = modules

    def reset(self):
        for name, (_, _, mod, attr) in KERNELS.items():
            setattr(self.modules[mod], attr, 0)

    def read(self):
        return {name: getattr(self.modules[mod], attr)
                for name, (_, _, mod, attr) in KERNELS.items()}


def kernel_entries(torch, dev):
    """Phase 2: every kernel against its plain version; one entry each for
    the kernels line (launches filled in by the path that runs them)."""
    entries, ok = {}, True

    def entry(name, row, timing):
        err = row["max_abs_err"]
        if isinstance(err, dict):   # a backward check: this kernel's outputs
            err = max(err[k] for k in OUTPUTS[name])
        # a kernel's own plain and library times where the check took them,
        # else its pair's; the scopes name the outputs each timed call made
        own = {k: timing.get(k, row.get(k)) for k in (
            "plain_ms", "plain_scope", "library_ms", "library_scope")}
        entries[name] = {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": None,
            "max_abs_err": err, "ms": timing["ms"],
            "plain_ms": own["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": own["library_ms"],
            "outputs": list(OUTPUTS.get(name) or FORWARD_OUTPUTS[name]),
            "plain_scope": own["plain_scope"],
            "library_scope": own["library_scope"],
            "shape": row["shape"], "dtype": row["dtype"]}

    for name, check in (("flash_fwd", check_flash),
                        ("block1d_fwd", check_block1d),
                        ("resblock_branch", check_resblock)):
        main_row, rows = check(torch, dev)
        emit({"phase": "kernels", "kernel": name, "cases": rows})
        ok &= all(r["ok"] for r in rows)
        entry(name, main_row, main_row)
    for names, check in ((("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dkv")),
                         check_flash_bwd), \
            ((("block1d_bwd_data", "data"), ("block1d_bwd_weight", "weight")),
             check_block1d_bwd):
        main_row, rows = check(torch, dev)
        emit({"phase": "kernels", "kernel": [n for n, _ in names],
              "cases": rows})
        ok &= all(r["ok"] for r in rows)
        for name, part in names:
            entry(name, main_row, main_row[part])
        if "library_backend" in main_row:
            entries[names[0][0]]["library_backend"] = \
                main_row["library_backend"]
            entries[names[1][0]]["library_backend"] = \
                main_row["library_backend"]
    return ok, entries


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
    counters = Counters({"flash_cuda": flash_cuda,
                         "block1d_cuda": block1d_cuda,
                         "resblock_cuda": resblock_cuda})
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

    ok, entries = kernel_entries(torch, dev)
    # each kernel's launches come from the path that runs it: the forward
    # kernels' from the conversions, the backward kernels' from training
    main_ok, launches = main_path(torch, np, dev, counters)
    ok &= main_ok
    for name in ("flash_fwd", "block1d_fwd", "resblock_branch"):
        entries[name]["launches"] = launches[name]
    ok &= slice_parity(torch, np, dev)
    train_ok, launches = train_path(torch, np, dev, counters)
    ok &= train_ok
    for name in OUTPUTS:
        entries[name]["launches"] = launches[name]
    ok &= train_parity(torch, np, dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    emit({"kernels": list(entries.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
