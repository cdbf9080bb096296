#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``serenade_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. build    -- compile the CUDA kernels from ``serenade_tpu_torch/csrc``;
2. kernels  -- each kernel (forward K1-K3, backward K4-K7, the Viterbi
               trellis) against its plain PyTorch version on the card, at
               small f32 shapes and at the conversion, extraction,
               training and post-processing paths' shapes, with times, the
               roofline bound and a PyTorch yardstick;
3. main     -- a full-width Converter (seeded random weights, ContentVec
               too) answers four requests through Euler-10 and the HiFiGAN
               vocoder; the launch counters must show every forward kernel
               ran, and the routed-call counters that no call took the
               plain route around a kernel; then one more (1024, 512)
               request under torch.profiler gives the device's busy time
               and the kernels that took it;
3b. features -- raw audio in: four sung-like waveforms (4.5, 7.0, 10.24,
               12.0 s, synthesized from a seed) through
               ``extract_from_wav_batch`` on the card and on the CPU, held
               key by key; then ``convert_wav`` of a 10.24 s source and a
               5.12 s reference (the (1024, 512) bucket) timed as
               extraction and conversion, with its launches (K1-K3 and the
               Viterbi kernel, routed calls 0) and profiles of the
               extraction and of the whole request;
4. parity   -- one small conversion on the CPU (plain versions) and on the
               card (kernels) with the same weights and noise, in f32 and
               in bf16 (head dim 32: its attention takes the plain route
               on both, counted alike);
5. train    -- a full-width Serenade and the recipe's optimizer take 2
               warm-up and 5 timed steps at B 16 x T 512; losses finite,
               every parameter with a nonzero gradient and changed, the
               launch counters at 6 (K1, K4, K5) and 13 (K2, K6, K7) a
               step, no call routed; then one step under torch.profiler;
6. train_parity -- one small f32 train step on the CPU and on the card
               from the same weights, batch and draws;
7. serve    -- phase 3's Converter behind ``serving.make_server`` on
               127.0.0.1:0: a registered style, then 8 client threads post
               16 /convert_features requests (phase 3's shapes, half with
               the style, half with their own reference), then 16 uniform
               (1024, 512) requests with the style, each traffic at
               max_batch 1, 8, 8, 1 in turns; each turn prints requests,
               batches, mean batch, p50/p95 latency, audio-seconds per
               second, the launch and routed counters, and fails on any
               error, a non-finite or misshapen answer or a routed call;
               then one profiled turn of each traffic at max_batch 8 and
               1 gives the device's idle share and the host's waits on
               it (failing if the host waited on the stream); then raw
               audio: 16 /convert_wav requests (npz bodies of phase 3b's
               four waveforms, the registered style) at max_batch 1, 8,
               8, 1, with the dispatcher's extraction time;
8. batch_parity -- row i of a batched bf16 conversion on the card against
               the same request converted alone at the same buckets and
               noise row, held by phase 4's rule against the CPU's own
               bf16 - f32 gap; f32 too;
9. stream   -- long-form and streaming, phase 3's Converter and phase 7's
               style packed on the card: a 60 s feature source through
               ``convert_features_stream`` (4 chunks at 2048/256) and
               ``convert_features_long``, a 60 s waveform through
               ``convert_wav_stream`` (windowed extraction ramping 512 ->
               2048), each with its time to first audio, wall time, RTF,
               launches (K1, K2, K3, the Viterbi kernel) and routed calls
               (0); 20 s fed to ``convert_wav_stream_live`` in 20 ms
               pieces at real time (lag p50/p95/max), then unpaced; both
               endpoints over HTTP (a feature npz and RIFF with ?style= to
               /convert_stream, a chunked PCM16 upload to
               /convert_stream_live), each read to its done marker; then a
               small f32 stream on the card against the CPU by phase 4's
               rule.  Profiles of the long feature stream and of 2 s of
               the live one give the device's idle share;
10. decode  -- decode end to end after the files are read: a temporary
               experiment dir built from a seed at full width (two port
               checkpoints, a reference-layout Serenade .pkl with seeded
               GST BatchNorm statistics, a reference HiFiGAN .pkl in
               weight-norm form), read back through the port's loaders and
               converters (every tensor exact, the average the f32 mean,
               the step rules' picks, each load timed); then the decode
               core over 6 sources x 3 styles at --batch-size 4, Euler-10,
               with the converted vocoder: per-group wall time, RTF,
               launches (K1-K3), routed calls (0), a profile of the
               largest group; each output against a lone conversion from
               its noise row (phase 8's rule, the gap measured on the card
               in f32), and one group on the card against the CPU in f32
               (phase 4's rule);
11. train_loop -- ``trainers.SSCTrainer`` at full width over a seeded
               corpus (64 utterances of 300-2,900 frames, two of 3,000+
               that the collater drops): (a) the recipe's keys, batch 4
               through the host loader (2 thread workers, prefetch 2), 16
               steps, evals at 8 and 16 with the seeded HiFiGAN, async
               saves; (b) the full-budget keys, B 16 x 1,280 from the
               corpus resident on the card, 12 steps, an async save
               against a synchronous one, a fresh trainer resumed from
               step 6 bit for bit and run to 12, one profiled step; (c) 3
               steps with the encoder and the GST frozen.  Steps/s and
               valid frames/s (each bucket's first visit apart), launches
               a step (6 K1/K4/K5, 13 K2/K6/K7), routed calls (0), peak
               memory, the saves' blocked time;
12. variant -- the F0-fluctuation variant (``SerenadeNew``, its first
               Block1D 244 channels wide, which phase 2 holds K2, K6 and
               K7 at) at full width with ContentVec and the seeded
               HiFiGAN: (a) four (1024, 512) ``convert_features`` requests
               with ``f0_fluc`` (launches of K1-K3, routed calls 0); batch
               rows against lone conversions at the same buckets, noise
               rows and shifts by phase 8's rule, and a small f32
               conversion on the card against the CPU by phase 4's; (b)
               ``convert_wav`` of phase 3b's 10.24 s source, its extracted
               ``f0_fluc`` against the CPU's; (c) the server with a style
               that carries ``f0_fluc``: eight /convert_features requests
               at max_batch 8 and one without ``f0_fluc``, refused alone;
               (d) a 20 s ``convert_features_stream``; (e)
               ``SSCTrainerNew`` from the card-resident corpus at B 16 x
               1,280 for 6 unsynchronised steps (steps/s, 6 K1/K4/K5 and
               13 K2/K6/K7 launches a step), then one small f32 train step
               on the card against the CPU by phase 6's rule;
13. distill_eval -- few-step distillation and objective evaluation from
               a seeded full-width teacher: (a) ``bin/distill.
               distill_core`` in endpoint mode (student 2 Euler steps,
               teacher Euler-10) through ``SSCTrainer`` from a
               card-resident corpus at B 16 x 1,280, 6 steps with async
               saves: steps/s, the teacher's share of a step (CUDA
               events), peak memory, launches a step (72 K1, 156 K2, 12
               K4/K5, 26 K6/K7), routed calls 0, finite losses, every
               ``cfm_decoder`` tensor moved, the encoder, the GST and the
               teacher equal to the teacher's bit for bit; (b) the same in
               reflow mode, 3 steps (66 K1, 143 K2, 6 K4/K5, 13 K6/K7 a
               step); (c) the saved student read back with the distilled
               config's 2 steps answering phase 3's (1024, 512) request
               (12 K1, 26 K2, 9 K3), the same Converter at Euler-10 in
               turns; (d) one small f32 distill step of each mode on the
               card against the CPU by phase 6's rule; (e)
               ``bin/evaluate.main`` over phase 3b's waveforms and their
               identical, pitch-shifted, noised and delayed copies and
               (c)'s conversion, with ``--device cuda`` and ``--device
               cpu``: summaries within 0.02 dB MCD, 1 cent and 0.01 V/UV
               of each other, identical pairs under 0.05 dB and V/UV 0,
               the Viterbi kernel's launches one a batched analysis,
               routed calls 0, seconds per audio second.
14. deploy  -- deployment at full width: (a) the mel-only Converter with
               f32 weights, ``quantize="int8"`` and ``"int8_compute"``
               answering one (1024, 512) request with the same noise:
               parameter bytes resident on the card, walls, the mel gap
               to the f32 weights', 60 K1 and 130 K2 a conversion, routed
               calls 0, ``int8_dot``'s ``torch._int_mm`` calls and routed
               shapes; the int8 weights under 0.35x the f32 parameters'
               bytes; (b) ``int8_matmul`` on the card equal to its exact
               int32 plain version; (c) the Converter with the seeded
               HiFiGAN exported for CUDA (f32 at (1024, 512) and the
               decode's largest bucket, (1216, 640); int8 at (1024, 512)),
               loaded and held against the live Converter at one seed:
               mel within phase 4's f32 rule, the waveform away from its
               last 16 frames within 1e-3, the program's custom ops (K1
               and K2 once in the ODE loop's body, K3 nine times) and a
               conversion's launches at the live counts (60 K1, 130 K2, 9
               K3), export, load and conversion seconds, the programs'
               bytes (the int8 artifact under 0.45x the f32 parameters it
               holds); (d) ``ArtifactService`` behind ``make_server``:
               4 clients post 8 (1024, 512) requests naming a registered
               style, latency p50/p95, /convert_wav refused with 400.
15. postprocess -- recipe stage 9, SiFiGAN post-processing (lines
               ``"phase": "postprocess"`` with ``"part"`` analysis /
               synthesis / synthesis_parity / decoded / cli_device /
               cli_native, then ``"postprocess_done"``): (a) phase 2
               holds K3 without additional convs at SiFiGAN's filter
               shapes (batch 8 of 10,240 / 40,960 / 122,880 / 245,760
               rows at C 256 / 128 / 64 / 32, k 3, 5, 7; the bound one
               conv a stage) and the Viterbi kernel at Harvest's 17
               states; (b) Harvest, band aperiodicity and D4C of phase
               3b's waveforms at 5 ms frames, seconds per audio second on
               the card, one Viterbi launch a waveform, two waveforms on
               the CPU too (vuv on 99.5 % of frames, f0 within 1e-3, the
               aperiodicity within 1e-2 dB); (c) the full-width SiFiGAN
               (the CLI's default generator, seeded weights) at batch 8 x
               2,048 frames: wall, RTF, the profile's busy share, 12 K3
               branch calls a synthesis on the split-TF32 route, routed
               calls 0, and a small f32 synthesis on the card against the
               CPU within 1e-3; (d) ``postprocess_core`` over phase 10's
               18 decode outputs (RTF, analysis and synthesis seconds, one
               Viterbi launch an utterance, 12 K3 calls a batch), then
               ``bin/ssc_postprocessing.main --anasyn`` over a temporary
               directory of phase 3b's waveforms (no config, stats or
               h5); (e) the same with ``--f0-backend harvest_native
               --analysis-backend native`` (the host library, built by
               g++).
16. vocoder -- the Griffin-Lim vocoder, the transcriber and vocoder
               training (lines ``"phase": "vocoder"`` with ``"part"``
               griffin_lim / transcriber / sifigan_extract /
               train_hifigan / synthesis_hifigan / train_sifigan /
               synthesis_sifigan, then ``"vocoder_done"``): (a) phase 3's
               (1024, 512) request through ``Converter.from_expdir`` on a
               tree written here whose ``vocoder:`` section is
               ``conf/vocoder_griffin_lim.yaml`` (as JSON): wall, RTF, 60
               K1 and 130 K2 a conversion, no K3, routed calls 0, the
               waveform within 1e-3 of the CPU's Griffin-Lim peak; (b) the
               transcriber at 229 mels x 768 from a seeded upstream-layout
               ``midi_model.pt`` on phase 3b's 10.24 s source: the card's
               notes and intervals equal to the CPU's, the logits' gap, one
               Viterbi launch, then preprocessing with it (``bin/
               preprocess.main --midi-model-ckpt`` where h5py is here,
               else the extraction it runs); (c) ``bin/
               sifigan_extract_features`` over phase 3b's waveforms, then
               both vocoder families trained at the recipe's widths
               (``conf/vocoder_hifigan.yaml``, ``conf/vocoder_sifigan.yaml``:
               batch 16 x 32 frames) on the conv backend: no kernel
               launch, every parameter's gradient nonzero, losses finite,
               steps/s, peak memory, the profiled step's idle share; each
               state saved by ``AsyncSaver`` and read back exactly, then
               synthesis from the HiFiGAN directory through
               ``load_vocoder`` (K3, within 1e-3 of the trained
               generator's conv backend) and from the SiFiGAN directory
               through ``postprocess_core`` (K3), routed calls 0.
17. nusvc  -- the model variants and small tools (lines ``"phase":
               "nusvc"`` with ``"part"`` inference / train / fused_qkv /
               snakebeta_unet / param_count, then ``"nusvc_done"``); phase
               2 holds K1, K4 and K5 at NUSVC's head dim 256: (a) NUSVC at
               its published widths (771 in, encoder 384, decoder (256,
               256), head dim 256, GST 50 tokens x 256; bf16 compute, f32
               parameters, seeded weights) converts a (1024, 512) request
               with Euler-10 twice: 60 K1 and 130 K2 launches each, routed
               calls 0, a finite (1, 1024, 80) mel, then a short f32
               conversion on the card against the CPU within 1e-3; (b)
               ``loss``, its backward and the recipe's AdamW at B 16 x 512,
               2 warm-up and 5 timed steps: 6 K1/K4/K5 and 13 K2/K6/K7
               launches a step, routed calls 0, every gradient finite and
               nonzero, steps/s; (c) phase 3's (1024, 512) request with
               ``SERENADE_FUSE_QKV=1`` and without, from the same noise:
               60 K1 launches each, routed calls 0, the mels within phase
               8's rule of each other against the card's own bf16 - f32
               gap; (d) Serenade's UNet with ``act_fn="snakebeta"``, one
               bf16 evaluation at T 1536: 6 K1 and 13 K2 launches; (e)
               ``bin/param_count --config`` on Serenade's full-width config
               and NUSVC's defaults, each total equal to the instantiated
               model's.

Then the card's name and power limit, one line listing the kernels, and
``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero, with
no result, when CUDA is absent, the package is missing, or any phase
fails.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_BF16 = 989e12     # H100 SXM dense tensor-core FLOP/s
PEAK_F32 = 67e12       # H100 SXM FP32 FLOP/s outside the tensor cores
PEAK_TF32 = 495e12     # H100 SXM dense TF32 tensor-core FLOP/s
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
SR, HOP = 24000, 240


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# what cuda_ms saw: timed calls, those it had to time again with a longer
# device-side wait, and the longest wait it used (ms, CUDA events)
TIMING = {"calls": 0, "retried": 0, "max_wait_ms": 0.0}


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events).  A
    device-side wait ahead of the first event holds the queue while the
    host enqueues every run, so that a kernel shorter than its wrapper's
    host time is timed back to back and not at the host's pace.  If the
    device reached the first event before the host had enqueued the last
    run, the wait was too short: it is doubled and the runs timed again,
    up to 400 ms of wait, and past that the timing fails."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    TIMING["calls"] += 1
    cycles = 50_000_000                  # about 25 ms at the H100's clock
    for attempt in range(5):
        wait = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        wait.record()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()         # still waiting: every run queued
        end.synchronize()
        TIMING["max_wait_ms"] = max(TIMING["max_wait_ms"],
                                    wait.elapsed_time(start))
        if held:
            return start.elapsed_time(end) / reps
        TIMING["retried"] += attempt == 0
        cycles *= 2
    raise RuntimeError("cuda_ms: the host did not enqueue the timed runs "
                       "within a 400 ms device-side wait")


def host_us(torch, fn, reps: int) -> float:
    """Mean host time of one call of ``fn`` in microseconds: the wrapper's
    checks, allocations and launch, not the device's work (the calls are
    queued without a synchronise in between)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / reps * 1e6


def rel_err(torch, got, ref) -> tuple:
    """(max |got - ref|, that over max(1, max |ref|)), in f64."""
    diff = (got.double() - ref.double()).abs().max().item()
    return diff, diff / max(1.0, ref.double().abs().max().item())


def bound_ms(flops: float, nbytes: float, bf16: bool,
             peak: float = None) -> tuple:
    """(ms, what bounds it) of ``flops`` at the bf16 or f32 peak, or at
    ``peak`` FLOP/s where given, against ``nbytes`` at the HBM rate."""
    t_ops = flops / (peak or (PEAK_BF16 if bf16 else PEAK_F32))
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _halved(lengths):
    """Valid lengths at the UNet's half resolution (its mask's ::2)."""
    return [(n + 1) // 2 for n in lengths]


def _loop_blocks(t, lengths):
    """(T, Cin, lengths, timed) of the UNet's Block1D shapes in a train
    step at bucket ``t``: inputs of 242, 512 and 1024 channels at T, 512
    and 1024 at T/2 (Cout 512 in all); the largest timed."""
    half = _halved(lengths)
    return ((t, 1024, lengths, True), (t, 242, lengths, False),
            (t, 512, lengths, False), (t // 2, 512, half, False),
            (t // 2, 1024, half, False))


def _heads(torch, gen, dev, b, h, t, d, dtype):
    """A (B, H, T, D) view of a (B, T, H, D) buffer, as the attention's
    head split makes them."""
    return (torch.randn((b, t, h, d), generator=gen, device=dev)
            .to(dtype).transpose(1, 2))


def check_flash(torch, dev):
    import torch.nn.functional as F

    from serenade_tpu_torch.ops import _cuda, flash_cuda as K

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []

    def case(b, h, t, d, dtype, valid, tol, timed):
        # the (B, H, T, D) views of (B, T, H, D) buffers the path hands K1
        q, k, v = (_heads(torch, gen, dev, b, h, t, d, dtype)
                   for _ in range(3))
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
            row["host_us"] = host_us(torch, lambda: K._flash_cuda(
                q, k, v, mask, scale), 50)
            row["plan"] = K.k1_plan(b, h, t, d, dtype, _cuda.sm_count(dev))
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
    # ragged: the half-resolution attention of a (1200, 200) request, and
    # the train step's forward
    case(1, 4, 736, 512, torch.bfloat16, [700], 2e-2, True)
    case(16, 4, 512, 512, torch.bfloat16, [512] + [475] * 15, 2e-2, True)
    # the serving path's batch of 8 (1024, 512) requests
    case(8, 4, 1536, 512, torch.bfloat16, [1536] * 8, 2e-2, True)
    # the streams: a 2048-frame chunk behind the 512-frame style, and a
    # live 64-frame chunk
    case(1, 4, 2560, 512, torch.bfloat16, [2560], 2e-2, True)
    case(1, 4, 576, 512, torch.bfloat16, [576], 2e-2, True)
    # the decode's largest group (phase 10)
    case(DECODE_GROUP[0], 4, DECODE_GROUP[1], 512, torch.bfloat16,
         DECODE_GROUP_LENGTHS, 2e-2, True)
    # the training loop (phase 11) at both of the UNet's resolutions, and
    # its eval's packed self-reference
    for b, t, lengths in LOOP_CHECKS:
        case(b, 4, t, 512, torch.bfloat16, lengths, 2e-2, True)
        case(b, 4, t // 2, 512, torch.bfloat16, _halved(lengths), 2e-2,
             False)
    case(len(LOOP_DEV), 4, LOOP_EVAL_T, 512, torch.bfloat16,
         [2 * n for n in LOOP_DEV], 2e-2, True)
    # NUSVC's head dim 256 (phase 17): its (1024, 512) inference and its
    # B 16 x 512 train step's forward, and a ragged shape
    for b, t, lengths in NUSVC_CHECKS:
        case(b, 4, t, 256, torch.bfloat16, lengths, 2e-2, True)
    case(3, 4, 200, 256, torch.bfloat16, [200, 96, 1], 2e-2, False)
    return main, rows


def check_block1d(torch, dev):
    """K2 against block1d_plain.  Its yardstick is cuDNN's conv1d alone on
    the same x·mask: no one call computes all of K2, and the conv is what
    its Hopper kernel runs."""
    import torch.nn.functional as F

    from serenade_tpu_torch.ops import _cuda, block1d_cuda as K

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
               "max_abs_err": err, "rel_err": rel, "tol": tol,
               "ok": rel <= tol}
        if timed:
            es = x.element_size()
            nbytes = es * (b * t * (cin + cout) + 3 * cin * cout) + 12 * cout
            row["bound_ms"], row["bound_by"] = bound_ms(
                2.0 * b * t * 3 * cin * cout, nbytes, dtype == torch.bfloat16)
            args = K.prepare_forward(x, mask, w, bias, gamma, beta)
            row["ms"] = cuda_ms(torch, lambda: K._block1d_cuda(
                *args, 8, 1e-5), 20)
            plan = K.k2_plan(b, t, cin, cout, dtype, _cuda.sm_count(dev))
            row["plan"] = {k: plan[k] for k in (
                "wn", "grid", "ctas", "stages", "smem_bytes", "x_loader")}
            row["plain_ms"] = cuda_ms(torch, lambda: K.block1d_plain(
                x, mask, w, bias, gamma, beta), 20)
            # cuDNN's conv1d (k 3, padding 1) on the same x·mask, (B, C, T)
            # as cuDNN takes it, held against K2's y before it is timed
            xm_bct = (x * mask).to(dtype).transpose(1, 2).contiguous()
            wc = w.to(dtype)
            lib = F.conv1d(xm_bct, wc, padding=1)
            _, y, _ = K._block1d_cuda(*args, 8, 1e-5)
            torch.cuda.synchronize()
            row["library_max_abs_err"], lib_rel = rel_err(
                torch, lib.transpose(1, 2) + args[3], y)
            row["ok"] &= lib_rel <= tol
            row["library_ms"] = cuda_ms(
                torch, lambda: F.conv1d(xm_bct, wc, padding=1), 20)
            row["plain_scope"], row["library_scope"] = ["out"], ["conv"]
        rows.append(row)
        return row

    case(2, 70, 20, 64, torch.float32, [70, 33], 1e-4, False)
    main = case(1, 1536, 1024, 512, torch.bfloat16, [1536], 2e-2, True)
    for t, cin in ((1536, 242), (1536, 512), (768, 512), (768, 1024)):
        case(1, t, cin, 512, torch.bfloat16, [t - 5], 2e-2, True)
    # the Hopper kernel at ragged tiles: lengths in the middle of a tile,
    # a tile past the length, the cp.async loader at batch > 1
    case(3, 200, 1024, 512, torch.bfloat16, [200, 131, 1], 2e-2, False)
    case(2, 150, 242, 512, torch.bfloat16, [150, 77], 2e-2, False)
    # the serving path's batch of 8 (1024, 512) requests
    case(8, 1536, 1024, 512, torch.bfloat16, [1536] * 8, 2e-2, True)
    # the streams' packed lengths (as above)
    case(1, 2560, 1024, 512, torch.bfloat16, [2560], 2e-2, True)
    case(1, 576, 1024, 512, torch.bfloat16, [576], 2e-2, True)
    # the decode's largest group (phase 10)
    case(DECODE_GROUP[0], DECODE_GROUP[1], 1024, 512, torch.bfloat16,
         DECODE_GROUP_LENGTHS, 2e-2, True)
    # the training loop (phase 11): the UNet's block shapes, and its
    # eval's packed self-reference
    for b, t, lengths in LOOP_CHECKS:
        for tt, cin, lens, timed in _loop_blocks(t, lengths):
            case(b, tt, cin, 512, torch.bfloat16, lens, 2e-2, timed)
    case(len(LOOP_DEV), LOOP_EVAL_T, 1024, 512, torch.bfloat16,
         [2 * n for n in LOOP_DEV], 2e-2, False)
    # the F0-fluctuation variant's first Block1D, Cin 244 (phase 12): a
    # conversion, the full-budget train batch, a small f32 case
    for b, t, cin, dtype, lengths, tol in VARIANT_CHECKS:
        case(b, t, cin, 512, getattr(torch, dtype), lengths, tol, True)
    return main, rows


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
    from serenade_tpu_torch.ops import _cuda, flash_cuda as K

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
            plan = K.k4_plan(b, h, t, t, d, dtype, _cuda.sm_count(dev))
            row["dq"]["plan"] = {k: plan[k] for k in (
                "grid", "threads", "smem_bytes", "query_rows", "key_tile",
                "slots", "ctas")}
            plan = K.k5_plan(b, h, t, t, d, dtype, _cuda.sm_count(dev))
            row["dkv"]["plan"] = {k: plan[k] for k in (
                "grid", "threads", "smem_bytes", "keys", "query_tile",
                "stages", "ctas")}
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
    # K5's Hopper kernel at Tk 200 (Tq not a multiple of 64): key blocks
    # 96-127 and on of the second sample wholly padded (they store zeros),
    # one valid key in the third
    case(3, 4, 200, 512, torch.bfloat16, [200, 96, 1], 2e-2, False)
    main = case(16, 4, 512, 512, torch.bfloat16, [512] + [475] * 15, 2e-2,
                True)
    case(16, 4, 256, 512, torch.bfloat16, [256] + [219] * 15, 2e-2, True)
    # the training loop (phase 11) at both of the UNet's resolutions
    for b, t, lengths in LOOP_CHECKS:
        case(b, 4, t, 512, torch.bfloat16, lengths, 2e-2, True)
        case(b, 4, t // 2, 512, torch.bfloat16, _halved(lengths), 2e-2,
             False)
    # NUSVC's head dim 256 (phase 17): the train step at both resolutions,
    # and key blocks wholly padded
    b, t, lengths = NUSVC_CHECKS[1]
    case(b, 4, t, 256, torch.bfloat16, lengths, 2e-2, True)
    case(b, 4, t // 2, 256, torch.bfloat16, _halved(lengths), 2e-2, False)
    case(3, 4, 200, 256, torch.bfloat16, [200, 96, 1], 2e-2, False)
    return main, rows


def check_block1d_bwd(torch, dev):
    """K6 and K7 against block1d_backward_plain on the same x, weights,
    output cotangent and K2's y and statistics.  K6's yardstick is cuDNN's
    conv1d data gradient on the same dy and weight (its dx product alone),
    K7's cuDNN's conv1d weight gradient on the same x·mask and dy."""
    from torch.nn.grad import conv1d_input, conv1d_weight

    from serenade_tpu_torch.ops import _cuda, block1d_cuda as K

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
            plan = K.k7_plan(b, t, cin, cout, dtype, _cuda.sm_count(dev))
            row["weight"]["plan"] = {k: plan[k] for k in (
                "grid", "splits", "smem_bytes", "x_loader")}
            # the plain version computes all five gradients together, its
            # weight part dW alone; no single call computes K6's outputs
            row["data"]["plain_ms"] = cuda_ms(
                torch, lambda: K.block1d_backward_plain(
                    x, mask, w, bias, gamma, beta, g), 5)
            row["data"]["plain_scope"] = list(names)
            plan = K.k6_plan(b, t, cin, cout, dtype, _cuda.sm_count(dev))
            row["data"]["plan"] = {k: plan[k] for k in (
                "bn", "grid", "ctas", "stages", "smem_bytes")}
            # K6's three kernels apart, ms a call from 10 profiled calls:
            # the dx product beside the two GroupNorm passes (bf16: f32
            # runs the FMA kernels).  The profiler has at times reported
            # none of a kernel's events: up to three profiles, and a part
            # none of them saw is not measured (null)
            if bf16:
                parts = (("dx", "k6::dx_bf16_kernel"),
                         ("gn_reduce", "gn_reduce_kernel"),
                         ("gn_dy", "gn_dy_kernel"))
                for tries in range(1, 4):
                    seen = device_time(torch, lambda: (
                        [K.block1d_bwd_data(x, lens, w, gamma, beta, y,
                                            stats, g) for _ in range(10)],
                        torch.cuda.synchronize()))["port_kernels"]
                    if all(sym in seen for _, sym in parts):
                        break
                row["data"]["profile_ms"] = {
                    part: (seen[sym]["ms"] / seen[sym]["count"]
                           if sym in seen else None) for part, sym in parts}
                row["data"]["profile_tries"] = tries
            # cuDNN's data gradient of conv1d (k 3, padding 1) on the same
            # dy and weight, (B, C, T) as cuDNN takes them, held against
            # the plain dx on the valid frames (cuDNN does not mask) before
            # it is timed
            dy_bct = dy.transpose(1, 2).contiguous()
            lib = conv1d_input((b, cin, t), w, dy_bct, padding=1)
            torch.cuda.synchronize()
            row["data"]["library_max_abs_err"], lib_rel = rel_err(
                torch, lib.transpose(1, 2) * mask, refs[0])
            row["ok"] &= lib_rel <= tol
            row["data"]["library_ms"] = cuda_ms(
                torch, lambda: conv1d_input((b, cin, t), w, dy_bct,
                                            padding=1), 10)
            row["data"]["library_scope"] = ["dx"]
            row["weight"]["plain_ms"] = cuda_ms(
                torch, lambda: K.block1d_weight_grad_plain(x, mask, dy), 5)
            row["weight"]["plain_scope"] = ["dw"]
            # cuDNN's weight gradient of conv1d (k 3, padding 1) on the same
            # x·mask and dy, both (B, C, T) as cuDNN takes them
            xm_bct = (x * mask).to(dtype).transpose(1, 2).contiguous()
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
    # K6's Hopper kernel at T 200 (not a multiple of 64): n_b a multiple of
    # 64 and 1, whose second 128-row tile lies past n_b (stores zeros)
    case(3, 200, 1024, 512, torch.bfloat16, [200, 128, 1], 2e-2, False)
    main = case(16, 512, 1024, 512, torch.bfloat16, [512] + [475] * 15,
                2e-2, True)
    for t, cin in ((512, 242), (256, 512), (256, 1024)):
        case(16, t, cin, 512, torch.bfloat16,
             [t] + [t - (37 if t == 512 else 18)] * 15, 2e-2, True)
    # the training loop (phase 11): the UNet's block shapes
    for b, t, lengths in LOOP_CHECKS:
        for tt, cin, lens, timed in _loop_blocks(t, lengths):
            case(b, tt, cin, 512, torch.bfloat16, lens, 2e-2, timed)

    def k7_case(b, t, cin, cout, lengths, tol):
        x = torch.randn((b, t, cin), generator=gen, device=dev).bfloat16()
        dy = torch.randn((b, t, cout), generator=gen, device=dev).bfloat16()
        mask = (torch.arange(t, device=dev)[None, :]
                < torch.tensor(lengths, device=dev)[:, None]).float()[..., None]
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        dw = K.block1d_bwd_weight(x, lens, dy)
        ref = K.block1d_weight_grad_plain(x, mask, dy)
        torch.cuda.synchronize()
        err, rel = rel_err(torch, dw, ref)
        return {"kernel": "block1d_bwd_weight", "shape": [b, t, cin, cout],
                "lengths": lengths, "dtype": "bfloat16",
                "max_abs_err": {"dw": err}, "tol": tol, "ok": rel <= tol}

    # K7 alone, dy nonzero on padded frames (neither the Pallas kernel nor
    # the plain version masks dy): n_b a multiple of 64, n_b = T, n_b = 1,
    # through both of its loaders (Cin 1024 by TMA, Cin 242 by cp.async)
    for cin in (1024, 242):
        for lengths in ([64, 512, 1, 128], [64] * 4, [1] * 4):
            rows.append(k7_case(4, 512, cin, 512, lengths, 2e-2))
    # the F0-fluctuation variant's first Block1D (phase 12)
    for b, t, cin, dtype, lengths, tol in VARIANT_CHECKS:
        case(b, t, cin, 512, getattr(torch, dtype), lengths, tol, True)
    return main, rows


def split_tf32_plain(torch, x, w1, b1, w2, b2, k, dils):
    """K3's f32 arithmetic with plain operations: each conv as the three
    products a_lo w_hi + a_hi w_lo + a_hi w_hi of TF32 parts, each exact
    in f32 (no TF32 in the conv), summed in f32."""
    import torch.nn.functional as F

    from serenade_tpu_torch.models.layers import conv1d
    from serenade_tpu_torch.ops.resblock_cuda import tf32_split

    def conv(a, w, b, d):
        (ah, al), (wh, wl) = tf32_split(a), tf32_split(w)
        out = b
        for aa, ww in ((al, wh), (ah, wl), (ah, wh)):
            out = out + conv1d(aa, ww, None, dilation=d,
                               padding=((k - 1) // 2 * d,) * 2)
        return out

    h = x
    for i, d in enumerate(dils):
        o = conv(F.leaky_relu(h, 0.1), w1[i], b1[i], d)
        h = h + conv(F.leaky_relu(o, 0.1), w2[i], b2[i], 1)
    return h


def check_resblock(torch, dev):
    """K3 against resblock_branch_plain (cuDNN without TF32).  f32 rows
    also hold both against the plain branch in f64, and the small C 64,
    k 11 case against ``split_tf32_plain`` on the CPU.  The f32 bound is
    the work as split TF32, three TF32 products for each f32 one at the
    tensor cores' TF32 rate, the least time f32 accuracy takes on the
    card; ``bound_f32_fma_ms`` states it at the FMA units' rate."""
    from serenade_tpu_torch.ops import _cuda, resblock_cuda as K

    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    dils = (1, 3, 5)

    def case(b, t, c, k, dtype, tol, timed, emulate=False, add=True):
        x = torch.randn((b, t, c), generator=gen, device=dev).to(dtype)
        ws = [(torch.randn((3, c, c, k), generator=gen, device=dev)
               / math.sqrt(k * c)).to(dtype) for _ in range(2)]
        bs = [0.1 * torch.randn((3, c), generator=gen, device=dev)
              for _ in range(2)]
        args = (x, ws[0], bs[0], ws[1], bs[1])
        kw = dict(kernel_size=k, dilations=dils, use_additional_convs=add)
        out = K.resblock_branch(*args, **kw)
        ref = K.resblock_branch_plain(
            x, ws[0], bs[0].to(dtype), ws[1], bs[1].to(dtype), **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(torch, out, ref)
        plan = K.k3_plan(b, t, c, k, dils[-1], add, dtype,
                         _cuda.sm_count(dev))
        row = {"shape": [b, t, c, k], "dtype": str(dtype)[6:],
               "additional_convs": add, "route": plan["route"],
               "max_abs_err": err, "rel_err": rel, "tol": tol,
               "ok": rel <= tol}
        if dtype == torch.float32:
            ref64 = K.resblock_branch_plain(
                *(a.double() for a in args), **kw)
            row["rel_err_f64"] = rel_err(torch, out, ref64)[1]
            row["plain_rel_err_f64"] = rel_err(torch, ref, ref64)[1]
            if emulate:
                emu = split_tf32_plain(torch, *(a.cpu() for a in args), k,
                                       dils)
                row["rel_err_split_plain"] = rel_err(torch, out.cpu(), emu)[1]
                row["split_plain_rel_err"] = rel_err(torch, emu,
                                                     ref.cpu())[1]
                row["split_plain_rel_err_f64"] = rel_err(torch, emu,
                                                         ref64.cpu())[1]
        if timed:
            # one conv a stage without additional convs, two with
            convs = 2 if add else 1
            es = x.element_size()
            nbytes = es * (2 * b * t * c + convs * 3 * k * c * c) + 24 * c
            flops = 3 * convs * 2.0 * b * t * k * c * c
            if dtype == torch.float32:
                row["bound_ms"], row["bound_by"] = bound_ms(
                    3 * flops, nbytes, False, PEAK_TF32)
                row["bound_f32_fma_ms"] = bound_ms(flops, nbytes, False)[0]
            else:
                row["bound_ms"], row["bound_by"] = bound_ms(
                    flops, nbytes, True)
            if plan["route"] == "tf32":
                row["plan"] = [{k: p[k] for k in ("bm", "ctas", "stages",
                                                  "smem_bytes")}
                               for p in plan["convs"]]
            row["ms"] = cuda_ms(torch, lambda: K.resblock_branch(
                *args, **kw), 5)
            row["plain_ms"] = cuda_ms(torch, lambda: K.resblock_branch_plain(
                x, ws[0], bs[0].to(dtype), ws[1], bs[1].to(dtype), **kw), 5)
            row["library_ms"] = None
            row["plain_scope"], row["library_scope"] = ["out"], None
            # a bound is a least time: a kernel under it means a wrong bound
            row["ok"] &= row["ms"] >= row["bound_ms"]
        rows.append(row)
        return row

    case(1, 300, 32, 3, torch.float32, 1e-4, False)
    case(2, 150, 128, 11, torch.float32, 1e-4, False)
    case(1, 256, 64, 11, torch.float32, 1e-4, False, emulate=True)
    main = case(1, 8192, 256, 11, torch.float32, 1e-4, True)
    for t, c in ((8192, 256), (49152, 128), (245760, 64)):
        for k in (3, 7, 11):
            if (t, c, k) != (8192, 256, 11):
                case(1, t, c, k, torch.float32, 1e-4, True)
    case(1, 8192, 256, 11, torch.bfloat16, 3e-2, True)
    # the serving path's vocoder tail at batch 8
    case(8, 8192, 256, 11, torch.float32, 1e-4, True)
    # the streams' vocoder at its unbucketed lengths: a long-form region
    # of 1,792 frames and a live one of 48, each after 32 frames of
    # context, through the three stages (x8 at C 256, x48 at 128, x240
    # at 64)
    for frames in (1824, 80):
        for up, c in ((8, 256), (48, 128), (240, 64)):
            for k in (3, 7, 11):
                case(1, frames * up, c, k, torch.float32, 1e-4,
                     frames == 1824)
    # the decode's vocoder, each output alone at its source's length:
    # 1,200 frames (whole 64-row tiles) and 1,190 (a partial last tile)
    for frames in (1200, 1190):
        for up, c in ((8, 256), (48, 128), (240, 64)):
            for k in (3, 7, 11):
                case(1, frames * up, c, k, torch.float32, 1e-4,
                     frames == 1200)
    # SiFiGAN's filter network (phase 15): no additional convs, batch 8 of
    # the 2,048-frame bucket at its four widths, k 3, 5 and 7, and a ragged
    # small case
    case(2, 333, 32, 5, torch.float32, 1e-4, False, add=False)
    for t, c in SIFIGAN_FILTER_SHAPES:
        for k in (3, 5, 7):
            case(SIFIGAN_BATCH, t, c, k, torch.float32, 1e-4, True,
                 add=False)
    return main, rows


def wall_ms(torch, fn, reps: int) -> float:
    """Mean host wall time of ``fn`` in ms, each run synchronised (for a
    plain version that itself waits on the device)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - start) / reps * 1e3


VITERBI = dict(voiced_bias=0.35, transition_octave_cost=6.0,
               switch_cost=0.4)
# the 10.24 s source's padded frames (phase 3b's main request)
VITERBI_MAIN = (1, 1153, 5)
# Harvest's trellis on a 12 s waveform's 128-hop bucket at 5 ms frames
VITERBI_HARVEST = (1, 2433, 16)
# SiFiGAN's synthesis batch (phase 15): 8 rows of the 2,048-frame bucket
# (10.24 s at 5 ms frames), and its filter network's (T, C) at each level
SIFIGAN_BATCH, SIFIGAN_FRAMES = 8, 2048
SIFIGAN_FILTER_SHAPES = ((10240, 256), (40960, 128), (122880, 64),
                         (245760, 32))


def check_viterbi(torch, np, dev):
    """The Viterbi kernel against its plain version (the frame loop) on
    the same seeded candidates: the states identical, and so f0 and vuv.
    Its yardstick: no PyTorch call decodes a trellis (library_ms null)."""
    from serenade_tpu_torch.ops import f0 as F0, viterbi_cuda as V

    rng = np.random.default_rng(21)
    rows = []

    def case(b, n, k, timed):
        cand = rng.uniform(60.0, 1100.0, (b, n, k)).astype(np.float32)
        em = rng.uniform(0.0, 1.0, (b, n, k)).astype(np.float32)
        em[rng.random((b, n, k)) < 0.3] = 1e6     # absent candidates
        cand, em = (torch.from_numpy(a).to(dev) for a in (cand, em))
        lf = torch.log2(torch.clamp_min(cand, 1.0))
        states = V.viterbi_states(em, lf, **VITERBI)
        plain = V.viterbi_states_plain(em, lf, **VITERBI)
        f0, vuv = F0.f0_of_states(cand, states, 60.0, 1100.0)
        f0_p, vuv_p = F0.f0_of_states(cand, plain, 60.0, 1100.0)
        torch.cuda.synchronize()
        same = (bool(torch.equal(states, plain)) and bool(torch.equal(f0, f0_p))
                and bool(torch.equal(vuv, vuv_p)))
        row = {"shape": [b, n, k], "dtype": "float32",
               "states_differing": int((states != plain).sum().item()),
               "max_abs_err": (f0 - f0_p).abs().max().item(), "tol": 0.0,
               "ok": same}
        if timed:
            nbytes = 2 * b * n * k * 4 + b * n * 8
            flops = 5.0 * b * max(n - 1, 0) * (k + 1) ** 2
            row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, False)
            row["ms"] = cuda_ms(torch, lambda: V.viterbi_states(
                em, lf, **VITERBI), 20)
            row["host_us"] = host_us(torch, lambda: V.viterbi_states(
                em, lf, **VITERBI), 50)
            row["plain_ms"] = wall_ms(torch, lambda: V.viterbi_states_plain(
                em, lf, **VITERBI), 2)
            row["library_ms"] = None
            row["plain_scope"] = ["states, host wall: its backtrace runs on "
                                  "the host"]
            row["library_scope"] = None
        rows.append(row)
        return row

    case(1, 1, 5, False)
    main = case(*VITERBI_MAIN, True)
    case(8, 1027, 5, True)
    case(4, 6003, 5, True)
    # Harvest's 17-state trellis (phase 15) at a 12 s waveform's bucket,
    # a batch of 2,048-frame rows, and the widest trellis, 32 states
    case(*VITERBI_HARVEST, True)
    case(8, 2049, 16, True)
    case(2, 700, 31, False)
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
    from serenade_tpu_torch.configs import (
        CONTENTVEC_CONFIG, VOCODER_CONFIG, serenade_config,
    )

    t0 = time.time()
    conv = Converter(serenade_config(), None, _scaler(np),
                     vocoder_config=VOCODER_CONFIG,
                     vocoder_stats={"mean": np.zeros(80), "scale": np.ones(80)},
                     contentvec_config=CONTENTVEC_CONFIG,
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
    launches, routed = counters.read(), counters.routed()
    n = len(requests)
    want = {"flash_fwd": 60 * n, "block1d_fwd": 130 * n, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "block1d_bwd_data": 0,
            "block1d_bwd_weight": 0, "viterbi_f0": 0}
    # every call of the full-width path runs a kernel: none is routed
    counts_ok = (all(launches[k] == v for k, v in want.items())
                 and launches["resblock_branch"] >= 9 * n
                 and not any(routed.values()))
    emit({"phase": "main", "setup_s": setup_s, "requests": results,
          "launches": launches, "launches_expected": dict(
              want, resblock_branch=f">= {9 * n}"), "routed": routed,
          "ok": counts_ok and all(r["ok"] for r in results)})
    prof = device_time(torch, lambda: (conv.convert_features(*feats[0]),
                                       torch.cuda.synchronize()))
    # idle share against the unprofiled wall time of the same request
    prof["device_idle_share"] = 1.0 - prof["device_busy_s"] / results[0][
        "wall_s"]
    emit(dict(phase="profile", request=list(requests[0]), **prof))
    return counts_ok and all(r["ok"] for r in results), launches, conv


# device symbols of the port's CUDA kernels, as the profiler names them
KERNEL_SYMBOLS = ("k1::flash_fwd_bf16_kernel", "k4::dq_bf16_kernel",
                  "k5::dkv_bf16_kernel", "k2::conv_stats_kernel",
                  "norm_mish", "gn_reduce_kernel", "gn_dy_kernel",
                  "k6::dx_bf16_kernel", "k7::dw_bf16_kernel",
                  "k3::conv_tf32_kernel", "stage_kernel",
                  "vit::viterbi_kernel")


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
    # the port's own kernels, each summed over its launches
    ours = {}
    for us, key, count in rows:
        for name in KERNEL_SYMBOLS:
            if name in key:
                ms, n = ours.get(name, (0.0, 0))
                ours[name] = (ms + us / 1e3, n + count)
    # the host's waits on the device (a pageable copy waits too, inside
    # cudaMemcpyAsync + cudaStreamSynchronize)
    syncs = {ev.key: ev.count for ev in prof.key_averages()
             if "Synchronize" in ev.key or ev.key == "cudaMemcpyAsync"}
    # the device's timeline: its first kernel's start to its last one's
    # end, and the time some kernel ran (kernels of libraries' side
    # streams overlap, so their sum can exceed it)
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events() if ev.device_type == DeviceType.CUDA)
    covered, reach = 0.0, None
    for b, e in spans:
        if reach is None or b > reach:
            covered += e - b
            reach = e
        elif e > reach:
            covered += e - reach
            reach = e
    return {"device_busy_s": sum(us for us, _, _ in rows) / 1e6,
            "device_span_s": (spans[-1][1] - spans[0][0]) / 1e6
            if spans else 0.0,
            "device_covered_s": covered / 1e6,
            "host_waits": syncs,
            "device_launches": sum(count for _, _, count in rows),
            "top": [{"kernel": key[:60], "ms": us / 1e3, "count": count}
                    for us, key, count in rows[:10]],
            "port_kernels": {name: {"ms": ms, "count": n}
                             for name, (ms, n) in ours.items()}}


# ---------------------------------------------------------------------------
# phase 3b: raw audio in
# ---------------------------------------------------------------------------

# phase 3b's waveforms: seconds and first note (Hz)
FEATURE_WAVS = ((4.5, 220.0), (7.0, 262.0), (10.24, 196.0), (12.0, 330.0))
SOURCE_S, REFERENCE_S = 10.24, 5.12      # the (1024, 512) bucket


def sung(np, seconds, seed, f0=220.0):
    """A sung-like waveform at SR: a harmonic tone with 5.5 Hz vibrato, a
    note change (a minor third up) halfway, 50 ms fades and breath noise
    (the CPU tests' ``sung``)."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * SR))
    t = np.arange(n) / SR
    note = np.where(t < seconds / 2, f0, f0 * 2 ** (3 / 12))
    phase = 2 * np.pi * np.cumsum(note * (1 + 0.015 * np.sin(
        2 * np.pi * 5.5 * t))) / SR
    x = sum(a * np.sin(k * phase)
            for k, a in enumerate((0.3, 0.12, 0.06, 0.03), 1))
    env = np.clip(np.minimum(t, seconds - t) / 0.05, 0, 1)
    return (x * env + 0.01 * rng.normal(size=n)).astype(np.float32)


def feature_wavs(np):
    return [sung(np, s, 40 + i, f0) for i, (s, f0) in enumerate(FEATURE_WAVS)]


def _frames_kept(seconds):
    """Frames of a ``seconds`` waveform once extracted (ContentVec's are
    the fewest: 100 a second for these lengths)."""
    return int(round(seconds * 100))


def compare_features(np, card, cpu) -> dict:
    """One waveform's features, the card's against the CPU's, key by key:
    log-mel within 1e-4 where it is within 70 dB of its frame's peak
    (deeper, rounding decides; the eps floor caps it at 1e-2), loudness
    within 1e-4, vuv equal on 99.5 % of frames and
    f0 within 1e-3 relative where both are voiced, the score equal on 99 %
    of frames, ContentVec within 1e-3 of max(1, |CPU|) (12 layers of f32
    products up to 3072 deep, summed in another order)."""
    got = {k: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
           for k, v in card.items()}
    want = {k: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
            for k, v in cpu.items()}
    shapes = all(got[k].shape == want[k].shape for k in want)
    lm = np.abs(got["logmel"] - want["logmel"])
    loud_rows = want["logmel"] >= want["logmel"].max(-1, keepdims=True) - 3.5
    both = (got["vuv"] > 0) & (want["vuv"] > 0)
    f0_rel = float((np.abs(got["f0"] - want["f0"])[both]
                    / want["f0"][both]).max()) if both.any() else 0.0
    hub = float(np.abs(got["hubert"] - want["hubert"]).max())
    hub_scale = max(1.0, float(np.abs(want["hubert"]).max()))
    row = {"frames": int(want["hubert"].shape[0]),
           "logmel_err_within_70db": float(lm[loud_rows].max()),
           "logmel_err": float(lm.max()),
           "loud_err": float(np.abs(got["loud"] - want["loud"]).max()),
           "vuv_agree": float((got["vuv"] == want["vuv"]).mean()),
           "f0_rel_err": f0_rel,
           "score_agree": float((got["est_lf0_score"]
                                 == want["est_lf0_score"]).mean()),
           "hubert_err": hub, "hubert_scale": hub_scale,
           "finite": all(bool(np.isfinite(v).all()) for v in got.values())}
    row["ok"] = (shapes and row["finite"]
                 and row["logmel_err_within_70db"] <= 1e-4
                 and row["logmel_err"] <= 1e-2 and row["loud_err"] <= 1e-4
                 and row["vuv_agree"] >= 0.995 and f0_rel <= 1e-3
                 and row["score_agree"] >= 0.99
                 and hub <= 1e-3 * hub_scale)
    return row


def features_path(torch, np, dev, counters, conv, card):
    """Phase 3b: extraction on the card against the CPU, then convert_wav
    at the (1024, 512) bucket, timed as extraction and conversion."""
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.configs import CONTENTVEC_CONFIG, serenade_config

    wavs = feature_wavs(np)
    t0 = time.time()
    got = conv.extract_from_wav_batch(wavs, [SR] * len(wavs))
    torch.cuda.synchronize()
    first_s = time.time() - t0
    t0 = time.time()
    # the same function on the CPU: ContentVec from the same seed
    cpu = Converter(serenade_config(), None, _scaler(np),
                    contentvec_config=CONTENTVEC_CONFIG, seed=0,
                    device="cpu")
    want = cpu.extract_from_wav_batch(wavs, [SR] * len(wavs))
    cpu_s = time.time() - t0
    rows = [compare_features(np, g, w) for g, w in zip(got, want)]
    for (seconds, _), row in zip(FEATURE_WAVS, rows):
        row["seconds"] = seconds
        row["ok"] &= row["frames"] == _frames_kept(seconds)
    parity_ok = all(r["ok"] for r in rows)
    emit({"phase": "features_parity", "card": card, "first_call_s": first_s,
          "cpu_s": cpu_s, "waveforms": rows, "ok": parity_ok})
    del cpu

    src = sung(np, SOURCE_S, 50, 196.0)
    ref = sung(np, REFERENCE_S, 51, 262.0)
    conv.convert_wav(src, ref, SR)                 # warm-up
    torch.cuda.synchronize()
    counters.reset()
    runs, right = [], True
    for _ in range(3):
        t0 = time.perf_counter()
        fs = conv.extract_from_wav(src, SR, "src")
        fr = conv.extract_from_wav(ref, SR, "ref")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mel, wav, _ = conv.convert_features(fs, fr)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        right &= (fs["hubert"].shape[0] == 1024
                  and fr["hubert"].shape[0] == 512
                  and mel.shape == (1024, 80) and wav.shape == (1024 * HOP,)
                  and bool(np.isfinite(mel).all())
                  and bool(np.isfinite(wav).all()))
        runs.append({"extract_s": t1 - t0, "convert_s": t2 - t1,
                     "wall_s": t2 - t0, "rtf": (t2 - t0) / SOURCE_S,
                     "extract_share": (t1 - t0) / (t2 - t0)})
    launches, routed = counters.read(), counters.routed()
    n = len(runs)
    # per request: Euler-10's 60 K1 and 130 K2 launches, 9 K3 branch
    # calls at least, one Viterbi launch for each of the two waveforms
    counts_ok = (launches["flash_fwd"] == 60 * n
                 and launches["block1d_fwd"] == 130 * n
                 and launches["resblock_branch"] >= 9 * n
                 and launches["viterbi_f0"] == 2 * n
                 and not any(routed.values()))
    ok = parity_ok and right and counts_ok
    wall = sum(r["wall_s"] for r in runs) / n
    emit({"phase": "features", "card": card, "source_s": SOURCE_S,
          "reference_s": REFERENCE_S, "runs": runs,
          "mean_wall_s": wall, "mean_rtf": wall / SOURCE_S,
          "launches_per_request": {k: v / n for k, v in launches.items()},
          "routed": routed, "right": right, "ok": ok})
    extract = sum(r["extract_s"] for r in runs) / n
    prof = device_time(torch, lambda: (conv.extract_from_wav(src, SR, "src"),
                                       conv.extract_from_wav(ref, SR, "ref"),
                                       torch.cuda.synchronize()))
    prof["device_idle_share"] = 1.0 - prof["device_busy_s"] / extract
    emit(dict(phase="features_profile", scope="extraction", **prof))
    prof = device_time(torch, lambda: (conv.convert_wav(src, ref, SR),
                                       torch.cuda.synchronize()))
    prof["device_idle_share"] = 1.0 - prof["device_busy_s"] / wall
    emit(dict(phase="features_profile", scope="convert_wav", **prof))
    return ok, launches


def slice_parity(torch, np, dev, counters):
    """One small conversion on the CPU (plain versions) and on the card
    (kernels) with the same weights and noise, in f32 and in bf16.  bf16
    at head dim 32 and these widths also takes the routes around the
    kernels that do not take its shapes (counted)."""
    from serenade_tpu_torch.api import Converter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(input_dim=32, output_dim=80, encoder_channels=16,
               encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
               decoder_attention_head_dim=32, gst_tokens=10,
               gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16)
    voc = {"sampling_rate": SR, "generator_params": {
        "channels": 64, "upsample_scales": [4, 3],
        "upsample_kernel_sizes": [8, 6]}}
    rng = np.random.default_rng(4)
    src = _features(np, rng, 150, False, input_dim=32)
    ref = _features(np, rng, 100, True, input_dim=32)
    x0 = 0.667 * rng.normal(size=(1, 128 + 192, 80))
    out = {}
    for dtype in ("float32", "bfloat16"):
        for device in ("cpu", dev):
            conv = Converter(dict(cfg, dtype=dtype), None,
                             _scaler(np, input_dim=32), vocoder_config=voc,
                             vocoder_stats={"mean": np.zeros(80),
                                            "scale": np.ones(80)},
                             n_timesteps=4, seed=5, device=device)
            counters.reset()
            mel, wav, _ = conv.convert_features(src, ref, x0=x0)
            out[dtype, str(device)] = (mel, wav, counters.routed())
    (mel32, wav32, _), (mel32d, wav32d, _) = (out["float32", "cpu"],
                                              out["float32", str(dev)])
    tol = 1e-3
    mel_err = float(np.abs(mel32 - mel32d).max())
    wav_err = float(np.abs(wav32 - wav32d).max())
    scale = max(1.0, float(np.abs(mel32).max()))
    ok = mel_err / scale <= tol and wav_err <= tol
    # bf16: the card against the CPU relative to the CPU's own bf16 - f32
    # gap, as the CPU tests hold the port against JAX (two bf16 results
    # rounding independently differ by about sqrt(2) times that gap on
    # average, at most twice it): mean within 1.5x, max within 2x
    mel16, _, routed_cpu = out["bfloat16", "cpu"]
    mel16d, _, routed_card = out["bfloat16", str(dev)]
    gap = np.abs(mel16 - mel32)
    err = np.abs(mel16d - mel16)
    bf16 = {"mel_max_abs_err": float(err.max()),
            "mel_mean_abs_err": float(err.mean()),
            "cpu_gap_max": float(gap.max()), "cpu_gap_mean": float(gap.mean()),
            "tol": {"mean": 1.5, "max": 2.0},
            "routed": {"cpu": routed_cpu, "card": routed_card},
            "finite": bool(np.isfinite(mel16d).all())}
    bf16_ok = (bf16["finite"] and err.mean() <= 1.5 * gap.mean()
               and err.max() <= 2.0 * gap.max() and routed_card == routed_cpu)
    emit({"phase": "parity", "mel_max_abs_err": mel_err,
          "wav_max_abs_err": wav_err, "mel_scale": scale, "tol": tol,
          "bf16": bf16, "ok": ok and bf16_ok})
    return ok and bf16_ok


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phases 5 and 6: the training step
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_T = 16, 512
TRAIN_LENGTHS = [512] + [475] * 15
# per train step: 6 transformer blocks and 13 Block1Ds, forward and backward
TRAIN_LAUNCHES = {"flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
                  "block1d_fwd": 13, "block1d_bwd_data": 13,
                  "block1d_bwd_weight": 13, "resblock_branch": 0,
                  "viterbi_f0": 0}


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
    launches, routed = counters.read(), counters.routed()
    peak = torch.cuda.max_memory_allocated()
    unchanged = [n for n, p in model.named_parameters()
                 if torch.equal(p.detach(), before[n])]
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    finite = all(math.isfinite(v) for r in records for v in r.values())
    ok = (finite and not no_grad and not unchanged and launches == want
          and not any(routed.values()))
    step_s = sum(walls) / len(walls)
    emit({"phase": "train", "batch": [b, t], "lengths": lengths,
          "params": sum(p.numel() for p in model.parameters()),
          "setup_s": setup_s, "steps": records, "step_s": walls,
          "mean_step_s": step_s, "steps_per_s": 1.0 / step_s,
          "frames_per_s": sum(lengths) / step_s,
          "peak_memory_gb": peak / 1e9, "params_without_grad": no_grad,
          "params_unchanged": unchanged, "launches": launches,
          "launches_expected": want, "routed": routed, "ok": ok})
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


# ---------------------------------------------------------------------------
# phases 7 and 8: the serving path
# ---------------------------------------------------------------------------

# phase 3's request shapes; 8 clients post 16 requests, the first half
# with the registered style, the second with their own reference
SERVE_SHAPES = ((1024, 512), (700, 300), (450, 512), (1200, 200))
SERVE_CLIENTS, SERVE_REQUESTS = 8, 16
SERVE_TURNS = (1, 8, 8, 1)
STYLE_FRAMES = 512


def _http(url, body=None) -> bytes:
    """GET ``url``, or POST ``body`` to it."""
    import urllib.request

    req = urllib.request.Request(url, data=body)
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.read()


def _f32(feats):
    return {k: v.astype("float32") for k, v in feats.items()}


def _decode_wav(body):
    """A /convert_wav answer (RIFF wav bytes) as (mel, wav, sr); no mel."""
    import io

    from serenade_tpu_torch.utils.audio import read_wav

    wav, sr = read_wav(io.BytesIO(body))
    return None, wav, sr


def serve_turn(torch, np, conv, counters, max_batch, traffic, style,
               endpoint="/convert_features"):
    """A server at ``max_batch`` on 127.0.0.1:0 registers ``style`` and
    answers ``traffic`` (bodies and their source frames) posted to
    ``endpoint`` from SERVE_CLIENTS client threads; then /healthz.
    Returns the turn's numbers, checked."""
    import threading

    from serenade_tpu_torch.serving import (
        BatchingConverter, decode_response, encode_reference, make_server,
    )

    decode = _decode_wav if endpoint == "/convert_wav" else decode_response

    batching = BatchingConverter(conv, max_batch=max_batch)
    server = make_server(batching, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    results, faults = [None] * len(traffic), []

    def client(j):
        for k in range(j, len(traffic), SERVE_CLIENTS):
            body, frames = traffic[k]
            t0 = time.perf_counter()
            try:
                out = decode(_http(base + endpoint, body))
            except Exception as exc:  # noqa: BLE001 — reported, fails the phase
                faults.append(f"request {k}: {exc!r}")
                continue
            results[k] = (time.perf_counter() - t0, frames) + out

    try:
        _http(f"{base}/register_reference?name=breathy",
              encode_reference(style))
        counters.reset()
        start = time.perf_counter()
        clients = [threading.Thread(target=client, args=(j,))
                   for j in range(SERVE_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.perf_counter() - start
        launches, routed = counters.read(), counters.routed()
        health = json.loads(_http(f"{base}/healthz"))
    finally:
        server.shutdown()
        server.server_close()
        batching.close()
        thread.join(timeout=10)
    done = [r for r in results if r is not None]
    right = all((mel is None or (mel.shape == (n, 80)
                                 and bool(np.isfinite(mel).all())))
                and wav.shape == (n * HOP,) and sr == SR
                and bool(np.isfinite(wav).all())
                for _, n, mel, wav, sr in done)
    lat = [r[0] for r in done]
    batches = health["batches"]
    audio = sum(n for _, n, *_ in done) * HOP / SR
    # every call of the path runs a kernel: 60 K1 and 130 K2 launches a
    # batch (Euler-10), at least 9 K3 branch calls
    counts_ok = (launches["flash_fwd"] == 60 * batches
                 and launches["block1d_fwd"] == 130 * batches
                 and launches["resblock_branch"] >= 9 * batches
                 and (launches["viterbi_f0"] > 0) == (endpoint == "/convert_wav")
                 and not any(routed.values()))
    ok = (not faults and len(done) == len(traffic) and right and counts_ok
          and health["ok"] and health["errors"] == 0
          and health["requests"] == len(traffic)
          and (max_batch == 1 or batches < len(traffic)))
    return {"max_batch": max_batch, "requests": len(done),
            "batches": batches, "mean_batch": len(done) / max(1, batches),
            "errors": health["errors"], "faults": faults[:4],
            "latency_s": {"p50": float(np.percentile(lat, 50)) if lat else None,
                          "p95": float(np.percentile(lat, 95)) if lat else None,
                          "max": max(lat, default=None)},
            "wall_s": wall, "audio_s": audio, "audio_s_per_s": audio / wall,
            "server_compute_s": health["compute_sec"],
            "server_launch_s": health["launch_sec"],
            "server_extract_s": health["extract_sec"],
            # the dispatcher's busy time that went to extraction
            "extract_share": (health["extract_sec"] / max(
                1e-9, health["extract_sec"] + health["launch_sec"])),
            "launches": launches,
            "routed": routed, "ok": ok}


def serve_path(torch, np, dev, counters, conv, card):
    """Phase 7: phase 3's Converter behind ``make_server``.  The mixed
    traffic (phase 3's shapes, half with the registered style) and then
    uniform traffic ((1024, 512) requests, all with the style: one
    bucket key) at max_batch 1, 8, 8, 1 in turns; then one profiled turn
    of each at max_batch 8 and 1 for the device's busy time and the
    host's waits on it."""
    from serenade_tpu_torch.serving import (
        BatchingConverter, encode_request, warmup_server,
    )

    d = conv.scaler["hubert"]["mean"].shape[0]
    rng = np.random.default_rng(7)
    style = _f32(_features(np, rng, STYLE_FRAMES, True, input_dim=d))

    def body(s, ref):
        return encode_request(_f32(_features(np, rng, s, False,
                                             input_dim=d)), ref), s

    mixed = []
    for k in range(SERVE_REQUESTS):
        s, r = SERVE_SHAPES[k % len(SERVE_SHAPES)]
        mixed.append(body(s, "breathy" if k < SERVE_REQUESTS // 2 else
                          _f32(_features(np, rng, r, True, input_dim=d))))
    uniform = [body(SERVE_SHAPES[0][0], "breathy")
               for _ in range(SERVE_REQUESTS)]
    t0 = time.time()
    warm = BatchingConverter(conv, max_batch=8)
    try:
        warmup_server(warm, [(s, r, 2) for s, r in SERVE_SHAPES]
                      + [(s, STYLE_FRAMES, 2) for s, _ in SERVE_SHAPES]
                      + [(SERVE_SHAPES[0][0], STYLE_FRAMES, 8)])
    finally:
        warm.close()
    emit({"phase": "serve_warmup", "seconds": time.time() - t0})
    ok, walls = True, {}
    for name, traffic in (("mixed", mixed), ("uniform", uniform)):
        for turn, max_batch in enumerate(SERVE_TURNS):
            row = serve_turn(torch, np, conv, counters, max_batch, traffic,
                             style)
            walls.setdefault((name, max_batch), []).append(row["wall_s"])
            emit({"phase": "serve", "traffic": name, "turn": turn,
                  "card": card, **row})
            ok &= row["ok"]
    for name, traffic in (("mixed", mixed), ("uniform", uniform)):
        for max_batch in (8, 1):
            rows = []
            prof = device_time(torch, lambda: rows.append(serve_turn(
                torch, np, conv, counters, max_batch, traffic, style)))
            wall = (sum(walls[name, max_batch])
                    / len(walls[name, max_batch]))
            # the profiler must have seen the dispatcher thread's kernels
            k1 = prof["port_kernels"].get("k1::flash_fwd_bf16_kernel", {})
            seen = k1.get("count", 0) == rows[0]["launches"]["flash_fwd"]
            # the dispatcher only launches: the host waits on the device
            # once a batch, on the finisher's event, never on the stream
            waits_ok = (prof["host_waits"].get("cudaEventSynchronize")
                        == rows[0]["batches"]
                        and not prof["host_waits"].get(
                            "cudaStreamSynchronize"))
            emit({"phase": "serve_profile", "traffic": name,
                  "max_batch": max_batch, "card": card,
                  "unprofiled_wall_s": wall,
                  "device_idle_share": (1.0 - prof["device_busy_s"] / wall
                                        if seen else None),
                  "profile_saw_dispatcher": seen, "host_waits_ok": waits_ok,
                  "turn": rows[0], **prof})
            ok &= rows[0]["ok"] and waits_ok
    return ok & serve_raw(torch, np, conv, counters, card)


def serve_raw(torch, np, conv, counters, card):
    """Raw audio: 8 clients post 16 /convert_wav requests, npz bodies of
    phase 3b's four waveforms against a style registered from a 5.12 s
    reference's features, at max_batch 1, 8, 8, 1 in turns (one
    unreported warm-up turn first)."""
    from serenade_tpu_torch.serving import encode_wav_request

    style = _f32({k: v for k, v in conv.extract_from_wav(
        sung(np, REFERENCE_S, 52, 262.0), SR, "style").items()
        if k in ("hubert", "score", "loud", "logmel")})
    wavs = feature_wavs(np)
    traffic = [(encode_wav_request(wavs[k % len(wavs)], SR, "breathy"),
                _frames_kept(FEATURE_WAVS[k % len(wavs)][0]))
               for k in range(SERVE_REQUESTS)]
    t0 = time.time()
    warm = serve_turn(torch, np, conv, counters, 8, traffic, style,
                      "/convert_wav")
    emit({"phase": "serve_raw_warmup", "seconds": time.time() - t0,
          "ok": warm["ok"]})
    ok = warm["ok"]
    for turn, max_batch in enumerate(SERVE_TURNS):
        row = serve_turn(torch, np, conv, counters, max_batch, traffic,
                         style, "/convert_wav")
        emit({"phase": "serve", "traffic": "raw", "turn": turn,
              "card": card, **row})
        ok &= row["ok"]
    return ok


def batch_parity(torch, np, dev, counters):
    """Phase 8: row i of one batched conversion on the card against
    request i converted alone at the same buckets from the same noise
    row.  bf16 is held by phase 4's rule against the CPU's own bf16 - f32
    gap on the same requests, f32 within phase 4's 1e-3.  A narrow model
    whose attention keeps head dim 512, so K1 and K2 run (at batch 4)."""
    from serenade_tpu_torch.api import Converter

    cfg = dict(input_dim=32, output_dim=80, encoder_channels=16,
               encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
               decoder_attention_head_dim=512, gst_tokens=10,
               gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16)
    rng = np.random.default_rng(8)
    frames = ((150, 100), (100, 64), (70, 90))   # source buckets 192, 128
    srcs = [_features(np, rng, s, False, input_dim=32) for s, _ in frames]
    refs = [_features(np, rng, r, True, input_dim=32) for _, r in frames]
    ts, tr = 192, 128
    x0 = 0.667 * rng.normal(size=(4, tr + ts, 80))

    def run(dtype, device, batched):
        conv = Converter(dict(cfg, dtype=dtype), None,
                         _scaler(np, input_dim=32), n_timesteps=4, seed=5,
                         device=device)
        if batched:
            return np.concatenate(conv.convert_features_batch(
                srcs, refs, ts=ts, tr=tr, pad_batch_pow2=True, x0=x0))
        return np.concatenate([conv.convert_features_batch(
            [s], [r], ts=ts, tr=tr, x0=x0[i:i + 1])[0]
            for i, (s, r) in enumerate(zip(srcs, refs))])

    counters.reset()
    batched, alone = run("bfloat16", dev, True), run("bfloat16", dev, False)
    launches, routed = counters.read(), counters.routed()
    gap = np.abs(run("bfloat16", "cpu", False) - run("float32", "cpu", False))
    err = np.abs(batched - alone)
    b32, a32 = run("float32", dev, True), run("float32", dev, False)
    err32 = float(np.abs(b32 - a32).max())
    scale = max(1.0, float(np.abs(a32).max()))
    bf16_ok = (bool(np.isfinite(batched).all())
               and err.mean() <= 1.5 * gap.mean()
               and err.max() <= 2.0 * gap.max())
    ran = launches["flash_fwd"] > 0 and launches["block1d_fwd"] > 0
    ok = bf16_ok and err32 <= 1e-3 * scale and ran and not any(
        routed.values())
    emit({"phase": "batch_parity", "batch": [4, ts, tr],
          "bf16": {"max_abs_err": float(err.max()),
                   "mean_abs_err": float(err.mean()),
                   "cpu_gap_max": float(gap.max()),
                   "cpu_gap_mean": float(gap.mean()),
                   "tol": {"mean": 1.5, "max": 2.0}},
          "f32": {"max_abs_err": err32, "scale": scale, "tol": 1e-3},
          "launches": launches, "routed": routed, "ok": ok})
    return ok


# ---------------------------------------------------------------------------
# phase 9: long-form and streaming conversion
# ---------------------------------------------------------------------------

LONG_FRAMES, LONG_S = 6000, 60.0    # a 60 s source: 4 chunks at 2048/256
LIVE_S, LIVE_PIECE = 20.0, 480      # 20 s of live input in 20 ms pieces
LIVE_PROFILE_S = 2.0                # profiled unpaced: reading a trace
                                    # costs far more than the run
HTTP_FRAMES, HTTP_RIFF_S, HTTP_LIVE_S = 2400, 20.0, 5.0


def serve_style(np, d):
    """Phase 7's registered style: 512 frames from seed 7's first draw."""
    return _f32(_features(np, np.random.default_rng(7), STYLE_FRAMES, True,
                          input_dim=d))


def _timed_stream(torch, segments):
    """Drain a stream: (its segments, seconds to the first segment with a
    waveform, seconds in all), on the host's clock."""
    t0 = time.perf_counter()
    out, first = [], None
    for seg in segments:
        if first is None and seg[2] is not None:
            first = time.perf_counter() - t0
        out.append(seg)
    torch.cuda.synchronize()
    return out, first, time.perf_counter() - t0


def _contiguous(np, segs, n) -> bool:
    """Segments in order, end to end, covering n frames, finite, each
    waveform hop times its mel."""
    pos = 0
    for start, mel, wav in segs:
        if (start != pos or not np.isfinite(mel).all() or wav is None
                or wav.shape != (mel.shape[0] * HOP,)
                or not np.isfinite(wav).all()):
            return False
        pos += mel.shape[0]
    return pos == n


def _stream_counts(launches, routed, k3_calls_min, viterbi):
    """K1 60 and K2 130 launches a chunk (Euler-10), K3 at least 9 branch
    calls a vocoder call, the Viterbi kernel once a window; none routed."""
    return (launches["flash_fwd"] > 0 and launches["block1d_fwd"] > 0
            and launches["flash_fwd"] * 13 == launches["block1d_fwd"] * 6
            and launches["resblock_branch"] >= k3_calls_min
            and (launches["viterbi_f0"] > 0) == viterbi
            and not any(routed.values()))


def stream_long(torch, np, conv, counters, packed, card):
    """Long-form: a 60 s source through convert_features_stream (features
    in, 2048/256) and a 60 s waveform through convert_wav_stream (ramping
    512 -> 2048, windowed extraction), each once to warm up and once
    timed with the counters; convert_features_long on the same features;
    one profiled run of the features stream."""
    from serenade_tpu_torch.features import FeatureConfig, stream_total_frames

    rng = np.random.default_rng(9)
    src = _f32(_features(np, rng, LONG_FRAMES, False,
                         input_dim=conv.scaler["hubert"]["mean"].shape[0]))
    wav = sung(np, LONG_S, 90, 196.0)
    ok, rows = True, {}
    for name, run, n in (
            ("features", lambda: conv.convert_features_stream(src, packed),
             LONG_FRAMES),
            ("wav", lambda: conv.convert_wav_stream(wav, SR, packed),
             stream_total_frames(int(LONG_S * SR) + 512,
                                 FeatureConfig.from_dict(conv.config)))):
        _timed_stream(torch, run())                       # warm-up
        counters.reset()
        segs, first, wall = _timed_stream(torch, run())
        launches, routed = counters.read(), counters.routed()
        chunks = launches["flash_fwd"] // 60
        right = _contiguous(np, segs, n)
        counts_ok = _stream_counts(launches, routed,
                                   9 * len(segs), name == "wav")
        row = {"frames": n, "chunks": chunks, "segments": len(segs),
               "first_audio_s": first, "wall_s": wall,
               "rtf": wall / (n * HOP / SR), "launches": launches,
               "routed": routed, "right": right}
        if name == "wav":
            row["windows"] = launches["viterbi_f0"]
            row["ok"] = right and counts_ok and chunks == 5
        else:
            mel, wav, _ = conv.convert_features_long(src, packed)
            row["long_mel_frames"] = int(mel.shape[0])
            row["ok"] = (right and counts_ok and chunks == 4
                         and mel.shape[0] == sum(m.shape[0]
                                                 for _, m, _ in segs)
                         and bool(np.isfinite(mel).all())
                         and bool(np.isfinite(wav).all()))
        emit({"phase": "stream", "part": f"long_{name}", "card": card,
              "source_s": n * HOP / SR, **row})
        rows[name] = row
        ok &= row["ok"]
    prof = device_time(torch, lambda: _timed_stream(
        torch, conv.convert_features_stream(src, packed)))
    prof["device_idle_share"] = 1.0 - prof["device_busy_s"] / rows[
        "features"]["wall_s"]
    emit(dict(phase="stream_profile", part="long_features", **prof))
    return ok, rows


def stream_live(torch, np, conv, counters, packed, card):
    """Live: LIVE_S of a sung waveform fed to convert_wav_stream_live in
    20 ms pieces by a feeder thread at real time (defaults 64/16/32).
    Each segment's lag is the time it is yielded minus the time the last
    piece holding audio it covers arrived.  Then the same stream fed as
    fast as it is read (wall time, RTF), and a profiled LIVE_PROFILE_S of
    it."""
    import queue
    import threading

    wav = sung(np, LIVE_S, 91, 220.0)
    pieces = [wav[i:i + LIVE_PIECE] for i in range(0, len(wav), LIVE_PIECE)]
    _timed_stream(torch, conv.convert_wav_stream_live(iter(pieces[:100]),
                                                      SR, packed))
    q = queue.Queue()
    t0 = time.perf_counter()

    def feed():
        for i, p in enumerate(pieces):
            time.sleep(max(0.0, t0 + (i + 1) * LIVE_PIECE / SR
                           - time.perf_counter()))
            q.put(p)
        q.put(None)

    def arrivals():
        while (p := q.get()) is not None:
            yield p

    feeder = threading.Thread(target=feed, daemon=True)
    counters.reset()
    feeder.start()
    lags, segs = [], []
    for seg in conv.convert_wav_stream_live(arrivals(), SR, packed):
        now = time.perf_counter()
        start, mel, _ = seg
        end = min((start + mel.shape[0]) * HOP, len(wav))
        arrived = t0 + math.ceil(end / LIVE_PIECE) * LIVE_PIECE / SR
        lags.append(now - arrived)
        segs.append(seg)
    feeder.join()
    launches, routed = counters.read(), counters.routed()
    n = sum(m.shape[0] for _, m, _ in segs)
    counters.reset()
    fast, first, wall = _timed_stream(torch, conv.convert_wav_stream_live(
        iter(pieces), SR, packed))
    same = (len(fast) == len(segs) and all(
        a[0] == b[0] and a[1].shape == b[1].shape for a, b in zip(fast, segs)))
    ok = (_contiguous(np, segs, n) and same and n >= LIVE_S * 100
          and _stream_counts(launches, routed, 9 * len(segs),
                             True))
    emit({"phase": "stream", "part": "live", "card": card, "source_s": LIVE_S,
          "piece_ms": 1000 * LIVE_PIECE / SR, "spans": launches["viterbi_f0"],
          "segments": len(segs), "frames": n,
          "lag_s": {"p50": float(np.percentile(lags, 50)),
                    "p95": float(np.percentile(lags, 95)),
                    "max": max(lags), "min": min(lags)},
          "unpaced": {"wall_s": wall, "rtf": wall / LIVE_S,
                      "first_audio_s": first},
          "launches": launches, "routed": routed, "ok": ok})
    short = pieces[:int(LIVE_PROFILE_S * SR / LIVE_PIECE)]
    prof = device_time(torch, lambda: _timed_stream(
        torch, conv.convert_wav_stream_live(iter(short), SR, packed)))
    _, _, short_wall = _timed_stream(
        torch, conv.convert_wav_stream_live(iter(short), SR, packed))
    prof["device_idle_share"] = 1.0 - prof["device_busy_s"] / short_wall
    emit(dict(phase="stream_profile", part="live_unpaced",
              source_s=LIVE_PROFILE_S, unprofiled_wall_s=short_wall, **prof))
    return ok


def stream_http(torch, np, conv, counters, style, card):
    """Both stream endpoints on 127.0.0.1:0: /convert_stream with a
    feature npz (the registered style) and with RIFF and ?style=,
    /convert_stream_live with a chunked PCM16 upload through http.client.
    Each answer is read by iter_stream_blocks to its done marker; the
    first block's time is on the client's clock."""
    import http.client
    import io
    import threading
    import urllib.request

    from serenade_tpu_torch.features import FeatureConfig, stream_total_frames
    from serenade_tpu_torch.serving import (
        BatchingConverter, encode_reference, encode_request,
        iter_stream_blocks, make_server,
    )
    from serenade_tpu_torch.utils.audio import write_wav

    fc = FeatureConfig.from_dict(conv.config)
    rng = np.random.default_rng(10)
    src = _f32(_features(np, rng, HTTP_FRAMES, False,
                         input_dim=conv.scaler["hubert"]["mean"].shape[0]))
    riff = io.BytesIO()
    write_wav(riff, sung(np, HTTP_RIFF_S, 92, 262.0), SR)
    pcm = (np.clip(sung(np, HTTP_LIVE_S, 93, 196.0), -1, 1)
           * 32767).astype("<i2").tobytes()
    batching = BatchingConverter(conv)
    server = make_server(batching, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]

    def blocks_of(resp, t0):
        first, out = None, []
        for blk in iter_stream_blocks(resp):
            first = first if first is not None else time.perf_counter() - t0
            out.append(blk)
        return out, first, time.perf_counter() - t0

    def post(path, body):
        t0 = time.perf_counter()
        req = urllib.request.Request(f"http://{host}:{port}{path}", data=body)
        with urllib.request.urlopen(req, timeout=300) as resp:
            return blocks_of(resp, t0)

    def live(path):
        """The upload goes out from its own thread while this one reads
        the answer, which starts before the upload ends."""
        c = http.client.HTTPConnection(host, port, timeout=300)

        def upload():
            for i in range(0, len(pcm), 2 * LIVE_PIECE):
                p = pcm[i:i + 2 * LIVE_PIECE]
                c.send(f"{len(p):X}\r\n".encode() + p + b"\r\n")
            c.send(b"0\r\n\r\n")

        sender = threading.Thread(target=upload, daemon=True)
        try:
            t0 = time.perf_counter()
            c.putrequest("POST", path)
            c.putheader("Transfer-Encoding", "chunked")
            c.endheaders()
            sender.start()
            return blocks_of(c.getresponse(), t0)
        finally:
            sender.join(timeout=60)
            c.close()

    ok = True
    try:
        urllib.request.urlopen(urllib.request.Request(
            f"http://{host}:{port}/register_reference?name=breathy",
            data=encode_reference(style)), timeout=60).read()
        for name, call, n in (
                ("features_npz", lambda: post(
                    "/convert_stream", encode_request(src, "breathy")),
                 HTTP_FRAMES),
                ("riff_style", lambda: post(
                    "/convert_stream?style=breathy", riff.getvalue()),
                 stream_total_frames(int(HTTP_RIFF_S * SR) + 512, fc)),
                ("live_chunked_pcm16", lambda: live(
                    "/convert_stream_live?style=breathy"),
                 stream_total_frames(int(HTTP_LIVE_S * SR) + 512, fc))):
            call()                                         # warm-up
            counters.reset()
            blocks, first, wall = call()
            launches, routed = counters.read(), counters.routed()
            segs = [(int(b["start"]), b["mel"], b["wav"]) for b in blocks]
            right = (_contiguous(np, segs, n)
                     and all(int(b["sr"]) == SR for b in blocks))
            row = {"endpoint": name, "blocks": len(blocks), "frames": n,
                   "first_block_s": first, "wall_s": wall,
                   "rtf": wall / (n * HOP / SR), "done_marker": True,
                   "launches": launches, "routed": routed, "right": right,
                   "ok": right and _stream_counts(
                       launches, routed, 9 * len(blocks),
                       name != "features_npz")}
            emit({"phase": "stream", "part": "http", "card": card, **row})
            ok &= row["ok"]
    finally:
        server.shutdown()
        server.server_close()
        batching.close()
        thread.join(timeout=10)
    return ok


def stream_parity(torch, np, dev, counters):
    """A small f32 model (head dim 512, so K1 and K2 run) converts a
    300-frame source at chunk 128 / overlap 32 and temperature 0 through
    convert_features_stream, on the card (kernels) and on the CPU (plain
    versions) from the same weights; the stitched mel and waveform are
    held by phase 4's f32 rule, the waveform relative to its own peak
    (``wav_scale``), since the narrow random vocoder's output is small."""
    from serenade_tpu_torch.api import Converter

    cfg = dict(input_dim=32, output_dim=80, encoder_channels=16,
               encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
               decoder_attention_head_dim=512, gst_tokens=10,
               gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16,
               dtype="float32")
    voc = {"sampling_rate": SR, "generator_params": {
        "channels": 64, "upsample_scales": [4, 3],
        "upsample_kernel_sizes": [8, 6]}}
    rng = np.random.default_rng(11)
    src = _features(np, rng, 300, False, input_dim=32)
    ref = _features(np, rng, 100, True, input_dim=32)
    out = {}
    for device in ("cpu", dev):
        conv = Converter(cfg, None, _scaler(np, input_dim=32),
                         vocoder_config=voc,
                         vocoder_stats={"mean": np.zeros(80),
                                        "scale": np.ones(80)},
                         n_timesteps=4, temperature=0.0, seed=5,
                         device=device)
        counters.reset()
        segs = list(conv.convert_features_stream(
            src, ref, chunk_frames=128, overlap_frames=32))
        out[str(device)] = (segs, counters.read(), counters.routed())
    cpu, (card, launches, routed) = out["cpu"][0], out[str(dev)]
    same = [s for s, _, _ in cpu] == [s for s, _, _ in card]
    mel_c = np.concatenate([m for _, m, _ in cpu])
    mel_d = np.concatenate([m for _, m, _ in card])
    wav_c = np.concatenate([w for _, _, w in cpu])
    wav_d = np.concatenate([w for _, _, w in card])
    mel_err = float(np.abs(mel_c - mel_d).max())
    wav_err = float(np.abs(wav_c - wav_d).max())
    scale = max(1.0, float(np.abs(mel_c).max()))
    wav_scale = float(np.abs(wav_c).max())
    ran = all(launches[k] > 0 for k in ("flash_fwd", "block1d_fwd",
                                        "resblock_branch"))
    ok = (same and mel_err / scale <= 1e-3
          and wav_err <= 1e-3 * wav_scale and ran
          and not any(routed.values()))
    emit({"phase": "stream_parity", "segments": len(card),
          "starts": [s for s, _, _ in card], "mel_max_abs_err": mel_err,
          "wav_max_abs_err": wav_err, "mel_scale": scale,
          "wav_scale": wav_scale, "tol": 1e-3,
          "launches": launches, "routed": routed, "ok": ok})
    return ok


def stream_path(torch, np, dev, counters, conv, card):
    """Phase 9: phase 3's Converter with phase 7's style, packed as a
    registered style is: long-form features and raw audio, live input,
    both endpoints over HTTP, then card-vs-CPU parity of a small stream.
    Returns (ok, the launches of the long-form raw-audio stream)."""
    t0 = time.time()
    style = serve_style(np, conv.scaler["hubert"]["mean"].shape[0])
    with torch.no_grad():
        packed = conv.pack_reference(style)
    seconds = {}

    def part(name, fn):
        t = time.time()
        out = fn()
        seconds[name] = time.time() - t
        return out

    ok, rows = part("long", lambda: stream_long(torch, np, conv, counters,
                                                packed, card))
    ok &= part("live", lambda: stream_live(torch, np, conv, counters, packed,
                                           card))
    ok &= part("http", lambda: stream_http(torch, np, conv, counters, style,
                                           card))
    ok &= part("parity", lambda: stream_parity(torch, np, dev, counters))
    emit({"phase": "stream_done", "seconds": time.time() - t0,
          "part_seconds": seconds, "ok": ok})
    return ok, rows["wav"]["launches"]


# ---------------------------------------------------------------------------
# phase 10: decode end to end
# ---------------------------------------------------------------------------

# source frames and (style, reference frames): the sources' buckets 1216
# (four), 640 and 320, the references' 640, 448 and 256
DECODE_SOURCES = (1200, 1190, 1170, 1160, 620, 300)
DECODE_STYLES = (("Breathy", 600), ("Falsetto", 400), ("Mixed_Voice", 210))
DECODE_BATCH = 4
# the largest group: 4 rows packed to 1216 + 640, each row's valid length
DECODE_GROUP = (DECODE_BATCH, 1216 + 640)
DECODE_GROUP_LENGTHS = [600 + n for n in DECODE_SOURCES[:DECODE_BATCH]]


def _f0_track(np, rng, frames):
    """A sung F0 track in Hz, its onset unvoiced (zeros)."""
    f0 = 220.0 * 2 ** (np.cumsum(rng.normal(size=frames)) / 60.0)
    f0[: frames // 10] = 0.0
    return f0


def _seeded_state_dict(torch, module, seed):
    """The module's init from ``seed`` with every tensor moved off its
    init's zeros and ones by seeded noise; running variances positive."""
    from serenade_tpu_torch.models.layers import init_params_

    init_params_(module, seed)
    g = torch.Generator().manual_seed(seed + 100)
    return {k: (0.5 + torch.rand(v.shape, generator=g)) if k.endswith(".var")
            else v.detach() + 0.02 * torch.randn(v.shape, generator=g)
            for k, v in module.state_dict().items()}


def _max_diff(torch, got, want):
    """max |got - want| over two state dicts, inf if their keys differ."""
    if set(got) != set(want):
        return float("inf")
    return max((got[k].double() - want[k].double()).abs().max().item()
               for k in want)


def decode_files(torch, np, root):
    """The decode's files at full width, built from a seed under ``root``
    and read back through the port: two port checkpoints (the step rules'
    picks, one restored, the two averaged), a reference-layout Serenade
    .pkl (the port's names inverted; GST BatchNorm statistics seeded) and
    a reference HiFiGAN .pkl in weight-norm form, each converted.
    Returns (ok, model state dict, generator state dict, model args)."""
    from serenade_tpu_torch.checkpoint import (
        average_checkpoints, find_last_checkpoints, find_latest_checkpoint,
        restore_params_only, save_checkpoint,
    )
    from serenade_tpu_torch.configs import VOCODER_CONFIG, serenade_config
    from serenade_tpu_torch.models.convert_serenade import (
        convert_serenade, load_torch_serenade_checkpoint,
        to_reference_state_dict,
    )
    from serenade_tpu_torch.models.serenade import Serenade
    from serenade_tpu_torch.vocoder.convert import (
        to_reference_generator_state_dict,
    )
    from serenade_tpu_torch.vocoder.vocoder import (
        generator_from_config, generator_layout, load_vocoder,
    )

    t0 = time.time()
    params = dict(serenade_config(), gst_norm_type="frozen_batch")
    sd = _seeded_state_dict(torch, Serenade(**params), 0)
    g = torch.Generator().manual_seed(1)
    older = {k: v + 0.01 * torch.randn(v.shape, generator=g)
             for k, v in sd.items()}
    gen_sd = _seeded_state_dict(
        torch, generator_from_config(VOCODER_CONFIG), 3)
    exp = os.path.join(root, "exp")
    p100 = save_checkpoint(exp, 100, older)
    p200 = save_checkpoint(exp, 200, sd)
    os.makedirs(os.path.join(exp, "checkpoint-50steps"))      # rules only
    os.makedirs(os.path.join(exp, "checkpoint-300steps.tmp"))
    pkl = os.path.join(root, "checkpoint-200000steps.pkl")
    torch.save({"model": to_reference_state_dict(sd, params)}, pkl)
    voc_pkl = os.path.join(root, "vocoder.pkl")
    torch.save({"model": {"generator": to_reference_generator_state_dict(
        gen_sd, **generator_layout(VOCODER_CONFIG))}}, voc_pkl)
    build_s = time.time() - t0

    load_s, diffs = {}, {}

    def timed(name, fn):
        t = time.time()
        out = fn()
        load_s[name] = time.time() - t
        return out

    restored = timed("port_checkpoint", lambda: restore_params_only(p200))
    diffs["port_checkpoint"] = _max_diff(torch, restored, sd)
    avg = timed("average_of_2", lambda: average_checkpoints([p100, p200]))
    diffs["average_vs_f32_mean"] = _max_diff(
        torch, avg, {k: (older[k].float() + sd[k].float()) / 2 for k in sd})
    model_sd = timed("serenade_pkl", lambda: convert_serenade(
        load_torch_serenade_checkpoint(pkl), params))
    diffs["serenade_pkl"] = _max_diff(torch, model_sd, sd)
    voc_sd = timed("hifigan_pkl", lambda: load_vocoder(voc_pkl,
                                                       VOCODER_CONFIG))
    diffs["hifigan_pkl"] = _max_diff(torch, voc_sd, gen_sd)
    # the JAX package's rules: the highest step; the n highest at or below
    # max_step, ascending; names that are not checkpoint-<N>steps ignored
    picks = {"latest": os.path.basename(find_latest_checkpoint(exp)),
             "last_2_max_step_100": [os.path.basename(p) for p in
                                     find_last_checkpoints(exp, 2, 100)]}
    want = {"latest": "checkpoint-200steps",
            "last_2_max_step_100": ["checkpoint-50steps",
                                    "checkpoint-100steps"]}
    bn = [k for k in sd if k.startswith("gst.ref_enc.norm")]
    seeded_bn = all(bool((sd[k] != (1.0 if k.endswith(".var") else 0.0))
                         .all()) for k in bn if k.endswith((".mean", ".var")))
    ok = (all(d == 0.0 for d in diffs.values()) and picks == want
          and bool(bn) and seeded_bn)
    emit({"phase": "decode_files", "build_s": build_s, "load_s": load_s,
          "max_abs_diff": diffs, "picks": picks, "picks_expected": want,
          "gst_batchnorm_seeded": seeded_bn, "tensors": len(sd),
          "generator_tensors": len(gen_sd), "ok": ok})
    return ok, model_sd, voc_sd, params


def decode_path(torch, np, dev, counters, card):
    """Phase 10: the decode's files (:func:`decode_files`, in a temporary
    directory removed after), then ``ssc_decode.decode_core`` over
    DECODE_SOURCES x DECODE_STYLES at DECODE_BATCH on the card, with the
    converted vocoder; each output against a lone conversion from its
    noise row, and the smallest group on the card against the CPU.
    Returns (ok, the decode's launches)."""
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.bin.ssc_decode import decode_core, plan_chunks
    from serenade_tpu_torch.configs import VOCODER_CONFIG

    t0 = time.time()
    root = tempfile.mkdtemp(prefix="chip_smoke_decode_")
    try:
        ok, model_sd, voc_sd, params = decode_files(torch, np, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    rng = np.random.default_rng(10)
    sc = _scaler(np)
    vstats = {"mean": np.zeros(80), "scale": np.ones(80)}
    sources = {f"EN_s{i % 2}_song{i}_Control_Group_0": dict(
        _features(np, rng, n, False), lf0=_f0_track(np, rng, n))
        for i, n in enumerate(DECODE_SOURCES)}
    references = {style: dict(_features(np, rng, n, True),
                              f0=_f0_track(np, rng, n))
                  for style, n in DECODE_STYLES}
    styles = {u: {s: s for s, _ in DECODE_STYLES} for u in sources}

    def converter(dtype, device, vocoder=True):
        voc = dict(vocoder_config=VOCODER_CONFIG, vocoder_params=voc_sd,
                   vocoder_stats=vstats) if vocoder else {}
        return Converter(dict(params, dtype=dtype), model_sd, sc,
                         n_timesteps=10, solver="euler", seed=0,
                         device=device, **voc)

    conv = converter("bfloat16", dev)
    plan = plan_chunks(sources, styles, references, DECODE_BATCH)
    # the largest group alone: the warm-up, and the profiled run
    style = DECODE_STYLES[0][0]
    largest = (dict(list(sources.items())[:DECODE_BATCH]),
               {u: {style: style} for u in sources},
               {style: references[style]})
    for _ in decode_core(conv, *largest, DECODE_BATCH):
        pass
    torch.cuda.synchronize()

    counters.reset()
    groups, results = [], []
    start = last = time.time()
    for (ts, tr), rows in decode_core(conv, sources, styles, references,
                                      DECODE_BATCH):
        now = time.time()          # the chunk's mels and wavs are on the host
        groups.append({"ts": ts, "tr": tr, "batch": len(rows),
                       "wall_s": now - last})
        results.extend(rows)
        last = now
    wall = time.time() - start
    launches, routed = counters.read(), counters.routed()
    n_conv = len(results)
    audio_s = sum(r["mel"].shape[0] for r in results) * HOP / SR
    shapes_ok = all(
        r["mel"].shape == (sources[r["utt_id"]]["hubert"].shape[0], 80)
        and r["wav"].shape == (r["mel"].shape[0] * HOP,)
        and r["lf0"].shape == (r["mel"].shape[0],)
        and bool(np.isfinite(r["mel"]).all())
        and bool(np.isfinite(r["wav"]).all()) for r in results)
    want = {"flash_fwd": 60 * len(plan), "block1d_fwd": 130 * len(plan),
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "block1d_bwd_data": 0,
            "block1d_bwd_weight": 0, "viterbi_f0": 0}
    counts_ok = (all(launches[k] == v for k, v in want.items())
                 and launches["resblock_branch"] >= 9 * n_conv
                 and not any(routed.values()))
    run_ok = (shapes_ok and counts_ok
              and n_conv == len(DECODE_SOURCES) * len(DECODE_STYLES)
              and len(groups) == len(plan))
    emit({"phase": "decode", "card": card, "conversions": n_conv,
          "groups": len({(g["ts"], g["tr"]) for g in groups}),
          "chunks": len(groups), "batch_size": DECODE_BATCH,
          "group_wall_s": groups, "wall_s": wall, "audio_s": audio_s,
          "rtf": wall / audio_s, "launches": launches,
          "launches_expected": dict(want, resblock_branch=f">= {9 * n_conv}"),
          "routed": routed, "ok": run_ok})
    ok &= run_ok

    prof = device_time(torch, lambda: (
        [None for _ in decode_core(conv, *largest, DECODE_BATCH)],
        torch.cuda.synchronize()))
    prof["device_idle_share"] = 1.0 - prof["device_busy_s"] / groups[0][
        "wall_s"]
    emit(dict(phase="decode_profile", group=[groups[0]["ts"],
                                             groups[0]["tr"], DECODE_BATCH],
              **prof))

    # each output against the same pair converted alone from its noise row,
    # by phase 8's rule: the bf16 difference within the bf16 - f32 gap of
    # the lone conversions, measured here on the card
    conv32 = converter("float32", dev)
    errs, gaps, wav_err, lone_s = [], [], 0.0, []
    for r in results:
        src, ref = sources[r["utt_id"]], references[r["ref_key"]]
        t = time.time()
        mel, wav, _ = conv.convert_features(src, ref, x0=r["x0"])
        lone_s.append(time.time() - t)      # on the host: the work is done
        mel32, _, _ = conv32.convert_features(src, ref, x0=r["x0"])
        errs.append(np.abs(r["mel"] - mel).ravel())
        gaps.append(np.abs(mel - mel32).ravel())
        wav_err = max(wav_err, float(np.abs(r["wav"] - wav).max()))
    err, gap = np.concatenate(errs), np.concatenate(gaps)
    lone_ok = bool(err.mean() <= 1.5 * gap.mean()
                   and err.max() <= 2.0 * gap.max())

    # the smallest group on the card and on the CPU in f32, from one noise
    # draw, by phase 4's rule
    utt = list(sources)[-1]
    style = DECODE_STYLES[-1][0]
    one = ({utt: sources[utt]}, {utt: {style: style}},
           {style: references[style]})
    out = {}
    for device, c in (("card", conv32), ("cpu", converter("float32",
                                                          "cpu"))):
        noise_rng = np.random.default_rng(12)
        (group, (row,)), = list(decode_core(
            c, *one, DECODE_BATCH, noise=lambda b, t: 0.667 * noise_rng
            .normal(size=(b, t, 80))))
        out[device] = row
    mel_cc = float(np.abs(out["card"]["mel"] - out["cpu"]["mel"]).max())
    wav_cc = float(np.abs(out["card"]["wav"] - out["cpu"]["wav"]).max())
    scale = max(1.0, float(np.abs(out["cpu"]["mel"]).max()))
    cpu_ok = bool(mel_cc / scale <= 1e-3 and wav_cc <= 1e-3)
    emit({"phase": "decode_parity",
          "batched_vs_lone": {"conversions": n_conv,
                              "max_abs_err": float(err.max()),
                              "mean_abs_err": float(err.mean()),
                              "card_gap_max": float(gap.max()),
                              "card_gap_mean": float(gap.mean()),
                              "tol": {"mean": 1.5, "max": 2.0},
                              "wav_max_abs_err": wav_err,
                              "lone_wall_s": sum(lone_s),
                              "largest_group_lone_wall_s":
                                  sum(lone_s[:groups[0]["batch"]]),
                              "largest_group_wall_s": groups[0]["wall_s"],
                              "ok": lone_ok},
          "card_vs_cpu": {"group": list(group) + [1],
                          "mel_max_abs_err": mel_cc, "mel_scale": scale,
                          "wav_max_abs_err": wav_cc, "tol": 1e-3,
                          "ok": cpu_ok}})
    ok &= lone_ok and cpu_ok
    emit({"phase": "decode_done", "seconds": time.time() - t0, "ok": ok})
    return ok, launches, results


# ---------------------------------------------------------------------------
# phase 11: the training loop
# ---------------------------------------------------------------------------

# the seeded corpus: 64 utterances of 300-2,900 frames and two of 3,000 or
# more, which the collater drops; a dev set whose longest (2,900 frames,
# bucket 2,944) packs to T 5,888 in the eval's self-reference inference
LOOP_UTTS, LOOP_FRAMES, LOOP_LONG = 64, (300, 2900), (3000, 3100)
LOOP_DEV = (2900, 1500, 800, 400)
LOOP_EVAL_T = 2 * 2944
# phase 2's rows at the loop's shapes: the full budget's B 16 x 1,280
# (corpus lengths clamped at 1,280) and the recipe's longest bucket at
# batch 4 (lengths from U(300, 2,900), longest first)
LOOP_CHECKS = (
    (16, 1280, [1280, 1280, 903, 1280, 1280, 611, 1280, 1280, 1280, 1166,
                1280, 402, 1280, 1280, 977, 1280]),
    (4, 2944, [2900, 2210, 1337, 301]))
LOOP_STEPS = {"recipe": 16, "fullbudget": 12, "freeze": 3}
LOOP_FREEZE = ["params/encoder", "params/gst"]


class SeededCorpus:
    """``FeatsDataset``'s interface (``__len__``, ``__getitem__``,
    ``lengths``) over utterances made from a seed, as
    ``FeatsDataset(scaler=...)`` gives them: hubert and logmel are drawn
    already standardized (standard normal, f32), score and loud drawn in
    their units and min-max scaled by the seeded scaler dicts.  The
    logmel dict is the eval vocoder's ``trg_stats``."""

    def __init__(self, np, lengths, seed):
        self._np = np
        rng = np.random.default_rng(seed)
        self.scaler = {
            "hubert": {"mean": rng.normal(size=768), "scale":
                       rng.uniform(0.5, 2.0, size=768)},
            "logmel": {"mean": rng.normal(size=80) - 4.0, "scale":
                       rng.uniform(0.5, 2.0, size=80)},
            "score": {"min": 0.0, "max": 80.0},
            "loud": {"min": -80.0, "max": 0.0}}
        self.items = []
        for t in lengths:
            item = {}
            for key, dim in (("hubert", 768), ("logmel", 80)):
                item[key] = rng.standard_normal((t, dim), dtype=np.float32)
            for key, lo, hi in (("score", 40.0, 80.0), ("loud", -60.0, 0.0)):
                st = self.scaler[key]
                v = rng.uniform(lo, hi, (t, 1)).astype(np.float32)
                v -= st["min"]
                v /= st["max"] - st["min"]
                item[key] = v
            self.items.append(item)
        self.nbytes = sum(a.nbytes for it in self.items for a in it.values())

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self, key="hubert"):
        return self._np.array([it[key].shape[0] for it in self.items])


class _Writer:
    """The trainer's scalars, kept (tensorboardX is not on the card's
    machine)."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, key, value, step):
        self.scalars[f"{key}@{step}"] = float(value)


class _StepLog(list):
    """Per-step records of :func:`_recorded_step`, and the last metrics."""
    metrics = None


def _recorded_step(torch, step_fn, log: _StepLog, shape_of):
    """``step_fn`` with each step's bucket and valid frames
    (``shape_of(batch)``), its host time and CUDA events around it
    recorded in ``log``.  Nothing synchronises: the trainer's dispatch
    window lets the host queue a step while the device runs the last."""
    def step(state, batch, *rest):
        start = time.time()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        state, metrics = step_fn(state, batch, *rest)
        events[1].record()
        t, frames = shape_of(batch)
        log.append({"t": t, "frames": frames,
                    "host_s": time.time() - start, "events": events})
        log.metrics = metrics
        return state, metrics

    return step


def _rates(torch, log, excluded_s=0.0):
    """Steps/s and valid frames/s over the loop's window as it ran: on the
    device's clock from the first step's start to the last step's end,
    less ``excluded_s`` (the evals' wall).  Apart, for attribution only:
    each bucket's first visit (host time and device span) beside the
    mean of its later visits."""
    torch.cuda.synchronize()
    for r in log:
        r["span_s"] = r["events"][0].elapsed_time(r["events"][1]) / 1e3
    window = (log[0]["events"][0].elapsed_time(log[-1]["events"][1]) / 1e3
              - excluded_s)
    visits = {}
    for r in log:
        visits.setdefault(r["t"], []).append(r)
    first = {}
    for t, rs in visits.items():
        later = rs[1:]
        first[str(t)] = {
            "host_s": rs[0]["host_s"], "span_s": rs[0]["span_s"],
            "later_visits": len(later),
            "later_host_s": (sum(r["host_s"] for r in later) / len(later)
                             if later else None),
            "later_span_s": (sum(r["span_s"] for r in later) / len(later)
                             if later else None)}
    return {"steps": len(log), "window_s": window,
            "steps_per_s": len(log) / window,
            "frames_per_s": sum(r["frames"] for r in log) / window,
            "buckets": sorted(visits), "first_visits": first}


def train_loop_path(torch, np, dev, counters, card):
    """Phase 11: ``SSCTrainer`` at full width over a seeded corpus: (a) the
    recipe's keys with the host loader (batch 4, two thread workers,
    prefetch 2), eval samples through the seeded HiFiGAN and an async
    save at 8; (b) the full-budget keys with the corpus resident on the
    card (batch 16 at 1,280 frames), an async save at 6 against a
    synchronous save of the same state, a fresh trainer resumed from
    step 6 bit for bit and run to 12, one profiled step; (c) 3 steps with
    the encoder and the GST frozen.  Returns (ok, the phase's
    launches)."""
    from serenade_tpu_torch.checkpoint import (
        restore_checkpoint, save_checkpoint,
    )
    from serenade_tpu_torch.collaters.ssc import SSCCollater
    from serenade_tpu_torch.configs import (
        TRAIN_CONFIG, TRAIN_CONFIG_FULLBUDGET, VOCODER_CONFIG,
        serenade_config,
    )
    from serenade_tpu_torch.datasets.device_cache import DeviceResidentData
    from serenade_tpu_torch.datasets.loader import ShardedBatchLoader
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.models.serenade import Serenade
    from serenade_tpu_torch.trainers import (
        SSCTrainer, build_optimizer, build_train_step, create_train_state,
    )
    from serenade_tpu_torch.trainers.eval_samples import make_eval_fn
    from serenade_tpu_torch.utils.model_io import freeze_mask
    from serenade_tpu_torch.vocoder.vocoder import Vocoder

    t0 = time.time()
    ok = True
    cfg = serenade_config()
    rng = np.random.default_rng(11)
    lengths = [int(n) for n in rng.integers(
        LOOP_FRAMES[0], LOOP_FRAMES[1] + 1, LOOP_UTTS)] + list(LOOP_LONG)
    corpus = SeededCorpus(np, lengths, 11)
    dev_corpus = SeededCorpus(np, LOOP_DEV, 12)
    sd0 = init_params_(Serenade(**cfg), seed=0).state_dict()
    root = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    setup_s = time.time() - t0

    def fresh(trainable=None, config=TRAIN_CONFIG):
        model = Serenade(**cfg)
        model.load_state_dict(sd0)
        model.to(dev)
        opt, _ = build_optimizer(config, trainable_mask=trainable)
        return model, opt, create_train_state(model, opt)

    def host_shape(batch):
        return (int(batch["x"].shape[1]),
                int(np.asarray(batch["lengths"]).sum()))

    def finite(writer):
        return bool(writer.scalars) and all(
            math.isfinite(v) for v in writer.scalars.values())

    counters.reset()
    try:
        # (a) the recipe's keys, the host loader, eval samples, async save
        config = dict(TRAIN_CONFIG, train_max_steps=LOOP_STEPS["recipe"],
                      log_interval_steps=4, eval_interval_steps=8,
                      save_interval_steps=8, num_save_intermediate_results=4)
        model, opt, state = fresh()
        loader = ShardedBatchLoader(corpus, SSCCollater(),
                                    batch_size=config["batch_size"], seed=0,
                                    num_workers=2)
        dev_batch = next(iter(ShardedBatchLoader(
            dev_corpus, SSCCollater(), batch_size=len(LOOP_DEV),
            shuffle=False, drop_last=False)))
        vocoder = Vocoder(VOCODER_CONFIG, None,
                          {"mean": np.zeros(80), "scale": np.ones(80)},
                          trg_stats=corpus.scaler["logmel"], device=dev)
        eval_dir = os.path.join(root, "a")
        inner_eval = make_eval_fn(model, dev_batch, outdir=eval_dir,
                                  vocoder=vocoder, num_save=4, device=dev)
        evals = []

        def eval_fn(state, steps):
            # the queued steps finish first, so their time stays the loop's
            torch.cuda.synchronize()
            before = counters.read()
            start = time.time()
            mel = inner_eval(state, steps)
            torch.cuda.synchronize()
            after = counters.read()
            wavs = sorted(f for f in os.listdir(os.path.join(
                eval_dir, "predictions", f"{steps}steps"))
                if f.endswith(".wav"))
            evals.append({"step": steps, "wall_s": time.time() - start,
                          "launches": {k: after[k] - before[k] for k in
                                       ("flash_fwd", "block1d_fwd",
                                        "resblock_branch")},
                          "mel_finite": bool(np.isfinite(mel).all()),
                          "wavs": len(wavs)})

        log, writer = _StepLog(), _Writer()
        trainer = SSCTrainer(
            config, _recorded_step(torch, build_train_step(
                model, opt, device=dev), log, host_shape),
            state, loader, writer=writer, outdir=os.path.join(root, "a"),
            eval_fn=eval_fn,
            generator=torch.Generator(device=dev).manual_seed(2))
        start = time.time()
        trainer.run()
        torch.cuda.synchronize()
        run_s = time.time() - start
        loader.shutdown()
        launches, routed = counters.read(), counters.routed()
        n = LOOP_STEPS["recipe"]
        ev = {k: sum(e["launches"][k] for e in evals)
              for k in ("flash_fwd", "block1d_fwd", "resblock_branch")}
        per_step = {k: (launches[k] - ev.get(k, 0)) / n for k in
                    ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "block1d_fwd", "block1d_bwd_data",
                     "block1d_bwd_weight")}
        want = {k: (6 if k.startswith("flash") else 13) for k in per_step}
        # evals at 8 and 16: Euler-10 (60 K1, 130 K2), 4 samples vocoded
        # as prediction and ground truth (9 branch calls a vocoder run)
        a_ok = (per_step == want and not any(routed.values())
                and finite(writer) and [e["step"] for e in evals] == [8, 16]
                and all(e["mel_finite"] and e["wavs"] == 8 for e in evals)
                and ev["flash_fwd"] == 120 and ev["block1d_fwd"] == 260
                and ev["resblock_branch"] >= 9 * 16
                and sorted(trainer.save_blocked_s) == [8, 16])
        emit({"phase": "train_loop", "run": "recipe", "card": card,
              "batch": config["batch_size"], "workers": 2, "prefetch": 2,
              "corpus_items": len(corpus), "corpus_host_gb":
                  corpus.nbytes / 1e9, "run_s": run_s,
              **_rates(torch, log, sum(e["wall_s"] for e in evals
                                       if e["step"] < n)),
              "launches_per_step": per_step, "launches_per_step_expected":
                  want, "routed": routed, "eval": evals,
              "save_blocked_s": trainer.save_blocked_s,
              "losses": {k: v for k, v in writer.scalars.items()
                         if "loss" in k}, "ok": a_ok})
        ok &= a_ok
        del model, opt, state, trainer, vocoder
        shutil.rmtree(os.path.join(root, "a"), ignore_errors=True)

        # (b) the full-budget keys, the corpus resident on the card
        fb = dict(TRAIN_CONFIG_FULLBUDGET,
                  train_max_steps=LOOP_STEPS["fullbudget"],
                  save_interval_steps=6, log_interval_steps=6,
                  eval_interval_steps=10 ** 9)
        pft = fb["collater_params"]["pad_frames_to"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model, opt, state = fresh(config=fb)
        t = time.time()
        dr = DeviceResidentData(corpus, pad_frames_to=pft,
                                batch_size=fb["batch_size"], seed=0,
                                device=dev)
        torch.cuda.synchronize()
        upload_s = time.time() - t
        log, writer = _StepLog(), _Writer()
        step = build_train_step(model, opt, device=dev)
        lens = np.minimum(corpus.lengths(), pft)
        trainer = SSCTrainer(
            fb, _recorded_step(torch, dr.wrap_step(step), log, lambda b: (
                pft, int(lens[b["indices"]].sum()))), state, dr,
            writer=writer, outdir=os.path.join(root, "b"),
            generator=torch.Generator(device=dev).manual_seed(2))
        # the state at step 6 copied to the host before the async save, to
        # hold the saved file against (the next step updates in place)
        ref = {}
        interval_save = trainer.save

        def save(step):
            if step == 6:
                ref.update(
                    params={k: p.detach().to("cpu", copy=True)
                            for k, p in state.params.items()},
                    **{part: {k: v.to("cpu", copy=True) for k, v in
                              state.opt_state[part].items()}
                       for part in ("mu", "nu")},
                    count=state.opt_state["count"])
            interval_save(step)

        trainer.save = save
        counts0 = counters.read()
        start = time.time()
        trainer.run()
        torch.cuda.synchronize()
        run_s = time.time() - start
        counts1 = counters.read()
        peak = torch.cuda.max_memory_allocated()
        rates = _rates(torch, log)
        # the step after the async save waits on the device for its copies
        after_save = {k: log[6][k] for k in ("host_s", "span_s")}
        params = {k: p.detach() for k, p in state.params.items()}
        t = time.time()
        save_checkpoint(os.path.join(root, "sync"), 12, params,
                        state.opt_state, epochs=trainer.epochs)
        sync_s = time.time() - t
        shutil.rmtree(os.path.join(root, "sync"), ignore_errors=True)
        prof = device_time(torch, lambda: (
            step(state, dr.gather(next(iter(dr))["indices"])),
            torch.cuda.synchronize()))
        # over the loop's window as it ran: every step as busy as this one
        prof["device_idle_share"] = 1.0 - (
            prof["device_busy_s"] * rates["steps"] / rates["window_s"])
        b_losses = finite(writer)
        del model, opt

        # a fresh trainer resumed from step 6: the saved state exactly
        path = os.path.join(root, "b", "checkpoint-6steps")
        saved = restore_checkpoint(path)
        model2 = Serenade(**cfg).to(dev)
        g = torch.Generator(device=dev).manual_seed(5)
        with torch.no_grad():
            for p in model2.parameters():
                p.normal_(generator=g)
        opt2, _ = build_optimizer(fb)
        state2 = create_train_state(model2, opt2)
        writer2 = _Writer()
        resumed = SSCTrainer(
            fb, dr.wrap_step(build_train_step(model2, opt2, device=dev)),
            state2, dr, writer=writer2, outdir=os.path.join(root, "b2"),
            generator=torch.Generator(device=dev).manual_seed(2))
        resumed.resume(path)
        # the file holds the state as it was at the save, and the fresh
        # trainer holds the file, bit for bit
        snapshot_exact = (
            saved["opt_state"]["count"] == ref["count"] == 6
            and all(torch.equal(saved["params"][k], v)
                    for k, v in ref["params"].items())
            and all(torch.equal(saved["opt_state"][part][k], v)
                    for part in ("mu", "nu") for k, v in ref[part].items()))
        exact = (
            snapshot_exact
            and resumed.steps == saved["meta"]["step"] == 6
            and resumed.epochs == saved["meta"]["epochs"]
            and state2.step == 6
            and state2.opt_state["count"] == saved["opt_state"]["count"]
            and all(torch.equal(p.cpu(), ref["params"][k])
                    for k, p in state2.params.items())
            and all(torch.equal(v.cpu(), ref[part][k])
                    for part in ("mu", "nu")
                    for k, v in state2.opt_state[part].items()))
        resumed.run()
        torch.cuda.synchronize()
        routed = counters.routed()
        b_counts = {k: counts1[k] - counts0[k] for k in counts1}
        n = LOOP_STEPS["fullbudget"]
        b_want = {k: n * (6 if k.startswith("flash") else 13)
                  for k in per_step}
        b_ok = (b_losses and finite(writer2) and exact
                and resumed.steps == 12 and not any(routed.values())
                and all(b_counts[k] == v for k, v in b_want.items())
                and sorted(trainer.save_blocked_s) == [6, 12])
        emit({"phase": "train_loop", "run": "fullbudget", "card": card,
              "batch": [fb["batch_size"], pft], "run_s": run_s, **rates,
              "corpus_device_gb": dr.nbytes / 1e9, "upload_s": upload_s,
              "peak_memory_gb": peak / 1e9,
              "save_blocked_s": trainer.save_blocked_s,
              "step_after_async_save_s": after_save,
              "sync_save_s": sync_s, "launches": b_counts,
              "launches_expected": b_want, "routed": routed,
              "snapshot_exact": snapshot_exact, "resume_exact": exact,
              "resumed_steps": resumed.steps,
              "losses": {k: v for k, v in {**writer.scalars,
                                           **writer2.scalars}.items()
                         if "loss" in k}, "ok": b_ok})
        emit(dict(phase="train_loop_profile", run="fullbudget", **prof))
        ok &= b_ok
        del model2, opt2, state2, resumed, trainer, dr, ref, saved
        shutil.rmtree(os.path.join(root, "b"), ignore_errors=True)

        # (c) the encoder and the GST frozen
        with torch.device("meta"):
            mask = freeze_mask(Serenade(**cfg), LOOP_FREEZE)
        config = dict(TRAIN_CONFIG, train_max_steps=LOOP_STEPS["freeze"],
                      log_interval_steps=1, eval_interval_steps=10 ** 9,
                      save_interval_steps=10 ** 9, async_checkpointing=False)
        model, opt, state = fresh(trainable=mask)
        before = {k: p.detach().clone() for k, p in state.params.items()}
        log, writer = _StepLog(), _Writer()
        loader = ShardedBatchLoader(corpus, SSCCollater(), batch_size=4,
                                    seed=3)
        trainer = SSCTrainer(
            config, _recorded_step(torch, build_train_step(
                model, opt, device=dev), log, host_shape),
            state, loader, writer=writer, outdir=os.path.join(root, "c"),
            generator=torch.Generator(device=dev).manual_seed(2))
        trainer.run()
        frozen = [k for k, v in mask.items() if not v]
        unchanged = [k for k, p in state.params.items()
                     if torch.equal(p, before[k])]
        grads = [p.grad for p in state.params.values()]
        all_norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads])))
        logged = float(log.metrics["train/grad_norm"])
        frozen_grads = all(state.params[k].grad is not None
                           and bool(state.params[k].grad.abs().amax() > 0)
                           for k in frozen)
        c_ok = (sorted(unchanged) == sorted(frozen) and bool(frozen)
                and frozen_grads and finite(writer)
                and abs(logged - all_norm) <= 1e-5 * all_norm
                and set(state.opt_state["mu"]) == {k for k, v in
                                                   mask.items() if v}
                and not any(counters.routed().values()))
        emit({"phase": "train_loop", "run": "freeze", "card": card,
              "frozen_prefixes": LOOP_FREEZE, "frozen_tensors": len(frozen),
              "trainable_tensors": len(mask) - len(frozen),
              "unchanged_tensors": len(unchanged),
              "frozen_have_gradients": frozen_grads,
              "grad_norm_logged": logged, "grad_norm_all": all_norm,
              "ok": c_ok})
        ok &= c_ok
        del model, opt, state, trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = counters.read()
    emit({"phase": "train_loop_done", "seconds": time.time() - t0,
          "setup_s": setup_s, "launches": launches, "ok": bool(ok)})
    return bool(ok), launches


# ---------------------------------------------------------------------------
# phase 12: the F0-fluctuation variant
# ---------------------------------------------------------------------------

# phase 2's rows at the variant's first Block1D, Cin 244: (B, T, Cin,
# dtype, lengths, tolerance); dtype by name, resolved in the checks
VARIANT_CHECKS = (
    (1, 1536, 244, "bfloat16", [1536], 2e-2),
    (16, 1280, 244, "bfloat16", LOOP_CHECKS[0][2], 2e-2),
    (2, 150, 244, "float32", [150, 77], 1e-4))
VARIANT_REQUESTS = 4                 # (1024, 512) conversions
VARIANT_SERVE, VARIANT_STYLE = 8, 512
# the serve part's window: long enough that all nine clients arrive in it
# (a full window of 8 closes at once), so each bucket is one batch
VARIANT_SERVE_WAIT_MS = 2000.0
VARIANT_STREAM_FRAMES = 2000         # 20 s: 3 chunks at 1024/128
VARIANT_CHUNK = (1024, 128)
VARIANT_UTTS, VARIANT_STEPS = 32, 6


def _fluc_feats(np, rng, frames, with_mel, input_dim=768):
    """``_features`` and an F0 fluctuation of a sung track's scale."""
    feats = _features(np, rng, frames, with_mel, input_dim=input_dim)
    feats["f0_fluc"] = 0.02 * rng.normal(size=(frames, 1))
    return feats


def variant_convert(torch, np, dev, counters, conv, card):
    """Phase 12 (a) and (b): four (1024, 512) feature conversions, then
    convert_wav of phase 3b's waveforms with ``f0_fluc`` extracted on the
    card and held against the CPU's extraction."""
    from serenade_tpu_torch import features

    rng = np.random.default_rng(120)
    feats = [(_fluc_feats(np, rng, 1024, False),
              _fluc_feats(np, rng, 512, True))
             for _ in range(VARIANT_REQUESTS)]
    conv.convert_features(*feats[0])            # warm-up
    torch.cuda.synchronize()
    counters.reset()
    runs, right = [], True
    for src, ref in feats:
        t0 = time.perf_counter()
        mel, wav, _ = conv.convert_features(src, ref)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        right &= (mel.shape == (1024, 80) and wav.shape == (1024 * HOP,)
                  and bool(np.isfinite(mel).all())
                  and bool(np.isfinite(wav).all()))
    launches, routed = counters.read(), counters.routed()
    parts = [launches]
    n = len(runs)
    counts_ok = (launches["flash_fwd"] == 60 * n
                 and launches["block1d_fwd"] == 130 * n
                 and launches["resblock_branch"] >= 9 * n
                 and not any(routed.values()))
    a_ok = right and counts_ok
    emit({"phase": "variant", "part": "convert_features", "card": card,
          "request": [1024, 512], "wall_s": runs,
          "mean_rtf": sum(runs) / n / (1024 * HOP / SR),
          "launches": launches, "routed": routed, "ok": a_ok})

    src = sung(np, SOURCE_S, 50, 196.0)
    ref = sung(np, REFERENCE_S, 51, 262.0)
    conv.convert_wav(src, ref, SR)                  # warm-up
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    fs = conv.extract_from_wav(src, SR, "src")
    fr = conv.extract_from_wav(ref, SR, "ref")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mel, wav, _ = conv.convert_features(fs, fr)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches, routed = counters.read(), counters.routed()
    parts.append(launches)
    # the CPU's extraction of the same waveform: F0 and the fluctuation
    # need no ContentVec
    fc = features.FeatureConfig.from_dict(conv.config)
    cpu = features.extract_features("src", src, SR, fc, with_f0_fluc=True,
                                    f0_range=(70.0, 1100.0), device="cpu")
    got = fs["f0_fluc"][:, 0]
    want = cpu["f0_fluc"][:len(got), 0]
    vuv = fs["vuv"][:, 0] == cpu["vuv"][:len(got), 0]
    err = np.abs(got - want)
    fluc = {"frames": len(got), "vuv_agree": float(vuv.mean()),
            "max_abs_err": float(err[vuv].max()),
            "mean_abs_err": float(err.mean()), "tol": 2e-3,
            "ok": bool(vuv.mean() >= 0.995 and err[vuv].max() <= 2e-3
                       and got.dtype == np.float32)}
    b_ok = (fluc["ok"] and mel.shape == (1024, 80)
            and bool(np.isfinite(wav).all())
            and launches["flash_fwd"] == 60
            and launches["block1d_fwd"] == 130
            and launches["resblock_branch"] >= 9
            and launches["viterbi_f0"] == 2 and not any(routed.values()))
    emit({"phase": "variant", "part": "convert_wav", "card": card,
          "source_s": SOURCE_S, "reference_s": REFERENCE_S,
          "extract_s": t1 - t0, "convert_s": t2 - t1, "wall_s": t2 - t0,
          "rtf": (t2 - t0) / SOURCE_S, "f0_fluc": fluc,
          "launches": launches, "routed": routed, "ok": b_ok})
    return a_ok and b_ok, parts


def variant_parity(torch, np, dev, counters):
    """Phase 12: batched rows against lone conversions at the same
    buckets, noise rows and shifts (phase 8's rule) with a narrow
    SerenadeNew whose attention keeps head dim 512 (K1 and K2 run), and a
    small f32 conversion on the card against the CPU (phase 4's rule)."""
    from serenade_tpu_torch.api import Converter

    cfg = dict(input_dim=32, output_dim=80, encoder_channels=16,
               encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
               decoder_attention_head_dim=512, gst_tokens=10,
               gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16)
    rng = np.random.default_rng(121)
    frames = ((150, 100), (100, 64), (70, 90))
    srcs = [_fluc_feats(np, rng, s, False, input_dim=32) for s, _ in frames]
    refs = [_fluc_feats(np, rng, r, True, input_dim=32) for _, r in frames]
    ts, tr = 192, 128
    x0 = 0.667 * rng.normal(size=(4, tr + ts, 80))
    shifts = [37, 170]

    def run(dtype, device, batched):
        conv = Converter(dict(cfg, dtype=dtype), None,
                         _scaler(np, input_dim=32), n_timesteps=4, seed=5,
                         device=device, model_type="SerenadeNew")
        if batched:
            return np.concatenate(conv.convert_features_batch(
                srcs, refs, ts=ts, tr=tr, pad_batch_pow2=True, x0=x0,
                shifts=shifts))
        return np.concatenate([conv.convert_features_batch(
            [s], [r], ts=ts, tr=tr, x0=x0[i:i + 1], shifts=shifts)[0]
            for i, (s, r) in enumerate(zip(srcs, refs))])

    counters.reset()
    batched, alone = run("bfloat16", dev, True), run("bfloat16", dev, False)
    launches, routed = counters.read(), counters.routed()
    cpu32 = run("float32", "cpu", False)
    gap = np.abs(run("bfloat16", "cpu", False) - cpu32)
    err = np.abs(batched - alone)
    b32, a32 = run("float32", dev, True), run("float32", dev, False)
    err32 = float(np.abs(b32 - a32).max())
    scale = max(1.0, float(np.abs(a32).max()))
    card_cpu = float(np.abs(a32 - cpu32).max())
    ok = (bool(np.isfinite(batched).all())
          and err.mean() <= 1.5 * gap.mean() and err.max() <= 2.0 * gap.max()
          and err32 <= 1e-3 * scale and card_cpu <= 1e-3 * scale
          and launches["flash_fwd"] > 0 and launches["block1d_fwd"] > 0
          and not any(routed.values()))
    emit({"phase": "variant", "part": "parity", "batch": [4, ts, tr],
          "shifts": shifts,
          "bf16_batch": {"max_abs_err": float(err.max()),
                         "mean_abs_err": float(err.mean()),
                         "cpu_gap_max": float(gap.max()),
                         "cpu_gap_mean": float(gap.mean()),
                         "tol": {"mean": 1.5, "max": 2.0}},
          "f32_batch": {"max_abs_err": err32, "scale": scale, "tol": 1e-3},
          "f32_card_vs_cpu": {"max_abs_err": card_cpu, "scale": scale,
                              "tol": 1e-3},
          "launches": launches, "routed": routed, "ok": ok})
    return ok, [launches]


def variant_serve_stream(torch, np, conv, counters, card):
    """Phase 12 (c) and (d): the server with a style that carries its
    ``f0_fluc``: eight /convert_features requests in four buckets at
    max_batch 8 and one without ``f0_fluc`` from nine client threads at
    once, the bad one refused alone and the eight in one batch a bucket
    (one window that outlasts the clients' arrival); then a 20 s feature
    stream against the packed style."""
    import threading
    import urllib.error

    from serenade_tpu_torch.collaters.ssc import bucket_length
    from serenade_tpu_torch.serving import (
        BatchingConverter, decode_response, encode_reference,
        encode_request, make_server,
    )

    rng = np.random.default_rng(122)
    style = _f32(_fluc_feats(np, rng, VARIANT_STYLE, True))
    srcs = [_f32(_fluc_feats(np, rng, n, False))
            for n in (1024, 700, 450, 1200) * 2]
    bad = {k: v for k, v in _f32(_fluc_feats(np, rng, 600, False)).items()
           if k != "f0_fluc"}
    batching = BatchingConverter(conv, max_batch=VARIANT_SERVE,
                                 max_wait_ms=VARIANT_SERVE_WAIT_MS)
    server = make_server(batching, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    bodies = [encode_request(f, "fluc") for f in srcs] + [
        encode_request(bad, "fluc")]
    results, faults = [None] * len(bodies), []

    def client(k):
        t0 = time.perf_counter()
        try:
            out = decode_response(_http(base + "/convert_features",
                                        bodies[k]))
            results[k] = (time.perf_counter() - t0,) + out
        except urllib.error.HTTPError as exc:
            results[k] = ("refused", exc.code, exc.read().decode()[:200])
        except Exception as exc:  # noqa: BLE001 — reported, fails the phase
            faults.append(f"request {k}: {exc!r}")

    try:
        _http(f"{base}/register_reference?name=fluc",
              encode_reference(style))
        counters.reset()
        start = time.perf_counter()
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(len(bodies))]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.perf_counter() - start
        launches, routed = counters.read(), counters.routed()
        health = json.loads(_http(f"{base}/healthz"))
        packed = batching.packed_reference("fluc")
    finally:
        server.shutdown()
        server.server_close()
        batching.close()
        thread.join(timeout=10)
    good = results[:-1]
    refused = results[-1]
    right = all(r is not None and r[0] != "refused"
                and r[1].shape == (f["hubert"].shape[0], 80)
                and r[2].shape == (f["hubert"].shape[0] * HOP,)
                and bool(np.isfinite(r[1]).all())
                for r, f in zip(good, srcs))
    refused_ok = (refused is not None and refused[0] == "refused"
                  and refused[1] == 400 and "f0_fluc" in refused[2])
    batches = health["batches"]
    buckets = len({bucket_length(f["hubert"].shape[0]) for f in srcs})
    # the refused request is the server's one error; the rows of a bucket
    # share one batch, so a request that fell out of co-batching (a
    # variant row the batch path cannot take) fails here
    serve_ok = (right and refused_ok and not faults
                and health["requests"] == len(srcs)
                and health["errors"] == 1 and batches == buckets
                and launches["flash_fwd"] == 60 * batches
                and launches["block1d_fwd"] == 130 * batches
                and not any(routed.values()))
    lat = [r[0] for r in good if r is not None and r[0] != "refused"]
    emit({"phase": "variant", "part": "serve", "card": card,
          "max_batch": VARIANT_SERVE, "max_wait_ms": VARIANT_SERVE_WAIT_MS,
          "requests": len(srcs), "buckets": buckets, "batches": batches,
          "refused": refused_ok and list(refused[:2]),
          "faults": faults[:4], "wall_s": wall,
          "latency_s": {"p50": float(np.percentile(lat, 50)) if lat else None,
                        "max": max(lat, default=None)},
          "errors": health["errors"], "launches": launches,
          "routed": routed, "ok": serve_ok})
    parts = [launches]

    src = _fluc_feats(np, rng, VARIANT_STREAM_FRAMES, False)
    counters.reset()
    t0 = time.perf_counter()
    first, frames, segs = None, 0, 0
    finite = True
    for start, mel, wav in conv.convert_features_stream(
            src, packed, chunk_frames=VARIANT_CHUNK[0],
            overlap_frames=VARIANT_CHUNK[1]):
        if first is None:
            first = time.perf_counter() - t0
        finite &= bool(np.isfinite(mel).all() and np.isfinite(wav).all())
        frames += mel.shape[0]
        segs += 1
    wall = time.perf_counter() - t0
    launches, routed = counters.read(), counters.routed()
    parts.append(launches)
    stream_ok = (finite and frames == VARIANT_STREAM_FRAMES
                 and launches["flash_fwd"] > 0
                 and launches["block1d_fwd"] > 0
                 and launches["resblock_branch"] > 0
                 and not any(routed.values()))
    emit({"phase": "variant", "part": "stream", "card": card,
          "source_s": VARIANT_STREAM_FRAMES * HOP / SR,
          "chunk_overlap": list(VARIANT_CHUNK), "segments": segs,
          "first_audio_s": first, "wall_s": wall,
          "rtf": wall / (VARIANT_STREAM_FRAMES * HOP / SR),
          "launches": launches, "routed": routed, "ok": stream_ok})
    return serve_ok and stream_ok, parts


def variant_train(torch, np, dev, counters, card):
    """Phase 12 (e): ``SSCTrainerNew`` at full width from the card-resident
    corpus (with ``f0_fluc``) at B 16 x 1,280, 6 unsynchronised steps;
    then one small f32 train step on the card against the CPU."""
    from serenade_tpu_torch.configs import (
        TRAIN_CONFIG, TRAIN_CONFIG_FULLBUDGET, serenade_config,
    )
    from serenade_tpu_torch.datasets.device_cache import DeviceResidentData
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.models.serenade_new import SerenadeNew
    from serenade_tpu_torch.trainers import (
        build_optimizer, build_train_step, create_train_state,
    )
    from serenade_tpu_torch.trainers.ssc import SSCTrainerNew

    t0 = time.time()
    rng = np.random.default_rng(123)
    lengths = [int(n) for n in rng.integers(LOOP_FRAMES[0], LOOP_FRAMES[1]
                                            + 1, VARIANT_UTTS)]
    corpus = SeededCorpus(np, lengths, 123)
    for item in corpus.items:
        item["f0_fluc"] = (0.02 * rng.standard_normal(
            (item["hubert"].shape[0], 1))).astype(np.float32)
    fb = dict(TRAIN_CONFIG_FULLBUDGET, train_max_steps=VARIANT_STEPS,
              log_interval_steps=VARIANT_STEPS, eval_interval_steps=10 ** 9,
              save_interval_steps=10 ** 9)
    pft = fb["collater_params"]["pad_frames_to"]
    model = init_params_(SerenadeNew(**serenade_config()), seed=0).to(dev)
    opt, _ = build_optimizer(fb)
    state = create_train_state(model, opt)
    dr = DeviceResidentData(corpus, pad_frames_to=pft,
                            batch_size=fb["batch_size"], seed=0, device=dev)
    log, writer = _StepLog(), _Writer()
    lens = np.minimum(corpus.lengths(), pft)
    trainer = SSCTrainerNew(
        fb, _recorded_step(torch, dr.wrap_step(build_train_step(
            model, opt, device=dev)), log, lambda b: (
            pft, int(lens[b["indices"]].sum()))), state, dr,
        writer=writer, outdir=tempfile.mkdtemp(prefix="chip_smoke_variant_"),
        generator=torch.Generator(device=dev).manual_seed(2))
    trainer.save = lambda step: None       # phase 11 times the saves
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    trainer.run()
    torch.cuda.synchronize()
    shutil.rmtree(trainer.outdir, ignore_errors=True)
    launches, routed = counters.read(), counters.routed()
    rates = _rates(torch, log)
    want = {k: VARIANT_STEPS * v for k, v in TRAIN_LAUNCHES.items()}
    finite = bool(writer.scalars) and all(
        math.isfinite(v) for v in writer.scalars.values())
    train_ok = (finite and launches == want and not any(routed.values())
                and "f0_fluc" in dr.arrays)
    emit({"phase": "variant", "part": "train", "card": card,
          "batch": [fb["batch_size"], pft], "setup_s": setup_s, **rates,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "losses": writer.scalars, "launches": launches,
          "launches_expected": want, "routed": routed, "ok": train_ok})
    del model, opt, state, trainer, dr

    cfg = dict(input_dim=32, output_dim=80, encoder_channels=80,
               encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
               decoder_attention_head_dim=32, gst_tokens=10,
               gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16, dropout=0.0,
               dtype="float32")
    config = dict(TRAIN_CONFIG, optimizer_params=dict(
        TRAIN_CONFIG["optimizer_params"], eps=1e-3))
    b, t = 2, 64
    batch = {"x": rng.normal(size=(b, t, 32)), "lengths": np.array([64, 45]),
             "logmel": rng.normal(size=(b, t, 80)),
             "midi": rng.uniform(size=(b, t, 1)),
             "loud": rng.uniform(size=(b, t, 1)),
             "f0_fluc": 0.02 * rng.normal(size=(b, t, 1))}
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v
             for k, v in batch.items()}
    draws = {"frac": 0.3, "start": 0.4, "t": np.array([0.2, 0.7]),
             "z": rng.normal(size=(b, t, 80))}
    out = []
    for device in ("cpu", dev):
        model = init_params_(SerenadeNew(**cfg), seed=3).to(device)
        opt, _ = build_optimizer(config)
        step = build_train_step(model, opt, device=device)
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
             for k, v in draws.items()}
        d["s1"], d["s2"] = (torch.tensor(s, device=device) for s in (17, 40))
        _, metrics = step(create_train_state(model, opt), batch, None,
                          draws=d)
        out.append(({k: float(v) for k, v in metrics.items()},
                    {n: p.detach().cpu()
                     for n, p in model.named_parameters()}))
    (m_cpu, p_cpu), (m_dev, p_dev) = out
    metric_err = max(abs(m_cpu[k] - m_dev[k]) / max(1.0, abs(m_cpu[k]))
                     for k in m_cpu)
    param_err = max(float((p_cpu[n] - p_dev[n]).abs().max()) for n in p_cpu)
    parity_ok = metric_err <= 1e-4 and param_err <= 1e-5
    emit({"phase": "variant", "part": "train_parity", "metrics_cpu": m_cpu,
          "metrics_card": m_dev, "metric_rel_err": metric_err,
          "param_max_abs_err": param_err,
          "tol": {"metrics": 1e-4, "params": 1e-5}, "ok": parity_ok})
    return train_ok and parity_ok, [launches]


def variant_path(torch, np, dev, counters, card):
    """Phase 12: the F0-fluctuation variant, a seeded full-width
    SerenadeNew with ContentVec and the seeded HiFiGAN, through
    conversion, raw audio, batch parity, the server, a stream and the
    trainer.  Returns (ok, launches of the whole phase)."""
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.configs import (
        CONTENTVEC_CONFIG, VOCODER_CONFIG, serenade_config,
    )

    t0 = time.time()
    conv = Converter(serenade_config(), None, _scaler(np),
                     vocoder_config=VOCODER_CONFIG,
                     vocoder_stats={"mean": np.zeros(80), "scale": np.ones(80)},
                     contentvec_config=CONTENTVEC_CONFIG, n_timesteps=10,
                     solver="euler", seed=0, device=dev,
                     model_type="SerenadeNew")
    setup_s = time.time() - t0
    # each part's counts from its own reset to its read, summed
    ok, parts = True, []
    for run in (lambda: variant_convert(torch, np, dev, counters, conv, card),
                lambda: variant_parity(torch, np, dev, counters),
                lambda: variant_serve_stream(torch, np, conv, counters, card),
                lambda: variant_train(torch, np, dev, counters, card)):
        part_ok, launches = run()
        ok &= part_ok
        parts += launches
    del conv
    totals = {k: sum(p[k] for p in parts) for k in KERNELS}
    emit({"phase": "variant_done", "seconds": time.time() - t0,
          "setup_s": setup_s, "launches": totals, "ok": bool(ok)})
    return bool(ok), totals


# ---------------------------------------------------------------------------
# phase 13: few-step distillation and objective evaluation
# ---------------------------------------------------------------------------

DISTILL_STEPS = {"endpoint": 6, "reflow": 3}
DISTILL_UTTS = 48                    # U(300, 2,900) frames, clamped at 1,280
# a distill step's launches: the teacher's Euler-10 (60 K1, 130 K2 under
# no_grad), then the student's 2-step rollout (12 K1, 26 K2, their
# backward 12 K4, 12 K5, 26 K6, 26 K7) or one reflow loss (a train step's)
DISTILL_LAUNCHES = {
    "endpoint": {"flash_fwd": 72, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                 "block1d_fwd": 156, "block1d_bwd_data": 26,
                 "block1d_bwd_weight": 26, "resblock_branch": 0,
                 "viterbi_f0": 0},
    "reflow": {"flash_fwd": 66, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
               "block1d_fwd": 143, "block1d_bwd_data": 13,
               "block1d_bwd_weight": 13, "resblock_branch": 0,
               "viterbi_f0": 0}}
STUDENT_TURNS = (2, 10, 10, 2)       # Euler steps of (c)'s turns
# (e): each target's converted copies, by suffix
EVAL_SUFFIXES = ("_same", "_shift", "_noise", "_late", "_student")


def _teacher_config():
    from serenade_tpu_torch.configs import (
        TRAIN_CONFIG_FULLBUDGET, serenade_config,
    )

    return dict(TRAIN_CONFIG_FULLBUDGET, model_type="Serenade",
                model_params=serenade_config(), trainer_type="SSCTrainer")


def distill_run(torch, np, dev, counters, card, mode, teacher_sd, corpus,
                root):
    """Phase 13 (a) or (b): ``bin/distill.distill_core`` in ``mode`` from
    the card-resident corpus at B 16 x 1,280, through ``SSCTrainer`` with
    its async saves.  Returns (ok, launches, the student's last
    checkpoint, the line's figures)."""
    from serenade_tpu_torch.bin.distill import distill_config, distill_core
    from serenade_tpu_torch.datasets.device_cache import DeviceResidentData

    n = DISTILL_STEPS[mode]
    base = _teacher_config()
    config = distill_config(base, distill_steps=n, lr=1e-4, student_steps=2,
                            mode=mode, teacher_steps=10, solver="euler")
    pft = base["collater_params"]["pad_frames_to"]
    dr = DeviceResidentData(corpus, pad_frames_to=pft,
                            batch_size=base["batch_size"], seed=0,
                            device=dev)
    outdir = os.path.join(root, mode)
    writer = _Writer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    start = time.time()
    trainer, teacher = distill_core(
        config, teacher_sd, dr, outdir=outdir, mode=mode, student_steps=2,
        teacher_steps=10, temperature=0.667, seed=777, device=dev,
        writer=writer)
    torch.cuda.synchronize()
    run_s = time.time() - start
    launches, routed = counters.read(), counters.routed()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    student = {k: p.detach() for k, p in trainer.state.params.items()}
    frozen_equal = all(
        torch.equal(student[k], teacher_sd[k].to(dev)) for k in student
        if k.startswith(("encoder.", "gst.")))
    unmoved = [k for k in student if k.startswith("cfm_decoder.")
               and torch.equal(student[k], teacher_sd[k].to(dev))]
    teacher_same = all(torch.equal(v, teacher_sd[k].to(dev))
                       for k, v in teacher.state_dict().items())
    losses = {k: v for k, v in writer.scalars.items() if "loss" in k}
    finite = bool(losses) and all(math.isfinite(v) for v in losses.values())
    want = {k: n * v for k, v in DISTILL_LAUNCHES[mode].items()}
    ckpt = os.path.join(outdir, f"checkpoint-{n}steps")

    # the teacher's share of a step: CUDA events around its pass alone and
    # around one more whole step (after the counters were read)
    idx = np.arange(base["batch_size"])
    batch = dr.gather(idx)
    gen = torch.Generator(device=dev).manual_seed(5)
    args = (batch["x"], batch["lengths"], batch["logmel"], batch["midi"],
            batch["loud"])
    spans = []
    for _ in range(3):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        teacher.make_reflow_batch(*args, generator=gen, n_timesteps=10)
        events[1].record()
        trainer.train_step(trainer.state, {"indices": idx}, gen)
        events[2].record()
        spans.append(events)
    torch.cuda.synchronize()
    teacher_ms = [e[0].elapsed_time(e[1]) for e in spans]
    step_ms = [e[1].elapsed_time(e[2]) for e in spans]
    interval = config["save_interval_steps"]
    saves = [s for s in range(1, n + 1) if s % interval == 0 or s == n]
    ok = (finite and frozen_equal and not unmoved and teacher_same
          and launches == want and not any(routed.values())
          and os.path.isdir(ckpt) and sorted(trainer.save_blocked_s) == saves)
    line = {"phase": "distill_eval", "part": mode, "card": card,
            "batch": [base["batch_size"], pft], "steps": n,
            "run_s": run_s, "steps_per_s": n / run_s,
            "teacher_pass_ms": teacher_ms, "distill_step_ms": step_ms,
            "teacher_share": sum(teacher_ms) / sum(step_ms),
            "peak_memory_gb": peak_gb, "losses": losses,
            "save_blocked_s": trainer.save_blocked_s,
            "launches": launches, "launches_expected": want,
            "launches_per_step": {k: v / n for k, v in launches.items()},
            "routed": routed, "frozen_equal": frozen_equal,
            "cfm_tensors_unmoved": unmoved, "teacher_unchanged": teacher_same,
            "ok": ok}
    emit(line)
    del trainer, teacher, dr
    return ok, launches, ckpt


def student_convert(torch, np, dev, counters, card, ckpt, config):
    """Phase 13 (c): the distilled student read back from its checkpoint
    with the distilled config's sampler, as ``Converter.from_expdir``
    reads them, answering phase 3's (1024, 512) request with the seeded
    HiFiGAN; the same Converter at Euler-10 in turns.  Returns (ok,
    launches of the 2-step turns, the last 2-step waveform)."""
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.checkpoint import restore_params_only
    from serenade_tpu_torch.configs import VOCODER_CONFIG

    steps = int(config.get("inference_n_timesteps", 10))
    conv = Converter(config["model_params"], restore_params_only(ckpt),
                     _scaler(np), vocoder_config=VOCODER_CONFIG,
                     vocoder_stats={"mean": np.zeros(80),
                                    "scale": np.ones(80)},
                     n_timesteps=steps,
                     solver=config.get("inference_solver", "euler"),
                     seed=0, device=dev)
    rng = np.random.default_rng(0)
    src, ref = _features(np, rng, 1024, False), _features(np, rng, 512, True)
    conv.convert_features(src, ref)          # warm-up
    torch.cuda.synchronize()
    turns, by_steps, wav = [], {}, None
    for n in STUDENT_TURNS:
        conv.n_timesteps = n
        counters.reset()
        start = time.time()
        mel, out, sr = conv.convert_features(src, ref)
        torch.cuda.synchronize()
        wall = time.time() - start
        launches = counters.read()
        by_steps.setdefault(n, launches)
        good = (mel.shape == (1024, 80) and out.shape == (1024 * HOP,)
                and bool(np.isfinite(mel).all())
                and bool(np.isfinite(out).all()))
        turns.append({"n_timesteps": n, "wall_s": wall,
                      "rtf": wall / (1024 * HOP / SR), "launches": launches,
                      "routed": counters.routed(), "ok": good})
        if n == steps:
            wav = out
    routed_ok = not any(v for t in turns for v in t["routed"].values())
    counts_ok = all(
        by_steps[n]["flash_fwd"] == 6 * n
        and by_steps[n]["block1d_fwd"] == 13 * n
        and by_steps[n]["resblock_branch"] >= 9 for n in by_steps)
    ok = (steps == 2 and routed_ok and counts_ok
          and all(t["ok"] for t in turns))
    emit({"phase": "distill_eval", "part": "student_convert", "card": card,
          "request": [1024, 512], "config_n_timesteps": steps,
          "turns": turns, "ok": ok})
    del conv
    return ok, by_steps[2], wav


def distill_parity(torch, np, dev):
    """Phase 13 (d): one small f32 distill step of each mode on the CPU
    (plain versions) and on the card (kernels) from the same teacher,
    batch and draws, by phase 6's rule."""
    from serenade_tpu_torch.bin.distill import distill_config
    from serenade_tpu_torch.configs import TRAIN_CONFIG
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.models.serenade import Serenade
    from serenade_tpu_torch.trainers import build_optimizer, create_train_state
    from serenade_tpu_torch.trainers.distill import (
        build_distill_step, distill_trainable_mask, frozen_teacher,
    )

    cfg = dict(input_dim=32, output_dim=80, encoder_channels=80,
               encoder_hidden_dim=32, decoder_channels=64, gst_embed_dim=32,
               decoder_attention_head_dim=32, gst_tokens=10,
               gst_conv_chans=(8, 8, 16, 16), gst_gru_units=16, dropout=0.0,
               dtype="float32")
    rng = np.random.default_rng(13)
    b, t = 2, 64
    batch = {"x": rng.normal(size=(b, t, 32)), "lengths": np.array([64, 45]),
             "logmel": rng.normal(size=(b, t, 80)),
             "midi": rng.uniform(size=(b, t, 1)),
             "loud": rng.uniform(size=(b, t, 1))}
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v
             for k, v in batch.items()}
    draws = {"frac": 0.7, "start": 0.2, "t": np.array([0.3, 0.8]),
             "x0": 0.667 * rng.normal(size=(b, t, 80))}
    sd = init_params_(Serenade(**cfg), seed=3).state_dict()
    lines, ok = [], True
    for mode in ("endpoint", "reflow"):
        # eps 1e-3: with 1e-8 a gradient whose sign is only rounding
        # becomes a step of the full learning rate on one side
        config = distill_config(dict(TRAIN_CONFIG, optimizer_params=dict(
            TRAIN_CONFIG["optimizer_params"], eps=1e-3)), distill_steps=1,
            lr=1e-4, student_steps=2, mode=mode, teacher_steps=3,
            solver="euler")
        out = []
        for device in ("cpu", dev):
            models = []
            for _ in range(2):
                m = Serenade(**cfg)
                m.load_state_dict(sd)
                models.append(m.to(device))
            teacher, student = frozen_teacher(models[0]), models[1]
            opt, _ = build_optimizer(
                config, trainable_mask=distill_trainable_mask(student))
            step = build_distill_step(student, teacher, opt, mode=mode,
                                      n_teacher_steps=3, device=device)
            d = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                 for k, v in draws.items()}
            _, metrics = step(create_train_state(student, opt), batch, None,
                              draws=d)
            out.append(({k: float(v) for k, v in metrics.items()},
                        {n: p.detach().cpu()
                         for n, p in student.named_parameters()}))
        (m_cpu, p_cpu), (m_dev, p_dev) = out
        metric_err = max(abs(m_cpu[k] - m_dev[k]) / max(1.0, abs(m_cpu[k]))
                         for k in m_cpu)
        param_err = max(float((p_cpu[n] - p_dev[n]).abs().max())
                        for n in p_cpu)
        mode_ok = metric_err <= 1e-4 and param_err <= 1e-5
        ok &= mode_ok
        lines.append({"mode": mode, "metrics_cpu": m_cpu,
                      "metrics_card": m_dev, "metric_rel_err": metric_err,
                      "param_max_abs_err": param_err, "ok": mode_ok})
    emit({"phase": "distill_eval", "part": "parity", "runs": lines,
          "tol": {"metrics": 1e-4, "params": 1e-5}, "ok": bool(ok)})
    return bool(ok)


def _pitch_shifted(np, wav, cents):
    ratio = 2.0 ** (cents / 1200.0)
    n = int(len(wav) / ratio)
    return np.interp(np.arange(n) * ratio, np.arange(len(wav)),
                     wav).astype(np.float32)


def _analysis_groups(np, lengths):
    """The batched analyses ``metrics.extract_eval_feats_batch`` runs
    over waveforms of these lengths: one a length bucket and 8 rows."""
    bucket = 128 * (SR * 5 // 1000)
    groups = {}
    for n in lengths:
        groups[-(-n // bucket)] = groups.get(-(-n // bucket), 0) + 1
    return sum(-(-c // 8) for c in groups.values())


def evaluate_run(torch, np, dev, counters, card, student_wav):
    """Phase 13 (e): ``bin/evaluate.main`` over two wav directories, with
    ``--device cuda`` and ``--device cpu``.  Targets: phase 3b's four
    waveforms; converted, for each: an identical copy, one 100 cents up,
    one with noise 20 dB down, one 60 ms late, and (c)'s 2-step
    conversion beside the 10.24 s target.  Returns (ok, the card run's
    launches)."""
    from serenade_tpu_torch.bin.evaluate import main as evaluate_main
    from serenade_tpu_torch.utils.audio import write_wav

    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    conv_dir, tgt_dir = (os.path.join(root, d) for d in ("conv", "tgt"))
    os.makedirs(conv_dir)
    os.makedirs(tgt_dir)
    rng = np.random.default_rng(14)
    converted, targets = [], []
    for i, w in enumerate(feature_wavs(np)):
        write_wav(os.path.join(tgt_dir, f"w{i}.wav"), w, SR)
        targets.append(len(w))
        copies = {"_same": w, "_shift": _pitch_shifted(np, w, 100.0),
                  "_noise": w + 0.1 * float(np.std(w)) * rng.normal(
                      size=len(w)).astype(np.float32),
                  "_late": np.concatenate(
                      [np.zeros(int(0.06 * SR), np.float32), w])}
        if abs(len(w) - SOURCE_S * SR) < HOP:
            copies["_student"] = student_wav
        for suffix, c in copies.items():
            write_wav(os.path.join(conv_dir, f"w{i}{suffix}.wav"), c, SR)
            converted.append(len(c))
    # the CLI analyses the converted wavs, then every pair's target
    want_viterbi = (_analysis_groups(np, converted)
                    + _analysis_groups(np, [targets[int(s)] for s in [
                        name[1] for name in sorted(os.listdir(conv_dir))]]))
    argv = ["--converted-dir", conv_dir, "--target-dir", tgt_dir,
            "--strip-suffixes", *EVAL_SUFFIXES, "--verbose", "0"]
    runs = {}
    for device in ("cuda", "cpu"):
        counters.reset()
        start = time.time()
        result = evaluate_main(argv + ["--device", device])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - start
        runs[device] = {"result": result, "wall_s": wall,
                        "launches": counters.read(),
                        "routed": counters.routed()}
    shutil.rmtree(root, ignore_errors=True)
    audio_s = (sum(converted) + sum(
        targets[int(name[1])] for name in runs["cuda"]["result"][
            "per_utterance"])) / SR
    card_run, cpu_run = runs["cuda"], runs["cpu"]
    per, per_cpu = (r["result"]["per_utterance"] for r in (card_run, cpu_run))
    tol = {"mcd_db": 0.02, "f0_rmse_cents": 1.0, "vuv_error": 0.01}
    diffs = {k: max(abs(per[s][k] - per_cpu[s][k]) for s in per
                    if per[s][k] is not None) for k in tol}
    same = [per[s] for s in per if s.endswith("_same")]
    ok = (set(per) == set(per_cpu) and len(per) == len(converted)
          and all(diffs[k] <= tol[k] for k in tol)
          and all(m["mcd_db"] < 0.05 and m["vuv_error"] == 0.0
                  for m in same)
          and all(math.isfinite(m["mcd_db"]) for m in per.values())
          and card_run["launches"]["viterbi_f0"] == want_viterbi
          and not any(card_run["routed"].values()))
    emit({"phase": "distill_eval", "part": "evaluate", "card": card,
          "pairs": len(per), "audio_s": audio_s,
          "summary_card": card_run["result"]["summary"],
          "summary_cpu": cpu_run["result"]["summary"],
          "per_utterance_card": per, "max_diff_card_cpu": diffs, "tol": tol,
          "wall_s": {d: r["wall_s"] for d, r in runs.items()},
          "s_per_audio_s": {d: r["wall_s"] / audio_s
                            for d, r in runs.items()},
          "launches": card_run["launches"], "viterbi_expected": want_viterbi,
          "routed": card_run["routed"], "ok": ok})
    return ok, card_run["launches"]


def distill_eval_path(torch, np, dev, counters, card):
    """Phase 13: few-step distillation at full width (a: endpoint, b:
    reflow) from seeded teacher weights, the student through the Converter
    (c), a small distill step on the card against the CPU (d), and the
    evaluation CLI on the card and on the CPU (e).  Returns (ok, launches
    of the whole phase)."""
    from serenade_tpu_torch.bin.distill import distill_config
    from serenade_tpu_torch.configs import serenade_config
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.models.serenade import Serenade

    t0 = time.time()
    rng = np.random.default_rng(13)
    lengths = [int(n) for n in rng.integers(LOOP_FRAMES[0], LOOP_FRAMES[1]
                                            + 1, DISTILL_UTTS)]
    corpus = SeededCorpus(np, lengths, 13)
    teacher_sd = init_params_(Serenade(**serenade_config()),
                              seed=0).state_dict()
    root = tempfile.mkdtemp(prefix="chip_smoke_distill_")
    ok, parts = True, []
    try:
        for mode in ("endpoint", "reflow"):
            part_ok, launches, ckpt = distill_run(
                torch, np, dev, counters, card, mode, teacher_sd, corpus,
                root)
            ok &= part_ok
            parts.append(launches)
            if mode == "endpoint":
                student_ckpt = ckpt
        config = distill_config(_teacher_config(), distill_steps=6,
                                lr=1e-4, student_steps=2, mode="endpoint",
                                teacher_steps=10, solver="euler")
        part_ok, launches, wav = student_convert(
            torch, np, dev, counters, card, student_ckpt, config)
        ok &= part_ok
        parts.append(launches)
        ok &= distill_parity(torch, np, dev)
        part_ok, launches = evaluate_run(torch, np, dev, counters, card, wav)
        ok &= part_ok
        parts.append(launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    totals = {k: sum(p[k] for p in parts) for k in KERNELS}
    emit({"phase": "distill_eval_done", "seconds": time.time() - t0,
          "launches": totals, "ok": bool(ok)})
    return bool(ok), totals


# ---------------------------------------------------------------------------
# phase 14: deployment (int8 weights, exported artifacts, the artifact
# server)
# ---------------------------------------------------------------------------

QUANT_MODES = (None, "int8", "int8_compute")
QUANT_REPS = 3                       # timed (1024, 512) conversions a mode
# the main path's bucket and the decode's largest (phase 10's 1,200-frame
# sources and 600-frame styles), each with a request it is picked for;
# the int8 artifact takes the first alone, for the card and the CPU
DEPLOY_BUCKETS = ((1024, 512), (1216, 640))
DEPLOY_REQUESTS = ((1000, 500), (1200, 600))
DEPLOY_HTTP = (4, 8)                 # artifact server: clients, requests
# the custom ops each program holds: in the ODE step's loop body K1 (6)
# and K2 (13) once, beside it K3 (9 branches)
PROGRAM_OPS = {"flash_fwd": 6, "block1d_fwd": 13, "resblock_branch": 9}
# JAX's size bounds (``tests/test_quantize.py``) on int8 bytes over the
# parameters' bytes at 4 a parameter: resident on the card, and as an
# artifact
QUANT_BOUND, ARTIFACT_BOUND = 0.35, 0.45
INT8_DOT_SHAPES = ((1536, 512, 2048), (1, 2048, 512))   # (m, k, n)


def _resident(torch, build):
    """(what ``build`` returns, the device bytes it left allocated)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = build()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_allocated() - before


def quantized_convert(torch, np, dev, counters, card):
    """Phase 14a: the mel-only Converter at full width with f32 weights
    (stored bf16 where the layer computes bf16), ``quantize="int8"`` and
    ``"int8_compute"``, one seed, Euler-10, the same noise: parameter
    bytes resident on the card, the (1024, 512) request's wall, the mel
    gap to the f32 weights', launches a conversion.  Gates: the int8
    weights' bytes under 0.35x the f32 parameters' at 4 bytes each
    (JAX's bound on ``quantized_bytes``, ``tests/test_quantize.py``), and
    under 0.35x that over the f32 Converter's stored bytes times its
    resident bytes."""
    from serenade_tpu_torch import quantize as pq
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.configs import serenade_config

    rng = np.random.default_rng(14)
    src, ref = (_f32(_features(np, rng, 1024, False)),
                _f32(_features(np, rng, 512, True)))
    x0 = (0.667 * rng.normal(size=(1, 512 + 1024, 80))).astype(np.float32)
    rows, mels, ok = {}, {}, True
    quantized = None
    for mode in QUANT_MODES:
        conv, resident = _resident(torch, lambda: Converter(
            serenade_config(), None, _scaler(np), n_timesteps=10, seed=0,
            device=dev, quantize=mode))
        conv.convert_features(src, ref, x0=x0)            # warm-up
        torch.cuda.synchronize()
        counters.reset()
        pq.launches = pq.routed = 0
        walls = []
        for _ in range(QUANT_REPS):
            start = time.time()
            mel, _, _ = conv.convert_features(src, ref, x0=x0)
            torch.cuda.synchronize()
            walls.append(time.time() - start)
        launches = {k: v // QUANT_REPS for k, v in counters.read().items()}
        mels[mode] = mel
        if mode is None:
            f32_bytes = 4 * sum(p.numel() for p in conv.model.parameters())
            # as the f32 Converter stores them: bf16 where a layer
            # computes bf16 (``store_compute_weights_``)
            stored_bytes = sum(p.numel() * p.element_size()
                               for p in conv.model.parameters())
        row = {"resident_bytes": resident, "wall_s": walls,
               "launches": launches,
               "routed": counters.routed(),
               "int8_dot": {"int_mm": pq.launches // QUANT_REPS,
                            "routed": pq.routed // QUANT_REPS},
               "finite": bool(np.isfinite(mel).all())}
        if mode == "int8":
            quantized = launches
            # JAX's measure: int8 values and f32 scales, the rest at f32
            row["quantized_bytes"] = sum(
                qt.q.numel() + 4 * qt.scale.numel()
                for qt, _ in conv._qweights.values()) + 4 * sum(
                p.numel() for p in conv.model.parameters())
        ok &= (row["finite"] and launches["flash_fwd"] == 60
               and launches["block1d_fwd"] == 130
               and not any(row["routed"].values()))
        rows[str(mode)] = row
        del conv
        torch.cuda.empty_cache()
    for mode in ("int8", "int8_compute"):
        gap = np.abs(mels[mode] - mels[None])
        rows[mode]["mel_gap_to_f32"] = {"max": float(gap.max()),
                                        "mean": float(gap.mean())}
    ratio = rows["int8"]["resident_bytes"] / f32_bytes
    # against the f32 Converter's own resident bytes, JAX's bound scaled
    # by the parameters' bytes at 4 over their bytes as stored
    resident_ratio = (rows["int8"]["resident_bytes"]
                      / rows["None"]["resident_bytes"])
    resident_bound = QUANT_BOUND * f32_bytes / stored_bytes
    ok &= (ratio < QUANT_BOUND and resident_ratio < resident_bound
           and rows["int8_compute"]["int8_dot"]["int_mm"] > 0)
    emit({"phase": "deploy", "part": "quantized", "card": card,
          "modes": rows, "f32_param_bytes": f32_bytes,
          "f32_stored_param_bytes": stored_bytes,
          "int8_over_f32_params": ratio, "bound": QUANT_BOUND,
          "int8_over_f32_resident": resident_ratio,
          "resident_bound": resident_bound, "ok": bool(ok)})
    return bool(ok), quantized


def int8_dot_check(torch, dev, card):
    """Phase 14b: ``int8_matmul`` on the card (``torch._int_mm``, or the
    plain f64 product for a shape it refuses) against its exact plain
    version on the same int8 operands: the int32 sums equal."""
    from serenade_tpu_torch import quantize as pq

    gen = torch.Generator(device=dev).manual_seed(14)
    rows, ok = [], True
    for m, k, n in INT8_DOT_SHAPES:
        a, w = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int8)
                for shape in ((m, k), (n, k)))
        pq.launches = pq.routed = 0
        got = pq.int8_matmul(a, w)
        route = "int_mm" if pq.launches else "plain"
        equal = bool(torch.equal(got, pq.int8_matmul_plain(a, w)))
        ok &= equal
        rows.append({"m": m, "k": k, "n": n, "route": route, "equal": equal,
                     "ms": cuda_ms(torch, lambda: pq.int8_matmul(a, w), 20),
                     "plain_ms": cuda_ms(
                         torch, lambda: pq.int8_matmul_plain(a, w), 20)})
    emit({"phase": "deploy", "part": "int8_dot", "card": card,
          "cases": rows, "ok": bool(ok)})
    return bool(ok)


def _dir_bytes(art, suffix=".pt2"):
    return {f: os.path.getsize(os.path.join(art, f))
            for f in sorted(os.listdir(art)) if f.endswith(suffix)}


def artifact_run(torch, np, dev, counters, card, quantize, buckets, root,
                 platforms):
    """Phase 14c: a full-width Converter with the seeded HiFiGAN exported
    at ``buckets`` for ``platforms`` (None: the Converter's device and the
    CPU), its CUDA programs loaded and held against the live Converter at
    one seed, a request each bucket picks: mel within phase 4's f32
    tolerance (1e-3 of max(1, |mel|)), the waveform away from its last 16
    frames within 1e-3; each program's custom ops (in the manifest and
    the loaded graph) and a conversion's launches at the live Converter's
    60 K1, 130 K2 and 9 K3, 0 routed in both.  A CPU program is loaded
    and its custom ops counted.  Returns (ok, the first request's
    launches, the artifact's directory, {parameters, their f32 bytes as
    stored})."""
    from serenade_tpu_torch import deploy
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.configs import VOCODER_CONFIG, serenade_config

    conv = Converter(serenade_config(), None, _scaler(np),
                     vocoder_config=VOCODER_CONFIG,
                     vocoder_stats={"mean": np.zeros(80),
                                    "scale": np.ones(80)},
                     n_timesteps=10, seed=0, device=dev, quantize=quantize)
    art = os.path.join(root, str(quantize or "f32"))
    start = time.time()
    man = deploy.export_converter(conv, art, buckets=buckets,
                                  platforms=platforms)
    export_s = time.time() - start
    start = time.time()
    exp = deploy.load(art, seed=3, device=dev)
    load_s = time.time() - start
    rng = np.random.default_rng(15)
    ok, rows, first = True, [], None
    for (t_src, t_ref), bucket in zip(DEPLOY_REQUESTS, buckets):
        name = "convert_s%d_r%d" % bucket
        src, ref = (_f32(_features(np, rng, t_src, False)),
                    _f32(_features(np, rng, t_ref, True)))
        exp.convert_features(src, ref)             # first call: warm-up
        runs = {}
        for run, gen in (("live", conv.generator),
                         ("artifact", exp.generator)):
            gen.manual_seed(3)
            torch.cuda.synchronize()
            counters.reset()
            start = time.time()
            mel, wav, _ = (conv if run == "live" else exp).convert_features(
                src, ref)
            torch.cuda.synchronize()
            runs[run] = {"wall_s": time.time() - start, "mel": mel,
                         "wav": wav, "launches": counters.read(),
                         "routed": counters.routed()}
        live, got = runs["live"], runs["artifact"]
        ops = deploy.program_ops(exp.programs[name])
        cut = (live["mel"].shape[0] - 16) * HOP
        mel_err = float(np.abs(got["mel"] - live["mel"]).max())
        wav_err = float(np.abs(got["wav"][:cut] - live["wav"][:cut]).max())
        scale = max(1.0, float(np.abs(live["mel"]).max()))
        counts = [{k: r["launches"][k] for k in PROGRAM_OPS}
                  for r in (live, got)]
        row_ok = (mel_err / scale <= 1e-3 and wav_err <= 1e-3
                  and ops == PROGRAM_OPS
                  and man["custom_ops"][name][dev.type] == ops
                  and counts[0] == counts[1] == {
                      "flash_fwd": 60, "block1d_fwd": 130,
                      "resblock_branch": 9}
                  and not any(live["routed"].values())
                  and not any(got["routed"].values())
                  and got["mel"].shape == (t_src, 80)
                  and bool(np.isfinite(got["wav"]).all()))
        ok &= row_ok
        first = first or got["launches"]
        rows.append({"request": [t_src, t_ref], "bucket": list(bucket),
                     "live_wall_s": live["wall_s"],
                     "convert_wall_s": got["wall_s"],
                     "mel_max_abs_err": mel_err, "mel_scale": scale,
                     "wav_interior_max_abs_err": wav_err,
                     "program_ops": ops, "launches": got["launches"],
                     "live_launches": live["launches"],
                     "routed": got["routed"], "ok": bool(row_ok)})
    cpu = {}
    if "cpu" in man["platforms"]:
        start = time.time()
        exp_cpu = deploy.load(art, seed=3, device="cpu")
        cpu["load_s"] = time.time() - start
        cpu["program_ops"] = {n: deploy.program_ops(p)
                              for n, p in exp_cpu.programs.items()}
        cpu["ok"] = all(o == PROGRAM_OPS == man["custom_ops"][n]["cpu"]
                        for n, o in cpu["program_ops"].items())
        ok &= cpu["ok"]
        del exp_cpu
    emit({"phase": "deploy", "part": "artifact", "card": card,
          "quantize": quantize, "buckets": [list(b) for b in buckets],
          "platforms": man["platforms"], "export_s": export_s,
          "export_s_per_program": man["export_seconds"], "load_s": load_s,
          "bytes": _dir_bytes(art), "requests": rows, "cpu_program": cpu,
          "ok": bool(ok)})
    params = list(conv.model.parameters()) + list(
        conv.vocoder.model.parameters())
    sizes = {"numel": sum(p.numel() for p in params) + sum(
        qt.q.numel() for qt, _ in conv._qweights.values()),
        "stored_bytes": sum(p.numel() * p.element_size() for p in params)}
    del conv, exp
    torch.cuda.empty_cache()
    return bool(ok), first, art, sizes


def artifact_server(torch, np, dev, card, art):
    """Phase 14d: ``ArtifactService`` over the f32 artifact behind
    ``serving.make_server`` on 127.0.0.1:0: a style registered, then
    ``DEPLOY_HTTP`` clients post (1024, 512) /convert_features requests
    naming it; latency p50/p95 on the clients' clocks, and /convert_wav
    refused with 400."""
    import threading
    import urllib.error
    from concurrent.futures import ThreadPoolExecutor

    from serenade_tpu_torch.deploy import ArtifactService
    from serenade_tpu_torch.serving import (
        decode_response, encode_request, make_server,
    )

    service = ArtifactService(art, seed=4, device=dev)
    rng = np.random.default_rng(16)
    service.register_reference("style", _f32(_features(np, rng, 512, True)))
    src = _f32(_features(np, rng, 1024, False))
    body = encode_request(src, "style")
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _http(url + "/convert_features", body)       # warm-up

        def one(_):
            start = time.time()
            mel, wav, _ = decode_response(_http(url + "/convert_features",
                                                body))
            return (time.time() - start, mel.shape == (1024, 80)
                    and bool(np.isfinite(wav).all()))

        clients, n = DEPLOY_HTTP
        start = time.time()
        with ThreadPoolExecutor(clients) as pool:
            results = list(pool.map(one, range(n)))
        wall = time.time() - start
        try:
            _http(url + "/convert_wav", b"RIFF")
            refused = False
        except urllib.error.HTTPError as exc:
            refused = exc.code == 400
        health = json.loads(_http(url + "/healthz"))
    finally:
        server.shutdown()
        server.server_close()
    lat = [r[0] for r in results]
    ok = all(r[1] for r in results) and refused
    emit({"phase": "deploy", "part": "server", "card": card,
          "clients": clients, "requests": n, "wall_s": wall,
          "latency_s": {"p50": float(np.percentile(lat, 50)),
                        "p95": float(np.percentile(lat, 95))},
          "audio_s_per_s": n * 1024 * HOP / SR / wall,
          "convert_wav_refused": refused, "healthz": health,
          "ok": bool(ok)})
    return bool(ok)


def deploy_path(torch, np, dev, counters, card):
    """Phase 14: int8 Converters (a), ``int8_dot`` on the card (b), the
    f32 artifact at both buckets for the card, and the int8 artifact at
    the main path's for the card and the CPU (the export's default),
    exported, loaded and run (c), the artifact server (d).  Gates beside
    each part's: the int8 artifact's bytes under 0.45x the f32 parameters
    it was made from at 4 bytes each (JAX's bound on its artifacts,
    ``tests/test_quantize.py``), and under 0.45x that over the f32
    artifact's stored parameter bytes times the f32 artifact's bytes.
    Returns (ok, {"deploy": the f32 artifact's launches a conversion,
    "quantized": the int8 Converter's})."""
    t0 = time.time()
    ok, quantized = quantized_convert(torch, np, dev, counters, card)
    ok &= int8_dot_check(torch, dev, card)
    root = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    try:
        art_ok, deployed, art, f32 = artifact_run(
            torch, np, dev, counters, card, None, DEPLOY_BUCKETS, root,
            (dev.type,))
        ok &= art_ok
        q_ok, _, art_q, _ = artifact_run(
            torch, np, dev, counters, card, "int8", DEPLOY_BUCKETS[:1], root,
            None)
        ok &= q_ok
        main = f"convert_s1024_r512.{dev.type}.pt2"
        q_bytes = _dir_bytes(art_q)[main]
        f32_art = _dir_bytes(art)[main]
        sizes = {"int8_bytes": q_bytes, "f32_artifact_bytes": f32_art,
                 "f32_param_bytes": 4 * f32["numel"],
                 "f32_stored_param_bytes": f32["stored_bytes"],
                 "int8_over_f32_params": q_bytes / (4 * f32["numel"]),
                 "bound": ARTIFACT_BOUND,
                 "int8_over_f32_artifact": q_bytes / f32_art,
                 "artifact_bound": (ARTIFACT_BOUND * 4 * f32["numel"]
                                    / f32["stored_bytes"])}
        sizes["ok"] = bool(
            sizes["int8_over_f32_params"] < ARTIFACT_BOUND
            and sizes["int8_over_f32_artifact"] < sizes["artifact_bound"])
        ok &= sizes["ok"]
        emit({"phase": "deploy", "part": "sizes", "card": card, **sizes})
        ok &= artifact_server(torch, np, dev, card, art)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "deploy_done", "seconds": time.time() - t0,
          "ok": bool(ok)})
    zeros = {k: 0 for k in KERNELS}
    return bool(ok), {"deploy": dict(zeros, **deployed),
                      "quantized": dict(zeros, **quantized)}


# ---------------------------------------------------------------------------
# phase 15: SiFiGAN post-processing (recipe stage 9)
# ---------------------------------------------------------------------------

POST_REPS = 3              # timed full-width syntheses


def _synced(torch, fn):
    """(result, host seconds) of ``fn`` ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def post_analysis(torch, np, dev, counters, card):
    """(b): Harvest, band aperiodicity, D4C and CheapTrick of phase 3b's
    waveforms at 5 ms frames, each on its 128-hop bucket as stage 9 runs
    them: timed on the card (a warm-up call first), and ``sp2mc`` of the
    envelopes on the host; every waveform also on the CPU, held by phase
    3b's card-vs-CPU F0 rule (vuv on 99.5 % of frames, f0 within 1e-3
    relative where both are voiced) and the aperiodicity within 1e-2 dB
    (both from the card's F0)."""
    from serenade_tpu_torch.features import _bucketed
    from serenade_tpu_torch.ops.f0 import smooth_f0_median
    from serenade_tpu_torch.ops.harvest import harvest_f0
    from serenade_tpu_torch.ops.sptk import sp2mc
    from serenade_tpu_torch.ops.world import band_aperiodicity, cheaptrick, d4c

    hop = SR // 200
    lo, hi = 80.0, 1100.0
    ops = {"harvest": lambda x, f0: harvest_f0(
               x, fs=SR, f0_floor=lo, f0_ceil=hi, frame_period_ms=5.0),
           "bandap": lambda x, f0: band_aperiodicity(x, f0, fs=SR),
           "d4c": lambda x, f0: d4c(x, f0, fs=SR),
           "cheaptrick": lambda x, f0: cheaptrick(x, f0, fs=SR)}
    wavs = feature_wavs(np)
    audio_s = sum(len(w) for w in wavs) / SR
    inputs = [torch.from_numpy(_bucketed(w, hop)[0]).to(dev) for w in wavs]
    # the first calls (filter banks, FFT plans) apart: Harvest's F0, and a
    # call of each aperiodicity at each length
    f0s = [smooth_f0_median(ops["harvest"](x, None)[0]) for x in inputs]
    for x, f0 in zip(inputs, f0s):
        ops["bandap"](x, f0), ops["d4c"](x, f0), ops["cheaptrick"](x, f0)
    seconds = {}
    counters.reset()
    for name, op in ops.items():
        seconds[name] = sum(_synced(torch, lambda: op(x, f0))[1]
                            for x, f0 in zip(inputs, f0s))
    launches = counters.read()
    # the mel-cepstrum of each envelope, on the host (SPTK's recursion)
    envs = [ops["cheaptrick"](x, f0).cpu().numpy()
            for x, f0 in zip(inputs, f0s)]
    t0 = time.perf_counter()
    for env in envs:
        sp2mc(env, 39, 0.466)
    seconds["sp2mc_host"] = time.perf_counter() - t0
    rows, ok = [], launches["viterbi_f0"] == len(wavs)
    for i in range(len(wavs)):
        x_cpu, f0_card = inputs[i].cpu(), f0s[i]
        f0_cpu = smooth_f0_median(ops["harvest"](x_cpu, None)[0])
        g, w = f0_card.cpu().numpy(), f0_cpu.numpy()
        both = (g > 0) & (w > 0)
        row = {"seconds": FEATURE_WAVS[i][0], "frames": len(g),
               "vuv_agree": float(((g > 0) == (w > 0)).mean()),
               "voiced": float((w > 0).mean()),
               "f0_max_rel_err": float((np.abs(g - w)[both]
                                        / w[both]).max())}
        for name in ("bandap", "d4c"):
            card_ap = ops[name](inputs[i], f0_card).cpu().numpy()
            cpu_ap = ops[name](x_cpu, f0_card.cpu()).numpy()
            row[f"{name}_max_abs_err_db"] = float(np.abs(card_ap
                                                         - cpu_ap).max())
            row[f"{name}_min_db"] = float(cpu_ap.min())
        row["ok"] = (row["vuv_agree"] >= 0.995 and row["voiced"] > 0.5
                     and row["f0_max_rel_err"] <= 1e-3
                     and row["bandap_max_abs_err_db"] <= 1e-2
                     and row["d4c_max_abs_err_db"] <= 1e-2)
        ok &= row["ok"]
        rows.append(row)
    emit({"phase": "postprocess", "part": "analysis", "card": card,
          "audio_s": audio_s, "seconds": seconds,
          "s_per_audio_s": {k: v / audio_s for k, v in seconds.items()},
          "launches": launches, "card_vs_cpu": rows, "ok": bool(ok)})
    return bool(ok)


def _sifigan_inputs(np, batch, frames, seed):
    """Aux features, the excitation (the stage's SignalGenerator) and the
    dense factors of ``batch`` rows from a seed, at the full-width
    config's rates."""
    from serenade_tpu_torch.bin.ssc_postprocessing import DEFAULT_CONFIG
    from serenade_tpu_torch.sifigan.features import (
        SignalGenerator, dense_factors_per_level,
    )

    rng = np.random.default_rng(seed)
    gen = SignalGenerator(sample_rate=SR, hop_size=SR // 200, seed=seed)
    c = rng.normal(size=(batch, frames, 43)).astype(np.float32)
    sines, dfs = [], []
    for _ in range(batch):
        f0 = rng.uniform(150.0, 450.0) * (1 + 0.02 * np.sin(
            np.arange(frames) * 0.1))
        sines.append(gen(f0))
        dfs.append(dense_factors_per_level(
            f0, SR, DEFAULT_CONFIG["dense_factors"], (5, 4, 3, 2)))
    return (np.stack(sines), c,
            [np.stack([d[i] for d in dfs]) for i in range(4)])


def post_synthesis(torch, np, dev, counters, card):
    """(c): the full-width SiFiGAN (the CLI's default generator, seeded
    weights) at SIFIGAN_BATCH x SIFIGAN_FRAMES: wall, RTF, a profile's
    busy share, launches (12 K3 branch calls a synthesis, every filter
    stage on the split-TF32 route), routed calls 0; then a small f32
    synthesis on the card against the CPU by phase 4's rule (the waveform
    and the excitation within 1e-3 of the CPU's peak).  Returns (ok, the
    generator on the card)."""
    from serenade_tpu_torch.bin.ssc_postprocessing import (
        DEFAULT_CONFIG, load_generator,
    )
    from serenade_tpu_torch.ops import _cuda, resblock_cuda

    model = load_generator(DEFAULT_CONFIG, None, device=dev)
    sine, c, dfs = _sifigan_inputs(np, SIFIGAN_BATCH, SIFIGAN_FRAMES, 15)
    args = [torch.from_numpy(a).to(dev) for a in [sine, c] + dfs]

    def run():
        with torch.no_grad():
            return model(args[0], args[1], args[2:])

    (y, e), first_s = _synced(torch, run)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    walls = [_synced(torch, run)[1] for _ in range(POST_REPS)]
    launches, routed = counters.read(), counters.routed()
    peak = torch.cuda.max_memory_allocated()
    audio_s = SIFIGAN_BATCH * SIFIGAN_FRAMES * 5e-3
    wall = sum(walls) / len(walls)
    prof = device_time(torch, run)
    plans = {f"{t}x{c_}": resblock_cuda.k3_plan(
        SIFIGAN_BATCH, t, c_, k, 5, False, torch.float32,
        _cuda.sm_count(dev))["route"]
        for t, c_ in SIFIGAN_FILTER_SHAPES for k in (3,)}
    right = (tuple(y.shape) == (SIFIGAN_BATCH, SIFIGAN_FRAMES * 120, 1)
             and tuple(e.shape) == tuple(y.shape)
             and bool(torch.isfinite(y).all()) and float(y.abs().max()) > 0)
    counts_ok = (launches["resblock_branch"] == 12 * POST_REPS
                 and all(v == 0 for k, v in launches.items()
                         if k != "resblock_branch")
                 and not any(routed.values())
                 and set(plans.values()) == {"tf32"})
    emit({"phase": "postprocess", "part": "synthesis", "card": card,
          "batch": [SIFIGAN_BATCH, SIFIGAN_FRAMES], "first_call_s": first_s,
          "walls_s": walls, "wall_s": wall, "audio_s": audio_s,
          "rtf": wall / audio_s, "s_per_audio_s": wall / audio_s,
          "device_busy_s": prof["device_busy_s"],
          "device_busy_share": prof["device_busy_s"] / wall,
          "top": prof["top"], "port_kernels": prof["port_kernels"],
          "peak_bytes": peak,
          "launches_per_synthesis": {k: v / POST_REPS
                                     for k, v in launches.items()},
          "routed": routed, "k3_routes": plans, "right": right,
          "ok": bool(right and counts_ok)})

    # a small f32 synthesis, the same seeded weights, card against CPU
    small = _sifigan_inputs(np, 1, 96, 16)
    cpu_model = load_generator(DEFAULT_CONFIG, None, device="cpu")
    outs = []
    for m, d in ((model, dev), (cpu_model, torch.device("cpu"))):
        a = [torch.from_numpy(x).to(d) for x in [small[0], small[1]]
             + small[2]]
        with torch.no_grad():
            outs.append([o.cpu() for o in m(a[0], a[1], a[2:])])
    wav_err = float((outs[0][0] - outs[1][0]).abs().max())
    exc_err = float((outs[0][1] - outs[1][1]).abs().max())
    wav_scale = float(outs[1][0].abs().max())
    exc_scale = float(outs[1][1].abs().max())
    parity_ok = (wav_scale > 0 and exc_scale > 0
                 and wav_err <= 1e-3 * wav_scale
                 and exc_err <= 1e-3 * exc_scale)
    emit({"phase": "postprocess", "part": "synthesis_parity",
          "frames": 96, "wav_max_abs_err": wav_err, "wav_scale": wav_scale,
          "excitation_max_abs_err": exc_err, "excitation_scale": exc_scale,
          "tol": 1e-3, "ok": bool(parity_ok)})
    return bool(right and counts_ok and parity_ok), model


def post_decoded(torch, np, dev, counters, card, model, decoded):
    """(d), first half: ``postprocess_core`` over phase 10's decode
    outputs (their wavs and shifted lf0, Harvest's default range),
    synthesis with (c)'s generator.  The stage's RTF, its analysis and
    synthesis seconds (split where the core enters ``synthesize``, all
    analysis done), launches (one Viterbi launch an utterance, 12 K3
    branch calls a synthesis batch), routed calls 0."""
    from serenade_tpu_torch.bin import ssc_postprocessing as post
    from serenade_tpu_torch.bin.ssc_postprocessing import (
        DEFAULT_CONFIG, postprocess_core, voice_range_for,
    )

    utts = [{"key": f"{r['utt_id']}_{r['style']}", "wav": r["wav"],
             "lf0": r["lf0"], "f0_range": voice_range_for(r["utt_id"])}
            for r in decoded]
    audio_s = sum(len(u["wav"]) for u in utts) / SR
    # the synthesis batches: same-bucket items, up to 8
    buckets = {}
    for u in utts:
        t = 1 + len(u["wav"]) // 120
        buckets[-(-t // 128)] = buckets.get(-(-t // 128), 0) + 1
    batches = sum(-(-n // 8) for n in buckets.values())
    synthesize, marks = post.synthesize, {}

    def marked(*args, **kwargs):
        torch.cuda.synchronize()
        marks["synthesis"] = time.perf_counter()
        yield from synthesize(*args, **kwargs)

    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post.synthesize = marked
    try:
        outs = list(postprocess_core(model, utts, DEFAULT_CONFIG,
                                     device=dev))
    finally:
        post.synthesize = synthesize
    wall = time.perf_counter() - t0
    analysis_s = marks["synthesis"] - t0
    launches, routed = counters.read(), counters.routed()
    lengths = {u["key"]: (1 + len(u["wav"]) // 120) * 120 for u in utts}
    right = (len(outs) == len(utts)
             and all(suffix == "_sifigan" and wav.shape == (lengths[key],)
                     and bool(np.isfinite(wav).all())
                     for key, suffix, wav in outs))
    counts_ok = (launches["viterbi_f0"] == len(utts)
                 and launches["resblock_branch"] == 12 * batches
                 and all(launches[k] == 0 for k in launches
                         if k not in ("viterbi_f0", "resblock_branch"))
                 and not any(routed.values()))
    emit({"phase": "postprocess", "part": "decoded", "card": card,
          "utterances": len(utts), "synthesis_batches": batches,
          "wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
          "analysis_s": analysis_s, "synthesis_s": wall - analysis_s,
          "launches": launches, "routed": routed, "right": right,
          "ok": bool(right and counts_ok)})
    return bool(right and counts_ok), launches


def post_cli(torch, np, card):
    """(d), second half, and (e): ``bin/ssc_postprocessing.main --anasyn``
    over a temporary directory of phase 3b's waveforms (no config, stats
    or h5: the full-width default, seeded weights) on the card, then with
    ``--f0-backend harvest_native --analysis-backend native`` (Harvest,
    CheapTrick and band aperiodicity on the host, built by g++; the
    synthesis on the card).  Each writes every ``*_anasyn.wav`` at its
    length, finite."""
    from serenade_tpu_torch.bin import ssc_postprocessing as post
    from serenade_tpu_torch.utils.audio import read_wav, write_wav

    root = tempfile.mkdtemp(prefix="chip_smoke_post_")
    names = ["song_Tenor", "song_Alto", "song_Bass", "song_Soprano"]
    ok = True
    try:
        wavs = feature_wavs(np)
        for name, w in zip(names, wavs):
            write_wav(os.path.join(root, f"{name}.wav"), w, SR)
        for kind, extra in (("device", []),
                            ("native", ["--f0-backend", "harvest_native",
                                        "--analysis-backend", "native"])):
            _, wall = _synced(torch, lambda: post.main(
                ["--in-dir", root, "--anasyn", "--verbose", "0", *extra]))
            right = True
            for name, w in zip(names, wavs):
                y, sr = read_wav(os.path.join(root, f"{name}_anasyn.wav"))
                right &= (sr == SR and len(y) == (1 + len(w) // 120) * 120
                          and bool(np.isfinite(y).all()))
            emit({"phase": "postprocess", "part": f"cli_{kind}",
                  "card": card, "wavs": len(wavs), "wall_s": wall,
                  "audio_s": sum(len(w) for w in wavs) / SR,
                  "ok": bool(right)})
            ok &= right
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return bool(ok)


def postprocess_path(torch, np, dev, counters, card, decoded):
    """Phase 15: recipe stage 9.  Returns (ok, the launches of (d)'s
    run over the decode outputs)."""
    t0 = time.time()
    ok = post_analysis(torch, np, dev, counters, card)
    synth_ok, model = post_synthesis(torch, np, dev, counters, card)
    decoded_ok, launches = post_decoded(torch, np, dev, counters, card,
                                        model, decoded)
    del model
    cli_ok = post_cli(torch, np, card)
    ok &= synth_ok and decoded_ok and cli_ok
    emit({"phase": "postprocess_done", "seconds": time.time() - t0,
          "ok": bool(ok)})
    return bool(ok), launches


# ---------------------------------------------------------------------------
# phase 16: the Griffin-Lim vocoder, the transcriber, vocoder training
# ---------------------------------------------------------------------------

GL_REQUEST = (1024, 512)
GL_REPS = 3                          # timed conversions
# the upstream transcriber's config keys at full width (229 mels, 768 =
# model_complexity 48 x 16); the phase's own seeded model, no released one
MIDI_CONFIG = dict(n_mels=229, model_complexity=48, sample_rate=16000,
                   win_length=2048, hop_length=320, fmin=30.0, fmax=8000.0,
                   onset_threshold=0.5, offset_threshold=0.5,
                   pitch_sum="median")
VOC_WARMUP, VOC_TIMED = 2, 3         # GAN steps a family
VOC_SYNTH_FRAMES = 1024              # a trained HiFiGAN's synthesis


def _has(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None


def _write_yaml(path: str, obj) -> None:
    """``obj`` as YAML by the port's writer of an experiment's
    ``config.yml`` (its tuples as lists, through JSON)."""
    from serenade_tpu_torch.config import dump_config

    dump_config(json.loads(json.dumps(obj)), path)


def gl_convert(torch, np, dev, counters, card):
    """(a): phase 3's (1024, 512) request through ``Converter.from_expdir``
    on a tree written here (the recipe's model, seeded weights as a port
    checkpoint, ``config.yml`` whose ``vocoder:`` section names
    ``conf/vocoder_griffin_lim.yaml``'s values and identity ``.npz``
    statistics): wall and RTF over GL_REPS conversions, K1's and
    K2's launches (60 and 130 a conversion), no K3 launch, nothing
    routed; the waveform against the same Griffin-Lim on the CPU from the
    card's mel, within 1e-3 of the CPU's peak."""
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.checkpoint import save_checkpoint
    from serenade_tpu_torch.configs import GRIFFIN_LIM_CONFIG, serenade_config
    from serenade_tpu_torch.models.serenade import Serenade
    from serenade_tpu_torch.vocoder.vocoder import Vocoder

    root = tempfile.mkdtemp(prefix="chip_smoke_gl_")
    try:
        exp = os.path.join(root, "exp")
        sc = _scaler(np)
        np.savez(os.path.join(root, "stats.npz"), **{
            f"{feat}_{k}": v for feat, d in sc.items() for k, v in d.items()})
        np.savez(os.path.join(root, "voc_stats.npz"), mean=np.zeros(80),
                 scale=np.ones(80))
        _write_yaml(os.path.join(root, "vocoder_griffin_lim.yaml"),
                    GRIFFIN_LIM_CONFIG)
        params = serenade_config()
        sd = _seeded_state_dict(torch, Serenade(**params), 160)
        save_checkpoint(exp, 1, sd)
        _write_yaml(os.path.join(exp, "config.yml"), {
            "sampling_rate": SR, "model_type": "Serenade",
            "model_params": params, "inference_n_timesteps": 10,
            "vocoder": {
                "config": os.path.join(root, "vocoder_griffin_lim.yaml"),
                "stats": os.path.join(root, "voc_stats.npz")}})
        t0 = time.time()
        conv = Converter.from_expdir(exp, os.path.join(root, "stats.npz"),
                                     seed=0, device=dev)
        setup_s = time.time() - t0
        rng = np.random.default_rng(16)
        src = _features(np, rng, GL_REQUEST[0], False)
        ref = _features(np, rng, GL_REQUEST[1], True)
        conv.convert_features(src, ref)               # warm-up
        torch.cuda.synchronize()
        counters.reset()
        walls = []
        for _ in range(GL_REPS):
            (mel, wav, sr), wall = _synced(
                torch, lambda: conv.convert_features(src, ref))
            walls.append(wall)
        launches, routed = counters.read(), counters.routed()
        # host-bound (32 iterations of small launches): timed on the wall
        mel_dev = torch.from_numpy(mel[None]).to(dev)
        voc_ms = 1e3 * min(_synced(torch, lambda: conv.vocoder.synthesize(
            mel_dev))[1] for _ in range(3))
        voc_prof = device_time(torch, lambda: (
            conv.vocoder.synthesize(mel_dev), torch.cuda.synchronize()))
        cpu = Vocoder.from_files("", os.path.join(
            root, "vocoder_griffin_lim.yaml"), os.path.join(
            root, "voc_stats.npz"), trg_stats=sc["logmel"], device="cpu")
        want = cpu.decode(mel)[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    err = float(np.abs(wav - want).max())
    scale = float(np.abs(want).max())
    audio_s = GL_REQUEST[0] * HOP / SR
    right = (type(conv.vocoder.model).__name__ == "GriffinLimSynth"
             and sr == SR and wav.shape == (GL_REQUEST[0] * HOP,)
             and bool(np.isfinite(wav).all()) and scale > 0)
    counts_ok = (launches["flash_fwd"] == 60 * GL_REPS
                 and launches["block1d_fwd"] == 130 * GL_REPS
                 and all(v == 0 for k, v in launches.items()
                         if k not in ("flash_fwd", "block1d_fwd"))
                 and not any(routed.values()))
    ok = bool(right and counts_ok and err <= 1e-3 * scale)
    emit({"phase": "vocoder", "part": "griffin_lim", "card": card,
          "request": list(GL_REQUEST), "setup_s": setup_s, "walls_s": walls,
          "rtf": sum(walls) / len(walls) / audio_s,
          "griffin_lim_wall_ms": voc_ms,
          "griffin_lim_device_busy_ms": 1e3 * voc_prof["device_busy_s"],
          "griffin_lim_device_launches": voc_prof["device_launches"],
          "n_iter": 32, "launches": launches,
          "routed": routed, "wav_max_abs_err": err, "wav_scale": scale,
          "tol": 1e-3, "ok": ok})
    return ok, launches


def transcriber_run(torch, np, dev, counters, card):
    """(b): the transcriber at 229 mels x 768 from a seeded
    ``midi_model.pt`` in the upstream layout (its output layer scaled and
    centred on this source's median logits, so its tracks cross the
    decoder's thresholds), on phase 3b's 10.24 s source: the card's notes
    and intervals equal to the CPU's, the frame logits' gap, the wall;
    then ``bin/preprocess.main --midi-model-ckpt`` over that waveform
    (``features.extract_features_batch`` with the transcriber where the
    machine has no h5py or pyyaml to read and write the recipe's files),
    its score from the transcriber."""
    from serenade_tpu_torch.modules.phoneme_midi.convert import (
        to_upstream_state_dict,
    )
    from serenade_tpu_torch.modules.phoneme_midi.model import (
        TranscriptionModel, load_transcriber, mel_db_frontend,
    )
    from serenade_tpu_torch.utils.audio import resample

    cfg = MIDI_CONFIG
    source = feature_wavs(np)[2]                       # the 10.24 s one
    model = TranscriptionModel(cfg["n_mels"], cfg["model_complexity"] * 16)
    model.load_state_dict(_seeded_state_dict(torch, model, 161))
    model = model.to(dev).eval()
    wav16 = resample(source, SR, cfg["sample_rate"])
    args = (cfg["sample_rate"], cfg["win_length"], cfg["hop_length"],
            cfg["n_mels"], cfg["fmin"], cfg["fmax"])
    mel = mel_db_frontend(torch.from_numpy(wav16), *args)
    with torch.no_grad():
        model.combined_fc.weight.mul_(20.0)
        logits = model(mel[None].to(dev))[0]
        model.combined_fc.bias.sub_(logits.median(dim=0).values)
    root = tempfile.mkdtemp(prefix="chip_smoke_midi_")
    try:
        ckpt = os.path.join(root, "midi_model.pt")
        torch.save({"config": cfg, "model_state_dict": to_upstream_state_dict(
            {k: v.cpu() for k, v in model.state_dict().items()})}, ckpt)
        fns = {"card": load_transcriber(ckpt, device=dev),
               "cpu": load_transcriber(ckpt, device="cpu")}
        with torch.no_grad():
            gap = float((fns["card"].model(mel[None].to(dev)).cpu()
                         - fns["cpu"].model(mel[None])).abs().max())
        fns["card"](source, SR)                        # warm-up
        counters.reset()
        card_out, wall = _synced(torch, lambda: fns["card"](source, SR))
        launches = counters.read()
        cpu_out = fns["cpu"](source, SR)
        pre = preprocess_with_transcriber(np, root, ckpt, source, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    right = card_out == cpu_out and len(card_out[0]) > 0
    ok = bool(right and launches["viterbi_f0"] == 1 and pre["ok"])
    emit({"phase": "vocoder", "part": "transcriber", "card": card,
          "n_mels": cfg["n_mels"], "model_size": cfg["model_complexity"] * 16,
          "audio_s": len(source) / SR, "wall_s": wall,
          "s_per_audio_s": wall / (len(source) / SR),
          "notes": len(card_out[0]), "notes_equal": card_out == cpu_out,
          "logits_max_abs_gap": gap, "launches": launches,
          "preprocess": pre, "ok": ok})
    return ok


def preprocess_with_transcriber(np, root, ckpt, source, dev):
    """``bin/preprocess.main --midi-model-ckpt`` over ``source`` (a wav.scp
    of one file, the feature config as YAML, no ContentVec), or, without
    h5py and pyyaml here, the extraction it runs: the dumped score must
    differ from F0 note segmentation's."""
    from serenade_tpu_torch.configs import FEATURE_CONFIG
    from serenade_tpu_torch.features import (
        FeatureConfig, extract_features_batch,
    )
    from serenade_tpu_torch.modules.phoneme_midi.model import load_transcriber

    fc = FeatureConfig.from_dict(FEATURE_CONFIG)
    plain = extract_features_batch([("u0", source, SR, None)], fc,
                                   device=dev)["u0"]
    t0 = time.time()
    if _has("h5py") and _has("yaml"):
        from serenade_tpu_torch.bin import preprocess
        from serenade_tpu_torch.utils.audio import write_wav
        from serenade_tpu_torch.utils.h5 import read_hdf5

        write_wav(os.path.join(root, "u0.wav"), source, SR)
        with open(os.path.join(root, "wav.scp"), "w") as f:
            f.write(f"u0 {os.path.join(root, 'u0.wav')}\n")
        _write_yaml(os.path.join(root, "conf.yml"), FEATURE_CONFIG)
        preprocess.main(["--wav-scp", os.path.join(root, "wav.scp"),
                         "--dumpdir", os.path.join(root, "dump"), "--config",
                         os.path.join(root, "conf.yml"),
                         "--midi-model-ckpt", ckpt,
                         "--allow-missing-hubert", "true", "--device",
                         str(dev), "--verbose", "0"])
        midi = read_hdf5(os.path.join(root, "dump", "u0.h5"), "midi")
        route = "preprocess.main"
    else:
        feats = extract_features_batch(
            [("u0", source, SR, None)], fc, device=dev,
            midi_transcribe_fn=load_transcriber(ckpt, device=dev))["u0"]
        midi = None if feats is None else feats["midi"]
        route = "extract_features_batch"
    ok = (midi is not None and plain is not None
          and midi.shape == plain["midi"].shape
          and not np.array_equal(midi, plain["midi"]))
    return {"route": route, "wall_s": time.time() - t0,
            "frames": None if midi is None else int(midi.shape[0]),
            "ok": bool(ok)}


def _recording_grads(torch, opt, seen):
    """``opt`` recording, at its first update, whether each gradient
    has a nonzero element."""
    update = opt.update

    def recorded(params, grads, state):
        if not seen:
            seen.update({n: bool(torch.count_nonzero(g)) for n, g in
                         grads.items()})
        return update(params, grads, state)

    opt.update = recorded


def _train_family(torch, np, dev, counters, card, family, items):
    """One family's GAN steps at the recipe's widths: VOC_WARMUP steps,
    then VOC_TIMED synchronised ones, one profiled; returns (entry, the
    generator, the discriminator, the state)."""
    from serenade_tpu_torch.bin import vocoder_train as ptrain
    from serenade_tpu_torch.configs import (
        SIFIGAN_TRAIN_CONFIG, VOCODER_TRAIN_CONFIG,
    )
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.trainers import vocoder_trainer as vt
    from serenade_tpu_torch.vocoder.losses import residual_loss

    config = (VOCODER_TRAIN_CONFIG if family == "hifigan"
              else SIFIGAN_TRAIN_CONFIG)
    gen, hop = ptrain.build_generator(config, family)
    disc = ptrain.build_discriminator(
        "univnet" if family == "sifigan" else "msd_mpd")
    init_params_(gen, 0)
    init_params_(disc, 1)
    gen.to(dev).train()
    disc.to(dev).train()
    gopt, dopt = (vt.adamw_chain(float(config["gen_lr"])),
                  vt.adamw_chain(float(config["disc_lr"])))
    seen_g, seen_d = {}, {}
    _recording_grads(torch, gopt, seen_g)
    _recording_grads(torch, dopt, seen_d)
    state = vt.create_vocoder_state(gen, disc, gopt, dopt)
    kw = dict(sampling_rate=SR, lambda_adv=config["lambda_adv"],
              lambda_fm=config["lambda_fm"], lambda_mel=config["lambda_mel"])
    rng = np.random.default_rng(int(config["seed"]))
    batch, frames = config["vocoder_batch_size"], config["segment_frames"]
    if family == "sifigan":
        kw.update(lambda_reg=config["lambda_reg"],
                  gen_forward=vt.sifigan_forward(gen, with_excitation=True),
                  reg_loss_fn=lambda aux, b: residual_loss(
                      aux, b["wav"], b["cf0"], sampling_rate=SR,
                      hop_size=hop))

        def sample():
            return vt.sample_sifigan_segments(items, rng, batch, frames, hop)
    else:
        def sample():
            return vt.sample_mel_wav_segments(items, rng, batch, frames, hop)
    step = vt.build_vocoder_train_step(gen, disc, gopt, dopt, **kw)
    batches = [vt.batch_to_device(sample(), dev)
               for _ in range(VOC_WARMUP + VOC_TIMED + 1)]
    metrics_seen = []
    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    first_s = []
    for b in batches[:VOC_WARMUP]:
        (state, m), s = _synced(torch, lambda: step(state, b))
        first_s.append(s)
        metrics_seen.append(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[VOC_WARMUP:VOC_WARMUP + VOC_TIMED]:
        state, m = step(state, b)
        metrics_seen.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    # idle: the profiled step's timeline where no kernel runs (its kernels'
    # sum exceeds both the span and the unprofiled wall: some overlap)
    prof = device_time(torch, lambda: (step(state, batches[-1]),
                                       torch.cuda.synchronize()))
    launches = counters.read()
    finite = all(bool(torch.isfinite(v)) for m in metrics_seen
                 for v in m.values())
    grads_ok = (len(seen_g) == len(state.gen_params) and all(seen_g.values())
                and len(seen_d) == len(state.disc_params)
                and all(seen_d.values()))
    per_step = wall / VOC_TIMED
    entry = {"phase": "vocoder", "part": f"train_{family}", "card": card,
             "batch": [batch, frames], "samples": frames * hop,
             "generator_params": sum(p.numel() for p in gen.parameters()),
             "discriminator_params": sum(p.numel()
                                         for p in disc.parameters()),
             "first_steps_s": first_s, "step_s": per_step,
             "steps_per_s": 1.0 / per_step, "peak_bytes": peak,
             "device_busy_s": prof["device_busy_s"],
             "device_span_s": prof["device_span_s"],
             "device_covered_s": prof["device_covered_s"],
             "device_idle_share": 1.0 - prof["device_covered_s"] / max(
                 prof["device_span_s"], 1e-9),
             "top": prof["top"][:5],
             "metrics": {k: float(v) for k, v in metrics_seen[-1].items()},
             "finite": finite,
             "zero_grad_params": [n for n, v in list(seen_g.items())
                                  + list(seen_d.items()) if not v],
             "launches": launches,
             "ok": bool(finite and grads_ok
                        and not any(launches.values()))}
    return entry, gen, disc, state


def vocoder_train(torch, np, dev, counters, card):
    """(c): both families trained at the recipe's widths
    (``conf/vocoder_hifigan.yaml``: 512 channels, upsample (8, 6, 5),
    batch 16 x 32 frames, multi-scale + multi-period; and
    ``conf/vocoder_sifigan.yaml``: 512, (5, 4, 3, 2), in 43, UnivNet +
    multi-period, the residual loss at lambda 1), on the conv backend: no
    kernel launches, every parameter of both networks with a nonzero
    gradient, every loss finite; steps/s, peak memory, the idle share.
    The SiFiGAN's streams come from ``sifigan_extract_features`` over
    phase 15's waveforms (``main`` where h5py is here, its
    ``extract_core`` otherwise), the HiFiGAN's log-mels from the same
    waveforms.  Each trained state is saved by ``AsyncSaver`` and read
    back exactly; then synthesis from the HiFiGAN directory through
    ``load_vocoder`` and from the SiFiGAN directory through
    ``postprocess_core``, on the fused backend: K3 launched, nothing
    routed, the HiFiGAN's waveform within 1e-3 of its peak of the
    trained (conv backend) generator's.  Returns (ok, the training's
    launches, the synthesis launches)."""
    from serenade_tpu_torch.bin import sifigan_extract_features as extract
    from serenade_tpu_torch.bin import ssc_postprocessing as post
    from serenade_tpu_torch.bin.vocoder_train import vocoder_checkpoint
    from serenade_tpu_torch.checkpoint import AsyncSaver, restore_checkpoint
    from serenade_tpu_torch.configs import FEATURE_CONFIG
    from serenade_tpu_torch.ops.mel import logmelfilterbank

    wavs = feature_wavs(np)
    root = tempfile.mkdtemp(prefix="chip_smoke_voc_")
    ok, train_launches, synth = True, {}, {}
    try:
        t0 = time.perf_counter()
        if _has("h5py"):
            from serenade_tpu_torch.utils.audio import write_wav

            lines = []
            for i, w in enumerate(wavs):
                path = os.path.join(root, f"u{i}.wav")
                write_wav(path, w, SR)
                lines.append(f"u{i} {path}\n")
            with open(os.path.join(root, "wav.scp"), "w") as f:
                f.writelines(lines)
            extract.main(["--wav-scp", os.path.join(root, "wav.scp"),
                          "--dumpdir", os.path.join(root, "feats"),
                          "--device", str(dev), "--verbose", "0"])
            items = extract.load_precomputed(os.path.join(root, "feats"))
            route = "main"
        else:
            items = [f for _, f in extract.extract_core(
                ((f"u{i}", (w, SR)) for i, w in enumerate(wavs)),
                device=dev)]
            route = "extract_core"
        extract_s = time.perf_counter() - t0
        streams_ok = (len(items) == len(wavs) and all(
            it["sine"].shape[0] == it["c"].shape[0] * 120
            and it["c"].shape[1] == 43 and np.isfinite(it["c"]).all()
            for it in items))
        emit({"phase": "vocoder", "part": "sifigan_extract", "route": route,
              "wavs": len(wavs), "audio_s": sum(len(w) for w in wavs) / SR,
              "wall_s": extract_s, "ok": bool(streams_ok)})
        ok &= streams_ok
        fc = FEATURE_CONFIG
        mels = [{"logmel": logmelfilterbank(
            torch.from_numpy(w).to(dev), SR, fft_size=fc["fft_size"],
            hop_size=fc["hop_size"], win_length=fc["win_length"],
            num_mels=fc["num_mels"], fmin=fc["fmin"], fmax=fc["fmax"],
            eps=fc["eps"]).cpu().numpy(), "wave": w} for w in wavs]

        saver = AsyncSaver()
        for family, data in (("hifigan", mels), ("sifigan", items)):
            entry, gen, disc, state = _train_family(
                torch, np, dev, counters, card, family, data)
            train_launches[family] = entry["launches"]
            t0 = time.perf_counter()
            path = saver.save(os.path.join(root, family), state.step,
                              *vocoder_checkpoint(state))
            entry["save_blocked_s"] = time.perf_counter() - t0
            saver.wait()
            back = restore_checkpoint(path)
            exact = all(torch.equal(back["params"][net][k].to(dev), v)
                        for net, live in (("generator", state.gen_params),
                                          ("discriminator",
                                           state.disc_params))
                        for k, v in live.items())
            entry["restored_exactly"] = exact
            entry["ok"] = bool(entry["ok"] and exact)
            emit(entry)
            ok &= entry["ok"]
            del disc, state
            if family == "hifigan":
                ok &= _hifigan_synthesis(torch, np, dev, counters, card,
                                         path, gen, synth)
            else:
                ok &= _sifigan_synthesis(torch, np, dev, counters, card,
                                         path, post, wavs, synth)
            del gen
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return bool(ok), train_launches, synth


def _hifigan_synthesis(torch, np, dev, counters, card, path, gen, synth):
    """A trained HiFiGAN directory through ``load_vocoder`` into a
    ``Vocoder`` (identity statistics, the fused backend)."""
    from serenade_tpu_torch.configs import VOCODER_TRAIN_CONFIG
    from serenade_tpu_torch.vocoder.vocoder import Vocoder, load_vocoder

    ident = {"mean": np.zeros(80), "scale": np.ones(80)}
    voc = Vocoder(VOCODER_TRAIN_CONFIG, load_vocoder(
        path, VOCODER_TRAIN_CONFIG), ident, take_norm_feat=False,
        device=dev)
    mel = np.random.default_rng(17).normal(
        size=(VOC_SYNTH_FRAMES, 80)).astype(np.float32) - 3.0
    voc.decode(mel)                                    # warm-up
    counters.reset()
    (y, _), wall = _synced(torch, lambda: voc.decode(mel))
    launches, routed = counters.read(), counters.routed()
    gen.eval()
    with torch.no_grad():
        want = gen(torch.from_numpy(mel[None]).to(dev))[0, :, 0].cpu(
            ).numpy()
    err, scale = float(np.abs(y - want).max()), float(np.abs(want).max())
    right = (y.shape == (VOC_SYNTH_FRAMES * HOP,)
             and bool(np.isfinite(y).all()) and scale > 0)
    ok = bool(right and launches["resblock_branch"] > 0
              and not any(routed.values()) and err <= 1e-3 * scale)
    synth["hifigan"] = launches
    emit({"phase": "vocoder", "part": "synthesis_hifigan", "card": card,
          "frames": VOC_SYNTH_FRAMES, "wall_s": wall,
          "rtf": wall / (VOC_SYNTH_FRAMES * HOP / SR), "launches": launches,
          "routed": routed, "wav_max_abs_err_vs_conv_backend": err,
          "wav_scale": scale, "tol": 1e-3, "ok": ok})
    return ok


def _sifigan_synthesis(torch, np, dev, counters, card, path, post, wavs,
                       synth):
    """A trained SiFiGAN directory through stage 9's ``load_generator``
    and ``postprocess_core`` (``--anasyn``) over phase 15's waveforms."""
    model = post.load_generator(post.DEFAULT_CONFIG, path, device=dev)
    utts = [{"key": f"u{i}", "wav": w, "lf0": None,
             "f0_range": (130, 660)} for i, w in enumerate(wavs)]
    counters.reset()
    outs, wall = _synced(torch, lambda: list(post.postprocess_core(
        model, utts, post.DEFAULT_CONFIG, anasyn=True, device=dev)))
    launches, routed = counters.read(), counters.routed()
    right = (len(outs) == len(utts)
             and all(bool(np.isfinite(w).all()) and w.shape[0] > 0
                     for _, _, w in outs))
    ok = bool(right and launches["resblock_branch"] > 0
              and not any(routed.values()))
    synth["sifigan"] = launches
    emit({"phase": "vocoder", "part": "synthesis_sifigan", "card": card,
          "utterances": len(utts), "wall_s": wall,
          "audio_s": sum(len(w) for w in wavs) / SR, "launches": launches,
          "routed": routed, "ok": ok})
    return ok


def vocoder_path(torch, np, dev, counters, card):
    """Phase 16.  Returns (ok, the launches of (a), of (c)'s training and
    of (c)'s syntheses)."""
    t0 = time.time()
    ok, gl_launches = gl_convert(torch, np, dev, counters, card)
    ok &= transcriber_run(torch, np, dev, counters, card)
    train_ok, train_launches, synth = vocoder_train(torch, np, dev,
                                                    counters, card)
    ok &= train_ok
    emit({"phase": "vocoder_done", "seconds": time.time() - t0,
          "ok": bool(ok)})
    return bool(ok), gl_launches, train_launches, synth


# ---------------------------------------------------------------------------
# phase 17: the model variants and small tools
# ---------------------------------------------------------------------------

# NUSVC's attention at head dim 256 (phase 2's rows): its (1024, 512)
# inference and its train step, as (B, T, valid lengths)
NUSVC_CHECKS = ((1, 1024, [1024]), (16, 512, [512] + [475] * 15))
NUSVC_REQUEST = (1024, 512)          # source, reference frames
NUSVC_STEPS = 10                     # Euler steps of (a)
NUSVC_TRAIN_STEPS = 5                # timed steps of (b), after 2 warm-up
NUSVC_PARITY = (64, 48, 2)           # (a)'s f32 parity: frames, ref, steps
FUSED_REQUEST = (1024, 512)          # (c): phase 3's first request
SNAKE_T = 1536                       # (d): its packed length
# a UNet evaluation of NUSVC's and of Serenade's: 6 transformer blocks and
# 13 Block1Ds
UNET_LAUNCHES = {"flash_fwd": 6, "block1d_fwd": 13}


def _nusvc_inputs(torch, dev, b, t, t_ref, lengths, seed, input_dim=771):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((b, t, input_dim), generator=g, device=dev),
            torch.tensor(lengths, device=dev),
            torch.randn((b, t_ref, 80), generator=g, device=dev))


def _only(launches, want) -> bool:
    """Each kernel in ``want`` launched that many times, every other kernel
    never."""
    return all(n == want.get(k, 0) for k, n in launches.items())


def nusvc_infer(torch, np, dev, counters, card):
    """(a) NUSVC at its published widths (bf16 compute, f32 parameters,
    seeded weights) converts a (1024, 512) request, Euler-10; then a short
    f32 conversion on the card against the CPU."""
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.models.nusvc import NUSVC

    t0 = time.time()
    model = init_params_(NUSVC(), seed=3).to(dev).eval()
    setup_s = time.time() - t0
    s, r = NUSVC_REQUEST
    x, lengths, ref = _nusvc_inputs(torch, dev, 1, s, r, [s], 4)
    ref_lengths = torch.tensor([r], device=dev)
    model.inference(x, lengths, ref, ref_lengths, n_timesteps=2)  # warm-up
    torch.cuda.synchronize()
    counters.reset()
    walls = []
    for _ in range(2):
        start = time.time()
        mel = model.inference(x, lengths, ref, ref_lengths,
                              n_timesteps=NUSVC_STEPS)
        torch.cuda.synchronize()
        walls.append(time.time() - start)
    launches, routed = counters.read(), counters.routed()
    evals = 2 * NUSVC_STEPS
    want = {k: v * evals for k, v in UNET_LAUNCHES.items()}
    ok = (tuple(mel.shape) == (1, s, 80) and bool(torch.isfinite(mel).all())
          and _only(launches, want) and not any(routed.values()))
    # f32 at a short length: the card's kernels against the CPU's plain
    # versions, from the same weights and noise (phase 4's 1e-3)
    t, tr, steps = NUSVC_PARITY
    cpu_model = NUSVC(dtype="float32")
    cpu_model.load_state_dict(model.state_dict())
    card_model = NUSVC(dtype="float32").to(dev)
    card_model.load_state_dict(model.state_dict())
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=shape).astype(np.float32) for shape in
              ((1, t, 771), (1, tr, 80), (1, t, 80))]
    outs = []
    for m, d in ((cpu_model, torch.device("cpu")), (card_model, dev)):
        xs, refs, x0 = (torch.from_numpy(a).to(d) for a in arrays)
        outs.append(m.inference(
            xs, torch.tensor([t - 5], device=d), refs,
            torch.tensor([tr], device=d), n_timesteps=steps,
            x0=0.667 * x0).cpu().numpy())
    err = float(np.abs(outs[0] - outs[1]).max())
    scale = max(1.0, float(np.abs(outs[0]).max()))
    parity_ok = err / scale <= 1e-3
    wall = min(walls)
    emit({"phase": "nusvc", "part": "inference", "card": card,
          "request": list(NUSVC_REQUEST), "steps": NUSVC_STEPS,
          "params": sum(p.numel() for p in model.parameters()),
          "setup_s": setup_s, "wall_s": walls,
          "rtf": wall / (s * HOP / SR), "launches": launches,
          "launches_expected": want, "routed": routed,
          "f32_parity": {"frames": t, "steps": steps, "max_abs_err": err,
                         "scale": scale, "tol": 1e-3, "ok": parity_ok},
          "ok": ok and parity_ok})
    return ok and parity_ok, launches, model


def nusvc_train(torch, np, dev, counters, card, model):
    """(b) One step at a time of NUSVC's ``loss`` at B 16 x 512 (dropout
    on), its backward and the recipe's AdamW: 2 warm-up and 5 timed
    steps."""
    from serenade_tpu_torch.configs import TRAIN_CONFIG
    from serenade_tpu_torch.trainers import build_optimizer, \
        create_train_state

    model.train()
    opt, _ = build_optimizer(TRAIN_CONFIG)
    state = create_train_state(model, opt)
    b, t, lengths = NUSVC_CHECKS[1]
    x, lens, mel = _nusvc_inputs(torch, dev, b, t, t, lengths, 6)
    gen = torch.Generator(device=dev).manual_seed(7)

    def step():
        for p in state.params.values():
            p.grad = None
        out = model(x, lens, mel, generator=gen)
        out["loss"].backward()
        grads = {n: p.grad for n, p in state.params.items()}
        norm = opt.update(state.params, grads, state.opt_state)
        return out, grads, norm

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    counters.reset()
    walls, losses = [], []
    for _ in range(NUSVC_TRAIN_STEPS):
        start = time.time()
        out, grads, norm = step()
        torch.cuda.synchronize()
        walls.append(time.time() - start)
        losses.append({k: float(v.detach()) for k, v in out.items()})
    launches, routed = counters.read(), counters.routed()
    model.eval()
    no_grad = [n for n, g in grads.items()
               if g is None or not bool(torch.isfinite(g).all())
               or not bool(g.abs().amax() > 0)]
    want = {k: n * NUSVC_TRAIN_STEPS for k, n in TRAIN_LAUNCHES.items()
            if n}
    finite = all(math.isfinite(v) for r in losses for v in r.values())
    ok = (finite and not no_grad and math.isfinite(float(norm))
          and _only(launches, want) and not any(routed.values()))
    step_s = sum(walls) / len(walls)
    emit({"phase": "nusvc", "part": "train", "card": card,
          "batch": [b, t], "step_s": walls, "steps_per_s": 1.0 / step_s,
          "frames_per_s": sum(lengths) / step_s, "losses": losses,
          "params_without_finite_grad": no_grad, "launches": launches,
          "launches_expected": want, "routed": routed, "ok": ok})
    return ok, launches


def fused_qkv_convert(torch, np, dev, counters, card, conv):
    """(c) Phase 3's Converter answers its (1024, 512) request with the
    fused QKV projection (``SERENADE_FUSE_QKV=1``) and without, from the
    same noise: the mels within phase 8's rule of each other, measured
    against the card's own bf16 - f32 gap (an f32 Converter from the same
    seeded weights), 60 K1 launches each, no call routed."""
    from serenade_tpu_torch.api import Converter
    from serenade_tpu_torch.configs import serenade_config

    rng = np.random.default_rng(8)
    s, r = FUSED_REQUEST
    src, ref = _features(np, rng, s, False), _features(np, rng, r, True)
    x0 = 0.667 * rng.normal(size=(1, s + r, 80))
    runs, ok = {}, True
    old = os.environ.get("SERENADE_FUSE_QKV")
    try:
        for fused in ("1", "0"):
            os.environ["SERENADE_FUSE_QKV"] = fused
            conv.convert_features(src, ref, x0=x0)         # warm-up
            torch.cuda.synchronize()
            counters.reset()
            start = time.time()
            mel, _, _ = conv.convert_features(src, ref, x0=x0)
            torch.cuda.synchronize()
            wall = time.time() - start
            launches, routed = counters.read(), counters.routed()
            runs[fused] = (mel, wall, launches, routed)
            ok &= (launches["flash_fwd"] == 6 * conv.n_timesteps
                   and not any(routed.values()))
    finally:
        if old is None:
            os.environ.pop("SERENADE_FUSE_QKV", None)
        else:
            os.environ["SERENADE_FUSE_QKV"] = old
    f32 = Converter(serenade_config("float32"), None, _scaler(np),
                    n_timesteps=10, solver="euler", seed=0, device=dev)
    mel32, _, _ = f32.convert_features(src, ref, x0=x0)
    del f32
    fused, unfused = runs["1"][0], runs["0"][0]
    gap, err = np.abs(unfused - mel32), np.abs(fused - unfused)
    rule = bool(err.mean() <= 1.5 * gap.mean()
                and err.max() <= 2.0 * gap.max())
    ok &= rule and bool(np.isfinite(fused).all())
    emit({"phase": "nusvc", "part": "fused_qkv", "card": card,
          "request": [s, r], "wall_s": {"fused": runs["1"][1],
                                        "unfused": runs["0"][1]},
          "launches": {"fused": runs["1"][2], "unfused": runs["0"][2]},
          "routed": {"fused": runs["1"][3], "unfused": runs["0"][3]},
          "max_abs_diff": float(err.max()), "mean_abs_diff": float(err.mean()),
          "bf16_gap_max": float(gap.max()), "bf16_gap_mean": float(gap.mean()),
          "tol": {"mean": 1.5, "max": 2.0}, "ok": bool(ok)})
    return bool(ok)


def snakebeta_unet(torch, np, dev, counters, card):
    """(d) Serenade's UNet (242 -> 80, channels (512, 512), head dim 512)
    with ``act_fn="snakebeta"`` in bf16: one evaluation at the packed T
    1536 of a (1024, 512) request."""
    from serenade_tpu_torch.configs import SERENADE_MODEL_PARAMS as P
    from serenade_tpu_torch.models.layers import init_params_
    from serenade_tpu_torch.models.transformer import SnakeBeta
    from serenade_tpu_torch.models.unet import Decoder

    cond = P["encoder_channels"] + 2 + P["output_dim"]
    dec = init_params_(Decoder(
        cond + P["output_dim"], P["output_dim"],
        channels=(P["decoder_channels"],) * 2,
        attention_head_dim=P["decoder_attention_head_dim"],
        spk_dim=P["gst_embed_dim"], act_fn="snakebeta",
        dtype=torch.bfloat16), seed=9).to(dev)
    snakes = sum(isinstance(m, SnakeBeta) for m in dec.modules())
    t = SNAKE_T
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((1, t, 80), generator=g, device=dev)
    mu = torch.randn((1, t, cond), generator=g, device=dev)
    spk = torch.randn((1, P["gst_embed_dim"]), generator=g, device=dev)
    mask = torch.ones((1, t, 1), device=dev)
    tt = torch.full((1,), 0.5, device=dev)
    with torch.no_grad():
        dec(x, mask, mu, tt, spk)                       # warm-up
        torch.cuda.synchronize()
        counters.reset()
        out = dec(x, mask, mu, tt, spk)
        torch.cuda.synchronize()
    launches, routed = counters.read(), counters.routed()
    ok = (snakes == 6 and tuple(out.shape) == (1, t, 80)
          and bool(torch.isfinite(out).all())
          and _only(launches, UNET_LAUNCHES) and not any(routed.values()))
    emit({"phase": "nusvc", "part": "snakebeta_unet", "card": card, "t": t,
          "snakebeta_blocks": snakes, "launches": launches,
          "launches_expected": UNET_LAUNCHES, "routed": routed, "ok": ok})
    return ok


def param_counts(torch, np, card, nusvc_params):
    """(e) ``bin/param_count --config`` on Serenade's full-width config and
    NUSVC's defaults (written as YAML where pyyaml is; else the function
    the CLI runs on the same dict), each total against the instantiated
    model's parameters."""
    from serenade_tpu_torch.bin import param_count
    from serenade_tpu_torch.configs import serenade_config
    from serenade_tpu_torch.models.serenade import Serenade

    serenade_n = sum(p.numel() for p in Serenade(
        **serenade_config()).parameters())
    totals, ok = {}, True
    with tempfile.TemporaryDirectory() as root:
        for name, params, want in (("Serenade", serenade_config(),
                                    serenade_n),
                                   ("NUSVC", {}, nusvc_params)):
            config = {"model_type": name, "model_params": params}
            if _has("yaml"):
                path = os.path.join(root, f"{name}.yml")
                _write_yaml(path, config)
                out = param_count.main(["--config", path])
                route = "cli"
            else:
                out = param_count.count_tree(param_count.config_tree(config))
                route = "config_tree"
            totals[name] = {"total": out["total"],
                            "per_module": out["per_module"], "route": route}
            ok &= out["total"] == want
    emit({"phase": "nusvc", "part": "param_count", "card": card,
          "totals": totals, "ok": bool(ok)})
    return bool(ok)


def nusvc_path(torch, np, dev, counters, card, conv):
    """Phase 17.  Returns (ok, the launches of (a)'s inference and of
    (b)'s train steps)."""
    t0 = time.time()
    ok, infer_launches, model = nusvc_infer(torch, np, dev, counters, card)
    train_ok, train_launches = nusvc_train(torch, np, dev, counters, card,
                                           model)
    ok &= train_ok
    n_params = sum(p.numel() for p in model.parameters())
    del model
    ok &= fused_qkv_convert(torch, np, dev, counters, card, conv)
    ok &= snakebeta_unet(torch, np, dev, counters, card)
    ok &= param_counts(torch, np, card, n_params)
    emit({"phase": "nusvc_done", "seconds": time.time() - t0,
          "ok": bool(ok)})
    return bool(ok), infer_launches, train_launches


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
    # a kernel of the port with no Pallas counterpart: the trellis is a
    # lax.scan in JAX
    "viterbi_f0": ("serenade_tpu_torch/csrc/viterbi_f0.cu",
                   "serenade_tpu/ops/f0.py:301", "viterbi_cuda", "launches"),
}
# what each forward kernel writes, and the gradients each backward kernel
# writes
FORWARD_OUTPUTS = {"flash_fwd": ("out", "lse"), "block1d_fwd": ("out",),
                   "resblock_branch": ("out",), "viterbi_f0": ("states",)}
OUTPUTS = {"flash_bwd_dq": ("dq",), "flash_bwd_dkv": ("dk", "dv"),
           "block1d_bwd_data": ("dx", "dbias", "dgamma", "dbeta"),
           "block1d_bwd_weight": ("dw",)}


# the calls each wrapper module routed to its plain version because a
# kernel does not take their shape: counter module and attribute
ROUTED = {"attention": ("flash_cuda", "routed"),
          "block1d": ("block1d_cuda", "routed")}


class Counters:
    """Every kernel's launch counter and every routed-call counter, read
    and reset by name."""

    def __init__(self, modules):
        self.modules = modules

    def reset(self):
        for mod, attr in [v[2:] for v in KERNELS.values()] + list(
                ROUTED.values()):
            setattr(self.modules[mod], attr, 0)

    def read(self):
        return {name: getattr(self.modules[mod], attr)
                for name, (_, _, mod, attr) in KERNELS.items()}

    def routed(self):
        return {name: getattr(self.modules[mod], attr)
                for name, (mod, attr) in ROUTED.items()}


def _head_dims(entry, rows, part=None):
    """The head dims a flash kernel ran at in phase 2, and its timed rows
    at NUSVC's head dim 256 (ms, bound, plain, SDPA)."""
    entry["head_dims"] = sorted({r["shape"][3] for r in rows})
    entry["head_dim_256_rows"] = [
        {"shape": r["shape"],
         "max_abs_err": (max(r["max_abs_err"][k] for k in OUTPUTS[
             f"flash_bwd_{part}"]) if part else r["max_abs_err"]),
         **{k: (r[part] if part else r)[k] for k in ("ms", "bound_ms")},
         "plain_ms": r["plain_ms"], "library_ms": r["library_ms"]}
        for r in rows if r["shape"][3] == 256 and "plain_ms" in r]


def kernel_entries(torch, np, dev):
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
        for key in ("bound_f32_fma_ms", "plan", "profile_ms"):
            if key in timing:
                entries[name][key] = timing[key]

    for name, check in (("flash_fwd", check_flash),
                        ("block1d_fwd", check_block1d),
                        ("resblock_branch", check_resblock)):
        main_row, rows = check(torch, dev)
        emit({"phase": "kernels", "kernel": name, "cases": rows})
        ok &= all(r["ok"] for r in rows)
        entry(name, main_row, main_row)
        if name == "resblock_branch":
            # SiFiGAN's filter network: no additional convs (phase 15)
            entries[name]["filter_rows"] = [
                {k: r[k] for k in ("shape", "ms", "bound_ms", "plain_ms",
                                   "max_abs_err")}
                for r in rows if not r["additional_convs"] and "ms" in r]
        if name == "flash_fwd":
            _head_dims(entries[name], rows)
    main_row, rows = check_viterbi(torch, np, dev)
    emit({"phase": "kernels", "kernel": "viterbi_f0", "cases": rows})
    ok &= all(r["ok"] for r in rows)
    entry("viterbi_f0", main_row, main_row)
    entries["viterbi_f0"]["pallas_counterpart"] = None
    # Harvest's 17-state trellis (phase 15)
    entries["viterbi_f0"]["harvest_rows"] = [
        {k: r[k] for k in ("shape", "ms", "bound_ms", "plain_ms",
                           "states_differing")}
        for r in rows if r["shape"][2] == 16 and "ms" in r]
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
            if name.startswith("flash"):
                _head_dims(entries[name], rows, part)
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
            _cuda, block1d_cuda, flash_cuda, resblock_cuda, viterbi_cuda,
        )
    except ImportError as exc:
        print(f"chip_smoke: the serenade_tpu_torch package is missing: {exc}",
              file=sys.stderr)
        return 2
    counters = Counters({"flash_cuda": flash_cuda,
                         "block1d_cuda": block1d_cuda,
                         "resblock_cuda": resblock_cuda,
                         "viterbi_cuda": viterbi_cuda})
    dev = torch.device("cuda")
    # f32 stays f32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else "nvidia-smi: no output")

    t0 = time.time()
    logs = _cuda.build_all()
    ptxas = [line.strip() for log in logs.values()
             for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.time() - t0, "ptxas": ptxas})

    ok, entries = kernel_entries(torch, np, dev)
    # each kernel's launches come from the path that runs it: the forward
    # kernels' from the conversions, the backward kernels' from training
    main_ok, launches, conv = main_path(torch, np, dev, counters)
    ok &= main_ok
    for name in ("flash_fwd", "block1d_fwd", "resblock_branch"):
        entries[name]["launches"] = launches[name]
    features_ok, launches = features_path(torch, np, dev, counters, conv,
                                          card)
    ok &= features_ok
    entries["viterbi_f0"]["launches"] = launches["viterbi_f0"]
    ok &= slice_parity(torch, np, dev, counters)
    train_ok, launches = train_path(torch, np, dev, counters)
    ok &= train_ok
    for name in OUTPUTS:
        entries[name]["launches"] = launches[name]
    ok &= train_parity(torch, np, dev)
    ok &= serve_path(torch, np, dev, counters, conv, card)
    ok &= batch_parity(torch, np, dev, counters)
    stream_ok, launches = stream_path(torch, np, dev, counters, conv, card)
    ok &= stream_ok
    for name in ("flash_fwd", "block1d_fwd", "resblock_branch",
                 "viterbi_f0"):
        entries[name]["stream_launches"] = launches[name]
    decode_ok, launches, decoded = decode_path(torch, np, dev, counters,
                                               card)
    ok &= decode_ok
    for name in ("flash_fwd", "block1d_fwd", "resblock_branch"):
        entries[name]["decode_launches"] = launches[name]
    loop_ok, launches = train_loop_path(torch, np, dev, counters, card)
    ok &= loop_ok
    for name in entries:
        entries[name]["loop_launches"] = launches[name]
    variant_ok, launches = variant_path(torch, np, dev, counters, card)
    ok &= variant_ok
    for name in entries:
        entries[name]["variant_launches"] = launches[name]
    distill_ok, launches = distill_eval_path(torch, np, dev, counters, card)
    ok &= distill_ok
    for name in entries:
        entries[name]["distill_eval_launches"] = launches[name]
    deploy_ok, launches = deploy_path(torch, np, dev, counters, card)
    ok &= deploy_ok
    for name in entries:
        entries[name]["deploy_launches"] = launches["deploy"][name]
        entries[name]["quantized_launches"] = launches["quantized"][name]
    post_ok, launches = postprocess_path(torch, np, dev, counters, card,
                                         decoded)
    ok &= post_ok
    for name in entries:
        entries[name]["postprocess_launches"] = launches[name]
    voc_ok, gl_launches, train_launches, synth = vocoder_path(
        torch, np, dev, counters, card)
    ok &= voc_ok
    for name in entries:
        entries[name]["griffin_lim_launches"] = gl_launches[name]
        entries[name]["vocoder_train_launches"] = {
            f: v[name] for f, v in train_launches.items()}
        entries[name]["vocoder_synthesis_launches"] = {
            f: v[name] for f, v in synth.items()}
    nusvc_ok, infer_launches, train_launches = nusvc_path(
        torch, np, dev, counters, card, conv)
    ok &= nusvc_ok
    for name in entries:
        entries[name]["nusvc_launches"] = {
            "inference": infer_launches[name], "train": train_launches[name]}
    # every time above was taken with the queue held (cuda_ms fails if not)
    emit({"phase": "timing", **TIMING})

    print(card, flush=True)
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
