#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--trace-dir DIR]

Phases, each printing one JSON line:

1. build    compile every CUDA kernel from src/repro_torch/csrc/ (nvcc,
            sm_90a, one process per source, in parallel);
2. kernels  hold each kernel against its plain PyTorch version on the card
            at the main path's shapes and at ragged ones, and time the
            kernel, the plain version and, where one exists, the single
            PyTorch call computing the same function (timed only); K1 also
            gives bit-identical outputs on 1, 2, 4 and 8 CTAs, is timed on
            each and beside the composition it replaces (sum over ranks,
            K2, copy to every rank), and beside a plain copy kernel on the
            same 8 CTAs moving the same bytes (``budget_bound_ms``, a probe
            built here and used nowhere in the port); K3 adds the main
            path's first prefill split behind an empty cache row
            (``engine``, with the key tiles the live-tile table lets it
            visit), its second split at tp=8 (``engine_tp``: the ranks
            folded into the batch, one KV head each) and a sweep over G
            and head dim;
3. online   the serving front end and observability at full width
            (Llama-3.3-70B cut to 4 layers, bf16, packed + paged):
            8 requests (prompts of 300-1800 tokens, 32 new) served with
            a WallClockProfiler and a TraceRecorder at tp=1, then plain
            and profiled in turns (tokens, steps equal; the profiler's
            cost per step), ``fit_calibration`` on the measured forwards
            (its JSON and the Chrome traces go to --trace-dir/online/;
            the trace validates, its weave counts equal the engine's);
            the same requests through ``OnlineServer`` on the calibrated
            clock with Poisson arrivals, a cancel and an expiring
            deadline (TTFT, TPOT, e2e percentiles and goodput; pool
            drained; one terminal event per request; K3 held on the
            inputs it gave K3, ``main_path_k3``), and on a small
            float32 model with the online tokens gated equal to the
            offline ones; at tp=8 ``ring`` 4 requests profiled and plain
            (tokens equal), a fit, and each woven prefill's fenced wall
            not below the same call's CUDA-event time;
4. engine   serve 4 greedy requests through the two-dispatch Engine with
            Llama-3.3-70B's widths cut to 4 layers (bf16, random weights
            from the seed) at tp=1, and show from the launch counters that
            the main path ran through the kernels; then trace one prefill
            and one decode step of the model with torch.profiler and split
            their device time by kind of kernel; then hold K3 against its
            plain version on the inputs the run gave it, at each shape
            (``main_path_k3``);
5. engine_tp the same requests at tp=8 (the eight ranks on one card's rank
            axis) in comm mode "ring": K1 launches equal splits·(1+2L) per
            forward, so no forward fell back; one traced prefill call
            gives K1's device time and the part of it that overlapped
            other kernels (the weave's comm stream), and K3 is held on
            its inputs again; every traced call's Chrome trace is written
            to --trace-dir (build/traces/);
6. engine_packed  the same requests and a 5th that shares request 0's
            first 1024 prompt tokens (added once request 0's prefill is
            done: 64 blocks hit the prefix cache) through packed hybrid
            batching over the paged pool, at tp=1 (K2) and tp=8 (ring,
            K1): one ``packed_step`` line per step (segments, split, ms);
            K2/K1 launches equal splits·(1+2L) and K3's splits·L (every
            split's attention is one K3 call over its segments); K3 is
            held on the inputs of every shape it got; at tp=1 one mixed
            step with two splits is run again under the profiler, with
            the device time of the segments' gather, the scatter into the
            pool and the query/output layout apart (``breakdown``,
            engine_packed); each packed run's peak device memory (from
            the run's start: weights, pool and the run's activations)
            stays within 1.5 GB of the two-dispatch run's at its tp
            (``peak_memory``);
7. engine_paged  the two-dispatch engine over the paged pool at tp=1
            (paged prefill: gather, K3, insert; paged decode);
8. engine_moe  the MoE family at full width, random bf16 weights from
            the seed: Mixtral-8x22B (``ffn``: every rank a d_ff slice of
            all 8 experts; 4 of 56 layers) serves the engine phases' 4
            requests through the two-dispatch engine at tp=1 ``fused`` and
            tp=8 ``ring`` and, with the 5th sharing request, packed over
            the pool at tp=8 ``ring`` (``engine_moe_packed``); OLMoE-1B-7B
            (``expert``: 8 of its 64 experts a rank; all 16 layers) packed
            at tp=8 ``ring`` (``engine_moe_olmoe``).  Gated as the Llama
            runs (launch formulas, pools drained, K3 held at every shape
            it got, ``main_path_k3``); reported: step times, peaks, per
            forward the share of assignments capacity dropped and the
            assignments per expert (``moe_forwards``), and one traced
            prefill or mixed step whose device time the MoE layer's named
            ranges split into routing, dispatch, expert products and
            combine (``breakdown``);
9. moe_sync one ``moe_forward`` at Mixtral width over 2048 tokens at tp=1
            and tp=8 under ``torch.cuda.set_sync_debug_mode("error")``:
            the layer never waits for the card;
10. identity a small float32 model served on the card (kernels) and on the
            CPU (plain versions) must give identical greedy tokens, at
            tp=1 and at tp=2 in ring mode with the weave (and its streams)
            firing, through the two-dispatch engine over slots and
            through packed batching over the paged pool with a request
            that hits the prefix cache; so must its two MoE twins
            (``ffn`` and ``expert``), whose prefill also keeps every
            layer's expert choices equal on both devices.

Then a ``kernels`` summary line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}`` — printed only when every
phase passed.  Without a CUDA device, or without the repository's src/
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
K2_TOL = 1e-2                      # atol and rtol: one bf16 ulp at |x| < 8
# K1 sums the ranks in the plain version's order, so the reduced row is
# bit-equal; only sum(t^2)'s order and the rsqrt differ, as in K2
K1_TOL = 1e-2
# K3 tolerances scale with each case's output: its rms shrinks as 1/sqrt of
# the keys a query sees (about 0.024 at 4.6K keys), so a fixed atol would
# let a dropped key tile through.  A bf16 ulp is at most 2^-7 of a value.
K3_ATOL_RMS = 2.0 ** -5            # atol: four bf16 ulps of rms(plain)
K3_RTOL = 2.0 ** -7                # one ulp: kernel and plain round apart
K3_REL_FRO = 1e-2                  # ||kernel - plain||_F / ||plain||_F
# A fully masked row is the exact mean of V up to the kernel's own
# rounding to bf16, half an ulp, at most 2^-8 of the value.  Keys past Sk
# joining the average (the source note's trap) would scale it by
# Sk / (Sk rounded up to a tile), 0.47 % at Sk = 5096.
MASKED_RTOL = 2.0 ** -8
MASKED_ATOL = 1e-6
CTA_SWEEP = (1, 2, 4, 8)           # K1's budgets: bit-identical, each timed
IDENTITY_LOGIT_TOL = 1e-4          # float32, TF32 off: summation order only
# a packed run's peak over the two-dispatch run's at the same tp; the
# reference's per-token KV view would add 17 GB per layer
PACKED_PEAK_SLACK_GB = 1.5


# A plain copy on a K1-sized grid: what that many SMs can move on this
# card.  Built beside the port's kernels; the port never calls it.
COPY_PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(1024)
copy_probe(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 7 * stride < n; i += 8 * stride) {  // 8 loads in flight
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < 8; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < n; i += stride) dst[i] = src[i];
}
extern "C" int copy_probe_launch(const void* src, void* dst, long long n16,
                                 int ctas, void* stream) {
  copy_probe<<<ctas, 1024, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (uint4*)dst, n16);
  return (int)cudaGetLastError();
}
"""


def start_copy_probe_build():
    """Start nvcc on the copy probe (in parallel with the port's build)."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "copy_probe.cu").write_text(COPY_PROBE_SRC)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
           str(out / "libcopy_probe.so"), str(out / "copy_probe.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def load_copy_probe(proc_out):
    import ctypes
    proc, out = proc_out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"copy probe build failed:\n{log}")
    lib = ctypes.CDLL(str(out / "libcopy_probe.so"))
    lib.copy_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.copy_probe_launch.restype = ctypes.c_int
    return lib


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of one call of ``fn``: ``iters`` calls are
    captured in a CUDA graph after a warm-up call, and one replay is timed
    with CUDA events, so host-side launch cost does not count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, iters: int = 20) -> float:
    """Mean host time of one call of ``fn``: the time to enqueue its work,
    without the profiler, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, atol, rtol) -> float:
    """Every element within ``atol + rtol * |want|``; returns the max abs
    error."""
    err = max_err(got, want)
    bad = ((got.float() - want.float()).abs()
           > atol + rtol * want.float().abs()).sum().item()
    if bad:
        raise AssertionError(f"{name}: {bad} elements beyond atol={atol} "
                             f"rtol={rtol} (max abs err {err})")
    return err


def rel_fro(got, want) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------

def check_k3(torch, name, q, k, v, qpos, kpos, *, causal, window=0,
             sm_scale=None) -> dict:
    """Hold K3 against its plain version on these inputs (every element
    within atol = K3_ATOL_RMS * rms(plain) + K3_RTOL * |plain|, and the
    relative Frobenius error within K3_REL_FRO), and every query row with
    no visible key against the mean of V over all Sk keys of its KV head.
    Returns the case's fields, with the key tiles the live-tile table lets
    the kernel visit (bfloat16)."""
    from repro_torch.kernels import flash_attention as K3
    b, sq, kvh, g, dh = q.shape
    kw = dict(causal=causal, window=window, sm_scale=sm_scale)
    out = K3.flash_attention(q, k, v, qpos, kpos, **kw)
    torch.cuda.synchronize()
    plain = K3.flash_attention_plain(q, k, v, qpos, kpos, **kw)
    rms = float(plain.float().pow(2).mean().sqrt())
    atol = K3_ATOL_RMS * rms
    err = check_close(name, out, plain, atol, K3_RTOL)
    fro = rel_fro(out, plain)
    if not fro <= K3_REL_FRO:
        raise AssertionError(f"{name}: relative Frobenius error {fro} > "
                             f"{K3_REL_FRO}")
    del plain
    case = {"B": b, "Sq": sq, "Sk": k.shape[1], "KVH": kvh, "G": g,
            "dh": dh, "window": window, "dtype": str(q.dtype)[6:],
            "rms_plain": rms, "max_abs_err": err, "atol": atol,
            "rtol": K3_RTOL, "rel_fro_err": fro, "rel_fro_tol": K3_REL_FRO}
    if q.dtype == torch.bfloat16:
        rows, keys, _ = K3.tiling()
        live = K3.live_tiles(qpos, kpos, causal=causal, window=window,
                             queries_per_cta=rows // g, keys_per_tile=keys)
        case.update(key_tiles_visited=int((live > 0).sum()) * kvh,
                    key_tiles_total=live.numel() * kvh)
    masked = ~K3.attention_mask(qpos, kpos, causal, window).any(-1)
    if bool(masked.any()):
        want = v.float().mean(dim=1)[:, None, :, None].expand(
            b, sq, kvh, g, dh)[masked]
        case.update(
            masked_rows=int(masked.sum()),
            masked_rows_err=check_close(f"{name} fully masked rows",
                                        out[masked], want, MASKED_ATOL,
                                        MASKED_RTOL),
            masked_rows_rel_fro_err=rel_fro(out[masked], want),
            masked_rows_atol=MASKED_ATOL, masked_rows_rtol=MASKED_RTOL)
    return case


def kernel_phase(torch, seed: int, probe):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import fused_rmsnorm as K2

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev, bf16 = "cuda", torch.bfloat16
    rows = {}

    d = 8192
    k2_err = 0.0
    for t in (8, 32, 1000, 2048):
        x = torch.randn(t, d, generator=gen, device=dev, dtype=bf16)
        r = torch.randn(t, d, generator=gen, device=dev, dtype=bf16)
        w = (torch.randn(d, generator=gen, device=dev).abs() + 0.5).to(bf16)
        out, new_res = K2.fused_residual_rmsnorm(x, r, w)
        torch.cuda.synchronize()
        p_out, p_res = K2.fused_residual_rmsnorm_plain(x, r, w)
        err = max(check_close(f"K2 out T={t}", out, p_out, K2_TOL, K2_TOL),
                  check_close(f"K2 residual T={t}", new_res, p_res, K2_TOL,
                              K2_TOL))
        k2_err = max(k2_err, err)
        case = {"phase": "kernels", "kernel": "fused_residual_rmsnorm",
                "T": t, "d": d, "dtype": "bfloat16", "max_abs_err": err,
                "tol": K2_TOL}
        if t == 2048:
            nbytes = 4 * t * d * 2 + d * 2
            case.update(
                ms=time_ms(torch, lambda: K2.fused_residual_rmsnorm(x, r, w)),
                plain_ms=time_ms(
                    torch, lambda: K2.fused_residual_rmsnorm_plain(x, r, w)),
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             5 * t * d / FP32_FLOPS) * 1e3,
                bound_by="bytes", library_ms=None)
            rows["fused_residual_rmsnorm"] = case
        emit(case)

    # K1: N ranks' partials (N, T, d) and residual slices (N, T/N, d)
    from repro_torch.core import fused_collectives as FC
    from repro_torch.distributed.context import CommCtx
    from repro_torch.kernels import ar_rmsnorm as K1
    gen1 = torch.Generator(device="cuda").manual_seed(seed + 1)
    k1_err = 0.0
    for n, t, d1 in ([(n, t, 8192) for n in (2, 4, 8) for t in (8, 2048)]
                     + [(8, 32, 8192), (8, 1000, 8190)]):
        x = torch.randn(n, t, d1, generator=gen1, device=dev, dtype=bf16)
        r = torch.randn(n, t // n, d1, generator=gen1, device=dev,
                        dtype=bf16)
        w = (torch.randn(d1, generator=gen1, device=dev).abs() + 0.5
             ).to(bf16)
        out, new_res = K1.ar_rmsnorm(x, r, w, ctas=K1.MAX_CTAS)
        for c in CTA_SWEEP[:-1]:
            out1, new_res1 = K1.ar_rmsnorm(x, r, w, ctas=c)
            torch.cuda.synchronize()
            if not (torch.equal(out, out1) and torch.equal(new_res, new_res1)):
                raise AssertionError(f"K1 N={n} T={t} d={d1}: {c} and "
                                     f"{K1.MAX_CTAS} CTAs differ")
        p_out, p_res = K1.ar_rmsnorm_plain(x, r, w)
        err = max(check_close(f"K1 out N={n} T={t} d={d1}", out, p_out,
                              K1_TOL, K1_TOL),
                  check_close(f"K1 residual N={n} T={t} d={d1}", new_res,
                              p_res, K1_TOL, K1_TOL))
        k1_err = max(k1_err, err)
        case = {"phase": "kernels", "kernel": "ar_rmsnorm", "N": n, "T": t,
                "d": d1, "dtype": "bfloat16", "max_abs_err": err,
                "tol": K1_TOL, "ctas_bit_identical": list(CTA_SWEEP)}
        if (n, t, d1) == (8, 2048, 8192):
            # the composition K1 replaces: sum over ranks, K2, all-gather
            ctx = CommCtx(mode="fused", use_pallas=True, tp=n)
            c_out, c_res = FC.comm_norm(x, r, w, ctx=ctx)
            case["composition_max_abs_err"] = max(
                check_close("K1 vs composition", out, c_out, K1_TOL, K1_TOL),
                check_close("K1 vs composition residual", new_res, c_res,
                            K1_TOL, K1_TOL))
            # each input read once, each output written once
            nbytes = 2 * (n + 1) * t * d1 * 2 + d1 * 2
            flops = (n + 5) * t * d1
            ms_ctas = {c: time_ms(torch, lambda c=c: K1.ar_rmsnorm(
                x, r, w, ctas=c)) for c in CTA_SWEEP}
            # the same bytes through a plain copy on the same 8 CTAs
            src = torch.empty(nbytes // 32 * 16, dtype=torch.uint8,
                              device=dev)    # half read, half written
            dst = torch.empty_like(src)

            def copy():
                rc = probe.copy_probe_launch(
                    src.data_ptr(), dst.data_ptr(), src.numel() // 16,
                    K1.MAX_CTAS, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"copy probe: CUDA error {rc}")
            case.update(
                ms=ms_ctas[K1.MAX_CTAS],
                ms_by_ctas={str(c): ms for c, ms in ms_ctas.items()},
                budget_bound_ms=time_ms(torch, copy),
                plain_ms=time_ms(
                    torch, lambda: K1.ar_rmsnorm_plain(x, r, w), iters=3),
                composition_ms=time_ms(
                    torch, lambda: FC.comm_norm(x, r, w, ctx=ctx)),
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             flops / FP32_FLOPS) * 1e3,
                bound_by="bytes", library_ms=None)
            del src, dst
            case["achieved_gb_per_s"] = nbytes / case["ms"] / 1e6
            case["achieved_gb_per_s_1cta"] = nbytes / ms_ctas[1] / 1e6
            case["budget_gb_per_s"] = nbytes / case["budget_bound_ms"] / 1e6
            rows["ar_rmsnorm"] = case
        emit(case)
        del x, r, out, out1, p_out, p_res
    torch.cuda.empty_cache()

    k3_err = 0.0

    def positions(sq, sk, q0, k_valid, b=1, k_at=0):
        """qpos q0..; kpos: the sk - sq keys before the chunk are empty
        cache slots (-1) but for k_valid keys at 0.. from index k_at, then
        the chunk's own keys at q0.."""
        qpos = torch.arange(q0, q0 + sq, dtype=torch.int32, device=dev)
        kpos = torch.full((sk,), -1, dtype=torch.int32, device=dev)
        kpos[k_at:k_at + k_valid] = torch.arange(k_valid, dtype=torch.int32,
                                                 device=dev)
        kpos[sk - sq:] = qpos
        return (qpos[None].repeat(b, 1).contiguous(),
                kpos[None].repeat(b, 1).contiguous())

    # (name, B, Sq, Sk, KVH, G, dh, window, q0, cache keys valid, index of
    # the first valid one, padded query rows); every case causal, bf16
    cases = [
        # a 1024-token split behind a full 4096-slot row
        ("main", 1, 1024, 4096 + 1024, 8, 8, 128, 0, 4096, 4096, 0, 0),
        # the main path's first prefill split: a fresh request's empty
        # 4096-slot row, then the chunk's own keys
        ("engine", 1, 1024, 4096 + 1024, 8, 8, 128, 0, 0, 0, 0, 0),
        # its second split at tp=8, the ranks folded into the batch (one
        # KV head each): the empty row, the first split's 1024 keys, then
        # its own 776 tokens and the chunk's 56 padded rows
        ("engine_tp", 8, 832, 4096 + 1024 + 832, 1, 8, 128, 0, 1024, 1024,
         4096, 56),
        # ragged Sk, empty cache slots, padded prefill rows (qpos -1)
        ("padded", 1, 1000, 4096 + 1000, 8, 8, 128, 0, 1000, 1000, 0, 56),
        ("window", 1, 512, 1536, 8, 8, 128, 256, 1024, 1024, 0, 0),
        # the other GQA groups and head dims of the configs, ragged
        ("g1_d64", 2, 300, 1000, 2, 1, 64, 0, 700, 600, 0, 20),
        ("g5_d128", 1, 257, 1000, 3, 5, 128, 300, 743, 743, 0, 0),
        ("g16_d64", 1, 100, 4096 + 100, 2, 16, 64, 0, 0, 0, 0, 7),
    ]
    for (name, b, sq, sk, kvh, g, dh, window, q0, k_valid, k_at,
         pad) in cases:
        qpos, kpos = positions(sq, sk, q0, k_valid, b, k_at)
        if pad:
            qpos[:, -pad:] = -1          # their keys are padding too
            kpos[:, -pad:] = -1
        q = torch.randn(b, sq, kvh, g, dh, generator=gen, device=dev,
                        dtype=bf16)
        k = torch.randn(b, sk, kvh, dh, generator=gen, device=dev, dtype=bf16)
        v = torch.randn(b, sk, kvh, dh, generator=gen, device=dev, dtype=bf16)
        kw = dict(causal=True, window=window)
        case = {"phase": "kernels", "kernel": "flash_attention", "case": name,
                **check_k3(torch, f"K3 {name}", q, k, v, qpos, kpos, **kw)}
        k3_err = max(k3_err, case["max_abs_err"])
        if name.startswith("engine") and not (case["key_tiles_visited"]
                                              < case["key_tiles_total"]):
            raise AssertionError(f"K3 {name}: no key tile skipped ({case})")
        if name in ("main", "engine", "engine_tp"):
            qs = q.reshape(b, sq, kvh * g, dh).transpose(1, 2).contiguous()
            ks = k.transpose(1, 2).contiguous()
            vs = v.transpose(1, 2).contiguous()
            mask = K3.attention_mask(qpos, kpos, True, window)[:, None]
            # only the (query, key) pairs the mask lets through need work
            pairs = int(mask.sum())
            flops = 4 * dh * kvh * g * pairs
            nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * (sq + sk)
            case.update(
                visible_pairs=pairs,
                ms=time_ms(torch, lambda: K3.flash_attention(q, k, v, qpos,
                                                             kpos, **kw)),
                plain_ms=time_ms(torch, lambda: K3.flash_attention_plain(
                    q, k, v, qpos, kpos, **kw), iters=3),
                bound_ms=max(flops / BF16_FLOPS,
                             nbytes / HBM_BYTES_PER_S) * 1e3,
                bound_by=("operations" if flops / BF16_FLOPS
                          > nbytes / HBM_BYTES_PER_S else "bytes"),
                library_ms=time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=mask, scale=dh ** -0.5,
                        enable_gqa=True)))
            # what the host spends per call: the wrapper, and the
            # live-tile table's torch ops alone
            rows_cta, keys, _ = K3.tiling()
            case.update(
                host_ms=host_ms(torch, lambda: K3.flash_attention(
                    q, k, v, qpos, kpos, **kw)),
                table_host_ms=host_ms(torch, lambda: K3.live_tiles(
                    qpos, kpos, queries_per_cta=rows_cta // g,
                    keys_per_tile=keys, **kw)))
            if name == "main":
                rows["flash_attention"] = case
        emit(case)
        del q, k, v
        torch.cuda.empty_cache()
    rows["fused_residual_rmsnorm"]["max_abs_err"] = k2_err
    rows["ar_rmsnorm"]["max_abs_err"] = k1_err
    rows["flash_attention"]["max_abs_err"] = k3_err
    return rows


# --------------------------------------------------------------------------
# phases 3 and 4: the engine at full width, at tp=1 and at tp=8
# --------------------------------------------------------------------------

def reset_launches():
    from repro_torch.kernels import ar_rmsnorm as K1
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import fused_rmsnorm as K2
    for fn in (K1.ar_rmsnorm, K2.fused_residual_rmsnorm, K3.flash_attention):
        fn.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import ar_rmsnorm as K1
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import fused_rmsnorm as K2
    return {"ar_rmsnorm": K1.ar_rmsnorm.launches,
            "fused_residual_rmsnorm": K2.fused_residual_rmsnorm.launches,
            "flash_attention": K3.flash_attention.launches}


def capture_k3_inputs(store: dict):
    """Make the model path keep a copy of K3's inputs at each shape it
    gives the kernel (the first call of each) in ``store``, so that they
    can be checked once the run is over; the calls still go through the
    wrapper, which counts the launches.  The copies are taken on the card
    (a copy kernel, in order with the run); ``offload`` moves them to the
    host between steps, outside the timed region, so a phase's peak
    memory holds at most one step's copies.  Returns the undo."""
    from repro_torch.layers import attention as A
    wrapper = A.flash_attention

    def keep(q, k, v, qpos, kpos, **kw):
        key = (tuple(q.shape), tuple(k.shape), q.dtype,
               tuple(sorted(kw.items())))
        if key not in store:
            store[key] = ([t.clone() for t in (q, k, v, qpos, kpos)], kw)
        return wrapper(q, k, v, qpos, kpos, **kw)

    A.flash_attention = keep
    return lambda: setattr(A, "flash_attention", wrapper)


def offload(store: dict) -> None:
    """Move ``capture_k3_inputs``' copies to the host."""
    for key, (tensors, kw) in store.items():
        store[key] = ([t.cpu() for t in tensors], kw)


def check_main_path_k3(torch, store: dict, engine: str, tp: int) -> float:
    """Hold K3 on the inputs ``capture_k3_inputs`` kept, shape by shape,
    emitting one ``main_path_k3`` line each; returns the max abs error."""
    torch.cuda.synchronize()
    if not store:
        raise AssertionError(f"{engine}: the model path reached no K3 call")
    k3_err = 0.0
    for tensors, kw in store.values():
        tensors = [t.cuda() for t in tensors]
        case = check_k3(torch, f"K3 {engine} main path "
                        f"{tuple(tensors[0].shape)}", *tensors, **kw)
        k3_err = max(k3_err, case["max_abs_err"])
        emit({"phase": "main_path_k3", "engine": engine, "tp": tp, **case})
        del tensors
    store.clear()
    torch.cuda.empty_cache()
    return k3_err


PROMPT_LENS, NEW_TOKENS = (1800, 1200, 700, 300), 16
SHARED_PREFIX, SHARER_OWN = 1024, 200   # the 5th request of engine_packed


def full_width_model(torch, np, seed: int, *, tp: int, comm_mode: str,
                     n_layers: int, config=None):
    """A registry model's widths (Llama-3.3-70B unless ``config``) cut to
    ``n_layers``, bf16, random weights from the seed at ``tp`` ranks, and
    the phases' prompts.  Collects what earlier phases left first (their
    engines sit in reference cycles through the timing wrappers); returns
    the memory still allocated then, which should be none of theirs."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models.build import build_model

    cfg = dataclasses.replace(config or get_config("llama3.3-70b"),
                              num_layers=n_layers)
    pcfg = ParallelConfig(comm_mode=comm_mode, attn_impl="pallas",
                          use_pallas_norm=True)
    api = build_model(cfg, pcfg, tp=tp)
    gc.collect()
    torch.cuda.empty_cache()
    start_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = api.init(seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    return cfg, api, params, prompts, init_s, start_gb


class MoeStats:
    """Per forward of a run: the MoE assignments each expert got and the
    share capacity dropped.  The counts are taken on the card, in stream
    order with the dispatch (no host sync), and read after the run;
    ``step`` closes a forward.  A no-op for a dense model."""

    def __init__(self, torch, cfg):
        from repro_torch.layers import moe
        self.torch, self.cfg, self.mod = torch, cfg, moe
        self.orig = moe._capacity_dispatch
        self.calls, self.forwards = [], []
        if not cfg.is_moe:
            return
        experts = torch.arange(cfg.num_experts, device="cuda")
        ffn = cfg.moe_partition == "ffn"     # every rank holds every expert

        def count(x, topi, topw, **kw):
            buf, slot, flat_w = self.orig(x, topi, topw, **kw)
            kept = (slot[:1] if ffn else slot).ge(0).sum()
            load = (topi[0].reshape(-1, 1) == experts).sum(0)
            self.calls.append((topi.shape[1], torch.cat([load, kept[None]])))
            return buf, slot, flat_w

        moe._capacity_dispatch = count

    def step(self):
        if self.calls:
            self.forwards.append(self.calls)
            self.calls = []

    def undo(self):
        self.mod._capacity_dispatch = self.orig

    def summary(self) -> dict:
        """Per forward: tokens (over its splits), the share of its T·k
        assignments dropped, and each expert's assignments per layer
        (min, mean, max; the list itself for at most 8 experts)."""
        cfg, k, n_layers = self.cfg, self.cfg.num_experts_per_tok, \
            self.cfg.num_layers
        rows, total = [], 0
        for calls in self.forwards:
            counts = self.torch.stack([c for _, c in calls]).sum(0).cpu()
            tokens = sum(t for t, _ in calls) // n_layers
            load = (counts[:-1].double() / n_layers).tolist()
            assigned = tokens * k * n_layers
            row = {"tokens": tokens, "splits": len(calls) // n_layers,
                   "drop_share": 1 - int(counts[-1]) / assigned,
                   "load_min": min(load), "load_mean": tokens * k
                   / cfg.num_experts, "load_max": max(load)}
            if cfg.num_experts <= 8:
                row["load"] = load
            rows.append(row)
            total += assigned
        dropped = sum(r["drop_share"] * r["tokens"] * k * n_layers
                      for r in rows)
        return {"forwards": rows, "drop_share": dropped / max(total, 1),
                "capacity_factor": cfg.capacity_factor}


def moe_ranges(cfg) -> dict:
    """The MoE layer's named ranges (label -> range) for
    ``device_breakdown``; none for a dense model."""
    if not cfg.is_moe:
        return {}
    from repro_torch.layers import moe
    return {"moe_route": moe.ROUTE_RANGE, "moe_dispatch": moe.DISPATCH_RANGE,
            "moe_experts": moe.EXPERTS_RANGE,
            "moe_combine": moe.COMBINE_RANGE}


def reset_peak(torch) -> float:
    """Start a run's peak-memory count from what is allocated now (the
    weights and the KV cache or pool); returns that, in GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def check_launches(eng, launches, *, norm_kernel: str, n_layers: int,
                   k3_splits: int) -> dict:
    """Every forward's add+norm slots ran the mode's kernel (so none fell
    back to vanilla, which launches neither K1 nor K2): splits·(1+2L)
    launches; K3 ran once per layer of each of ``k3_splits`` splits."""
    st = eng.stats
    splits = st.forwards + st.weave_forwards
    want = {"ar_rmsnorm": 0, "fused_residual_rmsnorm": 0,
            "flash_attention": k3_splits * n_layers}
    want[norm_kernel] = splits * (1 + 2 * n_layers)
    if launches != want or 0 in (launches[norm_kernel],
                                 launches["flash_attention"]):
        raise AssertionError(f"launches {launches}, expected {want}")
    return want


def check_outputs(done, n_requests: int, vocab: int, new_tokens: int):
    if sorted(r.rid for r in done) != list(range(n_requests)):
        raise AssertionError(f"finished {[r.rid for r in done]}")
    for r in done:
        if len(r.output) != new_tokens or not all(
                0 <= t < vocab for t in r.output):
            raise AssertionError(f"rid {r.rid} output {r.output}")


def check_drained(eng) -> None:
    """No block table left and no block referenced in the paged pool."""
    mgr = eng.block_mgr
    if mgr.tables or any(mgr.alloc.ref):
        raise AssertionError("the pool did not drain")


def engine_phase(torch, np, seed: int, trace_dir: Path, *, tp: int,
                 comm_mode: str, paged: bool = False, n_layers: int = 4,
                 config=None, phase: str = ""):
    """Serve the 4 requests through the two-dispatch engine at ``tp``
    ranks on the card's rank axis, over legacy slots or (``paged``) the
    paged pool; the add+norm slots run K2 (``fused``) or K1 (``ring``).
    ``config``: the model (Llama-3.3-70B by default), ``phase`` its
    lines' name.  Returns (launches, K3's max error on the run's inputs,
    peak GB)."""
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    phase = phase or ("engine_paged" if paged else ("engine" if tp == 1
                                                    else "engine_tp"))
    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, prompts, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode, n_layers=n_layers,
        config=config)

    # a direct prefill of request 0 must give finite logits of the right
    # shape, and the engine's first token for it must be their argmax
    cache_rows = api.init_cache(1, SchedulerConfig().max_len, device="cuda")
    chunk = 1856                       # what the scheduler pads 1800 to
    tokens = torch.zeros(1, chunk, dtype=torch.long, device="cuda")
    tokens[0, :1800] = torch.tensor(prompts[0], device="cuda")
    pos = torch.full((1, chunk), -1, dtype=torch.int32, device="cuda")
    pos[0, :1800] = torch.arange(1800, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits, _ = api.prefill(params, tokens, cache_rows, pos,
                                last_idx=torch.tensor([1799], device="cuda"))
    v_loc = params["embedding"]["embed"].shape[1]
    if logits.shape != (tp, 1, 1, v_loc) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"not finite / wrong shape")
    first_tok = int(sharded_argmax(logits, vocab_size=cfg.vocab_size)[0, 0])
    del logits

    eng = Engine(api, params, SchedulerConfig(paged=paged))
    times = {"prefill": [], "decode": []}
    k3_inputs = {}
    stats = MoeStats(torch, cfg)

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t) * 1e3)
            offload(k3_inputs)
            stats.step()
        return run

    eng._run_prefill = timed("prefill", eng._run_prefill)
    eng._run_decode = timed("decode", eng._run_decode)
    for i, p in enumerate(prompts):
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))

    undo = capture_k3_inputs(k3_inputs)
    try:
        run_start_gb = reset_peak(torch)
        reset_launches()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        undo()
        stats.undo()
    peak = torch.cuda.max_memory_allocated() / 1e9

    check_outputs(done, len(prompts), cfg.vocab_size, NEW_TOKENS)
    out0 = next(r for r in done if r.rid == 0).output[0]
    if out0 != first_tok:
        raise AssertionError(f"engine's first token {out0} != direct "
                             f"prefill argmax {first_tok}")
    st = eng.stats
    pf = eng.metrics.get("engine/site_forwards", site="prefill").value
    pw_inst = eng.metrics.get("engine/site_weave", site="prefill")
    pf_splits = pf + (pw_inst.value if pw_inst is not None else 0)
    want = check_launches(eng, launches, norm_kernel=norm_kernel,
                          n_layers=n_layers, k3_splits=pf_splits)
    row = {"phase": phase, "model": cfg.name, "tp": tp,
           "comm_mode": comm_mode, "paged": paged, "layers": n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "prompt_lens": list(PROMPT_LENS), "new_tokens": NEW_TOKENS,
           "forwards": st.forwards, "weave_forwards": st.weave_forwards,
           "prefill_forwards": pf, "prefill_splits": pf_splits,
           "launches": launches, "expected_launches": want,
           "param_init_s": init_s, "wall_s": wall_s,
           "prefill_ms": times["prefill"], "decode_ms": times["decode"],
           "prefill_ms_median": statistics.median(times["prefill"]),
           "decode_ms_median": statistics.median(times["decode"]),
           "allocated_at_start_gb": start_gb,
           "allocated_at_run_start_gb": run_start_gb,
           "max_memory_allocated_gb": peak}
    if paged:
        row["prefix_hit_tokens"] = eng.block_mgr.stats.hit_tokens
    emit(row)
    if cfg.is_moe:
        emit({"phase": "moe_forwards", "engine": phase, "tp": tp,
              **stats.summary()})

    if not paged:
        # where a step's time goes: request 0's whole prefill chunk, and
        # one decode step over the 8 slots (4 active), warm after the run
        last = torch.tensor([1799], device="cuda")
        dtok = torch.zeros(eng.scfg.max_batch, 1, dtype=torch.long,
                           device="cuda")
        dpos = torch.full((eng.scfg.max_batch, 1), -1, dtype=torch.int32,
                          device="cuda")
        dpos[:len(PROMPT_LENS), 0] = torch.tensor(
            [n + NEW_TOKENS - 1 for n in PROMPT_LENS], device="cuda")
        with torch.no_grad():
            for step, fn in (
                    ("prefill", lambda: api.prefill(
                        params, tokens, cache_rows, pos, last_idx=last)),
                    ("decode", lambda: api.decode_step(
                        params, dtok, eng.cache, dpos))):
                trace = trace_dir / f"{phase}_tp{tp}_{step}_trace.json"
                brk = device_breakdown(torch, fn, trace,
                                       ranges=moe_ranges(cfg))
                if tp > 1 and step == "prefill" and not brk["k1_launches"]:
                    raise AssertionError("no K1 kernel in the traced "
                                         "prefill")
                emit({"phase": "breakdown", "engine": phase, "tp": tp,
                      "step": step, "tokens":
                      chunk if step == "prefill" else eng.scfg.max_batch,
                      **brk})
    del eng, params, cache_rows
    torch.cuda.empty_cache()

    # K3 at every shape this run gave it, on the inputs it got there
    return launches, check_main_path_k3(torch, k3_inputs, phase, tp), peak


class RecordPackedSteps:
    """The model API with its packed steps' inputs kept (the tokens on
    the card, the host arrays), so that one step can be run again."""

    def __init__(self, api):
        self._api = api
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._api, name)

    def packed_step(self, params, tokens, cache, positions, **kw):
        self.calls.append((tokens, positions, kw))
        return self._api.packed_step(params, tokens, cache, positions, **kw)


def serve_with_sharer(eng, Request, prompts, new_tokens: int, sharer):
    """Serve ``prompts`` (rids 0..n-1) and, once request 0's prefill is
    done, one more request whose prompt is ``sharer`` (rid n): its
    admission finds request 0's full blocks in the prefix cache.  Returns
    (finished requests, the sharer)."""
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    late = Request(rid=len(prompts), prompt=sharer,
                   max_new_tokens=new_tokens)
    added = False
    while True:
        if not added and reqs[0].prefill_done:
            eng.add_request(late)
            added = True
        if not eng.step():
            break
    if not added:
        raise AssertionError("request 0 never finished its prefill")
    return eng.sched.finished, late


def packed_phase(torch, np, seed: int, trace_dir: Path, *, tp: int,
                 comm_mode: str, n_layers: int = 4, config=None,
                 phase: str = "engine_packed"):
    """Serve the 4 requests and a 5th that repeats request 0's first 1024
    prompt tokens (64 blocks of 16) and adds 200 of its own, through
    packed hybrid batching over
    the paged pool (the defaults of ``SchedulerConfig(paged=True,
    packed=True)``): one forward per step, its splits' attention K3 over
    the segments.  At tp=1, one mixed step (decode and prefill segments,
    two splits) is run again under the profiler, as it is at any tp for a
    MoE model (``config``; Llama-3.3-70B by default), whose expert parts
    the profile splits apart.  Returns (launches, K3's max error on the
    run's inputs, peak GB)."""
    from repro_torch.layers import attention as A
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, prompts, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode, n_layers=n_layers,
        config=config)
    rng = np.random.RandomState(seed + 5)
    sharer = (prompts[0][:SHARED_PREFIX]
              + rng.randint(0, cfg.vocab_size, SHARER_OWN).tolist())
    scfg = SchedulerConfig(paged=True, packed=True)
    eng = Engine(api, params, scfg)
    rec = RecordPackedSteps(api)
    eng.api = rec
    steps, k3_inputs = [], {}
    stats = MoeStats(torch, cfg)
    run_packed = eng._run_packed

    def timed(plan):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_packed(plan)
        torch.cuda.synchronize()
        kinds = {s.kind for s in plan.segments}
        steps.append({"segments": [[s.kind, s.n_tokens]
                                   for s in plan.segments],
                      "tokens": plan.total_tokens,
                      "split": plan.overlap.split,
                      "kind": "prefill" if "prefill" in kinds else "decode",
                      "mixed": kinds == {"prefill", "decode"},
                      "ms": (time.perf_counter() - t) * 1e3})
        offload(k3_inputs)
        stats.step()
    eng._run_packed = timed

    undo = capture_k3_inputs(k3_inputs)
    try:
        run_start_gb = reset_peak(torch)
        reset_launches()
        t0 = time.perf_counter()
        done, late = serve_with_sharer(eng, Request, prompts, NEW_TOKENS,
                                       sharer)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        undo()
        stats.undo()
    peak = torch.cuda.max_memory_allocated() / 1e9

    check_outputs(done, len(prompts) + 1, cfg.vocab_size, NEW_TOKENS)
    hit_blocks = late.prompt_hit_tokens // scfg.block_size
    if hit_blocks != SHARED_PREFIX // scfg.block_size:
        raise AssertionError(f"the 5th request hit {hit_blocks} blocks of "
                             f"the prefix cache, not "
                             f"{SHARED_PREFIX // scfg.block_size}")
    check_drained(eng)
    mgr = eng.block_mgr
    st = eng.stats
    want = check_launches(eng, launches, norm_kernel=norm_kernel,
                          n_layers=n_layers,
                          k3_splits=st.forwards + st.weave_forwards)
    for i, step in enumerate(steps):
        emit({"phase": "packed_step", "engine": phase, "tp": tp, "step": i,
              **step})
    by_kind = {k: [s["ms"] for s in steps if s["kind"] == k]
               for k in ("prefill", "decode")}
    emit({"phase": phase, "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "layers": n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype,
          "prompt_lens": list(PROMPT_LENS) + [len(sharer)],
          "new_tokens": NEW_TOKENS, "block_size": scfg.block_size,
          "num_blocks": scfg.effective_num_blocks,
          "chunk_tokens": scfg.chunk_tokens,
          "forwards": st.forwards, "weave_forwards": st.weave_forwards,
          "launches": launches, "expected_launches": want,
          "prefix_hit_blocks_5th": hit_blocks,
          "prefix_hit_tokens": mgr.stats.hit_tokens,
          "param_init_s": init_s, "wall_s": wall_s,
          "prefill_step_ms": by_kind["prefill"],
          "decode_step_ms": by_kind["decode"],
          "prefill_step_ms_median": statistics.median(by_kind["prefill"]),
          "decode_step_ms_median": statistics.median(by_kind["decode"]),
          "allocated_at_start_gb": start_gb,
          "allocated_at_run_start_gb": run_start_gb,
          "max_memory_allocated_gb": peak})
    if cfg.is_moe:
        emit({"phase": "moe_forwards", "engine": phase, "tp": tp,
              **stats.summary()})

    if tp == 1 or cfg.is_moe:
        # one mixed step with two splits, run again on the pool after the
        # run (its requests' blocks are still in place; the pool never
        # ran dry): where its time goes
        pick = next(i for i, s in enumerate(steps)
                    if s["mixed"] and s["split"] is not None)
        tokens, positions, kw = rec.calls[pick]
        trace = trace_dir / f"{phase}_tp{tp}_step_trace.json"
        with torch.no_grad():
            brk = device_breakdown(
                torch, lambda: api.packed_step(params, tokens, eng.cache,
                                               positions, **kw),
                trace, ranges={"scatter": A.SCATTER_RANGE,
                               "gather": A.GATHER_RANGE,
                               "layout": A.LAYOUT_RANGE, **moe_ranges(cfg)})
        emit({"phase": "breakdown", "engine": phase, "tp": tp,
              "step": "packed", "packed_step": pick,
              "segments": steps[pick]["segments"],
              "split": steps[pick]["split"], **brk})
    del eng, rec, params
    torch.cuda.empty_cache()
    return launches, check_main_path_k3(torch, k3_inputs, phase, tp), peak


# --------------------------------------------------------------------------
# speculative decoding at full width: engine_spec and verify_weave
# --------------------------------------------------------------------------

SPEC_BLOCK, SPEC_NEW_TOKENS, SPEC_GAMMA = 64, 64, 3
VERIFY_ROWS, VERIFY_CACHE, VERIFY_FILLED = 128, 1024, 960
VERIFY_REL_FRO = 1e-2          # weave-on logits against the unsplit call's


def spec_prompts(np, seed: int, vocab: int):
    """One seeded 64-token block repeated up to each of PROMPT_LENS:
    prompt-lookup traffic (code editing, retrieval-grounded chat)."""
    block = np.random.RandomState(seed + 15).randint(0, vocab,
                                                     SPEC_BLOCK).tolist()
    return [(block * -(-n // SPEC_BLOCK))[:n] for n in PROMPT_LENS]


def serve_steps(torch, eng, Request, prompts, new_tokens: int, store: dict):
    """Serve ``prompts`` one timed step at a time (the card synchronized
    around each).  Returns (requests, steps): per step its ms, whether it
    prefilled, whether it verified, and the tokens it committed."""
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    st, steps = eng.stats, []
    while True:
        before = (st.prefill_tokens, st.spec.verify_steps,
                  sum(len(r.output) for r in reqs))
        torch.cuda.synchronize()
        t = time.perf_counter()
        more = eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        offload(store)
        if not more:
            return reqs, steps
        steps.append({"ms": ms, "prefill": st.prefill_tokens > before[0],
                      "verify": st.spec.verify_steps > before[1],
                      "tokens": sum(len(r.output) for r in reqs)
                      - before[2]})


def decode_summary(steps) -> dict:
    """Times of the steps that prefilled nothing: their median, and their
    wall per token they committed."""
    dec = [s for s in steps if not s["prefill"]]
    return {"decode_steps": len(dec),
            "decode_step_ms_median": statistics.median(s["ms"] for s in dec),
            "decode_ms_per_token": (sum(s["ms"] for s in dec)
                                    / sum(s["tokens"] for s in dec)),
            "ms_per_token": (sum(s["ms"] for s in steps)
                             / sum(s["tokens"] for s in steps))}


def spec_phase(torch, np, seed: int, *, tp: int, comm_mode: str,
               packed: bool = True, n_layers: int = 4):
    """Serve the 4 prompt-lookup requests (64 new tokens each, greedy)
    with speculative decoding (n-gram draft, gamma 3) over the paged pool,
    packed (verify windows are segments of K3's packed steps) or
    two-dispatch (``verify_step``), then the same engine with spec off on
    the same prompts.  Returns (launches of both runs, K3's max error on
    the spec run's inputs)."""
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, _, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode, n_layers=n_layers)
    prompts = spec_prompts(np, seed, cfg.vocab_size)
    runs, k3_inputs, total = {}, {}, {}
    for gamma in (SPEC_GAMMA, 0):
        scfg = SchedulerConfig(paged=True, packed=packed, spec_gamma=gamma)
        eng = Engine(api, params, scfg)
        draft_ms = []
        if gamma:
            # the drafting is host work: its time per step, on its own
            propose = eng.draft.propose

            def timed_propose(contexts, propose=propose):
                t = time.perf_counter()
                out = propose(contexts)
                draft_ms.append((time.perf_counter() - t) * 1e3)
                return out
            eng.draft.propose = timed_propose
        undo = capture_k3_inputs(k3_inputs) if gamma else None
        try:
            run_start_gb = reset_peak(torch)
            reset_launches()
            t0 = time.perf_counter()
            reqs, steps = serve_steps(torch, eng, Request, prompts,
                                      SPEC_NEW_TOKENS, k3_inputs)
            wall_s = time.perf_counter() - t0
            launches = read_launches()
        finally:
            if undo is not None:
                undo()
        peak = torch.cuda.max_memory_allocated() / 1e9
        check_outputs(eng.sched.finished, len(prompts), cfg.vocab_size,
                      SPEC_NEW_TOKENS)
        check_drained(eng)
        st = eng.stats
        if packed:
            k3_splits = st.forwards + st.weave_forwards
        else:
            pw = eng.metrics.get("engine/site_weave", site="prefill")
            k3_splits = (eng.metrics.get("engine/site_forwards",
                                         site="prefill").value
                         + (pw.value if pw is not None else 0))
        want = check_launches(eng, launches, norm_kernel=norm_kernel,
                              n_layers=n_layers, k3_splits=k3_splits)
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        runs[gamma] = {
            "outputs": {r.rid: r.output for r in reqs},
            "forwards": st.forwards, "weave_forwards": st.weave_forwards,
            "launches": launches, "expected_launches": want,
            "wall_s": wall_s, "steps": len(steps),
            "mixed_step_ms": [s["ms"] for s in steps if s["prefill"]],
            **decode_summary(steps),
            "allocated_at_run_start_gb": run_start_gb,
            "max_memory_allocated_gb": peak}
        if gamma:
            sp = st.spec
            verify_ms = [s["ms"] for s in steps
                         if s["verify"] and not s["prefill"]]
            runs[gamma].update(
                verify_steps=sp.verify_steps,
                draft_proposed=sp.draft_proposed,
                draft_accepted=sp.draft_accepted,
                acceptance_rate=sp.acceptance_rate,
                tokens_per_step=sp.tokens_per_step,
                verify_step_ms_median=statistics.median(verify_ms),
                verify_step_ms=verify_ms,
                draft_ms_median=statistics.median(draft_ms),
                draft_ms_total=sum(draft_ms))
            if not (sp.verify_steps > 0 and sp.draft_proposed > 0):
                raise AssertionError(f"no verify step or draft: {runs}")
        del eng
        gc.collect()
    if packed and not any(tensors[0].shape[1] == SPEC_GAMMA + 1
                          for tensors, _ in k3_inputs.values()):
        raise AssertionError("K3 never got a verify-only packed step")
    spec, off = runs[SPEC_GAMMA], runs[0]
    prefix = []
    for rid, out in spec.pop("outputs").items():
        ref = off["outputs"][rid]
        n = next((i for i, (a, b) in enumerate(zip(out, ref)) if a != b),
                 len(out))
        prefix.append(n)
    off.pop("outputs")
    emit({"phase": "engine_spec", "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "packed": packed, "paged": True,
          "layers": n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
          "gamma": SPEC_GAMMA, "draft": "ngram n=3",
          "prompt_lens": list(PROMPT_LENS), "new_tokens": SPEC_NEW_TOKENS,
          "param_init_s": init_s, "allocated_at_start_gb": start_gb, **spec,
          "spec_off": off,
          "tokens_matching_spec_off": sum(prefix),
          "matching_prefix_by_request": prefix,
          "tokens_total": SPEC_NEW_TOKENS * len(prompts),
          "ms_per_token_vs_spec_off": (spec["decode_ms_per_token"]
                                       / off["decode_ms_per_token"])})
    del params
    return total, check_main_path_k3(
        torch, k3_inputs, "engine_spec" + ("" if packed else "_two"), tp)


def verify_weave_phase(torch, np, seed: int, trace_dir: Path, *, tp: int,
                       comm_mode: str, n_layers: int = 4) -> dict:
    """One ``verify_step`` of 128 rows x (1 + gamma 3) tokens over a slot
    cache of 1024 cells with 960 positions filled (random bf16 KV): the
    verify site's threshold (128 rows) is met, so the weave splits the
    batch.  Run with the weave on and off: the split taken, the mode's
    kernel once per add+norm slot of each split, logits within
    VERIFY_REL_FRO of the unsplit call's; wall ms and a traced breakdown
    of each.  Returns the launches of the two counted calls."""
    from repro_torch.models import transformer as TRX

    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, _, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode, n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    cache = api.init_cache(VERIFY_ROWS, VERIFY_CACHE, device="cuda")
    for layer in cache:
        layer["k"].normal_(generator=gen)
        layer["v"].normal_(generator=gen)
        layer["pos"][:, :VERIFY_FILLED] = torch.arange(
            VERIFY_FILLED, dtype=torch.int32, device="cuda")
    s_v = SPEC_GAMMA + 1
    tokens = torch.randint(0, cfg.vocab_size, (VERIFY_ROWS, s_v),
                           generator=gen, device="cuda")
    positions = (VERIFY_FILLED + torch.arange(
        s_v, dtype=torch.int32, device="cuda"))[None].repeat(VERIFY_ROWS, 1)
    cache_gb = sum(t.numel() * t.element_size() for layer in cache
                   for t in layer.values()) / 1e9
    out, total = {}, {}
    for weave in (True, False):
        wapi = dataclasses.replace(api, pcfg=dataclasses.replace(
            api.pcfg, tokenweave=weave))
        info = TRX.weave_decision_info(VERIFY_ROWS, s_v, tp=tp,
                                       pcfg=wapi.pcfg, decode=True)
        if info.weave != weave or (info.split is None) == weave:
            raise AssertionError(f"weave={weave}: decision {info}")

        def call():
            return wapi.verify_step(params, tokens, cache, positions)
        with torch.no_grad():
            call()                                   # warm-up
            reset_launches()
            logits, _ = call()
            torch.cuda.synchronize()
            launches = read_launches()
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            name = f"verify_weave_tp{tp}_{'on' if weave else 'off'}"
            brk = device_breakdown(torch, call,
                                   trace_dir / f"{name}_trace.json")
        splits = 2 if weave else 1
        want = {"ar_rmsnorm": 0, "fused_residual_rmsnorm": 0,
                "flash_attention": 0}
        want[norm_kernel] = splits * (1 + 2 * n_layers)
        if launches != want:
            raise AssertionError(f"weave={weave}: launches {launches}, "
                                 f"expected {want}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        out[weave] = logits.float()
        emit({"phase": "verify_weave", "model": cfg.name, "tp": tp,
              "comm_mode": comm_mode, "layers": n_layers, "weave": weave,
              "rows": VERIFY_ROWS, "window": s_v, "cache_len": VERIFY_CACHE,
              "filled": VERIFY_FILLED, "cache_gb": cache_gb,
              "split": info.split, "reason": info.reason,
              "launches": launches, "expected_launches": want,
              "wall_ms": walls, "wall_ms_median": statistics.median(walls),
              "breakdown": brk})
    err = rel_fro(out[True], out[False])
    emit({"phase": "verify_weave_check", "tp": tp,
          "logits_rel_fro_err": err, "tol": VERIFY_REL_FRO})
    if not err <= VERIFY_REL_FRO:
        raise AssertionError(f"tp={tp}: weave-on logits differ by {err}")
    del cache, params, out
    return total


# --------------------------------------------------------------------------
# the sampler on the card at the full vocabulary
# --------------------------------------------------------------------------

SAMPLE_DRAWS, SAMPLE_BATCH, TV_TOL = 20000, 1000, 0.05
SAMPLE_SETTINGS = (dict(temperature=1.0, top_k=0, top_p=1.0),
                   dict(temperature=0.8, top_k=50, top_p=0.9))


def target_probs(np, row, *, temperature, top_k, top_p):
    """The filtered softmax of one logits row in float64 numpy:
    temperature, the k largest, then the smallest prefix reaching p."""
    x = row.astype(np.float64) / temperature
    keep = np.ones(len(x), bool)
    if top_k:
        keep &= x >= np.sort(x)[::-1][top_k - 1]
    p = np.where(keep, np.exp(x - x.max()), 0.0)
    p /= p.sum()
    if top_p < 1.0:
        order = np.argsort(p)[::-1]
        cut = int(np.searchsorted(np.cumsum(p[order]), top_p)) + 1
        q = np.zeros_like(p)
        q[order[:cut]] = p[order[:cut]]
        p = q / q.sum()
    return p


def total_variation(np, ids, p) -> float:
    emp = np.bincount(ids, minlength=len(p)) / len(ids)
    return 0.5 * float(np.abs(emp - p).sum())


def sampler_phase(torch, np, seed: int, *, tp: int):
    """Llama-3.3-70B's vocabulary (128256) on ``tp`` ranks: two fixed
    logits rows (24 hot tokens over a normal tail).  For each setting,
    ``filtered_logits`` keeps on the card the set it keeps on the CPU,
    and 20000 draws of ``sample``, and of the first token that
    ``verify_sample`` commits for a window whose draft is the most likely
    token or one outside the kept set, lie within TV 0.05 of the
    filtered softmax."""
    from repro_torch.configs.llama3_70b import CONFIG
    from repro_torch.runtime import sampler as S
    from repro_torch.runtime import spec as SP

    vocab = CONFIG.vocab_size
    rng = np.random.RandomState(seed + 31)
    rows = rng.randn(2, vocab).astype(np.float32)
    for row in rows:
        row[rng.choice(vocab, 24, replace=False)] += 14 + 2 * rng.rand(24)

    def on_ranks(a, dev):
        """(B, S, V) -> (R, B, S, V/R)."""
        b, s, v = a.shape
        return a.reshape(b, s, tp, v // tp).permute(2, 0, 1, 3).to(dev)

    gen = torch.Generator(device="cuda").manual_seed(seed + 32)
    full = torch.from_numpy(rows)
    for i, kw in enumerate(SAMPLE_SETTINGS):
        kept = {dev: (S.filtered_logits(on_ranks(full[:, None], dev),
                                        vocab_size=vocab, **kw)
                      > -1e29).cpu() for dev in ("cuda", "cpu")}
        if not torch.equal(kept["cuda"], kept["cpu"]):
            raise AssertionError(f"tp={tp} {kw}: kept sets differ between "
                                 f"cuda and cpu")
        p = target_probs(np, rows[0], **kw)
        batch = on_ranks(full[:1, None].expand(SAMPLE_BATCH, 1, vocab),
                         "cuda").contiguous()
        t = time.perf_counter()
        ids = np.concatenate([
            S.sample(batch, vocab_size=vocab, generator=gen, **kw).cpu()
            .numpy() for _ in range(SAMPLE_DRAWS // SAMPLE_BATCH)])
        sample_s = time.perf_counter() - t
        tv = {"sample": total_variation(np, ids, p)}
        window = on_ranks(full[None].expand(SAMPLE_BATCH, 2, vocab),
                          "cuda").contiguous()
        for label, first in (("draft_top", int(np.argmax(p))),
                             ("draft_outside", int(np.argmin(rows[0])))):
            draft = torch.full((SAMPLE_BATCH, 1), first, device="cuda")
            got = []
            for _ in range(SAMPLE_DRAWS // SAMPLE_BATCH):
                n_acc, emit_ = SP.verify_sample(window, draft, gen,
                                                vocab_size=vocab, **kw)
                got.append(torch.where(n_acc >= 1, draft[:, 0],
                                       emit_.long()).cpu().numpy())
            tv[label] = total_variation(np, np.concatenate(got), p)
        emit({"phase": "sampler", "tp": tp, "vocab": vocab, **kw,
              "draws": SAMPLE_DRAWS,
              "kept_tokens": int(kept["cpu"][:, 0].sum()),
              "kept_equal_cpu": True, "tv": tv, "tv_tol": TV_TOL,
              "sample_s": sample_s})
        if not max(tv.values()) < TV_TOL:
            raise AssertionError(f"tp={tp} {kw}: total variation {tv}")
        del batch, window


# K3's side pass over V (vsum_kernel) runs in the same call as its main
# kernel and counts as K3, as do the live-tile table's torch ops (read
# from the wrapper's named range, device_breakdown)
KINDS = (("flash_attention", "flash_fwd"), ("flash_attention", "vsum_kernel"),
         ("fused_rmsnorm", "fused_rmsnorm"), ("ar_rmsnorm", "ar_rmsnorm"))


def kernel_kind(name: str) -> str:
    name = name.lower()
    for kind, key in KINDS:
        if key in name:
            return kind
    if any(s in name for s in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm"
    return "other"


def overlap_ms(events, kind: str) -> float:
    """Device time of the ``kind`` kernels during which some other kernel
    ran (on another stream): intervals (start, end, kind) in ms."""
    others = sorted((s, e) for s, e, k in events if k != kind)
    merged = []
    for s, e in others:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total = 0.0
    for s, e, k in events:
        if k != kind:
            continue
        for ms, me in merged:
            if me <= s:
                continue
            if ms >= e:
                break
            total += min(e, me) - max(s, ms)
    return total


def device_breakdown(torch, fn, trace_path, ranges=None) -> dict:
    """Time one call of ``fn`` on the host's clock, then trace one more
    with torch.profiler into ``trace_path``: device time summed by kind of
    kernel, the longest kernels, the time some kernel ran (the union over
    streams, so kernels that overlap count once), the share of the first
    call's wall time in which none ran, and how much of K1's device time
    overlapped other kernels.  Kernels launched inside K3's live-tile
    range count as K3; that range's host time is given apart, and so are
    the host's time to enqueue the first call (until it returns) and its
    span from the traced call's first launch to its last.  ``ranges``
    (label -> a ``record_function`` name): the device time, kernel count
    and host time of each named range too."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as K3

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall_ms = (time.perf_counter() - t) * 1e3
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())
    events = events.get("traceEvents", events)
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "dur" in e]

    def in_range(name):
        """(correlation ids of the launches inside the named range, the
        range's host ms)."""
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") == name]
        corr = {e.get("args", {}).get("correlation") for e in launches
                if any(s <= e["ts"] <= t for s, t in spans)} - {None}
        return corr, sum(t - s for s, t in spans) / 1e3

    table, table_host_ms = in_range(K3.LIVE_TILES_RANGE)
    extra = {name: in_range(r) for name, r in (ranges or {}).items()}
    extra_ms = {name: 0.0 for name in extra}
    extra_n = {name: 0 for name in extra}
    kinds = {"gemm": 0.0, "flash_attention": 0.0, "fused_rmsnorm": 0.0,
             "ar_rmsnorm": 0.0, "other": 0.0}
    iv, table_ms, table_n, per_name = [], 0.0, 0, {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset") \
                or "dur" not in e:
            continue
        ms = e["dur"] / 1e3
        corr = e.get("args", {}).get("correlation")
        in_table = corr in table
        kind = "flash_attention" if in_table else kernel_kind(e["name"])
        kinds[kind] += ms
        table_ms += ms if in_table else 0.0
        table_n += in_table
        for name, (ids, _) in extra.items():
            if corr in ids:
                extra_ms[name] += ms
                extra_n[name] += 1
        name = e["name"][:100]
        per_name[name] = (per_name.get(name, (0.0, 0))[0] + ms,
                          per_name.get(name, (0.0, 0))[1] + 1)
        if e["cat"] == "kernel":
            iv.append((e["ts"] / 1e3, (e["ts"] + e["dur"]) / 1e3, kind))
    if not iv:
        raise AssertionError("torch.profiler recorded no kernel")
    busy = max(e for _, e, _ in iv) - min(s for s, _, _ in iv) - idle_ms(iv)
    k1 = [e - s for s, e, k in iv if k == "ar_rmsnorm"]
    kernels = sorted(((ms, n, name) for name, (ms, n) in per_name.items()),
                     reverse=True)
    k3_calls = sum(1 for e in events if e.get("cat") == "kernel"
                   and "flash_fwd" in e["name"])
    return {"wall_ms": wall_ms, "host_ms": enqueue_ms,
            "device_busy_ms": busy,
            "kernel_ms_sum": sum(kinds.values()),
            "device_idle_share": 1 - busy / wall_ms,
            "device_ms_by_kind": kinds,
            "traced_wall_ms": traced_wall_ms,
            "host_launch_span_ms": (max(e["ts"] + e["dur"] for e in launches)
                                    - min(e["ts"] for e in launches)) / 1e3,
            "k3_calls": k3_calls, "k3_table_kernels": table_n,
            "k3_table_device_ms": table_ms,
            "k3_table_host_ms": table_host_ms,
            "ranges": {name: {"device_ms": extra_ms[name],
                              "kernels": extra_n[name],
                              "host_ms": extra[name][1]} for name in extra},
            "k1_launches": len(k1), "k1_device_ms": sum(k1),
            "k1_overlapped_ms": overlap_ms(iv, "ar_rmsnorm"),
            "trace": str(trace_path),
            "top_kernels": [{"ms": ms, "count": n, "name": k}
                            for ms, n, k in kernels[:10]]}


def idle_ms(events) -> float:
    """Gaps between kernels over the traced span (any stream)."""
    iv = sorted((s, e) for s, e, _ in events)
    gap, end = 0.0, iv[0][1]
    for s, e in iv[1:]:
        if s > end:
            gap += s - end
        end = max(end, e)
    return gap


# --------------------------------------------------------------------------
# the MoE family at full width: Mixtral-8x22B and OLMoE-1B-7B
# --------------------------------------------------------------------------

MIXTRAL_LAYERS = 4                 # of 56: 19.3 GB of experts in bf16
OLMOE_LAYERS = 16                  # all of them: 12.9 GB of experts
MOE_SYNC_TOKENS = 2048


def moe_phases(**kw) -> list:
    """Mixtral-8x22B (``ffn``) through the two-dispatch engine at tp=1
    ``fused`` and tp=8 ``ring`` and packed over the pool at tp=8 ``ring``;
    OLMoE-1B-7B (``expert``, 8 experts a rank) packed at tp=8 ``ring``.
    The gates are the Llama phases': launch formulas, pools drained, K3
    held at every shape.  Returns each run's (launches, K3 error, peak)."""
    from repro_torch.configs import get_config
    mixtral = dict(config=get_config("mixtral-8x22b"), n_layers=MIXTRAL_LAYERS)
    olmoe = dict(config=get_config("olmoe-1b-7b"), n_layers=OLMOE_LAYERS)
    return [engine_phase(**kw, **mixtral, tp=1, comm_mode="fused",
                         phase="engine_moe"),
            engine_phase(**kw, **mixtral, tp=8, comm_mode="ring",
                         phase="engine_moe"),
            packed_phase(**kw, **mixtral, tp=8, comm_mode="ring",
                         phase="engine_moe_packed"),
            packed_phase(**kw, **olmoe, tp=8, comm_mode="ring",
                         phase="engine_moe_olmoe")]


def moe_sync_phase(torch, seed: int):
    """One ``moe_forward`` at Mixtral-8x22B's widths over 2048 tokens at
    tp=1 and tp=8, under ``torch.cuda.set_sync_debug_mode("error")``: any
    operation that waits for the card raises.  A warm call first (the
    libraries' first-use set-up is not the layer's); the output must be
    finite, and the call is timed between CUDA events."""
    from repro_torch.configs import get_config
    from repro_torch.layers import moe
    cfg = get_config("mixtral-8x22b")
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    for tp in (1, 8):
        gc.collect()
        torch.cuda.empty_cache()
        params = moe.init_moe_params(gen, cfg, tp, device="cuda",
                                     dtype=torch.bfloat16)
        x = torch.randn(1, 1, MOE_SYNC_TOKENS, cfg.d_model, generator=gen,
                        device="cuda", dtype=torch.bfloat16).expand(
                            tp, -1, -1, -1)
        with torch.no_grad():
            moe.moe_forward(params, x, cfg)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.set_sync_debug_mode("error")
            try:
                start.record()
                out, aux = moe.moe_forward(params, x, cfg)
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if out.shape != x.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"moe_sync tp={tp}: output "
                                 f"{tuple(out.shape)} not finite")
        emit({"phase": "moe_sync", "model": cfg.name, "tp": tp,
              "tokens": MOE_SYNC_TOKENS, "sync_debug_mode": "error",
              "raised": False, "ms": start.elapsed_time(end),
              "aux": aux.tolist()})
        del params, x, out


# --------------------------------------------------------------------------
# phase 5: the same small float32 model on the card and on the CPU
# --------------------------------------------------------------------------

def small_api(*, tp: int, comm_mode: str, moe: str = ""):
    """The identity checks' small float32 model: (config, model API);
    ``moe`` ("ffn" or "expert"): its MoE twin, 4 experts top-2 with
    expert d_ff 256 in that partitioning."""
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.models.build import build_model
    cfg = ModelConfig(name="small", family="dense", num_layers=2, d_model=256,
                      num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512,
                      vocab_size=512, dtype="float32")
    if moe:
        cfg = dataclasses.replace(
            cfg, name=f"small-moe-{moe}", family="moe", num_experts=4,
            num_experts_per_tok=2, moe_d_ff=256, moe_partition=moe)
    pcfg = ParallelConfig(comm_mode=comm_mode, attn_impl="pallas",
                          use_pallas_norm=True, split_unit=16,
                          tokenweave_min_tokens=32)
    return cfg, build_model(cfg, pcfg, tp=tp)


def capture_routes(torch, store: list):
    """Make the MoE layer keep, per call, each row's expert choice and
    the gap between its k-th and (k+1)-th router probability (how near a
    tie it was), on the host.  Returns the undo."""
    from repro_torch.layers import moe
    orig = moe._route

    def keep(x, router, cfg):
        topw, topi, aux = orig(x, router, cfg)
        probs = torch.softmax(x.float() @ router, dim=-1)
        top = moe.top_k(probs, cfg.num_experts_per_tok + 1)[0]
        store.append((topi[0].cpu(), (top[0, :, -2] - top[0, :, -1]).cpu()))
        return topw, topi, aux

    moe._route = keep
    return lambda: setattr(moe, "_route", orig)


def route_flips(routes: dict, splits: int) -> list:
    """The rows whose experts differ between cuda and cpu, by layer."""
    flips = []
    for i, ((ti, tm), (ci, cm)) in enumerate(zip(routes["cuda"],
                                                 routes["cpu"])):
        for row in (ti != ci).any(-1).nonzero().flatten().tolist():
            flips.append({"layer": i // splits, "split": i % splits,
                          "row": row, "cuda": ti[row].tolist(),
                          "cpu": ci[row].tolist(),
                          "margin_cuda": float(tm[row]),
                          "margin_cpu": float(cm[row])})
    return flips


def identity_phase(torch, np, seed: int, *, tp: int, comm_mode: str,
                   moe: str = ""):
    """A small float32 model (its MoE twin with ``moe``) served on the
    card and on the CPU: greedy tokens equal over slots and packed over
    the pool, prefill logits within IDENTITY_LOGIT_TOL; for the dense
    model also with speculation.  A MoE twin's prefill check also holds
    each layer's expert choices equal on both devices, and a mismatch
    names the rows that flipped and how near a tie they were."""
    from repro_torch.models.build import build_model
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api = small_api(tp=tp, comm_mode=comm_mode, moe=moe)
    pcfg = api.pcfg
    scfg = SchedulerConfig(max_batch=16, chunk_tokens=64, max_len=128,
                           prefill_bucket=16)
    p_cpu = api.init(seed, device="cpu")

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cuda(v) for v in tree]
        return tree.cuda()
    p_gpu = to_cuda(p_cpu)

    rng = np.random.RandomState(seed + 1)
    prompts = [rng.randint(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.randint(5, 100, size=16)]

    # prefill logits on both devices (and, for a MoE twin, every layer's
    # expert choices)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 48)))
    pos = torch.arange(48, dtype=torch.int32)[None].repeat(2, 1)
    pos[1, 40:] = -1
    last = torch.tensor([47, 39])
    logits, routes = {}, {}
    with torch.no_grad():
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            rows = api.init_cache(2, scfg.max_len, device=dev)
            routes[dev] = []
            undo = capture_routes(torch, routes[dev])
            try:
                logits[dev], _ = api.prefill(params, tokens.to(dev), rows,
                                             pos.to(dev),
                                             last_idx=last.to(dev))
            finally:
                undo()
    err = max_err(logits["cuda"].cpu(), logits["cpu"])
    splits = 1 + api.mod.weave_decision_info(2, 48, tp=tp, pcfg=pcfg).weave
    flips = route_flips(routes, splits) if moe else []
    if flips or not err <= IDENTITY_LOGIT_TOL:
        raise AssertionError(f"tp={tp} {cfg.name}: prefill logits differ "
                             f"by {err}; expert choices flipped: {flips}")

    # greedy speculative decoding (gamma 3) with the n-gram draft and
    # with a one-layer random draft model of the same vocabulary
    from repro_torch.runtime import spec as SP
    if not moe:
        dapi = build_model(dataclasses.replace(cfg, num_layers=1), pcfg,
                           tp=tp)
        d_cpu = dapi.init(seed + 7, device="cpu")
        d_params = {"cpu": d_cpu, "cuda": to_cuda(d_cpu)}

    def spec_identity(engine, base, serve, want):
        """The spec engines over ``base``'s scheduler give the spec-off
        tokens ``want`` on cuda and on cpu, verifying windows on both."""
        for kind in ("ngram", "model"):
            got, launches, spec = {}, {}, {}
            for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
                draft = None if kind == "ngram" else SP.ModelDraft(
                    dapi, d_params[dev], SPEC_GAMMA, max_batch=base.max_batch)
                reset_launches()
                eng = Engine(api, params, dataclasses.replace(
                    base, spec_gamma=SPEC_GAMMA), draft=draft, device=dev)
                got[dev] = serve(eng)
                torch.cuda.synchronize()
                launches[dev] = read_launches()
                spec[dev] = [eng.stats.spec.verify_steps,
                             eng.stats.spec.draft_accepted]
            if got["cuda"] != want or got["cpu"] != want:
                raise AssertionError(f"tp={tp} {engine} {kind} draft: spec "
                                     f"tokens {got} != spec off {want}")
            if (0 in (launches["cuda"][norm_kernel],
                      launches["cuda"]["flash_attention"],
                      spec["cuda"][0], spec["cpu"][0])
                    or any(launches["cpu"].values())):
                raise AssertionError(f"tp={tp} {engine} {kind}: launches "
                                     f"{launches}, verify/accepted {spec}")
            emit({"phase": "identity_spec", "model": cfg.name, "tp": tp,
                  "comm_mode": comm_mode, "engine": engine, "draft": kind,
                  "gamma": SPEC_GAMMA, "requests": len(want),
                  "tokens_identical": True,
                  "verify_steps_accepted": spec,
                  "cuda_launches": launches["cuda"]})

    def serve_slots(eng):
        for i, p in enumerate(prompts):
            eng.add_request(Request(rid=i, prompt=p, max_new_tokens=6))
        return {r.rid: r.output for r in eng.run()}

    outs, launches, weave = {}, {}, {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        reset_launches()
        eng = Engine(api, params, scfg, device=dev)
        outs[dev] = serve_slots(eng)
        torch.cuda.synchronize()
        launches[dev] = read_launches()
        weave[dev] = eng.stats.weave_forwards
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(f"tp={tp} {cfg.name}: cuda tokens "
                             f"{outs['cuda']} != cpu {outs['cpu']}")
    if (0 in (launches["cuda"][norm_kernel],
              launches["cuda"]["flash_attention"])
            or any(launches["cpu"].values()) or not weave["cuda"]):
        raise AssertionError(f"tp={tp}: launches {launches}, weave "
                             f"forwards {weave}")
    row = {"phase": "identity", "model": cfg.name, "tp": tp,
           "comm_mode": comm_mode, "requests": len(prompts),
           "tokens_identical": True, "weave_forwards": weave["cuda"],
           "cuda_launches": launches["cuda"],
           "prefill_logits_max_abs_err": err, "tol": IDENTITY_LOGIT_TOL}
    if moe:
        row["min_route_margin"] = min(
            float(m.min()) for _, m in routes["cuda"])
    emit(row)
    if not moe:
        spec_identity("slots", scfg, serve_slots, outs["cuda"])

    # packed hybrid batching over the paged pool, with one more request
    # sharing the longest prompt's first 32 tokens (2 blocks of 16),
    # added once request 0's prefill is done
    pscfg = dataclasses.replace(scfg, paged=True, packed=True)
    src = max(prompts, key=len)
    order = [src] + [p for p in prompts if p is not src]
    sharer = src[:32] + rng.randint(0, cfg.vocab_size, 8).tolist()
    hits = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        reset_launches()
        eng = Engine(api, params, pscfg, device=dev)
        done, late = serve_with_sharer(eng, Request, order, 6, sharer)
        outs[dev] = {r.rid: r.output for r in done}
        torch.cuda.synchronize()
        launches[dev] = read_launches()
        weave[dev] = eng.stats.weave_forwards
        hits[dev] = late.prompt_hit_tokens
    if outs["cuda"] != outs["cpu"] or len(outs["cuda"]) != len(order) + 1:
        raise AssertionError(f"tp={tp} packed paged: cuda tokens "
                             f"{outs['cuda']} != cpu {outs['cpu']}")
    if (0 in (launches["cuda"][norm_kernel],
              launches["cuda"]["flash_attention"])
            or any(launches["cpu"].values()) or not weave["cuda"]
            or hits["cuda"] != hits["cpu"] or hits["cuda"] != 32):
        raise AssertionError(f"tp={tp} packed paged: launches {launches}, "
                             f"weave forwards {weave}, prefix hits {hits}")
    emit({"phase": "identity_packed_paged", "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "requests": len(order) + 1,
          "tokens_identical": True, "weave_forwards": weave["cuda"],
          "prefix_hit_tokens_sharer": hits["cuda"],
          "cuda_launches": launches["cuda"]})
    if not moe:
        spec_identity("packed_paged", pscfg, lambda eng: {
            r.rid: r.output for r in serve_with_sharer(
                eng, Request, order, 6, sharer)[0]}, outs["cuda"])


# --------------------------------------------------------------------------
# online serving with tracing, profiling and calibration at full width
# --------------------------------------------------------------------------

ONLINE_N, ONLINE_NEW = 8, 32       # (a) and (b): 8 requests, 32 new tokens
ONLINE_TP8_N, ONLINE_TP8_NEW = 4, 16   # (c)
ONLINE_PROMPTS = (300, 1800)       # prompt lengths, drawn from the seed
ONLINE_GAP_STEPS = 6               # mean inter-arrival: a prefill + 6
#                                    decode steps on the calibrated clock
ONLINE_CANCEL = (1, 4)             # rid 1 disconnects after 4 tokens
ONLINE_EXPIRE = (2, 4)             # rid 2's deadline: 4 decode steps
ONLINE_MIN_OVERLAP = 3             # arrivals while others decode
FENCE_CALLS = 1000                 # wrapped no-ops timing the fence


def online_prompts(np, seed: int, vocab: int, n: int):
    rng = np.random.RandomState(seed + 16)
    lens = rng.randint(ONLINE_PROMPTS[0], ONLINE_PROMPTS[1] + 1, n)
    return [rng.randint(0, vocab, int(m)).tolist() for m in lens]


class EventTimedSteps:
    """The model API with each packed step timed between two CUDA events
    on the current stream: inside the engine's dispatch, so inside the
    profiler's fences, the same call the profiler measures."""

    def __init__(self, torch, api):
        self._torch = torch
        self._api = api
        self.events = []

    def __getattr__(self, name):
        return getattr(self._api, name)

    def packed_step(self, *args, **kw):
        start = self._torch.cuda.Event(enable_timing=True)
        end = self._torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._api.packed_step(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out


def serve_counted(torch, eng, Request, prompts, new_tokens: int, *,
                  norm_kernel: str, n_layers: int, total: dict):
    """Serve ``prompts`` offline with the launch counts set to 0 just
    before and read just after; the counts must equal the packed
    formulas, and are added to ``total``.  Returns ({rid: tokens},
    wall seconds)."""
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    st = eng.stats
    check_launches(eng, launches, norm_kernel=norm_kernel,
                   n_layers=n_layers,
                   k3_splits=st.forwards + st.weave_forwards)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    check_outputs(reqs, len(prompts), eng.api.cfg.vocab_size, new_tokens)
    check_drained(eng)
    return {r.rid: list(r.output) for r in reqs}, wall_s


def calibration_row(rep) -> dict:
    return {"mfu_cap": rep.mfu_cap, "ici": rep.ici,
            "overhead_s": rep.overhead, "step_base_s": rep.step_base,
            "step_per_token_s": rep.step_per_token,
            "n_samples": rep.n_samples, "buckets": len(rep.buckets),
            "worst_rel_err": rep.worst_rel_err,
            "worst_bucket": rep.worst_bucket,
            "per_mode_rel_err": rep.per_mode_rel_err}


def measured_ms(prof) -> dict:
    return {kind: {"n": row["n"], "mean_ms": row["mean_s"] * 1e3}
            for kind, row in prof.summary().items()}


def serve_online(torch, eng, prompts, new_tokens: int, cost, seed: int, *,
                 trace_path: Path, norm_kernel: str, n_layers: int,
                 total: dict):
    """Serve ``prompts`` through an ``OnlineServer`` over ``eng`` (which
    carries a TraceRecorder) on the clock ``cost``, with Poisson arrivals,
    ONLINE_CANCEL's rid disconnecting during its decode and ONLINE_EXPIRE's
    rid given a deadline that expires.  Gates: launches equal the packed
    formulas (added to ``total``), the pool drains, the cancel and the
    expiry land, every other request finishes with its budget, at least
    ONLINE_MIN_OVERLAP requests arrive while others decode, and the trace
    validates with one terminal event per request.  Returns (the row to
    print, the requests)."""
    from repro_torch.obs import (TERMINAL_PHASES, export_chrome_trace,
                                 validate_chrome_trace)
    from repro_torch.runtime.requests import Request, poisson_arrivals
    from repro_torch.runtime.server import OnlineServer, ServerConfig

    decode_s = cost.of(len(prompts))
    # a mean gap of one mean prompt's prefill and ONLINE_GAP_STEPS decode
    # steps: each request lives about new_tokens steps, so several overlap
    mean_prompt = sum(map(len, prompts)) / len(prompts)
    rate = 1.0 / (cost.of(mean_prompt) + ONLINE_GAP_STEPS * decode_s)
    srv = OnlineServer(eng, ServerConfig(step_cost=cost,
                                         expire_on_deadline=True))
    reqs = poisson_arrivals(
        [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
         for i, p in enumerate(prompts)], rate=rate, seed=seed)
    cancel_rid, cancel_after = ONLINE_CANCEL
    expire_rid, expire_steps = ONLINE_EXPIRE
    streamed, disconnect = [], []

    def on_token(req, tok, at):
        streamed.append((req.rid, tok, at))
        if req.rid == cancel_rid and len(req.output) >= cancel_after \
                and not disconnect:
            disconnect.append(at)
            srv.cancel(cancel_rid)
    for r in reqs:
        if r.rid == expire_rid:
            r.deadline = r.arrival_time + expire_steps * decode_s
        srv.submit(r, on_token=on_token)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    st = eng.stats
    check_launches(eng, launches, norm_kernel=norm_kernel,
                   n_layers=n_layers,
                   k3_splits=st.forwards + st.weave_forwards)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    check_drained(eng)
    by_rid = {r.rid: r for r in reqs}
    if by_rid[cancel_rid].finish_reason != "cancelled" or \
            by_rid[expire_rid].finish_reason != "expired":
        raise AssertionError(
            f"cancel/expiry: {by_rid[cancel_rid].finish_reason}, "
            f"{by_rid[expire_rid].finish_reason}")
    for r in reqs:
        if r.rid not in (cancel_rid, expire_rid) and (
                r.finish_reason != "stop" or len(r.output) != new_tokens):
            raise AssertionError(f"rid {r.rid}: {r.finish_reason}, "
                                 f"{len(r.output)} tokens")
    overlap = [r.rid for r in reqs if any(
        o is not r and o.first_token_time is not None
        and o.first_token_time <= r.arrival_time
        < (o.finish_time if o.finish_time is not None else float("inf"))
        for o in reqs)]
    if len(overlap) < ONLINE_MIN_OVERLAP:
        raise AssertionError(f"only {overlap} arrived while others "
                             f"decoded")
    doc = export_chrome_trace(eng.obs, path=str(trace_path))
    problems = validate_chrome_trace(doc)
    phases: dict = {}
    for ev in eng.obs.events:
        if ev["kind"] == "request":
            phases.setdefault(ev["rid"], []).append(ev["phase"])
    admitted = [rid for rid, ph in phases.items() if "admit" in ph]
    terminals = {rid: sum(p in TERMINAL_PHASES for p in ph)
                 for rid, ph in phases.items()}
    # every request reached one terminal state (the expiring one may
    # expire before its admission); the validator holds the admitted ones
    # to it too
    if problems or len(phases) != len(prompts) or not admitted or any(
            n != 1 for n in terminals.values()):
        raise AssertionError(f"online trace: {problems[:5]}, terminals "
                             f"{terminals}")
    lat = st.latency
    if (st.cancelled, st.expired) != (1, 1) or not lat.goodput < 1.0:
        raise AssertionError(f"cancelled {st.cancelled}, expired "
                             f"{st.expired}, goodput {lat.goodput}")
    return {"rate_per_s": rate, "decode_step_s": decode_s,
            "step_cost": {"base_s": cost.base, "per_token_s": cost.per_token},
            "arrivals_s": [r.arrival_time for r in reqs],
            "arrived_while_others_decode": overlap,
            "latency": lat.summary(), "goodput": lat.goodput,
            "cancelled": st.cancelled, "expired": st.expired,
            "completed": st.completed, "steps": st.steps,
            "forwards": st.forwards, "weave_forwards": st.weave_forwards,
            "streamed_tokens": len(streamed), "disconnect_s": disconnect,
            "virtual_s": srv.clock, "wall_s": wall_s, "launches": launches,
            "trace": str(trace_path), "trace_events": len(doc["traceEvents"]),
            "admitted": len(admitted), "terminal_events": terminals}, reqs


def online_identity(torch, np, seed: int, total: dict, trace_path: Path):
    """Online tokens against offline ones, gated, on the identity phase's
    small float32 model (TF32 off) on the card: the same traffic as the
    llama-width run (8 requests, 32 new tokens, Poisson arrivals, a
    cancel, an expiry) on a unit clock; every request that finishes gives
    its offline tokens.  At llama width in bf16 the online run's batches
    give the GEMMs other shapes than the offline run's, so its tokens are
    reported, not gated (as spec against spec off)."""
    from repro_torch.obs import TraceRecorder
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig
    from repro_torch.runtime.server import StepCost

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, api = small_api(tp=1, comm_mode="fused")
        params = api.init(seed, device="cuda")
        rng = np.random.RandomState(seed + 17)
        prompts = [rng.randint(0, cfg.vocab_size, int(n)).tolist()
                   for n in rng.randint(5, 100, size=ONLINE_N)]
        scfg = SchedulerConfig(max_batch=ONLINE_N, chunk_tokens=64,
                               max_len=160, prefill_bucket=16, paged=True,
                               packed=True)
        kw = dict(norm_kernel="fused_residual_rmsnorm",
                  n_layers=cfg.num_layers, total=total)
        offline, _ = serve_counted(torch, Engine(api, params, scfg),
                                   Request, prompts, ONLINE_NEW, **kw)
        eng = Engine(api, params, scfg, obs=TraceRecorder())
        row, reqs = serve_online(
            torch, eng, prompts, ONLINE_NEW, StepCost(1.0, 0.02), seed,
            trace_path=trace_path, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    differ = {r.rid: r.output for r in reqs
              if r.finish_reason == "stop" and r.output != offline[r.rid]}
    emit({"phase": "online_identity", "model": cfg.name, "tp": 1,
          "dtype": cfg.dtype, "new_tokens": ONLINE_NEW,
          "prompt_lens": [len(p) for p in prompts],
          "tokens_equal_offline": not differ,
          **{k: row[k] for k in ("arrived_while_others_decode", "latency",
                                 "cancelled", "expired", "steps",
                                 "forwards", "weave_forwards",
                                 "launches")}})
    if differ:
        raise AssertionError(f"online tokens differ from offline: {differ}")


def online_phase(torch, np, seed: int, trace_dir: Path,
                 n_layers: int = 4) -> dict:
    """The port's serving front end and observability on the card.

    (a) tp=1 ``fused``: 8 requests (prompts of 300-1800 tokens, 32 new,
        greedy) through the packed paged engine with a WallClockProfiler
        and a TraceRecorder, then plain, profiled, profiled, plain
        (tokens, steps and forwards equal; the profiler's cost per step
        from the turns; the same profiler, so every shape is past its
        warm-up);
        ``fit_calibration`` on the profiler's steady samples; its JSON
        and the Chrome trace are written to ``trace_dir/online/``; the
        trace validates and its weave counts equal EngineStats'.
    (b) tp=1: the same requests through ``OnlineServer`` on the clock
        ``StepCost.from_calibration`` gives, with Poisson arrivals at a
        rate of one per ONLINE_GAP_STEPS decode steps, rid 1 cancelled
        during its decode and rid 2 past a deadline that expires; the
        others finish with their offline tokens, the pool drains, the
        trace has one terminal event per admitted request.  At llama
        width in bf16 the online tokens are reported beside the offline
        ones; ``online_identity`` gates them on a small float32 model.
    (c) tp=8 ``ring`` (K1 on the weave's comm stream): 4 requests, 16
        new tokens, profiled, plain, and profiled again with the same
        profiler (tokens equal); a fit at tp=8; each woven prefill's
        measured ms is not below its model call's time between CUDA
        events on the current stream, taken by chip_smoke inside the
        same dispatch (the fence covers every stream).

    Returns (the launches of the counted runs, summed; K3's max error
    on the inputs the online run (b) gave it, ``main_path_k3`` lines)."""
    from repro_torch.analysis.calibration import fit_calibration
    from repro_torch.obs import (TraceRecorder, WallClockProfiler,
                                 export_chrome_trace, validate_chrome_trace,
                                 weave_counts_from_trace)
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig
    from repro_torch.runtime.server import StepCost

    out_dir = trace_dir / "online"
    out_dir.mkdir(parents=True, exist_ok=True)
    total: dict = {}
    scfg = SchedulerConfig(paged=True, packed=True)

    # (a) calibrate at tp=1
    cfg, api, params, _, init_s, _ = full_width_model(
        torch, np, seed, tp=1, comm_mode="fused", n_layers=n_layers)
    prompts = online_prompts(np, seed, cfg.vocab_size, ONLINE_N)
    kw = dict(norm_kernel="fused_residual_rmsnorm", n_layers=n_layers,
              total=total)
    rec, prof = TraceRecorder(), WallClockProfiler()
    eng = Engine(api, params, scfg, obs=rec, profiler=prof)
    offline, wall_prof = serve_counted(torch, eng, Request, prompts,
                                       ONLINE_NEW, **kw)
    st = eng.stats
    # plain and profiled in turns (the same profiler: every shape is past
    # its warm-up now, so the fit sees each kind of step, the first
    # prefill's included); the profiler's cost is the difference
    walls = {"plain": [], "profiled": []}
    for name in ("plain", "profiled", "profiled", "plain"):
        other = Engine(api, params, scfg,
                       profiler=prof if name == "profiled" else None)
        toks, wall = serve_counted(torch, other, Request, prompts,
                                   ONLINE_NEW, **kw)
        walls[name].append(wall)
        if toks != offline or (other.stats.steps, other.stats.forwards) \
                != (st.steps, st.forwards):
            raise AssertionError(f"a {name} run differs from the profiled "
                                 f"and traced one")
    del other
    # the fence's own cost on an idle card: two synchronizes and a timer
    fence = WallClockProfiler().attach(device="cuda").wrap(lambda: None)
    t0 = time.perf_counter()
    for _ in range(FENCE_CALLS):
        fence()
    fence_us = (time.perf_counter() - t0) * 1e6 / FENCE_CALLS
    report = fit_calibration(cfg, prof.steady_samples(), tp=1,
                             tile=api.pcfg.split_unit_for(1),
                             model=cfg.name)
    report.save(str(out_dir / "calibration_tp1.json"))
    doc = export_chrome_trace(rec, path=str(out_dir / "offline_tp1.json"))
    problems = validate_chrome_trace(doc)
    weave = weave_counts_from_trace(rec)
    if problems or weave != (st.weave_forwards, st.forwards):
        raise AssertionError(f"offline trace: {problems[:5]}, weave "
                             f"counts {weave} vs {st.weave_forwards}, "
                             f"{st.forwards}")
    emit({"phase": "online_calibrate", "model": cfg.name, "tp": 1,
          "comm_mode": "fused", "layers": n_layers,
          "prompt_lens": [len(p) for p in prompts],
          "new_tokens": ONLINE_NEW, "steps": st.steps,
          "forwards": st.forwards, "weave_forwards": st.weave_forwards,
          "samples": len(prof.samples),
          "steady_samples": len(prof.steady_samples()),
          "measured_ms": measured_ms(prof),
          "wall_s": {"profiled_traced": wall_prof, **walls},
          "profiler_ms_per_step": (sum(walls["profiled"])
                                   - sum(walls["plain"])) / 2 * 1e3
          / st.steps, "fence_us_idle_card": fence_us,
          "calibration": calibration_row(report),
          "calibration_json": str(out_dir / "calibration_tp1.json"),
          "trace": str(out_dir / "offline_tp1.json"),
          "trace_events": len(doc["traceEvents"]),
          "trace_problems": len(problems),
          "trace_weave_forwards": list(weave), "param_init_s": init_s})
    del eng

    # (b) online at tp=1 on the calibrated clock; the same traffic on a
    # small float32 model holds the online tokens to the offline ones
    cost = StepCost.from_calibration(report)
    eng = Engine(api, params, scfg, obs=TraceRecorder())
    # K3's inputs at each shape this run gives it (copied on the card,
    # moved to the host after the run), held against the plain version
    k3_inputs: dict = {}
    undo = capture_k3_inputs(k3_inputs)
    try:
        row, reqs = serve_online(torch, eng, prompts, ONLINE_NEW, cost,
                                 seed, trace_path=out_dir / "online_tp1.json",
                                 **kw)
    finally:
        undo()
    offload(k3_inputs)
    matched = {r.rid: sum(a == b for a, b in zip(r.output, offline[r.rid]))
               for r in reqs if r.finish_reason == "stop"}
    emit({"phase": "online", "model": cfg.name, "tp": 1,
          "comm_mode": "fused", "layers": n_layers, **row,
          "tokens_matched_offline": matched, "new_tokens": ONLINE_NEW})
    del eng, params
    k3_err = check_main_path_k3(torch, k3_inputs, "online", 1)
    online_identity(torch, np, seed, total,
                    trace_path=out_dir / "online_identity.json")

    # (c) tp=8 ring, profiled against plain
    cfg8, api8, params8, _, _, _ = full_width_model(
        torch, np, seed, tp=8, comm_mode="ring", n_layers=n_layers)
    kw8 = dict(kw, norm_kernel="ar_rmsnorm")
    prompts8 = prompts[:ONLINE_TP8_N]
    prof8 = WallClockProfiler()
    runs = {}
    for name, prof_ in (("profiled", prof8), ("plain", None),
                        ("profiled_again", prof8)):
        eng8 = Engine(api8, params8, scfg, profiler=prof_)
        first = len(prof8.samples)
        timed_api = eng8.api = EventTimedSteps(torch, api8)
        toks, wall = serve_counted(torch, eng8, Request, prompts8,
                                   ONLINE_TP8_NEW, **kw8)
        runs[name] = (toks, wall, eng8.stats.steps)
    if len({repr((t, n)) for t, _, n in runs.values()}) != 1:
        raise AssertionError("tp=8 profiled runs differ from the plain one")
    report8 = fit_calibration(cfg8, prof8.steady_samples(), tp=8,
                              tile=api8.pcfg.split_unit_for(8),
                              model=cfg8.name)
    report8.save(str(out_dir / "calibration_tp8.json"))
    # the woven prefill-bearing forwards of the last run (past their
    # warm-up): each one's fenced wall against its model call's CUDA-event
    # time, taken in the same dispatch
    torch.cuda.synchronize()
    woven = [(i, smp.wall_s * 1e3,
              timed_api.events[i][0].elapsed_time(timed_api.events[i][1]))
             for i, smp in enumerate(prof8.samples[first:])
             if smp.weave and smp.tokens_real > ONLINE_TP8_N]
    if not woven:
        raise AssertionError("no woven prefill at tp=8")
    emit({"phase": "online_tp8", "model": cfg8.name, "tp": 8,
          "comm_mode": "ring", "layers": n_layers,
          "requests": ONLINE_TP8_N, "new_tokens": ONLINE_TP8_NEW,
          "steps": eng8.stats.steps, "forwards": eng8.stats.forwards,
          "weave_forwards": eng8.stats.weave_forwards,
          "measured_ms": measured_ms(prof8),
          "wall_s": {name: wall for name, (_, wall, _) in runs.items()},
          "calibration": calibration_row(report8),
          "calibration_json": str(out_dir / "calibration_tp8.json"),
          "fence_check": [
              {"forward": i, "tokens": prof8.samples[first + i].tokens_static,
               "split": prof8.samples[first + i].split,
               "measured_ms": meas, "event_ms": ev}
              for i, meas, ev in woven]})
    for i, meas, ev in woven:
        if not meas >= ev:
            raise AssertionError(f"forward {i}: measured {meas} ms < "
                                 f"CUDA-event {ev} ms: the fence missed work")
    del eng8, timed_api, params8
    torch.cuda.empty_cache()
    emit({"phase": "online_launches", "launches": total})
    return total, k3_err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", type=Path,
                    default=ROOT / "build" / "traces",
                    help="where the traced model calls' Chrome traces go")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    probe = start_copy_probe_build()
    info = build.build()
    emit({"phase": "build", "seconds": info["seconds"],
          "built": info["built"],
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in info["ptxas"].items()}})
    for name in build.SOURCES:
        build.load(name)

    rows = kernel_phase(torch, args.seed, load_copy_probe(probe))
    # the main paths: launches are counted from 0 over each engine run
    kw = dict(torch=torch, np=np, seed=args.seed, trace_dir=args.trace_dir)
    online = online_phase(**kw)
    two = {1: engine_phase(**kw, tp=1, comm_mode="fused"),
           8: engine_phase(**kw, tp=8, comm_mode="ring")}
    packed = {1: packed_phase(**kw, tp=1, comm_mode="fused"),
              8: packed_phase(**kw, tp=8, comm_mode="ring")}
    paths = [online, *two.values(), *packed.values(),
             engine_phase(**kw, tp=1, comm_mode="fused", paged=True)]
    # no per-token KV view on the card: each packed run's peak stays
    # within PACKED_PEAK_SLACK_GB of the two-dispatch run's at its tp
    for tp in (1, 8):
        excess = packed[tp][2] - two[tp][2]
        emit({"phase": "peak_memory", "tp": tp,
              "two_dispatch_gb": two[tp][2], "packed_gb": packed[tp][2],
              "excess_gb": excess, "limit_gb": PACKED_PEAK_SLACK_GB})
        if not excess <= PACKED_PEAK_SLACK_GB:
            raise AssertionError(f"tp={tp}: packed peak {packed[tp][2]} GB "
                                 f"exceeds two-dispatch {two[tp][2]} GB by "
                                 f"more than {PACKED_PEAK_SLACK_GB} GB")
    # speculative decoding: packed at tp=1 and tp=8, two-dispatch paged
    kw.pop("trace_dir")
    paths += [spec_phase(**kw, tp=1, comm_mode="fused"),
              spec_phase(**kw, tp=8, comm_mode="ring"),
              spec_phase(**kw, tp=1, comm_mode="fused", packed=False)]
    for tp, mode in ((1, "fused"), (8, "ring")):
        paths.append((verify_weave_phase(**kw, trace_dir=args.trace_dir,
                                         tp=tp, comm_mode=mode), 0.0))
    # the MoE family, and the MoE layer free of host syncs
    paths += moe_phases(**kw, trace_dir=args.trace_dir)
    moe_sync_phase(torch, args.seed)
    launches = {name: sum(p[0][name] for p in paths)
                for name in paths[0][0]}
    # the K3 error over every shape the main paths gave it, too
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], *(p[1] for p in paths))
    for tp in (1, 8):
        sampler_phase(torch, np, args.seed, tp=tp)
    for moe in ("", "ffn", "expert"):
        identity_phase(torch, np, args.seed, tp=1, comm_mode="fused",
                       moe=moe)
        identity_phase(torch, np, args.seed, tp=2, comm_mode="ring",
                       moe=moe)

    sources = {"ar_rmsnorm": (
        "src/repro_torch/csrc/ar_rmsnorm.cu",
        "src/repro/kernels/ring_ar_rmsnorm.py:43"),
        "fused_residual_rmsnorm": (
        "src/repro_torch/csrc/fused_rmsnorm.cu",
        "src/repro/kernels/fused_rmsnorm.py:27"),
        "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:29")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name]["library_ms"]}
        for name, (src, rep) in sources.items()]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
