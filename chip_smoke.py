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
3. engine   serve 4 greedy requests through the two-dispatch Engine with
            Llama-3.3-70B's widths cut to 4 layers (bf16, random weights
            from the seed) at tp=1, and show from the launch counters that
            the main path ran through the kernels; then trace one prefill
            and one decode step of the model with torch.profiler and split
            their device time by kind of kernel; then hold K3 against its
            plain version on the inputs the run gave it, at each shape
            (``main_path_k3``);
4. engine_tp the same requests at tp=8 (the eight ranks on one card's rank
            axis) in comm mode "ring": K1 launches equal splits·(1+2L) per
            forward, so no forward fell back; one traced prefill call
            gives K1's device time and the part of it that overlapped
            other kernels (the weave's comm stream), and K3 is held on
            its inputs again; every traced call's Chrome trace is written
            to --trace-dir (build/traces/);
5. identity a small float32 model served on the card (kernels) and on the
            CPU (plain versions) must give identical greedy tokens, at
            tp=1 and at tp=2 in ring mode with the weave (and its streams)
            firing.

Then a ``kernels`` summary line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}`` — printed only when every
phase passed.  Without a CUDA device, or without the repository's src/
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
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
    for t in (8, 1000, 2048):
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
                     + [(8, 1000, 8190)]):
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
    wrapper, which counts the launches.  Returns the undo."""
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


def engine_phase(torch, np, seed: int, trace_dir: Path, *, tp: int,
                 comm_mode: str, n_layers: int = 4):
    """Serve the 4 requests at ``tp`` ranks on the card's rank axis; the
    add+norm slots run K2 (``fused``) or K1 (``ring``)."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.llama3_70b import CONFIG
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.models.build import build_model
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    phase = "engine" if tp == 1 else "engine_tp"
    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    prompt_lens, new_tokens = (1800, 1200, 700, 300), 16
    cfg = dataclasses.replace(CONFIG, num_layers=n_layers)
    pcfg = ParallelConfig(comm_mode=comm_mode, attn_impl="pallas",
                          use_pallas_norm=True)
    api = build_model(cfg, pcfg, tp=tp)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in prompt_lens]

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

    eng = Engine(api, params, SchedulerConfig())
    times = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t) * 1e3)
        return run

    eng._run_prefill = timed("prefill", eng._run_prefill)
    eng._run_decode = timed("decode", eng._run_decode)
    for i, p in enumerate(prompts):
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=new_tokens))

    k3_inputs = {}
    undo = capture_k3_inputs(k3_inputs)
    try:
        reset_launches()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        undo()

    if sorted(r.rid for r in done) != list(range(len(prompts))):
        raise AssertionError(f"finished {[r.rid for r in done]}")
    for r in done:
        if len(r.output) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"rid {r.rid} output {r.output}")
    out0 = next(r for r in done if r.rid == 0).output[0]
    if out0 != first_tok:
        raise AssertionError(f"engine's first token {out0} != direct "
                             f"prefill argmax {first_tok}")
    st = eng.stats
    splits = st.forwards + st.weave_forwards
    pf = eng.metrics.get("engine/site_forwards", site="prefill").value
    pw_inst = eng.metrics.get("engine/site_weave", site="prefill")
    pf_splits = pf + (pw_inst.value if pw_inst is not None else 0)
    # every forward's add+norm slots ran the mode's kernel, so none fell
    # back to vanilla (which launches neither K1 nor K2)
    want = {"ar_rmsnorm": 0, "fused_residual_rmsnorm": 0,
            "flash_attention": pf_splits * n_layers}
    want[norm_kernel] = splits * (1 + 2 * n_layers)
    if launches != want or 0 in (launches[norm_kernel],
                                 launches["flash_attention"]):
        raise AssertionError(f"launches {launches}, expected {want}")
    emit({"phase": phase, "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "layers": n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype,
          "prompt_lens": list(prompt_lens), "new_tokens": new_tokens,
          "forwards": st.forwards, "weave_forwards": st.weave_forwards,
          "prefill_forwards": pf, "prefill_splits": pf_splits,
          "launches": launches, "expected_launches": want,
          "param_init_s": init_s, "wall_s": wall_s,
          "prefill_ms": times["prefill"], "decode_ms": times["decode"],
          "prefill_ms_median": statistics.median(times["prefill"]),
          "decode_ms_median": statistics.median(times["decode"]),
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 1e9})

    # where a step's time goes: request 0's whole prefill chunk, and one
    # decode step over the 8 slots (4 active), warm after the run above
    last = torch.tensor([1799], device="cuda")
    dtok = torch.zeros(eng.scfg.max_batch, 1, dtype=torch.long, device="cuda")
    dpos = torch.full((eng.scfg.max_batch, 1), -1, dtype=torch.int32,
                      device="cuda")
    dpos[:len(prompt_lens), 0] = torch.tensor(
        [n + new_tokens - 1 for n in prompt_lens], device="cuda")
    with torch.no_grad():
        for step, fn in (
                ("prefill", lambda: api.prefill(params, tokens, cache_rows,
                                                pos, last_idx=last)),
                ("decode", lambda: api.decode_step(params, dtok, eng.cache,
                                                   dpos))):
            trace = trace_dir / f"{phase}_{step}_trace.json"
            row = device_breakdown(torch, fn, trace)
            if tp > 1 and step == "prefill" and not row["k1_launches"]:
                raise AssertionError("no K1 kernel in the traced prefill")
            emit({"phase": "breakdown", "engine": phase, "tp": tp,
                  "step": step, "tokens":
                  chunk if step == "prefill" else eng.scfg.max_batch,
                  **row})
    del eng, params, cache_rows
    torch.cuda.empty_cache()

    # K3 at every shape this run gave it, on the inputs it got there
    if not k3_inputs:
        raise AssertionError(f"{phase}: the model path reached no K3 call")
    k3_err = 0.0
    for tensors, kw in k3_inputs.values():
        q = tensors[0]
        case = check_k3(torch, f"K3 {phase} main path {tuple(q.shape)}",
                        *tensors, **kw)
        k3_err = max(k3_err, case["max_abs_err"])
        emit({"phase": "main_path_k3", "engine": phase, "tp": tp, **case})
    k3_inputs.clear()
    torch.cuda.empty_cache()
    return launches, k3_err


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


def device_breakdown(torch, fn, trace_path) -> dict:
    """Time one call of ``fn`` on the host's clock, then trace one more
    with torch.profiler into ``trace_path``: device time summed by kind of
    kernel, the longest kernels, the time some kernel ran (the union over
    streams, so kernels that overlap count once), the share of the first
    call's wall time in which none ran, and how much of K1's device time
    overlapped other kernels.  Kernels launched inside K3's live-tile
    range count as K3; that range's host time is given apart, and so are
    the host's time to enqueue the first call (until it returns) and its
    span from the traced call's first launch to its last."""
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
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") == K3.LIVE_TILES_RANGE]
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "dur" in e]
    table = {e.get("args", {}).get("correlation") for e in launches
             if any(s <= e["ts"] <= t for s, t in spans)} - {None}
    kinds = {"gemm": 0.0, "flash_attention": 0.0, "fused_rmsnorm": 0.0,
             "ar_rmsnorm": 0.0, "other": 0.0}
    iv, table_ms, table_n, per_name = [], 0.0, 0, {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset") \
                or "dur" not in e:
            continue
        ms = e["dur"] / 1e3
        in_table = e.get("args", {}).get("correlation") in table
        kind = "flash_attention" if in_table else kernel_kind(e["name"])
        kinds[kind] += ms
        table_ms += ms if in_table else 0.0
        table_n += in_table
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
            "k3_table_host_ms": sum(t - s for s, t in spans) / 1e3,
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
# phase 5: the same small float32 model on the card and on the CPU
# --------------------------------------------------------------------------

def identity_phase(torch, np, seed: int, *, tp: int, comm_mode: str):
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.models.build import build_model
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg = ModelConfig(name="small", family="dense", num_layers=2, d_model=256,
                      num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512,
                      vocab_size=512, dtype="float32")
    pcfg = ParallelConfig(comm_mode=comm_mode, attn_impl="pallas",
                          use_pallas_norm=True, split_unit=16,
                          tokenweave_min_tokens=32)
    scfg = SchedulerConfig(max_batch=16, chunk_tokens=64, max_len=128,
                           prefill_bucket=16)
    api = build_model(cfg, pcfg, tp=tp)
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
    outs, launches, weave = {}, {}, {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        reset_launches()
        eng = Engine(api, params, scfg, device=dev)
        for i, p in enumerate(prompts):
            eng.add_request(Request(rid=i, prompt=p, max_new_tokens=6))
        outs[dev] = {r.rid: r.output for r in eng.run()}
        torch.cuda.synchronize()
        launches[dev] = read_launches()
        weave[dev] = eng.stats.weave_forwards
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(f"tp={tp}: cuda tokens {outs['cuda']} != cpu "
                             f"{outs['cpu']}")
    if (0 in (launches["cuda"][norm_kernel],
              launches["cuda"]["flash_attention"])
            or any(launches["cpu"].values()) or not weave["cuda"]):
        raise AssertionError(f"tp={tp}: launches {launches}, weave "
                             f"forwards {weave}")

    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 48)))
    pos = torch.arange(48, dtype=torch.int32)[None].repeat(2, 1)
    pos[1, 40:] = -1
    last = torch.tensor([47, 39])
    logits = {}
    with torch.no_grad():
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            rows = api.init_cache(2, scfg.max_len, device=dev)
            logits[dev], _ = api.prefill(params, tokens.to(dev), rows,
                                         pos.to(dev), last_idx=last.to(dev))
    err = max_err(logits["cuda"].cpu(), logits["cpu"])
    if not err <= IDENTITY_LOGIT_TOL:
        raise AssertionError(f"tp={tp}: prefill logits differ by {err}")
    emit({"phase": "identity", "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "requests": len(prompts),
          "tokens_identical": True, "weave_forwards": weave["cuda"],
          "cuda_launches": launches["cuda"],
          "prefill_logits_max_abs_err": err, "tol": IDENTITY_LOGIT_TOL})


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
    paths = [engine_phase(torch, np, args.seed, args.trace_dir, tp=1,
                          comm_mode="fused"),
             engine_phase(torch, np, args.seed, args.trace_dir, tp=8,
                          comm_mode="ring")]
    launches = {name: sum(p[0][name] for p in paths)
                for name in paths[0][0]}
    # the K3 error over every shape the main paths gave it, too
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], *(p[1] for p in paths))
    identity_phase(torch, np, args.seed, tp=1, comm_mode="fused")
    identity_phase(torch, np, args.seed, tp=2, comm_mode="ring")

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
