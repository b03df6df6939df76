#!/usr/bin/env python3
"""K1 beside an earlier checkout, on one NVIDIA GPU, in turns.

    python3 scripts/k1_ab.py --parent DIR [--out DIR]

DIR is a checkout of an earlier commit of this repository (``git archive
<commit> | tar -x -C DIR``) whose ``src/repro_torch/csrc/ar_rmsnorm.cu``
has the same C entry point, its sixth-from-last argument a body flag
(1: vector rows, 0: scalar) where this tree's takes a route.

1. One-card K1 (bf16, 8 CTAs) at every served width and at Llama's
   decode and verify sizes: the earlier kernel and this tree's (the
   route its rule picks) in ten alternating pairs, with the largest
   difference of their outputs; then this tree's two vector routes
   (register, and bulk where a row takes the whole CTA) in turns
   (register, bulk, bulk, register).  Times: CUDA events over a CUDA
   graph of 10 calls (``chip_smoke.time_ms``).
2. This tree's two vector routes where the bulk route can run (rows of
   a whole CTA: bf16 d 6144 and 8192, float32 d 4096) swept over the
   rows a CTA takes (T and the grid, ``SWEEP``), in turns (register,
   bulk, bulk, register), bit-equal, with the route the rule picks.
3. The cross-rank form: ``chip_smoke.py --k1-peer-local`` run from DIR and
   from this tree in turns (earlier, this, this, earlier), each a process
   of its own; one summary line per case with every run's ms.

Prints one JSON line per case, the card's name and power limit, and
writes each child's output under --out.  Exits 2 without a CUDA device.
"""
import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (N, T, d): every served width at a prefill split of N 8, d 8192 and 4096
# at the other N, and Llama's decode and verify sizes (chip_smoke.py
# K1_TIMED)
CASES = ((8, 12000, 512), (8, 3000, 512), (8, 2048, 2048), (8, 2048, 3584),
         (8, 2048, 4096), (8, 2048, 6144), (8, 2048, 8192), (4, 2048, 4096),
         (4, 2048, 8192), (2, 2048, 8192), (8, 8, 8192), (8, 32, 8192),
         (4, 8, 8192))
PAIRS = 10
# (N, d, dtype, T values, grids): whole-CTA rows for the route sweep
SWEEP = ((8, 8192, "bfloat16", (16, 32, 64, 128, 256, 512), (2, 4, 8)),
         (8, 6144, "bfloat16", (16, 32, 64, 128, 256, 512), (2, 4, 8)),
         (8, 4096, "float32", (16, 32, 64, 128, 256, 512), (2, 4, 8)),
         (4, 8192, "bfloat16", (128, 2048), (8,)),
         (4, 6144, "bfloat16", (128, 2048), (8,)))


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def earlier_k1(torch, K1, build, parent: Path, out: Path):
    """The earlier checkout's one-card K1, built here, as a callable."""
    lib_path = out / "libk1_earlier.so"
    src = parent / "src" / "repro_torch" / "csrc" / "ar_rmsnorm.cu"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    p, i, tab = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(K1.PtrTable)
    lib.ar_rmsnorm.argtypes = [tab, tab, p, tab, tab, i, i, i,
                               ctypes.c_float, i, i, i, p]
    lib.ar_rmsnorm.restype = i

    def run(x, r, w):
        out_t, new_res = torch.empty_like(x), torch.empty_like(r)
        n, t, d = x.shape
        tabs = [K1._table(a) for a in (x, r, out_t, new_res)]
        rc = lib.ar_rmsnorm(
            ctypes.byref(tabs[0]), ctypes.byref(tabs[1]), w.data_ptr(),
            ctypes.byref(tabs[2]), ctypes.byref(tabs[3]), n, t, d, 1e-6, 1,
            int(K1.pipelined(x, r, w)), K1.MAX_CTAS,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier K1: CUDA error {rc}")
        return out_t, new_res
    return run


def one_card(torch, cs, parent: Path, out: Path) -> None:
    from repro_torch.kernels import ar_rmsnorm as K1
    from repro_torch.kernels import build
    build.build(["ar_rmsnorm"])
    earlier = earlier_k1(torch, K1, build, parent, out)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for n, t, d in CASES:
        x = torch.randn(n, t, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        r = torch.randn(n, t // n, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        w = (torch.randn(d, generator=gen, device="cuda").abs() + 0.5
             ).to(torch.bfloat16)
        (e_out, e_res), (o_out, o_res) = earlier(x, r, w), K1.ar_rmsnorm(
            x, r, w)
        torch.cuda.synchronize()
        row = {"kernel": "ar_rmsnorm", "N": n, "T": t, "d": d,
               "dtype": "bfloat16", "ctas": K1.MAX_CTAS,
               "route": K1.route(d, torch.bfloat16, n, t, K1.MAX_CTAS),
               "earlier_vs_this_max_abs": max(cs.max_err(e_out, o_out),
                                              cs.max_err(e_res, o_res)),
               "earlier_ms": [], "this_ms": []}
        for k in range(PAIRS):
            pair = [("earlier", lambda: earlier(x, r, w)),
                    ("this", lambda: K1.ar_rmsnorm(x, r, w))]
            for name, fn in pair if k % 2 == 0 else pair[::-1]:
                row[f"{name}_ms"].append(cs.time_ms(torch, fn))
        row["this_faster_pairs"] = sum(
            a < b for a, b in zip(row["this_ms"], row["earlier_ms"]))
        routes = ["register"]
        if K1.row_group(d, torch.bfloat16)[1] == K1.CTA_THREADS:
            routes.append("bulk")
        for name in routes + routes[::-1]:
            row.setdefault(f"{name}_ms", []).append(cs.time_ms(
                torch, lambda name=name: K1._launch(x, r, w, 1e-6,
                                                    K1.MAX_CTAS, name)))
        print(json.dumps(row), flush=True)


def route_sweep(torch, cs) -> None:
    from repro_torch.kernels import ar_rmsnorm as K1
    gen = torch.Generator(device="cuda").manual_seed(2)
    for n, d, dtype, ts, grids in SWEEP:
        dt = getattr(torch, dtype)
        for t in ts:
            x = torch.randn(n, t, d, generator=gen, device="cuda", dtype=dt)
            r = torch.randn(n, t // n, d, generator=gen, device="cuda",
                            dtype=dt)
            w = (torch.randn(d, generator=gen, device="cuda").abs() + 0.5
                 ).to(dt)
            for ctas in grids:
                runs = {k: K1._launch(x, r, w, 1e-6, ctas, k)
                        for k in ("register", "bulk")}
                torch.cuda.synchronize()
                (a, ar), (b, br) = runs["register"], runs["bulk"]
                if not (torch.equal(a, b) and torch.equal(ar, br)):
                    raise AssertionError(f"K1 routes differ at N={n} T={t} "
                                         f"d={d} {dtype} on {ctas} CTAs")
                row = {"kernel": "ar_rmsnorm", "sweep": True, "N": n, "T": t,
                       "d": d, "dtype": dtype, "ctas": ctas,
                       "rows_per_cta": K1.rows_per_cta(t, d, dt, ctas),
                       "route": K1.route(d, dt, n, t, ctas)}
                order = ["register", "bulk"]
                for name in order + order[::-1]:
                    row.setdefault(f"{name}_ms", []).append(cs.time_ms(
                        torch, lambda name=name: K1._launch(
                            x, r, w, 1e-6, ctas, name)))
                row["bulk_over_register"] = (sum(row["bulk_ms"])
                                             / sum(row["register_ms"]))
                print(json.dumps(row), flush=True)


def cross_rank(out: Path, parent: Path) -> None:
    env = dict(os.environ, CUDA_DEVICE_MAX_CONNECTIONS="32")
    runs = {}
    for k, who in enumerate(("earlier", "this", "this", "earlier")):
        cwd = parent if who == "earlier" else ROOT
        proc = subprocess.run([sys.executable, "chip_smoke.py",
                               "--k1-peer-local"], cwd=cwd, env=env,
                              capture_output=True, text=True)
        (out / f"k1_peer_{k}_{who}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{who}: k1_peer_local exit "
                               f"{proc.returncode}\n{proc.stderr[-3000:]}")
        for ln in proc.stdout.splitlines():
            if not ln.startswith("{"):
                continue
            case = json.loads(ln)
            if case.get("mode") != "one_process":
                continue
            key = (case["N"], case["T"], case["d"], case["dtype"])
            row = runs.setdefault(key, {})
            row.setdefault(f"{who}_ms", []).append(case["ms"])
            if "ms_free" in case:
                row.setdefault("this_ms_free", []).append(case["ms_free"])
    for (n, t, d, dtype), row in runs.items():
        print(json.dumps({"kernel": "ar_rmsnorm_peer", "N": n, "T": t,
                          "d": d, "dtype": dtype, **row}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k1_ab")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    args.out.mkdir(parents=True, exist_ok=True)
    cs = chip_smoke()
    one_card(torch, cs, args.parent.resolve(), args.out)
    route_sweep(torch, cs)
    cross_rank(args.out, args.parent.resolve())
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
