"""End-to-end serving driver (the port of ``examples/serve_e2e.py``): a
ShareGPT-like trace through the continuous-batching engine with
Sarathi-style chunked prefill, TokenWeave on, reporting throughput and
per-request latency stats.

    python examples/torch/serve_e2e.py [--device cpu] [--requests 8] \
        [--weave-off]
"""
import argparse
import time

import _path  # noqa: F401  (src/ on sys.path)
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models.build import build_model
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.requests import sharegpt_like_trace
from repro_torch.runtime.scheduler import SchedulerConfig


def main(argv=None):
    p = argparse.ArgumentParser()
    _path.add_device_arg(p)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--arch", default="qwen1.5-4b")
    p.add_argument("--weave-off", action="store_true")
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--max-in", type=int, default=512)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    pcfg = ParallelConfig(tokenweave=not args.weave_off, comm_mode="fused",
                          remat=False, split_unit=32,
                          tokenweave_min_tokens=64)
    api = build_model(cfg, pcfg, tp=1)
    params = api.init(0, device=device)

    eng = Engine(api, params,
                 SchedulerConfig(max_batch=4, chunk_tokens=args.chunk,
                                 max_len=1024, prefill_bucket=64),
                 device=device)
    trace = sharegpt_like_trace(args.requests, vocab=cfg.vocab_size,
                                seed=0, max_in=args.max_in, max_out=32)
    for r in trace:
        r.max_new_tokens = min(r.max_new_tokens, 16)
        eng.add_request(r)

    t0 = time.perf_counter()
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = eng.stats.prefill_tokens + eng.stats.decode_tokens
    print(f"arch={cfg.name} tokenweave={'off' if args.weave_off else 'on'} "
          f"device={device}")
    print(f"requests completed : {len(done)}/{args.requests}")
    print(f"engine iterations  : {eng.stats.steps}")
    print(f"prefill tokens     : {eng.stats.prefill_tokens}")
    print(f"decode tokens      : {eng.stats.decode_tokens}")
    print(f"throughput         : {toks/dt:,.0f} tok/s over {dt:.1f}s "
          f"(host clock, first calls included)")
    ttfts = [r.first_token_step - r.arrival_step for r in done]
    print(f"TTFT (steps)       : mean {sum(ttfts)/len(ttfts):.1f} "
          f"max {max(ttfts)}")
    if len(done) != args.requests:
        raise SystemExit(f"{args.requests - len(done)} requests unfinished")


if __name__ == "__main__":
    main()
