"""Multi-turn shared-system-prompt serving through the PAGED engine (the
port of ``examples/shared_prefix_serve.py``): every conversation starts
with the same system prompt, and follow-up turns replay their own growing
history — the workload prefix caching is built for.

Reports prefix-hit rate, preemption count, evictions, and effective
prefill tokens saved vs. a no-prefix-cache run of the identical trace.
With greedy sampling the two runs are token-identical, so the savings are
pure (the script exits non-zero if they are not).

    python examples/torch/shared_prefix_serve.py [--device cpu] \
        [--users 4] [--turns 3] [--paged-off]
"""
import argparse
import time

import _path  # noqa: F401  (src/ on sys.path)
import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models.build import build_model
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.requests import Request
from repro_torch.runtime.scheduler import SchedulerConfig


def conversation_trace(users: int, turns: int, vocab: int, sys_len: int = 96,
                       turn_len: int = 24, seed: int = 0):
    """Per user: turn t's prompt = system + full history of turns < t +
    fresh user tokens (multi-turn chat replay, the serving-paper staple)."""
    rng = np.random.RandomState(seed)
    system = [int(x) for x in rng.randint(0, vocab, size=sys_len)]
    convs = [[] for _ in range(users)]
    reqs = []
    rid = 0
    for _ in range(turns):
        for u in range(users):
            convs[u].extend(int(x) for x in
                            rng.randint(0, vocab, size=turn_len))
            reqs.append(Request(rid=rid, prompt=system + list(convs[u]),
                                max_new_tokens=8))
            rid += 1
    return reqs


def run_trace(api, params, reqs, prefix_caching, paged, chunk, device,
              max_batch=4):
    eng = Engine(api, params,
                 SchedulerConfig(max_batch=max_batch, chunk_tokens=chunk,
                                 max_len=1024, prefill_bucket=32,
                                 paged=paged, block_size=16,
                                 prefix_caching=prefix_caching),
                 device=device)
    for r in reqs:
        eng.add_request(r)
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    return eng, done, dt


def main(argv=None):
    p = argparse.ArgumentParser()
    _path.add_device_arg(p)
    p.add_argument("--users", type=int, default=4)
    p.add_argument("--turns", type=int, default=3)
    p.add_argument("--arch", default="qwen1.5-4b")
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--paged-off", action="store_true",
                   help="legacy slot engine (no paging, no prefix cache)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    pcfg = ParallelConfig(tokenweave=True, comm_mode="fused", remat=False,
                          split_unit=32, tokenweave_min_tokens=64)
    api = build_model(cfg, pcfg, tp=1)
    params = api.init(0, device=device)

    def fresh_trace():
        return conversation_trace(args.users, args.turns,
                                  vocab=cfg.vocab_size)

    paged = not args.paged_off
    eng, done, dt = run_trace(api, params, fresh_trace(),
                              prefix_caching=paged, paged=paged,
                              chunk=args.chunk, device=device)
    nominal = sum(len(r.prompt) for r in done)
    print(f"arch={cfg.name} paged={'on' if paged else 'off'} "
          f"device={device}")
    print(f"requests completed   : {len(done)}")
    print(f"engine iterations    : {eng.stats.steps}")
    print(f"nominal prompt tokens: {nominal}")
    print(f"prefill tokens run   : {eng.stats.prefill_tokens}")
    print(f"decode tokens        : {eng.stats.decode_tokens}")
    print(f"wall time            : {dt:.1f}s")
    if paged:
        st = eng.block_mgr.stats
        # vs. actually-computed prefill (miss_tokens would also count
        # recompute-readmission contexts and understate savings)
        saved = nominal - eng.stats.prefill_tokens
        print(f"prefix-hit tokens    : {st.hit_tokens} "
              f"(hit rate {st.hit_rate:.1%})")
        print(f"prefill saved        : {saved} tokens "
              f"({saved / max(nominal, 1):.1%} of nominal prefill FLOPs)")
        print(f"preemptions          : {st.preemptions}")
        print(f"evictions            : {st.evictions}")
        print(f"cow copies           : {st.cow_copies}")

        # cross-check: identical trace, prefix cache off -> same tokens
        _, done2, _ = run_trace(api, params, fresh_trace(),
                                prefix_caching=False, paged=True,
                                chunk=args.chunk, device=device)
        same = all(a.output == b.output for a, b in
                   zip(sorted(done, key=lambda r: r.rid),
                       sorted(done2, key=lambda r: r.rid)))
        print(f"outputs identical to cold-prefill run: {same}")
        if not same:
            raise SystemExit("prefix caching changed outputs!")


if __name__ == "__main__":
    main()
