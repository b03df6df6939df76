"""Online serving walkthrough (DESIGN.md §10; the port of
``examples/online_serve.py``): a Poisson-arrival trace through the
OnlineServer — streaming tokens, a mid-flight cancellation, tight
deadlines — then the same trace offline to show the token-identity pin,
and the sim's load sweep showing where the packed engine starts weaving
before two-dispatch does.

    python examples/torch/online_serve.py [--device cpu] [--requests 8] \
        [--rate 0.25] [--packed] [--deadline 30]
"""
import argparse

import _path  # noqa: F401  (src/ on sys.path)

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models.build import build_model
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.requests import poisson_arrivals, sharegpt_like_trace
from repro_torch.runtime.scheduler import SchedulerConfig
from repro_torch.runtime.server import OnlineServer, ServerConfig, StepCost
from repro_torch.sim.overlap_sim import online_summary


def main(argv=None):
    p = argparse.ArgumentParser()
    _path.add_device_arg(p)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--rate", type=float, default=0.25,
                   help="Poisson arrival rate (requests per virtual tick)")
    p.add_argument("--packed", action="store_true",
                   help="packed hybrid batching (one forward/iteration)")
    p.add_argument("--deadline", type=float, default=None,
                   help="per-request e2e SLO in virtual ticks")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                      vocab_size=128, dtype="float32")
    pcfg = ParallelConfig(tokenweave=True, comm_mode="fused", remat=False,
                          split_unit=16, tokenweave_min_tokens=32)
    api = build_model(cfg, pcfg, tp=1)
    params = api.init(0, device=device)

    def trace():
        t = sharegpt_like_trace(args.requests, vocab=cfg.vocab_size,
                                seed=11, max_in=48, max_out=8)
        for r in t:
            r.max_new_tokens = max(2, min(r.max_new_tokens, 8))
            if args.deadline is not None:
                r.deadline = r.arrival_time + args.deadline
        return poisson_arrivals(t, rate=args.rate, seed=5)

    def scfg():
        return SchedulerConfig(max_batch=4, chunk_tokens=48, max_len=128,
                               prefill_bucket=16, paged=True,
                               packed=args.packed)

    # ---- offline reference (whole queue drained at once) -------------
    off = Engine(api, params, scfg(), device=device)
    for r in trace():
        off.add_request(r)
    ref = {r.rid: r.output for r in off.run()}

    # ---- online: arrivals, streaming, a cancellation -----------------
    eng = Engine(api, params, scfg(), device=device)
    srv = OnlineServer(eng, ServerConfig(
        step_cost=StepCost(base=1.0, per_token=0.05),
        expire_on_deadline=args.deadline is not None))

    def stream(req, tok, t):
        tag = "TTFT" if len(req.output) == 1 else "    "
        print(f"  t={t:7.2f}  rid={req.rid}  +tok {tok:3d}  {tag}")

    reqs = trace()
    for r in reqs:
        srv.submit(r, on_token=stream)
    victim = reqs[-1].rid
    srv.cancel(victim, at=reqs[-1].arrival_time + 2.0)
    done = srv.run()

    got = {r.rid: r.output for r in done}
    identical = all(got[rid] == ref[rid] for rid in got)
    print(f"\ncompleted={len(done)} "
          f"aborted={[(r.rid, r.finish_reason) for r in srv.aborted]}")
    print(f"online outputs identical to offline: {identical}")
    lat = eng.stats.latency.summary()
    print(f"goodput={lat['goodput']:.2f} ttft_p50={lat['ttft_p50']:.2f} "
          f"tpot_p50={lat['tpot_p50']:.2f} e2e_p99={lat['e2e_p99']:.2f} "
          f"weave_rate={eng.stats.weave_rate:.2f} (virtual ticks)")
    if not identical:
        raise SystemExit("online outputs differ from offline")

    # ---- the load-dependence story (analytic, 70B/tp8 on H100s) ------
    big = get_config("llama3.3-70b")
    print("\noffered load sweep (llama3.3-70b, tp=8, sim):")
    print(f"{'rate':>6} {'decode':>7} {'chunk':>6} {'packed_weaves':>14} "
          f"{'halves_weave':>13} {'packed_gain':>12}")
    for rate, s in online_summary(big, [5.0, 15.0, 25.0, 30.0, 40.0],
                                  tp=8).items():
        print(f"{rate:6.0f} {s['decode_tokens']:7.0f} "
              f"{s['chunk_tokens']:6.0f} {s['packed_weaves']:14.0f} "
              f"{s['halves_weave']:13.0f} {s['packed_gain']:12.3f}")


if __name__ == "__main__":
    main()
