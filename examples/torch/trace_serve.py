"""Observability walkthrough (DESIGN.md §12; the port of
``examples/trace_serve.py``): a seeded online-serving run
with a ``TraceRecorder`` attached — writes the Chrome-trace/Perfetto JSON,
prints the per-phase compute/comm/overlapped virtual-time breakdown from
the per-forward weave attributions, and walks ONE request's weave-decision
log end to end (every forward the engine ran while it was live, with the
split decision and §9 roofline estimate each one carried).

    python examples/torch/trace_serve.py [--device cpu] [--requests 8] \
        [--packed] [--out trace.json] [--follow RID]

Load the JSON at https://ui.perfetto.dev: one process per engine track,
one thread per request lifecycle.
"""
import argparse
from collections import defaultdict

import _path  # noqa: F401  (src/ on sys.path)

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models.build import build_model
from repro_torch.obs import (TERMINAL_PHASES, TraceRecorder,
                             export_chrome_trace, validate_chrome_trace,
                             weave_counts_from_trace)
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.requests import poisson_arrivals, sharegpt_like_trace
from repro_torch.runtime.scheduler import SchedulerConfig
from repro_torch.runtime.server import OnlineServer, ServerConfig, StepCost


def main(argv=None):
    p = argparse.ArgumentParser()
    _path.add_device_arg(p)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--rate", type=float, default=0.25)
    p.add_argument("--packed", action="store_true",
                   help="packed hybrid batching (one forward/iteration)")
    p.add_argument("--out", default="trace.json",
                   help="Chrome-trace JSON output path")
    p.add_argument("--follow", type=int, default=0, metavar="RID",
                   help="request whose weave-decision log to walk")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                      vocab_size=128, dtype="float32")
    pcfg = ParallelConfig(tokenweave=True, comm_mode="fused", remat=False,
                          split_unit=16, tokenweave_min_tokens=32)
    api = build_model(cfg, pcfg, tp=1)
    params = api.init(0, device=device)

    rec = TraceRecorder()
    eng = Engine(api, params,
                 SchedulerConfig(max_batch=4, chunk_tokens=48, max_len=128,
                                 prefill_bucket=16, paged=True,
                                 packed=args.packed),
                 device=device, obs=rec, obs_track="engine")
    srv = OnlineServer(eng, ServerConfig(
        step_cost=StepCost(base=1.0, per_token=0.05)))

    reqs = sharegpt_like_trace(args.requests, vocab=cfg.vocab_size, seed=11,
                               max_in=48, max_out=8)
    for r in reqs:
        r.max_new_tokens = max(2, min(r.max_new_tokens, 8))
    for r in poisson_arrivals(reqs, rate=args.rate, seed=5):
        srv.submit(r)
    done = srv.run()
    print(f"served {len(done)} requests in {srv.clock:.1f} virtual ticks, "
          f"{eng.stats.steps} engine steps")

    # ---- per-phase virtual-time breakdown from the attributions -------
    by_kind = defaultdict(lambda: [0, 0, 0.0, 0.0, 0.0])
    for ev in rec.events:
        if ev["kind"] != "span" or ev["cat"] != "forward":
            continue
        a = ev["args"]
        t = by_kind[a["kind"]]
        t[0] += 1
        t[1] += int(bool(a["weave"]))
        t[2] += a["est_compute"]
        t[3] += a["est_comm"]
        t[4] += a["est_overlapped"]
    print("\nper-phase breakdown (est. §9-roofline virtual seconds):")
    print(f"  {'phase':<9} {'fwds':>5} {'weave':>6} {'compute':>11} "
          f"{'comm':>11} {'overlapped':>11} {'comm hidden':>11}")
    for kind in sorted(by_kind):
        n, w, comp, comm, ovl = by_kind[kind]
        hidden = ovl / comm if comm else 0.0
        print(f"  {kind:<9} {n:>5} {w:>6} {comp:>11.3e} {comm:>11.3e} "
              f"{ovl:>11.3e} {hidden:>10.1%}")
    w, n = weave_counts_from_trace(rec)
    assert (w, n) == (eng.stats.weave_forwards, eng.stats.forwards), \
        "trace and EngineStats disagree — the §12 invariant broke"
    print(f"\nweave rate: {w}/{n} = {w / max(n, 1):.3f} "
          f"(trace == EngineStats: True)")

    # ---- one request end to end ---------------------------------------
    rid = args.follow
    evs = [ev for ev in rec.events
           if ev["kind"] == "request" and ev["rid"] == str(rid)]
    if not evs:
        raise SystemExit(f"request {rid} not in trace")
    print(f"\nrequest {rid} lifecycle:")
    for ev in evs:
        extra = {k: v for k, v in ev["args"].items() if v is not None}
        print(f"  t={ev['ts']:8.2f}  {ev['phase']:<15} {extra}")
    t0 = min(ev["ts"] for ev in evs)
    t1 = max(ev["ts"] for ev in evs)
    print(f"\nweave decisions while request {rid} was live "
          f"(t in [{t0:.1f}, {t1:.1f}]):")
    for ev in rec.events:
        if ev["kind"] != "span" or ev["cat"] != "forward":
            continue
        if not (t0 <= ev["ts"] <= t1):
            continue
        a = ev["args"]
        print(f"  t={ev['ts']:8.2f}  {ev['name']:<16} "
              f"weave={str(bool(a['weave'])):<5} reason={a['reason']:<18} "
              f"tokens={a['tokens']:>3}  split={a['split']}  "
              f"ovl={a['est_overlapped']:.3g}")
    term = [ev["phase"] for ev in evs if ev["phase"] in TERMINAL_PHASES]
    print(f"terminal: {term[0]}")

    # ---- export ---------------------------------------------------------
    doc = export_chrome_trace(rec, path=args.out)
    fails = validate_chrome_trace(doc)
    assert not fails, fails
    print(f"\nwrote {len(doc['traceEvents'])} events to {args.out} "
          f"(valid; open at https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
