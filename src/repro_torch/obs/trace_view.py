"""Inspect / validate a Chrome-trace JSON exported by the port
(``repro_torch.obs.export_chrome_trace``, DESIGN.md §12).

    python -m repro_torch.obs.trace_view TRACE.json              # summary
    python -m repro_torch.obs.trace_view TRACE.json --validate   # CI gate
    python -m repro_torch.obs.trace_view TRACE.json --request online7
    python -m repro_torch.obs.trace_view TRACE.json --measured   # §13

(from ``src/`` with no PYTHONPATH, or with ``src`` on ``sys.path``).  The
counterpart of ``scripts/trace_view.py`` over ``repro_torch.obs.trace``:
the same four modes, the same output and exit codes.

Summary mode prints, per engine track: step/forward span counts, the
trace-derived weave rate (weave forwards / forwards, recomputed from the
per-forward attribution records, the number ``EngineStats.weave_rate``
reports), the per-forward decision reasons with the overlap-policy plan
ids that made them (plan id 0 = the global threshold, a nonzero id = a
tuned plan from ``analysis/autotune.py``, DESIGN.md §14), and the
estimated compute / comm / overlapped virtual-time totals from the §9
sim roofline.  ``--request`` walks one request's lifecycle thread event
by event (arrival -> ... -> terminal) with every forward step while it
was live.  ``--validate`` runs the schema check
(``repro_torch.obs.validate_chrome_trace``) and exits non-zero on any
failure.  ``--measured`` summarizes the ``[measured]`` wall-clock track a
``WallClockProfiler`` recorded (DESIGN.md §13): per (track, phase),
measured seconds next to the §9-roofline virtual-second estimates and
their ratio.

The trace itself loads in the Perfetto UI.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from repro_torch.obs.trace import TERMINAL_PHASES, validate_chrome_trace


def _tracks(doc: dict):
    """pid -> process name, (pid, tid) -> thread name."""
    procs, threads = {}, {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "M":
            continue
        if ev["name"] == "process_name":
            procs[ev["pid"]] = ev["args"]["name"]
        elif ev["name"] == "thread_name":
            threads[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    return procs, threads


def summarize(doc: dict) -> None:
    procs, _ = _tracks(doc)
    per = defaultdict(lambda: {"steps": 0, "forwards": 0, "weave": 0,
                               "compute": 0.0, "comm": 0.0,
                               "overlapped": 0.0,
                               "by_reason": defaultdict(int),
                               "by_plan": defaultdict(int),
                               "by_method": defaultdict(int)})
    requests = defaultdict(list)
    for ev in doc["traceEvents"]:
        ph, cat = ev.get("ph"), ev.get("cat")
        if ph == "X" and cat == "step":
            per[procs.get(ev["pid"], ev["pid"])]["steps"] += 1
        elif ph == "X" and cat == "forward":
            t = per[procs.get(ev["pid"], ev["pid"])]
            a = ev.get("args", {})
            t["forwards"] += 1
            t["weave"] += int(bool(a.get("weave")))
            t["compute"] += a.get("est_compute", 0.0)
            t["comm"] += a.get("est_comm", 0.0)
            t["overlapped"] += a.get("est_overlapped", 0.0)
            t["by_reason"][a.get("reason", "?")] += 1
            t["by_plan"][a.get("plan_id", 0)] += 1
            t["by_method"][a.get("method", "?")] += 1
        elif ph == "i" and cat == "request":
            requests[(ev["pid"], ev["tid"])].append(ev["name"])

    for name in sorted(per):
        t = per[name]
        rate = t["weave"] / t["forwards"] if t["forwards"] else 0.0
        print(f"track {name}: {t['steps']} steps, {t['forwards']} forwards, "
              f"weave_rate={rate:.4f}")
        reasons = ", ".join(f"{k}={v}" for k, v in
                            sorted(t["by_reason"].items()))
        print(f"  decisions: {reasons}")
        # method=ring/ringweave rows are forwards the plan routed onto the
        # REAL fused ring AllReduce-RMSNorm kernel (DESIGN.md §14)
        methods = ", ".join(
            f"{k}{' [fused-kernel]' if k in ('ring', 'ringweave') else ''}"
            f"={v}" for k, v in sorted(t["by_method"].items()))
        print(f"  methods: {methods}")
        plans = ", ".join(
            f"{'global-threshold' if pid == 0 else f'plan {pid}'}={v}"
            for pid, v in sorted(t["by_plan"].items()))
        print(f"  decided by: {plans}")
        print(f"  est virtual time: compute={t['compute']:.6g} "
              f"comm={t['comm']:.6g} overlapped={t['overlapped']:.6g}")
    n_term = sum(1 for phases in requests.values()
                 if any(p in TERMINAL_PHASES for p in phases))
    print(f"requests: {len(requests)} lifecycle threads, "
          f"{n_term} reached a terminal phase")


def summarize_measured(doc: dict) -> int:
    """Virtual-vs-measured per phase from the ``[measured]`` track(s)."""
    procs, _ = _tracks(doc)
    per = defaultdict(lambda: {"n": 0, "measured_s": 0.0, "virtual_s": 0.0})
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X" or ev.get("cat") != "measured":
            continue
        a = ev.get("args", {})
        track = procs.get(ev["pid"], ev["pid"])
        kind = a.get("kind", ev.get("name", "?"))
        t = per[(track, kind)]
        t["n"] += 1
        # the exporter scales 1 virtual tick (= 1 wall second on the
        # measured track) to 1e6 trace units
        t["measured_s"] += ev.get("dur", 0.0) / 1e6
        t["virtual_s"] += a.get("est_makespan", 0.0)
    if not per:
        print("no measured spans in this trace — record one with a "
              "WallClockProfiler attached to the engine "
              "(repro_torch.obs.profiler, DESIGN.md §13)", file=sys.stderr)
        return 1
    print(f"{'track':<22} {'phase':<9} {'n':>5} {'measured_s':>12} "
          f"{'virtual_s':>12} {'meas/virt':>10}")
    for (track, kind) in sorted(per):
        t = per[(track, kind)]
        ratio = (t["measured_s"] / t["virtual_s"] if t["virtual_s"]
                 else float("inf"))
        print(f"{str(track):<22} {kind:<9} {t['n']:>5} "
              f"{t['measured_s']:>12.6f} {t['virtual_s']:>12.6f} "
              f"{ratio:>10.3g}")
    tot_m = sum(t["measured_s"] for t in per.values())
    tot_v = sum(t["virtual_s"] for t in per.values())
    print(f"total: measured={tot_m:.6f}s virtual={tot_v:.6g}s "
          f"ratio={tot_m / tot_v if tot_v else float('inf'):.3g}")
    return 0


def show_request(doc: dict, rid: str) -> int:
    procs, threads = _tracks(doc)
    want = f"req {rid}"
    key = next((k for k, v in threads.items() if v == want), None)
    if key is None:
        names = sorted(v[4:] for v in threads.values())
        print(f"no request {rid!r}; known rids: {', '.join(names)}",
              file=sys.stderr)
        return 1
    pid, tid = key
    print(f"request {rid} lifecycle:")
    for ev in doc["traceEvents"]:
        if (ev.get("pid"), ev.get("tid")) != (pid, tid):
            continue
        if ev.get("ph") == "i" and ev.get("cat") == "request":
            extra = {k: v for k, v in ev.get("args", {}).items()
                     if v is not None}
            print(f"  t={ev['ts'] / 1e6:10.4f}  {ev['name']:<15} {extra}")
    # every forward span whose step committed tokens for this rid is not
    # tagged per-rid (packed forwards are shared); show the overlap-policy
    # decision log of all forwards instead, time-interleaved with the
    # lifecycle — each row names the plan that decided it (plan 0 = the
    # degenerate global threshold, DESIGN.md §14)
    print(f"\noverlap-policy decisions while {rid} was live (all tracks):")
    first = min((ev["ts"] for ev in doc["traceEvents"]
                 if (ev.get("pid"), ev.get("tid")) == (pid, tid)
                 and "ts" in ev), default=0.0)
    last = max((ev["ts"] for ev in doc["traceEvents"]
                if (ev.get("pid"), ev.get("tid")) == (pid, tid)
                and "ts" in ev), default=0.0)
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X" or ev.get("cat") != "forward":
            continue
        if not (first <= ev["ts"] <= last):
            continue
        a = ev.get("args", {})
        track = procs.get(ev["pid"], ev["pid"])
        plan = a.get("plan_id", 0)
        print(f"  t={ev['ts'] / 1e6:10.4f}  {track:<10} {ev['name']:<16} "
              f"weave={str(bool(a.get('weave'))):<5} "
              f"reason={a.get('reason', '?'):<16} tokens={a.get('tokens')} "
              f"plan={'threshold' if plan == 0 else plan} "
              f"bucket={a.get('bucket', '?')} "
              f"ovl={a.get('est_overlapped', 0.0):.3g}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace", help="Chrome-trace JSON from export_chrome_trace")
    p.add_argument("--validate", action="store_true",
                   help="schema + invariant check; non-zero exit on failure")
    p.add_argument("--request", default=None, metavar="RID",
                   help="walk one request's lifecycle thread")
    p.add_argument("--measured", action="store_true",
                   help="virtual-vs-measured wall-clock summary per phase "
                        "(needs a trace recorded with a WallClockProfiler)")
    args = p.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)

    if args.validate:
        fails = validate_chrome_trace(doc)
        if fails:
            print(f"{len(fails)} validation failure(s):", file=sys.stderr)
            for msg in fails:
                print(f"  {msg}", file=sys.stderr)
            return 1
        n = len(doc.get("traceEvents", []))
        print(f"trace valid: {n} events")
        return 0
    if args.measured:
        return summarize_measured(doc)
    if args.request is not None:
        return show_request(doc, args.request)
    summarize(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
