"""Structured trace events on the deterministic virtual clock
(DESIGN.md §12), as ``repro.obs.trace``: pure Python, the same events
and the same exported JSON.

``TraceRecorder`` collects three raw event kinds:

* **spans**    — ``complete(track, name, ts, dur)``: a named interval on a
  replica track.  The engine emits one ``step/*`` span per iteration and
  one nested ``forward/*`` span per model dispatch (carrying the weave
  attribution record, obs/attribution.py).
* **instants** — point events on a track.
* **request lifecycle events** — ``request_event(rid, phase)``: arrival →
  queued → admit → prefill_done → (preempt | handoff_export →
  handoff_adopt)* → finish | cancel | expire.  Exactly one terminal phase
  per admitted request is an exported invariant
  (``validate_chrome_trace``), including cancels that land mid-migration.

Time is whatever virtual clock the caller owns: ``OnlineServer`` /
``Replica`` push their clock in via ``sync`` before each engine step; a
bare offline ``Engine`` self-advances one tick per step via ``auto``
(which defers to ``sync`` forever after the first external sync).  The
recorder never reads wall time, so a trace is a pure function of the
workload — and recording is observation only: tracing on vs off is
token-identical and step-count-identical (DESIGN.md §12, pinned by
tests/test_torch_obs.py against the reference's).

``export_chrome_trace`` emits the Chrome-trace / Perfetto JSON object
format (one process per track, plus a ``requests`` process with one
thread per request); load it at https://ui.perfetto.dev.  One virtual
tick maps to one second (1e6 µs).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple, Union

# virtual ticks -> chrome-trace microseconds (1 tick = 1s)
TS_SCALE = 1_000_000.0

TERMINAL_PHASES = ("finish", "cancel", "expire")

# lifecycle phase -> the state the request is in UNTIL its next event
# (drawn as a derived span on the request's thread)
_SEGMENT = {
    "arrival": "pending",
    "queued": "queued",
    "admit": "prefill",
    "prefill_done": "decode",
    "preempt": "queued",
    "handoff_export": "migrating",
    "handoff_adopt": "decode",
    "requeue": "queued",     # replica died; re-admitted elsewhere (§15)
}


class TraceRecorder:
    """Collects structured events; ``None`` (the default everywhere) means
    tracing is off and no observability code runs at all.

    ``request_ns`` prefixes request ids so independent workloads merged
    into one exported trace (the benchmark sweep) cannot collide, while a
    cluster — many engines, ONE recorder — keeps a single lifecycle per
    rid across migrations.
    """

    def __init__(self, request_ns: str = ""):
        self.request_ns = request_ns
        self.now = 0.0
        self.events: List[dict] = []
        self._synced = False

    # ---- clock ---------------------------------------------------------
    def sync(self, t: float) -> None:
        """External virtual-clock owners (OnlineServer, Replica) stamp the
        recorder before each engine step.  Per-track monotonicity follows
        from each owner's clock being monotonic."""
        self._synced = True
        self.now = float(t)

    def auto(self, t: float) -> None:
        """Offline-engine fallback clock (one tick per step); a no-op once
        any external owner has synced."""
        if not self._synced:
            self.now = float(t)

    # ---- raw events ----------------------------------------------------
    def complete(self, track: str, name: str, ts: float, dur: float,
                 cat: str = "step", args: Optional[dict] = None) -> None:
        self.events.append({"kind": "span", "track": track, "name": name,
                            "cat": cat, "ts": float(ts), "dur": float(dur),
                            "args": args or {}})

    def instant(self, track: str, name: str, ts: Optional[float] = None,
                cat: str = "mark", args: Optional[dict] = None) -> None:
        self.events.append({"kind": "instant", "track": track, "name": name,
                            "cat": cat,
                            "ts": self.now if ts is None else float(ts),
                            "args": args or {}})

    def request_event(self, rid, phase: str, ts: Optional[float] = None,
                      args: Optional[dict] = None) -> None:
        self.events.append({"kind": "request",
                            "rid": f"{self.request_ns}{rid}",
                            "phase": phase,
                            "ts": self.now if ts is None else float(ts),
                            "args": args or {}})


def weave_counts_from_trace(rec: TraceRecorder,
                            track: Optional[str] = None
                            ) -> Tuple[int, int]:
    """(weave_forwards, forwards) recomputed from the recorded per-forward
    attribution spans — the trace-side ground truth that must equal
    ``EngineStats.weave_forwards / forwards`` exactly (DESIGN.md §12)."""
    weave = total = 0
    for ev in rec.events:
        if ev["kind"] != "span" or ev["cat"] != "forward":
            continue
        if track is not None and ev["track"] != track:
            continue
        total += 1
        weave += int(bool(ev["args"].get("weave")))
    return weave, total


# --------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# --------------------------------------------------------------------------

def export_chrome_trace(rec: Union[TraceRecorder, List[TraceRecorder]],
                        path: Optional[str] = None) -> dict:
    """Convert recorder(s) to the Chrome-trace JSON object format.

    Layout: pid 1 is the ``requests`` process (one thread per request,
    instants per lifecycle phase plus derived state spans between them);
    every distinct track gets its own process from pid 2 up, events on
    tid 0.  Event order within a (pid, tid) preserves emission order,
    which ``validate_chrome_trace`` checks is time-monotonic.
    """
    recs = rec if isinstance(rec, list) else [rec]
    events: List[dict] = []
    track_pid: Dict[str, int] = {}
    req_tid: Dict[str, int] = {}
    REQ_PID = 1
    events.append({"name": "process_name", "ph": "M", "pid": REQ_PID,
                   "tid": 0, "args": {"name": "requests"}})

    def pid_of(track: str) -> int:
        if track not in track_pid:
            track_pid[track] = 2 + len(track_pid)
            events.append({"name": "process_name", "ph": "M",
                           "pid": track_pid[track], "tid": 0,
                           "args": {"name": track}})
        return track_pid[track]

    def tid_of(rid: str) -> int:
        if rid not in req_tid:
            req_tid[rid] = 1 + len(req_tid)
            events.append({"name": "thread_name", "ph": "M", "pid": REQ_PID,
                           "tid": req_tid[rid],
                           "args": {"name": f"req {rid}"}})
        return req_tid[rid]

    # group request events per rid so derived state spans interleave with
    # their instants in time order
    by_rid: Dict[str, List[dict]] = {}
    for r in recs:
        for ev in r.events:
            if ev["kind"] == "span":
                events.append({"name": ev["name"], "cat": ev["cat"],
                               "ph": "X", "ts": ev["ts"] * TS_SCALE,
                               "dur": ev["dur"] * TS_SCALE,
                               "pid": pid_of(ev["track"]), "tid": 0,
                               "args": ev["args"]})
            elif ev["kind"] == "instant":
                events.append({"name": ev["name"], "cat": ev["cat"],
                               "ph": "i", "s": "t",
                               "ts": ev["ts"] * TS_SCALE,
                               "pid": pid_of(ev["track"]), "tid": 0,
                               "args": ev["args"]})
            else:
                by_rid.setdefault(ev["rid"], []).append(ev)

    for rid, evs in by_rid.items():
        tid = tid_of(rid)
        for i, ev in enumerate(evs):
            events.append({"name": ev["phase"], "cat": "request",
                           "ph": "i", "s": "t", "ts": ev["ts"] * TS_SCALE,
                           "pid": REQ_PID, "tid": tid, "args": ev["args"]})
            seg = _SEGMENT.get(ev["phase"])
            if seg is not None and i + 1 < len(evs):
                events.append({"name": seg, "cat": "request_phase",
                               "ph": "X", "ts": ev["ts"] * TS_SCALE,
                               "dur": (evs[i + 1]["ts"] - ev["ts"])
                               * TS_SCALE,
                               "pid": REQ_PID, "tid": tid, "args": {}})

    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"clock": "virtual (1 tick = 1s)",
                         "schema": "repro.obs DESIGN.md §12"}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    return doc


# --------------------------------------------------------------------------
# schema validation (chip_smoke.py's online phase gates on it)
# --------------------------------------------------------------------------

def validate_chrome_trace(doc: dict) -> List[str]:
    """Structural + semantic checks over an exported trace.  Returns a
    list of failure strings (empty = valid):

    * every event carries name/ph/ts/pid/tid; complete spans a dur >= 0;
    * per (pid, tid), timestamps are monotonically nondecreasing in
      emission order (the virtual-clock monotonicity invariant);
    * every ``forward`` span nests inside a ``step`` span on its track;
    * every forward span carries the full weave attribution record;
    * request threads: at most one terminal phase, EXACTLY one for every
      admitted request, and nothing after the terminal.
    """
    fails: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]

    last_ts: Dict[Tuple[int, int], float] = {}
    steps: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    forwards: List[Tuple[Tuple[int, int], float, float, dict]] = []
    req_phases: Dict[Tuple[int, int], List[str]] = {}

    for i, ev in enumerate(evs):
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                fails.append(f"event {i}: missing {field!r}")
                break
        else:
            ph = ev["ph"]
            if ph == "M":
                continue
            if "ts" not in ev or not isinstance(ev["ts"], (int, float)):
                fails.append(f"event {i} ({ev['name']}): bad ts")
                continue
            key = (ev["pid"], ev["tid"])
            if ev["ts"] < last_ts.get(key, float("-inf")) - 1e-6:
                fails.append(
                    f"event {i} ({ev['name']}): ts {ev['ts']} goes "
                    f"backwards on track pid={key[0]} tid={key[1]} "
                    f"(last {last_ts[key]})")
            last_ts[key] = max(last_ts.get(key, float("-inf")), ev["ts"])
            if ph == "X":
                dur = ev.get("dur")
                if not isinstance(dur, (int, float)) or dur < 0:
                    fails.append(f"event {i} ({ev['name']}): complete span "
                                 f"needs dur >= 0, got {dur!r}")
                    continue
                if ev.get("cat") == "step":
                    steps.setdefault(key, []).append((ev["ts"],
                                                      ev["ts"] + dur))
                elif ev.get("cat") == "forward":
                    forwards.append((key, ev["ts"], ev["ts"] + dur,
                                     ev.get("args", {})))
            elif ph == "i" and ev.get("cat") == "request":
                req_phases.setdefault(key, []).append(ev["name"])

    eps = 1e-3  # µs — float slack on nested span edges
    required = ("weave", "reason", "tokens", "threshold", "method",
                "plan_id", "est_compute", "est_comm", "est_overlapped")
    for key, t0, t1, args in forwards:
        if not any(s0 - eps <= t0 and t1 <= s1 + eps
                   for s0, s1 in steps.get(key, [])):
            fails.append(f"forward span at ts={t0} on pid={key[0]} not "
                         f"nested in any step span")
        missing = [f for f in required if f not in args]
        if missing:
            fails.append(f"forward span at ts={t0}: attribution record "
                         f"missing {missing}")

    for key, phases in req_phases.items():
        terms = [p for p in phases if p in TERMINAL_PHASES]
        admitted = any(p in ("admit", "handoff_adopt") for p in phases)
        if len(terms) > 1:
            fails.append(f"request tid={key[1]}: {len(terms)} terminal "
                         f"events {terms}")
        if admitted and len(terms) != 1:
            fails.append(f"request tid={key[1]}: admitted but "
                         f"{len(terms)} terminal event(s) (phases: "
                         f"{phases})")
        if terms and phases[-1] not in TERMINAL_PHASES:
            fails.append(f"request tid={key[1]}: events after terminal "
                         f"{terms[0]!r}: {phases}")
    return fails
