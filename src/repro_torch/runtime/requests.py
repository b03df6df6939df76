"""Request lifecycle + synthetic workload traces (fixed-length and
ShareGPT-like mixed-length conversations), plus the arrival processes
that drive online serving (DESIGN.md §10) and the shared-prefix group
traces the cluster router benchmarks use (DESIGN.md §11).

Trace generators never touch the global ``random`` module: they take an
explicit ``seed`` (int) or an already-constructed ``random.Random``
instance, so benchmark and test workloads are reproducible and callers can
thread one RNG through several generators without seed collisions.
"""
from __future__ import annotations

import dataclasses
import enum
import random
from typing import List, Optional, Union

Seed = Union[int, random.Random]


def _rng(seed: Seed) -> random.Random:
    return seed if isinstance(seed, random.Random) else random.Random(seed)


class State(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    state: State = State.WAITING
    slot: Optional[int] = None
    prefill_pos: int = 0              # context tokens already in cache
    output: List[int] = dataclasses.field(default_factory=list)
    arrival_step: int = 0
    first_token_step: Optional[int] = None
    done_step: Optional[int] = None
    # --- paged-cache / preemption bookkeeping ---
    resumed: bool = False             # re-prefilling after preemption
    preemptions: int = 0
    prompt_hit_tokens: int = 0        # prefix-cache hit at last admission
    # --- disaggregated serving (runtime/cluster.py, DESIGN.md §11) ---
    # park the request for KV handoff once its prefill completes (set by
    # the cluster when routing to a prefill-role replica; cleared at
    # adoption so a preemption on the decode replica re-prefills locally
    # instead of re-migrating)
    handoff_after_prefill: bool = False
    migrations: int = 0               # completed prefill->decode handoffs
    # re-admissions after a replica death (runtime/cluster.py failure
    # handling, DESIGN.md §15) — counted separately from ``preemptions``
    # because the trigger is a machine fault, not pool pressure
    requeues: int = 0
    # --- online serving (runtime/server.py, DESIGN.md §10) ---
    # all times are VIRTUAL (deterministic server clock), not wall clock
    arrival_time: float = 0.0         # when the request enters the system
    deadline: Optional[float] = None  # absolute e2e SLO deadline (None=none)
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    finish_reason: str = ""           # "" | "stop" | "cancelled" | "expired"

    @property
    def context_tokens(self) -> List[int]:
        """Tokens that must be in the cache before the next decode step.
        After a recompute-preemption the generated tokens are part of the
        context; the last output token is the pending (not yet inserted)
        decode input, so it is excluded."""
        if self.resumed and self.output:
            return self.prompt + self.output[:-1]
        return self.prompt

    @property
    def length(self) -> int:
        """Context length + pending sampled token (decode write position
        is ``length - 1``)."""
        if self.state == State.DECODE:
            return len(self.prompt) + len(self.output)
        return self.prefill_pos + len(self.output)

    @property
    def prefill_done(self) -> bool:
        return self.prefill_pos >= len(self.context_tokens)

    # --- SLO metrics (virtual time; populated by runtime/server.py) ---
    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token AFTER the first (None until finished or
        when only one token was produced)."""
        if self.finish_time is None or self.first_token_time is None:
            return None
        if len(self.output) <= 1:
            return None
        return ((self.finish_time - self.first_token_time)
                / (len(self.output) - 1))

    @property
    def e2e_latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def slo_ok(self) -> bool:
        """Completed (neither cancelled nor expired) within the deadline;
        a request without a deadline only needs to complete."""
        if self.finish_reason != "stop":
            return False
        if self.deadline is None:
            return True
        return self.finish_time is not None and \
            self.finish_time <= self.deadline


def reset_for_requeue(req: Request) -> Request:
    """Return a request to WAITING for re-admission on another replica
    after its owner died (runtime/cluster.py + runtime/transport.py,
    DESIGN.md §15).  Same recompute semantics as scheduler preemption:
    generated tokens fold into the context via ``resumed`` and prefill
    restarts from zero, so with greedy sampling the recovered output is
    token-identical to a never-failed run."""
    req.state = State.WAITING
    req.slot = None
    req.prefill_pos = 0
    req.prompt_hit_tokens = 0
    req.resumed = bool(req.output)
    req.requeues += 1
    return req


def fixed_trace(n_requests: int, input_len: int, output_len: int,
                vocab: int, seed: Seed = 0) -> List[Request]:
    rng = _rng(seed)
    return [Request(rid=i,
                    prompt=[rng.randrange(vocab) for _ in range(input_len)],
                    max_new_tokens=output_len)
            for i in range(n_requests)]


def repetitive_trace(n_requests: int, motif_len: int, repeats: int,
                     output_len: int, vocab: int,
                     seed: Seed = 0) -> List[Request]:
    """Prompts built by repeating a per-request random motif — the
    prompt-lookup-friendly structure (code, templated text) where n-gram
    drafting earns its acceptance rate."""
    rng = _rng(seed)
    reqs = []
    for i in range(n_requests):
        motif = [rng.randrange(vocab) for _ in range(motif_len)]
        reqs.append(Request(rid=i, prompt=motif * repeats,
                            max_new_tokens=output_len))
    return reqs


# --------------------------------------------------------------------------
# arrival processes (online serving, runtime/server.py / DESIGN.md §10):
# stamp ``Request.arrival_time`` on an existing trace.  All are driven by an
# explicit seed/Random, so a trace + arrival process is fully reproducible.
# --------------------------------------------------------------------------

def replay_arrivals(reqs: List[Request],
                    times: List[float]) -> List[Request]:
    """Replay recorded arrival times (e.g. from a production trace dump).
    Requests are re-ordered by arrival time (stable for ties)."""
    if len(times) != len(reqs):
        raise ValueError(f"{len(times)} arrival times for {len(reqs)} "
                         f"requests")
    for r, t in zip(reqs, times):
        r.arrival_time = float(t)
    reqs.sort(key=lambda r: (r.arrival_time, r.rid))
    return reqs


def poisson_arrivals(reqs: List[Request], rate: float,
                     seed: Seed = 0, start: float = 0.0) -> List[Request]:
    """Poisson process: i.i.d. exponential inter-arrival gaps with mean
    ``1/rate`` (arrivals per virtual-time unit)."""
    rng = _rng(seed)
    t = start
    times = []
    for _ in reqs:
        t += rng.expovariate(rate)
        times.append(t)
    return replay_arrivals(reqs, times)


def bursty_arrivals(reqs: List[Request], rate: float, burst: int,
                    off_time: float, seed: Seed = 0,
                    start: float = 0.0) -> List[Request]:
    """On-off (bursty) process: bursts of ``burst`` requests arriving at
    ``rate`` (Poisson within the burst) separated by idle gaps of mean
    ``off_time`` — the flash-crowd pattern that stresses admission and
    makes per-iteration token counts (and thus the weave rate) swing."""
    rng = _rng(seed)
    t = start
    times = []
    for i in range(len(reqs)):
        if i and i % max(burst, 1) == 0:
            t += rng.expovariate(1.0 / off_time) if off_time > 0 else 0.0
        t += rng.expovariate(rate)
        times.append(t)
    return replay_arrivals(reqs, times)


def grouped_prefix_trace(n_groups: int, per_group: int, prefix_len: int,
                         tail_len: int, output_len: int, vocab: int,
                         seed: Seed = 0) -> List[Request]:
    """Groups of requests sharing a long common prompt prefix (system
    prompt / few-shot header) with private tails — the workload where
    prefix-affinity routing (runtime/cluster.py, DESIGN.md §11) keeps a
    group's traffic on the replica whose prefix cache already holds its
    blocks.  Requests are interleaved round-robin across groups so a
    position-based router would scatter every group over the fleet."""
    rng = _rng(seed)
    prefixes = [[rng.randrange(vocab) for _ in range(prefix_len)]
                for _ in range(n_groups)]
    reqs = []
    for i in range(per_group):
        for g in range(n_groups):
            tail = [rng.randrange(vocab) for _ in range(tail_len)]
            reqs.append(Request(rid=i * n_groups + g,
                                prompt=prefixes[g] + tail,
                                max_new_tokens=output_len))
    return reqs


def sharegpt_like_trace(n_requests: int, vocab: int, seed: Seed = 0,
                        mean_in: int = 161, mean_out: int = 338,
                        max_in: int = 1024, max_out: int = 1024
                        ) -> List[Request]:
    """Log-normal-ish length mix matching the ShareGPT summary stats the
    serving literature reports (mean input ~161, mean output ~338)."""
    rng = _rng(seed)
    reqs = []
    for i in range(n_requests):
        ilen = min(max_in, max(1, int(rng.lognormvariate(4.4, 1.0))))
        olen = min(max_out, max(1, int(rng.lognormvariate(5.2, 0.9))))
        reqs.append(Request(
            rid=i, prompt=[rng.randrange(vocab) for _ in range(ilen)],
            max_new_tokens=olen))
    return reqs
