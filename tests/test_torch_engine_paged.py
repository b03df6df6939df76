"""The PyTorch port's engine over the paged pool and with packed hybrid
batching, against the JAX reference engine.

Seeded traces drawn by test_differential's generator (seeds 1000 +
trial, prompts sharing random prefixes, cancellations at a request's
progress point) with speculative decoding off replay through the
reference ``Engine`` and the port's ``Engine(device="cpu")`` with the same
tiny model, in four columns: two-dispatch over the paged pool, packed
over the paged pool, packed over legacy slots, and packed over the paged
pool with an all-``fused`` overlap plan read through the port's
``load_policy``.  Greedy tokens must be identical, cancellations go
through ``Engine.abort``, and after each trace the port's pool is empty:
no table left, no reference held.  One more trace starves the pool so
that both engines preempt.

The reference runs as its own tests run it (``tiny_pcfg``); the port
with ``attn_impl="pallas"`` and ``use_pallas_norm=True``, so its packed
steps take the segment form with K3's wrapper (its plain version on the
CPU).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.runtime.requests import Request as JRequest
from repro.runtime.requests import State as JState

from repro_torch.configs import base as tbase
from repro_torch.models.build import build_model as t_build_model
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.requests import Request as TRequest
from repro_torch.runtime.requests import State as TState
from repro_torch.weights import from_jax_params

N_TRACES = 25
SCHED = dict(max_batch=3, chunk_tokens=48, max_len=128, prefill_bucket=16,
             block_size=16)
COLUMNS = {"two_paged": dict(paged=True, packed=False),
           "packed_paged": dict(paged=True, packed=True),
           "packed": dict(paged=False, packed=True),
           "packed_fused": dict(paged=True, packed=True, plan="fused")}


@pytest.fixture(scope="module")
def fused_plan_path(tmp_path_factory):
    """test_differential's all-``fused`` plan: method fused (K1's ring
    mode and the weave, half the budget) at every tp=1 site and bucket."""
    from repro.core.policy import PLAN_VERSION, SITES, PlanEntry, TunedPolicy
    from repro.core.splitting import DEFAULT_BUCKET_EDGES, token_bucket
    buckets = {token_bucket(lo, DEFAULT_BUCKET_EDGES)
               for lo in DEFAULT_BUCKET_EDGES} | {token_bucket(0)}
    entries = tuple(PlanEntry(site=site, bucket=b, tp=1, family="dense",
                              method="fused", split_frac=0.5, budget=0.5)
                    for site in SITES for b in sorted(buckets))
    plan = TunedPolicy(plan_id=424242, version=PLAN_VERSION,
                       bucket_edges=DEFAULT_BUCKET_EDGES, entries=entries)
    path = tmp_path_factory.mktemp("plans") / "all_fused.json"
    plan.save(str(path))
    return str(path)


@pytest.fixture(scope="module")
def torch_model(tiny_model, tiny_cfg, tiny_pcfg):
    _, _, params = tiny_model
    cfg = tbase.ModelConfig(**dataclasses.asdict(tiny_cfg))
    pcfg = dataclasses.replace(
        tbase.ParallelConfig(**{f.name: getattr(tiny_pcfg, f.name)
                                for f in dataclasses.fields(tiny_pcfg)}),
        attn_impl="pallas", use_pallas_norm=True)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), cfg, pcfg,
                              device="cpu")
    return t_build_model(cfg, pcfg), tparams


def _gen_trace(rng: np.random.RandomState):
    """test_differential's generator, verbatim: prompts, output budgets,
    a spec-decode gamma (drawn, then forced to 0 by the caller) and
    cancellation triggers rid -> n_tokens emitted."""
    n_req = int(rng.randint(2, 6))
    shared = list(rng.randint(0, 128, size=int(rng.randint(8, 24)))) \
        if rng.rand() < 0.5 else []
    prompts = []
    for _ in range(n_req):
        tail = list(rng.randint(0, 128, size=int(rng.randint(1, 40))))
        use_shared = shared and rng.rand() < 0.6
        prompts.append((shared + tail if use_shared else tail)[:96])
    outs = [int(rng.randint(2, 7)) for _ in range(n_req)]
    gamma = int(rng.choice([0, 0, 2, 3]))
    cancels = {}
    if rng.rand() < 0.4:
        rid = int(rng.randint(0, n_req))
        cancels[rid] = int(rng.randint(0, outs[rid]))
    return prompts, outs, gamma, cancels


def _drive(eng, request_cls, done_state, prompts, outs, cancels,
           max_steps=500):
    """Step an engine, applying each cancellation once its request has
    emitted its trigger's count of tokens.  Returns ``{rid: output}`` of
    the requests not cancelled."""
    reqs = [request_cls(rid=i, prompt=[int(t) for t in p], max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, outs))]
    for r in reqs:
        eng.add_request(r)
    pending = dict(cancels)
    for _ in range(max_steps):
        for rid, trigger in list(pending.items()):
            r = reqs[rid]
            if r.state != done_state and len(r.output) >= trigger:
                eng.abort(r)
                del pending[rid]
        if not eng.step():
            break
    assert eng.sched.all_done(), "trace did not drain"
    return {r.rid: r.output for r in reqs if r.rid not in cancels}


def _drained(eng):
    mgr = eng.block_mgr
    if mgr is None:
        return
    assert not mgr.tables, f"unreleased block tables: {list(mgr.tables)}"
    leaked = [b for b in range(mgr.alloc.num_blocks) if mgr.alloc.ref[b]]
    assert not leaked, f"blocks with nonzero refcount: {leaked}"


def _run_both(builder, torch_model, plan_path, prompts, outs, cancels,
              **cfg):
    plan = cfg.pop("plan", None)
    if plan:
        cfg["plan_path"] = plan_path
    cfg = {**SCHED, **cfg}
    jeng = builder(**cfg)
    want = _drive(jeng, JRequest, JState.DONE, prompts, outs, cancels)
    api, tparams = torch_model
    teng = TEngine(api, tparams, tsched.SchedulerConfig(**cfg), device="cpu")
    got = _drive(teng, TRequest, TState.DONE, prompts, outs, cancels)
    _drained(teng)
    return jeng, teng, got, want


@pytest.mark.parametrize("trial", range(N_TRACES))
def test_paged_and_packed_engines_token_identical(trial, tiny_engine_builder,
                                                  torch_model,
                                                  fused_plan_path):
    prompts, outs, _, cancels = _gen_trace(np.random.RandomState(1000 + trial))
    for name, cfg in COLUMNS.items():
        jeng, teng, got, want = _run_both(tiny_engine_builder, torch_model,
                                          fused_plan_path, prompts, outs,
                                          cancels, **cfg)
        assert got == want, (trial, name, cancels, got, want)
        for rid, out in got.items():
            assert len(out) == outs[rid]
        st, jst = teng.stats, jeng.stats
        assert (st.forwards, st.weave_forwards, st.cancelled) == \
            (jst.forwards, jst.weave_forwards, jst.cancelled), name
        if teng.block_mgr is not None:
            assert dataclasses.asdict(teng.block_mgr.stats) == \
                dataclasses.asdict(jeng.block_mgr.stats), name
        if name == "packed_fused":
            fused = teng.metrics.get("engine/site_fused", site="packed")
            assert fused is not None and fused.value == st.forwards


@pytest.mark.parametrize("packed", [False, True], ids=["two", "packed"])
def test_preemption_trace_token_identical(packed, tiny_engine_builder,
                                          torch_model, fused_plan_path):
    """A pool of 9 blocks of 16 for 4 slots and 4 requests of 30 prompt
    tokens and 12 new ones: both engines preempt and recompute, with the
    same tokens and the same paging counters."""
    rng = np.random.RandomState(77)
    prompts = [list(rng.randint(0, 128, 30)) for _ in range(4)]
    outs = [12] * 4
    jeng, teng, got, want = _run_both(
        tiny_engine_builder, torch_model, fused_plan_path, prompts, outs, {},
        paged=True, packed=packed, max_batch=4, num_blocks=9,
        prefix_caching=False)
    assert got == want
    assert teng.block_mgr.stats.preemptions > 0
    assert dataclasses.asdict(teng.block_mgr.stats) == \
        dataclasses.asdict(jeng.block_mgr.stats)


def test_traces_exercise_prefix_hits_weave_and_cancels():
    """The 25 traces are not vacuous: some share prefixes, some cancel."""
    traces = [_gen_trace(np.random.RandomState(1000 + t))
              for t in range(N_TRACES)]
    assert sum(bool(c) for *_, c in traces) >= 5
    assert sum(len(p) for p, *_ in traces) > 50
