"""The port's engine serving the MoE family against the JAX reference
engine, column for column, in float32 on the CPU.

MoE tokens depend on the batch by design: each expert takes at most
max(ceil(T·k/E·capacity_factor), 4) assignments of a forward's split, T
counting its padding rows, and drops the rest in token order.  So the
reference's own columns (two-dispatch over slots or the pool, packed over
the pool or slots, speculative) disagree with each other at the configs'
capacity_factor 1.25, and the port is held to the reference's *same*
column: tokens, forward and weave counts, paging and ``spec/*`` counters
equal, the pool drained.  At capacity_factor 8.0 nothing drops and every
column gives the same tokens.

Reduced mixtral-8x22b (``ffn``) and olmoe-1b-7b (``expert``), every weight
perturbed by 0.05·N(0, 1), replay 4 seeded traces of test_differential's
generator (prompts ending in a copy of their first 8 tokens, so that the
n-gram draft proposes); the port counts its dropped assignments (some
must drop at 1.25, none at 8.0) and checks on every packed step that each
split's padding rows come after all of its real rows, where a padding
row's routing cannot displace a real token.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.build import build_model as j_build_model
from repro.runtime.engine import Engine as JEngine
from repro.runtime.requests import Request as JRequest
from repro.runtime.requests import State as JState
from repro.runtime.scheduler import SchedulerConfig as JSched

from repro_torch.layers import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.build import build_model as t_build_model
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.requests import Request as TRequest
from repro_torch.runtime.requests import State as TState
from repro_torch.runtime.scheduler import SchedulerConfig as TSched
from repro.runtime import requests as JRQ
from repro.runtime import server as JSRV

from repro_torch.runtime import requests as TRQ
from repro_torch.runtime import server as TSRV
from test_torch_configs import MOE, model_pair
from test_torch_engine_paged import _drained, _drive, _gen_trace
from test_torch_server import ARRIVALS, _outcome, _reqs, _server

N_TRACES = 4
SCHED = dict(max_batch=3, chunk_tokens=48, max_len=128, prefill_bucket=48,
             block_size=16)
COLUMNS = {"two_legacy": dict(paged=False, packed=False),
           "two_paged": dict(paged=True, packed=False),
           "packed_paged": dict(paged=True, packed=True),
           "packed": dict(paged=False, packed=True),
           "spec_packed_paged": dict(paged=True, packed=True, spec_gamma=3)}
COUNTERS = ("verify_steps", "draft_proposed", "draft_accepted", "emitted")


def moe_trace(trial: int):
    prompts, outs, _, cancels = _gen_trace(np.random.RandomState(1000 + trial))
    return [p + p[:8] for p in prompts], outs, cancels


@pytest.fixture(scope="module")
def moe_models(mesh11):
    """(name, capacity_factor) -> (reference api, mesh and weights, port
    api and weights, the reference's jit caches by column); built once."""
    made = {}

    def get(name, cf):
        if (name, cf) not in made:
            cfg = dataclasses.replace(jconfigs.get_config(name).reduced(),
                                      capacity_factor=cf)
            _, jparams, jpcfg, tparams, tcfg, tpcfg = model_pair(cfg, seed=5)
            made[name, cf] = (j_build_model(cfg, jpcfg, tp=1), mesh11,
                              jparams, t_build_model(tcfg, tpcfg), tparams,
                              {})
        return made[name, cf]

    return get


class CountDrops:
    """Wrap the port's dispatch: count the assignments dropped by
    capacity (at tp=1 every assignment is local)."""

    def __init__(self, monkeypatch):
        self.dropped = self.assigned = 0
        orig = TM._capacity_dispatch

        def wrap(x, topi, topw, **kw):
            buf, slot, flat_w = orig(x, topi, topw, **kw)
            self.dropped += int((slot < 0).sum())
            self.assigned += slot.numel()
            return buf, slot, flat_w

        monkeypatch.setattr(TM, "_capacity_dispatch", wrap)


class PaddingLast:
    """The model API, checking on every packed step that each split's
    padding rows (slot -1) come after all of its real rows."""

    def __init__(self, api):
        self._api = api
        self.steps = self.padded = 0

    def __getattr__(self, name):
        return getattr(self._api, name)

    def packed_step(self, params, tokens, cache, positions, *, seg_slots,
                    **kw):
        api, t = self._api, tokens.shape[1]
        split = TT.weave_decision_info(1, t, tp=api.tp, pcfg=api.pcfg,
                                       packed=True,
                                       family=api.cfg.family).split
        cuts = [0, t] if split is None else [0, split[0], t]
        slots = seg_slots.cpu().numpy()
        for lo, hi in zip(cuts, cuts[1:]):
            pad = slots[lo:hi] < 0
            assert not (pad[:-1] & ~pad[1:]).any(), (lo, hi, slots.tolist())
        self.steps += 1
        self.padded += bool((slots < 0).any())
        return api.packed_step(params, tokens, cache, positions,
                               seg_slots=seg_slots, **kw)


def run_column(models, name, cf, column, trial, monkeypatch):
    """(reference's tokens and engine, port's tokens and engine, port's
    drop counter) for one trace in one column."""
    japi, mesh, jparams, tapi, tparams, jit_caches = models(name, cf)
    prompts, outs, cancels = moe_trace(trial)
    scfg = {**SCHED, **COLUMNS[column]}
    jeng = JEngine(japi, mesh, jparams, JSched(**scfg),
                   jit_cache=jit_caches.setdefault(column, {}))
    want = _drive(jeng, JRequest, JState.DONE, prompts, outs, cancels)
    drops = CountDrops(monkeypatch)
    teng = TEngine(tapi, tparams, TSched(**scfg), device="cpu")
    teng.api = PaddingLast(tapi)
    with torch.no_grad():
        got = _drive(teng, TRequest, TState.DONE, prompts, outs, cancels)
    _drained(teng)
    return want, jeng, got, teng, drops


@pytest.mark.parametrize("trial", range(N_TRACES))
@pytest.mark.parametrize("name", MOE)
def test_moe_engine_columns_match_reference(name, trial, moe_models,
                                            monkeypatch):
    """Each column's tokens and counters equal the reference's same
    column at capacity_factor 1.25, where assignments drop."""
    dropped = padded = 0
    for column in COLUMNS:
        want, jeng, got, teng, drops = run_column(
            moe_models, name, 1.25, column, trial, monkeypatch)
        assert got == want, (name, trial, column, got, want)
        st, jst = teng.stats, jeng.stats
        assert (st.forwards, st.weave_forwards, st.cancelled) == \
            (jst.forwards, jst.weave_forwards, jst.cancelled), column
        if teng.block_mgr is not None:
            assert dataclasses.asdict(teng.block_mgr.stats) == \
                dataclasses.asdict(jeng.block_mgr.stats), column
        if teng.spec_gamma:
            spec = [getattr(st.spec, c) for c in COUNTERS]
            assert spec == [getattr(jst.spec, c) for c in COUNTERS], column
            assert spec[0] > 0, "no verify window in the speculative column"
        if COLUMNS[column]["packed"]:
            assert teng.api.steps > 0, column
            padded += teng.api.padded
        dropped += drops.dropped
    assert dropped > 0, "capacity dropped nothing: the columns could agree"
    assert padded > 0, "no packed step carried padding"


@pytest.mark.parametrize("name", MOE)
def test_moe_engine_columns_agree_without_drops(name, moe_models,
                                                monkeypatch):
    """At capacity_factor 8.0 no assignment drops and every port column
    gives the reference's two-dispatch tokens."""
    ref, _, got, _, drops = run_column(moe_models, name, 8.0, "two_legacy",
                                       0, monkeypatch)
    assert got == ref
    _, _, _, tapi, tparams, _ = moe_models(name, 8.0)
    prompts, outs, cancels = moe_trace(0)
    for column, cfg in COLUMNS.items():
        drops = CountDrops(monkeypatch)
        teng = TEngine(tapi, tparams, TSched(**SCHED, **cfg), device="cpu")
        with torch.no_grad():
            got = _drive(teng, TRequest, TState.DONE, prompts, outs, cancels)
        assert got == ref, (name, column, got, ref)
        assert drops.dropped == 0 and drops.assigned > 0, column


@pytest.mark.parametrize("name", MOE)
def test_moe_online_server_matches_reference(name, moe_models):
    """Both packages' ``OnlineServer`` over the packed paged engine, 5
    requests arriving on the virtual clock: the streamed (rid, token, t),
    each request's times and the latency summary equal."""
    japi, mesh, jparams, tapi, tparams, jit_caches = moe_models(name, 1.25)
    scfg = {**SCHED, **COLUMNS["packed_paged"]}
    engines = {
        "j": lambda: JEngine(japi, mesh, jparams, JSched(**scfg),
                             jit_cache=jit_caches.setdefault(
                                 "packed_paged", {})),
        "t": lambda: TEngine(tapi, tparams, TSched(**scfg), device="cpu")}
    out = {}
    for key, rq, srv_mod in (("j", JRQ, JSRV), ("t", TRQ, TSRV)):
        ns = SimpleNamespace(rq=rq, srv=srv_mod)
        srv = _server(ns, engines[key](), srv_mod.ServerConfig(
            step_cost=srv_mod.StepCost(base=1.0, per_token=0.02)))
        for r in _reqs(ns, np.random.RandomState(8), 5, arrival=ARRIVALS):
            srv.submit(r)
        srv.run()
        out[key] = _outcome(srv)
    assert out["t"] == out["j"]
    assert len(out["t"]["completed"]) == 5
