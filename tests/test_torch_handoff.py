"""The PyTorch port's KV handoff against the JAX reference, on the CPU.

* Host side: ``BlockManager.export_blocks`` / ``import_blocks`` leave the
  port's manager in the reference's state after a seeded op sequence that
  exports, imports (prefix-shared and copied blocks) and rolls back imports
  a small pool cannot hold (``_mgr_state`` of tests/test_torch_paging.py).
* Device side: ``extract_blocks`` / ``select_payload`` / ``implant_blocks``
  on equal pools give bit-equal payloads, frames and pools at tp=1 and
  tp=2, in the stacked and the per-layer form; a reference payload
  implants into the port's pool bit for bit.
* Engines: a port prefill engine parks the reference's payload for the
  same request (pos and the tree exactly, k/v within 1e-5: the two models
  compute them in another order), in both forms and both dispatch
  schemes; a payload framed by either package and adopted by the other's
  decode engine gives the reference single engine's tokens; ``evacuate``
  returns the reference's requests in the reference's order, drains the
  pool, and a requeue onto a fresh engine gives the uninterrupted tokens,
  on both backends and both dispatch schemes; a parked request aborts.

The reference runs as its own tests run it (``tiny_pcfg``); the port with
``attn_impl="pallas"`` and ``use_pallas_norm=True`` (the wrappers' plain
versions on the CPU).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import paging as JPG
from repro.runtime import transport as JTR
from repro.runtime.engine import Engine as JEngine
from repro.runtime.requests import Request as JRequest
from repro.runtime.requests import State as JState
from repro.runtime.scheduler import SchedulerConfig as JSched

from repro_torch.configs import base as tbase
from repro_torch.models.build import build_model as t_build_model
from repro_torch.runtime import paging as TPG
from repro_torch.runtime import transport as TTR
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.requests import Request as TRequest
from repro_torch.runtime.requests import State as TState
from repro_torch.runtime.scheduler import SchedulerConfig as TSched
from repro_torch.weights import from_jax_params
from test_torch_paging import _mgr_state

# tests/test_cluster.py's engine
SCHED = dict(max_batch=4, chunk_tokens=48, max_len=96, prefill_bucket=16,
             paged=True, block_size=8)
_JIT = {}


@pytest.fixture(scope="module")
def models(model_builder, tiny_cfg, tiny_pcfg, mesh11):
    """Per ``scan_layers``: both packages' engine factories over the same
    tiny model (the reference's params stacked or per layer)."""
    out = {}
    for scan in (True, False):
        jpcfg = dataclasses.replace(tiny_pcfg, scan_layers=scan)
        japi, jparams = model_builder(tiny_cfg, jpcfg)
        cfg = tbase.ModelConfig(**dataclasses.asdict(tiny_cfg))
        pcfg = dataclasses.replace(
            tbase.ParallelConfig(**dataclasses.asdict(jpcfg)),
            attn_impl="pallas", use_pallas_norm=True)
        tapi = t_build_model(cfg, pcfg)
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                  pcfg, device="cpu")

        def j(scan=scan, japi=japi, jparams=jparams, **kw):
            kw = {**SCHED, **kw}
            cache = _JIT.setdefault((scan,) + tuple(sorted(kw.items())), {})
            return JEngine(japi, mesh11, jparams, JSched(**kw),
                           jit_cache=cache)

        def t(tapi=tapi, tparams=tparams, **kw):
            return TEngine(tapi, tparams, TSched(**{**SCHED, **kw}),
                           device="cpu")

        out[scan] = {
            "j": SimpleNamespace(engine=j, Request=JRequest, State=JState,
                                 tr=JTR),
            "t": SimpleNamespace(engine=t, Request=TRequest, State=TState,
                                 tr=TTR)}
    return out


def _drained(eng):
    mgr = eng.block_mgr
    assert not mgr.tables, list(mgr.tables)
    assert not any(mgr.alloc.ref), mgr.alloc.ref


def _prompts(n=3, seed=0):
    """Prompts sharing a two-block prefix (block_size 8), so an importer
    shares what an earlier adoption registered."""
    rng = np.random.RandomState(seed)
    shared = [int(t) for t in rng.randint(0, 128, 16)]
    return [shared + [int(t) for t in rng.randint(0, 128, 4 + 9 * i)]
            for i in range(n)]


# --------------------------------------------------------------------------
# host side: the block manager's migration half
# --------------------------------------------------------------------------

def test_export_import_scenario_matches_reference():
    """tests/test_cluster.py's export/import refcount scenario and its
    atomic rollback, on both packages' managers: same returns, same
    state after every call."""
    def run(PG):
        log = []
        src = PG.BlockManager(num_blocks=8, block_size=4,
                              max_blocks_per_req=4)
        ctx = list(range(10))
        log.append(src.allocate_prompt(1, ctx))
        src.register_filled(1, ctx, 8)
        log.append(src.export_blocks(1, 10))
        src.free_request(1)
        dst = PG.BlockManager(num_blocks=8, block_size=4,
                              max_blocks_per_req=4)
        log.append(dst.import_blocks(1, ctx, 10))
        dst.register_filled(1, ctx, 10)
        log.append(dst.import_blocks(2, list(range(8)) + [99, 98], 10))
        log.append(_mgr_state(dst))
        dst.free_request(1)
        dst.free_request(2)
        tiny = PG.BlockManager(num_blocks=3, block_size=4,
                               max_blocks_per_req=4)
        log.append(tiny.import_blocks(1, list(range(12)), 12))
        return log + [_mgr_state(m) for m in (src, dst, tiny)]

    want, got = run(JPG), run(TPG)
    assert got == want
    assert got[2][1] == [0, 1, 2]               # cold: all copied
    assert got[3][1] == [2]                     # 2 full-block hits shared
    assert got[5] is None                       # rolled back


@pytest.mark.parametrize("seed", range(3))
def test_block_manager_migrations_match_reference(seed):
    """Seeded admit / register / grow / export+free / import / free on a
    pool small enough that imports roll back and the LRU evicts; the
    state equals the reference's after every operation."""
    rng = np.random.RandomState(seed)
    bs, nb, maxb = 4, 16, 10
    shared = [int(t) for t in rng.randint(0, 50, 12)]
    mgrs = [JPG.BlockManager(nb, bs, maxb), TPG.BlockManager(nb, bs, maxb)]
    live, ctx, exported, next_rid, rolled_back = [], {}, [], 0, 0
    for _ in range(250):
        op = rng.randint(6)
        if op == 0 or not live:                       # admit
            tail = [int(t) for t in rng.randint(0, 50, rng.randint(1, 14))]
            c = (shared[:rng.randint(0, 13)] + tail)[:maxb * bs - 8]
            hits = {m.allocate_prompt(next_rid, c) for m in mgrs}
            assert len(hits) == 1
            if hits.pop() >= 0:
                live.append(next_rid)
                ctx[next_rid] = c
                for m in mgrs:
                    m.register_filled(next_rid, c, len(c))
            next_rid += 1
        elif op == 1:                                 # decode growth
            rid = live[rng.randint(len(live))]
            oks = {m.ensure_writable(rid, len(ctx[rid])) for m in mgrs}
            assert len(oks) == 1
            if oks.pop():
                ctx[rid].append(int(rng.randint(50)))
                for m in mgrs:
                    m.register_filled(rid, ctx[rid], len(ctx[rid]))
        elif op == 2:                                 # export, then release
            rid = live.pop(rng.randint(len(live)))
            n = int(rng.randint(1, len(ctx[rid]) + 1))
            blocks = [m.export_blocks(rid, n) for m in mgrs]
            assert blocks[0] == blocks[1]
            for m in mgrs:
                m.free_request(rid)
            exported.append(ctx[rid][:n])
        elif op in (3, 4) and exported:               # import
            c = exported[rng.randint(len(exported))]
            n = int(rng.randint(1, len(c) + 1))
            got = [m.import_blocks(next_rid, c[:n], n) for m in mgrs]
            assert got[0] == got[1]
            rolled_back += got[0] is None
            if got[0] is not None:
                live.append(next_rid)
                ctx[next_rid] = list(c[:n])
                for m in mgrs:
                    m.register_filled(next_rid, c, n)
            next_rid += 1
        elif op == 5:                                 # finish
            rid = live.pop(rng.randint(len(live)))
            for m in mgrs:
                m.free_request(rid)
        if rng.rand() < 0.3:
            assert mgrs[0].take_pending_resets() == \
                mgrs[1].take_pending_resets()
        assert _mgr_state(mgrs[1]) == _mgr_state(mgrs[0])
    st = mgrs[1].stats
    assert st.migrations_out and st.migrations_in, st
    assert st.import_shared_blocks and st.import_copied_blocks, st
    assert rolled_back and st.evictions, (rolled_back, st)


# --------------------------------------------------------------------------
# device side: extract / select / implant on equal pools
# --------------------------------------------------------------------------

NB, BS, DH = 9, 4, 3


def _np_pool(rng, tp, kv, nl):
    return {"k": rng.randn(nl, NB, BS, tp * kv, DH).astype(np.float32),
            "v": rng.randn(nl, NB, BS, tp * kv, DH).astype(np.float32),
            "pos": rng.randint(-1, 40, (nl, NB, BS)).astype(np.int32)}


def _ranks(a, tp):
    """(..., tp·kv, dh) -> (tp, ..., kv, dh)."""
    a = a.reshape(*a.shape[:-2], tp, -1, a.shape[-1])
    return np.ascontiguousarray(np.moveaxis(a, -3, 0))


def _torch_pool(np_pool, tp):
    return [{"k": torch.from_numpy(_ranks(np_pool["k"][i], tp)),
             "v": torch.from_numpy(_ranks(np_pool["v"][i], tp)),
             "pos": torch.from_numpy(np_pool["pos"][i].copy())}
            for i in range(len(np_pool["pos"]))]


def _jax_pool(np_pool, stacked):
    if stacked:
        return {n: jnp.asarray(a) for n, a in np_pool.items()}
    return {f"layer_{i}": {n: jnp.asarray(a[i]) for n, a in np_pool.items()}
            for i in range(len(np_pool["pos"]))}


def _pool_as_np(tpool, tp):
    """The port's pool in the reference's stacked layout."""
    def heads(a):                 # (tp, nb, bs, kv, dh) -> (nb, bs, tp·kv, dh)
        return np.moveaxis(a, 0, -3).reshape(*a.shape[1:-2], -1, a.shape[-1])
    return {n: np.stack([heads(layer[n].numpy()) if n != "pos"
                         else layer[n].numpy() for layer in tpool])
            for n in ("k", "v", "pos")}


def _jax_as_np(jpool, stacked):
    if stacked:
        return {n: np.asarray(a) for n, a in jpool.items()}
    return {n: np.stack([np.asarray(jpool[f"layer_{i}"][n])
                         for i in range(len(jpool))])
            for n in ("k", "v", "pos")}


def assert_tree_equal(got, want):
    """Same keys in the same order, same dtype and shape, same bytes (a
    torch tensor against a numpy array)."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_tree_equal(got[k], want[k])
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else got
    assert g.dtype == want.dtype and g.shape == want.shape
    assert g.tobytes() == want.tobytes()


@pytest.mark.parametrize("stacked,nl", [(True, 2), (False, 2), (False, 11)],
                         ids=["stacked", "per_layer", "per_layer_11"])
@pytest.mark.parametrize("tp,kv", [(1, 2), (2, 1)])
def test_extract_select_implant_bit_equal(tp, kv, stacked, nl):
    """Payloads, frames and pools equal the reference's; 11 layers pin the
    per-layer keys' order (``layer_10`` before ``layer_2``, as
    ``jax.device_get`` returns them)."""
    rng = np.random.RandomState(tp)
    np_pool = _np_pool(rng, tp, kv, nl)
    ids = [5, 0, 7]
    want = jax.device_get(JPG.extract_blocks(_jax_pool(np_pool, stacked),
                                             ids))
    got = TPG.extract_blocks(_torch_pool(np_pool, tp), ids, stacked=stacked)
    assert_tree_equal(got, want)
    assert TPG.payload_nbytes(got) == JPG.payload_nbytes(want)
    assert TTR.encode_frame("handoff", got) == \
        JTR.encode_frame("handoff", want)

    sel = [2, 0]
    want_sub = JPG.select_payload(want, sel)
    got_sub = TPG.select_payload(got, sel)
    assert_tree_equal(got_sub, want_sub)

    # implant into another pool (a destination that is also extracted
    # above, and the pos cells of both), from the port's payload and from
    # the reference's numpy payload
    dst = [3, 5]
    other = _np_pool(np.random.RandomState(10 + tp), tp, kv, nl)
    jpool = JPG.implant_blocks(_jax_pool(other, stacked), want_sub, dst)
    for payload in (got_sub, want_sub):
        tpool = TPG.implant_blocks(_torch_pool(other, tp), payload, dst)
        assert_tree_equal(_pool_as_np(tpool, tp), _jax_as_np(jpool, stacked))


def test_payload_stacked_follows_the_reference_pool(tiny_pcfg):
    """Stacked exactly when the reference's pool is: ``scan_layers`` and
    uniform layer kinds (gemma3's local/global layers are not)."""
    from repro.configs import get_config as j_get_config
    from repro.models.transformer import use_scan
    from repro_torch.configs import get_config
    for name in ("llama3.3-70b", "gemma3-1b"):
        for scan in (True, False):
            pcfg = dataclasses.replace(tiny_pcfg, scan_layers=scan)
            assert TPG.payload_stacked(get_config(name), pcfg) == \
                use_scan(j_get_config(name), pcfg)
    assert not TPG.payload_stacked(get_config("gemma3-1b"),
                                   tbase.ParallelConfig())


# --------------------------------------------------------------------------
# engines: park, adopt across packages, evacuate, abort
# --------------------------------------------------------------------------

def _park(ns, prompts, **kw):
    eng = ns.engine(**kw)
    reqs = [ns.Request(rid=i, prompt=list(p), max_new_tokens=6,
                       handoff_after_prefill=True)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run()
    hs = eng.take_handoffs()
    assert [h.req for h in hs] == reqs
    assert all(r.state == ns.State.DECODE and len(r.output) == 1
               for r in reqs)
    return eng, hs


@pytest.mark.parametrize("packed", [False, True], ids=["two", "packed"])
@pytest.mark.parametrize("scan", [True, False], ids=["stacked", "per_layer"])
def test_parked_payload_matches_reference(models, scan, packed):
    prompts = _prompts(3)
    jeng, jh = _park(models[scan]["j"], prompts, packed=packed)
    teng, th = _park(models[scan]["t"], prompts, packed=packed)
    _drained(teng)
    for a, b in zip(th, jh):
        assert (a.n_tokens, a.req.output) == (b.n_tokens, b.req.output)
        want = jax.device_get(b.payload)
        assert list(a.payload) == list(want)
        assert ("k" in a.payload) == scan
        layers = ([(a.payload, want)] if scan else
                  [(a.payload[n], want[n]) for n in want])
        for got_l, want_l in layers:
            assert list(got_l) == ["k", "pos", "v"]
            np.testing.assert_array_equal(got_l["pos"].numpy(),
                                          want_l["pos"])
            for n in ("k", "v"):
                assert got_l[n].dtype == torch.float32
                # within 1e-5: the port's model computes them in
                # another order
                np.testing.assert_allclose(got_l[n].numpy(), want_l[n],
                                           rtol=0, atol=1e-5)
        assert TPG.payload_nbytes(a.payload) == JPG.payload_nbytes(want)
        assert len(TTR.encode_frame("handoff", TTR.handoff_to_wire(a))) == \
            len(JTR.encode_frame("handoff", JTR.handoff_to_wire(
                JTR.Handoff(req=b.req, n_tokens=b.n_tokens, payload=want))))


def _single(ns, prompts):
    eng = ns.engine()
    for i, p in enumerate(prompts):
        eng.add_request(ns.Request(rid=i, prompt=list(p), max_new_tokens=6))
    return {r.rid: list(map(int, r.output)) for r in eng.run()}


@pytest.mark.parametrize("src,dst", [("j", "t"), ("t", "j")])
@pytest.mark.parametrize("scan", [True, False], ids=["stacked", "per_layer"])
def test_payload_adopted_across_packages(models, scan, src, dst):
    """Each handoff framed by one package, decoded by the other and
    adopted by its decode engine: the reference single engine's tokens;
    the importer shares the prefix blocks an earlier adoption
    registered."""
    prompts = _prompts(3, seed=1)
    want = _single(models[scan]["j"], prompts)
    _, hs = _park(models[scan][src], prompts)
    S, D = models[scan][src], models[scan][dst]
    deng = D.engine()
    for h in hs:
        kind, body = D.tr.decode_frame(S.tr.encode_frame(
            "handoff", S.tr.handoff_to_wire(h)))
        got = D.tr.handoff_from_wire(body)
        assert deng.adopt_request(got.req, got.n_tokens, got.payload)
    done = deng.run()
    assert {r.rid: list(map(int, r.output)) for r in done} == want
    assert all(r.migrations == 1 for r in done)
    st = deng.block_mgr.stats
    assert st.migrations_in == 3 and st.import_shared_blocks == 4, st
    _drained(deng)


@pytest.mark.parametrize("paged,packed", [(True, False), (True, True),
                                          (False, False), (False, True)],
                         ids=["two_paged", "packed_paged", "two_legacy",
                              "packed_legacy"])
def test_evacuate_then_requeue_matches_uninterrupted(models, paged, packed):
    """Evacuate mid-run (one request parked for handoff on the pool, some
    prefilling, some decoding): the reference's requests in its order,
    each reset for a recompute requeue; the pool drained (slots: every
    cell's pos -1); a fresh engine then gives the uninterrupted tokens."""
    prompts = _prompts(3, seed=2) + [list(range(1, 70))]
    want = _single(models[True]["t"], prompts)
    kw = dict(paged=paged, packed=packed, max_batch=3)
    evac = {}
    for name in ("j", "t"):
        ns = models[True][name]
        eng = ns.engine(**kw)
        reqs = [ns.Request(rid=i, prompt=list(p), max_new_tokens=6,
                           handoff_after_prefill=paged and i == 0)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.add_request(r)
        for _ in range(3):
            assert eng.step()
        out = eng.evacuate()
        evac[name] = [(r.rid, list(map(int, r.output)), r.resumed,
                       r.requeues, r.state.value, r.slot, r.prefill_pos)
                      for r in out]
        finished = {r.rid: list(map(int, r.output))
                    for r in eng.sched.finished}
    assert evac["t"] == evac["j"]
    assert any(r[1] for r in evac["t"]) and any(not r[1]
                                                for r in evac["t"])
    assert not eng.handoff_ready and not eng.sched.waiting
    assert all(r is None for r in eng.sched.active)
    if paged:
        _drained(eng)
        assert evac["t"][0][0] == 0                # the parked one first
    else:
        assert all(bool((layer["pos"] == -1).all()) for layer in eng.cache)
    fresh = models[True]["t"].engine(**kw)
    for r in out:
        r.handoff_after_prefill = False
        fresh.add_request(r)
    done = {r.rid: list(map(int, r.output)) for r in fresh.run()}
    assert {**finished, **done} == want
    if paged:
        _drained(fresh)


def test_abort_parked_request(models):
    ns = models[True]["t"]
    eng = ns.engine()
    req = ns.Request(rid=0, prompt=list(range(1, 21)), max_new_tokens=4,
                     handoff_after_prefill=True)
    other = ns.Request(rid=1, prompt=list(range(3, 30)), max_new_tokens=4,
                       handoff_after_prefill=True)
    eng.add_request(req)
    eng.add_request(other)
    eng.run()
    assert len(eng.handoff_ready) == 2 and req.slot is None
    assert eng.abort(req)
    assert req.state == TState.DONE and req.finish_reason == "cancelled"
    assert [h.req for h in eng.handoff_ready] == [other]
    assert eng.stats.cancelled == 1 and not eng.abort(req)
    _drained(eng)


def test_adopt_returns_false_without_slot_or_blocks(models):
    """tests/test_cluster.py's refusals: no free slot, a pool too small;
    nothing half done either way."""
    ns = models[True]["t"]
    _, (h,) = _park(ns, [list(range(20))])
    dst = ns.engine(max_batch=2)
    blockers = [TRequest(rid=i, prompt=list(range(1, 12)),
                         max_new_tokens=64) for i in (1, 2)]
    for b in blockers:
        dst.add_request(b)
    while not all(b.state == TState.DECODE for b in blockers):
        dst.step()
    assert not dst.adopt_request(h.req, h.n_tokens, h.payload)
    assert h.req.rid not in dst.block_mgr.tables
    tiny_pool = ns.engine(max_batch=2, num_blocks=3)
    assert not tiny_pool.adopt_request(h.req, h.n_tokens, h.payload)
    _drained(tiny_pool)
    legacy = ns.engine(paged=False)
    with pytest.raises(ValueError, match="paged"):
        legacy.adopt_request(h.req, h.n_tokens, h.payload)
