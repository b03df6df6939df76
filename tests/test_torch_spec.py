"""The PyTorch port's speculative decoding (``runtime/spec.py``, the
engine's verify windows, ``verify_step``) against the JAX reference, in
float32 on the CPU with the tiny dense model and the same weights.

The differential traces of test_differential (seeds 1000 + trial) whose
drawn gamma is above 0 replay through the reference ``Engine`` and the
port's ``Engine(device="cpu")`` in six columns: two-dispatch over the
paged pool, packed over the paged pool, two-dispatch over legacy slots,
packed over legacy slots, and packed over the pool and two-dispatch over
legacy slots with the all-fused overlap plan.  Greedy tokens and the ``spec/*`` counters must be equal,
cancellations go through ``Engine.abort``, and the pool drains.

The reference runs ``tiny_pcfg``; the port ``attn_impl="pallas"`` and
``use_pallas_norm=True``, so its kernel wrappers are on the path and take
their plain versions on CPU tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.models import transformer as JT
from repro.models.build import build_model as j_build_model
from repro.runtime import spec as JSP
from repro.runtime.engine import Engine as JEngine
from repro.runtime.scheduler import SchedulerConfig as JSched

from repro_torch.configs import base as tbase
from repro_torch.models import transformer as TT
from repro_torch.models.build import build_model as t_build_model
from repro_torch.runtime import spec as TSP
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.requests import Request as TRequest
from repro_torch.runtime.requests import State as TState
from repro_torch.runtime.scheduler import SchedulerConfig as TSched
from repro_torch.weights import from_jax_params
from test_torch_engine_paged import (COLUMNS, N_TRACES, SCHED, _gen_trace,
                                     _run_both, fused_plan_path, torch_model)
from test_torch_model import (_close, _paged_state, _pools_close,
                              _random_cache, _shard_run, _torch_cache,
                              _torch_pool, both)

SPEC_TRIALS = [t for t in range(N_TRACES)
               if _gen_trace(np.random.RandomState(1000 + t))[2] > 0]
SPEC_COLUMNS = {**COLUMNS, "two_legacy": dict(paged=False, packed=False)}
COUNTERS = ("verify_steps", "draft_proposed", "draft_accepted", "emitted")

__all__ = ["fused_plan_path", "torch_model", "both"]   # fixtures


def test_spec_trials_are_the_gamma_traces():
    """17 of the 25 differential traces draw gamma 2 or 3."""
    gammas = [_gen_trace(np.random.RandomState(1000 + t))[2]
              for t in SPEC_TRIALS]
    assert len(SPEC_TRIALS) == 17 and set(gammas) == {2, 3}


@pytest.mark.parametrize("trial", SPEC_TRIALS)
def test_spec_traces_token_identical(trial, tiny_engine_builder, torch_model,
                                     fused_plan_path):
    prompts, outs, gamma, cancels = _gen_trace(
        np.random.RandomState(1000 + trial))
    for name, cfg in SPEC_COLUMNS.items():
        jeng, teng, got, want = _run_both(
            tiny_engine_builder, torch_model, fused_plan_path, prompts, outs,
            cancels, spec_gamma=gamma, **cfg)
        assert got == want, (trial, name, gamma, cancels, got, want)
        for rid, out in got.items():
            assert len(out) == outs[rid]
        st, jst = teng.stats, jeng.stats
        assert [getattr(st.spec, c) for c in COUNTERS] == \
            [getattr(jst.spec, c) for c in COUNTERS], name
        assert (st.forwards, st.weave_forwards, st.decode_tokens,
                st.cancelled) == (jst.forwards, jst.weave_forwards,
                                  jst.decode_tokens, jst.cancelled), name
        if teng.block_mgr is not None:
            assert dataclasses.asdict(teng.block_mgr.stats) == \
                dataclasses.asdict(jeng.block_mgr.stats), name


def test_spec_traces_verify_drafts(torch_model):
    """The traces are not vacuous for speculation: served by the port's
    two-dispatch paged column, they verify windows and accept some drafts
    and reject others."""
    api, tparams = torch_model
    st = {c: 0 for c in COUNTERS}
    for trial in SPEC_TRIALS:
        prompts, outs, gamma, _ = _gen_trace(
            np.random.RandomState(1000 + trial))
        eng = TEngine(api, tparams, TSched(**SCHED, paged=True,
                                           spec_gamma=gamma), device="cpu")
        for i, (p, n) in enumerate(zip(prompts, outs)):
            eng.add_request(TRequest(rid=i, prompt=[int(t) for t in p],
                                     max_new_tokens=n))
        eng.run()
        for c in COUNTERS:
            st[c] += getattr(eng.stats.spec, c)
    assert st["verify_steps"] > 0
    assert 0 < st["draft_accepted"] < st["draft_proposed"]


# --------------------------------------------------------------------------
# verification and drafts against the reference
# --------------------------------------------------------------------------

def _on_ranks(logits: np.ndarray, r: int) -> torch.Tensor:
    """(B, S, V) full-vocab logits -> (R, B, S, V/R) rank shards."""
    b, s, v = logits.shape
    return torch.from_numpy(
        logits.reshape(b, s, r, v // r).transpose(2, 0, 1, 3).copy())


def test_verify_greedy_matches_reference(mesh11):
    """Integer logits (ties everywhere, broken toward the smallest id),
    a padded vocabulary tail holding the largest logits, drafts with -1
    holes; the port at R = 1, 2, 4 equals the reference."""
    vocab, v_pad, gamma, b = 30, 32, 3, 64
    rng = np.random.RandomState(5)
    logits = rng.randint(0, 4, (b, gamma + 1, v_pad)).astype(np.float32)
    logits[..., vocab:] = 9.0                    # never chosen
    draft = rng.randint(-1, vocab, (b, gamma)).astype(np.int32)
    tgt = np.argmax(logits[..., :vocab], axis=-1)
    for i in range(0, b, 2):                     # accept a prefix of 0..3
        n = (i // 2) % (gamma + 1)
        draft[i, :n] = tgt[i, :n]

    def fn(lg, dr):
        return JSP.verify_greedy(lg, dr, vocab_size=vocab, tp_axis="model")

    jn, je = _shard_run(mesh11, fn, jnp.asarray(logits), jnp.asarray(draft))
    assert len(set(np.asarray(jn).tolist())) == gamma + 1
    for r in (1, 2, 4):
        n_acc, emit = TSP.verify_greedy(_on_ranks(logits, r),
                                        torch.from_numpy(draft),
                                        vocab_size=vocab)
        np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(emit.numpy(), np.asarray(je))


@pytest.mark.parametrize("gamma,n", [(3, 3), (2, 1), (5, 4)])
def test_ngram_draft_matches_reference(gamma, n):
    rng = np.random.RandomState(gamma * 10 + n)
    motif = rng.randint(0, 16, 6).tolist()
    contexts = [rng.randint(0, 8, int(rng.randint(1, 40))).tolist()
                for _ in range(30)]
    contexts += [motif * k + rng.randint(0, 16, j).tolist()
                 for k in (1, 2, 3) for j in (0, 1, 4)]
    want = JSP.NgramDraft(gamma, n=n).propose(contexts)
    got = TSP.NgramDraft(gamma, n=n).propose(contexts)
    assert got == want
    assert sum(map(bool, got)) > len(contexts) // 2


@pytest.fixture(scope="module")
def draft_pair(tiny_model, torch_model):
    """The same target params as a reference and a port ModelDraft."""
    api, mesh, params = tiny_model
    tapi, tparams = torch_model
    return (JSP.ModelDraft(api, mesh, params, gamma=3, max_batch=4),
            TSP.ModelDraft(tapi, tparams, 3, max_batch=4))


def test_model_draft_matches_reference(draft_pair):
    """Proposals for contexts across two length buckets and a batch above
    max_batch (padded to 8 rows)."""
    jd, td = draft_pair
    rng = np.random.RandomState(9)
    contexts = [rng.randint(0, 128, int(n)).tolist()
                for n in (1, 5, 30, 63, 64, 70, 100)]
    assert td.propose(contexts) == jd.propose(contexts)


def _serve(eng, prompts, n_new):
    for i, p in enumerate(prompts):
        eng.add_request(TRequest(rid=i, prompt=list(p), max_new_tokens=n_new))
    return {r.rid: r.output for r in eng.run()}


def _prompts(seed=0, sizes=(23, 57, 40)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, n).tolist() for n in sizes]


SPEC_SCHED = dict(max_batch=4, chunk_tokens=64, max_len=128,
                  prefill_bucket=16)


@pytest.mark.parametrize("kw", [dict(paged=True), dict(paged=False),
                                dict(paged=True, packed=True)],
                         ids=["paged", "slots", "packed_paged"])
def test_model_draft_engine_token_identical(kw, torch_model, draft_pair):
    """A self-draft accepts every token and commits gamma+1 per window
    through the rollback machinery; the tokens are plain greedy's."""
    api, tparams = torch_model
    prompts = _prompts()
    ref = _serve(TEngine(api, tparams, TSched(**SPEC_SCHED, **kw),
                         device="cpu"), prompts, 12)
    eng = TEngine(api, tparams, TSched(**SPEC_SCHED, **kw, spec_gamma=3),
                  draft=draft_pair[1], device="cpu")
    assert _serve(eng, prompts, 12) == ref
    assert eng.stats.spec.acceptance_rate == pytest.approx(1.0)
    assert eng.stats.spec.tokens_per_step > 2.0


def test_spec_respects_max_new_tokens(torch_model):
    """Drafts are capped so a verify never overshoots max_new_tokens."""
    api, tparams = torch_model
    draft = TSP.ModelDraft(api, tparams, 4, max_batch=4)
    eng = TEngine(api, tparams, TSched(**SPEC_SCHED, paged=True,
                                       spec_gamma=4), draft=draft,
                  device="cpu")
    got = _serve(eng, _prompts(), 5)
    assert all(len(o) == 5 for o in got.values())
    assert eng.stats.spec.draft_accepted > 0


# --------------------------------------------------------------------------
# verify_step and verify windows in packed steps
# --------------------------------------------------------------------------

def test_verify_step_weave_matches_unsplit_and_reference(mesh11, tiny_cfg):
    """32 rows x 3 tokens cross the verify site's threshold: the weave's
    batch split gives the unsplit logits and cache within 1e-5, and both
    the reference's."""
    from repro.configs.base import ParallelConfig as JPcfg
    b, s_v, max_len = 32, 3, 16
    pcfg_on = JPcfg(tokenweave=True, comm_mode="fused", remat=False,
                    split_unit=16, tokenweave_min_tokens=32)
    api = j_build_model(tiny_cfg, pcfg_on, tp=1)
    jparams = api.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, tiny_cfg.vocab_size, (b, s_v)).astype(np.int32)
    positions = np.broadcast_to(np.arange(s_v, dtype=np.int32)[None],
                                (b, s_v)).copy()

    def jfn(p, c, t, pos):
        return JT.verify_step(p, t, c, cfg=tiny_cfg, pcfg=pcfg_on,
                              positions=pos)

    j_logits, j_cache = jax.jit(jax.shard_map(
        jfn, mesh=mesh11, in_specs=(api.specs(), api.cache_specs(), P(), P()),
        out_specs=(P(), api.cache_specs()), check_vma=False))(
        jparams, api.init_cache(b, max_len), jnp.asarray(tokens),
        jnp.asarray(positions))

    tcfg = tbase.ModelConfig(**dataclasses.asdict(tiny_cfg))
    outs = {}
    for name, weave in (("weave", True), ("unsplit", False)):
        tpcfg = tbase.ParallelConfig(
            tokenweave=weave, comm_mode="fused", remat=False, split_unit=16,
            tokenweave_min_tokens=32, attn_impl="pallas",
            use_pallas_norm=True)
        info = TT.weave_decision_info(b, s_v, tp=1, pcfg=tpcfg, decode=True)
        assert info.weave == weave and info.site == "verify"
        tapi = t_build_model(tcfg, tpcfg)
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                  tpcfg, device="cpu")
        logits, cache = tapi.verify_step(
            tparams, torch.from_numpy(tokens),
            tapi.init_cache(b, max_len, device="cpu"),
            torch.from_numpy(positions))
        assert logits.shape == (1, b, s_v, tcfg.vocab_size)
        outs[name] = (logits[0], cache)
    _close(outs["weave"][0], outs["unsplit"][0], tol=1e-5)
    for lw, lu in zip(outs["weave"][1], outs["unsplit"][1]):
        _close(lw["k"], lu["k"], tol=1e-5)
    _close(outs["weave"][0], j_logits, tol=1e-5)
    _pools_close(outs["weave"][1], j_cache)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
def test_packed_verify_window_cut_by_the_weave(both, paged):
    """A packed step whose weave cut (16 of 48) falls inside row 0's
    verify window (its pending input and 3 draft tokens at 14..17): the
    suffix split's window tokens read the prefix split's; W = 4 logits
    and the cache equal the reference's, and the unsplit forward's."""
    mesh, jparams, cfg, pcfg, tparams, tcfg, tpcfg = both
    t, gamma = 48, 3
    info = JT.weave_decision_info(1, t, tp=1, pcfg=pcfg, packed=True)
    cut = info.split[0]
    rng = np.random.RandomState(77)
    ctx = [9, 5, 0, 0]
    tokens = np.zeros((1, t), np.int32)
    positions = np.full((1, t), -1, np.int32)
    seg = np.full(t, -1, np.int32)
    sample_idx = np.full((4, gamma + 1), -1, np.int32)
    cur = 0
    # row 1 decodes, row 2 prefills 13 fresh tokens, row 0 verifies a
    # window of 4 (positions 9..12) over its 9 cached tokens, row 3
    # prefills 20
    for row, n, win in ((1, 1, 1), (2, 13, 1), (0, gamma + 1, gamma + 1),
                        (3, 20, 1)):
        tokens[0, cur:cur + n] = rng.randint(0, cfg.vocab_size, n)
        positions[0, cur:cur + n] = np.arange(ctx[row], ctx[row] + n)
        seg[cur:cur + n] = row
        sample_idx[row, :win] = np.arange(cur + n - win, cur + n)
        cur += n
    assert seg[cut - 1] == seg[cut] == 0 and cut - 1 > 0
    if paged:
        cache, bt = _paged_state(rng, cfg, ctx, grow=24)
        t_cache, t_ref = _torch_pool(cache), _torch_pool(cache)
        kw, tkw = ({"block_tables": jnp.asarray(bt)},
                   {"block_tables": torch.from_numpy(bt)})
    else:
        cache, kw, tkw = _random_cache(rng, cfg, 4, 40, ctx), {}, {}
        t_cache, t_ref = _torch_cache(cache), _torch_cache(cache)

    def jfn(params, tok, cache, pos, seg, idx, kw):
        return JT.packed_step(params, tok, cache, cfg=cfg, pcfg=pcfg,
                              positions=pos, seg_slots=seg, sample_idx=idx,
                              **kw)

    j_logits, j_cache = _shard_run(
        mesh, jfn, jparams, jnp.asarray(tokens),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(positions),
        jnp.asarray(seg), jnp.asarray(sample_idx), kw)
    args = dict(positions=torch.from_numpy(positions),
                seg_slots=torch.from_numpy(seg),
                sample_idx=torch.from_numpy(sample_idx), **tkw)
    t_logits, t_cache = TT.packed_step(
        tparams, torch.from_numpy(tokens), t_cache, cfg=tcfg, pcfg=tpcfg,
        **args)
    u_logits, _ = TT.packed_step(
        tparams, torch.from_numpy(tokens), t_ref, cfg=tcfg,
        pcfg=dataclasses.replace(tpcfg, tokenweave=False), **args)
    assert t_logits.shape == (1, 4, gamma + 1, cfg.vocab_size)
    live = sample_idx >= 0
    _close(t_logits[0][live], np.asarray(j_logits)[live])
    _close(t_logits[0][live], u_logits[0][live], tol=1e-5)
    _pools_close(t_cache, j_cache)


# --------------------------------------------------------------------------
# rollback on slots: stale draft KV above the committed length
# --------------------------------------------------------------------------

class ScriptedDraft(TSP.DraftProposer):
    """Proposes, at its k-th call, ``script[k]`` = (right, wrong): that
    many tokens of the known greedy continuation, then that many wrong
    ones; empty once the script ends."""

    def __init__(self, gamma, script, reference):
        self.gamma = gamma
        self.script = list(script)
        self.reference = reference          # full greedy streams
        self.calls = 0

    def propose(self, contexts):
        right, wrong = (self.script[self.calls]
                        if self.calls < len(self.script) else (0, 0))
        self.calls += 1
        props = []
        for ctx in contexts:
            full = next(f for f in self.reference
                        if f[:len(ctx)] == list(ctx))
            cont = full[len(ctx):len(ctx) + right + wrong]
            props.append(cont[:right] + [(t + 1) % 128
                                         for t in cont[right:]])
        return props


def test_slot_verify_with_shrinking_gamma_and_stale_cells(torch_model):
    """Over legacy slots: an empty draft (a plain decode step), a gamma=3
    window all rejected (its 3 draft cells stay stale above the committed
    length), then a gamma=1 window under the stale cells, then 2 right +
    1 wrong: greedy's tokens all along."""
    api, tparams = torch_model
    prompts = _prompts(3, sizes=(20, 33))
    ref = _serve(TEngine(api, tparams, TSched(**SPEC_SCHED), device="cpu"),
                 prompts, 10)
    full = [list(p) + ref[i] for i, p in enumerate(prompts)]
    draft = ScriptedDraft(3, [(0, 0), (0, 3), (0, 1), (2, 1)], full)
    eng = TEngine(api, tparams, TSched(**SPEC_SCHED, spec_gamma=3),
                  draft=draft, device="cpu")
    reqs = [TRequest(rid=i, prompt=list(p), max_new_tokens=10)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    while not all(r.state == TState.DECODE for r in reqs):
        eng.step()
    stale_seen = False
    while eng.step():
        if draft.calls == 3:                 # after the gamma=1 window
            for r in reqs:
                pos = eng.cache[0]["pos"][r.slot]
                committed = r.length - 1     # cells 0 .. length-2 hold it
                stale_seen |= bool((pos > committed).any())
    assert stale_seen
    assert {r.rid: r.output for r in reqs} == ref
    st = eng.stats.spec
    assert st.verify_steps >= 3 and 0 < st.draft_accepted < \
        st.draft_proposed


# --------------------------------------------------------------------------
# refusals and stochastic serving
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sliding_slots", "seq_shard",
                                  "short_draft"])
def test_spec_refused_as_the_reference_refuses(case, tiny_model, tiny_cfg,
                                               tiny_pcfg, torch_model):
    """Both engines refuse the same configurations with ValueError; the
    paged backend takes a sliding window (mask-enforced)."""
    api, mesh, params = tiny_model
    tapi, tparams = torch_model
    jcfg, jpcfg, draft, sched = tiny_cfg, tiny_pcfg, None, dict(
        max_batch=2, max_len=64, spec_gamma=2)
    if case == "sliding_slots":
        jcfg = dataclasses.replace(tiny_cfg, sliding_window=16)
    elif case == "seq_shard":
        jpcfg = dataclasses.replace(tiny_pcfg, seq_shard_kv=True)
    else:
        draft = (JSP.NgramDraft(1), TSP.NgramDraft(1))
    japi = j_build_model(jcfg, jpcfg, tp=1)
    t_api = dataclasses.replace(
        tapi, cfg=tbase.ModelConfig(**dataclasses.asdict(jcfg)),
        pcfg=dataclasses.replace(tapi.pcfg, seq_shard_kv=jpcfg.seq_shard_kv))
    with pytest.raises(ValueError):
        JEngine(japi, mesh, params, JSched(**sched),
                draft=draft and draft[0])
    with pytest.raises(ValueError):
        TEngine(t_api, tparams, TSched(**sched), draft=draft and draft[1],
                device="cpu")
    if case == "sliding_slots":
        TEngine(t_api, tparams, TSched(**sched, paged=True), device="cpu")


@pytest.mark.parametrize("kw", [dict(paged=True), dict(paged=True,
                                                       packed=True)],
                         ids=["paged", "packed_paged"])
def test_stochastic_spec_engine_reproducible(kw, torch_model):
    """temperature/top-k/top-p through prefill, fallback decode and verify
    from the engine's seeded generator: same seed, same tokens; another
    seed, other tokens; the global RNG plays no part."""
    api, tparams = torch_model
    motif = _prompts(4, sizes=(6,))[0]
    prompts = [motif * 3 + tail for tail in _prompts(5, sizes=(2, 15))]

    def run(seed):
        eng = TEngine(api, tparams,
                      TSched(max_batch=2, chunk_tokens=48, max_len=96,
                             prefill_bucket=16, spec_gamma=2, **kw),
                      temperature=0.8, top_k=20, top_p=0.95, seed=seed,
                      device="cpu")
        torch.manual_seed(seed + 100)
        out = _serve(eng, prompts, 6)
        assert eng.stats.spec.verify_steps > 0
        return out

    a, b, c = run(0), run(0), run(1)
    assert a == b
    assert a != c
    assert all(len(o) == 6 for o in a.values())
