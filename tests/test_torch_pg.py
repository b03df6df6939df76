"""The port's ``process_group`` backend (``CommCtx`` over ``torch.distributed``
groups, ``launch.mesh.init_groups``) in CPU processes over gloo, held to
the rank-axis path on the same inputs and, at tp=2, to the JAX reference.

Two worlds are spawned once for the module (``torch.multiprocessing.spawn``,
a ``file://`` store): world 2 runs the meshes (data 1, model 2) and
(data 2, model 1), world 4 the meshes (data 1, model 4) and (data 2,
model 2); world 2 then runs ``launch.serve``'s main (the reduced
qwen3-moe-235b-a22b, ``ep2d``, among its models).  Every rank runs every
case of a mesh and writes its results to an ``.npz``; the tests read
them and compute the rank-axis side here.  The data meshes run the data
group: ``all_to_all``, the batch over it (the ep2d model and the tiny
dense model at (2, 2), each process its data shard's rows) and
context-parallel decode over it (zamba2-7b and olmoe-1b-7b at (2, 2),
the ep2d model at (2, 1)).
The reference runs on 4 XLA host devices in one subprocess
(``conftest.run_distributed``), at tp=2 and, for the ep2d model with the
batch over data, at (data 2, model 2), on weights the port draws and
hands over in the reference's layout (``weights.to_jax_layout``), while
the worlds run.

Comm mode ``ring`` runs K1's cross-rank wrapper, whose CPU form is its
plain version over the group (``kernels/ar_rmsnorm_peer.py``): held to the
rank axis's ``ring`` (comm_norm, engine tokens, the launcher) and to the
jnp oracle ``repro.kernels.ref.ring_ar_rmsnorm_ref``.

Tolerances: float32 collectives 1e-6 relative; bf16 sums with
``bf16_wire=False`` within one bf16 ulp of ``rank_sum``, with
``bf16_wire=True`` within 2^-7 relative Frobenius (and different from the
float32 wire on an input whose partial sums round differently in bf16);
comm_norm 1e-6; model logits, KV and caches 1e-5; tokens equal; against the
reference logits within 1e-4 (``test_torch_tp.TOL``); K1's plain version
against the oracle within 1e-5 in float32 and one bf16 ulp in bf16 (the
group sums in gloo's order, the oracle rank 0 first).
"""
import dataclasses
import json
import os
import threading
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import run_distributed

from repro_torch.configs import base as tbase
from repro_torch.core import fused_collectives as tfc
from repro_torch.distributed import collectives as TCL
from repro_torch.distributed.context import CommCtx, Groups
from repro_torch.kernels.ar_rmsnorm import rank_sum
from repro_torch.launch.mesh import init_groups, make_mesh
from repro_torch.layers.embedding import (sharded_argmax,
                                          sharded_softmax_xent)
from repro_torch.models import transformer as TT
from repro_torch.models.build import build_model
from repro_torch.runtime import spec as TSP
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.requests import Request
from repro_torch.runtime.sampler import sample
from repro_torch.runtime.scheduler import SchedulerConfig
from repro_torch.weights import from_jax_params, take_rank, to_jax_layout

TOL_REF = 1e-4
CFG = dict(name="tiny", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
           vocab_size=125, dtype="float32")   # 125: the vocab is padded
PCFG = dict(tokenweave=True, remat=False, split_unit=16,
            tokenweave_min_tokens=32)
SCHED = dict(max_batch=3, chunk_tokens=48, max_len=128, prefill_bucket=16)
PACKED = dict(SCHED, paged=True, packed=True, block_size=16)
STOCHASTIC = dict(temperature=0.8, top_p=0.9)
WORLDS = {2: ((1, 2), (2, 1)), 4: ((1, 4), (2, 2))}
MODES = ("vanilla", "reordered", "fused", "ring", "nocomm")
N_REF = 2                         # two-dispatch reference traces at tp=2


def _cfg():
    return tbase.ModelConfig(**CFG)


@pytest.fixture(autouse=True)
def _one_thread():
    """The rank axis's side runs here in many tiny ops: one intra-op
    thread, as the spawned ranks run, keeps them from spinning against
    the other test workers' threads on a loaded host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcfg(**kw):
    return tbase.ParallelConfig(comm_mode=kw.pop("comm_mode", "fused"),
                                attn_impl="pallas", use_pallas_norm=True,
                                **PCFG, **kw)


# --------------------------------------------------------------------------
# inputs, made from seeds on both sides
# --------------------------------------------------------------------------

def _coll_inputs(tp, dp=1, seed=0):
    """(tp, dp·T, d) partials, each data shard's T rows one after the
    other; (dp, n) per-shard values for the ``_dp`` pair."""
    rng = np.random.RandomState(seed + 10 * tp + dp)
    x = rng.randn(tp, dp * 4 * tp, 48).astype(np.float32)
    x *= np.exp2(rng.randint(-6, 6, size=x.shape)).astype(np.float32)
    y = rng.randn(dp, 40).astype(np.float32)
    return x, y


def _a2a_inputs(tp, dp):
    """(R, D, N, 6) rows, N = 4·D, with magnitudes over 12 binades, and
    (1, D, N) integer tags."""
    rng = np.random.RandomState(30 + 10 * tp + dp)
    x = rng.randn(tp, dp, 4 * dp, 6).astype(np.float32)
    x *= np.exp2(rng.randint(-6, 6, size=x.shape)).astype(np.float32)
    return x, rng.randint(-1, 9, size=(1, dp, 4 * dp))


def _wire_input(tp):
    """bf16 partials whose sum rounds differently when each partial sum
    is rounded to bf16: rank 0 holds 1, the others 2^-9 (exactly 1 +
    (tp-1)·2^-9 in float32)."""
    x = np.full((tp, 8 * tp, 16), 2.0 ** -9, np.float32)
    x[0] = 1.0
    return x


def _cn_inputs(tp):
    rng = np.random.RandomState(100 + tp)
    t, d = 6 * tp, 64
    return (rng.randn(tp, t, d).astype(np.float32),
            rng.randn(t, d).astype(np.float32),
            (np.abs(rng.randn(d)) + 0.5).astype(np.float32),
            (np.abs(rng.randn(d)) + 0.5).astype(np.float32))


def _params(tp, seed=3):
    """The tiny model's weights at ``tp`` ranks, drawn by the port."""
    return TT.init_params(_cfg(), seed=seed, device="cpu", tp=tp)


def _cache_inputs(tp, b, c, seed, lengths=None):
    """A random slot cache (per layer (tp, B, C, kv, dh) and (B, C)) with
    row i holding ``lengths[i]`` positions (random unless given), and one
    decode step's ids."""
    cfg = _cfg()
    lay = TT.A.attention_layout(tp, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim)
    rng = np.random.RandomState(seed)
    if lengths is None:
        lengths = rng.randint(1, c - 4, size=b)
    layers = []
    for _ in range(cfg.num_layers):
        shape = (tp, b, c, lay.kv_store, cfg.head_dim)
        pos = np.full((b, c), -1, np.int32)
        for i, n in enumerate(lengths):
            pos[i, :n] = np.arange(n)
        layers.append({"k": rng.randn(*shape).astype(np.float32),
                       "v": rng.randn(*shape).astype(np.float32),
                       "pos": pos})
    tokens = rng.randint(0, cfg.vocab_size, (b, 1))
    return layers, tokens, lengths


def _torch_cache(layers, rank=None, slots=None):
    """numpy cache -> torch; one model rank's heads and a slot range of
    each layer when given."""
    out = []
    for lay in layers:
        k, v, pos = lay["k"], lay["v"], lay["pos"]
        if rank is not None:
            k, v = k[rank:rank + 1], v[rank:rank + 1]
        if slots is not None:
            k, v, pos = (k[:, :, slots], v[:, :, slots], pos[:, slots])
        out.append({n: torch.from_numpy(np.ascontiguousarray(a))
                    for n, a in (("k", k), ("v", v), ("pos", pos))})
    return out


def _traces(trial0, n):
    """Seeded engine traces: (prompts, new tokens), as test_torch_tp's."""
    out = []
    for trial in range(trial0, trial0 + n):
        rng = np.random.RandomState(trial)
        prompts = [[int(t) for t in rng.randint(0, CFG["vocab_size"],
                                                int(rng.randint(3, 60)))]
                   for _ in range(int(rng.randint(2, 6)))]
        out.append((prompts, [int(rng.randint(2, 7)) for _ in prompts]))
    return out


def _packed_trace(seed):
    rng = np.random.RandomState(seed)
    shared = [int(t) for t in rng.randint(0, CFG["vocab_size"], 40)]
    prompts = [shared[:int(rng.randint(16, 41))]
               + [int(t) for t in rng.randint(0, CFG["vocab_size"],
                                              int(rng.randint(1, 30)))]
               for _ in range(5)]
    return prompts, [int(rng.randint(2, 9)) for _ in prompts]


LOOKUP_BLOCK = 8
GAMMA = 3
SELF_KINDS = {2: 2, 4: 1}         # the self-draft engine's kinds a tp runs
SPEC_COUNTERS = ("verify_steps", "draft_proposed", "draft_accepted",
                 "emitted")


def _lookup_traces(trial0, n):
    """Prompt-lookup traces: each prompt repeats one seeded block of
    LOOKUP_BLOCK tokens up to its length, so the n-gram draft proposes
    from the first decode step on."""
    out = []
    for trial in range(trial0, trial0 + n):
        rng = np.random.RandomState(trial)
        block = [int(t) for t in rng.randint(0, CFG["vocab_size"],
                                             LOOKUP_BLOCK)]
        prompts = [(block * 8)[:int(rng.randint(12, 60))]
                   for _ in range(int(rng.randint(2, 5)))]
        out.append((prompts, [int(rng.randint(6, 13)) for _ in prompts]))
    return out


ENGINE_TRACES = {"two": (SCHED, _traces(7000, N_REF)),
                 "packed": (PACKED, [_packed_trace(7100)]),
                 "two_spec": (dict(SCHED, spec_gamma=GAMMA),
                              _lookup_traces(7215, 1)),
                 "packed_spec": (dict(PACKED, spec_gamma=GAMMA),
                                 _lookup_traces(7300, 1))}


def _serve_stats(api, params, sched, prompts, outs, **kw):
    """(each request's tokens, the engine's ``spec/*`` counters)."""
    eng = Engine(api, params, SchedulerConfig(**sched), device="cpu", **kw)
    for i, (p, n) in enumerate(zip(prompts, outs)):
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=n))
    got = {r.rid: r.output for r in eng.run()}
    if eng.block_mgr is not None:            # the pool drained
        assert not eng.block_mgr.tables and not any(eng.block_mgr.alloc.ref)
    return ([got[i] for i in range(len(prompts))],
            [getattr(eng.stats.spec, c) for c in SPEC_COUNTERS])


def _serve(api, params, sched, prompts, outs, **kw):
    return _serve_stats(api, params, sched, prompts, outs, **kw)[0]


def _serve_traces(api, params, sched, traces, **kw):
    """Every trace's tokens and the counters summed over the traces."""
    runs = [_serve_stats(api, params, sched, p, n, **kw) for p, n in traces]
    return ([t for t, _ in runs],
            [int(sum(c)) for c in zip(*(c for _, c in runs))])


def _sampler_logits(tp):
    """Vocab-sharded logits with no near-tie: a permutation of values
    0.37 apart, so neither the top-p threshold nor an argmax sits within
    rounding of another value."""
    rng = np.random.RandomState(40 + tp)
    v_loc, b = 12, 5
    vals = np.stack([rng.permutation(tp * v_loc) * 0.37 / 4
                     for _ in range(b)]).astype(np.float32)
    return vals.reshape(b, 1, tp, v_loc).transpose(2, 0, 1, 3).copy()


# --------------------------------------------------------------------------
# the worlds: every rank runs every case of its mesh
# --------------------------------------------------------------------------

def _case_collectives(groups, out, dp):
    tp, r, d = groups.model_size, groups.model_rank, groups.data_rank
    x, y = _coll_inputs(tp, dp)
    t_loc = x.shape[1] // dp
    mine = torch.from_numpy(x[r:r + 1, d * t_loc:(d + 1) * t_loc])
    for dtype, wire in (("f32", False), ("bf16", False), ("bf16", True)):
        ctx = CommCtx(tp=tp, dp=dp, backend="process_group", groups=groups,
                      bf16_wire=wire)
        xt = mine if dtype == "f32" else mine.bfloat16()
        key = f"{dtype}/{int(wire)}"
        out[f"psum/{key}"] = TCL.psum(xt, ctx).float().numpy()
        out[f"psum_scatter/{key}"] = TCL.psum_scatter(xt, ctx).float().numpy()
        out[f"all_gather/{key}"] = TCL.all_gather(
            TCL.token_shard_slice(xt, ctx), ctx).float().numpy()
        out[f"pmax/{key}"] = TCL.pmax(xt, ctx).float().numpy()
        yt = torch.from_numpy(y[d:d + 1])
        yt = yt if dtype == "f32" else yt.bfloat16()
        out[f"psum_dp/{key}"] = TCL.psum_dp(yt, ctx).float().numpy()
        out[f"pmax_dp/{key}"] = TCL.pmax_dp(yt, ctx).float().numpy()
    if dp > 1:
        a, ids = _a2a_inputs(tp, dp)
        ctx = CommCtx(tp=tp, dp=dp, backend="process_group", groups=groups)
        for dtype in ("f32", "bf16"):
            x = torch.from_numpy(a[r:r + 1, d:d + 1])
            x = x if dtype == "f32" else x.bfloat16()
            rows, tags = TCL.all_to_all(x, ctx, ids=torch.from_numpy(
                ids[:, d:d + 1]))
            out[f"a2a/{dtype}"] = rows.float().numpy()
            out[f"a2a/{dtype}/ids"] = tags.numpy()
    if dp == 1:
        w = torch.from_numpy(_wire_input(tp)[r:r + 1]).bfloat16()
        for wire in (False, True):
            ctx = CommCtx(tp=tp, backend="process_group", groups=groups,
                          bf16_wire=wire)
            out[f"wire/{int(wire)}"] = TCL.psum(w, ctx).float().numpy()


def _case_comm_norm(groups, out):
    tp, r = groups.model_size, groups.model_rank
    x, res, w, wp = (torch.from_numpy(a) for a in _cn_inputs(tp))
    t, d = res.shape
    for mode in MODES:
        ctx = CommCtx(mode=mode, use_pallas=True, tp=tp,
                      backend="process_group", groups=groups)
        res_in = (res.reshape(tp, t // tp, d)[r:r + 1]
                  if ctx.sharded_residual else res[None])
        for post in (False, True):
            o, nr = tfc.comm_norm(x[r:r + 1], res_in.clone(), w, ctx=ctx,
                                  weight_post=wp if post else None)
            out[f"cn/{mode}/{int(post)}/out"] = o.numpy()
            out[f"cn/{mode}/{int(post)}/res"] = nr.numpy()


def _k1_inputs(tp, dtype):
    """Every rank's partial (tp, T, d) and residual chunk (tp, T/tp, d) and
    the weight, numpy-seeded."""
    rng = np.random.RandomState(200 + tp)
    t, d = 8 * tp, 32
    x = rng.randn(tp, t, d).astype(np.float32)
    res = rng.randn(tp, t // tp, d).astype(np.float32)
    w = (np.abs(rng.randn(d)) + 0.5).astype(np.float32)
    if dtype == "bf16":               # values a bf16 holds exactly
        x, res, w = (_bf16(a).float().numpy() for a in (x, res, w))
    return x, res, w


def _case_k1_peer(groups, out):
    """K1's cross-rank wrapper on this rank's share (its plain version
    over the group on the CPU)."""
    from repro_torch.kernels.ar_rmsnorm_peer import ar_rmsnorm_peer
    tp, r = groups.model_size, groups.model_rank
    ctx = CommCtx(mode="ring", use_pallas=True, tp=tp,
                  backend="process_group", groups=groups)
    for dtype in ("f32", "bf16"):
        x, res, w = (torch.from_numpy(a) for a in _k1_inputs(tp, dtype))
        if dtype == "bf16":
            x, res, w = x.bfloat16(), res.bfloat16(), w.bfloat16()
        o, nr = ar_rmsnorm_peer(x[r:r + 1], res[r:r + 1], w, ctx)
        out[f"k1p/{dtype}/out"] = o.float().numpy()
        out[f"k1p/{dtype}/res"] = nr.float().numpy()


def _argmax_logits(tp):
    """Small integer logits: ties within and across ranks, and the
    largest value in the padded vocab tail (which must never win)."""
    lg = np.random.RandomState(70 + tp).randint(0, 4, size=(tp, 3, 2, 10))
    lg[-1, 0, 0, -3:] = 9
    return lg.astype(np.float32)


def _case_argmax(groups, out):
    tp, r = groups.model_size, groups.model_rank
    ctx = CommCtx(tp=tp, backend="process_group", groups=groups)
    lg = torch.from_numpy(_argmax_logits(tp)[r:r + 1])
    out["argmax"] = sharded_argmax(lg, vocab_size=tp * 10 - 3,
                                   ctx=ctx).numpy()


def _case_model(groups, out):
    """Prefill (weave on) and decode through ``ModelApi`` on one rank."""
    tp, r = groups.model_size, groups.model_rank
    api = build_model(_cfg(), _pcfg(), tp=tp, groups=groups)
    params = take_rank(_params(tp), r, _cfg())
    b, chunk = 2, 48
    layers, _, _ = _cache_inputs(tp, b, 64, seed=5, lengths=[10, 3])
    tokens, positions = _prefill_inputs(b, chunk)
    lg, kv = api.prefill(params, tokens, _torch_cache(layers, r), positions,
                         last_idx=torch.tensor([chunk - 1, chunk - 6]))
    out["pf/logits"] = lg.numpy()
    for i, (k, v, _) in enumerate(kv):
        out[f"pf/k{i}"], out[f"pf/v{i}"] = k.numpy(), v.numpy()
    layers, tokens, lengths = _cache_inputs(tp, 4, 32, seed=6)
    cache = _torch_cache(layers, r)
    lg, cache = api.decode_step(params, torch.from_numpy(tokens), cache,
                                _decode_positions(lengths))
    out["dc/logits"] = lg.numpy()
    for i, lay in enumerate(cache):
        for n in ("k", "v", "pos"):
            out[f"dc/{n}{i}"] = lay[n].numpy()


def _prefill_inputs(b, chunk):
    rng = np.random.RandomState(8)
    tokens = torch.from_numpy(rng.randint(0, CFG["vocab_size"], (b, chunk)))
    positions = torch.full((b, chunk), -1, dtype=torch.int32)
    for i, (start, take) in enumerate(((10, chunk), (3, chunk - 5))):
        positions[i, :take] = torch.arange(start, start + take)
    return tokens, positions


def _decode_positions(lengths):
    pos = torch.from_numpy(lengths[:, None].astype(np.int32))
    pos[1, 0] = -1                       # an inactive slot
    return pos


def _case_engine(groups, out):
    tp, r = groups.model_size, groups.model_rank
    api = build_model(_cfg(), _pcfg(), tp=tp, groups=groups)
    params = take_rank(_params(tp), r, _cfg())
    ring = build_model(_cfg(), _pcfg(comm_mode="ring"), tp=tp,
                       groups=groups)
    for name, (sched, traces) in ENGINE_TRACES.items():
        for kind, kw in (("greedy", {}), ("stochastic", STOCHASTIC)):
            out[f"eng/{name}/{kind}"] = np.asarray(json.dumps(
                _serve_traces(api, params, sched, traces, seed=11, **kw)))
        out[f"eng/{name}/ring"] = np.asarray(json.dumps(
            _serve_traces(ring, params, sched, traces)))
    # the target as its own draft over the groups: drafts are accepted
    sched, traces = ENGINE_TRACES["two_spec"]
    for kind, kw in (("greedy", {}), ("stochastic", STOCHASTIC))[:SELF_KINDS[
            tp]]:
        out[f"eng/self_draft/{kind}"] = np.asarray(json.dumps(_serve_traces(
            api, params, sched, traces, seed=11,
            draft=TSP.ModelDraft(api, params, GAMMA, len_bucket=16,
                                 max_batch=2), **kw)))
    _case_verify(groups, out)
    _case_draft(groups, out)
    ctx = api.comm_ctx
    lg = torch.from_numpy(_sampler_logits(tp)[r:r + 1])
    for s in range(3):
        gen = torch.Generator().manual_seed(s)
        out[f"sampler/{s}"] = sample(lg, vocab_size=tp * 12 - 2,
                                     generator=gen, ctx=ctx,
                                     **STOCHASTIC).numpy()


def _verify_inputs(tp):
    """Verification inputs at ``tp`` ranks: logits (tp, B, GAMMA+1, V_loc)
    with no near-tie (permutations of values 0.37 apart, the largest in
    the padded vocab tail at one row), drafts (B, GAMMA) holding the
    target argmax for a prefix of 0..GAMMA tokens, -1 holes and, in the
    last row, the padded tail; and the vocab size."""
    rng = np.random.RandomState(60 + tp)
    v_loc, b = 12, 8
    vocab = tp * v_loc - 2
    full = np.stack([rng.permutation(tp * v_loc) * 0.37
                     for _ in range(b * (GAMMA + 1))]).astype(np.float32)
    full = full.reshape(b, GAMMA + 1, tp * v_loc)
    tgt = np.argmax(full[..., :vocab], axis=-1)
    draft = rng.randint(-1, vocab, (b, GAMMA))
    for i in range(b):
        draft[i, :i % (GAMMA + 1)] = tgt[i, :i % (GAMMA + 1)]
    draft[-1, 0] = vocab + 1
    full[-1, 0, vocab:] += 100.0
    logits = full.reshape(b, GAMMA + 1, tp, v_loc).transpose(2, 0, 1, 3)
    return np.ascontiguousarray(logits), draft, vocab


def _case_verify(groups, out):
    """``verify_greedy`` and ``verify_sample`` (3 seeds) on this rank's
    shard of fixed logits, over the model group."""
    tp, r = groups.model_size, groups.model_rank
    ctx = CommCtx(tp=tp, backend="process_group", groups=groups)
    logits, draft, vocab = _verify_inputs(tp)
    lg, dr = torch.from_numpy(logits[r:r + 1]), torch.from_numpy(draft)
    n_acc, emit = TSP.verify_greedy(lg, dr, vocab_size=vocab, ctx=ctx)
    out["verify/greedy"] = torch.stack([n_acc, emit.long()]).numpy()
    for s in range(3):
        n_acc, emit = TSP.verify_sample(
            lg, dr, torch.Generator().manual_seed(s), vocab_size=vocab,
            ctx=ctx, **STOCHASTIC)
        out[f"verify/sample/{s}"] = torch.stack([n_acc, emit.long()]).numpy()


def _draft_model(tp):
    """A one-layer draft of the tiny model at ``tp`` ranks: (cfg, weights,
    contexts to propose for)."""
    cfg = dataclasses.replace(_cfg(), num_layers=1)
    params = TT.init_params(cfg, seed=9, device="cpu", tp=tp)
    rng = np.random.RandomState(9)
    ctxs = [[int(t) for t in rng.randint(0, CFG["vocab_size"], n)]
            for n in (5, 23, 17)]
    return cfg, params, ctxs


def _case_draft(groups, out):
    """A ``ModelDraft`` over the groups: each rank its rank's draft."""
    tp, r = groups.model_size, groups.model_rank
    cfg, params, ctxs = _draft_model(tp)
    api = build_model(cfg, _pcfg(), tp=tp, groups=groups)
    draft = TSP.ModelDraft(api, take_rank(params, r, cfg), GAMMA,
                           len_bucket=16, max_batch=2)
    out["draft/proposals"] = np.asarray(draft.propose(ctxs))


def _case_reference(groups, out, ref_params):
    """tp=2: the reference's weights, one rank's slice of them."""
    r = groups.model_rank
    api = build_model(_cfg(), _pcfg(), tp=2, groups=groups)
    params = from_jax_params(ref_params, _cfg(), _pcfg(), device="cpu",
                             rank=r)
    for name, (sched, traces) in ENGINE_TRACES.items():
        out[f"ref/{name}"] = np.asarray(json.dumps(
            [_serve(api, params, sched, p, n) for p, n in traces]))
    b, chunk = 2, 48
    tokens, positions = _prefill_inputs(b, chunk)
    cache = api.init_cache(b, 64, device="cpu")
    lg, _ = api.prefill(params, tokens, cache, positions,
                        last_idx=torch.tensor([chunk - 1, chunk - 6]))
    out["ref/logits"] = lg.numpy()


CP_STEPS = 3


def _case_cp_decode(groups, out):
    """Context-parallel decode: each data rank holds C/D slots."""
    tp, dp = groups.model_size, groups.data_size
    r, d = groups.model_rank, groups.data_rank
    pcfg = _pcfg(seq_shard_kv=True)
    api = build_model(_cfg(), pcfg, tp=tp, ep=dp, groups=groups)
    params = take_rank(_params(tp, seed=4), r, _cfg())
    layers, tokens, lengths = _cache_inputs(tp, 4, 32, seed=9)
    c = 32 // dp
    cache = _torch_cache(layers, r, slice(d * c, (d + 1) * c))
    assert cache[0]["k"].shape == api.init_cache(4, 32, device="cpu")[0][
        "k"].shape
    tok, pos = torch.from_numpy(tokens), _decode_positions(lengths)
    for step in range(CP_STEPS):
        lg, cache = api.decode_step(params, tok, cache, pos)
        out[f"cp/logits{step}"] = lg.numpy()
        tok = sample(lg, vocab_size=CFG["vocab_size"],
                     ctx=api.comm_ctx)[:, None]
        out[f"cp/tokens{step}"] = tok.numpy()
        pos = torch.where(pos >= 0, pos + 1, pos)
    for i, lay in enumerate(cache):
        for n in ("k", "v", "pos"):
            out[f"cp/{n}{i}"] = lay[n].numpy()


# --------------------------------------------------------------------------
# the data group: the batch over it, ep2d's all-to-alls, context-parallel
# decode of every family that has one
# --------------------------------------------------------------------------

EP2D = "qwen3-moe-235b-a22b"
EP2D_SEED = 6
# the ep2d model at D = 2 x R = 2, the batch over data: (phase, the weave
# splits) -> (global rows, seed); 16 decode rows a data shard reach the
# decode split's floor at tp=2
DATA_CASES = {("prefill", True): (4, 81), ("decode", True): (32, 82),
              ("decode", False): (8, 83)}
DATA_MODES = ("fused", "ring")
DATA_LEN = 48                     # prefill tokens a row: the weave cuts them
DATA_SLOTS = 32                   # decode cache cells
CP_FAMILIES = ("zamba2-7b", "olmoe-1b-7b")   # at (2, 2); ep2d at (2, 1)
CP_ROWS, CP_SLOTS = 2, 64         # the ep2d model decodes one row


def _ep2d_cfg():
    from repro_torch.configs import get_config
    return get_config(EP2D).reduced()


def _ep2d_params(tp, dp):
    return TT.init_params(_ep2d_cfg(), seed=EP2D_SEED, device="cpu", tp=tp,
                          ep=dp)


def _data_inputs(cfg, tp, phase, b, seed):
    """A case of DATA_CASES (numpy, the rank axis's layout): prefill
    tokens (b, DATA_LEN); or a decode step's tokens and positions (row 1
    free) over a random slot cache of DATA_SLOTS cells per layer, k/v
    (tp, b, C, kv heads / tp, dh)."""
    rng = np.random.RandomState(seed)
    if phase == "prefill":
        return {"tokens": rng.randint(0, cfg.vocab_size, (b, DATA_LEN))}
    lay = TT.A.attention_layout(tp, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim)
    lengths = rng.randint(1, DATA_SLOTS - 4, size=b)
    cache = []
    for _ in range(cfg.num_layers):
        shape = (tp, b, DATA_SLOTS, lay.kv_store, cfg.head_dim)
        pos = np.full((b, DATA_SLOTS), -1, np.int32)
        for i, n in enumerate(lengths):
            pos[i, :n] = np.arange(n)
        cache.append({"k": rng.randn(*shape).astype(np.float32),
                      "v": rng.randn(*shape).astype(np.float32),
                      "pos": pos})
    positions = lengths[:, None].astype(np.int32)
    positions[1, 0] = -1
    return {"cache": cache, "positions": positions,
            "tokens": rng.randint(0, cfg.vocab_size, (b, 1))}


def _ref_cache_np(cache):
    """A ``_data_inputs`` cache -> the reference's stacked layout: k/v (L,
    B, C, kv heads, dh), pos (L, B, C)."""
    def heads(a):
        a = np.moveaxis(a, 0, 2)
        return a.reshape(a.shape[:2] + (-1,) + a.shape[4:])
    return {"k": np.stack([heads(c["k"]) for c in cache]),
            "v": np.stack([heads(c["v"]) for c in cache]),
            "pos": np.stack([c["pos"] for c in cache])}


def _cut(full, like, groups):
    """This process's part of a rank-axis tree: on each axis where the
    process's tree (``like``) is smaller, the model rank's slice (1 of
    tp) or the data rank's (1/D of the rows or of the slots)."""
    from test_torch_pg_families import _leaves, _map
    shapes = {p: t.shape for p, t in _leaves(like)}
    tp, dp = groups.model_size, groups.data_size
    r, d = groups.model_rank, groups.data_rank

    def cut(path, t):
        for a, (m, n) in enumerate(zip(t.shape, shapes[path])):
            if m == n:
                continue
            if n == 1 and m == tp:
                t = t.narrow(a, r, 1)
            elif m == n * dp:
                t = t.narrow(a, d * n, n)
            else:
                raise AssertionError((path, t.shape, shapes[path]))
        return t.contiguous()
    return _map(cut, full)


class _decisions:
    """Every ``weave_decision_info`` call's (b, s, decode, weave, split,
    reason) while the block runs."""

    def __enter__(self):
        self.orig, self.infos = TT.weave_decision_info, []

        def record(b, s, **kw):
            info = self.orig(b, s, **kw)
            self.infos.append([b, s, bool(kw.get("decode")), info.weave,
                               list(info.split or []), info.reason])
            return info
        TT.weave_decision_info = record
        return self.infos

    def __exit__(self, *exc):
        TT.weave_decision_info = self.orig
        return False


def _data_run(api, params, inp, rows=None, rank=None):
    """One DATA_CASES step through ``api``: (logits, the chunk's KV or the
    cache, the decisions); ``rows`` and ``rank`` cut the inputs to one
    process's data shard and model rank."""
    rows = slice(None) if rows is None else rows
    tokens = torch.from_numpy(inp["tokens"][rows])
    with _decisions() as infos, torch.no_grad():
        if "cache" not in inp:
            lg, kv = api.prefill(params, tokens, None, None)
            kv = [{"k": k, "v": v, "pos": p} for k, v, p in kv]
        else:
            cache = _torch_cache([{n: a[:, rows] if n != "pos" else a[rows]
                                   for n, a in c.items()}
                                  for c in inp["cache"]], rank)
            lg, kv = api.decode_step(
                params, tokens, cache,
                torch.from_numpy(inp["positions"][rows]))
    return lg, kv, infos


def _case_data_batch(groups, out):
    """The batch over the data group at (2, 2): the ep2d model in every
    DATA_CASES step, the tiny dense model's prefill and two decode steps,
    in ``fused`` and ``ring``; each process runs its data shard's rows."""
    tp, dp = groups.model_size, groups.data_size
    r, d = groups.model_rank, groups.data_rank
    cfg = _ep2d_cfg()
    for mode in DATA_MODES:
        api = build_model(cfg, _pcfg(comm_mode=mode), tp=tp, ep=dp,
                          groups=groups)
        params = api.init(EP2D_SEED, device="cpu")
        for (phase, weave), (b, seed) in DATA_CASES.items():
            inp = _data_inputs(cfg, tp, phase, b, seed)
            n = b // dp
            lg, kv, infos = _data_run(api, params, inp,
                                      slice(d * n, (d + 1) * n), r)
            key = f"data/ep2d/{mode}/{phase}/{int(weave)}"
            out[key + "/logits"] = lg.numpy()
            out[key + "/decisions"] = np.asarray(json.dumps(infos))
            for i, layer in enumerate(kv):
                for name, t in layer.items():
                    out[f"{key}/{name}{i}"] = t.numpy()
    dense = take_rank(_params(tp), r, _cfg())
    for mode in DATA_MODES:
        api = build_model(_cfg(), _pcfg(comm_mode=mode), tp=tp, ep=dp,
                          groups=groups)
        for i, lg, tok, cache in _dense_data_steps(api, dense, d, r):
            key = f"data/dense/{mode}/{i}"
            out[key + "/logits"] = lg.numpy()
            if tok is not None:
                out[key + "/tokens"] = tok.numpy()
            for j, layer in enumerate(cache):      # the next step
                for name, t in layer.items():      # writes in place
                    out[f"{key}/{name}{j}"] = t.numpy().copy()


def _dense_data_steps(api, params, d=None, r=None):
    """The tiny dense model with the batch over the data axis: a prefill
    of 4 rows (the weave cutting each shard's rows; row 1 ends in 5
    padding tokens), then two greedy decode steps of 8 rows over a random
    cache.  Yields (step, logits, tokens, the prefill's chunk KV or the
    cache); ``d`` and ``r`` cut the rows and heads to one process's."""
    dp = api.ep

    def rows(b):
        return slice(None) if d is None else slice(d * b // dp,
                                                   (d + 1) * b // dp)
    rng = np.random.RandomState(90)
    b = 4
    tokens = torch.from_numpy(rng.randint(0, CFG["vocab_size"],
                                          (b, DATA_LEN)))
    positions = torch.arange(DATA_LEN, dtype=torch.int32).repeat(b, 1)
    positions[1, -5:] = -1
    with torch.no_grad():
        lg, kv = api.prefill(params, tokens[rows(b)], None,
                             positions[rows(b)])
    yield 0, lg, None, [{"k": k, "v": v, "pos": p} for k, v, p in kv]
    layers, dtok, lengths = _cache_inputs(api.tp, 8, 32, seed=91)
    sl = rows(8)
    cache = _torch_cache([{"k": c["k"][:, sl], "v": c["v"][:, sl],
                           "pos": c["pos"][sl]} for c in layers], r)
    tok, pos = torch.from_numpy(dtok)[sl], _decode_positions(lengths)[sl]
    for i in (1, 2):
        with torch.no_grad():
            lg, cache = api.decode_step(params, tok, cache, pos)
        tok = sample(lg, vocab_size=CFG["vocab_size"],
                     ctx=api.comm_ctx)[:, None]
        yield i, lg, tok, cache
        pos = torch.where(pos >= 0, pos + 1, pos)


def _cp_model(name, tp, dp):
    """A context-parallel case's (cfg, pcfg, rank-axis weights): the
    reduced model at (dp, tp) under ``seq_shard_kv``, the CP_FAMILIES'
    weights perturbed as tests/test_torch_pg_families.py draws them."""
    from test_torch_pg_families import _params as family_params
    pcfg = _pcfg(seq_shard_kv=True)
    if name == EP2D:
        return _ep2d_cfg(), pcfg, _ep2d_params(tp, dp)
    from repro_torch.configs import get_config
    return get_config(name).reduced(), pcfg, family_params(name)


def _cp_cache(api, rows):
    """A random rank-axis cache of ``rows`` rows and CP_SLOTS cells
    (floats 0.5·N(0, 1), row i holding ``lengths[i]`` positions), and
    the first step's tokens and positions."""
    from test_torch_pg_families import _map
    rng = np.random.RandomState(95)
    lengths = rng.randint(41, CP_SLOTS - 4, size=rows)

    def fill(path, t):
        if t.dtype.is_floating_point:
            return torch.from_numpy(
                (0.5 * rng.randn(*t.shape)).astype(np.float32))
        pos = np.full(t.shape, -1, np.int32)
        for i, n in enumerate(lengths):
            pos[i, :n] = np.arange(n)
        return torch.from_numpy(pos)
    cache = _map(fill, api.init_cache(rows, CP_SLOTS, device="cpu"))
    tokens = torch.from_numpy(rng.randint(0, api.cfg.vocab_size, (rows, 1)))
    return cache, tokens, torch.from_numpy(lengths[:, None].astype(np.int32))


def _cp_steps(api, params, cache, tok, pos):
    """Two greedy context-parallel decode steps: [(logits, tokens)] and
    the cache, updated in place."""
    steps = []
    for _ in range(2):
        with torch.no_grad():
            lg, cache = api.decode_step(params, tok, cache, pos)
        tok = sample(lg, vocab_size=api.cfg.vocab_size,
                     ctx=api.comm_ctx)[:, None]
        steps.append((lg, tok))
        pos = pos + 1
    return steps, cache


def _case_cp_families(groups, out):
    """Context-parallel decode over the data group: CP_FAMILIES at (2, 2),
    the ep2d model at (2, 1), one row of each data rank's C/D slots."""
    from test_torch_pg_families import _leaves
    tp, dp, r = groups.model_size, groups.data_size, groups.model_rank
    for name in (CP_FAMILIES if tp == 2 else (EP2D,)):
        cfg, pcfg, full = _cp_model(name, tp, dp)
        axis = build_model(cfg, pcfg, tp=tp, ep=dp)
        api = build_model(cfg, pcfg, tp=tp, ep=dp, groups=groups)
        params = (api.init(EP2D_SEED, device="cpu") if name == EP2D
                  else take_rank(full, r, cfg))
        rows = 1 if name == EP2D else CP_ROWS
        cache, tok, pos = _cp_cache(axis, rows)
        cache = _cut(cache, api.init_cache(rows, CP_SLOTS, device="cpu"),
                     groups)
        steps, cache = _cp_steps(api, params, cache, tok, pos)
        for i, (lg, t) in enumerate(steps):
            out[f"cpf/{name}/logits{i}"] = lg.numpy()
            out[f"cpf/{name}/tokens{i}"] = t.numpy()
        for path, t in _leaves(cache):
            out[f"cpf/{name}/cache/{path}"] = t.numpy()


def _worker(rank, world, tmp, ref_path):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    ref_params = None
    for n_data, n_model in WORLDS[world]:
        groups = init_groups(make_mesh((n_data, n_model), ("data", "model")),
                             backend="gloo", init_method=(
                                 f"file://{tmp}/store_{n_data}x{n_model}"),
                             rank=rank, world_size=world)
        out = {"coords": np.asarray([groups.data_rank, groups.model_rank]),
               "backend": np.asarray(dist.get_backend())}
        _case_collectives(groups, out, n_data)
        if n_data == 1:
            _case_argmax(groups, out)
            _case_comm_norm(groups, out)
            _case_k1_peer(groups, out)
            _case_model(groups, out)
            _case_engine(groups, out)
            if n_model == 2:
                ref_params = {k: v for k, v in np.load(ref_path).items()
                              if not k.startswith("ep2d/")}
                _case_reference(groups, out, _nest(ref_params))
        else:
            _case_cp_decode(groups, out)
            _case_cp_families(groups, out)
            if n_model == 2:
                _case_data_batch(groups, out)
        np.savez(f"{tmp}/{n_data}x{n_model}_r{rank}.npz", **out)
        dist.destroy_process_group()
    if world == 2:
        _case_serve(rank, tmp)


SERVE = ["--arch", "llama3.3-70b", "--reduced", "--prompt-lens", "20,9",
         "--new-tokens", "3", "--seed", "2"]


SERVE_EP2D = ["--arch", EP2D, "--reduced", "--prompt-lens", "20,9",
              "--new-tokens", "3", "--seed", "2", "--comm-mode", "ring"]


SERVE_SPEC = ["--arch", "llama3.3-70b", "--reduced", "--prompt-lens",
              "150,70", "--new-tokens", "10", "--seed", "2", "--lookup",
              "--spec-gamma", str(GAMMA), "--comm-mode", "ring"]
SERVES = {"serve": SERVE, "serve_ring": SERVE + ["--comm-mode", "ring"],
          "serve_ep2d": SERVE_EP2D, "serve_spec": SERVE_SPEC,
          "serve_ep2d_spec": SERVE_EP2D + ["--spec-gamma", str(GAMMA),
                                           "--packed", "--lookup"]}


def _case_serve(rank, tmp):
    """``launch.serve``'s main in a world of 2 over gloo, in comm modes
    ``fused`` (its default) and ``ring``, the ep2d model in ``ring`` (data
    size 1: every expert on both ranks, each expert's d_ff split), and
    both with speculative decoding on prompt-lookup prompts (n-gram
    draft; the ep2d model packed over the pool)."""
    import contextlib
    import io
    from repro_torch.launch import serve
    for name, argv in SERVES.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv + ["--device", "cpu",
                                    "--init-method",
                                    f"file://{tmp}/store_{name}",
                                    "--rank", str(rank), "--world-size",
                                    "2"])
        np.savez(f"{tmp}/{name}_r{rank}.npz", rc=np.asarray(rc),
                 line=np.asarray(buf.getvalue()))


def _nest(flat):
    """'a/b/c' keys -> nested dict of numpy arrays."""
    tree = {}
    for key, a in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _flat(tree, prefix=""):
    """A parameter tree (dicts, lists of layers) -> {'a/b/c': numpy}."""
    if isinstance(tree, list):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.numpy()
    return out


# --------------------------------------------------------------------------
# the reference at tp=2, in a subprocess
# --------------------------------------------------------------------------

_JAX_SIDE = r"""
import json, sys
sys.path.insert(0, TESTS_)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import ModelConfig, ParallelConfig
from repro.models import transformer as T
from repro.models.build import build_model
from repro.runtime.engine import Engine
from repro.runtime.requests import Request
from repro.runtime.scheduler import SchedulerConfig

CFG, PCFG, TRACES, PARAMS, OUT = CFG_, PCFG_, TRACES_, PARAMS_, OUT_
mesh = jax.make_mesh((1, 2), ('data', 'model'), devices=jax.devices()[:2],
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = ModelConfig(**CFG)
pcfg = ParallelConfig(comm_mode='fused', use_pallas_norm=False, **PCFG)
api = build_model(cfg, pcfg, tp=2)
tree = {}
for key, a in np.load(PARAMS).items():
    *path, leaf = key.split('/')
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = jnp.asarray(a)
ep2d = tree.pop('ep2d')
out = {}
for name, (sched, traces) in TRACES.items():
    jit_cache, toks = {}, []
    for prompts, outs in traces:
        eng = Engine(api, mesh, tree, SchedulerConfig(**sched),
                     jit_cache=jit_cache)
        for i, (p, n) in enumerate(zip(prompts, outs)):
            eng.add_request(Request(rid=i, prompt=p, max_new_tokens=n))
        got = {r.rid: r.output for r in eng.run()}
        toks.append([got[i] for i in range(len(prompts))])
    out['ref/' + name] = np.asarray(json.dumps(toks))
b, chunk = 2, 48
rng = np.random.RandomState(8)
tokens = rng.randint(0, cfg.vocab_size, (b, chunk)).astype(np.int32)
positions = np.full((b, chunk), -1, np.int32)
for i, (start, take) in enumerate(((10, chunk), (3, chunk - 5))):
    positions[i, :take] = np.arange(start, start + take)
last = np.array([chunk - 1, chunk - 6], np.int32)
cache = api.init_cache(b, 64)
f = jax.jit(jax.shard_map(
    lambda p, t, c, pos, li: T.prefill(p, t, c, cfg=cfg, pcfg=pcfg,
                                       positions=pos, last_idx=li)[0],
    mesh=mesh, in_specs=(api.specs(), P(), api.cache_specs(), P(), P()),
    out_specs=P(None, None, 'model'), check_vma=False))
out['ref/logits'] = np.asarray(f(tree, tokens, cache, positions, last))

# the ep2d model at (data 2, model 2), the batch over data, in 'fused'
# (the reference's 'ring' without Pallas falls back to it)
import test_torch_pg as PG
from repro import configs as C
from repro.models import transformer as JT
decisions = []
orig_info = JT.weave_decision_info
def record(b, s, **kw):
    info = orig_info(b, s, **kw)
    decisions.append([b, s, bool(kw.get('decode')), info.weave,
                      list(info.split or []), info.reason])
    return info
JT.weave_decision_info = record
m22 = jax.make_mesh((2, 2), ('data', 'model'),
                    axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = C.get_config(PG.EP2D).reduced()
pcfg = ParallelConfig(comm_mode='fused', use_pallas_norm=False, **PCFG)
api = build_model(cfg, pcfg, tp=2, ep=2)
for (phase, weave), (b, seed) in PG.DATA_CASES.items():
    if phase == 'decode' and not weave:
        continue
    inp = PG._data_inputs(PG._ep2d_cfg(), 2, phase, b, seed)
    tok = inp['tokens'].astype(np.int32)
    decisions.clear()
    if phase == 'prefill':
        pos = np.broadcast_to(np.arange(PG.DATA_LEN, dtype=np.int32),
                              tok.shape).copy()
        g = jax.jit(jax.shard_map(
            lambda p, t, ps: T.prefill(p, t, None, cfg=cfg, pcfg=pcfg,
                                       positions=ps)[0],
            mesh=m22, in_specs=(api.specs(), P('data'), P('data')),
            out_specs=P('data', None, 'model'), check_vma=False))
        lg = g(ep2d, tok, pos)
    else:
        cache = {k: jnp.asarray(v)
                 for k, v in PG._ref_cache_np(inp['cache']).items()}
        g = jax.jit(jax.shard_map(
            lambda p, t, c, ps: T.decode_step(p, t, c, cfg=cfg, pcfg=pcfg,
                                              positions=ps)[0],
            mesh=m22, in_specs=(api.specs(), P('data'), api.cache_specs(),
                                P('data')),
            out_specs=P('data', None, 'model'), check_vma=False))
        lg = g(ep2d, tok, cache, inp['positions'])
    out[f'ep2d/{phase}/logits'] = np.asarray(lg)
    out[f'ep2d/{phase}/decisions'] = np.asarray(json.dumps(decisions))
JT.weave_decision_info = orig_info
np.savez(OUT, **out)
print('PASS')
"""


def _reference_code(params_path, out_path):
    code = _JAX_SIDE
    traces = {k: (sched, v) for k, (sched, v) in ENGINE_TRACES.items()}
    for key, val in (("TESTS_", repr(os.path.dirname(
                         os.path.abspath(__file__)))),
                     ("CFG_", repr(CFG)), ("PCFG_", repr(PCFG)),
                     ("TRACES_", repr(traces)),
                     ("PARAMS_", repr(str(params_path))),
                     ("OUT_", repr(str(out_path)))):
        code = code.replace(key, val, 1)
    return code


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Spawn both worlds (and start the reference subprocess) once; ->
    {(data, model): [rank 0's results, rank 1's, ...]}, "ref": the
    reference's npz, "params": the tp=2 weights it ran."""
    tmp = tmp_path_factory.mktemp("pg")
    params = _params(2)
    flat = _flat(to_jax_layout(params, _cfg(), _pcfg()))
    flat.update(_flat(to_jax_layout(_ep2d_params(2, 2), _ep2d_cfg(),
                                    _pcfg()), "ep2d/"))
    np.savez(tmp / "ref_params.npz", **flat)
    ref_error = []

    def reference():
        try:
            run_distributed(_reference_code(tmp / "ref_params.npz",
                                            tmp / "ref.npz"),
                            n_devices=4, timeout=600)
        except BaseException as e:           # re-raised after the join
            ref_error.append(e)
    ref = threading.Thread(target=reference)
    ref.start()
    # the workers import src/ through sys.path: without PYTHONPATH their
    # interpreters skip src/sitecustomize.py, which would load jax
    saved = os.environ.pop("PYTHONPATH", None)
    try:
        procs = [mp.spawn(_worker, args=(world, str(tmp),
                                         str(tmp / "ref_params.npz")),
                          nprocs=world, join=False) for world in WORLDS]
    finally:
        if saved is not None:
            os.environ["PYTHONPATH"] = saved
    try:
        for ctx in procs:
            while not ctx.join():
                pass
    except BaseException:
        for ctx in procs:
            for p in ctx.processes:
                p.kill()
        raise
    finally:
        ref.join()
    if ref_error:
        raise ref_error[0]
    got = {mesh: [dict(np.load(tmp / f"{mesh[0]}x{mesh[1]}_r{w}.npz"))
                  for w in range(mesh[0] * mesh[1])]
           for meshes in WORLDS.values() for mesh in meshes}
    for name in SERVES:
        got[name] = [dict(np.load(tmp / f"{name}_r{w}.npz"))
                     for w in range(2)]
    got["ref"] = dict(np.load(tmp / "ref.npz"))
    got["params"] = params
    return got


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [m for ms in WORLDS.values() for m in ms])
def test_init_groups_coordinates_follow_the_mesh(worlds, mesh):
    coords = np.stack([r["coords"] for r in worlds[mesh]])
    want = np.arange(mesh[0] * mesh[1]).reshape(mesh)
    for w, (d, m) in enumerate(coords):
        assert want[d, m] == w
    assert all(str(r["backend"]) == "gloo" for r in worlds[mesh])


# --------------------------------------------------------------------------
# collectives against the rank-axis branch
# --------------------------------------------------------------------------

def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _expected(op, x, y, tp, dp, dtype, d, r):
    """The rank-axis result that process (data d, model r) should hold."""
    cast = torch.from_numpy if dtype == "f32" else _bf16
    t_loc = x.shape[1] // dp
    if op in ("psum", "pmax"):
        shard = cast(np.ascontiguousarray(x[:, d * t_loc:(d + 1) * t_loc]))
        ctx = CommCtx(tp=tp)
        out = TCL.psum(shard, ctx) if op == "psum" else TCL.pmax(shard, ctx)
        return out.float().numpy()
    ctx = CommCtx(tp=tp, dp=dp)
    xt, yt = cast(x), cast(y)
    if op == "psum_scatter":
        c = t_loc // tp
        out = TCL.psum_scatter(xt, ctx)[r:r + 1, d * c:(d + 1) * c]
    elif op == "all_gather":
        out = TCL.all_gather(TCL.token_shard_slice(xt, ctx), ctx)[
            r:r + 1, d * t_loc:(d + 1) * t_loc]
    else:
        fn = TCL.psum_dp if op == "psum_dp" else TCL.pmax_dp
        out = fn(yt, ctx)[d:d + 1]
    return out.float().numpy()


def _bf16_ulp(a):
    a = np.abs(a.astype(np.float32))
    return np.spacing(a) * 2.0 ** 16


COLL_OPS = ("psum", "psum_scatter", "all_gather", "pmax", "psum_dp",
            "pmax_dp")


@pytest.mark.parametrize("wire", ["f32/0", "bf16/0", "bf16/1"])
@pytest.mark.parametrize("op", COLL_OPS)
@pytest.mark.parametrize("mesh", [(1, 2), (1, 4), (2, 1), (2, 2)])
def test_collective_matches_rank_axis(worlds, mesh, op, wire):
    dp, tp = mesh
    x, y = _coll_inputs(tp, dp)
    dtype = wire.split("/")[0]
    for w, res in enumerate(worlds[mesh]):
        d, r = divmod(w, tp)
        ref = _expected(op, x, y, tp, dp, dtype, d, r)
        got = res[f"{op}/{wire}"]
        assert got.shape == ref.shape, (op, got.shape, ref.shape)
        if dtype == "f32":
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        elif wire == "bf16/0" or op in ("pmax", "pmax_dp", "all_gather"):
            assert (np.abs(got - ref) <= _bf16_ulp(ref)).all(), op
        else:
            err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert err <= 2.0 ** -7, (op, err)


@pytest.mark.parametrize("tp", [2, 4])
def test_bf16_wire_changes_the_bf16_sum(worlds, tp):
    """rank 0 holds 1, the others 2^-9: the float32 wire rounds 1 +
    (tp-1)·2^-9 once (rank_sum's bits); the bf16 wire rounds every partial
    sum, so an order that adds 1 first loses the small terms."""
    x = _wire_input(tp)
    want = rank_sum(_bf16(x)).float().numpy()
    results = worlds[(1, tp)]
    for res in results:
        np.testing.assert_array_equal(res["wire/0"], want)
        err = np.linalg.norm(res["wire/1"] - want) / np.linalg.norm(want)
        assert err <= 2.0 ** -7
    if tp > 2:
        assert any((res["wire/1"] != res["wire/0"]).any() for res in results)
    else:
        # two terms: one rounding either way
        assert all((res["wire/1"] == res["wire/0"]).all() for res in results)


# --------------------------------------------------------------------------
# comm_norm, model, engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tp", [2, 4])
def test_comm_norm_matches_rank_axis(worlds, tp, mode, post):
    x, res, w, wp = (torch.from_numpy(a) for a in _cn_inputs(tp))
    ctx = CommCtx(mode=mode, use_pallas=True, tp=tp)
    t, d = res.shape
    res_in = (res.reshape(tp, t // tp, d) if ctx.sharded_residual
              else res.expand(tp, t, d).contiguous())
    out, new_res = tfc.comm_norm(x, res_in, w, ctx=ctx,
                                 weight_post=wp if post else None)
    for r, got in enumerate(worlds[(1, tp)]):
        np.testing.assert_allclose(got[f"cn/{mode}/{int(post)}/out"],
                                   out[r:r + 1].numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got[f"cn/{mode}/{int(post)}/res"],
                                   new_res[r:r + 1].numpy(), rtol=1e-6,
                                   atol=1e-6)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("tp", [2, 4])
def test_prefill_and_decode_match_rank_axis(worlds, tp):
    api = build_model(_cfg(), _pcfg(), tp=tp)
    params = _params(tp)
    b, chunk = 2, 48
    layers, _, _ = _cache_inputs(tp, b, 64, seed=5, lengths=[10, 3])
    tokens, positions = _prefill_inputs(b, chunk)
    assert TT.weave_decision_info(b, chunk, tp=tp, pcfg=api.pcfg).weave
    lg, kv = api.prefill(params, tokens, _torch_cache(layers), positions,
                         last_idx=torch.tensor([chunk - 1, chunk - 6]))
    layers, dtok, lengths = _cache_inputs(tp, 4, 32, seed=6)
    dlg, cache = api.decode_step(params, torch.from_numpy(dtok),
                                 _torch_cache(layers),
                                 _decode_positions(lengths))
    for r, got in enumerate(worlds[(1, tp)]):
        _close(got["pf/logits"], lg[r:r + 1].numpy())
        for i, (k, v, _) in enumerate(kv):
            _close(got[f"pf/k{i}"], k[r:r + 1].numpy())
            _close(got[f"pf/v{i}"], v[r:r + 1].numpy())
        _close(got["dc/logits"], dlg[r:r + 1].numpy())
        for i, lay in enumerate(cache):
            _close(got[f"dc/k{i}"], lay["k"][r:r + 1].numpy())
            _close(got[f"dc/v{i}"], lay["v"][r:r + 1].numpy())
            np.testing.assert_array_equal(got[f"dc/pos{i}"],
                                          lay["pos"].numpy())


def _spec_served(engine, counters):
    """A spec trace's summed counters show verified windows and drafts;
    a trace without spec has none."""
    verify_steps, proposed = counters[:2]
    if ENGINE_TRACES[engine][0].get("spec_gamma"):
        assert verify_steps > 0 and proposed > 0, (engine, counters)
    else:
        assert counters == [0] * len(SPEC_COUNTERS)


@pytest.mark.parametrize("kind", ["greedy", "stochastic"])
@pytest.mark.parametrize("engine", list(ENGINE_TRACES))
@pytest.mark.parametrize("tp", [2, 4])
def test_engine_tokens_equal_rank_axis(worlds, tp, engine, kind):
    """Each process's engine over the groups: tokens and ``spec/*``
    counters (summed over the traces) equal to the rank axis's, greedy
    and seeded stochastic, speculative traces (verify windows over slots
    and packed over the pool) included."""
    api = build_model(_cfg(), _pcfg(), tp=tp)
    sched, traces = ENGINE_TRACES[engine]
    want = _serve_traces(api, _params(tp), sched, traces, seed=11,
                         **(STOCHASTIC if kind == "stochastic" else {}))
    _spec_served(engine, want[1])
    for got in worlds[(1, tp)]:
        assert json.loads(str(got[f"eng/{engine}/{kind}"])) == list(want)


@pytest.mark.parametrize("engine", list(ENGINE_TRACES))
@pytest.mark.parametrize("tp", [2, 4])
def test_ring_engine_tokens_equal_rank_axis(worlds, tp, engine):
    """Comm mode ``ring``: every slot through K1's cross-rank wrapper on
    each process against the rank axis's K1, greedy; tokens and
    ``spec/*`` counters."""
    api = build_model(_cfg(), _pcfg(comm_mode="ring"), tp=tp)
    sched, traces = ENGINE_TRACES[engine]
    want = _serve_traces(api, _params(tp), sched, traces)
    for got in worlds[(1, tp)]:
        assert json.loads(str(got[f"eng/{engine}/ring"])) == list(want)


@pytest.mark.parametrize("tp, kind", [(2, "greedy"), (2, "stochastic"),
                                      (4, "greedy")])
def test_self_draft_engine_equals_rank_axis(worlds, tp, kind):
    """The tiny model as its own ``ModelDraft`` over the groups (every
    rank rolling out its own rank's weights, the argmax over the model
    group) on the ``two_spec`` traces: tokens and ``spec/*`` counters
    equal to the rank axis's, and drafts accepted (greedy: every
    proposal; stochastic: some, not all)."""
    api = build_model(_cfg(), _pcfg(), tp=tp)
    params = _params(tp)
    sched, traces = ENGINE_TRACES["two_spec"]
    want = _serve_traces(api, params, sched, traces, seed=11,
                         draft=TSP.ModelDraft(api, params, GAMMA,
                                              len_bucket=16, max_batch=2),
                         **(STOCHASTIC if kind == "stochastic" else {}))
    _, proposed, accepted, _ = want[1]
    assert 0 < accepted <= proposed
    assert (accepted == proposed) == (kind == "greedy")
    for got in worlds[(1, tp)]:
        assert json.loads(str(got[f"eng/self_draft/{kind}"])) == list(want)


@pytest.mark.parametrize("tp", [2, 4])
def test_verify_rules_over_groups_equal_rank_axis(worlds, tp):
    """``verify_greedy`` and ``verify_sample`` (temperature 0.8, top-p 0.9,
    3 seeds) with a group ctx on each rank's shard of fixed logits: (n_acc,
    emit) equal to the rank axis's on the whole logits, drafts accepted
    and rejected, and the padded vocab tail never emitted."""
    logits, draft, vocab = _verify_inputs(tp)
    lg, dr = torch.from_numpy(logits), torch.from_numpy(draft)
    n_acc, emit = TSP.verify_greedy(lg, dr, vocab_size=vocab)
    want = {"greedy": torch.stack([n_acc, emit.long()]).numpy()}
    assert sorted(set(n_acc.tolist())) == list(range(GAMMA + 1))
    for s in range(3):
        n_acc, emit = TSP.verify_sample(
            lg, dr, torch.Generator().manual_seed(s), vocab_size=vocab,
            **STOCHASTIC)
        want[f"sample/{s}"] = torch.stack([n_acc, emit.long()]).numpy()
    acc = np.concatenate([want[f"sample/{s}"][0] for s in range(3)])
    assert acc.max() > 0 and acc.min() == 0
    for key, w in want.items():
        assert (w[1] < vocab).all()
        for got in worlds[(1, tp)]:
            np.testing.assert_array_equal(got[f"verify/{key}"], w)


@pytest.mark.parametrize("tp", [2, 4])
def test_model_draft_over_groups_equals_rank_axis(worlds, tp):
    """A one-layer ``ModelDraft`` built over the groups (each process its
    rank's draft weights): every rank's proposals equal the rank axis's
    draft's on the same contexts."""
    cfg, params, ctxs = _draft_model(tp)
    draft = TSP.ModelDraft(build_model(cfg, _pcfg(), tp=tp), params,
                           GAMMA, len_bucket=16, max_batch=2)
    want = np.asarray(draft.propose(ctxs))
    assert want.shape == (len(ctxs), GAMMA)
    for got in worlds[(1, tp)]:
        np.testing.assert_array_equal(got["draft/proposals"], want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tp", [2, 4])
def test_k1_peer_plain_matches_the_oracle(worlds, tp, dtype):
    """Each rank's full normed output and its residual chunk from K1's
    cross-rank wrapper (its plain version over gloo) against
    ``ring_ar_rmsnorm_ref``'s for that rank."""
    import jax.numpy as jnp
    from repro.kernels.ref import ring_ar_rmsnorm_ref
    x, res, w = _k1_inputs(tp, dtype)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    outs, ress = ring_ar_rmsnorm_ref([jnp.asarray(a, jdt) for a in x],
                                     [jnp.asarray(a, jdt) for a in res],
                                     jnp.asarray(w, jdt))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else dict(
        rtol=2.0 ** -7, atol=1e-6)
    for r, got in enumerate(worlds[(1, tp)]):
        np.testing.assert_allclose(got[f"k1p/{dtype}/out"][0],
                                   np.asarray(outs[r], np.float32), **tol)
        np.testing.assert_allclose(got[f"k1p/{dtype}/res"][0],
                                   np.asarray(ress[r], np.float32), **tol)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_argmax_ties_across_ranks(worlds, tp):
    lg = _argmax_logits(tp)
    want = sharded_argmax(torch.from_numpy(lg), vocab_size=tp * 10 - 3)
    assert int(want[0, 0]) < tp * 10 - 3            # the pad never wins
    for got in worlds[(1, tp)]:
        np.testing.assert_array_equal(got["argmax"], want.numpy())


@pytest.mark.parametrize("tp", [2, 4])
def test_stochastic_sample_equals_rank_axis(worlds, tp):
    lg = torch.from_numpy(_sampler_logits(tp))
    for s in range(3):
        want = sample(lg, vocab_size=tp * 12 - 2, generator=torch.Generator(
        ).manual_seed(s), **STOCHASTIC).numpy()
        for got in worlds[(1, tp)]:
            np.testing.assert_array_equal(got[f"sampler/{s}"], want)


@pytest.mark.parametrize("engine", list(ENGINE_TRACES))
def test_engine_tokens_equal_reference_tp2(worlds, engine):
    want = json.loads(str(worlds["ref"][f"ref/{engine}"]))
    assert sum(len(t) for trace in want for t in trace) > 0
    for got in worlds[(1, 2)]:
        assert json.loads(str(got[f"ref/{engine}"])) == want


def test_prefill_logits_match_reference_tp2(worlds):
    want = worlds["ref"]["ref/logits"]                  # (B, 1, tp·V_loc)
    for r, got in enumerate(worlds[(1, 2)]):
        v_loc = got["ref/logits"].shape[-1]
        _close(got["ref/logits"][0], want[..., r * v_loc:(r + 1) * v_loc],
               TOL_REF)


# --------------------------------------------------------------------------
# context-parallel decode over the data group
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_cp_decode_matches_rank_axis(worlds, mesh):
    dp, tp = mesh
    api = build_model(_cfg(), _pcfg(seq_shard_kv=True), tp=tp, ep=dp)
    params = _params(tp, seed=4)
    layers, tokens, lengths = _cache_inputs(tp, 4, 32, seed=9)
    cache = _torch_cache(layers)
    tok, pos = torch.from_numpy(tokens), _decode_positions(lengths)
    steps = []
    for _ in range(CP_STEPS):
        lg, cache = api.decode_step(params, tok, cache, pos)
        tok = sample(lg, vocab_size=CFG["vocab_size"])[:, None]
        steps.append((lg, tok))
        pos = torch.where(pos >= 0, pos + 1, pos)
    c = 32 // dp
    for w, got in enumerate(worlds[mesh]):
        d, r = divmod(w, tp)
        for i, (lg, tok) in enumerate(steps):
            _close(got[f"cp/logits{i}"], lg[r:r + 1].numpy())
            np.testing.assert_array_equal(got[f"cp/tokens{i}"], tok.numpy())
        for i, lay in enumerate(cache):
            sl = slice(d * c, (d + 1) * c)
            _close(got[f"cp/k{i}"], lay["k"][r:r + 1, :, sl].numpy())
            np.testing.assert_array_equal(got[f"cp/pos{i}"],
                                          lay["pos"][:, sl].numpy())


# --------------------------------------------------------------------------
# the data group: all_to_all, the batch over it, CP decode of the families
# --------------------------------------------------------------------------

def _close_leaf(got, want):
    """Within 1e-5 of max(1, the leaf's largest magnitude)."""
    want = np.asarray(want, np.float32)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_all_to_all_matches_rank_axis(worlds, mesh, dtype):
    """``collectives.all_to_all`` over the data group (gloo's
    ``all_to_all_single``) equals the rank axis's index op bit for bit,
    rows and the ids that ride with them."""
    dp, tp = mesh
    a, ids = _a2a_inputs(tp, dp)
    x = torch.from_numpy(a)
    x = x if dtype == "f32" else x.bfloat16()
    want, want_ids = TCL.all_to_all(x, CommCtx(tp=tp, dp=dp),
                                    ids=torch.from_numpy(ids))
    assert not torch.equal(want_ids, torch.from_numpy(ids))
    for w, got in enumerate(worlds[mesh]):
        d, r = divmod(w, tp)
        np.testing.assert_array_equal(got[f"a2a/{dtype}"],
                                      want[r:r + 1, d:d + 1].float().numpy())
        np.testing.assert_array_equal(got[f"a2a/{dtype}/ids"],
                                      want_ids[:, d:d + 1].numpy())


_DATA_AXIS = {}


def _data_axis(mode, case):
    """The rank axis's (logits, KV or cache, decisions) of a DATA_CASES
    step at D = 2 x R = 2, once per test session."""
    if (mode, case) not in _DATA_AXIS:
        cfg = _ep2d_cfg()
        api = build_model(cfg, _pcfg(comm_mode=mode), tp=2, ep=2)
        b, seed = DATA_CASES[case]
        _DATA_AXIS[mode, case] = _data_run(
            api, _ep2d_params(2, 2), _data_inputs(cfg, 2, case[0], b, seed))
    return _DATA_AXIS[mode, case]


def _check_shard_layers(got, key, layers, d, r, n):
    """Each layer's KV or cache leaves of data shard d, model rank r (n
    rows a shard) against the rank axis's."""
    rows = slice(d * n, (d + 1) * n)
    for i, layer in enumerate(layers):
        for name, t in layer.items():
            if name == "pos":
                np.testing.assert_array_equal(got[f"{key}/{name}{i}"],
                                              t[rows].numpy())
            else:
                _close_leaf(got[f"{key}/{name}{i}"],
                            t[r:r + 1, rows].numpy())


@pytest.mark.parametrize("case", list(DATA_CASES),
                         ids=["prefill_weave", "decode_split",
                              "decode_unsplit"])
@pytest.mark.parametrize("mode", DATA_MODES)
def test_ep2d_batch_over_data_group_matches_rank_axis(worlds, mode, case):
    """The reduced qwen3-moe-235b-a22b (``ep2d``) at (data 2, model 2),
    each process on its data shard's rows, its experts' d_ff slice and the
    data group's all-to-alls: logits within 1e-5 and KV within 1e-5 of
    max(1, |leaf|) of the rank axis's at D = 2 x R = 2, and every forward's
    weave decision (made on one shard's rows) the rank axis's."""
    lg, kv, infos = _data_axis(mode, case)
    phase, weave = case
    n = DATA_CASES[case][0] // 2
    key = f"data/ep2d/{mode}/{phase}/{int(weave)}"
    assert infos[0][0] == n and infos[0][3] == weave
    for w, got in enumerate(worlds[(2, 2)]):
        d, r = divmod(w, 2)
        assert json.loads(str(got[key + "/decisions"])) == infos
        _close(got[key + "/logits"], lg[r:r + 1, d * n:(d + 1) * n].numpy())
        _check_shard_layers(got, key, kv, d, r, n)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("mode", DATA_MODES)
def test_ep2d_batch_over_data_group_matches_reference(worlds, mode, phase):
    """The same model against the JAX reference's ``shard_map`` at (data 2,
    model 2) on the same weights: a woven prefill and a decode step whose
    batch split takes rows of both shards; logits within 1e-4, and the
    reference's weave decisions."""
    case = (phase, True)
    want = worlds["ref"][f"ep2d/{phase}/logits"]      # (B, 1, V_pad)
    n = DATA_CASES[case][0] // 2
    key = f"data/ep2d/{mode}/{phase}/1"
    for w, got in enumerate(worlds[(2, 2)]):
        d, r = divmod(w, 2)
        v_loc = got[key + "/logits"].shape[-1]
        _close(got[key + "/logits"][0],
               want[d * n:(d + 1) * n, :, r * v_loc:(r + 1) * v_loc],
               TOL_REF)
        assert json.loads(str(got[key + "/decisions"])) == json.loads(
            str(worlds["ref"][f"ep2d/{phase}/decisions"]))


@pytest.mark.parametrize("mode", DATA_MODES)
def test_dense_batch_over_data_group_matches_rank_axis(worlds, mode):
    """The tiny dense model at (data 2, model 2) with the batch over data:
    a woven prefill and two greedy decode steps, logits within 1e-5,
    tokens equal, KV and caches within 1e-5 of max(1, |leaf|)."""
    api = build_model(_cfg(), _pcfg(comm_mode=mode), tp=2, ep=2)
    for i, lg, tok, cache in _dense_data_steps(api, _params(2)):
        n = lg.shape[1] // 2
        key = f"data/dense/{mode}/{i}"
        for w, got in enumerate(worlds[(2, 2)]):
            d, r = divmod(w, 2)
            _close(got[key + "/logits"],
                   lg[r:r + 1, d * n:(d + 1) * n].numpy())
            if tok is not None:
                np.testing.assert_array_equal(got[key + "/tokens"],
                                              tok[d * n:(d + 1) * n].numpy())
            _check_shard_layers(got, key, cache, d, r, n)


@pytest.mark.parametrize("name", list(CP_FAMILIES) + [EP2D])
def test_cp_decode_of_families_over_data_group_matches_rank_axis(worlds,
                                                                 name):
    """Context-parallel decode over the data group: the reduced zamba2-7b
    (the shared attention's caches) and olmoe-1b-7b (``expert``) at (2, 2),
    the ep2d model at (2, 1) with one row (each data rank dispatching its
    copy through the all-to-alls): two greedy steps, logits within 1e-5,
    tokens equal, each process's caches and states within 1e-5 of max(1,
    |leaf|) of its part of the rank axis's."""
    from test_torch_pg_families import _leaves
    mesh = (2, 1) if name == EP2D else (2, 2)
    dp, tp = mesh
    cfg, pcfg, full = _cp_model(name, tp, dp)
    api = build_model(cfg, pcfg, tp=tp, ep=dp)
    cache, tok, pos = _cp_cache(api, 1 if name == EP2D else CP_ROWS)
    steps, cache = _cp_steps(api, full, cache, tok, pos)
    for w, got in enumerate(worlds[mesh]):
        d, r = divmod(w, tp)
        for i, (lg, t) in enumerate(steps):
            _close(got[f"cpf/{name}/logits{i}"], lg[r:r + 1].numpy())
            np.testing.assert_array_equal(got[f"cpf/{name}/tokens{i}"],
                                          t.numpy())
        groups = Groups(model=None, data=None, model_rank=r, data_rank=d,
                        model_size=tp, data_size=dp)
        like = {p: torch.from_numpy(got[f"cpf/{name}/cache/{p}"])
                for p, _ in _leaves(cache)}
        from test_torch_pg_families import _map
        mine = _cut(cache, _map(lambda p, t: like[p], cache), groups)
        for p, t in _leaves(mine):
            _close_leaf(like[p].numpy(), t.numpy())


def test_serve_launcher_serves_ep2d_at_data_size_1(worlds):
    """``launch.serve --arch qwen3-moe-235b-a22b --reduced --comm-mode
    ring`` in a world of 2 (mesh 1 x 2: every expert on both ranks, each
    expert's d_ff split): the ranks agree, and rank 0's tokens are the
    rank axis's ``ring`` engine's at tp=2 on the same seeded weights."""
    from repro_torch.configs import get_config
    assert [int(r["rc"]) for r in worlds["serve_ep2d"]] == [0, 0]
    line = json.loads(str(worlds["serve_ep2d"][0]["line"]))
    assert line["ranks_agree"] and line["arch"] == EP2D + "-reduced"
    cfg = get_config(EP2D).reduced()
    api = build_model(cfg, tbase.ParallelConfig(
        comm_mode="ring", attn_impl="pallas", use_pallas_norm=True), tp=2)
    params = api.init(2, device="cpu")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (20, 9)]
    assert line["tokens"] == _serve(api, params, dict(), prompts, [3, 3])


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_ep2d_rank_cut_three_ways(coords):
    """One (data, model) rank's ep2d tree: ``take_rank(..., data_rank=)``
    of the 2 x 2 draw equals ``from_jax_params(rank=, data_rank=)`` of the
    reference's layout, which equals ``ModelApi.init`` under groups; its
    expert weights are (1, 1, E/D, ...)."""
    d, r = coords
    cfg = _ep2d_cfg()
    full = _ep2d_params(2, 2)
    want = take_rank(full, r, cfg, data_rank=d)
    ref = _nest(_flat(to_jax_layout(full, cfg, _pcfg())))
    got = from_jax_params(ref, cfg, _pcfg(), device="cpu", rank=r,
                          data_rank=d)
    groups = Groups(model=None, data=None, model_rank=r, data_rank=d,
                    model_size=2, data_size=2)
    api = build_model(cfg, _pcfg(), tp=2, ep=2, groups=groups)
    init = api.init(EP2D_SEED, device="cpu")
    assert want["layers"][0]["moe"]["w_up"].shape[:3] == (1, 1, 2)
    exp = _flat(want)
    for tree in (got, init):
        flat = _flat(tree)
        assert flat.keys() == exp.keys()
        for k in flat:
            np.testing.assert_array_equal(flat[k], exp[k])
    with pytest.raises(ValueError, match="data_rank"):
        take_rank(full, r, cfg)


def test_dry_run_all_to_alls_of_ep2d_unchanged():
    """The meta dry run of the ep2d model at D = 2 x R = 2 (a woven
    prefill of 4 x 48 tokens and a decode step of 32 rows): two
    all-to-alls per MoE call, each the device's send buffer, D·cs rows of
    d (the local expert ids ride with the rows), cs from each call's
    tokens per data shard, as before ``collectives.all_to_all``."""
    import math
    from repro_torch.analysis import op_costs
    cfg = _ep2d_cfg()
    api = build_model(cfg, _pcfg(), tp=2, ep=2)
    params = api.init(0, device="meta")

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")
    _, pre = op_costs.measure(api.prefill, params, i32(4, DATA_LEN), None,
                              i32(4, DATA_LEN), devices=4, ride=2)
    cache = api.init_cache(32, DATA_SLOTS, device="meta")
    _, dec = op_costs.measure(api.decode_step, params, i32(32, 1), cache,
                              i32(32, 1), devices=4, ride=2)
    k = cfg.num_experts_per_tok
    # tokens a data shard per MoE call: each weave split's of one shard's
    # rows (prefill 2 rows cut along the sequence, decode 16 rows)
    pf = TT.weave_decision_info(2, DATA_LEN, tp=2, pcfg=api.pcfg).split
    dc = TT.weave_decision_info(16, 1, tp=2, pcfg=api.pcfg,
                                decode=True).split
    assert pf and dc
    for costs, calls in ((pre, [2 * n for n in pf]), (dec, list(dc))):
        want = []
        for t_loc in calls:
            cs = max(math.ceil(t_loc * k / 2 * cfg.capacity_factor), 4)
            want += [2 * cs * cfg.d_model * 4] * 2
        got = [c.result_bytes for c in costs.collectives
               if c.kind == "all-to-all"]
        assert got == want * cfg.num_layers
        assert all(c.group_size == 2 for c in costs.collectives
                   if c.kind == "all-to-all")


# --------------------------------------------------------------------------
# refusals (in process: nothing here reaches a collective)
# --------------------------------------------------------------------------

def _fake_groups(model=2, data=1):
    return Groups(model=None, data=None, model_rank=0, data_rank=0,
                  model_size=model, data_size=data)


def _refusal(case):
    """What stays refused over the process_group backend: (the call,
    the words its error names[, the error when not NotImplementedError])."""
    from repro_torch.configs import get_config

    def build(name, ep=1, **pcfg):
        return build_model(get_config(name).reduced(),
                           tbase.ParallelConfig(**pcfg), tp=2, ep=ep,
                           groups=_fake_groups(data=ep))

    def engine_spec(name):
        api = build(name)
        Engine(api, api.init(0, device="cpu"),
               SchedulerConfig(**dict(SCHED, spec_gamma=GAMMA)),
               device="cpu")

    def train(name):
        api = build(name)
        api.train_loss(None, {"tokens": torch.zeros(1, 4, dtype=torch.long),
                              "labels": torch.zeros(1, 4, dtype=torch.long)})
    def engine_data(name):
        api = build(name, ep=2)
        Engine(api, api.init(0, device="cpu"), SchedulerConfig(**SCHED),
               device="cpu")
    return {
        "hybrid_batch_data": (lambda: build("zamba2-7b", ep=2),
                              "ep=2.*hybrid family"),
        "ssm_data": (lambda: build("falcon-mamba-7b", ep=2),
                     "ep=2.*ssm family"),
        "encdec_data": (lambda: build("whisper-base", ep=2),
                        "ep=2.*encdec family"),
        "engine_data": (lambda: engine_data("llama3.3-70b"),
                        "data size 1, not ep=2"),
        "train_ssm": (lambda: train("falcon-mamba-7b"), "training"),
        "train_encdec": (lambda: train("whisper-base"), "training"),
        # the reference's own refusal, raised on either backend
        "spec_ssm": (lambda: engine_spec("falcon-mamba-7b"),
                     "speculative decoding rolls back KV positions; ssm "
                     "state has no token axis", ValueError),
    }[case]


@pytest.mark.parametrize("case", ["hybrid_batch_data", "ssm_data",
                                  "encdec_data", "engine_data", "train_ssm",
                                  "train_encdec", "spec_ssm"])
def test_process_group_refuses_what_is_not_ported(case):
    """The hybrid's batch over the data group, a data axis for the ssm
    and encdec families, the engine at data size 2, and training of a
    non-dense family raise NotImplementedError by name, and speculative
    decoding of an ssm model the reference's ValueError; every family
    builds over groups at data size 1 (tests/test_torch_pg_families.py),
    the transformer families with the batch over the data group,
    speculative decoding and the verify step, and they and the hybrid
    under context-parallel decode over it."""
    call, words, *exc = _refusal(case)
    with pytest.raises(*(exc or [NotImplementedError]), match=words):
        call()


@pytest.mark.parametrize("draft_on", ["rank_axis", "other_rank",
                                      "other_tp", "other_group"])
def test_engine_refuses_a_draft_off_the_target_groups(draft_on):
    """A ``ModelDraft`` must run at the target's tp over the target's
    groups (its own rank's draft weights), else the ranks could propose
    different tokens: a draft on the rank axis, over another model rank's
    groups, at another tp or over another ``torch.distributed`` group of
    the same size and rank raises ValueError; one over the same groups
    is taken."""
    api = build_model(_cfg(), _pcfg(), tp=2, groups=_fake_groups())
    params = take_rank(_params(2), 0, _cfg())
    cfg, dparams, _ = _draft_model(2)
    groups = {"rank_axis": None,
              "other_rank": dataclasses.replace(_fake_groups(),
                                                model_rank=1),
              "other_tp": _fake_groups(model=4),
              "other_group": dataclasses.replace(_fake_groups(),
                                                 model=object())}[draft_on]
    tp = 4 if draft_on == "other_tp" else 2
    d_api = build_model(cfg, _pcfg(), tp=tp, groups=groups)
    sched = SchedulerConfig(**dict(SCHED, spec_gamma=GAMMA))
    with pytest.raises(ValueError, match="model draft runs at tp="):
        Engine(api, params, sched, device="cpu", draft=TSP.ModelDraft(
            d_api, dparams, GAMMA))
    same = build_model(cfg, _pcfg(), tp=2, groups=_fake_groups())
    eng = Engine(api, params, sched, device="cpu", draft=TSP.ModelDraft(
        same, take_rank(dparams, 0, cfg), GAMMA))
    assert eng.draft.api.groups == api.groups


def test_training_refuses_process_group():
    api = build_model(_cfg(), _pcfg(), tp=2, groups=_fake_groups())
    params = take_rank(_params(2), 0, _cfg())
    with pytest.raises(NotImplementedError, match="training"):
        api.train_loss(params, {"tokens": torch.zeros(1, 4, dtype=torch.long),
                                "labels": torch.zeros(1, 4,
                                                      dtype=torch.long)})
    ctx = CommCtx(tp=2, backend="process_group", groups=_fake_groups())
    with pytest.raises(NotImplementedError, match="sharded_softmax_xent"):
        sharded_softmax_xent(torch.zeros(1, 1, 4, 63),
                             torch.zeros(1, 4, dtype=torch.long),
                             vocab_size=125, ctx=ctx)


def test_comm_ctx_backends():
    with pytest.raises(ValueError, match="unknown comm backend"):
        CommCtx(backend="nccl")
    with pytest.raises(ValueError, match="init_groups"):
        CommCtx(tp=2, backend="process_group")
    with pytest.raises(ValueError, match="model size"):
        CommCtx(tp=4, backend="process_group", groups=_fake_groups())
    ra = CommCtx(tp=4)
    assert (ra.local_ranks, ra.rank, ra.backend) == (4, 0, "rank_axis")
    pg = CommCtx(tp=2, backend="process_group",
                 groups=dataclasses.replace(_fake_groups(), model_rank=1))
    assert (pg.local_ranks, pg.rank) == (1, 1)


def test_from_jax_params_rank_slices_per_rank_leaves():
    params = _params(2)
    ref = {k: v for k, v in _flat(to_jax_layout(params, _cfg(),
                                                _pcfg())).items()}
    full = from_jax_params(_nest(ref), _cfg(), _pcfg(), device="cpu")
    for r in range(2):
        one = from_jax_params(_nest(ref), _cfg(), _pcfg(), device="cpu",
                              rank=r)
        want = take_rank(full, r, _cfg())
        assert one["norm_first"].shape == (CFG["d_model"],)
        assert one["embedding"]["embed"].shape[0] == 1
        got, exp = _flat(one), _flat(want)
        assert got.keys() == exp.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], exp[k])


def _torch_leaves(tree):
    items = tree if isinstance(tree, list) else tree.values()
    for v in items:
        if isinstance(v, (dict, list)):
            yield from _torch_leaves(v)
        else:
            yield v


class _WholeLeaves(TorchDispatchMode):
    """Weak references to every op's output that holds all ``tp`` ranks;
    at each ``randn`` none of the earlier ones may be alive."""

    def __init__(self, tp):
        super().__init__()
        self.tp, self.refs, self.draws = tp, [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.randn:
            self.draws += 1
            assert all(w() is None for w in self.refs), \
                "a whole leaf outlived its cut"
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if (isinstance(t, torch.Tensor) and t.dim() >= 2
                    and t.shape[0] == self.tp):
                self.refs.append(weakref.ref(t))
        return out


def test_init_one_rank_draws_each_leaf_whole_then_cuts():
    """``ModelApi.init`` under groups: rank r's leaves equal slice r of
    the tp-rank draw, each in a storage of its own, and no whole leaf is
    alive when the next is drawn, so the peak is one whole leaf beside
    the rank's tree, not the whole model."""
    cfg = dataclasses.replace(_cfg(), qkv_bias=True)
    full = TT.init_params(cfg, seed=5, device="cpu", tp=2)
    for r in range(2):
        api = build_model(cfg, _pcfg(), tp=2, groups=dataclasses.replace(
            _fake_groups(), model_rank=r))
        with _WholeLeaves(2) as seen:
            one = api.init(5, device="cpu")
        assert seen.draws > 4 and all(w() is None for w in seen.refs)
        got, want = _flat(one), _flat(take_rank(full, r, cfg))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        for leaf in _torch_leaves(one):
            assert leaf.untyped_storage().nbytes() == leaf.nbytes


def test_serve_launcher_matches_the_rank_axis_engine(worlds):
    """``python -m repro_torch.launch.serve`` in a world of 2 (mesh 1x2)
    over gloo: both
    ranks exit 0 (their tokens agree), rank 0 alone prints, and its
    tokens are the rank-axis engine's on the same seeded weights."""
    from repro_torch.configs import get_config
    assert [int(r["rc"]) for r in worlds["serve"]] == [0, 0]
    assert str(worlds["serve"][1]["line"]) == ""
    line = json.loads(str(worlds["serve"][0]["line"]))
    assert line["backend"] == "gloo" and line["ranks_agree"]
    assert line["world_size"] == 2
    cfg = get_config("llama3.3-70b").reduced()
    api = build_model(cfg, tbase.ParallelConfig(
        comm_mode="fused", attn_impl="pallas", use_pallas_norm=True), tp=2)
    params = api.init(2, device="cpu")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (20, 9)]
    want = _serve(api, params, dict(), prompts, [3, 3])
    assert line["tokens"] == want


def test_serve_launcher_ring_matches_the_rank_axis_ring_engine(worlds):
    """``launch.serve --comm-mode ring`` in a world of 2 over gloo: the
    ranks agree, and rank 0's tokens are the rank-axis engine's in comm
    mode ``ring`` on the same seeded weights."""
    from repro_torch.configs import get_config
    assert [int(r["rc"]) for r in worlds["serve_ring"]] == [0, 0]
    line = json.loads(str(worlds["serve_ring"][0]["line"]))
    assert line["comm_mode"] == "ring" and line["ranks_agree"]
    cfg = get_config("llama3.3-70b").reduced()
    api = build_model(cfg, tbase.ParallelConfig(
        comm_mode="ring", attn_impl="pallas", use_pallas_norm=True), tp=2)
    params = api.init(2, device="cpu")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (20, 9)]
    assert line["tokens"] == _serve(api, params, dict(), prompts, [3, 3])


def _serve_rank_axis(argv, **sched):
    """The rank axis's engine at tp=2 on ``launch.serve``'s seeded weights
    and prompts for ``argv`` (its comm mode), with ``sched``: (tokens,
    ``spec/*`` counters)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    args = serve.parse(argv)
    cfg = get_config(args.arch).reduced()
    api = build_model(cfg, tbase.ParallelConfig(
        comm_mode=args.comm_mode, attn_impl="pallas", use_pallas_norm=True),
        tp=2)
    prompts = serve.prompts_of(np, args, cfg.vocab_size)
    return _serve_stats(api, api.init(args.seed, device="cpu"), sched,
                        prompts, [args.new_tokens] * len(prompts))


def test_serve_launcher_spec_ring_equals_spec_off(worlds):
    """``launch.serve --spec-gamma 3 --lookup --comm-mode ring`` in a
    world of 2 over gloo: the ranks agree, windows were verified and
    drafts accepted, and its greedy tokens equal the rank axis's ``ring``
    engine's with speculation off (and its counters those of the rank
    axis's with it on)."""
    assert [int(r["rc"]) for r in worlds["serve_spec"]] == [0, 0]
    line = json.loads(str(worlds["serve_spec"][0]["line"]))
    assert line["ranks_agree"] and line["comm_mode"] == "ring"
    spec = line["spec"]
    assert spec["gamma"] == GAMMA and spec["draft"] == "ngram"
    assert spec["verify_steps"] > 0 and spec["proposed"] > 0
    off, counters = _serve_rank_axis(SERVE_SPEC)
    assert counters == [0] * len(SPEC_COUNTERS)
    assert line["tokens"] == off
    _, counters = _serve_rank_axis(SERVE_SPEC, spec_gamma=GAMMA)
    assert [spec[k] for k in ("verify_steps", "proposed", "accepted",
                              "emitted")] == counters


def test_serve_launcher_spec_ep2d_equals_rank_axis(worlds):
    """The ep2d model at data size 1 with speculative decoding, packed
    over the pool (``--spec-gamma 3 --packed --lookup --comm-mode
    ring``): the ranks agree, and tokens and counters equal the rank
    axis's engine with the same scheduler (MoE tokens depend on the
    batch, so the reference is the same speculative engine)."""
    assert [int(r["rc"]) for r in worlds["serve_ep2d_spec"]] == [0, 0]
    line = json.loads(str(worlds["serve_ep2d_spec"][0]["line"]))
    assert line["ranks_agree"] and line["spec"]["packed"]
    tokens, counters = _serve_rank_axis(
        SERVES["serve_ep2d_spec"], spec_gamma=GAMMA, paged=True, packed=True)
    assert counters[0] > 0
    assert line["tokens"] == tokens
    assert [line["spec"][k] for k in ("verify_steps", "proposed",
                                      "accepted", "emitted")] == counters
