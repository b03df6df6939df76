"""K1's cross-rank form (``kernels/ar_rmsnorm_peer.py``,
``distributed/peer.py``) without a card: the host layout of the kernel's
peer pointer tables, the workspace sizing (receive slots, the one-wait
path's publish blocks, one per epoch parity), the choice of the one-wait
path, a model of the flag protocol stepped through every interleaving,
the wrapper's refusals and its device-side epoch under CUDA graph
capture, ``comm_norm(ring)`` under ``process_group`` reaching the wrapper
(never the ``fused`` composition), the row header both K1 forms include
and the build's digest over it, and ``launch.serve``'s choice of
backend.  Its numbers over a group of processes are
held in ``tests/test_torch_pg.py`` (the plain version against the jnp
oracle and the rank axis); the kernel itself in ``chip_smoke.py``'s
``k1_peer`` phase on the card.
"""
import contextlib
import ctypes
import itertools
import types

import pytest
import torch

from repro_torch.core import fused_collectives as tfc
from repro_torch.core.splitting import ring_ctas
from repro_torch.distributed.context import CommCtx, Groups
from repro_torch.kernels import ar_rmsnorm_peer as K1P
from repro_torch.runtime.scheduler import SchedulerConfig

SLOT = 3 * 256
PUB, PUB_RES = 5 * 256, 3 * 256
U64 = 8


def _bases(n):
    """Fake, distinct workspace base addresses, 1 GB apart."""
    return [(p + 1) << 30 for p in range(n)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_peer_tables_of_every_rank(n):
    """Each rank's tables follow the workspace layout (flags, N slots,
    gathered), and the ranks agree: the slot rank r pushes its chunk c
    into is the slot rank c reads r's partial from, the arrive flag r
    raises on c is the one c waits on for r, and every rank pulls rank
    p's gathered chunk after p's ready flags."""
    bases = _bases(n)
    tabs = [K1P.tables(bases, r, SLOT, PUB, PUB_RES) for r in range(n)]
    for r, tab in enumerate(tabs):
        assert tab.arrive_in == bases[r] + K1P.ARRIVE_OFFSET
        assert tab.gathered_own == bases[r] + K1P.FLAG_BYTES + n * SLOT
        assert tab.ready_own == bases[r] + K1P.READY_OFFSET
        assert tab.epoch == bases[r] + K1P.EPOCH_OFFSET
        assert (tab.pub_stride, tab.pub_res) == (PUB, PUB_RES)
        for p in range(n):
            assert tab.gathered[p] == tabs[p].gathered_own
            assert tab.ready[p] == tabs[p].ready_own
            # every rank reads rank p's publish blocks and pub flags where
            # rank p writes them
            assert tab.pub[p] == tabs[p].gathered_own + SLOT
            assert tab.pub_flag[p] == bases[p] + K1P.PUB_FLAG_OFFSET
            if p == r:
                assert (tab.push[p], tab.recv[p], tab.arrive_out[p]) == (
                    None, None, None)
                continue
            assert tab.recv[p] == bases[r] + K1P.FLAG_BYTES + p * SLOT
            assert tab.push[p] == tabs[p].recv[r]
            for b in range(K1P.MAX_CTAS):
                assert (tab.arrive_out[p] + b * K1P.MAX_RANKS * U64
                        == tabs[p].arrive_in + (b * K1P.MAX_RANKS + r) * U64)
        for p in range(n, K1P.MAX_RANKS):
            assert (tab.push[p], tab.recv[p], tab.gathered[p],
                    tab.arrive_out[p], tab.ready[p], tab.pub[p],
                    tab.pub_flag[p]) == (None,) * 7
        # the flags (arrive, ready, pub, epoch), slots, gathered and the
        # two publish blocks tile the workspace without overlap
        flags = [(K1P.ARRIVE_OFFSET, K1P.MAX_CTAS * K1P.MAX_RANKS),
                 (K1P.READY_OFFSET, K1P.MAX_CTAS),
                 (K1P.PUB_FLAG_OFFSET, K1P.MAX_CTAS),
                 (K1P.EPOCH_OFFSET, K1P.MAX_CTAS)]
        for (a, na), (b, _) in zip(flags, flags[1:] + [(K1P.FLAG_BYTES, 0)]):
            assert a + na * U64 <= b
        assert tab.pub[r] + 2 * PUB == bases[r] + K1P.workspace_bytes(
            n, SLOT, PUB)


def test_peer_tables_match_the_cuda_struct_and_refuse_bad_ranks():
    # struct PeerTables: 7 tables of 8 pointers, 4 pointers, 2 byte counts
    assert ctypes.sizeof(K1P.PeerTables) == (7 * K1P.MAX_RANKS + 6) * 8
    with pytest.raises(ValueError, match="ranks"):
        K1P.tables(_bases(9), 0, SLOT, PUB, PUB_RES)
    with pytest.raises(ValueError, match="rank 2 of 2"):
        K1P.tables(_bases(2), 2, SLOT, PUB, PUB_RES)


@pytest.mark.parametrize("rows,d,dtype,n,want", [
    (2048, 8192, torch.bfloat16, 8, 2048 // 8 * 8192 * 2),
    (2048, 8192, torch.bfloat16, 2, 1024 * 8192 * 2),
    (2048, 4096, torch.float32, 4, 512 * 4096 * 4),
    (100, 10, torch.bfloat16, 3, 768),     # 33 rows x 20 bytes, rounded up
])
def test_slot_bytes_hold_a_chunk_of_the_largest_forward(rows, d, dtype, n,
                                                        want):
    assert K1P.slot_bytes(rows, d, dtype, n) == want
    pub, _ = K1P.pub_bytes(rows, d, dtype, n)
    assert K1P.workspace_bytes(n, want, pub) == (K1P.FLAG_BYTES
                                                 + (n + 1) * want + 2 * pub)


@pytest.mark.parametrize("rows,d,dtype,n,small,x_bytes,res_bytes", [
    # T/N below 8 CTAs: 7 rows a rank, x of 7N rows, the residual's 7
    (2048, 8192, torch.bfloat16, 8, 56, 56 * 16384, 7 * 16384),
    (2048, 8192, torch.bfloat16, 2, 14, 14 * 16384, 7 * 16384),
    (2048, 4096, torch.float32, 4, 28, 28 * 16384, 7 * 16384),
    # a workspace of fewer rows publishes no more than them
    (12, 8192, torch.bfloat16, 4, 12, 12 * 16384, 3 * 16384),
    (100, 10, torch.bfloat16, 3, 21, 512, 256),     # 420 and 140 bytes
])
def test_publish_blocks_hold_a_small_call_at_each_parity(
        rows, d, dtype, n, small, x_bytes, res_bytes):
    """The one-wait path's publish block holds a rank's x of every small
    call the workspace takes and its residual chunk; the workspace holds
    two, one per parity of the call epoch."""
    assert K1P.small_rows(rows, n) == small
    assert K1P.pub_bytes(rows, d, dtype, n) == (x_bytes + res_bytes, x_bytes)
    for ctas in range(1, K1P.MAX_CTAS + 1):
        for t in range(n, rows + 1, n):
            if K1P.small_t(t, n, ctas):
                assert t <= small
    slot = K1P.slot_bytes(rows, d, dtype, n)
    assert K1P.workspace_bytes(n, slot, x_bytes + res_bytes) - (
        K1P.FLAG_BYTES + (n + 1) * slot) == 2 * (x_bytes + res_bytes)


@pytest.mark.parametrize("t,n,ctas,want", [
    (8, 8, 8, True), (56, 8, 8, True), (64, 8, 8, False),
    (8, 2, 8, True), (16, 2, 8, False), (8, 2, 4, False), (6, 2, 4, True),
    (2, 2, 1, False), (2048, 8, 8, False), (16, 4, 8, True),
    (16, 4, 2, False),
])
def test_small_t_takes_the_one_wait_path_below_the_ctas(t, n, ctas, want):
    """Decode and verify sizes (T/N below the CTA count) take one wait;
    larger T the three phases."""
    assert K1P.small_t(t, n, ctas) is want


@pytest.mark.parametrize("kw,want", [
    (dict(), 2048),                                   # the defaults
    (dict(chunk_tokens=2000, prefill_bucket=64), 2048),
    (dict(chunk_tokens=96, prefill_bucket=64, max_batch=3), 128),
    (dict(chunk_tokens=64, max_batch=16, spec_gamma=7), 128),
])
def test_max_forward_tokens(kw, want):
    assert SchedulerConfig(**kw).max_forward_tokens(tp=2) == want


def test_max_forward_tokens_pads_to_the_packed_unit():
    # the packed total is padded to lcm(prefill_bucket, tp) = 192 at tp 3
    assert SchedulerConfig(chunk_tokens=2048).max_forward_tokens(3) == 2112


def _workspace(n=2, rows=64, d=16, dtype=torch.float32):
    pub, pub_res = K1P.pub_bytes(rows, d, dtype, n)
    return types.SimpleNamespace(n=n, rank=0, rows=rows, device=torch.device(
        "cpu"), slot_bytes=K1P.slot_bytes(rows, d, dtype, n), pub_bytes=pub,
        pub_res=pub_res)


def _inputs(t=8, d=16, n=2):
    return (torch.zeros(1, t, d), torch.zeros(1, t // n, d), torch.ones(d))


@pytest.mark.parametrize("case,match", [
    ("no_workspace", "no peer workspace"),
    ("too_many_rows", "workspace holds"),
    ("ctas_0", r"ctas=0 outside \[1, 8\]"),
    ("ctas_9", r"ctas=9 outside \[1, 8\]"),
    ("ranks", "3 ranks against a workspace of 2"),
    ("residual", "residual must be"),
    ("publish", "takes the one-wait path"),
])
def test_check_inputs_refusals(case, match):
    x, res, w = _inputs()
    ws, ctas, ranks = _workspace(), 8, 2
    if case == "no_workspace":
        ws = None
    elif case == "publish":
        # 4 rows a rank fit a 4-row workspace's slots (256 bytes), but
        # its publish blocks hold only its 4 rows of x
        ws = _workspace(rows=4)
        assert K1P.small_t(8, 2, ctas)
    elif case == "too_many_rows":
        x, res, w = _inputs(t=66)
    elif case.startswith("ctas"):
        ctas = int(case[-1])
    elif case == "ranks":
        ranks = 3
    else:
        res = torch.zeros(1, 3, 16)
    with pytest.raises(ValueError, match=match):
        K1P.check_inputs(x, res, w, ws, ctas, ranks)


def test_check_inputs_takes_the_largest_forward():
    K1P.check_inputs(*_inputs(t=64), _workspace(), 1, 2)
    # and the largest one-wait call: 7 rows a rank below 8 CTAs
    K1P.check_inputs(*_inputs(t=14), _workspace(), 8, 2)
    K1P.check_inputs(*_inputs(t=4), _workspace(rows=4), 8, 2)


def test_wrapper_refuses_autograd_and_other_devices():
    x, res, w = _inputs()
    with pytest.raises(RuntimeError, match="no backward"):
        K1P.ar_rmsnorm_peer(x.requires_grad_(), res, w)
    other = types.SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(ValueError, match="no kernel for device"):
        K1P.ar_rmsnorm_peer(other, res, w)


def _pg_ctx(**kw):
    groups = Groups(model=None, data=None, model_rank=1, data_rank=0,
                    model_size=2, data_size=1)
    return CommCtx(**{"mode": "ring", "use_pallas": True, "tp": 2,
                      "backend": "process_group", "groups": groups, **kw})


def test_ring_under_process_group_takes_the_peer_kernel(monkeypatch):
    """Under ``process_group`` a ring slot goes to K1's cross-rank wrapper
    on ``ring_ctas(budget)`` CTAs, never to the ``fused`` composition;
    the reference's ladder (a post-norm, no reduction, no kernels) still
    takes ``fused``."""
    calls = []

    def peer(x, res, w, ctx, *, eps, ctas):
        calls.append((tuple(x.shape), ctx, eps, ctas))
        return x.clone(), res.clone()

    def refuse(*a, **k):
        raise AssertionError("the fused composition ran")
    monkeypatch.setattr(K1P, "ar_rmsnorm_peer", peer)
    monkeypatch.setattr(tfc.C, "psum_scatter", refuse)
    x, res, w = _inputs(t=8, d=16)
    ctx = _pg_ctx(comm_budget=0.25)
    tfc.comm_norm(x, res, w, ctx=ctx)
    assert calls == [((1, 8, 16), ctx, ctx.eps, ring_ctas(0.25))]
    monkeypatch.undo()

    ladder = []
    monkeypatch.setattr(K1P, "ar_rmsnorm_peer", refuse)
    monkeypatch.setattr(tfc.C, "psum_scatter",
                        lambda x, ctx: ladder.append("rs") or x[:, :4])
    monkeypatch.setattr(tfc.C, "token_shard_slice",
                        lambda x, ctx: ladder.append("slice") or x[:, :4])
    monkeypatch.setattr(tfc.C, "all_gather",
                        lambda x, ctx: torch.cat([x, x], dim=1))
    tfc.comm_norm(x, res, w, ctx=ctx, weight_post=w)
    tfc.comm_norm(x, res, w, ctx=ctx, reduce_input=False)
    tfc.comm_norm(x, res, w, ctx=_pg_ctx(use_pallas=False))
    assert ladder == ["rs", "slice", "rs"]


class _Fake:
    """A stand-in for a CUDA tensor: the attributes the wrapper reads."""

    def __init__(self, shape, dtype=torch.float32, ptr=0x10000):
        self.shape, self.dtype, self._ptr = tuple(shape), dtype, ptr
        self.device = torch.device("cuda", 0)
        self.requires_grad = False

    def data_ptr(self):
        return self._ptr

    def element_size(self):
        return 4


def test_wrapper_takes_the_device_epoch_under_capture(monkeypatch):
    """Under CUDA graph capture the wrapper launches as it does eagerly,
    and nothing it passes changes from call to call: the kernel reads and
    advances the call epoch in the workspace on the card (the tables point
    at it), so a captured call replayed signals a fresh epoch."""
    ws = types.SimpleNamespace(
        n=2, rank=1, rows=64, tables=K1P.tables(_bases(2), 1, SLOT, PUB,
                                                PUB_RES))
    launches = []

    class Lib:
        def ar_rmsnorm_peer(self, tab, *args):
            launches.append((bytes(tab._obj), args))
            return 0

    allocated = iter(range(0x20000, 0x30000, 0x1000))
    fake_torch = types.SimpleNamespace(
        empty=lambda shape, dtype, device: _Fake(shape, dtype,
                                                 next(allocated)),
        cuda=types.SimpleNamespace(
            device=lambda d: contextlib.nullcontext(),
            current_stream=lambda d: types.SimpleNamespace(cuda_stream=7),
            is_current_stream_capturing=lambda: True))
    monkeypatch.setattr(K1P, "torch", fake_torch)
    monkeypatch.setattr(K1P, "_lib", Lib)
    monkeypatch.setattr(K1P, "check_inputs", lambda *a, **k: None)
    monkeypatch.setattr(K1P, "pipelined", lambda *a: True)
    monkeypatch.setattr(K1P.build, "check_status",
                        lambda lib, rc, what: None)
    x, res, w = _Fake((1, 8, 16)), _Fake((1, 4, 16)), _Fake((16,))
    before = K1P.ar_rmsnorm_peer.launches
    K1P.ar_rmsnorm_peer(x, res, w, workspace=ws, ctas=8)
    K1P.ar_rmsnorm_peer(x, res, w, workspace=ws, ctas=8)
    assert K1P.ar_rmsnorm_peer.launches == before + 2
    (tab0, args0), (tab1, args1) = launches
    # the same tables both times, pointing at this rank's epoch slots
    assert tab0 == tab1 == bytes(ws.tables)
    assert ws.tables.epoch == _bases(2)[1] + K1P.EPOCH_OFFSET
    # the arguments differ only in the outputs' addresses: no host epoch
    n, rank, t, d, _, dtype, vec, small, ctas, stream = args0[5:]
    assert (n, rank, t, d, dtype, vec, small, ctas, stream) == (
        2, 1, 8, 16, 0, 1, 1, 8, 7)
    assert args0[:3] == args1[:3] and args0[5:] == args1[5:]


def test_both_k1_forms_include_one_row_body():
    """The one-card and the cross-rank K1 include the same row header, so
    their bits cannot drift apart, and neither defines the row arithmetic
    itself."""
    from repro_torch.kernels import build

    row = build.CSRC / "ar_rmsnorm_row.cuh"
    for name in ("ar_rmsnorm", "ar_rmsnorm_peer"):
        src = build.CSRC / build.SOURCES[name]
        assert build.includes(src) == [row]
        text = src.read_text()
        for helper in ("float to_f", "warp_sum(float", "from_f<float>(float"):
            assert helper not in text, (name, helper)


def test_library_name_follows_the_included_headers(tmp_path, monkeypatch):
    """An edited header rebuilds every source that includes it (directly
    or through another header), and no other."""
    from repro_torch.kernels import build

    (tmp_path / "a.cu").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text('  #  include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("// c\n")
    (tmp_path / "d.cu").write_text("#include <stdint.h>\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "SOURCES", {"a": "a.cu", "d": "d.cu"})
    assert build.includes(tmp_path / "a.cu") == [tmp_path / "b.cuh",
                                                 tmp_path / "c.cuh"]
    assert build.includes(tmp_path / "d.cu") == []
    before = {n: build.lib_path(n) for n in ("a", "d")}
    (tmp_path / "c.cuh").write_text("// c, edited\n")
    assert build.lib_path("a") != before["a"]
    assert build.lib_path("d") == before["d"]


@pytest.mark.parametrize("local_world,cards,want", [
    (1, 1, "nccl"), (2, 1, "gloo"), (4, 4, "nccl"), (8, 8, "nccl"),
    (9, 8, "gloo"), (2, 8, "nccl"),
])
def test_serve_picks_gloo_only_when_ranks_share_a_card(local_world, cards,
                                                       want):
    from repro_torch.launch import serve

    assert serve.cuda_backend(local_world, cards) == want
    assert serve.parse([]).backend is None


# --------------------------------------------------------------------------
# a model of the flag protocol (csrc/ar_rmsnorm_peer.cu), one CTA a rank
# --------------------------------------------------------------------------

def _call_steps(small: bool, rank: int, n: int, e: int, parities=2):
    """One rank's call of epoch e as the kernel orders it: ("write" or
    "read", buffer), ("raise", flag) or ("wait", flag), each tagged with
    e.  Buffers and flags are named with the rank that writes them
    first: ("slot", c, r) is rank c's receive slot of rank r."""
    peers = [p for p in range(n) if p != rank]
    if small:
        block = ("pub", rank, e % parities)
        steps = ([("write", block), ("raise", ("pub", rank))]
                 + [("wait", ("pub", p)) for p in peers]
                 + [("read", ("pub", p, e % parities)) for p in peers])
    else:
        steps = ([("write", ("slot", c, rank)) for c in peers]
                 + [("raise", ("arrive", c, rank)) for c in peers]
                 + [("wait", ("arrive", rank, p)) for p in peers]
                 + [("read", ("slot", rank, p)) for p in peers]
                 + [("write", ("gathered", rank)), ("raise", ("ready", rank))]
                 + [("wait", ("ready", p)) for p in peers]
                 + [("read", ("gathered", p)) for p in peers])
    return [(op, item, e) for op, item in steps]


def _explore(programs):
    """Step through every interleaving of the ranks' programs (a state is
    the ranks' program counters; each buffer and flag has one writer, so
    its value follows from the writer's counter).  Returns the first
    violation: a read that finds its buffer written by another call than
    its own (rewritten while this rank may still read it, or not yet
    written), or a state where no rank can move."""
    n = len(programs)
    # per rank and counter: what its executed prefix wrote (buffer or flag
    # -> the epoch of its last write)
    prefix = []
    for prog in programs:
        seen, states = {}, [{}]
        for op, item, e in prog:
            if op in ("write", "raise"):
                seen = dict(seen)
                seen[(op, item)] = e
            states.append(seen)
        prefix.append(states)

    def value(pcs, kind, item):
        owner = item[2] if item[0] in ("slot", "arrive") else item[1]
        return prefix[owner][pcs[owner]].get((kind, item), 0)

    start = (0,) * n
    todo, seen = [start], {start}
    while todo:
        pcs = todo.pop()
        moved = False
        for r in range(n):
            if pcs[r] == len(programs[r]):
                continue
            op, item, e = programs[r][pcs[r]]
            if op == "wait" and value(pcs, "raise", item) < e:
                continue
            if op == "read":
                got = value(pcs, "write", item)
                if got != e:
                    return (f"rank {r}, call {e}: reads {item} holding "
                            f"call {got}'s data")
            moved = True
            nxt = pcs[:r] + (pcs[r] + 1,) + pcs[r + 1:]
            if nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
        if not moved and any(pc < len(p) for pc, p in zip(pcs, programs)):
            return f"deadlock at {pcs}"
    return None


def _programs(ts, n, ctas=8, parities=2):
    kinds = [K1P.small_t(t, n, ctas) for t in ts]
    return [sum((_call_steps(small, r, n, e, parities)
                 for e, small in enumerate(kinds, start=1)), [])
            for r in range(n)]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("calls", list(itertools.product((1, 16), repeat=3)))
def test_flag_protocol_never_rewrites_what_a_peer_may_read(n, calls):
    """Three calls of every mix of one-wait (T = N) and three-phase (T =
    16 N) calls at N 2 and 3: in no interleaving of the ranks' steps is a
    receive slot, a gathered chunk or a publish block rewritten while a
    peer may still read it, or read before this call wrote it, and no
    interleaving deadlocks."""
    ts = [c * n for c in calls]
    assert [K1P.small_t(t, n, 8) for t in ts] == [c == 1 for c in calls]
    assert _explore(_programs(ts, n)) is None


def test_flag_protocol_model_catches_one_publish_block():
    """The model has teeth: with one publish block in place of one per
    epoch parity, a rank's next one-wait call overwrites its block while
    a peer still reads the last call's."""
    bad = _explore(_programs([2, 2, 2], 2, parities=1))
    assert bad is not None and "reads ('pub'" in bad
