"""K1's cross-rank form (``kernels/ar_rmsnorm_peer.py``,
``distributed/peer.py``) without a card: the host layout of the kernel's
peer pointer tables, the workspace sizing, the wrapper's refusals (a
CUDA graph capture among them), ``comm_norm(ring)`` under
``process_group`` reaching the wrapper (never the ``fused``
composition), the row header both K1 forms include and the build's digest
over it, and ``launch.serve``'s choice of backend.  Its numbers over a group of processes are
held in ``tests/test_torch_pg.py`` (the plain version against the jnp
oracle and the rank axis); the kernel itself in ``chip_smoke.py``'s
``k1_peer`` phase on the card.
"""
import ctypes
import types

import pytest
import torch

from repro_torch.core import fused_collectives as tfc
from repro_torch.core.splitting import ring_ctas
from repro_torch.distributed.context import CommCtx, Groups
from repro_torch.kernels import ar_rmsnorm_peer as K1P
from repro_torch.runtime.scheduler import SchedulerConfig

SLOT = 3 * 256
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
    tabs = [K1P.tables(bases, r, SLOT) for r in range(n)]
    for r, tab in enumerate(tabs):
        assert tab.arrive_in == bases[r] + K1P.ARRIVE_OFFSET
        assert tab.gathered_own == bases[r] + K1P.FLAG_BYTES + n * SLOT
        assert tab.ready_own == bases[r] + K1P.READY_OFFSET
        for p in range(n):
            assert tab.gathered[p] == tabs[p].gathered_own
            assert tab.ready[p] == tabs[p].ready_own
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
                    tab.arrive_out[p], tab.ready[p]) == (None,) * 5
        # flags, slots and gathered tile the workspace without overlap
        assert K1P.READY_OFFSET >= K1P.MAX_CTAS * K1P.MAX_RANKS * U64
        assert K1P.READY_OFFSET + K1P.MAX_CTAS * U64 <= K1P.FLAG_BYTES
        assert tab.gathered_own + SLOT == bases[r] + K1P.workspace_bytes(
            n, SLOT)


def test_peer_tables_match_the_cuda_struct_and_refuse_bad_ranks():
    # struct PeerTables: 5 tables of 8 pointers and 3 pointers
    assert ctypes.sizeof(K1P.PeerTables) == (5 * K1P.MAX_RANKS + 3) * 8
    with pytest.raises(ValueError, match="ranks"):
        K1P.tables(_bases(9), 0, SLOT)
    with pytest.raises(ValueError, match="rank 2 of 2"):
        K1P.tables(_bases(2), 2, SLOT)


@pytest.mark.parametrize("rows,d,dtype,n,want", [
    (2048, 8192, torch.bfloat16, 8, 2048 // 8 * 8192 * 2),
    (2048, 8192, torch.bfloat16, 2, 1024 * 8192 * 2),
    (2048, 4096, torch.float32, 4, 512 * 4096 * 4),
    (100, 10, torch.bfloat16, 3, 768),     # 33 rows x 20 bytes, rounded up
])
def test_slot_bytes_hold_a_chunk_of_the_largest_forward(rows, d, dtype, n,
                                                        want):
    assert K1P.slot_bytes(rows, d, dtype, n) == want
    assert K1P.workspace_bytes(n, want) == K1P.FLAG_BYTES + (n + 1) * want


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
    return types.SimpleNamespace(n=n, rank=0, rows=rows, device=torch.device(
        "cpu"), slot_bytes=K1P.slot_bytes(rows, d, dtype, n))


def _inputs(t=8, d=16, n=2):
    return (torch.zeros(1, t, d), torch.zeros(1, t // n, d), torch.ones(d))


@pytest.mark.parametrize("case,match", [
    ("no_workspace", "no peer workspace"),
    ("too_many_rows", "workspace holds"),
    ("ctas_0", r"ctas=0 outside \[1, 8\]"),
    ("ctas_9", r"ctas=9 outside \[1, 8\]"),
    ("ranks", "3 ranks against a workspace of 2"),
    ("residual", "residual must be"),
])
def test_check_inputs_refusals(case, match):
    x, res, w = _inputs()
    ws, ctas, ranks = _workspace(), 8, 2
    if case == "no_workspace":
        ws = None
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


def test_wrapper_refuses_cuda_graph_capture(monkeypatch):
    """A captured call would replay its host-drawn epoch, which the flags
    already hold: the wrapper raises under capture, before it touches the
    workspace."""
    x = types.SimpleNamespace(device=torch.device("cuda"))
    _, res, w = _inputs()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        K1P.ar_rmsnorm_peer(x, res, w)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    with pytest.raises(ValueError, match="no peer workspace"):
        K1P.ar_rmsnorm_peer(x, res, w)


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
