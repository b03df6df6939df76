"""Training over process groups (one (pod, data, model) rank per process,
gloo on the CPU), held to the rank axis on the same seed.

One world of 4 processes is spawned once for the module
(``spawn_world``: ``torch.multiprocessing.spawn`` without PYTHONPATH,
one intra-op thread, a timeout) and runs, on the meshes (data 2, model
2) and (pod 2, data 1, model 2):

- every collective's forward and backward (``distributed/
  collectives.py``) on seeded inputs and cotangents, against autograd
  through the rank axis's form: float32 within 1e-6 relative;
- both train steps with the weave on (its splits forced by
  ``tokenweave_min_tokens``) in comm modes vanilla, reordered, fused and
  nocomm, 2 steps each from one seed: losses within 1e-5 relative,
  params within 2e-4 of max(1, a leaf's largest magnitude)
  (``test_torch_training.close_tree``'s bound), each process's ZeRO-1
  chunk of ``m`` / ``v`` within the same bound of its slice of the rank
  axis's, its bytes those ``zero_specs`` gives; the manual step with the
  int8 pod reduce by its losses and its first reduce's inputs replayed
  through the rank axis's ``compressed_psum``: bit-equal;
  the launcher's gathered checkpoint equal to the rank axis's layout and
  cut back to each process's state bit for bit;
- ``launch.train`` over groups on the reduced Gemma3-1B: a run that
  fails at step 3, its resume and an uninterrupted run (final losses
  within 1e-3 relative); the groups run's checkpoint resumed by a
  one-process rank-axis run and a rank-axis checkpoint resumed over
  groups;
- every other family (``FAMILIES``: MoE ``expert``, ``ffn`` and
  ``ep2d``, vlm, ssm, hybrid, encdec; reduced configs) in comm mode
  fused with the weave on: both train steps, 2 steps each (``ep2d`` on
  (data 2, model 2), the others on (pod 2, data 1, model 2), the ssm's
  manual step with the int8 pod reduce too), held to the rank axis at
  the bounds above, with every rank issuing the same collectives and
  the ZeRO-1 chunks' bytes; the ``all_to_all`` over the data group
  forward and backward at 1e-6; ``launch.train --arch NAME`` over groups
  for each, 2 steps and a resume to 3, its losses within 1e-3 of the
  rank axis's run.

- ``ep2d`` under a pod axis (the reduced qwen3-moe-235b-a22b at (pod
  2, data 2, model 1): experts over data alone, the batch over pod x
  data): both train steps held to the rank axis at the bounds above,
  the ZeRO-1 chunks of its expert leaves over the pod group alone, and
  ``launch.train --mesh 2x2x1`` over groups, 2 steps and a resume to 3.

The rank axis's side runs here while the world runs.  The refusal
(``ring`` under a gradient) needs no world.
``tests/test_torch_train_steps.py`` spawns its own world with
``spawn_world`` and ``replay_reference`` to hold the steps over groups to
the JAX reference.  This file imports neither jax nor the reference: the
spawned processes import it.
"""
import contextlib
import io
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._pytree import tree_flatten

from repro_torch import weights as W
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.core import fused_collectives as tfc
from repro_torch.distributed import collectives as TCL
from repro_torch.distributed.context import CommCtx, Groups
from repro_torch.launch import train as driver
from repro_torch.launch.mesh import init_groups, make_mesh
from repro_torch.models import transformer as TT
from repro_torch.models.build import build_model
from repro_torch.training import compression as TC
from repro_torch.training import optimizer as TO
from repro_torch.training.data import SyntheticLM, family_inputs
from repro_torch.training.train_step import (make_manual_sync_train_step,
                                             make_train_step, state_specs)

WORLD = 4
TIMEOUT_S = 600
COLL_RTOL = 1e-6
LOSS_RTOL, NORM_RTOL, PARAM_TOL, RESUME_RTOL = 1e-5, 1e-4, 2e-4, 1e-3
MESHES = {"d2m2": ((2, 2), ("data", "model")),
          "p2d1m2": ((2, 1, 2), ("pod", "data", "model"))}
# ep2d under a pod axis: experts over data alone, the batch over pod x data
POD_MESH = "p2d2m1"
ALL_MESHES = dict(MESHES, **{POD_MESH: ((2, 2, 1), ("pod", "data",
                                                    "model"))})
POD_EP2D = ("qwen3-moe-235b-a22b", ("auto", "manual"))
MODES = ("vanilla", "reordered", "fused", "nocomm")
BUILDERS = {"d2m2": ("auto", "manual"),
            "p2d1m2": ("auto", "manual", "int8")}   # int8: the pod reduce
CFG = dict(name="tiny", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
           vocab_size=125, dtype="float32")   # 125: the vocab is padded
SEED, STEPS, BATCH, SEQ = 3, 2, 4, 32
# every family but dense, reduced: name -> (mesh, builders); int8: the
# pod reduce for one non-dense family
FAMILIES = {"olmoe-1b-7b": ("p2d1m2", ("auto", "manual")),
            "mixtral-8x22b": ("p2d1m2", ("auto", "manual")),
            "qwen3-moe-235b-a22b": ("d2m2", ("auto", "manual")),
            "qwen2-vl-7b": ("p2d1m2", ("auto", "manual")),
            "falcon-mamba-7b": ("p2d1m2", ("auto", "manual", "int8")),
            "zamba2-7b": ("p2d1m2", ("auto", "manual")),
            "whisper-base": ("p2d1m2", ("auto", "manual"))}


# --------------------------------------------------------------------------
# spawning a world
# --------------------------------------------------------------------------

def spawn_world(fn, args, nprocs: int = WORLD, timeout: float = TIMEOUT_S,
                while_running=None):
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes, started
    without PYTHONPATH (src/sitecustomize.py would load jax in them; they
    get src/ through this process's sys.path); ``while_running()`` runs
    here meanwhile and its result is returned.  A failing process, or the
    world outliving ``timeout`` seconds, kills every process and
    raises."""
    saved = os.environ.pop("PYTHONPATH", None)
    try:
        ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    finally:
        if saved is not None:
            os.environ["PYTHONPATH"] = saved
    deadline = time.monotonic() + timeout
    try:
        got = while_running() if while_running is not None else None
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the world of {nprocs} outlived "
                                   f"{timeout} s")
        return got
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def _groups(mesh: str, rank: int, tmp, tag: str = ""):
    shape, axes = ALL_MESHES[mesh]
    return init_groups(make_mesh(shape, axes), backend="gloo",
                       init_method=f"file://{tmp}/store_{mesh}{tag}",
                       rank=rank, world_size=WORLD)


def _flat(tree) -> list:
    return [t.detach().clone() for t in tree_flatten(tree)[0]]


# --------------------------------------------------------------------------
# collectives: forward and backward against the rank axis's autograd
# --------------------------------------------------------------------------

COLLECTIVES = ("psum", "psum_scatter", "all_gather", "gather_ranks",
               "token_shard_slice", "psum_dp", "pmax")


def _coll_case(name: str, tp: int, dp: int):
    """(x: every rank's (or data shard's) input, g: every process's
    cotangent, seeded) for one collective; x (R, ...) or (D, ...)."""
    rng = np.random.RandomState(7 + COLLECTIVES.index(name))

    def rnd(*shape):
        a = rng.randn(*shape).astype(np.float32)
        return a * np.exp2(rng.randint(-4, 4, size=shape)).astype(np.float32)
    t, d = 4 * tp, 6
    x = {"psum": (tp, t, d), "psum_scatter": (tp, t, d),
         "all_gather": (tp, t // tp, d), "gather_ranks": (tp, 3, d),
         "token_shard_slice": (tp, t, d), "psum_dp": (dp, 5),
         "pmax": (tp, t, d)}[name]
    g = {"psum": (tp, t, d), "psum_scatter": (tp, t // tp, d),
         "all_gather": (tp, t, d), "gather_ranks": (tp, tp, 3, d),
         "token_shard_slice": (tp, t // tp, d), "psum_dp": (dp, 5),
         "pmax": (tp, t, d)}[name]
    return rnd(*x), rnd(*g)


def _coll_apply(name: str, x, ctx):
    return getattr(TCL, name)(x, ctx)


def _case_collectives(groups, out, mesh: str):
    tp, r, q = groups.model_size, groups.model_rank, groups.dp_rank
    ctx = CommCtx(tp=tp, dp=groups.dp_size, backend="process_group",
                  groups=groups)
    for name in COLLECTIVES:
        x, g = _coll_case(name, tp, groups.dp_size)
        mine = torch.from_numpy(x[q if name == "psum_dp" else r][None])
        mine.requires_grad_(True)
        y = _coll_apply(name, mine, ctx)
        out[f"{mesh}/coll/{name}/out"] = y.detach()
        if name == "pmax":
            out[f"{mesh}/coll/{name}/grad_free"] = not y.requires_grad
            continue
        cot = torch.from_numpy(g[q if name == "psum_dp" else r])
        (gx,) = torch.autograd.grad(y, mine, cot.reshape(y.shape))
        out[f"{mesh}/coll/{name}/grad"] = gx


def _coll_rank_axis(name: str, tp: int, dp: int):
    """The rank axis's (out, input grad): the collective over dim 0 under
    autograd, its output's cotangent the sum of the processes' shares
    where the output is the same on every rank (a sum, a gathered tensor,
    each process holding its share)."""
    x, g = _coll_case(name, tp, dp)
    xt = torch.from_numpy(x).requires_grad_(True)
    # one data shard's rows, as a process holds them
    ctx = CommCtx(tp=tp, dp=dp if name == "psum_dp" else 1)
    y = _coll_apply(name, xt, ctx)
    if name == "pmax":
        return y.detach(), None
    cot = torch.from_numpy(g)
    if name in ("psum", "gather_ranks"):
        cot = cot.sum(dim=0)
    (gx,) = torch.autograd.grad(y, xt, cot.reshape(y.shape))
    return y.detach(), gx


def _coll_a2a_rank_axis():
    """The rank axis's ``all_to_all`` of the d2m2 data shards under
    autograd: (out, input grad), (1, D, N, d) each."""
    x, g = _a2a_case(2)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = TCL.all_to_all(xt, CommCtx(tp=2, dp=2))
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    return y.detach(), gx


# --------------------------------------------------------------------------
# the train steps
# --------------------------------------------------------------------------

def _pcfg(mode: str, mesh: str):
    pod = len(ALL_MESHES[mesh][0]) == 3
    return tbase.ParallelConfig(
        comm_mode=mode, tokenweave=True, remat=True, split_unit=16,
        tokenweave_min_tokens=32, use_pallas_norm=True, attn_impl="pallas",
        dp_axes=("pod", "data") if pod else ("data",),
        grad_compression="int8" if pod else "none")


def _steps(api, mesh: str, builder: str):
    """``STEPS`` steps of a builder from SEED -> (losses, norms, state)."""
    shape, axes = ALL_MESHES[mesh]
    m = make_mesh(shape, axes)
    ocfg = TO.AdamWConfig(lr=1e-2, warmup_steps=5)
    if builder == "auto":
        step, init = make_train_step(api, m, None, ocfg, dp_size=api.ep)
    else:
        step, init = make_manual_sync_train_step(
            api, m, None, ocfg, compress_pod=builder == "int8")
    state = list(init(SEED, device="cpu"))
    data = SyntheticLM(vocab=api.cfg.vocab_size, seq_len=SEQ,
                       global_batch=BATCH)
    losses, norms = [], []
    for i in range(STEPS):
        got = step(*state, family_inputs(api.cfg, data.batch(i), i))
        state = [got[0], got[1], *got[3:]]
        losses.append(float(got[2]["loss"]))
        norms.append(float(got[2]["grad_norm"]))
    return losses, norms, state


class _Int8Spy:
    """The first ``compress_grads`` call's inputs and outputs, flattened,
    with each leaf's ``keep`` dims."""

    def __enter__(self):
        self.real, self.first = TC.compress_grads, None

        def spy(grads, ef, specs=None, group=None):
            got = self.real(grads, ef, specs, group)
            if self.first is None:
                keep = [tuple(i for i, a in enumerate(s) if a is not None)
                        for s in tree_flatten(specs, is_leaf=lambda v:
                                              isinstance(v, tuple))[0]]
                self.first = {"x": _flat(grads), "e": _flat(ef),
                              "reduced": _flat(got[0]),
                              "e_new": _flat(got[1]), "keep": keep}
            return got
        TC.compress_grads = spy
        return self

    def __exit__(self, *exc):
        TC.compress_grads = self.real
        return False


class _CollectiveLog:
    """Every ``torch.distributed`` collective the block issues: (name,
    shape, dtype, group size), in order."""
    NAMES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
             "all_to_all_single")

    def __enter__(self):
        self.calls, self.saved = [], {n: getattr(dist, n) for n in self.NAMES}
        for name, real in self.saved.items():
            def logged(*args, _name=name, _real=real, **kw):
                t = args[0] if args else kw["tensor"]
                self.calls.append((_name, tuple(t.shape), str(t.dtype),
                                   dist.get_world_size(kw.get("group"))))
                return _real(*args, **kw)
            setattr(dist, name, logged)
        return self

    def __exit__(self, *exc):
        for name, real in self.saved.items():
            setattr(dist, name, real)
        return False


def _case_steps(groups, out, mesh: str):
    cfg = tbase.ModelConfig(**CFG)
    for mode in MODES:
        for builder in BUILDERS[mesh]:
            key = f"{mesh}/{mode}/{builder}"
            api = build_model(cfg, _pcfg(mode, mesh), tp=groups.model_size,
                              ep=groups.dp_size, groups=groups)
            with _Int8Spy() as spy, _CollectiveLog() as log:
                losses, norms, state = _steps(api, mesh, builder)
            out[key] = {"loss": losses, "gnorm": norms,
                        "params": _flat(state[0]), "m": _flat(state[1]["m"]),
                        "v": _flat(state[1]["v"]), "int8": spy.first,
                        "collectives": log.calls}
            if mode != "fused" or builder == "manual":
                continue
            # the launcher's checkpoint: gathered, then cut back
            full = driver.to_checkpoint(state, cfg, api.pcfg, api,
                                        zero=builder == "auto")
            back = driver.from_checkpoint(full, cfg, api.pcfg, "cpu", api,
                                          zero=builder == "auto")
            out[key]["ckpt"] = _flat(full)
            out[key]["ckpt_back"] = all(
                torch.equal(a, b) for a, b in zip(_flat(back),
                                                  _flat(state)))


def _case_families(groups, out, mesh: str):
    """Every family of ``FAMILIES`` on this mesh: its builders' steps,
    collectives and (int8) first pod reduce."""
    for name, (at, builders) in FAMILIES.items():
        if at != mesh:
            continue
        cfg = get_config(name).reduced()
        for builder in builders:
            api = build_model(cfg, _pcfg("fused", mesh),
                              tp=groups.model_size, ep=groups.dp_size,
                              groups=groups)
            with _Int8Spy() as spy, _CollectiveLog() as log:
                losses, norms, state = _steps(api, mesh, builder)
            out[f"{name}/{builder}"] = {
                "loss": losses, "gnorm": norms, "params": _flat(state[0]),
                "m": _flat(state[1]["m"]), "v": _flat(state[1]["v"]),
                "int8": spy.first, "collectives": log.calls}


def _case_pod_ep2d(groups, out):
    """``POD_EP2D``'s builders at (pod 2, data 2, model 1): each process
    holds its data rank's experts, the same in both pods."""
    name, builders = POD_EP2D
    cfg = get_config(name).reduced()
    for builder in builders:
        api = build_model(cfg, _pcfg("fused", POD_MESH), tp=1,
                          ep=groups.dp_size, groups=groups)
        with _CollectiveLog() as log:
            losses, norms, state = _steps(api, POD_MESH, builder)
        out[f"pod/{name}/{builder}"] = {
            "loss": losses, "gnorm": norms, "params": _flat(state[0]),
            "m": _flat(state[1]["m"]), "v": _flat(state[1]["v"]),
            "collectives": log.calls}


def _a2a_case(dp: int):
    """(x, g): every data shard's (1, N, d) rows and cotangent, seeded."""
    rng = np.random.RandomState(29)
    return (rng.randn(1, dp, 4 * dp, 6).astype(np.float32),
            rng.randn(1, dp, 4 * dp, 6).astype(np.float32))


def _case_all_to_all(groups, out):
    """``all_to_all`` over the data group, forward and backward."""
    ctx = CommCtx(tp=groups.model_size, dp=groups.dp_size,
                  backend="process_group", groups=groups)
    x, g = _a2a_case(groups.dp_size)
    q = groups.data_rank
    mine = torch.from_numpy(x[:, q:q + 1]).requires_grad_(True)
    y = TCL.all_to_all(mine, ctx)
    (gx,) = torch.autograd.grad(y, mine, torch.from_numpy(g[:, q:q + 1]))
    out["a2a"] = (y.detach(), gx)


def _like(tree, like):
    """``tree`` (dicts keyed as the reference sorts them) in ``like``'s
    key order."""
    if isinstance(like, dict):
        return {k: _like(tree[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [_like(t, v) for t, v in zip(tree, like)]
    return tree


def replay_reference(rank: int, tmp, cfg_kw: dict, pcfg_kw: dict,
                     steps: int):
    """``tests/test_torch_train_steps.py``'s world: at (pod 2, data 1,
    model 2) each process replays the reference's ``auto``, ``manual``
    and ``int8`` steps from its slice of the reference's initial params
    (``tmp``/init.pt, the reference's tree) on the same batches, and
    writes its losses, grad norms and final params."""
    from repro_torch.weights import from_jax_params
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    groups = _groups("p2d1m2", rank, tmp)
    cfg = tbase.ModelConfig(**cfg_kw)
    pcfg = tbase.ParallelConfig(**pcfg_kw)
    api = build_model(cfg, pcfg, tp=2, ep=2, groups=groups)
    mesh = make_mesh(*MESHES["p2d1m2"])
    init_tree = torch.load(tmp / "init.pt", weights_only=False)
    ocfg = TO.AdamWConfig(lr=1e-2, warmup_steps=5)
    data = SyntheticLM(vocab=cfg.vocab_size, seq_len=32, global_batch=4)
    out = {"coords": (groups.pod_rank, groups.model_rank)}
    for variant in ("auto", "manual", "int8"):
        if variant == "auto":
            step, init = make_train_step(api, mesh, None, ocfg, dp_size=2)
        else:
            step, init = make_manual_sync_train_step(
                api, mesh, None, ocfg, compress_pod=variant == "int8")
        state = list(init(0, device="cpu"))
        # the reference's weights in the structure init gave the state
        state[0] = _like(from_jax_params(init_tree, cfg, pcfg,
                                         device="cpu",
                                         rank=groups.model_rank), state[0])
        losses, norms = [], []
        for i in range(steps):
            got = step(*state, data.batch(i))
            state = [got[0], got[1], *got[3:]]
            losses.append(float(got[2]["loss"]))
            norms.append(float(got[2]["grad_norm"]))
        out[variant] = {"loss": losses, "gnorm": norms,
                        "params": state[0]}
    dist.destroy_process_group()
    torch.save(out, tmp / f"replay_r{rank}.pt")


# --------------------------------------------------------------------------
# the driver over groups
# --------------------------------------------------------------------------

DRIVER = ["--reduced", "--mesh", "2x1x2", "--steps", "4", "--batch", "4",
          "--seq", "32", "--device", "cpu"]
DRIVER_FAIL = 3


def _drive(argv) -> tuple:
    """``launch.train.main`` here: (exit code, its standard output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = driver.main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, buf.getvalue()


def _final_loss(text: str) -> float:
    lines = [ln for ln in text.splitlines() if ln.startswith("[train] step")]
    return float(lines[-1].split("loss")[1].split()[0])


def _case_driver(rank: int, tmp, out):
    """Over groups: fail at DRIVER_FAIL, resume, an uninterrupted run,
    and a resume of the rank axis's checkpoint (``axis_fail``, copied)."""
    runs = (("fail", "fail", ["--fail-at-step", str(DRIVER_FAIL)]),
            ("resume", "fail", []), ("clean", "clean", []),
            ("from_axis", "axis_fail_copy", []))
    for name, ckpt, extra in runs:
        rc, text = _drive(DRIVER + extra + [
            "--ckpt-dir", str(tmp / ckpt), "--rank", str(rank),
            "--world-size", str(WORLD), "--init-method",
            f"file://{tmp}/store_driver_{name}"])
        out[f"driver/{name}"] = (rc, text)
        if name == "fail" and rank == 0:
            shutil.copytree(tmp / "fail", tmp / "fail_copy")


def _family_argv(name: str, steps: int, ckpt) -> list:
    mesh = "2x2" if FAMILIES[name][0] == "d2m2" else "2x1x2"
    return ["--arch", name, "--reduced", "--mesh", mesh, "--steps",
            str(steps), "--batch", "4", "--seq", "32", "--device", "cpu",
            "--ckpt-dir", str(ckpt)]


def _pod_argv(steps: int, ckpt) -> list:
    return ["--arch", POD_EP2D[0], "--reduced", "--mesh", "2x2x1",
            "--steps", str(steps), "--batch", "4", "--seq", "32",
            "--device", "cpu", "--ckpt-dir", str(ckpt)]


def _case_family_driver(rank: int, tmp, out):
    """``launch.train --arch NAME`` over groups for every family: 2 steps,
    then a resume to 3 from its gathered checkpoint."""
    for name in FAMILIES:
        for steps in (2, 3):
            out[f"driver/{name}/{steps}"] = _drive(
                _family_argv(name, steps, tmp / f"fam_{name}") + [
                    "--rank", str(rank), "--world-size", str(WORLD),
                    "--init-method", f"file://{tmp}/store_{name}_{steps}"])
    for steps in (2, 3):
        out[f"driver/pod/{steps}"] = _drive(_pod_argv(steps, tmp / "pod") + [
            "--rank", str(rank), "--world-size", str(WORLD),
            "--init-method", f"file://{tmp}/store_pod_{steps}"])


def _world(rank: int, tmp):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    out = {}
    for mesh in MESHES:
        groups = _groups(mesh, rank, tmp)
        out[f"{mesh}/coords"] = (groups.pod_rank, groups.data_rank,
                                 groups.model_rank, groups.dp_rank)
        _case_collectives(groups, out, mesh)
        if mesh == "d2m2":
            _case_all_to_all(groups, out)
        _case_steps(groups, out, mesh)
        _case_families(groups, out, mesh)
        dist.destroy_process_group()
    groups = _groups(POD_MESH, rank, tmp)
    out[f"{POD_MESH}/coords"] = (groups.pod_rank, groups.data_rank,
                                 groups.model_rank, groups.dp_rank)
    _case_pod_ep2d(groups, out)
    dist.destroy_process_group()
    _case_driver(rank, tmp, out)
    _case_family_driver(rank, tmp, out)
    torch.save(out, tmp / f"r{rank}.pt")


def _rank_axis(tmp):
    """The rank axis's side, computed while the world runs."""
    cfg = tbase.ModelConfig(**CFG)
    got = {}
    for mesh, (shape, axes) in MESHES.items():
        tp, dp = shape[-1], int(np.prod(shape[:-1]))
        for name in COLLECTIVES:
            got[f"{mesh}/coll/{name}"] = _coll_rank_axis(name, tp, dp)
        for mode in MODES:
            for builder in BUILDERS[mesh]:
                api = build_model(cfg, _pcfg(mode, mesh), tp=tp, ep=dp)
                losses, norms, state = _steps(api, mesh, builder)
                key = f"{mesh}/{mode}/{builder}"
                got[key] = {"loss": losses, "gnorm": norms, "state": state,
                            "api": api}
                if mode == "fused" and builder != "manual":
                    got[key]["ckpt"] = _flat(driver.to_checkpoint(
                        state, cfg, api.pcfg))
    for name, (mesh, builders) in FAMILIES.items():
        shape, _ = MESHES[mesh]
        fcfg = get_config(name).reduced()
        for builder in builders:
            api = build_model(fcfg, _pcfg("fused", mesh), tp=shape[-1],
                              ep=int(np.prod(shape[:-1])))
            losses, norms, state = _steps(api, mesh, builder)
            got[f"{name}/{builder}"] = {"loss": losses, "gnorm": norms,
                                        "state": state, "api": api}
        for steps in (2, 3):
            got[f"driver/{name}/{steps}"] = _drive(_family_argv(
                name, steps, tmp / f"axis_fam_{name}"))
    name, builders = POD_EP2D
    for builder in builders:
        api = build_model(get_config(name).reduced(),
                          _pcfg("fused", POD_MESH), tp=1, ep=4, pods=2)
        losses, norms, state = _steps(api, POD_MESH, builder)
        got[f"pod/{name}/{builder}"] = {"loss": losses, "gnorm": norms,
                                        "state": state, "api": api}
    for steps in (2, 3):
        got[f"driver/pod/{steps}"] = _drive(_pod_argv(steps,
                                                      tmp / "axis_pod"))
    got["a2a"] = _coll_a2a_rank_axis()
    return got


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the world once (the rank axis's side and its driver runs
    meanwhile) -> {"ranks": [rank 0's results, ...], "axis": the rank
    axis's, "tmp": the world's directory}."""
    tmp = tmp_path_factory.mktemp("pg_train")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # the rank axis's checkpoint that the world resumes
        rc, _ = _drive(DRIVER + ["--ckpt-dir", str(tmp / "axis_fail"),
                                 "--fail-at-step", str(DRIVER_FAIL)])
        assert rc == 42
        shutil.copytree(tmp / "axis_fail", tmp / "axis_fail_copy")
        axis = spawn_world(_world, (tmp,), while_running=lambda: dict(
            _rank_axis(tmp),
            clean=_drive(DRIVER + ["--ckpt-dir", str(tmp / "axis_clean")]),
            resume=_drive(DRIVER + ["--ckpt-dir", str(tmp / "axis_fail")])))
    finally:
        torch.set_num_threads(n)
    ranks = [torch.load(tmp / f"r{w}.pt", weights_only=False)
             for w in range(WORLD)]
    return {"ranks": ranks, "axis": axis, "tmp": tmp}


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

def _close(got, want, tol):
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape
    if not want.numel():             # a ZeRO-1 chunk another rank owns
        return
    err = float((got - want).abs().max()) / max(1.0,
                                                float(want.abs().max()))
    assert err <= tol, err


@pytest.mark.parametrize("mesh", list(MESHES))
def test_groups_coordinates(world, mesh):
    """World rank = (pod · data + data index) · model + model index; the
    data-parallel rank pod-major."""
    shape, _ = MESHES[mesh]
    n_pod, n_data, n_model = (1,) * (3 - len(shape)) + shape
    for w, r in enumerate(world["ranks"]):
        p, d, m, q = r[f"{mesh}/coords"]
        assert (p * n_data + d) * n_model + m == w
        assert q == p * n_data + d


@pytest.mark.parametrize("name", COLLECTIVES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_collective_backward_matches_rank_axis(world, mesh, name):
    """Each process's output and input gradient against its slice of the
    rank axis's (the data shard's for ``psum_dp``), float32 within 1e-6
    relative; ``pmax`` carries no gradient."""
    y_axis, g_axis = world["axis"][f"{mesh}/coll/{name}"]
    for r in world["ranks"]:
        _, _, m, q = r[f"{mesh}/coords"]
        y = r[f"{mesh}/coll/{name}/out"]
        if name == "pmax":
            assert r[f"{mesh}/coll/{name}/grad_free"]
        i = q if name == "psum_dp" else m
        want = {"psum": y_axis, "pmax": y_axis,
                "gather_ranks": y_axis}.get(name)
        if want is None:
            want = y_axis[i:i + 1]
        np.testing.assert_allclose(y.numpy().reshape(want.shape),
                                   want.numpy(), rtol=COLL_RTOL,
                                   atol=COLL_RTOL * float(want.abs().max()))
        if name == "pmax":
            continue
        gx = r[f"{mesh}/coll/{name}/grad"]
        np.testing.assert_allclose(
            gx.numpy()[0], g_axis[i].numpy(), rtol=COLL_RTOL,
            atol=COLL_RTOL * float(g_axis.abs().max()))


def test_the_weave_splits_the_steps():
    """The steps' forwards split: each data-parallel shard's rows (2 x 32
    tokens) cut by the weave at tokenweave_min_tokens 32."""
    info = TT.weave_decision_info(BATCH // 2, SEQ, tp=2,
                                  pcfg=_pcfg("fused", "d2m2"))
    assert info.weave and info.split is not None


def _step_cases():
    return [(mesh, mode, b) for mesh in MESHES for mode in MODES
            for b in BUILDERS[mesh] if b != "int8"]


@pytest.mark.parametrize("mesh,mode,builder", _step_cases())
def test_steps_over_groups_match_rank_axis(world, mesh, mode, builder):
    """Losses within 1e-5 relative, grad norms within 1e-4, every
    process's params after the steps within 2e-4 of its slice of the rank
    axis's.  The int8 step is held by its reduce (bit-equal on the same
    inputs, below) and its losses: its quantizer is discontinuous, and
    the groups sum each gradient in another order than the rank axis's
    one backward over the folded batch, so an element on a rounding edge
    may quantize one step apart (one such element moved a param by
    lr x warm-up = 2e-3 in comm mode nocomm)."""
    key = f"{mesh}/{mode}/{builder}"
    ax = world["axis"][key]
    cfg = tbase.ModelConfig(**CFG)
    for r in world["ranks"]:
        got = r[key]
        np.testing.assert_allclose(got["loss"], ax["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["gnorm"], ax["gnorm"], rtol=NORM_RTOL)
        _, _, m, _ = r[f"{mesh}/coords"]
        want = tree_flatten(W.take_rank(ax["state"][0], m, cfg))[0]
        assert len(want) == len(got["params"])
        for a, b in zip(got["params"], want):
            _close(a, b, PARAM_TOL)


@pytest.mark.parametrize("mesh,mode,builder", _step_cases())
def test_every_rank_issues_the_same_collectives(world, mesh, mode, builder):
    """Every process issues the same collectives in the same order (name,
    shape, dtype, group size), the backward's and the optimizer's among
    them: autograd orders the weave's two independent splits alike
    everywhere, and a remat layer recomputes alike (a rank that did not
    would hang its group or mix its tensors)."""
    key = f"{mesh}/{mode}/{builder}"
    calls = [r[key]["collectives"] for r in world["ranks"]]
    assert all(c == calls[0] for c in calls)
    names = {c[0] for c in calls[0]}
    assert "all_reduce" in names
    if mode in ("reordered", "fused"):
        assert {"reduce_scatter_tensor", "all_gather_into_tensor"} <= names


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero1_chunks_match_rank_axis_state(world, mesh, mode):
    """The auto step's ``m`` / ``v``: each process holds its data-parallel
    chunk of its model rank's slice of the rank axis's state (within the
    params' bound), and its bytes are what ``zero_specs`` gives a device
    (the reference's layout: a leaf's bytes over its spec's model and
    data-parallel axes)."""
    _check_zero1(world, f"{mesh}/{mode}/auto", tbase.ModelConfig(**CFG),
                 mesh)


def _check_zero1(world, key: str, cfg, mesh: str):
    ax = world["axis"][key]
    api = ax["api"]
    params, opt = ax["state"][0], ax["state"][1]
    shape, _ = ALL_MESHES[mesh]
    tp, dp = shape[-1], int(np.prod(shape[:-1]))
    pods = shape[0] if len(shape) == 3 else 1
    _, ospec = state_specs(api, params, dp)
    ref = W.to_jax_layout(params, cfg, api.pcfg)
    want_bytes = 0
    for t, spec in zip(tree_flatten(ref)[0], tree_flatten(
            ospec["m"], is_leaf=lambda s: isinstance(s, tuple))[0]):
        n = t.numel() * 4
        for e in spec:
            axes = e if isinstance(e, tuple) else (e,)
            n //= int(np.prod([{"model": tp, "pod": shape[0] if
                                len(shape) == 3 else 1,
                                "data": shape[-2]}.get(a, 1) for a in axes]))
        want_bytes += n
    for r in world["ranks"]:
        _, d, m, q = r[f"{mesh}/coords"]
        mine = W.take_rank(params, m, cfg, data_rank=d)
        dims = W.zero_dims(mine, cfg, api.pcfg, dp)
        for k in ("m", "v"):
            got = r[key][k]
            want = tree_flatten(W.take_chunk(W.take_rank(
                opt[k], m, cfg, data_rank=d), dims, q, dp, pods))[0]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.shape == b.shape
                _close(a, b, PARAM_TOL)
            assert sum(t.numel() * t.element_size() for t in got) \
                == want_bytes
    assert want_bytes < sum(t.numel() * 4 for t in tree_flatten(ref)[0]) \
        // tp


@pytest.mark.parametrize("mode", MODES)
def test_int8_pod_reduce_is_bit_equal_to_rank_axis(world, mode):
    """The first int8 pod reduce of the manual step at (pod 2, data 1,
    model 2): each model rank's two pods' inputs stacked on the rank
    axis's pod axis through its ``compressed_psum`` give every pod's
    reduced gradient and new error bit for bit."""
    _check_int8(world, f"p2d1m2/{mode}/int8")


def _check_int8(world, key: str):
    ranks = world["ranks"]
    np.testing.assert_allclose(ranks[0][key]["loss"],
                               world["axis"][key]["loss"], rtol=LOSS_RTOL)
    for m in range(2):
        pods = [r[key]["int8"] for r in ranks
                if r["p2d1m2/coords"][2] == m]
        assert len(pods) == 2 and all(p is not None for p in pods)
        for i, keep in enumerate(pods[0]["keep"]):
            x = torch.cat([p["x"][i] for p in pods])
            e = torch.cat([p["e"][i] for p in pods])
            reduced, e_new = TC.compressed_psum(x, e, keep)
            for p, pod in enumerate(pods):
                assert torch.equal(pod["reduced"][i], reduced.to(
                    pod["reduced"][i].dtype))
                assert torch.equal(pod["e_new"][i], e_new[p:p + 1])


@pytest.mark.parametrize("mesh,builder", [("d2m2", "auto"),
                                          ("p2d1m2", "auto"),
                                          ("p2d1m2", "int8")])
def test_gathered_checkpoint_matches_rank_axis(world, mesh, builder):
    """``launch.train.to_checkpoint`` over groups (every process's slices,
    chunks and pod entries gathered) equals the rank axis's layout within
    the params' bound on every process, and ``from_checkpoint`` cuts each
    process's state back out of it bit for bit."""
    key = f"{mesh}/fused/{builder}"
    want = world["axis"][key]["ckpt"]
    for r in world["ranks"]:
        got = r[key]["ckpt"]
        assert r[key]["ckpt_back"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            _close(a, b, PARAM_TOL)


def test_driver_fails_resumes_and_matches_uninterrupted(world):
    """``launch.train`` over groups exits 42 on every rank at step 3 after
    its checkpoint, resumes from it, and ends within 1e-3 of an
    uninterrupted run; only world rank 0 prints."""
    ranks = world["ranks"]
    for w, r in enumerate(ranks):
        assert r["driver/fail"][0] == 42
        assert r["driver/resume"][0] == 0 and r["driver/clean"][0] == 0
        assert bool(r["driver/clean"][1]) == (w == 0)
    resumed, clean = ranks[0]["driver/resume"][1], ranks[0]["driver/clean"][1]
    assert f"resumed from checkpoint step {DRIVER_FAIL}" in resumed
    np.testing.assert_allclose(_final_loss(resumed), _final_loss(clean),
                               rtol=RESUME_RTOL)


def test_driver_checkpoints_move_between_groups_and_rank_axis(world):
    """The groups run's step-3 checkpoint resumed by a one-process rank-axis
    run, and the rank axis's resumed over groups: each ends within 1e-3
    of the uninterrupted runs."""
    tmp, ranks, axis = world["tmp"], world["ranks"], world["axis"]
    rc, text = _drive(DRIVER + ["--ckpt-dir", str(tmp / "fail_copy")])
    assert rc == 0 and f"step {DRIVER_FAIL}" in text
    clean = _final_loss(ranks[0]["driver/clean"][1])
    np.testing.assert_allclose(_final_loss(text), clean, rtol=RESUME_RTOL)
    rc, text = ranks[0]["driver/from_axis"]
    assert rc == 0 and f"step {DRIVER_FAIL}" in text
    axis_clean = _final_loss(axis["clean"][1])
    np.testing.assert_allclose(_final_loss(text), axis_clean,
                               rtol=RESUME_RTOL)
    np.testing.assert_allclose(_final_loss(axis["resume"][1]), axis_clean,
                               rtol=RESUME_RTOL)
    np.testing.assert_allclose(axis_clean, clean, rtol=RESUME_RTOL)


# --------------------------------------------------------------------------
# refusals (no world)
# --------------------------------------------------------------------------

def _one_rank_groups():
    """A process's groups of one: the refusals raise before any
    collective."""
    return Groups(model=None, data=None, model_rank=0, data_rank=0,
                  model_size=1, data_size=1)


def test_ring_under_a_gradient_raises_over_groups():
    """Comm mode ``ring`` (K1, no backward) under a gradient raises the
    rank axis's message, in the slot and through a train step's loss."""
    ctx = CommCtx(mode="ring", use_pallas=True, backend="process_group",
                  groups=_one_rank_groups())
    x = torch.randn(1, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="K1 .* has no backward"):
        tfc.comm_norm(x, torch.zeros(1, 8, 16), torch.ones(16), ctx=ctx)
    cfg = tbase.ModelConfig(**CFG)
    api = build_model(cfg, _pcfg("ring", "d2m2"), groups=_one_rank_groups())
    params = api.init(0, device="cpu")
    for p in tree_flatten(params)[0]:
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(
        vocab=CFG["vocab_size"], seq_len=SEQ, global_batch=2).batch(0).items()}
    with pytest.raises(RuntimeError, match="K1 .* has no backward"):
        api.train_loss(params, batch)
    axis = build_model(cfg, _pcfg("ring", "d2m2"), tp=2)
    p2 = axis.init(0, device="cpu")
    for p in tree_flatten(p2)[0]:
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="K1 .* has no backward"):
        axis.train_loss(p2, batch)


# --------------------------------------------------------------------------
# every other family
# --------------------------------------------------------------------------

def test_all_to_all_backward_matches_rank_axis(world):
    """``all_to_all`` over the data group of (data 2, model 2): each
    process's output and input gradient are its data shard's of the rank
    axis's autograd, float32 within 1e-6 relative (the exchange back is
    the backward)."""
    y_axis, g_axis = world["axis"]["a2a"]
    for r in world["ranks"]:
        d = r["d2m2/coords"][1]
        y, gx = r["a2a"]
        for got, want in ((y, y_axis), (gx, g_axis)):
            np.testing.assert_allclose(
                got.numpy(), want[:, d:d + 1].numpy(), rtol=COLL_RTOL,
                atol=COLL_RTOL * float(want.abs().max()))


def _family_cases(with_int8: bool = False):
    return [(name, b) for name, (_, builders) in FAMILIES.items()
            for b in builders if with_int8 or b != "int8"]


@pytest.mark.parametrize("name,builder", _family_cases())
def test_family_steps_over_groups_match_rank_axis(world, name, builder):
    """Each family's steps over groups: losses within 1e-5 relative, grad
    norms within 1e-4, every process's params within 2e-4 of its slice of
    the rank axis's (an ``ep2d`` expert weight: its (data, model)
    rank's)."""
    mesh = FAMILIES[name][0]
    ax = world["axis"][f"{name}/{builder}"]
    cfg = get_config(name).reduced()
    for r in world["ranks"]:
        got = r[f"{name}/{builder}"]
        np.testing.assert_allclose(got["loss"], ax["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["gnorm"], ax["gnorm"], rtol=NORM_RTOL)
        _, d, m, _ = r[f"{mesh}/coords"]
        want = tree_flatten(W.take_rank(ax["state"][0], m, cfg,
                                        data_rank=d))[0]
        assert len(want) == len(got["params"])
        for a, b in zip(got["params"], want):
            assert a.shape == b.shape
            _close(a, b, PARAM_TOL)


@pytest.mark.parametrize("name,builder", _family_cases(with_int8=True))
def test_family_ranks_issue_the_same_collectives(world, name, builder):
    """Every process issues the same collectives in the same order, the
    backward's among them (``ep2d``: the all-to-alls both ways)."""
    calls = [r[f"{name}/{builder}"]["collectives"] for r in world["ranks"]]
    assert all(c == calls[0] for c in calls)
    names = {c[0] for c in calls[0]}
    assert {"all_reduce", "reduce_scatter_tensor",
            "all_gather_into_tensor"} <= names
    ep2d = FAMILIES[name][0] == "d2m2"
    assert ("all_to_all_single" in names) == ep2d


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_zero1_chunks_match_rank_axis_state(world, name):
    """The auto step's ``m`` / ``v`` chunks of each family: each process's
    within the params' bound of its slice of the rank axis's, its bytes
    what ``zero_specs`` gives a device (the ssm's A_log and D, the
    hybrid's per-invocation leaves and ``lora_b``, ``ep2d``'s experts
    over (data, model) among them)."""
    _check_zero1(world, f"{name}/auto", get_config(name).reduced(),
                 FAMILIES[name][0])


def test_family_int8_pod_reduce_is_bit_equal_to_rank_axis(world):
    """The ssm's int8 manual step: losses within 1e-5 of the rank axis's
    and its first pod reduce bit-equal on the same inputs."""
    _check_int8(world, "falcon-mamba-7b/int8")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_driver_trains_every_family_over_groups(world, name):
    """``launch.train --arch NAME`` over groups: 2 steps, then a resume
    from its gathered checkpoint to 3; every rank exits 0, only rank 0
    prints, and the printed losses are the rank axis's run's within 1e-3
    relative."""
    for steps in (2, 3):
        key = f"driver/{name}/{steps}"
        rc, text = world["axis"][key]
        assert rc == 0
        for w, r in enumerate(world["ranks"]):
            assert r[key][0] == 0
            assert bool(r[key][1]) == (w == 0)
        got = world["ranks"][0][key][1]
        if steps == 3:
            assert "resumed from checkpoint step 2" in got
        np.testing.assert_allclose(_final_loss(got), _final_loss(text),
                                   rtol=RESUME_RTOL)


# --------------------------------------------------------------------------
# ep2d under a pod axis
# --------------------------------------------------------------------------

@pytest.mark.parametrize("builder", POD_EP2D[1])
def test_ep2d_under_a_pod_steps_match_rank_axis(world, builder):
    """The reduced qwen3-moe-235b-a22b at (pod 2, data 2, model 1): each
    process holds its data rank's experts (the same in both pods), runs
    the all-to-alls over its pod's data group and sums the experts'
    gradients over the pod group.  Losses within 1e-5 relative, grad
    norms within 1e-4, every process's params within 2e-4 of its slice of
    the rank axis's (D = 4 over 2 pods).  The manual step is held to the
    rank axis alone: the reference's own raises on ``ep2d``."""
    name = POD_EP2D[0]
    ax = world["axis"][f"pod/{name}/{builder}"]
    cfg = get_config(name).reduced()
    assert ax["api"].expert_shards == 2
    for r in world["ranks"]:
        got = r[f"pod/{name}/{builder}"]
        np.testing.assert_allclose(got["loss"], ax["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["gnorm"], ax["gnorm"], rtol=NORM_RTOL)
        _, d, m, _ = r[f"{POD_MESH}/coords"]
        want = tree_flatten(W.take_rank(ax["state"][0], m, cfg,
                                        data_rank=d))[0]
        assert len(want) == len(got["params"])
        for a, b in zip(got["params"], want):
            assert a.shape == b.shape
            _close(a, b, PARAM_TOL)


@pytest.mark.parametrize("builder", POD_EP2D[1])
def test_ep2d_under_a_pod_ranks_issue_the_same_collectives(world, builder):
    """Every process issues the same collectives in the same order, the
    data group's all-to-alls both ways among them."""
    calls = [r[f"pod/{POD_EP2D[0]}/{builder}"]["collectives"]
             for r in world["ranks"]]
    assert all(c == calls[0] for c in calls)
    names = {c[0] for c in calls[0]}
    assert {"all_reduce", "all_to_all_single"} <= names


def test_ep2d_under_a_pod_zero1_chunks_match_rank_axis_state(world):
    """The auto step's ``m`` / ``v`` under a pod axis: each expert leaf
    chunked over the pod group alone (``weights.PodChunk``, the
    reference's ``zero_specs`` giving it the one free axis, ``pod``), the
    other leaves over pod x data; each process's chunks within the
    params' bound of its slice of the rank axis's, their bytes what
    ``zero_specs`` gives a device."""
    name = POD_EP2D[0]
    cfg = get_config(name).reduced()
    ax = world["axis"][f"pod/{name}/auto"]
    mine = W.take_rank(ax["state"][0], 0, cfg, data_rank=0)
    pairs = []
    W._zip_map(lambda dim, kind: pairs.append((dim, kind)),
               W.zero_dims(mine, cfg, ax["api"].pcfg, 4),
               W.leaf_kinds(mine, cfg, ax["api"].pcfg))
    assert any(kind == "ep2d" for _, kind in pairs)
    assert all(isinstance(dim, W.PodChunk) == (kind == "ep2d")
               for dim, kind in pairs if dim is not None)
    _check_zero1(world, f"pod/{name}/auto", cfg, POD_MESH)


def test_driver_trains_ep2d_under_a_pod_over_groups(world):
    """``launch.train --arch qwen3-moe-235b-a22b --mesh 2x2x1`` over
    groups: 2 steps, then a resume to 3 from its gathered checkpoint;
    every rank exits 0, only rank 0 prints, and the printed losses are
    the rank axis's run's within 1e-3 relative."""
    for steps in (2, 3):
        key = f"driver/pod/{steps}"
        rc, text = world["axis"][key]
        assert rc == 0
        for w, r in enumerate(world["ranks"]):
            assert r[key][0] == 0
            assert bool(r[key][1]) == (w == 0)
        got = world["ranks"][0][key][1]
        if steps == 3:
            assert "resumed from checkpoint step 2" in got
        np.testing.assert_allclose(_final_loss(got), _final_loss(text),
                                   rtol=RESUME_RTOL)
