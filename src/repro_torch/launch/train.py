"""Fault-tolerant training driver, as ``repro.launch.train``.

Features (and ``tests/test_torch_checkpoint.py``):
  * resume-from-latest on (re)start: surviving node failure / preemption
  * periodic async checkpointing (atomic renames, keep_last trimming), in
    the reference's file format and parameter layout
    (``weights.to_jax_layout``): either package resumes the other's run
  * SIGTERM/SIGINT handler -> final checkpoint before exit (preemption)
  * elastic restore: the checkpoint stores full logical arrays, so a run
    resumes on another device
  * optional int8 gradient compression across pods (--manual-sync)

By default the mesh's ranks lie on one device's rank axes
(``launch/mesh.py``): ``--mesh PODxDATAxMODEL`` builds the model at tp =
MODEL with the data rank axis D = POD x DATA (an ``ep2d`` model's
experts over DATA alone, in every pod).  With ``--world-size`` (or
torchrun's ``WORLD_SIZE``) the mesh is one (pod, data, model) rank per
process instead (every family), over ``launch.mesh.init_groups``:
``--rank`` (or ``RANK``), ``--init-method`` (a ``file://`` store or
``env://``), and on CUDA card ``LOCAL_RANK`` modulo the cards there are
with ``--backend`` NCCL, or gloo once several of the host's ranks share
a card (``launch.serve.cuda_backend``); the CPU takes gloo.  Each process
takes its data-parallel shard's rows of every batch
(``training/train_step.py``).  Every family trains: the batch carries
encdec's stub frames and vlm's patch rows and M-RoPE ids beside the
tokens (``training.data.family_inputs``).  A checkpoint is gathered from every
process (its slices, ZeRO-1 chunks and pod entries) and written by world
rank 0 in the reference's layout, the others waiting for the write at
the end and at ``--fail-at-step`` (which exits 42 on every rank); on
resume every rank reads it and takes its part, so a run over groups
resumes on the rank axis and the other way round.  The flags and
defaults are the reference's; ``--device`` is added: the run is on CUDA
unless it names another device (``--device cpu``), and it stops with an
error where there is no CUDA.  Only world rank 0 prints.

Usage (CPU demo; from ``src/``, with no PYTHONPATH, which would load the
reference's jax shim through ``src/sitecustomize.py``):
    cd src && python -m repro_torch.launch.train --device cpu \\
        --arch gemma3-1b --reduced --steps 50 --ckpt-dir /tmp/ckpt
Over four CPU processes, one per rank of a pod 2 x data 1 x model 2
mesh over gloo, with ``store=$(mktemp -d)`` made once for all four:
    cd src && for r in 0 1 2 3; do python -m repro_torch.launch.train \\
        --device cpu --reduced --mesh 2x1x2 --steps 8 --ckpt-dir /tmp/c \\
        --rank $r --world-size 4 --init-method file://$store/store & done
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import numpy as np
import torch


@torch.no_grad()
def to_checkpoint(state, cfg, pcfg, api=None, zero=False):
    """(params, opt[, ef]) -> the reference's layout of the same tuple:
    the parameter layout for params, ``m`` and ``v`` (the error feedback
    is kept in it already).  With ``api.groups`` every process's slices,
    its ZeRO-1 chunks of ``m`` / ``v`` (``zero``) and its pod entries are
    gathered first (``weights.gather_ranks_tree`` / ``gather_pods``,
    collectives), so the tuple holds the full logical arrays on every
    process."""
    from repro_torch import weights as W

    params, opt, extra = state[0], state[1], tuple(state[2:])
    g = api.groups if api is not None else None
    if g is not None:
        dims = W.zero_dims(params, cfg, pcfg, g.dp_size) if zero else None
        opt = dict(opt, **{k: W.gather_ranks_tree(opt[k], cfg, g, dims, pcfg)
                           for k in ("m", "v")})
        extra = tuple(W.gather_pods(e, api.specs(params), g) for e in extra)
        params = W.gather_ranks_tree(params, cfg, g, None, pcfg)
    return (W.to_jax_layout(params, cfg, pcfg),
            {"m": W.to_jax_layout(opt["m"], cfg, pcfg),
             "v": W.to_jax_layout(opt["v"], cfg, pcfg),
             "step": opt["step"]}) + extra


def from_checkpoint(tree, cfg, pcfg, device, api=None, zero=False):
    """The inverse of ``to_checkpoint``, on ``device``: with
    ``api.groups`` this process's part (its model rank's slice, with
    ``zero`` its ZeRO-1 chunk of ``m`` / ``v``, its pod's error
    feedback)."""
    from repro_torch import weights as W

    g = api.groups if api is not None else None
    rank = None if g is None else g.model_rank
    data_rank = None if g is None else g.data_rank

    def conv(t):
        return W.from_jax_params(t, cfg, pcfg, device=device, rank=rank,
                                 data_rank=data_rank)
    params = conv(tree[0])
    opt = {"m": conv(tree[1]["m"]), "v": conv(tree[1]["v"]),
           "step": tree[1]["step"].to(device)}
    extra = [e for e in tree[2:]]
    if g is not None:
        if zero:
            dims = W.zero_dims(params, cfg, pcfg, g.dp_size)
            for k in ("m", "v"):
                opt[k] = torch.utils._pytree.tree_map(
                    lambda t: t.clone(), W.take_chunk(
                        opt[k], dims, g.dp_rank, g.dp_size, g.pod_size))
        extra = [torch.utils._pytree.tree_map(
            lambda t: t.clone().to(device), W.take_pod(
                e, api.specs(params), g.pod_rank, g.model_rank))
            for e in extra]
    else:
        extra = [torch.utils._pytree.tree_map(lambda t: t.to(device), e)
                 for e in extra]
    return [params, opt] + extra


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="gemma3-1b")
    p.add_argument("--reduced", action="store_true",
                   help="tiny same-family config (CPU)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--mesh", default="1x1",
                   help="DATAxMODEL (or PODxDATAxMODEL)")
    p.add_argument("--comm-mode", default="fused",
                   choices=["vanilla", "reordered", "fused", "nocomm"])
    p.add_argument("--no-tokenweave", action="store_true")
    p.add_argument("--manual-sync", action="store_true",
                   help="explicit grad sync (+int8 pod compression)")
    p.add_argument("--fail-at-step", type=int, default=0,
                   help="simulate a crash at step N (fault-tolerance test)")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, an error without it)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="over process groups on CUDA (default: gloo when "
                        "several ranks share a card, else NCCL; the CPU "
                        "takes gloo)")
    p.add_argument("--init-method", default="env://",
                   help="the process group's store (over process groups)")
    p.add_argument("--rank", type=int, default=None,
                   help="this process's world rank (default: $RANK)")
    p.add_argument("--world-size", type=int, default=None,
                   help="one rank per process when given (or "
                        "$WORLD_SIZE): the mesh's size")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import init_groups, make_mesh
    from repro_torch.launch.serve import cuda_backend

    device = resolve_device(args.device)
    dims = [int(x) for x in args.mesh.split("x")]
    if len(dims) == 2:
        axes, dp_axes = ("data", "model"), ("data",)
    else:
        axes, dp_axes = ("pod", "data", "model"), ("pod", "data")
    mesh = make_mesh(dims, axes)
    tp = dims[-1]
    dp = int(np.prod(dims[:-1]))

    world = args.world_size
    if world is None and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
    groups, rank = None, 0
    if world is not None:
        rank = int(os.environ["RANK"]) if args.rank is None else args.rank
        backend = "gloo"
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", rank))
            cards = torch.cuda.device_count()
            device = torch.device("cuda", local % cards)
            torch.cuda.set_device(device)
            backend = args.backend or cuda_backend(
                int(os.environ.get("LOCAL_WORLD_SIZE", world)), cards)
        groups = init_groups(mesh, backend=backend,
                             init_method=args.init_method, rank=rank,
                             world_size=world)
    try:
        return _run(args, device, mesh, tp, dp, dp_axes, groups, rank)
    finally:
        if groups is not None:
            dist.destroy_process_group()


def _run(args, device, mesh, tp, dp, dp_axes, groups, rank):
    """Build the model and its step on the rank axis or over ``groups``,
    resume from the latest checkpoint, and train."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models.build import build_model
    from repro_torch.training.data import SyntheticLM, family_inputs
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (make_manual_sync_train_step,
                                                 make_train_step)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pcfg = ParallelConfig(comm_mode=args.comm_mode,
                          tokenweave=not args.no_tokenweave,
                          dp_axes=dp_axes, split_unit=64,
                          tokenweave_min_tokens=256,
                          grad_compression="int8" if args.manual_sync
                          else "none")
    api = build_model(cfg, pcfg, tp=tp, ep=dp, groups=groups,
                      pods=mesh.size("pod"))

    data = SyntheticLM(vocab=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch)
    batch0 = family_inputs(cfg, data.batch(0), 0)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 4 + 1))

    if args.manual_sync:
        step_fn, init_fn = make_manual_sync_train_step(api, mesh, batch0,
                                                       ocfg)
    else:
        step_fn, init_fn = make_train_step(api, mesh, batch0, ocfg,
                                           dp_size=dp)

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    zero = not args.manual_sync      # make_train_step's ZeRO-1 chunks
    state = list(init_fn(0, device=device))
    mgr = CheckpointManager(args.ckpt_dir) if rank == 0 else None
    start_step = 0
    latest = CheckpointManager(args.ckpt_dir, async_save=False).latest_step()
    if latest is not None:
        reader = CheckpointManager(args.ckpt_dir, async_save=False)
        # its keypaths (gathered: a process's ZeRO-1 chunks may be empty)
        target = to_checkpoint(state, cfg, pcfg, api, zero=zero)
        restored = reader.restore(latest, target, device="cpu")
        state = from_checkpoint(restored, cfg, pcfg, device, api, zero=zero)
        start_step = latest
        say(f"[train] resumed from checkpoint step {start_step}")

    stop = {"now": False}

    def _handler(signum, frame):
        say(f"[train] signal {signum}: checkpointing and exiting")
        stop["now"] = True

    def save(n, wait=False):
        """World rank 0 writes the gathered state; the others wait for
        the gather and, with ``wait``, for the write."""
        tree = to_checkpoint(state, cfg, pcfg, api, zero=zero)
        if mgr is not None:
            mgr.save(n, tree)
            if wait:
                mgr.wait()
        if groups is not None and wait:
            dist.barrier()

    previous = {s: signal.signal(s, _handler)
                for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        t0 = time.time()
        i = start_step
        for i in range(start_step, args.steps):
            batch = family_inputs(cfg, data.batch(i), i)
            out = step_fn(*state[:2], *([state[2], batch] if len(state) == 3
                                        else [batch]))
            if len(state) == 3:
                state[0], state[1], metrics, state[2] = out
            else:
                state[0], state[1], metrics = out
            if i % 10 == 0 or i == args.steps - 1:
                say(f"[train] step {i} loss {float(metrics['loss']):.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"({time.time()-t0:.1f}s)")
            if args.fail_at_step and i + 1 == args.fail_at_step:
                save(i + 1, wait=True)
                say(f"[train] simulated failure at step {i + 1}")
                sys.exit(42)
            if groups is not None:
                # every rank stops at the same step
                flag = torch.tensor([float(stop["now"])], device=device)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                stop["now"] = bool(flag.item())
            if (i + 1) % args.ckpt_every == 0 or stop["now"]:
                save(i + 1)
            if stop["now"]:
                break
        save(i + 1, wait=True)
        say(f"[train] done at step {i + 1}")
        return 0
    finally:
        for s, h in previous.items():
            signal.signal(s, h)


if __name__ == "__main__":
    sys.exit(main())
