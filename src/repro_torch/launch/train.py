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

The mesh's ranks lie on one device's rank axes (``launch/mesh.py``):
``--mesh PODxDATAxMODEL`` builds the model at tp = MODEL with the data
rank axis D = POD x DATA.  The flags and defaults are the reference's;
``--device`` is added: the run is on CUDA unless it names another device
(``--device cpu``), and it stops with an error where there is no CUDA.

Usage (CPU demo; from ``src/``, with no PYTHONPATH, which would load the
reference's jax shim through ``src/sitecustomize.py``):
    cd src && python -m repro_torch.launch.train --device cpu \\
        --arch gemma3-1b --reduced --steps 50 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np
import torch


@torch.no_grad()
def to_checkpoint(state, cfg, pcfg):
    """(params, opt[, ef]) -> the reference's layout of the same tuple:
    the parameter layout for params, ``m`` and ``v`` (the error feedback
    is kept in it already)."""
    from repro_torch.weights import to_jax_layout

    def conv(tree):
        return to_jax_layout(tree, cfg, pcfg)
    params, opt = state[0], state[1]
    out = [conv(params), {"m": conv(opt["m"]), "v": conv(opt["v"]),
                          "step": opt["step"]}]
    return tuple(out) + tuple(state[2:])


def from_checkpoint(tree, cfg, pcfg, device):
    """The inverse of ``to_checkpoint``, on ``device``."""
    from repro_torch.weights import from_jax_params

    def conv(t):
        return from_jax_params(t, cfg, pcfg, device=device)
    state = [conv(tree[0]), {"m": conv(tree[1]["m"]),
                             "v": conv(tree[1]["v"]),
                             "step": tree[1]["step"].to(device)}]
    return state + list(tree[2:])


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
    args = p.parse_args(argv)

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.build import build_model
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (make_manual_sync_train_step,
                                                 make_train_step)

    device = resolve_device(args.device)
    dims = [int(x) for x in args.mesh.split("x")]
    if len(dims) == 2:
        axes, dp_axes = ("data", "model"), ("data",)
    else:
        axes, dp_axes = ("pod", "data", "model"), ("pod", "data")
    mesh = make_mesh(dims, axes)
    tp = dims[-1]
    dp = int(np.prod(dims[:-1]))

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pcfg = ParallelConfig(comm_mode=args.comm_mode,
                          tokenweave=not args.no_tokenweave,
                          dp_axes=dp_axes, split_unit=64,
                          tokenweave_min_tokens=256,
                          grad_compression="int8" if args.manual_sync
                          else "none")
    api = build_model(cfg, pcfg, tp=tp, ep=dp)

    data = SyntheticLM(vocab=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch)
    batch0 = data.batch(0)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 4 + 1))

    if args.manual_sync:
        step_fn, init_fn = make_manual_sync_train_step(api, mesh, batch0,
                                                       ocfg)
    else:
        step_fn, init_fn = make_train_step(api, mesh, batch0, ocfg,
                                           dp_size=dp)

    state = list(init_fn(0, device=device))
    mgr = CheckpointManager(args.ckpt_dir)
    start_step = 0
    latest = mgr.latest_step()
    if latest is not None:
        _, restored = mgr.restore_latest(to_checkpoint(state, cfg, pcfg),
                                         device=device)
        state = from_checkpoint(restored, cfg, pcfg, device)
        start_step = latest
        print(f"[train] resumed from checkpoint step {start_step}")

    stop = {"now": False}

    def _handler(signum, frame):
        print(f"[train] signal {signum}: checkpointing and exiting")
        stop["now"] = True

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)

    def save(n):
        mgr.save(n, to_checkpoint(state, cfg, pcfg))

    t0 = time.time()
    i = start_step
    for i in range(start_step, args.steps):
        batch = data.batch(i)
        out = step_fn(*state[:2], *([state[2], batch] if len(state) == 3
                                    else [batch]))
        if len(state) == 3:
            state[0], state[1], metrics, state[2] = out
        else:
            state[0], state[1], metrics = out
        if i % 10 == 0 or i == args.steps - 1:
            print(f"[train] step {i} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        if args.fail_at_step and i + 1 == args.fail_at_step:
            save(i + 1)
            mgr.wait()
            print(f"[train] simulated failure at step {i + 1}")
            sys.exit(42)
        if (i + 1) % args.ckpt_every == 0 or stop["now"]:
            save(i + 1)
        if stop["now"]:
            break
    save(i + 1)
    mgr.wait()
    print(f"[train] done at step {i + 1}")


if __name__ == "__main__":
    main()
