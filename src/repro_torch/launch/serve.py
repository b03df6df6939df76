"""Serve seeded requests with one model rank per process over
``torch.distributed`` process groups (``launch.mesh.init_groups``): the
launcher of a multi-card machine, run under ``torchrun``.

    torchrun --nproc-per-node=8 -m repro_torch.launch.serve \\
        --arch llama3.3-70b --layers 4 [--comm-mode ring]
    torchrun --nproc-per-node=8 -m repro_torch.launch.serve \\
        --arch mixtral-8x22b --layers 4 --comm-mode ring

Every process draws the model's weights from the seed and keeps its own
model rank's (``ModelApi.init`` with groups), runs its own ``Engine`` on
the same requests (the scheduler is deterministic and every rank samples
the same token over the model group), and the ranks check that they
emitted the same tokens; rank 0 prints one JSON line, with the kernels'
launches over the engine's run.  On CUDA each process takes card
``LOCAL_RANK`` modulo the cards there are, and the backend is NCCL,
or gloo once several of the host's ranks (``LOCAL_WORLD_SIZE``, else the
world size) share a card, since NCCL refuses two ranks on one device
(``--backend`` overrides it); the CPU takes gloo.  The
rank and the world size come from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``; ``--init-method env://``) or from
``--rank`` / ``--world-size`` with a ``file://`` store.  The mesh is
(data 1, model = world size), as the engine serves it.  ``--arch`` takes
every family the engine serves: dense, MoE (``expert`` and ``ffn``; an
``ep2d`` model needs the data group, ROADMAP.md A19), ssm, and vlm as
text.  The hybrid and encdec families are refused by name: the engine
cannot hold their caches, and they are served by direct
``ModelApi.prefill`` / ``decode_step`` calls.  ``--comm-mode ring``
runs every add+norm slot as K1's cross-rank form on CUDA (the model
group's peer buffers are made before the first forward,
``distributed.peer.attach``), its plain version over the group on the
CPU.

Without CUDA, ``--device cuda`` (the default) stops with an error; run
from ``src/`` with no PYTHONPATH (``src/sitecustomize.py`` would load the
reference's jax shim).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.3-70b")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's tiny float32 form")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the process group's backend on CUDA (default: "
                         "gloo when several ranks share a card, else NCCL; "
                         "the CPU takes gloo)")
    ap.add_argument("--comm-mode", default="fused",
                    choices=("fused", "ring"))
    ap.add_argument("--init-method", default="env://")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--prompt-lens", default="1800,1200,700,300")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed import peer
    from repro_torch.launch.mesh import init_groups, make_mesh
    from repro_torch.models.build import build_model
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    cfg = get_config(args.arch)
    if cfg.family in ("hybrid", "encdec"):
        print(f"serve: the {cfg.family} family is served by direct "
              f"ModelApi.prefill / decode_step calls, not by the engine",
              file=sys.stderr)
        return 2
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    rank = int(os.environ["RANK"]) if args.rank is None else args.rank
    world = (int(os.environ["WORLD_SIZE"]) if args.world_size is None
             else args.world_size)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("serve: no CUDA device (--device cpu runs on gloo)",
                  file=sys.stderr)
            return 2
        local = int(os.environ.get("LOCAL_RANK", rank))
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
        backend = args.backend or cuda_backend(
            int(os.environ.get("LOCAL_WORLD_SIZE", world)), cards)
    else:
        device, backend = torch.device("cpu"), "gloo"
    groups = init_groups(make_mesh((1, world), ("data", "model")),
                         backend=backend, init_method=args.init_method,
                         rank=rank, world_size=world)
    try:
        pcfg = ParallelConfig(comm_mode=args.comm_mode, attn_impl="pallas",
                              use_pallas_norm=True)
        sched = SchedulerConfig()
        if args.comm_mode == "ring" and device.type == "cuda":
            groups = peer.attach(
                groups, rows=sched.max_forward_tokens(world), d=cfg.d_model,
                dtype=getattr(torch, cfg.dtype), device=device)
        api = build_model(cfg, pcfg, tp=world, groups=groups)
        params = api.init(args.seed, device=device)
        rng = np.random.RandomState(args.seed)
        prompts = [rng.randint(0, cfg.vocab_size, int(n)).tolist()
                   for n in args.prompt_lens.split(",")]
        eng = Engine(api, params, sched, device=device)
        for i, p in enumerate(prompts):
            eng.add_request(Request(rid=i, prompt=p,
                                    max_new_tokens=args.new_tokens))
        before = launches()
        t0 = time.perf_counter()
        done = eng.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t0
        after = launches()
        # prefill forwards and their weave splits: K3's calls per layer
        prefill_splits = sum(
            m.value for m in (
                eng.metrics.get("engine/site_forwards", site="prefill"),
                eng.metrics.get("engine/site_weave", site="prefill"))
            if m is not None)
        tokens = {r.rid: r.output for r in done}
        flat = torch.tensor([t for rid in sorted(tokens)
                             for t in tokens[rid]], dtype=torch.int64,
                            device=device)
        lo, hi = flat.clone(), flat.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        same = bool(torch.equal(lo, hi))
        if rank == 0:
            print(json.dumps({
                "arch": cfg.name, "family": cfg.family,
                "layers": cfg.num_layers,
                "dtype": cfg.dtype, "comm_mode": args.comm_mode,
                "backend": dist.get_backend(), "world_size": world,
                "forwards": eng.stats.forwards,
                "weave_forwards": eng.stats.weave_forwards,
                "prefill_splits": prefill_splits,
                "launches": {k: after[k] - before[k] for k in after},
                "wall_s": wall_s, "ranks_agree": same,
                "tokens": [tokens[rid] for rid in sorted(tokens)]}),
                flush=True)
        if groups.peer is not None:
            groups.peer.close()
        return 0 if same else 1
    finally:
        dist.destroy_process_group()


def cuda_backend(local_world: int, cards: int) -> str:
    """The backend for ``local_world`` ranks on this host's ``cards``
    cards, rank k on card k modulo ``cards``: gloo once two ranks share a
    card (NCCL refuses two ranks on one device), else NCCL."""
    return "gloo" if local_world > cards else "nccl"


def launches() -> dict:
    """Each kernel wrapper's launch count."""
    from repro_torch.kernels import (ar_rmsnorm, ar_rmsnorm_peer,
                                     flash_attention, fused_rmsnorm)
    return {"ar_rmsnorm": ar_rmsnorm.ar_rmsnorm.launches,
            "ar_rmsnorm_peer": ar_rmsnorm_peer.ar_rmsnorm_peer.launches,
            "fused_residual_rmsnorm":
                fused_rmsnorm.fused_residual_rmsnorm.launches,
            "flash_attention": flash_attention.flash_attention.launches}


if __name__ == "__main__":
    sys.exit(main())
