"""Serve seeded requests with one model rank per process over
``torch.distributed`` process groups (``launch.mesh.init_groups``): the
launcher of a multi-card machine, run under ``torchrun``.

    torchrun --nproc-per-node=8 -m repro_torch.launch.serve \\
        --arch llama3.3-70b --layers 4

Every process draws the model's weights from the seed and keeps its own
model rank's (``ModelApi.init`` with groups), runs its own ``Engine`` on
the same requests (the scheduler is deterministic and every rank samples
the same token over the model group), and the ranks check that they
emitted the same tokens; rank 0 prints one JSON line.  The backend follows
``--device``: NCCL on CUDA (each process on ``cuda:LOCAL_RANK``), gloo on
the CPU.  The rank and the world size come from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; ``--init-method env://``) or
from ``--rank`` / ``--world-size`` with a ``file://`` store.  The mesh
is (data 1, model = world size): the dense family at data size 1, as the
engine serves it.

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
    from repro_torch.launch.mesh import init_groups, make_mesh
    from repro_torch.models.build import build_model
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    rank = int(os.environ["RANK"]) if args.rank is None else args.rank
    world = (int(os.environ["WORLD_SIZE"]) if args.world_size is None
             else args.world_size)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("serve: no CUDA device (--device cpu runs on gloo)",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank)))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    groups = init_groups(make_mesh((1, world), ("data", "model")),
                         backend=backend, init_method=args.init_method,
                         rank=rank, world_size=world)
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        if args.layers:
            cfg = dataclasses.replace(cfg, num_layers=args.layers)
        pcfg = ParallelConfig(comm_mode="fused", attn_impl="pallas",
                              use_pallas_norm=True)
        api = build_model(cfg, pcfg, tp=world, groups=groups)
        params = api.init(args.seed, device=device)
        rng = np.random.RandomState(args.seed)
        prompts = [rng.randint(0, cfg.vocab_size, int(n)).tolist()
                   for n in args.prompt_lens.split(",")]
        eng = Engine(api, params, SchedulerConfig(), device=device)
        for i, p in enumerate(prompts):
            eng.add_request(Request(rid=i, prompt=p,
                                    max_new_tokens=args.new_tokens))
        t0 = time.perf_counter()
        done = eng.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t0
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
                "arch": cfg.name, "layers": cfg.num_layers,
                "backend": dist.get_backend(), "world_size": world,
                "forwards": eng.stats.forwards, "wall_s": wall_s,
                "ranks_agree": same,
                "tokens": [tokens[rid] for rid in sorted(tokens)]}),
                flush=True)
        return 0 if same else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
