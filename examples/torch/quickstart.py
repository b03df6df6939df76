"""Quickstart: build a tiny TokenWeave model, train it for a handful of
steps on synthetic data, then greedily generate through the serving engine
(the port of ``examples/quickstart.py``).

    python examples/torch/quickstart.py [--device cpu] [--steps 30]
"""
import argparse

import _path  # noqa: F401  (src/ on sys.path)
from torch.utils._pytree import tree_map

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.build import build_model
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.requests import Request
from repro_torch.runtime.scheduler import SchedulerConfig
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import make_train_step


def main(argv=None):
    p = argparse.ArgumentParser()
    _path.add_device_arg(p)
    p.add_argument("--steps", type=int, default=30)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(name="quickstart", family="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                      d_ff=256, vocab_size=256, dtype="float32")
    # TokenWeave on: fused AllReduce-RMSNorm + two-split weave
    pcfg = ParallelConfig(tokenweave=True, comm_mode="fused", remat=False,
                          split_unit=32, tokenweave_min_tokens=64)
    mesh = make_mesh((1, 1), ("data", "model"))
    api = build_model(cfg, pcfg, tp=1)

    data = SyntheticLM(vocab=cfg.vocab_size, seq_len=128, global_batch=4)
    step, init = make_train_step(api, mesh, data.batch(0),
                                 AdamWConfig(lr=3e-3, warmup_steps=10),
                                 dp_size=1)
    params, opt = init(0, device=device)
    print(f"training a 2-layer model on synthetic Markov data ({device})...")
    for i in range(args.steps):
        params, opt, m = step(params, opt, data.batch(i))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"  step {i:3d}  loss {float(m['loss']):.4f}")

    print("serving with continuous batching + chunked prefill...")
    params = tree_map(lambda t: t.detach(), params)
    eng = Engine(api, params,
                 SchedulerConfig(max_batch=2, chunk_tokens=64, max_len=256,
                                 prefill_bucket=32), device=device)
    prompt = data.batch(999)["tokens"][0, :40].tolist()
    eng.add_request(Request(rid=0, prompt=prompt, max_new_tokens=16))
    done = eng.run()
    print(f"  prompt tail: {prompt[-8:]}")
    print(f"  generated : {done[0].output}")
    print("done — the dry run of the same model families on the 256- and "
          "512-device meshes: python -m repro_torch.launch.dryrun (from "
          "src/).")


if __name__ == "__main__":
    main()
