"""Paper ablation (Fig. 16 analogue) on the §9 simulator priced with one
H100's roofline constants (the port of ``examples/overlap_ablation.py``):
vanilla vs RMSNorm-reordered vs fused-kernel-only vs full TokenWeave vs
the communication-free counterfactual, across models and sequence
lengths.  Pure arithmetic: nothing runs on a device, so ``--device``
only checks that the device named is there.

    python examples/torch/overlap_ablation.py [--device cpu] [--tp 8]
"""
import argparse

import _path  # noqa: F401  (src/ on sys.path)

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.sim.overlap_sim import e2e_latency


def main(argv=None):
    p = argparse.ArgumentParser()
    _path.add_device_arg(p)
    p.add_argument("--tp", type=int, default=8)
    args = p.parse_args(argv)
    resolve_device(args.device)
    modes = ["vanilla", "reordered", "fuseonly", "tokenweave", "nocomm"]
    for arch in ("llama3.3-70b", "qwen2.5-72b", "mixtral-8x22b"):
        cfg = get_config(arch)
        print(f"\n=== {arch} on H100 x {args.tp} (sim), prefill latency "
              f"(ms) ===")
        print(f"{'tokens':>8} " + " ".join(f"{m:>10}" for m in modes)
              + f" {'tw-gain':>8} {'vs-nocomm':>9}")
        for toks in (1024, 2048, 4096, 8192, 16384):
            r = {m: e2e_latency(cfg, m, toks, tp=args.tp) for m in modes}
            print(f"{toks:8d} "
                  + " ".join(f"{r[m]*1e3:10.1f}" for m in modes)
                  + f" {r['vanilla']/r['tokenweave']:7.3f}x"
                  + f" {r['nocomm']/r['tokenweave']:8.3f}x")
    print("\n(tw-gain = paper Fig.11/16 speedup; vs-nocomm > 1 reproduces "
          "the paper's 'beats zero-communication' result)")


if __name__ == "__main__":
    main()
