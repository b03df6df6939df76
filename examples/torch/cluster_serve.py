"""Cluster serving walkthrough (runtime/cluster.py, DESIGN.md §11; the
port of ``examples/cluster_serve.py``): a
shared-prefix trace through a 3-replica fleet under each router — showing
where every request lands and that prefix-affinity keeps groups together —
then the same offered load through a disaggregated 2-prefill + 1-decode
fleet with KV handoff, showing the decode replica's merged batches weaving
where the monolithic fleet's engines sit below the floor; finally the
sim's analytic fleet crossover sweep.

    python examples/torch/cluster_serve.py [--device cpu] [--groups 4] \
        [--per-group 4] [--router prefix_affinity] [--requests 48]
"""
import argparse

import _path  # noqa: F401  (src/ on sys.path)

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models.build import build_model
from repro_torch.runtime.cluster import (ClusterConfig, ClusterServer,
                                         Replica, ROUTERS)
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.requests import (grouped_prefix_trace,
                                          poisson_arrivals,
                                          sharegpt_like_trace)
from repro_torch.runtime.scheduler import SchedulerConfig
from repro_torch.sim.overlap_sim import (cluster_crossover_rate,
                                         cluster_summary)


def main(argv=None):
    p = argparse.ArgumentParser()
    _path.add_device_arg(p)
    p.add_argument("--groups", type=int, default=4)
    p.add_argument("--per-group", type=int, default=4)
    p.add_argument("--router", default=None, choices=sorted(ROUTERS),
                   help="run only this router (default: all three)")
    p.add_argument("--requests", type=int, default=48,
                   help="trace size for the disaggregation comparison")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                      vocab_size=128, dtype="float32")
    pcfg = ParallelConfig(tokenweave=True, comm_mode="fused", remat=False,
                          split_unit=16, tokenweave_min_tokens=48)
    api = build_model(cfg, pcfg, tp=1)
    params = api.init(0, device=device)

    def engine(max_batch=16):
        return Engine(api, params,
                      SchedulerConfig(max_batch=max_batch, chunk_tokens=64,
                                      max_len=96, prefill_bucket=16,
                                      paged=True, block_size=8,
                                      packed=True), device=device)

    def affinity_trace():
        t = grouped_prefix_trace(args.groups, args.per_group, prefix_len=24,
                                 tail_len=6, output_len=6,
                                 vocab=cfg.vocab_size, seed=3)
        return poisson_arrivals(t, rate=0.5, seed=5)

    # ---- single-engine reference (the token-identity pin) ------------
    ref_eng = engine()
    for r in affinity_trace():
        ref_eng.add_request(r)
    ref = {r.rid: r.output for r in ref_eng.run()}

    routers = [args.router] if args.router else sorted(ROUTERS)
    for router in routers:
        reps = [Replica(f"r{i}", engine()) for i in range(3)]
        cs = ClusterServer(reps, ClusterConfig(router=router))
        for r in affinity_trace():
            cs.submit(r)
        done = cs.run()
        got = {r.rid: r.output for r in done}
        groups = {}
        for rid, name in sorted(cs.placement.items()):
            groups.setdefault(rid % args.groups, []).append(name)
        print(f"\n{router}: outputs identical to single engine: "
              f"{got == ref}")
        for g, names in sorted(groups.items()):
            print(f"  prompt-group {g}: {names}")
        s = cs.summary()
        print(f"  affinity_hit_rate={s['affinity_hit_rate']:.2f}  "
              + "  ".join(f"{r.name}:weave={s[f'{r.name}/weave_rate']:.2f}"
                          for r in reps))

    # ---- disaggregated prefill/decode vs monolithic fleet ------------
    def load_trace():
        t = sharegpt_like_trace(args.requests, vocab=cfg.vocab_size,
                                seed=11, max_in=32, max_out=32)
        for r in t:
            r.max_new_tokens = max(24, min(r.max_new_tokens, 32))
        return poisson_arrivals(t, rate=8.0, seed=5)

    ref_eng = engine()
    for r in load_trace():
        ref_eng.add_request(r)
    ref2 = {r.rid: r.output for r in ref_eng.run()}

    mono = [Replica(f"m{i}", engine()) for i in range(3)]
    cs_m = ClusterServer(mono, ClusterConfig(router="round_robin"))
    for r in load_trace():
        cs_m.submit(r)
    got_m = {r.rid: r.output for r in cs_m.run()}
    mono_fwd = sum(r.engine.stats.forwards for r in mono)
    mono_weave = (sum(r.engine.stats.weave_forwards for r in mono)
                  / max(mono_fwd, 1))

    disagg = [Replica("p0", engine(), role="prefill"),
              Replica("p1", engine(), role="prefill"),
              Replica("d0", engine(max_batch=48), role="decode")]
    cs_d = ClusterServer(disagg, ClusterConfig(router="round_robin"))
    for r in load_trace():
        cs_d.submit(r)
    got_d = {r.rid: r.output for r in cs_d.run()}
    s = cs_d.summary()
    st = disagg[2].engine.block_mgr.stats
    print(f"\ndisaggregation at the same offered load "
          f"({args.requests} requests, both fleets of 3):")
    print(f"  outputs identical (mono, disagg): "
          f"{got_m == ref2}, {got_d == ref2}")
    print(f"  monolithic fleet weave rate: {mono_weave:.2f}")
    print(f"  disagg decode-fleet weave rate: "
          f"{s['decode_fleet/weave_rate']:.2f}  "
          f"(migrations={int(s['migrations'])}, "
          f"imports shared/copied={st.import_shared_blocks}/"
          f"{st.import_copied_blocks})")

    # ---- the fleet-level story (analytic, 70B/tp8 on H100s) ----------
    big = get_config("llama3.3-70b")
    rates = [10.0, 20.0, 30.0, 40.0, 60.0, 80.0]
    summ = cluster_summary(big, rates, n_replicas=4, tp=8)
    print("\ntotal offered load sweep (llama3.3-70b, tp=8, fleet of 4, "
          "1 decode replica, sim):")
    print(f"{'rate':>6} {'mono_iter':>10} {'decode_fleet':>13} "
          f"{'mono_weaves':>12} {'fleet_weaves':>13} {'fleet_gain':>11}")
    for rate in rates:
        s = summ[rate]
        print(f"{rate:6.0f} {s['mono_iter_tokens']:10.0f} "
              f"{s['decode_fleet_tokens']:13.0f} "
              f"{s['mono_weaves']:12.0f} {s['decode_fleet_weaves']:13.0f} "
              f"{s['decode_fleet_gain']:11.3f}")
    print(f"crossover (fleet weaves, mono does not): "
          f"{cluster_crossover_rate(big, rates, 4, tp=8)}")


if __name__ == "__main__":
    main()
