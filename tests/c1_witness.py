"""ROADMAP.md C1's trace and witness: where the int8 manual step over
process groups parts from the rank axis and from the JAX reference.

Run from the repository's root (a few minutes on the CPU):

    PYTHONPATH=src python tests/c1_witness.py

1. The gradients of one step of the tiny float32 config at (pod 2, data
   1, model 2), one rank per process over gloo, against the rank axis on
   the same params and rows, leaf by leaf, bit for bit: before any sum
   (each process's sharded leaves against the rank axis at D = 1 on its
   pod's rows), after the model sum (every leaf, the same rows), and
   after the data-parallel reduce (against the rank axis's manual step at
   D = 2).
2. The reference's manual int8 step (3 steps, the quantizer's inputs
   ``x + error`` kept per device) against the processes' (the same
   initial params and batches): the first int8 payload element that
   differs, with both inputs over their scales.

Nothing here is a test: it prints what it finds.
"""
import os
import pathlib
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from conftest import run_distributed  # noqa: E402
from test_torch_pg_train import _groups, _like, spawn_world  # noqa: E402
from test_torch_train_steps import STEP_PCFG, unflatten  # noqa: E402
from test_torch_training import PORT_KERNELS, TINY  # noqa: E402

from repro_torch import weights as W  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.training import compression as TC  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402
from repro_torch.training.data import SyntheticLM  # noqa: E402

STEPS = 3
PCFG = dict(STEP_PCFG, **PORT_KERNELS, dp_axes=("pod", "data"),
            grad_compression="int8")

REF = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax import lax
from repro.configs.base import ModelConfig, ParallelConfig
from repro.models.build import build_model
from repro.training import compression as C
from repro.training.data import SyntheticLM
from repro.training.optimizer import AdamWConfig
from repro.training.train_step import make_manual_sync_train_step
store, at = {}, [0]
real = C.compressed_psum
def kept(grads, axis, ef_state):
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    out_g, out_e = [], []
    for (path, g), e in zip(flat, jax.tree.leaves(ef_state)):
        key = jax.tree_util.keystr(path)
        def put(xf, p, m, key=key):
            store[f"{at[0]}|{key}|{int(p)}|{int(m)}"] = np.asarray(xf)
        jax.debug.callback(put, g.astype(jnp.float32) + e,
                           lax.axis_index("pod"), lax.axis_index("model"))
        r, ne = real(g, axis, e)
        out_g.append(r.astype(g.dtype))
        out_e.append(ne)
    tree = jax.tree.structure(grads)
    return jax.tree.unflatten(tree, out_g), jax.tree.unflatten(tree, out_e)
C.compress_grads = kept
cfg = ModelConfig(**%(tiny)r)
pcfg = ParallelConfig(**%(pcfg)r, dp_axes=('pod', 'data'),
                      grad_compression='int8')
mesh = jax.make_mesh((2, 1, 2), ('pod', 'data', 'model'),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
api = build_model(cfg, pcfg, tp=2)
data = SyntheticLM(vocab=cfg.vocab_size, seq_len=32, global_batch=4)
b0 = {k: jnp.asarray(v) for k, v in data.batch(0).items()}
step, init = make_manual_sync_train_step(
    api, mesh, b0, AdamWConfig(lr=1e-2, warmup_steps=5), compress_pod=True)
state = list(init(jax.random.PRNGKey(3)))
for p, leaf in jax.tree_util.tree_flatten_with_path(state[0])[0]:
    store["init" + jax.tree_util.keystr(p)] = np.asarray(leaf)
for i in range(%(steps)d):
    at[0] = i
    b = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
    state[0], state[1], m, state[2] = step(*state[:2], state[2], b)
    jax.block_until_ready(state[0])
np.savez(sys.argv[1], **store)
print("PASS")
"""


def _stage_grads(api, params, rows):
    """One manual-step backward over ``rows`` (a shard's own token mean
    plus its aux, summed): the raw gradient leaves; over groups seeded
    1/tp."""
    TS._trainable(params)
    ls, dn, aux = api.train_loss(params, TS._to_device(rows, "cpu"),
                                 dp=api.ep)
    loss = (ls / torch.clamp(dn, min=1.0) + aux).sum()
    seed = 1.0 if api.groups is None else 1.0 / api.groups.model_size
    return tree_flatten(TS._grads(loss, params, seed))[0]


def _world(rank, tmp):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    groups = _groups("p2d1m2", rank, tmp)
    cfg = tbase.ModelConfig(**TINY)
    pcfg = tbase.ParallelConfig(**PCFG)
    api = build_model(cfg, pcfg, tp=2, ep=2, groups=groups)
    init_tree = torch.load(tmp / "init.pt", weights_only=False)
    data = SyntheticLM(vocab=cfg.vocab_size, seq_len=32, global_batch=4)
    out = {"coords": (groups.pod_rank, groups.model_rank)}
    # 1. the stages of one backward
    params = W.from_jax_params(init_tree, cfg, pcfg, device="cpu",
                               rank=groups.model_rank)
    raw = _stage_grads(api, params, TS._own_rows(data.batch(0), groups))
    lay = TS._GroupLayout(api, params, zero=False)
    out["raw"] = [t.detach().clone() for t in raw]
    model = lay.sync_model(raw)
    out["model"] = [t.detach().clone() for t in model]
    out["dp"] = [t.detach().clone() for t in lay.reduce_dp(model)]
    out["kinds"] = lay.kinds
    # 2. the int8 step's quantizer inputs, x + error, every step
    step, init = TS.make_manual_sync_train_step(
        api, make_mesh((2, 1, 2), ("pod", "data", "model")), None,
        TO.AdamWConfig(lr=1e-2, warmup_steps=5), compress_pod=True)
    state = list(init(0, device="cpu"))
    state[0] = _like(W.from_jax_params(init_tree, cfg, pcfg, device="cpu",
                                       rank=groups.model_rank), state[0])
    real, out["xf"] = TC.compress_grads, []

    def spy(grads, ef, specs=None, group=None):
        out["xf"].append({k: (g.float() + e)[0].detach().clone()
                          for (k, g), e in zip(_paths(grads),
                                               tree_flatten(ef)[0])})
        return real(grads, ef, specs, group)
    TC.compress_grads = spy
    for i in range(STEPS):
        got = step(*state, data.batch(i))
        state = [got[0], got[1], got[3]]
    TC.compress_grads = real
    dist.destroy_process_group()
    torch.save(out, tmp / f"r{rank}.pt")


def _paths(tree, prefix=""):
    """(the reference's keystr, leaf) of a nested dict, in its order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _paths(v, f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def _first_difference(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            j = int((a - b).abs().argmax())
            return i, tuple(a.shape), j, float(a.flatten()[j]), \
                float(b.flatten()[j])
    return None


def _quantize(x):
    """``compression._quantize`` in numpy: one float32 scale, round half
    to even."""
    scale = np.float32(max(np.abs(x).max(), np.float32(1e-12))) / \
        np.float32(127.0)
    return np.clip(np.round(x / scale), -127, 127), scale


def main():
    torch.set_num_threads(1)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="c1_"))
    code = REF % {"tiny": TINY, "pcfg": STEP_PCFG, "steps": STEPS}
    run_distributed(code.replace("sys.argv[1]", repr(str(tmp / "ref.npz"))),
                    n_devices=4, timeout=600)
    z = np.load(tmp / "ref.npz")
    init_tree = unflatten(z, "init")
    torch.save(init_tree, tmp / "init.pt")
    spawn_world(_world, (tmp,))
    cfg = tbase.ModelConfig(**TINY)
    pcfg = tbase.ParallelConfig(**PCFG)
    full = SyntheticLM(vocab=cfg.vocab_size, seq_len=32,
                       global_batch=4).batch(0)
    paths = [k for k, _ in _paths(W.to_jax_layout(
        W.from_jax_params(init_tree, cfg, pcfg, device="cpu"), cfg, pcfg))]
    print("1. the processes' gradients against the rank axis's, bit for bit "
          "(leaf index, shape, element, process, rank axis)")
    for w in range(4):
        r = torch.load(tmp / f"r{w}.pt", weights_only=False)
        pod, m = r["coords"]
        rows = {k: v[2 * pod:2 * pod + 2] for k, v in full.items()}
        for stage, batch, ep in (("raw", rows, 1), ("model", rows, 1),
                                 ("dp", full, 2)):
            api = build_model(cfg, pcfg, tp=2, ep=ep)
            params = W.from_jax_params(init_tree, cfg, pcfg, device="cpu")
            grads = _stage_grads(api, params, batch)
            want = tree_flatten(W.take_rank(
                torch.utils._pytree.tree_unflatten(
                    grads, tree_flatten(params)[1]), m, cfg))[0]
            got = r[stage]
            if stage == "raw":
                pick = [i for i, k in enumerate(r["kinds"])
                        if k == "sharded"]
                got, want = [got[i] for i in pick], [want[i] for i in pick]
            n = sum(not torch.equal(a, b) for a, b in zip(got, want))
            print(f"  world rank {w} {stage}: {n} of {len(got)} leaves "
                  f"differ; first {_first_difference(got, want)}")
    print("2. the int8 payloads, the processes' against the reference's")
    for w in range(4):
        r = torch.load(tmp / f"r{w}.pt", weights_only=False)
        pod, m = r["coords"]
        for i, xf in enumerate(r["xf"]):
            for key in paths:
                mine, ref = xf[key].numpy(), z[f"{i}|{key}|{pod}|{m}"]
                mine = mine.reshape(ref.shape)
                (qa, sa), (qb, sb) = _quantize(mine), _quantize(ref)
                bad = np.argwhere(qa != qb)
                if len(bad):
                    j = tuple(int(x) for x in bad[0])
                    print(f"  world rank {w} (pod {pod}, model {m}) step "
                          f"{i} leaf {key} element {j}: x + error "
                          f"{mine[j]:.9g} / {sa:.9g} = {mine[j] / sa:.9f} "
                          f"(int8 {int(qa[j])}) against the reference's "
                          f"{ref[j]:.9g} / {sb:.9g} = {ref[j] / sb:.9f} "
                          f"(int8 {int(qb[j])}); {len(bad)} such")
                    break
            else:
                continue
            break


if __name__ == "__main__":
    main()
