"""The port's training path against the JAX reference, in float32 on the
CPU, on the same numpy-seeded inputs and weights (``from_jax_params``).

- ``sharded_softmax_xent`` (the padded vocabulary tail, ``ignore_id``) at
  one and two vocab shards;
- ``train_loss`` and its gradient for the dense, MoE (``expert``) and vlm
  families (``check_family``; the ssm, hybrid and encdec families in
  ``tests/test_torch_train_families.py``), every leaf of the reduced
  configs perturbed by 0.05·N(0, 1), the weave splitting, remat on: the
  loss within 1e-5 relative, every gradient leaf within 1e-4 of max(1,
  the leaf's largest magnitude).  The reference runs its plain paths (its
  Pallas kernels have no gradient in interpret mode); the port runs K2
  and K3 through their autograd Functions (``use_pallas_norm``,
  ``attn_impl="pallas"``), plain versions on CPU tensors;
- ``adamw_update`` over 3 steps (within 1e-6), ``SyntheticLM`` batches
  bit-equal, ``_quantize``'s int8 payload equal and ``compressed_psum``
  within 1e-6.

The specs and the train steps against the reference at pod 2 x model 2
are in ``tests/test_torch_train_steps.py``; checkpoints and launch.train in
``tests/test_torch_checkpoint.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro import configs as jconfigs
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ParallelConfig as JParallel
from repro.layers import embedding as JE
from repro.models.build import build_model as j_build_model
from repro.training import compression as JC
from repro.training import optimizer as JO
from repro.training.data import SyntheticLM as JSyntheticLM
from repro.training.train_step import make_loss_fn as j_make_loss_fn

from repro_torch.configs import base as tbase
from repro_torch.layers import embedding as TE
from repro_torch.models.build import build_model as t_build_model
from repro_torch.training import compression as TC
from repro_torch.training import optimizer as TO
from repro_torch.training.data import SyntheticLM as TSyntheticLM
from repro_torch.weights import from_jax_params

LOSS_RTOL, GRAD_TOL, ADAM_TOL, PSUM_TOL = 1e-5, 1e-4, 1e-6, 1e-6
PERTURB = 0.05
PCFG = dict(tokenweave=True, comm_mode="fused", remat=True, split_unit=16,
            tokenweave_min_tokens=32)
# the port runs the kernels' autograd Functions; the reference its plain
# paths
PORT_KERNELS = dict(use_pallas_norm=True, attn_impl="pallas")
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=128, dtype="float32")
B, S = 2, 40                    # 80 tokens: the weave splits the sequence


def family_cfg(family: str):
    if family == "dense":
        return JModelConfig(**TINY)
    if family == "ssm":
        return JModelConfig(name="t", family="ssm", num_layers=2,
                            d_model=64, num_heads=0, num_kv_heads=0, d_ff=0,
                            vocab_size=128, ssm_state=8, ssm_dt_rank=8,
                            dtype="float32")
    name = {"moe": "olmoe-1b-7b", "vlm": "qwen2-vl-7b",
            "hybrid": "zamba2-7b", "encdec": "whisper-base"}[family]
    cfg = jconfigs.get_config(name).reduced()
    if family in ("moe", "vlm", "encdec"):
        cfg = dataclasses.replace(cfg, num_layers=2)
    return cfg


def perturbed_init(api, seed: int):
    params = api.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + PERTURB * rng.randn(*a.shape).astype(
            np.asarray(a).dtype)), params)


def family_batch(cfg, family: str, seed: int):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -100                         # ignored positions
    if family == "encdec":
        batch["frames"] = rng.randn(B, 16, cfg.d_model).astype(np.float32)
    if family == "vlm":
        # 8 patch rows in front of the text; 1-D and M-RoPE ids as the
        # reference's image-then-text layout takes them
        n_img = 8
        batch["extra_embeds"] = rng.randn(B, n_img, cfg.d_model).astype(
            np.float32)
        s_all = n_img + S
        batch["mrope_positions"] = np.broadcast_to(
            np.arange(s_all, dtype=np.int32)[None, None],
            (B, 3, s_all)).copy()
    batch["labels"] = labels
    return batch


def leaves(tree) -> list:
    """A nested dict's or list's leaves, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def close_tree(got, want, tol):
    """Every leaf within tol of max(1, the leaf's largest magnitude)."""
    g_l, w_l = leaves(got), leaves(want)
    assert len(g_l) == len(w_l)
    worst = 0.0
    for g, w in zip(g_l, w_l):
        w = torch.as_tensor(np.array(w)).float()
        assert g.shape == w.shape
        err = float((g.detach().float() - w).abs().max()) / max(
            1.0, float(w.abs().max()))
        worst = max(worst, err)
    assert worst <= tol, worst
    return worst


# --------------------------------------------------------------------------
# the cross-entropy and train_loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tp,vocab", [(1, 128), (2, 125)])
def test_sharded_softmax_xent_matches_reference(tp, vocab, mesh11):
    """The reference at one shard on the full (padded) logits, the port on
    ``tp`` shards of them: the padded tail masked, -100 ignored."""
    rng = np.random.RandomState(tp)
    v_pad = 128
    logits = (3 * rng.randn(B, S, v_pad)).astype(np.float32)
    labels = rng.randint(0, vocab, (B, S)).astype(np.int32)
    labels[1, 5:9] = -100

    def f(lg, lab):
        return JE.sharded_softmax_xent(lg, lab, vocab_size=vocab)
    ls, dn = jax.shard_map(f, mesh=mesh11, in_specs=(P(), P()),
                           out_specs=(P(), P()), check_vma=False)(logits, labels)
    t_logits = torch.from_numpy(logits).reshape(B, S, tp, v_pad // tp)
    got_ls, got_dn = TE.sharded_softmax_xent(
        t_logits.permute(2, 0, 1, 3), torch.from_numpy(labels),
        vocab_size=vocab)
    assert float(got_dn) == float(dn)
    np.testing.assert_allclose(float(got_ls), float(ls), rtol=LOSS_RTOL)


# the reference compiled without XLA's costly passes: the same function,
# in about 60 % of the compile time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def check_family(family: str, mesh):
    """``train_loss`` and its gradient, the reference's (its global-mean
    loss, ``make_loss_fn``) against the port's ``ModelApi.train_loss``."""
    cfg = family_cfg(family)
    api = j_build_model(cfg, JParallel(**PCFG), tp=1)
    params = perturbed_init(api, 3)
    batch = family_batch(cfg, family, 5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_sm, _, _ = j_make_loss_fn(api, mesh, jb)
    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_sm)).lower(
        params, jb).compile(FAST_COMPILE)(params, jb)

    tcfg = tbase.ModelConfig(**dataclasses.asdict(cfg))
    tpcfg = tbase.ParallelConfig(**PCFG, **PORT_KERNELS)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                              tpcfg, device="cpu")
    leaves, spec = tree_flatten(tparams)
    for p in leaves:
        p.requires_grad_(True)
    tapi = t_build_model(tcfg, tpcfg)
    ls, dn, aux = tapi.train_loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert ls.shape == dn.shape == aux.shape == (1,)
    loss = ls.sum() / dn.sum().clamp_min(1.0) + aux.mean()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, j_grads), tcfg, tpcfg,
                           device="cpu")
    close_tree(tree_unflatten([torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)], spec),
               want, GRAD_TOL)


@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_train_loss_and_gradients_match_reference(family, mesh11):
    check_family(family, mesh11)


# --------------------------------------------------------------------------
# optimizer, data, compression
# --------------------------------------------------------------------------

def test_adamw_update_matches_reference():
    """Three steps on a tree with a 1-D leaf (no decay) and a 3-D one,
    warm-up and clipping active, within 1e-6."""
    rng = np.random.RandomState(0)
    shapes = {"w": (2, 8, 16), "b": {"g": (16,), "k": (4, 16)}}
    params = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda s: (3 * rng.randn(*s)).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
             for _ in range(3)]
    cfg = JO.AdamWConfig(lr=1e-2, warmup_steps=2, grad_clip=1.0)
    tcfg = TO.AdamWConfig(**dataclasses.asdict(cfg))
    jp = jax.tree.map(jnp.asarray, params)
    jopt = JO.init_opt_state(jp)
    tp = jax.tree.map(torch.from_numpy, params)
    topt = TO.init_opt_state(tp)
    for g in grads:
        jp, jopt, jn = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g),
                                       jopt, cfg)
        tp, topt, tn = TO.adamw_update(tp, jax.tree.map(torch.from_numpy, g),
                                       topt, tcfg)
        np.testing.assert_allclose(float(tn), float(jn), rtol=ADAM_TOL)
    assert int(topt["step"]) == int(jopt["step"]) == 3
    for got, want in ((tp, jp), (topt["m"], jopt["m"]),
                      (topt["v"], jopt["v"])):
        close_tree(got, jax.tree.map(np.asarray, want), ADAM_TOL)


def test_synthetic_lm_batches_bit_equal():
    j = JSyntheticLM(vocab=97, seq_len=33, global_batch=8, seed=4)
    t = TSyntheticLM(vocab=97, seq_len=33, global_batch=8, seed=4)
    for step, host, count in ((0, 0, 1), (3, 0, 1), (5, 1, 2), (7, 3, 4)):
        a, b = j.batch(step, host, count), t.batch(step, host, count)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_quantize_payload_and_compressed_psum_match_reference():
    """The int8 payload equal (halfway values round to even in both), the
    reduce over one pod within 1e-6, the new error equal."""
    rng = np.random.RandomState(1)
    x = (rng.randn(64, 33) * 1e-3).astype(np.float32)
    c = 2.0 ** -10                  # the scale: max|x| = 127 c
    x[0, :4] = np.array([0.5, 1.5, -2.5, 127.0]) * c
    err = (rng.randn(64, 33) * 1e-5).astype(np.float32)
    for a in (x, x + err):
        jq, js = JC._quantize(jnp.asarray(a))
        tq, ts = TC._quantize(torch.from_numpy(a))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
    mesh = jax.make_mesh((1,), ("pod",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    jr, je = jax.shard_map(lambda v, e: JC.compressed_psum(v, "pod", e),
                           mesh=mesh, in_specs=(P(), P()),
                           out_specs=(P(), P()))(x, err)
    tr, te = TC.compressed_psum(torch.from_numpy(x)[None],
                                torch.from_numpy(err)[None])
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=PSUM_TOL,
                               atol=PSUM_TOL)
    np.testing.assert_array_equal(te[0].numpy(), np.asarray(je))
