"""Weight bridge between the reference package's parameter pytree and
this package's parameter dict, both ways (``from_jax_params``,
``to_jax_layout``), and what the reference reads off its layout: each
leaf's PartitionSpec (``reference_specs``) and its number of dimensions
(``reference_ndims``, which decides its weight decay).

``params_np`` is ``jax.tree.map(np.asarray, params)`` of the reference's
``init_params`` (``models.transformer``, ``models.mamba_model``,
``models.hybrid`` or ``models.encdec``) at any tp.  These layouts need
care:

* layers are either stacked with a leading layer axis (``scan_layers``
  with uniform layer kinds, and always for the ssm and hybrid families)
  or a ``{"layer_i": ...}`` dict;
* every sharded weight carries a per-shard leading axis of size tp, kept
  as the port's rank axis (a MoE layer's expert weights too); an
  ``ep2d`` layer's expert weights carry two, (ep, tp, E/ep, ...), kept as
  the data and rank axes (D, R, ...) (``layers/moe.py``); the
  replicated weights (norm gains, q/k norms, the row-parallel output bias,
  the MoE router, Mamba-2's B/C projection and conv) carry an axis of size
  1 and drop it;
* the encdec tree has two stacks, ``enc_layers`` and ``dec_layers``, and
  replicated top-level leaves (``pos_enc`` and ``pos_dec`` (1, P, d),
  ``norm_first_enc``, ``norm_first``), each losing its size-1 axis;
* the hybrid's shared block carries a per-invocation axis in front of the
  size-1 axis of its replicated ``norm_out`` (n_inv, 1, d) and ``lora_a``
  (n_inv, 1, 2d, 16), so that axis 1 is the one dropped there;
* the MoE router and the SSM's A_log, D and dt_bias stay float32 whatever
  ``dtype`` asks for, as routing and the recurrences run in float32;
* bf16 arrays arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
  refuses, so they go over through a uint16 view.

``from_jax_params(..., rank=r)`` keeps model rank r's slice ``[r:r+1]``
of every per-rank leaf (replicated leaves whole), the parameters of one
process of a ``process_group`` model (``distributed/context.py``);
``take_rank`` cuts the same slice out of this package's dict.  Both
take the dense and MoE ``expert``/``ffn`` trees.

``from_jax_params`` also takes the reference's tree with torch leaves
(``to_jax_layout``'s output, a checkpoint restored by
``checkpoint.manager``); ``to_jax_layout`` of the optimizer's ``m`` and
``v`` trees gives the reference's optimizer layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def to_torch(a, device=None, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype, copy=True)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype or t.dtype)


# leaves the reference replicates (PartitionSpec None): (1, ...) -> (...)
REPLICATED = frozenset({"norm_attn", "norm_ffn", "norm_cross",
                        "norm_attn_post",
                        "norm_ffn_post", "q_norm", "k_norm", "b_out",
                        "router", "norm_out", "in_proj_bc", "conv_bc"})
# leaves kept in float32 whatever dtype the caller asks for
FLOAT32 = frozenset({"router", "A_log", "D", "dt_bias"})


def _convert(tree, device, dtype, rank=None):
    """Keep the per-shard axis of sharded leaves as the rank axis (rank
    ``rank``'s slice of it when given); drop the size-1 axis of
    replicated ones."""
    def leaf(k, v):
        if k in REPLICATED:
            v = v[0]
        elif rank is not None:
            v = v[rank:rank + 1]
        return to_torch(v, device, torch.float32 if k in FLOAT32 else dtype)
    return {k: (_convert(v, device, dtype, rank) if isinstance(v, dict)
                else leaf(k, v)) for k, v in tree.items()}


def _check_rank_slicing(tree_keys, cfg) -> None:
    """One model rank's slice is taken for the trees whose every sharded
    leaf leads with the rank axis."""
    if (cfg.family not in ("dense", "moe", "vlm")
            or cfg.moe_partition == "ep2d" and cfg.family == "moe"
            or {"shared", "enc_layers"} & set(tree_keys)):
        raise NotImplementedError(
            f"one rank's parameters are cut for the dense and MoE "
            f"expert/ffn trees, not for {cfg.name!r} ({cfg.family})")


def take_rank(params, rank: int, cfg):
    """This package's parameter dict at tp ranks -> model rank ``rank``'s:
    every per-rank leaf's ``[rank:rank+1]`` as a copy of its own (so the
    full tree can be freed), replicated leaves as they are."""
    _check_rank_slicing(params, cfg)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else [walk(x) for x in v] if isinstance(v, list)
                else v if k in REPLICATED or k in TOP_REPLICATED
                else v[rank:rank + 1].clone() for k, v in tree.items()}
    return walk(params)


def from_jax_params(params_np, cfg, pcfg=None, device=None, dtype=None,
                    rank=None):
    """Reference pytree (numpy leaves) -> this package's parameter dict,
    on ``device`` (CUDA unless given); with ``rank``, model rank
    ``rank``'s parameters alone (a leading rank axis of size 1)."""
    device = resolve_device(device)
    if rank is not None:
        _check_rank_slicing(params_np, cfg)

    def layers(tree, n):
        if "layer_0" in tree:
            per_layer = [tree[f"layer_{i}"] for i in range(n)]
        else:
            def take(t, i):
                return {k: take(v, i) if isinstance(v, dict) else v[i]
                        for k, v in t.items()}
            per_layer = [take(tree, i) for i in range(n)]
        return [_convert(lp, device, dtype, rank) for lp in per_layer]

    out = {
        "embedding": _convert(params_np["embedding"], device, dtype, rank),
        "norm_first": to_torch(params_np["norm_first"][0], device, dtype),
    }
    if "enc_layers" in params_np:
        out.update({k: to_torch(params_np[k][0], device, dtype)
                    for k in ("pos_enc", "pos_dec", "norm_first_enc")})
        out["enc_layers"] = layers(params_np["enc_layers"],
                                   cfg.encoder_layers)
        out["dec_layers"] = layers(params_np["dec_layers"], cfg.num_layers)
        return out
    out["layers"] = layers(params_np["layers"], cfg.num_layers)
    if "shared" in params_np:
        sh = params_np["shared"]
        out["shared"] = {
            "attn": _convert(sh["attn"], device, dtype),
            "norm_in": to_torch(sh["norm_in"][0], device, dtype),
            "norm_out": to_torch(sh["norm_out"][:, 0], device, dtype),
            "lora_a": to_torch(sh["lora_a"][:, 0], device, dtype),
            "lora_b": to_torch(sh["lora_b"], device, dtype)}
    return out


# top-level leaves the reference replicates with a leading size-1 axis
TOP_REPLICATED = ("norm_first", "pos_enc", "pos_dec", "norm_first_enc")


def _stacks_layers(cfg, pcfg=None) -> bool:
    """Whether the reference stacks its layers on a leading layer axis:
    the transformer families under ``scan_layers`` with uniform layer
    kinds, the other families always."""
    if cfg.family not in ("dense", "moe", "vlm"):
        return True
    from repro_torch.models.transformer import layer_kinds
    kinds = layer_kinds(cfg)
    return ((pcfg is None or pcfg.scan_layers)
            and all(k == kinds[0] for k in kinds))


def _walk(params, cfg, pcfg, leaf, stack):
    """The port's parameter tree (or a tree of its shape, as ``m``) in
    the reference's structure: ``leaf(t, kind, lead)`` maps each leaf,
    kind "replicated" (the reference gives it a leading size-1 axis),
    "per_invocation" (the size-1 axis after the hybrid's invocation
    axis), "sharded" (the per-shard axis is the port's rank axis) or
    "ep2d" (the data and rank axes), and ``lead`` is 1 inside layers the
    reference stacks; ``stack(list)`` joins one leaf over those layers
    (None keeps the port's list of layers)."""
    ep2d = cfg.family == "moe" and cfg.moe_partition == "ep2d"

    def conv(tree, lead, parent=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = conv(v, lead, k)
            elif k in REPLICATED:
                out[k] = leaf(v, "replicated", lead)
            elif ep2d and parent == "moe":
                out[k] = leaf(v, "ep2d", lead)
            else:
                out[k] = leaf(v, "sharded", lead)
        return out

    def join(trees):
        return {k: join([t[k] for t in trees])
                if isinstance(trees[0][k], dict) else stack([t[k] for t in trees])
                for k in trees[0]}

    def layers(lst):
        lead = int(_stacks_layers(cfg, pcfg))
        per = [conv(lp, lead) for lp in lst]
        if stack is None:
            return per
        if lead:
            return join(per)
        return {f"layer_{i}": lp for i, lp in enumerate(per)}

    out = {}
    for k, v in params.items():
        if k == "embedding":
            out[k] = conv(v, 0)
        elif k in TOP_REPLICATED:
            out[k] = leaf(v, "replicated", 0)
        elif k in ("layers", "enc_layers", "dec_layers"):
            out[k] = layers(v)
        elif k == "shared":
            out[k] = {"attn": conv(v["attn"], 0),
                      "norm_in": leaf(v["norm_in"], "replicated", 0),
                      "norm_out": leaf(v["norm_out"], "per_invocation", 0),
                      "lora_a": leaf(v["lora_a"], "per_invocation", 0),
                      "lora_b": leaf(v["lora_b"], "sharded", 1)}
        else:
            raise KeyError(f"unknown parameter group {k!r}")
    return out


def to_jax_layout(params, cfg, pcfg=None):
    """This package's parameter dict (or the optimizer's ``m`` / ``v``,
    trees of its shape) -> the reference's pytree, torch leaves on their
    own device and dtype: the inverse of ``from_jax_params``.  Replicated
    leaves get their size-1 axis back, stacked layers are stacked (new
    tensors), per-layer dicts are named ``layer_i``."""
    def leaf(t, kind, lead):
        if kind == "replicated":
            return t.unsqueeze(0)
        if kind == "per_invocation":
            return t.unsqueeze(1)
        return t
    return _walk(params, cfg, pcfg, leaf, torch.stack)


def reference_specs(params, cfg, pcfg=None):
    """The reference's ``api.specs()`` as tuples, in its structure: a
    replicated leaf all None, a sharded one ``"model"`` on its per-shard
    axis (after a stacked layer axis), an ``ep2d`` expert weight
    ``("data", "model")``."""
    def leaf(t, kind, lead):
        if kind == "replicated":
            return (None,) * (lead + 1)
        if kind == "per_invocation":
            return (None, None)
        return (None,) * lead + (("data", "model") if kind == "ep2d"
                                 else ("model",))
    return _walk(params, cfg, pcfg, leaf, lambda xs: xs[0])


def reference_ndims(params, cfg, pcfg=None):
    """Each leaf's number of dimensions in the reference's layout, in the
    port's structure (the reference decays the leaves with 2 or more)."""
    def leaf(t, kind, lead):
        return t.dim() + lead + (kind in ("replicated", "per_invocation"))
    return _walk(params, cfg, pcfg, leaf, None)
