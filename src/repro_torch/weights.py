"""Weight bridge: the reference package's parameter pytree, as numpy
arrays, to this package's parameter dict.

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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def to_torch(a, device=None, dtype=None) -> torch.Tensor:
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


def _convert(tree, device, dtype):
    """Keep the per-shard axis of sharded leaves as the rank axis; drop
    the size-1 axis of replicated ones."""
    return {k: (_convert(v, device, dtype) if isinstance(v, dict)
                else to_torch(v[0] if k in REPLICATED else v, device,
                              torch.float32 if k in FLOAT32 else dtype))
            for k, v in tree.items()}


def from_jax_params(params_np, cfg, pcfg=None, device=None, dtype=None):
    """Reference pytree (numpy leaves) -> this package's parameter dict,
    on ``device`` (CUDA unless given)."""
    device = resolve_device(device)

    def layers(tree, n):
        if "layer_0" in tree:
            per_layer = [tree[f"layer_{i}"] for i in range(n)]
        else:
            def take(t, i):
                return {k: take(v, i) if isinstance(v, dict) else v[i]
                        for k, v in t.items()}
            per_layer = [take(tree, i) for i in range(n)]
        return [_convert(lp, device, dtype) for lp in per_layer]

    out = {
        "embedding": _convert(params_np["embedding"], device, dtype),
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
