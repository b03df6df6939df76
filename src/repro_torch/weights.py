"""Weight bridge: the reference package's parameter pytree, as numpy
arrays, to this package's parameter dict.

``params_np`` is ``jax.tree.map(np.asarray, params)`` of
``repro.models.transformer.init_params`` at any tp.  Three layouts need
care:

* layers are either stacked with a leading layer axis (``scan_layers``
  with uniform layer kinds) or a ``{"layer_i": ...}`` dict;
* every sharded weight carries a per-shard leading axis of size tp, kept
  as the port's rank axis; the replicated weights (norm gains, q/k norms,
  the row-parallel output bias) carry an axis of size 1 and drop it;
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


# leaves the reference replicates (PartitionSpec None): (1, n) -> (n,)
REPLICATED = frozenset({"norm_attn", "norm_ffn", "norm_attn_post",
                        "norm_ffn_post", "q_norm", "k_norm", "b_out"})


def _convert(tree, device, dtype):
    """Keep the per-shard axis of sharded leaves as the rank axis; drop
    the size-1 axis of replicated ones."""
    return {k: (_convert(v, device, dtype) if isinstance(v, dict)
                else to_torch(v[0] if k in REPLICATED else v, device, dtype))
            for k, v in tree.items()}


def from_jax_params(params_np, cfg, pcfg=None, device=None, dtype=None):
    """Reference pytree (numpy leaves) -> this package's parameter dict,
    on ``device`` (CUDA unless given)."""
    device = resolve_device(device)
    layers_np = params_np["layers"]
    if "layer_0" in layers_np:
        per_layer = [layers_np[f"layer_{i}"] for i in range(cfg.num_layers)]
    else:
        def take(tree, i):
            return {k: take(v, i) if isinstance(v, dict) else v[i]
                    for k, v in tree.items()}
        per_layer = [take(layers_np, i) for i in range(cfg.num_layers)]
    return {
        "embedding": _convert(params_np["embedding"], device, dtype),
        "norm_first": to_torch(params_np["norm_first"][0], device, dtype),
        "layers": [_convert(lp, device, dtype) for lp in per_layer],
    }
