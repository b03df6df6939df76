"""AdamW with ZeRO-1 optimizer-state specs, as ``repro.training.optimizer``.

The update is elementwise and runs on the whole layout of one device: the
parameters, their gradients and the float32 ``m`` / ``v`` are trees of the
same structure, and ``adamw_update`` writes the new values in place.
``zero_specs`` / ``opt_state_specs`` are the reference's pure functions
over shapes and PartitionSpecs (tuples here, in the reference's layout:
``weights.reference_specs``): for each leaf, the dims the data axes split
the optimizer state over.  On one card's rank axes the layout stays
whole.  Over process groups (``training/train_step.py``) each process
holds its chunk of ``m`` / ``v`` on the dim these specs pick
(``weights.zero_dims``), ``adamw_update`` runs on the chunks, and
``global_norm`` counts every part once over the groups.

Weight decay follows the reference's rule, ``ndim >= 2``, counted in the
reference's layout (``weights.reference_ndims``): there a replicated leaf
keeps a size-1 axis and stacked layers a layer axis, so the port's rank
axis (or its lack) never decides it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params):
    """Float32 zeros like every leaf (``m``, ``v``) and the int32 step."""
    leaves = tree_flatten(params)[0]
    dev = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def zero_extend(shape, spec, dp_axes, dp_size: int) -> tuple:
    """One leaf's ZeRO-1 spec: ``spec`` (a tuple) extended with the
    unused dp axes on the largest free dim of ``shape`` that they divide,
    as long as the leaf's ndim; unchanged where no dim divides."""
    n_dp = max(len(dp_axes), 1)
    per_axis = max(int(round(dp_size ** (1.0 / n_dp))), 1)
    shape = tuple(shape)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                used.add(a)
    avail = [a for a in dp_axes if a not in used]
    if not avail:
        return tuple(entries)
    div = per_axis ** len(avail) if len(avail) < n_dp else dp_size
    best, best_size = -1, 0
    for i, (dim, s) in enumerate(zip(shape, entries)):
        if s is None and dim % div == 0 and dim > best_size:
            best, best_size = i, dim
    if best < 0:
        return tuple(entries)
    entries[best] = tuple(avail) if len(avail) > 1 else avail[0]
    return tuple(entries)


def zero_specs(shapes, pspecs, dp_axes, dp_size: int):
    """Extend each param spec with the (unused) dp axes on a divisible
    free dim, the largest; params already sharded over a dp axis (ep2d
    experts) only get the remaining axes (``zero_extend``).  ``shapes``: a
    tree of shape tuples (or tensors) in the structure of ``pspecs``, a
    tree of spec tuples.  Returns the tree of extended spec tuples, each
    as long as its leaf's ndim."""
    spec_leaves, treedef = tree_flatten(pspecs, is_leaf=_is_spec)
    shape_leaves = tree_flatten(shapes, is_leaf=lambda x: isinstance(
        x, (tuple, torch.Size)))[0]
    return tree_unflatten(
        [zero_extend(getattr(sh, "shape", sh), sp, dp_axes, dp_size)
         for sh, sp in zip(shape_leaves, spec_leaves)], treedef)


def opt_state_specs(shapes, pspecs, dp_axes, dp_size: int):
    zs = zero_specs(shapes, pspecs, dp_axes, dp_size)
    return {"m": zs, "v": zs, "step": ()}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``: float32, as the reference's."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree, owned=None, group=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of
    squares.  Over process groups each process holds a part of every
    leaf (a model rank's slice, a ZeRO-1 chunk) or a copy of one:
    ``owned`` (one bool per leaf, in ``tree_flatten`` order) says which
    of its leaves this process counts, so that every part counts once,
    and the sum of squares is all-reduced over ``group`` (the processes
    that hold the parts) before the root."""
    leaves = tree_flatten(tree)[0]
    total = None
    for x, mine in zip(leaves, owned or [True] * len(leaves)):
        ss = torch.sum(torch.square(x.float()))
        if not mine:
            ss = torch.zeros_like(ss)
        total = ss if total is None else total + ss
    if owned is not None:
        dist.all_reduce(total, group=group)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: AdamWConfig, gnorm=None,
                 decay_mask=None):
    """One AdamW step with global-norm clipping and warm-up, in float32,
    the reference's arithmetic leaf by leaf.  ``decay_mask``: a tree of
    bools in the structure of ``params`` (``weights.reference_ndims(...)
    >= 2``); without one a leaf decays iff its ndim >= 2, the reference's
    rule on the tree given.  Writes the new params (cast back to their
    dtype), ``m``, ``v`` and ``step`` in place and returns (params,
    opt_state, gnorm)."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, step)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    p_l = tree_flatten(params)[0]
    g_l = tree_flatten(grads)[0]
    m_l = tree_flatten(opt_state["m"])[0]
    v_l = tree_flatten(opt_state["v"])[0]
    d_l = (tree_flatten(decay_mask)[0] if decay_mask is not None
           else [p.dim() >= 2 for p in p_l])
    if not len(p_l) == len(g_l) == len(m_l) == len(v_l) == len(d_l):
        raise ValueError("params, grads, m, v and the decay mask differ in "
                         "structure")
    for p, g, m, v, dec in zip(p_l, g_l, m_l, v_l, d_l):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        decay = cfg.weight_decay if dec else 0.0
        p.copy_((p.float() * (1 - lr * decay) - lr * delta).to(p.dtype))
    opt_state["step"].copy_(step)
    return params, opt_state, gnorm
