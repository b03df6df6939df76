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

``from_jax_params(..., rank=r)`` keeps model rank r's slice of every
per-rank leaf (replicated and per-invocation leaves whole), the
parameters of one process of a ``process_group`` model
(``distributed/context.py``); ``take_rank`` cuts the same slice out of
this package's dict.  Both cut each leaf on the axis ``_walk`` names for
it: the leading axis of a layer's or the embedding's leaf, axis 1 of the
hybrid's ``shared.lora_b``, and an ``ep2d`` expert weight's two leading
(data, model) axes at (``data_rank``, r), (D, R, E/D, ...) -> (1, 1,
E/D, ...): a process of a (data, model) mesh holds its data shard's
experts' d_ff slice, and of a (pod, data, model) mesh the same slice as
its data rank on every other pod (the experts split over ``data``
alone).

Over process groups (``training/train_step.py``): ``zero_dims`` gives
each leaf's ZeRO-1 dim and ``take_chunk`` a process's chunk on it;
``gather_ranks_tree`` and ``gather_pods`` put every process's slices,
chunks and pod entries back together, so that the launcher writes the
reference's full logical arrays (``to_jax_layout``), and ``take_pod``
cuts a process's error feedback out of them.

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


def _torch_tree(tree, device, dtype):
    """Every leaf of a tree in this package's structure as a tensor on
    ``device``: ``dtype``, or float32 for the ``FLOAT32`` leaves."""
    def one(k, v):
        if isinstance(v, dict):
            return _torch_tree(v, device, dtype)
        if isinstance(v, list):
            return [_torch_tree(x, device, dtype) for x in v]
        return to_torch(v, device, torch.float32 if k in FLOAT32 else dtype)
    return {k: one(k, v) for k, v in tree.items()}


def _narrow(t, axis: int, rank: int):
    """Rank ``rank``'s slice of ``t`` on ``axis`` (a view)."""
    return t[(slice(None),) * axis + (slice(rank, rank + 1),)]


def _data_rank(cfg, data_rank):
    """The data rank an ``ep2d`` tree is cut at (0 for other trees)."""
    if cfg.family == "moe" and cfg.moe_partition == "ep2d":
        if data_rank is None:
            raise ValueError(f"{cfg.name!r} splits its experts over the "
                             f"data axis too: pass data_rank")
        return data_rank
    return 0


def _cut(t, kind, lead, rank, data_rank):
    """Model rank ``rank``'s slice of a leaf of ``kind`` (a view): on axis
    ``lead`` of a sharded leaf, on the (data, model) axes of an ``ep2d``
    one."""
    if kind == "ep2d":
        return _narrow(_narrow(t, lead, data_rank), lead + 1, rank)
    return _narrow(t, lead, rank)


def take_rank(params, rank: int, cfg, data_rank=None):
    """This package's parameter dict at tp ranks -> model rank ``rank``'s
    (and, for an ``ep2d`` tree, data rank ``data_rank``'s): every sharded
    leaf's slice on its rank axes as a copy of its own (so the full tree
    can be freed), replicated leaves as they are."""
    data_rank = _data_rank(cfg, data_rank)

    def cut(t, kind, lead):
        if kind not in ("sharded", "ep2d"):
            return t
        return _cut(t, kind, lead, rank, data_rank).clone(
            memory_format=torch.contiguous_format)
    return _walk(params, cfg, None, cut, None, layer_axis=False)


def _zip_map(fn, tree, *others):
    """``fn`` over the leaves of ``tree`` and the same places of
    ``others`` (dicts, lists and tuples in ``tree``'s structure; a tuple
    of ``others`` whose ``tree`` place is a tensor is a leaf)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others)


class _Place:
    """Where one leaf of the port's tree lies: its ``kind`` (``_walk``'s),
    ``axis``, the port leaf's rank axis (a sharded leaf's model axis; an
    ``ep2d`` one's data axis, its model axis next), ``stacked``, whether
    the reference stacks it over the layers, and in a layer's leaf
    ``layer``, the layer's index of ``n_layers`` in its stack."""

    def __init__(self, t, kind: str, axis: int):
        self.shape, self.kind, self.axis = tuple(t.shape), kind, axis
        self.stacked, self.layer, self.n_layers = 0, None, 0


def _places(params, cfg, pcfg=None):
    """Every leaf's ``_Place``, in the port's structure: any family's
    tree, the rank axis's or one process's."""
    places = _walk(params, cfg, pcfg, _Place, None, layer_axis=False)

    def stack(p, lead):
        p.stacked = lead - p.axis
        return p
    places = _zip_map(stack, places, _walk(params, cfg, pcfg,
                                           lambda t, kind, lead: lead, None))
    for k in ("layers", "enc_layers", "dec_layers"):
        for i, lp in enumerate(places.get(k, ())):
            for p in _leaves(lp):
                p.layer, p.n_layers = i, len(places[k])
    return places


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def leaf_kinds(params, cfg, pcfg=None):
    """Each leaf's kind in the port's structure: "sharded" (one model
    rank's slice), "replicated" or "per_invocation" (whole on every model
    rank) or "ep2d" (one (data, model) rank's experts)."""
    return _zip_map(lambda p: p.kind, _places(params, cfg, pcfg))


class LayerChunk:
    """The ZeRO-1 "dim" of a layer's leaf whose chunk the reference takes
    on its stacked layer axis: data-parallel rank ``owner`` (the one whose
    L/D layers hold this layer) keeps the whole leaf, of ``shape``, the
    others none of it."""

    def __init__(self, owner: int, shape):
        self.owner, self.shape = owner, tuple(shape)


class PodChunk:
    """The ZeRO-1 dim of an ``ep2d`` expert leaf under a pod axis: its
    spec holds ``"data"`` already, so the reference's ``zero_extend``
    gives it the one data-parallel axis left, ``"pod"``, and each pod rank
    keeps chunk ``pod_rank`` of ``pod_size`` on ``dim``."""

    def __init__(self, dim: int):
        self.dim = dim


def zero_dims(params, cfg, pcfg, dp_size: int):
    """The port's dim ZeRO-1 splits each leaf's ``m`` / ``v`` over, or
    None where the leaf stays whole, in the port's structure: the dim
    ``optimizer.zero_extend`` picks in the reference's layout of the leaf
    (its spec and shape, the stack's layer count where the reference
    stacks the layers, the size-1 axis of a replicated leaf), moved to
    the port's layout; where it picks the stacked layer axis, a
    ``LayerChunk``; for an ``ep2d`` leaf, whose pick is the pod axis, a
    ``PodChunk``.  ``params`` is the rank axis's tree or one process's
    (its rank axes, of size 1 there, are the spec's ``"model"`` and
    ``"data"`` axes either way, never picked)."""
    from repro_torch.training.optimizer import zero_extend

    def leaf(p):
        lead = p.stacked
        shape, spec = list(p.shape), [None] * len(p.shape)
        if p.kind == "sharded":
            spec[p.axis] = "model"
        elif p.kind == "ep2d":
            spec[p.axis:p.axis + 2] = ["data", "model"]
        ins = {"replicated": 0, "per_invocation": 1}.get(p.kind)
        if ins is not None:
            shape.insert(ins, 1)
            spec.insert(ins, None)
        zs = zero_extend((p.n_layers,) * lead + tuple(shape),
                         (None,) * lead + tuple(spec), pcfg.dp_axes, dp_size)
        picked = [i - lead for i, e in enumerate(zs)
                  if e is not None and (i < lead or spec[i - lead] is None)]
        if not picked:
            return None
        if picked[0] < 0 and p.kind == "ep2d":
            raise NotImplementedError(
                "a ZeRO-1 chunk of an ep2d leaf over the pod axis on its "
                "stacked layer axis is not ported")
        if picked[0] < 0:
            return LayerChunk(p.layer // (p.n_layers // dp_size), p.shape)
        dim = picked[0] - (ins is not None and picked[0] > ins)
        return PodChunk(dim) if p.kind == "ep2d" else dim
    return _zip_map(leaf, _places(params, cfg, pcfg))


def take_chunk(tree, dims, dp_rank: int, dp_size: int, pods: int = 1):
    """ZeRO-1 chunk ``dp_rank`` of ``dp_size`` of every leaf of ``tree``
    (a process's ``m`` / ``v``, or its params or gradients) on its dim in
    ``dims`` (``zero_dims``), as a view; a leaf whose dim is None whole,
    a ``LayerChunk`` leaf whole on its owner and empty (no rows of its
    first dim) elsewhere, a ``PodChunk`` leaf's chunk of ``pods`` at the
    pod of ``dp_rank`` (pod outer)."""
    def cut(t, dim):
        if dim is None:
            return t
        if isinstance(dim, LayerChunk):
            return t if dim.owner == dp_rank else t.narrow(0, 0, 0)
        if isinstance(dim, PodChunk):
            n = t.shape[dim.dim] // pods
            return t.narrow(dim.dim, dp_rank // (dp_size // pods) * n, n)
        n = t.shape[dim] // dp_size
        return t.narrow(dim, dp_rank * n, n)
    return _zip_map(cut, tree, dims)


def gather_dim(t, dim: int, group):
    """Every group rank's ``t`` joined on ``dim``, rank-major."""
    import torch.distributed as dist
    size = dist.get_world_size(group)
    if size == 1:
        return t
    moved = t.movedim(dim, 0).contiguous()
    out = moved.new_empty((size * moved.shape[0], *moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def gather_ranks_tree(tree, cfg, groups, dims=None, pcfg=None):
    """The inverse of ``take_rank`` (and, with ``dims``, of
    ``take_chunk``) over process groups: every process's tree (its model
    rank's slice of each sharded leaf, its (data, model) rank's experts of
    an ``ep2d`` one; with ``dims`` its ZeRO-1 chunk on those dims) -> the
    rank axis's whole tree on every process: each chunk gathered over
    ``groups.dp`` (a ``LayerChunk`` leaf broadcast from its owner, a
    ``PodChunk`` one gathered over ``groups.pod``), then
    each sharded leaf over ``groups.model`` on its rank axis, an
    ``ep2d`` leaf over ``groups.model`` and then ``groups.data`` on its
    two.  A collective: every process calls it with trees of the same
    structure."""
    places = _places(tree, cfg, pcfg)
    if dims is None:
        dims = _zip_map(lambda t: None, tree)

    def one(t, p, dim):
        if isinstance(dim, LayerChunk):
            t = broadcast_owned(t, dim, groups)
        elif isinstance(dim, PodChunk):
            t = gather_dim(t, dim.dim, groups.pod)
        elif dim is not None:
            t = gather_dim(t, dim, groups.dp)
        if p.kind == "sharded":
            t = gather_dim(t, p.axis, groups.model)
        elif p.kind == "ep2d":
            t = gather_dim(gather_dim(t, p.axis + 1, groups.model), p.axis,
                           groups.data)
        return t
    return _zip_map(one, tree, places, dims)


def broadcast_owned(t, chunk: LayerChunk, groups):
    """A ``LayerChunk`` leaf whole on every data-parallel rank: its
    owner's ``t`` broadcast over ``groups.dp`` (the others' ``t`` is
    empty)."""
    import torch.distributed as dist
    if groups.dp_rank != chunk.owner:
        t = t.new_empty(chunk.shape)
    else:
        t = t.contiguous()
    dist.broadcast(t, src=dist.get_global_rank(groups.dp, chunk.owner),
                   group=groups.dp)
    return t


def _model_axis(spec):
    """The index of ``"model"`` in a reference spec tuple, or None."""
    for i, e in enumerate(spec):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return i
    return None


def take_pod(ef, specs, pod_rank: int, model_rank: int):
    """A process's part of the int8 pod reduce's error feedback, from the
    rank axis's (leaves (P, *reference leaf), ``specs`` the reference's
    specs of the leaves): its pod's entry, (1, ...), and its model rank's
    block on the spec's ``"model"`` axis."""
    def cut(e, spec):
        e = e.narrow(0, pod_rank, 1)
        axis = _model_axis(spec)
        return e if axis is None else e.narrow(axis + 1, model_rank, 1)
    return _zip_map(cut, ef, specs)


def gather_pods(ef, specs, groups):
    """The inverse of ``take_pod`` over process groups: every process's
    error feedback -> the rank axis's (P, ...) whole on every process.  A
    collective."""
    def one(e, spec):
        e = gather_dim(e, 0, groups.pod)
        axis = _model_axis(spec)
        return e if axis is None else gather_dim(e, axis + 1, groups.model)
    return _zip_map(one, ef, specs)


def from_jax_params(params_np, cfg, pcfg=None, device=None, dtype=None,
                    rank=None, data_rank=None):
    """Reference pytree (numpy leaves) -> this package's parameter dict,
    on ``device`` (CUDA unless given); with ``rank``, model rank
    ``rank``'s parameters alone (a rank axis of size 1; an ``ep2d``
    tree's experts at ``data_rank`` too), cut from views before anything
    is copied."""
    device = resolve_device(device)
    if rank is not None:
        data_rank = _data_rank(cfg, data_rank)

    def layers(tree, n):
        if "layer_0" in tree:
            return [tree[f"layer_{i}"] for i in range(n)]

        def take(t, i):
            return {k: take(v, i) if isinstance(v, dict) else v[i]
                    for k, v in t.items()}
        return [take(tree, i) for i in range(n)]

    tree = dict(params_np)
    for k, n in (("layers", cfg.num_layers), ("dec_layers", cfg.num_layers),
                 ("enc_layers", cfg.encoder_layers)):
        if k in tree:
            tree[k] = layers(tree[k], n)

    def leaf(t, kind, lead):
        if kind == "replicated":
            return t[0]
        if kind == "per_invocation":
            return t[:, 0]
        return t if rank is None else _cut(t, kind, lead, rank, data_rank)
    return _torch_tree(_walk(tree, cfg, pcfg, leaf, None, layer_axis=False),
                       device, dtype)


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


def _walk(params, cfg, pcfg, leaf, stack, *, layer_axis: bool = True):
    """The port's parameter tree (or a tree of its shape, as ``m``) in
    the reference's structure: ``leaf(t, kind, lead)`` maps each leaf,
    kind "replicated" (the reference gives it a leading size-1 axis),
    "per_invocation" (the size-1 axis after the hybrid's invocation
    axis), "sharded" (the per-shard axis, axis ``lead``, is the port's
    rank axis) or "ep2d" (the data and rank axes), and ``lead`` is 1
    inside layers the reference stacks (with ``layer_axis=False`` 0: the
    axes of one layer's leaf) and for the hybrid's ``shared.lora_b``,
    whose invocation axis leads; ``stack(list)`` joins one leaf over
    those layers (None keeps the port's list of layers).  The one place
    that decides each leaf's kind: the reference's layout and specs, and
    the rank cuts of ``take_rank`` and ``from_jax_params``."""
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
        lead = int(layer_axis and _stacks_layers(cfg, pcfg))
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
