"""Train-step builders, as ``repro.training.train_step``.

The reference runs one program per device under ``shard_map``; here one
process runs ``torch.autograd`` over the whole rank-axis layout of one
device (``distributed/context.py``): the model ranks on the rank axis R,
the data-parallel axes (``pod`` x ``data``, pod outer) folded into the
data rank axis D = ``api.ep`` over the batch's rows.  A replicated leaf
(a norm gain, stored once) is used by every rank, so its gradient comes
out summed over its uses, which is what the reference's shard_map
transpose gives (and what its manual step's ``_sync_model_axis`` does);
a sharded leaf holds every rank's slice and gets every slice's gradient.

``make_train_step`` (default): the global token mean
``sum(loss_sum) / max(sum(denom), 1) + mean(aux)`` over the D data
shards, one backward, AdamW.

``make_manual_sync_train_step``: the reference's manual variant and its
semantics: each data shard's loss is the mean over its own tokens (plus
its aux), the gradients are summed over the data shards, then divided by
their number (the reference's divisor with VMA-tracking jax), and the
global norm counts each replicated leaf once, as the reference's
``_manual_global_norm`` does: here every slice of a sharded leaf is
present and a replicated leaf is stored once, so that is the plain
``global_norm`` of the tree.
With ``compress_pod`` the pod reduce is the int8 one with per-pod
float32 error feedback, as the reference runs it: its parameters are
invariant over ``pod`` and ``data``, so jax's VMA-aware transpose hands
every pod the gradient already summed over both axes, each pod quantizes
that sum plus its own error, and the reduce adds the pods' payloads,
which counts the sum once per pod (the port reproduces this; ROADMAP.md
C).  One backward serves both forms.

Over process groups (``api.groups``, ``launch.mesh.init_groups``: one
(pod, data, model) rank per process, every family) a process runs
its data-parallel shard's rows of the global batch (``_own_rows``).  The
loss is computed whole on every model rank (the cross-entropy's sums run
over the model group), so each process seeds its backward with 1/tp:
the model group's seeds sum to one, and a collective's backward, which
sums the ranks' cotangents (``distributed/collectives.py``), hands each
rank's slice the gradient the rank axis gives it (seeding each with 1
would make every gradient tp times too large, the reference's own note
on its manual step).  A replicated leaf's gradient then holds only this
process's uses and is summed over the model group (``_sync_model_axis``);
a sharded leaf's slice is exact.  An ``ep2d`` expert leaf (experts
over the data axis alone, every pod holding each once) has its gradient
summed over the pod group.  ``make_train_step`` holds ZeRO-1
state: each process keeps its chunk of ``m`` / ``v`` on the dim
``zero_specs`` picks (``weights.zero_dims``; an ``ep2d`` leaf's over the
pod group alone), the chunked gradients are
reduce-scattered over the data-parallel group and the rest all-reduced,
AdamW updates the chunks and the params are all-gathered; the global
norm counts every slice and chunk once (``optimizer.global_norm`` with
``owned``).  ``make_manual_sync_train_step`` keeps ``m`` / ``v`` whole,
as the reference's; its gradient is summed over the data-parallel group
before the int8 pod reduce, which runs over the pod group.

Both builders return ``(step, init_fn)`` with the reference's signatures
except that ``init_fn`` takes an integer seed, not a PRNG key (the port's
init draws from a seeded ``torch.Generator``), and a ``device`` (CUDA
unless given).  ``step`` updates the params and the optimizer state in
place and returns them with ``{"loss", "grad_norm"}`` (float32 scalars on
the params' device).  ``state_specs`` gives the reference's param and
ZeRO-1 optimizer-state PartitionSpecs (tuples) for a parameter tree.
A step's loss, backward (the remat recomputes in it) and optimizer run in
named ranges (``RANGES``) so that a profile can split their device time.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch import weights
from repro_torch.device import resolve_device
from repro_torch.training import compression as C
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            global_norm, init_opt_state,
                                            opt_state_specs)

FORWARD_RANGE = "repro_torch.train.forward"     # the loss
BACKWARD_RANGE = "repro_torch.train.backward"   # autograd, remat included
OPTIMIZER_RANGE = "repro_torch.train.optimizer"  # the pod reduce, AdamW
RANGES = {"train_forward": FORWARD_RANGE, "train_backward": BACKWARD_RANGE,
          "train_optimizer": OPTIMIZER_RANGE}
_record = torch.profiler.record_function


def _check_layout(api, mesh) -> int:
    """The data size D, after checking the api (and its groups) against
    the mesh."""
    pcfg = api.pcfg
    tp, dp = mesh.size(pcfg.tp_axis), mesh.dp_size(pcfg.dp_axes)
    if api.tp != tp or api.ep != dp:
        raise ValueError(f"the model is built for tp={api.tp}, ep={api.ep}; "
                         f"the mesh {mesh.shape} over dp_axes "
                         f"{pcfg.dp_axes} gives tp={tp}, data size {dp}")
    if (api.cfg.is_moe and api.cfg.moe_partition == "ep2d"
            and api.pods != mesh.size("pod")):
        raise ValueError(f"ep2d experts split over the data axis alone: "
                         f"build the model with pods={mesh.size('pod')} "
                         f"for the mesh {mesh.shape}, not {api.pods}")
    g = api.groups
    if g is not None:
        got = (g.pod_size, g.data_size, g.model_size)
        if got != (mesh.size("pod"), mesh.size("data"), tp):
            raise ValueError(f"groups of (pod, data, model) sizes {got} "
                             f"against the mesh {mesh.shape}")
    return dp


def _to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _own_rows(batch, groups):
    """This process's rows of the global batch: its data-parallel shard's,
    ``[dp_rank·B/D, (dp_rank+1)·B/D)`` (``transformer.data_layout``'s
    order); the whole batch without groups."""
    if groups is None:
        return batch
    rows = next(iter(batch.values())).shape[0]
    if rows % groups.dp_size:
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{groups.dp_size} data-parallel shards")
    n = rows // groups.dp_size
    lo = groups.dp_rank * n
    return {k: v[lo:lo + n] for k, v in batch.items()}


def _device_of(params) -> torch.device:
    return tree_flatten(params)[0][0].device


def _decay_mask(api, params):
    """The reference's weight-decay rule, ndim >= 2 in its layout."""
    return tree_map(lambda n: n >= 2,
                    weights.reference_ndims(params, api.cfg, api.pcfg))


def _grads(loss, params, seed: float = 1.0):
    """d loss / d every leaf of ``params`` (zeros for an unused leaf), in
    the structure of ``params``; the backward seeded with ``seed``."""
    leaves, treedef = tree_flatten(params)
    got = torch.autograd.grad(loss, leaves, torch.full_like(loss, seed),
                              allow_unused=True)
    return tree_unflatten([torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, got)], treedef)


def _trainable(params):
    for p in tree_flatten(params)[0]:
        p.requires_grad_(True)


def state_specs(api, params, dp_size: int):
    """(param specs, ZeRO-1 optimizer-state specs), the reference's
    PartitionSpecs as tuples in its layout, for ``params``."""
    pspec = api.specs(params)
    shapes = tree_map(lambda t: tuple(t.shape), weights.to_jax_layout(
        tree_map(lambda t: t.to("meta"), params), api.cfg, api.pcfg))
    return pspec, opt_state_specs(shapes, pspec, api.pcfg.dp_axes, dp_size)


# --------------------------------------------------------------------------
# over process groups: one (pod, data, model) rank per process
# --------------------------------------------------------------------------

def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The float32 sum of ``t`` over ``group``, rounded once to its
    dtype."""
    buf = t.detach().float()
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


class _GroupLayout:
    """How one process's leaves lie over the groups (any family's tree:
    ``weights.leaf_kinds``): each leaf sharded over the model group,
    replicated on it (``replicated``, ``per_invocation``) or one (data,
    model) rank's experts (``ep2d``, the same on every pod), and its
    ZeRO-1 dim over the data-parallel group (``weights.zero_dims``; None:
    whole on every data-parallel rank; an ``ep2d`` leaf's over the pod
    group, ``weights.PodChunk``), with ``zero=False`` none (the manual
    step keeps the reference's unchunked state)."""

    SYNCED = ("replicated", "per_invocation")    # summed over the model

    def __init__(self, api, params, zero: bool):
        g = api.groups
        self.groups = g
        self.kinds = tree_flatten(weights.leaf_kinds(params, api.cfg,
                                                     api.pcfg))[0]
        dims = (weights.zero_dims(params, api.cfg, api.pcfg, g.dp_size)
                if zero and g.dp_size > 1 else None)
        self.dims_tree = dims
        self.dims = (_flat_dims(dims) if dims is not None
                     else [None] * len(self.kinds))

    def chunks(self, tree):
        """This process's ZeRO-1 chunk of every leaf (views)."""
        if self.dims_tree is None:
            return tree
        return weights.take_chunk(tree, self.dims_tree, self.groups.dp_rank,
                                  self.groups.dp_size, self.groups.pod_size)

    def sync_model(self, grads: list) -> list:
        """``_sync_model_axis``: a replicated leaf's gradient summed over
        the model group (each process holds the part from its own uses);
        a sharded leaf's slice stays local."""
        return [_sum_over(g, self.groups.model) if k in self.SYNCED else g
                for g, k in zip(grads, self.kinds)]

    def reduce_dp(self, grads: list) -> list:
        """The data-parallel gradient sum in float32, rounded once: a
        chunked leaf's reduce-scattered to this process's chunk, the
        others all-reduced; an ``ep2d`` leaf's summed over the pod group
        alone (its data rank owns those experts in every pod, and their
        gradient came home from each of the pod's shards through the
        all-to-alls' backward), reduce-scattered on a ``PodChunk``.
        Consumes ``grads``: each entry is dropped once reduced, so that a
        whole leaf's gradient is freed as its chunk is made."""
        g = self.groups
        out = []
        for i, (dim, kind) in enumerate(zip(self.dims, self.kinds)):
            t, grads[i] = grads[i], None
            if kind == "ep2d":
                out.append(t if g.pod_size == 1
                           else _reduce_scatter(t, dim.dim, g.pod)
                           if isinstance(dim, weights.PodChunk)
                           else _sum_over(t, g.pod))
            elif g.dp_size == 1:
                out.append(t)
            elif dim is None:
                out.append(_sum_over(t, g.dp))
            elif isinstance(dim, weights.LayerChunk):
                # the owner's whole leaf, nothing elsewhere
                buf = t.detach().float().contiguous()
                dist.reduce(buf, dist.get_global_rank(g.dp, dim.owner),
                            group=g.dp)
                out.append(buf.to(t.dtype) if g.dp_rank == dim.owner
                           else t.narrow(0, 0, 0))
            else:
                out.append(_reduce_scatter(t, dim, g.dp))
        return out

    def owned(self) -> list:
        """Which leaves this process's norm counts, so that over the
        world every part counts once: a replicated leaf on model rank 0
        alone, an unchunked leaf on data-parallel rank 0 alone, a
        ``LayerChunk`` leaf on its owner, an ``ep2d`` leaf on every
        (data, model) rank (each holds its own experts) of pod 0, or of
        every pod where its ``PodChunk`` splits it over the pods."""
        g = self.groups

        def on_dp(dim):
            if isinstance(dim, weights.LayerChunk):
                return dim.owner == g.dp_rank
            return dim is not None or g.dp_rank == 0
        return [(dim is not None or g.pod_rank == 0) if k == "ep2d"
                else ((k not in self.SYNCED or g.model_rank == 0)
                      and on_dp(dim))
                for k, dim in zip(self.kinds, self.dims)]

    @torch.no_grad()
    def gather_params(self, params: list) -> None:
        """Every data-parallel rank's updated chunk into each chunked
        param, in place."""
        g = self.groups
        for p, dim in zip(params, self.dims):
            if isinstance(dim, weights.LayerChunk):
                p.copy_(weights.broadcast_owned(p, dim, g))
            elif isinstance(dim, weights.PodChunk):
                n = p.shape[dim.dim] // g.pod_size
                p.copy_(weights.gather_dim(
                    p.narrow(dim.dim, g.pod_rank * n, n), dim.dim, g.pod))
            elif dim is not None:
                n = p.shape[dim] // g.dp_size
                p.copy_(weights.gather_dim(p.narrow(dim, g.dp_rank * n, n),
                                           dim, g.dp))


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk on ``dim`` of the float32 sum of ``t`` over
    ``group``, rounded once to its dtype."""
    moved = t.detach().movedim(dim, 0).float().contiguous()
    part = moved.new_empty((moved.shape[0] // dist.get_world_size(group),
                            *moved.shape[1:]))
    dist.reduce_scatter_tensor(part, moved, group=group)
    return part.to(t.dtype).movedim(0, dim)


def _flat_dims(dims) -> list:
    """A tree of ints and Nones -> its leaves in ``tree_flatten``'s order,
    every None kept as a leaf (``tree_flatten`` treats None as an empty
    node in some torch versions)."""
    if isinstance(dims, dict):
        return [x for v in dims.values() for x in _flat_dims(v)]
    if isinstance(dims, (list, tuple)):
        return [x for v in dims for x in _flat_dims(v)]
    return [dims]


def _update(api, layout, params, grads, opt, ocfg, gnorm):
    """AdamW on this process's chunks (``layout``), then every chunked
    param gathered over the data-parallel group."""
    decay = tree_flatten(_decay_mask(api, params))[0]
    with torch.no_grad():
        chunks = tree_flatten(layout.chunks(params))[0]
        m_l, v_l = tree_flatten(opt["m"])[0], tree_flatten(opt["v"])[0]
        if [c.shape for c in chunks] != [m.shape for m in m_l]:
            raise ValueError("the params' chunks and the optimizer state "
                             "differ in structure (make the state from "
                             "these params: init_opt_state)")
        adamw_update(chunks, grads, {"m": m_l, "v": v_l,
                                     "step": opt["step"]},
                     ocfg, gnorm=gnorm, decay_mask=decay)
    layout.gather_params(tree_flatten(params)[0])
    return params, opt


def make_loss_fn(api, mesh):
    """The global-mean loss over the data shards: params, batch ->
    float32 scalar.  Over groups the batch is this process's rows and
    the loss this process's part of the global mean (its shard's loss
    sum over the global token count, and its share of the mean aux): the
    data-parallel sum of the parts is the loss."""
    _check_layout(api, mesh)
    g = api.groups

    def loss_fn(params, batch):
        ls, dn, aux = api.train_loss(params, batch)
        if g is None:
            return ls.sum() / torch.clamp(dn.sum(), min=1.0) + aux.mean()
        denom = torch.clamp(_sum_over(dn.sum(), g.dp), min=1.0)
        return ls.sum() / denom + aux.sum() / g.dp_size
    return loss_fn


def make_train_step(api, mesh, batch_like, ocfg: AdamWConfig,
                    dp_size: int):
    """Returns (step, init_fn).  step(params, opt, batch) -> (params, opt,
    metrics); ``batch`` numpy arrays or tensors {"tokens", "labels", ...}
    of the global batch.  init_fn(seed, *, device=None) -> (params,
    opt).

    With ``api.groups`` each process takes its data-parallel shard's rows
    of the batch, seeds its backward with 1/tp (the loss is computed on
    every model rank), sums a replicated leaf's gradient over the model
    group, reduce-scatters each leaf with a ZeRO-1 dim over the
    data-parallel group (the others are all-reduced), runs AdamW on its
    chunks of the params against its chunks of ``m`` / ``v``, and
    all-gathers the params; ``init_fn`` gives its slice of the rank
    axis's params and its chunks of the state."""
    if _check_layout(api, mesh) != dp_size:
        raise ValueError(f"dp_size={dp_size} differs from the mesh's data "
                         f"size {mesh.dp_size(api.pcfg.dp_axes)}")
    loss_fn = make_loss_fn(api, mesh)
    g = api.groups

    def step(params, opt, batch):
        _trainable(params)
        batch = _to_device(_own_rows(batch, g), _device_of(params))
        with _record(FORWARD_RANGE):
            loss = loss_fn(params, batch)
        with _record(BACKWARD_RANGE):
            grads = _grads(loss, params, 1.0 if g is None
                           else 1.0 / g.model_size)
        with _record(OPTIMIZER_RANGE):
            if g is None:
                params, opt, gnorm = adamw_update(
                    params, grads, opt, ocfg,
                    decay_mask=_decay_mask(api, params))
                return params, opt, {"loss": loss.detach(),
                                     "grad_norm": gnorm}
            lay = _GroupLayout(api, params, zero=True)
            leaves = lay.sync_model(tree_flatten(grads)[0])
            del grads
            grads = lay.reduce_dp(leaves)
            gnorm = global_norm(grads, lay.owned())
            params, opt = _update(api, lay, params, grads, opt, ocfg, gnorm)
            loss = _sum_over(loss, g.dp)
        return params, opt, {"loss": loss, "grad_norm": gnorm}

    def init_fn(seed: int, *, device=None):
        params = api.init(seed, device=resolve_device(device))
        if g is None:
            return params, init_opt_state(params)
        return params, init_opt_state(
            _GroupLayout(api, params, zero=True).chunks(params))

    return step, init_fn


# --------------------------------------------------------------------------
# manual-sync variant (explicit sums + cross-pod grad compression)
# --------------------------------------------------------------------------

def make_manual_sync_train_step(api, mesh, batch_like, ocfg: AdamWConfig,
                                *, compress_pod: bool | None = None):
    """Returns (step, init_fn).  step(params, opt, batch) -> (params, opt,
    metrics), or with ``compress_pod`` step(params, opt, ef, batch) ->
    (params, opt, metrics, ef), ``ef`` the per-pod error feedback, (P,
    ...) float32 per leaf of the reference's layout
    (``weights.to_jax_layout``), as the reference's.  init_fn(seed, *,
    device=None) -> (params, opt[, ef]).

    With ``api.groups`` each process runs its data-parallel shard's rows
    with the backward seeded 1/tp, then the reference's explicit sums:
    a replicated leaf's gradient over the model group
    (``_sync_model_axis``), every gradient over the data-parallel group
    (the sum the rank axis's autograd gives, which reaches the pod reduce
    as the reference's VMA transpose hands it over), then with
    ``compress_pod`` the int8 reduce over the pod group
    (``compression.compressed_psum``); ``m`` / ``v`` stay whole (the
    reference's ``ospec = {"m": pspec, ...}``) and ``ef`` is its pod's
    entry of its model rank's blocks, (1, ...)."""
    pcfg = api.pcfg
    n_dp = _check_layout(api, mesh)
    has_pod = "pod" in mesh.axis_names
    if compress_pod is None:
        compress_pod = pcfg.grad_compression == "int8" and has_pod
    pods = mesh.size("pod")
    g = api.groups

    def shard_losses(params, batch, dp):
        """Each data shard's own token mean plus its aux, summed."""
        ls, dn, aux = api.train_loss(params, batch, dp=dp)
        return (ls / torch.clamp(dn, min=1.0) + aux).sum()

    def body(params, opt, ef, batch):
        _trainable(params)
        batch = _to_device(_own_rows(batch, g), _device_of(params))
        with _record(FORWARD_RANGE):
            total = shard_losses(params, batch, n_dp)
        with _record(BACKWARD_RANGE):
            grads = _grads(total, params, 1.0 if g is None
                           else 1.0 / g.model_size)
        with _record(OPTIMIZER_RANGE):
            if g is not None:
                lay = _GroupLayout(api, params, zero=False)
                leaves, treedef = tree_flatten(grads)
                grads = tree_unflatten(lay.reduce_dp(lay.sync_model(leaves)),
                                       treedef)
                total = _sum_over(total, g.dp)
            return sync_and_update(params, opt, ef, grads, total)

    def sync_and_update(params, opt, ef, grads, total):
        if compress_pod:
            # every pod's copy of the summed gradient, with its own error,
            # in the reference's layout (its devices' blocks)
            ref = weights.to_jax_layout(grads, api.cfg, pcfg)
            local = 1 if g is not None else pods
            reduced, ef = C.compress_grads(
                tree_map(lambda t: t.expand(local, *t.shape), ref), ef,
                api.specs(params), None if g is None else g.pod)
            grads = weights.from_jax_params(reduced, api.cfg, pcfg,
                                            device=_device_of(params))
        grads = tree_map(lambda t: t / n_dp, grads)
        gnorm = (None if g is None else global_norm(
            grads, _GroupLayout(api, params, zero=False).owned()))
        params, opt, gnorm = adamw_update(
            params, grads, opt, ocfg, gnorm=gnorm,
            decay_mask=_decay_mask(api, params))
        metrics = {"loss": total.detach() / n_dp, "grad_norm": gnorm}
        return params, opt, metrics, ef

    if compress_pod:
        def step(params, opt, ef, batch):
            return body(params, opt, ef, batch)
    else:
        def step(params, opt, batch):
            return body(params, opt, None, batch)[:3]

    def init_fn(seed: int, *, device=None):
        params = api.init(seed, device=resolve_device(device))
        opt = init_opt_state(params)
        if compress_pod:
            return params, opt, C.init_ef_state(weights.to_jax_layout(
                params, api.cfg, pcfg), 1 if g is not None else pods)
        return params, opt

    return step, init_fn
