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
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch import weights
from repro_torch.device import resolve_device
from repro_torch.training import compression as C
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state, opt_state_specs)

FORWARD_RANGE = "repro_torch.train.forward"     # the loss
BACKWARD_RANGE = "repro_torch.train.backward"   # autograd, remat included
OPTIMIZER_RANGE = "repro_torch.train.optimizer"  # the pod reduce, AdamW
RANGES = {"train_forward": FORWARD_RANGE, "train_backward": BACKWARD_RANGE,
          "train_optimizer": OPTIMIZER_RANGE}
_record = torch.profiler.record_function


def _check_layout(api, mesh) -> int:
    """The data size D, after checking the api against the mesh."""
    pcfg = api.pcfg
    tp, dp = mesh.size(pcfg.tp_axis), mesh.dp_size(pcfg.dp_axes)
    if api.tp != tp or api.ep != dp:
        raise ValueError(f"the model is built for tp={api.tp}, ep={api.ep}; "
                         f"the mesh {mesh.shape} over dp_axes "
                         f"{pcfg.dp_axes} gives tp={tp}, data size {dp}")
    if (api.cfg.family == "moe" and api.cfg.moe_partition == "ep2d"
            and mesh.size("pod") > 1):
        raise NotImplementedError(
            "ep2d experts split over the data axis alone; a pod axis over "
            "them is not ported")
    return dp


def _to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _device_of(params) -> torch.device:
    return tree_flatten(params)[0][0].device


def _decay_mask(api, params):
    """The reference's weight-decay rule, ndim >= 2 in its layout."""
    return tree_map(lambda n: n >= 2,
                    weights.reference_ndims(params, api.cfg, api.pcfg))


def _grads(loss, params):
    """d loss / d every leaf of ``params`` (zeros for an unused leaf), in
    the structure of ``params``."""
    leaves, treedef = tree_flatten(params)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
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


def make_loss_fn(api, mesh):
    """The global-mean loss over the data shards: params, batch ->
    float32 scalar."""
    _check_layout(api, mesh)

    def loss_fn(params, batch):
        ls, dn, aux = api.train_loss(params, batch)
        return ls.sum() / torch.clamp(dn.sum(), min=1.0) + aux.mean()
    return loss_fn


def make_train_step(api, mesh, batch_like, ocfg: AdamWConfig,
                    dp_size: int):
    """Returns (step, init_fn).  step(params, opt, batch) -> (params, opt,
    metrics); ``batch`` numpy arrays or tensors {"tokens", "labels", ...}
    of the global batch.  init_fn(seed, *, device=None) -> (params,
    opt)."""
    if _check_layout(api, mesh) != dp_size:
        raise ValueError(f"dp_size={dp_size} differs from the mesh's data "
                         f"size {mesh.dp_size(api.pcfg.dp_axes)}")
    loss_fn = make_loss_fn(api, mesh)

    def step(params, opt, batch):
        _trainable(params)
        with _record(FORWARD_RANGE):
            loss = loss_fn(params, _to_device(batch, _device_of(params)))
        with _record(BACKWARD_RANGE):
            grads = _grads(loss, params)
        with _record(OPTIMIZER_RANGE):
            params, opt, gnorm = adamw_update(
                params, grads, opt, ocfg, decay_mask=_decay_mask(api, params))
        return params, opt, {"loss": loss.detach(), "grad_norm": gnorm}

    def init_fn(seed: int, *, device=None):
        params = api.init(seed, device=resolve_device(device))
        return params, init_opt_state(params)

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
    (``weights.to_jax_layout``), as the reference's.  init_fn(seed, *, device=None) -> (params,
    opt[, ef])."""
    pcfg = api.pcfg
    n_dp = _check_layout(api, mesh)
    has_pod = "pod" in mesh.axis_names
    if compress_pod is None:
        compress_pod = pcfg.grad_compression == "int8" and has_pod
    pods = mesh.size("pod")

    def shard_losses(params, batch, dp):
        """Each data shard's own token mean plus its aux, summed."""
        ls, dn, aux = api.train_loss(params, batch, dp=dp)
        return (ls / torch.clamp(dn, min=1.0) + aux).sum()

    def body(params, opt, ef, batch):
        _trainable(params)
        batch = _to_device(batch, _device_of(params))
        with _record(FORWARD_RANGE):
            total = shard_losses(params, batch, n_dp)
        with _record(BACKWARD_RANGE):
            grads = _grads(total, params)
        with _record(OPTIMIZER_RANGE):
            return sync_and_update(params, opt, ef, grads, total)

    def sync_and_update(params, opt, ef, grads, total):
        if compress_pod:
            # every pod's copy of the summed gradient, with its own error,
            # in the reference's layout (its devices' blocks)
            ref = weights.to_jax_layout(grads, api.cfg, pcfg)
            reduced, ef = C.compress_grads(
                tree_map(lambda g: g.expand(pods, *g.shape), ref), ef,
                api.specs(params))
            grads = weights.from_jax_params(reduced, api.cfg, pcfg,
                                            device=_device_of(params))
        grads = tree_map(lambda g: g / n_dp, grads)
        params, opt, gnorm = adamw_update(
            params, grads, opt, ocfg, decay_mask=_decay_mask(api, params))
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
                params, api.cfg, pcfg), pods)
        return params, opt

    return step, init_fn
