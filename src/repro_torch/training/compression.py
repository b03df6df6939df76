"""int8 gradient compression with error feedback for the cross-pod reduce,
as ``repro.training.compression``.

The reference runs one program per pod and psums over the ``pod`` mesh
axis; here the pods lie on a leading pod axis P of one tensor, each
entry that pod's own value, and the psum is a sum over it.  Each pod
quantizes its value plus its carried float32 error to int8 with one
float32 scale (``_quantize``: ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 payload is the reference's bit for bit),
keeps what the quantization lost as its new error, and the reduce sums
the dequantized payloads.  Over a ``torch.distributed`` pod group each
process holds its own pod's entry and the payloads cross the wire as
int8 with their float32 scales.  Used by the manual-sync train step when
``ParallelConfig.grad_compression == "int8"``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


def _quantize(x: torch.Tensor, keep=()):
    """x -> (int8 payload, float32 scale): scale = max|x| / 127 (at least
    1e-12 / 127), payload = round-half-even(x / scale) clipped to
    [-127, 127].  ``keep``: dims of x that hold one device's block each
    in the reference (a sharded leaf's per-shard axis), each block with
    its own scale; none: one scale."""
    xf = x.float()
    red = [d for d in range(xf.dim()) if d not in keep]
    amax = xf.abs().amax(dim=red, keepdim=True) if keep else xf.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _pod_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every pod's ``t`` over the pod group, pod-major: (P, *t.shape)."""
    size = dist.get_world_size(group)
    out = t.new_empty((size, *t.shape))
    dist.all_gather_into_tensor(out, t.reshape(1, *t.shape).contiguous(),
                                group=group)
    return out


def compressed_psum(x: torch.Tensor, error: torch.Tensor, keep=(),
                    group=None):
    """psum over the pod axis of x (P, ...) with int8 quantization and
    error feedback.  ``error`` (P, ...) float32 is each pod's residual
    carried across steps; ``keep`` as ``_quantize``'s, dims of x[p].
    Returns (the reduced float32 value, the same on every pod, shape
    x.shape[1:]; the new error (P, ...)).  Each pod's payload is the int8
    ``_quantize`` gives; the sum of the dequantized payloads models the
    receive side's dequantize-accumulate.

    ``group``: the pod group of ``torch.distributed`` processes, each
    holding its own pod's x and error (P = 1 here): each quantizes its
    value plus its error, the int8 payloads and their float32 scales are
    what crosses the wire (gathered over the group), and every pod
    dequantizes them and sums in float32, pod 0 first, the rank axis's
    order, so the result is the rank axis's bit for bit."""
    if x.shape != error.shape:
        raise ValueError(f"x {tuple(x.shape)} and error "
                         f"{tuple(error.shape)} differ")
    xf = x.float() + error
    if group is None:
        qs = [_quantize(xf[p], keep) for p in range(x.shape[0])]
    else:
        if x.shape[0] != 1:
            raise ValueError(f"a process holds one pod, x has {x.shape[0]}")
        q, scale = _quantize(xf[0], keep)
        qs = list(zip(_pod_gather(q, group), _pod_gather(scale, group)))
    dqs = [q.float() * scale for q, scale in qs]
    reduced = dqs[0]
    for dq in dqs[1:]:
        reduced = reduced + dq
    if group is None:
        return reduced, xf - torch.stack(dqs)
    mine = dist.get_rank(group)
    return reduced, xf - dqs[mine][None]


def compress_grads(grads, ef_state, specs=None, group=None):
    """Tree-wise ``compressed_psum``: grads and ef_state trees of (P, ...)
    leaves -> (reduced grads in each leaf's dtype, without the pod axis;
    the new ef_state).  ``specs``: the leaves' PartitionSpecs as tuples
    (the reference's layout, ``weights.reference_specs``): each sharded
    dim's blocks get their own scale, as each device quantizes its own
    block in the reference.  ``group``: the pod group, each process
    holding its pod's leaves (P = 1) of its model rank's block."""
    g_l, treedef = tree_flatten(grads)
    e_l = tree_flatten(ef_state)[0]
    s_l = ([()] * len(g_l) if specs is None else
           tree_flatten(specs, is_leaf=lambda x: isinstance(x, tuple))[0])
    out_g, out_e = [], []
    for g, e, spec in zip(g_l, e_l, s_l):
        keep = tuple(i for i, a in enumerate(spec) if a is not None)
        r, ne = compressed_psum(g, e, keep, group)
        out_g.append(r.to(g.dtype))
        out_e.append(ne)
    return tree_unflatten(out_g, treedef), tree_unflatten(out_e, treedef)


def init_ef_state(grads_like, pods: int):
    """Float32 zeros (P, ...) for every leaf of ``grads_like``."""
    return tree_map(lambda g: torch.zeros((pods,) + tuple(g.shape),
                                          dtype=torch.float32,
                                          device=g.device), grads_like)
