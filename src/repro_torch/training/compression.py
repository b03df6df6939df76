"""int8 gradient compression with error feedback for the cross-pod reduce,
as ``repro.training.compression``.

The reference runs one program per pod and psums over the ``pod`` mesh
axis; here the pods lie on a leading pod axis P of one tensor, each
entry that pod's own value, and the psum is a sum over it.  Each pod
quantizes its value plus its carried float32 error to int8 with one
float32 scale (``_quantize``: ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 payload is the reference's bit for bit),
keeps what the quantization lost as its new error, and the reduce sums
the dequantized payloads.  Used by the manual-sync train step when
``ParallelConfig.grad_compression == "int8"``.
"""
from __future__ import annotations

import torch
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


def compressed_psum(x: torch.Tensor, error: torch.Tensor, keep=()):
    """psum over the pod axis of x (P, ...) with int8 quantization and
    error feedback.  ``error`` (P, ...) float32 is each pod's residual
    carried across steps; ``keep`` as ``_quantize``'s, dims of x[p].
    Returns (the reduced float32 value, the same on every pod, shape
    x.shape[1:]; the new error (P, ...)).  Each pod's payload is the int8
    ``_quantize`` gives; the sum of the dequantized payloads models the
    receive side's dequantize-accumulate."""
    if x.shape != error.shape:
        raise ValueError(f"x {tuple(x.shape)} and error "
                         f"{tuple(error.shape)} differ")
    xf = x.float() + error
    dqs = []
    for p in range(x.shape[0]):
        q, scale = _quantize(xf[p], keep)
        dqs.append(q.float() * scale)
    dq = torch.stack(dqs)
    reduced = dq[0]
    for p in range(1, dq.shape[0]):
        reduced = reduced + dq[p]
    return reduced, xf - dq


def compress_grads(grads, ef_state, specs=None):
    """Tree-wise ``compressed_psum``: grads and ef_state trees of (P, ...)
    leaves -> (reduced grads in each leaf's dtype, without the pod axis;
    the new ef_state).  ``specs``: the leaves' PartitionSpecs as tuples
    (the reference's layout, ``weights.reference_specs``): each sharded
    dim's blocks get their own scale, as each device quantizes its own
    block in the reference."""
    g_l, treedef = tree_flatten(grads)
    e_l = tree_flatten(ef_state)[0]
    s_l = ([()] * len(g_l) if specs is None else
           tree_flatten(specs, is_leaf=lambda x: isinstance(x, tuple))[0])
    out_g, out_e = [], []
    for g, e, spec in zip(g_l, e_l, s_l):
        keep = tuple(i for i, a in enumerate(spec) if a is not None)
        r, ne = compressed_psum(g, e, keep)
        out_g.append(r.to(g.dtype))
        out_e.append(ne)
    return tree_unflatten(out_g, treedef), tree_unflatten(out_e, treedef)


def init_ef_state(grads_like, pods: int):
    """Float32 zeros (P, ...) for every leaf of ``grads_like``."""
    return tree_map(lambda g: torch.zeros((pods,) + tuple(g.shape),
                                          dtype=torch.float32,
                                          device=g.device), grads_like)
