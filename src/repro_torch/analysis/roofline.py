"""The three-term roofline of one NVIDIA H100 SXM5, as
``repro.analysis.roofline``: its constants, ``Roofline``, ``model_flops``
and ``analyze``.  The reference reads a compiled XLA module's counts
(``analysis/hlo.py``); ``analyze`` here prices the counts of a call run
on meta tensors (``analysis/op_costs.py``, the dry run
``launch/dryrun.py``).

The constants are NVIDIA's H100 SXM5 data sheet's, dense rates without
sparsity, at the card's full 700 W power limit:

* ``PEAK_FLOPS`` — 989 TFLOP/s of bf16 on the tensor cores;
* ``HBM_BW``     — 3.35 TB/s of HBM3;
* ``NVLINK_BW``  — 900 GB/s of NVLink per GPU: 18 fourth-generation
  links of 25 GB/s in each direction, both directions summed.

``ICI_EFF`` keeps the reference's name for the interconnect rate the
§9 sim prices collectives with (``sim.overlap_sim.HW.ici``): the
per-GPU rate a ring collective drives.  A ring step sends one chunk to
the next rank while it receives one from the previous rank, and the
sim's ring formulas count the bytes each GPU sends, so the rate is one
direction of the GPU's NVLink: half of ``NVLINK_BW``, 450 GB/s.

On one card the port's tp ranks sit on a rank axis of the card's own
memory (``distributed/context.py``): a collective there is a copy in
HBM and never crosses NVLink.  That is why ``analysis/calibration.py``
fits ``ici`` from measured forwards rather than taking this constant.

The three roofline terms of a device's work (the sim prices each op by
the larger of the first two, each collective by the third):

    compute_s    = flops / PEAK_FLOPS
    memory_s     = bytes / HBM_BW
    collective_s = wire_bytes / ICI_EFF
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.analysis.op_costs import ModuleCosts
from repro_torch.configs.base import ModelConfig

PEAK_FLOPS = 989e12       # bf16, dense, tensor cores / GPU
HBM_BW = 3.35e12          # bytes/s / GPU
NVLINK_BW = 900e9         # bytes/s / GPU, both directions of 18 links
ICI_EFF = NVLINK_BW / 2   # one direction: what a ring step sends at


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_device: float
    useful_ratio: float
    loop_multiplier: float
    by_kind: Dict[str, float]

    def to_dict(self):
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, n_tokens: int, *, train: bool,
                decode_context: int = 0, seq_len: int = 0) -> float:
    """6*N*D (train) / 2*N*D (inference) active-param flops + attention
    (the reference's formula: causal attention counted at half)."""
    n = cfg.active_param_count()
    mult = 6.0 if train else 2.0
    total = mult * n * n_tokens
    # attention score/value flops (not in 6ND): 2*2*L*H*dh*S_kv per token
    if cfg.num_heads:
        kv = decode_context if decode_context else (seq_len or n_tokens)
        att = (2 * 2 * cfg.num_layers * cfg.num_heads * cfg.head_dim
               * n_tokens * kv)
        if cfg.sliding_window and cfg.local_global_period:
            # most layers see only the window
            loc = (cfg.local_global_period - 1) / cfg.local_global_period
            att = att * (1 - loc) + att * loc * min(
                1.0, cfg.sliding_window / max(kv, 1))
        total += (3.0 if train else 1.0) * att / 2  # causal halves it
    return total


def analyze(costs: ModuleCosts, cfg: ModelConfig, *, n_devices: int,
            n_tokens_global: int, train: bool, decode_context: int = 0,
            seq_len: int = 0) -> Roofline:
    """The roofline of one call's per-device ``costs`` priced with the
    H100's constants.  ``loop_multiplier`` is 1.0 by construction: the
    port walks its layers in Python, so no collective sits in a loop
    body that the count visits once (the reference divides the dynamic
    count by the static one of a scanned module)."""
    flops = costs.flops
    byts = costs.bytes_accessed
    wire = costs.wire_bytes
    loop_mult = (costs.num_collectives_dynamic
                 / max(costs.num_collectives_static, 1))
    mf = model_flops(cfg, n_tokens_global, train=train,
                     decode_context=decode_context,
                     seq_len=seq_len) / n_devices
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = wire / ICI_EFF
    dom = max([("compute", compute_s), ("memory", memory_s),
               ("collective", collective_s)], key=lambda kv: kv[1])[0]
    return Roofline(
        flops_per_device=flops, bytes_per_device=byts,
        wire_bytes_per_device=wire, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dom,
        model_flops_per_device=mf,
        useful_ratio=mf / flops if flops else 0.0,
        loop_multiplier=loop_mult if costs.num_collectives_static else 1.0,
        by_kind=dict(costs.by_kind))
