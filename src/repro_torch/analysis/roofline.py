"""Roofline constants of one NVIDIA H100 SXM5, as
``repro.analysis.roofline``'s (its HLO-artifact analyzer is XLA-specific
and stays unported: ROADMAP.md A2).

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

PEAK_FLOPS = 989e12       # bf16, dense, tensor cores / GPU
HBM_BW = 3.35e12          # bytes/s / GPU
NVLINK_BW = 900e9         # bytes/s / GPU, both directions of 18 links
ICI_EFF = NVLINK_BW / 2   # one direction: what a ring step sends at

