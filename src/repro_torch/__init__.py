"""PyTorch/CUDA port of the TokenWeave reproduction in ``src/repro``.

The JAX package is the reference; this package mirrors its module layout
(``configs``, ``core``, ``layers``, ``kernels``, ``models``, ``runtime``,
``obs``) so each ported function sits where its counterpart does.  It
imports ``torch``, ``numpy`` and the standard library only — never ``jax``
and never ``repro`` (whose import loads jax) — so it keeps its own copies
of the pure-Python modules it needs.

Entry points run on CUDA unless the caller passes ``device="cpu"``.  The
hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc``
at first use into ``build/kernels/`` at the repository root
(``kernels/build.py``).  On CPU tensors every kernel wrapper runs its plain
PyTorch version instead.
"""
