#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--trace-dir DIR]

Phases, each printing one JSON line:

1. build    compile every CUDA kernel from src/repro_torch/csrc/ (nvcc,
            sm_90a, one process per source, in parallel);
2. kernels  hold each kernel against its plain PyTorch version on the card
            at the main path's shapes and at ragged ones, and time the
            kernel, the plain version and, where one exists, the single
            PyTorch call computing the same function (timed only); K1 also
            gives bit-identical outputs on 1, 2, 4 and 8 CTAs and through
            both vector routes (register, and bulk copies where a row takes
            the whole CTA), is timed on each route that takes the rows at
            every served width (d 512 at T 3000 and 12000, 2048, 3584,
            4096, 6144, 8192) and at Llama's decode and verify sizes (T 8
            and 32), beside the composition it replaces
            (sum over ranks, K2, copy to every rank), and beside two copy
            kernels on the same 8 CTAs moving the same bytes, one through
            16-byte loads and stores (``budget_bound_ms``) and one through
            bulk copies (``budget_bound_bulk_ms``), probes built here and
            used nowhere in the port; K3 adds the main
            path's first prefill split behind an empty cache row
            (``engine``, with the key tiles the live-tile table lets it
            visit), its second split at tp=8 (``engine_tp``: the ranks
            folded into the batch, one KV head each) and a sweep over G
            and head dim;
2b. k1_peer K1's cross-rank form (csrc/ar_rmsnorm_peer.cu), N ranks on
            the one card: (a) in one process, N = 2, 4, 8 ranks as N
            launches on N streams, each with its own peer workspace, at
            (T 2048, d 8192), (T 12000, d 512), (T 1000, d 8190: the
            scalar body) and (T 8, d 8192: fewer rows than CTAs) bf16 and
            (T 2048, d 4096) float32, and T/N of 1, N, 2N and 8N rows at
            d 8192 (the one-wait path where T/N is below the CTAs, three
            phases elsewhere): every rank's output and new residual
            bit-equal to the one-card K1's on the same inputs, on 1, 2, 4
            and 8 CTAs, within K1_TOL of the plain version, timed with
            CUDA events beside the one-card K1, the streams joined after
            every call (``ms``) and running free (``ms_free``); then the
            N ranks' calls at T 8 and 1024 captured into N CUDA graphs,
            one per rank's stream, replayed 20 times on fresh inputs, each
            replay bit-equal to an eager call and to the one-card K1, and
            timed; (b) N = 2 and 4 processes, each
            calling ``comm_norm`` in comm mode ``ring`` under
            ``CommCtx(process_group)`` over gloo groups (which carry only
            the CUDA IPC handle exchange): bit-equal to the one-card K1 on
            the whole inputs, one launch a call, times labelled
            time-sliced (the processes share the card by turns);
3. online   the serving front end and observability at full width
            (Llama-3.3-70B cut to 4 layers, bf16, packed + paged):
            8 requests (prompts of 300-1800 tokens, 32 new) served with
            a WallClockProfiler and a TraceRecorder at tp=1, then plain
            and profiled in turns (tokens, steps equal; the profiler's
            cost per step), ``fit_calibration`` on the measured forwards
            (its JSON and the Chrome traces go to --trace-dir/online/;
            the trace validates, its weave counts equal the engine's);
            the same requests through ``OnlineServer`` on the calibrated
            clock with Poisson arrivals, a cancel and an expiring
            deadline (TTFT, TPOT, e2e percentiles and goodput; pool
            drained; one terminal event per request; K3 held on the
            inputs it gave K3, ``main_path_k3``), and on a small
            float32 model with the online tokens gated equal to the
            offline ones; at tp=8 ``ring`` 4 requests profiled and plain
            (tokens equal), a fit, and each woven prefill's fenced wall
            not below the same call's CUDA-event time;
4. engine   serve 4 greedy requests through the two-dispatch Engine with
            Llama-3.3-70B's widths cut to 4 layers (bf16, random weights
            from the seed) at tp=1, and show from the launch counters that
            the main path ran through the kernels; then trace one prefill
            and one decode step of the model with torch.profiler and split
            their device time by kind of kernel; then hold K3 against its
            plain version on the inputs the run gave it, at each shape
            (``main_path_k3``);
5. engine_tp the same requests at tp=8 (the eight ranks on one card's rank
            axis) in comm mode "ring": K1 launches equal splits·(1+2L) per
            forward, so no forward fell back; one traced prefill call
            gives K1's device time and the part of it that overlapped
            other kernels (the weave's comm stream), and K3 is held on
            its inputs again; every traced call's Chrome trace is written
            to --trace-dir (build/traces/);
6. engine_packed  the same requests and a 5th that shares request 0's
            first 1024 prompt tokens (added once request 0's prefill is
            done: 64 blocks hit the prefix cache) through packed hybrid
            batching over the paged pool, at tp=1 (K2) and tp=8 (ring,
            K1): one ``packed_step`` line per step (segments, split, ms);
            K2/K1 launches equal splits·(1+2L) and K3's splits·L (every
            split's attention is one K3 call over its segments); K3 is
            held on the inputs of every shape it got; at tp=1 one mixed
            step with two splits is run again under the profiler, with
            the device time of the segments' gather, the scatter into the
            pool and the query/output layout apart (``breakdown``,
            engine_packed); each packed run's peak device memory (from
            the run's start: weights, pool and the run's activations)
            stays within 1.5 GB of the two-dispatch run's at its tp
            (``peak_memory``);
7. engine_paged  the two-dispatch engine over the paged pool at tp=1
            (paged prefill: gather, K3, insert; paged decode);
8. engine_moe  the MoE family at full width, random bf16 weights from
            the seed: Mixtral-8x22B (``ffn``: every rank a d_ff slice of
            all 8 experts; 4 of 56 layers) serves the engine phases' 4
            requests through the two-dispatch engine at tp=1 ``fused`` and
            tp=8 ``ring`` and, with the 5th sharing request, packed over
            the pool at tp=8 ``ring`` (``engine_moe_packed``); OLMoE-1B-7B
            (``expert``: 8 of its 64 experts a rank; all 16 layers) packed
            at tp=8 ``ring`` (``engine_moe_olmoe``).  Gated as the Llama
            runs (launch formulas, pools drained, K3 held at every shape
            it got, ``main_path_k3``); reported: step times, peaks, per
            forward the share of assignments capacity dropped and the
            assignments per expert (``moe_forwards``), and one traced
            prefill or mixed step whose device time the MoE layer's named
            ranges split into routing, dispatch, expert products and
            combine (``breakdown``);
9. moe_sync one ``moe_forward`` at Mixtral width over 2048 tokens at tp=1
            and tp=8 under ``torch.cuda.set_sync_debug_mode("error")``:
            the layer never waits for the card;
10. identity a small float32 model served on the card (kernels) and on the
            CPU (plain versions) must give identical greedy tokens, at
            tp=1 and at tp=2 in ring mode with the weave (and its streams)
            firing, through the two-dispatch engine over slots and
            through packed batching over the paged pool with a request
            that hits the prefix cache; so must its two MoE twins
            (``ffn`` and ``expert``), whose prefill also keeps every
            layer's expert choices equal on both devices;
11. cluster the engine phases' 4 requests at Llama-3.3-70B width (4
            layers, bf16) through a disaggregated pair, one prefill and
            one decode replica sharing the params, every envelope and KV
            payload through the loopback wire, at tp=1 ``fused`` and tp=8
            ``ring``: one ``cluster_handoff`` line per handoff (tokens,
            payload and frame bytes, extract / encode / decode / implant
            ms, each fenced), launches equal their formula, every request
            migrated once, both pools quiescent, one payload bit-identical
            after extract -> frame -> decode -> implant -> extract, tokens
            against a single paged engine reported; then the small
            float32 model on the card, every engine from
            ``build_engine_from_spec``: a two-replica cluster under each
            router, the disaggregated loopback cluster and a kill with
            its requeue, a spawned ``python -m
            repro_torch.runtime.transport`` replica hard-killed mid-run
            beside a local one, and one SSE stream from a spawned ``python
            -m repro_torch.runtime.http_api``, each token-identical to the
            offline engine (a failed server fails the script);
12. engine_ssm  Falcon-Mamba-7B at full width and depth (64 layers, bf16,
            random weights from the seed) serves the engine phases' 4
            requests through the two-dispatch engine over legacy slots at
            tp=1 ``fused`` and tp=8 ``ring``: K2/K1 launches equal
            splits·(1+L) and K3's none; request 0's first token equals a
            direct prefill's argmax; one traced prefill and one traced
            decode call split by the SSM layer's ranges (in/out
            projections, conv, x_proj's rank sum, scan);
13. hybrid  Zamba2-7B at full width and depth (81 Mamba-2 layers, 13
            shared-attention calls at head dim 224, bf16) through
            ``ModelApi``: 4 rows, two 512-token prefill chunks through
            the cache (the second reads the first's shared KV and resumes
            its SSD state), 16 greedy decode steps, at tp=1 and tp=8; K3
            launches equal 13 per split per chunk, K2/K1 splits·(1+81+13)
            per forward; K3 held on the run's inputs; one traced chunk
            and decode step; then small float32 ssm and hybrid models give
            equal greedy tokens on the card and the CPU at tp=1 and tp=2
            ``ring`` (``identity_ssm``, ``identity_hybrid``);
14. vlm     Qwen2-VL-7B at full width and depth (28 layers, bf16) through
            ``ModelApi``: 4 rows of 256 patch embeddings (a 448x448
            image) and 768 text tokens with M-RoPE ids, one 4096-token
            prefill (the weave splits the sequence; K3 at G 7) and 32
            greedy decode steps, at tp=1 and tp=8; launches equal
            splits·28 (K3) and ``norm_launches``; K3 held on the run's
            inputs; one traced prefill and decode step;
15. encdec  Whisper-base at full width and depth (6 + 6 layers, bf16):
            16 rows of 1500 stub frames through the encoder (its batch
            split; K3 bidirectional), a 4-token decoder prompt, the self
            and cross caches written, 64 greedy decode steps, at tp=1
            and tp=8 (the vocabulary padded to 51,872); launches equal
            ``encdec_launches``; K3 held on the run's inputs; the
            encoder timed alone; then small float32 vlm and encdec twins
            give equal greedy tokens on the card and the CPU at tp=1 and
            tp=2 ``ring`` (``identity_vlm``, ``identity_encdec``);
16. engine_moe_qwen3  Qwen3-MoE-235B-A22B at full width (4 of 94
            layers, bf16, ``ep2d`` at data size 1: all 128 experts on the
            one data shard, expert d_ff over the ranks) serves the engine
            phases' 4 requests through the two-dispatch engine at tp=1
            ``fused`` and tp=8 ``ring``, gated as the other engine phases;
17. ep2d    the same model by direct calls at D = 2 data shards x R = 4
            ranks (experts over D, its all-to-alls index ops on the card,
            K1 once a slot per data shard) and at D = 1 x R = 4: 4 rows of
            1024 tokens (the batch over D), 16 decode steps; launches equal
            their formulas, K3 held on the run's inputs, drop shares, a
            traced prefill and decode with the MoE ranges (dispatch and
            combine device ms);
18. cp_decode  Gemma3-1B at full width and depth at the ``long_500k``
            shape (one row, 524,288 positions, its caches filled from the
            seed): 16 bf16 decode steps under ``seq_shard_kv`` at D = 4
            beside D = 1 (greedy tokens equal; each step's logits against
            D = 1 on the same cache reported) and 4 float32 steps (logits
            within 1e-3); then small float32 twins, ep2d at D = 2 x R = 2
            and the reduced Gemma3-1B at D = 4, give equal greedy tokens on
            the card and the CPU (``identity_ep2d``, ``identity_cp``);
19. pg_engine  the process-group backend: ``init_groups`` over NCCL at
            world size 1 (a (data 1, model 1) mesh, a file store), the
            engine phase's model at tp=1 ``fused`` built on the rank axis
            and over the groups (one rank's params, ``take_rank``): one
            prefill's logits bit-equal, the 4 requests through the
            two-dispatch engine over slots and packed over the paged pool
            give equal tokens on both, launches equal their formulas (K2,
            K3), the pool drains, K3 held on the group runs' inputs
            (``pg_engine`` with both engines' step medians); then psum,
            psum_scatter and all_gather at (2048, 8192) bf16 over NCCL
            with each wire dtype beside the rank axis's at tp=1 and tp=8
            (``pg_collectives``, with the card's name and power limit);
            the process group is destroyed at the end;
19b. pg_ring  ``launch.serve``'s ``main`` with ``--comm-mode ring
            --backend gloo`` at world size 2, both ranks on the card, each
            with a spy around K1's cross-rank wrapper: Llama-3.3-70B at 4
            layers (bf16) and its reduced float32 twin; K1-peer launches
            equal the engine's slots, splits·(1+2L), no other add+norm
            kernel runs; at every (T, CTAs) the forwards gave it (prefill
            splits, decode steps of T/2 rows below the 8 CTAs) the served
            inputs, stacked, through the one-card K1: each rank's outputs
            bit-equal, within K1_TOL of the plain version; tokens beside
            the rank axis's ``ring`` at tp=2 on the card (bf16 reported,
            float32 gated equal), and K1's inputs and outputs beside the
            rank axis's call by call (bits, by digest): outputs equal
            wherever inputs are (gated), float32 the same calls at the
            same shapes (gated); the first call whose inputs part, and a
            layer's products at its rows batched over the ranks and one
            rank alone (reported);
19c. pg_families  the other families the same way, in two processes
            of its own (``--pg-families-rank``) that run every model in
            turn: Mixtral-8x22B (``ffn``, 4 of 56 layers), OLMoE-1B-7B
            (``expert``, 16 layers) and Falcon-Mamba-7B (8 of 64 layers)
            through ``launch.serve`` (4 requests of 1024/640/384/128
            tokens, 8 new), Zamba2-7B (12 of 81 layers: two shared-block
            groups; 2 x 512 tokens), Whisper-base (all 6 + 6 layers; 4 x
            1500 frames, a 4-token prompt) and Qwen2-VL-7B (4 of 28
            layers; 2 x (256 patches + 256 text)) by direct ``ModelApi``
            calls with 8 greedy decode steps, each at full width (bf16)
            and as its reduced float32 twin; K1's peer workspace sized by
            ``peer.direct_rows`` for direct calls; gates: the ranks'
            tokens equal, K1-peer launches equal the family's formula
            (``PGF_FORMULAS``: splits·(1+2L) MoE and vlm, splits·(1+L)
            ssm, splits·(1+L+n_inv) hybrid, the encoder's
            enc_splits·(1+2L_enc) + splits·(1+3L) encdec), no other
            add+norm kernel, the peer kernel bit-equal to the one-card K1
            at every served (T, CTAs) (the body it took, vector or
            scalar, reported), K3's launches equal the family's formula
            (``PGF_K3_FORMULAS``: prefill splits·L MoE and vlm, none ssm,
            splits·n_inv hybrid, enc_splits·L_enc + splits·L encdec) and
            K3 held against its plain version on each rank's inputs at
            every shape it got (causal, Whisper's bidirectional encoder,
            G 7, Zamba2's head dim 224), each twin's tokens and K1 calls
            equal to the rank axis's ``ring`` at tp=2; per-rank prefill
            and decode wall ms (time-sliced); then K1's cross-rank form at
            N 2 timed
            at each full-width model's largest and smallest served rows
            (``k1_peer_families``, a process of its own); Qwen3-MoE-235B
            (``ep2d`` at data size 1, 4 of 94 layers) is served the same
            way;
19d. pg_data  the data group, four processes of its own
            (``--pg-data-rank``) on a (data 2, model 2) mesh over gloo in
            ``ring``, each model group with its own K1 peer workspace:
            Qwen3-MoE-235B-A22B at full width (4 of 94 layers, bf16) with
            the batch over the data group (a prefill of 4 x 1024 tokens,
            each process its data shard's 2 rows, ``ep2d``'s three
            all-to-alls over the data group, then 8 greedy decode steps),
            then float32 twins: the small ep2d model and the reduced
            Llama with the batch over data (4 x 48 tokens, 4 steps), and
            the reduced Zamba2's context-parallel decode over the data
            group (2 rows, each data rank 128 of a 256-slot seeded shared
            cache, 8 steps); gates: each shard's model ranks emit equal
            tokens, K1-peer launches equal splits·(1+2L) (the hybrid's
            splits·(1+L+n_inv)) per forward and no other add+norm kernel,
            the peer kernel bit-equal to the one-card K1 at every (T,
            CTAs) each model group served, K3's launches and K3 on every
            shape the ranks kept, each twin's tokens equal to the rank
            axis's at D = 2 x R = 2 and its first logits within 1e-5;
            reported: bf16 tokens against the rank axis, all-to-all
            calls, bytes and ms a call, per-rank prefill and decode ms
            (time-sliced) and the phase's seconds;
19e. pg_spec  speculative decoding the same way, two processes of its
            own (``--pg-spec-rank``) serving through ``launch.serve`` in
            ``ring`` over gloo: Llama-3.3-70B at full width (4 of 80
            layers, bf16) on prompt-lookup prompts (one seeded 64-token
            block repeated to 1800/1200/700/300 tokens), 32 new tokens,
            gamma 3: spec off, the n-gram draft over legacy slots and
            packed over the paged pool, a model draft (the target
            drafting for itself over the same groups with a K1 workspace
            of its own) packed; then the reduced float32 twin of each and
            a seeded stochastic packed run (temperature 0.2, top-p 0.9);
            gates: the ranks agree, verify steps, proposals and accepted
            drafts in every spec run, K1-peer launches equal splits·(1+2L)
            over the target's and the rollout forwards and no other
            add+norm kernel, the peer kernel bit-equal to the one-card K1
            at every served (T, CTAs) (verify windows and rollout splits
            among them), K3's launches (prefill, packed and rollout
            splits) and K3 on every kept shape, a packed run's verify-only
            segments among them, the twins' greedy tokens equal spec
            off's and every twin's tokens and counters the rank axis's
            ``ring`` engine's at tp=2; reported: bf16 tokens against spec
            off, acceptance, tokens per verified step, verify step and
            rollout forward medians (time-sliced);
20. train_kernels  K2's and K3's autograd Functions (the kernel forward,
            the plain version's backward) against autograd through their
            plain versions on the card at the training step's shapes: K3
            at Gemma3-1B's global and local (window 512) layers (B 4, S
            1024, 1 KV head x 4, dh 256, bf16) and in float32 at dh 128,
            G 8; K2 at (4096, 1152) and (2048, 8192) bf16; the output and
            every input gradient within TRAIN_REL_FRO (bf16, relative
            Frobenius) or TRAIN_FP32_TOL of max(1, its largest magnitude)
            (float32); forward+backward ms of both;
21. train_gemma  Gemma3-1B at full width and depth (26 layers, d 1152,
            vocabulary 262,144, tied embeddings, bf16, random weights
            from the seed) trains 6 AdamW steps of ``make_train_step`` at
            tp=1 (``fused``, K2 and K3 inside autograd, every layer under
            remat) on ``SyntheticLM`` batches of 4 x 1024: every loss and
            gradient norm finite, the last loss below the first, K2 and
            K3 launched on every step; step ms (median of steps 2-6, CUDA
            events), tokens/s, peak GB, launches per step;
22. train_resume  ``python -m repro_torch.launch.train`` on the card
            (reduced Qwen1.5-4B): a run that fails at step 6 (exit 42), its
            restart ("resumed from checkpoint step 6") and an
            uninterrupted run, final losses within 1e-3 relative; then
            ``--manual-sync --mesh 2x1x2`` (int8 pod reduce, reduced
            Gemma3-1B) for 4 steps, its loss falling.

The kernels phase holds K2 and K1 at the families' widths too (d 4096,
3584, 1152 and 512, K1 timed at Whisper's 8 x 1500-row split and at one
data shard's 4 x 2048 rows of d 4096, and on a data shard's views of a
two-shard tensor, bit-equal to copies) and K3 at bf16 head dims 224 and
256 (``hybrid_d224``, ``gemma_d256`` timed beside SDPA, ``g2_d224``
ragged and windowed), bidirectional (``whisper_enc``, timed), at G 7
(``qwen2vl``, timed; ``bidir_padded`` ragged with padded keys) and at
Qwen3-MoE's G 16 and 8 (``qwen3``, ``qwen3_tp8``, ``qwen3_ep2d``, timed).

After the engine phases, ``tuned_plan``: the overlap-plan autotuner on
``online_tp8``'s calibration (build/plans/tuned.json; the entries that
differ from analysis/plans/h100_default.json printed), engine_tp's
traffic served over the paged pool at tp=8 ``ring`` under the threshold
policy and from the tuned plan in turns, each forward's plan key and
budget with the CTAs it grants K1 (every K1 grid gated equal to it), K1
held and timed at each CTA count used, K3 on every shape, step medians
of both policies, bf16 tokens reported and the float32 twin's at tp=2
gated equal.  After the identity phases, ``dryrun``: the meta-device dry
run of every ASSIGNED arch x shape (and Llama-3.3-70B and
Mixtral-8x22B) on the 16x16 mesh in parallel processes, a status count
and the two paper models' per-device bytes and dominant roofline terms,
then Llama-3.3-70B at 4 layers and tp=8 built on the card, its
parameters' memory within 1 % of the dry run's count; and ``examples``:
examples/torch/quickstart.py and serve_e2e.py run on the card, exit 0.

Then a ``kernels`` summary line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}`` — printed only when every
phase passed.  Without a CUDA device, or without the repository's src/
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
K2_TOL = 1e-2                      # atol and rtol: one bf16 ulp at |x| < 8
# K1 sums the ranks in the plain version's order, so the reduced row is
# bit-equal; only sum(t^2)'s order and the rsqrt differ, as in K2
K1_TOL = 1e-2
# K3 tolerances scale with each case's output: its rms shrinks as 1/sqrt of
# the keys a query sees (about 0.024 at 4.6K keys), so a fixed atol would
# let a dropped key tile through.  A bf16 ulp is at most 2^-7 of a value.
K3_ATOL_RMS = 2.0 ** -5            # atol: four bf16 ulps of rms(plain)
K3_RTOL = 2.0 ** -7                # one ulp: kernel and plain round apart
K3_REL_FRO = 1e-2                  # ||kernel - plain||_F / ||plain||_F
# A fully masked row is the exact mean of V up to the kernel's own
# rounding to bf16, half an ulp, at most 2^-8 of the value.  Keys past Sk
# joining the average (the source note's trap) would scale it by
# Sk / (Sk rounded up to a tile), 0.47 % at Sk = 5096.
MASKED_RTOL = 2.0 ** -8
MASKED_ATOL = 1e-6
CTA_SWEEP = (1, 2, 4, 8)           # K1's budgets: bit-identical, each timed
IDENTITY_LOGIT_TOL = 1e-4          # float32, TF32 off: summation order only
# a packed run's peak over the two-dispatch run's at the same tp; the
# reference's per-token KV view would add 17 GB per layer
PACKED_PEAK_SLACK_GB = 1.5
# training: the kernels' autograd Functions against autograd through their
# plain versions (bf16 by relative Frobenius error, float32 against the
# tensor's scale), and launch.train's resumed run against an unbroken one
TRAIN_REL_FRO = 2e-2
TRAIN_FP32_TOL = 1e-4
RESUME_RTOL = 1e-3
MANUAL_INT8_FALL_RTOL = 0.1   # int8's fixed-batch loss fall against none's
TRAIN_STEPS = 6


# Two plain copies on a K1-sized grid: what that many SMs can move on this
# card, through ordinary 16-byte loads and stores (copy_probe) and through
# Hopper's bulk copies (bulk_probe: one thread a CTA keeps a ring of
# cp.async.bulk loads into shared memory in flight and writes each chunk
# back with a bulk store).  Built beside the port's kernels; the port never
# calls them.
COPY_PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(1024)
copy_probe(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 7 * stride < n; i += 8 * stride) {  // 8 loads in flight
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < 8; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < n; i += stride) dst[i] = src[i];
}
extern "C" int copy_probe_launch(const void* src, void* dst, long long n16,
                                 int ctas, void* stream) {
  copy_probe<<<ctas, 1024, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (uint4*)dst, n16);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ unsigned su32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// chunk: bytes of a bulk copy; n: chunks in all, chunk c to CTA c % grid
__global__ void __launch_bounds__(32)
bulk_probe(const char* __restrict__ src, char* __restrict__ dst, long long n,
           int chunk, int stages) {
  extern __shared__ __align__(128) unsigned char buf[];
  uint64_t* full = (uint64_t*)(buf + (size_t)stages * chunk);
  if (threadIdx.x != 0) return;
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(su32(full + s))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const long long first = blockIdx.x, step = gridDim.x;
  const long long mine = n > first ? (n - 1 - first) / step + 1 : 0;
  auto load = [&](long long k) {
    const int s = (int)(k % stages);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(su32(full + s)), "r"(chunk) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(su32(buf + (size_t)s * chunk)),
        "l"(src + (first + k * step) * chunk), "r"(chunk),
        "r"(su32(full + s)) : "memory");
  };
  for (long long k = 0; k < mine && k < stages; ++k) load(k);
  for (long long k = 0; k < mine; ++k) {
    const int s = (int)(k % stages);
    unsigned done;
    do {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(su32(full + s)), "r"((unsigned)((k / stages) & 1))
          : "memory");
    } while (!done);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(dst + (first + k * step) * chunk),
                 "r"(su32(buf + (size_t)s * chunk)), "r"(chunk) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (k >= 1) {   // chunk k-1's store has read its stage: refill it
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      if (k - 1 + stages < mine) load(k - 1 + stages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
extern "C" int bulk_probe_launch(const void* src, void* dst, long long n,
                                 int chunk, int stages, int ctas,
                                 void* stream) {
  const size_t smem = (size_t)stages * chunk + 8 * stages;
  cudaError_t e = cudaFuncSetAttribute(
      bulk_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  bulk_probe<<<ctas, 32, smem, (cudaStream_t)stream>>>(
      (const char*)src, (char*)dst, n, chunk, stages);
  return (int)cudaGetLastError();
}
"""
# the bulk probe's copies: 16 KB chunks in a ring of 12 (192 KB a CTA)
BULK_PROBE_CHUNK = 16 * 1024
BULK_PROBE_STAGES = 12


def start_copy_probe_build():
    """Start nvcc on the copy probe (in parallel with the port's build)."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "copy_probe.cu").write_text(COPY_PROBE_SRC)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
           str(out / "libcopy_probe.so"), str(out / "copy_probe.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def load_copy_probe(proc_out):
    import ctypes
    proc, out = proc_out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"copy probe build failed:\n{log}")
    lib = ctypes.CDLL(str(out / "libcopy_probe.so"))
    lib.copy_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.copy_probe_launch.restype = ctypes.c_int
    lib.bulk_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.bulk_probe_launch.restype = ctypes.c_int
    return lib


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of one call of ``fn``: ``iters`` calls are
    captured in a CUDA graph after a warm-up call, and one replay is timed
    with CUDA events, so host-side launch cost does not count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, iters: int = 20) -> float:
    """Mean host time of one call of ``fn``: the time to enqueue its work,
    without the profiler, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, atol, rtol) -> float:
    """Every element within ``atol + rtol * |want|``; returns the max abs
    error."""
    err = max_err(got, want)
    bad = ((got.float() - want.float()).abs()
           > atol + rtol * want.float().abs()).sum().item()
    if bad:
        raise AssertionError(f"{name}: {bad} elements beyond atol={atol} "
                             f"rtol={rtol} (max abs err {err})")
    return err


def rel_fro(got, want) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------

def check_k3(torch, name, q, k, v, qpos, kpos, *, causal, window=0,
             sm_scale=None) -> dict:
    """Hold K3 against its plain version on these inputs (every element
    within atol = K3_ATOL_RMS * rms(plain) + K3_RTOL * |plain|, and the
    relative Frobenius error within K3_REL_FRO), and every query row with
    no visible key against the mean of V over all Sk keys of its KV head.
    Returns the case's fields, with the key tiles the live-tile table lets
    the kernel visit (bfloat16)."""
    from repro_torch.kernels import flash_attention as K3
    b, sq, kvh, g, dh = q.shape
    kw = dict(causal=causal, window=window, sm_scale=sm_scale)
    out = K3.flash_attention(q, k, v, qpos, kpos, **kw)
    torch.cuda.synchronize()
    plain = K3.flash_attention_plain(q, k, v, qpos, kpos, **kw)
    rms = float(plain.float().pow(2).mean().sqrt())
    atol = K3_ATOL_RMS * rms
    err = check_close(name, out, plain, atol, K3_RTOL)
    fro = rel_fro(out, plain)
    if not fro <= K3_REL_FRO:
        raise AssertionError(f"{name}: relative Frobenius error {fro} > "
                             f"{K3_REL_FRO}")
    del plain
    case = {"B": b, "Sq": sq, "Sk": k.shape[1], "KVH": kvh, "G": g,
            "dh": dh, "window": window, "dtype": str(q.dtype)[6:],
            "rms_plain": rms, "max_abs_err": err, "atol": atol,
            "rtol": K3_RTOL, "rel_fro_err": fro, "rel_fro_tol": K3_REL_FRO}
    if q.dtype == torch.bfloat16:
        rows, keys, _ = K3.tiling(dh)
        live = K3.live_tiles(qpos, kpos, causal=causal, window=window,
                             queries_per_cta=rows // g, keys_per_tile=keys)
        case.update(key_tiles_visited=int((live > 0).sum()) * kvh,
                    key_tiles_total=live.numel() * kvh)
    masked = ~K3.attention_mask(qpos, kpos, causal, window).any(-1)
    if bool(masked.any()):
        want = v.float().mean(dim=1)[:, None, :, None].expand(
            b, sq, kvh, g, dh)[masked]
        case.update(
            masked_rows=int(masked.sum()),
            masked_rows_err=check_close(f"{name} fully masked rows",
                                        out[masked], want, MASKED_ATOL,
                                        MASKED_RTOL),
            masked_rows_rel_fro_err=rel_fro(out[masked], want),
            masked_rows_atol=MASKED_ATOL, masked_rows_rtol=MASKED_RTOL)
    return case


# K1's cases (N, T, d), bf16: Llama's d 8192 at a prefill split and at
# decode sizes; every served width at a prefill split of N 8 (Whisper-base's
# 512 at its encoder splits of 3000 and 12000 rows, OLMoE's 2048,
# Zamba2's and Qwen2-VL's 3584, Falcon-Mamba's and Qwen3-MoE's 4096,
# Mixtral's 6144, Llama's 8192); d 8190 (the scalar body); one data
# shard's rows of Qwen3-MoE at D = 2 x R = 4
K1_CASES = ([(n, t, 8192) for n in (2, 4, 8) for t in (8, 2048)]
            + [(8, 32, 8192), (8, 1000, 8190), (8, 2048, 4096),
               (8, 2048, 3584), (8, 1000, 3584), (8, 12000, 512),
               (8, 3000, 512), (8, 2048, 2048), (8, 2048, 6144),
               (4, 1024, 4096), (4, 2048, 4096)])
# the cases timed, on each vector route that takes them: every served width
# at N 8, d 8192 and 4096 at the other N, and Llama's decode (T 8) and
# verify (T 32) sizes
K1_TIMED = {(8, 12000, 512), (8, 3000, 512), (8, 2048, 2048),
            (8, 2048, 3584), (8, 2048, 4096), (8, 2048, 6144),
            (8, 2048, 8192), (4, 2048, 4096), (4, 2048, 8192),
            (2, 2048, 8192), (8, 8, 8192), (8, 32, 8192), (4, 8, 8192)}


def probe_ms(torch, probe, nbytes: int, ctas: int) -> tuple:
    """(copy probe ms, bulk probe ms): ``nbytes`` moved (half read, half
    written, in bulk-probe chunks) by each probe on ``ctas`` CTAs."""
    chunks = max(1, nbytes // 2 // BULK_PROBE_CHUNK)
    src = torch.empty(chunks * BULK_PROBE_CHUNK, dtype=torch.uint8,
                      device="cuda")
    dst = torch.empty_like(src)

    def copy():
        rc = probe.copy_probe_launch(
            src.data_ptr(), dst.data_ptr(), src.numel() // 16, ctas,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"copy probe: CUDA error {rc}")

    def bulk():
        rc = probe.bulk_probe_launch(
            src.data_ptr(), dst.data_ptr(), chunks, BULK_PROBE_CHUNK,
            BULK_PROBE_STAGES, ctas, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"bulk probe: CUDA error {rc}")
    # the bulk probe copies exactly: held on its output
    src.random_(0, 256)
    bulk()
    torch.cuda.synchronize()
    if not torch.equal(src, dst):
        raise AssertionError("bulk probe: the copy differs from its source")
    return time_ms(torch, copy), time_ms(torch, bulk)


def k1_kernel_cases(torch, seed: int, probe) -> dict:
    """K1 (one card) at every K1_CASES shape: bit-identical on 1, 2, 4 and
    8 CTAs and through each vector route that takes the rows, within
    K1_TOL of the plain version; the K1_TIMED shapes timed on each such
    route (forced through ``K1._launch``) beside the bound and
    both 8-CTA probes.  Returns the kernel line's row."""
    from repro_torch.core import fused_collectives as FC
    from repro_torch.distributed.context import CommCtx
    from repro_torch.kernels import ar_rmsnorm as K1
    dev, bf16 = "cuda", torch.bfloat16
    gen1 = torch.Generator(device="cuda").manual_seed(seed + 1)
    k1_err, row = 0.0, None
    for n, t, d1 in K1_CASES:
        x = torch.randn(n, t, d1, generator=gen1, device=dev, dtype=bf16)
        r = torch.randn(n, t // n, d1, generator=gen1, device=dev,
                        dtype=bf16)
        w = (torch.randn(d1, generator=gen1, device=dev).abs() + 0.5
             ).to(bf16)
        out, new_res = K1.ar_rmsnorm(x, r, w, ctas=K1.MAX_CTAS)
        vec = K1.pipelined(x, r, w)
        group = K1.row_group(d1, bf16)
        # the bulk route takes rows of a whole CTA only
        routes = (("scalar",) if not vec else ("register", "bulk")
                  if group[1] == K1.CTA_THREADS else ("register",))
        chosen = K1.route(d1, bf16, n, t, K1.MAX_CTAS, vec)
        for c in CTA_SWEEP:
            for rt in routes:
                out1, new_res1 = K1._launch(
                    x, r, w, 1e-6, c, None if rt == "scalar" else rt)
                torch.cuda.synchronize()
                if not (torch.equal(out, out1)
                        and torch.equal(new_res, new_res1)):
                    raise AssertionError(
                        f"K1 N={n} T={t} d={d1}: {c} CTAs on the {rt} route "
                        f"differ from {K1.MAX_CTAS} CTAs on the {chosen} "
                        f"route")
        p_out, p_res = K1.ar_rmsnorm_plain(x, r, w)
        err = max(check_close(f"K1 out N={n} T={t} d={d1}", out, p_out,
                              K1_TOL, K1_TOL),
                  check_close(f"K1 residual N={n} T={t} d={d1}", new_res,
                              p_res, K1_TOL, K1_TOL))
        k1_err = max(k1_err, err)
        group = K1.row_group(d1, bf16)
        case = {"phase": "kernels", "kernel": "ar_rmsnorm", "N": n, "T": t,
                "d": d1, "dtype": "bfloat16", "max_abs_err": err,
                "tol": K1_TOL, "ctas_bit_identical": list(CTA_SWEEP),
                "routes_bit_identical": list(routes), "route": chosen,
                "group_threads": group[1] if group else None,
                "rows_at_once": group[2] if group else 1,
                "rows_per_cta": (K1.rows_per_cta(t, d1, bf16, K1.MAX_CTAS)
                                 if group else -(-t // K1.MAX_CTAS))}
        if (n, t, d1) == (8, 2048, 8192):
            # the composition K1 replaces: sum over ranks, K2, all-gather
            ctx = CommCtx(mode="fused", use_pallas=True, tp=n)
            c_out, c_res = FC.comm_norm(x, r, w, ctx=ctx)
            case["composition_max_abs_err"] = max(
                check_close("K1 vs composition", out, c_out, K1_TOL, K1_TOL),
                check_close("K1 vs composition residual", new_res, c_res,
                            K1_TOL, K1_TOL))
            case["ms_by_ctas"] = {str(c): time_ms(
                torch, lambda c=c: K1.ar_rmsnorm(x, r, w, ctas=c))
                for c in CTA_SWEEP}
            case.update(
                plain_ms=time_ms(
                    torch, lambda: K1.ar_rmsnorm_plain(x, r, w), iters=3),
                composition_ms=time_ms(
                    torch, lambda: FC.comm_norm(x, r, w, ctx=ctx)),
                library_ms=None)
        if (n, t, d1) in K1_TIMED:
            # each input read once, each output written once
            nbytes = 2 * (n + 1) * t * d1 * 2 + d1 * 2
            flops = (n + 5) * t * d1
            for rt in routes:
                case[f"ms_{rt}"] = time_ms(torch, lambda rt=rt: K1._launch(
                    x, r, w, 1e-6, K1.MAX_CTAS,
                    None if rt == "scalar" else rt))
            case["ms"] = case[f"ms_{chosen}"]
            # the same bytes through the plain and the bulk copy on the
            # same 8 CTAs
            case["budget_bound_ms"], case["budget_bound_bulk_ms"] = probe_ms(
                torch, probe, nbytes, K1.MAX_CTAS)
            case.update(bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                     flops / FP32_FLOPS) * 1e3,
                        bound_by="bytes")
            for key, name in (("ms", "achieved"), ("ms_register", "register"),
                              ("ms_bulk", "bulk"),
                              ("budget_bound_ms", "budget"),
                              ("budget_bound_bulk_ms", "budget_bulk")):
                if key in case:
                    case[f"{name}_gb_per_s"] = nbytes / case[key] / 1e6
        if (n, t, d1) == (8, 2048, 8192):
            case["achieved_gb_per_s_1cta"] = (
                nbytes / case["ms_by_ctas"]["1"] / 1e6)
            row = case
        emit(case)
        del x, r, out, out1, p_out, p_res
    # with a data axis comm_norm runs K1 once per data shard on views of
    # that shard's rows (each rank's slab contiguous, the ranks D·T rows
    # apart): bit-equal to K1 on contiguous copies, and held
    dp, n, t, d1 = 2, 4, 1024, 4096
    x = torch.randn(n, dp * t, d1, generator=gen1, device=dev, dtype=bf16)
    r = torch.randn(n, dp * t // n, d1, generator=gen1, device=dev,
                    dtype=bf16)
    w = (torch.randn(d1, generator=gen1, device=dev).abs() + 0.5).to(bf16)
    for g in range(dp):
        xv, rv = x[:, g * t:(g + 1) * t], r[:, g * t // n:(g + 1) * t // n]
        out, new_res = K1.ar_rmsnorm(xv, rv, w)
        c_out, c_res = K1.ar_rmsnorm(xv.contiguous(), rv.contiguous(), w)
        torch.cuda.synchronize()
        if not (torch.equal(out, c_out) and torch.equal(new_res, c_res)):
            raise AssertionError(f"K1 on data shard {g}'s views differs "
                                 f"from K1 on copies")
        p_out, p_res = K1.ar_rmsnorm_plain(xv, rv, w)
        err = max(check_close(f"K1 views shard {g}", out, p_out, K1_TOL,
                              K1_TOL),
                  check_close(f"K1 views shard {g} residual", new_res, p_res,
                              K1_TOL, K1_TOL))
        k1_err = max(k1_err, err)
        emit({"phase": "kernels", "kernel": "ar_rmsnorm", "N": n, "T": t,
              "d": d1, "data_shard": g, "data_shards": dp, "views": True,
              "dtype": "bfloat16", "max_abs_err": err, "tol": K1_TOL,
              "bit_identical_to_copies": True})
    del x, r, out, c_out, p_out, p_res
    torch.cuda.empty_cache()
    row["max_abs_err"] = k1_err
    return row


def kernel_phase(torch, seed: int, probe):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import fused_rmsnorm as K2

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev, bf16 = "cuda", torch.bfloat16
    rows = {}

    k2_err = 0.0
    # Llama's d 8192, then Falcon-Mamba's 4096, Zamba2's and Qwen2-VL's
    # 3584, Whisper-base's 512 at an encoder split's 8 x 1500 and
    # Gemma3-1B's one-row context-parallel decode at 1152 (held)
    for t, d in ((8, 8192), (32, 8192), (1000, 8192), (2048, 8192),
                 (2048, 4096), (1000, 3584), (2048, 3584), (12000, 512),
                 (1, 1152)):
        x = torch.randn(t, d, generator=gen, device=dev, dtype=bf16)
        r = torch.randn(t, d, generator=gen, device=dev, dtype=bf16)
        w = (torch.randn(d, generator=gen, device=dev).abs() + 0.5).to(bf16)
        out, new_res = K2.fused_residual_rmsnorm(x, r, w)
        torch.cuda.synchronize()
        p_out, p_res = K2.fused_residual_rmsnorm_plain(x, r, w)
        err = max(check_close(f"K2 out T={t}", out, p_out, K2_TOL, K2_TOL),
                  check_close(f"K2 residual T={t}", new_res, p_res, K2_TOL,
                              K2_TOL))
        k2_err = max(k2_err, err)
        case = {"phase": "kernels", "kernel": "fused_residual_rmsnorm",
                "T": t, "d": d, "dtype": "bfloat16", "max_abs_err": err,
                "tol": K2_TOL}
        if (t, d) == (2048, 8192):
            nbytes = 4 * t * d * 2 + d * 2
            case.update(
                ms=time_ms(torch, lambda: K2.fused_residual_rmsnorm(x, r, w)),
                plain_ms=time_ms(
                    torch, lambda: K2.fused_residual_rmsnorm_plain(x, r, w)),
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             5 * t * d / FP32_FLOPS) * 1e3,
                bound_by="bytes", library_ms=None)
            rows["fused_residual_rmsnorm"] = case
        emit(case)

    rows["ar_rmsnorm"] = k1_kernel_cases(torch, seed, probe)

    k3_err = 0.0

    def positions(sq, sk, q0, k_valid, b=1, k_at=0):
        """qpos q0..; kpos: the sk - sq keys before the chunk are empty
        cache slots (-1) but for k_valid keys at 0.. from index k_at, then
        the chunk's own keys at q0.."""
        qpos = torch.arange(q0, q0 + sq, dtype=torch.int32, device=dev)
        kpos = torch.full((sk,), -1, dtype=torch.int32, device=dev)
        kpos[k_at:k_at + k_valid] = torch.arange(k_valid, dtype=torch.int32,
                                                 device=dev)
        kpos[sk - sq:] = qpos
        return (qpos[None].repeat(b, 1).contiguous(),
                kpos[None].repeat(b, 1).contiguous())

    # (name, B, Sq, Sk, KVH, G, dh, causal, window, q0, cache keys valid,
    # index of the first valid one, padded query rows); bf16
    cases = [
        # a 1024-token split behind a full 4096-slot row
        ("main", 1, 1024, 4096 + 1024, 8, 8, 128, True, 0, 4096, 4096, 0,
         0),
        # the main path's first prefill split: a fresh request's empty
        # 4096-slot row, then the chunk's own keys
        ("engine", 1, 1024, 4096 + 1024, 8, 8, 128, True, 0, 0, 0, 0, 0),
        # its second split at tp=8, the ranks folded into the batch (one
        # KV head each): the empty row, the first split's 1024 keys, then
        # its own 776 tokens and the chunk's 56 padded rows
        ("engine_tp", 8, 832, 4096 + 1024 + 832, 1, 8, 128, True, 0, 1024,
         1024, 4096, 56),
        # ragged Sk, empty cache slots, padded prefill rows (qpos -1)
        ("padded", 1, 1000, 4096 + 1000, 8, 8, 128, True, 0, 1000, 1000, 0,
         56),
        ("window", 1, 512, 1536, 8, 8, 128, True, 256, 1024, 1024, 0, 0),
        # the other GQA groups and head dims of the configs, ragged
        ("g1_d64", 2, 300, 1000, 2, 1, 64, True, 0, 700, 600, 0, 20),
        ("g5_d128", 1, 257, 1000, 3, 5, 128, True, 300, 743, 743, 0, 0),
        ("g16_d64", 1, 100, 4096 + 100, 2, 16, 64, True, 0, 0, 0, 0, 7),
        # Zamba2's shared attention (2·3584 wide, 32 heads of 224) at the
        # hybrid phase's second chunk: a 256-token split of 4 rows behind
        # its 1040-cell cache rows (768 earlier tokens valid) and the
        # first split
        ("hybrid_d224", 4, 256, 1040 + 256, 32, 1, 224, True, 0, 768, 768,
         0, 0),
        # gemma3-1b's global layers (4 heads on 1 KV head of 256) behind
        # 2048 cached keys, and a ragged, windowed, padded case at 224
        ("gemma_d256", 1, 1024, 2048 + 1024, 1, 4, 256, True, 0, 2048, 2048,
         0, 0),
        ("g2_d224", 2, 300, 1000, 3, 2, 224, True, 128, 700, 600, 0, 20),
        # Whisper-base's encoder, bidirectional: one batch split of 8
        # rows of 1500 frames, 8 heads of 64
        ("whisper_enc", 8, 1500, 1500, 8, 1, 64, False, 0, 0, 0, 0, 0),
        # Qwen2-VL-7B's prefill, second split: 4 rows of 512 tokens behind
        # the first split's 512 keys, 28 heads on 4 KV heads (G 7)
        ("qwen2vl", 4, 512, 1024, 4, 7, 128, True, 0, 512, 512, 0, 0),
        # bidirectional with padded keys (kpos -1 between the cache's
        # valid keys and the chunk's own) and padded query rows, ragged
        ("bidir_padded", 2, 300, 1000, 3, 7, 64, False, 0, 700, 600, 0, 20),
        # Qwen3-MoE-235B's prefill (64 heads on 4 KV heads of 128): a
        # first split behind an empty 4096-slot row at tp=1 (G 16) and
        # at tp=8 (the ranks folded into the batch, 8 heads on one KV
        # head each), and a second split at D = 2 x R = 4 (2 rows a data
        # shard and the ranks folded into the batch: 16 rows, 16 heads on
        # one KV head) behind the first split's 512 keys
        ("qwen3", 1, 1024, 4096 + 1024, 4, 16, 128, True, 0, 0, 0, 0, 0),
        ("qwen3_tp8", 8, 1024, 4096 + 1024, 1, 8, 128, True, 0, 0, 0, 0,
         0),
        ("qwen3_ep2d", 16, 512, 1024, 1, 16, 128, True, 512, 512, 512, 0,
         0),
    ]
    timed = ("main", "engine", "engine_tp", "hybrid_d224", "gemma_d256",
             "whisper_enc", "qwen2vl", "qwen3", "qwen3_tp8", "qwen3_ep2d")
    for (name, b, sq, sk, kvh, g, dh, causal, window, q0, k_valid, k_at,
         pad) in cases:
        qpos, kpos = positions(sq, sk, q0, k_valid, b, k_at)
        if pad:
            qpos[:, -pad:] = -1          # their keys are padding too
            kpos[:, -pad:] = -1
        q = torch.randn(b, sq, kvh, g, dh, generator=gen, device=dev,
                        dtype=bf16)
        k = torch.randn(b, sk, kvh, dh, generator=gen, device=dev, dtype=bf16)
        v = torch.randn(b, sk, kvh, dh, generator=gen, device=dev, dtype=bf16)
        kw = dict(causal=causal, window=window)
        case = {"phase": "kernels", "kernel": "flash_attention", "case": name,
                **check_k3(torch, f"K3 {name}", q, k, v, qpos, kpos, **kw)}
        k3_err = max(k3_err, case["max_abs_err"])
        if name.startswith("engine") and not (case["key_tiles_visited"]
                                              < case["key_tiles_total"]):
            raise AssertionError(f"K3 {name}: no key tile skipped ({case})")
        if name in timed:
            qs = q.reshape(b, sq, kvh * g, dh).transpose(1, 2).contiguous()
            ks = k.transpose(1, 2).contiguous()
            vs = v.transpose(1, 2).contiguous()
            mask = K3.attention_mask(qpos, kpos, causal, window)[:, None]
            # only the (query, key) pairs the mask lets through need work
            pairs = int(mask.sum())
            # with every pair visible SDPA computes the same function
            # with no mask, on its fastest (flash) path
            sdpa_mask = None if pairs == b * sq * sk else mask
            flops = 4 * dh * kvh * g * pairs
            nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * (sq + sk)
            case.update(
                visible_pairs=pairs,
                ms=time_ms(torch, lambda: K3.flash_attention(q, k, v, qpos,
                                                             kpos, **kw)),
                plain_ms=time_ms(torch, lambda: K3.flash_attention_plain(
                    q, k, v, qpos, kpos, **kw), iters=3),
                bound_ms=max(flops / BF16_FLOPS,
                             nbytes / HBM_BYTES_PER_S) * 1e3,
                bound_by=("operations" if flops / BF16_FLOPS
                          > nbytes / HBM_BYTES_PER_S else "bytes"),
                library_ms=time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=sdpa_mask, scale=dh ** -0.5,
                        enable_gqa=True)))
            # what the host spends per call: the wrapper, and the
            # live-tile table's torch ops alone
            rows_cta, keys, _ = K3.tiling(dh)
            case.update(
                host_ms=host_ms(torch, lambda: K3.flash_attention(
                    q, k, v, qpos, kpos, **kw)),
                table_host_ms=host_ms(torch, lambda: K3.live_tiles(
                    qpos, kpos, queries_per_cta=rows_cta // g,
                    keys_per_tile=keys, **kw)))
            if name == "main":
                rows["flash_attention"] = case
        emit(case)
        del q, k, v
        torch.cuda.empty_cache()
    rows["fused_residual_rmsnorm"]["max_abs_err"] = k2_err
    rows["flash_attention"]["max_abs_err"] = k3_err
    return rows


# --------------------------------------------------------------------------
# phases 3 and 4: the engine at full width, at tp=1 and at tp=8
# --------------------------------------------------------------------------

def reset_launches():
    from repro_torch.kernels import ar_rmsnorm as K1
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import fused_rmsnorm as K2
    for fn in (K1.ar_rmsnorm, K2.fused_residual_rmsnorm, K3.flash_attention):
        fn.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import ar_rmsnorm as K1
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import fused_rmsnorm as K2
    return {"ar_rmsnorm": K1.ar_rmsnorm.launches,
            "fused_residual_rmsnorm": K2.fused_residual_rmsnorm.launches,
            "flash_attention": K3.flash_attention.launches}


def capture_k3_inputs(store: dict):
    """Make the model path keep a copy of K3's inputs at each shape it
    gives the kernel (the first call of each) in ``store``, so that they
    can be checked once the run is over; the calls still go through the
    wrapper, which counts the launches.  The copies are taken on the card
    (a copy kernel, in order with the run); ``offload`` moves them to the
    host between steps, outside the timed region, so a phase's peak
    memory holds at most one step's copies.  Returns the undo."""
    from repro_torch.layers import attention as A
    wrapper = A.flash_attention

    def keep(q, k, v, qpos, kpos, **kw):
        key = (tuple(q.shape), tuple(k.shape), q.dtype,
               tuple(sorted(kw.items())))
        if key not in store:
            store[key] = ([t.detach().clone() for t in (q, k, v, qpos, kpos)],
                          kw)
        return wrapper(q, k, v, qpos, kpos, **kw)

    A.flash_attention = keep
    return lambda: setattr(A, "flash_attention", wrapper)


def offload(store: dict) -> None:
    """Move ``capture_k3_inputs``' copies to the host."""
    for key, (tensors, kw) in store.items():
        store[key] = ([t.cpu() for t in tensors], kw)


def check_main_path_k3(torch, store: dict, engine: str, tp: int) -> float:
    """Hold K3 on the inputs ``capture_k3_inputs`` kept, shape by shape,
    emitting one ``main_path_k3`` line each; returns the max abs error."""
    torch.cuda.synchronize()
    if not store:
        raise AssertionError(f"{engine}: the model path reached no K3 call")
    k3_err = 0.0
    for tensors, kw in store.values():
        tensors = [t.cuda() for t in tensors]
        case = check_k3(torch, f"K3 {engine} main path "
                        f"{tuple(tensors[0].shape)}", *tensors, **kw)
        k3_err = max(k3_err, case["max_abs_err"])
        emit({"phase": "main_path_k3", "engine": engine, "tp": tp, **case})
        del tensors
    store.clear()
    torch.cuda.empty_cache()
    return k3_err


def capture_k2_inputs(store: dict):
    """As ``capture_k3_inputs``, for K2 where the model path reaches it
    (``core.fused_collectives``, ``use_pallas``): a copy of its inputs at
    the first call of each shape.  Returns the undo."""
    from repro_torch.core import fused_collectives as FC
    wrapper = FC.fused_residual_rmsnorm

    def keep(x, residual, weight, *, eps=1e-6, use_pallas=False):
        key = (tuple(x.shape), x.dtype, eps)
        if use_pallas and key not in store:
            store[key] = ([t.detach().clone() for t in (x, residual, weight)],
                          eps)
        return wrapper(x, residual, weight, eps=eps, use_pallas=use_pallas)

    FC.fused_residual_rmsnorm = keep
    return lambda: setattr(FC, "fused_residual_rmsnorm", wrapper)


def check_main_path_k2(torch, store: dict, engine: str) -> float:
    """Hold K2 on the inputs ``capture_k2_inputs`` kept, as the kernel
    phase holds it (every element within K2_TOL), one ``main_path_k2``
    line each; returns the max abs error."""
    from repro_torch.kernels import fused_rmsnorm as K2
    torch.cuda.synchronize()
    if not store:
        raise AssertionError(f"{engine}: the model path reached no K2 call")
    k2_err = 0.0
    for (x, r, w), eps in store.values():
        out, new_res = K2.fused_residual_rmsnorm(x, r, w, eps=eps)
        torch.cuda.synchronize()
        p_out, p_res = K2.fused_residual_rmsnorm_plain(x, r, w, eps)
        name = f"K2 {engine} main path {tuple(x.shape)}"
        err = max(check_close(f"{name} out", out, p_out, K2_TOL, K2_TOL),
                  check_close(f"{name} residual", new_res, p_res, K2_TOL,
                              K2_TOL))
        k2_err = max(k2_err, err)
        emit({"phase": "main_path_k2", "engine": engine,
              "T": x.shape[0], "d": x.shape[-1], "dtype": str(x.dtype)[6:],
              "max_abs_err": err, "tol": K2_TOL})
    store.clear()
    return k2_err


PROMPT_LENS, NEW_TOKENS = (1800, 1200, 700, 300), 16
SHARED_PREFIX, SHARER_OWN = 1024, 200   # the 5th request of engine_packed


def full_width_model(torch, np, seed: int, *, tp: int, comm_mode: str,
                     n_layers: int, config=None):
    """A registry model's widths (Llama-3.3-70B unless ``config``) cut to
    ``n_layers``, bf16, random weights from the seed at ``tp`` ranks, and
    the phases' prompts.  Collects what earlier phases left first (their
    engines sit in reference cycles through the timing wrappers); returns
    the memory still allocated then, which should be none of theirs."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models.build import build_model

    cfg = dataclasses.replace(config or get_config("llama3.3-70b"),
                              num_layers=n_layers)
    pcfg = ParallelConfig(comm_mode=comm_mode, attn_impl="pallas",
                          use_pallas_norm=True)
    api = build_model(cfg, pcfg, tp=tp)
    gc.collect()
    torch.cuda.empty_cache()
    start_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = api.init(seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    return cfg, api, params, prompts, init_s, start_gb


class MoeStats:
    """Per forward of a run: the MoE assignments each expert got and the
    share capacity dropped.  The counts are taken on the card, in stream
    order with the dispatch (no host sync), and read after the run;
    ``step`` closes a forward.  A no-op for a dense model."""

    def __init__(self, torch, cfg):
        from repro_torch.layers import moe
        self.torch, self.cfg, self.mod = torch, cfg, moe
        # ep2d dispatches twice (by destination shard, then by expert):
        # an assignment is kept when its arrival row is
        self.name = ("_ep2d_dispatch" if cfg.moe_partition == "ep2d"
                     else "_capacity_dispatch")
        self.orig = getattr(moe, self.name)
        self.calls, self.forwards = [], []
        if not cfg.is_moe:
            return
        experts = torch.arange(cfg.num_experts, device="cuda")
        ffn = cfg.moe_partition == "ffn"     # every rank holds every expert

        def count(x, topi, topw, **kw):
            buf, slot, flat_w = self.orig(x, topi, topw, **kw)
            kept = (slot[:1] if ffn else slot).ge(0).sum()
            load = (topi[0].reshape(-1, 1) == experts).sum(0)
            self.calls.append((topi.shape[1], torch.cat([load, kept[None]])))
            return buf, slot, flat_w

        def count_ep2d(xs, topi, **kw):
            buf, slot, slot2 = self.orig(xs, topi, **kw)
            load = (topi.reshape(-1, 1) == experts).sum(0)
            self.calls.append((topi.shape[0] * topi.shape[1],
                               torch.cat([load, slot2.ge(0).sum()[None]])))
            return buf, slot, slot2

        setattr(moe, self.name, count_ep2d if self.name == "_ep2d_dispatch"
                else count)

    def step(self):
        if self.calls:
            self.forwards.append(self.calls)
            self.calls = []

    def undo(self):
        setattr(self.mod, self.name, self.orig)

    def summary(self) -> dict:
        """Per forward: tokens (over its splits), the share of its T·k
        assignments dropped, and each expert's assignments per layer
        (min, mean, max; the list itself for at most 8 experts)."""
        cfg, k, n_layers = self.cfg, self.cfg.num_experts_per_tok, \
            self.cfg.num_layers
        rows, total = [], 0
        for calls in self.forwards:
            counts = self.torch.stack([c for _, c in calls]).sum(0).cpu()
            tokens = sum(t for t, _ in calls) // n_layers
            load = (counts[:-1].double() / n_layers).tolist()
            assigned = tokens * k * n_layers
            row = {"tokens": tokens, "splits": len(calls) // n_layers,
                   "drop_share": 1 - int(counts[-1]) / assigned,
                   "load_min": min(load), "load_mean": tokens * k
                   / cfg.num_experts, "load_max": max(load)}
            if cfg.num_experts <= 8:
                row["load"] = load
            rows.append(row)
            total += assigned
        dropped = sum(r["drop_share"] * r["tokens"] * k * n_layers
                      for r in rows)
        return {"forwards": rows, "drop_share": dropped / max(total, 1),
                "capacity_factor": cfg.capacity_factor}


def moe_ranges(cfg) -> dict:
    """The MoE layer's named ranges (label -> range) for
    ``device_breakdown``; none for a dense model."""
    if not cfg.is_moe:
        return {}
    from repro_torch.layers import moe
    return {"moe_route": moe.ROUTE_RANGE, "moe_dispatch": moe.DISPATCH_RANGE,
            "moe_experts": moe.EXPERTS_RANGE,
            "moe_combine": moe.COMBINE_RANGE}


def reset_peak(torch) -> float:
    """Start a run's peak-memory count from what is allocated now (the
    weights and the KV cache or pool); returns that, in GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def check_launches(eng, launches, *, norm_kernel: str, n_layers: int,
                   k3_splits: int) -> dict:
    """Every forward's add+norm slots ran the mode's kernel (so none fell
    back to vanilla, which launches neither K1 nor K2): splits·(1+2L)
    launches; K3 ran once per layer of each of ``k3_splits`` splits."""
    st = eng.stats
    splits = st.forwards + st.weave_forwards
    want = {"ar_rmsnorm": 0, "fused_residual_rmsnorm": 0,
            "flash_attention": k3_splits * n_layers}
    want[norm_kernel] = splits * (1 + 2 * n_layers)
    if launches != want or 0 in (launches[norm_kernel],
                                 launches["flash_attention"]):
        raise AssertionError(f"launches {launches}, expected {want}")
    return want


def check_outputs(done, n_requests: int, vocab: int, new_tokens: int):
    if sorted(r.rid for r in done) != list(range(n_requests)):
        raise AssertionError(f"finished {[r.rid for r in done]}")
    for r in done:
        if len(r.output) != new_tokens or not all(
                0 <= t < vocab for t in r.output):
            raise AssertionError(f"rid {r.rid} output {r.output}")


def check_drained(eng) -> None:
    """No block table left and no block referenced in the paged pool."""
    mgr = eng.block_mgr
    if mgr.tables or any(mgr.alloc.ref):
        raise AssertionError("the pool did not drain")


def engine_phase(torch, np, seed: int, trace_dir: Path, *, tp: int,
                 comm_mode: str, paged: bool = False, n_layers: int = 4,
                 config=None, phase: str = ""):
    """Serve the 4 requests through the two-dispatch engine at ``tp``
    ranks on the card's rank axis, over legacy slots or (``paged``) the
    paged pool; the add+norm slots run K2 (``fused``) or K1 (``ring``).
    ``config``: the model (Llama-3.3-70B by default), ``phase`` its
    lines' name.  Returns (launches, K3's max error on the run's inputs,
    peak GB)."""
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    phase = phase or ("engine_paged" if paged else ("engine" if tp == 1
                                                    else "engine_tp"))
    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, prompts, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode, n_layers=n_layers,
        config=config)

    # a direct prefill of request 0 must give finite logits of the right
    # shape, and the engine's first token for it must be their argmax
    cache_rows = api.init_cache(1, SchedulerConfig().max_len, device="cuda")
    chunk = 1856                       # what the scheduler pads 1800 to
    tokens = torch.zeros(1, chunk, dtype=torch.long, device="cuda")
    tokens[0, :1800] = torch.tensor(prompts[0], device="cuda")
    pos = torch.full((1, chunk), -1, dtype=torch.int32, device="cuda")
    pos[0, :1800] = torch.arange(1800, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits, _ = api.prefill(params, tokens, cache_rows, pos,
                                last_idx=torch.tensor([1799], device="cuda"))
    v_loc = params["embedding"]["embed"].shape[1]
    if logits.shape != (tp, 1, 1, v_loc) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"not finite / wrong shape")
    first_tok = int(sharded_argmax(logits, vocab_size=cfg.vocab_size)[0, 0])
    del logits

    eng = Engine(api, params, SchedulerConfig(paged=paged))
    times = {"prefill": [], "decode": []}
    k3_inputs = {}
    stats = MoeStats(torch, cfg)

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t) * 1e3)
            offload(k3_inputs)
            stats.step()
        return run

    eng._run_prefill = timed("prefill", eng._run_prefill)
    eng._run_decode = timed("decode", eng._run_decode)
    for i, p in enumerate(prompts):
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))

    undo = capture_k3_inputs(k3_inputs)
    try:
        run_start_gb = reset_peak(torch)
        reset_launches()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        undo()
        stats.undo()
    peak = torch.cuda.max_memory_allocated() / 1e9

    check_outputs(done, len(prompts), cfg.vocab_size, NEW_TOKENS)
    out0 = next(r for r in done if r.rid == 0).output[0]
    if out0 != first_tok:
        raise AssertionError(f"engine's first token {out0} != direct "
                             f"prefill argmax {first_tok}")
    st = eng.stats
    pf = eng.metrics.get("engine/site_forwards", site="prefill").value
    pw_inst = eng.metrics.get("engine/site_weave", site="prefill")
    pf_splits = pf + (pw_inst.value if pw_inst is not None else 0)
    want = check_launches(eng, launches, norm_kernel=norm_kernel,
                          n_layers=n_layers, k3_splits=pf_splits)
    row = {"phase": phase, "model": cfg.name, "tp": tp,
           "comm_mode": comm_mode, "paged": paged, "layers": n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "prompt_lens": list(PROMPT_LENS), "new_tokens": NEW_TOKENS,
           "forwards": st.forwards, "weave_forwards": st.weave_forwards,
           "prefill_forwards": pf, "prefill_splits": pf_splits,
           "launches": launches, "expected_launches": want,
           "param_init_s": init_s, "wall_s": wall_s,
           "prefill_ms": times["prefill"], "decode_ms": times["decode"],
           "prefill_ms_median": statistics.median(times["prefill"]),
           "decode_ms_median": statistics.median(times["decode"]),
           "allocated_at_start_gb": start_gb,
           "allocated_at_run_start_gb": run_start_gb,
           "max_memory_allocated_gb": peak}
    if paged:
        row["prefix_hit_tokens"] = eng.block_mgr.stats.hit_tokens
    emit(row)
    if cfg.is_moe:
        emit({"phase": "moe_forwards", "engine": phase, "tp": tp,
              **stats.summary()})

    if not paged:
        # where a step's time goes: request 0's whole prefill chunk, and
        # one decode step over the 8 slots (4 active), warm after the run
        last = torch.tensor([1799], device="cuda")
        dtok = torch.zeros(eng.scfg.max_batch, 1, dtype=torch.long,
                           device="cuda")
        dpos = torch.full((eng.scfg.max_batch, 1), -1, dtype=torch.int32,
                          device="cuda")
        dpos[:len(PROMPT_LENS), 0] = torch.tensor(
            [n + NEW_TOKENS - 1 for n in PROMPT_LENS], device="cuda")
        with torch.no_grad():
            for step, fn in (
                    ("prefill", lambda: api.prefill(
                        params, tokens, cache_rows, pos, last_idx=last)),
                    ("decode", lambda: api.decode_step(
                        params, dtok, eng.cache, dpos))):
                trace = trace_dir / f"{phase}_tp{tp}_{step}_trace.json"
                brk = device_breakdown(torch, fn, trace,
                                       ranges=moe_ranges(cfg))
                if tp > 1 and step == "prefill" and not brk["k1_launches"]:
                    raise AssertionError("no K1 kernel in the traced "
                                         "prefill")
                emit({"phase": "breakdown", "engine": phase, "tp": tp,
                      "step": step, "tokens":
                      chunk if step == "prefill" else eng.scfg.max_batch,
                      **brk})
    del eng, params, cache_rows
    torch.cuda.empty_cache()

    # K3 at every shape this run gave it, on the inputs it got there
    return launches, check_main_path_k3(torch, k3_inputs, phase, tp), peak


class RecordPackedSteps:
    """The model API with its packed steps' inputs kept (the tokens on
    the card, the host arrays), so that one step can be run again."""

    def __init__(self, api):
        self._api = api
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._api, name)

    def packed_step(self, params, tokens, cache, positions, **kw):
        self.calls.append((tokens, positions, kw))
        return self._api.packed_step(params, tokens, cache, positions, **kw)


def serve_with_sharer(eng, Request, prompts, new_tokens: int, sharer):
    """Serve ``prompts`` (rids 0..n-1) and, once request 0's prefill is
    done, one more request whose prompt is ``sharer`` (rid n): its
    admission finds request 0's full blocks in the prefix cache.  Returns
    (finished requests, the sharer)."""
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    late = Request(rid=len(prompts), prompt=sharer,
                   max_new_tokens=new_tokens)
    added = False
    while True:
        if not added and reqs[0].prefill_done:
            eng.add_request(late)
            added = True
        if not eng.step():
            break
    if not added:
        raise AssertionError("request 0 never finished its prefill")
    return eng.sched.finished, late


def packed_phase(torch, np, seed: int, trace_dir: Path, *, tp: int,
                 comm_mode: str, n_layers: int = 4, config=None,
                 phase: str = "engine_packed"):
    """Serve the 4 requests and a 5th that repeats request 0's first 1024
    prompt tokens (64 blocks of 16) and adds 200 of its own, through
    packed hybrid batching over
    the paged pool (the defaults of ``SchedulerConfig(paged=True,
    packed=True)``): one forward per step, its splits' attention K3 over
    the segments.  At tp=1, one mixed step (decode and prefill segments,
    two splits) is run again under the profiler, as it is at any tp for a
    MoE model (``config``; Llama-3.3-70B by default), whose expert parts
    the profile splits apart.  Returns (launches, K3's max error on the
    run's inputs, peak GB)."""
    from repro_torch.layers import attention as A
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, prompts, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode, n_layers=n_layers,
        config=config)
    rng = np.random.RandomState(seed + 5)
    sharer = (prompts[0][:SHARED_PREFIX]
              + rng.randint(0, cfg.vocab_size, SHARER_OWN).tolist())
    scfg = SchedulerConfig(paged=True, packed=True)
    eng = Engine(api, params, scfg)
    rec = RecordPackedSteps(api)
    eng.api = rec
    steps, k3_inputs = [], {}
    stats = MoeStats(torch, cfg)
    run_packed = eng._run_packed

    def timed(plan):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_packed(plan)
        torch.cuda.synchronize()
        kinds = {s.kind for s in plan.segments}
        steps.append({"segments": [[s.kind, s.n_tokens]
                                   for s in plan.segments],
                      "tokens": plan.total_tokens,
                      "split": plan.overlap.split,
                      "kind": "prefill" if "prefill" in kinds else "decode",
                      "mixed": kinds == {"prefill", "decode"},
                      "ms": (time.perf_counter() - t) * 1e3})
        offload(k3_inputs)
        stats.step()
    eng._run_packed = timed

    undo = capture_k3_inputs(k3_inputs)
    try:
        run_start_gb = reset_peak(torch)
        reset_launches()
        t0 = time.perf_counter()
        done, late = serve_with_sharer(eng, Request, prompts, NEW_TOKENS,
                                       sharer)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        undo()
        stats.undo()
    peak = torch.cuda.max_memory_allocated() / 1e9

    check_outputs(done, len(prompts) + 1, cfg.vocab_size, NEW_TOKENS)
    hit_blocks = late.prompt_hit_tokens // scfg.block_size
    if hit_blocks != SHARED_PREFIX // scfg.block_size:
        raise AssertionError(f"the 5th request hit {hit_blocks} blocks of "
                             f"the prefix cache, not "
                             f"{SHARED_PREFIX // scfg.block_size}")
    check_drained(eng)
    mgr = eng.block_mgr
    st = eng.stats
    want = check_launches(eng, launches, norm_kernel=norm_kernel,
                          n_layers=n_layers,
                          k3_splits=st.forwards + st.weave_forwards)
    for i, step in enumerate(steps):
        emit({"phase": "packed_step", "engine": phase, "tp": tp, "step": i,
              **step})
    by_kind = {k: [s["ms"] for s in steps if s["kind"] == k]
               for k in ("prefill", "decode")}
    emit({"phase": phase, "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "layers": n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype,
          "prompt_lens": list(PROMPT_LENS) + [len(sharer)],
          "new_tokens": NEW_TOKENS, "block_size": scfg.block_size,
          "num_blocks": scfg.effective_num_blocks,
          "chunk_tokens": scfg.chunk_tokens,
          "forwards": st.forwards, "weave_forwards": st.weave_forwards,
          "launches": launches, "expected_launches": want,
          "prefix_hit_blocks_5th": hit_blocks,
          "prefix_hit_tokens": mgr.stats.hit_tokens,
          "param_init_s": init_s, "wall_s": wall_s,
          "prefill_step_ms": by_kind["prefill"],
          "decode_step_ms": by_kind["decode"],
          "prefill_step_ms_median": statistics.median(by_kind["prefill"]),
          "decode_step_ms_median": statistics.median(by_kind["decode"]),
          "allocated_at_start_gb": start_gb,
          "allocated_at_run_start_gb": run_start_gb,
          "max_memory_allocated_gb": peak})
    if cfg.is_moe:
        emit({"phase": "moe_forwards", "engine": phase, "tp": tp,
              **stats.summary()})

    if tp == 1 or cfg.is_moe:
        # one mixed step with two splits, run again on the pool after the
        # run (its requests' blocks are still in place; the pool never
        # ran dry): where its time goes
        pick = next(i for i, s in enumerate(steps)
                    if s["mixed"] and s["split"] is not None)
        tokens, positions, kw = rec.calls[pick]
        trace = trace_dir / f"{phase}_tp{tp}_step_trace.json"
        with torch.no_grad():
            brk = device_breakdown(
                torch, lambda: api.packed_step(params, tokens, eng.cache,
                                               positions, **kw),
                trace, ranges={"scatter": A.SCATTER_RANGE,
                               "gather": A.GATHER_RANGE,
                               "layout": A.LAYOUT_RANGE, **moe_ranges(cfg)})
        emit({"phase": "breakdown", "engine": phase, "tp": tp,
              "step": "packed", "packed_step": pick,
              "segments": steps[pick]["segments"],
              "split": steps[pick]["split"], **brk})
    del eng, rec, params
    torch.cuda.empty_cache()
    return launches, check_main_path_k3(torch, k3_inputs, phase, tp), peak


# --------------------------------------------------------------------------
# speculative decoding at full width: engine_spec and verify_weave
# --------------------------------------------------------------------------

SPEC_NEW_TOKENS, SPEC_GAMMA = 64, 3
VERIFY_ROWS, VERIFY_CACHE, VERIFY_FILLED = 128, 1024, 960
VERIFY_REL_FRO = 1e-2          # weave-on logits against the unsplit call's


def spec_prompts(np, seed: int, vocab: int):
    """One seeded 64-token block repeated up to each of PROMPT_LENS:
    prompt-lookup traffic (``launch.serve.lookup_prompts``)."""
    from repro_torch.launch.serve import lookup_prompts
    return lookup_prompts(np, seed, vocab, PROMPT_LENS)


def serve_steps(torch, eng, Request, prompts, new_tokens: int, store: dict):
    """Serve ``prompts`` one timed step at a time (the card synchronized
    around each).  Returns (requests, steps): per step its ms, whether it
    prefilled, whether it verified, and the tokens it committed."""
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    st, steps = eng.stats, []
    while True:
        before = (st.prefill_tokens, st.spec.verify_steps,
                  sum(len(r.output) for r in reqs))
        torch.cuda.synchronize()
        t = time.perf_counter()
        more = eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        offload(store)
        if not more:
            return reqs, steps
        steps.append({"ms": ms, "prefill": st.prefill_tokens > before[0],
                      "verify": st.spec.verify_steps > before[1],
                      "tokens": sum(len(r.output) for r in reqs)
                      - before[2]})


def decode_summary(steps) -> dict:
    """Times of the steps that prefilled nothing: their median, and their
    wall per token they committed."""
    dec = [s for s in steps if not s["prefill"]]
    return {"decode_steps": len(dec),
            "decode_step_ms_median": statistics.median(s["ms"] for s in dec),
            "decode_ms_per_token": (sum(s["ms"] for s in dec)
                                    / sum(s["tokens"] for s in dec)),
            "ms_per_token": (sum(s["ms"] for s in steps)
                             / sum(s["tokens"] for s in steps))}


def spec_phase(torch, np, seed: int, *, tp: int, comm_mode: str,
               packed: bool = True, n_layers: int = 4):
    """Serve the 4 prompt-lookup requests (64 new tokens each, greedy)
    with speculative decoding (n-gram draft, gamma 3) over the paged pool,
    packed (verify windows are segments of K3's packed steps) or
    two-dispatch (``verify_step``), then the same engine with spec off on
    the same prompts.  Returns (launches of both runs, K3's max error on
    the spec run's inputs)."""
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, _, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode, n_layers=n_layers)
    prompts = spec_prompts(np, seed, cfg.vocab_size)
    runs, k3_inputs, total = {}, {}, {}
    for gamma in (SPEC_GAMMA, 0):
        scfg = SchedulerConfig(paged=True, packed=packed, spec_gamma=gamma)
        eng = Engine(api, params, scfg)
        draft_ms = []
        if gamma:
            # the drafting is host work: its time per step, on its own
            propose = eng.draft.propose

            def timed_propose(contexts, propose=propose):
                t = time.perf_counter()
                out = propose(contexts)
                draft_ms.append((time.perf_counter() - t) * 1e3)
                return out
            eng.draft.propose = timed_propose
        undo = capture_k3_inputs(k3_inputs) if gamma else None
        try:
            run_start_gb = reset_peak(torch)
            reset_launches()
            t0 = time.perf_counter()
            reqs, steps = serve_steps(torch, eng, Request, prompts,
                                      SPEC_NEW_TOKENS, k3_inputs)
            wall_s = time.perf_counter() - t0
            launches = read_launches()
        finally:
            if undo is not None:
                undo()
        peak = torch.cuda.max_memory_allocated() / 1e9
        check_outputs(eng.sched.finished, len(prompts), cfg.vocab_size,
                      SPEC_NEW_TOKENS)
        check_drained(eng)
        st = eng.stats
        if packed:
            k3_splits = st.forwards + st.weave_forwards
        else:
            pw = eng.metrics.get("engine/site_weave", site="prefill")
            k3_splits = (eng.metrics.get("engine/site_forwards",
                                         site="prefill").value
                         + (pw.value if pw is not None else 0))
        want = check_launches(eng, launches, norm_kernel=norm_kernel,
                              n_layers=n_layers, k3_splits=k3_splits)
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        runs[gamma] = {
            "outputs": {r.rid: r.output for r in reqs},
            "forwards": st.forwards, "weave_forwards": st.weave_forwards,
            "launches": launches, "expected_launches": want,
            "wall_s": wall_s, "steps": len(steps),
            "mixed_step_ms": [s["ms"] for s in steps if s["prefill"]],
            **decode_summary(steps),
            "allocated_at_run_start_gb": run_start_gb,
            "max_memory_allocated_gb": peak}
        if gamma:
            sp = st.spec
            verify_ms = [s["ms"] for s in steps
                         if s["verify"] and not s["prefill"]]
            runs[gamma].update(
                verify_steps=sp.verify_steps,
                draft_proposed=sp.draft_proposed,
                draft_accepted=sp.draft_accepted,
                acceptance_rate=sp.acceptance_rate,
                tokens_per_step=sp.tokens_per_step,
                verify_step_ms_median=statistics.median(verify_ms),
                verify_step_ms=verify_ms,
                draft_ms_median=statistics.median(draft_ms),
                draft_ms_total=sum(draft_ms))
            if not (sp.verify_steps > 0 and sp.draft_proposed > 0):
                raise AssertionError(f"no verify step or draft: {runs}")
        del eng
        gc.collect()
    if packed and not any(tensors[0].shape[1] == SPEC_GAMMA + 1
                          for tensors, _ in k3_inputs.values()):
        raise AssertionError("K3 never got a verify-only packed step")
    spec, off = runs[SPEC_GAMMA], runs[0]
    prefix = []
    for rid, out in spec.pop("outputs").items():
        ref = off["outputs"][rid]
        n = next((i for i, (a, b) in enumerate(zip(out, ref)) if a != b),
                 len(out))
        prefix.append(n)
    off.pop("outputs")
    emit({"phase": "engine_spec", "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "packed": packed, "paged": True,
          "layers": n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
          "gamma": SPEC_GAMMA, "draft": "ngram n=3",
          "prompt_lens": list(PROMPT_LENS), "new_tokens": SPEC_NEW_TOKENS,
          "param_init_s": init_s, "allocated_at_start_gb": start_gb, **spec,
          "spec_off": off,
          "tokens_matching_spec_off": sum(prefix),
          "matching_prefix_by_request": prefix,
          "tokens_total": SPEC_NEW_TOKENS * len(prompts),
          "ms_per_token_vs_spec_off": (spec["decode_ms_per_token"]
                                       / off["decode_ms_per_token"])})
    del params
    return total, check_main_path_k3(
        torch, k3_inputs, "engine_spec" + ("" if packed else "_two"), tp)


def verify_weave_phase(torch, np, seed: int, trace_dir: Path, *, tp: int,
                       comm_mode: str, n_layers: int = 4) -> dict:
    """One ``verify_step`` of 128 rows x (1 + gamma 3) tokens over a slot
    cache of 1024 cells with 960 positions filled (random bf16 KV): the
    verify site's threshold (128 rows) is met, so the weave splits the
    batch.  Run with the weave on and off: the split taken, the mode's
    kernel once per add+norm slot of each split, logits within
    VERIFY_REL_FRO of the unsplit call's; wall ms and a traced breakdown
    of each.  Returns the launches of the two counted calls."""
    from repro_torch.models import transformer as TRX

    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, _, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode, n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    cache = api.init_cache(VERIFY_ROWS, VERIFY_CACHE, device="cuda")
    for layer in cache:
        layer["k"].normal_(generator=gen)
        layer["v"].normal_(generator=gen)
        layer["pos"][:, :VERIFY_FILLED] = torch.arange(
            VERIFY_FILLED, dtype=torch.int32, device="cuda")
    s_v = SPEC_GAMMA + 1
    tokens = torch.randint(0, cfg.vocab_size, (VERIFY_ROWS, s_v),
                           generator=gen, device="cuda")
    positions = (VERIFY_FILLED + torch.arange(
        s_v, dtype=torch.int32, device="cuda"))[None].repeat(VERIFY_ROWS, 1)
    cache_gb = sum(t.numel() * t.element_size() for layer in cache
                   for t in layer.values()) / 1e9
    out, total = {}, {}
    for weave in (True, False):
        wapi = dataclasses.replace(api, pcfg=dataclasses.replace(
            api.pcfg, tokenweave=weave))
        info = TRX.weave_decision_info(VERIFY_ROWS, s_v, tp=tp,
                                       pcfg=wapi.pcfg, decode=True)
        if info.weave != weave or (info.split is None) == weave:
            raise AssertionError(f"weave={weave}: decision {info}")

        def call():
            return wapi.verify_step(params, tokens, cache, positions)
        with torch.no_grad():
            call()                                   # warm-up
            reset_launches()
            logits, _ = call()
            torch.cuda.synchronize()
            launches = read_launches()
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            name = f"verify_weave_tp{tp}_{'on' if weave else 'off'}"
            brk = device_breakdown(torch, call,
                                   trace_dir / f"{name}_trace.json")
        splits = 2 if weave else 1
        want = {"ar_rmsnorm": 0, "fused_residual_rmsnorm": 0,
                "flash_attention": 0}
        want[norm_kernel] = splits * (1 + 2 * n_layers)
        if launches != want:
            raise AssertionError(f"weave={weave}: launches {launches}, "
                                 f"expected {want}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        out[weave] = logits.float()
        emit({"phase": "verify_weave", "model": cfg.name, "tp": tp,
              "comm_mode": comm_mode, "layers": n_layers, "weave": weave,
              "rows": VERIFY_ROWS, "window": s_v, "cache_len": VERIFY_CACHE,
              "filled": VERIFY_FILLED, "cache_gb": cache_gb,
              "split": info.split, "reason": info.reason,
              "launches": launches, "expected_launches": want,
              "wall_ms": walls, "wall_ms_median": statistics.median(walls),
              "breakdown": brk})
    err = rel_fro(out[True], out[False])
    emit({"phase": "verify_weave_check", "tp": tp,
          "logits_rel_fro_err": err, "tol": VERIFY_REL_FRO})
    if not err <= VERIFY_REL_FRO:
        raise AssertionError(f"tp={tp}: weave-on logits differ by {err}")
    del cache, params, out
    return total


# --------------------------------------------------------------------------
# the sampler on the card at the full vocabulary
# --------------------------------------------------------------------------

SAMPLE_DRAWS, SAMPLE_BATCH, TV_TOL = 20000, 1000, 0.05
SAMPLE_SETTINGS = (dict(temperature=1.0, top_k=0, top_p=1.0),
                   dict(temperature=0.8, top_k=50, top_p=0.9))


def target_probs(np, row, *, temperature, top_k, top_p):
    """The filtered softmax of one logits row in float64 numpy:
    temperature, the k largest, then the smallest prefix reaching p."""
    x = row.astype(np.float64) / temperature
    keep = np.ones(len(x), bool)
    if top_k:
        keep &= x >= np.sort(x)[::-1][top_k - 1]
    p = np.where(keep, np.exp(x - x.max()), 0.0)
    p /= p.sum()
    if top_p < 1.0:
        order = np.argsort(p)[::-1]
        cut = int(np.searchsorted(np.cumsum(p[order]), top_p)) + 1
        q = np.zeros_like(p)
        q[order[:cut]] = p[order[:cut]]
        p = q / q.sum()
    return p


def total_variation(np, ids, p) -> float:
    emp = np.bincount(ids, minlength=len(p)) / len(ids)
    return 0.5 * float(np.abs(emp - p).sum())


def sampler_phase(torch, np, seed: int, *, tp: int):
    """Llama-3.3-70B's vocabulary (128256) on ``tp`` ranks: two fixed
    logits rows (24 hot tokens over a normal tail).  For each setting,
    ``filtered_logits`` keeps on the card the set it keeps on the CPU,
    and 20000 draws of ``sample``, and of the first token that
    ``verify_sample`` commits for a window whose draft is the most likely
    token or one outside the kept set, lie within TV 0.05 of the
    filtered softmax."""
    from repro_torch.configs.llama3_70b import CONFIG
    from repro_torch.runtime import sampler as S
    from repro_torch.runtime import spec as SP

    vocab = CONFIG.vocab_size
    rng = np.random.RandomState(seed + 31)
    rows = rng.randn(2, vocab).astype(np.float32)
    for row in rows:
        row[rng.choice(vocab, 24, replace=False)] += 14 + 2 * rng.rand(24)

    def on_ranks(a, dev):
        """(B, S, V) -> (R, B, S, V/R)."""
        b, s, v = a.shape
        return a.reshape(b, s, tp, v // tp).permute(2, 0, 1, 3).to(dev)

    gen = torch.Generator(device="cuda").manual_seed(seed + 32)
    full = torch.from_numpy(rows)
    for i, kw in enumerate(SAMPLE_SETTINGS):
        kept = {dev: (S.filtered_logits(on_ranks(full[:, None], dev),
                                        vocab_size=vocab, **kw)
                      > -1e29).cpu() for dev in ("cuda", "cpu")}
        if not torch.equal(kept["cuda"], kept["cpu"]):
            raise AssertionError(f"tp={tp} {kw}: kept sets differ between "
                                 f"cuda and cpu")
        p = target_probs(np, rows[0], **kw)
        batch = on_ranks(full[:1, None].expand(SAMPLE_BATCH, 1, vocab),
                         "cuda").contiguous()
        t = time.perf_counter()
        ids = np.concatenate([
            S.sample(batch, vocab_size=vocab, generator=gen, **kw).cpu()
            .numpy() for _ in range(SAMPLE_DRAWS // SAMPLE_BATCH)])
        sample_s = time.perf_counter() - t
        tv = {"sample": total_variation(np, ids, p)}
        window = on_ranks(full[None].expand(SAMPLE_BATCH, 2, vocab),
                          "cuda").contiguous()
        for label, first in (("draft_top", int(np.argmax(p))),
                             ("draft_outside", int(np.argmin(rows[0])))):
            draft = torch.full((SAMPLE_BATCH, 1), first, device="cuda")
            got = []
            for _ in range(SAMPLE_DRAWS // SAMPLE_BATCH):
                n_acc, emit_ = SP.verify_sample(window, draft, gen,
                                                vocab_size=vocab, **kw)
                got.append(torch.where(n_acc >= 1, draft[:, 0],
                                       emit_.long()).cpu().numpy())
            tv[label] = total_variation(np, np.concatenate(got), p)
        emit({"phase": "sampler", "tp": tp, "vocab": vocab, **kw,
              "draws": SAMPLE_DRAWS,
              "kept_tokens": int(kept["cpu"][:, 0].sum()),
              "kept_equal_cpu": True, "tv": tv, "tv_tol": TV_TOL,
              "sample_s": sample_s})
        if not max(tv.values()) < TV_TOL:
            raise AssertionError(f"tp={tp} {kw}: total variation {tv}")
        del batch, window


# K3's side pass over V (vsum_kernel) runs in the same call as its main
# kernel and counts as K3, as do the live-tile table's torch ops (read
# from the wrapper's named range, device_breakdown)
KINDS = (("flash_attention", "flash_fwd"), ("flash_attention", "vsum_kernel"),
         ("fused_rmsnorm", "fused_rmsnorm"), ("ar_rmsnorm", "ar_rmsnorm"))


def kernel_kind(name: str) -> str:
    name = name.lower()
    for kind, key in KINDS:
        if key in name:
            return kind
    if any(s in name for s in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm"
    return "other"


def overlap_ms(events, kind: str) -> float:
    """Device time of the ``kind`` kernels during which some other kernel
    ran (on another stream): intervals (start, end, kind) in ms."""
    others = sorted((s, e) for s, e, k in events if k != kind)
    merged = []
    for s, e in others:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total = 0.0
    for s, e, k in events:
        if k != kind:
            continue
        for ms, me in merged:
            if me <= s:
                continue
            if ms >= e:
                break
            total += min(e, me) - max(s, ms)
    return total


def device_breakdown(torch, fn, trace_path, ranges=None) -> dict:
    """Time one call of ``fn`` on the host's clock, then trace one more
    with torch.profiler into ``trace_path``: device time summed by kind of
    kernel, the longest kernels, the time some kernel ran (the union over
    streams, so kernels that overlap count once), the share of the first
    call's wall time in which none ran, and how much of K1's device time
    overlapped other kernels.  Kernels launched inside K3's live-tile
    range count as K3; that range's host time is given apart, and so are
    the host's time to enqueue the first call (until it returns) and its
    span from the traced call's first launch to its last.  ``ranges``
    (label -> a ``record_function`` name): the device time, kernel count
    and host time of each named range too."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as K3

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall_ms = (time.perf_counter() - t) * 1e3
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())
    events = events.get("traceEvents", events)
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "dur" in e]

    def in_range(name):
        """(correlation ids of the launches inside the named range, the
        range's host ms)."""
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") == name]
        corr = {e.get("args", {}).get("correlation") for e in launches
                if any(s <= e["ts"] <= t for s, t in spans)} - {None}
        return corr, sum(t - s for s, t in spans) / 1e3

    table, table_host_ms = in_range(K3.LIVE_TILES_RANGE)
    extra = {name: in_range(r) for name, r in (ranges or {}).items()}
    extra_ms = {name: 0.0 for name in extra}
    extra_n = {name: 0 for name in extra}
    kinds = {"gemm": 0.0, "flash_attention": 0.0, "fused_rmsnorm": 0.0,
             "ar_rmsnorm": 0.0, "other": 0.0}
    iv, table_ms, table_n, per_name = [], 0.0, 0, {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset") \
                or "dur" not in e:
            continue
        ms = e["dur"] / 1e3
        corr = e.get("args", {}).get("correlation")
        in_table = corr in table
        kind = "flash_attention" if in_table else kernel_kind(e["name"])
        kinds[kind] += ms
        table_ms += ms if in_table else 0.0
        table_n += in_table
        for name, (ids, _) in extra.items():
            if corr in ids:
                extra_ms[name] += ms
                extra_n[name] += 1
        name = e["name"][:100]
        per_name[name] = (per_name.get(name, (0.0, 0))[0] + ms,
                          per_name.get(name, (0.0, 0))[1] + 1)
        if e["cat"] == "kernel":
            iv.append((e["ts"] / 1e3, (e["ts"] + e["dur"]) / 1e3, kind))
    if not iv:
        raise AssertionError("torch.profiler recorded no kernel")
    busy = max(e for _, e, _ in iv) - min(s for s, _, _ in iv) - idle_ms(iv)
    k1 = [e - s for s, e, k in iv if k == "ar_rmsnorm"]
    kernels = sorted(((ms, n, name) for name, (ms, n) in per_name.items()),
                     reverse=True)
    k3_calls = sum(1 for e in events if e.get("cat") == "kernel"
                   and "flash_fwd" in e["name"])
    return {"wall_ms": wall_ms, "host_ms": enqueue_ms,
            "device_busy_ms": busy,
            "kernel_ms_sum": sum(kinds.values()),
            "device_idle_share": 1 - busy / wall_ms,
            "device_ms_by_kind": kinds,
            "traced_wall_ms": traced_wall_ms,
            "host_launch_span_ms": (max(e["ts"] + e["dur"] for e in launches)
                                    - min(e["ts"] for e in launches)) / 1e3,
            "k3_calls": k3_calls, "k3_table_kernels": table_n,
            "k3_table_device_ms": table_ms,
            "k3_table_host_ms": table_host_ms,
            "ranges": {name: {"device_ms": extra_ms[name],
                              "kernels": extra_n[name],
                              "host_ms": extra[name][1]} for name in extra},
            "k1_launches": len(k1), "k1_device_ms": sum(k1),
            "k1_overlapped_ms": overlap_ms(iv, "ar_rmsnorm"),
            "trace": str(trace_path),
            "top_kernels": [{"ms": ms, "count": n, "name": k}
                            for ms, n, k in kernels[:10]]}


def idle_ms(events) -> float:
    """Gaps between kernels over the traced span (any stream)."""
    iv = sorted((s, e) for s, e, _ in events)
    gap, end = 0.0, iv[0][1]
    for s, e in iv[1:]:
        if s > end:
            gap += s - end
        end = max(end, e)
    return gap


# --------------------------------------------------------------------------
# the MoE family at full width: Mixtral-8x22B and OLMoE-1B-7B
# --------------------------------------------------------------------------

MIXTRAL_LAYERS = 4                 # of 56: 19.3 GB of experts in bf16
OLMOE_LAYERS = 16                  # all of them: 12.9 GB of experts
MOE_SYNC_TOKENS = 2048


def moe_phases(**kw) -> list:
    """Mixtral-8x22B (``ffn``) through the two-dispatch engine at tp=1
    ``fused`` and tp=8 ``ring`` and packed over the pool at tp=8 ``ring``;
    OLMoE-1B-7B (``expert``, 8 experts a rank) packed at tp=8 ``ring``.
    The gates are the Llama phases': launch formulas, pools drained, K3
    held at every shape.  Returns each run's (launches, K3 error, peak)."""
    from repro_torch.configs import get_config
    mixtral = dict(config=get_config("mixtral-8x22b"), n_layers=MIXTRAL_LAYERS)
    olmoe = dict(config=get_config("olmoe-1b-7b"), n_layers=OLMOE_LAYERS)
    return [engine_phase(**kw, **mixtral, tp=1, comm_mode="fused",
                         phase="engine_moe"),
            engine_phase(**kw, **mixtral, tp=8, comm_mode="ring",
                         phase="engine_moe"),
            packed_phase(**kw, **mixtral, tp=8, comm_mode="ring",
                         phase="engine_moe_packed"),
            packed_phase(**kw, **olmoe, tp=8, comm_mode="ring",
                         phase="engine_moe_olmoe")]


def moe_sync_phase(torch, seed: int):
    """One ``moe_forward`` at Mixtral-8x22B's widths over 2048 tokens at
    tp=1 and tp=8, under ``torch.cuda.set_sync_debug_mode("error")``: any
    operation that waits for the card raises.  A warm call first (the
    libraries' first-use set-up is not the layer's); the output must be
    finite, and the call is timed between CUDA events."""
    from repro_torch.configs import get_config
    from repro_torch.layers import moe
    cfg = get_config("mixtral-8x22b")
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    for tp in (1, 8):
        gc.collect()
        torch.cuda.empty_cache()
        params = moe.init_moe_params(gen, cfg, tp, device="cuda",
                                     dtype=torch.bfloat16)
        x = torch.randn(1, 1, MOE_SYNC_TOKENS, cfg.d_model, generator=gen,
                        device="cuda", dtype=torch.bfloat16).expand(
                            tp, -1, -1, -1)
        with torch.no_grad():
            moe.moe_forward(params, x, cfg)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.set_sync_debug_mode("error")
            try:
                start.record()
                out, aux = moe.moe_forward(params, x, cfg)
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if out.shape != x.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"moe_sync tp={tp}: output "
                                 f"{tuple(out.shape)} not finite")
        emit({"phase": "moe_sync", "model": cfg.name, "tp": tp,
              "tokens": MOE_SYNC_TOKENS, "sync_debug_mode": "error",
              "raised": False, "ms": start.elapsed_time(end),
              "aux": aux.tolist()})
        del params, x, out


# --------------------------------------------------------------------------
# phase 5: the same small float32 model on the card and on the CPU
# --------------------------------------------------------------------------

def small_api(*, tp: int, comm_mode: str, moe: str = ""):
    """The identity checks' small float32 model: (config, model API);
    ``moe`` ("ffn" or "expert"): its MoE twin, 4 experts top-2 with
    expert d_ff 256 in that partitioning."""
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.models.build import build_model
    cfg = ModelConfig(name="small", family="dense", num_layers=2, d_model=256,
                      num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512,
                      vocab_size=512, dtype="float32")
    if moe:
        cfg = dataclasses.replace(
            cfg, name=f"small-moe-{moe}", family="moe", num_experts=4,
            num_experts_per_tok=2, moe_d_ff=256, moe_partition=moe)
    pcfg = ParallelConfig(comm_mode=comm_mode, attn_impl="pallas",
                          use_pallas_norm=True, split_unit=16,
                          tokenweave_min_tokens=32)
    return cfg, build_model(cfg, pcfg, tp=tp)


def capture_routes(torch, store: list):
    """Make the MoE layer keep, per call, each row's expert choice and
    the gap between its k-th and (k+1)-th router probability (how near a
    tie it was), on the host.  Returns the undo."""
    from repro_torch.layers import moe
    orig = moe._route

    def keep(x, router, cfg):
        topw, topi, aux = orig(x, router, cfg)
        probs = torch.softmax(x.float() @ router, dim=-1)
        top = moe.top_k(probs, cfg.num_experts_per_tok + 1)[0]
        store.append((topi[0].cpu(), (top[0, :, -2] - top[0, :, -1]).cpu()))
        return topw, topi, aux

    moe._route = keep
    return lambda: setattr(moe, "_route", orig)


def route_flips(routes: dict, splits: int) -> list:
    """The rows whose experts differ between cuda and cpu, by layer."""
    flips = []
    for i, ((ti, tm), (ci, cm)) in enumerate(zip(routes["cuda"],
                                                 routes["cpu"])):
        for row in (ti != ci).any(-1).nonzero().flatten().tolist():
            flips.append({"layer": i // splits, "split": i % splits,
                          "row": row, "cuda": ti[row].tolist(),
                          "cpu": ci[row].tolist(),
                          "margin_cuda": float(tm[row]),
                          "margin_cpu": float(cm[row])})
    return flips


def identity_phase(torch, np, seed: int, *, tp: int, comm_mode: str,
                   moe: str = ""):
    """A small float32 model (its MoE twin with ``moe``) served on the
    card and on the CPU: greedy tokens equal over slots and packed over
    the pool, prefill logits within IDENTITY_LOGIT_TOL; for the dense
    model also with speculation.  A MoE twin's prefill check also holds
    each layer's expert choices equal on both devices, and a mismatch
    names the rows that flipped and how near a tie they were."""
    from repro_torch.models.build import build_model
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api = small_api(tp=tp, comm_mode=comm_mode, moe=moe)
    pcfg = api.pcfg
    scfg = SchedulerConfig(max_batch=16, chunk_tokens=64, max_len=128,
                           prefill_bucket=16)
    p_cpu = api.init(seed, device="cpu")
    p_gpu = to_device(p_cpu, "cuda")

    rng = np.random.RandomState(seed + 1)
    prompts = [rng.randint(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.randint(5, 100, size=16)]

    # prefill logits on both devices (and, for a MoE twin, every layer's
    # expert choices)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 48)))
    pos = torch.arange(48, dtype=torch.int32)[None].repeat(2, 1)
    pos[1, 40:] = -1
    last = torch.tensor([47, 39])
    logits, routes = {}, {}
    with torch.no_grad():
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            rows = api.init_cache(2, scfg.max_len, device=dev)
            routes[dev] = []
            undo = capture_routes(torch, routes[dev])
            try:
                logits[dev], _ = api.prefill(params, tokens.to(dev), rows,
                                             pos.to(dev),
                                             last_idx=last.to(dev))
            finally:
                undo()
    err = max_err(logits["cuda"].cpu(), logits["cpu"])
    splits = 1 + api.mod.weave_decision_info(2, 48, tp=tp, pcfg=pcfg).weave
    flips = route_flips(routes, splits) if moe else []
    if flips or not err <= IDENTITY_LOGIT_TOL:
        raise AssertionError(f"tp={tp} {cfg.name}: prefill logits differ "
                             f"by {err}; expert choices flipped: {flips}")

    # greedy speculative decoding (gamma 3) with the n-gram draft and
    # with a one-layer random draft model of the same vocabulary
    from repro_torch.runtime import spec as SP
    if not moe:
        dapi = build_model(dataclasses.replace(cfg, num_layers=1), pcfg,
                           tp=tp)
        d_cpu = dapi.init(seed + 7, device="cpu")
        d_params = {"cpu": d_cpu, "cuda": to_device(d_cpu, "cuda")}

    def spec_identity(engine, base, serve, want):
        """The spec engines over ``base``'s scheduler give the spec-off
        tokens ``want`` on cuda and on cpu, verifying windows on both."""
        for kind in ("ngram", "model"):
            got, launches, spec = {}, {}, {}
            for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
                draft = None if kind == "ngram" else SP.ModelDraft(
                    dapi, d_params[dev], SPEC_GAMMA, max_batch=base.max_batch)
                reset_launches()
                eng = Engine(api, params, dataclasses.replace(
                    base, spec_gamma=SPEC_GAMMA), draft=draft, device=dev)
                got[dev] = serve(eng)
                torch.cuda.synchronize()
                launches[dev] = read_launches()
                spec[dev] = [eng.stats.spec.verify_steps,
                             eng.stats.spec.draft_accepted]
            if got["cuda"] != want or got["cpu"] != want:
                raise AssertionError(f"tp={tp} {engine} {kind} draft: spec "
                                     f"tokens {got} != spec off {want}")
            if (0 in (launches["cuda"][norm_kernel],
                      launches["cuda"]["flash_attention"],
                      spec["cuda"][0], spec["cpu"][0])
                    or any(launches["cpu"].values())):
                raise AssertionError(f"tp={tp} {engine} {kind}: launches "
                                     f"{launches}, verify/accepted {spec}")
            emit({"phase": "identity_spec", "model": cfg.name, "tp": tp,
                  "comm_mode": comm_mode, "engine": engine, "draft": kind,
                  "gamma": SPEC_GAMMA, "requests": len(want),
                  "tokens_identical": True,
                  "verify_steps_accepted": spec,
                  "cuda_launches": launches["cuda"]})

    def serve_slots(eng):
        for i, p in enumerate(prompts):
            eng.add_request(Request(rid=i, prompt=p, max_new_tokens=6))
        return {r.rid: r.output for r in eng.run()}

    outs, launches, weave = {}, {}, {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        reset_launches()
        eng = Engine(api, params, scfg, device=dev)
        outs[dev] = serve_slots(eng)
        torch.cuda.synchronize()
        launches[dev] = read_launches()
        weave[dev] = eng.stats.weave_forwards
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(f"tp={tp} {cfg.name}: cuda tokens "
                             f"{outs['cuda']} != cpu {outs['cpu']}")
    if (0 in (launches["cuda"][norm_kernel],
              launches["cuda"]["flash_attention"])
            or any(launches["cpu"].values()) or not weave["cuda"]):
        raise AssertionError(f"tp={tp}: launches {launches}, weave "
                             f"forwards {weave}")
    row = {"phase": "identity", "model": cfg.name, "tp": tp,
           "comm_mode": comm_mode, "requests": len(prompts),
           "tokens_identical": True, "weave_forwards": weave["cuda"],
           "cuda_launches": launches["cuda"],
           "prefill_logits_max_abs_err": err, "tol": IDENTITY_LOGIT_TOL}
    if moe:
        row["min_route_margin"] = min(
            float(m.min()) for _, m in routes["cuda"])
    emit(row)
    if not moe:
        spec_identity("slots", scfg, serve_slots, outs["cuda"])

    # packed hybrid batching over the paged pool, with one more request
    # sharing the longest prompt's first 32 tokens (2 blocks of 16),
    # added once request 0's prefill is done
    pscfg = dataclasses.replace(scfg, paged=True, packed=True)
    src = max(prompts, key=len)
    order = [src] + [p for p in prompts if p is not src]
    sharer = src[:32] + rng.randint(0, cfg.vocab_size, 8).tolist()
    hits = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        reset_launches()
        eng = Engine(api, params, pscfg, device=dev)
        done, late = serve_with_sharer(eng, Request, order, 6, sharer)
        outs[dev] = {r.rid: r.output for r in done}
        torch.cuda.synchronize()
        launches[dev] = read_launches()
        weave[dev] = eng.stats.weave_forwards
        hits[dev] = late.prompt_hit_tokens
    if outs["cuda"] != outs["cpu"] or len(outs["cuda"]) != len(order) + 1:
        raise AssertionError(f"tp={tp} packed paged: cuda tokens "
                             f"{outs['cuda']} != cpu {outs['cpu']}")
    if (0 in (launches["cuda"][norm_kernel],
              launches["cuda"]["flash_attention"])
            or any(launches["cpu"].values()) or not weave["cuda"]
            or hits["cuda"] != hits["cpu"] or hits["cuda"] != 32):
        raise AssertionError(f"tp={tp} packed paged: launches {launches}, "
                             f"weave forwards {weave}, prefix hits {hits}")
    emit({"phase": "identity_packed_paged", "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "requests": len(order) + 1,
          "tokens_identical": True, "weave_forwards": weave["cuda"],
          "prefix_hit_tokens_sharer": hits["cuda"],
          "cuda_launches": launches["cuda"]})
    if not moe:
        spec_identity("packed_paged", pscfg, lambda eng: {
            r.rid: r.output for r in serve_with_sharer(
                eng, Request, order, 6, sharer)[0]}, outs["cuda"])


# --------------------------------------------------------------------------
# online serving with tracing, profiling and calibration at full width
# --------------------------------------------------------------------------

ONLINE_N, ONLINE_NEW = 8, 32       # (a) and (b): 8 requests, 32 new tokens
ONLINE_TP8_N, ONLINE_TP8_NEW = 4, 16   # (c)
ONLINE_PROMPTS = (300, 1800)       # prompt lengths, drawn from the seed
ONLINE_GAP_STEPS = 6               # mean inter-arrival: a prefill + 6
#                                    decode steps on the calibrated clock
ONLINE_CANCEL = (1, 4)             # rid 1 disconnects after 4 tokens
ONLINE_EXPIRE = (2, 4)             # rid 2's deadline: 4 decode steps
ONLINE_MIN_OVERLAP = 3             # arrivals while others decode
FENCE_CALLS = 1000                 # wrapped no-ops timing the fence


def online_prompts(np, seed: int, vocab: int, n: int):
    rng = np.random.RandomState(seed + 16)
    lens = rng.randint(ONLINE_PROMPTS[0], ONLINE_PROMPTS[1] + 1, n)
    return [rng.randint(0, vocab, int(m)).tolist() for m in lens]


class EventTimedSteps:
    """The model API with each packed step timed between two CUDA events
    on the current stream: inside the engine's dispatch, so inside the
    profiler's fences, the same call the profiler measures."""

    def __init__(self, torch, api):
        self._torch = torch
        self._api = api
        self.events = []

    def __getattr__(self, name):
        return getattr(self._api, name)

    def packed_step(self, *args, **kw):
        start = self._torch.cuda.Event(enable_timing=True)
        end = self._torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._api.packed_step(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out


def serve_counted(torch, eng, Request, prompts, new_tokens: int, *,
                  norm_kernel: str, n_layers: int, total: dict):
    """Serve ``prompts`` offline with the launch counts set to 0 just
    before and read just after; the counts must equal the packed
    formulas, and are added to ``total``.  Returns ({rid: tokens},
    wall seconds)."""
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    st = eng.stats
    check_launches(eng, launches, norm_kernel=norm_kernel,
                   n_layers=n_layers,
                   k3_splits=st.forwards + st.weave_forwards)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    check_outputs(reqs, len(prompts), eng.api.cfg.vocab_size, new_tokens)
    check_drained(eng)
    return {r.rid: list(r.output) for r in reqs}, wall_s


def calibration_row(rep) -> dict:
    return {"mfu_cap": rep.mfu_cap, "ici": rep.ici,
            "overhead_s": rep.overhead, "step_base_s": rep.step_base,
            "step_per_token_s": rep.step_per_token,
            "n_samples": rep.n_samples, "buckets": len(rep.buckets),
            "worst_rel_err": rep.worst_rel_err,
            "worst_bucket": rep.worst_bucket,
            "per_mode_rel_err": rep.per_mode_rel_err}


def measured_ms(prof) -> dict:
    return {kind: {"n": row["n"], "mean_ms": row["mean_s"] * 1e3}
            for kind, row in prof.summary().items()}


def serve_online(torch, eng, prompts, new_tokens: int, cost, seed: int, *,
                 trace_path: Path, norm_kernel: str, n_layers: int,
                 total: dict):
    """Serve ``prompts`` through an ``OnlineServer`` over ``eng`` (which
    carries a TraceRecorder) on the clock ``cost``, with Poisson arrivals,
    ONLINE_CANCEL's rid disconnecting during its decode and ONLINE_EXPIRE's
    rid given a deadline that expires.  Gates: launches equal the packed
    formulas (added to ``total``), the pool drains, the cancel and the
    expiry land, every other request finishes with its budget, at least
    ONLINE_MIN_OVERLAP requests arrive while others decode, and the trace
    validates with one terminal event per request.  Returns (the row to
    print, the requests)."""
    from repro_torch.obs import (TERMINAL_PHASES, export_chrome_trace,
                                 validate_chrome_trace)
    from repro_torch.runtime.requests import Request, poisson_arrivals
    from repro_torch.runtime.server import OnlineServer, ServerConfig

    decode_s = cost.of(len(prompts))
    # a mean gap of one mean prompt's prefill and ONLINE_GAP_STEPS decode
    # steps: each request lives about new_tokens steps, so several overlap
    mean_prompt = sum(map(len, prompts)) / len(prompts)
    rate = 1.0 / (cost.of(mean_prompt) + ONLINE_GAP_STEPS * decode_s)
    srv = OnlineServer(eng, ServerConfig(step_cost=cost,
                                         expire_on_deadline=True))
    reqs = poisson_arrivals(
        [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
         for i, p in enumerate(prompts)], rate=rate, seed=seed)
    cancel_rid, cancel_after = ONLINE_CANCEL
    expire_rid, expire_steps = ONLINE_EXPIRE
    streamed, disconnect = [], []

    def on_token(req, tok, at):
        streamed.append((req.rid, tok, at))
        if req.rid == cancel_rid and len(req.output) >= cancel_after \
                and not disconnect:
            disconnect.append(at)
            srv.cancel(cancel_rid)
    for r in reqs:
        if r.rid == expire_rid:
            r.deadline = r.arrival_time + expire_steps * decode_s
        srv.submit(r, on_token=on_token)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    st = eng.stats
    check_launches(eng, launches, norm_kernel=norm_kernel,
                   n_layers=n_layers,
                   k3_splits=st.forwards + st.weave_forwards)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    check_drained(eng)
    by_rid = {r.rid: r for r in reqs}
    if by_rid[cancel_rid].finish_reason != "cancelled" or \
            by_rid[expire_rid].finish_reason != "expired":
        raise AssertionError(
            f"cancel/expiry: {by_rid[cancel_rid].finish_reason}, "
            f"{by_rid[expire_rid].finish_reason}")
    for r in reqs:
        if r.rid not in (cancel_rid, expire_rid) and (
                r.finish_reason != "stop" or len(r.output) != new_tokens):
            raise AssertionError(f"rid {r.rid}: {r.finish_reason}, "
                                 f"{len(r.output)} tokens")
    overlap = [r.rid for r in reqs if any(
        o is not r and o.first_token_time is not None
        and o.first_token_time <= r.arrival_time
        < (o.finish_time if o.finish_time is not None else float("inf"))
        for o in reqs)]
    if len(overlap) < ONLINE_MIN_OVERLAP:
        raise AssertionError(f"only {overlap} arrived while others "
                             f"decoded")
    doc = export_chrome_trace(eng.obs, path=str(trace_path))
    problems = validate_chrome_trace(doc)
    phases: dict = {}
    for ev in eng.obs.events:
        if ev["kind"] == "request":
            phases.setdefault(ev["rid"], []).append(ev["phase"])
    admitted = [rid for rid, ph in phases.items() if "admit" in ph]
    terminals = {rid: sum(p in TERMINAL_PHASES for p in ph)
                 for rid, ph in phases.items()}
    # every request reached one terminal state (the expiring one may
    # expire before its admission); the validator holds the admitted ones
    # to it too
    if problems or len(phases) != len(prompts) or not admitted or any(
            n != 1 for n in terminals.values()):
        raise AssertionError(f"online trace: {problems[:5]}, terminals "
                             f"{terminals}")
    lat = st.latency
    if (st.cancelled, st.expired) != (1, 1) or not lat.goodput < 1.0:
        raise AssertionError(f"cancelled {st.cancelled}, expired "
                             f"{st.expired}, goodput {lat.goodput}")
    return {"rate_per_s": rate, "decode_step_s": decode_s,
            "step_cost": {"base_s": cost.base, "per_token_s": cost.per_token},
            "arrivals_s": [r.arrival_time for r in reqs],
            "arrived_while_others_decode": overlap,
            "latency": lat.summary(), "goodput": lat.goodput,
            "cancelled": st.cancelled, "expired": st.expired,
            "completed": st.completed, "steps": st.steps,
            "forwards": st.forwards, "weave_forwards": st.weave_forwards,
            "streamed_tokens": len(streamed), "disconnect_s": disconnect,
            "virtual_s": srv.clock, "wall_s": wall_s, "launches": launches,
            "trace": str(trace_path), "trace_events": len(doc["traceEvents"]),
            "admitted": len(admitted), "terminal_events": terminals}, reqs


def online_identity(torch, np, seed: int, total: dict, trace_path: Path):
    """Online tokens against offline ones, gated, on the identity phase's
    small float32 model (TF32 off) on the card: the same traffic as the
    llama-width run (8 requests, 32 new tokens, Poisson arrivals, a
    cancel, an expiry) on a unit clock; every request that finishes gives
    its offline tokens.  At llama width in bf16 the online run's batches
    give the GEMMs other shapes than the offline run's, so its tokens are
    reported, not gated (as spec against spec off)."""
    from repro_torch.obs import TraceRecorder
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig
    from repro_torch.runtime.server import StepCost

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, api = small_api(tp=1, comm_mode="fused")
        params = api.init(seed, device="cuda")
        rng = np.random.RandomState(seed + 17)
        prompts = [rng.randint(0, cfg.vocab_size, int(n)).tolist()
                   for n in rng.randint(5, 100, size=ONLINE_N)]
        scfg = SchedulerConfig(max_batch=ONLINE_N, chunk_tokens=64,
                               max_len=160, prefill_bucket=16, paged=True,
                               packed=True)
        kw = dict(norm_kernel="fused_residual_rmsnorm",
                  n_layers=cfg.num_layers, total=total)
        offline, _ = serve_counted(torch, Engine(api, params, scfg),
                                   Request, prompts, ONLINE_NEW, **kw)
        eng = Engine(api, params, scfg, obs=TraceRecorder())
        row, reqs = serve_online(
            torch, eng, prompts, ONLINE_NEW, StepCost(1.0, 0.02), seed,
            trace_path=trace_path, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    differ = {r.rid: r.output for r in reqs
              if r.finish_reason == "stop" and r.output != offline[r.rid]}
    emit({"phase": "online_identity", "model": cfg.name, "tp": 1,
          "dtype": cfg.dtype, "new_tokens": ONLINE_NEW,
          "prompt_lens": [len(p) for p in prompts],
          "tokens_equal_offline": not differ,
          **{k: row[k] for k in ("arrived_while_others_decode", "latency",
                                 "cancelled", "expired", "steps",
                                 "forwards", "weave_forwards",
                                 "launches")}})
    if differ:
        raise AssertionError(f"online tokens differ from offline: {differ}")


def online_phase(torch, np, seed: int, trace_dir: Path,
                 n_layers: int = 4) -> dict:
    """The port's serving front end and observability on the card.

    (a) tp=1 ``fused``: 8 requests (prompts of 300-1800 tokens, 32 new,
        greedy) through the packed paged engine with a WallClockProfiler
        and a TraceRecorder, then plain, profiled, profiled, plain
        (tokens, steps and forwards equal; the profiler's cost per step
        from the turns; the same profiler, so every shape is past its
        warm-up);
        ``fit_calibration`` on the profiler's steady samples; its JSON
        and the Chrome trace are written to ``trace_dir/online/``; the
        trace validates and its weave counts equal EngineStats'.
    (b) tp=1: the same requests through ``OnlineServer`` on the clock
        ``StepCost.from_calibration`` gives, with Poisson arrivals at a
        rate of one per ONLINE_GAP_STEPS decode steps, rid 1 cancelled
        during its decode and rid 2 past a deadline that expires; the
        others finish with their offline tokens, the pool drains, the
        trace has one terminal event per admitted request.  At llama
        width in bf16 the online tokens are reported beside the offline
        ones; ``online_identity`` gates them on a small float32 model.
    (c) tp=8 ``ring`` (K1 on the weave's comm stream): 4 requests, 16
        new tokens, profiled, plain, and profiled again with the same
        profiler (tokens equal); a fit at tp=8; each woven prefill's
        measured ms is not below its model call's time between CUDA
        events on the current stream, taken by chip_smoke inside the
        same dispatch (the fence covers every stream).

    Returns (the launches of the counted runs, summed; K3's max error
    on the inputs the online run (b) gave it, ``main_path_k3`` lines)."""
    from repro_torch.analysis.calibration import fit_calibration
    from repro_torch.obs import (TraceRecorder, WallClockProfiler,
                                 export_chrome_trace, validate_chrome_trace,
                                 weave_counts_from_trace)
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig
    from repro_torch.runtime.server import StepCost

    out_dir = trace_dir / "online"
    out_dir.mkdir(parents=True, exist_ok=True)
    total: dict = {}
    scfg = SchedulerConfig(paged=True, packed=True)

    # (a) calibrate at tp=1
    cfg, api, params, _, init_s, _ = full_width_model(
        torch, np, seed, tp=1, comm_mode="fused", n_layers=n_layers)
    prompts = online_prompts(np, seed, cfg.vocab_size, ONLINE_N)
    kw = dict(norm_kernel="fused_residual_rmsnorm", n_layers=n_layers,
              total=total)
    rec, prof = TraceRecorder(), WallClockProfiler()
    eng = Engine(api, params, scfg, obs=rec, profiler=prof)
    offline, wall_prof = serve_counted(torch, eng, Request, prompts,
                                       ONLINE_NEW, **kw)
    st = eng.stats
    # plain and profiled in turns (the same profiler: every shape is past
    # its warm-up now, so the fit sees each kind of step, the first
    # prefill's included); the profiler's cost is the difference
    walls = {"plain": [], "profiled": []}
    for name in ("plain", "profiled", "profiled", "plain"):
        other = Engine(api, params, scfg,
                       profiler=prof if name == "profiled" else None)
        toks, wall = serve_counted(torch, other, Request, prompts,
                                   ONLINE_NEW, **kw)
        walls[name].append(wall)
        if toks != offline or (other.stats.steps, other.stats.forwards) \
                != (st.steps, st.forwards):
            raise AssertionError(f"a {name} run differs from the profiled "
                                 f"and traced one")
    del other
    # the fence's own cost on an idle card: two synchronizes and a timer
    fence = WallClockProfiler().attach(device="cuda").wrap(lambda: None)
    t0 = time.perf_counter()
    for _ in range(FENCE_CALLS):
        fence()
    fence_us = (time.perf_counter() - t0) * 1e6 / FENCE_CALLS
    report = fit_calibration(cfg, prof.steady_samples(), tp=1,
                             tile=api.pcfg.split_unit_for(1),
                             model=cfg.name)
    report.save(str(out_dir / "calibration_tp1.json"))
    doc = export_chrome_trace(rec, path=str(out_dir / "offline_tp1.json"))
    problems = validate_chrome_trace(doc)
    weave = weave_counts_from_trace(rec)
    if problems or weave != (st.weave_forwards, st.forwards):
        raise AssertionError(f"offline trace: {problems[:5]}, weave "
                             f"counts {weave} vs {st.weave_forwards}, "
                             f"{st.forwards}")
    emit({"phase": "online_calibrate", "model": cfg.name, "tp": 1,
          "comm_mode": "fused", "layers": n_layers,
          "prompt_lens": [len(p) for p in prompts],
          "new_tokens": ONLINE_NEW, "steps": st.steps,
          "forwards": st.forwards, "weave_forwards": st.weave_forwards,
          "samples": len(prof.samples),
          "steady_samples": len(prof.steady_samples()),
          "measured_ms": measured_ms(prof),
          "wall_s": {"profiled_traced": wall_prof, **walls},
          "profiler_ms_per_step": (sum(walls["profiled"])
                                   - sum(walls["plain"])) / 2 * 1e3
          / st.steps, "fence_us_idle_card": fence_us,
          "calibration": calibration_row(report),
          "calibration_json": str(out_dir / "calibration_tp1.json"),
          "trace": str(out_dir / "offline_tp1.json"),
          "trace_events": len(doc["traceEvents"]),
          "trace_problems": len(problems),
          "trace_weave_forwards": list(weave), "param_init_s": init_s})
    del eng

    # (b) online at tp=1 on the calibrated clock; the same traffic on a
    # small float32 model holds the online tokens to the offline ones
    cost = StepCost.from_calibration(report)
    eng = Engine(api, params, scfg, obs=TraceRecorder())
    # K3's inputs at each shape this run gives it (copied on the card,
    # moved to the host after the run), held against the plain version
    k3_inputs: dict = {}
    undo = capture_k3_inputs(k3_inputs)
    try:
        row, reqs = serve_online(torch, eng, prompts, ONLINE_NEW, cost,
                                 seed, trace_path=out_dir / "online_tp1.json",
                                 **kw)
    finally:
        undo()
    offload(k3_inputs)
    matched = {r.rid: sum(a == b for a, b in zip(r.output, offline[r.rid]))
               for r in reqs if r.finish_reason == "stop"}
    emit({"phase": "online", "model": cfg.name, "tp": 1,
          "comm_mode": "fused", "layers": n_layers, **row,
          "tokens_matched_offline": matched, "new_tokens": ONLINE_NEW})
    del eng, params
    k3_err = check_main_path_k3(torch, k3_inputs, "online", 1)
    online_identity(torch, np, seed, total,
                    trace_path=out_dir / "online_identity.json")

    # (c) tp=8 ring, profiled against plain
    cfg8, api8, params8, _, _, _ = full_width_model(
        torch, np, seed, tp=8, comm_mode="ring", n_layers=n_layers)
    kw8 = dict(kw, norm_kernel="ar_rmsnorm")
    prompts8 = prompts[:ONLINE_TP8_N]
    prof8 = WallClockProfiler()
    runs = {}
    for name, prof_ in (("profiled", prof8), ("plain", None),
                        ("profiled_again", prof8)):
        eng8 = Engine(api8, params8, scfg, profiler=prof_)
        first = len(prof8.samples)
        timed_api = eng8.api = EventTimedSteps(torch, api8)
        toks, wall = serve_counted(torch, eng8, Request, prompts8,
                                   ONLINE_TP8_NEW, **kw8)
        runs[name] = (toks, wall, eng8.stats.steps)
    if len({repr((t, n)) for t, _, n in runs.values()}) != 1:
        raise AssertionError("tp=8 profiled runs differ from the plain one")
    report8 = fit_calibration(cfg8, prof8.steady_samples(), tp=8,
                              tile=api8.pcfg.split_unit_for(8),
                              model=cfg8.name)
    report8.save(str(out_dir / "calibration_tp8.json"))
    # the woven prefill-bearing forwards of the last run (past their
    # warm-up): each one's fenced wall against its model call's CUDA-event
    # time, taken in the same dispatch
    torch.cuda.synchronize()
    woven = [(i, smp.wall_s * 1e3,
              timed_api.events[i][0].elapsed_time(timed_api.events[i][1]))
             for i, smp in enumerate(prof8.samples[first:])
             if smp.weave and smp.tokens_real > ONLINE_TP8_N]
    if not woven:
        raise AssertionError("no woven prefill at tp=8")
    emit({"phase": "online_tp8", "model": cfg8.name, "tp": 8,
          "comm_mode": "ring", "layers": n_layers,
          "requests": ONLINE_TP8_N, "new_tokens": ONLINE_TP8_NEW,
          "steps": eng8.stats.steps, "forwards": eng8.stats.forwards,
          "weave_forwards": eng8.stats.weave_forwards,
          "measured_ms": measured_ms(prof8),
          "wall_s": {name: wall for name, (_, wall, _) in runs.items()},
          "calibration": calibration_row(report8),
          "calibration_json": str(out_dir / "calibration_tp8.json"),
          "fence_check": [
              {"forward": i, "tokens": prof8.samples[first + i].tokens_static,
               "split": prof8.samples[first + i].split,
               "measured_ms": meas, "event_ms": ev}
              for i, meas, ev in woven]})
    for i, meas, ev in woven:
        if not meas >= ev:
            raise AssertionError(f"forward {i}: measured {meas} ms < "
                                 f"CUDA-event {ev} ms: the fence missed work")
    del eng8, timed_api, params8
    torch.cuda.empty_cache()
    emit({"phase": "online_launches", "launches": total})
    return total, k3_err


# --------------------------------------------------------------------------
# the cluster: disaggregated KV handoff, the wire, sockets and HTTP
# --------------------------------------------------------------------------

CLUSTER_SMALL_N, CLUSTER_SMALL_NEW = 8, 6
CLUSTER_KILL_AT = 4.0              # virtual time: r0 then owns decodes
SOCKET_DIE_AFTER = 4               # the socket replica's steps before exit
SERVER_TIMEOUT_S = 300


def same_bits(torch, a, b) -> bool:
    """Same dtype, shape and bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


class HandoffTimes:
    """Per KV handoff of a disaggregated cluster (by rid): its committed
    tokens, payload bytes and frame bytes, and the ms of its extract
    (device -> host, in the prefill engine's park), encode and decode (the
    loopback wire) and implant (host -> device, in the decode engine's
    adoption), each fenced with ``torch.cuda.synchronize()``.  Keeps the
    first payload for the round trip."""

    def __init__(self, torch, engines):
        from repro_torch.runtime import paging as PG
        from repro_torch.runtime import transport as TR
        self.torch, self.PG, self.TR = torch, PG, TR
        self.rows: dict = {}
        self.first_payload = None
        self._req = None           # the request whose park/adoption runs
        self.orig = [(PG, "extract_blocks", PG.extract_blocks),
                     (PG, "implant_blocks", PG.implant_blocks),
                     (TR, "encode_frame", TR.encode_frame),
                     (TR, "decode_frame", TR.decode_frame)]
        PG.extract_blocks = self._extract
        PG.implant_blocks = self._implant
        TR.encode_frame = self._encode
        TR.decode_frame = self._decode
        for eng in engines:
            eng._park_for_handoff = self._owner(
                eng._park_for_handoff, lambda r: r)
            eng.adopt_request = self._owner(
                eng.adopt_request, lambda req, *a: req)

    def undo(self):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)

    def _owner(self, fn, req_of):
        def run(*args):
            self._req = req_of(*args)
            return fn(*args)
        return run

    def _timed(self, fn, *args, **kw):
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        self.torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def _row(self, rid):
        return self.rows.setdefault(rid, {"rid": rid})

    def _extract(self, pool, ids, **kw):
        out, ms = self._timed(self.orig[0][2], pool, ids, **kw)
        row = self._row(self._req.rid)
        row.update(n_tokens=self._req.prefill_pos, blocks=len(ids),
                   payload_nbytes=self.PG.payload_nbytes(out),
                   extract_ms=ms)
        if self.first_payload is None:
            self.first_payload = out
        return out

    def _implant(self, pool, payload, ids):
        out, ms = self._timed(self.orig[1][2], pool, payload, ids)
        self._row(self._req.rid).update(implant_ms=ms,
                                        implanted_blocks=len(ids))
        return out

    def _encode(self, kind, obj):
        out, ms = self._timed(self.orig[2][2], kind, obj)
        if kind == "handoff":
            self._row(obj["req"]["rid"]).update(encode_ms=ms,
                                                frame_bytes=len(out))
        return out

    def _decode(self, buf):
        (kind, obj), ms = self._timed(self.orig[3][2], buf)
        if kind == "handoff":
            self._row(obj["req"]["rid"])["decode_ms"] = ms
        return kind, obj


def cluster_phase(torch, np, seed: int, *, tp: int, comm_mode: str,
                  n_layers: int = 4):
    """The engine phases' 4 requests through a disaggregated cluster at
    Llama-3.3-70B width (4 layers, bf16): one prefill replica and one
    decode replica over the paged pool, sharing one params object, every
    arrival envelope and KV payload through the loopback wire.  One
    ``cluster_handoff`` line per handoff; gates: every request migrated
    once, both pools quiescent, launches equal their formula, and one
    payload taken through extract -> frame -> decode -> implant into fresh
    blocks -> extract comes back bit-identical in bf16.  The tokens are
    compared with a single paged engine's and reported, not gated (the
    decode replica runs other GEMM shapes).  Returns (launches, K3's max
    error on the run's inputs, peak GB)."""
    from repro_torch.runtime import cluster as CL
    from repro_torch.runtime import paging as PG
    from repro_torch.runtime import transport as TR
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, prompts, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode, n_layers=n_layers)
    scfg = SchedulerConfig(paged=True)
    engines = [Engine(api, params, scfg) for _ in range(2)]
    reps = [CL.Replica("p0", engines[0], role="prefill"),
            CL.Replica("d0", engines[1], role="decode")]
    cs = CL.ClusterServer(reps, CL.ClusterConfig(router="round_robin",
                                                 wire="loopback"))
    for i, p in enumerate(prompts):
        cs.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    k3_inputs = {}
    times = HandoffTimes(torch, engines)
    undo = capture_k3_inputs(k3_inputs)
    try:
        run_start_gb = reset_peak(torch)
        reset_launches()
        t0 = time.perf_counter()
        done = cs.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        undo()
        times.undo()
    offload(k3_inputs)
    peak = torch.cuda.max_memory_allocated() / 1e9

    check_outputs(done, len(prompts), cfg.vocab_size, NEW_TOKENS)
    if (any(r.migrations != 1 for r in done)
            or cs.summary()["migrations"] != len(prompts)
            or sorted(times.rows) != list(range(len(prompts)))):
        raise AssertionError(f"tp={tp}: migrations "
                             f"{[r.migrations for r in done]}, handoffs "
                             f"{sorted(times.rows)}")
    cs.check_quiescent()
    pf = engines[0].metrics.get("engine/site_forwards", site="prefill")
    pw = engines[0].metrics.get("engine/site_weave", site="prefill")
    splits = sum(e.stats.forwards + e.stats.weave_forwards for e in engines)
    want = {"ar_rmsnorm": 0, "fused_residual_rmsnorm": 0,
            "flash_attention": (pf.value + (pw.value if pw else 0))
            * n_layers}
    want[norm_kernel] = splits * (1 + 2 * n_layers)
    if launches != want or 0 in (launches[norm_kernel],
                                 launches["flash_attention"]):
        raise AssertionError(f"tp={tp}: launches {launches}, expected "
                             f"{want}")
    for rid in sorted(times.rows):
        emit({"phase": "cluster_handoff", "tp": tp, **times.rows[rid]})

    # one payload, framed, decoded, implanted into fresh blocks of the
    # decode pool and extracted again: the same bits
    payload = times.first_payload
    frame = TR.encode_frame("handoff", payload)
    _, got = TR.decode_frame(frame)
    dec = engines[1]
    mgr = dec.block_mgr
    n = times.rows[0]["blocks"]
    ids = [mgr.alloc.alloc() for _ in range(n)]
    PG.implant_blocks(dec.cache, got, ids)
    back = PG.extract_blocks(dec.cache, ids, stacked=dec._stacked_payload)
    for b in ids:
        mgr.alloc.decref(b, cached=False)
    if list(back) != list(payload) or not all(
            same_bits(torch, back[k], payload[k]) for k in payload) \
            or payload["k"].dtype != torch.bfloat16:
        raise AssertionError(f"tp={tp}: the payload's round trip changed "
                             f"its bits")
    emit({"phase": "cluster_roundtrip", "tp": tp, "blocks": n,
          "payload_nbytes": PG.payload_nbytes(payload),
          "frame_bytes": len(frame), "dtype": "bfloat16",
          "bit_identical": True})

    # the same requests through one paged engine: tokens reported
    single = Engine(api, params, scfg)
    for i, p in enumerate(prompts):
        single.add_request(Request(rid=i, prompt=p,
                                   max_new_tokens=NEW_TOKENS))
    ref = {r.rid: r.output for r in single.run()}
    out = {r.rid: r.output for r in done}
    same = [sum(a == b for a, b in zip(out[i], ref[i])) for i in sorted(ref)]
    rows = times.rows.values()
    emit({"phase": "cluster", "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "layers": n_layers, "dtype": cfg.dtype,
          "replicas": {"p0": "prefill", "d0": "decode"}, "wire": "loopback",
          "prompt_lens": list(PROMPT_LENS), "new_tokens": NEW_TOKENS,
          "migrations": cs.summary()["migrations"],
          "wire_frames": cs.wire.frames, "wire_bytes": cs.wire.bytes,
          "launches": launches, "expected_launches": want,
          "param_init_s": init_s, "wall_s": wall_s,
          "handoff_ms": {k: sum(r[k] for r in rows) for k in (
              "extract_ms", "encode_ms", "decode_ms", "implant_ms")},
          "tokens_matching_single": same,
          "requests_matching_single": sum(s == NEW_TOKENS for s in same),
          "allocated_at_start_gb": start_gb,
          "allocated_at_run_start_gb": run_start_gb,
          "max_memory_allocated_gb": peak})
    del cs, reps, engines, dec, single, params, payload, got, back
    times.first_payload = None
    torch.cuda.empty_cache()
    return launches, check_main_path_k3(torch, k3_inputs, "cluster", tp), peak


def small_spec(seed: int) -> dict:
    """The identity checks' small float32 model as a server spec (the
    kernels on: ``attn_impl="pallas"``, ``use_pallas_norm``), paged."""
    return {"model": {"name": "small", "family": "dense", "num_layers": 2,
                      "d_model": 256, "num_heads": 8, "num_kv_heads": 2,
                      "head_dim": 32, "d_ff": 512, "vocab_size": 512,
                      "dtype": "float32"},
            "parallel": {"comm_mode": "fused", "attn_impl": "pallas",
                         "use_pallas_norm": True, "split_unit": 16,
                         "tokenweave_min_tokens": 32},
            "scheduler": {"max_batch": 4, "chunk_tokens": 64,
                          "max_len": 128, "prefill_bucket": 16,
                          "paged": True, "block_size": 16},
            "seed": seed}


def start_server(module: str, spec: dict, log: Path, *args):
    """``python -m <module> --port 0 --spec <spec>`` on the card (no
    device in the spec), from src/ with no PYTHONPATH, its stderr to
    ``log``."""
    import os
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    log.parent.mkdir(parents=True, exist_ok=True)
    err = open(log, "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", module, "--port", "0", "--spec",
             json.dumps(spec), *args], cwd=SRC, env=env,
            stdout=subprocess.PIPE, stderr=err, text=True), err
    except BaseException:
        err.close()
        raise


def listening(proc, log: Path):
    """(host, port) from the server's ``LISTENING`` line, waiting at most
    SERVER_TIMEOUT_S; raises with its log when it exits or hangs."""
    import select
    ready, _, _ = select.select([proc.stdout], [], [], SERVER_TIMEOUT_S)
    line = proc.stdout.readline() if ready else ""
    if not line.startswith("LISTENING"):
        raise AssertionError(f"server {proc.args[2]} did not start: "
                             f"{line!r} {log.read_text()[-3000:]}")
    _, host, port = line.split()
    return host, int(port)


def sse_tokens(host: str, port: int, body: dict) -> list:
    """One streamed completion over a raw socket: its tokens, in order."""
    import socket
    payload = json.dumps({**body, "stream": True}).encode("utf-8")
    with socket.create_connection((host, port),
                                  timeout=SERVER_TIMEOUT_S) as s:
        s.sendall((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                   f"Content-Type: application/json\r\n"
                   f"Content-Length: {len(payload)}\r\n\r\n"
                   ).encode("ascii") + payload)
        with s.makefile("rb") as f:
            if b"200" not in f.readline():
                raise AssertionError("the completion was refused")
            toks, done = [], False
            for line in f:
                if not line.startswith(b"data: "):
                    continue
                data = line[6:].strip()
                if data == b"[DONE]":
                    break
                ev = json.loads(data)
                if "token" in ev:
                    toks.append(ev["token"])
                done = done or bool(ev.get("done"))
    if not done:
        raise AssertionError("the stream ended without its done event")
    return toks


def http_stats(host: str, port: int) -> dict:
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=SERVER_TIMEOUT_S)
    try:
        conn.request("GET", "/v1/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def cluster_small_phase(torch, np, seed: int):
    """The small float32 model (TF32 off) on the card, every engine built
    by ``build_engine_from_spec`` (CUDA by default): 8 requests with
    Poisson arrivals through a two-replica cluster under each router, the
    disaggregated loopback cluster, and a kill of replica r0 mid-decode
    followed by the requeue; then ``python -m
    repro_torch.runtime.transport`` as a socket replica beside a local
    one, hard-killed after a few steps, and ``python -m
    repro_torch.runtime.http_api`` streaming one SSE completion.  Every
    run's tokens must equal one offline engine's (gate); pools drained;
    the in-process runs launched K2 and K3.  The servers start first and
    boot while the in-process runs go."""
    from repro_torch.runtime import cluster as CL
    from repro_torch.runtime import transport as TR
    from repro_torch.runtime.requests import Request, poisson_arrivals

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = small_spec(seed)
    logs = ROOT / "build" / "servers"
    procs, files = [], []
    try:
        for module, args in (("repro_torch.runtime.transport",
                              ("--name", "w0")),
                             ("repro_torch.runtime.http_api", ())):
            proc, err = start_server(module, spec,
                                     logs / f"{module.split('.')[-1]}.log",
                                     *args)
            procs.append(proc)
            files.append(err)

        rng = np.random.RandomState(seed + 31)
        prompts = [rng.randint(0, 512, int(n)).tolist()
                   for n in rng.randint(5, 100, size=CLUSTER_SMALL_N)]

        def trace():
            return poisson_arrivals(
                [Request(rid=i, prompt=list(p),
                         max_new_tokens=CLUSTER_SMALL_NEW)
                 for i, p in enumerate(prompts)], rate=0.5, seed=seed)

        reset_launches()
        single = TR.build_engine_from_spec(spec)
        if single.device.type != "cuda":
            raise AssertionError(f"the spec's engine is on {single.device}")
        for r in trace():
            single.add_request(r)
        want = {r.rid: r.output for r in single.run()}

        def serve(name, replicas, cfg, kill=None):
            cs = CL.ClusterServer(replicas, cfg)
            for r in trace():
                cs.submit(r)
            if kill is not None:
                cs.kill_replica(*kill)
            got = {r.rid: r.output for r in cs.run()}
            if got != want:
                raise AssertionError(f"cluster {name}: tokens {got} != "
                                     f"the single engine's {want}")
            cs.check_quiescent()
            row = {"phase": "cluster_small", "run": name,
                   "requests": len(got), "tokens_identical": True,
                   "migrations": cs.summary()["migrations"],
                   "replica_deaths": cs.stats.replica_deaths,
                   "requeued": cs.stats.requeued}
            emit(row)
            return row

        def local(role="mixed", name="r"):
            return CL.Replica(name, TR.build_engine_from_spec(spec),
                              role=role)

        for router in sorted(CL.ROUTERS):
            serve(f"router={router}", [local(name="r0"), local(name="r1")],
                  CL.ClusterConfig(router=router))
        row = serve("disagg_loopback",
                    [local("prefill", "p0"), local("decode", "d0")],
                    CL.ClusterConfig(wire="loopback"))
        if row["migrations"] != CLUSTER_SMALL_N:
            raise AssertionError(f"disaggregated: {row}")
        row = serve("kill_requeue", [local(name="r0"), local(name="r1")],
                    CL.ClusterConfig(), kill=("r0", CLUSTER_KILL_AT))
        if row["replica_deaths"] != 1 or not row["requeued"]:
            raise AssertionError(f"kill: {row}")
        torch.cuda.synchronize()
        launches = read_launches()
        if 0 in (launches["fused_residual_rmsnorm"],
                 launches["flash_attention"]):
            raise AssertionError(f"small clusters: launches {launches}")
        emit({"phase": "cluster_small_launches", "launches": launches})

        # a socket replica (its own process, CUDA by default) beside a
        # local one, hard-killed after SOCKET_DIE_AFTER steps
        host, port = listening(procs[0], logs / "transport.log")
        remote = TR.RemoteEngine(host, port, name="w0",
                                 timeout=SERVER_TIMEOUT_S)
        try:
            remote.die_after(SOCKET_DIE_AFTER)
            cs_row = serve("socket_kill",
                           [CL.Replica("w0", remote), local(name="r1")],
                           CL.ClusterConfig())
        finally:
            remote.close()
        code = procs[0].wait(timeout=SERVER_TIMEOUT_S)
        if code != 17 or cs_row["replica_deaths"] != 1:
            raise AssertionError(f"socket replica exit {code}, {cs_row}")

        # the HTTP API (its own process, CUDA by default): one SSE stream
        host, port = listening(procs[1], logs / "http_api.log")
        toks = sse_tokens(host, port, {"prompt": prompts[0],
                                       "max_new_tokens": CLUSTER_SMALL_NEW})
        stats = http_stats(host, port)
        if toks != want[0] or stats["leaked_blocks"] or stats["tables"]:
            raise AssertionError(f"http: tokens {toks} != {want[0]}, "
                                 f"stats {stats}")
        emit({"phase": "cluster_http", "tokens_identical": True,
              "tokens": len(toks), "stats": stats})
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
            proc.stdout.close()
        for f in files:
            f.close()


# --------------------------------------------------------------------------
# the ssm and hybrid families at full width: Falcon-Mamba-7B through the
# engine, Zamba2-7B through direct prefill and decode calls
# --------------------------------------------------------------------------

SSM_LAYERS = 64                    # all of Falcon-Mamba-7B's
HYBRID_LAYERS = 81                 # all of Zamba2-7B's (13 shared calls)
HYBRID_ROWS, HYBRID_CHUNK = 4, 512  # two chunks of 4 x 512 tokens


def ssm_ranges() -> dict:
    """The SSM layers' named ranges (label -> range) for
    ``device_breakdown``."""
    from repro_torch.layers import ssm
    return dict(ssm.RANGES)


def norm_launches(api, b: int, s: int, *, decode: bool, slots: int) -> int:
    """The add+norm kernel launches of one (b, s) forward: per split one
    entry norm and one slot per block (``slots``: layers, plus the
    hybrid's shared-block calls), once per data shard when the batch is
    over D (K1 runs per shard); none when a shard's tokens do not divide
    over the ranks, where ``comm_norm`` takes the reference's vanilla
    fallback (a 4-row decode, an exact 700-token ssm chunk at tp=8)."""
    from repro_torch.models import transformer as TR
    b_loc, shards = TR.data_layout(b, api.ep, api.pcfg)
    if TR._comm_ctx(api.pcfg, api.cfg, b_loc * s, api.tp).mode == "vanilla":
        return 0
    return shards * (1 + TR.weave_decision_info(
        b_loc, s, tp=api.tp, pcfg=api.pcfg, decode=decode).weave) * (
        1 + slots)


def recurrent_launches(norm: int, *, norm_kernel: str, k3: int = 0) -> dict:
    """What a run launches: ``norm`` add+norm kernels of the mode's kind,
    K3 ``k3`` times."""
    want = {"ar_rmsnorm": 0, "fused_residual_rmsnorm": 0,
            "flash_attention": k3}
    want[norm_kernel] = norm
    return want


def engine_ssm_phase(torch, np, seed: int, trace_dir: Path, *, tp: int,
                     comm_mode: str):
    """Falcon-Mamba-7B at full width and depth (bf16, random weights from
    the seed) serves the engine phases' 4 requests through the two-
    dispatch engine over legacy slots: K2 (``fused``) or K1 (``ring``)
    launches equal splits·(1+L), K3 none; request 0's first token equals
    the argmax of a direct prefill of its prompt (the engine prefills it
    alone, one exact chunk); one traced prefill and one traced decode
    call split by the SSM layer's ranges.  Returns (launches, 0.0, peak
    GB)."""
    from repro_torch.configs import get_config
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    t_phase = time.perf_counter()
    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, prompts, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode, n_layers=SSM_LAYERS,
        config=get_config("falcon-mamba-7b"))
    n0 = PROMPT_LENS[0]
    tokens = torch.tensor([prompts[0]], device="cuda")
    with torch.no_grad():
        logits, _ = api.prefill(params, tokens,
                                api.init_cache(1, 1, device="cuda"), None)
    v_loc = params["embedding"]["embed"].shape[1]
    if logits.shape != (tp, 1, 1, v_loc) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"not finite / wrong shape")
    first_tok = int(sharded_argmax(logits, vocab_size=cfg.vocab_size)[0, 0])
    del logits

    eng = Engine(api, params, SchedulerConfig())
    times = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t) * 1e3)
        return run

    eng._run_prefill = timed("prefill", eng._run_prefill)
    eng._run_decode = timed("decode", eng._run_decode)
    note, shapes = eng._note_forward, []

    def noted(b, s, n_real, **kw):
        shapes.append((b, s, kw.get("decode", False)))
        return note(b, s, n_real, **kw)
    eng._note_forward = noted
    for i, p in enumerate(prompts):
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    run_start_gb = reset_peak(torch)
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9

    check_outputs(done, len(prompts), cfg.vocab_size, NEW_TOKENS)
    out0 = next(r for r in done if r.rid == 0).output[0]
    if out0 != first_tok:
        raise AssertionError(f"engine's first token {out0} != direct "
                             f"prefill argmax {first_tok}")
    st = eng.stats
    want = recurrent_launches(
        sum(norm_launches(api, b, s_, decode=dec, slots=SSM_LAYERS)
            for b, s_, dec in shapes), norm_kernel=norm_kernel)
    if launches != want or not launches[norm_kernel]:
        raise AssertionError(f"launches {launches}, expected {want}")
    emit({"phase": "engine_ssm", "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "layers": SSM_LAYERS,
          "d_model": cfg.d_model, "d_inner": cfg.d_inner,
          "ssm_state": cfg.ssm_state, "dtype": cfg.dtype,
          "prompt_lens": list(PROMPT_LENS), "new_tokens": NEW_TOKENS,
          "forwards": st.forwards, "weave_forwards": st.weave_forwards,
          "prefill_chunks": [s_ for _, s_, dec in shapes if not dec],
          "launches": launches, "expected_launches": want,
          "param_init_s": init_s, "wall_s": wall_s,
          "prefill_ms": times["prefill"], "decode_ms": times["decode"],
          "prefill_ms_median": statistics.median(times["prefill"]),
          "decode_ms_median": statistics.median(times["decode"]),
          "allocated_at_start_gb": start_gb,
          "allocated_at_run_start_gb": run_start_gb,
          "max_memory_allocated_gb": peak})

    # where a step's time goes: request 0's prefill, one decode step over
    # the 8 slots (4 of them finished requests' rows), warm after the run
    dtok = torch.zeros(eng.scfg.max_batch, 1, dtype=torch.long,
                       device="cuda")
    with torch.no_grad():
        for step, fn in (
                ("prefill", lambda: api.prefill(
                    params, tokens, api.init_cache(1, 1, device="cuda"),
                    None)),
                ("decode", lambda: api.decode_step(params, dtok, eng.cache,
                                                   None))):
            trace = trace_dir / f"engine_ssm_tp{tp}_{step}_trace.json"
            brk = device_breakdown(torch, fn, trace, ranges=ssm_ranges())
            if tp > 1 and step == "prefill" and not brk["k1_launches"]:
                raise AssertionError("no K1 kernel in the traced prefill")
            emit({"phase": "breakdown", "engine": "engine_ssm", "tp": tp,
                  "step": step, "tokens":
                  n0 if step == "prefill" else eng.scfg.max_batch, **brk})
    del eng, params
    torch.cuda.empty_cache()
    emit({"phase": "engine_ssm_seconds", "tp": tp,
          "seconds": time.perf_counter() - t_phase})
    return launches, 0.0, peak


def hybrid_phase(torch, np, seed: int, trace_dir: Path, *, tp: int,
                 comm_mode: str):
    """Zamba2-7B at full width and depth (bf16, random weights from the
    seed) through ``ModelApi``: 4 rows, two 512-token prefill chunks
    through the cache (the second attends the first's shared KV, which
    ``kv_cache.insert_chunk`` wrote, and resumes its SSD state), then
    NEW_TOKENS greedy decode steps.  K3 runs 13 times per split of each
    chunk (the shared block's prefill at head dim 224), K2 or K1
    splits·(1 + 81 + 13) times per forward; K3 is held on the inputs the
    run gave it; one traced prefill chunk and one traced decode step split
    by the SSM ranges.  Returns (launches, K3's max error on the run's
    inputs, peak GB)."""
    from repro_torch.configs import get_config
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.models import transformer as TR
    from repro_torch.runtime import kv_cache as KC

    t_phase = time.perf_counter()
    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, _, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode,
        n_layers=HYBRID_LAYERS, config=get_config("zamba2-7b"))
    n_inv = cfg.num_layers // cfg.shared_attn_period
    b, chunk = HYBRID_ROWS, HYBRID_CHUNK
    max_len = 2 * chunk + NEW_TOKENS
    cache = api.init_cache(b, max_len, device="cuda")
    rng = np.random.RandomState(seed + 19)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (b, 2 * chunk))).to("cuda")
    rows = torch.arange(b, device="cuda")
    v_loc = params["embedding"]["embed"].shape[1]
    times = {"prefill": [], "decode": []}
    k3_inputs, splits, outs = {}, [], []

    def prefill(c):
        pos = torch.arange(c * chunk, (c + 1) * chunk, dtype=torch.int32,
                           device="cuda")[None].repeat(b, 1)
        logits, out = api.prefill(params, tokens[:, c * chunk:
                                                 (c + 1) * chunk],
                                  cache, pos)
        return logits, out

    undo = capture_k3_inputs(k3_inputs)
    try:
        run_start_gb = reset_peak(torch)
        reset_launches()
        with torch.no_grad():
            for c in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, out = prefill(c)
                KC.insert_chunk(cache["shared"], out["shared"],
                                torch.full((b,), c * chunk, device="cuda"),
                                rows)
                torch.cuda.synchronize()
                times["prefill"].append((time.perf_counter() - t) * 1e3)
                offload(k3_inputs)
                splits.append(1 + TR.weave_decision_info(
                    b, chunk, tp=tp, pcfg=api.pcfg).weave)
                if logits.shape != (tp, b, 1, v_loc) or \
                        not bool(torch.isfinite(logits).all()):
                    raise AssertionError(f"chunk {c}: logits "
                                         f"{tuple(logits.shape)} not finite"
                                         f" / wrong shape")
            tok = sharded_argmax(logits, vocab_size=cfg.vocab_size)
            for step in range(NEW_TOKENS):
                outs.append(tok[:, 0].tolist())
                pos = torch.full((b, 1), 2 * chunk + step, dtype=torch.int32,
                                 device="cuda")
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, cache = api.decode_step(params, tok, cache, pos)
                tok = sharded_argmax(logits, vocab_size=cfg.vocab_size)
                torch.cuda.synchronize()
                times["decode"].append((time.perf_counter() - t) * 1e3)
        launches = read_launches()
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(0 <= t < cfg.vocab_size for row in outs for t in row) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"decode tokens {outs} or logits out of range")
    slots = cfg.num_layers + n_inv
    want = recurrent_launches(
        2 * norm_launches(api, b, chunk, decode=False, slots=slots)
        + NEW_TOKENS * norm_launches(api, b, 1, decode=True, slots=slots),
        norm_kernel=norm_kernel, k3=n_inv * sum(splits))
    if launches != want or not launches[norm_kernel]:
        raise AssertionError(f"launches {launches}, expected {want}")
    emit({"phase": "hybrid", "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "layers": HYBRID_LAYERS,
          "shared_invocations": n_inv, "d_model": cfg.d_model,
          "shared_head_dim": 2 * cfg.d_model // cfg.num_heads,
          "ssm_heads": cfg.ssm_heads, "ssm_state": cfg.ssm_state,
          "dtype": cfg.dtype, "rows": b, "chunk": chunk,
          "prefill_splits": splits, "decode_steps": NEW_TOKENS,
          "launches": launches, "expected_launches": want,
          "param_init_s": init_s, "prefill_ms": times["prefill"],
          "decode_ms": times["decode"],
          "decode_ms_median": statistics.median(times["decode"]),
          "tokens_row0": [row[0] for row in outs],
          "allocated_at_start_gb": start_gb,
          "allocated_at_run_start_gb": run_start_gb,
          "max_memory_allocated_gb": peak})

    # where a chunk's time goes: the second chunk again (its SSD state
    # and KV are rewritten, which no later check reads), and one decode
    # step
    pos = torch.full((b, 1), max_len - 1, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        for step, fn in (("prefill", lambda: prefill(1)),
                         ("decode", lambda: api.decode_step(
                             params, tok, cache, pos))):
            trace = trace_dir / f"hybrid_tp{tp}_{step}_trace.json"
            brk = device_breakdown(torch, fn, trace, ranges=ssm_ranges())
            if step == "prefill" and brk["k3_calls"] != n_inv * splits[1]:
                raise AssertionError(f"traced chunk: {brk['k3_calls']} K3 "
                                     f"kernels")
            emit({"phase": "breakdown", "engine": "hybrid", "tp": tp,
                  "step": step,
                  "tokens": b * chunk if step == "prefill" else b, **brk})
    del params, cache, out, logits
    torch.cuda.empty_cache()
    err = check_main_path_k3(torch, k3_inputs, "hybrid", tp)
    emit({"phase": "hybrid_seconds", "tp": tp,
          "seconds": time.perf_counter() - t_phase})
    return launches, err, peak


def to_device(tree, dev):
    """A parameter tree (dicts, lists, tuples, tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [to_device(v, dev) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return tree.to(dev)


def identity_recurrent_phase(torch, np, seed: int, *, tp: int,
                             comm_mode: str):
    """Small float32 ssm and hybrid models on the card (kernels) and on
    the CPU (plain versions): the ssm engine's greedy tokens over slots
    equal, the weave firing; the hybrid's direct calls (two prefill
    chunks of 2 x 32 through the cache, 4 greedy decode steps) give equal
    tokens and logits within IDENTITY_LOGIT_TOL."""
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.models.build import build_model
    from repro_torch.runtime import kv_cache as KC
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    pcfg = ParallelConfig(comm_mode=comm_mode, attn_impl="pallas",
                          use_pallas_norm=True, split_unit=16,
                          tokenweave_min_tokens=32)
    rng = np.random.RandomState(seed + 3)

    # the ssm engine over slots
    cfg = ModelConfig(name="small-ssm", family="ssm", num_layers=2,
                      d_model=256, num_heads=0, num_kv_heads=0, d_ff=0,
                      vocab_size=512, ssm_state=16, ssm_dt_rank=16,
                      dtype="float32")
    api = build_model(cfg, pcfg, tp=tp)
    p_cpu = api.init(seed, device="cpu")
    params = {"cpu": p_cpu, "cuda": to_device(p_cpu, "cuda")}
    prompts = [rng.randint(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.randint(5, 100, size=16)]
    scfg = SchedulerConfig(max_batch=16, chunk_tokens=64, max_len=128,
                           prefill_bucket=16)
    outs, launches, weave = {}, {}, {}
    for dev in ("cuda", "cpu"):
        reset_launches()
        eng = Engine(api, params[dev], scfg, device=dev)
        for i, p in enumerate(prompts):
            eng.add_request(Request(rid=i, prompt=p, max_new_tokens=6))
        outs[dev] = {r.rid: r.output for r in eng.run()}
        torch.cuda.synchronize()
        launches[dev] = read_launches()
        weave[dev] = eng.stats.weave_forwards
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(f"tp={tp} {cfg.name}: cuda tokens "
                             f"{outs['cuda']} != cpu {outs['cpu']}")
    if (not launches["cuda"][norm_kernel]
            or launches["cuda"]["flash_attention"]
            or any(launches["cpu"].values()) or not weave["cuda"]):
        raise AssertionError(f"tp={tp} {cfg.name}: launches {launches}, "
                             f"weave forwards {weave}")
    emit({"phase": "identity_ssm", "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "requests": len(prompts),
          "tokens_identical": True, "weave_forwards": weave["cuda"],
          "cuda_launches": launches["cuda"]})

    # the hybrid by direct calls
    cfg = ModelConfig(name="small-hybrid", family="hybrid", num_layers=4,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=0,
                      vocab_size=512, ssm_state=16, ssm_heads=4,
                      shared_attn_period=2, dtype="float32")
    api = build_model(cfg, pcfg, tp=tp)
    p_cpu = api.init(seed, device="cpu")
    params = {"cpu": p_cpu, "cuda": to_device(p_cpu, "cuda")}
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 64)))
    got, first, launches = {}, {}, {}
    for dev in ("cuda", "cpu"):
        reset_launches()
        cache = api.init_cache(2, 80, device=dev)
        with torch.no_grad():
            for c in range(2):
                pos = torch.arange(32 * c, 32 * (c + 1), dtype=torch.int32,
                                   device=dev)[None].repeat(2, 1)
                logits, out = api.prefill(
                    params[dev], tokens[:, 32 * c:32 * (c + 1)].to(dev),
                    cache, pos)
                KC.insert_chunk(cache["shared"], out["shared"],
                                torch.full((2,), 32 * c, device=dev),
                                torch.arange(2, device=dev))
            first[dev] = logits.cpu()
            tok, got[dev] = sharded_argmax(logits, vocab_size=512), []
            for step in range(4):
                got[dev].append(tok[:, 0].tolist())
                pos = torch.full((2, 1), 64 + step, dtype=torch.int32,
                                 device=dev)
                logits, cache = api.decode_step(params[dev], tok, cache, pos)
                tok = sharded_argmax(logits, vocab_size=512)
        torch.cuda.synchronize()
        launches[dev] = read_launches()
    err = max_err(first["cuda"], first["cpu"])
    if got["cuda"] != got["cpu"] or not err <= IDENTITY_LOGIT_TOL:
        raise AssertionError(f"tp={tp} {cfg.name}: cuda tokens "
                             f"{got['cuda']} != cpu {got['cpu']} or logits "
                             f"differ by {err}")
    if (0 in (launches["cuda"][norm_kernel],
              launches["cuda"]["flash_attention"])
            or any(launches["cpu"].values())):
        raise AssertionError(f"tp={tp} {cfg.name}: launches {launches}")
    emit({"phase": "identity_hybrid", "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "tokens_identical": True,
          "prefill_logits_max_abs_err": err, "tol": IDENTITY_LOGIT_TOL,
          "cuda_launches": launches["cuda"]})


# --------------------------------------------------------------------------
# the vlm and encdec families at full width: Qwen2-VL-7B and Whisper-base
# through direct ModelApi calls
# --------------------------------------------------------------------------

VLM_LAYERS = 28                    # all of Qwen2-VL-7B's
# a 448x448 image: 14-px patches merged 2x2, a 16x16 grid of 256 patch
# embeddings, then 768 text tokens, in each of 4 rows
VLM_ROWS, VLM_GRID, VLM_TEXT, VLM_DECODE = 4, 16, 768, 32
# 16 windows of 30 s (1500 frames), Whisper's 4-token start-of-transcript
# prompt, 64 greedy tokens
WHISPER_ROWS, WHISPER_PROMPT, WHISPER_DECODE = 16, 4, 64


def vlm_inputs(torch, np, seed: int, cfg, b: int, grid: int, n_text: int,
               dev, dtype):
    """Text tokens (B, n_text), patch embeddings (B, grid², d) at 0.02
    scale as the reference's input stub, and M-RoPE ids (B, 3, grid² +
    n_text): patch (i, j) gets (t, h, w) = (0, i, j), text token k gets
    t = h = w = grid + k."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (b, n_text))
    img = 0.02 * rng.randn(b, grid * grid, cfg.d_model).astype(np.float32)
    i, j = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    ids = np.concatenate([np.stack([0 * i.ravel(), i.ravel(), j.ravel()]),
                          np.tile(grid + np.arange(n_text), (3, 1))], axis=1)
    ids = np.tile(ids[None], (b, 1, 1)).astype(np.int32)
    return (torch.from_numpy(tokens).to(dev),
            torch.from_numpy(img).to(dev, dtype),
            torch.from_numpy(ids).to(dev))


def timed_ms(torch, fn):
    """(fn's result, its wall ms between two device syncs)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def vlm_phase(torch, np, seed: int, trace_dir: Path, *, tp: int,
              comm_mode: str):
    """Qwen2-VL-7B at full width and depth (bf16, random weights from the
    seed) through ``ModelApi``: one prefill of 4 rows of 256 patch
    embeddings and 768 text tokens with M-RoPE ids (4096 tokens, the
    weave splitting the sequence), its KV written into a slot cache, then
    VLM_DECODE greedy decode steps at positions 1024 + j and M-RoPE ids
    784 + j.  K3 runs splits·28 times (G 7), K2 or K1 per
    ``norm_launches`` (two slots a layer); K3 is held on the run's
    inputs; one traced prefill and one traced decode step.  Returns
    (launches, K3's max error on the run's inputs, peak GB)."""
    from repro_torch.configs import get_config
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.models import transformer as TR
    from repro_torch.runtime import kv_cache as KC

    t_phase = time.perf_counter()
    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, _, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode, n_layers=VLM_LAYERS,
        config=get_config("qwen2-vl-7b"))
    b, grid, n_text = VLM_ROWS, VLM_GRID, VLM_TEXT
    s = grid * grid + n_text
    tokens, img, ids = vlm_inputs(torch, np, seed + 20, cfg, b, grid,
                                  n_text, "cuda", torch.bfloat16)
    cache = api.init_cache(b, s + VLM_DECODE, device="cuda")
    rows = torch.arange(b, device="cuda")
    v_loc = params["embedding"]["embed"].shape[1]
    decode_ms, outs, k3_inputs = [], [], {}

    def prefill():
        return api.prefill(params, tokens, None, None, mrope_positions=ids,
                           extra_embeds=img)

    def step_ids(j):
        """Decode step j's 1-D positions and M-RoPE ids."""
        return (torch.full((b, 1), s + j, dtype=torch.int32, device="cuda"),
                torch.full((b, 3, 1), grid + n_text + j, dtype=torch.int32,
                           device="cuda"))

    undo = capture_k3_inputs(k3_inputs)
    try:
        run_start_gb = reset_peak(torch)
        reset_launches()
        with torch.no_grad():
            (logits, kv), prefill_ms = timed_ms(torch, prefill)
            KC.insert_chunk(cache, kv, torch.zeros(b, device="cuda"), rows)
            del kv
            offload(k3_inputs)
            if logits.shape != (tp, b, 1, v_loc) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"prefill logits {tuple(logits.shape)}"
                                     f" not finite / wrong shape")
            tok = sharded_argmax(logits, vocab_size=cfg.vocab_size)
            for j in range(VLM_DECODE):
                outs.append(tok[:, 0].tolist())
                pos, mr = step_ids(j)
                (logits, cache), ms = timed_ms(
                    torch, lambda: api.decode_step(params, tok, cache, pos,
                                                   mrope_positions=mr))
                tok = sharded_argmax(logits, vocab_size=cfg.vocab_size)
                decode_ms.append(ms)
        launches = read_launches()
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(0 <= t < cfg.vocab_size for row in outs for t in row) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"decode tokens {outs} or logits out of range")
    splits = 1 + TR.weave_decision_info(b, s, tp=tp, pcfg=api.pcfg).weave
    want = recurrent_launches(
        norm_launches(api, b, s, decode=False, slots=2 * VLM_LAYERS)
        + VLM_DECODE * norm_launches(api, b, 1, decode=True,
                                     slots=2 * VLM_LAYERS),
        norm_kernel=norm_kernel, k3=splits * VLM_LAYERS)
    if launches != want or not launches[norm_kernel]:
        raise AssertionError(f"launches {launches}, expected {want}")
    emit({"phase": "vlm", "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "layers": VLM_LAYERS,
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "mrope_sections":
          list(cfg.mrope_sections), "dtype": cfg.dtype, "rows": b,
          "patches": grid * grid, "text_tokens": n_text,
          "prefill_splits": splits, "decode_steps": VLM_DECODE,
          "launches": launches, "expected_launches": want,
          "param_init_s": init_s, "prefill_ms": prefill_ms,
          "decode_ms": decode_ms,
          "decode_ms_median": statistics.median(decode_ms),
          "tokens_row0": [row[0] for row in outs],
          "allocated_at_start_gb": start_gb,
          "allocated_at_run_start_gb": run_start_gb,
          "max_memory_allocated_gb": peak})

    # where the time goes: the prefill again (its KV is dropped) and one
    # decode step into the cache's last cell
    pos, mr = step_ids(VLM_DECODE - 1)
    with torch.no_grad():
        for step, fn in (("prefill", prefill),
                         ("decode", lambda: api.decode_step(
                             params, tok, cache, pos, mrope_positions=mr))):
            trace = trace_dir / f"vlm_tp{tp}_{step}_trace.json"
            brk = device_breakdown(torch, fn, trace)
            if step == "prefill" and brk["k3_calls"] != splits * VLM_LAYERS:
                raise AssertionError(f"traced prefill: {brk['k3_calls']} K3 "
                                     f"kernels")
            emit({"phase": "breakdown", "engine": "vlm", "tp": tp,
                  "step": step, "tokens": b * s if step == "prefill" else b,
                  **brk})
    del params, cache, logits
    torch.cuda.empty_cache()
    err = check_main_path_k3(torch, k3_inputs, "vlm", tp)
    emit({"phase": "vlm_seconds", "tp": tp,
          "seconds": time.perf_counter() - t_phase})
    return launches, err, peak


def encdec_launches(api, b: int, s_enc: int, prompt: int, steps: int, *,
                    norm_kernel: str) -> dict:
    """What one encdec run launches: the encoder's batch splits each an
    entry norm and two slots a layer, and one K3 call a layer; the
    decoder prompt's splits (``norm_launches``, three slots a layer) and
    one K3 call a layer each; ``steps`` decode steps' slots."""
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as TR
    cfg = api.cfg
    enc_splits = 1 + (ED.encoder_split(b, s_enc, tp=api.tp, pcfg=api.pcfg)
                      is not None)
    enc_norm = (0 if TR._comm_ctx(api.pcfg, cfg, b * s_enc, api.tp).mode
                == "vanilla" else enc_splits * (1 + 2 * cfg.encoder_layers))
    dec_splits = 1 + TR.weave_decision_info(b, prompt, tp=api.tp,
                                            pcfg=api.pcfg).weave
    slots = 3 * cfg.num_layers
    return recurrent_launches(
        enc_norm + norm_launches(api, b, prompt, decode=False, slots=slots)
        + steps * norm_launches(api, b, 1, decode=True, slots=slots),
        norm_kernel=norm_kernel,
        k3=enc_splits * cfg.encoder_layers + dec_splits * cfg.num_layers)


def encdec_phase(torch, np, seed: int, trace_dir: Path, *, tp: int,
                 comm_mode: str):
    """Whisper-base at full width and depth (6 encoder and 6 decoder
    layers, bf16, random weights from the seed) through ``ModelApi``: one
    prefill of 16 rows of 1500 stub frames (the encoder's batch split, K3
    bidirectional) and a 4-token decoder prompt, its self KV and cross
    caches written into the cache, then WHISPER_DECODE greedy decode steps
    over both caches.  Launches equal ``encdec_launches``; K3 is held on
    the run's inputs; ids lie within the unpadded vocabulary (51,865,
    padded to 51,872 at tp=8); one traced prefill and one traced decode
    step; the encoder alone timed after the run.  Returns (launches, K3's
    max error on the run's inputs, peak GB)."""
    from repro_torch.configs import get_config
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.runtime import kv_cache as KC

    t_phase = time.perf_counter()
    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    cfg, api, params, _, init_s, start_gb = full_width_model(
        torch, np, seed, tp=tp, comm_mode=comm_mode,
        n_layers=get_config("whisper-base").num_layers,
        config=get_config("whisper-base"))
    b, s_enc, n = WHISPER_ROWS, cfg.max_source_positions, WHISPER_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    frames = torch.randn(b, s_enc, cfg.d_model, generator=gen,
                         device="cuda").to(getattr(torch, cfg.dtype))
    rng = np.random.RandomState(seed + 21)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, n))
                              ).to("cuda")
    cache = api.init_cache(b, n + WHISPER_DECODE, device="cuda",
                           enc_len=s_enc)
    rows = torch.arange(b, device="cuda")
    v_loc = params["embedding"]["embed"].shape[1]
    decode_ms, outs, k3_inputs = [], [], {}

    def prefill():
        return api.prefill(params, prompt, None, None, frames=frames)

    undo = capture_k3_inputs(k3_inputs)
    try:
        run_start_gb = reset_peak(torch)
        reset_launches()
        with torch.no_grad():
            (logits, out), prefill_ms = timed_ms(torch, prefill)
            KC.insert_chunk(cache["self"], out["self"],
                            torch.zeros(b, device="cuda"), rows)
            KC.write_rows(cache["cross"], out["cross"], rows)
            del out
            offload(k3_inputs)
            if logits.shape != (tp, b, 1, v_loc) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"prefill logits {tuple(logits.shape)}"
                                     f" not finite / wrong shape")
            tok = sharded_argmax(logits, vocab_size=cfg.vocab_size)
            for j in range(WHISPER_DECODE):
                outs.append(tok[:, 0].tolist())
                pos = torch.full((b, 1), n + j, dtype=torch.int32,
                                 device="cuda")
                (logits, cache), ms = timed_ms(
                    torch, lambda: api.decode_step(params, tok, cache, pos))
                tok = sharded_argmax(logits, vocab_size=cfg.vocab_size)
                decode_ms.append(ms)
        launches = read_launches()
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(0 <= t < cfg.vocab_size for row in outs for t in row) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"decode tokens {outs} outside the vocabulary "
                             f"{cfg.vocab_size} or logits not finite")
    want = encdec_launches(api, b, s_enc, n, WHISPER_DECODE,
                           norm_kernel=norm_kernel)
    if launches != want or not launches[norm_kernel]:
        raise AssertionError(f"launches {launches}, expected {want}")
    with torch.no_grad():
        encoder_ms = statistics.median(
            timed_ms(torch, lambda: api.mod.encode(
                params, frames, cfg=cfg, pcfg=api.pcfg))[1]
            for _ in range(3))
    emit({"phase": "encdec", "model": cfg.name, "tp": tp,
          "comm_mode": comm_mode, "encoder_layers": cfg.encoder_layers,
          "decoder_layers": cfg.num_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "vocab_padded": v_loc * tp,
          "dtype": cfg.dtype, "rows": b, "frames": s_enc,
          "prompt_tokens": n, "decode_steps": WHISPER_DECODE,
          "launches": launches, "expected_launches": want,
          "param_init_s": init_s, "encoder_ms": encoder_ms,
          "prefill_ms": prefill_ms, "decode_ms": decode_ms,
          "decode_ms_median": statistics.median(decode_ms),
          "tokens_row0": [row[0] for row in outs],
          "allocated_at_start_gb": start_gb,
          "allocated_at_run_start_gb": run_start_gb,
          "max_memory_allocated_gb": peak})

    pos = torch.full((b, 1), n + WHISPER_DECODE - 1, dtype=torch.int32,
                     device="cuda")
    k3_prefill = want["flash_attention"]
    with torch.no_grad():
        for step, fn in (("prefill", prefill),
                         ("decode", lambda: api.decode_step(params, tok,
                                                            cache, pos))):
            trace = trace_dir / f"encdec_tp{tp}_{step}_trace.json"
            brk = device_breakdown(torch, fn, trace)
            if step == "prefill" and brk["k3_calls"] != k3_prefill:
                raise AssertionError(f"traced prefill: {brk['k3_calls']} K3 "
                                     f"kernels")
            emit({"phase": "breakdown", "engine": "encdec", "tp": tp,
                  "step": step,
                  "tokens": b * (s_enc + n) if step == "prefill" else b,
                  **brk})
    del params, cache, logits, frames
    torch.cuda.empty_cache()
    err = check_main_path_k3(torch, k3_inputs, "encdec", tp)
    emit({"phase": "encdec_seconds", "tp": tp,
          "seconds": time.perf_counter() - t_phase})
    return launches, err, peak


def identity_family_phase(torch, np, seed: int, *, tp: int,
                          comm_mode: str):
    """Small float32 vlm and encdec twins on the card (kernels) and on the
    CPU (plain versions), TF32 off, by direct calls: a vlm prefill of 16
    rows of 16 patch embeddings and 48 text tokens with M-RoPE ids and 4
    greedy decode steps; an encdec prefill of 16 rows of 40 frames and a
    4-token prompt, its caches written, and 4 greedy decode steps.  The
    weaves fire (sequence, encoder batch and decode batch splits); the
    vocabulary, 509, does not divide over 2 ranks.  Greedy tokens equal,
    prefill logits within IDENTITY_LOGIT_TOL."""
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.models.build import build_model
    from repro_torch.runtime import kv_cache as KC

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    norm_kernel = {"fused": "fused_residual_rmsnorm",
                   "ring": "ar_rmsnorm"}[comm_mode]
    pcfg = ParallelConfig(comm_mode=comm_mode, attn_impl="pallas",
                          use_pallas_norm=True, split_unit=16,
                          tokenweave_min_tokens=32)
    rng = np.random.RandomState(seed + 5)
    b, vocab, steps = 16, 509, 4
    small = dict(num_layers=2, d_model=64, num_heads=4, head_dim=16,
                 d_ff=128, vocab_size=vocab, dtype="float32")
    cfgs = {"vlm": ModelConfig(name="small-vlm", family="vlm",
                               num_kv_heads=2, mrope_sections=(2, 3, 3),
                               **small),
            "encdec": ModelConfig(name="small-whisper", family="encdec",
                                  num_kv_heads=4, encoder_layers=2,
                                  act="gelu", learned_positions=True,
                                  max_source_positions=64, **small)}
    tokens, img, ids = vlm_inputs(torch, np, seed + 6, cfgs["vlm"], b, 4, 48,
                                  "cpu", torch.float32)
    frames = torch.from_numpy(rng.randn(b, 40, 64).astype(np.float32))
    prompt = torch.from_numpy(rng.randint(0, vocab, (b, 4)))
    for family, cfg in cfgs.items():
        api = build_model(cfg, pcfg, tp=tp)
        p_cpu = api.init(seed, device="cpu")
        params = {"cpu": p_cpu, "cuda": to_device(p_cpu, "cuda")}
        got, first, launches = {}, {}, {}
        for dev in ("cuda", "cpu"):
            reset_launches()
            rows = torch.arange(b, device=dev)
            with torch.no_grad():
                if family == "vlm":
                    s = ids.shape[2]
                    cache = api.init_cache(b, s + steps, device=dev)
                    logits, kv = api.prefill(
                        params[dev], tokens.to(dev), None, None,
                        mrope_positions=ids.to(dev),
                        extra_embeds=img.to(dev))
                    KC.insert_chunk(cache, kv, torch.zeros(b, device=dev),
                                    rows)
                else:
                    s = prompt.shape[1]
                    cache = api.init_cache(b, s + steps, device=dev,
                                           enc_len=frames.shape[1])
                    logits, out = api.prefill(params[dev], prompt.to(dev),
                                              None, None,
                                              frames=frames.to(dev))
                    KC.insert_chunk(cache["self"], out["self"],
                                    torch.zeros(b, device=dev), rows)
                    KC.write_rows(cache["cross"], out["cross"], rows)
                first[dev] = logits.cpu()
                tok, got[dev] = sharded_argmax(logits, vocab_size=vocab), []
                for j in range(steps):
                    got[dev].append(tok[:, 0].tolist())
                    pos = torch.full((b, 1), s + j, dtype=torch.int32,
                                     device=dev)
                    kw = ({"mrope_positions": torch.full(
                        (b, 3, 1), int(ids.max()) + 1 + j, dtype=torch.int32,
                        device=dev)}
                        if family == "vlm" else {})
                    logits, cache = api.decode_step(params[dev], tok, cache,
                                                    pos, **kw)
                    tok = sharded_argmax(logits, vocab_size=vocab)
            torch.cuda.synchronize()
            launches[dev] = read_launches()
        err = max_err(first["cuda"], first["cpu"])
        if got["cuda"] != got["cpu"] or not err <= IDENTITY_LOGIT_TOL:
            raise AssertionError(f"tp={tp} {cfg.name}: cuda tokens "
                                 f"{got['cuda']} != cpu {got['cpu']} or "
                                 f"logits differ by {err}")
        if not all(0 <= t < vocab for row in got["cuda"] for t in row):
            raise AssertionError(f"tp={tp} {cfg.name}: ids outside the "
                                 f"vocabulary {vocab}")
        if (0 in (launches["cuda"][norm_kernel],
                  launches["cuda"]["flash_attention"])
                or any(launches["cpu"].values())):
            raise AssertionError(f"tp={tp} {cfg.name}: launches {launches}")
        emit({"phase": f"identity_{family}", "model": cfg.name, "tp": tp,
              "comm_mode": comm_mode, "tokens_identical": True,
              "prefill_logits_max_abs_err": err, "tol": IDENTITY_LOGIT_TOL,
              "cuda_launches": launches["cuda"]})


# --------------------------------------------------------------------------
# the data rank axis: Qwen3-MoE-235B's ep2d at D = 2 x R = 4 and Gemma3-1B's
# context-parallel decode over 524,288 positions
# --------------------------------------------------------------------------

QWEN3_LAYERS = 4                   # of 94: 19.3 GB of experts in bf16
EP2D_ROWS, EP2D_LEN, EP2D_DECODE, EP2D_TP = 4, 1024, 16, 4
GEMMA_CONTEXT, CP_DECODE, CP_SHARDS = 524288, 16, 4   # long_500k: one row
CP_FP32_STEPS = 4
CP_FP32_REL_FRO = 1e-3             # float32: summation order only


def qwen3_phases(**kw) -> list:
    """Qwen3-MoE-235B-A22B (``ep2d`` at data size 1: all 128 experts on
    the one data shard, expert d_ff over the ranks) through the two-
    dispatch engine at tp=1 ``fused`` and tp=8 ``ring``; gated as the
    other engine phases (launch formulas, K3 at every shape)."""
    from repro_torch.configs import get_config
    qwen3 = dict(config=get_config("qwen3-moe-235b-a22b"),
                 n_layers=QWEN3_LAYERS, phase="engine_moe_qwen3")
    return [engine_phase(**kw, **qwen3, tp=1, comm_mode="fused"),
            engine_phase(**kw, **qwen3, tp=8, comm_mode="ring")]


def ep2d_run(torch, np, seed: int, trace_dir: Path, *, dp: int):
    """Qwen3-MoE-235B's widths, QWEN3_LAYERS layers, bf16, random weights
    from the seed, at D = ``dp`` data shards x R = EP2D_TP ranks in comm
    mode ``ring``, by direct ``ModelApi`` calls: a prefill of EP2D_ROWS
    rows of EP2D_LEN tokens, the batch over D (the weave cutting each
    data shard's rows), its KV written into a slot cache, then
    EP2D_DECODE greedy decode steps.  Launches: K1 once a slot per data
    shard where a shard's tokens divide over the ranks (a decode of 2
    rows a shard takes the vanilla fallback), K3 splits·L.  Returns
    (launches, K3's max error on the run's inputs, peak GB)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.models import transformer as TR
    from repro_torch.models.build import build_model
    from repro_torch.runtime import kv_cache as KC

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                              num_layers=QWEN3_LAYERS)
    pcfg = ParallelConfig(comm_mode="ring", attn_impl="pallas",
                          use_pallas_norm=True)
    api = build_model(cfg, pcfg, tp=EP2D_TP, ep=dp)
    gc.collect()
    torch.cuda.empty_cache()
    params = api.init(seed, device="cuda")
    b, s = EP2D_ROWS, EP2D_LEN
    rng = np.random.RandomState(seed + 40)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).cuda()
    cache = api.init_cache(b, s + EP2D_DECODE, device="cuda")
    rows = torch.arange(b, device="cuda")
    v_loc = params["embedding"]["embed"].shape[1]
    decode_ms, outs, k3_inputs = [], [], {}
    stats = MoeStats(torch, cfg)

    def prefill():
        return api.prefill(params, tokens, None, None)

    undo = capture_k3_inputs(k3_inputs)
    try:
        run_start_gb = reset_peak(torch)
        reset_launches()
        with torch.no_grad():
            (logits, kv), prefill_ms = timed_ms(torch, prefill)
            stats.step()
            KC.insert_chunk(cache, kv, torch.zeros(b, device="cuda"), rows)
            del kv
            offload(k3_inputs)
            if logits.shape != (EP2D_TP, b, 1, v_loc) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"prefill logits {tuple(logits.shape)}"
                                     f" not finite / wrong shape")
            tok = sharded_argmax(logits, vocab_size=cfg.vocab_size)
            for j in range(EP2D_DECODE):
                outs.append(tok[:, 0].tolist())
                pos = torch.full((b, 1), s + j, dtype=torch.int32,
                                 device="cuda")
                (logits, cache), ms = timed_ms(
                    torch, lambda: api.decode_step(params, tok, cache, pos))
                stats.step()
                tok = sharded_argmax(logits, vocab_size=cfg.vocab_size)
                decode_ms.append(ms)
        launches = read_launches()
    finally:
        undo()
        stats.undo()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(0 <= t < cfg.vocab_size for row in outs for t in row) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"decode tokens {outs} or logits out of range")
    b_loc, _ = TR.data_layout(b, dp, pcfg)
    splits = 1 + TR.weave_decision_info(b_loc, s, tp=EP2D_TP,
                                        pcfg=pcfg).weave
    want = recurrent_launches(
        norm_launches(api, b, s, decode=False, slots=2 * QWEN3_LAYERS)
        + EP2D_DECODE * norm_launches(api, b, 1, decode=True,
                                      slots=2 * QWEN3_LAYERS),
        norm_kernel="ar_rmsnorm", k3=splits * QWEN3_LAYERS)
    if launches != want or not launches["ar_rmsnorm"]:
        raise AssertionError(f"launches {launches}, expected {want}")
    emit({"phase": "ep2d", "model": cfg.name, "data_shards": dp,
          "tp": EP2D_TP, "comm_mode": "ring", "layers": QWEN3_LAYERS,
          "experts_per_shard": cfg.num_experts // dp,
          "expert_d_ff_per_rank": cfg.moe_d_ff // EP2D_TP,
          "rows": b, "rows_per_shard": b_loc, "prompt_len": s,
          "prefill_splits": splits, "decode_steps": EP2D_DECODE,
          "launches": launches, "expected_launches": want,
          "prefill_ms": prefill_ms, "decode_ms": decode_ms,
          "decode_ms_median": statistics.median(decode_ms),
          "tokens_row0": [row[0] for row in outs],
          "allocated_at_run_start_gb": run_start_gb,
          "max_memory_allocated_gb": peak})
    emit({"phase": "moe_forwards", "engine": "ep2d", "data_shards": dp,
          "tp": EP2D_TP, **stats.summary()})

    # where the time goes: the prefill again (its KV is dropped), with
    # the MoE layer's ranges (ep2d: both dispatches and the all-to-alls
    # are in moe_dispatch, the return in moe_combine), and one decode step
    pos = torch.full((b, 1), s + EP2D_DECODE - 1, dtype=torch.int32,
                     device="cuda")
    with torch.no_grad():
        for step, fn in (("prefill", prefill),
                         ("decode", lambda: api.decode_step(params, tok,
                                                            cache, pos))):
            trace = trace_dir / f"ep2d_d{dp}_{step}_trace.json"
            brk = device_breakdown(torch, fn, trace, ranges=moe_ranges(cfg))
            emit({"phase": "breakdown", "engine": "ep2d", "data_shards": dp,
                  "tp": EP2D_TP, "step": step,
                  "tokens": b * s if step == "prefill" else b, **brk})
    del params, cache, logits
    torch.cuda.empty_cache()
    err = check_main_path_k3(torch, k3_inputs, f"ep2d_d{dp}", EP2D_TP)
    emit({"phase": "ep2d_seconds", "data_shards": dp,
          "seconds": time.perf_counter() - t_phase})
    return launches, err, peak


def identity_data_phase(torch, np, seed: int):
    """Small float32 twins on the card (kernels) and on the CPU (plain
    versions), TF32 off, by direct calls: an ``ep2d`` MoE model at D = 2 x
    R = 2 ``ring`` (a prefill of 4 rows of 48 tokens, the batch over D
    and the weave cutting each shard's rows, then 4 greedy decode steps)
    and the reduced Gemma3-1B (sliding and global layers) at D = 4 under
    ``seq_shard_kv`` (8 greedy decode steps of one row from a seeded
    256-slot cache).  Greedy tokens equal, first logits within
    IDENTITY_LOGIT_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.models.build import build_model
    from repro_torch.runtime import kv_cache as KC

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(seed + 7)
    moe = ModelConfig(name="small-moe-ep2d", family="moe", num_layers=2,
                      d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
                      d_ff=512, vocab_size=509, num_experts=4,
                      num_experts_per_tok=2, moe_d_ff=256,
                      moe_partition="ep2d", qk_norm=True, dtype="float32")
    gemma = dataclasses.replace(get_config("gemma3-1b").reduced(),
                                vocab_size=509)
    base = dict(attn_impl="pallas", use_pallas_norm=True, split_unit=16,
                tokenweave_min_tokens=32)
    twins = {"ep2d": (moe, ParallelConfig(comm_mode="ring", **base), 2, 2),
             "cp": (gemma, ParallelConfig(comm_mode="fused",
                                          seq_shard_kv=True, **base), 1, 4)}
    for name, (cfg, pcfg, tp, dp) in twins.items():
        api = build_model(cfg, pcfg, tp=tp, ep=dp)
        p_cpu = api.init(seed, device="cpu")
        params = {"cpu": p_cpu, "cuda": to_device(p_cpu, "cuda")}
        got, first, launches = {}, {}, {}
        if name == "ep2d":
            b, s, steps, c = 4, 48, 4, 64
            prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s)))
        else:
            b, s, steps, c = 1, 200, 8, 256
            seeded = api.init_cache(b, c, device="cpu")
            for layer in seeded:
                cells = layer["pos"].shape[1]
                for n in ("k", "v"):
                    layer[n].copy_(torch.from_numpy(
                        rng.randn(*layer[n].shape).astype(np.float32)))
                p = torch.arange(max(0, s - cells), s, dtype=torch.int32)
                layer["pos"][0, p % cells] = p
            start = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, 1)))
        for dev in ("cuda", "cpu"):
            reset_launches()
            with torch.no_grad():
                if name == "ep2d":
                    cache = api.init_cache(b, c, device=dev)
                    logits, kv = api.prefill(params[dev], prompt.to(dev),
                                             None, None)
                    KC.insert_chunk(cache, kv, torch.zeros(b, device=dev),
                                    torch.arange(b, device=dev))
                    first[dev] = logits.cpu()
                    tok = sharded_argmax(logits, vocab_size=cfg.vocab_size)
                else:
                    cache = to_device(seeded, dev)
                    tok = start.to(dev)
                got[dev] = []
                for j in range(steps):
                    pos = torch.full((b, 1), s + j, dtype=torch.int32,
                                     device=dev)
                    logits, cache = api.decode_step(params[dev], tok, cache,
                                                    pos)
                    if j == 0 and name == "cp":
                        first[dev] = logits.cpu()
                    tok = sharded_argmax(logits, vocab_size=cfg.vocab_size)
                    got[dev].append(tok[:, 0].tolist())
            torch.cuda.synchronize()
            launches[dev] = read_launches()
        err = max_err(first["cuda"], first["cpu"])
        if got["cuda"] != got["cpu"] or not err <= IDENTITY_LOGIT_TOL:
            raise AssertionError(f"identity_{name}: cuda tokens "
                                 f"{got['cuda']} != cpu {got['cpu']} or "
                                 f"logits differ by {err}")
        norm_kernel = ("ar_rmsnorm" if pcfg.comm_mode == "ring"
                       else "fused_residual_rmsnorm")
        if not launches["cuda"][norm_kernel] or any(launches["cpu"].values()):
            raise AssertionError(f"identity_{name}: launches {launches}")
        emit({"phase": f"identity_{name}", "model": cfg.name, "tp": tp,
              "data_shards": dp, "comm_mode": pcfg.comm_mode,
              "seq_shard_kv": pcfg.seq_shard_kv, "tokens_identical": True,
              "tokens": got["cuda"], "first_logits_max_abs_err": err,
              "tol": IDENTITY_LOGIT_TOL, "cuda_launches": launches["cuda"]})


def counted(fn):
    """(fn's result, the kernel launches it made)."""
    before = read_launches()
    out = fn()
    after = read_launches()
    return out, {k: after[k] - before[k] for k in after}


def cp_compare(torch, cfg, seed: int, dtype, steps: int) -> dict:
    """Gemma3-1B's full widths and depth in ``dtype`` at the
    ``long_500k`` shape, caches filled from the seed: ``steps`` greedy
    decode steps at D = CP_SHARDS; before each, the same step at D = 1 on
    a copy of the same cache and the same token (the gate's pair); then
    D = 1 on its own cache and D = CP_SHARDS's tokens (timed; its caches
    drift from the other run's by rounding, so its logits only report)."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.models.build import build_model

    cfg = dataclasses.replace(cfg, dtype=str(dtype)[6:])
    pcfg = ParallelConfig(comm_mode="fused", attn_impl="pallas",
                          use_pallas_norm=True, seq_shard_kv=True)
    gc.collect()
    torch.cuda.empty_cache()
    apis = {d: build_model(cfg, pcfg, tp=1, ep=d) for d in (CP_SHARDS, 1)}
    params = apis[CP_SHARDS].init(seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 50)
    seeded = apis[CP_SHARDS].init_cache(1, GEMMA_CONTEXT, device="cuda")
    filled = GEMMA_CONTEXT - steps
    for layer in seeded:
        cells = layer["pos"].shape[1]
        for n in ("k", "v"):
            layer[n].normal_(generator=gen)
        p = torch.arange(max(0, filled - cells), filled, dtype=torch.int32,
                         device="cuda")
        layer["pos"][0, p % cells] = p

    def clone(cache):
        return [{n: t.clone() for n, t in layer.items()} for layer in cache]

    tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen,
                        device="cuda")
    inputs, tokens, ms, pair_err, logits_cp = [], [], [], [], []
    pair_tokens = []
    launches = {k: 0 for k in read_launches()}
    cache = clone(seeded)
    run_start_gb = reset_peak(torch)
    with torch.no_grad():
        for j in range(steps):
            pos = torch.full((1, 1), filled + j, dtype=torch.int32,
                             device="cuda")
            ref, _ = apis[1].decode_step(params, tok, clone(cache), pos)
            (out, n), t = timed_ms(torch, lambda: counted(
                lambda: apis[CP_SHARDS].decode_step(params, tok, cache,
                                                    pos)))
            logits, cache = out
            launches = {k: launches[k] + n[k] for k in n}
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"cp_decode {cfg.dtype}: logits not "
                                     f"finite")
            pair_err.append(rel_fro(logits, ref))
            pair_tokens.append(int(sharded_argmax(
                ref, vocab_size=cfg.vocab_size)[0, 0]))
            logits_cp.append(logits.float())
            inputs.append(tok)
            tok = sharded_argmax(logits, vocab_size=cfg.vocab_size)
            tokens.append(int(tok[0, 0]))
            ms.append(t)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del cache
        cache = clone(seeded)
        ms_d1, drift, tokens_d1 = [], [], []
        for j in range(steps):
            pos = torch.full((1, 1), filled + j, dtype=torch.int32,
                             device="cuda")
            (logits, cache), t = timed_ms(torch, lambda: apis[1].decode_step(
                params, inputs[j], cache, pos))
            drift.append(rel_fro(logits, logits_cp[j]))
            tokens_d1.append(int(sharded_argmax(
                logits, vocab_size=cfg.vocab_size)[0, 0]))
            ms_d1.append(t)
    global_gb = sum(layer["k"].nbytes + layer["v"].nbytes for layer in seeded
                    if layer["pos"].shape[1] == GEMMA_CONTEXT) / 1e9
    del params, seeded, cache
    torch.cuda.empty_cache()
    return {"dtype": cfg.dtype, "filled_positions": filled,
            "global_layers_kv_gb": global_gb, "decode_steps": steps,
            "logits_rel_fro_err_vs_d1_by_step": pair_err,
            "logits_rel_fro_err_vs_d1": max(pair_err),
            "free_running_d1_rel_fro_by_step": drift, "tokens": tokens,
            "tokens_d1": pair_tokens, "tokens_free_running_d1": tokens_d1,
            "tokens_equal": tokens == pair_tokens == tokens_d1,
            "decode_ms": ms, "decode_ms_median": statistics.median(ms),
            "decode_ms_d1": ms_d1,
            "decode_ms_median_d1": statistics.median(ms_d1),
            "launches": launches, "allocated_at_run_start_gb": run_start_gb,
            "max_memory_allocated_gb": peak}


def cp_decode_phase(torch, np, seed: int):
    """Gemma3-1B at full width and depth (26 layers, random weights from
    the seed) at the ``long_500k`` shape: one row, GEMMA_CONTEXT
    positions.  The caches are filled from the seed (the 4 global layers'
    524,288 slots and the sliding layers' 512-slot rings hold the
    positions before the steps), not by a prefill.  In bf16: CP_DECODE
    greedy decode steps under ``seq_shard_kv`` at D = CP_SHARDS (each
    global layer's decode combines the 4 shards' 131,072-slot chunks)
    beside D = 1 (``cp_compare``): the greedy tokens equal.  The logits
    are gated in float32, TF32 off, over CP_FP32_STEPS steps: each
    within CP_FP32_REL_FRO (relative Frobenius) of the same step at D = 1
    on the same cache, the combine being the unsharded softmax up to
    float32 summation order.  In bf16 that order flips a rounding now and
    then, which 26 random-weight layers carry to the logits (bit-equal
    steps beside ones a few 1e-2 apart), so there the errors are
    reported against VERIFY_REL_FRO, not gated.  Every forward launches
    K2 once (its entry norm: the sandwich post-norms take the unfused
    composition, as the reference's do); no K1, no K3 (decode attention
    is plain).  Returns the bf16 D = CP_SHARDS run's (launches, 0.0,
    peak GB)."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = get_config("gemma3-1b")
    reset_launches()
    bf16 = cp_compare(torch, cfg, seed, torch.bfloat16, CP_DECODE)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fp32 = cp_compare(torch, cfg, seed, torch.float32, CP_FP32_STEPS)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = recurrent_launches(CP_DECODE, norm_kernel="fused_residual_rmsnorm")
    for run, tol in ((bf16, VERIFY_REL_FRO), (fp32, CP_FP32_REL_FRO)):
        run["tol"], run["logits_gated"] = tol, run is fp32
        emit({"phase": "cp_decode", "model": cfg.name,
              "layers": cfg.num_layers, "d_model": cfg.d_model, "rows": 1,
              "context": GEMMA_CONTEXT, "data_shards": CP_SHARDS,
              "slots_per_shard": GEMMA_CONTEXT // CP_SHARDS, **run})
    emit({"phase": "cp_decode_seconds",
          "seconds": time.perf_counter() - t_phase})
    if bf16["launches"] != want:
        raise AssertionError(f"cp_decode: launches {bf16['launches']}, "
                             f"expected {want}")
    for run in (bf16, fp32):
        if not run["tokens_equal"]:
            raise AssertionError(f"cp_decode {run['dtype']}: D={CP_SHARDS} "
                                 f"tokens {run['tokens']}, D=1 "
                                 f"{run['tokens_d1']} / "
                                 f"{run['tokens_free_running_d1']}")
    if not fp32["logits_rel_fro_err_vs_d1"] <= CP_FP32_REL_FRO:
        raise AssertionError(
            f"cp_decode float32: D={CP_SHARDS} and D=1 logits differ by "
            f"{fp32['logits_rel_fro_err_vs_d1']} (relative Frobenius)")
    return bf16["launches"], 0.0, bf16["max_memory_allocated_gb"]

# --------------------------------------------------------------------------
# phases 19-21: training
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# pg_engine: the process-group backend over NCCL at world size 1
# --------------------------------------------------------------------------

PG_SHAPE = (2048, 8192)            # a prefill split's rows at Llama width
PG_ITERS = 20
PG_TURNS = ("rank_axis", "process_group", "process_group", "rank_axis")
# torch.distributed's own ranges around each NCCL call (none on the rank
# axis): their host ms in a traced decode step
PG_RANGES = {"nccl_reduce_scatter": "nccl:_reduce_scatter_base",
             "nccl_all_gather": "nccl:_all_gather_base"}


def card_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def event_ms(torch, fn, iters: int = PG_ITERS) -> float:
    """Mean time of one call of ``fn`` over ``iters`` back-to-back calls
    between two CUDA events, after a warm-up call (the host's launches
    included: NCCL's calls are not captured in a graph here)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_engine_steps(torch, eng, times: list) -> None:
    """Record each forward's wall ms and kind ("prefill", "decode") in
    ``times``, fenced by synchronize, for either dispatch scheme."""
    def wrap(kind_of, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            times.append((kind_of(*args), (time.perf_counter() - t) * 1e3))
        return run
    eng._run_prefill = wrap(lambda *a: "prefill", eng._run_prefill)
    eng._run_decode = wrap(lambda *a: "decode", eng._run_decode)
    eng._run_packed = wrap(lambda plan: "prefill" if any(
        s.kind == "prefill" for s in plan.segments) else "decode",
        eng._run_packed)


def pg_collectives(torch, groups) -> None:
    """psum, psum_scatter and all_gather at PG_SHAPE bf16: over NCCL (the
    process group of one card) with each wire dtype, beside the rank
    axis's versions at tp=1 and tp=8; one ``pg_collectives`` line each."""
    from repro_torch.distributed import collectives as CL
    from repro_torch.distributed.context import CommCtx

    t, d = PG_SHAPE
    card = card_line()
    x8 = torch.randn(8, t, d, device="cuda", dtype=torch.bfloat16)
    cases = [("rank_axis", 1, False, x8[:1].contiguous()),
             ("rank_axis", 8, False, x8)]
    cases += [("process_group", 1, wire, x8[:1].contiguous())
              for wire in (False, True)]
    for backend, tp, wire, x in cases:
        ctx = (CommCtx(tp=tp, bf16_wire=wire) if backend == "rank_axis"
               else CommCtx(tp=tp, backend=backend, groups=groups,
                            bf16_wire=wire))
        local = CL.token_shard_slice(x, ctx).contiguous()
        for op, fn in (("psum", lambda: CL.psum(x, ctx)),
                       ("psum_scatter", lambda: CL.psum_scatter(x, ctx)),
                       ("all_gather", lambda: CL.all_gather(local, ctx))):
            emit({"phase": "pg_collectives", "op": op, "backend": backend,
                  "tp": tp, "bf16_wire": wire, "shape": list(PG_SHAPE),
                  "dtype": "bfloat16", "ms": event_ms(torch, fn),
                  "iters": PG_ITERS, "card": card})
    del x8, cases
    torch.cuda.empty_cache()


def pg_engine_phase(torch, np, seed: int, trace_dir: Path):
    """The engine phase's model (Llama-3.3-70B widths, 4 layers, bf16,
    seed 0) at tp=1 ``fused`` with K2, built twice: on the rank axis and
    over a ``(data 1, model 1)`` mesh of NCCL process groups
    (``init_groups``, a file store), with one rank's params
    (``weights.take_rank``).  One prefill's logits must be bit-equal, and
    the 4 requests served through the two-dispatch engine over legacy
    slots and through packed batching over the paged pool, each in turns
    (``PG_TURNS``), must give equal tokens on both backends; launches
    equal their formulas (K2 and K3), the pool drains, K3 is held on the
    first process-group run's inputs.  Then one decode step of each
    backend is traced (``breakdown``) and the collectives are timed
    (``pg_collectives``).  Returns (launches of the runs, K3's max error,
    peak GB)."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch.mesh import init_groups, make_mesh
    from repro_torch.models.build import build_model
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig
    from repro_torch.weights import take_rank

    store = Path(tempfile.mkdtemp(prefix="pg_store_"))
    groups = init_groups(make_mesh((1, 1), ("data", "model")),
                         backend="nccl", init_method=f"file://{store}/store",
                         rank=0, world_size=1)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        cfg, api, params, prompts, init_s, start_gb = full_width_model(
            torch, np, seed, tp=1, comm_mode="fused", n_layers=4)
        apis = {"rank_axis": (api, params),
                "process_group": (build_model(cfg, api.pcfg, tp=1,
                                              groups=groups),
                                  take_rank(params, 0, cfg))}

        # one prefill's logits, bit-equal
        chunk = 1856
        tokens = torch.zeros(1, chunk, dtype=torch.long, device="cuda")
        tokens[0, :1800] = torch.tensor(prompts[0], device="cuda")
        pos = torch.full((1, chunk), -1, dtype=torch.int32, device="cuda")
        pos[0, :1800] = torch.arange(1800, dtype=torch.int32, device="cuda")
        logits = {}
        with torch.no_grad():
            for name, (a, p) in apis.items():
                cache = a.init_cache(1, SchedulerConfig().max_len,
                                     device="cuda")
                logits[name], _ = a.prefill(
                    p, tokens, cache, pos,
                    last_idx=torch.tensor([1799], device="cuda"))
                del cache
        if not (torch.isfinite(logits["rank_axis"]).all()
                and torch.equal(logits["rank_axis"],
                                logits["process_group"])):
            raise AssertionError("prefill logits differ between the rank "
                                 "axis and the process group")
        del logits

        launches = {n: 0 for n in read_launches()}
        k3_err, peak, rows = 0.0, 0.0, []
        for scheme, kw in (("two_dispatch", {}),
                           ("packed_paged", dict(paged=True, packed=True))):
            toks, times, stats = [], {n: [] for n in apis}, {}
            for turn, name in enumerate(PG_TURNS):
                a, p = apis[name]
                eng = Engine(a, p, SchedulerConfig(**kw))
                time_engine_steps(torch, eng, times[name])
                for i, prompt in enumerate(prompts):
                    eng.add_request(Request(rid=i, prompt=prompt,
                                            max_new_tokens=NEW_TOKENS))
                k3_inputs = {}
                undo = (capture_k3_inputs(k3_inputs) if turn == 1
                        else (lambda: None))
                try:
                    reset_peak(torch)
                    reset_launches()
                    done = eng.run()
                    torch.cuda.synchronize()
                    got = read_launches()
                finally:
                    undo()
                peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
                check_outputs(done, len(prompts), cfg.vocab_size, NEW_TOKENS)
                st = eng.stats
                if kw:
                    check_drained(eng)
                    splits = st.forwards + st.weave_forwards
                else:
                    pf = eng.metrics.get("engine/site_forwards",
                                         site="prefill").value
                    pw = eng.metrics.get("engine/site_weave", site="prefill")
                    splits = pf + (pw.value if pw is not None else 0)
                want = check_launches(eng, got,
                                      norm_kernel="fused_residual_rmsnorm",
                                      n_layers=cfg.num_layers,
                                      k3_splits=splits)
                for k in launches:
                    launches[k] += got[k]
                toks.append({r.rid: r.output for r in done})
                stats[name] = {"forwards": st.forwards,
                               "weave_forwards": st.weave_forwards,
                               "launches": got, "expected_launches": want}
                del eng
                if k3_inputs:
                    k3_err = max(k3_err, check_main_path_k3(
                        torch, k3_inputs, f"pg_engine_{scheme}", 1))
            if any(t != toks[0] for t in toks):
                raise AssertionError(f"{scheme}: tokens differ between the "
                                     f"rank axis and the process group")
            for name in apis:
                by_kind = {k: [ms for kk, ms in times[name] if kk == k]
                           for k in ("prefill", "decode")}
                rows.append({"scheme": scheme, "backend": name,
                             "runs": PG_TURNS.count(name), **stats[name],
                             "prefill_ms": by_kind["prefill"],
                             "decode_ms_median":
                                 statistics.median(by_kind["decode"]),
                             "step_ms_median": statistics.median(
                                 ms for _, ms in times[name])})
        emit({"phase": "pg_engine", "model": cfg.name, "tp": 1,
              "layers": cfg.num_layers, "dtype": cfg.dtype,
              "backend": dist.get_backend(), "world_size":
              dist.get_world_size(), "prompt_lens": list(PROMPT_LENS),
              "new_tokens": NEW_TOKENS, "tokens_equal": True,
              "prefill_logits_bit_equal": True, "runs": rows,
              "max_memory_allocated_gb": peak, "card": card_line()})
        # where a decode step's time goes on each backend: 8 slots, the
        # 4 requests' rows at their last positions over an empty cache
        dtok = torch.zeros(8, 1, dtype=torch.long, device="cuda")
        dpos = torch.full((8, 1), -1, dtype=torch.int32, device="cuda")
        dpos[:len(PROMPT_LENS), 0] = torch.tensor(
            [n + NEW_TOKENS - 1 for n in PROMPT_LENS], device="cuda")
        for name, (a, p) in apis.items():
            cache = a.init_cache(8, SchedulerConfig().max_len,
                                 device="cuda")
            with torch.no_grad():
                brk = device_breakdown(
                    torch, lambda: a.decode_step(p, dtok, cache, dpos),
                    trace_dir / f"pg_engine_{name}_decode_trace.json",
                    ranges=PG_RANGES)
            emit({"phase": "breakdown", "engine": "pg_engine",
                  "backend": name, "tp": 1, "step": "decode", "tokens": 8,
                  **brk})
            del cache
        del apis, params
        gc.collect()
        torch.cuda.empty_cache()
        pg_collectives(torch, groups)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return launches, k3_err, peak


# --------------------------------------------------------------------------
# k1_peer: K1's cross-rank form, N ranks on the one card
# --------------------------------------------------------------------------

# (T, d, dtype): a prefill split's rows at Llama width, Whisper's encoder
# split of short rows, one float32 case, rows of 8190 (not whole 16-byte
# vectors: the scalar body), and a decode step's 8 rows (T/N below the 8
# CTAs: CTAs with no rows still take part in the flags)
K1P_CASES = ((2048, 8192, "bfloat16"), (12000, 512, "bfloat16"),
             (2048, 4096, "float32"), (1000, 8190, "bfloat16"),
             (8, 8192, "bfloat16"))
K1P_LOCAL_RANKS = (2, 4, 8)        # one process, one stream a rank
# a CUDA graph of the N ranks' calls, one per rank's stream, replayed on
# fresh inputs: a decode's T (one wait) and a prefill split's (three phases)
K1P_GRAPH_T = (8, 1024)
K1P_GRAPH_REPLAYS = 20
K1P_PROC_RANKS = (2, 4)            # one process a rank
K1P_ITERS = 20
K1P_PROC_ITERS = 5
# the workspace every k1_peer run sizes: 2048 rows of 8192 bf16, whose
# chunks hold every case's
K1P_ROWS, K1P_D = 2048, 8192
K1P_TIMEOUT_S = 600
# a sleep kernel that holds back k1_peer's timed calls while the host
# enqueues them (~70 ms at the H100's clock), doubled while too short
K1P_GATE_CYCLES = 1 << 27


def k1p_small(n: int) -> tuple:
    """The one-wait path's cases at N ranks, d 8192 bf16: T/N of 1, N, 2N
    and 8N rows a rank (the one-wait path where T/N is below the CTAs, the
    three phases elsewhere; the CTA sweep crosses between them)."""
    return tuple((c * n, 8192, "bfloat16") for c in (1, n, 2 * n, 8 * n))


def gated_ms(torch, fn, iters: int) -> tuple:
    """(device ms, host ms) of one call of ``fn`` (launches on several
    streams, joined back into the current one): ``iters`` calls are
    enqueued behind a sleep kernel on the current stream and timed from
    its end with CUDA events, so they run back to back whatever the
    host's launch rate; the host ms is the enqueueing's.  A CUDA graph
    would serve as well (``time_ms``), but a graph's parallel branches are
    not promised to run at once, and the ranks' kernels wait on each
    other."""
    fn()
    torch.cuda.synchronize()
    cycles = K1P_GATE_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        host = (time.perf_counter() - t) * 1e3 / iters
        end.record()
        late = start.query()       # the gate opened before the last launch
        torch.cuda.synchronize()
        if not late:
            return start.elapsed_time(end) / iters, host
        cycles *= 2
    raise AssertionError("the host could not enqueue the timed calls "
                         "within the gate")


def free_ms(torch, streams, call, iters: int = K1P_ITERS) -> tuple:
    """(device ms, host ms) of one call of N ranks when each rank's stream
    runs its calls back to back, the ranks meeting only through the
    kernel's flags, as one process a rank runs them: ``call(k)`` enqueues
    rank k's call on the current stream; ``iters`` calls a rank are
    enqueued behind one gate and joined once (``gated_ms`` joins the
    streams after every call)."""
    main = torch.cuda.current_stream()

    def batch():
        for s in streams:
            s.wait_stream(main)
        for _ in range(iters):
            for k, s in enumerate(streams):
                with torch.cuda.stream(s):
                    call(k)
        for s in streams:
            main.wait_stream(s)
    ms, host = gated_ms(torch, batch, 1)
    return ms / iters, host / iters


def k1p_inputs(torch, seed: int, n: int, t: int, d: int, dtype):
    """Every rank's partial (n, T, d) and residual chunk (n, T/n, d) and
    the weight, from the seed on the card: equal in every process."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 100 * n + t + d)
    dt = getattr(torch, dtype)
    x = torch.randn(n, t, d, generator=gen, device="cuda", dtype=dt)
    r = torch.randn(n, t // n, d, generator=gen, device="cuda", dtype=dt)
    w = (torch.randn(d, generator=gen, device="cuda").abs() + 0.5).to(dt)
    return x, r, w


def k1p_bytes(n: int, t: int, d: int, size: int) -> dict:
    """The function's bytes (each input read once, each output written
    once: K1's) and this design's traffic over the N ranks (source
    note)."""
    return {"function_bytes": 2 * (n + 1) * t * d * size + d * size,
            "design_bytes": ((3 * (n - 1) + 2) + (2 * (n - 1) + 3))
            * t * d * size}


def k1_peer_graph(torch, seed: int, n: int, ws, streams, t: int,
                  d: int) -> dict:
    """N ranks' calls captured into N CUDA graphs, one on each rank's
    stream (as one process a rank would capture its own), replayed
    K1P_GRAPH_REPLAYS times on fresh inputs; each replay's outputs
    bit-equal to an eager call on the same inputs through the same
    workspaces (the device epoch runs on through both) and to the one-card
    K1.  Returns the case's line, with the replay's device ms."""
    from repro_torch.kernels import ar_rmsnorm as K1
    from repro_torch.kernels import ar_rmsnorm_peer as K1P

    main = torch.cuda.current_stream()
    gen = torch.Generator(device="cuda").manual_seed(seed + 7 * n + t)
    x = torch.empty(n, t, d, dtype=torch.bfloat16, device="cuda")
    r = torch.empty(n, t // n, d, dtype=torch.bfloat16, device="cuda")
    w = (torch.randn(d, generator=gen, device="cuda").abs() + 0.5).to(x.dtype)

    def fresh():
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
        r.copy_(torch.randn(r.shape, generator=gen, device="cuda"))

    def on_streams(fn):
        for s in streams:
            s.wait_stream(main)
        outs = []
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs.append(fn(k))
        for s in streams:
            main.wait_stream(s)
        return outs

    def eager(k):
        return K1P.ar_rmsnorm_peer(x[k:k + 1], r[k:k + 1], w,
                                   workspace=ws[k], ctas=K1.MAX_CTAS)
    fresh()
    on_streams(eager)
    torch.cuda.synchronize()
    graphs, captured = [], []
    before = K1P.ar_rmsnorm_peer.launches
    for k, s in enumerate(streams):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            captured.append(eager(k))
        graphs.append(graph)
    if K1P.ar_rmsnorm_peer.launches != before + n:
        raise AssertionError("the captured calls did not reach the kernel")

    def replay():
        on_streams(lambda k: graphs[k].replay())
    for i in range(K1P_GRAPH_REPLAYS):
        fresh()
        replay()
        want = on_streams(eager)
        ref_out, ref_res = K1.ar_rmsnorm(x, r, w, ctas=K1.MAX_CTAS)
        torch.cuda.synchronize()
        for k, ((o, nr), (eo, enr)) in enumerate(zip(captured, want)):
            if not (torch.equal(o, eo) and torch.equal(nr, enr)
                    and torch.equal(o[0], ref_out[k])
                    and torch.equal(nr[0], ref_res[k])):
                raise AssertionError(
                    f"K1 peer graph N={n} T={t}: replay {i}, rank {k} "
                    f"differs from the eager call")
    ms, host = gated_ms(torch, replay, K1P_ITERS)
    eager_ms, eager_host = gated_ms(torch, lambda: on_streams(eager),
                                    K1P_ITERS)
    free, free_host = free_ms(torch, streams, lambda k: graphs[k].replay())
    eager_free, eager_free_host = free_ms(torch, streams, eager)
    del graphs
    return {"phase": "k1_peer", "mode": "graph", "N": n, "T": t, "d": d,
            "dtype": "bfloat16", "ctas": K1.MAX_CTAS,
            "one_wait": K1P.small_t(t, n, K1.MAX_CTAS),
            "replays": K1P_GRAPH_REPLAYS, "bit_equal_to_eager": True,
            "bit_equal_to_one_card_k1": True, "ms": ms, "host_ms": host,
            "eager_ms": eager_ms, "eager_host_ms": eager_host,
            "ms_free": free, "host_ms_free": free_host,
            "eager_ms_free": eager_free, "eager_host_ms_free": eager_free_host,
            "iters": K1P_ITERS}


def k1_peer_local(torch, seed: int, cases=K1P_CASES,
                  ranks=K1P_LOCAL_RANKS, small=True) -> None:
    """k1_peer (a), in a process of its own: N ranks as N launches on N
    streams, each with its own workspace (``PeerWorkspace.local``), at
    every ``cases`` shape (K1P_CASES, or pg_families' served rows) and N
    in ``ranks``.  Each rank's output
    and new residual bit-equal to the one-card K1's on the same inputs, on
    1, 2, 4 and 8 CTAs, and within K1_TOL of the plain version; the
    device time of one call of all N ranks (``gated_ms``) beside the
    one-card K1's.  One JSON line per case, then the summary."""
    from repro_torch.distributed.peer import PeerWorkspace
    from repro_torch.kernels import ar_rmsnorm as K1
    from repro_torch.kernels import ar_rmsnorm_peer as K1P

    summary = {"max_abs_err": 0.0}
    main = torch.cuda.current_stream()
    for n in ranks:
        ws = PeerWorkspace.local(n, rows=K1P_ROWS, d=K1P_D,
                                 dtype=torch.bfloat16, device="cuda")
        streams = [torch.cuda.Stream() for _ in range(n)]
        extra = [c for c in k1p_small(n) if c not in cases] if small else []
        for t, d, dtype in [*cases, *extra]:
            x, r, w = k1p_inputs(torch, seed, n, t, d, dtype)

            def run(ctas):
                outs = []
                for s in streams:
                    s.wait_stream(main)
                for k, s in enumerate(streams):
                    with torch.cuda.stream(s):
                        outs.append(K1P.ar_rmsnorm_peer(
                            x[k:k + 1], r[k:k + 1], w, workspace=ws[k],
                            ctas=ctas))
                for s in streams:
                    main.wait_stream(s)
                return outs
            ref_out, ref_res = K1.ar_rmsnorm(x, r, w, ctas=K1.MAX_CTAS)
            before = K1P.ar_rmsnorm_peer.launches
            for ctas in CTA_SWEEP:
                outs = run(ctas)
                torch.cuda.synchronize()
                for k, (o, nr) in enumerate(outs):
                    if not (torch.equal(o[0], ref_out[k])
                            and torch.equal(nr[0], ref_res[k])):
                        raise AssertionError(
                            f"K1 peer N={n} T={t} d={d} {dtype} rank {k} on "
                            f"{ctas} CTAs differs from the one-card K1")
            launches = K1P.ar_rmsnorm_peer.launches - before
            if launches != n * len(CTA_SWEEP):
                raise AssertionError(f"K1 peer launches {launches}")
            p_out, p_res = K1.ar_rmsnorm_plain(x, r, w)
            err = max(check_close(f"K1 peer N={n} T={t} out", ref_out, p_out,
                                  K1_TOL, K1_TOL),
                      check_close(f"K1 peer N={n} T={t} residual", ref_res,
                                  p_res, K1_TOL, K1_TOL))
            summary["max_abs_err"] = max(summary["max_abs_err"], err)
            size = x.element_size()
            ms, host = gated_ms(torch, lambda: run(K1.MAX_CTAS), K1P_ITERS)
            free, free_host = free_ms(torch, streams, lambda k: (
                K1P.ar_rmsnorm_peer(x[k:k + 1], r[k:k + 1], w,
                                    workspace=ws[k], ctas=K1.MAX_CTAS)))
            case = {"phase": "k1_peer", "mode": "one_process", "N": n,
                    "T": t, "d": d, "dtype": dtype, "ctas": K1.MAX_CTAS,
                    "bit_equal_to_one_card_k1": True,
                    "ctas_bit_identical": list(CTA_SWEEP),
                    "one_wait_at_ctas": [c for c in CTA_SWEEP
                                         if K1P.small_t(t, n, c)],
                    "max_abs_err": err, "tol": K1_TOL, "ms": ms,
                    "host_ms": host, "ms_free": free,
                    "host_ms_free": free_host, "iters": K1P_ITERS,
                    "one_card_k1_ms": time_ms(torch, lambda: K1.ar_rmsnorm(
                        x, r, w, ctas=K1.MAX_CTAS)),
                    **k1p_bytes(n, t, d, size)}
            case["bound_ms"] = (case["function_bytes"] / HBM_BYTES_PER_S
                                * 1e3)
            case["design_bound_ms"] = (case["design_bytes"]
                                       / HBM_BYTES_PER_S * 1e3)
            case["achieved_gb_per_s"] = case["design_bytes"] / ms / 1e6
            if (n, t, d, dtype) == (8, 2048, 8192, "bfloat16"):
                case["plain_ms"] = time_ms(
                    torch, lambda: K1.ar_rmsnorm_plain(x, r, w), iters=3)
                summary.update(ms=ms, plain_ms=case["plain_ms"],
                               bound_ms=case["bound_ms"], bound_by="bytes",
                               library_ms=None)
            emit(case)
            del x, r, w, ref_out, ref_res, p_out, p_res
        if small:
            for t in K1P_GRAPH_T:
                emit(k1_peer_graph(torch, seed, n, ws, streams, t, K1P_D))
        for one in ws:
            one.close()
        torch.cuda.empty_cache()
    emit({"k1_peer_local": summary})


def k1_peer_rank(torch, seed: int, rank: int, world: int,
                 store: str) -> None:
    """k1_peer (b), one process of a world of N on the card: gloo groups
    (they carry only the IPC handle exchange), a workspace over them
    (``peer.attach``), then at every K1P_CASES shape ``comm_norm`` in
    comm mode ``ring`` under ``process_group`` on this rank's share:
    output and new residual bit-equal to the one-card K1's on the whole
    inputs (made here from the same seed), one launch a call; the calls'
    time, with the ranks time-sliced on the card.  One JSON line."""
    import torch.distributed as dist
    from repro_torch.core import fused_collectives as FC
    from repro_torch.core.splitting import ring_ctas
    from repro_torch.distributed import peer
    from repro_torch.distributed.context import CommCtx
    from repro_torch.kernels import ar_rmsnorm as K1
    from repro_torch.kernels import ar_rmsnorm_peer as K1P
    from repro_torch.launch.mesh import init_groups, make_mesh

    groups = init_groups(make_mesh((1, world), ("data", "model")),
                         backend="gloo", init_method=f"file://{store}/store",
                         rank=rank, world_size=world)
    try:
        groups = peer.attach(groups, rows=K1P_ROWS, d=K1P_D,
                             dtype=torch.bfloat16, device="cuda")
        ctx = CommCtx(mode="ring", use_pallas=True, tp=world,
                      backend="process_group", groups=groups)
        cases = []
        for t, d, dtype in K1P_CASES:
            x, r, w = k1p_inputs(torch, seed + 1, world, t, d, dtype)
            ref_out, ref_res = K1.ar_rmsnorm(x, r, w, ctas=K1.MAX_CTAS)
            mine = (x[rank:rank + 1], r[rank:rank + 1])
            before = K1P.ar_rmsnorm_peer.launches
            out, new_res = FC.comm_norm(*mine, w, ctx=ctx)
            torch.cuda.synchronize()
            if K1P.ar_rmsnorm_peer.launches != before + 1:
                raise AssertionError("comm_norm(ring) did not launch the "
                                     "peer kernel once")
            if not (torch.equal(out[0], ref_out[rank])
                    and torch.equal(new_res[0], ref_res[rank])):
                raise AssertionError(f"K1 peer across processes, rank "
                                     f"{rank} of {world}, T={t} d={d} "
                                     f"{dtype}: differs from the one-card "
                                     f"K1")
            ms = event_ms(torch, lambda: FC.comm_norm(*mine, w, ctx=ctx),
                          iters=K1P_PROC_ITERS)
            cases.append({"T": t, "d": d, "dtype": dtype,
                          "time_sliced_ms": ms})
        emit({"phase": "k1_peer", "mode": "processes", "rank": rank,
              "N": world, "ctas": ring_ctas(ctx.comm_budget),
              "bit_equal_to_one_card_k1": True, "cases": cases,
              "launches": K1P.ar_rmsnorm_peer.launches,
              "iters": K1P_PROC_ITERS})
        groups.peer.close()
    finally:
        dist.destroy_process_group()


def run_children(cmds, *, cwd, env, timeout: float) -> list:
    """Start every command at once and wait for all; their standard
    output's lines, or a failure naming the first that failed (every
    child is stopped before it raises)."""
    procs = [subprocess.Popen(c, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs, failed = [], []
    try:
        for c, p in zip(cmds, procs):
            out, err = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode != 0:
                failed.append(f"{' '.join(map(str, c))}: exit "
                              f"{p.returncode}\n{out[-2000:]}\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError("\n".join(failed))
    return outs


def json_lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith("{")]


def k1_peer_phase(seed: int) -> dict:
    """K1's cross-rank form on the card: (a) one process, N ranks on N
    streams (``k1_peer_local``; CUDA_DEVICE_MAX_CONNECTIONS raised so no
    two streams share a hardware queue, where a spinning rank could hold
    back the launch it waits for); (b) N processes, one rank each
    (``k1_peer_rank``).  Returns the kernel line's numbers."""
    import os
    import tempfile

    env = dict(os.environ, CUDA_DEVICE_MAX_CONNECTIONS="32")
    me = [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed)]
    out, = run_children([me + ["--k1-peer-local"]], cwd=ROOT, env=env,
                        timeout=K1P_TIMEOUT_S)
    lines = json_lines(out)
    for ln in lines[:-1]:
        emit(ln)
    row = lines[-1]["k1_peer_local"]
    card = card_line()
    for n in K1P_PROC_RANKS:
        store = tempfile.mkdtemp(prefix="k1p_store_")
        outs = run_children(
            [me + ["--k1-peer-rank", str(k), "--k1-peer-world", str(n),
                   "--k1-peer-store", store] for k in range(n)],
            cwd=ROOT, env=dict(os.environ, GLOO_SOCKET_IFNAME="lo"),
            timeout=K1P_TIMEOUT_S)
        for o in outs:
            for ln in json_lines(o):
                emit(dict(ln, card=card))
    return row


# --------------------------------------------------------------------------
# pg_ring: launch.serve in comm mode ring, two ranks on the card
# --------------------------------------------------------------------------

PG_RING_WORLD = 2


def bits_digest(torch, t):
    """A fingerprint of a tensor's bits, left on the card (no host sync):
    the int64 sum of each element's bit pattern times a weight from its
    position, 1 to 65521.  Equal bits give equal digests; a change in any
    one element changes it (each term is below 2^48 in size)."""
    bits = t.reshape(-1).view(torch.int16 if t.element_size() == 2
                              else torch.int32).to(torch.int64)
    pos = torch.arange(bits.numel(), device=t.device, dtype=torch.int64)
    return (bits * (pos % 65521 + 1)).sum()


class k1_peer_spy:
    """A spy around K1's cross-rank wrapper while the block runs: it
    calls the wrapper as the model asked and keeps, for every call, its
    (T, CTAs) and the digests of its x, residual, output and new
    residual; at the first call of each (T, CTAs) it saves those tensors,
    the weight and the body ``check_inputs`` picks (vector or scalar).
    The wrapper counts its launches on the spy (``launches``), where
    ``launch.serve`` reads them.  On leaving, the calls go to
    ``spy_dir``/calls_r<rank>.json."""

    def __init__(self, torch, spy_dir: Path, rank: int):
        self.torch, self.spy_dir, self.rank = torch, spy_dir, rank

    def __enter__(self):
        from repro_torch.kernels import ar_rmsnorm as K1
        from repro_torch.kernels import ar_rmsnorm_peer as K1P

        torch, spy_dir, rank = self.torch, self.spy_dir, self.rank
        self.mod, self.real = K1P, K1P.ar_rmsnorm_peer
        real, calls, digests, saved = self.real, [], [], set()
        self.calls, self.digests = calls, digests

        def spy(x, residual, weight, ctx=None, **kw):
            out, new_res = real(x, residual, weight, ctx, **kw)
            key = (x.shape[1], kw["ctas"])
            calls.append(key)
            digests.append(torch.stack([bits_digest(torch, t)
                                        for t in (x, residual, out,
                                                  new_res)]))
            if key not in saved:
                saved.add(key)
                torch.save({"x": x.cpu(), "residual": residual.cpu(),
                            "weight": weight.cpu(), "out": out.cpu(),
                            "new_res": new_res.cpu(), "eps": kw["eps"],
                            "vector": K1.pipelined(x, residual, weight)},
                           spy_dir / f"r{rank}_T{key[0]}_c{key[1]}.pt")
            return out, new_res

        spy.launches = real.launches
        K1P.ar_rmsnorm_peer = spy
        return spy

    def __exit__(self, *exc):
        self.mod.ar_rmsnorm_peer = self.real
        (self.spy_dir / f"calls_r{self.rank}.json").write_text(json.dumps({
            "calls": self.calls,
            "digests": (self.torch.stack(self.digests).tolist()
                        if self.digests else [])}))
        return False


def serve_spied(torch, spy_dir: Path, argv) -> int:
    """One rank of pg_ring: ``launch.serve``'s ``main`` on ``argv`` under
    ``k1_peer_spy``.  Everything goes to ``spy_dir`` for pg_ring_phase."""
    from repro_torch.launch import serve

    with k1_peer_spy(torch, spy_dir, serve.parse(argv).rank):
        return serve.main(argv)


def serve_ring(*, reduced: bool, seed: int, spy_dir: Path,
               timeout: float = 900) -> dict:
    """``python -m repro_torch.launch.serve --comm-mode ring --backend
    gloo`` at world size PG_RING_WORLD, every rank on the card (Llama-3.3-
    70B at 4 layers, or ``--reduced``), each rank's ``main`` run under
    ``serve_spied``; rank 0's JSON line, once both ranks exited 0."""
    import os
    import tempfile

    store = tempfile.mkdtemp(prefix="pg_ring_store_")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    args = ["--arch", "llama3.3-70b", "--comm-mode", "ring", "--backend",
            "gloo", "--world-size", str(PG_RING_WORLD), "--seed", str(seed),
            "--prompt-lens", ",".join(map(str, PROMPT_LENS)),
            "--new-tokens", str(NEW_TOKENS),
            "--init-method", f"file://{store}/store"]
    args += ["--reduced"] if reduced else ["--layers", "4"]
    me = [sys.executable, str(Path(__file__).resolve()), "--pg-ring-spy",
          str(spy_dir), "--serve-argv"]
    try:
        outs = run_children([me + args + ["--rank", str(k)]
                             for k in range(PG_RING_WORLD)],
                            cwd=ROOT, env=env, timeout=timeout)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    line, = json_lines(outs[0])
    if not line["ranks_agree"]:
        raise AssertionError("pg_ring: the ranks' tokens differ")
    return line


def rank_axis_calls(torch, fn) -> tuple:
    """Run ``fn`` with a spy around the rank axis's K1 in ``comm_norm``:
    (fn's result, every call's (T, CTAs), every call's digests of x,
    residual, output and new residual, rank by rank)."""
    from repro_torch.core import fused_collectives as FC

    real = FC.ar_rmsnorm
    calls, digests = [], []

    def spy(x, residual, weight, **kw):
        out, new_res = real(x, residual, weight, **kw)
        calls.append((x.shape[1], kw["ctas"]))
        digests.append(torch.stack([
            torch.stack([bits_digest(torch, t[k])
                         for t in (x, residual, out, new_res)])
            for k in range(x.shape[0])]))
        return out, new_res

    FC.ar_rmsnorm = spy
    try:
        result = fn()
    finally:
        FC.ar_rmsnorm = real
    return result, calls, torch.stack(digests).tolist() if digests else []


def check_peer_shapes(torch, spy_dir: Path, counts: dict,
                      label: str = "pg_ring",
                      ranks=range(PG_RING_WORLD)) -> tuple:
    """K1's cross-rank form at every (T, CTAs) the served forwards gave
    it: the saved inputs of one model group's ranks (world ranks
    ``ranks``, in model-rank order) stacked, the one-card K1 run on them,
    each rank's output and new residual bit-equal to it, and it within
    K1_TOL of the plain version.  Returns (rows for the report, max abs
    error)."""
    from repro_torch.kernels import ar_rmsnorm as K1

    rows, worst = [], 0.0
    for (t, ctas), n_calls in sorted(counts.items()):
        parts = [torch.load(spy_dir / f"r{k}_T{t}_c{ctas}.pt")
                 for k in ranks]
        w = parts[0]["weight"]
        if not all(torch.equal(p["weight"], w) for p in parts):
            raise AssertionError(f"{label} T={t}: the ranks' weights differ")
        x = torch.cat([p["x"] for p in parts]).cuda()
        r = torch.cat([p["residual"] for p in parts]).cuda()
        w, eps = w.cuda(), parts[0]["eps"]
        ref_out, ref_res = K1.ar_rmsnorm(x, r, w, eps=eps, ctas=ctas)
        for k, p in enumerate(parts):
            if not (torch.equal(p["out"][0].cuda(), ref_out[k])
                    and torch.equal(p["new_res"][0].cuda(), ref_res[k])):
                raise AssertionError(
                    f"{label}: K1 peer at T={t} on {ctas} CTAs, rank {k}, "
                    f"differs from the one-card K1 on the same inputs")
        p_out, p_res = K1.ar_rmsnorm_plain(x, r, w, eps)
        err = max(check_close(f"{label} K1 peer T={t} out", ref_out, p_out,
                              K1_TOL, K1_TOL),
                  check_close(f"{label} K1 peer T={t} residual", ref_res,
                              p_res, K1_TOL, K1_TOL))
        worst = max(worst, err)
        rows.append({"T": t, "d": int(w.shape[0]),
                     "chunk": t // PG_RING_WORLD, "ctas": ctas,
                     "calls": n_calls,
                     "body": ("vector" if parts[0].get("vector")
                              else "scalar"),
                     "bit_equal_to_one_card_k1": True,
                     "max_abs_err": err})
    return rows, worst


def first_differences(got: list, want: list) -> list:
    """Per request, the first token that differs (None: all equal)."""
    return [next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
            for g, w in zip(got, want)]


def first_divergence(group: list, axis: list, calls: list,
                     axis_calls: list) -> dict:
    """Set the served calls (``group[k]``: rank k's (calls, digests))
    beside the rank axis's, call by call over the calls both made at the
    same (T, CTAs): the first call whose K1 inputs differ (which input, on
    which rank), and whether K1's outputs agreed at every call whose
    inputs agreed.  Raises where they did not."""
    n = 0
    while (n < min(len(calls), len(axis_calls))
           and tuple(calls[n]) == tuple(axis_calls[n])):
        n += 1
    first, agreed = None, 0
    for i in range(n):
        same_in = [group[k][1][i][:2] == axis[i][k][:2]
                   for k in range(PG_RING_WORLD)]
        if all(same_in):
            agreed += 1
            for k in range(PG_RING_WORLD):
                if group[k][1][i][2:] != axis[i][k][2:]:
                    raise AssertionError(
                        f"pg_ring call {i}: K1's inputs equal the rank "
                        f"axis's on every rank, rank {k}'s outputs differ")
        elif first is None:
            first = {"call": i, "T": calls[i][0], "ctas": calls[i][1],
                     "x_differs": [group[k][1][i][0] != axis[i][k][0]
                                   for k in range(PG_RING_WORLD)],
                     "residual_differs": [group[k][1][i][1] != axis[i][k][1]
                                          for k in range(PG_RING_WORLD)]}
    return {"calls": len(calls), "axis_calls": len(axis_calls),
            "aligned": n, "inputs_equal": agreed,
            "outputs_equal_where_inputs_equal": True,
            "first_input_difference": first}


def layer_gemms(cfg) -> dict:
    """A dense layer's products on one rank at tp=PG_RING_WORLD: name ->
    (f, n), (T, f) @ (f, n) (wv has wk's shape, w_up w_gate's)."""
    hd, d, w = cfg.head_dim, cfg.d_model, PG_RING_WORLD
    return {"wq": (d, cfg.num_heads * hd // w),
            "wk": (d, max(cfg.num_kv_heads // w, 1) * hd),
            "wo": (cfg.num_heads * hd // w, d),
            "w_gate": (d, cfg.d_ff // w),
            "w_down": (cfg.d_ff // w, d)}


def gemm_witness(torch, seed: int, t: int, f: int, n: int, dtype) -> dict:
    """A product at T rows the two ways the model runs it at tp=2: the
    rank axis's one batched product over both ranks, (R, T, f) @ (R, f, n),
    and a process's own, (1, T, f) @ (1, f, n), on the same seeded
    operands in the model's dtype: whether each rank's bits differ, and by
    how much."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(PG_RING_WORLD, t, f, generator=gen, device="cuda").to(
        dtype)
    b = (torch.randn(PG_RING_WORLD, f, n, generator=gen, device="cuda")
         / f ** 0.5).to(dtype)
    both = a @ b
    one = [(a[k:k + 1] @ b[k:k + 1])[0] for k in range(PG_RING_WORLD)]
    return {"T": t, "f": f, "n": n,
            "bits_differ": [not torch.equal(both[k], one[k])
                            for k in range(PG_RING_WORLD)],
            "max_abs_diff": max(max_err(both[k], one[k])
                                for k in range(PG_RING_WORLD))}


def pg_ring_phase(torch, np, seed: int) -> tuple:
    """Comm mode ``ring`` one rank per process (``launch.serve``, gloo for
    the collectives that are not K1, K1's cross-rank form for every add+
    norm slot) at Llama-3.3-70B width, 4 layers, bf16, and its float32
    twin (the reduced config): K1-peer launches equal the engine's slots,
    splits·(1+2L), and nothing else runs an add+norm kernel; K1-peer bit-
    equal to the one-card K1 (and within K1_TOL of the plain version) at
    every (T, CTAs) the forwards gave it, on the served inputs
    (``check_peer_shapes``); tokens beside the rank axis's ``ring`` at
    tp=2 on the card (bf16: reported; float32: equal), and K1's inputs
    and outputs beside the rank axis's call by call
    (``first_divergence``: outputs equal wherever inputs are; float32:
    the same calls at the same shapes), with, where the inputs part, a
    layer's products at that call's rows the two ways (``gemm_witness``).  Returns (rank 0's K1-peer launches over both
    runs, the largest error against the plain version)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models.build import build_model
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    peer_launches, worst = 0, 0.0
    for reduced in (False, True):
        spy_dir = Path(tempfile.mkdtemp(prefix="pg_ring_spy_"))
        try:
            line = serve_ring(reduced=reduced, seed=seed, spy_dir=spy_dir)
            got = line["launches"]
            slots = ((line["forwards"] + line["weave_forwards"])
                     * (1 + 2 * line["layers"]))
            if (got["ar_rmsnorm_peer"] != slots or got["ar_rmsnorm"]
                    or got["fused_residual_rmsnorm"]):
                raise AssertionError(f"pg_ring launches {got}, expected "
                                     f"{slots} of ar_rmsnorm_peer alone")
            peer_launches += got["ar_rmsnorm_peer"]
            group = []
            for k in range(PG_RING_WORLD):
                log = json.loads((spy_dir / f"calls_r{k}.json").read_text())
                group.append(([tuple(c) for c in log["calls"]],
                              log["digests"]))
            calls = group[0][0]
            if any(g[0] != calls for g in group) or len(calls) != slots:
                raise AssertionError("pg_ring: the ranks' K1-peer calls "
                                     "differ, or miss the slot count")
            counts = {}
            for c in calls:
                counts[c] = counts.get(c, 0) + 1
            shapes, err = check_peer_shapes(torch, spy_dir, counts)
            worst = max(worst, err)
        finally:
            shutil.rmtree(spy_dir, ignore_errors=True)
        # the rank axis's ring at tp=2 on the same seeded weights
        cfg = get_config("llama3.3-70b")
        cfg = (cfg.reduced() if reduced
               else dataclasses.replace(cfg, num_layers=4))
        api = build_model(cfg, ParallelConfig(
            comm_mode="ring", attn_impl="pallas", use_pallas_norm=True),
            tp=PG_RING_WORLD)
        params = api.init(seed, device="cuda")
        rng = np.random.RandomState(seed)
        prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
                   for n in PROMPT_LENS]
        eng = Engine(api, params, SchedulerConfig())
        for i, p in enumerate(prompts):
            eng.add_request(Request(rid=i, prompt=p,
                                    max_new_tokens=NEW_TOKENS))
        done, axis_calls, axis = rank_axis_calls(torch, eng.run)
        done = {r.rid: r.output for r in done}
        want = [done[i] for i in range(len(prompts))]
        same = line["tokens"] == want
        first_diff = first_differences(line["tokens"], want)
        calls_vs_axis = first_divergence(group, axis, calls, axis_calls)
        first = calls_vs_axis["first_input_difference"]
        if first is not None:
            first["gemm_witness"] = {
                name: gemm_witness(torch, seed, first["T"], f, n,
                                   getattr(torch, cfg.dtype))
                for name, (f, n) in layer_gemms(cfg).items()}
        emit({"phase": "pg_ring", "model": line["arch"],
              "layers": line["layers"], "dtype": line["dtype"],
              "world_size": line["world_size"], "backend": line["backend"],
              "forwards": line["forwards"],
              "weave_forwards": line["weave_forwards"],
              "launches_rank0": got, "expected_peer_launches": slots,
              "wall_s_time_sliced": line["wall_s"],
              "tokens_equal_rank_axis_ring_tp2": same,
              "first_differing_token": first_diff,
              "peer_shapes": shapes, "calls_vs_rank_axis": calls_vs_axis,
              "gated": reduced, "card": card_line()})
        if reduced and not (same and calls_vs_axis["aligned"]
                            == len(calls) == len(axis_calls)):
            raise AssertionError("pg_ring float32 twin: tokens or K1 call "
                                 "shapes differ from the rank axis's ring "
                                 "at tp=2")
        del api, params, eng
        gc.collect()
        torch.cuda.empty_cache()
    return peer_launches, worst


# --------------------------------------------------------------------------
# pg_families: the MoE, ssm, hybrid, encdec and vlm families one rank per
# process, two ranks on the card
# --------------------------------------------------------------------------

# (registry name, layers (0: all of them), how it is served): MoE (ep2d at
# data size 1: every expert on both ranks, each expert's d_ff split) and
# ssm through launch.serve's engine, the hybrid, encdec and vlm by direct
# ModelApi calls (the engine cannot hold their caches)
PGF_MODELS = (("mixtral-8x22b", 4, "serve"), ("olmoe-1b-7b", 16, "serve"),
              ("qwen3-moe-235b-a22b", 4, "serve"),
              ("falcon-mamba-7b", 8, "serve"), ("zamba2-7b", 12, "direct"),
              ("whisper-base", 0, "direct"), ("qwen2-vl-7b", 4, "direct"))
PGF_PROMPT_LENS, PGF_NEW_TOKENS = (1024, 640, 384, 128), 8
# direct calls, by family: (rows, prompt tokens); the vlm's prompt follows
# a VLM_GRID x VLM_GRID patch image, Whisper's decoder prompt 1500 frames
PGF_DIRECT = {"hybrid": (2, 512), "encdec": (4, 4), "vlm": (2, 256)}
PGF_DECODE = 8
PGF_TIMEOUT_S = 900
# K1-peer launches per forward per weave split, by family: the entry norm
# and each block's slot (an encdec forward adds its encoder's when it
# encodes)
PGF_FORMULAS = {"moe": "splits·(1+2L)", "ssm": "splits·(1+L)",
                "hybrid": "splits·(1+L+n_inv)", "vlm": "splits·(1+2L)",
                "encdec": "enc_splits·(1+2L_enc) + splits·(1+3L)"}
# K3 launches per run: one call per attention layer of each prefill split
# (decode attention is not K3); the ssm has no attention
PGF_K3_FORMULAS = {"moe": "prefill_splits·L", "ssm": "0",
                   "hybrid": "splits·n_inv", "vlm": "splits·L",
                   "encdec": "enc_splits·L_enc + splits·L"}


def pgf_config(name: str, layers: int, twin: bool):
    """A PGF_MODELS model: its widths at ``layers`` (bf16), or its reduced
    float32 twin."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if twin:
        return cfg.reduced()
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def pgf_pcfg():
    from repro_torch.configs.base import ParallelConfig
    return ParallelConfig(comm_mode="ring", attn_impl="pallas",
                          use_pallas_norm=True)


def pgf_run(name: str, twin: bool) -> str:
    return f"{name}_{'twin' if twin else 'full'}"


def pgf_prompts(np, seed: int, cfg) -> list:
    """``launch.serve``'s prompts for PGF_PROMPT_LENS and ``seed``."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).tolist()
            for n in PGF_PROMPT_LENS]


class api_timings:
    """Wall ms of every ``ModelApi`` call of ``names`` (default
    ``prefill`` and ``decode_step``) while the block runs, each between
    two device syncs (under process groups the ranks' time-sliced share
    of the card and gloo's copies included), and each call's token rows
    (``rows``)."""

    def __init__(self, torch, names=("prefill", "decode_step")):
        self.torch = torch
        self.ms = {n: [] for n in names}
        self.rows = {n: [] for n in names}

    def __enter__(self):
        from repro_torch.models.build import ModelApi
        self.cls, torch = ModelApi, self.torch
        self.real = {n: getattr(ModelApi, n) for n in self.ms}

        def timed(name, fn):
            def call(api, params, tokens, *args, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(api, params, tokens, *args, **kw)
                torch.cuda.synchronize()
                self.ms[name].append((time.perf_counter() - t) * 1e3)
                self.rows[name].append(int(tokens.numel()))
                return out
            return call
        for name, fn in self.real.items():
            setattr(ModelApi, name, timed(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.cls, name, fn)
        return False


def drive_direct(torch, np, api, params, seed: int) -> dict:
    """A hybrid, encdec or vlm model by direct ``ModelApi`` calls, as the
    reference serves them: one prefill of PGF_DIRECT's rows (Zamba2: a
    512-token chunk; Whisper: 1500 stub frames and a 4-token prompt;
    Qwen2-VL: a 16 x 16 patch image and 256 text tokens with M-RoPE ids),
    its caches written (``kv_cache.insert_chunk`` / ``write_rows``), then
    PGF_DECODE greedy steps (``sharded_argmax`` over the api's context).
    Returns the tokens of every step, rows by position."""
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.runtime import kv_cache as KC

    cfg, fam, dev = api.cfg, api.cfg.family, "cuda"
    b, s = PGF_DIRECT[fam]
    dt = getattr(torch, cfg.dtype)
    rng = np.random.RandomState(seed + 23)
    rows, zero = torch.arange(b, device=dev), torch.zeros(b, device=dev)
    if fam == "vlm":
        tokens, img, ids = vlm_inputs(torch, np, seed + 23, cfg, b, VLM_GRID,
                                      s, dev, dt)
        n = VLM_GRID * VLM_GRID + s
        cache = api.init_cache(b, n + PGF_DECODE, device=dev)

        def prefill():
            return api.prefill(params, tokens, None, None,
                               mrope_positions=ids, extra_embeds=img)
    elif fam == "encdec":
        gen = torch.Generator(device=dev).manual_seed(seed + 23)
        frames = torch.randn(b, cfg.max_source_positions, cfg.d_model,
                             generator=gen, device=dev).to(dt)
        tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                              (b, s))).to(dev)
        n = s
        cache = api.init_cache(b, n + PGF_DECODE, device=dev,
                               enc_len=cfg.max_source_positions)

        def prefill():
            return api.prefill(params, tokens, None, None, frames=frames)
    else:
        tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                              (b, s))).to(dev)
        n = s
        cache = api.init_cache(b, n + PGF_DECODE, device=dev)

        def prefill():
            return api.prefill(params, tokens, cache, None)
    ctx = api.comm_ctx
    with torch.no_grad():
        logits, out = prefill()
        if fam == "hybrid":
            KC.insert_chunk(cache["shared"], out["shared"], zero, rows)
        elif fam == "encdec":
            KC.insert_chunk(cache["self"], out["self"], zero, rows)
            KC.write_rows(cache["cross"], out["cross"], rows)
        else:
            KC.insert_chunk(cache, out, zero, rows)
        del out
        outs = []
        for j in range(PGF_DECODE + 1):
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{cfg.name}: step {j}'s logits are "
                                     f"not finite")
            tok = sharded_argmax(logits, vocab_size=cfg.vocab_size, ctx=ctx)
            outs.append(tok[:, 0].tolist())
            if j == PGF_DECODE:
                break
            pos = torch.full((b, 1), n + j, dtype=torch.int32, device=dev)
            # the vlm's M-RoPE ids run on from the image's grid
            kw = ({} if fam != "vlm" else {"mrope_positions": torch.full(
                (b, 3, 1), VLM_GRID + s + j, dtype=torch.int32, device=dev)})
            logits, cache = api.decode_step(params, tok, cache, pos, **kw)
    if not all(0 <= t < cfg.vocab_size for row in outs for t in row):
        raise AssertionError(f"{cfg.name}: tokens {outs} outside the "
                             f"vocabulary")
    return {"tokens": outs, "rows": b, "prompt": n}


def direct_spied(torch, np, run_dir: Path, cfg, seed: int,
                 rank: int) -> dict:
    """One rank of a direct-call run: gloo groups over a (1, 2) mesh, K1's
    peer workspace sized by ``peer.direct_rows`` for the run's largest
    forward, the model built over the groups in comm mode ``ring`` with
    this rank's weights (``ModelApi.init``), ``drive_direct`` under
    ``k1_peer_spy``; whether both ranks emitted the same tokens."""
    import torch.distributed as dist
    from repro_torch.distributed import peer
    from repro_torch.launch.mesh import init_groups, make_mesh
    from repro_torch.models.build import build_model

    groups = init_groups(make_mesh((1, PG_RING_WORLD), ("data", "model")),
                         backend="gloo", init_method=f"file://{run_dir}/store",
                         rank=rank, world_size=PG_RING_WORLD)
    try:
        b, s = PGF_DIRECT[cfg.family]
        chunk = s + (VLM_GRID * VLM_GRID if cfg.family == "vlm" else 0)
        rows = peer.direct_rows(cfg, batch=b, chunk=chunk)
        groups = peer.attach(groups, rows=rows, d=cfg.d_model,
                             dtype=getattr(torch, cfg.dtype), device="cuda")
        api = build_model(cfg, pgf_pcfg(), tp=PG_RING_WORLD, groups=groups)
        params = api.init(seed, device="cuda")
        with k1_peer_spy(torch, run_dir, rank) as spy:
            before = spy.launches
            reset_launches()
            got = drive_direct(torch, np, api, params, seed)
            launches = dict(read_launches(),
                            ar_rmsnorm_peer=spy.launches - before)
        flat = torch.tensor([t for step in got["tokens"] for t in step],
                            device="cuda")
        lo, hi = flat.clone(), flat.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        groups.peer.close()
        return dict(got, arch=cfg.name, layers=cfg.num_layers,
                    dtype=cfg.dtype, workspace_rows=rows,
                    launches=launches,
                    ranks_agree=bool(torch.equal(lo, hi)))
    finally:
        dist.destroy_process_group()


def pgf_rank(torch, np, seed: int, rank: int, out_dir: Path) -> None:
    """One of pg_families' two processes: every PGF_MODELS model at full
    width (bf16, depth cut) and its reduced float32 twin, one after the
    other, over gloo groups with K1's cross-rank form in every add+norm
    slot (``launch.serve`` or ``direct_spied``), K3's inputs kept at the
    first call of each shape (``capture_k3_inputs``); each run's spy
    records, K3 inputs, timings and result go to ``out_dir``/<run>/."""
    import contextlib
    import io

    for name, layers, how in PGF_MODELS:
        for twin in (False, True):
            run_dir = out_dir / pgf_run(name, twin)
            run_dir.mkdir(exist_ok=True)
            cfg = pgf_config(name, layers, twin)
            k3_inputs = {}
            undo = capture_k3_inputs(k3_inputs)
            reset_launches()
            with contextlib.ExitStack() as stack:
                stack.callback(undo)
                timing = stack.enter_context(api_timings(torch))
                if how == "serve":
                    argv = ["--arch", name, "--comm-mode", "ring",
                            "--backend", "gloo", "--world-size",
                            str(PG_RING_WORLD), "--seed", str(seed),
                            "--prompt-lens",
                            ",".join(map(str, PGF_PROMPT_LENS)),
                            "--new-tokens", str(PGF_NEW_TOKENS),
                            "--init-method", f"file://{run_dir}/store",
                            "--rank", str(rank)]
                    argv += (["--reduced"] if twin
                             else ["--layers", str(layers)])
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        rc = serve_spied(torch, run_dir, argv)
                    if rc:
                        raise AssertionError(f"pg_families {name}: "
                                             f"launch.serve exit {rc}")
                    line = (json_lines(buf.getvalue()) or [{}])[0]
                else:
                    line = direct_spied(torch, np, run_dir, cfg, seed, rank)
            line["ms"] = timing.ms
            line["k3_launches"] = read_launches()["flash_attention"]
            (run_dir / f"result_r{rank}.json").write_text(json.dumps(line))
            offload(k3_inputs)
            torch.save(list(k3_inputs.values()), run_dir / f"k3_r{rank}.pt")
            del k3_inputs
            gc.collect()
            torch.cuda.empty_cache()


def pgf_expected(api, how: str, line: dict) -> int:
    """K1-peer launches a run must make (PGF_FORMULAS): per forward, per
    weave split, the entry norm and each block's slot; a forward whose
    tokens do not divide over the ranks would take the vanilla fallback
    and fail the count.  Served runs count the engine's forwards and
    weave forwards; direct runs their prefill and PGF_DECODE steps."""
    cfg = api.cfg
    if how == "serve":
        per = 1 + (2 if cfg.family == "moe" else 1) * cfg.num_layers
        return (line["forwards"] + line["weave_forwards"]) * per
    b, s = PGF_DIRECT[cfg.family]
    if cfg.family == "encdec":
        return encdec_launches(api, b, cfg.max_source_positions, s,
                               PGF_DECODE, norm_kernel="ar_rmsnorm"
                               )["ar_rmsnorm"]
    slots = (cfg.num_layers + cfg.num_layers // cfg.shared_attn_period
             if cfg.family == "hybrid" else 2 * cfg.num_layers)
    n = s + (VLM_GRID * VLM_GRID if cfg.family == "vlm" else 0)
    return (norm_launches(api, b, n, decode=False, slots=slots)
            + PGF_DECODE * norm_launches(api, b, 1, decode=True,
                                         slots=slots))


def pgf_k3_expected(api, how: str, line: dict) -> int:
    """K3 launches a run must make (PGF_K3_FORMULAS): one call per
    attention layer of each prefill split.  Served runs count the
    engine's prefill forwards and their weave splits
    (``launch.serve``'s ``prefill_splits``); direct runs their one
    prefill, Whisper's encoder split apart."""
    from repro_torch.models import transformer as TR
    cfg = api.cfg
    if how == "serve":
        return line["prefill_splits"] * (cfg.num_layers
                                         if cfg.family == "moe" else 0)
    b, s = PGF_DIRECT[cfg.family]
    if cfg.family == "encdec":
        return encdec_launches(api, b, cfg.max_source_positions, s,
                               PGF_DECODE, norm_kernel="ar_rmsnorm"
                               )["flash_attention"]
    n = s + (VLM_GRID * VLM_GRID if cfg.family == "vlm" else 0)
    splits = 1 + TR.weave_decision_info(b, n, tp=api.tp,
                                        pcfg=api.pcfg).weave
    return splits * (cfg.num_layers // cfg.shared_attn_period
                     if cfg.family == "hybrid" else cfg.num_layers)


def pgf_check_k3(torch, run_dir: Path, name: str, want: int,
                 ranks=range(PG_RING_WORLD)) -> tuple:
    """K3 on each rank's kept inputs, shape by shape, against its plain
    version (``check_main_path_k3``; a run whose formula gives no K3 call
    must have kept none).  Returns (K3's max error, the shapes held)."""
    err, shapes = 0.0, []
    for k in ranks:
        kept = torch.load(run_dir / f"k3_r{k}.pt")
        if not want:
            if kept:
                raise AssertionError(f"pg_families {name}: K3 ran where "
                                     f"the family has no attention")
            continue
        shapes += [[list(t[0].shape), list(t[1].shape), str(t[0].dtype)[6:],
                    kw.get("causal", True)] for t, kw in kept]
        err = max(err, check_main_path_k3(
            torch, dict(enumerate(kept)), f"pg_families {name} rank {k}",
            PG_RING_WORLD))
    return err, shapes


def pgf_rank_axis(torch, np, cfg, how: str, seed: int):
    """The rank axis's ``ring`` at tp=2 on the card on the same seeded
    weights and inputs: (tokens, K1's calls, their digests)."""
    from repro_torch.models.build import build_model
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    api = build_model(cfg, pgf_pcfg(), tp=PG_RING_WORLD)
    params = api.init(seed, device="cuda")
    if how == "direct":
        got, calls, digests = rank_axis_calls(
            torch, lambda: drive_direct(torch, np, api, params, seed))
        return got["tokens"], calls, digests
    prompts = pgf_prompts(np, seed, cfg)
    eng = Engine(api, params, SchedulerConfig())
    for i, p in enumerate(prompts):
        eng.add_request(Request(rid=i, prompt=p,
                                max_new_tokens=PGF_NEW_TOKENS))
    done, calls, digests = rank_axis_calls(torch, eng.run)
    done = {r.rid: r.output for r in done}
    return [done[i] for i in range(len(prompts))], calls, digests


def pgf_check(torch, np, seed: int, run_dir: Path, name: str, layers: int,
              how: str, twin: bool) -> tuple:
    """One pg_families run's gates: the ranks' tokens and K1-peer calls
    equal, K1-peer launches equal the family's formula (no other add+norm
    kernel), every served (T, CTAs) bit-equal to the one-card K1 on the
    stacked inputs (``check_peer_shapes``); K3's launches equal the
    family's K3 formula, on both ranks, and K3 within its tolerance of
    the plain version on each rank's inputs at every shape
    (``pgf_check_k3``); a twin's tokens and K1 calls equal to the rank
    axis's ring at tp=2.  Emits its line; returns (rank 0's K1-peer
    launches, the largest K1-peer error against the plain version, the
    served shapes, rank 0's K3 launches, K3's largest error)."""
    from repro_torch.models.build import build_model

    cfg = pgf_config(name, layers, twin)
    res = [json.loads((run_dir / f"result_r{k}.json").read_text())
           for k in range(PG_RING_WORLD)]
    line = res[0]
    tokens = line["tokens"]
    if how == "direct" and res[1]["tokens"] != tokens:
        raise AssertionError(f"pg_families {name}: the ranks' tokens differ")
    if not line["ranks_agree"]:
        raise AssertionError(f"pg_families {name}: the ranks' tokens differ")
    api = build_model(cfg, pgf_pcfg(), tp=PG_RING_WORLD)
    want = pgf_expected(api, how, line)
    got = line["launches"]
    if (got["ar_rmsnorm_peer"] != want or got.get("ar_rmsnorm")
            or got.get("fused_residual_rmsnorm")):
        raise AssertionError(f"pg_families {name}: launches {got}, expected "
                             f"{want} of ar_rmsnorm_peer alone")
    want_k3 = pgf_k3_expected(api, how, line)
    k3_counts = [got["flash_attention"]] + [r["k3_launches"] for r in res]
    if any(n != want_k3 for n in k3_counts):
        raise AssertionError(f"pg_families {name}: K3 launches {k3_counts} "
                             f"(rank 0's run, each rank's process), "
                             f"expected {want_k3}")
    k3_err, k3_shapes = pgf_check_k3(torch, run_dir, name, want_k3)
    group = []
    for k in range(PG_RING_WORLD):
        log = json.loads((run_dir / f"calls_r{k}.json").read_text())
        group.append(([tuple(c) for c in log["calls"]], log["digests"]))
    calls = group[0][0]
    if any(g[0] != calls for g in group) or len(calls) != want:
        raise AssertionError(f"pg_families {name}: the ranks' K1-peer calls "
                             f"differ, or miss the slot count")
    counts = {}
    for c in calls:
        counts[c] = counts.get(c, 0) + 1
    shapes, err = check_peer_shapes(torch, run_dir, counts,
                                    label=f"pg_families {name}")
    out = {"phase": "pg_families", "model": cfg.name, "family": cfg.family,
           "served_by": ("launch.serve" if how == "serve"
                         else "ModelApi direct calls"),
           "layers": cfg.num_layers, "layers_cut_from": (
               None if twin else pgf_config(name, 0, False).num_layers),
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "world_size": PG_RING_WORLD, "backend": "gloo",
           "launches_rank0": got, "expected_peer_launches": want,
           "formula": PGF_FORMULAS[cfg.family],
           "expected_k3_launches": want_k3,
           "k3_formula": PGF_K3_FORMULAS[cfg.family],
           "k3_shapes_held": k3_shapes, "k3_max_abs_err": k3_err,
           "ranks_agree": True, "tokens_rank0": tokens,
           "peer_shapes": shapes,
           "prefill_ms": [r["ms"]["prefill"] for r in res],
           "decode_ms": [r["ms"]["decode_step"] for r in res],
           "decode_ms_median": [statistics.median(r["ms"]["decode_step"])
                                for r in res],
           "gated": True, "card": card_line()}
    if how == "serve":
        out.update(forwards=line["forwards"],
                   weave_forwards=line["weave_forwards"],
                   wall_s_time_sliced=line["wall_s"],
                   prompt_lens=list(PGF_PROMPT_LENS),
                   new_tokens=PGF_NEW_TOKENS)
    else:
        out.update(rows=line["rows"], prompt=line["prompt"],
                   decode_steps=PGF_DECODE,
                   workspace_rows=line["workspace_rows"])
    if twin:
        axis_tokens, axis_calls, axis = pgf_rank_axis(torch, np, cfg, how,
                                                      seed)
        same = axis_tokens == tokens
        calls_vs_axis = first_divergence(group, axis, calls, axis_calls)
        out.update(tokens_equal_rank_axis_ring_tp2=same,
                   calls_vs_rank_axis=calls_vs_axis)
        emit(out)
        if not (same and calls_vs_axis["aligned"] == len(calls)
                == len(axis_calls)):
            raise AssertionError(f"pg_families {name} float32 twin: tokens "
                                 f"or K1 call shapes differ from the rank "
                                 f"axis's ring at tp=2")
    else:
        emit(out)
    return (got["ar_rmsnorm_peer"], err, [(r["T"], r["d"], cfg.dtype)
                                          for r in shapes],
            got["flash_attention"], k3_err)


def pgf_shape_cases(served: dict) -> list:
    """The K1-peer shapes pg_families times: per full-width model its
    largest served T (a prefill split) and its smallest (a decode
    step)."""
    cases = []
    for shapes in served.values():
        ts = sorted({t for t, _, _ in shapes})
        for t in sorted({ts[0], ts[-1]}):
            d, dtype = shapes[0][1], shapes[0][2]
            if (t, d, dtype) not in cases:
                cases.append((t, d, dtype))
    return cases


def pg_families_phase(torch, np, seed: int) -> tuple:
    """The MoE (Mixtral ``ffn``, OLMoE ``expert``), ssm (Falcon-Mamba),
    hybrid (Zamba2), encdec (Whisper) and vlm (Qwen2-VL) families in comm
    mode ``ring`` one model rank per process: two processes on the card
    (``pgf_rank``; gloo carries the groups' collectives, CUDA IPC K1's
    peer buffers), each model at full width with its depth cut and as
    its reduced float32 twin, gated by ``pgf_check``; then K1's cross-
    rank form at N 2 timed at each full-width model's largest and
    smallest served rows, in a process of its own (``k1_peer_local``).
    Returns (rank 0's K1-peer launches over every run, the largest K1-peer
    error against the plain version, rank 0's K3 launches over every
    run, K3's largest error on the runs' inputs)."""
    import os
    import tempfile

    t0 = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="pg_families_"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    me = [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
          "--pg-families-dir", str(out_dir), "--pg-families-rank"]
    launches, worst, served, k3_launches, k3_err = 0, 0.0, {}, 0, 0.0
    try:
        run_children([me + [str(k)] for k in range(PG_RING_WORLD)],
                     cwd=ROOT, env=env, timeout=PGF_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        for name, layers, how in PGF_MODELS:
            for twin in (False, True):
                n, err, shapes, n_k3, err_k3 = pgf_check(
                    torch, np, seed, out_dir / pgf_run(name, twin), name,
                    layers, how, twin)
                launches += n
                worst = max(worst, err)
                k3_launches += n_k3
                k3_err = max(k3_err, err_k3)
                if not twin:
                    served[name] = shapes
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    cases = pgf_shape_cases(served)
    env = dict(os.environ, CUDA_DEVICE_MAX_CONNECTIONS="32")
    out, = run_children([[sys.executable, str(Path(__file__).resolve()),
                          "--seed", str(seed), "--k1-peer-local",
                          "--k1-peer-cases", json.dumps(cases)]],
                        cwd=ROOT, env=env, timeout=K1P_TIMEOUT_S)
    card = card_line()
    for ln in json_lines(out)[:-1]:
        emit(dict(ln, phase="k1_peer_families", card=card))
    worst = max(worst, json_lines(out)[-1]["k1_peer_local"]["max_abs_err"])
    emit({"phase": "pg_families_seconds", "ranks_s": ranks_s,
          "seconds": time.perf_counter() - t0})
    return launches, worst, k3_launches, k3_err


# --------------------------------------------------------------------------
# pg_data: the data group over process groups, four (data, model) ranks on
# the card
# --------------------------------------------------------------------------

PGD_MESH = (2, 2)                  # (data, model): world rank = d·2 + m
PGD_WORLD = PGD_MESH[0] * PGD_MESH[1]
PGD_TIMEOUT_S = 600
# the runs, in order: Qwen3-MoE-235B at full width (bf16, QWEN3_LAYERS),
# the batch over data; then float32 twins, TF32 off: identity_data_phase's
# ep2d model and a reduced dense model with the batch over data, and the
# reduced Zamba2 decoding context-parallel over the data group
PGD_RUNS = ("qwen3_full", "ep2d_twin", "dense_twin", "hybrid_cp_twin")
PGD_TWIN_ROWS, PGD_TWIN_LEN, PGD_TWIN_DECODE = 4, 48, 4
PGD_CP_ROWS, PGD_CP_SLOTS, PGD_CP_LEN = 2, 256, 200
PGD_LOGIT_TOL = 1e-5               # float32 twins against the rank axis


def pgd_model(run: str):
    """(cfg, pcfg, how) of a pg_data run: ``how`` is "batch" (the batch
    over the data group: a prefill, its KV written, greedy decode steps)
    or "cp" (context-parallel decode from a seeded cache)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    if run == "qwen3_full":
        return (dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                                    num_layers=QWEN3_LAYERS),
                pgf_pcfg(), "batch")
    base = dict(comm_mode="ring", attn_impl="pallas", use_pallas_norm=True,
                split_unit=16, tokenweave_min_tokens=32)
    if run == "ep2d_twin":
        return (ModelConfig(name="small-moe-ep2d", family="moe",
                            num_layers=2, d_model=256, num_heads=8,
                            num_kv_heads=2, head_dim=32, d_ff=512,
                            vocab_size=509, num_experts=4,
                            num_experts_per_tok=2, moe_d_ff=256,
                            moe_partition="ep2d", qk_norm=True,
                            dtype="float32"),
                ParallelConfig(**base), "batch")
    if run == "dense_twin":
        return (dataclasses.replace(get_config("llama3.3-70b").reduced(),
                                    vocab_size=509),
                ParallelConfig(**base), "batch")
    return (dataclasses.replace(get_config("zamba2-7b").reduced(),
                                vocab_size=509),
            ParallelConfig(seq_shard_kv=True, **base), "cp")


def pgd_shape(run: str) -> tuple:
    """(global rows, prompt tokens, decode steps) of a pg_data run."""
    if run == "qwen3_full":
        return EP2D_ROWS, EP2D_LEN, PGF_DECODE
    if run == "hybrid_cp_twin":
        return PGD_CP_ROWS, PGD_CP_LEN, PGF_DECODE
    return PGD_TWIN_ROWS, PGD_TWIN_LEN, PGD_TWIN_DECODE


def pgd_cut(tree, like, groups):
    """A process's part of a rank-axis tree of tensors (dicts and lists):
    on each axis where ``like`` (the process's tree) is smaller, the model
    rank's slice (1 of tp) or the data rank's 1/D (rows or cache slots)."""
    if isinstance(tree, dict):
        return {k: pgd_cut(v, like[k], groups) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [pgd_cut(v, w, groups) for v, w in zip(tree, like)]
        return out if isinstance(tree, list) else tuple(out)
    t = tree
    for a, (m, n) in enumerate(zip(tree.shape, like.shape)):
        if m == n:
            continue
        if n == 1 and m == groups.model_size:
            t = t.narrow(a, groups.model_rank, 1)
        elif m == n * groups.data_size:
            t = t.narrow(a, groups.data_rank * n, n)
        else:
            raise AssertionError(f"pgd_cut: {tuple(tree.shape)} against "
                                 f"{tuple(like.shape)}")
    return t.contiguous()


def pgd_cp_cache(torch, np, seed: int, cfg, pcfg):
    """The context-parallel run's seeded rank-axis cache on the CPU (tp=2,
    D = 2): every float 0.5·N(0, 1), each row holding its PGD_CP_LEN
    positions; and the first step's tokens."""
    from repro_torch.models.build import build_model

    def fill(t, rng):
        if isinstance(t, dict):
            return {k: fill(v, rng) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [fill(v, rng) for v in t]
            return out if isinstance(t, list) else tuple(out)
        if t.dtype.is_floating_point:
            return torch.from_numpy(
                (0.5 * rng.randn(*t.shape)).astype(np.float32))
        pos = np.full(t.shape, -1, np.int32)
        pos[:, :PGD_CP_LEN] = np.arange(PGD_CP_LEN)
        return torch.from_numpy(pos)
    api = build_model(cfg, pcfg, tp=PGD_MESH[1], ep=PGD_MESH[0])
    rng = np.random.RandomState(seed + 51)
    cache = fill(api.init_cache(PGD_CP_ROWS, PGD_CP_SLOTS, device="cpu"),
                 rng)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (PGD_CP_ROWS, 1)))
    return cache, tokens


def pgd_drive(torch, np, api, params, seed: int, run: str) -> dict:
    """One pg_data run through ``api`` (the rank axis at D = 2 x R = 2, or
    one process of the groups) by direct ``ModelApi`` calls: for "batch"
    runs a prefill of the seeded global batch (a process takes its data
    shard's rows), its KV written into a slot cache, then greedy decode
    steps; for "cp" greedy context-parallel decode steps from the seeded
    cache (a process takes its part of it).  Returns the tokens of every
    step, rows by position, and the first logits on the host."""
    from repro_torch.layers.embedding import sharded_argmax
    from repro_torch.runtime import kv_cache as KC

    cfg, pcfg, how = pgd_model(run)
    b, s, steps = pgd_shape(run)
    groups, dev = api.groups, "cuda"
    ctx = api.comm_ctx
    outs = []
    with torch.no_grad():
        if how == "batch":
            rng = np.random.RandomState(seed + 40)
            tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                  (b, s)))
            if groups is not None:
                n = b // groups.data_size
                tokens = tokens[groups.data_rank * n:
                                (groups.data_rank + 1) * n]
            rows = tokens.shape[0]
            cache = api.init_cache(b, s + steps, device=dev)
            logits, kv = api.prefill(params, tokens.to(dev), None, None)
            KC.insert_chunk(cache, kv, torch.zeros(rows, device=dev),
                            torch.arange(rows, device=dev))
            del kv
            first = logits.float().cpu()
            tok = sharded_argmax(logits, vocab_size=cfg.vocab_size, ctx=ctx)
            start = s
        else:
            cache, tok = pgd_cp_cache(torch, np, seed, cfg, pcfg)
            if groups is not None:
                cache = pgd_cut(cache, api.init_cache(
                    PGD_CP_ROWS, PGD_CP_SLOTS, device="cpu"), groups)
            cache = to_device(cache, dev)
            tok, rows, first, start = tok.to(dev), PGD_CP_ROWS, None, s
        for j in range(steps):
            outs.append(tok[:, 0].tolist())
            pos = torch.full((rows, 1), start + j, dtype=torch.int32,
                             device=dev)
            logits, cache = api.decode_step(params, tok, cache, pos)
            if first is None:
                first = logits.float().cpu()
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"pg_data {run}: step {j}'s logits are "
                                     f"not finite")
            tok = sharded_argmax(logits, vocab_size=cfg.vocab_size, ctx=ctx)
        outs.append(tok[:, 0].tolist())
    if not all(0 <= t < cfg.vocab_size for row in outs for t in row):
        raise AssertionError(f"pg_data {run}: tokens {outs} outside the "
                             f"vocabulary")
    return {"tokens": outs, "first": first}


class a2a_spy:
    """Each ``collectives.all_to_all`` call while the block runs: the rows'
    bytes a process sends and its wall ms between two device syncs
    (time-sliced with the other ranks, gloo's host staging included)."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from repro_torch.distributed import collectives as COL
        self.mod, self.real = COL, COL.all_to_all
        torch, real, calls = self.torch, self.real, self.calls

        def spy(x, ctx, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(x, ctx, **kw)
            torch.cuda.synchronize()
            calls.append((x.numel() * x.element_size(),
                          (time.perf_counter() - t) * 1e3))
            return out
        COL.all_to_all = spy
        return self

    def __exit__(self, *exc):
        self.mod.all_to_all = self.real
        return False


def pgd_rank(torch, np, seed: int, rank: int, out_dir: Path) -> None:
    """One of pg_data's four processes: gloo groups over a (data 2, model
    2) mesh, then every PGD_RUNS run over them in comm mode ``ring`` (K1's
    cross-rank form in every add+norm slot, over its model group's peer
    workspace sized by ``peer.direct_rows`` for one data shard's rows),
    this rank's weights (``ModelApi.init``: its model rank's slice, its
    data shard's ep2d experts), under ``k1_peer_spy``, ``a2a_spy`` and
    ``api_timings``, K3's inputs kept at the first call of each shape;
    each run's result, spy records and K3 inputs go to ``out_dir``/<run>/."""
    import contextlib

    import torch.distributed as dist
    from repro_torch.distributed import peer
    from repro_torch.launch.mesh import init_groups, make_mesh
    from repro_torch.models.build import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    base = init_groups(make_mesh(PGD_MESH, ("data", "model")),
                       backend="gloo", init_method=f"file://{out_dir}/store",
                       rank=rank, world_size=PGD_WORLD)
    try:
        for run in PGD_RUNS:
            run_dir = out_dir / run
            run_dir.mkdir(exist_ok=True)
            cfg, pcfg, how = pgd_model(run)
            b, s, _ = pgd_shape(run)
            rows = peer.direct_rows(cfg, batch=b, chunk=s if how == "batch"
                                    else 1, dp=1 if how == "cp"
                                    else PGD_MESH[0])
            groups = peer.attach(base, rows=rows, d=cfg.d_model,
                                 dtype=getattr(torch, cfg.dtype),
                                 device="cuda")
            api = build_model(cfg, pcfg, tp=PGD_MESH[1], ep=PGD_MESH[0],
                              groups=groups)
            params = api.init(seed, device="cuda")
            k3_inputs = {}
            undo = capture_k3_inputs(k3_inputs)
            reset_launches()
            with contextlib.ExitStack() as stack:
                stack.callback(undo)
                timing = stack.enter_context(api_timings(torch))
                a2a = stack.enter_context(a2a_spy(torch))
                spy = stack.enter_context(k1_peer_spy(torch, run_dir, rank))
                before = spy.launches
                got = pgd_drive(torch, np, api, params, seed, run)
                launches = dict(read_launches(),
                                ar_rmsnorm_peer=spy.launches - before)
            torch.save(got.pop("first"), run_dir / f"logits_r{rank}.pt")
            (run_dir / f"result_r{rank}.json").write_text(json.dumps(dict(
                got, launches=launches, ms=timing.ms, a2a=a2a.calls,
                workspace_rows=rows, coords=[groups.data_rank,
                                             groups.model_rank])))
            offload(k3_inputs)
            torch.save(list(k3_inputs.values()), run_dir / f"k3_r{rank}.pt")
            groups.peer.close()
            del params, api, k3_inputs, groups
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def pgd_expected(run: str) -> tuple:
    """(K1-peer launches, K3 launches) each process of a run must make:
    per forward, per weave split, the entry norm and each block's slot
    (none where a shard's tokens do not divide over the ranks: the
    vanilla fallback), K3 once per attention layer of each prefill
    split."""
    from repro_torch.models import transformer as TR
    from repro_torch.models.build import build_model
    cfg, pcfg, how = pgd_model(run)
    b, s, steps = pgd_shape(run)
    # the rank axis at data size 1 runs one shard's rows as a process does
    one = build_model(cfg, pcfg, tp=PGD_MESH[1],
                      ep=PGD_MESH[0] if how == "cp" else 1)
    if how == "cp":
        slots = cfg.num_layers + cfg.num_layers // cfg.shared_attn_period
        return steps * norm_launches(one, b, 1, decode=True,
                                     slots=slots), 0
    b //= PGD_MESH[0]
    slots = 2 * cfg.num_layers
    splits = 1 + TR.weave_decision_info(b, s, tp=PGD_MESH[1],
                                        pcfg=pcfg).weave
    return (norm_launches(one, b, s, decode=False, slots=slots)
            + steps * norm_launches(one, b, 1, decode=True, slots=slots),
            splits * cfg.num_layers)


def pgd_check(torch, np, seed: int, run_dir: Path, run: str) -> tuple:
    """One pg_data run's gates: the model ranks of each data shard emit
    equal tokens (every rank, for the context-parallel run), each
    process's K1-peer launches equal ``pgd_expected``'s and its calls its
    model group's, no other add+norm kernel, the peer kernel bit-equal to
    the one-card K1 at every (T, CTAs) each model group served
    (``check_peer_shapes``), K3's launches on every rank equal the
    formula and K3 within its tolerance on every rank's inputs; a twin's
    tokens equal to the rank axis's at D = 2 x R = 2 and each rank's
    first logits within PGD_LOGIT_TOL of its slice (bf16: the tokens
    reported).  Emits its line; returns (rank 0's K1-peer launches, the
    worst K1-peer error, rank 0's K3 launches, K3's worst error)."""
    from repro_torch.models.build import build_model

    cfg, pcfg, how = pgd_model(run)
    twin = run != "qwen3_full"
    res = [json.loads((run_dir / f"result_r{w}.json").read_text())
           for w in range(PGD_WORLD)]
    tp = PGD_MESH[1]
    for w, r in enumerate(res):
        if r["coords"] != list(divmod(w, tp)):
            raise AssertionError(f"pg_data {run}: rank {w} at {r['coords']}")
    shards = [[w for w in range(PGD_WORLD) if w // tp == d]
              for d in range(PGD_MESH[0])]
    same = (range(PGD_WORLD),) if how == "cp" else shards
    for ranks in same:
        if any(res[w]["tokens"] != res[ranks[0]]["tokens"] for w in ranks):
            raise AssertionError(f"pg_data {run}: ranks {list(ranks)}' "
                                 f"tokens differ")
    want, want_k3 = pgd_expected(run)
    for w, r in enumerate(res):
        got = r["launches"]
        if (got["ar_rmsnorm_peer"] != want or got["ar_rmsnorm"]
                or got["fused_residual_rmsnorm"]
                or got["flash_attention"] != want_k3):
            raise AssertionError(f"pg_data {run} rank {w}: launches {got}, "
                                 f"expected {want} of ar_rmsnorm_peer alone "
                                 f"and {want_k3} of flash_attention")
    worst, shapes = 0.0, []
    for d, ranks in enumerate(shards):
        group = [json.loads((run_dir / f"calls_r{w}.json").read_text())
                 ["calls"] for w in ranks]
        if any(g != group[0] for g in group) or len(group[0]) != want:
            raise AssertionError(f"pg_data {run}: data shard {d}'s model "
                                 f"ranks made other K1-peer calls")
        counts = {}
        for c in group[0]:
            counts[tuple(c)] = counts.get(tuple(c), 0) + 1
        rows, err = check_peer_shapes(torch, run_dir, counts,
                                      label=f"pg_data {run} shard {d}",
                                      ranks=ranks)
        worst = max(worst, err)
        shapes += [dict(row, data_shard=d) for row in rows]
    k3_err, k3_shapes = pgf_check_k3(torch, run_dir, f"pg_data {run}",
                                     want_k3, ranks=range(PGD_WORLD))
    # the rank axis at D = 2 x R = 2 on the card, the same seeded weights
    axis = build_model(cfg, pcfg, tp=tp, ep=PGD_MESH[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    params = axis.init(seed, device="cuda")
    ref = pgd_drive(torch, np, axis, params, seed, run)
    del params
    n = len(ref["tokens"][0]) // (1 if how == "cp" else PGD_MESH[0])
    tokens_equal, logit_err = [], 0.0
    for w, r in enumerate(res):
        d, m = divmod(w, tp)
        lo = 0 if how == "cp" else d * n
        tokens_equal.append(r["tokens"] == [row[lo:lo + n]
                                            for row in ref["tokens"]])
        mine = torch.load(run_dir / f"logits_r{w}.pt")
        logit_err = max(logit_err, max_err(
            mine, ref["first"][m:m + 1, lo:lo + n]))
    a2a = [r["a2a"] for r in res]
    out = {"phase": "pg_data", "run": run, "model": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "mesh": {"data": PGD_MESH[0],
                                        "model": PGD_MESH[1]},
           "backend": "gloo", "comm_mode": pcfg.comm_mode,
           "how": ("the batch over the data group" if how == "batch"
                   else "context-parallel decode over the data group"),
           "rows_per_process": len(res[0]["tokens"][0]),
           "workspace_rows": res[0]["workspace_rows"],
           "launches_rank0": res[0]["launches"],
           "expected_peer_launches": want, "expected_k3_launches": want_k3,
           "k3_shapes_held": k3_shapes, "k3_max_abs_err": k3_err,
           "peer_shapes": shapes, "tokens_rank0": res[0]["tokens"],
           "tokens_equal_rank_axis": tokens_equal,
           "first_logits_max_abs_err_vs_rank_axis": logit_err,
           "all_to_all_calls": [len(c) for c in a2a],
           "all_to_all_bytes_rank0": sum(nb for nb, _ in a2a[0]),
           "all_to_all_ms_per_call": [
               statistics.median(ms for _, ms in c) if c else None
               for c in a2a],
           "all_to_all_ms_by_bytes_rank0": {
               str(nb): [ms for b, ms in a2a[0] if b == nb]
               for nb in sorted({b for b, _ in a2a[0]})},
           "prefill_ms": [r["ms"]["prefill"] for r in res],
           "decode_ms_median": [statistics.median(r["ms"]["decode_step"])
                                for r in res],
           "gated": twin, "card": card_line()}
    emit(out)
    if twin and not (all(tokens_equal) and logit_err <= PGD_LOGIT_TOL):
        raise AssertionError(f"pg_data {run}: tokens {tokens_equal} or "
                             f"first logits (max error {logit_err}) differ "
                             f"from the rank axis's at D = 2 x R = 2")
    if cfg.moe_partition == "ep2d" and not all(a2a):
        raise AssertionError(f"pg_data {run}: a rank made no all-to-all")
    return (res[0]["launches"]["ar_rmsnorm_peer"], worst,
            res[0]["launches"]["flash_attention"], k3_err)


def pg_data_phase(torch, np, seed: int) -> tuple:
    """The data group one (data, model) rank per process: four processes
    on the card (``pgd_rank``; gloo carries the groups' collectives and
    ``ep2d``'s all-to-alls, CUDA IPC each model group's K1 peer buffers)
    run PGD_RUNS, gated by ``pgd_check``.  Returns (rank 0's K1-peer
    launches over every run, the worst K1-peer error, rank 0's K3
    launches, K3's worst error)."""
    import os
    import tempfile

    t0 = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="pg_data_"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    me = [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
          "--pg-data-dir", str(out_dir), "--pg-data-rank"]
    launches, worst, k3_launches, k3_err = 0, 0.0, 0, 0.0
    try:
        run_children([me + [str(k)] for k in range(PGD_WORLD)], cwd=ROOT,
                     env=env, timeout=PGD_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        for run in PGD_RUNS:
            n, err, n_k3, err_k3 = pgd_check(torch, np, seed, out_dir / run,
                                             run)
            launches += n
            worst = max(worst, err)
            k3_launches += n_k3
            k3_err = max(k3_err, err_k3)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "pg_data_seconds", "ranks_s": ranks_s,
          "seconds": time.perf_counter() - t0})
    return launches, worst, k3_launches, k3_err


# --------------------------------------------------------------------------
# pg_spec: speculative decoding one model rank per process, two ranks on
# the card
# --------------------------------------------------------------------------

PGS_GAMMA, PGS_NEW_TOKENS = 3, 32
PGS_TIMEOUT_S = 900
# a temperature low enough that the random target gives the n-gram
# proposals a share of its mass: the draws accept some and reject some
PGS_STOCHASTIC = ("--temperature", "0.2", "--top-p", "0.9")
# the runs, each at full width (Llama-3.3-70B, 4 layers, bf16) and as the
# reduced float32 twin, in order: spec off, then the n-gram draft over
# legacy slots (two-dispatch) and packed over the pool, the target as its
# own model draft packed; the twin adds a seeded stochastic packed run
PGS_RUNS = {"off": (), "ngram_slots": (),
            "ngram_packed": ("--packed",),
            "model_packed": ("--packed", "--draft", "model"),
            "stochastic": ("--packed",) + PGS_STOCHASTIC}
PGS_TIMED = ("prefill", "decode_step", "verify_step", "packed_step",
             "forward")


def pgs_runs(twin: bool) -> list:
    return [(name, twin) for name in PGS_RUNS
            if twin or name != "stochastic"]


def pgs_argv(seed: int, name: str, twin: bool) -> list:
    """``launch.serve``'s argv for a pg_spec run (no rank, no store)."""
    argv = ["--arch", "llama3.3-70b", "--comm-mode", "ring", "--backend",
            "gloo", "--world-size", str(PG_RING_WORLD), "--seed", str(seed),
            "--prompt-lens", ",".join(map(str, PROMPT_LENS)),
            "--new-tokens", str(PGS_NEW_TOKENS), "--lookup"]
    argv += ["--reduced"] if twin else ["--layers", "4"]
    if name != "off":
        argv += ["--spec-gamma", str(PGS_GAMMA), *PGS_RUNS[name]]
    return argv


def pgs_dir(name: str, twin: bool) -> str:
    return f"{name}_{'twin' if twin else 'full'}"


def pgs_rank(torch, np, seed: int, rank: int, out_dir: Path) -> None:
    """One of pg_spec's two processes: every run of ``pgs_runs`` through
    ``launch.serve``'s ``main`` under ``k1_peer_spy`` (K1's cross-rank
    form in every add+norm slot of the target's and the draft's forwards),
    ``api_timings`` over PGS_TIMED, K3's inputs kept at the first call of
    each shape and each model-draft rollout forward's (rows, length);
    each run's result, spy records and K3 inputs go to
    ``out_dir``/<run>/."""
    import contextlib
    import io

    from repro_torch.runtime import spec as SP

    torch.backends.cuda.matmul.allow_tf32 = False
    for twin in (False, True):
        for name, _ in pgs_runs(twin):
            run_dir = out_dir / pgs_dir(name, twin)
            run_dir.mkdir(exist_ok=True)
            argv = pgs_argv(seed, name, twin) + [
                "--init-method", f"file://{run_dir}/store", "--rank",
                str(rank)]
            k3_inputs, rollouts = {}, []
            real_next = SP.ModelDraft._next_tokens

            def next_tokens(draft, tokens, *a, real_next=real_next,
                            rollouts=rollouts):
                rollouts.append(list(tokens.shape))
                return real_next(draft, tokens, *a)
            undo = capture_k3_inputs(k3_inputs)
            reset_launches()
            buf = io.StringIO()
            with contextlib.ExitStack() as stack:
                stack.callback(undo)
                stack.callback(setattr, SP.ModelDraft, "_next_tokens",
                               real_next)
                SP.ModelDraft._next_tokens = next_tokens
                timing = stack.enter_context(api_timings(torch, PGS_TIMED))
                stack.enter_context(contextlib.redirect_stdout(buf))
                rc = serve_spied(torch, run_dir, argv)
            if rc:
                raise AssertionError(f"pg_spec {pgs_dir(name, twin)}: "
                                     f"launch.serve exit {rc}")
            line = (json_lines(buf.getvalue()) or [{}])[0]
            line.update(ms=timing.ms, rows=timing.rows, rollouts=rollouts,
                        k3_launches=read_launches()["flash_attention"])
            (run_dir / f"result_r{rank}.json").write_text(json.dumps(line))
            offload(k3_inputs)
            torch.save(list(k3_inputs.values()), run_dir / f"k3_r{rank}.pt")
            del k3_inputs
            gc.collect()
            torch.cuda.empty_cache()


def pgs_expected(cfg, line: dict, rollouts: list) -> tuple:
    """(K1-peer launches, K3 launches) a run must make: per forward, per
    weave split, the entry norm and each block's two slots, the target's
    forwards (``launch.serve``'s forwards and weave forwards) and the
    model draft's rollout forwards alike (their weave decided as a
    prefill's; the draft is the target's model, L layers); K3 once per
    attention layer of each prefill split, of each packed step's split
    (verify windows are segments) and of each rollout forward's
    split."""
    from repro_torch.models import transformer as TR
    pcfg = pgf_pcfg()
    splits = line["forwards"] + line["weave_forwards"]
    k3 = (splits if line["spec"]["packed"]
          else line["prefill_splits"]) * cfg.num_layers
    peer = splits * (1 + 2 * cfg.num_layers)
    for b, s in rollouts:
        n = 1 + TR.weave_decision_info(b, s, tp=PG_RING_WORLD,
                                       pcfg=pcfg).weave
        peer += n * (1 + 2 * cfg.num_layers)
        k3 += n * cfg.num_layers
    return peer, k3


def pgs_rank_axis(torch, np, argv: list):
    """The rank axis's ``ring`` engine at tp=2 on the card with the
    launcher's weights, prompts, scheduler, draft and sampling for
    ``argv``: (tokens, ``spec`` counters)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.build import build_model
    from repro_torch.runtime import spec as SP
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    args = serve.parse(argv)
    cfg = get_config(args.arch)
    cfg = (cfg.reduced() if args.reduced
           else dataclasses.replace(cfg, num_layers=args.layers))
    api = build_model(cfg, pgf_pcfg(), tp=PG_RING_WORLD)
    params = api.init(args.seed, device="cuda")
    draft = None
    if args.spec_gamma and args.draft == "model":
        draft = SP.ModelDraft(api, params, args.spec_gamma)
    eng = Engine(api, params, SchedulerConfig(
        spec_gamma=args.spec_gamma, paged=args.packed, packed=args.packed),
        draft=draft, seed=args.seed, temperature=args.temperature,
        top_p=args.top_p)
    prompts = serve.prompts_of(np, args, cfg.vocab_size)
    for i, p in enumerate(prompts):
        eng.add_request(Request(rid=i, prompt=p,
                                max_new_tokens=args.new_tokens))
    done = {r.rid: r.output for r in eng.run()}
    sp = eng.stats.spec
    return ([done[i] for i in range(len(prompts))],
            {"verify_steps": sp.verify_steps, "proposed": sp.draft_proposed,
             "accepted": sp.draft_accepted, "emitted": sp.emitted})


def pgs_check(torch, np, seed: int, run_dir: Path, name: str, twin: bool,
              off_tokens: list) -> tuple:
    """One pg_spec run's gates: the ranks agree; a spec run verified
    windows, proposed drafts and accepted some; K1-peer launches equal
    ``pgs_expected`` (target and draft forwards) and nothing else ran an
    add+norm kernel, the ranks' K1-peer calls equal and bit-equal to the
    one-card K1 at every served (T, CTAs) (``check_peer_shapes``: verify
    windows and rollout forwards included); K3's launches equal on both
    ranks and K3 held on every kept shape (``pgf_check_k3``), a packed
    run's verify-only steps among them; a twin's greedy tokens equal
    spec off's, and every twin's tokens and ``spec`` counters the rank
    axis's ``ring`` engine's at tp=2 on the card.  Emits its line;
    returns (rank 0's K1-peer launches, the worst K1-peer error, rank 0's
    K3 launches, K3's worst error, the tokens)."""
    from repro_torch.configs import get_config

    label = f"pg_spec {pgs_dir(name, twin)}"
    cfg = get_config("llama3.3-70b")
    cfg = cfg.reduced() if twin else dataclasses.replace(cfg, num_layers=4)
    res = [json.loads((run_dir / f"result_r{k}.json").read_text())
           for k in range(PG_RING_WORLD)]
    line, spec = res[0], res[0]["spec"]
    if not line["ranks_agree"]:
        raise AssertionError(f"{label}: the ranks' tokens differ")
    if res[1]["rollouts"] != line["rollouts"]:
        raise AssertionError(f"{label}: the ranks' draft forwards differ")
    if name != "off" and not (spec["verify_steps"] > 0
                              and spec["proposed"] > 0
                              and spec["accepted"] > 0):
        raise AssertionError(f"{label}: no window verified, no draft "
                             f"proposed or none accepted: {spec}")
    want, want_k3 = pgs_expected(cfg, line, line["rollouts"])
    got = line["launches"]
    if (got["ar_rmsnorm_peer"] != want or got["ar_rmsnorm"]
            or got["fused_residual_rmsnorm"]):
        raise AssertionError(f"{label}: launches {got}, expected {want} of "
                             f"ar_rmsnorm_peer alone")
    k3_counts = [got["flash_attention"]] + [r["k3_launches"] for r in res]
    if any(n != want_k3 for n in k3_counts):
        raise AssertionError(f"{label}: K3 launches {k3_counts}, expected "
                             f"{want_k3}")
    k3_err, k3_shapes = pgf_check_k3(torch, run_dir, label, want_k3)
    # q (segments, longest segment, ...): verify windows alone
    verify_only = [sh for sh in k3_shapes if sh[0][1] == PGS_GAMMA + 1]
    if spec["packed"] and name != "off" and not verify_only:
        raise AssertionError(f"{label}: K3 held no verify-only packed step "
                             f"({k3_shapes})")
    group = []
    for k in range(PG_RING_WORLD):
        log = json.loads((run_dir / f"calls_r{k}.json").read_text())
        group.append(([tuple(c) for c in log["calls"]], log["digests"]))
    calls = group[0][0]
    if any(g[0] != calls for g in group) or len(calls) != want:
        raise AssertionError(f"{label}: the ranks' K1-peer calls differ, or "
                             f"miss the slot count")
    counts = {}
    for c in calls:
        counts[c] = counts.get(c, 0) + 1
    shapes, err = check_peer_shapes(torch, run_dir, counts, label=label)
    tokens = line["tokens"]
    timed = {n: [r["ms"][n] for r in res] for n in PGS_TIMED}
    # a verify step: verify_step, or a packed step of verify windows
    # alone (no more rows than max_batch windows, padded)
    verify_ms = [ms for r in res for ms, rows in zip(
        r["ms"]["verify_step"] + r["ms"]["packed_step"],
        r["rows"]["verify_step"] + r["rows"]["packed_step"])
        if rows <= 64]
    emitted = spec["emitted"]
    out = {"phase": "pg_spec", "run": name, "model": line["arch"],
           "layers": line["layers"], "dtype": line["dtype"],
           "world_size": PG_RING_WORLD, "backend": line["backend"],
           "gamma": spec["gamma"], "draft": spec["draft"],
           "packed": spec["packed"],
           "stochastic": name == "stochastic",
           "prompt_lens": list(PROMPT_LENS), "new_tokens": PGS_NEW_TOKENS,
           "forwards": line["forwards"],
           "weave_forwards": line["weave_forwards"],
           "rollout_forwards": len(line["rollouts"]),
           "rollout_shapes": sorted({tuple(r) for r in line["rollouts"]}),
           "verify_steps": spec["verify_steps"],
           "proposed": spec["proposed"], "accepted": spec["accepted"],
           "emitted": emitted,
           "acceptance_rate": (spec["accepted"] / spec["proposed"]
                               if spec["proposed"] else 0.0),
           "tokens_per_step": (emitted / (emitted - spec["accepted"])
                               if emitted > spec["accepted"] else 0.0),
           "launches_rank0": got, "expected_peer_launches": want,
           "formula": "splits·(1+2L) + rollout splits·(1+2L_draft)",
           "expected_k3_launches": want_k3, "k3_shapes_held": k3_shapes,
           "k3_verify_only_shapes": verify_only, "k3_max_abs_err": k3_err,
           "peer_shapes": shapes, "ranks_agree": True,
           "verify_step_ms_median_time_sliced": (
               statistics.median(verify_ms) if verify_ms else None),
           "ms_median_time_sliced": {
               n: [statistics.median(v) if v else None for v in ms]
               for n, ms in timed.items()},
           "wall_s_time_sliced": line["wall_s"],
           "gated": twin, "card": card_line()}
    if off_tokens is not None:
        out["first_token_differing_from_spec_off"] = first_differences(
            tokens, off_tokens)
    if twin:
        axis_tokens, axis_spec = pgs_rank_axis(
            torch, np, pgs_argv(seed, name, twin))
        same = (axis_tokens == tokens and all(
            axis_spec[k] == spec[k] for k in axis_spec))
        out["tokens_and_counters_equal_rank_axis_ring_tp2"] = same
        emit(out)
        greedy_ok = name == "stochastic" or off_tokens is None or (
            tokens == off_tokens)
        if not (same and greedy_ok):
            raise AssertionError(f"{label}: tokens or counters differ from "
                                 f"the rank axis's ring at tp=2 ({axis_spec}"
                                 f" vs {spec}) or from spec off's")
    else:
        emit(out)
    return got["ar_rmsnorm_peer"], err, got["flash_attention"], k3_err, \
        tokens


def pg_spec_phase(torch, np, seed: int) -> tuple:
    """Speculative decoding one model rank per process: two processes on
    the card (``pgs_rank``; gloo carries the groups' collectives, CUDA IPC
    K1's peer buffers, the target's workspace and the model draft's own)
    serve the prompt-lookup requests through ``launch.serve`` in comm mode
    ``ring``, gated by ``pgs_check``.  Returns (rank 0's K1-peer launches
    over every run, the worst K1-peer error, rank 0's K3 launches, K3's
    worst error)."""
    import os
    import tempfile

    t0 = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="pg_spec_"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    me = [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
          "--pg-spec-dir", str(out_dir), "--pg-spec-rank"]
    launches, worst, k3_launches, k3_err = 0, 0.0, 0, 0.0
    try:
        run_children([me + [str(k)] for k in range(PG_RING_WORLD)],
                     cwd=ROOT, env=env, timeout=PGS_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        for twin in (False, True):
            off = None
            for name, _ in pgs_runs(twin):
                n, err, n_k3, err_k3, tokens = pgs_check(
                    torch, np, seed, out_dir / pgs_dir(name, twin), name,
                    twin, off)
                if name == "off":
                    off = tokens
                launches += n
                worst = max(worst, err)
                k3_launches += n_k3
                k3_err = max(k3_err, err_k3)
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "pg_spec_seconds", "ranks_s": ranks_s,
          "seconds": time.perf_counter() - t0})
    return launches, worst, k3_launches, k3_err


def grads_of(torch, fn, inputs, g_out):
    """(outputs, d(sum of outputs . g_out) / d inputs) through autograd."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    got = torch.autograd.grad(outs, leaves, g_out)
    return [o.detach() for o in outs], list(got)


def fwd_bwd_ms(torch, fn, inputs, g_out, iters: int = 3) -> float:
    """Mean ms of one forward and backward, CUDA events, after a warm-up
    (autograd allocates, so no CUDA graph)."""
    grads_of(torch, fn, inputs, g_out)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        grads_of(torch, fn, inputs, g_out)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_train_case(torch, name, kernel_fn, plain_fn, inputs, g_out,
                     names) -> dict:
    """The autograd Function's output and input gradients against
    autograd through the plain version on the same inputs."""
    outs, grads = grads_of(torch, kernel_fn, inputs, g_out)
    torch.cuda.synchronize()
    p_outs, p_grads = grads_of(torch, plain_fn, inputs, g_out)
    case = {"phase": "train_kernels", "case": name,
            "shapes": [list(t.shape) for t in inputs[:3]],
            "dtype": str(inputs[0].dtype)[6:]}
    bf16 = inputs[0].dtype == torch.bfloat16
    for label, got, want in ([(f"out{i}", o, w) for i, (o, w) in
                              enumerate(zip(outs, p_outs))]
                             + list(zip(names, grads, p_grads))):
        if bf16:
            err = rel_fro(got, want)
            ok = err <= TRAIN_REL_FRO
            case[f"{label}_rel_fro"] = err
        else:
            scale = max(1.0, float(want.float().abs().max()))
            err = max_err(got, want) / scale
            ok = err <= TRAIN_FP32_TOL
            case[f"{label}_err"] = err
        if not ok:
            raise AssertionError(f"train_kernels {name}: {label} off by "
                                 f"{err}")
    case["tol"] = TRAIN_REL_FRO if bf16 else TRAIN_FP32_TOL
    case["kernel_fwd_bwd_ms"] = fwd_bwd_ms(torch, kernel_fn, inputs, g_out)
    case["plain_fwd_bwd_ms"] = fwd_bwd_ms(torch, plain_fn, inputs, g_out)
    emit(case)
    return case


def train_kernels_phase(torch, seed: int) -> None:
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import fused_rmsnorm as K2
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)
    for name, b, s, kvh, g, dh, window, dt in (
            ("k3_gemma_global", 4, 1024, 1, 4, 256, 0, torch.bfloat16),
            ("k3_gemma_local", 4, 1024, 1, 4, 256, 512, torch.bfloat16),
            ("k3_fp32_d128", 2, 512, 2, 8, 128, 0, torch.float32)):
        pos = torch.arange(s, dtype=torch.int32,
                           device="cuda")[None].expand(b, s).contiguous()
        qkv = [rnd(b, s, kvh, g, dh, dtype=dt), rnd(b, s, kvh, dh, dtype=dt),
               rnd(b, s, kvh, dh, dtype=dt)]
        g_out = [rnd(b, s, kvh, g, dh, dtype=dt)]
        kw = dict(causal=True, window=window)
        check_train_case(
            torch, name,
            lambda q, k, v: ops.flash_attention(q, k, v, pos, pos, **kw),
            lambda q, k, v: K3.flash_attention_plain(q, k, v, pos, pos, **kw),
            qkv, g_out, ("dq", "dk", "dv"))
    for name, t, d in (("k2_gemma", 4096, 1152), ("k2_d8192", 2048, 8192)):
        xs = [rnd(t, d), rnd(t, d), 1.0 + rnd(d, scale=0.1)]
        g_out = [rnd(t, d), rnd(t, d)]
        check_train_case(
            torch, name,
            lambda x, r, w: ops.fused_residual_rmsnorm(x, r, w, eps=1e-6,
                                                       use_pallas=True),
            lambda x, r, w: K2.fused_residual_rmsnorm_plain(x, r, w, 1e-6),
            xs, g_out, ("dx", "dresidual", "dweight"))


def train_gemma_phase(torch, np, seed: int, trace_dir: Path):
    """Six AdamW steps of Gemma3-1B at full width and depth, then one more
    step traced (``breakdown``: device ms by kind of kernel and in the
    loss, backward and optimizer ranges).  K3's and K2's inputs are kept
    at each shape the six steps give them (the weave's two 512-token
    splits: the suffix's queries at positions 512..1023 against 1024 keys,
    global and window 512) and the kernels are held on them afterwards.
    Returns (launches over the six steps, K3's error, K2's error): a main
    path."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.build import build_model
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import RANGES, make_train_step

    cfg = get_config("gemma3-1b")
    pcfg = ParallelConfig(comm_mode="fused", attn_impl="pallas",
                          use_pallas_norm=True, remat=True, split_unit=64,
                          tokenweave_min_tokens=256)
    api = build_model(cfg, pcfg, tp=1)
    batch, seq = 4, 1024
    data = SyntheticLM(vocab=cfg.vocab_size, seq_len=seq,
                       global_batch=batch, seed=seed)
    step, init = make_train_step(api, make_mesh((1, 1), ("data", "model")),
                                 None, AdamWConfig(lr=1e-3, warmup_steps=2),
                                 dp_size=1)
    base = reset_peak(torch)
    params, opt = init(seed, device="cuda")
    n_params = sum(p.numel() for p in
                   torch.utils._pytree.tree_flatten(params)[0])
    k3_inputs, k2_inputs = {}, {}
    undo = [capture_k3_inputs(k3_inputs), capture_k2_inputs(k2_inputs)]
    reset_launches()
    losses, norms, ms, per_step = [], [], [], []
    for i in range(TRAIN_STEPS):
        b = data.batch(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = read_launches()
        start.record()
        params, opt, m = step(params, opt, b)
        end.record()
        torch.cuda.synchronize()
        after = read_launches()
        counts = {k: after[k] - before[k] for k in after}
        per_step.append(counts)
        ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        for k in ("fused_residual_rmsnorm", "flash_attention"):
            if counts[k] <= 0:
                raise AssertionError(f"train_gemma step {i}: {k} not "
                                     f"launched ({counts})")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9 - base
    for u in undo:
        u()
    med = statistics.median(ms[1:])
    state = {"params": params, "opt": opt}

    def one_step():
        state["params"], state["opt"], _ = step(
            state["params"], state["opt"], data.batch(TRAIN_STEPS))
    emit({"phase": "breakdown", "engine": "train_gemma", "tp": 1,
          "step": "train", "tokens": batch * seq,
          **device_breakdown(torch, one_step, trace_dir / "train_gemma.json",
                             RANGES)})
    params, opt = state["params"], state["opt"]
    emit({"phase": "train_gemma", "layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "params": n_params, "batch": batch, "seq": seq,
          "step_ms": ms, "step_ms_median_2_6": med,
          "tokens_per_s": batch * seq / (med / 1e3), "peak_gb": peak,
          "launches_per_step": per_step, "losses": losses,
          "grad_norms": norms})
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train_gemma: non-finite loss or norm "
                             f"{losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_gemma: loss did not fall {losses}")
    del params, opt, state
    gc.collect()
    torch.cuda.empty_cache()
    return (launches, check_main_path_k3(torch, k3_inputs, "train_gemma", 1),
            check_main_path_k2(torch, k2_inputs, "train_gemma"))


def run_train(*runs):
    """``python -m repro_torch.launch.train`` on the card for each (args,
    checkpoint dir), all at once (each is mostly its interpreter's and
    CUDA's start), from src/ with no PYTHONPATH.  Returns (return code,
    stdout, stderr) per run."""
    import os
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--ckpt-dir", str(ckpt)], cwd=SRC, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for args, ckpt in runs]
    out = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            out.append((proc.returncode, stdout, stderr))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def logged_losses(out: str) -> list:
    return [float(ln.split("loss")[1].split()[0]) for ln in out.splitlines()
            if ln.startswith("[train] step")]


def train_resume_phase(torch) -> None:
    import shutil
    root = ROOT / "build" / "train_resume"
    shutil.rmtree(root, ignore_errors=True)
    args = ["--arch", "qwen1.5-4b", "--reduced", "--steps", "12",
            "--ckpt-every", "4", "--batch", "2", "--seq", "64"]
    manual_args = ["--reduced", "--steps", "4", "--batch", "4", "--seq",
                   "64", "--mesh", "2x1x2", "--manual-sync"]
    t0 = time.perf_counter()
    crash, clean = run_train((args + ["--fail-at-step", "6"], root / "crash"),
                             (args, root / "clean"))
    resume, manual = run_train((args, root / "crash"),
                               (manual_args, root / "manual"))
    for name, (rc, stdout, stderr) in (("crash", crash), ("clean", clean),
                                       ("resume", resume),
                                       ("manual", manual)):
        if rc != (42 if name == "crash" else 0):
            raise AssertionError(f"train_resume: the {name} run exited {rc}: "
                                 f"{stdout}{stderr[-3000:]}")
    if "resumed from checkpoint step 6" not in resume[1]:
        raise AssertionError(f"train_resume: no resume: {resume[1]}")
    resumed = logged_losses(resume[1])[-1]
    clean = logged_losses(clean[1])[-1]
    rel = abs(resumed - clean) / abs(clean)
    manual = logged_losses(manual[1])
    emit({"phase": "train_resume", "resumed_final_loss": resumed,
          "clean_final_loss": clean, "rel_diff": rel, "rtol": RESUME_RTOL,
          "manual_sync_losses": manual,
          "seconds": time.perf_counter() - t0})
    if not rel <= RESUME_RTOL:
        raise AssertionError(f"train_resume: final losses {resumed} vs "
                             f"{clean}")
    if not (len(manual) == 2 and all(map(math.isfinite, manual))):
        raise AssertionError(f"train_resume: manual-sync losses {manual}")
    manual_sync_phase(torch)


def manual_sync_phase(torch) -> None:
    """Whether the int8 pod reduce trains: the driver's ``--manual-sync
    --mesh 2x1x2`` configuration built in process, 4 steps from one init
    with the int8 reduce and without it (same batches), each holding the
    loss on one fixed batch (batch 0) before and after.  Both must fall,
    and the int8 run's fall must be within MANUAL_INT8_FALL_RTOL of the
    uncompressed run's, relative."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.build import build_model
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_manual_sync_train_step

    steps = 4
    cfg = get_config("gemma3-1b").reduced()
    pcfg = ParallelConfig(comm_mode="fused", dp_axes=("pod", "data"),
                          split_unit=64, tokenweave_min_tokens=256,
                          grad_compression="int8")
    api = build_model(cfg, pcfg, tp=2, ep=2)
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
    data = SyntheticLM(vocab=cfg.vocab_size, seq_len=64, global_batch=4)
    fixed = {k: torch.as_tensor(v).cuda() for k, v in data.batch(0).items()}
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=steps // 4 + 1)

    @torch.no_grad()
    def fixed_loss(params):
        ls, dn, aux = api.train_loss(params, fixed, dp=2)
        return float((ls / torch.clamp(dn, min=1.0) + aux).mean())

    out = {}
    for name, compress in (("int8", True), ("none", False)):
        step, init = make_manual_sync_train_step(api, mesh, data.batch(0),
                                                 ocfg, compress_pod=compress)
        state = list(init(0, device="cuda"))
        before, losses = fixed_loss(state[0]), []
        for i in range(steps):
            extra = state[2:] + [data.batch(i)]
            got = step(state[0], state[1], *extra)
            state = [got[0], got[1], *got[3:]]
            losses.append(float(got[2]["loss"]))
        out[name] = {"fixed_before": before, "fixed_after":
                     fixed_loss(state[0]), "step_losses": losses}
    fall = {k: v["fixed_before"] - v["fixed_after"] for k, v in out.items()}
    emit({"phase": "manual_sync", "mesh": "2x1x2", "steps": steps,
          "lr": ocfg.lr, **out, "fall": fall,
          "fall_rtol": MANUAL_INT8_FALL_RTOL})
    if not (fall["none"] > 0 and abs(fall["int8"] - fall["none"])
            <= MANUAL_INT8_FALL_RTOL * fall["none"]):
        raise AssertionError(f"manual_sync: fixed-batch loss falls {fall}")



# --------------------------------------------------------------------------
# the tuned overlap plan, the meta-device dry run and the examples
# --------------------------------------------------------------------------

PLAN_TURNS = ("warmup", "threshold", "tuned", "tuned", "threshold")
DRYRUN_WORKERS = 8                 # dry-run processes at a time (8 cores)
# the cells that take longest on meta, started first: Zamba2's 256 SSD
# chunks a layer at 32k, then the train steps of the deepest models
DRYRUN_SLOW = (("zamba2-7b", "prefill_32k"), ("zamba2-7b", "train_4k"),
               ("qwen3-moe-235b-a22b", "train_4k"),
               ("deepseek-67b", "train_4k"))
DRYRUN_PARAM_RTOL = 0.01           # allocated parameter bytes vs the count
DRYRUN_REPORTED = ("llama3.3-70b", "mixtral-8x22b")
EXAMPLES = ("quickstart", "serve_e2e")


def retarget_plan(plan, tp_from: int, tp_to: int):
    """The plan's ``tp_from`` entries granted at ``tp_to``: the plans
    cover tp 8 and 1, the float32 twin runs at tp=2."""
    return dataclasses.replace(plan, entries=tuple(
        dataclasses.replace(e, tp=tp_to) for e in plan.entries
        if e.tp == tp_from))


class PlanSpy:
    """Each engine forward's weave decision, and on each K1 call the grid
    it got beside the budget of the forward it ran in; keeps a copy of
    K1's inputs at the first call of each CTA count (taken on the card,
    moved to the host by ``offload``)."""

    def __init__(self, torch, eng):
        from repro_torch.kernels import ops
        from repro_torch.models import transformer
        self.ops, self.tr = ops, transformer
        self.decide, self.k1 = transformer.weave_decision_info, ops._k1
        self.infos, self.forwards, self.grids = [], [], []
        self.k1_inputs = {}
        note = eng._note_forward

        def decide(*a, **kw):
            info = self.decide(*a, **kw)
            self.infos.append(info)
            return info

        def k1(x, residual, weight, *, eps=1e-6, ctas=8):
            self.grids.append((ctas, self.infos[-1].budget))
            if ctas not in self.k1_inputs:
                self.k1_inputs[ctas] = ([t.detach().clone() for t in
                                         (x, residual, weight)], eps)
            return self.k1(x, residual, weight, eps=eps, ctas=ctas)

        def note_forward(b, s, n_real, **kw):
            note(b, s, n_real, **kw)
            self.forwards.append((self.infos[-1], b * s))

        transformer.weave_decision_info = decide
        ops._k1 = k1
        eng._note_forward = note_forward

    def offload(self):
        for ctas, (tensors, eps) in self.k1_inputs.items():
            self.k1_inputs[ctas] = ([t.cpu() for t in tensors], eps)

    def undo(self):
        self.tr.weave_decision_info = self.decide
        self.ops._k1 = self.k1


def plan_forward_rows(spy, plan) -> list:
    """(site, bucket, method, split_frac, budget -> K1 CTAs) of each
    forward: the plan's entry at its key, or the threshold decision."""
    from repro_torch.core.splitting import ring_ctas
    index = {} if plan is None else {
        (e.site, e.bucket, e.tp, e.family): e for e in plan.entries}
    rows = []
    for info, tokens in spy.forwards:
        e = index.get((info.site, info.bucket, 8, "dense"))
        rows.append({"site": info.site, "bucket": info.bucket,
                     "tokens": tokens,
                     "method": e.method if e else "threshold",
                     "split_frac": e.split_frac if e else None,
                     "budget": info.budget,
                     "k1_ctas": ring_ctas(info.budget),
                     "split": info.split, "reason": info.reason})
    return rows


def tuned_plan_phase(torch, np, seed: int, trace_dir: Path):
    """The overlap-plan autotuner on the card's calibration, served.
    ``autotune.build_default_plan`` on ``online_tp8``'s
    calibration_tp8.json writes build/plans/tuned.json; every entry that
    differs from the committed ``h100_default.json`` is printed.  Then
    engine_tp's traffic (Llama-3.3-70B widths, 4 layers, bf16, tp=8
    ``ring``, two-dispatch over the paged pool) is served under the
    threshold policy and from the tuned plan in turns (``PLAN_TURNS``,
    after an untimed warm-up run under the threshold policy):
    each forward's plan key, method, split fraction and budget with the
    CTAs it grants K1 (``tuned_plan_forwards``); every K1 call's grid is
    ``ring_ctas`` of its forward's budget; every request finishes and the
    pool drains; K1 is held against its plain version on the inputs it
    got at each CTA count used, bit-identical across them, and timed at
    each; K3 on every shape (``main_path_k3``).  The bf16 tokens of the
    two policies are reported (their splits differ); on the small
    float32 twin at tp=2 ``ring`` (the plan's tp=8 entries granted at
    tp=2) they are gated equal.  Returns (launches, K3's max error,
    peak GB)."""
    from repro_torch.analysis import autotune
    from repro_torch.core.policy import TunedPolicy
    from repro_torch.core.splitting import ring_ctas
    from repro_torch.kernels import ar_rmsnorm as K1
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.requests import Request
    from repro_torch.runtime.scheduler import SchedulerConfig

    cal_path = trace_dir / "online" / "calibration_tp8.json"
    with open(cal_path) as f:
        cal = json.load(f)
    plan = autotune.build_default_plan(cal)
    plan_dir = ROOT / "build" / "plans"
    plan_dir.mkdir(parents=True, exist_ok=True)
    plan_path = plan_dir / "tuned.json"
    plan.save(str(plan_path), **autotune._meta(str(cal_path)))
    default = TunedPolicy.load(autotune.H100_PLAN)
    ref = {(e.site, e.bucket, e.tp, e.family): e for e in default.entries}
    diffs = [e for e in plan.entries
             if ref.get((e.site, e.bucket, e.tp, e.family)) != e]
    for e in diffs:
        old = ref.get((e.site, e.bucket, e.tp, e.family))
        emit({"phase": "tuned_plan_diff", "site": e.site,
              "bucket": e.bucket, "tp": e.tp, "family": e.family,
              "tuned": [e.method, e.split_frac, e.budget],
              "h100_default": None if old is None else
              [old.method, old.split_frac, old.budget]})
    emit({"phase": "tuned_plan", "plan_id": plan.plan_id,
          "h100_default_plan_id": default.plan_id,
          "entries": len(plan.entries), "differing_entries": len(diffs),
          "calibration": {k: cal.get(k) for k in (
              "peak", "hbm", "ici", "mfu_cap", "overhead", "tile")},
          "plan_json": str(plan_path)})

    cfg, api, params, prompts, _, _ = full_width_model(
        torch, np, seed, tp=8, comm_mode="ring", n_layers=4)
    total = {"ar_rmsnorm": 0, "fused_residual_rmsnorm": 0,
             "flash_attention": 0}
    k3_inputs, k1_inputs, tokens = {}, {}, {}
    times = {name: {"prefill": [], "decode": []} for name in PLAN_TURNS}
    peak = 0.0
    for turn, name in enumerate(PLAN_TURNS):
        eng = Engine(api, params, SchedulerConfig(
            paged=True, plan_path=str(plan_path) if name == "tuned"
            else None))
        turn_times = {"prefill": [], "decode": []}
        spy = PlanSpy(torch, eng)

        def timed(kind, fn, name=name, spy=spy):
            def run(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                turn_times[kind].append((time.perf_counter() - t) * 1e3)
                offload(k3_inputs)
                spy.offload()
            return run

        eng._run_prefill = timed("prefill", eng._run_prefill)
        eng._run_decode = timed("decode", eng._run_decode)
        for i, p in enumerate(prompts):
            eng.add_request(Request(rid=i, prompt=p,
                                    max_new_tokens=NEW_TOKENS))
        undo = capture_k3_inputs(k3_inputs)
        try:
            reset_peak(torch)
            reset_launches()
            done = eng.run()
            torch.cuda.synchronize()
            launches = read_launches()
        finally:
            undo()
            spy.undo()
        peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
        check_outputs(done, len(prompts), cfg.vocab_size, NEW_TOKENS)
        check_drained(eng)
        bad = [(c, b) for c, b in spy.grids if c != ring_ctas(b)]
        if bad or not spy.grids:
            raise AssertionError(f"{name}: K1 grids against their "
                                 f"forwards' budgets {bad[:8]}, "
                                 f"{len(spy.grids)} K1 calls")
        for c, inputs in spy.k1_inputs.items():
            k1_inputs.setdefault(c, inputs)
        for k in total:
            total[k] += launches[k]
        tokens[name] = {r.rid: r.output for r in done}
        for kind, ms in turn_times.items():
            times[name][kind] += ms
        emit({"phase": "tuned_plan_forwards", "turn": turn, "policy": name,
              "plan_id": int(eng.metrics.get("engine/plan_id").value),
              "launches": launches,
              "ms_median": {k: statistics.median(v)
                            for k, v in turn_times.items()},
              "prefill_ms": turn_times["prefill"],
              "k1_ctas_used": sorted({c for c, _ in spy.grids}),
              "forwards": plan_forward_rows(
                  spy, plan if name == "tuned" else None)})
        del eng, spy
    del params
    torch.cuda.empty_cache()

    # K1 on the inputs it got at each CTA count used: against its plain
    # version, bit-identical on every count used, timed on each
    ctas_used = sorted(k1_inputs)
    k1_ms, k1_err = {}, 0.0
    for c in ctas_used:
        (x, r, w), eps = k1_inputs[c]
        x, r, w = x.cuda(), r.cuda(), w.cuda()
        out, new_res = K1.ar_rmsnorm(x, r, w, eps=eps, ctas=c)
        for c2 in ctas_used:
            o2, r2 = K1.ar_rmsnorm(x, r, w, eps=eps, ctas=c2)
            torch.cuda.synchronize()
            if not (torch.equal(out, o2) and torch.equal(new_res, r2)):
                raise AssertionError(f"K1 {tuple(x.shape)}: {c} and {c2} "
                                     f"CTAs differ")
        p_out, p_res = K1.ar_rmsnorm_plain(x, r, w, eps)
        err = max(check_close(f"K1 tuned plan {c} CTAs out", out, p_out,
                              K1_TOL, K1_TOL),
                  check_close(f"K1 tuned plan {c} CTAs residual", new_res,
                              p_res, K1_TOL, K1_TOL))
        k1_err = max(k1_err, err)
        k1_ms[c] = {str(c2): time_ms(torch, lambda c2=c2: K1.ar_rmsnorm(
            x, r, w, eps=eps, ctas=c2)) for c2 in sorted({*ctas_used, 8})}
        emit({"phase": "tuned_plan_k1", "ctas": c, "shape": list(x.shape),
              "max_abs_err": err, "tol": K1_TOL,
              "bit_identical_ctas": ctas_used, "ms_by_ctas": k1_ms[c]})
        del x, r, w, out, new_res, p_out, p_res

    def medians(name):
        return {k: statistics.median(v) for k, v in times[name].items()}
    emit({"phase": "tuned_plan_steps", "model": cfg.name, "tp": 8,
          "layers": 4, "turns": list(PLAN_TURNS),
          "threshold_ms_median": medians("threshold"),
          "tuned_ms_median": medians("tuned"),
          "tokens_equal_bf16": tokens["tuned"] == tokens["threshold"],
          "k1_max_abs_err": k1_err, "peak_gb": peak,
          "card": card_line()})
    k3_err = check_main_path_k3(torch, k3_inputs, "tuned_plan", 8)

    # the float32 twin at tp=2: the plan's tp=8 entries granted at tp=2
    torch.backends.cuda.matmul.allow_tf32 = False
    twin_plan = plan_dir / "tuned_tp2.json"
    retarget_plan(plan, 8, 2).save(str(twin_plan))
    scfg = dict(max_batch=16, chunk_tokens=64, max_len=128,
                prefill_bucket=16)
    cfg2, api2 = small_api(tp=2, comm_mode="ring")
    p2 = api2.init(seed, device="cuda")
    rng = np.random.RandomState(seed + 1)
    prompts2 = [rng.randint(0, cfg2.vocab_size, int(n)).tolist()
                for n in rng.randint(5, 100, size=16)]
    twin, ctas2 = {}, {}
    for name, path in (("threshold", None), ("tuned", str(twin_plan))):
        eng = Engine(api2, p2, SchedulerConfig(**scfg, plan_path=path))
        spy = PlanSpy(torch, eng)
        for i, p in enumerate(prompts2):
            eng.add_request(Request(rid=i, prompt=p, max_new_tokens=8))
        reset_launches()
        try:
            twin[name] = {r.rid: r.output for r in eng.run()}
        finally:
            spy.undo()
        launches = read_launches()
        for k in total:
            total[k] += launches[k]
        ctas2[name] = sorted({c for c, _ in spy.grids})
        if any(c != ring_ctas(b) for c, b in spy.grids):
            raise AssertionError(f"twin {name}: a K1 grid is not its "
                                 f"forward's budget's")
    emit({"phase": "tuned_plan_twin", "model": cfg2.name, "tp": 2,
          "comm_mode": "ring", "requests": len(prompts2),
          "tokens_identical": twin["tuned"] == twin["threshold"],
          "k1_ctas_used": ctas2})
    if twin["tuned"] != twin["threshold"]:
        raise AssertionError("float32 twin: tuned-plan tokens differ from "
                             "the threshold policy's")
    del p2
    torch.cuda.empty_cache()
    return total, max(k3_err, 0.0), peak, k1_err


def dryrun_phase(torch) -> None:
    """``launch.dryrun.run_cell`` for every ASSIGNED arch x shape on the
    16x16 mesh on meta tensors (one ``python -m repro_torch.launch.dryrun
    --arch --shape`` process per cell, ``DRYRUN_WORKERS`` at a time, the
    records in build/dryrun/), and the two paper models the report names
    (``DRYRUN_REPORTED``): a status count, and for those two each
    shape's per-device ``memory.args`` in GB and the roofline's dominant
    term.  Then Llama-3.3-70B cut to 4 layers at tp=8 is built on the
    card: the memory its parameters take must be within
    ``DRYRUN_PARAM_RTOL`` of the dry run's parameter bytes of the same
    cell (tp=8 ranks of one data shard, all on the card's rank axis)."""
    import os

    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.build import build_model

    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [*ASSIGNED, *DRYRUN_REPORTED]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    # the slowest cells first, then train steps, then 32k prefills
    pending = [*DRYRUN_SLOW, *(
        (a, s) for s in ("train_4k", "prefill_32k", "decode_32k",
                         "long_500k") for a in archs
        if (a, s) not in DRYRUN_SLOW)]
    running, failed = [], []
    while pending or running:
        while pending and len(running) < DRYRUN_WORKERS:
            arch, shape = pending.pop(0)
            out = out_dir / f"{arch}_{shape}.json"
            out.unlink(missing_ok=True)
            log = open(out_dir / f"{arch}_{shape}.log", "w")
            running.append(((arch, shape), log, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--out", str(out)], cwd=SRC,
                env=env, stdout=log, stderr=subprocess.STDOUT)))
        time.sleep(0.2)
        for item in [r for r in running if r[2].poll() is not None]:
            running.remove(item)
            item[1].close()
            if item[2].returncode:
                failed.append(item[0])
    if failed:
        raise AssertionError(f"dry run processes failed: {failed} (logs in "
                             f"{out_dir})")
    records = {}
    for arch in archs:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            with open(out_dir / f"{arch}_{shape}.json") as f:
                records.update(json.load(f))
    status = {}
    for key, rec in records.items():
        status[rec["status"]] = status.get(rec["status"], 0) + 1
    errors = {k: r.get("error") for k, r in records.items()
              if r["status"] == "error"}
    emit({"phase": "dryrun", "mesh": "16x16", "cells": len(records),
          "status": status, "seconds": time.perf_counter() - t0,
          "workers": DRYRUN_WORKERS, "errors": errors})
    for key, rec in sorted(records.items()):
        if key.split("|")[0] in DRYRUN_REPORTED and rec["status"] == "ok":
            emit({"phase": "dryrun_cell", "arch": rec["arch"],
                  "shape": rec["shape"],
                  "memory_args_gb": rec["memory"]["args"] / 1e9,
                  "memory_gb": {k: rec["memory"][k] / 1e9 for k in (
                      "params", "opt", "cache", "inputs", "out")},
                  "dominant": rec["roofline"]["dominant"],
                  "compute_s": rec["roofline"]["compute_s"],
                  "memory_s": rec["roofline"]["memory_s"],
                  "collective_s": rec["roofline"]["collective_s"]})
    if errors or status.get("ok", 0) + status.get("skipped", 0) != \
            len(archs) * 4:
        raise AssertionError(f"dry run: {status}, errors {errors}")

    # the parameters of one cell on the card against the dry run's count
    mesh = make_mesh((1, 8), ("data", "model"))
    rec = dryrun.run_cell("llama3.3-70b", "decode_32k", multi_pod=False,
                          mesh=mesh, cfg_overrides={"num_layers": 4},
                          tag="tp8_4layers")
    if rec["status"] != "ok":
        raise AssertionError(f"dry run of the card's cell: {rec}")
    counted = rec["memory"]["params"] * 8        # tp=8 ranks on one card
    api = build_model(dataclasses.replace(get_config("llama3.3-70b"),
                                          num_layers=4),
                      ParallelConfig(comm_mode="ring", attn_impl="pallas",
                                     use_pallas_norm=True), tp=8)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params = api.init(0, device="cuda")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    rel = abs(grown - counted) / counted
    emit({"phase": "dryrun_params", "arch": "llama3.3-70b", "layers": 4,
          "tp": 8, "allocated_bytes": grown, "dryrun_bytes": counted,
          "dryrun_bytes_per_rank": rec["memory"]["params"],
          "rel_diff": rel, "rtol": DRYRUN_PARAM_RTOL})
    del params
    torch.cuda.empty_cache()
    if not rel <= DRYRUN_PARAM_RTOL:
        raise AssertionError(f"parameters took {grown} bytes on the card, "
                             f"the dry run counts {counted}")


def examples_phase() -> None:
    """The example scripts ``EXAMPLES`` run on the card as a user runs
    them (``python examples/torch/<name>.py``, no ``--device``: CUDA by
    default); each must exit 0."""
    import os
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for name in EXAMPLES:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        emit({"phase": "examples", "example": name,
              "returncode": proc.returncode,
              "seconds": time.perf_counter() - t0,
              "stdout_tail": proc.stdout.strip().splitlines()[-3:]})
        if proc.returncode:
            raise AssertionError(f"examples/torch/{name}.py exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", type=Path,
                    default=ROOT / "build" / "traces",
                    help="where the traced model calls' Chrome traces go")
    # k1_peer's own processes (k1_peer_phase starts them)
    ap.add_argument("--k1-peer-local", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--k1-peer-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--k1-peer-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--k1-peer-store", help=argparse.SUPPRESS)
    # pg_ring's ranks (serve_ring starts them): launch.serve's argv follows
    ap.add_argument("--pg-ring-spy", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--serve-argv", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)
    # pg_families' ranks and its K1-peer timing (pg_families_phase starts
    # them)
    ap.add_argument("--pg-families-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--pg-families-dir", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--k1-peer-cases", type=json.loads,
                    help=argparse.SUPPRESS)
    # pg_data's ranks (pg_data_phase starts them)
    ap.add_argument("--pg-data-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--pg-data-dir", type=Path, help=argparse.SUPPRESS)
    # pg_spec's ranks (pg_spec_phase starts them)
    ap.add_argument("--pg-spec-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--pg-spec-dir", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    if args.k1_peer_local and args.k1_peer_cases:
        k1_peer_local(torch, args.seed,
                      cases=[tuple(c) for c in args.k1_peer_cases],
                      ranks=(PG_RING_WORLD,), small=False)
        return 0
    if args.k1_peer_local:
        k1_peer_local(torch, args.seed)
        return 0
    if args.pg_families_rank is not None:
        pgf_rank(torch, np, args.seed, args.pg_families_rank,
                 args.pg_families_dir)
        return 0
    if args.pg_data_rank is not None:
        pgd_rank(torch, np, args.seed, args.pg_data_rank, args.pg_data_dir)
        return 0
    if args.pg_spec_rank is not None:
        pgs_rank(torch, np, args.seed, args.pg_spec_rank, args.pg_spec_dir)
        return 0
    if args.k1_peer_rank is not None:
        k1_peer_rank(torch, args.seed, args.k1_peer_rank, args.k1_peer_world,
                     args.k1_peer_store)
        return 0
    if args.pg_ring_spy is not None:
        return serve_spied(torch, args.pg_ring_spy, args.serve_argv)
    from repro_torch.kernels import build

    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    probe = start_copy_probe_build()
    info = build.build()
    emit({"phase": "build", "seconds": info["seconds"],
          "built": info["built"], "done_at": info["done_at"],
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in info["ptxas"].items()}})
    for name in build.SOURCES:
        build.load(name)

    t0 = time.perf_counter()
    rows = kernel_phase(torch, args.seed, load_copy_probe(probe))
    t1 = time.perf_counter()
    rows["ar_rmsnorm_peer"] = k1_peer_phase(args.seed)
    emit({"phase": "kernel_seconds", "kernels": t1 - t0,
          "k1_peer": time.perf_counter() - t1})
    # the main paths: launches are counted from 0 over each engine run
    kw = dict(torch=torch, np=np, seed=args.seed, trace_dir=args.trace_dir)
    online = online_phase(**kw)
    two = {1: engine_phase(**kw, tp=1, comm_mode="fused"),
           8: engine_phase(**kw, tp=8, comm_mode="ring")}
    packed = {1: packed_phase(**kw, tp=1, comm_mode="fused"),
              8: packed_phase(**kw, tp=8, comm_mode="ring")}
    paths = [online, *two.values(), *packed.values(),
             engine_phase(**kw, tp=1, comm_mode="fused", paged=True)]
    # no per-token KV view on the card: each packed run's peak stays
    # within PACKED_PEAK_SLACK_GB of the two-dispatch run's at its tp
    for tp in (1, 8):
        excess = packed[tp][2] - two[tp][2]
        emit({"phase": "peak_memory", "tp": tp,
              "two_dispatch_gb": two[tp][2], "packed_gb": packed[tp][2],
              "excess_gb": excess, "limit_gb": PACKED_PEAK_SLACK_GB})
        if not excess <= PACKED_PEAK_SLACK_GB:
            raise AssertionError(f"tp={tp}: packed peak {packed[tp][2]} GB "
                                 f"exceeds two-dispatch {two[tp][2]} GB by "
                                 f"more than {PACKED_PEAK_SLACK_GB} GB")
    # the overlap plan tuned on online_tp8's calibration, served at tp=8
    *tuned, tuned_k1_err = tuned_plan_phase(**kw)
    paths.append(tuple(tuned))
    # speculative decoding: packed at tp=1 and tp=8, two-dispatch paged
    kw.pop("trace_dir")
    paths += [spec_phase(**kw, tp=1, comm_mode="fused"),
              spec_phase(**kw, tp=8, comm_mode="ring"),
              spec_phase(**kw, tp=1, comm_mode="fused", packed=False)]
    for tp, mode in ((1, "fused"), (8, "ring")):
        paths.append((verify_weave_phase(**kw, trace_dir=args.trace_dir,
                                         tp=tp, comm_mode=mode), 0.0))
    # the MoE family, and the MoE layer free of host syncs
    paths += moe_phases(**kw, trace_dir=args.trace_dir)
    moe_sync_phase(torch, args.seed)
    # the cluster: disaggregated handoff at full width, then the small
    # model's clusters, a socket replica and the HTTP API
    t0 = time.perf_counter()
    paths += [cluster_phase(**kw, tp=1, comm_mode="fused"),
              cluster_phase(**kw, tp=8, comm_mode="ring")]
    cluster_small_phase(torch, np, args.seed)
    emit({"phase": "cluster_seconds", "seconds": time.perf_counter() - t0})
    # the ssm family through the engine, the hybrid through direct calls
    kw["trace_dir"] = args.trace_dir
    for tp, mode in ((1, "fused"), (8, "ring")):
        paths += [engine_ssm_phase(**kw, tp=tp, comm_mode=mode),
                  hybrid_phase(**kw, tp=tp, comm_mode=mode)]
    # the vlm and encdec families through direct calls
    for tp, mode in ((1, "fused"), (8, "ring")):
        paths += [vlm_phase(**kw, tp=tp, comm_mode=mode),
                  encdec_phase(**kw, tp=tp, comm_mode=mode)]
    # the data rank axis: Qwen3-MoE through the engine at data size 1,
    # ep2d at D = 2 and D = 1 by direct calls, context-parallel decode
    paths += qwen3_phases(**kw)
    paths += [ep2d_run(**kw, dp=dp) for dp in (2, 1)]
    kw.pop("trace_dir")
    paths.append(cp_decode_phase(**kw))
    # the process-group backend: NCCL at world size 1 beside the rank axis
    paths.append(pg_engine_phase(**kw, trace_dir=args.trace_dir))
    # comm mode ring one rank per process: K1's cross-rank form
    peer_launches, pg_ring_err = pg_ring_phase(torch, np, args.seed)
    # the MoE, ssm, hybrid, encdec and vlm families the same way
    (family_launches, pg_families_err, family_k3,
     family_k3_err) = pg_families_phase(torch, np, args.seed)
    peer_launches += family_launches
    # the data group: four (data, model) ranks, ep2d's all-to-alls, the
    # batch over the data group, context-parallel decode over it
    data_launches, pg_data_err, data_k3, data_k3_err = pg_data_phase(
        torch, np, args.seed)
    peer_launches += data_launches
    family_k3 += data_k3
    family_k3_err = max(family_k3_err, data_k3_err)
    # speculative decoding the same way: verify windows, model drafts
    spec_launches, pg_spec_err, spec_k3, spec_k3_err = pg_spec_phase(
        torch, np, args.seed)
    peer_launches += spec_launches
    family_k3 += spec_k3
    family_k3_err = max(family_k3_err, spec_k3_err)
    # training: the kernels inside autograd, Gemma3-1B's steps, launch.train
    t0 = time.perf_counter()
    train_kernels_phase(torch, args.seed)
    *gemma, gemma_k2_err = train_gemma_phase(torch, np, args.seed,
                                             args.trace_dir)
    paths.append(tuple(gemma))
    train_resume_phase(torch)
    emit({"phase": "train_seconds", "seconds": time.perf_counter() - t0})
    launches = {name: sum(p[0][name] for p in paths)
                for name in paths[0][0]}
    launches["ar_rmsnorm_peer"] = peer_launches
    launches["flash_attention"] += family_k3
    # the K3 error over every shape the main paths gave it, too, and K2's
    # over training's
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], family_k3_err,
        *(p[1] for p in paths))
    rows["fused_residual_rmsnorm"]["max_abs_err"] = max(
        rows["fused_residual_rmsnorm"]["max_abs_err"], gemma_k2_err)
    for tp in (1, 8):
        sampler_phase(torch, np, args.seed, tp=tp)
    for moe in ("", "ffn", "expert"):
        identity_phase(torch, np, args.seed, tp=1, comm_mode="fused",
                       moe=moe)
        identity_phase(torch, np, args.seed, tp=2, comm_mode="ring",
                       moe=moe)
    for tp, mode in ((1, "fused"), (2, "ring")):
        identity_recurrent_phase(torch, np, args.seed, tp=tp, comm_mode=mode)
        identity_family_phase(torch, np, args.seed, tp=tp, comm_mode=mode)
    identity_data_phase(torch, np, args.seed)
    rows["ar_rmsnorm"]["max_abs_err"] = max(
        rows["ar_rmsnorm"]["max_abs_err"], tuned_k1_err)
    rows["ar_rmsnorm_peer"]["max_abs_err"] = max(
        rows["ar_rmsnorm_peer"]["max_abs_err"], pg_ring_err, pg_families_err,
        pg_data_err, pg_spec_err)
    # the meta-device dry run and the examples: host work, after every
    # timed phase
    dryrun_phase(torch)
    examples_phase()

    sources = {"ar_rmsnorm": (
        "src/repro_torch/csrc/ar_rmsnorm.cu",
        "src/repro/kernels/ring_ar_rmsnorm.py:43"),
        "ar_rmsnorm_peer": (
        "src/repro_torch/csrc/ar_rmsnorm_peer.cu",
        "src/repro/kernels/ring_ar_rmsnorm.py:43"),
        "fused_residual_rmsnorm": (
        "src/repro_torch/csrc/fused_rmsnorm.cu",
        "src/repro/kernels/fused_rmsnorm.py:27"),
        "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:29")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name]["library_ms"]}
        for name, (src, rep) in sources.items()]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
