#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed S] [--s1-only | --serve-only |
                           --train-only | --mesh-only | --dryrun-only]

``--s1-only`` runs phases 1-2 and S1 alone (on the queries that phase 3
draws, without the main path's q-errors) and prints no result lines;
``--serve-only`` runs phases 1-2 and L1-L3 alone and prints none either;
``--train-only`` runs phases 1-2 and T1 alone, ``--mesh-only`` phases 1-2
and M1 alone, ``--dryrun-only`` phases 1-2 and R1 alone, no result
lines.

Phases, in order; each raises on failure:

1. Device: require CUDA; print the card's name and ``nvidia-smi``'s
   name and power limit.
2. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source, in parallel); print seconds and ptxas lines.
3. Each kernel wrapper against its plain PyTorch version at the main path's
   shapes, with the stated tolerances; CUDA-event times of the kernel, the
   plain version and (for ``l2dist`` and ``hamming_to_buckets``)
   ``torch.cdist``, beside the bound. ``l2dist`` runs its tiled kernel at
   1,000,000 and 1,016,384 rows x 64 queries, each held with
   ``torch.equal`` against its general kernel, whose time it prints beside
   the FP32-issue ceiling. ``query_lanes`` (the query hash fused into the
   Hamming scan) at (64, 2, 2^20), ``torch.equal`` to ``lsh_hash`` plus
   ``hamming_to_buckets``, timed beside them.
4. The main path at SIFT1M scale (N = 1,000,000, d = 128): ``build`` at
   capacity 2^20, 64 paper-protocol queries through
   ``estimate_batch_stats``, an in-capacity ``update`` of 16,384 points, an
   ``update`` past capacity (growth to 2^21), an estimate after each, all
   held against ``true_cardinality`` (each call's count sum and max, and a
   digest of the query workload's tau grid, are printed). Kernel launch
   counts are zeroed just before and read just after: every estimate
   launches ``query_lanes`` and ``central_qualify`` once, every ``l2dist``
   launch must have taken the tiled kernel, and none of the kernels those
   two replaced (``lsh_hash``, ``hamming_to_buckets``, ``l2dist_rows``,
   ``adc_rows[_q8]``) may launch. Then ``query_lanes`` again at 2^21, and
   on an index of 2^21 bucket rows that are all live; each time also with
   other counts of worker blocks, which must give the same results. A
   third ``estimate_batch_stats`` of the 64 queries (launch counts
   restored after it) holds its slab loop (``slab_loop``, one launch)
   bit-equal to the host loop of ``slab_qualify`` steps on a copy of the
   loop's input state, and its results equal to the first call's.
5. The fused slab kernel ``slab_qualify`` against its plain version on the
   grown state (128 lanes x 128 slots, B = 2^21): sample counts and sums
   equal, and equal to the slab path's composition before the fusion (the
   torch candidate walk and the ``l2dist_rows`` kernel); CUDA-event and
   profiler times, and the launches of one slab step either way. Then the
   slab loop on the grown state's lanes from their start (128 lanes x
   128, chunk 128): bit-equal to the host loop, its CUDA-event and
   profiler times beside the host loop's and the byte bound of the
   candidates its per-lane counts show it qualified. Then
   ``central_qualify`` (Alg. 3's central count, one launch) against its
   plain version and the composition it replaced (ring 0's cumsum row,
   ``gather_ring_from_cum``, ``l2dist_rows``) at 128 lanes x 2048.
6. Where the time goes: ``torch.profiler`` over one ``estimate_batch`` and
   one ``update`` (with ``copy_`` and ``searchsorted`` time, launch calls
   and the call's peak device memory).
7. Small-input agreement: the same index, queries and round keys through
   the CPU path (plain versions) and the GPU path (kernels).
8. The PQ path at SIFT1M scale, launch counts zeroed just before and read
   just after each config: ``build(use_pq=True)`` under the repo's
   paper-faithful PQ config (``benchmarks/common.py``
   ``prober_cfg(use_pq=True)``: float ADC on far rings, exact distances on
   the central bucket and near rings), ``estimate_batch_stats`` twice
   (bit-identical), an in-capacity and a growth ``update`` (Alg. 8) with
   an estimate after each; the serving config (``serve_cfg``: every
   qualification through the uint8 LUT), then ``serve_cfg`` with float
   LUTs (the config where the uint8 datapath is absent), each config's
   slab loop held bit-equal to the host loop in one more estimate; and
   the full-ADC-scan baseline, held against its plain version.
9. The four ADC kernels against their plain versions at the PQ path's
   shapes (and the packed 4-bit layout), with CUDA-event times of the
   kernel, the plain version and ``embedding_bag`` beside the bound (and,
   for ``adc_batch[_q8]``, beside the shared-memory word ceiling); then
   ``slab_qualify`` against its plain version on the PQ states: mixed
   routing and banded weights at 2^21, ``serve_cfg``'s uint8 slab (64 x
   512) with byte and packed codes; the slab loop on the same PQ states
   and on ``serve_cfg`` with float LUTs (chunk 512: a cluster of 4 blocks
   a lane), bit-equal to the host loop and timed as in 5;
   ``central_qualify`` on the PQ states
   (``prober_cfg``'s exact central, a banded ADC central, ``serve_cfg``'s
   uint8 and float LUTs) against the composition it replaced.
10. ``torch.profiler`` over one PQ ``estimate_batch`` of each config.
11. Small-input agreement of the PQ path (packed 4-bit codes, float and
    uint8 LUTs) between the CPU and the GPU.

The serving path runs between 7 and 8:

C1. The serving deployment at the main path's width: the exact state at
    capacity 2^20 with ingest epochs, ``CardinalityCoalescer(cache_size=
    1024, max_batch=64, reuse_tol=0)``, a pool of the 64 paper-protocol
    queries x 4 grid radii, 24 flushes of 64 zipfian (s = 0.99) draws over
    a seeded shuffle of the pool, the main path's 16,384 rows ingested
    after flush 8 and its 40,000 after flush 16 (growth to 2^21), and one
    point anchored on a live row (inside every projection range, so W
    stays) after flushes 10, 12, 14, 18, 20 and 22. Launch
    counts are zeroed before the first flush and read after the last; a
    flush with a miss launches ``query_lanes`` once for the keys and once
    for its probe, ``cache_insert`` and ``central_qualify`` once, an
    all-hit flush ``query_lanes`` once, and no flush ``lsh_hash`` or
    ``hamming_to_buckets``. A shadow check (``tests/test_cache.py``'s)
    sees no stale serve, every hit equals its probe's estimate bit for
    bit, and every request of a recorded key is a hit when no ingest
    touched its probed rings and a stale refresh when one did. Hits
    before the first ingest, and stale refreshes after the ingests that
    keep W (``params_epoch`` unchanged, some entries but not all touched)
    must occur. Prints each flush's hits, misses, stale entries,
    evictions, wall ms and peak memory, and the served q-error before the
    first ingest; then the lookup's and ``query_lanes``' times at the
    flush's shapes and profiles of an all-hit and an all-miss flush.
C2. ``cache_insert`` against its plain version, ``torch.equal`` on every
    field (S = 1024 and 65,536; 64 and 256 lanes; duplicate keys; a full
    cache with every ``ref`` set), with wrapper, device (its three
    kernels summed) and plain-loop times and the bound; then the chain's
    per-lane slope: device time at 1 active lane against 64 at S = 1024,
    in ns and in clocks at the SM clock measured under that load.
C3. Small-input agreement of the serving path: the same stream at
    reuse_tol 0.25 through a CPU and a GPU coalescer with the same round
    keys.

Then, after the PQ path, this slice's three phases:

N1. The paper's neighbor table (Alg. 6) of both tables of the exact 1M
    state at capacity 2^20 (the main path's build), at a table capacity
    of next_pow2(max n_buckets) and M = 6: ``neighbor_dists``
    ``torch.equal`` to its plain version, timed beside ``torch.cdist(p=0)``
    and its byte and compare bounds; ``ring(i, k)`` equal to
    ``hamming_to_buckets(...) == k`` for 64 buckets a table, k = 1..6;
    then points anchored on live rows (4,096, more until every table
    gains a bucket) ingested with W kept, and Alg. 9's update ``torch.equal`` to
    a fresh build of the old codes followed by the new ones and to its
    plain version, timed against the build, the plain version,
    ``torch.cdist(p=0)`` of the new codes against the live ones and its
    bound. ``neighbor_dists`` launches are counted over the builds and
    updates. Then the build at n_valid = 0 (the pure zero fill, against
    the table's byte bound) and at n_valid = B, each ``torch.equal`` to
    its plain version.
B1. The baselines on the same state: 64 paper-protocol queries x 12
    targets through the Dynamic Prober (exact), Sampling 1 % (10,000
    rows a pair; ``l2dist_rows`` launches counted over this run alone and
    the kernel held against its plain version there, on the ids as drawn
    and shuffled within each row; the ids' share of non-decreasing
    neighbours, what a sort of them would cost, and the kernel's time
    beside the per-draw and distinct-row byte bounds) and the MLP trained
    on 60 % of the queries; q-errors, ms a pair, training seconds.
D1. The five paper corpora (``CORPORA``) at their own widths (128, 300,
    300, 960, 1770), each at N = 1M: ``load``, the exact build, one
    ``estimate_batch`` of 64 queries (q-error, wall ms, peak memory); the
    workload's ``l2dist`` must take the tiled kernel at every width (k in
    2 panels at d = 960, 4 at 1770 with 8-byte copies) and never the
    general one, and is held with ``torch.equal`` against the general
    kernel (the witness), its time beside the operations bound, the
    FP32-issue ceiling and the witness's time; Sampling 1 % at d = 1770,
    and the small-input CPU-vs-GPU agreement at d = 1770 (the kernels'
    paths for rows that are not 16-byte pieces).

Then this slice's phase, the sharded deployment:

S1. The main path's corpus, queries and ingests over four ranks of one
    process group on the card (``distributed.run_ranks``: spawned
    processes, gloo, whose collectives take CUDA tensors; NCCL refuses two
    ranks on one device): ``build_sharded`` at a global capacity of 2^20
    (2^18 a shard), ``estimate_sharded`` in ``local`` and ``sync`` mode,
    ``update_sharded`` of the 16,384 points (4,096 a shard), both modes,
    ``update_sharded`` of the 40,000 (every shard grows to 2^19 together),
    both modes; launch counts zeroed before and read after this sequence
    on every rank. Checks, each fatal: (1) every rank's codes equal a
    single-device build (and its ingests) of the same points with the same
    functions, and W that state's W; (2) W the same on every rank after
    each step, and the estimates too; (3) live counts the round-robin
    ones (254,096 and 264,096 a shard); (4) ``eps = 0`` and ``s1 = 1``
    recover ``true_cardinality`` within 1e-2 in both modes (the reference's
    ``test_8dev_distributed_estimator`` config, 4,000 x 32); (5) a group
    of one rank over NCCL: build, updates and both modes ``torch.equal``
    to ``estimate_batch`` (``test_sharded_paths_on_trivial_mesh``); (6) on
    the reference's skewed split, sync mean q-error <= local and < 1.05;
    (7) two ranks on the CPU against two on the card, 8,192 x 32: equal
    integer-valued estimates, the rest within rtol 1e-5, equal
    ``probed_k`` and ``nvisited``; (8) as (7) on every rank's full-width
    shard after each step of the sequence (a CPU copy against the card,
    both modes, 8 queries tie-free over all shards). Logs q-errors beside
    the main path's, wall ms at rank 0, collectives and their ms, ingest
    points/s, and per rank the launches and peak memory. The ranks share
    one card: no time there is a scaling figure.

Then the semantic-operator serving path, through the CLI a user runs:

L1. ``repro_torch.launch.serve.main`` with ``--arch qwen2-7b --scale full
    --corpus 1000000 --emb-dim 128 --requests 8 --slots 4 --max-len 256
    --max-calls 64``: the dense LM at full width (7,615,616,512
    parameters, bfloat16, random weights from the seed) behind
    ``ServeEngine``, the ``SemanticPlanner`` over a SIFT1M-shaped corpus,
    each request's exact ranking through ``l2dist``. Launch counts zeroed
    before and read after; fatal: an operator served and one refused,
    every finished request 1-4 tokens, ``query_lanes``, ``central_qualify``
    and ``slab_loop`` launched, the replaced kernels not. Then the
    planner's kernels at the CLI's shapes (its ProberConfig, one query an
    estimate), launch counts restored after: the planner's index rebuilt
    from the seed, each request's ``l2dist`` (1M x 128 x 1) against
    ``ref.l2dist`` (rtol/atol 1e-5), and its operator, the radius moved to
    the midpoint of the target-th and next squared distance, on a CPU copy
    (plain versions) against the card with the same round keys: equal
    integer-valued estimates, ``probed_k`` and ``nvisited``, the rest
    within rtol 1e-5, on the operators tie-free (at least 6 of 8). Then at
    full width: teacher-forced ``decode_step`` against ``forward`` on 16
    tokens and SDPA (the card's attention route) against plain ``_sdpa``
    (prefill and decode shapes) within bfloat16 tolerances fixed in the
    code (``L1_LOGIT_TOL``, ``L1_SDPA_TOL``), greedy tokens equal where
    the top-2 gap exceeds the logit tolerance; a decode step beside its
    byte bound (and with plain ``_sdpa`` patched in as the route), a
    prefill, both attention forms (and the SDPA backend's kernels), and a
    profile of each.
L2. The same CLI with ``--scale smoke --shards 4`` in ``sync`` and
    ``local`` mode: four gloo ranks on the card plan every operator over
    the 1M corpus in lockstep; fatal: the plans equal on every rank (and
    the sharded coalescer's SPMD check, which raises). Logs collectives
    an estimate, wall and launches a rank. Then the sync run's operators
    on four ranks again: each rank's 250,000-row shard of the planner's
    index, the checks of L1 on a CPU copy of the shard against the card,
    in sync mode (``estimate_batch_pooled``, the group's collectives on
    both sides).

Then the other model families, through the serve steps a user calls:

L3. ``rwkv6-1.6b``, ``recurrentgemma-9b``, ``whisper-medium`` and
    ``qwen3-moe-30b-a3b`` in turn, each at its published config (full
    width; full depth where the weights fit beside ``L3_HEADROOM``, else
    the most layers that do, logged), random bfloat16 weights from the
    seed, each freed before the next. For each: parameters, GiB and init
    seconds; ``serve.step.make_prefill_step`` on an input that takes the
    family's long-sequence route (``L3_MODELS``) and 16 steps of
    ``make_decode_step`` over 4 slots, CUDA-event ms beside a step's byte
    bound (the weights a step reads, every expert for moe, and its cache);
    a profile of each (launch calls, busy share, peak memory). Fatal:
    teacher-forced ``decode_step`` against ``forward`` (whisper: against
    ``decode`` on the same ``prefill_cross``; moe with room for every
    token, so that forward drops none) on 16 tokens in bfloat16, greedy
    tokens equal wherever forward's top-2 gap exceeds ``L1_LOGIT_TOL`` and
    the max |diff| within it, or, for ``L3_F32_COPY`` (where bfloat16
    rounding alone exceeds it; the max logged), within ``L3_F32_TOL`` on a
    float32 copy at full width (moe's depth cut to fit); the SDPA route
    against plain ``_sdpa`` within ``L1_SDPA_TOL`` for whisper's encoder
    and cross-attention and rglru's ``windowed_attention``; in float32,
    rwkv6's chunked WKV against the sequential one on the first layer's
    r, k, v, w (``L3_WKV_TOL``) and rglru's doubling scan against a
    sequential loop on the first recurrent block's (a, b) at S = 4096
    (``L3_SCAN_TOL``); moe's stable top-k picks ``torch.topk``'s experts
    wherever the k-th and (k+1)-th gates differ. Logged for moe: the
    assignments forward drops at ``capacity_factor`` 1.25 over the prefill
    batch and over the check's sequence, and the gate ties at the k-th
    expert.

Last, training, through the entry points a user calls (no kernel of its
own: the reference's training path has no ``pallas_call``):

T1. a. ``launch.train.build_trainer`` for ``qwen2.5-3b`` at its published
    config (full width and depth: 36 layers, d 2048, GQA 16/2, d_ff
    11008, vocab 151,936), random float32 master weights from the seed,
    bfloat16 compute, per-layer recompute, ``make_train_step(...,
    n_microbatches=2)`` on ``TokenPipeline`` batches of 4 x 512 tokens
    (``T1_BATCH``, ``T1_SEQ``, ``T1_MICRO``) with the phase's AdamW
    (``T1_OPT``): 2 warm-up and 8 timed steps. Logs parameters, GiB,
    init seconds, each step's loss and grad norm, a step's CUDA-event ms
    split into forward+backward and clip+AdamW (an event recorded as
    ``adamw.update`` starts), tokens/s, the model-FLOP share (6·N·D over
    the step time and the 989 TFLOP/s bf16 peak; recompute's extra 2·N·D
    beside it), AdamW beside its byte bound (28 B a parameter at 3.35
    TB/s), peak memory, then a profile of one step (launch calls, busy
    share; ``phase_profile`` runs one unprofiled first: 12 steps in
    all). Fatal: every loss and grad norm finite; the loss of step 1's
    batch lower after step 1.
    b. The same config cut to 2 layers (``T1_CPU_LAYERS``) in float32 (TF32
    off), the same bridged weights on the card and on the CPU, one step of
    2 microbatches on 2 x 64 tokens. Fatal: loss within ``T1_LOSS_TOL``,
    grad norm within ``T1_RTOL``, m and v within ``T1_STATE_TOL`` of each
    leaf's largest element, params within ``T1_RTOL`` + ``T1_STEP_ATOL``·lr
    where |m| ≥ ``T1_COND`` of its leaf's largest and within one step's
    reach elsewhere (the comment at the constants says why).
    c. The first layer's q, k, v of a microbatch at full width in bfloat16
    (the causal boolean mask ``causal_attention`` passes): the SDPA
    route's dq, dk, dv against plain ``_sdpa``'s, fatal beyond
    ``T1_SDPA_GRAD_TOL`` of the largest; times, and the attention
    operators and kernels SDPA ran.
    d. ``launch.train.main`` at smoke scale on the card (24 steps, a
    checkpoint every 4; fatal unless it improves the loss), then the loop
    it builds (``build_loop``) twice, uninterrupted and with
    ``WorkerFailure`` injected at steps 7 and 13 (``T1_FT_FAIL``). Fatal:
    2 restarts, final loss and params within ``T1_FT_TOL``; logs whether
    they are bit-equal. The full-width state's checkpoints (~41 GB of npz)
    are not written here.

M1. The mesh trainer (``launch.train.build_trainer(mesh=...)``: DTensor
    parameters and AdamW state placed by ``sharding.rules.param_specs``,
    each block's weights gathered inside ``layers.remat`` by
    ``sharding.act``) on ``make_host_mesh()`` over a one-rank NCCL group
    (``launch.train.join_process_group``), beside the plain trainer, both
    built from the seed: ``qwen2.5-3b`` at its published width, depth cut
    to 12 layers (``M1_LAYERS``: both trainers fit the card together), 3
    steps on the T1 batches (4 x 512 tokens, 2 microbatches) under
    ``torch.use_deterministic_algorithms(True)``, then 3 more as users run
    them. Fatal: every parameter and ``m`` / ``v`` leaf of the mesh trainer
    a DTensor with the placements ``param_specs`` gives; in the
    deterministic steps each loss and grad norm, and after them every
    parameter, ``m`` and ``v``, bit-equal between the two trainers; in the
    default steps loss and grad norm within ``M1_TOL`` (cuDNN attention's
    backward, SDPA's route on the card, is not deterministic: the plain
    trainer does not repeat itself bit for bit there). Logs each step's
    CUDA-event ms and host ms (the call without a sync: what DTensor
    dispatch adds) for both, launch calls a step and peak memory.
    Then tensor parallelism (``m1_tensor_parallel``): the plain runs here,
    each freed before the next, then M1_TP_RANKS gloo ranks on the card
    (``run_ranks``, a (1, 4) mesh: NCCL wants a card a rank), each
    holding a quarter of the heads, d_ff, experts and vocab: the same
    qwen2.5-3b trainer for M1_STEPS default steps on the same batches,
    then qwen3-moe-30b-a3b cut to M1_MOE_LAYERS layers for one train step,
    and M1_DECODE_STEPS decode steps of 4 slots of qwen2-7b (KV = 4 over
    4: the KV-head route) and of qwen2.5-3b from position M1_SEQ_START
    (KV = 2: the sequence route, its writes crossing from rank 0's rows
    to rank 1's), each cut to M1_DECODE_LAYERS layers; those three in
    float32 compute. Fatal: a step's loss or grad norm beyond M1_TOL of
    the plain trainer's; a leaf's step-1 gradient norm beyond
    M1_LEAF_GRAD_TOL, or the norm of its change over the steps beyond
    M1_LEAF_CHANGE_TOL, of the plain trainer's; the parameters' global
    norm after the steps beyond M1_PNORM_TOL; an all-gather over "model"
    other than an activation's (``CollectiveCounter``, one more step);
    the MoE's loss or grad norm beyond M1_F32_TOL or an assignment or
    drop that differs; decode logits beyond M1_F32_TOL of their largest,
    or a decode off its route (the sequence route's combine,
    ``layers._split_attend``, counted). Logs per rank each step's
    CUDA-event and host ms, the largest per-leaf gaps, a step's
    collectives (by group) and the peak. Then the other families on the
    same ranks (``m1_fam_rank``; the plain runs first, here, each freed
    before the next): rwkv6-1.6b (4 layers, 8 of its 32 heads a rank),
    recurrentgemma-9b (5 layers: a group and a tail of 2; its LRU
    channels and 4 of 16 heads a rank, K / V gathered) and
    whisper-medium (4 + 4 layers), full width, float32: one train step
    (M1_FAM_TRAIN) against the plain step, a second one timed, then a
    prefill of 4 slots and M1_DECODE_STEPS decode steps from a random
    cache at M1_FAM_START (recurrentgemma from 2,046: its K/V ring's
    writes pass from rank 3's rows to rank 0's). Fatal: loss or grad
    norm beyond M1_F32_TOL, a leaf's gradient norm beyond M1_FAM_LEAF_TOL;
    prefill and decode logits beyond M1_F32_TOL of their largest
    (whisper's prefill, whose cross K/V the step writes in bfloat16,
    M1_FAM_PREFILL_BF16); a state leaf the steps write beyond
    M1_FAM_STATE_TOL of its largest element (each rank holds its block
    against the plain cache's); an all-gather over "model" other than an
    activation's; recurrentgemma's decode off the sequence route. Logs
    each family's step ms, collectives a step by group and peak a rank.

R1. The dry runs, each in a process of its own (a fake process group,
    apart from M1's NCCL group): ``launch.dryrun`` of ``R1_CELLS``
    (qwen2-7b ``train_4k`` on the (16, 16) mesh, qwen3-moe-235b-a22b
    ``decode_32k`` on the (2, 16, 16) one, rwkv6-1.6b ``long_500k`` on
    (16, 16)) at full size on fake ``cuda`` tensors, the three at once,
    then ``launch.dryrun_ce`` at 4,096,000 points a rank (rank 0's shard
    built and estimated on the card), its warm-up estimate holding every
    ``query_lanes`` and ``central_qualify`` call against the plain version
    and the slab loop against the host loop on the same inputs, at the
    CE's shapes (K = 12 over
    the 4,096,000-row shard, chunk 512, budget 8192). Fatal: a process
    failed, a record is missing or has a zero roofline term; the CE's
    estimates not finite, no slab step, a path kernel not launched, a
    kernel call apart from its plain version. Logs each cell's
    trace seconds, terms, traced peak a rank, collective bytes and
    attention routes, and the CE's wall time (CUDA events) and device
    peak beside the card's name and power limit.

X1. Beside R1's three traces: the five ``examples/torch_*.py`` at their
    JAX twins' sizes on the card, each in its own process, all at once.
    Fatal: an exit code.

Each phase prints its seconds. Ends with a ``{"kernels": [...]}`` line
(thirteen entries) and, last, the ``{"ok": true, ...}`` line. Exits
non-zero, printing no result, without CUDA or without the
package beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# benchmarks/common.py prober_cfg (exact path): the repo's benchmark config
CFG_KW = dict(n_tables=2, n_funcs=10, ring_budget=2048, central_budget=2048,
              chunk=128, eps=0.01)
N, DIM, CAPACITY, NQ = 1_000_000, 128, 2 ** 20, 64
N_INGEST, N_GROW = 16_384, 40_000
# the serving deployment: CardinalityCoalescer(cache_size=1024,
# max_batch=64, reuse_tol=0) on the exact state; a pool of the NQ queries x
# SERVE_RADII grid radii; SERVE_FLUSHES flushes of 64 zipfian draws; the
# main path's two ingests before the flushes named (after flushes 8, 16),
# and SERVE_TRICKLE point anchored on a live row (noise SERVE_NOISE, the
# reference's benchmarks/workloads.py _ingest_batch) before each flush of
# SERVE_TRICKLES. One point, not the reference's mixed pacing of 32 every
# 128 events: on this config a probed ball holds 14-97 % of the corpus, so
# 32 points touch every entry and the ball check would never keep one
SERVE_CACHE, SERVE_BATCH, SERVE_FLUSHES, SERVE_RADII = 1024, 64, 24, 4
ZIPF_S = 0.99
SERVE_INGESTS = {8: (N, N + N_INGEST),
                 16: (N + N_INGEST, N + N_INGEST + N_GROW)}
SERVE_TRICKLE, SERVE_NOISE = 1, 0.05
SERVE_TRICKLES = (10, 12, 14, 18, 20, 22)
# benchmarks/common.py prober_cfg(use_pq=True, d=128) and serve_cfg(d=128)
PQ_KW = dict(use_pq=True, pq_m=32, pq_kc=64, pq_iters=8)
PROBER_PQ_KW = dict(CFG_KW, pq_exact_rings=2, **PQ_KW)
SERVE_KW = dict(n_tables=1, n_funcs=12, ring_budget=1024, central_budget=512,
                chunk=512, max_visit=2048, pq_exact_rings=0,
                pq_exact_central=False, pq_int8_lut=True, **PQ_KW)
# N1: the anchored ingest (4,096 and 16,384 points made no bucket in some
# table on this seed), and the buckets a table whose rings are checked
N1_INGEST, N1_RINGS = 65536, 64
# D1: the width whose corpus also runs Sampling 1 %, and the widths of the
# CPU-vs-GPU small-input agreement (d = 128 runs with the exact path)
D1_SAMPLING_DIM = 1770
D1_AGREE_DIMS = (300, 960, 1770)
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
# H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz (Hopper white paper)
INT32_OP_S = 132 * 64 * 1.98e9
FP32_FLOP_S = 67e12            # H100 SXM fp32 outside the tensor cores
FP32_LANES_PER_SM = 128        # Hopper: 4 schedulers x 32 FP32 lanes
MARGIN = 1e-5
REPLACES = {"lsh_hash": "src/repro/kernels/lsh_hash.py:46",
            "hamming_to_buckets": "src/repro/kernels/hamming.py:32",
            "query_lanes": "src/repro/kernels/lsh_hash.py:46, "
                           "src/repro/kernels/hamming.py:32",
            "l2dist": "src/repro/kernels/l2dist.py:41",
            "l2dist_rows": "src/repro/kernels/l2dist.py:41",
            "adc_rows": "src/repro/kernels/adc.py:67",
            "adc_batch": "src/repro/kernels/adc.py:110",
            "adc_rows_q8": "src/repro/kernels/adc.py:153",
            "adc_batch_q8": "src/repro/kernels/adc.py:200",
            "slab_qualify": "src/repro/kernels/l2dist.py:41, "
                            "src/repro/kernels/adc.py:67",
            "slab_loop": "src/repro/core/prober.py:390 (the slab "
                         "while_loop), src/repro/kernels/l2dist.py:41, "
                         "src/repro/kernels/adc.py:67",
            "central_qualify": "src/repro/kernels/adc.py:153, "
                               "src/repro/kernels/adc.py:67, "
                               "src/repro/kernels/l2dist.py:41",
            "cache_insert": "src/repro/cache/estimate_cache.py:166 (insert, "
                            "a jax.lax.fori_loop; no pallas_call)",
            "neighbor_dists": "src/repro/core/neighbors.py:26 "
                              "(_pairwise_hamming, jnp; no pallas_call)"}
# the kernels every estimator path launches under local stopping (the slab
# loop in one launch; pooled stopping steps it with slab_qualify), and the
# ones they replaced there (still built and held against their plain
# versions)
PATH_KERNELS = ("query_lanes", "slab_loop", "central_qualify")
EXACT_KERNELS = PATH_KERNELS + ("l2dist",)
# R1: the dry-run cells (arch, shape, mesh) and the CE's points a rank; X1:
# the examples; each phase's processes' time limit, seconds
R1_CELLS = (("qwen2-7b", "train_4k", "single"),
            ("qwen3-moe-235b-a22b", "decode_32k", "multi"),
            ("rwkv6-1.6b", "long_500k", "single"))
R1_CE_POINTS, R1_TIMEOUT = 4_096_000, 300
X1_EXAMPLES = ("torch_quickstart", "torch_dynamic_updates",
               "torch_distributed_estimate", "torch_serve_semantic",
               "torch_train_tiny_lm")
REPLACED = ("lsh_hash", "hamming_to_buckets", "l2dist_rows", "adc_rows",
            "adc_rows_q8")
SOURCES = {"lsh_hash": "lsh_hash.cu", "hamming_to_buckets": "hamming.cu",
           "query_lanes": "hamming.cu", "l2dist": "l2dist.cu",
           "l2dist_rows": "l2dist.cu", "adc_rows": "adc.cu",
           "adc_batch": "adc.cu", "adc_rows_q8": "adc.cu",
           "adc_batch_q8": "adc.cu", "slab_qualify": "slab.cu",
           "slab_loop": "slab.cu",
           "central_qualify": "slab.cu", "cache_insert": "cache.cu",
           "neighbor_dists": "neighbors.cu"}

def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` launches, warmed up."""
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


def smi_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else f"nvidia-smi failed: {smi.stderr.strip()}")


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} (count {torch.cuda.device_count()})")
    log(smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return name


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.load()
    log(f"build: {built.seconds:.3f} s nvcc, {time.perf_counter() - t0:.3f} s "
        f"in all -> {built.path.name}")
    for line in built.ptxas:
        log(f"  {line}")


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock as ``nvidia-smi`` reports it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(smi.stdout.split()[0]) * 1e6


def fp32_ceiling_ms(torch, flops: float) -> float:
    """The FP32-issue ceiling of the difference form: ``flops`` / 2 FADD
    and as many FFMA lane instructions, one warp instruction per scheduler
    a clock on every SM at the card's maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return flops / (sms * FP32_LANES_PER_SM * max_sm_clock_hz()) * 1e3


def clocks_under_load(torch, fn, seconds: float = 2.0):
    """(SM MHz, board W) samples of ``nvidia-smi`` every 100 ms while ``fn``
    runs back to back for ``seconds`` (the first second's samples dropped:
    the query starts before the load settles)."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1.0 + seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=60)[0]
    rows = [tuple(map(float, ln.split(","))) for ln in out.splitlines()
            if ln.count(",") == 1]
    return rows[10:]


def sass_mix(lib_path, kernel: str):
    """FADD, FFMA and all instructions in the span from the first to the
    last FADD/FFMA of ``kernel``'s SASS in the built library (the unrolled
    k loop), from ``cuobjdump``; None where the toolkit lacks it."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120).stdout
    for body in sass.split("Function : ")[1:]:
        if f"{kernel}E" not in body.split("\n", 1)[0]:
            continue
        ops = []
        for ln in body.splitlines():
            # "/*0a40*/   @P0 FADD R1, R2, -R3 ;   /* 0x... */"
            words = ln.split("*/", 1)[1].split() if ln.strip().startswith(
                "/*") else []
            if words:
                op = words[1] if words[0].startswith("@") else words[0]
                ops.append(op.split(".")[0])
        fp = [i for i, o in enumerate(ops) if o in ("FADD", "FFMA")]
        span = ops[fp[0]:fp[-1] + 1]
        return span.count("FADD"), span.count("FFMA"), len(span)
    return None


def near_integer(torch, x, a, b, w):
    v = (x.double() @ a.double() + (b * w).double()) / w.double()
    return (v - torch.round(v)).abs() < MARGIN


def phase_kernels(torch, corpus, qs, taus, index, cfg) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    from repro_torch.core import lsh
    from repro_torch.kernels import ops, ref
    res = {}
    p = index.params
    x = corpus[:N]
    dev = x.device

    # lsh_hash: the query hash (64 x 128 -> 20) and the 1M corpus
    for tag, xx in (("queries", qs), ("corpus", x)):
        got = ops.lsh_hash(xx, p.a, p.b, p.w)
        want = ref.lsh_hash(xx, p.a, p.b, p.w)
        near = near_integer(torch, xx, p.a, p.b, p.w)
        flips = int((got != want).sum())
        bad = int(((got != want) & ~near).sum())
        log(f"lsh_hash[{tag} {tuple(xx.shape)}]: {flips} codes differ, "
            f"{int(near.sum())} values within {MARGIN} of an integer")
        if bad:
            raise AssertionError(f"lsh_hash: {bad} codes differ outside "
                                 "the margin")
    n, d, f = qs.shape[0], qs.shape[1], p.a.shape[1]
    res["lsh_hash"] = dict(
        max_abs_err=float((ops.lsh_hash(qs, p.a, p.b, p.w)
                           - ref.lsh_hash(qs, p.a, p.b, p.w)).abs().max()),
        ms=cuda_ms(torch, lambda: ops.lsh_hash(qs, p.a, p.b, p.w)),
        plain_ms=cuda_ms(torch, lambda: ref.lsh_hash(qs, p.a, p.b, p.w)),
        bound=bound_ms(*ops.lsh_hash_work(n, d, f)), library_ms=None)
    nx = x.shape[0]
    k_ms = cuda_ms(torch, lambda: ops.lsh_hash(x, p.a, p.b, p.w))
    p_ms = cuda_ms(torch, lambda: ref.lsh_hash(x, p.a, p.b, p.w), iters=5)
    b_ms = bound_ms(*ops.lsh_hash_work(nx, d, f))[0]
    log(f"lsh_hash[corpus] kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms (the main path hashes the corpus by project_raw and "
        "quantize, not by this kernel)")

    # hamming_to_buckets: (Q, L, B) = (64, 2, 2^20)
    qcodes = lsh.hash_point(p, qs, cfg.n_tables)
    bc, nb = index.bucket_codes, index.n_buckets
    got = ops.hamming_to_buckets(bc, qcodes, nb)
    want = ref.hamming_to_buckets(bc, qcodes, nb)
    if not torch.equal(got, want):
        raise AssertionError("hamming_to_buckets differs from its plain "
                             "version")
    nl, nbk, k = bc.shape
    # torch.cdist(p=0) counts the same mismatches, as (L, B, Q) and unmasked
    qt = qcodes.transpose(0, 1).float().contiguous()
    bcf = bc.float()
    lib = torch.cdist(bcf, qt, p=0)
    live = torch.arange(nbk, device=dev)[None, :] < nb[:, None]
    if not torch.equal(lib.permute(2, 0, 1)[:, live], want[:, live].float()):
        raise AssertionError("torch.cdist(p=0) differs from the Hamming "
                             "counts on live buckets")
    del lib
    res["hamming_to_buckets"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(torch, lambda: ops.hamming_to_buckets(bc, qcodes, nb)),
        plain_ms=cuda_ms(torch, lambda: ref.hamming_to_buckets(bc, qcodes, nb),
                         iters=5),
        # codes are read only for the live bucket rows (the rest are masked)
        bound=bound_ms(*ops.hamming_to_buckets_work(NQ, nl, nbk, k,
                                                    live=int(nb.sum()))),
        library_ms=cuda_ms(torch, lambda: torch.cdist(bcf, qt, p=0), iters=5))
    del got, want, bcf
    log(f"hamming_to_buckets{tuple(qcodes.shape[:2]) + (nbk,)}: exact")
    res["query_lanes"] = phase_query_lanes(torch, index, qs, "2^20")

    # l2dist_rows: one slab's shape (128 lanes x 128) and the central pass
    # (128 lanes x 2048), lane i holding query i // L
    g = torch.Generator(device=dev).manual_seed(1)
    lane_q = torch.arange(NQ * cfg.n_tables, device=dev) // cfg.n_tables
    qs_l, tsq_l = qs[lane_q].contiguous(), (taus * taus)[lane_q]
    for c in (cfg.chunk, cfg.central_budget):
        ids = torch.randint(0, x.shape[0], (qs_l.shape[0], c), generator=g,
                            device=dev, dtype=torch.int32)
        got = ops.l2dist_rows(x, ids, qs_l)
        want = ref.l2dist_rows(x, ids, qs_l)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        check_decisions(torch, f"l2dist_rows{tuple(ids.shape) + (d,)}", got,
                        want, tsq_l[:, None])
        if c == cfg.central_budget:
            r = ids.shape[0]
            res["l2dist_rows"] = dict(
                max_abs_err=float((got - want).abs().max()),
                ms=cuda_ms(torch, lambda: ops.l2dist_rows(x, ids, qs_l)),
                plain_ms=cuda_ms(torch, lambda: ref.l2dist_rows(x, ids, qs_l)),
                bound=bound_ms(*ops.l2dist_rows_work(r, c, d)),
                library_ms=None)
            log(f"l2dist_rows{tuple(ids.shape) + (d,)}: kernel "
                f"{kernel_device_us(torch, lambda: ops.l2dist_rows(x, ids, qs_l), 'l2dist_rows_kernel'):.2f}"
                " us per launch on the device (profiler)")

    # l2dist: true_cardinality / query-workload shapes, 1M and the ragged
    # 1,016,384 (not a multiple of the 128-row tile) x 64; the tiled kernel
    # is bit-equal to the general one (the same fmaf order)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_hz = max_sm_clock_hz()
    for nl in (N, N + N_INGEST):
        xl = corpus[:nl]
        if ops.l2dist_plan(nl, NQ, d, xl.data_ptr(), qs.data_ptr()) is None:
            raise AssertionError(f"l2dist at {nl} x {NQ} x {d} does not take "
                                 "the tiled kernel")
        got = ops.l2dist(xl, qs)
        if not torch.equal(got, ops.l2dist_general(xl, qs)):
            raise AssertionError(f"l2dist at {nl} rows: the tiled kernel "
                                 "differs from the general one")
        want = ref.l2dist(xl, qs)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        nbytes, flops = ops.l2dist_work(nl, NQ, d)
        r = dict(
            max_abs_err=float((got - want).abs().max()),
            ms=cuda_ms(torch, lambda: ops.l2dist(xl, qs)),
            plain_ms=cuda_ms(torch, lambda: ref.l2dist(xl, qs), iters=3),
            bound=bound_ms(nbytes, flops),
            library_ms=cuda_ms(torch, lambda: torch.cdist(xl, qs) ** 2))
        del got, want
        general_ms = cuda_ms(torch, lambda: ops.l2dist_general(xl, qs))
        ceiling = fp32_ceiling_ms(torch, flops)
        log(f"l2dist[{nl} x {NQ} x {d}]: tiled kernel {r['ms']:.4f} ms "
            f"(bit-equal to the general kernel, {general_ms:.4f} ms); plain "
            f"{r['plain_ms']:.4f} ms, torch.cdist ** 2 "
            f"{r['library_ms']:.4f} ms; bounds: bytes "
            f"{nbytes / HBM_BYTES_S * 1e3:.4f} ms, operations "
            f"{flops / FP32_FLOP_S * 1e3:.4f} ms; FP32-issue ceiling "
            f"{ceiling:.4f} ms ({sms} SMs x {FP32_LANES_PER_SM} lanes at "
            f"{sm_hz / 1e6:.0f} MHz); max_abs_err {r['max_abs_err']}")
        if nl == N:
            res["l2dist"] = r
    # what the FP32-issue ceiling assumes: the clock under this load, and
    # an instruction stream of FADD and FFMA alone
    rows = sorted(clocks_under_load(torch, lambda: ops.l2dist(x, qs)))
    if rows:
        mhz = rows[len(rows) // 2][0]
        at_mhz = 2 * N * NQ * d / (sms * FP32_LANES_PER_SM * mhz * 1e6)
        log(f"l2dist under load ({len(rows)} samples): SM clock "
            f"{rows[0][0]:.0f}-{rows[-1][0]:.0f} MHz, median {mhz:.0f}; "
            f"board power {min(w for _, w in rows):.2f}-"
            f"{max(w for _, w in rows):.2f} W; FP32-issue ceiling at the "
            f"median clock {at_mhz * 1e3:.4f} ms")
    from repro_torch.kernels import build
    # the instantiation d = 128 takes: 16-byte copies, one panel
    mix = sass_mix(build.load().path, "l2dist_tiled_kernelILi16ELb0E")
    log("l2dist_tiled_kernel k loop (SASS): " + (
        "not measured (no cuobjdump)" if mix is None else
        f"{mix[0]} FADD + {mix[1]} FFMA of {mix[2]} instructions = "
        f"{(mix[0] + mix[1]) / mix[2]:.4f}"))
    for name, r in res.items():
        log(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), library "
            f"{r['library_ms']}, max_abs_err {r['max_abs_err']}")
    return res


def phase_query_lanes(torch, index, qs, tag) -> dict:
    """``query_lanes`` over ``index``'s buckets at the queries' shape:
    ``torch.equal`` to ``lsh_hash`` plus ``hamming_to_buckets`` (the two
    launches it replaced on the main path), and against its plain version
    (codes may differ only where a hash value lies within MARGIN of an
    integer; distances equal on the kernel's codes); CUDA-event times beside
    the two kernels' and ``hamming_to_buckets``' alone, and device times.
    Returns the kernel's result entry."""
    from repro_torch.kernels import ops, ref
    p = index.params
    bc, nb = index.bucket_codes, index.n_buckets
    nl, nbk, k = bc.shape
    nq, d = qs.shape
    f = p.a.shape[1]
    args = (qs, p.a, p.b, p.w, bc, nb)

    def replaced():
        codes = ops.lsh_hash(qs, p.a, p.b, p.w).reshape(nq, nl, k)
        return codes, ops.hamming_to_buckets(bc, codes, nb)

    qcodes, ham = ops.query_lanes(*args)
    want = replaced()
    if not (torch.equal(qcodes, want[0]) and torch.equal(ham, want[1])):
        raise AssertionError(f"query_lanes[{tag}] differs from lsh_hash + "
                             "hamming_to_buckets")
    del want
    pcodes, near = hold_query_lanes(torch, tag, args, (qcodes, ham))
    live = int(nb.sum())
    res = dict(
        max_abs_err=float((qcodes - pcodes).abs().max()),
        ms=cuda_ms(torch, lambda: ops.query_lanes(*args)),
        plain_ms=cuda_ms(torch, lambda: ref.query_lanes(*args), iters=5),
        # queries, a, b, w, the live bucket rows, n_buckets; codes and
        # distances out
        bound=bound_ms(*ops.query_lanes_work(nq, d, nl, nbk, k, live)),
        library_ms=None)
    # other worker counts (blocks that scan the live tiles and hash): 4, 8
    # and 32 per SM over the L tables beside the default 16, and one per
    # tile (every live tile its own block and hash)
    sms = torch.cuda.get_device_properties(qs.device).multi_processor_count
    tiles = -(-nbk // 256)
    grids = []
    for per_sm in (4, 8, 32, None):
        workers = tiles if per_sm is None else per_sm * sms // nl
        got = ops.query_lanes(*args, workers=workers)
        if not (torch.equal(got[0], qcodes) and torch.equal(got[1], ham)):
            raise AssertionError(f"query_lanes[{tag}] with {workers} workers "
                                 "a table differs from the default")
        del got
        grids.append((per_sm, workers, cuda_ms(
            torch, lambda: ops.query_lanes(*args, workers=workers))))
    del ham
    both_ms = cuda_ms(torch, replaced)
    ham_ms = cuda_ms(torch, lambda: ops.hamming_to_buckets(bc, qcodes, nb))
    hash_ms = cuda_ms(torch, lambda: ops.lsh_hash(qs, p.a, p.b, p.w))
    dev_us = kernel_device_us(torch, lambda: ops.query_lanes(*args),
                              "query_lanes_kernel")
    ham_us = kernel_device_us(torch, lambda: ops.hamming_to_buckets(
        bc, qcodes, nb), "hamming_kernel")
    log(f"query_lanes[{tag}, ({nq}, {nl}, {nbk}), K = {k}]: torch.equal to "
        f"lsh_hash + hamming_to_buckets; {int((qcodes != pcodes).sum())} "
        f"codes differ from the plain version, {int(near.sum())} hash "
        f"values within {MARGIN} of an integer")
    log(f"  wrapper {res['ms']:.4f} ms (CUDA events); the two it replaced "
        f"{both_ms:.4f} ms (lsh_hash {hash_ms:.4f}, hamming_to_buckets "
        f"{ham_ms:.4f}); against hamming_to_buckets alone "
        f"{res['ms'] / ham_ms:.4f} ("
        f"{'within' if res['ms'] <= 1.05 * ham_ms else 'NOT within'} 5%); "
        f"device {dev_us:.2f} us per launch, hamming_kernel {ham_us:.2f} us; "
        f"plain {res['plain_ms']:.4f} ms; bound {res['bound'][0]:.4f} ms "
        f"({res['bound'][1]}); live bucket rows {live} of {nl * nbk}")
    log(f"  workers (blocks that scan live tiles and hash; {tiles} tiles a "
        f"table): 16 per SM (default, {16 * sms // nl} a table) "
        f"{res['ms']:.4f} ms; " + ", ".join(
            f"{'one per tile' if per_sm is None else f'{per_sm} per SM'} "
            f"({workers} a table) {ms:.4f} ms ({ms / ham_ms:.4f} of "
            "hamming_to_buckets)" for per_sm, workers, ms in grids)
        + " (equal results)")
    return res


def hold_query_lanes(torch, tag, args, got):
    """``got`` = ``ops.query_lanes(*args)`` against its plain version on
    the same inputs: codes may differ only where a hash value lies within
    MARGIN of an integer; distances equal ``ref.hamming_to_buckets`` on the
    kernel's codes. Returns the plain codes and the margin mask."""
    from repro_torch.kernels import ref
    qs, a, b, w, bc, nb = args
    qcodes, ham = got
    pcodes, _ = ref.query_lanes(*args)
    near = near_integer(torch, qs, a, b, w).reshape(qcodes.shape)
    if ((qcodes != pcodes) & ~near).any() or not torch.equal(
            ham, ref.hamming_to_buckets(bc, qcodes, nb)):
        raise AssertionError(f"query_lanes[{tag}] differs from its plain "
                             "version off the margin")
    return pcodes, near


def exact_ties(torch, qual, ids, lanes, ok):
    """Per row of candidates ``ids`` (R, c) of lanes ``lanes`` (R,), the
    ones under ``ok`` whose d² (float64) lies within MARGIN τ² of τ²: where
    the exact route's float32 sums may round the other way."""
    d2 = ((qual.x[ids.long()].double() - qual.qs[lanes][:, None].double())
          ** 2).sum(-1)
    t2 = qual.tau_sq[lanes][:, None].double()
    return (((d2 - t2).abs() <= MARGIN * t2) & ok).sum(1, dtype=torch.int32)


def hold_slab(torch, tag, slab, qual, chunk, got):
    """``got`` = ``ops.slab_qualify(*slab, qual, chunk)`` against its
    plain version on the same inputs: sample counts equal; hard sums apart
    only by candidates whose d² lies within MARGIN τ² of τ² (exact-route
    lanes), banded sums within rtol 1e-6. Returns the plain result, the
    candidate mask ``ok``, the exact-route lanes and the ties a lane."""
    from repro_torch.kernels import ref
    plain = ref.slab_qualify(*slab, qual, chunk)
    ids, ok = ref.slab_candidates(*slab, chunk)
    k, lanes, prings = slab[0], slab[2], slab[5]
    exact = (k.clamp_max(prings.shape[1]) <= qual.exact_rings) | \
        (qual.codes is None)
    if not torch.equal(got[1], plain[1]):
        raise AssertionError(f"slab_qualify[{tag}]: sample counts differ "
                             "from the plain version")
    ties = torch.zeros_like(got[1])
    if exact.any():
        ex = torch.nonzero(exact).squeeze(1)
        ties[ex] = exact_ties(torch, qual, ids[ex], lanes[ex], ok[ex])
    if qual.resid is not None:
        torch.testing.assert_close(got[0], plain[0], rtol=1e-6, atol=1e-6)
    elif ((got[0] - plain[0]).abs() > ties).any():
        raise AssertionError(f"slab_qualify[{tag}]: weight sums differ from "
                             "the plain version")
    return plain, ok, exact, ties


def hold_slab_loop(torch, tag, pre, got, ctx, view, lane_t, qual, cfg):
    """The slab loop's final state ``got`` (``prober._loop_lanes`` from
    the state ``pre``) against the host loop of ``slab_qualify`` steps on
    a copy of ``pre``: every field bit-equal (the kernel's stopping rule
    is the host loop's, rounded alike). Returns the lanes held."""
    from repro_torch.core import prober
    want = prober._run_lanes({k: v.clone() for k, v in pre.items()}, ctx,
                             view, lane_t, qual, cfg)
    for k, v in got.items():
        a, b = (t.view(torch.int32) if t.dtype == torch.float32 else t
                for t in (v, want[k]))
        if not torch.equal(a, b):
            raise AssertionError(f"slab_loop[{tag}]: {k} differs from the "
                                 f"host loop in {int((a != b).sum())} lanes")
    return got["k"].numel()


@contextlib.contextmanager
def holding_loop(torch, tag, when=lambda: True):
    """Inside, every ``prober._loop_lanes`` call for which ``when()`` holds
    is held against the host loop on a copy of its input state
    (:func:`hold_slab_loop`). Yields a list holding the count of calls
    held."""
    from repro_torch.core import prober
    loop_lanes = prober._loop_lanes
    held = [0]

    def run(state, ctx, view, lane, lane_t, qual, cfg):
        pre = {k: v.clone() for k, v in state.items()} if when() else None
        counts = loop_lanes(state, ctx, view, lane, lane_t, qual, cfg)
        if pre is not None:
            hold_slab_loop(torch, tag, pre, state, ctx, view, lane_t, qual,
                           cfg)
            held[0] += 1
        return counts

    prober._loop_lanes = run
    try:
        yield held
    finally:
        prober._loop_lanes = loop_lanes


def held_estimate(torch, tag, fn, want):
    """One more estimate ``fn()`` with its slab loop held against the host
    loop (:func:`holding_loop`), launch counts restored after it; its
    results must equal ``want``, the same call's earlier results."""
    from repro_torch.kernels import ops
    saved = dict(ops.LAUNCHES)
    with holding_loop(torch, tag) as held:
        got = fn()
    ops.LAUNCHES.update(saved)
    if held[0] != 1:
        raise AssertionError(f"slab_loop[{tag}]: {held[0]} loops held, "
                             "want 1")
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{tag}: the held estimate differs from the "
                             "earlier call")
    log(f"slab_loop[{tag}]: the estimate's loop bit-equal to the host loop "
        "in every state field; results equal to the earlier call's")


def hold_central(torch, tag, args, got):
    """``got`` = ``ops.central_qualify(*args)`` against its plain version
    on the same inputs: seen and total equal; on the exact route the sums
    apart only by candidates whose d² lies within MARGIN τ² of τ², banded
    sums within rtol 1e-6, the other ADC routes' sums equal. Returns the
    plain result and the ties a lane."""
    from repro_torch.kernels import ref
    qcodes, tid, bc, nb, starts, sizes, order, qual, exact, budget = args
    plain = ref.central_qualify(*args)
    for i, what in ((1, "seen"), (2, "total")):
        if not torch.equal(got[i], plain[i]):
            raise AssertionError(f"central_qualify[{tag}]: {what} differs "
                                 "from the plain version")
    ties = torch.zeros_like(got[1])
    if exact:
        ids, valid, _, _ = ref.central_ids(qcodes, tid, bc, nb, starts,
                                           sizes, order, budget)
        lanes = torch.arange(ids.shape[0], device=ids.device)
        ties = exact_ties(torch, qual, ids, lanes, valid)
    if not exact and qual.resid is not None:
        torch.testing.assert_close(got[0], plain[0], rtol=1e-6, atol=1e-6)
    elif ((got[0] - plain[0]).abs() > ties).any():
        raise AssertionError(f"central_qualify[{tag}]: sums differ from the "
                             "plain version")
    return plain, ties


def every_row_live(torch, index):
    """``index`` with every bucket row live, for ``phase_query_lanes``:
    random codes in [-3, 3] over the whole (L, B, K) bucket axis and
    ``n_buckets`` = B, so that no tile is padding and every cluster
    hashes (the hash reads only the params, the scan the codes)."""
    bc = index.bucket_codes
    g = torch.Generator(device=bc.device).manual_seed(7)
    return index._replace(
        bucket_codes=torch.randint(-3, 4, bc.shape, generator=g,
                                   device=bc.device, dtype=torch.int32),
        n_buckets=torch.full_like(index.n_buckets, bc.shape[1]),
        n_buckets_max=bc.shape[1])


def q_errors(torch, est, truth):
    e, t = est.double().clamp_min(1.0), truth.double().clamp_min(1.0)
    return torch.maximum(e / t, t / e)


def summarize(torch, tag, est, truth):
    if not torch.isfinite(est).all() or (est < 0).any():
        raise AssertionError(f"{tag}: non-finite or negative estimate")
    qe = q_errors(torch, est, truth)
    stats = (float(qe.mean()), float(qe.median()),
             float(torch.quantile(qe, 0.95)), float(qe.max()))
    log(f"{tag}: q-error mean {stats[0]:.4f} median {stats[1]:.4f} p95 "
        f"{stats[2]:.4f} max {stats[3]:.4f}")
    return stats


def phase_main_path(torch, corpus, cfg, seed):
    """The port's main path at SIFT1M scale; returns the launch counts, the
    grown state, the queries and radii, and the q-errors at each stage."""
    from repro_torch.core import estimator as E
    from repro_torch.data import vectors
    from repro_torch.kernels import ops
    dev = corpus.device
    g = torch.Generator(device=dev).manual_seed(seed + 1)

    def expect_live(state, n):
        if int(state.n_valid) != n:
            raise AssertionError(f"n_valid {int(state.n_valid)} != {n}")
        log(f"n_valid {n}, capacity {state.capacity}")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state, t_build = timed(torch, lambda: E.build(
        corpus[:N], cfg, g, capacity=CAPACITY, device=dev))
    expect_live(state, N)
    log(f"build: {t_build:.3f} s (N {N}, capacity {CAPACITY}, buckets "
        f"{state.index.n_buckets.tolist()})")
    (qs, taus_grid, cards), t_wl = timed(
        torch, lambda: vectors.paper_query_workload(g, corpus[:N], NQ))
    taus = taus_grid[torch.arange(NQ, device=dev),
                     torch.arange(NQ, device=dev) % taus_grid.shape[1]]
    log(f"query workload: {t_wl:.3f} s, {taus_grid.shape[1]} targets, "
        f"one per query round robin; tau grid digest {digest(taus_grid)}, "
        f"cardinalities digest {digest(cards)}")
    rks = E.draw_round_keys(g, NQ, cfg.n_tables, dev)

    for rnd in ("first", "second"):
        out, t_est = timed(torch, lambda: E.estimate_batch_stats(
            state, qs, taus, cfg, rks=rks))
        log(f"estimate_batch_stats ({rnd} call, Q={NQ}): {t_est * 1e3:.3f} ms")
        if rnd == "second" and not all(torch.equal(a, b)
                                       for a, b in zip(first, out)):
            raise AssertionError("estimate_batch_stats is not deterministic")
        first = out
    held_estimate(torch, "main path @ N", lambda: E.estimate_batch_stats(
        state, qs, taus, cfg, rks=rks), first)
    est, probed_k, nvis = first
    truth = truth_line(torch, "@ N", E.true_cardinality(state.x, qs, taus,
                                                          n_valid=N))
    qerr = {"@ N": summarize(torch, "estimate @ N", est, truth)}
    log(f"  probed_k mean {float(probed_k.float().mean()):.3f}, nvisited "
        f"mean {float(nvis.float().mean()):.1f}")

    state, t_up = timed(torch, lambda: E.update(
        state, corpus[N:N + N_INGEST], cfg))
    expect_live(state, N + N_INGEST)
    if state.capacity != CAPACITY:
        raise AssertionError("in-capacity update changed the capacity")
    log(f"update (in capacity, {N_INGEST} points): {t_up:.3f} s = "
        f"{N_INGEST / t_up:.1f} points/s")
    est, t_est = timed(torch, lambda: E.estimate_batch(
        state, qs, taus, cfg, generator=g))
    truth = truth_line(torch, "@ N+ingest", E.true_cardinality(
        state.x, qs, taus, n_valid=N + N_INGEST))
    log(f"estimate_batch after ingest: {t_est * 1e3:.3f} ms")
    qerr["@ N+ingest"] = summarize(torch, "estimate @ N+ingest", est, truth)

    n_all = N + N_INGEST + N_GROW
    state, t_grow = timed(torch, lambda: E.update(
        state, corpus[N + N_INGEST:n_all], cfg))
    expect_live(state, n_all)
    log(f"update (past capacity, {N_GROW} points): {t_grow:.3f} s, capacity "
        f"{CAPACITY} -> {state.capacity}")
    est, t_est = timed(torch, lambda: E.estimate_batch(
        state, qs, taus, cfg, generator=g))
    truth = truth_line(torch, "@ grown", E.true_cardinality(
        state.x, qs, taus, n_valid=n_all))
    log(f"estimate_batch after growth: {t_est * 1e3:.3f} ms")
    qerr["@ grown"] = summarize(torch, "estimate @ grown", est, truth)
    counts = dict(ops.LAUNCHES)
    nl, nk, nb = cfg.n_tables, cfg.n_funcs, state.capacity
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2 ** 30:.3f}"
        f" GiB (ring cumsums alone: {NQ * nl * (nk + 1) * nb * 4 / 2 ** 30:.3f}"
        f" GiB at B = {nb})")
    log(f"main-path launches: {json.dumps(counts)}")
    missing = [k for k in EXACT_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    all_tiled(counts, "exact main path")
    none_replaced(counts, "exact main path")
    log(f"per estimate: {counts['query_lanes'] / 4:g} query_lanes and "
        f"{counts['central_qualify'] / 4:g} central_qualify launches (4 "
        "estimates)")
    return counts, state, qs, taus, qerr


def digest(t) -> str:
    """A short digest of a tensor's bytes, for comparing logs."""
    raw = t.contiguous().cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def truth_line(torch, tag, truth):
    """Log the sum and max of a ``true_cardinality`` call's counts."""
    log(f"true_cardinality {tag}: sum {int(truth.sum())}, max "
        f"{int(truth.max())}, digest {digest(truth)}")
    return truth


def all_tiled(counts, tag):
    """Every ``l2dist`` launch in ``counts`` took the tiled kernel."""
    if counts["l2dist_general"]:
        raise AssertionError(f"{tag}: {counts['l2dist_general']} of "
                             f"{counts['l2dist']} l2dist launches took the "
                             "general kernel")


def none_replaced(counts, tag):
    """No kernel that ``query_lanes`` or ``central_qualify`` replaced on
    the estimator's path launched in ``counts``."""
    ran = {k: counts[k] for k in REPLACED if counts[k]}
    if ran:
        raise AssertionError(f"{tag}: replaced kernels launched: {ran}")


def exact_profile_runs(torch, state, qs, taus, cfg, seed):
    """One estimate_batch and one in-capacity update of the grown state."""
    from repro_torch.core import estimator as E
    g = torch.Generator(device=qs.device).manual_seed(seed + 3)
    extra = torch.randn((N_INGEST, DIM), generator=g, device=qs.device)
    return [("estimate_batch", lambda: E.estimate_batch(
                state, qs, taus, cfg, generator=g)),
            ("update", lambda: E.update(state, extra, cfg))]


KERNEL_NAMES = ("lsh_hash_kernel", "hamming_kernel", "query_lanes_kernel",
                "l2dist_kernel", "l2dist_tiled_kernel", "l2dist_rows_kernel",
                "adc_rows_kernel", "adc_batch_kernel", "slab_qualify_kernel",
                "central_qualify_kernel", "cache_insert_keys_kernel",
                "cache_insert_chain_kernel", "cache_insert_write_kernel",
                "neighbor_dists_kernel")
LAUNCH_API = ("cudaLaunchKernel", "cuLaunchKernel")   # and their Ex forms


def launch_calls(ka) -> int:
    return sum(e.count for e in ka if e.key.startswith(LAUNCH_API))


def slab_setup(torch, state, qs, taus, cfg, seed):
    """The slab kernel's inputs at a main-path slab of ``state``: every
    lane of the queries, shuffled, each in a random ring 1..K+1 (K+1: a
    finished lane) at a random slab 0..(its PRP domain's slab count), so
    that draws past the sample cap and past the domain occur. Returns the
    slab arguments, the qualification, and what ``_slab_step`` reads."""
    from repro_torch.core import estimator as E, lsh, prober
    dev = qs.device
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    nl, nk = cfg.n_tables, cfg.n_funcs
    view = prober.table_views(state.index)
    qcodes, ham = lsh.query_lanes(state.index.params, qs, view.bucket_codes,
                                  view.n_buckets)
    nql = qs.shape[0] * nl
    lane = torch.arange(nql, device=dev)
    qual = prober._make_qual(state.x, qs, taus * taus, lane // nl, cfg,
                             **E._pq_args(state, qs, cfg))
    rks = E.draw_round_keys(g, qs.shape[0], nl, dev).reshape(nql, 6)
    ctx, est0, vis0 = prober._table_setup(
        view, ham, qcodes, rks, lane % nl, qual,
        qual.codes is None or cfg.pq_exact_central, cfg)
    del ham
    lanes = torch.randperm(nql, generator=g, device=dev)
    k = torch.randint(1, nk + 2, (nql,), generator=g, device=dev,
                      dtype=torch.int32)
    p_ring = ctx.prings[lanes].gather(
        1, (k.clamp_max(nk).long() - 1)[:, None]).squeeze(1)
    n_slabs = (p_ring + cfg.chunk - 1) // cfg.chunk
    ci = (torch.rand(nql, generator=g, device=dev) * (n_slabs + 1)).int()
    slab = (k, ci, lanes, lanes % nl, ctx.rks[lanes], ctx.prings[lanes],
            ctx.caps[lanes], ctx.nbits[lanes], ctx.cums, view.bucket_starts,
            view.order)
    state0 = prober._init_state(ctx, est0, vis0, nk)
    return slab, qual, (ctx, view, state0)


def launches_of(torch, fn) -> tuple[int, int]:
    """(host launch calls, device kernels) of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    host = launch_calls(ka)
    dev = sum(e.count for e in ka if e.device_type == DeviceType.CUDA
              and "memcpy" not in e.key.lower()
              and "memset" not in e.key.lower())
    return host, dev


def kernel_device_us(torch, fn, name, iters=20, per_call=False) -> float:
    """Profiler device time per launch of the kernels whose names hold
    ``name`` over ``iters`` calls of ``fn`` (0 when the profiler saw
    none); with ``per_call``, their sum per call of ``fn`` (a wrapper that
    launches several kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [(_device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    n = iters if per_call and hits else sum(c for _, c in hits)
    return sum(t for t, _ in hits) / n if n else 0.0


def phase_slab(torch, tag, state, qs, taus, cfg, seed, step=False,
               requal=None) -> dict:
    """``slab_qualify`` against the slab path's composition before the
    fusion (the torch candidate walk and the row kernels: the same sums)
    and against its plain version (hard weights may move only where a d²
    lies within MARGIN tau^2 of tau^2; banded sums within rtol 1e-6), with
    CUDA-event and profiler times beside the bound; with ``step`` also the
    launches of one slab step. ``requal`` may replace the qualification
    inputs. Returns the kernel's result entry."""
    from repro_torch.core import prober
    from repro_torch.kernels import ops, ref
    slab, qual, (ctx, view, state0) = slab_setup(torch, state, qs, taus,
                                                 cfg, seed)
    if requal is not None:
        qual = requal(qual)
    chunk = cfg.chunk
    banded = qual.resid is not None
    got = ops.slab_qualify(*slab, qual, chunk)
    before = ref.slab_qualify(*slab, qual, chunk, rows=ops)
    plain, ok, exact, ties = hold_slab(torch, tag, slab, qual, chunk, got)
    k, _, lanes = slab[:3]
    if not torch.equal(got[1], before[1]):
        raise AssertionError(f"slab_qualify[{tag}]: sample counts differ")
    if banded:
        torch.testing.assert_close(got[0], before[0], rtol=1e-6, atol=1e-6)
    elif not torch.equal(got[0], before[0]):
        raise AssertionError(f"slab_qualify[{tag}]: weight sums differ")
    n_ok = ok.sum(1)
    d = qual.x.shape[1]
    lut_b = 0 if qual.codes is None else \
        qual.luts[0].numel() * qual.luts.element_size()
    cb = 0 if qual.codes is None else \
        qual.codes.shape[1] + (4 if banded else 0)
    # the candidates drawn, each qualified exactly or by ADC
    m = 0 if qual.codes is None else qual.luts.shape[1]
    nbytes, flops = ops.slab_qualify_work(
        k.numel(), d, int((n_ok * exact).sum()), int(exact.sum()),
        int((n_ok * ~exact).sum()), int((~exact).sum()), cb, lut_b, m)
    res = dict(
        max_abs_err=float((got[0] - plain[0]).abs().max()),
        ms=cuda_ms(torch, lambda: ops.slab_qualify(*slab, qual, chunk)),
        plain_ms=cuda_ms(torch, lambda: ref.slab_qualify(*slab, qual,
                                                         chunk)),
        bound=bound_ms(nbytes, flops), library_ms=None)
    before_ms = cuda_ms(torch, lambda: ref.slab_qualify(*slab, qual, chunk,
                                                        rows=ops))
    dev_us = kernel_device_us(torch, lambda: ops.slab_qualify(
        *slab, qual, chunk), "slab_qualify_kernel")
    log(f"slab_qualify[{tag}, {k.numel()} lanes x {chunk}, B = "
        f"{slab[8].shape[-1]}]: {int(n_ok.sum())} candidates drawn, "
        f"{int(exact.sum())} lanes routed exact; counts equal, sums equal "
        f"to the composition before the fusion{' (rtol 1e-6)' if banded else ''}, "
        f"max |diff| to the plain version {res['max_abs_err']} "
        f"({int(ties.sum())} d^2 within {MARGIN} tau^2 of tau^2)")
    log(f"  wrapper {res['ms'] * 1e3:.2f} us per call (CUDA events), kernel "
        f"{dev_us:.2f} us per launch on the device (profiler); plain "
        f"{res['plain_ms']:.4f} ms, composition before the fusion "
        f"{before_ms:.4f} ms; bound {res['bound'][0] * 1e3:.3f} us "
        f"({res['bound'][1]}, {nbytes} bytes)")
    if step:
        s = {kk: v[lanes] for kk, v in state0.items()}
        s["k"], s["ci"] = slab[0], slab[1]
        small = ctx._replace(cums=None, rks=slab[4], prings=slab[5],
                             caps=slab[6], nbits=slab[7],
                             totals_f=ctx.totals_f[lanes],
                             w_caps=ctx.w_caps[lanes],
                             first_targets=ctx.first_targets[lanes])
        plain = launches_of(torch, lambda: ref.slab_qualify(*slab, qual,
                                                            chunk))
        before = launches_of(torch, lambda: ref.slab_qualify(
            *slab, qual, chunk, rows=ops))
        now = launches_of(torch, lambda: ops.slab_qualify(*slab, qual,
                                                          chunk))
        step_now = launches_of(torch, lambda: prober._slab_step(
            s, ctx, small, lanes, slab[3], view, qual, cfg))
        for what, (host, dev) in (
                ("plain candidate half (ref.slab_qualify)", plain),
                ("candidate half before the fusion (torch walk + row "
                 "kernel)", before),
                ("candidate half now (ops.slab_qualify)", now),
                ("whole slab step now (prober._slab_step)", step_now)):
            log(f"  per slab, {what}: {host} launch calls, {dev} device "
                "kernels")
        log(f"  per slab, whole step before the fusion (derived): "
            f"{step_now[0] - now[0] + before[0]} launch calls")
    return res


def fresh_ms(torch, make, fn, iters: int) -> float:
    """Mean CUDA-event time of ``fn(make())`` over ``iters`` calls, each
    on a fresh input made outside the timed span, warmed up."""
    fn(make())
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        a = make()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(a)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def phase_slab_loop(torch, tag, state, qs, taus, cfg, seed,
                    requal=None) -> dict:
    """The slab loop (``prober._loop_lanes``: one ``slab_loop`` launch) on
    the queries' lanes of ``state`` from their start, held bit-equal to
    the host loop of ``slab_qualify`` steps on a copy of its input state
    (:func:`hold_slab_loop`); CUDA-event times of both, each on a fresh
    copy, and the profiler's device time of the kernel, beside the bound
    of the candidates its per-lane counts show it qualified. ``requal``
    may replace the qualification inputs. Returns the kernel's result
    entry."""
    from repro_torch.core import estimator as E, prober
    from repro_torch.kernels import ops
    g = torch.Generator(device=qs.device).manual_seed(seed + 12)
    rks = E.draw_round_keys(g, qs.shape[0], cfg.n_tables, qs.device)
    b = prober.setup_lanes(state.index, state.x, qs, taus, cfg, rks,
                           **E._pq_args(state, qs, cfg))
    qual = b.qual if requal is None else requal(b.qual)

    def fresh():
        return {k: v.clone() for k, v in b.state.items()}

    def loop(st):
        return prober._loop_lanes(st, b.ctx, b.view, b.lane, b.lane_t, qual,
                                  cfg)

    def host(st):
        return prober._run_lanes(st, b.ctx, b.view, b.lane_t, qual, cfg)

    got = fresh()
    counts = loop(got)
    nql = hold_slab_loop(torch, f"{tag}, main-path shapes", b.state, got,
                         b.ctx, b.view, b.lane_t, qual, cfg)
    ms = fresh_ms(torch, fresh, loop, iters=5)
    plain_ms = fresh_ms(torch, fresh, host, iters=2)
    dev_us = kernel_device_us(torch, lambda: loop(fresh()),
                              "slab_qualify_kernel", iters=5)
    exact_n, adc_n, steps = counts.long().sum(0).tolist()
    codes = qual.codes is not None
    lut_b = qual.luts[0].numel() * qual.luts.element_size() if codes else 0
    cb = qual.codes.shape[1] + 4 * (qual.resid is not None) if codes else 0
    m = qual.luts.shape[1] if codes else 0
    # each candidate the lanes qualified read once, each lane's query row
    # or LUT and state once: the loop stages them across its steps
    nbytes, flops = ops.slab_qualify_work(
        nql, qual.x.shape[1], exact_n, int((counts[:, 0] > 0).sum()),
        adc_n, int((counts[:, 1] > 0).sum()), cb, lut_b, m)
    res = dict(max_abs_err=0.0,       # bit-equal to the host loop, held
               ms=ms, plain_ms=plain_ms, bound=bound_ms(nbytes, flops),
               library_ms=None)
    log(f"slab_loop[{tag}, {nql} lanes x chunk {cfg.chunk}, B = "
        f"{b.ctx.cums.shape[-1]}]: bit-equal to the host loop in every "
        f"state field; {steps} lane-steps (longest lane "
        f"{int(counts[:, 2].max())}), {exact_n} candidates qualified "
        f"exactly, {adc_n} by ADC")
    log(f"  loop {ms:.4f} ms a call (CUDA events), kernel {dev_us:.2f} us "
        f"on the device (profiler); host loop {plain_ms:.4f} ms; bound "
        f"{res['bound'][0] * 1e3:.3f} us ({res['bound'][1]}, {nbytes} "
        "bytes)")
    return res


def phase_central(torch, tag, state, qs, taus, cfg, exact=None) -> dict:
    """``central_qualify`` on ``state`` for the queries' lanes, against the
    central count it replaced (ring 0's row copied out of the ring cumsums,
    ``gather_ring_from_cum`` and the row kernels: the same sums) and its
    plain version: counts equal; hard sums equal to the old composition
    (and to the plain version, up to d² within MARGIN tau^2 of tau^2 on the
    exact route); banded sums within rtol 1e-6; the scaled ``est0`` equal.
    Times beside the bound and the replaced row kernel's device time, and
    the launches of either. ``exact`` forces the route (default: the
    config's). Returns the kernel's result entry."""
    from repro_torch.core import estimator as E, lsh, prober
    from repro_torch.kernels import ops, ref
    dev = qs.device
    nl, k = cfg.n_tables, cfg.n_funcs
    view = prober.table_views(state.index)
    qcodes, ham = lsh.query_lanes(state.index.params, qs, view.bucket_codes,
                                  view.n_buckets)
    cums = prober.ring_cumsums(view, ham, k)
    del ham
    nql = qs.shape[0] * nl
    lane = torch.arange(nql, device=dev)
    tid = lane % nl
    qual = prober._make_qual(state.x, qs, taus * taus, lane // nl, cfg,
                             **E._pq_args(state, qs, cfg))
    if exact is None:
        exact = qual.codes is None or cfg.pq_exact_central
    budget = cfg.central_budget
    banded = not exact and qual.resid is not None
    args = (qcodes, tid, view.bucket_codes, view.n_buckets,
            view.bucket_starts, view.bucket_sizes, view.order, qual, exact,
            budget)

    def before():
        ids, valid, total = ref.gather_ring_from_cum(
            view, tid, cums[:, 0].contiguous(), budget)
        qualified = (ref.qualify(qual, ids, lane, exact, rows=ops)
                     * valid).sum(-1)
        return qualified, valid.sum(-1, dtype=torch.int32), total, ids, valid

    def scaled(qualified, seen, total):
        return qualified * torch.where(seen > 0, total / seen.clamp_min(1),
                                       0.0)

    got = ops.central_qualify(*args)
    old = before()
    plain, ties = hold_central(torch, tag, args, got)
    for i, what in ((1, "seen"), (2, "total")):
        if not torch.equal(got[i], old[i]):
            raise AssertionError(f"central_qualify[{tag}]: {what} differs")
    if banded:
        torch.testing.assert_close(got[0], old[0], rtol=1e-6, atol=1e-6)
    elif not torch.equal(got[0], old[0]):
        raise AssertionError(f"central_qualify[{tag}]: sums differ")
    est, est_old = scaled(*got), scaled(*old[:3])
    if banded:
        torch.testing.assert_close(est, est_old, rtol=1e-6, atol=1e-6)
    elif not torch.equal(est, est_old):
        raise AssertionError(f"central_qualify[{tag}]: est0 differs")
    seen = got[1]
    n = int(seen.sum())
    # lanes of one table with one code share their bucket, and with it the
    # slice of ids and rows: the bound reads each (table, bucket) once
    found = got[2] > 0
    key = torch.cat([tid[:, None].to(torch.int32),
                     qcodes.reshape(nql, k)], 1)[found]
    _, inv = torch.unique(key, dim=0, return_inverse=True)
    nu = int(inv.max()) + 1 if inv.numel() else 0
    n_u = int(torch.zeros(nu, dtype=torch.int64, device=dev).scatter_(
        0, inv, seen[found].long()).sum())
    d = qual.x.shape[1]
    lut_b = 0 if exact else qual.luts[0].numel() * qual.luts.element_size()
    m = 0 if exact else qual.luts.shape[1]
    row_b = 4 * d if exact else qual.codes.shape[1] + (4 if banded else 0)
    res = dict(
        max_abs_err=float((got[0] - plain[0]).abs().max()),
        ms=cuda_ms(torch, lambda: ops.central_qualify(*args)),
        plain_ms=cuda_ms(torch, lambda: ref.central_qualify(*args), iters=5),
        bound=bound_ms(*ops.central_qualify_work(nql, k, d, exact, lut_b, m,
                                                 row_b, n, n_u)),
        library_ms=None)
    before_ms = cuda_ms(torch, before, iters=5)
    dev_us = kernel_device_us(torch, lambda: ops.central_qualify(*args),
                              "central_qualify_kernel")
    row_kernel = "l2dist_rows_kernel" if exact else "adc_rows_kernel"
    row_us = kernel_device_us(torch, before, row_kernel, iters=5)
    host_now, dev_now = launches_of(torch, lambda: ops.central_qualify(*args))
    host_old, dev_old = launches_of(torch, before)
    route = "exact" if exact else "banded ADC" if banded else \
        "uint8 ADC" if qual.thresh is not None else "float ADC"
    log(f"central_qualify[{tag}, {nql} lanes x {budget}, {route}, B = "
        f"{view.bucket_codes.shape[1]}]: {int((got[2] > 0).sum())} lanes "
        f"found their bucket ({nu} distinct buckets, {n_u} distinct slots), "
        f"{int((got[2] > budget).sum())} above the budget, {n} points "
        f"qualified; counts equal, sums equal to the old "
        f"composition{' (rtol 1e-6)' if banded else ''}, max |diff| to the "
        f"plain version {res['max_abs_err']} ({int(ties.sum())} d^2 within "
        f"{MARGIN} tau^2 of tau^2)")
    log(f"  wrapper {res['ms'] * 1e3:.2f} us per call (CUDA events), kernel "
        f"{dev_us:.2f} us per launch on the device (profiler); the old "
        f"composition {before_ms:.4f} ms per call, its {row_kernel} "
        f"{row_us:.2f} us on the device; plain {res['plain_ms']:.4f} ms; "
        f"bound {res['bound'][0] * 1e3:.3f} us ({res['bound'][1]})")
    log(f"  launches: now {host_now} launch calls, {dev_now} device kernels;"
        f" the old composition {host_old} launch calls, {dev_old} device "
        "kernels")
    return res


def phase_profile(torch, runs):
    """Where the time goes: torch.profiler over each ``(tag, fn)`` of
    ``runs``; device time by operator and the device's busy share of the
    wall time, the launch calls, and the call's peak device memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for tag, fn in runs:
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        peak = torch.cuda.max_memory_allocated()
        log(f"profile[{tag}]: peak device memory {peak / 2 ** 30:.3f} GiB, "
            f"{(peak - live) / 2 ** 30:.3f} GiB above the "
            f"{live / 2 ** 30:.3f} GiB live before the call")
        # kernels (device rows) give the busy time; operators (host rows)
        # carry the device time of the kernels they launched
        ka = prof.key_averages()
        dev_t = [(_device_us(e), e.count, e.key) for e in ka]
        busy = sum(t for (t, _, _), e in zip(dev_t, ka)
                   if e.device_type == DeviceType.CUDA)
        by_op = sorted(((t, c, k) for (t, c, k), e in zip(dev_t, ka)
                        if e.device_type == DeviceType.CPU and t > 0),
                       reverse=True)
        if busy <= 0:
            log(f"profile[{tag}]: the profiler saw no device time; device "
                "busy share not measured")
            continue
        log(f"profile[{tag}]: wall {wall_us:.1f} us, device busy "
            f"{busy:.1f} us = {busy / wall_us:.4f} of wall (idle "
            f"{1 - busy / wall_us:.4f}); device time by operator:")
        for t, c, k in by_op[:10]:
            log(f"  {t:12.1f} us {c:6d} calls  {k}")
        for op in ("aten::index", "aten::copy_", "aten::searchsorted"):
            rows = [(t, c) for (t, c, k), e in zip(dev_t, ka)
                    if e.device_type == DeviceType.CPU and k == op]
            log(f"  {op}: {sum(t for t, _ in rows) / 1e3:.3f} ms on the "
                f"device over {sum(c for _, c in rows)} calls")
        log(f"  launch calls: {launch_calls(ka)}")
        host = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:6]
        log("  host (self CPU) time by operator: " + ", ".join(
            f"{e.key} {e.self_cpu_time_total:.0f} us / {e.count}"
            for e in host))
        # the port's own kernels are launched through ctypes, so they have
        # no operator row: list their device rows (templates by instance)
        for (t, c, k), e in zip(dev_t, ka):
            label = [k[k.index(n):].split("(")[0] for n in KERNEL_NAMES
                     if f"::{n}(" in k or f"::{n}<" in k]
            if e.device_type == DeviceType.CUDA and label:
                log(f"  {t:12.1f} us {c:6d} calls  {label[0]} "
                    f"({t / c:.2f} us each)")


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def check_pq_fit(torch, x, cfg, g):
    """PQ training on the card against the CPU (the agreement above bridges
    a CPU-built state): one assignment, one segment sum and the whole fit
    from the same initial rows agree, codes outside ties
    (``pq.assign_ties``) exactly."""
    from repro_torch.core import pq as pqmod
    rows = pqmod.draw_init_rows(g, x.shape[0], cfg.pq_kc, "cpu")
    xs = pqmod.split_subspaces(x, cfg.pq_m)
    cents = xs[rows].transpose(0, 1).contiguous()
    a_cpu = pqmod.assign(cents, xs)
    a_gpu = pqmod.assign(cents.cuda(), xs.cuda()).cpu()
    tie = pqmod.assign_ties(cents, xs, MARGIN)
    if ((a_cpu != a_gpu) & ~tie).any():
        raise AssertionError("PQ assign differs between CPU and GPU")
    seg = pqmod._segments(a_cpu, cfg.pq_kc)
    flat = xs.reshape(-1, xs.shape[-1])
    s_cpu = pqmod.segment_sum(flat, seg, cfg.pq_m * cfg.pq_kc)
    s_gpu = pqmod.segment_sum(flat.cuda(), seg.cuda(),
                              cfg.pq_m * cfg.pq_kc).cpu()
    torch.testing.assert_close(s_gpu, s_cpu, rtol=1e-4, atol=1e-3)
    f_cpu = pqmod.fit(x, cfg, init_rows=rows)
    f_gpu = pqmod.fit(x.cuda(), cfg, init_rows=rows.cuda())
    differ = f_gpu.codes.cpu() != f_cpu.codes
    f_tie = pqmod.assign_ties(f_cpu.centroids, xs, MARGIN)
    dc = float((f_gpu.centroids.cpu() - f_cpu.centroids).abs().max())
    log(f"pq fit on the card against the CPU (N={x.shape[0]}): "
        f"{int(((a_cpu != a_gpu)).sum())} of {a_cpu.numel()} assignments "
        f"differ ({int(tie.sum())} ties), segment sums allclose; full fit: "
        f"{int(differ.sum())} of {differ.numel()} codes differ "
        f"({int(f_tie.sum())} ties), centroids max |diff| {dc:.3g}")
    torch.testing.assert_close(f_gpu.centroids.cpu(), f_cpu.centroids,
                               rtol=1e-5, atol=1e-5)
    if (differ & ~f_tie).any():
        raise AssertionError("PQ fit on the card departs from the CPU's")


def tie_free(torch, x, qs, taus, params):
    """Mask of the queries with no hash value within the float margin of
    an integer and no point's d² within MARGIN τ² of τ²: where two paths
    may legitimately decide differently."""
    ok_hash = ~near_integer(torch, qs, params.a, params.b, params.w).any(1)
    d2 = torch.stack([((x.double() - q) ** 2).sum(-1) for q in qs.double()])
    t2 = (taus.double() ** 2)[:, None]
    return ok_hash & ~((d2 - t2).abs() <= MARGIN * t2).any(1)


def phase_small_agreement(torch, cfg, seed, tag="exact", dim=32):
    """The same index, queries and round keys on the CPU (plain versions)
    and on the GPU (kernels): equal ring depths and sample counts, equal
    estimates to rtol 1e-5. Queries whose hash values or distances sit
    within the float margin of a boundary are left out beforehand, since
    there the two sides may legitimately decide differently."""
    from repro_torch import bridge
    from repro_torch.core import estimator as E
    from repro_torch.data import vectors
    g = torch.Generator().manual_seed(seed + 2)
    x = vectors.make_corpus(g, 8192, dim)
    cpu = E.build(x, cfg, g, capacity=2 ** 14, device="cpu")
    gpu = bridge.state_from_numpy(bridge.state_to_numpy(cpu), "cuda")
    qs, taus, _ = vectors.paper_query_workload(g, x, 48, n_taus=6)
    taus = taus[torch.arange(48), torch.arange(48) % taus.shape[1]]
    ok = tie_free(torch, x, qs, taus, cpu.index.params)
    if cfg.use_pq:
        ok &= tie_free_pq_queries(cpu, qs, taus, cfg)
    keep = torch.nonzero(ok).squeeze(1)[:16]
    if keep.numel() < 8:
        raise AssertionError("too few tie-free queries for the agreement")
    qs, taus = qs[keep], taus[keep]
    rks = E.draw_round_keys(g, len(keep), cfg.n_tables, "cpu")
    want = E.estimate_batch_stats(cpu, qs, taus, cfg, rks=rks)
    got = E.estimate_batch_stats(gpu, qs, taus, cfg, rks=rks)
    for name, a, b in zip(("ests", "probed_k", "nvisited"), got, want):
        if name == "ests":
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
        elif not torch.equal(a.cpu(), b):
            raise AssertionError(f"CPU and GPU paths differ in {name}")
    if cfg.use_pq and not cfg.pq_int8_lut:
        check_pq_fit(torch, x, cfg, g)
    log(f"small-input agreement ({tag}): {len(keep)} queries, CPU and GPU "
        f"paths agree (max |diff| "
        f"{float((got[0].cpu() - want[0]).abs().max())})")
    summarize(torch, f"estimate @ N=8192 ({tag})", got[0].cpu(),
              E.true_cardinality(x, qs, taus))


def timed(torch, fn):
    """(result, seconds) of ``fn`` on the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_decisions(torch, tag, got, want, tsq):
    """Qualification decisions ``d <= tau^2`` of a kernel against its plain
    version: they may differ only where the plain distance lies within
    MARGIN tau^2 of tau^2 (two summation orders)."""
    dec = (got <= tsq) != (want <= tsq)
    at_margin = (want - tsq).abs() <= MARGIN * tsq
    log(f"{tag}: {int(dec.sum())} decisions differ, {int(at_margin.sum())} "
        f"candidates within {MARGIN} tau^2 of tau^2")
    if (dec & ~at_margin).any():
        raise AssertionError(f"{tag}: a decision differs off the margin")


def phase_pq_main_path(torch, corpus, qs, taus, seed):
    """The PQ path at SIFT1M scale under both PQ configs, plus the scan
    baseline; returns the launch counts of each and the two states."""
    from repro_torch.core import baselines, estimator as E, pq as pqmod
    from repro_torch.core.config import ProberConfig
    from repro_torch.kernels import ops, ref
    dev = corpus.device
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    cfg = ProberConfig(**PROBER_PQ_KW)
    scfg = ProberConfig(**SERVE_KW)
    launches = {}

    def read_launches(tag, need):
        launches[tag] = dict(ops.LAUNCHES)
        log(f"pq-path launches ({tag}): {json.dumps(launches[tag])}")
        missing = [k for k in need if launches[tag][k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the PQ path "
                                 f"({tag}): {missing}")
        all_tiled(launches[tag], f"PQ path ({tag})")
        none_replaced(launches[tag], f"PQ path ({tag})")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state, t_build = timed(torch, lambda: E.build(
        corpus[:N], cfg, g, capacity=CAPACITY, device=dev))
    log(f"pq build (prober_cfg, M={cfg.pq_m}, Kc={cfg.pq_kc}, "
        f"{cfg.pq_iters} Lloyd iterations): {t_build:.3f} s, buckets "
        f"{state.index.n_buckets.tolist()}")
    r2 = state.pq.resid[:N].double() ** 2
    t2 = (taus.double() ** 2).sort().values
    log(f"  quantization distortion: squared residual ||x - q(x)||^2 median "
        f"{float(r2.median()):.4f}, mean {float(r2.mean()):.4f}; tau^2 of the "
        f"{NQ} queries min {float(t2[0]):.4f}, median "
        f"{float(t2[NQ // 2]):.4f}, max {float(t2[-1]):.4f}")
    truth = truth_line(torch, "@ N (PQ path)", E.true_cardinality(
        state.x, qs, taus, n_valid=N))
    rks = E.draw_round_keys(g, NQ, cfg.n_tables, dev)
    for rnd in ("first", "second"):
        out, t_est = timed(torch, lambda: E.estimate_batch_stats(
            state, qs, taus, cfg, rks=rks))
        log(f"pq estimate_batch_stats (prober_cfg, {rnd} call, Q={NQ}): "
            f"{t_est * 1e3:.3f} ms")
        if rnd == "second" and not all(torch.equal(a, b)
                                       for a, b in zip(first, out)):
            raise AssertionError("PQ estimate_batch_stats is not "
                                 "deterministic")
        first = out
    held_estimate(torch, "pq prober_cfg @ N", lambda: E.estimate_batch_stats(
        state, qs, taus, cfg, rks=rks), first)
    summarize(torch, "pq estimate @ N (prober_cfg)", first[0], truth)
    log(f"  probed_k mean {float(first[1].float().mean()):.3f}, nvisited "
        f"mean {float(first[2].float().mean()):.1f}")

    n_live = N
    for n_add in (N_INGEST, N_GROW):
        cap0 = state.capacity
        state, t_up = timed(torch, lambda: E.update(
            state, corpus[n_live:n_live + n_add], cfg, n_valid=n_live))
        n_live += n_add
        if int(state.n_valid) != n_live or int(state.pq.n_valid) != n_live:
            raise AssertionError(f"n_valid after the PQ update != {n_live}")
        log(f"pq update ({n_add} points, capacity {cap0} -> "
            f"{state.capacity}): {t_up:.3f} s = {n_add / t_up:.1f} points/s")
        est, t_est = timed(torch, lambda: E.estimate_batch(
            state, qs, taus, cfg, generator=g))
        log(f"pq estimate_batch after the update: {t_est * 1e3:.3f} ms")
        summarize(torch, f"pq estimate @ {n_live}", est, truth_line(
            torch, f"@ {n_live} (PQ path)",
            E.true_cardinality(state.x, qs, taus, n_valid=n_live)))
    if state.capacity != 2 * CAPACITY:
        raise AssertionError("the growth update did not double capacity")
    read_launches("prober_cfg", PATH_KERNELS)

    ops.reset_launches()
    sstate, t_build = timed(torch, lambda: E.build(
        corpus[:N], scfg, g, capacity=CAPACITY, device=dev))
    log(f"pq build (serve_cfg): {t_build:.3f} s, buckets "
        f"{sstate.index.n_buckets.tolist()}")
    srks = E.draw_round_keys(g, NQ, scfg.n_tables, dev)
    for rnd in ("first", "second"):
        out, t_est = timed(torch, lambda: E.estimate_batch_stats(
            sstate, qs, taus, scfg, rks=srks))
        log(f"pq estimate_batch_stats (serve_cfg, {rnd} call, Q={NQ}): "
            f"{t_est * 1e3:.3f} ms")
    held_estimate(torch, "pq serve_cfg @ N", lambda: E.estimate_batch_stats(
        sstate, qs, taus, scfg, rks=srks), out)
    summarize(torch, "pq estimate @ N (serve_cfg)", out[0], truth)
    log(f"  probed_k mean {float(out[1].float().mean()):.3f}, nvisited "
        f"mean {float(out[2].float().mean()):.1f}")
    read_launches("serve_cfg", PATH_KERNELS)

    ops.reset_launches()
    fcfg = scfg.replace(pq_int8_lut=False)
    out, t_est = timed(torch, lambda: E.estimate_batch_stats(
        sstate, qs, taus, fcfg, rks=srks))
    log(f"pq estimate_batch_stats (serve_cfg, float LUTs, Q={NQ}): "
        f"{t_est * 1e3:.3f} ms")
    held_estimate(torch, "pq serve_cfg float LUTs @ N",
                  lambda: E.estimate_batch_stats(sstate, qs, taus, fcfg,
                                                 rks=srks), out)
    summarize(torch, "pq estimate @ N (serve_cfg, float LUTs)", out[0],
              truth)
    read_launches("serve_cfg, float LUTs", PATH_KERNELS)

    ops.reset_launches()
    for rnd in ("first", "second"):
        counts, t_scan = timed(torch, lambda: baselines
                               .adc_scan_estimate_batch(sstate.pq, qs, taus))
        log(f"adc_scan_estimate_batch over {sstate.pq.capacity} codes "
            f"({rnd} call): {t_scan * 1e3:.3f} ms")
    summarize(torch, "full ADC scan @ N", counts, truth)
    read_launches("adc scan", ("adc_batch",))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"pq peak device memory: {peak:.3f} GiB")
    # the scan's counts against its plain version on the same LUTs
    luts = pqmod.adc_table(sstate.pq, qs).contiguous()
    plain = ref.adc_batch(sstate.pq.codes, luts)
    live = torch.arange(plain.shape[1], device=dev) < N
    tsq = (taus * taus)[:, None]
    want = ((plain <= tsq) & live).sum(1).float()
    near = (((plain - tsq).abs() <= MARGIN * tsq) & live).sum(1)
    diff = (counts - want).abs()
    log(f"adc_scan counts against the plain version: max |diff| "
        f"{float(diff.max())}, {int(near.sum())} candidates within the "
        "margin")
    if (diff > near).any():
        raise AssertionError("adc_scan_estimate_batch differs from its plain "
                             "version off the margin")
    return launches, state, sstate


def phase_adc_kernels(torch, sstate, qs, taus) -> dict:
    """The four ADC kernels against their plain versions at the PQ path's
    shapes, then the packed layout; times, bounds and embedding_bag."""
    from repro_torch.core import pq as pqmod
    from repro_torch.kernels import ops, ref
    dev = qs.device
    res = {}
    p = sstate.pq
    m, kc = p.m, p.kc
    codes = p.codes                                      # (2^20, M) uint8
    luts = pqmod.adc_table(p, qs).contiguous()           # (Q, M, Kc) f32
    qluts = pqmod.quantize_lut(luts).q8.contiguous()
    tsq = (taus * taus)[:, None]
    nc, nq = codes.shape[0], luts.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_hz = max_sm_clock_hz()

    def bag(lut_stack):
        """embedding_bag computing the same (transposed) scan: row n sums
        rows codes[n, m] + m Kc of the (M Kc, Q) table."""
        idx = codes.long() + torch.arange(m, device=dev) * kc
        w = lut_stack.float().permute(1, 2, 0).reshape(m * kc, nq) \
            .contiguous()
        return lambda: torch.nn.functional.embedding_bag(idx, w, mode="sum")

    for name, fn, plain_fn, lut_stack, out_b in (
            ("adc_batch", ops.adc_batch, ref.adc_batch, luts, 4),
            ("adc_batch_q8", ops.adc_batch_q8, ref.adc_batch_q8, qluts, 4)):
        # both sum over m in order: float sums bit-equal, int32 exact
        got, want = fn(codes, lut_stack), plain_fn(codes, lut_stack)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version")
        lib = bag(lut_stack)
        lib_err = float((lib().T - want.float()).abs().max())
        log(f"{name}: embedding_bag agrees to {lib_err}")
        res[name] = dict(
            max_abs_err=float((got - want).abs().max()),
            ms=cuda_ms(torch, lambda: fn(codes, lut_stack)),
            plain_ms=cuda_ms(torch, lambda: plain_fn(codes, lut_stack),
                             iters=3),
            bound=bound_ms(*ops.adc_batch_work(
                nq, nc, codes.shape[1], m,
                lut_stack.numel() * lut_stack.element_size(), out_b)),
            library_ms=cuda_ms(torch, lib, iters=5))
        # the kernel's other ceiling: one shared-memory word per float
        # lookup, per four uint8 ones, at 32 words a clock on each SM
        words = nq * nc * m // (4 if lut_stack.dtype == torch.uint8 else 1)
        log(f"{name}: kernel {res[name]['ms']:.4f} ms, byte bound "
            f"{res[name]['bound'][0]:.4f} ms, shared-word ceiling "
            f"{words / (sms * 32 * sm_hz) * 1e3:.4f} ms ({words} words, "
            f"{sms} SMs x 32 words/clock at {sm_hz / 1e6:.0f} MHz)")
        del got, want

    # the rows kernels at the central pass they serve on the main path:
    # serve_cfg's (64 lanes x 512), with float and uint8 LUTs
    g = torch.Generator(device=dev).manual_seed(7)
    for name, fn, plain_fn, lut_stack, nl, c, cdes in (
            ("adc_rows", ops.adc_rows, ref.adc_rows, luts,
             NQ * SERVE_KW["n_tables"], SERVE_KW["central_budget"], codes),
            ("adc_rows_q8", ops.adc_rows_q8, ref.adc_rows_q8, qluts,
             NQ * SERVE_KW["n_tables"], SERVE_KW["central_budget"], codes)):
        ids = torch.randint(0, N, (nl, c), generator=g, device=dev,
                            dtype=torch.int32)
        lane_q = (torch.arange(nl, device=dev) * nq // nl).to(torch.int32)
        got = fn(cdes, ids, lut_stack, lane_q)
        want = plain_fn(cdes, ids, lut_stack, lane_q)
        if name == "adc_rows":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            check_decisions(torch, f"{name}({nl} lanes x {c})", got, want,
                            tsq[lane_q.long()])
        elif not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version")
        esz = lut_stack.element_size()
        # embedding_bag computes the same sums from flattened LUT indices:
        # candidate (r, i) sums entries lane_q[r] M Kc + m Kc + code_m of
        # the (Q M Kc, 1) table
        idx = (lane_q.long()[:, None, None] * (m * kc)
               + torch.arange(m, device=dev) * kc
               + cdes[ids.long()].long()).reshape(-1, m)
        table = lut_stack.float().reshape(-1, 1)

        def lib():
            return torch.nn.functional.embedding_bag(idx, table, mode="sum")

        lib_err = float((lib().reshape(nl, c) - want.float()).abs().max())
        res[name] = dict(
            max_abs_err=float((got - want).abs().max()),
            ms=cuda_ms(torch, lambda: fn(cdes, ids, lut_stack, lane_q)),
            plain_ms=cuda_ms(torch, lambda: plain_fn(cdes, ids, lut_stack,
                                                     lane_q)),
            # ids, the gathered code rows, the lanes' distinct LUTs, lane_q
            # and the output
            bound=bound_ms(*ops.adc_rows_work(
                nl, c, cdes.shape[1], m, m * kc * esz,
                int(lane_q.unique().numel()))),
            library_ms=cuda_ms(torch, lib))
        log(f"{name}({nl} lanes x {c}): kernel "
            f"{kernel_device_us(torch, lambda: fn(cdes, ids, lut_stack, lane_q), 'adc_rows_kernel'):.2f}"
            f" us per launch on the device (profiler); embedding_bag agrees "
            f"to {lib_err}")

    # the packed 4-bit layout at the default M = 8, Kc = 16
    pc = torch.randint(0, 16, (nc, 8), generator=g, device=dev,
                       dtype=torch.uint8)
    pk = pqmod.pack_codes(pc).contiguous()
    pl = torch.rand((nq, 8, 16), generator=g, device=dev) * 10
    pql = torch.randint(0, 256, (nq, 8, 16), generator=g, device=dev,
                        dtype=torch.uint8)
    ids = torch.randint(0, nc, (128, 128), generator=g, device=dev,
                        dtype=torch.int32)
    lane_q = (torch.arange(128, device=dev) * nq // 128).to(torch.int32)
    if not torch.equal(ops.adc_batch(pk, pl), ref.adc_batch(pc, pl)):
        raise AssertionError("packed 4-bit adc_batch differs from the plain "
                             "byte-code version")
    torch.testing.assert_close(ops.adc_rows(pk, ids, pl, lane_q),
                               ref.adc_rows(pc, ids, pl, lane_q), rtol=1e-5,
                               atol=1e-5)
    if not (torch.equal(ops.adc_batch_q8(pk, pql), ref.adc_batch_q8(pc, pql))
            and torch.equal(ops.adc_rows_q8(pk, ids, pql, lane_q),
                            ref.adc_rows_q8(pc, ids, pql, lane_q))):
        raise AssertionError("packed 4-bit ADC differs from byte codes")
    log(f"packed 4-bit layout (M=8, Kc=16, {tuple(pk.shape)}): all four "
        f"kernels agree with the plain byte-code versions; adc_batch "
        f"{cuda_ms(torch, lambda: ops.adc_batch(pk, pl)):.4f} ms")
    # centroid updates: the sorted segment reduction is deterministic
    seg = torch.randint(0, m * kc, (nc * m,), generator=g, device=dev)
    data = torch.randn((nc * m, 4), generator=g, device=dev)
    if not torch.equal(pqmod.segment_sum(data, seg, m * kc),
                       pqmod.segment_sum(data, seg, m * kc)):
        raise AssertionError("segment_sum is not deterministic on the card")
    log(f"segment_sum over ({nc * m}, 4) into {m * kc} segments: "
        "bit-identical across two calls")
    for name, r in res.items():
        log(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), library "
            f"{r['library_ms']}, max_abs_err {r['max_abs_err']}")
    return res


def tie_free_pq_queries(state, qs, taus, cfg):
    """Queries for which the CPU and the GPU may not decide differently:
    no ADC distance at tau^2, and on the uint8 datapath no LUT entry or
    threshold at a rounding tie (``pq.adc_ties``, ``pq.q8_ties``)."""
    from repro_torch.core import pq as pqmod
    p = state.pq
    luts = pqmod.adc_table(p, qs)
    ok = ~pqmod.adc_ties(luts, p.codes[:int(p.n_valid)], taus, MARGIN)
    if cfg.pq_int8_lut:
        ok &= ~pqmod.q8_ties(luts, taus, p.m)
    return ok


# ---- the serving path: CardinalityCoalescer with the estimate cache -------

def zipf_stream(np, seed, n_pool, n_flushes, batch):
    """(n_flushes, batch) pool indices: zipfian (s = ZIPF_S) ranks over a
    seeded shuffle of the pool."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_pool)
    w = 1.0 / np.arange(1, n_pool + 1) ** ZIPF_S
    return perm[rng.choice(n_pool, size=(n_flushes, batch), p=w / w.sum())]


class ServeShadow:
    """``tests/test_cache.py::_ShadowTracker`` on the card: for every
    probed key, whether an ingest since its probe landed within its probed
    rings (W compared bitwise; the new points' codes, as the index holds
    them, against the entry's query codes, distance against its
    ``probed_k``). A key is the pool index and the query's codes under the
    current W. A hit of a dirty key is a stale serve, and a hit must equal
    the probe's estimate bit for bit. While nothing was evicted, a request
    of a recorded key must be a hit when it is clean and a stale refresh
    when it is dirty, and a new key a probe; a query within ``MARGIN`` of
    a hash boundary, where the plain hash may disagree with the kernel's,
    is held to the first two rules only. Query codes come from the plain
    hash (``ref.lsh_hash``), so the shadow launches none of the port's
    kernels."""

    def __init__(self, torch, nl):
        self.torch, self.nl = torch, nl
        self.entries: dict = {}
        self.hits = self.held = 0

    def key(self, state, j, q):
        from repro_torch.kernels import ref
        p = state.index.params
        codes = ref.lsh_hash(q[None], p.a, p.b, p.w).reshape(self.nl, -1)
        tie = bool(near_integer(self.torch, q[None], p.a, p.b, p.w).any())
        return (j, codes.cpu().numpy().tobytes()), codes, tie

    def flush(self, state, picks, qs, reqs, evicted):
        """Hold one flush's answers to the entries as they stood before it
        (its lookups precede its inserts), then record its probes; of
        duplicate keys the last lane's probe stays, as in the cache."""
        keyed = [self.key(state, j, q) for j, q in zip(picks, qs)]
        for (key, _, tie), r in zip(keyed, reqs):
            e = self.entries.get(key)
            if r.provenance == "hit":
                self.hits += 1
                if e is None and tie:
                    continue
                if e is None:
                    raise AssertionError("a hit without a recorded probe")
                if e["dirty"]:
                    raise AssertionError("stale serve: an ingest touched "
                                         "the entry's probed rings")
                if r.est != e["est"]:
                    raise AssertionError("a hit differs from its probe's "
                                         "estimate")
            elif not (tie or evicted):
                want = ("probe" if e is None else "stale-refresh"
                        if e["dirty"] else "hit")
                if r.provenance != want:
                    raise AssertionError(
                        f"a request answered as {r.provenance}; the shadow "
                        f"expects {want}")
                self.held += 1
        for (key, codes, _), r in zip(keyed, reqs):
            if r.provenance != "hit":
                self.entries[key] = {
                    "qcodes": codes, "w": state.index.params.w.clone(),
                    "probed_k": self.torch.as_tensor(r.probed_k,
                                                     device=codes.device),
                    "dirty": False, "est": r.est}

    def note_ingest(self, state_after, lo, hi):
        """Mark the entries that rows ``lo:hi`` of ``state_after`` touch;
        returns (entries clean before, entries marked)."""
        ix = state_after.index
        new = ix.codes[:, lo:hi].transpose(0, 1)               # (n, L, K)
        w = ix.params.w
        clean = [e for e in self.entries.values() if not e["dirty"]]
        for e in clean:
            if not self.torch.equal(e["w"], w):
                e["dirty"] = True
                continue
            d = (new != e["qcodes"][None]).sum(-1).amin(0)      # (L,)
            if bool((d <= e["probed_k"]).any()):
                e["dirty"] = True
        return len(clean), sum(e["dirty"] for e in clean)


def anchored_rows(torch, state, g, n):
    """``n`` new points near live ones (``benchmarks/workloads.py``
    ``_ingest_batch``: a random live row plus ``SERVE_NOISE`` Gaussian
    noise) whose raw projections lie inside every function's live range by
    a margin of 1e-3 of it, so Alg. 7 keeps W bit for bit."""
    from repro_torch.core import lsh
    ix, nv = state.index, int(state.n_valid)
    raw = ix.raw[:nv]
    lo, hi = raw.amin(0), raw.amax(0)
    m = 1e-3 * (hi - lo)
    dev = state.x.device
    rows = torch.randint(0, nv, (4 * n,), generator=g, device=dev)
    x = state.x[rows] + SERVE_NOISE * torch.randn(
        (4 * n, state.x.shape[1]), generator=g, device=dev)
    r = lsh.project_raw(ix.params, x)
    x = x[((r > lo + m) & (r < hi - m)).all(1)][:n]
    if x.shape[0] < n:
        raise AssertionError("too few anchored rows inside the ranges")
    return x.contiguous()


def flush_requests(co, pool_q, pool_t, picks):
    reqs = [co.submit(pool_q[j], pool_t[j]) for j in picks]
    co.flush()
    return reqs


def phase_serving(torch, corpus, cfg, seed):
    """The serving deployment at the main path's width: the exact state at
    capacity 2^20 with ingest epochs, ``CardinalityCoalescer(cache_size=
    1024, max_batch=64, reuse_tol=0)``, a pool of the 64 paper-protocol
    queries x 4 grid radii, 24 flushes of 64 zipfian draws over it, the main
    path's ingests after flushes 8 (16,384 rows, in capacity) and 16 (40,000
    rows, growth to 2^21), one anchored point that keeps W after flushes
    10, 12, 14 (at 2^20) and 18, 20, 22 (at 2^21). Launch counts are
    zeroed before the first flush and read after the last; each flush is
    held to its launches and to the shadow. Returns the counts, the
    coalescer and the last flush's pool indices."""
    import numpy as np
    from repro_torch.core import estimator as E
    from repro_torch.data import vectors
    from repro_torch.kernels import ops
    from repro_torch.serve.coalescer import CardinalityCoalescer
    dev = corpus.device
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    state, t_build = timed(torch, lambda: E.build(
        corpus[:N], cfg, g, capacity=CAPACITY, device=dev,
        track_epochs=True))
    qs, grid, _ = vectors.paper_query_workload(g, corpus[:N], NQ)
    cols = torch.linspace(0, grid.shape[1] - 1, SERVE_RADII).round().long()
    pool_qt = qs.repeat_interleave(SERVE_RADII, 0)
    pool_tt = grid[:, cols.to(dev)].reshape(-1).contiguous()
    truth = E.true_cardinality(state.x, pool_qt, pool_tt, n_valid=N).cpu()
    pool_q, pool_t = pool_qt.cpu().numpy(), pool_tt.cpu().numpy()
    n_pool = pool_q.shape[0]
    draws = zipf_stream(np, seed + 21, n_pool, SERVE_FLUSHES, SERVE_BATCH)
    log(f"serving: build {t_build:.3f} s (N {N}, capacity {CAPACITY}, "
        f"epochs attached); pool {n_pool} = {NQ} queries x {SERVE_RADII} "
        f"radii (grid columns {cols.tolist()} of {grid.shape[1]}); "
        f"{SERVE_FLUSHES} flushes of {SERVE_BATCH} zipfian (s = {ZIPF_S}) "
        f"draws, {len(np.unique(draws))} distinct pairs drawn; pool digest "
        f"{digest(pool_tt)}")
    co = CardinalityCoalescer(state, cfg, g, max_batch=SERVE_BATCH,
                              cache_size=SERVE_CACHE, reuse_tol=0.0)
    g_in = torch.Generator(device=dev).manual_seed(seed + 22)
    shadow = ServeShadow(torch, cfg.n_tables)
    served_est, served_truth = [], []
    walls, peaks, touched = [], [], []
    stale_after = hits_before = stale_kept = 0
    first_ingest = min(SERVE_INGESTS)
    kept_w = False          # the last ingest kept W
    torch.cuda.synchronize()
    ops.reset_launches()
    for f in range(SERVE_FLUSHES):
        if f in SERVE_INGESTS or f in SERVE_TRICKLES:
            lo = int(co.state.n_valid)
            if f in SERVE_INGESTS:
                x_new = corpus[slice(*SERVE_INGESTS[f])]
            else:
                x_new = anchored_rows(torch, co.state, g_in, SERVE_TRICKLE)
            hi = lo + x_new.shape[0]
            pe0 = int(co.state.epochs.params_epoch)
            _, t_in = timed(torch, lambda: (co.ingest(x_new.cpu().numpy()),
                                            co.apply_ingest()))
            ep = co.state.epochs
            kept_w = f in SERVE_TRICKLES
            if kept_w and int(ep.params_epoch) != pe0:
                raise AssertionError(f"serving: the anchored ingest after "
                                     f"flush {f} moved W")
            clean, marked = shadow.note_ingest(co.state, lo, hi)
            if kept_w:
                touched.append((clean, marked))
            log(f"serving: ingest of {hi - lo} "
                f"{'anchored' if kept_w else 'corpus'} rows after flush {f}"
                f": {t_in:.3f} s ({(hi - lo) / t_in:.1f} points/s, chunks "
                f"of {cfg.ingest_chunk}); n_valid {int(co.state.n_valid)}, "
                f"capacity {co.state.capacity}, params_epoch {pe0} -> "
                f"{int(ep.params_epoch)}, n_ingested {int(ep.n_ingested)}; "
                f"the shadow marks {marked} of {clean} clean entries")
        before, stats0 = dict(ops.LAUNCHES), dict(co.cache_stats)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        reqs = flush_requests(co, pool_q, pool_t, draws[f])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
        d = {k: ops.LAUNCHES[k] - before[k] for k in before}
        st = {k: co.cache_stats[k] - stats0[k] for k in stats0}
        probes = int(st["misses"] > 0)
        want = {"query_lanes": 1 + probes, "cache_insert": probes,
                "central_qualify": probes, "lsh_hash": 0,
                "hamming_to_buckets": 0}
        bad = {k: (d[k], v) for k, v in want.items() if d[k] != v}
        if bad:
            raise AssertionError(f"serving flush {f}: launches (got, want) "
                                 f"{bad}")
        shadow.flush(co.state, [int(j) for j in draws[f]],
                     torch.from_numpy(pool_q[draws[f]]).to(dev), reqs,
                     co.cache_stats["evicts"] > 0)
        if f < first_ingest:
            served_est += [r.est for r in reqs]
            served_truth += [float(truth[j]) for j in draws[f]]
            hits_before += st["hits"]
        else:
            stale_after += st["stale"]
            stale_kept += st["stale"] if kept_w else 0
        walls.append((wall, st))
        peaks.append(peak)
        ran = {k: v for k, v in d.items() if v}
        log(f"serving flush {f:2d}: hits {st['hits']:2d} misses "
            f"{st['misses']:2d} stale {st['stale']:2d} evicts "
            f"{st['evicts']:2d}; wall {wall:.3f} ms; peak {peak:.3f} GiB "
            f"above live; launches {json.dumps(ran)}")
    counts = dict(ops.LAUNCHES)
    log(f"serving launches: {json.dumps(counts)}")
    if hits_before == 0:
        raise AssertionError("serving: no hit before the first ingest")
    if stale_kept == 0:
        raise AssertionError("serving: no stale refresh after an ingest "
                             "that kept W")
    marked, clean = (sum(t[i] for t in touched) for i in (1, 0))
    if not 0 < marked < clean:
        raise AssertionError(f"serving: the ingests that kept W marked "
                             f"(clean, marked) {touched}: none, or all")
    if shadow.hits != co.cache_stats["hits"]:
        raise AssertionError("serving: the shadow saw another hit count")
    log(f"serving: no stale serve over {shadow.hits} hits (shadow check), "
        f"{shadow.held} misses as the shadow has them (a new key a probe, "
        f"a touched one a stale refresh); cache_stats "
        f"{json.dumps(co.cache_stats)}; hits before the first ingest "
        f"{hits_before}, stale refreshes after it "
        f"{stale_after}, {stale_kept} of them after ingests that kept W "
        f"(entries clean, marked: {touched})")
    all_miss = [w for w, st in walls if st["hits"] == 0]
    most = max(walls, key=lambda ws: ws[1]["hits"])
    log("serving: all-miss flush wall "
        f"{', '.join(f'{w:.3f}' for w in all_miss)} ms; mostly-hit flush "
        f"({most[1]['hits']} hits) {most[0]:.3f} ms; "
        f"median flush wall {float(np.median([w for w, _ in walls])):.3f} ms;"
        f" peak device memory of a flush {max(peaks):.3f} GiB above live "
        f"(all-miss flush 0: {peaks[0]:.3f})")
    summarize(torch, "served estimates before the first ingest",
              torch.tensor(served_est), torch.tensor(served_truth))
    return counts, co, pool_q, pool_t, draws[-1]


def phase_serving_times(torch, co, pool_q, pool_t, picks):
    """Outside the counted run: the lookup's and ``query_lanes``' times at
    the flush's shapes on the grown state, and profiles of an all-hit and an
    all-miss flush."""
    from repro_torch.cache import estimate_cache as C
    from repro_torch.core import lsh
    st = co.state
    ix = st.index
    dev = st.x.device
    qs = torch.from_numpy(pool_q[picks]).to(dev)
    taus = torch.from_numpy(pool_t[picks]).to(dev)
    qcodes, ham = lsh.query_lanes(ix.params, qs, ix.bucket_codes,
                                  ix.n_buckets)
    qh, tk = C.query_hash(qs), C.tau_band(taus, 0.0)
    live = torch.ones(qs.shape[0], dtype=torch.bool, device=dev)
    lq_ms = cuda_ms(torch, lambda: lsh.query_lanes(
        ix.params, qs, ix.bucket_codes, ix.n_buckets))
    look = {flag: cuda_ms(torch, lambda: C.lookup(
        co._cache, st.epochs, ham, ix.bucket_sizes, qcodes, qh, tk, live,
        match_qhash=True, check_ingest=flag)) for flag in (False, True)}
    log(f"serving times at ({qs.shape[0]}, {ix.n_tables}, "
        f"{ix.bucket_codes.shape[1]}), cache {co._cache.size}: query_lanes "
        f"{lq_ms:.4f} ms a flush; lookup {look[True]:.4f} ms with the ball "
        f"check, {look[False]:.4f} ms without")
    del ham
    calls = [0]

    def all_miss():
        calls[0] += 1     # a new radius each call: every key is new
        flush_requests(co, pool_q, pool_t * (1 + 1e-4 * calls[0]), picks)

    phase_profile(torch, [
        ("serving flush, all hits", lambda: flush_requests(
            co, pool_q, pool_t, picks)),
        ("serving flush, all misses", all_miss)])


def insert_inputs(torch, g, s, n, nl, k, full):
    """A random cache of ``s`` entries (all valid and referenced when
    ``full``) and ``n`` lanes: keys of entries, new keys and repeats of
    earlier lanes' keys, some lanes inactive."""
    from repro_torch.cache import estimate_cache as C
    dev = g.device

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)
    flags = (torch.ones(s, dtype=torch.bool, device=dev) if full
             else ri(0, 2, (s,)).bool() for _ in range(2))
    cache = C.EstimateCache(
        qcodes=ri(-2, 3, (s, nl, k)),
        qhash=ri(0, 1 << 32, (s, 2), torch.int64),
        tau_key=ri(0, 3, (s,)), snap_ball=ri(0, 1000, (s, nl)),
        snap_params=ri(0, 3, (s,), torch.int64),
        probed_k=ri(0, k + 1, (s, nl)),
        est=torch.rand(s, generator=g, device=dev),
        nvisited=ri(0, 5000, (s,)), valid=next(flags), ref=next(flags),
        hand=ri(0, s, ()))
    # half the lanes take an entry's key, the rest a new one; a quarter
    # then repeat an earlier lane's key
    src = ri(0, s, (n,), torch.int64)
    new = ri(0, 2, (n,)).bool()
    qc = torch.where(new[:, None, None], ri(-2, 3, (n, nl, k)),
                     cache.qcodes[src])
    qh = torch.where(new[:, None], ri(0, 1 << 32, (n, 2), torch.int64),
                     cache.qhash[src])
    tk = torch.where(new, ri(0, 3, (n,)), cache.tau_key[src])
    rep = ri(0, 4, (n,)) == 0
    prev = (torch.rand(n, generator=g, device=dev)
            * torch.arange(n, device=dev)).long()
    prev = torch.where(rep, prev, torch.arange(n, device=dev))
    lanes = (qc[prev].contiguous(), qh[prev].contiguous(),
             tk[prev].contiguous(), ri(0, 1000, (n, nl)),
             torch.tensor(1, device=dev),
             torch.rand(n, generator=g, device=dev), ri(0, 5000, (n,)),
             ri(0, k + 1, (n, nl)), ri(0, 8, (n,)) > 0)
    return cache, lanes


def phase_cache_insert(torch, seed) -> dict:
    """``cache_insert`` against its plain version (the reference's loop in
    torch, on the CPU copy of the same inputs), ``torch.equal`` on every
    field, at S = 1024 and 65,536 with 64 and 256 lanes (duplicate keys,
    the full sweep of a cache whose ``ref`` bits are all set); wrapper and
    device times beside the plain loop's on the card (and its launches)
    and the bound. Returns the serving shape's result entry."""
    from repro_torch.cache import estimate_cache as C
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(seed + 40)
    nl, k = CFG_KW["n_tables"], CFG_KW["n_funcs"]
    res, err = None, 0.0
    for s, n, full, match in ((SERVE_CACHE, SERVE_BATCH, False, True),
                              (SERVE_CACHE, SERVE_BATCH, True, True),
                              (SERVE_CACHE, 256, False, False),
                              (1 << 16, SERVE_BATCH, False, True),
                              (1 << 16, 256, True, True)):
        cache, lanes = insert_inputs(torch, g, s, n, nl, k, full)
        want_c = C.EstimateCache(*(t.to("cpu", copy=True) for t in cache))
        want = ref.cache_insert(want_c, *(t.cpu() for t in lanes), match)
        got_c = C.EstimateCache(*(t.clone() for t in cache))
        got = ops.cache_insert(got_c, *lanes, match)
        torch.cuda.synchronize()
        est_err = float((got_c.est.cpu() - want_c.est).abs().max())
        unequal = {name: int((a.cpu() != b).sum())
                   for name, a, b in zip(C.EstimateCache._fields, got_c,
                                         want_c) if name != "est"}
        for name, a, b in zip(C.EstimateCache._fields, got_c, want_c):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"cache_insert (S={s}, n={n}): {name} "
                                     f"differs from the plain version (max "
                                     f"|est| diff {est_err}, unequal "
                                     f"integer elements {unequal})")
        if int(got) != int(want):
            raise AssertionError(f"cache_insert (S={s}, n={n}): evictions "
                                 f"{int(got)} != {int(want)}")
        err = max(err, est_err)
        # the bytes this run's data needs: valid and tau_key of every entry;
        # the codes of entries whose tau key is an active lane's (or that a
        # lane wrote), the fingerprints (with match_qhash) of those whose
        # codes match too; ref up to each victim (the bits cleared, the
        # victims); the active lanes; each written entry and cleared bit
        act = lanes[-1]
        qc, tk = lanes[0][act], lanes[2][act]
        changed = torch.zeros(s, dtype=torch.bool, device="cuda")
        for a, b in zip(got_c[:9], cache[:9]):      # ref apart
            if a.dim():
                changed |= (a != b).reshape(s, -1).any(1)
        tau_hit = ((cache.valid & torch.isin(cache.tau_key, tk)) | changed)
        code_hit = torch.zeros(s, dtype=torch.bool, device="cuda")
        for i in range(0, s, 4096):
            c = cache.qcodes[i:i + 4096].reshape(-1, 1, nl * k)
            code_hit[i:i + 4096] = (
                (c == qc.reshape(1, -1, nl * k)).all(-1)
                & (cache.tau_key[i:i + 4096, None] == tk[None])).any(1)
        code_hit = (code_hit & cache.valid & tau_hit) | changed
        cleared = int((cache.ref & ~got_c.ref).sum())
        nbytes = ops.cache_insert_work(
            s, n, nl, k, match, active=int(act.sum()),
            tau_hits=int(tau_hit.sum()), code_hits=int(code_hit.sum()),
            changed=int(changed.sum()), cleared=cleared)[0]
        iters = 20
        fresh = [C.EstimateCache(*(t.clone() for t in cache))
                 for _ in range(2 * iters + 1)]
        it = iter(fresh)
        ms = cuda_ms(torch, lambda: ops.cache_insert(next(it), *lanes, match),
                     iters=iters)
        dev_us = kernel_device_us(
            torch, lambda: ops.cache_insert(next(it), *lanes, match),
            "cache_insert_", iters=iters - 1, per_call=True)
        plain = [C.EstimateCache(*(t.clone() for t in cache))
                 for _ in range(4)]
        pit = iter(plain)
        plain_ms = cuda_ms(torch, lambda: ref.cache_insert(
            next(pit), *lanes, match), iters=3)
        host, devk = launches_of(torch, lambda: ref.cache_insert(
            C.EstimateCache(*(t.clone() for t in cache)), *lanes, match))
        b = bound_ms(nbytes, 0)
        log(f"cache_insert (S={s}, {n} lanes, {int(act.sum())} active,"
            f" {'full, every ref set' if full else 'random valid/ref'}, "
            f"match_qhash={match}): torch.equal to the plain version on "
            f"every field (max |est| diff {est_err}, unequal integer "
            f"elements {sum(unequal.values())}); {int(got)} evictions, "
            f"{int(changed.sum())} entries written, {cleared} ref bits "
            f"cleared; wrapper {ms * 1e3:.2f} us (CUDA events), device "
            f"{dev_us:.2f} us; plain loop on the card {plain_ms:.3f} ms, "
            f"{host} launch calls ({devk} device kernels); bound "
            f"{b[0] * 1e3:.4f} us ({b[1]}, {nbytes} bytes: "
            f"{int(tau_hit.sum())} codes read, {int(code_hit.sum())} "
            "fingerprints)")
        del fresh, plain
        if res is None:
            res = dict(ms=ms, plain_ms=plain_ms, bound=b, library_ms=None)
    res["max_abs_err"] = err
    lane_slope(torch, g, nl, k, res["bound"][0])
    return res


def lane_slope(torch, g, nl, k, bound_ms_):
    """The chain's measured floor: device time of ``cache_insert`` at the
    serving shape (S = 1024, 64 lanes) with 1 active lane against all 64,
    the difference a lane in ns and in SM clocks at the clock measured
    under the 64-lane load."""
    from repro_torch.cache import estimate_cache as C
    from repro_torch.kernels import ops
    cache, lanes = insert_inputs(torch, g, SERVE_CACHE, SERVE_BATCH, nl, k,
                                 False)
    us = {}
    for n_act in (1, SERVE_BATCH):
        act = torch.zeros(SERVE_BATCH, dtype=torch.bool, device="cuda")
        act[:n_act] = True
        la = lanes[:-1] + (act,)
        fresh = iter([C.EstimateCache(*(t.clone() for t in cache))
                      for _ in range(21)])
        us[n_act] = kernel_device_us(
            torch, lambda: ops.cache_insert(next(fresh), *la, True),
            "cache_insert_", iters=20, per_call=True)
    busy = C.EstimateCache(*(t.clone() for t in cache))
    mhz = sorted(r[0] for r in clocks_under_load(
        torch, lambda: ops.cache_insert(busy, *lanes, True), seconds=1.0))
    clock = mhz[len(mhz) // 2] if mhz else max_sm_clock_hz() / 1e6
    slope_ns = (us[SERVE_BATCH] - us[1]) / (SERVE_BATCH - 1) * 1e3
    log(f"cache_insert per-lane slope (S = {SERVE_CACHE}, {SERVE_BATCH} "
        f"lanes): device {us[1]:.2f} us at 1 active lane, "
        f"{us[SERVE_BATCH]:.2f} us at {SERVE_BATCH}: {slope_ns:.1f} ns a "
        f"lane = {slope_ns * clock / 1e3:.0f} clocks at {clock:.0f} MHz "
        f"(SM clock under the 64-lane load, median of {len(mhz)} samples); "
        f"the serving shape's byte bound {bound_ms_ * 1e3:.4f} us")


def phase_serving_agreement(torch, cfg, seed):
    """The same stream at reuse_tol 0.25 through a CPU coalescer (plain
    versions) and a GPU one with the same round keys, on a bridged small
    state, with an in-capacity ingest of midpoints: equal provenance,
    rings, sample counts and ``cache_stats``, estimates within rtol 1e-6,
    every cache field equal (``est`` within rtol 1e-6). Queries, radii
    and ingest rows at a hash boundary, a tau^2 boundary or a band edge
    are left out beforehand."""
    import math
    import numpy as np
    from repro_torch import bridge
    from repro_torch.cache import estimate_cache as C
    from repro_torch.core import estimator as E
    from repro_torch.data import vectors
    from repro_torch.serve.coalescer import CardinalityCoalescer
    tol = 0.25
    g = torch.Generator().manual_seed(seed + 30)
    x = vectors.make_corpus(g, 8192, 32)
    cpu = E.build(x, cfg, g, capacity=2 ** 14, device="cpu",
                  track_epochs=True)
    gpu = bridge.state_from_numpy(bridge.state_to_numpy(cpu), "cuda")
    p = cpu.index.params
    perm = torch.randperm(8192, generator=g)
    mids = 0.5 * (x[perm[:1024]] + x[perm[1024:2048]])
    mids = mids[~near_integer(torch, mids, p.a, p.b, p.w).any(1)][:512]
    live = torch.cat([x, mids])
    qs, taus, _ = vectors.paper_query_workload(g, x, 48, n_taus=6)
    d2 = ((live.double()[None] - qs.double()[:, None]) ** 2).sum(-1)
    ok = ~near_integer(torch, qs, p.a, p.b, p.w).any(1)
    pool = []
    for qi in torch.nonzero(ok).squeeze(1).tolist():
        for t in taus[qi, ::2].tolist():
            band = math.log(t) / math.log1p(tol)
            if abs(band - round(band)) > 1e-5 and not (
                    (d2[qi] - t * t).abs() <= MARGIN * t * t).any():
                pool.append((qi, t))
    pool = pool[:36]
    if len(pool) < 24:
        raise AssertionError("too few tie-free serving pairs")
    pool_q = qs[[q for q, _ in pool]].numpy()
    pool_t = np.array([t for _, t in pool], np.float32)
    draws = zipf_stream(np, seed + 31, len(pool), 10, 16)

    def keys(i, n):
        return E.draw_round_keys(torch.Generator().manual_seed(seed + 100 + i),
                                 n, cfg.n_tables, "cpu")

    cos = [CardinalityCoalescer(st, cfg, max_batch=16, cache_size=32,
                                reuse_tol=tol, round_keys=keys)
           for st in (cpu, gpu)]
    for f in range(10):
        if f == 4:
            for co in cos:
                co.ingest(mids.numpy())
                co.apply_ingest()
            if not torch.equal(cos[0].state.index.params.w,
                               cos[1].state.index.params.w.cpu()):
                raise AssertionError("serving agreement: W after the "
                                     "ingest differs between CPU and GPU")
        got, want = (flush_requests(co, pool_q, pool_t, draws[f])
                     for co in cos[::-1])
        for a, b in zip(got, want):
            if a.provenance != b.provenance or (a.probed_k is None) != (
                    b.probed_k is None) or (a.probed_k is not None and (
                    not np.array_equal(a.probed_k, b.probed_k)
                    or a.nvisited != b.nvisited)):
                raise AssertionError(f"serving agreement, flush {f}: "
                                     "provenance or probe stats differ")
            if not math.isclose(a.est, b.est, rel_tol=1e-6, abs_tol=1e-6):
                raise AssertionError(f"serving agreement, flush {f}: "
                                     f"estimates {a.est} != {b.est}")
    if cos[0].cache_stats != cos[1].cache_stats:
        raise AssertionError("serving agreement: cache_stats differ")
    gc, wc = (bridge.cache_to_numpy(co._cache) for co in cos[::-1])
    for k in C.EstimateCache._fields:
        if k == "est":
            np.testing.assert_allclose(gc[k], wc[k], rtol=1e-6, atol=1e-6)
        elif not np.array_equal(gc[k], wc[k]):
            raise AssertionError(f"serving agreement: cache field {k} "
                                 "differs")
    if cos[0].cache_stats["hits"] == 0:
        raise AssertionError("serving agreement: no hit")
    log(f"serving agreement (reuse_tol {tol}): {len(pool)} pairs, 10 "
        f"flushes of 16, {len(mids)} ingested; CPU and GPU coalescers agree "
        f"(provenance, rings, samples, every cache field); cache_stats "
        f"{json.dumps(cos[1].cache_stats)}")


# ---- N1, B1, D1: the neighbor table, the baselines, the paper corpora ----

def padded_codes(torch, bucket_codes, cap):
    """(cap, K) int32: the first ``cap`` rows of one table's bucket codes,
    sentinel-padded where the table has fewer rows."""
    from repro_torch.core import lsh
    out = torch.full((cap, bucket_codes.shape[-1]), lsh.CODE_SENTINEL,
                     dtype=torch.int32, device=bucket_codes.device)
    n = min(cap, bucket_codes.shape[0])
    out[:n] = bucket_codes[:n]
    return out


def new_codes_last(torch, old, new):
    """Alg. 9's ``codes_all``: the old codes (n_old, K) first, then the
    rows of ``new`` (the grown index's bucket codes, re-sorted) that are not
    among them. Every old code must still be a bucket."""
    both = torch.cat([old, new])
    _, inv = torch.unique(both, dim=0, return_inverse=True)
    inv_old, inv_new = inv[:old.shape[0]], inv[old.shape[0]:]
    if not torch.isin(inv_old, inv_new).all():
        raise AssertionError("an old bucket code vanished in the ingest")
    return torch.cat([old, new[~torch.isin(inv_new, inv_old)]])


def phase_neighbors(torch, state, cfg, seed):
    """N1: the paper's neighbor table (Alg. 6) of both tables of the exact
    1M state at capacity 2^20, at a table capacity of next_pow2(max
    n_buckets) and M = ``cfg.table_max_dist``; ``neighbor_dists`` against
    its plain version and ``torch.cdist(p=0)``; the rings against the
    online ones; then an ingest of points anchored on live rows (W kept,
    new buckets in every table) and Alg. 9's update against a fresh
    build. Launch counts are zeroed just before the builds and read just
    after the updates.
    Returns the kernel's result entry and its launches."""
    from repro_torch.core import estimator as E, neighbors
    from repro_torch.core.updates import next_pow2
    from repro_torch.kernels import ops, ref
    dev = state.x.device
    ix = state.index
    nl, k, m = ix.n_tables, ix.n_funcs, cfg.table_max_dist
    nbs = [int(v) for v in ix.n_buckets.tolist()]
    cap = next_pow2(max(nbs))
    codes = [padded_codes(torch, ix.bucket_codes[t], cap) for t in range(nl)]
    log(f"N1 neighbor table: buckets {nbs}, table capacity {cap}, K = {k}, "
        f"M = {m}")
    g = torch.Generator(device=dev).manual_seed(seed + 12)
    # the ingest first: it reads the state, not the tables
    grown = E.update(state, anchored_rows(torch, state, g, N1_INGEST), cfg)
    if not torch.equal(grown.index.params.w, ix.params.w):
        raise AssertionError("the anchored ingest moved W")
    nbs2 = [int(v) for v in grown.index.n_buckets.tolist()]
    log(f"N1 ingest of {N1_INGEST} anchored points: W kept, buckets "
        f"{nbs} -> {nbs2} (+{[b - a for a, b in zip(nbs, nbs2)]})")
    if not all(b > a for a, b in zip(nbs, nbs2)):
        raise AssertionError("the ingest made no new bucket in some table")
    cap2 = next_pow2(max(nbs2))
    codes_all = [padded_codes(torch, new_codes_last(
        torch, codes[t][:nbs[t]], grown.index.bucket_codes[t, :nbs2[t]]),
        cap2) for t in range(nl)]
    del grown

    torch.cuda.synchronize()
    ops.reset_launches()
    tables, t_build = timed(torch, lambda: [
        neighbors.build(codes[t], nbs[t], m) for t in range(nl)])
    built = [tb.dists.clone() for tb in tables]
    if cap2 > cap:
        tables = [neighbors.grow(tb, cap2) for tb in tables]
    updated, t_update = timed(torch, lambda: [
        neighbors.update(tables[t], codes_all[t], nbs[t], nbs2[t])
        for t in range(nl)])
    launches = ops.LAUNCHES["neighbor_dists"]
    log(f"N1 path: build of both tables {t_build * 1e3:.3f} ms, update "
        f"{t_update * 1e3:.3f} ms (host clock, synchronised), "
        f"neighbor_dists launches {launches}")
    if launches == 0:
        raise AssertionError("N1 launched no neighbor_dists")

    # the kernel against its plain version, both tables at full width
    err = unequal = 0
    for t in range(nl):
        want = ref.neighbor_dists(codes[t], nbs[t], m, 0, cap, torch.zeros(
            (cap, cap), dtype=torch.int8, device=dev))
        err = max(err, int((built[t].int() - want.int()).abs().max()))
        unequal += int((built[t] != want).sum())
        if not torch.equal(built[t], want):
            raise AssertionError(f"neighbor_dists differs from its plain "
                                 f"version on table {t}: max |diff| {err}, "
                                 f"{unequal} entries unequal")
        # the rings of 64 buckets, k = 1..M, against hamming_to_buckets
        idx = torch.linspace(0, nbs[t] - 1, N1_RINGS, device=dev).long()
        ham = ops.hamming_to_buckets(
            codes[t][None].contiguous(), codes[t][idx][:, None].contiguous(),
            torch.tensor([nbs[t]], dtype=torch.int32, device=dev))[:, 0]
        table = neighbors.NeighborTable(built[t], torch.tensor(nbs[t]), m)
        for kk in range(1, m + 1):
            if not torch.equal(neighbors.ring(table, idx, kk), ham == kk):
                raise AssertionError(f"table {t}: ring {kk} differs from the "
                                     "online ring")
        if not torch.equal(updated[t].dists, neighbors.build(
                codes_all[t], nbs2[t], m).dists):
            raise AssertionError(f"table {t}: Alg. 9's update differs from "
                                 "a fresh Alg. 6 build")
    log(f"N1: neighbor_dists torch.equal to its plain version on both "
        f"tables (max |diff| {err}, {unequal} entries unequal); rings 1..{m} of {N1_RINGS} buckets a table equal "
        "hamming_to_buckets' rings; Alg. 9 update torch.equal to a fresh "
        "build")

    def build_both():
        return [ops.neighbor_dists(codes[t], nbs[t], m) for t in range(nl)]

    def plain_both():
        return [ref.neighbor_dists(codes[t], nbs[t], m, 0, cap, torch.zeros(
            (cap, cap), dtype=torch.int8, device=dev)) for t in range(nl)]

    fcodes = [c.float() for c in codes]

    def cdist_both():
        return [torch.cdist(c, c, p=0) for c in fcodes]

    def update_both():
        return [neighbors.update(updated[t], codes_all[t], nbs[t], nbs2[t])
                for t in range(nl)]

    # bytes: both tables written once, the codes read once; operations:
    # the compares the live rows need
    work = [ops.neighbor_dists_work(cap, k, n) for n in nbs]
    nbytes, ops_n = sum(w[0] for w in work), sum(w[1] for w in work)
    tb, ti = nbytes / HBM_BYTES_S * 1e3, ops_n / INT32_OP_S * 1e3
    res = dict(max_abs_err=float(err), ms=cuda_ms(torch, build_both),
               plain_ms=cuda_ms(torch, plain_both, iters=3),
               bound=(max(tb, ti), "bytes" if tb >= ti else "operations"),
               library_ms=cuda_ms(torch, cdist_both, iters=3))
    new_rows = [b - a for a, b in zip(nbs, nbs2)]
    outs = [u.dists.clone() for u in updated]

    def plain_update_both():
        return [ref.neighbor_dists(codes_all[t].to(torch.int32), nbs2[t], m,
                                   nbs[t], nbs2[t], outs[t])
                for t in range(nl)]

    if not all(torch.equal(a, b.dists)
               for a, b in zip(plain_update_both(), updated)):
        raise AssertionError("Alg. 9's update differs from its plain version")
    upd_ms = cuda_ms(torch, update_both)
    upd_plain_ms = cuda_ms(torch, plain_update_both, iters=3)
    # the library yardstick: one torch.cdist(p=0) a table of the new codes
    # against the live ones (the strips, unmasked, as float)
    fnew = [codes_all[t][nbs[t]:nbs2[t]].float() for t in range(nl)]
    flive = [codes_all[t][:nbs2[t]].float() for t in range(nl)]
    upd_lib_ms = cuda_ms(torch, lambda: [
        torch.cdist(a, b, p=0) for a, b in zip(fnew, flive)], iters=3)
    # bytes: both strips of each table written once, its live codes read
    # once; operations: the compares of the new rows against the live ones
    upd = [ops.neighbor_dists_work(cap2, k, n2, n1, n2)
           for n1, n2 in zip(nbs, nbs2)]
    upd_tb = sum(w[0] for w in upd) / HBM_BYTES_S * 1e3
    upd_ti = sum(w[1] for w in upd) / INT32_OP_S * 1e3
    dev_us = kernel_device_us(torch, build_both, "neighbor_dists_kernel")
    upd_us = kernel_device_us(torch, update_both, "neighbor_dists_kernel")
    edge = []
    for n_valid in (0, cap):
        got = ops.neighbor_dists(codes[0], n_valid, m)
        want = ref.neighbor_dists(codes[0], n_valid, m, 0, cap, torch.zeros(
            (cap, cap), dtype=torch.int8, device=dev))
        if not torch.equal(got, want):
            raise AssertionError(f"neighbor_dists at n_valid = {n_valid} "
                                 "differs from its plain version")
        del got, want
        edge.append(kernel_device_us(
            torch, lambda: ops.neighbor_dists(codes[0], n_valid, m),
            "neighbor_dists_kernel"))
    table_us = cap * cap / HBM_BYTES_S * 1e6
    log(f"neighbor_dists[{nl} x ({cap}, {cap}), K = {k}]: wrapper "
        f"{res['ms']:.4f} ms for both tables (CUDA events), device "
        f"{dev_us:.2f} us a table (profiler); plain {res['plain_ms']:.4f} ms, "
        f"torch.cdist(p=0) {res['library_ms']:.4f} ms; bounds: bytes "
        f"{tb:.4f} ms ({nbytes / 2 ** 20:.1f} MiB), compares {ti:.4f} ms "
        f"({ops_n:.4g} at {INT32_OP_S / 1e12:.1f} Top/s)")
    log(f"neighbor_dists[({cap}, {cap}), K = {k}] at n_valid = 0 (the zero "
        f"fill alone): device {edge[0]:.2f} us against the table's byte "
        f"bound {table_us:.2f} us ({edge[0] and table_us / edge[0]:.3f} of "
        f"it); at n_valid = {cap} (every tile live): {edge[1]:.2f} us "
        f"(compares bound {cap * (cap + 1) / 2 * k / INT32_OP_S * 1e6:.2f} "
        f"us once a pair); both torch.equal to the plain version")
    log(f"N1 Alg. 9 update ({new_rows} new codes, strips of "
        f"{[r * (2 * cap2 - r) for r in new_rows]} entries): {upd_ms:.4f} ms "
        f"against the build's {res['ms']:.4f} ms ({upd_ms / res['ms']:.4f}); "
        f"device {upd_us:.2f} us a launch against the build's {dev_us:.2f}; "
        f"plain {upd_plain_ms:.4f} ms (torch.equal to the kernel's); "
        f"torch.cdist(p=0) of the new codes against the live ones "
        f"{upd_lib_ms:.4f} ms; bound "
        f"{max(upd_tb, upd_ti):.6f} ms ({'bytes' if upd_tb >= upd_ti else 'operations'}: "
        f"bytes {upd_tb:.6f}, compares {upd_ti:.6f})")
    return res, launches


def phase_baselines(torch, state, x, cfg, seed):
    """B1: the paper's baselines at 1M, d = 128: 64 paper-protocol queries
    x 12 targets through the Dynamic Prober (exact), Sampling 1 % and the
    MLP trained on 60 % of the queries (``benchmarks/common.py`` eval_*);
    q-error and ms a query. ``l2dist_rows`` launches are counted over the
    sampling run alone; the prober's estimates launch no replaced kernel.
    Returns the sampling run's launch counts and ``l2dist_rows``' result
    entry at the sampling run's shape."""
    from repro_torch.core import baselines, estimator as E
    from repro_torch.data import vectors
    from repro_torch.kernels import ops, ref
    dev = x.device
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    qs, taus, cards = vectors.paper_query_workload(g, x, NQ)
    nq, nt = taus.shape
    n_pairs = nq * nt
    truth = cards.reshape(-1)
    ops.reset_launches()
    t0 = time.perf_counter()
    est_dp = torch.stack([E.estimate_batch(state, qs, taus[:, t], cfg,
                                           generator=g) for t in range(nt)],
                         dim=1).reshape(-1)
    torch.cuda.synchronize()
    dp_ms = (time.perf_counter() - t0) * 1e3
    none_replaced(dict(ops.LAUNCHES), "B1 prober estimates")

    fq, ft = qs.repeat_interleave(nt, 0), taus.reshape(-1)
    n_s = x.shape[0] // 100
    ops.reset_launches()
    est_s, t_s = timed(torch, lambda: baselines.sampling_estimate(
        x, fq, ft, g, n_s))
    samp_counts = dict(ops.LAUNCHES)
    if samp_counts["l2dist_rows"] == 0:
        raise AssertionError("B1: sampling launched no l2dist_rows")
    ids = baselines.draw_sample_ids(g, x.shape[0], n_pairs, n_s)
    # the kernel reads a row that several pairs draw from L2 when each
    # pair's ids ascend; how far the top-k draws do, and what a sort would
    # cost
    ascending = float((ids[:, 1:] >= ids[:, :-1]).float().mean())
    sort_ms = cuda_ms(torch, lambda: ids.sort(dim=1), iters=5)
    got = ops.l2dist_rows(x, ids, fq)
    want = ref.l2dist_rows(x, ids, fq)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    check_decisions(torch, f"B1 l2dist_rows{tuple(ids.shape)}", got, want,
                    (ft * ft)[:, None])
    # the same draws shuffled within each row: the same distances, moved
    g_perm = torch.Generator(device=dev).manual_seed(seed + 14)
    perm = torch.argsort(torch.rand(ids.shape, generator=g_perm, device=dev),
                         dim=1)
    shuffled = torch.gather(ids, 1, perm).contiguous()
    if not torch.equal(ops.l2dist_rows(x, shuffled, fq),
                       torch.gather(got, 1, perm)):
        raise AssertionError("B1 l2dist_rows: shuffled ids give other "
                             "distances")
    shuffled_ms = cuda_ms(torch, lambda: ops.l2dist_rows(x, shuffled, fq))
    del perm, shuffled
    r, d = ids.shape[0], x.shape[1]
    # 7.68M draws over 1M rows touch nearly every row, most several times:
    # the function must read each distinct drawn row once
    n_rows = torch.unique(ids).numel()
    rows = dict(max_abs_err=float((got - want).abs().max()),
                ms=cuda_ms(torch, lambda: ops.l2dist_rows(x, ids, fq)),
                plain_ms=cuda_ms(torch, lambda: ref.l2dist_rows(x, ids, fq),
                                 iters=3),
                # ids, the distinct drawn rows, the queries, the distances
                # out; a multiply-add a coordinate
                bound=bound_ms(*ops.l2dist_rows_work(r, n_s, d, n_rows)),
                library_ms=None)
    del got, want
    draw_ms = cuda_ms(torch, lambda: baselines.draw_sample_ids(
        g, x.shape[0], n_pairs, n_s), iters=3)
    rows_ms = rows["ms"]

    ntr = int(nq * 0.6)
    m, t_fit = timed(torch, lambda: baselines.fit_mlp(
        x, qs[:ntr], taus[:ntr], cards[:ntr], g))
    eq, et = qs[ntr:].repeat_interleave(nt, 0), taus[ntr:].reshape(-1)
    est_m, t_m = timed(torch, lambda: baselines.mlp_estimate(m, eq, et))
    log(f"B1 workload: {nq} queries x {nt} targets, cardinalities "
        f"{int(cards.min())}..{int(cards.max())}")
    summarize(torch, "B1 Dynamic Prober (exact)", est_dp, truth)
    summarize(torch, "B1 Sampling 1 %", est_s, truth)
    summarize(torch, "B1 MLP (held-out 40 %)", est_m,
              cards[ntr:].reshape(-1))
    small = (truth < 100)
    for tag, est in (("Dynamic Prober", est_dp), ("Sampling 1 %", est_s)):
        qe = q_errors(torch, est, truth)
        log(f"B1 {tag}: q-error at cardinalities < 100 mean "
            f"{float(qe[small].mean()):.4f} (n {int(small.sum())}), >= 100 "
            f"mean {float(qe[~small].mean()):.4f}; zero estimates "
            f"{int((est == 0).sum())}")
    log(f"B1 ms a (query, tau): Dynamic Prober {dp_ms / n_pairs:.4f} "
        f"({nt} batches of {nq}), Sampling 1 % {t_s * 1e3 / n_pairs:.4f} "
        f"({n_pairs} rows x {n_s}: draws {draw_ms:.3f} ms, l2dist_rows "
        f"{rows_ms:.3f} ms a batch), MLP {t_m * 1e3 / et.shape[0]:.4f}; "
        f"MLP training {t_fit:.3f} s ({ntr} queries x {nt}, 400 epochs)")
    log(f"B1 sampling launches: {json.dumps(samp_counts)}")
    per_draw = bound_ms(ops.l2dist_rows_work(r, n_s, d)[0], 0)[0]
    log(f"l2dist_rows[B1, ({r}, {n_s}, {d})]: kernel {rows['ms']:.4f} ms on "
        f"the ids as drawn ({ascending:.6f} of neighbours non-decreasing; "
        f"a sort of each row would take {sort_ms:.4f} ms), "
        f"{shuffled_ms:.4f} ms on them shuffled within each row; plain "
        f"{rows['plain_ms']:.4f} ms; bounds: bytes of the distinct rows "
        f"{rows['bound'][0]:.4f} ms ({rows['bound'][1]}; {n_rows} distinct "
        f"rows drawn, {r * n_s / n_rows:.2f} draws a row), a row a draw "
        f"{per_draw:.4f} ms; max_abs_err {rows['max_abs_err']}")
    return samp_counts, rows


def plain_l2dist(torch, x, q, rows=2 ** 18):
    """``ref.l2dist`` in row chunks: its per-query (N, d) difference would
    be 7 GB at N = 1M, d = 1770."""
    from repro_torch.kernels import ref
    return torch.cat([ref.l2dist(x[i:i + rows], q)
                      for i in range(0, x.shape[0], rows)])


def check_ground_truth(torch, tag, got, want, taus, cards):
    """The workload's ``l2dist`` distances ``got`` (N, Q) against the plain
    ones ``want`` at every tau of ``taus`` (Q, T), as ``check_decisions``
    does, and its cardinalities ``cards`` (Q, T) against a recount from
    ``want``: both may differ only by candidates within MARGIN tau^2 of
    tau^2."""
    n_dec = n_margin = n_cards = 0
    for t in range(taus.shape[1]):
        tsq = (taus[:, t] ** 2)[None, :]
        dec = (got <= tsq) != (want <= tsq)
        at_margin = (want - tsq).abs() <= MARGIN * tsq
        if (dec & ~at_margin).any():
            raise AssertionError(f"{tag}: a decision differs off the margin")
        diff = (cards[:, t] - (want <= tsq).sum(0)).abs()
        if (diff > at_margin.sum(0)).any():
            raise AssertionError(f"{tag}: a cardinality differs from the "
                                 "plain recount off the margin")
        n_dec += int(dec.sum())
        n_margin += int(at_margin.sum())
        n_cards += int((diff > 0).sum())
    log(f"{tag}: over {taus.shape[1]} taus a query, {n_dec} decisions "
        f"differ, {n_margin} candidates within {MARGIN} tau^2 of tau^2; "
        f"{n_cards} of {cards.numel()} cardinalities differ from a recount "
        "from the plain distances")


def phase_corpora(torch, cfg, seed, dev):
    """D1: the five paper corpora at their own widths, each at N = 1M
    (``load`` at scale 1M / CORPORA's N): the workload's ``l2dist`` (the
    tiled kernel at every width, never the general one) against its plain
    version and, with ``torch.equal``, against the general kernel, the
    witness, and the ground-truth cardinalities against a plain recount;
    its time beside the operations bound, the FP32-issue ceiling and the
    witness's time; build the exact
    state, one ``estimate_batch`` of 64 paper-protocol queries; q-error,
    wall ms, peak memory. At d = 1770 also Sampling 1 % (``l2dist_rows``
    off its 16-byte path, against its plain version)."""
    from repro_torch.core import baselines, estimator as E
    from repro_torch.core.updates import next_pow2
    from repro_torch.data import vectors
    from repro_torch.kernels import ops, ref
    for i, (name, (n0, d)) in enumerate(vectors.CORPORA.items()):
        t_start = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(seed + 20 + i)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        ds, t_load = timed(torch, lambda: vectors.load(
            name, g, n_queries=NQ, scale=N / n0, device=dev))
        tiled, general = (ops.LAUNCHES["l2dist"]
                          - ops.LAUNCHES["l2dist_general"],
                          ops.LAUNCHES["l2dist_general"])
        plan = ops.l2dist_plan(ds.x.shape[0], NQ, d, ds.x.data_ptr(),
                               ds.queries.data_ptr())
        if (tiled, general) != (1, 0) or plan is None:
            raise AssertionError(f"D1 {name}: l2dist launches tiled {tiled}, "
                                 f"general {general}: the workload must take "
                                 "the tiled kernel alone")
        got = ops.l2dist(ds.x, ds.queries)
        if not torch.equal(got, ops.l2dist_general(ds.x, ds.queries)):
            raise AssertionError(f"D1 {name}: the tiled l2dist differs from "
                                 "the general kernel")
        want = plain_l2dist(torch, ds.x, ds.queries)
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        check_ground_truth(torch, f"D1 {name} l2dist{tuple(got.shape)}",
                           got, want, ds.taus, ds.cards)
        del got, want
        plain_ms = cuda_ms(torch, lambda: plain_l2dist(
            torch, ds.x, ds.queries), iters=1)
        l2_ms = cuda_ms(torch, lambda: ops.l2dist(ds.x, ds.queries), iters=5)
        witness_ms = cuda_ms(torch, lambda: ops.l2dist_general(
            ds.x, ds.queries), iters=5)
        lib_ms = cuda_ms(torch, lambda: torch.cdist(ds.x, ds.queries) ** 2,
                         iters=3)
        nb_, fl = ops.l2dist_work(ds.x.shape[0], NQ, d)
        ceiling = fp32_ceiling_ms(torch, fl)
        taus = ds.taus[torch.arange(NQ, device=dev),
                       torch.arange(NQ, device=dev) % ds.taus.shape[1]]
        truth = ds.cards[torch.arange(NQ, device=dev),
                         torch.arange(NQ, device=dev) % ds.taus.shape[1]]
        state, t_build = timed(torch, lambda: E.build(
            ds.x, cfg, g, capacity=next_pow2(ds.x.shape[0]), device=dev))
        ops.reset_launches()
        E.estimate_batch(state, ds.queries, taus, cfg, generator=g)
        est, t_est = timed(torch, lambda: E.estimate_batch(
            state, ds.queries, taus, cfg, generator=g))
        counts = dict(ops.LAUNCHES)
        none_replaced(counts, f"D1 {name}")
        if any(counts[kk] == 0 for kk in PATH_KERNELS):
            raise AssertionError(f"D1 {name}: a path kernel did not launch: "
                                 f"{counts}")
        log(f"D1 {name} (N {ds.x.shape[0]}, d {d}; CORPORA N {n0} x "
            f"{N / n0:g}): load {t_load:.3f} s, build {t_build:.3f} s, "
            f"estimate_batch of {NQ} {t_est * 1e3:.3f} ms (second call), "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f}"
            f" GiB; the workload's l2dist took the tiled kernel ({plan.panels}"
            f" panels of {plan.chunks} chunks, {plan.width}-byte copies): "
            f"{l2_ms:.4f} ms a call ({ds.x.shape[0]} x {NQ} x {d}; bounds: "
            f"bytes {nb_ / HBM_BYTES_S * 1e3:.4f} ms, operations "
            f"{fl / FP32_FLOP_S * 1e3:.4f} ms; FP32-issue ceiling "
            f"{ceiling:.4f} ms, {ceiling / l2_ms:.4f} of it), the general "
            f"kernel (the witness, bit-equal) {witness_ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms (one call, in row chunks), torch.cdist(x, q) "
            f"** 2 {lib_ms:.4f} ms, max |diff| {err}")
        summarize(torch, f"D1 {name} estimate", est, truth)
        if d == D1_SAMPLING_DIM:
            n_s = ds.x.shape[0] // 100
            est_s, t_s = timed(torch, lambda: baselines.sampling_estimate(
                ds.x, ds.queries, taus, g, n_s))
            summarize(torch, f"D1 {name} Sampling 1 %", est_s, truth)
            ids = baselines.draw_sample_ids(g, ds.x.shape[0], NQ, n_s)
            got = ops.l2dist_rows(ds.x, ids, ds.queries)
            want = ref.l2dist_rows(ds.x, ids, ds.queries)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            check_decisions(torch, f"D1 {name} l2dist_rows"
                            f"{tuple(ids.shape) + (d,)}", got, want,
                            (taus * taus)[:, None])
            del got, want
            log(f"D1 {name} Sampling 1 %: {t_s * 1e3:.3f} ms for {NQ} "
                f"queries x {n_s} rows; l2dist_rows {cuda_ms(torch, lambda: ops.l2dist_rows(ds.x, ids, ds.queries), iters=5):.4f}"
                " ms a call")
        del ds, state
        torch.cuda.empty_cache()
        log(f"D1 {name}: {time.perf_counter() - t_start:.1f} s")


# ---------------------------------------------------------------- S1 ----
# the sharded deployment: the main path's corpus, queries and ingests over
# S1_RANKS ranks of one card (gloo: NCCL refuses two ranks on one device);
# its checks' configs are the reference's tests/test_sharding.py ones
S1_RANKS, S1_TIMEOUT = 4, 600
S1_EPS0_KW = dict(n_tables=1, n_funcs=6, ring_budget=1024,
                  central_budget=1024, chunk=128, eps=0.0, s1=1.0,
                  max_visit=100000)            # test_8dev_distributed_estimator
S1_SKEW_KW = dict(n_tables=1, n_funcs=8, n_regions=4, ring_budget=2048,
                  central_budget=2048, chunk=64, s1=0.05,
                  eps=0.12)    # test_8dev_sync_beats_local_on_skewed_shards
S1_TRIVIAL_KW = dict(n_tables=2, n_funcs=6, ring_budget=512,
                     central_budget=512, chunk=128)  # trivial-mesh test
CORPUS_STRIDE = 4099          # rows of the corpus digest the ranks compare


def phase_sharded_rank(rank, spec):
    """One rank of S1 (spawned by ``distributed.run_ranks``): the main
    sequence on this rank's shard with launch counts zeroed before it and
    read after it (checks 1-3 and 8 inside it), then checks 4-7; writes
    its record to ``spec["out"]``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.core import collectives, distributed as D, estimator as E
    from repro_torch.core import lsh
    from repro_torch.core.config import ProberConfig
    from repro_torch.data import vectors
    from repro_torch.kernels import ops
    dev = torch.device(spec["dev"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev.index or 0)
    p_ranks = dist.get_world_size()
    # the ranks share the host's cores (check 7 and 8 run on the CPU)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // p_ranks))
    say = log if rank == 0 else (lambda *a: None)
    seed, n, cap = spec["seed"], spec["n"], spec["capacity"]
    cfg = ProberConfig(**CFG_KW)
    nl = cfg.n_tables

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def clock(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def same_on_every_rank(t, what):
        t0 = t.clone()
        dist.broadcast(t0, 0)
        if not torch.equal(t0, t):
            raise AssertionError(f"S1 rank {rank}: {what} differs from "
                                 "rank 0's")

    corpus = vectors.make_corpus(
        torch.Generator(device=dev).manual_seed(seed),
        n + spec["ingest"] + spec["grow"], spec["dim"])
    if digest(corpus[::CORPUS_STRIDE]) != spec["digest"]:
        raise AssertionError(f"S1 rank {rank}: corpus differs from the main "
                             "path's")
    qs, taus = spec["qs"].to(dev), spec["taus"].to(dev)
    nq = qs.shape[0]
    rec = {"rank": rank, "estimates": {}}
    stream = [0]

    def check_single(tag, st, single, gids):
        """Check 1 (codes against the single-device state, W against its
        W) and check 2 (W the same on every rank)."""
        if not torch.equal(st.index.params.w, single.index.params.w):
            raise AssertionError(f"S1 {tag} rank {rank}: W differs from the "
                                 "single-device W")
        idx = torch.from_numpy(gids).to(dev)
        if not torch.equal(st.index.codes[:, :len(gids)],
                           single.index.codes[:, idx]):
            raise AssertionError(f"S1 {tag} rank {rank}: codes differ from "
                                 "the single-device state's")
        same_on_every_rank(st.index.params.w, f"{tag}: W")

    def estimates(tag, st, n_live):
        truth = E.true_cardinality(corpus[:n_live], qs, taus) \
            if rank == 0 else None
        for mode in ("local", "sync"):
            rks = D.shard_round_keys(seed, nq, nl, dev, stream=stream[0])
            stream[0] += 1
            c0 = dict(collectives.COUNT)
            est, wall = clock(lambda: D.estimate_sharded(
                st, qs, taus, cfg, rks, mode=mode))
            n_c = collectives.COUNT["calls"] - c0["calls"]
            s_c = collectives.COUNT["seconds"] - c0["seconds"]
            same_on_every_rank(est, f"{tag} {mode} estimates")
            rec["estimates"][f"{tag} {mode}"] = dict(
                ms=wall * 1e3, collectives=n_c, collective_ms=s_c * 1e3)
            if rank == 0:
                qe = summarize(torch, f"S1 {tag} {mode}", est.cpu(),
                               truth.cpu())
                main = spec["main_qe"][tag]
                say(f"  S1 {tag} {mode}: wall {wall * 1e3:.3f} ms at rank "
                    f"0, {n_c} collectives ({s_c * 1e3:.3f} ms, "
                    f"{s_c / wall:.3f} of the wall); single-device main "
                    f"path q-error mean {main[0]:.4f} median {main[1]:.4f} "
                    f"p95 {main[2]:.4f} (sharded: {qe[0]:.4f} / {qe[1]:.4f}"
                    f" / {qe[2]:.4f})")

    def check_cpu(tag, st):
        """Check 8: this rank's real shard, copied to the CPU (plain
        versions), against the card, both modes with the same group and
        keys, on 8 queries tie-free over every shard's live rows: equal
        integer-valued estimates, probed_k and nvisited, the rest within
        rtol 1e-5. In sync mode a rank steps lanes past its own PRP domain
        while other ranks still sample, and keeps lanes with an empty
        local ring active: slab_qualify inputs that only this path gives.
        Its launches are not the main path's: the counts are restored."""
        saved, t0 = dict(ops.LAUNCHES), time.perf_counter()
        ok = tie_free(torch, st.x[:int(st.n_valid)], qs, taus,
                      st.index.params).to(torch.int32)
        dist.all_reduce(ok, dist.ReduceOp.MIN)
        keep = torch.nonzero(ok).squeeze(1)[:8]
        if keep.numel() < 8:
            raise AssertionError(f"S1 check 8 {tag}: too few tie-free "
                                 "queries")
        cpu = bridge.state_from_numpy(bridge.state_to_numpy(st), "cpu")
        q8, t8 = qs[keep], taus[keep]
        rks = D.shard_round_keys(seed, len(keep), nl, "cpu",
                                 stream=200 + stream[0])
        world, diff = dist.group.WORLD, 0.0
        for mode, fn in (
                ("local", lambda s, *a: E.estimate_batch_stats(
                    s, *a[:3], rks=a[3])),
                ("sync", lambda s, *a: E.estimate_batch_pooled(
                    s, *a, world, with_stats=True))):
            want = fn(cpu, q8.cpu(), t8.cpu(), cfg, rks)
            got = [t.cpu() for t in fn(st, q8, t8, cfg, rks.to(dev))]
            whole = want[0] == want[0].round()
            if not torch.equal(got[0][whole], want[0][whole]):
                raise AssertionError(f"S1 check 8 {tag} {mode} rank {rank}: "
                                     "integer-valued estimates differ")
            torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                                       atol=1e-5)
            for what, a, b in zip(("probed_k", "nvisited"), got[1:],
                                  want[1:]):
                if not torch.equal(a, b):
                    raise AssertionError(f"S1 check 8 {tag} {mode} rank "
                                         f"{rank}: {what} differs")
            diff = max(diff, float((got[0] - want[0]).abs().max()))
        ops.LAUNCHES.update(saved)
        say(f"S1 check 8 {tag} (each rank's shard of {int(st.n_valid)} "
            f"rows on the CPU against {dev}, queries {keep.tolist()}): both "
            f"modes agree (max |diff| at rank 0 {diff}), probed_k and "
            f"nvisited equal; {time.perf_counter() - t0:.1f} s")

    # ---- the main sequence: build, estimates, two ingests, estimates ----
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    g = torch.Generator(device=dev).manual_seed(seed + 50 + rank)
    st, t_build = clock(lambda: D.build_sharded(corpus[:n], cfg, g,
                                                capacity=cap, device=dev))
    nv = np.full(p_ranks, n // p_ranks, np.int64)
    if int(st.n_valid) != n // p_ranks or st.capacity != cap // p_ranks:
        raise AssertionError(f"S1 rank {rank}: shard n_valid "
                             f"{int(st.n_valid)}, capacity {st.capacity}")
    say(f"S1 build_sharded: {t_build:.3f} s at rank 0 ({p_ranks} shards of "
        f"{n // p_ranks} rows, capacity {st.capacity} a shard)")
    gids = np.arange(rank * n // p_ranks, (rank + 1) * n // p_ranks)
    raw = lsh.project_raw(st.index.params, corpus[:n])
    single = E.build(corpus[:n], cfg, params=st.index.params._replace(
        w=lsh.normalize_w(raw, cfg.n_regions)), capacity=cap, device=dev)
    del raw
    check_single("build", st, single, gids)
    estimates("@ N", st, n)
    check_cpu("@ N", st)
    n_live = n
    for tag, size, want_cap in (("@ N+ingest", spec["ingest"], cap),
                                ("@ grown", spec["grow"], 2 * cap)):
        x_new = corpus[n_live:n_live + size]
        offset = int(nv.sum()) % p_ranks
        (st, nv2), t_up = clock(lambda: D.update_sharded(st, x_new, cfg,
                                                         n_valid=nv))
        single = E.update(single, x_new, cfg, n_valid=n_live)
        mine = np.arange((rank - offset) % p_ranks, size, p_ranks)
        gids = np.concatenate([gids, n_live + mine])
        want_nv = nv + np.bincount((offset + np.arange(size)) % p_ranks,
                                   minlength=p_ranks)
        if nv2.tolist() != want_nv.tolist() or \
                int(st.n_valid) != want_nv[rank]:
            raise AssertionError(f"S1 {tag} rank {rank}: live counts "
                                 f"{nv2.tolist()}, want {want_nv.tolist()}")
        caps = D.shard_counts(st.capacity, device=dev)
        if (caps != want_cap // p_ranks).any():
            raise AssertionError(f"S1 {tag}: shard capacities "
                                 f"{caps.tolist()}, want {want_cap // p_ranks}")
        nv, n_live = nv2, n_live + size
        check_single(tag, st, single, gids)
        say(f"S1 update_sharded {tag}: {size} points in {t_up:.3f} s = "
            f"{size / t_up:.1f} points/s at rank 0; live counts "
            f"{nv.tolist()}, shard capacity {st.capacity}")
        rec[f"update {tag}"] = size / t_up
        estimates(tag, st, n_live)
        check_cpu(tag, st)
    rec["launches"] = {k: ops.LAUNCHES[k] for k in PATH_KERNELS}
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if cuda else None
    # (the CPU's plain versions count no launch)
    missing = [k for k in PATH_KERNELS if rec["launches"][k] == 0]
    if cuda and missing:
        raise AssertionError(f"S1 rank {rank}: kernels not launched: "
                             f"{missing}")
    del st, single, corpus
    if cuda:
        torch.cuda.empty_cache()

    # ---- check 4: eps = 0 recovers the exact count in both modes ----
    g0 = torch.Generator().manual_seed(seed + 60)
    x0 = torch.randn((4000, 32), generator=g0).to(dev)
    cfg0 = ProberConfig(**S1_EPS0_KW)
    st0 = D.build_sharded(x0, cfg0, torch.Generator().manual_seed(seed + 61),
                          device=dev)
    q0, t0 = x0[:3] + 0.01, torch.tensor([1.0, 3.0, 6.0], device=dev)
    truth0 = E.true_cardinality(x0, q0, t0).float()
    for mode in ("local", "sync"):
        est = D.estimate_sharded(st0, q0, t0, cfg0, D.shard_round_keys(
            seed, 3, 1, dev, stream=100), mode=mode)
        if not torch.allclose(est, truth0, rtol=0.0, atol=1e-2):
            raise AssertionError(f"S1 eps=0 {mode}: {est.tolist()} against "
                                 f"{truth0.tolist()}")
    say(f"S1 check 4 (eps = 0, 4,000 x 32 over {p_ranks} ranks): both modes "
        f"equal true_cardinality {truth0.tolist()} within 1e-2")

    # ---- check 5: a group of one rank over NCCL, the plain path ----
    backend = "nccl" if cuda else "gloo"
    solo = dist.new_group([0], backend=backend)
    if rank == 0:
        g5 = torch.Generator().manual_seed(seed + 70)
        x5 = torch.randn((2000, 16), generator=g5).to(dev)
        cfg5 = ProberConfig(**S1_TRIVIAL_KW)
        st5 = D.build_sharded(x5[:1000], cfg5, g5, group=solo,
                              capacity=4096, device=dev)
        nv5 = None
        for i in range(1000, 2000, 250):
            st5, nv5 = D.update_sharded(st5, x5[i:i + 250], cfg5, group=solo,
                                        n_valid=nv5)
        if nv5.tolist() != [2000]:
            raise AssertionError(f"S1 check 5: live counts {nv5.tolist()}")
        q5, t5 = x5[:4] + 0.01, torch.linspace(3.0, 6.0, 4, device=dev)
        rks5 = D.shard_round_keys(seed, 4, cfg5.n_tables, dev, group=solo,
                                  stream=101)
        want = E.estimate_batch(st5, q5, t5, cfg5, rks=rks5)
        for mode in ("local", "sync"):
            got = D.estimate_sharded(st5, q5, t5, cfg5, rks5, group=solo,
                                     mode=mode)
            if not torch.equal(got, want):
                raise AssertionError(f"S1 check 5 {mode}: {got.tolist()} "
                                     f"against {want.tolist()}")
        say(f"S1 check 5 (a {backend} group of one rank: build, 4 updates, "
            "both modes): torch.equal to estimate_batch "
            f"{want.tolist()}")

    # ---- check 6: the reference's skewed split, sync no worse ----
    xs, q6, t6 = vectors.skewed_shards(np.random.default_rng(0), p_ranks)
    cfg6 = ProberConfig(**S1_SKEW_KW)
    xs, q6, t6 = (torch.from_numpy(a).to(dev) for a in (xs, q6, t6))
    st6 = D.build_sharded(xs, cfg6, torch.Generator().manual_seed(seed + 80),
                          device=dev)
    truth6 = E.true_cardinality(xs, q6, t6)
    mq = {}
    for mode in ("local", "sync"):
        est = D.estimate_sharded(st6, q6, t6, cfg6, D.shard_round_keys(
            seed, 6, 1, dev, stream=102), mode=mode)
        mq[mode] = float(q_errors(torch, est, truth6).mean())
    if not (mq["sync"] <= mq["local"] + 1e-6 and mq["sync"] < 1.05):
        raise AssertionError(f"S1 check 6: mean q-error sync {mq['sync']}, "
                             f"local {mq['local']}")
    say(f"S1 check 6 (skewed split over {p_ranks} ranks): mean q-error "
        f"local {mq['local']:.4f}, sync {mq['sync']:.4f}")

    # ---- check 7: ranks on the CPU against ranks on the card, P = 2 ----
    pair = dist.new_group([0, 1])
    if rank < 2:
        g7 = torch.Generator().manual_seed(seed + 2)
        x7 = vectors.make_corpus(g7, spec["small_n"], 32)
        cpu = D.build_sharded(x7, cfg, torch.Generator().manual_seed(seed),
                              group=pair, capacity=2 * spec["small_n"],
                              device="cpu")
        gpu = bridge.state_from_numpy(bridge.state_to_numpy(cpu), dev)
        q7, t7, _ = vectors.paper_query_workload(g7, x7, 48, n_taus=6)
        t7 = t7[torch.arange(48), torch.arange(48) % t7.shape[1]]
        keep = torch.nonzero(tie_free(torch, x7, q7, t7, cpu.index.params))
        keep = keep.squeeze(1)[:16]
        if keep.numel() < 8:
            raise AssertionError("S1 check 7: too few tie-free queries")
        q7, t7 = q7[keep], t7[keep]
        rks = D.shard_round_keys(seed, len(keep), nl, "cpu", group=pair,
                                 stream=103)
        diff = 0.0
        for mode in ("local", "sync"):
            want = D.estimate_sharded(cpu, q7, t7, cfg, rks, group=pair,
                                      mode=mode)
            got = D.estimate_sharded(gpu, q7.to(dev), t7.to(dev), cfg,
                                     rks.to(dev), group=pair,
                                     mode=mode).cpu()
            whole = want == want.round()
            if not torch.equal(got[whole], want[whole]):
                raise AssertionError(f"S1 check 7 {mode}: integer-valued "
                                     "estimates differ")
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            diff = max(diff, float((got - want).abs().max()))
        for name, fn in (
                ("local", lambda s, *a: E.estimate_batch_stats(
                    s, *a[:3], rks=a[3])),
                ("sync", lambda s, *a: E.estimate_batch_pooled(
                    s, *a, pair, with_stats=True))):
            want = fn(cpu, q7, t7, cfg, rks)
            got = fn(gpu, q7.to(dev), t7.to(dev), cfg, rks.to(dev))
            for what, a, b in zip(("probed_k", "nvisited"), got[1:], want[1:]):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"S1 check 7 {name}: {what} differs")
        say(f"S1 check 7 (2 ranks on the CPU against 2 on {dev}, "
            f"{spec['small_n']} x 32, {len(keep)} queries): both modes "
            f"agree (max |diff| {diff}), probed_k and nvisited equal")
    with open(Path(spec["out"]) / f"rank{rank}.json", "w") as fh:
        json.dump(rec, fh)


def phase_sharded(torch, seed, qs, taus, main_qe, corpus_digest, dev,
                  n=N, capacity=CAPACITY, ingest=N_INGEST, grow=N_GROW,
                  small_n=8192):
    """S1: ``S1_RANKS`` gloo ranks on ``dev`` (one card) through
    ``distributed.run_ranks``; logs every rank's launches, collectives and
    peak memory beside the card's name and power limit."""
    import tempfile
    from repro_torch.core import distributed as D
    with tempfile.TemporaryDirectory() as out:
        spec = dict(dev=str(dev), seed=seed, n=n, dim=DIM, capacity=capacity,
                    ingest=ingest, grow=grow, small_n=small_n,
                    qs=qs.cpu(), taus=taus.cpu(), main_qe=main_qe,
                    digest=corpus_digest, out=out)
        D.run_ranks(phase_sharded_rank, S1_RANKS, args=(spec,),
                    backend="gloo", timeout=S1_TIMEOUT)
        recs = [json.loads((Path(out) / f"rank{r}.json").read_text())
                for r in range(S1_RANKS)]
    log(f"S1 ranks ({S1_RANKS} gloo ranks on one card, "
        f"{smi_line() if str(dev).startswith('cuda') else dev}; they share "
        "it, so no time here is a scaling figure):")
    for r in recs:
        ests = r["estimates"]
        log(f"  rank {r['rank']}: launches {json.dumps(r['launches'])}, "
            "peak "
            + ("not measured" if r["peak_gib"] is None
               else f"{r['peak_gib']:.3f} GiB")
            + "; collectives a local / sync estimate: "
            + ", ".join(f"{k} {v['collectives']} ({v['collective_ms']:.1f}"
                        " ms)" for k, v in ests.items()))
    return recs


# L1/L2: the semantic-operator serving path, through the CLI a user
# runs (``python -m repro_torch.launch.serve``): qwen2-7b at full width on
# a SIFT1M-shaped corpus (N = 1M, d = 128), then the planner sharded over
# four gloo ranks on the one card. L1_MAX_NEW is the CLI's max_new.
L1_ARGS = ["--arch", "qwen2-7b", "--scale", "full", "--corpus", str(N),
           "--emb-dim", str(DIM), "--requests", "8", "--slots", "4",
           "--max-len", "256", "--max-calls", "64"]
L1_MAX_NEW, L1_PARAMS, L1_CHECK_LEN = 4, 7_615_616_512, 16
# bfloat16 tolerances, fixed before the first run on the card: logits are
# O(1) (RMS ~1.2, |logit| < 8, where a bfloat16 step is 1/32) and decode
# (M = 1 products) rounds otherwise than forward (M = 16); at this width on
# the CPU 2 and 4 layers differed by 0.039 and 0.047, so 28 layers get
# 0.25. Attention outputs are < 4, where a bfloat16 step is 1/64: 4 steps.
L1_LOGIT_TOL, L1_SDPA_TOL = 0.25, 0.0625
L2_ARGS = L1_ARGS[:2] + ["--scale", "smoke"] + L1_ARGS[4:] + ["--shards",
                                                              "4"]
L1_AGREE_MIN = 6       # of the 8 operators, tie-free ones to compare


def operator_pairs(torch, corpus, queries):
    """The serve CLI's operators ``queries`` (document, target count,
    radius) as ``(qs, taus, exact counts, l2dist max |diff|)``: each
    request's
    ``ops.l2dist`` against ``ref.l2dist`` (rtol/atol 1e-5), and each radius
    moved to the midpoint of the target-th and next squared distance, so
    the exact count is the operator's and no row lies on the sphere.
    Raises unless the plain distances give the CLI's radius (the corpus is
    the CLI's)."""
    from repro_torch.kernels import ops, ref
    qs, taus, exact, err = [], [], [], 0.0
    for doc, target, tau in queries:
        q = corpus[doc][None].contiguous()
        got, want = ops.l2dist(corpus, q), ref.l2dist(corpus, q)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = max(err, float((got - want).abs().max()))
        d2 = torch.sort(want[:, 0]).values
        k = min(target, corpus.shape[0] - 1)
        if k + 1 >= corpus.shape[0] or not abs(
                float(d2[k].sqrt()) - tau) <= 1e-5 * tau:
            raise AssertionError(f"operator on document {doc}: radius {tau} "
                                 "is not the corpus's target-th distance")
        qs.append(q)
        taus.append(((d2[k] + d2[k + 1]) / 2).sqrt())
        exact.append(k + 1)
    return torch.cat(qs), torch.stack(taus), exact, err


def planner_agreement(torch, tag, st, corpus, queries, cfg, keys,
                      group=None):
    """The planner's kernels at its own shapes: :func:`operator_pairs` on
    ``queries``, then each tie-free operator alone (Q = 1, as the planner
    estimates) on a CPU copy of ``st`` (plain versions) and on the card
    with the same round keys ``keys(i)`` (1, L, 6): equal integer-valued
    estimates, ``probed_k`` and ``nvisited``, the rest within rtol 1e-5.
    With a ``group`` (every rank calls it, on its shard) the estimates are
    sync mode's, the group's collectives on both sides, and the tie filter
    holds over every shard. The launch counts are restored after. Returns
    a record for the log."""
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.core import estimator as E
    from repro_torch.kernels import ops
    saved, t0 = dict(ops.LAUNCHES), time.perf_counter()
    qs, taus, exact, l2err = operator_pairs(torch, corpus, queries)
    ok = tie_free(torch, st.x[:int(st.n_valid)], qs, taus,
                  st.index.params).to(torch.int32)
    if group is not None:
        dist.all_reduce(ok, dist.ReduceOp.MIN, group=group)
    keep = torch.nonzero(ok).squeeze(1).tolist()
    if len(keep) < L1_AGREE_MIN:
        raise AssertionError(f"{tag}: {len(keep)} of {len(queries)} "
                             f"operators tie-free, want {L1_AGREE_MIN}")
    cpu = bridge.state_from_numpy(bridge.state_to_numpy(st), "cpu")

    def run(s, q, t, rks):
        if group is None:
            return E.estimate_batch_stats(s, q, t, cfg, rks=rks)
        return E.estimate_batch_pooled(s, q, t, cfg, rks, group,
                                       with_stats=True)

    diff, ests = 0.0, []
    for i in keep:
        rks = keys(i)
        want = run(cpu, qs[i:i + 1].cpu(), taus[i:i + 1].cpu(), rks)
        got = [t.cpu() for t in run(st, qs[i:i + 1], taus[i:i + 1],
                                    rks.to(st.x.device))]
        whole = want[0] == want[0].round()
        if not torch.equal(got[0][whole], want[0][whole]):
            raise AssertionError(f"{tag} operator {i}: integer-valued "
                                 "estimates differ")
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
        for what, a, b in zip(("probed_k", "nvisited"), got[1:], want[1:]):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag} operator {i}: {what} differs")
        diff = max(diff, float((got[0] - want[0]).abs().max()))
        ests.append(float(got[0][0]))
    ops.LAUNCHES.update(saved)
    return dict(kept=keep, l2dist_err=l2err, est_diff=diff, ests=ests,
                exact=[exact[i] for i in keep],
                seconds=time.perf_counter() - t0)


def phase_lm_serving(torch, seed, dev="cuda"):
    """L1: ``launch.serve.main`` at full width on ``dev``, launch counts
    zeroed just before and read just after; then the model's own checks at
    full width (:func:`lm_checks`). Returns the CLI's record."""
    import gc
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    stats: dict = {}
    served, refused = serve.main(L1_ARGS + ["--seed", str(seed),
                                            "--device", str(dev)],
                                 stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    eng = stats["engine"]
    log(f"L1 serve CLI ({smi_line()}): {served} LLM calls served, {refused} "
        f"operators refused, {wall:.1f} s in main; {stats['params']:,} "
        f"parameters, {stats['param_bytes'] / 2 ** 30:.3f} GiB, init "
        f"{stats['init_s']:.3f} s; index build {stats['planner_build_s']:.3f}"
        f" s; planner {1e3 * stats['plan_s'] / stats['n_plans']:.1f} ms an "
        f"estimate ({stats['n_plans']}); prefill "
        f"{1e3 * eng['prefill_s'] / max(eng['prefills'], 1):.2f} ms a "
        f"request ({eng['prefills']}, host clock, argmax read); decode "
        f"{1e3 * eng['decode_s'] / max(eng['steps'], 1):.2f} ms a step "
        f"({eng['steps']} steps, {eng['tokens']} tokens, "
        f"{eng['tokens'] / max(eng['decode_s'], 1e-9):.1f} tokens/s); peak "
        f"{peak:.3f} GiB; plans {stats['plans']}")
    log(f"L1 launches over the phase: {json.dumps(counts)}")
    if served < 1 or refused < 1:
        raise SystemExit(f"L1: {served} served, {refused} refused; want at "
                         "least one of each")
    bad = [n for n in stats["new_tokens"] if not 1 <= n <= L1_MAX_NEW]
    if bad or len(stats["new_tokens"]) != served:
        raise SystemExit(f"L1: finished requests with {bad} tokens")
    if stats["params"] != L1_PARAMS:
        raise SystemExit(f"L1: {stats['params']} parameters, want "
                         f"{L1_PARAMS}")
    missing = [k for k in PATH_KERNELS if counts[k] == 0]
    if missing or counts["l2dist"] < len(stats["plans"]):
        raise SystemExit(f"L1: {missing} not launched, or l2dist "
                         f"{counts['l2dist']} < one a request")
    none_replaced(counts, "L1")
    from argparse import Namespace
    from repro_torch.core import estimator as E
    corpus, _ = serve.draw_corpus(Namespace(seed=seed, corpus=N,
                                            emb_dim=DIM), torch.device(dev))
    st = E.build(corpus, serve.PLANNER_CFG,
                 torch.Generator(device=dev).manual_seed(seed), device=dev)
    gk = torch.Generator().manual_seed(seed + 13)
    agree = planner_agreement(
        torch, "L1 planner", st, corpus, stats["queries"], serve.PLANNER_CFG,
        lambda i: E.draw_round_keys(gk, 1, serve.PLANNER_CFG.n_tables,
                                    "cpu"))
    log(f"L1 planner at the CLI's shapes (1M x 128, L = 2, K = 8, budgets "
        f"1024, one query an estimate): l2dist of {len(stats['queries'])} "
        f"requests vs ref.l2dist max |diff| {agree['l2dist_err']}; operators "
        f"{agree['kept']} tie-free, CPU and card agree (max |diff| "
        f"{agree['est_diff']}, estimates {agree['ests']}, exact "
        f"{agree['exact']}), probed_k and "
        f"nvisited equal; {agree['seconds']:.1f} s")
    del corpus, st
    lm_checks(torch, seed, dev)
    return stats


def lm_checks(torch, seed, dev="cuda"):
    """qwen2-7b at full width on the card: teacher-forced ``decode_step``
    against ``forward`` on one 16-token sequence and the SDPA route against
    plain ``_sdpa`` (L1_LOGIT_TOL, L1_SDPA_TOL; greedy tokens equal where
    the top-2 gap exceeds L1_LOGIT_TOL); CUDA-event times of a decode step
    (4 slots x 256) beside its byte bound, of a prefill, and of both
    attention forms; a profile of each."""
    import gc
    from repro_torch import configs
    from repro_torch.models import layers as L, transformer as T
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device(dev)
    cfg = configs.get_config("qwen2-7b")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = T.init(cfg, g, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab, (1, L1_CHECK_LEN), generator=g,
                         device=dev)
    with torch.no_grad():
        full = T.forward(model, {"tokens": toks}, cfg)[0]
    cache = T.init_cache(cfg, 1, L1_CHECK_LEN, device=dev)
    outs = []
    for t in range(L1_CHECK_LEN):
        logits, cache = T.decode_step(model, cache, toks[:, t], cfg)
        outs.append(logits[0])
    dec = torch.stack(outs)
    diff = float((dec - full).abs().max())
    top2 = full.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > L1_LOGIT_TOL
    same = (dec.argmax(-1) == full.argmax(-1))
    log(f"L1 decode vs forward (qwen2-7b full width, {L1_CHECK_LEN} tokens, "
        f"bfloat16): max |diff| {diff:.6f} (tol {L1_LOGIT_TOL}); greedy "
        f"tokens equal at {int(same.sum())} of {L1_CHECK_LEN} positions, "
        f"{int(clear.sum())} with a top-2 gap above the tolerance; init "
        f"{init_s:.3f} s")
    if not diff <= L1_LOGIT_TOL or not bool(same[clear].all()):
        raise SystemExit("L1: decode_step disagrees with forward")
    with torch.no_grad():
        x = L.apply_norm(model.layers[0].ln1,
                         L.embed(model.embed, toks, cfg), cfg)
        pos = torch.arange(L1_CHECK_LEN, device=dev)
        q, k, v = L.qkv_project(model.layers[0].attn, x, cfg, pos[None])
    causal = (pos[:, None] >= pos[None, :])[None, None]
    # the decode shape: 4 slots at their own positions over a 256-row cache
    gq = torch.Generator(device=dev).manual_seed(seed + 12)
    dq = torch.randn((4, 1, cfg.n_heads, cfg.hd), generator=gq, device=dev
                     ).to(torch.bfloat16)
    dk, dv = (torch.randn((4, 256, cfg.n_kv, cfg.hd), generator=gq,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    dpos = torch.tensor([200, 100, 50, 17], device=dev)
    dmask = (torch.arange(256, device=dev)[None, :] <= dpos[:, None])[
        :, None, None, :]
    for tag, args in (("prefill 1 x 16", (q, k, v, causal)),
                      ("decode 4 x 1 over 256", (dq, dk, dv, dmask))):
        plain, lib = L._sdpa(*args, cfg), L.sdpa_library(*args, cfg)
        d = float((plain.float() - lib.float()).abs().max())
        ms_p = cuda_ms(torch, lambda: L._sdpa(*args, cfg))
        ms_l = cuda_ms(torch, lambda: L.sdpa_library(*args, cfg))
        log(f"L1 attention {tag}: SDPA vs plain max |diff| {d:.6f} (tol "
            f"{L1_SDPA_TOL}, outputs up to "
            f"{float(plain.float().abs().max()):.3f}); plain {ms_p:.4f} ms, "
            f"SDPA {ms_l:.4f} ms; SDPA backend kernels: "
            f"{sdpa_kernels(torch, lambda: L.sdpa_library(*args, cfg))}")
        if not d <= L1_SDPA_TOL:
            raise SystemExit(f"L1: SDPA disagrees with plain _sdpa ({tag})")
    # a decode step of the CLI's shape: 4 slots, a 256-row cache
    cache4 = T.init_cache(cfg, 4, 256, device=dev)
    cache4["pos"] = dpos.int()
    tok4 = torch.randint(0, cfg.vocab, (4,), generator=gq, device=dev)
    emb = model.embed.embedding
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    kv_bytes = sum(cache4[k].numel() * cache4[k].element_size()
                   for k in ("k", "v"))
    b_ms = bound_ms(weights - emb.numel() * emb.element_size() + kv_bytes,
                    0)[0]
    step = {"sdpa": cuda_ms(torch, lambda: T.decode_step(
        model, cache4, tok4, cfg), iters=10)}
    route = L.attend
    L.attend = L._sdpa               # plain _sdpa as the route, for timing
    try:
        step["plain"] = cuda_ms(torch, lambda: T.decode_step(
            model, cache4, tok4, cfg), iters=10)
    finally:
        L.attend = route
    pre = cuda_ms(torch, lambda: T.prefill(model, {"tokens": toks[:, :8]},
                                           cfg, max_len=256), iters=10)
    log(f"L1 decode step (4 slots, 256-row cache, CUDA events, "
        f"{smi_line()}): {step['sdpa']:.3f} ms (SDPA, the card's route; "
        f"{step['plain']:.3f} ms with plain _sdpa); byte bound {b_ms:.3f} ms (weights but the "
        f"embedding table, and the K/V cache, at 3.35 TB/s: "
        f"{(weights - emb.numel() * emb.element_size()) / 1e9:.3f} GB); "
        f"{4e3 / step['sdpa']:.1f} tokens/s at 4 slots; prefill of 8 "
        f"tokens {pre:.3f} ms")
    phase_profile(torch, [
        ("qwen2-7b decode step, 4 slots x 256", lambda: T.decode_step(
            model, cache4, tok4, cfg)),
        ("qwen2-7b prefill, 8 tokens", lambda: T.prefill(
            model, {"tokens": toks[:, :8]}, cfg, max_len=256))])
    del model, cache, cache4
    gc.collect()
    torch.cuda.empty_cache()


def sdpa_kernels(torch, fn) -> str:
    """The device kernels one call of ``fn`` launched (profiler names)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key[:60] for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA})
    return ", ".join(names) or "none seen by the profiler"


def planner_shard_rank(rank, spec):
    """One rank of L2's agreement (spawned by ``distributed.run_ranks``):
    this rank's shard of the CLI's planner index, built as the sharded
    planner builds it, and :func:`planner_agreement` in sync mode on the
    operators ``spec["queries"]``; writes its record to ``spec["out"]``."""
    from argparse import Namespace
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.launch import serve
    dev = torch.device(spec["dev"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    world = dist.group.WORLD
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // dist.get_world_size()))
    seed, cfg = spec["seed"], serve.PLANNER_CFG
    corpus, _ = serve.draw_corpus(Namespace(seed=seed, corpus=spec["n"],
                                            emb_dim=spec["dim"]), dev)
    st = D.build_sharded(corpus, cfg,
                         torch.Generator(device=dev).manual_seed(seed),
                         group=world, device=dev)
    rec = planner_agreement(
        torch, f"L2 planner rank {rank}", st, corpus, spec["queries"], cfg,
        lambda i: D.shard_round_keys(seed, 1, cfg.n_tables, "cpu",
                                     stream=300 + i), group=world)
    rec.update(rank=rank, rows=int(st.n_valid))
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)


def phase_sharded_planner(torch, seed, dev="cuda"):
    """L2: the serve CLI with ``--shards 4`` on the card (gloo ranks, smoke
    model on rank 0) in both stopping modes: ``main`` raises unless every
    rank planned the same, and the sharded coalescer raises if its SPMD
    check fails; logs the plans, collectives an estimate, and wall and
    launches a rank. Then :func:`planner_shard_rank` on four ranks with the
    sync run's operators."""
    import tempfile
    from repro_torch.core import distributed as D
    from repro_torch.launch import serve
    queries = None
    for mode in ("sync", "local"):
        stats: dict = {}
        t0 = time.perf_counter()
        served, refused = serve.main(L2_ARGS + [
            "--stopping", mode, "--seed", str(seed), "--device", str(dev)],
            stats=stats)
        wall = time.perf_counter() - t0
        ranks = stats["ranks"]
        if any(r["plans"] != ranks[0]["plans"] for r in ranks):
            raise SystemExit(f"L2 {mode}: plans differ between ranks")
        log(f"L2 {mode} (4 gloo ranks on one card, {smi_line()}; they share "
            f"it, so no time here is a scaling figure): {served} served, "
            f"{refused} refused, {wall:.1f} s in main; plans equal on all "
            f"{len(ranks)} ranks; plans (action, estimate, calls) "
            f"{ranks[0]['plans']}")
        for r in ranks:
            log(f"  rank {r['rank']}: "
                f"{r['plan_collectives'] / r['n_plans']:.1f} collectives and "
                f"{1e3 * r['plan_s'] / r['n_plans']:.1f} ms an estimate; "
                f"index build {r['planner_build_s']:.3f} s; request loop "
                f"{r['wall_s']:.3f} s; launches "
                f"{json.dumps({k: v for k, v in r['launches'].items() if v})}")
        if mode == "sync":
            queries = ranks[0]["queries"]
    with tempfile.TemporaryDirectory() as out:
        spec = dict(dev=str(dev), seed=seed, n=N, dim=DIM, queries=queries,
                    out=out)
        D.run_ranks(planner_shard_rank, 4, args=(spec,), backend="gloo",
                    timeout=S1_TIMEOUT)
        recs = [json.loads((Path(out) / f"rank{r}.json").read_text())
                for r in range(4)]
    log(f"L2 planner at the CLI's shapes, sync mode, 4 gloo ranks on one "
        f"card: l2dist vs ref.l2dist max |diff| {recs[0]['l2dist_err']}; "
        f"operators {recs[0]['kept']} tie-free over every shard, exact "
        f"counts {recs[0]['exact']}")
    for r in recs:
        log(f"  rank {r['rank']} ({r['rows']} rows): CPU copy and card agree "
            f"(max |diff| {r['est_diff']}, estimates {r['ests']}), probed_k "
            f"and nvisited equal; {r['seconds']:.1f} s")


# L3: each family at its published config through the serve steps:
# (arch, prefill batch, prefill length or encoder frames, decode cache
# rows). The prefill lengths take each family's long-sequence route:
# rwkv6's chunked WKV (four chunks of 128), rglru's windowed attention
# past its 2048 window, whisper's 30 s of audio (1500 encoder frames);
# moe four sequences of 64. Decode: 4 slots, 16 steps; rglru's cache
# rows give its 2048-row window ring, whisper's its 448-token decoder.
L3_MODELS = (("rwkv6-1.6b", 4, 512, 256),
             ("recurrentgemma-9b", 1, 4096, 4096),
             ("whisper-medium", 4, 1500, 448),
             ("qwen3-moe-30b-a3b", 4, 64, 256))
L3_SLOTS, L3_STEPS, L3_CHECK_LEN = 4, 16, 16
L3_HEADROOM = 8 * 2 ** 30    # device bytes kept free beside the weights
# float32: the reference's test_rwkv_chunked_equals_sequential tolerance;
# the doubling scan rounds at most log2(4096) = 12 times an element where
# the loop rounds once a step, both contracting (0 < a < 1)
L3_WKV_TOL, L3_SCAN_TOL = 2e-3, 1e-5
# Where bfloat16 rounding alone takes decode past L1_LOGIT_TOL from
# forward, the decode check's max |diff| runs on a float32 copy at full
# width (depth cut only if it does not fit) and the bfloat16 one is logged,
# its greedy tokens still held. recurrentgemma-9b: 0.37-0.44 in bfloat16
# over 38 layers on four sequences, 6e-5 and 1e-4 in float32. qwen3-moe:
# 0.258, its router's bfloat16 logits tie at the 8th expert (794 of 12,288
# token-layer pairs of the prefill batch), so rounding flips which expert
# runs. (rwkv6's float32 gap is 3e-2 at 24 layers and grows with depth in
# the reference too, 1.2e-5 at 1 layer and 1.4e-4 at 4: no copy for it)
L3_F32_COPY = ("recurrentgemma-9b", "qwen3-moe-30b-a3b")
L3_F32_TOL = 1e-3


def phase_families(torch, seed, dev="cuda"):
    """L3: each of ``L3_MODELS`` in turn (:func:`family_run`), the model
    freed before the next."""
    import gc
    for i, (arch, b, s, rows) in enumerate(L3_MODELS):
        gc.collect()
        torch.cuda.empty_cache()
        family_run(torch, arch, b, s, rows, seed + 20 + i, torch.device(dev))
    gc.collect()
    torch.cuda.empty_cache()


def weight_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def fit_depth(torch, cfg, dev):
    """``cfg`` with the most layers (at most its own) whose weights fit
    beside ``L3_HEADROOM`` in the card's free memory: the width is never
    cut."""
    from repro_torch.models import get_family
    free = torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else 2 ** 62
    n = cfg.n_layers
    while n > 1 and weight_bytes(get_family(cfg).init(
            cfg.replace(n_layers=n), torch.Generator(), "meta")) \
            + L3_HEADROOM > free:
        n -= 1
    return cfg.replace(n_layers=n)


def step_bytes(model, cfg, cache) -> int:
    """Bytes a decode step reads: every weight but the embedding rows it
    gathers (the whole table when the unembedding is tied to it) and
    whisper's encoder and positions; and every cache tensor."""
    skip = ("enc_layers.", "enc_norm.", "dec_pos")
    if not cfg.tie_embeddings:
        skip += ("embed.embedding",)
    w = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
            if not n.startswith(skip))

    def leaves(c):
        for v in c.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)
    return w + sum(t.numel() * t.element_size() for t in leaves(cache))


def l3_batch(torch, cfg, b, s, g, dev):
    """The prefill input: ``b`` x ``s`` tokens, or whisper's ``b`` x ``s``
    encoder frames (stub embeddings)."""
    if cfg.input_mode == "encdec":
        return {"frames": torch.randn((b, s, cfg.d_model), generator=g,
                                      device=dev).to(cfg.torch_dtype)}
    return {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                    device=dev)}


def decode_vs_forward(torch, fam, model, cfg, toks, dev, enc=None):
    """Teacher-forced decode of ``toks`` (1, T) against forward (whisper:
    against ``decode`` given the encoder output ``enc``, after
    ``prefill_cross`` of it), caches in ``cfg.dtype``'s precision: (max
    |diff| of the logits, whether the greedy tokens are equal wherever
    forward's top-2 gap exceeds ``L1_LOGIT_TOL``, how many positions have
    such a gap)."""
    t = toks.shape[1]
    dt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    with torch.no_grad():
        if enc is None:
            full = fam.forward(model, {"tokens": toks}, cfg)[0]
            cache = fam.init_cache(cfg, 1, t, dtype=dt, device=dev)
        else:
            full = fam.decode(model, toks, enc, cfg)[0]
            cache = fam.prefill_cross(model, enc, fam.init_cache(
                cfg, 1, t, dtype=dt, enc_len=enc.shape[1], device=dev), cfg)
    outs = []
    for i in range(t):
        logits, cache = fam.decode_step(model, cache, toks[:, i], cfg)
        outs.append(logits[0])
    dec = torch.stack(outs)
    top2 = full.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > L1_LOGIT_TOL
    same = dec.argmax(-1) == full.argmax(-1)
    return (float((dec - full).abs().max()), bool(same[clear].all()),
            int(clear.sum()))


def no_drops(cfg):
    """moe: ``cfg`` with a capacity for every token of a group (c = S), so
    that forward drops nothing, as decode's groups of B tokens do not."""
    if cfg.family != "moe":
        return cfg
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)


def f32_twin(torch, arch, seed, dev):
    """Decode vs forward on a float32 copy of ``arch`` at its published
    width (its depth cut only if float32 weights do not fit, logged): the
    cache's correctness without bfloat16 rounding; fatal beyond
    ``L3_F32_TOL``."""
    from repro_torch import configs
    from repro_torch.models import get_family
    published = configs.get_config(arch)
    cfg = no_drops(fit_depth(torch, published.replace(dtype="float32"),
                             dev))
    fam = get_family(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = fam.init(cfg, g, dev)
    toks = torch.randint(0, cfg.vocab, (1, L3_CHECK_LEN), generator=g,
                         device=dev)
    diff, _, _ = decode_vs_forward(torch, fam, model, cfg, toks, dev)
    log(f"L3 {arch} float32 copy ({cfg.n_layers} of {published.n_layers} "
        f"layers{', capacity for every token' if cfg.family == 'moe' else ''}"
        f", {weight_bytes(model) / 2 ** 30:.3f} GiB): decode vs "
        f"forward ({L3_CHECK_LEN} tokens) max |diff| {diff:.3e} (tol "
        f"{L3_F32_TOL})")
    if not diff <= L3_F32_TOL:
        raise SystemExit(f"L3 {arch}: float32 decode_step disagrees with "
                         "forward")


def routes_agree(torch, tag, fn):
    """``fn()`` with ``layers.attend`` on its card route (SDPA) and with
    plain ``_sdpa`` patched in: max |diff|, times and SDPA's kernels;
    fatal beyond ``L1_SDPA_TOL``."""
    from repro_torch.models import layers as L
    route = L.attend
    with torch.no_grad():
        lib = fn()
        ms_l = cuda_ms(torch, fn, iters=3)
        kernels = sdpa_kernels(torch, fn)
        L.attend = L._sdpa
        try:
            plain = fn()
            ms_p = cuda_ms(torch, fn, iters=3)
        finally:
            L.attend = route
    d = float((lib.float() - plain.float()).abs().max())
    log(f"{tag}: SDPA vs plain _sdpa max |diff| {d:.6f} (tol {L1_SDPA_TOL}, "
        f"outputs up to {float(plain.float().abs().max()):.3f}); SDPA "
        f"{ms_l:.4f} ms, plain {ms_p:.4f} ms; SDPA backend kernels: "
        f"{kernels}")
    if not d <= L1_SDPA_TOL:
        raise SystemExit(f"{tag}: SDPA disagrees with plain _sdpa")


def moe_routing(torch, model, toks, cfg):
    """moe's forward over ``toks`` layer by layer, its router read at each
    layer: (the (token, slot) assignments dropped at the capacity, the
    (token, layer) pairs with a drop, the tokens whose k-th and (k+1)-th
    gates tie, the untied tokens where the stable top-k's experts differ
    from ``torch.topk``'s)."""
    from repro_torch.models import layers as L, moe as M, transformer as T
    k, e = cfg.top_k, cfg.n_experts
    dropped = pairs = ties = differ = 0
    with torch.no_grad():
        x = L.embed(model.embed, toks, cfg)
        rope = T._rope(x, cfg)
        for blk in model.layers:
            h = x + T._attn(blk.attn, L.apply_norm(blk.ln1, x, cfg), cfg,
                            rope)
            hn = L.apply_norm(blk.ln2, h, cfg)
            gates = torch.softmax((hn @ blk.moe.router.to(hn.dtype)).float(),
                                  dim=-1)
            _, topi = M.top_k(gates, k)
            srt = torch.sort(gates, dim=-1, descending=True).values
            tie = srt[..., k - 1] == srt[..., k]
            lib = torch.topk(gates, k).indices
            same = (topi.sort(-1).values == lib.sort(-1).values).all(-1)
            _, keep = M.dispatch(topi, e, M.capacity(cfg, toks.shape[1]))
            dropped += int((~keep).sum())
            pairs += int((~keep).any(-1).sum())
            ties += int(tie.sum())
            differ += int((~same & ~tie).sum())
            x = h + M.apply_moe(blk.moe, hn, cfg)
    return dropped, pairs, ties, differ


def moe_checks(torch, model, cfg, prefill_toks, toks, tag):
    """moe: the assignments forward drops over the prefill batch and over
    the decode check's sequence ``toks`` at ``cfg``'s capacity, the gate
    ties at the k-th expert, and the top-k rule (fatal)."""
    from repro_torch.models import moe as M
    for what, t in (("the prefill batch", prefill_toks),
                    ("the decode check's sequence", toks)):
        dropped, pairs, ties, differ = moe_routing(torch, model, t, cfg)
        n = t.numel() * cfg.n_layers
        log(f"{tag} routing over {what} {tuple(t.shape)} (capacity_factor "
            f"{cfg.capacity_factor}: {M.capacity(cfg, t.shape[1])} slots an "
            f"expert a sequence): {dropped} of {n * cfg.top_k} (token, slot, "
            f"layer) assignments dropped, at {pairs} of "
            f"{n} (token, layer) pairs; k-th / "
            f"(k+1)-th gate ties at {ties}; stable top-k and torch.topk pick "
            f"other experts at {differ} untied")
        if differ:
            raise SystemExit(f"{tag}: stable top-k and torch.topk disagree")


def family_checks(torch, model, cfg, batch, tag):
    """The family's own fatal checks: SDPA against plain for whisper's
    encoder and cross-attention and rglru's windowed attention; rwkv6's
    chunked WKV against the sequential one and rglru's doubling scan
    against a loop, in float32, on the first layer's real inputs."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L, rglru as G, rwkv6 as R, \
        whisper as W
    with torch.no_grad():
        if cfg.family == "whisper":
            lp = model.enc_layers[0]
            h = L.apply_norm(lp.ln1, batch["frames"], cfg)
            routes_agree(torch, f"{tag} encoder attention "
                         f"{tuple(h.shape)}", lambda: L.causal_attention(
                             lp.attn, h, cfg, causal=False))
            dp = model.dec_layers[0]
            enc = W.encode(model, batch["frames"], cfg)
            kv = W._enc_kv(dp.cross_attn, enc, cfg)
            toks = torch.zeros((enc.shape[0], L3_CHECK_LEN), dtype=torch.long,
                               device=enc.device)
            hq = L.apply_norm(dp.ln2, L.embed(model.embed, toks, cfg), cfg)
            routes_agree(torch, f"{tag} cross-attention {tuple(hq.shape)} "
                         f"over {enc.shape[1]} frames",
                         lambda: W._cross_attention(dp.cross_attn, hq, kv,
                                                    cfg))
        if cfg.family == "rglru":
            x = L.embed(model.embed, batch["tokens"], cfg)
            blk = model.groups[0].attn
            h = L.apply_norm(blk.ln1, x, cfg)
            routes_agree(torch, f"{tag} windowed_attention {tuple(h.shape)}, "
                         f"window {cfg.window}",
                         lambda: L.windowed_attention(blk.mix, h, cfg))
            rec = model.groups[0].rec1
            u = G._causal_conv(rec.mix, L.apply_norm(rec.ln1, x, cfg)
                               @ rec.mix.w_in.to(x.dtype))
            a, b = G._lru_coeffs(rec.mix, u)
            got = G.linear_scan(a, b)
            want = torch.empty_like(b)
            h = torch.zeros_like(b[:, 0])
            for t in range(b.shape[1]):
                h = a[:, t] * h + b[:, t]
                want[:, t] = h
            d = float((got - want).abs().max())
            ms_scan = cuda_ms(torch, lambda: G.linear_scan(a, b), iters=5)
            log(f"{tag} doubling scan vs a sequential loop ((a, b) "
                f"{tuple(b.shape)} of the first recurrent block, float32): "
                f"max |diff| {d:.3e} (rtol = atol = {L3_SCAN_TOL}, |h| up to "
                f"{float(want.abs().max()):.3f}); scan {ms_scan:.4f} ms")
            torch.testing.assert_close(got, want, rtol=L3_SCAN_TOL,
                                       atol=L3_SCAN_TOL)
        if cfg.family == "rwkv6":
            blk = model.layers[0]
            x = L.apply_norm(blk.ln1, L.embed(model.embed, batch["tokens"],
                                              cfg), cfg)
            xx = F.pad(x, (0, 0, 1, 0))[:, :-1]
            r, k, v, _, w, u, _ = R._tm_projections(
                blk.tm, x, xx, cfg, R._route(blk.tm, cfg))
            got = R._wkv_chunked(r, k, v, w, u, cfg.rwkv_chunk)
            want = R._wkv_sequential(r, k, v, w, u)
            d = float((got - want).abs().max())
            ms_c = cuda_ms(torch, lambda: R._wkv_chunked(
                r, k, v, w, u, cfg.rwkv_chunk), iters=3)
            ms_s = cuda_ms(torch, lambda: R._wkv_sequential(r, k, v, w, u),
                           iters=1)
            log(f"{tag} chunked WKV vs sequential (r, k, v, w "
                f"{tuple(r.shape)} of layer 0, chunk {cfg.rwkv_chunk}, "
                f"float32): max |diff| {d:.3e} (rtol = atol = {L3_WKV_TOL}, "
                f"outputs up to {float(want.abs().max()):.3f}); chunked "
                f"{ms_c:.3f} ms, sequential {ms_s:.3f} ms")
            torch.testing.assert_close(got, want, rtol=L3_WKV_TOL,
                                       atol=L3_WKV_TOL)


def family_run(torch, arch, b, s, rows, seed, dev):
    """One family of L3: init at the published width, prefill, 16 decode
    steps and their profile, then the checks (the module docstring)."""
    import gc
    from repro_torch import configs
    from repro_torch.models import get_family
    from repro_torch.serve import step
    published = configs.get_config(arch)
    cfg = fit_depth(torch, published, dev)
    fam = get_family(cfg)
    tag = f"L3 {arch}"
    if cfg.replace(n_layers=published.n_layers) != published:
        raise SystemExit(f"{tag}: not the published width")
    g = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = fam.init(cfg, g, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    depth = ("full depth" if cfg.n_layers == published.n_layers else
             f"DEPTH CUT from {published.n_layers} layers (the weights and "
             f"{L3_HEADROOM / 2 ** 30:.0f} GiB must fit)")
    log(f"{tag} ({smi_line()}): full width (d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff}, {cfg.n_heads} heads / {cfg.n_kv} KV x {cfg.hd}, vocab "
        f"{cfg.vocab}, experts {cfg.n_experts} top-{cfg.top_k}, window "
        f"{cfg.window}, encoder layers {cfg.enc_layers}), {cfg.n_layers} "
        f"layers, {depth}; {sum(p.numel() for p in model.parameters()):,} "
        f"parameters (cfg.param_count() {cfg.param_count():,}), "
        f"{weight_bytes(model) / 2 ** 30:.3f} GiB, init {init_s:.3f} s")
    batch = l3_batch(torch, cfg, b, s, g, dev)
    prefill = step.make_prefill_step(cfg)
    logits = prefill(model, batch)
    if logits.shape != (b, cfg.vocab) or not bool(logits.isfinite().all()):
        raise SystemExit(f"{tag}: prefill logits {tuple(logits.shape)} not "
                         "(B, V) or not finite")
    pre_ms = cuda_ms(torch, lambda: prefill(model, batch), iters=3)
    # 16 decode steps over 4 slots, each timed by CUDA events
    kw = dict(enc_len=s) if cfg.family == "whisper" else {}
    cache = fam.init_cache(cfg, L3_SLOTS, rows, device=dev, **kw)
    if kw:
        with torch.no_grad():
            enc = fam.encode(model, batch["frames"][:L3_SLOTS], cfg)
        cache = fam.prefill_cross(model, enc, cache, cfg)
    decode = step.make_decode_step(cfg)
    tok = torch.randint(0, cfg.vocab, (L3_SLOTS,), generator=g, device=dev)
    nbytes = step_bytes(model, cfg, cache)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(L3_STEPS + 1)]
    ev[0].record()
    for i in range(L3_STEPS):
        logits, cache = decode(model, cache, tok)
        tok = logits.argmax(-1)
        ev[i + 1].record()
    torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(L3_STEPS)]
    if not bool(logits.isfinite().all()) or int(cache["pos"]) != L3_STEPS:
        raise SystemExit(f"{tag}: decode logits not finite or pos "
                         f"{int(cache['pos'])} != {L3_STEPS}")
    steady = sum(ms[1:]) / (L3_STEPS - 1)
    log(f"{tag} prefill ({b} x {s} {'frames' if kw else 'tokens'}, CUDA "
        f"events, {smi_line()}): {pre_ms:.3f} ms; decode step ({L3_SLOTS} "
        f"slots, {rows}-row cache): first {ms[0]:.3f} ms, then mean "
        f"{steady:.3f} ms (min {min(ms[1:]):.3f}, max {max(ms[1:]):.3f}), "
        f"{1e3 * L3_SLOTS / steady:.1f} tokens/s; byte bound "
        f"{bound_ms(nbytes, 0)[0]:.3f} ms (the weights a step reads and its "
        f"cache, {nbytes / 1e9:.3f} GB at 3.35 TB/s); peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    phase_profile(torch, [
        (f"{arch} decode step, {L3_SLOTS} slots",
         lambda: decode(model, cache, tok)),
        (f"{arch} prefill, {b} x {s}", lambda: prefill(model, batch))])
    toks = torch.randint(0, cfg.vocab, (1, L3_CHECK_LEN), generator=g,
                         device=dev)
    enc = None
    if cfg.family == "moe":
        moe_checks(torch, model, cfg, batch["tokens"], toks, tag)
    if cfg.family == "whisper":
        with torch.no_grad():
            enc = fam.encode(model, batch["frames"][:1], cfg)
    diff, greedy, clear = decode_vs_forward(torch, fam, model, no_drops(cfg),
                                            toks, dev, enc)
    room = ", capacity for every token" if cfg.family == "moe" else ""
    log(f"{tag} decode vs {'decode' if kw else 'forward'} ({L3_CHECK_LEN} "
        f"tokens, bfloat16{room}): max |diff| {diff:.6f} (tol "
        f"{L1_LOGIT_TOL}{', logged' if arch in L3_F32_COPY else ''}); "
        f"greedy tokens equal "
        f"at the {clear} positions whose top-2 gap exceeds it: {greedy}")
    if not greedy or not (arch in L3_F32_COPY or diff <= L1_LOGIT_TOL):
        raise SystemExit(f"{tag}: decode_step disagrees with forward")
    family_checks(torch, model, cfg, batch, tag)
    log(f"{tag}: peak over the family "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    if arch in L3_F32_COPY:
        del model, cache, batch
        gc.collect()
        torch.cuda.empty_cache()
        f32_twin(torch, arch, seed, dev)


# ------------------------------------------------------ T1: training ----

T1_ARCH = "qwen2.5-3b"
T1_BATCH, T1_SEQ, T1_MICRO = 4, 512, 2      # 2,048 tokens, 2 microbatches
T1_WARMUP, T1_STEPS = 2, 8
# the phase's AdamW (set before the first run): step 1 at lr 1e-4
T1_OPT = dict(lr=1e-4, warmup_steps=1, total_steps=T1_WARMUP + T1_STEPS)
BF16_FLOP_S = 989e12            # H100 SXM dense bf16 tensor, data sheet
ADAMW_BYTES = 28                # a parameter: read p, g, m, v; write p, m, v
# T1b, card against CPU in float32 on 2 layers at full width, one step:
# loss absolute; grad norm relative; m and v (linear in the gradient) within
# T1_STATE_TOL of each leaf's largest element; params within T1_RTOL of |p|
# plus T1_STEP_ATOL·lr where |m| is at least T1_COND of its leaf's largest,
# and within one step's reach, (2 + wd·|p|)·lr, elsewhere: on step 1 the
# update is m̂/(√v̂+ε) = g/(|g|+ε), which the two devices' summation
# orders move freely where g is a cancellation residue near ε (0.16·lr in
# the attention weights, whose gradients at a random init are mostly such
# residues), and hardly at all where |g| is well above its noise
T1_CPU_LAYERS, T1_CPU_BATCH, T1_CPU_SEQ = 2, 2, 64
T1_LOSS_TOL, T1_RTOL, T1_STEP_ATOL, T1_STATE_TOL = 1e-4, 1e-4, 0.05, 1e-3
T1_COND = 1e-3
# T1c: the SDPA route's q/k/v gradients against plain _sdpa's, bfloat16,
# relative to the largest plain gradient
T1_SDPA_GRAD_TOL = 0.0625
# T1d: the driver's loop with failures against the uninterrupted one
T1_FT_ARGS = ["--arch", T1_ARCH, "--scale", "smoke", "--steps", "24",
              "--save-every", "4"]
T1_FT_FAIL = (7, 13)
T1_FT_TOL = 1e-3


def phase_training(torch, seed, dev="cuda"):
    """T1 (the module docstring): a, the full-width trainer; b, card
    against CPU; c, the attention backward; d, the driver and its
    restarts."""
    import gc
    dev = torch.device(dev)
    model, batch = t1_trainer(torch, seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t1_cpu_agreement(torch, seed, dev)
    t1_attention_backward(torch, model, batch, seed)
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    t1_driver(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()


def t1_trainer(torch, seed, dev):
    """T1a: ``build_trainer`` at qwen2.5-3b's published config, 2 warm-up
    and 8 timed steps of ``make_train_step``; returns the model (its AdamW
    state freed) and the last batch."""
    from repro_torch import configs
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_loss_fn
    cfg = configs.get_config(T1_ARCH)
    tag = f"T1 {T1_ARCH}"
    opt_cfg = adamw.AdamWConfig(**T1_OPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt, step = train.build_trainer(cfg, opt_cfg,
                                           microbatches=T1_MICRO, seed=seed,
                                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    if {p.dtype for p in model.parameters()} != {torch.float32}:
        raise SystemExit(f"{tag}: master weights not float32")
    log(f"{tag} ({smi_line()}): published config (d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, {cfg.n_heads} heads / {cfg.n_kv} KV x "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, untied), {n:,} "
        f"parameters (cfg.param_count() {cfg.param_count():,}); float32 "
        f"master weights {4 * n / 2 ** 30:.3f} GiB, with m and v "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated; "
        f"init {init_s:.3f} s; compute {cfg.dtype}; AdamW {T1_OPT}")
    pipe = TokenPipeline(vocab=cfg.vocab, batch=T1_BATCH, seq=T1_SEQ,
                         seed=seed, device=dev)
    real_update = adamw.update
    mids = []

    def marked_update(*a, **k):
        """adamw.update with a CUDA event before it: the split."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        mids.append(ev)
        return real_update(*a, **k)

    rows = []
    for i in range(T1_WARMUP + T1_STEPS):
        batch = pipe.next()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        adamw.update = marked_update
        try:
            _, opt, m = step(model, opt, batch)
        finally:
            adamw.update = real_update
        end.record()
        loss, gn, lr = float(m["loss"]), float(m["grad_norm"]), float(m["lr"])
        rows.append((start, mids[-1], end, loss, gn, lr))
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise SystemExit(f"{tag}: step {i + 1} loss {loss} grad norm "
                             f"{gn} not finite")
        if i == 0:
            with torch.no_grad():
                after = float(make_loss_fn(cfg)(model, batch))
            log(f"{tag}: step 1 loss {loss:.6f} (grad norm {gn:.4f}, lr "
                f"{lr:.3e}); the same batch after the step {after:.6f}")
            if not after < loss:
                raise SystemExit(f"{tag}: one step did not lower the loss on "
                                 "its batch")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    timed = rows[T1_WARMUP:]
    tot = [s.elapsed_time(e) for s, _, e, *_ in timed]
    fb = [s.elapsed_time(mid) for s, mid, _, *_ in timed]
    upd = [mid.elapsed_time(e) for _, mid, e, *_ in timed]
    mean = sum(tot) / len(tot)
    tokens = T1_BATCH * T1_SEQ
    flops = 6 * n * tokens
    bound = bound_ms(ADAMW_BYTES * n, 0)[0]
    log(f"{tag} losses: " + ", ".join(f"{r[3]:.4f}" for r in rows)
        + "; grad norms: " + ", ".join(f"{r[4]:.3f}" for r in rows))
    log(f"{tag} step ({T1_BATCH} x {T1_SEQ} tokens in {T1_MICRO} "
        f"microbatches, CUDA events over {T1_STEPS} steps after "
        f"{T1_WARMUP}, {smi_line()}): {mean:.3f} ms (min {min(tot):.3f}, "
        f"max {max(tot):.3f}); forward+backward {sum(fb) / len(fb):.3f} ms, "
        f"clip+AdamW {sum(upd) / len(upd):.3f} ms (min {min(upd):.3f}); "
        f"{1e3 * tokens / mean:.1f} tokens/s; model-FLOP share "
        f"{flops / (mean * 1e-3) / BF16_FLOP_S:.4f} (6·N·D = {flops:.4e} "
        f"FLOP a step against {BF16_FLOP_S:.3e} FLOP/s bf16; recompute "
        f"adds 2·N·D = {2 * n * tokens:.4e}, 8·N·D share "
        f"{8 * n * tokens / (mean * 1e-3) / BF16_FLOP_S:.4f}); AdamW "
        f"{sum(upd) / len(upd):.3f} ms against its byte bound {bound:.3f} "
        f"ms ({ADAMW_BYTES} B a parameter at 3.35 TB/s); peak "
        f"{peak / 2 ** 30:.3f} GiB")
    phase_profile(torch, [(f"{T1_ARCH} train step, {tokens} tokens",
                           lambda: step(model, opt, batch))])
    del opt
    return model, batch


def t1_cpu_agreement(torch, seed, dev):
    """T1b: one ``make_train_step`` (2 microbatches) of the same bridged
    float32 weights, 2 layers at full width, on the card and on the CPU."""
    from repro_torch import bridge, configs
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import get_family
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    import numpy as np
    tag = f"T1 {T1_ARCH} card vs CPU"
    cfg = configs.get_config(T1_ARCH).replace(n_layers=T1_CPU_LAYERS,
                                              dtype="float32")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    d = bridge.lm_params_to_numpy(get_family(cfg).init(
        cfg, g, dev, param_dtype=torch.float32))
    opt_cfg = adamw.AdamWConfig(**T1_OPT)
    batch = TokenPipeline(vocab=cfg.vocab, batch=T1_CPU_BATCH,
                          seq=T1_CPU_SEQ, seed=seed, device="cpu").next()
    out = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        model = bridge.lm_params_from_numpy(d, cfg, where, torch.float32)
        opt = adamw.init(dict(model.named_parameters()))
        step = make_train_step(cfg, opt_cfg, n_microbatches=T1_MICRO)
        _, opt, m = step(model, opt, {k: v.to(where) for k, v in
                                      batch.items()})
        out[name] = (float(m["loss"]), float(m["grad_norm"]),
                     bridge.lm_params_to_numpy(model),
                     bridge.adamw_state_to_numpy(opt, model))
        log(f"{tag}: {name} step {time.perf_counter() - t0:.2f} s (bridge "
            f"included)")
        del model, opt
    (lg, gg, pg, sg), (lc, gc_, pc, sc) = out["card"], out["cpu"]
    lr = opt_cfg.lr
    bad_p, dp, n_ill, dp_ill = [], 0.0, 0, 0.0
    for k in pc:
        m = np.abs(sc[f"m.{k}"])
        well = m >= T1_COND * m.max()
        diff = np.abs(pg[k] - pc[k])
        reach = (2 + opt_cfg.weight_decay * np.abs(d[k])) * lr
        if (diff[well] > T1_RTOL * np.abs(pc[k][well])
                + T1_STEP_ATOL * lr).any() or (diff > reach).any():
            bad_p.append(k)
        dp = max(dp, float(diff[well].max(initial=0.0)))
        dp_ill = max(dp_ill, float(diff[~well].max(initial=0.0)))
        n_ill += int((~well).sum())
    ds = {part: max(float(np.abs(sg[k] - sc[k]).max()
                          / max(np.abs(sc[k]).max(), 1e-30))
                    for k in sc if k.startswith(part + "."))
          for part in ("m", "v")}
    log(f"{tag} ({cfg.n_layers} layers, float32, TF32 off, "
        f"{T1_CPU_BATCH} x {T1_CPU_SEQ} tokens, {T1_MICRO} microbatches): "
        f"loss {lg:.6f} vs {lc:.6f} (|diff| {abs(lg - lc):.3e}, tol "
        f"{T1_LOSS_TOL}); grad norm {gg:.6f} vs {gc_:.6f} (rel "
        f"{abs(gg - gc_) / gc_:.3e}, tol {T1_RTOL}); params max |diff| "
        f"{dp:.3e} where |m| >= {T1_COND} of its leaf's max (tol "
        f"{T1_STEP_ATOL} x lr + {T1_RTOL} rel), {dp_ill:.3e} = "
        f"{dp_ill / lr:.3f} x lr at the {n_ill:,} others (tol one step's "
        f"reach, (2 + wd|p|) x lr); m, v max "
        f"|diff| / leaf max {ds['m']:.3e}, {ds['v']:.3e} (tol "
        f"{T1_STATE_TOL}); step {int(sg['step'])} = {int(sc['step'])}")
    if not (abs(lg - lc) <= T1_LOSS_TOL and abs(gg - gc_) <= T1_RTOL * gc_
            and not bad_p and max(ds.values()) <= T1_STATE_TOL
            and int(sg["step"]) == int(sc["step"]) == 1):
        raise SystemExit(f"{tag}: the card's train step disagrees with the "
                         f"CPU's (params out of tolerance: {bad_p[:4]})")


def t1_attention_backward(torch, model, batch, seed):
    """T1c: the first layer's q, k, v of a microbatch at full width in
    bfloat16; the SDPA route's gradients against plain ``_sdpa``'s."""
    from repro_torch import configs
    from repro_torch.models import layers as L, transformer as T
    cfg = configs.get_config(T1_ARCH)
    tag = f"T1 {T1_ARCH} attention backward"
    blk = model.layers[0]
    toks = batch["tokens"][:T1_BATCH // T1_MICRO]
    with torch.no_grad():
        x = L.embed(model.embed, toks, cfg)
        q, k, v = L.qkv_project(blk.attn, L.apply_norm(blk.ln1, x, cfg), cfg,
                                None, T._rope(x, cfg))
    s = toks.shape[1]
    pos = torch.arange(s, device=q.device)
    mask = (pos[:, None] >= pos[None, :])[None, None]
    g = torch.Generator(device=q.device).manual_seed(seed + 2)
    dout = torch.randn((q.shape[0], s, cfg.n_heads * cfg.hd), generator=g,
                       device=q.device).to(q.dtype)

    def grads(route):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        route(*leaves, mask, cfg).backward(dout)
        return [t.grad for t in leaves]

    lib, plain = grads(L.sdpa_library), grads(L._sdpa)
    rel = max(float((a.float() - b.float()).abs().max())
              / float(b.float().abs().max()) for a, b in zip(lib, plain))
    ms_l = cuda_ms(torch, lambda: grads(L.sdpa_library), iters=5)
    ms_p = cuda_ms(torch, lambda: grads(L._sdpa), iters=5)
    kernels = sdpa_kernels(torch, lambda: grads(L.sdpa_library))
    ops_ = sdpa_ops(torch, lambda: grads(L.sdpa_library))
    log(f"{tag} ({tuple(q.shape)} q, {tuple(k.shape)} k/v, causal boolean "
        f"mask as causal_attention passes it): dq/dk/dv max |diff| / max "
        f"|plain| {rel:.5f} (tol {T1_SDPA_GRAD_TOL}); forward+backward "
        f"SDPA {ms_l:.4f} ms, plain {ms_p:.4f} ms; SDPA operators "
        f"(forward and backward): {ops_}; device kernels: {kernels}")
    if not rel <= T1_SDPA_GRAD_TOL:
        raise SystemExit(f"{tag}: SDPA's gradients disagree with plain "
                         "_sdpa's")


def sdpa_ops(torch, fn) -> str:
    """The attention operators one call of ``fn`` ran (profiler rows whose
    name holds "attention": the backend SDPA picked, forward and
    backward)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if "attention" in e.key.lower()})
    return ", ".join(names) or "none seen by the profiler"


def t1_driver(torch, dev):
    """T1d: ``launch.train.main`` at smoke scale on the card, then the loop
    it builds run uninterrupted and with failures at ``T1_FT_FAIL``."""
    import tempfile
    from repro_torch.launch import train
    tag = f"T1 {T1_ARCH} driver"
    with tempfile.TemporaryDirectory() as tmp:
        dev_args = ["--device", dev.type]
        t0 = time.perf_counter()
        out = train.main(T1_FT_ARGS + dev_args + ["--ckpt-dir", f"{tmp}/m"])
        log(f"{tag}: main, {len(out)} steps in "
            f"{time.perf_counter() - t0:.2f} s")
        if not out[-1]["loss"] < out[0]["loss"]:
            raise SystemExit(f"{tag}: the driver did not improve the loss")
        runs = {}
        for name, fail in (("uninterrupted", ()), ("failures", T1_FT_FAIL)):
            loop, state, _ = train.build_loop(train.parse_args(
                T1_FT_ARGS + dev_args + ["--ckpt-dir", f"{tmp}/{name}"]))
            fired = set()

            def inject(step, fail=fail, fired=fired):
                if step in fail and step not in fired:
                    fired.add(step)
                    return True
                return False

            _, flog = loop.run(state, len(out), inject=inject)
            runs[name] = (loop.restarts, flog, state["params"])
    (_, la, pa), (restarts, lb, pb) = runs["uninterrupted"], runs["failures"]
    dl = abs(la[-1]["loss"] - lb[-1]["loss"])
    with torch.no_grad():
        dp = max(float((pa[k] - pb[k]).abs().max()) for k in pa)
        same = dl == 0 and all(torch.equal(pa[k], pb[k]) for k in pa)
    log(f"{tag}: failures at steps {T1_FT_FAIL}: {restarts} restarts, "
        f"{len(lb)} steps run for {len(la)}; final loss {la[-1]['loss']:.6f} "
        f"vs {lb[-1]['loss']:.6f} (|diff| {dl:.3e}), params max |diff| "
        f"{dp:.3e} (tol {T1_FT_TOL}); bit-equal: {same}")
    if restarts != len(T1_FT_FAIL) or not (dl <= T1_FT_TOL
                                           and dp <= T1_FT_TOL):
        raise SystemExit(f"{tag}: the restarted run does not reproduce the "
                         "uninterrupted one")


# ---------------------------------------------- M1: the mesh trainer ----

M1_LAYERS = 12       # depth cut: the plain and the mesh trainer fit together
M1_STEPS = 3         # deterministic (bit-equal), then as many default steps
# the default steps' loss and grad norm, relative: cuDNN attention's
# backward accumulates in a varying order, so the first default step
# parts the trainers by 7e-5 to 1.2e-4 of the grad norm, and the later
# ones by up to 6.8e-4 once their parameters have parted (Adam's early
# steps move each weight by ~lr whatever the size of its gradient; H100
# 80GB HBM3 at 700 W). A nondeterministic spread, not a fit: the limit
# keeps ~3x over the largest reading seen
M1_TOL = 2e-3


# M1's tensor-parallel part: a (1, 4) mesh of gloo ranks on the one card
# (NCCL wants a card a rank). qwen3-moe-30b-a3b at full width cut to
# M1_MOE_LAYERS layers (its 128 experts over "model"), one train step of
# M1_MOE_BATCH; qwen2-7b at full width cut to M1_DECODE_LAYERS layers,
# M1_DECODE_STEPS decode steps of 4 slots (KV = 4 over 4 ranks: the KV-head
# route). Both in float32 compute, where only the order of the sums over
# "model" parts them from the plain steps (bfloat16 rounds each rank's
# partial sums, and a router tie then moves an assignment): the MoE's
# assignments bit-equal, loss and grad norm within M1_F32_TOL (relative),
# the decode logits within M1_F32_TOL of the largest
M1_TP_RANKS = 4
M1_MOE_LAYERS, M1_MOE_BATCH = 2, (2, 256)
M1_DECODE_LAYERS, M1_DECODE_SLOTS, M1_DECODE_LEN = 4, 4, 256
M1_DECODE_STEPS = 4
M1_F32_TOL = 1e-4
M1_TP_TIMEOUT = 600
# the sequence route: qwen2.5-3b (KV = 2 over 4 ranks) at full width cut to
# M1_DECODE_LAYERS layers, float32, decoding from M1_SEQ_START (random K / V
# in the rows before it), so that its writes cross from rank 0's rows of
# the cache to rank 1's
M1_SEQ_START = M1_DECODE_LEN // M1_TP_RANKS - M1_DECODE_STEPS // 2
# The (1, 4) trainer leaf by leaf, relative to the plain trainer's: the
# norm of each parameter's gradient in step 1 (both trainers start from
# the same weights) and of its change over the M1_STEPS steps; and the
# parameters' global norm after them. Readings (H100 80GB HBM3 at 700 W,
# bf16 compute, the default route): at most 6.4e-3 for a gradient and
# 4.1e-2 for a change, both on a `bk` bias (its sum over the tokens
# nearly cancels, and Adam moves an element by ~lr whatever the size of
# its gradient, so a flipped sign of a near-zero one shows), 7.6e-8 for
# the global norm. The limits keep ~3x over them; a gradient summed over
# "model" on too few ranks (a missing f / g) is off by tens of percent.
M1_LEAF_GRAD_TOL = 2e-2
M1_LEAF_CHANGE_TOL = 0.125
M1_PNORM_TOL = 2.5e-7
# The other families on the same (1, 4) mesh, at full width, depth cut,
# float32 compute: rwkv6-1.6b (32 heads, 8 a rank), recurrentgemma-9b
# (one group and a tail of 2; its LRU channels, 4 of its 16 heads a rank,
# K / V gathered: KV = 1) and whisper-medium (4 + 4 layers, 4 of its 16
# heads and KV heads a rank; its vocab of 51,865 whole on every rank). One
# train step each (M1_FAM_TRAIN: rwkv6's chunked WKV over 4 chunks,
# recurrentgemma's windowed attention past its window of 2,048, whisper's
# 1,500 frames and 448 tokens) against the plain step: loss and grad norm
# within M1_F32_TOL (relative), each leaf's gradient norm within
# M1_FAM_LEAF_TOL of the plain one's (relative, floored at
# M1_FAM_LEAF_FLOOR of the largest leaf's: whisper's key biases have a
# gradient that is zero but for rounding); then a prefill of 4 slots and
# M1_DECODE_STEPS decode steps from a random cache at M1_FAM_START
# (recurrentgemma's ring of 2,048 rows, 512 a rank, from 2,046: its writes
# pass from rank 3's rows to rank 0's): logits within M1_F32_TOL of their
# largest (whisper's prefill within M1_FAM_PREFILL_BF16 of it: its step
# writes the cross K/V in bfloat16, where a last-bit difference moves an
# element by 2^-8 of itself), each state leaf the steps write within
# M1_FAM_STATE_TOL of its largest element. The limits keep ~10x over the
# float32 readings of the CPU test (tests/test_torch_tensor_parallel_
# families.py: 2e-5 of a leaf, 7.4e-5 for whisper's prefill); a sum over
# "model" that is missing or doubled is off by tens of percent.
# rwkv6's gradients at full width are determined by float32 arithmetic
# only to ~1e-3 on the card: the plain step with its sequential WKV in
# place of the chunked one (the same function) moves the grad norm and
# the first layers' leaves (u, mu, mu_x, the ddlerp's LoRA) by more than
# M1_F32_TOL, at the same loss. So its grad norm and each leaf are held
# within that spread, measured and logged in the same run
# (``m1_fam_spread``), where it exceeds M1_F32_TOL / M1_FAM_LEAF_TOL
M1_FAMILIES = {"rwkv6-1.6b": dict(n_layers=4),
               "recurrentgemma-9b": dict(n_layers=5),
               "whisper-medium": dict(n_layers=4, enc_layers=4)}
M1_FAM_TRAIN = {"rwkv6-1.6b": (2, 512), "recurrentgemma-9b": (1, 4096),
                "whisper-medium": (1, 448)}
M1_FAM_FRAMES = 1500
M1_FAM_PROMPT = 256
M1_FAM_CACHE = {"rwkv6-1.6b": 256, "recurrentgemma-9b": 2048,
                "whisper-medium": 448}
M1_FAM_START = {"rwkv6-1.6b": 0, "recurrentgemma-9b": 2046,
                "whisper-medium": 64}
M1_FAM_LEAF_TOL = 1e-3
M1_FAM_LEAF_FLOOR = 1e-4
M1_FAM_STATE_TOL = 1e-4
M1_FAM_PREFILL_BF16 = 1e-3


def phase_mesh_training(torch, seed, dev="cuda"):
    """M1 (the module docstring): the mesh trainer on a one-rank NCCL
    group against the plain trainer, bit for bit; then the tensor-parallel
    checks on M1_TP_RANKS gloo ranks (``m1_tensor_parallel``)."""
    import gc
    import torch.distributed as dist
    from repro_torch.launch import train
    dev = torch.device(dev)
    had_group = dist.is_initialized()
    train.join_process_group(dev)
    try:
        m1_trainers(torch, seed, dev)
    finally:
        if not had_group:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    m1_tensor_parallel(torch, seed, dev)


def m1_trainers(torch, seed, dev):
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules
    cfg = configs.get_config(T1_ARCH).replace(n_layers=M1_LAYERS)
    tag = f"M1 {T1_ARCH} ({M1_LAYERS} layers)"
    opt_cfg = adamw.AdamWConfig(**T1_OPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_host_mesh(device=dev.type)
    t0 = time.perf_counter()
    plain, popt, pstep = train.build_trainer(
        cfg, opt_cfg, microbatches=T1_MICRO, seed=seed, device=dev)
    sharded, sopt, sstep = train.build_trainer(
        cfg, opt_cfg, microbatches=T1_MICRO, seed=seed, device=dev,
        mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    specs = rules.param_specs(sharded, mesh)
    bad = [k for k, p in sharded.named_parameters()
           if not all(isinstance(t, DTensor)
                      and tuple(t.placements) == specs[k].placements
                      for t in (p, sopt["m"][k], sopt["v"][k]))]
    n = sum(p.numel() for p in plain.parameters())
    n_sharded = sum(any(not pl.is_replicate() for pl in s.placements)
                    for s in specs.values())
    log(f"{tag} ({smi_line()}): mesh {dict(rules.mesh_axes(mesh))} on a "
        f"one-rank {torch.distributed.get_backend()} group; {n:,} "
        f"parameters in {len(specs)} tensors ({n_sharded} with a Shard "
        f"placement by the rules, e.g. layers.0.attn.wq "
        f"{specs['layers.0.attn.wq'].axes}); both trainers built in "
        f"{init_s:.3f} s, {torch.cuda.memory_allocated() / 2 ** 30:.3f} "
        f"GiB allocated; DTensors with the rules' placements: "
        f"{len(specs) - len(bad)} of {len(specs)} (params, m and v)")
    if bad:
        raise SystemExit(f"{tag}: not placed by the rules: {bad[:4]}")
    pipe = TokenPipeline(vocab=cfg.vocab, batch=T1_BATCH, seq=T1_SEQ,
                         seed=seed, device=dev)
    trainers = (("plain", plain, popt, pstep), ("mesh", sharded, sopt, sstep))
    # cuBLAS's deterministic workspace setting, which is PyTorch's default
    # workspace on sm_90 (32 MiB) and which deterministic mode requires
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        rows = m1_steps(torch, tag, pipe, trainers, "deterministic", 0)
    finally:
        torch.use_deterministic_algorithms(False)
    m1_equal(torch, tag, plain, popt, sharded, sopt,
             f"after {M1_STEPS} deterministic steps")
    m1_times(torch, tag, rows, "deterministic")
    rows = m1_steps(torch, tag, pipe, trainers, "default", M1_TOL)
    m1_times(torch, tag, rows, "default")
    peak = torch.cuda.max_memory_allocated()
    batch = pipe.next()
    calls = {name: launches_of(torch, lambda: step(model, opt, batch))
             for name, model, opt, step in trainers}
    log(f"{tag}: launch calls / device kernels a step (default): plain "
        f"{calls['plain'][0]} / {calls['plain'][1]}, mesh "
        f"{calls['mesh'][0]} / {calls['mesh'][1]}; peak "
        f"{peak / 2 ** 30:.3f} GiB (both trainers' parameters, m and v "
        f"live)")


def m1_steps(torch, tag, pipe, trainers, mode, tol):
    """M1_STEPS steps of each trainer on the same batches: tol 0 holds
    each loss and grad norm bit-equal, else within ``tol`` relative.
    -> per trainer (event ms, host ms, loss, grad norm) a step."""
    rows = {name: [] for name, *_ in trainers}
    for i in range(M1_STEPS):
        batch = pipe.next()
        out = {}
        for name, model, opt, step in trainers:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            _, _, m = step(model, opt, batch)
            host_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            torch.cuda.synchronize()
            out[name] = m
            rows[name].append((start.elapsed_time(end), host_ms,
                               float(m["loss"]), float(m["grad_norm"])))
        (_, _, lp, gp), (_, _, lm, gm) = rows["plain"][-1], rows["mesh"][-1]
        rel = max(abs(lp - lm) / abs(lp), abs(gp - gm) / gp)
        same = all(torch.equal(out["plain"][k], out["mesh"][k])
                   for k in ("loss", "grad_norm", "lr"))
        log(f"{tag} {mode} step {i + 1}: loss {lp:.6f} / {lm:.6f}, grad "
            f"norm {gp:.6f} / {gm:.6f} (plain / mesh); bit-equal: {same}; "
            f"max relative |diff| {rel:.3e} (tol "
            f"{tol if tol else 'bit-equal'})")
        if not (same if tol == 0 else rel <= tol):
            raise SystemExit(f"{tag}: {mode} step {i + 1}'s loss or grad "
                             "norm differs between the plain and mesh "
                             "trainers")
    return rows


def m1_times(torch, tag, rows, mode):
    for name, r in rows.items():
        log(f"{tag} {name} {mode} step ({T1_BATCH} x {T1_SEQ} tokens in "
            f"{T1_MICRO} microbatches, {smi_line()}): CUDA events "
            + ", ".join(f"{t[0]:.3f}" for t in r) + " ms; host (the call, "
            "no sync) " + ", ".join(f"{t[1]:.3f}" for t in r) + " ms")


def m1_equal(torch, tag, plain, popt, sharded, sopt, when):
    """Every parameter, m and v of the two trainers bit-equal (the mesh
    trainer's one rank holds the whole of each)."""
    bad = [k for k, p in plain.named_parameters()
           if not (torch.equal(p, sharded.get_parameter(k).to_local())
                   and torch.equal(popt["m"][k], sopt["m"][k].to_local())
                   and torch.equal(popt["v"][k], sopt["v"][k].to_local()))]
    log(f"{tag} {when}: parameters, m and v bit-equal in "
        f"{len(popt['m']) - len(bad)} of {len(popt['m'])} tensors; step "
        f"{int(popt['step'])} / {int(sopt['step'])}")
    if bad or int(popt["step"]) != int(sopt["step"]):
        raise SystemExit(f"{tag}: the mesh trainer's state differs from "
                         f"the plain trainer's {when}: {bad[:4]}")


def m1_cfg(arch, smoke=False, **kw):
    """``arch``'s published config (its smoke config with ``smoke``: a CPU
    rehearsal) with ``kw``."""
    from repro_torch import configs
    get = configs.get_smoke_config if smoke else configs.get_config
    return get(arch).replace(**kw)


def m1_moe_cfg(smoke=False):
    return m1_cfg("qwen3-moe-30b-a3b", smoke, n_layers=M1_MOE_LAYERS,
                  dtype="float32")


def m1_decode_cfg(smoke=False):
    return m1_cfg("qwen2-7b", smoke, n_layers=M1_DECODE_LAYERS,
                  dtype="float32")


def m1_decodes(smoke=False):
    """M1's tensor-parallel decode checks: (name, config, start)."""
    return (("decode", m1_decode_cfg(smoke), 0),
            ("seq_decode", m1_cfg(T1_ARCH, smoke, n_layers=M1_DECODE_LAYERS,
                                  dtype="float32"), M1_SEQ_START))


def m1_moe_batch(torch, cfg, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    t = torch.randint(0, cfg.vocab, M1_MOE_BATCH, generator=g, device=dev)
    return {"tokens": t, "labels": t}


def m1_recording_dispatch(calls):
    """``moe.dispatch`` keeping every call's (slots, keep) on the host."""
    from repro_torch.models import moe
    dispatch = moe.dispatch

    def run(topi, n_experts, c):
        flat, keep = dispatch(topi, n_experts, c)
        calls.append((flat.cpu(), keep.cpu()))
        return flat, keep
    return run


def m1_moe_step(torch, cfg, seed, dev, mesh=None):
    """One train step of the MoE cut (``mesh``: sharded): -> (loss, grad
    norm, dispatch calls)."""
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    model, opt, step = train.build_trainer(
        cfg, adamw.AdamWConfig(**T1_OPT), seed=seed, device=dev, mesh=mesh)
    calls = []
    original, moe.dispatch = moe.dispatch, m1_recording_dispatch(calls)
    try:
        _, _, m = step(model, opt, m1_moe_batch(torch, cfg, seed, dev))
    finally:
        moe.dispatch = original
    return float(m["loss"]), float(m["grad_norm"]), calls


def m1_decode_logits(torch, cfg, seed, dev, mesh=None, start=0):
    """M1_DECODE_STEPS decode steps of ``cfg`` from position ``start``
    (the cache's rows before it random; ``mesh``: weights and cache placed
    by the rules) -> (logits (steps, B, V) on the host, the calls of the
    sequence route's combine, ``layers._split_attend``)."""
    from repro_torch.models import get_family, layers
    from repro_torch.serve.step import make_decode_step
    from repro_torch.sharding import rules
    fam = get_family(cfg)
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    model = fam.init(cfg, g, dev, param_dtype=torch.float32)
    cache = fam.init_cache(cfg, M1_DECODE_SLOTS, M1_DECODE_LEN,
                           dtype=torch.float32, device=dev)
    for k in ("k", "v"):
        rows = cache[k][:, :, :start]
        rows.copy_(torch.randn(rows.shape, generator=g, device=dev))
    cache["pos"].fill_(start)
    toks = torch.randint(0, cfg.vocab, (M1_DECODE_STEPS, M1_DECODE_SLOTS),
                         generator=g, device=dev)
    if mesh is not None:
        for name, spec in rules.param_specs(model, mesh).items():
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            mod.register_parameter(leaf, torch.nn.Parameter(rules.place(
                mod._parameters[leaf].detach(), mesh, spec.placements)))
        cspecs = rules.cache_specs(cache, mesh)
        cache = {k: rules.place(v, mesh, cspecs[k].placements)
                 for k, v in cache.items()}
    step = make_decode_step(cfg, mesh=mesh)
    out, combines = [], [0]
    split_attend = layers._split_attend

    def counted(*a):
        combines[0] += 1
        return split_attend(*a)
    layers._split_attend = counted
    try:
        for t in toks:
            logits, cache = step(model, cache, t)
            out.append(logits.cpu())
    finally:
        layers._split_attend = split_attend
    return torch.stack(out), combines[0]


def m1_leaf_steps(torch, cfg, seed, dev, mesh=None):
    """M1_STEPS default steps of ``cfg``'s trainer (``mesh``: sharded by
    the rules) on the T1 batches -> (model, opt, step, rows: (event ms,
    host ms, loss, grad norm) a step, leaves: the norms of each
    parameter's step-1 gradient (``"grad"``) and of its change over the
    steps (``"change"``)). Step 1 also keeps a copy of its gradients (the
    ``grad_transform`` hook) and the steps a copy of the parameters."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    cuda = dev.type == "cuda"
    opt_cfg = adamw.AdamWConfig(**T1_OPT)
    model, opt, _ = train.build_trainer(
        cfg, opt_cfg, microbatches=T1_MICRO, seed=seed, device=dev,
        mesh=mesh)
    kept = {}

    def keep(grads):
        if not kept:
            kept.update({k: g.detach().clone() for k, g in grads.items()})
        return grads
    step = train.make_train_step(cfg, opt_cfg, n_microbatches=T1_MICRO,
                                 grad_transform=keep, mesh=mesh)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=T1_BATCH, seq=T1_SEQ,
                         seed=seed, device=dev)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    rows = []
    for _ in range(M1_STEPS):
        batch = pipe.next()
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        _, _, m = step(model, opt, batch)
        host_ms = (time.perf_counter() - t0) * 1e3
        if cuda:
            end.record()
            torch.cuda.synchronize()
        rows.append((start.elapsed_time(end) if cuda else host_ms, host_ms,
                     float(m["loss"]), float(m["grad_norm"])))

    def norm(t):
        return float(adamw.global_norm({"leaf": t}))
    leaves = {"grad": {k: norm(g) for k, g in kept.items()},
              "change": {k: norm(p.detach() - before.pop(k))
                         for k, p in model.named_parameters()}}
    kept.clear()
    return model, opt, (step, pipe), rows, leaves


def m1_leaf_gaps(want: dict, got: dict) -> dict:
    """Per kind ("grad", "change"): the three largest relative gaps of a
    leaf's norm from the plain trainer's, as (gap, leaf), largest first."""
    out = {}
    for kind, ref in want.items():
        gaps = [(abs(got[kind][k] - v) / v if v else
                 float(got[kind][k] != 0), k) for k, v in ref.items()]
        out[kind] = sorted(gaps, reverse=True)[:3]
    return out


def m1_fam_cfg(arch, smoke=False):
    return m1_cfg(arch, smoke, dtype="float32", **M1_FAMILIES[arch])


def m1_fam_shapes(cfg, smoke=False) -> dict:
    """The family checks' shapes: ``train`` (batch, tokens), ``frames``
    (whisper's encoder length), ``prompt`` (the prefill's tokens),
    ``cache`` (its max length) and ``start`` (the first decode position).
    ``smoke``: the CPU rehearsal's, cut to the smoke configs (rglru's
    window of 16 from 14)."""
    arch = cfg.name
    if smoke:
        win = cfg.window or 16
        train = {"rglru": (1, 3 * win), "rwkv6": (1, cfg.rwkv_chunk + 8)}
        return dict(train=train.get(cfg.family, (2, 16)),
                    frames=24, prompt=8, cache=win,
                    start=win - 2 if cfg.family == "rglru" else 3)
    return dict(train=M1_FAM_TRAIN[arch], frames=M1_FAM_FRAMES,
                prompt=M1_FAM_PROMPT, cache=M1_FAM_CACHE[arch],
                start=M1_FAM_START[arch])


def m1_fam_batch(torch, cfg, shp, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    t = torch.randint(0, cfg.vocab, shp["train"], generator=g, device=dev)
    batch = {"tokens": t, "labels": t}
    if cfg.input_mode == "encdec":
        batch["frames"] = torch.randn(shp["train"][0], shp["frames"],
                                      cfg.d_model, generator=g, device=dev)
    return batch


def m1_event_ms(torch, fn, cuda):
    """(``fn()``, its ms: CUDA events on the card, the host clock on the
    CPU)."""
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    out = fn()
    if not cuda:
        return out, (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def m1_fam_train(torch, cfg, shp, seed, dev, mesh=None):
    """Two train steps of ``cfg`` (``mesh``: sharded by the rules) on one
    batch. Step 1 under ``CollectiveCounter``, keeping each leaf's
    gradient norm (the ``grad_transform`` hook: ``adamw.global_norm`` of a
    one-leaf dict, an all-reduce on a DTensor); step 2 timed. -> dict of
    step 1's loss, grad norm, leaf norms and collectives, step 2's ms."""
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.utils.comms import CollectiveCounter
    opt_cfg = adamw.AdamWConfig(**T1_OPT)
    model, opt, _ = train.build_trainer(cfg, opt_cfg, seed=seed, device=dev,
                                        mesh=mesh)
    leaves = {}

    def keep(grads):
        if not leaves:
            leaves.update({k: float(adamw.global_norm({"leaf": g}))
                           for k, g in grads.items()})
        return grads
    step = train.make_train_step(cfg, opt_cfg, grad_transform=keep,
                                 mesh=mesh)
    batch = m1_fam_batch(torch, cfg, shp, seed, dev)
    with CollectiveCounter() as cc:
        _, _, m = step(model, opt, batch)
    out = {"loss": float(m["loss"]), "gn": float(m["grad_norm"]),
           "leaves": dict(leaves), "collectives": cc.collective_bytes(),
           "by_group": cc.by_group(),
           "gathers": sorted({(r["group"], r["line"]) for r in cc.records
                              if r["op"] == "all-gather"})}
    _, out["ms"] = m1_event_ms(torch, lambda: step(model, opt, batch),
                               dev.type == "cuda")
    return out


def m1_fam_spread(torch, cfg, shp, seed, dev, tr) -> dict:
    """The plain step's own float32 spread, where the family has a second
    algorithm for the same function: rwkv6's step with the sequential WKV
    in place of the chunked one, against ``tr`` (the chunked step): the
    relative gaps of its grad norm (``"gn"``) and of each leaf's gradient
    norm (``"leaves"``, floored as the checks floor them). Zero gaps for
    the other families."""
    if cfg.family != "rwkv6" or shp["train"][1] <= cfg.rwkv_chunk:
        return {"gn": 0.0, "leaves": {k: 0.0 for k in tr["leaves"]}}
    seq = m1_fam_train(torch, cfg.replace(rwkv_chunk=shp["train"][1]), shp,
                       seed, dev)
    return {"gn": abs(seq["gn"] - tr["gn"]) / tr["gn"],
            "leaves": m1_leaf_rel(tr["leaves"], seq["leaves"])}


def m1_leaf_rel(want: dict, got: dict) -> dict:
    """Each leaf's relative gap of its gradient norm, floored at
    M1_FAM_LEAF_FLOOR of the largest leaf's."""
    top = max(want.values())
    return {k: abs(got[k] - v) / max(v, M1_FAM_LEAF_FLOOR * top)
            for k, v in want.items()}


def m1_fam_serve(torch, cfg, shp, seed, dev, mesh=None):
    """A prefill of 4 slots and M1_DECODE_STEPS decode steps from a random
    cache at ``shp["start"]`` (``mesh``: weights, batch and cache placed
    by the rules) -> (prefill logits, the steps' logits (steps, B, V), on
    the host; the cache leaves the steps write, each the rank's block;
    the sequence route's combines; the steps' ms)."""
    from repro_torch.models import get_family, layers
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    from repro_torch.sharding import rules
    fam = get_family(cfg)
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    model = fam.init(cfg, g, dev, param_dtype=torch.float32)
    slots = M1_DECODE_SLOTS
    kw = {}
    if cfg.input_mode == "encdec":
        batch = {"frames": torch.randn(slots, shp["frames"], cfg.d_model,
                                       generator=g, device=dev)}
        kw["enc_len"] = shp["frames"]
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab,
                                         (slots, shp["prompt"]),
                                         generator=g, device=dev)}
    cache = fam.init_cache(cfg, slots, shp["cache"], dtype=torch.float32,
                           device=dev, **kw)
    flat = m1_flat(cache)
    for v in flat.values():
        if v.is_floating_point():
            v.copy_(torch.randn(v.shape, generator=g, device=dev))
    flat["pos"].fill_(shp["start"])
    toks = torch.randint(0, cfg.vocab, (M1_DECODE_STEPS, slots),
                         generator=g, device=dev)
    if mesh is not None:
        for name, spec in rules.param_specs(model, mesh).items():
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            mod.register_parameter(leaf, torch.nn.Parameter(rules.place(
                mod._parameters[leaf].detach(), mesh, spec.placements)))
        cspecs = rules.cache_specs(flat, mesh)
        flat = {k: rules.place(v, mesh, cspecs[k].placements)
                for k, v in flat.items()}
    cache = m1_nest(flat)
    prefill = make_prefill_step(cfg, mesh=mesh)(model, batch).cpu()
    step = make_decode_step(cfg, mesh=mesh)
    combines = [0]
    split_attend = layers._split_attend

    def counted(*a):
        combines[0] += 1
        return split_attend(*a)
    layers._split_attend = counted
    out = []
    try:
        def steps():
            c = cache
            for t in toks:
                logits, c = step(model, c, t)
                out.append(logits)
            return c
        cache, ms = m1_event_ms(torch, steps, dev.type == "cuda")
    finally:
        layers._split_attend = split_attend
    written = {k: (v.to_local() if hasattr(v, "to_local") else v)
               for k, v in m1_flat(cache).items()
               if k not in ("pos", "xk", "xv")}
    return prefill, torch.stack(out).cpu(), written, combines[0], ms


def m1_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(m1_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def m1_nest(flat):
    out = {}
    for k, v in flat.items():
        *head, leaf = k.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[leaf] = v
    return out


def m1_fam_rank(torch, mesh, spec, dev, smoke, free, peak):
    """A rank's family checks: each family's sharded train step, prefill
    and decode steps, held here against the plain ones the parent saved
    (the state leaves block by block: no leaf is gathered). -> record."""
    from repro_torch.sharding import rules
    out = {}
    for arch in M1_FAMILIES:
        cfg = m1_fam_cfg(arch, smoke)
        shp = m1_fam_shapes(cfg, smoke)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        rec = m1_fam_train(torch, cfg, shp, spec["seed"], dev, mesh)
        rec["gathers"] = [list(x) for x in rec["gathers"]]
        rec["peak_train_gib"] = peak()
        free()
        prefill, logits, written, combines, ms = m1_fam_serve(
            torch, cfg, shp, spec["seed"], dev, mesh)
        want = torch.load(spec[f"fam.{arch}"])
        rec["prefill_err"] = float((prefill - want["prefill"]).abs().max())
        rec["decode_err"] = float((logits - want["logits"]).abs().max())
        rec["combines"], rec["decode_ms"] = combines, ms
        state = {}
        for k, v in written.items():
            full = want["state"][k]
            mine = rules.local_chunk(full, mesh, rules.cache_specs(
                {k: full}, mesh)[k].placements)
            state[k] = [float((v.cpu() - mine).abs().max()),
                        float(full.abs().max()), list(v.shape)]
        rec["state"] = state
        rec["peak_gib"] = peak()
        out[arch] = rec
        free()
    return out


def m1_tp_rank(rank, spec):
    """One rank of M1's tensor-parallel checks (spawned by
    ``distributed.run_ranks``, gloo): the (1, M1_TP_RANKS) mesh trainer of
    qwen2.5-3b (M1_LAYERS) for M1_STEPS steps (CUDA events, host ms, loss,
    grad norm, the per-leaf norms of ``m1_leaf_steps``), one more step
    under ``CollectiveCounter``, the parameters' global norm and the peak;
    the MoE step; the decode steps on the KV-head and the sequence routes.
    Writes its record to ``spec["out"]``."""
    import gc
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.optim import adamw
    from repro_torch.utils.comms import CollectiveCounter
    dev, seed, smoke = torch.device(spec["dev"]), spec["seed"], spec["smoke"]
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    else:
        torch.set_num_threads(1)
    # gloo on both axes: a mesh axis that spans the world would otherwise
    # get a group of the card's default backend (NCCL), a card a rank
    mesh = init_device_mesh(dev.type, (1, M1_TP_RANKS),
                            mesh_dim_names=("data", "model"),
                            backend_override={"data": "gloo",
                                              "model": "gloo"})
    cuda = dev.type == "cuda"

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def peak():
        return torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0

    rec = {"rank": rank, "model_group": mesh.get_group("model").group_name}
    cfg = m1_cfg(T1_ARCH, smoke, n_layers=M1_LAYERS)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model, opt, (step, pipe), rec["rows"], rec["leaves"] = m1_leaf_steps(
        torch, cfg, seed, dev, mesh)
    rec["param_norm"] = float(adamw.global_norm(
        dict(model.named_parameters())))
    with CollectiveCounter() as cc:
        step(model, opt, pipe.next())
    rec["collectives"] = cc.collective_bytes()
    rec["by_group"] = cc.by_group()
    rec["model_gathers"] = sorted({r["line"] for r in cc.records
                                   if r["op"] == "all-gather"
                                   and r["group"] == rec["model_group"]})
    rec["peak_gib"] = peak()
    del model, opt, step
    free()
    loss, gn, calls = m1_moe_step(torch, m1_moe_cfg(smoke), seed, dev, mesh)
    rec["moe"] = [loss, gn]
    want = torch.load(spec["moe_calls"])
    rec["moe_calls_equal"] = len(calls) == len(want) and all(
        torch.equal(a, c) and torch.equal(b, d)
        for (a, b), (c, d) in zip(calls, want))
    free()
    for name, dcfg, start in m1_decodes(smoke):
        logits, rec[f"{name}_combines"] = m1_decode_logits(
            torch, dcfg, seed, dev, mesh, start)
        want = torch.load(spec[name])
        rec[f"{name}_err"] = float((logits - want).abs().max())
        rec[f"{name}_scale"] = float(want.abs().max())
        free()
    rec["peak_all_gib"] = peak()
    rec["families"] = m1_fam_rank(torch, mesh, spec, dev, smoke, free, peak)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)


def m1_tensor_parallel(torch, seed, dev, smoke=False):
    """M1's tensor-parallel part: the plain runs first, here (each freed
    before the next), then M1_TP_RANKS gloo ranks on the card
    (``m1_tp_rank``) and the checks: each step's loss and grad norm
    within M1_TOL of the plain trainer's on the same batches (the
    default route, as the one-rank part's default steps); each leaf's
    step-1 gradient norm within M1_LEAF_GRAD_TOL and the norm of its
    change over the steps within M1_LEAF_CHANGE_TOL, the parameters'
    global norm after them within M1_PNORM_TOL; no all-gather over "model"
    but an activation's; the MoE step and both decodes' logits within
    M1_F32_TOL, the MoE's assignments bit-equal, each decode on its route
    (the sequence route's combine called once a layer a step, the KV-head
    route's never). ``smoke``: the smoke configs (a CPU rehearsal)."""
    import gc
    import tempfile
    from repro_torch.core import distributed as D
    from repro_torch.optim import adamw
    tag = f"M1 TP ({M1_TP_RANKS} gloo ranks, a (1, {M1_TP_RANKS}) mesh)"
    cfg = m1_cfg(T1_ARCH, smoke, n_layers=M1_LAYERS)
    cuda = dev.type == "cuda"

    def free():
        gc.collect()
        torch.cuda.empty_cache()
    model, _, _, rows, leaves = m1_leaf_steps(torch, cfg, seed, dev)
    plain = [r[2:] for r in rows]
    pnorm = float(adamw.global_norm(dict(model.named_parameters())))
    del model
    free()
    moe_plain = m1_moe_step(torch, m1_moe_cfg(smoke), seed, dev)
    free()
    decodes = {}
    for name, dcfg, start in m1_decodes(smoke):
        decodes[name] = m1_decode_logits(torch, dcfg, seed, dev, None,
                                         start)[0]
        free()
    fams = {}
    for arch in M1_FAMILIES:
        fcfg = m1_fam_cfg(arch, smoke)
        shp = m1_fam_shapes(fcfg, smoke)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        tr = m1_fam_train(torch, fcfg, shp, seed, dev)
        tr["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                          if cuda else 0.0)
        free()
        tr["spread"] = m1_fam_spread(torch, fcfg, shp, seed, dev, tr)
        free()
        prefill, logits, written, _, ms = m1_fam_serve(torch, fcfg, shp,
                                                       seed, dev)
        fams[arch] = (tr, {"prefill": prefill, "logits": logits,
                           "state": {k: v.cpu() for k, v in
                                     written.items()}}, ms)
        del written
        free()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        spec = dict(seed=seed, out=out, dev=str(dev), smoke=smoke,
                    moe_calls=os.path.join(out, "moe_calls.pt"))
        torch.save(moe_plain[2], spec["moe_calls"])
        for name, logits in decodes.items():
            spec[name] = os.path.join(out, f"{name}.pt")
            torch.save(logits, spec[name])
        for arch, (_, served, _) in fams.items():
            spec[f"fam.{arch}"] = os.path.join(out, f"fam_{arch}.pt")
            torch.save(served, spec[f"fam.{arch}"])
        t0 = time.perf_counter()
        D.run_ranks(m1_tp_rank, M1_TP_RANKS, args=(spec,), backend="gloo",
                    timeout=M1_TP_TIMEOUT)
        secs = time.perf_counter() - t0
        recs = [json.loads((Path(out) / f"rank{r}.json").read_text())
                for r in range(M1_TP_RANKS)]
    log(f"{tag} ({smi_line()}; the ranks share the card, so no time here "
        f"is a scaling figure): {T1_ARCH} at {M1_LAYERS} layers, "
        f"{M1_STEPS} steps of {T1_BATCH} x {T1_SEQ} tokens in {T1_MICRO} "
        f"microbatches (step 1 also copies its gradients, each step the "
        f"parameters: the per-leaf checks); the ranks ran {secs:.1f} s")
    bad = []
    for r in recs:
        steps = []
        for i, ((ev, host, loss, gn), (lp, gp)) in enumerate(
                zip(r["rows"], plain)):
            rel = max(abs(loss - lp) / abs(lp), abs(gn - gp) / gp)
            steps.append(f"step {i + 1}: {ev:.3f} ms (events), {host:.3f} "
                         f"ms host, loss {loss:.6f} / {lp:.6f}, grad norm "
                         f"{gn:.6f} / {gp:.6f} (mesh / plain), max relative "
                         f"|diff| {rel:.3e}")
            if rel > M1_TOL:
                bad.append(f"rank {r['rank']} step {i + 1}: {rel:.3e}")
        prel = abs(r["param_norm"] - pnorm) / pnorm
        if prel > M1_PNORM_TOL:
            bad.append(f"rank {r['rank']} parameter norm: {prel:.3e}")
        gaps = m1_leaf_gaps(leaves, r["leaves"])
        for kind, tol in (("grad", M1_LEAF_GRAD_TOL),
                          ("change", M1_LEAF_CHANGE_TOL)):
            if gaps[kind][0][0] > tol:
                bad.append(f"rank {r['rank']} {kind} of {gaps[kind][0][1]}: "
                           f"{gaps[kind][0][0]:.3e}")
        worst = {kind: ", ".join(f"{g:.3e} ({k})" for g, k in top)
                 for kind, top in gaps.items()}
        model_coll = r["by_group"].get(r["model_group"], {})
        log(f"  rank {r['rank']}: " + "; ".join(steps)
            + f"; parameters' global norm {r['param_norm']:.6f} / "
            f"{pnorm:.6f} ({prel:.3e}, tol {M1_PNORM_TOL}); over "
            f"{len(leaves['grad'])} leaves the largest relative gaps of a "
            f"step-1 gradient norm {worst['grad']} (tol "
            f"{M1_LEAF_GRAD_TOL}), of a change's norm over the steps "
            f"{worst['change']} (tol {M1_LEAF_CHANGE_TOL}); a step's "
            f"collectives {json.dumps(r['collectives'])}, over 'model' "
            f"{json.dumps(model_coll)}; all-gathers over 'model' from "
            f"{r['model_gathers']}; peak {r['peak_gib']:.3f} GiB (the "
            f"trainer), {r['peak_all_gib']:.3f} GiB (with the MoE and "
            "decode checks)")
        if any("_all_gather(y, x.contiguous()" not in line
               for line in r["model_gathers"]):
            bad.append(f"rank {r['rank']}: a parameter gathered over "
                       f"'model': {r['model_gathers']}")
    mcfg = m1_moe_cfg(smoke)
    r0 = recs[0]
    lm, gm = r0["moe"]
    lp, gp = moe_plain[:2]
    mrel = max(abs(lm - lp) / abs(lp), abs(gm - gp) / gp)
    drops = sum(int((~k).sum()) for _, k in moe_plain[2])
    log(f"{tag} qwen3-moe-30b-a3b at {M1_MOE_LAYERS} layers (full width, "
        f"{mcfg.n_experts} experts, {mcfg.n_experts // M1_TP_RANKS} a rank; "
        f"float32 compute), one train step of {M1_MOE_BATCH}: loss "
        f"{lm:.7f} / {lp:.7f}, grad norm {gm:.7f} / {gp:.7f} (mesh / "
        f"plain), max relative |diff| {mrel:.3e} (tol {M1_F32_TOL}); "
        f"assignments and drops ({drops} dropped of "
        f"{sum(k.numel() for _, k in moe_plain[2])}) bit-equal on every "
        f"rank: {all(r['moe_calls_equal'] for r in recs)}")
    if mrel > M1_F32_TOL or not all(r["moe_calls_equal"] for r in recs):
        bad.append(f"moe: {mrel:.3e}, assignments equal "
                   f"{[r['moe_calls_equal'] for r in recs]}")
    for name, dcfg, start in m1_decodes(smoke):
        derr = max(r[f"{name}_err"] for r in recs)
        dscale = r0[f"{name}_scale"]
        seq = dcfg.n_kv % M1_TP_RANKS != 0
        want = M1_DECODE_LAYERS * M1_DECODE_STEPS if seq else 0
        combines = [r[f"{name}_combines"] for r in recs]
        log(f"{tag} {dcfg.name} at {M1_DECODE_LAYERS} layers (full width, "
            f"KV {dcfg.n_kv} over {M1_TP_RANKS}: "
            f"{'the sequence' if seq else 'the KV-head'} route; float32), "
            f"{M1_DECODE_STEPS} decode steps of {M1_DECODE_SLOTS} slots "
            f"from position {start} of {M1_DECODE_LEN} "
            f"({M1_DECODE_LEN // M1_TP_RANKS} rows a rank): max |diff| of "
            f"the logits {derr:.3e} against the plain steps' (largest "
            f"{dscale:.3f}; tol {M1_F32_TOL} of it); "
            f"the sequence route's combines a rank {combines} (want {want})")
        if derr > M1_F32_TOL * dscale or any(c != want for c in combines):
            bad.append(f"{name}: {derr:.3e}, combines {combines}")
    bad += m1_fam_checks(tag, fams, recs, smoke)
    if bad:
        raise SystemExit(f"{tag}: the sharded steps part from the plain "
                         f"ones: {bad}")


def m1_fam_checks(tag, fams, recs, smoke) -> list:
    """Log each family's sharded step, prefill and decode against the
    plain ones (``fams``: arch -> (train record, served, decode ms)) and
    return what is off."""
    bad = []
    for arch, (tr, served, plain_ms) in fams.items():
        cfg = m1_fam_cfg(arch, smoke)
        shp = m1_fam_shapes(cfg, smoke)
        lscale = float(served["logits"].abs().max())
        pscale = float(served["prefill"].abs().max())
        ptol = M1_FAM_PREFILL_BF16 if cfg.family == "whisper" \
            else M1_F32_TOL
        spread = tr["spread"]
        gn_tol = max(M1_F32_TOL, spread["gn"])
        seq = cfg.family == "rglru"
        want_combines = (cfg.n_layers // 3) * M1_DECODE_STEPS if seq else 0
        log(f"{tag} {arch} at {m1_depth(cfg)} (full width, float32; "
            f"{smi_line()}): plain step {tr['ms']:.3f} ms (events; step 2 "
            f"of {shp['train'][0]} x {shp['train'][1]} tokens"
            + (f", {shp['frames']} frames" if cfg.family == "whisper"
               else "") + f"), peak {tr['peak_gib']:.3f} GiB; plain "
            f"{M1_DECODE_STEPS} decode steps of {M1_DECODE_SLOTS} slots "
            f"from position {shp['start']} {plain_ms:.3f} ms"
            + (f"; the plain step's own spread (sequential WKV against the "
               f"chunked one): grad norm {spread['gn']:.3e}, largest leaf "
               f"{max(spread['leaves'].values()):.3e}"
               if spread["gn"] else ""))
        for r in recs:
            f = r["families"][arch]
            lrel = abs(f["loss"] - tr["loss"]) / abs(tr["loss"])
            grel = abs(f["gn"] - tr["gn"]) / tr["gn"]
            rel = m1_leaf_rel(tr["leaves"], f["leaves"])
            gaps = sorted(((g, k) for k, g in rel.items()), reverse=True)
            over = [(g, k) for g, k in gaps
                    if g > max(M1_FAM_LEAF_TOL, spread["leaves"][k])]
            perr, derr = f["prefill_err"] / pscale, f["decode_err"] / lscale
            serr = max(((e / s if s else e), k)
                       for k, (e, s, _) in f["state"].items())
            model_coll = f["by_group"].get(r["model_group"], {})
            model_gathers = sorted({line for grp, line in f["gathers"]
                                    if grp == r["model_group"]})
            log(f"  rank {r['rank']}: step 1 loss {f['loss']:.7f} / "
                f"{tr['loss']:.7f} ({lrel:.3e}, tol {M1_F32_TOL}), grad "
                f"norm {f['gn']:.7f} / {tr['gn']:.7f} ({grel:.3e}, tol "
                f"{gn_tol:.3e}) (mesh / plain); over {len(gaps)} leaves the "
                f"largest relative gaps of a gradient norm "
                + ", ".join(f"{g:.3e} ({k}; spread "
                            f"{spread['leaves'][k]:.3e})" for g, k in gaps[:3])
                + f" (tol {M1_FAM_LEAF_TOL} or the leaf's spread); step 2 "
                f"{f['ms']:.3f} ms "
                f"(events); a step's collectives "
                f"{json.dumps(f['collectives'])}, over 'model' "
                f"{json.dumps(model_coll)}; all-gathers over 'model' from "
                f"{model_gathers}; peak {f['peak_train_gib']:.3f} GiB "
                f"(training), {f['peak_gib']:.3f} GiB (with the serve "
                f"checks); prefill logits {perr:.3e} of their largest "
                f"{pscale:.3f} (tol {ptol}); decode logits {derr:.3e} of "
                f"{lscale:.3f} (tol {M1_F32_TOL}), {f['decode_ms']:.3f} ms "
                f"for the {M1_DECODE_STEPS} steps; the state's largest gap "
                f"{serr[0]:.3e} of its largest element ({serr[1]}; tol "
                f"{M1_FAM_STATE_TOL}; the rank's blocks "
                + ", ".join(f"{k} {tuple(v[2])}"
                            for k, v in f["state"].items())
                + f"); the sequence route's combines {f['combines']} "
                f"(want {want_combines})")
            if lrel > M1_F32_TOL or grel > gn_tol or over:
                bad.append(f"{arch} rank {r['rank']} step: loss {lrel:.3e}, "
                           f"grad norm {grel:.3e}, leaves {over[:3]}")
            if perr > ptol or derr > M1_F32_TOL \
                    or serr[0] > M1_FAM_STATE_TOL \
                    or f["combines"] != want_combines:
                bad.append(f"{arch} rank {r['rank']} serve: prefill "
                           f"{perr:.3e}, decode {derr:.3e}, state {serr}, "
                           f"combines {f['combines']}")
            if any("_all_gather(y, x.contiguous()" not in line
                   for line in model_gathers):
                bad.append(f"{arch} rank {r['rank']}: a parameter gathered "
                           f"over 'model': {model_gathers}")
    return bad


def m1_depth(cfg) -> str:
    if cfg.family == "whisper":
        return f"{cfg.enc_layers} + {cfg.n_layers} layers"
    return f"{cfg.n_layers} layers"


def _run_all(cmds: dict, timeout: float) -> dict:
    """Run each command of ``cmds`` (name -> argv) as a subprocess, all at
    once, with ``src`` on the path; -> name -> (exit code, output,
    seconds). Kills whatever is left after ``timeout`` seconds."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for k, c in cmds.items()}
    out = {}
    try:
        for k, p in procs.items():
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                text = p.communicate(timeout=left)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                text = p.communicate()[0] + f"\n(killed after {timeout} s)"
            out[k] = (p.returncode, text, time.perf_counter() - t0)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return out


def _tail(text: str, n: int = 30) -> str:
    return "\n".join(text.strip().splitlines()[-n:])


def ce_held(argv) -> int:
    """R1's CE: ``launch.dryrun_ce.main(argv)`` with every
    ``query_lanes`` and ``central_qualify`` call of its first
    ``estimate_sharded`` (the warm-up, before the timed and the counted
    runs) held against its plain version, and its slab loop against the
    host loop, on the same inputs, at the CE's own shapes (``hold_*``).
    Fatal: a difference, or a kernel the warm-up never called. Run as
    ``python -c "import chip_smoke ..."``."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun_ce
    held = dict.fromkeys(PATH_KERNELS, 0)
    ties = dict.fromkeys(PATH_KERNELS, 0)
    err = dict.fromkeys(PATH_KERNELS, 0.0)
    calls = [0]

    def hold(name, a, got):
        if name == "query_lanes":
            pcodes, near = hold_query_lanes(torch, "CE", a, got)
            t, e = int(near.sum()), float((got[0] - pcodes).abs().max())
        else:
            plain, tl = hold_central(torch, "CE", a, got)
            t, e = int(tl.sum()), float((got[0] - plain[0]).abs().max())
        held[name] += 1
        ties[name] += t
        err[name] = max(err[name], e)

    def wrap(name, kernel):
        def run(*a):
            got = kernel(*a)
            if calls[0] == 1:
                hold(name, a, got)
            return got
        return run

    for name in ("query_lanes", "central_qualify"):
        setattr(ops, name, wrap(name, getattr(ops, name)))
    estimate = D.estimate_sharded

    def counted(*a, **kw):
        calls[0] += 1
        return estimate(*a, **kw)

    D.estimate_sharded = counted
    with holding_loop(torch, "CE", lambda: calls[0] == 1) as loops:
        dryrun_ce.main(argv)
    held["slab_loop"] = loops[0]
    log("R1 CE held in its warm-up estimate: "
        + ", ".join(f"{k} {held[k]} calls (max |diff| {err[k]}, {ties[k]} "
                    + ("hash values within MARGIN of an integer"
                       if k == "query_lanes" else "d^2 within MARGIN tau^2 "
                       "of tau^2") + ")" for k in ("query_lanes",
                                                   "central_qualify"))
        + f" against the plain versions; slab_loop {held['slab_loop']} "
        f"calls bit-equal to the host loop; MARGIN = {MARGIN}")
    if min(held.values()) == 0:
        raise AssertionError(f"R1 CE: a kernel was never held: {held}")
    return 0


def phase_dryrun(examples: bool = True):
    """R1: ``launch.dryrun`` of the ``R1_CELLS`` (each in its own process,
    the three at once: a fresh fake process group each, apart from M1's
    NCCL group), then ``launch.dryrun_ce`` at 4,096,000 points a rank on
    the card. Fatal: a process failed, a record is missing, or a roofline
    term of a cell is zero (every cell here computes, moves bytes and
    gathers); the CE's estimates not finite, a slab step never run, a
    path kernel never launched, or a kernel call of its warm-up estimate
    apart from its plain version (``ce_held``). Logs trace seconds,
    traced peak a rank, collective bytes, attention routes, and the CE's
    wall time and device peak. With ``examples``, X1 runs beside the three traces: the five
    ``examples/torch_*.py`` on the card at their JAX twins' sizes (their
    defaults), each in its own process; fatal: an exit code (each asserts
    what its twin prints)."""
    out = ROOT / "build" / "dryrun"
    cmds = {f"R1 {a} {s} {m}": [sys.executable, "-m",
                                "repro_torch.launch.dryrun", "--arch", a,
                                "--shape", s, "--mesh", m, "--out-dir",
                                str(out)]
            for a, s, m in R1_CELLS}
    if examples:
        cmds.update({f"X1 {n}": [sys.executable,
                                 str(ROOT / "examples" / f"{n}.py")]
                     for n in X1_EXAMPLES})
    runs = _run_all(cmds, R1_TIMEOUT)
    runs.update(_run_all({"R1 ce": [
        sys.executable, "-c",
        "import sys, chip_smoke; sys.exit(chip_smoke.ce_held(sys.argv[1:]))",
        "--n-per-shard", str(R1_CE_POINTS), "--out-dir", str(out)]},
        R1_TIMEOUT))
    for k, (rc, text, secs) in runs.items():
        log(f"{k}: exit {rc} after {secs:.1f} s\n{_tail(text, 12)}")
    failed = [k for k, (rc, _, _) in runs.items() if rc != 0]
    if failed:
        raise AssertionError(f"failed: {failed}:\n" + "\n".join(
            _tail(runs[k][1]) for k in failed))
    for a, s, m in R1_CELLS:
        rec = json.loads((out / f"{a}__{s}__{m}.json").read_text())
        r = rec["roofline"]
        log(f"R1 {a} {s} {m}: trace {rec['trace_s']} s, terms compute "
            f"{r['t_compute_s']:.6g} s, memory {r['t_memory_s']:.6g} s, "
            f"collective {r['t_collective_s']:.6g} s ({r['dominant']}), "
            f"useful {r['useful_ratio']:.4f}, FLOPs {r['hlo_flops']:.6g}, "
            f"bytes {r['hlo_bytes']:.6g}, peak (traced) "
            f"{rec['memory']['peak_memory_in_bytes'] / 2 ** 30:.3f} GiB a "
            f"rank, arguments "
            f"{rec['memory']['argument_size_in_bytes'] / 2 ** 30:.3f} GiB, "
            f"collectives {json.dumps(rec['collectives'])}, attention "
            f"{rec['attention_route']}, profile {rec['profile']}")
        if min(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]) <= 0:
            raise AssertionError(f"R1 {a} {s} {m}: a roofline term is 0: "
                                 f"{r}")
    ce = json.loads((out / "ce_estimator__single__local.json").read_text())
    r = ce["roofline"]
    log(f"R1 CE ({ce['shape']}, {ce['chips']} ranks, {ce['mode']}): wall "
        f"{ce['wall_ms']:.3f} ms (CUDA events), device peak "
        f"{ce['device_peak_bytes'] / 2 ** 30:.3f} GiB, peak (traced) "
        f"{ce['memory']['peak_memory_in_bytes'] / 2 ** 30:.3f} GiB, slab "
        f"steps {ce['slab_steps']}, terms compute {r['t_compute_s']:.6g} s, "
        f"memory {r['t_memory_s']:.6g} s, collective "
        f"{r['t_collective_s']:.6g} s ({r['dominant']}), cost "
        f"{json.dumps(ce['cost_raw'])}, launches {ce['launches']}, "
        f"collectives {json.dumps(ce['collectives'])}; {smi_line()}")
    if not ce["estimates_finite"] or max(ce["slab_steps"].values()) < 1:
        raise AssertionError(f"R1 CE: estimates finite "
                             f"{ce['estimates_finite']}, slab steps "
                             f"{ce['slab_steps']}")
    if any(ce["launches"].get(k, 0) == 0 for k in PATH_KERNELS) or \
            min(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]) <= 0:
        raise AssertionError(f"R1 CE: launches {ce['launches']}, roofline "
                             f"{r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--s1-only", action="store_true",
                    help="phases 1-2 and S1 alone; no result lines")
    ap.add_argument("--serve-only", action="store_true",
                    help="phases 1-2 and L1-L3 alone; no result lines")
    ap.add_argument("--train-only", action="store_true",
                    help="phases 1-2 and T1 alone; no result lines")
    ap.add_argument("--mesh-only", action="store_true",
                    help="phases 1-2 and M1 alone; no result lines")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="phases 1-2 and R1 alone; no result lines")
    args = ap.parse_args(argv)
    import torch
    name = phase_device(torch)
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside "
                         "chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    clock = [t_start]

    def lap(tag):
        """Log the seconds since the last lap: the per-phase times."""
        now = time.perf_counter()
        log(f"phase seconds [{tag}]: {now - clock[0]:.1f}")
        clock[0] = now

    from repro_torch.core import lsh
    from repro_torch.core.config import ProberConfig
    from repro_torch.data import vectors
    phase_build()
    lap("device and build")
    if args.train_only:
        phase_training(torch, args.seed)
        lap("T1 training")
        return 0
    if args.mesh_only:
        phase_mesh_training(torch, args.seed)
        lap("M1 mesh trainer")
        return 0
    if args.dryrun_only:
        phase_dryrun(examples=False)
        lap("R1 dry runs")
        return 0
    if args.serve_only:
        phase_lm_serving(torch, args.seed)
        lap("L1 LM serving")
        phase_sharded_planner(torch, args.seed)
        lap("L2 sharded planner")
        phase_families(torch, args.seed)
        lap("L3 model families")
        return 0
    cfg = ProberConfig(**CFG_KW)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    corpus = vectors.make_corpus(g, N + N_INGEST + N_GROW, DIM)
    corpus_digest = digest(corpus[::CORPUS_STRIDE])
    x = corpus[:N]
    qs0, taus0, _ = vectors.paper_query_workload(g, x, NQ)
    taus0 = taus0[torch.arange(NQ, device=dev),
                  torch.arange(NQ, device=dev) % taus0.shape[1]]
    if args.s1_only:
        nan = (float("nan"),) * 3
        phase_sharded(torch, args.seed, qs0, taus0,
                      dict.fromkeys(("@ N", "@ N+ingest", "@ grown"), nan),
                      corpus_digest, dev)
        lap("S1 sharded estimator")
        return 0
    x_pad = torch.nn.functional.pad(x, (0, 0, 0, CAPACITY - N))
    index = lsh.build_index(x_pad, cfg, g, n_valid=N)
    res = phase_kernels(torch, corpus, qs0, taus0, index, cfg)
    del index, x_pad
    torch.cuda.empty_cache()
    lap("kernels")
    counts, state, qs, taus, main_qe = phase_main_path(torch, corpus, cfg,
                                                       args.seed)
    lap("main path")
    phase_query_lanes(torch, state.index, qs, "2^21")
    phase_query_lanes(torch, every_row_live(torch, state.index), qs,
                      "2^21, every row live")
    torch.cuda.empty_cache()
    res["slab_qualify"] = phase_slab(torch, "exact", state, qs, taus, cfg,
                                     args.seed, step=True)
    torch.cuda.empty_cache()
    res["slab_loop"] = phase_slab_loop(torch, "exact", state, qs, taus, cfg,
                                       args.seed)
    torch.cuda.empty_cache()
    res["central_qualify"] = phase_central(torch, "exact", state, qs, taus,
                                           cfg)
    torch.cuda.empty_cache()
    phase_profile(torch, exact_profile_runs(torch, state, qs, taus, cfg,
                                            args.seed))
    del state
    torch.cuda.empty_cache()
    phase_small_agreement(torch, cfg, args.seed)
    lap("query_lanes, slab, central, profile, agreement")
    serve_counts, co, pool_q, pool_t, picks = phase_serving(
        torch, corpus, cfg, args.seed)
    phase_serving_times(torch, co, pool_q, pool_t, picks)
    del co
    torch.cuda.empty_cache()
    res["cache_insert"] = phase_cache_insert(torch, args.seed)
    phase_serving_agreement(torch, cfg, args.seed)
    torch.cuda.empty_cache()
    lap("serving C1-C3")
    pq_counts, pstate, sstate = phase_pq_main_path(torch, corpus, qs, taus,
                                                   args.seed)
    res.update(phase_adc_kernels(torch, sstate, qs, taus))
    from repro_torch.core import estimator as E, pq as pqmod
    g_pr = torch.Generator(device=dev).manual_seed(args.seed + 6)
    pcfg, scfg = ProberConfig(**PROBER_PQ_KW), ProberConfig(**SERVE_KW)

    def packed(qual):
        """The serving slab with random 4-bit codes and Kc = 16 LUTs."""
        n, (nq, m, _) = qual.codes.shape[0], qual.luts.shape
        codes = torch.randint(0, 16, (n, m), generator=g_pr, device=dev,
                              dtype=torch.uint8)
        luts = torch.randint(0, 256, (nq, m, 16), generator=g_pr,
                             device=dev, dtype=torch.uint8)
        return qual._replace(codes=pqmod.pack_codes(codes).contiguous(),
                             luts=luts)

    for tag, st, c, requal in (
            ("prober_cfg PQ, mixed routing", pstate, pcfg, None),
            ("prober_cfg PQ, banded", pstate, pcfg.replace(pq_banded=True),
             None),
            ("serve_cfg uint8", sstate, scfg, None),
            ("serve_cfg uint8, packed codes", sstate, scfg, packed)):
        phase_slab(torch, tag, st, qs, taus, c, args.seed, requal=requal)
        torch.cuda.empty_cache()
    for tag, st, c, requal in (
            ("prober_cfg PQ, mixed routing", pstate, pcfg, None),
            ("prober_cfg PQ, banded", pstate, pcfg.replace(pq_banded=True),
             None),
            ("serve_cfg uint8", sstate, scfg, None),
            ("serve_cfg float LUTs", sstate,
             scfg.replace(pq_int8_lut=False), None),
            ("serve_cfg uint8, packed codes", sstate, scfg, packed)):
        phase_slab_loop(torch, tag, st, qs, taus, c, args.seed,
                        requal=requal)
        torch.cuda.empty_cache()
    for tag, st, c, exact in (
            ("prober_cfg PQ", pstate, pcfg, None),
            ("prober_cfg PQ, banded ADC", pstate,
             pcfg.replace(pq_banded=True), False),
            ("serve_cfg uint8", sstate, scfg, None),
            ("serve_cfg float LUTs", sstate,
             scfg.replace(pq_int8_lut=False), None)):
        phase_central(torch, tag, st, qs, taus, c, exact)
        torch.cuda.empty_cache()
    phase_profile(torch, [
        ("pq estimate_batch (prober_cfg)", lambda: E.estimate_batch(
            pstate, qs, taus, pcfg, generator=g_pr)),
        ("pq estimate_batch (serve_cfg)", lambda: E.estimate_batch(
            sstate, qs, taus, scfg, generator=g_pr))])
    del pstate, sstate
    torch.cuda.empty_cache()
    for tag, kw in (("pq float, packed", {}),
                    ("pq uint8, packed", dict(pq_int8_lut=True))):
        phase_small_agreement(torch, ProberConfig(
            **CFG_KW, use_pq=True, pq_pack4=True, **kw), args.seed, tag)
    lap("PQ path")
    # N1 and B1 on the main path's 1M state at 2^20 (the same build: the
    # same generator seed), then D1
    nstate = E.build(x, cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 1), capacity=CAPACITY, device=dev)
    res["neighbor_dists"], counts["neighbor_dists"] = phase_neighbors(
        torch, nstate, cfg, args.seed)
    lap("N1 neighbor table")
    b1_counts, res["l2dist_rows"] = phase_baselines(torch, nstate, x, cfg,
                                                    args.seed)
    counts["l2dist_rows"] = b1_counts["l2dist_rows"]
    del nstate, corpus, x
    torch.cuda.empty_cache()
    lap("B1 baselines")
    phase_corpora(torch, cfg, args.seed, dev)
    for d in D1_AGREE_DIMS:
        phase_small_agreement(torch, cfg, args.seed, f"exact, d = {d}",
                              dim=d)
    lap("D1 corpora")
    phase_sharded(torch, args.seed, qs, taus, main_qe, corpus_digest, dev)
    lap("S1 sharded estimator")
    torch.cuda.empty_cache()
    phase_lm_serving(torch, args.seed)
    lap("L1 LM serving")
    phase_sharded_planner(torch, args.seed)
    lap("L2 sharded planner")
    phase_families(torch, args.seed)
    lap("L3 model families")
    phase_training(torch, args.seed)
    lap("T1 training")
    phase_mesh_training(torch, args.seed)
    lap("M1 mesh trainer")
    phase_dryrun()
    lap("R1 dry runs, X1 examples")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    # launches: the exact kernels' from the exact main path, the ADC
    # kernels' from the PQ path's configs (adc_batch_q8 has no path in the
    # reference), cache_insert's from the serving run, neighbor_dists' from
    # N1, l2dist_rows' from B1's sampling run
    counts.update({k: sum(w[k] for w in pq_counts.values())
                   for k in ("adc_rows", "adc_rows_q8", "adc_batch",
                             "adc_batch_q8")})
    counts["cache_insert"] = serve_counts["cache_insert"]
    kernels = [dict(name=k, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{SOURCES[k]}",
                    replaces=REPLACES[k], launches=counts[k],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                    bound_by=r["bound"][1], library_ms=r["library_ms"])
               for k, r in res.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
