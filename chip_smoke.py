"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-report   # phases 1, 3-8 and 12 (a)
    python3 chip_smoke.py --bits-dump DIR LABEL   # outputs to DIR/LABEL.pt
    python3 chip_smoke.py --bits-compare DIR      # all dumps bit for bit
    python3 chip_smoke.py --bits-probe      # repeated calls' bits only
    python3 chip_smoke.py --fused-split     # what K6 / K11's flush costs
    python3 chip_smoke.py --sharded-only    # phase 16 alone, every card
    python3 chip_smoke.py --sharded-only 2x2    # ... on these meshes only

Drives the port's paths at realistic sizes and holds every CUDA kernel
they run (K1-K11 and the sharded plans' ordered combine) against its plain
PyTorch version. The compile path is
``repro_torch.compile(matrix, Target) -> SpmvPlan`` with a 1-D x (kernels
K1-K6); the serving path is ``prune_magnitude`` -> ``compile(...,
Target(batch_size=8), store=)`` -> ``PlanExecutor`` -> ``SpmvEngine``
with a ``PlanStore`` hot-swap (the multi-RHS kernels K7-K11); the sharded
path is ``compile(matrix, Target(mesh=make_data_mesh(4, device="cuda:0")))``
-> ``ShardedSpmvPlan`` (phase 12); the LLM serving path is
``ServingEngine`` -> ``ModelExecutor`` -> ``CausalLM`` (phase 13); the
training path is ``make_train_step`` and ``TrainDriver`` (phase 14), and
on a mesh of processes, one a card, with the state sharded (phase 16).
Phases, each printing its seconds:

1. device: the card's name and power limit, the kernels' nvcc build;
2. SpMV kernels on small odd shapes (T not a multiple of tiles_per_step,
   tiles_per_step in {1, 3, 8}, every storage type) against the plain
   versions, with K1/K2/K5 at W in {1, 9, 31, 32, 33, 400, 1000} (the
   slab and split-row mappings; row counts not multiples of 32; K5 from
   row 11 into a prefilled y, n_rows cutting a slab), K4/K6 in one-hot
   mode on unsorted local rows with some outside [0, M) (C = 1536 and
   21), K3/K6 in seg_scan mode on ends that descend, repeat, pass C or
   fall below 0, a padding tile, C in {21, 512, 2048, 8192, 12288} on and
   off the 16-byte alignment with K6 at tiles_per_step 1, 3, 8 and 16 (at
   C = 12288 exactly 48 KB of dynamic shared memory), and M =
   60000 segments, and columns outside [0, n_cols); 2b. the same for the SpMM
   kernels at B in {1, 3, 8, 17, 40}, K7-K9 at those widths, at 5120
   rows and at one serving tile (T = 1, R = 128, W = 397, B = 8); K10b
   and K11 on one-hot local rows unsorted, of one row, in runs across a
   thread, a warp and a pass, out of range, at C = 21 and 12 and off the
   16-byte alignment; K10a and K11 on seg_scan ends that descend, repeat,
   pass C or fall below 0, and a padding tile; C = 512 at tiles_per_step
   1, 3, 8 and 16; and tiles of C = 8192 slots at M = 700 (B = 8 and 40,
   the accumulator past 48 KB), M = 8192 and M = 60000 (one tile's
   accumulator past the block's shared memory), and C = 512 at M = 384,
   B = 8 (a window of exactly 48 KB of dynamic shared memory); 2c. eight
   random rows of 20 nonzeros padded with zero slots to W in {20, 24, 32,
   40, 64, 200, 400}, and three of 300 padded to W in {300, 304, 400,
   512}, each launched among 1, 128 and 65,536 rows: K1 and K5 give a row
   one and the same bits, and so do K7 and K9 at B = 8, and the grouped K1
   and K7 with the row's bucket between two others (a ``row_sums {...}``
   line);
3. a searched compile of ``banded_matrix(2**21, 4)`` (18.87 M nnz) on the
   default Target (a 10 s budget), checked against the float64 oracle,
   plus a save/load round trip;
4. fixed-graph compiles that force every SpMV kernel: ELL on the banded
   matrix (scatter K1, grid_acc K2, fused K5 at tiles_per_step 1 and 8,
   bf16), and the seg family on ``powerlaw_matrix(2**20, 2**20, 8.0,
   1.5)`` (7,845,296 nnz; seg_scan, onehot and gmem_atom, fused K6 and
   unfused K3/K4), each checked against the oracle;
4b. bit stability: every phase-4 seg plan (K3, K4, K6 in both modes,
   the gmem_atom steps, the unfused plans' ordered combine; at B = 8
   K10a, K10b, K11) called 20 times and its saved-and-loaded copy once,
   at B = 1 and 8: every output bit-identical to the first (a
   ``bitstable {...}`` line);
5. SpMV kernel report: each kernel at the operands of a phase-4 plan
   against its plain version (fp32 and bf16 storage), its median time over
   CUDA events, the plain version's and the cuSPARSE yardstick's
   (``torch.sparse_csr_tensor @ x``, never used by the port), and its
   bound (bytes each input read once and each output written once over
   3.35 TB/s, or 2 flops per stored slot over 67 TFLOP/s fp32, the
   larger). ``ms`` is what a caller sees (events around the call, host
   time included); ``device_ms`` (and ``library_device_ms``) times the
   card alone, with the host's enqueueing hidden behind a sleep kernel.
   K6 in one-hot mode (the fused ONEHOT_MXU_RED plan) is timed the same
   way and printed on a line of its own (``K6[onehot_mxu] {...}``). Both
   K6 rows are also held bit for bit to the unfused kernel's partials
   (K3 / K4) placed in the fused step's fixed order (one-writer rows y +
   v, shared rows through ``rowmap_combine`` in perm order), and carry
   the step's side slots and shared rows (``n_side``, ``shared_rows``). The
   K3 and K6 (seg_scan) rows add two probes on their vals and cols, on
   the card alone: ``gather_device_ms`` (K1 on them viewed as (T, C/16,
   16) ELL tiles: the same bytes and x gathers in K1's structure) and
   ``b1_spmm_device_ms`` (K10a / K11 at B = 1); the lines
   ``K3[local_cols] {...}`` and ``K6[local_cols] {...}`` time the same
   kernels, checked the same way, with ascending columns whose gathers
   stay in a few L1 lines;
6. the serving path at full width: Qwen3-8B's FFN up-projection
   (d_ff x d_model = 12288 x 4096) magnitude-pruned to density 0.08
   (4,026,531 nnz), a searched ``Target(batch_size=8)`` compile (a 10 s
   budget) through a ``PlanStore``, ``PlanExecutor`` with buckets (1, 2,
   4, 8), and ``SpmvEngine`` serving 200 requests in ragged waves while a fixed-graph
   plan lands in the store and is hot-swapped in; every answer is checked
   against the float64 oracle;
7. fixed-graph compiles on the same matrix that force every SpMM kernel
   at B = 8 (ELL scatter K7, grid_acc K8, fused K9 at tiles_per_step 1
   and 8 and bf16; seg_scan, onehot and gmem_atom, unfused K10a/K10b and
   fused K11), each checked against the oracle; the ELL scatter plan's
   26 width buckets run as one grouped K7 launch and one combine, and
   with a 1-D x (also checked) as one grouped K1 launch and one combine;
8. SpMM kernel report at the phase-7 operands, as phase 5, with the
   cuSPARSE SpMM yardstick ``torch.sparse_csr_tensor @ X``, X (n_cols, 8).
   The K7 row times the grouped launch over the ELL plan's 26 buckets
   and adds the 26 per-bucket launches (``per_bucket_ms``,
   ``per_bucket_device_ms``), the host time of one wrapper call
   (``host_us_per_call``: the 26 per-bucket calls on the host clock,
   before any synchronise, over 26; ``grouped_host_us_per_call``), the
   device time of one single-tile launch (``one_tile_ms``), and the plan
   call (``plan_ms``, ``plan_device_ms``, ``plan_launches``) beside its
   per-step loop (``per_step_*``, held to the same bits). A ``K1[grouped]
   {...}`` line does the same for the plan with a 1-D x (the grouped K1
   beside cuSPARSE SpMV), and its row follows the twelve on the kernels
   line. In a package without grouped launches (the parent in an A/B)
   both time the per-bucket launches. When the searched B = 8 plan of phase 6 is a seg
   plan, its fused seg step is timed with K11 at its own chunk and
   tiles_per_step and printed on a line of its own (``K11[searched]
   {...}``, with the cuSPARSE SpMM times), outside the twelve rows; K11
   and ``K11[searched]`` are held to K10a / K10b's partials placed in
   order, as K6 is, and carry ``n_side`` and ``shared_rows``;
9. the paper's baselines (``repro_torch.sparse``: CSR, COO, ELL, SELL,
   HYB, Merge, ACSR, CSR-Adaptive, eager torch ops) on the banded,
   powerlaw and serving matrices with a 1-D x: each built on the card,
   held to the float64 oracle and timed (``ms``, ``device_ms``), one
   ``baselines {...}`` line per matrix; a format whose stored bytes,
   counted from the row lengths before anything is built, pass 16 GB is
   left out (ELL on the powerlaw matrix). Then the Perfect Format
   Selector over the built formats, beside the port's plan for the
   matrix (phase 3's searched plan, the fastest of phase 4's seg plans,
   phase 6's searched plan) timed the same way: one ``pfs {...}`` line per
   matrix;
10. dynamic sparsity (``repro_torch.dyn``) on the serving matrix: (a) a
   ``capacity_graph()`` plan (K1) updated in place by a delta that
   revalues 10 % of the entries and moves 5 % to another column of the
   same row, against a fresh compile of the mutated matrix: output and
   every format tensor bit-identical, the oracle within 1e-5 (a
   ``dyn_update {...}`` line), and again with a delta that drops the last
   entry of a third of the rows, which the fresh compile puts in narrower
   width buckets: output bit-identical (a ``dyn_update[move_buckets]
   {...}`` line); (b) one step of ``run_pruning_loop`` at
   lr 0.01 with a ``DynamicSparsityManager`` on a ``PlanExecutor`` over a
   ``capacity_graph(pad_to=512)`` plan, every served answer held to the
   oracle, the first step's delta also handed to a manager on (a)'s plan,
   where it does not fit and a background re-search on the card takes
   over (``pruning step`` and ``pruning {...}`` lines); (c) one update
   of phase 4's fused seg_scan plan (K6) on the powerlaw matrix (a ``dyn_seg_update {...}`` line);
11. fleet compilation (``repro_torch.corpus``, every compile on the cuda
   backend): (a) ``run_sweep(isolate="process")`` over the first entry
   of ``synthetic_corpus("medium")`` (banded at n = 1024) and one
   real-size entry (powerlaw n = 2^20, 7.85 M nnz) under
   the reference test's coarse budget, one ``corpus_sweep {...}`` line per
   entry; no child may rebuild a kernel library; (b) the same sweep with ``resume=True``,
   which must compile nothing; (c) ``train_from_store`` -> ``CorpusModel``
   (a ``corpus_model {...}`` line); (d) ``holdout_corpus("medium")`` and a
   held-out power-law matrix (n = 2^18; 2^19 up to PR 21) compiled with
   anneal, learned and portfolio (deadline 2 s), each held to the oracle
   and timed (one
   ``corpus_holdout {...}`` line each), and on the held-out power-law
   matrix the Designer's seconds on ``capacity_graph()`` before and after
   the one-pass ELL layout, whose layouts must agree (a ``designer_layout
   {...}`` line); (e) ``python -m repro_torch.cli``
   in subprocesses: a search, a B = 8 search, ``--no-search``, ``--sweep
   smoke`` and ``--train-from-store`` (a ``cli {...}`` line of return
   codes); (f) ``SpmvPlan.cost_analysis`` of phase 3's and phase 6's
   searched plans, its bound beside their card time (``cost_analysis
   {...}`` lines);
12. sharded SpMV (``repro_torch.dist``) on 4 shards of the one card: (a)
   the serving matrix compiled with ``Target(mesh=..., partition=mode)``
   and no budget (``default_shard_graph``) in row and col mode, held to the
   float64 oracle (1e-4 x max|oracle|, the reference's dist tolerance) at
   B = 1 and 8, two calls and the saved-and-loaded plan bit-identical; one
   ``dist {...}`` line per mode with the shards' nnz, families, stacked
   bytes and slots, the folded operands' own bytes (``folded_bytes``),
   launches per call (one family kernel and one combine a step: the
   shards share the card, so the call runs once over the folded
   operands), ``ms`` / ``device_ms`` at B = 1 and 8, beside phase 6's
   dense searched plan and cuSPARSE; (b)
   ``dist_search`` of phase 4's power-law operand (row mode, nnz balance,
   4 s, 2 structures, 1 coarse sample a shard), and again with shard 0's
   search crashing (it must fall back), each held to the oracle at B = 1
   and 8 (``dist_search {...}`` lines); (c) ``sparsify_linear_sharded``
   on the serving weight answering an (8, 4096) batch. Every family
   kernel and the combine are held to their plain versions on shard 0's
   operands and on the folded ones. The ordered combine
   (``rowmap_combine``) joins the kernel report with six rows: at shard
   0's ELL step of the col-mode and the row-mode serving plans at B = 1
   and 8, at all four col-mode shards' partials in one launch (the
   folded shape), and at the unfused power-law plan's shape (phase 8's
   ``dense_plans`` line);
13. LLM serving (``repro_torch.models``, ``ModelExecutor``,
   ``ServingEngine``; seeded random weights, full widths, no kernel of
   its own): (a) qwen3-8b at depth 2, fp32: ``decode_step`` over 16
   tokens and ``prefill`` against ``forward`` by tests/test_models.py's
   2e-3 rule, block 0 and the head against float64 on the CPU, a request
   joining mid-flight against the same request alone (same tokens,
   bit-identical slot caches; an ``llm_check {...}`` line); (b) qwen3-8b
   at its full 36 layers, bf16 weights: a ``ServingEngine`` of 8 slots
   (max_seq 512, 32 new tokens) serves 16 seeded requests (prompts of
   8-32 tokens) arriving one every two steps, the second eight joining
   mid-flight; then one decode step of 8 live rows timed as a caller
   sees it (``step_ms``), on the card alone (``step_device_ms``: the step
   in a CUDA graph, under ``device_ms``) and under ``torch.profiler``
   (kernels a step), beside the bound of its weight and cache bytes (an
   ``llm_serve {...}`` line); (c) deepseek-moe-16b at depth 2, fp32:
   one-hot against sorted dispatch on (4, 512) tokens at capacity factor
   8 (rtol 2e-4, atol 2e-5) and 1.25 (equal drops), decode against
   forward at a drop-free capacity, then layer 0's routing of 2048
   tokens as a ``routing_matrix`` (2048 x 64, 12,288 nnz) compiled on
   ``capacity_graph()`` and patched in place by a 25 % churn, held to the
   oracle, its ELL kernel (K1 or K5) to the plain version, its launches
   counted (an ``llm_moe {...}`` line); (d) mamba2-1.3b at depth 2, fp32:
   ``prefill`` of 256 tokens and 256 ``decode_step`` s against
   ``forward`` over 512 (an ``llm_ssm {...}`` line);
14. training (``repro_torch.train``, ``launch.TrainDriver``; seeded
   random weights, the synthetic pipeline; no kernel of its own): (a)
   granite-3-2b at full width, depth 2, batch 2 x 128: one fp32 step
   against the same step in float64 on the card (loss, grad_norm,
   gradients, the parameters after AdamW) and remat on against off (a
   ``train_check {...}`` line, each error beside its tolerance); (b)
   granite-3-2b at its full 40 layers (2.53 B parameters), bf16 compute,
   remat, batch 4 x 512: one warm-up and 6 timed ``make_train_step``
   steps (CUDA events), the split into forward+backward and the
   optimizer, tokens/s, model FLOPs over step time and over the bf16
   peak, first and last loss, peak memory, and one grad_accum=2 step's
   loss beside the grad_accum=1 loss of its batch (a ``train_step
   {...}`` line); (c) ``TrainDriver`` at full width, depth 2, with
   checkpoints every 3 steps, compression and a failure injected at
   step 7: one restart from a checkpoint, >= 8 steps run, a finite loss,
   then a timed save and restore of its state (a ``train_driver {...}``
   line); (d) ``python -m repro_torch.launch.train --arch granite-3-2b
   --reduced --steps 50`` in a subprocess (a ``train_cli {...}`` line);
15. the dry run and the examples (``repro_torch.launch.dryrun``, which
   allocates nothing and needs no card; ``examples/torch_*.py``): (a)
   ``lower_cell`` of phase 14 (b)'s step on a one-device mesh
   description, its argument + temporary bytes within 25 % of phase 14
   (b)'s measured peak and its FLOPs 1.2-1.3x phase 14's model FLOPs
   (the remat recompute; a ``dryrun_train {...}`` line); (b) the same for
   qwen3-8b's decode at phase 13 (b)'s 8 slots and 512 positions, with
   the reference's float32 weights and with the engine's bf16 ones, the
   bf16 prediction within 25 % of phase 13 (b)'s peak while serving (a
   ``dryrun_decode {...}`` line); (c) ``python -m
   repro_torch.launch.dryrun --arch all --shape train_4k --mesh
   single`` in a child, that cell of every architecture on the
   reference's 16 x 16 pod description, 0 failed (a ``dryrun_sweep
   {...}`` line): it needs no card, so it runs beside phases 4 and 4b
   (nothing timed there) and is read after phase 4b; (d) the five
   examples on the card in children, at once and beside (a)-(b): each
   returns 0, passes its
   own check line (oracle errors, the loaded plan bit-identical, the
   loss decreasing) and has launched every kernel its plans dispatch to,
   by the children's launch counters (an ``examples {...}`` line);
16. sharded training and serving (``repro_torch.dist.collectives``, the
   step with ``grad_specs`` on a mesh of processes; no kernel of its
   own): torchrun
   starts this script's ``--sharded-worker`` mode, one process a card,
   NCCL, on a mesh of every visible card ((1, 1) on one card; (n, 1) and,
   for n >= 4, (n / 2, 2) and (1, n) on n): (a) granite-3-2b,
   granite-moe-3b-a800m (its 40 experts split over ``model``, a tied
   vocabulary) and mamba2-1.3b (its 64 SSD heads split, an untied head)
   at full width, depth 2, fp32, batch 8 x 128: the sharded step's first
   gradients and three steps against the one-device step on the same
   weights and batches, within phase 14 (a)'s limits, each twice: as
   is and with sequence parallelism (``seq_shard`` with ``act_dp`` the
   data axes: the residual stream's sequence split over ``model``) (a
   ``sharded_check {...}`` line each, with the layout's splits and
   ``seq_shard``); (b) granite-3-2b at its
   full 40 layers (and on (n / 2, 2) and (1, n) the other two at their
   full 32 and 48; on (n / 2, 2) granite with ``seq_shard`` too, beside
   the same mesh without it), bf16, remat, 4 x 512 tokens a data position: for
   granite the unsharded step on 4 x 512 and the sharded step in one
   process, each with a warm-up, 3
   timed steps split at the optimizer and one under ``torch.profiler``
   (the card's busy time, its idle share of the step, host time,
   collectives), each rank's peak memory and state bytes, beside phase
   14 (b)'s unsharded step (a ``sharded_step {...}`` line each);
   (c) ``python -m repro_torch.launch.train`` under torchrun on (n, 1),
   reduced, with a failure injected, beside the first (a) (the first
   (b) waits for it to end): one restart, a finite loss (a
   ``sharded_cli {...}`` line); then the sharded serving step
   (``prefill`` and ``decode_step`` with ``layout=``, the caches laid
   out by ``cache_specs``): (a') qwen3-8b, granite-moe-3b-a800m,
   deepseek-moe-16b, mamba2-1.3b and granite-3-2b with a 16-token
   window, at full width, depth 2, fp32: a prefill of 8 x 24 tokens and
   4 decode steps (one scalar position, then per-row positions with a
   subset of the rows live) against the one-device calls, every rank's
   logits and every cache leaf gathered whole within phase 13 (a)'s
   2e-3 rule (a ``sharded_serve_check {...}`` line each); (b') qwen3-8b
   at full depth, bf16, 8 rows a data position: a 32-token prompt and
   32 greedy decode steps, the one-device calls on the global batch
   first in the same process, then the sharded ones: step ms as seen,
   the card's busy ms and idle share (one profiled step), collectives a
   step, peak memory, tok/s, the byte bound, and the share of greedy
   tokens equal to the one device's; on one card (every split of size
   one) the prefill logits and every greedy token must equal the one
   device's, elsewhere the prefill logits must lie within 2e-2 x max
   |logit| of the float32 one-device prefill's, or twice the bf16 one
   device's distance from them, and a prefill with a planted fault
   must miss that limit (a ``sharded_serve {...}`` line). Each line
   carries the card's name and power limit.

Phases 3-4 and phases 6-7 are the two paths: the launch counters are set
to 0 before each and read after it, and each of its kernels must have
launched. Phase 10 is read the same way: K1 and K6 must launch in it;
phase 11 prints its own process's counts (its searches pick the
kernels); in phase 12 every kernel its plans' families dispatch to, and
the combine, must launch; in phase 13's churn run K1 or K5 must
launch, and no other kernel. The script is the child subreaper of what
it starts (children, and the orphans they leave, even outside their
session) and, before its last lines and on a failure, kills and reaps
every process still below it (a ``processes {...}`` line names those it
found). The last two lines are the kernel report (the
twelve kernels and the combine) and ``{"ok": true, "device": {...}}``.
``--kernel-report`` runs phases 1, 3-8 and phase 12 (a) alone and
prints the twelve rows and the combine's: copied into a checkout of
another commit, it times that commit's kernels on the same card (the A/B
recipe of the verify notes; there a call may also launch once a shard);
``--bits-dump DIR LABEL`` writes the outputs of the sharded, searched and
unfused plans to ``DIR/LABEL.pt`` (the plans made once under
``DIR/plans`` and loaded by every later run, in either checkout) and
``--bits-compare DIR`` holds every dump there to the first, bit for bit;
``--bits-probe`` counts, in the same way, the calls of the seg kernels
and plans whose bits differ from the first call's, and ``--fused-split``
times the fused seg steps (K6, K11) against their unfused kernels and
with their flush cut down (``fused_split {...}`` lines);
``--sharded-only`` runs phase 16 alone (on every visible card: the
multi-card meshes' check; ``DATAxMODEL`` arguments keep those meshes
only), and ``--sharded-worker OUT DATA MODEL GATE ARCHS`` is one rank
of it. The script
exits non-zero, printing no result, without a GPU or outside a checkout
of the repository. It imports neither jax nor ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
SEARCH_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
KERNEL_TOL = 1e-4                # kernel vs plain: summation order

KERNELS = {
    "K1": ("ell_spmv", "src/repro_torch/kernels/csrc/ell_spmv.cu",
           "src/repro/kernels/ell_spmv.py:74"),
    "K2": ("ell_spmv_direct", "src/repro_torch/kernels/csrc/ell_spmv.cu",
           "src/repro/kernels/ell_spmv.py:106"),
    "K3": ("seg_spmv[seg_scan]", "src/repro_torch/kernels/csrc/seg_spmv.cu",
           "src/repro/kernels/seg_spmv.py:102"),
    "K4": ("seg_spmv[onehot_mxu]", "src/repro_torch/kernels/csrc/seg_spmv.cu",
           "src/repro/kernels/seg_spmv.py:102"),
    "K5": ("ell_spmv_fused", "src/repro_torch/kernels/csrc/ell_spmv.cu",
           "src/repro/kernels/ell_spmv.py:249"),
    "K6": ("seg_spmv_fused", "src/repro_torch/kernels/csrc/seg_spmv.cu",
           "src/repro/kernels/seg_spmv.py:274"),
    "K7": ("ell_spmm", "src/repro_torch/kernels/csrc/ell_spmm.cu",
           "src/repro/kernels/ell_spmv.py:146"),
    "K8": ("ell_spmm_direct", "src/repro_torch/kernels/csrc/ell_spmm.cu",
           "src/repro/kernels/ell_spmv.py:174"),
    "K9": ("ell_spmm_fused", "src/repro_torch/kernels/csrc/ell_spmm.cu",
           "src/repro/kernels/ell_spmv.py:284"),
    "K10a": ("seg_spmm[seg_scan]", "src/repro_torch/kernels/csrc/seg_spmm.cu",
             "src/repro/kernels/seg_spmv.py:170"),
    "K10b": ("seg_spmm[onehot_mxu]",
             "src/repro_torch/kernels/csrc/seg_spmm.cu",
             "src/repro/kernels/seg_spmv.py:170"),
    "K11": ("seg_spmm_fused", "src/repro_torch/kernels/csrc/seg_spmm.cu",
            "src/repro/kernels/seg_spmv.py:319"),
}
SPMV_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6")
ONEHOT_K6 = "K6[onehot_mxu]"     # reported apart from the twelve rows
SEARCHED_K11 = "K11[searched]"   # ... and so is the searched plan's K11
SPMM_KERNELS = ("K7", "K8", "K9", "K10a", "K10b", "K11")
SERVE_B = 8                      # the serving plan's searched batch size
# search budgets of phases 3 and 6, short for the smoke run's time limit
# (the seed pass may run to twice the budget)
SEARCH_SECONDS = {"banded": 10.0, "serving": 10.0}
STORAGES = [(torch.float32, torch.int32, torch.float32),
            (torch.bfloat16, torch.int16, torch.float32),
            (torch.bfloat16, torch.int16, torch.bfloat16)]


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def phase(name: str):
    t0 = time.perf_counter()

    def done():
        print(f"[phase {name}] {time.perf_counter() - t0:.2f} s", flush=True)
    print(f"[phase {name}] start", flush=True)
    return done


def err_scale(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()), float(want.abs().max())


def check_kernel(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err, scale = err_scale(got, want)
    tol = KERNEL_TOL * scale + 1e-6
    print(f"  {label}: max_abs_err {err:.3e} (tol {tol:.3e})")
    require(err <= tol, f"{label}: kernel disagrees with its plain version")
    return err


def check_oracle(label: str, y: torch.Tensor, oracle: np.ndarray,
                 storage: str) -> None:
    y = y.cpu().numpy()
    require(y.shape == oracle.shape and np.isfinite(y).all(),
            f"{label}: bad output shape or non-finite values")
    scale = float(np.abs(oracle).max())
    err = float(np.abs(y - oracle).max())
    tol = SEARCH_TOL[storage] * scale + 1e-5
    print(f"  {label}: vs oracle max_abs_err {err:.3e} (tol {tol:.3e})")
    require(err <= tol, f"{label}: output disagrees with the oracle")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms over ``reps`` CUDA-event pairs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, warmup: int = 3,
              max_cycles: int = 1 << 34) -> float:
    """Median time of ``fn`` on the card alone, in ms: a sleep kernel keeps
    the card busy while the host enqueues ``fn``, so the events bracket
    only the card's work. A sample counts only if the host finished
    enqueueing before the card reached the first event; otherwise the
    sleep is doubled, up to ``max_cycles``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles, times = 1 << 22, []
    while len(times) < reps:
        require(cycles < max_cycles, "device_ms: the host never got ahead")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        ahead = not a.query()
        b.synchronize()
        if ahead:
            times.append(a.elapsed_time(b))
        else:
            cycles *= 2
    return statistics.median(times)


def host_ms(fn, calls: int = 200, reps: int = 5) -> float:
    """Median host time, in ms, to enqueue one call of ``fn`` (its Python
    and its checks, not the card's work): ``calls`` calls back to back
    while a sleep kernel keeps the card busy, so that none waits for the
    card. A sample counts only if the sleep outlasted the calls;
    otherwise the sleep is doubled."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles, times = 1 << 24, []
    while len(times) < reps:
        require(cycles < 1 << 36, "host_ms: the card never stayed busy")
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = time.perf_counter() - t0
        ahead = not slept.query()
        torch.cuda.synchronize()
        if ahead:
            times.append(t / calls * 1e3)
        else:
            cycles *= 2
    return statistics.median(times)


# ------------------------------- phase 1 ----------------------------------

def device_phase():
    from repro_torch.kernels import build
    done = phase("1 device")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    per_source = build.build_all()
    print(f"  kernel build {time.perf_counter() - t0:.2f} s "
          f"(per source: {json.dumps(per_source)})")
    for log in sorted(build.BUILD_DIR.glob("*.log")):
        print(f"  {log.name}: {ptxas_summary(log.read_text())}")
    done()


def kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier in a mangled name: its length is the
    number written before it."""
    for found in re.finditer(r"(\d+)([A-Za-z_]+_kernel)", mangled):
        digits, name = found.groups()
        if any(int(digits[k:]) == len(name) for k in range(len(digits))):
            return name
    return mangled


def ptxas_summary(text: str) -> str:
    """Per kernel template in nvcc's ``-Xptxas -v`` output: its
    instantiations, their registers a thread (least-most) and the most
    spill bytes stored."""
    kernels, name = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = kernel_name(ln.split("'")[1])
            kernels.setdefault(name, {"regs": [], "spill": 0})
        elif name and "spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
            kernels[name]["spill"] = max(kernels[name]["spill"], spill)
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            kernels[name]["regs"].append(int(m.group(1)))
    return "; ".join(
        f"{k} x{len(v['regs'])} {min(v['regs'], default=0)}-"
        f"{max(v['regs'], default=0)} registers, spill {v['spill']} B"
        for k, v in kernels.items()) or "(no ptxas info)"


# ------------------------------- phase 2 ----------------------------------

def onehot_rows(rng, t, c, m, case="out_of_range"):
    """(t, c) int32 local rows that the one-hot kernels must sum as the
    one-hot matrix does: ``out_of_range`` in no order, about a fifth of
    them outside [0, m) (-1, m, m + 100, which add nothing); ``unsorted``;
    ``one_row`` (one heavy row fills each tile); ``runs`` (sorted runs whose
    lengths cross a thread's 8 slots, a warp's 256 and a pass's 2048)."""
    if case == "unsorted":
        return torch.from_numpy(rng.integers(0, m, (t, c)).astype(np.int32))
    if case == "one_row":
        return torch.from_numpy(np.repeat(np.arange(t)[:, None] % m, c,
                                          axis=1).astype(np.int32))
    if case == "runs":
        lens = [7, 9, 31, 33, 250, 260, 1, 8, 16, 257, 2100]
        rows = np.repeat(np.arange(c), np.resize(lens, c))[:c]
        return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            np.minimum(rows, m - 1), (t, c)), dtype=np.int32))
    local = rng.integers(0, m, (t, c))
    bad = rng.random((t, c)) < 0.2
    local[bad] = rng.choice([-1, m, m + 100], int(bad.sum()))
    return torch.from_numpy(local.astype(np.int32))


def seg_ends(rng, case, t, c, m):
    """(t, m) int32 seg_end rows the packer never writes: ``descending``
    somewhere, ``repeated``, ``past_c``, ``negative``, ``mixed`` (any of
    these), or the packer's with a ``padding`` tile of ends 0."""
    if case == "descending":
        end = rng.integers(0, c + 1, (t, m))
        end[0] = np.sort(end[0])[::-1]
    elif case == "repeated":
        end = np.sort(rng.choice([0, c // 3, c // 3, c - 1, c], (t, m)),
                      axis=1)
        end[0] = c // 2
    elif case == "mixed":
        end = rng.integers(-3, c + 4, (t, m))
    else:
        end = np.sort(rng.integers(0, c + 1, (t, m)), axis=1)
        if case == "past_c":
            end[:, -3:] = [c + 1, c + 7, 2 * c]
        elif case == "negative":
            end[:, :3] = [-5, -1, 0]
        else:
            end[-1] = 0
    return torch.from_numpy(end.astype(np.int32))


def seg_case(rng, t, s, l, m):
    """The packer's sorted local rows (t, s, l) and their seg_end (t, m)."""
    c = s * l
    local = np.sort(rng.integers(0, m, (t, c)), axis=1)
    local = np.minimum(local - local[:, :1], m - 1)
    seg_end = np.full((t, m), c, np.int32)
    for ti in range(t):
        starts = np.searchsorted(local[ti], np.arange(m), side="right")
        seg_end[ti] = np.where(starts < c, starts, c)
    return (torch.from_numpy(local.astype(np.int32).reshape(t, s, l)),
            torch.from_numpy(seg_end))


# (T, R, W) of the width sweep: K1/K2 take the 32-row slab kernel up to
# W = 32 and split rows over warps above it; 72 and 5 rows are not
# multiples of the slab's 32 rows. K7-K9 split a row over 1, 2, 4 or 8
# warps by row count, W and B (8 at one serving tile at B = 8).
ELL_WIDTHS = [(3, 24, 1), (3, 24, 9), (3, 24, 31), (3, 24, 32), (3, 24, 33),
              (1, 24, 400), (1, 5, 1000)]
ONE_TILE = (1, 128, 397)         # a single-tile bucket of the serving plan


def ell_case(rng, shape, n_cols, vd, cd):
    v = torch.from_numpy(rng.standard_normal(shape)).to(vd)
    c = torch.from_numpy(rng.integers(0, n_cols, shape)).to(cd)
    return v, c


def out_of_range(rng, v, c, n_cols):
    """``c`` with about a tenth of its slots (and the first) outside
    [0, n_cols), and the plain versions' operands for the same sums: those
    slots at column 0 with value 0."""
    bad = torch.from_numpy(rng.random(tuple(c.shape)) < 0.1)
    bad.view(-1)[0] = True
    far = c.masked_fill(bad, n_cols + 7)
    far.view(-1)[0] = -1
    return far, v.masked_fill(bad, 0), c.masked_fill(bad, 0)


def off_by_one(t: torch.Tensor, dev) -> torch.Tensor:
    """``t`` on ``dev``, one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    flat[1:] = t.reshape(-1).to(dev)
    return flat[1:].view(t.shape)


def small_kernels_phase():
    from repro_torch.kernels import ops, ref
    done = phase("2 kernels on small odd shapes")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n_cols = 5000
    g = lambda t: t.to(dev)
    for vd, cd, xd in [(torch.float32, torch.int32, torch.float32),
                       (torch.bfloat16, torch.int16, torch.float32),
                       (torch.bfloat16, torch.int16, torch.bfloat16)]:
        tag = f"{str(vd)[6:]}/{str(cd)[6:]}/x:{str(xd)[6:]}"
        T, R, W = 7, 24, 37
        v = torch.from_numpy(rng.standard_normal((T, R, W))).to(vd)
        c = torch.from_numpy(rng.integers(0, n_cols, (T, R, W))).to(cd)
        x = torch.from_numpy(rng.standard_normal(n_cols)).to(xd)
        check_kernel(f"K1 {tag}", ops.ell_spmv(g(v), g(c), g(x)),
                     ref.ell_spmv_ref(v, c, x))
        check_kernel(f"K2 {tag}", ops.ell_spmv_direct(g(v), g(c), g(x)),
                     ref.ell_spmv_direct_ref(v, c, x))
        for k in (1, 3, 8):
            check_kernel(f"K5 {tag} K={k}", ops.ell_spmv_fused(
                g(v), g(c), g(x), n_rows=150, row0=11, tiles_per_step=k),
                ref.ell_spmv_fused_ref(v, c, x, n_rows=150, row0=11))
        T, S, L, M = 7, 12, 128, 200
        local, end = seg_case(rng, T, S, L, M)
        v = torch.from_numpy(rng.standard_normal((T, S, L))).to(vd)
        c = torch.from_numpy(rng.integers(0, n_cols, (T, S, L))).to(cd)
        r0 = torch.from_numpy((np.arange(T) * 150).astype(np.int32))
        for mode, kid in (("seg_scan", "K3"), ("onehot_mxu", "K4")):
            check_kernel(f"{kid} {tag}", ops.seg_spmv(
                g(v), g(c), g(local), g(end), g(x), M, mode=mode),
                ref.seg_spmv_ref(v, c, local, end, x, M, mode))
            for k in (1, 3, 8):
                check_kernel(f"K6[{mode}] {tag} K={k}", ops.seg_spmv_fused(
                    g(v), g(c), g(local), g(end), g(r0), g(x), M,
                    n_rows=1000, mode=mode, tiles_per_step=k, **fused_kw(
                        g(v), g(local), g(end), g(r0), M, 1000, mode)),
                    ref.seg_spmv_fused_ref(v, c, local, end, r0, x, M,
                                           n_rows=1000, mode=mode))
        for T, S, L, M in ((7, 12, 128, 200), (5, 3, 7, 5)):
            local = onehot_rows(rng, T, S * L, M).reshape(T, S, L)
            end = torch.zeros((T, M), dtype=torch.int32)  # one-hot: unread
            v = torch.from_numpy(rng.standard_normal((T, S, L))).to(vd)
            c = torch.from_numpy(rng.integers(0, n_cols, (T, S, L))).to(cd)
            r0 = torch.from_numpy((np.arange(T) * 150).astype(np.int32))
            what = f"{tag} C={S * L} unsorted, rows out of range"
            check_kernel(f"K4 {what}", ops.seg_spmv(
                g(v), g(c), g(local), g(end), g(x), M, mode="onehot_mxu"),
                ref.seg_spmv_ref(v, c, local, end, x, M, "onehot_mxu"))
            for k in (1, 3, 8):
                check_kernel(f"{ONEHOT_K6} {what} K={k}", ops.seg_spmv_fused(
                    g(v), g(c), g(local), g(end), g(r0), g(x), M,
                    n_rows=1000, mode="onehot_mxu", tiles_per_step=k,
                    **fused_kw(g(v), g(local), g(end), g(r0), M, 1000,
                               "onehot_mxu")),
                    ref.seg_spmv_fused_ref(v, c, local, end, r0, x, M,
                                           n_rows=1000, mode="onehot_mxu"))
        for shape in ELL_WIDTHS:
            v, c = ell_case(rng, shape, n_cols, vd, cd)
            check_kernel(f"K1 {tag} {shape}", ops.ell_spmv(g(v), g(c), g(x)),
                         ref.ell_spmv_ref(v, c, x))
            check_kernel(f"K2 {tag} {shape}",
                         ops.ell_spmv_direct(g(v), g(c), g(x)),
                         ref.ell_spmv_direct_ref(v, c, x))
            # K5 adds into a prefilled y from row 11; n_rows cuts a slab
            rows = shape[0] * shape[1]
            n_rows = 11 + rows - min(13, rows // 2)
            y0 = torch.from_numpy(rng.standard_normal(n_rows)).float()
            check_kernel(f"K5 {tag} {shape} K=3", ops.ell_spmv_fused(
                g(v), g(c), g(x), n_rows=n_rows, row0=11, tiles_per_step=3,
                out=g(y0.clone())), ref.ell_spmv_fused_ref(
                    v, c, x, n_rows=n_rows, row0=11, out=y0.clone()))
        for shape in ((3, 24, 9), (1, 24, 400)):
            v, c = ell_case(rng, shape, n_cols, vd, cd)
            far, v0, c0 = out_of_range(rng, v, c, n_cols)
            check_kernel(f"K1 {tag} {shape} columns out of range",
                         ops.ell_spmv(g(v), g(far), g(x)),
                         ref.ell_spmv_ref(v0, c0, x))
        seg_scan_cases(rng, n_cols, vd, cd, x, tag)
    # M = 60000 segments over tiles of C = 8192: shared memory that grew
    # with M refused this launch
    T, S, L, M = 2, 64, 128, 60000
    _, end = seg_case(rng, T, S, L, M)
    v = torch.from_numpy(rng.standard_normal((T, S, L)).astype(np.float32))
    c = torch.from_numpy(rng.integers(0, n_cols, (T, S, L)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal(n_cols).astype(np.float32))
    check_seg_scan(f"C={S * L} M={M}", v, c, end, x, M,
                   torch.tensor([0, 100], dtype=torch.int32), 100 + M, g,
                   ks=(1, 2))
    torch.cuda.synchronize()
    done()


def check_seg_scan(what, v, c, end, x, M, r0, n_rows, g, ks=(1, 3, 8, 16)):
    """K3 and K6 in seg_scan mode (K6 at each tiles_per_step) against
    their plain versions; ``g`` moves a tensor to the card."""
    from repro_torch.kernels import ops, ref
    local = torch.zeros(v.shape, dtype=torch.int32)     # seg_scan: unread
    check_kernel(f"K3 {what}", ops.seg_spmv(
        g(v), g(c), g(local), g(end), g(x), M, mode="seg_scan"),
        ref.seg_spmv_ref(v, c, local, end, x, M, "seg_scan"))
    for k in ks:
        check_kernel(f"K6[seg_scan] {what} K={k}", ops.seg_spmv_fused(
            g(v), g(c), g(local), g(end), g(r0), g(x), M, n_rows=n_rows,
            mode="seg_scan", tiles_per_step=k, **fused_kw(
                g(v), g(local), g(end), g(r0), M, n_rows, "seg_scan")),
            ref.seg_spmv_fused_ref(v, c, local, end, r0, x, M,
                                   n_rows=n_rows, mode="seg_scan"))


# (T, S, L, M) for K3 / K6 in seg_scan mode: C = 21 (scalar loads; a
# thread's 8 slots cross tiles), 512 (a 2048-slot pass spans four tiles),
# 2048 (one tile a pass), 8192 (four passes a tile, with a carry) and
# 12288 (exactly 48 KB of dynamic shared memory beside the kernel's own
# __shared__ arrays: the opt-in); T is not a multiple of tiles_per_step 3,
# 8 or 16
SCAN_WIDTHS = [(37, 3, 7, 5), (37, 4, 128, 60), (9, 16, 128, 300),
               (3, 64, 128, 700), (2, 96, 128, 300)]


def seg_scan_cases(rng, n_cols, vd, cd, x, tag):
    """K3/K6 (seg_scan) at one storage on ends that descend, repeat, pass
    C or fall below 0, and a padding tile; and on the packer's ends at each
    of SCAN_WIDTHS, with the arrays on and off the 16-byte alignment."""
    dev = torch.device("cuda")
    on_card = lambda t: t.to(dev)
    off = lambda t: off_by_one(t, dev)
    operands = lambda T, S, L: (
        torch.from_numpy(rng.standard_normal((T, S, L))).to(vd),
        torch.from_numpy(rng.integers(0, n_cols, (T, S, L))).to(cd))
    T, S, L, M = 7, 4, 128, 24
    r0 = torch.from_numpy((np.arange(T) * 20).astype(np.int32))
    for case in ("descending", "repeated", "past_c", "negative", "mixed",
                 "padding"):
        v, c = operands(T, S, L)
        check_seg_scan(f"{tag} ends {case}", v, c,
                       seg_ends(rng, case, T, S * L, M), x, M, r0, 150,
                       on_card)
    for T, S, L, M in SCAN_WIDTHS:
        _, end = seg_case(rng, T, S, L, M)
        v, c = operands(T, S, L)
        r0 = torch.from_numpy((np.arange(T) * (M // 2)).astype(np.int32))
        for g, how in ((on_card, ""), (off, " unaligned")):
            check_seg_scan(f"{tag} C={S * L} T={T}{how}", v, c, end, x, M,
                           r0, (M // 2) * T + 7, g)


def small_spmm_phase():
    from repro_torch.kernels import ops, ref
    done = phase("2b SpMM kernels on small odd shapes")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n_cols = 5000
    g = lambda t: t.to(dev)
    for (vd, cd, xd), b in [(st, b) for st in STORAGES
                            for b in (1, 3, 8, 17, 40)]:
        tag = f"{str(vd)[6:]}/{str(cd)[6:]}/x:{str(xd)[6:]} B={b}"
        x = torch.from_numpy(rng.standard_normal((n_cols, b))).to(xd)
        T, R, W = 7, 24, 37
        v = torch.from_numpy(rng.standard_normal((T, R, W))).to(vd)
        c = torch.from_numpy(rng.integers(0, n_cols, (T, R, W))).to(cd)
        check_kernel(f"K7 {tag}", ops.ell_spmm(g(v), g(c), g(x)),
                     ref.ell_spmm_ref(v, c, x))
        check_kernel(f"K8 {tag}", ops.ell_spmm_direct(g(v), g(c), g(x)),
                     ref.ell_spmm_direct_ref(v, c, x))
        for k in (1, 3, 8):
            check_kernel(f"K9 {tag} K={k}", ops.ell_spmm_fused(
                g(v), g(c), g(x), n_rows=150, row0=11, tiles_per_step=k),
                ref.ell_spmm_fused_ref(v, c, x, n_rows=150, row0=11))
        T, S, L, M = 7, 12, 128, 200
        local, end = seg_case(rng, T, S, L, M)
        end[-1] = 0                       # a padding tile
        v = torch.from_numpy(rng.standard_normal((T, S, L))).to(vd)
        v[-1] = 0
        c = torch.from_numpy(rng.integers(0, n_cols, (T, S, L))).to(cd)
        r0 = torch.from_numpy((np.arange(T) * 150).astype(np.int32))
        for mode, kid in (("seg_scan", "K10a"), ("onehot_mxu", "K10b")):
            check_kernel(f"{kid} {tag}", ops.seg_spmm(
                g(v), g(c), g(local), g(end), g(x), M, mode=mode),
                ref.seg_spmm_ref(v, c, local, end, x, M, mode))
            for k in (1, 3, 8):
                check_kernel(f"K11[{mode}] {tag} K={k}", ops.seg_spmm_fused(
                    g(v), g(c), g(local), g(end), g(r0), g(x), M,
                    n_rows=1000, mode=mode, tiles_per_step=k, **fused_kw(
                        g(v), g(local), g(end), g(r0), M, 1000, mode)),
                    ref.seg_spmm_fused_ref(v, c, local, end, r0, x, M,
                                           n_rows=1000, mode=mode))
        shapes = ELL_WIDTHS + [ONE_TILE, (40, 128, 20)] if b == 8 else \
            [(1, 24, 400), ONE_TILE]
        for T, R, W in shapes:
            v, c = ell_case(rng, (T, R, W), n_cols, vd, cd)
            n_rows = 11 + T * R - R // 2        # cuts into the last tile
            check_kernel(f"K7 {tag} {(T, R, W)}", ops.ell_spmm(
                g(v), g(c), g(x)), ref.ell_spmm_ref(v, c, x))
            check_kernel(f"K8 {tag} {(T, R, W)}", ops.ell_spmm_direct(
                g(v), g(c), g(x)), ref.ell_spmm_direct_ref(v, c, x))
            check_kernel(f"K9 {tag} {(T, R, W)} K=3", ops.ell_spmm_fused(
                g(v), g(c), g(x), n_rows=n_rows, row0=11, tiles_per_step=3),
                ref.ell_spmm_fused_ref(v, c, x, n_rows=n_rows, row0=11))
        if b == 8:
            v, c = ell_case(rng, ONE_TILE, n_cols, vd, cd)
            far, v0, c0 = out_of_range(rng, v, c, n_cols)
            check_kernel(f"K7 {tag} {ONE_TILE} columns out of range",
                         ops.ell_spmm(g(v), g(far), g(x)),
                         ref.ell_spmm_ref(v0, c0, x))
            # x one element off the vector alignment: one column per lane
            flat = g(torch.cat([x.new_zeros(1), x.reshape(-1)]))
            check_kernel(f"K7 {tag} {ONE_TILE} unaligned x", ops.ell_spmm(
                g(v), g(c), flat[1:].view(x.shape)), ref.ell_spmm_ref(v, c, x))
        seg_spmm_cases(rng, n_cols, vd, cd, xd, b, tag)
    # one tile of C = 8192 slots (LANE_NNZ_BLOCK's largest chunk) at M =
    # 700: a stored (C, B) scan would not fit a block's shared memory, and
    # at B = 40 the (M, B) accumulator passes 48 KB (the opt-in); then one
    # tile's accumulator beyond the block's shared memory (M = 8192 at B =
    # 8: fewer columns a window; M = 60000: part of the segments a window);
    # and C = 512, M = 384, B = 8: a window of four tiles takes exactly 48
    # KB, which with the kernel's own __shared__ array needs the opt-in too
    for (T, S, M, b) in ((3, 64, 700, 8), (3, 64, 700, 40), (3, 64, 8192, 8),
                         (3, 64, 60000, 1), (6, 4, 384, 8)):
        L = 128
        local, end = seg_case(rng, T, S, L, M)
        v = torch.from_numpy(rng.standard_normal((T, S, L)).astype(np.float32))
        c = torch.from_numpy(rng.integers(0, n_cols, (T, S, L)).astype(np.int32))
        x = torch.from_numpy(rng.standard_normal((n_cols, b)).astype(np.float32))
        r0 = torch.from_numpy((np.arange(T) * 600).astype(np.int32))
        for mode, kid in (("seg_scan", "K10a"), ("onehot_mxu", "K10b")):
            what = f"C={S * L} M={M} B={b}"
            check_kernel(f"{kid} {what}", ops.seg_spmm(
                g(v), g(c), g(local), g(end), g(x), M, mode=mode),
                ref.seg_spmm_ref(v, c, local, end, x, M, mode))
            check_kernel(f"K11[{mode}] {what}", ops.seg_spmm_fused(
                g(v), g(c), g(local), g(end), g(r0), g(x), M,
                n_rows=1200 + M, mode=mode, tiles_per_step=3, **fused_kw(
                    g(v), g(local), g(end), g(r0), M, 1200 + M, mode)),
                ref.seg_spmm_fused_ref(v, c, local, end, r0, x, M,
                                       n_rows=1200 + M, mode=mode))
    torch.cuda.synchronize()
    done()


# (n, widths (None: W = n), seeds): n = 20 takes the slab kernel up to
# W = 32 and split rows above; n = 300 is split over 1 to 8 warps
ROW_SUM_CASES = ((20, (None, 24, 32, 40, 64, 200, 400), 8),
                 (300, (None, 304, 400, 512), 3))
ROW_SUM_ROWS = (1, 128, 65536)


def row_sum_bits(n: int, widths, seed: int) -> dict:
    """One random row of n nonzeros, padded with zero slots to each W and
    launched among 1, 128 and 65,536 rows of random others: each of K1,
    K5, K7 and K9 (B = 8)'s set of results for it, the grouped K1 and K7
    (its bucket between two others) adding to K1's and K7's."""
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    n_cols = 5000
    rng = np.random.default_rng(seed)
    row_v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    row_c = torch.from_numpy(rng.integers(0, n_cols, n).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal(n_cols).astype(np.float32))
    x8 = torch.from_numpy(rng.standard_normal((n_cols, 8)).astype(np.float32))
    x, x8 = x.to(dev), x8.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    got = {"K1": set(), "K5": set(), "K7": set(), "K9": set()}
    for W in widths:
        W = W or n
        for rows in ROW_SUM_ROWS:
            vals = torch.randn((rows, 1, W), generator=gen, device=dev)
            cols = torch.randint(0, n_cols, (rows, 1, W), generator=gen,
                                 device=dev, dtype=torch.int32)
            at = rows // 3
            vals[at, 0] = 0.0
            cols[at, 0] = 0
            vals[at, 0, :n] = row_v.to(dev)
            cols[at, 0, :n] = row_c.to(dev)
            got["K1"].add(ops.ell_spmv(vals, cols, x)[at, 0].item())
            got["K5"].add(ops.ell_spmv_fused(vals, cols, x,
                                             n_rows=rows)[at].item())
            got["K7"].add(tuple(ops.ell_spmm(vals, cols, x8)[at, 0].tolist()))
            got["K9"].add(tuple(ops.ell_spmm_fused(vals, cols, x8,
                                                   n_rows=rows)[at].tolist()))
            if grouped_wrappers():
                # buckets of 3 x 40 and 5 x 33 slots on either side
                side = [(torch.randn(s, generator=gen, device=dev),
                         torch.randint(0, n_cols, s, generator=gen,
                                       device=dev, dtype=torch.int32))
                        for s in ((3, 1, 40), (5, 1, 33))]
                group = ops.TileGroup(
                    [side[0][0], vals, side[1][0]],
                    [side[0][1], cols, side[1][1]])
                got["K1"].add(ops.ell_spmv_grouped(group, x)[3 + at].item())
                got["K7"].add(tuple(
                    ops.ell_spmm_grouped(group, x8)[3 + at].tolist()))
    check_kernel(f"K1 row of {n} (seed {seed}) against its plain version",
                 torch.tensor([next(iter(got["K1"]))]),
                 ref.ell_spmv_ref(row_v[None, None], row_c[None, None],
                                  x.cpu()).reshape(1))
    return got


def row_sum_phase():
    """2c. A row's sum depends on its slot values in order only: the
    rows of ``ROW_SUM_CASES`` get one and the same bits from K1 and K5,
    and from K7 and K9 at B = 8, whatever W and the launch."""
    done = phase("2c row sums independent of width and launch")
    distinct = {}
    for n, widths, seeds in ROW_SUM_CASES:
        for seed in range(seeds):
            got = row_sum_bits(n, widths, seed)
            same = got["K1"] == got["K5"] and got["K7"] == got["K9"]
            distinct[f"n={n} seed={seed}"] = dict(
                {k: len(v) for k, v in got.items()}, pairs_equal=same)
    print("row_sums " + json.dumps({
        "widths": {n: [w or n for w in ws] for n, ws, _ in ROW_SUM_CASES},
        "rows": ROW_SUM_ROWS, "distinct_bits": distinct}))
    require(all(d[k] == 1 for d in distinct.values()
                for k in ("K1", "K5", "K7", "K9"))
            and all(d["pairs_equal"] for d in distinct.values()),
            f"a row's sum depends on W or the launch: {distinct}")
    done()


def seg_spmm_cases(rng, n_cols, vd, cd, xd, b, tag):
    """K10a/K10b/K11 on what the packer never writes, at one storage and B:
    one-hot local rows unsorted, of one row, in runs across a thread, a
    warp and a pass, out of range, at C = 21 and 12, and arrays and x off
    the 16-byte alignment; seg_scan ends that descend, repeat, pass C or
    fall below 0, and a padding tile; C = 512 (the searched plan's chunk)
    at tiles_per_step 1, 3, 8 and 16 with T = 37."""
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.standard_normal((n_cols, b))).to(xd)

    def check(what, mode, v, c, local, end, r0, n_rows, M, g, ks=(1, 3, 8)):
        kid = "K10a" if mode == "seg_scan" else "K10b"
        check_kernel(f"{kid} {tag} {what}", ops.seg_spmm(
            g(v), g(c), g(local), g(end), g(x), M, mode=mode),
            ref.seg_spmm_ref(v, c, local, end, x, M, mode))
        for k in ks:
            check_kernel(f"K11[{mode}] {tag} {what} K={k}",
                         ops.seg_spmm_fused(g(v), g(c), g(local), g(end),
                                            g(r0), g(x), M, n_rows=n_rows,
                                            mode=mode, tiles_per_step=k,
                                            **fused_kw(g(v), g(local),
                                                       g(end), g(r0), M,
                                                       n_rows, mode)),
                         ref.seg_spmm_fused_ref(v, c, local, end, r0, x, M,
                                                n_rows=n_rows, mode=mode))

    def operands(T, S, L):
        v = torch.from_numpy(rng.standard_normal((T, S, L))).to(vd)
        c = torch.from_numpy(rng.integers(0, n_cols, (T, S, L))).to(cd)
        return v, c

    on_card = lambda t: t.to(dev)
    off = lambda t: off_by_one(t, dev)
    for case, (T, S, L, M) in (("unsorted", (9, 16, 128, 96)),
                               ("one_row", (9, 16, 128, 96)),
                               ("runs", (9, 16, 128, 96)),
                               ("out_of_range", (9, 16, 128, 96)),
                               ("out_of_range", (9, 3, 7, 5)),
                               ("unsorted", (9, 3, 4, 10)),
                               ("unaligned", (9, 16, 128, 96))):
        v, c = operands(T, S, L)
        local = (seg_case(rng, T, S, L, M)[0] if case == "unaligned" else
                 onehot_rows(rng, T, S * L, M, case).reshape(T, S, L))
        end = torch.zeros((T, M), dtype=torch.int32)     # one-hot: unread
        r0 = torch.from_numpy((np.arange(T) * 50).astype(np.int32))
        check(f"C={S * L} {case}", "onehot_mxu", v, c, local, end, r0, 420,
              M, off if case == "unaligned" else on_card)
    T, S, L, M = 7, 4, 128, 24
    for case in ("descending", "repeated", "past_c", "negative", "mixed",
                 "padding"):
        v, c = operands(T, S, L)
        local = torch.zeros((T, S, L), dtype=torch.int32)  # seg_scan: unread
        r0 = torch.from_numpy((np.arange(T) * 20).astype(np.int32))
        check(f"ends {case}", "seg_scan", v, c, local,
              seg_ends(rng, case, T, S * L, M), r0, 150, M, on_card)
    T, S, L, M = 37, 4, 128, 8
    local, end = seg_case(rng, T, S, L, M)
    v, c = operands(T, S, L)
    r0 = torch.from_numpy((np.arange(T) * 6).astype(np.int32))
    for mode in ("seg_scan", "onehot_mxu"):
        check("C=512 T=37", mode, v, c, local, end, r0, 6 * T, M, on_card,
              ks=(1, 3, 8, 16))


# ----------------------------- phases 3 and 4 -----------------------------

def chain(*ops):
    from repro_torch.core.graph import OperatorGraph
    from repro_torch.design.registry import OpSpec
    return OperatorGraph.chain(*(OpSpec.make(n, **p) for n, p in ops))


def timed(label: str, designer: dict, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    designer[label] = round(time.perf_counter() - t0, 3)
    return out


def searched_phase(B, xb, oracle_b, designer):
    import repro_torch
    done = phase("3 searched compile, banded 2**21")
    cfg = repro_torch.SearchConfig(max_seconds=SEARCH_SECONDS["banded"],
                                   max_structures=1,
                                   coarse_samples=2, fine_eval_budget=0,
                                   use_cost_model=False, timing_repeats=3,
                                   seed=0)
    plan = timed("search banded (wall)", designer, repro_torch.compile, B,
                 repro_torch.Target(), budget=cfg)
    res = plan.search_result
    print(f"  searched {res.n_evaluations} candidates in "
          f"{res.wall_seconds:.1f} s; failures {res.failure_counts}; "
          f"winner {plan.graph.label()} at {res.best_seconds * 1e3:.3f} ms "
          f"({res.gflops:.1f} GFLOP/s)")
    for rec in sorted(res.records, key=lambda r: r.seconds)[:6]:
        print(f"    {rec.seconds * 1e3:9.3f} ms  {rec.graph.label()}")
    require(res.fallback is False, "the searched plan is a fallback")
    bad = {"crash", "wrong_result", "oom"} & set(res.failure_counts)
    require(not bad, f"search failures {bad}")
    y = plan(xb)
    check_oracle("searched plan", y, oracle_b, plan.spec["storage_dtype"])
    scratch = ROOT / "results"               # listed in .gitignore
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        path = Path(d) / "banded.plan.npz"
        plan.save(path)
        loaded = repro_torch.load_plan(path)
        require(sorted(loaded.fmt) == sorted(plan.fmt), "round trip keys")
        for k, a in plan.fmt.items():
            b = loaded.fmt[k]
            require(a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
                    f"round trip changed {k}")
        require(torch.equal(loaded(xb), y), "round trip changed the output")
    print("  save/load round trip: bit-identical arrays and output")
    done()
    return plan


def fixed_phase(B, xb, oracle_b, P, xp, oracle_p, designer):
    import repro_torch
    from repro_torch.core.graph import run_graph
    from repro_torch.core.kernel_builder import build_program
    done = phase("4 fixed-graph compiles")
    progs = {}
    ell = [("COMPRESS", {}), ("TILE_ROW_BLOCK", {"rows": 128}),
           ("LANE_ROW_BLOCK", {})]
    g_grid = chain(*ell, ("LANE_TOTAL_RED", {"combine": "grid_acc"}))
    g_scatter = chain(*ell, ("LANE_TOTAL_RED", {}))
    meta = timed("run_graph banded ELL grid_acc", designer, run_graph, B,
                 g_grid)
    progs["K5 fused K=1"] = repro_torch.compile(B, repro_torch.Target(),
                                                graph=g_grid)
    progs["K5 fused K=8"] = build_program(meta, "cuda", tiles_per_step=8)
    progs["K2 direct"] = build_program(meta, "cuda", fuse_combine=False)
    progs["K5 fused bf16"] = repro_torch.compile(
        B, repro_torch.Target(dtype="bfloat16"), graph=g_grid)
    meta = timed("run_graph banded ELL scatter", designer, run_graph, B,
                 g_scatter)
    progs["K1 scatter"] = build_program(meta, "cuda", fuse_combine=False)
    for name, prog in progs.items():
        check_oracle(f"banded {name}", prog(xb if "bf16" not in name else
                                            xb.to(torch.bfloat16)),
                     oracle_b, prog.spec["storage_dtype"])
    banded = progs
    progs = {}
    for red in ("SEG_SCAN_RED", "ONEHOT_MXU_RED", "GMEM_ATOM_RED"):
        g = chain(("COMPRESS", {}), ("LANE_NNZ_BLOCK", {"chunk": 2048}),
                  (red, {}))
        meta = timed(f"run_graph powerlaw {red}", designer, run_graph, P, g)
        progs[f"{red} fused"] = build_program(meta, "cuda", tiles_per_step=4)
        progs[f"{red} unfused"] = build_program(meta, "cuda",
                                                fuse_combine=False)
        if red == "SEG_SCAN_RED":
            progs[f"{red} fused bf16"] = repro_torch.compile(
                P, repro_torch.Target(dtype="bfloat16"), graph=g)
    for name, prog in progs.items():
        check_oracle(f"powerlaw {name}", prog(xp if "bf16" not in name else
                                              xp.to(torch.bfloat16)),
                     oracle_p, prog.spec["storage_dtype"])
    torch.cuda.synchronize()
    done()
    return banded, progs


BITSTABLE_CALLS = 20


def bitstable_phase(seg, xp):
    """4b. Every phase-4 seg plan (K3, K4, K6 in both modes, the gmem_atom
    steps and the unfused rowmap combines at B = 1; K10a, K10b and K11 at
    B = 8) called BITSTABLE_CALLS times and its saved-and-loaded copy once:
    every output must be bit-identical to the first."""
    import repro_torch
    from repro_torch.api import SpmvPlan, _plan_from_program
    done = phase("4b bit-stable seg plans")
    x8 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (xp.shape[0], 8)).astype(np.float32)).cuda()
    report = {}
    scratch = ROOT / "results"               # listed in .gitignore
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        for name, prog in seg.items():
            plan = (prog if isinstance(prog, SpmvPlan) else
                    _plan_from_program(prog, None, repro_torch.Target()))
            path = Path(d) / "seg.plan.npz"
            plan.save(path)
            loaded = repro_torch.load_plan(path)
            for b, x in ((1, xp), (8, x8)):
                y0 = plan(x)
                differ = sum(not torch.equal(plan(x), y0)
                             for _ in range(BITSTABLE_CALLS - 1))
                require(differ == 0, f"{name} B={b}: {differ} of "
                        f"{BITSTABLE_CALLS - 1} calls differ from the first")
                require(torch.equal(loaded(x), y0),
                        f"{name} B={b}: the loaded plan's output differs")
                if not isinstance(prog, SpmvPlan):
                    require(torch.equal(prog(x), y0),
                            f"{name} B={b}: the program's output differs")
            report[name] = [st.get("fused", False) for st in
                            plan.spec["steps"]]
    print("bitstable " + json.dumps({"calls": BITSTABLE_CALLS, "B": [1, 8],
                                     "plans_fused_steps": report}))
    done()


# -------------------------------- phase 5 ---------------------------------

def _operands(prog, step) -> dict:
    """A spec step's operands (cols materialized if model-elided)."""
    from repro_torch.core.kernel_builder import _step_cols
    fmt = prog.fmt
    key = step["key"]
    return {"vals": fmt[f"{key}_vals"],
            "cols": _step_cols(step, fmt, fmt[f"{key}_vals"].device),
            "local": fmt.get(f"{key}_local"),
            "end": fmt.get(f"{key}_end"), "r0": fmt.get(f"{key}_r0")}


def _step(prog):
    """Spec step 0 and its operands."""
    step = prog.spec["steps"][0]
    return step, _operands(prog, step)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def fused_kw(v, local, end, r0, M: int, n_rows: int, mode: str) -> dict:
    """``rows=`` for a fused seg wrapper (K6 / K11), which it requires on
    the card: the ``FusedRows`` of its operands, built once, as a plan
    builds them, so that a timed call is the kernel's one launch alone."""
    from repro_torch.kernels import combine
    aux = end if mode == "seg_scan" else local
    return {"rows": combine.fused_rows(r0, aux, M, n_rows, mode,
                                       v.shape[1] * v.shape[2])}


def shared_slots(rows) -> tuple:
    """The shared pairs of a ``FusedRows`` and their side slots (a package
    without ``FusedRows.shared_pairs`` codes slot k as -2 - k)."""
    if hasattr(rows, "shared_pairs"):
        return rows.shared_pairs()
    pairs = torch.nonzero(rows.dst <= -2).reshape(-1)
    return pairs, -2 - rows.dst.long()[pairs]


def placed_in_order(rows, part, y):
    """The unfused kernel's partials ``part`` ((T * M,) or (T * M, B))
    placed where a fused step's ``rows`` puts them, in its fixed order:
    each one-writer pair's partial at its row (y[d] + v), then each listed
    row's side slots through ``rowmap_combine`` in perm order. Adds into
    ``y`` and returns it."""
    from repro_torch.kernels import ops
    d = rows.dst.long()
    direct = d >= 0
    y[d[direct]] = y[d[direct]] + part[direct]
    side = torch.empty((rows.n_side,) + tuple(part.shape[1:]),
                       device=part.device)
    pairs, slot = shared_slots(rows)
    side[slot] = part[pairs]
    off = torch.zeros(y.shape[0] + 1, dtype=torch.int64, device=y.device)
    off[rows.rows.long() + 1] = rows.offsets[1:] - rows.offsets[:-1]
    return ops.rowmap_combine(y, side, rows.perm, torch.cumsum(off, 0))


def check_placement(label: str, got: torch.Tensor, want: torch.Tensor,
                    rows_list) -> dict:
    """A fused K6 / K11 call's output bit for bit against the unfused
    kernel's partials placed in order (``placed_in_order``); the fields
    its report line gains: the side slots and the shared rows of its
    steps."""
    require(torch.equal(got, want), f"{label}: the fused kernel differs "
            "from the unfused kernel's partials placed in order")
    out = {"n_side": sum(r.n_side for r in rows_list),
           "shared_rows": sum(int(r.rows.numel()) for r in rows_list),
           "placement_bits_equal": True}
    print(f"  {label}: bit for bit the unfused partials placed in order "
          f"({json.dumps(out)})")
    return out


def kernel_cases(banded, seg, xb, xp, n_b, n_p):
    """For K1-K6: (vals, cols, kernel fn, plain fn, bytes fn, flops,
    matrix, probes, placed) at the operands of a phase-4 plan; ``placed``
    (K6 only, else None) checks a fused call bit for bit against the
    unfused kernel's partials placed in order. The fused kernels
    add into ``out`` (fresh zeros when None); timing reuses one buffer so
    that no memset is timed with them. ``probes`` (K3 and K6 in seg_scan
    mode, else None) run other kernels on the same vals and cols:
    ``gather`` is K1 on them viewed as ELL tiles of 16-slot rows (the same
    bytes and x gathers in K1's structure), ``b1_spmm`` is K10a / K11 at
    B = 1 (the run-keyed design)."""
    from repro_torch.kernels import ops, ref

    def ell(prog_name, kid):
        step, o = _step(banded[prog_name])
        v, c = o["vals"], o["cols"]
        T, R, W = v.shape
        comb = step["combine"]
        flops = 2 * v.numel()
        if kid == "K5":
            rows = min(T * R, n_b - comb["b0"])
            byt = lambda vv, cc: nbytes(vv, cc, xb) + 8 * rows
            k = banded[prog_name].spec["tiles_per_step"]
            run = lambda vv, cc, out=None: ops.ell_spmv_fused(
                vv, cc, xb, n_rows=n_b, row0=comb["b0"], tiles_per_step=k,
                out=out)
            plain = lambda vv, cc: ref.ell_spmv_fused_ref(
                vv, cc, xb, n_rows=n_b, row0=comb["b0"])
        else:
            byt = lambda vv, cc: nbytes(vv, cc, xb) + 4 * T * R
            fn = ops.ell_spmv if kid == "K1" else ops.ell_spmv_direct
            pf = ref.ell_spmv_ref if kid == "K1" else ref.ell_spmv_direct_ref
            run = lambda vv, cc, out=None: fn(vv, cc, xb)
            plain = lambda vv, cc: pf(vv, cc, xb)
        return v, c, run, plain, byt, flops, "banded", None, None

    def segk(prog_name, kid, mode):
        step, o = _step(seg[prog_name])
        v, c, local, end, r0 = (o["vals"], o["cols"], o["local"], o["end"],
                                o["r0"])
        M = step["seg_rows"]
        T = v.shape[0]
        aux = end if mode == "seg_scan" else local
        flops = 2 * v.numel()
        if kid == "K6":
            k = seg[prog_name].spec["tiles_per_step"]
            kw = fused_kw(v, local, end, r0, M, n_p, mode)
            byt = lambda vv, cc: nbytes(vv, cc, aux, r0, xp) + 8 * n_p
            run = lambda vv, cc, out=None: ops.seg_spmv_fused(
                vv, cc, local, end, r0, xp, M, n_rows=n_p, mode=mode,
                tiles_per_step=k, out=out, **kw)
            plain = lambda vv, cc: ref.seg_spmv_fused_ref(
                vv, cc, local, end, r0, xp, M, n_rows=n_p, mode=mode)
            placed = lambda label, vv, cc: check_placement(
                label, run(vv, cc), placed_in_order(
                    kw["rows"], ops.seg_spmv(vv, cc, local, end, xp, M,
                                             mode=mode).reshape(-1),
                    torch.zeros(n_p, device=xp.device)), [kw["rows"]])
        else:
            byt = lambda vv, cc: nbytes(vv, cc, aux, xp) + 4 * T * M
            run = lambda vv, cc, out=None: ops.seg_spmv(vv, cc, local, end,
                                                        xp, M, mode=mode)
            plain = lambda vv, cc: ref.seg_spmv_ref(vv, cc, local, end, xp,
                                                    M, mode)
            placed = None
        probes = None
        if mode == "seg_scan":
            x1 = xp.view(-1, 1)
            if kid == "K6":
                y1 = torch.zeros((n_p, 1), device=xp.device)
                b1 = lambda vv, cc: ops.seg_spmm_fused(
                    vv, cc, local, end, r0, x1, M, n_rows=n_p, mode=mode,
                    tiles_per_step=k, out=y1, **kw)
            else:
                b1 = lambda vv, cc: ops.seg_spmm(vv, cc, local, end, x1, M,
                                                 mode=mode)
            probes = {"gather": lambda vv, cc: ops.ell_spmv(
                vv.view(T, -1, 16), cc.view(T, -1, 16), xp), "b1_spmm": b1}
        return v, c, run, plain, byt, flops, "powerlaw", probes, placed

    return {"K1": ell("K1 scatter", "K1"),
            "K2": ell("K2 direct", "K2"),
            "K3": segk("SEG_SCAN_RED unfused", "K3", "seg_scan"),
            "K4": segk("ONEHOT_MXU_RED unfused", "K4", "onehot_mxu"),
            "K5": ell("K5 fused K=1", "K5"),
            "K6": segk("SEG_SCAN_RED fused", "K6", "seg_scan"),
            ONEHOT_K6: segk("ONEHOT_MXU_RED fused", "K6", "onehot_mxu")}


def csr_on_device(m):
    crow = np.zeros(m.n_rows + 1, np.int64)
    np.cumsum(np.bincount(m.rows, minlength=m.n_rows), out=crow[1:])
    return torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(m.cols.astype(np.int64)),
        torch.from_numpy(m.vals), size=(m.n_rows, m.n_cols),
        check_invariants=True).cuda()


def report_phase(cases, launches, csr, xs, n_rows):
    done = phase("5 kernel report")
    library = {name: cuda_ms(lambda A=A, x=xs[name]: A @ x)
               for name, A in csr.items()}
    library_dev = {name: device_ms(lambda A=A, x=xs[name]: A @ x)
                   for name, A in csr.items()}
    print(f"  library (torch.sparse_csr_tensor @ x) ms: {library}, on the "
          f"card alone: {library_dev}")
    rows = []
    for kid, (v, c, run, plain, byt, flops, mat, probes,
              placed) in cases.items():
        name, source, replaces = KERNELS[kid[:2]]
        err = check_kernel(f"{kid} {name} fp32 {tuple(v.shape)}",
                           run(v, c), plain(v, c))
        shared = placed(kid, v, c) if placed else {}
        v16 = v.to(torch.bfloat16)
        c16 = c.to(torch.int16) if int(c.max()) <= 32767 else c
        check_kernel(f"{kid} {name} bf16/{str(c16.dtype)[6:]}",
                     run(v16, c16), plain(v16, c16))
        out = torch.zeros(n_rows[mat], device=v.device)
        ms = cuda_ms(lambda: run(v, c, out))
        dev_ms = device_ms(lambda: run(v, c, out))
        plain_ms = cuda_ms(lambda: plain(v, c), reps=5)
        b_ms = byt(v, c) / HBM_BYTES_PER_S * 1e3
        f_ms = flops / FP32_FLOPS_PER_S * 1e3
        row = {"name": f"{kid} {name}", "route": "cuda",
               "source": source, "replaces": replaces,
               "launches": launches[kid[:2]], "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(b_ms, f_ms),
               "bound_by": "bytes" if b_ms >= f_ms else "operations",
               "library_ms": library[mat],
               "device_ms": dev_ms,
               "library_device_ms": library_dev[mat],
               "shape": list(v.shape), "matrix": mat,
               "bytes": byt(v, c), **shared}
        if probes:
            row.update(probe_times(probes, v, c))
        if kid == ONEHOT_K6:     # not one of the twelve rows: a line apart
            print(f"{ONEHOT_K6} {json.dumps(row)}")
        else:
            rows.append(row)
        print(f"  {kid}: {ms:.4f} ms ({dev_ms:.4f} on the card), bound "
              f"{max(b_ms, f_ms):.4f} ms ({100 * max(b_ms, f_ms) / ms:.1f}% "
              f"of bound), plain {plain_ms:.4f} ms, library "
              f"{library[mat]:.4f} ms ({library_dev[mat]:.4f}), launches "
              f"{launches[kid[:2]]}")
        if probes:
            local_cols_line(kid, row, run, plain, byt, probes, v,
                            xs[mat].shape[0], n_rows[mat])
    torch.cuda.synchronize()
    done()
    return rows


def probe_times(probes, v, c) -> dict:
    """The card times of a K3 / K6 row's probes on vals ``v``, cols
    ``c``."""
    return {f"{name}_device_ms": device_ms(lambda fn=fn: fn(v, c))
            for name, fn in probes.items()}


def local_cols_line(kid, row, run, plain, byt, probes, v, n_cols,
                    n_rows) -> None:
    """``K3[local_cols] {...}`` / ``K6[local_cols] {...}``: the row's
    kernel on the same vals, seg_end and r0 with ascending columns
    ``cols[t, s] = ((t*C + s) * n_cols) // (T*C)``, so that a warp's x
    gathers hit a few L1 lines; the same byte bound, plain-version check
    and timings as the row. Against the row it splits the x gathers' cost
    from the kernel's structure."""
    n = v.numel()
    cl = (torch.arange(n, device=v.device, dtype=torch.int64) * n_cols
          // n).to(torch.int32).view(v.shape)
    err = check_kernel(f"{kid}[local_cols]", run(v, cl), plain(v, cl))
    out = torch.zeros(n_rows, device=v.device)
    b_ms = byt(v, cl) / HBM_BYTES_PER_S * 1e3
    f_ms = 2 * n / FP32_FLOPS_PER_S * 1e3
    line = {"name": f"{kid}[local_cols] {row['name'].split(' ', 1)[1]}",
            "max_abs_err": err, "ms": cuda_ms(lambda: run(v, cl, out)),
            "device_ms": device_ms(lambda: run(v, cl, out)),
            "plain_ms": cuda_ms(lambda: plain(v, cl), reps=5),
            "bound_ms": max(b_ms, f_ms),
            "bound_by": "bytes" if b_ms >= f_ms else "operations",
            "shape": row["shape"], "bytes": byt(v, cl)}
    line.update(probe_times(probes, v, cl))
    print(f"{kid}[local_cols] {json.dumps(line)}")


def grouped_wrappers() -> tuple:
    """The grouped K1 and K7 wrappers (``ell_spmv_grouped``,
    ``ell_spmm_grouped``), or () in a package without them (the parent in
    an A/B, which runs a plan's buckets one launch each)."""
    from repro_torch.kernels import ops
    if not hasattr(ops, "ell_spmm_grouped"):
        return ()
    return ops.ell_spmv_grouped, ops.ell_spmm_grouped


def grouped_launches() -> dict:
    """The grouped K1 and K7 launches so far (counted under K1 and K7)."""
    return {f"{k}[grouped]": fn.launches
            for k, fn in zip(("K1", "K7"), grouped_wrappers())}


def launch_counts() -> dict:
    from repro_torch.kernels import ops
    g = grouped_launches()
    return {"K1": ops.ell_spmv.launches + g.get("K1[grouped]", 0),
            "K2": ops.ell_spmv_direct.launches,
            "K3": ops.seg_spmv.launches["seg_scan"],
            "K4": ops.seg_spmv.launches["onehot_mxu"],
            "K5": ops.ell_spmv_fused.launches,
            "K6": ops.seg_spmv_fused.launches,
            "K7": ops.ell_spmm.launches + g.get("K7[grouped]", 0),
            "K8": ops.ell_spmm_direct.launches,
            "K9": ops.ell_spmm_fused.launches,
            "K10a": ops.seg_spmm.launches["seg_scan"],
            "K10b": ops.seg_spmm.launches["onehot_mxu"],
            "K11": ops.seg_spmm_fused.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels import ops
    for fn in (ops.ell_spmv, ops.ell_spmv_direct, ops.ell_spmv_fused,
               ops.seg_spmv_fused, ops.ell_spmm, ops.ell_spmm_direct,
               ops.ell_spmm_fused, ops.seg_spmm_fused, *grouped_wrappers()):
        fn.launches = 0
    for fn in (ops.seg_spmv, ops.seg_spmm):
        fn.launches = {m: 0 for m in fn.launches}


# ----------------------------- phases 6 and 7 -----------------------------

def serving_matrix(designer):
    """Qwen3-8B's FFN up-projection (d_ff x d_model, from the reference's
    configs/qwen3_8b.py), random weights from seed 0, magnitude-pruned to
    the serving example's density 0.08."""
    from repro_torch.serve import prune_magnitude
    w = np.random.default_rng(0).standard_normal((12288, 4096),
                                                 dtype=np.float32)
    m = timed("prune_magnitude(12288 x 4096, 0.08)", designer,
              prune_magnitude, w, 0.08)
    print(f"  pruned {m.n_rows}x{m.n_cols} nnz={m.nnz} in "
          f"{designer['prune_magnitude(12288 x 4096, 0.08)']:.2f} s")
    require(m.nnz == int(w.size * 0.08), "prune_magnitude kept the wrong k")
    return m


def oracle_cols(m, xt: np.ndarray) -> np.ndarray:
    """``m.spmm_dense_oracle`` of an (n_cols, n) stack: the same float64
    products, summed by scipy's CSR product (``np.add.at`` over the
    serving matrix's 200 columns took 21 s of the host)."""
    import scipy.sparse as sp
    a = sp.csr_matrix((m.vals.astype(np.float64), (m.rows, m.cols)),
                      shape=(m.n_rows, m.n_cols))
    return np.asarray(a @ xt.astype(np.float64))


def serving_phase(W, designer, store_dir):
    import repro_torch
    from repro_torch.serve import MatvecRequest, PlanExecutor, SpmvEngine
    from repro_torch.serve.engine import _percentile as percentile
    done = phase("6 serving path, pruned 12288x4096 at B=8")
    target = repro_torch.Target(batch_size=SERVE_B)
    cfg = repro_torch.SearchConfig(max_seconds=SEARCH_SECONDS["serving"],
                                   max_structures=2,
                                   coarse_samples=2, fine_eval_budget=0,
                                   use_cost_model=False, timing_repeats=3,
                                   seed=0)
    store = repro_torch.PlanStore(store_dir)
    plan = timed("search serving (wall)", designer, repro_torch.compile, W,
                 target, budget=cfg, store=store)
    res = plan.search_result
    require(res is not None, "the serving compile was a store hit")
    print(f"  searched {res.n_evaluations} candidates in "
          f"{res.wall_seconds:.1f} s; failures {res.failure_counts}; "
          f"winner {plan.graph.label()} at {res.best_seconds * 1e3:.3f} ms "
          f"for B={SERVE_B} ({res.gflops:.1f} GFLOP/s)")
    for rec in sorted(res.records, key=lambda r: r.seconds)[:6]:
        print(f"    {rec.seconds * 1e3:9.3f} ms  {rec.graph.label()}")
    require(res.fallback is False, "the serving plan is a fallback")
    bad = {"crash", "wrong_result", "oom"} & set(res.failure_counts)
    require(not bad, f"search failures {bad}")
    swap_in = timed("compile serving ELL grid_acc (fixed graph)", designer,
                    repro_torch.compile, W, target, graph=chain(
                        ("COMPRESS", {}), ("TILE_ROW_BLOCK", {"rows": 128}),
                        ("LANE_ROW_BLOCK", {}),
                        ("LANE_TOTAL_RED", {"combine": "grid_acc"})))
    ex = PlanExecutor(plan, W, watch=store.watch(W, target, cfg))
    require(ex.buckets == (1, 2, 4, 8), f"buckets {ex.buckets}")
    t0 = time.perf_counter()
    ex.warmup()
    print(f"  warmup of buckets {ex.buckets}: "
          f"{time.perf_counter() - t0:.3f} s")
    eng = SpmvEngine(ex)
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((200, W.n_cols)).astype(np.float32)
    reqs = [MatvecRequest(i, xs[i]) for i in range(200)]
    waves, lo, wall, wave_ms = (13, 5, 1, 2, 3, 176), 0, 0.0, []
    for i, n in enumerate(waves):
        if i == 2:       # a fixed-graph plan lands under the serving key
            store.put(W, target, cfg, None, swap_in)
        if i == 4:       # ... and the searched plan comes back
            store.put(W, target, cfg, None, plan)
        out = eng.run(reqs[lo:lo + n])
        lo += n
        wall += out["wall_s"]
        wave_ms.append(out["wall_s"] * 1e3)
        print(f"  wave of {n}: {out['wall_s'] * 1e3:.2f} ms, hot_swaps "
              f"{out['hot_swaps']}, health {out['health']}")
    torch.cuda.synchronize()
    require(all(r.status == "ok" for r in reqs), "a request is not ok")
    require(eng.failed == 0, f"{eng.failed} failed requests")
    dropped = sum(r.status == "pending" for r in reqs)
    require(dropped == 0, f"{dropped} dropped requests")
    require(eng.hot_swaps >= 1, "no hot-swap happened under load")
    t0 = time.perf_counter()
    oracle = oracle_cols(W, xs.T)
    designer["oracle serving (200 columns)"] = round(
        time.perf_counter() - t0, 3)
    got = np.stack([r.y for r in reqs], axis=1)
    check_oracle("served answers (n_rows, 200)", torch.from_numpy(got),
                 oracle, plan.spec["storage_dtype"])
    lats = sorted(r.latency_s for r in reqs)
    stats = {"requests": len(reqs), "wall_s": wall,
             "throughput_rps": len(reqs) / wall,
             "latency_p50_ms": percentile(lats, 50) * 1e3,
             "latency_p99_ms": percentile(lats, 99) * 1e3,
             "wave_ms": dict(zip(map(str, waves), wave_ms)),
             # the last wave (22 full buckets) has no hot-swap in it
             "steady_rps": waves[-1] / (wave_ms[-1] / 1e3),
             "hot_swaps": eng.hot_swaps,
             "rejected_swaps": ex.rejected_swaps,
             "failed": eng.failed, "dropped": dropped,
             "winner": plan.graph.label(),
             "winner_ms": res.best_seconds * 1e3,
             "swapped_in": swap_in.graph.label()}
    print("serving " + json.dumps(stats))
    done()
    return plan, swap_in, oracle[:, :SERVE_B], xs[:SERVE_B].T.copy()


def spmm_fixed_phase(W, swap_in, x8, oracle8, designer):
    import repro_torch
    from repro_torch.core.graph import run_graph
    from repro_torch.core.kernel_builder import build_program
    done = phase("7 fixed-graph SpMM compiles at B=8")
    xd = torch.from_numpy(x8).cuda()
    ell = [("COMPRESS", {}), ("TILE_ROW_BLOCK", {"rows": 128}),
           ("LANE_ROW_BLOCK", {})]
    g_grid = chain(*ell, ("LANE_TOTAL_RED", {"combine": "grid_acc"}))
    progs = {}
    meta = timed("run_graph serving ELL scatter", designer, run_graph, W,
                 chain(*ell, ("LANE_TOTAL_RED", {})))
    progs["K7 scatter"] = build_program(meta, "cuda", fuse_combine=False)
    meta = timed("run_graph serving ELL grid_acc", designer, run_graph, W,
                 g_grid)
    progs["K8 direct"] = build_program(meta, "cuda", fuse_combine=False)
    progs["K9 fused K=1"] = swap_in
    progs["K9 fused K=8"] = build_program(meta, "cuda", tiles_per_step=8)
    progs["K9 fused bf16"] = repro_torch.compile(
        W, repro_torch.Target(batch_size=SERVE_B, dtype="bfloat16"),
        graph=g_grid)
    # the tiles' widths (358-397 here) fall into 26 buckets, and only the
    # single-tile buckets have contiguous rows; padding every width to 400
    # makes one bucket of all 96 tiles, so K8 and K9 also run over the
    # whole matrix in one launch (the operands of their report rows)
    meta = timed("run_graph serving ELL grid_acc pad 400", designer,
                 run_graph, W, chain(*ell[:2], ("LANE_PAD", {"pad_to": 400}),
                                     *ell[2:], ("LANE_TOTAL_RED",
                                                {"combine": "grid_acc"})))
    progs["K8 direct padded"] = build_program(meta, "cuda",
                                              fuse_combine=False)
    progs["K9 fused padded"] = build_program(meta, "cuda")
    for red in ("SEG_SCAN_RED", "ONEHOT_MXU_RED", "GMEM_ATOM_RED"):
        g = chain(("COMPRESS", {}), ("LANE_NNZ_BLOCK", {"chunk": 2048}),
                  (red, {}))
        meta = timed(f"run_graph serving {red}", designer, run_graph, W, g)
        progs[f"{red} fused"] = build_program(meta, "cuda", tiles_per_step=4)
        progs[f"{red} unfused"] = build_program(meta, "cuda",
                                                fuse_combine=False)
    for name, prog in progs.items():
        y = prog(xd if "bf16" not in name else xd.to(torch.bfloat16))
        check_oracle(f"serving {name} ({len(prog.spec['steps'])} steps)", y,
                     oracle8, prog.spec["storage_dtype"])
    # ... and the scatter plan with a 1-D x (K1 over its buckets)
    check_oracle("serving K7 scatter, 1-D x", progs["K7 scatter"](
        xd[:, 0].contiguous()), oracle8[:, 0], "float32")
    torch.cuda.synchronize()
    done()
    return progs, xd


# -------------------------------- phase 8 ---------------------------------

def spmm_cases(progs, xd, n_rows):
    """For K7-K11: the spec steps of a phase-7 plan that dispatch to the
    kernel, as (run, plain, bytes, flops, shape) over all of them (an ELL
    plan has one step per tile-width bucket). ``run(vals_list)`` launches
    the kernel once per step, K7 once for all its steps (the grouped
    launch, where the package has it: its per-bucket launches are
    ``per_bucket``); the fused kernels add into ``out``."""
    from repro_torch.kernels import ops, ref
    B = xd.shape[1]
    x_bytes = nbytes(xd)

    def ell(prog_name, kid):
        prog = progs[prog_name]
        steps = []
        for step in prog.spec["steps"]:
            comb = step["combine"]
            affine = comb["mode"] == "affine"
            fused = bool(step.get("fused")) and affine
            direct = affine and comb["direct"] and not fused
            if {"K7": not fused and not direct, "K8": direct,
                    "K9": fused}[kid]:
                steps.append((step, _operands(prog, step)))
        require(steps, f"{prog_name} has no step for {kid}")
        k = prog.spec["tiles_per_step"]

        def launch(fused, unfused, vals, cols, out):
            """One call per step: the fused kernel adds every step into
            ``out`` (fresh zeros when None); the others are concatenated."""
            if kid != "K9":
                return torch.cat([unfused(v, c, xd).reshape(-1, B)
                                  for v, c in zip(vals, cols)])
            if out is None:
                out = torch.zeros((n_rows, B), device=xd.device)
            for (step, _), v, c in zip(steps, vals, cols):
                fused(v, c, step["combine"]["b0"], out)
            return out

        kern = {"K7": ops.ell_spmm, "K8": ops.ell_spmm_direct}.get(kid)
        plain = {"K7": ref.ell_spmm_ref,
                 "K8": ref.ell_spmm_direct_ref}.get(kid)
        fused_kern = lambda v, c, b0, out: ops.ell_spmm_fused(
            v, c, xd, n_rows=n_rows, row0=b0, tiles_per_step=k, out=out)
        fused_plain = lambda v, c, b0, out: ref.ell_spmm_fused_ref(
            v, c, xd, n_rows=n_rows, row0=b0, out=out)
        vals = [o["vals"] for _, o in steps]
        cols = [o["cols"] for _, o in steps]
        rows = sum(v.shape[0] * v.shape[1] for v in vals)
        out_bytes = (8 if kid == "K9" else 4) * rows * B
        run = lambda vs, cs, out=None: launch(fused_kern, kern, vs, cs, out)
        plain_run = lambda vs, cs: launch(fused_plain, plain, vs, cs, None)
        extra = {}
        if kid == "K7":
            # the plan runs its buckets as one grouped launch (where the
            # package has it); the per-bucket launches are timed beside
            extra = {"prog": prog, "per_bucket": run}
            if grouped_wrappers():
                group = ops.TileGroup(vals, cols)
                run = lambda vs, cs, out=None: ops.ell_spmm_grouped(
                    group if vs is vals else ops.TileGroup(vs, cs), xd)
                plain_run = lambda vs, cs: ref.ell_spmm_grouped_ref(vs, cs,
                                                                    xd)
        return {"vals": vals, "cols": cols, "run": run, "plain": plain_run,
                **extra,
                "bytes": lambda vs, cs: nbytes(*vs, *cs) + x_bytes
                + out_bytes,
                "flops": 2 * sum(v.numel() for v in vals) * B,
                "shape": f"{len(vals)} steps, T={sum(v.shape[0] for v in vals)}"
                         f", R={vals[0].shape[1]}, W={min(v.shape[2] for v in vals)}"
                         f"-{max(v.shape[2] for v in vals)}"}

    def segk(prog_name, kid, mode):
        prog = progs[prog_name]
        step = prog.spec["steps"][0]
        require(len(prog.spec["steps"]) == 1, f"{prog_name}: one seg step")
        o = _operands(prog, step)
        local, end, r0 = o["local"], o["end"], o["r0"]
        M = step["seg_rows"]
        aux = end if mode == "seg_scan" else local
        v0 = o["vals"]
        T = v0.shape[0]
        k = prog.spec["tiles_per_step"]
        if kid == "K11":
            kw = fused_kw(v0, local, end, r0, M, n_rows, mode)
            run = lambda vs, cs, out=None: ops.seg_spmm_fused(
                vs[0], cs[0], local, end, r0, xd, M, n_rows=n_rows,
                mode=mode, tiles_per_step=k, out=out, **kw)
            plain = lambda vs, cs: ref.seg_spmm_fused_ref(
                vs[0], cs[0], local, end, r0, xd, M, n_rows=n_rows,
                mode=mode)
            placed = lambda label, vs, cs: check_placement(
                label, run(vs, cs), placed_in_order(
                    kw["rows"], ops.seg_spmm(vs[0], cs[0], local, end, xd,
                                             M, mode=mode).reshape(-1, B),
                    torch.zeros((n_rows, B), device=xd.device)),
                [kw["rows"]])
            out_bytes = 8 * n_rows * B
        else:
            run = lambda vs, cs, out=None: ops.seg_spmm(
                vs[0], cs[0], local, end, xd, M, mode=mode)
            plain = lambda vs, cs: ref.seg_spmm_ref(vs[0], cs[0], local,
                                                    end, xd, M, mode)
            placed = None
            out_bytes = 4 * T * M * B
        return {"vals": [v0], "cols": [o["cols"]], "run": run,
                "plain": plain, "placed": placed,
                "bytes": lambda vs, cs: nbytes(*vs, *cs, aux, r0 if kid ==
                                               "K11" else None)
                + x_bytes + out_bytes,
                "flops": 2 * v0.numel() * B,
                "shape": f"T={T}, S={v0.shape[1]}, L={v0.shape[2]}, M={M}"}

    return {"K7": ell("K7 scatter", "K7"),
            "K8": ell("K8 direct padded", "K8"),
            "K9": ell("K9 fused padded", "K9"),
            "K10a": segk("SEG_SCAN_RED unfused", "K10a", "seg_scan"),
            "K10b": segk("ONEHOT_MXU_RED unfused", "K10b", "onehot_mxu"),
            "K11": segk("SEG_SCAN_RED fused", "K11", "seg_scan")}


def host_us(calls, reps: int = 10) -> float:
    """The host time of ``calls`` (a list of thunks) on the host clock
    before any synchronise, over their number, in us; median of
    ``reps``."""
    per_call = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for call in calls:
            call()
        per_call.append((time.perf_counter() - t0) / len(calls) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def k7_host_and_one_tile(vals, cols, xd) -> dict:
    """The K7 wrapper's host time per call (the plan's per-bucket calls,
    and the grouped call where the package has it) and one single-tile
    launch on the card alone."""
    from repro_torch.kernels import ops
    out = {"host_us_per_call": host_us([
        lambda v=v, c=c: ops.ell_spmm(v, c, xd) for v, c in zip(vals, cols)]),
        "host_calls": len(vals)}
    if grouped_wrappers():
        group = ops.TileGroup(vals, cols)
        out["grouped_host_us_per_call"] = host_us(
            [lambda: ops.ell_spmm_grouped(group, xd)])
    i = min(range(len(vals)), key=lambda k: vals[k].shape[0])
    require(vals[i].shape[0] == 1, "the ELL plan has no single-tile step")
    out["one_tile_ms"] = device_ms(lambda: ops.ell_spmm(vals[i], cols[i], xd))
    out["one_tile_shape"] = list(vals[i].shape)
    return out


def plan_calls(prog, x) -> dict:
    """A plan's call as a caller sees it and on the card, and its
    launches a call (kernel and combine), beside the per-step loop of the
    same program (one launch and one combine a step); in a package
    without grouped launches the call is that loop."""
    out = {"plan_ms": cuda_ms(lambda: prog(x)),
           "plan_device_ms": device_ms(lambda: prog(x)),
           "plan_launches": launches_of(lambda: prog(x))}
    if grouped_wrappers():
        from repro_torch.core.kernel_builder import ELL_GROUPS
        order = {k: v for k, v in prog.order.items() if k != ELL_GROUPS}
        loop = lambda: prog.fn(prog.fmt, x, order)
        require(torch.equal(prog(x), loop()),
                "the grouped plan call differs from the per-step loop")
        out.update(per_step_ms=cuda_ms(loop),
                   per_step_device_ms=device_ms(loop),
                   per_step_launches=launches_of(loop))
    return out


def k1_grouped_line(prog, x1, csr, launches: int) -> dict:
    """K1 on the phase-7 ELL scatter plan with a 1-D x: its buckets (all
    wider than 32 slots) in one grouped launch (where the package has it,
    else their per-bucket launches), held to the plain version in fp32
    and bf16/int16, timed beside the per-bucket launches, the plan call
    beside the per-step loop, and cuSPARSE SpMV (``csr @ x``); a ``K1
    [grouped] {...}`` line, and its row for the kernels line."""
    from repro_torch.kernels import ops, ref
    steps = [st for st in prog.spec["steps"] if st["kind"] == "ell"]
    vals = [prog.fmt[f"{st['key']}_vals"] for st in steps]
    cols = [_operands(prog, st)["cols"] for st in steps]
    require(min(v.shape[2] for v in vals) > 32,
            "a bucket of the serving plan is 32 slots wide or less")
    per_bucket = lambda vs, cs: torch.cat([ops.ell_spmv(v, c, x1).reshape(-1)
                                           for v, c in zip(vs, cs)])
    run = per_bucket
    plain = lambda vs, cs: torch.cat([ref.ell_spmv_ref(v, c, x1).reshape(-1)
                                      for v, c in zip(vs, cs)])
    if grouped_wrappers():
        group = ops.TileGroup(vals, cols)
        run = lambda vs, cs: ops.ell_spmv_grouped(
            group if vs is vals else ops.TileGroup(vs, cs), x1)
        plain = lambda vs, cs: ref.ell_spmv_grouped_ref(vs, cs, x1)
    err = check_kernel("K1[grouped] fp32", run(vals, cols),
                       plain(vals, cols))
    v16 = [v.to(torch.bfloat16) for v in vals]
    c16 = [c.to(torch.int16) for c in cols]
    check_kernel("K1[grouped] bf16/int16", run(v16, c16), plain(v16, c16))
    require(torch.equal(run(vals, cols), per_bucket(vals, cols)),
            "K1[grouped]: a row differs from its bucket's own launch")
    rows = sum(v.shape[0] * v.shape[1] for v in vals)
    byt = nbytes(*vals, *cols, x1) + 4 * rows
    b_ms = byt / HBM_BYTES_PER_S * 1e3
    f_ms = 2 * sum(v.numel() for v in vals) / FP32_FLOPS_PER_S * 1e3
    line = {"name": "K1[grouped] ell_spmv_grouped", "route": "cuda",
            "source": KERNELS["K1"][1], "replaces": KERNELS["K1"][2],
            "launches": launches, "max_abs_err": err,
            "ms": cuda_ms(lambda: run(vals, cols)),
            "device_ms": device_ms(lambda: run(vals, cols)),
            "plain_ms": cuda_ms(lambda: plain(vals, cols), reps=5),
            "bound_ms": max(b_ms, f_ms),
            "bound_by": "bytes" if b_ms >= f_ms else "operations",
            "library_ms": cuda_ms(lambda: csr @ x1),
            "library_device_ms": device_ms(lambda: csr @ x1),
            "per_bucket_ms": cuda_ms(lambda: per_bucket(vals, cols)),
            "per_bucket_device_ms": device_ms(
                lambda: per_bucket(vals, cols)),
            "grouped": bool(grouped_wrappers()),
            "shape": f"{len(vals)} steps, T={sum(v.shape[0] for v in vals)}"
                     f", R={vals[0].shape[1]}, W={min(v.shape[2] for v in vals)}"
                     f"-{max(v.shape[2] for v in vals)}",
            "matrix": "qwen3_8b_ffn_up_pruned_0.08", "B": 1, "bytes": byt,
            **plan_calls(prog, x1)}
    print(f"K1[grouped] {json.dumps(line)}")
    return line


def spmm_report_phase(cases, launches, csr, xd, n_rows):
    done = phase("8 SpMM kernel report")
    library = cuda_ms(lambda: csr @ xd)
    library_dev = device_ms(lambda: csr @ xd)
    print(f"  library (torch.sparse_csr_tensor @ X, X {tuple(xd.shape)}) "
          f"ms: {library:.4f} ({library_dev:.4f} on the card alone)")
    rows = []
    for kid, case in cases.items():
        name, source, replaces = KERNELS[kid]
        vs, cs = case["vals"], case["cols"]
        err = check_kernel(f"{kid} {name} fp32 ({case['shape']})",
                           case["run"](vs, cs), case["plain"](vs, cs))
        v16 = [v.to(torch.bfloat16) for v in vs]
        c16 = [c.to(torch.int16) for c in cs]
        check_kernel(f"{kid} {name} bf16/int16", case["run"](v16, c16),
                     case["plain"](v16, c16))
        shared = (case["placed"](kid, vs, cs) if case.get("placed")
                  else {})
        out = torch.zeros((n_rows, xd.shape[1]), device=xd.device)
        ms = cuda_ms(lambda: case["run"](vs, cs, out))
        dev_ms = device_ms(lambda: case["run"](vs, cs, out))
        plain_ms = cuda_ms(lambda: case["plain"](vs, cs), reps=5)
        byt = case["bytes"](vs, cs)
        b_ms = byt / HBM_BYTES_PER_S * 1e3
        f_ms = case["flops"] / FP32_FLOPS_PER_S * 1e3
        rows.append({"name": f"{kid} {name}", "route": "cuda",
                     "source": source, "replaces": replaces,
                     "launches": launches[kid], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(b_ms, f_ms),
                     "bound_by": "bytes" if b_ms >= f_ms else "operations",
                     "library_ms": library, "device_ms": dev_ms,
                     "library_device_ms": library_dev,
                     "shape": case["shape"],
                     "matrix": "qwen3_8b_ffn_up_pruned_0.08",
                     "B": int(xd.shape[1]), "bytes": byt, **shared})
        if kid == "K7":
            rows[-1].update(k7_host_and_one_tile(vs, cs, xd))
            rows[-1].update(
                grouped=bool(grouped_wrappers()),
                per_bucket_ms=cuda_ms(lambda: case["per_bucket"](vs, cs)),
                per_bucket_device_ms=device_ms(
                    lambda: case["per_bucket"](vs, cs)),
                **plan_calls(case["prog"], xd))
        print(f"  {kid}: {ms:.4f} ms ({dev_ms:.4f} on the card), bound "
              f"{max(b_ms, f_ms):.4f} ms ({100 * max(b_ms, f_ms) / ms:.1f}% "
              f"of bound), plain {plain_ms:.4f} ms, library {library:.4f} "
              f"ms ({library_dev:.4f}), launches {launches[kid]}")
        if kid == "K7":
            r = rows[-1]
            print(f"  K7 host per wrapper call {r['host_us_per_call']:.1f} "
                  f"us over {len(vs)} calls; one tile "
                  f"{tuple(r['one_tile_shape'])} {r['one_tile_ms']:.4f} ms "
                  f"on the card; per bucket {r['per_bucket_ms']:.4f} ms "
                  f"({r['per_bucket_device_ms']:.4f}); plan call "
                  f"{r['plan_ms']:.4f} ms ({r['plan_device_ms']:.4f}), "
                  f"launches {r['plan_launches']}")
    torch.cuda.synchronize()
    done()
    return rows


def searched_seg_line(plan, xd, n_rows, launches, csr) -> None:
    """The K11 time at the operands serving runs: each fused seg step of
    the searched B = 8 plan (its chunk, its tiles_per_step), on a line of
    its own, ``K11[searched] {...}``, outside the twelve rows, beside
    cuSPARSE SpMM on the serving matrix (``csr @ X``). An ELL
    plan, or a seg step without the fused combine, runs no K11: one line
    says so."""
    from repro_torch.kernels import ops, ref
    steps = [st for st in plan.spec["steps"] if st["kind"] == "seg"]
    fused = [st for st in steps
             if st.get("fused") and f"{st['key']}_r0" in plan.fmt]
    if not fused:
        print(f"  {SEARCHED_K11}: the searched plan {plan.graph.label()} has "
              f"{len(steps)} seg steps and no fused one; no K11 to time")
        return
    B = xd.shape[1]
    k = plan.spec["tiles_per_step"]
    ops_ = [_operands(plan, st) for st in fused]
    modes = ["seg_scan" if st["reduce"] == "gmem_atom" else st["reduce"]
             for st in fused]
    kws = [fused_kw(o["vals"], o["local"], o["end"], o["r0"],
                    st["seg_rows"], n_rows, mode)
           for st, o, mode in zip(fused, ops_, modes)]

    def run(out=None, plain=False):
        fn = ref.seg_spmm_fused_ref if plain else ops.seg_spmm_fused
        if out is None:
            out = torch.zeros((n_rows, B), device=xd.device)
        for st, o, mode, kw in zip(fused, ops_, modes, kws):
            extra = {} if plain else {"tiles_per_step": k, **kw}
            fn(o["vals"], o["cols"], o["local"], o["end"], o["r0"], xd,
               st["seg_rows"], n_rows=n_rows, mode=mode, out=out, **extra)
        return out

    err = check_kernel(f"{SEARCHED_K11} {plan.graph.label()}", run(),
                       run(plain=True))
    want = torch.zeros((n_rows, B), device=xd.device)
    for st, o, mode, kw in zip(fused, ops_, modes, kws):
        placed_in_order(kw["rows"], ops.seg_spmm(
            o["vals"], o["cols"], o["local"], o["end"], xd, st["seg_rows"],
            mode=mode).reshape(-1, B), want)
    shared = check_placement(SEARCHED_K11, run(), want,
                             [kw["rows"] for kw in kws])
    out = torch.zeros((n_rows, B), device=xd.device)
    ms = cuda_ms(lambda: run(out))
    dev_ms = device_ms(lambda: run(out))
    plain_ms = cuda_ms(lambda: run(plain=True), reps=5)
    byt = sum(nbytes(o["vals"], o["cols"], o["end"] if m == "seg_scan"
                     else o["local"], o["r0"]) for o, m in zip(ops_, modes))
    byt += nbytes(xd) + 8 * n_rows * B
    flops = 2 * B * sum(o["vals"].numel() for o in ops_)
    b_ms = byt / HBM_BYTES_PER_S * 1e3
    f_ms = flops / FP32_FLOPS_PER_S * 1e3
    line = {"name": f"{SEARCHED_K11} seg_spmm_fused", "graph":
            plan.graph.label(), "modes": modes, "tiles_per_step": k,
            "launches": launches["K11"], "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": max(b_ms, f_ms),
            "bound_by": "bytes" if b_ms >= f_ms else "operations",
            "library_ms": cuda_ms(lambda: csr @ xd),
            "library_device_ms": device_ms(lambda: csr @ xd),
            "bytes": byt, "B": int(B),
            "shape": [list(o["vals"].shape) + [st["seg_rows"]]
                      for o, st in zip(ops_, fused)],
            "storage": plan.spec["storage_dtype"], **shared}
    print(f"{SEARCHED_K11} {json.dumps(line)}")


def dense_plans_line(plans, seg, xp, n_p: int, launches: int) -> dict:
    """Where dense plans run their rowmap combines: the call time of each
    plan in ``plans`` (name -> (plan, x at B = 1, x at B = 8)) as a caller
    sees it and on the card; and the combine alone at the unfused seg_scan
    plan's shape (its rowmap, its K3 partials on the power-law ``xp``),
    with ``launches``, the combine's launches on the compile and serving
    paths: a ``dense_plans {...}`` line; returns the combine's kernels-line
    row at that shape (``combine_entry``)."""
    from repro_torch.kernels import ops
    out = {}
    for name, (plan, x1, x8) in plans.items():
        for b, x in ((1, x1), (8, x8)):
            out[f"{name} B={b}"] = {"ms": cuda_ms(lambda: plan(x)),
                                    "device_ms": device_ms(lambda: plan(x))}
    prog = seg["SEG_SCAN_RED unfused"]
    step, o = _step(prog)
    rm = prog.fmt[f"{step['key']}_rowmap"]
    flat = ops.seg_spmv(o["vals"], o["cols"], o["local"], o["end"],
                        xp, step["seg_rows"], mode="seg_scan").reshape(-1)
    order = ops.combine_order(rm, n_p)
    row = combine_entry("dense B=1", flat, order, rm, launches,
                        "powerlaw (SEG_SCAN_RED unfused plan)")
    out["combine"] = {k: row[k] for k in (
        "shape", "max_abs_err", "launches", "ms", "device_ms", "plain_ms",
        "bound_ms", "bytes", "library_ms", "library_device_ms",
        "max_run")}
    print("dense_plans " + json.dumps(out))
    return row


# -------------------------------- phase 9 ---------------------------------

BASELINE_LIMIT = 16e9            # bytes a baseline format may take on the card


def baseline_bytes(name: str, m) -> int:
    """The stored bytes of baseline ``name`` for ``m``, from its row lengths
    alone (the builders' layouts; nothing is built). Phase 9 leaves out a
    format above ``BASELINE_LIMIT`` and holds every built one to this."""
    lengths = m.row_lengths().astype(np.int64)
    n, nnz = m.n_rows, m.nnz
    if name in ("CSR", "COO"):
        return 12 * nnz
    if name == "ELL":
        return 8 * n * (int(lengths.max()) if nnz else 1)
    if name == "Merge":
        return 12 * (-(-max(nnz, 1) // 1024) * 1024)
    if name == "HYB":
        w = max(1, int(np.percentile(lengths, 75)))
        return 8 * n * w + 12 * int(np.maximum(lengths - w, 0).sum())
    if name == "SELL":              # C = 8 rows a slice, sigma = 16 slices
        srt = lengths[np.lexsort((-lengths, np.arange(n) // 128))]
        n_sl = -(-n // 8)
        pad = np.zeros(n_sl * 8, np.int64)
        pad[:n] = srt
        widths = np.maximum(pad.reshape(n_sl, 8).max(1), 1)
        return int(64 * widths.sum()) + 32 * n_sl
    if name == "ACSR":
        logs = np.ceil(np.log2(np.maximum(lengths, 1))).astype(np.int64)
        return sum(int((logs == lv).sum())
                   * (8 * max(1, int(lengths[logs == lv].max())) + 4)
                   for lv in np.unique(logs))
    if name == "CSR-Adaptive":      # greedy blocks of >= 256 nnz
        csum = np.concatenate([[0], np.cumsum(lengths)])
        bounds = [0]
        while bounds[-1] < n:
            j = int(np.searchsorted(csum, csum[bounds[-1]] + 256))
            if j > n:
                break
            bounds.append(j)
        if bounds[-1] != n:
            bounds.append(n)
        blk = csum[bounds[1:]] - csum[bounds[:-1]]
        return 12 * (len(bounds) - 1) * int(blk.max())
    raise KeyError(name)


def pfs_seconds(fn, repeats: int = 3) -> float:
    """Best of ``repeats`` host-clock times of ``fn()`` with the card
    synchronised before and after: the Perfect Format Selector's timer."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def card_ms(fn, reps: int = 20):
    """``device_ms`` of a baseline, or None where the host cannot get
    ahead of the card: a call of more launches than the card's launch
    queue holds (SELL's and ACSR's loops over width buckets on the
    powerlaw matrix) blocks the host behind the sleep kernel, however
    long it sleeps."""
    try:
        return device_ms(fn, reps=reps, max_cycles=1 << 28)
    except SmokeFailure:
        return None


def reps_for(fn) -> int:
    """Timing repeats for a call: 20, fewer when one call takes more than
    10 ms (the slowest baselines take hundreds), at least 3."""
    one = cuda_ms(fn, reps=1, warmup=1)
    return int(min(20, max(3, 200.0 / max(one, 1e-3))))


def baselines_phase(cases) -> None:
    """Every baseline format on each matrix, checked and timed, then the
    Perfect Format Selector over the built ones beside the port's plan.
    ``cases``: name -> (matrix, x on the card, float64 oracle, {label:
    plan}); the fastest plan by ``cuda_ms`` is the port's entry."""
    from repro_torch.sparse import (BASELINES, PerfectFormatSelector,
                                    build_baseline)
    done = phase("9 baselines and the Perfect Format Selector")
    for mat, (m, xd, oracle, plans) in cases.items():
        line, built, left_out = {}, [], {}
        for name in BASELINES:
            est = baseline_bytes(name, m)
            if est > BASELINE_LIMIT:
                left_out[name] = est
                print(f"  {mat} {name}: left out, {est / 1e9:.1f} GB on "
                      "the card")
                continue
            t0 = time.perf_counter()
            f = build_baseline(name, m)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            require(f.stored_bytes == est,
                    f"{mat} {name}: {f.stored_bytes} stored bytes, "
                    f"{est} counted from the row lengths")
            check_oracle(f"{mat} {name}", f(xd), oracle, "float32")
            fn = lambda f=f: f(xd)
            reps = reps_for(fn)
            line[name] = {"ms": cuda_ms(fn, reps=reps),
                          "device_ms": card_ms(fn, reps=reps),
                          "stored_bytes": f.stored_bytes,
                          "padded_nnz": f.padded_nnz, "arrays": len(f.fmt),
                          "build_s": build_s}
            built.append(name)
            del f, fn
            torch.cuda.empty_cache()
        print(f"baselines {json.dumps({'matrix': mat, 'nnz': m.nnz, 'formats': line, 'left_out_bytes': left_out})}")
        require(built, f"{mat}: no baseline was built")
        t0 = time.perf_counter()
        res = PerfectFormatSelector(candidates=built).select(
            m, xd.cpu().numpy())
        pfs_s = time.perf_counter() - t0
        win = res.best_format
        ours = {label: cuda_ms(lambda p=p: p(xd)) for label, p in
                plans.items()}
        label = min(ours, key=ours.get)
        plan = plans[label]
        check_oracle(f"{mat} plan {label}", plan(xd), oracle,
                     plan.spec["storage_dtype"])
        out = {"matrix": mat, "winner": res.best_name,
               "winner_s": res.best_seconds, "all_s": res.all_seconds,
               "winner_ms": cuda_ms(lambda: win(xd), reps=reps_for(
                   lambda: win(xd))),
               "winner_device_ms": card_ms(lambda: win(xd)),
               "pfs_wall_s": pfs_s, "plan": label,
               "plan_s": pfs_seconds(lambda: plan(xd)),
               "plan_ms": ours[label],
               "plan_device_ms": device_ms(lambda: plan(xd)),
               "plans_ms": ours}
        out["speedup_s"] = out["winner_s"] / out["plan_s"]
        print(f"pfs {json.dumps(out)}")
        del res, win
        torch.cuda.empty_cache()
    done()


# -------------------------------- phase 10 --------------------------------

def keep_lengths_mutation(m, seed: int, n_rev: int, n_drop: int):
    """``m`` with ``n_rev`` entries revalued, ``n_drop`` dropped and one new
    entry added into the row of each dropped one, in a column the row did
    not hold: every row keeps its length, so a fresh compile designs the
    same layout as the patched plan (the reference test's ``_mutate``,
    with an add for every drop)."""
    from repro_torch.core.matrices import SparseMatrix
    rng = np.random.default_rng(seed)
    vals = m.vals.copy()
    rev = rng.choice(m.nnz, n_rev, replace=False)
    vals[rev] = rng.standard_normal(n_rev).astype(np.float32) + 0.1
    drop = rng.choice(m.nnz, n_drop, replace=False)
    keep = np.ones(m.nnz, bool)
    keep[drop] = False
    held = np.sort(m.rows.astype(np.int64) * m.n_cols + m.cols)
    add_r = m.rows[drop].astype(np.int64)
    add_c = np.full(n_drop, -1, np.int64)
    todo = np.arange(n_drop)
    while todo.size:                 # redraw columns the row already holds
        add_c[todo] = rng.integers(0, m.n_cols, todo.size)
        key = add_r * m.n_cols + add_c
        pos = np.minimum(np.searchsorted(held, key[todo]), held.size - 1)
        clash = held[pos] == key[todo]
        first = np.zeros(n_drop, bool)
        first[np.unique(key, return_index=True)[1]] = True
        todo = np.union1d(todo[clash], np.nonzero(~first)[0])
    return SparseMatrix(
        m.n_rows, m.n_cols,
        np.concatenate([m.rows[keep], add_r.astype(np.int32)]),
        np.concatenate([m.cols[keep], add_c.astype(np.int32)]),
        np.concatenate([vals[keep], rng.standard_normal(n_drop).astype(
            np.float32) + 0.1])).canonical()


def check_exact(label: str, y: torch.Tensor, m, x: np.ndarray) -> float:
    """``y`` against ``m``'s float64 oracle within 1e-5 * max|oracle|."""
    o = m.spmv_dense_oracle(x)
    err = float(np.abs(y.cpu().numpy().astype(np.float64) - o).max())
    tol = 1e-5 * float(np.abs(o).max())
    print(f"  {label}: vs oracle max_abs_err {err:.3e} (tol {tol:.3e})")
    require(err <= tol, f"{label}: output disagrees with the oracle")
    return err


def dyn_update(W, designer):
    """(a) One in-place update of the capacity plan against a fresh
    compile of the mutated matrix: bit-identical output and tensors."""
    import repro_torch
    from repro_torch.dyn import PatternDelta, PlanPatcher, check_capacity
    from repro_torch.train.dynamic import capacity_graph
    plan = timed("compile serving capacity_graph()", designer,
                 repro_torch.compile, W, repro_torch.Target(),
                 graph=capacity_graph())
    m1 = keep_lengths_mutation(W, seed=5, n_rev=W.nnz // 10,
                               n_drop=W.nnz // 20)
    delta = PatternDelta.from_matrices(W, m1)
    t0 = time.perf_counter()
    check = check_capacity(plan, delta)
    check_s = time.perf_counter() - t0
    require(check, f"the in-capacity delta does not fit: {check.reasons[:3]}")
    # plan.update(delta) is PlanPatcher(plan).apply(delta): timed apart
    t0 = time.perf_counter()
    patcher = PlanPatcher(plan)
    init_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    upd = patcher.apply(delta)
    torch.cuda.synchronize()
    apply_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fresh = repro_torch.compile(m1, repro_torch.Target(),
                                graph=capacity_graph())
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    x = np.random.default_rng(6).standard_normal(W.n_cols).astype(np.float32)
    require(torch.equal(upd(x), fresh(x)),
            "the updated plan's output is not bit-identical to a fresh "
            "compile's")
    require(sorted(upd.fmt) == sorted(fresh.fmt)
            and all(torch.equal(upd.fmt[k], t) for k, t in fresh.fmt.items()),
            "a patched tensor differs from the fresh compile's")
    require(upd.plan_version == plan.plan_version + 1, "plan_version")
    err = check_exact("updated plan", upd(x), m1, x)
    check_exact("source plan, old matrix", plan(x), W, x)
    out = {"delta": {"added": delta.n_added, "removed": delta.n_removed,
                     "revalued": delta.n_revalued},
           "steps": len(plan.spec["steps"]), "check_s": check_s,
           "patcher_init_ms": init_ms, "apply_ms": apply_ms,
           "fresh_compile_s": fresh_s, "bit_identical": True,
           "max_abs_err": err, "plan_version": upd.plan_version}
    print(f"dyn_update {json.dumps(out)}")
    out = bucket_moving_update(W, plan, x)
    print(f"dyn_update[move_buckets] {json.dumps(out)}")
    return plan


def bucket_moving_mutation(m, seed: int):
    """``m`` with 10 % of its entries revalued and the last entry of a
    third of its rows dropped, none added back: those rows shrink, so a
    fresh compile puts many of them in narrower width buckets, where the
    patched plan keeps them in theirs (the delta of
    tests/test_torch_dyn.py's bucket-changing property test, made certain
    to move rows; tests/test_torch_cuda.py uses it too)."""
    from repro_torch.core.matrices import SparseMatrix
    rng = np.random.default_rng(seed)
    vals = m.vals.copy()
    rev = rng.choice(m.nnz, m.nnz // 10, replace=False)
    vals[rev] = rng.standard_normal(rev.size).astype(np.float32) + 0.25
    last = np.nonzero(np.diff(np.append(m.rows, m.n_rows)) != 0)[0]
    drop = rng.choice(last, last.size // 3, replace=False)
    keep = np.ones(m.nnz, bool)
    keep[drop] = False
    return SparseMatrix(m.n_rows, m.n_cols, m.rows[keep], m.cols[keep],
                        vals[keep]).canonical()


def bucket_moving_update(W, plan, x) -> dict:
    """(a) again with a delta that moves rows between width buckets: the
    patched plan's output is bit-identical to a fresh compile's, whose
    layout differs."""
    import repro_torch
    from repro_torch.dyn import PatternDelta, check_capacity
    from repro_torch.train.dynamic import capacity_graph
    m2 = bucket_moving_mutation(W, seed=7)
    delta = PatternDelta.from_matrices(W, m2)
    require(check_capacity(plan, delta), "the bucket-moving delta must fit")
    upd = plan.update(delta)
    fresh = repro_torch.compile(m2, repro_torch.Target(),
                                graph=capacity_graph())
    buckets = lambda p: [(st["report"]["width"], st["report"]["tiles"])
                         for st in p.spec["steps"]]
    require(buckets(upd) != buckets(fresh),
            "the delta moved no row to another width bucket")
    same = bool(torch.equal(upd(x), fresh(x)))
    err = check_exact("updated plan, rows moved between buckets", upd(x),
                      m2, x)
    require(same, "an update that moves rows between width buckets is not "
            "bit-identical to a fresh compile")
    tiles_at = lambda p: dict(buckets(p))       # width -> tiles
    a, b = tiles_at(upd), tiles_at(fresh)
    moved = sum(abs(a.get(w, 0) - b.get(w, 0)) for w in a.keys() | b) // 2
    return {"delta": {"added": delta.n_added, "removed": delta.n_removed,
                      "revalued": delta.n_revalued},
            "buckets_patched": len(buckets(upd)),
            "buckets_fresh": len(buckets(fresh)),
            "tiles_in_another_width": int(moved),
            "bit_identical": same, "max_abs_err": err}


def served_manager(W, plan, executor, probe, **kw):
    """A ``DynamicSparsityManager`` that times each ``apply``, records the
    delta's size, then serves a batch through the attached
    ``PlanExecutor``, held to the oracle of the matrix the manager says
    its live plan encodes. The first delta also goes to ``probe``, a
    second manager on another plan, whose action is recorded."""
    from repro_torch.dyn import DynamicSparsityManager

    class Served(DynamicSparsityManager):
        def apply(self, delta):
            if not self.log:
                t0 = time.perf_counter()
                self.probe_action = probe.apply(delta)["action"]
                self.probe_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            out = super().apply(delta)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            xs = np.random.default_rng(len(self.log)).standard_normal(
                (4, self.matrix.n_cols)).astype(np.float32)
            got = self.executor.execute(xs).T
            want = oracle_cols(self.matrix, xs.T)
            err = float(np.abs(got - want).max())
            tol = 1e-5 * float(np.abs(want).max())
            require(err <= tol, f"pruning step {len(self.log) + 1}: a "
                    f"served answer is off by {err:.3e} (tol {tol:.3e})")
            self.log.append({"action": out["action"], "apply_ms": ms,
                             "added": delta.n_added,
                             "removed": delta.n_removed,
                             "revalued": delta.n_revalued,
                             "served_max_abs_err": err})
            print(f"  pruning step {len(self.log)}: "
                  f"{json.dumps(self.log[-1])}", flush=True)
            return out

    mgr = Served(W, plan, executor=executor, **kw)
    mgr.log = []
    return mgr


def manager_stats(mgr) -> dict:
    st = mgr.stats()
    return {k: st[k] for k in ("updates_applied", "deferred",
                               "out_of_capacity", "researches_started",
                               "researches_landed", "researches_failed",
                               "plan_version", "serving_stale")}


def pruning_loop(W, plan_a, designer, steps: int = 1) -> None:
    """(b) ``run_pruning_loop`` at lr 0.01 on the dense weight behind W,
    with a manager attached to a ``PlanExecutor`` serving the plan. The
    plan pads lanes to 512 slots, so that every row keeps room for a
    step's churn. The first step's delta also goes to a manager on (a)'s
    plan (``capacity_graph()``, lanes padded to 8), where it does not
    fit: that manager re-searches on the card in the background while the
    loop runs, and its landed plan is held to the oracle."""
    import repro_torch
    from repro_torch.core.search import SearchConfig
    from repro_torch.dyn import DynamicSparsityManager
    from repro_torch.serve import PlanExecutor
    from repro_torch.train.dynamic import capacity_graph, run_pruning_loop
    w = np.random.default_rng(0).standard_normal((W.n_rows, W.n_cols),
                                                 dtype=np.float32)
    require(np.array_equal(w[W.rows, W.cols], W.vals),
            "W is not the pruned weight of serving_matrix")
    plan = timed("compile serving capacity_graph(pad_to=512)", designer,
                 repro_torch.compile, W, repro_torch.Target(),
                 graph=capacity_graph(pad_to=512))
    budget = dict(research_budget=SearchConfig(max_seconds=2,
                                               max_structures=2),
                  research_deadline_s=8.0)
    probe = DynamicSparsityManager(W, plan_a, **budget)
    ex = PlanExecutor(plan, W)
    mgr = served_manager(W, plan, ex, probe, **budget)
    t0 = time.perf_counter()
    rep = run_pruning_loop(w, 0.08, steps, manager=mgr, lr=0.01, seed=0)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    require(mgr.quiesce(timeout=60.0), "a re-search is still running")
    require(probe.quiesce(timeout=120.0),
            "the capacity_graph() re-search is still running")
    quiesce_s = time.perf_counter() - t0
    st, pst = mgr.stats(), probe.stats()
    x = np.random.default_rng(9).standard_normal(W.n_cols).astype(np.float32)
    probe_err = check_exact("capacity_graph() manager after its re-search",
                            probe.plan(x), probe.matrix, x)
    out = {"steps": rep.steps, "history": rep.history,
           "oracle_max_rel_err": rep.oracle_max_rel_err,
           "executor_updates": ex.update_count, "wall_s": wall,
           "quiesce_s": quiesce_s, "manager": manager_stats(mgr),
           "step_log": mgr.log,
           "capacity_graph_manager": dict(
               manager_stats(probe), first_action=mgr.probe_action,
               apply_ms=mgr.probe_ms, max_abs_err=probe_err,
               plan=(probe.plan.graph.label() if probe.plan.graph
                     else None))}
    print(f"pruning {json.dumps(out)}")
    require(rep.updates_applied >= 1, "no pruning step was applied in place")
    require(rep.oracle_max_rel_err <= 1e-5, "a checked answer is off")
    for name, s_ in (("", st), ("capacity_graph() ", pst)):
        require(s_["researches_failed"] == 0,
                f"a {name}re-search failed: {s_['last_error']}")
    require(not pst["serving_stale"]
            and (mgr.probe_action != "research"
                 or pst["researches_landed"] >= 1),
            "the capacity_graph() manager never adopted its re-search")


def seg_update(P, seg_prog) -> None:
    """(c) One in-capacity update of the powerlaw seg_scan fused plan."""
    import repro_torch
    from repro_torch.api import _plan_from_program
    from repro_torch.dyn import PatternDelta, PlanPatcher
    plan = _plan_from_program(seg_prog, chain(
        ("COMPRESS", {}), ("LANE_NNZ_BLOCK", {"chunk": 2048}),
        ("SEG_SCAN_RED", {})), repro_torch.Target())
    require(all(s.get("fused") and s["reduce"] == "seg_scan"
                for s in plan.spec["steps"]), "not a fused seg_scan plan")
    m1 = keep_lengths_mutation(P, seed=7, n_rev=20000, n_drop=10000)
    delta = PatternDelta.from_matrices(P, m1)
    t0 = time.perf_counter()
    patcher = PlanPatcher(plan)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    upd = patcher.apply(delta)
    torch.cuda.synchronize()
    apply_ms = (time.perf_counter() - t0) * 1e3
    x = np.random.default_rng(8).standard_normal(P.n_cols).astype(np.float32)
    y = upd(x)
    check_oracle("seg update", y, m1.spmv_dense_oracle(x), "float32")
    check_oracle("source seg plan, old matrix", plan(x),
                 P.spmv_dense_oracle(x), "float32")
    out = {"delta": {"added": delta.n_added, "removed": delta.n_removed,
                     "revalued": delta.n_revalued},
           "shape": list(plan.fmt[plan.spec["steps"][0]["key"] + "_vals"]
                         .shape),
           "patcher_init_s": init_s, "apply_ms": apply_ms,
           "plan_version": upd.plan_version}
    print(f"dyn_seg_update {json.dumps(out)}")


def dyn_phase(W, P, seg_prog, designer) -> None:
    done = phase("10 dynamic sparsity")
    reset_launch_counts()                    # phase 10 starts here
    plan_a = dyn_update(W, designer)
    pruning_loop(W, plan_a, designer)
    seg_update(P, seg_prog)
    torch.cuda.synchronize()
    launches = launch_counts()               # ... and ends here
    print(f"  phase-10 launches: {launches}")
    require(launches["K1"] > 0 and launches["K6"] > 0,
            f"K1 or K6 never launched in phase 10: {launches}")
    done()


# -------------------------------- phase 11 --------------------------------

# the sweep's coarse budget (the reference's tests/test_corpus.py shape),
# also the budget of the holdout's anneal and learned compiles
SWEEP_SECONDS = 4.0
PORTFOLIO_DEADLINE_S = 2.0
SWEEP_MEDIUM = 1         # entries of synthetic_corpus("medium") swept


def corpus_entry(family: str, seed: int, **params):
    """A CorpusEntry named the way ``synthetic_corpus`` names its own."""
    from repro_torch.corpus.datasets import CorpusEntry
    tag = "_".join(f"{k}{v}" for k, v in sorted(params.items()))
    return CorpusEntry(name=f"{family}_{tag}_s{seed}", family=family,
                       params=tuple(sorted(params.items())), seed=seed)


def real_size_entries() -> list:
    """Sweep entries at a size users call real: phase 4's power-law
    operand (7.85 M nnz, above the 50 MB L2). Left out for time: the
    banded n = 2^20 entry (9.4 M nnz; its search took 13-15 s of the
    H100 machine's host time, besides its child's start), and the
    HYB-friendly entry (n = 2^19, 10,922 rows of 512, 8.7 M nnz), whose
    search timed one candidate, a tiled ELL whose tiles pad to their
    512-slot rows, in 102 s of the H100 machine's host time (PERF.md
    §6)."""
    return [corpus_entry("powerlaw", 0, n=2 ** 20, avg_row=8.0, alpha=1.5)]


def per_width_ell_layout(b):
    """The Designer's ELL layout as it was built before the one-pass
    routing (one rescan of all nonzeros per distinct tile width), kept here
    to time the Designer before and after on the same matrix."""
    import math
    from repro_torch.core.operators import EllBucket, EllTileLayout, _ceil_to
    n = b.n_block_rows
    R = b.tile_rows or _ceil_to(max(n, 1), 8)
    n_tiles = max(1, math.ceil(n / R))
    lengths = b.row_lengths()
    lengths_pad = np.zeros(n_tiles * R, np.int64)
    lengths_pad[:n] = lengths
    w_per_tile = lengths_pad.reshape(n_tiles, R).max(axis=1)
    w_per_tile = np.maximum(_ceil_to(1, b.pad_to),
                            ((w_per_tile + b.pad_to - 1) // b.pad_to)
                            * b.pad_to)
    w_per_tile = np.maximum(w_per_tile, 1)
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    pos_in_row = np.arange(b.nnz, dtype=np.int64) - row_ptr[b.rows]
    tile_of_row = np.arange(n, dtype=np.int64) // R
    row_in_tile = np.arange(n, dtype=np.int64) % R
    buckets = []
    for w in np.unique(w_per_tile):
        tiles = np.where(w_per_tile == w)[0]
        t_rank = np.full(n_tiles, -1, np.int64)
        t_rank[tiles] = np.arange(tiles.size)
        vals = np.zeros((tiles.size, R, int(w)), np.float32)
        cols = np.zeros((tiles.size, R, int(w)), np.int32)
        rowmap = np.full((tiles.size, R), -1, np.int32)
        nz_tile = t_rank[tile_of_row[b.rows]]
        sel = nz_tile >= 0
        at = (nz_tile[sel], row_in_tile[b.rows[sel]], pos_in_row[sel])
        vals[at] = b.vals[sel]
        cols[at] = b.cols[sel]
        rows_here = np.where(t_rank[tile_of_row] >= 0)[0]
        rowmap[t_rank[tile_of_row[rows_here]], row_in_tile[rows_here]] = \
            b.row_ids[rows_here]
        buckets.append(EllBucket(int(w), vals, cols, rowmap))
    return EllTileLayout(tile_rows=R, buckets=tuple(buckets))


def designer_before_after(m) -> dict:
    """The Designer on ``capacity_graph()`` (8-row tiles sorted by length,
    widths padded to 8: many ELL width buckets) with the one-pass ELL
    layout and with the per-width rescans; the layouts must agree. The
    operators before LANE_ROW_BLOCK run once (``prefix_s``), and
    ``designer_s_*`` adds each layout build to them."""
    from repro_torch.core import operators
    from repro_torch.core.metadata import from_matrix
    from repro_torch.train.dynamic import capacity_graph
    g = capacity_graph()
    chain = g.branch_chains[0]
    cut = [op.name for op in chain].index("LANE_ROW_BLOCK")
    t0 = time.perf_counter()
    meta = from_matrix(m)
    for op in g.converting + chain[:cut]:
        meta = operators.apply_op(meta, op)
    prefix = time.perf_counter() - t0
    new = operators._build_ell_layout
    out, layouts = {"prefix_s": round(prefix, 3)}, {}
    try:
        for name, fn in (("after", new), ("before", per_width_ell_layout)):
            operators._build_ell_layout = fn
            t0 = time.perf_counter()
            done = meta
            for op in chain[cut:]:
                done = operators.apply_op(done, op)
            layouts[name] = done.blocks[0].layout
            out[f"designer_s_{name}"] = round(
                prefix + time.perf_counter() - t0, 3)
    finally:
        operators._build_ell_layout = new
    a, b = layouts["after"].buckets, layouts["before"].buckets
    require(len(a) == len(b) and all(
        u.width == v.width and np.array_equal(u.vals, v.vals)
        and np.array_equal(u.cols, v.cols)
        and np.array_equal(u.rowmap, v.rowmap) for u, v in zip(a, b)),
        "the one-pass ELL layout differs from the per-width one")
    out["ell_buckets"] = len(a)
    return out


def kernel_libraries() -> dict:
    from repro_torch.kernels import build
    return {p.name: p.stat().st_mtime_ns
            for p in sorted(build.BUILD_DIR.glob("*.so"))}


def corpus_sweep(sets, store, cfg, resume: bool) -> list:
    from repro_torch.corpus import run_sweep
    import repro_torch
    recs = []
    for entries in sets.values():
        recs += run_sweep(entries, store, budget=cfg,
                          target=repro_torch.Target(), isolate="process",
                          resume=resume)
    return recs


def sweep_phase(store_dir: Path, cfg) -> None:
    """(a) sweep in isolated children, (b) resume, (c) train."""
    import repro_torch
    from repro_torch.corpus import (default_model_path, load_records,
                                    synthetic_corpus, train_from_store)
    from repro_torch.corpus.sweep import RECORDS_FILENAME
    # the first family at its smaller size and one real-size entry: an
    # isolated child takes several seconds to start whatever its entry,
    # which bought the other entries little at the run's time limit (the
    # sharded serving step of phase 16 took the time of those dropped)
    sets = {"medium": synthetic_corpus("medium")[:SWEEP_MEDIUM],
            "real": real_size_entries()}
    store = repro_torch.PlanStore(store_dir)
    libs = kernel_libraries()
    t0 = time.perf_counter()
    recs = corpus_sweep(sets, store, cfg, resume=False)
    sweep_s = time.perf_counter() - t0
    require(kernel_libraries() == libs,
            "a sweep child rebuilt the kernel libraries")
    n = len(sets["medium"]) + len(sets["real"])
    require(len(recs) == n, f"{len(recs)} of {n} entries swept")
    for rec in recs:
        print("corpus_sweep " + json.dumps({
            "name": rec.name, "rows": rec.n_rows, "nnz": rec.nnz,
            "label": rec.label, "gflops": rec.gflops,
            "wall_s": round(rec.wall_seconds, 3),
            "n_evaluations": rec.n_evaluations,
            "failure_counts": rec.failure_counts, "error": rec.error}),
              flush=True)
        require(rec.error is None, f"{rec.name}: {rec.error}")
        bad = {"crash", "wrong_result", "fallback"} & set(rec.failure_counts)
        require(not bad, f"{rec.name}: search failures {bad}")
    print(f"  sweep of {n} entries in isolated children: {sweep_s:.1f} s; "
          "no child rebuilt a kernel library")
    journal = store_dir / RECORDS_FILENAME
    n_lines = journal.read_text().count("\n")
    t0 = time.perf_counter()
    again = corpus_sweep(sets, store, cfg, resume=True)
    print(f"  resume: {len(again)} compiles, {len(load_records(journal))} "
          f"journal records, {time.perf_counter() - t0:.2f} s")
    require(not again and journal.read_text().count("\n") == n_lines,
            "the resumed sweep compiled or journaled again")
    t0 = time.perf_counter()
    model = train_from_store(store_dir)
    path = model.save(default_model_path(store_dir))
    print("corpus_model " + json.dumps({
        "labels": list(model.labels),
        "exemplars": len(model.exemplar_labels), "sweep_rows": model.n_train,
        "log_mae": model.mad, "fingerprint": model.fingerprint(),
        "train_s": round(time.perf_counter() - t0, 3), "path": path.name}))
    require(len(model.exemplar_labels) == len(load_records(
        store_dir / RECORDS_FILENAME)), "an exemplar is missing")


def holdout_phase(store_dir: Path, cfg) -> None:
    """(d) held-out matrices compiled cold with anneal, and with the
    learned and portfolio strategies from a copy of the swept store's
    sidecars and model (so no holdout plan is reused by the next); the
    Designer's layouts before and after on the real-size one."""
    import shutil
    import repro_torch
    from repro_torch.corpus import holdout_corpus
    real = corpus_entry("powerlaw", 7, n=2 ** 18, avg_row=8.0, alpha=1.2)
    target = repro_torch.Target()
    for entry in holdout_corpus("medium") + [real]:
        m = entry.build()
        if entry is real:
            print("designer_layout " + json.dumps(
                {"name": entry.name, "rows": m.n_rows, "nnz": m.nnz,
                 **designer_before_after(m)}), flush=True)
        x_np = np.random.default_rng(3).standard_normal(
            m.n_cols).astype(np.float32)
        oracle = m.spmv_dense_oracle(x_np)
        x = torch.from_numpy(x_np).cuda()
        for strategy in ("anneal", "learned", "portfolio"):
            kw = {}
            if strategy != "anneal":
                fresh = store_dir.parent / f"{strategy}-{entry.name}"
                fresh.mkdir()
                for f in (list(store_dir.glob("*.stats.json"))
                          + [store_dir / "corpus_model.npz"]):
                    shutil.copy(f, fresh / f.name)
                kw["store"] = repro_torch.PlanStore(fresh)
            if strategy == "portfolio":
                kw["deadline_s"] = PORTFOLIO_DEADLINE_S
            t0 = time.perf_counter()
            plan = repro_torch.compile(m, target, budget=cfg,
                                       strategy=strategy, **kw)
            wall = time.perf_counter() - t0
            res = plan.search_result
            require(res is not None and res.strategy_name == strategy,
                    f"{entry.name} {strategy}: not a fresh search")
            check_oracle(f"{entry.name} {strategy}", plan(x), oracle,
                         plan.spec["storage_dtype"])
            fn = functools.partial(plan, x)
            reps = reps_for(fn)
            ms, dms = cuda_ms(fn, reps=reps), card_ms(fn, reps=reps)
            if strategy == "anneal":
                anneal_ms, anneal_dms = ms, dms
            print("corpus_holdout " + json.dumps({
                "name": entry.name, "rows": m.n_rows, "nnz": m.nnz,
                "strategy": strategy, "compile_s": round(wall, 3),
                "n_evaluations": res.n_evaluations,
                "fallback": res.fallback, "graph": plan.graph.label(),
                "steps": len(plan.spec["steps"]), "ms": ms,
                "device_ms": dms, "ms_over_anneal": ms / anneal_ms,
                "device_ms_over_anneal": (dms / anneal_dms if dms and
                                          anneal_dms else None)}),
                  flush=True)
            del plan
        torch.cuda.empty_cache()


CLI_RUNS = {
    "search": ["--demo", "--seconds", "5", "--out", "{d}/demo.plan.npz"],
    "search_b8": ["--demo", "--batch", "8", "--seconds", "5",
                  "--out", "{d}/demo8.plan.npz"],
    "no_search": ["--demo", "--no-search", "--out", "{d}/heur.plan.npz"],
    "sweep": ["--sweep", "smoke", "--seconds", "1", "--store", "{d}/store"],
    "train": ["--train-from-store", "--store", "{d}/store"],
}


def cli_phase(work: Path) -> None:
    """(e) ``python -m repro_torch.cli`` in subprocesses on the card: the
    four that share nothing at once, then ``train`` on ``sweep``'s
    store."""
    rcs, secs = {}, {}

    def run(names):
        children = {name: start_child(
            ["-m", "repro_torch.cli",
             *(a.format(d=work) for a in CLI_RUNS[name])],
            work / f"cli_{name}.log") for name in names}
        for name, (rc, t, out) in wait_children(children, 300).items():
            secs[name] = round(t, 2)
            rcs[name] = rc
            lines = out.strip().splitlines()
            keep = [ln for ln in lines if ln.startswith(
                ("searched", "compiled", "verified", "benchmark", "sweep[",
                 "trained"))]
            print(f"  cli {name}: rc {rc}; " + " | ".join(keep))
            if rc != 0:
                print(out[-6000:])
            if "--out" in CLI_RUNS[name]:
                require(any(ln.startswith("verified:") for ln in lines),
                        f"cli {name}: no verified line")

    run([n for n in CLI_RUNS if n != "train"])
    run(["train"])
    print("cli " + json.dumps({"returncodes": rcs, "seconds": secs}))
    require(all(rc == 0 for rc in rcs.values()), f"cli return codes {rcs}")


def cost_lines(plans) -> None:
    """(f) ``SpmvPlan.cost_analysis`` and the bound it gives, beside the
    plan's time on the card."""
    for name, (plan, x) in plans.items():
        b = 1 if x.ndim == 1 else x.shape[1]
        ca = plan.cost_analysis(b)
        bound = max(ca["bytes accessed"] / HBM_BYTES_PER_S,
                    ca["flops"] / FP32_FLOPS_PER_S) * 1e3
        dms = device_ms(lambda: plan(x))
        print("cost_analysis " + json.dumps({
            "plan": name, "batch": b, "bytes_accessed": ca["bytes accessed"],
            "flops": ca["flops"], "bound_ms": bound, "device_ms": dms,
            "percent_of_bound": 100.0 * bound / dms,
            "ell_slack": ca["capacity"]["ell_slack"],
            "seg_headroom": ca["capacity"]["seg_headroom"]}))
        require(ca["flops"] >= 2 * plan.nnz * b, f"{name}: flops too low")


def corpus_phase(cost_plans) -> None:
    import repro_torch
    done = phase("11 corpus: sweep, train, fleet compile, CLI")
    cfg = repro_torch.SearchConfig(max_seconds=SWEEP_SECONDS,
                                   max_structures=2, coarse_samples=1,
                                   fine_eval_budget=0, use_cost_model=False,
                                   seed=0)
    reset_launch_counts()                    # phase 11 starts here
    scratch = ROOT / "results"               # listed in .gitignore
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        store_dir = Path(d) / "store"
        t0 = time.perf_counter()
        sweep_phase(store_dir, cfg)
        t1 = time.perf_counter()
        holdout_phase(store_dir, cfg)
        t2 = time.perf_counter()
        (Path(d) / "cli").mkdir()
        cli_phase(Path(d) / "cli")
        t3 = time.perf_counter()
    cost_lines(cost_plans)
    torch.cuda.synchronize()
    launches = launch_counts()               # ... and ends here
    print(f"  phase-11 launches (this process): {launches}; sweep "
          f"{t1 - t0:.1f} s, holdout {t2 - t1:.1f} s, cli {t3 - t2:.1f} s")
    require(sum(launches.values()) > 0, "phase 11 launched no kernel")
    done()


# -------------------------------- phase 12 --------------------------------

DIST_SHARDS = 4
DIST_TOL = 1e-4          # the reference's dist tests: 1e-4 * max|oracle|
# a coarse per-shard search budget (the reference's dist tests' shape)
DIST_SEARCH = dict(max_seconds=4, max_structures=2, coarse_samples=1,
                   fine_eval_budget=0, use_cost_model=False, seed=0)
COMBINE = ("rowmap_combine", "src/repro_torch/kernels/csrc/rowmap_combine.cu",
           "src/repro/core/kernel_builder.py:395")


def dist_launches() -> dict:
    """The twelve kernels' launch counts and the ordered combine's."""
    from repro_torch.kernels import ops
    return dict(launch_counts(), combine=ops.rowmap_combine.launches)


def launches_of(fn) -> dict:
    """Launches of one call of ``fn``, by kernel."""
    before = dist_launches()
    fn()
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in dist_launches().items()
            if v != before[k]}


def check_dist(label: str, y: torch.Tensor, oracle: np.ndarray) -> float:
    y = y.cpu().numpy()
    require(y.shape == oracle.shape and np.isfinite(y).all(),
            f"{label}: bad output shape or non-finite values")
    err = float(np.abs(y - oracle).max())
    tol = DIST_TOL * float(np.abs(oracle).max())
    print(f"  {label}: vs oracle max_abs_err {err:.3e} (tol {tol:.3e})")
    require(err <= tol, f"{label}: output disagrees with the oracle")
    return err


def family_kernel(step: dict, batched: bool) -> str:
    """The kernel a sharded plan's family step launches (gmem_atom runs
    through the seg_scan kernels; no sharded step is fused)."""
    require(not step.get("fused"), f"a fused sharded step: {step['key']}")
    if step["kind"] == "ell":
        return "K7" if batched else "K1"
    if step["reduce"] == "onehot_mxu":
        return "K10b" if batched else "K4"
    return "K10a" if batched else "K3"


def package_folds() -> bool:
    """Whether the package under test runs the shards that share a card
    in one pass (``fold_operands``); a package before that (the parent in
    an A/B) runs them once a shard, and is held to that."""
    from repro_torch.dist import spmv
    return hasattr(spmv, "fold_operands")


def check_launches(label: str, call, steps: list, n_shards: int,
                   batched: bool, shared: bool) -> dict:
    """One call's launches, which must be one family kernel and one
    combine a step where the shards share a card (``shared``, the folded
    call, in a package that folds), one a step and shard where they do
    not, and nothing else."""
    def want(per: int) -> dict:
        out = {}
        for st in steps:
            k = family_kernel(st, batched)
            out[k] = out.get(k, 0) + per
            out["combine"] = out.get("combine", 0) + per
        return out
    need = want(1 if shared and package_folds() else n_shards)
    got = launches_of(call)
    require(got == need, f"{label}: a call launched {got}, not {need}")
    return got


def check_shard_kernels(label: str, prog, x1, x8) -> None:
    """Shard 0's operands of every step of a sharded plan or program, and
    the folded set where the shards share the card (every shard's tiles
    at once, the whole padded x), through the wrapper the step dispatches
    to and the ordered combine, held against their plain versions on the
    same tensors at B = 1 and 8 (the sharded shapes: (T', 8, 8) ELL
    chunks, seg tiles with unsorted rows or all padding)."""
    ops_ = prog.operands
    n_shards = len(ops_)
    folded = getattr(ops_, "folded", None)
    require(folded is not None or not package_folds(),
            f"{label}: the shards share the card and fold nothing")
    n_out = prog.band_rows if prog.mode == "row" else prog.n_rows
    sets = [("shard 0", ops_[0], False)]
    if folded is not None:
        sets.append(("folded", folded, True))
    for x in (x1, x8):
        if prog.mode == "col":
            width = -(-prog.n_cols // n_shards)
            pad = width * n_shards - prog.n_cols
            whole = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        for tag, op, is_folded in sets:
            xs = x
            if prog.mode == "col":           # shard 0's slice, or all of it
                xs = whole if is_folded else x[:width]
            shard_steps(f"{label} {tag}", prog.steps, op, xs.contiguous(),
                        n_shards * n_out if is_folded else n_out)


def step_partials(st: dict, fmt: dict, x, plain: bool = False) -> tuple:
    """A sharded family step's partials on ``fmt`` through the wrapper it
    dispatches to (or, with ``plain``, its plain version), and the fmt key
    of its rowmap."""
    from repro_torch.kernels import ops, ref
    key = st["key"]
    require(st["cols"]["mode"] == "array", f"{key}: cols by model")
    vals, cols = fmt[f"{key}_vals"], fmt[st["cols"]["key"]]
    b = x.ndim == 2
    if st["kind"] == "ell":
        fn = ((ref.ell_spmm_ref if b else ref.ell_spmv_ref) if plain
              else (ops.ell_spmm if b else ops.ell_spmv))
        return fn(vals, cols, x), st["combine"]["key"]
    pk = "seg_scan" if st["reduce"] == "gmem_atom" else st["reduce"]
    fn = ((ref.seg_spmm_ref if b else ref.seg_spmv_ref) if plain
          else (ops.seg_spmm if b else ops.seg_spmv))
    return (fn(vals, cols, fmt.get(f"{key}_local"), fmt.get(f"{key}_end"),
               x, st["seg_rows"], mode=pk), f"{key}_rowmap")


def shard_order(op, key: str, n_out: int):
    """The combine order of rowmap ``key`` on operands ``op``: the one
    placed with them, or, for a shard's view beside a folded set (which
    holds the orders), made here."""
    from repro_torch.kernels import ops
    return op.order[key] if key in op.order else ops.combine_order(
        op.fmt[key], n_out)


def shard_steps(label: str, steps: list, op, x, n_out: int) -> None:
    """Every step of ``steps`` on the operands ``op`` (fmt, order), whose
    output has ``n_out`` rows: the family kernel and the combine against
    their plain versions."""
    from repro_torch.kernels import ref
    b = x.shape[1] if x.ndim == 2 else 1
    for st in steps:
        got, rm_key = step_partials(st, op.fmt, x)
        want, _ = step_partials(st, op.fmt, x, plain=True)
        vals = op.fmt[f"{st['key']}_vals"]
        tag = f"{label} {family_kernel(st, b > 1)} " \
            f"{tuple(vals.shape)} {vals.dtype} B={b}"
        check_kernel(tag, got, want)
        flat = got.reshape((-1,) + tuple(x.shape[1:])).contiguous()
        order = shard_order(op, rm_key, n_out)
        y0 = torch.zeros((order[1].numel() - 1,) + tuple(x.shape[1:]),
                         device=flat.device)
        check_kernel(f"{tag} combine", combine_call(y0.clone(), flat, order),
                     ref.rowmap_combine_ref(y0.clone(), flat, *order))


def timed_pair(fn, x1, x8) -> dict:
    return {"ms_b1": cuda_ms(lambda: fn(x1)),
            "device_ms_b1": device_ms(lambda: fn(x1)),
            "ms_b8": cuda_ms(lambda: fn(x8)),
            "device_ms_b8": device_ms(lambda: fn(x8))}


def apart_mesh():
    """``DIST_SHARDS`` shards on the one card under two device names
    (``cuda`` and ``cuda:0`` compare unequal): a mesh whose shards do
    not share a device, on which a plan runs once a shard, as it does
    where the shards sit on several cards."""
    from repro_torch.dist.mesh import DataMesh
    return DataMesh(tuple(torch.device("cuda", 0) if i % 2 else
                          torch.device("cuda") for i in range(DIST_SHARDS)))


def serving_sharded(W, mode, mesh, xs, oracles, beside, designer):
    """(a) The serving matrix on ``DIST_SHARDS`` shards of the card in
    ``mode``: held to the oracle at B = 1 and 8, bit-identical across two
    calls and a save/load, and one ``dist {...}`` line with ``beside``
    (the dense plan's and cuSPARSE's times, taken once for both modes)
    next to its own. The saved plan is also loaded onto
    :func:`apart_mesh`, which runs it once a shard: held to the oracle,
    to the same bits, and to a family kernel and a combine a step and
    shard (``per_shard`` in the line)."""
    import repro_torch
    label = f"compile serving sharded {mode} (default_shard_graph)"
    plan = timed(label, designer, repro_torch.compile, W,
                 repro_torch.Target(mesh=mesh, partition=mode))
    ys = [plan(x) for x in xs]
    errs = [check_dist(f"sharded {mode} B={x.shape[1] if x.ndim == 2 else 1}",
                       y, o) for x, y, o in zip(xs, ys, oracles)]
    scratch = ROOT / "results"               # listed in .gitignore
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        path = Path(d) / "sharded.plan.npz"
        plan.save(path)
        loaded = repro_torch.load_plan(path, mesh=mesh)
        same = all(torch.equal(f(x), y) for f in (plan, loaded)
                   for x, y in zip(xs, ys))
        apart = repro_torch.load_plan(path, mesh=apart_mesh())
        ys_apart = [apart(x) for x in xs]
    require(same, f"sharded {mode}: repeat calls or the loaded plan are "
            "not bit-identical")
    require(getattr(apart.operands, "folded", None) is None,
            f"sharded {mode}: shards on two devices were folded")
    for x, y, o in zip(xs, ys_apart, oracles):
        check_dist(f"sharded {mode} per shard "
                   f"B={x.shape[1] if x.ndim == 2 else 1}", y, o)
    require(all(torch.equal(a, y) for a, y in zip(ys_apart, ys)),
            f"sharded {mode}: the per-shard run and the folded call differ")
    on = W.rows if mode == "row" else W.cols
    slots = sum(plan.stacks[f"{st['key']}_vals"].numel()
                for st in plan.steps)
    n_shards = plan.n_shards
    ops_ = plan.operands
    shared = mesh.shared_device is not None
    line = {"mode": mode, "n_shards": n_shards,
            "families": [st["report"] for st in plan.steps],
            "shard_nnz": [int(((on >= a) & (on < b)).sum())
                          for a, b in plan.bounds],
            "per_device_format_bytes": plan.per_device_format_bytes,
            "replicated_format_bytes": plan.replicated_format_bytes,
            "combine_order_bytes": (
                ops_.order_bytes if hasattr(ops_, "order_bytes")
                else sum(op.order_bytes for op in ops_)),
            "folded_bytes": getattr(ops_, "folded_bytes", None),
            "stacked_slots_over_nnz": slots / W.nnz,
            "launches_b1": check_launches(f"sharded {mode} B=1",
                                          lambda: plan(xs[0]), plan.steps,
                                          n_shards, False, shared),
            "launches_b8": check_launches(f"sharded {mode} B=8",
                                          lambda: plan(xs[1]), plan.steps,
                                          n_shards, True, shared),
            "compile_s": designer[label], "max_abs_err": errs,
            "bit_identical": same}
    line.update(timed_pair(plan, *xs))
    line["per_shard"] = {
        "launches_b1": check_launches(f"sharded {mode} per shard B=1",
                                      lambda: apart(xs[0]), plan.steps,
                                      n_shards, False, False),
        "launches_b8": check_launches(f"sharded {mode} per shard B=8",
                                      lambda: apart(xs[1]), plan.steps,
                                      n_shards, True, False),
        "bit_identical": True, **timed_pair(apart, *xs)}
    line.update(beside)
    print(f"dist {json.dumps(line)}")
    return plan


def segment_sum(y, flat, perm, off):
    """The combine in plain PyTorch calls: gather the partials in ``perm``
    order, ``torch.segment_reduce`` them by row, add into y."""
    y += torch.segment_reduce(flat.index_select(0, perm), "sum",
                              offsets=off, axis=0)
    return y


def combine_call(y, flat, order):
    """The ordered combine on ``order``: whole where the package checks an
    order once, where it is built (``CombineOrder``), else as its two
    tensors (a package before that)."""
    from repro_torch.kernels import combine, ops
    if isinstance(order, getattr(combine, "CombineOrder", ())):
        return ops.rowmap_combine(y, flat, order)
    return ops.rowmap_combine(y, flat, *order)


def combine_entry(label: str, flat, order, rowmap, launches: int,
                  matrix: str) -> dict:
    """A kernels-line row of the ordered combine on the partials ``flat``
    ((N,) or (N, B)) in ``order`` (its ``rowmap``'s): against its plain
    version; ``ms`` as a caller sees it, ``host_ms`` its host side alone
    and ``device_ms`` on the card;
    its bound (the partials with a row and their perm entries, offsets,
    and the rows with a run read and written once, over 3.35 TB/s; one
    add a partial over the fp32 rate); ``index_add_`` on the same
    partials (in whatever order the atomics take) as the library call,
    and ``segment_sum``, the same order in PyTorch calls, beside it."""
    from repro_torch.kernels import ref
    perm, off = order
    n = off.numel() - 1
    rhs = tuple(flat.shape[1:])
    b = rhs[0] if rhs else 1
    y0 = torch.zeros((n,) + rhs, device=flat.device)
    got = combine_call(y0.clone(), flat, order)
    want = ref.rowmap_combine_ref(y0.clone(), flat, perm, off)
    err = check_kernel(f"combine {label} n_rows={n} partials={perm.numel()}"
                       f" B={b}", got, want)
    seg = [segment_sum(y0.clone(), flat, perm, off) for _ in range(3)]
    check_kernel(f"combine {label} segment_sum", seg[0], want)
    seg_stable = all(torch.equal(t, seg[0]) for t in seg)
    rm = rowmap.reshape(-1).long()
    idx = torch.where(rm >= 0, rm, n)
    y, y_lib = y0.clone(), torch.zeros((n + 1,) + rhs, device=flat.device)
    ms = cuda_ms(lambda: combine_call(y, flat, order))
    dev_ms = device_ms(lambda: combine_call(y, flat, order))
    plain_ms = cuda_ms(lambda: ref.rowmap_combine_ref(y, flat, perm, off),
                       reps=5)
    lib_ms = cuda_ms(lambda: y_lib.index_add_(0, idx, flat))
    lib_dev = device_ms(lambda: y_lib.index_add_(0, idx, flat))
    seg_ms = cuda_ms(lambda: segment_sum(y, flat, perm, off))
    seg_dev = device_ms(lambda: segment_sum(y, flat, perm, off))
    runs = off[1:] - off[:-1]
    used = int((runs > 0).sum())
    byt = (perm.numel() * (4 + 4 * b) + nbytes(off) + 2 * used * b * 4)
    b_ms = byt / HBM_BYTES_PER_S * 1e3
    f_ms = perm.numel() * b / FP32_FLOPS_PER_S * 1e3
    row = {"name": COMBINE[0] if label == COMBINE_FIRST
           else f"{COMBINE[0]}[{label}]",
           "route": "cuda", "source": COMBINE[1],
           "replaces": COMBINE[2], "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(b_ms, f_ms),
           "bound_by": "bytes" if b_ms >= f_ms else "operations",
           "library_ms": lib_ms, "device_ms": dev_ms,
           "library_device_ms": lib_dev, "segment_sum_ms": seg_ms,
           "segment_sum_device_ms": seg_dev,
           "segment_sum_bit_stable": seg_stable,
           "shape": [n, int(perm.numel()), b], "rows_with_a_run": used,
           "max_run": int(runs.max()) if n else 0,
           "host_ms": host_ms(lambda: combine_call(y, flat, order)),
           "matrix": matrix,
           "bytes": byt, "one_element_add_device_ms": one_element_ms()}
    print(f"  combine {label}: {ms:.4f} ms ({dev_ms:.4f} on the card, "
          f"{row['host_ms']:.4f} to enqueue), "
          f"bound {max(b_ms, f_ms):.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_add_ {lib_ms:.4f} ms ({lib_dev:.4f}), segment_sum "
          f"{seg_ms:.4f} ms ({seg_dev:.4f}, bits repeat: {seg_stable}), "
          f"launches {launches}")
    return row


COMBINE_FIRST = "col shard 0 B=1"        # the row PRs 19-26 reported


@functools.lru_cache(maxsize=1)
def one_element_ms() -> float:
    """``device_ms`` of a one-element ``add_``: the least a launch takes
    on this card, beside which the combine's small shapes are read."""
    t = torch.zeros(1, device="cuda")
    return device_ms(lambda: t.add_(1))


def shifted_rowmaps(rm: torch.Tensor, n_out: int) -> torch.Tensor:
    """A (n, T', R) rowmap stack as one (n T', R) rowmap whose shard i
    adds into rows [i n_out, (i + 1) n_out): the folded call's rowmap,
    built here so that a package without the fold is timed on it too."""
    n = rm.shape[0]
    shift = torch.arange(n, device=rm.device).reshape(
        (n,) + (1,) * (rm.ndim - 1)) * n_out
    out = torch.where(rm >= 0, rm.long() + shift, -1)
    return out.reshape((-1,) + tuple(rm.shape[2:]))


def combine_rows(plans, xs, launches: int) -> list:
    """The kernels-line rows of the ordered combine at the sharded shapes:
    shard 0's first family step of the col-mode and the row-mode serving
    plans at B = 1 and 8, and all four col-mode shards' partials of that
    step in one launch (the folded call's shape), B = 1."""
    from repro_torch.kernels import ops
    rows = []
    by_mode = {p.mode: p for p in plans}
    for mode in ("col", "row"):
        plan = by_mode[mode]
        st, op0 = plan.steps[0], plan.operands[0]
        width = -(-plan.n_cols // plan.n_shards)
        for x in xs:
            b = x.shape[1] if x.ndim == 2 else 1
            x0 = (x[:width] if mode == "col" else x).contiguous()
            flat, key = step_partials(st, op0.fmt, x0)
            flat = flat.reshape((-1,) + tuple(x.shape[1:]))
            n_out = plan.band_rows if mode == "row" else plan.n_rows
            rows.append(combine_entry(
                f"{mode} shard 0 B={b}" if mode == "row" or b > 1
                else COMBINE_FIRST, flat, shard_order(op0, key, n_out),
                op0.fmt[key],
                launches, f"serving ({mode}-mode shard 0, "
                f"{family_kernel(st, b > 1)} family)"))
    plan = by_mode["col"]
    st = plan.steps[0]
    n, width = plan.n_shards, -(-plan.n_cols // plan.n_shards)
    x = torch.cat([xs[0], xs[0].new_zeros(n * width - plan.n_cols)])
    parts = [step_partials(st, op.fmt, x[i * width:(i + 1) * width])
             for i, op in enumerate(plan.operands)]
    flat = torch.cat([p.reshape(-1) for p, _ in parts])
    rm = shifted_rowmaps(plan.stacks[parts[0][1]], plan.n_rows)
    rows.append(combine_entry("folded col B=1", flat,
                              ops.combine_order(rm, n * plan.n_rows), rm,
                              launches, f"serving (col mode, {n} shards "
                              "in one launch)"))
    return rows


def searched_shards(P, xp, oracle_p, mesh, designer) -> list:
    """(b) ``dist_search`` of the power-law operand on ``DIST_SHARDS``
    shards of the card (row mode, nnz balance, a coarse budget a shard),
    held to the oracle at B = 1 and 8; then again with shard 0's search
    crashing, which must fall back and stay right."""
    import warnings
    import repro_torch
    from repro_torch.dist.search import (ShardedSearchConfig, dist_search,
                                         shard_fault_hook)
    cfg = ShardedSearchConfig(mode="row", balance="nnz",
                              search=repro_torch.SearchConfig(**DIST_SEARCH))
    rng = np.random.default_rng(3)
    x8 = rng.standard_normal((P.n_cols, 8)).astype(np.float32)
    o8 = oracle_cols(P, x8)
    x8 = torch.from_numpy(x8).cuda()

    def crash(shard):
        if shard.index == 0:
            raise RuntimeError("injected shard crash")

    programs = []
    for tag, hook in (("searched", None), ("shard 0 crashes", crash)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with shard_fault_hook(hook) if hook else contextlib.nullcontext():
                res = timed(f"dist_search powerlaw ({tag})", designer,
                            dist_search, P, mesh, cfg)
        prog = res.program
        errs = [check_dist(f"dist_search ({tag}) B=1", prog(xp), oracle_p),
                check_dist(f"dist_search ({tag}) B=8", prog(x8), o8)]
        calls = [check_launches(f"dist_search ({tag}) B={b}",
                                lambda x=x: prog(x), prog.steps,
                                len(prog.operands), b > 1,
                                mesh.shared_device is not None)
                 for b, x in ((1, xp), (8, x8))]
        if hook:
            require(res.failed_shards() == [0]
                    and res.failure_counts.get("fallback") == 1,
                    f"shard 0 did not fall back: {res.failure_counts}")
        shards = [{"shard": r.shard.index, "nnz": r.shard.matrix.nnz,
                   "family": r.family, "searched": r.searched,
                   "graph": r.graph_label, "failed": r.failed,
                   "failure": r.failure,
                   "best_ms": (None if r.result is None
                               else r.result.best_seconds * 1e3),
                   "failures": ({} if r.result is None
                                else r.result.failure_counts)}
                  for r in res.reports]
        print("dist_search " + json.dumps({
            "run": tag, "n_shards": len(res.reports),
            "heterogeneous": res.is_heterogeneous(),
            "families": [st["report"] for st in prog.steps],
            "failure_counts": res.failure_counts,
            "stacked_slots_over_nnz": sum(
                prog.stacks[f"{st['key']}_vals"].numel()
                for st in prog.steps) / P.nnz,
            "seconds": designer[f"dist_search powerlaw ({tag})"],
            "max_abs_err": errs, "launches_b1": calls[0],
            "launches_b8": calls[1], "shards": shards,
            "ms_b1": cuda_ms(lambda: prog(xp)),
            "device_ms_b1": device_ms(lambda: prog(xp))}))
        programs.append(prog)
    return programs, x8


def sharded_layer(W, mesh, designer) -> None:
    """(c) ``sparsify_linear_sharded`` on the serving weight (phase 6's
    random weight from seed 0) answers an (8, 4096) batch."""
    import warnings
    from repro_torch.serve import sparsify_linear_sharded
    w = np.random.default_rng(0).standard_normal((12288, 4096),
                                                 dtype=np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        layer = timed("sparsify_linear_sharded(12288 x 4096, 0.08)",
                      designer, sparsify_linear_sharded, w, mesh, 0.08)
    require(layer.matrix.nnz == W.nnz, "the sharded layer pruned otherwise")
    X = np.random.default_rng(4).standard_normal((8, 4096)).astype(
        np.float32)
    X = torch.from_numpy(X).cuda()
    Y = layer(X)
    require(Y.is_cuda and tuple(Y.shape) == (8, 12288), "bad layer output")
    check_launches("sparsify_linear_sharded B=8", lambda: layer(X),
                   layer.program.steps, layer.program.n_shards, True,
                   mesh.shared_device is not None)
    check_dist("sparsify_linear_sharded (8, 4096) batch", Y.T,
               oracle_cols(W, X.cpu().numpy().T))


def dist_phase(W, P, xp, oracle_p, x8, oracle8, dense, designer,
               report: bool = False) -> list:
    """Phase 12: sharded SpMV on one card (``repro_torch.dist``); returns
    the ordered combine's kernels-line rows at the sharded shapes. With
    ``report`` (``--kernel-report``) only (a), the serving plans, and the
    combine rows."""
    from repro_torch.dist import make_data_mesh
    from repro_torch.kernels import ops
    done = phase("12 sharded SpMV (4 shards on one card)")
    mesh = make_data_mesh(DIST_SHARDS, device="cuda:0")
    xs = [torch.from_numpy(np.ascontiguousarray(x8[:, 0])).cuda(),
          torch.from_numpy(x8).cuda()]
    oracles = [oracle8[:, 0], oracle8]
    csr = csr_on_device(W)
    reset_launch_counts()                    # phase 12 starts here
    ops.rowmap_combine.launches = 0
    beside = {f"dense_{k}": v for k, v in timed_pair(dense, *xs).items()}
    beside.update({f"cusparse_{k}": v for k, v in
                   timed_pair(lambda x: csr @ x, *xs).items()})
    plans = [serving_sharded(W, mode, mesh, xs, oracles, beside, designer)
             for mode in ("row", "col")]
    progs, xp8 = ([], None) if report else searched_shards(
        P, xp, oracle_p, mesh, designer)
    if not report:
        sharded_layer(W, mesh, designer)
    torch.cuda.synchronize()
    launches = dist_launches()               # ... and ends here
    want = {family_kernel(st, b) for p in plans + progs for st in p.steps
            for b in (False, True)} | {"combine"}
    print(f"  phase-12 launches: {launches}; expected {sorted(want)}")
    require(all(launches[k] > 0 for k in want),
            f"a kernel of the sharded path never launched: {launches}")
    for p in plans:
        check_shard_kernels(f"serving {p.mode}", p, *xs)
    for p, tag in zip(progs, ("searched", "shard 0 crashed")):
        check_shard_kernels(f"powerlaw {tag}", p, xp, xp8)
    rows = combine_rows(plans, xs, launches["combine"])
    del csr
    torch.cuda.empty_cache()
    done()
    return rows


# -------------------------------- phase 13 --------------------------------

QWEN, DEEPSEEK, MAMBA = "qwen3-8b", "deepseek-moe-16b", "mamba2-1.3b"
LLM_TOL = 2e-3           # tests/test_models.py: decode vs forward, rtol = atol
F64_TOL = 1e-3           # the card against float64 on the CPU, x max|y|
MOE_RTOL, MOE_ATOL = 2e-4, 2e-5   # tests/test_models.py: sorted vs onehot


def llm_cfg(name: str, n_layers=None, **moe):
    """An assigned architecture at full width, its depth cut to
    ``n_layers`` (None: the published depth), its MoE fields replaced."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def within_2e3(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """``got`` against ``want`` by the reference test's rule, |got - want|
    <= 2e-3 + 2e-3 * |want| everywhere; returns the max abs error."""
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    require(g.shape == w.shape and np.isfinite(g).all(),
            f"{label}: bad shape or non-finite values")
    err = np.abs(g - w)
    excess = float((err - (LLM_TOL + LLM_TOL * np.abs(w))).max())
    print(f"  {label}: max_abs_err {err.max():.3e} (rule 2e-3 + 2e-3|ref|, "
          f"worst excess {excess:.3e})")
    require(excess <= 0, f"{label}: outside the 2e-3 rule")
    return float(err.max())


def tree_bytes(tree) -> int:
    from repro_torch.models.model import _leaves
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def decode_against_forward(label, model, tokens, start: int = 0,
                           caches=None) -> float:
    """Stepwise ``decode_step`` from position ``start`` (fresh caches, or
    ``caches`` from a prefill) against ``forward`` over ``tokens``."""
    b, s = tokens.shape
    full, _ = model(tokens)
    if caches is None:
        caches = model.cache_spec(b, s)
    errs = []
    for t in range(start, s):
        step, caches = model.decode_step(tokens[:, t: t + 1],
                                         torch.tensor(t), caches)
        g, w = step[:, 0].cpu().numpy(), full[:, t].float().cpu().numpy()
        require(np.isfinite(g).all(), f"{label}: non-finite logits at {t}")
        excess = (np.abs(g - w) - (LLM_TOL + LLM_TOL * np.abs(w))).max()
        require(excess <= 0, f"{label}: position {t} outside the 2e-3 rule "
                f"(excess {excess:.3e})")
        errs.append(float(np.abs(g - w).max()))
    print(f"  {label}: {len(errs)} decoded positions within 2e-3 of forward "
          f"(max_abs_err {max(errs):.3e})")
    return max(errs)


def serve_solo_and_joined(cfg, params, dev) -> dict:
    """A request served alone against the same request joining mid-flight,
    two steps behind its neighbour: the same tokens, bit-identical slot
    caches."""
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    sc = ServeConfig(max_batch=2, max_seq=64, max_new_tokens=6)
    prompts = ([11, 22, 33], [7, 8, 9, 10, 11])

    def solo(prompt):
        eng = ServingEngine(cfg, sc, params=params, device=dev)
        r = Request(0, np.asarray(prompt))
        eng.run([r])
        return tuple(r.out_tokens), eng, r._slot

    runs = [solo(p) for p in prompts]
    eng = ServingEngine(cfg, sc, params=params, device=dev)
    reqs = [Request(i, np.asarray(p)) for i, p in enumerate(prompts)]
    require(eng.submit(reqs[0]), "no free slot")
    eng.step()
    eng.step()
    require(eng.submit(reqs[1]), "no free slot")   # joins mid-flight
    while eng.active or eng.queue:
        eng.step()
    same_bits = True
    for (tokens, solo_eng, slot), req in zip(runs, reqs):
        require(tuple(req.out_tokens) == tokens,
                f"joined request {req.rid}: tokens {req.out_tokens} differ "
                f"from the solo run's {tokens}")
        for c_solo, c_join in zip(solo_eng.executor.caches,
                                  eng.executor.caches):
            same_bits &= all(torch.equal(c_solo[k][:, slot],
                                         c_join[k][:, req._slot])
                             for k in c_solo)
    require(same_bits, "a joined slot's caches differ from the solo run's")
    print(f"  mid-flight join: tokens {[r.out_tokens for r in reqs]} equal "
          "the solo runs', slot caches bit-identical")
    return {"tokens": [r.out_tokens for r in reqs], "bit_identical": True}


def block_and_head_f64(model, tokens) -> float:
    """The first pattern block, the final norm and the head on the card
    (fp32) against the same port functions on the CPU in float64."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = model.cfg
    specs = M.pattern_specs(cfg)

    def run(params, block, h):
        pos = torch.arange(h.shape[1], device=h.device)[None]
        h, _ = M._block_body(cfg, specs, block, h, pos)
        return M._logits(cfg, params, L.apply_norm(params["final_norm"], h))

    block0 = M.block_views(model.params)[0]
    with torch.inference_mode():
        h = model.params["embed"][tokens]
        y = run(model.params, block0, h)
        # the head's weights (the embedding only where it is tied)
        part = {k: model.params[k] for k in ("final_norm", "lm_head")
                if k in model.params}
        if cfg.tie_embeddings:
            part["embed"] = model.params["embed"]
        to64 = functools.partial(M.tree_map, lambda t: t.detach().cpu()
                                 .double())
        y64 = run(to64(part), to64(block0), h.cpu().double())
    err = float((y.double().cpu() - y64).abs().max())
    tol = F64_TOL * float(y64.abs().max()) + 1e-5
    print(f"  block 0 + head on the card vs float64 on the CPU: max_abs_err "
          f"{err:.3e} (tol {tol:.3e})")
    require(err <= tol, "block 0 + head disagree with float64")
    return err


def llm_correctness(dev) -> dict:
    """(a) qwen3-8b at full width, depth 2, fp32 on the card."""
    from repro_torch.models import CausalLM
    cfg = llm_cfg(QWEN, 2)
    model = CausalLM(cfg, seed=0, device=dev)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "param_bytes": tree_bytes(model.params)}
    rng = np.random.default_rng(13)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))).to(dev)
    with torch.inference_mode():
        out["decode_vs_forward"] = decode_against_forward(
            "qwen3 decode_step vs forward", model, tokens)
        full, _ = model(tokens)
        last, pre = model.prefill(tokens)
        out["prefill_vs_forward"] = within_2e3(
            "qwen3 prefill vs forward (last position)", last[:, 0],
            full[:, -1])
        caches = model.cache_spec(2, 16)
        for t in range(16):
            _, caches = model.decode_step(tokens[:, t: t + 1],
                                          torch.tensor(t), caches)
        out["prefill_caches_vs_decode"] = max(
            within_2e3(f"qwen3 prefill {k} cache vs decoded", p[k], c[k])
            for p, c in zip(pre, caches) for k in p)
    out["f64_max_abs_err"] = block_and_head_f64(model, tokens[:1, :8])
    out["join"] = serve_solo_and_joined(cfg, model.params, dev)
    print(f"llm_check {json.dumps(out)}")
    return out


def step_profile(fn) -> dict:
    """Kernels and launch calls of one ``fn()`` under ``torch.profiler``,
    and the card's busy time in them; None where the profiler saw no
    device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if getattr(e, "device_type", None) == cuda]
    kernels = [e for e in device if not e.name.startswith(("Memcpy",
                                                           "Memset"))]
    calls = [e for e in events if "LaunchKernel" in e.name]
    if not device:
        return {"kernels_per_step": None, "launch_calls_per_step": len(calls),
                "profiled_busy_ms": None}
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    return {"kernels_per_step": len(kernels),
            "launch_calls_per_step": len(calls),
            "memcpy_memset_per_step": len(device) - len(kernels),
            "profiled_busy_ms": busy_us / 1e3}


def graph_device_ms(fn, reps: int = 10) -> float:
    """``fn``'s time on the card alone: captured once in a CUDA graph and
    replayed under ``device_ms``. Eager, a decode step's thousands of
    launches fill the launch queue while the sleep kernel runs, so the
    host can never get ahead of the card; a replay is one launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return device_ms(graph.replay, reps=reps, warmup=2)


def llm_serve_full(dev) -> dict:
    """(b) qwen3-8b at full width and depth, bf16 weights on the card:
    16 seeded requests (prompts of 8-32 tokens) arrive one every two
    engine steps at a ``ServingEngine`` of 8 slots; the second eight join
    mid-flight as slots free. Then one decode step of 8 live rows is
    timed (``ms``, ``device_ms``) and profiled."""
    from repro_torch.models import padded_vocab
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    from repro_torch.serve.engine import _percentile
    cfg = llm_cfg(QWEN)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc = ServeConfig(max_batch=8, max_seq=512, max_new_tokens=32,
                     compute_dtype="bfloat16")
    eng = ServingEngine(cfg, sc, device=dev)
    ex = eng.executor
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the peak while serving, apart from the fp32 weights of the init
    # (the whole run's peak is still read at the end)
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # one step that commits nothing: cuBLAS and the allocator warm up
    ex.decode(np.zeros((8, 1), np.int32), np.zeros(8, np.int32),
              np.zeros(8, bool))
    rng = np.random.default_rng(20)
    lens = rng.integers(8, 33, 16)
    reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)))
            for i, n in enumerate(lens)]
    pending = list(reqs)
    steps, t0 = 0, time.perf_counter()
    while pending or eng.queue or eng.active:
        if pending and steps % 2 == 0:
            eng.enqueue(pending.pop(0))
        eng.step()
        steps += 1
        require(steps <= sc.max_steps, "serving did not terminate")
    wall = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated()
    failed = sum(r.failed for r in reqs)
    require(failed == 0 and all(r.done and len(r.out_tokens) == 32
                                for r in reqs),
            f"{failed} failed requests, or a request not done")
    first_done = min(r.t_done for r in reqs[:8])
    last_done = max(r.t_done for r in reqs[:8])
    joined = sum(first_done <= r.t_first <= last_done for r in reqs[8:])
    lats = sorted(r.latency_s for r in reqs)
    tokens = sum(len(r.out_tokens) for r in reqs)
    # the step: 8 live rows at depth 300
    tok, pos, rows = ex.inputs(rng.integers(0, cfg.vocab, (8, 1)),
                               np.full(8, 300), np.ones(8, bool))
    logits = ex.step(tok, pos, rows)
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    ms = cuda_ms(lambda: ex.step(tok, pos, rows), reps=10, warmup=2)
    dev_ms = graph_device_ms(lambda: ex.step(tok, pos, rows))
    prof = step_profile(lambda: ex.step(tok, pos, rows))
    wb = tree_bytes(ex.params)
    cb = tree_bytes(ex.caches)
    bound_bytes = wb + cb + 8 * padded_vocab(cfg) * 4
    line = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": "bfloat16",
            "max_batch": 8, "max_seq": 512, "max_new_tokens": 32,
            "requests": len(reqs), "prompt_tokens": int(lens.sum()),
            "tokens": tokens, "failed": failed, "joined_mid_flight": joined,
            "wall_s": wall, "tok_per_s": tokens / wall,
            "decode_steps": steps,
            "executor_decodes": steps + int(lens.sum()),
            "latency_p50_s": _percentile(lats, 50),
            "latency_p99_s": _percentile(lats, 99), "init_s": init_s,
            "step_ms": ms, "step_device_ms": dev_ms,
            "weight_bytes": wb, "weight_bound_ms": wb / HBM_BYTES_PER_S * 1e3,
            "cache_bytes": cb,
            "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
            "max_memory_allocated": max(init_peak,
                                        torch.cuda.max_memory_allocated()),
            "serve_peak_bytes": serve_peak}
    line.update(prof)
    print(f"llm_serve {json.dumps(line)}")
    require(joined > 0, "no request of the second eight joined mid-flight")
    return line


def capacity_drops(cfg, idx, impl: str) -> int:
    """(token, k) pairs past their expert's capacity, by each dispatch's
    own ranking: the one-hot cumsum over (s, k), or the stable sort."""
    from repro_torch.models import moe as MOE
    e, (b, s, k) = cfg.moe, idx.shape
    cap = MOE._capacity(cfg, s)
    if impl == "onehot":
        oh = MOE._one_hot(idx, e.n_experts, torch.float32)
        pos = torch.cumsum(oh.reshape(b, s * k, e.n_experts), 1) - 1.0
        return int(((oh.reshape(b, s * k, -1) > 0) & (pos >= cap)).sum())
    flat = idx.reshape(b, s * k)
    srt = torch.gather(flat, 1, torch.argsort(flat, dim=1, stable=True))
    counts = MOE._one_hot(srt, e.n_experts, torch.int64).cumsum(1)
    rank = torch.gather(counts, 2, srt[..., None])[..., 0] - 1
    return int((rank >= cap).sum())


def churn_routes(idx0, g0, n_experts: int, seed: int = 0):
    """tests/test_dyn.py's churn: a quarter of the tokens re-route one
    expert slot to an expert they do not use; every gate moves."""
    rng = np.random.default_rng(seed)
    idx1, g1 = idx0.copy(), g0 + 0.01
    k = idx0.shape[1]
    for t in rng.choice(len(idx0), len(idx0) // 4, replace=False):
        free = np.setdiff1d(np.arange(n_experts), idx1[t])
        idx1[t, rng.integers(k)] = rng.choice(free)
    return idx1, g1


def layer0_routes(model, toks):
    """Layer 0's router on its real input, ln2(embed + attention):
    (gates, idx), each (B, S, K)."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import block_views
    cfg, p0 = model.cfg, block_views(model.params)[0][0]
    with torch.inference_mode():
        h = model.params["embed"][toks]
        pos = torch.arange(toks.shape[1], device=toks.device)[None]
        h = h + L.attention_train(cfg, p0["attn"],
                                  L.apply_norm(p0["ln1"], h), pos)
        gates, idx, _ = MOE._router(cfg, p0["ffn"],
                                    L.apply_norm(p0["ln2"], h))
    return gates, idx


def moe_churn(cfg, model, dev) -> dict:
    """Layer 0's router on 2048 tokens of the model's own activations,
    its routing matrix compiled on ``capacity_graph()``, a 25 % churn
    patched in place: held to the oracle, the plan's ELL kernel to its
    plain version, its launches counted."""
    import repro_torch
    from repro_torch.dyn import PatternDelta, check_capacity
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe as MOE
    from repro_torch.train.dynamic import capacity_graph
    rng = np.random.default_rng(21)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 2048))).to(dev)
    gates, idx = layer0_routes(model, toks)
    idx0, g0 = idx[0].cpu().numpy(), gates[0].cpu().numpy()
    m0 = MOE.routing_matrix(idx0, g0, cfg.moe.n_experts)
    idx1, g1 = churn_routes(idx0, g0, cfg.moe.n_experts)
    m1 = MOE.routing_matrix(idx1, g1, cfg.moe.n_experts)
    delta = PatternDelta.from_matrices(m0, m1)
    require(delta.n_added == delta.n_removed > 0, "the churn moved nothing")
    x = rng.standard_normal(cfg.moe.n_experts).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    reset_launch_counts()                    # the churn run starts here
    t0 = time.perf_counter()
    plan = repro_torch.compile(m0, repro_torch.Target(),
                               graph=capacity_graph())
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    require(bool(check_capacity(plan, delta)), "the churn does not fit")
    t0 = time.perf_counter()
    upd = plan.update(delta)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    err = check_exact("routing plan after the churn", upd(xd), m1, x)
    check_exact("routing plan before the churn", plan(xd), m0, x)
    torch.cuda.synchronize()
    launches = launch_counts()               # ... and ends here
    ell = {k: launches[k] for k in ("K1", "K5") if launches[k]}
    require(ell and sum(launches.values()) == sum(ell.values()),
            f"the routing plan launched {launches}, not K1/K5 alone")
    kerr = 0.0
    for step in upd.spec["steps"]:
        o = _operands(upd, step)
        v, c = o["vals"], o["cols"]
        if step.get("fused"):
            b0 = step["combine"]["b0"]
            got = ops.ell_spmv_fused(v, c, xd, n_rows=m1.n_rows, row0=b0,
                                     tiles_per_step=upd.spec[
                                         "tiles_per_step"])
            want = ref.ell_spmv_fused_ref(v, c, xd, n_rows=m1.n_rows,
                                          row0=b0)
            kid = "K5"
        else:
            got, want, kid = ops.ell_spmv(v, c, xd), ref.ell_spmv_ref(
                v, c, xd), "K1"
        kerr = max(kerr, check_kernel(f"routing plan {step['key']} {kid} "
                                      f"{tuple(v.shape)}", got, want))
    return {"routing_nnz": m0.nnz, "routing_shape": [m0.n_rows, m0.n_cols],
            "churn": {"added": delta.n_added, "removed": delta.n_removed,
                      "revalued": delta.n_revalued},
            "steps": len(upd.spec["steps"]),
            "fused_steps": sum(bool(s.get("fused"))
                               for s in upd.spec["steps"]),
            "compile_s": compile_s, "update_ms": update_ms,
            "oracle_max_abs_err": err, "kernel_max_abs_err": kerr,
            "launches": ell, "call_ms": cuda_ms(lambda: upd(xd)),
            "call_device_ms": device_ms(lambda: upd(xd))}


def llm_moe(dev) -> dict:
    """(c) deepseek-moe-16b at full width, depth 2, fp32."""
    from repro_torch.models import CausalLM
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import block_views
    cfg = llm_cfg(DEEPSEEK, 2, impl="onehot", capacity_factor=8.0)
    model = CausalLM(cfg, seed=1, device=dev)
    p0 = block_views(model.params)[0][0]
    rng = np.random.default_rng(22)
    line = {"arch": cfg.name, "n_layers": cfg.n_layers,
            "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
            "shared": cfg.moe.n_shared, "d_expert": cfg.moe.d_expert,
            "param_bytes": tree_bytes(model.params)}
    with torch.inference_mode():
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 512))).to(dev)
        x = L.apply_norm(p0["ln2"], model.params["embed"][toks])
        for cf in (8.0, 1.25):
            cfgs = {impl: llm_cfg(DEEPSEEK, 2, impl=impl, capacity_factor=cf)
                    for impl in ("onehot", "sorted")}
            ys, t = {}, {}
            for impl, c in cfgs.items():
                ys[impl] = MOE.apply_moe(c, p0["ffn"], x)
                t[impl] = cuda_ms(lambda c=c: MOE.apply_moe(c, p0["ffn"], x),
                                  reps=5, warmup=1)
            _, idx, _ = MOE._router(cfgs["onehot"], p0["ffn"], x)
            drops = {impl: capacity_drops(c, idx, impl)
                     for impl, c in cfgs.items()}
            (y1, a1), (y2, a2) = ys["onehot"], ys["sorted"]
            d = (y1 - y2).abs()
            excess = float((d - (MOE_ATOL + MOE_RTOL * y2.abs())).max())
            print(f"  apply_moe (4, 512) cf {cf}: onehot vs sorted "
                  f"max_abs_err {float(d.max()):.3e} (worst excess "
                  f"{excess:.3e}), aux "
                  f"{float(a1):.6f} / {float(a2):.6f}, drops {drops}, ms "
                  f"{t}")
            require(drops["onehot"] == drops["sorted"],
                    f"cf {cf}: the dispatches drop {drops}")
            if cf == 8.0:
                require(excess <= 0, "onehot and sorted disagree at cf 8")
            line[f"cf{cf}"] = {"max_abs_err": float(d.max()),
                               "drops": drops["onehot"],
                               "capacity": MOE._capacity(cfgs["onehot"], 512),
                               "onehot_ms": t["onehot"],
                               "sorted_ms": t["sorted"]}
        # the train path drops past capacity and decode (one token a
        # row) never does, so decode matches forward only at a drop-free
        # capacity: tests/test_models.py's cf 8 is one for its reduced
        # config; at 64 experts top-6 and 16 tokens cf 8 gives capacity
        # 12 and layer 0 may drop. cf = E / K gives capacity = S.
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))).to(dev)
        _, idx = layer0_routes(model, tokens)
        line["layer0_drops_cf8"] = capacity_drops(cfg, idx, "onehot")
        cf_free = cfg.moe.n_experts / cfg.moe.top_k
        free = CausalLM(llm_cfg(DEEPSEEK, 2, capacity_factor=cf_free),
                        model.params, device=dev)
        require(MOE._capacity(free.cfg, 16) == 16, "not drop-free")
        line["decode_vs_forward"] = decode_against_forward(
            f"deepseek decode_step vs forward (drop-free cf {cf_free:.3f}; "
            f"layer 0 drops {line['layer0_drops_cf8']} at cf 8)", free,
            tokens)
    line.update(moe_churn(cfg, model, dev))
    print(f"llm_moe {json.dumps(line)}")
    return line


def llm_ssm(dev) -> dict:
    """(d) mamba2-1.3b at full width, depth 2, fp32: forward over 512
    tokens against prefill of 256 and 256 decode steps."""
    from repro_torch.models import CausalLM
    cfg = llm_cfg(MAMBA, 2)
    model = CausalLM(cfg, seed=2, device=dev)
    rng = np.random.default_rng(23)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 512))).to(dev)
    line = {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_state": cfg.ssm.d_state, "chunk": cfg.ssm.chunk,
            "param_bytes": tree_bytes(model.params)}
    with torch.inference_mode():
        full, _ = model(tokens)
        t0 = time.perf_counter()
        last, caches = model.prefill(tokens[:, :256])
        torch.cuda.synchronize()
        line["prefill_s"] = time.perf_counter() - t0
        line["prefill_vs_forward"] = within_2e3(
            "mamba2 prefill(256) vs forward", last[:, 0], full[:, 255])
        t0 = time.perf_counter()
        line["decode_vs_forward"] = decode_against_forward(
            "mamba2 256 decode_steps after prefill vs forward", model,
            tokens, start=256, caches=caches)
        line["decode_s"] = time.perf_counter() - t0
    print(f"llm_ssm {json.dumps(line)}")
    return line


def llm_phase(dev) -> dict:
    """Phase 13: the LLM serving path (``repro_torch.models``,
    ``ModelExecutor``, ``ServingEngine``) at full width; returns each
    part's line."""
    done = phase("13 LLM serving")
    lines = {}
    for part in (llm_correctness, llm_serve_full, llm_moe, llm_ssm):
        t0 = time.perf_counter()
        lines[part.__name__] = part(dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"  {part.__name__}: {time.perf_counter() - t0:.1f} s")
    done()
    return lines


# ------------------------------- --bits-probe ------------------------------

BITS_CALLS = 50


def bits_probe() -> None:
    """How often repeated calls give other bits, in the checkout this
    script sits in (the A/B recipe copies it into the parent's): phase
    4's power-law seg operands (chunk 2048) through K3/K4 and K10a/K10b
    (per-tile partials: the run reduction alone, no combine), the fused
    plans (K6 / K11) and the unfused plans (the kernels and their
    combine), BITS_CALLS calls each; prints the calls that differ from
    the first (a ``bits_probe {...}`` line)."""
    from repro_torch.core.graph import run_graph
    from repro_torch.core.kernel_builder import _step_cols, build_program
    from repro_torch.core.matrices import powerlaw_matrix
    from repro_torch.kernels import ops
    P = powerlaw_matrix(2 ** 20, 2 ** 20, 8.0, 1.5, seed=0)
    rng = np.random.default_rng(1)
    x1 = torch.from_numpy(rng.standard_normal(P.n_cols).astype(
        np.float32)).cuda()
    x8 = torch.from_numpy(rng.standard_normal((P.n_cols, 8)).astype(
        np.float32)).cuda()
    out = {}

    def count(name, fn):
        y0 = fn()
        out[name] = sum(not torch.equal(fn(), y0)
                        for _ in range(BITS_CALLS - 1))

    for red, mode in (("ONEHOT_MXU_RED", "onehot_mxu"),
                      ("SEG_SCAN_RED", "seg_scan")):
        meta = run_graph(P, chain(("COMPRESS", {}), ("LANE_NNZ_BLOCK",
                                                      {"chunk": 2048}),
                                  (red, {})))
        fused = build_program(meta, "cuda", tiles_per_step=4)
        unfused = build_program(meta, "cuda", fuse_combine=False)
        st = fused.spec["steps"][0]
        f, k = fused.fmt, st["key"]
        v = f[f"{k}_vals"]
        c = _step_cols(st, f, v.device)
        local, end, M = f.get(f"{k}_local"), f.get(f"{k}_end"), st["seg_rows"]
        count(f"{mode} tiles B=1 (K3/K4)",
              lambda: ops.seg_spmv(v, c, local, end, x1, M, mode=mode))
        count(f"{mode} tiles B=8 (K10)",
              lambda: ops.seg_spmm(v, c, local, end, x8, M, mode=mode))
        count(f"{mode} fused plan B=1 (K6)", lambda: fused(x1))
        count(f"{mode} fused plan B=8 (K11)", lambda: fused(x8))
        count(f"{mode} unfused plan B=1", lambda: unfused(x1))
        count(f"{mode} unfused plan B=8", lambda: unfused(x8))
    print("bits_probe " + json.dumps({"calls": BITS_CALLS,
                                      "differing_calls": out}))


# ------------------------------- --bits-dump -------------------------------

# x of every --bits-dump output: (n_cols,) and (n_cols, 8) from these seeds
BITS_DUMP_SEEDS = {1: 31, 8: 32}


def bits_dump(out_dir: Path, label: str) -> None:
    """Writes ``out_dir/label.pt`` (``torch.save``): the outputs, at B = 1
    and 8 from fixed seeds (each call's ``device_ms`` on the
    ``bits_dump`` line), of the plans whose sums go through the ordered
    combine: phase 12's sharded serving plans (row and col, 4 shards of
    the card), both ``dist_search`` programs (searched, and shard 0
    crashing), phase 4's unfused power-law plans, phase 6's searched
    serving plan and phase 7's ELL plan of 26 width buckets, scatter and
    with its single-tile buckets fused. Each plan is made, saved under
    ``out_dir/plans`` and
    loaded the first time, and loaded from there every later time, so two
    checkouts (this script copied into a parent's) run the same plans:
    a search's winner depends on timing. Uses only sharded plans and
    ``api._plan_from_program``, which older packages have too."""
    import warnings
    import repro_torch
    from repro_torch.api import ShardedSpmvPlan, _plan_from_program
    from repro_torch.core.graph import run_graph
    from repro_torch.core.kernel_builder import build_program
    from repro_torch.core.matrices import powerlaw_matrix
    from repro_torch.dist import make_data_mesh
    from repro_torch.dist.search import (ShardedSearchConfig, dist_search,
                                         shard_fault_hook)
    plans_dir = out_dir / "plans"
    plans_dir.mkdir(parents=True, exist_ok=True)
    mesh = make_data_mesh(DIST_SHARDS, device="cuda:0")
    designer, mats = {}, {}

    def matrix(name):
        if name not in mats:
            mats[name] = (serving_matrix(designer) if name == "serving" else
                          powerlaw_matrix(2 ** 20, 2 ** 20, 8.0, 1.5,
                                          seed=0))
        return mats[name]

    def load(name, make, sharded):
        path = plans_dir / f"{name}.plan.npz"
        if not path.is_file():
            make().save(path)
        return repro_torch.load_plan(path, mesh=mesh if sharded else None)

    def crash(shard):
        if shard.index == 0:
            raise RuntimeError("injected shard crash")

    def searched(hook):
        cfg = ShardedSearchConfig(
            mode="row", balance="nnz",
            search=repro_torch.SearchConfig(**DIST_SEARCH))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with shard_fault_hook(hook) if hook else \
                    contextlib.nullcontext():
                res = dist_search(matrix("powerlaw"), mesh, cfg)
        return ShardedSpmvPlan.from_program(
            res.program, repro_torch.Target(mesh=mesh, partition="row"),
            search_result=res)

    def unfused(red):
        g = chain(("COMPRESS", {}), ("LANE_NNZ_BLOCK", {"chunk": 2048}),
                  (red, {}))
        prog = build_program(run_graph(matrix("powerlaw"), g), "cuda",
                             fuse_combine=False)
        return _plan_from_program(prog, None, repro_torch.Target())

    def serving_ell(fuse):
        """Phase 7's ELL plan of the serving matrix: 26 width buckets,
        scatter (``fuse``: its single-tile buckets fused)."""
        g = chain(("COMPRESS", {}), ("TILE_ROW_BLOCK", {"rows": 128}),
                  ("LANE_ROW_BLOCK", {}), ("LANE_TOTAL_RED", {}))
        prog = build_program(run_graph(matrix("serving"), g), "cuda",
                             fuse_combine=fuse)
        return _plan_from_program(prog, None, repro_torch.Target(
            batch_size=SERVE_B))

    def serving_searched():
        cfg = repro_torch.SearchConfig(
            max_seconds=SEARCH_SECONDS["serving"], max_structures=2,
            coarse_samples=2, fine_eval_budget=0, use_cost_model=False,
            timing_repeats=3, seed=0)
        return repro_torch.compile(matrix("serving"), repro_torch.Target(
            batch_size=SERVE_B), budget=cfg)

    cases = {f"sharded {mode}": ("serving", lambda mode=mode:
                                 repro_torch.compile(
                                     matrix("serving"), repro_torch.Target(
                                         mesh=mesh, partition=mode)), True)
             for mode in ("row", "col")}
    cases["dist_search searched"] = ("powerlaw", lambda: searched(None),
                                     True)
    cases["dist_search shard 0 crashes"] = ("powerlaw",
                                            lambda: searched(crash), True)
    for red in ("SEG_SCAN_RED", "ONEHOT_MXU_RED", "GMEM_ATOM_RED"):
        cases[f"powerlaw {red} unfused"] = ("powerlaw",
                                            lambda red=red: unfused(red),
                                            False)
    cases["serving searched"] = ("serving", serving_searched, False)
    cases["serving ELL scatter"] = ("serving", lambda: serving_ell(False),
                                    False)
    cases["serving ELL fused"] = ("serving", lambda: serving_ell(True),
                                  False)
    out, card = {}, {}
    for name, (m, make, sharded) in cases.items():
        plan = load(name.replace(" ", "_"), make, sharded)
        for b, seed in BITS_DUMP_SEEDS.items():
            rng = np.random.default_rng(seed)
            x = torch.from_numpy(rng.standard_normal(
                (plan.n_cols,) if b == 1 else (plan.n_cols, b)).astype(
                np.float32)).cuda()
            out[f"{name} B={b}"] = plan(x).cpu()
            card[f"{name} B={b}"] = device_ms(lambda: plan(x))
        del plan
        torch.cuda.empty_cache()
    torch.save(out, out_dir / f"{label}.pt")
    print("bits_dump " + json.dumps({"label": label, "outputs": sorted(out),
                                     "host_seconds": designer,
                                     "device_ms": card}))


def bits_compare(out_dir: Path) -> None:
    """Every ``out_dir/*.pt`` of ``--bits-dump`` against the first (by
    name): each output ``torch.equal``; a ``bits_compare {...}`` line,
    and a failure on any output that differs."""
    files = sorted(out_dir.glob("*.pt"))
    require(len(files) >= 2, f"fewer than two dumps in {out_dir}")
    first = torch.load(files[0])
    differ = {}
    for f in files[1:]:
        other = torch.load(f)
        require(sorted(other) == sorted(first), f"{f.name}: other outputs")
        differ[f.name] = sorted(k for k in first
                                if not torch.equal(first[k], other[k]))
    print("bits_compare " + json.dumps({"against": files[0].name,
                                        "outputs": len(first),
                                        "differing": differ}))
    require(not any(differ.values()), f"outputs differ: {differ}")


SPLIT_ROUNDS = 3


def _cut_flush(rows) -> dict:
    """``rows`` (a ``FusedRows``) with its flush cut down: no segment used
    (``no_flush``), every pair mapped to nothing (``flush_reads_only``:
    dst and n_used read, nothing written) and every used pair added by an
    atomic into its row (``all_atomic``: the placement without an order,
    no side slot)."""
    d = rows.dst.long()
    direct = d.clone()
    if rows.n_side:
        of_slot = torch.empty(rows.n_side, dtype=torch.long, device=d.device)
        of_slot[rows.perm.long()] = torch.repeat_interleave(
            rows.rows.long(), rows.offsets[1:] - rows.offsets[:-1])
        pairs, slot = shared_slots(rows)
        direct[pairs] = of_slot[slot]
    empty = {f: rows.dst[:0] for f in ("perm", "rows", "slot_row", "count",
                                       "arrive") if f in rows._fields}
    if "cells" in rows._fields:
        empty["cells"] = rows.cells[:0]
    return {"no_flush": rows._replace(n_used=torch.zeros_like(rows.n_used)),
            "flush_reads_only": rows._replace(
                dst=torch.full_like(rows.dst, -1)),
            "all_atomic": rows._replace(
                dst=direct.to(torch.int32), n_side=0,
                offsets=torch.zeros(1, dtype=torch.int64, device=d.device),
                **empty)}


def split_line(label, prog, x, n_rows, tps=(4,)) -> None:
    """One ``fused_split {...}`` line: the card time of the fused step of
    ``prog`` (its one seg step) and of its parts, on x ((n,) for K6, (n,
    B) for K11); see :func:`fused_split`."""
    from repro_torch.core.kernel_builder import _step_cols
    from repro_torch.kernels import ops
    from repro_torch.kernels import seg_spmv as segmod
    st = prog.spec["steps"][0]
    f, key = prog.fmt, st["key"]
    v = f[f"{key}_vals"]
    c = _step_cols(st, f, v.device)
    local, end, r0 = f.get(f"{key}_local"), f.get(f"{key}_end"), f[f"{key}_r0"]
    M = st["seg_rows"]
    mode = "seg_scan" if st["reduce"] == "gmem_atom" else st["reduce"]
    rows = fused_kw(v, local, end, r0, M, n_rows, mode)["rows"]
    fop = ops.seg_spmv_fused if x.ndim == 1 else ops.seg_spmm_fused
    uop = ops.seg_spmv if x.ndim == 1 else ops.seg_spmm
    out = torch.zeros((n_rows,) + tuple(x.shape[1:]), device=x.device)
    second = getattr(segmod, "launch_combine", None)

    def fused(r, k=tps[0], alone=False):
        if alone and second is not None:  # the kernel without its second
            segmod.launch_combine = lambda *a, **kw: None   # launch
        try:
            fop(v, c, local, end, r0, x, M, n_rows=n_rows, mode=mode,
                tiles_per_step=k, out=out, rows=r)
        finally:
            if second is not None:
                segmod.launch_combine = second

    fns = {"unfused": lambda: uop(v, c, local, end, x, M, mode=mode)}
    fns.update({f"fused_tps{k}": functools.partial(fused, rows, k)
                for k in tps})
    if second is not None:
        fns["kernel_only"] = functools.partial(fused, rows, alone=True)
        side = torch.zeros((rows.n_side,) + tuple(x.shape[1:]),
                           device=x.device)
        fns["combine_only"] = lambda: second(out, side, rows.perm,
                                             rows.offsets, rows.rows)
    for name, r in _cut_flush(rows).items():
        fns[name] = functools.partial(fused, r, alone=True)
    times = {k: [] for k in fns}
    for _ in range(SPLIT_ROUNDS):
        for k, fn in fns.items():
            times[k].append(device_ms(fn))
    cnt = rows.offsets[1:] - rows.offsets[:-1]
    line = {"operand": label, "mode": mode, "shape": list(v.shape) + [M],
            "B": 1 if x.ndim == 1 else int(x.shape[1]),
            "n_side": rows.n_side, "shared_rows": int(rows.rows.numel()),
            "most_writers": int(cnt.max()) if cnt.numel() else 0,
            "second_launch": second is not None,
            "device_ms": {k: statistics.median(t) for k, t in times.items()},
            "rounds": times}
    print("fused_split " + json.dumps(line), flush=True)


def fused_split() -> None:
    """What a fused seg step (K6, K11) spends beyond its unfused kernel, in
    the checkout this script sits in (the A/B recipe copies it into the
    parent's): the card time of the unfused kernel (K3/K4, K10a/K10b), the
    fused call, and the fused kernel with its flush cut down
    (:func:`_cut_flush`); where the package adds shared rows in a second
    launch (``seg_spmv.launch_combine``), also the call without it
    (``kernel_only``) and that launch alone (``combine_only``). On phase
    4's power-law operands (K6 in both modes; one-hot at tiles_per_step
    1, 2, 4 and 8) and on the serving matrix (K11 at C = 2048 and 512, B
    = 8; K6 at C = 512). The median of SPLIT_ROUNDS rounds."""
    from repro_torch.core.graph import run_graph
    from repro_torch.core.kernel_builder import build_program
    from repro_torch.core.matrices import powerlaw_matrix
    P = powerlaw_matrix(2 ** 20, 2 ** 20, 8.0, 1.5, seed=0)
    rng = np.random.default_rng(1)
    xp = torch.from_numpy(rng.standard_normal(P.n_cols).astype(
        np.float32)).cuda()
    for red, tps in (("ONEHOT_MXU_RED", (4, 1, 2, 8)), ("SEG_SCAN_RED", (4,))):
        meta = run_graph(P, chain(("COMPRESS", {}), ("LANE_NNZ_BLOCK",
                                                      {"chunk": 2048}),
                                  (red, {})))
        split_line("powerlaw", build_program(meta, "cuda", tiles_per_step=4),
                   xp, P.n_rows, tps)
    W = serving_matrix({})
    x8 = torch.from_numpy(rng.standard_normal((W.n_cols, 8)).astype(
        np.float32)).cuda()
    for red, chunk in (("SEG_SCAN_RED", 2048), ("ONEHOT_MXU_RED", 2048),
                       ("SEG_SCAN_RED", 512)):
        meta = run_graph(W, chain(("COMPRESS", {}), ("LANE_NNZ_BLOCK",
                                                      {"chunk": chunk}),
                                  (red, {})))
        prog = build_program(meta, "cuda", tiles_per_step=4)
        split_line(f"serving C={chunk}", prog, x8, W.n_rows)
        if chunk == 512:
            split_line(f"serving C={chunk}", prog, x8[:, 0].contiguous(),
                       W.n_rows)


# -------------------------------- phase 14 --------------------------------

GRANITE = "granite-3-2b"
# (a) the card's fp32 step against float64 on the card: loss and
# grad_norm relative, gradients as max abs error over max |float64|
# (about 8x the 1.3e-6 measured on an H100, so that a TF32 step, the
# control below, fails it); remat on against off the same; after one
# AdamW step, PARAMS_SHARE of the parameters within PARAMS_CLOSE (1 % of
# lr, the step a parameter moves by) and every one within 2 lr (a
# gradient near 0 whose fp32 sign differs moves its parameter by up to
# 2 lr in AdamW's first step)
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "grads": 1e-5, "remat": 1e-5}
PARAMS_CLOSE, PARAMS_SHARE = 1e-5, 0.999
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 (data sheet)


def adamw_f64(opt, grads, params, gnorm: float):
    """The reference's first AdamW step (count 1, zero moments) in
    float64, written out here as the plain version the card's float32
    step is held to."""
    from repro_torch.train.optimizer import _map
    warm = min(1 / max(opt.warmup_steps, 1), 1.0)
    frac = min(max((1 - opt.warmup_steps)
                   / max(opt.total_steps - opt.warmup_steps, 1), 0.0), 1.0)
    lr = opt.lr * warm * (0.1 + 0.9 * 0.5 * (1 + np.cos(np.pi * frac)))
    scale = min(1.0, opt.grad_clip / (gnorm + 1e-9))

    def upd(g, p):
        g = g * scale
        mh = (1 - opt.b1) * g / (1 - opt.b1)
        vh = (1 - opt.b2) * g * g / (1 - opt.b2)
        return p - lr * (mh / (torch.sqrt(vh) + opt.eps)
                         + opt.weight_decay * p)
    return _map(upd, grads, params), lr


def rel_tree_err(got, want) -> float:
    from repro_torch.train.optimizer import tree_leaves
    scale = max(float(w.abs().max()) for w in tree_leaves(want))
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(tree_leaves(got), tree_leaves(want))) / scale


def train_check(dev) -> None:
    """(a) granite-3-2b at full width, depth 2, batch 2 x 128 (synthetic
    batch 0): one fp32 step on the card against the same step in float64
    on the card, and remat on against off. A control runs the fp32
    gradients once more with TF32 matmuls allowed: the gradient check must
    fail it, or it could not tell TF32 from fp32."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import AdamWConfig, _map, tree_leaves
    from repro_torch.train.step import (TrainConfig, init_state,
                                        make_grad_fn, make_train_step)
    cfg = llm_cfg(GRANITE, n_layers=2)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tc = TrainConfig(opt=opt, compute_dtype="float32", remat=True)
    batch = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=128, global_batch=2, seed=0)).batch_at(0)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    p32 = init_params(cfg, 0, dev)
    (l32, _), g32 = make_grad_fn(cfg, tc)(p32, tb)
    no_remat = make_grad_fn(cfg, dataclasses.replace(tc, remat=False))
    _, g_off = no_remat(p32, tb)
    remat_err = rel_tree_err(g32, g_off)
    del g_off
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        (l_tf32, _), g_tf32 = no_remat(p32, tb)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    p64 = _map(lambda t: t.double(), p32)
    (l64, _), g64 = make_grad_fn(cfg, dataclasses.replace(
        tc, compute_dtype="float64", remat=False))(p64, tb)
    grads_err = rel_tree_err(g32, g64)
    tf32_err = rel_tree_err(g_tf32, g64)
    gn64 = float(torch.sqrt(sum(torch.sum(g * g)
                                for g in tree_leaves(g64))))
    new64, lr = adamw_f64(opt, g64, p64, gn64)
    del g64, g32, g_tf32, p64
    state = init_state(cfg, tc, _map(torch.clone, p32))
    state, met = make_train_step(cfg, tc)(state, batch)
    torch.cuda.synchronize()
    perr = torch.cat([(a.double() - b).abs().reshape(-1) for a, b in zip(
        tree_leaves(state["params"]), tree_leaves(new64))])
    loss, gn = float(met["loss"]), float(met["grad_norm"])
    out = {"arch": GRANITE, "n_layers": cfg.n_layers, "batch": [2, 128],
           "params": sum(t.numel() for t in tree_leaves(p32)),
           "loss": loss, "loss_f64": float(l64),
           "loss_rel_err": abs(loss - float(l64)) / abs(float(l64)),
           "grad_norm": gn, "grad_norm_f64": gn64,
           "grad_norm_rel_err": abs(gn - gn64) / gn64,
           "grads_rel_err": grads_err, "remat_rel_err": remat_err,
           "params_max_abs_err": float(perr.max()),
           "params_share_within": float((perr <= PARAMS_CLOSE).double()
                                        .mean()),
           "lr": lr, "tf32_control": {
               "grads_rel_err": tf32_err,
               "loss_rel_err": abs(float(l_tf32) - float(l64))
               / abs(float(l64))},
           "tol": dict(TRAIN_TOL, params_max=2 * lr,
                       params_close=PARAMS_CLOSE,
                       params_share=PARAMS_SHARE)}
    print("train_check " + json.dumps(out))
    require(abs(float(l32) - loss) == 0.0,
            "the step's loss is not its grad_fn's")
    for k, key in (("loss", "loss_rel_err"),
                   ("grad_norm", "grad_norm_rel_err"),
                   ("grads", "grads_rel_err"), ("remat", "remat_rel_err"),
                   ("params_max", "params_max_abs_err")):
        require(out[key] <= out["tol"][k],
                f"train_check {key} {out[key]:.3e} > {out['tol'][k]:.3e}")
    require(out["params_share_within"] >= PARAMS_SHARE,
            f"train_check: {out['params_share_within']:.5f} of the "
            f"parameters within {PARAMS_CLOSE}, not {PARAMS_SHARE}")
    require(tf32_err > TRAIN_TOL["grads"],
            f"train_check: the TF32 control's gradients ({tf32_err:.3e}) "
            f"pass the fp32 tolerance {TRAIN_TOL['grads']}")
    del state, new64, p32, perr
    torch.cuda.empty_cache()


def model_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (PaLM's count): 6 N per token,
    N the parameter count (the tied embedding once, as the head's
    matmul), plus 12 L H Q S per token for attention (no causal
    halving); remat's recomputation is not counted."""
    return batch * seq * (6 * cfg.n_params()
                          + 12 * cfg.n_layers * cfg.n_heads * cfg.hd * seq)


def split_timed_steps(step, state, batches):
    """Run ``step`` (a ``make_train_step``) on each batch, each timed with
    CUDA events and split where the step hands its gradients to
    ``adamw_update`` (an event recorded there): ``(state, losses,
    [(step_ms, fwd_bwd_ms, optimizer_ms)])``, fwd_bwd_ms + optimizer_ms
    = step_ms for each step."""
    import repro_torch.train.step as step_mod
    real = step_mod.adamw_update
    marks = []

    def marked(*args, **kw):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return real(*args, **kw)

    losses, times = [], []
    step_mod.adamw_update = marked
    try:
        for batch in batches:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            marks.clear()
            a.record()
            state, met = step(state, batch)
            b.record()
            b.synchronize()
            require(len(marks) == 1, "the step did not call adamw_update "
                    "once")
            times.append((a.elapsed_time(b), a.elapsed_time(marks[0]),
                          marks[0].elapsed_time(b)))
            losses.append(float(met["loss"]))
    finally:
        step_mod.adamw_update = real
    return state, losses, times


def train_step_full(dev) -> dict:
    """(b) granite-3-2b at full width and depth (40 layers), bf16
    compute, remat, batch 4 x 512: make_train_step for one warm-up and 6
    timed steps, each split into forward+backward and optimizer; then one
    grad_accum=2 step beside the grad_accum=1 loss on its batch."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import (TrainConfig, init_state,
                                        make_train_step)
    cfg = llm_cfg(GRANITE)
    B, S = 4, 512
    tc = TrainConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=2,
                                     total_steps=100),
                     compute_dtype="bfloat16", remat=True)
    pipe = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S,
                                             global_batch=B, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch_at(s).items()} for s in range(8)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, tc, init_params(cfg, 0, dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, tc)
    state, met = step(state, batches[0])       # warm-up
    # the peak of the six timed steps alone (the whole part's peak is
    # still read at the end)
    pre_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, losses, split = split_timed_steps(step, state, batches[1:7])
    step_peak = torch.cuda.max_memory_allocated()
    losses.insert(0, float(met["loss"]))
    with torch.no_grad():
        loss1 = float(loss_fn(cfg, state["params"], batches[7],
                              torch.bfloat16, remat=False)[0])
    state, met2 = make_train_step(cfg, dataclasses.replace(
        tc, grad_accum=2))(state, batches[7])
    loss2 = float(met2["loss"])
    torch.cuda.synchronize()
    times = [t for t, _, _ in split]
    step_ms = statistics.median(times)
    flops = model_flops(cfg, B, S)
    out = {"arch": GRANITE, "n_layers": cfg.n_layers,
           "params": cfg.n_params(), "batch": [B, S],
           "compute_dtype": "bfloat16", "remat": True,
           "init_s": init_s, "step_ms": step_ms, "step_ms_all": times,
           "fwd_bwd_ms": statistics.median(f for _, f, _ in split),
           "optimizer_ms": statistics.median(o for _, _, o in split),
           "fwd_bwd_ms_all": [f for _, f, _ in split],
           "optimizer_ms_all": [o for _, _, o in split],
           "tokens_per_s": B * S / (step_ms / 1e3),
           "model_flops_per_step": flops,
           "model_tflops_per_s": flops / (step_ms / 1e3) / 1e12,
           "mfu_vs_bf16_peak": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "loss_grad_accum_1": loss1,
           "loss_grad_accum_2": loss2,
           "peak_memory_gb": max(pre_peak,
                                 torch.cuda.max_memory_allocated()) / 1e9,
           "step_peak_gb": step_peak / 1e9}
    print("train_step " + json.dumps(out))
    require(all(np.isfinite(losses)) and np.isfinite(loss2),
            "train_step: a non-finite loss")
    require(abs(loss2 - loss1) <= 2e-2 * abs(loss1),
            f"train_step: grad_accum=2 loss {loss2} vs {loss1}")
    del state, batches
    torch.cuda.empty_cache()
    return out


def train_driver(dev) -> None:
    """(c) TrainDriver on the card: granite-3-2b at full width, depth 2,
    batch 2 x 128, 10 steps, checkpoints every 3 steps into a temporary
    directory, compression on, a failure injected at step 7 (by then the
    step-3 save has committed: a save waits for the one in flight): it
    must restart once from a checkpoint and end with >= 8 steps run and a
    finite loss. Then one blocking save and one restore of its final
    state, timed, the restored leaves bit-identical."""
    from repro_torch.launch.train import DriverConfig, TrainDriver
    from repro_torch.train.optimizer import tree_leaves
    scratch = ROOT / "results"               # listed in .gitignore
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        dc = DriverConfig(arch=GRANITE, reduced=False, steps=10, batch=2,
                          seq=128, ckpt_dir=d, ckpt_every=3, fail_at_step=7,
                          compression=True, log_every=100, device=str(dev))
        drv = TrainDriver(dc)
        drv.cfg = llm_cfg(GRANITE, n_layers=2)     # full width, depth 2
        t0 = time.perf_counter()
        res = drv.run()
        run_s = time.perf_counter() - t0
        steps = [m["step"] for m in drv.metrics_log]
        back_at = [b for a, b in zip(steps, steps[1:]) if b <= a]
        require(res["restarts"] == 1 and res["n_steps_run"] >= 8
                and np.isfinite(res["final_loss"]) and len(back_at) == 1
                and back_at[0] > 0, f"train_driver: {res}, steps {steps}")
        last = Path(d) / f"step_{drv.ckpt.latest_step():08d}"
        ckpt_bytes = sum(f.stat().st_size for f in last.iterdir())
        t0 = time.perf_counter()
        drv.ckpt.save(99, drv.state, blocking=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = drv.ckpt.restore(99, drv.state, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        require(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(back), tree_leaves(drv.state))),
            "train_driver: a restored leaf differs")
        steps_s = [m["time"] for m in drv.metrics_log]
    print("train_driver " + json.dumps({
        **res, "n_layers": 2, "resumed_at_step": back_at[0],
        "run_s": run_s, "step_s_median":
        statistics.median(steps_s), "ckpt_bytes": ckpt_bytes,
        "save_s": save_s, "restore_s": restore_s}))
    del drv, back
    torch.cuda.empty_cache()


def train_cli() -> None:
    """(d) ``python -m repro_torch.launch.train --arch granite-3-2b
    --reduced --steps 50`` in a subprocess on the card (its default
    device): return code 0 and a finite final loss (a ``train_cli
    {...}`` line)."""
    import ast
    import os
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    scratch = ROOT / "results"               # listed in .gitignore
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             GRANITE, "--reduced", "--steps", "50", "--ckpt_dir", d],
            capture_output=True, text=True, timeout=300, env=env)
        secs = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:] + proc.stderr[-3000:])
    require(proc.returncode == 0, f"train cli: rc {proc.returncode}")
    res = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    print("train_cli " + json.dumps({"returncode": proc.returncode,
                                     "seconds": secs, **res}))
    require(res["n_steps_run"] == 50 and np.isfinite(res["final_loss"]),
            f"train cli: {res}")


def train_phase(dev) -> dict:
    """Phase 14; returns (b)'s ``train_step`` line."""
    done = phase("14 training")
    train_check(dev)
    step = train_step_full(dev)
    train_driver(dev)
    train_cli()
    done()
    return step


# -------------------------------- phase 15 --------------------------------

# (a), (b): the dry run's argument + temporary bytes against the card's
# measured peak (relative); (a)'s FLOPs over phase 14's model FLOPs, the
# remat recompute (the forward counted twice, matmuls only)
DRYRUN_MEM_TOL = 0.25
DRYRUN_FLOPS_RATIO = (1.2, 1.3)
# (c): the single-pod sweep's cells and its worker processes (all 32
# cells took 139 s beside (d) on the H100 machine, and the run's total
# neared its 1200 s: the train and decode cells here, 20 cells, which
# took 108 s with 4 workers; 6 of the machine's 8 cores once the
# examples (d) have ended; the whole sweep's time is in PERF.md)
# the train cell of every architecture (decode is (b)'s cell in-process)
DRYRUN_SHAPES = "train_4k"
DRYRUN_JOBS = 6
DRYRUN_TIMEOUT_S = 420
# (d): each example at a short budget, and the check its own line must pass
EXAMPLE_TIMEOUT_S = 300
EXAMPLES = {
    "torch_quickstart": (["--seconds", "5"],
                         lambda c: c["oracle_rel_err"] <= c["tol"]
                         and c["bit_identical_load"]),
    "torch_custom_operator": (["--seconds", "5"],
                              lambda c: c["oracle_rel_err"] <= c["tol"]
                              and c["bit_identical_load"]
                              and c["structures_with_op"] > 0),
    "torch_serve_requests": ([],
                             lambda c: c["requests_served"] == c["requests"]
                             and c["sparse_linear_rel_err"] <= c["tol"]
                             and c["matvec_rel_err"] <= c["tol"]
                             and c["matvecs_ok"] == c["matvecs"]
                             and c["hot_swaps"] == 1),
    "torch_spmv_search_report": (["--seconds", "1"],
                                 lambda c: c["oracle_rel_err"] <= c["tol"]),
    "torch_train_lm": (["--tiny", "--steps", "30"],
                       lambda c: c["steps"] == 30 and c["loss_decreased"]),
}


def child_env() -> dict:
    import os
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))


def start_child(args: list, log: Path) -> tuple:
    """A child process in its own session (so that a timeout stops it
    and every process it started), its output in ``log``; a thread
    notes the time it ends."""
    import threading
    f = open(log, "w")
    proc = subprocess.Popen([sys.executable] + args, stdout=f,
                            stderr=subprocess.STDOUT, env=child_env(),
                            cwd=ROOT, start_new_session=True)
    ended = {}

    def watch():
        proc.wait()
        ended["t"] = time.perf_counter()
    threading.Thread(target=watch, daemon=True).start()
    return proc, f, time.perf_counter(), ended


def wait_children(children: dict, timeout: float) -> dict:
    """{name: (return code, seconds, output)} once every child has ended;
    a child past ``timeout`` is killed with its session and returns
    None. Each child's seconds run to its own end."""
    import os
    import signal
    ends = {}
    while len(ends) < len(children):
        for name, child in children.items():
            proc, _, t0, ended = child
            if name in ends:
                continue
            if "t" in ended:
                ends[name] = (proc.returncode, ended["t"] - t0)
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)   # what it left
            elif time.perf_counter() - t0 > timeout:
                stop_child(child)
                ends[name] = (None, time.perf_counter() - t0)
        time.sleep(0.2)
    out = {}
    for name, (proc, f, _, _) in children.items():
        f.close()
        out[name] = ends[name] + (Path(f.name).read_text(),)
    return out


def stop_child(child: tuple) -> None:
    """Kill a child with every process of its session."""
    import os
    import signal
    proc, f, _, _ = child
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    f.close()


def become_subreaper() -> None:
    """Make this process the child subreaper of everything it starts: a
    process orphaned below it (a killed child's leftovers, a worker pool's
    resource tracker) is handed to it, not to the machine's init, so that
    :func:`stop_strays` finds and reaps it."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:          # PR_SET_CHILD_SUBREAPER
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def descendants() -> dict:
    """{pid: command line} of every process below this one, zombies
    included."""
    import os
    parent = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            with contextlib.suppress(OSError):
                stat = Path(f"/proc/{entry}/stat").read_text()
                parent[int(entry)] = int(stat[stat.rindex(")") + 2:]
                                         .split()[1])
    below, frontier = set(), {os.getpid()}
    while frontier:
        frontier = {p for p, pp in parent.items() if pp in frontier} - below
        below |= frontier
    out = {}
    for pid in below:
        with contextlib.suppress(OSError):
            out[pid] = (Path(f"/proc/{pid}/cmdline").read_bytes()
                        .replace(b"\0", b" ").decode(errors="replace")
                        .strip()[:160])
    return out


def stop_strays(timeout: float = 20.0) -> list:
    """Kill every process still below this one and reap it, once each
    child of this script has been waited for; the command lines of those
    found (a zombie's is empty). Raises if one outlives ``timeout``."""
    import os
    import signal
    found = {}
    deadline = time.perf_counter() + timeout
    while True:
        left = descendants()
        for pid, cmd in left.items():
            found.setdefault(pid, cmd)
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        with contextlib.suppress(ChildProcessError):
            while os.waitpid(-1, os.WNOHANG)[0]:
                pass
        if not left:
            return [found[p] for p in sorted(found)]
        if time.perf_counter() > deadline:
            raise RuntimeError(f"processes outlived SIGKILL: {left}")
        time.sleep(0.05)


def tagged(out: str, tag: str):
    """The JSON of the last ``<tag> {...}`` line of ``out`` (None if
    there is none)."""
    lines = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    return json.loads(lines[-1][len(tag) + 1:]) if lines else None


def dryrun_train(train: dict) -> None:
    """(a) ``lower_cell`` of phase 14 (b)'s step (granite-3-2b, 40
    layers, 4 x 512, bf16, remat) on a one-device mesh description,
    beside what phase 14 (b) measured on the card."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainConfig
    B, S = train["batch"]
    tc = TrainConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=2,
                                     total_steps=100),
                     compute_dtype="bfloat16", remat=True)
    low = lower_cell(llm_cfg(GRANITE), ShapeCell("smoke_train", S, B,
                                                 "train"),
                     Mesh(("data", "model"), (1, 1)), tc)
    comp = low.compile()
    mem, ca = comp.memory_analysis(), comp.cost_analysis()
    predicted = mem["argument_bytes"] + mem["temp_bytes"]
    peak = train["peak_memory_gb"] * 1e9
    step_peak = train["step_peak_gb"] * 1e9
    ratio = ca["flops_global"] / train["model_flops_per_step"]
    line = {"arch": GRANITE, "cell": [B, S, "train"], "lower_s": low.lower_s,
            "compile_s": comp.compile_s, "memory_s": comp.memory_s,
            "argument_bytes": mem["argument_bytes"],
            "temp_bytes": mem["temp_bytes"], "predicted_bytes": predicted,
            "measured_peak_bytes": peak,
            "predicted_over_peak": predicted / peak,
            "measured_step_peak_bytes": step_peak,
            "predicted_over_step_peak": predicted / step_peak,
            "flops_global": ca["flops_global"],
            "model_flops": train["model_flops_per_step"],
            "flops_over_model_flops": ratio,
            "bytes_accessed": ca["bytes accessed"],
            "transcendentals": ca["transcendentals"],
            "collectives_total_bytes": comp.collectives()["total_bytes"],
            "collectives_basis": comp.collectives_basis}
    print("dryrun_train " + json.dumps(line))
    require(abs(predicted / peak - 1) <= DRYRUN_MEM_TOL,
            f"dry run of the train step: {predicted:.4g} bytes predicted, "
            f"{peak:.4g} measured")
    require(DRYRUN_FLOPS_RATIO[0] <= ratio <= DRYRUN_FLOPS_RATIO[1],
            f"dry-run FLOPs {ratio:.3f}x model FLOPs")


def dryrun_decode(serve: dict) -> None:
    """(b) ``lower_cell`` of qwen3-8b's decode at phase 13 (b)'s slots and
    cache length, with the reference's float32 weights and with the bf16
    weights the engine holds, beside what phase 13 (b) measured: its
    whole peak (the float32 init included) and its peak while serving."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import Mesh
    B, S = serve["max_batch"], serve["max_seq"]
    line = {"arch": QWEN, "cell": [B, S, "decode"],
            "measured_peak_bytes": serve["max_memory_allocated"],
            "measured_serve_peak_bytes": serve["serve_peak_bytes"]}
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        comp = lower_cell(llm_cfg(QWEN), ShapeCell("smoke_decode", S, B,
                                                   "decode"),
                          Mesh(("data", "model"), (1, 1)),
                          param_dtype=dtype).compile()
        mem = comp.memory_analysis()
        pred = mem["argument_bytes"] + mem["temp_bytes"]
        line[name] = {"argument_bytes": mem["argument_bytes"],
                      "temp_bytes": mem["temp_bytes"],
                      "alias_bytes": mem["alias_bytes"],
                      "predicted_bytes": pred,
                      "predicted_over_peak":
                          pred / serve["max_memory_allocated"],
                      "predicted_over_serve_peak":
                          pred / serve["serve_peak_bytes"],
                      "flops_global": comp.flops_global,
                      "compile_s": comp.compile_s}
    print("dryrun_decode " + json.dumps(line))
    r = line["bfloat16"]["predicted_over_serve_peak"]
    require(abs(r - 1) <= DRYRUN_MEM_TOL,
            f"dry run of the bf16 decode step: {r:.3f}x the serving peak")


def start_dryrun_sweep() -> tuple:
    """(c) the single-pod dry-run sweep in a child: ``(child, its
    output directory)``. It needs no card and times nothing of the port,
    so the full run starts it beside phases 4 and 4b, which compile and
    check bits but time nothing, and reads it before phase 5."""
    scratch = ROOT / "results"               # listed in .gitignore
    scratch.mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=scratch)
    out = Path(work.name)
    child = start_child(["-m", "repro_torch.launch.dryrun", "--arch",
                         "all", "--shape", DRYRUN_SHAPES, "--mesh",
                         "single", "--jobs", str(DRYRUN_JOBS), "--out",
                         str(out / "dryrun")], out / "dryrun.log")
    return child, work


def dryrun_sweep_phase(sweep: tuple) -> None:
    """Phase 15 (c), read before phase 5: the wait for the sweep beside
    phases 4 and 4b, then its line."""
    done = phase("15c dry-run sweep (started before phase 4)")
    child, work = sweep
    t0 = time.perf_counter()
    try:
        dryrun_sweep_result(child, Path(work.name) / "dryrun")
    finally:
        work.cleanup()
    print(f"  waited {time.perf_counter() - t0:.1f} s for the sweep after "
          "phase 4b")
    done()


def dryrun_sweep_result(child: tuple, out_dir: Path) -> None:
    """(c) the single-pod sweep's child: 0 failed, one record a cell."""
    from repro_torch.configs import REGISTRY, cells_for
    rc, secs, out = wait_children({"sweep": child},
                                  DRYRUN_TIMEOUT_S)["sweep"]
    want = sum(1 for cfg in REGISTRY.values() for c in cells_for(cfg)
               if DRYRUN_SHAPES == "all"
               or c.name in DRYRUN_SHAPES.split(","))
    summary = re.search(r"dry-run complete: (\d+) ok, (\d+) failed", out)
    recs = [json.loads(p.read_text()) for p in sorted(out_dir.glob("*.json"))]
    line = {"mesh": "pod16x16", "shapes": DRYRUN_SHAPES,
            "jobs": DRYRUN_JOBS, "returncode": rc, "seconds": secs,
            "cells": want, "records": len(recs),
            "ok": int(summary.group(1)) if summary else None,
            "failed": int(summary.group(2)) if summary else None,
            "cell_wall_s_sum": sum(r["wall_s"] for r in recs),
            "largest_argument_bytes": max(
                (r["memory"]["argument_bytes"], r["arch"], r["shape"])
                for r in recs if r["ok"]) if recs else None}
    print("dryrun_sweep " + json.dumps(line))
    if rc != 0:
        print(out[-3000:])
    require(rc == 0 and line["failed"] == 0 and line["ok"] == want
            and len(recs) == want, f"dry-run sweep: {line}")


def start_examples(work: Path) -> dict:
    """(d) the five examples on the card, in children at once."""
    return {name: start_child([str(ROOT / "examples" / f"{name}.py"), *args]
                              + (["--ckpt", str(work / "ckpt")]
                                 if name == "torch_train_lm" else []),
                              work / f"{name}.log")
            for name, (args, _) in EXAMPLES.items()}


def examples_result(children: dict) -> None:
    """(d) each example must end with rc 0, pass its own check line, and
    have launched every kernel its plans dispatch to (its ``launches``
    and ``dispatch`` lines)."""
    line, bad = {}, []
    for name, (rc, secs, out) in wait_children(children,
                                               EXAMPLE_TIMEOUT_S).items():
        check, launches = tagged(out, "check"), tagged(out, "launches")
        dispatch = tagged(out, "dispatch") or []
        ok = (rc == 0 and check is not None and EXAMPLES[name][1](check)
              and all((launches or {}).get(k, 0) > 0 for k in dispatch))
        line[name] = {"returncode": rc, "seconds": secs, "check": check,
                      "dispatch": dispatch,
                      "launches": {k: v for k, v in (launches or {}).items()
                                   if v}}
        if not ok:
            bad.append(name)
            print(f"--- {name} (rc {rc}) ---\n{out[-3000:]}")
    print("examples " + json.dumps(line))
    require(not bad, f"examples that failed or launched nothing of their "
            f"plans: {bad}")


def dryrun_phase(serve: dict, train: dict) -> None:
    """Phase 15: the dry run (``repro_torch.launch.dryrun``, no card)
    against phases 13 and 14, and the five examples on the card at once
    beside it; its single-pod sweep ran beside phases 4 and 4b."""
    done = phase("15 dry run and examples")
    scratch = ROOT / "results"               # listed in .gitignore
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        examples = start_examples(Path(d))
        try:
            dryrun_train(train)
            dryrun_decode(serve)
            examples_result(examples)
        except BaseException:
            for child in examples.values():
                stop_child(child)
            raise
    done()


# -------------------------------- phase 16 --------------------------------

SHARDED_TIMEOUT_S = 420
# (a)'s global batch: 8 rows split over 1, 2, 4 or 8 data positions
SHARDED_CHECK_BATCH = (8, 128)
SHARDED_CHECK_STEPS = 3
SHARDED_FULL_SEQ = 512
# (a) checks granite's dense blocks and the model splits of MoE experts
# (40 a layer, top 8, a tied vocabulary) and Mamba heads (64, an untied
# head); (b) runs granite on every mesh, the other two at full depth on
# the four-card meshes of ``--sharded-only``
GMOE = "granite-moe-3b-a800m"
SHARDED_CHECK_ARCHS = (GRANITE, GMOE, MAMBA)
SHARDED_SPLIT_ARCHS = (GMOE, MAMBA)
# (b)'s ARCHS entry for an architecture with seq_shard on
SEQ_MARK = "+seq"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def sharded_meshes(n: int) -> list:
    """``((data, model), archs)``: the meshes of every visible card and
    the architectures (b) runs on each: (1, 1) on one card, granite;
    (n, 1) and, for n >= 4, (n / 2, 2) on n, granite, and on (n / 2, 2)
    and (1, n) the two model splits too; on (n / 2, 2) granite with
    ``seq_shard`` too (``SEQ_MARK``)."""
    if n == 1:
        return [((1, 1), (GRANITE,))]
    if n < 4:
        return [((n, 1), (GRANITE,))]
    return [((n, 1), (GRANITE,)),
            ((n // 2, 2), (GRANITE, GRANITE + SEQ_MARK)
             + SHARDED_SPLIT_ARCHS),
            ((1, n), SHARDED_SPLIT_ARCHS)]


def state_slices(mesh, specs, full: dict) -> dict:
    """This rank's slices of a parameter tree (the leaves themselves
    where a slice is the whole leaf)."""
    from repro_torch.dist.sharding import map_specs, shard_leaf
    coords = mesh.coords
    return map_specs(lambda sp, p: shard_leaf(p, sp, mesh, coords), specs,
                     full)


def on(dev, batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def seq_config(tc, mesh, seq: bool):
    """``tc`` with the residual stream's sequence split over ``model``
    (``seq_shard`` with ``act_dp`` the mesh's data axes) when ``seq``."""
    import dataclasses
    from repro_torch.dist.sharding import dp_axes
    return dataclasses.replace(tc, seq_shard=True, act_dp=dp_axes(mesh)) \
        if seq else tc


def sharded_check(mesh, arch: str = GRANITE, seq: bool = False) -> dict:
    """(a) ``arch`` at full width, depth 2, fp32, batch 8 x 128: the
    sharded step's first gradients and three steps (loss, grad_norm, the
    parameters after AdamW, gathered whole) against the one-device step
    on the same weights and global batches, within phase 14 (a)'s
    limits; parameters within 2 lr a step. ``seq``: the sharded step
    with ``seq_shard`` (``seq_config``)."""
    import torch.distributed as dist
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist.collectives import Layout, gather_leaf
    from repro_torch.dist.sharding import (param_specs, shard_batch,
                                           spec_leaves)
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import AdamWConfig, _map, tree_leaves
    from repro_torch.train.step import (TrainConfig, init_state,
                                        make_grad_fn, make_train_step)
    cfg = llm_cfg(arch, n_layers=2)
    dev, coords = mesh.device, mesh.coords
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tc = TrainConfig(opt=opt, compute_dtype="float32", remat=True)
    B, S = SHARDED_CHECK_BATCH
    pipe = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S,
                                             global_batch=B, seed=0))
    batches = [pipe.batch_at(s) for s in range(SHARDED_CHECK_STEPS)]
    full = init_params(cfg, 0, dev)
    specs = param_specs(cfg, mesh, full)
    # copies: the two steps update their states in place
    local = _map(torch.clone, state_slices(mesh, specs, full))
    t0 = time.perf_counter()
    (l1, _), g1 = make_grad_fn(cfg, tc)(full, on(dev, batches[0]))
    layout = Layout(cfg, mesh, specs)
    tc_shd = seq_config(tc, mesh, seq)
    (ln, _), gn = make_grad_fn(cfg, tc_shd, layout)(
        local, on(dev, shard_batch(batches[0], cfg, mesh, coords)))
    scale = max(float(g.abs().max()) for g in tree_leaves(g1))
    grads_err = max(float((gather_leaf(a, sp, mesh) - b).abs().max())
                    for a, b, sp in zip(tree_leaves(gn), tree_leaves(g1),
                                        spec_leaves(specs))) / scale
    del g1, gn
    one = init_state(cfg, tc, full)
    shd = init_state(cfg, tc, local)
    step_one = make_train_step(cfg, tc)
    step_shd = make_train_step(cfg, tc_shd, grad_specs=specs, mesh=mesh)
    steps = []
    for b in batches:
        one, m1 = step_one(one, b)
        shd, mn = step_shd(shd, shard_batch(b, cfg, mesh, coords))
        steps.append({k: (float(mn[k]), float(m1[k]))
                      for k in ("loss", "grad_norm")})
    torch.cuda.synchronize()
    perr = torch.cat([(gather_leaf(a, sp, mesh) - b).abs().reshape(-1)
                      for a, b, sp in zip(tree_leaves(shd["params"]),
                                          tree_leaves(one["params"]),
                                          spec_leaves(specs))])
    lr = float(opt.lr)
    out = {"arch": arch, "n_layers": cfg.n_layers, "batch": [B, S],
           # the layout's tensor-parallel flags (None where an older
           # package, timed with this script, has no such flag)
           "splits": {k: getattr(layout, f"{k}_tp", None)
                      for k in ("attn", "mlp", "moe", "ssm", "vocab")},
           "mesh": list(mesh.sizes), "backend": dist.get_backend(),
           "seq_shard": seq,
           "steps": len(batches), "seconds": time.perf_counter() - t0,
           "losses": [st["loss"][0] for st in steps],
           "grad_norms": [st["grad_norm"] for st in steps],
           "loss_rel_err": max(abs(a - b) / abs(b) for a, b in
                               (st["loss"] for st in steps)),
           "grad_norm_rel_err": max(abs(a - b) / abs(b) for a, b in
                                    (st["grad_norm"] for st in steps)),
           "first_loss_equal": float(l1) == float(ln),
           "grads_rel_err": grads_err,
           "params_max_abs_err": float(perr.max()),
           "params_share_within": float((perr <= PARAMS_CLOSE).double()
                                        .mean()),
           "tol": dict(loss=TRAIN_TOL["loss"],
                       grad_norm=TRAIN_TOL["grad_norm"],
                       grads=TRAIN_TOL["grads"],
                       params_max=2 * lr * len(batches),
                       params_close=PARAMS_CLOSE,
                       params_share=PARAMS_SHARE)}
    bad = [f"{key} {out[key]:.3e} > {out['tol'][k]:.3e}"
           for k, key in (("loss", "loss_rel_err"),
                          ("grad_norm", "grad_norm_rel_err"),
                          ("grads", "grads_rel_err"),
                          ("params_max", "params_max_abs_err"))
           if not out[key] <= out["tol"][k]]
    if out["params_share_within"] < PARAMS_SHARE:
        bad.append(f"{out['params_share_within']:.5f} of the parameters "
                   f"within {PARAMS_CLOSE}")
    if bad:
        print("sharded_check " + json.dumps(out), flush=True)
    require(not bad, f"sharded_check {arch} on {list(mesh.sizes)} "
            f"(seq_shard {seq}): " + "; ".join(bad))
    del one, shd, full, local, perr
    torch.cuda.empty_cache()
    return out


def span_ms(spans: list) -> float:
    """The length of the union of ``(start, end)`` spans (µs), in ms."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / 1e3


def profiled_step(step, state, batch, step_ms: float):
    """One more step under ``torch.profiler``: ``(state, {...})``
    (``profiled_call``'s)."""
    out, prof = profiled_call(lambda: step(state, batch), step_ms)
    return out[0], prof


def profiled_call(fn, step_ms: float):
    """``fn()`` once under ``torch.profiler``: ``(its result, {...})``, the
    card's busy time outside NCCL's kernels (the union of the other
    kernels' and copies' spans; an NCCL kernel also spins while it waits
    for the other ranks) and the idle share of ``step_ms`` (an
    unprofiled call's time) that leaves, the NCCL kernels' time, the
    host time and the collectives issued (None where the profiler saw
    no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    nccl = [(e.time_range.start, e.time_range.end) for e in dev
            if "nccl" in e.name.lower()]
    other = [(e.time_range.start, e.time_range.end) for e in dev
             if "nccl" not in e.name.lower()]
    busy_ms = span_ms(other) if dev else None
    ka = prof.key_averages()
    return out, {
        "device_busy_ms": busy_ms, "nccl_kernel_ms": span_ms(nccl),
        "idle_share": None if busy_ms is None else 1 - busy_ms / step_ms,
        "host_ms": sum(e.self_cpu_time_total for e in ka) / 1e3,
        "collectives": sum(e.count for e in ka
                           if e.key == "record_param_comms")}


def full_step_line(step, state, batches) -> tuple:
    """A warm-up, three timed steps split at the optimizer
    (``split_timed_steps``) and one profiled: ``(state, {...})``."""
    state, met = step(state, batches[0])
    state, losses, split = split_timed_steps(step, state, batches[1:4])
    step_ms = statistics.median(t for t, _, _ in split)
    state, prof = profiled_step(step, state, batches[4], step_ms)
    return state, {"step_ms": step_ms, "step_ms_all": [t for t, _, _ in split],
                   "fwd_bwd_ms": statistics.median(f for _, f, _ in split),
                   "optimizer_ms": statistics.median(o for _, _, o in split),
                   "losses": [float(met["loss"])] + losses, **prof}


def sharded_full(mesh, arch: str = GRANITE) -> dict:
    """(b) ``arch`` at full width and depth, bf16 compute, remat, 4 x 512
    tokens a data position (the global batch 4 x 512 on one card): for
    granite, in this process the unsharded step on 4 rows (phase 14
    (b)'s batch) first; then the sharded step on this rank's rows of the
    global batch, each with a warm-up, 3 timed steps (CUDA events) and
    one under the profiler; each rank's peak memory and state bytes (the
    largest over the ranks). ``arch`` ending in ``SEQ_MARK``: the
    sharded step alone, with ``seq_shard`` (``seq_config``)."""
    seq = arch.endswith(SEQ_MARK)
    arch = arch.removesuffix(SEQ_MARK)
    import torch.distributed as dist
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist.sharding import dp_axes, param_specs, shard_batch
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves
    from repro_torch.train.step import TrainConfig, init_state, \
        make_train_step
    cfg = llm_cfg(arch)
    dev, coords = mesh.device, mesh.coords
    n_dp = int(np.prod([mesh.shape[a] for a in dp_axes(mesh)]))
    B, S = 4 * n_dp, SHARDED_FULL_SEQ
    tc = TrainConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=2,
                                     total_steps=100),
                     compute_dtype="bfloat16", remat=True)
    pipe = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S,
                                             global_batch=B, seed=0))
    glob = [pipe.batch_at(s) for s in range(5)]
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "params": cfg.n_params(), "batch": [B, S],
           "mesh": list(mesh.sizes), "compute_dtype": "bfloat16",
           "remat": True, "seq_shard": seq}
    one = None
    if arch == GRANITE and not seq:
        torch.cuda.reset_peak_memory_stats()
        state = init_state(cfg, tc, init_params(cfg, 0, dev))
        state, one = full_step_line(
            make_train_step(cfg, tc), state,
            [on(dev, {k: v[:4] for k, v in b.items()}) for b in glob])
        one["tokens_per_s"] = 4 * S / (one["step_ms"] / 1e3)
        one["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del state
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = init_params(cfg, 0, dev)
    specs = param_specs(cfg, mesh, full)
    params = state_slices(mesh, specs, full)
    del full                                 # (1, 1): the slices are it
    state = init_state(cfg, tc, params)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    state, shd = full_step_line(
        make_train_step(cfg, seq_config(tc, mesh, seq), grad_specs=specs,
                        mesh=mesh), state,
        [on(dev, shard_batch(b, cfg, mesh, coords)) for b in glob])
    peak = torch.tensor([torch.cuda.max_memory_allocated(), state_bytes],
                        dtype=torch.float64, device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    out.update(shd, tokens_per_s=B * S / (shd["step_ms"] / 1e3),
               model_tflops_per_s=model_flops(cfg, B, S)
               / (shd["step_ms"] / 1e3) / 1e12,
               peak_memory_gb=float(peak[0]) / 1e9,
               state_bytes_per_rank=int(peak[1]),
               unsharded_same_process=one)
    require(all(np.isfinite(shd["losses"] + (one or shd)["losses"])),
            "sharded_step: a non-finite loss")
    del state, params
    torch.cuda.empty_cache()
    return out


# (a') the sharded serving step's checks: (arch, sliding window) at full
# width, depth 2, fp32 (granite with a window below the prompt: the ring
# buffer); global rows, prompt tokens, cache slots; the rows live at each
# decode step (None: all; the first step at one scalar position)
SERVE_CHECK_ARCHS = ((QWEN, None), (GMOE, None), (DEEPSEEK, None),
                     (MAMBA, None), (GRANITE, 16))
SERVE_CHECK_SHAPE = (8, 24, 32)
SERVE_LIVE = (None, (0, 2, 3, 5, 6), (1, 3, 4, 7), None)
# (b') qwen3-8b at full depth, bf16: rows a data position, prompt tokens,
# greedy decode steps; the prefill logits' limit, x max |logit| (bf16)
SERVE_FULL = (8, 32, 32)
SERVE_TOL = 2e-2


def rule_2e3(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """``within_2e3``'s rule, quietly: ``(max abs err, worst excess)``."""
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    require(g.shape == w.shape and np.isfinite(g).all(),
            "bad shape or non-finite values")
    err = np.abs(g - w)
    return float(err.max()), float((err - (LLM_TOL + LLM_TOL
                                           * np.abs(w))).max())


def my_rows(cfg, mesh, n: int) -> torch.Tensor:
    """The indices of this rank's rows of a global batch of ``n``."""
    from repro_torch.dist.sharding import shard_serve
    return torch.from_numpy(shard_serve(
        {"token": np.arange(n)[:, None]}, cfg, mesh, mesh.coords)[
            "token"][:, 0])


def sharded_serve_check(mesh, arch: str, window) -> dict:
    """(a') ``arch`` at full width, depth 2, fp32 (``window``: its sliding
    window): the sharded ``prefill`` of ``SERVE_CHECK_SHAPE``'s prompt and
    ``len(SERVE_LIVE)`` decode steps (a scalar position, then each row's
    own depth with ``SERVE_LIVE``'s rows live) against the one-device
    calls on the same weights: every rank's logits (its rows, the whole
    vocabulary) and every cache leaf gathered whole (``cache_specs``)
    within phase 13 (a)'s 2e-3 rule."""
    import torch.distributed as dist
    from repro_torch.dist.collectives import Layout, gather_leaf
    from repro_torch.dist.sharding import (cache_specs, param_specs,
                                           shard_serve)
    from repro_torch.models import (cache_spec, decode_step, fill_caches,
                                    init_params, prefill)
    cfg = llm_cfg(arch, n_layers=2)
    if window:
        cfg = dataclasses.replace(cfg, window=window)
    dev, f32 = mesh.device, torch.float32
    B, S, S_c = SERVE_CHECK_SHAPE
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)
    depth, steps = np.full(B, S), []
    for t, live in enumerate(SERVE_LIVE):
        steps.append({"token": rng.integers(0, cfg.vocab, (B, 1)),
                      "pos": np.int64(S) if t == 0 else depth.copy(),
                      "rows": None if live is None else np.array(live)})
        depth = depth + (np.isin(np.arange(B), live) if live else 1)
    t0 = time.perf_counter()
    full = init_params(cfg, 0, dev)
    specs = param_specs(cfg, mesh, full)
    layout = Layout(cfg, mesh, specs)
    local = state_slices(mesh, specs, full)
    mine = my_rows(cfg, mesh, B).to(dev)
    cuda = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        a).to(dev)
    errs = {"logits": [], "caches": []}

    def check(kind, got, want):
        err, excess = rule_2e3(got, want)
        errs[kind].append(err)
        require(excess <= 0, f"sharded_serve_check {arch} on "
                f"{list(mesh.sizes)}: {kind} outside the 2e-3 rule "
                f"(excess {excess:.3e})")

    def check_caches(got, want):
        for sp, g, w in zip(cache_specs(cfg, mesh, want), got, want):
            for k in w:
                check("caches", gather_leaf(g[k], sp[k], mesh), w[k])

    with torch.no_grad():
        lg1, pre1 = prefill(cfg, full, cuda(prompt), None, f32)
        ins = shard_serve({"tokens": prompt}, cfg, mesh, mesh.coords)
        lgn, pren = prefill(cfg, local, cuda(ins["tokens"]), None, f32,
                            layout=layout)
        check("logits", lgn, lg1[mine])
        check_caches(pren, pre1)
        c1 = cache_spec(cfg, B, S_c, f32, dev)
        cn = cache_spec(cfg, B, S_c, f32, dev, layout=layout)
        fill_caches(c1, pre1)
        fill_caches(cn, pren)
        for st in steps:
            l1, _ = decode_step(cfg, full, cuda(st["token"]),
                                cuda(st["pos"]), c1, f32,
                                rows=cuda(st["rows"]))
            own = {k: cuda(v) for k, v in shard_serve(
                st, cfg, mesh, mesh.coords).items()}
            ln, _ = decode_step(cfg, local, own["token"], own["pos"], cn,
                                f32, rows=own["rows"], layout=layout)
            check("logits", ln, l1[mine])
        check_caches(cn, c1)
    torch.cuda.synchronize()
    out = {"arch": arch, "n_layers": cfg.n_layers, "window": window,
           "mesh": list(mesh.sizes), "backend": dist.get_backend(),
           "shape": [B, S, S_c], "decode_steps": len(steps),
           "splits": {k: getattr(layout, f"{k}_tp")
                      for k in ("attn", "mlp", "moe", "ssm", "vocab")},
           "conv_part": layout.conv_part,
           "logits_max_abs_err": max(errs["logits"]),
           "caches_max_abs_err": max(errs["caches"]),
           "caches_compared": len(errs["caches"]),
           "rule": "|got - one device| <= 2e-3 + 2e-3 |one device|",
           "seconds": time.perf_counter() - t0}
    del full, local, c1, cn, pre1, pren
    torch.cuda.empty_cache()
    return out


def timed_decode(fn, tok, n: int) -> tuple:
    """``n`` greedy steps ``tok = argmax(fn(tok))``, each timed on the
    host clock between synchronisations: ``(ms of each, the tokens of
    each step (rows, n))``."""
    times, toks = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = fn(tok).argmax(-1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
    return times, torch.cat(toks, 1)


@contextlib.contextmanager
def planted_fault(tp):
    """A wrong sharded call: while open, ``tp.exit`` on model position 1
    returns the position's own partial sum. It still issues the
    all-reduce, so every rank issues what the right call does (a rank
    that skipped it would leave the others waiting)."""
    real = tp.exit
    tp.exit = lambda x: (lambda y: x if tp.rank == 1 else y)(real(x))
    try:
        yield
    finally:
        del tp.exit


def sharded_serve(mesh) -> dict:
    """(b') qwen3-8b at full width and depth, bf16: ``SERVE_FULL``'s rows
    a data position prefill a prompt and decode greedily, the sharded
    serving step beside the one-device calls on the global batch in this
    process, on the same weights. Per step as the caller sees it (host
    clock between synchronisations), the card's busy time outside NCCL
    and the idle share (one profiled step), the collectives issued, each
    rank's peak memory (the largest over the ranks), tokens/s of the
    global batch, and the byte bound (the rank's weight and cache bytes
    over the HBM rate). On a mesh of one card every split is of size
    one: the prefill logits and every greedy token must equal the
    one-device run's. Elsewhere the prefill logits are reported beside
    the one-device bf16 prefill's (``prefill_within_tol``: within
    ``SERVE_TOL`` x max |logit| of them) and must lie within ``SERVE_TOL``
    x max |logit| of the float32 one-device prefill's, or within twice
    the one device's own distance from them; where ``model`` splits, a
    prefill with a planted fault (``planted_fault``) must miss that
    limit. The share of greedy tokens equal to the one-device run's."""
    import torch.distributed as dist
    from repro_torch.dist.collectives import Layout, count_collectives
    from repro_torch.dist.sharding import dp_axes, param_specs, shard_serve
    from repro_torch.models import (cache_spec, cast_params, decode_step,
                                    fill_caches, init_params, prefill)
    from repro_torch.models.model import block_views
    cfg = llm_cfg(QWEN)
    dev, bf16 = mesh.device, torch.bfloat16
    n_dp = int(np.prod([mesh.shape[a] for a in dp_axes(mesh)]))
    rows, S, T = SERVE_FULL
    B, S_c = rows * n_dp, S + T + 2
    prompt = np.random.default_rng(21).integers(0, cfg.vocab, (B, S))
    full = init_params(cfg, 0, dev)
    with torch.no_grad():        # the float32 logits both bf16 runs near
        lg32 = prefill(cfg, full, torch.from_numpy(prompt).to(dev), None,
                       torch.float32)[0]
    full = cast_params(full, bf16)
    torch.cuda.empty_cache()
    specs = param_specs(cfg, mesh, full)
    layout = Layout(cfg, mesh, specs)
    local = state_slices(mesh, specs, full)
    mine = my_rows(cfg, mesh, B).to(dev)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": "bfloat16",
           "mesh": list(mesh.sizes), "global_rows": B, "prompt": S,
           "decode_steps": T, "splits": {
               k: getattr(layout, f"{k}_tp")
               for k in ("attn", "mlp", "moe", "ssm", "vocab")}}
    with torch.no_grad():
        # the one-device calls on the global batch
        torch.cuda.reset_peak_memory_stats()
        lg1, pre1 = prefill(cfg, full, torch.from_numpy(prompt).to(dev),
                            None, bf16)
        c1 = cache_spec(cfg, B, S_c, bf16, dev)
        fill_caches(c1, pre1)
        del pre1
        views, depth = block_views(full), [S]

        def one(tok):
            lg, _ = decode_step(cfg, full, tok, torch.tensor(depth[0]), c1,
                                bf16, views=views)
            depth[0] += 1
            return lg
        times1, toks1 = timed_decode(one, lg1.argmax(-1), T)
        one_ms = statistics.median(times1)
        _, prof1 = profiled_call(lambda: one(toks1[:, -1:]), one_ms)
        out["one_device"] = {"step_ms": one_ms, "tok_per_s": B / one_ms
                             * 1e3, "peak_memory_gb":
                             torch.cuda.max_memory_allocated() / 1e9,
                             **prof1}
        # on (1, 1) the slices are the weights themselves
        del c1, full, views
        torch.cuda.empty_cache()
        # the sharded serving step on this rank's rows
        torch.cuda.reset_peak_memory_stats()
        ins = shard_serve({"tokens": prompt}, cfg, mesh, mesh.coords)
        t0 = time.perf_counter()
        lgn, pren = prefill(cfg, local, torch.from_numpy(
            ins["tokens"]).to(dev), None, bf16, layout=layout)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        want, exact = lg1[mine], lg32[mine]
        scale, scale32 = float(want.abs().max()), float(exact.abs().max())
        pre_err = float((lgn - want).abs().max())
        pre_equal = bool(torch.equal(lgn, want))
        one32 = float((want - exact).abs().max())
        shd32 = float((lgn - exact).abs().max())
        fault32 = None
        if layout.tp.size > 1:
            with planted_fault(layout.tp):
                bad = prefill(cfg, local, torch.from_numpy(
                    ins["tokens"]).to(dev), None, bf16, layout=layout)[0]
            fault32 = float((bad - exact).abs().max())
            del bad
        cn = cache_spec(cfg, B, S_c, bf16, dev, layout=layout)
        fill_caches(cn, pren)
        del pren
        views_n, depth = block_views(local), [S]

        def shd(tok):
            lg, _ = decode_step(cfg, local, tok, torch.tensor(depth[0]), cn,
                                bf16, views=views_n, layout=layout)
            depth[0] += 1
            return lg
        times, toks = timed_decode(shd, lgn.argmax(-1), T)
        step_ms = statistics.median(times)
        with count_collectives() as issued:
            shd(toks[:, -1:])
        _, prof = profiled_call(lambda: shd(toks[:, -1:]), step_ms)
    wb, cb = tree_bytes(local), tree_bytes(cn)
    peak = torch.tensor([torch.cuda.max_memory_allocated()],
                        dtype=torch.float64, device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    same = float((toks == toks1[mine]).double().mean())
    limit = max(SERVE_TOL * scale32, 2 * one32)
    out.update(
        prefill_ms=prefill_ms, prefill_max_abs_err=pre_err,
        prefill_bit_equal=pre_equal, prefill_tol=SERVE_TOL * scale,
        prefill_within_tol=pre_err <= SERVE_TOL * scale,
        one_device_vs_fp32=one32, sharded_vs_fp32=shd32,
        fp32_tol=SERVE_TOL * scale32, fp32_limit=limit,
        planted_fault_vs_fp32=fault32,
        step_ms=step_ms, step_ms_all=times,
        tok_per_s=B / step_ms * 1e3, **prof,
        collectives_per_step=len(issued),
        collectives_over_several=sum(n > 1 for _, n, _ in issued),
        collective_bytes_per_step=sum(b for _, n, b in issued if n > 1),
        peak_memory_gb=float(peak[0]) / 1e9, weight_bytes_per_rank=wb,
        cache_bytes_per_rank=cb,
        bound_ms=(wb + cb) / HBM_BYTES_PER_S * 1e3,
        greedy_tokens_equal_share=same)
    if all(n == 1 for n in mesh.sizes):
        ok = pre_equal and same == 1.0
        why = (f"prefill bit-equal {pre_equal}, {same:.3f} of the greedy "
               "tokens equal to the one device's on a mesh of one card")
    else:
        # bf16 sums in another order move a 36-layer model's logits by
        # about bf16's own error: the sharded prefill is held to the
        # float32 logits, within SERVE_TOL of their max or twice the one
        # device's bf16 error, and a planted fault must miss that limit
        ok = bool(np.isfinite(shd32)) and shd32 <= limit and (
            fault32 is None or fault32 > limit)
        why = (f"prefill logits {shd32:.3e} from the float32 ones, the "
               f"planted fault's {fault32}, limit {limit:.3e} (the one "
               f"device's bf16: {one32:.3e}; {SERVE_TOL} x max "
               f"{scale32:.3e})")
    if not ok:
        print("sharded_serve " + json.dumps({
            k: v for k, v in out.items() if k != "step_ms_all"}))
    require(ok, f"sharded_serve on {list(mesh.sizes)}: {why}")
    del local, cn
    torch.cuda.empty_cache()
    return out


def wait_for_file(path: Path, timeout: float) -> None:
    deadline = time.perf_counter() + timeout
    while not path.exists():
        require(time.perf_counter() < deadline, f"{path.name} never came")
        time.sleep(0.1)


def sharded_worker(argv: list) -> int:
    """One rank of phase 16 (started by torchrun): ``OUT DATA MODEL
    GATE ARCHS``; (a) for every architecture of ``SHARDED_CHECK_ARCHS``,
    without ``seq_shard`` and with it,
    then, once the file ``GATE`` exists (the parent makes it when (c),
    which shares the card, has ended), (b) for each of ``ARCHS`` (comma
    separated), then the serving step's (a') for each of
    ``SERVE_CHECK_ARCHS`` and (b'); rank 0 writes the results to ``OUT``
    as JSON."""
    import os
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    out, data, model = Path(argv[0]), int(argv[1]), int(argv[2])
    archs = argv[4].split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl")
    try:
        mesh = make_local_mesh(data, model)
        res = {"check": [sharded_check(mesh, a, seq)
                         for seq in (False, True)
                         for a in SHARDED_CHECK_ARCHS]}
        wait_for_file(Path(argv[3]), SHARDED_TIMEOUT_S)
        res["step"] = [sharded_full(mesh, a) for a in archs]
        t0 = time.perf_counter()
        res["serve_check"] = [sharded_serve_check(mesh, a, w)
                              for a, w in SERVE_CHECK_ARCHS]
        res["serve"] = sharded_serve(mesh)
        res["serve_seconds"] = time.perf_counter() - t0
        if mesh.rank == 0:
            out.write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


def torchrun(n: int, args: list) -> list:
    return ["-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n)] + args


def start_sharded_cli(work: Path, n: int) -> tuple:
    """(c) ``python -m repro_torch.launch.train`` under torchrun on an
    (n, 1) mesh over NCCL: granite-3-2b reduced, 20 steps, checkpoints
    every 3, a failure injected at step 7."""
    return start_child(torchrun(n, [
        "-m", "repro_torch.launch.train", "--arch", GRANITE, "--reduced",
        "--steps", "20", "--ckpt_every", "3", "--fail_at_step", "7",
        "--data_mesh", str(n), "--ckpt_dir", str(work / "cli_ckpt")]),
        work / "sharded_cli.log")


def sharded_cli_result(child: tuple, n: int) -> dict:
    """(c)'s line: the restart contract of the reference's driver tests
    and a finite loss."""
    import ast
    rc, secs, text = wait_children({"cli": child}, SHARDED_TIMEOUT_S)["cli"]
    if rc != 0:
        print(text[-6000:])
    require(rc == 0, f"sharded train cli: rc {rc}")
    lines = [ln for ln in text.splitlines() if ln.startswith("{'")]
    require(len(lines) == 1, "sharded train cli: rank 0 did not print "
            "its result once")
    res = ast.literal_eval(lines[0])
    require(res["restarts"] == 1 and res["n_steps_run"] >= 20
            and np.isfinite(res["final_loss"]), f"sharded train cli: {res}")
    return {"returncode": rc, "seconds": secs, "mesh": [n, 1], **res}


def sharded_phase(train, only=None) -> None:
    """Phase 16: the sharded train step and the sharded serving step on a
    mesh of every visible card, one process a card (torchrun, NCCL),
    beside phase 14 (b)'s unsharded step (``train``; None with
    ``--sharded-only``); ``only``: the ``(data, model)`` meshes to run, of
    ``sharded_meshes``'s."""
    train = train or {"step_ms": None, "peak_memory_gb": None,
                      "step_peak_gb": None}
    done = phase("16 sharded training")
    card = card_line()
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    scratch = ROOT / "results"               # listed in .gitignore
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        work = Path(d)
        cli = start_sharded_cli(work, n)
        meshes = [(m, a) for m, a in sharded_meshes(n)
                  if only is None or m in only]
        require(meshes, f"no mesh of {only} on {n} cards")
        for i, ((data, model), archs) in enumerate(meshes):
            out = work / f"sharded_{data}x{model}.json"
            gate = work / f"gate_{data}x{model}"
            child = start_child(torchrun(data * model, [
                str(ROOT / "chip_smoke.py"), "--sharded-worker", str(out),
                str(data), str(model), str(gate), ",".join(archs)]),
                work / f"sharded_{data}x{model}.log")
            if i == 0:                       # (c) beside the first (a)
                try:
                    cli_line = sharded_cli_result(cli, n)
                except BaseException:
                    stop_child(child)
                    raise
            gate.touch()
            rc, secs, text = wait_children({"w": child},
                                           SHARDED_TIMEOUT_S)["w"]
            if rc != 0:
                print(text[-8000:])
            require(rc == 0, f"sharded training on ({data}, {model}): rc {rc}")
            res = json.loads(out.read_text())
            for check in res["check"]:
                print("sharded_check " + json.dumps({**check,
                                                     "card": card}))
            for step in res["step"]:
                print("sharded_step " + json.dumps({
                    **step, "child_s": secs,
                    "phase14_step_ms": train["step_ms"],
                    "phase14_peak_memory_gb": train["peak_memory_gb"],
                    "phase14_step_peak_gb": train["step_peak_gb"],
                    "card": card}))
            for check in res["serve_check"]:
                print("sharded_serve_check " + json.dumps({**check,
                                                           "card": card}))
            print("sharded_serve " + json.dumps({
                **res["serve"], "serve_seconds": res["serve_seconds"],
                "card": card}))
        print("sharded_cli " + json.dumps({**cli_line, "card": card}))
    done()


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--sharded-worker"] and len(argv) == 6:
        sys.path.insert(0, str(ROOT / "src"))
        return sharded_worker(argv[1:])
    kernel_report = argv == ["--kernel-report"]
    meshes = [tuple(int(n) for n in a.split("x")) for a in argv[1:]
              if re.fullmatch(r"[0-9]+x[0-9]+", a)]
    if argv and not kernel_report and argv not in (
            ["--bits-probe"], ["--fused-split"]) and not (
            argv[0] == "--sharded-only" and len(meshes) == len(argv) - 1
    ) and not (argv[0] == "--bits-dump" and len(argv) == 3) and not (
            argv[0] == "--bits-compare" and len(argv) == 2):
        print(f"usage: {sys.argv[0]} [--kernel-report | --bits-probe | "
              "--fused-split | --sharded-only [DATAxMODEL ...] | "
              "--bits-dump DIR LABEL | --bits-compare DIR]",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    become_subreaper()
    try:
        return run(argv, kernel_report)
    finally:
        stop_strays()                        # on a failure too


def finish(rows: list, t_start: float) -> None:
    """The last lines, once no process this run started is left."""
    print("processes " + json.dumps({"stopped_at_end": stop_strays()}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def run(argv: list, kernel_report: bool) -> int:
    if argv == ["--bits-probe"]:
        bits_probe()
        return 0
    if argv[:1] == ["--bits-dump"]:
        device_phase()
        bits_dump(Path(argv[1]).resolve(), argv[2])
        return 0
    if argv[:1] == ["--bits-compare"]:
        bits_compare(Path(argv[1]).resolve())
        return 0
    if argv == ["--fused-split"]:
        device_phase()
        fused_split()
        return 0
    if argv[:1] == ["--sharded-only"]:
        t_start = time.perf_counter()
        print(card_line())
        sharded_phase(None, [tuple(int(n) for n in a.split("x"))
                             for a in argv[1:]] or None)
        finish([], t_start)
        return 0
    from repro_torch.core.matrices import banded_matrix, powerlaw_matrix
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device_phase()
    if not kernel_report:
        small_kernels_phase()
        small_spmm_phase()
        row_sum_phase()

    designer = {}
    done = phase("matrices")
    B = timed("banded_matrix(2**21, 4)", designer, banded_matrix, 2 ** 21, 4,
              seed=0)
    P = timed("powerlaw_matrix(2**20, 2**20, 8.0, 1.5)", designer,
              powerlaw_matrix, 2 ** 20, 2 ** 20, 8.0, 1.5, seed=0)
    rng = np.random.default_rng(1)
    xb_np = rng.standard_normal(B.n_cols).astype(np.float32)
    xp_np = rng.standard_normal(P.n_cols).astype(np.float32)
    oracle_b = timed("oracle banded", designer, B.spmv_dense_oracle, xb_np)
    oracle_p = timed("oracle powerlaw", designer, P.spmv_dense_oracle, xp_np)
    xb, xp = torch.from_numpy(xb_np).cuda(), torch.from_numpy(xp_np).cuda()
    print(f"  banded {B.n_rows}x{B.n_cols} nnz={B.nnz}; powerlaw "
          f"{P.n_rows}x{P.n_cols} nnz={P.nnz}")
    done()

    reset_launch_counts()                    # the compile path starts here
    ops.rowmap_combine.launches = 0
    searched_b = searched_phase(B, xb, oracle_b, designer)
    sweep = None if kernel_report else start_dryrun_sweep()
    banded, seg = fixed_phase(B, xb, oracle_b, P, xp, oracle_p, designer)
    torch.cuda.synchronize()
    launches = launch_counts()               # ... and ends here
    combines = ops.rowmap_combine.launches
    print(f"  compile-path launches: {launches}, rowmap_combine {combines}")
    require(all(launches[k] > 0 for k in SPMV_KERNELS) and combines > 0,
            f"a kernel of the compile path never launched: {launches}, "
            f"rowmap_combine {combines}")
    if not kernel_report:
        bitstable_phase(seg, xp)
        dryrun_sweep_phase(sweep)

    cases = kernel_cases(banded, seg, xb, xp, B.n_rows, P.n_rows)
    csr = {"banded": csr_on_device(B), "powerlaw": csr_on_device(P)}
    rows = report_phase(cases, launches, csr, {"banded": xb, "powerlaw": xp},
                        {"banded": B.n_rows, "powerlaw": P.n_rows})
    del banded, cases, csr

    done = phase("serving matrix")
    W = serving_matrix(designer)
    done()
    scratch = ROOT / "results"               # listed in .gitignore
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as store_dir:
        reset_launch_counts()                # the serving path starts here
        ops.rowmap_combine.launches = 0
        searched, swap_in, oracle8, x8 = serving_phase(W, designer,
                                                       store_dir)
        progs, xd = spmm_fixed_phase(W, swap_in, x8, oracle8, designer)
        torch.cuda.synchronize()
        serve_launches = launch_counts()     # ... and ends here
        serve_combines = ops.rowmap_combine.launches
        serve_grouped = grouped_launches()
    print(f"  serving-path launches: {serve_launches}, rowmap_combine "
          f"{serve_combines}, grouped {serve_grouped}")
    require(all(serve_launches[k] > 0 for k in SPMM_KERNELS)
            and serve_combines > 0 and all(serve_grouped.values()),
            f"a kernel of the serving path never launched: {serve_launches},"
            f" rowmap_combine {serve_combines}, grouped {serve_grouped}")
    launches.update({k: serve_launches[k] for k in SPMM_KERNELS})
    print("designer " + json.dumps({"host_seconds": designer}))
    csr_w = csr_on_device(W)
    rows += spmm_report_phase(spmm_cases(progs, xd, W.n_rows), launches,
                              csr_w, xd, W.n_rows)
    searched_seg_line(searched, xd, W.n_rows, serve_launches, csr_w)
    xp8 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (P.n_cols, 8)).astype(np.float32)).cuda()
    dense_row = dense_plans_line({
        **{f"powerlaw {red} unfused": (seg[f"{red} unfused"], xp, xp8)
           for red in ("SEG_SCAN_RED", "ONEHOT_MXU_RED", "GMEM_ATOM_RED")},
        "serving searched": (searched, xd[:, 0].contiguous(), xd)},
        seg, xp, P.n_rows, combines + serve_combines)
    del xp8
    require(len(rows) == len(KERNELS), "the report misses a kernel")
    rows.append(k1_grouped_line(progs["K7 scatter"], xd[:, 0].contiguous(),
                                csr_w, serve_grouped.get("K1[grouped]", 0)))
    del progs, csr_w
    torch.cuda.empty_cache()
    if kernel_report:
        rows += dist_phase(W, P, xp, oracle_p, x8, oracle8, searched,
                           designer, report=True)
        finish(rows + [dense_row], t_start)
        return 0

    x1 = xd[:, 0].contiguous()
    baselines_phase({
        "banded": (B, xb, oracle_b, {"searched": searched_b}),
        "powerlaw": (P, xp, oracle_p, {k: v for k, v in seg.items()
                                        if "bf16" not in k}),
        "serving": (W, x1, oracle8[:, 0], {"searched": searched})})
    dyn_phase(W, P, seg["SEG_SCAN_RED fused"], designer)
    corpus_phase({"banded searched": (searched_b, xb),
                  f"serving searched B={SERVE_B}": (searched, xd)})
    rows += dist_phase(W, P, xp, oracle_p, x8, oracle8, searched, designer)
    rows.append(dense_row)
    dev = torch.device("cuda", torch.cuda.current_device())
    llm = llm_phase(dev)
    train = train_phase(dev)
    dryrun_phase(llm["llm_serve_full"], train)
    sharded_phase(train)
    finish(rows, t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
