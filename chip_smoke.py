"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` each, in parallel), holds each against its plain PyTorch version
on the card, and drives the port's paths through the entry points a user
calls, each with the launch counts set to 0 just before it and read just
after:

1. build (ptxas's registers and spills of the flash and paged kernels;
   a spill in the tensor-core flash kernel at hd 64, 128 or 256 fails);
2. the bound's timing probes; 3. the cache-scan kernel against
   its plain version, every policy x prefetch (each row evicts under
   every pair);
4. ``simulate`` on the §V worked example;
5. ``simulate``'s stages on the full-size deployment (16 shards x 16,384
   lines, 2^22 requests), and the cache-scan kernel's masked mode against
   its plain version on requests 100,352 to 108,543 of its rows, from the
   carry the kernel left after the first 100,352 (each row's cache fills
   and begins to evict in that window);
6. the reuse-distance kernel against its plain version at small shapes,
   and on general rows (prev not a previous-occurrence array, valid not
   a prefix);
7. the cache-scan kernel with its own policy and beta on each of 8 rows
   in one launch, against its plain version;
8. the miss-rate-curve route at full width: ``sweep`` over 64 cache sizes
   of the full-size deployment under LRU (one reuse-distance launch, no
   cache-scan launch), its counters at 16,384 lines against the
   cache-scan kernel's, and the reuse kernel against its plain version on
   the first MRC_PLAIN_ROWS rows of the distance array;
9. the sweep's megabatch at full width: 16 points, 8 cache signatures,
   one cache-scan launch of 128 rows, and the cache-scan kernel against
   its plain version on those rows' first 2^13 steps;
10. serving at full width: mistral-nemo-12b in bf16 (weights from seed 0)
   at 20 of its 40 layers (the depth cut keeps the smoke inside its time
   limit), 8 requests x 3,072-token prompts, prefill and 257 greedy
   decode steps
   over the paged two-tier KV cache (tier 1 at half the pages, promotion
   every 4 steps); the flash-attention, paged-attention and page-copy
   kernels against their plain versions on inputs captured from that run;
   and the whole path again with the plain versions selected, fed the
   kernel run's tokens: the tier state equal integer for integer, the
   learner's f32 weights bit for bit, the final hidden states and the
   logprobs within a tolerance that two planted faults exceed.
11. serving mamba2-370m at full width (48 SSD layers, no KV pools), as
   phase 10: 48 SSD-scan launches at prefill, the kernel against its
   plain version on layer 0's captured inputs (y within one bf16 step,
   the final state within SSD_F32_TOL), the plain path teacher-forced
   within HIDDEN_TOL of the kernel run against a noise floor (the plain
   scan with half-length chunks), and a planted fault (layer 0's
   handed-off state zeroed) above the bar;
12. serving recurrentgemma-9b at full width (26 RG-LRU and 12 local
   attention layers, window 2,048, read window 17 pages), as phase 10:
   26 RG-LRU, 12 flash and 2 x 12 x 257 paged launches, each kernel
   against its plain version on captured inputs, the plain path with
   the tier state equal and the hidden states and logprobs within their
   bars, and planted faults (the window's token mask dropped; the
   RG-LRU handoff state unrounded) above the bar.
13. the chunked replay at full size: phase 5's deployment through
   ``simulate_stream`` at ``DEFAULT_CHUNK`` (16 launches of the
   cache-scan kernel's masked mode), its counters and report equal to
   phase 5's, and again with ``donate=False``; a stop at 2^21 requests,
   the checkpoint pickled and resumed (equal results, equal peak device
   memory in both halves, at most two buffer sets); a two-tenant mix at
   full width against a one-shot ``tier1_counters``; the masked kernel
   against its plain version from the checkpoint's carry with pads
   mid-row, in the default plan, at cluster 1 and in the scratch plan;
   ``engine="scan"`` on the card against the fused kernel.
14. training (``repro_torch.launch.train.run_training``): (a) stablelm-3b
   at full width (bf16 weights, f32 AdamW moments and error feedback,
   remat) for 6 steps of 2 x 4,096 tokens from the two-tier data-shard
   cache: finite losses and grad norms, the median step time, tokens/s,
   model FLOP/s against the bf16 peak, peak memory, the card's busy share
   over one step (``torch.profiler``) and the cache's hits and misses;
   (b) three steps of reduced stablelm-3b in f32 on the card and on the
   CPU from one state, within TRAIN_CPU_TOL; (c) the restart drill at
   stablelm-3b's width and depth 2: a run killed after its first tier-1
   snapshot and resumed equals an uninterrupted run bit for bit, with the
   snapshot's save and restore times. The training path reaches no hand
   kernel (the reference trains through its plain blockwise attention),
   so its launch counts print as 0.
15. the §VII configurator: ``configure()`` on the test size of
   ``tests/test_system.py`` on the card and on the CPU, every field of
   every candidate equal and in the same order (one cache-scan launch a
   cache size); then at a planner's size (IRM, 2^20 requests over 2^20
   pages, 30% writes; 1,024 to 16,384 lines; k 1 to 64; λ 200), its
   frontier, time and 5 launches.
16. int8 KV serving at full width: phase 10's serve with
   ``kv_dtype="int8"``: int8 pools of half phase 10's bytes with f32
   scales, the tier state and learner equal to phase 10's bf16 run, the
   paged kernel's int8 variant against its plain version on captured
   inputs (a plain version without the bf16 rounding must fail that
   bar), the plain path teacher-forced within phase 10's bars with two
   planted faults above them (the v scale read for k; the scales one
   slot off), and page copy on int8 slots and scale rows, byte for byte.
17. whisper-tiny served at full width as phase 10: 32 requests of 1,500
   stub frame embeddings (the encoder's 4 layers of full attention, once
   at prefill) and 128-token decoder prompts, 257 decode steps, each
   decoder layer's cross-attention over its stored keys and values; the
   encoder's, the cross- and the causal self-attention's flash calls
   against the plain version; a planted fault (layer 0's stored
   cross-attention keys and values zeroed) above the bar.
18. paligemma-3b served as phase 10: 16 requests of 256 stub patch
   embeddings (a bidirectional prefix) and 256 text tokens; the
   prefix-LM flash call against the plain version, which without the
   prefix mask must fail that bar; a planted fault (the prefix mask
   dropped at prefill) above the serve's bar.
19. mixtral-8x22b at full width and 8 of its 56 layers (20.4 B
   parameters; all 56 do not fit one card) with phase 10's shape: top-2
   of 8 experts behind the 4,096-token window (33 read pages > 27, so the
   window never clips); the prefill's dropped-slot fraction; bars on the
   median over steps and sequences (routing flips at near-ties move a
   few tokens' states a long way), a planted fault (top-1 routing) above
   them.
20. training the other families (``run_training`` for mamba2-370m,
   recurrentgemma-9b at 3 of 38 layers and mixtral-8x22b at 1 of 56;
   ``make_train_step`` with stub frames or patch embeddings for
   whisper-tiny and paligemma-3b): (a) each at full width for 4 steps:
   finite losses and grad norms, no step skipped, every layer of every
   first-moment leaf non-zero (so mamba2's gradients at its chunk of 256
   are finite, fault (l) of the reference), the median step, positions
   a second, model FLOP/s against the bf16 peak, peak memory beside its
   reckoning, mixtral's auxiliary loss and dropped slots, and no hand
   kernel launched (training runs the reference's training forms: the
   plain blockwise attention, the chunked SSD scan and the associative
   RG-LRU scan under autograd); (b) two f32 steps of each reduced
   configuration on the card and on the CPU from one state, within
   TRAIN_CPU_TOL (mixtral's routing compared between the devices).
21. serving across ranks (``repro_torch.launch.spmd.build_serve``):
   mistral-nemo-12b at full width and 4 of its 40 layers on 4 ranks that
   share the card (``repro_torch.launch.mesh.spawn_ranks``; gloo, by the
   backend rule, since NCCL takes one card a rank), a (data 2, model 2)
   mesh with the pages sharded over the model axis (block-cyclic), 8 x
   3,072-token prompts (4 a data shard) and SHARDED_STEPS decode steps
   teacher-forced on a one-card serve of the same configuration and depth
   run first: (a) each rank's kernel run against its plain run, the tier
   state equal field for field and the hidden states and logprobs within
   phase 10's bars; (b) the sharded run against the one-card run within
   the same bars, (a) printed beside as the noise floor; (c) every page
   has one owner, and every tier-2 launch of layer 0 reads owned pages
   only; (d) page shard 1's partial dropped from the combine exceeds the
   bar, over SHARDED_FAULT_STEPS steps from the kernel run's prefill
   state. Flash, paged attention and page copy launch on every rank; rank 0
   holds each against its plain version at the sharded shapes. It prints
   the backend, each rank's decode ms a step and its collectives a step
   and their share of the step.
22. training across ranks (``repro_torch.launch.spmd.build_train_step``),
   on phase 21's 4 ranks, after its serve: (a) stablelm-3b at full width
   and 4 of its 32 layers on (data 2, model 2), bf16 with remat, f32
   AdamW moments, SHARDED_TRAIN's 2 x 4,096 tokens (1 x 4,096 a data
   shard), 3 steps: every step finite and applied on every rank, the
   metrics equal on every rank, no hand kernel launched; each rank's step
   ms, its collectives by kind (the backward's included: the FSDP
   gathers' reduce-scatters, the entry markers' sums) with their calls,
   bytes and share of the step, and its peak memory; (b) the reduced
   stablelm-3b in f32 on (data 2, model 2), and on (pod 2, data 2) with
   int8-compressed pod gradients, 2 steps each, every rank's metrics and
   blocks of the parameters and both moments against the one-card step on
   the card, within the CPU tests' bars
   (``tests/test_torch_sharded_train.py``); (c) a planted fault, the data
   axis's sum of the replicated leaves' gradients dropped, above them.
23. the dry run (``repro_torch.launch.dryrun``) of phase 22 (a)'s cell:
   rank 0's step traced on ``meta`` in a fake process group of the 4
   ranks, in this process and on no card. Its collectives a step (calls
   and bytes by kind, and their wire bytes) and its argument bytes must
   equal rank 0's on the card exactly; it prints its peak memory beside
   rank 0's on the card, with their ratio, and its roofline on the H100's
   published peaks (the three terms, the dominant one, roofline_frac)
   beside phase 22's measured step. It takes at most DRY_RUN_LIMIT_S.

It prints:

- the card's name and power limit, as ``nvidia-smi`` prints them;
- one line per phase, with its times;
- one JSON line ``{"kernels": [...]}`` with the seven kernels'
  launches on their paths, its agreement with the plain version, its time, the plain
  version's time and its bound, term by term (paged attention's time in
  a loop of wrapper calls, and from a CUDA graph of the kernel's launches
  alone as ``ms_graph``; page copy's ``ms`` a loop of 5 wrapper calls with
  the index vectors on the CPU, as the engine's write-back and promotion
  pass them (after 5 untimed calls), ``ms_blocking`` the same loop with
  the index vectors first moved to the card by blocking copies from
  pageable memory (what the wrapper did before it moved them through
  pinned memory; the two loops alternate, each key the median of three),
  ``ms_cold`` its launch alone with int32 indices already on the card,
  each launch between its own CUDA events after the 50 MB L2 is flushed
  by writing 256 MiB, the median of 25, held against the bound,
  ``library_ms_cold`` ``dst[di] = src[si]`` timed the same way,
  ``library_ms`` a loop of 5 of those warm, ``ms_graph`` the
  launch replayed warm from a CUDA graph (not held against the bound: it
  may read from L2); the cache scan's chunked replay under
  ``chunked_`` keys; paged attention's int8 variant under ``int8_``
  keys, page copy's under ``int8_`` (its scale rows under
  ``int8_scale_``) and at phase 12's shape under
  ``recurrentgemma_``; flash, paged attention and page copy at phases
  17-19's shapes under ``whisper_enc_`` / ``whisper_cross_`` /
  ``whisper_self_`` (flash) or ``whisper_``, ``vlm_prefix_`` and ``moe_``
  keys; and phase 21's sharded shapes of flash, paged attention and page
  copy under ``sharded_`` keys, rank 0's, beside the one-card ones);
- each phase's end, in seconds from the start (``[smoke] phase ...``);
- last, ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits nonzero. Without CUDA, or without the
rest of the repository beside it, the script exits nonzero and prints no
result.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s. The data sheet's
# 67 TFLOP/s outside the tensor cores counts an FMA as two operations on
# 128 fp32 lanes an SM; Hopper's SM has 64 int32 lanes (Hopper architecture
# white paper), so the kernel's integer compares, adds and selects issue at
# a quarter of that.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# Integer operations per cache line: the lookup compare (every step, over
# the filled lines), each LRU/LFU argmin step (eviction steps), and the
# Random expert's threefry draw and argmax step (eviction steps: 20 rounds
# of add/rotate/xor, 6 key injections, the mantissa shift).
OPS_LOOKUP, OPS_ARGMIN, OPS_DRAW = 1, 1, 83
# Integer operations a filled line costs a look-ahead pass: its tag's hash
# (a multiply and a shift), the probe's load and compare.
OPS_PROBE = 4
# Per eviction step and line: the int32 state arrays the victim experts
# read (LRU: ts, LFU: freq) and whether the Random expert draws.
VICTIM_ARRAYS = {"ws": 2, "lru": 1, "lfu": 1, "random": 0}
DRAWS = {"ws": 1, "lru": 0, "lfu": 0, "random": 1}
PUBLISHED_LAM_EFF = 86.6  # §V worked example
# Phase 5 holds the kernel against the plain version on WINDOW requests of
# each full-size row from the masked mode's carried state at request
# WINDOW_START: every row's 16,384 lines fill (its 16,384th distinct page
# arrives between requests 103,071 and 107,078) and evictions begin
# inside the window, which ends at request 108,543. (A prefix of 2^17
# requests from an empty cache held the same events, but its plain
# per-step loop took 180-270 s; a window of 2^15 took 94-123 s, of 2^14
# from request 98,304 47-75 s until PR 25, which cut it to pay for phase
# 22; the phase checks that every row fills and evicts in the window.)
WINDOW_START, WINDOW = 3 * 2**15 + 2**11, 2**13
# Megabatch steps per row held against the plain version. Its rows fill
# their 16,384 lines near step 105,000, so this prefix covers the fill
# only; eviction under each policy and beta is held in phases 3 and 7,
# and at full size under ws in phase 5. The plain version's per-step loop
# takes about 2 ms a step on an H100 (PERF.md), and 2^17 steps here
# would take a fifth of the smoke's time (2^15 took 69 s).
# (2^14 until PR 25, whose phase 22 its 30 s of plain loop paid half of.)
MEGA_PREFIX = 2**13
# Phase 8 holds the reuse kernel against the plain O(L^2) count on this
# many of the MRC route's 16 rows of 2^19 (all 16 until PR 25, 40-47 s of
# the plain count; cut to pay for phase 22).
MRC_PLAIN_ROWS = 4
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
# The serves' shape: 8 requests of 3,072-token prompts, 257 decode steps,
# tier 1 at half the pages, promotion every 4 steps, at full width.
SERVE_SHAPE = dict(full=True, requests=8, prompt=3072, new=258,
                   hbm_fraction=0.5, promote_every=4)
# Phase 10: mistral-nemo-12b at full width and 20 of its 40 layers (the
# depth cut keeps the smoke inside its time limit beside phases 17-19;
# phase 16's tier state is held against this run's, so it takes the same
# depth), and its tolerances.
SERVE = dict(SERVE_SHAPE, arch="mistral-nemo-12b", layers=20)
FLASH_TOL = 2e-2     # bf16 output, the bar of tests/test_kernels.py
# Element by element, the flash kernel's bf16 output against the plain
# version's: both round f32 results that differ only in summation order,
# so they may differ by one bf16 step (2^-7 of the value at most), plus
# the f32 summation noise where the output cancels to near zero.
FLASH_ULP, FLASH_ABS = 2.0 ** -7, 1e-5
FLASH_FAULT = 2.0 ** -5  # planted fault: the last query tile off by 1/32
PAGED_REL_TOL = 1e-5  # f32 partials, against each field's largest magnitude
# Kernel run vs plain run, in nats. The random 40-layer bf16 model
# amplifies any change of summation order: the plain run against itself
# with only the prefill attention reordered differs by about a tenth of a
# nat (the phase measures this noise floor); in f32 the kernel run stays
# within 1e-4 of the plain run (tests/test_torch_serving_cuda.py).
LOGPROB_TOL = 0.5
# Kernel run vs plain run: the final hidden state that each step unembeds,
# |h - h_plain| / |h_plain| for each sequence and step. Planted faults
# (the tier-2 partial dropped; one tier-2 page skipped) must exceed it.
HIDDEN_TOL = 0.05
# Phases 11 and 12: the recurrent models at full width, served as phase 10.
SSD_SERVE = dict(SERVE_SHAPE, arch="mamba2-370m")
# recurrentgemma-9b keeps all 38 layers: at 20 (6 attention and 14 RG-LRU
# layers) its planted fault (b) moved the hidden state by 0.0467 on an
# H100, under the 0.05 bar (PERF.md §4).
RG_SERVE = dict(SERVE_SHAPE, arch="recurrentgemma-9b")
# The SSD kernel's f32 results (the final state; y from f32 inputs)
# against the plain version's, over the largest magnitude. Both sum the
# within-chunk decay dt A in f32; at mamba2's chunk of 256 a chunk's sum
# reaches several hundred, where one f32 ulp is ~3e-5, so the decays
# exp(cum_t - cum_s) of two summation orders differ by that much (2.5e-5
# for the state, 2.6e-5 for y on an H100, PERF.md §6).
SSD_F32_TOL = 1e-4
# Phase 11's bar on the final hidden state, kernel run vs plain run: the
# random 48-layer mamba2 in bf16 turns a reordering into more than phase
# 10's bar (the plain path against itself with half-length chunks differs
# by 0.069 on an H100, PERF.md §6); 2.9x that floor, while the planted
# fault (one layer's handed-off state zeroed) gave 0.82. So this comparison
# catches only faults that move the hidden state by more than 0.2; the
# kernel-level checks on captured inputs (y within one bf16 step, the state
# within SSD_F32_TOL) carry the fine bar.
SSD_HIDDEN_TOL = 0.2
# Phase 14: training. (a) stablelm-3b at full width, 2 x 4,096 tokens (the
# sequence of SHAPES["train_4k"]), 6 steps with the reference launcher's
# hyperparameters (8 until PR 25, whose phase 22 they pay for); the step
# time is the median of steps 3-6.
TRAIN = dict(arch="stablelm-3b", batch=2, seq=4096, steps=6, lr=3e-4)
TRAIN_TIMED = slice(2, 6)
# (b) three steps of reduced stablelm-3b in f32 on the card and on the CPU
# from one state. The matmuls reduce in other orders on the two devices
# (cuBLAS with TF32 off; the CPU's BLAS), which moves losses and grad
# norms in their last bits (the port against the reference on the CPU:
# 2.4e-7 relative); AdamW's m / (sqrt(v) + eps) turns last-bit differences
# of gradients near zero into visible fractions of the learning rate (the
# same comparison: up to 0.047 lr after three steps). So: losses and grad
# norms within 1e-5 relative, every parameter within 0.1 lr a step.
TRAIN_CPU = dict(batch=4, seq=64, steps=3, lr=1e-3)
TRAIN_CPU_TOL = dict(rel=1e-5, lr_frac_per_step=0.1)
# (c) the restart drill at full width and depth 2 (0.42 B parameters, a
# 5.8 GB snapshot): 5 steps uninterrupted; killed after step index 3 with
# a tier-1 snapshot every 3 steps (one, at step 3); resumed to step 5.
DRILL = dict(layers=2, steps=5, kill_at=3, tier1_every=3)
# Phase 20: the other families train at their published widths, each for
# TRAIN_FAMILY_STEPS steps (bf16 weights from seed 0, remat, the moments in
# the configuration's dtype: f32, bf16 for mixtral), the step time the
# median of steps 2-4. Depth and batch are cut only where one 80 GB card
# forces it: recurrentgemma-9b at 3 of 38 layers (one R, R, local
# attention repeat: 9.57 B parameters would take 153 GB of state) and 1 x
# 4,096 tokens (the f32 logits over 256,000 tokens take 21 GB); mixtral at
# 1 of 56 layers (2 reckon to 70 GB); paligemma-3b 1 x (256 patches +
# 3,840 tokens). "reckoned" (``_train_reckoning``) is the state, 16 B a
# parameter (bf16 parameters and gradients, two f32 moments, f32 error
# feedback; 12 B with bf16 moments), plus the f32 logits, their exp and
# their gradient (3 x 4 B a position and vocabulary entry) and the f32
# unembedding with its gradient; activations under remat are not counted.
TRAIN_FAMILIES = (
    dict(arch="mamba2-370m", layers=0, batch=2, seq=4096),
    dict(arch="recurrentgemma-9b", layers=3, batch=1, seq=4096),
    dict(arch="mixtral-8x22b", layers=1, batch=2, seq=4096),
    dict(arch="whisper-tiny", layers=0, batch=8, seq=448),
    dict(arch="paligemma-3b", layers=0, batch=1, seq=4096),
)
TRAIN_FAMILY_STEPS = 4
# (b) two f32 steps of each family's reduced configuration on the card and
# on the CPU from one state, held to TRAIN_CPU_TOL.
TRAIN_FAMILY_CPU = dict(batch=4, seq=64, steps=2, lr=1e-3)
# Page copy's cold times (``cold_ms``): the median of COLD_REPS calls,
# each after writing L2_FLUSH_BYTES (five times the H100's 50 MB L2).
L2_FLUSH_BYTES = 256 * 2**20
COLD_REPS = 25
PROFILE_STEPS = 4  # decode steps traced with torch.profiler
CONTROL_STEPS = 24  # decode steps of the noise-floor run
# Phase 15: the configurator on the test size of tests/test_system.py, on
# the card and on the CPU, then at a planner's size: one shard of 16,384
# lines at most (the eviction's argmin walks every line; one row at 2^18
# lines would take tens of seconds).
CONF_TEST = dict(spec=dict(kind="poisson", n_requests=600, n_pages=128),
                 arrival_rate=100.0, cache_sizes=(16, 64), k_threads=(1, 16))
CONF_PLAN = dict(spec=dict(kind="irm", n_requests=2**20, n_pages=2**20,
                           write_fraction=0.3, seed=0),
                 arrival_rate=200.0,
                 cache_sizes=tuple(2**i for i in range(10, 15)),
                 k_threads=(1, 4, 16, 64))
# Phase 16: phase 10's serve with int8 KV pools.
INT8_SERVE = dict(SERVE)
# Phases 17-19: the other families at full width, served as phase 10
# (bf16 weights from seed 0, tier 1 at half the pages, promotion every 4
# steps, 257 decode steps). Whisper-tiny: 32 requests of 1,500 stub frames
# and 128-token decoder prompts (385 positions of its 448). Paligemma-3b:
# 16 requests of 256 patch embeddings and 256 text tokens. Mixtral-8x22b at
# full width and 8 of its 56 layers: 20.4 B parameters, 40.9 GB in bf16
# (all 56 layers, 141 B, do not fit one 80 GB card), phase 10's shape.
# Each "hidden_tol" is the phase's bar on the final hidden state, kernel
# run vs plain run, set from the noise floor the phase measures (the plain
# path with blockwise prefill attention); every planted fault must exceed
# it.
WHISPER_SERVE = dict(SERVE_SHAPE, arch="whisper-tiny", requests=32, prompt=128,
                     tag="whisper serve", hidden_tol=HIDDEN_TOL,
                     key="whisper", flash_keys=dict(
                         enc="whisper_enc", cross="whisper_cross",
                         self="whisper_self"))
VLM_SERVE = dict(SERVE_SHAPE, arch="paligemma-3b", requests=16, prompt=256,
                 tag="vlm serve", hidden_tol=HIDDEN_TOL, key="vlm_prefix",
                 flash_keys=dict(self="vlm_prefix"))
# Mixtral's bars hold the median over steps and sequences: a reordered
# sum flips the routing of a few tokens at near-ties, which moves their
# hidden states by up to 0.8 and their logprobs by up to 3 nats (more at
# the prefill's capacity drops, where a flip shifts the queue positions
# behind it), but the median stays at the noise floor (0.011 for the
# hidden state, 0.026 nats on an H100, PERF.md §2). Bars: 0.05 (phase
# 10's) and 0.1 nats; top-1 routing moved the median hidden state by 1.01.
MOE_SERVE = dict(SERVE_SHAPE, arch="mixtral-8x22b", layers=8, tag="moe serve",
                 hidden_tol=HIDDEN_TOL, logprob_tol=0.1, quantile=0.5,
                 key="moe", flash_keys=dict(self="moe"))

# Phase 21: mistral-nemo-12b served by 4 ranks that share the card, on a
# (data 2, model 2) mesh with its pages sharded over the model axis
# (block-cyclic), at full width and 4 of its 40 layers, 8 x 3,072-token
# prompts (4 a data shard) and SHARDED_STEPS teacher-forced decode steps;
# the planted fault (page shard 1's partial dropped from the combine) over
# SHARDED_FAULT_STEPS of them, from the kernel run's prefill state. Gloo
# moves about 0.45 GB/s a rank between ranks that share the card, and
# ZeRO-3 gathers every layer's weights and the embedding and unembedding
# every step (4.2 s a step at 8 layers), so the steps were cut from 33 to
# 4, then the layers from 8 to 4 (PERF.md §4).
SHARDED_STEPS = 4
SHARDED_FAULT_STEPS = 2
SHARDED_SERVE = dict(SERVE_SHAPE, arch="mistral-nemo-12b", layers=4,
                     new=SHARDED_STEPS + 1, mesh=((2, 2), ("data", "model")),
                     page_axes=("model",), mapping="block_cyclic")
# Phase 22: training across phase 21's 4 ranks. (a) stablelm-3b at full
# width and 4 of its 32 layers (phase 14's global batch of 2 x 4,096, 3
# steps): a rank gathers its 23.1 M-parameter block of each layer over
# "data" twice a step (forward and remat), reduce-scatters the gathered
# gradients, and sums the TP partials (forward and remat) and the entry
# markers' gradients over "model": ~2.2 GB a rank a step, ~5 s at gloo's
# ~0.45 GB/s between ranks that share the card, so depth is cut to 4
# layers and the steps to 3 (PERF.md §4). (b) the parity runs, the
# reduced f32 configuration at the CPU tests' shape; (c) the planted
# fault on the first parity mesh.
SHARDED_TRAIN = dict(arch="stablelm-3b", layers=4, batch=2, seq=4096,
                     steps=3, lr=3e-4, mesh=((2, 2), ("data", "model")))
SHARDED_TRAIN_PARITY = dict(
    arch="stablelm-3b", batch=4, seq=32, steps=2,
    meshes=(((2, 2), ("data", "model"), False),
            ((2, 2), ("pod", "data"), True)))
# Phase 23: the dry run of phase 22 (a)'s cell (rank 0's step traced on
# meta in a fake group of 4 ranks, in the smoke's own process) takes at
# most this long.
DRY_RUN_LIMIT_S = 30
# The CPU tests' bars (tests/test_torch_sharded_train.py): losses and grad
# norms 1e-5 relative, parameters 0.1 lr a step, moments 1e-5 of each
# leaf's largest; with int8 pod compression the reference's own bars
# (loss 1e-5, parameters and moments 5e-4, absolute) and the grad norm
# within one code step (1 / 127) relative.
SHARDED_TRAIN_TOL = dict(rel=1e-5, lr_frac_per_step=0.1, moment_rel=1e-5,
                         ref_loss=1e-5, ref_abs=5e-4, code_step=1 / 127)

def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 1) -> tuple[float, object]:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    out = None
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def graph_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn()`` replayed from a CUDA graph ``reps``
    times (CUDA events): the launches' own time, without the host's time
    between them, which a loop of short kernels from Python may exceed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    ms, _ = cuda_ms(graph.replay, reps)
    return ms


def _paged_inputs(call) -> tuple:
    """A captured paged launch (``q, pool, slot, live, window`` and, for an
    int8 pool, its scale) with q in f32 and the tables in int32 on the
    pool's card, as the wrapper converts them: timing it times the kernel
    alone."""
    q, pool, slot, live, window, *scale = call
    dev = pool.device
    return (q.to(dev, torch.float32).contiguous(), pool,
            slot.to(dev, torch.int32).contiguous(),
            live.to(dev, torch.int32).contiguous(), window, *scale)


def _seen(row: np.ndarray) -> np.ndarray:
    """Distinct pages of ``row`` before each step."""
    new = np.zeros(len(row), np.int64)
    new[np.unique(row, return_index=True)[1]] = 1
    return np.cumsum(new) - new


def filled_lines(row: np.ndarray, n_lines: int, start: int = 0) -> int:
    """Lines the lookups of one row's steps from ``start`` on scan (the
    steps before ``start`` only fill the cache): a step scans the lines
    filled before it. No line is evicted before the cache is full, so until
    then the fill is the number of distinct pages the row has seen."""
    return int(np.minimum(_seen(row)[start:], n_lines).sum())


def filled_at_passes(row: np.ndarray, n_lines: int, K: int,
                     start: int = 0) -> int:
    """Lines the look-ahead passes of one row's steps from ``start`` on
    scan: the pass before step ``t0`` (every ``K``-th step from ``start``)
    scans the lines filled before it."""
    return int(np.minimum(_seen(row)[start::K], n_lines).sum())


def bound(policies, out: dict, pages: np.ndarray, n_lines: int, W: int,
          plan, chain_ms: float, walker_ms: float, rates: dict,
          start: int = 0) -> dict:
    """Least time the card could take for this run's work, term by term
    (``policies``: one policy for every row, or one a row; ``plan``: the
    launch's ``cache_scan.Plan``). The terms of the look-ahead design, of
    which the bound is the largest:

    - ``io_bytes_ms``: inputs read once (page, write flag, window id; 12 B
      a request) and outputs written once, over the HBM rate;
    - ``state_bytes_pass_ms``: the per-line state the design must read (4 B
      of tags a filled line a look-ahead pass of ``plan.K`` steps; on an
      eviction step 4 B a line of each array a victim expert scans), over
      the shared-memory read rate measured here where the state lives in
      shared memory, else the L2 read rate;
    - ``ops_pass_ms``: the integer operations on those lines (a pass's
      probe, the argmins, the Random draws), over the int32 rate;
    - ``walker_chain_ms``: each row is a chain of dependent walker
      iterations, and none can take less than the measured skeleton of
      one (``walker_ms`` is ``L`` of them: one warp's dependent
      shared-memory step each, and a block pass every K steps). An
      iteration takes one miss or a run of at most 32 hits, so a row
      takes at least ``misses + ceil(hits / 32)`` of them; the term is
      the most of any row, at ``walker_ms / L`` each.

    Beside them, as before, the terms of the design with a block barrier a
    step (``bound_terms_block_barrier``): ``state_bytes_ms`` (4 B of tags a
    filled line a step, at the L2 rate), ``ops_ms`` (a compare a filled
    line a step) and ``serial_chain_ms`` (two block barriers around one
    dependent L2 load a step). ``bytes`` names the byte terms,
    ``operations`` the others (the chain is a chain of dependent
    operations). With ``start``, the launch took the steps from ``start``
    on of ``pages``' rows, resuming from the state the steps before left.
    """
    B, L = pages.shape
    L -= start
    if isinstance(policies, str):
        policies = [policies] * B
    evictions = out["evictions"].tolist()
    state = ops = state_pass = ops_pass = 0
    fills: dict = {}  # a sweep's points repeat the same shard rows
    for row, policy, ev in zip(pages, policies, evictions):
        key = row.tobytes()
        if key not in fills:
            fills[key] = (filled_lines(row, n_lines, start),
                          filled_at_passes(row, n_lines, plan.K, start))
        scanned, passed = fills[key]
        ev_lines = ev * n_lines
        victims = 4 * VICTIM_ARRAYS[policy] * ev_lines
        evict_ops = ev_lines * (OPS_ARGMIN * VICTIM_ARRAYS[policy]
                                + OPS_DRAW * DRAWS[policy])
        state += 4 * scanned + victims
        ops += OPS_LOOKUP * scanned + evict_ops
        state_pass += 4 * passed + victims
        ops_pass += OPS_PROBE * passed + evict_ops
    io = 12 * B * L + B * (4 * 8 + 4 * 3 + 4 * 3 + 4 * 13 * W)
    rate = rates["smem"] if plan.smem_state else rates["l2"]
    misses = np.asarray(out["misses"].tolist(), np.int64)
    iters = int((misses + -(-(L - misses) // 32)).max())
    terms = dict(io_bytes_ms=1e3 * io / HBM_BYTES_PER_S,
                 state_bytes_pass_ms=1e3 * state_pass / rate,
                 ops_pass_ms=1e3 * ops_pass / INT32_OPS_PER_S,
                 walker_chain_ms=walker_ms * iters / L)
    return dict(_largest(terms), bound_terms_block_barrier=dict(
        state_bytes_ms=1e3 * state / rates["l2"],
        ops_ms=1e3 * ops / INT32_OPS_PER_S, serial_chain_ms=chain_ms))


def cache_scan_bound(policies, out: dict, pages: np.ndarray, cfg, W: int,
                     rates: dict, start: int = 0) -> dict:
    """:func:`bound` of a cache-scan launch over ``pages``' rows (from
    ``start`` on), with its plan and its two step probes timed here on the
    launch's shapes."""
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.kernels import probe
    B, L = pages.shape
    L -= start
    plan = cs.cache_scan_plan(cfg, W, B)
    dev = torch.device("cuda")
    chain = probe.chain_step_ms(dev, n_rows=B, threads=plan.threads,
                                steps=L)
    walker = probe.walker_step_ms(dev, n_rows=B, threads=plan.threads,
                                  steps=L, K=plan.K, n_lines=cfg.n_lines)
    return dict(bound(policies, out, pages, cfg.n_lines, W, plan, chain,
                      walker, rates, start), plan=plan._asdict())


def _largest(terms: dict) -> dict:
    top = max(terms, key=terms.get)
    return dict(bound_ms=terms[top],
                bound_by=("bytes" if "bytes" in top else "operations"),
                bound_terms=terms)


def reuse_bound(prev: np.ndarray, valid: np.ndarray) -> dict:
    """Least time for the reuse-distance pass over ``prev``/``valid``:

    - ``bytes_ms``: ``prev`` (4 B) and ``valid`` (1 B) read once and the
      distances (4 B) written once, over the HBM rate;
    - ``ops_ms``: the compares of an O(n log n) count, ``n ceil(log2 n)``
      for a row of ``n`` real (valid) positions, over the int32 rate.

    It prices the algorithm the kernel runs, a merge sort of each row
    that counts on the way (``csrc/reuse_distance.cu``): a comparison sort
    of ``n`` keys needs ``log2(n!) ~ n log2 n`` compares. Beside them, not
    applied (``bound_terms_direct_count``), the compares of a direct
    count, which the kernel ran before its redesign: ``j - P[j] - 1`` for
    each real position ``j`` with ``P[j] >= 0``."""
    S, L = prev.shape
    n = valid.sum(axis=1).astype(np.int64)
    sort_compares = int(sum(int(x) * int(np.ceil(np.log2(x)))
                            for x in n if x > 1))
    j = np.arange(L, dtype=np.int64)[None, :]
    reused = valid & (prev >= 0)
    compares = int(np.where(reused, j - prev.astype(np.int64) - 1, 0).sum())
    return dict(_largest(dict(bytes_ms=1e3 * 9 * S * L / HBM_BYTES_PER_S,
                              ops_ms=1e3 * sort_compares / INT32_OPS_PER_S)),
                bound_terms_direct_count=dict(
                    ops_ms=1e3 * compares / INT32_OPS_PER_S),
                sort_compares=sort_compares, compares=compares)


def compare(got: dict, want: dict, ctx: str) -> float:
    """Every field equal (integers exactly, f32 bit for bit); returns the
    largest absolute difference (0.0)."""
    if set(got) != set(want):
        raise AssertionError(f"kernel != plain ({ctx}): fields differ")
    err = 0.0
    for f, ref in want.items():
        x = got[f]
        if ref.dtype == torch.float32:
            same = torch.equal(x.view(torch.int32), ref.view(torch.int32))
        else:
            same = torch.equal(x, ref)
        err = max(err, float((x.double() - ref.double()).abs().max()))
        if not same:
            raise AssertionError(f"kernel != plain ({ctx}): field={f}")
    return err


def check_report(rep, ctr, ctx: str) -> None:
    """A sweep report's per-shard and windowed counters equal
    ``tier1_counters``'s ``ctr`` in every field."""
    from repro_torch.sim.engine import _ffill_weights
    for f in ("requests", "reads", "writes", "hits", "misses",
              "prefetch_hits", "tier2_reads", "tier2_writes", "evictions"):
        if [getattr(sh, f) for sh in rep.shards] != getattr(ctr, f).tolist():
            raise AssertionError(f"{ctx} != tier1_counters in {f}")
    for f in ("requests", "hits", "misses", "prefetch_hits", "tier2_reads",
              "tier2_writes", "evictions", "expert_use"):
        if not np.array_equal(getattr(rep.windows, f),
                              getattr(ctr, "win_" + f)):
            raise AssertionError(f"{ctx} != tier1_counters in windows.{f}")
    if not np.array_equal(rep.windows.weights, _ffill_weights(
            ctr.win_weights, ctr.win_requests)):
        raise AssertionError(f"{ctx}: window weights differ")


def fmt_bound(b: dict) -> str:
    def terms(d):
        return ", ".join(f"{k[:-3]} {v:.4f}" for k, v in d.items())
    text = (f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
            f"{terms(b['bound_terms'])}")
    for name in ("bound_terms_block_barrier", "bound_terms_per_head_cb",
                 "bound_terms_direct_count"):
        if name in b:
            text += f"; not applied: {terms(b[name])}"
    if "plan" in b:
        p = b["plan"]
        where = "shared memory" if p["smem_state"] else "device scratch"
        text += (f"; plan: state in {where}, K {p['K']}, {p['threads']} "
                 f"threads, cluster {p['cluster']}")
    return text + ")"


def check_over_bound(tag: str, ms: float, bound_ms: float) -> None:
    """A kernel time under its own bound means the bound prices work the
    kernel does not do: fail."""
    if not ms >= bound_ms:
        raise AssertionError(f"[{tag}] kernel {ms} ms under its bound "
                             f"{bound_ms} ms")


def check_kernels_over_bounds(kernels: list) -> None:
    """Every ``<x>ms`` of the kernels line at or above its
    ``<x>bound_ms``."""
    for entry in kernels:
        for key, b in entry.items():
            if key.endswith("bound_ms") and b is not None:
                ms = entry.get(key[:-len("bound_ms")] + "ms")
                if ms is not None:
                    check_over_bound(f"{entry['name']} {key}", ms, b)


def phase_build():
    """Build every CUDA source at once (one nvcc each, in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import cache_scan as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import page_gather as pg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import probe
    from repro_torch.kernels import reuse_distance as rd
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.build import build_library
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        libs = list(pool.map(lambda f: f(), (
            cs.build_cache_scan, rd.build_reuse_distance, probe.build_probe,
            fa.build_flash_attention, pa.build_paged_attention,
            pg.build_page_copy, ss.build_ssd_scan, rs.build_rglru_scan)))
    dt = time.perf_counter() - t0
    for lib in libs:
        report = [ln.strip() for ln in lib.with_suffix(".log").read_text()
                  .splitlines() if "registers" in ln or "smem" in ln]
        log(f"[build] {lib.name}; ptxas: {' | '.join(report)}")
    log(f"[build] {len(libs)} libraries in {dt:.2f} s")
    # The redesigned kernels' logs, found by source (the libraries exist
    # now, so build_library only returns their paths).
    logs = {src: ptxas_functions(build_library(src).with_suffix(".log")
                                 .read_text())
            for src in (fa.SOURCE, pa.SOURCE)}
    for src, fns in logs.items():
        log(f"[build] {src.name}, each kernel (registers, spill stores / "
            f"loads in bytes): " + "; ".join(
                f"{f['name']} {f['registers']}, {f['spill_stores']} / "
                f"{f['spill_loads']}" for f in fns))
    # The tensor-core flash kernel at the served models' head dims (64:
    # whisper; 128: mistral, mixtral; 256: recurrentgemma, paligemma): each
    # must be in the log, and none may spill.
    tc = {f["name"]: f for f in logs[fa.SOURCE]
          if f["name"] in ("tc<64>", "tc<128>", "tc<256>")
          and f["registers"] is not None}
    if len(tc) != 3:
        raise AssertionError(f"ptxas's log of {fa.SOURCE.name} does not "
                             f"report tc<64>, tc<128> and tc<256>: "
                             f"{sorted(tc)}")
    spilled = [n for n, f in tc.items()
               if f["spill_stores"] + f["spill_loads"]]
    if spilled:
        raise AssertionError(f"the tensor-core flash kernel spills: "
                             f"{spilled}")
    # The paged kernel's int8 instantiations (phase 16) must be built.
    int8 = sorted(f["name"] for f in logs[pa.SOURCE]
                  if f["name"].startswith("paged<int8"))
    if int8 != ["paged<int8, 1>", "paged<int8, 4>"]:
        raise AssertionError(f"ptxas's log of {pa.SOURCE.name} lacks the "
                             f"int8 kernels: {int8}")
    # The RG-LRU kernels' special-function instructions (RGLRU_MUFU): a
    # thread's gate loop takes 2 channels x 16 steps, and the scan kernel
    # holds two copies of it (sub-chunks inside the sequence, and a ragged
    # tail), 64 elements.
    for fn in sass_mufu(build_library(rs.SOURCE)):
        n = sum(fn["mufu"].values())
        per = (f"; over its two copies of a thread's 32-element gate loop "
               f"{n / 64:.3f} an element (RGLRU_MUFU = {RGLRU_MUFU})"
               if "chunk_kernel" in fn["name"] else "")
        log(f"[build] {rs.SOURCE.name} SASS {fn['name']}: {n} MUFU "
            f"{fn['mufu']}{per}")


def ptxas_functions(text: str) -> list:
    """Each kernel of a ``ptxas -v`` log: a short name (``tc<HD>`` and
    ``f32<HD>`` for flash attention's two paths, ``paged<type, GT>`` with
    type bf16, f32 or int8),
    its registers and its spill stores and loads in bytes."""
    import re
    fns, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            for pat, fmt in ((r"2tc6kernelILi(\d+)E", "tc<{}>"),
                             (r"3f326kernelILi(\d+)E", "f32<{}>"),
                             (r"paged_attention_kernelI(\w+?)Li(\d+)E",
                              "paged<{}, {}>")):
                hit = re.search(pat, name)
                if hit:
                    name = fmt.format(*(("bf16" if "bfloat16" in g else
                                         "f32" if g == "f" else
                                         "int8" if g == "a" else g)
                                        for g in hit.groups()))
                    break
            cur = dict(name=name, registers=None, spill_stores=0,
                       spill_loads=0)
            fns.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int,
                                                              m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
    return fns


def phase_probes() -> dict:
    """The card's L2 and shared-memory read rates, for the bound's
    state-bytes terms."""
    from repro_torch.kernels import probe
    rates = dict(l2=probe.l2_read_rate("cuda"),
                 smem=probe.smem_read_rate("cuda"))
    log(f"[probes] L2 read rate {rates['l2'] / 1e12:.3f} TB/s "
        f"(l2_read_probe), shared-memory read rate "
        f"{rates['smem'] / 1e12:.3f} TB/s (smem_read_probe); CUDA events")
    return rates


def _rows(L: int, n_windows: int):
    """Four stream rows of ``L`` requests (IRM, Poisson/IRM mix, two
    interleaved strided streams, IRM), with a padded tail."""
    from repro_torch.core.traffic import TrafficSpec, make_stream
    from repro_torch.storage.tiered_store import stream_window_ids
    specs = [TrafficSpec(kind="irm", n_requests=L, n_pages=4096,
                         write_fraction=0.3, seed=1),
             TrafficSpec(kind="mixed", n_requests=L, n_pages=2048,
                         write_fraction=0.3, seed=2),
             TrafficSpec(kind="strided", n_requests=L, n_pages=8192,
                         stride=3, n_streams=2, write_fraction=0.3, seed=3),
             TrafficSpec(kind="irm", n_requests=L, n_pages=1024,
                         write_fraction=0.5, seed=4)]
    pages, writes = zip(*(make_stream(s) for s in specs))
    win = np.tile(stream_window_ids(L, n_windows), (len(specs), 1))
    win[:, L - 96:] = n_windows  # trailing pads drop out of every window
    return np.stack(pages), np.stack(writes), win


def phase_kernel_vs_plain(rates: dict) -> None:
    """Kernel vs plain version on the card, every policy x prefetch, on 4
    rows of 4,096 requests over 512 lines: each row fills its lines and
    evicts under every pair (the Poisson/IRM row meets its 513th distinct
    page at request 3,829, so shorter rows would not evict)."""
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.storage.tiered_store import StoreConfig
    B, L, N, W = 4, 4096, 512, 8
    dev = torch.device("cuda")
    rows = _rows(L, W)
    pages, writes, win = (torch.as_tensor(x, device=dev) for x in rows)
    keys = cs.cold_keys(9, B, dev)
    for policy in ("ws", "lru", "lfu", "random"):
        for prefetch in (False, True):
            cfg = StoreConfig(n_lines=N, policy=policy, prefetch=prefetch)
            hyper = cfg.hyper(device=dev)
            args = (cfg, hyper, keys, pages, writes, win)
            cs.cache_scan_cuda(*args, n_windows=W)  # warm-up
            k_ms, out = cuda_ms(lambda: cs.cache_scan_cuda(
                *args, n_windows=W), reps=3)
            p_ms, want = cuda_ms(lambda: cs.cache_scan_plain(
                *args, n_windows=W))
            compare(out, want, f"policy={policy} prefetch={prefetch}")
            if not (out["evictions"] > 0).all():
                raise AssertionError(f"policy={policy} prefetch={prefetch}: "
                                     "a row never evicts")
            b = cache_scan_bound(policy, out, rows[0], cfg, W, rates)
            check_over_bound(f"policy={policy} prefetch={prefetch}", k_ms,
                             b["bound_ms"])
            log(f"[kernel vs plain] policy={policy} prefetch={prefetch}: "
                f"equal (tolerance 0: integers exact, f32 bit for bit); "
                f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms, "
                f"{fmt_bound(b)}; evictions {out['evictions'].tolist()}")


def worked_example_spec():
    from repro_torch.core.traffic import TrafficSpec
    from repro_torch.sim import RateSpec, SimSpec
    from repro_torch.storage.tiered_store import StoreConfig
    return SimSpec(
        traffic=TrafficSpec(kind="irm", n_requests=4000, n_pages=1024,
                            write_fraction=0.3, seed=7),
        store=StoreConfig(n_lines=128, policy="ws"),
        n_shards=4, lam=100.0, k_servers=1,
        rates=RateSpec(source="paper"), p12_override=0.2)


def phase_worked_example() -> int:
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.sim import simulate
    spec = worked_example_spec()
    cs.reset_cache_scan_launch_count()
    t0 = time.perf_counter()
    rep = simulate(spec, device="cuda")
    dt = time.perf_counter() - t0
    launches = cs.cache_scan_launch_count()
    if launches < 1:
        raise AssertionError("the §V run launched no cache-scan kernel")
    err = abs(rep.lam_eff - PUBLISHED_LAM_EFF) / PUBLISHED_LAM_EFF
    if not err < 0.01:
        raise AssertionError(f"lam_eff={rep.lam_eff} off 86.6 by {err:.2%}")
    cpu = simulate(spec, device="cpu")
    same = (json.dumps(rep.to_dict(), sort_keys=True)
            == json.dumps(cpu.to_dict(), sort_keys=True))
    if not same:
        raise AssertionError("§V report on cuda != report on cpu")
    log(f"[§V example] lam_eff={rep.lam_eff} (rel err {err:.2e}), "
        f"rho1={rep.rho1}, rho2={rep.rho2}, miss_rate={rep.miss_rate}; "
        f"to_dict identical to the cpu run; {dt:.2f} s, {launches} launch")
    return launches


def full_size_spec():
    from repro_torch.core.traffic import TrafficSpec
    from repro_torch.sim import SimSpec
    from repro_torch.storage.tiered_store import StoreConfig
    return SimSpec(
        traffic=TrafficSpec(kind="irm", n_requests=2**22, n_pages=2**22,
                            write_fraction=0.3, seed=7),
        store=StoreConfig(n_lines=16384, policy="ws"),
        n_shards=16, mapping="random", n_windows=32, lam=200.0)


def phase_full_size(rates: dict) -> dict:
    """The paper's many-core deployment: 16 processes, one 16,384-line
    tier-1 cache each, 2^22 IRM requests, through the two entry points
    ``simulate`` composes."""
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.sim import report_from_counters, tier1_counters
    from repro_torch.sim.engine import (
        _assemble_counters, fault_owner, stream_for_spec)
    from repro_torch.storage.tiered_store import (
        StreamStats, correct_padded_stats, init_stream_carry,
        partition_streams, stream_window_ids, tree_map)
    spec = full_size_spec()
    cfg = spec.store
    t0 = time.perf_counter()
    pages, is_write, times, n_pages, W, _ = stream_for_spec(spec)
    gen_s = time.perf_counter() - t0

    cs.reset_cache_scan_launch_count()
    t1 = time.perf_counter()
    ctr = tier1_counters(spec, device="cuda")
    t2 = time.perf_counter()
    rep = report_from_counters(spec, ctr)
    t3 = time.perf_counter()
    launches = cs.cache_scan_launch_count()
    if launches < 1:
        raise AssertionError("the full-size run launched no kernel")

    if not (ctr.evictions > 0).all():
        raise AssertionError(f"a shard never evicted: {ctr.evictions}")
    if not (ctr.hits + ctr.misses == ctr.requests).all():
        raise AssertionError("hits + misses != requests")
    for f in ("requests", "hits", "misses", "prefetch_hits", "tier2_reads",
              "tier2_writes", "evictions"):
        if not (getattr(ctr, "win_" + f).sum(-1) == getattr(ctr, f)).all():
            raise AssertionError(f"windowed {f} do not sum to the total")
    if not np.isfinite(rep.response_s) or rep.requests != 2**22:
        raise AssertionError("full-size report is not finite / complete")

    # The kernel alone at the main path's shapes, timed with CUDA events;
    # it must reproduce the main path's counters.
    owner = fault_owner(spec, pages, times, n_pages)
    sh_pages, sh_writes, counts, _, sh_win = partition_streams(
        pages, is_write, n_shards=spec.n_shards, n_pages=n_pages,
        n_windows=W, owner=owner)
    dev = torch.device("cuda")
    B, L = sh_pages.shape
    args = (cfg, cfg.hyper(device=dev), cs.cold_keys(0, B, dev),
            *(torch.as_tensor(x, device=dev)
              for x in (sh_pages, sh_writes, sh_win)))
    k_ms, out = cuda_ms(lambda: cs.cache_scan_cuda(*args, n_windows=W))
    stats = StreamStats(requests=torch.full((B,), L, device=dev), **out)
    writes = np.bincount(owner[is_write], minlength=spec.n_shards)
    again = _assemble_counters(correct_padded_stats(stats, counts, L),
                               counts, writes)
    for f in ctr._fields:
        if not np.array_equal(getattr(again, f), getattr(ctr, f)):
            raise AssertionError(f"timed re-run differs in {f}")
    main_b = cache_scan_bound("ws", out, sh_pages, cfg, W, rates)
    log(f"[full size] {spec.n_shards} shards x {L} padded requests "
        f"(loads {int(counts.min())}..{int(counts.max())}), "
        f"n_lines={cfg.n_lines}: stream generation {gen_s:.2f} s, "
        f"tier-1 stage {t2 - t1:.2f} s (generation, mapping, partition, "
        f"kernel), report {t3 - t2:.3f} s; kernel {k_ms:.1f} ms (CUDA "
        f"events), {fmt_bound(main_b)}; {launches} launch; "
        f"miss_rate={rep.miss_rate:.4f}, evictions/shard "
        f"{int(ctr.evictions.min())}..{int(ctr.evictions.max())}, "
        f"response_s={rep.response_s:.6g}")

    # Kernel against the plain version at the main path's widths (16 rows,
    # 16,384 lines, 32 windows), in the masked mode from a carried state:
    # the kernel takes each row's first WINDOW_START requests from a cold
    # carry, then the kernel and the plain version each take the next
    # WINDOW from that carry, every carry leaf compared. The caches fill
    # and begin to evict inside the window.
    S0, P = WINDOW_START, WINDOW
    ids = stream_window_ids(S0 + P, W)

    def cut(lo, hi):
        return (args[3][:, lo:hi].contiguous(), args[4][:, lo:hi].contiguous(),
                torch.as_tensor(np.tile(ids[lo:hi], (B, 1)), device=dev))
    hyper = cs.per_row(cfg.hyper(), B, dev)
    carry = cs.masked_cache_scan_cuda(
        cfg, hyper, *init_stream_carry(cfg, B, n_windows=W, device=dev),
        *cut(0, S0), n_windows=W)
    win = cut(S0, S0 + P)
    mine = tree_map(torch.clone, carry)
    pk_ms, (ks, ka) = cuda_ms(lambda: cs.masked_cache_scan_cuda(
        cfg, hyper, *mine, *win, n_windows=W))
    pp_ms, (ps, pa_) = cuda_ms(lambda: cs.masked_cache_scan_plain(
        cfg, hyper, *carry, *win, n_windows=W))
    err = 0.0
    for i, (x, y) in enumerate(zip(cs.carry_leaves(ks, ka),
                                   cs.carry_leaves(ps, pa_))):
        same = (torch.equal(x.view(torch.int32), y.view(torch.int32))
                if y.dtype == torch.float32 else torch.equal(x, y))
        if not same:
            raise AssertionError(f"full-size rows, masked window: kernel != "
                                 f"plain in carry leaf {i}")
        err = max(err, float((x.double() - y.double()).abs().max()))
    fill0 = carry[0].cache.valid.sum(1)
    fill1 = ks.cache.valid.sum(1)
    ev = ka.evictions - carry[1].evictions
    if not ((fill0 < cfg.n_lines).all() and (fill1 == cfg.n_lines).all()
            and (ev > 0).all()):
        raise AssertionError(
            f"the window does not hold every row's fill and first "
            f"evictions: filled lines {fill0.tolist()} -> {fill1.tolist()}, "
            f"evictions {ev.tolist()}")
    pre_b = cache_scan_bound(
        "ws", dict(evictions=ev, misses=ka.misses - carry[1].misses),
        sh_pages[:, :S0 + P], cfg, W, rates, start=S0)
    log(f"[full size, kernel vs plain] {B} rows x requests {S0}..{S0 + P - 1}"
        f" in the masked mode, from the carry the kernel left after the "
        f"first {S0}: n_lines={cfg.n_lines}, {W} windows, ws; filled lines "
        f"at the window's start {int(fill0.min())}..{int(fill0.max())}, at "
        f"its end {int(fill1.min())}..{int(fill1.max())}; every carry leaf "
        f"equal (tolerance 0: integers exact, f32 bit for bit, the key); "
        f"kernel {pk_ms:.1f} ms, plain {pp_ms:.1f} ms, {fmt_bound(pre_b)}; "
        f"evictions/row in the window {int(ev.min())}..{int(ev.max())}")
    del mine, ks, ka, ps, pa_, carry
    return dict(counters=ctr, report=rep, rows=sh_pages, launches=launches,
                ms=pk_ms, plain_ms=pp_ms, main_tier1_stage_s=t2 - t1,
                max_abs_err=err, **pre_b,
                shape=f"{B}x{P} (requests {S0}..{S0 + P - 1} of the main "
                      f"path's rows, masked mode from the carried state), "
                      f"n_lines={cfg.n_lines}, n_windows={W}, ws",
                main_ms=k_ms, main_bound_ms=main_b["bound_ms"],
                main_bound_by=main_b["bound_by"],
                main_bound_terms=main_b["bound_terms"],
                main_bound_terms_block_barrier=main_b[
                    "bound_terms_block_barrier"],
                main_plan=main_b["plan"],
                main_shape=f"{B}x{L} rows, n_lines={cfg.n_lines}, "
                           f"n_windows={W}, ws")


def reset_launch_counts() -> None:
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.kernels import reuse_distance as rd
    cs.reset_cache_scan_launch_count()
    rd.reset_reuse_compile_count()


def launch_counts() -> dict:
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.kernels import reuse_distance as rd
    return dict(cache_scan=cs.cache_scan_launch_count(),
                reuse_distance=rd.reuse_compile_count())


def phase_reuse_vs_plain() -> None:
    """Kernel 2 against its plain version at small shapes: rows of several
    lengths, a row of first accesses only, a row of pads only, ragged pads;
    then general rows (prev not a previous-occurrence array, valid not a
    prefix)."""
    from repro_torch.kernels import reuse_distance as rd
    from repro_torch.kernels.ref import reuse_distance_ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    for S, L, n_pages in ((2, 256, 40), (1, 1, 1), (3, 1000, 97),
                          (4, 4097, 600), (16, 3001, 300), (2, 70001, 9000)):
        pages = rng.integers(0, n_pages, (S, L)).astype(np.int32)
        counts = rng.integers(0, L + 1, S)
        counts[0] = L
        pages[0] = np.arange(L)            # first accesses only
        if S > 2:
            counts[1] = 0                  # pads only
        prev, valid = rd.prev_occurrence(pages, counts)
        p = torch.as_tensor(prev, device=dev)
        v = torch.as_tensor(valid, device=dev)
        got = rd.reuse_distance_cuda(p, v)
        torch.cuda.synchronize()
        want = reuse_distance_ref(p, v)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(
                f"reuse kernel != plain at S={S} L={L}: {bad} positions")
        log(f"[reuse kernel vs plain] S={S} L={L}: equal in every integer "
            f"(tolerance 0); first accesses {int((prev < 0).sum())}, pads "
            f"{int((~valid).sum())}")
    # General rows: prev anywhere in [-1, L + 3) (a few across the whole
    # int32 range), pads inside the rows; around the kernel's 2,048-position
    # tile and past several of its merge levels.
    for S, L in ((3, 2049), (2, 70001)):
        prev = rng.integers(-1, L + 3, (S, L)).astype(np.int64)
        far = rng.random((S, L)) < 0.05
        prev[far] = rng.integers(np.iinfo(np.int32).min,
                                 np.iinfo(np.int32).max, int(far.sum()))
        valid = rng.random((S, L)) < 0.8
        p = torch.as_tensor(prev.astype(np.int32), device=dev)
        v = torch.as_tensor(valid, device=dev)
        got = rd.reuse_distance_cuda(p, v)
        torch.cuda.synchronize()
        if not torch.equal(got, reuse_distance_ref(p, v)):
            raise AssertionError(f"reuse kernel != plain on general rows at "
                                 f"S={S} L={L}: "
                                 f"{int((got != reuse_distance_ref(p, v)).sum())}"
                                 " positions")
        log(f"[reuse kernel vs plain] general rows S={S} L={L} (prev not a "
            f"previous-occurrence array, valid not a prefix): equal in every "
            f"integer (tolerance 0)")


def phase_mixed_knobs(rates: dict) -> None:
    """Kernel 1 with its own policy and beta on each of 8 rows in one
    launch, against the plain version on the same rows."""
    from repro_torch.core.traffic import TrafficSpec, make_stream
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.storage.tiered_store import (
        POLICY_TO_IDX, StoreConfig, StoreHyper, stream_window_ids)
    B, L, N, W = 8, 4096, 512, 8
    dev = torch.device("cuda")
    streams = [make_stream(TrafficSpec(
        kind="irm", n_requests=L, n_pages=2048 << (b % 3),
        write_fraction=0.3, seed=20 + b)) for b in range(B)]
    pages = np.stack([p for p, _ in streams])
    win = np.tile(stream_window_ids(L, W), (B, 1))
    win[:, L - 64:] = W
    policies = ["ws", "lru", "lfu", "random"] * 2
    betas = [0.5, 0.7, 0.9, 0.7, 0.9, 0.5, 0.7, 0.9]
    hyper = StoreHyper(
        alpha=torch.full((B,), 0.5, device=dev),
        beta=torch.tensor(betas, dtype=torch.float32, device=dev),
        threshold=torch.full((B,), 0.25, device=dev),
        policy_idx=torch.tensor([POLICY_TO_IDX[p] for p in policies],
                                dtype=torch.int32, device=dev))
    cfg = StoreConfig(n_lines=N).static_config()
    args = (cfg, hyper, cs.cold_keys(0, B, dev),
            torch.as_tensor(pages, device=dev),
            torch.as_tensor(np.stack([w for _, w in streams]), device=dev),
            torch.as_tensor(win, device=dev))
    cs.cache_scan_cuda(*args, n_windows=W)  # warm-up
    k_ms, out = cuda_ms(lambda: cs.cache_scan_cuda(*args, n_windows=W),
                        reps=3)
    p_ms, want = cuda_ms(lambda: cs.cache_scan_plain(*args, n_windows=W))
    compare(out, want, "8 rows, mixed policy and beta")
    if not (out["evictions"] > 0).all():
        raise AssertionError("a mixed-knob row never evicted")
    b = cache_scan_bound(policies, out, pages, cfg, W, rates)
    check_over_bound("mixed knobs", k_ms, b["bound_ms"])
    log(f"[mixed knobs] {B} rows x {L} requests, n_lines={N}, {W} windows, "
        f"policies {policies}, betas {betas}, one launch: equal (tolerance "
        f"0: integers exact, f32 bit for bit); kernel {k_ms:.3f} ms, plain "
        f"{p_ms:.1f} ms, {fmt_bound(b)}; evictions "
        f"{out['evictions'].tolist()}")


def mrc_sizes() -> list:
    """64 distinct cache sizes, geometric from 2^8 to 2^18, the one
    nearest 16,384 set to it."""
    sizes = np.round(2.0 ** np.linspace(8, 18, 64)).astype(np.int64)
    sizes[np.argmin(np.abs(sizes - 16384))] = 16384
    if len(set(sizes.tolist())) != 64:
        raise AssertionError("MRC sizes are not distinct")
    return sizes.tolist()


def phase_mrc(spec) -> dict:
    """The MRC route at full width: the full-size deployment under LRU in
    one window, 64 cache sizes from one reuse-distance pass."""
    from repro_torch.kernels import reuse_distance as rd
    from repro_torch.kernels.ref import reuse_distance_ref
    from repro_torch.sim import sweep, tier1_counters
    from repro_torch.sim.engine import fault_owner, stream_for_spec
    from repro_torch.sim.mrc import _bucket_cap
    from repro_torch.storage.tiered_store import partition_streams
    sizes = mrc_sizes()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = sweep(spec, {"store.n_lines": sizes}, mrc="require", stream="off",
                profile=True, device="cuda")
    sweep_s = time.perf_counter() - t0
    launches = launch_counts()
    if launches != dict(cache_scan=0, reuse_distance=1):
        raise AssertionError(f"MRC sweep launched {launches}, want no "
                             "cache-scan launch and one reuse launch")
    for pt, rep in zip(res.points, res.reports):
        if not (np.isfinite(rep.response_s) and rep.requests == 2**22):
            raise AssertionError(f"MRC report {pt} not finite / complete")
    rep16 = res.reports[sizes.index(16384)]
    check_report(rep16, tier1_counters(
        spec.replace(**{"store.n_lines": 16384}), device="cuda"),
        "MRC sweep at 16,384 lines")

    # The pass's stages again, one by one, on the same inputs: their times,
    # and the distance array the plain version is held against.
    t0 = time.perf_counter()
    pages, is_write, times, n_pages, W, _ = stream_for_spec(spec)
    owner = fault_owner(spec, pages, times, n_pages)
    t1 = time.perf_counter()
    sh_pages, _, counts, _, _ = partition_streams(
        pages, is_write, n_shards=spec.n_shards, mapping=spec.mapping,
        n_pages=n_pages, n_windows=W, owner=owner)
    t2 = time.perf_counter()
    capb = _bucket_cap(sh_pages.shape[1])
    sh_pages = np.pad(sh_pages, ((0, 0), (0, capb - sh_pages.shape[1])))
    prev, valid = rd.prev_occurrence(sh_pages, counts)
    t3 = time.perf_counter()
    dev = torch.device("cuda")
    p = torch.as_tensor(prev, device=dev)
    v = torch.as_tensor(valid, device=dev)
    rd.reuse_distance_cuda(p, v).cpu()
    t4 = time.perf_counter()
    stages = dict(stream=t1 - t0, partition=t2 - t1,
                  prev_occurrence=t3 - t2, distance=t4 - t3)
    # The sweep's MRC route is its engine stage; what the stages above do
    # not cover is the host histogram and write-back intervals.
    stages["histogram"] = res.profile["engine_dispatch"] - sum(
        stages.values())
    k_ms, got_d = cuda_ms(lambda: rd.reuse_distance_cuda(p, v), reps=3)
    # The plain O(L^2) count on the first MRC_PLAIN_ROWS rows (distances
    # never cross rows).
    n_plain = MRC_PLAIN_ROWS
    p_ms, want_d = cuda_ms(lambda: reuse_distance_ref(p[:n_plain],
                                                      v[:n_plain]))
    if not torch.equal(got_d[:n_plain], want_d):
        raise AssertionError(
            f"reuse kernel != plain on rows 0..{n_plain - 1} of the full "
            f"[{p.shape[0]}, {capb}] array: "
            f"{int((got_d[:n_plain] != want_d).sum())} positions")
    b = reuse_bound(prev, valid)
    S, L = prev.shape
    log(f"[MRC route] {spec.n_shards} shards x {L} (bucket; loads "
        f"{int(counts.min())}..{int(counts.max())}), {len(sizes)} sizes "
        f"{sizes[0]}..{sizes[-1]}: sweep {sweep_s:.2f} s (MRC pass "
        f"{res.profile['engine_dispatch']:.2f} s, reports "
        f"{res.profile['report_solve']:.3f} s), launches {launches}; "
        f"counters at 16,384 lines equal the cache-scan kernel's in every "
        f"field; stages timed alone: stream {stages['stream']:.2f} s, "
        f"partition {stages['partition']:.2f} s, prev_occurrence "
        f"{stages['prev_occurrence']:.2f} s, distance pass (copies "
        f"included) {stages['distance']:.3f} s, histogram (the MRC pass "
        f"less those) {stages['histogram']:.2f} s; kernel {k_ms:.2f} ms "
        f"(CUDA events) on the whole [{S}, {L}] array, plain {p_ms:.1f} ms "
        f"on its first {n_plain} rows, equal there (tolerance 0); "
        f"{fmt_bound(b)}; {b['sort_compares']} "
        f"compares of an O(n log n) count, {b['compares']} of the direct "
        f"count; "
        f"miss rate at 16,384 lines {rep16.miss_rate:.6f}")
    return dict(launches=launches["reuse_distance"], max_abs_err=0.0,
                ms=k_ms, plain_ms=p_ms, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], bound_terms=b["bound_terms"],
                bound_terms_direct_count=b["bound_terms_direct_count"],
                sort_compares=b["sort_compares"], compares=b["compares"],
                shape=f"{S}x{L} (the MRC route's rows, full size, lru)",
                plain_shape=f"{n_plain}x{L} (the first {n_plain} rows)")


def phase_megabatch(full_ctr, rates: dict) -> dict:
    """The sweep's megabatch at full width: 4 policies x 2 betas (8 cache
    signatures) x 2 rates, one 2^19 bucket, one launch of 128 rows; then
    that launch's rows against the plain version on their first
    MEGA_PREFIX steps."""
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.sim import sweep
    from repro_torch.storage.tiered_store import POLICY_TO_IDX
    spec = full_size_spec()
    axes = {"store.policy": ["ws", "lru", "lfu", "random"],
            "store.beta": [0.5, 0.7], "lam": [100.0, 200.0]}
    timed = []
    launch = cs.cache_scan_cuda

    def timed_launch(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kw)
        stop.record()
        timed.append((start, stop, args, kw, out))
        return out

    reset_launch_counts()
    cs.cache_scan_cuda = timed_launch
    try:
        t0 = time.perf_counter()
        res = sweep(spec, axes, stream="off", profile=True, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        cs.cache_scan_cuda = launch
    launches = launch_counts()
    if launches != dict(cache_scan=1, reuse_distance=0):
        raise AssertionError(f"megabatch sweep launched {launches}, want "
                             "one cache-scan launch and no reuse launch")
    (start, stop, args, kw, out), = timed
    k_ms = start.elapsed_time(stop)
    for pt, rep in zip(res.points, res.reports):
        vals = (rep.response_s, rep.lam_eff, rep.rho1, rep.rho2,
                rep.miss_rate)
        if not all(np.isfinite(x) for x in vals):
            raise AssertionError(f"report {pt} is not finite: {vals}")
    i = res.points.index({"store.policy": "ws", "store.beta": 0.7,
                          "lam": 200.0})
    check_report(res.reports[i], full_ctr, "(ws, 0.7) sweep point")

    cfg, hyper, keys, pages, writes, win = args
    B, L = pages.shape
    name = {v: k for k, v in POLICY_TO_IDX.items()}
    policies = [name[i] for i in hyper.policy_idx.tolist()]
    knobs = set(zip(policies, hyper.beta.tolist()))
    if len(knobs) != 8:
        raise AssertionError(f"the launch's rows carry {len(knobs)} "
                             "(policy, beta) pairs, want 8")
    W = kw["n_windows"]
    mega_b = cache_scan_bound(policies, out, pages.cpu().numpy(), cfg, W,
                              rates)

    # The launch's rows against the plain version on their first
    # MEGA_PREFIX steps, with their own knobs, keys and window ids.
    P = MEGA_PREFIX
    pre = (cfg, hyper, keys, *(x[:, :P].contiguous()
                               for x in (pages, writes, win)))
    pk_ms, pout = cuda_ms(lambda: cs.cache_scan_cuda(*pre, **kw))
    pp_ms, want = cuda_ms(lambda: cs.cache_scan_plain(*pre, **kw))
    err = compare(pout, want, f"megabatch rows, first {P} steps")
    pre_b = cache_scan_bound(policies, pout, pages[:, :P].cpu().numpy(),
                             cfg, W, rates)
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in res.profile.items()
                       if isinstance(v, float))
    log(f"[megabatch] {len(res.points)} points, 8 cache signatures, one "
        f"launch of {B} rows x {L} steps (n_lines={cfg.n_lines}, {W} "
        f"windows): kernel {k_ms:.1f} ms (CUDA events), {fmt_bound(mega_b)}; "
        f"sweep {wall:.2f} s; profile: {stages}; (ws, 0.7) counters equal "
        f"phase 5's tier1_counters; every report finite; launches "
        f"{launches}")
    log(f"[megabatch, kernel vs plain] the launch's {B} rows (policies x "
        f"betas {sorted(knobs)}), first {P} steps, n_lines={cfg.n_lines}, "
        f"{W} windows: equal (tolerance 0: integers exact, f32 bit for "
        f"bit); kernel {pk_ms:.1f} ms, plain {pp_ms:.1f} ms, "
        f"{fmt_bound(pre_b)}; misses/row "
        f"{int(pout['misses'].min())}..{int(pout['misses'].max())}, "
        f"evictions/row "
        f"{int(pout['evictions'].min())}..{int(pout['evictions'].max())}")
    return dict(sweep_launches=launches["cache_scan"], sweep_ms=k_ms,
                sweep_bound_ms=mega_b["bound_ms"],
                sweep_bound_by=mega_b["bound_by"],
                sweep_bound_terms=mega_b["bound_terms"],
                sweep_bound_terms_block_barrier=mega_b[
                    "bound_terms_block_barrier"],
                sweep_plan=mega_b["plan"],
                sweep_shape=f"{B}x{L} rows (16 points, 8 signatures, mixed "
                            f"policy and beta), n_lines={cfg.n_lines}, "
                            f"n_windows={W}",
                sweep_prefix_ms=pk_ms, sweep_prefix_plain_ms=pp_ms,
                sweep_prefix_max_abs_err=err,
                sweep_prefix_bound_ms=pre_b["bound_ms"],
                sweep_prefix_bound_by=pre_b["bound_by"],
                sweep_prefix_bound_terms=pre_b["bound_terms"],
                sweep_prefix_shape=f"{B}x{P} (first {P} steps of the "
                                   f"megabatch rows)")


def _rel_err(got, want) -> float:
    """Largest absolute difference over the largest magnitude of ``want``."""
    den = float(want.double().abs().max().clamp(min=1e-30))
    return float((got.double() - want.double()).abs().max()) / den


def _bf16_step_excess(got, want) -> float:
    """Largest ``|got - want| / (FLASH_ULP |want| + FLASH_ABS)``, element
    by element: at most 1 passes."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (FLASH_ULP * w.abs() + FLASH_ABS)).max())


def _with_hidden(run_fn):
    """``run_fn()`` (a serve) with the final hidden state that each step
    unembeds recorded: ``(result, f32 [steps, B, d])``."""
    from repro_torch.serving import engine as eng
    hidden = []
    unembed0 = eng.unembed_greedy

    def hook(x, w, *a):
        hidden.append(x.float())
        return unembed0(x, w, *a)
    eng.unembed_greedy = hook
    try:
        res = run_fn()
    finally:
        eng.unembed_greedy = unembed0
    return res, torch.stack(hidden)


def _hidden_err(h, ref, q=None) -> float:
    """Largest ``|h - ref| / |ref|`` of one sequence's hidden state at one
    step, over the steps both runs made (with ``q``, its ``q``-quantile
    over those steps and sequences)."""
    n = min(len(h), len(ref))
    e = (h[:n] - ref[:n]).norm(dim=-1) / ref[:n].norm(dim=-1)
    return float(e.max() if q is None else torch.quantile(e.flatten(), q))


def _lp_err(lp, ref, q=None) -> float:
    """Largest ``|lp - ref|`` of the logprobs over the steps both runs made
    (with ``q``, its ``q``-quantile)."""
    n = min(lp.shape[1], ref.shape[1])
    e = np.abs(lp[:, :n] - ref[:, :n])
    return float(e.max() if q is None else np.quantile(e, q))


def _visible_pairs(Sq: int, Skv: int, causal: bool = True, window=None,
                   prefix_len: int = 0) -> int:
    """(query, key) pairs the mask lets through, for one head: all of
    them without ``causal``; else key j for query i where i - window < j
    <= i, or j < prefix_len."""
    if not causal:
        return Sq * Skv
    w = window or Skv
    return sum(min(i + 1, w) + max(0, min(prefix_len, i + 1 - w))
               + max(0, prefix_len - (i + 1)) for i in range(Sq))


def _flash_bound(q, k, window=None, causal=True, prefix_len=0) -> dict:
    """GQA attention on q ``[B, H, Sq, hd]``, k ``[B, KV, Skv, hd]``: 4
    flops a visible (query, key) pair and head dim (QK^T and PV) at the
    bf16 tensor-core rate; q, k, v read once and the output written once
    at HBM's rate."""
    B, H, S, hd = q.shape
    pairs = _visible_pairs(S, k.shape[2], causal, window, prefix_len)
    flops = 4 * B * H * pairs * hd
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return dict(_largest(dict(bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                              ops_ms=1e3 * flops / BF16_FLOPS_PER_S)),
                flops=flops, bytes=nbytes)


def _paged_bound(calls, page: int) -> dict:
    """Decode attention over both tiers of one layer: every live K and V
    row of the owned pages read once (each page from one tier; inside the
    sliding window where there is one), with an int8 pool its two f32
    scales a token, q read and the partials written, at HBM's rate; 4
    flops a live token, head dim and query head, and with an int8 pool 3
    a K or V element read (convert, scale, round to bf16), at the f32 rate
    of the data sheet (67 TFLOP/s)."""
    nbytes = flops = 0
    for q, pool, slot, live, window, *scale in calls:
        B, H, hd = q.shape
        KV = pool.shape[3]
        tok = torch.arange(slot.shape[1] * page, device=slot.device)
        n_live = live.to(slot.device)[:, None]
        on = (slot >= 0).repeat_interleave(page, 1) & (tok[None] < n_live)
        if window > 0:
            on &= tok[None] >= n_live - window
        n = int(on.sum())
        quant = bool(scale) and scale[0] is not None
        nbytes += n * (2 * KV * hd * pool.element_size() + 8 * quant) \
            + 4 * q.numel() + 4 * (B * H * hd + 2 * B * H)
        flops += 4 * n * hd * H + 3 * n * 2 * KV * hd * quant
    return dict(_largest(dict(bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                              ops_ms=1e3 * flops / 67e12)),
                bytes=nbytes, flops=flops)


def _copy_bound(n_rows: int, row_bytes: int) -> dict:
    """Each moved byte read once and written once, at HBM's rate."""
    return dict(_largest(dict(bytes_ms=1e3 * 2 * n_rows * row_bytes
                              / HBM_BYTES_PER_S)), bytes=2 * n_rows * row_bytes)


def _view_into(buf, whole, d):
    """``d``, a view into ``whole``, as the same view into ``buf``, a copy
    of ``whole``."""
    off = (d.data_ptr() - whole.data_ptr()) // whole.element_size()
    return buf.view(-1)[off:].as_strided(d.shape, d.stride())


def check_page_copy(tag: str, cases) -> None:
    """Page copy byte for byte on the card: for each ``(name, whole, dst,
    src, di, si)`` (``dst`` a view into the pool ``whole``), the kernel and
    the plain version, each on its own copy of ``whole``."""
    from repro_torch.kernels import page_gather as pg
    from repro_torch.kernels.ref import page_copy_ref
    for name, whole, d, s_, i_d, i_s in cases:
        outs = []
        for fn in (pg.page_copy_cuda, page_copy_ref):
            buf = whole.clone()
            fn(_view_into(buf, whole, d), s_, i_d, i_s)
            torch.cuda.synchronize()
            outs.append(buf.view(torch.uint8).view(-1))
        if not torch.equal(*outs):
            raise AssertionError(f"[{tag}] page copy kernel != plain "
                                 f"({name})")
        del outs, buf


def _live_pairs(di, si) -> int:
    """The pairs of a page copy that move a row (neither index -1)."""
    return int(((di >= 0) & (si >= 0)).sum())


def cold_ms(fn, reps: int = COLD_REPS) -> float:
    """Median device time of one ``fn()`` called cold: before each call a
    buffer of ``L2_FLUSH_BYTES`` is written, which flushes the 50 MB L2,
    and each call runs between its own CUDA events. The card first spins
    while the host enqueues every call, so that no call waits for the
    host."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(reps)]
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms at 1.98 GHz
    for start, stop in events:
        flush.fill_(1)
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def page_copy_times(tag: str, whole, dst, src, di, si) -> dict:
    """Page copy's times on a captured population (``dst`` a view into the
    pool ``whole``, timed on a copy of it), under the kernels line's
    page-copy keys:

    - ``ms``: a loop of 5 wrapper calls with the index vectors on the CPU,
      as the engine's write-back and promotion pass them (their pinned
      copies to the card included), as row 4 of PERF.md was timed before,
      after 5 untimed calls: a serving engine's steady state, in which
      PyTorch's caching host allocator holds the pinned blocks;
    - ``ms_blocking``: the same loop, after the same warm-up, with the
      host range test and then two blocking copies of the index vectors
      from pageable memory to the card, as the wrapper did before it moved
      them through pinned memory; the two loops alternate, three times
      each, and each key is the median of its three;
    - ``ms_cold``: the launch alone, the indices already int32 on the
      card, cold (:func:`cold_ms`); ``library_ms_cold``: ``dst[di] =
      src[si]`` with int64 indices on the card, timed the same way;
    - ``ms_graph``: the launch alone replayed warm from a CUDA graph;
    - ``library_ms``: a loop of 5 library calls, warm; ``plain_ms``.

    Fails if a cold kernel time is under the bound."""
    from repro_torch.kernels import page_gather as pg
    from repro_torch.kernels.ref import page_copy_ref
    dev = whole.device
    buf = whole.clone()
    view = _view_into(buf, whole, dst)
    di_cpu, si_cpu = di.cpu(), si.cpu()
    live = (di_cpu >= 0) & (si_cpu >= 0)
    di_card, si_card = (x.to(dev, torch.int32) for x in (di_cpu, si_cpu))
    ldi, lsi = (x[live].long().to(dev) for x in (di_cpu, si_cpu))
    row_bytes = view[0].numel() * view.element_size()
    cb = _copy_bound(int(live.sum()), row_bytes)

    def launch():
        return pg.page_copy_cuda(view, src, di_card, si_card)

    def library():
        view[ldi] = src[lsi]

    def engine_call():
        return pg.page_copy_cuda(view, src, di_cpu, si_cpu)

    def blocking_call():
        for x in (di_cpu, si_cpu):
            int(x.min()), int(x.max())
        return pg.page_copy_cuda(view, src, di_cpu.to(dev, torch.int32),
                                 si_cpu.to(dev, torch.int32))
    loops = dict(ms=engine_call, ms_blocking=blocking_call)
    for fn in loops.values():
        cuda_ms(fn, reps=5)
    rounds = [{k: cuda_ms(fn, reps=5)[0] for k, fn in loops.items()}
              for _ in range(3)]
    out = {k: float(np.median([r[k] for r in rounds])) for k in loops}
    out["ms_cold"] = cold_ms(launch)
    out["library_ms_cold"] = cold_ms(library)
    out["library_ms"], _ = cuda_ms(library, reps=5)
    out["ms_graph"] = graph_ms(launch)
    out["plain_ms"], _ = cuda_ms(lambda: page_copy_ref(view, src, di_cpu,
                                                       si_cpu))
    check_over_bound(f"{tag} page copy ms_cold", out["ms_cold"],
                     cb["bound_ms"])
    out.update(bound_ms=cb["bound_ms"], bound_by=cb["bound_by"],
               bound_terms=cb["bound_terms"])
    log(f"[{tag}, page copy times] {int(live.sum())} pages of {row_bytes} "
        f"B: cold {out['ms_cold']:.4f} ms, dst[di] = src[si] cold "
        f"{out['library_ms_cold']:.4f} ms; from a CUDA graph "
        f"{out['ms_graph']:.4f} ms; a loop of wrapper calls with CPU "
        f"indices {out['ms']:.4f} ms (with blocking index copies "
        f"{out['ms_blocking']:.4f} ms), of dst[di] = src[si] "
        f"{out['library_ms']:.4f} ms; plain {out['plain_ms']:.3f} ms; "
        f"{fmt_bound(cb)} [{card_line()}]")
    return out


def _build_serve(S: dict, dev):
    """A serve's configuration at full width, its depth cut to
    ``S["layers"]`` where given, and random bf16 parameters from seed 0."""
    import dataclasses
    from repro_torch.configs.archs import get_config
    from repro_torch.models.params import init_params
    cfg = get_config(S["arch"])
    if S.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=S["layers"])
    return cfg, init_params(cfg, 0, dev)


def _depth(cfg, S: dict) -> str:
    from repro_torch.configs.archs import get_config
    full = get_config(S["arch"]).n_layers
    return (f"{cfg.n_layers} of {full} layers" if cfg.n_layers < full else
            f"all {full} layers")


def _profile_decode(cfg, params, run, S: dict, dev, tag: str = "serve",
                    kv_dtype: str = "auto") -> None:
    """Where a decode step's time goes: PROFILE_STEPS more steps of the
    kernel run (its pools hold pages past the last token), after one
    untraced step, under ``torch.profiler``; kernel time by group, its
    share of the run's own (untraced) step time, kernel launches and
    synchronizations a step. The profiler's own host cost makes the
    traced steps far slower, so their wall time is not the step's."""
    from repro_torch.serving import engine as eng
    page = cfg.page_size
    max_seq = S.get("max_seq") or -(-(S["prompt"] + S["new"]) // page) * page
    sc = eng.ServeConfig(max_seq=max_seq, batch_local=S["requests"],
                         hbm_fraction=S["hbm_fraction"], kv_dtype=kv_dtype)
    dec = eng.make_decode_step(cfg, sc)
    state = run.state
    tok = torch.as_tensor(run.tokens[:, -1], device=dev)
    state, (tok, _) = dec(params, state, tok)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_STEPS):
            state, (tok, _) = dec(params, state, tok)
        torch.cuda.synchronize()
    step_ms = 1e3 * run.decode_s / (S["new"] - 1)
    groups = dict(paged=0.0, gemm=0.0, other=0.0)
    kernels = syncs = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            name = e.name.lower()
            g = ("paged" if "paged_attention" in name else
                 "gemm" if any(x in name for x in ("gemm", "nvjet", "cutlass",
                                                   "sm90_xmma")) else "other")
            groups[g] += e.time_range.elapsed_us() / 1e3 / PROFILE_STEPS
        elif "Synchronize" in e.name:
            syncs += 1
    busy = sum(groups.values())
    if run.state.kv is not None and groups["paged"] <= 0:
        raise AssertionError("the profiled decode steps ran no paged kernel")
    log(f"[{tag}, profile] {PROFILE_STEPS} decode steps after the run "
        f"(torch.profiler): kernels {busy:.2f} ms a step, "
        f"{100 * busy / step_ms:.1f}% of the run's {step_ms:.2f} ms step: "
        f"paged attention {groups['paged']:.2f} ms, GEMMs "
        f"{groups['gemm']:.2f} ms, other {groups['other']:.2f} ms; "
        f"{kernels / PROFILE_STEPS:.0f} kernel launches and "
        f"{syncs / PROFILE_STEPS:.1f} synchronizations a step")


def phase_serve(dev=torch.device("cuda")) -> tuple:
    """Serving at full width through ``repro_torch.launch.serve``; returns
    the flash-attention, paged-attention and page-copy kernel entries, and
    the run's tier state (its pools dropped), logprobs and pool bytes for
    phase 16."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import page_gather as pg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain_versions
    from repro_torch.kernels.ref import attention_ref, paged_attention_ref
    from repro_torch.launch import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S = SERVE
    t0 = time.perf_counter()
    cfg, params = _build_serve(S, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = cfg.total_params()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (S["requests"], S["prompt"])).astype(np.int32)
    steps = S["new"] - 1
    L = cfg.n_layers

    # Capture kernel inputs from the run: layer 0's prefill q/k/v, the
    # last decode step's paged launches at the first and last layers, and
    # the first prefill population into tier 2.
    calls = dict(paged=0)
    cap: dict = {}
    flash0, paged0, copy0 = fa.flash_attention, pa.paged_attention, \
        pg.page_copy
    last = (steps - 1) * 2 * L

    def flash_hook(q, k, v, **kw):
        if "flash" not in cap:
            cap["flash"] = (q.clone(), k.clone(), v.clone(), kw)
        return flash0(q, k, v, **kw)

    def paged_hook(q, pool, slot, live, window=0, scale=None):
        i = calls["paged"] - last
        if i in (0, 1, 2 * L - 2, 2 * L - 1):
            cap.setdefault("paged", []).append(
                (q.clone(), pool, slot.clone(), live.clone(), window))
        calls["paged"] += 1
        return paged0(q, pool, slot, live, window, scale=scale)

    def copy_hook(dst, src, di, si):
        if "copy" not in cap:
            cap["copy"] = (dst, src.clone(), di.clone(), si.clone())
        return copy0(dst, src, di, si)

    fa.flash_attention, pa.paged_attention, pg.page_copy = \
        flash_hook, paged_hook, copy_hook
    serve.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        run, run_h = _with_hidden(lambda: serve.serve(
            cfg, params, prompts, new=S["new"],
            hbm_fraction=S["hbm_fraction"],
            promote_every=S["promote_every"]))
    finally:
        fa.flash_attention, pa.paged_attention, pg.page_copy = \
            flash0, paged0, copy0
    launches = serve.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(launches[k] for k in ("flash_attention", "paged_attention",
                                     "page_copy")) or \
            launches["ssd_scan"] or launches["rglru_scan"]:
        raise AssertionError(f"a serving kernel never launched, or a scan "
                             f"kernel did: {launches}")
    if launches["flash_attention"] != L or \
            launches["paged_attention"] != 2 * L * steps:
        raise AssertionError(f"launches {launches}, want {L} flash and "
                             f"{2 * L * steps} paged")
    kv = run.state.kv
    B = S["requests"]
    if run.tokens.shape != (B, S["new"]) or not np.isfinite(
            run.logprobs).all() or not ((run.tokens >= 0)
                                        & (run.tokens < cfg.vocab)).all():
        raise AssertionError("serve output is not finite tokens/logprobs "
                             "of the expected shape")
    if not (kv.lengths == S["prompt"] + steps).all():
        raise AssertionError(f"lengths {kv.lengths.tolist()}")
    t1, t2 = int(kv.t1_reads[0]), int(kv.t2_reads[0])
    log(f"[serve] {cfg.name} ({_depth(cfg, S)}, {n_params / 1e9:.2f} B "
        f"params, bf16, seed 0; "
        f"init {init_s:.1f} s), {B} requests x {S['prompt']} prompt tokens, "
        f"{steps} decode steps, hbm_fraction {S['hbm_fraction']}: prefill "
        f"{run.prefill_s:.3f} s, decode {run.decode_s:.3f} s "
        f"({B * steps / run.decode_s:.1f} tok/s, "
        f"{1e3 * run.decode_s / steps:.2f} ms/step); tier-1 page reads {t1}, "
        f"tier-2 {t2}, evictions {int(kv.evictions[0])}, write-backs "
        f"{int(kv.writebacks[0])}; OL weights {kv.ols.weights.tolist()}; "
        f"launches {launches}; peak memory {peak_gb:.1f} GB")

    # The whole path again with the plain versions selected, fed the
    # kernel run's tokens.
    forced = torch.as_tensor(run.tokens[:, :-1], device=dev)
    serve.reset_launch_counts()
    with plain_versions():
        plain, plain_h = _with_hidden(lambda: serve.serve(
            cfg, params, prompts, new=S["new"],
            hbm_fraction=S["hbm_fraction"], promote_every=S["promote_every"],
            forced=forced))
    if any(serve.launch_counts().values()):
        raise AssertionError("the plain run launched a kernel")
    pkv = plain.state.kv
    for f in ("page_slot", "t2_slot", "lengths", "t", "t1_reads", "t2_reads",
              "evictions", "writebacks"):
        if not torch.equal(getattr(kv, f), getattr(pkv, f)):
            raise AssertionError(f"kernel run != plain run in {f}")
    for x, y in zip(kv.meta + kv.ols, pkv.meta + pkv.ols):
        if not torch.equal(x, y):
            raise AssertionError("kernel run != plain run in the metadata "
                                 "or the learner")
    if kv.key != pkv.key or not torch.equal(
            kv.ols.weights.view(torch.int32), pkv.ols.weights.view(torch.int32)):
        raise AssertionError("kernel run != plain run in the key / weights")
    lp_err = float(np.abs(run.logprobs - plain.logprobs).max())
    h_err = _hidden_err(run_h, plain_h)
    # The noise floor: the plain path again, the first CONTROL_STEPS decode
    # steps, with only the prefill attention's summation order changed
    # (blockwise attention in 512-blocks instead of one softmax).
    from repro_torch.models.attention import blockwise_attention
    from repro_torch.serving import engine as eng
    n_ctl = min(CONTROL_STEPS, steps)
    n = n_ctl + 1
    short = dict(new=n, hbm_fraction=S["hbm_fraction"],
                 promote_every=S["promote_every"], forced=forced[:, :n_ctl],
                 max_seq=kv.page_slot.shape[1] * cfg.page_size)
    flash_plain = fa.flash_attention
    fa.flash_attention = lambda q, k, v, **kw: blockwise_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        **kw).transpose(1, 2)
    try:
        with plain_versions():
            ctl, ctl_h = _with_hidden(
                lambda: serve.serve(cfg, params, prompts, **short))
    finally:
        fa.flash_attention = flash_plain
    floor = float(np.abs(ctl.logprobs - plain.logprobs[:, :n]).max())
    head = float(np.abs(run.logprobs[:, :n] - plain.logprobs[:, :n]).max())
    h_floor = _hidden_err(ctl_h, plain_h)
    h_head = _hidden_err(run_h[:n], plain_h)
    # Planted faults through the same comparison, on the kernel path and
    # the first n_ctl steps: the tier-2 partial dropped from the merge, and
    # the tier-2 launches skipping page 0 of every sequence (a prompt page
    # that lives only in tier 2). Each must fail the bar.
    comb0, paged_k = eng.combine_partials, pa.paged_attention
    seen = dict(n=0)

    def skip_page0(q, pool, slot, live, window=0, scale=None):
        seen["n"] += 1
        if seen["n"] % 2 == 0:   # the engine launches tier 1, then tier 2
            slot = slot.clone()
            slot[:, 0] = -1
        return paged_k(q, pool, slot, live, window, scale=scale)
    faults = {}
    for name, patch in (
            ("tier-2 partial dropped",
             lambda: setattr(eng, "combine_partials",
                             lambda parts: comb0(parts[:1]))),
            ("page 0 skipped in tier 2",
             lambda: setattr(pa, "paged_attention", skip_page0))):
        patch()
        try:
            bad, bad_h = _with_hidden(
                lambda: serve.serve(cfg, params, prompts, **short))
        finally:
            eng.combine_partials, pa.paged_attention = comb0, paged_k
        faults[name] = (
            _hidden_err(bad_h, plain_h),
            float(np.abs(bad.logprobs - plain.logprobs[:, :n]).max()))
        del bad, bad_h
    log(f"[serve, plain path] the same run with the plain versions, "
        f"teacher-forced on the kernel run's tokens: prefill "
        f"{plain.prefill_s:.3f} s, decode {plain.decode_s:.3f} s; tier state "
        f"and learner equal (integers exact, f32 weights bit for bit); "
        f"final hidden state |h - h_plain| / |h_plain| largest "
        f"{h_err:.3e} over all steps, {h_head:.3e} over the first {n_ctl} "
        f"(tolerance {HIDDEN_TOL}); noise floor (plain vs plain with "
        f"blockwise prefill attention, first {n_ctl} steps) {h_floor:.3e}; "
        f"planted faults (kernel path, first {n_ctl} steps): "
        + "; ".join(f"{k} {v[0]:.3e} (logprobs {v[1]:.3e})"
                    for k, v in faults.items())
        + f"; logprobs max |diff| {lp_err:.3e} over all steps, {head:.3e} "
        f"over the first {n_ctl} (tolerance {LOGPROB_TOL}), noise floor "
        f"{floor:.3e}; greedy tokens equal in "
        f"{int((plain.tokens == run.tokens).sum())} of {run.tokens.size}")
    if not h_err <= HIDDEN_TOL:
        raise AssertionError(f"hidden states differ by {h_err} > "
                             f"{HIDDEN_TOL}")
    if not lp_err <= LOGPROB_TOL:
        raise AssertionError(f"logprobs differ by {lp_err} > {LOGPROB_TOL}")
    for name, (e, _) in faults.items():
        if not e > HIDDEN_TOL:
            raise AssertionError(f"planted fault '{name}' passes the "
                                 f"comparison: {e} <= {HIDDEN_TOL}")
    del plain, pkv, ctl, run_h, plain_h, ctl_h

    # Flash attention: layer 0's prefill q/k/v, all 8 sequences.
    q, k, v, kw = cap["flash"]
    fa.flash_attention_cuda(q, k, v, **kw)  # warm-up
    f_ms, got = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                        reps=3)
    fp_ms, want = cuda_ms(lambda: attention_ref(q, k, v, **kw))
    f_err = float((got.float() - want.float()).abs().max())
    f_rel = float(((got.float() - want.float()).abs()
                   / (want.float().abs() + 1)).max())
    f_exc = _bf16_step_excess(got, want)
    # A planted fault: the last 64-query tile of every head off by 1/32.
    bad = got.clone()
    bad[:, :, -64:] = (bad[:, :, -64:].float() * (1 + FLASH_FAULT)).to(
        bad.dtype)
    bad_exc = _bf16_step_excess(bad, want)
    bad_rel = float(((bad.float() - want.float()).abs()
                     / (want.float().abs() + 1)).max())
    del bad
    log(f"[serve, flash vs plain] max |diff| {f_err:.3e}, |diff| / (|plain| "
        f"+ 1) {f_rel:.3e} (tolerance {FLASH_TOL}), |diff| / ({FLASH_ULP:g} "
        f"|plain| + {FLASH_ABS:g}) {f_exc:.3f} (tolerance 1); planted fault "
        f"(last query tile x (1 + {FLASH_FAULT:g})): {bad_exc:.3f} and "
        f"{bad_rel:.3e}")
    if not (f_rel <= FLASH_TOL and f_exc <= 1):
        raise AssertionError(f"flash kernel != plain: {f_err} (rel {f_rel}, "
                             f"element-wise {f_exc})")
    if not bad_exc > 1:
        raise AssertionError("the flash check passes a planted fault")
    sdpa = dict(is_causal=True, enable_gqa=True)
    torch.nn.functional.scaled_dot_product_attention(q, k, v, **sdpa)
    f_lib, _ = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, **sdpa), reps=3)
    fb = _flash_bound(q, k)
    log(f"[serve, flash vs plain] layer 0's prefill, q {list(q.shape)} "
        f"(strided [B, S, H, hd] views), causal: max |diff| {f_err:.3e}, "
        f"element-wise {f_exc:.3f} of its bar; kernel "
        f"{f_ms:.3f} ms, plain {fp_ms:.1f} ms, scaled_dot_product_attention {f_lib:.3f} ms, "
        f"{fmt_bound(fb)}")
    del got, want

    # Paged attention: the last decode step's tier-1 and tier-2 launches at
    # the first and the last layer (the pools hold the state of that step:
    # nothing wrote those layers after it).
    pcalls = cap["paged"]
    p_err = 0.0
    for i, (qq, pool, slot, live, window) in enumerate(pcalls):
        got = pa.paged_attention_cuda(qq, pool, slot, live, window)
        want = paged_attention_ref(qq, pool, slot, live, window)
        for g, w, name in zip(got, want, ("acc", "m", "l")):
            e = _rel_err(g, w)
            p_err = max(p_err, e)
            if not e <= PAGED_REL_TOL:
                raise AssertionError(f"paged kernel != plain in {name} "
                                     f"(call {i}): {e}")
    first = pcalls[:2]
    p_ms, _ = cuda_ms(lambda: [pa.paged_attention_cuda(*c) for c in first],
                      reps=10)
    conv = [_paged_inputs(c) for c in first]
    p_graph = graph_ms(lambda: [pa.paged_attention_cuda(*c) for c in conv])
    pp_ms, _ = cuda_ms(lambda: [paged_attention_ref(*c) for c in first],
                       reps=3)
    pb = _paged_bound(first, cfg.page_size)
    n_split = pa.split_plan(B, cfg.n_kv_heads, kv.page_slot.shape[1],
                            cfg.page_size)
    log(f"[serve, paged vs plain] last decode step, layers 0 and {L - 1}, "
        f"tier 1 and tier 2: largest |diff| / largest |plain| of acc, m, l "
        f"{p_err:.3e} (tolerance {PAGED_REL_TOL}); layer 0, both tiers "
        f"(n_split, span {n_split}): kernel {p_ms:.4f} ms in a loop of "
        f"calls, {p_graph:.4f} ms from a CUDA graph of its launches alone, "
        f"plain {pp_ms:.3f} ms, "
        f"{fmt_bound(pb)}")

    # Page copy, byte for byte on the full-width pools: the first prefill
    # population (layer 0 into tier 2), a whole-slot write-back (tier-1
    # slots of resident pages down to their tier-2 slots) and a whole-slot
    # promotion (tier-2 pages into two tier-1 slots a hand-made state
    # frees).
    dst, src, di, si = cap["copy"]
    pool1, pool2 = kv.pool1, kv.pool2
    res = (kv.page_slot >= 0).reshape(-1).nonzero().reshape(-1)[:8]
    wb_dst = kv.t2_slot.reshape(-1)[res]
    wb_src = kv.page_slot.reshape(-1)[res]
    non = (kv.page_slot < 0).reshape(-1).nonzero().reshape(-1)[:2]
    pr_dst = kv.page_slot.reshape(-1)[res[:2]]
    pr_src = kv.t2_slot.reshape(-1)[non]
    cases = (("prefill population", pool2, dst, src, di, si),
             ("write-back", pool2, pool2, pool1, wb_dst, wb_src),
             ("promotion", pool1, pool1, pool2, pr_dst, pr_src))
    check_page_copy("serve", cases)
    copy_times = page_copy_times("serve", pool2, dst, src, di, si)
    row_bytes = dst[0].numel() * dst.element_size()
    log(f"[serve, page copy vs plain] prefill population (layer 0, "
        f"{_live_pairs(di, si)} pages of {row_bytes} B into tier 2), a "
        f"whole-slot write-back ({len(res)} slots of "
        f"{pool1[0].numel() * 2} B) and a whole-slot promotion (2 slots): "
        f"equal byte for byte")

    _profile_decode(cfg, params, run, S, dev)
    bf16_run = dict(kv=kv._replace(pool1=None, pool2=None, scale1=None,
                                   scale2=None),
                    logprobs=run.logprobs,
                    pool_bytes=sum(p.numel() * p.element_size()
                                   for p in (pool1, pool2)))

    def entry(name, src_file, replaces, **kw):
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{src_file}",
                    replaces=replaces, launches=launches[name], **kw)
    return [
        entry("flash_attention", "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:77", max_abs_err=f_err,
              ms=f_ms, plain_ms=fp_ms, bound_ms=fb["bound_ms"],
              bound_by=fb["bound_by"], bound_terms=fb["bound_terms"],
              library_ms=f_lib,
              shape=f"q {list(q.shape)}, k/v {list(k.shape)}, causal, bf16 "
                    f"(layer 0 of the prefill)"),
        entry("paged_attention", "paged_attention.cu",
              "src/repro/kernels/paged_attention.py:89", max_abs_err=p_err,
              ms=p_ms, plain_ms=pp_ms, bound_ms=pb["bound_ms"],
              bound_by=pb["bound_by"], bound_terms=pb["bound_terms"],
              library_ms=None, max_abs_err_kind="relative to the largest "
              "|plain| of each field", ms_graph=p_graph,
              ms_kind="a loop of wrapper calls on the captured inputs; "
              "ms_graph: a CUDA graph of the launches alone, on inputs "
              "already in f32 / int32 on the card",
              shape=f"both tiers of layer 0 at the last decode step, "
                    f"q {list(first[0][0].shape)}, pools "
                    f"{list(pool1.shape)} / {list(pool2.shape)} bf16"),
        entry("page_copy", "page_copy.cu",
              "src/repro/kernels/page_gather.py:37", max_abs_err=0.0,
              **copy_times,
              shape=f"{_live_pairs(di, si)} rows of {row_bytes} B into "
                    f"one layer "
                    f"of tier 2 (prefill population)"),
    ], bf16_run


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for x in tree for t in _leaves(x)]
    return [tree]


def _serve_pair(tag: str, cfg, params, prompts, S: dict, dev):
    """The full-width serve through ``repro_torch.launch.serve`` with the
    kernels (launch counts set to 0 just before it and read just after),
    its output checked, and the same serve with the plain versions
    selected, teacher-forced on its tokens. Returns ``(run, run_h,
    launches, plain, plain_h, forced, peak_gb)``."""
    from repro_torch.kernels import plain_versions
    from repro_torch.launch import serve
    serve.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run, run_h = _with_hidden(lambda: serve.serve(
        cfg, params, prompts, new=S["new"],
        hbm_fraction=S["hbm_fraction"], promote_every=S["promote_every"],
        extras=S.get("extras")))
    launches = serve.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    B, steps = S["requests"], S["new"] - 1
    # Token ids range over the embedding's rows: the vocabulary padded to a
    # multiple of 256, whose extra rows hold random weights here and can
    # win the argmax, as in the reference's unembed_greedy.
    n_rows = params["embed"].shape[0]
    if run.tokens.shape != (B, S["new"]) or not np.isfinite(
            run.logprobs).all() or not ((run.tokens >= 0)
                                        & (run.tokens < n_rows)).all():
        raise AssertionError(
            f"[{tag}] serve output is not finite tokens / logprobs of the "
            f"expected shape: {run.tokens.shape}, tokens in "
            f"[{run.tokens.min()}, {run.tokens.max()}] (rows {n_rows}), "
            f"finite logprobs {np.isfinite(run.logprobs).mean():.3f}")
    if not torch.isfinite(run_h).all() or run_h.shape[0] != S["new"]:
        raise AssertionError(f"[{tag}] hidden states not finite")
    forced = torch.as_tensor(run.tokens[:, :-1], device=dev)
    serve.reset_launch_counts()
    with plain_versions():
        plain, plain_h = _with_hidden(lambda: serve.serve(
            cfg, params, prompts, new=S["new"],
            hbm_fraction=S["hbm_fraction"], promote_every=S["promote_every"],
            forced=forced, extras=S.get("extras")))
    if any(serve.launch_counts().values()):
        raise AssertionError(f"[{tag}] the plain run launched a kernel")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[{tag}] {cfg.name} ({n_params / 1e9:.2f} B params, bf16, "
        f"seed 0), {B} requests x {S['prompt']} prompt tokens, {steps} "
        f"decode steps: prefill {run.prefill_s:.3f} s, decode "
        f"{run.decode_s:.3f} s ({B * steps / run.decode_s:.1f} tok/s, "
        f"{1e3 * run.decode_s / steps:.2f} ms/step); launches {launches}; "
        f"peak memory {peak_gb:.1f} GB; plain run: prefill "
        f"{plain.prefill_s:.3f} s, decode {plain.decode_s:.3f} s")
    return run, run_h, launches, plain, plain_h, forced, peak_gb


def _rec_err(a, b) -> float:
    """Largest relative difference of the recurrent states, leaf by leaf
    and layer by layer (``|a - b|`` over the largest ``|b|`` of the
    layer's leaf)."""
    err = 0.0
    for ra, rb in ((a.rec, b.rec), (a.rec_tail, b.rec_tail)):
        for da, db in zip(ra, rb):
            for k in da:
                x, y = da[k].float(), db[k].float()
                for i in range(x.shape[0] if x.dim() > 2 else 1):
                    xi, yi = (x[i], y[i]) if x.dim() > 2 else (x, y)
                    err = max(err, _rel_err(xi, yi))
    return err


def _short_runs(cfg, params, prompts, S: dict, forced, plain_h, plain_lp,
                runs: dict, n_steps: int, q=None) -> dict:
    """The first ``n_steps`` decode steps of the teacher-forced serve once
    per entry of ``runs`` (name -> (patch, unpatch, plain?)): each one's
    largest (with ``q``: ``q``-quantile of the) hidden-state difference and
    logprob gap against the plain run."""
    from repro_torch.kernels import plain_versions
    from repro_torch.launch import serve
    n_ctl = min(n_steps, S["new"] - 1)
    out = {}
    for name, (patch, unpatch, plain) in runs.items():
        patch()
        try:
            if plain:
                with plain_versions():
                    res, h = _with_hidden(lambda: serve.serve(
                        cfg, params, prompts, new=n_ctl + 1,
                        hbm_fraction=S["hbm_fraction"],
                        promote_every=S["promote_every"],
                        forced=forced[:, :n_ctl], max_seq=S["max_seq"],
                        extras=S.get("extras")))
            else:
                res, h = _with_hidden(lambda: serve.serve(
                    cfg, params, prompts, new=n_ctl + 1,
                    hbm_fraction=S["hbm_fraction"],
                    promote_every=S["promote_every"],
                    forced=forced[:, :n_ctl], max_seq=S["max_seq"],
                    extras=S.get("extras")))
        finally:
            unpatch()
        out[name] = (_hidden_err(h, plain_h, q),
                     _lp_err(res.logprobs, plain_lp, q))
        del res, h
    return out


def _check_bars(tag: str, h_err: float, lp_err: float, control: dict,
                faults: dict, n_ctl: int, tol: float = HIDDEN_TOL,
                lp_tol: float = LOGPROB_TOL, stat: str = "largest") -> None:
    log(f"[{tag}, plain path] final hidden state |h - h_plain| / |h_plain| "
        f"{stat} {h_err:.3e} over all steps (tolerance {tol}); "
        + "; ".join(f"{k} (first {n_ctl} steps) {v[0]:.3e} (logprobs "
                    f"{v[1]:.3e})" for k, v in {**control, **faults}.items())
        + f"; logprobs |diff| {stat} {lp_err:.3e} (tolerance {lp_tol})")
    if not h_err <= tol:
        raise AssertionError(f"[{tag}] hidden states differ by {h_err} > "
                             f"{tol}")
    if not lp_err <= lp_tol:
        raise AssertionError(f"[{tag}] logprobs differ by {lp_err} > "
                             f"{lp_tol}")
    for name, (e, _) in control.items():
        if not e <= tol:
            raise AssertionError(f"[{tag}] the noise floor '{name}' {e} is "
                                 f"above the bar {tol}")
    for name, (e, _) in faults.items():
        if not e > tol:
            raise AssertionError(f"[{tag}] planted fault '{name}' passes the "
                                 f"comparison: {e} <= {tol}")


def _ssd_bound(x, Bm, chunk: int) -> dict:
    """The SSD scan's least time: x, dt, B, C read once and y and the final
    state written once at HBM's rate (``bytes_ms``); the products at the
    bf16 tensor-core rate with C B^T counted once per (sequence, chunk),
    as B and C are shared by the heads (``ops_shared_cb_ms``): C B^T and
    (CB * decay)(dt x) over the q (q + 1) / 2 causal pairs t >= s of a
    chunk of q steps (2 N and 2 P flops a pair; y sums over s <= t only),
    C h and B^T x (2 q N P each). Beside them, not applied, the operations
    with C B^T counted once per head (``ops_ms``, the count before the
    kernel shared it)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    lens = [Q] * (S // Q) + ([S % Q] if S % Q else [])
    cb = Bsz * sum(q * (q + 1) // 2 * 2 * N for q in lens)
    rest = Bsz * H * sum(q * (q + 1) // 2 * 2 * P + 4 * q * N * P
                         for q in lens)
    nbytes = (2 * x.numel() * x.element_size() + 4 * Bsz * S * H
              + 2 * Bm.numel() * Bm.element_size() + 4 * H
              + 4 * Bsz * H * N * P)
    return dict(_largest(dict(bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                              ops_shared_cb_ms=1e3 * (cb + rest)
                              / BF16_FLOPS_PER_S)),
                bound_terms_per_head_cb=dict(
                    ops_ms=1e3 * (H * cb + rest) / BF16_FLOPS_PER_S),
                flops=cb + rest, bytes=nbytes)


# f32 operations an RG-LRU element takes outside the special-function
# unit: two gates (a multiply, an add, the sigmoid's negation and add), log
# a, the scalings of exp's arguments, 2 log a, 1 - exp(2 log a), the max,
# the square root's product, i u, the product and the update's multiply
# and add. The kernel is built with --fmad=false, so each is its own
# instruction with its own rounding (the plain version's): none fuses into
# an FMA, while the data sheet's 67 TFLOP/s counts an FMA as two
# operations. These issue at half that rate.
RGLRU_OPS = 21
F32_OPS_PER_S = 67e12 / 2
# MUFU instructions an RG-LRU element takes: four ex2 (the two sigmoids'
# exp, a = exp(log a), exp(2 log a)), two rcp (the sigmoids' divides) and
# one rsq (the square root). Counted in the SASS of the built kernel
# (cuobjdump -sass; the smoke's build phase prints the count, PERF.md
# §6). Hopper's special-function unit returns 16 of them a clock an SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0); the H100 SXM has 132 SMs at a boost clock of
# 1,980 MHz (NVIDIA data sheet).
RGLRU_MUFU = 7
MUFU_PER_S = 16 * 132 * 1.98e9


def _rglru_bound(u) -> dict:
    """u read once and h written once at HBM's rate (the five [W] vectors
    too; ``bytes_ms``); RGLRU_OPS f32 instructions an element at the f32
    issue rate (``ops_ms``); RGLRU_MUFU special-function results an
    element at the SFU's rate (``sfu_ms``)."""
    nbytes = 2 * u.numel() * u.element_size() + 5 * 4 * u.shape[-1]
    flops = RGLRU_OPS * u.numel()
    mufu = RGLRU_MUFU * u.numel()
    return dict(_largest(dict(bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                              ops_ms=1e3 * flops / F32_OPS_PER_S,
                              sfu_ms=1e3 * mufu / MUFU_PER_S)),
                flops=flops, mufu=mufu, bytes=nbytes)


def sass_mufu(lib) -> list:
    """Each kernel of a built library with its MUFU instructions by
    opcode, from ``cuobjdump -sass`` (``nvdisasm`` is not needed: the
    library holds sm_90a SASS); empty where the toolkit has no
    cuobjdump."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return []
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    fns = []
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fns.append(dict(name=m.group(1), mufu={}))
        elif fns:
            op = re.search(r"\b(MUFU\.\w+)", ln)
            if op:
                fns[-1]["mufu"][op.group(1)] = fns[-1]["mufu"].get(
                    op.group(1), 0) + 1
    return fns


def phase_ssd_serve(dev=torch.device("cuda")) -> dict:
    """Phase 11: mamba2-370m served at full width through
    ``repro_torch.launch.serve``; returns the SSD-scan kernel's entry."""
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tr
    S = SSD_SERVE
    tag = "ssd serve"
    gc.collect()  # the previous phase's model
    torch.cuda.empty_cache()
    cfg, params = serve.build(S["arch"], full=True, seed=0, device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (S["requests"], S["prompt"])).astype(np.int32)
    S = dict(S, max_seq=-(-(S["prompt"] + S["new"]) // cfg.page_size)
             * cfg.page_size)
    cap = {}
    scan0, cuda0 = ks.ssd_scan, ks.ssd_scan_cuda

    def cuda_hook(x, dt, A, Bm, Cm, chunk):  # the kernel's own inputs
        if "ssd" not in cap:
            cap["ssd"] = (x.clone(), dt.clone(), A.clone(), Bm.clone(),
                          Cm.clone(), chunk)
        return cuda0(x, dt, A, Bm, Cm, chunk)
    ks.ssd_scan_cuda = cuda_hook
    try:
        run, run_h, launches, plain, plain_h, forced, _ = _serve_pair(
            tag, cfg, params, prompts, S, dev)
    finally:
        ks.ssd_scan_cuda = cuda0
    if launches["ssd_scan"] != cfg.n_layers or launches["ssd_scan"] != sum(
            launches.values()) or run.state.kv is not None:
        raise AssertionError(f"[{tag}] launches {launches}, want "
                             f"{cfg.n_layers} ssd_scan and nothing else")
    rec_err = _rec_err(run.state, plain.state)
    h_err = _hidden_err(run_h, plain_h)
    lp_err = float(np.abs(run.logprobs - plain.logprobs).max())

    # The noise floor: the plain path with chunks of half the length (the
    # same scan, summed in another order). The planted fault: layer 0's
    # handed-off SSD state zeroed, on the kernel path.
    def half_chunk(x, dt, A, Bm, Cm, *, chunk):
        return scan0(x, dt, A, Bm, Cm, chunk=chunk // 2)
    block0 = tr.ssd_block
    seen = dict(n=0)

    def zero_state(*a, **kw):
        out, st = block0(*a, **kw)
        seen["n"] += 1
        if st is not None and seen["n"] == 1:
            st = dict(st, h=torch.zeros_like(st["h"]))
        return out, st
    runs = {
        "noise floor (plain, chunk / 2)": (
            lambda: setattr(ks, "ssd_scan", half_chunk),
            lambda: setattr(ks, "ssd_scan", scan0), True),
        "fault: layer 0's handed-off state zeroed": (
            lambda: setattr(tr, "ssd_block", zero_state),
            lambda: setattr(tr, "ssd_block", block0), False)}
    short = _short_runs(cfg, params, prompts, S, forced, plain_h,
                        plain.logprobs, runs, CONTROL_STEPS)
    control = {k: v for k, v in short.items() if k.startswith("noise")}
    faults = {k: v for k, v in short.items() if k.startswith("fault")}
    log(f"[{tag}, plain path] recurrent states after the last step, kernel "
        f"run vs plain run: largest |diff| / largest |plain| {rec_err:.3e}")
    _check_bars(tag, h_err, lp_err, control, faults, CONTROL_STEPS,
                SSD_HIDDEN_TOL)
    del plain, plain_h

    # The kernel against its plain version on layer 0's prefill inputs.
    x, dt, A, Bm, Cm, chunk = cap["ssd"]
    ks.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk)  # warm-up
    k_ms, (y, h) = cuda_ms(lambda: ks.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk),
                           reps=5)
    p_ms, (yp, hp) = cuda_ms(lambda: ks.ssd_scan_plain(x, dt, A, Bm, Cm,
                                                        chunk))
    y_err = float((y.float() - yp.float()).abs().max())
    y_exc = _bf16_step_excess(y, yp)
    h_rel = _rel_err(h, hp)
    # The same inputs in f32: the kernel's arithmetic without bf16 rounding.
    f32 = [t.float() for t in (x, Bm, Cm)]
    y32, h32 = ks.ssd_scan_cuda(f32[0], dt, A, f32[1], f32[2], chunk)
    y32p, h32p = ks.ssd_scan_plain(f32[0], dt, A, f32[1], f32[2], chunk)
    y32_rel = _rel_err(y32, y32p)
    Bsz, S_, H = dt.shape
    cum_max = float((dt * A).reshape(Bsz, S_ // chunk, chunk, H).sum(2)
                    .abs().max())
    bad = y.clone()
    bad[:, -64:] = (bad[:, -64:].float() * (1 + FLASH_FAULT)).to(bad.dtype)
    bad_exc = _bf16_step_excess(bad, yp)
    del bad, y32, h32, y32p, h32p, f32
    b = _ssd_bound(x, Bm, chunk)
    log(f"[{tag}, ssd_scan vs plain] layer 0's prefill, x {list(x.shape)} "
        f"bf16, N {Bm.shape[-1]}, chunk {chunk}: y max |diff| {y_err:.3e}, "
        f"|diff| / ({FLASH_ULP:g} |plain| + {FLASH_ABS:g}) {y_exc:.3f} "
        f"(tolerance 1; planted fault, the last 64 steps x (1 + "
        f"{FLASH_FAULT:g}): {bad_exc:.3f}); final state |diff| / largest "
        f"|plain| {h_rel:.3e} (tolerance {SSD_F32_TOL}; the largest chunk "
        f"sum of |dt A| is {cum_max:.1f}); in f32, y {y32_rel:.3e} "
        f"(tolerance {SSD_F32_TOL}); kernel {k_ms:.3f} ms, plain "
        f"{p_ms:.1f} ms, {fmt_bound(b)}")
    if not (y_exc <= 1 and h_rel <= SSD_F32_TOL and y32_rel <= SSD_F32_TOL):
        raise AssertionError(f"[{tag}] ssd kernel != plain: y {y_exc}, "
                             f"state {h_rel}, f32 y {y32_rel}")
    if not bad_exc > 1:
        raise AssertionError(f"[{tag}] the y check passes a planted fault")
    _profile_decode(cfg, params, run, S, dev, tag=tag)
    del run, run_h, params
    return dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:68",
        launches=launches["ssd_scan"], max_abs_err=y_err, ms=k_ms,
        plain_ms=p_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
        bound_terms=b["bound_terms"],
        bound_terms_per_head_cb=b["bound_terms_per_head_cb"],
        library_ms=None, state_rel_err=h_rel,
        shape=f"x {list(x.shape)} bf16, B/C {list(Bm.shape)}, chunk {chunk} "
              f"(layer 0 of the prefill)")


def phase_rglru_serve(dev=torch.device("cuda")) -> tuple:
    """Phase 12: recurrentgemma-9b served at full width through
    ``repro_torch.launch.serve``; returns the RG-LRU-scan kernel's entry
    and the serving kernels' numbers at this model's shapes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import page_gather as pg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain_versions
    from repro_torch.kernels import rglru_scan as kr
    from repro_torch.kernels.ref import attention_ref, paged_attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import rglru as rg
    from repro_torch.serving import engine as eng
    from repro_torch.models.attention import blockwise_attention
    S = RG_SERVE
    tag = "rglru serve"
    gc.collect()  # the previous phase's model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, params = _build_serve(S, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (S["requests"], S["prompt"])).astype(np.int32)
    S = dict(S, max_seq=-(-(S["prompt"] + S["new"]) // cfg.page_size)
             * cfg.page_size)
    steps = S["new"] - 1
    kinds = cfg.layer_kinds()
    n_attn = sum(k.startswith("attn") for k in kinds)
    n_rec = kinds.count("rglru")

    cap: dict = {}
    calls = dict(paged=0)
    last = (steps - 1) * 2 * n_attn
    flash0, paged0, copy0, scan0 = (fa.flash_attention, pa.paged_attention,
                                    pg.page_copy, kr.rglru_scan)

    def flash_hook(q, k, v, **kw):
        if "flash" not in cap:
            cap["flash"] = (q.clone(), k.clone(), v.clone(), kw)
        return flash0(q, k, v, **kw)

    def paged_hook(q, pool, slot, live, window=0, scale=None):
        if calls["paged"] - last in (0, 1):
            cap.setdefault("paged", []).append(
                (q.clone(), pool, slot.clone(), live.clone(), window))
        calls["paged"] += 1
        return paged0(q, pool, slot, live, window, scale=scale)

    def copy_hook(dst, src, di, si):
        if "copy" not in cap:
            cap["copy"] = (dst, src.clone(), di.clone(), si.clone())
        return copy0(dst, src, di, si)

    def scan_hook(u, *ps):
        if "rglru" not in cap:
            cap["rglru"] = (u.clone(), *(p.clone() for p in ps))
        return scan0(u, *ps)
    fa.flash_attention, pa.paged_attention, pg.page_copy, kr.rglru_scan = (
        flash_hook, paged_hook, copy_hook, scan_hook)
    try:
        run, run_h, launches, plain, plain_h, forced, peak = _serve_pair(
            tag, cfg, params, prompts, S, dev)
    finally:
        fa.flash_attention, pa.paged_attention, pg.page_copy, \
            kr.rglru_scan = flash0, paged0, copy0, scan0
    want = dict(flash_attention=n_attn, paged_attention=2 * n_attn * steps,
                rglru_scan=n_rec, ssd_scan=0)
    if any(launches[k] != v for k, v in want.items()) or \
            not launches["page_copy"]:
        raise AssertionError(f"[{tag}] launches {launches}, want {want} and "
                             "page copies")
    kv, pkv = run.state.kv, plain.state.kv
    for f in ("page_slot", "t2_slot", "lengths", "t", "t1_reads", "t2_reads",
              "evictions", "writebacks"):
        if not torch.equal(getattr(kv, f), getattr(pkv, f)):
            raise AssertionError(f"[{tag}] kernel run != plain run in {f}")
    for x, y in zip(kv.meta + kv.ols, pkv.meta + pkv.ols):
        if not torch.equal(x, y):
            raise AssertionError(f"[{tag}] kernel run != plain run in the "
                                 "metadata or the learner")
    if kv.key != pkv.key or not torch.equal(
            kv.ols.weights.view(torch.int32), pkv.ols.weights.view(torch.int32)):
        raise AssertionError(f"[{tag}] kernel run != plain run in the key / "
                             "weights")
    if not (kv.lengths == S["prompt"] + steps).all():
        raise AssertionError(f"[{tag}] lengths {kv.lengths.tolist()}")
    spec = eng.make_kv_spec(cfg, eng.ServeConfig(
        max_seq=S["max_seq"], batch_local=S["requests"],
        hbm_fraction=S["hbm_fraction"]))
    log(f"[{tag}] {_depth(cfg, S)}; init {init_s:.1f} s; {spec.n_pages} "
        f"pages a sequence, "
        f"{spec.hbm_slots} tier-1 and {spec.t2_slots} tier-2 slots, read "
        f"window {spec.read_pages} pages "
        f"(window {cfg.window} tokens); tier-1 page reads "
        f"{int(kv.t1_reads[0])}, tier-2 {int(kv.t2_reads[0])}, evictions "
        f"{int(kv.evictions[0])}, write-backs {int(kv.writebacks[0])}; OL "
        f"weights {kv.ols.weights.tolist()}; tier state and learner equal "
        f"to the plain run's (integers exact, f32 weights bit for bit)")
    rec_err = _rec_err(run.state, plain.state)
    h_err = _hidden_err(run_h, plain_h)
    lp_err = float(np.abs(run.logprobs - plain.logprobs).max())

    # The noise floor: the plain path with blockwise prefill attention.
    # Planted faults on the kernel path: (a) the window's token mask
    # dropped (the paged kernel also reads the tokens of the window's
    # first page that are older than the window); (b) the prefill's
    # RG-LRU state handed on unrounded (f32) instead of as the bf16 output.
    def blockwise(q, k, v, **kw):
        return blockwise_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), **kw).transpose(1, 2)

    def no_window(q, pool, slot, live, window=0, scale=None):
        return paged0(q, pool, slot, live, 0, scale=scale)
    handoff0 = rg._handoff
    last_f32 = {}

    def scan_f32(u, *ps):
        last_f32["h"] = kr.rglru_scan_cuda(u.float(), *ps)[:, -1]
        return scan0(u, *ps)

    def unrounded(h):
        return last_f32["h"]

    def patch_f32():
        kr.rglru_scan, rg._handoff = scan_f32, unrounded

    def unpatch_f32():
        kr.rglru_scan, rg._handoff = scan0, handoff0
    runs = {
        "noise floor (plain, blockwise prefill attention)": (
            lambda: setattr(fa, "flash_attention", blockwise),
            lambda: setattr(fa, "flash_attention", flash0), True),
        "fault (a): window token mask dropped": (
            lambda: setattr(pa, "paged_attention", no_window),
            lambda: setattr(pa, "paged_attention", paged0), False),
        "fault (b): RG-LRU handoff unrounded": (patch_f32, unpatch_f32,
                                                False)}
    # A page of decode steps: the token mask of fault (a) admits r + 1
    # tokens older than the window at a step with L % page = r, so only a
    # whole page of steps reaches its full size.
    n_ctl = cfg.page_size
    short = _short_runs(cfg, params, prompts, S, forced, plain_h,
                        plain.logprobs, runs, n_ctl)
    control = {k: v for k, v in short.items() if k.startswith("noise")}
    faults = {k: v for k, v in short.items() if k.startswith("fault")}
    log(f"[{tag}, plain path] recurrent states after the last step, kernel "
        f"run vs plain run: largest |diff| / largest |plain| {rec_err:.3e}")
    _check_bars(tag, h_err, lp_err, control, faults, n_ctl)
    del plain, plain_h, pkv

    # RG-LRU: layer 0's prefill u, element by element within one bf16 step.
    u, *ps = cap["rglru"]
    kr.rglru_scan_cuda(u, *ps)  # warm-up
    r_ms, h = cuda_ms(lambda: kr.rglru_scan_cuda(u, *ps), reps=20)
    rp_ms, hp = cuda_ms(lambda: kr.rglru_scan_plain(u, *ps))
    r_err = float((h.float() - hp.float()).abs().max())
    r_exc = _bf16_step_excess(h, hp)
    bad = h.clone()
    bad[:, -64:] = (bad[:, -64:].float() * (1 + FLASH_FAULT)).to(bad.dtype)
    r_bad = _bf16_step_excess(bad, hp)
    del bad, h, hp
    rb = _rglru_bound(u)
    log(f"[{tag}, rglru_scan vs plain] layer 0's prefill, u "
        f"{list(u.shape)} bf16: max |diff| {r_err:.3e}, |diff| / "
        f"({FLASH_ULP:g} |plain| + {FLASH_ABS:g}) {r_exc:.3f} (tolerance 1; "
        f"planted fault {r_bad:.3f}); kernel {r_ms:.4f} ms, plain "
        f"{rp_ms:.1f} ms, {fmt_bound(rb)}")
    if not r_exc <= 1:
        raise AssertionError(f"[{tag}] rglru kernel != plain: {r_exc}")
    if not r_bad > 1:
        raise AssertionError(f"[{tag}] the rglru check passes a planted "
                             "fault")

    # Flash at hd 256 with the 2,048-token window: layer 2's prefill.
    q, k, v, kw = cap["flash"]
    fa.flash_attention_cuda(q, k, v, **kw)
    f_ms, got = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                        reps=3)
    fp_ms, want_o = cuda_ms(lambda: attention_ref(q, k, v, **kw))
    f_err = float((got.float() - want_o.float()).abs().max())
    f_exc = _bf16_step_excess(got, want_o)
    del got, want_o
    if not f_exc <= 1:
        raise AssertionError(f"[{tag}] flash kernel != plain: {f_exc}")
    fb = _flash_bound(q, k, kw.get("window"))
    # The yardstick: one PyTorch call for the same function, a boolean band
    # mask (causal, the last `window` keys) with the kv head shared.
    pos = torch.arange(q.shape[2], device=dev)
    band = (pos[None, :] <= pos[:, None]) & (
        pos[None, :] > pos[:, None] - kw["window"])
    sdpa = dict(attn_mask=band, enable_gqa=True)
    torch.nn.functional.scaled_dot_product_attention(q, k, v, **sdpa)
    f_lib, _ = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, **sdpa), reps=3)
    del band
    log(f"[{tag}, flash vs plain] layer 2's prefill, q {list(q.shape)}, "
        f"window {kw.get('window')}: max |diff| {f_err:.3e}, element-wise "
        f"{f_exc:.3f} of its bar; kernel {f_ms:.3f} ms, plain {fp_ms:.1f} ms, "
        f"scaled_dot_product_attention (band mask, enable_gqa) {f_lib:.3f} "
        f"ms, {fmt_bound(fb)}")

    # Paged: both tiers of the first attention layer at the last step.
    pcalls = cap["paged"]
    p_err = 0.0
    for qq, pool, slot, live, window in pcalls:
        got = pa.paged_attention_cuda(qq, pool, slot, live, window)
        want_p = paged_attention_ref(qq, pool, slot, live, window)
        for g, w in zip(got, want_p):
            p_err = max(p_err, _rel_err(g, w))
    if not p_err <= PAGED_REL_TOL:
        raise AssertionError(f"[{tag}] paged kernel != plain: {p_err}")
    p_ms, _ = cuda_ms(lambda: [pa.paged_attention_cuda(*c) for c in pcalls],
                      reps=10)
    conv = [_paged_inputs(c) for c in pcalls]
    p_graph = graph_ms(lambda: [pa.paged_attention_cuda(*c) for c in conv])
    pp_ms, _ = cuda_ms(lambda: [paged_attention_ref(*c) for c in pcalls],
                       reps=3)
    pb = _paged_bound(pcalls, cfg.page_size)
    n_split = pa.split_plan(S["requests"], cfg.n_kv_heads,
                            pcalls[0][2].shape[1], cfg.page_size)
    log(f"[{tag}, paged vs plain] last decode step, first attention layer, "
        f"both tiers, window {pcalls[0][4]}: largest |diff| / largest "
        f"|plain| {p_err:.3e} (tolerance {PAGED_REL_TOL}); (n_split, span) "
        f"{n_split}: kernel {p_ms:.4f} ms in a loop of calls, "
        f"{p_graph:.4f} ms from a CUDA graph of its launches alone, plain "
        f"{pp_ms:.3f} ms, {fmt_bound(pb)}")

    # Page copy: the first prefill population, byte for byte.
    dst, src, di, si = cap["copy"]
    whole = kv.pool2
    check_page_copy(tag, [("prefill population", whole, dst, src, di, si)])
    copy_times = page_copy_times(tag, whole, dst, src, di, si)
    log(f"[{tag}, page copy vs plain] prefill population of layer 2 into "
        f"tier 2 ({_live_pairs(di, si)} pages): equal byte for byte")
    _profile_decode(cfg, params, run, S, dev, tag=tag)
    del run, run_h, params
    rglru = dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:55",
        launches=launches["rglru_scan"], max_abs_err=r_err, ms=r_ms,
        plain_ms=rp_ms, bound_ms=rb["bound_ms"], bound_by=rb["bound_by"],
        bound_terms=rb["bound_terms"], library_ms=None,
        shape=f"u {list(u.shape)} bf16 (layer 0 of the prefill)")
    at_rg = dict(
        flash_attention=dict(recurrentgemma_ms=f_ms,
                             recurrentgemma_plain_ms=fp_ms,
                             recurrentgemma_library_ms=f_lib,
                             recurrentgemma_bound_ms=fb["bound_ms"],
                             recurrentgemma_launches=launches[
                                 "flash_attention"],
                             recurrentgemma_max_abs_err=f_err),
        paged_attention=dict(recurrentgemma_ms=p_ms,
                             recurrentgemma_ms_graph=p_graph,
                             recurrentgemma_plain_ms=pp_ms,
                             recurrentgemma_bound_ms=pb["bound_ms"],
                             recurrentgemma_launches=launches[
                                 "paged_attention"],
                             recurrentgemma_max_abs_err=p_err),
        page_copy=dict({f"recurrentgemma_{k}": v
                        for k, v in copy_times.items()},
                       recurrentgemma_launches=launches["page_copy"]))
    return rglru, at_rg


def _timed_masked_launches():
    """Wrap the masked-mode launcher: each launch between two CUDA events
    (recorded on the stream, so nothing waits), with its rows' misses and
    hits before and after (device copies). Returns ``(records, restore)``."""
    from repro_torch.kernels import cache_scan as cs
    records = []
    launch = cs.masked_cache_scan_cuda

    def timed(cfg, hyper, state, acc, pages, *rest, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        before = (acc.misses.clone(), acc.hits.clone())
        start.record()
        out = launch(cfg, hyper, state, acc, pages, *rest, **kw)
        stop.record()
        records.append((start, stop, before,
                        (acc.misses.clone(), acc.hits.clone()),
                        tuple(pages.shape), carry_bytes(state, acc)))
        return out

    cs.masked_cache_scan_cuda = timed

    def restore():
        cs.masked_cache_scan_cuda = launch
    return records, restore


def carry_bytes(state, acc) -> int:
    from repro_torch.kernels import cache_scan as cs
    return sum(x.numel() * x.element_size()
               for x in cs.carry_leaves(state, acc))


def chunked_bound(records, main_terms: dict, cfg, plan) -> dict:
    """Least time for a chunked replay's launches, each priced as
    :func:`bound` prices a launch, summed: its rows read once (12 B a
    position), its carry read and written once; the per-line state and
    operations of the same real requests (passes every K of them and the
    evictions: phase 5's terms, since the requests are the same); and
    each launch's walker chain, ``misses + ceil(hits / 32)`` iterations of
    its longest row at the probe's step time for its shape."""
    from repro_torch.kernels import probe
    io = chain = 0.0
    steps: dict = {}
    for _, _, (m0, h0), (m1, h1), shape, cbytes in records:
        B, L = shape
        if shape not in steps:
            steps[shape] = probe.walker_step_ms(
                "cuda", n_rows=B, threads=plan.threads, steps=L, K=plan.K,
                n_lines=cfg.n_lines) / L
        misses = (m1 - m0).cpu().numpy().astype(np.int64)
        hits = (h1 - h0).cpu().numpy().astype(np.int64)
        chain += steps[shape] * int((misses + -(-hits // 32)).max())
        io += 12 * B * L + 2 * cbytes
    terms = dict(io_bytes_ms=1e3 * io / HBM_BYTES_PER_S,
                 state_bytes_pass_ms=main_terms["state_bytes_pass_ms"],
                 ops_pass_ms=main_terms["ops_pass_ms"],
                 walker_chain_ms=chain)
    return _largest(terms)


def phase_chunked_replay(full_ctr, full_rep, full_rows, full: dict,
                         rates: dict) -> dict:
    """Phase 13: the chunked replay at full size through the public entry
    points. (a) phase 5's deployment by ``simulate_stream`` at
    ``DEFAULT_CHUNK`` (16 chunks of rows of 32,768), its counters and
    report against phase 5's one-shot ones, then the synchronous
    ``donate=False`` baseline; (b) a stop at 2^21 requests, the checkpoint
    pickled and resumed, equal peak memory in both halves; (c) a
    two-tenant mix at full width against a one-shot ``tier1_counters``;
    (d) the masked kernel against its plain version on 2^11 requests of
    the shard rows from the checkpoint's carry, pads mid-row and at the
    tails, in three plans; (e) ``engine="scan"`` on the card."""
    import pickle

    from repro_torch.core.traffic import TenantSpec, TrafficSpec, tenant_mix
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.sim import (
        SimSpec, report_from_counters, simulate_stream,
        stream_tier1_counters, tier1_counters)
    from repro_torch.sim import stream as stream_mod
    from repro_torch.sim.stream import DEFAULT_CHUNK, _to_device
    from repro_torch.storage import tiered_store as ts
    t_phase = time.perf_counter()
    spec = full_size_spec()
    cfg = spec.store
    dev = torch.device("cuda")

    # (a) the replay, timed launch by launch; the counters it reports on
    # are caught on their way from stream_tier1_counters.
    caught = []
    replay = stream_mod.stream_tier1_counters

    def catch(*args, **kw):
        out = replay(*args, **kw)
        caught.append(out[0])
        return out

    records, restore = _timed_masked_launches()
    stream_mod.stream_tier1_counters = catch
    reset_launch_counts()
    ts.reset_stream_compile_count()
    prof: dict = {}
    try:
        t0 = time.perf_counter()
        rep = simulate_stream(spec, profile=prof, device="cuda")
        wall = time.perf_counter() - t0
        launches = launch_counts()["cache_scan"]
        n_sets = ts.stream_compile_count()
        restore()
        base_prof: dict = {}
        t0 = time.perf_counter()
        base_rep = simulate_stream(spec, donate=False, profile=base_prof,
                                   device="cuda")
        base_wall = time.perf_counter() - t0
    finally:
        restore()
        stream_mod.stream_tier1_counters = replay
    if launches != len(records) or launches != prof["stream_chunks"]:
        raise AssertionError(f"{launches} cache-scan launches for "
                             f"{prof['stream_chunks']} chunks")
    k_ms = sum(a.elapsed_time(b) for a, b, *_ in records)
    want = json.dumps(full_rep.to_dict(), sort_keys=True)
    for tag, got_rep, got_ctr in (("", rep, caught[0]),
                                  ("donate=False ", base_rep, caught[1])):
        if json.dumps(got_rep.to_dict(), sort_keys=True) != want:
            raise AssertionError(f"{tag}simulate_stream's report != phase "
                                 "5's")
        for f in full_ctr._fields:
            if not np.array_equal(getattr(got_ctr, f),
                                  getattr(full_ctr, f)):
                raise AssertionError(f"{tag}replay != one-shot in {f}")
    plan = cs.cache_scan_plan(cfg, spec.n_windows, spec.n_shards)
    cb = chunked_bound(records, full["main_bound_terms"], cfg, plan)
    shapes = sorted({r[4] for r in records})

    def fmt_prof(p, total):
        chunks = sum(v for v in p.values() if isinstance(v, float))
        return (", ".join(f"{k} {v:.3f} s" for k, v in p.items()
                          if isinstance(v, float))
                + f", the rest (the whole stream's generation, mapping and "
                  f"binning before the first chunk, the report) "
                  f"{total - chunks:.3f} s")
    log(f"[chunked replay] simulate_stream at chunk {DEFAULT_CHUNK}: "
        f"{launches} launches of {shapes} rows, {wall:.2f} s wall (phase "
        f"5's one-shot tier1_counters, generation included, "
        f"{full['main_tier1_stage_s']:.2f} s); {n_sets} buffer sets; "
        f"kernel {k_ms:.1f} ms summed (CUDA events), {fmt_bound(cb)}, the "
        f"carry {records[0][5]} B in and out a launch; "
        f"{fmt_prof(prof, wall)}; donate=False: {base_wall:.2f} s wall "
        f"({fmt_prof(base_prof, base_wall)}); both: Tier1Counters equal "
        f"phase 5's in every field, report to_dict identical to phase 5's")

    # (b) stop at 2^21, pickle, resume: bit-exact, equal peak memory.
    half = 2**21
    ts.reset_stream_compile_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _, _, ck = stream_tier1_counters(spec, max_requests=half, device="cuda")
    peak1 = torch.cuda.max_memory_allocated() - base_mem
    blob = pickle.dumps(ck)
    ck2 = pickle.loads(blob)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    ctr2, _, end = stream_tier1_counters(spec, checkpoint=ck2, device="cuda")
    peak2 = torch.cuda.max_memory_allocated() - base_mem
    for f in full_ctr._fields:
        if not np.array_equal(getattr(ctr2, f), getattr(full_ctr, f)):
            raise AssertionError(f"resumed replay != uninterrupted in {f}")
    more_sets = ts.stream_compile_count()
    buf_set = 3 * 4 * max(B * L for B, L in shapes)
    if (not end.done or n_sets + more_sets > 2
            or abs(peak1 - peak2) > buf_set):
        raise AssertionError(
            f"resume: done={end.done}, {n_sets} + {more_sets} buffer sets, "
            f"peak memory {peak1} vs {peak2} B (one set {buf_set} B)")
    log(f"[chunked replay, resume] stopped at {half} requests, checkpoint "
        f"pickled ({len(blob)} B) and resumed: counters equal the "
        f"uninterrupted replay in every field; peak device memory above "
        f"the phase's start {peak1} B (first half), {peak2} B (second), "
        f"one buffer set {buf_set} B; buffer sets: {n_sets} in (a), "
        f"{more_sets} more here")

    # (c) the two-tenant mix at full width.
    mix = tenant_mix(
        TenantSpec(name="oltp", rate=600.0, n_pages=2**20, zipf_s=1.3,
                   write_fraction=0.4),
        TenantSpec(name="analytics", rate=200.0, n_pages=3 * 2**20,
                   zipf_s=0.9),
        n_requests=2**22)
    window_dt = mix.n_requests / (600.0 + 200.0) / 32
    tspec = SimSpec(traffic=mix, store=cfg, n_shards=16, mapping="random",
                    n_windows=32, window_dt=window_dt, lam=200.0)
    reset_launch_counts()
    t0 = time.perf_counter()
    tctr, tc, _ = stream_tier1_counters(tspec, device="cuda")
    t_wall = time.perf_counter() - t0
    t_launches = launch_counts()["cache_scan"]
    trep = report_from_counters(tspec, tctr, tenants=tc)
    one = tier1_counters(tspec, device="cuda")
    for f in one._fields:
        if not np.array_equal(getattr(tctr, f), getattr(one, f)):
            raise AssertionError(f"tenant replay != one-shot in {f}")
    if not (tctr.evictions > 0).all():
        raise AssertionError(f"a shard never evicted: {tctr.evictions}")
    if not (np.array_equal(tc.win_requests.sum(0),
                           tctr.win_requests.sum(0))
            and np.array_equal(tc.win_misses.sum(0),
                               tctr.win_misses.sum(0))
            and sum(t.requests for t in trep.tenants) == trep.requests
            and sum(t.misses for t in trep.tenants) == trep.misses):
        raise AssertionError("per-tenant counters do not sum to the pool")
    per = "; ".join(f"{t.name}: {t.requests} requests, miss rate "
                    f"{t.miss_rate:.4f}, mean response "
                    f"{t.mean_response_s:.6g} s" for t in trep.tenants)
    log(f"[chunked replay, tenants] oltp + analytics over {mix.n_pages} "
        f"pages, {mix.n_requests} requests, 32 windows of {window_dt} s "
        f"({32 * tc.n_tenants} composite), 16 shards x {cfg.n_lines} "
        f"lines: {t_wall:.2f} s wall, {t_launches} launches; counters "
        f"equal a one-shot tier1_counters; every shard evicts "
        f"({int(tctr.evictions.min())}..{int(tctr.evictions.max())}); "
        f"tenants sum to the pool; {per}")

    # (d) the masked kernel against its plain version, from the
    # checkpoint's carry (full caches), on 2^11 requests of the shard rows
    # (2^12 until PR 25, which cut it to pay for phase 22) cut into three
    # unequal chunks with pads planted.
    P, W = 2**11, spec.n_windows
    rng = np.random.default_rng(13)
    rows = full_rows[:, :P]
    B = rows.shape[0]
    writes_np = rng.random(rows.shape) < 0.3
    chunks = []
    for lo, hi in ((0, 475), (475, 1400), (1400, P)):
        # n real requests a row at random positions among the first
        # n + 5n/16 of n + 3n/8 (pads mid-row), then a padded tail.
        n = hi - lo
        shape = (B, n + n // 4 + n // 8)
        pages = np.zeros(shape, np.int32)
        writes = np.zeros(shape, bool)
        win = np.full(shape, W + 1, np.int32)
        for b in range(B):
            real = np.sort(rng.choice(shape[1] - n // 16, n, replace=False))
            pages[b, real] = rows[b, lo:hi]
            writes[b, real] = writes_np[b, lo:hi]
            win[b, real] = (np.arange(lo, hi) * W) // P
        chunks.append([torch.as_tensor(x, device=dev)
                       for x in (pages, writes, win)])
    hyper = cs.per_row(cfg.hyper(), B, dev)
    carry0 = _to_device(ck.carry, dev)
    t0 = time.perf_counter()
    want = carry0
    for c in chunks:
        want = cs.masked_cache_scan_plain(cfg, hyper, *want, *c, n_windows=W)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    wleaves = cs.carry_leaves(*want)
    errs, kms = [], {}
    for name, launch in (("default", {}), ("cluster 1", dict(cluster=1)),
                         ("scratch", dict(smem_state=False))):
        got = _to_device(ck.carry, dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for c in chunks:
            got = cs.masked_cache_scan_cuda(cfg, hyper, *got, *c,
                                            n_windows=W, **launch)
        stop.record()
        torch.cuda.synchronize()
        kms[name] = start.elapsed_time(stop)
        for i, (x, y) in enumerate(zip(cs.carry_leaves(*got), wleaves)):
            same = (torch.equal(x.view(torch.int32), y.view(torch.int32))
                    if y.dtype == torch.float32 else torch.equal(x, y))
            if not same:
                raise AssertionError(f"masked kernel ({name}) != plain "
                                     f"in carry leaf {i}")
            errs.append(float((x.double() - y.double()).abs().max()))
    ev = (want[1].evictions - carry0[1].evictions).cpu()
    if not (ev > 0).all():
        raise AssertionError("a row never evicted in the compared chunks")
    real_n = sum(int((c[2] < W).sum()) for c in chunks)
    log(f"[chunked replay, masked kernel vs plain] {B} rows from the "
        f"checkpoint's carry, three chunks of "
        f"{[tuple(c[0].shape) for c in chunks]} positions ({real_n} real "
        f"requests, pads mid-row and at the tails), n_lines={cfg.n_lines}, "
        f"{W} windows: every carry leaf equal (tolerance 0: integers "
        f"exact, f32 bit for bit, the key) in the default plan, at cluster "
        f"1 and in the device-scratch plan; kernel "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in kms.items())
        + f"; plain {plain_ms:.1f} ms; evictions/row "
        f"{int(ev.min())}..{int(ev.max())}")

    # (e) the per-step engine on the card.
    sspec = SimSpec(
        traffic=TrafficSpec(kind="irm", n_requests=1200, n_pages=512,
                            zipf_s=1.1, write_fraction=0.3, seed=3),
        store=ts.StoreConfig(n_lines=64, policy="ws"), n_shards=4,
        n_windows=7)
    t0 = time.perf_counter()
    scan = tier1_counters(sspec, engine="scan", device="cuda")
    scan_s = time.perf_counter() - t0
    fused = tier1_counters(sspec, device="cuda")
    for f in fused._fields:
        if not np.array_equal(getattr(scan, f), getattr(fused, f)):
            raise AssertionError(f"engine='scan' != fused in {f}")
    log(f"[chunked replay, scan engine] engine='scan' on the card "
        f"(4 shards x 64 lines, 1,200 requests): equal to the fused "
        f"kernel in every field, {scan_s:.2f} s; phase 13 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(chunked_launches=launches, chunked_ms=k_ms,
                chunked_bound_ms=cb["bound_ms"],
                chunked_bound_by=cb["bound_by"],
                chunked_bound_terms=cb["bound_terms"],
                chunked_wall_s=wall, chunked_baseline_wall_s=base_wall,
                chunked_profile=prof, chunked_shape=(
                    f"{launches} launches of {shapes} rows (simulate_stream "
                    f"at chunk {DEFAULT_CHUNK}), n_lines={cfg.n_lines}, "
                    f"n_windows={spec.n_windows}, ws"),
                chunked_max_abs_err=max(errs),
                chunked_masked_ms=kms["default"],
                chunked_masked_plain_ms=plain_ms,
                chunked_tenant_wall_s=t_wall)


def _busy_ms(prof) -> tuple[float, int, dict]:
    """The union of the card's kernel and copy intervals in a profile, in
    ms, the count of kernels, and the kernel time (ms) by group."""
    spans = []
    groups = dict(gemm=0.0, elementwise=0.0, reduce=0.0, index=0.0,
                  copy=0.0, other=0.0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start, dur = e.start_ns(), e.duration_ns()
        spans.append((start, start + dur))
        name = e.name().lower()
        g = ("copy" if "memcpy" in name or "memset" in name else
             "gemm" if any(x in name for x in ("gemm", "nvjet", "cutlass",
                                                "sm90_xmma")) else
             "elementwise" if "elementwise" in name else
             "reduce" if "reduce" in name else
             "index" if any(x in name for x in ("index", "scatter",
                                                 "gather")) else "other")
        groups[g] += dur / 1e6
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6, len(spans), groups


def _train_launches() -> dict:
    from repro_torch.launch import serve
    return {**launch_counts(), **serve.launch_counts()}


def _reset_train_launches() -> None:
    from repro_torch.launch import serve
    reset_launch_counts()
    serve.reset_launch_counts()


def _train_full(root: str, card: str, dev) -> None:
    """Phase 14 (a): stablelm-3b at full width through ``run_training``."""
    from repro_torch.configs.archs import get_config
    from repro_torch.launch.train import run_training
    from repro_torch.storage.datacache import (DataCache, DataCacheConfig,
                                               ShardedTokenStore)
    from repro_torch.training.checkpoint import CheckpointConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainHyper, make_train_step
    T = TRAIN
    never = 10 ** 9  # no snapshot at full width (the smoke's time)
    data = os.path.join(root, "data_full")
    _reset_train_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = run_training(
        arch=T["arch"], reduced=False, steps=T["steps"], batch=T["batch"],
        seq=T["seq"], lr=T["lr"], data_dir=data, resume=False,
        ckpt=CheckpointConfig(dir_tier1=os.path.join(root, "full_fast"),
                              dir_tier2=os.path.join(root, "full_durable"),
                              tier1_every=never, tier2_every=never),
        log_every=T["steps"], device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = _train_launches()
    losses, gnorms = out["losses"], out["grad_norms"]
    if len(losses) != T["steps"] or not (np.all(np.isfinite(losses)) and
                                        np.all(np.isfinite(gnorms))):
        raise AssertionError(f"[train] non-finite or missing losses "
                             f"{losses} / grad norms {gnorms}")
    cfg = get_config(T["arch"])
    B, S, L = T["batch"], T["seq"], cfg.n_layers
    tokens = B * S
    step_s = float(np.median(out["step_s"][TRAIN_TIMED]))
    n = out["n_params"]
    dense_flops = 6 * n * tokens
    # Causal attention, forward: QK^T and PV over the visible half of each
    # S x S score matrix, 2 flops a multiply-add: 2 * B * H * hd * S^2 a
    # layer; training is three times the forward (the backward twice).
    attn_flops = 3 * 2 * B * cfg.n_heads * cfg.head_dim * S * S * L
    flops = dense_flops + attn_flops
    share = flops / step_s / BF16_FLOPS_PER_S
    log(f"[train, full width] {cfg.name}: {n:,} parameters (bf16; f32 "
        f"AdamW moments and error feedback; remat), {T['steps']} steps of "
        f"{B} x {S} tokens from the data-shard cache, lr {T['lr']} "
        f"(warmup 20): run {wall:.1f} s (the first step {out['step_s'][0]:.2f} "
        f"s); median step over steps 3-{T['steps']} {1e3 * step_s:.1f} ms, "
        f"{tokens / step_s:,.0f} tokens/s [{card}]")
    log(f"[train, full width] model FLOPs a step: 6 N D = 6 x {n:,} x "
        f"{tokens:,} = {dense_flops:.4e}, attention 3 x 2 B H hd S^2 L = "
        f"{attn_flops:.4e}, total {flops:.4e}: {flops / step_s / 1e12:.1f} "
        f"TFLOP/s, {100 * share:.1f}% of the bf16 dense peak 989 TFLOP/s "
        f"[{card}]; peak memory (max_memory_allocated) "
        f"{peak / 1e9:.2f} GB (reckoned ~55 GB) of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.1f} GB")
    log(f"[train, full width] losses {[round(x, 4) for x in losses]}; grad "
        f"norms {[round(x, 4) for x in gnorms]}; data cache: "
        f"{out['cache_hits']} hits, {out['cache_misses']} misses; hand-"
        f"kernel launches {launches} (the training path runs none)")

    # One more step under torch.profiler: the card's busy share.
    state = out.pop("state")
    del out
    hyper = TrainHyper(adamw=AdamWConfig(lr=T["lr"], warmup_steps=20,
                                         decay_steps=max(T["steps"], 100)))
    step_fn = make_train_step(cfg, hyper=hyper)
    store = ShardedTokenStore(data, n_shards=16, shard_tokens=B * (S + 1) * 4,
                              vocab=cfg.vocab)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in DataCache(
        store, DataCacheConfig(cache_shards=4)).batch(T["steps"], B, S).items()}
    torch.cuda.synchronize(dev)
    # The card's activity alone: a step makes ~10^5 host ops, whose
    # tracing would cost more than the step.
    acts = [torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        state, m = step_fn(state, batch)
        torch.cuda.synchronize(dev)
    traced_s = time.perf_counter() - t0
    busy_ms, kernels, groups = _busy_ms(prof)
    if not np.isfinite(float(m["loss"])) or busy_ms <= 0:
        raise AssertionError("[train] the profiled step failed or traced no "
                             "device time")
    log(f"[train, profile] one step under torch.profiler: the card busy "
        f"{busy_ms:.1f} ms (union of kernels and copies), "
        f"{100 * busy_ms / (1e3 * step_s):.1f}% of the untraced median step "
        f"{1e3 * step_s:.1f} ms ({100 * busy_ms / (1e3 * traced_s):.1f}% of "
        f"the traced step's {1e3 * traced_s:.1f} ms); {kernels:,} kernels "
        f"and copies; kernel ms by group "
        f"{ {k: round(v, 1) for k, v in groups.items()} } [{card}]")
    del state, m, batch, prof


def _family_batch(cfg, B: int, S: int, rng, dev) -> dict:
    """A batch of ``S`` positions a sequence from a numpy generator:
    random tokens and labels, and the stub embeddings the family needs
    (a VLM's patch embeddings among the ``S``, whisper's frames beside
    them; ``N(0, 0.02^2)`` in the parameters' dtype), on ``dev``."""
    s_txt = S - (cfg.vlm_prefix or 0)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, s_txt)).astype(
        np.int32)) for k in ("tokens", "labels")}
    dt = getattr(torch, cfg.param_dtype)
    for key, n, on in (("prefix_embeds", cfg.vlm_prefix, cfg.vlm_prefix),
                       ("frames", cfg.enc_seq, cfg.enc_dec)):
        if on:
            b[key] = torch.from_numpy(rng.normal(size=(
                B, n, cfg.d_model)).astype(np.float32) * 0.02).to(dt)
    return {k: v.to(dev) for k, v in b.items()}


def _route_recorder(route, records: list):
    """A stand-in for ``moe.route`` that records each call's router
    probabilities and chosen experts (on the host) in ``records``."""

    def recorded(x, w, cfg):
        out = route(x, w, cfg)
        records.append((out[0].detach().cpu(), out[2].cpu()))
        return out
    return recorded


def _routing_margins(cpu_rec: list, gpu_rec: list, k: int) -> str:
    """The two devices' routings: tokens whose top-``k`` experts differ,
    and the smallest gap between the ``k``-th and the next probability
    (the CPU's), over all tokens and over the flipped ones."""
    flips, tokens, low, low_flip = 0, 0, float("inf"), float("inf")
    for (p, e), (_, eg) in zip(cpu_rec, gpu_rec):
        top = torch.sort(p, dim=-1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        diff = (e != eg).any(-1)
        flips += int(diff.sum())
        tokens += e.shape[0]
        low = min(low, float(gap.min()))
        if diff.any():
            low_flip = min(low_flip, float(gap[diff].min()))
    return (f"routing: {flips} of {tokens} (token, layer) choices differ "
            f"between the devices; smallest top-{k} margin {low:.3e}"
            + (f", {low_flip:.3e} at a flipped token" if flips else ""))


def _train_card_vs_cpu(arch: str, C: dict, card: str, dev) -> None:
    """``C["steps"]`` f32 steps of ``arch``'s reduced configuration on the
    card and on the CPU from one state (phases 14 (b) and 20 (b))."""
    import dataclasses
    from repro_torch.configs.archs import get_config
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.training.compression import init_error_feedback
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import (TrainHyper, TrainState,
                                                 make_train_step)
    from repro_torch.training.tree import leaves, tree_map
    tol = TRAIN_CPU_TOL
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    params = init_params(cfg, 0, "cpu")
    cpu = TrainState(params, adamw_init(params, cfg.opt_state_dtype),
                     init_error_feedback(params))
    gpu = tree_map(lambda t: t.to(dev, copy=True), cpu)
    step = make_train_step(cfg, hyper=TrainHyper(adamw=AdamWConfig(
        lr=C["lr"], warmup_steps=0, decay_steps=100)))
    rng = np.random.default_rng(0)
    worst = dict(loss=0.0, grad_norm=0.0)
    records = dict(cpu=[], gpu=[])
    route0 = moe.route
    try:
        for _ in range(C["steps"]):
            b = _family_batch(cfg, C["batch"], C["seq"], rng, "cpu")
            moe.route = _route_recorder(route0, records["cpu"])
            cpu, mc = step(cpu, b)
            moe.route = _route_recorder(route0, records["gpu"])
            gpu, mg = step(gpu, {k: v.to(dev) for k, v in b.items()})
            for k in worst:
                a, g = float(mc[k]), float(mg[k])
                worst[k] = max(worst[k], abs(g - a) / abs(a))
            if cfg.moe is not None:
                a, g = float(mc["aux_loss"]), float(mg["aux_loss"])
                worst["aux_loss"] = max(worst.get("aux_loss", 0.0),
                                        abs(g - a) / abs(a))
    finally:
        moe.route = route0
    dp = max(float((g.cpu() - c).abs().max())
             for g, c in zip(leaves(gpu.params), leaves(cpu.params)))
    bound = tol["lr_frac_per_step"] * C["lr"] * C["steps"]
    equal_steps = int(gpu.opt.step) == int(cpu.opt.step) == C["steps"]
    ok = (max(worst.values()) <= tol["rel"] and dp <= bound and equal_steps)
    routing = ("; " + _routing_margins(records["cpu"], records["gpu"],
                                       cfg.moe.top_k)
               if cfg.moe is not None else "")
    log(f"[train, card vs cpu] {cfg.name} f32, {C['steps']} steps of "
        f"{C['batch']} x {C['seq']}, lr {C['lr']}, TF32 off: "
        + ", ".join(f"{k.replace('_', ' ')} rel {v:.2e}"
                    for k, v in worst.items())
        + f" (bar {tol['rel']:.0e}); params max |diff| {dp:.3e} = "
        f"{dp / C['lr']:.4f} lr (bar {bound / C['lr']:.2f} lr){routing}")
    if not ok:
        raise AssertionError(f"[train] {cfg.name}: card and CPU disagree "
                             "beyond TRAIN_CPU_TOL")


def _train_drill(root: str, card: str, dev) -> None:
    """Phase 14 (c): the restart drill at full width, depth 2."""
    from repro_torch.launch.train import run_training
    from repro_torch.training.checkpoint import CheckpointConfig
    from repro_torch.training.tree import leaves
    D, T = DRILL, TRAIN
    never = 10 ** 9

    def ck(name, every):
        return CheckpointConfig(dir_tier1=os.path.join(root, name, "fast"),
                                dir_tier2=os.path.join(root, name, "durable"),
                                tier1_every=every, tier2_every=never)

    kw = dict(arch=T["arch"], reduced=False, layers=D["layers"],
              steps=D["steps"], batch=T["batch"], seq=T["seq"], lr=T["lr"],
              data_dir=os.path.join(root, "data_drill"), log_every=never,
              device=dev)
    full = run_training(ckpt=ck("uninterrupted", never), **kw)
    want = [t.detach().cpu() for t in leaves(full.pop("state"))]
    nbytes = sum(t.numel() * t.element_size() for t in want)
    killed = run_training(ckpt=ck("drill", D["tier1_every"]),
                          kill_at=D["kill_at"], **kw)
    del killed["state"]
    torch.cuda.empty_cache()
    resumed = run_training(ckpt=ck("drill", D["tier1_every"]), **kw)
    got = leaves(resumed.pop("state"))
    k = D["tier1_every"]  # the step the snapshot holds
    same_state = len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a.cpu(), b)
        for a, b in zip(got, want))
    ok = (killed.get("killed_at") == D["kill_at"]
          and killed["losses"] == full["losses"][:D["kill_at"] + 1]
          and resumed["losses"] == full["losses"][k:] and same_state)
    save_s, restore_s = killed["save_s"], resumed["restore_s"]
    log(f"[train, restart drill] {T['arch']} at full width, {D['layers']} "
        f"layers ({full['n_params']:,} parameters), {T['batch']} x "
        f"{T['seq']}: killed after step {D['kill_at']}, resumed from the "
        f"tier-1 snapshot of step {k}: losses after it "
        f"{resumed['losses']} vs uninterrupted {full['losses'][k:]}, final "
        f"state {'equal bit for bit' if same_state else 'DIFFERENT'} "
        f"({len(want)} leaves); snapshot {nbytes / 1e9:.2f} GB, save "
        f"{save_s:.2f} s ({nbytes / 1e9 / save_s:.2f} GB/s), restore "
        f"{restore_s:.2f} s ({nbytes / 1e9 / restore_s:.2f} GB/s) [{card}]")
    if not ok:
        raise AssertionError("[train] the resumed run differs from the "
                             "uninterrupted one")


def phase_train(dev=torch.device("cuda")) -> None:
    """Phase 14: training through ``repro_torch.launch.train``."""
    import shutil
    import tempfile
    gc.collect()  # the previous phases' models
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_smoke_", dir=build)
    try:
        _train_full(root, card, dev)
        gc.collect()
        torch.cuda.empty_cache()
        _train_card_vs_cpu(TRAIN["arch"], TRAIN_CPU, card, dev)
        _train_drill(root, card, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[train] phase 14 took {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")


def _train_reckoning(cfg, n: int, B: int, s_txt: int) -> dict:
    """Phase 20's reckoned peak in GB: the state (bf16 parameters and
    gradients, the moments in ``cfg.opt_state_dtype``, f32 error
    feedback) and the f32 logits (the logits, their exp and their
    gradient over ``B x s_txt`` positions; the f32 unembedding and its
    gradient)."""
    from repro_torch.models.params import pad_vocab
    moment = 2 if cfg.opt_state_dtype == "bfloat16" else 4
    V = pad_vocab(cfg.vocab)
    state = n * (2 + 2 * moment + 4 + 2)
    logits = 3 * B * s_txt * V * 4 + 2 * V * cfg.d_model * 4
    return dict(state=state / 1e9, logits=logits / 1e9,
                total=(state + logits) / 1e9)


def _train_flops(cfg, params, B: int, S: int) -> float:
    """Model FLOPs of one step: 6 N D, N the parameters a position passes
    through (an MoE's expert banks at top_k / n_experts; whisper's encoder
    over its frames), plus attention, 3 x 4 B H hd a visible (query, key)
    pair and layer (QK^T and PV, forward and backward)."""
    from repro_torch.training.tree import leaves
    n_all = sum(t.numel() for t in leaves(params))
    n_enc = sum(t.numel() for t in leaves(params.get("enc_blocks", [])))
    n_exp = sum(blk[k].numel() for part in ("blocks", "tail")
                for blk in params[part] for k in ("w_gate", "w_up", "w_down")
                if cfg.moe is not None and k in blk)
    active = n_all - n_enc - n_exp + (
        n_exp * cfg.moe.top_k / cfg.moe.n_experts if cfg.moe else 0)
    T = cfg.enc_seq if cfg.enc_dec else 0
    flops = 6 * active * B * S + 6 * n_enc * B * T
    pair = 3 * 4 * B * cfg.n_heads * cfg.head_dim
    for kind in cfg.layer_kinds():
        if kind.startswith("attn"):
            window = cfg.window if kind in ("attn_swa", "attn_local") else None
            flops += pair * _visible_pairs(S, S, window=window,
                                           prefix_len=cfg.vlm_prefix or 0)
            if cfg.enc_dec:
                flops += pair * _visible_pairs(S, T, causal=False)
    flops += pair * cfg.n_enc_layers * _visible_pairs(T, T, causal=False)
    return flops


def _train_with_extras(cfg, F: dict, dev) -> dict:
    """Phase 20 (a) for whisper-tiny and paligemma-3b, whose batches carry
    stub embeddings that the data-shard cache does not hold: ``run_training``
    refuses them, so the steps go through ``make_train_step`` with
    ``run_training``'s state and hyperparameters, each step's batch drawn
    from a numpy seed. Returns ``run_training``'s keys."""
    from repro_torch.models.params import init_params
    from repro_torch.training.compression import init_error_feedback
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import (TrainHyper, TrainState,
                                                 make_train_step)
    from repro_torch.training.tree import leaves
    params = init_params(cfg, 0, dev)
    state = TrainState(params, adamw_init(params, cfg.opt_state_dtype),
                       init_error_feedback(params))
    step_fn = make_train_step(cfg, hyper=TrainHyper(adamw=AdamWConfig(
        lr=TRAIN["lr"], warmup_steps=20, decay_steps=100)))
    out = dict(losses=[], grad_norms=[], aux_losses=[], dropped=[],
               step_s=[], n_params=sum(p.numel() for p in leaves(params)))
    for i in range(TRAIN_FAMILY_STEPS):
        t0 = time.perf_counter()
        b = _family_batch(cfg, F["batch"], F["seq"],
                          np.random.default_rng(i), dev)
        state, m = step_fn(state, b)
        for key, metric in (("losses", "loss"), ("grad_norms", "grad_norm"),
                            ("aux_losses", "aux_loss"),
                            ("dropped", "dropped")):
            out[key].append(float(m[metric]))
        out["step_s"].append(time.perf_counter() - t0)
    out["state"] = state
    return out


def _untrained_leaves(mu) -> list:
    """The first-moment leaves (each layer of a stacked leaf on its own)
    that are all zero: no step's gradient reached them."""
    dead = []
    for name in sorted(mu):
        tree = mu[name]
        if isinstance(tree, torch.Tensor):
            tree = [{"": tree}]
        for i, blk in enumerate(tree):
            for k, m in blk.items():
                rows = m.reshape(m.shape[0], -1) if (
                    name in ("blocks", "enc_blocks") and m.dim() > 1) else (
                    m.reshape(1, -1))
                for r in torch.nonzero(~rows.ne(0).any(1)).flatten().tolist():
                    dead.append(f"{name}[{i}].{k}[{r}]")
    return dead


def _train_family(F: dict, root: str, card: str, dev) -> None:
    """Phase 20 (a): one family at full width for TRAIN_FAMILY_STEPS steps."""
    import dataclasses
    from repro_torch.configs.archs import get_config
    from repro_torch.launch.train import run_training
    from repro_torch.training.checkpoint import CheckpointConfig
    cfg = get_config(F["arch"])
    if F["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=F["layers"])
    B, S, steps = F["batch"], F["seq"], TRAIN_FAMILY_STEPS
    never = 10 ** 9
    gc.collect()
    torch.cuda.empty_cache()
    _reset_train_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if cfg.enc_dec or cfg.vlm_prefix:
        out = _train_with_extras(cfg, F, dev)
    else:
        out = run_training(
            arch=F["arch"], reduced=False, layers=F["layers"], steps=steps,
            batch=B, seq=S, lr=TRAIN["lr"], resume=False,
            data_dir=os.path.join(root, "data_" + F["arch"]),
            ckpt=CheckpointConfig(dir_tier1=os.path.join(root, "fam_fast"),
                                  dir_tier2=os.path.join(root, "fam_durable"),
                                  tier1_every=never, tier2_every=never),
            log_every=never, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = _train_launches()
    state = out.pop("state")
    losses, gnorms = out["losses"], out["grad_norms"]
    dead = _untrained_leaves(state.opt.mu)
    finite = (len(losses) == steps and np.all(np.isfinite(losses))
              and np.all(np.isfinite(gnorms)))
    s_txt = S - (cfg.vlm_prefix or 0)
    reck = _train_reckoning(cfg, out["n_params"], B, s_txt)
    step_s = float(np.median(out["step_s"][1:]))
    flops = _train_flops(cfg, state.params, B, S)
    depth = (f"{cfg.n_layers} of {get_config(F['arch']).n_layers} layers"
             if F["layers"] else f"all {cfg.n_layers} layers")
    extras = (f" + {cfg.enc_seq} stub frames" if cfg.enc_dec else
              f" ({cfg.vlm_prefix} stub patches + {s_txt} tokens)"
              if cfg.vlm_prefix else "")
    log(f"[train families] {cfg.name} at full width, {depth}, "
        f"{out['n_params']:,} parameters (bf16; {cfg.opt_state_dtype} "
        f"moments; remat), {steps} steps of {B} x {S}{extras}: run "
        f"{wall:.1f} s (the first step {out['step_s'][0]:.2f} s); median "
        f"step over steps 2-{steps} {1e3 * step_s:.1f} ms, "
        f"{B * S / step_s:,.0f} positions/s; model FLOPs {flops:.4e} a step "
        f"(6 N D + attention): {flops / step_s / 1e12:.1f} TFLOP/s, "
        f"{100 * flops / step_s / BF16_FLOPS_PER_S:.1f}% of the bf16 dense "
        f"peak; peak memory {peak:.2f} GB (reckoned {reck['total']:.1f} GB: "
        f"state {reck['state']:.1f}, f32 logits and unembedding "
        f"{reck['logits']:.1f}) [{card}]")
    log(f"[train families] {cfg.name}: losses {[round(x, 4) for x in losses]};"
        f" grad norms {[round(x, 4) for x in gnorms]}; optimizer steps "
        f"{int(state.opt.step)}; first-moment leaves never reached "
        f"{dead or 'none'}; hand-kernel launches {launches}")
    if cfg.moe is not None:
        log(f"[train families] {cfg.name}: aux_loss "
            f"{[round(x, 5) for x in out['aux_losses']]}, dropped slot "
            f"fraction {[round(x, 5) for x in out['dropped']]}")
    if cfg.ssm is not None:
        mu = state.opt.mu["blocks"][0]
        log(f"[train families] {cfg.name} at its chunk of {cfg.ssm.chunk} "
            f"(fault (l)): first moments' largest magnitude "
            + ", ".join(f"{k} {float(mu[k].float().abs().max()):.3e}"
                        for k in ("A_log", "dt_bias", "w_dt"))
            + ", every layer's non-zero and finite")
    if peak > 72:
        log(f"[train families] {cfg.name}: peak memory {peak:.2f} GB is over "
            "72 GB")
    if not finite or dead or int(state.opt.step) != steps or any(
            launches.values()):
        raise AssertionError(f"[train families] {cfg.name}: non-finite "
                             f"losses or grad norms, a skipped step, a "
                             f"leaf never trained or a hand kernel launched")
    del state, out


def phase_train_families(dev=torch.device("cuda")) -> None:
    """Phase 20: training the other families (mamba2-370m,
    recurrentgemma-9b, mixtral-8x22b, whisper-tiny, paligemma-3b)."""
    import shutil
    import tempfile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_families_", dir=build)
    try:
        for F in TRAIN_FAMILIES:
            _train_family(F, root, card, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    for F in TRAIN_FAMILIES:
        _train_card_vs_cpu(F["arch"], TRAIN_FAMILY_CPU, card, dev)
    log(f"[train families] phase 20 took {time.perf_counter() - t_phase:.1f}"
        f" s [{card}]")


def _same_value(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b)
    return a == b


def phase_configurator() -> None:
    """Phase 15: ``configure()`` on the card against the same call on the
    CPU (every field of every candidate equal, in order; one cache-scan
    launch a cache size), then at a planner's size."""
    import dataclasses

    from repro_torch.core.configurator import configure
    from repro_torch.core.traffic import TrafficSpec
    t_phase = time.perf_counter()
    kw = dict(CONF_TEST)
    spec = TrafficSpec(**kw.pop("spec"))
    reset_launch_counts()
    card = configure(spec, device="cuda", **kw)
    n_card = launch_counts()["cache_scan"]
    cpu = configure(spec, device="cpu", **kw)
    rows = [[dataclasses.asdict(c) for c in x] for x in (card, cpu)]
    if len(card) != len(cpu) or not all(
            _same_value(a[k], b[k]) for a, b in zip(*rows) for k in a):
        raise AssertionError(f"[configurator] card != cpu:\n{rows[0]}\n"
                             f"{rows[1]}")
    if n_card != len(kw["cache_sizes"]):
        raise AssertionError(f"[configurator] {n_card} cache-scan launches, "
                             f"want {len(kw['cache_sizes'])}")
    log(f"[configurator] test size (poisson, 600 requests, 128 pages, sizes "
        f"{kw['cache_sizes']}, k {kw['k_threads']}, lambda "
        f"{kw['arrival_rate']}): {len(card)} candidates equal to the CPU "
        f"run field for field and in order; {n_card} cache-scan launches")

    kw = dict(CONF_PLAN)
    spec = TrafficSpec(**kw.pop("spec"))
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cands = configure(spec, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = launch_counts()["cache_scan"]
    keys = [(not c.equilibrium, c.predicted_time_s) for c in cands]
    if n != len(kw["cache_sizes"]) or len(cands) != len(
            kw["cache_sizes"]) * len(kw["k_threads"]) or keys != sorted(
            keys) or not all(0.0 <= c.miss_rate <= 1.0 for c in cands):
        raise AssertionError(f"[configurator] planner size: {n} launches, "
                             f"{len(cands)} candidates, order {keys}")
    log(f"[configurator] planner size (irm, 2^20 requests over 2^20 pages, "
        f"30% writes, seed 0; ws; sizes {kw['cache_sizes']} lines, k "
        f"{kw['k_threads']}, lambda {kw['arrival_rate']} req/s): "
        f"{wall:.2f} s, {n} cache-scan launches; frontier (lines, k, miss, "
        f"rho1, rho2, eq, T_pred s): " + "; ".join(
            f"{c.n_lines} {c.k_threads} {c.miss_rate:.4f} {c.rho1:.4f} "
            f"{c.rho2:.3f} {str(c.equilibrium)[0]} {c.predicted_time_s:.2f}"
            for c in cands))
    log(f"[configurator] phase 15 took {time.perf_counter() - t_phase:.1f} s")


def _tier_state_equal(a, b) -> list:
    """The fields of two ``PagedKV`` tier states that differ (integers
    exact, the learner's f32 weights bit for bit)."""
    bad = [f for f in ("page_slot", "t2_slot", "lengths", "t", "t1_reads",
                       "t2_reads", "evictions", "writebacks")
           if not torch.equal(getattr(a, f), getattr(b, f))]
    bad += [f"meta/ols {i}" for i, (x, y) in enumerate(zip(a.meta + a.ols,
                                                           b.meta + b.ols))
            if not torch.equal(x, y)]
    if a.key != b.key:
        bad.append("key")
    if not torch.equal(a.ols.weights.view(torch.int32),
                       b.ols.weights.view(torch.int32)):
        bad.append("weights")
    return bad


def phase_int8_serve(bf16_run: dict, dev=torch.device("cuda")) -> dict:
    """Phase 16: phase 10's serve with int8 KV pools; returns the int8
    keys of the paged-attention, flash-attention and page-copy entries."""
    from repro_torch.kernels import page_gather as pg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain_versions
    from repro_torch.kernels.ref import paged_attention_ref
    from repro_torch.launch import serve
    gc.collect()  # the previous phases' models
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    S = INT8_SERVE
    cfg, params = _build_serve(S, dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (S["requests"], S["prompt"])).astype(np.int32)
    B, steps, L = S["requests"], S["new"] - 1, cfg.n_layers
    common = dict(hbm_fraction=S["hbm_fraction"],
                  promote_every=S["promote_every"], kv_dtype="int8")

    # Capture the last decode step's paged launches at the first and last
    # layers, and the first int8 and scale copies (layer 0's prefill
    # population of tier 2).
    calls = dict(paged=0)
    cap: dict = {}
    paged0, copy0 = pa.paged_attention, pg.page_copy
    last = (steps - 1) * 2 * L

    def paged_hook(q, pool, slot, live, window=0, scale=None):
        if calls["paged"] - last in (0, 1, 2 * L - 2, 2 * L - 1):
            cap.setdefault("paged", []).append(
                (q.clone(), pool, slot.clone(), live.clone(), window, scale))
        calls["paged"] += 1
        return paged0(q, pool, slot, live, window, scale=scale)

    def copy_hook(dst, src, di, si):
        key = "copy_scale" if dst.dtype == torch.float32 else "copy"
        if key not in cap:
            cap[key] = (dst, src.clone(), di.clone(), si.clone())
        return copy0(dst, src, di, si)

    pa.paged_attention, pg.page_copy = paged_hook, copy_hook
    serve.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        run, run_h = _with_hidden(lambda: serve.serve(
            cfg, params, prompts, new=S["new"], **common))
    finally:
        pa.paged_attention, pg.page_copy = paged0, copy0
    launches = serve.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches["flash_attention"] != L or \
            launches["paged_attention"] != 2 * L * steps or \
            not launches["page_copy"] or launches["ssd_scan"] or \
            launches["rglru_scan"]:
        raise AssertionError(f"[int8 serve] launches {launches}, want {L} "
                             f"flash, {2 * L * steps} paged, page copies")
    kv = run.state.kv
    if run.tokens.shape != (B, S["new"]) or not np.isfinite(
            run.logprobs).all() or not ((run.tokens >= 0)
                                        & (run.tokens < cfg.vocab)).all():
        raise AssertionError("[int8 serve] output is not finite tokens / "
                             "logprobs of the expected shape")
    if not (kv.pool1.dtype == kv.pool2.dtype == torch.int8
            and kv.scale1.dtype == kv.scale2.dtype == torch.float32
            and kv.scale1.shape == kv.pool1.shape[:4]
            and kv.scale2.shape == kv.pool2.shape[:4]):
        raise AssertionError("[int8 serve] pools not int8 with f32 scales")
    pool_bytes = sum(p.numel() * p.element_size()
                     for p in (kv.pool1, kv.pool2))
    sc_bytes = sum(p.numel() * 4 for p in (kv.scale1, kv.scale2))
    if 2 * pool_bytes != bf16_run["pool_bytes"]:
        raise AssertionError(f"[int8 serve] pools {pool_bytes} B, not half "
                             f"of phase 10's {bf16_run['pool_bytes']} B")
    bad = _tier_state_equal(kv, bf16_run["kv"])
    if bad:
        raise AssertionError(f"[int8 serve] tier state != phase 10's bf16 "
                             f"run in {bad}")
    gap = float(np.abs(run.logprobs - bf16_run["logprobs"]).max())
    t1, t2 = int(kv.t1_reads[0]), int(kv.t2_reads[0])
    log(f"[int8 serve] {cfg.name} ({_depth(cfg, S)}, bf16 weights, seed 0), "
        f"int8 KV pools, "
        f"{B} requests x {S['prompt']} prompt tokens, {steps} decode steps, "
        f"hbm_fraction {S['hbm_fraction']}: prefill {run.prefill_s:.3f} s, "
        f"decode {run.decode_s:.3f} s ({B * steps / run.decode_s:.1f} tok/s, "
        f"{1e3 * run.decode_s / steps:.2f} ms/step); pools {pool_bytes} B "
        f"(phase 10's bf16 pools {bf16_run['pool_bytes']} B) + scales "
        f"{sc_bytes} B; tier-1 page reads {t1}, tier-2 {t2}, evictions "
        f"{int(kv.evictions[0])}, write-backs {int(kv.writebacks[0])}: tier "
        f"state and learner equal phase 10's bf16 run (integers exact, f32 "
        f"weights bit for bit); launches {launches}; peak memory "
        f"{peak_gb:.1f} GB; logprob gap to phase 10's bf16 run "
        f"{gap:.3e} (information only)")

    # The whole path with the plain versions, fed the kernel run's tokens.
    forced = torch.as_tensor(run.tokens[:, :-1], device=dev)
    serve.reset_launch_counts()
    with plain_versions():
        plain, plain_h = _with_hidden(lambda: serve.serve(
            cfg, params, prompts, new=S["new"], forced=forced, **common))
    if any(serve.launch_counts().values()):
        raise AssertionError("[int8 serve] the plain run launched a kernel")
    bad = _tier_state_equal(kv, plain.state.kv)
    if bad:
        raise AssertionError(f"[int8 serve] kernel run != plain run in {bad}")
    lp_err = float(np.abs(run.logprobs - plain.logprobs).max())
    h_err = _hidden_err(run_h, plain_h)
    # Planted faults on the kernel path over the first CONTROL_STEPS steps:
    # the v scale read for k, and each slot read with the scales of the
    # slot before it (a scale moved to the wrong slot).
    n_ctl = min(CONTROL_STEPS, steps)
    short = dict(new=n_ctl + 1, forced=forced[:, :n_ctl],
                 max_seq=kv.page_slot.shape[1] * cfg.page_size, **common)

    def v_for_k(q, pool, slot, live, window=0, scale=None):
        bad = scale.clone()
        bad[..., 0] = bad[..., 1]
        return paged0(q, pool, slot, live, window, scale=bad)

    def wrong_slot(q, pool, slot, live, window=0, scale=None):
        return paged0(q, pool, slot, live, window, scale=scale.roll(1, 0))
    faults = {}
    for name, fn in (("v scale for k", v_for_k),
                     ("scales one slot off", wrong_slot)):
        pa.paged_attention = fn
        try:
            f_run, f_h = _with_hidden(lambda: serve.serve(
                cfg, params, prompts, **short))
        finally:
            pa.paged_attention = paged0
        faults[name] = (_hidden_err(f_h, plain_h), float(np.abs(
            f_run.logprobs - plain.logprobs[:, :n_ctl + 1]).max()))
        del f_run, f_h
    log(f"[int8 serve, plain path] the same run with the plain versions, "
        f"teacher-forced: prefill {plain.prefill_s:.3f} s, decode "
        f"{plain.decode_s:.3f} s; tier state and learner equal; final hidden "
        f"state |h - h_plain| / |h_plain| largest {h_err:.3e} (tolerance "
        f"{HIDDEN_TOL}); logprobs max |diff| {lp_err:.3e} (tolerance "
        f"{LOGPROB_TOL}); planted faults (kernel path, first {n_ctl} steps): "
        + "; ".join(f"{k} {v[0]:.3e} (logprobs {v[1]:.3e})"
                    for k, v in faults.items()))
    if not h_err <= HIDDEN_TOL:
        raise AssertionError(f"[int8 serve] hidden states differ by {h_err}")
    if not lp_err <= LOGPROB_TOL:
        raise AssertionError(f"[int8 serve] logprobs differ by {lp_err}")
    for name, (e, _) in faults.items():
        if not e > HIDDEN_TOL:
            raise AssertionError(f"[int8 serve] planted fault '{name}' "
                                 f"passes the comparison: {e} <= "
                                 f"{HIDDEN_TOL}")
    del plain, plain_h, run_h

    # The int8 kernel against its plain version on the captured launches,
    # and a planted fault: the plain version without the bf16 rounding.
    pcalls = cap["paged"]
    p_err = 0.0
    for i, (qq, pool, slot, live, window, sc) in enumerate(pcalls):
        got = pa.paged_attention_cuda(qq, pool, slot, live, window, sc)
        want = paged_attention_ref(qq, pool, slot, live, window, sc)
        for g, w, name in zip(got, want, ("acc", "m", "l")):
            e = _rel_err(g, w)
            p_err = max(p_err, e)
            if not e <= PAGED_REL_TOL:
                raise AssertionError(f"[int8 serve] paged kernel != plain in "
                                     f"{name} (call {i}): {e}")
    qq, pool, slot, live, window, sc = pcalls[0]
    unrounded = pool.float() * sc[..., None, None]
    got = pa.paged_attention_cuda(qq, pool, slot, live, window, sc)
    no_round = max(_rel_err(g, w) for g, w in zip(got, paged_attention_ref(
        qq, unrounded, slot, live, window)))
    del unrounded
    if not no_round > PAGED_REL_TOL:
        raise AssertionError(f"[int8 serve] the paged check passes a plain "
                             f"version without the bf16 rounding: "
                             f"{no_round}")
    first = pcalls[:2]
    p_ms, _ = cuda_ms(lambda: [pa.paged_attention_cuda(*c) for c in first],
                      reps=10)
    conv = [_paged_inputs(c) for c in first]
    p_graph = graph_ms(lambda: [pa.paged_attention_cuda(*c) for c in conv])
    pp_ms, _ = cuda_ms(lambda: [paged_attention_ref(*c) for c in first],
                       reps=3)
    pb = _paged_bound(first, cfg.page_size)
    log(f"[int8 serve, paged vs plain] last decode step, layers 0 and "
        f"{L - 1}, tier 1 and tier 2: largest |diff| / largest |plain| of "
        f"acc, m, l {p_err:.3e} (tolerance {PAGED_REL_TOL}); planted fault "
        f"(plain without the bf16 rounding) {no_round:.3e}; layer 0, both "
        f"tiers: kernel {p_ms:.4f} ms in a loop of calls, {p_graph:.4f} ms "
        f"from a CUDA graph of its launches alone, plain {pp_ms:.3f} ms, "
        f"{fmt_bound(pb)}")

    # Page copy on int8 slots and on scale rows, byte for byte: layer 0's
    # prefill population of tier 2 (pages, then scales) and a whole-slot
    # write-back of resident slots (pools, then scales).
    res = (kv.page_slot >= 0).reshape(-1).nonzero().reshape(-1)[:8]
    wb_dst = kv.t2_slot.reshape(-1)[res]
    wb_src = kv.page_slot.reshape(-1)[res]
    cases = [(f"prefill population ({k})", whole, *cap[k])
             for k, whole in (("copy", kv.pool2), ("copy_scale", kv.scale2))]
    cases += [(f"write-back ({lo.dtype})", up, up, lo, wb_dst, wb_src)
              for lo, up in ((kv.pool1, kv.pool2), (kv.scale1, kv.scale2))]
    check_page_copy("int8 serve", cases)
    dst, src, di, si = cap["copy"]
    row_bytes = dst[0].numel() * dst.element_size()
    copy_times = page_copy_times("int8 serve", kv.pool2, dst, src, di, si)
    log(f"[int8 serve, page copy vs plain] layer 0's prefill population "
        f"({_live_pairs(di, si)} int8 pages of {row_bytes} B and their "
        f"scale rows "
        f"of {cap['copy_scale'][0][0].numel() * 4} B into tier 2) and a "
        f"whole-slot write-back ({len(res)} slots of "
        f"{kv.pool1[0].numel()} B and their scales of "
        f"{kv.scale1[0].numel() * 4} B): equal byte for byte")
    # The scale rows' population, timed as the pages' is.
    scale_times = page_copy_times("int8 serve, scale rows", kv.scale2,
                                  *cap["copy_scale"])
    _profile_decode(cfg, params, run, S, dev, tag="int8 serve",
                    kv_dtype="int8")
    log(f"[int8 serve] phase 16 took {time.perf_counter() - t_phase:.1f} s "
        f"[{card_line()}]")
    del run, params
    return dict(
        paged_attention=dict(
            int8_launches=launches["paged_attention"],
            int8_max_abs_err=p_err, int8_ms=p_ms, int8_ms_graph=p_graph,
            int8_plain_ms=pp_ms, int8_bound_ms=pb["bound_ms"],
            int8_bound_by=pb["bound_by"], int8_bound_terms=pb["bound_terms"],
            int8_no_bf16_rounding_err=no_round,
            int8_shape=f"both tiers of layer 0 at the last decode step, "
                       f"int8 pools {list(kv.pool1.shape)} / "
                       f"{list(kv.pool2.shape)} with f32 scales"),
        flash_attention=dict(int8_launches=launches["flash_attention"]),
        page_copy=dict({f"int8_{k}": v for k, v in copy_times.items()},
                       **{f"int8_scale_{k}": v
                          for k, v in scale_times.items()},
                       int8_launches=launches["page_copy"]))


def _sdpa_mask(q, k, kw) -> dict:
    """Arguments of the one PyTorch call that computes the flash call
    ``kw`` on q, k (the yardstick, never used by the port): no mask
    without ``causal``; ``is_causal`` where neither a window shorter than
    the sequence nor a prefix changes the causal mask; else a boolean
    mask of the visible pairs."""
    Sq, Skv = q.shape[2], k.shape[2]
    window, prefix = kw.get("window"), kw.get("prefix_len", 0)
    if not kw.get("causal", True):
        return dict(enable_gqa=True)
    if not prefix and (window is None or window >= Sq):
        return dict(is_causal=True, enable_gqa=True)
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Skv, device=q.device)[None, :]
    vis = j <= i
    if window is not None:
        vis &= j > i - window
    return dict(attn_mask=vis | (j < prefix), enable_gqa=True)


def _flash_vs_plain(tag: str, name: str, call, dev) -> dict:
    """The flash kernel against its plain version on one captured call,
    element by element within one bf16 step; its time, the plain
    version's, the bound and SDPA's; returns those numbers."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref
    q, k, v, kw = call
    fa.flash_attention_cuda(q, k, v, **kw)  # warm-up
    f_ms, got = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                        reps=3)
    fp_ms, want = cuda_ms(lambda: attention_ref(q, k, v, **kw))
    f_err = float((got.float() - want.float()).abs().max())
    f_rel = float(((got.float() - want.float()).abs()
                   / (want.float().abs() + 1)).max())
    f_exc = _bf16_step_excess(got, want)
    out = dict(ms=f_ms, plain_ms=fp_ms, max_abs_err=f_err, exc=f_exc)
    if kw.get("prefix_len"):
        # A planted fault: the plain version with the prefix mask dropped
        # (plain causal attention) must fail the bar.
        no_prefix = attention_ref(q, k, v, causal=True,
                                  window=kw.get("window"))
        out["no_prefix_exc"] = _bf16_step_excess(got, no_prefix)
        del no_prefix
        if not out["no_prefix_exc"] > 1:
            raise AssertionError(f"[{tag}] the flash check passes a plain "
                                 f"version without the prefix mask")
    del got, want
    if not (f_rel <= FLASH_TOL and f_exc <= 1):
        raise AssertionError(f"[{tag}] flash kernel != plain ({name}): "
                             f"{f_err} (rel {f_rel}, element-wise {f_exc})")
    sdpa = _sdpa_mask(q, k, kw)
    F_ = torch.nn.functional
    F_.scaled_dot_product_attention(q, k, v, **sdpa)
    out["library_ms"], _ = cuda_ms(
        lambda: F_.scaled_dot_product_attention(q, k, v, **sdpa), reps=3)
    lib = ("SDPA" + (", is_causal" if sdpa.get("is_causal") else "")
           + (", boolean mask" if "attn_mask" in sdpa else ""))
    del sdpa
    fb = _flash_bound(q, k, kw.get("window"), kw.get("causal", True),
                      kw.get("prefix_len", 0))
    out.update(bound_ms=fb["bound_ms"], bound_by=fb["bound_by"],
               bound_terms=fb["bound_terms"],
               shape=f"q {list(q.shape)}, k/v {list(k.shape)}, " + ", ".join(
                   f"{a}={b}" for a, b in kw.items()) + ", bf16")
    log(f"[{tag}, flash vs plain] {name}: {out['shape']}: max |diff| "
        f"{f_err:.3e}, |diff| / (|plain| + 1) {f_rel:.3e} (tolerance "
        f"{FLASH_TOL}), element-wise {f_exc:.3f} of its bar (1)"
        + (f", the plain version without the prefix mask "
           f"{out['no_prefix_exc']:.3f}" if "no_prefix_exc" in out else "")
        + f"; kernel {f_ms:.3f} ms, plain {fp_ms:.1f} ms, {lib} "
        f"{out['library_ms']:.3f} ms, {fmt_bound(fb)}")
    return out


def phase_family_serve(S: dict, dev=torch.device("cuda")) -> dict:
    """Phases 17-19: whisper-tiny (encoder-decoder), paligemma-3b (VLM
    prefix) or mixtral-8x22b (MoE, depth cut) served at full width through
    ``repro_torch.launch.serve`` as phase 10 serves mistral: launches
    counted; the whole serve again with the plain versions, teacher-forced
    (tier state equal, hidden states and logprobs within the phase's bars
    against its measured noise floor, planted faults above them); each
    flash call of the path (whisper: the encoder, the cross- and the
    causal self-attention; paligemma: prefix-LM; mixtral: the window),
    paged attention and page copy against their plain versions on
    captured inputs. Returns the flash, paged and page-copy entries' keys
    at this model's shapes."""
    import dataclasses
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import page_gather as pg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.attention import blockwise_attention
    from repro_torch.serving import engine as eng
    gc.collect()  # the previous phases' models
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    tag = S["tag"]
    cfg, params = _build_serve(S, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    B, steps, L = S["requests"], S["new"] - 1, cfg.n_layers
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (B, S["prompt"])).astype(np.int32)
    extras = serve.make_extras(cfg, B, rng, dev)
    n_pos = cfg.vlm_prefix + S["prompt"] + S["new"]
    S = dict(S, extras=extras,
             max_seq=-(-n_pos // cfg.page_size) * cfg.page_size)

    # Captures from the kernel run: each kind of flash call (the first of
    # each), the last decode step's two paged launches of layer 0, the
    # first prefill population, and the MoE's dropped fractions at prefill.
    cap: dict = dict(flash={}, dropped=[])
    n_flash: dict = {}
    calls = dict(paged=0)
    last = (steps - 1) * 2 * L
    flash0, paged0, copy0 = fa.flash_attention, pa.paged_attention, \
        pg.page_copy
    moe0, cross0 = moe.moe_swiglu, eng._decode_cross_attention

    def flash_hook(q, k, v, **kw):
        kind = ("self" if kw.get("causal", True) else
                "enc" if q.shape[2] == k.shape[2] else "cross")
        cap["flash"].setdefault(kind, (q.clone(), k.clone(), v.clone(), kw))
        n0 = fa.flash_attention_launch_count()
        out = flash0(q, k, v, **kw)
        n_flash[kind] = n_flash.get(kind, 0) + (
            fa.flash_attention_launch_count() - n0)
        return out

    def paged_hook(q, pool, slot, live, window=0, scale=None):
        if calls["paged"] - last in (0, 1):
            cap.setdefault("paged", []).append(
                (q.clone(), pool, slot.clone(), live.clone(), window))
        calls["paged"] += 1
        return paged0(q, pool, slot, live, window, scale=scale)

    def copy_hook(dst, src, di, si):
        if "copy" not in cap:
            cap["copy"] = (dst, src.clone(), di.clone(), si.clone())
        return copy0(dst, src, di, si)

    def moe_hook(x, *w, **kw):
        out = moe0(x, *w, **kw)
        if x.shape[0] > B and len(cap["dropped"]) < L:  # the prefill's
            cap["dropped"].append(float(out.dropped))
        return out

    def cross_hook(x, p, cfg_, ck, cv, *a):
        cap.setdefault("cross", (x.clone(), p, cfg_, ck, cv))
        return cross0(x, p, cfg_, ck, cv, *a)

    fa.flash_attention, pa.paged_attention, pg.page_copy = (
        flash_hook, paged_hook, copy_hook)
    moe.moe_swiglu, eng._decode_cross_attention = moe_hook, cross_hook
    try:
        run, run_h, launches, plain, plain_h, forced, peak = _serve_pair(
            tag, cfg, params, prompts, S, dev)
    finally:
        fa.flash_attention, pa.paged_attention, pg.page_copy = (
            flash0, paged0, copy0)
        moe.moe_swiglu, eng._decode_cross_attention = moe0, cross0
    n_enc = cfg.n_enc_layers if cfg.enc_dec else 0
    want = dict(flash_attention=L + n_enc + (L if cfg.enc_dec else 0),
                paged_attention=2 * L * steps, ssd_scan=0, rglru_scan=0)
    if any(launches[k] != v for k, v in want.items()) or \
            not launches["page_copy"]:
        raise AssertionError(f"[{tag}] launches {launches}, want {want} and "
                             "page copies")
    kv, pkv = run.state.kv, plain.state.kv
    bad = _tier_state_equal(kv, pkv)
    if bad:
        raise AssertionError(f"[{tag}] kernel run != plain run in {bad}")
    if not (kv.lengths == cfg.vlm_prefix + S["prompt"] + steps).all():
        raise AssertionError(f"[{tag}] lengths {kv.lengths.tolist()}")
    spec = eng.make_kv_spec(cfg, eng.ServeConfig(
        max_seq=S["max_seq"], batch_local=B, hbm_fraction=S["hbm_fraction"]))
    rec_err = _rec_err(run.state, plain.state)
    drop = cap["dropped"]
    log(f"[{tag}] {_depth(cfg, S)} at full width (d {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads}, hd {cfg.head_dim}); "
        f"init {init_s:.1f} s; "
        + "".join(f"{k} {list(v.shape)}, " for k, v in extras.items())
        + f"{spec.n_pages} pages a sequence, {spec.hbm_slots} tier-1 and "
        f"{spec.t2_slots} tier-2 slots, read window {spec.read_pages} pages; "
        f"tier-1 page reads {int(kv.t1_reads[0])}, tier-2 "
        f"{int(kv.t2_reads[0])}, evictions {int(kv.evictions[0])}, "
        f"write-backs {int(kv.writebacks[0])}; OL weights "
        f"{kv.ols.weights.tolist()}; tier state and learner equal to the "
        f"plain run's (integers exact, f32 weights bit for bit); flash "
        f"launches by kind {n_flash}"
        + (f"; cross-attention keys and values after the prefill, kernel "
           f"run vs plain run: largest |diff| / largest |plain| "
           f"{rec_err:.3e}" if cfg.enc_dec else "")
        + (f"; prefill's dropped (token, k) slots, capacity factor "
           f"{cfg.moe.capacity_factor}: {min(drop):.4f}..{max(drop):.4f} "
           f"over {len(drop)} layers (mean {np.mean(drop):.4f})"
           if cfg.moe is not None else ""))
    q = S.get("quantile")
    h_err = _hidden_err(run_h, plain_h, q)
    lp_err = _lp_err(run.logprobs, plain.logprobs, q)
    log(f"[{tag}, plain path] kernel run vs plain run, final hidden state "
        f"|h - h_plain| / |h_plain| over {steps + 1} steps x {B} sequences, "
        f"quantiles 0.5 / 0.9 / 0.99 / largest: " + " / ".join(
            f"{_hidden_err(run_h, plain_h, x):.3e}" for x in (0.5, 0.9, 0.99,
                                                              None))
        + "; logprobs |diff|: " + " / ".join(
            f"{_lp_err(run.logprobs, plain.logprobs, x):.3e}"
            for x in (0.5, 0.9, 0.99, None)))

    # The noise floor (the plain path with blockwise prefill attention) and
    # the planted faults on the kernel path, over CONTROL_STEPS steps.
    def blockwise(q, k, v, **kw):
        return blockwise_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), **kw).transpose(1, 2)
    runs = {"noise floor (plain, blockwise prefill attention)": (
        lambda: setattr(fa, "flash_attention", blockwise),
        lambda: setattr(fa, "flash_attention", flash0), True)}
    if cfg.enc_dec:
        seen = dict(n=0)

        def zero_layer0(x, p, cfg_, ck, cv, *a):
            seen["n"] += 1
            if seen["n"] % L == 1:  # the first decoder layer of each step
                ck, cv = torch.zeros_like(ck), torch.zeros_like(cv)
            return cross0(x, p, cfg_, ck, cv, *a)
        runs["fault: layer 0's cross-attention keys and values zeroed"] = (
            lambda: setattr(eng, "_decode_cross_attention", zero_layer0),
            lambda: setattr(eng, "_decode_cross_attention", cross0), False)
    if cfg.vlm_prefix:
        def no_prefix(q, k, v, **kw):
            return flash0(q, k, v, **dict(kw, prefix_len=0))
        runs["fault: prefix mask dropped at prefill"] = (
            lambda: setattr(fa, "flash_attention", no_prefix),
            lambda: setattr(fa, "flash_attention", flash0), False)
    if cfg.moe is not None:
        def top1(x, *w, **kw):
            *ws, mc = w
            return moe0(x, *ws, dataclasses.replace(mc, top_k=1), **kw)
        runs["fault: top-1 routing instead of top-2"] = (
            lambda: setattr(moe, "moe_swiglu", top1),
            lambda: setattr(moe, "moe_swiglu", moe0), False)
    n_ctl = min(CONTROL_STEPS, steps)
    short = _short_runs(cfg, params, prompts, S, forced, plain_h,
                        plain.logprobs, runs, n_ctl, q=q)
    control = {k: v for k, v in short.items() if k.startswith("noise")}
    faults = {k: v for k, v in short.items() if k.startswith("fault")}
    _check_bars(tag, h_err, lp_err, control, faults, n_ctl,
                tol=S["hidden_tol"], lp_tol=S.get("logprob_tol", LOGPROB_TOL),
                stat="largest" if q is None else f"{q}-quantile")
    del plain, plain_h, pkv, run_h

    # Each kind of flash call against the plain version.
    names = dict(enc="encoder (full attention)",
                 cross="prefill cross-attention (full, Sq != Skv)",
                 self="layer 0's causal self-attention")
    flash = {}
    for kind, call in cap["flash"].items():
        flash[kind] = _flash_vs_plain(tag, names[kind], call, dev)
        flash[kind]["launches"] = n_flash.get(kind, 0)
    del cap["flash"]

    # Paged: both tiers of layer 0 at the last decode step.
    pcalls = cap["paged"]
    p_err = max(_rel_err(g, w) for c in pcalls for g, w in zip(
        pa.paged_attention_cuda(*c), paged_attention_ref(*c)))
    if not p_err <= PAGED_REL_TOL:
        raise AssertionError(f"[{tag}] paged kernel != plain: {p_err}")
    p_ms, _ = cuda_ms(lambda: [pa.paged_attention_cuda(*c) for c in pcalls],
                      reps=10)
    conv = [_paged_inputs(c) for c in pcalls]
    p_graph = graph_ms(lambda: [pa.paged_attention_cuda(*c) for c in conv])
    pp_ms, _ = cuda_ms(lambda: [paged_attention_ref(*c) for c in pcalls],
                       reps=3)
    pb = _paged_bound(pcalls, cfg.page_size)
    n_split = pa.split_plan(B, cfg.n_kv_heads, pcalls[0][2].shape[1],
                            cfg.page_size)
    log(f"[{tag}, paged vs plain] last decode step, layer 0, both tiers, q "
        f"{list(pcalls[0][0].shape)}, window {pcalls[0][4]}: largest |diff| "
        f"/ largest |plain| {p_err:.3e} (tolerance {PAGED_REL_TOL}); "
        f"(n_split, span) {n_split}: kernel {p_ms:.4f} ms in a loop of "
        f"calls, {p_graph:.4f} ms from a CUDA graph of its launches alone, "
        f"plain {pp_ms:.3f} ms, {fmt_bound(pb)}")

    # Page copy: the first prefill population, byte for byte.
    dst, src, di, si = cap["copy"]
    whole = kv.pool2
    check_page_copy(tag, [("prefill population", whole, dst, src, di, si)])
    copy_times = page_copy_times(tag, whole, dst, src, di, si)
    log(f"[{tag}, page copy vs plain] prefill population of layer 0 into "
        f"tier 2 ({_live_pairs(di, si)} pages of "
        f"{dst[0].numel() * dst.element_size()} B): equal byte for byte")

    if cfg.enc_dec:  # the plain cross-attention of a decode step
        x, p, cfg_, ck, cv = cap["cross"]
        x_ms, _ = cuda_ms(lambda: cross0(x, p, cfg_, ck, cv), reps=20)
        # Launches counted on the host side (the runtime's launch calls):
        # a short trace after the earlier phases' traces may miss device
        # events.
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            cross0(x, p, cfg_, ck, cv)
            torch.cuda.synchronize()
        n_k = sum(e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                  for e in prof.events())
        log(f"[{tag}, decode cross-attention] plain PyTorch over the stored "
            f"keys and values {list(ck.shape)}: {n_k} kernel launches and "
            f"{x_ms:.4f} ms a layer, {L} layers a decode step")
    _profile_decode(cfg, params, run, S, dev, tag=tag)
    log(f"[{tag}] prefill {run.prefill_s:.3f} s, decode "
        f"{1e3 * run.decode_s / steps:.2f} ms/step; peak memory {peak:.1f} "
        f"GB; phase took {time.perf_counter() - t_phase:.1f} s "
        f"[{card_line()}]")
    del run, params, cap
    key = S["key"]
    out = dict(flash_attention={}, paged_attention=dict(
        {f"{key}_launches": launches["paged_attention"],
         f"{key}_max_abs_err": p_err, f"{key}_ms": p_ms,
         f"{key}_ms_graph": p_graph, f"{key}_plain_ms": pp_ms,
         f"{key}_bound_ms": pb["bound_ms"], f"{key}_bound_by": pb["bound_by"],
         f"{key}_library_ms": None,
         f"{key}_shape": f"both tiers of layer 0 at the last decode step, q "
                         f"{list(pcalls[0][0].shape)}, pools "
                         f"{list(kv.pool1.shape)} / {list(kv.pool2.shape)}"}),
        page_copy=dict({f"{key}_{k}": v for k, v in copy_times.items()},
                       **{f"{key}_launches": launches["page_copy"]}))
    for kind, f in flash.items():
        fk = S["flash_keys"][kind]
        out["flash_attention"].update({
            f"{fk}_{n}": f[n] for n in (
                "launches", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "shape")})
    return out


def _clone(x):
    """A copy of a decode state's tensors (in tuples, lists and dicts)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _sharded_run(prefill, decode, params, prompts, forced, steps: int,
                 spec, S: dict, n_promote: int, state0=None) -> dict:
    """This rank's prefill (or a copy of ``state0``, a prefill's state) and
    ``steps`` teacher-forced decode steps (pages promoted every
    ``promote_every`` steps), each step timed from a synchronized card to
    a synchronized card, with the final hidden state that each step
    unembeds and the collectives of each step; ``state0`` in the result
    is a copy of the prefill's state."""
    from repro_torch.distributed import axes as dax
    from repro_torch.serving import engine as eng
    from repro_torch.serving import kvpool as kvp
    hidden, lps, toks, ms, coll = [], [], [], [], []
    unembed0 = eng.unembed_greedy

    def hook(x, w, *a):
        hidden.append(x.float())
        return unembed0(x, w, *a)
    eng.unembed_greedy = hook
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if state0 is None:
            state, (tok, lp) = prefill(params, prompts)
            state0 = _clone(state)
            toks.append(tok)
            lps.append(lp)
        else:
            state = _clone(state0)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        for t in range(steps):
            dax.reset_collective_stats()
            t0 = time.perf_counter()
            state, (tok, lp) = decode(params, state, forced[:, t])
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            coll.append(dax.collective_stats())
            toks.append(tok)
            lps.append(lp)
            if state.kv is not None and (
                    t % S["promote_every"] == S["promote_every"] - 1):
                state = state._replace(kv=kvp.promote_pages(
                    state.kv, spec, n_promote))
    finally:
        eng.unembed_greedy = unembed0
    return dict(state=state, state0=state0,
                hidden=torch.stack(hidden).cpu(),
                lp=torch.stack(lps, 1).float().cpu().numpy(),
                tok=torch.stack(toks, 1).cpu().numpy(), ms=ms, coll=coll,
                prefill_s=prefill_s)


def _kv_ints(kv) -> dict:
    out = dict(page_slot=kv.page_slot, t2_slot=kv.t2_slot,
               lengths=kv.lengths, t=kv.t, t1_reads=kv.t1_reads,
               t2_reads=kv.t2_reads, evictions=kv.evictions,
               writebacks=kv.writebacks, key=torch.tensor(kv.key),
               weights=kv.ols.weights.view(torch.int32))
    for name, x in zip(kv.meta._fields, kv.meta):
        out["meta_" + name] = x
    for name, x in zip(kv.ols._fields, kv.ols):
        out["ols_" + name] = x
    return {k: v.cpu().numpy().copy() for k, v in out.items()}


def _sharded_rank(rank: int, dev, S: dict, prompts, forced) -> dict:
    """One rank of phase 21: its shards of mistral-nemo-12b, the kernel
    run (collectives timed), the plain run and the faulted run, each
    teacher-forced on the one-card run's tokens; rank 0 also holds each
    serving kernel against its plain version at the sharded shapes."""
    from repro_torch.distributed import axes as dax
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import page_gather as pg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain_versions
    from repro_torch.kernels.ref import (attention_ref, page_copy_ref,
                                         paged_attention_ref)
    from repro_torch.launch import serve, spmd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import Partial
    from repro_torch.serving import engine as eng
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(*S["mesh"])
    t0 = time.perf_counter()
    cfg, full = _build_serve(S, dev)
    sc = eng.ServeConfig(
        max_seq=S["max_seq"], batch_local=S["requests"] // mesh.size("data"),
        page_axes=S["page_axes"], mapping=S["mapping"],
        hbm_fraction=S["hbm_fraction"])
    prefill, decode, specs = spmd.build_serve(cfg, mesh, sc)
    params = spmd.shard_for_rank(full, cfg, mesh)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = spmd.local_batch(torch.as_tensor(prompts), specs)
    forced = spmd.local_batch(torch.as_tensor(forced), specs).to(dev)
    steps, L = forced.shape[1], cfg.n_layers
    args = (prefill, decode, params, prompts, forced)

    # The kernel run: launches counted, kernel inputs captured (layer 0's
    # prefill flash call, its two paged launches at the last step, the
    # first prefill copy) and every tier-2 table of layer 0 kept for (c).
    cap: dict = dict(t2=[])
    calls = dict(paged=0)
    flash0, paged0, copy0 = fa.flash_attention, pa.paged_attention, \
        pg.page_copy

    def flash_hook(q, k, v, **kw):
        cap.setdefault("flash", (q.clone(), k.clone(), v.clone(), kw))
        return flash0(q, k, v, **kw)

    def paged_hook(q, pool, slot, live, window=0, scale=None):
        i = calls["paged"]
        calls["paged"] += 1
        if i % (2 * L) == 1:
            cap["t2"].append(slot.clone())
        if i - (steps - 1) * 2 * L in (0, 1):
            cap.setdefault("paged", []).append(
                (q.clone(), pool, slot.clone(), live.clone(), window))
        return paged0(q, pool, slot, live, window, scale=scale)

    def copy_hook(dst, src, di, si):
        cap.setdefault("copy", (dst, src.clone(), di.clone(), si.clone()))
        return copy0(dst, src, di, si)

    fa.flash_attention, pa.paged_attention, pg.page_copy = (
        flash_hook, paged_hook, copy_hook)
    serve.reset_launch_counts()
    dax.time_collectives(True)
    try:
        run = _sharded_run(*args, steps, specs.kv_spec, S, sc.n_promote)
    finally:
        dax.time_collectives(False)
        fa.flash_attention, pa.paged_attention, pg.page_copy = (
            flash0, paged0, copy0)
    launches = serve.launch_counts()
    kv = run["state"].kv
    t2_tables = [t.cpu() for t in cap.pop("t2")]
    kernels = {}
    if rank == 0:
        q, k, v, kw = cap["flash"]
        fa.flash_attention_cuda(q, k, v, **kw)
        f_ms, got = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                            reps=3)
        fp_ms, want = cuda_ms(lambda: attention_ref(q, k, v, **kw))
        f_exc = _bf16_step_excess(got, want)
        sdpa = dict(is_causal=True, enable_gqa=True)
        f_lib, _ = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, **sdpa), reps=3)
        fb = _flash_bound(q, k)
        kernels["flash_attention"] = dict(
            max_abs_err=float((got.float() - want.float()).abs().max()),
            bf16_step_excess=f_exc, ms=f_ms, plain_ms=fp_ms,
            library_ms=f_lib, bound_ms=fb["bound_ms"],
            bound_by=fb["bound_by"],
            shape=f"q {list(q.shape)}, k/v {list(k.shape)}, causal, bf16")
        del got, want
        first = cap["paged"]
        p_err = 0.0
        for c in first:
            for g, w in zip(pa.paged_attention_cuda(*c),
                            paged_attention_ref(*c)):
                p_err = max(p_err, _rel_err(g, w))
        p_ms, _ = cuda_ms(lambda: [pa.paged_attention_cuda(*c)
                                   for c in first], reps=10)
        pp_ms, _ = cuda_ms(lambda: [paged_attention_ref(*c) for c in first],
                           reps=3)
        pb = _paged_bound(first, cfg.page_size)
        kernels["paged_attention"] = dict(
            max_abs_err=p_err, ms=p_ms, plain_ms=pp_ms,
            bound_ms=pb["bound_ms"], bound_by=pb["bound_by"],
            shape=f"both tiers of layer 0 at the last decode step, q "
                  f"{list(first[0][0].shape)}, pools {list(kv.pool1.shape)}"
                  f" / {list(kv.pool2.shape)} bf16, owned pages only")
        dst, src, di, si = cap["copy"]
        check_page_copy("sharded serve", (
            ("prefill population", kv.pool2, dst, src, di, si),))
        di_c, si_c = pg.card_index(dev, di, si)
        pg.page_copy_cuda(dst, src, di_c, si_c)
        c_ms, _ = cuda_ms(lambda: pg.page_copy_cuda(dst, src, di_c, si_c),
                          reps=5)
        cp_ms, _ = cuda_ms(lambda: page_copy_ref(dst, src, di, si))
        live = (di_c >= 0) & (si_c >= 0)
        dl, sl = di_c[live].long(), si_c[live].long()
        lib_ms, _ = cuda_ms(lambda: dst.__setitem__(dl, src[sl]), reps=5)
        row_bytes = dst[0].numel() * dst.element_size()
        cb = _copy_bound(_live_pairs(di, si), row_bytes)
        kernels["page_copy"] = dict(
            max_abs_err=0.0, ms=c_ms, plain_ms=cp_ms, library_ms=lib_ms,
            bound_ms=cb["bound_ms"], bound_by=cb["bound_by"],
            shape=f"{_live_pairs(di, si)} owned rows of {row_bytes} B into "
                  f"one layer of tier 2 (prefill population)")
    cap.clear()

    # The plain run, and the planted fault on the kernel path: page shard
    # 1's partial dropped from the combine (every rank patches; the ranks
    # of page shard 1 send the empty partial).
    with plain_versions():
        plain = _sharded_run(*args, steps, specs.kv_spec, S, sc.n_promote)
    comb0 = eng.combine_shards

    def drop(part, ax, names):
        if specs.page_shard == 1:
            part = Partial(torch.zeros_like(part.acc),
                           torch.full_like(part.m, -1e30),
                           torch.zeros_like(part.l))
        return comb0(part, ax, names)
    eng.combine_shards = drop
    try:
        bad = _sharded_run(prefill, decode, params, prompts,
                           forced[:, :S["fault_steps"]], S["fault_steps"],
                           specs.kv_spec, S, sc.n_promote,
                           state0=run.pop("state0"))
    finally:
        eng.combine_shards = comb0
    plain.pop("state0")
    bad.pop("state0")
    return dict(
        rank=rank, coords=mesh.coords(), backend=mesh.backend,
        batch_shard=specs.batch_shard, page_shard=specs.page_shard,
        init_s=init_s, launches=launches, kernels=kernels,
        t2_tables=t2_tables, owned=(kv.t2_slot >= 0).numpy(),
        t2_slot=kv.t2_slot.numpy(), kv=_kv_ints(kv),
        kv_plain=_kv_ints(plain["state"].kv),
        **{f"{name}_{k}": v for name, r in (("run", run), ("plain", plain),
                                            ("bad", bad))
           for k, v in r.items() if k != "state"})


def phase_sharded_serve(dev=torch.device("cuda"), train: bool = True
                        ) -> tuple:
    """Phase 21: mistral-nemo-12b served by 4 ranks sharing the card, on a
    (data 2, model 2) mesh with page_axes ("model",): (a) the kernel run
    against the plain run of the same sharded steps, (b) against the
    one-card serve of the same configuration and depth, (c) every page has
    one owner and each rank reads from tier 2 only the pages it owns, (d)
    a planted fault (a page shard's partial dropped) above the bar.
    Returns the serving kernels' ``sharded_`` keys and, with ``train``,
    phase 22's results from the same ranks (``phase_sharded_train``'s
    input; else None)."""
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    S = dict(SHARDED_SERVE, fault_steps=SHARDED_FAULT_STEPS)
    tag = "sharded serve"
    steps = S["new"] - 1
    t_phase = time.perf_counter()
    cfg, params = _build_serve(S, dev)
    prompts = np.random.default_rng(21).integers(
        0, cfg.vocab, (S["requests"], S["prompt"])).astype(np.int32)
    S["max_seq"] = -(-(S["prompt"] + S["new"]) // cfg.page_size) * \
        cfg.page_size
    # The one-card serve of the same configuration and depth: the tokens
    # every sharded run is fed, and the reference of check (b).
    serve.reset_launch_counts()
    one, one_h = _with_hidden(lambda: serve.serve(
        cfg, params, prompts, new=S["new"], hbm_fraction=S["hbm_fraction"],
        promote_every=S["promote_every"], max_seq=S["max_seq"]))
    forced = one.tokens[:, :-1]
    one_lp, one_ms = one.logprobs, 1e3 * one.decode_s / steps
    del params, one
    gc.collect()
    torch.cuda.empty_cache()
    n_ranks = int(np.prod(S["mesh"][0]))
    backend = backend_for(dev, n_ranks)
    t0 = time.perf_counter()
    if train:
        ranks = spawn_ranks(_sharded_ranks, n_ranks,
                            (S, prompts, forced, SHARDED_TRAIN,
                             SHARDED_TRAIN_PARITY), device="cuda")
    else:
        ranks = spawn_ranks(_sharded_rank, n_ranks, (S, prompts, forced),
                            device="cuda")
    ranks_s = time.perf_counter() - t0
    trained = [r.pop("train") for r in ranks] if train else None
    B_loc = S["requests"] // S["mesh"][0][0]

    # (a) kernel run against plain run, rank by rank; (b) against the
    # one-card run; (d) the planted fault against the plain run.
    a_h = a_lp = b_h = b_lp = d_h = 0.0
    for r in ranks:
        if r["backend"] != backend:
            raise AssertionError(f"[{tag}] rank {r['rank']} ran "
                                 f"{r['backend']}, the rule says {backend}")
        for k, v in r["kv"].items():
            if not np.array_equal(v, r["kv_plain"][k]):
                raise AssertionError(f"[{tag}] rank {r['rank']}: kernel run "
                                     f"!= plain run in {k}")
        a_h = max(a_h, _hidden_err(r["run_hidden"], r["plain_hidden"]))
        a_lp = max(a_lp, _lp_err(r["run_lp"], r["plain_lp"]))
        rows = slice(r["batch_shard"] * B_loc, (r["batch_shard"] + 1) * B_loc)
        b_h = max(b_h, _hidden_err(r["run_hidden"], one_h[:, rows].cpu()))
        b_lp = max(b_lp, _lp_err(r["run_lp"], one_lp[rows]))
        # The faulted run starts from the prefill's state: its steps are
        # the plain run's from the second hidden state on.
        d_h = max(d_h, _hidden_err(r["bad_hidden"], r["plain_hidden"][1:]))
        ln = r["launches"]
        if not (ln["flash_attention"] == cfg.n_layers and
                ln["paged_attention"] == 2 * cfg.n_layers * steps and
                ln["page_copy"] > 0):
            raise AssertionError(f"[{tag}] rank {r['rank']} launches {ln}")
    # Tokens and logprobs equal across the ranks of a batch shard.
    for r in ranks:
        for o in ranks:
            if o["batch_shard"] == r["batch_shard"] and not (
                    np.array_equal(o["run_tok"], r["run_tok"])
                    and np.array_equal(o["run_lp"], r["run_lp"])):
                raise AssertionError(f"[{tag}] ranks {r['rank']} and "
                                     f"{o['rank']} disagree on tokens")
    # (c) one owner a page; tier-2 reads of owned pages only.
    n_reads = 0
    for shard in {r["batch_shard"] for r in ranks}:
        grp = [r for r in ranks if r["batch_shard"] == shard]
        if not (np.sum([r["owned"] for r in grp], 0) == 1).all():
            raise AssertionError(f"[{tag}] a page without exactly one owner")
        for r in grp:
            for t in r["t2_tables"]:
                on = t.numpy() >= 0
                n_reads += int(on.sum())
                if not (r["owned"][on].all() and np.array_equal(
                        t.numpy()[on], r["t2_slot"][on])):
                    raise AssertionError(f"[{tag}] rank {r['rank']} read a "
                                         f"page it does not own from tier 2")
    control = {"noise floor (a): kernel vs plain, sharded": (a_h, a_lp)}
    log(f"[{tag}] {cfg.name} ({_depth(cfg, S)}) on {n_ranks} ranks sharing "
        f"the card ({card_line()}), mesh {S['mesh'][0]} "
        f"{S['mesh'][1]}, page_axes {S['page_axes']}, {S['mapping']}, "
        f"backend {backend}: {S['requests']} x {S['prompt']} prompts, "
        f"{steps} decode steps; one-card run {one_ms:.2f} ms/step; ranks "
        f"spawned and done in {ranks_s:.1f} s"
        f"{' (with phase 22 after the serve)' if train else ''}; tier-2 "
        f"reads of layer 0 "
        f"checked: {n_reads}, all owned")
    for r in ranks:
        per = [sum(v[2] for v in c.values()) for c in r["run_coll"]]
        n_c = [sum(v[0] for v in c.values()) for c in r["run_coll"]]
        by = {}
        for c in r["run_coll"]:
            for k, v in c.items():
                by[k] = (by.get(k, (0, 0, 0.0))[0] + v[0],
                         by.get(k, (0, 0, 0.0))[1] + v[1],
                         by.get(k, (0, 0, 0.0))[2] + v[2])
        med = float(np.median(r["run_ms"]))
        log(f"[{tag}] rank {r['rank']} {r['coords']} (page shard "
            f"{r['page_shard']}, batch shard {r['batch_shard']}): init "
            f"{r['init_s']:.1f} s, prefill {r['run_prefill_s']:.3f} s, "
            f"decode {med:.1f} ms/step median (collectives timed, the card "
            f"synchronized around each), collectives {np.median(n_c):.0f} "
            f"a step taking {1e3 * np.median(per):.1f} ms "
            f"({100 * 1e3 * np.median(per) / med:.1f}% of the step); by "
            f"kind over {steps} steps (calls, MB sent, s): "
            + ", ".join(f"{k} ({v[0]}, {v[1] / 1e6:.0f}, {v[2]:.2f})"
                        for k, v in by.items())
            + f"; launches {r['launches']}; plain decode "
            f"{float(np.median(r['plain_ms'])):.1f} ms/step; t1 reads "
            f"{int(r['kv']['t1_reads'][0])}, t2 reads "
            f"{int(r['kv']['t2_reads'][0])}, evictions "
            f"{int(r['kv']['evictions'][0])}")
    log(f"[{tag}] (b) sharded kernel run vs the one-card kernel run: "
        f"hidden {b_h:.3e}, logprobs {b_lp:.3e}; (a) noise floor beside "
        f"it, kernel vs plain on the same shards: hidden {a_h:.3e}, "
        f"logprobs {a_lp:.3e}; (d) page shard 1's partial dropped, first "
        f"{S['fault_steps']} steps: hidden {d_h:.3e}")
    _check_bars(tag + " (a)", a_h, a_lp, {}, {}, steps)
    _check_bars(tag + " (b)", b_h, b_lp, control,
                {"fault (d): page shard 1's partial dropped": (d_h, 0.0)},
                S["fault_steps"])
    k0 = ranks[0]["kernels"]
    for name, e in k0.items():
        log(f"[{tag}, {name} vs plain] rank 0, {e['shape']}: max |diff| "
            f"{e['max_abs_err']:.3e}, kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.3f} ms, library "
            f"{e.get('library_ms') or float('nan'):.4f} ms, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
    if not k0["flash_attention"]["bf16_step_excess"] <= 1:
        raise AssertionError(f"[{tag}] flash kernel != plain at the sharded "
                             f"shape")
    if not k0["paged_attention"]["max_abs_err"] <= PAGED_REL_TOL:
        raise AssertionError(f"[{tag}] paged kernel != plain at the sharded "
                             f"shape")
    log(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s")
    out = {}
    for name in ("flash_attention", "paged_attention", "page_copy"):
        e = k0[name]
        out[name] = {
            "sharded_launches": sum(r["launches"][name] for r in ranks),
            "sharded_ms": e["ms"], "sharded_plain_ms": e["plain_ms"],
            "sharded_library_ms": e.get("library_ms"),
            "sharded_bound_ms": e["bound_ms"],
            "sharded_bound_by": e["bound_by"],
            "sharded_max_abs_err": e["max_abs_err"],
            "sharded_shape": e["shape"] + f" (rank 0 of {n_ranks}, "
                                          f"{backend}, one card shared)"}
    return out, trained


def _sharded_ranks(rank: int, dev, S: dict, prompts, forced, T: dict,
                   P: dict) -> dict:
    """Phases 21 and 22 on one spawn of the ranks: the sharded serve, then
    (its tensors freed) the sharded training."""
    out = _sharded_rank(rank, dev, S, prompts, forced)
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = _sharded_train_rank(rank, dev, T, P)
    return out


def _parity_cfg(arch: str):
    """Phase 22 (b)'s reduced f32 configuration, f32 moments (as the CPU
    tests')."""
    import dataclasses
    from repro_torch.configs.archs import get_config
    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32",
                               opt_state_dtype="float32")


def _parity_state(cfg, dev):
    from repro_torch.models.params import init_params
    from repro_torch.training.compression import init_error_feedback
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import TrainState
    params = init_params(cfg, 1, dev)
    return TrainState(params, adamw_init(params, cfg.opt_state_dtype),
                      init_error_feedback(params))


def _parity_batches(cfg, P: dict) -> list:
    rng = np.random.default_rng(22)
    return [{k: torch.as_tensor(rng.integers(
        0, cfg.vocab, (P["batch"], P["seq"])).astype(np.int32))
        for k in ("tokens", "labels")} for _ in range(P["steps"])]


def _np_leaves(tree) -> list:
    from repro_torch.training.tree import leaves
    return [t.detach().float().cpu().numpy() for t in leaves(tree)]


def _sharded_train_cfg(T: dict):
    """Phase 22 (a)'s configuration: full width, ``T["layers"]`` layers."""
    import dataclasses
    from repro_torch.configs.archs import get_config
    return dataclasses.replace(get_config(T["arch"]), n_layers=T["layers"])


def _sharded_train_hyper(T: dict):
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainHyper
    return TrainHyper(adamw=AdamWConfig(lr=T["lr"], warmup_steps=20,
                                        decay_steps=100))


def _sharded_train_rank(rank: int, dev, T: dict, P: dict) -> dict:
    """One rank of phase 22: (a) the full-width steps, each timed with its
    collectives; (b) the parity runs; (c) the planted fault."""
    from repro_torch.core.roofline import storage_bytes
    from repro_torch.distributed import axes as dax
    from repro_torch.launch import serve, spmd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import init_params
    from repro_torch.training import train_step as ts
    from repro_torch.training.compression import init_error_feedback
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(*T["mesh"])
    cfg = _sharded_train_cfg(T)
    t0 = time.perf_counter()
    full = init_params(cfg, 0, dev)
    params = tree_map(lambda t: t.clone(), spmd.shard_for_rank(full, cfg,
                                                               mesh))
    del full
    gc.collect()
    torch.cuda.empty_cache()
    state = ts.TrainState(params, adamw_init(params, cfg.opt_state_dtype),
                          init_error_feedback(params))
    step, _, _ = spmd.build_train_step(cfg, mesh, _sharded_train_hyper(T))
    rng = np.random.default_rng(14)
    batch = spmd.train_batch_for_rank({k: torch.as_tensor(rng.integers(
        0, cfg.vocab, (T["batch"], T["seq"])).astype(np.int32))
        for k in ("tokens", "labels")}, mesh)
    batch = {k: v.to(dev) for k, v in batch.items()}
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    arg_bytes = storage_bytes((state, batch))  # the step's arguments
    torch.cuda.reset_peak_memory_stats(dev)
    serve.reset_launch_counts()
    ms, coll, wire, metrics = [], [], [], []
    dax.time_collectives(True)
    try:
        for _ in range(T["steps"]):
            dax.reset_collective_stats()
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize(dev)
            ms.append(1e3 * (time.perf_counter() - t1))
            coll.append(dax.collective_stats())
            wire.append(dax.collective_wire_bytes())
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        dax.time_collectives(False)
    launches = serve.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    untrained = _untrained_leaves(state.opt.mu)
    n_local = sum(t.numel() for t in _leaves(state.params))
    applied = int(state.opt.step)
    del state, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    # (b) parity, (c) the planted fault.
    pcfg = _parity_cfg(P["arch"])
    parity = []
    for shape, axes, comp in P["meshes"]:
        pmesh = make_mesh(shape, axes)
        runs = []
        for fault in (False, True) if not comp else (False,):
            hy = ts.TrainHyper(aux_weight=0.0, compress_pod_grads=comp)
            pstep, _, _ = spmd.build_train_step(pcfg, pmesh, hy)
            st = spmd.shard_state(_parity_state(pcfg, dev), pcfg, pmesh)
            promote0 = ts.promote
            if fault:  # the data axis's sum of replicated leaves dropped
                ts.promote = lambda params, gs_tree, ax: params
            try:
                mm = []
                for b in _parity_batches(pcfg, P):
                    b = spmd.train_batch_for_rank(b, pmesh)
                    st, m = pstep(st, {k: v.to(dev) for k, v in b.items()})
                    mm.append({k: float(v) for k, v in m.items()})
            finally:
                ts.promote = promote0
            runs.append(dict(metrics=mm, params=_np_leaves(st.params),
                             mu=_np_leaves(st.opt.mu),
                             nu=_np_leaves(st.opt.nu)))
        parity.append(dict(coords=pmesh.coords(), runs=runs))
    return dict(rank=rank, coords=mesh.coords(), init_s=init_s, ms=ms,
                coll=coll, wire=wire, arg_bytes=arg_bytes, metrics=metrics,
                launches=launches, peak=peak,
                untrained=untrained, applied=applied, n_local=n_local,
                parity=parity)


def _sharded_train_only(rank: int, dev, T: dict, P: dict) -> dict:
    return _sharded_train_rank(rank, dev, T, P)


def _parity_gaps(got: dict, want: dict, lr: float, comp: bool) -> tuple:
    """(metric gap, parameter gap, moment gap, ok) of one rank's parity
    run against the one-card blocks ``want``, by phase 22's bars."""
    tol = SHARDED_TRAIN_TOL
    keys = ("loss", "grad_norm", "dropped")
    m_gap = max(abs(g[k] - w[k]) / abs(w[k]) if w[k] else abs(g[k])
                for g, w in zip(got["metrics"], want["metrics"])
                for k in keys)
    p_gap = max(float(np.abs(g - w).max())
                for g, w in zip(got["params"], want["params"]))
    mo_rel = max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
                 for name in ("mu", "nu")
                 for g, w in zip(got[name], want[name]))
    mo_abs = max(float(np.abs(g - w).max()) for name in ("mu", "nu")
                 for g, w in zip(got[name], want[name]))
    if not comp:
        ok = (m_gap <= tol["rel"] and p_gap <= tol["lr_frac_per_step"] * lr
              and mo_rel <= tol["moment_rel"])
    else:
        ok = (all(abs(g["loss"] - w["loss"]) < tol["ref_loss"] and
                  abs(g["grad_norm"] / w["grad_norm"] - 1) <= tol["code_step"]
                  for g, w in zip(got["metrics"], want["metrics"]))
              and p_gap < tol["ref_abs"] and mo_abs < tol["ref_abs"])
    return m_gap, p_gap, mo_rel, ok


def phase_sharded_train(ranks=None, dev=torch.device("cuda")) -> None:
    """Phase 22: the sharded training of ``_sharded_train_rank`` on 4 ranks
    sharing the card (``ranks``: phase 21's spawn's results; None spawns
    them), checked against the one-card step on the card."""
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    from repro_torch.models import params as pm
    from repro_torch.training.optimizer import AdamWConfig, lr_schedule
    from repro_torch.training.train_step import TrainHyper, make_train_step
    T, P, tag = SHARDED_TRAIN, SHARDED_TRAIN_PARITY, "sharded train"
    t_phase = time.perf_counter()
    n_ranks = int(np.prod(T["mesh"][0]))
    if ranks is None:
        ranks = spawn_ranks(_sharded_train_only, n_ranks, (T, P),
                            device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    # (a) every step finite and applied, metrics equal on every rank.
    for r in ranks:
        fin = all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                  for m in r["metrics"])
        if not (fin and r["applied"] == T["steps"] and not r["untrained"]):
            raise AssertionError(f"[{tag}] rank {r['rank']}: finite {fin}, "
                                 f"steps applied {r['applied']}, untrained "
                                 f"{r['untrained'][:4]}")
        if r["metrics"] != ranks[0]["metrics"]:
            raise AssertionError(f"[{tag}] ranks {r['rank']} and 0 disagree "
                                 f"on the metrics")
        if any(r["launches"].values()):
            raise AssertionError(f"[{tag}] rank {r['rank']} launched hand "
                                 f"kernels {r['launches']}")
    log(f"[{tag}, full width] {T['arch']} at {T['layers']} of 32 layers, "
        f"bf16, remat, f32 moments, on {n_ranks} ranks sharing the card "
        f"({card}), mesh {T['mesh'][0]} {T['mesh'][1]}, backend "
        f"{backend_for(dev, n_ranks)}: {T['steps']} steps of {T['batch']} x "
        f"{T['seq']} tokens; losses "
        f"{[round(m['loss'], 4) for m in ranks[0]['metrics']]}, grad norms "
        f"{[round(m['grad_norm'], 4) for m in ranks[0]['metrics']]}, equal "
        f"on every rank; hand-kernel launches 0")
    for r in ranks:
        by: dict = {}
        for c in r["coll"][1:]:
            for k, v in c.items():
                a = by.get(k, (0, 0, 0.0))
                by[k] = (a[0] + v[0], a[1] + v[1], a[2] + v[2])
        n_steps = max(len(r["coll"]) - 1, 1)
        step_ms = float(np.median(r["ms"][1:]))
        coll_ms = 1e3 * sum(v[2] for v in by.values()) / n_steps
        log(f"[{tag}, full width] rank {r['rank']} {r['coords']}: "
            f"{r['n_local'] / 1e6:.1f} M parameters local, init "
            f"{r['init_s']:.1f} s, steps "
            f"{[round(x, 1) for x in r['ms']]} ms (collectives timed, the "
            f"card synchronized around each), median of steps 2-"
            f"{T['steps']} {step_ms:.1f} ms, collectives {coll_ms:.1f} ms a "
            f"step ({100 * coll_ms / step_ms:.1f}%); by kind a step (calls, "
            f"MB sent, ms, share of the step): "
            + ", ".join(f"{k} ({v[0] // n_steps}, {v[1] / n_steps / 1e6:.0f}"
                        f", {1e3 * v[2] / n_steps:.0f}, "
                        f"{100 * 1e3 * v[2] / n_steps / step_ms:.1f}%)"
                        for k, v in sorted(by.items()))
            + f"; peak memory {r['peak'] / 1e9:.2f} GB")

    # (b) parity against the one-card step on the card; (c) the fault.
    pcfg = _parity_cfg(P["arch"])
    step = make_train_step(pcfg, hyper=TrainHyper(aux_weight=0.0))
    st = _parity_state(pcfg, dev)
    one_m = []
    for b in _parity_batches(pcfg, P):
        st, m = step(st, {k: v.to(dev) for k, v in b.items()})
        one_m.append({k: float(v) for k, v in m.items()})
    lr = sum(float(lr_schedule(AdamWConfig(), torch.tensor(t)))
             for t in range(1, P["steps"] + 1))
    fault_gap = None
    for i, (shape, axes, comp) in enumerate(P["meshes"]):
        sizes = dict(zip(axes, shape))
        ms = pm.MeshSizes(data=sizes.get("data", 1),
                          model=sizes.get("model", 1))
        specs = pm.param_pspecs(
            pcfg, ms, data_axis="data" if "data" in axes else None,
            model_axis="model" if "model" in axes else None)
        worst = [0.0, 0.0, 0.0]
        for r in ranks:
            par = r["parity"][i]

            def cut(tree):
                return _np_leaves(pm.zip_map(
                    lambda w, sp: pm.shard_leaf(w, sp, sizes,
                                                par["coords"]), tree, specs))
            want = dict(metrics=one_m, params=cut(st.params),
                        mu=cut(st.opt.mu), nu=cut(st.opt.nu))
            m_gap, p_gap, mo_gap, ok = _parity_gaps(par["runs"][0], want,
                                                    lr, comp)
            worst = [max(a, b) for a, b in zip(worst, (m_gap, p_gap,
                                                       mo_gap))]
            if not ok:
                raise AssertionError(
                    f"[{tag}] parity {shape} {axes} rank {r['rank']}: "
                    f"metrics {m_gap:.3e}, params {p_gap:.3e}, moments "
                    f"{mo_gap:.3e} beyond the bars")
            if len(par["runs"]) > 1:
                f = _parity_gaps(par["runs"][1], want, lr, comp)
                if fault_gap is None or f[0] > fault_gap[0]:
                    fault_gap = f[:3]
                if f[3]:
                    raise AssertionError(f"[{tag}] the planted fault (the "
                                         f"data sum dropped) passed the bars")
        log(f"[{tag}, parity] reduced {P['arch']} f32, {P['steps']} steps of "
            f"{P['batch']} x {P['seq']}, mesh {shape} {axes}"
            f"{', int8 pod compression' if comp else ''}, every rank against "
            f"the one-card step on the card (TF32 off): metrics rel "
            f"{worst[0]:.2e}, params max |diff| {worst[1]:.3e} = "
            f"{worst[1] / lr:.4f} lr, moments {worst[2]:.2e} of their "
            f"largest (bars: "
            + ("the reference's, loss 1e-5, params and moments 5e-4, grad "
               "norm 1/127 relative" if comp else
               "1e-5, 0.1 lr a step, 1e-5") + ")")
    if fault_gap is None:
        raise AssertionError(f"[{tag}] no planted-fault run")
    log(f"[{tag}, fault] the data axis's sum of the replicated leaves' "
        f"gradients dropped: metrics rel {fault_gap[0]:.2e}, params "
        f"{fault_gap[1]:.3e} ({fault_gap[1] / lr:.3f} lr), moments "
        f"{fault_gap[2]:.2e}: above the bars")
    log(f"[{tag}] phase checks {time.perf_counter() - t_phase:.1f} s")


def phase_dry_run(ranks) -> None:
    """Phase 23: the dry run of phase 22 (a)'s cell, rank 0's step traced
    on ``meta`` in a fake group of its 4 ranks in this process
    (``repro_torch.launch.dryrun.trace_cell``), held against rank 0's run
    on the card (``ranks``: phase 22's results)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import make_mesh
    T, tag = SHARDED_TRAIN, "dry run"
    t0 = time.perf_counter()
    card = card_line()
    n_ranks = int(np.prod(T["mesh"][0]))
    rec = trace_cell(_sharded_train_cfg(T),
                     ShapeSpec("sharded_train", T["seq"], T["batch"],
                               "train"),
                     n_ranks, lambda: make_mesh(*T["mesh"]), rank=0)
    r0 = next(r for r in ranks if r["rank"] == 0)
    dry = {k: (v[0], v[1]) for k, v in rec["collectives"].items()}
    dry_wire = {k: v[2] for k, v in rec["collectives"].items()}
    for i, (c, w) in enumerate(zip(r0["coll"][1:], r0["wire"][1:]), 2):
        real = {k: (v[0], v[1]) for k, v in c.items()}
        if real != dry or w != dry_wire:
            raise AssertionError(
                f"[{tag}] collectives of step {i} on the card {real} "
                f"(wire {w}) differ from the trace's {dry} (wire "
                f"{dry_wire})")
    mem = rec["memory"]
    if mem["argument_size_in_bytes"] != r0["arg_bytes"]:
        raise AssertionError(
            f"[{tag}] argument bytes {mem['argument_size_in_bytes']} "
            f"traced, {r0['arg_bytes']} on the card")
    log(f"[{tag}] {T['arch']} at {T['layers']} of 32 layers, rank 0 of "
        f"{n_ranks} on {T['mesh'][0]} {T['mesh'][1]}, {T['batch']} x "
        f"{T['seq']} tokens ({rec['trace_s']:.2f} s traced on meta, a fake "
        f"group, no card): {rec['hlo_flops']:.4e} FLOPs, "
        f"{rec['hlo_bytes_accessed']:.4e} bytes (all ops "
        f"{rec['hlo_bytes_all_ops']:.4e}); collectives a step, equal to "
        f"phase 22 rank 0's steps 2-{T['steps']} on the card exactly (calls, "
        f"MB sent, MB on the wire): "
        + ", ".join(f"{k} ({v[0]}, {v[1] / 1e6:.1f}, {v[2] / 1e6:.1f})"
                    for k, v in rec["collectives"].items())
        + f"; arguments {mem['argument_size_in_bytes']} bytes, equal to "
        f"the card's")
    peak, peak_card = mem["peak_memory_in_bytes"], r0["peak"]
    log(f"[{tag}] peak memory: traced {peak / 1e9:.2f} GB (the live meta "
        f"storages, arguments included), on the card {peak_card / 1e9:.2f} "
        f"GB (rank 0, torch.cuda.max_memory_allocated over phase 22's "
        f"steps; {card}): ratio {peak / peak_card:.3f}")
    step_ms = float(np.median(r0["ms"][1:]))
    bound_ms = 1e3 * max(rec["t_compute_s"], rec["t_memory_s"],
                         rec["t_collective_s"])
    log(f"[{tag}] roofline on the H100's published peaks (989 TFLOP/s "
        f"bf16, 3.35 TB/s, 450 GB/s a link each way): compute "
        f"{1e3 * rec['t_compute_s']:.3f} ms, memory "
        f"{1e3 * rec['t_memory_s']:.3f} ms, collective "
        f"{1e3 * rec['t_collective_s']:.3f} ms; dominant "
        f"{rec['dominant']}, roofline_frac {rec['roofline_frac']:.4f}; "
        f"phase 22's measured step (rank 0, median of steps 2-{T['steps']}) "
        f"{step_ms:.1f} ms on {card}, {step_ms / bound_ms:.1f}x the bound "
        f"of {bound_ms:.3f} ms")
    took = time.perf_counter() - t0
    log(f"[{tag}] phase {took:.1f} s")
    if took > DRY_RUN_LIMIT_S:
        raise AssertionError(f"[{tag}] the phase took {took:.1f} s, over "
                             f"its {DRY_RUN_LIMIT_S} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails at once without the repo)
    log(card_line())  # name, power limit: as nvidia-smi prints them
    t_start = time.perf_counter()

    def done(phase: str) -> None:
        log(f"[smoke] phase {phase} done at "
            f"{time.perf_counter() - t_start:.1f} s")
    phase_build()
    done("1 (build)")
    rates = phase_probes()
    done("2 (probes)")
    phase_kernel_vs_plain(rates)
    done("3")
    phase_worked_example()
    done("4")
    full = phase_full_size(rates)
    done("5")
    full_ctr = full.pop("counters")
    full_rep, full_rows = full.pop("report"), full.pop("rows")
    phase_reuse_vs_plain()
    done("6")
    phase_mixed_knobs(rates)
    done("7")
    mrc = phase_mrc(full_size_spec().replace(
        **{"store.policy": "lru", "n_windows": 1}))
    done("8")
    mega = phase_megabatch(full_ctr, rates)
    done("9")
    serving, bf16_run = phase_serve()
    done("10")
    ssd = phase_ssd_serve()
    done("11")
    rglru, at_rg = phase_rglru_serve()
    done("12")
    chunked = phase_chunked_replay(full_ctr, full_rep, full_rows, full,
                                   rates)
    done("13")
    phase_train()
    done("14")
    phase_configurator()
    done("15")
    int8 = phase_int8_serve(bf16_run)
    done("16")
    breadth = [phase_family_serve(S) for S in (WHISPER_SERVE, VLM_SERVE,
                                               MOE_SERVE)]
    done("17-19")
    phase_train_families()
    done("20")
    sharded, trained = phase_sharded_serve()
    done("21 (and 22's ranks)")
    phase_sharded_train(trained)
    done("22")
    phase_dry_run(trained)
    done("23")
    for entry in serving:
        entry.update(sharded[entry["name"]])
        entry.update(at_rg[entry["name"]])
        entry.update(int8[entry["name"]])
        for fam in breadth:
            entry.update(fam[entry["name"]])
    cache_scan = dict(
        name="cache_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/cache_scan.cu",
        replaces="src/repro/kernels/cache_scan.py:385", library_ms=None,
        **full, **mega, **chunked)
    reuse = dict(
        name="reuse_distance", route="cuda",
        source="src/repro_torch/kernels/csrc/reuse_distance.cu",
        replaces="src/repro/kernels/reuse_distance.py:142", library_ms=None,
        **mrc)
    kernels = [cache_scan, reuse, *serving, ssd, rglru]
    check_kernels_over_bounds(kernels)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
