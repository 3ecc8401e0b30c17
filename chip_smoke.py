"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
and drives the port's paths through the entry points a user calls: the
DA engines, serving and training.

DD-KF: the streaming engine (``repro_torch.assim.AssimilationEngine``,
single-device solver) at the paper's size: n = 2048, p = 8, m = 2000
observations per cycle on ``drifting_swarm`` (``EXAMPLE4`` ``ex4_p8`` of
``repro/configs/cls_paper``), then a 2D shelf tiling with overlap at the
same width.  Each engine runs three ways: (a) through the kernels, (b)
the same again, (c) through the plain PyTorch versions.  It fails unless
every cycle's analysis is within 1e-10 of the direct CLS solve, (a) and
(b) are bitwise equal, (a) and (c) agree within 1e-12, the host
decisions of all three match, and the launch counters show that (a) ran
every kernel and (c) none.

The paper's baseline (``kf``): on Example 4's problem (n = 2048, m = 2000
beta observations, f64), the sequential VAR-KF
(``repro_torch.core.kalman.solve_cls_sequential``, block 50: the paper's
T^1), matrix-free CG (``cls.solve_cg``) and the Schwarz DD-CLS solver
(``dd.SchwarzSolver``, p = 8 on DyDD boundaries, multiplicative and
additive), each held to the direct CLS solve at the reference's bounds
(1e-9, 1e-8, 1e-9 and 1e-8) and timed.

Parareal (``pint``): ``repro_torch.assim.TimeParEngine`` at ``ex4_p8``
over 8 cycles in 4 windows, (a) through the kernels, (b) the sequential
engine on the same stream, (c) through the plain versions, (d) at
``time_windows=1``.  It fails unless (a) converges, its host decisions
equal (b)'s, its analysis chain is within 1e-6 of (b)'s and every cycle
within 1e-10 of the direct solve, (c) is within 1e-9 of (a) and launches
nothing, (a) launches ``schwarz_fwd`` and ``schwarz_bwd`` k C fine +
(k + 1) C coarse times and ``gram`` C times (k Parareal iterations, C
cycles), and (d) is bitwise (b).  It prints the wall times, k, the
correction norms and the peak device memory of each run.

The distributed solve (``shardmap``): ``repro_torch.runtime.mesh.launch``
spawns 8 ranks that share the card over gloo (NCCL refuses two ranks on
one GPU), their collectives through pinned host copies; each runs the
engine with ``solver="shardmap"`` on its own subdomain: (a) ``ex4_p8``
(allreduce exchange; 4 cycles with a snapshot every 2, the run the mesh
resume is held to) and (b) the 2D shelf on the ("row", "col") mesh
with both exchanges, 2 cycles, then (c) ``TimeParEngine`` at
``PINT`` cut to 4 cycles on the auto ("time": 4, "sub": 2) mesh.  It
fails unless every rank's analyses and deterministic journal are the
same, (a) and (b) are within 1e-13 of the single-process vmapped engine
on the same stream, every cycle within 1e-10 of the direct solve, their
host decisions equal, each rank launched ``gram`` once and each Schwarz
kernel 120 times a cycle, each rank's block of the first packing equals
the single-process packing's rows bitwise, the m-vector's scatter and
psum paths agree within 1e-13 and the neighbour exchange journals fewer
bytes, and (c) converges in the single-process run's iterations within
1e-6 of its sequential chain.  It prints each rank's walls, the
transport and the card; a correctness run of ranks that time-slice one
card, not a speed-up.  Its kernels are held and timed at a rank's block
(1, 6094, 1553).  Rank 0 alone must have written each step of (a), and
every rank's snapshot of it must hash the same.

The DA paths on a process mesh, in the same launch and two more, at
``EXAMPLE4``'s ``ex4_p8`` (``configs/cls_paper.py``): (a) the fleet:
``FleetServer(mesh=...)`` on an 8-rank ("fleet",) mesh over three
streams of 2 cycles (two on DyDD, one static), a snapshot every 2
cycles, a transient pack fault and a transient cohort-solve fault; each
stream's journal and final analysis on every rank must equal the stream
run alone in this process bitwise, every cycle within 1e-10 of the
direct solve, every cohort's capacity 8, each retry taken once on every
rank, rank 0 alone writing the snapshots, and each rank's launches
those of its slice (``gram`` once a stream and cycle: every rank packs
every stream; each Schwarz kernel 120 times for its one slot of each
cohort solve).  (c) ``compressed_psum`` of a (4096, 4096) f32 and bf16
gradient a rank: every rank's mean must be bitwise one process's int32
sum times the max scale over 8, and each rank's new error its own
(g + e) - q * scale.  (b) resume onto a mesh (``mesh resume``): 8 ranks
run ex4_p8 with ``solver="shardmap"`` and are SIGKILLed by their
injectors at the end of cycle 1; the launch must raise naming the
signal within the collective timeout, the newest verified step must be
2; resumed on 8 ranks, the journal and final analysis must be bitwise
(a)'s uninterrupted run's; resumed at p = 4 on 4 ranks, each remaining
cycle within 1e-10 of the direct solve.  Each prints its walls and peak
memory per rank beside the card's name and power limit.

Fleet (``fleet``): ``repro_torch.assim.serving.FleetServer`` at
``ex4_p8``'s width over five streams of 4 cycles (three on DyDD:
``drifting_swarm``, ``bursty_clusters``, ``storm_front``; two static
``drifting_swarm`` streams that share a cohort key), ``max_active=4``,
four packing threads, a snapshot every 2 cycles, a transient pack
fault, a transient cohort-solve fault and a stream retired by faults
on every attempt, then readmitted from its snapshot.  It fails unless
each stream's journal and final analysis equal the same stream run
alone bitwise, every cycle is within 1e-10 of the direct solve, a
cohort of two or more went through ``stack_packed``/``solve_fleet``,
and ``gram`` launched once for each stream and cycle and each Schwarz
kernel ``iters`` times for each cohort slot.  It prints the rounds, the
cohorts, the wall time beside the standalone runs', the snapshot p50
and the peak memory.

Resume (``resume``): at ``ex4_p8``, a child process killed by its chaos
injector after cycle 3 of 6 (snapshots every 2) is resumed here from
step 4 bitwise equal to an uninterrupted run; step 4 resumed at p = 4
stays within 1e-10 of the direct solve; a torn step 4 fails ``verify``
and ``latest_checkpoint`` falls back to step 2; a ``TimeParEngine``
window checkpoint resumes the sequential engine within 1e-6.

LM serving: ``repro_torch.launch.serve.serve_batch`` on
RecurrentGemma-9B and then on Mamba-2 1.3B, each at full width in bf16
(weights drawn on the card from a seeded generator), four requests of
4096, 3072, 2500 and 1800 prompt tokens left-padded to 4096, 32 greedy
tokens each: (a) through the kernels, (b) the same again, bitwise equal
to (a), (c) the prefill through the plain versions, for RecurrentGemma
within 2e-2 of (a) in the last-position logits (relative to their
max-abs) and in the trunk's output less the embedding (Frobenius over
Frobenius, and within 0.2 at the worst position; ``LM_PATHS`` holds each
model's limits), (d) the prefill through the kernels with every kernel
call held against its plain version on that call's inputs, (e) the
prefill with the last layer's kernel output losing its last 64
positions, which the trunk gate must catch.  Mamba-2's (c) and (e) run on
an f32 copy of its weights, at limits set for f32: in bf16 its random
layers amplify rounding past any fixed gate (``LM_PATHS``), so there its
kernel route is held to the plain route within twice a rounding-level
control.  The launch counters must show 12 ``flash_attention`` and 26
``rglru_scan`` launches for the RecurrentGemma prefill, 48 ``ssd_scan``
launches for the Mamba-2 prefill, and none for decode.  The smoke configs
(f32) are also served on the card and on the CPU, whose plain path the
CPU tests hold to the JAX package.

The uniform attention stack: the smoke configs (f32) of Yi-6B, Gemma-7B,
GLM-4-9B, gemma3-1b (local and global layers, head dimension 12, which
the attention wrapper zero-pads to 16), OLMoE-1B-7B and Mixtral-8x22B
(``moe_ep``, two virtual experts) served on the card and on the CPU as
above (the MoE ones with the CPU run's routing fed to the card's: left
padding gives rows whose hidden states differ in the last bits, and
which of them a chunk edge migrates follows the rounding); then Yi-6B
(32 layers, d_model 4096, GQA 32 x 128 over 4 kv
heads, global attention) and OLMoE-1B-7B (16 layers, d_model 2048, 16 x
128 heads, 64 experts top-8 routed by the DyDD schedule) at full width
in bf16 through runs (a) to (e) on the same traffic; 32 and 16
``flash_attention`` launches a prefill.  Yi's (c) within 2e-2 in logits
and trunk and 5e-2 at the worst position.  OLMoE's kernel and plain
routes send some tokens to other experts (a difference in attention
moves the router, and left padding ties tokens): the share of (token,
expert) assignments that differ is printed, each plain run records its
routing and the runs held to it replay it; with it fed, OLMoE's random
bf16 layers still amplify rounding, as Mamba-2's do (one ulp on every
attention output moves its logits past 2e-2), so its (c) and (e) run on
an f32 copy at Mamba-2's f32 limits; in bf16 it is held end to end
within twice a control that moves every attention output by up to a bf16
ulp, on the weights of two seeds, and each attention call of (d) within
about one ulp (Frobenius) and a quarter ulp of bias of its plain version,
which run (f), a bias of one to two ulps planted in every call, must
trip.  The profiles print the MoE's device time (dispatch, experts,
combine) and its share.
Each of these prefills' first attention call is a ``kernels`` row of its
own, and ``flash_attention`` forward and backward run at head dimensions
off a multiple of 8 (``PADDED_ATTN``) in both dtypes.

The encoder-decoder and the vision stub (``MODALITY_ARCHS``): the smoke
configs of whisper-large-v3 and phi-3-vision-4.2b on the card against
the CPU, then each at full size in bf16 through runs (a) to (e) as
above: whisper (32 encoder and 32 decoder layers, d_model 1280, 20
heads of 64) on 4 requests of 416, 352, 288 and 200 tokens with frames
(4, 1500, 1280) drawn at scale 0.02, 32 greedy tokens (448 positions,
its decoder's context): 96 ``flash_attention`` launches a prefill, 32
non-causal over the 1500 frames, 32 causal, 32 cross-attention calls of
416 query rows against the 1500 frames; phi-3-vision (32 layers,
d_model 3072, 32 heads of 96) with 144 patches (4, 144, 3072) before
prompts of 3952-1656 tokens, 4096 positions on the longest: 32 launches.
A ``kernels`` row for each kind of their prefills' attention calls, then
``cross_attention``: the forward and backward in f32 and bf16 with S_kv
!= S (whisper's shapes, one query row, a ragged S_kv, S_kv under one
tile, D 128 and 256) and at D = 96 (``CROSS_ATTN``), each against its
plain version, two launches bitwise equal.  The serve and train CLIs
run the eight smoke configs as child processes, all at once (``clis``);
whisper's training CLI must refuse (its loader has no frames) with a
``ValueError`` naming them.

Each kernel is then held against its plain version on the card, on the
main path's own inputs, on random values at the same shapes and at
ragged shapes (``flash_attention`` also with k and v at fewer rows than
q, the grouped kv heads that the prefill passes unexpanded), and timed
beside its bound, the plain version and one library call where there is
one (for ``flash_attention``, SDPA with the same mask on an expanded copy
of k and v; SDPA's full causal attention, ``sdpa_causal_ms``, is printed
beside it and is no yardstick of the same function); ``gram``,
``flash_attention``, ``rglru_scan`` and ``ssd_scan`` must also give
bitwise equal outputs over two launches at the main shape.
``flash_attention`` is also held row by row (the worst row's difference
norm over its norm), a limit that one-tile faults planted in its plain
version at the main shape must exceed.  ``schwarz_fwd`` and
``schwarz_bwd`` (f64 and f32) must give bitwise equal outputs over two
launches, blocks 0 and p - 1 of ex4_p8's packing launched alone bitwise
their rows of the batched launch, the packing as a member of a 4-problem
stack bitwise its standalone launch, rank 0's block alone bitwise row 0
of the whole packing's launch, and views one element past a 16-byte
boundary at the ragged, wide and rank shapes within the tolerance of
the plain version and bitwise the aligned launch; their rows also carry
the time with the calls queued ahead of the card (``device_ms``), with
the L2 refilled with other data before each call (``cold_ms``) and of
the forward and backward alternating on one A (``pair_ms``,
``pair_device_ms``).
``ssd_scan``'s ``bound_ms`` counts the flops the function needs at the
TF32 tensor-core peak beside its bytes; the text line also prints the
time of the kernel's own 3xTF32 arithmetic and of exact f32 FMA.  The
build phase prints every kernel's registers, spills and static shared
memory from ``-Xptxas -v``, and fails if ptxas ignored the bf16
``flash_attention`` kernel's ``setmaxnreg`` (C7508).
``torch.profiler`` traces one DD-KF cycle and, for each served model,
one prefill and one decode step; the five launches of one ``ssd_scan``
call are timed one by one.

Training (``train``): ``repro_torch.runtime.steps.make_train_step`` on
one ``BalancedLoader`` batch, AdamW with f32 moments, remat "block", the
chunked loss (512), six runs: OLMoE-1B-7B at full width with its depth
cut to 10 of 16 layers (batch 4 x 2048, dp 4, step 0 on an f32 copy;
its first attention call, cast to bf16, gives a forward and a backward
row at the training shape), Mamba-2 1.3B at full size (48 layers, batch
4 x seq 2048, loader dp 4) and RecurrentGemma-9B at full width with its
depth cut to 18 layers (six (R, R, A) periods, batch 2 x seq 4096, dp
2; its 38 layers would need ~102 GB at 12 bytes a parameter), in bf16,
then RecurrentGemma-9B in f32 at full width, 3 layers (one period,
~1.64 B parameters, ~26 GB at 16 bytes a parameter), batch 2 x seq 4096,
through the f32 attention backward; phi-3-vision-4.2b at full size
(batch 2 x (144 patches + 2048 tokens), step 0 in bf16) second and
whisper-large-v3 at full size (batch 4 x 448 tokens with frames (4,
1500, 1280), step 0 on an f32 copy, which runs the f32 cross-attention
forward and backward at full width) last, both through
``make_train_step`` on the loader's batches with the frames or patches
added (the trainer's loader has none).  Step 0's loss and global grad norm
through the kernels are held to the plain route on the same batch
(within 1e-3 and 2e-2 relative; Mamba-2 and OLMoE on an f32 copy of
their weights, as their serving gates), the loss must fall over 4 steps
on the repeated batch, and every step must launch each forward kernel
twice a layer (remat recomputes it) and each backward kernel once; it
prints the step time p50, tokens a second and peak memory.  The
training CLI then runs the f32 RecurrentGemma and Mamba-2 smoke configs
on the card (``train_cli``, no ``--device``) and must exit 0.
``train_kernels`` holds each backward kernel (``flash_attention_bwd`` in
bf16 and in f32,
``rglru_scan_bwd``, ``ssd_scan_bwd``) to autograd through its plain
version at the first training layer's inputs, random inputs at the same
shapes and ragged shapes (f32 within 1e-4, bf16 within 2e-2 relative
Frobenius; ``flash_attention``'s dK and dV also row by row within
``ATTN_ROW_TOL`` and its dQ against the FA2 plain backward, in f64 for
f32, on the kernel's out and lse, which two planted one-tile faults at
the kernel's tiles must trip; the f32 attention's row gates also on
``DQ_DRAWS`` seeded draws at its training shape, and its dQ row gate on
an input whose rows sit nearly on one key, against f64), checks two
launches bitwise equal and
times each (median) beside its bound, the plain backward and, for
attention, SDPA's backward with the same mask and the earlier design's
time; it prints the device time of each CUDA launch of one backward call
(attention: prep, dq, dkdv; RG-LRU: chunk, carry, out; SSD: ychunk,
rpass, col, row, dcum), each backward kernel's ``-Xptxas -v`` line and
the launches' dynamic shared memory, and times the f32 forward kernels
(attention beside SDPA, ``rglru_scan``) at their training shapes.
``rglru_scan``'s forward takes its TMA path where the row stride is a
multiple of 16 bytes and its direct path elsewhere: at the prefill and
training shapes and at ragged shapes that reach both, each call prints
its path and must equal the direct path bitwise, and both paths are
timed in the same run.  The ``kernels`` line has twenty-nine rows: the
six forward kernels, the f32 attention forward, the four backward ones
(the bf16 and f32 attention's each), flash_attention at Yi's and OLMoE's
prefill and OLMoE's training shape, forward and backward, at whisper's
encoder, decoder self-attention and cross-attention calls and
phi-3-vision's call of their prefills, its backward at whisper's three
training calls in bf16, its forward and backward at whisper's training
cross-attention in f32, ``gram``, ``schwarz_fwd`` and
``schwarz_bwd`` at a rank's block (``*_per_rank``), and ``ssd_scan``
and its backward at a data-parallel rank's shape (``*_per_rank``).

Data-parallel training (``dp_train``): ``mesh.launch`` spawns 4 ranks
that share the card over gloo (host transport) on the ("data": 2,
"model": 2) mesh; each holds its blocks of the params and AdamW moments
(``param_specs``, ``opt_specs``).  (a) The f32 smoke configs of
gemma3-1b ("dp" profile) and yi-6b ("tp", GQA), B = 8 rows of 32
tokens, two ``make_train_step(mesh=)`` steps at lr 1e-3: every rank's
losses, grad norms and gathered params bitwise the same, and within the
CPU tests' limits of the port's single-process step on the card (loss
1e-5, grad norm 1e-4 relative, params 1e-5 absolute but for elements
whose first moment was under 1e-7 after a step, 2 lr a step there);
gemma3's state saved under the mesh (one writer) and ``remesh``ed onto
("data": 4, "model": 1) and, in a launch of 2 ranks, ("data": 1,
"model": 2), every block bitwise its slice of the saved arrays.  (b)
Mamba-2 1.3B at full size in bf16 (the "tp" profile) through
``train(mesh=)`` for one step of 4 x 2048 tokens (2 rows a rank): step
0's loss and global grad norm within 1e-3 and 2e-2 of one process's on
the same batch and weights, every rank's ``ssd_scan`` and backward
launches each step as ``expected_train_launches``, each rank's resting
bytes of params and moments the specs' share, every rank's losses
bitwise the same; it prints each rank's step walls and peak memory and
the launch's wall.

Sharded serving (``serve_mesh``): (a) inside ``dp_train``'s launch, ten
f32 smoke cases through ``make_prefill_step(mesh=)`` and
``make_serve_step(mesh=, cache_shapes=)`` (kv heads split, slots split,
rows alone), every rank's logits, tokens and cache blocks held to one
process on the card (1e-4, pos bitwise), each rank's prefill launching
one prefill's kernels and decode none; (b) after RecurrentGemma's
serving, RecurrentGemma-9B at full width in bf16 on two ranks of
("data": 1, "model": 2) through ``serve_batch(mesh=)``, its ring cache's
slots split, held to a one-process ``serve_batch`` of the same weights
and the serving phase's two longest prompts (ragged, left-padded; logits
within the arch's gate, tokens to the first near tie); it prints each
rank's gather, prefill and decode times, memory and launches.

Dry run (``dryrun``): ``repro_torch.launch.dryrun.lower_cell`` traces,
on ``meta`` tensors, one step of each of five runs above (the trainer's
Mamba-2 1.3B, OLMoE-1B-7B at 10 layers and RecurrentGemma-9B at 18
layers in one process; a ``dp_train`` (b) rank and a ``serve_mesh`` (b)
rank on a ``TracedMesh`` of their meshes' shape and rank), and each
predicted peak (the trace's peak of live bytes plus what the card held
besides the step's inputs when the run began) must lie within
DRYRUN_TOL of the run's ``torch.cuda.max_memory_allocated``.  It then
prints the single-pod dry run's ``fits`` column for the 40 cells at
full width, which a process started at the beginning of the script
computes on the host, niced and hidden from the card (the cells it
finished where it did not finish in time).

Needs one CUDA card and ``nvcc``; imports nothing of JAX.  Exits nonzero
on any failure, and when there is no card.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

REPLACES = {
    "gram": "src/repro/kernels/gram.py:58",
    "schwarz_fwd": "src/repro/kernels/schwarz_step.py:69",
    "schwarz_bwd": "src/repro/kernels/schwarz_step.py:130",
    "flash_attention": "src/repro/kernels/flash_attention.py:118",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:57",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:82",
}
SOURCES = {
    "gram": "src/repro_torch/kernels/csrc/gram.cu",
    "schwarz_fwd": "src/repro_torch/kernels/csrc/schwarz_step.cu",
    "schwarz_bwd": "src/repro_torch/kernels/csrc/schwarz_step.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "rglru_scan": "src/repro_torch/kernels/csrc/rglru_scan.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
}
# The backward kernels (no TPU counterpart; each row's "replaces" names
# the TPU kernel of its forward).
BWD_SOURCES = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_attention_f32":
        "src/repro_torch/kernels/csrc/flash_attention_bwd_f32.cu",
    "rglru_scan": "src/repro_torch/kernels/csrc/rglru_scan.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
}
# The first design of each redesigned backward kernel at the training
# shape, for comparison on the printed line, as PERF.md rows 7-10 keep it,
# of the f32 attention forward at the f32 training shape (row 4) and of
# the rglru_scan forward at the training and prefill shapes (row 6)
# (NVIDIA H100 80GB HBM3, 700.00 W).
EARLIER_BWD_MS = {"flash_attention": 7.9980, "rglru_scan": 1.0065,
                  "ssd_scan": 16.7313, "flash_attention_f32": 31.7893}
EARLIER_FWD_MS = {"flash_attention_f32": 28.6055, "rglru_scan": 0.3605,
                  "rglru_scan_prefill": 0.4283}
# The f32 attention kernels, forward and backward, by their names in
# -Xptxas -v (with the soft cap's flag, Lb0E or Lb1E, where the kernel
# takes one): the ten uncapped ones may not spill; the capped ones'
# spills are printed.
F32_ATTN_KERNELS = (r"((?:flash_f32|fa32_bwd_[a-z]+)_kernel"
                    r"(?:ILi\d+E(?:Lb[01]E)?)?)")
# Each backward kernel's CUDA kernels by name, as the profiler and (with
# the template's mangled arguments) -Xptxas -v name them; the attention's
# with the soft cap's flag.
BWD_KERNELS = {
    "flash_attention": (r"(fa_bwd_[a-z]+_kernel(?:ILi\d+E(?:Lb[01]E)?"
                        r"|<\d+(?:, (?:true|false))?>)?)"),
    "flash_attention_f32": (r"(fa32_bwd_[a-z]+_kernel(?:ILi\d+E(?:Lb[01]E)?"
                            r"|<\d+(?:, (?:true|false))?>)?)"),
    "rglru_scan": r"(rglru_bwd_[a-z]+_kernel(?:I\w+?E|<[\w:]+>)?)",
    "ssd_scan": r"(ssd_bwd_[a-z]+_kernel)"}
REL_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
# The LM kernels' tolerances, as in tests/test_kernels.py.
LM_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# flash_attention row by row as well: the worst output row's difference
# norm over its norm.  LM_TOL divides by the largest |plain| of the whole
# output, which comes from the first rows (few keys, |o| ~ 3), while most
# rows of a long sequence average ~ 750 keys (|o| ~ 0.04), so one missing
# or extra 64-key tile would pass it; phase_lm_kernels plants such faults
# in the plain version and checks that this limit catches them.
ATTN_ROW_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Full-width RecurrentGemma-9B, kernels vs plain route, the trunk's output
# less the embedding: the worst position's difference norm over its norm.
# bf16 rounding differences that grow through 38 random layers give
# 5.6e-2; run (e), the last attention layer's last 64 rows zeroed, gives
# 0.44 (NVIDIA H100 80GB HBM3, 700.00 W).
TRUNK_ROW_TOL = 0.2
# ssd_scan against its plain version, as tests/test_kernels.py holds the
# Pallas kernel to its oracle: |kernel - plain| <= atol + rtol |plain| in
# y and in the final state.
SSD_ATOL, SSD_RTOL = 5e-5, 5e-4


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_environment() -> str:
    print("== environment")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f", count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    print("== build")
    t0 = time.perf_counter()
    _build.load()
    print(f"built {len(list(_build.CSRC.glob('*.cu')))} sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for log in _build.BUILD_LOG:
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "warning", "error")):
                print("  " + line.strip())
    # setmaxnreg is ignored (ptxas C7508) unless the bf16 flash_attention
    # kernel's producer and consumer roles never reconverge.
    if _build.BUILD_LOG:
        check(not any("C7508" in log for log in _build.BUILD_LOG),
              "ptxas reports no ignored setmaxnreg (C7508)")
        # (the prep kernel, which both cap flags launch, is built in the
        # capped kernels' source too: its lines are counted once)
        f32 = list(dict.fromkeys(ptxas_report(F32_ATTN_KERNELS)))
        capped = [line for line in f32 if "Lb1E" in line]
        f32 = [line for line in f32 if "Lb1E" not in line]
        check(len(f32) == 10 and all(" 0 bytes spill stores" in line
                                     for line in f32),
              f"ptxas reports no spills for the {len(f32)} uncapped f32 "
              f"attention kernels (forward and backward at D 64, 128 and "
              f"256, prep)")
        print(f"  the {len(capped)} soft-capped f32 attention kernels "
              f"(spills reported, not gated): "
              + "; ".join(capped))
    else:
        print("  library built by an earlier run: no ptxas output here")


def run_engine(cfg, scenario: str, m: int, cycles: int):
    """One engine run through the user entry point; returns the journal,
    the per-cycle analyses, the launch counts of this run alone and the
    packing (with its rhs) that the run solved first."""
    from repro_torch.assim import AssimilationEngine
    from repro_torch.kernels import ops

    eng = AssimilationEngine(cfg)
    analyses = []
    eng.on_analysis = lambda cycle, x: analyses.append(x)
    solved = []
    solve_input = eng.solve_input

    def keep_first(prep):
        out = solve_input(prep)
        if not solved:
            solved.append(out[0])
        return out

    eng.solve_input = keep_first
    ops.reset_counts()
    t0 = time.perf_counter()
    journal = eng.run_scenario(scenario, m=m, cycles=cycles)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    return journal, analyses, counts, wall, solved[0]


HOST_FIELDS = ("loads", "loads_before", "repartitioned", "migrated",
               "rounds", "rebalance_suppressed")


def phase_engine(title: str, cfg, scenario: str, m: int, cycles: int):
    print(f"== engine: {title}")
    runs = {}
    first = None
    variants = (("a", cfg), ("b", cfg),
                ("c", dataclasses.replace(cfg, solver_kernel="plain",
                                          gram_mode="plain")))
    for tag, c in variants:
        journal, xs, counts, wall, packed = run_engine(c, scenario, m,
                                                       cycles)
        runs[tag] = (journal, xs, counts)
        if tag == "a":
            first = packed
        errs = [r.error_vs_direct for r in journal.records]
        p50 = {k: round(v["p50"] * 1e3, 3)
               for k, v in journal.phase_stats().items()}
        print(f"  ({tag}) solver_kernel={c.solver_kernel} "
              f"gram_mode={c.gram_mode}: {wall:.2f} s for {cycles} cycles, "
              f"launches {counts}, max err vs direct {max(errs):.3e}")
        print(f"      phase p50 ms: {json.dumps(p50, sort_keys=True)}")
        check(len(journal.records) == cycles and all(
            e <= 1e-10 for e in errs),
            f"({tag}) every cycle within 1e-10 of the direct solve")
    ja, xa, ca = runs["a"]
    jb, xb, _ = runs["b"]
    jc, xc, cc = runs["c"]
    check(all(torch.equal(u, v) for u, v in zip(xa, xb)),
          "(a) and (b) analyses bitwise equal")
    diff = max(float((u - v).abs().max()) for u, v in zip(xa, xc))
    check(diff <= 1e-12, f"(a) vs (c) max abs diff {diff:.3e} <= 1e-12")
    for tag, j in (("b", jb), ("c", jc)):
        check(all(getattr(r, f) == getattr(s, f) for r, s in
                  zip(ja.records, j.records) for f in HOST_FIELDS),
              f"host decisions of (a) and ({tag}) identical")
    check(ca["gram"] >= cycles and ca["schwarz_fwd"] == cycles * cfg.iters
          and ca["schwarz_bwd"] == cycles * cfg.iters,
          f"(a) ran the kernels: {ca}")
    check(all(v == 0 for v in cc.values()), f"(c) ran no kernel: {cc}")
    from repro_torch.core import ddkf
    # Run (a)'s first packing and its analysis gathered to local slots:
    # the kernels' inputs on the main path.
    return ca, (first, ddkf.gather_local(first, xa[0]))


# The paper's baseline at Example 4's size: each solver against the direct
# CLS solve at the reference's own bounds (tests/test_cls_kalman.py,
# tests/test_dd_schwarz.py): (norm or max-abs, bound).
KF_BOUNDS = {"kf": ("norm", 1e-9), "cg": ("max", 1e-8),
             "schwarz_multiplicative": ("norm", 1e-9),
             "schwarz_additive": ("norm", 1e-8)}


def wall_s(fn):
    """(result, host wall seconds) of ``fn`` run to a synchronised end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_kf(smi: str) -> None:
    """The paper's sequential VAR-KF (its T^1), CG, and the Schwarz DD-CLS
    solver at p = 8 on DyDD boundaries, on Example 4's problem: n = 2048,
    m = 2000 beta(2, 5) observations, f64 on the card.  Each is held to
    ``cls.solve`` at the reference's bounds and timed (host wall clock to
    a synchronised end; the KF twice, the second run is T^1).  No custom
    kernel lies on these paths: their products are dense cuBLAS/cuSOLVER
    calls, as the reference computes them outside any Pallas kernel."""
    from repro_torch.core import cls, dd, dydd, kalman
    from repro_torch.kernels import ops

    print("== kf: the paper's baseline at Example 4's size (n=2048, m=2000 "
          "beta observations, f64)")
    rng = np.random.default_rng(0)
    obs = rng.beta(2.0, 5.0, 2000)
    prob = cls.local_problem(rng, 2048, obs)
    dec = dd.decompose_1d(prob.n, dydd.dydd_1d(obs, 8).boundaries)
    ops.reset_counts()
    x_direct, t_direct = wall_s(lambda: cls.solve(prob))
    _, t_first = wall_s(lambda: kalman.solve_cls_sequential(prob, block=50))
    kf_runs = [wall_s(lambda: kalman.solve_cls_sequential(prob, block=50))
               for _ in range(5)]
    kf_times = sorted(t for _, t in kf_runs)
    runs = {"kf": (kf_runs[-1][0], kf_times[2]),
            "cg": wall_s(lambda: cls.solve_cg(prob))}
    iters = {}
    for mode in ("multiplicative", "additive"):
        (x, k, _), t = wall_s(lambda: dd.SchwarzSolver(prob, dec).solve(
            iters=300, mode=mode))
        runs[f"schwarz_{mode}"] = (x, t)
        iters[f"schwarz_{mode}"] = k
    counts = ops.launch_counts()
    print(f"  direct cls.solve {t_direct * 1e3:.2f} ms; first KF run "
          f"{t_first * 1e3:.2f} ms ({smi})")
    for name, (x, t) in runs.items():
        kind, bound = KF_BOUNDS[name]
        d = x - x_direct
        err = float(torch.linalg.norm(d) if kind == "norm"
                    else d.abs().max())
        extra = f", {iters[name]} iterations" if name in iters else ""
        print(f"  {name}: {t * 1e3:.2f} ms{extra} ({smi})")
        check(bool(torch.isfinite(x).all()) and x.shape == (prob.n,)
              and err < bound, f"{name} within {bound:g} ({kind}) of the "
              f"direct solve: {err:.3e}")
    spread = ", ".join(f"{t * 1e3:.2f}" for t in kf_times)
    print(f"  T^1 (sequential VAR-KF, block 50): median "
          f"{kf_times[2] * 1e3:.2f} ms of 5 runs after the first ({spread} "
          f"ms; {smi})")
    check(all(v == 0 for v in counts.values()),
          f"the kf path launches no custom kernel: {counts}")


# Parareal at ex4_p8: the engine's sizes and the stream.
PINT = {"n": 2048, "p": 8, "m": 2000, "cycles": 8, "windows": 4}


def phase_pint(smi: str) -> None:
    """Parareal at ex4_p8 (n = 2048, p = 8, 120 iterations, m = 2000 on
    drifting_swarm, 8 cycles, 4 windows): (a) ``TimeParEngine`` through
    the kernels, (b) the sequential engine on the same stream, (c) the
    Parareal engine through the plain versions, (d) ``time_windows=1``.
    Each run starts with the launch counts at 0 and reads them at its
    end."""
    from repro_torch.assim import (AssimilationEngine, EngineConfig,
                                   TimeParEngine)
    from repro_torch.kernels import ops
    from repro_torch.obs import trace

    scenario, m, cycles = "drifting_swarm", PINT["m"], PINT["cycles"]
    cfg = EngineConfig(n=PINT["n"], p=PINT["p"], iters=120,
                       track_reference=True, time_windows=PINT["windows"])
    print(f"== pint: Parareal at ex4_p8 (n={cfg.n}, p={cfg.p}, iters=120, "
          f"m={m}, {scenario}, {cycles} cycles, {cfg.time_windows} "
          f"windows)")

    def run(tag, make, c):
        eng = make(c)
        chain = []
        if isinstance(eng, AssimilationEngine):
            eng.on_analysis = lambda cycle, x: chain.append(x)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tracer = trace.Tracer("chip_smoke")
        ops.reset_counts()
        t0 = time.perf_counter()
        with trace.tracing(tracer):
            journal = eng.run_scenario(scenario, m=m, cycles=cycles)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not chain:
            chain = [torch.as_tensor(x, device=DEVICE)
                     for x in eng.analyses]
        errs = [r.error_vs_direct for r in journal.records]
        print(f"  ({tag}) {type(eng).__name__} solver_kernel="
              f"{c.solver_kernel} gram_mode={c.gram_mode} time_windows="
              f"{c.time_windows}: {wall:.2f} s, peak memory {peak:.2f} GiB,"
              f" launches {counts}, max err vs direct {max(errs):.3e} "
              f"({smi})")
        if "pint" in journal.meta:
            split = {name: round(tracer.total_duration(f"pint.{name}"), 3)
                     for name in ("prepare", "coarse", "fine", "correct")}
            print(f"      Parareal spans, s: {json.dumps(split)}")
        else:
            split = {k: round(v["p50"] * 1e3, 3)
                     for k, v in journal.phase_stats().items()}
            print(f"      phase p50 ms: {json.dumps(split, sort_keys=True)}")
        check(len(journal.records) == cycles and all(
            e <= 1e-10 for e in errs),
            f"({tag}) every cycle within 1e-10 of the direct solve")
        return journal, chain, counts

    ja, xa, ca = run("a", TimeParEngine, cfg)
    jb, xb, _ = run("b", AssimilationEngine,
                    dataclasses.replace(cfg, time_windows=1))
    jc, xc, cc = run("c", TimeParEngine, dataclasses.replace(
        cfg, solver_kernel="plain", gram_mode="plain"))
    jd, xd, _ = run("d", TimeParEngine, dataclasses.replace(
        cfg, time_windows=1))
    pint = ja.meta["pint"]
    k, fine, coarse = pint["iters"], pint["fine_iters"], pint["coarse_iters"]
    print(f"  (a) Parareal: {k} iterations, correction norms "
          f"{pint['correction_norms']}, fine {fine} / coarse {coarse} "
          f"iterations a solve")
    check(pint["converged"] and pint["correction_norms"][-1] <= pint["tol"],
          f"(a) converged in {k} Parareal iterations")
    check(all(getattr(r, f) == getattr(s, f) for r, s in
              zip(ja.records, jb.records) for f in HOST_FIELDS),
          "host decisions of (a) and (b) identical")
    diff = max(float((u - v).abs().max()) for u, v in zip(xa, xb))
    check(diff <= 1e-6, f"(a) vs (b) chain max abs diff {diff:.3e} <= 1e-6")
    diff = max(float((u - v).abs().max()) for u, v in zip(xa, xc))
    check(diff <= 1e-9, f"(a) vs (c) chain max abs diff {diff:.3e} <= 1e-9")
    check(all(v == 0 for v in cc.values()), f"(c) ran no kernel: {cc}")
    want = k * cycles * fine + (k + 1) * cycles * coarse
    check(ca["schwarz_fwd"] == ca["schwarz_bwd"] == want
          and ca["gram"] == cycles,
          f"(a) launches: schwarz_fwd/bwd {ca['schwarz_fwd']}/"
          f"{ca['schwarz_bwd']} = k C fine + (k+1) C coarse = {want}, "
          f"gram {ca['gram']} = C")
    check(all(torch.equal(u, v) for u, v in zip(xb, xd))
          and jb.deterministic_json() == jd.deterministic_json(),
          "(d) time_windows=1 bitwise equal to (b)")


# The distributed solve: ranks sharing the one card over gloo (NCCL
# refuses two ranks on one GPU), collectives through pinned host copies.
SHARDMAP = {"ranks": 8, "backend": "gloo", "cycles": 2, "mvec_iters": 12}
# Parareal on the ranks: PINT cut to 4 cycles, one a window.  Every rank
# prepares and keeps every cycle's ex4_p8 packing (the coarse sweeps need
# them all); at 8 cycles, 8 ranks need more than the card's 80 GB.
SHARDMAP_PINT = dict(PINT, cycles=4)
SHARDMAP_RUNS = (
    ("ex4_p8", dict(n=2048, p=8, iters=120), "drifting_swarm", 2000,
     ("allreduce",)),
    ("shelf2d", dict(ndim=2, nx=64, ny=32, pr=2, pc=4, overlap=1,
                     damping=0.7, iters=120), "rotating_swarm", 2000,
     ("allreduce", "neighbour")),
)


def _sha(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def shardmap_rank(device, runs, cycles: int, pint: dict, tmp: str) -> dict:
    """One rank of ``phase_shardmap`` (spawned: importable by name).  Each
    engine run starts with the launch counts at 0 and reads them at its
    end; the packing each run solved first is kept for the checks.  The
    ex4_p8 run is ``MESH_RESUME``'s uninterrupted run, with its snapshots
    under ``tmp``; the fleet on a ("fleet",) mesh and ``compressed_psum``
    follow the Parareal run."""
    from repro_torch.assim import (AssimilationEngine, EngineConfig,
                                   TimeParEngine, streams)
    from repro_torch.core import ddkf
    from repro_torch.kernels import ops

    writes = keep_writes()
    out = {}
    for tag, kw, scenario, m, comms in runs:
        for comm in comms:
            cfg = EngineConfig(solver="shardmap", comm=comm,
                               track_reference=True, **kw)
            eng = AssimilationEngine(cfg, device=device)
            digests = keep_digests(eng)
            del writes[:]
            xs, first = [], []
            eng.on_analysis = lambda cycle, x: xs.append(x.cpu())
            solve_input = eng.solve_input

            def keep_first(prep, solve_input=solve_input, first=first):
                got = solve_input(prep)
                if not first:
                    first.append(got[0])
                return got

            eng.solve_input = keep_first
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_counts()
            t0 = time.perf_counter()
            if tag == MESH_RESUME["tag"]:
                r = MESH_RESUME
                journal = eng.run(
                    streams.ResumableStream(scenario, m, r["cycles"],
                                            seed=0),
                    checkpoint_dir=os.path.join(tmp, "uninterrupted"),
                    snapshot_every=r["snapshot_every"])
            else:
                journal = eng.run_scenario(scenario, m=m, cycles=cycles)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            pk = first[0]
            res = {"analyses": xs, "journal": journal.deterministic_dict(),
                   "records": journal.to_dict()["records"],
                   "counts": counts, "wall": wall,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "digests": digests, "writes": list(writes),
                   "mesh": eng.mesh.describe(),
                   "collectives": dict(eng.mesh.counts),
                   "first": pk.first, "shape": list(pk.A_loc.shape),
                   "sha": {"A_loc": _sha(pk.A_loc), "L_loc": _sha(pk.L_loc)}}
            if comm == "allreduce":
                # The m-vector paths held to each other on the first
                # packing, at SHARDMAP["mvec_iters"] iterations.
                solve = dict(axis=eng.mesh_axis, damping=cfg.damping,
                             iters=SHARDMAP["mvec_iters"])
                t0 = time.perf_counter()
                xs_ = ddkf.solve_shardmap(pk, eng.mesh, mvec="scatter",
                                          **solve)
                xp_ = ddkf.solve_shardmap(pk, eng.mesh, mvec="psum", **solve)
                res["mvec_diff"] = float((xs_ - xp_).abs().max())
                res["mvec_wall"] = time.perf_counter() - t0
            out[(tag, comm)] = res
            del eng, pk, first
    cfg = EngineConfig(n=pint["n"], p=pint["p"], iters=120,
                       track_reference=True, time_windows=pint["windows"])
    tp = TimeParEngine(cfg, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    journal = tp.run_scenario("drifting_swarm", m=pint["m"],
                              cycles=pint["cycles"])
    torch.cuda.synchronize()
    out["pint"] = {"analyses": [torch.as_tensor(a) for a in tp.analyses],
                   "pint": journal.meta["pint"],
                   "records": journal.to_dict()["records"],
                   "journal": journal.deterministic_dict(),
                   "wall": time.perf_counter() - t0,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del tp, journal, writes[:]
    out["fleet"] = mesh_fleet_rank(device, os.path.join(tmp, "fleet"),
                                   writes)
    out["compress"] = compress_rank(device)
    return out


# -- the DA fleet, resume and compressed_psum on a process mesh ---------------

def ex4_p8():
    """``EXAMPLE4``'s ``ex4_p8`` of the port's ``configs/cls_paper.py``:
    n = 2048, p = 8 on a chain, m = 2000 observations a cycle."""
    from repro_torch.configs.cls_paper import EXAMPLE4
    return next(c for c in EXAMPLE4 if c.name == "ex4_p8")


def keep_writes() -> list:
    """This rank's log of the checkpoint steps it writes: wraps
    ``checkpoint.manager.save_pytree``, which the engine calls through
    the module."""
    from repro_torch.checkpoint import manager as ckpt
    log, save = [], ckpt.save_pytree

    def logged(tree, directory, step, metadata=None):
        log.append((os.path.basename(directory), int(step)))
        return save(tree, directory, step, metadata)

    ckpt.save_pytree = logged
    return log


def keep_digests(eng) -> list:
    """The ``snapshot_digest`` of each snapshot ``eng`` takes."""
    from repro_torch.assim.engine import snapshot_digest
    log, snap = [], eng.snapshot

    def kept(*a, **kw):
        tree, meta = snap(*a, **kw)
        log.append(snapshot_digest(tree, meta))
        return tree, meta

    eng.snapshot = kept
    return log


# The fleet on an 8-rank ("fleet",) mesh at ex4_p8's width: (sid, scenario,
# seed, DyDD), two on DyDD and one static, 2 cycles each (3 in the CPU
# test; cut for the script's time), a snapshot every 2; a transient pack
# fault of one stream at cycle 1 and a transient cohort-solve fault of
# the server at round 1.
MESH_FLEET = {"iters": 120, "cycles": 2, "pack_workers": 4,
              "snapshot_every": 2, "pack_fault": ("drift", 1),
              "solve_fault_round": 1}
MESH_FLEET_STREAMS = (("drift", "drifting_swarm", 0, True),
                      ("storm", "storm_front", 2, True),
                      ("static", "drifting_swarm", 3, False))


def mesh_fleet_config(dydd: bool):
    from repro_torch.assim import EngineConfig
    case = ex4_p8()
    return EngineConfig(n=case.n, p=case.p, iters=MESH_FLEET["iters"],
                        rebalance=dydd, track_reference=True)


def mesh_fleet_stream(name: str, seed: int):
    from repro_torch.assim import streams
    return streams.ResumableStream(name, ex4_p8().m, MESH_FLEET["cycles"],
                                   seed=seed)


def mesh_fleet_rank(device, tmp: str, writes: list) -> dict:
    """``FleetServer(mesh=...)`` over ``MESH_FLEET_STREAMS`` on a mesh of
    every rank; launch counts from 0 over the serve."""
    from repro_torch.assim.serving import FleetServer
    from repro_torch.assim.engine import AssimilationEngine
    from repro_torch.kernels import ops
    from repro_torch.obs import meters
    from repro_torch.runtime.chaos import ChaosConfig, ChaosInjector
    from repro_torch.runtime.mesh import ProcessMesh

    f = MESH_FLEET
    mesh = ProcessMesh((torch.distributed.get_world_size(),), ("fleet",),
                       device=device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reg = meters.Meters()
    prev = meters.set_meters(reg)
    digests = {}
    try:
        server = FleetServer(
            mesh=mesh, mesh_axis="fleet", device=device,
            pack_workers=f["pack_workers"], gather_window=1.0,
            chaos=ChaosInjector(ChaosConfig(
                solve_fault_cycles=(f["solve_fault_round"],))))
        for sid, name, seed, dydd in MESH_FLEET_STREAMS:
            chaos = (ChaosInjector(ChaosConfig(
                pack_fault_cycles=(f["pack_fault"][1],)))
                if sid == f["pack_fault"][0] else None)
            eng = AssimilationEngine(mesh_fleet_config(dydd), device,
                                     chaos=chaos)
            digests[sid] = keep_digests(eng)
            server.add_stream(sid, eng.cfg, mesh_fleet_stream(name, seed),
                              engine=eng,
                              checkpoint_dir=os.path.join(tmp, sid),
                              snapshot_every=f["snapshot_every"])
        ops.reset_counts()
        t0 = time.perf_counter()
        journals = server.serve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        meters.set_meters(prev)
    snap = reg.snapshot()
    return {"journals": {k: j.deterministic_dict()
                         for k, j in journals.items()},
            "errors": {k: [r.error_vs_direct for r in j.records]
                       for k, j in journals.items()},
            "analysis": {k: e.analysis.cpu()
                         for k, e in server.engines.items()},
            "cohorts": [(e["size"], e["capacity"], e["w"])
                        for e in snap["events"]
                        if e["name"] == "fleet.cohort"],
            "retries": sorted((e["site"], str(e.get("sid")))
                              for e in snap["events"]
                              if e["name"] == "chaos.retry"),
            "counts": counts, "wall": wall,
            "rounds": server.stats["rounds"], "digests": digests,
            "writes": list(writes), "objects": mesh.counts["objects"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


# compressed_psum on the 8 ranks: each rank's gradient and error buffer
# drawn on the card from seed + rank.
COMPRESS = {"shape": (4096, 4096), "seed": 28}


def compress_inputs(dtype, rank: int, device):
    gen = torch.Generator(device=device).manual_seed(COMPRESS["seed"] + rank)
    g = torch.randn(COMPRESS["shape"], generator=gen, device=device)
    e = 1e-2 * torch.randn(COMPRESS["shape"], generator=gen, device=device)
    return g.to(dtype), e


def compress_rank(device) -> dict:
    """``compressed_psum`` of this rank's gradients on a ("data",) mesh:
    the hashes of the mean and the new error, and the wall."""
    from repro_torch.optim import compress
    from repro_torch.runtime.mesh import ProcessMesh

    mesh = ProcessMesh((torch.distributed.get_world_size(),), ("data",),
                       device=device)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        g, e = compress_inputs(dtype, mesh.rank, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mean, err = compress.compressed_psum(g, e, "data", mesh=mesh)
        torch.cuda.synchronize()
        out[str(dtype)] = {"mean": _sha(mean.float()), "error": _sha(err),
                           "wall": time.perf_counter() - t0,
                           "peak_gib": torch.cuda.max_memory_allocated()
                           / 2**30}
    return out


def pint_single(pint: dict) -> tuple:
    """(sequential chain, Parareal iterations) of one process at ``pint``
    on the card: what the ranks' Parareal run is held to."""
    from repro_torch.assim import (AssimilationEngine, EngineConfig,
                                   TimeParEngine)

    cfg = EngineConfig(n=pint["n"], p=pint["p"], iters=120,
                       time_windows=pint["windows"])
    tp = TimeParEngine(cfg)
    tp.run_scenario("drifting_swarm", m=pint["m"], cycles=pint["cycles"])
    seq = AssimilationEngine(dataclasses.replace(cfg, time_windows=1))
    chain = []
    seq.on_analysis = lambda cycle, x: chain.append(x)
    seq.run_scenario("drifting_swarm", m=pint["m"], cycles=pint["cycles"])
    return chain, tp.journal.meta["pint"]["iters"]


def phase_shardmap(smi: str) -> tuple:
    """The parallel DD-KF over ``torch.distributed``: 8 ranks on the one
    card (gloo, host transport), each running the engine with
    ``solver="shardmap"`` on its own subdomain, then ``TimeParEngine`` on
    the auto ("time", "sub") mesh.  (a) ex4_p8 (``MESH_RESUME``'s 4
    cycles, a snapshot every 2: the uninterrupted run that the mesh
    resume is held to) and (b) the 2D shelf (both exchanges, 2 cycles)
    are held to the single-process vmapped engine on the same stream and
    seed; (c) Parareal at ``SHARDMAP_PINT`` to one process's sequential
    chain and iteration count at the same config.  The same ranks then
    serve the fleet on a ("fleet",) mesh (``check_mesh_fleet``) and run
    ``compressed_psum`` (``check_compress``).  A correctness run of
    ranks that share one card, not a speed-up.  Returns rank 0's first
    ex4_p8 packing's inputs and its launch counts, for the per-rank
    kernel rows, and the ranks' ex4_p8 runs."""
    import tempfile
    from repro_torch.assim import EngineConfig
    from repro_torch.runtime import mesh

    ranks, cycles = SHARDMAP["ranks"], SHARDMAP["cycles"]
    print(f"== shardmap: {ranks} ranks on one card over "
          f"{SHARDMAP['backend']}, {cycles} cycles a run, ex4_p8 "
          f"{MESH_RESUME['cycles']} ({smi})")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = mesh.launch(shardmap_rank, ranks,
                          backend=SHARDMAP["backend"],
                          args=(SHARDMAP_RUNS, cycles, SHARDMAP_PINT, tmp),
                          timeout=MESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        print(f"  {ranks} ranks spawned, ran and joined in {wall:.2f} s "
              f"({smi})")
        for key in out[0]:
            if "wall" not in out[0][key]:
                continue
            walls = [round(o[key]["wall"], 3) for o in out]
            mvec = [round(o[key].get("mvec_wall", 0.0), 3) for o in out]
            peak = [round(o[key].get("peak_gib", 0.0), 2) for o in out]
            print(f"  {key} walls per rank, s: {walls}; the two mvec "
                  f"solves {mvec}; peak memory per rank, GiB: {peak}")
        check_mesh_fleet([o["fleet"] for o in out], tmp, smi)
    check_compress([o["compress"] for o in out], smi)
    first_1d = None
    for tag, kw, scenario, m, comms in SHARDMAP_RUNS:
        run_cycles = (MESH_RESUME["cycles"] if tag == MESH_RESUME["tag"]
                      else cycles)
        single, xv, cv, _, packed = run_engine(
            EngineConfig(track_reference=True, **kw), scenario, m,
            run_cycles)
        for comm in comms:
            res = [o[(tag, comm)] for o in out]
            r0 = res[0]
            label = f"({tag}, {comm})"
            print(f"  {label} single-process vmapped launches {cv}; mesh "
                  f"{r0['mesh']}; collectives a rank {r0['collectives']}")
            check(r0["mesh"]["transport"] == "host"
                  and r0["mesh"]["backend"] == "gloo",
                  f"{label} gloo with host transport: {r0['mesh']}")
            check(all(len(r["analyses"]) == run_cycles and all(
                torch.equal(a, b) for a, b in zip(r["analyses"],
                                                  r0["analyses"]))
                for r in res), f"{label} every rank's analysis bitwise "
                f"the same")
            check(all(r["journal"] == r0["journal"] for r in res),
                  f"{label} every rank's deterministic journal the same")
            diff = max(float((a - b.cpu()).abs().max())
                       for a, b in zip(r0["analyses"], xv))
            check(diff <= 1e-13, f"{label} vs the single-process vmapped "
                  f"engine: max abs diff {diff:.3e} <= 1e-13")
            errs = [rec["error_vs_direct"] for rec in r0["records"]]
            check(all(e <= 1e-10 for e in errs), f"{label} every cycle "
                  f"within 1e-10 of the direct solve: {max(errs):.3e}")
            check(all(rec[f] == getattr(want, f)
                      for rec, want in zip(r0["records"], single.records)
                      for f in HOST_FIELDS),
                f"{label} loads and repartition decisions equal")
            want = {"gram": run_cycles,
                    "schwarz_fwd": run_cycles * kw["iters"],
                    "schwarz_bwd": run_cycles * kw["iters"]}
            check(all({k: r["counts"][k] for k in want} == want
                      for r in res),
                  f"{label} launches per rank {want}: "
                  f"{[r['counts']['schwarz_fwd'] for r in res]}")
            same = {f: [r["sha"][f] == _sha(getattr(packed, f)[
                r["first"]:r["first"] + 1]) for r in res]
                for f in ("A_loc", "L_loc")}
            check(all(same["A_loc"] + same["L_loc"])
                  and [r["first"] for r in res] == list(range(ranks)),
                  f"{label} each rank's block (A_loc {r0['shape']}, L_loc) "
                  f"bitwise the rows of the single-process packing: {same}")
            if "mvec_diff" in r0:
                d = max(r["mvec_diff"] for r in res)
                check(d <= 1e-13,
                      f"{label} mvec scatter vs psum {d:.3e} <= 1e-13")
            if tag == MESH_RESUME["tag"] and first_1d is None:
                first_1d = (packed, xv[0], r0["counts"])
                uninterrupted = res
                check_single_writer(res, label)
        if len(comms) == 2:
            a, n = (out[0][(tag, c)]["records"] for c in comms)
            check(all(y["comm_bytes_per_cycle"] < x["comm_bytes_per_cycle"]
                      for x, y in zip(a, n)),
                  f"({tag}) neighbour comm bytes below allreduce: "
                  f"{[y['comm_bytes_per_cycle'] for y in n]} < "
                  f"{[x['comm_bytes_per_cycle'] for x in a]}")
    xs_seq, k_seq = pint_single(SHARDMAP_PINT)
    res = [o["pint"] for o in out]
    r0 = res[0]
    pint = r0["pint"]
    peaks = [round(r["peak_gib"], 2) for r in res]
    print(f"  (pint) peak memory a rank {peaks} GiB; {pint['iters']} "
          f"Parareal iterations, correction norms "
          f"{pint['correction_norms']}")
    check(pint["mesh"] == {"time": 4, "sub": 2},
          f"(pint) auto mesh {pint['mesh']}")
    check(pint["converged"] and pint["iters"] == k_seq,
          f"(pint) converged in {pint['iters']} iterations, as the "
          f"single-process run ({k_seq})")
    check(all(r["journal"] == r0["journal"] and all(
        torch.equal(a, b) for a, b in zip(r["analyses"], r0["analyses"]))
        for r in res), "(pint) every rank's chain and journal the same")
    diff = max(float((a - b.cpu()).abs().max())
               for a, b in zip(r0["analyses"], xs_seq))
    check(len(r0["analyses"]) == SHARDMAP_PINT["cycles"] and diff <= 1e-6,
          f"(pint) chain vs the sequential engine {diff:.3e} <= 1e-6")
    errs = [rec["error_vs_direct"] for rec in r0["records"]]
    check(all(e <= 1e-10 for e in errs),
          f"(pint) every cycle within 1e-10 of the direct solve: "
          f"{max(errs):.3e}")
    return first_1d, uninterrupted


def check_single_writer(res: list, label: str) -> None:
    """Rank 0 alone wrote each step of the ranks' checkpointed run, and
    every rank's snapshot of each step hashed the same before the
    write."""
    r = MESH_RESUME
    steps = list(range(r["snapshot_every"], r["cycles"] + 1,
                       r["snapshot_every"]))
    print(f"  {label} steps written by rank: "
          f"{[x['writes'] for x in res]}; snapshot sha256 rank 0 "
          f"{[d[:12] for d in res[0]['digests']]}")
    check(res[0]["writes"] == [("uninterrupted", s) for s in steps]
          and all(x["writes"] == [] for x in res[1:]),
          f"{label} rank 0 alone wrote steps {steps}")
    check(all(x["digests"] == res[0]["digests"] for x in res)
          and len(res[0]["digests"]) == len(steps),
          f"{label} every rank's snapshot of each step the same")


def check_mesh_fleet(res: list, tmp: str, smi: str) -> None:
    """(a) of the mesh phases: the ranks' fleet against each stream run
    alone in this process on the card."""
    from repro_torch.assim import AssimilationEngine
    from repro_torch.checkpoint import manager as ckpt

    f, r0 = MESH_FLEET, res[0]
    print(f"  (fleet mesh) {len(MESH_FLEET_STREAMS)} streams x "
          f"{f['cycles']} cycles at ex4_p8 width on {len(res)} ranks: "
          f"walls per rank {[round(x['wall'], 3) for x in res]} s, peak "
          f"memory per rank {[round(x['peak_gib'], 2) for x in res]} GiB, "
          f"{r0['rounds']} rounds, cohorts (size/capacity, w) "
          + ", ".join(f"{a}/{c} w{w}" for a, c, w in r0["cohorts"])
          + f"; launches per rank {[x['counts']['schwarz_fwd'] for x in res]}"
          f" schwarz_fwd; {r0['objects']} agreements a rank ({smi})")
    alone_wall = 0.0
    for sid, name, seed, dydd in MESH_FLEET_STREAMS:
        eng = AssimilationEngine(mesh_fleet_config(dydd))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        journal = eng.run(mesh_fleet_stream(name, seed))
        torch.cuda.synchronize()
        alone_wall += time.perf_counter() - t0
        want = journal.deterministic_dict()
        check(all(x["journals"][sid] == want and torch.equal(
            x["analysis"][sid], eng.analysis.cpu()) for x in res),
            f"(fleet mesh) {sid}: every rank's journal and final analysis "
            f"bitwise the stream run alone")
        errs = r0["errors"][sid]
        check(len(errs) == f["cycles"] and max(errs) <= 1e-10,
              f"(fleet mesh) {sid}: every cycle within 1e-10 of the direct "
              f"solve ({max(errs):.3e})")
        check(all(x["digests"][sid] == r0["digests"][sid] for x in res)
              and ckpt.verify(ckpt.latest_checkpoint(
                  os.path.join(tmp, "fleet", sid))),
              f"(fleet mesh) {sid}: every rank's snapshot the same, the "
              f"step verified")
    print(f"  (fleet mesh) the streams alone one after another: "
          f"{alone_wall:.2f} s")
    check(all(x["cohorts"] == r0["cohorts"] for x in res)
          and all(c == len(res) for _, c, _ in r0["cohorts"]),
          f"(fleet mesh) every cohort's capacity {len(res)}, the same "
          f"cohorts on every rank")
    check(all(x["retries"] == [("pack", f["pack_fault"][0]),
                               ("solve", "None")] for x in res),
          "(fleet mesh) the pack and solve faults retried once on every "
          "rank")
    steps = [(sid, s) for sid, _, _, _ in MESH_FLEET_STREAMS
             for s in range(f["snapshot_every"], f["cycles"] + 1,
                            f["snapshot_every"])]
    check(sorted(r0["writes"]) == sorted(steps)
          and all(x["writes"] == [] for x in res[1:]),
          f"(fleet mesh) rank 0 alone wrote the streams' steps: "
          f"{[x['writes'] for x in res]}")
    prepared = len(MESH_FLEET_STREAMS) * f["cycles"]
    want = [{"gram": prepared,
             "schwarz_fwd": f["iters"] * len(x["cohorts"]),
             "schwarz_bwd": f["iters"] * len(x["cohorts"])} for x in res]
    check(all({k: x["counts"][k] for k in w} == w
              for x, w in zip(res, want))
          and sum(a for a, _, _ in r0["cohorts"]) == prepared,
          f"(fleet mesh) launches per rank: gram {prepared} (every rank "
          f"prepares every stream), each Schwarz kernel {f['iters']} for "
          f"its one slot of each of the {len(r0['cohorts'])} cohort "
          f"solves: {want[0]}")


def check_compress(res: list, smi: str) -> None:
    """(c) of the mesh phases: every rank's mean the same bits, those of
    one process's int32 sum times the max scale over the rank count, and
    each rank's new error its own (g + e) - q * scale."""
    from repro_torch.optim import compress

    k = len(res)
    for dtype in (torch.float32, torch.bfloat16):
        qs = []
        for r in range(k):
            g, e = compress_inputs(dtype, r, DEVICE)
            s = g.float() + e
            q, scale = compress.quantize(s)
            qs.append((q, scale, _sha(
                (s.double() - q.double() * scale.double()).float())))
            del g, e, s
        total = sum(q.to(torch.int32) for q, _, _ in qs)
        smax = max(sc for _, sc, _ in qs)
        want = _sha((total.float() * smax / k).to(dtype).float())
        got = [x[str(dtype)] for x in res]
        print(f"  (compressed_psum) {str(dtype)} {COMPRESS['shape']} on "
              f"{k} ranks: walls per rank "
              f"{[round(x['wall'] * 1e3, 1) for x in got]} ms, peak memory "
              f"per rank {[round(x['peak_gib'], 2) for x in got]} GiB "
              f"({smi})")
        check(all(x["mean"] == want for x in got),
              f"(compressed_psum) {dtype}: every rank's mean bitwise the "
              f"int32 sum x max scale / {k}")
        check(all(x["error"] == q[2] for x, q in zip(got, qs)),
              f"(compressed_psum) {dtype}: each rank's new error its own "
              f"(g + e) - q * scale")
        del qs, total


def shardmap_rows(first_1d) -> list:
    """``gram``, ``schwarz_fwd`` and ``schwarz_bwd`` at a rank's shape
    (1, m, w): rank 0's block of the ex4_p8 run's first packing, with the
    m-vector all the ranks reduce, against the plain versions there and on
    random values, timed beside the bound, the plain version and cuBLAS;
    ``launches`` is rank 0's count in the ``shardmap`` run."""
    packed, x_glob, counts = first_1d
    from repro_torch.core import ddkf
    print("== kernels at a rank's block (ex4_p8, rank 0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    whole = kernel_cases(packed, ddkf.gather_local(packed, x_glob),
                         torch.float64)
    A, r, b, Ax, u, x, muov, mask = whole["schwarz_bwd"]
    one = slice(0, 1)
    cases = {"gram": (A[one].contiguous(), whole["gram"][1][one]),
             "schwarz_fwd": (A[one].contiguous(), x[one], packed.wdiv[one]),
             "schwarz_bwd": (A[one].contiguous(), r, b, Ax, u[one], x[one],
                             muov[one], mask[one])}
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = tuple(cases["gram"][0].shape)
    rows = []
    for name, args in cases.items():
        err = compare(name, args, torch.float64, f"rank 0 {shape}")
        rand = random_case(*shape, 0, torch.float64, gen)[name]
        err = max(err, compare(name, rand, torch.float64,
                               f"random {shape}"))
        if name == "gram":
            n1, n2 = _kernel(name)(*args), _kernel(name)(*args)
            check(torch.equal(n1, n2),
                  f"gram rank 0 {shape}: two launches bitwise equal")
            del n1, n2
        else:
            # rank 0's block alone: bitwise the batched launch's row 0,
            # twice; at an element offset, bitwise the aligned launch
            batch = _outs(_kernel(name)(*whole[name]))
            for _ in range(2):
                got = _outs(_kernel(name)(*args))
                check(all(torch.equal(a[0], b[0])
                          for a, b in zip(got, batch)),
                      f"{name} rank 0 {shape}: bitwise row 0 of the "
                      f"batched launch at {tuple(whole[name][0].shape)}")
            schwarz_offset(name, args, torch.float64, f"rank 0 {shape}")
            del batch, got
        reps = 5 if name == "gram" else 20
        bound, by = _bound(name, args)
        row = {"name": f"{name}_per_rank", "ok": True, "route": "cuda",
               "source": SOURCES[name], "replaces": REPLACES[name],
               "launches": counts[name], "max_abs_err": err,
               "ms": time_ms(lambda: _kernel(name)(*args), reps),
               "plain_ms": time_ms(lambda: _plain(name)(*args), reps),
               "bound_ms": bound, "bound_by": by,
               "library_ms": time_ms(_library(name, args), reps),
               "shape": list(shape), "dtype": "float64"}
        print(f"  {row['name']}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
              f"ms, bound {bound:.4f} ms ({by}), {counts[name]} launches "
              f"on rank 0")
        rows.append(row)
    schwarz_times(cases, {r["name"][:-len("_per_rank")]: r for r in rows},
                  f"rank 0 {shape}", 20)
    return rows


# The multi-tenant fleet at ex4_p8's width: (sid, scenario, seed, DyDD).
# The static pair is added first, so both start in the first admission
# and share a cohort key; the fifth stream waits for a slot.
FLEET = {"n": 2048, "p": 8, "m": 2000, "iters": 120, "cycles": 4,
         "max_active": 4, "pack_workers": 4, "snapshot_every": 2}
FLEET_STREAMS = (("static_3", "drifting_swarm", 3, False),
                 ("static_4", "drifting_swarm", 4, False),
                 ("dydd_drift", "drifting_swarm", 0, True),
                 ("dydd_bursty", "bursty_clusters", 1, True),
                 ("dydd_storm", "storm_front", 2, True))
# The faults: a transient pack fault of one stream at cycle 1, a
# transient cohort-solve fault of the server at round 1, and pack faults
# of one stream at cycle 2 on every attempt, which retire it as failed
# after its step-2 snapshot; it is readmitted from that snapshot.
FLEET_TRANSIENT_PACK = ("dydd_drift", 1)
FLEET_TRANSIENT_SOLVE_ROUND = 1
FLEET_FAILED = ("dydd_bursty", 2)


def p50_ms(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 50)) * 1e3


def phase_fleet(smi: str) -> None:
    """``FleetServer`` at ex4_p8's width (n = 2048, p = 8, m = 2000, 120
    iterations, 4 cycles) over five streams, three on DyDD and two
    static, with ``max_active=4``, four packing threads, a snapshot
    every 2 cycles and three injected faults (``FLEET_*``).  Each
    stream's journal and final analysis must equal the same stream run
    alone by ``AssimilationEngine.run`` bitwise, every cycle must be
    within 1e-10 of the direct solve, one cohort must stack two or more
    members, and the launch counts must follow: ``gram`` once for each
    stream and cycle prepared (no prepare is repeated: the readmitted
    stream resumes at its last snapshot, which the failed cycle
    follows), ``schwarz_fwd`` and ``schwarz_bwd`` ``iters`` times for
    each slot of each cohort solve, padded slots included."""
    import tempfile
    from repro_torch.assim import AssimilationEngine, EngineConfig, streams
    from repro_torch.assim.serving import FleetServer
    from repro_torch.kernels import ops
    from repro_torch.obs import meters
    from repro_torch.runtime.chaos import ChaosConfig, ChaosInjector

    f = FLEET
    cycles = f["cycles"]
    print(f"== fleet: FleetServer at ex4_p8 width (n={f['n']}, p={f['p']}, "
          f"m={f['m']}, iters={f['iters']}, {cycles} cycles, "
          f"{len(FLEET_STREAMS)} streams, max_active={f['max_active']}, "
          f"pack_workers={f['pack_workers']}, snapshot_every="
          f"{f['snapshot_every']})")

    def config(dydd: bool):
        return EngineConfig(n=f["n"], p=f["p"], iters=f["iters"],
                            rebalance=dydd, track_reference=True)

    def stream(name: str, seed: int):
        return streams.ResumableStream(name, f["m"], cycles, seed=seed)

    alone, alone_wall = {}, 0.0
    for sid, name, seed, dydd in FLEET_STREAMS:
        eng = AssimilationEngine(config(dydd))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        journal = eng.run(stream(name, seed))
        torch.cuda.synchronize()
        alone_wall += time.perf_counter() - t0
        alone[sid] = (journal, eng.analysis)

    reg = meters.Meters()
    prev = meters.set_meters(reg)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            server = FleetServer(
                max_active=f["max_active"], pack_workers=f["pack_workers"],
                gather_window=1.0, chaos=ChaosInjector(ChaosConfig(
                    solve_fault_cycles=(FLEET_TRANSIENT_SOLVE_ROUND,))))
            for sid, name, seed, dydd in FLEET_STREAMS:
                chaos = None
                if sid == FLEET_TRANSIENT_PACK[0]:
                    chaos = ChaosInjector(ChaosConfig(
                        pack_fault_cycles=(FLEET_TRANSIENT_PACK[1],)))
                elif sid == FLEET_FAILED[0]:
                    chaos = ChaosInjector(ChaosConfig(
                        pack_fault_cycles=(FLEET_FAILED[1],),
                        fail_every_attempt=True))
                server.add_stream(sid, config(dydd), stream(name, seed),
                                  checkpoint_dir=os.path.join(tmp, sid),
                                  snapshot_every=f["snapshot_every"],
                                  chaos=chaos)
            ops.reset_counts()
            t0 = time.perf_counter()
            journals = server.serve()
            failed = len(journals[FLEET_FAILED[0]])
            rounds = server.stats["rounds"]
            server.readmit(FLEET_FAILED[0])
            journals = server.serve()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            rounds += server.stats["rounds"]
    finally:
        meters.set_meters(prev)
    snap = reg.snapshot()
    cohorts = [e for e in snap["events"] if e["name"] == "fleet.cohort"]
    names = [e["name"] for e in snap["events"]]
    print(f"  {rounds} rounds; cohorts (size/capacity, w): "
          + ", ".join(f"{e['size']}/{e['capacity']} w{e['w']}"
                      for e in cohorts))
    print(f"  fleet wall {wall:.2f} s against {alone_wall:.2f} s for the "
          f"five streams run alone one after another; snapshot time p50 "
          f"{p50_ms(snap['series']['engine.snapshot_time']):.3f} ms over "
          f"{len(snap['series']['engine.snapshot_time'])} snapshots; peak "
          f"memory {peak:.2f} GiB; launches {counts} ({smi})")
    check(failed == FLEET_FAILED[1] and names.count("fleet.stream_failed")
          == 1 and names.count("fleet.stream_readmitted") == 1,
          f"{FLEET_FAILED[0]} retired as failed after {failed} cycles and "
          f"was readmitted")
    check(snap["counters"]["chaos.retries"] == 4 and sorted(
        (e["site"], e.get("sid")) for e in snap["events"]
        if e["name"] == "chaos.retry") == [
            ("pack", FLEET_FAILED[0])] * 2 + [
            ("pack", FLEET_TRANSIENT_PACK[0])] + [("solve", None)],
          "the transient pack and solve faults were retried once each, the "
          "failing stream's twice")
    for sid, _, _, _ in FLEET_STREAMS:
        journal, x = alone[sid]
        fj = journals[sid]
        check(len(fj.records) == cycles and all(
            r.error_vs_direct <= 1e-10 for r in fj.records),
            f"{sid}: {cycles} cycles, each within 1e-10 of the direct "
            f"solve (max {max(r.error_vs_direct for r in fj.records):.3e})")
        check(fj.deterministic_json() == journal.deterministic_json()
              and torch.equal(server.engines[sid].analysis, x),
              f"{sid}: journal and final analysis bitwise equal to the "
              f"stream run alone")
    stacked = [e for e in cohorts if e["capacity"] >= 2]
    check(any(e["size"] >= 2 for e in stacked),
          f"{len(stacked)} cohort solves went through stack_packed/"
          f"solve_fleet, one with two or more members")
    members = sum(e["size"] for e in cohorts)
    slots = sum(e["capacity"] for e in cohorts)
    prepared = sum(len(j.records) for j in journals.values())
    check(members == prepared == len(FLEET_STREAMS) * cycles
          and counts["gram"] == prepared
          and counts["schwarz_fwd"] == counts["schwarz_bwd"]
          == f["iters"] * slots,
          f"launches: gram {counts['gram']} = streams x cycles = "
          f"{prepared}; schwarz_fwd/bwd {counts['schwarz_fwd']}/"
          f"{counts['schwarz_bwd']} = iters x cohort slots = {f['iters']} "
          f"x {slots} ({slots - members} padded)")


# Resume onto a mesh at ex4_p8 (``phase_mesh_resume``): the ranks'
# ``solver="shardmap"`` engine, 4 cycles, a snapshot every 2, every rank
# killed at the end of cycle 1 (after the step-2 snapshot is published);
# step 2 resumed on 8 ranks and elastically at p = 4 on 4.  Its
# uninterrupted run is the ``shardmap`` phase's ex4_p8 run.  Cut from 6
# cycles killed after cycle 3 for the script's time: each ex4_p8 cycle
# costs ≈ 12 s a rank while 8 ranks share the card.
MESH_RESUME = {"tag": "ex4_p8", "cycles": 4, "snapshot_every": 2,
               "kill_cycle": 1, "elastic_p": 4}
# The collective timeout of the mesh launches.
MESH_TIMEOUT_S = 300


def mesh_resume_config():
    from repro_torch.assim import EngineConfig
    case = ex4_p8()
    return EngineConfig(n=case.n, p=case.p, iters=120, solver="shardmap",
                        track_reference=True)


def killed_mesh_rank(device, ck: str) -> None:
    """The ranks' ex4_p8 run of ``MESH_RESUME``, killed by every rank's
    injector at the end of cycle ``kill_cycle``."""
    from repro_torch.assim import AssimilationEngine, streams
    from repro_torch.runtime.chaos import ChaosConfig, ChaosInjector

    r = MESH_RESUME
    eng = AssimilationEngine(mesh_resume_config(), device,
                             chaos=ChaosInjector(ChaosConfig(
                                 kill_cycles=(r["kill_cycle"],))))
    eng.run(streams.ResumableStream("drifting_swarm", ex4_p8().m,
                                    r["cycles"], seed=0),
            checkpoint_dir=ck, snapshot_every=r["snapshot_every"])
    raise SmokeFailure("the injector did not kill this rank")


def resume_mesh_rank(device, path: str, p) -> dict:
    """``resume_assim_engine`` of ``path`` on this launch's ranks (at ``p``
    when given), run to the stream's end; launch counts from 0."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import elastic

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    eng, stream = elastic.resume_assim_engine(path, p=p)
    pos = stream.pos
    journal = eng.run(stream)
    torch.cuda.synchronize()
    return {"pos": pos, "journal": journal.deterministic_dict(),
            "records": journal.to_dict()["records"],
            "resume": journal.meta["resume"], "mesh": eng.mesh.describe(),
            "analysis": eng.analysis.cpu(), "counts": ops.launch_counts(),
            "wall": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_mesh_resume(smi: str, uninterrupted: list) -> None:
    """(b) of the mesh phases: ``MESH_RESUME``'s run on 8 ranks killed at
    the end of cycle ``kill_cycle`` (the launch must raise naming the
    signal, within the collective timeout; the newest verified step the
    one after it), resumed on 8 ranks bitwise the ``shardmap`` phase's
    uninterrupted run, and elastically at p = 4 on 4 ranks, each
    remaining cycle within 1e-10 of the direct solve."""
    import tempfile
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.runtime import mesh

    r, case = MESH_RESUME, ex4_p8()
    at = r["kill_cycle"] + 1
    rest = r["cycles"] - at
    iters = mesh_resume_config().iters
    print(f"== mesh resume: ex4_p8 (n={case.n}, p={case.p}, m={case.m}) "
          f"with solver='shardmap' on {case.p} ranks, {r['cycles']} cycles, "
          f"a snapshot every {r['snapshot_every']}, killed after cycle "
          f"{r['kill_cycle']}; resumed on {case.p} ranks and at p="
          f"{r['elastic_p']} ({smi})")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            mesh.launch(killed_mesh_rank, case.p, backend="gloo",
                        args=(tmp,), timeout=MESH_TIMEOUT_S)
            died = "the launch returned"
        except Exception as exc:     # the ranks' kill must fail the launch
            died = f"{type(exc).__name__}: {exc}"
        wall = time.perf_counter() - t0
        print(f"  killed launch ended in {wall:.2f} s: {died.strip()[:200]}")
        step = os.path.join(tmp, "step_%08d" % at)
        check("SIGKILL" in died and wall < MESH_TIMEOUT_S,
              f"the launch raised naming SIGKILL within the "
              f"{MESH_TIMEOUT_S} s collective timeout")
        check(ckpt.latest_checkpoint(tmp) == step and ckpt.verify(step),
              f"the newest verified step is {at}")
        for label, p, ranks, want in (
                (f"same p={case.p}", None, case.p, uninterrupted),
                (f"elastic p={r['elastic_p']}", r["elastic_p"],
                 r["elastic_p"], None)):
            t0 = time.perf_counter()
            res = mesh.launch(resume_mesh_rank, ranks, backend="gloo",
                              args=(tmp, p), timeout=MESH_TIMEOUT_S)
            wall = time.perf_counter() - t0
            x0 = res[0]
            print(f"  ({label}) launch {wall:.2f} s; walls per rank "
                  f"{[round(x['wall'], 3) for x in res]} s, peak memory per "
                  f"rank {[round(x['peak_gib'], 2) for x in res]} GiB, mesh "
                  f"{x0['mesh']['shape']}, resume {x0['resume']} ({smi})")
            check(all(x["pos"] == at and x["journal"] == x0["journal"]
                      and torch.equal(x["analysis"], x0["analysis"])
                      for x in res),
                  f"({label}) every rank resumed at cycle {at} with the "
                  f"same journal and analysis")
            check(all({k: x["counts"][k] for k in want_counts(rest, iters)}
                      == want_counts(rest, iters) for x in res),
                  f"({label}) launches per rank {want_counts(rest, iters)}: "
                  f"{[x['counts']['schwarz_fwd'] for x in res]}")
            errs = [rec["error_vs_direct"] for rec in x0["records"][at:]]
            check(len(errs) == rest and max(errs) <= 1e-10,
                  f"({label}) cycles {at}-{r['cycles'] - 1} within 1e-10 "
                  f"of the direct solve ({max(errs):.3e})")
            if want is not None:
                check(x0["journal"] == want[0]["journal"]
                      and torch.equal(x0["analysis"],
                                      want[0]["analyses"][-1]),
                      f"({label}) journal and final analysis bitwise the "
                      f"uninterrupted run's")
            else:
                check(x0["mesh"]["shape"] == {"sub": r["elastic_p"]}
                      and all(len(rec["loads"]) == r["elastic_p"]
                              for rec in x0["records"][at:])
                      and x0["resume"][-1] == {"at_cycle": at,
                                               "p": r["elastic_p"],
                                               "remeshed": True},
                      f"({label}) the remaining cycles on {r['elastic_p']} "
                      f"subdomains, none replayed")


def want_counts(cycles: int, iters: int) -> dict:
    """A shardmap rank's launches over ``cycles`` cycles: one ``gram`` (its
    block) and ``iters`` of each Schwarz kernel a cycle."""
    return {"gram": cycles, "schwarz_fwd": cycles * iters,
            "schwarz_bwd": cycles * iters}


# The resume checks at ex4_p8: 6 cycles, a snapshot every 2, the process
# killed at the end of cycle 3 (after its step-4 snapshot).
RESUME = {"n": 2048, "p": 8, "m": 2000, "iters": 120, "cycles": 6,
          "snapshot_every": 2, "kill_cycle": 3, "elastic_p": 4}

_RESUME_CHILD = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.assim import EngineConfig, AssimilationEngine, streams
from repro_torch.runtime.chaos import ChaosConfig, ChaosInjector
chaos = ChaosInjector(ChaosConfig(kill_cycles=({kill},)))
eng = AssimilationEngine(EngineConfig(**{cfg!r}), chaos=chaos)
eng.run(streams.ResumableStream("drifting_swarm", {m}, {cycles}, seed=0),
        checkpoint_dir={ck!r}, snapshot_every={every})
print("UNREACHABLE")
"""


def phase_resume(smi: str) -> None:
    """Checkpoint and resume at ex4_p8 on the card.  Kill: a child
    process runs 6 cycles with a snapshot every 2 and is SIGKILLed at the
    end of cycle 3; the newest verified step must be 4, and the resume
    here must give a journal and final analysis bitwise equal to an
    uninterrupted run.  Elastic: the same step resumed at p = 4, each
    remaining cycle within 1e-10 of the direct solve.  Torn: a torn step
    4 fails ``verify`` and ``latest_checkpoint`` falls back to step 2.
    Parareal: ``TimeParEngine`` over 4 cycles in 2 windows with a
    snapshot every window; the sequential engine resumed from step 2
    repeats the tail's DyDD decisions and ends within 1e-6 of it."""
    import signal
    import tempfile
    from repro_torch.assim import (AssimilationEngine, EngineConfig,
                                   TimeParEngine, streams)
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.runtime import chaos, elastic

    r = RESUME
    cfg_kw = dict(n=r["n"], p=r["p"], iters=r["iters"],
                  track_reference=True)
    print(f"== resume: kill, torn, elastic and Parareal checkpoints at "
          f"ex4_p8 (n={r['n']}, p={r['p']}, m={r['m']}, drifting_swarm, "
          f"{r['cycles']} cycles, snapshot every {r['snapshot_every']})")
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "kill")
        script = _RESUME_CHILD.format(
            src=os.path.join(HERE, "src"), cfg=cfg_kw, kill=r["kill_cycle"],
            m=r["m"], cycles=r["cycles"], ck=ck, every=r["snapshot_every"])
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, timeout=300)
        print(f"  child ran {time.perf_counter() - t0:.1f} s, exit "
              f"{out.returncode}")
        check(out.returncode == -signal.SIGKILL
              and "UNREACHABLE" not in out.stdout,
              f"the child died by SIGKILL{out.stderr[-2000:]}")
        latest = ckpt.latest_checkpoint(ck)
        step4 = os.path.join(ck, "step_00000004")
        check(latest == step4, f"latest verified checkpoint is "
              f"{os.path.basename(latest or 'none')}")

        base = AssimilationEngine(EngineConfig(**cfg_kw))
        base.run(streams.ResumableStream("drifting_swarm", r["m"],
                                         r["cycles"], seed=0))
        eng, stream = elastic.resume_assim_engine(ck)
        t0 = time.perf_counter()
        eng.run(stream)
        torch.cuda.synchronize()
        print(f"  resumed cycles 4-5 in {time.perf_counter() - t0:.2f} s "
              f"({smi})")
        check(eng.journal.deterministic_json()
              == base.journal.deterministic_json()
              and torch.equal(eng.analysis, base.analysis),
              "the child's cycles 0-3 and the resumed 4-5 are bitwise the "
              "uninterrupted run's journal and final analysis")

        eng, stream = elastic.resume_assim_engine(step4, p=r["elastic_p"])
        eng.run(stream)
        tail = eng.journal.records[4:]
        errs = [t.error_vs_direct for t in tail]
        check(eng.p == r["elastic_p"] and len(tail) == 2
              and all(len(t.loads) == r["elastic_p"] for t in tail)
              and all(e <= 1e-10 for e in errs),
              f"elastic resume at p={r['elastic_p']}: cycles 4-5 within "
              f"1e-10 of the direct solve (max {max(errs):.3e})")

        chaos.tear_checkpoint(step4, seed=0)
        check(not ckpt.verify(step4) and ckpt.latest_checkpoint(ck)
              == os.path.join(ck, "step_00000002"),
              "torn step 4 fails verify; latest_checkpoint falls back to "
              "step 2")

        pk = os.path.join(tmp, "pint")
        tp = TimeParEngine(EngineConfig(time_windows=2, **cfg_kw))
        t0 = time.perf_counter()
        tp.run(streams.ResumableStream("drifting_swarm", r["m"], 4, seed=0),
               checkpoint_dir=pk, snapshot_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = sorted(d for d in os.listdir(pk) if d.startswith("step_"))
        check(steps == ["step_00000002", "step_00000004"],
              f"Parareal window checkpoints {steps} ({wall:.2f} s)")
        eng, stream = elastic.resume_assim_engine(
            os.path.join(pk, "step_00000002"))
        eng.run(stream)
        diff = float((eng.analysis - tp.analysis).abs().max())
        check(all(a.loads == b.loads and a.repartitioned == b.repartitioned
                  for a, b in zip(eng.journal.records[2:],
                                  tp.journal.records[2:]))
              and len(eng.journal.records) == 4 and diff <= 1e-6,
              f"sequential resume from the window-1 checkpoint repeats the "
              f"tail's DyDD decisions; final analysis within {diff:.3e} "
              f"<= 1e-6 of the windowed run")


def phase_profile(cfg, scenario: str, m: int, cycles: int) -> None:
    """Where one cycle's time goes: ``torch.profiler`` over the engine's
    prepare and solve of cycle 0 — host wall times, the device's busy
    share of them, and the operations with the most device time."""
    from repro_torch.assim import AssimilationEngine, CycleStep, streams
    from torch.profiler import ProfilerActivity, profile

    print("== profile: one ex4_p8 cycle (prepare + solve)")
    eng = AssimilationEngine(cfg)
    obs = next(iter(streams.make_stream(scenario, m, cycles)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prep = eng.prepare(0, obs)
        t1 = time.perf_counter()
        eng.solve_step(CycleStep(cycle=0, obs=obs, prep=prep))
        t2 = time.perf_counter()

    wall_ms = (t2 - t0) * 1e3
    print(f"  prepare {(t1 - t0) * 1e3:.1f} ms, solve {(t2 - t1) * 1e3:.1f} "
          f"ms (host wall)")
    device_report(prof, wall_ms, 10)


def device_report(prof, wall_ms: float, top: int) -> float:
    """Print the device's busy time and share of ``wall_ms``, and the
    ``top`` device operations by time, from a ``torch.profiler`` run;
    returns the busy time in ms."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Device-side entries only (kernels, copies): the host ops that
    # launched them carry the same time again, and so do the device spans
    # of the MoE ranges (:func:`moe_ranges`).
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")
                     and e.key not in MOE_RANGES),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    print(f"  device busy {busy_ms:.1f} ms = {busy_ms / wall_ms:.3f} of "
          f"the {wall_ms:.1f} ms wall time, "
          f"{sum(e.count for e in events)} device operations")
    for e in events[:top]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms device  {e.count:6d} calls  "
              f"{e.key[:70]}")
    return busy_ms


def kernel_cases(packed, x_loc, dtype):
    """Inputs of the three kernels at one packing's shapes."""
    from repro_torch.kernels import ref

    A = packed.A_loc.to(dtype)
    p, m, _ = A.shape
    x = x_loc.to(dtype).contiguous()
    wdiv, muov, mask = (t.to(dtype) for t in
                        (packed.wdiv, packed.muov, packed.mask))
    r, b = packed.r.to(dtype), packed.b.to(dtype)
    y, u = ref.schwarz_fwd_plain(A, x, wdiv)
    Ax = y.sum(dim=0)
    return {
        "gram": (A, r.expand(p, m).contiguous()),
        "schwarz_fwd": (A, x, wdiv),
        "schwarz_bwd": (A, r, b, Ax, u.contiguous(), x, muov, mask),
    }


# Ragged shapes: m and w off every tile, w = 1, zero-padded columns; an
# odd w over four 128-column tiles with m off the 16-row slabs.
RAGGED = ((3, 1001, 77, 0), (2, 37, 1, 0), (2, 300, 130, 9), (1, 5, 300, 40),
          (2, 1003, 389, 0))


def random_case(p: int, m: int, w: int, pad: int, dtype, gen):
    """Random inputs of the three kernels at (p, m, w), with random
    positive r and the last ``pad`` columns zero."""
    def v(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           device="cuda").to(dtype)

    A = v(p, m, w)
    mask = torch.ones(p, w, dtype=dtype, device="cuda")
    if pad:
        A[:, :, w - pad:] = 0.0
        mask[:, w - pad:] = 0.0
    r = v(m).abs()
    return {
        "gram": (A, r.expand(p, m).contiguous()),
        "schwarz_fwd": (A, v(p, w), v(p, w).abs()),
        "schwarz_bwd": (A, r, v(m), v(m), v(p, m), v(p, w), v(p, w).abs(),
                        mask),
    }


def _plain(name):
    from repro_torch.kernels import ref
    return {"gram": ref.gram_plain, "schwarz_fwd": ref.schwarz_fwd_plain,
            "schwarz_bwd": ref.schwarz_bwd_plain}[name]


def _kernel(name):
    from repro_torch.kernels import gram, schwarz_step
    return {"gram": gram.gram, "schwarz_fwd": schwarz_step.schwarz_fwd,
            "schwarz_bwd": schwarz_step.schwarz_bwd}[name]


def _library(name, args):
    """One cuBLAS batched product computing the kernel's function (with
    the small elementwise parts of the function around it; gram's
    scaling by r, a pass over all of A, is made before the timing)."""
    if name == "gram":
        A, r = args
        Ar = A * r[..., None]
        return lambda: torch.bmm(A.mT, Ar)
    if name == "schwarz_fwd":
        A, x, wdiv = args
        return lambda: torch.bmm(A, torch.stack([x * wdiv, x], dim=2))
    A, r, b, Ax, u, x, muov, mask = args
    return lambda: torch.baddbmm(
        (muov * x)[:, None, :], (r[None] * ((b - Ax)[None] + u))[:, None, :],
        A)[:, 0] * mask


def _bound(name, args):
    """(bound_ms, bound_by) of gram or a Schwarz kernel on ``args``
    (``repro_torch.kernels.cost``: the larger of the bytes moved, each
    input read once and each output written once, over the HBM rate and
    the flops over the dtype's peak)."""
    from repro_torch.kernels import cost
    A = args[0]
    return getattr(cost, name)(A.shape, A.dtype).bound()


def compare(name, args, dtype, label):
    out_k = _kernel(name)(*args)
    out_p = _plain(name)(*args)
    torch.cuda.synchronize()
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    err = max(float((k - q).abs().max()) for k, q in zip(outs_k, outs_p))
    scale = max(float(q.abs().max()) for q in outs_p) or 1.0
    ok = all(k.shape == q.shape and bool(torch.isfinite(k).all())
             for k, q in zip(outs_k, outs_p))
    check(ok and err / scale <= REL_TOL[dtype],
          f"{name} {label} {str(dtype)[6:]}: max abs err {err:.3e}, "
          f"rel {err / scale:.3e} <= {REL_TOL[dtype]:g}")
    return err


# Rows too wide for the Schwarz kernels' usual launch: the forward reads
# xs through L1 (no room to stage it beside a row a stage), the backward
# cuts a row into segments of TILE_BYTES (schwarz_step.fwd_plan, bwd_plan).
SCHWARZ_WIDE = ((2, 33, 15000, 7), (1, 300, 2500, 0))
SCHWARZ = ("schwarz_fwd", "schwarz_bwd")
SCHWARZ_PTXAS = (r"(schwarz_(?:fwd|bwd_partial|bwd_finish)_kernel"
                 r"I[df](?:Lb[01])?)")
# Problems of the stack whose member is held to its standalone launch.
SCHWARZ_STACK = 4
L2_FLUSH_BYTES = 512 << 20   # read before a cold call: 10 x the L2
QUEUE_SLEEP_CYCLES = 20_000_000   # ≈ 10 ms of the card's clock


def _outs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def schwarz_block(name, args, rows: slice):
    """The Schwarz kernel's inputs of subdomains ``rows`` alone (contiguous
    copies; the backward's m-vectors r, b, Ax are every subdomain's)."""
    shared = (1, 2, 3) if name == "schwarz_bwd" else ()
    return tuple(a if k in shared else a[rows].contiguous()
                 for k, a in enumerate(args))


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element into a fresh
    buffer: 8 bytes (f64) or 4 (f32) past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def schwarz_bitwise(cases: dict, dtype, label: str) -> None:
    """A subdomain's bits independent of the batch, for both Schwarz
    kernels: two launches equal; blocks 0 and p - 1 launched alone equal
    their rows of the batched launch; the packing as member
    ``SCHWARZ_STACK // 2`` of a stack of ``SCHWARZ_STACK`` problems (every
    input a view of the stack, as ``ddkf._member`` gives the fleet; the
    other members zero) equals its standalone launch."""
    tag = f"{label} {str(dtype)[6:]}"
    for name in SCHWARZ:
        args = cases[name]
        p = args[0].shape[0]
        whole = _outs(_kernel(name)(*args))
        again = _outs(_kernel(name)(*args))
        check(all(torch.equal(a, b) for a, b in zip(whole, again)),
              f"{name} {tag}: two launches bitwise equal")
        for blk in sorted({0, p - 1}):
            alone = _outs(_kernel(name)(*schwarz_block(
                name, args, slice(blk, blk + 1))))
            check(all(torch.equal(a[0], b[blk])
                      for a, b in zip(alone, whole)),
                  f"{name} {tag}: block {blk} of {p} alone bitwise its row "
                  f"of the batched launch")
        member = SCHWARZ_STACK // 2
        views = []
        for a in args:
            stack = torch.zeros((SCHWARZ_STACK,) + tuple(a.shape),
                                dtype=a.dtype, device=a.device)
            stack[member] = a
            views.append(stack[member])
        got = _outs(_kernel(name)(*views))
        check(all(torch.equal(a, b) for a, b in zip(got, whole)),
              f"{name} {tag}: member {member} of a {SCHWARZ_STACK}-problem "
              f"stack bitwise its standalone launch")
        del whole, again, views, got
        torch.cuda.empty_cache()


def schwarz_offset(name, args, dtype, label: str) -> None:
    """The kernel on views one element past a 16-byte boundary: within
    REL_TOL of the plain version and bitwise its launch on aligned
    copies."""
    views = tuple(offset_view(a) for a in args)
    assert all(v.data_ptr() % 16 for v in views)
    compare(name, views, dtype, f"{label} at a {views[0].element_size()}-"
            f"byte offset")
    got = _outs(_kernel(name)(*views))
    want = _outs(_kernel(name)(*args))
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{name} {label} {str(dtype)[6:]}: the offset views bitwise the "
          f"aligned launch")


def queued_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls that the
    host queued while the card slept (``torch.cuda._sleep``): the launches
    run one after another with no wait for the host between them, so a
    call whose host time exceeds its device time (the wrappers' checks,
    allocations and launches at p = 1) is timed by its device time."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def cold_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` with the L2 cache refilled before each
    call by a read of ``L2_FLUSH_BYTES`` (a read, so that no dirty line is
    written back during the call; CUDA events around the call alone)."""
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=DEVICE)
    fn()
    pairs = []
    for _ in range(reps):
        flush.sum()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        pairs.append((t0, t1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def schwarz_times(cases: dict, rows: dict, label: str, reps: int) -> None:
    """Adds to each Schwarz row its device time a call with the calls
    queued ahead (``device_ms``, :func:`queued_ms`: the back-to-back
    ``ms`` also holds the host's time between calls where that is the
    longer, as at p = 1), its cold time (``cold_ms``: the L2 refilled
    with other data before each call) and the forward-backward pair
    alternating on one A, as the solve launches them (``pair_ms`` back to
    back, ``pair_device_ms`` queued).  A is 75.7 MB a subdomain against
    50 MB of L2, so a time under the byte bound would read A partly from
    L2."""
    fwd, bwd = (_kernel(n) for n in SCHWARZ)

    def pair():
        fwd(*cases["schwarz_fwd"])
        bwd(*cases["schwarz_bwd"])

    pair_ms, pair_dev = time_ms(pair, reps), queued_ms(pair, reps)
    for name in SCHWARZ:
        row = rows[name]
        row["device_ms"] = queued_ms(lambda: _kernel(name)(*cases[name]),
                                     reps)
        row["cold_ms"] = cold_ms(lambda: _kernel(name)(*cases[name]), reps)
        row["pair_ms"], row["pair_device_ms"] = pair_ms, pair_dev
        plan = schwarz_plan(name, cases[name][0])
        dev, cold = row["device_ms"], row["cold_ms"]
        print(f"  {row['name']} {label}: back to back {row['ms']:.4f} ms "
              f"({row['bound_ms'] / row['ms']:.3f} of the bound), queued "
              f"{dev:.4f} ms ({row['bound_ms'] / dev:.3f}), cold "
              f"{cold:.4f} ms ({row['bound_ms'] / cold:.3f}); the pair fwd "
              f"+ bwd {pair_ms:.4f} ms, queued {pair_dev:.4f}, against 2 "
              f"bounds {2 * row['bound_ms']:.4f}; grid {plan['grid']}, "
              f"{plan['smem_bytes']} B dynamic shared memory")


def schwarz_plan(name, A) -> dict:
    from repro_torch.kernels import schwarz_step
    plan = (schwarz_step.fwd_plan if name == "schwarz_fwd"
            else schwarz_step.bwd_plan)
    return plan(tuple(A.shape), A.dtype)


def phase_kernels(main_cases, counts):
    """Kernel vs plain at the main path's shapes (f64, f32): the engine's
    first packing, and random values with random positive r at the same
    (p, m, w); then at ragged shapes.  The timings of the first (main)
    packing go into the JSON line; its max_abs_err is the larger f64 one
    of the two main-shape cases."""
    print("== kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    for line in ptxas_report(SCHWARZ_PTXAS):
        print(f"  ptxas {line}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for label, (packed, x_loc) in main_cases:
        real = int(packed.mask.sum())
        print(f"  {label} first packing: w = {packed.w}, {real} real "
              f"column slots of p*w = {packed.p * packed.w} "
              f"({real / (packed.p * packed.w):.3f} of A_loc is not "
              f"padding)")
        shape = tuple(packed.A_loc.shape)
        timed = not rows
        for dtype in (torch.float64, torch.float32):
            for name, args in random_case(*shape, 0, dtype, gen).items():
                err = compare(name, args, dtype, f"{label} random {shape}")
                if timed and dtype == torch.float64:
                    rows[name] = {"max_abs_err": err}
            cases = kernel_cases(packed, x_loc, dtype)
            if timed:
                schwarz_bitwise(cases, dtype, f"{label} {shape}")
            for name, args in cases.items():
                err = compare(name, args, dtype, f"{label} {shape}")
                if not timed or dtype != torch.float64:
                    continue
                if name == "gram":
                    n1, n2 = _kernel(name)(*args), _kernel(name)(*args)
                    check(torch.equal(n1, n2),
                          f"gram {label}: two launches bitwise equal")
                    del n1, n2
                reps = 5 if name == "gram" else 20
                bound, by = _bound(name, args)
                rows[name] = {
                    "name": name, "ok": True, "route": "cuda",
                    "source": SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": counts[name],
                    "max_abs_err": max(err, rows[name]["max_abs_err"]),
                    "ms": time_ms(lambda: _kernel(name)(*args), reps),
                    "plain_ms": time_ms(lambda: _plain(name)(*args), reps),
                    "bound_ms": bound, "bound_by": by,
                    "library_ms": time_ms(_library(name, args), reps),
                    "shape": list(args[0].shape), "dtype": "float64",
                }
                print(f"  {name} {label}: kernel {rows[name]['ms']:.4f} ms, "
                      f"plain {rows[name]['plain_ms']:.4f} ms, library "
                      f"{rows[name]['library_ms']:.4f} ms, bound "
                      f"{bound:.4f} ms ({by})")
            if timed and dtype == torch.float64:
                schwarz_times(cases, rows, f"{label} {shape}", 20)
    for dtype in (torch.float64, torch.float32):
        for p, m, w, pad in RAGGED:
            for name, args in random_case(p, m, w, pad, dtype, gen).items():
                compare(name, args, dtype, f"ragged {(p, m, w)}")
                if name in SCHWARZ:
                    schwarz_offset(name, args, dtype, f"ragged {(p, m, w)}")
        for p, m, w, pad in SCHWARZ_WIDE:
            case = random_case(p, m, w, pad, dtype, gen)
            for name in SCHWARZ:
                compare(name, case[name], dtype, f"wide {(p, m, w)}")
                schwarz_offset(name, case[name], dtype, f"wide {(p, m, w)}")
    return [rows[k] for k in ("gram", "schwarz_fwd", "schwarz_bwd")]


# ---------------------------------------------------------------------------
# LM serving: RecurrentGemma-9B and Mamba-2 1.3B.
# ---------------------------------------------------------------------------

PROMPT_LENS = (4096, 3072, 2500, 1800)
MAX_NEW = 32
# Each served model: the kernel launches of its prefill at full width and
# on the smoke config, the prefill block whose output after the last layer
# is the trunk's output before the final norm, the kernel op whose last
# launch run (e) faults, and the limits of (c): the last-position logits'
# max abs difference over max abs, and the trunk's output less the
# embedding, Frobenius over Frobenius and at the worst position.
LM_PATHS = {
    "recurrentgemma-9b": {
        "launches": {"flash_attention": 12, "rglru_scan": 26},
        "smoke_launches": {"flash_attention": 1, "rglru_scan": 4},
        "block": "_rglru_prefill_block", "fault": "flash_attention",
        "gates": {"logits": 2e-2, "frob": 2e-2, "rows": TRUNK_ROW_TOL}},
    "mamba2-1.3b": {
        "launches": {"ssd_scan": 48}, "smoke_launches": {"ssd_scan": 3},
        "block": "_ssd_prefill_block", "fault": "ssd_scan",
        "gate_dtype": torch.float32,
        "gates": {"logits": 1e-4, "frob": 2e-3, "rows": 2e-2}},
    # Yi-6B's worst position reads 1.06e-2 kernel vs plain and 0.189 under
    # run (e), which RecurrentGemma's 0.2 would not catch: 5e-2.
    "yi-6b": {
        "launches": {"flash_attention": 32},
        "smoke_launches": {"flash_attention": 2},
        "block": "_attn_prefill_block", "fault": "flash_attention",
        "gates": {"logits": 2e-2, "frob": 2e-2, "rows": 5e-2}},
    # ``moe``: each plain run records every layer's routing and the runs
    # held to it replay it (:func:`moe_routes`).  With each route's own
    # routing, 31 % of OLMoE's (token, expert) assignments differ and the
    # logits by 0.79; with (c)'s routing fed, the bf16 logits still
    # differ by 6.0e-2: its 16 random bf16 layers amplify rounding, as
    # Mamba-2's do, and the plain route against itself with every
    # attention output moved by up to one bf16 ulp (``control_scale``)
    # reads 5.2e-2, so no bf16 kernel short of the plain version's own
    # rounding holds 2e-2 end to end.  (c) and (e) compare an f32 copy at
    # Mamba-2's f32 limits; bf16 is held end to end within CONTROL_K of
    # that control, on the weights of seed 0 and of each
    # ``control_seeds``, and call by call on its own path (``call_gates``:
    # :func:`bf16_call_gate`).
    "olmoe-1b-7b": {
        "launches": {"flash_attention": 16},
        "smoke_launches": {"flash_attention": 2},
        "block": "_attn_prefill_block", "fault": "flash_attention",
        "moe": True, "gate_dtype": torch.float32, "control_scale": 2.0 ** -8,
        "control_seeds": (1,),
        "call_gates": {"frob": 2.0 ** -8, "bias": 2.0 ** -10},
        "gates": {"logits": 1e-4, "frob": 2e-3, "rows": 2e-2}},
    # whisper-large-v3: 32 encoder layers (non-causal self-attention over
    # the 1500 frames) and 32 decoder layers (causal self-attention and a
    # cross-attention to the frames): 96 launches a prefill.  Its prompts
    # fill the decoder's context of 448 with the 32 new tokens; the frames
    # (B, 1500, 1280) are drawn from the run's seed (draw_extras).
    "whisper-large-v3": {
        "launches": {"flash_attention": 96},
        "smoke_launches": {"flash_attention": 6},
        "prompts": (416, 352, 288, 200),
        "block": "_cross_prefill_block", "fault": "flash_attention",
        "call_gates": {"frob": 2.0 ** -8, "bias": 2.0 ** -10},
        "gates": {"logits": 2e-2, "frob": 2e-2, "rows": 5e-2}},
    # phi-3-vision-4.2b: 144 patch embeddings before each prompt, so that
    # the longest runs 4096 positions, as the other models' traffic.
    "phi3-vision-4.2b": {
        "launches": {"flash_attention": 32},
        "smoke_launches": {"flash_attention": 2},
        "prompts": tuple(n - 144 for n in PROMPT_LENS),
        "block": "_attn_prefill_block", "fault": "flash_attention",
        "call_gates": {"frob": 2.0 ** -8, "bias": 2.0 ** -10},
        "gates": {"logits": 2e-2, "frob": 2e-2, "rows": 5e-2}},
}
# The encoder-decoder and the vision stub, served and trained after the
# uniform stack.
MODALITY_ARCHS = ("whisper-large-v3", "phi3-vision-4.2b")
# The scale of the frames and patches drawn for them, as the reference's
# tests draw them.
EXTRAS_SCALE = 0.02
# The uniform attention stack's smoke configs (f32) that phase_lm_small and
# the CLIs run on the card: every layer one flash_attention launch a
# prefill (gemma3-1b's smoke config at head dimension 12, zero-padded to
# 16 by the wrapper).
UNIFORM_ARCHS = ("yi-6b", "gemma-7b", "glm4-9b", "gemma3-1b", "olmoe-1b-7b",
                 "mixtral-8x22b")
# Mamba-2's runs (c) and (e) compare an f32 copy of the weights: with
# random weights its 48 bf16 layers amplify rounding flips, so that the
# plain route against itself with every SSD output scaled by 1 + 1e-6
# (below bf16's resolution) moves the trunk by 0.30 (Frobenius) and the
# logits by 6.4e-2.  In f32 the kernel and plain routes differ by 2.3e-6
# in the logits, 2.4e-4 (Frobenius) and 2.4e-3 (worst position) in the
# trunk, and run (e) reaches 1.3e-2 and 0.26 in the trunk; the f32 limits
# lie between, with room on both sides (NVIDIA H100 80GB HBM3, 700.00 W).
# In bf16 the kernel route is held to that control instead
# (:func:`bf16_control_gate`); (d) holds every bf16 layer.
CONTROL_K = 2
# Run (f) of :func:`bf16_call_gate`: the relative bias planted in every
# output of the path's bf16 kernel.
BF16_CALL_FAULT = 2.0 ** -7


@contextlib.contextmanager
def wrapped(module, name: str, wrap):
    """Replace ``module.name`` by ``wrap(module.name)`` for the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def keep_prefill(store: list):
    """Wrap ``steps.make_prefill_step`` so each prefill's batch and
    last-position logits are kept in ``store``."""
    def wrap(make):
        def make_and_keep(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(params, batch):
                out = step(params, batch)
                store.append((batch, out[0]))
                return out
            return run
        return make_and_keep
    return wrap


def uncapped_kwargs(kwargs: dict) -> dict:
    """A kept call's keyword arguments without a zero ``softcap`` (the
    attention of a config with no cap passes 0.0), so that the SDPA and
    FA2 yardsticks, which compute uncapped attention, take them as they
    are; a capped call keeps its cap."""
    return {k: v for k, v in kwargs.items()
            if not (k == "softcap" and not v)}


def keep_first_call(store: dict, name: str):
    """Wrap a kernel op so its first call's arguments land in ``store``,
    detached: a kept argument with its autograd graph would keep the
    graph's tensors (the step's whole params among them) alive for the
    rest of the run, and every later step's peak memory would count
    them."""
    def wrap(fn):
        def run(*args, **kwargs):
            if name not in store:
                store[name] = (tuple(a.detach() if torch.is_tensor(a)
                                     else a for a in args),
                               uncapped_kwargs(kwargs))
            return fn(*args, **kwargs)
        return run
    return wrap


def attention_kind(q, k, causal: bool) -> str:
    """A flash_attention call's kind: "cross" (k and v of another length
    than q), "causal" or "noncausal" self-attention."""
    if k.shape[1] != q.shape[1]:
        return "cross"
    return "causal" if causal else "noncausal"


def keep_attention_kinds(store: dict, tally: dict, name: str):
    """Wrap ``ops.flash_attention`` (or another function of q, k, v, ...)
    so the first call of each kind (:func:`attention_kind`) lands in
    ``store`` under ``name:kind`` and ``tally`` counts the calls of each
    kind."""
    def wrap(fn):
        def run(q, k, v, *args, **kwargs):
            kind = attention_kind(q, k, kwargs.get("causal", True))
            store.setdefault(f"{name}:{kind}", (
                tuple(t.detach() for t in (q, k, v)),
                uncapped_kwargs(kwargs)))
            tally[kind] = tally.get(kind, 0) + 1
            return fn(q, k, v, *args, **kwargs)
        return run
    return wrap


def agreement(name, out, plain):
    """(max abs err, ratio) of a kernel's output against its plain
    version's; the kernel agrees when ratio <= 1.  ``ssd_scan`` (y and
    the final state): the worst |kernel - plain| / (SSD_ATOL + SSD_RTOL
    |plain|); the others: max abs err / max abs of the plain output, over
    the dtype's LM_TOL."""
    if name == "ssd_scan":
        diffs = [((k - p).abs(), SSD_ATOL + SSD_RTOL * p.abs())
                 for k, p in zip(out, plain)]
        return (max(float(d.max()) for d, _ in diffs),
                max(float((d / a).max()) for d, a in diffs))
    err = float((out.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max()) or 1.0
    return err, err / scale / LM_TOL[plain.dtype]


def call_stats(out, plain):
    """(Frobenius ratio, scale bias) of a call's output against its plain
    version's, in f64: ||out - plain|| / ||plain|| and <out - plain,
    plain> / <plain, plain>.  bf16 rounding of two f32 computations moves
    a share of the elements by an ulp either way and reads near 0 in the
    bias; a kernel off by a relative c everywhere reads c in both."""
    o, p = out.double(), plain.double()
    pp = float((p * p).sum()) or 1.0
    return (float((o - p).norm()) / pp ** 0.5,
            float(((o - p) * p).sum()) / pp)


def compare_calls(errs: dict, name: str, stats: dict | None = None):
    """Wrap a kernel op so every call's output is also held against the
    op's plain version on the same inputs; ``errs[name]`` gets each
    call's :func:`agreement` and ``stats[name]``, where given, its
    :func:`call_stats`."""
    def wrap(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            kw = {k: v for k, v in kwargs.items() if k != "mode"}
            plain = lm_plain(name)(*args, **kw)
            errs.setdefault(name, []).append(agreement(name, out, plain))
            if stats is not None:
                stats.setdefault(name, []).append(call_stats(out, plain))
            return out
        return run
    return wrap


def scale_output(scale: float):
    """Wrap a kernel op so its output (the first of a tuple) comes out
    multiplied by ``scale``, in the output's dtype."""
    def wrap(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            if isinstance(out, tuple):
                return (out[0] * scale, *out[1:])
            return out * scale
        return run
    return wrap


def jitter_output(rel: float, seed: int = 0):
    """Wrap a kernel op so its output comes out multiplied element by
    element by 1 + rel u, u uniform on [-1, 1] drawn from a generator
    seeded with ``seed`` (a fresh draw each call), in the output's dtype;
    the gradient the call passes back is multiplied by the same."""
    gen = None

    def wrap(fn):
        def run(*args, **kwargs):
            nonlocal gen
            out = fn(*args, **kwargs)
            if gen is None:
                gen = torch.Generator(device=out.device).manual_seed(seed)
            u = torch.rand(out.shape, generator=gen, device=out.device)
            return (out.float() * (1 + rel * (2 * u - 1))).to(out.dtype)
        return run
    return wrap


def keep_trunk_output(store: dict):
    """Wrap a prefill block function so the residual stream it returns
    lands in ``store["h"]``: after the prefill, the last block's, which is
    the trunk's output before the final norm."""
    def wrap(block):
        def run(*args, **kwargs):
            h, cache = block(*args, **kwargs)
            store["h"] = h
            return h, cache
        return run
    return wrap


def serve_run(cfg, params, prompts, path, kept_inputs=None, extras=None):
    """One ``serve_batch`` of the prompts, greedy, on the batch's frames
    or patches ``extras`` (zeros by default); returns the prefill's
    (batch, logits), the generated tokens, the stats and the launch
    counts of this run alone.  ``kept_inputs`` (a dict) receives the
    arguments of the first call of each of the path's kernel ops and of
    each kind of attention call, the calls of each kind (under
    ``"attention_kinds"``) and the prefill's trunk output
    (:func:`keep_first_call`, :func:`keep_attention_kinds`,
    :func:`keep_trunk_output`)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.runtime import steps

    reqs = [serve.Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    kept = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(steps, "make_prefill_step",
                                    keep_prefill(kept)))
        if kept_inputs is not None:
            for name in path["launches"]:
                stack.enter_context(wrapped(
                    ops, name, keep_first_call(kept_inputs, name)))
            if "flash_attention" in path["launches"]:
                stack.enter_context(wrapped(
                    ops, "flash_attention", keep_attention_kinds(
                        kept_inputs, kept_inputs.setdefault(
                            "attention_kinds", {}), "flash_attention")))
            stack.enter_context(wrapped(transformer, path["block"],
                                        keep_trunk_output(kept_inputs)))
        ops.reset_counts()
        reqs, stats = serve.serve_batch(cfg, params, reqs,
                                        max_seq=max(map(len, prompts))
                                        + MAX_NEW, extras=extras)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    return kept[0], [r.out for r in reqs], stats, counts


# The kernels rows of each kind of attention call in the prefills of the
# encoder-decoder and the vision stub: (kind, row name, label).
MODALITY_ROWS = {
    "whisper-large-v3": (
        ("noncausal", "flash_attention_whisper_encoder_prefill",
         "encoder self-attention"),
        ("causal", "flash_attention_whisper_self_prefill",
         "decoder self-attention"),
        ("cross", "flash_attention_whisper_cross_prefill",
         "cross-attention")),
    "phi3-vision-4.2b": (
        ("causal", "flash_attention_phi3_prefill", "self-attention"),),
}


def phase_modality_serve(arch: str) -> list:
    """``arch`` served at full size (:func:`phase_lm_serve`) and profiled,
    then a ``kernels`` row (:func:`attention_shape_row`) for each kind of
    its prefill's attention calls (MODALITY_ROWS), at the first call of
    that kind in run (a), with that kind's launches a prefill."""
    counts, params, cfg, batch, inputs, layer_errs = phase_lm_serve(arch)
    phase_lm_profile(cfg, params, batch)
    del params, batch
    torch.cuda.empty_cache()
    tally = inputs.pop("attention_kinds")
    check(sum(tally.values()) == counts["flash_attention"],
          f"{arch} prefill: attention calls by kind {tally} add up to its "
          f"{counts['flash_attention']} flash_attention launches")
    rows = []
    for kind, name, what in MODALITY_ROWS[arch]:
        args, kwargs = inputs[f"flash_attention:{kind}"]
        kwargs = {k: v for k, v in kwargs.items() if k != "mode"}
        rows.append(attention_shape_row(
            name, f"{arch} prefill {what}", args, kwargs, tally[kind],
            cfg.num_heads, layer_errs["flash_attention"]))
    del inputs
    torch.cuda.empty_cache()
    return rows


def phase_lm_small(arch: str) -> None:
    """The smoke config (f32, prompts longer than the RecurrentGemma
    window and than five Mamba-2 chunks) served on the card through the
    kernels and on the CPU through the plain versions, with the same
    weights: the CPU path is the one the tests hold to the JAX package
    at 1e-4."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.runtime import steps

    print(f"== lm_serve: {arch} smoke config, card vs CPU")
    path = smoke_path(arch)
    cfg = configs.get_smoke_config(arch)
    cpu = transformer.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 29, 17)]
    moe = {"moe": bool(cfg.num_experts)}
    routes_card, routes_cpu = [], []
    with moe_routes(moe, routes_card, record=True):
        (_, logits_card), toks_card, _, counts = serve_run(
            cfg, _to_device(cpu, DEVICE), prompts, path)
    kept = []
    with wrapped(steps, "make_prefill_step", keep_prefill(kept)), \
            moe_routes(moe, routes_cpu, record=True):
        reqs, _ = serve.serve_batch(
            cfg, cpu, [serve.Request(rid=i, prompt=p, max_new=MAX_NEW)
                       for i, p in enumerate(prompts)],
            max_seq=max(map(len, prompts)) + MAX_NEW)
    if moe["moe"]:
        # Left padding gives rows of one token whose hidden states differ
        # in the last bits, so which of them a chunk edge migrates or
        # drops follows the rounding: the card's run is held to the CPU's
        # with the CPU's routing fed to it.
        differ = sum(int((ea.cpu() != ec).any(-1).sum())
                     for (ea, _), (ec, _) in zip(routes_card, routes_cpu))
        orders = sum(int((oa.cpu() != oc).any(-1).sum())
                     for (_, oa), (_, oc) in zip(routes_card, routes_cpu))
        diff = float((logits_card.cpu() - kept[0][1]).abs().max())
        print(f"  card with its own routing: {differ} tokens' experts and "
              f"{orders} rows' orders differ from the CPU's over "
              f"{len(routes_cpu)} MoE calls; prefill logits max abs diff "
              f"{diff:.3e}")
        with moe_routes(moe, routes_cpu):
            (_, logits_card), toks_card, _, counts = serve_run(
                cfg, _to_device(cpu, DEVICE), prompts, path)
    diff = float((logits_card.cpu() - kept[0][1]).abs().max())
    fed = ", the CPU's routing fed to the card" if moe["moe"] else ""
    check(diff <= 1e-4, f"smoke prefill logits, card kernels vs CPU plain"
          f"{fed}: max abs diff {diff:.3e} <= 1e-4")
    check(toks_card == [r.out for r in reqs],
          f"smoke greedy tokens equal on the card and the CPU "
          f"({len(prompts)} x {MAX_NEW})")
    want = path["smoke_launches"]
    check(all(v == want.get(k, 0) for k, v in counts.items()),
          f"smoke prefill ran {want} launches, decode none: {counts}")


def smoke_path(arch: str) -> dict:
    """``LM_PATHS[arch]``, or for a smoke-only uniform arch its launches:
    one flash_attention a layer."""
    from repro_torch import configs
    if arch in LM_PATHS:
        return LM_PATHS[arch]
    layers = configs.get_smoke_config(arch).num_layers
    return {"launches": {"flash_attention": layers},
            "smoke_launches": {"flash_attention": layers}}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def served_positions(batch) -> int:
    """The positions a served batch's prefill runs: its tokens after any
    prepended patches."""
    patches = batch.get("patches")
    return batch["tokens"].shape[1] + (0 if patches is None
                                       else patches.shape[1])


def prefill_trunk(cfg, params, batch, block: str, mode="auto"):
    """One prefill of ``batch`` with caches for MAX_NEW more positions:
    its last-position logits and the trunk's output before the final norm
    (the last ``block``'s)."""
    from repro_torch.models import transformer
    from repro_torch.runtime import steps

    kept: dict = {}
    with wrapped(transformer, block, keep_trunk_output(kept)):
        logits, _ = steps.make_prefill_step(
            cfg, max_seq=served_positions(batch) + MAX_NEW, mode=mode)(
                params, batch)
    torch.cuda.synchronize()
    return logits, kept["h"]


def trunk_diff(label, t, ref):
    """Print and return (Frobenius ratio, worst position's norm ratio) of
    ``t - ref``; ``t`` and ``ref`` are trunk outputs less the embedding,
    (B, S, D)."""
    diff = t - ref
    frob = float(diff.norm() / ref.norm())
    rows = float((diff.norm(dim=-1) / ref.norm(dim=-1)).max())
    print(f"  {label}: trunk less the embedding, max abs diff / max abs "
          f"{float(diff.abs().max() / ref.abs().max()):.3e} (max abs "
          f"{float(ref.abs().max()):.4g}), worst position's norm ratio "
          f"{rows:.3e}, Frobenius ratio {frob:.3e}")
    return frob, rows


def phase_lm_serve(arch: str):
    """``arch`` at full width in bf16: runs (a) to (e).  Returns (a)'s
    launch counts, the weights, the config, the prefill batch, the first
    inputs of each kernel op in (a) and the largest max abs error of each
    op over every layer of (d).

    With random weights the embedding dominates the residual stream and
    so the logits, so (c) is also held to (a) in the trunk's own
    contribution: the final residual stream less the embedding.  bf16
    rounding differences grow through the random layers, so that gate is
    on norms (all positions, and the worst one), and (e) shows that it
    trips on a fault in the last layer.  Where the path names a
    ``gate_dtype``, (c) and (e) compare a kernel-route prefill of the
    weights cast to it instead of (a).  The tight check of the kernels
    is (d), a kernel-route prefill whose every kernel call is held
    against the plain version on that call's inputs; where the path
    names ``call_gates``, also in Frobenius and bias, and run (f) plants
    a bias that must trip them (:func:`bf16_call_gate`)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    path = LM_PATHS[arch]
    cfg = configs.get_config(arch)
    lens = path.get("prompts", PROMPT_LENS)
    print(f"== lm_serve: {arch} full width ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, bf16), prompts {lens} left-padded"
          f" to {max(lens)}, {MAX_NEW} greedy tokens each"
          + "".join(f", {k} {tuple(v.shape)} drawn at scale {EXTRAS_SCALE}"
                    for k, v in draw_extras(cfg, len(lens), 0,
                                            meta=True).items()))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, 0, device=DEVICE)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in _leaves(params))
    print(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s:"
          f" {n / 1e9:.3f} B parameters ({n * 2 / 1e9:.2f} GB bf16; "
          f"param_count() {cfg.param_count() / 1e9:.3f} B)")
    prompts = draw_prompts(cfg, 0, lens)
    extras = draw_extras(cfg, len(prompts), 0)

    runs = {}
    inputs: dict = {}
    want = path["launches"]
    for tag in ("a", "b"):
        (batch, logits), toks, stats, counts = serve_run(
            cfg, params, prompts, path, inputs if tag == "a" else None,
            extras)
        runs[tag] = (logits, toks, counts)
        print(f"  ({tag}) prefill {stats['prefill_s']:.4f} s, decode "
              f"{stats['decode_s'] / MAX_NEW * 1e3:.3f} ms/step, "
              f"{stats['tokens_per_s']:.1f} tokens/s; launches {counts}")
        check(tuple(logits.shape) == (len(prompts), cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"({tag}) prefill logits finite, shape {tuple(logits.shape)}")
        check(all(len(t) == MAX_NEW and all(0 <= x < cfg.vocab_size
                                            for x in t) for t in toks),
              f"({tag}) {MAX_NEW} tokens in the vocabulary per request")
        check(all(v == want.get(k, 0) for k, v in counts.items()),
              f"({tag}) the prefill ran {want} launches, decode and the "
              f"other kernels none")
    la, ta, ca = runs["a"]
    lb, tb, _ = runs["b"]
    check(torch.equal(la, lb) and ta == tb,
          "(a) and (b) prefill logits and generated tokens bitwise equal")
    print(f"  max memory allocated, weights and runs (a), (b): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    fault = path["fault"]
    ha = inputs.pop("h")
    gate_dtype = path.get("gate_dtype")
    gp = params
    if gate_dtype is not None:
        bf16_control_gate(cfg, params, batch, path, la, ha)
        for seed in path.get("control_seeds", ()):
            bf16_control_seed(cfg, path, seed)
        gp = _cast(params, gate_dtype)
        ops.reset_counts()
        la, ha = prefill_trunk(cfg, gp, batch, path["block"])
        check(ops.launch_counts() == ca, f"(a, {str(gate_dtype)[6:]}) the "
              f"prefill of the weights in {str(gate_dtype)[6:]} ran the "
              f"same launches")
    tag = "" if gate_dtype is None else f", {str(gate_dtype)[6:]}"
    gates = path["gates"]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    routes_c: list = []
    with moe_routes(path, routes_c, record=True):
        lc, hc = prefill_trunk(cfg, gp, batch, path["block"], mode="plain")
    cc = ops.launch_counts()
    check(all(v == 0 for v in cc.values()), f"(c{tag}) ran no kernel: {cc}")
    print(f"  max memory allocated, weights and run (c{tag}): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if path.get("moe"):
        la, ha = moe_route_gate(cfg, gp, batch, path, la, ha, lc, hc,
                                routes_c)
    rel = float((la.float() - lc.float()).abs().max()
                / lc.float().abs().max())
    agree = float((la.argmax(-1) == lc.argmax(-1)).float().mean())
    print(f"  (c{tag}) plain prefill: last-position logits max abs diff / "
          f"max abs {rel:.3e}; first tokens agree for {agree:.2f} of the "
          f"requests")
    check(rel <= gates["logits"], f"(a{tag}) vs (c{tag}) relative logits "
          f"difference {rel:.3e} <= {gates['logits']:g}")
    emb = transformer.trunk_input(cfg, gp, batch).float()
    tc = hc.float() - emb
    frob, rows = trunk_diff(f"(a{tag}) vs (c{tag})", ha.float() - emb, tc)
    check(frob <= gates["frob"], f"(a{tag}) vs (c{tag}) trunk difference, "
          f"Frobenius over Frobenius, {frob:.3e} <= {gates['frob']:g}")
    check(rows <= gates["rows"], f"(a{tag}) vs (c{tag}) trunk difference at "
          f"the worst position, norm over norm, {rows:.3e} <= "
          f"{gates['rows']:g}")

    # (e) The trunk gate catches a fault in one deep layer that the
    # logits gate misses: the last launch of the fault kernel loses the
    # last 64 rows (positions) of its output.
    def zero_tail(fn):
        calls = []

        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append(1)
            if len(calls) == ca[fault]:
                y = (out[0] if isinstance(out, tuple) else out).clone()
                y[:, -64:] = 0
                out = (y, *out[1:]) if isinstance(out, tuple) else y
            return out
        return run

    with wrapped(ops, fault, zero_tail), moe_routes(path, routes_c):
        le, he = prefill_trunk(cfg, gp, batch, path["block"])
    rel_e = float((le.float() - lc.float()).abs().max()
                  / lc.float().abs().max())
    _, rows_e = trunk_diff(f"(e{tag}) faulted vs (c{tag})", he.float() - emb,
                           tc)
    check(rows_e > gates["rows"], f"(e{tag}) a fault in the last {fault} "
          f"layer trips the trunk gate ({rows_e:.3e} > {gates['rows']:g}; "
          f"logits rel {rel_e:.3e})")
    del emb, tc, hc, he, ha, gp

    errs: dict = {}
    stats = {} if "call_gates" in path else None
    with contextlib.ExitStack() as stack:
        for name in want:
            stack.enter_context(wrapped(ops, name,
                                        compare_calls(errs, name, stats)))
        prefill_trunk(cfg, params, batch, path["block"])
    worst = {}
    for name, calls in errs.items():
        worst[name] = max(e for e, _ in calls)
        ratio = max(r for _, r in calls)
        check(ratio <= 1, f"(d) {name} against its plain version on the "
              f"inputs of each of its {len(calls)} layers: max abs err "
              f"{worst[name]:.3e}, worst error over its allowance "
              f"{ratio:.3e} <= 1")
    if stats is not None:
        bf16_call_gate(cfg, params, batch, path, stats[fault])
    return ca, params, cfg, batch, inputs, worst


def draw_prompts(cfg, seed: int, lens=PROMPT_LENS) -> list:
    """The served traffic: one prompt of each of ``lens`` tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, k).astype(np.int32)
            for k in lens]


def draw_extras(cfg, batch: int, seed: int, meta: bool = False) -> dict:
    """A batch's inputs besides its tokens, drawn on the card from a
    generator seeded with ``seed`` at scale EXTRAS_SCALE in the config's
    dtype: whisper's frames (B, encoder_seq, d_model), phi-3-vision's
    patches (B, num_patches, d_model); none for a text-only model.  With
    ``meta``, empty tensors of those shapes (for printing)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    like = serve.modality_inputs(cfg, batch, "meta")
    if meta:
        return like
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dtype = transformer.DTYPES[cfg.dtype]
    return {k: (EXTRAS_SCALE * torch.randn(v.shape, generator=gen,
                                           device=DEVICE)).to(dtype)
            for k, v in like.items()}


def bf16_control_seed(cfg, path, seed: int) -> None:
    """:func:`bf16_control_gate` again on weights and prompts drawn from
    ``seed``: the kernel route (a) prefilled on them, then held to the
    plain route and to the control as run (a) is."""
    from repro_torch.models import transformer

    params = transformer.init_params(cfg, seed, device=DEVICE)
    prompts = draw_prompts(cfg, seed, path.get("prompts", PROMPT_LENS))
    toks = np.zeros((len(prompts), max(map(len, prompts))), np.int64)
    for i, p in enumerate(prompts):            # left-padded, as served
        toks[i, toks.shape[1] - len(p):] = p
    batch = {"tokens": torch.as_tensor(toks, device=DEVICE),
             **draw_extras(cfg, len(prompts), seed)}
    print(f"  weights and prompts of seed {seed}:")
    la, ha = prefill_trunk(cfg, params, batch, path["block"])
    bf16_control_gate(cfg, params, batch, path, la, ha,
                      tag=f", seed {seed}")
    del params, la, ha
    torch.cuda.empty_cache()


def bf16_call_gate(cfg, params, batch, path, stats) -> None:
    """The bf16 kernel held call by call on the path's own inputs: every
    call of (d) (``stats``: each call's :func:`call_stats` against the
    plain version on that call's inputs) within the path's
    ``call_gates``, a Frobenius ratio of about one bf16 ulp and a bias of
    a quarter of one.  Run (f) repeats (d) with every kernel output
    scaled by 1 + BF16_CALL_FAULT, a bias of one to two bf16 ulps, and
    must trip them: a kernel off by that much can pass the end-to-end
    control gate, whose reading the random layers' amplification of
    rounding sets."""
    from repro_torch.kernels import ops

    gates, name = path["call_gates"], path["fault"]

    def worst(calls):
        return (max(f for f, _ in calls), max(abs(b) for _, b in calls))

    frob, bias = worst(stats)
    check(frob <= gates["frob"] and bias <= gates["bias"],
          f"(d) {name}, bf16, each of its {len(stats)} calls against its "
          f"plain version: Frobenius ratio {frob:.3e} <= {gates['frob']:.3e}"
          f", |bias| {bias:.3e} <= {gates['bias']:.3e} (worst call)")
    faulted: dict = {}
    with wrapped(ops, name, lambda fn: compare_calls({}, name, faulted)(
            scale_output(1 + BF16_CALL_FAULT)(fn))):
        prefill_trunk(cfg, params, batch, path["block"])
    frob_f, bias_f = worst(faulted[name])
    check(frob_f > gates["frob"] or bias_f > gates["bias"],
          f"(f) {name}'s output scaled by 1 + {BF16_CALL_FAULT:.3g} trips "
          f"the call gates: Frobenius ratio {frob_f:.3e}, |bias| "
          f"{bias_f:.3e}")


@contextlib.contextmanager
def moe_routes(path: dict, routes: list, record: bool = False):
    """For a MoE path: record each ``moe.route`` call's decisions (each
    layer's experts and order) into ``routes``, or replay them in order in
    place of the routes the run would take; nothing for other paths."""
    from repro_torch.models import moe
    if not path.get("moe"):
        yield
        return
    replay = iter(routes)

    def wrap(route):
        def run(cfg, probs):
            if not record:
                return tuple(t.to(probs.device) for t in next(replay))
            out = route(cfg, probs)
            routes.append(out)
            return out
        return run

    with wrapped(moe, "route", wrap):
        yield


def moe_route_gate(cfg, params, batch, path, la, ha, lc, hc, routes_c):
    """The MoE path's kernel route against the plain route (c): a bf16
    difference in attention moves the router's logits, and a token whose
    k-th and (k+1)-th experts nearly tie changes experts, which moves the
    trunk discontinuously.  Re-run the kernel route recording its routes
    (bitwise equal to run (a)), print the share of (token, expert)
    assignments that differ from (c)'s and the logits and trunk
    differences with each route's own routing; then run the kernel route
    with (c)'s routing fed to it and return its logits and trunk, which
    the gates hold to (c)."""
    from repro_torch.models import transformer

    routes_a: list = []
    with moe_routes(path, routes_a, record=True):
        la2, ha2 = prefill_trunk(cfg, params, batch, path["block"])
    check(torch.equal(la2, la) and torch.equal(ha2, ha),
          "(a) re-run recording its routes: logits and trunk bitwise (a)'s")
    e = cfg.num_experts
    differ = total = 0
    for (ea, _), (ec, _) in zip(routes_a, routes_c):
        a = torch.nn.functional.one_hot(ea, e).sum(-2)
        c = torch.nn.functional.one_hot(ec, e).sum(-2)
        differ += int((a > c).sum())
        total += int(a.sum())
    emb = transformer.trunk_input(cfg, params, batch).float()
    rel = float((la.float() - lc.float()).abs().max() / lc.float().abs().max())
    print(f"  (a) vs (c), each with its own routing: {differ} of {total} "
          f"(token, expert) assignments differ over {len(routes_a)} MoE "
          f"layers ({differ / total:.3e}); last-position logits max abs "
          f"diff / max abs {rel:.3e}")
    trunk_diff("(a) vs (c), each with its own routing", ha.float() - emb,
               hc.float() - emb)
    with moe_routes(path, routes_c):
        la, ha = prefill_trunk(cfg, params, batch, path["block"])
    print(f"  (a, (c)'s routing) the kernel route with the plain route's "
          f"routing fed to it: the gates below hold it to (c)")
    return la, ha


def _cast(tree, dtype):
    """A copy of a param tree in ``dtype``, detached from any graph."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.detach().to(dtype)


def bf16_control_gate(cfg, params, batch, path, la, ha, tag="") -> None:
    """Hold the kernel route (run (a): logits ``la``, trunk ``ha``) to the
    plain route in the served dtype against a control: the plain route
    against itself with every output of the path's fault kernel op scaled
    by 1 + 1e-6, a change below bf16's resolution (1 + the path's
    ``control_scale`` where the op's output is bf16: 2^-8 moves each
    element by up to one bf16 ulp).  On a MoE path the plain route's
    routing is fed to the kernel route and to the control
    (:func:`moe_route_gate`).  The kernel route's
    logits and trunk Frobenius differences must stay within CONTROL_K
    times the control's.  The worst position is printed only: CONTROL_K
    times the control's reading there (0.72) would admit unrelated
    outputs.  ``tag`` names the weights in the check's line."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    scale = 1 + path.get("control_scale", 1e-6)
    routes: list = []
    with moe_routes(path, routes, record=True):
        lc, hc = prefill_trunk(cfg, params, batch, path["block"],
                               mode="plain")
    if path.get("moe"):
        la, ha = moe_route_gate(cfg, params, batch, path, la, ha, lc, hc,
                                routes)
    with wrapped(ops, path["fault"], scale_output(scale)), \
            moe_routes(path, routes):
        lp, hp = prefill_trunk(cfg, params, batch, path["block"],
                               mode="plain")
    emb = transformer.trunk_input(cfg, params, batch).float()
    tc = hc.float() - emb
    read = []
    for label, lx, hx in (("(a) vs (c), bf16", la, ha),
                          (f"control: (c) scaled by 1 + {scale - 1:.3g} vs "
                           f"(c), bf16", lp, hp)):
        rel = float((lx.float() - lc.float()).abs().max()
                    / lc.float().abs().max())
        print(f"  {label}: last-position logits max abs diff / max abs "
              f"{rel:.3e}")
        read.append((rel, trunk_diff(label, hx.float() - emb, tc)[0]))
    (rel_a, frob_a), (rel_c, frob_c) = read
    check(rel_a <= CONTROL_K * rel_c and frob_a <= CONTROL_K * frob_c,
          f"(a) vs (c), bf16{tag}, within {CONTROL_K}x the control: logits "
          f"{rel_a:.3e} <= {CONTROL_K * rel_c:.3e}, trunk Frobenius "
          f"{frob_a:.3e} <= {CONTROL_K * frob_c:.3e}")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def phase_lm_profile(cfg, params, batch) -> None:
    """``torch.profiler`` over one full-width prefill and one decode step
    after it: the device's busy share and the operations with the most
    device time.  The decode step is also timed without the profiler."""
    from repro_torch.runtime import steps
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        return out, prof, (t1 - t0) * 1e3

    B, S = batch["tokens"].shape[0], served_positions(batch)
    print(f"== profile: one {cfg.name} prefill ({B} x {S} positions)")
    step = steps.make_prefill_step(cfg, max_seq=S + MAX_NEW)
    with moe_ranges(cfg):
        (logits, cache), prof, wall_ms = profiled(lambda: step(params,
                                                               batch))
    moe_share(prof, device_report(prof, wall_ms, 15))

    print(f"== profile: one {cfg.name} decode step ({B} tokens) after that "
          f"prefill")
    serve = steps.make_serve_step(cfg)
    cur = logits.argmax(-1)[:, None]
    serve(params, cache, cur, S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        serve(params, cache, cur, S)
    torch.cuda.synchronize()
    print(f"  decode step without the profiler: "
          f"{(time.perf_counter() - t0) / 3 * 1e3:.3f} ms")
    with moe_ranges(cfg):
        _, prof, wall_ms = profiled(lambda: serve(params, cache, cur, S))
    moe_share(prof, device_report(prof, wall_ms, 8))


# The MoE layer's parts, each traced as a range of its own.
MOE_PARTS = ("_dispatch", "_experts", "_combine")
MOE_RANGES = tuple("moe" + name for name in MOE_PARTS)


@contextlib.contextmanager
def moe_ranges(cfg):
    """For a MoE config, wrap the MoE layer's parts (router, schedule and
    dispatch; the expert products; the combine) in ``record_function``
    ranges named ``moe<part>``; nothing otherwise."""
    from repro_torch.models import moe
    from torch.profiler import record_function

    def ranged(name):
        def wrap(fn):
            def run(*args, **kwargs):
                with record_function("moe" + name):
                    return fn(*args, **kwargs)
            return run
        return wrap

    with contextlib.ExitStack() as stack:
        if cfg.num_experts:
            for name in MOE_PARTS:
                stack.enter_context(wrapped(moe, name, ranged(name)))
        yield


def moe_share(prof, busy_ms: float) -> None:
    """Print the device time of each MoE range of a profile (the kernels
    launched inside its host range) and their share of the device's busy
    time."""
    def dev_us(e):
        if hasattr(e, "device_time_total"):
            return e.device_time_total
        return e.cuda_time_total

    parts = {name: sum(dev_us(e) for e in prof.events()
                       if e.name == "moe" + name
                       and str(e.device_type).endswith("CPU")) / 1e3
             for name in MOE_PARTS}
    if not any(parts.values()):
        return
    total = sum(parts.values())
    print(f"  MoE device time {total:.3f} ms = {total / busy_ms:.3f} of the "
          f"busy time: " + ", ".join(
              f"{name[1:]} {ms:.3f} ms" for name, ms in parts.items()))


def lm_bound(name, args, kwargs):
    """(bound_ms, bound_by) of flash_attention or rglru_scan on ``args``
    (``repro_torch.kernels.cost``): bytes (inputs read once, output
    written once) over the HBM rate against flops over the dtype's peak;
    the attention's flops count the visible score entries only, its
    bytes k and v at their own (kv head) rows."""
    from repro_torch.kernels import cost
    t = args[0]
    if name == "flash_attention":
        return cost.flash_attention(
            t.shape, args[1].shape, t.dtype, causal=kwargs["causal"],
            window=kwargs["window"]).bound()
    return cost.rglru_scan(t.shape, t.dtype).bound()


def lm_kernel(name):
    from repro_torch.kernels import flash_attention, rglru_scan
    return {"flash_attention": flash_attention.flash_attention,
            "rglru_scan": rglru_scan.rglru_scan}[name]


def lm_plain(name):
    from repro_torch.kernels import ref
    return {"flash_attention": ref.attention_plain,
            "rglru_scan": ref.rglru_scan_plain,
            "ssd_scan": ref.ssd_scan_plain}[name]


def worst_row(out, plain) -> float:
    """The largest over rows (the last dimension) of ||out - plain|| /
    ||plain||; a row of zeros in ``plain`` asks for zeros in ``out``."""
    diff = (out.float() - plain.float()).norm(dim=-1)
    return float((diff / plain.float().norm(dim=-1).clamp_min(1e-30)).max())


def lm_compare(name, args, kwargs, label):
    out_k = lm_kernel(name)(*args, **kwargs)
    out_p = lm_plain(name)(*args, **kwargs)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    scale = float(out_p.float().abs().max()) or 1.0
    dtype = args[0].dtype
    tol = LM_TOL[dtype]
    ok = (out_k.shape == out_p.shape and out_k.dtype == out_p.dtype
          and bool(torch.isfinite(out_k).all()) and err / scale <= tol)
    what = (f"{name} {label} {str(dtype)[6:]}: max abs err {err:.3e}, rel "
            f"{err / scale:.3e} <= {tol:g}")
    if name == "flash_attention" and ok:
        row = worst_row(out_k, out_p)
        ok = row <= ATTN_ROW_TOL[dtype]
        what += f", worst row {row:.3e} <= {ATTN_ROW_TOL[dtype]:g}"
    check(ok, what)
    return err


def attention_masked(q, k, v, visible):
    """``ref.attention_plain``'s function under an explicit (S, S)
    visibility mask, one query head at a time."""
    from repro_torch.kernels import ref
    rep = q.shape[0] // k.shape[0]
    out = torch.empty_like(q)
    for b in range(q.shape[0]):
        scores = (q[b].float() @ k[b // rep].float().T
                  / float(np.sqrt(q.shape[2])))
        scores = torch.where(visible, scores, ref.NEG_INF)
        out[b] = (torch.softmax(scores, dim=-1)
                  @ v[b // rep].float()).to(q.dtype)
    return out


def attention_masks(s: int, causal: bool, window: int, device, *,
                    key_tile: int = 64, q_block: int = 128,
                    s_kv: int | None = None):
    """The visibility mask of (causal, window) and the masks that a kernel
    with one ``key_tile``-key tile wrong would apply (64 keys and 128-row
    q blocks, the bf16 kernels' tiles, unless given): the window's edge
    one tile early (rows >= window lose their ``key_tile`` oldest keys),
    and the first tile that all rows of the last q block see in full
    skipped for that block (the rows that see the most keys, where one
    tile moves the output least).  (mask, [(label, faulty mask), ...]);
    with ``s_kv`` keys (a cross-attention) the mask is (S, S_kv)."""
    t = key_tile
    pos = torch.arange(s)
    s_kv = s if s_kv is None else s_kv
    ok = torch.ones(s, s_kv, dtype=torch.bool)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    faults = []
    if window > t:
        faults.append((f"window edge one {t}-key tile early",
                       ok & (pos[None, :] > pos[:, None] - (window - t))))
    if window > 0:
        ok &= pos[None, :] > pos[:, None] - window
    q0 = (s - 1) // q_block * q_block
    k0 = next((k0 for k0 in range(0, s_kv - t + 1, t)
               if bool(ok[q0:, k0:k0 + t].all())), None)
    if k0 is not None:
        skipped = ok.clone()
        skipped[q0:, k0:k0 + t] = False
        faults.append((f"rows {q0}.. without keys {k0}..{k0 + t - 1}, their "
                       f"first fully visible {t}-key tile", skipped))
    return ok.to(device), [(label, m.to(device)) for label, m in faults]


def check_attention_faults(qkv, kwargs):
    """Plant one-tile faults in the plain output and hold them to the
    checks: ``ATTN_ROW_TOL`` must catch each (``LM_TOL`` alone is printed
    beside it), and must pass the plain version recomputed under the true
    mask by the same code that plants them."""
    plain = lm_plain("flash_attention")(*qkv, **kwargs)
    scale = float(plain.float().abs().max())
    tol = ATTN_ROW_TOL[plain.dtype]
    ok, faults = attention_masks(qkv[0].shape[1], kwargs["causal"],
                                 kwargs["window"], qkv[0].device)
    row = worst_row(attention_masked(*qkv, ok), plain)
    check(row <= tol, f"flash_attention plain under its own mask, one head "
          f"at a time: worst row {row:.3e} <= {tol:g}")
    for label, mask in faults:
        out = attention_masked(*qkv, mask)
        rel = float((out.float() - plain.float()).abs().max()) / scale
        row = worst_row(out, plain)
        check(row > tol, f"flash_attention planted fault ({label}): worst "
              f"row {row:.3e} > {tol:g} (max abs over max |plain| "
              f"{rel:.3e}, against LM_TOL {LM_TOL[plain.dtype]:g})")


def sdpa_calls(q, k, v, causal: bool, window: int, heads: int):
    """Two ``scaled_dot_product_attention`` calls on the same inputs,
    timed as yardsticks (the port never calls them): with the same
    causal-window boolean mask, the same function as the kernel; and with
    ``is_causal=True`` and no mask, full causal attention (1.33x the
    visible scores at the prefill's window), which shows only what
    PyTorch's own fused kernel reaches on this card.  Where every key is
    visible (non-causal, no window; a cross-attention's S_kv keys) both
    are SDPA with no mask, the same function.  SDPA takes k and v with
    every query head's row, so the expanded copy is made here, before the
    timed window."""
    bh, s, d = q.shape
    rep, s_kv = bh // k.shape[0], k.shape[1]
    k, v = (t.repeat_interleave(rep, dim=0) for t in (k, v))
    qs = q.view(bh // heads, heads, s, d)
    ks, vs = (t.view(bh // heads, heads, s_kv, d) for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not causal and window <= 0:
        return (lambda: sdpa(qs, ks, vs),) * 2
    mask = attention_masks(s, causal, window, q.device)[0]
    return (lambda: sdpa(qs, ks, vs, attn_mask=mask),
            lambda: sdpa(qs, ks, vs, is_causal=True))


# Ragged flash_attention cases with grouped kv (BH, BH_kv, S, D, causal,
# window): GQA at D 256, MQA at D 128, one kv row per query row at an odd S,
# one prefill-length MQA layer at the prefill's window, and a window no
# shorter than S.
GQA_RAGGED = ((32, 2, 1000, 256, True, 0), (16, 1, 160, 128, True, 64),
              (4, 4, 77, 64, False, 0), (3, 1, 4096, 256, True, 2048),
              (8, 2, 300, 128, True, 512))


def phase_lm_kernels(inputs: dict, layer_errs: dict, counts: dict,
                     heads: int) -> list:
    """Kernel vs plain at the prefill's own shapes: the first call of
    each op in run (a), random values at the same shapes (the JSON
    max_abs_err is the largest of these and of every layer of run (d),
    ``layer_errs``), two launches bitwise equal; then ragged shapes;
    then the timings of the main shape."""
    print("== kernels: LM")
    gen = torch.Generator(device=DEVICE).manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    rows = []
    for name in ("flash_attention", "rglru_scan"):
        args, kwargs = inputs[name]
        kwargs = {k: v for k, v in kwargs.items() if k != "mode"}
        shape, dtype = tuple(args[0].shape), args[0].dtype
        err = max(layer_errs[name],
                  lm_compare(name, args, kwargs, f"prefill input {shape}"))
        if name == "flash_attention":
            kshape = tuple(args[1].shape)
            rand = (randn(*shape, dtype=dtype), randn(*kshape, dtype=dtype),
                    randn(*kshape, dtype=dtype))
        else:
            rand = (torch.rand(*shape, generator=gen, device=DEVICE)
                    .mul(0.3).add(0.7).to(dtype),
                    randn(*shape, dtype=dtype).mul(0.1))
        err = max(err, lm_compare(name, rand, kwargs, f"random {shape}"))
        if name == "flash_attention":
            check_attention_faults(rand, kwargs)
        k1 = lm_kernel(name)(*args, **kwargs)
        check(torch.equal(k1, lm_kernel(name)(*args, **kwargs)),
              f"{name}: two launches bitwise equal")
        bound, by = lm_bound(name, args, kwargs)
        row = {
            "name": name, "ok": True, "route": "cuda",
            "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": counts[name], "max_abs_err": err,
            "ms": time_ms(lambda: lm_kernel(name)(*args, **kwargs), 20),
            "plain_ms": time_ms(lambda: lm_plain(name)(*args, **kwargs), 2),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": list(shape), "dtype": str(dtype)[6:],
        }
        if name == "rglru_scan":
            row.update(rglru_paths(args, f"prefill input {shape}"))
        if name == "flash_attention":
            row["kv_shape"] = list(args[1].shape)
            masked, causal_only = sdpa_calls(*args, heads=heads, **kwargs)
            row["library_ms"] = time_ms(masked, 10)
            row["sdpa_causal_ms"] = time_ms(causal_only, 10)
            # The kernel on k and v expanded to every query head, as the
            # prefill passed them before it read the kv heads in place.
            rep = shape[0] // args[1].shape[0]
            kv = tuple(t.repeat_interleave(rep, dim=0) for t in args[1:])
            row["ms_expanded_kv"] = time_ms(
                lambda: lm_kernel(name)(args[0], *kv, **kwargs), 20)
            del kv
        lib = row["library_ms"]
        print(f"  {name} {shape}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound:.4f} ms ({by})")
        if name == "rglru_scan":
            print(f"  rglru_scan {shape}: {row['path']} path, median "
                  f"{row['ms_median']:.4f} ms; the direct path (the first "
                  f"design) {row['direct_ms']:.4f} ms back to back, median "
                  f"{row['direct_ms_median']:.4f} ms; earlier "
                  f"{EARLIER_FWD_MS['rglru_scan_prefill']:.4f} ms (PERF.md)")
        if name == "flash_attention":
            print(f"  flash_attention k, v {row['kv_shape']}; kernel on k, v "
                  f"expanded to every query head "
                  f"{row['ms_expanded_kv']:.4f} ms; library = SDPA with the "
                  f"same mask on that expanded copy; SDPA is_causal=True "
                  f"without the window (full causal, "
                  f"{row['sdpa_causal_ms']:.4f} ms) is no yardstick of the "
                  f"same function")
        rows.append(row)

    for dtype in (torch.float32, torch.bfloat16):
        for s in (1000, 160):
            for d in (64, 128, 256):
                for causal, window in ((True, 0), (True, 64), (False, 0)):
                    qkv = tuple(randn(3, s, d, dtype=dtype)
                                for _ in range(3))
                    lm_compare("flash_attention", qkv,
                               {"causal": causal, "window": window},
                               f"ragged (3, {s}, {d}) causal={causal} "
                               f"window={window}")
        # k and v read in place: BH_kv rows serving BH query rows.
        for bh, bh_kv, s, d, causal, window in GQA_RAGGED:
            qkv = (randn(bh, s, d, dtype=dtype),
                   randn(bh_kv, s, d, dtype=dtype),
                   randn(bh_kv, s, d, dtype=dtype))
            lm_compare("flash_attention", qkv,
                       {"causal": causal, "window": window},
                       f"grouped kv ({bh}, {bh_kv}, {s}, {d}) causal={causal}"
                       f" window={window}")
    for dtype, shapes in RGLRU_RAGGED.items():
        for shape in shapes:
            ab = (torch.rand(*shape, generator=gen, device=DEVICE)
                  .mul(0.3).add(0.7).to(dtype),
                  randn(*shape, dtype=dtype).mul(0.1))
            rglru_compare(ab, f"ragged {shape}")
    return rows


def attention_shape_row(name: str, label: str, args, kwargs, launches: int,
                        heads: int, layer_err: float = 0.0) -> dict:
    """A ``kernels`` row for flash_attention at a shape of a later path
    (``name``): the path's first call ``args`` and random values at the
    same shape held against the plain version (:func:`lm_compare`: LM_TOL
    and the worst row within ATTN_ROW_TOL; the row's max_abs_err is the
    largest of these and ``layer_err``, the worst layer of the path's run
    (d)), two launches bitwise equal; the kernel, the plain version and
    SDPA timed (library_ms: SDPA with the same mask, or with
    ``is_causal=True`` where the mask is plain causal, the same function;
    the other printed beside it) and the bound."""
    shape, dtype = tuple(args[0].shape), args[0].dtype
    err = max(layer_err, lm_compare("flash_attention", args, kwargs,
                                    f"{label} input {shape}"))
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    rand = tuple(torch.randn(t.shape, generator=gen, device=DEVICE).to(dtype)
                 for t in args)
    err = max(err, lm_compare("flash_attention", rand, kwargs,
                              f"{label} random {shape}"))
    del rand
    kernel = lambda: lm_kernel("flash_attention")(*args, **kwargs)  # noqa
    check(torch.equal(kernel(), kernel()),
          f"flash_attention {label}: two launches bitwise equal")
    bound, by = lm_bound("flash_attention", args, kwargs)
    masked, causal_only = sdpa_calls(*args, heads=heads, **kwargs)
    sdpa_masked, sdpa_causal = time_ms(masked, 10), time_ms(causal_only, 10)
    same = kwargs["causal"] and kwargs["window"] <= 0
    row = {
        "name": name, "ok": True, "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"], "launches": launches,
        "max_abs_err": err, "ms": time_ms(kernel, 20),
        "plain_ms": time_ms(
            lambda: lm_plain("flash_attention")(*args, **kwargs), 2),
        "bound_ms": bound, "bound_by": by,
        "library_ms": sdpa_causal if same else sdpa_masked,
        "sdpa_masked_ms": sdpa_masked, "sdpa_causal_ms": sdpa_causal,
        "shape": list(shape), "kv_shape": list(args[1].shape),
        "dtype": str(dtype)[6:], "window": int(kwargs["window"]),
    }
    print(f"  flash_attention {label} {shape}, k, v {row['kv_shape']}, "
          f"window {row['window']}: kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms "
          f"({'is_causal' if same else 'same mask'}; with the mask "
          f"{sdpa_masked:.4f} ms, is_causal {sdpa_causal:.4f} ms), bound "
          f"{bound:.4f} ms ({by}), share of the bound "
          f"{bound / row['ms']:.3f}, {launches} launches a path run")
    return row


def attention_bwd_shape_row(name: str, label: str, args, kwargs,
                            launches: int, heads: int,
                            kernel_delta: bool = False,
                            rows: bool | str = True) -> dict:
    """A ``kernels`` row for the flash_attention backward at a shape of a
    later path: :func:`bwd_compare` on ``args`` and on random values at
    the shape (the forward outputs it reads at the forward's gates, the
    gradients against autograd through the plain version within
    GRAD_TOL, dK, dV and dQ row by row), two launches bitwise equal; the
    kernel (median of 7), the plain backward and SDPA's backward timed
    beside the bound (library_ms: SDPA's causal path where the mask is
    plain causal, the same function, else the same mask; both printed),
    and the device time of each of its CUDA launches (the
    profiler's, :func:`launch_times`; where it drops them, each launch
    alone between CUDA events, :func:`attention_launch_times`), in f32 or
    bf16 (``flash_attention_bwd_f32.cu`` or ``flash_attention_bwd.cu``).
    ``kernel_delta`` and ``rows`` go to :func:`bwd_compare` for
    ``args`` (the random values' rows are always gated)."""
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    shape, dtype = tuple(args[0].shape), args[0].dtype
    key = ("flash_attention_f32" if dtype == torch.float32
           else "flash_attention")
    err, fwd, kernel, plain, dout, _ = bwd_compare(
        "flash_attention", args, kwargs, gen, f"{label} {shape}", rows,
        kernel_delta)
    rand = tuple(torch.randn(t.shape, generator=gen, device=DEVICE).to(dtype)
                 for t in args)
    err = max(err, bwd_compare("flash_attention", rand, kwargs, gen,
                               f"{label} random {shape}", True)[0])
    del rand
    g1, g2 = kernel(), kernel()
    check(all(torch.equal(a, b) for a, b in zip(g1, g2)),
          f"flash_attention backward {label}: two launches bitwise equal")
    del g1, g2
    bound, by = bwd_bound("flash_attention", args, kwargs)
    masked = median_ms(sdpa_backward(*args, dout, heads=heads, **kwargs), 5)
    same = kwargs["causal"] and kwargs["window"] <= 0
    causal = (median_ms(sdpa_backward(*args, dout, heads=heads,
                                      is_causal=True, **kwargs), 5)
              if same else None)
    row = {
        "name": name, "ok": True, "route": "cuda",
        "source": BWD_SOURCES[key],
        "replaces": REPLACES["flash_attention"], "pass": "backward",
        "launches": launches, "max_abs_err": err,
        "ms": median_ms(kernel, 7), "plain_ms": median_ms(plain, 3),
        "bound_ms": bound, "bound_by": by,
        "library_ms": causal if same else masked,
        "sdpa_masked_ms": masked, "sdpa_causal_ms": causal,
        "shape": list(shape), "kv_shape": list(args[1].shape),
        "dtype": str(dtype)[6:], "window": int(kwargs["window"]),
    }
    print(f"  flash_attention backward {label} {shape}: kernel "
          f"{row['ms']:.4f} ms (median), plain {row['plain_ms']:.4f} ms, "
          f"SDPA backward {row['library_ms']:.4f} ms "
          f"({'is_causal' if same else 'same mask'}; with the mask "
          f"{masked:.4f} ms), bound "
          f"{bound:.4f} ms ({by}), share of the bound "
          f"{bound / row['ms']:.3f}, {launches} launches a training step")
    parts, how = launch_times(kernel, BWD_KERNELS[key]), \
        "the profiler's"
    from repro_torch.kernels import flash_attention
    launches = flash_attention.bwd_plan(args[0].shape, args[1].shape,
                                        dtype)["launches"]
    if len(parts) != len(launches):
        parts = attention_launch_times(args, fwd, dout, kwargs, kernel,
                                       row["ms"])
        how = "each launch alone between CUDA events"
    row["launch_ms"] = {k: ms for k, ms in parts}
    print(f"  flash_attention backward {label} launches, device time a call "
          f"({how}): " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in parts))
    print_bwd_build(key, args, kwargs)
    return row


# The bf16 attention's design at head dimension 128 (128-key tiles on a
# persistent grid; the backward's dkdv on 128-row kv blocks) on the card,
# (BH, BH_kv, S, causal, window): S off a multiple of 128, GQA rep 8 and 16
# (also in two query-head groups a kv block), windows of 512 and 4096 at S
# = 8192, non-causal with and without a window; the backward on most.
D128_FWD = ((8, 8, 1000, True, 0), (8, 8, 4095, True, 0),
            (16, 2, 1000, True, 0), (32, 2, 4095, True, 0),
            (2, 1, 8192, True, 512), (2, 1, 8192, True, 4096),
            (4, 4, 1000, False, 0), (4, 1, 4095, False, 0),
            (4, 2, 300, False, 64), (3, 1, 77, True, 0))
D128_BWD = ((8, 8, 1000, True, 0), (16, 2, 1000, True, 0),
            (16, 1, 4095, True, 0), (2, 1, 8192, True, 4096),
            (2, 2, 8192, True, 512), (4, 4, 1000, False, 0),
            (6, 3, 300, True, 512), (3, 3, 77, True, 0))


def phase_attention_d128() -> None:
    """The bf16 flash_attention forward and backward at D = 128 on
    D128_FWD's and D128_BWD's shapes, each held to its plain version
    (:func:`lm_compare`, :func:`bwd_compare` with the rows of dQ, dK and
    dV), two launches bitwise equal."""
    from repro_torch.kernels import flash_attention
    print("== kernels: flash_attention bf16 at D = 128 (ragged S, GQA, "
          "windows, non-causal)")
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    for cases, bwd in ((D128_FWD, False), (D128_BWD, True)):
        for bh, bh_kv, s, causal, window in cases:
            qkv = tuple(torch.randn(r, s, 128, generator=gen, device=DEVICE)
                        .to(torch.bfloat16) for r in (bh, bh_kv, bh_kv))
            kw = {"causal": causal, "window": window}
            label = (f"D 128 ({bh}, {bh_kv}, {s}) causal={causal} "
                     f"window={window}")
            if bwd:
                kernel = bwd_compare("flash_attention", qkv, kw, gen, label,
                                     True)[2]
            else:
                lm_compare("flash_attention", qkv, kw, label)

                def kernel():
                    return flash_attention.flash_attention(*qkv, lse=True,
                                                           **kw)
            one, two = kernel(), kernel()
            check(all(torch.equal(a, b) for a, b in zip(one, two)),
                  f"flash_attention{' backward' if bwd else ''} {label}: two "
                  f"launches bitwise equal")
            del qkv, kernel, one, two
    torch.cuda.empty_cache()


# flash_attention where k and v have another length than q, non-causal
# with no window (BH, BH_kv, S, S_kv, D, causal): whisper-large-v3's
# encoder call (S_kv = S = 1500), its prefill's cross call (416 query rows
# against the 1500 frames) and its training's (448), one query row, a
# ragged S_kv, S_kv under one 128-key tile with grouped kv, and D 128 and
# 256 (the other bf16 design); then phi-3-vision's head dimension 96,
# causal at its prefill shape and ragged.
CROSS_ATTN = ((80, 80, 1500, 1500, 64, False),
              (80, 80, 416, 1500, 64, False),
              (80, 80, 448, 1500, 64, False), (20, 20, 1, 1500, 64, False),
              (8, 8, 300, 1001, 64, False), (8, 4, 200, 77, 64, False),
              (6, 2, 130, 33, 128, False), (4, 4, 77, 300, 256, False),
              (32, 32, 4096, 4096, 96, True), (8, 8, 1000, 1000, 96, True))
# The f32 backward cases held row by row as well as in Frobenius: those
# whose dQ row gate (against the FA2 plain backward in f64) holds at most
# CROSS_ROWS_MAX score elements (phi-3-vision's shape holds 2^29), and
# with at least CROSS_ROWS_MIN_Q query rows.  With one query row each dK
# row is one entry of dS = P .* (dP - Delta) times q, whose relative
# error is that of dP_j - Delta where the two nearly cancel, and the
# kernel's Delta and autograd's differ in rounding: the worst f32 dK row
# read 1.5e-4 at the floor of the row gate (GRAD_ROW_FLOOR) against
# 2e-5, at a Frobenius difference of 7.7e-7; the worst bf16 one 0.159
# against 2e-2, autograd's Delta reading the f32 output (measured on
# one H100).  bf16 cases with fewer query rows hold dQ and dK
# against the FA2 plain backward fed the kernel's own bf16 out
# (``bwd_compare``'s ``kernel_delta``), as every bf16 dQ row gate does.
CROSS_ROWS_MAX = 1 << 28
CROSS_ROWS_MIN_Q = 128


def phase_cross_attention() -> None:
    """flash_attention forward and backward in f32 and bf16 on CROSS_ATTN's
    shapes, each held to its plain version (:func:`lm_compare`: LM_TOL
    and the worst row; :func:`bwd_compare`: the forward outputs it reads,
    the gradients within GRAD_TOL and, in bf16 and where CROSS_ROWS_MAX
    and CROSS_ROWS_MIN_Q allow in f32, dK, dV and dQ row by row), two
    launches bitwise equal (out and lse; dQ, dK and dV)."""
    from repro_torch.kernels import flash_attention
    print("== kernels: flash_attention with S_kv != S (cross-attention) and "
          "at head dimension 96, f32 and bf16, forward and backward")
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    for dtype in (torch.float32, torch.bfloat16):
        for bh, bh_kv, s, s_kv, d, causal in CROSS_ATTN:
            qkv = tuple(torch.randn(r, n, d, generator=gen, device=DEVICE)
                        .to(dtype) for r, n in ((bh, s), (bh_kv, s_kv),
                                                (bh_kv, s_kv)))
            kw = {"causal": causal, "window": 0}
            label = (f"({bh}, {bh_kv}, S {s}, S_kv {s_kv}, D {d}) "
                     f"causal={causal}")
            lm_compare("flash_attention", qkv, kw, label)
            one = flash_attention.flash_attention(*qkv, lse=True, **kw)
            two = flash_attention.flash_attention(*qkv, lse=True, **kw)
            check(all(torch.equal(a, b) for a, b in zip(one, two)),
                  f"flash_attention {label} {str(dtype)[6:]}: two launches "
                  f"bitwise equal")
            del one, two
            rows = dtype == torch.bfloat16 or (
                s >= CROSS_ROWS_MIN_Q and bh * s * s_kv <= CROSS_ROWS_MAX)
            few = dtype == torch.bfloat16 and s < CROSS_ROWS_MIN_Q
            kernel = bwd_compare("flash_attention", qkv, kw, gen, label,
                                 rows, kernel_delta=few)[2]
            one, two = kernel(), kernel()
            check(all(torch.equal(a, b) for a, b in zip(one, two)),
                  f"flash_attention backward {label} {str(dtype)[6:]}: two "
                  f"launches bitwise equal")
            del qkv, kernel, one, two
            torch.cuda.empty_cache()


# Soft-capped attention (attn_softcap > 0, cap tanh(s scale / cap) before
# the mask): each kernel design with a cap that bites, at a path's shapes
# (row name, label, (BH, BH_kv, S, S_kv, D), dtype, causal, window,
# backward, query heads a batch row): the bf16 forward at D = 256 on
# RecurrentGemma-9B's prefill shape and its backward at the training
# shape (PERF.md rows 4 and 7), both at D = 128 on Yi-6B's prefill shape,
# the forward at whisper-large-v3's cross shape (S_kv != S), and the f32
# forward and backward at D = 256 on RecurrentGemma's f32 training shape
# (rows 4 and 10).  Their q and k are drawn at SOFTCAP_AMP, so that the
# scaled scores (standard deviation AMP^2 = 9) reach several caps of
# SOFTCAP_CALL.
SOFTCAP_CALL = 10.0
SOFTCAP_AMP = 3.0
SOFTCAP_CALLS = (
    ("flash_attention_softcap_recurrentgemma_prefill",
     "recurrentgemma-9b prefill", (64, 4, 4096, 4096, 256), torch.bfloat16,
     True, 2048, False, 16),
    ("flash_attention_bwd_softcap_recurrentgemma_train",
     "recurrentgemma-9b training", (32, 2, 4096, 4096, 256), torch.bfloat16,
     True, 2048, True, 16),
    ("flash_attention_softcap_yi_6b_prefill", "yi-6b prefill",
     (128, 16, 4096, 4096, 128), torch.bfloat16, True, 0, False, 32),
    ("flash_attention_bwd_softcap_yi_6b", "yi-6b prefill shape",
     (128, 16, 4096, 4096, 128), torch.bfloat16, True, 0, True, 32),
    ("flash_attention_softcap_whisper_cross_prefill",
     "whisper-large-v3 cross-attention prefill", (80, 80, 416, 1500, 64),
     torch.bfloat16, False, 0, False, 20),
    ("flash_attention_f32_softcap_recurrentgemma_train",
     "recurrentgemma-9b f32 training", (32, 2, 4096, 4096, 256),
     torch.float32, True, 2048, False, 16),
    ("flash_attention_bwd_f32_softcap_recurrentgemma_train",
     "recurrentgemma-9b f32 training", (32, 2, 4096, 4096, 256),
     torch.float32, True, 2048, True, 16),
)
# The capped rows' library call (SDPA takes no cap): flex_attention with
# the cap as its score_mod and the causal and window mask as its block
# mask, compiled by torch.compile, one graph a shape.  Its compiles
# (4-20 s a shape on the card) run first in a child process started
# before the LM phases (``--warm-flex``), so that the rows' own compiles
# read inductor's and Triton's caches under FLEX_CACHE.
FLEX_CACHE = os.path.join(HERE, "build", "torchinductor")
FLEX_WARM_LOG = os.path.join(HERE, "build", "flex_warm.log")
_FLEX: dict = {}


def flex_library(args, kwargs, heads: int, dout=None):
    """flex_attention on a capped call's inputs, compiled: q as (B,
    heads, S, D), k and v expanded to every query head (the copy made
    here, before any timed window, as for SDPA), the cap and the
    window's reach as tensors its mods capture, so that a graph serves
    any cap and window at its shape.  Returns (the call, the wall of
    its first call in seconds: the compile); the call is the forward, or
    with ``dout`` the backward alone (``autograd.grad`` of a kept
    forward, as :func:`sdpa_backward` times SDPA's)."""
    import torch._dynamo.config as dynamo_config
    import torch._functorch.config as functorch_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    os.environ["TORCHINDUCTOR_CACHE_DIR"] = FLEX_CACHE
    # the backward is timed on a kept graph (retain_graph), which
    # donated buffers refuse; every shape keeps its own graph
    functorch_config.donated_buffer = False
    dynamo_config.recompile_limit = 64
    if "fn" not in _FLEX:
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False,
                                    fullgraph=True)
    compiled = _FLEX["fn"]
    q, k, v = args
    bh, s, d = q.shape
    s_kv = k.shape[1]
    rep, b = bh // k.shape[0], bh // heads
    causal, window = bool(kwargs["causal"]), int(kwargs["window"])
    if window > 0 and not causal:
        raise ValueError("flex_library: a window without the causal mask")
    cap = torch.tensor(float(kwargs["softcap"]), device=q.device)
    reach = torch.tensor(window if window > 0 else s + s_kv,
                         device=q.device)

    def score_mod(score, bi, hi, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(bi, hi, qi, ki):
        return (ki <= qi) & (qi - ki < reach)
    mask = (create_block_mask(mask_mod, None, None, s, s_kv,
                              device=q.device) if causal else None)
    leaves = [q.detach().reshape(b, heads, s, d)] + [
        t.detach().repeat_interleave(rep, dim=0).reshape(b, heads, s_kv, d)
        for t in (k, v)]
    t0 = time.perf_counter()
    if dout is None:
        def call():
            return compiled(*leaves, score_mod=score_mod, block_mask=mask)
        call()
    else:
        leaves = [t.clone().requires_grad_() for t in leaves]
        out = compiled(*leaves, score_mod=score_mod, block_mask=mask)
        dview = dout.reshape(b, heads, s, d)

        def call():
            return torch.autograd.grad(out, leaves, dview,
                                       retain_graph=True)
        call()
    torch.cuda.synchronize()
    return call, time.perf_counter() - t0


def flex_specs() -> tuple:
    """Every capped row's flex_attention call: ((BH, BH_kv, S, S_kv, D),
    dtype, causal, window, backward, heads), the full-width gemma-7b
    phase's three (its prefill in bf16 and in f32, its training step)
    and SOFTCAP_CALLS'."""
    from repro_torch import configs

    g = configs.get_config("gemma-7b")
    h, hk, d = g.num_heads, g.num_kv_heads, g.head_dim
    b, s = SOFTCAP_PROMPTS, SOFTCAP_PROMPT_LEN
    tb, ts = SOFTCAP_TRAIN
    return (((b * h, b * hk, s, s, d), torch.bfloat16, True, 0, False, h),
            ((b * h, b * hk, s, s, d), torch.float32, True, 0, False, h),
            ((tb * h, tb * hk, ts, ts, d), torch.bfloat16, True, 0, True,
             h)) + tuple(c[2:] for c in SOFTCAP_CALLS)


def warm_flex() -> int:
    """``chip_smoke.py --warm-flex``: compile (and run once) each of
    :func:`flex_specs` on random inputs; its caches are what counts."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for (bh, bh_kv, s, s_kv, d), dtype, causal, window, bwd, heads in \
            flex_specs():
        q, k, v, dout = (torch.randn(n, t, d, generator=gen,
                                     device=DEVICE).to(dtype)
                         for n, t in ((bh, s), (bh_kv, s_kv), (bh_kv, s_kv),
                                      (bh, s)))
        kw = {"causal": causal, "window": window, "softcap": SOFTCAP_CALL}
        _, first = flex_library((q, k, v), kw, heads,
                                dout if bwd else None)
        print(f"flex_attention {'backward ' if bwd else ''}{(bh, s, d)} "
              f"kv {(bh_kv, s_kv)} {dtype} causal {causal} window {window}:"
              f" first call {first:.1f} s", flush=True)
        del q, k, v, dout
        torch.cuda.empty_cache()
    return 0


def start_flex_warm():
    """Start :func:`warm_flex` in a child process (its output in
    FLEX_WARM_LOG); :func:`join_flex_warm` waits for it."""
    import atexit

    os.makedirs(os.path.dirname(FLEX_WARM_LOG), exist_ok=True)
    log = open(FLEX_WARM_LOG, "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--warm-flex"],
        stdout=log, stderr=subprocess.STDOUT, cwd=HERE,
        env=dict(os.environ, TORCHINDUCTOR_CACHE_DIR=FLEX_CACHE))
    log.close()
    proc.started = time.perf_counter()
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def join_flex_warm(proc) -> None:
    """Wait for the warm-up child and print its log; a child that failed
    only leaves the rows' compiles uncached."""
    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    with open(FLEX_WARM_LOG) as f:
        lines = f.read().splitlines()
    print(f"== flex_attention warm-up child: exit {rc}, "
          f"{time.perf_counter() - proc.started:.1f} s since its start")
    for line in (lines if rc == 0 else lines[-20:]):
        print(f"  {line}")


def softcap_row(name: str, label: str, args, kwargs, launches: int,
                launches_from, backward: bool, heads: int) -> dict:
    """A ``kernels`` row of a soft-capped flash_attention call (with
    ``backward``, of its backward): held to the plain version under the
    uncapped calls' gates (:func:`lm_compare`: LM_TOL and the worst row;
    :func:`bwd_compare`: the forward outputs it reads, GRAD_TOL and the
    rows of dQ, dK and dV); the capped and the uncapped kernel on the same
    inputs differ by at least 10 times the gate (max abs over max abs for
    the forward, every gradient's Frobenius distance over norm for the
    backward), so a kernel that ignored the cap would fail; two launches
    bitwise equal; the kernel, the uncapped kernel, the plain version
    and the library (:func:`flex_library`, ``heads`` query heads a batch
    row) timed beside the bound (the uncapped call's: the tanh runs on
    the special-function units and is not counted)."""
    from repro_torch.kernels import flash_attention

    dtype, shape = args[0].dtype, tuple(args[0].shape)
    uncapped_kw = {k: v for k, v in kwargs.items() if k != "softcap"}
    what = f"{label} softcap {kwargs['softcap']:g} {shape}"
    if backward:
        gen = torch.Generator(device=DEVICE).manual_seed(17)
        err, _, kernel, plain, dout, _ = bwd_compare(
            "flash_attention", args, kwargs, gen, what, True)
        fwd0 = flash_attention.flash_attention(*args, lse=True,
                                               **uncapped_kw)

        def uncapped():
            return flash_attention.flash_attention_bwd(*args, *fwd0, dout,
                                                       **uncapped_kw)
        moved = min(_rel(a, b) for a, b in zip(uncapped(), kernel()))
        gate, timer, reps, plain_reps = GRAD_TOL[dtype], median_ms, 7, 3
        bound, by = bwd_bound("flash_attention", args, kwargs)
        same = all(torch.equal(a, b) for a, b in zip(kernel(), kernel()))
        library, compile_s = flex_library(args, kwargs, heads, dout)
        # (dK and dV of every query head summed over each kv head's)
        lib_diff = max(float((a.float().reshape(b.shape[0], -1,
                                                *b.shape[1:]).sum(1)
                              - b.float()).abs().max())
                       for a, b in zip(library(), kernel()))
    else:
        err = lm_compare("flash_attention", args, kwargs, what)

        def kernel():
            return lm_kernel("flash_attention")(*args, **kwargs)

        def uncapped():
            return lm_kernel("flash_attention")(*args, **uncapped_kw)

        def plain():
            return lm_plain("flash_attention")(*args, **kwargs)
        out, out0 = kernel(), uncapped()
        moved = float((out.float() - out0.float()).abs().max()
                      / out.float().abs().max())
        del out, out0
        gate, timer, reps, plain_reps = LM_TOL[dtype], time_ms, 20, 2
        bound, by = lm_bound("flash_attention", args, kwargs)
        same = torch.equal(kernel(), kernel())
        library, compile_s = flex_library(args, kwargs, heads)
        lib_diff = float((library().reshape(shape).float()
                          - kernel().float()).abs().max())
    kind = "flash_attention backward" if backward else "flash_attention"
    check(moved >= 10 * gate, f"{kind} {what}: the capped and uncapped "
          f"kernels differ by {moved:.3e} >= 10 x the gate {gate:g}")
    check(same, f"{kind} {what}: two launches bitwise equal")
    row = {
        "name": name, "ok": True, "route": "cuda",
        "source": (BWD_SOURCES["flash_attention_f32" if dtype ==
                               torch.float32 else "flash_attention"]
                   if backward else SOURCES["flash_attention"]),
        "replaces": REPLACES["flash_attention"], "launches": launches,
        "launches_from": launches_from, "max_abs_err": err,
        "ms": timer(kernel, reps), "plain_ms": timer(plain, plain_reps),
        "bound_ms": bound, "bound_by": by,
        "library_ms": timer(library, 10 if timer is time_ms else 5),
        "library": "flex_attention, compiled",
        "uncapped_ms": timer(uncapped, reps),
        "softcap": float(kwargs["softcap"]), "cap_moved": moved,
        "shape": list(shape), "kv_shape": list(args[1].shape),
        "dtype": str(dtype)[6:], "window": int(kwargs["window"]),
    }
    if backward:
        row["pass"] = "backward"
    print(f"  {kind} {what}, k, v "
          f"{row['kv_shape']}, window {row['window']}: kernel "
          f"{row['ms']:.4f} ms, uncapped {row['uncapped_ms']:.4f} ms "
          f"(x{row['ms'] / row['uncapped_ms']:.2f}), plain "
          f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms "
          f"(flex_attention, compiled in {compile_s:.1f} s; max abs diff "
          f"from the kernel's {lib_diff:.3e}), bound {bound:.4f} ms ({by}), "
          f"share of the bound {bound / row['ms']:.3f}, {launches} launches "
          f"({launches_from or 'no capped call of this shape on a path'})")
    del library
    return row


def phase_softcap_calls() -> list:
    """Every capped kernel design on SOFTCAP_CALLS' shapes
    (:func:`softcap_row`), with the ptxas lines of the capped kernels.
    No path of this script runs a capped call at these shapes: their rows
    carry 0 launches and ``launches_from`` None (the full-width gemma-7b
    phase's rows carry its launches)."""
    print(f"== kernels: soft-capped flash_attention (cap {SOFTCAP_CALL:g}, "
          f"q and k drawn at {SOFTCAP_AMP:g}), every design, forward and "
          f"backward")
    for line in ptxas_report(
            r"((?:flash_bf16_persistent|flash_bf16|flash_f32|fa_bwd_[a-z]+"
            r"|fa32_bwd_[a-z]+)_kernelILi\d+ELb1E)"):
        print(f"  ptxas (capped): {line}")
    gen = torch.Generator(device=DEVICE).manual_seed(29)
    rows = []
    for name, label, (bh, bh_kv, s, s_kv, d), dtype, causal, window, bwd, \
            heads in SOFTCAP_CALLS:
        q = (torch.randn(bh, s, d, generator=gen, device=DEVICE)
             * SOFTCAP_AMP).to(dtype)
        k = (torch.randn(bh_kv, s_kv, d, generator=gen, device=DEVICE)
             * SOFTCAP_AMP).to(dtype)
        v = torch.randn(bh_kv, s_kv, d, generator=gen, device=DEVICE).to(
            dtype)
        kw = {"causal": causal, "window": window, "softcap": SOFTCAP_CALL}
        rows.append(softcap_row(name, label, (q, k, v), kw, 0, None, bwd,
                                heads))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


# The full-width soft-capped model: gemma-7b (d_model 3072, 16 heads of
# 256, 16 kv heads, d_ff 24576, vocab 256000, bf16) cut to SOFTCAP_LAYERS
# layers for the time budget, with Gemma 2's final-logits cap 30.0 and
# the first of SOFTCAP_MODEL_CAPS (Gemma 2's attention cap 50.0 first)
# under which its first layer's capped and uncapped attention outputs
# differ by at least 10 x LM_TOL; a prefill of SOFTCAP_PROMPTS prompts of
# SOFTCAP_PROMPT_LEN tokens, SOFTCAP_NEW greedy tokens, one training step
# of SOFTCAP_TRAIN (batch, seq).
SOFTCAP_LAYERS = 4
SOFTCAP_MODEL_CAPS = (50.0, 20.0, 10.0, 5.0, 2.0, 1.0, 0.5, 0.2, 0.1)
SOFTCAP_PROMPTS, SOFTCAP_PROMPT_LEN, SOFTCAP_NEW = 4, 4096, 8
SOFTCAP_TRAIN = (2, 4096)
# The prefill's gates: the block whose output is the trunk's, the
# control of bf16_control_gate (every attention output moved by up to
# one bf16 ulp), and the f32 copy's limits (Mamba-2's and OLMoE's).
SOFTCAP_PATH = {"block": "_attn_prefill_block", "fault": "flash_attention",
                "control_scale": 2.0 ** -8,
                "gates": LM_PATHS["olmoe-1b-7b"]["gates"]}


class _FirstCall(Exception):
    pass


def softcap_first_call(cfg, params, batch):
    """The arguments of the first flash_attention call of a prefill of
    ``batch`` (layer 0's q, k, v: the cap does not touch them); the
    prefill stops there."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import steps

    kept: dict = {}

    def wrap(fn):
        def run(*args, **kwargs):
            keep_first_call(kept, "first")(fn)(*args, **kwargs)
            raise _FirstCall
        return run
    with wrapped(ops, "flash_attention", wrap):
        try:
            steps.make_prefill_step(cfg, max_seq=batch["tokens"].shape[1])(
                params, batch)
        except _FirstCall:
            pass
    return kept["first"][0]


def phase_softcap_model(smi: str) -> list:
    """gemma-7b at full width, SOFTCAP_LAYERS layers, with the attention
    cap, through the port's entry points: ``serve_batch`` (a prefill of
    4 x 4096 tokens through the capped kernels, SOFTCAP_NEW greedy
    tokens); its prefill held to the plain route in bf16 within CONTROL_K
    of the one-ulp control (:func:`bf16_control_gate`) and, on an f32
    copy of the weights through the f32 capped kernel, at the f32 limits
    (last-position logits, the trunk's output less the embedding in
    Frobenius and at the worst position); every bf16 kernel call of a
    prefill against its plain version; each decode step's logits after
    the kernels' prefill against those after the plain route's on the
    same tokens (the logits gate); step 0's loss and global grad norm
    through the kernels against the plain route (TRAIN_LOSS_TOL,
    TRAIN_NORM_TOL) and one ``launch.train.train`` step, launch counts
    exact; then the capped rows at the first attention call of the
    prefill, of the f32 prefill and of the training step.  Returns those
    three rows."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    base = configs.get_config("gemma-7b").scaled(
        num_layers=SOFTCAP_LAYERS, logits_softcap=30.0)
    print(f"== softcap: gemma-7b full width, {SOFTCAP_LAYERS} of "
          f"{configs.get_config('gemma-7b').num_layers} layers (cut for the "
          f"time budget), d_model {base.d_model}, {base.num_heads} heads of "
          f"{base.head_dim}, {base.num_kv_heads} kv heads, d_ff "
          f"{base.d_ff}, vocab {base.vocab_size}, {base.dtype}, "
          f"logits_softcap 30 ({smi})")
    t0 = time.perf_counter()
    params = transformer.init_params(base, 0, device=DEVICE)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in _leaves(params))
    print(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s:"
          f" {n / 1e9:.3f} B parameters")
    prompts = draw_prompts(base, 0, (SOFTCAP_PROMPT_LEN,) * SOFTCAP_PROMPTS)
    batch = {"tokens": torch.as_tensor(np.stack(prompts), device=DEVICE)}

    # The cap: Gemma 2's 50.0 if it bites on these weights, else the
    # largest of SOFTCAP_MODEL_CAPS that does.
    args = softcap_first_call(base, params, batch)
    out0 = lm_kernel("flash_attention")(*args, causal=True, window=0)
    scale = float(out0.float().abs().max())
    cap, moves = None, []
    for c in SOFTCAP_MODEL_CAPS:
        out = lm_kernel("flash_attention")(*args, causal=True, window=0,
                                           softcap=c)
        moved = float((out.float() - out0.float()).abs().max()) / scale
        moves.append(f"{c:g}: {moved:.3e}")
        if moved >= 10 * LM_TOL[torch.bfloat16]:
            cap = c
            break
    x = (torch.einsum("bqd,bkd->bqk", args[0][:1].float(),
                      args[1][:1].float()) / float(np.sqrt(args[0].shape[2])))
    print(f"  layer 0's scaled scores (head 0): max |s| "
          f"{float(x.abs().max()):.3f}, median {float(x.abs().median()):.3f};"
          f" capped vs uncapped attention output, max abs over max abs, by "
          f"cap: {', '.join(moves)}")
    check(cap is not None, f"a cap of {SOFTCAP_MODEL_CAPS} bites on layer 0 "
          f"(>= 10 x {LM_TOL[torch.bfloat16]:g})")
    print(f"  attention cap {cap:g}"
          + (" (Gemma 2's)" if cap == 50.0 else
             " (Gemma 2's 50 does not bite on these random weights)"))
    del out0, out, x
    cfg = base.scaled(attn_softcap=cap)

    # serve_batch through the capped kernels.
    reqs = [serve.Request(rid=i, prompt=p, max_new=SOFTCAP_NEW)
            for i, p in enumerate(prompts)]
    kept: dict = {}
    ops.reset_counts()
    with wrapped(ops, "flash_attention", keep_first_call(kept, "prefill")):
        reqs, stats = serve.serve_batch(
            cfg, params, reqs, max_seq=SOFTCAP_PROMPT_LEN + SOFTCAP_NEW)
    torch.cuda.synchronize()
    served = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"  serve_batch: prefill {stats['prefill_s']:.4f} s, decode "
          f"{stats['decode_s'] / SOFTCAP_NEW * 1e3:.3f} ms/step; launches "
          f"{served}")
    check(served == {"flash_attention": cfg.num_layers},
          f"serve_batch: the prefill ran {cfg.num_layers} capped "
          f"flash_attention launches, decode none")
    toks = [r.out for r in reqs]
    check(all(len(t) == SOFTCAP_NEW and all(0 <= x < cfg.vocab_size
                                            for x in t) for t in toks),
          f"{SOFTCAP_NEW} tokens in the vocabulary per request")

    # The prefill against the plain route: in bf16 within CONTROL_K of the
    # one-ulp control (the fixed gates read these random layers'
    # amplified rounding: the trunk's Frobenius 2.4e-2 against 2e-2 in
    # this PR's second check), and on an f32 copy of the weights, through
    # the f32 capped kernel, at the f32 limits; every bf16 kernel call of
    # a prefill against its plain version.
    la, ha = prefill_trunk(cfg, params, batch, SOFTCAP_PATH["block"])
    check(bool(torch.isfinite(la).all()) and tuple(la.shape) == (
        SOFTCAP_PROMPTS, cfg.vocab_size), "prefill logits finite")
    bf16_control_gate(cfg, params, batch, SOFTCAP_PATH, la, ha,
                      tag=", capped")
    del la, ha
    gp = _cast(params, torch.float32)
    ops.reset_counts()
    with wrapped(ops, "flash_attention", keep_first_call(kept, "f32")):
        lf, hf = prefill_trunk(cfg, gp, batch, SOFTCAP_PATH["block"])
    f32_launches = ops.launch_counts()["flash_attention"]
    lc, hc = prefill_trunk(cfg, gp, batch, SOFTCAP_PATH["block"],
                           mode="plain")
    gates = SOFTCAP_PATH["gates"]
    rel = float((lf - lc).abs().max() / lc.abs().max())
    emb = transformer.trunk_input(cfg, gp, batch).float()
    frob, rows_ = trunk_diff("capped prefill, f32 copy, kernels vs plain",
                             hf.float() - emb, hc.float() - emb)
    check(rel <= gates["logits"] and frob <= gates["frob"]
          and rows_ <= gates["rows"], f"capped prefill, f32 copy "
          f"({f32_launches} f32 capped launches), kernels vs plain: logits "
          f"{rel:.3e} <= {gates['logits']:g}, trunk Frobenius {frob:.3e} <= "
          f"{gates['frob']:g}, worst position {rows_:.3e} <= "
          f"{gates['rows']:g}")
    del gp, lf, hf, lc, hc, emb
    torch.cuda.empty_cache()
    errs: dict = {}
    with wrapped(ops, "flash_attention", compare_calls(errs,
                                                       "flash_attention")):
        prefill_trunk(cfg, params, batch, SOFTCAP_PATH["block"])
    calls = errs["flash_attention"]
    check(max(r for _, r in calls) <= 1, f"each of the {len(calls)} capped "
          f"flash_attention calls of a prefill against its plain version: "
          f"max abs err {max(e for e, _ in calls):.3e}, worst over its "
          f"allowance {max(r for _, r in calls):.3e} <= 1")

    # Decode after each route's prefill on serve_batch's tokens; the
    # kernels' route's greedy tokens are serve_batch's.
    serve_step = steps.make_serve_step(cfg)
    fed = torch.as_tensor(toks, device=DEVICE)          # (B, SOFTCAP_NEW)
    logits = {}
    for mode in ("auto", "plain"):
        lg, cache = steps.make_prefill_step(
            cfg, max_seq=SOFTCAP_PROMPT_LEN + SOFTCAP_NEW, mode=mode)(
                params, batch)
        greedy = [torch.argmax(lg, -1)]
        out = []
        for i in range(SOFTCAP_NEW):
            lg, cache = serve_step(params, cache, fed[:, i:i + 1],
                                   SOFTCAP_PROMPT_LEN + i)
            out.append(lg[:, 0].float())
            greedy.append(torch.argmax(lg[:, 0], -1))
        logits[mode] = torch.stack(out)
        if mode == "auto":
            check(torch.equal(torch.stack(greedy[:SOFTCAP_NEW], 1), fed),
                  "the kernels' prefill and decode steps give serve_batch's "
                  "greedy tokens")
        del cache
    rel = float(((logits["auto"] - logits["plain"]).abs().amax(dim=(1, 2))
                 / logits["plain"].abs().amax(dim=(1, 2))).max())
    check(rel <= LM_PATHS["yi-6b"]["gates"]["logits"], f"{SOFTCAP_NEW} "
          f"decode steps after the capped prefill, kernels' cache vs plain "
          f"route's: worst step's logits {rel:.3e} <= "
          f"{LM_PATHS['yi-6b']['gates']['logits']:g}")
    del logits

    # One training step: step 0 kernels vs plain, then the trainer.
    B, S = SOFTCAP_TRAIN
    loader = pipeline.BalancedLoader(vocab_size=cfg.vocab_size, dp=2,
                                     batch_per_shard=B // 2, seq=S, seed=0)
    tb = train_mod.batch_on(DEVICE, *loader.next_batch())
    want = expected_train_launches(cfg)
    read = {}
    for mode in ("auto", "plain"):
        ops.reset_counts()
        with (wrapped(ops, "flash_attention", keep_first_call(kept, "train"))
              if mode == "auto" else contextlib.nullcontext()):
            loss, grads = steps.value_and_grad(
                steps.make_loss_fn(cfg, mode=mode), params, tb)
            norm = float(adamw.global_norm(grads))
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        read[mode] = (float(loss), norm)
        print(f"  step 0 {mode}: loss {float(loss):.6f}, grad norm "
              f"{norm:.6f}, launches {counts}")
        check(counts == (want if mode == "auto" else {}),
              f"step 0 {mode}: launches {counts} == "
              f"{want if mode == 'auto' else {}}")
        del loss, grads
    for p in adamw.leaves(params):
        p.requires_grad_(False)
    (lk, nk), (lp, np_) = read["auto"], read["plain"]
    check(abs(lk - lp) <= TRAIN_LOSS_TOL * abs(lp)
          and abs(nk - np_) <= TRAIN_NORM_TOL * np_,
          f"capped step 0, kernels vs plain: loss {abs(lk - lp) / abs(lp):.3e}"
          f" <= {TRAIN_LOSS_TOL:g}, grad norm {abs(nk - np_) / np_:.3e} <= "
          f"{TRAIN_NORM_TOL:g}")
    ops.reset_counts()
    t0 = time.perf_counter()
    params, opt, losses = train_mod.train(
        cfg, steps=1, seq=S, global_batch=B, dp=2, ckpt_dir=None, seed=0,
        log_every=1, device=DEVICE, init_params=params)
    torch.cuda.synchronize()
    trained = {k: v for k, v in ops.launch_counts().items() if v}
    check(trained == want and all(np.isfinite(losses)),
          f"train: one capped step through launch.train.train, launches "
          f"{trained} == {want}, loss {losses} finite "
          f"({time.perf_counter() - t0:.2f} s)")
    del params, opt
    torch.cuda.empty_cache()

    label = f"gemma-7b ({SOFTCAP_LAYERS} layers)"
    rows = []
    for key, name, what, launches, source, bwd in (
            ("prefill", "flash_attention_softcap_gemma_7b_prefill",
             "prefill", served["flash_attention"],
             "softcap gemma-7b serve_batch", False),
            ("f32", "flash_attention_f32_softcap_gemma_7b_prefill",
             "prefill, f32 copy", f32_launches,
             "softcap gemma-7b f32 prefill", False),
            ("train", "flash_attention_bwd_softcap_gemma_7b_train",
             "training", trained["flash_attention_bwd"],
             "softcap gemma-7b train step", True)):
        args, kw = kept.pop(key)
        kw = {k: v for k, v in kw.items() if k != "mode"}
        rows.append(softcap_row(name, f"{label} {what}", args, kw, launches,
                                source, bwd, cfg.num_heads))
        del args
        torch.cuda.empty_cache()
    return rows


# The port's examples on the card at their CI flags, in this process.
EXAMPLE_RUNS = (("quickstart_torch", []), ("serve_lm_torch", []),
                ("train_lm_torch", ["--tiny", "--steps", "30"]),
                ("dydd_assimilation_torch",
                 ["--n", "96", "--m", "200", "--cycles", "4",
                  "--scenarios", "drifting_swarm"]))


def phase_examples() -> None:
    """Each ``examples/*_torch.py`` ``main`` in-process on the card (no
    ``--device``: the card is their default) at its CI flags; the
    quickstart's error, every request finishing, the loss falling (the
    examples check these themselves and raise) and each one's wall."""
    import importlib.util
    import tempfile

    print("== examples: the port's four, on the card")
    for name, argv in EXAMPLE_RUNS:
        spec = importlib.util.spec_from_file_location(
            f"_example_{name}", os.path.join(HERE, "examples", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        with tempfile.TemporaryDirectory() as tmp:
            extra = ["--ckpt-dir", tmp] if name == "train_lm_torch" else []
            t0 = time.perf_counter()
            module.main(argv + extra)
            torch.cuda.synchronize()
        print(f"  ok: examples/{name}.py {' '.join(argv)} ran in "
              f"{time.perf_counter() - t0:.1f} s")


# flash_attention at head dimensions the kernels read zero-padded (BH,
# BH_kv, S, D, causal, window): gemma3-1b's smoke 12 (to 16) at its window
# and MQA, 20 (to 24; 32 in the bf16 backward), and 40, which the forward
# reads as it is and the bf16 backward pads to 48.
PADDED_ATTN = ((4, 1, 77, 12, True, 16), (8, 2, 300, 12, True, 0),
               (3, 3, 64, 20, False, 0), (6, 2, 200, 40, True, 64))


def phase_padded_head_dim() -> None:
    """flash_attention forward and backward at PADDED_ATTN's head
    dimensions in f32 and bf16, against the plain version at the true
    D's scale (:func:`lm_compare`, :func:`bwd_compare`)."""
    from repro_torch.kernels import flash_attention
    print("== kernels: flash_attention at head dimensions off a multiple of "
          "8 (16 in the bf16 backward), zero-padded in the wrapper")
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        for bh, bh_kv, s, d, causal, window in PADDED_ATTN:
            qkv = tuple(torch.randn(r, s, d, generator=gen, device=DEVICE)
                        .to(dtype) for r in (bh, bh_kv, bh_kv))
            kw = {"causal": causal, "window": window}
            pads = (flash_attention.launch_plan(qkv[0].shape, qkv[1].shape,
                                                qkv[2].shape, dtype)["d_pad"],
                    flash_attention.bwd_plan(qkv[0].shape, qkv[1].shape,
                                             dtype)["d_pad"])
            label = (f"({bh}, {bh_kv}, {s}, {d}) padded to {pads[0]} "
                     f"(backward {pads[1]}) causal={causal} window={window}")
            lm_compare("flash_attention", qkv, kw, label)
            bwd_compare("flash_attention", qkv, kw, gen, label)


# Ragged rglru_scan forward cases (B, S, W) that reach both paths: S = 1,
# S off the 64-step box, W = 1, 33, 70 (direct) and 100, 36 (TMA in f32,
# W off the 32-channel box), bf16 at W % 8 = 4 (direct) and W % 8 = 0
# (TMA), B = 1 and B = 3.
RGLRU_RAGGED = {
    torch.float32: ((1, 1, 4096), (3, 77, 100), (2, 1, 33), (1, 33, 1),
                    (2, 1000, 70), (3, 130, 36)),
    torch.bfloat16: ((3, 77, 100), (2, 65, 8), (1, 200, 1000), (2, 1, 33),
                     (1, 33, 1))}


def rglru_compare(ab, label) -> float:
    """rglru_scan against its plain version (:func:`lm_compare`), two
    launches bitwise equal, and the path the wrapper chose bitwise equal
    to the direct path; prints the path."""
    from repro_torch.kernels import rglru_scan
    err = lm_compare("rglru_scan", ab, {}, label)
    h = rglru_scan.rglru_scan(*ab)
    path = rglru_scan.last_path
    check(torch.equal(h, rglru_scan.rglru_scan(*ab))
          and torch.equal(h, rglru_scan.rglru_scan(*ab, direct=True)),
          f"rglru_scan {label} {str(ab[0].dtype)[6:]}: {path} path, two "
          f"launches and the direct path bitwise equal")
    return err


def rglru_paths(args, label) -> dict:
    """The rglru_scan forward at ``args``: the path its wrapper chooses,
    bitwise equal to the direct path (the first design, kept for the shapes
    TMA does not take), each path's time (median of 7 between CUDA events;
    the direct path also as the mean of back-to-back calls)."""
    from repro_torch.kernels import rglru_scan
    h = rglru_scan.rglru_scan(*args)
    path = rglru_scan.last_path
    check(torch.equal(h, rglru_scan.rglru_scan(*args, direct=True)),
          f"rglru_scan {label}: the {path} path and the direct path bitwise "
          f"equal")
    del h
    direct = lambda: rglru_scan.rglru_scan(*args, direct=True)
    return {"path": path,
            "ms_median": median_ms(lambda: rglru_scan.rglru_scan(*args), 7),
            "direct_ms": time_ms(direct, 20),
            "direct_ms_median": median_ms(direct, 7)}


# Ragged ssd_scan cases (BH, B/C rows, S, P, N, chunk): rep 1; odd BH with
# a part-filled P tile, N 64 and a chunk off the 64-row sub-tiles; P 32
# with rep 4; S below the chunk; the smoke config's scan; an odd P and an
# odd chunk, which take the kernel's single-float loads.
SSD_RAGGED = ((6, 6, 1024, 64, 128, 256), (5, 5, 300, 48, 64, 100),
              (8, 2, 512, 32, 64, 128), (3, 1, 200, 64, 128, 256),
              (2, 2, 40, 16, 16, 8), (3, 3, 65, 7, 8, 5))


def ssd_random(bh, groups, s, p, n, gen):
    """Random ssd_scan inputs whose decays keep the state alive across
    chunks (dt in [0.001, 0.1], A in [-2, -0.5], as tests/test_kernels.py
    draws them)."""
    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=DEVICE)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    return (randn(bh, s, p), rand(bh, s) * 0.099 + 0.001,
            -(rand(bh) * 1.5 + 0.5), randn(groups, s, n), randn(groups, s, n))


def ssd_compare(args, chunk: int, label: str) -> float:
    """Kernel vs plain version on ``args``, in y and the final state."""
    from repro_torch.kernels import ref, ssd_scan

    out_k = ssd_scan.ssd_scan(*args, chunk=chunk)
    out_p = ref.ssd_scan_plain(*args, chunk=chunk, state=True)
    torch.cuda.synchronize()
    err, ratio = agreement("ssd_scan", out_k, out_p)
    ok = all(k.shape == q.shape and bool(torch.isfinite(k).all())
             for k, q in zip(out_k, out_p))
    check(ok and ratio <= 1, f"ssd_scan {label}: y and final state max abs "
          f"err {err:.3e}, worst error over ({SSD_ATOL:g} + {SSD_RTOL:g} "
          f"|plain|) {ratio:.3e} <= 1")
    return err


def ssd_bound(args, chunk: int):
    """The least time of one ssd_scan: (bound_ms, bound_by, ops) with
    ops the operations' times (ms) of the function's flops
    (``repro_torch.kernels.cost.ssd_scan``) at the TF32 tensor-core peak
    (495 TFLOP/s; the bound's side), of the kernel's own arithmetic, each
    product as three TF32 products, and of exact f32 FMA (67 TFLOP/s)."""
    from repro_torch.kernels import cost
    x, _, _, B, _ = args
    work = cost.ssd_scan(x.shape, B.shape, chunk)
    t_ops = work.flops / cost.PEAK_TF32 * 1e3
    ops = {"tf32": t_ops, "3xtf32": 3 * t_ops,
           "fma": work.flops / cost.PEAK_FLOPS[torch.float32] * 1e3}
    return (*work.bound(), ops)


def launch_times(fn, pattern: str, calls: int = 3) -> list:
    """(name, ms) of each CUDA launch of ``fn`` whose kernel matches the
    regex ``pattern`` (its first group is the name): device time a call,
    the mean over the launches of ``calls`` profiled calls.  The profiler
    has dropped the kernel records (keeping only the runtime's launch
    calls) of the f32 attention backward in most runs of the whole
    script, with 57 of 85 GB of device memory free, and not in runs of
    its kernels alone (PERF.md §7; the cause is not known), so that
    kernel's launches are timed by ``attention_launch_times``
    instead.  It takes a CUDA-only session whose schedule skips a call
    and warms up on another and, where that matched nothing, one of CPU
    and CUDA activities after a warm-up call, as a training step's
    profile runs; where neither did, it prints what the profiler
    recorded."""
    import re

    from torch.profiler import ProfilerActivity, profile, schedule

    def matched(prof):
        out = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            m = re.search(pattern, e.key)
            if m and us and e.count:
                out.append((m.group(1), us / 1e3 / e.count))
        return out, [e.key[:60] for e in prof.key_averages()][:4]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=calls)) as prof:
        for _ in range(calls + 2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    out, seen = matched(prof)
    if out:
        return out
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out, seen2 = matched(prof)
    if not out:
        print(f"  launch_times: no kernel matched {pattern!r}; the profiler "
              f"recorded {seen} and then {seen2}")
    return out


def print_ssd_launches(args, chunk: int) -> None:
    """Device time of each of the five CUDA launches of one ssd_scan call
    (:func:`launch_times` over three profiled calls)."""
    from repro_torch.kernels import ssd_scan

    parts = launch_times(lambda: ssd_scan.ssd_scan(*args, chunk=chunk),
                         r"ssd_([a-z]+)_kernel")
    print("  ssd_scan launches, device time a call: "
          + ", ".join(f"{k} {ms:.4f} ms" for k, ms in parts))


def ptxas_report(pattern: str) -> list:
    """The ``-Xptxas -v`` lines of this run's build for every kernel whose
    mangled name matches the regex ``pattern`` (its first group is the
    name): "name: R registers, S bytes spill stores, static shared memory
    M bytes"."""
    import re

    from repro_torch.kernels import _build

    out, name = [], None
    for log in _build.BUILD_LOG:
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                k = re.search(pattern, m.group(1))
                name = k.group(1) if k else None
                spill = None
                continue
            if name is None:
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = m.group(1)
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                          line)
            if m:
                out.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                           f"spill stores, static shared memory "
                           f"{m.group(2) or 0} bytes")
                name = None
    return out


def phase_ssd_kernels(first_call, layer_err: float, counts: dict) -> dict:
    """ssd_scan vs its plain version, in y and the final state: on the
    Mamba-2 prefill's first-layer inputs (``first_call``, the op's
    arguments in run (a)), on random inputs at the same shapes whose
    state stays alive, and at ragged shapes; two launches bitwise equal;
    then the timings at the prefill's shape.  The JSON max_abs_err is
    the largest of the first two and of every layer of run (d),
    ``layer_err``."""
    from repro_torch.kernels import ref, ssd_scan

    print("== kernels: ssd_scan")
    args, kwargs = first_call
    chunk = kwargs["chunk"]
    x, _, _, B, _ = args
    shapes = f"x {tuple(x.shape)}, B/C {tuple(B.shape)}, chunk {chunk}"
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    err = max(layer_err, ssd_compare(args, chunk, f"prefill input {shapes}"),
              ssd_compare(ssd_random(x.shape[0], B.shape[0], x.shape[1],
                                     x.shape[2], B.shape[2], gen),
                          chunk, f"random {shapes}"))
    for bh, groups, s, p, n, c in SSD_RAGGED:
        ssd_compare(ssd_random(bh, groups, s, p, n, gen), c,
                    f"ragged x {(bh, s, p)}, B/C {(groups, s, n)}, "
                    f"chunk {c}")
    y1, f1 = ssd_scan.ssd_scan(*args, chunk=chunk)
    y2, f2 = ssd_scan.ssd_scan(*args, chunk=chunk)
    check(torch.equal(y1, y2) and torch.equal(f1, f2),
          "ssd_scan: two launches bitwise equal")
    bound, by, ops = ssd_bound(args, chunk)
    row = {
        "name": "ssd_scan", "ok": True, "route": "cuda",
        "source": SOURCES["ssd_scan"], "replaces": REPLACES["ssd_scan"],
        "launches": counts["ssd_scan"], "max_abs_err": err,
        "ms": time_ms(lambda: ssd_scan.ssd_scan(*args, chunk=chunk), 10),
        "plain_ms": time_ms(lambda: ref.ssd_scan_plain(
            *args, chunk=chunk, state=True), 2),
        "bound_ms": bound, "bound_by": by,
        "library_ms": None, "shape": list(x.shape), "dtype": "float32",
    }
    print_ssd_launches(args, chunk)
    print(f"  ssd_scan {shapes}: kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, library none, bound {bound:.4f} ms "
          f"({by}; the function's flops at the TF32 peak "
          f"{ops['tf32']:.4f} ms), share of the bound "
          f"{bound / row['ms']:.3f}; operations alone: 3xTF32 as the "
          f"kernel does them {ops['3xtf32']:.4f} ms, exact f32 FMA "
          f"{ops['fma']:.4f} ms")
    return row


# ---------------------------------------------------------------------------
# Training (``train`` and ``train_kernels``).
# ---------------------------------------------------------------------------

# The training runs, by name: Mamba-2 1.3B at full size; RecurrentGemma-9B
# at full width with its depth cut to 18 layers, six (R, R, A) periods: at
# 12 bytes a parameter (bf16 params and grads, f32 m and v) its 38 layers
# need ~102 GB, more than the card's 80 GB; 18 layers (4.60 B parameters)
# need ~55 GB and leave room for the block-remat activations at batch 2 x
# seq 4096.  Both from one BalancedLoader batch (dp shards of one row),
# bf16 params, AdamW (lr 3e-4, f32 moments), remat "block", loss_chunk
# 512.  Step 0 is held kernels against plain routes on the same batch in
# ``gate_dtype``: Mamba-2 on an f32 copy of its weights, as its serving
# gates are (``LM_PATHS``), since its 48 random bf16 layers amplify
# rounding flips past any fixed gate; RecurrentGemma-9B in bf16.  Then
# RecurrentGemma-9B in f32, the dtype of its smoke config and the
# reference's, through the f32 flash_attention backward: full width, the
# depth cut to one (R, R, A) period, 3 layers: ~1.05 B of embedding and
# 3 x ~0.197 B of layers, ~1.64 B parameters at 16 bytes each (f32
# params, grads, m and v) are ~26 GB before activations.  It ran two
# periods until whisper's and phi-3-vision's runs joined the script; one
# period keeps the f32 attention backward's path and shape and takes
# ~20 s off the whole run.
# OLMoE-1B-7B at full width, 10 of its 16 layers (~4.40 B parameters,
# ~53 GB of bf16 weights and grads and f32 moments; 16 layers would need
# ~83 GB before activations), step 0 on an f32 copy as Mamba-2's; it runs
# first: alone on the card 8 layers peaked at 47.01 GB and 12 at 67.64
# GB, but after the other runs step 0's f32 backward ran out of memory at
# 12 layers and at 10, 13.8 GB of the cache left in fragments (NVIDIA
# H100 80GB HBM3, 700.00 W).  ``keep``: the kernel ops whose first call's
# arguments the train_kernels phase reads, stored under the op's name
# plus ``suffix``, as the run's launch counts are.
# Whisper's repeated-batch steps, over which the loss must fall, run on an
# f32 copy at lr 1e-7.  At the trainer's lr 3e-4 in bf16 its loss rose
# (142.60, 142.66, 148.47, 152.23; measured on one H100): Adam's
# first steps move each element by about lr in its gradient's sign, and
# with the tied output table at scale 1 (logits ~36 sigma, loss ~145,
# grad norm ~1962 over 1.59 B parameters) such a step is far past the
# linear regime of the random 64-layer model; in bf16 a smaller step is
# lost to rounding (an element of the table at 1 has an ulp of 2^-7).
# Those bf16 steps still run, through the kernels and through the plain
# route, and the kernels' losses are held to the plain route's.
WHISPER_REPEAT = {"dtype": torch.float32, "lr": 1e-7}
TRAIN_RUNS = {
    "olmoe-1b-7b": {"arch": "olmoe-1b-7b", "layers": 10, "dtype": None,
                    "batch": 4, "seq": 2048, "dp": 4,
                    "gate_dtype": torch.float32, "suffix": "_olmoe",
                    "keep": ("flash_attention",)},
    "phi3-vision-4.2b": {"arch": "phi3-vision-4.2b", "layers": None,
                         "dtype": None, "batch": 2, "seq": 2048, "dp": 2,
                         "gate_dtype": torch.bfloat16, "suffix": "_phi3",
                         "keep": ()},
    "recurrentgemma-9b": {"arch": "recurrentgemma-9b", "layers": 18,
                          "dtype": None, "batch": 2, "seq": 4096, "dp": 2,
                          "gate_dtype": torch.bfloat16, "suffix": "",
                          "keep": ("flash_attention", "rglru_scan")},
    "mamba2-1.3b": {"arch": "mamba2-1.3b", "layers": None, "dtype": None,
                    "batch": 4, "seq": 2048, "dp": 4,
                    "gate_dtype": torch.float32, "suffix": "",
                    "keep": ("ssd_scan",)},
    "recurrentgemma-9b-f32": {"arch": "recurrentgemma-9b", "layers": 3,
                              "dtype": "float32", "batch": 2, "seq": 4096,
                              "dp": 2, "gate_dtype": torch.float32,
                              "suffix": "_f32", "keep": ("flash_attention",)},
    # The encoder-decoder and the vision stub at full size, on batches
    # that hold frames (B, 1500, 1280) or patches (B, 144, 3072) drawn as
    # served (draw_extras), which the trainer takes as ``extras``.
    # Whisper's step 0 on an f32 copy (6.4 GB); the first attention call
    # of each kind of its trainer's run (``keep_kinds``) gets a bf16
    # backward row, and of its f32 repeated steps the f32 cross rows.
    # Phi-3-vision's step 0 in bf16, as RecurrentGemma's: an f32 copy
    # (+30.6 GB) would not fit beside its ~46 GB of bf16 training state.
    "whisper-large-v3": {"arch": "whisper-large-v3", "layers": None,
                         "dtype": None, "batch": 4, "seq": 448, "dp": 4,
                         "gate_dtype": torch.float32, "suffix": "_whisper",
                         "keep": (), "keep_kinds": True,
                         "repeat": WHISPER_REPEAT},
}
TRAIN_STEPS = 4
TRAIN_LOSS_TOL = 1e-3   # step 0, kernels vs plain: loss, relative
TRAIN_NORM_TOL = 2e-2   # step 0, kernels vs plain: global grad norm
# The control of a run whose loss-falls check moved off its own dtype
# (whisper): its bf16 repeated steps through the plain route with every
# attention output multiplied element by element by 1 + 2^-8 u, u uniform
# on [-1, 1] (a seeded draw for each call): up to one bf16 ulp either way,
# as a kernel's rounding moves it, in the forward and, through the chain
# rule, in the gradient each call passes back.  The kernels' losses must
# stay within CONTROL_K times the control's distance from the plain
# route's.  Its 64 random bf16 layers move the loss by 1.03e-3 kernels vs
# plain at step 0 alone (the same weights), past TRAIN_LOSS_TOL; every
# output scaled by 1 + 2^-8 instead (OLMoE's serving control) moved it by
# at most 8.9e-4 over the 4 steps against the kernels' 5.5e-3 at step 3,
# since a gradient scaled by a constant leaves Adam's step as it was
# (measured on one H100).
TRAIN_CONTROL_JITTER = 2.0 ** -8
# The backward kernels against autograd through the plain versions: each
# gradient's Frobenius difference over its norm (f32: as the forward's
# REL_TOL; bf16: as LM_TOL).  flash_attention at the training shape also
# row by row, within ATTN_ROW_TOL as its forward: the worst row's
# difference norm over its norm, the row norms floored at GRAD_ROW_FLOOR
# times their median.  dK and dV are held so against autograd; dQ
# against ref.attention_bwd_plain fed the kernel's own bf16 out and lse,
# because autograd's Delta = rowsum(dO .* O) reads the f32 output: dQ's
# row i is sum_j dS_ij k_j with dS = P .* (dP - Delta), which cancels
# where a row's softmax sits on one key, and there the bf16 rounding of
# O alone moved the first training layer's worst dQ row to 0.25 against
# autograd (NVIDIA H100 80GB HBM3, 700.00 W).  The forward outputs each
# backward reads are held to the forward's gates (forward_agrees).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GRAD_ROW_FLOOR = 1e-2


def expected_train_launches(cfg) -> dict:
    """Kernel launches of one training step: each layer's forward kernel
    once in the forward and once more in the backward's recompute under
    remat, its backward kernel once."""
    mult = 2 if cfg.remat in ("block", "group") else 1
    if cfg.is_encoder_decoder:      # encoder, decoder self and cross
        attn = cfg.encoder_layers + 2 * cfg.num_layers
        return {"flash_attention": mult * attn, "flash_attention_bwd": attn}
    if cfg.attn_pattern == ("ssd",):
        return {"ssd_scan": mult * cfg.num_layers,
                "ssd_scan_bwd": cfg.num_layers}
    if "rglru" not in cfg.attn_pattern:     # uniform: every layer attention
        return {"flash_attention": mult * cfg.num_layers,
                "flash_attention_bwd": cfg.num_layers}
    period = len(cfg.attn_pattern)
    attn = cfg.num_layers // period
    rec = cfg.num_layers - attn
    return {"rglru_scan": mult * rec, "rglru_scan_bwd": rec,
            "flash_attention": mult * attn, "flash_attention_bwd": attn}


def phase_train(run: str, smi: str, kept: dict,
                peaks: dict | None = None) -> dict:
    """Train ``TRAIN_RUNS[run]`` through the port's entry points:
    step 0's loss and global grad norm through the kernels against the
    plain route on the loader's first batch; the trainer
    (``launch.train.train``) for TRAIN_STEPS steps, with its kernel
    launches exactly as the code implies, the step time p50, peak memory
    and tokens a second; then TRAIN_STEPS AdamW steps on that first batch
    repeated, over which the loss must fall, and one more under
    ``torch.profiler``.  Where the run's ``repeat`` moves the loss-falls
    check to another dtype or lr, the repeated steps first run at the
    run's own through the kernels, through the plain route and through
    the plain route under a control (TRAIN_CONTROL_JITTER), and the
    kernels' losses must stay within CONTROL_K times the control's
    distance from the plain route's.  Whisper's and phi-3-vision's
    batches also hold frames or patches (:func:`draw_extras`, given to
    the trainer as ``extras``).  The first call of each kernel op of the run's ``keep``
    lands in ``kept`` (the train_kernels phase's inputs) under its name
    and the run's ``suffix``; with ``keep_kinds``, the first attention
    call of each kind (:func:`attention_kind`) of the trainer's run under
    ``flash_attention`` plus the suffix, ``:`` and the kind, and of the
    repeated steps in ``repeat``'s dtype under ``flash_attention_f32``
    plus the same.  Returns the kernels' launches a step of the trainer's
    run (its counts over TRAIN_STEPS), each under its name and the
    suffix, and those of each kind of attention call, forward and
    backward, under ``:`` and the kind (of the repeated steps in f32
    under the f32 rows' names).  The trainer's peak memory lands in
    ``peaks`` under the run's name (:func:`keep_peak`)."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    spec = TRAIN_RUNS[run]
    arch = spec["arch"]
    cfg = configs.get_config(arch)
    if spec["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    if spec["dtype"]:
        cfg = dataclasses.replace(cfg, dtype=spec["dtype"])
    B, S = spec["batch"], spec["seq"]
    print(f"== train: {arch}, {cfg.num_layers} layers, {cfg.dtype}, d_model "
          f"{cfg.d_model}, batch {B} x seq {S}, remat {cfg.remat}, "
          f"loss_chunk {cfg.loss_chunk} ({smi})")
    params = transformer.init_params(cfg, seed=0, device=DEVICE)
    n_params = sum(p.numel() for p in adamw.leaves(params))
    loader = pipeline.BalancedLoader(
        vocab_size=cfg.vocab_size, dp=spec["dp"],
        batch_per_shard=B // spec["dp"], seq=S, seed=0)
    extras = draw_extras(cfg, B, 0)
    batch = {**train_mod.batch_on(DEVICE, *loader.next_batch()), **extras}
    st = loader.last_stats
    print(f"  {n_params / 1e9:.3f} B parameters; loader dp {spec['dp']}: "
          f"loads {st.loads_before.tolist()} -> {st.loads_after.tolist()}"
          f", E {st.efficiency_before:.3f} -> {st.efficiency_after:.3f}, "
          f"{st.docs_moved} documents moved, "
          f"{int(batch['mask'].sum())} target tokens"
          + "".join(f", {k} {tuple(v.shape)}" for k, v in extras.items()))
    want = expected_train_launches(cfg)
    if cfg.num_heads:
        kept.setdefault("heads", cfg.num_heads)
    suffix = spec["suffix"]

    # Step 0: loss and global grad norm, kernels against plain.
    gate = (params if spec["gate_dtype"] == torch.bfloat16
            else _cast(params, spec["gate_dtype"]))
    read = {}
    for mode in ("auto", "plain"):
        ops.reset_counts()
        with contextlib.ExitStack() as stack:
            if mode == "auto":
                for name in spec["keep"]:
                    stack.enter_context(wrapped(
                        ops, name, keep_first_call(kept, name + suffix)))
            t0 = time.perf_counter()
            loss, grads = steps.value_and_grad(
                steps.make_loss_fn(cfg, mode=mode), gate, batch)
            norm = float(adamw.global_norm(grads))
            wall = time.perf_counter() - t0
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        read[mode] = (float(loss), norm)
        print(f"  step 0 {mode:5s} ({str(spec['gate_dtype'])[6:]}): loss "
              f"{float(loss):.6f}, global grad norm {norm:.6f}, "
              f"{wall:.2f} s, launches {counts}")
        check(counts == (want if mode == "auto" else {}),
              f"step 0 {mode}: kernel launches {counts} == "
              f"{want if mode == 'auto' else {}}")
        del grads, loss
    for p in adamw.leaves(gate):
        p.requires_grad_(False)
    del gate
    torch.cuda.empty_cache()
    (lk, nk), (lp, np_) = read["auto"], read["plain"]
    check(abs(lk - lp) <= TRAIN_LOSS_TOL * abs(lp),
          f"step 0 loss, kernels vs plain: {abs(lk - lp) / abs(lp):.3e} "
          f"<= {TRAIN_LOSS_TOL:g} relative")
    check(abs(nk - np_) <= TRAIN_NORM_TOL * np_,
          f"step 0 global grad norm, kernels vs plain: "
          f"{abs(nk - np_) / np_:.3e} <= {TRAIN_NORM_TOL:g} relative")

    # The main path: the trainer (launch.train.train) for TRAIN_STEPS
    # steps of the loader's batches on the cosine schedule, each step
    # timed to a synchronised end.
    times = []

    def timed(make):
        def make_timed(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(*a):
                t0 = time.perf_counter()
                out = step(*a)
                float(out[0])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                return out
            return run
        return make_timed

    ops.reset_counts()
    # what the card holds besides the params the trainer takes
    other = torch.cuda.memory_allocated() - sum(
        p.numel() * p.element_size() for p in adamw.leaves(params))
    torch.cuda.reset_peak_memory_stats()
    # the main path's attention calls of each kind, forward and backward
    kinds: dict = {}
    with wrapped(train_mod.steps_mod, "make_train_step", timed), \
            attention_kinds(kept if spec.get("keep_kinds") else {}, kinds,
                            "flash_attention" + suffix):
        params, opt, losses = train_mod.train(
            cfg, steps=TRAIN_STEPS, seq=S, global_batch=B, dp=spec["dp"],
            ckpt_dir=None, seed=0, log_every=1, device=DEVICE,
            init_params=params, extras=extras or None)
    main_counts = {k: v for k, v in ops.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if peaks is not None:
        keep_peak(peaks, run, arch, "train", B, S, other,
                  layers=spec["layers"], dtype=spec["dtype"])
    p50 = float(np.median(times))
    total = {k: TRAIN_STEPS * v for k, v in want.items()}
    check(main_counts == total, f"train: kernel launches over "
          f"{TRAIN_STEPS} steps {main_counts} == {total} (each step: "
          f"every layer's forward "
          f"kernel twice, remat recomputing it, its backward kernel once)")
    check(all(np.isfinite(losses)), f"train: losses "
          f"{[round(x, 6) for x in losses]} finite")
    positions = B * (S + (cfg.num_patches if "patches" in batch else 0))
    print(f"  {run} train ({smi}): step p50 {p50:.4f} s (steps "
          f"{[round(t, 4) for t in times]} s), {B * S / p50:.1f} tokens/s"
          + (f" ({positions / p50:.1f} positions/s with the patches)"
             if positions != B * S else "")
          + f", peak memory {peak:.2f} GB, launches a step {want}")
    per_kind = kind_launches(kinds, main_counts, suffix, "")

    # TRAIN_STEPS more steps on one repeated batch: the loss must fall
    # (at the run's ``repeat`` dtype and lr where it names them, after the
    # run's own dtype and lr through the kernels and the plain route).
    del opt
    torch.cuda.empty_cache()
    repeat = spec.get("repeat", {})
    if repeat:
        series = {}
        for label, mode, jitter in (("kernels", "auto", 0.0),
                                    ("plain", "plain", 0.0),
                                    ("control", "plain",
                                     TRAIN_CONTROL_JITTER)):
            rp = adamw.tree_map(lambda p: p.detach().clone(), params)
            with (wrapped(ops, "flash_attention", jitter_output(jitter))
                  if jitter else contextlib.nullcontext()):
                series[label] = repeat_steps(
                    cfg, rp, batch, mode, want if mode == "auto" else {})
            for p in adamw.leaves(rp):
                p.requires_grad_(False)
            del rp
            torch.cuda.empty_cache()
        ra, rc, rs = series["kernels"], series["plain"], series["control"]
        rel = [abs(a - c) / abs(c) for a, c in zip(ra, rc)]
        ctl = [abs(a - c) / abs(c) for a, c in zip(rs, rc)]
        print(f"  repeated batch, {cfg.dtype}, lr "
              f"{adamw.AdamWConfig().lr:g}: kernels "
              f"{[round(x, 6) for x in ra]}, plain "
              f"{[round(x, 6) for x in rc]}, control (plain, every "
              f"attention output times 1 + {TRAIN_CONTROL_JITTER:.3g} u) "
              f"{[round(x, 6) for x in rs]}; relative to plain: kernels "
              f"{['%.3e' % r for r in rel]}, control "
              f"{['%.3e' % r for r in ctl]}")
        check(all(np.isfinite(ra + rc + rs))
              and max(rel) <= CONTROL_K * max(ctl),
              f"repeated batch, {cfg.dtype}: the kernels' losses within "
              f"{CONTROL_K}x the control of the plain route's, worst step "
              f"{max(rel):.3e} <= {CONTROL_K * max(ctl):.3e}; the loss falls"
              f" through the kernels {ra[-1] < ra[0]}, through the plain "
              f"route {rc[-1] < rc[0]}")
    rp = _cast(params, repeat["dtype"]) if "dtype" in repeat else params
    f32_kinds: dict = {}
    with attention_kinds(kept if spec.get("keep_kinds") else {}, f32_kinds,
                         "flash_attention_f32" + suffix):
        losses = repeat_steps(cfg, rp, batch, "auto", want,
                              lr=repeat.get("lr"))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the loss falls over {TRAIN_STEPS} steps on one batch"
          + "".join(f", {k} {v}" for k, v in repeat.items())
          + f": {[round(x, 6) for x in losses]}")
    if "dtype" in repeat:      # the profile steps the run's own dtype
        for p in adamw.leaves(rp):
            p.requires_grad_(False)
        del rp
        torch.cuda.empty_cache()
        if repeat["dtype"] == torch.float32:
            per_kind.update(kind_launches(
                f32_kinds, {k: TRAIN_STEPS * v for k, v in want.items()},
                suffix, "_f32"))
    else:
        params = rp

    # One more step under torch.profiler: where a step's device time goes.
    from torch.profiler import ProfilerActivity, profile
    step_fn = steps.make_train_step(cfg, adamw.AdamWConfig())
    opt = adamw.adamw_init(params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"  profile of one {run} training step:")
    device_report(prof, wall_ms, 15)
    for p in adamw.leaves(params):
        p.requires_grad_(False)
    del params, opt, batch
    torch.cuda.empty_cache()
    return {**{k + suffix: v // TRAIN_STEPS for k, v in main_counts.items()},
            **per_kind}


def repeat_steps(cfg, params, batch, mode: str, want: dict,
                 lr: float | None = None) -> list:
    """TRAIN_STEPS AdamW steps (``lr``, by default AdamWConfig's) on
    ``batch`` from ``params`` (updated in place) through ``mode``'s route,
    each step's kernel launches ``want``; returns the losses."""
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    step_fn = steps.make_train_step(
        cfg, adamw.AdamWConfig(**({} if lr is None else {"lr": lr})),
        mode=mode)
    opt = adamw.adamw_init(params)
    losses = []
    for i in range(TRAIN_STEPS):
        ops.reset_counts()
        loss, params, opt = step_fn(params, opt, batch)
        losses.append(float(loss))
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        check(counts == want, f"repeated batch, {mode}, step {i}: kernel "
              f"launches {counts} == {want}")
    return losses


@contextlib.contextmanager
def attention_kinds(store: dict, tally: dict, name: str):
    """For the block: the first forward call of each kind of attention
    (:func:`attention_kind`) lands in ``store`` under ``name:kind``, and
    ``tally`` counts the calls of each kind, forward under the kind and
    backward (``kernels.flash_attention.flash_attention_bwd``, which the
    backward of ``ops.flash_attention`` calls) under ``bwd:`` and the
    kind."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops

    bwd: dict = {}
    with wrapped(ops, "flash_attention",
                 keep_attention_kinds(store, tally, name)), \
            wrapped(fa_mod, "flash_attention_bwd",
                    keep_attention_kinds({}, bwd, name)):
        yield
    tally.update({f"bwd:{k}": v for k, v in bwd.items()})


def kind_launches(tally: dict, counts: dict, suffix: str, f32: str) -> dict:
    """Launches a step of each kind of attention call from an
    :func:`attention_kinds` tally over TRAIN_STEPS steps, forward under
    ``flash_attention`` and backward under ``flash_attention_bwd`` (each
    plus ``f32``, the run's ``suffix``, ``:`` and the kind), after
    checking that each pass's kinds add up to its ``counts``."""
    out = {}
    for op, pre in (("flash_attention", ""), ("flash_attention_bwd", "bwd:")):
        mine = {k[len(pre):]: v for k, v in tally.items()
                if k.startswith(pre) and (pre or ":" not in k)}
        check(sum(mine.values()) == counts.get(op, 0),
              f"{op}{f32}{suffix} calls by kind {mine} add up to its "
              f"{counts.get(op, 0)} launches over {TRAIN_STEPS} steps")
        out.update({f"{op}{f32}{suffix}:{k}": v // TRAIN_STEPS
                    for k, v in mine.items()})
    return out


def phase_train_cli(arch: str) -> None:
    """The training CLI on the card (no ``--device``: the card is the
    default) at the smoke config of ``arch`` (f32; Mamba-2's SSD chunk is
    8), in a child process; it must exit 0."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
           "--smoke", "--steps", "3", "--seq", "32", "--batch", "4",
           "--dp", "2"]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600)
    tail = (out.stdout + out.stderr).strip().splitlines()[-4:]
    print(f"== train_cli: {' '.join(cmd[1:])} ({time.perf_counter() - t0:.1f}"
          f" s)")
    for line in tail:
        print(f"  | {line}")
    check(out.returncode == 0, f"the training CLI at the {arch} smoke "
          f"config exits 0 on the card (got {out.returncode})")


def phase_clis(archs) -> None:
    """The serving and training CLIs on the card (no ``--device``) at the
    smoke config of each of ``archs``, all started together as child
    processes: serve 3 requests of under 24 prompt tokens, 4 new tokens,
    in waves of 2; train 3 steps at batch 8 x seq 32, loader dp 2 (8
    rows, so Mixtral's 8 accumulated microbatches a step are a row each).
    Each must exit 0, but the training CLI of an encoder-decoder
    (whisper), whose loader's batches have no frames, which must fail
    with a ``ValueError`` that names them (the reference's fails in its
    first step with ``KeyError: 'frames'``)."""
    from repro_torch import configs

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    cmds = []
    refused = {i for i, arch in enumerate(archs)
               if configs.get_smoke_config(arch).is_encoder_decoder}
    for arch in archs:
        cmds.append([sys.executable, "-m", "repro_torch.launch.serve",
                     "--arch", arch, "--smoke", "--batch", "3",
                     "--prompt-len", "24", "--max-new", "4", "--slots",
                     "2"])
        cmds.append([sys.executable, "-m", "repro_torch.launch.train",
                     "--arch", arch, "--smoke", "--steps", "3", "--seq",
                     "32", "--batch", "8", "--dp", "2"])
    print(f"== clis: the serve and train CLIs at {len(archs)} smoke configs, "
          f"{len(cmds)} child processes at once")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"  all ended in {time.perf_counter() - t0:.1f} s")
    for c, p, out in zip(cmds, procs, outs):
        tail = out.strip().splitlines()[-2:]
        print(f"  $ {' '.join(c[2:])} -> exit {p.returncode}")
        for line in tail:
            print(f"  | {line}")
    bad = []
    for i, (c, p, out) in enumerate(zip(cmds, procs, outs)):
        if i % 2 and i // 2 in refused:
            if not (p.returncode and "ValueError" in out and "frames" in out):
                bad.append(" ".join(c[2:]) + " (must refuse: no frames)")
        elif p.returncode:
            bad.append(" ".join(c[2:]))
    check(not bad, f"the serve and train CLIs exit 0 on the card at the "
          f"smoke configs of {', '.join(archs)}, the training CLI of "
          f"{[archs[i] for i in sorted(refused)]} refusing it with a "
          f"ValueError that names the missing frames (failed: {bad})")


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each between two
    CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1))
    return float(np.median(out))


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def worst_grad_row(g, plain) -> float:
    """The largest over rows of ||g - plain|| / max(||plain||, floor),
    the floor GRAD_ROW_FLOOR times the median row norm."""
    rows = plain.float().norm(dim=-1)
    floor = GRAD_ROW_FLOOR * float(rows.median())
    diff = (g.float() - plain.float()).norm(dim=-1)
    return float((diff / rows.clamp_min(floor)).max())


def bwd_case(name: str, args, kwargs, gen):
    """(the kernel's forward outputs, the plain forward's, the backward
    kernel and the plain backward as callables, the output gradient) for
    ``name`` at ``args``: the kernel forward (attention with its lse,
    ssd_scan with its final state) then its backward kernel, and
    autograd through the plain forward, on one random output gradient."""
    from repro_torch.kernels import flash_attention, ref, rglru_scan
    from repro_torch.kernels import ssd_scan

    leaves = [a.detach().clone().requires_grad_() for a in args]
    if name == "flash_attention":
        fwd = flash_attention.flash_attention(*args, lse=True, **kwargs)
        fwd_p = ref.attention_plain(*leaves, lse=True, **kwargs)
        dout = torch.randn(fwd[0].shape, generator=gen, device=DEVICE).to(
            fwd[0].dtype)

        def kernel():
            return flash_attention.flash_attention_bwd(*args, *fwd, dout,
                                                       **kwargs)
    elif name == "rglru_scan":
        fwd = (rglru_scan.rglru_scan(*args),)
        fwd_p = (ref.rglru_scan_plain(*leaves),)
        dout = torch.randn(fwd[0].shape, generator=gen, device=DEVICE).to(
            fwd[0].dtype)

        def kernel():
            return rglru_scan.rglru_scan_bwd(args[0], fwd[0], dout)
    else:
        y, state, saved = ssd_scan.ssd_scan(*args, workspaces=True,
                                            **kwargs)
        fwd = (y, state)
        fwd_p = ref.ssd_scan_plain(*leaves, state=True, **kwargs)
        dout = torch.randn(y.shape, generator=gen, device=DEVICE)

        def kernel():
            return ssd_scan.ssd_scan_bwd(*args, dout, saved, **kwargs)

    def plain():
        return torch.autograd.grad(fwd_p[0], leaves, dout, retain_graph=True)
    return fwd, fwd_p, kernel, plain, dout


def forward_agrees(name, fwd, fwd_p):
    """Hold the forward outputs that a backward case reads (the kernel's
    and the plain version's on the same inputs) to the forward's own
    gates: :func:`agreement` (LM_TOL; for ssd_scan y and the final state
    against SSD_ATOL + SSD_RTOL |plain|), and for attention the worst
    row within ATTN_ROW_TOL and the lse by :func:`agreement` in f32.
    Returns (ok, the readings for the check's message)."""
    fwd_p = tuple(t.detach() for t in fwd_p)
    ok = all(k.shape == p.shape and k.dtype == p.dtype
             and bool(torch.isfinite(k).all()) for k, p in zip(fwd, fwd_p))
    if name == "ssd_scan":
        _, ratio = agreement(name, fwd, fwd_p)
    else:
        _, ratio = agreement(name, fwd[0], fwd_p[0])
    ok = ok and ratio <= 1
    what = f"forward over its gate {ratio:.3e} <= 1"
    if name == "flash_attention":
        tol = ATTN_ROW_TOL[fwd[0].dtype]
        row = worst_row(fwd[0], fwd_p[0])
        _, lse_ratio = agreement(name, fwd[1], fwd_p[1])
        ok = ok and row <= tol and lse_ratio <= 1
        what += (f", worst row {row:.3e} <= {tol:g}, lse over its gate "
                 f"{lse_ratio:.3e} <= 1")
    return ok, what


def bwd_compare(name, args, kwargs, gen, label, rows: bool | str = False,
                kernel_delta: bool = False):
    """Hold the forward outputs to their plain version's
    (:func:`forward_agrees`) and the backward kernel to autograd through
    the plain version on ``args``; with ``rows``, flash_attention's dK
    and dV row by row against autograd and its dQ row by row against
    ``ref.attention_bwd_plain`` fed the kernel's own out and lse.  With
    ``rows="print"`` those rows are printed, not gated, beside the median
    cosine of each k row to its head's mean row and, in bf16, the worst
    dQ and dK rows against :func:`fa2_rounded_ds`: where the keys are
    nearly parallel, dQ = dS K nearly cancels and a row gate reads the
    bf16 rounding of dS, FA2's operand; with ``rows="rounded"`` (bf16)
    the dQ and dK rows are gated against :func:`fa2_rounded_ds` instead,
    the others printed.  With
    ``kernel_delta`` (flash_attention), dQ and dK are held, in Frobenius
    and by rows, against that FA2 plain backward (in f64 for f32, as
    :func:`fa2_inputs`) instead of autograd (whose Delta = rowsum(dO .*
    O) reads the f32 output, where the bf16 kernel's reads its own bf16
    output): where dS = P .* (dP - Delta) nearly cancels (one query row,
    or V_j ~ O_i), the rounding of O alone moves them; autograd's
    readings are printed beside.
    Returns (max abs err of the gradients, the kernel's forward outputs,
    the kernel and plain callables, the output gradient, the FA2 plain
    gradients or None)."""
    from repro_torch.kernels import ref

    fwd, fwd_p, kernel, plain, dout = bwd_case(name, args, kwargs, gen)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    dtype = args[0].dtype
    ok_fwd, what_fwd = forward_agrees(name, fwd, fwd_p)
    tol = GRAD_TOL[dtype]
    fa2 = None
    note = ""
    if kernel_delta:
        fa2 = ref.attention_bwd_plain(*fa2_inputs(*args, *fwd, dout),
                                      **kwargs)
        note = (f" (dQ, dK against the FA2 plain backward on the kernel's "
                f"out and lse; against autograd "
                f"{['%.3e' % _rel(g, w) for g, w in zip(got, want)]})")
        want = (fa2[0].to(dtype), fa2[1].to(dtype), want[2])
    rels = [_rel(g, w) for g, w in zip(got, want)]
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    ok = all(g.shape == w.shape and g.dtype == w.dtype
             and bool(torch.isfinite(g).all()) for g, w in zip(got, want))
    what = (f"{name} {label} {str(dtype)[6:]}: {what_fwd}; backward "
            f"gradients' Frobenius over norm {['%.3e' % r for r in rels]} "
            f"<= {tol:g}{note}")
    ok = ok_fwd and ok and max(rels) <= tol
    if rows and ok:
        worst = [worst_grad_row(g, w) for g, w in zip(got[1:], want[1:])]
        if fa2 is None:
            fa2 = ref.attention_bwd_plain(*fa2_inputs(*args, *fwd, dout),
                                          **kwargs)
        worst_dq = worst_grad_row(got[0], fa2[0])
        if rows in ("print", "rounded"):
            k = args[1].float()
            cos = torch.nn.functional.cosine_similarity(
                k, k.mean(dim=1, keepdim=True), dim=-1)
            what += (f"; worst rows, not gated, of dQ and dK, dV "
                     f"{worst_dq:.3e}, {['%.3e' % r for r in worst]}; k "
                     f"rows' cosine to their head's mean row, median "
                     f"{float(cos.median()):.4f}")
            if dtype == torch.bfloat16:
                rq, rk = fa2_rounded_ds(*args, *fwd, dout, **kwargs)
                worst_r = [worst_grad_row(got[0], rq),
                           worst_grad_row(got[1], rk)]
                what += (f"; worst rows of dQ, dK against it with dS "
                         f"rounded to bf16, the kernel's operand, "
                         f"{['%.3e' % r for r in worst_r]}")
                if rows == "rounded":
                    ok = max(worst_r) <= ATTN_ROW_TOL[dtype]
                    what += f" <= {ATTN_ROW_TOL[dtype]:g}"
                else:
                    what += ", not gated"
        else:
            ok = max(worst + [worst_dq]) <= ATTN_ROW_TOL[dtype]
            what += (f", worst rows of dK, dV {['%.3e' % r for r in worst]}"
                     f", of dQ against the FA2 plain backward on the "
                     f"kernel's out and lse {worst_dq:.3e} <= "
                     f"{ATTN_ROW_TOL[dtype]:g}")
    check(ok, what)
    return err, fwd, kernel, plain, dout, fa2


def fa2_inputs(*tensors):
    """The inputs of the FA2 plain backward that holds a kernel's dQ (q, k,
    v, the kernel's out and lse, dO): as they are for bf16 (the plain
    version computes in f32); in f64 for f32.  The f32 kernel's dQ takes
    dS = P .* dO (V - O), exactly 0 where a row's softmax sits on one key
    (its O is that key's V bitwise) and accurate where it sits nearly on
    one; held to an f32 plain version, the plain version's own rounding
    would count against it, which the row check's floor turns into
    ~1e-3 on rows whose dQ is near 0."""
    if tensors[0].dtype == torch.float32:
        return tuple(t.double() for t in tensors)
    return tensors


def fa2_rounded_ds(q, k, v, o, lse, dout, *, causal: bool, window: int):
    """dQ and dK of bf16 attention by the FA2 formulas of
    ``ref.attention_bwd_plain`` on the kernel's own out and lse, in f32,
    with dS = P .* (dP - Delta) rounded to bf16 before its products with
    K and Q, as the bf16 kernel rounds that operand (the scale applied
    after, as there).  Where the keys or queries a row sums over nearly
    cancel, that rounding alone moves a row far past the bf16 row gate
    against the unrounded formulas; against these the kernel's rows show
    what it adds."""
    rep = q.shape[0] // k.shape[0]
    bh_kv, s_kv, d = k.shape
    scale = 1.0 / float(np.sqrt(d))
    ke = k.float().repeat_interleave(rep, dim=0)
    ve = v.float().repeat_interleave(rep, dim=0)
    qf, dof = q.float(), dout.float()
    vis = attention_masks(q.shape[1], causal, window, q.device,
                          s_kv=s_kv)[0]
    p = torch.where(vis[None], torch.exp(
        torch.einsum("bqd,bkd->bqk", qf, ke) * scale
        - lse.float()[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1)
    ds = (p * (torch.einsum("bqd,bkd->bqk", dof, ve) - delta[..., None])
          ).to(torch.bfloat16).float()
    del p
    dq = torch.einsum("bqk,bkd->bqd", ds, ke) * scale
    dk = (torch.einsum("bqk,bqd->bkd", ds, qf) * scale).view(
        bh_kv, rep, s_kv, d).sum(1)
    return dq, dk


def attention_grads_masked(q, k, v, dout, visible):
    """The gradients of :func:`attention_masked` (one head at a time under
    an explicit mask) by autograd."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = attention_masked(*leaves, visible)
    return torch.autograd.grad(out, leaves, dout)


def attention_dq_masked(q, k, v, o, lse, dout, visible):
    """dQ by the FA2 formulas from the given o and lse, under an explicit
    (S, S) visibility mask, one query head at a time (f32; f64 for f64
    inputs): dS = P .* (dO V^T - Delta), less each row's P-weighted mean
    but for bf16 inputs, as ``ref.attention_bwd_plain`` takes it; in f64
    (the f32 kernel's check) the Delta form agrees with its dO (V - O)
    form far inside the row gate, and it needs no (S, S, D) difference."""
    rep = q.shape[0] // k.shape[0]
    scale = 1.0 / float(np.sqrt(q.shape[2]))
    wide = torch.promote_types(q.dtype, torch.float32)
    dq = torch.empty(q.shape, dtype=wide, device=q.device)
    for b in range(q.shape[0]):
        kb, vb, dob = (t.to(wide) for t in (k[b // rep], v[b // rep],
                                            dout[b]))
        p = torch.where(visible, torch.exp(q[b].to(wide) @ kb.T * scale
                                           - lse[b, :, None].to(wide)), 0.0)
        delta = (dob * o[b].to(wide)).sum(-1)
        ds = p * (dob @ vb.T - delta[:, None])
        dq[b] = ds @ kb * scale
        if q.dtype != torch.bfloat16:
            mean = ds.sum(-1) / p.sum(-1).clamp_min(torch.finfo(wide).tiny)
            dq[b] -= mean[:, None] * (p @ kb) * scale
    return dq


def check_attention_bwd_faults(args, kwargs, dout, plain_grads, fwd, fa2,
                               tiles=(64, 128)):
    """One-tile faults planted in the attention's plain gradients (the
    masks of :func:`attention_masks` at the kernel's ``tiles``: keys a kv
    tile, rows a q block) must trip the row checks: dK and dV against
    autograd's ``plain_grads``, dQ (by the FA2 formulas on the kernel's
    out and lse ``fwd``, in :func:`fa2_inputs`' dtype) against ``fa2``;
    the same per-head code under the true mask must pass them."""
    tol = ATTN_ROW_TOL[args[0].dtype]
    ok_mask, faults = attention_masks(args[0].shape[1], kwargs["causal"],
                                      kwargs["window"], DEVICE,
                                      key_tile=tiles[0], q_block=tiles[1])

    def worst(mask):
        dkv = [worst_grad_row(g, w) for g, w in zip(
            attention_grads_masked(*args, dout, mask)[1:], plain_grads[1:])]
        dq = worst_grad_row(attention_dq_masked(
            *fa2_inputs(*args, *fwd, dout), mask), fa2[0])
        return dkv, dq

    dkv, dq = worst(ok_mask)
    check(max(dkv + [dq]) <= tol, f"flash_attention backward, plain one "
          f"head at a time under its own mask: worst rows of dK, dV "
          f"{['%.3e' % r for r in dkv]}, of dQ {dq:.3e} <= {tol:g}")
    for label, mask in faults:
        dkv, dq = worst(mask)
        check(max(dkv) > tol and dq > tol, f"flash_attention backward "
              f"planted fault ({label}): worst rows of dK, dV "
              f"{['%.3e' % r for r in dkv]}, the largest > {tol:g}; of "
              f"dQ {dq:.3e} > {tol:g}")


# The f32 attention backward's row gates at the training shape on seeded
# draws beside the kept inputs: DQ_DRAWS draws of q, k, v and dO, each
# from a generator seeded DQ_SEED + i, and one input whose rows sit nearly
# on one key (NEAR_KEY_SEED): each query row is a key row it sees scaled
# so that the key's score is about NEAR_KEY_SCORE (8 / sqrt(D) times the
# key: at D 64, the CPU test's inputs), where dP - Delta would cancel.
DQ_DRAWS, DQ_SEED = 8, 1000
NEAR_KEY_SEED, NEAR_KEY_SCORE = 2000, 8.0


def attention_f32_draws(args, kwargs) -> None:
    """The f32 flash_attention backward on DQ_DRAWS seeded draws at
    ``args``' shapes (:func:`bwd_compare` with its row checks: dK and dV
    against autograd, dQ against the FA2 plain backward in f64 on the
    kernel's out and lse, each within ATTN_ROW_TOL; each draw's worst rows
    printed) and on the near-one-key input (:func:`near_one_key_dq`)."""
    shape, kshape = args[0].shape, args[1].shape
    for i in range(DQ_DRAWS):
        gen = torch.Generator(device=DEVICE).manual_seed(DQ_SEED + i)
        rand = tuple(torch.randn(sh, generator=gen, device=DEVICE)
                     for sh in (shape, kshape, kshape))
        bwd_compare("flash_attention", rand, kwargs, gen,
                    f"seeded draw {i} (seed {DQ_SEED + i}) {tuple(shape)}",
                    True)
        del rand
        torch.cuda.empty_cache()
    near_one_key_dq(args, kwargs)


def near_one_key_dq(args, kwargs) -> None:
    """The f32 flash_attention backward where every query row sits nearly
    on one key it sees (k, v and dO seeded draws; query row i of head h is
    k[h // rep, j] scaled by NEAR_KEY_SCORE / sqrt(D) for a key j it sees,
    drawn at random): the forward within its gates, and dQ within
    ATTN_ROW_TOL row by row of the FA2 plain backward in f64 on the
    kernel's out and lse.  There autograd through the f32 plain forward
    is itself off the f64 gradients, so dQ, dK and dV are held to f64; dK
    and dV (dS^T = P^T (dP^T - Delta), which cancels there) are printed
    beside it, not gated, with autograd's own distance from f64."""
    from repro_torch.kernels import flash_attention, ref

    gen = torch.Generator(device=DEVICE).manual_seed(NEAR_KEY_SEED)
    bh, s, d = args[0].shape
    k, v, dout = (torch.randn(sh, generator=gen, device=DEVICE)
                  for sh in (args[1].shape, args[1].shape, args[0].shape))
    pos = torch.arange(s, device=DEVICE)
    window, causal = kwargs["window"], kwargs["causal"]
    lo = (pos - window + 1).clamp_min(0) if window > 0 else pos * 0
    hi = pos + 1 if causal else pos * 0 + s
    pick = lo + (torch.rand((bh, s), generator=gen, device=DEVICE)
                 * (hi - lo)).long().clamp_max(hi - lo - 1)
    rep = bh // k.shape[0]
    heads = torch.arange(bh, device=DEVICE)[:, None] // rep
    q = k[heads, pick] * (NEAR_KEY_SCORE / float(np.sqrt(d)))
    fwd = flash_attention.flash_attention(q, k, v, lse=True, **kwargs)
    ok_fwd, what_fwd = forward_agrees(
        "flash_attention", fwd,
        ref.attention_plain(q, k, v, lse=True, **kwargs))
    got = flash_attention.flash_attention_bwd(q, k, v, *fwd, dout, **kwargs)
    want = ref.attention_bwd_plain(*fa2_inputs(q, k, v, *fwd, dout),
                                   **kwargs)
    rows = [worst_grad_row(g, w) for g, w in zip(got, want)]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(ref.attention_plain(*leaves, **kwargs),
                               leaves, dout)
    auto_rows = [worst_grad_row(g, w) for g, w in zip(auto, want)]
    del leaves, auto
    tol = ATTN_ROW_TOL[torch.float32]
    check(ok_fwd and all(bool(torch.isfinite(g).all()) for g in got)
          and rows[0] <= tol,
          f"flash_attention f32 near one key {tuple(q.shape)} (seed "
          f"{NEAR_KEY_SEED}): {what_fwd}; worst row of dQ against the FA2 "
          f"plain backward in f64 {rows[0]:.3e} <= {tol:g}")
    print(f"  near one key: worst rows of dK, dV against f64 (dS^T = P^T "
          f"(dP^T - Delta), not gated) {rows[1]:.3e}, {rows[2]:.3e}; "
          f"autograd through the f32 plain forward against f64: dQ, dK, dV "
          f"{', '.join('%.3e' % r for r in auto_rows)}")
    del q, k, v, dout, fwd, got, want
    torch.cuda.empty_cache()


def bwd_bound(name, args, kwargs):
    """(bound_ms, bound_by) of one backward call
    (``repro_torch.kernels.cost``): the bytes it must move (inputs, the
    forward's saved tensors it reads, output gradient read once;
    gradients written once) over the HBM rate against the flops the
    function needs at the type's peak (TF32 for the scans)."""
    from repro_torch.kernels import cost
    t = args[0]
    if name == "flash_attention":
        return cost.flash_attention_bwd(
            t.shape, args[1].shape, t.dtype, causal=kwargs["causal"],
            window=kwargs["window"]).bound()
    if name == "rglru_scan":
        return cost.rglru_scan_bwd(t.shape, t.dtype).bound()
    x, _, _, B, _ = args
    return cost.ssd_scan_bwd(x.shape, B.shape, kwargs["chunk"]).bound()


def print_bwd_build(key: str, args, kwargs) -> None:
    """A backward kernel's ``-Xptxas -v`` lines from this run's build and
    the dynamic shared memory of its launches at ``args``' shapes."""
    from repro_torch.kernels import flash_attention, ssd_scan

    for line in ptxas_report(BWD_KERNELS[key]):
        print(f"  ptxas: {line}")
    if key.startswith("flash_attention"):
        plan = flash_attention.bwd_plan(args[0].shape, args[1].shape,
                                        args[0].dtype)
        print(f"  launches {', '.join(plan['launches'])}; dynamic shared "
              f"memory and CTAs: dq {plan['dq_smem_bytes']} B, "
              f"{plan['dq_ctas']} CTAs; dkdv {plan['dkdv_smem_bytes']} B, "
              f"{plan['dkdv_ctas']} CTAs ({plan['groups']} query-head groups "
              f"a kv block)")
    elif key == "ssd_scan":
        smem = ssd_scan.bwd_smem_bytes()
        x, _, _, B, _ = args
        splits = ssd_scan.bwd_splits(x.shape[0], B.shape[0], x.shape[1],
                                     min(kwargs["chunk"], x.shape[1]))
        print(f"  dynamic shared memory: col {smem['col']} B, row "
              f"{smem['row']} B; head splits {splits}")


def sdpa_backward(q, k, v, dout, causal: bool, window: int, heads: int,
                  is_causal: bool = False):
    """SDPA's backward with the same mask on k and v expanded to every
    query head, as a callable: the library's yardstick (the port never
    calls it); with ``is_causal``, SDPA's own causal path and no mask,
    the same function where the mask is plain causal; with no mask where
    every key is visible (non-causal, no window: a cross-attention's S_kv
    keys)."""
    bh, s, d = q.shape
    rep = bh // k.shape[0]
    mask = (None if is_causal or (not causal and window <= 0)
            else attention_masks(s, causal, window, q.device)[0])
    leaves = [t.detach().reshape(bh // heads, heads, t.shape[1], d).clone()
              .requires_grad_()
              for t in (q, k.repeat_interleave(rep, dim=0),
                        v.repeat_interleave(rep, dim=0))]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=mask, is_causal=is_causal)
    dview = dout.view(bh // heads, heads, s, d)
    return lambda: torch.autograd.grad(out, leaves, dview, retain_graph=True)


def rglru_training_forward(args) -> None:
    """The rglru_scan forward at the training shape (f32): held to its
    plain version within LM_TOL, two launches and the direct path bitwise
    equal (:func:`rglru_compare`), its time as the median of 7 calls
    between CUDA events beside the mean of back-to-back calls, the direct
    path's (the first design) in this run, the bound, its plain version's
    and the earlier design's (PERF.md row 6); a text line."""
    from repro_torch.kernels import rglru_scan
    shape = tuple(args[0].shape)
    rglru_compare(args, f"training shape {shape}")
    paths = rglru_paths(args, f"training shape {shape}")
    ms = time_ms(lambda: rglru_scan.rglru_scan(*args), 20)
    plain_ms = time_ms(lambda: lm_plain("rglru_scan")(*args), 2)
    bound, by = lm_bound("rglru_scan", args, {})
    plan = rglru_scan.fwd_plan(shape, args[0].dtype)
    for line in ptxas_report(r"(rglru_scan_(?:tma_)?kernel(?:I\w+?E)?)"):
        print(f"  ptxas: {line}")
    print(f"  rglru_scan forward launch: {plan['path']} path, {plan['ctas']} "
          f"CTAs of {plan['threads']} threads, {plan['stages']} stages, "
          f"dynamic shared memory {plan['smem_bytes']} B")
    print(f"  rglru_scan forward {shape} {str(args[0].dtype)[6:]} at the "
          f"training shape: "
          f"{paths['path']} path, kernel {paths['ms_median']:.4f} ms (median "
          f"of 7; back to back {ms:.4f} ms), direct path "
          f"{paths['direct_ms_median']:.4f} ms (median; back to back "
          f"{paths['direct_ms']:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), share of the bound "
          f"{bound / paths['ms_median']:.3f}; earlier "
          f"{EARLIER_FWD_MS['rglru_scan']:.4f} ms (PERF.md)")


def attention_f32_row(args, kwargs, heads: int, launches: int) -> dict:
    """The f32 flash_attention forward at the f32 training run's first
    layer inputs, as a row of the kernels JSON line: held to
    attention_plain (its ``agreement`` within LM_TOL and the worst row
    within ATTN_ROW_TOL), two launches bitwise equal (out and lse), each
    causal head's first row, which sees one key, equal to that key's V
    bitwise (the backward's f32 dQ row gate rests on it); its -Xptxas -v
    lines; its time (median of 7 between CUDA events; one launch a call)
    beside the plain version's, SDPA's with the same mask, the bound and
    the first design's.  ``launches``: its launches a step of the f32 training
    run."""
    from repro_torch.kernels import flash_attention, ref

    q, k, v = args
    run = lambda: flash_attention.flash_attention(*args, lse=True, **kwargs)
    out, lse = run()
    out2, lse2 = run()
    plain = ref.attention_plain(*args, **kwargs)
    err, ratio = agreement("flash_attention", out, plain)
    row = worst_row(out, plain)
    tol = ATTN_ROW_TOL[q.dtype]
    shape = tuple(q.shape)
    check(bool(torch.isfinite(out).all()) and ratio <= 1 and row <= tol,
          f"flash_attention f32 forward {shape} against attention_plain: "
          f"max abs err {err:.3e} over its gate {ratio:.3e} <= 1, worst "
          f"row {row:.3e} <= {tol:g}")
    check(torch.equal(out, out2) and torch.equal(lse, lse2),
          "flash_attention f32 forward: two launches bitwise equal")
    if kwargs["causal"]:
        rep = q.shape[0] // k.shape[0]
        check(torch.equal(out[:, 0], v.repeat_interleave(rep, dim=0)[:, 0]),
              f"flash_attention f32 forward: the first row of each of the "
              f"{q.shape[0]} heads (one visible key) is that key's V "
              f"bitwise")
    del out, lse, out2, lse2, plain
    torch.cuda.empty_cache()
    for line in ptxas_report(r"(flash_f32_kernel(?:ILi\d+E)?)"):
        print(f"  ptxas: {line}")
    bound, by = lm_bound("flash_attention", args, kwargs)
    out = {
        "name": "flash_attention_f32", "ok": True, "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"], "launches": launches,
        "max_abs_err": err, "ms": median_ms(run, 7),
        "plain_ms": median_ms(
            lambda: ref.attention_plain(*args, **kwargs), 3),
        "bound_ms": bound, "bound_by": by,
        "library_ms": median_ms(
            sdpa_calls(*args, heads=heads, **kwargs)[0], 5),
        "shape": list(shape), "dtype": "float32",
    }
    print(f"  flash_attention forward {shape} float32 at the training "
          f"shape: kernel {out['ms']:.4f} ms (median; one launch), plain "
          f"{out['plain_ms']:.4f} ms, library {out['library_ms']:.4f} ms "
          f"(SDPA, same mask), bound {bound:.4f} ms ({by}), share of the "
          f"bound {bound / out['ms']:.3f}; first design "
          f"{EARLIER_FWD_MS['flash_attention_f32']:.4f} ms (PERF.md)")
    return out


def attention_launch_times(args, fwd, dout, kwargs, kernel,
                           whole_ms: float) -> list:
    """(name, ms) of each CUDA launch of one flash_attention backward at
    ``args`` (f32 or bf16, D a multiple of 16): prep (none in bf16 at D <=
    128, whose dq launch does its work), dq and dkdv, each run alone
    through the C entry ``repro_flash_attention_bwd_{f32,bf16}_part``
    (which only this script calls) and timed between CUDA events, the
    median of 7 (in order, so that each reads what the one before left in
    the workspace).
    The profiler keeps no record of the f32 kernels in most runs of the
    whole script (:func:`launch_times`), and this is the bf16 rows'
    fallback where it drops theirs.  Checks that the launches alone
    give ``kernel``'s dQ, dK and dV bitwise, so the launches timed are the
    path's, and (f32) that their times add up to the whole call's median
    ``whole_ms`` within 10%."""
    from repro_torch.kernels import _build, flash_attention

    q, k, v = args
    o, lse = fwd
    kind = "f32" if q.dtype == torch.float32 else "bf16"
    ws = torch.empty(flash_attention.bwd_plan(q.shape, k.shape,
                                              q.dtype)["ws_shape"],
                     dtype=torch.float32, device=q.device)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    entry = getattr(_build.load(), f"repro_flash_attention_bwd_{kind}_part")
    names = flash_attention.bwd_plan(q.shape, k.shape, q.dtype)["launches"]
    out = []
    for name in names:
        def one(part=("prep", "dq", "dkdv").index(name)):
            _build.check(entry(
                *(t.data_ptr() for t in (q, k, v, o, dout, lse, ws, *grads)),
                q.shape[0], k.shape[0], q.shape[1], k.shape[1], q.shape[2],
                q.shape[2], int(bool(kwargs["causal"])), int(kwargs["window"]),
                float(kwargs.get("softcap", 0.0)), part,
                torch.cuda.current_stream(q.device).cuda_stream),
                f"flash_attention_bwd_{kind}_part")
        out.append((name, median_ms(one, 7)))
    total = sum(ms for _, ms in out)
    # A bf16 call's median holds its host time (60-100 us against ~0.5 ms
    # on the card at D = 128), so its sum is printed, not gated.
    near = kind == "bf16" or abs(total - whole_ms) <= 0.1 * whole_ms
    check(all(torch.equal(a, b) for a, b in zip(grads, kernel())) and near,
          f"flash_attention {kind} backward's launches alone: dQ, dK and dV "
          f"bitwise the whole call's, their times' sum {total:.4f} ms "
          + ("beside" if kind == "bf16" else "within 10% of")
          + f" its {whole_ms:.4f} ms")
    return out


# Ragged backward cases: flash_attention (BH, BH_kv, S, D, causal,
# window) in bf16 and f32; rglru_scan shapes in f32 and bf16 (one at
# S = 1, one shorter than the backward's 64-step chunk, one chunk and a
# step, a ragged last chunk at a width off the 4-channel vectors);
# ssd_scan (BH, B/C rows, S, P, N, chunk).
BWD_ATTN_RAGGED = ((8, 2, 1000, 256, True, 0), (4, 1, 160, 128, True, 64),
                   (4, 4, 77, 64, False, 0), (6, 3, 300, 128, True, 512))
BWD_RGLRU_RAGGED = ((3, 77, 100), (2, 1, 33), (1, 33, 1), (2, 65, 8),
                    (2, 1000, 70))
# The backward cases at the training shapes: the kept first call's key,
# the kernel op, and the kernel's tiles (keys a kv tile, rows a q block)
# at which the attention's planted faults sit.
BWD_CASES = (("flash_attention", "flash_attention", (64, 128)),
             ("rglru_scan", "rglru_scan", None),
             ("ssd_scan", "ssd_scan", None),
             ("flash_attention_f32", "flash_attention", (32, 64)))
BWD_SSD_RAGGED = ((5, 5, 300, 48, 64, 100), (8, 2, 512, 32, 64, 128),
                  (3, 1, 200, 64, 128, 256))


def phase_train_kernels(kept: dict, counts: dict) -> list:
    """Each backward kernel against autograd through its plain version,
    and the forward outputs it reads against the plain forward's: at the
    first training layer's inputs (``kept``, from the train phases;
    flash_attention in bf16 and, from the f32 RecurrentGemma run, in
    f32), on random inputs at the same shapes and at ragged shapes;
    flash_attention at the training shape also row by row in dQ, dK and
    dV, with planted one-tile faults that must trip those checks; two
    launches bitwise equal; then the timings (median of several) beside
    the bound, the plain backward and, for flash_attention, SDPA's
    backward with the same mask, and each CUDA launch's device time (the
    profiler's; the f32 attention's each run alone between CUDA events,
    ``attention_launch_times``); the f32 attention forward as a row
    of its own (``attention_f32_row``) and the f32 rglru_scan forward
    timed at their training shapes.
    ``counts``: each kernel's launches a step of the train phases' main
    path, under its ``kept`` key's suffix."""
    print("== train_kernels: backward kernels")
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    rows = []
    for key, name, tiles in BWD_CASES:
        args, kwargs = kept[key]
        args = tuple(a.detach().clone() for a in args)
        kwargs = {k: v for k, v in kwargs.items()
                  if k in ("causal", "window", "chunk")}
        if name == "ssd_scan":
            args = args[:5]
        shape, dtype = tuple(args[0].shape), args[0].dtype
        rows_check = name == "flash_attention"
        err, fwd, kernel, plain, dout, fa2 = bwd_compare(
            name, args, kwargs, gen, f"first training layer {shape}",
            rows_check)
        if name == "flash_attention":
            rand = (torch.randn(shape, generator=gen, device=DEVICE),
                    torch.randn(args[1].shape, generator=gen, device=DEVICE),
                    torch.randn(args[1].shape, generator=gen, device=DEVICE))
            rand = tuple(t.to(dtype) for t in rand)
        elif name == "rglru_scan":
            rand = (torch.rand(shape, generator=gen, device=DEVICE)
                    .mul(0.3).add(0.7).to(dtype),
                    torch.randn(shape, generator=gen, device=DEVICE)
                    .mul(0.1).to(dtype))
        else:
            x, _, _, B, _ = args
            rand = ssd_random(x.shape[0], B.shape[0], x.shape[1],
                              x.shape[2], B.shape[2], gen)
        err = max(err, bwd_compare(name, rand, kwargs, gen,
                                   f"random {shape}", rows_check)[0])
        if name == "flash_attention":
            check_attention_bwd_faults(args, kwargs, dout, plain(), fwd,
                                       fa2, tiles)
        if key == "flash_attention_f32":
            attention_f32_draws(args, kwargs)
        g1, g2 = kernel(), kernel()
        check(all(torch.equal(a, b) for a, b in zip(g1, g2)),
              f"{key} backward: two launches bitwise equal")
        del g1, g2
        bound, by = bwd_bound(name, args, kwargs)
        suffix = key[len(name):]
        row = {
            "name": f"{name}_bwd{suffix}", "ok": True, "route": "cuda",
            "source": BWD_SOURCES[key], "replaces": REPLACES[name],
            "pass": "backward", "launches": counts[f"{name}_bwd{suffix}"],
            "max_abs_err": err, "ms": median_ms(kernel, 7),
            # the host's share of a call (checks, allocations, the ctypes
            # call before the first launch) hidden behind the last call
            "ms_back_to_back": time_ms(kernel, 10),
            "plain_ms": median_ms(plain, 3),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": list(shape), "dtype": str(dtype)[6:],
        }
        if name == "flash_attention":
            row["library_ms"] = median_ms(sdpa_backward(
                *args, dout, heads=kept["heads"], **kwargs), 5)
        lib = row["library_ms"]
        earlier = EARLIER_BWD_MS.get(key)
        print(f"  {key} backward {shape}: kernel {row['ms']:.4f} ms "
              f"(median; back to back {row['ms_back_to_back']:.4f} ms), "
              f"plain {row['plain_ms']:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms (SDPA backward, same mask)'}"
              f", bound {bound:.4f} ms ({by}), share of the bound "
              f"{bound / row['ms']:.3f}"
              + ("" if earlier is None else
                 f"; first design {earlier:.4f} ms (PERF.md)"))
        if key == "flash_attention_f32":
            parts = attention_launch_times(args, fwd, dout, kwargs,
                                               kernel, row["ms"])
        else:
            parts = launch_times(kernel, BWD_KERNELS[key])
            if not parts and key == "flash_attention":
                parts = attention_launch_times(args, fwd, dout, kwargs,
                                               kernel, row["ms"])
        print(f"  {key} backward launches, device time a call: " + (
            ", ".join(f"{k} {ms:.4f} ms" for k, ms in parts)
            or "not traced"))
        print_bwd_build(key, args, kwargs)
        if key == "flash_attention_f32":
            rows.append(attention_f32_row(args, kwargs, kept["heads"],
                                          counts[key]))
        elif name == "rglru_scan":
            rglru_training_forward(args)
        rows.append(row)
        del kernel, plain, dout, args, rand, fwd, fa2
        torch.cuda.empty_cache()

    for dtype in (torch.bfloat16, torch.float32):
        for bh, bh_kv, s, d, causal, window in BWD_ATTN_RAGGED:
            qkv = tuple(torch.randn(r, s, d, generator=gen, device=DEVICE)
                        .to(dtype) for r in (bh, bh_kv, bh_kv))
            bwd_compare("flash_attention", qkv,
                        {"causal": causal, "window": window}, gen,
                        f"ragged ({bh}, {bh_kv}, {s}, {d}) causal={causal} "
                        f"window={window}")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in BWD_RGLRU_RAGGED:
            ab = (torch.rand(shape, generator=gen, device=DEVICE)
                  .mul(0.3).add(0.7).to(dtype),
                  torch.randn(shape, generator=gen, device=DEVICE)
                  .mul(0.1).to(dtype))
            bwd_compare("rglru_scan", ab, {}, gen, f"ragged {shape}")
    for bh, groups, s, p, n, c in BWD_SSD_RAGGED:
        bwd_compare("ssd_scan", ssd_random(bh, groups, s, p, n, gen),
                    {"chunk": c}, gen, f"ragged x {(bh, s, p)}, B/C "
                    f"{(groups, s, n)}, chunk {c}")
    return rows


# How whisper's kept bf16 training inputs hold their backward's rows
# (bwd_compare's ``rows``).  The encoder's: gated.  The decoder's causal
# self-attention: its worst dK row read 0.167 against autograd (whose
# Delta reads the f32 output) and 9.13e-2 against the FA2 formulas on the
# kernel's own out, 4.28e-3 against them with dS rounded to bf16 as the
# kernel's operand (dQ 3.50e-3; the random inputs' rows 6.5e-3), so
# gated against that.  The cross-attention's keys sit at a cosine of
# 0.9999 to their mean and dQ = dS K nearly cancels: its worst dQ row
# read 9.69e-2 against the FA2 formulas and 3.30e-2 with dS rounded, the
# one-ulp flips of the rounding there alone, so its rows are printed (its
# Frobenius and the random inputs' rows gated; measured on one H100).
ROWS_BY_KIND = {"noncausal": True, "causal": "rounded", "cross": "print"}


def whisper_train_rows(kept: dict, counts: dict) -> list:
    """``kernels`` rows for whisper-large-v3's training attention: the
    bf16 backward (:func:`attention_bwd_shape_row`) at the first call of
    each kind of the trainer's run, and the f32 cross-attention forward
    and backward at the first cross call of the repeated steps on an f32
    copy, each with its launches a step in that run (``counts``, from
    :func:`phase_train`), dQ and dK held to the FA2 plain backward on
    the kernel's own out and lse (``kernel_delta``), their rows as
    ROWS_BY_KIND says (the random inputs' rows always gated)."""
    from repro_torch import configs
    heads = configs.get_config("whisper-large-v3").num_heads
    rows = []
    for dtype, kind, what in (("", "noncausal", "encoder"),
                              ("", "causal", "self"),
                              ("", "cross", "cross"),
                              ("_f32", "cross", "cross")):
        args, kwargs = kept.pop(f"flash_attention{dtype}_whisper:{kind}")
        args = tuple(a.detach() for a in args)
        kwargs = {k: v for k, v in kwargs.items() if k in ("causal", "window")}
        label = (f"whisper-large-v3 training {what}-attention"
                 + (", f32" if dtype else ""))
        if dtype:
            rows.append(attention_shape_row(
                f"flash_attention_f32_whisper_{what}_train", label, args,
                kwargs, counts[f"flash_attention_f32_whisper:{kind}"],
                heads))
        rows.append(attention_bwd_shape_row(
            f"flash_attention_bwd{dtype}_whisper_{what}_train", label, args,
            kwargs, counts[f"flash_attention_bwd{dtype}_whisper:{kind}"],
            heads, rows=ROWS_BY_KIND[kind] if not dtype else "print",
            kernel_delta=True))
        del args
    return rows


# ---------------------------------------------------------------------------
# Data-parallel training on a process mesh (``dp_train``).
# ---------------------------------------------------------------------------

# Four ranks share the card over gloo (NCCL refuses two ranks on one
# GPU), their collectives through pinned host copies, on the ("data": 2,
# "model": 2) mesh.  (a) The f32 smoke configs of gemma3-1b ("dp"
# profile) and yi-6b ("tp", GQA), B = 8 rows of 32 tokens, two steps at
# lr 1e-3, held to the port's single-process step on the card within the
# limits of tests/test_torch_train.py (loss 1e-5 relative, grad norm 1e-4
# relative, params 1e-5 absolute but for elements whose first moment was
# under 1e-7 after a step, 2 lr a step there); the first one's state is
# saved and remeshed onto ("data": 4, "model": 1) and, in a launch of two
# ranks, ("data": 1, "model": 2).  (b) Mamba-2 1.3B at full size in bf16
# through train(mesh=) for one step of TRAIN_RUNS["mamba2-1.3b"]'s batch
# (the time budget's cut; (a)'s smoke steps run on updated params).
DP = {"ranks": 4, "backend": "gloo", "shape": (2, 2),
      "axes": ("data", "model")}
DP_SMOKE = (("gemma3-1b", 8), ("yi-6b", 8))
DP_SEQ = 32
DP_LR = 1e-3
DP_REMESH = ((4, 1), (1, 2))
DP_FULL = {"arch": "mamba2-1.3b", "steps": 1,
           **{k: TRAIN_RUNS["mamba2-1.3b"][k] for k in ("batch", "seq",
                                                        "dp")}}
DP_LOSS_RTOL, DP_NORM_RTOL, DP_PARAM_ATOL, DP_TINY_M = 1e-5, 1e-4, 1e-5, 1e-7


def dp_smoke_batch(cfg, b: int, seed: int) -> dict:
    """B rows of DP_SEQ tokens, the first half of the rows masked past the
    middle: ranks whose rows differ in their mask counts, where a mean of
    the ranks' means is another function than the global loss."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, DP_SEQ)).astype(np.int32)
    labels = np.zeros_like(toks)
    labels[:, :-1] = toks[:, 1:]
    mask = (rng.random((b, DP_SEQ)) < 0.9).astype(np.float32)
    mask[:, -1] = 0.0
    mask[: b // 2, DP_SEQ // 2:] = 0.0
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(
        labels), "mask": torch.from_numpy(mask)}


def _flat(tree) -> dict:
    """{"a/b": leaf} of a nested dict."""
    return {k[1:]: v for k, v in _leaves(tree)}


def _cpu(tree):
    from repro_torch.optim import adamw
    return adamw.tree_map(lambda t: t.detach().cpu().clone(), tree)


def dp_smoke_single(arch: str, b: int, tmp: str) -> dict:
    """The single-process step on the card: the smoke config's weights
    and two batches saved under ``tmp`` for the ranks, then two steps;
    the losses, grad norms, params after them and first moments after
    each step."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    cfg = configs.get_smoke_config(arch)
    params = transformer.init_params(cfg, seed=0, device=DEVICE)
    batches = [dp_smoke_batch(cfg, b, s) for s in range(2)]
    torch.save({"params": _cpu(params), "batches": batches},
               os.path.join(tmp, f"smoke_{arch}.pt"))
    step = steps.make_train_step(cfg, adamw.AdamWConfig(lr=DP_LR))
    opt = adamw.adamw_init(params)
    out = {"losses": [], "norms": [], "m": []}
    for batch in batches:
        loss, params, opt = step(params, opt, _to_device(batch, DEVICE))
        out["losses"].append(float(loss))
        out["norms"].append(float(step.last["grad_norm"]))
        out["m"].append(_flat(_cpu(opt["m"])))
    out["params"] = _flat(_cpu(params))
    return out


def dp_expected_bytes(cfg, mesh) -> int:
    """Bytes of one rank's params (cfg.dtype) and f32 moments and step
    under the mesh's specs: each leaf's elements over the product of the
    sizes of the axes that shard it."""
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding

    with sharding.use_mesh(mesh):
        specs = adamw.leaves(transformer.param_specs(cfg))
    total = 4          # the step
    for p, spec in zip(adamw.leaves(transformer.param_shapes(cfg)), specs):
        k = int(np.prod([mesh.shape[a] for a in sharding.spec_axes(spec)]))
        total += p.numel() // k * (p.element_size() + 8)
    return total


def dp_remeshed(cfg, directory: str, shape, device) -> dict:
    """This rank's blocks of ``directory``'s newest checkpoint remeshed
    onto a ``shape`` mesh, each held bitwise to its slice of the saved
    arrays (read here with numpy)."""
    from repro_torch.checkpoint import manager
    from repro_torch.models import transformer
    from repro_torch.runtime import elastic, sharding, steps
    from repro_torch.runtime.mesh import ProcessMesh

    mesh = ProcessMesh(shape, DP["axes"], device=device)
    t0 = time.perf_counter()
    params, opt, manifest = elastic.remesh(cfg, directory, mesh)
    wall = time.perf_counter() - t0
    saved, _ = manager.restore_pytree(manager.latest_checkpoint(directory))
    with sharding.use_mesh(mesh):
        shards = _flat({"params": sharding.named_shardings(
            mesh, transformer.param_specs(cfg)),
            "opt": sharding.named_shardings(mesh, steps.opt_specs(cfg))})
    blocks = _flat({"params": params, "opt": opt})
    bad = [k for k, arr in saved.items()
           if not np.array_equal(blocks[k].cpu().numpy(),
                                 arr[sharding.block_slices(shards[k],
                                                           arr.shape)])]
    return {"rank": mesh.rank, "step": manifest["step"], "wall": wall,
            "leaves": len(saved), "bad": bad,
            "device": str(blocks["params/embed"].device)}


def dp_train_rank(device, tmp: str) -> dict:
    """One rank of ``phase_dp_train`` (spawned: importable by name): (a)
    the smoke configs' sharded steps, a checkpoint of the first one's
    state under the mesh, its remesh onto (4, 1); serve_mesh's (a)
    (:func:`serve_mesh_smoke_rank`); (b) Mamba-2 at full
    size through ``train(mesh=)``, each step timed to a synchronised end
    with its launch counts, rank 0's first ``ssd_scan`` call kept."""
    from repro_torch import configs
    from repro_torch.checkpoint import manager
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding, steps, tp
    from repro_torch.runtime.mesh import ProcessMesh

    mesh = ProcessMesh(DP["shape"], DP["axes"], device=device)
    out = {"rank": mesh.rank, "mesh": mesh.describe(), "smoke": {}}
    for arch, _ in DP_SMOKE:
        cfg = configs.get_smoke_config(arch)
        inputs = torch.load(os.path.join(tmp, f"smoke_{arch}.pt"))
        with sharding.use_mesh(mesh):
            pshard = sharding.named_shardings(mesh,
                                              transformer.param_specs(cfg))
            oshard = sharding.named_shardings(mesh, steps.opt_specs(cfg))
        params = adamw.tree_map(
            lambda p, sh: sharding.local_block(p.to(device), sh).clone(),
            inputs["params"], pshard)
        opt = adamw.adamw_init(params)
        step = steps.make_train_step(cfg, adamw.AdamWConfig(lr=DP_LR),
                                     mesh=mesh)
        res = {"losses": [], "norms": []}
        for batch in inputs["batches"]:
            loss, params, opt = step(params, opt, _to_device(batch, device))
            res["losses"].append(loss.detach().cpu())
            res["norms"].append(float(step.last["grad_norm"]))
        state, shards = {"params": params, "opt": opt}, {"params": pshard,
                                                         "opt": oshard}
        res["whole"] = _flat(adamw.tree_map(
            lambda b, sh: sharding.gather(b, sh).cpu(), state, shards))
        out["smoke"][arch] = res
        if arch == DP_SMOKE[0][0]:
            mgr = manager.CheckpointManager(os.path.join(tmp, "ckpt"))
            out["saved"] = mgr.save(state, step=2, shardings=shards)
            mgr.close()
            out["remesh"] = dp_remeshed(cfg, os.path.join(tmp, "ckpt"),
                                        DP_REMESH[0], device)
        del params, opt, state
    torch.cuda.empty_cache()

    # serve_mesh (a): the smoke cases' sharded prefill and decode, timed
    # apart from the launch wall that (b) reports
    t0 = time.perf_counter()
    out["serve"] = serve_mesh_smoke_rank(device, mesh, tmp)
    out["serve_s"] = time.perf_counter() - t0

    # (b) full size through the trainer
    cfg = configs.get_config(DP_FULL["arch"])
    records, kept = [], {}
    # host seconds in the step's per-layer parameter gathers, their
    # gradients' reduce-scatters and the tensor-parallel psums (each ended
    # by a device wait)
    spent = {"gather_s": 0.0, "reduce_s": 0.0, "psum_s": 0.0}
    at_start = {}

    def timer(key):
        def wrap(fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(*args, **kwargs)
                torch.cuda.synchronize()
                spent[key] += time.perf_counter() - t0
                return res
            return run
        return wrap

    def timed(make):
        def make_timed(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(*a):
                torch.cuda.synchronize()
                if not records:
                    # the steps' peak, not the trainer's set-up (its f32
                    # draw of the largest leaf, 3.35 GB, outweighs a
                    # step), and what the card holds besides the step's
                    # params and moments
                    at_start["held"] = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                before = dict(spent)
                t0 = time.perf_counter()
                res = step(*a)
                loss = res[0].detach().cpu()
                torch.cuda.synchronize()
                records.append({"loss": loss, "wall":
                                time.perf_counter() - t0,
                                "norm": float(step.last["grad_norm"]),
                                "counts": dict(ops.launch_counts()),
                                **{k: v - before[k]
                                   for k, v in spent.items()}})
                return res
            return run
        return make_timed

    ops.reset_counts()
    with wrapped(train_mod.steps_mod, "make_train_step", timed), \
            wrapped(ops, "ssd_scan", keep_first_call(kept, "ssd_scan")), \
            wrapped(tp.Gather, "forward", timer("gather_s")), \
            wrapped(tp.Gather, "backward", timer("reduce_s")), \
            wrapped(tp, "_psum", timer("psum_s")):
        params, opt, losses = train_mod.train(
            cfg, steps=DP_FULL["steps"], seq=DP_FULL["seq"],
            global_batch=DP_FULL["batch"], dp=DP_FULL["dp"], ckpt_dir=None,
            seed=0, log_every=100, mesh=mesh)
    total = {k: v for k, v in ops.launch_counts().items() if v}
    prev = {}
    for rec in records:
        rec["step_counts"] = {k: v - prev.get(k, 0)
                              for k, v in rec["counts"].items()
                              if v - prev.get(k, 0)}
        prev = rec.pop("counts")
    resting = sum(t.numel() * t.element_size() for t in
                  adamw.leaves(params) + adamw.leaves(opt["m"])
                  + adamw.leaves(opt["v"]) + [opt["step"]])
    out["full"] = {"records": records, "total": total,
                   "resting": resting,
                   "want_resting": dp_expected_bytes(cfg, mesh),
                   "params": sum(p.numel() for p in adamw.leaves(
                       transformer.param_shapes(cfg))),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "peak": torch.cuda.max_memory_allocated(),
                   # held at the first step besides its params and
                   # moments (the batch's few kB too)
                   "base": at_start["held"] - resting}
    if mesh.rank == 0:
        args, kwargs = kept["ssd_scan"]
        torch.save(([a.detach().cpu() for a in args[:5]],
                    {"chunk": kwargs["chunk"]}),
                   os.path.join(tmp, "ssd_call.pt"))
    return out


def dp_remesh_rank(device, tmp: str, shape) -> dict:
    """One rank of the second launch: the saved smoke state remeshed."""
    from repro_torch import configs
    return dp_remeshed(configs.get_smoke_config(DP_SMOKE[0][0]),
                       os.path.join(tmp, "ckpt"), shape, device)


def dp_full_single() -> tuple:
    """Step 0 of DP_FULL in one process on the card, on the trainer's
    first batch and weights (the loader and ``init_params`` from seed
    0): (loss, global grad norm)."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    cfg = configs.get_config(DP_FULL["arch"])
    params = transformer.init_params(cfg, seed=0, device=DEVICE)
    loader = pipeline.BalancedLoader(
        vocab_size=cfg.vocab_size, dp=DP_FULL["dp"],
        batch_per_shard=DP_FULL["batch"] // DP_FULL["dp"],
        seq=DP_FULL["seq"], seed=0)
    batch = train_mod.batch_on(DEVICE, *loader.next_batch())
    loss, grads = steps.value_and_grad(steps.make_loss_fn(cfg), params,
                                       batch)
    norm = float(adamw.global_norm(grads))
    for p in adamw.leaves(params):
        p.requires_grad_(False)
    del params, grads, batch
    torch.cuda.empty_cache()
    return float(loss), norm


def check_dp_smoke(out: list, single: dict, smi: str) -> None:
    """(a): every rank's losses, grad norms and gathered params against
    the single-process step, every rank the same bits."""
    for arch, _ in DP_SMOKE:
        ref = single[arch]
        res = [o["smoke"][arch] for o in out]
        r0 = res[0]
        check(all(all(torch.equal(a, b) for a, b in zip(r["losses"],
                                                        r0["losses"]))
                  and r["norms"] == r0["norms"]
                  and all(torch.equal(r["whole"][k], r0["whole"][k])
                          for k in r0["whole"]) for r in res),
              f"dp_train {arch}: every rank's loss, grad norm and gathered "
              f"state bitwise the same")
        loss = [float(x) for x in r0["losses"]]
        rel_l = max(abs(a - b) / abs(b) for a, b in zip(loss, ref["losses"]))
        rel_n = max(abs(a - b) / b for a, b in zip(r0["norms"],
                                                   ref["norms"]))
        worst, worst_tiny, n_tiny = 0.0, 0.0, 0
        for k, want in ref["params"].items():
            d = (r0["whole"]["params/" + k] - want).abs()
            tiny = torch.zeros_like(d, dtype=torch.bool)
            for m in ref["m"]:
                tiny |= m[k].abs() < DP_TINY_M
            worst = max(worst, float(d[~tiny].max()) if (~tiny).any()
                        else 0.0)
            if tiny.any():
                worst_tiny = max(worst_tiny, float(d[tiny].max()))
                n_tiny += int(tiny.sum())
        print(f"  (a) {arch} smoke, {DP['shape']} mesh, 2 steps ({smi}): "
              f"losses {loss} vs one process {ref['losses']} (rel "
              f"{rel_l:.3e}); grad norms {r0['norms']} vs {ref['norms']} "
              f"(rel {rel_n:.3e}); params max abs diff {worst:.3e}, "
              f"{n_tiny} elements under the first-moment exception (max "
              f"{worst_tiny:.3e})")
        check(rel_l <= DP_LOSS_RTOL, f"dp_train {arch}: loss {rel_l:.3e} "
              f"<= {DP_LOSS_RTOL:g} relative to one process")
        check(rel_n <= DP_NORM_RTOL, f"dp_train {arch}: grad norm "
              f"{rel_n:.3e} <= {DP_NORM_RTOL:g} relative")
        check(worst <= DP_PARAM_ATOL and worst_tiny <= 2 * DP_LR * 2,
              f"dp_train {arch}: params {worst:.3e} <= {DP_PARAM_ATOL:g} "
              f"(first moment under {DP_TINY_M:g} after a step: "
              f"{worst_tiny:.3e} <= 2 lr a step)")


def check_dp_remesh(res: list, shape, saved: str) -> None:
    walls = [round(r["wall"], 3) for r in res]
    print(f"  (a) remesh of {saved} onto {shape}: {len(res)} ranks, "
          f"{res[0]['leaves']} leaves each, walls {walls} s, on "
          f"{res[0]['device']}")
    check(all(r["step"] == 2 and not r["bad"] and r["device"] != "cpu"
              for r in res),
          f"dp_train remesh onto {shape}: every rank's blocks on the card "
          f"bitwise slices of the saved arrays (mismatched: "
          f"{[r['bad'] for r in res]})")


def check_dp_full(out: list, single: tuple, wall: float, smi: str) -> None:
    """(b): step 0 against one process, launches a step, resting bytes,
    every rank's loss bits."""
    from repro_torch import configs

    cfg = configs.get_config(DP_FULL["arch"])
    want = expected_train_launches(cfg)
    fulls = [o["full"] for o in out]
    f0 = fulls[0]
    loss0 = float(f0["records"][0]["loss"])
    norm0 = f0["records"][0]["norm"]
    lp, np_ = single
    for o in out:
        f = o["full"]
        print(f"  (b) rank {o['rank']}: step walls "
              f"{[round(r['wall'], 3) for r in f['records']]} s (in the "
              f"per-layer gathers "
              f"{[round(r['gather_s'], 3) for r in f['records']]}, in their"
              f" reduce-scatters "
              f"{[round(r['reduce_s'], 3) for r in f['records']]}, in the "
              f"tensor-parallel psums "
              f"{[round(r['psum_s'], 3) for r in f['records']]}), losses "
              f"{[round(float(r['loss']), 6) for r in f['records']]}, "
              f"peak memory {f['peak_gb']:.2f} GB, resting params and "
              f"moments {f['resting'] / 1e9:.4f} GB (specs' share "
              f"{f['want_resting'] / 1e9:.4f} GB), launches a step "
              f"{[r['step_counts'] for r in f['records']]}")
    print(f"  (b) {DP_FULL['arch']} full size ({f0['params'] / 1e9:.3f} B "
          f"parameters, {cfg.dtype}), {DP['ranks']} ranks on {DP['shape']}, "
          f"batch {DP_FULL['batch']} x {DP_FULL['seq']}: launch wall "
          f"{wall:.2f} s, of which serve_mesh (a) "
          f"{max(o['serve_s'] for o in out):.2f} s (the slowest rank's), "
          f"without it {wall - max(o['serve_s'] for o in out):.2f} s; "
          f"step 0 loss {loss0:.6f} vs one process "
          f"{lp:.6f}, grad norm {norm0:.6f} vs {np_:.6f} ({smi})")
    check(abs(loss0 - lp) <= TRAIN_LOSS_TOL * abs(lp),
          f"dp_train {DP_FULL['arch']} step 0 loss vs one process: "
          f"{abs(loss0 - lp) / abs(lp):.3e} <= {TRAIN_LOSS_TOL:g}")
    check(abs(norm0 - np_) <= TRAIN_NORM_TOL * np_,
          f"dp_train {DP_FULL['arch']} step 0 grad norm vs one process: "
          f"{abs(norm0 - np_) / np_:.3e} <= {TRAIN_NORM_TOL:g}")
    check(all(r["step_counts"] == want for f in fulls
              for r in f["records"]) and len(f0["records"]) == DP_FULL[
                  "steps"],
          f"dp_train {DP_FULL['arch']}: every rank's launches each step "
          f"{want}")
    check(all(f["resting"] == f["want_resting"] for f in fulls),
          f"dp_train {DP_FULL['arch']}: each rank's resting bytes of "
          f"params and moments equal to the specs' share")
    check(all(torch.equal(r["loss"], r0["loss"]) and np.isfinite(
        float(r["loss"])) for f in fulls
        for r, r0 in zip(f["records"], f0["records"])),
        f"dp_train {DP_FULL['arch']}: every rank's losses finite and "
        f"bitwise the same")


def dp_ssd_rows(first_call, launches: dict) -> list:
    """``ssd_scan`` and its backward at a rank's shape (rank 0's first
    call of the dp_train run: its 32 heads of Mamba-2's 64 a row, 2 of
    the 4 rows a rank): against the plain versions there and on random
    values, timed beside the bound and the plain version; ``launches``
    is rank 0's count in that run."""
    args, kwargs = first_call
    args = tuple(a.to(DEVICE) for a in args)
    print(f"== kernels at a dp_train rank's shape: ssd_scan x "
          f"{tuple(args[0].shape)}, B/C {tuple(args[3].shape)}, chunk "
          f"{kwargs['chunk']}")
    return ssd_rank_rows(args, kwargs["chunk"], launches, "per_rank",
                         "rank 0")


def ssd_rank_rows(args, chunk: int, launches: dict, tag: str,
                  label: str) -> list:
    """``ssd_scan_{tag}`` and ``ssd_scan_bwd_{tag}`` at ``args``' shape:
    each against its plain version on ``args`` and on random values,
    two launches bitwise equal, timed beside the bound and the plain
    version."""
    from repro_torch.kernels import ref, ssd_scan

    x, _, _, B, _ = args
    shape = tuple(x.shape)
    gen = torch.Generator(device=DEVICE).manual_seed(29)
    rand = ssd_random(x.shape[0], B.shape[0], x.shape[1], x.shape[2],
                      B.shape[2], gen)
    err = max(ssd_compare(args, chunk, f"{label} {shape}"),
              ssd_compare(rand, chunk, f"random {shape}"))
    y1, s1 = ssd_scan.ssd_scan(*args, chunk=chunk)
    y2, s2 = ssd_scan.ssd_scan(*args, chunk=chunk)
    check(torch.equal(y1, y2) and torch.equal(s1, s2),
          f"ssd_scan {tag} {shape}: two launches bitwise equal")
    del y1, y2, s1, s2
    bound, by, ops_ms = ssd_bound(args, chunk)
    fwd = {"name": f"ssd_scan_{tag}", "ok": True, "route": "cuda",
           "source": SOURCES["ssd_scan"], "replaces": REPLACES["ssd_scan"],
           "launches": launches["ssd_scan"], "max_abs_err": err,
           "ms": time_ms(lambda: ssd_scan.ssd_scan(*args, chunk=chunk), 10),
           "plain_ms": time_ms(lambda: ref.ssd_scan_plain(
               *args, chunk=chunk, state=True), 2),
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "shape": list(shape), "dtype": str(x.dtype)[6:]}
    print(f"  ssd_scan_{tag}: kernel {fwd['ms']:.4f} ms, plain "
          f"{fwd['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by}), share "
          f"{bound / fwd['ms']:.3f}, {fwd['launches']} launches on rank 0")
    kw = {"chunk": chunk}
    err_b, _, kernel, plain, _, _ = bwd_compare(
        "ssd_scan", args, kw, gen, f"{label} {shape}")
    err_b = max(err_b, bwd_compare("ssd_scan", rand, kw, gen,
                                   f"random {shape}")[0])
    g1, g2 = kernel(), kernel()
    check(all(torch.equal(a, b) for a, b in zip(g1, g2)),
          f"ssd_scan backward {tag} {shape}: two launches bitwise equal")
    del g1, g2
    bound_b, by_b = bwd_bound("ssd_scan", args, kw)
    bwd = {"name": f"ssd_scan_bwd_{tag}", "ok": True, "route": "cuda",
           "source": BWD_SOURCES["ssd_scan"],
           "replaces": REPLACES["ssd_scan"], "pass": "backward",
           "launches": launches["ssd_scan_bwd"], "max_abs_err": err_b,
           "ms": median_ms(kernel, 7), "plain_ms": median_ms(plain, 3),
           "bound_ms": bound_b, "bound_by": by_b, "library_ms": None,
           "shape": list(shape), "dtype": str(x.dtype)[6:]}
    print(f"  ssd_scan_bwd_{tag}: kernel {bwd['ms']:.4f} ms (median), "
          f"plain {bwd['plain_ms']:.4f} ms, bound {bound_b:.4f} ms "
          f"({by_b}), share {bound_b / bwd['ms']:.3f}, {bwd['launches']} "
          f"launches on rank 0")
    del kernel, plain, rand
    torch.cuda.empty_cache()
    return [fwd, bwd]


# The LM kernels at a rank's share of serve_mesh (b)'s tensor-parallel
# path: RecurrentGemma-9B (16 query heads of 256 on one kv head, window
# 2048; 4096 RG-LRU channels) at 8 heads and 2048 channels a rank, its
# 2-way "model" axis.  Prefill shapes (4 rows of 4096) for the forwards,
# training shapes (2 rows of 4096) for the backwards.
RANK_ATTN_HEADS = 8
RANK_RGLRU_WIDTH = 2048
RANK_SERVED = "serve_mesh (b) rank 0, RecurrentGemma-9B on (1, 2)"


def phase_rank_kernels(launches: dict) -> list:
    """flash_attention and rglru_scan, forward and backward, at
    RANK_ATTN_HEADS heads and RANK_RGLRU_WIDTH channels a rank: against
    the plain versions on random values, two launches bitwise equal,
    timed beside the bound (attention beside SDPA's time, the same
    mask).  ``launches`` is each kernel's launches on rank 0 of
    serve_mesh (b) (its prefill's and its train step's), which each row
    carries, ``launches_from`` naming the run."""
    from repro_torch.kernels import ref, rglru_scan

    rows = []
    gen = torch.Generator(device=DEVICE).manual_seed(33)
    kw = {"causal": True, "window": 2048}
    heads = RANK_ATTN_HEADS
    print("== kernels at serve_mesh (b)'s tensor-parallel rank share")

    def draw_attn(b):
        return tuple(torch.randn(s, generator=gen, device=DEVICE).to(
            torch.bfloat16) for s in ((b * heads, 4096, 256),
                                      (b, 4096, 256), (b, 4096, 256)))
    rows.append(attention_shape_row(
        f"flash_attention_rank{heads}",
        f"RecurrentGemma-9B prefill, {heads} of 16 heads a rank",
        draw_attn(4), kw, launches["flash_attention"], heads))
    rows.append(attention_bwd_shape_row(
        f"flash_attention_bwd_rank{heads}",
        f"RecurrentGemma-9B training, {heads} of 16 heads a rank",
        draw_attn(2), kw, launches["flash_attention_bwd"], heads))
    torch.cuda.empty_cache()
    width = RANK_RGLRU_WIDTH

    def draw_rglru(b):
        a = torch.rand((b, 4096, width), generator=gen, device=DEVICE)
        return (0.5 + 0.5 * a, torch.randn((b, 4096, width), generator=gen,
                                           device=DEVICE))
    args = draw_rglru(4)
    err = rglru_compare(args, f"{width} channels a rank")
    bound, by = lm_bound("rglru_scan", args, {})
    rows.append({
        "name": f"rglru_scan_rank{width}", "ok": True, "route": "cuda",
        "source": SOURCES["rglru_scan"], "replaces": REPLACES["rglru_scan"],
        "launches": launches["rglru_scan"], "max_abs_err": err,
        "ms": time_ms(lambda: rglru_scan.rglru_scan(*args), 20),
        "plain_ms": time_ms(lambda: ref.rglru_scan_plain(*args), 2),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": list(args[0].shape), "dtype": "float32",
        "path": rglru_scan.last_path})
    r = rows[-1]
    print(f"  rglru_scan_rank{width} {tuple(args[0].shape)} ({r['path']} "
          f"path): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"bound {bound:.4f} ms ({by}), share {bound / r['ms']:.3f}")
    args = draw_rglru(2)
    err_b, _, kernel, plain, _, _ = bwd_compare(
        "rglru_scan", args, {}, gen, f"{width} channels a rank")
    g1, g2 = kernel(), kernel()
    check(all(torch.equal(a, b) for a, b in zip(g1, g2)),
          f"rglru_scan backward at {width} channels a rank: two launches "
          f"bitwise equal")
    del g1, g2
    bound, by = bwd_bound("rglru_scan", args, {})
    rows.append({
        "name": f"rglru_scan_bwd_rank{width}", "ok": True, "route": "cuda",
        "source": BWD_SOURCES["rglru_scan"],
        "replaces": REPLACES["rglru_scan"], "pass": "backward",
        "launches": launches["rglru_scan_bwd"], "max_abs_err": err_b,
        "ms": median_ms(kernel, 7), "plain_ms": median_ms(plain, 3),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": list(args[0].shape), "dtype": "float32"})
    r = rows[-1]
    print(f"  rglru_scan_bwd_rank{width} {tuple(args[0].shape)}: kernel "
          f"{r['ms']:.4f} ms (median), plain {r['plain_ms']:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), share {bound / r['ms']:.3f}")
    del kernel, plain, args
    torch.cuda.empty_cache()
    for r in rows:
        r["launches_from"] = RANK_SERVED
    return rows


def phase_dp_train(smi: str, peaks: dict | None = None) -> list:
    """Data-parallel training through ``make_train_step(mesh=)`` and
    ``train(mesh=)``: one launch of DP["ranks"] ranks sharing the card
    over gloo (host transport) for (a) and (b), one of two for the
    (1, 2) remesh.  Returns the per-rank ``ssd_scan`` rows; rank 0's
    peak memory in (b) lands in ``peaks`` as ``"dp_train"``."""
    import tempfile
    from repro_torch.runtime import mesh

    print(f"== dp_train: {DP['ranks']} ranks on one card over "
          f"{DP['backend']}, mesh {dict(zip(DP['axes'], DP['shape']))} "
          f"({smi})")
    with tempfile.TemporaryDirectory() as tmp:
        single = {arch: dp_smoke_single(arch, b, tmp)
                  for arch, b in DP_SMOKE}
        serve_single = serve_mesh_single(tmp)
        full = dp_full_single()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = mesh.launch(dp_train_rank, DP["ranks"], backend=DP["backend"],
                          args=(tmp,), timeout=MESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        print(f"  {DP['ranks']} ranks spawned, ran and joined in "
              f"{wall:.2f} s; mesh {out[0]['mesh']}")
        check(out[0]["mesh"]["transport"] == "host",
              f"dp_train: gloo with host transport: {out[0]['mesh']}")
        check_dp_smoke(out, single, smi)
        check(len({o["saved"] for o in out}) == 1,
              "dp_train: every rank saved the same checkpoint step")
        check_dp_remesh([o["remesh"] for o in out], DP_REMESH[0],
                        os.path.basename(out[0]["saved"]))
        t0 = time.perf_counter()
        two = mesh.launch(dp_remesh_rank, 2, backend=DP["backend"],
                          args=(tmp, DP_REMESH[1]), timeout=MESH_TIMEOUT_S)
        print(f"  2 ranks spawned, remeshed and joined in "
              f"{time.perf_counter() - t0:.2f} s")
        check_dp_remesh(two, DP_REMESH[1], os.path.basename(out[0]["saved"]))
        check_dp_full(out, full, wall, smi)
        if peaks is not None:
            f0 = out[0]["full"]
            keep_peak(peaks, "dp_train", DP_FULL["arch"], "train",
                      DP_FULL["batch"], DP_FULL["seq"], f0["base"],
                      measured=f0["peak"], mesh=DP["shape"], rank=0)
        check_serve_mesh_smoke(out, serve_single, smi)
        first = torch.load(os.path.join(tmp, "ssd_call.pt"))
    return dp_ssd_rows(first, out[0]["full"]["total"])


# serve_mesh: sharded prefill and decode on a process mesh
# (make_prefill_step(mesh=), make_serve_step(mesh=, cache_shapes=),
# serve_batch(mesh=)).  (a) runs inside dp_train's four-rank launch, (b)
# in a two-rank launch of its own after RecurrentGemma's serving.

# (a): the f32 smoke cases of tests/test_torch_serve_mesh.py, (name,
# arch, batch, prompt, decode steps, max_seq, the split stacks' layouts)
# on DP's ("data": 2, "model": 2) mesh: kv heads split (yi, olmoe, phi3),
# slots split (gemma3 at B = 2, recurrentgemma, whisper at B = 2 with a
# prompt of 8; gemma3_odd's full cache of 29 slots stays whole) or rows
# alone (gemma3 and whisper at B = 4, the "dp" profile; mamba2).
SERVE_MESH_SMOKE = (
    ("yi", "yi-6b", 4, 16, 8, 24, {"full": "heads"}),
    ("olmoe", "olmoe-1b-7b", 4, 16, 8, 24, {"full": "heads"}),
    ("phi3", "phi3-vision-4.2b", 4, 16, 8, 32, {"full": "heads"}),
    ("gemma3_dp", "gemma3-1b", 4, 20, 8, 28, {}),
    ("gemma3_seq", "gemma3-1b", 2, 20, 8, 28, {"full": "seq",
                                               "ring": "seq"}),
    ("gemma3_odd", "gemma3-1b", 2, 20, 9, 29, {"ring": "seq"}),
    ("recurrentgemma", "recurrentgemma-9b", 4, 20, 8, 28, {"attn": "seq"}),
    ("mamba2", "mamba2-1.3b", 4, 16, 8, 24, {}),
    ("whisper", "whisper-large-v3", 4, 16, 8, 24, {}),
    ("whisper_seq", "whisper-large-v3", 2, 8, 8, 24, {"self": "seq",
                                                      "cross_k": "seq"}))
# The CPU test's gate on f32 logits and cache leaves, max abs.
SERVE_MESH_ATOL = 1e-4
# (b): RecurrentGemma-9B at full width in bf16 on ("data": 1, "model": 2):
# its MQA ring of 2048 slots splits into two blocks of 1024; the serving
# phase's two longest prompts (PROMPT_LENS[:2], seed 0: ragged, the
# shorter left-padded), then ``steps`` greedy tokens.
SERVE_MESH_FULL = {"arch": "recurrentgemma-9b", "shape": (1, 2),
                   "prompts": PROMPT_LENS[:2], "steps": 8}
# A rank's peak with every rank holding the whole tree beside its blocks
# (NVIDIA H100 80GB HBM3, 700.00 W), and the most a rank of the
# tensor-parallel path may take: the blocks (8.52 GB), the prefill's
# activations and the caches.
SERVE_MESH_WHOLE_TREE_PEAK_GB = 38.30
SERVE_MESH_PEAK_GB = 22.0
# After serving, (b)'s two ranks take one tensor-parallel train step of
# RecurrentGemma-9B cut to one period (2 RG-LRU layers and an attention
# layer) at full width in bf16 on 2 rows of 4096, the backward kernels at
# a rank's 8 query heads and 2048 channels, held to one process.
SERVE_MESH_TRAIN = {"layers": 3, "batch": 2, "seq": 4096, "seed": 5}


def serve_mesh_train_batch(cfg) -> dict:
    c = SERVE_MESH_TRAIN
    rng = np.random.default_rng(c["seed"])
    toks = rng.integers(1, cfg.vocab_size, (c["batch"], c["seq"]))
    return {"tokens": torch.from_numpy(toks.astype(np.int64))}


def serve_mesh_train_cfg():
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(SERVE_MESH_FULL["arch"]),
                               num_layers=SERVE_MESH_TRAIN["layers"])


def serve_mesh_train_single() -> tuple:
    """The train step's loss and global grad norm in one process on the
    card (weights from seed 0)."""
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    cfg = serve_mesh_train_cfg()
    params = transformer.init_params(cfg, 0, device=DEVICE)
    loss, grads = steps.value_and_grad(
        steps.make_loss_fn(cfg), params,
        _to_device(serve_mesh_train_batch(cfg), DEVICE))
    norm = float(adamw.global_norm(grads))
    del params, grads
    torch.cuda.empty_cache()
    return float(loss), norm


def keep_outputs(store: list, made: list | None = None):
    """Wrap a step factory so each call's first output lands in
    ``store`` (and each step it makes in ``made``); the step's
    attributes (``logits_sharding``, ``layouts``) stay on the wrapper."""
    def wrap(make):
        def make_and_keep(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(*a):
                out = step(*a)
                store.append(out[0])
                return out
            run.__dict__.update(step.__dict__)
            if made is not None:
                made.append(run)
            return run
        return make_and_keep
    return wrap


def serve_mesh_inputs(cfg, b: int, s: int, seed: int) -> dict:
    """A smoke case's prefill batch: B prompts of S tokens, and frames or
    patches at EXTRAS_SCALE, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int64))}
    if cfg.frontend == "audio_stub":
        batch["frames"] = torch.from_numpy(EXTRAS_SCALE * rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model))).float()
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.from_numpy(EXTRAS_SCALE * rng.normal(
            size=(b, cfg.num_patches, cfg.d_model))).float()
    return batch


def serve_mesh_decode(serve, params, cache, logits, start: int, steps: int,
                      whole_logits=lambda x: x) -> dict:
    """Greedy decode of ``steps`` tokens after a prefill's ``logits``:
    each step's whole logits, tokens and cache (flat), on the CPU."""
    out = {"logits": [], "tokens": [], "caches": []}
    cur = torch.argmax(logits, -1)[:, None]
    for i in range(steps):
        blk, cache = serve(params, cache, cur, start + i)
        whole = whole_logits(blk)
        cur = torch.argmax(whole, -1)
        out["logits"].append(whole.float().cpu())
        out["tokens"].append(cur.cpu())
        out["caches"].append({k: v.cpu() for k, v in _flat(cache).items()})
    return out


def serve_mesh_single(tmp: str) -> dict:
    """Each smoke case in one process on the card: its weights (seed i)
    and batch saved under ``tmp`` for the ranks, then the prefill's
    logits, cache and kernel launches and each decode step's logits,
    tokens and cache."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.runtime import steps

    single = {}
    for i, (name, arch, b, s, n, max_seq, _) in enumerate(SERVE_MESH_SMOKE):
        cfg = configs.get_smoke_config(arch)
        params = transformer.init_params(cfg, seed=i, device=DEVICE)
        batch = serve_mesh_inputs(cfg, b, s, 100 + i)
        torch.save({"params": _cpu(params), "batch": batch},
                   os.path.join(tmp, f"serve_{name}.pt"))
        batch = _to_device(batch, DEVICE)
        ops.reset_counts()
        logits, cache = steps.make_prefill_step(cfg, max_seq=max_seq)(
            params, batch)
        torch.cuda.synchronize()
        res = {"launches": {k: v for k, v in ops.launch_counts().items()
                            if v},
               "prefill_logits": logits.cpu(),
               "prefill_cache": {k: v.cpu() for k, v in _flat(cache).items()}}
        res.update(serve_mesh_decode(steps.make_serve_step(cfg), params,
                                     cache, logits, served_positions(batch),
                                     n))
        single[name] = res
    return single


def serve_mesh_smoke_rank(device, mesh, tmp: str) -> dict:
    """(a) on one rank of dp_train's launch: each smoke case's sharded
    prefill (its kernel launches counted) and greedy decode steps (none
    launched), on the card."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding, steps

    res = {}
    for name, arch, b, s, n, max_seq, _ in SERVE_MESH_SMOKE:
        cfg = configs.get_smoke_config(arch)
        inputs = torch.load(os.path.join(tmp, f"serve_{name}.pt"))
        with sharding.use_mesh(mesh):
            pshard = sharding.named_shardings(mesh,
                                              transformer.param_specs(cfg))
        params = adamw.tree_map(
            lambda p, sh: sharding.local_block(p.to(device), sh).clone(),
            inputs["params"], pshard)
        batch = _to_device(inputs["batch"], device)
        ops.reset_counts()
        prefill = steps.make_prefill_step(cfg, mesh, max_seq)
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        r = {"launches": {k: v for k, v in ops.launch_counts().items()
                          if v},
             "device": str(adamw.leaves(cache)[0].device),
             "prefill_logits": logits.cpu(),
             "prefill_cache": {k: v.cpu() for k, v in _flat(cache).items()}}
        serve = steps.make_serve_step(cfg, mesh, prefill.cache_shapes)
        r["layouts"] = {k: v.dim for k, v in serve.layouts.items()}
        ops.reset_counts()
        r.update(serve_mesh_decode(
            serve, params, cache, logits, served_positions(batch), n,
            lambda x: sharding.gather(x, serve.logits_sharding)))
        torch.cuda.synchronize()
        r["decode_launches"] = {k: v for k, v in ops.launch_counts().items()
                                if v}
        res[name] = r
        del params, cache, prefill, serve
    mesh.kept.clear()               # the smoke configs' whole params
    torch.cuda.empty_cache()
    return res


def _max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check_serve_mesh_smoke(out: list, single: dict, smi: str) -> None:
    """(a): every rank's whole logits, tokens and cache blocks against
    the single process, the ranks' logits bits equal and ranks whose
    specs give the same block the same bits, each rank's prefill
    launches those of one single-process prefill and decode none."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.runtime import sharding, steps

    print(f"== serve_mesh (a): the f32 smoke cases on {DP['ranks']} ranks "
          f"of {dict(zip(DP['axes'], DP['shape']))} against one process "
          f"on the card ({smi})")
    mesh = sharding.AbstractMesh(DP["shape"], DP["axes"])
    for name, arch, b, s, n, max_seq, layouts in SERVE_MESH_SMOKE:
        cfg = configs.get_smoke_config(arch)
        ref = single[name]
        res = [o["serve"][name] for o in out]
        pre = ref["prefill_cache"]
        with sharding.use_mesh(mesh):
            specs = _flat(steps.cache_specs_tree(
                cfg, transformer.init_decode_cache(
                    cfg, b, max_seq, device="meta")))
        err_l, err_c, same = 0.0, 0.0, True
        for rank, r in enumerate(res):
            err_l = max([err_l, _max_abs(r["prefill_logits"],
                                         ref["prefill_logits"])]
                        + [_max_abs(a, c) for a, c in zip(r["logits"],
                                                          ref["logits"])])
            check(all(torch.equal(a, c) for a, c in zip(r["tokens"],
                                                        ref["tokens"])),
                  f"serve_mesh {name}: rank {rank}'s greedy tokens those "
                  f"of one process")
            for got, want in zip([r["prefill_cache"]] + r["caches"],
                                 [pre] + ref["caches"]):
                for k, blk in got.items():
                    sl = sharding.block_slices(sharding.NamedSharding(
                        mesh, specs[k]), want[k].shape, rank)
                    w = want[k][sl]
                    if k.endswith("pos"):
                        same &= torch.equal(blk, w)
                    else:
                        err_c = max(err_c, _max_abs(blk, w))
        held = {}
        for rank, r in enumerate(res):
            for k, blk in r["caches"][-1].items():
                sl = str(sharding.block_slices(sharding.NamedSharding(
                    mesh, specs[k]), ref["caches"][-1][k].shape, rank))
                if (k, sl) in held:
                    same &= torch.equal(held[(k, sl)], blk)
                held[(k, sl)] = blk
        print(f"  {name} ({arch}, B = {b}, prompt {s}, {n} steps, max_seq "
              f"{max_seq}): layouts {res[0]['layouts']}; logits max abs "
              f"{err_l:.3e}, cache blocks {err_c:.3e}; launches a rank "
              f"{[r['launches'] for r in res]} (one process "
              f"{ref['launches']}), decode {[r['decode_launches'] for r in res]}"
              f"; cache on {res[0]['device']}")
        check(all(r["layouts"] == layouts for r in res),
              f"serve_mesh {name}: split stacks {layouts}")
        check(err_l <= SERVE_MESH_ATOL and err_c <= SERVE_MESH_ATOL,
              f"serve_mesh {name}: logits and cache blocks within "
              f"{SERVE_MESH_ATOL:g} of one process")
        check(same and all(
            torch.equal(r["prefill_logits"], res[0]["prefill_logits"])
            and all(torch.equal(a, c) for a, c in zip(r["logits"],
                                                      res[0]["logits"]))
            for r in res),
            f"serve_mesh {name}: pos bitwise, every rank's logits and the "
            f"blocks ranks share the same bits")
        check(all(r["launches"] == ref["launches"] and ref["launches"]
                  and not r["decode_launches"]
                  and r["device"].startswith("cuda") for r in res),
              f"serve_mesh {name}: each rank's prefill launched "
              f"{ref['launches']}, one prefill's, and decode none")


def serve_mesh_full_single(cfg, params) -> dict:
    """(b)'s yardstick: ``serve_batch`` of the serving phase's prompts in
    one process on the card, SERVE_MESH_FULL["steps"] greedy tokens; the
    prefill's and each step's logits and the tokens, on the CPU."""
    from repro_torch.launch import serve
    from repro_torch.runtime import steps

    n = SERVE_MESH_FULL["steps"]
    prompts = draw_prompts(cfg, 0, SERVE_MESH_FULL["prompts"])
    reqs = [serve.Request(rid=i, prompt=p, max_new=n)
            for i, p in enumerate(prompts)]
    pre, dec = [], []
    with wrapped(steps, "make_prefill_step", keep_outputs(pre)), \
            wrapped(steps, "make_serve_step", keep_outputs(dec)):
        reqs, stats = serve.serve_batch(cfg, params, reqs,
                                        max_seq=max(map(len, prompts)) + n)
    torch.cuda.synchronize()
    print(f"== serve_mesh (b) yardstick: {cfg.name} in one process, "
          f"prefill {stats['prefill_s']:.4f} s, decode "
          f"{stats['decode_s'] / n * 1e3:.3f} ms a token")
    return {"logits": [pre[0].float().cpu()]
            + [x[:, 0].float().cpu() for x in dec],
            "tokens": [r.out for r in reqs]}


@contextlib.contextmanager
def timed_transport(mesh, spent: dict):
    """Time the mesh's transport steps for the block, each to a
    synchronised end, into ``spent`` by name: ``_wire`` (the copy to a
    pinned host buffer), ``_all_gather`` (gloo's collective) and
    ``_unwire`` (the copy back to the card)."""
    names = ("_wire", "_all_gather", "_unwire")

    def wrap(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return got
        return run

    for name in names:
        spent.setdefault(name, 0.0)
        setattr(mesh, name, wrap(name, getattr(mesh, name)))
    try:
        yield
    finally:
        for name in names:
            delattr(mesh, name)


def serve_mesh_full_rank(device) -> dict:
    """(b) on one rank: RecurrentGemma-9B's weights drawn as the serving
    phase draws them, this rank's blocks kept, the whole tree gathered
    once (timed), then ``serve_batch(mesh=)`` of the serving prompts."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding, steps, tp
    from repro_torch.runtime.mesh import ProcessMesh

    n = SERVE_MESH_FULL["steps"]
    mesh = ProcessMesh(SERVE_MESH_FULL["shape"], DP["axes"], device=device)
    cfg = configs.get_config(SERVE_MESH_FULL["arch"])
    base = torch.cuda.memory_allocated()
    with sharding.use_mesh(mesh):
        pshard = sharding.named_shardings(mesh, transformer.param_specs(cfg))
    full = transformer.init_params(cfg, 0, device=device)
    params = adamw.tree_map(
        lambda p, sh: sharding.local_block(p, sh).clone(), full, pshard)
    del full
    torch.cuda.empty_cache()
    # the peak of serving from the blocks (the whole weights drawn for
    # them are gone)
    torch.cuda.reset_peak_memory_stats()
    resting = sum(t.numel() * t.element_size() for t in adamw.leaves(params))
    parts = {}
    gathered = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_transport(mesh, parts), wrapped(tp.Gather, "forward",
                                               count_calls(gathered)):
        # the steps' shared tensor-parallel share: the blocks gathered
        # over their FSDP axes (none splits on ("data": 1, "model": 2))
        share = steps.tp_share(cfg, mesh)(params)
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    share_bytes = sum(t.numel() * t.element_size()
                      for t in adamw.leaves(share))
    del share
    gathered_gb = torch.cuda.memory_allocated() / 1e9
    prompts = draw_prompts(cfg, 0, SERVE_MESH_FULL["prompts"])
    reqs = [serve.Request(rid=i, prompt=p, max_new=n)
            for i, p in enumerate(prompts)]
    pre, dec, made = [], [], []
    ops.reset_counts()
    before = dict(mesh.counts)
    with wrapped(steps, "make_prefill_step", keep_outputs(pre)), \
            wrapped(steps, "make_serve_step", keep_outputs(dec, made)), \
            wrapped(tp.Gather, "forward", count_calls(gathered)):
        reqs, stats = serve.serve_batch(
            cfg, params, reqs, max_seq=max(map(len, prompts)) + n,
            mesh=mesh)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    collectives = {k: v - before[k] for k, v in mesh.counts.items()
                   if v != before[k]}
    logits = [pre[0].float().cpu()] + [
        sharding.gather(x, made[0].logits_sharding)[:, 0].float().cpu()
        for x in dec]
    # the same traffic again: the first prefill of a fresh process pays a
    # start-up cost that a serving process pays once
    again = [serve.Request(rid=i, prompt=p, max_new=n)
             for i, p in enumerate(prompts)]
    again, warm = serve.serve_batch(
        cfg, params, again, max_seq=max(map(len, prompts)) + n, mesh=mesh)
    mem = torch.cuda.memory_stats()
    peak, peak_gb = (torch.cuda.max_memory_allocated(),
                     torch.cuda.max_memory_allocated() / 1e9)
    on = str(adamw.leaves(params)[0].device)
    layouts = {k: (v.dim, v.start, v.stop, v.size)
               for k, v in made[0].layouts.items()}
    mesh.kept.clear()           # the serving share
    del params, made, pre, dec
    torch.cuda.empty_cache()
    train = serve_mesh_train_rank(mesh, device)
    return {"rank": mesh.rank, "gather_s": gather_s, "gather_parts": parts,
            "train": train,
            "param_gathers": len(gathered), "share_gb": share_bytes / 1e9,
            "prefill_s": stats["prefill_s"],
            "decode_ms": stats["decode_s"] / n * 1e3,
            "resting_gb": resting / 1e9, "gathered_gb": gathered_gb,
            "peak_gb": peak_gb, "peak": peak, "base": base,
            "reserved_gb": mem["reserved_bytes.all.peak"] / 1e9,
            "retries": mem["num_alloc_retries"],
            "launches": launches, "collectives": collectives,
            "layouts": layouts,
            "logits": logits, "tokens": [r.out for r in reqs],
            "warm": {"prefill_s": warm["prefill_s"],
                     "decode_ms": warm["decode_s"] / n * 1e3,
                     "tokens": [r.out for r in again]},
            "device": on}


def serve_mesh_train_rank(mesh, device) -> dict:
    """One tensor-parallel train step of SERVE_MESH_TRAIN on this rank:
    its loss, grad norm, wall and kernel launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding, steps

    cfg = serve_mesh_train_cfg()
    with sharding.use_mesh(mesh):
        pshard = sharding.named_shardings(mesh, transformer.param_specs(cfg))
    full = transformer.init_params(cfg, 0, device=device)
    params = adamw.tree_map(
        lambda p, sh: sharding.local_block(p, sh).clone(), full, pshard)
    del full
    torch.cuda.empty_cache()
    step = steps.make_train_step(cfg, adamw.AdamWConfig(), mesh=mesh)
    batch = _to_device(serve_mesh_train_batch(cfg), device)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, params, _ = step(params, adamw.adamw_init(params), batch)
    loss = loss.detach().cpu()
    torch.cuda.synchronize()
    out = {"loss": loss, "norm": float(step.last["grad_norm"]),
           "wall": time.perf_counter() - t0,
           "launches": {k: v for k, v in ops.launch_counts().items() if v}}
    del params
    torch.cuda.empty_cache()
    return out


def count_calls(store: list):
    """Wrap a function so each call appends its first argument's type
    name to ``store``."""
    def wrap(fn):
        def run(*args, **kwargs):
            store.append(type(args[0]).__name__)
            return fn(*args, **kwargs)
        return run
    return wrap


def serve_mesh_smoke_alone_rank(device, tmp: str) -> dict:
    """(a) in a launch of its own (``phase_serve_mesh(smoke=True)``)."""
    from repro_torch.runtime.mesh import ProcessMesh
    mesh = ProcessMesh(DP["shape"], DP["axes"], device=device)
    return {"serve": serve_mesh_smoke_rank(device, mesh, tmp)}


def phase_serve_mesh(smi: str, single: dict | None = None,
                     smoke: bool = False, peaks: dict | None = None) -> dict:
    """(b): RecurrentGemma-9B at full width in bf16 on two ranks sharing
    the card over gloo, held to ``single`` (the one-process run of
    :func:`serve_mesh_full_single`, drawn here when not given): the
    prefill's and the first decode step's logits within the arch's
    LM_PATHS logits gate, and each request's tokens equal up to the first
    step whose one-process top-2 logits lie within that gate.  With
    ``smoke`` (the phase run alone) (a) first, in a four-rank launch of
    its own instead of dp_train's.  Rank 0's peak memory in (b) lands
    in ``peaks`` as ``"serve_mesh"``.  Then (b)'s ranks take one
    tensor-parallel train step (SERVE_MESH_TRAIN) held to one process.
    Returns rank 0's kernel launches: the prefill's, and the train
    step's forward and backward ones."""
    import tempfile
    from repro_torch.runtime import mesh

    if smoke:
        with tempfile.TemporaryDirectory() as tmp:
            smoke_single = serve_mesh_single(tmp)
            out = mesh.launch(serve_mesh_smoke_alone_rank, DP["ranks"],
                              backend=DP["backend"], args=(tmp,),
                              timeout=MESH_TIMEOUT_S)
            check_serve_mesh_smoke(out, smoke_single, smi)
    if single is None:
        from repro_torch import configs
        from repro_torch.models import transformer
        cfg = configs.get_config(SERVE_MESH_FULL["arch"])
        params = transformer.init_params(cfg, 0, device=DEVICE)
        single = serve_mesh_full_single(cfg, params)
        del params
        torch.cuda.empty_cache()
    train_single = serve_mesh_train_single()
    arch = SERVE_MESH_FULL["arch"]
    gate = LM_PATHS[arch]["gates"]["logits"]
    want = LM_PATHS[arch]["launches"]
    ranks = int(np.prod(SERVE_MESH_FULL["shape"]))
    print(f"== serve_mesh (b): {arch} full width, bf16, {ranks} ranks on "
          f"one card over {DP['backend']}, mesh "
          f"{dict(zip(DP['axes'], SERVE_MESH_FULL['shape']))}, prompts "
          f"{SERVE_MESH_FULL['prompts']}, {SERVE_MESH_FULL['steps']} greedy "
          f"tokens ({smi})")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = mesh.launch(serve_mesh_full_rank, ranks, backend=DP["backend"],
                      timeout=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for r in out:
        print(f"  rank {r['rank']}: blocks {r['resting_gb']:.4f} GB at "
              f"rest, its tensor-parallel share {r['share_gb']:.4f} GB "
              f"({r['param_gathers']} parameter gathers in all), "
              f"{r['gathered_gb']:.4f} GB allocated after the share, peak "
              f"{r['peak_gb']:.4f} GB against {SERVE_MESH_WHOLE_TREE_PEAK_GB} GB "
              f"with the whole tree (reserved "
              f"{r['reserved_gb']:.4f} GB, {r['retries']} allocation "
              f"retries); the share "
              f"{r['gather_s']:.3f} s (copies to pinned host buffers "
              f"{r['gather_parts']['_wire']:.3f} s, gloo's all-gathers "
              f"{r['gather_parts']['_all_gather']:.3f} s, copies back "
              f"{r['gather_parts']['_unwire']:.3f} s), prefill {r['prefill_s']:.4f} s, "
              f"decode {r['decode_ms']:.3f} ms a token (run again: "
              f"{r['warm']['prefill_s']:.4f} s, {r['warm']['decode_ms']:.3f} "
              f"ms); launches in the first run "
              f"{r['launches']}; collectives {r['collectives']}; layouts "
              f"{r['layouts']}")
    print(f"  {ranks} ranks spawned, ran and joined in {wall:.2f} s")
    r0 = out[0]
    if peaks is not None:
        keep_peak(peaks, "serve_mesh", arch, "prefill",
                  len(SERVE_MESH_FULL["prompts"]),
                  max(SERVE_MESH_FULL["prompts"]), r0["base"],
                  measured=r0["peak"],
                  mesh=SERVE_MESH_FULL["shape"], rank=0)
    check(all(r["launches"] == want and r["device"].startswith("cuda")
              for r in out),
          f"serve_mesh (b): each rank's params on the card and its prefill "
          f"launched {want}, one prefill's, decode none")
    check(all(r["param_gathers"] == 0 and abs(r["share_gb"] - r[
        "resting_gb"]) < 1e-9 for r in out),
        "serve_mesh (b): no parameter gathered (no FSDP axis splits on "
        "(1, 2)); each rank's share its blocks, no whole tree")
    check(all(r["peak_gb"] <= SERVE_MESH_PEAK_GB for r in out),
          f"serve_mesh (b): each rank's peak "
          f"{max(r['peak_gb'] for r in out):.2f} GB <= "
          f"{SERVE_MESH_PEAK_GB} GB")
    blocks = sorted(r["layouts"]["attn"][1:] for r in out
                    if list(r["layouts"]) == ["attn"])
    check(len(blocks) == ranks and all(
        r["layouts"]["attn"][0] == "seq" for r in out) and all(
        a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        and blocks[0][0] == 0 and blocks[-1][1] == blocks[-1][2],
        f"serve_mesh (b): the ring cache's slots split over 'model', a "
        f"block a rank: {blocks}")
    check(all(all(torch.equal(a, b) for a, b in zip(r["logits"],
                                                     r0["logits"]))
              and r["tokens"] == r0["tokens"] == r["warm"]["tokens"]
              for r in out),
          "serve_mesh (b): every rank's logits and tokens the same bits, "
          "the run again the same tokens")
    rels = [float((a - c).abs().max() / c.abs().max())
            for a, c in zip(r0["logits"], single["logits"])]
    print(f"  logits max abs diff / max abs against one process, prefill "
          f"then each step: {[f'{x:.3e}' for x in rels]}")
    check(rels[0] <= gate and rels[1] <= gate,
          f"serve_mesh (b): prefill and first decode logits within {gate:g} "
          f"of one process ({rels[0]:.3e}, {rels[1]:.3e})")
    held = []
    for i, (got, ref) in enumerate(zip(r0["tokens"], single["tokens"])):
        upto = len(ref)
        for t, lg in enumerate(single["logits"][:len(ref)]):
            top = torch.topk(lg[i], 2).values
            if float(top[0] - top[1]) <= gate * float(lg.abs().max()):
                upto = t
                break
        held.append(upto)
        check(got[:upto] == ref[:upto],
              f"serve_mesh (b): request {i}'s tokens equal to one "
              f"process's up to step {upto} (the first near tie)")
    print(f"  tokens held equal up to steps {held}; mesh {r0['tokens']}, "
          f"one process {single['tokens']}")
    tcfg = serve_mesh_train_cfg()
    lp, np_ = train_single
    t0_ = r0["train"]
    print(f"  train step ({tcfg.num_layers} layers at full width, bf16, "
          f"{SERVE_MESH_TRAIN['batch']} x {SERVE_MESH_TRAIN['seq']}): "
          f"walls {[round(r['train']['wall'], 3) for r in out]} s, loss "
          f"{float(t0_['loss']):.6f} vs one process {lp:.6f}, grad norm "
          f"{t0_['norm']:.6f} vs {np_:.6f}, launches a rank "
          f"{[r['train']['launches'] for r in out]} ({smi})")
    check(all(torch.equal(r["train"]["loss"], t0_["loss"])
              and r["train"]["norm"] == t0_["norm"]
              and r["train"]["launches"] == expected_train_launches(tcfg)
              for r in out),
          f"serve_mesh (b) train step: every rank's loss and grad norm the "
          f"same bits, launches {expected_train_launches(tcfg)}")
    check(abs(float(t0_["loss"]) - lp) <= TRAIN_LOSS_TOL * abs(lp)
          and abs(t0_["norm"] - np_) <= TRAIN_NORM_TOL * np_,
          f"serve_mesh (b) train step vs one process: loss "
          f"{abs(float(t0_['loss']) - lp) / abs(lp):.3e} <= "
          f"{TRAIN_LOSS_TOL:g}, grad norm {abs(t0_['norm'] - np_) / np_:.3e}"
          f" <= {TRAIN_NORM_TOL:g}")
    # the prefill's forward launches, the train step's backward ones
    return dict(r0["train"]["launches"], **r0["launches"])


# dryrun: the runs whose peak memory the trace predicts, each within
# DRYRUN_TOL of the card's max_memory_allocated; the cells of the
# single-pod report the phase traces and prints: Mixtral-8x22B's serving
# cells, a few seconds each (the 40-cell sweep takes minutes of the host,
# Mixtral's train_4k alone 100 s), which fit a rank's card with
# tensor-parallel compute (372-1975 GB a rank with the whole tree).
DRYRUN_RUNS = ("mamba2-1.3b", "olmoe-1b-7b", "recurrentgemma-9b",
               "dp_train", "serve_mesh")
DRYRUN_TOL = 0.05
DRYRUN_CELLS = tuple(("mixtral-8x22b", shape) for shape in
                     ("prefill_32k", "decode_32k", "long_500k"))


def keep_peak(peaks: dict, name: str, arch: str, kind: str, batch: int,
              seq: int, other: int, *, measured: int | None = None,
              layers: int | None = None, dtype: str | None = None,
              mesh=None, rank: int = 0) -> None:
    """File a run's peak memory (``measured``, this process's
    ``max_memory_allocated`` by default) under ``name`` in ``peaks`` with
    what the dry run needs to trace its step: the arch (cut to
    ``layers``, in ``dtype``), the step's kind and batch, the mesh's
    ("data", "model") shape and the rank (None: one process), and
    ``other``, the bytes the card held when the run began besides the
    step's own inputs."""
    peaks[name] = {"arch": arch, "layers": layers, "dtype": dtype,
                   "kind": kind, "batch": batch, "seq": seq, "mesh": mesh,
                   "rank": rank, "other": int(other),
                   "peak": int(torch.cuda.max_memory_allocated()
                               if measured is None else measured)}


def phase_dryrun(peaks: dict, smi: str) -> None:
    """The dry run's predicted peak memory of each run of DRYRUN_RUNS
    against the card's: ``lower_cell`` traces one step of the run's
    configuration and batch on ``meta`` (no flop count), in one process
    or on a ``TracedMesh`` of the run's mesh shape and rank, and the
    prediction, its peak plus the bytes the card held besides the step's
    inputs when the run began, must lie within DRYRUN_TOL of the run's
    ``max_memory_allocated``.  Then the single-pod report's rows of
    DRYRUN_CELLS (on ``meta``, no flop count): each one's peak a rank
    with the report's ``fits`` (80 GB) and against this card's
    ``total_memory``; each must fit both."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    print(f"== dryrun: predicted peak memory against the card's ({smi})")
    t0 = time.perf_counter()
    for name, rel in dryrun_predictions(peaks):
        check(abs(rel) <= DRYRUN_TOL,
              f"dryrun {name}: predicted peak within {DRYRUN_TOL:g} of the "
              f"card's ({rel:+.3f})")
    mesh = make_production_mesh()
    card = torch.cuda.get_device_properties(0).total_memory
    print(f"  single-pod dry run at full width on the {dict(mesh.shape)} "
          f"mesh, rank 0: peak a rank, fits (80 GB), fits this card "
          f"({card / 1e9:.2f} GB)")
    for arch, shape in DRYRUN_CELLS:
        row = dryrun.run_cell(arch, shape, mesh, False, verbose=False,
                              analysis=False)
        m = row["memory"]
        print(f"    {arch}|{shape}: {m['peak_per_device'] / 1e9:.2f} GB, fits "
              f"{m['fits']}, fits this card {m['peak_per_device'] <= card} "
              f"(trace {row['trace_s']} s)")
        check(m["fits"] and m["peak_per_device"] <= card,
              f"dryrun: {arch}|{shape} fits a rank's card")
    print(f"  dryrun phase {time.perf_counter() - t0:.1f} s")


def dryrun_predictions(peaks: dict) -> list:
    """Trace each run of DRYRUN_RUNS and print its prediction against
    the card's peak; returns [(run, relative error)]."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCase
    from repro_torch.launch import dryrun
    from repro_torch.runtime.mesh import TracedMesh
    from repro_torch.runtime.sharding import AbstractMesh

    held = []
    for name in DRYRUN_RUNS:
        p = peaks[name]
        cfg = configs.get_config(p["arch"])
        if p["layers"]:
            cfg = dataclasses.replace(cfg, num_layers=p["layers"])
        if p["dtype"]:
            cfg = dataclasses.replace(cfg, dtype=p["dtype"])
        mesh = (None if p["mesh"] is None else TracedMesh(
            AbstractMesh(tuple(p["mesh"]), DP["axes"]), rank=p["rank"]))
        case = ShapeCase(name, p["seq"], p["batch"], p["kind"])
        t1 = time.perf_counter()
        acc = dryrun.lower_cell(cfg, case, mesh, flops=False)
        mem = acc["memory"]
        pred = mem["peak_per_device"] + p["other"]
        rel = (pred - p["peak"]) / p["peak"]
        where = ("one process" if mesh is None else
                 f"rank {p['rank']} of {dict(mesh.shape)}")
        print(f"  {name}: {cfg.name}, {cfg.num_layers} layers, {cfg.dtype},"
              f" {p['kind']} {p['batch']} x {p['seq']}, {where}: traced "
              f"{mem['peak_per_device'] / 1e9:.3f} GB "
              f"({time.perf_counter() - t1:.1f} s) + held besides "
              f"{p['other'] / 1e9:.3f} GB = predicted {pred / 1e9:.3f} GB,"
              f" measured {p['peak'] / 1e9:.3f} GB, {rel:+.3f}")
        held.append((name, rel))
    return held


def phase_dryrun_alone(smi: str) -> None:
    """The dryrun phase in a call of its own: the five runs whose peaks
    it predicts (dp_train, serve_mesh (b), whose two ranks need the card
    free, then the trainer's three of DRYRUN_RUNS), then the phase."""
    peaks, kept = {}, {}
    phase_dp_train(smi, peaks)
    phase_serve_mesh(smi, peaks=peaks)
    for run in DRYRUN_RUNS[:3]:
        phase_train(run, smi, kept, peaks)
    phase_dryrun(peaks, smi)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this check runs "
              "only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.assim import EngineConfig

    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        print(f"== {time.perf_counter() - t_start:.1f} s: {what} done")

    smi = phase_environment()
    phase_build()

    paper = EngineConfig(n=2048, p=8, iters=120, track_reference=True)
    counts_1d, main_1d = phase_engine(
        "ex4_p8 (n=2048, p=8, m=2000, drifting_swarm, 6 cycles)", paper,
        "drifting_swarm", 2000, 6)
    shelf = EngineConfig(ndim=2, nx=64, ny=32, pr=2, pc=4, overlap=1,
                         damping=0.7, iters=120, track_reference=True)
    counts_2d, main_2d = phase_engine(
        "2D shelf 64x32, 2x4 cells, overlap 1, damping 0.7 "
        "(rotating_swarm, m=2000, 3 cycles)", shelf, "rotating_swarm",
        2000, 3)

    phase_kf(smi)
    phase_pint(smi)
    first_rank, uninterrupted = phase_shardmap(smi)
    phase_mesh_resume(smi, uninterrupted)
    del uninterrupted
    phase_fleet(smi)
    phase_resume(smi)
    peaks: dict = {}
    dp_rows = phase_dp_train(smi, peaks)
    dp_launches = {r["name"].replace("_per_rank", ""): r["launches"]
                   for r in dp_rows}
    stamp("sharded training")

    rows = phase_kernels([("ex4_p8", main_1d), ("shelf2d", main_2d)],
                         counts_1d)
    rows += shardmap_rows(first_rank) + dp_rows
    del first_rank
    phase_profile(paper, "drifting_swarm", 2000, 6)
    stamp("the DA paths")
    flex_warm = start_flex_warm()

    phase_lm_small("recurrentgemma-9b")
    counts_lm, params, cfg, batch, inputs, layer_errs = phase_lm_serve(
        "recurrentgemma-9b")
    phase_lm_profile(cfg, params, batch)
    rows += phase_lm_kernels(inputs, layer_errs, counts_lm, cfg.num_heads)
    serve_full = serve_mesh_full_single(cfg, params)
    del params, batch, inputs   # free the 17 GB of RecurrentGemma weights
    torch.cuda.empty_cache()
    stamp("RecurrentGemma-9B serving")
    tp_launches = phase_serve_mesh(smi, serve_full, peaks=peaks)
    del serve_full
    rows += phase_rank_kernels(tp_launches)
    stamp("sharded serving and the kernels at its rank share")

    phase_lm_small("mamba2-1.3b")
    counts_m, params, cfg, batch, inputs, layer_errs = phase_lm_serve(
        "mamba2-1.3b")
    phase_lm_profile(cfg, params, batch)
    del params, batch
    torch.cuda.empty_cache()
    rows.append(phase_ssd_kernels(inputs["ssd_scan"], layer_errs["ssd_scan"],
                                  counts_m))
    del inputs
    stamp("Mamba-2 serving")

    # The uniform attention stack: the six smoke configs, then Yi-6B and
    # OLMoE-1B-7B served at full width, each prefill's attention as a row.
    for arch in UNIFORM_ARCHS:
        phase_lm_small(arch)
    for arch, tag in (("yi-6b", "yi_6b_prefill"),
                      ("olmoe-1b-7b", "olmoe_prefill")):
        counts_u, params, cfg, batch, inputs, layer_errs = phase_lm_serve(
            arch)
        phase_lm_profile(cfg, params, batch)
        del params, batch
        torch.cuda.empty_cache()
        args, kwargs = inputs["flash_attention"]
        kwargs = {k: v for k, v in kwargs.items() if k != "mode"}
        rows.append(attention_shape_row(
            f"flash_attention_{tag}", f"{arch} prefill", args, kwargs,
            counts_u["flash_attention"], cfg.num_heads,
            layer_errs["flash_attention"]))
        del inputs, args
        torch.cuda.empty_cache()
    phase_padded_head_dim()
    phase_attention_d128()
    stamp("the uniform stack's serving")

    # whisper-large-v3 and phi-3-vision-4.2b: the smoke configs, then each
    # at full size, a row for each kind of its prefill's attention calls;
    # then flash_attention with S_kv != S and at head dimension 96.
    for arch in MODALITY_ARCHS:
        phase_lm_small(arch)
    for arch in MODALITY_ARCHS:
        rows += phase_modality_serve(arch)
    phase_cross_attention()
    stamp("whisper's and phi-3-vision's serving")

    # Soft-capped attention: gemma-7b at full width with the cap through
    # serving and training, then every capped kernel design; the examples.
    join_flex_warm(flex_warm)
    rows += phase_softcap_model(smi)
    rows += phase_softcap_calls()
    phase_examples()
    stamp("soft-capped attention and the examples")

    kept, train_counts = {}, {}
    for run in TRAIN_RUNS:
        train_counts.update(phase_train(run, smi, kept, peaks))
    phase_train_cli("recurrentgemma-9b")
    phase_train_cli("mamba2-1.3b")
    phase_clis(UNIFORM_ARCHS + MODALITY_ARCHS)
    stamp("training and the CLIs")
    rows += phase_train_kernels(kept, train_counts)
    # OLMoE's training attention in bf16, the run's dtype (its first call
    # was kept from step 0's f32 copy)
    args, kwargs = kept.pop("flash_attention_olmoe")
    args = tuple(a.detach().to(torch.bfloat16) for a in args)
    kwargs = {k: v for k, v in kwargs.items() if k in ("causal", "window")}
    rows.append(attention_shape_row(
        "flash_attention_olmoe_train", "olmoe-1b-7b training", args, kwargs,
        train_counts["flash_attention_olmoe"], 16))
    rows.append(attention_bwd_shape_row(
        "flash_attention_bwd_olmoe_train", "olmoe-1b-7b training", args,
        kwargs, train_counts["flash_attention_bwd_olmoe"], 16))
    rows += whisper_train_rows(kept, train_counts)
    phase_dryrun(peaks, smi)
    print(f"== done in {time.perf_counter() - t_start:.1f} s "
          f"(2D launches {counts_2d})")
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(warm_flex() if sys.argv[1:] == ["--warm-flex"] else main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
