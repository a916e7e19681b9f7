#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tneq_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card, imports nothing of
JAX or ``tneq_tpu``, and prints one JSON line per phase:

1. setup — the card's name and power limit (``nvidia-smi``), the kernels
   built from ``tneq_tpu_torch/csrc`` with ``nvcc`` (build time), TF32 off;
2. kernels — B1/B2 (``csrc/chain_sweep.cu``, thread-block-cluster
   kernels) against their plain PyTorch versions on the card at n = 29
   sites, S in {9, 256, 1024}, with the tolerances stated below; their
   times (CUDA events around one call, median, and the card's own time from
   torch.profiler, also per site), their launch plans (cluster size,
   shared memory) and bounds;
   Then row_gate_kernels — R1/R2, the row sweep's gate-step kernels
   (``csrc/row_gate.cu``, added for the row sweep: no Pallas kernel), against
   their plain versions at the brick cell's gate steps (8 lanes; every form
   of the 8 x 5 wall's plan, the gate conjugated or not, shared across the
   lanes or not, float32 once), d_gate bit for bit on a second launch, and
   their times beside the plain versions', the ``torch.einsum`` step they
   replace and the byte bound;
3. bench — the ``bench.py`` training program on the port: 32-qubit, bond-16
   MPS, float32, plain SGD lr 1e-3 on −log F, 200 steps; step-0 loss against
   the port's plain path on the host, falling loss, launch counts
   (B1 = 3, B2 = 2 per step), steps/s;
4. experiment — the symmetry-breaking experiment, MPS topology, network
   fidelity, end to end (target → validate → prune), plus a 20-step
   validation fit held against the same fit on the host;
5. transfer_kernels — the transfer-sweep kernels, B3 (float32) and B4
   (complex64, ``csrc/transfer_step.cu``), against their plain version at
   (B, D, K) in {(130, 3, 2), (32, 3, 3), (512, 8, 4), (4096, 16, 4)} (the
   narrow route; the last also timed on the wide route) and at the wide
   route's (32, 32, 32), (32, 64, 16), (32, 128, 4), (31, 40, 12) and
   (512, 64, 16), n in {1, 5} sites, and at the corners of the gate
   (bonds up to 256, physical ranks up to 64) (32, 256, 4), (32, 32, 64)
   and (32, 256, 64), n in {1, 2}; forward and the backward's d_env chain
   (the same kernel, sites reversed, cores transposed), with the plan and
   its route, the times (CUDA events around one call, and the card's own
   time from torch.profiler, also per site), the bound of the whole sweep
   on the CUDA cores and on the tensor cores (3xTF32) and, at n = 1, the
   time of the one ``torch.einsum`` call that computes a step;
6. born_rule — the Born-rule Trainer at full width: 8 qubits, bond 8,
   Hermite order 4, batch 512, float32, SGD-G, 200 steps; the losses of the
   first 20 steps against the host's loss at the card's cores, a falling
   loss, B3 = 2 launches per step (one 5-site sweep forward, one d_env
   sweep backward), B4 = 0; then the same trainer at bond 64, Hermite order
   16 (the wide route) for 5 steps: B3 = 2 per step, step 0's loss and
   probabilities against the host's; then at bond 8, Hermite order 72, batch
   32 (fault C4: past the gate's ranks) for 3 steps: strategy
   ``mps_sweep``, no B3/B4 launch, step 0 against the host;
7. cli — ``apps.train_single_node.main`` at its defaults (complex64, 8
   qubits, dim 3, batch 32, SGD-G), 200 steps; B4 = 2 launches per step,
   finite losses, the first 20 against the same run on the host; then
   ``--dim 32`` (complex64 cores of 256 KiB, the wide route), one warm step
   and 3 timed steps, B4 = 2 per step; then the CLI's trainer at bond 128,
   Hermite order 4 (fault C3) for 3 steps, B4 = 2 per step, step 0 against
   the host; then at bond 264 (fault C4: past the gate's bonds) for 3
   steps, strategy ``mps_sweep``, no launch, step 0 against the host, and
   ``use_kernel=True`` on that chain raising; then ``--profile DIR`` at
   the defaults, cut to 5 steps: the Chrome trace it writes names B4's
   ``transfer_sweep_kernel`` and holds one ``train_step`` span per step;
8. brick — the reference experiment's default at full width: the 8-qubit,
   5-cell, rank-2 brick wall (35 cores), complex64, SGD-G, dense fidelity,
   the planted 20-core mask.  Its dense target (4^8 entries) against the
   host's from the same cores; the validation fit at its default budget
   (<= 4000 steps, lr 1) to 1 - F < 1e-3; the first 20 validation losses
   against the host's loss at the card's cores; one pass of the prune loop
   warm-started at the planted network, its prune budget cut to
   ``BRICK_PRUNE_STEPS``, which must prune exactly the planted cores, as
   the same pass on the host does; fit steps/s, launches per fit step and
   the device idle share from torch.profiler; then the experiment's CLI at
   4 qubits x 2 cells in a process of its own, on the card and on the
   host, with the same result.  This path runs no kernel of the port:
   every contraction is pairwise ``torch.einsum`` steps;
9. brick_network — the brick wall in network fidelity mode (row sweep,
   rescaled pairwise steps; no kernel of the port).  (a) The 8 x 5
   default in complex64 with the planted 20-core mask: the first 20
   validation losses against the host's −log F at the card's cores; the
   first ``NETWORK_VALIDATE_STEPS`` steps of the validation fit (lr 1 on
   −log F does not converge in its 4000 steps, in JAX either), reported;
   at phase 8's validated cores, 1 − F from the row sweep in complex128,
   on the card and on the host, against the dense fidelity in complex128,
   and the card's complex64 value against them within its float32
   rounding; one prune pass warm-started at the planted network,
   ``NETWORK_PRUNE_STEPS`` steps per candidate, which must prune exactly
   the planted cores, as the same pass on the host does; fit steps/s,
   launches per fit step, idle share; one 8-lane piece of the batched
   prune, whose R1/R2 launches and einsum steps (``row_scan``'s counter)
   must equal the row plan's.  (b) The JAX flagship,
   32 x 5 in float32 (155 cores), built by ``bench/flagship.py``'s
   ``build_32q`` and ``problem_32q`` (``run_32q``'s experiment, mask,
   target and start), 30 validation steps from its start:
   −log F falls, matches the host's at three of those steps, 309 pairwise
   einsums per overlap; steps/s, launches, busy and idle share, top
   kernels, peak memory.  (c) The CLI with ``--fidelity-mode network`` at
   4 x 2 in a process of its own, on the card and on the host, with the
   same result;
10. batched — the batched prune (``symmetry_breaking_batched``: lockstep
   lanes under ``torch.func.vmap``), one JSON line per part.  (a), run
   right after phase 2: B1/B2 with a lane axis at the bench shape, 1 and 8
   lanes, against the plain version with the lane axis and against one
   launch per lane, one launch per sweep at any lane count, times per call
   and per lane, bounds; and B1 alone at the shapes of
   ``bench/pallas_decision``'s grid (32 qubits: 64 and 512 lanes at S =
   256, 64 lanes at S = 1024, n = 29), on the lanes' M-form, against
   plain, with its plan.  (b) The batched prune of the 8 x 5 dense wall
   (complex64, lane_chunk 8, k = 8) with one planted core, warm-started
   at its planted network: the accepted core and the attempts equal the
   host's, each lane's 1 - F at the card's lane params equals the host's;
   lane-steps/s, launches per lane step, idle share, peak memory.  (c) The
   same in network mode (k = 4), the lanes' -log F against the host's.  (d) Phase
   4's MPS experiment with ``--batched`` semantics: it prunes the planted
   [3, 7], B1/B2 launches per chunk step equal at 1 and 8 lanes.  (e) Pair
   mode: 20 prune steps from phase 8's validated cores in complex64-pair
   against complex64, and the CLI with ``--dtype complex64-pair
   --batched`` at 4 x 2 on card and host.  (f) One chunk of 8 lanes of
   the 32 x 5 float32 flagship in network mode: lane-steps/s, launches,
   peak memory;
11. inference — one JSON line per part.  (a) ``bench/large_n_probe`` at
   its defaults: a 64-qubit, bond-16 float32 MPS chain, 200 SGD steps on
   -log F (B1 = 3, B2 = 2 launches per step), step-0 -log F against the
   host's, a falling loss, then 32 draws of the target through the chain
   sampler, cold and warm: finite, in bounds, at least 8 distinct values,
   repeated bit for bit on the card and held against the host's from the
   same uniforms by JAX's bin-flip rule; fit steps/s, idle share, and
   B1/B2 against plain at that depth (n = 61, S = 256).  Then 128 qubits,
   cut to 50 fit steps: a falling loss, finite draws, B1/B2 at n = 125.
   (b) The README's Quick start at its width through ``EngineSiamese``:
   ``QCTN(wall_graph(8, layers=4, dim=2))``, complex64, a batch of 32:
   the contraction plain and scaled, the gradient (dict and list), the
   full, marginal and conditional probabilities and 256 draws at grid
   1000 (the generic env sampler), each against the host at the same
   inputs, with seconds cold and warm, launches per call and the largest
   pairwise step, and ``utils/plots.marginal_grid`` of qubits (0, 1) on its
   100 x 100 grid against the host's (whether matplotlib is present is
   printed; the PNG renderers need it).  (c) ``full_probability`` (pairwise einsum) against
   ``Trainer.probability`` (one B3 launch) on the born_rule cell, and log
   P at 30 qubits (cores x16), finite on the card where P is not, against
   the host's;
12. structure_search — the genetic structure search (no kernel of the
   port: every contraction is pairwise ``torch.einsum`` steps), one JSON
   line per part.  (a) ``apps.structure_search`` at its defaults (4-qubit
   full connection, population 8, 3 generations, 2 repeats as lanes, 100
   adam steps, ``overlap_mse``): every loss finite; the same search on a
   1-worker ``DeviceFarm`` on cuda:0, and one killed in generation 1 and
   resumed from its checkpoint, give the serial run's populations, losses
   within ``TOL_GA_FARM``.  (b) ``GA_r03.json``'s 30-qubit log-fidelity
   search (``mps_graph(30, dim=2)``, population 6, 2 repeats, elitism 1),
   cut to ``GA30_GENERATIONS`` generations of ``GA30_STEPS`` fit steps:
   finite losses, a best fitness that never rises; seconds per evaluation
   cold (a topology new to the chunk cache) and warm, the 2-lane chunk's
   fit steps/s, launches, idle share and largest pairwise step (with its
   lane axis) of one of its steps, peak memory; the last candidate's
   −log F at the card's cores against the host's.  (c) ``apps.merge_split_demo`` on the
   card: the cores are carried through split and merge;
13. sliced — bond-sliced overlaps over a ``model`` mesh axis on one card
   and checkpoints, one JSON line per part.  (a) Phase 9 (b)'s flagship
   with ``make_mesh({"model": 2}, devices=["cuda:0"] * 2)``: −log F at
   its fresh cores against the unsliced row sweep (``TOL_LANE``), one
   log-overlap's gradient against the unsliced one, 5 fit steps (steps/s,
   launches per step, idle share, peak memory beside phase 9 (b)'s), B1/B2
   never launched (the sliced fit turns the chain route off), and one step
   at 4 positions (two bonds).  (b) Two gloo ranks spawned on cuda:0, one
   per position: the sliced log-overlap value as (a)'s within float32
   rounding, each rank's summed gradient as the one-process gradient, 3 fit
   steps with bit-equal replicas.  (c) ``EngineSiamese(mesh=...)`` at the
   README Quick start's width against ``mesh=None``; with a ``{"data":
   1}`` mesh (fault C5) on a complex128 chain, no B3/B4 launch, and on
   the same cores in complex64 one B4 launch, each against ``mesh=None``;
   and the sliced CLI
   (``--slice-devices 2``) at 4 x 2 on card and host.  (d)
   ``train_single_node --save`` at its defaults (B4 = 2 launches per
   step), the file read back by ``QCTN.from_pretrained`` on the card bit
   for bit, and the cli cell's ``Trainer`` resumed from a
   ``CheckpointManager`` continuing the uninterrupted run's losses;
14. distributed — the rest of the parallel layer, one JSON line per part,
   with gloo ranks spawned on cuda:0.  (a) ``DistributedTrainer`` on the
   born_rule cell (``mps_graph(8, 8, phys=4)``, K 4, float32, batch 512,
   SGD-G), 20 steps in one process and on 2 ranks of 256 rows: each rank's
   step-0 loss and averaged gradient against one process, the replicas
   bit-equal, B3 2 launches per step per rank; steps/s, idle share, peak
   memory, the all-reduce's share of the step.  (b) ``python -m
   tneq_tpu_torch.parallel.trainer`` at its defaults (6-qubit MPS, dim 2,
   complex64): the card's loss against the host's at the card's cores, 100
   steps on card (B4 2 per step) and host, and ``--model-axis 2
   --checkpoint-dir ... --resume`` continuing the uninterrupted losses.
   (c) FSDP of the headline chain (``mps_graph(32, dim=16)``, 31 cores
   padded to 32) over ``{"model": 2}``, 10 steps in one process and on 2
   ranks: the step-0 loss and each rank's gradient rows against the
   unstacked ones, each rank's state at most 0.55 of one process's, the
   identity pad bit-exact, B1 3 and B2 2 launches per step; steps/s, idle
   share, peak memory.  (d) ``check_mesh_health`` over (a)'s ranks with
   each primitive's time and route, and the gloo primitives the port does
   not use, on CUDA tensors (point-to-point is refused, so the ring goes
   through ``broadcast``); bench stage 5 (``5_collectives``) on (a)'s
   ranks, its route table printed.  (e)
   ``parallel/dryrun.dryrun_multichip(2)`` on cuda:0 and
   ``bench/multiproc_dryrun``'s four ranks, its loss against one process;
15. bench_stages — the card's bf16 matmul ceiling (stage 2 at n = 8192),
   then ``bench/run_all`` in this process with ``--device cuda`` over stages
   1, 2, 2b, 3, 3b, 6, 6b, 7, 7b, 7c and 8 at the reference package's
   default sizes, one JSON line per stage: every stage ``ok``, no
   ``*_error`` key, no share of the H100's peak above 1.05, and B1/B2 at
   3/2 launches per step in 7b where S = D² <= 1024 (none at D = 64) and
   in every step of 8.
16. bench_runners — the runners and probes of ``tneq_tpu_torch/bench``,
   each cut in depth only, one JSON line per part.  Started first and run
   beside the rest: (a) ``flagship_protocol --mode pair --restarts 2`` on
   the card with a target cache, killed by a watcher once its first seed
   lands, and the same settings with ``--device cpu`` (4 threads); (h)
   ``python -m tneq_tpu_torch.bench.flagship --mode 32q`` at 8 validation
   and 8 prune steps, whose record's ``flops_per_step`` must equal
   ``flops_per_step_32q`` and whose −log F values must be finite.  In this process:
   (c) ``mps_flagship.run`` at its width (32 qubits, D = 128, target D = 32;
   no kernel: S = D² > 1024) and at D = 16, target D = 8, whose four warm
   fits must launch B1 2 per step plus 1 per fit and B2 2 per step; (d)
   ``chain_variants.run`` at the headline shape, 100 steps: every final
   loss within 1e-4 (relative) of ``direct``'s, the kernel variant
   (``pallas``) 3 B1 and 2 B2 launches per step, the others none; (e)
   ``stiefel_stall`` at 12 qubits, D = 8, checkpoints 16 and 32, seed 0:
   finite fidelities, B1 launches = B2 launches + one per fit; (f)
   ``chunk_probe`` at 32 x 5, K in (1, 4), 2 dispatches: finite −log F
   and the two-point split; (g) ``ga_floor`` at 30 qubits, ``--grown
   0,28``, 20 train and 40 deep steps: finite rows, no B1/B2 launch (the
   evaluator contracts by the pairwise executor, in JAX too).  Then (b)
   ``batched_compare --mode pair`` on (a)'s cached target once the card's
   first child has written it (both children hit the cache), beside (a)'s
   card protocol resumed after the watcher killed it: the resumed state
   holds seeds 0 and 1, seed 0's record unchanged; both states complete
   with one planted mask, and ``protocol_compare`` reads the card's state
   against the host's and against ``FLAGSHIP_protocol_pair_cpu.json``,
   which JAX's ``flagship_protocol`` wrote.  Then, alone on the card, (i)
   ``pallas_decision.run`` at JAX's grid (16 x 64, 16 x 512, 32 x 64 at 32
   qubits; 30 repeats, cut from 300): no variant errs, each lane's
   ``pallas`` value within 5e-5 and ``direct`` within 1e-4 (relative) of
   ``mform``'s, one B1 launch per repeat for ``pallas`` and none for the
   others.  The phase's B1/B2 launches must equal the sum of (c) D = 16,
   (d), (e) and (i)'s.

Then a ``timing`` line (seconds per phase), the ``kernels`` summary line,
the ``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
{...}}``.  Any failed check exits non-zero
before the last line.  Without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

# f32 tolerances, as max|kernel - plain| / max|plain| per output (f: over
# sum|u_n * w|, the scale of the dot product).  Kernel and plain version do
# the same f32 arithmetic in another summation order; 29 rescaled sites of
# S-term sums stay within a few 1e-6 of each other.
TOL_KERNEL = 5e-5
TOL_STEP0 = 1e-4  # bench step-0 loss, card vs host, relative
TOL_FIT = 1e-4  # 20-step validation fit, card vs host
SWEEP_N = 29  # middle sites of the 32-qubit chain
SWEEP_BONDS = (3, 16, 32)  # S = 9 (ragged), 256 (bench), 1024 (the cap)
BENCH_STEPS = 200
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores (dense)
# B3/B4 against their plain versions, per site: the same f32 sums in
# another order (3xTF32 products on the wide route, each 8-deep k-step
# added in float32)
TOL_STEP = 2e-5
STEP_SHAPES = ((130, 3, 2), (32, 3, 3), (512, 8, 4), (4096, 16, 4))  # (B, D, K)
ROUTE_SHAPE = (4096, 16, 4)  # timed on both routes
# the wide route: train_single_node --dim 32 (complex64), D = 64 at K = 16,
# fault C3's bond 128 at K = 4, a ragged (31, 40, 12), and a batch of 512
WIDE_SHAPES = ((32, 32, 32), (32, 64, 16), (32, 128, 4), (31, 40, 12), (512, 64, 16))
# the corners of the gate (ops/transfer_step.transfer_sweep_supported: bonds
# up to 256, physical ranks up to 64), at 1 and 2 sites, timed over
# EDGE_REPS calls.  A 2-site B4 sweep at (32, 256, 64) takes ~7 s on the
# wide route, so a kernel pass whose checked call takes HEAVY_MS or more
# runs once: its time is the CUDA events' around that call, which at such
# lengths equal the profiler's device time to 5 digits (and a one-call
# trace came back without device events, or with part of them, in a whole
# run)
EDGE_SHAPES = ((32, 256, 4), (32, 32, 64), (32, 256, 64))
EDGE_SITES = (1, 2)
EDGE_REPS = 5
HEAVY_MS = 100.0
# fault C4: chains past the gate take the kernel-free sweep ("mps_sweep");
# (B, D, K) of mps_graph(8, D, phys=K) in the born_rule and the cli phase
C4_F32_SHAPE = (32, 8, 72)
C4_C64_SHAPE = (32, 264, 4)
C4_STEPS = 3
WIDE_STEPS = 3  # timed steps of train_single_node --dim 32 in the cli phase
C3_SHAPE = (32, 128, 4)  # the cli phase's trainer at bond 128 (fault C3)
C3_STEPS = 3
WIDE_BORN_SHAPE = (512, 64, 16)  # the born_rule phase's trainer on the wide route
WIDE_BORN_STEPS = 5
BORN_SHAPE = (512, 8, 4)  # the born_rule phase's transfer steps
CLI_SHAPE = (32, 3, 3)  # the cli phase's
BORN_STEPS = 200
CLI_STEPS = 200
CHECK_STEPS = 20  # card-vs-host comparisons of the two training phases
MIDDLE_STEPS = 5  # sites of the transfer sweep of an 8-qubit chain
# the brick phase: the reference CLI's planted mask of the 8 x 5 wall, and
# the cuts that keep the phase near 100 s (the defaults are 5000 prune
# steps and, for the CLI, 20 restarts).  The prune pass starts at the
# planted network, where each planted candidate is accepted at once and
# each other one stays far above tol after its steps (1 - F >= 1e-2 after
# 60).
BRICK_MASK = [2, 3, 5, 8, 9, 12, 13, 14, 15, 17, 18, 20, 21, 23, 25, 26, 29, 31, 32, 33]
BRICK_PRUNE_STEPS = 20
BRICK_CLI_PRUNE_STEPS = 100
TOL_TARGET = 1e-5  # dense target, card vs host, max-abs-normalised
# 1 - F ~ 1e-3 at the validated cores, card vs host, absolute: F ~ 0.999 in
# float32 carries ~1e-7 of rounding per summation order
TOL_FIT_INFID = 5e-6
# network mode: the row sweep's 1 - F, on the card and on the host, against
# the dense fidelity, all in complex128; the card's complex64 1 - F against
# that, within ROUNDING_ULPS float32 epsilons of 2|log<t,o>| + |log<o,o>| +
# |log<t,t>| (each log-overlap is a sum of per-row log-scales, rounded in
# float32)
TOL_NETWORK_DENSE = 1e-9
ROUNDING_ULPS = 4
# the brick_network phase: the JAX flagship (bench/flagship.py::run_32q),
# cut to FLAGSHIP_STEPS validation steps (a cold 155-core wall needs tens
# of thousands; at lr 1 its -log F first rises: 46.37 -> 47.09 in 20
# steps, 44.61 in 30, on an H100); the card's -log F is held against the
# host's at FLAGSHIP_CHECK_AT; pairwise einsums per overlap of its row sweep
FLAGSHIP_QUBITS, FLAGSHIP_CELLS = 32, 5
FLAGSHIP_STEPS = 30
FLAGSHIP_CHECK_AT = (0, 14, 29)
FLAGSHIP_PAIRWISE = 309
# the network-mode CLI at 4 x 2: its first target stalls near F = 0.45
# (host rehearsal), so 400 validation steps, not 4000, reject it
NETWORK_CLI_VALIDATE_STEPS = 400
# the 8 x 5 network-mode fit is host-bound near 6-9 steps/s on an H100
# (700 W) and ~2 steps/s on the host.  At the default validation budget (4000
# steps, lr 1) -log F does not fall: 446 s, ending at 1 - F = 0.99999.  So
# the phase runs the first NETWORK_VALIDATE_STEPS of that fit, and its
# prune pass gives each candidate NETWORK_PRUNE_STEPS steps (accepted
# candidates exit at once, rejected ones stay far above tol), which the
# host repeats.
NETWORK_VALIDATE_STEPS = 25  # cut from 50 for the runners' phase
NETWORK_PRUNE_STEPS = 1
# the batched phase: lane-batched B1/B2 at the bench shape; the batched
# prune at lane_chunk 8 and k = 8 steps per exit test (4 in network mode,
# where a lane step takes ~0.35 s; 16 and 8 before the runners' phase was
# added), cut to one chunk of steps per piece
# (default 5000 prune steps), of the 8 x 5 wall with one
# planted core (the reference CLI plants 20), warm at its planted network:
# the planted lane is at F = 1, every other above 1 - F = 0.5 (host
# rehearsal), so the first round accepts it and the second none.  Launches
# and idle share are read from one vmapped step of a piece's lanes.
LANE_COUNTS = (1, 8)
LANE_CHUNK = 8
BATCHED_K = 8
FLAGSHIP_LANE_STEPS = 4  # (f): one chunk of the 32 x 5 flagship's lanes, cut from 16
BATCHED_K_NETWORK = 4
BATCHED_PLANTED = [5]
# a lane's metric at the card's lane params, card vs host: 1e-4 of
# max(1, |metric|) (-log F is a difference of O(1)..O(20) log-overlaps)
TOL_LANE = 1e-4
# complex64-pair vs complex64 on the card, 20 prune steps from phase 8's
# validated cores (1 - F ~ 1e-3): the same float32 sums in another order,
# at most 4 float32 epsilons of F ~ 1 apart in a host rehearsal; the bound
# is about 17
PAIR_STEPS = 20
TOL_PAIR = 1e-6
# the inference phase (11).  (a) large_n_probe at its defaults, 64 qubits,
# bond 16, 200 fit steps; then 128 qubits, cut to 50 fit steps (default
# 200).  Per fit step the three chain overlaps of -log F launch B1 three
# times and the two that need a gradient B2 twice (the target needs none).
LARGE_N = ((64, 200), (128, 50))  # (qubits, fit steps)
LARGE_N_BOND = 16
LARGE_N_SAMPLES = 32
LARGE_N_GRID = 200  # sample()'s default
LARGE_N_PER_STEP = {"chain_sweep_fwd": 3, "chain_sweep_bwd": 2}
MIN_DISTINCT = 8  # distinct draws at 3 decimals
# (b) the README's Quick start at its width: QCTN(wall_graph(8, layers=4,
# dim=2)), complex64, a batch of 32, K = 2; engine.sample of 256 draws at
# the engine's default grid of 1000
ENGINE_QUBITS, ENGINE_LAYERS, ENGINE_BATCH, ENGINE_SAMPLES = 8, 4, 32, 256
ENGINE_GRID = 1000
# card vs host at the same inputs: probabilities and losses, max-abs-
# normalised over the batch (a probability far below the batch's largest
# carries the rounding of the large terms it cancels); gradients the same
# over all cores.  Draws from the same uniforms by JAX's bin-flip rule:
# a row identical, or first apart by less than 4 grid bins; 3/4 identical.
TOL_INFER = 1e-4
FLIP_BINS = 4
# (c) full_probability (pairwise einsum) against Trainer.probability (B3)
# on the born_rule cell; log P at 30 qubits, cores x16, card vs host in log
TOL_LOG30 = 1e-3

# the structure-search phase (12).  (a) apps.structure_search at its
# defaults, serial, on a 1-worker DeviceFarm, and killed at its
# GA_CRASH_AT-th evaluation (generation 1: generation 0 has 8) and resumed:
# the same populations, losses within TOL_GA_FARM (the same device and
# seeds: expected bit for bit)
GA_SEED = 0
GA_CRASH_AT = 11
TOL_GA_FARM = 1e-5
# (b) GA_r03.json's 30-qubit log-fidelity search (docs/ROUND3.md), cut in
# depth to keep the part near 90 s: 2 of its 5 generations, 30 of its 300
# fit steps per candidate; a lane's -log F at the card's cores, card vs
# host, within TOL_GA30 of max(1, |-log F|) (a sum of 29 float32 log-scales)
GA30_QUBITS = 30
GA30_GENERATIONS = 2
GA30_STEPS = 20
TOL_GA30 = 1e-4

# the sliced phase (13): the flagship bond-sliced over a model axis on one
# card.  (a) -log F at the same cores, sliced vs the unsliced row sweep,
# within TOL_LANE of max(1, |-log F|); one log-overlap's gradient within
# TOL_SLICED_GRAD (max-abs-normalised); SLICED_STEPS fit steps timed; one
# step at SLICED_WIDE positions.  (b) two gloo ranks on cuda:0: the value
# within float32 rounding (TOL_RANK_VALUE of max(1, |value|)), each rank's
# summed gradient within TOL_RANK_GRAD of the one-process gradient,
# RANK_STEPS fit steps with bit-equal replicas.  (c) the engine with a mesh
# against mesh=None (TOL_INFER) and the sliced CLI at 4 x 2, card vs host.
# (d) train_single_node --save at its defaults; a Trainer resumed from a
# CheckpointManager continues the uninterrupted run's losses within
# TOL_RESUME (relative)
SLICED_POSITIONS = 2
SLICED_WIDE = 4
SLICED_STEPS = 5
TOL_SLICED_GRAD = 1e-4
RANK_STEPS = 3
TOL_RANK_VALUE = 1e-6
TOL_RANK_GRAD = 1e-5
RESUME_STEPS = 3
TOL_RESUME = 1e-5

# the distributed phase (14).  (a) the born_rule cell as a DistributedConfig,
# DP_STEPS steps in one process and on DP_WORLD gloo ranks sharing cuda:0:
# each rank's step-0 loss and gradient (its rows, averaged over the data
# line) within TOL_DP of one process (relative; the gradient max-abs
# normalised), the replicas bit-equal after the run, B3 2 launches per step
# per rank; the all-reduce timed alone over AR_REPS calls.  (b) the trainer
# CLI at its defaults: the card's loss within TOL_STEP0 of the host's at the
# card's cores for CHECK_STEPS steps, TRAINER_CLI_STEPS steps on the card
# (B4 2 per step) and on the host, and a model axis of 2 run to RESUME_AT[0]
# steps and resumed to RESUME_AT[1], its losses within TOL_RESUME of the
# uninterrupted run's.  (c) FSDP of the headline chain (31 cores padded to
# 32) on FSDP_POSITIONS positions, FSDP_STEPS steps, one process and as many
# gloo ranks: the step-0 loss and each process's gradient rows within
# TOL_FSDP of the unstacked ones (relative; max-abs normalised), each rank's
# stacked params and momentum at most FSDP_BYTES_SHARE of one process's,
# the identity pad bit-exact, B1 3 and B2 2 launches per step.  (d) the
# health check over (a)'s ranks (every check ok, the routes
# GLOO_CUDA_ROUTES), and gloo's GLOO_PROBES primitives on CUDA tensors,
# each group in a process pair of its own.  (e)
# dryrun_multichip on DRYRUN_POSITIONS positions of cuda:0, and
# bench/multiproc_dryrun's four ranks, its loss within TOL_RANK_VALUE of the
# same step in one process
DP_WORLD = 2
DP_STEPS = 20
AR_REPS = 10
TOL_DP = 1e-5
TRAINER_CLI_STEPS = 100
RESUME_AT = (6, 9)
FSDP_QUBITS, FSDP_BOND = 32, 16
FSDP_POSITIONS = 2
FSDP_STEPS = 10
TOL_FSDP = 1e-5
FSDP_BYTES_SHARE = 0.55
GLOO_PROBES = (("all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single"),
               ("send",), ("batch_isend_irecv",))
GLOO_CUDA_ROUTES = {"all_gather": "all_gather", "psum": "all_reduce", "ppermute": "broadcast"}
DRYRUN_POSITIONS = 2
# the cli phase's profiled run: train_single_node --profile at its defaults,
# cut to PROFILE_STEPS steps (the default 200 would trace ~43,000 launches)
PROFILE_STEPS = 5

# the bench_stages phase (15): run_all in-process over BENCH_STAGES at the
# reference package's default sizes (stage 5 runs on phase 14 (a)'s ranks);
# the card's bf16 matmul ceiling, stage 2 at n = CEILING_N; every share of
# the H100's peak at most SHARE_BOUND; B1/B2 launches per step of stages 7b
# (S = D^2 within the kernels' cap) and 8 as counted
BENCH_STAGES = ("1", "2", "2b", "3", "3b", "6", "6b", "7", "7b", "7c", "8")
CEILING_N = 8192
SHARE_BOUND = 1.05
SHARE_KEYS = ("peak_share", "hbm_share", "mxu_util", "peak_mxu_util")
SWEEP_PER_STEP = {"chain_sweep_fwd": 3, "chain_sweep_bwd": 2}
STAGE_COLLECTIVE_ROUTES = {"psum": "all_reduce", "all_gather": "all_gather",
                           "ppermute": "broadcast"}

# phase 16 (bench_runners): the runners of tneq_tpu_torch/bench, each cut in
# depth only (the reference defaults in the comments).  (a) the protocol in
# pair mode: 2 restarts (20), validation not cut (3000; its target validates
# in ~608 steps), 2 prune steps (2000) with an exit test every 2 (8), one
# outer pass (3); the host's run beside the card's with 4 threads
COMPARE_FLAGS = ("--mode", "pair", "--prune-steps", "2", "--sync-every", "2",
                 "--max-outer", "1")
PROTOCOL_FLAGS = COMPARE_FLAGS + ("--restarts", "2", "--retry-wait", "0", "--retries", "0")
PROTOCOL_HOST_THREADS = "4"
JAX_PROTOCOL_FILE = "FLAGSHIP_protocol_pair_cpu.json"  # written by tneq_tpu
# (c) mps_flagship at its width (32 qubits, D = 128, target D = 32) and at D =
# 16 / target 8 (B1/B2): validation (16000), prune (2000), passes (2) and
# exit tests (every 1024 steps) cut
MPS_RUNS = {
    "d128": ("--validate-steps", "32", "--prune-steps", "16", "--sync-every", "16"),
    "d16": ("--dim", "16", "--target-dim", "8", "--validate-steps", "400",
            "--prune-steps", "16", "--sync-every", "16", "--max-outer", "1"),
}
CHAIN_VARIANT_STEPS = 100  # 2000
TOL_VARIANT = 1e-4  # each variant's final loss against direct's, relative
STALL_FLAGS = ("--checkpoints", "16,32", "--seeds", "0")  # 250..4000; seeds 0,1
CHUNK_PROBE = {"chunks": [1, 4], "dispatches": 2}  # [1, 16], 4
GA_FLOOR_FLAGS = ("--grown", "0,28", "--train-steps", "20", "--deep-steps", "40")  # 300, 1500
FLAGSHIP_CHILD_FLAGS = ("--mode", "32q", "--validate-steps", "8", "--prune-steps", "8",
                        "--budget", "600")  # 3000, 2000
# (i) pallas_decision at JAX's default grid and width; repeats cut (300)
DECISION_QUBITS = 32
DECISION_CONFIGS = "16x64,16x512,32x64"  # (bond D x lanes B); S = 256, 256, 1024
DECISION_REPEATS = 30
TOL_DECISION_DIRECT = 1e-4  # direct's lane values against mform's, relative

_KERNELS = {
    "chain_sweep_fwd": {
        "id": "B1",
        "replaces": "tneq_tpu/ops/chain_overlap.py:160",
    },
    "chain_sweep_bwd": {
        "id": "B2",
        "replaces": "tneq_tpu/ops/chain_overlap.py:224",
    },
    "transfer_step": {
        "id": "B3",
        "replaces": "tneq_tpu/ops/pallas_kernels.py:91",
    },
    "transfer_step_complex": {
        "id": "B4",
        "replaces": "tneq_tpu/ops/pallas_kernels.py:177",
    },
    # the row sweep's gate steps: no Pallas kernel in JAX (XLA's dots), added
    # because cuBLAS runs their long-K gate gradients on 8 of 132 SMs
    "row_gate_fwd": {"id": "R1", "replaces": None},
    "row_gate_bwd": {"id": "R2", "replaces": None},
}


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one ``fn()`` on the card (CUDA events, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps: int = 20):
    """Device time of one ``fn()``: the CUDA kernels it launches, summed by
    torch.profiler over ``reps`` calls after a warm-up; ``None`` where the
    trace shows no device time.  At small shapes the CUDA-event time of
    :func:`cuda_ms` is the host's time to issue the call, and this is the
    card's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(ev.device_time_total for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)
        if total:
            return total / 1e3 / reps
    return None


def _bound(nbytes: float, flops: float) -> dict:
    """Least time on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32)."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"bound_ms": max(tb, tf) * 1e3,
            "bound_by": "bytes" if tb >= tf else "operations"}


def sweep_bounds(n: int, S: int, lanes: int = 1) -> dict:
    """B1/B2 over ``lanes`` sweeps: each input read once, each output
    written once, over the work the sweeps do."""
    fwd_bytes = lanes * 4 * (n * S * S + 2 * S + n * S + n + 2 + S)
    fwd_flops = lanes * 2 * n * S * S
    bwd_bytes = lanes * 4 * (S + n * S * S + n * S + n + n * S * S + S)
    bwd_flops = lanes * 3 * n * S * S
    return {"chain_sweep_fwd": _bound(fwd_bytes, fwd_flops),
            "chain_sweep_bwd": _bound(bwd_bytes, bwd_flops)}


def sweep_bound(n: int, B: int, D: int, K: int, complex_: bool) -> dict:
    """B3/B4 over an n-site sweep, env0 [B,D,D], a [n,D,K,D], mx [n,B,K,K]
    -> out [n,B,D,D]: bytes of the inputs and the outputs once; flops of
    the factorised step, 2 B (2 D^3 K + D^2 K^2) per site, four times as
    many for complex64."""
    elem = 8 if complex_ else 4
    nbytes = elem * (B * D * D + n * (D * K * D + B * K * K + B * D * D))
    flops = n * 2 * B * (2 * D ** 3 * K + D * D * K * K) * (4 if complex_ else 1)
    return _bound(nbytes, flops)


def tc_sweep_bound(n: int, B: int, D: int, K: int, complex_: bool) -> dict:
    """The wide route's least time for the sweep of :func:`sweep_bound`: the
    same bytes; its products on the tensor cores as 3xTF32 (three TF32
    products per product, at 495 TFLOP/s) and its float32 adds (one per
    output and 8-deep k-step: 1/16 of the flops) at 67 TFLOP/s."""
    elem = 8 if complex_ else 4
    nbytes = elem * (B * D * D + n * (D * K * D + B * K * K + B * D * D))
    flops = n * 2 * B * (2 * D ** 3 * K + D * D * K * K) * (4 if complex_ else 1)
    t = (nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS, flops / 16 / FP32_FLOPS)
    return {"tc_bound_ms": max(t) * 1e3,
            "tc_bound_by": ("bytes", "tensor cores", "operations")[t.index(max(t))]}


def rel_err(k, p, scale=None) -> float:
    denom = float(p.abs().max()) if scale is None else float(scale)
    return float((k - p).abs().max()) / max(denom, 1e-30)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_setup() -> dict:
    import torch

    from tneq_tpu_torch.ops import cuda_build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    libs = cuda_build.build()
    build_s = time.perf_counter() - t0
    for name in libs:
        print(f"--- nvcc log: {name} ---\n{cuda_build.build_log(name)}",
              file=sys.stderr, flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    rec = {
        "phase": "setup",
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "build_s": build_s,
        "libraries": sorted(str(p.name) for p in libs.values()),
        "tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    emit(rec)
    return rec


def _random_sweep(bond: int, n: int, seed: int, dev):
    """u0, M, w of the M-form of two random max-abs-normalised chains with
    ``n`` middle sites, physical rank 2, bond ``bond`` (S = bond²)."""
    import numpy as np
    import torch

    from tneq_tpu_torch.ops.chain_overlap import chain_pair_to_mv

    rng = np.random.default_rng(seed)

    def core(*shape):
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)
        return x / x.abs().max()

    def chain():
        mids = torch.stack([core(bond, 2, 2, bond) for _ in range(n)])
        return core(2, 2, 2, bond), mids, core(bond, 2, 2, 2)

    v0, M, w = chain_pair_to_mv(chain(), chain())
    u0 = v0 / v0.abs().max()
    return u0.contiguous(), M.contiguous(), w.contiguous()


def _sweep_case(bond: int, n: int, seed: int) -> dict:
    """B1/B2 against their plain versions on one random chain of ``n``
    middle sites, S = bond²: errors, times, launch plans and bounds."""
    import torch

    from tneq_tpu_torch.ops import chain_overlap as co

    dev = torch.device("cuda", 0)
    S = bond * bond
    u0, M, w = _random_sweep(bond, n, seed=seed, dev=dev)
    kf = co._sweep_fwd_cuda(u0, M, w)
    pf = co._sweep_fwd_plain(u0, M, w)
    torch.cuda.synchronize()
    names = ("ustack", "scales", "f", "logsum", "ulast")
    err = {nm: rel_err(k, p) for nm, k, p in zip(names, kf, pf)}
    err["f"] = rel_err(kf[2], pf[2], scale=(pf[4] * w).abs().sum())
    r0 = (1.7 * w).contiguous()
    kb = co._sweep_bwd_cuda(r0, M, pf[0], pf[1])
    pb = co._sweep_bwd_plain(r0, M, pf[0], pf[1])
    torch.cuda.synchronize()
    err["dM"] = rel_err(kb[0], pb[0])
    err["du0"] = rel_err(kb[1], pb[1])
    abs_fwd = max(float((k - p).abs().max()) for k, p in zip(kf, pf))
    abs_bwd = max(float((k - p).abs().max()) for k, p in zip(kb, pb))
    calls = {
        "chain_sweep_fwd": (lambda: co._sweep_fwd_cuda(u0, M, w),
                            lambda: co._sweep_fwd_plain(u0, M, w)),
        "chain_sweep_bwd": (lambda: co._sweep_bwd_cuda(r0, M, pf[0], pf[1]),
                            lambda: co._sweep_bwd_plain(r0, M, pf[0], pf[1])),
    }
    times, plans = {}, {}
    for name, (kernel, plain) in calls.items():
        dms = device_ms(kernel)
        times[name] = {
            "ms": cuda_ms(kernel),
            "device_ms": dms,
            "per_site_device_ms": dms / n if dms else None,
            "plain_ms": cuda_ms(plain),
            "plain_device_ms": device_ms(plain),
        }
        cluster, strip, stages, tile_rows, smem = co._plan_for(
            M, backward=name == "chain_sweep_bwd")
        plans[name] = {"cluster": cluster, "strip": strip, "ring_stages": stages,
                       "tile_rows": tile_rows, "smem_bytes": smem}
    bad = {k: v for k, v in err.items() if not v <= TOL_KERNEL}
    check(not bad, f"n={n}, S={S}: kernel disagrees with plain version beyond "
                   f"{TOL_KERNEL}: {bad}")
    return {"n": n, "S": S, "rel_err": err,
            "max_abs_err": {"chain_sweep_fwd": abs_fwd, "chain_sweep_bwd": abs_bwd},
            "times": times, "plans": plans, "bounds": sweep_bounds(n, S)}


def phase_kernels() -> dict:
    cases = [_sweep_case(bond, SWEEP_N, seed=bond) for bond in SWEEP_BONDS]
    rec = {"phase": "kernels", "tolerance": TOL_KERNEL, "cases": cases}
    emit(rec)
    return rec


def phase_row_gate_kernels() -> dict:
    """R1/R2 (``csrc/row_gate.cu``) against their plain versions at the
    brick cell's gate steps (8 lanes, complex64; every form, the gate
    conjugated or not, per lane or shared with lane stride 0; float32 once
    per form), the backward's d_gate bit for bit on a second launch; then
    their times at 8 lanes (B side: conjugated gate), the plain versions',
    the one ``torch.einsum`` step they replace (forward, and its autograd
    backward), and the byte bound (each input read once, each output
    written once; a diagonal step needs half its environment)."""
    import torch

    from tneq_tpu_torch.graph import build_brick_wall_incidence, incidence_to_graph, parse_graph
    from tneq_tpu_torch.ops import row_scan

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(24)
    lanes = LANE_CHUNK

    def rnd(shape, dtype=torch.complex64):
        return torch.randn(shape, dtype=dtype, device=dev, generator=gen)

    cases = []
    wall = parse_graph(incidence_to_graph(build_brick_wall_incidence(8, 5, 2)))
    for key, (eq, form) in row_scan.gate_forms(wall).items():
        name = str(key)  # (K, N, diagonal, big)
        es, gs, os_ = form.shape(form.e), form.shape(form.g), form.shape(form.o)
        errs = []
        for dtype, conj, shared in ((torch.complex64, False, False),
                                    (torch.complex64, True, False),
                                    (torch.complex64, True, True),
                                    (torch.float32, False, False)):
            env, dout = rnd((lanes,) + es, dtype), rnd((lanes,) + os_, dtype)
            gate = rnd(gs, dtype).expand((lanes,) + gs) if shared else rnd((lanes,) + gs, dtype)
            out = row_scan._gate_fwd_cuda(env, gate, form, conj)
            d_env, d_gate = row_scan._gate_bwd_cuda(env, gate, dout, form, conj, True, True)
            d_gate2 = row_scan._gate_bwd_cuda(env, gate, dout, form, conj, False, True)[1]
            ref = row_scan._gate_fwd_plain(env, gate, form, conj)
            r_env, r_gate = row_scan._gate_bwd_plain(env, gate, dout, form, conj, True, True)
            torch.cuda.synchronize()
            err = {"dtype": str(dtype).replace("torch.", ""), "conj": conj, "shared": shared,
                   "out": rel_err(out, ref), "d_env": rel_err(d_env, r_env),
                   "d_gate": rel_err(d_gate, r_gate),
                   "d_gate_same_bits": bool(torch.equal(d_gate, d_gate2))}
            check(max(err["out"], err["d_env"], err["d_gate"]) <= TOL_KERNEL,
                  f"row_gate {name} {err}")
            check(err["d_gate_same_bits"], f"row_gate {name}: d_gate differs between launches")
            errs.append(err)
        env, dout = rnd((lanes,) + es), rnd((lanes,) + os_)
        gate = rnd((lanes,) + gs)
        elem = env.element_size()
        env_bytes = env.numel() * elem // (2 if form.d else 1)
        fwd_bytes = env_bytes + gate.numel() * elem + dout.numel() * elem
        # reads E, G and dO, writes dE (whole, zero off a diagonal) and dG
        bwd_bytes = (env_bytes + dout.numel() * elem + env.numel() * elem
                     + 2 * gate.numel() * elem)
        fwd_flops = 8 * lanes * form.size(form.f) * form.size(form.k) * form.size(form.n)

        def fwd():
            return row_scan._gate_fwd_cuda(env, gate, form, True)

        def bwd():
            return row_scan._gate_bwd_cuda(env, gate, dout, form, True, True, True)

        def plain_fwd():
            return row_scan._gate_fwd_plain(env, gate, form, True)

        def plain_bwd():
            return row_scan._gate_bwd_plain(env, gate, dout, form, True, True, True)

        ops = (env, gate.conj()) if form.big == 0 else (gate.conj(), env)
        lettered = row_scan._ellipsis(eq)[0]
        leaves = [o.detach().requires_grad_(True) for o in (env, gate)]

        def library_fwd():
            return torch.einsum(lettered, *ops)

        def library_bwd():
            e, g = leaves
            t = torch.einsum(lettered, *((e, g.conj()) if form.big == 0 else (g.conj(), e)))
            return torch.autograd.grad(t, leaves, dout)

        cases.append({
            "form": name, "equation": eq, "lanes": lanes,
            "K": form.size(form.k), "N": form.size(form.n), "diagonal": bool(form.d),
            "env_entries": form.size(form.e), "errors": errs,
            "fwd_ms": cuda_ms(fwd), "fwd_device_ms": device_ms(fwd),
            "bwd_ms": cuda_ms(bwd), "bwd_device_ms": device_ms(bwd),
            "plain_fwd_device_ms": device_ms(plain_fwd),
            "plain_bwd_device_ms": device_ms(plain_bwd, reps=5),
            "library_fwd_device_ms": device_ms(library_fwd),
            "library_bwd_device_ms": device_ms(library_bwd, reps=5),
            "fwd": _bound(fwd_bytes, fwd_flops), "bwd": _bound(bwd_bytes, 2 * fwd_flops),
        })
    rec = {"phase": "row_gate_kernels", "tolerance": TOL_KERNEL, "cases": cases}
    emit(rec)
    return rec


def _profile_steps(step, step_ms: float, steps: int = 5) -> dict:
    """Device time by kernel over a short window of ``step()`` calls
    (torch.profiler), and the device's idle share against ``step_ms``, the
    unprofiled wall time of one step; ``None`` where the trace shows no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()  # keep one-time work out of the window
    torch.cuda.synchronize()
    # the card's activity alone: host-side events would add several per
    # launch, and reading them back sets the time of a profiled phase
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {ev.key: ev.device_time_total / 1e3 / steps  # ms per step
               for ev in kernels if ev.device_time_total}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "steps": steps,
        "device_busy_ms_per_step": busy if busy else None,
        "device_idle_share": (1.0 - busy / step_ms) if busy else None,
        "kernel_launches_per_step": sum(ev.count for ev in kernels) / steps,
        "top_kernels_ms_per_step": {k[:80]: v for k, v in top} if top else None,
    }


def phase_bench(smi: str) -> dict:
    import torch

    from tneq_tpu_torch.bench.headline import build_problem, sgd_step
    from tneq_tpu_torch.model.qctn import params_from_numpy
    from tneq_tpu_torch.ops.chain_overlap import launch_counts, reset_launch_counts
    from tneq_tpu_torch.train.network_fit import network_log_fidelity

    graph, params_np, target_np = build_problem()
    p_host = params_from_numpy(params_np, "cpu")
    t_host = params_from_numpy(target_np, "cpu")
    with torch.no_grad():
        loss0_host = float(-network_log_fidelity(graph, p_host, t_host))
    params = params_from_numpy(params_np, "cuda")
    target = params_from_numpy(target_np, "cuda")
    _, loss0 = sgd_step(graph, params, target)
    loss0 = float(loss0)
    check(math.isfinite(loss0), f"step-0 loss is not finite: {loss0}")
    rel0 = abs(loss0 - loss0_host) / max(abs(loss0_host), 1e-30)
    check(rel0 <= TOL_STEP0, f"step-0 loss {loss0} vs host {loss0_host} (rel {rel0})")

    p = params
    for _ in range(3):  # warm-up
        p, _ = sgd_step(graph, p, target)
    torch.cuda.synchronize()
    p = params
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(BENCH_STEPS):
        p, loss = sgd_step(graph, p, target)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), "non-finite loss in the bench run")
    check(float(losses[-1]) < float(losses[0]),
          f"loss did not fall: {float(losses[0])} -> {float(losses[-1])}")
    check(counts["chain_sweep_fwd"] == 3 * BENCH_STEPS
          and counts["chain_sweep_bwd"] == 2 * BENCH_STEPS,
          f"launch counts {counts}, expected B1 = {3 * BENCH_STEPS}, "
          f"B2 = {2 * BENCH_STEPS}")
    box = {"p": p}

    def one_step():
        box["p"], _ = sgd_step(graph, box["p"], target)

    prof = _profile_steps(one_step, dt / BENCH_STEPS * 1e3)
    rec = {
        "phase": "bench",
        "program": "bench.py::_build_step_fn on tneq_tpu_torch: 32q MPS, "
                   "bond 16, phys 16, float32, SGD lr 1e-3 on -log F",
        "steps": BENCH_STEPS,
        "steps_per_s": BENCH_STEPS / dt,
        "ms_per_step": dt / BENCH_STEPS * 1e3,
        "loss_step0": loss0,
        "loss_step0_host": loss0_host,
        "loss_step0_rel_err": rel0,
        "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]),
        "launches": counts,
        "launches_per_step": {k: v / BENCH_STEPS for k, v in counts.items()},
        "profile": prof,
        "card": smi,
    }
    emit(rec)
    return rec


def _experiment_config(**kw):
    import torch

    from tneq_tpu_torch.apps.symmetry_breaking import SymmetryBreakingConfig

    # Budgets from a host rehearsal of this configuration: validation
    # converges near 1400 steps, and the planted cores refit within ~320
    # steps; the other candidates spend the whole prune budget.  The exit
    # is tested every 16 steps, so the host runs ahead of the card.
    base = dict(
        n_qubits=12, rank=2, topology="mps", bond_dim=16,
        fidelity_mode="network", dtype=torch.float32, optimizer="adam",
        validate_lr=2e-2, validate_steps=2000, prune_lr=5e-2, prune_steps=480,
        max_outer_iterations=1, tol=1e-3, fit_jit_scope="step",
        fit_sync_every=16, device="cuda",
    )
    base.update(kw)
    return SymmetryBreakingConfig(**base)


def phase_experiment() -> dict:
    import numpy as np
    import torch

    from tneq_tpu_torch.apps.symmetry_breaking import (
        make_experiment, symmetry_breaking, target_tensor_init,
        validate_target_tensor,
    )
    from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
    from tneq_tpu_torch.ops.chain_overlap import launch_counts, reset_launch_counts

    cfg = _experiment_config()
    exp = make_experiment(cfg)
    planted = [3, 7]
    reset_launch_counts()
    t0 = time.perf_counter()
    target = target_tensor_init(exp, planted, 1)
    ok, fid, vsteps, fitted = validate_target_tensor(exp, target, 2, return_params=True)
    pruned, attempts = symmetry_breaking(exp, target, shuffle_seed=0,
                                         warm_params=fitted, verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    check(math.isfinite(fid), f"validation fidelity is not finite: {fid}")
    check(counts["chain_sweep_fwd"] > 0 and counts["chain_sweep_bwd"] > 0,
          f"the experiment did not run the sweep kernels: {counts}")

    # the same 20-step validation fit on the card and on the host
    short = replace(cfg, validate_steps=20)
    t_np = params_to_numpy(target[0])
    mask_np = target[1].cpu().numpy()
    p_np = params_to_numpy(init_params(exp.graph, 5, torch.float32, device="cpu"))
    fits = {}
    for where in ("cuda", "cpu"):
        e = make_experiment(replace(short, device=where))
        res = e.run_fit(
            e.validate_fit, params_from_numpy(p_np, where), e.mask_vector([]),
            (params_from_numpy(t_np, where), torch.as_tensor(mask_np, device=where)),
        )
        fits[where] = (float(-torch.log1p(-res.infidelity)), int(res.steps),
                       params_to_numpy(res.params))
    nlf_d, nlf_h = fits["cuda"][0], fits["cpu"][0]
    nlf_err = abs(nlf_d - nlf_h) / max(abs(nlf_h), 1e-30)
    p_err = max(
        float(np.abs(fits["cuda"][2][k] - fits["cpu"][2][k]).max())
        / max(float(np.abs(fits["cpu"][2][k]).max()), 1e-30)
        for k in fits["cpu"][2]
    )
    check(fits["cuda"][1] == fits["cpu"][1] == 20,
          f"20-step fit steps: card {fits['cuda'][1]}, host {fits['cpu'][1]}")
    check(nlf_err <= TOL_FIT and p_err <= TOL_FIT,
          f"20-step fit card vs host: -log F rel {nlf_err}, params rel {p_err}")
    rec = {
        "phase": "experiment",
        "config": {"n_qubits": cfg.n_qubits, "bond_dim": cfg.bond_dim,
                   "rank": cfg.rank, "dtype": "float32",
                   "optimizer": cfg.optimizer,
                   "validate_lr": cfg.validate_lr,
                   "validate_steps": cfg.validate_steps,
                   "prune_lr": cfg.prune_lr,
                   "prune_steps": cfg.prune_steps,
                   "sync_every": cfg.fit_sync_every, "planted": planted},
        "validated": ok,
        "fidelity": fid,
        "validate_steps_taken": vsteps,
        "pruned": sorted(pruned),
        "planted_recovered": sorted(set(pruned) & set(planted)),
        "attempts": attempts,
        "seconds": dt,
        "launches": counts,
        "fit20": {"neg_log_f_card": nlf_d, "neg_log_f_host": nlf_h,
                  "neg_log_f_rel_err": nlf_err, "params_rel_err": p_err},
    }
    emit(rec)
    return rec, (exp, target, fitted)


def _sweep_inputs(n: int, B: int, D: int, K: int, complex_: bool, seed: int, dev):
    """env0 [B,D,D], a [n,D,K,D], mx [n,B,K,K] from numpy, max-abs 1 (a
    scaled by 1/(D K), so the envs of a sweep stay of order one)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0):
        x = rng.standard_normal(shape)
        if complex_:
            x = x + 1j * rng.standard_normal(shape)
        x = scale * x / np.abs(x).max()
        return torch.as_tensor(x.astype(np.complex64 if complex_ else np.float32), device=dev)

    return mk(B, D, D), mk(n, D, K, D, scale=1.0 / (D * K)), mk(n, B, K, K)


def _timed_once(fn):
    """``(fn(), CUDA-event ms)`` of one call on an idle card."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_transfer_kernels() -> dict:
    import torch

    from tneq_tpu_torch.ops import transfer_step as ts

    dev = torch.device("cuda", 0)
    cases = []
    for B, D, K in STEP_SHAPES + WIDE_SHAPES + EDGE_SHAPES:
        edge = (B, D, K) in EDGE_SHAPES
        reps = EDGE_REPS if edge else 20
        for n in EDGE_SITES if edge else (1, MIDDLE_STEPS):
            for name, complex_ in (("transfer_step", False), ("transfer_step_complex", True)):
                plain = ts.transfer_sweep_complex_plain if complex_ else ts.transfer_sweep_plain
                env, a, mx = _sweep_inputs(n, B, D, K, complex_, seed=B + D + n, dev=dev)
                g = _sweep_inputs(1, B, D, K, complex_, seed=B + D + n + 1, dev=dev)[0]
                plan = ts.kernel_plan(B, D, K, D, env.dtype, n)
                # the route the plan takes, and at ROUTE_SHAPE the other one too
                routes = [plan.route] + (["narrow" if plan.route == "wide" else "wide"]
                                         if (B, D, K) == ROUTE_SHAPE else [])
                pf, pb = plain(env, a, mx), plain(g, a, mx, backward=True)
                err, abs_err, calls, once = {}, 0.0, {}, {}
                for r in routes:
                    pre = "" if r == plan.route else f"{r}_"
                    fwd = lambda r=r: ts._launch(env, a, mx, complex_, route=r)  # noqa: E731
                    # the backward's d_env chain: the same kernel, sites reversed
                    bwd = lambda r=r: ts._launch(g, a, mx, complex_,  # noqa: E731
                                                 backward=True, route=r)
                    (kf, f_ms), (kb, b_ms) = _timed_once(fwd), _timed_once(bwd)
                    if edge and min(f_ms, b_ms) >= HEAVY_MS:
                        once = {"ms": f_ms, "device_ms": f_ms, "bwd_ms": b_ms,
                                "bwd_device_ms": b_ms, "timed_by": "cuda_events_one_call"}
                    else:
                        calls[pre], calls[f"{pre}bwd_"] = fwd, bwd
                    torch.cuda.synchronize()
                    err[f"{pre}fwd"] = max(rel_err(k, p) for k, p in zip(kf, pf))
                    err[f"{pre}d_env"] = max(rel_err(k, p) for k, p in zip(kb, pb))
                    abs_err = max(abs_err, float((kf - pf).abs().max()),
                                  float((kb - pb).abs().max()))
                calls["plain_"] = lambda: plain(env, a, mx)
                if n == 1:  # one torch.einsum computes one step
                    bra = a[0].conj() if complex_ else a[0]
                    calls["library_"] = lambda: torch.einsum(
                        "zab,akc,zkl,bld->zcd", env, a[0], mx[0], bra)
                times = {f"{k}ms": cuda_ms(fn, reps, warmup=1 if edge else 3)
                         for k, fn in calls.items()}
                times.update({f"{k}device_ms": device_ms(fn, reps) for k, fn in calls.items()})
                times.update(once)
                case = {
                    "kernel": name, "n": n, "B": B, "D": D, "K": K, "edge": edge, "reps": reps,
                    "route": plan.route,
                    "plan": plan._asdict(),
                    "rel_err": err,
                    "max_abs_err": abs_err,
                    **times,
                    "library_ms": times.get("library_ms"),
                    "library_device_ms": times.get("library_device_ms"),
                    "per_site_device_us": (times["device_ms"] * 1e3 / n
                                           if times["device_ms"] else None),
                    "bwd_per_site_device_us": (times["bwd_device_ms"] * 1e3 / n
                                               if times["bwd_device_ms"] else None),
                    **sweep_bound(n, B, D, K, complex_),
                    **tc_sweep_bound(n, B, D, K, complex_),
                }
                cases.append(case)
                bad = {k: v for k, v in err.items() if not v <= TOL_STEP}
                check(not bad, f"{name} at n = {n}, (B, D, K) = {(B, D, K)} disagrees "
                               f"with its plain version beyond {TOL_STEP}: {bad}")
    rec = {"phase": "transfer_kernels", "tolerance": TOL_STEP, "cases": cases}
    emit(rec)
    return rec


def _wide_trainer(D: int, K: int, B: int, dtype_name: str, steps: int,
                  strategy: str = "mps_sweep_cuda") -> dict:
    """The Born-rule Trainer (``TrainingConfig()``: SGD-G lr 1e-2 momentum
    0.9) on ``mps_graph(8, D, phys=K)`` at batch ``B`` of the CLI's data
    (numpy seed 0), whose sweeps take the wide route (``strategy``
    ``"mps_sweep_cuda"``: 2 launches per step) or, past the gate, the
    einsum step (``"mps_sweep"``: none): ``steps`` steps on the card with
    their launch counts and seconds, and step 0's loss and the Born-rule
    probabilities at the initial cores against the host's."""
    import numpy as np
    import torch

    from tneq_tpu_torch.graph import mps_graph, parse_graph
    from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
    from tneq_tpu_torch.ops import transfer_step as ts
    from tneq_tpu_torch.train.trainer import Trainer, TrainingConfig, basis_states

    dtype = getattr(torch, dtype_name)
    graph = parse_graph(mps_graph(8, D, phys=K))
    p_np = params_to_numpy(init_params(graph, 0, dtype, device="cpu"))
    x = np.random.default_rng(0).normal(size=(B, 8)).astype(np.float32)
    at_init = {}
    for where in ("cuda", "cpu"):
        tr = Trainer(graph, config=TrainingConfig(max_steps=steps, log_every=0), dtype=dtype,
                     device=where)
        check(tr.strategy == strategy, f"Trainer on mps_graph(8, {D}, phys={K}), {dtype_name}: "
                                       f"strategy {tr.strategy}, expected {strategy}")
        states = basis_states(graph, dtype=dtype, device=where)
        xs = torch.as_tensor(x, device=where)
        with torch.no_grad():
            params = params_from_numpy(p_np, where)
            at_init[where] = (tr.probability(params, states, xs).cpu(),
                              float(tr.loss(params, states, xs)))
        if where == "cuda":
            ts.reset_launch_counts()
            t0 = time.perf_counter()
            _, stats = tr.fit(params_from_numpy(p_np, where), [xs], states=states,
                              verbose=False)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = ts.launch_counts()
    (pc, lc), (ph, lh) = at_init["cuda"], at_init["cpu"]
    name = "transfer_step_complex" if dtype.is_complex else "transfer_step"
    per_step = 2 if strategy == "mps_sweep_cuda" else 0
    rec = {
        "program": f"Trainer on mps_graph(8, {D}, phys={K}), {dtype_name}, batch {B}, "
                   f"TrainingConfig() (sgdg lr 1e-2 momentum 0.9)",
        "strategy": strategy,
        "plan": (ts.kernel_plan(B, D, K, D, dtype, MIDDLE_STEPS)._asdict() if per_step
                 else None),
        "steps": steps, "seconds": dt, "steps_per_s": steps / dt,
        "losses": [float(v) for v in stats.losses],
        "step0_loss_card": float(stats.losses[0]), "loss_at_init_card": lc,
        "loss_at_init_host": lh, "step0_rel_err": abs(stats.losses[0] - lh) / abs(lh),
        "probability_rel_err": rel_err(pc, ph), "probability_max": float(ph.abs().max()),
        "launches": counts, "launches_per_step": {k: v / steps for k, v in counts.items()},
    }
    check(bool(np.isfinite(stats.losses).all()), f"{rec['program']}: non-finite loss")
    check(counts[name] == per_step * steps and sum(counts.values()) == per_step * steps,
          f"{rec['program']}: launch counts {counts}, expected {name} = {per_step * steps}")
    check(rec["step0_rel_err"] <= TOL_STEP0 and rec["probability_rel_err"] <= TOL_STEP0,
          f"{rec['program']}: step 0 against the host: loss rel {rec['step0_rel_err']}, "
          f"probabilities rel {rec['probability_rel_err']}")
    return rec


def _explicit_kernel_raises(shape) -> str:
    """``mps_sweep_siamese_fn(use_kernel=True)`` on the complex64 chain
    ``mps_graph(8, D, phys=K)`` past the gate, on the card: the
    ``ValueError`` it raises (the check fails if it computes)."""
    import torch

    from tneq_tpu_torch.graph import mps_graph, parse_graph
    from tneq_tpu_torch.ops.features import measurement_matrices
    from tneq_tpu_torch.ops.mps_sweep import mps_sweep_siamese_fn
    from tneq_tpu_torch.train.trainer import basis_states

    B, D, K = shape
    graph = parse_graph(mps_graph(8, D, phys=K))
    mx = measurement_matrices(torch.zeros(B, 8, device="cuda"), K).to(torch.complex64)
    try:
        mps_sweep_siamese_fn(graph, use_kernel=True)(
            {n: torch.zeros(s, dtype=torch.complex64, device="cuda")
             for n, s in graph.shapes.items()},
            basis_states(graph, dtype=torch.complex64, device="cuda"),
            [mx[:, q] for q in range(8)])
    except ValueError as e:
        return str(e)
    raise SmokeFailure(f"use_kernel=True on mps_graph(8, {D}, phys={K}) computed")


def phase_born_rule(smi: str) -> dict:
    import numpy as np
    import torch

    from tneq_tpu_torch.graph import mps_graph, parse_graph
    from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
    from tneq_tpu_torch.ops import transfer_step as ts
    from tneq_tpu_torch.train.data import gaussian_batches
    from tneq_tpu_torch.train.trainer import Trainer, TrainingConfig, basis_states

    B, D, K = BORN_SHAPE
    graph = parse_graph(mps_graph(8, D, phys=K))
    p_np = params_to_numpy(init_params(graph, 0, torch.float32, device="cpu"))

    def setup(where: str, steps: int):
        tr = Trainer(graph, config=TrainingConfig(max_steps=steps, log_every=0),
                     dtype=torch.float32, device=where)
        return (tr, gaussian_batches(4, B, 8, seed=0, device=where),
                basis_states(graph, dtype=torch.float32, device=where))

    # The first steps on the card, keeping their cores; the host's loss at
    # those cores must equal the card's.  (A free-running host trajectory
    # parts from the card's: float32 Born-rule probabilities are tiny
    # differences of large terms, and two summation orders differ past 1e-4
    # after a few Stiefel steps.  It is reported, not checked.)
    tc, data_c, states_c = setup("cuda", CHECK_STEPS)
    th, data_h, states_h = setup("cpu", CHECK_STEPS)
    params = params_from_numpy(p_np, "cuda")
    opt = tc.optimizer.init(params)
    card, host_at_card = [], []
    for i in range(CHECK_STEPS):
        cores = params_to_numpy(params)
        params, opt, loss = tc.train_step(params, opt, states_c, data_c[i % 4])
        card.append(float(loss))
        with torch.no_grad():
            host_at_card.append(float(th.loss(params_from_numpy(cores, "cpu"), states_h,
                                              data_h[i % 4])))
    rel_tf = [abs(c - h) / abs(h) for c, h in zip(card, host_at_card)]
    check(max(rel_tf) <= TOL_STEP0,
          f"born_rule: card loss vs host loss at the same cores, rel {max(rel_tf)}")
    _, host_free = th.fit(params_from_numpy(p_np, "cpu"), data_h, states=states_h,
                          verbose=False)

    # the main run: the reference loop on the card
    tm, _, _ = setup("cuda", BORN_STEPS)
    ts.reset_launch_counts()
    t0 = time.perf_counter()
    params, stats = tm.fit(params_from_numpy(p_np, "cuda"), data_c, states=states_c,
                           verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ts.launch_counts()
    losses = np.array(stats.losses)
    check(bool(np.isfinite(losses).all()), "born_rule: non-finite loss")
    check(losses[-4:].mean() < losses[:4].mean(),
          f"born_rule: loss did not fall: {losses[:4].mean()} -> {losses[-4:].mean()}")
    per_step = 2  # one sweep forward, one d_env sweep backward
    check(counts["transfer_step"] == per_step * BORN_STEPS
          and counts["transfer_step_complex"] == 0,
          f"born_rule launch counts {counts}, expected B3 = {per_step * BORN_STEPS}, B4 = 0")
    box = {"p": params, "o": tm.optimizer.init(params), "i": 0}

    def one_step():
        box["p"], box["o"], _ = tm.train_step(box["p"], box["o"], states_c,
                                              data_c[box["i"] % 4])
        box["i"] += 1

    prof = _profile_steps(one_step, dt / BORN_STEPS * 1e3)
    wide = _wide_trainer(*WIDE_BORN_SHAPE[1:], WIDE_BORN_SHAPE[0], "float32", WIDE_BORN_STEPS)
    # fault C4: physical rank 72 is past the gate, so the einsum step
    c4 = _wide_trainer(*C4_F32_SHAPE[1:], C4_F32_SHAPE[0], "float32", C4_STEPS, "mps_sweep")
    rec = {
        "phase": "born_rule",
        "program": "Trainer on mps_graph(8, 8, phys=4), float32, TrainingConfig() "
                   "(sgdg lr 1e-2 momentum 0.9), gaussian_batches(4, 512, 8, seed=0)",
        "strategy": tm.strategy,
        "steps": BORN_STEPS,
        "steps_per_s": BORN_STEPS / dt,
        "ms_per_step": dt / BORN_STEPS * 1e3,
        "loss_first4_mean": float(losses[:4].mean()),
        "loss_last4_mean": float(losses[-4:].mean()),
        "losses_every_20": [float(x) for x in losses[::20]],
        "first_losses_card": card,
        "host_loss_at_card_cores_rel_err_max": max(rel_tf),
        "free_running_host_rel_err": [abs(c - h) / abs(h)
                                      for c, h in zip(card, host_free.losses)],
        "launches": counts,
        "launches_per_step": {k: v / BORN_STEPS for k, v in counts.items()},
        "profile": prof,
        "wide": wide,
        "c4_rank72": c4,
        "card": smi,
    }
    emit(rec)
    return rec


def phase_cli(smi: str) -> dict:
    import numpy as np
    import torch

    from tneq_tpu_torch.apps.train_single_node import main as cli_main
    from tneq_tpu_torch.ops import transfer_step as ts

    ts.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        stats = cli_main(["--steps", str(CLI_STEPS), "--device", "cuda"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ts.launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        host = cli_main(["--steps", str(CHECK_STEPS), "--device", "cpu"])
    losses = np.array(stats.losses)
    check(bool(np.isfinite(losses).all()), "cli: non-finite loss")
    per_step = 2  # one sweep forward, one d_env sweep backward
    check(counts["transfer_step_complex"] == per_step * CLI_STEPS
          and counts["transfer_step"] == 0,
          f"cli launch counts {counts}, expected B4 = {per_step * CLI_STEPS}, B3 = 0")
    rel = [abs(c - h) / abs(h) for c, h in zip(stats.losses, host.losses)]
    check(max(rel) <= TOL_STEP0, f"cli: first {CHECK_STEPS} losses card vs host, rel {max(rel)}")
    # --dim 32: complex64 cores of 256 KiB, which B4's plan runs on the wide
    # route (its sweeps are held against the plain version in the
    # transfer_kernels phase); one warm step, then WIDE_STEPS timed
    with contextlib.redirect_stdout(sys.stderr):
        cli_main(["--dim", "32", "--steps", "1", "--device", "cuda"])
    torch.cuda.synchronize()
    ts.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        wide = cli_main(["--dim", "32", "--steps", str(WIDE_STEPS), "--device", "cuda"])
    torch.cuda.synchronize()
    dt_wide = time.perf_counter() - t0
    wide_counts = ts.launch_counts()
    check(bool(np.isfinite(wide.losses).all()), "cli --dim 32: non-finite loss")
    check(wide_counts == {"transfer_step": 0, "transfer_step_complex": per_step * WIDE_STEPS},
          f"cli --dim 32 launch counts {wide_counts}, expected B4 = {per_step * WIDE_STEPS}")
    # fault C3: the CLI's trainer at bond 128, Hermite order 4 (the CLI itself
    # ties the physical rank to --dim, which K = 4 cannot measure)
    c3 = _wide_trainer(*C3_SHAPE[1:], C3_SHAPE[0], "complex64", C3_STEPS)
    # fault C4: bond 264 is past the gate, so the einsum step; asked for
    # explicitly, the kernel raises (nothing falls back)
    c4 = _wide_trainer(*C4_C64_SHAPE[1:], C4_C64_SHAPE[0], "complex64", C4_STEPS, "mps_sweep")
    c4["explicit_kernel_raises"] = _explicit_kernel_raises(C4_C64_SHAPE)
    # --profile: the defaults for PROFILE_STEPS steps under torch.profiler; the
    # Chrome trace must name B4's kernel and one train_step span per step
    ts.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as prof_dir:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            profiled = cli_main(["--steps", str(PROFILE_STEPS), "--device", "cuda",
                                 "--profile", prof_dir])
        dt_prof = time.perf_counter() - t0
        prof_counts = ts.launch_counts()
        files = glob.glob(f"{prof_dir}/*.json")
        check(len(files) == 1, f"cli --profile wrote {files}")
        trace_bytes = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    b4 = sorted({e["name"] for e in events if e.get("cat") == "kernel"
                 and "transfer_sweep_kernel" in e.get("name", "")})
    spans = sum(1 for e in events if e.get("name") == "train_step"
                and e.get("cat") == "user_annotation")
    check(bool(b4) and spans == PROFILE_STEPS and bool(np.isfinite(profiled.losses).all())
          and prof_counts == {"transfer_step": 0,
                              "transfer_step_complex": per_step * PROFILE_STEPS},
          f"cli --profile: B4 kernels in the trace {b4}, train_step spans {spans}, "
          f"launch counts {prof_counts}")
    clip = float(-np.log(np.float32(1e-10)))
    rec = {
        "phase": "cli",
        "program": "apps.train_single_node.main defaults: mps 8 qubits, dim 3, "
                   "complex64, batch 32 x 4 batches, sgdg lr 1e-2 momentum 0.9",
        "steps": CLI_STEPS,
        "seconds": dt,
        "steps_per_s": CLI_STEPS / dt,
        "losses_every_10": [float(x) for x in losses[::10]],
        "loss_last": float(losses[-1]),
        "share_at_clip": float(np.isclose(losses, clip, rtol=1e-6).mean()),
        "host_rel_err_max": max(rel),
        "launches": counts,
        "launches_per_step": {k: v / CLI_STEPS for k, v in counts.items()},
        "wide": {"argv": ["--dim", "32", "--steps", str(WIDE_STEPS)], "seconds": dt_wide,
                 "steps_per_s": WIDE_STEPS / dt_wide, "after_warm_steps": 1,
                 "losses": [float(x) for x in wide.losses], "launches": wide_counts},
        "c3": c3,
        "c4_bond264": c4,
        "profile": {"argv": ["--steps", str(PROFILE_STEPS), "--profile", "DIR"],
                    "reduced": {"steps": PROFILE_STEPS}, "seconds": dt_prof,
                    "trace_bytes": trace_bytes, "trace_events": len(events),
                    "b4_kernels_named": b4,
                    "b4_kernel_events": sum(1 for e in events if e.get("name") in b4),
                    "train_step_spans": spans, "launches": prof_counts},
        "card": smi,
    }
    emit(rec)
    return rec


def _cli_pair(extra) -> dict:
    """The experiment's CLI in a process of its own, on the card and on the
    host, both at once: the ``best: pruned`` line of each, and the card's
    seconds."""
    cli = [sys.executable, "-m", "tneq_tpu_torch.apps.symmetry_breaking", *extra]
    best, seconds = {}, None
    t0 = time.perf_counter()
    procs = {where: subprocess.Popen(cli + ["--device", where], stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
             for where in ("cuda", "cpu")}
    try:
        for where, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=400)
            if where == "cuda":
                seconds = time.perf_counter() - t0
            print(stdout, stderr, sep="\n", file=sys.stderr, flush=True)
            lines = [ln for ln in stdout.splitlines() if ln.startswith("best: pruned ")]
            check(proc.returncode == 0 and len(lines) == 1,
                  f"the CLI {extra} on {where} exited {proc.returncode}")
            best[where] = lines[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(best["cuda"] == best["cpu"],
          f"the CLI {extra}: the card's result, {best['cuda']!r}, is not the host's, "
          f"{best['cpu']!r}")
    return {"best": best["cuda"], "seconds": seconds}


def phase_brick(smi: str):
    import torch

    from tneq_tpu_torch.apps.symmetry_breaking import (
        SymmetryBreakingConfig, make_experiment, symmetry_breaking, target_tensor_init,
        validate_target_tensor,
    )
    from tneq_tpu_torch.model.qctn import params_from_numpy, params_to_numpy
    from tneq_tpu_torch.ops import chain_overlap, transfer_step

    cfg = SymmetryBreakingConfig(device="cuda", max_outer_iterations=1,
                                 prune_steps=BRICK_PRUNE_STEPS)
    exp = make_experiment(cfg)
    host = make_experiment(replace(cfg, device="cpu"))
    check(exp.graph.ncores == 35 and cfg.dtype == torch.complex64,
          f"brick: {exp.graph.ncores} cores in {cfg.dtype}")
    chain_overlap.reset_launch_counts()
    transfer_step.reset_launch_counts()
    t_start = time.perf_counter()

    # the dense target from the same cores (drawn on the host), then the
    # validation's fresh cores from the same generator, as the CLI draws them
    gen = torch.Generator().manual_seed(0)
    target = target_tensor_init(exp, BRICK_MASK, gen)
    torch.cuda.synchronize()
    target_h = target_tensor_init(host, BRICK_MASK, 0)
    check(tuple(target.shape) == (2,) * 16 and bool(torch.isfinite(target).all()),
          f"brick: target of shape {tuple(target.shape)}")
    target_err = rel_err(target.cpu(), target_h)
    check(target_err <= TOL_TARGET, f"brick: target card vs host, rel {target_err}")

    # validation at the default budget
    t0 = time.perf_counter()
    ok, fid, vsteps, fitted = validate_target_tensor(exp, target, gen, return_params=True)
    torch.cuda.synchronize()
    dt_val = time.perf_counter() - t0
    check(ok and 1.0 - fid < 1e-3, f"brick: validation 1 - F = {1.0 - fid} in {vsteps} steps")

    # the first validation steps on the card, keeping their cores; the
    # host's 1 - F at those cores must equal the card's
    dc, dh = exp.validate_fit.drivers, host.validate_fit.drivers
    params = exp.init_params(2)
    opt = dc.optimizer.init(params)
    mask_c, mask_h = exp.mask_vector([]), host.mask_vector([])
    card, host_at_card = [], []
    for _ in range(CHECK_STEPS):
        cores = params_to_numpy(params)
        params, opt, infid = dc.step(params, opt, mask_c, target)
        card.append(float(infid))
        p_h = params_from_numpy(cores, "cpu")
        host_at_card.append(float(dh.step(p_h, dh.optimizer.init(p_h), mask_h, target_h)[2]))
    rel_first = [abs(c - h) / abs(h) for c, h in zip(card, host_at_card)]
    check(max(rel_first) <= TOL_STEP0,
          f"brick: card 1 - F vs host 1 - F at the same cores, rel {max(rel_first)}")
    # from a random start F ~ 4^-8, so 1 - F sits near 1 for those steps;
    # at the validated cores 1 - F ~ 1e-3 and the two must agree in absolute
    infid_fit = float(dc.step(fitted, dc.optimizer.init(fitted), mask_c, target)[2])
    p_h = params_from_numpy(params_to_numpy(fitted), "cpu")
    infid_fit_h = float(dh.step(p_h, dh.optimizer.init(p_h), mask_h, target_h)[2])
    check(abs(infid_fit - infid_fit_h) <= TOL_FIT_INFID,
          f"brick: 1 - F at the validated cores, card {infid_fit} vs host {infid_fit_h}")

    # one pass of the prune loop, warm-started at the planted network: the
    # target's own cores (drawn again from seed 0) with identities in the
    # planted places.  It must return the planted set, in the host's order.
    t0 = time.perf_counter()
    pruned, attempts = symmetry_breaking(exp, target, shuffle_seed=0,
                                         warm_params=_planted(exp, BRICK_MASK), verbose=False)
    torch.cuda.synchronize()
    dt_prune = time.perf_counter() - t0
    seconds = time.perf_counter() - t_start
    kernel_launches = {**chain_overlap.launch_counts(), **transfer_step.launch_counts()}
    t0 = time.perf_counter()
    pruned_h, attempts_h = symmetry_breaking(host, target_h, shuffle_seed=0,
                                             warm_params=_planted(host, BRICK_MASK),
                                             verbose=False)
    dt_prune_h = time.perf_counter() - t0
    check(sorted(pruned) == BRICK_MASK and (pruned, attempts) == (pruned_h, attempts_h),
          f"brick: the prune pass pruned {pruned} in {attempts} attempts on the card, "
          f"{pruned_h} in {attempts_h} on the host; planted {BRICK_MASK}")

    box = {"p": fitted, "o": dc.optimizer.init(fitted)}

    def one_step():
        box["p"], box["o"], m = dc.step(box["p"], box["o"], mask_c, target)
        float(m)  # the exit test's host sync, as in the fit loop

    prof = _profile_steps(one_step, dt_val / vsteps * 1e3)

    # the experiment's CLI, in a process of its own, on the card and on the
    # host: the same best pruned set (at 100 prune steps every candidate
    # stays far above tol: 1 - F >= 0.2 on the host)
    cli = _cli_pair(["--n-qubits", "4", "--n-cells", "2", "--restarts", "1",
                     "--prune-steps", str(BRICK_CLI_PRUNE_STEPS)])
    rec = {
        "phase": "brick",
        "program": "apps.symmetry_breaking defaults: brick wall 8 qubits x 5 cells, rank 2, "
                   "complex64, sgdg (validate lr 1, <= 4000 steps; prune lr 1e-2), dense "
                   "fidelity, tol 1e-3, planted mask of the reference CLI",
        "reduced": {"prune_steps": BRICK_PRUNE_STEPS, "max_outer_iterations": 1,
                    "cli": {"prune_steps": BRICK_CLI_PRUNE_STEPS, "restarts": 1}},
        "target_rel_err": target_err,
        "validated": ok,
        "validate_infidelity": 1.0 - fid,
        "validate_steps": vsteps,
        "validate_seconds": dt_val,
        "fit_steps_per_s": vsteps / dt_val,
        "first_infidelities_card": card,
        "host_at_card_rel_err_max": max(rel_first),
        "validated_infidelity_card_host": [infid_fit, infid_fit_h],
        "prune_warm_start": "the planted network",
        "pruned": sorted(pruned),
        "attempts": attempts,
        "prune_seconds": dt_prune,
        "host_prune_seconds": dt_prune_h,
        "seconds": seconds,
        "port_kernel_launches": kernel_launches,
        "profile": prof,
        "cli_seconds": cli["seconds"],
        "cli_best": cli["best"],
        "card": smi,
    }
    emit(rec)
    return rec, fitted


def phase_brick_network(smi: str, dense_fitted) -> dict:
    import numpy as np
    import torch

    from tneq_tpu_torch.apps.symmetry_breaking import (
        SymmetryBreakingConfig, make_experiment, symmetry_breaking, target_tensor_init,
        validate_target_tensor,
    )
    from tneq_tpu_torch.bench import flagship
    from tneq_tpu_torch.model.qctn import params_from_numpy, params_to_numpy
    from tneq_tpu_torch.ops import chain_overlap, row_scan, transfer_step
    from tneq_tpu_torch.ops.contract import make_core_only_fn
    from tneq_tpu_torch.train.losses import fidelity
    from tneq_tpu_torch.train.network_fit import _normalize, _overlap_fn, network_log_fidelity
    from tneq_tpu_torch.utils.device import matmul_precision

    def host_nlf(e, cores, t_eff):
        """The host's −log F at numpy ``cores`` against its prepared target."""
        with torch.no_grad(), matmul_precision("highest"):
            return float(-network_log_fidelity(e.graph, params_from_numpy(cores, "cpu"), t_eff))

    def pairwise_per_overlap(graph) -> int:
        return sum(len(r.steps) for r in row_scan._schedule(graph, None) if r.steps)

    chain_overlap.reset_launch_counts()
    transfer_step.reset_launch_counts()
    t_start = time.perf_counter()

    # (a) the reference default in network mode
    cfg = SymmetryBreakingConfig(device="cuda", fidelity_mode="network",
                                 validate_steps=NETWORK_VALIDATE_STEPS,
                                 max_outer_iterations=1, prune_steps=NETWORK_PRUNE_STEPS)
    exp = make_experiment(cfg)
    host = make_experiment(replace(cfg, device="cpu"))
    check(row_scan.supports_row_scan(exp.graph),
          "brick_network: the brick wall does not take the row sweep")
    gen = torch.Generator().manual_seed(0)
    target = target_tensor_init(exp, BRICK_MASK, gen)
    target_h = target_tensor_init(host, BRICK_MASK, 0)
    check(all(torch.equal(target[0][k].cpu(), target_h[0][k]) for k in target_h[0]),
          "brick_network: the target's cores differ between card and host")
    vfit, vfit_h = exp.validate_fit, host.validate_fit
    t_eff, log_tt = vfit.prepare(*target)
    t_eff_h, _ = vfit_h.prepare(*target_h)

    # the first validation steps on the card, keeping their cores; the
    # host's −log F at those cores must equal the card's
    dc = vfit.drivers
    params = exp.init_params(2)
    opt = dc.optimizer.init(params)
    mask = exp.mask_vector([])
    card, host_at_card = [], []
    for _ in range(CHECK_STEPS):
        cores = params_to_numpy(params)
        params, opt, nlf = dc.step(params, opt, mask, t_eff, log_tt)
        card.append(float(nlf))
        host_at_card.append(host_nlf(host, cores, t_eff_h))
    rel_first = [abs(c - h) / abs(h) for c, h in zip(card, host_at_card)]
    check(max(rel_first) <= TOL_STEP0,
          f"brick_network: card -log F vs host -log F at the same cores, rel {max(rel_first)}")

    # the validation fit, from the generator's next cores
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ok, fid, vsteps, fitted = validate_target_tensor(exp, target, gen, return_params=True)
    torch.cuda.synchronize()
    dt_val = time.perf_counter() - t0
    peak8 = torch.cuda.max_memory_allocated()
    check(math.isfinite(fid) and vsteps >= 1, f"brick_network: validation F = {fid}")

    # network mode computes the fidelity: at phase 8's validated cores
    # (1 - F ~ 1e-3), the row sweep in complex128, on the card and on the
    # host, equals the dense fidelity in complex128, and the card's
    # complex64 value is within the float32 rounding of its three O(20)
    # log-overlaps of that reference
    host_cores = {k: v.cpu().to(torch.complex128) for k, v in dense_fitted.items()}
    host_target = {k: v.to(torch.complex128) for k, v in t_eff_h.items()}
    core_fn = make_core_only_fn(host.graph)
    overlap = _overlap_fn(host.graph)
    with torch.no_grad(), matmul_precision("highest"):
        card_v = float(-torch.expm1(network_log_fidelity(exp.graph, dense_fitted, t_eff)))
        card128 = float(-torch.expm1(network_log_fidelity(
            exp.graph, {k: v.to(torch.complex128) for k, v in dense_fitted.items()},
            {k: v.to(torch.complex128) for k, v in t_eff.items()})))
        o_n, t_n = _normalize(host_cores), _normalize(host_target)
        terms = [float(overlap(*ab)) for ab in ((o_n, t_n), (o_n, o_n), (t_n, t_n))]
        net64 = -math.expm1(2.0 * terms[0] - terms[1] - terms[2])
        dense64 = float(1.0 - fidelity(core_fn(host_cores), core_fn(host_target)))
    tol_round = ROUNDING_ULPS * float(np.finfo(np.float32).eps) * (
        2.0 * abs(terms[0]) + abs(terms[1]) + abs(terms[2]))
    infid = {"card_complex64": card_v, "card_network_complex128": card128,
             "host_network_complex128": net64, "host_dense_complex128": dense64,
             "log_overlaps": terms, "card_tolerance": tol_round}
    check(max(abs(net64 - dense64), abs(card128 - dense64)) <= TOL_NETWORK_DENSE,
          f"brick_network: 1 - F in complex128, row sweep {card128} on the card and "
          f"{net64} on the host vs dense {dense64}")
    check(abs(card_v - net64) <= tol_round,
          f"brick_network: 1 - F on the card {card_v} vs {net64} in complex128 "
          f"(float32 rounding bound {tol_round})")

    # one pass of the prune loop warm-started at the planted network, card
    # then host
    t0 = time.perf_counter()
    pruned, attempts = symmetry_breaking(exp, target, shuffle_seed=0,
                                         warm_params=_planted(exp, BRICK_MASK), verbose=False)
    torch.cuda.synchronize()
    dt_prune = time.perf_counter() - t0
    t0 = time.perf_counter()
    pruned_h, attempts_h = symmetry_breaking(host, target_h, shuffle_seed=0,
                                             warm_params=_planted(host, BRICK_MASK),
                                             verbose=False)
    dt_prune_h = time.perf_counter() - t0
    check(sorted(pruned) == BRICK_MASK and (pruned, attempts) == (pruned_h, attempts_h),
          f"brick_network: the prune pass pruned {pruned} in {attempts} attempts on the "
          f"card, {pruned_h} in {attempts_h} on the host; planted {BRICK_MASK}")

    box = {"p": fitted, "o": dc.optimizer.init(fitted)}

    def one_step():
        box["p"], box["o"], m = dc.step(box["p"], box["o"], mask, t_eff, log_tt)
        float(m)  # the exit test's host sync, as in the fit loop

    prof8 = _profile_steps(one_step, dt_val / vsteps * 1e3, steps=1)

    # one piece of the batched prune, as the benchmark's cell runs it: the
    # row sweep's gate steps each launch R1 (and R2 with a gradient) once
    # for all lanes, prepare's <t,t> forward included
    masks = torch.stack([exp.mask_vector([c]) for c in range(LANE_CHUNK)])
    torch.cuda.synchronize()
    row_scan.reset_launch_counts()
    res = exp.prune_fit.batched(_planted(exp, BRICK_MASK), masks, *target,
                                chunk_steps=BATCHED_K_NETWORK)
    torch.cuda.synchronize()
    row_launches = row_scan.launch_counts()
    rows = row_scan._schedule(exp.graph, None)
    gates = sum(f is not None for r in rows for f in r.gates or ())
    einsums = sum(len(r.steps) for r in rows if r.steps) - gates
    overlaps = 1 + 2 * res.steps  # <t,t>, then <eff,t> and <eff,eff> per step
    planned = {"row_gate_fwd": gates * overlaps, "row_gate_bwd": gates * 2 * res.steps,
               "row_step_einsum": einsums * overlaps}
    check(row_launches == planned,
          f"brick_network: {LANE_CHUNK}-lane piece of {res.steps} steps launched "
          f"{row_launches}, planned {planned}")
    seconds_a = time.perf_counter() - t_start
    t_b = time.perf_counter()

    # (b) the JAX flagship through bench/flagship.py's helpers of run_32q:
    # 32 x 5, float32, its mask, target and start, the first validation steps
    exp32 = flagship.build_32q(FLAGSHIP_STEPS, FLAGSHIP_STEPS, device="cuda")
    host32 = flagship.build_32q(FLAGSHIP_STEPS, FLAGSHIP_STEPS, device="cpu")
    n32 = exp32.graph.ncores
    n_pairwise = pairwise_per_overlap(exp32.graph)
    check(n32 == (FLAGSHIP_QUBITS - 1) * FLAGSHIP_CELLS and n_pairwise == FLAGSHIP_PAIRWISE,
          f"flagship: {n32} cores, {n_pairwise} pairwise einsums per overlap")
    _, target32, params = flagship.problem_32q(exp32)
    t_eff32, log_tt32 = exp32.validate_fit.prepare(*target32)
    t_eff32_h, _ = host32.validate_fit.prepare(*(
        {k: v.cpu() for k, v in target32[0].items()}, target32[1].cpu()))
    d32 = exp32.validate_fit.drivers
    mask_all = exp32.mask_vector([])
    # one-time work (plans, allocator) out of the timing
    d32.step(params, d32.optimizer.init(params), mask_all, t_eff32, log_tt32)
    opt = d32.optimizer.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, kept = [], {}
    t0 = time.perf_counter()
    for i in range(FLAGSHIP_STEPS):
        if i in FLAGSHIP_CHECK_AT:
            kept[i] = params_to_numpy(params)
        params, opt, nlf = d32.step(params, opt, mask_all, t_eff32, log_tt32)
        losses.append(float(nlf))  # the exit test's host sync, as in the fit loop
    torch.cuda.synchronize()
    dt32 = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"flagship: -log F {losses[0]} -> {losses[-1]}")
    host32_nlf = {i: host_nlf(host32, kept[i], t_eff32_h) for i in FLAGSHIP_CHECK_AT}
    rel32 = {i: abs(losses[i] - host32_nlf[i]) / abs(host32_nlf[i]) for i in FLAGSHIP_CHECK_AT}
    check(max(rel32.values()) <= TOL_FIT,
          f"flagship: card -log F vs host at the same cores, rel {rel32}")
    box32 = {"p": params, "o": opt}

    def one_step32():
        box32["p"], box32["o"], m = d32.step(box32["p"], box32["o"], mask_all, t_eff32,
                                            log_tt32)
        float(m)

    # one step: reading a trace of ~6800 launches takes seconds
    prof32 = _profile_steps(one_step32, dt32 / FLAGSHIP_STEPS * 1e3, steps=1)
    seconds_b = time.perf_counter() - t_b

    # (c) the CLI in network mode at 4 x 2
    cli = _cli_pair(["--fidelity-mode", "network", "--n-qubits", "4", "--n-cells", "2",
                        "--restarts", "1", "--prune-steps", str(BRICK_CLI_PRUNE_STEPS),
                        "--validate-steps", str(NETWORK_CLI_VALIDATE_STEPS)])
    kernel_launches = {**chain_overlap.launch_counts(), **transfer_step.launch_counts()}
    rec = {
        "phase": "brick_network",
        "reference_default": {
            "program": "apps.symmetry_breaking defaults with fidelity_mode='network': brick "
                       "wall 8 qubits x 5 cells, rank 2, complex64, sgdg (validate lr 1; "
                       "prune lr 1e-2), tol 1e-3, planted mask of the reference CLI",
            "reduced": {"validate_steps": NETWORK_VALIDATE_STEPS,
                        "prune_steps": NETWORK_PRUNE_STEPS, "max_outer_iterations": 1},
            "pairwise_per_overlap": pairwise_per_overlap(exp.graph),
            "first_neg_log_f_card": card,
            "host_at_card_rel_err_max": max(rel_first),
            "validated": ok,
            "validate_infidelity": 1.0 - fid,
            "validate_steps": vsteps,
            "validate_seconds": dt_val,
            "fit_steps_per_s": vsteps / dt_val,
            "max_memory_allocated_bytes": peak8,
            "infidelity_checks": infid,
            "prune_warm_start": "the planted network",
            "pruned": sorted(pruned),
            "attempts": attempts,
            "prune_seconds": dt_prune,
            "host_prune_seconds": dt_prune_h,
            "seconds": seconds_a,
            "profile": prof8,
            "lane_piece": {"lanes": LANE_CHUNK, "steps": res.steps,
                           "gate_steps_per_overlap": gates,
                           "einsum_steps_per_overlap": einsums,
                           "row_scan_launches": row_launches},
        },
        "flagship": {
            "program": "bench/flagship.py::build_32q and problem_32q (run_32q's "
                       "experiment, mask, target and start): brick wall 32 qubits x 5 "
                       "cells, rank 2, float32, sgdg lr 1, network fidelity, mask "
                       "default_rng(0).choice(155, 38)",
            "reduced": {"validate_steps": FLAGSHIP_STEPS},
            "cores": n32,
            "pairwise_per_overlap": n_pairwise,
            "neg_log_f_first_last": [losses[0], losses[-1]],
            "neg_log_f_card_host": {i: [losses[i], host32_nlf[i]] for i in FLAGSHIP_CHECK_AT},
            "host_rel_err_max": max(rel32.values()),
            "fit_steps_per_s": FLAGSHIP_STEPS / dt32,
            "ms_per_step": dt32 / FLAGSHIP_STEPS * 1e3,
            "max_memory_allocated_bytes": peak,
            "profile": prof32,
            "seconds": seconds_b,
        },
        "cli": {"reduced": {"n_qubits": 4, "n_cells": 2, "restarts": 1,
                            "prune_steps": BRICK_CLI_PRUNE_STEPS,
                            "validate_steps": NETWORK_CLI_VALIDATE_STEPS}, **cli},
        "port_kernel_launches": kernel_launches,
        "seconds": time.perf_counter() - t_start,
        "card": smi,
    }
    emit(rec)
    return rec


def _lane_sweeps(lanes: int, seed: int, dev):
    """u0, M, w of ``lanes`` independent bench-shape sweeps, stacked on a
    leading lane axis."""
    import torch

    parts = [_random_sweep(16, SWEEP_N, seed + i, dev) for i in range(lanes)]
    return tuple(torch.stack([p[j] for p in parts]).contiguous() for j in range(3))


def _planted(e, planted_mask):
    """The planted network of experiment ``e``: the cores its target draws
    (``init_params(0)``) with identities in the places of ``planted_mask``."""
    import torch

    from tneq_tpu_torch.train.fit import identity_cores, masked_cores

    dtype = e.cfg.dtype
    idents = {k: torch.as_tensor(v).to(device=e.device, dtype=dtype)
              for k, v in identity_cores(e.graph, dtype).items()}
    return masked_cores(e.init_params(0), e.mask_vector(planted_mask), idents,
                        e.graph.core_names, dtype)


def _lane_step(fit, params, masks, shared):
    """One vmapped step of ``fit``'s lanes (``FitDrivers.batched_chunk``),
    all lanes at ``params``, and its wall time in ms (median of 3, with the
    exit test's read of the lane metrics): what a chunk repeats k times."""
    import torch
    from torch.utils._pytree import tree_map

    d = fit.drivers
    opt = d.optimizer.init(params)
    run = d.batched_chunk(1, opt, len(shared))
    b = int(masks.shape[0])
    lanes = (lambda x: x.expand((b,) + tuple(x.shape)).contiguous()  # noqa: E731
             if isinstance(x, torch.Tensor) else x)
    box = {"p": {k: lanes(v) for k, v in params.items()}, "o": tree_map(lanes, opt)}

    def step():
        box["p"], box["o"], m = run(box["p"], box["o"], masks, *shared)
        m.cpu()

    step()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e3)
    return step, sorted(times)[1]


def _decision_sweep_case(D: int, B: int, dev) -> dict:
    """B1 alone at a point of ``bench/pallas_decision``'s grid: the B lanes'
    M-form sweeps (``DECISION_QUBITS`` qubits, bond D) as its ``pallas``
    variant gives them to the kernel, in one launch, against the plain
    version; times, plan and bound."""
    import torch

    from tneq_tpu_torch.bench import pallas_decision as pd
    from tneq_tpu_torch.graph import mps_graph, parse_graph
    from tneq_tpu_torch.ops import chain_overlap as co

    g = parse_graph(mps_graph(DECISION_QUBITS, D, phys=2))
    first, mids, last = (torch.as_tensor(x).to(dev) for x in pd.build_lanes(g, B))
    with torch.no_grad():
        v0, M, w = torch.func.vmap(lambda f, m, l: co.chain_pair_to_mv((f, m, l), (f, m, l)))(
            first, mids, last)
    del first, mids, last
    u0 = (v0 / (v0.abs().amax(-1, keepdim=True) + co._TINY)).contiguous()
    M, w = M.contiguous(), w.contiguous()
    n, S = int(M.shape[1]), int(M.shape[-1])
    co.reset_launch_counts()
    kf = co._sweep_fwd_cuda(u0, M, w)
    torch.cuda.synchronize()
    check(co.launch_counts()["chain_sweep_fwd"] == 1,
          f"batched (a) {D}x{B}: B1 took {co.launch_counts()} launches, expected one")
    pf = co._sweep_fwd_plain(u0, M, w)
    names = ("ustack", "scales", "f", "logsum", "ulast")
    err = {nm: rel_err(k, p) for nm, k, p in zip(names, kf, pf)}
    err["f"] = rel_err(kf[2], pf[2], scale=(pf[4] * w).abs().sum(-1).max())
    bad = {k: v for k, v in err.items() if not v <= TOL_KERNEL}
    check(not bad, f"batched (a) {D}x{B}: B1 beyond {TOL_KERNEL}: {bad}")
    abs_err = max(float((k - p).abs().max()) for k, p in zip(kf, pf))
    del kf, pf

    def kernel():
        return co._sweep_fwd_cuda(u0, M, w)

    def plain():
        return co._sweep_fwd_plain(u0, M, w)

    dms = device_ms(kernel, reps=5)
    cluster, strip, stages, tile_rows, smem = co._plan_for(M, backward=False)
    rec = {"bond": D, "lanes": B, "n": n, "S": S, "rel_err": err, "max_abs_err": abs_err,
           "ms": cuda_ms(kernel, reps=10), "device_ms": dms,
           "device_ms_per_lane": dms / B if dms else None,
           "plain_ms": cuda_ms(plain, reps=5, warmup=1),
           "plain_device_ms": device_ms(plain, reps=3),
           **sweep_bounds(n, S, B)["chain_sweep_fwd"],
           "plan": {"cluster": cluster, "strip": strip, "ring_stages": stages,
                    "tile_rows": tile_rows, "smem_bytes": smem}}
    del u0, M, w
    torch.cuda.empty_cache()
    return rec


def phase_lane_kernels(smi: str) -> dict:
    """Phase 10 (a), run right after phase 2 (torch.profiler's device times
    come back empty now and then late in the script): B1/B2 with a lane
    axis at the bench shape, 1 and 8 lanes, against the plain version with
    the lane axis and one launch per lane; one launch per sweep."""
    import torch

    from tneq_tpu_torch.ops import chain_overlap as co

    dev = torch.device("cuda", 0)
    t_a = time.perf_counter()
    cases = []
    for lanes in LANE_COUNTS:
        u0, M, w = _lane_sweeps(lanes, 100, dev)
        r0 = (1.7 * w).contiguous()
        co.reset_launch_counts()
        kf = co._sweep_fwd_cuda(u0, M, w)
        kb = co._sweep_bwd_cuda(r0, M, kf[0], kf[1])
        torch.cuda.synchronize()
        counts = co.launch_counts()
        check(counts == {"chain_sweep_fwd": 1, "chain_sweep_bwd": 1},
              f"batched (a): {lanes} lanes took {counts} launches, expected one per sweep")
        pf = co._sweep_fwd_plain(u0, M, w)
        pb = co._sweep_bwd_plain(r0, M, kf[0], kf[1])
        names = ("ustack", "scales", "f", "logsum", "ulast", "dM", "du0")
        err = {nm: rel_err(k, p) for nm, k, p in zip(names, kf + kb, pf + pb)}
        err["f"] = rel_err(kf[2], pf[2], scale=(pf[4] * w).abs().sum(-1).max())
        single = 0.0
        for i in range(lanes):  # the same sweeps, one launch per lane
            one = co._sweep_fwd_cuda(u0[i], M[i], w[i])
            oneb = co._sweep_bwd_cuda(r0[i], M[i], one[0], one[1])
            single = max(single, *(rel_err(k[i], o) for k, o in zip(kf + kb, one + oneb)))
        torch.cuda.synchronize()
        err["vs_single_lane_launches"] = single
        bad = {k: v for k, v in err.items() if not v <= TOL_KERNEL}
        check(not bad, f"batched (a): {lanes} lanes beyond {TOL_KERNEL}: {bad}")
        calls = {
            "chain_sweep_fwd": (lambda: co._sweep_fwd_cuda(u0, M, w),
                                lambda: co._sweep_fwd_plain(u0, M, w),
                                lambda: [co._sweep_fwd_cuda(u0[i], M[i], w[i])
                                         for i in range(lanes)]),
            "chain_sweep_bwd": (lambda: co._sweep_bwd_cuda(r0, M, kf[0], kf[1]),
                                lambda: co._sweep_bwd_plain(r0, M, kf[0], kf[1]),
                                lambda: [co._sweep_bwd_cuda(r0[i], M[i], kf[0][i], kf[1][i])
                                         for i in range(lanes)]),
        }
        times, plans = {}, {}
        bounds = sweep_bounds(SWEEP_N, 256, lanes)
        for name, (kernel, plain, singles) in calls.items():
            dms = device_ms(kernel)
            times[name] = {
                "ms": cuda_ms(kernel),
                "device_ms": dms,
                "device_ms_per_lane": dms / lanes if dms else None,
                "plain_ms": cuda_ms(plain),
                "single_lane_launches_device_ms": device_ms(singles),
                **bounds[name],
            }
            cluster, strip, stages, tile_rows, smem = co._plan_for(
                M, backward=name == "chain_sweep_bwd")
            plans[name] = {"cluster": cluster, "strip": strip, "ring_stages": stages,
                           "tile_rows": tile_rows, "smem_bytes": smem}
        abs_err = {"chain_sweep_fwd": max(float((k - p).abs().max()) for k, p in zip(kf, pf)),
                   "chain_sweep_bwd": max(float((k - p).abs().max()) for k, p in zip(kb, pb))}
        cases.append({"lanes": lanes, "n": SWEEP_N, "S": 256, "launches": counts,
                      "rel_err": err, "max_abs_err": abs_err, "times": times,
                      "plans": plans})
    grid = [_decision_sweep_case(*(int(x) for x in spec.split("x")), dev)
            for spec in DECISION_CONFIGS.split(",")]
    rec = {"phase": "batched", "part": "a_lane_kernels", "tolerance": TOL_KERNEL,
           "cases": cases, "decision_grid": grid, "seconds": time.perf_counter() - t_a,
           "card": smi}
    emit(rec)
    return rec



def phase_batched(smi: str, experiment, dense_fitted) -> list:
    """Phase 10 (b)-(f): the batched prune (``symmetry_breaking_batched``,
    ``fit.batched``: lockstep lanes under ``torch.func.vmap``); one JSON
    line per part."""
    import numpy as np
    import torch

    from tneq_tpu_torch.apps.symmetry_breaking import (
        SymmetryBreakingConfig, make_experiment, symmetry_breaking_batched, target_tensor_init,
    )
    from tneq_tpu_torch.model.qctn import params_from_numpy, params_to_numpy
    from tneq_tpu_torch.ops import chain_overlap as co
    from tneq_tpu_torch.ops import transfer_step
    from tneq_tpu_torch.ops.complex_pair import pair_tree, to_pair

    recs = []

    def done(part: str, rec: dict) -> None:
        rec = {"phase": "batched", "part": part, **rec, "card": smi}
        emit(rec)
        recs.append(rec)

    def lanes_at(params, lanes):
        """Each lane's params, one dict per lane."""
        return [{k: v[i] for k, v in params.items()} for i in range(lanes)]

    # (b) the batched prune of the dense 8 x 5 wall: the target planted with
    # one core pruned, the lanes warm at its planted network; the first
    # round accepts that core, the second finds no viable candidate
    def brick_prune(mode: str, k: int):
        cfg = SymmetryBreakingConfig(device="cuda", fidelity_mode=mode, prune_steps=k,
                                     lane_chunk=LANE_CHUNK)
        exp = make_experiment(cfg)
        host = make_experiment(replace(cfg, device="cpu"))
        target = target_tensor_init(exp, BATCHED_PLANTED, 0)
        target_h = target_tensor_init(host, BATCHED_PLANTED, 0)
        warm, warm_h = _planted(exp, BATCHED_PLANTED), _planted(host, BATCHED_PLANTED)
        co.reset_launch_counts()
        transfer_step.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pruned, count = symmetry_breaking_batched(exp, target, warm_params=warm, verbose=False)
        torch.cuda.synchronize()
        dt_prune = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        kernel_launches = {**co.launch_counts(), **transfer_step.launch_counts()}
        # the first piece of lanes again, its lane params kept: each lane's
        # metric at them, card against host
        masks = torch.stack([exp.mask_vector([c]) for c in range(LANE_CHUNK)])
        args = target if mode == "network" else (target,)
        t0 = time.perf_counter()
        res = exp.prune_fit.batched(warm, masks, *args, chunk_steps=k)
        torch.cuda.synchronize()
        dt_piece = time.perf_counter() - t0
        dc, dh = exp.prune_fit.drivers, host.prune_fit.drivers
        shared_c = exp.prune_fit.prepare(*target) if mode == "network" else (target,)
        shared_h = host.prune_fit.prepare(*target_h) if mode == "network" else (target_h,)
        card_m, host_m = [], []
        for i, p in enumerate(lanes_at(res.params, LANE_CHUNK)):
            card_m.append(float(dc.step(p, dc.optimizer.init(p), masks[i], *shared_c)[2]))
            p_h = params_from_numpy(params_to_numpy(p), "cpu")
            host_m.append(float(dh.step(p_h, dh.optimizer.init(p_h), masks[i].cpu(),
                                        *shared_h)[2]))
        diff = [abs(c - h) / max(1.0, abs(h)) for c, h in zip(card_m, host_m)]
        check(max(diff) <= TOL_LANE,
              f"batched ({mode}): lane metrics card {card_m} vs host {host_m} at the card's "
              f"lane params")
        # launches and idle share of one vmapped step of the piece's lanes
        step, step_ms = _lane_step(exp.prune_fit, warm, masks, shared_c)
        prof = _profile_steps(step, step_ms, steps=1)
        rec = {
            "program": f"symmetry_breaking_batched, brick wall 8 x 5, rank 2, complex64, "
                       f"sgdg prune lr 1e-2, {mode} fidelity, lane_chunk {LANE_CHUNK}, "
                       f"k = {k}",
            "reduced": {"prune_steps": k, "planted": BATCHED_PLANTED},
            "warm_start": "the planted network",
            "pruned": pruned, "attempts": count, "prune_seconds": dt_prune,
            "max_memory_allocated_bytes": peak,
            "port_kernel_launches": kernel_launches,
            "piece": {"lanes": LANE_CHUNK, "steps": res.steps, "seconds": dt_piece,
                      "lane_steps_per_s": LANE_CHUNK * res.steps / dt_piece,
                      "metric_card_at_lane_params": card_m,
                      "metric_host_at_lane_params": host_m,
                      "max_diff": max(diff)},
            "lane_step_ms": step_ms,
            "profile_of_a_lane_step": prof,
            "launches_per_chunk_step": prof["kernel_launches_per_step"],
            "device_idle_share": prof["device_idle_share"],
        }
        return rec, exp, host, target, target_h, warm_h

    expected = (BATCHED_PLANTED, 2 * 35 - 1)  # two rounds: 35 candidates, then 34
    t_b = time.perf_counter()
    rec_b, exp_b, host_b, _, target_bh, warm_bh = brick_prune("dense", BATCHED_K)
    t0 = time.perf_counter()
    pruned_h, count_h = symmetry_breaking_batched(host_b, target_bh, warm_params=warm_bh,
                                                  verbose=False)
    rec_b["host_prune_seconds"] = time.perf_counter() - t0
    rec_b["host_pruned"], rec_b["host_attempts"] = pruned_h, count_h
    check((rec_b["pruned"], rec_b["attempts"]) == (pruned_h, count_h) == expected,
          f"batched (b): pruned {rec_b['pruned']} in {rec_b['attempts']} on the card, "
          f"{pruned_h} in {count_h} on the host; expected {expected}")
    done("b_dense", {**rec_b, "seconds": time.perf_counter() - t_b})

    # (c) the same in network mode (the host checks the lanes' -log F at the
    # card's lane params; its own prune would take minutes)
    t_c = time.perf_counter()
    rec_c = brick_prune("network", BATCHED_K_NETWORK)[0]
    check((rec_c["pruned"], rec_c["attempts"]) == expected,
          f"batched (c): pruned {rec_c['pruned']} in {rec_c['attempts']}, expected {expected}")
    done("c_network", {**rec_c, "seconds": time.perf_counter() - t_c})

    # (d) the MPS experiment of phase 4 with --batched semantics
    t_d = time.perf_counter()
    exp4, target4, fitted4 = experiment
    co.reset_launch_counts()
    t0 = time.perf_counter()
    pruned4, count4 = symmetry_breaking_batched(exp4, target4, warm_params=fitted4,
                                                verbose=False)
    torch.cuda.synchronize()
    dt4 = time.perf_counter() - t0
    counts4 = co.launch_counts()
    check(sorted(pruned4) == [3, 7],
          f"batched (d): the MPS experiment pruned {pruned4}, planted [3, 7]")
    check(counts4["chain_sweep_fwd"] > 0 and counts4["chain_sweep_bwd"] > 0,
          f"batched (d): the lanes did not run the sweep kernels: {counts4}")
    # one chunk at 1 lane and at LANE_CHUNK lanes: the same B1/B2 launches
    one_chunk = make_experiment(replace(exp4.cfg, prune_steps=BATCHED_K))
    per_lanes = {}
    for lanes in (1, LANE_CHUNK):
        masks = torch.stack([one_chunk.mask_vector([1 + i % 10]) for i in range(lanes)])
        co.reset_launch_counts()
        res = one_chunk.prune_fit.batched(fitted4, masks, *target4, chunk_steps=BATCHED_K)
        torch.cuda.synchronize()
        per_lanes[lanes] = {k: v / res.steps for k, v in co.launch_counts().items()}
    check(per_lanes[1] == per_lanes[LANE_CHUNK] and per_lanes[1]["chain_sweep_fwd"] > 0,
          f"batched (d): B1/B2 launches per chunk step {per_lanes} grow with the lanes")
    done("d_mps_experiment", {
        "program": "symmetry_breaking_batched on phase 4's experiment: MPS 12 qubits, bond "
                   "16, float32, adam (prune lr 5e-2, <= 480 steps), network fidelity, "
                   f"lane_chunk {exp4.cfg.lane_chunk}, k = {exp4.cfg.fit_sync_every}",
        "pruned": sorted(pruned4), "attempts": count4, "seconds": dt4,
        "launches": counts4, "launches_per_chunk_step": per_lanes,
        "total_seconds": time.perf_counter() - t_d,
    })

    # (e) pair mode: 20 prune steps from phase 8's validated cores (against
    # phase 8's target) in complex64 and in stacked-real pairs; then the
    # CLI, pair and batched
    t_e = time.perf_counter()
    target8 = target_tensor_init(exp_b, BRICK_MASK, 0)
    pair_runs = {}
    for form in ("complex64", "complex64-pair"):
        e = exp_b if form == "complex64" else make_experiment(
            replace(exp_b.cfg, complex_as_real=True))
        d = e.prune_fit.drivers
        p = dense_fitted if form == "complex64" else pair_tree(dense_fitted)
        t = target8 if form == "complex64" else to_pair(target8)
        o, m = d.optimizer.init(p), e.mask_vector([])
        vals = []
        for _ in range(PAIR_STEPS):
            p, o, v = d.step(p, o, m, t)
            vals.append(float(v))
        pair_runs[form] = vals
    pair_diff = max(abs(a - b) for a, b in zip(*pair_runs.values()))
    check(pair_diff <= TOL_PAIR,
          f"batched (e): pair 1 - F vs complex64 on the card, max diff {pair_diff}")
    cli = _cli_pair(["--n-qubits", "4", "--n-cells", "2", "--restarts", "1",
                     "--prune-steps", str(BRICK_CLI_PRUNE_STEPS), "--dtype", "complex64-pair",
                     "--batched"])
    done("e_pair", {"infidelity_complex64": pair_runs["complex64"],
                    "infidelity_pair": pair_runs["complex64-pair"], "max_diff": pair_diff,
                    "tolerance": TOL_PAIR, "cli": cli, "seconds": time.perf_counter() - t_e})

    # (f) the 32 x 5 float32 flagship in network mode: one chunk of lanes
    t_f = time.perf_counter()
    cfg32 = SymmetryBreakingConfig(n_qubits=FLAGSHIP_QUBITS, n_cells=FLAGSHIP_CELLS,
                                   fidelity_mode="network", dtype=torch.float32,
                                   device="cuda", prune_steps=FLAGSHIP_LANE_STEPS)
    exp32 = make_experiment(cfg32)
    n32 = exp32.graph.ncores
    mask32 = sorted(np.random.default_rng(0).choice(n32, size=n32 // 4, replace=False).tolist())
    gen32 = torch.Generator().manual_seed(0)
    target32 = target_tensor_init(exp32, mask32, gen32)
    params32 = exp32.init_params(gen32)
    masks32 = torch.stack([exp32.mask_vector([c]) for c in range(LANE_CHUNK)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res32 = exp32.prune_fit.batched(params32, masks32, *target32,
                                    chunk_steps=FLAGSHIP_LANE_STEPS)
    torch.cuda.synchronize()
    dt32 = time.perf_counter() - t0
    peak32 = torch.cuda.max_memory_allocated()
    check(tuple(res32.infidelity.shape) == (LANE_CHUNK,)
          and bool(torch.isfinite(res32.infidelity).all()),
          f"batched (f): lane 1 - F {res32.infidelity}")
    step32, step32_ms = _lane_step(exp32.prune_fit, params32, masks32,
                                   exp32.prune_fit.prepare(*target32))
    prof32 = _profile_steps(step32, step32_ms, steps=1)
    done("f_flagship_chunk", {
        "program": "bench/flagship.py::run_32q on the port (brick wall 32 x 5, float32, "
                   f"sgdg, network fidelity): one chunk of {FLAGSHIP_LANE_STEPS} steps, "
                   f"{LANE_CHUNK} lanes (one core pruned each)",
        "reduced": {"chunk_steps": FLAGSHIP_LANE_STEPS},
        "steps": res32.steps, "seconds": dt32,
        "lane_steps_per_s": LANE_CHUNK * res32.steps / dt32,
        "max_memory_allocated_bytes": peak32,
        "infidelity": res32.infidelity.tolist(),
        "lane_step_ms": step32_ms,
        "profile_of_a_lane_step": prof32,
        "launches_per_chunk_step": prof32["kernel_launches_per_step"],
        "seconds_total": time.perf_counter() - t_f,
    })
    return recs


def draws_agree(a, b, bounds, G) -> dict:
    """JAX's bin-flip rule for two draw blocks ``[S, nq]`` from the same
    uniforms (``tests/test_infer.py``)."""
    import numpy as np

    bin_w = (bounds[1] - bounds[0]) / (G - 1)
    ident, worst = 0, 0.0
    for ra, rb in zip(np.asarray(a), np.asarray(b)):
        diff = np.nonzero(ra != rb)[0]
        if diff.size == 0:
            ident += 1
        else:
            worst = max(worst, abs(float(ra[diff[0]] - rb[diff[0]])) / bin_w)
    ok = worst < FLIP_BINS and ident >= len(a) * 3 // 4
    return {"ok": bool(ok), "identical_rows": ident, "rows": len(a),
            "largest_first_difference_bins": worst}


def _call_stats(fn) -> dict:
    """Seconds of a cold and a warm call (synchronised), and the CUDA
    kernels one call launches (torch.profiler)."""
    import torch

    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prof = _profile_steps(fn, times[1] * 1e3, steps=1)
    return {"out": out, "cold_s": times[0], "warm_s": times[1],
            "launches": prof["kernel_launches_per_step"],
            "device_busy_ms": prof["device_busy_ms_per_step"],
            "device_idle_share": prof["device_idle_share"]}


def _norm_err(card, host) -> float:
    import torch

    card, host = torch.as_tensor(card).cpu().double(), torch.as_tensor(host).double()
    return float((card - host).abs().max()) / max(float(host.abs().max()), 1e-300)


def phase_large_n(smi: str) -> dict:
    """Phase 11 (a): ``bench/large_n_probe`` on the card, at 64 and at 128
    qubits."""
    import numpy as np
    import torch

    from tneq_tpu_torch.bench import large_n_probe as lnp
    from tneq_tpu_torch.bench.headline import sgd_step
    from tneq_tpu_torch.infer.chain_sampling import _chain_sample_from_uniforms, _draw_uniforms
    from tneq_tpu_torch.model.qctn import params_from_numpy
    from tneq_tpu_torch.ops import chain_overlap as co
    from tneq_tpu_torch.train.network_fit import network_log_fidelity

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    parts, launches = [], {k: 0 for k in LARGE_N_PER_STEP}
    for n, steps in LARGE_N:
        t0 = time.perf_counter()
        co.reset_launch_counts()
        run = lnp.fit_and_sample(n, LARGE_N_BOND, steps, LARGE_N_SAMPLES, "cuda")
        counts = co.launch_counts()
        seconds = time.perf_counter() - t0
        for k in launches:
            launches[k] += counts[k]
        rec, losses, draws = run["record"], run["losses"], run["draws"]
        g = run["graph"]
        check(bool(torch.isfinite(losses).all()), f"large_n {n}q: non-finite loss")
        check(float(losses[-1]) < float(losses[0]),
              f"large_n {n}q: loss did not fall: {float(losses[0])} -> {float(losses[-1])}")
        want = {k: v * steps for k, v in LARGE_N_PER_STEP.items()}
        check(run["launches"] == want,
              f"large_n {n}q: launches {run['launches']} over {steps} steps, expected {want}")
        check(draws.shape == (LARGE_N_SAMPLES, n) and bool(np.isfinite(draws).all())
              and float(np.abs(draws).max()) <= 5.0,
              f"large_n {n}q: draws not finite in [-5, 5] of shape {(LARGE_N_SAMPLES, n)}")
        part = {"qubits": n, "bond": LARGE_N_BOND, "fit_steps": steps, "record": rec,
                "fit_steps_per_s": rec["value"], "seconds": seconds,
                "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
                "launches_timed_fit": run["launches"],
                "launches_per_step": {k: v / steps for k, v in run["launches"].items()},
                "launches_with_warmup": counts,
                "sample_cold_s": rec["sample_cold_s"], "sample_warm_s": rec["sample_warm_s"],
                "distinct_values": int(len(np.unique(draws.round(3))))}
        target = params_from_numpy(run["target"], dev)
        box = {"p": params_from_numpy(run["start"], dev)}

        def one_step():
            box["p"], _ = sgd_step(g, box["p"], target)

        part["profile"] = _profile_steps(one_step, 1e3 / rec["value"], steps=1)
        part["sweep_case"] = _sweep_case(LARGE_N_BOND, n - 3, seed=n)
        if n == LARGE_N[0][0]:
            with torch.no_grad():
                host0 = float(-network_log_fidelity(
                    g, params_from_numpy(run["start"], "cpu"),
                    params_from_numpy(run["target"], "cpu")))
            rel0 = abs(float(losses[0]) - host0) / max(abs(host0), 1e-30)
            check(rel0 <= TOL_STEP0, f"large_n {n}q: step-0 -log F {float(losses[0])} "
                                     f"vs host {host0} (rel {rel0})")
            check(part["distinct_values"] >= MIN_DISTINCT,
                  f"large_n {n}q: {part['distinct_values']} distinct draws")
            # the cold call's uniforms, drawn anew from its generator; the
            # card repeats its draws bit for bit, the host by the rule
            gen = torch.Generator(device=dev).manual_seed(lnp.SAMPLE_SEEDS[0])
            us = _draw_uniforms(gen, g.nqubits, LARGE_N_SAMPLES, dev)
            K = g.output_ranks[0]
            kw = dict(grid_size=LARGE_N_GRID, dtype=torch.float32)
            again = _chain_sample_from_uniforms(g, target, run["states"], K, us, **kw)
            host = _chain_sample_from_uniforms(
                g, params_from_numpy(run["target"], "cpu"),
                [s.cpu() for s in run["states"]], K, us.cpu(), **kw)
            check(np.array_equal(again.cpu().numpy(), draws),
                  f"large_n {n}q: the card's draws from the same uniforms differ")
            agree = draws_agree(draws, host.numpy(), (-5.0, 5.0), LARGE_N_GRID)
            check(agree["ok"], f"large_n {n}q: card vs host draws {agree}")
            part.update(loss_step0=float(losses[0]), loss_step0_host=host0,
                        loss_step0_rel_err=rel0, card_vs_host_draws=agree)
        parts.append(part)
    rec = {"phase": "inference", "part": "a_large_n",
           "program": "bench/large_n_probe.py::fit_and_sample: mps_graph(n, 16, phys=2), "
                      "float32, SGD lr 1e-3 on -log F, then sample(32 draws, K=2, grid 200)",
           "launches": launches, "parts": parts,
           "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(rec)
    return rec


def phase_engine(smi: str) -> dict:
    """Phase 11 (b): the README's Quick start through ``EngineSiamese`` on
    the card, each call against the host's at the same inputs."""
    import numpy as np
    import torch

    from tneq_tpu_torch.engine import EngineSiamese
    from tneq_tpu_torch.graph import parse_graph, wall_graph
    from tneq_tpu_torch.infer.chain_sampling import _draw_uniforms
    from tneq_tpu_torch.infer.sampling import _sample_from_uniforms
    from tneq_tpu_torch.model.qctn import QCTN
    from tneq_tpu_torch.ops import pairwise as pw
    from tneq_tpu_torch.train.trainer import basis_states

    t_phase = time.perf_counter()
    g = parse_graph(wall_graph(ENGINE_QUBITS, layers=ENGINE_LAYERS, dim=2))
    x = np.random.default_rng(0).normal(size=(ENGINE_BATCH, ENGINE_QUBITS)).astype(np.float32)
    side = {}
    for where in ("cuda", "cpu"):
        model = QCTN(g, seed=0, dtype=torch.complex64, device=where)
        eng = EngineSiamese(device=where)
        mx, _ = eng.generate_data(x, K=2)
        side[where] = (model, eng, mx, basis_states(g, device=where))

    def calls(model, eng, mx, states):
        return {
            "contract": lambda: eng.contract_with_compiled_strategy(model, states, mx),
            "contract_scaled": lambda: eng.contract_with_compiled_strategy(
                model, states, mx, ret_type="scaled"),
            "gradient_dict": lambda: eng.contract_with_compiled_strategy_for_gradient(
                model, states, mx),
            "gradient_list": lambda: eng.contract_with_compiled_strategy_for_gradient(
                model, states, mx, ret="list"),
            "full_probability": lambda: eng.calculate_full_probability(model, states, mx),
            "marginal_probability": lambda: eng.calculate_marginal_probability(
                model, states, [mx[0], mx[3], mx[5]], [0, 3, 5]),
            "conditional_probability": lambda: eng.calculate_conditional_probability(
                model, states, mx[:3], [0, 1, 2], [0]),
            "sample": lambda: eng.sample(model, states, ENGINE_SAMPLES, 2),
        }

    card_calls, host_calls = calls(*side["cuda"]), calls(*side["cpu"])
    results = {}
    for name, fn in card_calls.items():
        stats = _call_stats(fn)
        card, host = stats.pop("out"), host_calls[name]() if name != "sample" else None
        if name == "contract_scaled":
            card, host = card[0] * torch.exp(card[1]), host[0] * torch.exp(host[1])
        if name.startswith("gradient"):
            (card_loss, card_g), (host_loss, host_g) = card, host
            if name == "gradient_dict":
                card_g, host_g = list(card_g.values()), list(host_g.values())
            scale = max(float(h.abs().max()) for h in host_g)
            stats["loss_rel_err"] = abs(float(card_loss) - float(host_loss)) / abs(float(host_loss))
            stats["grad_err"] = max(float((c.cpu() - h).abs().max()) for c, h in
                                    zip(card_g, host_g)) / scale
            check(stats["loss_rel_err"] <= TOL_INFER and stats["grad_err"] <= TOL_INFER,
                  f"engine {name}: loss rel {stats['loss_rel_err']}, grads {stats['grad_err']}")
        elif name == "sample":
            model, eng, _, states = side["cuda"]
            us = _draw_uniforms(torch.Generator(device="cuda").manual_seed(0),
                                ENGINE_QUBITS, ENGINE_SAMPLES, torch.device("cuda", 0))
            hm, _, _, hs = side["cpu"]
            host = _sample_from_uniforms(g, hm.params, hs, 2, us.cpu(), grid_size=ENGINE_GRID)
            stats["card_vs_host_draws"] = draws_agree(card.cpu().numpy(), host.numpy(),
                                                      (-5.0, 5.0), ENGINE_GRID)
            check(tuple(card.shape) == (ENGINE_SAMPLES, ENGINE_QUBITS)
                  and bool(torch.isfinite(card).all()),
                  f"engine sample: shape {tuple(card.shape)} or non-finite draws")
            check(stats["card_vs_host_draws"]["ok"],
                  f"engine sample: card vs host {stats['card_vs_host_draws']}")
            # the largest pairwise step of the generic sampler's env contractions
            ranks, einsum = [], pw.einsum
            pw.einsum = lambda eq, *ops: ranks.append(pw._lettered(eq)[1]) or einsum(eq, *ops)
            try:
                fn()
            finally:
                pw.einsum = einsum
            stats["largest_pairwise_step_axes"] = max(ranks)
            stats["pairwise_steps_per_call"] = len(ranks)
        else:
            stats["rel_err"] = _norm_err(card, host)
            check(bool(torch.isfinite(card).all()) and stats["rel_err"] <= TOL_INFER,
                  f"engine {name}: card vs host {stats['rel_err']}")
        results[name] = stats
    # utils/plots.marginal_grid of the same cores: P(x0, x1) on its default
    # 100 x 100 grid, card against host (the PNG renderers need matplotlib,
    # which a card's host may lack: the record says whether it is there)
    import importlib.util

    from tneq_tpu_torch.utils.plots import marginal_grid

    t0 = time.perf_counter()
    grid = marginal_grid(g, side["cuda"][0].params, device="cuda")
    dt_grid = time.perf_counter() - t0
    host_grid = marginal_grid(g, side["cpu"][0].params, device="cpu")
    grid_err = float(np.abs(grid - host_grid).max() / np.abs(host_grid).max())
    check(grid.shape == (100, 100) and bool(np.isfinite(grid).all())
          and grid_err <= TOL_INFER, f"engine marginal_grid: card vs host {grid_err}")
    results["marginal_grid"] = {"edge_size": 100, "seconds": dt_grid, "rel_err": grid_err,
                                "max": float(grid.max()),
                                "matplotlib": importlib.util.find_spec("matplotlib")
                                is not None}
    rec = {"phase": "inference", "part": "b_engine",
           "program": "README Quick start: EngineSiamese on QCTN(wall_graph(8, layers=4, "
                      "dim=2)), complex64, seed 0, x [32, 8] from default_rng(0), K = 2; "
                      "sample 256 draws at grid 1000 (generic env sampler); "
                      "utils/plots.marginal_grid of qubits (0, 1)",
           "tolerance": TOL_INFER, "calls": results,
           "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(rec)
    return rec


def phase_probability_checks(smi: str) -> dict:
    """Phase 11 (c): full_probability against the Trainer's B3 sweep on the
    born_rule cell, and log P at 30 qubits on the card and the host."""
    import numpy as np
    import torch

    from tneq_tpu_torch.graph import mps_graph, parse_graph
    from tneq_tpu_torch.infer import full_probability
    from tneq_tpu_torch.model.qctn import init_params
    from tneq_tpu_torch.ops import transfer_step as ts
    from tneq_tpu_torch.ops.features import generate_data, measurement_matrices
    from tneq_tpu_torch.train.data import gaussian_batches
    from tneq_tpu_torch.train.trainer import Trainer, basis_states

    t_phase = time.perf_counter()
    B, D, K = BORN_SHAPE
    graph = parse_graph(mps_graph(8, D, phys=K))
    params = init_params(graph, 0, torch.float32, device="cuda")
    x = gaussian_batches(4, B, 8, seed=0, device="cuda")[0]
    states = basis_states(graph, dtype=torch.float32, device="cuda")
    tr = Trainer(graph, dtype=torch.float32, device="cuda")
    ts.reset_launch_counts()
    p_kernel = tr.probability(params, states, x)
    counts = ts.launch_counts()
    check(counts == {"transfer_step": 1, "transfer_step_complex": 0},
          f"probability cross-check: B3/B4 launches {counts}, expected 1 / 0")
    mx = measurement_matrices(x, K)
    p_einsum = full_probability(graph, params, states, [mx[:, q] for q in range(8)])
    born_err = _norm_err(p_einsum, p_kernel.cpu())
    check(born_err <= TOL_INFER, f"full_probability vs Trainer.probability: {born_err}")

    g30 = parse_graph(mps_graph(30, dim=2))
    logs = {}
    for where in ("cuda", "cpu"):
        p30 = {k: 16.0 * v for k, v in init_params(g30, 0, torch.float32, where).items()}
        s30 = basis_states(g30, dtype=torch.float32, device=where)
        x30 = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 30)).astype(np.float32),
                              device=where)
        m30, _ = generate_data(x30, 2, dtype=torch.float32)
        logs[where] = full_probability(g30, p30, s30, m30, log=True).cpu()
        if where == "cuda":
            plain = full_probability(g30, p30, s30, m30)
    log_err = float((logs["cuda"] - logs["cpu"]).abs().max())
    check(bool(torch.isfinite(logs["cuda"]).all()), "log P at 30 qubits is not finite")
    check(not bool(torch.isfinite(plain).all()), "P at 30 qubits (cores x16) is finite")
    check(log_err <= TOL_LOG30, f"log P at 30 qubits, card vs host {log_err}")
    rec = {"phase": "inference", "part": "c_probability_checks",
           "born_rule": {"program": "mps_graph(8, 8, phys=4), float32, init seed 0, the "
                                    "first gaussian_batches(4, 512, 8, seed=0) batch",
                         "launches": counts, "max_abs_normalised_err": born_err},
           "log30": {"program": "mps_graph(30, dim=2), float32, cores x16, x [3, 30]",
                     "card": logs["cuda"].tolist(), "host": logs["cpu"].tolist(),
                     "max_abs_err": log_err, "plain_finite": False},
           "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 12: the structure search
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _recorded_evaluations():
    """Every ``CandidateEvaluator.evaluate`` call in the block (farm clones
    too): seconds, losses, and whether its topology was new to the chunk
    cache ("cold")."""
    from tneq_tpu_torch.genetic import CandidateEvaluator
    from tneq_tpu_torch.graph import parse_graph

    calls, evaluate = [], CandidateEvaluator.evaluate

    def recording(self, graph_string, seed, repeats=1):
        cold = parse_graph(graph_string).signature not in self._cache
        t0 = time.perf_counter()
        out = evaluate(self, graph_string, seed, repeats)
        calls.append({"graph": graph_string, "cold": cold, "losses": out[0].tolist(),
                      "seconds": time.perf_counter() - t0})
        return out

    CandidateEvaluator.evaluate = recording
    try:
        yield calls
    finally:
        CandidateEvaluator.evaluate = evaluate


def _population(ckpt: str) -> list:
    """(scope, graph, losses) of the last generation in a search checkpoint."""
    with open(ckpt) as f:
        state = json.load(f)
    return [(m["scope"], m["graph"], m["losses"])
            for members in state["generation"]["societies"].values() for m in members]


def _same_population(a: list, b: list, tol: float) -> float:
    """The largest loss difference of two populations with the same scopes
    and graphs (fails otherwise)."""
    check([x[:2] for x in a] == [x[:2] for x in b],
          f"structure search: populations differ: {[x[:2] for x in a]} vs {[x[:2] for x in b]}")
    worst = 0.0
    for (_, _, la), (_, _, lb) in zip(a, b):
        check(len(la) == len(lb), f"structure search: loss counts {la} vs {lb}")
        for x, y in zip(la, lb):
            worst = max(worst, abs(x - y) / max(1.0, abs(y)))
    check(worst <= tol, f"structure search: losses differ by {worst} > {tol}")
    return worst


def _eval_seconds(calls: list) -> dict:
    cold = [c["seconds"] for c in calls if c["cold"]]
    warm = [c["seconds"] for c in calls if not c["cold"]]
    return {"evaluations": len(calls), "cold": len(cold), "warm": len(warm),
            "cold_s_mean": sum(cold) / len(cold) if cold else None,
            "warm_s_mean": sum(warm) / len(warm) if warm else None}


def phase_ga_cli(smi: str, tmp: str) -> dict:
    """Phase 12 (a): the structure-search CLI at its defaults on the card,
    serial; farmed over a 1-worker DeviceFarm on cuda:0; killed in
    generation 1 and resumed from its checkpoint."""
    import random

    import numpy as np

    from tneq_tpu_torch.apps import structure_search
    from tneq_tpu_torch.genetic import EvolutionSearch

    t_phase = time.perf_counter()
    runs = {}
    for name, extra in (("serial", []), ("farm", ["--devices", "1"])):
        ckpt = f"{tmp}/ga_{name}.json"
        random.seed(GA_SEED)  # society names come from Python's random, as in JAX
        t0 = time.perf_counter()
        with _recorded_evaluations() as calls, contextlib.redirect_stdout(sys.stderr):
            res = structure_search.main(["--checkpoint", ckpt])
        runs[name] = {"result": res, "calls": calls, "population": _population(ckpt),
                      "seconds": time.perf_counter() - t0}
        losses = [x for c in calls for x in c["losses"]]
        check(bool(np.isfinite(losses).all()) and len(losses) == 2 * len(calls),
              f"structure search ({name}): non-finite losses {losses}")
    serial, farm = runs["serial"], runs["farm"]
    check(farm["result"]["scope"] == serial["result"]["scope"]
          and farm["result"]["graph"] == serial["result"]["graph"],
          "structure search: the farm's best differs from the serial run's")
    check([h["best_scope"] for h in farm["result"]["history"]]
          == [h["best_scope"] for h in serial["result"]["history"]],
          "structure search: the farm's history differs from the serial run's")
    farm_err = _same_population(farm["population"], serial["population"], TOL_GA_FARM)

    # killed during generation 1, resumed from the checkpoint of its boundary
    ckpt = f"{tmp}/ga_resume.json"
    random.seed(GA_SEED)
    with contextlib.redirect_stdout(sys.stderr):
        _, evaluator, kw = structure_search.build(["--checkpoint", ckpt])
    evaluate, n_calls = evaluator.evaluate, [0]

    def flaky(graph_string, seed, repeats=1):
        n_calls[0] += 1
        if n_calls[0] == GA_CRASH_AT:
            raise RuntimeError("simulated crash")
        return evaluate(graph_string, seed, repeats)

    evaluator.evaluate = flaky
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        try:
            EvolutionSearch(evaluator, checkpoint_path=ckpt, max_abnormal=0, **kw).run()
            crashed = False
        except RuntimeError:
            crashed = True
        check(crashed, "structure search: the crash run did not stop")
        with open(ckpt) as f:
            resumed_at = json.load(f)["generation_index"]
        _, evaluator, kw = structure_search.build(["--checkpoint", ckpt])
        best = EvolutionSearch.resume(ckpt, evaluator, **kw).run()
    check(resumed_at == 1, f"structure search: resumed at generation {resumed_at}, expected 1")
    check(best.scope == serial["result"]["scope"]
          and best.graph.to_dsl() == serial["result"]["graph"],
          "structure search: the resumed run's best differs from the uninterrupted run's")
    resume_err = _same_population(_population(ckpt), serial["population"], TOL_GA_FARM)
    hist = serial["result"]["history"]
    rec = {"phase": "structure_search", "part": "a_cli",
           "program": "apps.structure_search at its defaults: full connection of 4 qubits, "
                      "rank 2, population 8, 3 generations, repeat 2, top-k 3 x 2, 100 adam "
                      "steps (lr 5e-2) in chunks of 10, overlap_mse, float32, seed 0",
           "best": {k: serial["result"][k] for k in ("scope", "fitness", "sparsity", "losses")},
           "best_fitness_per_generation": [h["best_fitness"] for h in hist],
           "evaluations_per_generation": [h["evaluations"] for h in hist],
           "serial": {"seconds": serial["seconds"], **_eval_seconds(serial["calls"])},
           "farm_1_worker": {"seconds": farm["seconds"], **_eval_seconds(farm["calls"]),
                             "max_loss_diff": farm_err},
           "resume": {"crashed_at_evaluation": GA_CRASH_AT, "resumed_at_generation": resumed_at,
                      "seconds": time.perf_counter() - t0, "max_loss_diff": resume_err},
           "tolerance": TOL_GA_FARM, "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(rec)
    return rec


def phase_ga30(smi: str) -> dict:
    """Phase 12 (b): GA_r03.json's 30-qubit log-fidelity search, cut in
    depth; then one evaluation's chunk measured alone and its last cores
    re-evaluated on the host."""
    import random

    import numpy as np
    import torch
    from torch.utils._pytree import tree_map

    from tneq_tpu_torch.apps import structure_search
    from tneq_tpu_torch.genetic import CandidateEvaluator, EvolutionSearch
    from tneq_tpu_torch.genetic.evaluator import _lanes
    from tneq_tpu_torch.graph import mps_graph, parse_graph
    from tneq_tpu_torch.model.qctn import init_params
    from tneq_tpu_torch.ops import chain_overlap as co
    from tneq_tpu_torch.ops import pairwise as pw
    from tneq_tpu_torch.ops import transfer_step as ts

    t_phase = time.perf_counter()
    mps = mps_graph(GA30_QUBITS, dim=2)
    argv = [f"--goal-graph={mps}", f"--template-graph={mps}", "--tn-size", str(GA30_QUBITS),
            "--loss", "log_fidelity", "--population", "6", "--evaluate-repeat", "2",
            "--elitism", "1", "--generations", str(GA30_GENERATIONS),
            "--train-steps", str(GA30_STEPS)]
    random.seed(GA_SEED)
    co.reset_launch_counts()
    ts.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _recorded_evaluations() as calls, contextlib.redirect_stdout(sys.stderr):
        _, ev, kw = structure_search.build(argv)
        search = EvolutionSearch(ev, **kw)
        best = search.run()
    search_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kernel_launches = {**co.launch_counts(), **ts.launch_counts()}
    losses = [x for c in calls for x in c["losses"]]
    check(bool(np.isfinite(losses).all()), f"30q search: non-finite losses {losses}")
    bests = [h["best_fitness"] for h in search.history]
    check(all(b <= a for a, b in zip(bests, bests[1:])),
          f"30q search: best fitness rose between generations: {bests}")

    # the last evaluated candidate: one evaluation again, its chunk alone
    last = calls[-1]["graph"]
    graph = parse_graph(last)
    gen = torch.Generator().manual_seed(GA_SEED)
    starts = [init_params(graph, gen, torch.float32, device="cpu") for _ in range(2)]
    params0 = {k: torch.stack([s[k] for s in starts]).cuda() for k in graph.core_names}
    params_b, card_losses, _, _ = ev._fit(last, params0)
    host = ev.clone("cpu")
    card_l, host_l = [], []
    for i in range(2):
        lane = {k: v[i] for k, v in params_b.items()}
        card_l.append(float(ev._loss_fn(graph)(lane, ev._goal())[0]))
        host_l.append(float(host._loss_fn(graph)({k: v.cpu() for k, v in lane.items()},
                                                 host._goal())[0]))
    host_err = max(abs(c - h) / max(1.0, abs(h)) for c, h in zip(card_l, host_l))
    check(host_err <= TOL_GA30, f"30q search: -log F card {card_l} vs host {host_l}")

    run, optimizer = ev._chunk_fn(graph)
    state = tree_map(lambda x: _lanes(x, 2),
                     optimizer.init({k: v[0] for k, v in params0.items()}))
    goal = ev._goal()

    def chunk():
        return run(params0, state, goal)

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    chunk_s = sorted(times)[1]
    # one step of the same fit, as a 1-step chunk: the profiler's trace of
    # a 10-step chunk (~18,000 launches) takes tens of seconds to read
    one = CandidateEvaluator(ev.goal_graph, ev.goal_params, n_iter=1, method=ev.method,
                             learning_rate=ev.learning_rate, dtype=ev.dtype, loss=ev.loss)
    step_run, _ = one._chunk_fn(graph)

    def step():
        return step_run(params0, state, goal)

    prof = _profile_steps(step, chunk_s * 1e3 / ev.n_iter, steps=1)
    ranks, einsum = [], pw.einsum

    def recording(eq, *ops):
        ranks.append((pw._lettered(eq)[1], max(pw._vmap_dims(o) for o in ops)))
        return einsum(eq, *ops)

    pw.einsum = recording
    try:
        step()
    finally:
        pw.einsum = einsum
    largest = max(ranks, key=lambda r: sum(r))
    rec = {"phase": "structure_search", "part": "b_30q",
           "program": f"GA_r03.json's search: goal and template mps_graph({GA30_QUBITS}, dim=2), "
                      "goal cores from seed 0, loss log_fidelity, adam lr 5e-2, population 6, "
                      "repeat 2 (2 lanes), top-k 3 x 2, elitism 1, float32; reduced: "
                      f"{GA30_GENERATIONS} generations (5), {GA30_STEPS} fit steps per "
                      "candidate (300) in chunks of 10",
           "best": {"scope": best.scope, "fitness": best.fitness_score,
                    "losses": best.report_loss},
           "best_fitness_per_generation": bests,
           "evaluations_per_generation": [h["evaluations"] for h in search.history],
           "search_seconds": search_s, **_eval_seconds(calls),
           "kernel_launches": kernel_launches,
           "peak_memory_bytes": peak,
           "chunk": {"steps": ev.n_iter, "lanes": 2, "seconds": chunk_s,
                     "fit_steps_per_s": ev.n_iter / chunk_s,
                     "lane_steps_per_s": 2 * ev.n_iter / chunk_s,
                     "launches_per_step": prof["kernel_launches_per_step"],
                     "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
                     "device_idle_share": prof["device_idle_share"],
                     "top_kernels_ms_per_step": prof["top_kernels_ms_per_step"],
                     "forward_pairwise_einsums_per_step": len(ranks),
                     "largest_pairwise_step": {"axes": largest[0], "lane_axes": largest[1],
                                               "cuda_dims": sum(largest),
                                               "cuda_max_dims": pw.CUDA_MAX_DIMS}},
           "host_check": {"candidate_cores": graph.ncores, "card": card_l, "host": host_l,
                          "card_chunk_losses": card_losses.tolist(),
                          "max_err": host_err, "tolerance": TOL_GA30},
           "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(rec)
    return rec


def phase_merge_split(smi: str) -> dict:
    """Phase 12 (c): apps.merge_split_demo on the card."""
    import io

    from tneq_tpu_torch.apps import merge_split_demo

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = merge_split_demo.main(["--graph-types", "mps", "tree", "wall"])
    text = out.getvalue()
    check(rc == 0 and text.count("(carried)") == 2 and "MISMATCH" not in text,
          f"merge_split_demo: rc {rc}\n{text}")
    rec = {"phase": "structure_search", "part": "c_merge_split",
           "program": "apps.merge_split_demo: 6 qubits, dim 3, mps / tree / wall, split at the "
                      "middle core and merged back, cores on cuda",
           "fingerprints": [line.split(": ", 1)[1] for line in text.splitlines()
                            if line.startswith("weight fingerprint")],
           "split_refused": [line for line in text.splitlines() if "split not possible" in line],
           "seconds": time.perf_counter() - t0, "card": smi}
    emit(rec)
    return rec


def _flagship_sliced(mesh):
    """The flagship's experiment with ``mesh`` (built after any process
    group, so its fit takes the rank form there), its target prepared
    through the fit, the fresh cores phase 9 (b) starts from, and the
    unmasked mask: ``(exp, params, mask, t_eff, log_tt)``."""
    import numpy as np
    import torch

    from tneq_tpu_torch.apps.symmetry_breaking import (
        SymmetryBreakingConfig, make_experiment, target_tensor_init,
    )

    cfg = SymmetryBreakingConfig(n_qubits=FLAGSHIP_QUBITS, n_cells=FLAGSHIP_CELLS,
                                 fidelity_mode="network", dtype=torch.float32,
                                 device="cuda", mesh=mesh)
    exp = make_experiment(cfg)
    n = exp.graph.ncores
    mask = sorted(np.random.default_rng(0).choice(n, size=n // 4, replace=False).tolist())
    gen = torch.Generator().manual_seed(0)
    target = target_tensor_init(exp, mask, gen)
    t_eff, log_tt = exp.validate_fit.prepare(*target)
    return exp, exp.init_params(gen), exp.mask_vector([]), t_eff, log_tt


def _overlap_value_grad(fn, params, t_eff):
    """log|<p, t>| of the max-abs-normalised ``params`` and its gradient."""
    import torch

    from tneq_tpu_torch.train.network_fit import _normalize

    x = {k: v.detach().clone().requires_grad_() for k, v in _normalize(params).items()}
    val = fn(x, t_eff)
    grads = torch.autograd.grad(val, list(x.values()))
    return float(val.detach()), dict(zip(x, grads))


def _init_gloo(rank: int, world: int, port: int) -> None:
    """This spawned process as gloo rank ``rank`` of ``world``, on cuda:0."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)


def _spawn_ranks(target, world: int, *args, timeout: float = 600) -> list:
    """``target(rank, port, queue, *args)`` in ``world`` spawned processes:
    what each put on the queue, by rank; fails if a rank failed."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, port, queue) + args) for r in range(world)]
    for proc in procs:
        proc.start()
    try:
        outs = sorted((queue.get(timeout=timeout) for _ in procs), key=lambda o: o["rank"])
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
    failed = [o["failed"] for o in outs if "failed" in o]
    check(not failed and all(proc.exitcode == 0 for proc in procs),
          f"{target.__name__}: {failed}, exit codes {[proc.exitcode for proc in procs]}")
    return outs


def _sliced_rank_main(rank: int, port: int, queue) -> None:
    """Phase 13 (b) on one of two gloo ranks sharing cuda:0: the sliced
    log-overlap's value and summed gradient, then ``RANK_STEPS`` fit steps."""
    import torch
    import torch.distributed as dist

    try:
        _init_gloo(rank, SLICED_POSITIONS, port)
        from tneq_tpu_torch.parallel import make_mesh
        from tneq_tpu_torch.parallel.mp import make_sliced_log_overlap_fn

        mesh = make_mesh({"model": SLICED_POSITIONS}, devices=["cuda:0"] * SLICED_POSITIONS)
        exp, params, mask, t_eff, log_tt = _flagship_sliced(mesh)
        f = make_sliced_log_overlap_fn(exp.graph, mesh)
        value, grads = _overlap_value_grad(f, params, t_eff)
        grads = f.reduce_gradients(grads)
        d = exp.validate_fit.drivers
        opt, nlfs = d.optimizer.init(params), []
        for _ in range(RANK_STEPS):
            params, opt, m = d.step(params, opt, mask, t_eff, log_tt)
            nlfs.append(float(m))
        queue.put({"rank": rank, "ranks": f.ranks, "value": value,
                   "grads": {k: v.cpu().numpy() for k, v in grads.items()},
                   "params": {k: v.cpu().numpy() for k, v in params.items()},
                   "neg_log_f": nlfs})
    except Exception as e:
        queue.put({"rank": rank, "failed": repr(e)})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _meshed_chain_engine(counts, reset) -> dict:
    """Fault C5: ``EngineSiamese`` with a 1-position ``{"data": 1}`` mesh
    compiles the chain sweep.  A complex128 chain (``mps_graph(8, dim=4,
    phys=2)``) takes it without B3/B4 and matches the ``mesh=None`` engine
    (pairwise einsum) within ``TOL_INFER``; the same cores in complex64 take
    B4, one launch, a closure of their own."""
    import numpy as np
    import torch

    from tneq_tpu_torch.engine import EngineSiamese
    from tneq_tpu_torch.graph import mps_graph, parse_graph
    from tneq_tpu_torch.model.qctn import QCTN, init_params
    from tneq_tpu_torch.parallel import make_mesh
    from tneq_tpu_torch.train.trainer import basis_states

    g = parse_graph(mps_graph(8, dim=4, phys=2))
    cores = init_params(g, 0, torch.complex64, device="cuda")
    x = np.random.default_rng(0).normal(size=(ENGINE_BATCH, 8)).astype(np.float32)
    eng = EngineSiamese(dtype=torch.complex128, device="cuda",
                        mesh=make_mesh({"data": 1}, devices=["cuda:0"]))
    mx, _ = eng.generate_data(x, K=2)
    rec = {"program": "EngineSiamese(mesh={'data': 1}) on mps_graph(8, dim=4, phys=2)",
           "tolerance": TOL_INFER}
    for dtype in (torch.complex128, torch.complex64):
        model = QCTN(g, {k: v.to(dtype) for k, v in cores.items()}, device="cuda")
        states = basis_states(g, dtype=dtype, device="cuda")
        ms = [m.to(dtype) for m in mx]
        reset()
        probs = eng.contract_with_compiled_strategy(model, states, ms)
        torch.cuda.synchronize()
        launched = counts()
        plain = EngineSiamese(dtype=dtype, device="cuda").contract_with_compiled_strategy(
            model, states, ms)
        rec[str(dtype).split(".")[1]] = {"launches": launched,
                                         "err_vs_no_mesh": _norm_err(probs, plain.cpu())}
    wide, low = rec["complex128"], rec["complex64"]
    check(sum(wide["launches"].values()) == 0 and wide["err_vs_no_mesh"] <= TOL_INFER,
          f"meshed engine, complex128 chain: {wide}")
    check(low["launches"]["transfer_step_complex"] == 1 and sum(low["launches"].values()) == 1
          and low["err_vs_no_mesh"] <= TOL_INFER, f"meshed engine, complex64 chain: {low}")
    return rec


def phase_sliced(smi: str, unsliced: dict, tmp: str) -> list:
    """Phase 13: bond-sliced overlaps (parts a-c) and checkpoints (d), one
    JSON line per part."""
    import numpy as np
    import torch

    from tneq_tpu_torch.engine import EngineSiamese
    from tneq_tpu_torch.graph import parse_graph, wall_graph
    from tneq_tpu_torch.model.qctn import QCTN
    from tneq_tpu_torch.ops import chain_overlap, row_scan, transfer_step
    from tneq_tpu_torch.parallel import make_mesh
    from tneq_tpu_torch.parallel.mp import choose_slice_bonds, make_sliced_log_overlap_fn
    from tneq_tpu_torch.train.trainer import basis_states

    def counts():
        return {**chain_overlap.launch_counts(), **transfer_step.launch_counts()}

    def reset():
        chain_overlap.reset_launch_counts()
        transfer_step.reset_launch_counts()

    recs = []
    # (a) the flagship, sliced in one process
    t_part = time.perf_counter()
    reset()
    mesh = make_mesh({"model": SLICED_POSITIONS}, devices=["cuda:0"] * SLICED_POSITIONS)
    exp, params, mask, t_eff, log_tt = _flagship_sliced(mesh)
    ref_exp, _, _, ref_t_eff, ref_log_tt = _flagship_sliced(None)
    d, ref_d = exp.validate_fit.drivers, ref_exp.validate_fit.drivers
    # -log F at the same cores: the metric of one step, sliced and unsliced
    _, _, nlf0 = d.step(params, d.optimizer.init(params), mask, t_eff, log_tt)
    _, _, ref_nlf0 = ref_d.step(params, ref_d.optimizer.init(params), mask, ref_t_eff,
                                ref_log_tt)
    nlf_err = abs(float(nlf0) - float(ref_nlf0)) / max(1.0, abs(float(ref_nlf0)))
    check(math.isfinite(float(nlf0)) and nlf_err <= TOL_LANE,
          f"sliced flagship: -log F {float(nlf0)} vs unsliced {float(ref_nlf0)}, err {nlf_err}")
    f = make_sliced_log_overlap_fn(exp.graph, mesh)
    value, grads = _overlap_value_grad(f, params, t_eff)
    ref_value, ref_grads = _overlap_value_grad(
        row_scan.make_row_scan_log_overlap_fn(exp.graph), params, t_eff)
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    grad_err = max(float((grads[k] - ref_grads[k]).abs().max()) for k in grads) / scale
    check(grad_err <= TOL_SLICED_GRAD,
          f"sliced flagship: log-overlap gradient vs unsliced, err {grad_err}")
    opt = d.optimizer.init(params)
    p = params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(SLICED_STEPS):
        p, opt, nlf = d.step(p, opt, mask, t_eff, log_tt)
        losses.append(float(nlf))  # the exit test's host sync, as in the fit loop
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"sliced flagship: -log F {losses}")
    box = {"p": p, "o": opt}

    def one_step():
        box["p"], box["o"], m = d.step(box["p"], box["o"], mask, t_eff, log_tt)
        float(m)

    # one step: reading a trace of ~13,000 launches takes tens of seconds
    prof = _profile_steps(one_step, dt / SLICED_STEPS * 1e3, steps=1)
    # one step at SLICED_WIDE positions: more bonds (or a padded tail)
    wide_mesh = make_mesh({"model": SLICED_WIDE}, devices=["cuda:0"] * SLICED_WIDE)
    wide_bonds = choose_slice_bonds(exp.graph, SLICED_WIDE, prefer_early_rows=True)
    wide_exp, _, _, wide_t_eff, wide_log_tt = _flagship_sliced(wide_mesh)
    wd = wide_exp.validate_fit.drivers
    _, _, wide_nlf = wd.step(params, wd.optimizer.init(params), mask, wide_t_eff, wide_log_tt)
    wide_err = abs(float(wide_nlf) - float(ref_nlf0)) / max(1.0, abs(float(ref_nlf0)))
    check(wide_err <= TOL_LANE, f"sliced flagship at {SLICED_WIDE} positions: -log F "
          f"{float(wide_nlf)} vs unsliced {float(ref_nlf0)}")
    launches = counts()
    check(launches["chain_sweep_fwd"] == launches["chain_sweep_bwd"] == 0,
          f"sliced flagship: the chain route is off, yet {launches}")
    uf = unsliced["flagship"]
    rec_a = {
        "phase": "sliced", "part": "a_flagship_one_process",
        "program": "the flagship of phase 9 (b) (32 x 5, float32, 155 cores) with "
                   f"make_mesh({{'model': {SLICED_POSITIONS}}}, devices=['cuda:0'] * "
                   f"{SLICED_POSITIONS}): every overlap bond-sliced, one process",
        "bonds": [list(b) for b in choose_slice_bonds(exp.graph, SLICED_POSITIONS, True)],
        "neg_log_f_sliced_unsliced": [float(nlf0), float(ref_nlf0)],
        "neg_log_f_err": nlf_err, "tolerance": TOL_LANE,
        "log_overlap_sliced_unsliced": [value, ref_value],
        "grad_err": grad_err, "grad_tolerance": TOL_SLICED_GRAD,
        "fit_steps": SLICED_STEPS, "neg_log_f_first_last": [losses[0], losses[-1]],
        "fit_steps_per_s": SLICED_STEPS / dt, "ms_per_step": dt / SLICED_STEPS * 1e3,
        "max_memory_allocated_bytes": peak, "profile": prof,
        "unsliced_phase9b": {"fit_steps_per_s": uf["fit_steps_per_s"],
                             "kernel_launches_per_step":
                                 uf["profile"]["kernel_launches_per_step"],
                             "device_idle_share": uf["profile"]["device_idle_share"],
                             "max_memory_allocated_bytes": uf["max_memory_allocated_bytes"]},
        "wide": {"positions": SLICED_WIDE, "bonds": [list(b) for b in wide_bonds],
                 "neg_log_f": float(wide_nlf), "err": wide_err},
        "port_kernel_launches": launches,
        "seconds": time.perf_counter() - t_part, "card": smi,
    }
    emit(rec_a)
    recs.append(rec_a)

    # (b) two gloo ranks on cuda:0 against the one-process form of (a)
    t_part = time.perf_counter()
    outs = _spawn_ranks(_sliced_rank_main, SLICED_POSITIONS)
    one_grads = {k: v.cpu().numpy() for k, v in grads.items()}
    g_scale = max(float(np.abs(v).max()) for v in one_grads.values())
    rank_rec = []
    for o in outs:
        v_err = abs(o["value"] - value) / max(1.0, abs(value))
        g_err = max(float(np.abs(o["grads"][k] - one_grads[k]).max())
                    for k in one_grads) / g_scale
        nlf_err_r = max(abs(a - b) / max(1.0, abs(b))
                        for a, b in zip(o["neg_log_f"], losses[:RANK_STEPS]))
        check(o["ranks"] and v_err <= TOL_RANK_VALUE and g_err <= TOL_RANK_GRAD
              and nlf_err_r <= TOL_LANE,
              f"sliced rank {o['rank']}: value err {v_err}, gradient err {g_err}, "
              f"-log F err {nlf_err_r}")
        rank_rec.append({"rank": o["rank"], "value": o["value"], "value_err": v_err,
                         "grad_err": g_err, "neg_log_f": o["neg_log_f"],
                         "neg_log_f_err": nlf_err_r})
    equal = all(np.array_equal(outs[0]["params"][k], outs[1]["params"][k])
                for k in outs[0]["params"])
    check(equal, f"sliced ranks: the replicas' params differ after {RANK_STEPS} steps")
    rec_b = {"phase": "sliced", "part": "b_gloo_ranks",
             "program": f"{SLICED_POSITIONS} gloo ranks (spawn) sharing cuda:0, one per "
                        "model position: the flagship's sliced log-overlap value and "
                        f"summed gradient, then {RANK_STEPS} fit steps",
             "ranks": rank_rec, "replicas_bit_equal": equal,
             "tolerances": {"value": TOL_RANK_VALUE, "grad": TOL_RANK_GRAD,
                            "neg_log_f": TOL_LANE},
             "seconds": time.perf_counter() - t_part, "card": smi}
    emit(rec_b)
    recs.append(rec_b)

    # (c) the engine with a mesh, and the sliced CLI on card and host
    t_part = time.perf_counter()
    g = parse_graph(wall_graph(ENGINE_QUBITS, layers=ENGINE_LAYERS, dim=2))
    x = np.random.default_rng(0).normal(size=(ENGINE_BATCH, ENGINE_QUBITS)).astype(np.float32)
    model = QCTN(g, seed=0, dtype=torch.complex64, device="cuda")
    states = basis_states(g, device="cuda")
    plain_eng = EngineSiamese(device="cuda")
    mesh_eng = EngineSiamese(device="cuda", mesh=make_mesh(
        {"model": SLICED_POSITIONS}, devices=["cuda:0"] * SLICED_POSITIONS))
    mx, _ = plain_eng.generate_data(x, K=2)
    probs = mesh_eng.contract_with_compiled_strategy(model, states, mx)
    plain = plain_eng.contract_with_compiled_strategy(model, states, mx)
    eng_err = _norm_err(probs, plain.cpu())
    check(bool(torch.isfinite(probs).all()) and eng_err <= TOL_INFER,
          f"engine with a mesh vs mesh=None: {eng_err}")
    c5 = _meshed_chain_engine(counts, reset)
    # seed 1: its first 4 x 2 target validates (seed 0's stalls and is drawn anew)
    cli = _cli_pair(["--fidelity-mode", "network", "--n-qubits", "4", "--n-cells", "2",
                     "--restarts", "1", "--prune-steps", "5", "--validate-steps", "100",
                     "--seed", "1", "--slice-devices", str(SLICED_POSITIONS)])
    rec_c = {"phase": "sliced", "part": "c_engine_and_cli",
             "engine": {"program": "README Quick start (phase 11 b) with "
                                   f"mesh={{'model': {SLICED_POSITIONS}}} on cuda:0",
                        "err_vs_no_mesh": eng_err, "tolerance": TOL_INFER},
             "c5_chain_engine": c5,
             "cli": {"argv": "--fidelity-mode network --n-qubits 4 --n-cells 2 --restarts 1 "
                             "--prune-steps 5 --validate-steps 100 --seed 1 --slice-devices "
                             f"{SLICED_POSITIONS}", **cli},
             "seconds": time.perf_counter() - t_part, "card": smi}
    emit(rec_c)
    recs.append(rec_c)

    # (d) checkpoints: train_single_node --save at its defaults (B4), the
    # file on the card, and a Trainer resumed from a CheckpointManager
    from tneq_tpu_torch.apps.train_single_node import main as cli_main
    from tneq_tpu_torch.graph import example_graph
    from tneq_tpu_torch.train.trainer import Trainer, TrainingConfig
    from tneq_tpu_torch.utils import CheckpointManager
    from tneq_tpu_torch.utils._safetensors import load_file

    t_part = time.perf_counter()
    path = f"{tmp}/cli.safetensors"
    reset()
    with contextlib.redirect_stdout(sys.stderr):
        stats = cli_main(["--save", path])
    torch.cuda.synchronize()
    cli_counts = counts()
    check(cli_counts["transfer_step_complex"] == 2 * stats.steps,
          f"--save run: launch counts {cli_counts}, expected B4 = {2 * stats.steps}")
    src = example_graph(8, "mps", 3)
    loaded = QCTN.from_pretrained(src, path, device="cuda")
    tensors, meta = load_file(path)
    bit_equal = all(
        np.array_equal(loaded.params[n].cpu().numpy(),
                       tensors[f"core_{n}_real"] + 1j * tensors[f"core_{n}_imag"])
        for n in loaded.cores)
    init = QCTN(src, device="cuda").params  # the CLI's cores before training
    moved = any(not torch.equal(loaded.params[n], init[n]) for n in loaded.cores)
    check(meta == {"graph": "mps"} and bit_equal and moved,
          f"--save file: metadata {meta}, bit-equal {bit_equal}, trained {moved}")
    trainer = Trainer(loaded.graph, config=TrainingConfig(max_steps=2 * RESUME_STEPS),
                      dtype=torch.complex64, device="cuda")
    st = basis_states(loaded.graph, dtype=torch.complex64, device="cuda")
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.normal(size=(32, 8)).astype(np.float32), device="cuda")
          for _ in range(2 * RESUME_STEPS)]

    def run(p, o, batches):
        out = []
        for xb in batches:
            p, o, loss = trainer.train_step(p, o, st, xb)
            out.append(float(loss))
        return p, o, out

    p0 = loaded.params
    _, _, full = run(p0, trainer.optimizer.init(p0), xs)
    p3, o3, first = run(p0, trainer.optimizer.init(p0), xs[:RESUME_STEPS])
    mgr = CheckpointManager(f"{tmp}/ckpt", keep=2)
    mgr.save(RESUME_STEPS, p3, o3)
    step, p_np, o_res, _ = mgr.load(opt_state_template=trainer.optimizer.init(p0))
    p_res = {k: torch.as_tensor(v, device="cuda") for k, v in p_np.items()}
    _, _, rest = run(p_res, o_res, xs[RESUME_STEPS:])
    resume_err = max(abs(a - b) / abs(b) for a, b in zip(first + rest, full))
    check(step == RESUME_STEPS and resume_err <= TOL_RESUME,
          f"resume: step {step}, losses {first + rest} vs {full}, err {resume_err}")
    rec_d = {"phase": "sliced", "part": "d_checkpoints",
             "program": "apps.train_single_node.main(['--save', path]) at its defaults "
                        "(the cli cell); QCTN.from_pretrained on the card; the cli cell's "
                        f"Trainer saved after {RESUME_STEPS} of {2 * RESUME_STEPS} steps "
                        "by CheckpointManager and resumed",
             "steps": stats.steps, "launches": cli_counts,
             "from_pretrained_bit_equal": bit_equal, "metadata": meta,
             "losses_resumed_uninterrupted": [first + rest, full],
             "resume_rel_err": resume_err, "tolerance": TOL_RESUME,
             "seconds": time.perf_counter() - t_part, "card": smi}
    emit(rec_d)
    recs.append(rec_d)
    return recs


def _dp_config():
    """Phase 14 (a): the born_rule cell as a ``DistributedConfig``."""
    from tneq_tpu_torch.graph import mps_graph
    from tneq_tpu_torch.parallel import DistributedConfig

    B, D, K = BORN_SHAPE
    return DistributedConfig(graph=mps_graph(8, D, phys=K), K=K, dtype="float32",
                             batch_size=B, method="sgdg", learning_rate=1e-2, momentum=0.9,
                             max_steps=DP_STEPS, log_every=0)


def _dp_step0(tr, params, x, reduce=None):
    """The step-0 loss and gradient of ``tr`` at ``params`` on this
    process's rows of ``x`` (averaged over the data line by ``reduce``)."""
    import torch

    from tneq_tpu_torch.parallel import data_sharding

    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = tr.trainer.loss(leaves, tr.states, data_sharding(tr.mesh).local(x))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    loss = loss.detach()
    if reduce is not None:
        loss, grads = reduce(loss, grads)
    return float(loss), grads


def _dp_run(tr, params, data) -> dict:
    """``DistributedTrainer.train`` for DP_STEPS steps, timed, with its B3
    launches, peak memory and a profiled window of steps."""
    import torch

    from tneq_tpu_torch.ops import transfer_step as ts

    tr._train_step(params, tr.optimizer.init(params), data[0])  # one-time work untimed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts.reset_launch_counts()
    t0 = time.perf_counter()
    p, stats = tr.train(params, data)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ts.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    box = {"p": p, "o": tr.optimizer.init(p), "i": 0}

    def one_step():
        box["p"], box["o"], loss = tr._train_step(box["p"], box["o"], data[box["i"] % len(data)])
        box["i"] += 1
        float(loss)  # the loop's host read of the loss

    return {"params": {k: v.cpu().numpy() for k, v in p.items()}, "losses": stats.losses,
            "seconds": dt, "steps_per_s": DP_STEPS / dt, "launches": counts,
            "max_memory_allocated_bytes": peak,
            "profile": _profile_steps(one_step, dt / DP_STEPS * 1e3, steps=3)}


def _dp_rank_main(rank: int, port: int, queue) -> None:
    """Phase 14 (a) and (d) on one of two gloo ranks sharing cuda:0: the
    step-0 loss and gradient of the rank's 256 rows averaged over the data
    line, the all-reduce alone, DP_STEPS trainer steps, then
    ``check_mesh_health``."""
    import torch
    import torch.distributed as dist

    try:
        _init_gloo(rank, DP_WORLD, port)
        from tneq_tpu_torch.model.qctn import init_params
        from tneq_tpu_torch.parallel import DistributedTrainer, check_mesh_health
        from tneq_tpu_torch.parallel.dp import _mean_over_rows

        cfg = _dp_config()
        tr = DistributedTrainer(cfg, devices=["cuda:0"] * DP_WORLD)
        params = init_params(tr.graph, cfg.seed, torch.float32, device="cuda")
        data = tr.prepare_data()
        reduce = _mean_over_rows(tr.mesh, "data")
        loss0, grads0 = _dp_step0(tr, params, data[0], reduce)
        # the gradient's all-reduce alone (one flat buffer) and the loss's
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(AR_REPS):
            reduce(torch.tensor(loss0, device="cuda"), grads0)
        torch.cuda.synchronize()
        ar_ms = (time.perf_counter() - t0) / AR_REPS * 1e3
        run = _dp_run(tr, params, data)
        health = check_mesh_health(tr.mesh, verbose=False)
        # bench stage 5 on these ranks: the port's collectives on a line
        from tneq_tpu_torch.bench import stage_collectives

        collectives = stage_collectives(device="cuda")
        queue.put({"rank": rank, "loss0": loss0,
                   "grads0": {k: v.cpu().numpy() for k, v in grads0.items()},
                   "all_reduce_ms": ar_ms, "run": run, "health": health,
                   "collectives": collectives,
                   "grad_bytes": sum(g.numel() * g.element_size() for g in grads0.values())})
    except Exception as e:
        queue.put({"rank": rank, "failed": repr(e)})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _gloo_probe(prim: str, rank: int) -> bool:
    """One gloo primitive on CUDA tensors between ranks 0 and 1: whether it
    gave the right values (it raises, or aborts the process, when
    refused)."""
    import torch
    import torch.distributed as dist

    peer = 1 - rank
    x = torch.full((2,), float(rank), device="cuda")
    y = torch.empty_like(x)
    if prim == "all_gather_into_tensor":
        out = torch.empty(4, device="cuda")
        dist.all_gather_into_tensor(out, x)
        return out.tolist() == [0.0, 0.0, 1.0, 1.0]
    if prim == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(y, torch.arange(4.0, device="cuda") + rank)
        return y.tolist() == [1.0, 3.0] if rank == 0 else y.tolist() == [5.0, 7.0]
    if prim == "all_to_all_single":
        dist.all_to_all_single(y, torch.arange(2.0, device="cuda") + 10 * rank)
        return y.tolist() == [rank, 10.0 + rank]
    if prim == "send":
        if rank == 0:
            dist.send(x, peer)
            return True  # the sender receives nothing
        dist.recv(y, peer)
    else:  # batch_isend_irecv
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                           dist.P2POp(dist.irecv, y, peer)]):
            req.wait()
    return bool(y[0] == peer)


def _gloo_probe_main(rank: int, port: int, queue, prims) -> None:
    """Phase 14 (d): gloo primitives on CUDA tensors, in a group of their
    own (a refusal may abort the process or break the group)."""
    _init_gloo(rank, 2, port)
    for prim in prims:
        try:
            queue.put({"rank": rank, "prim": prim, "accepted": _gloo_probe(prim, rank)})
        except RuntimeError as e:
            queue.put({"rank": rank, "prim": prim, "accepted": False, "error": str(e)[:200]})


def _gloo_probes():
    """Start the probes, a pair of processes per group of GLOO_PROBES:
    ``(procs, queue)``."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = {}
    for prims in GLOO_PROBES:
        port = _free_port()
        procs[prims] = [ctx.Process(target=_gloo_probe_main, args=(r, port, queue, prims))
                        for r in range(2)]
        for proc in procs[prims]:
            proc.start()
    return procs, queue


def _gloo_probe_results(procs, queue) -> dict:
    """Each probed primitive: refused or not, its processes' exit codes and
    errors (the queue drained while the processes end)."""
    import queue as queue_mod

    every = [proc for ps in procs.values() for proc in ps]
    seen = []
    deadline = time.time() + 120
    while time.time() < deadline:
        try:
            seen.append(queue.get(timeout=0.5))
        except queue_mod.Empty:
            if not any(proc.is_alive() for proc in every):
                break
    for proc in every:
        proc.join(timeout=10)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
    out = {}
    for prims, ps in procs.items():
        for prim in prims:
            mine = [o for o in seen if o["prim"] == prim]
            out[prim] = {"refused": not (len(mine) == 2 and all(o["accepted"] for o in mine)),
                         "exit_codes": [proc.exitcode for proc in ps],
                         "errors": sorted({o["error"] for o in mine if "error" in o})}
    return out


def _fsdp_inputs(mesh):
    """Phase 14 (c): the headline chain's FSDP step on ``mesh``, and its
    prepared params and target."""
    import torch

    from tneq_tpu_torch.graph import mps_graph, parse_graph
    from tneq_tpu_torch.model.qctn import init_params
    from tneq_tpu_torch.parallel.fsdp import make_fsdp_network_fit_step

    g = parse_graph(mps_graph(FSDP_QUBITS, dim=FSDP_BOND))
    step, prepare, opt = make_fsdp_network_fit_step(g, mesh)
    p = init_params(g, 0, torch.float32, device="cuda")
    t = init_params(g, 1, torch.float32, device="cuda")
    return g, step, opt, p, t, prepare(p), prepare(t)


def _fsdp_run(mesh) -> dict:
    """The step-0 loss and this process's gradient rows, then FSDP_STEPS
    steps: timed, B1/B2 launches, peak memory, state bytes, the identity
    pad, a profiled window."""
    import torch

    from tneq_tpu_torch.ops import chain_overlap as co

    g, step, opt, _, _, arrays, t_arrays = _fsdp_inputs(mesh)
    loss0, grads = step.value_and_grad(arrays, t_arrays)
    o = opt.init(arrays)
    state_bytes = sum(t.numel() * t.element_size() for t in tuple(arrays) + tuple(o.momentum))
    step(arrays, opt.init(arrays), t_arrays)  # one-time work untimed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    co.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(FSDP_STEPS):
        arrays, o, loss = step(arrays, o, t_arrays)
        losses.append(float(loss))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = co.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ident = torch.eye(FSDP_BOND ** 2, device="cuda").reshape((FSDP_BOND,) * 4)
    box = {"a": arrays, "o": o}

    def one_step():
        box["a"], box["o"], m = step(box["a"], box["o"], t_arrays)
        float(m)

    return {"loss0": float(loss0), "grad_rows": grads[0].cpu().numpy(),
            "rows": arrays[0].shape[0], "state_bytes": state_bytes, "losses": losses,
            "last_row_identity": bool(torch.equal(arrays[0][-1], ident)),
            "seconds": dt, "steps_per_s": FSDP_STEPS / dt, "launches": counts,
            "max_memory_allocated_bytes": peak,
            "profile": _profile_steps(one_step, dt / FSDP_STEPS * 1e3, steps=2)}


def _fsdp_rank_main(rank: int, port: int, queue) -> None:
    """Phase 14 (c) on one of two gloo ranks sharing cuda:0."""
    import torch.distributed as dist

    try:
        _init_gloo(rank, FSDP_POSITIONS, port)
        from tneq_tpu_torch.parallel import make_mesh

        mesh = make_mesh({"model": FSDP_POSITIONS}, devices=["cuda:0"] * FSDP_POSITIONS)
        queue.put({"rank": rank, **_fsdp_run(mesh)})
    except Exception as e:
        queue.put({"rank": rank, "failed": repr(e)})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _max_rel(got: dict, ref: dict) -> float:
    import numpy as np

    scale = max(float(np.abs(v).max()) for v in ref.values())
    return max(float(np.abs(got[k] - ref[k]).max()) for k in ref) / scale


def _run_summary(run: dict) -> dict:
    return {k: run[k] for k in ("seconds", "steps_per_s", "launches",
                                "max_memory_allocated_bytes", "profile")}


def phase_distributed(smi: str, tmp: str) -> list:
    """Phase 14: the data-parallel trainer (a), the trainer CLI (b), FSDP
    at the headline width (c), the mesh health check and gloo's routes (d)
    and the dry runs (e), one JSON line per part."""
    import numpy as np
    import torch

    from tneq_tpu_torch.model.qctn import init_params, params_from_numpy, params_to_numpy
    from tneq_tpu_torch.parallel import DistributedTrainer, make_mesh

    recs = []
    # (a) the data-parallel trainer at the born_rule width
    t_part = time.perf_counter()
    cfg = _dp_config()
    tr = DistributedTrainer(cfg, devices=["cuda:0"])
    params = init_params(tr.graph, cfg.seed, torch.float32, device="cuda")
    data = tr.prepare_data()
    loss0, grads0 = _dp_step0(tr, params, data[0])
    grads0 = {k: v.cpu().numpy() for k, v in grads0.items()}
    one = _dp_run(tr, params, data)
    check(one["launches"]["transfer_step"] == 2 * DP_STEPS,
          f"dp_trainer, one process: B3 launches {one['launches']}, expected {2 * DP_STEPS}")
    dp_outs = _spawn_ranks(_dp_rank_main, DP_WORLD)
    ranks = []
    for o in dp_outs:
        l_err = abs(o["loss0"] - loss0) / abs(loss0)
        g_err = _max_rel(o["grads0"], grads0)
        r = o["run"]
        check(l_err <= TOL_DP and g_err <= TOL_DP,
              f"dp_trainer rank {o['rank']}: step-0 loss err {l_err}, gradient err {g_err}")
        check(r["launches"]["transfer_step"] == 2 * DP_STEPS,
              f"dp_trainer rank {o['rank']}: B3 launches {r['launches']}")
        check(all(math.isfinite(x) for x in r["losses"]), f"dp_trainer rank {o['rank']}: losses")
        ranks.append({"rank": o["rank"], "loss0_err": l_err, "grad0_err": g_err,
                      "all_reduce_ms": o["all_reduce_ms"],
                      "all_reduce_share_of_step": o["all_reduce_ms"] * r["steps_per_s"] / 1e3,
                      "loss_first_last": [r["losses"][0], r["losses"][-1]],
                      **_run_summary(r)})
    p0, p1 = dp_outs[0]["run"]["params"], dp_outs[1]["run"]["params"]
    equal = all(np.array_equal(p0[k], p1[k]) for k in p0)
    check(equal, f"dp_trainer: the replicas' params differ after {DP_STEPS} steps")
    rec_a = {"phase": "distributed", "part": "a_dp_trainer",
             "program": f"DistributedTrainer: mps_graph(8, 8, phys=4), K 4, float32, batch "
                        f"{cfg.batch_size}, sgdg lr 1e-2 momentum 0.9, {DP_STEPS} steps; one "
                        f"process (data 1), then {DP_WORLD} gloo ranks on cuda:0 (data "
                        f"{DP_WORLD}, {cfg.batch_size // DP_WORLD} rows each)",
             "strategy": tr.strategy, "loss0": loss0, "tolerance": TOL_DP,
             "one_process": {"loss_first_last": [one["losses"][0], one["losses"][-1]],
                             **_run_summary(one)},
             "ranks": ranks, "replicas_bit_equal": equal,
             "ranks_vs_one_process_params_max_rel": _max_rel(p0, one["params"]),
             "grad_buffer_bytes": dp_outs[0]["grad_bytes"],
             "launches": one["launches"]["transfer_step"]
             + sum(o["run"]["launches"]["transfer_step"] for o in dp_outs),
             "seconds": time.perf_counter() - t_part, "card": smi}
    emit(rec_a)
    recs.append(rec_a)

    # (b) the trainer CLI at its defaults: the card's loss against the
    # host's at the card's cores, the CLI's run (B4), and a resume
    from tneq_tpu_torch.graph import example_graph
    from tneq_tpu_torch.ops import transfer_step as ts
    from tneq_tpu_torch.parallel.trainer import DistributedConfig
    from tneq_tpu_torch.parallel.trainer import main as dist_main

    t_part = time.perf_counter()
    cli_cfg = DistributedConfig(graph=example_graph(6, "mps", 2), max_steps=CHECK_STEPS,
                                log_every=0)
    tc = DistributedTrainer(cli_cfg, devices=["cuda"])
    th = DistributedTrainer(cli_cfg, devices=["cpu"])
    params = init_params(tc.graph, cli_cfg.seed, torch.complex64, device="cuda")
    data_c, data_h = tc.prepare_data(), th.prepare_data()
    opt = tc.optimizer.init(params)
    card, host_at_card = [], []
    for i in range(CHECK_STEPS):
        cores = params_to_numpy(params)
        params, opt, loss = tc._train_step(params, opt, data_c[i % len(data_c)])
        card.append(float(loss))
        with torch.no_grad():
            host_at_card.append(float(th.trainer.loss(params_from_numpy(cores, "cpu"), th.states,
                                                      data_h[i % len(data_h)])))
    rel = max(abs(c - h) / abs(h) for c, h in zip(card, host_at_card))
    check(rel <= TOL_STEP0, f"trainer_cli: card loss vs host loss at the same cores, rel {rel}")
    ts.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        stats = dist_main(["--steps", str(TRAINER_CLI_STEPS)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ts.launch_counts()
    check(counts == {"transfer_step": 0, "transfer_step_complex": 2 * TRAINER_CLI_STEPS}
          and all(math.isfinite(x) for x in stats.losses),
          f"trainer_cli: launch counts {counts}, expected B4 = {2 * TRAINER_CLI_STEPS}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        host = dist_main(["--steps", str(TRAINER_CLI_STEPS), "--device", "cpu"])
    dt_host = time.perf_counter() - t0
    ck = f"{tmp}/trainer_ckpt"
    first, last = RESUME_AT
    argv = ["--model-axis", "2", "--checkpoint-dir", ck]
    with contextlib.redirect_stdout(sys.stderr):
        dist_main(["--steps", str(first)] + argv)
        resumed = dist_main(["--steps", str(last), "--resume"] + argv)
        full = dist_main(["--model-axis", "2", "--steps", str(last)])
    resume_err = max(abs(a - b) / abs(b) for a, b in zip(resumed.losses, full.losses[first:]))
    check(len(resumed.losses) == last - first and resume_err <= TOL_RESUME,
          f"trainer_cli resume: {resumed.losses} vs {full.losses[first:]}")
    rec_b = {"phase": "distributed", "part": "b_trainer_cli",
             "program": "python -m tneq_tpu_torch.parallel.trainer at its defaults (mps 6 "
                        "qubits, dim 2, complex64, batch 32 x 4, sgdg lr 1e-2 momentum 0.9)",
             "strategy": tc.strategy, "first_losses_card": card,
             "host_loss_at_card_cores_rel_err_max": rel, "tolerance": TOL_STEP0,
             "steps": TRAINER_CLI_STEPS, "seconds": dt, "steps_per_s": TRAINER_CLI_STEPS / dt,
             "loss_first_last": [stats.losses[0], stats.losses[-1]],
             "host": {"seconds": dt_host, "loss_first_last": [host.losses[0],
                                                               host.losses[-1]]},
             "launches": counts,
             "launches_per_step": {k: v / TRAINER_CLI_STEPS for k, v in counts.items()},
             "resume": {"argv": argv[:2], "steps": [first, last],
                        "losses_resumed_uninterrupted": [resumed.losses, full.losses[first:]],
                        "rel_err": resume_err, "tolerance": TOL_RESUME},
             "seconds_part": time.perf_counter() - t_part, "card": smi}
    emit(rec_b)
    recs.append(rec_b)

    # (c) FSDP at the headline width: one process, then two gloo ranks
    from tneq_tpu_torch.parallel.fsdp import stack_params
    from tneq_tpu_torch.train.network_fit import network_log_fidelity

    t_part = time.perf_counter()
    mesh = make_mesh({"model": FSDP_POSITIONS}, devices=["cuda:0"] * FSDP_POSITIONS)
    g, _, _, p, t, _, _ = _fsdp_inputs(mesh)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    nlf = -network_log_fidelity(g, leaves, t)
    ref_g = dict(zip(leaves, torch.autograd.grad(nlf, list(leaves.values()))))
    nlf = float(nlf.detach())
    stacked_ref = stack_params(g, ref_g, FSDP_POSITIONS).arrays[0].cpu().numpy()
    one_f = _fsdp_run(mesh)
    outs = _spawn_ranks(_fsdp_rank_main, FSDP_POSITIONS)
    per_step = {"chain_sweep_fwd": 3 * FSDP_STEPS, "chain_sweep_bwd": 2 * FSDP_STEPS}
    n_real = g.ncores
    scale = float(np.abs(stacked_ref[:n_real]).max())
    franks = []
    for run in [one_f] + outs:
        who = "one process" if run is one_f else f"rank {run['rank']}"
        rows = run["rows"]
        lo = 0 if run is one_f else run["rank"] * rows
        real = min(rows, n_real - lo)  # this process's rows that hold a core
        l_err = abs(run["loss0"] - nlf) / abs(nlf)
        g_err = float(np.abs(run["grad_rows"][:real] - stacked_ref[lo:lo + real]).max()) / scale
        check(l_err <= TOL_FSDP and g_err <= TOL_FSDP
              and not np.count_nonzero(run["grad_rows"][real:]),
              f"fsdp {who}: step-0 loss err {l_err}, gradient rows err {g_err}, the pad "
              f"rows' gradient nonzero: {bool(np.count_nonzero(run['grad_rows'][real:]))}")
        check(run["launches"] == per_step, f"fsdp {who}: launches {run['launches']}")
        # the pad (row 31) is the last row of the process that holds it
        pad_kept = run["last_row_identity"] if real < rows else None
        check(pad_kept is not False and all(math.isfinite(x) for x in run["losses"]),
              f"fsdp {who}: identity pad kept {pad_kept}, losses {run['losses']}")
        if run is not one_f:
            share = run["state_bytes"] / one_f["state_bytes"]
            check(share <= FSDP_BYTES_SHARE, f"fsdp {who}: state bytes share {share}")
            franks.append({"rank": run["rank"], "loss0_err": l_err, "grad_rows_err": g_err,
                           "rows": rows, "pad_identity": pad_kept,
                           "state_bytes": run["state_bytes"],
                           "state_bytes_share": share,
                           "loss_first_last": [run["losses"][0], run["losses"][-1]],
                           **_run_summary(run)})
    rec_c = {"phase": "distributed", "part": "c_fsdp_headline",
             "program": f"make_fsdp_network_fit_step(mps_graph({FSDP_QUBITS}, dim={FSDP_BOND}), "
                        f"make_mesh({{'model': {FSDP_POSITIONS}}}, devices=['cuda:0'] * "
                        f"{FSDP_POSITIONS})), float32, {FSDP_STEPS} steps; 31 cores padded to "
                        f"32; one process, then {FSDP_POSITIONS} gloo ranks on cuda:0",
             "neg_log_f_unstacked": nlf, "tolerance": TOL_FSDP,
             "one_process": {"loss0_err": abs(one_f["loss0"] - nlf) / abs(nlf),
                             "pad_identity": one_f["last_row_identity"],
                             "state_bytes": one_f["state_bytes"],
                             "loss_first_last": [one_f["losses"][0], one_f["losses"][-1]],
                             **_run_summary(one_f)},
             "ranks": franks, "bytes_share_bound": FSDP_BYTES_SHARE,
             "launches": {k: one_f["launches"][k] + sum(o["launches"][k] for o in outs)
                          for k in per_step},
             "seconds": time.perf_counter() - t_part, "card": smi}
    emit(rec_c)
    recs.append(rec_c)

    # (d) the health check over (a)'s ranks, and gloo's point-to-point
    # primitives on CUDA tensors; (e) the dry runs: four launcher-started
    # ranks in processes of their own, and the one-process multi-device dry
    # run.  The probes and the four ranks start first and run beside the
    # one-process dry run (their times are mostly process start).
    from tneq_tpu_torch.ops import measurement_matrices
    from tneq_tpu_torch.ops.contract import abs_square
    from tneq_tpu_torch.parallel import make_sliced_siamese_fn
    from tneq_tpu_torch.parallel.dryrun import dryrun_multichip
    from tneq_tpu_torch.train.losses import nll_loss
    from tneq_tpu_torch.train.trainer import basis_states

    t_part = time.perf_counter()
    probes = _gloo_probes()
    mp = subprocess.Popen([sys.executable, "-m", "tneq_tpu_torch.bench.multiproc_dryrun"],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            dry = dryrun_multichip(DRYRUN_POSITIONS, device="cuda")
        dt_dry = time.perf_counter() - t0
        mp_out, mp_err = mp.communicate(timeout=600)
        dt_mp = time.perf_counter() - t_part
    finally:
        if mp.poll() is None:
            mp.kill()
            mp.wait()
    probed = _gloo_probe_results(*probes)
    for o in dp_outs:
        rep = o["health"]
        routes = {p: rep["axes"]["data"][p]["route"] for p in ("all_gather", "psum", "ppermute")}
        check(rep["ok"] and routes == GLOO_CUDA_ROUTES,
              f"health rank {o['rank']}: {rep}, routes {routes}")
    # bench stage 5 (5_collectives) on the same ranks: each collective's
    # time and route at the stage's default 8 MB
    stage5 = []
    for o in dp_outs:
        rec5 = o["collectives"]
        routes = {k: r["route"] for k, r in rec5.get("results", {}).items()}
        check("skipped" not in rec5 and rec5["n_devices"] == DP_WORLD
              and routes == STAGE_COLLECTIVE_ROUTES
              and all(r["ms"] > 0 for r in rec5["results"].values()),
              f"bench stage 5 on rank {o['rank']}: {rec5}")
        stage5.append({"rank": o["rank"], **rec5})
    print("bench stage 5 (5_collectives), gloo ranks on cuda:0:", file=sys.stderr)
    for r5 in stage5:
        for k, r in r5["results"].items():
            print(f"  rank {r5['rank']}  {k:10s} -> {r['collective']:10s} via {r['route']:10s}"
                  f" {r['ms']:9.3f} ms  {r['algo_gbps']:8.2f} GB/s", file=sys.stderr)
    rec_d = {"phase": "distributed", "part": "d_health",
             "program": f"check_mesh_health over the {DP_WORLD} gloo ranks of (a) (mesh "
                        f"{{'data': {DP_WORLD}, 'model': 1}} on cuda:0); gloo's "
                        "primitives the port does not use, on CUDA tensors; bench stage 5 "
                        "(5_collectives) on the same ranks",
             "reports": [o["health"] for o in dp_outs], "gloo_cuda_probes": probed,
             "stage_collectives": stage5,
             "card": smi}
    emit(rec_d)
    recs.append(rec_d)

    print(mp_err, file=sys.stderr, flush=True)
    check(mp.returncode == 0, f"multiproc_dryrun exited {mp.returncode}")
    mp_rec = json.loads(mp_out.strip().splitlines()[-1])
    # the same step's loss in one process on the card
    from tneq_tpu_torch.graph import parse_graph, wall_graph

    wg = parse_graph(wall_graph(4, layers=2, dim=2))
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(8, wg.nqubits)),
                        dtype=torch.float32, device="cuda")
    mx = measurement_matrices(x, 2).to(torch.complex64)
    raw = make_sliced_siamese_fn(wg, make_mesh({"data": 2, "model": 2}, devices=["cuda:0"] * 4))(
        init_params(wg, 0, torch.complex64, device="cuda"),
        basis_states(wg, dtype=torch.complex64, device="cuda"),
        [mx[:, q] for q in range(wg.nqubits)])
    mp_ref = float(nll_loss(abs_square(raw)))
    mp_err_rel = abs(mp_rec["loss"] - mp_ref) / abs(mp_ref)
    check(mp_rec["ok"] and mp_rec["n_processes"] == 4 and mp_err_rel <= TOL_RANK_VALUE,
          f"multiproc_dryrun: {mp_rec}, one-process loss {mp_ref}")
    rec_e = {"phase": "distributed", "part": "e_dryruns",
             "dryrun_multichip": {"positions": DRYRUN_POSITIONS, "device": "cuda:0",
                                  "result": dry, "seconds": dt_dry},
             "multiproc_dryrun": {**mp_rec, "one_process_loss": mp_ref,
                                  "rel_err": mp_err_rel, "tolerance": TOL_RANK_VALUE,
                                  "seconds": dt_mp},
             "seconds": time.perf_counter() - t_part, "card": smi}
    emit(rec_e)
    recs.append(rec_e)
    return recs


def _walk(x, path: str = ""):
    """``(path, key, value)`` of every entry of nested dicts and lists."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield path, k, v
            yield from _walk(v, f"{path}.{k}")
    elif isinstance(x, list):
        for i, v in enumerate(x):
            yield from _walk(v, f"{path}[{i}]")


def phase_bench_stages(smi: str, tmp: str) -> dict:
    """Phase 15: the port's benchmark stages through ``bench/run_all`` on
    the card, at the reference package's default sizes, one JSON line per
    stage; the card's bf16 matmul ceiling (stage 2 at n = 8192)."""
    from tneq_tpu_torch.bench import flops, run_all
    from tneq_tpu_torch.bench.microbench import ALL_STAGES, stage_matmul_peak
    from tneq_tpu_torch.ops.chain_overlap import MAX_S

    t_phase = time.perf_counter()
    ceiling = stage_matmul_peak(sizes=(CEILING_N,), dtypes=("bfloat16",), device="cuda")
    ceiling = {**ceiling["results"][0], "tflops": ceiling["results"][0]["gflops"] / 1e3}
    emit({"phase": "bench_stages", "bf16_matmul_ceiling": ceiling, "card": smi})
    out = f"{tmp}/bench_stages"
    with contextlib.redirect_stdout(sys.stderr):
        rc = run_all.main(["--stages", ",".join(BENCH_STAGES), "--out", out,
                           "--device", "cuda", "--timeout", "600"])
    names = [k for k in ALL_STAGES if any(k.startswith(p) for p in BENCH_STAGES)]
    records = {}
    for name in names:
        with open(f"{out}/{name}.json") as f:
            records[name] = json.load(f)
        emit({"phase": "bench_stages", "stage": name, "record": records[name], "card": smi})
    failed = [n for n, r in records.items() if not r.get("ok")]
    check(rc == 0 and not failed, f"bench_stages: run_all rc {rc}, failed stages {failed}")
    errors = [f"{n}{p}.{k}" for n, r in records.items() for p, k, _ in _walk(r)
              if k == "error" or k.endswith("_error")]
    check(not errors, f"bench_stages: error keys {errors}")
    shares = {f"{n}{p}.{k}": v for n, r in records.items() for p, k, v in _walk(r)
              if k in SHARE_KEYS and v is not None}
    shares["ceiling.peak_share"] = ceiling["peak_share"]
    over = {k: v for k, v in shares.items() if v > SHARE_BOUND}
    check(not over, f"bench_stages: shares above {SHARE_BOUND} of the H100 peak: {over}")
    # B1/B2: per step of 7b's sweep where S = D^2 fits the kernels (none
    # beyond: D = 64 takes the per-site scan), per FSDP step of 8
    sweep7b = records["7b_bond_sweep"]
    zero = {k: 0.0 for k in SWEEP_PER_STEP}
    for r in sweep7b["sweep"]:
        fits = r["bond_dim"] ** 2 <= MAX_S
        check(r["route"] == ("chain_sweep" if fits else "chain_scan")
              and r["launches_per_step"] == (SWEEP_PER_STEP if fits else zero),
              f"bench_stages 7b at D = {r['bond_dim']}: route {r['route']}, launches per "
              f"step {r['launches_per_step']}")
    check(any(r["bond_dim"] ** 2 > MAX_S for r in sweep7b["sweep"]),
          "bench_stages 7b: no point beyond the sweep kernels' cap")
    for c in records["8_fsdp_memory"]["curve"]:
        check(c["launches"] == SWEEP_PER_STEP,
              f"bench_stages 8 at {c['model_axis']} positions: launches {c['launches']}")
    launches = {k: round(sum(r["launches_per_step"][k] * sweep7b["bench_steps"]
                             for r in sweep7b["sweep"]))
                + sum(c["launches"][k] for c in records["8_fsdp_memory"]["curve"])
                for k in SWEEP_PER_STEP}
    rec = {"phase": "bench_stages",
           "program": f"bench/run_all.main --device cuda --stages {','.join(BENCH_STAGES)} "
                      "at the reference package's default sizes (5_collectives: phase 14 d)",
           "reduced": {}, "stages_ok": {n: r["ok"] for n, r in records.items()},
           "seconds_by_stage": {n: r["wall_time_s"] for n, r in records.items()},
           "bf16_matmul_ceiling": ceiling,
           "measured_matmul_tflops_in_flops_py": flops.MEASURED_MATMUL_TFLOPS,
           "shares": shares, "share_bound": SHARE_BOUND, "launches": launches,
           "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(rec)
    return rec


def _module_proc(args, log_path: str, env_extra=None):
    """``python -m <args>`` in a session of its own (so that its children
    can be killed with it), its standard error to ``log_path``."""
    env = dict(os.environ, **(env_extra or {}))
    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, "-m", *args], stdout=subprocess.PIPE,
                                stderr=log, text=True, env=env, start_new_session=True)


def _log_tail(path: str, n: int = 4000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def _last_json(stdout: str) -> dict:
    lines = [ln for ln in stdout.strip().splitlines() if ln.startswith("{")]
    check(bool(lines), f"no JSON line in {stdout[-500:]!r}")
    return json.loads(lines[-1])


def _kill_group(proc) -> None:
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def phase_bench_runners(smi: str, tmp: str) -> list:
    """Phase 16: the runners and probes of ``tneq_tpu_torch/bench`` on the
    card, each cut in depth only (the cuts beside the constants above), one
    JSON line per part.  The card's and the host's protocol and the 32q
    flagship child start first and run beside the parts in this process; a
    watcher kills the card's protocol once its first seed lands."""
    import threading
    from argparse import Namespace

    import numpy as np

    from tneq_tpu_torch.bench import (
        chain_variants, chunk_probe, flagship, ga_floor, mps_flagship, pallas_decision,
        protocol_compare, stiefel_stall,
    )
    from tneq_tpu_torch.ops import chain_overlap as co
    from tneq_tpu_torch.ops.chain_overlap import MAX_S

    recs = []

    def done(part: str, rec: dict) -> None:
        rec = {"phase": "bench_runners", "part": part, **rec, "card": smi}
        emit(rec)
        recs.append(rec)

    def since(before: dict) -> dict:
        after = co.launch_counts()
        return {k: after[k] - before[k] for k in after}

    zero = {k: 0 for k in co.launch_counts()}
    t_phase = time.perf_counter()
    co.reset_launch_counts()
    cache = {w: f"{tmp}/target_{w}.pkl" for w in ("cuda", "cpu")}
    state = {w: f"{tmp}/protocol_{w}.json" for w in ("cuda", "cpu")}
    logs = {name: f"{tmp}/{name}.log" for name in ("protocol_cpu", "protocol_cuda",
                                                   "flagship_32q")}

    def protocol_cmd(where: str) -> list:
        return ["tneq_tpu_torch.bench.flagship_protocol", *PROTOCOL_FLAGS, "--out",
                state[where], "--target-cache", cache[where], "--device", where]

    procs = {}
    try:
        # beside the card's work: the host's protocol and the 32q child
        procs["protocol_cpu"] = _module_proc(protocol_cmd("cpu"), logs["protocol_cpu"],
                                             {"OMP_NUM_THREADS": PROTOCOL_HOST_THREADS})
        procs["flagship_32q"] = _module_proc(
            ["tneq_tpu_torch.bench.flagship", *FLAGSHIP_CHILD_FLAGS, "--device", "cuda"],
            logs["flagship_32q"])
        t_h = time.perf_counter()
        # (a) the card's protocol, killed by the watcher once its first seed
        # lands (the state file is replaced whole after each seed)
        t_a = time.perf_counter()
        procs["protocol_cuda"] = _module_proc(protocol_cmd("cuda"), logs["protocol_cuda"])
        watch = {}

        def watcher(proc=procs["protocol_cuda"]):
            deadline = time.time() + 900
            while time.time() < deadline and proc.poll() is None:
                if os.path.exists(state["cuda"]):
                    with open(state["cuda"]) as f:
                        runs = json.load(f)["runs"]
                    if runs:
                        _kill_group(proc)
                        watch["first"] = runs[0]
                        watch["killed_after"] = time.perf_counter() - t_a
                        return
                time.sleep(0.5)

        watch_thread = threading.Thread(target=watcher, daemon=True)
        watch_thread.start()

        # (c) mps_flagship at its width and at D = 16
        t_c = time.perf_counter()
        mps = {}
        for name, flags in MPS_RUNS.items():
            before = co.launch_counts()
            t0 = time.perf_counter()
            out = mps_flagship.run(mps_flagship.parse_args(["--device", "cuda", *flags]))
            launches = since(before)
            rec, steps, warm = out["record"], out["warm_steps"], out["warm_launches"]
            check(math.isfinite(rec["validate_fidelity"]) and rec["warm_steps_per_sec"] > 0
                  and math.isfinite(rec["tflops"]),
                  f"bench_runners (c) {name}: record {rec}")
            dim = int(flags[flags.index("--dim") + 1]) if "--dim" in flags else 128
            if dim * dim <= MAX_S:
                # two overlaps forward and backward per step, the target's
                # norm forward once per fit (four warm fits)
                want = {"chain_sweep_fwd": 2 * steps + 4, "chain_sweep_bwd": 2 * steps}
            else:
                want = zero
            check(warm == want and (dim * dim <= MAX_S or launches == zero),
                  f"bench_runners (c) {name}: B1/B2 launches of the warm fits {warm} "
                  f"(wanted {want}), of the run {launches}")
            mps[name] = {"record": rec, "launches": launches, "warm_launches": warm,
                         "warm_steps": steps, "warm_seconds": out["warm_s"],
                         "warm_launches_per_fit_step": {k: v / steps for k, v in warm.items()},
                         "seconds": time.perf_counter() - t0,
                         "reduced": dict(zip(flags[::2], flags[1::2]))}
        done("c_mps_flagship", {"runs": mps, "seconds": time.perf_counter() - t_c})

        # (d) chain_variants at the headline shape
        t_d = time.perf_counter()
        rec_d = chain_variants.run(CHAIN_VARIANT_STEPS, "cuda")
        var = rec_d["variants"]
        errors = {k: v["error"] for k, v in var.items() if "error" in v}
        check(not errors, f"bench_runners (d): variants failed: {errors}")
        ref = var["direct"]["loss"]
        rel = {k: abs(v["loss"] - ref) / abs(ref) for k, v in var.items()}
        check(max(rel.values()) <= TOL_VARIANT,
              f"bench_runners (d): final losses against direct's, relative {rel}")
        n = CHAIN_VARIANT_STEPS
        for k, v in var.items():
            want = {"chain_sweep_fwd": 3 * n, "chain_sweep_bwd": 2 * n} if k == "pallas" else zero
            check(v["launches"] == want,
                  f"bench_runners (d) {k}: B1/B2 launches {v['launches']}, wanted {want}")
        done("d_chain_variants", {"record": rec_d, "loss_rel_to_direct": rel,
                                  "tolerance": TOL_VARIANT,
                                  "reduced": {"steps": CHAIN_VARIANT_STEPS},
                                  "seconds": time.perf_counter() - t_d})

        # (e) stiefel_stall at 12 qubits, D = 8
        t_e = time.perf_counter()
        before = co.launch_counts()
        stall_args = stiefel_stall.parse_args(["--device", "cuda", *STALL_FLAGS])
        rec_e = stiefel_stall.run(stall_args)
        launches_e = since(before)
        fits = len(rec_e["curves"]) * len(rec_e["checkpoints"])
        check(all(math.isfinite(f) for c in rec_e["curves"] for f in c["fidelities"]),
              f"bench_runners (e): fidelities {rec_e['curves']}")
        # each fit: two overlaps forward and backward per step, the target's
        # norm forward once
        check(launches_e["chain_sweep_bwd"] > 0
              and launches_e["chain_sweep_fwd"] - launches_e["chain_sweep_bwd"] == fits,
              f"bench_runners (e): B1/B2 launches {launches_e} over {fits} fits")
        done("e_stiefel_stall", {"record": rec_e, "launches": launches_e, "fits": fits,
                                 "reduced": dict(zip(STALL_FLAGS[::2], STALL_FLAGS[1::2])),
                                 "seconds": time.perf_counter() - t_e})

        # (f) chunk_probe on the 32 x 5 flagship fit
        t_f = time.perf_counter()
        rec_f = chunk_probe.run(Namespace(device="cuda", n_qubits=32, **CHUNK_PROBE))
        check(all(math.isfinite(r["nlf"]) for r in rec_f["results"])
              and "t_exec_per_step_s" in rec_f,
              f"bench_runners (f): record {rec_f}")
        done("f_chunk_probe", {"record": rec_f, "reduced": CHUNK_PROBE,
                               "seconds": time.perf_counter() - t_f})

        # (g) ga_floor at 30 qubits on the uniform ends
        t_g = time.perf_counter()
        before = co.launch_counts()
        rec_g = ga_floor.run(ga_floor.parse_args(["--device", "cuda", *GA_FLOOR_FLAGS]))
        launches_g = since(before)
        check(len(rec_g["landscape"]) == 2
              and all(math.isfinite(r["best_neg_logF"]) for r in rec_g["landscape"])
              and math.isfinite(rec_g["matched_deep_neg_logF"]),
              f"bench_runners (g): record {rec_g}")
        # the evaluator contracts by the pairwise executor, in JAX too
        check(launches_g == zero, f"bench_runners (g): B1/B2 launches {launches_g}")
        done("g_ga_floor", {"record": rec_g, "launches": launches_g,
                            "reduced": dict(zip(GA_FLOOR_FLAGS[::2], GA_FLOOR_FLAGS[1::2])),
                            "seconds": time.perf_counter() - t_g})

        # (b) batched_compare on (a)'s cached target, once the card's first
        # child wrote it; (a) resumed once the watcher killed it
        deadline = time.time() + 900
        while not os.path.exists(cache["cuda"]) and watch_thread.is_alive() \
                and time.time() < deadline:
            time.sleep(0.5)
        check(os.path.exists(cache["cuda"]),
              f"bench_runners (a): no target cache: the card's target did not validate:\n"
              f"{_log_tail(logs['protocol_cuda'])}")
        t_b = time.perf_counter()
        compare = subprocess.Popen(
            [sys.executable, "-m", "tneq_tpu_torch.bench.batched_compare", *COMPARE_FLAGS,
             "--target-cache", cache["cuda"], "--device", "cuda"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True)
        procs["batched_compare"] = compare
        watch_thread.join(timeout=900)
        print(_log_tail(logs["protocol_cuda"]), file=sys.stderr, flush=True)
        check("first" in watch, f"bench_runners (a): no seed of the card's protocol landed "
                                f"(exit {procs['protocol_cuda'].poll()})")
        first = watch["first"]
        resumed = subprocess.Popen([sys.executable, "-m", *protocol_cmd("cuda")],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                   start_new_session=True)
        procs["protocol_cuda_resumed"] = resumed
        out, err = resumed.communicate(timeout=900)
        print(err[-4000:], file=sys.stderr, flush=True)
        check(resumed.returncode == 0, f"bench_runners (a): the resumed protocol exited "
                                       f"{resumed.returncode}")
        summary_cuda = _last_json(out)
        with open(state["cuda"]) as f:
            st_cuda = json.load(f)
        check(st_cuda["complete"] and [r["seed"] for r in st_cuda["runs"]] == [0, 1]
              and st_cuda["runs"][0] == first
              and "1 restart(s) already recorded" in err
              and "restart seed=0 " not in err,
              f"bench_runners (a): the resumed card state {summary_cuda}; seed 0 "
              f"{'kept' if st_cuda['runs'][0] == first else 'changed'}")
        seconds_a = time.perf_counter() - t_a

        # (b)
        out, err = compare.communicate(timeout=900)
        print(err[-4000:], file=sys.stderr, flush=True)
        check(compare.returncode == 0 and err.count("target cache hit") == 2,
              f"bench_runners (b): batched_compare exited {compare.returncode}")
        rec_b = _last_json(out)
        check(rec_b["device"] == "cuda" and rec_b["value"] is not None,
              f"bench_runners (b): record {rec_b}")
        done("b_batched_compare", {"record": rec_b, "reduced": dict(zip(
            COMPARE_FLAGS[::2], COMPARE_FLAGS[1::2])), "seconds": time.perf_counter() - t_b})

        # (h) the 32q flagship child
        proc = procs["flagship_32q"]
        stdout, _ = proc.communicate(timeout=900)
        seconds_h = time.perf_counter() - t_h
        print(_log_tail(logs["flagship_32q"]), file=sys.stderr, flush=True)
        check(proc.returncode == 0, f"bench_runners (h): the 32q child exited {proc.returncode}")
        rec_h = _last_json(stdout)
        want_fl = flagship.flops_per_step_32q(flagship.build_32q(8, 8, device="cpu"))
        # 16 steps of SGD-G at lr 1 need not lower -log F (the stage's verdict
        # wants a fall of 1 over 240 steps): finite values are checked
        check(rec_h["flops_per_step"] == want_fl and math.isfinite(rec_h["mxu_util"])
              and rec_h["nlf_final"] is not None and math.isfinite(rec_h["nlf_final"])
              and math.isfinite(rec_h["nlf_after_8_steps"]),
              f"bench_runners (h): record {rec_h} (flops per step {want_fl})")
        done("h_flagship_32q", {"record": rec_h, "reduced": dict(zip(
            FLAGSHIP_CHILD_FLAGS[::2], FLAGSHIP_CHILD_FLAGS[1::2])), "seconds": seconds_h})

        # (a) the host's protocol, then the comparisons
        proc = procs["protocol_cpu"]
        stdout, _ = proc.communicate(timeout=900)
        print(_log_tail(logs["protocol_cpu"]), file=sys.stderr, flush=True)
        check(proc.returncode == 0, f"bench_runners (a): the host's protocol exited "
                                    f"{proc.returncode}")
        with open(state["cpu"]) as f:
            st_cpu = json.load(f)
        with open(JAX_PROTOCOL_FILE) as f:
            st_jax = json.load(f)
        masks = {tuple(r["planted_mask"]) for st in (st_cuda, st_cpu) for r in st["runs"]}
        check(st_cpu["complete"] and st_cpu["settings"]["cpu"]
              and not st_cuda["settings"]["cpu"] and len(masks) == 1,
              f"bench_runners (a): host state complete {st_cpu['complete']}, planted masks "
              f"{masks}")
        with contextlib.redirect_stdout(sys.stderr):
            rc = protocol_compare.main(["--a", state["cuda"], "--b", state["cpu"],
                                        "--out", f"{tmp}/compare.json"])
        with open(f"{tmp}/compare.json") as f:
            cmp_host = json.load(f)
        cmp_jax = protocol_compare.compare_protocols(st_cuda, st_jax, "gpu", "jax_cpu")
        check(rc == 0 and cmp_host["n_shared"] == 2 and cmp_host["planted_masks_consistent"]
              and cmp_jax["n_shared"] == 2 and cmp_jax["planted_masks_consistent"],
              f"bench_runners (a): compare card/host {cmp_host['n_shared']} shared seeds, "
              f"card/JAX {cmp_jax['n_shared']}")
        done("a_protocol", {
            "reduced": dict(zip(PROTOCOL_FLAGS[::2], PROTOCOL_FLAGS[1::2])),
            "on_card": {"summary": summary_cuda, "runs": st_cuda["runs"],
                     "killed_after_seconds": watch["killed_after"], "seconds": seconds_a},
            "on_host": {"summary": {k: st_cpu["analysis"].get(k) for k in
                                 ("n_restarts", "pruned_sizes", "intersection_size")},
                     "runs": st_cpu["runs"], "threads": PROTOCOL_HOST_THREADS},
            "compare_card_host": {k: cmp_host[k] for k in (
                "n_shared", "mean_jaccard", "seeds_identical_set", "pooled_family")},
            "compare_card_jax_file": {"file": JAX_PROTOCOL_FILE, **{k: cmp_jax[k] for k in (
                "n_shared", "mean_jaccard", "seeds_identical_set", "planted_masks_consistent")}},
        })

        # (i) pallas_decision at JAX's default grid, alone on the card
        t_i = time.perf_counter()
        before = co.launch_counts()
        lane_vals = {}
        rec_i = pallas_decision.run(DECISION_QUBITS, DECISION_CONFIGS, DECISION_REPEATS,
                                    "cuda", lane_out=lane_vals)
        launches_i = since(before)
        errors = {(r["bond_dim"], r["batch"], k): r[k]["error"] for r in rec_i["grid"]
                  for k in pallas_decision.VARIANTS if "error" in r[k]}
        check(not errors, f"bench_runners (i): variants failed: {errors}")
        lane_err = {}
        for r in rec_i["grid"]:
            vals = lane_vals[(r["bond_dim"], r["batch"])]
            ref = vals["mform"]
            rel = {k: float(np.max(np.abs(vals[k] - ref) / np.abs(ref))) for k in ("pallas",
                                                                                    "direct")}
            lane_err[f"{r['bond_dim']}x{r['batch']}"] = rel
            check(vals["pallas"].shape == (r["batch"],) and np.isfinite(vals["pallas"]).all()
                  and rel["pallas"] <= TOL_KERNEL and rel["direct"] <= TOL_DECISION_DIRECT,
                  f"bench_runners (i) {r['bond_dim']}x{r['batch']}: lanes against mform's, "
                  f"relative {rel}")
            dev_ms = {k: r[k]["device_ms_per_repeat"] for k in pallas_decision.VARIANTS}
            check(all(v is not None and v > 0 for v in dev_ms.values()),
                  f"bench_runners (i) {r['bond_dim']}x{r['batch']}: device ms per repeat "
                  f"{dev_ms}")
            per_repeat = {k: r[k]["b1_launches_per_repeat"] for k in pallas_decision.VARIANTS}
            check(per_repeat == {"direct": 0, "mform": 0, "pallas": 1},
                  f"bench_runners (i) {r['bond_dim']}x{r['batch']}: B1 launches per repeat "
                  f"{per_repeat}")
        want_i = {"chain_sweep_fwd": sum(r[k]["b1_launches"] for r in rec_i["grid"]
                                         for k in pallas_decision.VARIANTS),
                  "chain_sweep_bwd": 0}
        check(launches_i == want_i, f"bench_runners (i): B1/B2 launches {launches_i}, "
                                    f"the record's {want_i}")
        done("i_pallas_decision", {"record": rec_i, "lane_rel_to_mform": lane_err,
                                   "tolerance": {"pallas": TOL_KERNEL,
                                                 "direct": TOL_DECISION_DIRECT},
                                   "launches": launches_i,
                                   "reduced": {"repeats": DECISION_REPEATS},
                                   "seconds": time.perf_counter() - t_i})
    finally:
        for proc in procs.values():
            _kill_group(proc)
    launches = co.launch_counts()
    paths = {"chain_variants_pallas": var["pallas"]["launches"],
             "mps_flagship_d16": mps["d16"]["launches"], "stiefel_stall": launches_e,
             "pallas_decision": launches_i}
    check(launches == {k: sum(p[k] for p in paths.values()) for k in launches},
          f"bench_runners: B1/B2 launches {launches} against its paths' {paths}")
    rec = {"phase": "bench_runners", "launches": launches, "launch_paths": paths,
           "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(rec)
    recs.append(rec)
    return recs


def kernels_line(kern: dict, bench: dict, transfer: dict, born: dict, cli: dict,
                 batched: list, large_n: dict, prob: dict, distributed: list,
                 stages: dict, runners: dict, row_gate: dict, brick_network: dict) -> dict:
    main_case = next(c for c in kern["cases"] if c["S"] == 256)
    dist = {r["part"]: r for r in distributed}
    fsdp = dist["c_fsdp_headline"]
    lane_part = next(r for r in batched if r["part"] == "a_lane_kernels")
    mps_part = next(r for r in batched if r["part"] == "d_mps_experiment")
    lane_case = next(c for c in lane_part["cases"] if c["lanes"] == LANE_CHUNK)
    rows = []
    for name in ("chain_sweep_fwd", "chain_sweep_bwd"):
        meta = _KERNELS[name]
        lt = lane_case["times"][name]
        rows.append({
            "name": name,
            "id": meta["id"],
            "route": "cuda",
            "source": "tneq_tpu_torch/csrc/chain_sweep.cu",
            "replaces": meta["replaces"],
            # the bench run's, phase 11 (a)'s fits, phase 14 (c)'s FSDP
            # steps (one process and both ranks), bench stages 7b and 8, and
            # phase 16's runners
            "launches": bench["launches"][name] + large_n["launches"][name]
            + fsdp["launches"][name] + stages["launches"][name]
            + runners["launches"][name],
            "bench_stages": {"launches": stages["launches"][name],
                             "launches_per_step": SWEEP_PER_STEP[name]},
            "bench_runners": {path: launches[name]
                              for path, launches in runners["launch_paths"].items()},
            "launches_per_step": bench["launches_per_step"][name],
            "max_abs_err": main_case["max_abs_err"][name],
            "ms": main_case["times"][name]["ms"],
            "plain_ms": main_case["times"][name]["plain_ms"],
            "bound_ms": main_case["bounds"][name]["bound_ms"],
            "bound_by": main_case["bounds"][name]["bound_by"],
            "library_ms": None,
            "device_ms": main_case["times"][name]["device_ms"],
            "plain_device_ms": main_case["times"][name]["plain_device_ms"],
            "cluster": main_case["plans"][name]["cluster"],
            "shape": {"n": main_case["n"], "S": main_case["S"]},
            # the batched prune's launch: LANE_CHUNK sweeps in one
            "lanes": {
                "lanes": LANE_CHUNK, "ms": lt["ms"], "device_ms": lt["device_ms"],
                "device_ms_per_lane": lt["device_ms_per_lane"], "plain_ms": lt["plain_ms"],
                "single_lane_launches_device_ms": lt["single_lane_launches_device_ms"],
                "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"],
                "max_abs_err": lane_case["max_abs_err"][name],
                "cluster": lane_case["plans"][name]["cluster"],
                "launches": mps_part["launches"][name],
                "launches_per_chunk_step": mps_part["launches_per_chunk_step"][LANE_CHUNK][name],
            },
            # B1 alone at bench/pallas_decision's grid (phase 10 (a)); its
            # launches in phase 16 (i)
            **({"decision_grid": [
                {k: c[k] for k in ("bond", "lanes", "n", "S", "ms", "device_ms",
                                   "device_ms_per_lane", "plain_ms", "plain_device_ms",
                                   "bound_ms", "bound_by", "max_abs_err", "plan")}
                for c in lane_part["decision_grid"]]} if name == "chain_sweep_fwd" else {}),
            # phase 11 (a): the 64- and 128-qubit fits
            "fsdp": {"launches": fsdp["launches"][name],
                     "launches_per_step_per_rank": fsdp["launches"][name]
                     / (FSDP_STEPS * (1 + FSDP_POSITIONS))},
            "large_n": [{"n": part["sweep_case"]["n"], "S": part["sweep_case"]["S"],
                         "ms": part["sweep_case"]["times"][name]["ms"],
                         "device_ms": part["sweep_case"]["times"][name]["device_ms"],
                         "plain_ms": part["sweep_case"]["times"][name]["plain_ms"],
                         "bound_ms": part["sweep_case"]["bounds"][name]["bound_ms"],
                         "bound_by": part["sweep_case"]["bounds"][name]["bound_by"],
                         "max_abs_err": part["sweep_case"]["max_abs_err"][name],
                         "launches_per_step": part["launches_per_step"][name]}
                        for part in large_n["parts"]],
        })
    # phase 14's new paths: (a) the data-parallel trainer (B3, one process
    # and both ranks), (b) the trainer CLI (B4)
    dist_launches = {
        "transfer_step": {"path": "a_dp_trainer", "launches": dist["a_dp_trainer"]["launches"],
                          "launches_per_step_per_rank": dist["a_dp_trainer"]["launches"]
                          / (DP_STEPS * (1 + DP_WORLD))},
        "transfer_step_complex": {
            "path": "b_trainer_cli",
            "launches": dist["b_trainer_cli"]["launches"]["transfer_step_complex"],
            "launches_per_step": dist["b_trainer_cli"]["launches_per_step"][
                "transfer_step_complex"]},
    }
    # the wide route's paths: phase 6's trainer at bond 64 (B3), phase 7's
    # --dim 32 and bond-128 trainer (B4)
    wide_launches = {
        "transfer_step": {"born_rule_wide": born["wide"]["launches"]["transfer_step"]},
        "transfer_step_complex": {
            "cli_dim32": cli["wide"]["launches"]["transfer_step_complex"],
            "cli_trainer_bond128": cli["c3"]["launches"]["transfer_step_complex"]},
    }
    # fault C4's chains past the gate: the einsum step, no launch
    refused = {"transfer_step": born["c4_rank72"], "transfer_step_complex": cli["c4_bond264"]}
    for name, run, shape in (("transfer_step", born, BORN_SHAPE),
                             ("transfer_step_complex", cli, CLI_SHAPE)):
        meta = _KERNELS[name]
        # the sweep as the main path launches it, and its one-site case
        case, one = (next(c for c in transfer["cases"]
                          if c["kernel"] == name and c["n"] == n
                          and (c["B"], c["D"], c["K"]) == shape)
                     for n in (MIDDLE_STEPS, 1))
        rows.append({
            "name": name,
            "id": meta["id"],
            "route": "cuda",
            "source": "tneq_tpu_torch/csrc/transfer_step.cu",
            "replaces": meta["replaces"],
            # the training run's, phase 11 (c)'s probability, phase 14's and
            # (B4) the cli phase's profiled run
            "launches": run["launches"][name] + prob["born_rule"]["launches"][name]
            + dist_launches[name]["launches"] + cli["profile"]["launches"][name]
            + sum(wide_launches[name].values()),
            "distributed": dist_launches[name],
            "wide_route_launches": wide_launches[name],
            "past_the_gate": {k: refused[name][k] for k in ("program", "strategy", "launches")},
            "launches_per_step": run["launches_per_step"][name],
            "max_abs_err": case["max_abs_err"],
            "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            # no one PyTorch call computes a sweep of n > 1 sites; one step
            # is one torch.einsum, timed at n = 1
            "library_ms": None,
            "device_ms": case["device_ms"],
            "bwd_ms": case["bwd_ms"],
            "bwd_device_ms": case["bwd_device_ms"],
            "per_site_device_us": case["per_site_device_us"],
            "plain_device_ms": case["plain_device_ms"],
            "one_site": {k: one[k] for k in ("ms", "device_ms", "library_ms",
                                             "library_device_ms", "bound_ms")},
            "plan": case["plan"],
            "shape": {"n": MIDDLE_STEPS, "B": shape[0], "D": shape[1], "K": shape[2]},
            # every shape of phase 5 off the main path's: the wide route's,
            # the gate's corners, and ROUTE_SHAPE on both routes
            "other_shapes": [
                {k: c.get(k) for k in (
                    "n", "B", "D", "K", "edge", "route", "max_abs_err", "ms", "device_ms",
                    "bwd_device_ms", "plain_device_ms", "library_device_ms", "bound_ms",
                    "bound_by", "tc_bound_ms", "tc_bound_by", "narrow_device_ms",
                    "narrow_bwd_device_ms", "wide_device_ms", "wide_bwd_device_ms")}
                for c in transfer["cases"]
                if c["kernel"] == name and (c["B"], c["D"], c["K"]) != shape],
        })
    # the row sweep's gate steps at the brick cell's 8 lanes, each form
    piece = brick_network["reference_default"]["lane_piece"]
    for name, part in (("row_gate_fwd", "fwd"), ("row_gate_bwd", "bwd")):
        meta = _KERNELS[name]
        rows.append({
            "name": name,
            "id": meta["id"],
            "route": "cuda",
            "source": "tneq_tpu_torch/csrc/row_gate.cu",
            "replaces": meta["replaces"],
            # one 8-lane piece of the batched prune (phase 9 (a)), as planned
            "launches": piece["row_scan_launches"][name],
            "piece_steps": piece["steps"],
            "gate_steps_per_overlap": piece["gate_steps_per_overlap"],
            "forms": [{
                "form": c["form"], "K": c["K"], "N": c["N"], "lanes": c["lanes"],
                "ms": c[f"{part}_ms"], "device_ms": c[f"{part}_device_ms"],
                "plain_device_ms": c[f"plain_{part}_device_ms"],
                "library_device_ms": c[f"library_{part}_device_ms"],
                "bound_ms": c[part]["bound_ms"], "bound_by": c[part]["bound_by"],
                "max_rel_err": max(max(e["out"], e["d_env"], e["d_gate"]) for e in c["errors"]),
            } for c in row_gate["cases"]],
        })
    return {"kernels": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only "
              "on the card", file=sys.stderr)
        return 2
    try:
        import tneq_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0

    try:
        setup = timed("setup", phase_setup)
        smi = setup["nvidia_smi"]
        kern = timed("kernels", phase_kernels)
        row_gate = timed("row_gate_kernels", phase_row_gate_kernels)
        lane_kern = timed("lane_kernels", phase_lane_kernels, smi)
        bench = timed("bench", phase_bench, smi)
        _, experiment = timed("experiment", phase_experiment)
        transfer = timed("transfer_kernels", phase_transfer_kernels)
        born = timed("born_rule", phase_born_rule, smi)
        cli = timed("cli", phase_cli, smi)
        _, dense_fitted = timed("brick", phase_brick, smi)
        brick_network = timed("brick_network", phase_brick_network, smi, dense_fitted)
        batched = timed("batched", phase_batched, smi, experiment, dense_fitted)
        large_n = timed("large_n", phase_large_n, smi)
        timed("engine", phase_engine, smi)
        prob = timed("probability_checks", phase_probability_checks, smi)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            timed("ga_cli", phase_ga_cli, smi, tmp)
        timed("ga30", phase_ga30, smi)
        timed("merge_split", phase_merge_split, smi)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            timed("sliced", phase_sliced, smi, brick_network, tmp)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            distributed = timed("distributed", phase_distributed, smi, tmp)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            stages = timed("bench_stages", phase_bench_stages, smi, tmp)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            runners = timed("bench_runners", phase_bench_runners, smi, tmp)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    emit({"phase": "timing", "seconds": seconds, "total": sum(seconds.values())})
    emit(kernels_line(kern, bench, transfer, born, cli, [lane_kern] + batched, large_n,
                      prob, distributed, stages, runners[-1], row_gate, brick_network))
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
