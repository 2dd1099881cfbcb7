#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. the card: its name and power limit (``nvidia-smi``);
2. build all nine CUDA libraries from ``src/repro_torch/csrc`` (one ``nvcc``
   each, in parallel); print ``ptxas``'s registers and spills of every
   entry function (no ``flash_attention_bwd`` or ``selective_scan_bwd``
   entry function may spill),
   the tensor-core instructions (``HMMA``/``HGMMA``) of every
   ``flash_attention`` kernel from ``cuobjdump -sass`` (each bf16
   tensor-core prefill kernel must have some) and the warpgroup products
   (``HGMMA``) of every ``flash_attention_bwd`` kernel (the dK/dV and the
   dQ kernel of each head dim must have some), the non-coherent loads
   of the network cluster kernels (none may be narrower than 64 bits: their
   int32 path rows are written and read in one launch), and the
   exponentials (``MUFU.EX2``) of every ``selective_scan_bwd`` entry
   function (each reverse walk exactly one a state a step of its unrolled
   round, 16 x 4); build the first version of ``selective_scan_bwd``
   (``dev/scan_bwd_first``) beside it, and read the resident blocks an SM
   of the reverse walk (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
   behind ``resident_blocks``): at least ``BLOCKS_PER_SM`` (16 warps) in
   both dtypes, or the run fails;
3. the two network kernels (one thread-block cluster per engine call, the
   staged alloc/release slot writes folded in) at the main path's shapes —
   16,384 slots, depth 3, the 555 links of the 500-site grid, 679 and
   13,528 dirty slots (the mean and the maximum per flush on
   ``grid_500_saturated``), a staged release and a staged alloc: each
   kernel bit-equal to its plain PyTorch version on the same packed inputs, slots outside the listed and staged
   ones untouched; the kernel's device time and its device operations per
   call (``torch.profiler`` over 200 calls: one kernel and one copy), the
   time of a call through the wrapper (copy, launch, sync), the plain
   version's device time (calls replayed from a CUDA graph) and wrapper
   time, beside the bound. After phase 7 the same check runs at
   ``grid_500_evict``'s own per-call shape (its slot capacity, listed and
   staged slots per re-rate, from the card run);
4. golden cells on the card: ``fig4/hrs/100`` bit-exact under
   ``net="numpy"`` and ``net="pallas"`` (the ``net_rerate`` path), within
   ``tests/golden_tolerance.json`` under ``net="device"``, and the deep cell
   bit-exact against ``tests/golden_deep.json``;
5. the main path at scale: ``grid_500_saturated`` at full width (500
   sites, the full catalog, ``broker="jax"``, ``net="device"``) with the job
   count cut from 20,000 to 2,000, on the card and on the CPU; all four
   metrics must be equal and the ``event_engine`` kernel must have run;
6. parity and timing of ``strategy_plan``, ``st_cost`` and ``value_score``
   at their paths' shapes: a ``grid_500_evict`` burst (500 sites x 1,250
   pairs, zero and nonzero serve), the ``bulk_shortest`` and 500-site
   dispatch bursts, the ``economy_starved`` (52 x 100) and 500 x 1,000
   value matrices in both modes — each bit-equal to its plain version,
   timed beside its bound; ``strategy_plan``'s bound counts the bytes its
   result depends on (``fetch`` at every cell, ``bw`` and ``local`` where
   ``fetch`` holds), with the bound at every cell beside it
   (``bound_all_cells_ms``). ``phase_dense_kernels`` imports
   ``repro_torch`` from ``sys.path``, so an older checkout's ``src``
   placed first is timed by the same code;
7. the slice's paths (``PATHS``) on the card and on the CPU:
   ``grid_500_evict`` in ``strategy_mode="batch"`` at full width (500
   sites, 10,000 files, 25-file jobs, ``broker="jax"``) with the job count
   cut from 20,000 to 2,000, ``bulk_shortest`` as registered,
   ``economy_starved`` at seed 0, ``hotset_drift`` under the
   ``predictive`` strategy and ``site_churn`` (500 jobs, six site outages
   from ``churn_schedule``). All four metrics must equal between the card
   and the CPU and equal the reference's (``REFERENCE``), and each path
   must launch its kernels (``PATH_KERNELS``); the card runs record their
   network-call shapes (``watch_engines``);
8. the serving path's kernels at its shapes (``ATTN_CASES``, ``SCAN_CASES``):
   ``flash_attention`` for the gemma3-1b prefill (B 4, H 4, KV 1, S 1,024,
   hd 256; global, local, float32 and softcap forms) and decode (one query
   against the 1,040-slot cache; global and local in bf16, global in
   float32), and at the MoE configs' layers (``MOE_ATTN_CASES``):
   granite-moe-1b-a400m's prefill and split decode (H 16, KV 8, hd 64) in
   bf16 and float32, arctic-480b's prefill (H 56, KV 8, hd 128) in bf16
   and float32, and zamba2-7b's shared block (``ZAMBA_ATTN_CASES``: H 32,
   KV 32, hd 112) in prefill and decode, bf16 and float32;
   ``selective_scan`` for the falcon-mamba-7b
   prefill (Bz 4, S 1,024, Di 8,192, N 16) and decode (S 1 from a state;
   timed cold, cycling over ``MAMBA_LAYERS`` states, warm beside it),
   each against its plain version within ``TOL`` (ten times for the scan),
   with device, wrapper, plain and ``scaled_dot_product_attention`` times
   beside the bound (bytes, operations, or for the scan the exponentials
   at the special-function rate ``SFU_EXPS``, whichever is slowest), and
   the ``flash_attention`` route each case takes
   (``plan_launch``: bf16 prefill on the tensor cores, float32 prefill on
   the CUDA cores, decode as splits of the key range and a merge);
9. serving (``SERVE``): ``repro_torch.launch.serve`` at full width for
   gemma3-1b, falcon-mamba-7b (depth ``MAMBA_TRAIN_LAYERS`` of 64,
   ``SERVE_LAYERS``), granite-moe-1b-a400m (phase 14 (b); its
   routes that differ between the bf16 kernel and plain runs counted by
   ``route_flips``), zamba2-7b (depth ``ZAMBA_TRAIN_LAYERS`` of 81; phase
   15 (b)) and internvl2-2b at full depth, text-only as the engine serves
   it (phase 16 (c)) — seeded weights, the two-pod router, 4
   requests of 1,024-token prompts, 16 new tokens — on the kernels, then the
   same model and inputs on the plain route (``backend="plain"``) on the
   card, then both routes again with the weights in float32. Each kernel
   must launch once per step in each layer whose kind runs it
   (``kernel_layers`` x 17: every layer for gemma3-1b, falcon-mamba-7b and
   granite, zamba2-7b's 2 shared-block applications of its 18 layers)
   on the bf16 kernel run, the plain route never. The float32 prefill logits must agree
   within ``SERVE_TOL_F32``; the bf16 ones within twice the bf16 noise (how
   far the plain route's bf16 logits lie from its float32 ones); the greedy
   tokens by ``greedy_agreement``'s margin rule at each tolerance. Each
   model is warmed up at the served shape on both routes before the timed
   runs; a MoE model's or zamba2-7b's bf16 prefill and one decode step are
   then profiled by family (``serve_split``; ``ssd``: Mamba-2's chunk
   work, by its profiler range ``SSD_SCOPE``);
10. telemetry, audit and sanitizer on the card (``phase_telemetry``):
   ``grid_500_saturated`` (2,000 jobs) under ``obs="trace"`` on the card
   and the CPU — its metrics equal to phase 5's card run, the four phase
   buckets partitioning the probe's ``wall_s``, the counters equal between
   card and CPU, and one ``net.flush`` span per ``event_engine`` launch
   (plus the flushes that found no active transfer, which launch
   nothing); phase 7's paths under ``obs="report"`` on the card, each
   with the reference's metrics and its kernels launched; the
   ``torch.profiler`` busy share of ``grid_500_saturated`` and
   ``grid_500_evict`` (batch) at ``TRACE_JOBS`` jobs; the conservation
   audit (``run_conservation_smoke`` and ``grid_500_saturated`` at 2,000
   jobs, ``net="device"``), every check ``ok`` and each report equal to
   the CPU's; ``sanitize_smoke`` on the card equal to the CPU's and to
   ``SANITIZE_REFERENCE``; a deep-copied simulator whose network engine
   caches none of the original's addresses and whose run leaves the
   original untouched; and the cost of one empty span (``probe_cost``);
11. the analysis layer on the card (``phase_analysis``): the kernel audit
   (``repro_torch.analysis.kernel_audit``) over every registered kernel —
   each CUDA route's peak device bytes (its input bytes plus what the call
   allocates) within its spec's budget, the simulation kernels equal to
   their plain versions at the spec's small and audit inputs, the model
   kernels within tolerance, each kernel launched; ``python -m
   repro_torch.analysis --fail-on-findings --units --conserve --tierace``
   (``ANALYSIS_CLI``) as a subprocess on the card, exit 0 with no finding;
   ``experiments.sweep`` of ``paper_baseline`` at ``SWEEP_JOBS`` jobs over
   hrs, bhr and lru, each cell bit-equal to ``tests/golden_metrics.json``'s
   ``fig4/*/100``, ``net_rerate`` launched; and ``experiments --all --jobs
   60`` (``ALL_JOBS``) on the card and on the CPU, equal in all four
   metrics;
12. training (``phase_train_kernels``, ``phase_train``,
   ``phase_supervisor``): (a) ``flash_attention_bwd`` at gemma3-1b's
   global and local layers (B 4, H 4, KV 1, S 1,024, hd 256, window 512)
   and gemma2-27b's heads with its softcap 50 (H 32, KV 16, hd 128, S
   512): dq, dk and dv against the float32 plain backward, each within
   twice the plain bf16 route's own error against it, and against the
   plain backward on the same inputs within ``TOL``, and bit-equal
   between two calls; the forward's lse
   within ``TOL``; device and wrapper times of the forward with lse and of
   the backward, the plain backward's, and
   ``scaled_dot_product_attention`` forward + backward beside the bound by
   operations (2.5 x the forward's); the port's forward + backward and
   the library's, as device time by the profiler, with the library's
   backend read from its kernels' names and its backward kernels alone
   (cuDNN's bprop). (b) gemma3-1b at full width and depth
   through ``repro_torch.launch.train``'s functions, batch 4 x 1,024: the
   first step's loss and every gradient leaf on the kernels against
   ``backend="plain"`` on the card within ``TRAIN_TOL`` (the plain bf16
   route's own distance from float32 printed beside), then ``TRAIN_STEPS``
   steps on a repeated batch under the supervisor (no checkpoint): the
   loss must fall; step ms, tokens/s, peak device memory and the flash
   forward (twice per layer: remat recomputes it) and backward launches
   per step. (c) the supervisor at the reduced gemma3-1b on the card:
   a checkpoint every 4 steps, a failure at step 6, 24 steps; one restart,
   the restored state bit-equal to what was saved;
13. training Mamba-1 (``phase_train_mamba_kernels``, ``phase_train_mamba``;
   its wall time printed): (a) the scan's forward with round states and
   ``selective_scan_bwd`` at falcon-mamba-7b's shape (Bz 4, S 1,024, Di
   8,192, N 16) in float32 and bf16, a nonzero h0 and dh_last: y and
   h_last bit-equal to the forward without states, every gradient against
   the plain backward on the same inputs within ten times ``TOL``
   (float32) or ``TOL`` (bf16) of its largest entry, two calls bit-equal;
   device and wrapper times of the forward with and without states and of
   the backward, the plain backward's, beside the bound (bytes: x, dt, dy
   read and dx, ddt written); the backward and its first version timed in
   turns (first, current, current, first) on the same inputs. (b)
   falcon-mamba-7b at full width and depth ``MAMBA_TRAIN_LAYERS`` of 64,
   batch 4 x 1,024, the same run as 12 (b):
   first step against ``backend="plain"`` within ``TRAIN_TOL``, 8 steps
   with a falling loss, ``selective_scan`` twice and
   ``selective_scan_bwd`` once a layer a step and nothing else, one step
   profiled by family;
14. the MoE feed-forward and the float32 backward: (a)
   ``flash_attention_bwd`` at granite-moe-1b-a400m's attention layer (B 4,
   H 16, KV 8, S 1,024, hd 64; ``MOE_BWD_CASES``) as 12 (a), in bf16 and
   on the float32 route (CUDA cores), and the float32 route at gemma3-1b's
   global layer: a float32 case against the plain backward on the same
   inputs within ``TOL["float32"]``, two calls bit-equal, timed as 12 (a)
   beside its bound by float32 operations and
   ``scaled_dot_product_attention``'s float32 forward + backward; (b) is
   phase 9's granite-moe-1b-a400m run; (c) granite-moe-1b-a400m trained at
   full width and depth as 12 (b), its first step's ``moe_aux`` held with
   the loss; the routes of both bf16 first steps are recorded, and in a
   layer whose routes differ the feed-forward's leaves (router, experts)
   and the norm before it are held within ``TRAIN_TOL`` or twice the plain
   bf16 route's own distance from float32, whichever is larger (a flipped
   token's gradient moves them as far as bf16 itself does), every other
   leaf within ``TRAIN_TOL``; the first step also in float32 (the float32
   backward), every leaf within ``TRAIN_TOL``; the profiled step's
   ``moe`` family is the device time inside the feed-forward's profiler
   range (``MOE_SCOPE``, forward, recompute and backward) that no other
   family takes; (d) arctic-480b at full width and depth
   ``ARCTIC_LAYERS``: one prefill of 4 x 1,024 tokens on the kernels and on
   the plain route in bf16, then with the weights in float32; the float32
   logits within ``SERVE_TOL_F32``, the bf16 ones within twice the plain
   bf16 route's distance from float32 (relative L2), peak memory and the
   routes that differ;
15. Mamba-2 and the shared attention block: (a) ``flash_attention_bwd``
   at zamba2-7b's shared layer (B 4, H 32, KV 32, S 1,024, hd 112;
   ``ZAMBA_BWD_CASES``) as 14 (a), in bf16 and on the float32 route (the
   forward's cases are in phase 8); (b) is phase 9's zamba2-7b run; (c)
   zamba2-7b trained at full width, its depth cut to ``ZAMBA_TRAIN_LAYERS``
   (2 groups and 4 remainder mamba2 blocks), as 12 (b): the first step
   within ``TRAIN_TOL`` of the plain route in the loss and every leaf,
   the shared block's included, 8 steps with a falling loss, 4
   ``flash_attention`` and 2 ``flash_attention_bwd`` launches a step, one
   profiled step by family with ``ssd``;
16. the encoder-decoder and the VLM front end: (a) ``flash_attention`` at
   their calls (``ENCDEC_ATTN_CASES``), as phase 8's cases: whisper-large-v3's
   encoder layer non-causal (B 4, H 20 on 20, S 1,500, hd 64) in bf16 and
   float32, its teacher-forced cross-attention (Sq 187 x Skv 1,500,
   non-causal), its split decode over the 1,500 cross keys in bf16 and in
   float32 on the bf16 caches cast (the casts timed beside) and over 17
   self keys, internvl2-2b's prefill and split decode (H 16 on 8, hd 128)
   in bf16 and float32; (b) whisper-large-v3 at full width and depth (32 +
   32 layers, seed 0): 4 requests of ``WHISPER_FRAMES`` frame embeddings
   from the seed, ``model.prefill`` (the encoder, the cross caches, the
   BOS step) and ``SERVE_NEW`` greedy tokens (``generate_encdec``), on the
   kernels and the plain route, in bf16 and with the same weights in
   float32, held by phase 9's rules (``hold_served``; float32 twice: with
   float32 caches at ``SERVE_TOL_F32``, and with the reference's bf16
   caches within twice what they move the plain route's float32 logits),
   32 + 64 x 17
   ``flash_attention`` launches and no other kernel, none on the plain
   route; prefill ms, decode ms a token, tokens/s, peak memory; (c)
   internvl2-2b's phase 9 run, then one ``model.prefill`` with 256 patch
   embeddings a request from the seed (``phase_vlm_prefill``), kernels
   against the plain route by the same rules, its logits moved off the
   text-only prefill's by more than the bf16 tolerance;
18. the mesh (``phase_mesh``): a (1, 1) ``DeviceMesh`` over NCCL at world
   size 1, from an in-process ``HashStore``; (a) gemma3-1b's parameters
   at full width and depth written to a checkpoint, restored and placed
   by ``reshard_for_mesh`` with the parameter rules, each leaf's
   ``full_tensor()`` bit-equal to the restored leaf; (b) its first
   training step at ``TRAIN_B`` x ``TRAIN_S`` on DTensor parameters,
   optimizer state and batch through ``make_train_step(mesh=...)``'s
   pinned gradient: ``flash_attention`` and ``flash_attention_bwd``
   launched as in 12 (b)'s first step and nothing else, the loss and
   every gradient leaf within ``TRAIN_TOL`` of the step without a mesh
   (the largest difference printed), then whole steps timed with
   ``max_memory_allocated``; (c) ``repro_torch.launch.dryrun`` of the
   same cell on a (1, 1) fake mesh, in a subprocess started before (a):
   its FLOPs (aten products plus the kernel formulas) within
   ``MESH_FLOPS_TOL`` of one profiled step's (``torch.profiler``
   ``with_flops`` over ``PROFILED_PRODUCTS`` plus the same formulas over
   the kernels launched, ``kernel_work``), its peak within
   ``MESH_PEAK_RATIO`` of the measured one.

The launch counts of each path are reset just before it runs and read just
after. The second-to-last line is the kernel summary as JSON; the last line
is ``{"ok": true, "device": {...}}``. Without a card, or without the rest
of the repository beside it, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

SLOTS, DEPTH = 16384, 3
DIRTY = (679, 13528)          # mean and max dirty slots per flush
SCALE_JOBS = 2000

#: The slice's scenario paths (phase 7): registry name, the spec fields
#: replaced, and the job count (``grid_500_evict`` cut from 20,000).
PATHS = {
    "grid_500_evict": ("grid_500_evict", {"strategy_mode": "batch"}, 2000),
    "bulk_shortest": ("bulk_shortest", {}, 500),
    "economy_starved": ("economy_starved", {}, 500),
    "hotset_drift": ("hotset_drift", {"strategy": "predictive"}, 500),
    "site_churn": ("site_churn", {}, 500),
}
#: The kernels each path must launch on the card.
PATH_KERNELS = {
    "grid_500_evict": ("strategy_plan", "net_rerate"),
    "bulk_shortest": ("st_cost",),
    "economy_starved": ("value_score",),
    "hotset_drift": ("value_score",),
    "site_churn": ("net_rerate",),
}
#: The reference's metrics of each path (``repro`` on the CPU, seed 0;
#: ``avg_job_time`` is the left-to-right mean of its job records), printed
#: by ``PYTHONPATH=src python tests/test_torch_smoke.py`` on a machine with
#: JAX; ``tests/test_torch_smoke.py`` holds the three short ones to it.
REFERENCE = {
    "grid_500_evict": {
        "avg_job_time": 178.90909695251497, "makespan": 29938.44298370881,
        "avg_inter_comms": 13.1415, "completed_jobs": 2000},
    "bulk_shortest": {
        "avg_job_time": 177305.7129894169, "makespan": 261626.7979223158,
        "avg_inter_comms": 4.896, "completed_jobs": 500},
    "economy_starved": {
        "avg_job_time": 320078.74173721217, "makespan": 386100.0,
        "avg_inter_comms": 7.252, "completed_jobs": 500},
    "hotset_drift": {
        "avg_job_time": 123720.46816159964, "makespan": 165600.0,
        "avg_inter_comms": 3.112, "completed_jobs": 500},
    "site_churn": {
        "avg_job_time": 137426.83633935088, "makespan": 189057.12660265114,
        "avg_inter_comms": 3.74, "completed_jobs": 500},
}
#: The reference's ``sanitize_smoke()`` at its defaults (40 jobs in bursts
#: of 8 on the paper grid, seed 0): ``repro.analysis.tierace`` on the CPU;
#: ``tests/test_torch_tierace.py`` holds it to the reference.
SANITIZE_REFERENCE = {"ties_seen": 366, "tie_races": [
    {"time": 0.0, "kinds": ["SUBMIT"] * 8,
     "detail": "state.sites[5][2]: 1500000000.0 != 1000000000.0"},
    {"time": 480.0, "kinds": ["SUBMIT"] * 8,
     "detail": "state.sites[11][2]: 1500000000.0 != 2000000000.0"},
    {"time": 960.0, "kinds": ["SUBMIT"] * 8,
     "detail": "state.queue[2][0]: 1128.0 != 968.0"},
    {"time": 1440.0, "kinds": ["SUBMIT"] * 8,
     "detail": "state.queue[2][0]: 1556.6666666666667 != 1444.0"},
    {"time": 1920.0, "kinds": ["SUBMIT"] * 8,
     "detail": "state.sites[1][2]: 3000000000.0 != 3500000000.0"},
]}
#: Phase 10's busy-share pass (``torch.profiler``): jobs per cell.
TRACE_JOBS = 500
#: Phase 11: the fig4 sweep cells (``paper_baseline`` x ``n_jobs``) held
#: to ``tests/golden_metrics.json``, and the job count of ``--all``.
SWEEP_JOBS, SWEEP_STRATEGIES = 100, ("hrs", "bhr", "lru")
ALL_JOBS = 60
#: The analysis CLI as phase 11 runs it on the card (a subprocess).
ANALYSIS_CLI = ("-m", "repro_torch.analysis", "--fail-on-findings",
                "--units", "--conserve", "--tierace")
#: The serving path's kernel shapes (phase 8): gemma3-1b's attention layers
#: (B, H, KV, hd, S) in prefill and decode, falcon-mamba-7b's scan.
ATTN_CASES = (
    # name, dtype, Sq, window, softcap, q_offset, kv_len
    ("prefill global bf16", "bfloat16", 1024, None, None, 0, None),
    ("prefill local bf16", "bfloat16", 1024, 512, None, 0, None),
    ("prefill global f32", "float32", 1024, None, None, 0, None),
    ("prefill softcap bf16", "bfloat16", 1024, None, 50.0, 0, None),
    ("decode global bf16", "bfloat16", 1, None, None, 1039, 1040),
    ("decode local bf16", "bfloat16", 1, 512, None, 1039, 1040),
    ("decode global f32", "float32", 1, None, None, 1039, 1040),
)
GEMMA_B, GEMMA_H, GEMMA_KV, GEMMA_HD, CACHE_LEN = 4, 4, 1, 256, 1040
SCAN_CASES = (("prefill f32", 1024), ("decode S=1 f32", 1))
MAMBA_BZ, MAMBA_DI, MAMBA_N = 4, 8192, 16
#: falcon-mamba-7b's layers: the cold decode timing cycles over one state
#: set per layer (~5 MB each, ~330 MB in all, above the 50 MB L2)
MAMBA_LAYERS = 64
L2_BYTES = 50 * 2 ** 20       # H100 SXM
TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # tests/test_kernels.py
#: Serving runs (phase 9): arch, its kernel, requests, prompt, new tokens.
SERVE = (("gemma3-1b", "flash_attention"), ("falcon-mamba-7b",
                                            "selective_scan"),
         ("granite-moe-1b-a400m", "flash_attention"),
         ("zamba2-7b", "flash_attention"),
         ("internvl2-2b", "flash_attention"))
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 1024, 16
#: kernel route against plain route with float32 weights, at each model's
#: served depth
#: (the bf16 runs are held to twice the bf16 noise measured in the run)
SERVE_TOL_F32 = 1e-3
#: Phase 12 (a): the backward's shapes: name, B, H, KV, S, hd, window,
#: softcap (gemma3-1b's global and local layers, gemma2-27b's heads)
BWD_CASES = (
    ("gemma3-1b global", "bfloat16", 4, 4, 1, 1024, 256, None, None),
    ("gemma3-1b local", "bfloat16", 4, 4, 1, 1024, 256, 512, None),
    ("gemma2-27b softcap", "bfloat16", 4, 32, 16, 512, 128, None, 50.0),
)
#: Phase 12 (b): batch, sequence and steps of the full-width training run;
#: the relative tolerance of the kernel route's first-step loss and of
#: each gradient leaf (relative L2 distance) against the plain route, both
#: in bf16: a wrong mask, layout or gradient moves a leaf by O(1), the bf16
#: rounding of 26 layers by about 1e-2 (the plain route's own distance from
#: float32 is printed beside)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 8
TRAIN_TOL = 5e-2
#: Phase 17 (b), (c): the float32 first step, kernels against plain (the
#: leaves read 1.2e-5 and 1.5e-5 at most on an H100; PERF.md)
TRAIN_TOL_F32 = 1e-4
#: Phase 14 (a): the backward at granite-moe-1b-a400m's attention layer,
#: in bf16 and on the float32 route, and the float32 route at gemma3-1b's
#: global layer (as BWD_CASES)
MOE_BWD_CASES = (
    ("granite-moe-1b-a400m", "bfloat16", 4, 16, 8, 1024, 64, None, None),
    ("granite-moe-1b-a400m", "float32", 4, 16, 8, 1024, 64, None, None),
    ("gemma3-1b global", "float32", 4, 4, 1, 1024, 256, None, None),
)
#: The MoE configs' attention layers as their serving paths call the
#: forward (phases 9 and 14 (d)): name, dtype, B, H, KV, hd, Sq, q_offset,
#: kv_len (causal, no window, no softcap; decode reads a 1,040-slot cache)
MOE_ATTN_CASES = (
    ("granite-moe-1b-a400m prefill bf16", "bfloat16", 4, 16, 8, 64, 1024, 0,
     None),
    ("granite-moe-1b-a400m decode bf16", "bfloat16", 4, 16, 8, 64, 1, 1039,
     1040),
    ("granite-moe-1b-a400m prefill f32", "float32", 4, 16, 8, 64, 1024, 0,
     None),
    ("granite-moe-1b-a400m decode f32", "float32", 4, 16, 8, 64, 1, 1039,
     1040),
    ("arctic-480b prefill bf16", "bfloat16", 4, 56, 8, 128, 1024, 0, None),
    ("arctic-480b prefill f32", "float32", 4, 56, 8, 128, 1024, 0, None),
)
#: Phase 14 (d): arctic-480b's depth (one layer's 128 experts are 26.8 GB
#: in bf16; the whole model is ~954 GB); its bf16 prefill logits are held
#: as phase 9 holds bf16 logits, to twice the plain bf16 route's own
#: distance from float32, measured in the run, and its float32 logits to
#: SERVE_TOL_F32
ARCTIC_LAYERS = 1
#: Phase 15: zamba2-7b's shared attention block (32 query heads on 32 KV
#: heads, hd 112) as serving calls the forward (phase 8: a 1,024-token
#: prefill, decode against a 1,040-slot cache; name, dtype, B, H, KV, hd,
#: Sq, q_offset, kv_len) and as training calls the backward (15 (a), as
#: BWD_CASES), and the depth zamba2-7b trains at in 15 (c): 81 layers need
#: ~92.5 GB of training state at 16 bytes a parameter, 18 (2 groups of six
#: mamba2 blocks and the shared block, then 4 mamba2 blocks) ~25.1 GB
ZAMBA_ATTN_CASES = (
    ("zamba2-7b prefill bf16", "bfloat16", 4, 32, 32, 112, 1024, 0, None),
    ("zamba2-7b decode bf16", "bfloat16", 4, 32, 32, 112, 1, 1039, 1040),
    ("zamba2-7b prefill f32", "float32", 4, 32, 32, 112, 1024, 0, None),
    ("zamba2-7b decode f32", "float32", 4, 32, 32, 112, 1, 1039, 1040),
)
ZAMBA_BWD_CASES = (
    ("zamba2-7b shared", "bfloat16", 4, 32, 32, 1024, 112, None, None),
    ("zamba2-7b shared", "float32", 4, 32, 32, 1024, 112, None, None),
)
ZAMBA_TRAIN_LAYERS = 18
#: Phase 16 (a): the flash attention calls of the encoder-decoder and the
#: VLM (name, dtype, B, H, KV, hd, Sq, Skv, causal, q_offset, kv_len,
#: cast): whisper-large-v3's encoder layer (non-causal, its 1,500 frames
#: not a multiple of 64), its teacher-forced cross-attention (187 decoder
#: positions on 1,500 keys), its decode against the cross caches (all
#: 1,500 keys: q_offset 1,499, as the model calls it; float32 reads the
#: bf16 caches cast) and the self caches (17 keys of 187 slots, the last
#: of 16 new tokens); internvl2-2b's prefill and decode (H 16 on KV 8,
#: hd 128, a 1,040-slot cache)
ENCDEC_ATTN_CASES = (
    ("whisper-large-v3 encoder bf16", "bfloat16", 4, 20, 20, 64, 1500, 1500,
     False, 0, None, False),
    ("whisper-large-v3 encoder f32", "float32", 4, 20, 20, 64, 1500, 1500,
     False, 0, None, False),
    ("whisper-large-v3 cross train bf16", "bfloat16", 4, 20, 20, 64, 187,
     1500, False, 0, None, False),
    ("whisper-large-v3 cross decode bf16", "bfloat16", 4, 20, 20, 64, 1, 1500,
     True, 1499, 1500, False),
    ("whisper-large-v3 cross decode f32", "float32", 4, 20, 20, 64, 1, 1500,
     True, 1499, 1500, True),
    ("whisper-large-v3 self decode bf16", "bfloat16", 4, 20, 20, 64, 1, 187,
     True, 16, 17, False),
    ("internvl2-2b prefill bf16", "bfloat16", 4, 16, 8, 128, 1024, 1024,
     True, 0, None, False),
    ("internvl2-2b decode bf16", "bfloat16", 4, 16, 8, 128, 1, 1040, True,
     1039, 1040, False),
    ("internvl2-2b prefill f32", "float32", 4, 16, 8, 128, 1024, 1024, True,
     0, None, False),
    ("internvl2-2b decode f32", "float32", 4, 16, 8, 128, 1, 1040, True,
     1039, 1040, False),
)
#: Phase 17 (a): the backward at the training calls of the encoder-decoder
#: and the VLM, in bf16 and on the float32 route: name, dtype, B, H, KV, S
#: (queries), hd, window, softcap, then causal and Skv: whisper-large-v3's
#: encoder layer (1,500 frames, not a multiple of 64, non-causal), its
#: cross-attention (187 decoder positions on 1,500 keys, non-causal) and
#: its decoder's self-attention (187, causal); internvl2-2b's layer (H 16
#: on KV 8, hd 128, causal)
ENCDEC_BWD_CASES = tuple(
    (name, dtype, B, H, KV, S, hd, None, None, causal, skv)
    for name, B, H, KV, S, hd, causal, skv in (
        ("whisper-large-v3 encoder", 4, 20, 20, 1500, 64, False, 1500),
        ("whisper-large-v3 cross", 4, 20, 20, 187, 64, False, 1500),
        ("whisper-large-v3 decoder self", 4, 20, 20, 187, 64, True, 187),
        ("internvl2-2b", 4, 16, 8, 1024, 128, True, 1024))
    for dtype in ("bfloat16", "float32"))
#: Phase 17 (b): whisper-large-v3's training batch: 1,500 frame embeddings
#: a row (from the seed, as phase 16 (b)), so 187 decoder tokens
WHISPER_TRAIN_FRAMES = 1500
#: Phase 16 (b): whisper-large-v3's requests: 1,500 frame embeddings each
#: (Whisper's 30 s window after the stubbed conv front end), so 187
#: decoder positions; the prompt is the BOS token, then SERVE_NEW tokens
WHISPER, WHISPER_FRAMES = "whisper-large-v3", 1500
#: Phase 16 (c): internvl2-2b's patch embeddings a request (the stub
#: InternViT front end's 256), N(0, 0.02^2) as its token embeddings
VLM_PATCH_SCALE = 0.02
#: Phase 13: the scan backward's dtypes at falcon-mamba-7b's shape
#: (MAMBA_BZ x TRAIN_S, MAMBA_DI, MAMBA_N), and the depth falcon-mamba-7b
#: trains at (64 layers need 112.1 GB of training state; 8 need 17.7 GB)
SCAN_BWD_DTYPES = ("float32", "bfloat16")
MAMBA_TRAIN_LAYERS = 8
#: Phase 9's depth cuts, to keep the script inside its time limit: the
#: two models whose serving runs took longest at full depth (49 and 63 s
#: of a 1,065 s script on an H100; falcon-mamba-7b's plain route walks
#: the scan a step at a time) serve at the depth they train at; every
#: other model at full depth
SERVE_LAYERS = {"falcon-mamba-7b": MAMBA_TRAIN_LAYERS,
                "zamba2-7b": ZAMBA_TRAIN_LAYERS}
#: The first version of ``selective_scan_bwd`` (one 256-thread block an SM,
#: two exponentials a state a step): its source and the header it was
#: written against, built beside the current one and timed in turns with
#: it in phase 13 (a)
SCAN_BWD_FIRST = os.path.join(ROOT, "dev", "scan_bwd_first")
#: exponentials in the SASS of each reverse walk: one a state (4 a thread)
#: a step of its unrolled 16-step round
SCAN_BWD_EX2 = 16 * 4


def _port_module(name: str):
    """A module of the port beside this script (``src/``), unless one is
    importable already (an older checkout's ``src`` placed first)."""
    import importlib
    import importlib.util

    if importlib.util.find_spec("repro_torch") is None:
        sys.path.append(os.path.join(ROOT, "src"))
    return importlib.import_module(name)


#: the H100 SXM figures of the port's roofline (one set for the repository)
_H100 = _port_module("repro_torch.launch.roofline")
HBM_BYTES_PER_S = _H100.HBM_BW          # HBM3
FP64_FLOPS = _H100.FP64_FLOPS           # float64, outside the tensor cores
BF16_FLOPS = _H100.BF16_FLOPS           # bf16, dense tensor cores
FP32_FLOPS = _H100.FP32_FLOPS           # float32, outside the tensor cores
#: the work formulas of the scan's forward and backward (their packages')
scan_work = _port_module("repro_torch.kernels.selective_scan.work").scan_work
scan_bwd_work = _port_module(
    "repro_torch.kernels.selective_scan_bwd.work").scan_bwd_work
#: exponentials a second on the special-function units: 16 a clock per SM,
#: 132 SMs, at the clock the float32 figure assumes (67e12 / (132 x 256))
SFU_EXPS = 4.18e12
ROUNDS, CALLS = 20, 50        # timing: rounds of back-to-back calls
#: st_cost's design, named in its kernel summary entry
ST_COST_DESIGN = (
    "two launches: missing_time_kernel finds each file's fetchable holders "
    "once per block (shared-memory bits, __ffs pops, coalesced bw row "
    "gathers) and packs presence by ballots; job_cost_kernel ranks each "
    "job's required files into a list once per block and adds their "
    "t_miss in ascending file order; launched as a programmatic dependent "
    "of the first")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def device_ms(fn, rounds: int = ROUNDS, calls: int = CALLS) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured into one
    CUDA graph, replayed between CUDA events, median over ``rounds``
    replays. The host's share of a call (input checks, ctypes, the launch
    itself) is not in it."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def wrapper_ms(fn, rounds: int = ROUNDS, calls: int = CALLS,
               warmup: int = 20) -> float:
    """Time of one eager ``fn()`` call as the engine makes it: CUDA events
    around ``calls`` back-to-back calls, median over ``rounds`` rounds.
    The host issues calls slower than the card runs them, so this is the
    Python wrapper's throughput, not the kernel's time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def engine_state(scenario: str, seed: int, n_slots: int, n_dirty: int,
                 n_staged: int, dev):
    """Slot state and one call's inputs at a path's shapes: realistic paths
    from the scenario's grid, a mix of released, fresh and carried slots,
    random link occupancy, ``n_dirty`` distinct listed slots and
    ``n_staged`` staged rows (releases and allocs; one alloc also listed,
    as after a transfer start). Returns ``(state, inputs, now, sizes)``:
    numpy slot arrays, the packed ``NetInputs`` on ``dev`` and the counts
    the bound needs."""
    import numpy as np

    from repro_torch.core import SCENARIOS, build_topology, to_grid_config
    from repro_torch.kernels.net_call import NetInputs

    topo = build_topology(to_grid_config(SCENARIOS[scenario]))
    rng = np.random.default_rng(seed)
    links = list(topo.nic_links) + list(topo.wan_links)
    bw = np.array([l.bandwidth for l in links])
    act = rng.integers(0, 40, len(links)).astype(np.float64)
    n_sites = topo.n_sites

    def route():
        ids = topo.link_ids_for(int(rng.integers(n_sites)),
                                int(rng.integers(n_sites)))
        row = np.full(DEPTH, -1, np.int32)
        row[:len(ids)] = ids
        return row

    path = np.full((n_slots, DEPTH), -1, np.int32)
    kind = rng.integers(0, 3, n_slots)    # 0 released, 1 fresh, 2 carried
    for s in np.flatnonzero(kind > 0):
        path[s] = route()
    now = 5e4
    rem = np.where(kind == 1, rng.integers(1, 1000, n_slots) * 5e5, 0.0)
    rate = np.where(kind == 2, rng.uniform(1e4, 1e7, n_slots), 0.0)
    eta = np.where(kind == 2, now + rng.uniform(0.0, 1e5, n_slots), np.inf)
    due = np.where(kind == 2, eta - 1.0 / np.where(rate > 0, rate, 1.0),
                   np.inf)
    perm = rng.permutation(n_slots).astype(np.int32)
    staged = perm[:n_staged]
    alloc = np.arange(n_staged) % 2 == 0          # allocs and releases
    st_rem = np.where(alloc, rng.integers(1, 1000, n_staged) * 5e5, 0.0)
    st_path = np.stack([route() if a else np.full(DEPTH, -1, np.int32)
                        for a in alloc]) if n_staged else \
        np.zeros((0, DEPTH), np.int32)
    idx = np.concatenate([staged[:1], perm[n_staged: n_staged + n_dirty - 1]]
                         )[:n_dirty] if n_dirty else perm[:0]
    state = dict(path=path, rem=rem, rate=rate, eta=eta, due=due,
                 active=kind > 0)
    inputs = NetInputs(len(links), DEPTH, dev).pack(
        np.stack([bw, act]), staged, st_rem, alloc, st_path,
        np.sort(idx))
    sizes = dict(slots=n_slots, dirty=n_dirty, staged=n_staged,
                 links=len(links))
    return state, inputs, now, sizes


def slot_arrays(state: dict, dev):
    import torch

    from repro_torch.kernels.net_call import SlotArrays

    t = {k: torch.tensor(v, device=dev) for k, v in state.items()}
    return SlotArrays(t["path"], t["rem"], t["rate"], t["eta"], t["due"],
                      t["active"])


def profiled_call(fn, calls: int = 200) -> dict:
    """``calls`` back-to-back ``fn()`` calls under ``torch.profiler``
    (after a warm-up): per call, the device time of the cluster kernels and
    of the host-to-device copies, the number of device operations, and
    each device operation's name with its count. The trace may miss a few
    calls, so each average is over the cluster kernels it recorded
    (``recorded``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern = [e for e in rows if "cluster_kernel" in e.key]
    copy = [e for e in rows if "Memcpy" in e.key]
    if not kern:
        raise AssertionError(f"no cluster kernel in the trace: "
                             f"{[e.key for e in rows]}")
    n = sum(e.count for e in kern)
    return dict(
        kernel_us=sum(e.self_device_time_total for e in kern) / n,
        copy_us=sum(e.self_device_time_total for e in copy) / n,
        device_ops_per_call=sum(e.count for e in rows) / n, recorded=n,
        ops={e.key: e.count for e in rows})


def net_kernel_case(scenario: str, seed: int, n_slots: int, n_dirty: int,
                    n_staged: int, dev) -> dict:
    """Both network kernels, with staged rows, at one shape: bit-equal to
    their plain versions on the same packed inputs (slots outside the
    listed and staged ones untouched); device time (``torch.profiler``)
    and time through the wrapper of the kernel, device and wrapper time of
    the plain version, and the bound. Returns ``{kernel: record}``."""
    import torch

    from repro_torch.kernels.event_engine import (event_engine_kernel,
                                                  event_engine_ref)
    from repro_torch.kernels.net_rerate import (net_rerate_kernel,
                                                net_rerate_ref)

    state, inputs, now, n = engine_state(scenario, seed, n_slots, n_dirty,
                                         n_staged, dev)
    idx_t, bw_t, act_t, staged_t = inputs.tensors(dev)
    touched = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    touched[idx_t.long()] = True
    touched[staged_t[0].long()] = True
    keys = ("path", "rem", "rate", "eta", "due", "active")
    L, N, S, D, n_s = n["links"], n["dirty"], n["staged"], DEPTH, n["slots"]
    # each input read once, each output written once: the packed inputs,
    # the staged rows' six slot fields, then per listed slot and the scan
    common = 16 * L + 8 * S + 4 * S * (2 + D) + 4 * N + S * (33 + 4 * D) + 8

    def plain_net(sl, i=idx_t, b=bw_t, a=act_t, st=staged_t):
        return net_rerate_ref(i, sl.path, sl.rem, sl.rate, b, a, now, st,
                              eta=sl.eta, due=sl.due, active=sl.active)

    def plain_flush(sl, i=idx_t, b=bw_t, a=act_t, st=staged_t):
        return event_engine_ref(i, sl.path, sl.rem, sl.rate, sl.eta, sl.due,
                                b, a, now, st, active=sl.active)

    cases = (("net_rerate", net_rerate_kernel, plain_net,
              common + 4 * D * N + 8 * N + 16 * n_s, 3 * D * N + 4 * n_s),
             ("event_engine", event_engine_kernel, plain_flush,
              common + 4 * D * N + 16 * N + 32 * N + 8 * n_s,
              (3 * D + 8) * N + n_s))
    out = {}
    for name, kern, plain, bytes_, flops in cases:
        rec = dict(shape=f"{scenario} slots={n_s} dirty={N} staged={S}",
                   n_dirty=N, bytes=bytes_, flops=flops, max_abs_err=0.0)
        k = slot_arrays(state, dev)
        p = slot_arrays(state, dev)
        got = kern(inputs, k, now)
        want = plain(p).item()
        if got != want:
            raise AssertionError(f"{name} {rec['shape']}: minimum {got!r} "
                                 f"!= plain {want!r}")
        before = slot_arrays(state, dev)
        for key in keys:
            a, b = getattr(k, key), getattr(p, key)
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: {key} differs from the plain "
                                     "version")
            if not torch.equal(a[~touched], getattr(before, key)[~touched]):
                raise AssertionError(f"{name}: {key} changed outside the "
                                     "listed and staged slots")
        fn = lambda: kern(inputs, k, now)  # noqa: E731
        prof = profiled_call(fn)
        rec.update(ms=prof["kernel_us"] / 1e3, copy_ms=prof["copy_us"] / 1e3,
                   device_ops_per_call=prof["device_ops_per_call"],
                   recorded=prof["recorded"], ops=prof["ops"],
                   wrapper_ms=wrapper_ms(fn))
        p = slot_arrays(state, dev)
        rec["plain_ms"] = device_ms(lambda: plain(p))
        # as the old engine called it: the inputs copied up, then the op
        rec["plain_wrapper_ms"] = wrapper_ms(
            lambda: plain(p, *inputs.tensors(dev)))
        rec["bound_ms"], rec["bound_by"] = roofline(bytes_, flops, FP64_FLOPS)
        print(f"[kernels] {name} {rec['shape']} bit-equal; device: "
              f"kernel={1e3 * rec['ms']!r}us copy={1e3 * rec['copy_ms']!r}us "
              f"device_ops_per_call={rec['device_ops_per_call']!r} "
              f"{rec['ops']} (calls recorded: {rec['recorded']} of 200) "
              f"plain={1e3 * rec['plain_ms']!r}us; through the "
              f"wrapper: kernel={1e3 * rec['wrapper_ms']!r}us "
              f"plain={1e3 * rec['plain_wrapper_ms']!r}us; bytes={bytes_} "
              f"flops={flops} bound={1e3 * rec['bound_ms']!r}us "
              f"({rec['bound_by']})")
        out[name] = rec
    return out


def phase_kernels(dev) -> dict:
    """Parity and timing of both network kernels at the smoke shapes
    (16,384 slots, 679 and 13,528 dirty, one staged release and one
    staged alloc); returns per-kernel lists of records."""
    out: dict = {}
    for n_dirty in DIRTY:
        for name, rec in net_kernel_case("grid_500_saturated", n_dirty,
                                         SLOTS, n_dirty, 2, dev).items():
            out.setdefault(name, []).append(rec)
    return out


def phase_golden(dev) -> dict:
    """Golden cells on the card; returns the launch counts of the
    net_rerate path (numpy + pallas cells)."""
    from repro_torch.core import SCENARIOS, GridConfig, run_experiment
    from repro_torch.kernels import _cuda
    from repro_torch.launch.experiments import run_spec

    tests = os.path.join(ROOT, "tests")
    golden = json.load(open(os.path.join(tests, "golden_metrics.json")))
    tol = json.load(open(os.path.join(tests, "golden_tolerance.json")))
    deep = json.load(open(os.path.join(tests, "golden_deep.json")))
    g = golden["metrics"]["fig4/hrs/100"]
    exact = ("avg_job_time", "avg_inter_comms", "total_wan_gb", "makespan")

    _cuda.reset_launches()
    for net in ("numpy", "pallas"):
        r = run_experiment(GridConfig(), strategy="hrs", n_jobs=100,
                           net=net, device=dev)
        for m in exact:
            if getattr(r, m) != g[m]:
                raise AssertionError(f"fig4/hrs/100 net={net}: {m} "
                                     f"{getattr(r, m)!r} != {g[m]!r}")
        if r.completed_jobs != 100:
            raise AssertionError(f"net={net}: {r.completed_jobs} completed")
        print(f"[golden] fig4/hrs/100 net={net} bit-exact "
              f"avg_job_time={r.avg_job_time!r}")
    rerate_path = dict(_cuda.LAUNCHES)

    r = run_experiment(GridConfig(), strategy="hrs", n_jobs=100,
                       net="device", device=dev)
    for m in ("avg_job_time", "avg_inter_comms", "makespan"):
        got, want = getattr(r, m), g[m]
        rel = 0.0 if got == want else abs(got - want) / max(abs(got),
                                                            abs(want))
        if rel > tol["bounds"][m]:
            raise AssertionError(f"fig4/hrs/100 net=device: {m} rel err "
                                 f"{rel} > {tol['bounds'][m]}")
        print(f"[golden] fig4/hrs/100 net=device {m} rel_err={rel!r} "
              f"(bound {tol['bounds'][m]})")
    if r.completed_jobs != 100:
        raise AssertionError(f"net=device: {r.completed_jobs} completed")

    r = run_spec(SCENARIOS[deep["scenario"]], n_jobs=deep["n_jobs"],
                 device=dev)
    for m in exact + ("completed_jobs",):
        if getattr(r, m) != deep["metrics"][m]:
            raise AssertionError(f"deep cell: {m} {getattr(r, m)!r} != "
                                 f"{deep['metrics'][m]!r}")
    print(f"[golden] {deep['scenario']}/{deep['n_jobs']} bit-exact "
          f"avg_job_time={r.avg_job_time!r}")
    if rerate_path["net_rerate"] == 0:
        raise AssertionError("the numpy/pallas cells never launched "
                             "net_rerate")
    return rerate_path


def phase_scale(dev) -> dict:
    """The main path at full width on the card and on the CPU; returns
    the launch counts and the result of the card run."""
    import torch

    from repro_torch.core import SCENARIOS
    from repro_torch.kernels import _cuda
    from repro_torch.launch.experiments import run_spec

    spec = SCENARIOS["grid_500_saturated"]
    results = {}
    for device in (dev, torch.device("cpu")):
        _cuda.reset_launches()
        t0 = time.perf_counter()
        r = run_spec(spec, n_jobs=SCALE_JOBS, device=device)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        results[device.type] = (r, wall, dict(_cuda.LAUNCHES))
        print(f"[scale] {spec.name} jobs={SCALE_JOBS} sites={spec.n_sites} "
              f"device={device} wall_s={wall!r} "
              f"avg_job_time={r.avg_job_time!r} makespan={r.makespan!r} "
              f"avg_inter_comms={r.avg_inter_comms!r} "
              f"completed={r.completed_jobs} "
              f"flush_passes={r.net_stats['flush_passes']} "
              f"flush_slots={r.net_stats['flush_slots']} "
              f"launches={_cuda.LAUNCHES}")
    (rc, _, launches), (rh, _, host_launches) = results["cuda"], results["cpu"]
    for m in ("avg_job_time", "makespan", "avg_inter_comms",
              "completed_jobs"):
        if getattr(rc, m) != getattr(rh, m):
            raise AssertionError(f"{spec.name}: {m} on the card "
                                 f"{getattr(rc, m)!r} != on the CPU "
                                 f"{getattr(rh, m)!r}")
    if rc.completed_jobs != SCALE_JOBS:
        raise AssertionError(f"{rc.completed_jobs}/{SCALE_JOBS} completed")
    if launches["event_engine"] == 0:
        raise AssertionError("the main path never launched event_engine")
    if any(host_launches.values()):
        raise AssertionError("the CPU run launched a CUDA kernel")
    return launches, rc


def _equal_or_raise(name: str, got, want) -> float:
    """Bit-equality of two result tensors, infs in the same places;
    returns the max abs error over the finite entries (0.0)."""
    import torch

    got, want = got.double(), want.double()
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: differs from the plain version "
                             f"(max abs err {err})")
    return err


def _grid(name: str, dev, seed: int):
    """The topology of a registered scenario and a network engine on
    ``dev`` with random link occupancy."""
    import numpy as np

    from repro_torch.core import (SCENARIOS, NetworkEngine, build_topology,
                                  to_grid_config)

    cfg = to_grid_config(SCENARIOS[name])
    topo = build_topology(cfg)
    net = NetworkEngine(topo, device=dev)
    rng = np.random.default_rng(seed)
    net.link_act[:] = rng.integers(0, 30, net.n_links).astype(np.float64)
    return cfg, topo, net, rng


def plan_state(seed: int, served: bool, dev):
    """A ``grid_500_evict`` burst: 50 jobs of 25 files at random sites
    (1,250 pairs), bandwidth columns from the engine, ~5 holders per file
    (a master and replicas), and zero or nonzero serve loads."""
    import numpy as np
    import torch

    cfg, topo, net, rng = _grid("grid_500_evict", dev, seed)
    n_sites, jobs, per_job = topo.n_sites, 50, cfg.files_per_job
    dsts = np.repeat(rng.integers(0, n_sites, jobs), per_job)
    n = dsts.size
    fetch = rng.random((n_sites, n)) < 4.0 / n_sites
    fetch[rng.integers(0, n_sites, n), np.arange(n)] = True
    region = np.array([topo.region_of(s) for s in range(n_sites)])
    local = region[:, None] == region[dsts][None, :]
    serve = (rng.uniform(0.0, 3.0, n_sites) * (rng.random(n_sites) < 0.3)
             if served else np.zeros(n_sites))
    free = rng.choice([0.0, 2.5e7, 1e9], n)
    size = np.full(n, cfg.file_size)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return (net.point_bandwidth_columns(dsts), t(fetch), t(local), t(serve),
            t(free), t(size))


def st_state(scenario: str, seed: int, dev):
    """A 50-job dispatch burst of ``scenario``: the bandwidth matrix of the
    engine, ~4 holders per file, the burst's required-file union, uneven
    relative loads and a few offline sites."""
    import numpy as np
    import torch

    from repro_torch.core import generate_jobs

    cfg, topo, net, rng = _grid(scenario, dev, seed)
    n_sites = topo.n_sites
    jobs = generate_jobs(cfg, 50)
    lfns = sorted({l for j in jobs for l in j.required})
    index = {l: i for i, l in enumerate(lfns)}
    n_f = len(lfns)
    presence = rng.random((n_sites, n_f)) < 3.0 / n_sites
    presence[rng.integers(0, n_sites, n_f), np.arange(n_f)] = True
    online = rng.random(n_sites) < 0.97
    fetch = presence & online[:, None]
    required = np.zeros((len(jobs), n_f), bool)
    for j, job in enumerate(jobs):
        required[j, [index[l] for l in job.required]] = True
    rel = rng.integers(0, 50, n_sites) * 60.0
    sizes = np.full(n_f, cfg.file_size)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return (net.point_bandwidth_matrix(), t(fetch), t(presence), t(sizes),
            t(required), t(rel), t(online))


def vs_state(scenario: str, seed: int, dev):
    """The economy's value-matrix inputs at ``scenario``'s full catalog:
    decayed demand (mostly zero), ~4 holders per file and the engine's
    bandwidth matrix."""
    import numpy as np
    import torch

    cfg, topo, net, rng = _grid(scenario, dev, seed)
    n_sites, n_f = topo.n_sites, cfg.n_files
    demand = rng.exponential(2.0, (n_sites, n_f)) * \
        (rng.random((n_sites, n_f)) < 0.2)
    presence = rng.random((n_sites, n_f)) < 3.0 / n_sites
    presence[rng.integers(0, n_sites, n_f), np.arange(n_f)] = True
    sizes = np.full(n_f, cfg.file_size)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return t(demand), t(sizes), t(presence), net.point_bandwidth_matrix()


def phase_path_shape(dev, shape: dict) -> dict:
    """Both network kernels at ``grid_500_evict``'s own per-call shape
    (from phase 7's run: its slot capacity, listed slots per re-rate,
    staged rows per call rounded up)."""
    import math

    n_dirty = round(shape["dirty_per_call"])
    n_staged = max(1, math.ceil(shape["staged_per_call"]))
    print(f"[kernels] grid_500_evict per-call shape: slots={shape['slots']} "
          f"rerate_calls={shape['rerate_calls']} "
          f"dirty_per_call={shape['dirty_per_call']!r} "
          f"staged_per_call={shape['staged_per_call']!r}")
    return net_kernel_case("grid_500_evict", 3, shape["slots"], n_dirty,
                           n_staged, dev)


def phase_dense_kernels(dev) -> dict:
    """Parity and timing of strategy_plan, st_cost and value_score at
    their paths' shapes; returns per-kernel records (one per shape).
    Imports ``repro_torch`` from ``sys.path``, so an older checkout's
    ``src`` placed first is timed by the same code."""
    from repro_torch.kernels.st_cost import st_cost_kernel, st_cost_ref
    from repro_torch.kernels.strategy_plan import (strategy_plan_kernel,
                                                   strategy_plan_ref)
    from repro_torch.kernels.value_score import (value_score_kernel,
                                                 value_score_ref)

    out: dict = {}

    def record(name, shape, kern, plain, err, bytes_, flops, plain_calls,
               **extra):
        bound_ms, bound_by = roofline(bytes_, flops, FP64_FLOPS)
        r = dict(shape=shape, max_abs_err=err, ms=device_ms(kern),
                 plain_ms=device_ms(plain, rounds=5, calls=plain_calls),
                 wrapper_ms=wrapper_ms(kern),
                 plain_wrapper_ms=wrapper_ms(plain, rounds=5,
                                             calls=plain_calls, warmup=2),
                 bytes=bytes_, flops=flops, bound_ms=bound_ms,
                 bound_by=bound_by, **extra)
        out.setdefault(name, []).append(r)
        print(f"[kernels] {name} {shape} bit-equal device: "
              f"kernel={1e3 * r['ms']!r}us plain={1e3 * r['plain_ms']!r}us; "
              f"through the wrapper: kernel={1e3 * r['wrapper_ms']!r}us "
              f"plain={1e3 * r['plain_wrapper_ms']!r}us; bytes={bytes_} "
              f"flops={flops} bound={1e3 * bound_ms!r}us ({bound_by})"
              + "".join(f" {k}={v!r}" for k, v in extra.items()))

    for served in (False, True):
        a = plan_state(3 + served, served, dev)
        ks, kf = strategy_plan_kernel(*a)
        ps, pf = strategy_plan_ref(*a)
        err = max(_equal_or_raise("strategy_plan sources", ks, ps),
                  _equal_or_raise("strategy_plan flags", kf, pf))
        n_s, n_p = a[0].shape
        n_fetch = int(a[1].sum())
        # what the result depends on: fetch at every cell, bw and local
        # where fetch holds (a masked key is -1 whatever they hold), serve
        # per site; free, size, sources, flags per pair. A divide, an add
        # and two compares per fetchable cell, two compares per masked one.
        per_pair = 16 * n_p + 8 * n_p + 3 * n_p
        # beside it, the bound counted at bw, fetch and local for every
        # cell, as the first design read them
        all_cells_ms, _ = roofline(10 * n_s * n_p + 8 * n_s + per_pair,
                                   3 * n_s * n_p, FP64_FLOPS)
        record("strategy_plan", f"sites={n_s} pairs={n_p} "
               f"serve={'nonzero' if served else 'zero'}",
               lambda: strategy_plan_kernel(*a),
               lambda: strategy_plan_ref(*a), err,
               n_s * n_p + 9 * n_fetch + 8 * n_s + per_pair,
               2 * n_s * n_p + 2 * n_fetch, 10, fetchable=n_fetch,
               bound_all_cells_ms=all_cells_ms)
    for scenario in ("bulk_shortest", "grid_500"):
        a = st_state(scenario, 7, dev)
        err = _equal_or_raise("st_cost", st_cost_kernel(*a), st_cost_ref(*a))
        bw, fetch, presence, sizes, required, rel, online = a
        n_s, n_f = presence.shape
        n_j = required.shape[0]
        # a compare per (fetchable holder, site), a divide per (file,
        # site), an add per (required file, site), a max per (job, site)
        flops = (int(fetch.sum()) * n_s + n_f * n_s
                 + int(required.sum()) * n_s + n_j * n_s)
        record("st_cost", f"{scenario} sites={n_s} union={n_f} jobs={n_j}",
               lambda: st_cost_kernel(*a), lambda: st_cost_ref(*a), err,
               8 * n_s * n_s + 2 * n_s * n_f + n_j * n_f + 8 * n_f
               + 9 * n_s + 8 * n_j * n_s, flops, 2)
    for scenario in ("economy_starved", "grid_500"):
        a = vs_state(scenario, 11, dev)
        demand, sizes, presence, bw = a
        n_s, n_f = demand.shape
        for mode in ("cost", "plain"):
            err = _equal_or_raise(
                "value_score", value_score_kernel(*a, mode=mode),
                value_score_ref(*a, mode=mode))
            # a compare per (holder, site) of every file, then a compare
            # (and a divide and a multiply in cost mode) per cell
            flops = int(presence.sum()) * n_s + n_s * n_f * (
                3 if mode == "cost" else 1)
            record("value_score", f"{scenario} sites={n_s} files={n_f} "
                   f"mode={mode}",
                   lambda: value_score_kernel(*a, mode=mode),
                   lambda: value_score_ref(*a, mode=mode), err,
                   17 * n_s * n_f + 8 * n_s * n_s + 8 * n_f, flops, 2)
    return out


class watch_engines:
    """Within the block, collect every ``NetworkEngine`` made, count the
    kernel calls' packed staged rows (``NetInputs.pack``) and the flushes
    that found no active transfer (they launch nothing); yields
    ``(engines, {"calls": n, "staged": rows, "empty_flushes": m})``.
    Wraps methods of this process only; the package is unchanged."""

    def __enter__(self):
        from repro_torch.core import NetworkEngine
        from repro_torch.kernels.net_call import NetInputs

        engines, packs = [], {"calls": 0, "staged": 0, "empty_flushes": 0}
        init, pack = NetworkEngine.__init__, NetInputs.pack
        flush = NetworkEngine.flush

        def watched_init(eng, *a, **kw):
            init(eng, *a, **kw)
            engines.append(eng)

        def counted_pack(inputs, links, st_slot, *a, **kw):
            packs["calls"] += 1
            packs["staged"] += len(st_slot)
            return pack(inputs, links, st_slot, *a, **kw)

        def counted_flush(eng, now):
            packs["empty_flushes"] += eng.n_active == 0
            return flush(eng, now)

        self._saved = (NetworkEngine, init, flush, NetInputs, pack)
        NetworkEngine.__init__, NetInputs.pack = watched_init, counted_pack
        NetworkEngine.flush = counted_flush
        return engines, packs

    def __exit__(self, *exc):
        cls_e, init, flush, cls_i, pack = self._saved
        cls_e.__init__, cls_e.flush, cls_i.pack = init, flush, pack
        return False


def phase_paths(dev, shapes: dict) -> dict:
    """The slice's scenario paths on the card and on the CPU; returns the
    card run's launch counts per path, and fills ``shapes`` with each
    card run's network-call shape: slot capacity, re-rate calls, listed
    and staged slots per call."""
    import dataclasses

    import torch

    from repro_torch.core import SCENARIOS
    from repro_torch.kernels import _cuda
    from repro_torch.launch.experiments import run_spec

    launches = {}
    for name, (scenario, replace, n_jobs) in PATHS.items():
        spec = dataclasses.replace(SCENARIOS[scenario], **replace)
        results = []
        for device in (dev, torch.device("cpu")):
            with watch_engines() as seen:
                _cuda.reset_launches()
                t0 = time.perf_counter()
                r = run_spec(spec, n_jobs=n_jobs, device=device)
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
            results.append((r, dict(_cuda.LAUNCHES)))
            if device.type == "cuda":
                engines, packs = seen
                st = r.net_stats
                calls = max(1, st["rerate_calls"])
                shapes[name] = dict(
                    slots=max(e.cap for e in engines),
                    rerate_calls=st["rerate_calls"],
                    dirty_per_call=st["rerate_slots"] / calls,
                    staged_per_call=packs["staged"] / max(1,
                                                          packs["calls"]))
            print(f"[paths] {name} jobs={n_jobs} sites={spec.n_sites} "
                  f"device={device} wall_s={wall!r} "
                  f"avg_job_time={r.avg_job_time!r} makespan={r.makespan!r} "
                  f"avg_inter_comms={r.avg_inter_comms!r} "
                  f"completed={r.completed_jobs} prefetches={r.prefetches} "
                  f"launches={_cuda.LAUNCHES}")
        (rc, card), (rh, host) = results
        want = REFERENCE[name]
        for m in ("avg_job_time", "makespan", "avg_inter_comms",
                  "completed_jobs"):
            if getattr(rc, m) != getattr(rh, m):
                raise AssertionError(f"{name}: {m} on the card "
                                     f"{getattr(rc, m)!r} != on the CPU "
                                     f"{getattr(rh, m)!r}")
            if getattr(rc, m) != want[m]:
                raise AssertionError(f"{name}: {m} {getattr(rc, m)!r} != "
                                     f"the reference's {want[m]!r}")
        for k in PATH_KERNELS[name]:
            if card[k] == 0:
                raise AssertionError(f"{name} never launched {k}")
        if any(host.values()):
            raise AssertionError(f"{name}: the CPU run launched a kernel")
        launches[name] = card
    return launches


def device_trace(spec, n_jobs: int, dev) -> dict:
    """One run of ``spec`` under ``torch.profiler``: the device's busy
    time (the sum of the CUDA kernels' and copies' durations: one stream,
    so they do not overlap) against the run's wall time, the network
    kernels' launches beside the network calls, and the top device
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.experiments import run_spec

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = run_spec(spec, n_jobs=n_jobs, device=dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    # device-side rows only (kernels, copies): a host operator's row
    # repeats the device time of the kernels it launched
    dev_rows = [(e.self_device_time_total, e.key, e.count) for e in rows
                if e.device_type == DeviceType.CUDA]
    busy_s = sum(t for t, _, _ in dev_rows) / 1e6
    if busy_s <= 0.0:
        raise AssertionError(f"{spec.name}: the profiler saw no device time")
    flushes = r.net_stats["flush_passes"]
    # network kernel calls: a flush each (net="device"), else a re-rate
    net_calls = flushes or r.net_stats["rerate_calls"]
    net_kernels = sum(c for _, key, c in dev_rows if "cluster_kernel" in key)
    out = dict(jobs=n_jobs, wall_s_under_profiler=wall, device_busy_s=busy_s,
               busy_share=busy_s / wall, net_calls=net_calls,
               network_kernel_launches=net_kernels,
               device_ops=sum(c for _, _, c in dev_rows))
    print(f"[telemetry] busy {spec.name} "
          + " ".join(f"{k}={v!r}" for k, v in out.items()))
    for t, key, count in sorted(dev_rows, reverse=True)[:8]:
        print(f"[telemetry]   device {key[:60]:<60} total_us={t!r} "
              f"count={count}")
    return out


def twin_addresses(dev) -> dict:
    """A simulator deep-copied before it runs (the sanitizer's twins are
    such copies): every cached address of the copy's network engine
    (slot tensors, page-locked and device buffers, mapped result word)
    differs from the original's, and running the copy to its end leaves
    the original's slot tensors and packed buffer as they were."""
    import copy

    import torch

    from repro_torch.core import (GridConfig, GridSimulator, build_catalog,
                                  build_topology, generate_jobs)

    cfg = GridConfig(n_regions=2, sites_per_region=4)
    topo = build_topology(cfg)
    catalog = build_catalog(cfg, topo)
    sim = GridSimulator(topo, catalog, device=dev)
    for info in catalog.files.values():
        sim.storage.bootstrap(info.master_site, info.lfn)
    for j, job in enumerate(generate_jobs(cfg, 40)):
        sim.submit_job(job, at=(j // 8) * cfg.interarrival * 8)
    net = sim.network
    before = [t.clone() for t in (net.rem, net.rate, net.eta, net.due,
                                  net.active, net.path)]
    packed = net._inputs._f64.tobytes()   # uninitialised words may be NaN
    twin = copy.deepcopy(sim)
    tnet = twin.network
    ours = set(net._slots.ptrs) | {net._inputs.host_ptr, net._inputs.dev_ptr,
                                   net._inputs.word_ptr}
    theirs = set(tnet._slots.ptrs) | {tnet._inputs.host_ptr,
                                      tnet._inputs.dev_ptr,
                                      tnet._inputs.word_ptr}
    if ours & theirs or len(theirs) != 9:
        raise AssertionError(f"the twin shares addresses: {ours & theirs}")
    if tnet._slots.rem is not tnet.rem:
        raise AssertionError("the twin's slot arrays are not its tensors")
    r = twin.run()
    torch.cuda.synchronize(dev)
    after = (net.rem, net.rate, net.eta, net.due, net.active, net.path)
    if not all(torch.equal(a, b) for a, b in zip(before, after)) or \
            net._inputs._f64.tobytes() != packed:
        raise AssertionError("running the twin wrote into the original")
    if len(r.records) != 40 or tnet.stats["rerate_calls"] == 0:
        raise AssertionError(f"the twin did not run: {len(r.records)}")
    print(f"[telemetry] twin addresses distinct ({len(theirs)}), the "
          f"original untouched after the twin's {tnet.stats['rerate_calls']}"
          f" re-rates")
    return {"addresses": len(theirs),
            "twin_rerate_calls": tnet.stats["rerate_calls"]}


def probe_cost(dev, n: int = 20000) -> dict:
    """Microseconds of one empty ``obs="report"`` span on an idle card,
    with the simulator's sync (the current stream's ``synchronize``),
    with ``torch.cuda.synchronize`` of the device, and with none."""
    import functools

    import torch

    from repro_torch.obs import make_probe

    out = {}
    for label, sync in (
            ("stream_synchronize", torch.cuda.current_stream(dev).synchronize),
            ("device_synchronize", functools.partial(torch.cuda.synchronize,
                                                     dev)),
            ("none", None)):
        probe = make_probe("report", sync=sync)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            with probe.span("x"):
                pass
        out[label] = 1e6 * (time.perf_counter() - t0) / n
    print("[telemetry] us per empty span: "
          + " ".join(f"{k}={v!r}" for k, v in out.items()))
    return out


def phase_telemetry(dev, scale_result) -> dict:
    """Phase 10: the telemetry, the conservation audit and the tie-race
    sanitizer on the card, each against its CPU run; returns the card
    runs' launch counts and records."""
    import dataclasses

    import torch

    from repro_torch.analysis.conserve import (conservation_audit,
                                               run_conservation_smoke)
    from repro_torch.analysis.tierace import sanitize_smoke
    from repro_torch.core import SCENARIOS
    from repro_torch.kernels import _cuda
    from repro_torch.launch.experiments import run_spec

    cpu = torch.device("cpu")
    out: dict = {"launches": {}}
    metrics = ("avg_job_time", "makespan", "avg_inter_comms",
               "completed_jobs")
    spec = dataclasses.replace(SCENARIOS["grid_500_saturated"], obs="trace")
    traced = {}
    for device in (dev, cpu):
        with watch_engines() as (_, packs):
            _cuda.reset_launches()
            t0 = time.perf_counter()
            r = run_spec(spec, n_jobs=SCALE_JOBS, device=device)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            launches = dict(_cuda.LAUNCHES)
        traced[device.type] = (r, packs["empty_flushes"], launches)
        tel = r.telemetry
        bd = tel.phase_breakdown()
        print(f"[telemetry] {spec.name} jobs={SCALE_JOBS} obs=trace "
              f"device={device} wall_s={wall!r} tel_wall_s={tel.wall_s!r} "
              f"phases={bd} trace_events={len(tel.trace)} "
              f"samples={tel.n_samples} launches={launches}")
    (rc, empty, launches), (rh, _, host) = traced["cuda"], traced["cpu"]
    tel = rc.telemetry
    for m in metrics:
        if getattr(rc, m) != getattr(scale_result, m):
            raise AssertionError(f"obs=trace moved {m}: "
                                 f"{getattr(rc, m)!r} != phase 5's "
                                 f"{getattr(scale_result, m)!r}")
    bd = tel.phase_breakdown()
    if abs(sum(bd.values()) - tel.wall_s) > 4e-6 or bd["other_s"] < 0 or \
            sum(tel.phase_self_s.values()) > tel.wall_s:
        raise AssertionError(f"the buckets do not partition wall_s "
                             f"{tel.wall_s!r}: {bd}")
    if tel.counters != rh.telemetry.counters:
        diff = {k: (tel.counters.get(k), rh.telemetry.counters.get(k))
                for k in set(tel.counters) | set(rh.telemetry.counters)
                if tel.counters.get(k) != rh.telemetry.counters.get(k)}
        raise AssertionError(f"counters: card != CPU: {diff}")
    spans = tel.phase_calls["net.flush"]
    # a flush that finds no active transfer launches nothing
    if spans != tel.counters["net.flush_passes"] or \
            spans != launches["event_engine"] + empty:
        raise AssertionError(f"net.flush spans {spans} != event_engine "
                             f"launches {launches['event_engine']} + "
                             f"{empty} empty flushes")
    if any(host.values()):
        raise AssertionError("the CPU run launched a kernel")
    out["launches"]["grid_500_saturated obs=trace"] = launches
    out["trace"] = dict(wall_s=tel.wall_s, phases=bd,
                        phase_self_s=tel.phase_self_s,
                        phase_calls=tel.phase_calls, flush_spans=spans,
                        empty_flushes=empty)

    # phase 7's paths under obs="report": the reference's metrics still
    for name, (scenario, replace, n_jobs) in PATHS.items():
        spec = dataclasses.replace(SCENARIOS[scenario], obs="report",
                                   **replace)
        _cuda.reset_launches()
        r = run_spec(spec, n_jobs=n_jobs, device=dev)
        launches = dict(_cuda.LAUNCHES)
        bd = r.telemetry.phase_breakdown()
        print(f"[telemetry] {name} obs=report jobs={n_jobs} "
              f"tel_wall_s={r.telemetry.wall_s!r} phases={bd} "
              f"launches={launches}")
        for m in metrics:
            if getattr(r, m) != REFERENCE[name][m]:
                raise AssertionError(f"{name} obs=report: {m} "
                                     f"{getattr(r, m)!r} != the "
                                     f"reference's {REFERENCE[name][m]!r}")
        for k in PATH_KERNELS[name]:
            if launches[k] == 0:
                raise AssertionError(f"{name} obs=report never launched {k}")
        out["launches"][f"{name} obs=report"] = launches

    out["busy"] = {
        name: device_trace(dataclasses.replace(SCENARIOS[name], **rep),
                           TRACE_JOBS, dev)
        for name, rep in (("grid_500_saturated", {}),
                          ("grid_500_evict", {"strategy_mode": "batch"}))}

    audits = {}
    for device in (dev, cpu):
        _cuda.reset_launches()
        reports = run_conservation_smoke(device=device) + [
            conservation_audit("grid_500_saturated", n_jobs=SCALE_JOBS,
                               net="device", device=device)]
        audits[device.type] = (reports, dict(_cuda.LAUNCHES))
        for rep in reports:
            print(f"[telemetry] conservation {rep['scenario']} "
                  f"jobs={rep['n_jobs']} net={rep['net']} device={device} "
                  f"ok={rep['ok']} checks="
                  + ",".join(f"{k}:{c['ok']}"
                             for k, c in rep["checks"].items()))
    (card_reports, launches), (cpu_reports, host) = (audits["cuda"],
                                                     audits["cpu"])
    for rep in card_reports:
        if not rep["ok"]:
            raise AssertionError(f"conservation {rep['scenario']}: "
                                 f"{rep['checks']}")
    if card_reports != cpu_reports:
        raise AssertionError("conservation reports: card != CPU")
    for k in ("net_rerate", "event_engine", "value_score"):
        if launches[k] == 0:
            raise AssertionError(f"the conservation runs never launched {k}")
    if any(host.values()):
        raise AssertionError("the CPU audits launched a kernel")
    out["launches"]["conservation"] = launches

    sanitized = {}
    for device in (dev, cpu):
        _cuda.reset_launches()
        t0 = time.perf_counter()
        sanitized[device.type] = sanitize_smoke(device=device)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        print(f"[telemetry] sanitize_smoke device={device} wall_s={wall!r} "
              f"ties_seen={sanitized[device.type]['ties_seen']} "
              f"tie_races={len(sanitized[device.type]['tie_races'])} "
              f"launches={_cuda.LAUNCHES}")
        if device.type == "cuda":
            launches = dict(_cuda.LAUNCHES)
    if not sanitized["cuda"] == sanitized["cpu"] == SANITIZE_REFERENCE:
        raise AssertionError(f"sanitize_smoke: card {sanitized['cuda']} / "
                             f"CPU {sanitized['cpu']} / reference "
                             f"{SANITIZE_REFERENCE}")
    if launches["net_rerate"] == 0:
        raise AssertionError("sanitize_smoke never launched net_rerate")
    out["launches"]["sanitize_smoke"] = launches
    out["sanitize"] = {k: sanitized["cuda"][k] if k == "ties_seen" else
                       len(sanitized["cuda"][k])
                       for k in ("ties_seen", "tie_races")}
    out["twins"] = twin_addresses(dev)
    out["span_us"] = probe_cost(dev)
    return out


def _analysis_cli(dev) -> dict:
    """``python -m repro_torch.analysis`` (``ANALYSIS_CLI``) in a
    subprocess on the card: it must exit 0 and report no finding, no
    audit failure and every conservation check ok."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES",
                                          str(dev.index))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *ANALYSIS_CLI], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"[analysis] cli | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the analysis CLI exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    from repro_torch.kernels import _cuda

    want = ("simlint: 0 finding(s)", "units: 0 finding(s)",
            f"kernel audit (plain + cuda): {len(_cuda.KERNELS)} kernel(s), "
            "0 failure(s)")
    for w in want:
        if w not in proc.stdout:
            raise AssertionError(f"the analysis CLI did not report {w!r}")
    if "FAIL" in proc.stdout:
        raise AssertionError("the analysis CLI reported a failure")
    print(f"[analysis] cli exit 0 in wall_s={wall!r}")
    return {"argv": list(ANALYSIS_CLI[1:]), "wall_s": wall,
            "returncode": proc.returncode}


def phase_analysis(dev) -> dict:
    """Phase 11: the kernel audit's card half over every registered
    kernel, the analysis CLI on the card, the fig4 sweep cells against
    the golden file and ``experiments --all`` on the card against the
    CPU; returns the launch counts of each part and the audit's bytes."""
    import tempfile

    import torch

    from repro_torch.analysis.kernel_audit import run_kernel_audit
    from repro_torch.core import SCENARIOS
    from repro_torch.kernels import _cuda, registered_kernels
    from repro_torch.launch import experiments

    t_phase = time.perf_counter()
    out: dict = {"launches": {}}
    cpu = torch.device("cpu")
    names = list(registered_kernels())
    if sorted(names) != sorted(_cuda.KERNELS):
        raise AssertionError(f"registered kernels {names} != "
                             f"{list(_cuda.KERNELS)}")

    _cuda.reset_launches()
    t0 = time.perf_counter()
    report, failures = run_kernel_audit(device=dev)
    audit_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    if failures:
        raise AssertionError(f"kernel audit: {failures}")
    audit = {}
    for name in names:
        cuda, plain = (report["kernels"][name]["cuda"],
                       report["kernels"][name]["plain"])
        if launches[name] == 0:
            raise AssertionError(f"the audit never launched {name}")
        audit[name] = {
            "peak_bytes": cuda["peak_bytes"],
            "budget_bytes": cuda["budget_bytes"],
            "input_bytes": cuda["cases"]["audit"]["input_bytes"],
            "alloc_bytes": cuda["cases"]["audit"]["alloc_bytes"],
            "max_abs_err": max(c["max_abs_err"]
                               for c in cuda["cases"].values()),
            "parity": cuda["parity"], "host_read": cuda["host_read"],
            "wrapper_ops": cuda["cases"]["audit"]["wrapper_ops"],
            "plain_peak_op_bytes": plain["peak_op_bytes"],
            "plain_max_rank": plain["max_rank"],
            "plain_rank_and_bytes": plain["rank_and_bytes"]}
        print(f"[analysis] audit {name}: peak_bytes={cuda['peak_bytes']} "
              f"(inputs {audit[name]['input_bytes']} + allocated "
              f"{audit[name]['alloc_bytes']}) budget={cuda['budget_bytes']} "
              f"{cuda['parity']} max_abs_err={audit[name]['max_abs_err']!r}"
              f" wrapper_ops={audit[name]['wrapper_ops']} "
              f"host_read={cuda['host_read']!r}; plain: peak_op_bytes="
              f"{plain['peak_op_bytes']} max_rank={plain['max_rank']} "
              f"({plain['rank_and_bytes']})")
    print(f"[analysis] audit of {len(names)} kernels in wall_s={audit_s!r} "
          f"(build_s={report['build_s']!r}) launches={launches}")
    out["audit"], out["audit_s"] = audit, audit_s
    out["launches"]["audit"] = launches

    out["cli"] = _analysis_cli(dev)

    golden = json.load(open(os.path.join(ROOT, "tests",
                                         "golden_metrics.json")))["metrics"]
    exact = ("avg_job_time", "avg_inter_comms", "total_wan_gb", "makespan")
    _cuda.reset_launches()
    t0 = time.perf_counter()
    cells = experiments.sweep(SCENARIOS["paper_baseline"], axis="n_jobs",
                              values=(SWEEP_JOBS,),
                              strategies=SWEEP_STRATEGIES, device=dev)
    torch.cuda.synchronize(dev)
    sweep_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    for (n, strategy), r in cells.items():
        g = golden[f"fig4/{strategy}/{n}"]
        for m in exact:
            if getattr(r, m) != g[m]:
                raise AssertionError(f"sweep fig4/{strategy}/{n}: {m} "
                                     f"{getattr(r, m)!r} != {g[m]!r}")
        if r.completed_jobs != n:
            raise AssertionError(f"sweep fig4/{strategy}/{n}: "
                                 f"{r.completed_jobs} completed")
        print(f"[analysis] sweep fig4/{strategy}/{n} bit-equal to the "
              f"golden file avg_job_time={r.avg_job_time!r}")
    if launches["net_rerate"] == 0:
        raise AssertionError("the sweep cells never launched net_rerate")
    print(f"[analysis] sweep of {len(cells)} cells in wall_s={sweep_s!r} "
          f"launches={launches}")
    out["sweep_s"] = sweep_s
    out["launches"]["sweep fig4"] = launches

    metrics = ("avg_job_time_s", "makespan_s", "avg_inter_comms",
               "completed_jobs")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for device in (dev, cpu):
            path = os.path.join(tmp, f"all_{device.type}.json")
            _cuda.reset_launches()
            t0 = time.perf_counter()
            experiments.main(["--all", "--jobs", str(ALL_JOBS), "--device",
                              str(device), "--out", path])
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            runs[device.type] = (json.load(open(path)), dict(_cuda.LAUNCHES),
                                 wall)
            print(f"[analysis] --all --jobs {ALL_JOBS} device={device} "
                  f"wall_s={wall!r} launches={_cuda.LAUNCHES}")
    (card, launches, card_s), (host, host_launches, host_s) = (runs["cuda"],
                                                               runs["cpu"])
    if sorted(card["scenarios"]) != sorted(SCENARIOS) or card["sweeps"]:
        raise AssertionError(f"--all ran {sorted(card['scenarios'])} and "
                             f"sweeps {sorted(card['sweeps'])}")
    for name, entry in card["scenarios"].items():
        rows, want = entry["rows"], host["scenarios"][name]["rows"]
        for a, b in zip(rows, want, strict=True):
            for m in metrics:
                if a[m] != b[m]:
                    raise AssertionError(f"--all {name} seed {a['seed']}: "
                                         f"{m} card {a[m]!r} != CPU "
                                         f"{b[m]!r}")
    if launches["net_rerate"] == 0 or any(host_launches.values()):
        raise AssertionError(f"--all launches: card {launches}, CPU "
                             f"{host_launches}")
    print(f"[analysis] --all: {len(card['scenarios'])} scenarios equal on "
          f"the card and the CPU in {', '.join(metrics)}")
    out["all"] = {"jobs": ALL_JOBS, "scenarios": len(card["scenarios"]),
                  "card_s": card_s, "cpu_s": host_s}
    out["launches"]["--all"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[analysis] phase 11 wall_s={out['phase_s']!r}")
    return out


def roofline(bytes_: float, flops: float, peak: float,
             exps: float = 0) -> tuple[float, str]:
    """The least time of one call, in ms, and the term that sets it: the
    bytes over the memory rate, the operations over the peak rate of their
    type, or the exponentials over the special-function rate."""
    terms = {"bytes": bytes_ / HBM_BYTES_PER_S, "operations": flops / peak,
             "exponentials": exps / SFU_EXPS}
    term = max(terms, key=terms.get)
    return 1e3 * terms[term], term


def _model_record(name, kern, plain, library, err, tol, bytes_, flops,
                  peak, plain_calls, exps: float = 0, ms=None,
                  reps: dict | None = None) -> dict:
    """Times of one kernel case beside its bound; prints one line. ``ms``,
    when given, is the kernel's device time as its path sees it (the
    scan's cold decode); the time of ``kern`` replayed on the same inputs
    is then ``warm_ms``. ``reps`` (rounds, calls) replaces the default
    timing counts for the kernel and the library."""
    reps = reps or {}
    bound_ms, term = roofline(bytes_, flops, peak, exps)
    warm = device_ms(kern, **reps)
    r = dict(shape=name, max_abs_err=err, tol=tol,
             ms=warm if ms is None else ms, warm_ms=warm,
             plain_ms=device_ms(plain, rounds=3, calls=plain_calls),
             wrapper_ms=wrapper_ms(kern, **reps),
             plain_wrapper_ms=wrapper_ms(plain, rounds=3, calls=plain_calls,
                                         warmup=1),
             # eager, CUDA events around back-to-back calls: cuDNN's
             # attention allocates inside the call, which graph capture
             # refuses
             library_ms=None if library is None else wrapper_ms(library,
                                                                **reps),
             bytes=bytes_, flops=flops, exps=exps, bound_ms=bound_ms,
             bound_by=term)
    lib = ("none" if library is None
           else f"{1e3 * r['library_ms']!r}us")
    kernel = (f"kernel={1e3 * warm!r}us" if ms is None else
              f"kernel cold={1e3 * ms!r}us (warm={1e3 * warm!r}us)")
    print(f"[model-kernels] {name}: max_abs_err={err!r} (tol {tol}) device: "
          f"{kernel} plain={1e3 * r['plain_ms']!r}us; "
          f"through the wrapper: kernel={1e3 * r['wrapper_ms']!r}us "
          f"plain={1e3 * r['plain_wrapper_ms']!r}us; library={lib}; "
          f"bytes={bytes_} flops={flops} exps={exps} "
          f"bound={1e3 * bound_ms!r}us ({term})")
    return r


def _close_or_raise(name: str, got, want, tol: float) -> float:
    """``got`` within ``tol`` (atol and rtol) of ``want``; returns the max
    abs error."""
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"{name}: differs from the plain version beyond "
                             f"tol {tol} (max abs err {err})")
    return err


def _attn_case(dev, rng, name: str, dtype: str, B: int, H: int, KV: int,
               hd: int, sq: int, skv: int, causal: bool = True,
               window=None, cap=None, q_offset: int = 0, kv_len=None,
               cast: bool = False) -> dict:
    """One ``flash_attention`` case in the model's layout ((B, S, heads,
    hd) storage seen as (B, heads, S, hd); the keys an ``skv``-slot cache
    where ``kv_len`` is set): the wrapper on card tensors against its plain
    version at ``TOL``, timed beside its bound and
    ``scaled_dot_product_attention`` (non-causal where the case is). With
    ``cast``, k and v are a bf16 cache cast to float32, as a float32
    encoder-decoder decode reads its bf16 caches; the record then carries
    the casts' device time (``cast_ms``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_mask,
                                                     flash_attention_kernel,
                                                     flash_attention_ref,
                                                     plan_launch)
    from repro_torch.kernels.flash_attention.work import attention_work

    dt = getattr(torch, dtype)
    t = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s, np.float32), device=dev).to(dt)
    q = t(B, sq, H, hd).transpose(1, 2)
    k, v = t(B, skv, KV, hd).transpose(1, 2), t(B, skv, KV, hd).transpose(1, 2)
    cast_ms = None
    if cast:
        kb, vb = k.bfloat16(), v.bfloat16()
        k, v = kb.float(), vb.float()
        cast_ms = device_ms(lambda: (kb.float(), vb.float()))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset,
              kv_len=kv_len)
    plan = plan_launch(B, H, KV, sq, kv_len or skv, causal=causal,
                       window=window, q_offset=q_offset, dtype=dt)
    route = plan.route + (f" ({plan.n_split} splits of "
                          f"{plan.split_len})" if plan.n_split else "")
    err = _close_or_raise(f"flash_attention {name}",
                          flash_attention_kernel(q, k, v, **kw),
                          flash_attention_ref(q, k, v, **kw), TOL[dtype])
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len, device=dev)
    bytes_, flops = attention_work(B, H, KV, hd, sq, skv,
                                   size=q.element_size(), causal=causal,
                                   window=window, q_offset=q_offset,
                                   kv_len=kv_len)
    library = None
    if cap is None:     # no PyTorch call takes a softcap
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        if window is None and kv_len is None:
            library = lambda: F.scaled_dot_product_attention(  # noqa
                qc, kc, vc, is_causal=causal, enable_gqa=True)
        else:
            library = lambda: F.scaled_dot_product_attention(  # noqa
                qc, kc, vc, attn_mask=mask, enable_gqa=True)
    r = _model_record(
        f"flash_attention {name} B={B} H={H} KV={KV} Sq={sq} Skv={skv} "
        f"hd={hd} causal={causal} route={route}",
        lambda: flash_attention_kernel(q, k, v, **kw),
        lambda: flash_attention_ref(q, k, v, **kw), library, err,
        TOL[dtype], bytes_, flops,
        BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS, 10,
        # a float32 prefill (CUDA cores) takes up to milliseconds a call
        reps=(dict(rounds=5, calls=10)
              if dt == torch.float32 and sq > 1 else None))
    if cast:
        r["cast_ms"] = cast_ms
        print(f"[model-kernels] {name}: the float32 casts of the bf16 K/V "
              f"cache {1e3 * cast_ms!r}us a call")
    return r


def phase_model_kernels(dev) -> dict:
    """Parity and timing of flash_attention and selective_scan at the
    serving path's shapes (gemma3-1b's ``ATTN_CASES``, then the MoE
    configs' ``MOE_ATTN_CASES`` and zamba2-7b's ``ZAMBA_ATTN_CASES``);
    returns per-kernel records (one per case)."""
    import numpy as np

    out: dict = {}
    rng = np.random.default_rng(13)
    cases = ([(name, dtype, GEMMA_B, GEMMA_H, GEMMA_KV, GEMMA_HD, sq, window,
               cap, q_offset, kv_len)
              for name, dtype, sq, window, cap, q_offset, kv_len in ATTN_CASES]
             + [(name, dtype, B, H, KV, hd, sq, None, None, q_offset, kv_len)
                for name, dtype, B, H, KV, hd, sq, q_offset, kv_len
                in MOE_ATTN_CASES + ZAMBA_ATTN_CASES])
    for (name, dtype, B, H, KV, hd, sq, window, cap, q_offset,
         kv_len) in cases:
        skv = CACHE_LEN if kv_len else sq
        out.setdefault("flash_attention", []).append(_attn_case(
            dev, rng, name, dtype, B, H, KV, hd, sq, skv, window=window,
            cap=cap, q_offset=q_offset, kv_len=kv_len))
    out.update(phase_scan(dev))
    return out


def _scan_set(rng, Bz: int, S: int, Di: int, N: int, dev) -> tuple:
    """One layer's scan inputs as the model hands them over: float32
    streams, a cached state h0."""
    import numpy as np
    import torch

    n = lambda *s: rng.standard_normal(s, np.float32)  # noqa: E731
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    x, B_, C_ = t(n(Bz, S, Di)), t(n(Bz, S, N)), t(n(Bz, S, N))
    dts = t((np.log1p(np.exp(n(Bz, S, Di))) * 0.1).astype(np.float32))
    A, D, h0 = t(-np.exp(n(Di, N) * 0.3)), t(n(Di)), t(n(Bz, Di, N))
    return x, dts, B_, C_, A, D, h0


def phase_scan(dev) -> dict:
    """Parity and timing of selective_scan at falcon-mamba-7b's prefill
    and decode shapes (``SCAN_CASES``). Decode is timed cold, as serving
    meets it: the timed calls cycle over ``MAMBA_LAYERS`` input sets, one
    per layer, each call keeping its outputs, so a state row is read and
    written once per ~330 MB; the time of calls replayed on one set stays
    beside it as ``warm_ms``. Imports ``repro_torch`` from ``sys.path``,
    so an older checkout's ``src`` placed first is timed by the same
    code."""
    import numpy as np

    from repro_torch.kernels.selective_scan import (selective_scan_kernel,
                                                    selective_scan_ref)

    out = []
    rng = np.random.default_rng(13)
    Bz, Di, N = MAMBA_BZ, MAMBA_DI, MAMBA_N
    for name, S in SCAN_CASES:
        args = _scan_set(rng, Bz, S, Di, N, dev)
        (ky, kh), (py, ph) = selective_scan_kernel(*args), selective_scan_ref(*args)
        tol = 10 * TOL["float32"]
        err = max(_close_or_raise(f"selective_scan {name} y", ky, py, tol),
                  _close_or_raise(f"selective_scan {name} h", kh, ph, tol))
        bytes_, flops, exps = scan_work(Bz, S, Di, N)
        cold = None
        if S == 1:
            sets = [args] + [_scan_set(rng, Bz, S, Di, N, dev)
                             for _ in range(MAMBA_LAYERS - 1)]
            kept, turn = [], iter(range(MAMBA_LAYERS))
            # each captured call reads its own layer's set and its outputs
            # stay allocated, so no two calls of a replay share a row
            cold = device_ms(lambda: kept.append(selective_scan_kernel(
                *sets[next(turn)])), calls=MAMBA_LAYERS)
            del sets, kept
        out.append(_model_record(
            f"selective_scan {name} Bz={Bz} S={S} Di={Di} N={N}",
            lambda: selective_scan_kernel(*args),
            lambda: selective_scan_ref(*args), None, err, tol, bytes_, flops,
            FP32_FLOPS, 1, exps=exps, ms=cold))
    return {"selective_scan": out}


def _serve(arch, cfg, params, backend: str, label: str) -> dict:
    """One full-width serving run on ``params``; prints its numbers."""
    from repro_torch.launch.serve import serve

    r = serve(cfg, params, n_requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
              new_tokens=SERVE_NEW, backend=backend)
    print(f"[serve] {arch} {label} requests={SERVE_REQUESTS} "
          f"prompt={SERVE_PROMPT} new={SERVE_NEW} "
          f"prefill_ms={r['prefill_ms']!r} "
          f"decode_ms_per_token={r['decode_ms_per_token']!r} "
          f"tokens_per_s={r['tokens_per_s']!r} peak_bytes={r['peak_bytes']} "
          f"sites={r['sites']} inter_comms={r['inter_comms']} "
          f"wan_bytes={r['wan_bytes']!r} lan_bytes={r['lan_bytes']!r}")
    return r


def to_f32(tree):
    """A parameter tree's leaves in float32 (new tensors)."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(v) for v in tree]
    return tree.float()


def hold_served(arch: str, k: dict, p: dict, k32: dict, p32: dict,
                atol32: float = SERVE_TOL_F32,
                rtol32: float = SERVE_TOL_F32) -> tuple:
    """Phase 9's rules between a kernel run and a plain run, each with
    ``tokens`` (B, n) and the ``logits`` (B, n, V) each was the argmax of,
    in bf16 as served (``k``, ``p``) and with the same weights in float32
    (``k32``, ``p32``): the first step's float32 logits within ``atol32``
    + ``rtol32`` x |logit| (``SERVE_TOL_F32`` both) and the bf16 ones
    within twice the bf16 noise (how far the plain route's bf16 logits lie
    from its float32 ones), the greedy tokens by ``greedy_agreement`` at
    each tolerance. Returns (err32, held32, err, tol, noise, held); raises
    on a breach."""
    import torch

    from repro_torch.serve.engine import greedy_agreement

    # float32: a wrong mask, index or layout moves logits by ~1e-1;
    # float32 rounding over the depth stays far below SERVE_TOL_F32
    got, want = k32["logits"][:, 0].float(), p32["logits"][:, 0].float()
    err32 = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=atol32, rtol=rtol32):
        raise AssertionError(f"{arch} f32 prefill logits: kernel route off "
                             f"the plain route by {err32} (atol {atol32}, "
                             f"rtol {rtol32})")
    held32 = greedy_agreement(k32["tokens"], p32["tokens"], p32["logits"],
                              atol=atol32, rtol=rtol32)
    # bf16 as served: the kernel route may differ from the plain route
    # by twice what bf16 rounding moves the plain route off its float32
    # result (the noise of the served dtype itself)
    noise = float((p["logits"][:, 0] - p32["logits"][:, 0]).abs().max())
    tol = 2 * noise
    err = float((k["logits"][:, 0] - p["logits"][:, 0]).abs().max())
    if not err <= tol:
        raise AssertionError(f"{arch} bf16 prefill logits: kernel route "
                             f"off the plain route by {err} > {tol} "
                             f"(2 x the bf16 noise {noise})")
    held = greedy_agreement(k["tokens"], p["tokens"], p["logits"],
                            atol=tol, rtol=0.0)
    return err32, held32, err, tol, noise, held


def phase_serve(dev) -> dict:
    """Each model of ``SERVE`` at full width (at the depth of
    ``SERVE_LAYERS`` where it names one) through the router and the
    engine, on the kernels and on the plain route, in bf16 as served and
    with the same weights in float32; for a MoE model also the routes
    that differ between the bf16 routes (:func:`route_flips`); returns
    the bf16 kernel runs' records."""
    import torch

    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M

    out = {}
    for arch, kernel in SERVE:
        cfg = get_config(arch)
        if arch in SERVE_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS[arch])
        t_arch = t0 = time.perf_counter()
        params = M.init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        for backend in ("auto", "plain"):   # warm-up at the served shape
            serve(cfg, params, n_requests=SERVE_REQUESTS,
                  prompt_len=SERVE_PROMPT, new_tokens=2, backend=backend)
        _cuda.reset_launches()                     # the main path
        k = _serve(arch, cfg, params, "auto", "bf16 kernels")
        launches = dict(_cuda.LAUNCHES)
        _cuda.reset_launches()
        p = _serve(arch, cfg, params, "plain", "bf16 plain")
        plain_launches = dict(_cuda.LAUNCHES)
        layers = kernel_layers(cfg, kernel)
        want = layers * (1 + SERVE_NEW)
        others = {n: c for n, c in launches.items() if n != kernel and c}
        if launches[kernel] != want or others or any(plain_launches.values()):
            raise AssertionError(
                f"{arch}: launches {launches} (want {kernel} = {want} and no "
                f"other), plain route {plain_launches} (want none)")
        logits = k["logits"]
        if logits.shape != (SERVE_REQUESTS, SERVE_NEW, cfg.vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: logits {tuple(logits.shape)} not "
                                 "finite or of the wrong shape")
        if k["sites"] != p["sites"] or k["tokens"].shape != (SERVE_REQUESTS,
                                                             SERVE_NEW):
            raise AssertionError(f"{arch}: sites or token shapes differ")
        params32 = to_f32(params)
        k32 = _serve(arch, cfg, params32, "auto", "f32 kernels")
        p32 = _serve(arch, cfg, params32, "plain", "f32 plain")
        vision = (phase_vlm_prefill(cfg, params, params32, dev)
                  if cfg.vision_tokens else None)
        del params32
        err32, held32, err, tol, noise, held = hold_served(arch, k, p, k32,
                                                           p32)
        equal = int((k["tokens"] == p["tokens"]).sum())
        flips = split = None
        if cfg.moe is not None:
            # the routes of both bf16 runs, recorded in untimed repeats
            routes = {}
            for backend in ("auto", "plain"):
                with watch_routes() as w:
                    serve(cfg, params, n_requests=SERVE_REQUESTS,
                          prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW,
                          backend=backend)
                routes[backend] = w.calls
            flips = route_flips(routes["auto"], routes["plain"])
            del routes
            print(f"[serve] {arch} bf16 routes kernels vs plain (a route is "
                  f"a (token, layer); decode after the first differing "
                  f"token sees other inputs): {flips}")
        if cfg.moe is not None or "mamba2" in cfg.layer_pattern:
            split = serve_split(cfg, params, dev, k)
        print(f"[serve] {arch} params={cfg.param_count()} init_s={init_s!r} "
              f"f32 prefill logits max_abs_err={err32!r} (tol "
              f"{SERVE_TOL_F32}), tokens held={held32}; bf16 prefill logits "
              f"max_abs_err={err!r} (tol {tol!r} = 2 x bf16 noise "
              f"{noise!r}), tokens held={held}, equal={equal}/"
              f"{k['tokens'].size}; {kernel} launches={launches[kernel]} "
              f"(= {layers} of {cfg.n_layers} layers x {1 + SERVE_NEW} "
              f"steps); wall_s={time.perf_counter() - t_arch!r}")
        out[arch] = dict(kernel=kernel, launches=launches[kernel],
                         logit_err=err, logit_tol=tol, logit_err_f32=err32,
                         held=held, held_f32=held32, route_flips=flips,
                         profiled=split, vision_prefill=vision,
                         **{m: k[m] for m in ("prefill_ms",
                                              "decode_ms_per_token",
                                              "tokens_per_s", "peak_bytes")},
                         plain={m: p[m] for m in ("prefill_ms",
                                                  "decode_ms_per_token",
                                                  "tokens_per_s")})
        del params, k, p, k32, p32, logits
        torch.cuda.empty_cache()
    return out


def serve_split(cfg, params, dev, timed: dict, calls: int = 2) -> dict:
    """A bf16 prefill of ``SERVE_REQUESTS`` x ``SERVE_PROMPT`` tokens and
    one decode step after it on the kernels, each ``calls`` times under the
    profiler: device busy ms a call by family (:func:`step_families`) and
    its share of the unprofiled run's prefill ms and decode ms a token
    (``timed``, from :func:`_serve`; the profiler slows the host, and
    reading back its trace takes seconds a call at zamba2-7b's 81 layers,
    hence two calls)."""
    import numpy as np
    import torch

    from repro_torch.models import model as M

    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT)), device=dev)
    caches = M.init_caches(cfg, SERVE_REQUESTS, SERVE_PROMPT + SERVE_NEW,
                           device=dev)
    steps = {
        "prefill": (lambda: M.prefill(cfg, params, tokens, caches=caches,
                                      backend="auto"),
                    timed["prefill_ms"]),
        "decode": (lambda: M.decode_step(cfg, params, caches, tokens[:, -1:],
                                         SERVE_PROMPT, backend="auto"),
                   timed["decode_ms_per_token"])}
    out = {}
    for part, (fn, ms) in steps.items():
        by_name, wall, scoped = device_split(fn, calls=calls,
                                             scopes=(MOE_SCOPE, SSD_SCOPE))
        family_ms = {k: v / 1e3 / calls
                     for k, v in step_families(by_name, scoped[MOE_SCOPE],
                                               scoped[SSD_SCOPE]).items()}
        busy = sum(family_ms.values())
        out[part] = {"profiled_wall_ms": wall, "busy_ms": busy,
                     "busy_share_of_timed": busy / ms,
                     "family_ms": family_ms}
        print(f"[serve] {cfg.name} bf16 kernels {part} profiled ({calls} "
              f"calls): wall_ms={wall!r} device busy ms={busy!r}, "
              f"{100 * busy / ms!r}% of the timed run's {ms!r} ms; by "
              f"family (ms): {family_ms}")
    del caches
    return out


def device_split(fn, calls: int = 20, scopes: tuple = ()
                 ) -> tuple[dict, float, dict]:
    """``calls`` back-to-back ``fn()`` calls under ``torch.profiler``
    after a warm-up: each device operation's name with ``(total µs,
    launches)`` as the trace recorded them (it may drop some, so divide by
    the launches it saw, not by ``calls``), the wall ms per call (host
    clock, ended by a sync), and for each ``record_function`` range named
    in ``scopes`` the device µs by name of the operations launched inside
    it (:func:`scoped_device_us`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    # a record_function range (the model's moe_ffn and train_segment) is
    # also a device row spanning the kernels inside it: not work of its own
    ranges = {e.name for e in events if e.is_user_annotation}
    by_name: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.key not in ranges:
            us, n = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (us + e.self_device_time_total, n + e.count)
    scoped = {scope: scoped_device_us(events, scope) for scope in scopes}
    return by_name, 1e3 * wall / calls, scoped


def scoped_device_us(events, scope: str) -> dict:
    """Device µs by name of the operations launched inside the
    ``record_function`` range ``scope``: by an operator under it (the
    forward, and its recompute under remat) or by the backward of such an
    operator (the autograd node that carries its sequence number). Another
    range met first on the way up (the model's ``train_segment``, around a
    recompute that some backward node triggered) marks a forward operator
    outside the scope."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]

    def under(e) -> bool:
        while e is not None and e.name != scope:
            e = e.cpu_parent
        return e is not None

    keys = {(e.thread, e.sequence_nr) for e in cpu
            if e.sequence_nr >= 0 and under(e)}

    def inside(e) -> bool:
        while e is not None:
            if e.name == scope:
                return True
            if e.is_user_annotation:
                return False
            if e.name.startswith("autograd::engine::evaluate_function"):
                return (e.fwd_thread, e.sequence_nr) in keys
            e = e.cpu_parent
        return False

    ranges = {e.name for e in cpu if e.is_user_annotation}
    out: dict = {}
    for e in cpu:
        if e.kernels and inside(e):
            for k in e.kernels:
                if k.name not in ranges:
                    out[k.name] = out.get(k.name, 0.0) + k.duration
    return out


#: device operations of a training step, by family (first match wins);
#: the ``ssd`` family is what the hand-written kernels' families do not
#: take inside Mamba-2's chunk range (``SSD_SCOPE``), its products
#: included; the ``moe`` family is what no pattern takes inside the MoE
#: feed-forward's profiler range (``MOE_SCOPE``): routing, dispatch,
#: combine and the experts' activation, forward and backward
STEP_FAMILIES = (
    ("flash_attention_bwd", ("dkdv_kernel", "dq_kernel", "delta_kernel",
                             "dkdv_f32_kernel", "dq_f32_kernel",
                             "delta_f32_kernel")),
    ("flash_attention", ("flash_kernel",)),
    ("selective_scan_bwd", ("scan_bwd_kernel", "scan_bwd_sum_kernel")),
    ("selective_scan", ("scan_kernel",)),
    ("gemm", ("gemm", "Gemm", "nvjet", "sm90_", "cutlass", "xmma",
              "cublas")),
    ("copy", ("Memcpy", "Memset")),
)
#: the families of the hand-written kernels, which no range takes from
KERNEL_FAMILIES = ("flash_attention_bwd", "flash_attention",
                   "selective_scan_bwd", "selective_scan")
#: the ``record_function`` range of ``repro_torch.models.moe.moe_ffn``
MOE_SCOPE = "moe_ffn"
#: the ``record_function`` range of Mamba-2's SSD chunk work
#: (``repro_torch.models.mamba.SSD_SCOPE``)
SSD_SCOPE = "ssd"


def step_families(by_name: dict, scoped: dict,
                  ssd: dict | None = None) -> dict:
    """Device µs by family of one profiled call: ``STEP_FAMILIES``;
    ``ssd``: the device µs inside ``SSD_SCOPE`` (``ssd``, by name) that
    the hand-written kernels' families do not take, GEMMs and copies
    included; ``moe``: the rest of ``scoped``, the device µs inside
    ``MOE_SCOPE``; ``other``: elementwise, reductions and indexing
    elsewhere."""
    ssd = ssd or {}
    out = {name: 0.0 for name, _ in STEP_FAMILIES}
    out["ssd"] = out["moe"] = out["other"] = 0.0
    for key, (us, _) in by_name.items():
        fam = next((name for name, pats in STEP_FAMILIES
                    if any(p in key for p in pats)), None)
        if fam not in KERNEL_FAMILIES:
            chunk = min(us, ssd.get(key, 0.0))
            out["ssd"] += chunk
            us -= chunk
        if fam is None:
            moe = min(us, scoped.get(key, 0.0))
            out["moe"] += moe
            out["other"] += us - moe
        else:
            out[fam] += us
    return out


def sdpa_backend(by_name: dict) -> str:
    """Which ``scaled_dot_product_attention`` backend ran, read from the
    names of the device operations its calls launched."""
    names = " ".join(by_name)
    for backend, pats in (("cudnn", ("cudnn",)),
                          ("flash", ("pytorch_flash", "flash_fwd",
                                     "flash_bwd")),
                          ("efficient", ("fmha", "cutlassF", "cutlassB",
                                         "mem_efficient")),
                          ("math", ("softmax", "SoftMax"))):
        if any(p in names for p in pats):
            return backend
    return "unknown"


def split_ms(by_name: dict, calls: int) -> float:
    """Device ms of one call: every device operation the trace of
    ``calls`` calls recorded, summed and divided by ``calls`` (a lower
    bound if the trace dropped some)."""
    return sum(us for us, _ in by_name.values()) / 1e3 / calls


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def kernel_layers(cfg, kernel: str) -> int:
    """The layers of ``cfg`` that launch ``kernel`` once a step: the
    attention kinds (each application of zamba2-7b's shared block among
    them) for the flash attention kernels, ``mamba1`` for the scan's;
    ``mamba2`` (plain PyTorch) launches none. The encoder-decoder's
    attention calls: one an encoder layer, two (self, cross) a decoder
    layer."""
    from repro_torch.models.transformer import ATTN_KINDS

    if cfg.enc_dec:
        return (cfg.n_encoder_layers + 2 * cfg.n_layers
                if kernel.startswith("flash_attention") else 0)
    kinds = ATTN_KINDS if kernel.startswith("flash_attention") else (
        "mamba1",)
    return sum(kind in kinds for kind in list(cfg.layer_pattern)
               * cfg.n_groups + list(cfg.remainder_pattern))


def phase_train_kernels(dev, cases=BWD_CASES, phase: str = "12 (a)"
                        ) -> dict:
    """Phase 12 (a) (and 14 (a), 15 (a), 17 (a) at ``MOE_BWD_CASES``,
    ``ZAMBA_BWD_CASES``, ``ENCDEC_BWD_CASES``): the flash attention
    backward at the training path's shapes (``cases``; a case of nine
    fields is causal with Skv = S, a case of eleven gives causal and Skv).
    The forward with lse is held to its plain version at ``TOL``: its
    output, its float32 output and lse; the backward reads that float32
    output, as the training path's ``FlashAttentionFn`` hands it over. A
    bf16 case is
    held against the float32 plain backward within twice the plain bf16
    route's own error against it, and against the plain version on the
    same inputs within ``TOL["bfloat16"]``; a float32 case (the CUDA-core
    route) against the plain version on the same inputs within
    ``TOL["float32"]``; both bit-equal over two calls. Times of the
    forward with lse and of the backward beside the bound and
    ``scaled_dot_product_attention``'s forward + backward, by the
    profiler's kernel sum."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_mask,
                                                     flash_attention_kernel,
                                                     flash_attention_lse_ref)
    from repro_torch.kernels.flash_attention.work import attention_bwd_work
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_kernel, flash_attention_bwd_ref)

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(17)
    out = []
    for case in cases:
        name, dtype, B, H, KV, S, hd, window, cap = case[:9]
        causal, Skv = case[9:] if len(case) > 9 else (True, S)
        dt = getattr(torch, dtype)
        bf16 = dt == torch.bfloat16
        # the model's layout: (B, S, heads, hd) storage seen as (B, heads,
        # S, hd)
        t = lambda n, s=S: torch.tensor(  # noqa: E731
            rng.standard_normal((B, s, n, hd), np.float32),
            device=dev).to(dt).transpose(1, 2)
        q, k, v, do = t(H), t(KV, Skv), t(KV, Skv), t(H)
        kw = dict(causal=causal, window=window, softcap=cap)
        f32 = [x.float() for x in (q, k, v, do)]
        o32, lse32, _ = flash_attention_lse_ref(*f32[:3], **kw)
        want = flash_attention_bwd_ref(*f32[:3], o32, lse32, f32[3], **kw)
        ob, lseb, o_p = flash_attention_lse_ref(q, k, v, **kw)
        ok_, lse_k, o_k = flash_attention_kernel(q, k, v, with_lse=True,
                                                 **kw)
        fwd_err = max(_close_or_raise(f"flash_attention {name} {dtype}", a,
                                      b_, TOL[dtype])
                      for a, b_ in ((ok_, ob), (o_k, o_p)))
        got = flash_attention_bwd_kernel(q, k, v, o_k, lse_k, do, **kw)
        # no float atomics: a second call on the same inputs is bit-equal
        again = flash_attention_bwd_kernel(q, k, v, o_k, lse_k, do, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {name} {dtype}: two "
                                 "calls on the same inputs differ")
        del again
        # the plain version on the very same inputs (in bf16 it rounds P
        # and dS to bf16 where the kernel does)
        same = flash_attention_bwd_ref(q, k, v, o_k, lse_k, do, **kw)
        same_errs = {label: _close_or_raise(
            f"flash_attention_bwd {name} {dtype} {label}", g, p_,
            TOL[dtype]) for label, g, p_ in zip(("dq", "dk", "dv"), got,
                                                 same)}
        same_err = max(same_errs.values())
        del same
        torch.cuda.synchronize(dev)
        lse_err = float((lse_k - lse32).abs().max())
        if bf16 and not lse_err <= TOL["bfloat16"]:
            raise AssertionError(f"flash_attention lse {name}: {lse_err} > "
                                 f"{TOL['bfloat16']}")
        if not bf16:
            _close_or_raise(f"flash_attention lse {name} {dtype}", lse_k,
                            lse32, TOL[dtype])
        if bf16:
            plain = flash_attention_bwd_ref(q, k, v, o_p, lseb, do, **kw)
            errors, tols = {}, {}
            for label, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
                noise = float((p.float() - w).abs().max())
                err = float((g.float() - w).abs().max())
                errors[label], tols[label] = err, 2 * noise
                if not err <= 2 * noise:
                    raise AssertionError(
                        f"flash_attention_bwd {name} {label}: max abs err "
                        f"{err} > 2 x the plain bf16 route's {noise}")
            del plain
        else:
            # float32: the plain version on the same inputs is the exact
            # gradient to float32 rounding
            errors = same_errs
            tols = {label: TOL[dtype] for label in errors}
        del f32, o32, want, got
        mask = attention_mask(S, Skv, causal=causal, window=window,
                              q_offset=0, kv_len=None, device=dev)
        # q, do, dq and k, v, dk, dv once each in their dtype, o and lse in
        # float32; bf16 products on the tensor cores, float32 ones on the
        # CUDA cores
        bytes_, flops = attention_bwd_work(
            B, H, KV, hd, S, Skv, size=q.element_size(),
            o_size=o_k.element_size(), causal=causal, window=window)
        bound_ms, term = roofline(bytes_, flops,
                                  BF16_FLOPS if bf16 else FP32_FLOPS)
        # the float32 route takes milliseconds a call: fewer timed calls
        reps = dict(rounds=ROUNDS, calls=CALLS) if bf16 else dict(rounds=5,
                                                                  calls=10)
        fwd = lambda: flash_attention_kernel(  # noqa: E731
            q, k, v, with_lse=True, **kw)
        kern = lambda: flash_attention_bwd_kernel(  # noqa: E731
            q, k, v, o_k, lse_k, do, **kw)
        plain_fn = lambda: flash_attention_bwd_ref(  # noqa: E731
            q, k, v, o_p, lseb, do, **kw)
        library = None
        if cap is None:     # no PyTorch call takes a softcap
            leaves = [x.contiguous().requires_grad_() for x in (q, k, v)]
            doc = do.contiguous()
            sdpa_kw = (dict(is_causal=causal) if window is None
                       else dict(attn_mask=mask))

            def library():
                o = F.scaled_dot_product_attention(*leaves, enable_gqa=True,
                                                   **sdpa_kw)
                torch.autograd.grad(o, leaves, doc)
        split = device_split(kern)[0]
        # forward + backward on both sides timed the same way: the device
        # operations of 20 calls under the profiler
        both = lambda: (fwd(), kern())  # noqa: E731
        fwd_bwd_ms = split_ms(device_split(both)[0], 20)
        lib_split = None if library is None else device_split(library)[0]
        r = dict(shape=f"flash_attention_bwd {name}"
                       f"{'' if bf16 else ' float32'} B={B} H={H} KV={KV} "
                       f"S={S} hd={hd} window={window} softcap={cap}"
                       + ("" if len(case) == 9 else
                          f" Skv={Skv} causal={causal}"),
                 dtype=dtype,
                 # µs a launch of each of the three kernels, and the
                 # launches the trace recorded of the 20 calls
                 split_us={k.replace("(anonymous namespace)::", "")
                           .split("(")[0].split("<")[0]: (us / n, n)
                           for k, (us, n) in split.items()},
                 errors=errors, tolerances=tols,
                 max_abs_err=max(errors.values()), lse_err=lse_err,
                 same_inputs_err=same_err, fwd_err=fwd_err,
                 lse_ms=device_ms(fwd), ms=device_ms(kern, **reps),
                 plain_ms=device_ms(plain_fn, rounds=3, calls=2),
                 wrapper_ms=wrapper_ms(kern, warmup=3, **reps),
                 plain_wrapper_ms=wrapper_ms(plain_fn, rounds=3, calls=2,
                                             warmup=1),
                 fwd_bwd_ms=fwd_bwd_ms,
                 library_ms=None if library is None else split_ms(lib_split,
                                                                  20),
                 library_wrapper_ms=None if library is None else wrapper_ms(
                     library, rounds=5, calls=10, warmup=3),
                 library_backend=None if library is None
                 else sdpa_backend(lib_split),
                 # the library's backward kernels alone (cuDNN's bprop)
                 library_bwd_ms=None if library is None else split_ms(
                     {k_: v_ for k_, v_ in lib_split.items()
                      if "bprop" in k_ or "bwd" in k_.lower()}, 20),
                 library_top=None if library is None else [
                     (k[:70], us / 20) for k, (us, _) in sorted(
                         lib_split.items(), key=lambda kv: -kv[1][0])[:4]],
                 bytes=bytes_, flops=flops, bound_ms=bound_ms, bound_by=term)
        lib = ("none" if library is None
               else f"{1e3 * r['library_ms']!r}us device, its backward "
                    f"kernels alone {1e3 * r['library_bwd_ms']!r}us ("
                    f"{r['library_backend']} backend; heaviest, us a call: "
                    f"{r['library_top']}), "
                    f"{1e3 * r['library_wrapper_ms']!r}us eager")
        held = ("vs float32 (tol 2 x plain bf16 route's" if bf16 else
                "vs the plain version on the same inputs (tol")
        print(f"[train-kernels] {r['shape']}: errors {held}: {tols}) "
              f"{errors} lse_err={lse_err!r}; "
              f"against the plain version on the same inputs: max abs err "
              f"{same_err!r} (within atol = rtol = {TOL[dtype]}); "
              f"forward output against its plain version {fwd_err!r}; "
              f"two calls bit-equal; "
              f"device: forward+lse={1e3 * r['lse_ms']!r}us "
              f"backward={1e3 * r['ms']!r}us plain backward="
              f"{1e3 * r['plain_ms']!r}us; through the wrapper: backward="
              f"{1e3 * r['wrapper_ms']!r}us plain={1e3 * r['plain_wrapper_ms']!r}"
              f"us; device by the profiler (20 calls): forward+lse+backward="
              f"{1e3 * fwd_bwd_ms!r}us, sdpa fwd+bwd={lib}; flops={flops!r} bytes={bytes_} "
              f"bound={1e3 * bound_ms!r}us ({term}); by kernel (profiler: "
              f"us a launch, launches recorded of 20 calls): "
              f"{r['split_us']}")
        out.append(r)
        del q, k, v, do, ob, lseb, ok_, lse_k, mask, o_k, o_p
        torch.cuda.empty_cache()
    print(f"[train-kernels] phase {phase} wall_s="
          f"{time.perf_counter() - t_phase!r}")
    return {"flash_attention_bwd": out}


def start_first_scan_bwd() -> tuple:
    """Start ``nvcc`` on the first version of ``selective_scan_bwd``
    (``SCAN_BWD_FIRST``, the current one's flags) into
    ``build/kernels/scan_bwd_first``; returns the process and the
    library's path."""
    from repro_torch.kernels import _cuda

    out = _cuda.BUILD_DIR / "scan_bwd_first"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libselective_scan_bwd.so"
    cmd = [_cuda._nvcc(), *_cuda.nvcc_flags("selective_scan_bwd"), "-I",
           SCAN_BWD_FIRST, "-o", str(lib),
           os.path.join(SCAN_BWD_FIRST, "selective_scan_bwd.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def load_first_scan_bwd(started: tuple) -> tuple:
    """Wait for :func:`start_first_scan_bwd`'s build; returns its C entry
    point (the current one's signature), its library and the build log.
    Raises if it failed."""
    import ctypes

    from repro_torch.kernels import _cuda

    proc, lib = started
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the first selective_scan_bwd failed to build\n"
                           f"{log}")
    symbol, argtypes = _cuda._SIGNATURES["selective_scan_bwd"]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn, lib, log


def phase_scan_bwd_occupancy(dev) -> dict:
    """Phase 2: the reverse walk's resident blocks an SM, in both dtypes,
    for the N = 16 vector build (the training shape's) and the masked one;
    raises below ``BLOCKS_PER_SM``."""
    import torch

    from repro_torch.kernels.selective_scan_bwd.kernel import (
        BLOCKS_PER_SM, THREADS, resident_blocks)

    out = {}
    for dtype in SCAN_BWD_DTYPES:
        for full in (True, False):
            n = resident_blocks(getattr(torch, dtype), full, dev)
            key = f"{dtype} {'N=16' if full else 'masked'}"
            out[key] = n
            print(f"[build] selective_scan_bwd {key}: {n} resident blocks "
                  f"an SM ({n * THREADS // 32} warps)")
    if min(out.values()) < BLOCKS_PER_SM:
        raise AssertionError(f"selective_scan_bwd: fewer than "
                             f"{BLOCKS_PER_SM} resident blocks an SM: {out}")
    return out


def phase_train_mamba_kernels(dev, first=None) -> dict:
    """Phase 13 (a): the scan's backward at falcon-mamba-7b's shape in
    float32 and bf16 (``SCAN_BWD_DTYPES``), from a seed with a nonzero h0
    and dh_last: the forward with round states bit-equal in y and h_last
    to the forward without; every gradient against the plain backward on
    the card on the same inputs within ``10 x TOL`` (float32) or ``TOL``
    (bf16) of the output's largest entry; two calls bit-equal; device and
    wrapper times of the forward with and without states and of the
    backward, the plain backward's device time and the bound. With
    ``first`` (the first version's C entry point), the backward and the
    first version in turns on the same inputs: first, current, current,
    first."""
    import numpy as np
    import torch

    from repro_torch.kernels import _cuda
    from repro_torch.kernels.selective_scan import (round_states,
                                                    selective_scan_kernel)
    from repro_torch.kernels.selective_scan_bwd import (
        selective_scan_bwd_kernel, selective_scan_bwd_ref)

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(19)
    Bz, S, Di, N = MAMBA_BZ, TRAIN_S, MAMBA_DI, MAMBA_N
    out = []
    for dtype in SCAN_BWD_DTYPES:
        dt_ = getattr(torch, dtype)
        x, dts, B_, C_, A, D, h0 = _scan_set(rng, Bz, S, Di, N, dev)
        args = (x.to(dt_), dts.to(dt_), B_.to(dt_), C_.to(dt_), A, D, h0)
        dy = torch.tensor(rng.standard_normal((Bz, S, Di), np.float32),
                          device=dev).to(dt_)
        dh_last = torch.tensor(rng.standard_normal((Bz, Di, N), np.float32),
                               device=dev)
        y0, hl0 = selective_scan_kernel(*args)
        states = round_states(args[0], h0)
        y, hl = selective_scan_kernel(*args, states)
        if not (torch.equal(y, y0) and torch.equal(hl, hl0)):
            raise AssertionError(f"selective_scan {dtype}: the forward with "
                                 "states differs from the one without")
        del y0, hl0, y, hl
        got = selective_scan_bwd_kernel(*args, states, dy, dh_last)
        again = selective_scan_bwd_kernel(*args, states, dy, dh_last)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"selective_scan_bwd {dtype}: two calls on "
                                 "the same inputs differ")
        del again
        want = selective_scan_bwd_ref(*args, states, dy, dh_last)
        tol = 10 * TOL["float32"] if dtype == "float32" else TOL[dtype]
        errors = {}
        for label, g, w in zip(("dx", "ddt", "dB", "dC", "dA", "dD", "dh0"),
                               got, want):
            g, w = g.float(), w.float()
            scale = float(w.abs().max())
            err = float((g - w).abs().max())
            errors[label] = err / scale
            if not torch.allclose(g, w, rtol=tol, atol=tol * scale):
                raise AssertionError(
                    f"selective_scan_bwd {dtype} {label}: max abs err {err} "
                    f"beyond tol {tol} of the largest entry {scale}")
        del got, want
        torch.cuda.synchronize(dev)
        size = args[0].element_size()
        bytes_, flops, exps = scan_bwd_work(Bz, S, Di, N, size)
        bound_ms, term = roofline(bytes_, flops, FP32_FLOPS, exps)
        kern = lambda: selective_scan_bwd_kernel(  # noqa: E731
            *args, states, dy, dh_last)
        plain = lambda: selective_scan_bwd_ref(  # noqa: E731
            *args, states, dy, dh_last)
        split = device_split(kern)[0]
        turns = []
        if first is not None:
            current = _cuda.entry_point("selective_scan_bwd")
            try:
                for label in ("first", "current", "current", "first"):
                    _cuda._loaded["selective_scan_bwd"] = (
                        first if label == "first" else current)
                    turns.append((label, device_ms(kern, calls=10)))
            finally:
                _cuda._loaded["selective_scan_bwd"] = current
        r = dict(shape=f"selective_scan_bwd {dtype} Bz={Bz} S={S} Di={Di} "
                       f"N={N}",
                 max_abs_err=max(errors.values()), errors=errors, tol=tol,
                 fwd_ms=device_ms(lambda: selective_scan_kernel(*args)),
                 fwd_states_ms=device_ms(
                     lambda: selective_scan_kernel(*args, states)),
                 ms=device_ms(kern, calls=10),
                 wrapper_ms=wrapper_ms(kern, calls=10, warmup=3),
                 fwd_states_wrapper_ms=wrapper_ms(
                     lambda: selective_scan_kernel(*args, states)),
                 plain_ms=device_ms(plain, rounds=3, calls=1),
                 plain_wrapper_ms=wrapper_ms(plain, rounds=3, calls=1,
                                             warmup=1),
                 # µs a launch of each kernel, the launches the profiler
                 # recorded of 20 calls
                 split_us={k.replace("(anonymous namespace)::", "")
                           .split("(")[0].split("<")[0]: (us / n, n)
                           for k, (us, n) in split.items()},
                 turns_ms=turns,
                 first_ms=[ms for label, ms in turns if label == "first"],
                 library_ms=None, bytes=bytes_, flops=flops, exps=exps,
                 bound_ms=bound_ms, bound_by=term)
        print(f"[train-mamba-kernels] {r['shape']}: errors relative to each "
              f"output's largest entry {errors} (tol {tol}); forward with "
              f"states bit-equal in y and h_last; two backward calls "
              f"bit-equal; device: forward={1e3 * r['fwd_ms']!r}us forward "
              f"with states={1e3 * r['fwd_states_ms']!r}us backward="
              f"{1e3 * r['ms']!r}us plain backward={1e3 * r['plain_ms']!r}us; "
              f"through the wrapper: backward={1e3 * r['wrapper_ms']!r}us "
              f"forward with states={1e3 * r['fwd_states_wrapper_ms']!r}us "
              f"plain={1e3 * r['plain_wrapper_ms']!r}us; library=none; "
              f"bytes={bytes_} flops={flops} exps={exps} "
              f"bound={1e3 * bound_ms!r}us ({term}); by kernel (profiler: "
              f"us a launch, launches recorded of 20 calls): "
              f"{r['split_us']}; in turns with the first version (us): "
              f"{[(k, 1e3 * v) for k, v in turns]}")
        out.append(r)
        del args, x, dts, B_, C_, A, D, h0, dy, dh_last, states
        torch.cuda.empty_cache()
    print(f"[train-mamba-kernels] phase 13 (a) wall_s="
          f"{time.perf_counter() - t_phase!r}")
    return {"selective_scan_bwd": out}


def phase_train(dev) -> dict:
    """Phase 12 (b): gemma3-1b at full width and depth through
    ``repro_torch.launch.train``'s functions (:func:`_train_run`):
    ``flash_attention`` twice a layer a step (remat recomputes it) and
    ``flash_attention_bwd`` once."""
    from repro_torch.configs import get_config

    return _train_run(dev, get_config("gemma3-1b"), "12 (b)",
                      ("flash_attention", "flash_attention_bwd"))


def phase_train_mamba(dev) -> dict:
    """Phase 13 (b): falcon-mamba-7b at full width, its depth cut from 64
    to ``MAMBA_TRAIN_LAYERS`` (``dataclasses.replace``), through
    ``repro_torch.launch.train``'s functions (:func:`_train_run`):
    ``selective_scan`` twice a layer a step (remat recomputes it; the
    second run saves the round states) and ``selective_scan_bwd`` once."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              n_layers=MAMBA_TRAIN_LAYERS)
    return _train_run(dev, cfg, "13 (b)",
                      ("selective_scan", "selective_scan_bwd"))


def _train_run(dev, cfg, phase: str, kernels: tuple, seq: int = TRAIN_S,
               embeds=None, tol_f32: float | None = None,
               vs_f32: bool = False) -> dict:
    """A full-width training run on ``TRAIN_B`` rows of ``seq`` tokens
    (``launch.train.family_batch``: for the encoder-decoder ``seq``
    frames and ``seq // 8`` decoder tokens, for a VLM the patch
    embeddings; ``embeds`` the frames or patch embeddings, else the
    reference's ones): the first step on the kernels against
    ``backend="plain"`` (and the plain route in float32; with ``tol_f32``
    also the kernels against the plain route in float32, held within it,
    which a MoE config does at ``TRAIN_TOL`` since bf16 routing flips move
    some leaves as far as bf16 itself does), then ``TRAIN_STEPS`` steps on
    a repeated batch under the supervisor; the forward kernel of
    ``kernels`` must launch twice an attention call a step, the backward
    once, nothing else. With ``vs_f32`` each bf16 leaf of the kernel route
    is held within twice the plain bf16 route's distance from float32, by
    its own distance from float32 (phase 9's rule for bf16 logits), not
    against the plain bf16 route. Returns step times, memory, the launches
    of the steps and one profiled step by family."""
    import tempfile

    import torch

    from repro_torch.checkpoint.ckpt import _leaf_paths
    from repro_torch.fault.failures import TrainingSupervisor
    from repro_torch.kernels import _cuda
    from repro_torch.launch import train as launch_train
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_step import grad_fn

    fwd_name, bwd_name = kernels
    layers = kernel_layers(cfg, fwd_name)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = launch_train.build(cfg, batch=TRAIN_B, seq=seq,
                             steps=TRAIN_STEPS, device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    batch, _ = run["loader"].next_batch()
    b = launch_train.family_batch(cfg, batch, device=dev, embeds=embeds)
    tokens = TRAIN_B * seq    # a row's positions (whisper: its frames)
    params = run.pop("params")

    # the first step's loss and gradients: kernels, plain, plain in float32
    # (each loss read as it comes); for a MoE config the routes of both
    # bf16 runs are recorded
    moe = cfg.moe is not None
    if moe and tol_f32 is None:
        tol_f32 = TRAIN_TOL
    hold_f32 = tol_f32 is not None
    routes, nll = {}, {}
    with contextlib.ExitStack() as watching:
        if moe:
            routes["auto"] = watching.enter_context(watch_routes()).calls
        nll["kernels"] = watching.enter_context(watch_nll())
        _cuda.reset_launches()
        lk, mk, gk = grad_fn(cfg, run["tcfg"], params, b, backend="auto")
        lk = float(lk)
        hold_launches = dict(_cuda.LAUNCHES)
    with contextlib.ExitStack() as watching:
        if moe:
            routes["plain"] = watching.enter_context(watch_routes()).calls
        nll["plain"] = watching.enter_context(watch_nll())
        lp, mp, gp = grad_fn(cfg, run["tcfg"], params, b, backend="plain")
        lp = float(lp)
    if hold_launches[bwd_name] != layers or any(
            _cuda.LAUNCHES[n] != c for n, c in hold_launches.items()):
        raise AssertionError(f"first step launches {hold_launches}, plain "
                             f"route {_cuda.LAUNCHES}")
    p32 = tree_map(lambda t: t.float(), params)
    with watch_nll() as nll["plain f32"]:
        l32, m32, g32 = grad_fn(cfg, run["tcfg"], p32, b, backend="plain")
    l32 = float(l32)
    if hold_f32:
        # the first step also in float32, kernels against plain: the
        # float32 backward runs (and routes rarely flip)
        _cuda.reset_launches()
        with watch_nll() as nll["kernels f32"]:
            lk32, mk32, gk32 = grad_fn(cfg, run["tcfg"], p32, b,
                                       backend="auto")
        lk32 = float(lk32)
        if _cuda.LAUNCHES[bwd_name] != layers:
            raise AssertionError(f"float32 first step launches "
                                 f"{dict(_cuda.LAUNCHES)}")
    del p32
    paths = [path for path, _ in _leaf_paths(gp)]
    names = ["/".join(path) for path in paths]
    err = [_rel_l2(a, c) for a, c in zip(tree_leaves(gk), tree_leaves(gp))]
    noise = [_rel_l2(a, c) for a, c in zip(tree_leaves(gp), tree_leaves(g32))]
    held = err
    if vs_f32:
        held = [_rel_l2(a, c) for a, c in zip(tree_leaves(gk),
                                               tree_leaves(g32))]
    loss_err = abs(lk - lp) / abs(lp)
    # a MoE config's load-balancing probe (group 0's first router)
    aux_err = (abs(float(mk["moe_aux"]) - float(mp["moe_aux"]))
               / abs(float(mp["moe_aux"])) if moe else None)
    tols = [TRAIN_TOL] * len(err)
    flipped: dict = {}
    if moe:
        # top-k routes flip between the bf16 routes and move the leaves
        # the flipped tokens' gradients pass through as far as bf16
        # rounding itself does: in a layer whose routes differ, its
        # feed-forward's leaves (router, experts) and the norm before it
        # (ln2) are held within TRAIN_TOL or twice the plain route's own
        # bf16 distance from float32, whichever is larger (phase 9's rule
        # for bf16 logits); every other leaf stays at TRAIN_TOL
        by_ptr = flips_by_router(routes["auto"], routes["plain"])
        blocks = {tuple(path[:-2]): by_ptr.get(leaf.data_ptr(), 0)
                  for path, leaf in _leaf_paths(params)
                  if path[-2:] == ("moe", "router")}
        flipped = {"/".join(blk): n for blk, n in blocks.items() if n}
        for i, path in enumerate(paths):
            blk = next((blk for blk in blocks
                        if path[:len(blk)] == blk), None)
            if (blk is not None and blocks[blk]
                    and path[len(blk)] in ("moe", "ln2")):
                tols[i] = max(TRAIN_TOL, 2 * noise[i])
        del routes
    if vs_f32:
        tols = [2 * n for n in noise]
    moved = [i for i, t in enumerate(tols) if t > TRAIN_TOL]
    worst = max(range(len(held)), key=lambda i: held[i] / tols[i])
    rest = [i for i, t in enumerate(tols) if t == TRAIN_TOL]
    print(f"[train] {cfg.name} full width, {cfg.n_layers} layers, params="
          f"{sum(t.numel() for t in tree_leaves(params))} init_s={init_s!r} "
          f"first step: loss kernels={lk!r} plain={lp!r} "
          f"plain f32={l32!r} rel err={loss_err!r}; gradient leaves "
          f"{len(err)}: max rel L2 kernels vs plain={max(err)!r} "
          f"({names[max(range(len(err)), key=err.__getitem__)]}), "
          f"median={statistics.median(err)!r}; plain bf16 "
          f"vs f32: max={max(noise)!r} median={statistics.median(noise)!r} "
          f"(tol {TRAIN_TOL})"
          + ("" if not vs_f32 else
             f"; each leaf held by its kernels vs f32 distance within 2 x "
             f"the plain bf16 route's: kernels vs f32 max={max(held)!r} "
             f"median={statistics.median(held)!r}, closest to its limit "
             f"{names[worst]} {held[worst]!r} of {tols[worst]!r}, smallest "
             f"limit {min(tols)!r}")
          + ("" if not moe else
             f"; moe_aux kernels={float(mk['moe_aux'])!r} plain="
             f"{float(mp['moe_aux'])!r} rel err={aux_err!r}; tokens whose "
             f"routes differ between the bf16 routes, by layer: {flipped}; "
             f"leaves at TRAIN_TOL: {len(rest)}, max rel L2 "
             f"{max(err[i] for i in rest)!r}; leaves held to 2 x the plain "
             f"bf16 route's distance from f32 (kernels vs plain, tol): "
             f"{ {names[i]: (err[i], tols[i]) for i in moved} }"))
    print(f"[train] {cfg.name} first step, the loss's parts by route "
          "(the final hidden state's and the head's dtypes, the summed "
          "token NLL over its count): "
          + "; ".join(f"{route} {w.summary()}" for route, w in nll.items())
          + f"; loss kernels={lk!r} plain={lp!r} plain f32={l32!r}")
    ok = (loss_err <= TRAIN_TOL and held[worst] <= tols[worst]
          and (aux_err is None or aux_err <= TRAIN_TOL))
    first32 = None
    if hold_f32:
        err32 = [_rel_l2(a, c) for a, c in zip(tree_leaves(gk32),
                                               tree_leaves(g32))]
        loss_err32 = abs(lk32 - l32) / abs(l32)
        aux_err32 = (abs(float(mk32["moe_aux"]) - float(m32["moe_aux"]))
                     / abs(float(m32["moe_aux"])) if moe else 0.0)
        worst32 = max(range(len(err32)), key=err32.__getitem__)
        first32 = {"loss_rel_err": loss_err32, "moe_aux_rel_err": aux_err32,
                   "max_leaf_rel_l2": err32[worst32],
                   "max_leaf": names[worst32],
                   "median_leaf_rel_l2": statistics.median(err32)}
        print(f"[train] {cfg.name} first step in float32: loss kernels="
              f"{lk32!r} plain={l32!r} rel err="
              f"{loss_err32!r}; moe_aux rel err={aux_err32!r}; gradient "
              f"leaves: max rel L2 kernels vs plain={err32[worst32]!r} "
              f"({names[worst32]}), median={statistics.median(err32)!r} "
              f"(tol {tol_f32})")
        ok = ok and max(loss_err32, aux_err32, err32[worst32]) <= tol_f32
        del gk32
    if not ok:
        raise AssertionError(f"first step: loss rel err {loss_err}, moe_aux "
                             f"rel err {aux_err}, leaf {names[worst]} rel "
                             f"L2 {held[worst]} (tol {tols[worst]}), float32 "
                             f"{first32} (tol {tol_f32})")
    del gk, gp, g32
    torch.cuda.empty_cache()

    # TRAIN_STEPS steps on the repeated batch, no checkpoint written
    step_fn = launch_train.make_step_fn(run["train_step"],
                                        lambda: (batch, None), dev, cfg=cfg,
                                        embeds=embeds)
    times = []

    def timed(state, i):
        t1 = time.perf_counter()
        result = step_fn(state, i)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t1)
        return result

    state = (params, run.pop("opt"))
    del params
    with tempfile.TemporaryDirectory() as tmp:
        sup = TrainingSupervisor(timed, tmp, ckpt_every=TRAIN_STEPS + 1)
        torch.cuda.reset_peak_memory_stats(dev)
        _cuda.reset_launches()                     # the main path
        state, hist = sup.run(state, TRAIN_STEPS)
        launches = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        written = os.listdir(tmp)
    # a step past the supervisor's deadline (4 x the median so far) is
    # run again on the same state, so it launches its kernels twice
    runs = TRAIN_STEPS + sup.stats.stragglers_mitigated
    losses = [h["loss"] for h in hist]
    step_s = statistics.median(times)
    fwd, bwd = launches[fwd_name], launches[bwd_name]
    others = {n: c for n, c in launches.items()
              if c and n not in (fwd_name, bwd_name)}
    print(f"[train] {cfg.name} {TRAIN_STEPS} steps B={TRAIN_B} S={seq}"
          + (f" (frames; {b['tokens'].shape[1]} decoder tokens)"
             if cfg.enc_dec else "") + ": "
          f"losses {losses} step_ms median={1e3 * step_s!r} (all "
          f"{[1e3 * x for x in times]}) tokens_per_s="
          f"{tokens / step_s!r} max_memory_allocated={peak} "
          f"{fwd_name} launches per step={fwd / runs!r} "
          f"{bwd_name} per step={bwd / runs!r} (step runs {runs}: "
          f"{sup.stats.stragglers_mitigated} re-issued past the deadline)")
    if not losses[-1] < losses[0] or not all(map(math.isfinite, losses)):
        raise AssertionError(f"the loss did not fall: {losses}")
    if (fwd != 2 * layers * runs
            or bwd != layers * runs or others or written):
        raise AssertionError(f"training launches {launches} over {runs} "
                             f"step runs (want {fwd_name} 2 x {layers} and "
                             f"{bwd_name} {layers} per step run, "
                             f"nothing else), checkpoints {written}")
    # one more step under torch.profiler: device time by family
    carry = [state]

    def one_step():
        carry[0] = step_fn(carry[0], TRAIN_STEPS)[0]

    by_name, prof_ms, scopes = device_split(one_step, calls=1,
                                            scopes=(MOE_SCOPE, SSD_SCOPE))
    scoped = scopes[MOE_SCOPE]
    families = step_families(by_name, scoped, scopes[SSD_SCOPE])
    busy = sum(families.values()) / 1e3
    top = sorted(((k, us) for k, (us, _) in by_name.items()),
                 key=lambda kv: -kv[1])[:12]
    moe_top = sorted(scoped.items(), key=lambda kv: -kv[1])[:8]
    ssd_top = sorted(scopes[SSD_SCOPE].items(), key=lambda kv: -kv[1])[:8]
    # the profiler slows the host, so the busy share is taken against the
    # median step without it
    share = busy / (1e3 * step_s)
    print(f"[train] {cfg.name} profiled step: wall_ms={prof_ms!r} device "
          f"busy ms={busy!r}, {100 * share!r}% of the median unprofiled step "
          f"({1e3 * step_s!r} ms); by family (ms): "
          f"{ {k: v / 1e3 for k, v in families.items()} }; heaviest "
          f"device operations (ms): "
          f"{ {k[:60]: v / 1e3 for k, v in top} }"
          + ("" if not scoped else
             f"; heaviest inside {MOE_SCOPE} (ms): "
             f"{ {k[:60]: v / 1e3 for k, v in moe_top} }")
          + ("" if not ssd_top else
             f"; heaviest inside {SSD_SCOPE} (ms): "
             f"{ {k[:60]: v / 1e3 for k, v in ssd_top} }"))
    del state, carry
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[train] phase {phase} wall_s={wall!r}")
    return {"arch": cfg.name, "layers": cfg.n_layers, "launches": launches,
            "step_runs": runs,
            "losses": losses, "step_ms": 1e3 * step_s,
            "step_ms_all": [1e3 * x for x in times],
            "tokens_per_s": tokens / step_s, "peak_bytes": peak,
            "first_step": {"loss_rel_err": loss_err,
                           "moe_aux_rel_err": aux_err,
                           "leaves_held_to_twice_bf16_noise": {
                               names[i]: (err[i], tols[i]) for i in moved},
                           "flipped_tokens_by_layer": flipped,
                           "float32": first32,
                           "max_leaf_rel_l2": err[worst],
                           "median_leaf_rel_l2": statistics.median(err),
                           "plain_bf16_vs_f32_max": max(noise),
                           "plain_bf16_vs_f32_median":
                               statistics.median(noise),
                           "tol": TRAIN_TOL},
            "profiled_step": {"wall_ms": prof_ms, "busy_ms": busy,
                              "busy_share_of_median_step": share,
                              "family_ms": {k: v / 1e3
                                            for k, v in families.items()},
                              "top_ms": {k[:60]: v / 1e3 for k, v in top},
                              "moe_top_ms": {k[:60]: v / 1e3
                                             for k, v in moe_top},
                              "ssd_top_ms": {k[:60]: v / 1e3
                                             for k, v in ssd_top}},
            "init_s": init_s, "phase_s": wall}


def phase_supervisor(dev) -> dict:
    """Phase 12 (c): the reduced gemma3-1b on the card under the
    supervisor, a checkpoint every 4 steps and a failure at step 6 (the
    reference's ``test_training_with_failures_recovers``): one restart,
    the loss below its start, the step-4 checkpoint restoring bit-equal
    to the state it saved."""
    import tempfile

    import torch

    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.fault.failures import FailurePlan, TrainingSupervisor
    from repro_torch.kernels import _cuda
    from repro_torch.launch import train as launch_train
    from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
    from repro_torch.train.train_step import TrainConfig, make_train_step

    t_phase = time.perf_counter()
    cfg = get_config("gemma3-1b").reduced()
    run = launch_train.build(cfg, batch=4, seq=64, steps=60, device=dev)
    step = make_train_step(cfg, TrainConfig(opt=OptimizerConfig(
        peak_lr=2e-3, warmup_steps=2, total_steps=60)))
    step_fn = launch_train.make_step_fn(step, run["loader"].next_batch, dev)
    saved = {}

    def keep(state, i):
        result = step_fn(state, i)
        if i + 1 == 4 and 4 not in saved:
            saved[4] = [t.detach().cpu().clone()
                        for t in tree_leaves(result[0])]
        return result

    bits = lambda t: (t.view(torch.int16)  # noqa: E731
                      if t.dtype == torch.bfloat16 else t)
    with tempfile.TemporaryDirectory() as tmp:
        sup = TrainingSupervisor(keep, tmp, ckpt_every=4,
                                 plan=FailurePlan(fail_at_steps=(6,)))
        _cuda.reset_launches()
        state, hist = sup.run((run["params"], run["opt"]), 24)
        launches = dict(_cuda.LAUNCHES)
        restored, _ = restore_checkpoint(tmp, 4, like=state, device=dev)
    same = [a.device == dev and a.dtype == b.dtype
            and torch.equal(bits(a.cpu()), bits(b))
            for a, b in zip(tree_leaves(restored), saved[4])]
    losses = [h["loss"] for h in hist]
    st = sup.stats
    print(f"[supervisor] reduced gemma3-1b on the card: restarts="
          f"{st.restarts} steps_run={st.steps_run} steps_wasted="
          f"{st.steps_wasted} first loss={losses[0]!r} last 6 min="
          f"{min(losses[-6:])!r}; step-4 checkpoint bit-equal: "
          f"{sum(same)}/{len(same)} leaves; launches={launches}")
    if (st.restarts != 1 or len(hist) < 24 or not all(same)
            or not min(losses[-6:]) < losses[0] - 0.15
            or not launches["flash_attention_bwd"]):
        raise AssertionError(f"supervisor: {st}, losses {losses}, "
                             f"bit-equal {sum(same)}/{len(same)}, "
                             f"launches {launches}")
    return {"restarts": st.restarts, "steps_run": st.steps_run,
            "steps_wasted": st.steps_wasted, "losses": losses,
            "restored_bit_equal_leaves": sum(same), "leaves": len(same),
            "launches": launches, "phase_s": time.perf_counter() - t_phase}


class watch_routes:
    """Records every MoE routing (``repro_torch.models.moe.route``) made
    inside the block: per call (one a MoE layer a step, and one more a
    layer where remat recomputes it), the chosen and the kept experts of
    each token as (B, S, E) masks, each token's top-k gap (the k-th
    largest router logit less the (k+1)-th), and the address of the
    router's storage (which names the layer)."""

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self._moe, self._route, self.calls = moe, moe.route, []

        def spy(x, router, *, top_k, C):
            r = self._route(x, router, top_k=top_k, C=C)
            logits, idx = r["logits"], r["idx"]
            kept = r["keep"].gather(1, torch.argsort(r["order"], dim=-1))
            chosen = torch.zeros(logits.shape, dtype=torch.uint8,
                                 device=x.device)
            kept_mask = chosen.clone().scatter_(
                2, idx, kept.view(idx.shape).to(torch.uint8))
            chosen.scatter_(2, idx, 1)
            top = torch.sort(logits, dim=-1, descending=True).values
            gap = (top[..., top_k - 1] - top[..., top_k]
                   if top_k < logits.shape[-1]
                   else torch.full(idx.shape[:2], math.inf, device=x.device))
            self.calls.append((chosen, kept_mask, gap, router.data_ptr()))
            return r

        moe.route = spy
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route
        return False


class watch_nll:
    """Records each cross-entropy chunk a forward computes
    (``repro_torch.models.model._chunk_nll``; not remat's recompute in
    the backward): the hidden state's and the head's dtypes, the chunk's
    summed token NLL (float32) and its token count."""

    def __enter__(self):
        from repro_torch.models import model

        self._model, self._fn, self.calls = model, model._chunk_nll, []

        def spy(h, labels, head, cap):
            out = self._fn(h, labels, head, cap)
            if not in_backward():
                self.calls.append((str(h.dtype), str(head.dtype),
                                   out.detach(), labels.numel()))
            return out

        model._chunk_nll = spy
        return self

    def __exit__(self, *exc):
        self._model._chunk_nll = self._fn
        return False

    def summary(self) -> str:
        if not self.calls:
            return "no chunk"
        dtypes = sorted({(h, w) for h, w, _, _ in self.calls})
        total = sum(float(c[2]) for c in self.calls)
        tokens = sum(c[3] for c in self.calls)
        return (f"hidden/head {dtypes}, {len(self.calls)} chunks, NLL "
                f"{total / tokens!r}")


def in_backward() -> bool:
    """True while autograd runs a backward (where remat recomputes a
    checkpointed forward)."""
    import torch

    return torch._C._current_graph_task_id() >= 0


def route_flips(calls_a: list, calls_b: list) -> dict:
    """(token, layer) routes of two runs of the same inputs, prefill
    (S > 1) and decode apart: how many chose other experts, how many kept
    other experts (the capacity line), and the smallest top-k gap of run b
    among those that chose others."""
    if len(calls_a) != len(calls_b):
        raise AssertionError(f"routings: {len(calls_a)} against "
                             f"{len(calls_b)}")
    out = {}
    for part in ("prefill", "decode"):
        n = chosen = kept = 0
        gaps = []
        for (ca, ka, *_), (cb, kb, gb, _) in zip(calls_a, calls_b):
            if ca.shape != cb.shape:
                raise AssertionError(f"routing shapes {tuple(ca.shape)} "
                                     f"against {tuple(cb.shape)}")
            if (ca.shape[1] > 1) != (part == "prefill"):
                continue
            other = (ca != cb).any(-1)
            n += other.numel()
            chosen += int(other.sum())
            kept += int((ka != kb).any(-1).sum())
            if bool(other.any()):
                gaps.append(float(gb[other].min()))
        out[part] = {"routes": n, "chose_other_experts": chosen,
                     "kept_other_experts": kept,
                     "min_gap_of_flipped": min(gaps) if gaps else None}
    return out


def flips_by_router(calls_a: list, calls_b: list) -> dict:
    """Tokens whose chosen or kept experts differ between two runs of the
    same inputs, by router storage address (one a MoE layer), counted at
    each layer's first routing (the forward; a remat recompute repeats
    it)."""
    out: dict = {}
    for (ca, ka, _, ptr), (cb, kb, *_) in zip(calls_a, calls_b):
        if ptr not in out:
            out[ptr] = int(((ca != cb).any(-1) | (ka != kb).any(-1)).sum())
    return out


def phase_train_zamba(dev) -> dict:
    """Phase 15 (c): zamba2-7b at full width, its depth cut from 81 to
    ``ZAMBA_TRAIN_LAYERS`` (``dataclasses.replace``), through
    ``repro_torch.launch.train``'s functions (:func:`_train_run`): the
    shared attention block's two applications launch ``flash_attention``
    twice each a step (remat recomputes it) and ``flash_attention_bwd``
    once each; the 16 mamba2 blocks launch no kernel. The profiled step's
    ``ssd`` family is Mamba-2's chunk work (``SSD_SCOPE``)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("zamba2-7b"),
                              n_layers=ZAMBA_TRAIN_LAYERS)
    return _train_run(dev, cfg, "15 (c)",
                      ("flash_attention", "flash_attention_bwd"))


def phase_train_moe(dev) -> dict:
    """Phase 14 (c): granite-moe-1b-a400m at full width and depth through
    ``repro_torch.launch.train``'s functions (:func:`_train_run`):
    ``flash_attention`` twice a layer a step and ``flash_attention_bwd``
    once, the first step's ``moe_aux`` and router gradients held with the
    rest."""
    from repro_torch.configs import get_config

    return _train_run(dev, get_config("granite-moe-1b-a400m"), "14 (c)",
                      ("flash_attention", "flash_attention_bwd"))


def phase_train_whisper(dev) -> dict:
    """Phase 17 (b): whisper-large-v3 at full width and depth (32 encoder
    and 32 decoder layers, seed 0) through ``repro_torch.launch.train``'s
    functions (:func:`_train_run`): ``TRAIN_B`` rows of
    ``WHISPER_TRAIN_FRAMES`` frame embeddings from the seed (as phase 16
    (b)'s requests) and 187 decoder tokens. Each of the 96 attention calls
    (the encoder's, the decoder's self- and cross-attention) launches
    ``flash_attention`` twice a step (remat recomputes it) and
    ``flash_attention_bwd`` once; the first step is held in bf16 against
    the plain route within ``TRAIN_TOL``, and in float32 within
    ``TRAIN_TOL_F32``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(WHISPER)
    frames = torch.tensor(np.random.default_rng(0).standard_normal(
        (TRAIN_B, WHISPER_TRAIN_FRAMES, cfg.d_model), np.float32),
        device=dev).bfloat16()
    return _train_run(dev, cfg, "17 (b)",
                      ("flash_attention", "flash_attention_bwd"),
                      seq=WHISPER_TRAIN_FRAMES, embeds=frames,
                      tol_f32=TRAIN_TOL_F32)


def phase_train_vlm(dev) -> dict:
    """Phase 17 (c): internvl2-2b at full width and depth through
    ``repro_torch.launch.train``'s functions (:func:`_train_run`):
    ``TRAIN_B`` x ``TRAIN_S`` tokens whose first 256 positions carry patch
    embeddings from the seed (N(0, ``VLM_PATCH_SCALE``^2), as phase 16
    (c)); ``flash_attention`` twice a layer a step and
    ``flash_attention_bwd`` once; the first step also in float32, within
    ``TRAIN_TOL_F32``. At this width the bf16 routes' own distance from
    float32 is TRAIN_TOL's size (the plain route's leaves lie a median
    4.4%, at most 5.9%, from float32 on an H100; PERF.md), so each bf16
    leaf of the kernel route is held by its distance from float32, within
    twice the plain bf16 route's (phase 9's rule)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    cfg = get_config("internvl2-2b")
    vision = torch.tensor(np.random.default_rng(0).standard_normal(
        (TRAIN_B, cfg.vision_tokens, cfg.d_model), np.float32)
        * VLM_PATCH_SCALE, device=dev)
    return _train_run(dev, cfg, "17 (c)",
                      ("flash_attention", "flash_attention_bwd"),
                      embeds=vision, tol_f32=TRAIN_TOL_F32, vs_f32=True)


def phase_arctic(dev) -> dict:
    """Phase 14 (d): arctic-480b at full width, its depth cut to
    ``ARCTIC_LAYERS`` (``dataclasses.replace``): one prefill of
    ``SERVE_REQUESTS`` x ``SERVE_PROMPT`` tokens on the kernels and on the
    plain route, in bf16 and then with the same weights in float32
    (converted in place, one leaf at a time: both copies do not fit). The
    float32 last-position logits agree within ``SERVE_TOL_F32``; the bf16
    ones within twice the plain bf16 route's own distance from the float32
    plain route (relative L2), as phase 9 holds bf16 logits;
    ``flash_attention`` once a layer on each kernel run and nothing on the
    plain ones; two bf16 prefills bit-equal; prefill ms, peak device memory
    and the routing flips between the bf16 routes."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import tree_leaves

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = dataclasses.replace(get_config("arctic-480b"),
                              n_layers=ARCTIC_LAYERS)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT)), device=dev)
    B, S = tokens.shape

    def prefill(backend):
        caches = M.init_caches(cfg, B, S, device=dev,
                               dtype=params["embed"].dtype)
        return M.prefill(cfg, params, tokens, caches=caches,
                         backend=backend)[0]

    def timed(backend):
        prefill(backend)                 # warm-up at the shape, uncounted
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _cuda.reset_launches()                       # the main path
        t0 = time.perf_counter()
        logits = prefill(backend)
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {n: c for n, c in _cuda.LAUNCHES.items() if c}
        want = {"flash_attention": cfg.n_layers} if backend == "auto" else {}
        if launches != want:
            raise AssertionError(f"arctic-480b {backend} launches {launches} "
                                 f"(want {want})")
        if logits.shape != (B, 1, cfg.vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"arctic-480b logits {tuple(logits.shape)}"
                                 " not finite or of the wrong shape")
        return dict(logits=logits, ms=ms, launches=launches,
                    peak=torch.cuda.max_memory_allocated(dev))

    runs = {}
    for backend in ("auto", "plain"):
        runs[backend] = timed(backend)
        with watch_routes() as w:
            again = prefill(backend)
        if not torch.equal(again, runs[backend]["logits"]):
            raise AssertionError(f"arctic-480b {backend}: two prefills "
                                 "differ")
        runs[backend]["routes"] = w.calls
    k, p = runs["auto"], runs["plain"]
    flips = route_flips(k["routes"], p["routes"])
    # the same weights in float32, one leaf at a time
    stack = [params]
    while stack:
        node = stack.pop()
        for key, val in (node.items() if isinstance(node, dict)
                         else enumerate(node)):
            if isinstance(val, (dict, list)):
                stack.append(val)
            else:
                node[key] = val.float()
                del val
                torch.cuda.empty_cache()
    k32, p32 = timed("auto"), timed("plain")
    err32 = _close_or_raise("arctic-480b f32 prefill logits", k32["logits"],
                            p32["logits"], SERVE_TOL_F32)
    noise = _rel_l2(p["logits"], p32["logits"])
    tol = 2 * noise
    rel = _rel_l2(k["logits"], p["logits"])
    err = float((k["logits"].float() - p["logits"].float()).abs().max())
    print(f"[arctic] arctic-480b full width, {cfg.n_layers} of 35 layers, "
          f"params={n_params} init_s={init_s!r} init peak={init_peak}; "
          f"prefill {B} x {S}: bf16 kernels {k['ms']!r} ms (peak "
          f"{k['peak']}), bf16 plain {p['ms']!r} ms (peak {p['peak']}), "
          f"f32 kernels {k32['ms']!r} ms (peak {k32['peak']}), f32 plain "
          f"{p32['ms']!r} ms (peak {p32['peak']}); f32 last logits max abs "
          f"err={err32!r} (tol {SERVE_TOL_F32}); bf16 last logits rel L2="
          f"{rel!r} (tol {tol!r} = 2 x the plain bf16 route's rel L2 from "
          f"f32 {noise!r}), max abs err={err!r}; routes kernels vs plain: "
          f"{flips['prefill']}; flash_attention launches {cfg.n_layers} a "
          f"kernel run")
    if not rel <= tol:
        raise AssertionError(f"arctic-480b bf16 prefill logits rel L2 {rel} "
                             f"> {tol} (2 x the bf16 noise {noise})")
    record = {"arch": cfg.name, "layers": cfg.n_layers,
              "launches": k["launches"]["flash_attention"],
              "launches_f32": k32["launches"]["flash_attention"],
              "logits_rel_l2": rel,
              "logits_max_abs_err": err, "tol": tol, "bf16_noise": noise,
              "logits_err_f32": err32, "tol_f32": SERVE_TOL_F32,
              "prefill_ms": k["ms"], "plain_prefill_ms": p["ms"],
              "prefill_ms_f32": k32["ms"], "plain_prefill_ms_f32": p32["ms"],
              "peak_bytes": k["peak"], "plain_peak_bytes": p["peak"],
              "peak_bytes_f32": k32["peak"], "init_s": init_s,
              "init_peak_bytes": init_peak, "route_flips": flips}
    del params, stack, runs, k, p, k32, p32
    torch.cuda.empty_cache()
    record["phase_s"] = time.perf_counter() - t_phase
    print(f"[arctic] phase 14 (d) wall_s={record['phase_s']!r}")
    return record


def phase_encdec_kernels(dev) -> list:
    """Phase 16 (a): ``flash_attention`` at the encoder-decoder's and the
    VLM's calls (``ENCDEC_ATTN_CASES``), each against its plain version at
    ``TOL`` and timed as phase 8's cases."""
    import numpy as np

    rng = np.random.default_rng(16)
    return [_attn_case(dev, rng, name, dtype, B, H, KV, hd, sq, skv,
                       causal=causal, q_offset=q_offset, kv_len=kv_len,
                       cast=cast)
            for (name, dtype, B, H, KV, hd, sq, skv, causal, q_offset, kv_len,
                 cast) in ENCDEC_ATTN_CASES]


def _serve_encdec(cfg, params, frames, backend: str, label: str) -> dict:
    """One greedy run of the encoder-decoder (``generate_encdec``: the
    prefill, then ``SERVE_NEW`` decode steps) on ``frames``; prints its
    numbers."""
    import torch

    from repro_torch.serve.engine import generate_encdec

    dev = frames.device
    torch.cuda.reset_peak_memory_stats(dev)
    r = generate_encdec(cfg, params, frames, SERVE_NEW, backend=backend)
    B = frames.shape[0]
    r.update(prefill_ms=1e3 * r["prefill_s"],
             decode_ms_per_token=1e3 * r["decode_s"] / SERVE_NEW,
             tokens_per_s=B * SERVE_NEW / (r["prefill_s"] + r["decode_s"]),
             peak_bytes=torch.cuda.max_memory_allocated(dev))
    print(f"[encdec] {cfg.name} {label} requests={B} frames={frames.shape[1]} "
          f"new={SERVE_NEW} prefill_ms={r['prefill_ms']!r} (encoder, cross "
          f"caches, BOS step) decode_ms_per_token="
          f"{r['decode_ms_per_token']!r} tokens_per_s={r['tokens_per_s']!r} "
          f"peak_bytes={r['peak_bytes']}")
    return r


def _encdec_f32_caches(cfg, params, frames, backend: str) -> dict:
    """The greedy run of :func:`_serve_encdec` (prefill, then
    ``SERVE_NEW`` decode steps) with the decoder caches in float32, where
    the reference keeps them in bf16 in every run. Not a served
    configuration: phase 16 (b)'s float32 hold of the kernels, and its
    measure of how far the bf16 caches move float32 logits."""
    import torch

    from repro_torch.models import model as M

    B, S = frames.shape[:2]
    caches = {k: [t.float() for t in v] for k, v in
              M.init_caches(cfg, B, S, device=frames.device).items()}
    toks, seen = [], []
    with torch.inference_mode():
        logits, caches = M.prefill(cfg, params, caches=caches, frames=frames,
                                   backend=backend)
        for i in range(SERVE_NEW):
            tok = logits[:, -1:].argmax(-1)
            toks.append(tok[:, 0])
            seen.append(logits[:, -1])
            logits, caches = M.decode_step(cfg, params, caches, tok, 1 + i,
                                           backend=backend)
    return {"tokens": torch.stack(toks, 1).cpu().numpy(),
            "logits": torch.stack(seen, 1)}


def phase_whisper(dev) -> dict:
    """Phase 16 (b): whisper-large-v3 at full width and depth (32 encoder
    and 32 decoder layers, seed 0) serving ``SERVE_REQUESTS`` requests of
    ``WHISPER_FRAMES`` frame embeddings (from the seed) and ``SERVE_NEW``
    greedy tokens, on the kernels and on the plain route, in bf16 as
    served and with the same weights and frames in float32.
    ``flash_attention`` launches once an encoder layer and twice a decoder
    layer a step (the BOS step one of them), nothing else; the plain route
    never.

    The decoder caches are bf16 in every run, as the reference's, so a
    float32 run rounds each K/V it caches, and a float32 difference of
    ~1e-6 between the routes flips that rounding by a bf16 ulp at some
    elements (0.2% of the cross keys at full depth, PERF.md), which moves
    the float32 logits by more than ``SERVE_TOL_F32``. So the float32 hold
    is made twice: with float32 caches on both routes
    (:func:`_encdec_f32_caches`), at ``SERVE_TOL_F32``, where only the
    kernels' float32 arithmetic parts the routes; and as served, bf16
    caches, within twice the cache noise (how far the bf16 caches move
    the plain route's float32 logits), as the bf16 run is held within
    twice the bf16 noise (:func:`hold_served`)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.models import model as M
    from repro_torch.serve.engine import generate_encdec, greedy_agreement

    cfg = get_config(WHISPER)
    t_arch = t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    frames = torch.tensor(np.random.default_rng(0).standard_normal(
        (SERVE_REQUESTS, WHISPER_FRAMES, cfg.d_model), np.float32),
        device=dev).bfloat16()
    for backend in ("auto", "plain"):   # warm-up at the served shape
        generate_encdec(cfg, params, frames, 2, backend=backend)
    _cuda.reset_launches()                     # the main path
    k = _serve_encdec(cfg, params, frames, "auto", "bf16 kernels")
    launches = dict(_cuda.LAUNCHES)
    _cuda.reset_launches()
    p = _serve_encdec(cfg, params, frames, "plain", "bf16 plain")
    plain_launches = dict(_cuda.LAUNCHES)
    want = cfg.n_encoder_layers + 2 * cfg.n_layers * (1 + SERVE_NEW)
    others = {n: c for n, c in launches.items()
              if n != "flash_attention" and c}
    if (launches["flash_attention"] != want or others
            or any(plain_launches.values())):
        raise AssertionError(
            f"{WHISPER}: launches {launches} (want flash_attention = {want} "
            f"and no other), plain route {plain_launches} (want none)")
    logits = k["logits"]
    if logits.shape != (SERVE_REQUESTS, SERVE_NEW, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{WHISPER}: logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    params32, frames32 = to_f32(params), frames.float()
    k32 = _serve_encdec(cfg, params32, frames32, "auto", "f32 kernels")
    p32 = _serve_encdec(cfg, params32, frames32, "plain", "f32 plain")
    q32 = _encdec_f32_caches(cfg, params32, frames32, "auto")
    r32 = _encdec_f32_caches(cfg, params32, frames32, "plain")
    del params32
    err_exact = _close_or_raise(f"{WHISPER} f32 first-step logits, float32 "
                                "caches", q32["logits"][:, 0],
                                r32["logits"][:, 0], SERVE_TOL_F32)
    held_exact = greedy_agreement(q32["tokens"], r32["tokens"],
                                  r32["logits"], atol=SERVE_TOL_F32,
                                  rtol=SERVE_TOL_F32)
    cache_noise = float((p32["logits"][:, 0] - r32["logits"][:, 0]).abs()
                        .max())
    tol32 = max(SERVE_TOL_F32, 2 * cache_noise)
    err32, held32, err, tol, noise, held = hold_served(
        WHISPER, k, p, k32, p32, atol32=tol32, rtol32=0.0)
    equal = int((k["tokens"] == p["tokens"]).sum())
    print(f"[encdec] {WHISPER} params={cfg.param_count()} init_s={init_s!r} "
          f"f32 with float32 caches: first-step logits max_abs_err="
          f"{err_exact!r} (tol {SERVE_TOL_F32}), tokens held={held_exact}; "
          f"f32 as served (bf16 caches): max_abs_err={err32!r} (tol "
          f"{tol32!r} = 2 x the caches' noise {cache_noise!r}), tokens "
          f"held={held32}; bf16 max_abs_err={err!r} (tol {tol!r} = 2 x bf16 "
          f"noise {noise!r}), tokens held={held}, equal={equal}/"
          f"{k['tokens'].size}; flash_attention launches="
          f"{launches['flash_attention']} (= {cfg.n_encoder_layers} + 2 x "
          f"{cfg.n_layers} x {1 + SERVE_NEW}); wall_s="
          f"{time.perf_counter() - t_arch!r}")
    out = dict(kernel="flash_attention", launches=launches["flash_attention"],
               logit_err=err, logit_tol=tol, logit_err_f32=err32,
               logit_tol_f32=tol32, cache_noise_f32=cache_noise,
               logit_err_f32_caches=err_exact, held=held, held_f32=held32,
               held_f32_caches=held_exact, equal=equal, init_s=init_s,
               **{m: k[m] for m in ("prefill_ms", "decode_ms_per_token",
                                    "tokens_per_s", "peak_bytes")},
               plain={m: p[m] for m in ("prefill_ms", "decode_ms_per_token",
                                        "tokens_per_s")},
               f32={m: k32[m] for m in ("prefill_ms", "decode_ms_per_token",
                                        "tokens_per_s", "peak_bytes")})
    del params, k, p, k32, p32, q32, r32, logits
    torch.cuda.empty_cache()
    return out


def phase_vlm_prefill(cfg, params, params32, dev) -> dict:
    """Phase 16 (c), inside phase 9's internvl2-2b run: one
    ``model.prefill`` of ``SERVE_REQUESTS`` x ``SERVE_PROMPT`` tokens
    whose first ``vision_tokens`` positions carry patch embeddings from
    the seed, on the kernels and on the plain route, with the bf16 and
    the float32 weights; the last position's logits held by
    :func:`hold_served`'s rules, and off the text-only prefill's by more
    than the bf16 tolerance (the patch embeddings reach the logits)."""
    import numpy as np
    import torch

    from repro_torch.kernels import _cuda
    from repro_torch.models import model as M

    B, S = SERVE_REQUESTS, SERVE_PROMPT
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)
    vision = torch.tensor(rng.standard_normal(
        (B, cfg.vision_tokens, cfg.d_model), np.float32) * VLM_PATCH_SCALE,
        device=dev)

    def run(p, backend, **kw):
        caches = M.init_caches(cfg, B, S, device=dev, dtype=p["embed"].dtype)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, _ = M.prefill(cfg, p, tokens, caches=caches, backend=backend,
                              **kw)
        torch.cuda.synchronize(dev)
        return {"logits": logits, "tokens": logits.argmax(-1).cpu().numpy(),
                "ms": 1e3 * (time.perf_counter() - t0)}

    _cuda.reset_launches()
    k = run(params, "auto", vision_embeds=vision)
    launches = dict(_cuda.LAUNCHES)
    want = kernel_layers(cfg, "flash_attention")
    if launches["flash_attention"] != want or any(
            c for n, c in launches.items() if n != "flash_attention"):
        raise AssertionError(f"{cfg.name} vision prefill: launches "
                             f"{launches} (want flash_attention = {want})")
    p = run(params, "plain", vision_embeds=vision)
    k32 = run(params32, "auto", vision_embeds=vision)
    p32 = run(params32, "plain", vision_embeds=vision)
    err32, held32, err, tol, noise, held = hold_served(
        f"{cfg.name} vision prefill", k, p, k32, p32)
    moved = float((run(params, "auto")["logits"] - k["logits"]).abs().max())
    if not moved > tol:
        raise AssertionError(f"{cfg.name}: the patch embeddings moved the "
                             f"logits by {moved} <= {tol}")
    print(f"[serve] {cfg.name} vision prefill ({cfg.vision_tokens} patch "
          f"embeddings a request) kernels {k['ms']!r} ms, plain {p['ms']!r} "
          f"ms; f32 logits max_abs_err={err32!r} (tol {SERVE_TOL_F32}); bf16 "
          f"max_abs_err={err!r} (tol {tol!r} = 2 x bf16 noise {noise!r}); "
          f"argmax held={held}/{held32}; text-only logits {moved!r} away; "
          f"flash_attention launches={launches['flash_attention']}")
    return dict(launches=launches["flash_attention"], prefill_ms=k["ms"],
                plain_ms=p["ms"], logit_err=err, logit_tol=tol,
                logit_err_f32=err32, moved_by_vision=moved)


#: Phase 18 (c): the dry run's FLOPs within this fraction of the profiled
#: step's (both sides count the same aten products and the same kernel
#: formulas, so a larger gap is a counting fault), and its peak within
#: this ratio of the measured peak
MESH_FLOPS_TOL = 0.01
MESH_PEAK_RATIO = (0.75, 1.25)
#: the products torch.profiler's ``with_flops`` counts that the dry run
#: counts too
PROFILED_PRODUCTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


class kernel_work:
    """Adds up, by the kernel packages' formulas, the FLOPs and bytes of
    every ``flash_attention`` forward and backward launched inside the
    block (the dry run counts its shape-only calls with the same
    formulas)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.kernels.flash_attention.work import (
            attention_bwd_work, attention_work)
        from repro_torch.kernels.flash_attention_bwd import kernel as bwd

        self.flops = self.bytes = 0.0
        self.calls = {"flash_attention": 0, "flash_attention_bwd": 0}
        self._ops, self._bwd = ops, bwd
        self._fwd_fn, self._bwd_fn = (ops.flash_attention_kernel,
                                      bwd.flash_attention_bwd_kernel)

        def shape(q, k, kw):
            B, H, Sq, hd = q.shape
            return (B, H, k.shape[1], hd, Sq, k.shape[2]), dict(
                causal=kw.get("causal", True), window=kw.get("window"),
                q_offset=kw.get("q_offset", 0), kv_len=kw.get("kv_len"))

        def fwd(q, k, v, **kw):
            dims, mask = shape(q, k, kw)
            b, f = attention_work(*dims, size=q.element_size(), **mask)
            self._add("flash_attention", f, b)
            return self._fwd_fn(q, k, v, **kw)

        def bwd_(q, k, v, o, lse, do, **kw):
            dims, mask = shape(q, k, kw)
            b, f = attention_bwd_work(*dims, size=q.element_size(),
                                      o_size=o.element_size(), **mask)
            self._add("flash_attention_bwd", f, b)
            return self._bwd_fn(q, k, v, o, lse, do, **kw)

        ops.flash_attention_kernel = fwd
        bwd.flash_attention_bwd_kernel = bwd_
        return self

    def _add(self, name, flops, bytes_):
        self.calls[name] += 1
        self.flops += flops
        self.bytes += bytes_

    def __exit__(self, *exc):
        self._ops.flash_attention_kernel = self._fwd_fn
        self._bwd.flash_attention_bwd_kernel = self._bwd_fn
        return False


def profiled_products(events) -> tuple[dict, dict, dict]:
    """FLOPs of the products of a profiled step by operator name
    (``with_flops``): those that ran on the card; apart from them the
    events that enclose another product (a DTensor operator is recorded
    around the local operator it runs) and the products that launched
    nothing. The profiler records an operator where it is called, above
    autograd: a checkpoint's recompute that stops early (once every saved
    tensor is back) stops inside the autograd wrapper of its last
    product, whose kernel never runs, once a remat segment."""
    ran, outer, aborted = {}, {}, {}

    def encloses(e) -> bool:
        return any(c.name in PROFILED_PRODUCTS or encloses(c)
                   for c in e.cpu_children)

    def launched(e) -> bool:
        return bool(e.kernels) or any(
            "Launch" in c.name or launched(c) for c in e.cpu_children)

    for e in events:
        if e.name in PROFILED_PRODUCTS:
            into = (outer if encloses(e) else ran if launched(e)
                    else aborted)
            into[e.name] = into.get(e.name, 0) + (e.flops or 0)
    return ran, outer, aborted


class count_propagation:
    """Counts DTensor's sharding propagations on fake tensors inside the
    block (each runs an operator once on global shapes, which the profiler
    records too); a step whose rules are all cached makes none."""

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self._cls = ShardingPropagator
        self._orig = ShardingPropagator._propagate_tensor_meta_non_cached
        self.calls = 0

        def counted(prop, op_schema):
            self.calls += 1
            return self._orig(prop, op_schema)

        ShardingPropagator._propagate_tensor_meta_non_cached = counted
        return self

    def __exit__(self, *exc):
        self._cls._propagate_tensor_meta_non_cached = self._orig
        return False


def start_mesh_dryrun(out_dir: str) -> subprocess.Popen:
    """Phase 18 (c)'s prediction, started first so that it runs beside
    (a) and (b): ``repro_torch.launch.dryrun`` for gemma3-1b's training
    step at ``TRAIN_B`` x ``TRAIN_S``, one microbatch, on a (1, 1) mesh of
    the fake backend, in its own process (it creates its process group)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b", "--shape", "train_4k", "--batch", str(TRAIN_B),
         "--seq", str(TRAIN_S), "--mesh", "1x1", "--n-micro", "1", "--out",
         out_dir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def phase_mesh(dev) -> dict:
    """Phase 18: the mesh on the card. A (1, 1) ``DeviceMesh`` over NCCL at
    world size 1, from an in-process ``HashStore``. (a) gemma3-1b's
    parameters at full width and depth, written to a checkpoint and
    restored, placed by ``reshard_for_mesh`` with the parameter rules:
    each leaf's ``full_tensor()`` bit-equal to the restored leaf. (b) its
    first training step at ``TRAIN_B`` x ``TRAIN_S`` with DTensor
    parameters, optimizer state and batch through ``make_train_step(mesh=
    ...)``'s gradient (``grad_fn`` with the pins): ``flash_attention``
    and ``flash_attention_bwd`` launch as in phase 12 (b)'s first step,
    the loss and every gradient leaf within ``TRAIN_TOL`` of the step
    without a mesh (the largest difference printed: 0 is expected on one
    rank); then whole steps, timed, with ``max_memory_allocated``. (c) the
    dry run of the same cell on a (1, 1) fake mesh in a subprocess: its
    FLOPs (aten products plus the kernels' formulas) within
    ``MESH_FLOPS_TOL`` of one profiled step's (``torch.profiler``'s
    ``with_flops`` over the same products, plus the same formulas over
    the launched kernels), its peak within ``MESH_PEAK_RATIO`` of the
    measured one."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint.ckpt import (reshard_for_mesh,
                                             restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.launch import shardings as S
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import axis_sizes, data_axes, make_debug_mesh
    from repro_torch.models import shardctx
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import grad_fn, make_train_step

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    predicting = start_mesh_dryrun(out_dir)
    cfg = get_config("gemma3-1b")
    layers = kernel_layers(cfg, "flash_attention")
    # remat checkpoints each group and each remainder block
    segments = cfg.n_groups + len(cfg.remainder_pattern)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        sizes = axis_sizes(mesh)
        rule = lambda path, leaf: S.placements(  # noqa: E731
            S.param_pspec(path, tuple(leaf.shape), sizes), mesh)
        run = launch_train.build(cfg, batch=TRAIN_B, seq=TRAIN_S,
                                 steps=TRAIN_STEPS, device=dev)
        params, opt, tcfg = run.pop("params"), run.pop("opt"), run["tcfg"]

        # (a) resharding a restored checkpoint
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as ck:
            save_checkpoint(params, ck, 0, n_shards=4)
            restored, _ = restore_checkpoint(ck, 0, like=params, device=dev)
        placed = reshard_for_mesh(restored, mesh, rule)
        n_leaves = 0
        for a, b_ in zip(tree_leaves(placed), tree_leaves(restored)):
            if not (isinstance(a, DTensor) and a.dtype == b_.dtype
                    and torch.equal(a.full_tensor(), b_)):
                raise AssertionError("reshard_for_mesh: a leaf differs from "
                                     "the restored one")
            n_leaves += 1
        if not all(torch.equal(a, b_) for a, b_ in
                   zip(tree_leaves(restored), tree_leaves(params))):
            raise AssertionError("the restored checkpoint differs from the "
                                 "parameters written")
        reshard_s = time.perf_counter() - t0
        del placed, restored
        print(f"[mesh] phase 18 (a) gemma3-1b: {n_leaves} leaves written, "
              f"restored and placed on the (1, 1) mesh by the parameter "
              f"rules, each full_tensor() bit-equal to the restored leaf "
              f"({reshard_s!r} s)")

        # (b) the first step on DTensors against the step without a mesh
        batch, _ = run["loader"].next_batch()
        b = launch_train.family_batch(cfg, batch, device=dev)
        dt = lambda spec, t: DTensor.from_local(  # noqa: E731
            t, mesh, S.placements(spec, mesh), run_check=False)
        on_mesh = lambda tree: S.tree_map_with_path(  # noqa: E731
            lambda path, t: dt(S.param_pspec(path, tuple(t.shape), sizes),
                               t), tree)
        dparams = on_mesh(params)
        dopt = {k: on_mesh(v) if k != "step" else dt((), v)
                for k, v in opt.items()}
        dbatch = {k: dt(S.batch_pspec(k, tuple(v.shape), mesh), v)
                  for k, v in b.items()}
        pins = S.param_shardings(mesh, params)
        pinned = dict(mesh=mesh, dp_axes=data_axes(mesh),
                      grad_shardings=pins)
        l0, _, g0 = grad_fn(cfg, tcfg, params, b)
        l0 = float(l0)
        shardctx.set_mesh(mesh, data_axes(mesh))
        try:
            _cuda.reset_launches()                  # the mesh path
            with implicit_replication():
                l1, _, g1 = grad_fn(cfg, tcfg, dparams, dbatch, **pinned)
            torch.cuda.synchronize(dev)
            launches = dict(_cuda.LAUNCHES)
            l1 = float(l1.full_tensor() if isinstance(l1, DTensor) else l1)
            errs, diffs = [], []
            for a, b_ in zip(tree_leaves(g1), tree_leaves(g0)):
                a = a.full_tensor() if isinstance(a, DTensor) else a
                errs.append(_rel_l2(a, b_))
                diffs.append(float((a.float() - b_.float()).abs().max()))
            del g0, g1
            loss_err = abs(l1 - l0) / abs(l0)
            want = {"flash_attention": 2 * layers,
                    "flash_attention_bwd": layers}
            others = {n: c for n, c in launches.items()
                      if c and n not in want}
            print(f"[mesh] phase 18 (b) gemma3-1b first step B={TRAIN_B} "
                  f"S={TRAIN_S} on the (1, 1) mesh: loss {l1!r} (without a "
                  f"mesh {l0!r}, rel err {loss_err!r}); {len(errs)} gradient "
                  f"leaves: max rel L2 {max(errs)!r}, max abs difference "
                  f"{max(diffs)!r} (tol {TRAIN_TOL}); launches {launches} "
                  f"(want {want}); card {smi}")
            if (loss_err > TRAIN_TOL or max(errs) > TRAIN_TOL or others
                    or any(launches[n] != c for n, c in want.items())):
                raise AssertionError(f"phase 18 (b): loss rel err "
                                     f"{loss_err}, leaf {max(errs)}, "
                                     f"launches {launches}")
            step = make_train_step(cfg, tcfg, **pinned)
            del params, opt
            times, peak = [], 0
            for _ in range(2):          # the first warms DTensor's caches
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                t1 = time.perf_counter()
                out = step(dparams, dopt, dbatch)
                torch.cuda.synchronize(dev)
                times.append(time.perf_counter() - t1)
                peak = torch.cuda.max_memory_allocated(dev)
                del out
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts,
                                        with_flops=True) as prof:
                with kernel_work() as work, count_propagation() as props:
                    out = step(dparams, dopt, dbatch)
                    torch.cuda.synchronize(dev)
            del out
        finally:
            shardctx.clear()
        products, nested, aborted = profiled_products(prof.events())
        measured = sum(products.values()) + work.flops
        print(f"[mesh] phase 18 (b) whole steps on the mesh: step_ms "
              f"{[1e3 * t for t in times]} max_memory_allocated={peak} "
              f"(B={TRAIN_B} S={TRAIN_S}); card {smi}")
    finally:
        dist.destroy_process_group()

    # (c) the dry run's prediction of the same step
    log, _ = predicting.communicate(timeout=600)
    path = os.path.join(out_dir, "gemma3-1b__train_4k__1x1.json")
    if predicting.returncode or not os.path.exists(path):
        raise AssertionError(f"phase 18 (c): the dry run failed: "
                             f"{log[-2000:]}")
    with open(path) as f:
        rec = json.load(f)
    if not rec.get("ok"):
        raise AssertionError(f"phase 18 (c): {rec.get('error')}")
    predicted = rec["matmul_flops_per_device"] + rec[
        "kernel_flops_per_device"]
    flops_err = abs(predicted - measured) / measured
    ratio = rec["peak_bytes"] / peak
    print(f"[mesh] phase 18 (c) dry run of the same step on a (1, 1) fake "
          f"mesh ({rec['wall_s']!r} s): predicted FLOPs {predicted!r} "
          f"(products {rec['matmul_flops_per_device']!r}, kernels "
          f"{rec['kernel_flops_per_device']!r}, {rec['kernels']}); profiled "
          f"{measured!r} (products {products}, kernels {work.flops!r}, "
          f"{work.calls}; not counted: the DTensor-level product events "
          f"around them {nested}, the products that launched nothing "
          f"(a remat recompute's early stop) {aborted} against "
          f"{segments} segments; sharding propagations in the step "
          f"{props.calls}); rel err {flops_err!r} (tol {MESH_FLOPS_TOL}); "
          f"peak predicted {rec['peak_bytes']} measured {peak} ratio "
          f"{ratio!r} (within {MESH_PEAK_RATIO}); card {smi}")
    if flops_err > MESH_FLOPS_TOL or not (
            MESH_PEAK_RATIO[0] <= ratio <= MESH_PEAK_RATIO[1]):
        raise AssertionError(f"phase 18 (c): FLOPs rel err {flops_err}, "
                             f"peak ratio {ratio}")
    wall = time.perf_counter() - t_phase
    print(f"[mesh] phase 18 wall_s={wall!r}")
    return {"launches": launches, "loss_rel_err": loss_err,
            "max_leaf_rel_l2": max(errs), "max_abs_diff": max(diffs),
            "reshard_leaves": n_leaves, "reshard_s": reshard_s,
            "step_ms": [1e3 * t for t in times], "peak_bytes": peak,
            "predicted_flops": predicted, "profiled_flops": measured,
            "profiled_products": products, "enclosing_products": nested,
            "aborted_products": aborted,
            "propagations": props.calls, "kernel_formula_flops": work.flops,
            "flops_rel_err": flops_err,
            "predicted_peak_bytes": rec["peak_bytes"], "peak_ratio": ratio,
            "dryrun_wall_s": rec["wall_s"], "phase_s": wall}


def ptxas_report(log: str) -> list:
    """``(kernel, "N registers, S bytes spill stores, L bytes spill
    loads")`` for each entry function of one ``nvcc -Xptxas -v`` log."""
    import re

    out, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = demangle(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)} bytes spill stores, {m.group(2)} bytes " \
                    "spill loads"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, f"{m.group(1)} registers, {spill}"))
            fn, spill = None, ""
    return out


def demangle(symbol: str) -> str:
    """``c++filt``'s reading of a mangled kernel name, without the
    anonymous namespace and the parameter list; the symbol itself when
    ``c++filt`` is missing."""
    try:
        name = subprocess.run(["c++filt", symbol], capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return symbol
    return name.replace("(anonymous namespace)::", "").split("(")[0]


def sass_counts(lib_name, pattern: str) -> dict:
    """Instructions matching ``pattern`` per entry function of one
    library (a kernel's name, or a library's path), read from
    ``cuobjdump -sass``."""
    import re
    import shutil

    from repro_torch.kernels import _cuda

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    lib = (_cuda._library_path(lib_name) if lib_name in _cuda.KERNELS
           else lib_name)
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = demangle(m.group(1))
            counts[fn] = 0
        elif fn and re.search(pattern, line):
            counts[fn] += 1
    return counts


def phase_sass(first_scan_bwd=None) -> dict:
    """Read the SASS of three kinds of kernel. The tensor-core instructions
    of each ``flash_attention`` entry function (``HMMA``, ``HGMMA``):
    raises unless each tensor-core prefill kernel has some; the other
    routes run on the CUDA cores. The warpgroup products (``HGMMA``) of
    each ``flash_attention_bwd`` entry function: raises unless the dK/dV
    and the dQ kernel of every head dim have some. The non-coherent
    read-only loads (``LDG...CONSTANT``) narrower than 64 bits in the
    network cluster kernels: raises on any, since their int32 reads (path
    rows, index lists) may see rows the same launch wrote. The
    exponentials (``MUFU.EX2``) of each ``selective_scan_bwd`` entry
    function: raises unless each reverse walk has ``SCAN_BWD_EX2``, one a
    state a step of its unrolled round (the library ``first_scan_bwd``,
    the first version, is counted beside it)."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS

    counts = sass_counts("flash_attention", r"\bH(G)?MMA\b")
    for fn, n in sorted(counts.items()):
        print(f"[sass] flash_attention: {fn}: {n} HMMA/HGMMA instructions")
    mma = {fn: n for fn, n in counts.items() if "flash_kernel_mma" in fn}
    if len(mma) != len(HEAD_DIMS) or not all(mma.values()):
        raise AssertionError(f"tensor-core prefill kernels without HMMA: "
                             f"{mma}")
    bwd = sass_counts("flash_attention_bwd", r"\bHGMMA\b")
    for fn, n in sorted(bwd.items()):
        print(f"[sass] flash_attention_bwd: {fn}: {n} HGMMA instructions")
    want = {f"void {kind}<{hd}>" for kind in ("dkdv_kernel", "dq_kernel")
            for hd in HEAD_DIMS}
    missing = sorted(fn for fn in want if not bwd.get(fn))
    if missing:
        raise AssertionError(f"backward product kernels without HGMMA: "
                             f"{missing} (found {bwd})")
    narrow_nc = {}
    for lib in ("net_rerate", "event_engine"):
        nc = sass_counts(lib, r"\bLDG\S*\.CONSTANT\b")
        narrow = sass_counts(lib, r"\bLDG(?!\S*\.(64|128))\S*\.CONSTANT\b")
        for fn in sorted(nc):
            print(f"[sass] {lib}: {fn}: {nc[fn]} non-coherent loads, "
                  f"{narrow[fn]} of them narrower than 64 bits")
            narrow_nc[fn] = narrow[fn]
    if any(narrow_nc.values()):
        raise AssertionError(f"network kernels with narrow non-coherent "
                             f"loads: {narrow_nc}")
    ex2 = {}
    for label, lib in (("current", "selective_scan_bwd"),
                       ("first", first_scan_bwd)):
        if lib is None:
            continue
        ex2[label] = sass_counts(lib, r"\bMUFU\.EX2\b")
        for fn, n in sorted(ex2[label].items()):
            print(f"[sass] selective_scan_bwd ({label}): {fn}: {n} "
                  f"MUFU.EX2 instructions")
    walks = {fn: n for fn, n in ex2["current"].items()
             if "scan_bwd_kernel" in fn}
    if len(walks) != 4 or set(walks.values()) != {SCAN_BWD_EX2}:
        raise AssertionError(f"selective_scan_bwd walks without one "
                             f"exponential a state a step "
                             f"({SCAN_BWD_EX2}): {walks}")
    return {"scan_bwd_ex2": ex2,
            "tensor_core_instructions": counts,
            "bwd_tensor_core_instructions": bwd,
            "narrow_noncoherent_loads": narrow_nc}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _cuda

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"[card] {smi}")
    print(f"[card] torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}"
          f" torch {torch.__version__} cuda {torch.version.cuda}")

    first_build = start_first_scan_bwd()
    build_s = _cuda.build()
    print(f"[build] {', '.join(_cuda.KERNELS)} built in {build_s:.2f}s")
    first_scan_bwd, first_lib, first_log = load_first_scan_bwd(first_build)
    for fn, report in ptxas_report(first_log):
        print(f"[build] selective_scan_bwd (first version): {fn}: {report}")
    ptxas = {name: ptxas_report(log) for name, log in _cuda.BUILD_LOGS.items()}
    for name, reports in ptxas.items():
        for fn, report in reports:
            print(f"[build] {name}: {fn}: {report}")
    spills = [f"{name}: {fn}"
              for name in ("flash_attention_bwd", "selective_scan_bwd")
              for fn, report in ptxas.get(name, [])
              if not report.endswith(" 0 bytes spill stores, 0 bytes spill "
                                     "loads")]
    if spills:
        raise AssertionError(f"backward entry functions that spill: "
                             f"{spills}")
    sass = phase_sass(first_lib)
    occupancy = phase_scan_bwd_occupancy(dev)

    kernels = phase_kernels(dev)
    dense = phase_dense_kernels(dev)
    golden = phase_golden(dev)
    scale, scale_result = phase_scale(dev)
    shapes: dict = {}
    paths = phase_paths(dev, shapes)
    path_shape = phase_path_shape(dev, shapes["grid_500_evict"])
    model = phase_model_kernels(dev)
    served = phase_serve(dev)
    telemetry = phase_telemetry(dev, scale_result)
    analysis = phase_analysis(dev)
    train_kernels = phase_train_kernels(dev)
    train = phase_train(dev)
    supervised = phase_supervisor(dev)
    t13 = time.perf_counter()
    mamba_kernels = phase_train_mamba_kernels(dev, first_scan_bwd)
    mamba_train = phase_train_mamba(dev)
    print(f"[train-mamba] phase 13 wall_s={time.perf_counter() - t13!r}")
    t14 = time.perf_counter()
    moe_kernels = phase_train_kernels(dev, MOE_BWD_CASES, "14 (a)")
    moe_train = phase_train_moe(dev)
    arctic = phase_arctic(dev)
    print(f"[moe] phase 14 (a, c, d) wall_s={time.perf_counter() - t14!r}")
    t15 = time.perf_counter()
    zamba_kernels = phase_train_kernels(dev, ZAMBA_BWD_CASES, "15 (a)")
    zamba_train = phase_train_zamba(dev)
    print(f"[zamba] phase 15 (a, c) wall_s={time.perf_counter() - t15!r}")
    t16 = time.perf_counter()
    encdec_kernels = phase_encdec_kernels(dev)
    whisper = phase_whisper(dev)
    print(f"[encdec] phase 16 (a, b) wall_s={time.perf_counter() - t16!r}")
    t17 = time.perf_counter()
    encdec_bwd = phase_train_kernels(dev, ENCDEC_BWD_CASES, "17 (a)")
    whisper_train = phase_train_whisper(dev)
    vlm_train = phase_train_vlm(dev)
    print(f"[encdec] phase 17 (a, b, c) wall_s="
          f"{time.perf_counter() - t17!r}")
    mesh = phase_mesh(dev)
    model["flash_attention"] += encdec_kernels
    launches = {"net_rerate": golden["net_rerate"],
                "event_engine": scale["event_engine"]}
    by_path = {name: {p: paths[p][name] for p, ks in PATH_KERNELS.items()
                      if name in ks}
               for name in ("strategy_plan", "st_cost", "value_score")}
    for name, counts in by_path.items():
        launches[name] = sum(counts.values())
    # each serving path's counts, and arctic-480b's prefill (phase 14 (d))
    by_serving = {}
    for arch, r in served.items():
        by_serving.setdefault(r["kernel"], {})[arch] = r["launches"]
    by_serving["flash_attention"]["arctic-480b depth 1 prefill"] = \
        arctic["launches"]
    by_serving["flash_attention"][WHISPER] = whisper["launches"]
    by_serving["flash_attention"]["internvl2-2b vision prefill"] = \
        served["internvl2-2b"]["vision_prefill"]["launches"]
    for name, counts in by_serving.items():
        launches[name] = sum(counts.values())

    sources = {"event_engine": ("src/repro_torch/csrc/event_engine.cu",
                                "src/repro/kernels/event_engine/kernel.py:39"),
               "net_rerate": ("src/repro_torch/csrc/net_rerate.cu",
                              "src/repro/kernels/net_rerate/kernel.py:38"),
               "strategy_plan": (
                   "src/repro_torch/csrc/strategy_plan.cu",
                   "src/repro/kernels/strategy_plan/kernel.py:45"),
               "st_cost": ("src/repro_torch/csrc/st_cost.cu",
                           "src/repro/kernels/st_cost/kernel.py:44"),
               "value_score": ("src/repro_torch/csrc/value_score.cu",
                               "src/repro/kernels/value_score/kernel.py:38"),
               "flash_attention": (
                   "src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention/kernel.py:29"),
               "selective_scan": (
                   "src/repro_torch/csrc/selective_scan.cu",
                   "src/repro/kernels/selective_scan/kernel.py:29")}
    summary = []
    # net_rerate's own path is phase 4; the slice-2 paths run it too
    rerate_by_path = {"golden": launches["net_rerate"],
                      **{p: paths[p]["net_rerate"] for p in PATHS}}
    # event_engine: the mean-dirty smoke shape is its path's;
    # net_rerate: grid_500_evict's own per-call shape
    for name in ("event_engine", "net_rerate"):
        rows = ([kernels[name][0], kernels[name][1], path_shape[name]]
                if name == "event_engine" else
                [path_shape[name], *kernels[name]])
        row = rows[0]
        summary.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "wrapper_ms": row["wrapper_ms"],
            "plain_wrapper_ms": row["plain_wrapper_ms"],
            "shape": row["shape"],
            "copy_ms": row["copy_ms"],
            "device_ops_per_call": row["device_ops_per_call"],
            "other_shapes": [{k: r[k] for k in
                              ("shape", "ms", "plain_ms", "wrapper_ms",
                               "plain_wrapper_ms", "bound_ms", "bound_by")}
                             for r in rows[1:]],
            "ptxas": dict(ptxas.get(name, [])),
            "narrow_noncoherent_loads": {
                fn: n for fn, n in sass["narrow_noncoherent_loads"].items()
                if fn in dict(ptxas.get(name, []))},
            **({"launches_by_path": rerate_by_path,
                "path_shape": shapes["grid_500_evict"]}
               if name == "net_rerate" else {}),
        })
    # the first shape of each is its path's: the grid_500_evict burst at
    # zero serve, bulk_shortest, economy_starved in cost mode
    for name in ("strategy_plan", "st_cost", "value_score"):
        rows = dense[name]
        row = rows[0]
        summary.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "wrapper_ms": row["wrapper_ms"],
            "plain_wrapper_ms": row["plain_wrapper_ms"],
            "shape": row["shape"], "launches_by_path": by_path[name],
            "other_shapes": [{k: r[k] for k in
                              ("shape", "ms", "plain_ms", "wrapper_ms",
                               "bound_ms", "bound_by")} for r in rows[1:]],
            **({"bound_all_cells_ms": row["bound_all_cells_ms"]}
               if name == "strategy_plan" else {}),
            **({"design": ST_COST_DESIGN} if name == "st_cost" else {}),
        })
    # the first case of each is its path's main shape: the gemma3-1b
    # global-layer prefill in bf16, the falcon-mamba-7b prefill
    for name in ("flash_attention", "selective_scan"):
        rows = model[name]
        row = rows[0]
        summary.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            # the exponentials are operations, on the special-function units
            "bound_by": "bytes" if row["bound_by"] == "bytes" else
                        "operations",
            "bound_term": row["bound_by"],
            "library_ms": row["library_ms"], "wrapper_ms": row["wrapper_ms"],
            "plain_wrapper_ms": row["plain_wrapper_ms"],
            "shape": row["shape"],
            "other_shapes": [{k: r[k] for k in
                              ("shape", "max_abs_err", "ms", "warm_ms",
                               "plain_ms", "wrapper_ms", "library_ms",
                               "bound_ms", "bound_by")} for r in rows[1:]],
            "serving": {a: {k: v for k, v in r.items() if k != "kernel"}
                        for a, r in served.items() if r["kernel"] == name},
            "launches_by_path": by_serving[name],
            **({"routes": {r["shape"]: r["ms"] for r in rows},
                "ptxas": dict(ptxas.get(name, [])),
                "tensor_core_instructions": sass["tensor_core_instructions"]}
               if name == "flash_attention" else {}),
        })
    # the backward: the gemma3-1b global layer is its path's main shape;
    # its launches are the full-width training run's (phase 12 (b))
    later = (moe_kernels["flash_attention_bwd"]
             + zamba_kernels["flash_attention_bwd"]
             + encdec_bwd["flash_attention_bwd"])
    rows = (train_kernels["flash_attention_bwd"]
            + [r for r in later if r["dtype"] == "bfloat16"])
    bwd_f32 = [r for r in later if r["dtype"] == "float32"]
    row = rows[0]
    trained = (("gemma3-1b", train), ("granite-moe-1b-a400m", moe_train),
               ("gemma3-1b on the (1, 1) mesh, first step", mesh),
               (f"zamba2-7b depth {ZAMBA_TRAIN_LAYERS}", zamba_train),
               (WHISPER, whisper_train), ("internvl2-2b", vlm_train))
    bwd_launches = {a: t["launches"]["flash_attention_bwd"]
                    for a, t in trained}
    summary.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:29",
        "replaces_note": (
            "the TPU kernel has no backward; the reference differentiates "
            "its jnp stand-in attention_blockwise "
            "(src/repro/models/attention.py:62) with jax.value_and_grad"),
        "launches": sum(bwd_launches.values()),
        "launches_by_path": bwd_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "library": ("scaled_dot_product_attention forward + backward, "
                    "device time by the profiler; compare fwd_bwd_ms"),
        "library_backend": row["library_backend"],
        "library_bwd_ms": row["library_bwd_ms"],
        "library_wrapper_ms": row["library_wrapper_ms"],
        "split_us": row["split_us"],
        "fwd_bwd_ms": row["fwd_bwd_ms"],
        "wrapper_ms": row["wrapper_ms"],
        "plain_wrapper_ms": row["plain_wrapper_ms"], "shape": row["shape"],
        "errors": row["errors"], "tolerances": row["tolerances"],
        "same_inputs_err": row["same_inputs_err"],
        "other_shapes": [{k: r[k] for k in
                          ("shape", "max_abs_err", "ms", "plain_ms",
                           "wrapper_ms", "fwd_bwd_ms", "library_ms",
                           "library_bwd_ms", "library_backend",
                           "library_wrapper_ms", "split_us",
                           "bound_ms", "bound_by", "errors", "tolerances",
                           "same_inputs_err", "lse_ms")}
                         for r in rows[1:]],
        "training": {k: v for k, v in train.items() if k != "launches"},
        "training_moe": {k: v for k, v in moe_train.items()
                         if k != "launches"},
        "training_zamba": {k: v for k, v in zamba_train.items()
                           if k != "launches"},
        "training_whisper": {k: v for k, v in whisper_train.items()
                             if k != "launches"},
        "training_internvl2": {k: v for k, v in vlm_train.items()
                               if k != "launches"},
        "float32": [{k: r[k] for k in
                     ("shape", "max_abs_err", "errors", "tolerances", "ms",
                      "plain_ms", "wrapper_ms", "fwd_bwd_ms", "library_ms",
                      "library_backend", "library_wrapper_ms", "split_us",
                      "bound_ms", "bound_by")}
                    for r in bwd_f32],
        "supervisor": supervised,
        "ptxas": dict(ptxas.get("flash_attention_bwd", [])),
        "hgmma_instructions": sass["bwd_tensor_core_instructions"],
    })
    # the scan's backward: float32 is the training path's dtype; its
    # launches are falcon-mamba-7b's training run (phase 13 (b))
    rows = mamba_kernels["selective_scan_bwd"]
    row = rows[0]
    summary.append({
        "name": "selective_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/selective_scan_bwd.cu",
        "replaces": ("none: the reference differentiates "
                     "_selective_scan_chunked, src/repro/models/mamba.py:69"),
        "launches": mamba_train["launches"]["selective_scan_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes" if row["bound_by"] == "bytes" else "operations",
        "bound_term": row["bound_by"], "library_ms": None,
        "wrapper_ms": row["wrapper_ms"],
        "plain_wrapper_ms": row["plain_wrapper_ms"], "shape": row["shape"],
        "errors": row["errors"], "tol": row["tol"],
        "split_us": row["split_us"],
        "first_version_ms": row["first_ms"], "turns_ms": row["turns_ms"],
        "resident_blocks": occupancy,
        "mufu_ex2": sass["scan_bwd_ex2"],
        "forward_ms": {"without_states": row["fwd_ms"],
                       "with_states": row["fwd_states_ms"],
                       "with_states_wrapper": row["fwd_states_wrapper_ms"]},
        "other_shapes": [{k: r[k] for k in
                          ("shape", "max_abs_err", "errors", "ms", "fwd_ms",
                           "fwd_states_ms", "plain_ms", "wrapper_ms",
                           "split_us", "first_ms", "turns_ms", "bound_ms",
                           "bound_by")}
                         for r in rows[1:]],
        "training": {k: v for k, v in mamba_train.items() if k != "launches"},
        "ptxas": dict(ptxas.get("selective_scan_bwd", [])),
    })
    for entry in summary:
        if entry["name"] == "flash_attention":
            entry["lse_forward"] = [{k: r[k] for k in ("shape", "lse_ms",
                                                       "lse_err", "fwd_err")}
                                    for r in train_kernels[
                                        "flash_attention_bwd"] + later]
            entry["launches_training"] = {
                a: t["launches"]["flash_attention"] for a, t in trained}
            entry["arctic"] = arctic
            entry["whisper"] = whisper
        if entry["name"] == "selective_scan":
            entry["launches_training"] = \
                mamba_train["launches"]["selective_scan"]
            entry["ptxas"] = dict(ptxas.get("selective_scan", []))
    for entry in summary:
        name = entry["name"]
        entry["phase10_launches"] = {
            p: counts[name] for p, counts in telemetry["launches"].items()
            if counts.get(name)}
        entry["phase11_launches"] = {
            p: counts[name] for p, counts in analysis["launches"].items()
            if counts.get(name)}
        entry["audit"] = {k: analysis["audit"][name][k] for k in
                          ("peak_bytes", "budget_bytes", "max_abs_err")}
    print("[telemetry] summary " + json.dumps(
        {k: v for k, v in telemetry.items() if k != "launches"}))
    print("[analysis] summary " + json.dumps(
        {k: v for k, v in analysis.items() if k != "launches"}))
    print(f"[total] chip_smoke wall_s={time.perf_counter() - T_START!r}")
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
