#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run on a wrong result:

1. build the segmax, wastage, rangemax, compaction, fitstats, scan,
   admission, admission_epoch, moe_dispatch, moe_combine, moe_combine_bwd,
   rglru_scan, rglru_scan_bwd, flash, flash_bwd, rwkv_wkv and rwkv_wkv_bwd
   kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. hold segmax and wastage against their plain PyTorch versions on the
   card, at the shapes of the largest bucket of the grid (peaks and fail
   indices exact, float32 wastage within rtol 1e-5 / atol 1e-4 GiB*s, the
   float64-summed instantiations within rtol 1e-9 / atol 1e-9), and time both
   (segmax also profiled, beside its bound and the block-per-row kernel's
   time before it); segmax also
   exact on its edge cases (lengths 0, below k_eff and not a multiple of 4,
   odd T, an unaligned row base, k_max 1 / 15 / 128, rows sharing a
   series); then the bucket's whole replay, every row's retry
   ladder in one wastage launch, against the plain loop of rounds, with the
   totals and with recorded ladders (32 attempts), in f32/f32, f32/f64 and
   f64/f64 (values, failure indices, retries and attempt counts exact,
   waste within the same gates), timed, profiled and beside its bound;
2b. the scan kernel (every running sum of the engine's predict phase)
   bitwise against ``scan.cumsum`` in both of its orders (sequential, and
   XLA's blocks of 16) in f32 and f64, at n = 1 to 20,000 and 60,000 (past
   the shared memory) and on a non-contiguous input; then at each of the
   predict phase's calls at the grid's largest bucket (the bank (4, 1,536,
   5) and PPM-improved's contrib (4, 1,536, 1,536) along axis 1, PPM's C and
   S along axis 2, Sizey's scores (2, 4, 2, 1,536) along the last axis, the
   fold (4, 1,536, 25) in order along the executions) in f32 and f64,
   bitwise and timed (CUDA events, profiled device time) beside its bound,
   the plain version's and ``torch.cumsum``'s time, the fold also beside
   its latency bound from the card's measured add latency
   (``tools/scan_clocks.py``); and ``predict_lanes`` at the largest bucket
   must dispatch fewer aten ops that launch than the bucket has executions
   (counted at dispatch, beside the count with the plain scan);
3. the paper's Fig. 7 grid (all eight methods) at full corpus size on the
   card (cold and warm), with the launch counts of that run, held against
   the port's own CPU run (every Fig. 7a cell within rtol 1e-3), the
   profiled run's launches and predict-phase host time beside the chains';
4. the Fig. 8 k-sweep (k = 1..15) on a sawtooth and a ramp/staged task, on
   the card against the CPU;
5. the cluster scheduler (Sec. IV-E) at the standard configuration, uncut:
   windows, sweep and auto placement, cold then warm, all giving the same
   (node, start, end) for every attempt, equal to the port's own CPU run,
   each run launching the kernels of its engine (counted per run: rangemax
   on windows, compaction on the sweep, segmax and wastage on both, wastage
   once per replay); one profiled warm windows run and one sweep run (each
   wall beside its total launches, the sweep's beside its total before
   the fold was one launch); the
   ``auto`` router's four constants;
6. rangemax and compaction against their plain versions on the card
   (bit-exact), at the shapes of phase 5 and at L = 256, 1024, 8192, in
   float64 and float32, and timed: the fit tables (running demand, tie
   mask and table in one launch, as the epoch program calls them) bitwise,
   also at L = 20,000 (the global-memory path), and profiled at the
   cluster's most frequent shape; compaction alone profiled at the sweep's
   shape; the sweep's chunk-boundary fold (fold, shift, keep mask,
   compaction and masked running demand in one compaction launch) bitwise,
   also past the shared memory (f64 L = 20,000, f32 L = 40,000), profiled
   at the sweep's most frequent shape, where ``device_timeline.
   _fold_and_compact`` must be one launch and at most one aten op that
   launches (counted at dispatch, beside the plain chain's count);
7. flash against its plain version on the card, in float32 (atol 3e-5,
   rtol 1e-4, the reference's kernel tolerance) and bf16 on N(0, 1) inputs
   (max |d| <= 1e-2, mean |d| <= 1e-3: p is rounded to bf16 after a running
   max that depends on the tiling), on the reference's five FLASH_CASES
   geometries at hd 64, a wave of the launcher's loop at llama3.2-3b's
   widths (prefill of B 4, T = S = 47, and decode against a ragged 63-slot
   cache), rows with no valid key (a causal prefill whose first queries
   precede every key, a decode whose window excludes every filled slot;
   S = 141, G = 3), wrapped rolling caches (hd 128 and 256, and a 40-query
   chunk), a causal prefill at S = 4,096 + 37, llama3.2-3b's prefill
   (B 2, T = S = 4096) and decode (T 1 against a ragged 4112-slot cache),
   and gemma2-9b's widths (T = S = 8192, hd 256, window 4096, softcap 50);
   each case prints the kernel's path, decode's splits and the share of KV
   tiles skipped; the last three are timed (CUDA events, and the profiled
   device time of each of the call's launches) against the plain version
   and against ``scaled_dot_product_attention`` (the yardstick only; it
   cannot take softcap);
8. serving at the full width and depth of llama3.2-3b (bf16, random
   weights from seed 0): (a) the launcher's wave loop with its defaults
   (24 requests, 16 decode steps, 512 MiB budget), every request served,
   every token in the vocabulary, flash launched in that run; (b) one batch
   of 2 x 4096-token prompts, 16 greedy tokens: prefill wall, ms per decode
   step, tokens/s, and one profiled run (flash's device time by kernel);
   (c) prefill + ``decode_step``
   against ``forward`` on T + 1 tokens, last logits within 2e-2 x
   max |logits|; (d) (b)'s prefill, and one of a second prompt, with the
   plain attention patched in, last logits within 2e-2 x max |logits| of
   the kernel's;
9. fitstats through the kernels API (``repro_torch.kernels.fit_stats``)
   against its plain version, each statistic within 1e-5 of the sum of the
   absolute values of its terms, two launches bitwise equal, and timed:
   (a) ``benchmarks/run.py:bench_kernels``' batch (B 512, T 2048, k 4, seed
   0, weights all ones); (b) the main path: for every eligible task of the
   corpus and k = 1..15, the bank over its executions (u = x - x_first,
   peaks from the API's ``segment_peaks``), with the launches of that run,
   each bank also within 1e-4 of the host ``KSegmentsModel``'s float64
   ``seg_stats``; (c) 2**20 rows at k = 128 with random weights;
10. ``segment_peaks`` and ``attempt_wastage`` through the kernels API on
   (a)'s batch against their plain versions (peaks and fail indices exact,
   wastage as in phase 2);
11. the online predictor path: ``AdaptiveKSelector`` on the card over the
   first 512 executions of the corpus' largest task (32 reoptimisations of
   6 candidates, each a replay through segmax and wastage), its
   ``history_k`` equal to its CPU run's, and one profiled run (wall and
   total launches, beside the chains'); and ``simulate_grid`` on the card
   against the sequential oracle ``simulate_suite`` (scale 0.35,
   progressive offsets, all nine engine methods, fraction 0.5) under the
   reference's gate (``tests/test_batch_engine.py:36-47``) on every cell;
12. serving admission: ``benchmarks/run.py:bench_serve``'s three streams
   (400 requests, seed 0: poisson at 8/s; bursty at 40/s, burst factor 8,
   150,000 MiB; diurnal at 12/s, amplitude 0.8, 80,000 MiB) through
   ``run_stream`` on ``"scalar"``, ``"batched"`` (its default
   ``device_min_batch`` of 32, and 1, so every batch of two or more goes
   through the decision kernel), ``"sharded-scalar"`` and ``"sharded"``
   (4 shards): counts, decisions/s, p50/p99, wastage, kernel launches and
   batches by path of each run; the batched runs' decisions must equal the
   scalar oracle's, and every decision-kernel call of those runs the plain
   loop's on the same inputs; the sharded runs' decisions must equal the
   per-shard oracle's, with no reseed and exactly one admission_epoch
   launch per decision batch; then bench_serve's microbench (batches of 256
   against 256 and 1,024 resident plans; the sharded engine at 8 shards,
   with its carried speedup over the batched one, its reseeds and the aten
   ops that launch in one warm batch), the decision kernel at its shape
   (1,024 resident) against the plain loop (admits equal) and its bound,
   timed, and the admission_epoch kernel at the sharded engine's shape
   (1,024 resident) against its plain version (admits, overflow, live
   counts and the whole new state bit for bit) and its bound, timed; beside
   each, the probes a candidate's window and commit range hold (mean and
   maximum) and the build's registers and spills; then both kernels again,
   checked and timed, at the largest poisson batch the stream sweep
   captured;
13. MoE serving at the full width of qwen3-moe-235b-a22b (d_model 4,096,
   64/4 heads of 128 with q/k norm, 128 experts top-8 of d_ff 1,536, vocab
   151,936), its depth cut to 8 of 94 layers (one layer's experts are 4.83
   GB of bf16), bf16, random weights from seed 0, the llama model of phase
   8 freed before: (a) the launcher's wave loop with its defaults, every
   request served, every token in the vocabulary, flash, moe_dispatch and
   moe_combine each launched in that run; (b) one batch of 2 x 4096-token
   prompts, 16 greedy tokens: prefill wall (median of 3), ms per decode
   step and tokens/s (medians of 5), greedy tokens identical across the
   repeats, and one profiled run (device time of flash, the two MoE
   kernels and the products); (c) the cache contract (as phase 8) at
   capacity factor E / k = 16, where nothing can be dropped (at the
   config's 1.25 a decode step and forward on T + 1 tokens drop different
   assignments, and these random weights load an expert past the
   reference tests' 8.0), with the decode's routes pinned to forward's (a
   near-tie may route apart between two bf16 paths), and unpinned wherever
   no route fell apart; (d) at 1.25, the prefill with plain flash,
   dispatch and combine, its routes pinned to the kernels' (and unpinned
   where none fell apart), last logits within 2e-2 x max |logits| of the
   kernels'; (e) both kernels bit for bit against
   their plain versions, with tokens dropped, at qwen3-moe's prefill (N
   8,192, E 128, k 8, C 641, D 4,096) and decode (N 2, C 1) shapes and
   grok-1-314b's widths (E 8, k 2, D 6,144, N 8,192, C 2,561), each timed
   (CUDA events and profiled device time) beside its bound, its plain
   version and a yardstick (``index_select`` of the rows given the slot
   table; ``index_add_`` of the weighted rows, which adds in another
   order); a dispatch call must be exactly one device launch (counted from
   the profiler's events), and its bound counts the rows of the tokens
   with a kept assignment (printed beside the count with every row, and
   beside the card's write and copy rates over a buffer of buf's size);
14. the recurrent mixers at full width and depth, bf16, random weights from
   seed 0, phase 13's model freed before: rwkv6-1.6b (24 rwkv layers,
   d_model 2,048, 32 heads of 64, d_ff 7,168, vocab 65,536) and
   recurrentgemma-2b (26 layers, 18 rglru and 8 local, d_model and rnn
   width 2,560, window 2,048, 10 / 1 heads of 256, vocab 256,000), each
   through phase 8's (a)-(d): (a) the launcher's wave loop, every request
   served, rwkv_wkv (rwkv) or rglru_scan and flash (recurrentgemma)
   launched in that run; (b) prefill wall (median of 3), ms per decode
   step and tokens/s (medians of 5; each decode repeat from a copy of the
   prefill's cache, whose recurrent state a step overwrites), greedy
   tokens identical across the repeats, a profiled greedy_generate (device
   time of each kernel, of the products and of the rest) and a profiled
   decode (busy share, launches a step, flash's decode calls); (c) the
   cache contract within 2e-2; (d) the plain WKV, RG-LRU and flash against
   the kernels, last logits within 2e-2 x max |logits|; then (e) each
   kernel against its plain version at the prefill (B 2, T 4,096) and
   decode (T 1, a nonzero state) shapes of both models' widths and at B 3,
   T 1,000: WKV within 1e-4 of max |o| and of max |S| (the token order
   against the reference's chunk form), RG-LRU bit for bit; exactly one
   device launch a call (from the profiler's events), CUDA-event and
   profiled device time beside the bound and the plain version's time (no
   library yardstick: no single PyTorch call runs either recurrence).
15. the modality frontends, bf16, random weights from seed 0, phase 14's
   models freed before: (a) hubert-xlarge at full width and depth (48
   layers, d_model 1,280, 16 heads of 80, non-causal, d_ff 5,120, vocab
   504, 512-dim frames) encoding B 8 x 1,500 seeded N(0, 1) frames (eight
   30-s clips at 50 frames a second): encode wall (median of 3) and
   frames/s, one flash launch a layer, logits finite of shape (8, 1,500,
   504) and the same across the repeats, ``make_prefill_step``'s logits
   forward's last position, a new last frame moving the first frame's
   logits (non-causal), a profiled encode (device time of flash, the
   products and the rest), the plain attention within 2e-2 x max
   |logits| with the weights in float32 and within max(2e-2, twice the
   bf16 encode's distance from the float32 one) in bf16; (b) qwen2-vl-72b
   at full width (d_model 8,192, 64/8 heads of 128, d_ff 29,568, vocab
   152,064, M-RoPE sections (16, 24, 24)), its
   depth cut to 16 of 80 layers (a layer is 1.755 GB of bf16), B 2 x 4,096
   tokens whose first 256 carry seeded patch embeddings (one 448 x 448
   image: a 16 x 16 grid of merged patches) with Qwen2-VL's M-RoPE rows
   (image tokens (0, row, col), text from 16 on all three rows, decode
   steps after it; the cache's positions the sequence's): prefill wall
   (median of 3), ms per decode step and tokens/s (medians of 5) through
   ``make_prefill_step`` / ``make_decode_step``, 16 greedy tokens the same
   across the repeats, one flash launch a layer call, a profiled prefill
   and decode (flash, products, rest, busy share, launches a step); (c)
   the cache contract within 2e-2 (every cache holding the sequence
   positions); (d) the plain attention in (b)'s prefill within 2e-2; (e)
   the sequence index on all three M-RoPE rows moving the last logits by
   more than (d)'s distance; (f) flash alone at the three new shapes
   (hubert's prefill, qwen2-vl's prefill and its G = 8 decode over a
   ragged 4,112-slot cache) as phase 7, beside the bound, the plain
   version and SDPA.
16. training, bf16, random weights from seed 0, phase 15's models freed
   before: (a) ``repro_torch.launch.train`` with its defaults (reduced
   llama3.2-3b, B 8 x T 128) on the card, 30 steps with a failure injected
   at step 12: exactly one restart, step 30, finite losses, flash and
   flash_bwd launched; (b) llama3.2-3b at full width and depth (28 layers,
   3.213 B parameters, bf16 weights, f32 moments, remat, the reference's
   ``OptimizerConfig`` defaults) on B 2 x T 4,096 of ``SyntheticLMData``:
   six steps (the first a warm-up; walls, median of the other five,
   tokens/s, peak memory against the card's), loss and grad_norm finite at
   every step, the first step's ce within 1e-2 relative of ``forward``'s
   logits' cross-entropy on the same batch, 56 flash and 28 flash_bwd
   launches a step, every parameter moved (a sample of each), one profiled
   step split into products, flash forward and backward, cross-entropy,
   optimizer and the rest (busy share, launches), then three steps with
   ``accum_steps`` 2; (c) the gradients through the kernels against those
   through the plain attention (``ops.flash_attention`` patched), at full
   width on 2 layers, every parameter's within 2e-2 of its max |g| with
   float32 weights, and within max(2e-2, twice the bf16 run's distance from
   the float32 one) with bf16 weights; (d) flash_bwd alone at llama's (B 2,
   T 4,096, 24/8, hd 128, causal), gemma2-9b's (B 1, T 8,192, 16/8, hd
   256, window 4,096, softcap 50), hubert's (B 8 x 1,500, 16/16, hd 80,
   non-causal) and qwen2-vl's (B 2 x 4,096, 64/8, hd 128) shapes, dq, dk
   and dv within 2e-2 (bf16) and 1e-4 (f32) of max |plain|, timed (CUDA
   events and profiled device time) beside the plain backward, SDPA's
   backward (a yardstick only; none under softcap) and the bound (2.5
   times the forward's 4 hd flops a valid pair at the bf16 rate, or the
   bytes, whichever is larger); (e) qwen3-moe-235b-a22b at full width
   (d_model 4,096, 64/4 heads of 128, 128 experts top-8, expert d_ff
   1,536, vocab 151,936, capacity 1.25, remat), depth cut to 1 of 94
   layers (3.733 B parameters: two layers with their moments do not fit
   beside the activations), on (b)'s batch shape: a warm-up and three
   timed steps (walls, tokens/s, peak memory), loss and grad_norm finite,
   the first step's ce within 1e-2 of ``forward``'s, every parameter moved
   with a nonzero first moment (the router and the three expert tensors
   among them), launches a step and layer flash 2, flash_bwd 1,
   moe_dispatch 2, moe_combine 3 (two forwards and the dispatch's
   backward) and moe_combine_bwd 1, one profiled step split as (b)'s with
   the MoE kernels' forward and backward apart; (f) ``layers.moe``'s
   gradients (dx, router, wi, wg, wo) through the kernels against those
   through the plain dispatch and combine, at full width on x (2, 4,096,
   4,096) with a random cotangent and 0.01 on aux, as (c) (the forward
   is bit for bit on both paths, so their routes agree; the plain path
   launches no MoE kernel); (g) ``moe_combine_bwd`` and the dispatch's
   backward (a combine launch with unit weights) alone at phase 13's
   three shapes: d_out_buf and dxf bit for bit against the plain versions
   and from run to run, dw within one bf16 ulp, timed beside the bound,
   the plain versions and the yardsticks (``index_copy_`` of the weighted
   rows for the slot part; no single call also gives dw); (h) rwkv6-1.6b
   and (i) recurrentgemma-2b at full width and depth (remat) on (b)'s
   batch shape, each as (e): a warm-up and three timed steps, the same
   gates, launches a step rwkv6 48 rwkv_wkv and 24 rwkv_wkv_bwd (each
   the state pass, the chunks and du's sum on the device; the forward
   that autograd records writes the backward's checkpoints),
   recurrentgemma 36 rglru_scan, 18 rglru_scan_bwd, 16 flash and 8
   flash_bwd, one profiled step split as (b)'s with the recurrent kernels'
   forward and backward apart; (j) both models' gradients through the
   recurrent kernels against those through the plain recurrences
   (``ops.rwkv_wkv`` / ``ops.rglru_scan`` patched), at full width on 2
   (rwkv6) and 3 (recurrentgemma: two rglru layers and a local one) layers,
   as (c); (k) ``rwkv_wkv_bwd`` and ``rglru_scan_bwd`` alone at phase 14's
   shapes (each model's own, the other's widths, B 3 x T 1,000, decode's
   T 1; the WKV's fed by the forward's checkpoints): the RG-LRU's bit for
   bit, the WKV's within 1e-4 of each output's max |plain|, both bit for
   bit from run to run, timed (CUDA events and profiled device time,
   launch by launch) beside the bound (the WKV's products at TF32's rate)
   and the plain version (no single PyTorch call runs a reverse linear
   recurrence);
17. the port's tooling on the card (``repro_torch.analysis.trace_audit``,
   ``repro_torch.launch.roofline``): (a) one warm ``simulate_grid`` at
   phase 3's configuration under ``no_rebuilds``: no kernel library built
   or loaded, every kernel launched as often as in phase 3's cold run (13
   segmax, 13 wastage), then a second warm run that must dispatch as many
   launching aten ops as the first; its read-backs and uploads printed;
   (b) every floating result of the cluster's placement programs (the
   windows engine's epoch program, with its rangemax launches, and the
   sweep's chunk-boundary fold, one compaction launch) float64
   (``check_dtypes``), on one policy of phase 5's standard configuration
   at 20 tasks a type (of 120); (c) the roofline of phase 16 (b)'s
   llama3.2-3b step, counted at dispatch on one more step: 6ND, the counted
   flops and bytes, flash's and flash_bwd's launches listed as not
   counted (their work goes through ctypes), the MFU at (b)'s median step
   wall beside the card's name and power limit.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero without
a card, or when anything disagrees.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NoReturn

CORPUS_SCALE = 1.0  # the paper's corpus: 33 eligible tasks
FIG8_KS = tuple(range(1, 16))
GRID_KERNELS = ("segmax", "wastage", "scan")  # the kernels of the engine's paths
# Earlier designs' figures, printed beside this run's (NVIDIA H100 80GB HBM3,
# 700 W): segmax and compaction as a block per row, profiled at the shapes
# this script times them at, and the warm sweep run's profiled launches
# while its chunk-boundary fold was a chain of small ops
SEGMAX_BLOCK_PER_ROW_MS = 0.0206  # 6,144 rows of T 2,048, k 4
COMPACTION_BLOCK_PER_ROW_MS = 0.0028  # (64, 1,024) f64
SWEEP_CHAIN_LAUNCHES = 906_000
# The profiled runs while the predict phase's running sums were chains of
# small ops (the same card and limit; the grid then ran six methods): the
# warm grid's and the tuner's total launches and their torch_sim.predict
# host ms
GRID_CHAIN_LAUNCHES, GRID_CHAIN_PREDICT_MS = 11_043, 230.76
TUNER_CHAIN_LAUNCHES, TUNER_CHAIN_PREDICT_MS = 80_595, 1_888.4


def _ptxas_summary(log: str) -> list[tuple[str, str, str]]:
    """(kernel, registers, spills) of each entry function in an
    ``nvcc -Xptxas -v`` log, names demangled with the toolkit's cu++filt."""
    rows, name, spills = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip().split(", ", 1)[-1]
        elif "Used" in line and "registers" in line:
            rows.append([name, re.search(r"Used (\d+) registers", line).group(1), spills])
    filt = shutil.which("cu++filt") or str(Path(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc").parent / "cu++filt")
    if rows and Path(filt).exists():
        names = subprocess.run([filt], input="\n".join(r[0] for r in rows), capture_output=True, text=True).stdout
        for r, n in zip(rows, names.splitlines()):
            for noise in ("(int)", "(bool)", "<unnamed>::", "(anonymous namespace)::", "void "):
                n = n.replace(noise, "")
            r[0] = n.split("(")[0]
    return [tuple(r) for r in rows]


def _fail(msg: str) -> NoReturn:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after a warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _wall(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profile(fn) -> dict:
    """One ``fn()`` under torch.profiler: wall time, device time of the
    kernels and of the copies, kernel launches, the engines' phases (host
    time, and device span of their annotations) and the busiest kernels
    with their launch counts.  Reads the profiler's raw event list: a
    cluster run has over a million launches, too many for its Python-side
    event tree."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _wall(fn)
    cuda = torch.autograd.DeviceType.CUDA
    phases_host: dict[str, float] = {}
    phases_device: dict[str, float] = {}
    device: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        name, ms = e.name(), e.duration_ns() / 1e6
        if name.startswith(("torch_sim.", "cluster.")):
            into = phases_device if e.device_type() == cuda else phases_host
            into[name] = into.get(name, 0.0) + ms
        elif e.device_type() == cuda:
            acc = device.setdefault(name, [0.0, 0])
            acc[0] += ms
            acc[1] += 1
    copies = {n: v for n, v in device.items() if n.startswith(("Memcpy", "Memset"))}
    kernels = {n: v for n, v in device.items() if n not in copies}
    return dict(
        wall_s=wall,
        kernel_ms=sum(v[0] for v in kernels.values()),
        copy_ms=sum(v[0] for v in copies.values()),
        launches=sum(v[1] for v in kernels.values()),
        phases_host_ms=phases_host,
        phases_device_ms=phases_device,
        top=sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6],
        top_all=list(kernels.items()),
    )


def _device_ms(call, kernel, n: int) -> float:
    """The profiled device time of one ``call()``: ``n`` calls under the
    profiler, the time of the launches named ``*kernel*`` (a name, or a
    tuple of names) over the calls the profiler kept (it drops the first
    twenty or so device events of a window; one call is one launch of the
    kernel)."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    for _ in range(3):  # a window whose device events the profiler all dropped is taken again
        prof = _profile(lambda: [call() for _ in range(n)])
        hits = [v for name, v in prof["top_all"] if any(k in name for k in names)]
        if hits:
            break
    return sum(v[0] for v in hits) / max(sum(v[1] for v in hits), 1)


def _ladder_bound(valid, rows_series, attempts, k: int, vsize: int, asize: int, slots: int) -> tuple[float, str]:
    """The retry ladder's bound, the sum of the bounds of its rounds when
    each round is one launch: in every round, each distinct series that one
    of its rows still scores is read once (the method rows of an execution
    share it); each row's schedule is read once and its outputs written
    once, at the HBM rate.  ``valid`` (S,) holds each series' samples."""
    import torch

    from repro_torch.launch import roofline

    rounds = torch.zeros_like(valid, dtype=torch.int64).scatter_reduce_(
        0, rows_series.long(), attempts.to(torch.int64), "amax")
    series_bytes = 4 * (rounds * valid.to(torch.int64)).sum().item()
    R = rows_series.numel()
    out_bytes = R * (asize + 4) + (R * (slots * (k * vsize + 4 + asize) + 4) if slots else 0)
    return roofline.bound_ms(series_bytes + R * 2 * k * vsize + out_bytes, 0)


def ladder_phase(y, lengths, series, bounds, values, k_eff, methods, cap_mib, kc) -> dict:
    """The retry-ladder kernel against the plain loop of rounds on the card,
    in both modes (the grid's totals; the cluster's recorded ladders, 32
    attempts) and the three precisions: values, failure indices, retries
    and attempt counts exact, waste within the wastage gates."""
    import torch

    from repro_torch.analysis import trace_audit
    from repro_torch.core.predictor import retry_flags
    from repro_torch.kernels import wastage
    from repro_torch.sim import torch_sim

    sel, cap = retry_flags(methods)
    N, B, M, k = values.shape
    rows_series = series.reshape(-1).repeat_interleave(M)
    valid = torch.clamp(lengths.to(torch.int64), max=y.shape[1])
    out = {}
    for vdt, acc in ((torch.float32, torch.float32), (torch.float32, torch.float64), (torch.float64, torch.float64)):
        bb, vv = bounds.to(vdt), values.to(vdt)
        tol = dict(rtol=1e-5, atol=1e-4) if acc == torch.float32 else dict(rtol=1e-9, atol=1e-9)
        for slots in (None, 32):
            kw = dict(interval_s=kc.interval_s, factor=kc.retry_factor, cap_mib=cap_mib, max_attempts=slots,
                      acc_dtype=acc)
            args = (y, lengths, series, bb, vv, k_eff, sel, cap)
            got = wastage.replay_ladder_cuda(*args, **kw)
            want = wastage.replay_ladder_plain(*args, **kw)
            torch.cuda.synchronize()
            name = f"ladder {str(vdt)[6:]}/{str(acc)[6:]} {'recorded (32 slots)' if slots else 'totals'}"
            exact = [("retries", got[1], want[1])]
            if slots:
                exact += [(n, g, w) for n, g, w in zip(("values", "failure indices"), got[2][:2], want[2][:2])]
                exact.append(("attempt counts", got[2][3], want[2][3]))
            for what, g, w in exact:
                if not torch.equal(g, w):
                    _fail(f"{name}: {(g != w).sum().item()} {what} differ from the plain loop")
            for what, g, w in [("waste", got[0], want[0])] + ([("attempt waste", got[2][2], want[2][2])] if slots else []):
                if not torch.allclose(g, w, **tol):
                    _fail(f"{name}: {what} off the plain loop by {(g - w).abs().max().item()} GiB*s beyond {tol}")
            ms = _cuda_ms(lambda: wastage.replay_ladder_cuda(*args, **kw), 20)
            plain_ms = _cuda_ms(lambda: wastage.replay_ladder_plain(*args, **kw), 2)
            device_ms = _device_ms(lambda: wastage.replay_ladder_cuda(*args, **kw), "wastage_kernel", 30)
            attempts = got[2][3] if slots else (got[1] + 1)
            bound_ms, bound_by = _ladder_bound(valid, rows_series, attempts, k, bb.element_size(),
                                               torch.finfo(acc).bits // 8, slots or 0)
            if slots is None or acc == torch.float64:  # the grid's call, and the cluster's
                before = wastage.launches
                site = trace_audit.launching_ops(lambda: torch_sim._replay(
                    y, lengths, series, bb, vv, k_eff, methods=methods, interval_s=kc.interval_s,
                    factor=kc.retry_factor, cap_mib=cap_mib, max_attempts=slots, acc_dtype=acc))
                if wastage.launches != before + 1 or site:
                    _fail(f"{name}: torch_sim._replay took {wastage.launches - before} wastage launches and "
                          f"{site} aten ops that launch, where it should take one launch and nothing else")
                plain = trace_audit.launching_ops(lambda: wastage.replay_ladder_plain(*args, **kw))
                print(f"  {name}: torch_sim._replay is 1 wastage launch and 0 aten ops that launch; "
                      f"the plain loop dispatches {plain} aten ops that launch")
            print(f"  {name}: {N * B * M} rows, {int(attempts.sum())} attempts (max retries "
                  f"{int(got[1].max())}): exact, max |dw| {(got[0] - want[0]).abs().max().item():.3e} GiB*s; "
                  f"kernel {ms:.4f} ms back to back, profiled device {device_ms:.4f} ms a replay, plain loop "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
            out[(vdt, acc, slots)] = dict(max_abs_err=(got[0] - want[0]).abs().max().item(), ms=ms,
                                          plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                          device_ms=device_ms)
    return out


def segmax_edges(dev) -> None:
    """segmax against its plain version, exact, where its loads and loops
    change course: lengths 0, below k_eff and not a multiple of 4, odd T
    and a row base off 16 bytes (scalar loads), k_max 1 / 15 / 128 (128: four
    chunks of 32 segments), k_eff below 1 and past k_max, and rows that
    share a series."""
    import numpy as np
    import torch

    from repro_torch.core.segmentation import segment_peaks_dynamic
    from repro_torch.kernels import segmax

    rng = np.random.default_rng(3)
    S, cases = 40, 0
    for T, offset in ((2048, 0), (2047, 0), (63, 0), (2048, 1)):
        y = (rng.random(S * T + offset) * 4000.0 + 10.0).astype(np.float32)
        lengths = rng.integers(0, T + 1, size=S).astype(np.int32)
        lengths[:8] = [0, 1, 2, 3, 5, 7, T - 1, T]
        yt = torch.from_numpy(y).to(dev)[offset:].view(S, T)
        lt = torch.from_numpy(lengths).to(dev)
        series = torch.arange(S, dtype=torch.int32, device=dev).repeat(3)
        for k_max in (1, 15, 128):
            k_eff = torch.from_numpy(rng.integers(-1, k_max + 3, size=3 * S).astype(np.int32)).to(dev)
            k_eff[:3] = torch.tensor([k_max, 0, 1], dtype=torch.int32)
            got = segmax.segmax_cuda(yt, lt, series, k_eff, k_max)
            want = segment_peaks_dynamic(yt[series], lt[series], k_eff, k_max)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                _fail(f"segmax edge case T={T} offset={offset} k_max={k_max}: {(got != want).sum().item()} peaks "
                      "differ from the plain version")
            cases += 1
    print(f"  segmax edge cases: {cases} exact (lengths 0 / < k_eff / odd, T 2048 / 2047 / 63, an unaligned base, "
          "k_max 1 / 15 / 128, k_eff -1 to k_max + 2, rows sharing a series)")


def kernels_phase(batch, cfg, dev) -> dict[str, dict]:
    """Each kernel against its plain version at the largest bucket's shapes."""
    import torch

    from repro_torch.core.allocation import attempt_outcomes_batch
    from repro_torch.core.segmentation import segment_peaks_dynamic
    from repro_torch.kernels import segmax, wastage
    from repro_torch.launch import roofline
    from repro_torch.sim import torch_sim
    from repro_torch.sim.batch_engine import GRID_METHODS

    L, B, T = batch.shape
    S = L * B
    y = torch.as_tensor(batch.y.reshape(S, T)).to(dev)
    lengths = torch.as_tensor(batch.lengths.reshape(S)).to(dev)
    series = torch.arange(S, dtype=torch.int32, device=dev)
    valid = torch.clamp(lengths.to(torch.int64), max=T)
    out = {}

    print(f"kernels phase: largest bucket L={L} B={B} T={T} ({batch.y.nbytes / 1e6:.1f} MB of series)")
    segmax_edges(dev)
    for k_max, k_eff in (
        (cfg.ksegments.k, torch.full((S,), cfg.ksegments.k, dtype=torch.int32, device=dev)),
        (15, (torch.arange(S, device=dev) % 15 + 1).to(torch.int32)),
    ):
        got = segmax.segmax_cuda(y, lengths, series, k_eff, k_max)
        want = segment_peaks_dynamic(y[series], lengths[series], k_eff, k_max)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            _fail(f"segmax k_max={k_max}: {(got != want).sum().item()} peaks differ from the plain version")
        ms = _cuda_ms(lambda: segmax.segmax_cuda(y, lengths, series, k_eff, k_max), 50)
        plain_ms = _cuda_ms(lambda: segment_peaks_dynamic(y[series], lengths[series], k_eff, k_max), 5)
        device_ms = _device_ms(lambda: segmax.segmax_cuda(y, lengths, series, k_eff, k_max), "segmax_kernel", 40)
        # bytes: each valid sample read once, the lengths, series and k_eff,
        # the peaks written once; operations: one compare a sample
        nbytes = 4 * valid.sum().item() + 4 * 3 * S + 4 * S * k_max
        bound_ms, bound_by = roofline.bound_ms(nbytes, valid.sum().item())
        print(f"  segmax k_max={k_max}: exact; kernel {ms:.4f} ms back to back, profiled device {device_ms:.4f} ms "
              f"(a block per row: {SEGMAX_BLOCK_PER_ROW_MS} ms at k_max 4), bound {bound_ms:.5f} ms ({bound_by}), "
              f"plain {plain_ms:.4f} ms")
        if k_max == cfg.ksegments.k:  # the main path's shape
            out["segmax"] = dict(max_abs_err=(got - want).abs().max().item(), ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by, device_ms=device_ms)

    # one attempt per row (the kernels API's call) on the first replay round
    # of the bucket: every method row of every non-empty execution, with the
    # engine's own predictions
    kc = cfg.ksegments
    x = torch.as_tensor(batch.x, dtype=torch.float32).to(dev)
    bounds, values = torch_sim.predict_lanes(
        x - x[:, :1], y, lengths, series.view(L, B), torch.as_tensor(batch.default_mib, dtype=torch.float32).to(dev),
        torch.full((L,), kc.k, dtype=torch.int32, device=dev), methods=GRID_METHODS, k=kc.k,
        interval_s=kc.interval_s, floor_mib=kc.floor_mib, cap_mib=cfg.node_cap_mib, error_mode=kc.error_mode,
        insample_window=kc.insample_window,
    )
    M, k = len(GRID_METHODS), kc.k
    rows = torch.nonzero(lengths.repeat_interleave(M) > 0).squeeze(1)
    rs = series.repeat_interleave(M)[rows].contiguous()
    b = bounds.reshape(-1, k)[rows].contiguous()
    v = torch.clamp(values.reshape(-1, k)[rows], max=cfg.node_cap_mib).contiguous()
    interval = kc.interval_s
    w_k, f_k = wastage.wastage_cuda(y, lengths, rs, b, v, interval)
    w_p, f_p = attempt_outcomes_batch(y[rs], lengths[rs], interval, b, v)
    torch.cuda.synchronize()
    if not torch.equal(f_k, f_p):
        _fail(f"wastage: {(f_k != f_p).sum().item()} fail indices differ from the plain version")
    if not torch.allclose(w_k, w_p, rtol=1e-5, atol=1e-4):
        _fail(f"wastage: max abs difference {(w_k - w_p).abs().max().item()} GiB*s beyond rtol 1e-5 / atol 1e-4")
    ms = _cuda_ms(lambda: wastage.wastage_cuda(y, lengths, rs, b, v, interval), 50)
    plain_ms = _cuda_ms(lambda: attempt_outcomes_batch(y[rs], lengths[rs], interval, b, v), 5)
    R = rows.numel()
    n_failed = (f_k >= 0).sum().item()
    print(f"  wastage rows={R} (failed {n_failed}): fail indices exact, max |dw| "
          f"{(w_k - w_p).abs().max().item():.3e} GiB*s; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    # bytes: each distinct series read once, each row's schedule and outputs;
    # operations: per valid sample t, k compares, a - y, the sum and y > a,
    # and for failed rows the second pass up to the kill
    row_len = valid[rs.long()]
    nbytes = 4 * valid.sum().item() + 4 * S + R * (4 + 8 * k + 8)
    nops = (row_len.sum().item() * (k + 5)) + ((f_k[f_k >= 0].to(torch.int64) + 1).sum().item() * (k + 3))
    bound_ms, bound_by = roofline.bound_ms(nbytes, nops)
    print(f"  one attempt f32: bound {bound_ms:.5f} ms ({bound_by})")
    # the cluster ladders' instantiations: float32 decisions with float64
    # sums, and float64 throughout (the x64 ladders)
    for vdt, acc in ((torch.float32, torch.float64), (torch.float64, torch.float64)):
        bb, vv = b.to(vdt), v.to(vdt)
        w_k, f_k = wastage.wastage_cuda(y, lengths, rs, bb, vv, interval, acc)
        w_p, f_p = attempt_outcomes_batch(y[rs], lengths[rs], interval, bb, vv, acc)
        torch.cuda.synchronize()
        name = f"wastage {str(vdt)[6:]}/{str(acc)[6:]}"
        if not torch.equal(f_k, f_p):
            _fail(f"{name}: {(f_k != f_p).sum().item()} fail indices differ from the plain version")
        if not torch.allclose(w_k, w_p, rtol=1e-9, atol=1e-9):
            _fail(f"{name}: max abs difference {(w_k - w_p).abs().max().item()} GiB*s beyond rtol 1e-9 / atol 1e-9")
        ms = _cuda_ms(lambda: wastage.wastage_cuda(y, lengths, rs, bb, vv, interval, acc), 50)
        plain_ms = _cuda_ms(lambda: attempt_outcomes_batch(y[rs], lengths[rs], interval, bb, vv, acc), 5)
        print(f"  {name} rows={R}: fail indices exact, max |dw| {(w_k - w_p).abs().max().item():.3e} GiB*s; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    # the whole replay of the bucket (the main path's call): every row's
    # retry ladder in one launch
    ladders = ladder_phase(y, lengths, series.view(L, B), bounds, values,
                           torch.full((L,), kc.k, dtype=torch.int32, device=dev), GRID_METHODS, cfg.node_cap_mib, kc)
    out["wastage"] = ladders[(torch.float32, torch.float32, None)]
    return out


# 2,048 / 2,049: the last length of the warp-per-line tier and the next;
# 60,000: past the shared memory (the global scratch path)
SCAN_LENGTHS = (1, 15, 16, 17, 255, 256, 257, 1536, 2048, 2049, 4096, 20000, 60000)
SCAN_KERNELS = ("chain_kernel", "line_kernel", "tile_kernel", "xla_kernel")  # csrc/scan.cu's device kernels


def _scan_rows(shape, dtype, seed: int, dev):
    """N(0, 1e3) values with exact zeros of both signs, -0.0 first."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * 1e3
    a[rng.random(shape) < 0.05] = -0.0
    a[..., 0] = -0.0
    return torch.from_numpy(a).to(dev, dtype)


def scan_shapes(L: int, B: int, k: int) -> tuple:
    """The predict phase's scan calls at a bucket of L lanes of B executions
    (``sim/torch_sim.py``): (name, shape, axis, sequential).  PPM's C and S
    are two calls at one shape."""
    return (("bank", (L, B, 5), 1, False),  # _prefix_bank: the regression bank, inner 5
            ("ppm C, S", (L, B, B), 2, False),  # _ppm_prefix_values: the masked sums, along the last axis
            ("contrib", (L, B, B), 1, False),  # PPM-improved's contrib, along the middle axis (inner B)
            ("sizey", (2, L, 2, B), 3, False),  # _sizey_prefix_values: the scores
            ("fold", (L, B, 5 * (1 + k)), 1, True))  # predict_lanes: the banks' fold, in execution order


def scan_timings(L: int, B: int, k: int, dev, kernels=SCAN_KERNELS, add=None) -> dict:
    """Each of ``scan_shapes(L, B, k)`` in f32 and f64: the kernel bitwise
    against ``prefix_sum_plain``, its profiled device ms (the launches named
    like ``kernels``), back-to-back ms, the plain version's, ``torch.cumsum``'s
    and the bound: bytes (a read and a write) or operations, the larger; for
    the fold also its latency bound, n dependent adds at ``add``'s measured
    cycles an add (``tools/scan_clocks.add_latency``)."""
    import torch

    from repro_torch.kernels import scan
    from repro_torch.launch import roofline

    out = {}
    for name, shape, dim, sequential in scan_shapes(L, B, k):
        for dtype in (torch.float32, torch.float64):
            n = shape[dim]
            block = n if sequential else scan.XLA_SCAN_BLOCK
            a = _scan_rows(shape, dtype, n + len(name), dev)
            got, want = scan.scan_cuda(a, dim, block), scan.prefix_sum_plain(a, dim, block)
            torch.cuda.synchronize()
            if not _same_bits(got, want):
                _fail(f"scan {name} {str(dtype)[6:]} {shape}: not bitwise equal to scan.cumsum")
            ms = _cuda_ms(lambda: scan.scan_cuda(a, dim, block), 50)
            device_ms = _device_ms(lambda: scan.scan_cuda(a, dim, block), kernels, 40)
            plain_ms = _cuda_ms(lambda: scan.prefix_sum_plain(a, dim, block), 2)
            library_ms = _cuda_ms(lambda: torch.cumsum(a, dim), 50)  # the yardstick: it adds in another order
            # operations: one add an element, and a second for a block's prefix in XLA's order
            peak = roofline.HW["peak_flops_f32" if dtype == torch.float32 else "peak_flops_f64"]
            bound_ms, bound_by = roofline.bound_ms(2 * a.numel() * a.element_size(),
                                                   a.numel() * (1 if sequential else 2), peak)
            row = dict(max_abs_err=(got - want).abs().max().item(), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms, device_ms=device_ms)
            extra = ""
            if sequential and add:
                row["latency_bound_ms"] = n * add[str(dtype)[6:]] / add["sm_hz"] * 1e3
                extra = f", latency bound {row['latency_bound_ms']:.6f} ms ({n} adds)"
            print(f"  {name} {str(dtype)[6:]} {shape} along axis {dim}: bitwise; profiled device {device_ms:.4f} ms, "
                  f"{ms:.4f} ms back to back, bound {bound_ms:.6f} ms ({bound_by}){extra}, plain {plain_ms:.4f} ms, "
                  f"torch.cumsum {library_ms:.4f} ms")
            out[(name, dtype)] = row
    return out


def scan_phase(batch, cfg, dev) -> dict:
    """The scan kernel bitwise against ``scan.cumsum`` in both orders, and
    timed at the predict phase's calls at the grid's largest bucket;
    ``predict_lanes`` there dispatches fewer launching aten ops than the
    bucket has executions."""
    import torch

    from repro_torch.analysis import trace_audit
    from repro_torch.kernels import ops, scan
    from repro_torch.sim import torch_sim
    from repro_torch.sim.batch_engine import GRID_METHODS
    from tools.scan_clocks import add_latency

    L, B, T = batch.shape
    cases = 0
    for dtype in (torch.float32, torch.float64):
        for n in SCAN_LENGTHS:
            a = _scan_rows((3 if n > 4096 else 16, n), dtype, n, dev)
            for block in (n, scan.XLA_SCAN_BLOCK):
                got, want = scan.scan_cuda(a, -1, block), scan.cumsum(a, block)
                torch.cuda.synchronize()
                if not _same_bits(got, want):
                    _fail(f"scan {str(dtype)[6:]} n={n} block={block}: not bitwise equal to scan.cumsum")
                cases += 1
        a = _scan_rows((L, B, 40), dtype, 5, dev).transpose(1, 2)  # non-contiguous, along the last axis
        for block in (B, scan.XLA_SCAN_BLOCK):
            if not _same_bits(scan.scan_cuda(a, -1, block), scan.prefix_sum_plain(a, -1, block)):
                _fail(f"scan {str(dtype)[6:]} on a non-contiguous input, block {block}: not bitwise equal")
            cases += 1
    print(f"scan phase: {cases} cases bitwise equal to scan.cumsum (n = {', '.join(map(str, SCAN_LENGTHS))}, "
          f"sequential and XLA order, f32 and f64, and a non-contiguous input)")

    add = add_latency()
    print(f"  dependent adds on the card: f32 {add['float32']:.3f} cycles, f64 {add['float64']:.3f} cycles; "
          f"SM clock {add['sm_hz'] / 1e6:.1f} MHz")
    out = scan_timings(L, B, cfg.ksegments.k, dev, add=add)

    # predict_lanes at the largest bucket: launching aten ops with the
    # kernel, and with the plain scan (the chains it replaced) on the same tensors
    kc = cfg.ksegments
    S = L * B
    x = torch.as_tensor(batch.x, dtype=torch.float32).to(dev)
    args = (x - x[:, :1], torch.as_tensor(batch.y.reshape(S, T)).to(dev),
            torch.as_tensor(batch.lengths.reshape(S)).to(dev),
            torch.arange(S, dtype=torch.int32, device=dev).view(L, B),
            torch.as_tensor(batch.default_mib, dtype=torch.float32).to(dev),
            torch.full((L,), kc.k, dtype=torch.int32, device=dev))
    kw = dict(methods=GRID_METHODS, k=kc.k, interval_s=kc.interval_s, floor_mib=kc.floor_mib,
              cap_mib=cfg.node_cap_mib, error_mode=kc.error_mode, insample_window=kc.insample_window)
    before = scan.launches
    site = trace_audit.launching_ops(lambda: torch_sim.predict_lanes(*args, **kw))
    n_scan = scan.launches - before
    with _patched(ops, "prefix_sum", lambda orig: scan.prefix_sum_plain):
        plain = trace_audit.launching_ops(lambda: torch_sim.predict_lanes(*args, **kw))
    execs = int(batch.n_execs.sum())
    print(f"  predict_lanes at the largest bucket ({L} lanes, {execs} executions, {len(GRID_METHODS)} methods): "
          f"{site} aten ops that launch and {n_scan} scan launches; with the plain scan {plain} aten ops that launch")
    if site >= execs or n_scan < 1:
        _fail(f"predict_lanes dispatched {site} launching aten ops ({n_scan} scan launches) for {execs} executions")
    return out[("ppm C, S", torch.float32)]


def _retry_diffs(got, want) -> int:
    return sum(int((g.retries != w.retries).sum()) for g, w in zip(got, want))


def grid_phase(wfs, cfg):
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.sim.batch_engine import simulate_grid
    from repro_torch.sim.simulator import fig7a_mean_wastage, fig7b_lowest_counts, fig7c_mean_retries

    ops.reset_launch_counts()
    res, cold = _wall(lambda: simulate_grid(wfs, cfg=cfg))
    counts = ops.launch_counts()
    print(f"grid phase: cuda cold {cold:.3f} s; launches {counts}")
    if min(counts[k] for k in GRID_KERNELS) < 1 or counts["wastage"] != counts["segmax"]:
        _fail(f"a kernel was not launched on the grid path, or a replay took more than one wastage launch: {counts}")
    _, warm = _wall(lambda: simulate_grid(wfs, cfg=cfg))
    prof = _profile(lambda: simulate_grid(wfs, cfg=cfg))
    busy = prof["kernel_ms"] / 1e3 / prof["wall_s"]
    print(f"  profiled warm run: wall {prof['wall_s']:.3f} s; kernels {prof['kernel_ms']:.2f} ms on the device "
          f"({100 * busy:.2f}% busy, {prof['launches']} launches); copies {prof['copy_ms']:.2f} ms")
    print(f"  phases, host ms {json.dumps({k: round(v, 2) for k, v in prof['phases_host_ms'].items()})}; "
          f"device span ms {json.dumps({k: round(v, 2) for k, v in prof['phases_device_ms'].items()})}")
    print(f"  against the predict phase's chains (6 methods): launches {prof['launches']} (was "
          f"{GRID_CHAIN_LAUNCHES}), torch_sim.predict host {prof['phases_host_ms'].get('torch_sim.predict', 0.0):.2f} "
          f"ms (was {GRID_CHAIN_PREDICT_MS})")
    for name, (ms, n) in prof["top"]:
        print(f"    {ms:8.3f} ms {n:6d} x  {name[:100]}")
    scan_k = [v for name, v in prof["top_all"] if any(k in name for k in SCAN_KERNELS)]
    print(f"  scan kernels in the profiled run: {sum(v[1] for v in scan_k)} launches, "
          f"{sum(v[0] for v in scan_k):.3f} ms on the device")
    t0 = time.perf_counter()
    ref = simulate_grid(wfs, cfg=cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    print(f"  cuda warm {warm:.3f} s; cpu {cpu_s:.3f} s; {len(res)} rows")
    if len(res) != len(ref) or any(
        (a.task, a.method, a.train_frac, a.n_test) != (b.task, b.method, b.train_frac, b.n_test) for a, b in zip(res, ref)
    ):
        _fail("grid rows differ between cuda and cpu")
    if not all(np.isfinite(r.wastage_gib_s).all() and len(r.wastage_gib_s) == r.n_test for r in res):
        _fail("grid wastage not finite or of the wrong length")
    wa, wr = fig7a_mean_wastage(res), fig7a_mean_wastage(ref)
    ra, bl = fig7c_mean_retries(res), fig7b_lowest_counts(res)
    worst = max(abs(wa[c] - wr[c]) / max(abs(wr[c]), 1e-12) for c in wr)
    n_diff = _retry_diffs(res, ref)
    print(f"  fig7a cells cuda vs cpu: max rel diff {worst:.3e} (limit 1e-3); executions whose retries differ: {n_diff}")
    if worst > 1e-3:
        _fail(f"fig7a cell off by {worst:.3e} (rtol 1e-3) between cuda and cpu")
    methods = sorted({m for m, _ in wa}, key=[r.method for r in res].index)
    fracs = sorted({f for _, f in wa})
    print("  fig7a mean wastage GiB*s (fig7c mean retries, fig7b lowest counts):")
    for m in methods:
        print("    " + f"{m:20s}" + "".join(f"  {f:.2f}: {wa[(m, f)]:10.2f} ({ra[(m, f)]:.3f}, {bl[(m, f)]:2d})" for f in fracs))
    best = min(wa[(m, 0.75)] for m in ("witt-lr", "ppm", "ppm-improved"))
    print(f"  ksegments-selective@0.75 reduction vs best baseline: {100 * (1 - wa[('ksegments-selective', 0.75)] / best):.2f}% "
          "(paper: 29.48%, information only)")
    return counts, cold, warm


def sweep_phase(wfs, cfg):
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.sim.batch_engine import simulate_ksweep

    eligible = [t for wf in wfs for t in wf.eligible_tasks(cfg.min_executions)]
    saw = next(t for t in eligible if t.family == "sawtooth")
    smooth = next(t for t in eligible if t.family in ("ramp", "staged"))
    ops.reset_launch_counts()
    for trace in (saw, smooth):
        got, cold = _wall(lambda: simulate_ksweep(trace, FIG8_KS, 0.5, cfg))
        _, warm = _wall(lambda: simulate_ksweep(trace, FIG8_KS, 0.5, cfg))
        ref = simulate_ksweep(trace, FIG8_KS, 0.5, cfg, device="cpu")
        worst = max(abs(got[k].mean_wastage - ref[k].mean_wastage) / max(abs(ref[k].mean_wastage), 1e-12) for k in FIG8_KS)
        n_diff = _retry_diffs([got[k] for k in FIG8_KS], [ref[k] for k in FIG8_KS])
        print(f"sweep phase: {trace.name} ({trace.n_executions} executions, T={trace.max_samples()}): cuda cold {cold:.3f} s, "
              f"warm {warm:.3f} s; mean wastage max rel diff vs cpu {worst:.3e}; retries differ on {n_diff}")
        print("  mean wastage by k: " + " ".join(f"{k}:{got[k].mean_wastage:.1f}" for k in FIG8_KS))
        if worst > 1e-3 or not all(np.isfinite(got[k].wastage_gib_s).all() for k in FIG8_KS):
            _fail(f"k-sweep of {trace.name} disagrees with the cpu run (rtol 1e-3) or is not finite")
    counts = ops.launch_counts()
    print(f"  sweep launches {counts}")
    if min(counts[k] for k in GRID_KERNELS) < 1:
        _fail(f"a kernel was not launched on the sweep path: {counts}")


# The cluster's standard configuration: benchmarks/run.py:bench_cluster's
# "standard" variant at the paper's full corpus, uncut.
CLUSTER_POLICIES = ("default", "witt-lr", "ppm-improved", "ksegments-selective")
CLUSTER_KW = dict(n_nodes=16, node_mib=128 * 1024.0, train_frac=0.5, max_tasks_per_type=120, min_executions=10,
                  max_attempts=32, placement_window=128)


def _same_placements(a: dict, b: dict) -> bool:
    return all(
        a[p].retries == b[p].retries and a[p].makespan_s == b[p].makespan_s
        and len(a[p].records) == len(b[p].records)
        and all(x.placements == y.placements for x, y in zip(a[p].records, b[p].records))
        for p in a
    )


@contextlib.contextmanager
def _patched(obj, name: str, make):
    """Replace ``obj.name`` by ``make(original)`` inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _shape_counter(shapes: collections.Counter):
    """A wrapper maker that counts the input shapes a kernel's wrapper sees
    (the wrapper still launches and counts as before)."""

    def make(orig):
        def wrapped(x, *args, **kw):
            shapes[tuple(x.shape)] += 1
            return orig(x, *args, **kw)

        return wrapped

    return make


def cluster_phase(wfs) -> dict:
    """The cluster scheduler at the standard configuration on the card."""
    from repro_torch.kernels import compaction, rangemax
    from repro_torch.sim import cluster

    ladder_s: list[float] = []

    def timed(compute):  # the ladder share of each run's wall
        def timed_ladders(*a, **kw):
            t0 = time.perf_counter()
            out = compute(*a, **kw)
            ladder_s.append(time.perf_counter() - t0)
            return out

        return timed_ladders

    shapes = {"rangemax": collections.Counter(), "compaction": collections.Counter()}
    with _patched(cluster, "compute_cluster_ladders", timed), \
            _patched(rangemax, "fit_tables_cuda", _shape_counter(shapes["rangemax"])), \
            _patched(compaction, "fold_compact_cuda", _shape_counter(shapes["compaction"])):
        return _cluster_runs(wfs, ladder_s, shapes)


def _cluster_runs(wfs, ladder_s: list, shapes: dict) -> dict:
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.sim import cluster, device_timeline

    def run(placement, **kw):
        """One cluster run, with the launch counts of that run alone."""
        st: dict = {}
        ops.reset_launch_counts()
        res, wall = _wall(lambda: cluster.run_cluster_batched(wfs, CLUSTER_POLICIES, placement=placement,
                                                              placement_stats=st, **{**CLUSTER_KW, **kw}))
        return res, wall, ladder_s[-1], st, ops.launch_counts()

    # the placement kernel each engine must launch (auto launches its route's)
    engine_kernels = {"windows": ("rangemax",), "sweep": ("compaction",), "auto": ()}
    print(f"cluster phase: {len(CLUSTER_POLICIES)} policies, {CLUSTER_KW}")
    runs = {}
    for placement in ("windows", "sweep", "auto"):
        for temp in ("cold", "warm"):
            res, wall, lad, st, counts = run(placement)
            runs[(placement, temp)] = (res, wall, lad, st)
            print(f"  {placement:7s} {temp}: wall {wall:.3f} s (ladders {lad:.3f} s, placement calls "
                  f"{st['program_wall_s']:.3f} s); program_calls {st['program_calls']}, waits_program "
                  f"{st['waits_program']}, waits_host {st['waits_host']}, rows {st['rows']}"
                  + (f", carried_hw {st['carried_hw']}, timeline_axis {st['timeline_axis']}" if "carried_hw" in st else ""))
            print(f"    launches of this run {counts}")
            need = GRID_KERNELS + engine_kernels[placement]
            if min(counts[k] for k in need) < 1 or max(counts["rangemax"], counts["compaction"]) < 1:
                _fail(f"cluster {placement} {temp}: a kernel of its path was not launched: {counts}")
            if counts["wastage"] != counts["segmax"]:
                _fail(f"cluster {placement} {temp}: a ladder replay took more than one wastage launch: {counts}")
            if temp == "warm" and placement != "auto":
                runs[(placement, "counts")] = counts
    counts = {"rangemax": runs.pop(("windows", "counts"))["rangemax"],
              "compaction": runs.pop(("sweep", "counts"))["compaction"]}
    print(f"  placement kernel launches: rangemax {counts['rangemax']} (warm windows run), compaction "
          f"{counts['compaction']} (warm sweep run); kernel input shapes over the runs "
          f"{json.dumps({k: {str(s): n for s, n in v.items()} for k, v in shapes.items()})}")
    ref = runs[("windows", "warm")][0]
    for key, (res, _, _, st) in runs.items():
        if st["waits_host"] != 0:
            _fail(f"cluster {key}: {st['waits_host']} waits resolved on the host")
        if not _same_placements(res, ref):
            _fail(f"cluster {key}: placements differ from the warm windows run")
        for p, r in res.items():
            if r.tasks_run != len(r.records) or not np.isfinite(r.wastage_gib_s) or not np.isfinite(r.makespan_s):
                _fail(f"cluster {key} {p}: malformed result")
    print("  windows, sweep and auto give identical (node, start, end) for every attempt of every policy")
    for p, r in ref.items():
        print(f"    {p:20s} makespan {r.makespan_s:.1f} s, wastage {r.wastage_gib_s:.2f} GiB*s, retries {r.retries}, "
              f"tasks {r.tasks_run}")
    # the port's own CPU run: counts, placements and makespans exact
    t0 = time.perf_counter()
    cpu = cluster.run_cluster_batched(wfs, CLUSTER_POLICIES, placement="windows", device="cpu", **CLUSTER_KW)
    cpu_s = time.perf_counter() - t0
    worst = max(abs(ref[p].wastage_gib_s - cpu[p].wastage_gib_s) / abs(cpu[p].wastage_gib_s) for p in cpu)
    print(f"  cpu windows run {cpu_s:.3f} s; wastage max rel diff card vs cpu {worst:.3e} (limit 1e-6)")
    if not _same_placements(ref, cpu):
        _fail("cluster placements on the card differ from the port's CPU run")
    if worst > 1e-6:
        _fail(f"cluster wastage on the card off by {worst:.3e} (rtol 1e-6) from the CPU run")
    # one profiled warm run of each engine: wall beside total launches,
    # device busy share, the busiest kernels
    for placement in ("windows", "sweep"):
        ops.reset_launch_counts()
        prof = _profile(lambda: cluster.run_cluster_batched(wfs, CLUSTER_POLICIES, placement=placement, **CLUSTER_KW))
        counts_p = ops.launch_counts()
        busy = prof["kernel_ms"] / 1e3 / prof["wall_s"]
        per_row = (f", {prof['launches'] / counts_p['rangemax']:.1f} per rangemax launch"
                   if counts_p["rangemax"] else
                   f"; with the fold as a chain {SWEEP_CHAIN_LAUNCHES:,}, {prof['launches'] - SWEEP_CHAIN_LAUNCHES:+,} "
                   f"here, {(prof['launches'] - SWEEP_CHAIN_LAUNCHES) / counts_p['compaction']:+.1f} per compaction "
                   "launch")
        print(f"  profiled warm {placement} run: wall {prof['wall_s']:.3f} s; kernels {prof['kernel_ms']:.2f} ms on "
              f"the device ({100 * busy:.2f}% busy, {prof['launches']} launches{per_row}); copies "
              f"{prof['copy_ms']:.2f} ms; kernel launches of this run {counts_p}")
        print(f"  phases, host ms {json.dumps({k: round(v, 2) for k, v in prof['phases_host_ms'].items()})}; "
              f"device span ms {json.dumps({k: round(v, 2) for k, v in prof['phases_device_ms'].items()})}")
        for name, (ms, n) in prof["top"]:
            print(f"    {ms:8.3f} ms {n:6d} x  {name[:100]}")
    # the auto router's constants.  Windows: one warm run, each program call
    # timed from its start to the next call's start (the call and the host
    # loop's bookkeeping after it), fitted as a + b * rows offered.
    calls: list[tuple[int, float]] = []

    def timing(program):
        def timed_call(now, bnd, *a, **kw):
            calls.append((len(bnd), time.perf_counter()))
            return program(now, bnd, *a, **kw)

        return timed_call

    with _patched(cluster, "first_fit_window", timing), _patched(cluster, "schedule_epoch", timing):
        w_res, w_wall, w_lad, _, _ = run("windows")
    t_end = calls[0][1] + (w_wall - w_lad)  # the placement ends with the run, less its ladders
    starts = [t for _, t in calls] + [t_end]
    n_rows = np.asarray([n for n, _ in calls], dtype=float)
    dur = np.diff(np.asarray(starts))
    win_row, win_dispatch = np.polyfit(n_rows, dur, 1)
    resid = dur - (win_dispatch + win_row * n_rows)
    print(f"  windows calls: {len(calls)}, {int(n_rows.sum())} rows offered, {dur.sum():.3f} s; fit a + b*rows: "
          f"a {win_dispatch * 1e3:.4f} ms, b {win_row * 1e3:.4f} ms, residual rms {resid.std() * 1e3:.4f} ms")
    if not _same_placements(w_res, ref):
        _fail("cluster placements changed between warm windows runs")
    # Sweep: two warm runs that differ only in the timeline axis
    sw = runs[("sweep", "warm")]
    L1 = sw[3]["timeline_axis"]
    S, N = len(CLUSTER_POLICIES), CLUSTER_KW["n_nodes"]
    rmax = max(sum(x.attempts for x in r.records) for r in ref.values())  # the deepest lane's rows
    key = (S, device_timeline._row_bucket(rmax), cluster.KSegmentsConfig().k, N)  # the sweep's hint key
    device_timeline._hint_put(key, 4 * L1)
    sw4 = run("sweep")
    device_timeline._hint_put(key, L1)
    L2 = sw4[3]["timeline_axis"]
    tau1, tau2 = (sw[1] - sw[2]) / (rmax * S), (sw4[1] - sw4[2]) / (rmax * S)
    sweep_cell = (tau2 - tau1) / (N * (L2 - L1))
    sweep_step = tau1 - sweep_cell * N * L1
    print(f"  auto constants on this card: _WIN_DISPATCH_S {win_dispatch:.3e}, _WIN_ROW_S {win_row:.3e}; "
          f"_SWEEP_STEP_S {sweep_step:.3e}, _SWEEP_CELL_S {sweep_cell:.3e} (sweep: L={L1} "
          f"{tau1 * 1e3:.4f} ms/row-step/lane, L={L2} {tau2 * 1e3:.4f}; rmax {rmax}, {S} lanes, {N} nodes)")
    if not _same_placements(sw4[0], ref):
        _fail("cluster placements changed with the timeline axis")
    return {"counts": counts, "shapes": shapes, "sweep_axis": L1, "n_nodes": N}


def _demand_rows(B: int, L: int, dtype, seed: int, dev):
    """Running-demand-like rows, -inf at masked positions."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((B, L)) * 3e4, 1)
    x[rng.random((B, L)) < 0.3] = -np.inf
    return torch.from_numpy(x).to(dev, dtype)


def _event_rows(B: int, L: int, dtype, seed: int, mode: str, dev):
    """Sorted (time, delta) rows, +inf / 0 tails, and a keep mask."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    fin = np.arange(L)[None, :] < rng.integers(L // 2, L + 1, size=B)[:, None]
    t = np.where(fin, np.sort(rng.random((B, L)) * 1e4, axis=1), np.inf)
    d = np.where(fin, np.round(rng.standard_normal((B, L)) * 512.0, 2), 0.0)
    keep = {"none": fin, "all": np.zeros_like(fin), "half": fin & (rng.random((B, L)) < 0.5)}[mode]
    return torch.from_numpy(t).to(dev, dtype), torch.from_numpy(d).to(dev, dtype), torch.from_numpy(keep).to(dev)


def _fit_rows(B: int, L: int, dtype, seed: int, dev):
    """Node event rows as the epoch program holds them: sorted times with
    ties and a +inf tail, MiB deltas (some -0.0), base demands."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    fin = np.arange(L)[None, :] < rng.integers(L // 2, L + 1, size=B)[:, None]
    t = np.where(fin, np.sort(np.round(rng.random((B, L)) * 5e3, 1), axis=1), np.inf)
    d = np.where(fin, np.round(rng.standard_normal((B, L)) * 4096.0, 3), 0.0)
    d[:, ::7] = -0.0
    return [torch.from_numpy(a).to(dev, dtype) for a in (t, d, np.round(rng.random(B) * 65536.0, 2))]


def _fold_rows(S: int, N: int, L: int, dtype, seed: int, dev):
    """The sweep's carried node rows: S lanes of N nodes of sorted event
    times with ties and +inf tails, MiB deltas (some -0.0, some cancelling,
    so that their events drop), bases (some -0.0), and each lane's clock,
    before, after, on and between events."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    R = S * N
    t = np.sort(np.round(rng.random((R, L)) * 5e3, 1), axis=1)
    fin = np.arange(L)[None, :] < rng.integers(L // 4, L + 1, size=R)[:, None]
    t = np.where(fin, t, np.inf)
    d = np.where(fin, np.round(rng.standard_normal((R, L)) * 4096.0, 3), 0.0)
    d[1:, ::7] = -0.0
    q = L // 4
    d[1::3, q:2 * q] = -d[1::3, :q]
    base = np.round(rng.random(R) * 65536.0, 2)
    base[::3] = -0.0
    now = np.round(rng.random(S) * 5e3, 1)
    now[0], now[1 % S] = -1.0, 1e4
    if S > 2:
        now[2] = t[2 * N, L // 3]
    return [torch.from_numpy(a).to(dev, dtype) for a in (t, d, base, now)]


def _same_bits(a, b) -> bool:
    import torch

    if a.is_floating_point():
        bits = torch.int64 if a.dtype == torch.float64 else torch.int32
        a, b = a.view(bits), b.view(bits)
    return torch.equal(a, b)


def sched_kernels_phase(cluster_info: dict, dev) -> dict[str, dict]:
    """rangemax (the fit tables the epoch program builds, and the table of
    given rows) and compaction (alone, and the sweep's fold around it)
    against their plain versions, bit-exact, at the shapes the cluster path
    gave them and at L = 256, 1024, 8192."""
    import torch

    from repro_torch.analysis import trace_audit
    from repro_torch.kernels import compaction, rangemax
    from repro_torch.launch import roofline
    from repro_torch.sim import device_timeline

    F64 = roofline.HW["peak_flops_f64"]

    def check_rangemax(x):
        got, want = rangemax.rangemax_cuda(x), rangemax.table_levels(x)
        torch.cuda.synchronize()
        if torch.isnan(got).any() or not torch.equal(got, want):
            _fail(f"rangemax {x.dtype} {tuple(x.shape)}: differs from the plain version")
        ms = _cuda_ms(lambda: rangemax.rangemax_cuda(x), 100)
        plain_ms = _cuda_ms(lambda: rangemax.table_levels(x), 10)
        B, L = x.shape
        P = rangemax.num_levels(L)
        bound_ms, bound_by = roofline.bound_ms(x.element_size() * B * L * (1 + P), B * L * (P - 1), F64)
        return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    def check_fit_tables(t, d, base0):
        (csm, tbl), (want_csm, want_tbl) = rangemax.fit_tables_cuda(t, d, base0), rangemax.fit_tables_plain(t, d, base0)
        torch.cuda.synchronize()
        bits = torch.int64 if t.dtype == torch.float64 else torch.int32
        if not (torch.equal(csm.view(bits), want_csm.view(bits)) and torch.equal(tbl.view(bits), want_tbl.view(bits))):
            _fail(f"fit tables {t.dtype} {tuple(t.shape)}: not bitwise equal to the plain version")
        ms = _cuda_ms(lambda: rangemax.fit_tables_cuda(t, d, base0), 100)
        plain_ms = _cuda_ms(lambda: rangemax.fit_tables_plain(t, d, base0), 10)
        device_ms = _device_ms(lambda: rangemax.fit_tables_cuda(t, d, base0), "fit_tables_kernel", 60)
        B, L = t.shape
        P = rangemax.num_levels(L)
        # bytes: t and d read once, base0, the table written once; operations:
        # ~2 adds, a compare for the tie mask and P - 1 maxima a slot
        bound_ms, bound_by = roofline.bound_ms(t.element_size() * (B * L * (2 + P) + B), B * L * (P + 2), F64)
        return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    device_ms=device_ms)

    def check_fold(t, d, base, now, n_nodes, profiled=False):
        got = compaction.fold_compact_cuda(t, d, base, now, n_nodes)
        want = compaction.fold_compact_plain(t, d, base, now, n_nodes)
        torch.cuda.synchronize()
        if not all(_same_bits(g, w) for g, w in zip(got, want)):
            _fail(f"fold {t.dtype} {tuple(t.shape)}: not bitwise equal to the plain version")
        ms = _cuda_ms(lambda: compaction.fold_compact_cuda(t, d, base, now, n_nodes), 100)
        plain_ms = _cuda_ms(lambda: compaction.fold_compact_plain(t, d, base, now, n_nodes), 10)
        R, L = t.shape
        es = t.element_size()
        # bytes: t and d read once, base and now, and t, d, csm, base and the
        # kept counts written once; operations: this run's adds and compares
        # (the folded prefix's sum, the shifted row's sum, two adds of the
        # base and a compare a shifted slot, the kept row's sum and its add)
        cnt = (t <= now.repeat_interleave(n_nodes)[:, None]).sum().item()
        nops = cnt + 4 * (R * L - cnt) + 2 * want[4].sum().item()
        bound_ms, bound_by = roofline.bound_ms(es * (5 * R * L + 2 * R + now.numel()) + 8 * R, nops, F64)
        out = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        if profiled:
            out["device_ms"] = _device_ms(lambda: compaction.fold_compact_cuda(t, d, base, now, n_nodes),
                                          "fold_kernel", 60)
        return out

    def check_compaction(t, d, keep, profiled=False):
        got, want = compaction.compaction_cuda(t, d, keep), compaction.compact_events_plain(t, d, keep)
        torch.cuda.synchronize()
        if any(torch.isnan(g).any() or not torch.equal(g, w) for g, w in zip(got, want)):
            _fail(f"compaction {t.dtype} {tuple(t.shape)}: differs from the plain version")
        ms = _cuda_ms(lambda: compaction.compaction_cuda(t, d, keep), 100)
        plain_ms = _cuda_ms(lambda: compaction.compact_events_plain(t, d, keep), 10)
        B, L = t.shape
        bound_ms, bound_by = roofline.bound_ms(B * L * (4 * t.element_size() + 1), B * L * 4, F64)
        out = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        if profiled:
            out["device_ms"] = _device_ms(lambda: compaction.compaction_cuda(t, d, keep), "compact_kernel", 60)
        return out

    print("sched kernels phase: fit tables and rangemax (16, L), compaction and the fold (64, L); bit-exact against "
          "the plain versions")
    for dtype in (torch.float64, torch.float32):
        for L in (256, 1024, 8192):
            f = check_fit_tables(*_fit_rows(16, L, dtype, L, dev))
            r = check_rangemax(_demand_rows(16, L, dtype, L, dev))
            print(f"  fit tables {str(dtype)[6:]} L={L}: bitwise; kernel {f['ms']:.4f} ms back to back, profiled "
                  f"device {f['device_ms']:.4f} ms, plain chain {f['plain_ms']:.4f} ms, bound {f['bound_ms']:.5f} ms")
            print(f"  rangemax {str(dtype)[6:]} L={L}: exact; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.5f} ms")
            for mode in ("none", "all", "half"):
                c = check_compaction(*_event_rows(64, L, dtype, L + 1, mode, dev))
                if mode == "half":
                    print(f"  compaction {str(dtype)[6:]} L={L} (keep none/all/half exact): kernel {c['ms']:.4f} ms, "
                          f"plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.5f} ms")
            c = check_fold(*_fold_rows(4, 16, L, dtype, L + 2, dev), 16)
            print(f"  fold {str(dtype)[6:]} (64, {L}): bitwise; kernel {c['ms']:.4f} ms back to back, plain chain "
                  f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.5f} ms")
    f = check_fit_tables(*_fit_rows(16, 20000, torch.float64, 9, dev))
    print(f"  fit tables f64 L=20000 (past the shared memory: the global path): bitwise; kernel {f['ms']:.4f} ms")
    for dtype, L in ((torch.float64, 20000), (torch.float32, 40000)):
        c = check_fold(*_fold_rows(4, 16, L, dtype, 9, dev), 16)
        print(f"  fold {str(dtype)[6:]} (64, {L}) (past the shared memory: the global path): bitwise; kernel "
              f"{c['ms']:.4f} ms")
    # the main path's shapes: the most frequent of the cluster runs
    (B, L), _ = cluster_info["shapes"]["rangemax"].most_common(1)[0]
    rows = _fit_rows(B, L, torch.float64, 7, dev)
    out = {"rangemax": check_fit_tables(*rows)}
    before = rangemax.launches
    site = trace_audit.launching_ops(lambda: device_timeline._fit_tables(*rows))
    if rangemax.launches != before + 1 or site:
        _fail(f"device_timeline._fit_tables took {rangemax.launches - before} rangemax launches and {site} aten ops "
              f"that launch, where it should take one launch and nothing else")
    plain = trace_audit.launching_ops(lambda: rangemax.fit_tables_plain(*rows))
    print(f"  device_timeline._fit_tables at the cluster path's shape is 1 rangemax launch and 0 aten ops that "
          f"launch; the plain chain dispatches {plain} aten ops that launch")
    print(f"  fit tables at the cluster path's shape ({B} nodes, L={L}) f64: bitwise; kernel "
          f"{out['rangemax']['ms']:.4f} ms back to back, profiled device {out['rangemax']['device_ms']:.4f} ms, "
          f"plain chain {out['rangemax']['plain_ms']:.4f} ms, bound {out['rangemax']['bound_ms']:.6f} ms")
    (B, L), _ = cluster_info["shapes"]["compaction"].most_common(1)[0]
    c = check_compaction(*_event_rows(B, L, torch.float64, 8, "half", dev), profiled=True)
    print(f"  compaction alone at the sweep's shape ({B} lanes x nodes, L={L}) f64: kernel {c['ms']:.4f} ms back to "
          f"back, profiled device {c['device_ms']:.4f} ms (a block per row: {COMPACTION_BLOCK_PER_ROW_MS} ms), bound "
          f"{c['bound_ms']:.6f} ms")
    # the main path's call: the sweep's whole chunk-boundary fold
    N = cluster_info["n_nodes"]
    S = B // N
    rows = _fold_rows(S, N, L, torch.float64, 8, dev)
    out["compaction"] = check_fold(*rows, N, profiled=True)
    t, d, base, now = rows
    step = (lambda: device_timeline._fold_and_compact(now, base.view(S, N), t.view(S, N, L), d.view(S, N, L)))
    before = compaction.launches
    site = trace_audit.launching_ops(step)
    if compaction.launches != before + 1 or site > 1:
        _fail(f"device_timeline._fold_and_compact took {compaction.launches - before} compaction launches and {site} "
              "aten ops that launch, where it should take one launch and at most one op (the max over nodes)")
    plain = trace_audit.launching_ops(lambda: compaction.fold_compact_plain(t, d, base, now, N))
    print(f"  device_timeline._fold_and_compact at the sweep's shape is 1 compaction launch and {site} aten op that "
          f"launches (the max over nodes); the plain chain dispatches {plain} aten ops that launch")
    print(f"  fold at the sweep's shape ({S} lanes x {N} nodes, L={L}) f64: bitwise; kernel "
          f"{out['compaction']['ms']:.4f} ms back to back, profiled device {out['compaction']['device_ms']:.4f} ms, "
          f"plain chain {out['compaction']['plain_ms']:.4f} ms, bound {out['compaction']['bound_ms']:.6f} ms "
          f"({out['compaction']['bound_by']})")
    return out


def _flash_case_inputs(B, T, S, H, KV, hd, dtype, seed, dev, ragged=None, window=None):
    """N(0, 1) q, k, v on the card; positions 0..T-1 against 0..S-1, or a
    ragged cache: row b holds ``ragged[b]`` tokens, -1 in the other slots,
    and queries the last of them; or a named pattern: "late-keys" (keys at
    positions S // 7 + 3.., so the first queries have no valid key),
    "window-out" (decode; row 0 holds S // 2 tokens and queries past its
    window, row 1 the last of 3 S // 4), "rolling" (a cache written at
    pos % S; row 0 wrapped at 3 S + 11, row 1 part filled)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, T, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    slots = torch.arange(S, device=dev)[None]
    steps = torch.arange(T, device=dev)[None]
    if ragged is None:
        qpos, kpos = steps.expand(B, T), slots.expand(B, S)
    elif ragged == "late-keys":
        qpos, kpos = steps.expand(B, T), (slots + S // 7 + 3).expand(B, S)
    elif ragged == "window-out":
        fill = torch.full((B, 1), 3 * S // 4, device=dev)
        fill[0] = S // 2
        kpos = torch.where(slots < fill, slots, -1)
        qpos = fill - 1
        qpos[0] += window + 5
    elif ragged == "rolling":
        nows = torch.tensor([3 * S + 11] + [S // 2 + b for b in range(1, B)], device=dev)[:, None]
        back = (nows - slots) % S  # how far behind the newest position each slot's last write is
        kpos = torch.where(nows - back >= 0, nows - back, -1)
        qpos = nows - T + 1 + steps
    else:
        n = torch.as_tensor(ragged, device=dev)[:, None]
        kpos = torch.where(slots < n, slots, -1)
        qpos = n - T + steps
    return q, k, v, qpos.to(torch.int32).contiguous(), kpos.to(torch.int32).contiguous()


def _flash_mask(qpos, kpos, causal, window):
    """(B, T, S) bool: the key slots each query attends to."""
    ok = (kpos >= 0)[:, None, :].expand(qpos.shape[0], qpos.shape[1], kpos.shape[1])  # every query's row, non-causal too
    if causal:
        ok = ok & (kpos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        ok = ok & (kpos[:, None, :] > qpos[:, :, None] - window)
    return ok


FLASH_KERNELS = "flash_kernel"  # every launch of csrc/flash.cu is named flash_kernel_*


def _flash_part(name: str) -> str:
    """flash_kernel_mma / _cores / _tiles / _combine, from a profiler's kernel name."""
    return re.search(FLASH_KERNELS + r"\w*", name).group(0)


def _flash_device_ms(call, n: int) -> tuple[float, dict]:
    """The profiled device time of one flash call: ``n`` calls under the
    profiler, each kernel's time over the launches the profiler kept (it
    drops the first twenty or so device events of a window), summed over
    the kernels."""
    prof = _profile(lambda: [call() for _ in range(n)])
    parts = {_flash_part(name): v for name, v in prof["top_all"] if FLASH_KERNELS in name}
    return sum(ms / max(k, 1) for ms, k in parts.values()), parts


def flash_phase(dev) -> dict:
    """flash against its plain version; times at the main path's shapes."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # name, (B, T, S, H, KV, hd), causal, window, softcap, positions, timed
    cases = [
        ("ref causal", (2, 64, 64, 4, 2, 64), True, None, None, None, False),
        ("ref softcap", (1, 300, 300, 8, 8, 64), True, None, 50.0, None, False),
        ("ref window", (2, 37, 37, 6, 2, 64), True, 16, None, None, False),
        ("ref ragged decode", (2, 1, 80, 4, 4, 64), True, None, None, (60, 41), False),
        ("ref encoder", (1, 128, 128, 4, 2, 64), False, None, None, None, False),
        ("serve wave prefill", (4, 47, 47, 24, 8, 128), True, None, None, None, False),
        ("serve wave decode", (4, 1, 63, 24, 8, 128), True, None, None, (63, 50, 31, 9), False),
        ("no valid key prefill", (2, 100, 141, 24, 8, 128), True, None, None, "late-keys", False),
        ("no valid key decode", (2, 1, 141, 24, 8, 128), True, 32, None, "window-out", False),
        ("rolling decode hd128", (2, 1, 300, 24, 8, 128), True, 100, None, "rolling", False),
        ("rolling decode hd256", (2, 1, 200, 16, 8, 256), True, 96, 50.0, "rolling", False),
        ("rolling chunk hd128", (1, 40, 300, 24, 8, 128), True, 100, None, "rolling", False),
        ("prefill S=4096+37", (2, 4133, 4133, 24, 8, 128), True, None, None, None, False),
        ("llama3.2-3b prefill", (2, 4096, 4096, 24, 8, 128), True, None, None, None, True),
        ("llama3.2-3b decode", (2, 1, 4112, 24, 8, 128), True, None, None, (4112, 3000), True),
        ("gemma2-9b widths", (1, 8192, 8192, 16, 8, 256), True, 4096, 50.0, None, True),
        # recurrentgemma-2b's decode: G = 10 on one KV head, a full 2,048-slot window
        ("recurrentgemma decode", (2, 1, 2048, 10, 1, 256), True, 2048, None, (2048, 2048), True),
    ]
    out = {}
    print("flash phase: kernel vs plain; f32 atol 3e-5 rtol 1e-4, bf16 max|d| <= 1e-2 and mean|d| <= 1e-3")
    for i, case in enumerate(cases):
        timed = _flash_case(case, 100 + i, sms, dev)
        if timed:
            out[case[0]] = timed
    torch.cuda.empty_cache()
    return out


def _flash_case(case, seed: int, sms: int, dev) -> dict | None:
    """One flash case in f32 and bf16, each against the plain version
    (printed with its path and share of KV tiles skipped); a timed case's
    bf16 run also timed (CUDA events, profiled device time), beside its
    plain version, SDPA and its bound.  Returns the timed numbers."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash
    from repro_torch.launch import roofline

    name, (B, T, S, H, KV, hd), causal, window, cap, ragged, timed = case
    kw = dict(causal=causal, window=window, softcap=cap)
    result = None
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, qp, kp = _flash_case_inputs(B, T, S, H, KV, hd, dtype, seed, dev, ragged, window)
        got = flash.flash_attention_cuda(q, k, v, qp, kp, **kw)
        want = flash.flash_attention_plain(q, k, v, qp, kp, **kw)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        err, mean = d.max().item(), d.mean().item()
        if not torch.isfinite(got.float()).all():
            _fail(f"flash {name} {dtype}: non-finite output")
        if dtype == torch.float32:
            if not torch.allclose(got, want, atol=3e-5, rtol=1e-4):
                _fail(f"flash {name} f32: max |d| {err:.3e} beyond atol 3e-5 / rtol 1e-4")
        elif err > 1e-2 or mean > 1e-3:
            _fail(f"flash {name} bf16: max |d| {err:.3e} (limit 1e-2), mean |d| {mean:.3e} (limit 1e-3)")
        mask = _flash_mask(qp, kp, causal, window)
        path, bm, bn = flash.kernel_plan(dtype, hd, T * (H // KV))
        splits = flash.decode_splits(B, KV, S, sms) if path == "split" else 1
        live = flash.flash_tile_live(qp, kp, H // KV, bm, bn, causal=causal, window=window)
        skipped = 1.0 - live.float().mean().item()
        line = (f"  {name:20s} {str(dtype)[6:]:8s} B{B} T{T} S{S} H{H} KV{KV} hd{hd}: "
                f"max |d| {err:.3e}, mean {mean:.3e}; {path} {bm}x{bn}"
                f"{f', {splits} splits' if path == 'split' else ''}, {100 * skipped:.1f}% of KV tiles skipped"
                f"{f', {(~mask.any(-1)).sum().item()} queries without a valid key' if not mask.any(-1).all() else ''}")
        if timed and dtype == torch.bfloat16:
            call = lambda: flash.flash_attention_cuda(q, k, v, qp, kp, **kw)  # noqa: E731
            reps = 10 if T > 1 else 50
            ms = _cuda_ms(call, reps)
            plain_ms = _cuda_ms(lambda: flash.flash_attention_plain(q, k, v, qp, kp, **kw), 3 if T > 1 else 20)
            dev_ms, parts = _flash_device_ms(call, 30 if T > 1 else 60)
            pairs = mask.sum().item() * H
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * (qp.numel() + kp.numel())
            bound_ms, bound_by = roofline.bound_ms(nbytes, 4 * hd * pairs, roofline.HW["peak_flops_bf16"])
            lib_ms = lib_note = None
            if cap is None:  # SDPA has no softcap
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                m4 = mask[:, None]
                sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4, enable_gqa=True)  # noqa: E731
                lib_ms = _cuda_ms(sdpa, reps)
                lib_err = (sdpa().transpose(1, 2).float() - got.float()).abs().max().item()
                lib_note = f"sdpa {lib_ms:.4f} ms (max |d| vs kernel {lib_err:.3e})"
            else:
                lib_note = "sdpa: null (no softcap)"
            line += (f"; kernel {ms:.4f} ms, profiled device time {dev_ms:.4f} ms ("
                     + ", ".join(f"{n} {t / max(c, 1):.4f} ms x {c}" for n, (t, c) in parts.items())
                     + f"), plain {plain_ms:.4f} ms, {lib_note}, bound {bound_ms:.4f} ms "
                     f"({bound_by}; {4 * hd * pairs:.3e} flop, {nbytes / 1e6:.1f} MB)")
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib_ms, device_ms=dev_ms, path=path, skipped=skipped)
        print(line)
        del q, k, v, got, want, d, mask
    return result


SERVE_ARCH = "llama3.2-3b"
SERVE_PROMPT, SERVE_BATCH, SERVE_STEPS = 4096, 2, 16
SERVE_REPEATS = 5


def serve_phase(dev) -> dict:
    """The serving path at the full width and depth of llama3.2-3b."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash, ops
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models.model import decode_step, forward, init_params
    from repro_torch.serve import AdmissionController, cache_bytes_per_token
    from repro_torch.serve.engine import greedy_generate, make_decode_step, make_prefill_step

    cfg = get_config(SERVE_ARCH)
    model, init_s = _wall(lambda: init_params(cfg, seed=0, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve phase: {cfg.name} at full width and depth ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card); "
          f"init_params {init_s:.2f} s")

    # (a) the launcher's wave loop, its defaults, the full config
    ctl = AdmissionController(hbm_budget_mib=512.0, k=4, interval_s=1.0)
    bpt = cache_bytes_per_token(cfg) / 2**20
    ops.reset_launch_counts()
    res, wall = _wall(lambda: serve_requests(cfg, model, ctl, requests=24, decode_steps=SERVE_STEPS,
                                             bytes_per_token_mib=bpt, device=dev, log=lambda m: None))
    counts = ops.launch_counts()
    toks = torch.cat([o.flatten() for o in res["outputs"]])
    print(f"  (a) launcher loop: {res['done']} served in {res['waves']} waves, {res['rejected']} deferred, "
          f"wall {wall:.3f} s; launches {counts}")
    if res["done"] != 24 or sum(o.shape[0] for o in res["outputs"]) != 24:
        _fail(f"serve: {res['done']} of 24 requests served")
    if any(o.shape[1] != SERVE_STEPS for o in res["outputs"]) or not 0 <= int(toks.min()) <= int(toks.max()) < cfg.vocab_size:
        _fail("serve: generated tokens of the wrong shape or outside the vocabulary")
    if counts["flash"] < 1:
        _fail(f"serve: flash was not launched on the serving path: {counts}")

    # (b) one long batch: prefill wall, ms per decode step, tokens/s
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + 1), generator=g, device=dev,
                           dtype=torch.int32)
    tokens = prompt[:, :SERVE_PROMPT].contiguous()
    cache_len = SERVE_PROMPT + SERVE_STEPS
    prefill = make_prefill_step(cfg, cache_len, device=dev)
    step = make_decode_step(cfg, device=dev)
    prefill(model, {"tokens": tokens})  # warm-up
    (logits, cache), prefill_s = _wall(lambda: prefill(model, {"tokens": tokens}))
    first = torch.argmax(logits, -1).to(torch.int32)

    def decode_all():
        last = [first]
        for i in range(SERVE_STEPS - 1):
            pos = torch.full((SERVE_BATCH,), SERVE_PROMPT + i, dtype=torch.int32, device=dev)
            lg, _ = step(model, cache, {"tokens": last[-1][:, None], "positions": pos})
            last.append(torch.argmax(lg, -1).to(torch.int32))
        return torch.stack(last, 1)

    # the decode loop is bound by the host's launches, whose pace varies on a
    # shared host: every repeat is printed, the median is kept
    decodes = [_wall(decode_all) for _ in range(SERVE_REPEATS)]
    gens = [_wall(lambda: greedy_generate(model, cfg, tokens, SERVE_STEPS, device=dev)) for _ in range(SERVE_REPEATS)]
    if not all(torch.equal(out, gens[0][0]) for out, _ in decodes + gens):
        _fail("serve: greedy_generate differs from its own prefill + decode steps, or between repeats")
    steps_ms = [s / (SERVE_STEPS - 1) * 1e3 for _, s in decodes]
    step_ms = statistics.median(steps_ms)
    gen_s = statistics.median(s for _, s in gens)
    prof = _profile(lambda: greedy_generate(model, cfg, tokens, SERVE_STEPS, device=dev))
    busy = prof["kernel_ms"] / 1e3 / prof["wall_s"]
    flash_ms = sum(v[0] for n, v in prof["top_all"] if FLASH_KERNELS in n)
    flash_parts = collections.Counter()
    for n, (ms, _) in prof["top_all"]:
        if FLASH_KERNELS in n:
            flash_parts[_flash_part(n)] += ms
    print(f"  (b) B {SERVE_BATCH} x {SERVE_PROMPT}-token prompt, {SERVE_STEPS} greedy tokens: "
          f"prefill {prefill_s:.4f} s; decode {step_ms:.3f} ms/step (median of "
          f"{' '.join(f'{x:.3f}' for x in steps_ms)}); greedy_generate {gen_s:.4f} s (median of "
          f"{' '.join(f'{s:.4f}' for _, s in gens)}) = {SERVE_BATCH * SERVE_STEPS / gen_s:.2f} tokens/s "
          f"({SERVE_BATCH * (SERVE_PROMPT + SERVE_STEPS) / gen_s:.1f} prompt+generated tokens/s)")
    print(f"  profiled greedy_generate: wall {prof['wall_s']:.4f} s; kernels {prof['kernel_ms']:.2f} ms on the device "
          f"({100 * busy:.2f}% busy, {prof['launches']} launches), flash {flash_ms:.2f} ms "
          f"({', '.join(f'{n} {ms:.2f}' for n, ms in sorted(flash_parts.items()))}); "
          f"copies {prof['copy_ms']:.2f} ms")
    for name, (ms, n) in prof["top"]:
        print(f"    {ms:9.3f} ms {n:6d} x  {name[:100]}")

    # (c) the cache contract at full width: prefill on T, decode at T,
    # against forward on T + 1 tokens
    full, _ = forward(model, prompt, last_only=True)
    _, c_cache = forward(model, tokens, want_cache=True, cache_len=cache_len)
    dec, _ = decode_step(model, c_cache, prompt[:, SERVE_PROMPT:], torch.full((SERVE_BATCH,), SERVE_PROMPT,
                                                                             dtype=torch.int32, device=dev))
    scale = full.abs().max().item()
    c_err = (full[:, 0] - dec[:, 0]).abs().max().item() / scale
    print(f"  (c) cache contract at T={SERVE_PROMPT}: |decode - forward(T+1)| / max|logits| = {c_err:.3e} (limit 2e-2)")
    if not np.isfinite(c_err) or c_err > 2e-2:
        _fail(f"serve: prefill + decode_step off forward on T + 1 tokens by {c_err:.3e} of max |logits| (limit 2e-2)")
    del c_cache

    # (d) the kernel against the plain path at full width, on (b)'s prompt
    # and on a second one
    del cache
    for seed in (1, 2):
        if seed != 1:
            g = torch.Generator(device=dev).manual_seed(seed)
            tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=g, device=dev,
                                   dtype=torch.int32)
            logits, _ = prefill(model, {"tokens": tokens})
        before = flash.launches
        with _patched(ops, "flash_attention", lambda orig: flash.flash_attention_plain):
            (plain_logits, _), plain_s = _wall(lambda: prefill(model, {"tokens": tokens}))
        if flash.launches != before:
            _fail("serve: the plain prefill launched the kernel")
        d_err = (plain_logits - logits).abs().max().item() / plain_logits.abs().max().item()
        agree = int((torch.argmax(plain_logits, -1) == torch.argmax(logits, -1)).sum())
        print(f"  (d) prompt seed {seed}: plain attention prefill {plain_s:.4f} s; last logits |kernel - plain| / "
              f"max|logits| = {d_err:.3e} (limit 2e-2); greedy first tokens agree {agree}/{SERVE_BATCH}")
        if not np.isfinite(d_err) or d_err > 2e-2:
            _fail(f"serve: kernel logits off the plain path by {d_err:.3e} of max |logits| (limit 2e-2)")
    del model
    torch.cuda.empty_cache()
    return {"counts": counts, "prefill_s": prefill_s, "step_ms": step_ms}


FITSTATS_TOL = 1e-5  # kernel vs plain, of each statistic's sum of absolute terms
FITSTATS_HOST_TOL = 1e-4  # kernel vs the float64 host bank, likewise
FITSTATS_KS = tuple(range(1, 16))
FITSTATS_BIG = (1 << 20, 128)  # (c): rows, segments


def _bench_kernels_inputs(dev):
    """benchmarks/run.py:bench_kernels' batch: B 512, T 2048, k 4, seed 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    B, T, k = 512, 2048, 4
    y = rng.uniform(1, 1e4, (B, T)).astype(np.float32)
    lengths = rng.integers(16, T + 1, B).astype(np.int32)
    x = rng.uniform(-10, 10, B)
    bounds = np.sort(rng.uniform(1, T * 2.0, (B, k)), axis=1).astype(np.float32)
    values = np.maximum.accumulate(rng.uniform(10, 12000, (B, k)), axis=1).astype(np.float32)
    return k, [torch.from_numpy(a).to(dev) for a in (y, lengths, x, bounds, values)]


def _bank_err(got, want, scale) -> float:
    """The largest difference of two banks, relative to each statistic's
    sum of absolute terms (sums of u cancel, so not relative to the sum)."""
    return ((got.double() - want.double()).abs() / scale.double().clamp(min=1e-30)).max().item()


def _fitstats_case(name: str, x, peaks, w, reps: int) -> dict:
    """fitstats on (x, peaks, w) against its plain version: the tolerance,
    bitwise equality of two launches, CUDA-event times and the bound."""
    import torch

    from repro_torch.kernels import fitstats
    from repro_torch.launch import roofline

    got, again = fitstats.fitstats_cuda(x, peaks, w), fitstats.fitstats_cuda(x, peaks, w)
    want = fitstats.fit_stats_plain(x, peaks, w)
    scale = fitstats.fit_stats_plain(x.abs(), peaks.abs(), w.abs())
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        _fail(f"fitstats {name}: two launches on the same inputs differ")
    err = _bank_err(got, want, scale)
    if not err <= FITSTATS_TOL:
        _fail(f"fitstats {name}: {err:.3e} of the sum of absolute terms from the plain version (limit {FITSTATS_TOL})")
    ms = _cuda_ms(lambda: fitstats.fitstats_cuda(x, peaks, w), reps)
    plain_ms = _cuda_ms(lambda: fitstats.fit_stats_plain(x, peaks, w), max(reps // 4, 2))
    # the device's own time of each pass, from the profiler's kernel events
    # (the CUDA-event mean of a small batch is the wrapper's host pace)
    prof = _profile(lambda: [fitstats.fitstats_cuda(x, peaks, w) for _ in range(20)])
    passes = {p: [v for n, v in prof["top_all"] if f"fitstats_{p}_kernel" in n] for p in ("partial", "final")}
    device = {p: (sum(v[0] for v in vs), sum(v[1] for v in vs)) for p, vs in passes.items()}
    device_ms = sum(t / max(n, 1) for t, n in device.values())
    B, k = peaks.shape
    # bytes: x, w and the peaks read once, the bank written once; operations:
    # w p, (w u) p and two adds a value, the row's scalars (w u, (w u) u, 3 adds)
    bound_ms, bound_by = roofline.bound_ms(4 * (B * k + 2 * B + 5 * k), 4 * B * k + 5 * B)
    print(f"  fitstats {name} B={B} k={k}: {err:.3e} of the terms' sum (limit {FITSTATS_TOL}), two launches "
          f"bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}); "
          f"profiled device time {device_ms:.4f} ms a call (pass 1 {device['partial'][0]:.4f} ms over "
          f"{device['partial'][1]} launches, pass 2 {device['final'][0]:.4f} ms over {device['final'][1]})")
    return dict(max_abs_err=(got - want).abs().max().item(), rel_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def fitstats_phase(wfs, cfg, dev) -> tuple[dict, int]:
    """fitstats through the kernels API: (a) bench_kernels' batch, (b) every
    eligible task of the corpus at k = 1..15 (the main path: the launches
    of that run are counted), also against the float64 host bank, (c) 2**20
    rows at k = 128 with random weights."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core.ksegments import KSegmentsConfig, KSegmentsModel
    from repro_torch.kernels import fitstats, ops

    print(f"fitstats phase: kernel vs plain within {FITSTATS_TOL}, vs the float64 host bank within "
          f"{FITSTATS_HOST_TOL}, of each statistic's sum of absolute terms")
    k, (y, lengths, x, _, _) = _bench_kernels_inputs(dev)
    peaks = kernels.segment_peaks(y, lengths, k)
    _fitstats_case("(a) bench_kernels", x.float(), peaks, torch.ones(len(x), device=dev), 200)

    # (b) the main path: every bank of the corpus through the API
    tasks = [t for wf in wfs for t in wf.eligible_tasks(cfg.min_executions)]
    inputs = []
    for trace in tasks:
        xs, ys, ls = trace.padded()
        u = torch.from_numpy(xs - xs[0]).to(dev, torch.float32)
        inputs.append((trace, u, torch.from_numpy(ys).to(dev), torch.from_numpy(ls).to(dev)))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    banks = {}
    for trace, u, ys, ls in inputs:
        ones = torch.ones(len(u), device=dev)
        for kk in FITSTATS_KS:
            pk = kernels.segment_peaks(ys, ls, kk)
            banks[(trace.name, kk)] = (pk, kernels.fit_stats(u, pk, ones))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"  (b) corpus: {len(tasks)} tasks x k = 1..15, {len(banks)} banks through the API in {wall:.3f} s; "
          f"launches {counts}")
    if counts["fitstats"] != len(banks) or counts["segmax"] != len(banks):
        _fail(f"fitstats phase: {len(banks)} banks but launches {counts}")
    worst_plain = worst_host = 0.0
    t0 = time.perf_counter()
    for trace, u, _, _ in inputs:
        ones = torch.ones(len(u), device=dev)
        for kk in FITSTATS_KS:
            pk, bank = banks[(trace.name, kk)]
            scale = fitstats.fit_stats_plain(u.abs(), pk, ones)
            worst_plain = max(worst_plain, _bank_err(bank, fitstats.fit_stats_plain(u, pk, ones), scale))
            host = KSegmentsModel(KSegmentsConfig(k=kk, error_mode="progressive"))
            for e in trace.executions:
                host.observe(e.input_size, e.series)
            seg = torch.from_numpy(host.state()["seg_stats"])
            worst_host = max(worst_host, _bank_err(bank.cpu(), seg, scale.cpu()))
    print(f"  (b) worst bank vs plain {worst_plain:.3e} (limit {FITSTATS_TOL}), vs the host model's float64 "
          f"seg_stats {worst_host:.3e} (limit {FITSTATS_HOST_TOL}); host check {time.perf_counter() - t0:.2f} s")
    if not worst_plain <= FITSTATS_TOL or not worst_host <= FITSTATS_HOST_TOL:
        _fail("fitstats phase: a corpus bank is off its plain version or the host model's")
    trace, u, ys, ls = max(inputs, key=lambda t: t[1].numel())  # the main path's largest shape
    pk = kernels.segment_peaks(ys, ls, FITSTATS_KS[-1])
    out = _fitstats_case(f"(b) {trace.name}", u, pk, torch.ones(len(u), device=dev), 200)

    # (c) 2**20 rows at the widest k, random weights
    B, kb = FITSTATS_BIG
    g = torch.Generator(device=dev).manual_seed(7)
    xb = torch.randn(B, generator=g, device=dev) * 40.0
    pb = torch.rand((B, kb), generator=g, device=dev) * 1e4
    wb = torch.rand(B, generator=g, device=dev)
    _fitstats_case("(c) 2**20 rows", xb, pb, wb, 50)
    del xb, pb, wb
    torch.cuda.empty_cache()
    return out, counts["fitstats"]


def api_phase(dev) -> None:
    """segment_peaks and attempt_wastage through the kernels API on
    bench_kernels' batch, against their plain versions on the card."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.allocation import attempt_outcomes_batch
    from repro_torch.core.segmentation import segment_peaks_dynamic

    k, (y, lengths, _, bounds, values) = _bench_kernels_inputs(dev)
    peaks = kernels.segment_peaks(y, lengths, k)
    want = segment_peaks_dynamic(y, torch.clamp(lengths, min=1), k, k)
    waste, fail = kernels.attempt_wastage(y, lengths, bounds, values, 2.0)
    w_p, f_p = attempt_outcomes_batch(y, lengths, 2.0, bounds, values)
    torch.cuda.synchronize()
    if not torch.equal(peaks, want):
        _fail(f"api segment_peaks: {(peaks != want).sum().item()} peaks differ from the plain version")
    if not torch.equal(fail, f_p):
        _fail(f"api attempt_wastage: {(fail != f_p).sum().item()} fail indices differ from the plain version")
    if not torch.allclose(waste, w_p, rtol=1e-5, atol=1e-4):
        _fail(f"api attempt_wastage: max |dw| {(waste - w_p).abs().max().item()} GiB*s beyond rtol 1e-5 / atol 1e-4")
    print(f"api phase (bench_kernels' batch, B={y.shape[0]} T={y.shape[1]} k={k}): segment_peaks exact, "
          f"attempt_wastage fail indices exact ({(fail >= 0).sum().item()} failed), max |dw| "
          f"{(waste - w_p).abs().max().item():.3e} GiB*s")


def _gate(got, ref) -> bool:
    """The reference's engine parity gate (tests/test_batch_engine.py:36-47)."""
    import numpy as np

    if got.n_train != ref.n_train or got.n_test != ref.n_test:
        return False
    if not np.isclose(got.wastage_gib_s.sum(), ref.wastage_gib_s.sum(), rtol=0.05, atol=1e-6):
        return False
    if abs(int(got.retries.sum()) - int(ref.retries.sum())) > max(2, 0.1 * ref.retries.sum()):
        return False
    return not ref.n_test or np.isclose(got.wastage_gib_s, ref.wastage_gib_s, rtol=0.05, atol=0.5).mean() > 0.9


KTUNER_OBSERVED = 512  # of sarek:task05_decline's 1,512 executions: 32 reoptimisations
ORACLE_SCALE = 0.35  # the reference benchmark's default corpus scale


def online_phase(wfs, seed: int) -> None:
    """The online predictor path: the adaptive-k tuner's replays on the card
    against its CPU run, and the grid on the card against the sequential
    oracle under the reference's gate."""
    import numpy as np

    from repro_torch.core.ksegments import KSegmentsConfig
    from repro_torch.core.ktuner import AdaptiveKSelector
    from repro_torch.kernels import ops
    from repro_torch.sim.batch_engine import simulate_grid
    from repro_torch.sim.simulator import SimConfig, simulate_suite
    from repro_torch.sim.torch_sim import ENGINE_METHODS
    from repro_torch.sim.traces import generate_suite

    trace = max((t for wf in wfs for t in wf.eligible_tasks(20)), key=lambda t: t.n_executions)
    execs = trace.executions[:KTUNER_OBSERVED]
    reopt_s: list[float] = []

    def timed(reoptimize):
        def timed_reoptimize():
            t0 = time.perf_counter()
            best = reoptimize()
            reopt_s.append(time.perf_counter() - t0)
            return best

        return timed_reoptimize

    card, cpu = AdaptiveKSelector(), AdaptiveKSelector(device="cpu")
    ops.reset_launch_counts()
    with _patched(card, "_reoptimize", timed):
        _, wall = _wall(lambda: [card.observe(e.input_size, e.series) for e in execs])
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    for e in execs:
        cpu.observe(e.input_size, e.series)
    cpu_s = time.perf_counter() - t0
    T = max(len(e.series) for e in execs)
    print(f"online phase: AdaptiveKSelector over {trace.name}'s first {len(execs)} executions (T up to {T}), "
          f"{len(reopt_s)} reoptimisations of {len(card.candidates)} candidates: card {wall:.3f} s, cold reoptimisation "
          f"{reopt_s[0] * 1e3:.2f} ms, warm median {statistics.median(reopt_s[1:]) * 1e3:.2f} ms, last "
          f"{reopt_s[-1] * 1e3:.2f} ms; cpu {cpu_s:.3f} s; launches {counts}")
    print(f"  history_k card {card.history_k}")
    prof = _profile(lambda: [sel.observe(e.input_size, e.series) for sel in [AdaptiveKSelector()] for e in execs])
    busy = prof["kernel_ms"] / 1e3 / prof["wall_s"]
    print(f"  profiled tuner run: wall {prof['wall_s']:.3f} s; kernels {prof['kernel_ms']:.2f} ms on the device "
          f"({100 * busy:.2f}% busy, {prof['launches']} launches, {TUNER_CHAIN_LAUNCHES} with the chains); host ms "
          f"{json.dumps({k: round(v, 2) for k, v in prof['phases_host_ms'].items()})} (torch_sim.predict was "
          f"{TUNER_CHAIN_PREDICT_MS})")
    if min(counts[k] for k in GRID_KERNELS) < 1 or counts["wastage"] != counts["segmax"]:
        _fail(f"the tuner's replays did not launch segmax and wastage once each: {counts}")
    if card.history_k != cpu.history_k or len(card.history_k) != len(execs) // card.refresh:
        _fail(f"AdaptiveKSelector: history_k on the card {card.history_k} differs from the cpu run {cpu.history_k}")

    corpus = generate_suite(seed=seed, scale=ORACLE_SCALE)
    cfg = SimConfig(min_executions=10, ksegments=KSegmentsConfig(error_mode="progressive"))
    ops.reset_launch_counts()
    got, grid_s = _wall(lambda: simulate_grid(corpus, ENGINE_METHODS, (0.5,), cfg))
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    want = simulate_suite(corpus, ENGINE_METHODS, (0.5,), cfg)
    oracle_s = time.perf_counter() - t0
    if [(r.task, r.method) for r in got] != [(r.task, r.method) for r in want]:
        _fail("grid and oracle rows differ")
    bad = [(r.task, r.method) for r, w in zip(got, want) if not _gate(r, w)]
    exact = sum(np.array_equal(r.retries, w.retries) for r, w in zip(got, want))
    print(f"  grid on the card vs the sequential oracle (scale {ORACLE_SCALE}, progressive, {len(ENGINE_METHODS)} "
          f"methods, fraction 0.5): "
          f"{len(got)} cells; card {grid_s:.3f} s, oracle {oracle_s:.3f} s; gate failed on {len(bad)}; retries "
          f"equal on {exact}; launches {counts}")
    if bad or min(counts[k] for k in GRID_KERNELS) < 1:
        _fail(f"grid vs oracle: the reference's gate failed on {bad[:5]}, or a kernel was not launched: {counts}")


# benchmarks/run.py:bench_serve's three streams (400 requests, seed 0) and its
# decision microbench (batches of 256 candidates against 256 and 1,024
# resident plans, budget 1e9 MiB so every candidate fits)
SERVE_STREAMS = {
    "poisson": dict(rate_per_s=8.0),
    "bursty": dict(arrival="bursty", rate_per_s=40.0, burst_factor=8.0, hbm_budget_mib=150_000.0),
    "diurnal": dict(arrival="diurnal", rate_per_s=12.0, diurnal_amp=0.8, hbm_budget_mib=80_000.0),
}
SERVE_REQUESTS = 400
ADMISSION_ENGINES = ("scalar", "batched", "batched device_min_batch=1", "sharded-scalar", "sharded")
ADMISSION_RESIDENT = (256, 1024)
ADMISSION_BATCH = 256
ADMISSION_MB_SHARDS = 8  # bench_serve's microbench shards


def _counted_paths(ctl, paths: collections.Counter):
    """Count the batches a batched controller decides on each of its paths:
    one candidate (``try_admit``), the host probe below ``device_min_batch``,
    the decision kernel at or above it."""
    for name, path in (("try_admit", "one"), ("_admit_host", "host"), ("_admit_device", "kernel")):
        def counted(*a, _orig=getattr(ctl, name), _path=path, **kw):
            paths[_path] += 1
            return _orig(*a, **kw)

        setattr(ctl, name, counted)
    return ctl


def _admission_bound(args, admits) -> tuple[float, str]:
    """The decision scan's bound: each input read once and the decisions
    written once, at the HBM rate; or, at the f64 rate, the operations this
    batch needs on its sorted probes: three binary searches a valid
    candidate for the ends of its windows ([start, end] and [start,
    release)), five operations a probe of its [start, end] window (the
    offset, the segment index merged along the sorted probes, two additions
    and the test) and two a probe of an admitted candidate's [start,
    release) (the switch index, merged the same way, and the addition)."""
    import math

    import torch

    from repro_torch.launch import roofline

    P, prof, starts, ends, rels, bnd, val, valext, sw, live, valid, _ = args
    lo = torch.searchsorted(P, starts, side="left")
    win = (torch.searchsorted(P, ends, side="right") - lo).clamp(min=0)
    held = (torch.searchsorted(P, rels, side="left") - lo).clamp(min=0)
    nbytes = sum(t.numel() * t.element_size() for t in args[:-1]) + admits.numel()
    nops = (int(valid.sum()) * 3 * math.ceil(math.log2(P.numel() + 1)) + 5 * int(win[valid].sum())
            + 2 * int(held[admits].sum()))
    return roofline.bound_ms(nbytes, nops, roofline.HW["peak_flops_f64"])


def _epoch_bound(args, t0: float, res) -> tuple[tuple[float, str], float]:
    """The carried epoch's bound, and the operations' time alone: the state
    read once and written once, the batch read once and the result row
    written once, at the HBM rate; or, at the f64 rate, the operations this
    batch needs, shard by shard: two
    additions an event folded (base0, its owner's sum) and one a live
    event of the decision prefix (its running sum); three binary searches a
    valid candidate for the ends of its windows; five operations a probe in
    a valid candidate's windows (the carried events in (start, end], the
    batch's starts and live switch instants in [start, end]) and two a
    probe at or after an admitted candidate's start (its event count, the
    addition); and a binary search a live event of the spliced row."""
    import math

    import torch

    from repro_torch.launch import roofline

    base0, tl_t, tl_d, tl_c, slot_fold, rel, starts, ends, rels, bnd, val, codes, valid = (a.cpu() for a in args)
    res = res.cpu()
    S, Cb = starts.shape
    admits = res[:, :Cb].bool()
    nbytes = 2 * sum(t.numel() * t.element_size() for t in (base0, tl_t, tl_d, tl_c, slot_fold)) + sum(
        t.numel() * t.element_size() for t in (rel, starts, ends, rels, bnd, val, codes, valid)) + res.numel() * 4
    nops = 0
    sw = torch.nextafter(starts[..., None] + bnd, torch.full_like(bnd, math.inf))
    live = torch.isfinite(bnd) & (starts[..., None] + bnd < rels[..., None])
    for s in range(S):
        gone = torch.isin(tl_c[s], rel[s][rel[s] >= 0])
        row = tl_t[s][~gone & torch.isfinite(tl_t[s])]
        folded = int((row <= t0).sum())
        old = row[row > t0]
        q = torch.cat([starts[s][valid[s]], sw[s][valid[s][:, None] & live[s]]])
        searches = 3 * int(valid[s].sum()) + int(res[s, Cb + 1])
        nops += 2 * folded + old.numel() + searches * math.ceil(math.log2(old.numel() + q.numel() + 2))
        for c in torch.nonzero(valid[s]).flatten().tolist():
            st, en = float(starts[s, c]), float(ends[s, c])
            nops += 5 * (int(((old > st) & (old <= en)).sum()) + int(((q >= st) & (q <= en)).sum()))
            if admits[s, c]:
                nops += 2 * (int((old >= st).sum()) + int((q >= st).sum()))
    return roofline.bound_ms(nbytes, nops, roofline.HW["peak_flops_f64"]), nops / roofline.HW["peak_flops_f64"] * 1e3


def _spread(counts) -> str:
    import torch

    counts = torch.as_tensor(counts, dtype=torch.float64)
    return f"mean {float(counts.mean()):.1f}, max {int(counts.max())}" if counts.numel() else "none"


def _admission_windows(args, admits) -> str:
    """Probes a candidate's window ([start, end], every valid candidate) and
    commit range ([start, release), every admitted one) hold: the counts
    ``_admission_bound`` forms, on the sorted probes."""
    import torch

    P, _, starts, ends, rels, *_, valid, _ = args
    lo = torch.searchsorted(P, starts, side="left")
    win = (torch.searchsorted(P, ends, side="right") - lo).clamp(min=0)
    held = (torch.searchsorted(P, rels, side="left") - lo).clamp(min=0)
    return (f"probes a window {_spread(win[valid].cpu())} (of {P.numel()}); a commit range "
            f"{_spread(held[admits.bool()].cpu())}")


def _epoch_windows(args, t0: float, res) -> str:
    """Probes a candidate's windows hold (the carried events in (start, end]
    and the batch's starts and live switch instants in [start, end], every
    valid candidate) and its commit range (both at or after its start, every
    admitted one): the counts ``_epoch_bound`` forms, shard by shard."""
    import math

    import torch

    base0, tl_t, tl_d, tl_c, slot_fold, rel, starts, ends, rels, bnd, val, codes, valid = (a.cpu() for a in args)
    res = res.cpu()
    S, Cb = starts.shape
    sw = torch.nextafter(starts[..., None] + bnd, torch.full_like(bnd, math.inf))
    live = torch.isfinite(bnd) & (starts[..., None] + bnd < rels[..., None])
    win, held = [], []
    for s in range(S):
        gone = torch.isin(tl_c[s], rel[s][rel[s] >= 0])
        row = tl_t[s][~gone & torch.isfinite(tl_t[s])]
        old = row[row > t0]
        q = torch.cat([starts[s][valid[s]], sw[s][valid[s][:, None] & live[s]]])
        for c in torch.nonzero(valid[s]).flatten().tolist():
            st, en = float(starts[s, c]), float(ends[s, c])
            win.append(int(((old > st) & (old <= en)).sum()) + int(((q >= st) & (q <= en)).sum()))
            if res[s, c]:
                held.append(int((old >= st).sum()) + int((q >= st).sum()))
    return f"probes a candidate's windows {_spread(win)}; a commit range {_spread(held)}"


def _ptxas_line(name: str) -> str:
    """Registers and spills of a kernel's build, one range over its entry points."""
    from repro_torch.kernels import build

    rows = _ptxas_summary(build.build_log(name))
    if not rows:
        return "no build log"
    regs = sorted(int(r) for _, r, _ in rows)
    spilled = [f"{k}: {sp}" for k, _, sp in rows if not sp.startswith("0 bytes spill stores")]
    return (f"{len(rows)} entry points, {regs[0]}-{regs[-1]} registers, "
            + ("; ".join(spilled) if spilled else "no spills"))


def admission_phase(dev, seed: int) -> tuple[dict[str, dict], dict[str, int]]:
    """The serving admission path: bench_serve's streams through every engine
    the port has, the batched engine against the scalar oracle and the
    sharded engine against the per-shard oracle decision for decision, then
    the decision microbench, the decision kernel at the microbench's shape
    against its plain loop and its bound, and the admission_epoch kernel at
    the sharded engine's microbench shape against its plain version and
    its bound."""
    import numpy as np
    import torch

    from repro_torch.analysis import trace_audit
    from repro_torch.kernels import admission, admission_epoch, ops
    from repro_torch.launch import roofline
    from repro_torch.serve.admission import AdmissionController, BatchedAdmissionController, ShardedAdmissionController
    from repro_torch.serve.stream import StreamConfig, make_controller, run_stream
    from repro_torch.sim.device_timeline import admission_epoch_plain, admission_scan_plain

    calls: list = []

    def capture(orig):
        def wrapped(*a):
            out = orig(*a)
            calls.append((a, out))
            return out

        return wrapped

    BatchedAdmissionController(1000.0, device_min_batch=1).try_admit_many(["w0", "w1"], [100, 200], 0.0)  # load
    ShardedAdmissionController(1000.0).try_admit_many(["w0", "w1"], [100, 200], 0.0)
    print(f"admission phase: bench_serve's streams ({SERVE_REQUESTS} requests, seed {seed}) through "
          f"{', '.join(ADMISSION_ENGINES)}")
    stream_epochs: list = []  # (stream, epoch args cloned) of every sharded decision batch

    def capture_stream_epoch(orig):
        def wrapped(*a, **kw):
            stream_epochs.append((stream, [x.clone() for x in a[:13]], *a[13:16]))
            return orig(*a, **kw)

        return wrapped

    stream_calls: dict[str, range] = {}  # each stream's decision-kernel calls
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with _patched(admission, "admission_cuda", capture), _patched(admission_epoch, "admission_epoch_cuda",
                                                                capture_stream_epoch):
        for name, kw in SERVE_STREAMS.items():
            stream, first_call = name, len(calls)
            cfg = StreamConfig(n_requests=SERVE_REQUESTS, seed=seed, **kw)
            runs = {}
            for engine in ADMISSION_ENGINES:
                paths: collections.Counter = collections.Counter()
                ctl = None
                if engine.startswith("batched"):
                    ctl = _counted_paths(BatchedAdmissionController(
                        cfg.hbm_budget_mib, k=cfg.k, interval_s=cfg.interval_s,
                        device_min_batch=1 if engine.endswith("=1") else 32), paths)
                elif engine == "sharded":  # count the non-empty decision batches
                    ctl = make_controller(cfg, engine)

                    def many(ids, *a, _orig=ctl.try_admit_many, _paths=paths):
                        _paths["kernel"] += len(ids) > 0
                        return _orig(ids, *a)

                    ctl.try_admit_many = many
                before, before_epoch = admission.launches, admission_epoch.launches
                res = run_stream(cfg, engine.split()[0], controller=ctl)
                torch.cuda.synchronize()
                launched = admission.launches - before
                launched_epoch = admission_epoch.launches - before_epoch
                runs[engine] = res
                print(f"    {name}/{engine}: admitted {res.admitted} rejected {res.rejected} evicted {res.evicted} "
                      f"finished {res.finished}; {res.decisions_per_s:.0f} decisions/s, p50 "
                      f"{res.p50_latency_s * 1e6:.1f} us, p99 {res.p99_latency_s * 1e6:.1f} us; wastage "
                      f"{res.wastage['segmentwise_gib_s']:.3f} GiB*s (peak reservation "
                      f"{res.wastage['peak_reservation_gib_s']:.3f}); admission launches {launched}, "
                      f"admission_epoch launches {launched_epoch}"
                      + (f"; batches by path {dict(paths)}" if engine.startswith("batched") else "")
                      + (f"; decision batches {paths['kernel']}, reseeds {ctl.reseeds}, axis L {ctl._L}, "
                         f"codes {ctl._Smax}" if engine == "sharded" else ""))
                if engine.endswith("=1") and launched == 0:
                    _fail(f"admission {name}: the batched engine at device_min_batch=1 launched no decision kernel")
                if engine.startswith("batched") and launched != paths["kernel"]:
                    _fail(f"admission {name}/{engine}: {launched} launches for {paths['kernel']} kernel batches")
                if engine == "sharded" and (launched_epoch != paths["kernel"] or ctl.reseeds or not launched_epoch):
                    _fail(f"admission {name}/sharded: {launched_epoch} admission_epoch launches for "
                          f"{paths['kernel']} decision batches, {ctl.reseeds} reseeds")
            want = runs["scalar"]
            for engine in ADMISSION_ENGINES[1:3]:
                got = runs[engine]
                if got.decisions != want.decisions or (got.evicted, got.finished) != (want.evicted, want.finished):
                    _fail(f"admission {name}: {engine} decisions differ from the scalar oracle's")
            got, want = runs["sharded"], runs["sharded-scalar"]
            if got.decisions != want.decisions or (got.evicted, got.finished) != (want.evicted, want.finished):
                _fail(f"admission {name}: sharded decisions differ from the per-shard oracle's")
            stream_calls[name] = range(first_call, len(calls))
    counts = ops.launch_counts()
    print(f"  streams: {time.perf_counter() - t0:.2f} s; launches of these runs {counts}; batched decisions equal "
          f"to the scalar oracle's and sharded decisions to the per-shard oracle's on every stream")
    if counts["admission"] != len(calls):
        _fail(f"admission: {counts['admission']} launches but {len(calls)} calls of the wrapper")
    bad = sum(not torch.equal(out, admission_scan_plain(*a)) for a, out in calls)
    if bad:
        _fail(f"admission: {bad} of the streams' {len(calls)} decision-kernel calls differ from the plain loop")
    poisson_calls = [calls[i][0] for i in stream_calls["poisson"]]  # the microbench reuses `calls`
    print(f"  the streams' {len(calls)} decision-kernel calls equal to the plain loop on the same inputs "
          f"(largest C {max(a[5].shape[0] for a, _ in calls)}, Pp {max(a[0].shape[0] for a, _ in calls)})")

    # bench_serve's microbench
    rng = np.random.default_rng(seed)
    ids = [f"c{i}" for i in range(ADMISSION_BATCH)]
    plens = [int(rng.integers(100, 2000)) for _ in ids]

    def make(cls, n_active):
        kw = dict(n_shards=ADMISSION_MB_SHARDS) if cls is ShardedAdmissionController else {}
        ctl = cls(hbm_budget_mib=1e9, k=4, interval_s=1.0, **kw)
        r = np.random.default_rng(seed + 1)
        for _ in range(40):
            plen = int(r.integers(100, 2000))
            ctl.observe(plen, (plen * 0.02 + 0.6 * np.arange(int(60 + plen * 0.05))).astype(np.float32))
        for i in range(n_active):
            if ctl.try_admit(f"res{i}", int(r.integers(100, 2000)), i * 0.05) is None:
                _fail("admission microbench: a resident plan was refused")
        return ctl, n_active * 0.05 + 0.5

    def one_round(ctl, batched, t):
        got = ctl.try_admit_many(ids, plens, t) if batched else [ctl.try_admit(i, p, t) for i, p in zip(ids, plens)]
        if not all(g is not None for g in got):
            _fail("admission microbench: a candidate was refused under a budget that fits all")
        for i in ids:
            ctl.release(i)

    epoch_calls: list = []

    def capture_epoch(orig):
        def wrapped(*a, **kw):
            epoch_calls.append((a, {k: v for k, v in kw.items() if k != "out"}))
            return orig(*a, **kw)

        return wrapped

    shape_args = None
    for n_active in ADMISSION_RESIDENT:
        engines = {"batched": (BatchedAdmissionController, True), "sharded": (ShardedAdmissionController, True)}
        if n_active == ADMISSION_RESIDENT[0]:
            engines = {"scalar": (AdmissionController, False), **engines}
        line, us = [], {}
        for engine, (cls, batched) in engines.items():
            ctl, t_probe = make(cls, n_active)
            calls.clear()
            epoch_calls.clear()
            with _patched(admission, "admission_cuda", capture), _patched(admission_epoch, "admission_epoch_cuda",
                                                                        capture_epoch):
                one_round(ctl, batched, t_probe)  # warm
                if engine == "sharded":
                    one_round(ctl, batched, t_probe)  # the carried axes settle
            if engine == "batched":
                shape_args = calls[-1][0]
            if engine == "sharded":
                # the epoch's inputs, copied before the next rounds reuse the buffers
                epoch_args = ([x.clone() for x in epoch_calls[-1][0][:13]], *epoch_calls[-1][0][13:16])
                aten = trace_audit.launching_ops(lambda: one_round(ctl, batched, t_probe))
            n, t1 = 0, time.perf_counter()
            while time.perf_counter() - t1 < 1.0:
                one_round(ctl, batched, t_probe)
                n += 1
            us[engine] = (time.perf_counter() - t1) * 1e6 / (n * ADMISSION_BATCH)
            line.append(f"{engine} {us[engine]:.2f} us a decision ({n} rounds)")
            if engine == "sharded":
                line.append(f"sharded at {ADMISSION_MB_SHARDS} shards: reseeds {ctl.reseeds}, axis L {ctl._L}, "
                            f"live events a shard {ctl._n_live.tolist()}, {aten} aten ops that launch in one warm "
                            f"batch")
                if ctl.reseeds:
                    _fail(f"admission microbench: the sharded engine reseeded {ctl.reseeds} times")
        line.append(f"carried_speedup {us['batched'] / us['sharded']:.2f} (batched / sharded)")
        print(f"  microbench, {n_active} resident, batches of {ADMISSION_BATCH}: {'; '.join(line)}")

    # the decision kernel at the microbench's shape (1,024 resident); its
    # decisions are checked twice: under the microbench's budget, where all
    # are admitted, and under one that binds partway through the batch (the
    # profile's peak plus 64 of the largest plan)
    a = shape_args
    got, want = ops.admission_scan(*a), admission_scan_plain(*a)
    tight = (*a[:-1], float(a[1].max()) + 64 * float(a[6][:, -1].max()))
    got_tight, want_tight = ops.admission_scan(*tight), admission_scan_plain(*tight)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        _fail("admission: the kernel's decisions differ from the plain loop's at the microbench's shape")
    if not torch.equal(got_tight, want_tight):
        _fail("admission: under a binding budget the kernel's decisions differ from the plain loop's")
    if not 0 < int(want_tight.sum()) < want_tight.numel():
        _fail(f"admission: the binding budget admitted {int(want_tight.sum())} of {want_tight.numel()}")
    Pp, (C, k) = a[0].shape[0], a[5].shape
    plan = admission.plan(Pp, C, k)
    ms = _cuda_ms(lambda: ops.admission_scan(*a), 50)
    device_ms = _device_ms(lambda: ops.admission_scan(*a), "decide_kernel", 40)
    plain_ms = _cuda_ms(lambda: admission_scan_plain(*a), 3)
    bound_ms, bound_by = _admission_bound(a, got)
    byte_ms = roofline.bound_ms(sum(t.numel() * t.element_size() for t in a[:-1]) + C, 0)[0]
    print(f"  decision kernel at the microbench's shape (C {C}, Pp {Pp}, k {k}; {int(got.sum())} admitted; plan "
          f"{plan}): equal to the plain loop, and under a binding budget ({int(got_tight.sum())} admitted); kernel {ms:.4f} ms back to back, profiled {device_ms:.4f} ms; plain "
          f"loop {plain_ms:.3f} ms; bound {bound_ms:.6f} ms ({bound_by}; bytes alone {byte_ms:.6f} ms)")
    decide = dict(max_abs_err=float((got.int() - want.int()).abs().max().item()), ms=ms, plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=bound_by, device_ms=device_ms)

    # the admission_epoch kernel at the sharded engine's shape (1,024
    # resident, 8 shards): every output bit for bit against the plain version
    state_batch, t_e, budget_e, Lp = epoch_args
    spare = tuple(torch.empty_like(x) for x in state_batch[:5])
    res, *state = ops.admission_epoch(*state_batch, t_e, budget_e, Lp, out=spare)
    plain = admission_epoch_plain(*state_batch, t_e, budget_e, Lp)
    torch.cuda.synchronize()
    S, Cb = state_batch[6].shape
    pieces = [(res[:, :Cb].bool(), plain[0]), (res[:, Cb].bool(), plain[1]), (res[:, Cb + 1], plain[2].int()),
              *zip(state, plain[3:])]
    same = [_same_bits(g, w) for g, w in pieces]
    if not all(same):
        _fail(f"admission_epoch: the kernel differs from its plain version at the microbench's shape ({same})")
    if bool(plain[1].any()) or not bool(plain[0].any()):
        _fail("admission_epoch: the microbench's epoch overflowed or admitted nothing")
    err = max(float((g.double() - w.double()).abs().max()) if g.is_floating_point() else
              float((g.long() - w.long()).abs().max()) for g, w in pieces)
    L, Smax, k = state_batch[1].shape[1], state_batch[4].shape[1], state_batch[9].shape[2]
    eplan = admission_epoch.plan(L, Lp if Lp is not None else L, Smax, Cb, k)
    e_ms = _cuda_ms(lambda: ops.admission_epoch(*state_batch, t_e, budget_e, Lp, out=spare), 50)
    e_device_ms = _device_ms(lambda: ops.admission_epoch(*state_batch, t_e, budget_e, Lp, out=spare), "epoch_kernel",
                             40)
    e_plain_ms = _cuda_ms(lambda: admission_epoch_plain(*state_batch, t_e, budget_e, Lp), 2)
    (e_bound_ms, e_bound_by), e_ops_ms = _epoch_bound(state_batch, t_e, res)
    print(f"  admission_epoch kernel at the sharded microbench's shape (S {S}, L {L}, Lp {Lp}, Smax {Smax}, Cb {Cb}, "
          f"k {k}, Rb {state_batch[5].shape[1]}; live events a shard {res[:, Cb + 1].tolist()}, "
          f"{int(res[:, :Cb].sum())} admitted; plan {eplan}): every output bit for bit equal to the plain version; "
          f"kernel {e_ms:.4f} ms back to back, profiled {e_device_ms:.4f} ms; plain {e_plain_ms:.3f} ms; bound "
          f"{e_bound_ms:.6f} ms ({e_bound_by}; operations alone {e_ops_ms:.6f} ms)")
    epoch = dict(max_abs_err=err, ms=e_ms, plain_ms=e_plain_ms, bound_ms=e_bound_ms, bound_by=e_bound_by,
                 device_ms=e_device_ms)
    print(f"    decision kernel: {_admission_windows(a, got)}; build {_ptxas_line('admission')}")
    print(f"    admission_epoch kernel: {_epoch_windows(state_batch, t_e, res)}; build "
          f"{_ptxas_line('admission_epoch')}")

    # both kernels once more at the largest poisson batch the stream sweep
    # captured (the streams' batches are smaller than the microbench's)
    sa = max(poisson_calls, key=lambda x: x[5].shape[0])
    s_got = ops.admission_scan(*sa)
    if not torch.equal(s_got, admission_scan_plain(*sa)):
        _fail("admission: the kernel differs from the plain loop at the largest poisson batch")
    decide["stream_ms"] = _cuda_ms(lambda: ops.admission_scan(*sa), 50)
    decide["stream_device_ms"] = _device_ms(lambda: ops.admission_scan(*sa), "decide_kernel", 40)
    print(f"  decision kernel at the largest poisson batch (C {sa[5].shape[0]}, Pp {sa[0].shape[0]}; "
          f"{_admission_windows(sa, s_got)}): equal to the plain loop; kernel {decide['stream_ms']:.4f} ms back to "
          f"back, profiled {decide['stream_device_ms']:.4f} ms")
    _, eb, et0, ebudget, eLp = max((x for x in stream_epochs if x[0] == "poisson"), key=lambda x: int(x[1][12].sum()))
    espare = tuple(torch.empty_like(x) for x in eb[:5])
    eres, *estate = ops.admission_epoch(*eb, et0, ebudget, eLp, out=espare)
    eplain = admission_epoch_plain(*eb, et0, ebudget, eLp)
    eCb = eb[6].shape[1]
    if not all(_same_bits(g, w) for g, w in [(eres[:, :eCb].bool(), eplain[0]), (eres[:, eCb].bool(), eplain[1]),
                                              (eres[:, eCb + 1], eplain[2].int()), *zip(estate, eplain[3:])]):
        _fail("admission_epoch: the kernel differs from its plain version at the largest poisson batch")
    epoch["stream_ms"] = _cuda_ms(lambda: ops.admission_epoch(*eb, et0, ebudget, eLp, out=espare), 50)
    epoch["stream_device_ms"] = _device_ms(lambda: ops.admission_epoch(*eb, et0, ebudget, eLp, out=espare),
                                           "epoch_kernel", 40)
    print(f"  admission_epoch kernel at the largest poisson batch (S {eb[6].shape[0]}, L {eb[1].shape[1]}, Lp {eLp}, "
          f"Cb {eCb}, {int(eb[12].sum())} candidates; {_epoch_windows(eb, et0, eres)}): every output bit for bit "
          f"equal to the plain version; kernel {epoch['stream_ms']:.4f} ms back to back, profiled "
          f"{epoch['stream_device_ms']:.4f} ms")
    return {"admission": decide, "admission_epoch": epoch}, {k: counts[k] for k in ("admission", "admission_epoch")}


MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_LAYERS = 8  # of 94: one layer's experts are 4.83 GB of bf16, the whole depth does not fit one card
MOE_REF_CAPACITY = 8.0  # the reference's MoE tests' factor (tests/test_models.py:25-26)
MOE_PREFILL_REPEATS = 3
# name, N, k, E, C, D, skew of the routing toward the low experts (so that
# the capacity drops); the first is the main path's prefill shape
MOE_CASES = (
    ("qwen3-moe prefill", 8192, 8, 128, 641, 4096, 3.0),
    ("qwen3-moe decode", 2, 8, 128, 1, 4096, 3.0),
    ("grok-1 widths", 8192, 2, 8, 2561, 6144, 2.0),
)
MOE_DEVICE_KERNELS = {"moe_dispatch": ("dispatch_kernel",), "moe_combine": ("combine_kernel",),
                      "moe_combine_bwd": ("combine_bwd_fill_kernel", "combine_bwd_kernel")}
PRODUCT_KERNELS = ("gemm", "xmma", "nvjet", "cutlass", "splitK")  # cuBLAS's product kernels, by name


def _with_capacity(model, factor: float):
    """The same weights under ``capacity_factor = factor``."""
    import dataclasses

    cfg = dataclasses.replace(model.cfg, capacity_factor=factor)
    model.cfg = cfg
    for block in model.layers:
        block.cfg = cfg
    return model


@contextlib.contextmanager
def _routes(record: list | None = None, pin: list | None = None):
    """Inside the block, each MoE layer's routing (``layers.route``, one
    call a layer, in order) appends its ids (N, k) to ``record``, or takes
    the ids ``pin[i]`` in its i-th call, its weights then this call's own
    probabilities at those ids, renormalised as ``route`` does.  Routing is
    a discontinuous function of the hidden state: two bf16 paths that differ
    by rounding may route a near-tie apart, and pinning one path's routes
    on the other compares the rest of the path alone."""
    import torch

    from repro_torch.models import layers as L

    orig, calls = L.route, [0]

    def route(xf, router, k):
        probs, weights, ids = orig(xf, router, k)
        if pin is not None:
            ids = pin[calls[0]]
            top = probs.gather(1, ids.long())
            weights = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
        if record is not None:
            record.append(ids)
        calls[0] += 1
        return probs, weights, ids

    L.route = route
    try:
        yield
    finally:
        L.route = orig


def _routes_apart(a: list, b: list) -> int:
    """(layer, token) pairs whose sets of experts differ between two runs'
    routes."""
    import torch

    return sum(int((torch.sort(x, -1).values != torch.sort(y, -1).values).any(-1).sum()) for x, y in zip(a, b))


def _moe_case(name: str, N: int, k: int, E: int, C: int, D: int, skew: float, dev) -> dict[str, dict]:
    """Both MoE kernels bit for bit against their plain versions at one
    shape (bf16 rows, routing from biased random logits), timed beside
    their bounds, the plain versions and the library yardsticks."""
    import torch

    from repro_torch.kernels import moe_combine, moe_dispatch
    from repro_torch.launch import roofline

    g = torch.Generator(device=dev).manual_seed(N + E)
    logits = torch.randn((N, E), generator=g, device=dev) - skew * torch.arange(E, device=dev) / E
    top = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True)
    ids = top.indices[:, :k].to(torch.int32).contiguous()
    w = (top.values[:, :k] / top.values[:, :k].sum(-1, keepdim=True)).contiguous()
    x = torch.randn((N, D), generator=g, device=dev).to(torch.bfloat16)
    out_buf = torch.randn((E, C, D), generator=g, device=dev).to(torch.bfloat16)
    buf, pos = moe_dispatch.moe_dispatch_cuda(x, ids, E, C)
    want_buf, want_pos = moe_dispatch.moe_dispatch_plain(x, ids, E, C)
    got = moe_combine.moe_combine_cuda(out_buf, ids, pos, w)
    want = moe_combine.moe_combine_plain(out_buf, ids, pos, w)
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int16)  # noqa: E731
    if not (torch.equal(pos, want_pos) and torch.equal(bits(buf), bits(want_buf))):
        _fail(f"moe {name}: dispatch differs from its plain version")
    if not torch.equal(bits(got), bits(want)):
        _fail(f"moe {name}: combine differs from its plain version")
    kept = pos < C
    n_kept, dropped = int(kept.sum()), N * k - int(kept.sum())
    if dropped == 0:
        _fail(f"moe {name}: the capacity dropped nothing, the case checks no drop")
    reps = 20 if N > 64 else 200
    prof_calls = max(reps, 64)  # the profiler drops a window's first ~20 device events
    out = {}
    # dispatch; yardstick: one index_select of the rows, given the slot table
    tok = torch.arange(N, device=dev)[:, None].expand(N, k)
    slot = torch.full((E * C,), N, dtype=torch.int64, device=dev)
    slot[(ids.long() * C + pos.long())[kept]] = tok[kept]
    xz = torch.cat([x, torch.zeros((1, D), dtype=x.dtype, device=dev)])
    if not torch.equal(bits(torch.index_select(xz, 0, slot).view(E, C, D)), bits(buf)):
        _fail(f"moe {name}: the index_select yardstick computes another buffer")
    call = lambda: moe_dispatch.moe_dispatch_cuda(x, ids, E, C)  # noqa: E731
    launched = _device_launches(call, prof_calls)
    if sum(launched.values()) != prof_calls or not all("dispatch_kernel" in n for n in launched):
        _fail(f"moe {name}: {prof_calls} dispatch calls launched {dict(launched)} on the device, not one "
              f"dispatch_kernel each")
    # the bound counts what the batch needs: buf written once, the rows of
    # tokens with a kept assignment read once (and, beside it, every row)
    rows_read = int(kept.any(-1).sum())
    small = 4 * (ids.numel() + pos.numel())
    nbytes, all_bytes = 2 * (buf.numel() + rows_read * D) + small, 2 * (buf.numel() + x.numel()) + small
    bound_ms, bound_by = roofline.bound_ms(nbytes, 0)
    # the card's write and copy rates over a buffer of this size
    zero_ms = _cuda_ms(torch.empty_like(buf).zero_, reps)
    copy_ms = _cuda_ms(lambda: torch.empty_like(buf).copy_(buf), reps)
    buf_bytes = 2 * buf.numel()
    # the kernel and its yardstick back to back, each the best of three
    # windows: a window that the host falls behind in (a pause of the
    # process between launches) times the host, not the card
    out["moe_dispatch"] = dict(
        max_abs_err=(buf.float() - want_buf.float()).abs().max().item(),
        ms=min(_cuda_ms(call, reps) for _ in range(3)),
        plain_ms=_cuda_ms(lambda: moe_dispatch.moe_dispatch_plain(x, ids, E, C), max(reps // 4, 3)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=min(_cuda_ms(lambda: torch.index_select(xz, 0, slot), reps) for _ in range(3)))
    device = {n: _device_ms(call, n, prof_calls) for n in MOE_DEVICE_KERNELS["moe_dispatch"]}
    out["moe_dispatch"]["device_ms"] = sum(device.values())
    # combine; yardstick: one index_add_ of the weighted slot rows (the
    # multiply done before, not timed), adding in another order
    w_slot = torch.zeros((E * C,), dtype=torch.float32, device=dev)
    w_slot[(ids.long() * C + pos.long())[kept]] = w[kept]
    weighted = (out_buf.view(E * C, D) * w_slot[:, None].to(out_buf.dtype)).contiguous()
    base = torch.zeros((N + 1, D), dtype=out_buf.dtype, device=dev)
    lib = lambda: torch.index_add(base, 0, slot, weighted)  # noqa: E731
    lib_err = (lib()[:N].float() - got.float()).abs().max().item()
    ccall = lambda: moe_combine.moe_combine_cuda(out_buf, ids, pos, w)  # noqa: E731
    cbytes = 2 * (n_kept * D + N * D) + 4 * 3 * ids.numel()
    cbound_ms, cbound_by = roofline.bound_ms(cbytes, 2 * n_kept * D)
    out["moe_combine"] = dict(
        max_abs_err=(got.float() - want.float()).abs().max().item(), ms=_cuda_ms(ccall, reps),
        plain_ms=_cuda_ms(lambda: moe_combine.moe_combine_plain(out_buf, ids, pos, w), max(reps // 4, 3)),
        bound_ms=cbound_ms, bound_by=cbound_by, library_ms=_cuda_ms(lib, reps),
        device_ms=_device_ms(ccall, "combine_kernel", prof_calls))
    d, c = out["moe_dispatch"], out["moe_combine"]
    print(f"  (e) {name:17s} N {N} k {k} E {E} C {C} D {D} bf16: {dropped} of {N * k} assignments dropped; "
          f"both bit for bit equal to the plain versions")
    print(f"      dispatch {d['ms']:.4f} ms (device: " + ", ".join(f"{n} {t:.4f}" for n, t in device.items())
          + f"; one device launch a call, {prof_calls} of {prof_calls} profiled), plain {d['plain_ms']:.4f}, "
          f"index_select {d['library_ms']:.4f}, bound {d['bound_ms']:.4f} ({d['bound_by']}: {nbytes / 1e6:.1f} MB "
          f"with the {rows_read} rows of tokens with a kept assignment, {all_bytes / 1e6:.1f} MB with all {N} rows, "
          f"{roofline.bound_ms(all_bytes, 0)[0]:.4f} ms); the card's write rate {buf_bytes / zero_ms / 1e9:.3f} TB/s "
          f"(buf.zero_ {zero_ms:.4f} ms), copy rate {2 * buf_bytes / copy_ms / 1e9:.3f} TB/s read + write "
          f"(empty_like(buf).copy_(buf) {copy_ms:.4f} ms)")
    print(f"      combine  {c['ms']:.4f} ms (device {c['device_ms']:.4f}), plain {c['plain_ms']:.4f}, index_add_ "
          f"{c['library_ms']:.4f} (max |d| vs kernel {lib_err:.3e}), bound {c['bound_ms']:.4f} ({c['bound_by']}, "
          f"{cbytes / 1e6:.1f} MB)")
    del buf, want_buf, out_buf, xz, weighted, base
    return out


def _device_launches(call, n: int) -> collections.Counter:
    """Device kernels that ``n`` calls of ``call()`` launch, by name, from
    the profiler's events.  The window opens with 64 launches of a fill,
    which take the place of the first device events that the profiler
    drops.  A window that kept fewer than ``n`` launches of the calls
    (the profiler dropped past the fills, or kept no device event at all)
    is taken again, up to three windows; the last is returned, so a call
    that launches nothing still shows short."""
    import torch

    pad = torch.empty(1, device="cuda")

    def run():
        for _ in range(64):
            pad.fill_(0.0)
        for _ in range(n):
            call()

    for _ in range(3):
        prof = _profile(run)
        launched = collections.Counter({name: cnt for name, (_, cnt) in prof["top_all"] if "FillFunctor" not in name})
        if sum(launched.values()) >= n:
            break
    return launched


def _device_split(prof: dict) -> dict[str, float]:
    """A profiled run's device ms by family: flash, the two MoE kernels,
    the two recurrent kernels, the products, the rest."""
    split = collections.Counter()
    for n, (ms, _) in prof["top_all"]:
        if FLASH_KERNELS in n:
            split["flash"] += ms
        elif any(k in n for k in MOE_DEVICE_KERNELS["moe_dispatch"]):
            split["moe_dispatch"] += ms
        elif "combine_kernel" in n:
            split["moe_combine"] += ms
        elif "wkv_kernel" in n:
            split["rwkv_wkv"] += ms
        elif "rglru_kernel" in n:
            split["rglru_scan"] += ms
        elif any(k in n for k in PRODUCT_KERNELS):
            split["products"] += ms
        else:
            split["other"] += ms
    return split


def moe_phase(dev) -> tuple[dict[str, dict], dict[str, int]]:
    """MoE serving at the full width of qwen3-moe-235b-a22b, 8 layers."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash, moe_combine, moe_dispatch, ops
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models.model import decode_step, forward, init_params
    from repro_torch.serve import AdmissionController, cache_bytes_per_token
    from repro_torch.serve.engine import greedy_generate, make_decode_step, make_prefill_step

    whole = get_config(MOE_ARCH)
    cfg = dataclasses.replace(whole, num_layers=MOE_LAYERS)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    model, init_s = _wall(lambda: init_params(cfg, seed=0, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"moe phase: {cfg.name} at full width (d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}, {cfg.num_experts} experts top-{cfg.experts_per_token}, expert d_ff {cfg.moe_d_ff}, vocab "
          f"{cfg.vocab_size}), depth cut to {MOE_LAYERS} of {whole.num_layers} layers (the whole depth is "
          f"{whole.param_count() / 1e9:.1f} B parameters); {n_params / 1e9:.3f} B parameters, "
          f"{(torch.cuda.memory_allocated() - held) / 1e9:.2f} GB on the card ({held / 1e9:.2f} GB held before); "
          f"random weights from seed 0, init_params {init_s:.2f} s; capacity factor {cfg.capacity_factor}")

    # (a) the launcher's wave loop, its defaults
    ctl = AdmissionController(hbm_budget_mib=512.0, k=4, interval_s=1.0)
    bpt = cache_bytes_per_token(cfg) / 2**20
    ops.reset_launch_counts()
    res, wall = _wall(lambda: serve_requests(cfg, model, ctl, requests=24, decode_steps=SERVE_STEPS,
                                             bytes_per_token_mib=bpt, device=dev, log=lambda m: None))
    counts = ops.launch_counts()
    toks = torch.cat([o.flatten() for o in res["outputs"]])
    print(f"  (a) launcher loop: {res['done']} served in {res['waves']} waves, {res['rejected']} deferred, "
          f"wall {wall:.3f} s; launches {counts}")
    if res["done"] != 24 or sum(o.shape[0] for o in res["outputs"]) != 24:
        _fail(f"moe serve: {res['done']} of 24 requests served")
    if any(o.shape[1] != SERVE_STEPS for o in res["outputs"]) or not 0 <= int(toks.min()) <= int(toks.max()) < cfg.vocab_size:
        _fail("moe serve: generated tokens of the wrong shape or outside the vocabulary")
    if min(counts["flash"], counts["moe_dispatch"], counts["moe_combine"]) < 1:
        _fail(f"moe serve: flash, moe_dispatch or moe_combine was not launched on the serving path: {counts}")

    # (b) one long batch: prefill wall, ms per decode step, tokens/s
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + 1), generator=g, device=dev,
                           dtype=torch.int32)
    tokens = prompt[:, :SERVE_PROMPT].contiguous()
    cache_len = SERVE_PROMPT + SERVE_STEPS
    prefill = make_prefill_step(cfg, cache_len, device=dev)
    step = make_decode_step(cfg, device=dev)
    prefill(model, {"tokens": tokens})  # warm-up
    prefills = [_wall(lambda: prefill(model, {"tokens": tokens})) for _ in range(MOE_PREFILL_REPEATS)]
    (logits, cache), _ = prefills[-1]
    prefill_s = statistics.median(s for _, s in prefills)
    first = torch.argmax(logits, -1).to(torch.int32)

    def decode_all():
        last = [first]
        for i in range(SERVE_STEPS - 1):
            pos = torch.full((SERVE_BATCH,), SERVE_PROMPT + i, dtype=torch.int32, device=dev)
            lg, _ = step(model, cache, {"tokens": last[-1][:, None], "positions": pos})
            last.append(torch.argmax(lg, -1).to(torch.int32))
        return torch.stack(last, 1)

    decodes = [_wall(decode_all) for _ in range(SERVE_REPEATS)]
    gens = [_wall(lambda: greedy_generate(model, cfg, tokens, SERVE_STEPS, device=dev)) for _ in range(SERVE_REPEATS)]
    if not all(torch.equal(out, gens[0][0]) for out, _ in decodes + gens):
        _fail("moe serve: greedy tokens differ between repeats, or from greedy_generate")
    steps_ms = [s / (SERVE_STEPS - 1) * 1e3 for _, s in decodes]
    step_ms = statistics.median(steps_ms)
    gen_s = statistics.median(s for _, s in gens)
    prof = _profile(lambda: greedy_generate(model, cfg, tokens, SERVE_STEPS, device=dev))
    split = _device_split(prof)
    print(f"  (b) B {SERVE_BATCH} x {SERVE_PROMPT}-token prompt, {SERVE_STEPS} greedy tokens: prefill {prefill_s:.4f} s "
          f"(median of {' '.join(f'{s:.4f}' for _, s in prefills)}); decode {step_ms:.3f} ms/step (median of "
          f"{' '.join(f'{x:.3f}' for x in steps_ms)}); greedy_generate {gen_s:.4f} s (median of "
          f"{' '.join(f'{s:.4f}' for _, s in gens)}) = {SERVE_BATCH * SERVE_STEPS / gen_s:.2f} tokens/s; greedy "
          f"tokens identical across the {2 * SERVE_REPEATS} repeats")
    print(f"  profiled greedy_generate: wall {prof['wall_s']:.4f} s; kernels {prof['kernel_ms']:.2f} ms on the device "
          f"({100 * prof['kernel_ms'] / 1e3 / prof['wall_s']:.2f}% busy, {prof['launches']} launches): "
          + ", ".join(f"{n} {ms:.2f}" for n, ms in split.most_common()) + f"; copies {prof['copy_ms']:.2f} ms")
    for name, (ms, n) in prof["top"]:
        print(f"    {ms:9.3f} ms {n:6d} x  {name[:100]}")

    # (c) the cache contract at capacity 8.0: at the config's 1.25 a decode
    # step (N = B tokens) and forward on T + 1 tokens drop different
    # assignments, in the reference as here (GShard's capacity)
    # (c) the cache contract where no assignment can be dropped: a capacity
    # factor of E / k gives every expert room for every token of the call.
    # At the config's 1.25 a decode step and forward(T+1) drop different
    # assignments (GShard's capacity, in the reference as here), and the
    # random weights route so unevenly that the reference tests' 8.0 drops
    # too (the largest expert load is printed beside its capacity).  The
    # decode step may also route the new token apart from forward's at a
    # near-tie (two bf16 paths of other rounding): the contract is gated
    # with the decode's routes pinned to forward's, and without the pin
    # wherever no route fell apart.
    del cache
    factor = cfg.num_experts / cfg.experts_per_token
    _with_capacity(model, factor)
    fwd_routes, dec_routes = [], []
    with _routes(record=fwd_routes):
        full, _ = forward(model, prompt, last_only=True)
    _, c_cache = forward(model, tokens, want_cache=True, cache_len=cache_len)
    pinned_cache = [{n: t.clone() for n, t in c.items()} for c in c_cache]
    at = torch.full((SERVE_BATCH,), SERVE_PROMPT, dtype=torch.int32, device=dev)
    with _routes(record=dec_routes):
        dec, _ = decode_step(model, c_cache, prompt[:, SERVE_PROMPT:], at)
    last = [r.view(SERVE_BATCH, SERVE_PROMPT + 1, -1)[:, -1].contiguous() for r in fwd_routes]
    with _routes(pin=last):
        dec_pin, _ = decode_step(model, pinned_cache, prompt[:, SERVE_PROMPT:], at)
    apart = _routes_apart(last, dec_routes)
    n_fwd = SERVE_BATCH * (SERVE_PROMPT + 1)
    load = max(int(torch.bincount(r.reshape(-1).long(), minlength=cfg.num_experts).max()) for r in fwd_routes)
    scale = full.abs().max().item()
    c_err = (full[:, 0] - dec[:, 0]).abs().max().item() / scale
    c_pin = (full[:, 0] - dec_pin[:, 0]).abs().max().item() / scale
    print(f"  (c) cache contract at T={SERVE_PROMPT}, capacity factor E / k = {factor} (capacity "
          f"{int(n_fwd * cfg.experts_per_token / cfg.num_experts * factor) + 1}, nothing dropped; the largest expert "
          f"load of forward(T+1) is {load} of {n_fwd} tokens, against a capacity of "
          f"{int(n_fwd * cfg.experts_per_token / cfg.num_experts * MOE_REF_CAPACITY) + 1} at the reference tests' "
          f"{MOE_REF_CAPACITY} and {int(n_fwd * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor) + 1} "
          f"at the config's {cfg.capacity_factor}): |decode - forward(T+1)| / max|logits| = {c_pin:.3e} with the "
          f"decode's routes pinned to forward's (limit 2e-2); {c_err:.3e} unpinned, the new token routed apart in "
          f"{apart} of {len(last) * SERVE_BATCH} (layer, sequence) pairs (limit 2e-2 where none is)")
    if not np.isfinite(c_pin) or c_pin > 2e-2 or (apart == 0 and c_err > 2e-2):
        _fail(f"moe serve: prefill + decode_step off forward on T + 1 tokens by {c_pin:.3e} (pinned), "
              f"{c_err:.3e} (unpinned, {apart} routes apart) of max |logits|")
    del c_cache, pinned_cache, full, dec, dec_pin, fwd_routes
    _with_capacity(model, cfg.capacity_factor)

    # (d) the kernels against the plain path at the config's own capacity,
    # on (b)'s prompt: plain flash, dispatch and combine, with the plain
    # run's routes pinned to the kernels' (a near-tie routed apart also
    # moves which assignments the capacity drops), and unpinned
    kern_routes, plain_routes = [], []
    with _routes(record=kern_routes):
        logits, _ = prefill(model, {"tokens": tokens})
    before = ops.launch_counts()
    with _patched(ops, "flash_attention", lambda orig: flash.flash_attention_plain), \
            _patched(ops, "moe_dispatch", lambda orig: moe_dispatch.moe_dispatch_plain), \
            _patched(ops, "moe_combine", lambda orig: moe_combine.moe_combine_plain):
        with _routes(pin=kern_routes):
            (plain_logits, _), plain_s = _wall(lambda: prefill(model, {"tokens": tokens}))
        with _routes(record=plain_routes):
            free_logits, _ = prefill(model, {"tokens": tokens})
    if ops.launch_counts() != before:
        _fail("moe serve: the plain prefill launched a kernel")
    scale = plain_logits.abs().max().item()
    d_err = (plain_logits - logits).abs().max().item() / scale
    d_free = (free_logits - logits).abs().max().item() / scale
    apart = _routes_apart(kern_routes, plain_routes)
    agree = int((torch.argmax(plain_logits, -1) == torch.argmax(logits, -1)).sum())
    print(f"  (d) plain flash, dispatch and combine at capacity {cfg.capacity_factor}: prefill {plain_s:.4f} s; last "
          f"logits |kernels - plain| / max|logits| = {d_err:.3e} with the plain run's routes pinned to the kernels' "
          f"(limit 2e-2); {d_free:.3e} unpinned, {apart} of {len(kern_routes) * tokens.numel()} (layer, token) "
          f"routes apart (limit 2e-2 where none is); greedy first tokens agree {agree}/{SERVE_BATCH}")
    if not np.isfinite(d_err) or d_err > 2e-2 or (apart == 0 and d_free > 2e-2):
        _fail(f"moe serve: kernel logits off the plain path by {d_err:.3e} (pinned), {d_free:.3e} (unpinned, "
              f"{apart} routes apart) of max |logits| (limit 2e-2)")
    del model, logits, plain_logits, free_logits, kern_routes, plain_routes
    torch.cuda.empty_cache()

    # (e) both kernels bit for bit at the main path's shapes and grok-1's
    per = [_moe_case(*case, dev) for case in MOE_CASES]
    per_kernel = {n: per[0][n] for n in ("moe_dispatch", "moe_combine")}
    torch.cuda.empty_cache()
    return per_kernel, {n: counts[n] for n in ("moe_dispatch", "moe_combine")}


RECURRENT_ARCHS = ("rwkv6-1.6b", "recurrentgemma-2b")
RECURRENT_KERNELS = {"rwkv_wkv": "wkv_kernel", "rglru_scan": "rglru_kernel"}  # device kernels, by name
WKV_TOL = 1e-4  # kernel vs plain, of max |o| and of max |S|: 3-pass TF32 products against float32 ones
# name, B, T, width (heads for WKV, channels for RG-LRU), state nonzero; the
# first of each is the main path's prefill shape.  Each kernel at both
# models' widths: rwkv6's 32 heads / 2,048 channels, recurrentgemma's 40
# heads (d_model 2,560) / rnn width 2,560
WKV_CASES = (
    ("rwkv6 prefill", 2, 4096, 32, False),
    ("rwkv6 decode", 2, 1, 32, True),
    ("rwkv6 B 3 T 1000", 3, 1000, 32, True),
    ("d 2,560 prefill", 2, 4096, 40, False),
    ("d 2,560 decode", 2, 1, 40, True),
)
RGLRU_CASES = (
    ("recurrentgemma prefill", 2, 4096, 2560, False),
    ("recurrentgemma decode", 2, 1, 2560, True),
    ("recurrentgemma B 3 T 1000", 3, 1000, 2560, True),
    ("R 2,048 prefill", 2, 4096, 2048, False),
    ("R 2,048 decode", 2, 1, 2048, True),
)
NO_LIBRARY = {"rwkv_wkv": "no single PyTorch call runs a linear recurrence with a matrix state",
              "rglru_scan": "no single PyTorch call runs an affine recurrence"}


def _kernel_case(kernel: str, name: str, call, plain, nbytes: float, nops: float, exact: bool) -> dict:
    """One recurrent kernel against its plain version on the same inputs:
    the error (WKV within WKV_TOL of max |out|, RG-LRU bit for bit), one
    device launch a call (from the profiler's events), CUDA-event and
    profiled device time beside the bound and the plain version's time."""
    import torch

    from repro_torch.launch import roofline

    got, want = call(), plain()
    torch.cuda.synchronize()
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    scales = [w.abs().max().item() for w in want]
    if exact and not all(torch.equal(g, w) for g, w in zip(got, want)):
        _fail(f"{kernel} {name}: differs from its plain version (max |d| {max(errs):.3e})")
    if not exact and any(e > WKV_TOL * s for e, s in zip(errs, scales)):
        _fail(f"{kernel} {name}: off its plain version by {errs} against {WKV_TOL} of max |out| {scales}")
    device_name = RECURRENT_KERNELS[kernel]
    n_prof = 64
    launched = _device_launches(call, n_prof)
    if sum(launched.values()) != n_prof or not all(device_name in k for k in launched):
        _fail(f"{kernel} {name}: {n_prof} calls launched {dict(launched)} on the device, not one {device_name} each")
    reps = 20 if nbytes > 1e8 else 200
    ms = _cuda_ms(call, reps)
    device_ms = _device_ms(call, device_name, n_prof)
    plain_ms = _cuda_ms(plain, 3)
    bound_ms, bound_by = roofline.bound_ms(nbytes, nops)
    print(f"  (e) {kernel} {name:26s} {'bit for bit' if exact else f'max |d| {max(e / s for e, s in zip(errs, scales)):.2e} of max |out|'}; "
          f"{ms:.4f} ms (device {device_ms:.4f}; one device launch a call, {n_prof} of {n_prof} profiled), plain "
          f"{plain_ms:.3f}, bound {bound_ms:.5f} ({bound_by}: {nbytes / 1e6:.1f} MB, {nops / 1e9:.3f} GFLOP), "
          f"{100 * bound_ms / device_ms:.1f}% of it; library null: {NO_LIBRARY[kernel]}")
    return dict(max_abs_err=max(errs), ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def _wkv_args(B: int, T: int, H: int, stateful: bool, dev) -> tuple[tuple, float, float]:
    """A WKV case's inputs (r, k, v, logw, u, S0) on the card, its bytes and
    its operations."""
    import torch

    g = torch.Generator(device=dev).manual_seed(B * T + H)
    r, k, v = (torch.randn((B, T, H, 64), generator=g, device=dev) for _ in range(3))
    logw = torch.clamp(-torch.exp(torch.rand((B, T, H, 64), generator=g, device=dev) * 4.5 - 4.0), -1.2, -1e-6)
    u = torch.randn((H, 64), generator=g, device=dev) * 0.1
    S0 = torch.randn((B, H, 64, 64), generator=g, device=dev) if stateful else torch.zeros((B, H, 64, 64), device=dev)
    # bytes: r, k, v, logw read and o written once, S read and written once
    # (u too); operations: the token form's 5 a (key, value) pair
    nbytes = 4 * (5 * r.numel() + 2 * S0.numel() + u.numel())
    return (r, k, v, logw, u, S0), nbytes, 5 * r.numel() * 64


def _rglru_args(B: int, T: int, R: int, stateful: bool, dev) -> tuple[tuple, float, float]:
    """An RG-LRU case's inputs (a, b, h0) on the card, its bytes and its
    operations."""
    import torch

    g = torch.Generator(device=dev).manual_seed(B * T + R)
    a = torch.exp(-8.0 * torch.nn.functional.softplus(torch.tensor(4.0)) * torch.rand((B, T, R), generator=g, device=dev))
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * torch.randn((B, T, R), generator=g, device=dev)
    h0 = torch.randn((B, R), generator=g, device=dev) if stateful else torch.zeros((B, R), device=dev)
    nbytes = 4 * (3 * a.numel() + 2 * h0.numel())  # a, b read, h_seq written; h0 read, h_last written
    return (a, b, h0), nbytes, 2 * a.numel()


def _wkv_case(name: str, B: int, T: int, H: int, stateful: bool, dev) -> dict:
    from repro_torch.kernels import rwkv_wkv

    args, nbytes, nops = _wkv_args(B, T, H, stateful, dev)
    return _kernel_case("rwkv_wkv", name, lambda: rwkv_wkv.rwkv_wkv_cuda(*args), lambda: rwkv_wkv.wkv_plain(*args),
                        nbytes, nops, False)


def _rglru_case(name: str, B: int, T: int, R: int, stateful: bool, dev) -> dict:
    from repro_torch.kernels import rglru_scan

    args, nbytes, nops = _rglru_args(B, T, R, stateful, dev)
    return _kernel_case("rglru_scan", name, lambda: rglru_scan.rglru_scan_cuda(*args),
                        lambda: rglru_scan.rglru_scan_plain(*args), nbytes, nops, True)


def _recurrent_model(arch: str, dev) -> dict[str, int]:
    """One recurrent model at full width and depth through (a)-(d)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash, ops, rglru_scan, rwkv_wkv
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models.model import Transformer, decode_step, forward, init_params
    from repro_torch.serve import AdmissionController, cache_bytes_per_token
    from repro_torch.serve.engine import greedy_generate, make_decode_step, make_prefill_step

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    model, init_s = _wall(lambda: init_params(cfg, seed=0, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    kinds = collections.Counter(cfg.layer_kinds)
    print(f"recurrent phase: {cfg.name} at full width and depth ({cfg.num_layers} layers: "
          + ", ".join(f"{n} {k}" for k, n in kinds.items()) + f"; d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}); {n_params / 1e9:.3f} B parameters, "
          f"{(torch.cuda.memory_allocated() - held) / 1e9:.2f} GB on the card; random weights from seed 0, "
          f"init_params {init_s:.2f} s")
    mine = ("rwkv_wkv",) if "rwkv" in kinds else ("rglru_scan", "flash")

    # (a) the launcher's wave loop, its defaults
    ctl = AdmissionController(hbm_budget_mib=512.0, k=4, interval_s=1.0)
    bpt = max(cache_bytes_per_token(cfg) / 2**20, 1e-4)
    ops.reset_launch_counts()
    res, wall = _wall(lambda: serve_requests(cfg, model, ctl, requests=24, decode_steps=SERVE_STEPS,
                                             bytes_per_token_mib=bpt, device=dev, log=lambda m: None))
    counts = ops.launch_counts()
    toks = torch.cat([o.flatten() for o in res["outputs"]])
    print(f"  (a) launcher loop: {res['done']} served in {res['waves']} waves, {res['rejected']} deferred, "
          f"wall {wall:.3f} s; launches " + ", ".join(f"{n} {counts[n]}" for n in ("rwkv_wkv", "rglru_scan", "flash")))
    if res["done"] != 24 or sum(o.shape[0] for o in res["outputs"]) != 24:
        _fail(f"{arch} serve: {res['done']} of 24 requests served")
    if any(o.shape[1] != SERVE_STEPS for o in res["outputs"]) or not 0 <= int(toks.min()) <= int(toks.max()) < cfg.vocab_size:
        _fail(f"{arch} serve: generated tokens of the wrong shape or outside the vocabulary")
    if min(counts[n] for n in mine) < 1:
        _fail(f"{arch} serve: {' or '.join(mine)} was not launched on the serving path: {counts}")

    # (b) one long batch: prefill wall, ms per decode step, tokens/s
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + 1), generator=g, device=dev,
                           dtype=torch.int32)
    tokens = prompt[:, :SERVE_PROMPT].contiguous()
    cache_len = SERVE_PROMPT + SERVE_STEPS
    prefill = make_prefill_step(cfg, cache_len, device=dev)
    step = make_decode_step(cfg, device=dev)
    prefill(model, {"tokens": tokens})  # warm-up
    prefills = [_wall(lambda: prefill(model, {"tokens": tokens})) for _ in range(MOE_PREFILL_REPEATS)]
    (logits, cache), _ = prefills[-1]
    prefill_s = statistics.median(s for _, s in prefills)
    first = torch.argmax(logits, -1).to(torch.int32)

    def decode_all():
        last = [first]
        for i in range(SERVE_STEPS - 1):
            pos = torch.full((SERVE_BATCH,), SERVE_PROMPT + i, dtype=torch.int32, device=dev)
            lg, _ = step(model, cache, {"tokens": last[-1][:, None], "positions": pos})
            last.append(torch.argmax(lg, -1).to(torch.int32))
        return torch.stack(last, 1)

    # a decode step writes the recurrent state in place: each repeat
    # starts from a copy of the prefill's cache
    start = [{n: t.clone() for n, t in c.items()} for c in cache]

    def decode_from_start():
        with torch.inference_mode():  # the cache's tensors are inference tensors
            for c, s in zip(cache, start):
                for n, t in c.items():
                    t.copy_(s[n])
        return decode_all()

    decodes = [_wall(decode_from_start) for _ in range(SERVE_REPEATS)]
    gens = [_wall(lambda: greedy_generate(model, cfg, tokens, SERVE_STEPS, device=dev)) for _ in range(SERVE_REPEATS)]
    if not all(torch.equal(out, gens[0][0]) for out, _ in decodes + gens):
        _fail(f"{arch} serve: greedy tokens differ between repeats, or from greedy_generate")
    steps_ms = [s / (SERVE_STEPS - 1) * 1e3 for _, s in decodes]
    step_ms = statistics.median(steps_ms)
    gen_s = statistics.median(s for _, s in gens)
    prof = _profile(lambda: greedy_generate(model, cfg, tokens, SERVE_STEPS, device=dev))
    split = _device_split(prof)
    dprof = _profile(decode_from_start)
    dsplit = _device_split(dprof)
    flash_decode = [(ms, n) for name, (ms, n) in dprof["top_all"] if FLASH_KERNELS in name]
    print(f"  (b) B {SERVE_BATCH} x {SERVE_PROMPT}-token prompt, {SERVE_STEPS} greedy tokens: prefill {prefill_s:.4f} s "
          f"(median of {' '.join(f'{s:.4f}' for _, s in prefills)}); decode {step_ms:.3f} ms/step (median of "
          f"{' '.join(f'{x:.3f}' for x in steps_ms)}); greedy_generate {gen_s:.4f} s (median of "
          f"{' '.join(f'{s:.4f}' for _, s in gens)}) = {SERVE_BATCH * SERVE_STEPS / gen_s:.2f} tokens/s; greedy "
          f"tokens identical across the {2 * SERVE_REPEATS} repeats")
    print(f"  profiled greedy_generate: wall {prof['wall_s']:.4f} s; kernels {prof['kernel_ms']:.2f} ms on the device "
          f"({100 * prof['kernel_ms'] / 1e3 / prof['wall_s']:.2f}% busy, {prof['launches']} launches): "
          + ", ".join(f"{n} {ms:.2f}" for n, ms in split.most_common()) + f"; copies {prof['copy_ms']:.2f} ms")
    for name, (ms, n) in prof["top"]:
        print(f"    {ms:9.3f} ms {n:6d} x  {name[:100]}")
    print(f"  profiled decode ({SERVE_STEPS - 1} steps): wall {dprof['wall_s']:.4f} s; kernels {dprof['kernel_ms']:.2f} "
          f"ms ({100 * dprof['kernel_ms'] / 1e3 / dprof['wall_s']:.2f}% busy), {dprof['launches'] / (SERVE_STEPS - 1):.1f} "
          f"launches a step: " + ", ".join(f"{n} {ms:.3f}" for n, ms in dsplit.most_common())
          + (f"; flash's decode calls (T x G = {cfg.num_heads // cfg.num_kv_heads} > 4: the tensor-core path, over a "
             f"{min(cfg.window_size, cache_len)}-slot window cache): "
             + ", ".join(f"{name_ms[0]:.3f} ms over {name_ms[1]}" for name_ms in flash_decode)
             if flash_decode else ""))

    # (c) the cache contract and (d) the kernels against their plain
    # versions, each in bf16 and with the same weights in float32.  The
    # float32 runs hold the state's handling and the kernels' arithmetic to
    # 2e-2 where rounding cannot hide a fault; the bf16 runs are held to
    # 2e-2 or to twice the bf16 rounding distance of the model (its forward
    # against the float32 one's), whichever is larger: two bf16 paths that
    # round apart (the decode step's products of B rows against the
    # prefill's, the kernels' sums against the plain versions') may each lie
    # that distance from the float32 function, and with random weights a
    # flip of one bf16 rounding grows through the depth
    del cache, start, logits
    f32 = Transformer(dataclasses.replace(cfg, dtype="float32"), seed=None, device=dev).eval()
    f32.load_state_dict(model.state_dict())  # the bf16 weights, exactly
    at = torch.full((SERVE_BATCH,), SERVE_PROMPT, dtype=torch.int32, device=dev)

    def contract(m):
        full, _ = forward(m, prompt, last_only=True)
        _, c_cache = forward(m, tokens, want_cache=True, cache_len=cache_len)
        dec, _ = decode_step(m, c_cache, prompt[:, SERVE_PROMPT:], at)
        return full[:, 0], (full[:, 0] - dec[:, 0]).abs().max().item() / full.abs().max().item()

    full, c_err = contract(model)
    full32, c_err32 = contract(f32)
    delta = (full - full32).abs().max().item() / full32.abs().max().item()
    lim = max(2e-2, 2 * delta)
    print(f"  (c) cache contract at T={SERVE_PROMPT}: |decode - forward(T+1)| / max|logits| = {c_err32:.3e} with the "
          f"weights in float32 (limit 2e-2), {c_err:.3e} in bf16 (limit {lim:.3e}: the bf16 forward lies {delta:.3e} "
          f"from the float32 one)")
    if not np.isfinite(c_err32) or c_err32 > 2e-2 or not np.isfinite(c_err) or c_err > lim:
        _fail(f"{arch} serve: prefill + decode_step off forward on T + 1 tokens by {c_err32:.3e} (float32, limit "
              f"2e-2), {c_err:.3e} (bf16, limit {lim:.3e}) of max |logits|")
    del full, full32

    def kernels_vs_plain(m):
        logits, _ = prefill(m, {"tokens": tokens})
        before = ops.launch_counts()
        with _patched(ops, "flash_attention", lambda orig: flash.flash_attention_plain), \
                _patched(ops, "rwkv_wkv", lambda orig: rwkv_wkv.wkv_plain), \
                _patched(ops, "rglru_scan", lambda orig: rglru_scan.rglru_scan_plain):
            (plain_logits, _), plain_s = _wall(lambda: prefill(m, {"tokens": tokens}))
        if ops.launch_counts() != before:
            _fail(f"{arch} serve: the plain prefill launched a kernel")
        err = (plain_logits - logits).abs().max().item() / plain_logits.abs().max().item()
        return err, plain_s, int((torch.argmax(plain_logits, -1) == torch.argmax(logits, -1)).sum())

    d_err32, plain_s32, agree32 = kernels_vs_plain(f32)
    d_err, plain_s, agree = kernels_vs_plain(model)
    print(f"  (d) plain WKV, RG-LRU and flash: last logits |kernels - plain| / max|logits| = {d_err32:.3e} in float32 "
          f"(limit 2e-2; plain prefill {plain_s32:.4f} s), {d_err:.3e} in bf16 (limit {lim:.3e}; plain prefill "
          f"{plain_s:.4f} s); greedy first tokens agree {agree32}/{SERVE_BATCH}, {agree}/{SERVE_BATCH}")
    if not np.isfinite(d_err32) or d_err32 > 2e-2 or not np.isfinite(d_err) or d_err > lim:
        _fail(f"{arch} serve: kernel logits off the plain path by {d_err32:.3e} (float32, limit 2e-2), {d_err:.3e} "
              f"(bf16, limit {lim:.3e}) of max |logits|")
    del model, f32
    torch.cuda.empty_cache()
    return {n: counts[n] for n in mine}


def recurrent_phase(dev) -> tuple[dict[str, dict], dict[str, int]]:
    """rwkv6-1.6b and recurrentgemma-2b at full width and depth, then the
    WKV and RG-LRU kernels against their plain versions."""
    counts = {}
    for arch in RECURRENT_ARCHS:
        t0 = time.perf_counter()
        counts.update(_recurrent_model(arch, dev))
        print(f"  {arch}: {time.perf_counter() - t0:.2f} s")
    wkv = [_wkv_case(*case, dev) for case in WKV_CASES]
    lru = [_rglru_case(*case, dev) for case in RGLRU_CASES]
    return {"rwkv_wkv": wkv[0], "rglru_scan": lru[0]}, {n: counts[n] for n in ("rwkv_wkv", "rglru_scan")}


AUDIO_ARCH = "hubert-xlarge"
AUDIO_BATCH, AUDIO_FRAMES = 8, 1500  # eight 30-s clips at 50 frames a second
VISION_ARCH = "qwen2-vl-72b"
VISION_LAYERS = 16  # of 80: a layer is 1.755 GB of bf16, the whole depth ~145 GB
VISION_GRID = (16, 16)  # one 448 x 448 image: 32 x 32 patches of 14, merged 2 x 2
FRONTEND_REPEATS = 3
# name, (B, T, S, H, KV, hd), causal, window, softcap, positions, timed
FRONTEND_FLASH_CASES = (
    ("hubert prefill", (AUDIO_BATCH, AUDIO_FRAMES, AUDIO_FRAMES, 16, 16, 80), False, None, None, None, True),
    ("qwen2-vl prefill", (2, 4096, 4096, 64, 8, 128), True, None, None, None, True),
    ("qwen2-vl decode", (2, 1, 4112, 64, 8, 128), True, None, None, (4112, 3000), True),
)


def _mrope_grid(batch: int, n: int, rows: int, cols: int, dev):
    """Qwen2-VL's M-RoPE rows (3, batch, n) int32 for a sequence whose first
    rows x cols tokens are an image: image token i at (t 0, h i // cols,
    w i % cols); the text after it from max(rows, cols) on, the same on all
    three rows (and so on through the decode steps)."""
    import torch

    s = torch.arange(n, device=dev)
    P = rows * cols
    text = s - P + max(rows, cols)
    pos = torch.stack([torch.where(s < P, 0, text), torch.where(s < P, s // cols, text),
                       torch.where(s < P, s % cols, text)])
    return pos[:, None].expand(3, batch, n).to(torch.int32).contiguous()


def _split_line(prof: dict) -> str:
    split = _device_split(prof)
    return (f"wall {prof['wall_s']:.4f} s, kernels {prof['kernel_ms']:.2f} ms on the device "
            f"({100 * prof['kernel_ms'] / 1e3 / prof['wall_s']:.2f}% busy, {prof['launches']} launches): "
            + ", ".join(f"{n} {ms:.3f}" for n, ms in split.most_common()) + f"; copies {prof['copy_ms']:.2f} ms")


def _audio_model(dev) -> int:
    """hubert-xlarge at full width and depth: encode, gates, profile, plain."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash, ops
    from repro_torch.models.model import Transformer, forward, init_params
    from repro_torch.serve.engine import make_prefill_step

    cfg = get_config(AUDIO_ARCH)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    model, init_s = _wall(lambda: init_params(cfg, seed=0, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    B, T = AUDIO_BATCH, AUDIO_FRAMES
    print(f"frontend phase (a): {cfg.name} at full width and depth ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads of {cfg.head_dim}, non-causal, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.frontend_dim}-dim frames); {n_params / 1e9:.3f} B parameters, "
          f"{(torch.cuda.memory_allocated() - held) / 1e9:.2f} GB on the card; random weights from seed 0, "
          f"init_params {init_s:.2f} s; B {B} x T {T} seeded N(0, 1) bf16 frames")
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn((B, T, cfg.frontend_dim), generator=g, device=dev).to(torch.bfloat16)

    def encode(f=feats):
        return forward(model, features=f)[0]

    encode()  # warm-up
    ops.reset_launch_counts()
    logits, _ = _wall(encode)
    counts = ops.launch_counts()
    runs = [_wall(encode) for _ in range(FRONTEND_REPEATS)]
    wall = statistics.median(s for _, s in runs)
    print(f"  encode {wall:.4f} s (median of {' '.join(f'{s:.4f}' for _, s in runs)}) = {B * T / wall:,.0f} frames/s; "
          f"flash launches in one encode {counts['flash']}")
    if counts["flash"] != cfg.num_layers:
        _fail(f"{cfg.name}: {counts['flash']} flash launches in one encode, not one a layer ({cfg.num_layers})")
    if tuple(logits.shape) != (B, T, cfg.vocab_size) or not torch.isfinite(logits).all():
        _fail(f"{cfg.name}: logits of shape {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    if not all(torch.equal(out, logits) for out, _ in runs):
        _fail(f"{cfg.name}: the encode differs between repeats")
    scale = logits.abs().max().item()
    step_logits, cache = make_prefill_step(cfg, T, device=dev)(model, {"features": feats})
    last, _ = forward(model, features=feats, last_only=True)
    last_err = (step_logits - logits[:, -1]).abs().max().item() / scale
    print(f"  make_prefill_step: the last position's logits, equal to forward(last_only) {torch.equal(step_logits, last[:, 0])}, "
          f"|step - forward[:, -1]| / max|logits| {last_err:.3e} (limit 2e-2); cache {cache}")
    if cache is not None or not torch.equal(step_logits, last[:, 0]) or last_err > 2e-2:
        _fail(f"{cfg.name}: make_prefill_step's logits are not forward's last position")
    other = feats.clone()
    other[:, -1] = torch.randn((B, cfg.frontend_dim), generator=g, device=dev).to(torch.bfloat16)
    moved = (encode(other)[:, 0] - logits[:, 0]).abs().max().item() / scale
    print(f"  a new last frame moves the first frame's logits by {moved:.3e} of max |logits| (non-causal; the encode "
          f"repeats bit for bit)")
    if not moved > 0.0:
        _fail(f"{cfg.name}: the last frame does not reach the first position: the encoder is not non-causal")
    prof = _profile(encode)
    print(f"  profiled encode: {_split_line(prof)}")
    for name, (ms, n) in prof["top"]:
        print(f"    {ms:9.3f} ms {n:6d} x  {name[:100]}")
    if _device_split(prof)["flash"] <= 0.0:
        _fail(f"{cfg.name}: the profiled encode launched no flash kernel")
    # the plain attention against the kernel, with the bf16 weights and
    # with the same weights in float32: the float32 run holds the kernel's
    # arithmetic to 2e-2 where rounding cannot hide a fault; the bf16 run
    # to 2e-2 or to twice the model's own bf16 distance (its logits against
    # the float32 copy's), whichever is larger, as phase 14 (c), (d): two
    # bf16 paths that round apart may each lie that distance from the
    # float32 function, and through 48 layers of random weights a flip of
    # one rounding grows
    f32 = Transformer(dataclasses.replace(cfg, dtype="float32"), seed=None, device=dev).eval()
    f32.load_state_dict(model.state_dict())  # the bf16 weights, exactly

    def kernel_vs_plain(m, kernel_logits):
        before = flash.launches
        with _patched(ops, "flash_attention", lambda orig: flash.flash_attention_plain):
            plain, plain_s = _wall(lambda: forward(m, features=feats)[0])
        if flash.launches != before:
            _fail(f"{cfg.name}: the plain encode launched the kernel")
        return (plain - kernel_logits).abs().max().item() / plain.abs().max().item(), plain_s

    logits32 = forward(f32, features=feats)[0]
    delta = (logits - logits32).abs().max().item() / logits32.abs().max().item()
    lim = max(2e-2, 2 * delta)
    d_err32, plain_s32 = kernel_vs_plain(f32, logits32)
    del logits32
    d_err, plain_s = kernel_vs_plain(model, logits)
    print(f"  plain attention: |kernel - plain| / max|logits| = {d_err32:.3e} with the weights in float32 (limit "
          f"2e-2; plain encode {plain_s32:.4f} s), {d_err:.3e} in bf16 (limit {lim:.3e}: the bf16 encode lies "
          f"{delta:.3e} from the float32 one; plain encode {plain_s:.4f} s)")
    if not np.isfinite(d_err32) or d_err32 > 2e-2 or not np.isfinite(d_err) or d_err > lim:
        _fail(f"{cfg.name}: kernel logits off the plain path by {d_err32:.3e} (float32, limit 2e-2), {d_err:.3e} "
              f"(bf16, limit {lim:.3e}) of max |logits|")
    del model, f32, logits, runs
    torch.cuda.empty_cache()
    return counts["flash"]


def _vision_model(dev) -> int:
    """qwen2-vl-72b at full width, 16 layers: prefill and decode with an
    image on the first positions and M-RoPE rows, gates, profile, plain."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash, ops
    from repro_torch.models.model import decode_step, forward, init_params
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    whole = get_config(VISION_ARCH)
    cfg = dataclasses.replace(whole, num_layers=VISION_LAYERS)
    rows, cols = VISION_GRID
    P = rows * cols
    if P != cfg.num_patches:
        _fail(f"{cfg.name}: a {rows} x {cols} grid is not the config's {cfg.num_patches} patches")
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    model, init_s = _wall(lambda: init_params(cfg, seed=0, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    B, T, steps = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS
    print(f"frontend phase (b): {cfg.name} at full width (d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
          f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, M-RoPE sections {cfg.mrope_sections}), "
          f"depth cut to {VISION_LAYERS} of {whole.num_layers} layers (the whole depth is "
          f"{whole.param_count() / 1e9:.1f} B parameters); {n_params / 1e9:.3f} B parameters, "
          f"{(torch.cuda.memory_allocated() - held) / 1e9:.2f} GB on the card; random weights from seed 0, "
          f"init_params {init_s:.2f} s; B {B} x T {T} tokens, the first {P} an image ({rows} x {cols} merged "
          f"patches, seeded N(0, 1) bf16 embeddings)")
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=g, device=dev, dtype=torch.int32)
    patches = torch.randn((B, P, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    grid = _mrope_grid(B, T + steps, rows, cols, dev)
    inputs = {"tokens": prompt[:, :T].contiguous(), "patch_embeds": patches, "mrope_positions": grid[:, :, :T]}
    cache_len = T + steps
    prefill = make_prefill_step(cfg, cache_len, device=dev)
    step = make_decode_step(cfg, device=dev)
    prefill(model, inputs)  # warm-up
    ops.reset_launch_counts()
    prefills = [_wall(lambda: prefill(model, inputs)) for _ in range(FRONTEND_REPEATS)]
    (logits, cache), _ = prefills[-1]
    prefill_s = statistics.median(s for _, s in prefills)
    first = torch.argmax(logits, -1).to(torch.int32)

    def decode_all():
        last = [first]
        for i in range(steps - 1):
            pos = torch.full((B,), T + i, dtype=torch.int32, device=dev)
            lg, _ = step(model, cache, {"tokens": last[-1][:, None], "positions": pos,
                                        "mrope_positions": grid[:, :, T + i : T + i + 1]})
            last.append(torch.argmax(lg, -1).to(torch.int32))
        return torch.stack(last, 1)

    decodes = [_wall(decode_all) for _ in range(SERVE_REPEATS)]
    counts = ops.launch_counts()
    want_flash = cfg.num_layers * (FRONTEND_REPEATS + SERVE_REPEATS * (steps - 1))
    if counts["flash"] != want_flash:
        _fail(f"{cfg.name}: {counts['flash']} flash launches in {FRONTEND_REPEATS} prefills and {SERVE_REPEATS} "
              f"decodes, not one a layer call ({want_flash})")
    firsts = [torch.argmax(lg, -1) for (lg, _), _ in prefills]
    if not all(torch.equal(f, firsts[0]) for f in firsts) or not all(torch.equal(o, decodes[0][0]) for o, _ in decodes):
        _fail(f"{cfg.name}: greedy tokens differ between repeats")
    steps_ms = [s / (steps - 1) * 1e3 for _, s in decodes]
    step_ms = statistics.median(steps_ms)
    print(f"  prefill {prefill_s:.4f} s (median of {' '.join(f'{s:.4f}' for _, s in prefills)}); decode "
          f"{step_ms:.3f} ms/step (median of {' '.join(f'{x:.3f}' for x in steps_ms)}) = {B * 1e3 / step_ms:.2f} "
          f"tokens/s; {steps} greedy tokens {B * steps / (prefill_s + step_ms * (steps - 1) / 1e3):.2f} tokens/s with "
          f"the prefill; greedy tokens identical across the repeats; flash launches {counts['flash']}")
    pprof = _profile(lambda: prefill(model, inputs))
    dprof = _profile(decode_all)
    G = cfg.num_heads // cfg.num_kv_heads
    flash_decode = [(ms, n) for name, (ms, n) in dprof["top_all"] if FLASH_KERNELS in name]
    print(f"  profiled prefill: {_split_line(pprof)}")
    for name, (ms, n) in pprof["top"]:
        print(f"    {ms:9.3f} ms {n:6d} x  {name[:100]}")
    print(f"  profiled decode ({steps - 1} steps, {dprof['launches'] / (steps - 1):.1f} launches a step): "
          f"{_split_line(dprof)}; flash's decode kernels ({flash.kernel_plan(torch.bfloat16, cfg.head_dim, G)[0]} "
          f"path at T x G = {G}): "
          + ", ".join(f"{ms:.3f} ms over {n}" for ms, n in flash_decode))
    if _device_split(pprof)["flash"] <= 0.0 or not flash_decode:
        _fail(f"{cfg.name}: a profiled prefill or decode launched no flash kernel")

    # (c) the cache contract: prefill on T, decode with its M-RoPE rows,
    # against forward on T + 1 (last only)
    del cache
    full, _ = forward(model, prompt, patch_embeds=patches, mrope_positions=grid[:, :, : T + 1], last_only=True)
    _, c_cache = forward(model, **inputs, want_cache=True, cache_len=cache_len)
    at = torch.full((B,), T, dtype=torch.int32, device=dev)
    dec, _ = decode_step(model, c_cache, prompt[:, T:], at, mrope_positions=grid[:, :, T : T + 1])
    seq_pos = all(torch.equal(c["pos"][:, : T + 1], torch.arange(T + 1, device=dev, dtype=torch.int32).expand(B, -1))
                  for c in c_cache)
    c_err = (full[:, 0] - dec[:, 0]).abs().max().item() / full.abs().max().item()
    print(f"  (c) cache contract at T={T}: |decode - forward(T+1)| / max|logits| = {c_err:.3e} (limit 2e-2); every "
          f"layer's cache holds the sequence positions 0..T: {seq_pos}")
    if not np.isfinite(c_err) or c_err > 2e-2 or not seq_pos:
        _fail(f"{cfg.name}: prefill + decode_step off forward on T + 1 by {c_err:.3e} of max |logits| (limit 2e-2), "
              f"or a cache holds other positions")
    del c_cache, full

    # (d) the kernel against the plain path, (e) M-RoPE reaches the model
    before = flash.launches
    with _patched(ops, "flash_attention", lambda orig: flash.flash_attention_plain):
        (plain, _), plain_s = _wall(lambda: prefill(model, inputs))
    if flash.launches != before:
        _fail(f"{cfg.name}: the plain prefill launched the kernel")
    d_err = (plain - logits).abs().max().item() / plain.abs().max().item()
    seq = torch.arange(T, device=dev, dtype=torch.int32).expand(3, B, T).contiguous()
    flat, _ = prefill(model, dict(inputs, mrope_positions=seq))
    e_err = (flat - logits).abs().max().item() / logits.abs().max().item()
    print(f"  (d) plain attention prefill {plain_s:.4f} s; last logits |kernel - plain| / max|logits| = {d_err:.3e} "
          f"(limit 2e-2)")
    print(f"  (e) the sequence index on all three M-RoPE rows: last logits {e_err:.3e} of max |logits| from the "
          f"grid's (must exceed (d)'s {d_err:.3e})")
    if not np.isfinite(d_err) or d_err > 2e-2:
        _fail(f"{cfg.name}: kernel logits off the plain path by {d_err:.3e} of max |logits| (limit 2e-2)")
    if not e_err > d_err:
        _fail(f"{cfg.name}: the M-RoPE rows move the logits by {e_err:.3e}, no more than the kernel's distance")
    del model, logits, plain, flat, prefills
    torch.cuda.empty_cache()
    return counts["flash"]


def frontend_phase(dev) -> dict[str, dict]:
    """hubert-xlarge and qwen2-vl-72b, then flash alone at their shapes."""
    import torch

    t0 = time.perf_counter()
    _audio_model(dev)
    print(f"  {AUDIO_ARCH}: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    _vision_model(dev)
    print(f"  {VISION_ARCH}: {time.perf_counter() - t0:.2f} s")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print("frontend phase (f): flash at the frontends' shapes; kernel vs plain as phase 7")
    out = {case[0]: _flash_case(case, 200 + i, sms, dev) for i, case in enumerate(FRONTEND_FLASH_CASES)}
    torch.cuda.empty_cache()
    return out


TRAIN_ARCH = "llama3.2-3b"
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_STEPS, TRAIN_ACCUM_STEPS = 6, 3  # the first of TRAIN_STEPS is the warm-up
GRAD_LAYERS = 2  # of 28: the gradients through the kernel against the plain version's
FLASH_BWD_KERNELS = "flash_bwd_kernel"  # every launch of csrc/flash_bwd.cu is named flash_bwd_kernel_*
# name, (B, T, H, KV, hd), causal, window, softcap: the training shapes of
# llama3.2-3b, gemma2-9b's widths, hubert-xlarge and qwen2-vl-72b
BWD_CASES = (
    ("llama", (2, 4096, 24, 8, 128), True, None, None),
    ("gemma2", (1, 8192, 16, 8, 256), True, 4096, 50.0),
    ("hubert", (8, 1500, 16, 16, 80), False, None, None),
    ("qwen2-vl", (2, 4096, 64, 8, 128), True, None, None),
)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # kernel vs plain, of max |plain| per output


def _train_split(prof) -> dict[str, list]:
    """A profiled train step's device time by family, [ms, launches]:
    products (cuBLAS), flash's forward and backward (by kernel name), the
    recurrent kernels' forward (WKV, RG-LRU) and backward (by kernel name),
    the MoE kernels' forward (dispatch and combine) and backward
    (``moe_combine_bwd``'s kernels, and the combine launches of the
    dispatch's gradient: inside the profiler range
    ``moe_dispatch.backward``, or its autograd node's op, to whichever
    the profiler ties them),
    cross-entropy (the kernels launched inside ``train.cross_entropy`` and
    by the backward of the autograd nodes made there, matched by sequence
    number), the optimizer (inside ``train.optimizer``) and the rest.  A
    kernel the profiler lists on an event and on one of its children is
    counted once, at the child."""
    events = prof.events()

    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    ce_seq = {e.sequence_nr for e in events
              if e.sequence_nr >= 0 and any(a.name == "train.cross_entropy" for a in chain(e))}
    split = {k: [0.0, 0] for k in ("products", "flash forward", "flash backward", "moe kernels", "moe backward",
                                   "recurrent forward", "recurrent backward", "cross-entropy", "optimizer", "rest")}
    for e in events:
        # an event may list the kernels its children list too: count each at the innermost
        inner = collections.Counter((k.name, k.duration) for c in e.cpu_children for k in c.kernels)
        for kern in e.kernels:
            if inner[(kern.name, kern.duration)] > 0:
                inner[(kern.name, kern.duration)] -= 1
                continue
            if kern.name.startswith(("train.", "Memcpy", "Memset")):  # a range's device span, copies
                continue
            names = [a.name for a in chain(e)]
            if any(k in kern.name for k in REC_BWD_KERNELS):
                fam = "recurrent backward"
            elif any(k in kern.name for k in RECURRENT_KERNELS.values()):
                fam = "recurrent forward"
            elif FLASH_BWD_KERNELS in kern.name:
                fam = "flash backward"
            elif FLASH_KERNELS in kern.name:
                fam = "flash forward"
            elif any(k in kern.name for k in MOE_DEVICE_KERNELS["moe_combine_bwd"]) or (
                    "combine_kernel" in kern.name and any(a == "moe_dispatch.backward" or "MoEDispatchBackward" in a
                                                          for a in names)):
                fam = "moe backward"
            elif "dispatch_kernel" in kern.name or "combine_kernel" in kern.name:
                fam = "moe kernels"
            elif "train.optimizer" in names:
                fam = "optimizer"
            elif "train.cross_entropy" in names or any(
                    a.sequence_nr in ce_seq and a.name.startswith("autograd::engine") for a in chain(e)):
                fam = "cross-entropy"
            elif any(k in kern.name for k in PRODUCT_KERNELS):
                fam = "products"
            else:
                fam = "rest"
            split[fam][0] += kern.duration / 1e3
            split[fam][1] += 1
    return split


def _raw_kernel_ms(prof) -> tuple[float, int]:
    """Device ms and launches of every kernel in a profile's raw events
    (what ``_train_split`` attributes to ops should add up to it)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    # the device's spans of the record_function ranges ("train.*") are not kernels
    ks = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda and not e.name().startswith(("Memcpy", "Memset", "train."))]
    return sum(e.duration_ns() for e in ks) / 1e6, len(ks)


def _train_launcher() -> None:
    """(a) ``repro_torch.launch.train`` with its defaults on the card, 30
    steps, one injected failure at step 12."""
    import math
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as ckpt:
        res, wall = _wall(lambda: launch_train.main(["--steps", "30", "--fail-at", "12", "--ckpt", ckpt]))
    counts = ops.launch_counts()
    losses = [m["loss"] for m in res["log"]]
    print(f"  (a) launcher: {wall:.2f} s, step {res['step']}, {res['restarts']} restart(s), losses "
          + ", ".join(f"{x:.4f}" for x in losses) + f"; flash {counts['flash']}, flash_bwd {counts['flash_bwd']} "
          f"launches")
    if res["restarts"] != 1 or res["step"] != 30 or not all(math.isfinite(x) for x in losses):
        _fail(f"train launcher: {res['restarts']} restarts, step {res['step']}, losses {losses}")
    if not counts["flash"] or not counts["flash_bwd"]:
        _fail(f"train launcher: flash {counts['flash']}, flash_bwd {counts['flash_bwd']} launches")


def _train_full(dev) -> int:
    """(b) llama3.2-3b at full width and depth: TRAIN_STEPS steps, then
    TRAIN_ACCUM_STEPS with accum_steps 2, then one step counted at dispatch
    for phase 17 (c).  Returns flash_bwd's launches in the TRAIN_STEPS
    steps, and that step's roofline with the median step wall."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import DataConfig, SyntheticLMData, make_host_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline
    from repro_torch.models.model import forward, init_params
    from repro_torch.train import OptimizerConfig, TrainConfig, init_train_state, make_train_step
    from repro_torch.train.train_step import cross_entropy

    cfg = get_config(TRAIN_ARCH)
    model = init_params(cfg, seed=0, device=dev)
    state = init_train_state(model, OptimizerConfig())
    n_params = sum(p.numel() for p in state["params"].values())
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    batches = [make_host_batch(data, i, device=dev) for i in range(TRAIN_STEPS + TRAIN_ACCUM_STEPS + 1)]
    logits, _ = forward(model, batches[0]["tokens"])
    ce_forward = cross_entropy(logits, batches[0]["labels"], batches[0]["mask"].float()).item()
    del logits
    # a sample of each parameter, to see it move
    before = {n: p.detach().flatten()[:65536].clone() for n, p in state["params"].items()}
    step = make_train_step(cfg, TrainConfig(), model)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    walls, rows = [], []
    for i in range(TRAIN_STEPS):
        (state, m), wall = _wall(lambda: step(state, batches[i]))
        walls.append(wall)
        rows.append({k: float(v) for k, v in m.items()})
        if not (math.isfinite(rows[-1]["loss"]) and math.isfinite(rows[-1]["grad_norm"])):
            _fail(f"train: step {i + 1} loss {rows[-1]['loss']}, grad_norm {rows[-1]['grad_norm']}")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    med = statistics.median(walls[1:])
    ce_err = abs(rows[0]["ce"] - ce_forward) / abs(ce_forward)
    print(f"  (b) {TRAIN_ARCH}: {cfg.num_layers} layers, {n_params / 1e9:.3f} B parameters, {cfg.dtype} weights, "
          f"f32 moments, remat {cfg.remat}; B {TRAIN_BATCH} x T {TRAIN_SEQ}")
    print(f"      step walls " + ", ".join(f"{w:.4f}" for w in walls) + f" s; median of the last "
          f"{len(walls) - 1} {med:.4f} s, {TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s; peak memory "
          f"{peak / 1e9:.2f} GB of {total / 1e9:.2f} GB")
    print("      losses " + ", ".join(f"{r['loss']:.4f}" for r in rows) + "; grad_norm "
          + ", ".join(f"{r['grad_norm']:.4f}" for r in rows) + f"; first step's ce {rows[0]['ce']:.6f} against "
          f"forward's {ce_forward:.6f} (relative {ce_err:.3e}, limit 1e-2)")
    per_step = {k: counts[k] / TRAIN_STEPS for k in ("flash", "flash_bwd")}
    print(f"      launches a step: flash {per_step['flash']:.0f}, flash_bwd {per_step['flash_bwd']:.0f}")
    if ce_err > 1e-2:
        _fail(f"train: first step's ce {rows[0]['ce']} off forward's {ce_forward} by {ce_err:.3e}")
    layers = cfg.num_layers
    if per_step["flash"] != (2 if cfg.remat else 1) * layers or per_step["flash_bwd"] != layers:
        _fail(f"train: flash {per_step['flash']} and flash_bwd {per_step['flash_bwd']} launches a step")
    still = [n for n, p in state["params"].items() if torch.equal(p.detach().flatten()[:65536], before[n])]
    if still:
        _fail(f"train: {len(still)} parameters did not move ({still[:4]})")
    del before

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (state, m), wall = _wall(lambda: step(state, batches[TRAIN_STEPS]))
    split = _train_split(prof)
    busy, launched = _raw_kernel_ms(prof)
    print(f"      profiled step: wall {wall:.4f} s, device busy {busy:.2f} ms ({100 * busy / (1e3 * wall):.1f}%), "
          f"{launched} kernel launches; by family (of {sum(ms for ms, _ in split.values()):.2f} ms the profiler "
          f"tied to an op): " + ", ".join(f"{k} {ms:.2f} ms x {n}" for k, (ms, n) in split.items()))

    step2 = make_train_step(cfg, TrainConfig(accum_steps=2), model)
    walls2, losses2 = [], []
    for i in range(TRAIN_ACCUM_STEPS):
        (state, m), wall = _wall(lambda: step2(state, batches[TRAIN_STEPS + 1 + i]))
        walls2.append(wall)
        losses2.append((float(m["loss"]), float(m["grad_norm"])))
        if not all(math.isfinite(x) for x in losses2[-1]):
            _fail(f"train: accum_steps 2, step {i + 1}: loss and grad_norm {losses2[-1]}")
    print(f"      accum_steps 2: walls " + ", ".join(f"{w:.4f}" for w in walls2) + " s; (loss, grad_norm) "
          + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in losses2) + f"; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    # phase 17 (c)'s roofline, counted at dispatch on one more step
    out = []
    roof = roofline.derive(lambda: out.append(step(state, batches[TRAIN_STEPS])), cfg,
                           ShapeSpec("phase 16 (b)", "train", TRAIN_SEQ, TRAIN_BATCH))
    state, m = out[0]
    if not math.isfinite(float(m["loss"])):
        _fail(f"train: the roofline's step gave loss {float(m['loss'])}")
    del state, step, step2, model, batches, out
    torch.cuda.empty_cache()
    return counts["flash_bwd"], dict(roofline=roof, step_s=med, n_params=n_params, layers=layers, remat=cfg.remat)


def _train_grads(dev) -> None:
    """(c) the gradients through the kernels against those through the
    plain attention, at full width on GRAD_LAYERS layers, with float32
    weights and with bf16 ones (the float32 model holds the bf16 weights)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, make_host_batch
    from repro_torch.kernels import flash, flash_bwd, ops
    from repro_torch.models.model import Transformer, init_params
    from repro_torch.train import make_loss_fn

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=GRAD_LAYERS)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    batch = make_host_batch(data, 0, device=dev)

    def grads(model, c, plain: bool):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        before = flash.launches + flash_bwd.launches
        ctx = _patched(ops, "flash_attention", lambda orig: flash.flash_attention_plain) if plain else \
            contextlib.nullcontext()
        with ctx:
            loss, _ = make_loss_fn(c)(model, batch)
            g = torch.autograd.grad(loss, list(params.values()))
        if plain and flash.launches + flash_bwd.launches != before:
            _fail("train (c): the plain path launched a kernel")
        return {n: t.float() for n, t in zip(params, g)}

    bf = init_params(cfg, seed=0, device=dev)
    c32 = dataclasses.replace(cfg, dtype="float32")
    f32 = Transformer(c32, seed=None, device=dev)
    f32.load_state_dict({n: t.float() for n, t in bf.state_dict().items()})
    runs = {}
    for name, model, c in (("float32", f32, c32), ("bfloat16", bf, cfg)):
        runs[name] = (grads(model, c, False), grads(model, c, True))
        del model
    del f32, bf
    torch.cuda.empty_cache()

    def dist(a: dict, b: dict) -> dict:
        return {n: (a[n] - b[n]).abs().max().item() / max(b[n].abs().max().item(), 1e-30) for n in b}

    d32 = dist(*runs["float32"])
    d16 = dist(*runs["bfloat16"])
    own = dist(runs["bfloat16"][0], runs["float32"][0])  # the bf16 run's distance from the float32 one
    worst32 = max(d32, key=d32.get)
    print(f"  (c) gradients, kernel vs plain attention, {GRAD_LAYERS} of 28 layers at full width, B {TRAIN_BATCH} x "
          f"T {TRAIN_SEQ}: float32 worst {worst32} {d32[worst32]:.3e} (limit 2e-2)")
    bad = [n for n in d32 if d32[n] > 2e-2]
    limits = {n: max(2e-2, 2 * own[n]) for n in d16}
    worst16 = max(d16, key=lambda n: d16[n] / limits[n])
    print(f"      bf16 worst {worst16} {d16[worst16]:.3e} (limit {limits[worst16]:.3e}: 2e-2 or twice the bf16 "
          f"run's distance from the float32 one, {own[worst16]:.3e})")
    bad += [n for n in d16 if d16[n] > limits[n]]
    if bad:
        _fail(f"train (c): gradients off the plain path's beyond the limit: {bad[:4]}")


def _bwd_device_ms(call, n: int) -> tuple[float, dict]:
    """The profiled device time of one flash_bwd call (six device launches:
    the two tile summaries, D, E, dK/dV, dQ): ``n`` calls under the
    profiler after 64 launches of a fill (the profiler drops the first
    device events of its window), each kernel's mean over the launches
    kept times its launches a call, summed over the kernels."""
    import torch

    pad = torch.empty(1, device="cuda")

    def run():
        for _ in range(64):
            pad.fill_(0.0)
        for _ in range(n):
            call()

    prof = _profile(run)
    parts = collections.defaultdict(lambda: [0.0, 0])
    for name, (ms, cnt) in prof["top_all"]:
        if FLASH_BWD_KERNELS in name:
            part = parts[re.search(FLASH_BWD_KERNELS + r"_\w+?(?=<|$|\()", name).group(0)]
            part[0] += ms
            part[1] += cnt
    a_call = {FLASH_BWD_KERNELS + "_tiles": 2}
    return sum(ms / max(c, 1) * a_call.get(p, 1) for p, (ms, c) in parts.items()), dict(parts)


def _sdpa_bwd_ms(q, k, v, dout, mask, causal: bool, window, reps: int) -> tuple[float, str]:
    """SDPA's backward on the same inputs (``torch.autograd.grad`` of an
    SDPA output, ``enable_gqa``; ``is_causal`` where the mask is causal
    alone, else the boolean mask): the yardstick, used nowhere in the port.
    -> (ms back to back, how the mask was given)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    extra = dict(is_causal=True) if causal and window is None else (
        dict(attn_mask=mask[:, None]) if window is not None else {})
    o = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **extra)
    do = dout.transpose(1, 2)
    ms = _cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), do, retain_graph=True), reps)
    return ms, "is_causal" if "is_causal" in extra else "mask" if extra else "no mask"


def _bwd_case(case, seed: int, dev) -> dict:
    """(d) flash_bwd alone at one shape: against the plain backward in bf16
    and f32, timed in bf16 (CUDA events, profiled device time) beside the
    plain backward, SDPA's backward and the bound."""
    import torch

    from repro_torch.kernels import flash, flash_bwd
    from repro_torch.launch import roofline

    name, (B, T, H, KV, hd), causal, window, cap = case
    kw = dict(causal=causal, window=window, softcap=cap)
    out_row = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, qp, kp = _flash_case_inputs(B, T, T, H, KV, hd, dtype, seed, dev)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
        out, lse = flash.flash_attention_lse_cuda(q, k, v, qp, kp, **kw)
        call = lambda: flash_bwd.flash_bwd_cuda(q, k, v, out, lse, dout, qp, kp, **kw)  # noqa: E731
        got = call()
        want = flash_bwd.flash_attention_bwd_plain(q, k, v, out, lse, dout, qp, kp, **kw)
        torch.cuda.synchronize()
        errs = [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item() for a, b in zip(got, want)]
        tol = BWD_TOL[str(dtype)[6:]]
        line = (f"  {name:8s} {str(dtype)[6:]:8s} B{B} T{T} H{H} KV{KV} hd{hd}: dq, dk, dv off the plain by "
                + ", ".join(f"{e:.3e}" for e in errs) + f" of max |plain| (limit {tol:g})")
        if not all(torch.isfinite(t.float()).all() for t in got) or max(errs) > tol:
            _fail(f"flash_bwd {name} {dtype}: {errs} (limit {tol})")
        del want
        if dtype == torch.bfloat16:
            reps = 5
            ms = _cuda_ms(call, reps)
            dev_ms, parts = _bwd_device_ms(call, 10)
            plain_ms = _cuda_ms(lambda: flash_bwd.flash_attention_bwd_plain(q, k, v, out, lse, dout, qp, kp, **kw), 1)
            mask = _flash_mask(qp, kp, causal, window)
            pairs = mask.sum().item() * H
            nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel() + 4 * (qp.numel() + kp.numel())
            bound_ms, bound_by = roofline.bound_ms(nbytes, 2.5 * 4 * hd * pairs, roofline.HW["peak_flops_bf16"])
            if cap is None:  # SDPA has no softcap
                lib_ms, how = _sdpa_bwd_ms(q, k, v, dout, mask, causal, window, reps)
                lib_note = f"sdpa backward {lib_ms:.4f} ms ({how})"
            else:
                lib_ms, lib_note = None, "sdpa backward: null (no softcap)"
            line += (f"; kernel {ms:.4f} ms, profiled {dev_ms:.4f} ms ("
                     + ", ".join(f"{n} {t / max(c, 1):.4f} ms x {c}" for n, (t, c) in parts.items())
                     + f"), plain {plain_ms:.4f} ms, {lib_note}, bound {bound_ms:.4f} ms ({bound_by}; "
                     f"{2.5 * 4 * hd * pairs:.3e} flop, {nbytes / 1e6:.1f} MB)")
            out_row = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=lib_ms, device_ms=dev_ms)
            del mask
        print(line)
        del q, k, v, out, lse, dout, got
    torch.cuda.empty_cache()
    return out_row


MOE_TRAIN_LAYERS = 1  # of 94: one layer is 3.733 B parameters with the embedding and head (~44.8 GB at 12 bytes
# each: bf16 weights and gradients, f32 moments), two are 6.221 B (~74.7 GB) before the activations
MOE_TRAIN_STEPS = 4  # the first is the warm-up
MOE_GRAD_AUX = 0.01  # the aux loss's cotangent in (f): the train step's MOE_AUX_COEF


def _moe_train(dev) -> int:
    """(e) qwen3-moe-235b-a22b at full width, MOE_TRAIN_LAYERS of 94 layers:
    MOE_TRAIN_STEPS steps and a profiled one.  Returns moe_combine_bwd's
    launches in the MOE_TRAIN_STEPS steps."""
    import dataclasses
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, make_host_batch
    from repro_torch.kernels import ops
    from repro_torch.models.model import forward, init_params
    from repro_torch.train import OptimizerConfig, TrainConfig, init_train_state, make_train_step
    from repro_torch.train.train_step import cross_entropy

    whole = get_config(MOE_ARCH)
    cfg = dataclasses.replace(whole, num_layers=MOE_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    model, init_s = _wall(lambda: init_params(cfg, seed=0, device=dev))
    state = init_train_state(model, OptimizerConfig())
    n_params = sum(p.numel() for p in state["params"].values())
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    batches = [make_host_batch(data, i, device=dev) for i in range(MOE_TRAIN_STEPS + 1)]
    logits, _ = forward(model, batches[0]["tokens"])
    ce_forward = cross_entropy(logits, batches[0]["labels"], batches[0]["mask"].float()).item()
    del logits
    # a sample of each parameter (of every expert, for the expert tensors), to see it move
    def sample(p):
        return p.detach()[:, :2].flatten() if p.dim() == 3 else p.detach().flatten()[:65536]

    before = {n: sample(p).clone() for n, p in state["params"].items()}
    step = make_train_step(cfg, TrainConfig(), model)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    walls, rows = [], []
    for i in range(MOE_TRAIN_STEPS):
        (state, m), wall = _wall(lambda: step(state, batches[i]))
        walls.append(wall)
        rows.append({k: float(v) for k, v in m.items()})
        if not (math.isfinite(rows[-1]["loss"]) and math.isfinite(rows[-1]["grad_norm"])):
            _fail(f"moe train: step {i + 1} loss {rows[-1]['loss']}, grad_norm {rows[-1]['grad_norm']}")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    med = statistics.median(walls[1:])
    ce_err = abs(rows[0]["ce"] - ce_forward) / abs(ce_forward)
    print(f"  (e) {cfg.name} at full width (d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}, {cfg.num_experts} experts top-{cfg.experts_per_token}, expert d_ff {cfg.moe_d_ff}, vocab "
          f"{cfg.vocab_size}, capacity {cfg.capacity_factor}), depth cut to {MOE_TRAIN_LAYERS} of {whole.num_layers} "
          f"layers: {n_params / 1e9:.3f} B parameters, {cfg.dtype} weights, f32 moments, remat {cfg.remat}; B "
          f"{TRAIN_BATCH} x T {TRAIN_SEQ}; init {init_s:.2f} s")
    print(f"      step walls " + ", ".join(f"{w:.4f}" for w in walls) + f" s; median of the last "
          f"{len(walls) - 1} {med:.4f} s, {TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s; peak memory "
          f"{peak / 1e9:.2f} GB of {total / 1e9:.2f} GB")
    print("      losses " + ", ".join(f"{r['loss']:.4f}" for r in rows) + "; aux " + ", ".join(
        f"{r['aux']:.4f}" for r in rows) + "; grad_norm " + ", ".join(f"{r['grad_norm']:.4f}" for r in rows)
          + f"; first step's ce {rows[0]['ce']:.6f} against forward's {ce_forward:.6f} (relative {ce_err:.3e}, "
          f"limit 1e-2)")
    names = ("flash", "flash_bwd", "moe_dispatch", "moe_combine", "moe_combine_bwd")
    per_step = {k: counts[k] / MOE_TRAIN_STEPS for k in names}
    # a layer under remat: two forwards and a backward; the dispatch's
    # backward is a combine launch
    want = {"flash": 2, "flash_bwd": 1, "moe_dispatch": 2, "moe_combine": 3, "moe_combine_bwd": 1}
    if not cfg.remat:
        want.update(flash=1, moe_dispatch=1, moe_combine=2)
    print("      launches a step: " + ", ".join(f"{k} {per_step[k]:.0f}" for k in names) + " (a layer: "
          + ", ".join(f"{k} {v}" for k, v in want.items()) + ")")
    if ce_err > 1e-2:
        _fail(f"moe train: first step's ce {rows[0]['ce']} off forward's {ce_forward} by {ce_err:.3e}")
    if any(per_step[k] != want[k] * MOE_TRAIN_LAYERS for k in names):
        _fail(f"moe train: launches a step {per_step}, want {want} a layer")
    still = [n for n, p in state["params"].items() if torch.equal(sample(p), before[n])]
    no_grad = [n for n, mu in state["opt"]["mu"].items() if not mu.any()]
    moe_leaves = [n for n in state["params"] if ".moe." in n]
    print(f"      every parameter moved and has a nonzero first moment ({len(state['params'])} leaves; the MoE "
          f"layer's {', '.join(n.rsplit('.', 1)[1] for n in moe_leaves)} among them)")
    if still or no_grad or len(moe_leaves) != 4 * MOE_TRAIN_LAYERS:
        _fail(f"moe train: parameters that did not move {still[:4]}, with no gradient {no_grad[:4]}, MoE leaves "
              f"{moe_leaves}")
    del before

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (state, m), wall = _wall(lambda: step(state, batches[MOE_TRAIN_STEPS]))
    split = _train_split(prof)
    busy, launched = _raw_kernel_ms(prof)
    print(f"      profiled step: wall {wall:.4f} s, device busy {busy:.2f} ms ({100 * busy / (1e3 * wall):.1f}%), "
          f"{launched} kernel launches; by family (of {sum(ms for ms, _ in split.values()):.2f} ms the profiler "
          f"tied to an op): " + ", ".join(f"{k} {ms:.2f} ms x {n}" for k, (ms, n) in split.items()))
    del state, step, model, batches, prof
    torch.cuda.empty_cache()
    return counts["moe_combine_bwd"]


def _moe_grads(dev) -> None:
    """(f) the MoE layer's gradients through the kernels against those
    through the plain dispatch and combine, at full width: ``layers.moe``
    on x (TRAIN_BATCH, TRAIN_SEQ, d_model) with a random cotangent on out
    and MOE_GRAD_AUX on aux, in float32 and bf16."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_combine, moe_combine_bwd, moe_dispatch, ops
    from repro_torch.models import layers as L

    cfg = get_config(MOE_ARCH)
    c32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    p16 = L.init_moe(cfg, gen, dev)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen, device=dev)
    cot = torch.randn(x.shape, generator=gen, device=dev)

    def launches():
        return moe_dispatch.launches + moe_combine.launches + moe_combine_bwd.launches

    def grads(p: dict, c, plain: bool) -> dict:
        for t in p.values():
            t.requires_grad_(True)
        xr = x.detach().to(L.cdtype(c)).requires_grad_()
        before = launches()
        ctx = contextlib.ExitStack()
        if plain:
            ctx.enter_context(_patched(ops, "moe_dispatch", lambda orig: moe_dispatch.moe_dispatch_plain))
            ctx.enter_context(_patched(ops, "moe_combine", lambda orig: moe_combine.moe_combine_plain))
        with ctx:
            out, aux = L.moe(p, xr, c)
            g = torch.autograd.grad((out, aux), [xr, *p.values()],
                                    (cot.to(out.dtype), torch.tensor(MOE_GRAD_AUX, device=dev)))
        if (launches() == before) != plain:
            _fail(f"moe train (f): the {'plain' if plain else 'kernel'} path launched {launches() - before} MoE "
                  f"kernels")
        for t in p.values():
            t.requires_grad_(False)
        return {"dx": g[0].float(), **{n: gi.float() for n, gi in zip(p, g[1:])}}

    def dist(a: dict, b: dict) -> dict:
        return {n: (a[n] - b[n]).abs().max().item() / max(b[n].abs().max().item(), 1e-30) for n in b}

    p32 = {n: t.float() for n, t in p16.items()}
    k32 = grads(p32, c32, False)
    d32 = dist(k32, grads(p32, c32, True))
    del p32
    torch.cuda.empty_cache()
    k16 = grads(p16, cfg, False)
    d16 = dist(k16, grads(p16, cfg, True))
    own = dist(k16, k32)  # the bf16 run's distance from the float32 one
    del p16, k16, k32
    torch.cuda.empty_cache()
    worst32 = max(d32, key=d32.get)
    print(f"  (f) gradients of layers.moe, kernels vs plain dispatch and combine, at full width, x ({TRAIN_BATCH}, "
          f"{TRAIN_SEQ}, {cfg.d_model}), capacity {cfg.capacity_factor}: float32 worst {worst32} {d32[worst32]:.3e} "
          f"(limit 2e-2): " + ", ".join(f"{n} {v:.3e}" for n, v in d32.items()))
    limits = {n: max(2e-2, 2 * own[n]) for n in d16}
    worst16 = max(d16, key=lambda n: d16[n] / limits[n])
    print(f"      bf16 worst {worst16} {d16[worst16]:.3e} (limit {limits[worst16]:.3e}: 2e-2 or twice the bf16 run's "
          f"distance from the float32 one, {own[worst16]:.3e}): " + ", ".join(f"{n} {v:.3e}" for n, v in d16.items()))
    bad = [n for n in d32 if d32[n] > 2e-2] + [n for n in d16 if d16[n] > limits[n]]
    if bad:
        _fail(f"moe train (f): gradients off the plain path's beyond the limit: {bad}")


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (x float32)."""
    import torch

    return torch.ldexp(torch.ones_like(x), (torch.frexp(x.abs()).exponent - 8).to(torch.int32))


def _moe_bwd_case(name: str, N: int, k: int, E: int, C: int, D: int, skew: float, dev) -> dict:
    """(g) the combine's backward kernel and the dispatch's (a combine
    launch with unit weights) at one of MOE_CASES' shapes, bf16: d_out_buf
    and dxf bit for bit against the plain versions and from run to run, dw
    within one bf16 ulp, timed beside the bounds, the plain versions and
    the yardsticks."""
    import torch

    from repro_torch.kernels import moe_combine_bwd, moe_dispatch
    from repro_torch.launch import roofline

    g = torch.Generator(device=dev).manual_seed(N + E)
    logits = torch.randn((N, E), generator=g, device=dev) - skew * torch.arange(E, device=dev) / E
    top = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True)
    ids = top.indices[:, :k].to(torch.int32).contiguous()
    w = (top.values[:, :k] / top.values[:, :k].sum(-1, keepdim=True)).contiguous()
    x = torch.randn((N, D), generator=g, device=dev).to(torch.bfloat16)
    _, pos = moe_dispatch.moe_dispatch_cuda(x, ids, E, C)
    del x
    out_buf = torch.randn((E, C, D), generator=g, device=dev).to(torch.bfloat16)
    dbuf = torch.randn((E, C, D), generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn((N, D), generator=g, device=dev).to(torch.bfloat16)
    call = lambda: moe_combine_bwd.moe_combine_bwd_cuda(dout, out_buf, ids, pos, w)  # noqa: E731
    dcall = lambda: moe_dispatch.moe_dispatch_bwd_cuda(dbuf, ids, pos)  # noqa: E731
    (d_buf, dw), again = call(), call()
    dxf, dxf2 = dcall(), dcall()
    want_buf, want_dw = moe_combine_bwd.moe_combine_bwd_plain(dout, out_buf, ids, pos, w)
    want_dxf = moe_dispatch.moe_dispatch_bwd_plain(dbuf, ids, pos)
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int16)  # noqa: E731
    kept = (pos >= 0) & (pos < C)
    n_kept = int(kept.sum())
    if not (torch.equal(bits(d_buf), bits(want_buf)) and torch.equal(bits(again[0]), bits(d_buf))
            and torch.equal(again[1], dw)):
        _fail(f"moe_combine_bwd {name}: d_out_buf off its plain version or dw off its first run")
    dw_err = (dw - want_dw).abs().max().item()
    if (dw[~kept] != 0).any() or not ((dw - want_dw).abs() <= _bf16_ulp(want_dw)).all():
        _fail(f"moe_combine_bwd {name}: dw off its plain version by {dw_err:.3e} (limit one bf16 ulp)")
    if not (torch.equal(bits(dxf), bits(want_dxf)) and torch.equal(bits(dxf2), bits(dxf))):
        _fail(f"moe dispatch backward {name}: dxf off its plain version or its first run")
    del want_buf, want_dxf, again, dxf2
    reps = 20 if N > 64 else 200
    prof_calls = max(reps, 64)  # the profiler drops a window's first ~20 device events
    # yardstick of the slot part: index_copy_ of the weighted rows into a
    # zeroed (E C, D) buffer, the zeroing and the multiply not timed
    tok = torch.arange(N, device=dev)[:, None].expand(N, k)[kept]
    slot = (ids.long() * C + pos.long())[kept]
    weighted = dout[tok] * w[kept].to(torch.bfloat16)[:, None]
    target = torch.zeros((E * C, D), dtype=torch.bfloat16, device=dev)
    lib = lambda: target.index_copy_(0, slot, weighted)  # noqa: E731
    lib()
    if not torch.equal(bits(target.view(E, C, D)), bits(d_buf)):
        _fail(f"moe_combine_bwd {name}: the index_copy_ yardstick computes another d_out_buf")
    lib_ms = min(_cuda_ms(lib, reps) for _ in range(3))
    # bytes: d_out_buf written, dout and the kept rows of out_buf read, ids,
    # pos and w read, dw written; operations: two products and an add an
    # element of a kept row
    nbytes = 2 * (d_buf.numel() + dout.numel() + n_kept * D) + 4 * 4 * ids.numel()
    bound_ms, bound_by = roofline.bound_ms(nbytes, 3 * n_kept * D)
    ms = min(_cuda_ms(call, reps) for _ in range(3))
    parts = {n: _device_ms(call, n, prof_calls) for n in MOE_DEVICE_KERNELS["moe_combine_bwd"]}
    plain_ms = _cuda_ms(lambda: moe_combine_bwd.moe_combine_bwd_plain(dout, out_buf, ids, pos, w), max(reps // 4, 3))
    # the dispatch's backward: the kept rows of dbuf read, dxf written;
    # yardstick: index_add_ of those rows (another order, with atomics)
    dbytes = 2 * (n_kept * D + dxf.numel()) + 4 * 3 * ids.numel()
    dbound_ms, dbound_by = roofline.bound_ms(dbytes, n_kept * D)
    base = torch.zeros((N, D), dtype=torch.bfloat16, device=dev)
    rows = dbuf.view(E * C, D)[slot].contiguous()
    dlib_ms = _cuda_ms(lambda: torch.index_add(base, 0, tok, rows), reps)
    d_ms = min(_cuda_ms(dcall, reps) for _ in range(3))
    d_dev = _device_ms(dcall, "combine_kernel", prof_calls)
    d_plain = _cuda_ms(lambda: moe_dispatch.moe_dispatch_bwd_plain(dbuf, ids, pos), max(reps // 4, 3))
    print(f"  (g) {name:17s} N {N} k {k} E {E} C {C} D {D} bf16: {N * k - n_kept} of {N * k} assignments dropped; "
          f"d_out_buf and dxf bit for bit, dw within one bf16 ulp (max |d| {dw_err:.3e})")
    print(f"      moe_combine_bwd {ms:.4f} ms (device " + ", ".join(f"{n} {t:.4f}" for n, t in parts.items())
          + f"), plain {plain_ms:.4f}, bound {bound_ms:.4f} ({bound_by}, {nbytes / 1e6:.1f} MB), {bound_ms / ms:.0%} "
          f"of it; index_copy_ of the weighted rows {lib_ms:.4f} (the slot part alone; no single call also gives dw)")
    print(f"      dispatch backward (combine_kernel, w = 1) {d_ms:.4f} ms (device {d_dev:.4f}), plain {d_plain:.4f}, "
          f"bound {dbound_ms:.4f} ({dbound_by}, {dbytes / 1e6:.1f} MB), {dbound_ms / d_ms:.0%} of it; index_add_ "
          f"of the kept rows {dlib_ms:.4f}")
    del d_buf, dw, dxf, out_buf, dbuf, dout, target, weighted, rows, base
    torch.cuda.empty_cache()
    return dict(max_abs_err=dw_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                device_ms=sum(parts.values()))


REC_TRAIN_STEPS = 4  # the first is the warm-up
REC_GRAD_LAYERS = {"rwkv6-1.6b": 2, "recurrentgemma-2b": 3}  # (j): two rwkv layers; two rglru and a local one
# device kernels of the recurrences' backward, by name: the WKV's three
# launches (the reverse state pass, the chunks, du) and the RG-LRU's one
REC_BWD_KERNELS = {"wkv_bwd_state_kernel": "rwkv_wkv_bwd", "wkv_bwd_chunk_kernel": "rwkv_wkv_bwd",
                   "wkv_bwd_du_kernel": "rwkv_wkv_bwd", "rglru_bwd_kernel": "rglru_scan_bwd"}
REC_BWD_NO_LIBRARY = "no single PyTorch call runs a reverse linear recurrence"


def _rec_kernel(arch: str) -> str:
    return "rwkv_wkv" if arch.startswith("rwkv") else "rglru_scan"


def _rec_train(arch: str, dev) -> dict[str, int]:
    """(h) rwkv6-1.6b and (i) recurrentgemma-2b at full width and depth on
    B TRAIN_BATCH x T TRAIN_SEQ: REC_TRAIN_STEPS steps and a profiled one.
    Returns the launches of the REC_TRAIN_STEPS steps, by kernel."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, make_host_batch
    from repro_torch.kernels import ops
    from repro_torch.models.model import forward, init_params
    from repro_torch.train import OptimizerConfig, TrainConfig, init_train_state, make_train_step
    from repro_torch.train.train_step import cross_entropy

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    model, init_s = _wall(lambda: init_params(cfg, seed=0, device=dev))
    state = init_train_state(model, OptimizerConfig())
    n_params = sum(p.numel() for p in state["params"].values())
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    batches = [make_host_batch(data, i, device=dev) for i in range(REC_TRAIN_STEPS + 1)]
    with torch.no_grad():
        logits, _ = forward(model, batches[0]["tokens"])
        ce_forward = cross_entropy(logits, batches[0]["labels"], batches[0]["mask"].float()).item()
    del logits
    before = {n: p.detach().flatten()[:65536].clone() for n, p in state["params"].items()}
    step = make_train_step(cfg, TrainConfig(), model)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    walls, rows = [], []
    for i in range(REC_TRAIN_STEPS):
        (state, m), wall = _wall(lambda: step(state, batches[i]))
        walls.append(wall)
        rows.append({k: float(v) for k, v in m.items()})
        if not (math.isfinite(rows[-1]["loss"]) and math.isfinite(rows[-1]["grad_norm"])):
            _fail(f"{arch} train: step {i + 1} loss {rows[-1]['loss']}, grad_norm {rows[-1]['grad_norm']}")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    med = statistics.median(walls[1:])
    ce_err = abs(rows[0]["ce"] - ce_forward) / abs(ce_forward)
    tag = "(h)" if arch.startswith("rwkv") else "(i)"
    print(f"  {tag} {arch} uncut ({cfg.num_layers} layers: {', '.join(sorted(set(cfg.layer_kinds)))}; d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}): {n_params / 1e9:.3f} B parameters, {cfg.dtype} weights, f32 "
          f"moments, remat {cfg.remat}; B {TRAIN_BATCH} x T {TRAIN_SEQ}; init {init_s:.2f} s")
    print(f"      step walls " + ", ".join(f"{w:.4f}" for w in walls) + f" s; median of the last "
          f"{len(walls) - 1} {med:.4f} s, {TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s; peak memory "
          f"{peak / 1e9:.2f} GB of {total / 1e9:.2f} GB")
    print("      losses " + ", ".join(f"{r['loss']:.4f}" for r in rows) + "; grad_norm "
          + ", ".join(f"{r['grad_norm']:.4f}" for r in rows) + f"; first step's ce {rows[0]['ce']:.6f} against "
          f"forward's {ce_forward:.6f} (relative {ce_err:.3e}, limit 1e-2)")
    kernel = _rec_kernel(arch)
    n_rec = sum(k in ("rwkv", "rglru") for k in cfg.layer_kinds)
    n_att = cfg.num_layers - n_rec
    f = 2 if cfg.remat else 1  # under remat a layer's forward runs twice
    want = {kernel: f * n_rec, kernel + "_bwd": n_rec, "flash": f * n_att, "flash_bwd": n_att}
    per_step = {k: counts[k] / REC_TRAIN_STEPS for k in want}
    print("      launches a step: " + ", ".join(f"{k} {per_step[k]:.0f}" for k in want) + " (want "
          + ", ".join(f"{k} {v}" for k, v in want.items()) + ")")
    if ce_err > 1e-2:
        _fail(f"{arch} train: first step's ce {rows[0]['ce']} off forward's {ce_forward} by {ce_err:.3e}")
    if any(per_step[k] != v for k, v in want.items()):
        _fail(f"{arch} train: launches a step {per_step}, want {want}")
    still = [n for n, p in state["params"].items() if torch.equal(p.detach().flatten()[:65536], before[n])]
    no_grad = [n for n, mu in state["opt"]["mu"].items() if not mu.any()]
    print(f"      every parameter moved and has a nonzero first moment ({len(state['params'])} leaves)")
    if still or no_grad:
        _fail(f"{arch} train: parameters that did not move {still[:4]}, with no gradient {no_grad[:4]}")
    del before

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (state, m), wall = _wall(lambda: step(state, batches[REC_TRAIN_STEPS]))
    split = _train_split(prof)
    busy, launched = _raw_kernel_ms(prof)
    print(f"      profiled step: wall {wall:.4f} s, device busy {busy:.2f} ms ({100 * busy / (1e3 * wall):.1f}%), "
          f"{launched} kernel launches; by family (of {sum(ms for ms, _ in split.values()):.2f} ms the profiler "
          f"tied to an op): " + ", ".join(f"{k} {ms:.2f} ms x {n}" for k, (ms, n) in split.items()))
    del state, step, model, batches, prof
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want}


def _rec_grads(arch: str, dev) -> None:
    """(j) a recurrent model's gradients through the recurrent kernels
    against those through the plain recurrences, at full width on
    REC_GRAD_LAYERS layers, float32 and bf16 weights (the float32 model
    holds the bf16 weights), as (c)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, make_host_batch
    from repro_torch.kernels import ops, rglru_scan, rglru_scan_bwd, rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.models.model import Transformer, init_params
    from repro_torch.train import make_loss_fn

    cfg = dataclasses.replace(get_config(arch), num_layers=REC_GRAD_LAYERS[arch])
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    batch = make_host_batch(data, 0, device=dev)
    kernel = _rec_kernel(arch)
    plain_fn = rwkv_wkv.wkv_plain if kernel == "rwkv_wkv" else rglru_scan.rglru_scan_plain

    def launches():
        return rwkv_wkv.launches + rwkv_wkv_bwd.launches + rglru_scan.launches + rglru_scan_bwd.launches

    def grads(model, c, plain: bool):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        before = launches()
        ctx = _patched(ops, kernel, lambda orig: plain_fn) if plain else contextlib.nullcontext()
        with ctx:
            loss, _ = make_loss_fn(c)(model, batch)
            g = torch.autograd.grad(loss, list(params.values()))
        if (launches() == before) != plain:
            _fail(f"{arch} train (j): the {'plain' if plain else 'kernel'} path launched {launches() - before} "
                  f"recurrent kernels")
        return {n: t.float() for n, t in zip(params, g)}

    bf = init_params(cfg, seed=0, device=dev)
    c32 = dataclasses.replace(cfg, dtype="float32")
    f32 = Transformer(c32, seed=None, device=dev)
    f32.load_state_dict({n: t.float() for n, t in bf.state_dict().items()})
    runs = {}
    for name, model, c in (("float32", f32, c32), ("bfloat16", bf, cfg)):
        runs[name] = (grads(model, c, False), grads(model, c, True))
        del model
    del f32, bf
    torch.cuda.empty_cache()

    def dist(a: dict, b: dict) -> dict:
        return {n: (a[n] - b[n]).abs().max().item() / max(b[n].abs().max().item(), 1e-30) for n in b}

    d32 = dist(*runs["float32"])
    d16 = dist(*runs["bfloat16"])
    own = dist(runs["bfloat16"][0], runs["float32"][0])  # the bf16 run's distance from the float32 one
    worst32 = max(d32, key=d32.get)
    print(f"  (j) {arch} gradients, {kernel} kernels vs the plain recurrence, {cfg.num_layers} layers "
          f"({', '.join(cfg.layer_kinds)}) at full width, B {TRAIN_BATCH} x T {TRAIN_SEQ}: float32 worst {worst32} "
          f"{d32[worst32]:.3e} (limit 2e-2)")
    limits = {n: max(2e-2, 2 * own[n]) for n in d16}
    worst16 = max(d16, key=lambda n: d16[n] / limits[n])
    print(f"      bf16 worst {worst16} {d16[worst16]:.3e} (limit {limits[worst16]:.3e}: 2e-2 or twice the bf16 "
          f"run's distance from the float32 one, {own[worst16]:.3e})")
    bad = [n for n in d32 if d32[n] > 2e-2] + [n for n in d16 if d16[n] > limits[n]]
    if bad:
        _fail(f"{arch} train (j): gradients off the plain path's beyond the limit: {bad[:4]}")
    del runs
    torch.cuda.empty_cache()


def _rec_bwd_case(kernel: str, name: str, B: int, T: int, W: int, stateful: bool, dev) -> dict:
    """(k) a recurrence's backward kernel alone at one of phase 14's shapes
    (W heads for the WKV, channels for the RG-LRU), against its plain
    version on the same inputs (RG-LRU bit for bit, WKV within WKV_TOL of
    each output's max |plain|) and against its own second run (bit for
    bit), timed back to back and profiled beside the bound and the plain
    version's time.  The WKV's is fed by the forward's checkpoints, as the
    train step feeds it (the forward that writes them is not timed)."""
    import torch

    from repro_torch.kernels import rglru_scan, rglru_scan_bwd, rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.launch import roofline

    g = torch.Generator(device=dev).manual_seed(B * T + W + 1)
    ops_per_s = roofline.HW["peak_flops_f32"]
    if kernel == "rwkv_wkv_bwd":
        args, _, _ = _wkv_args(B, T, W, stateful, dev)
        grads = (torch.randn(args[0].shape, generator=g, device=dev), torch.randn(args[5].shape, generator=g,
                                                                                   device=dev))
        ckpt = torch.empty(rwkv_wkv.checkpoint_shape(B, T, W), device=dev)
        rwkv_wkv.rwkv_wkv_cuda(*args, ckpt)
        call = lambda: rwkv_wkv_bwd.rwkv_wkv_bwd_cuda(*args, *grads, ckpt=ckpt)  # noqa: E731
        plain = lambda: rwkv_wkv_bwd.wkv_bwd_plain(*args, *grads)  # noqa: E731
        r, S0, u = args[0], args[5], args[4]
        # bytes: r, k, v, logw, do read and dr, dk, dv, dlogw written once;
        # S0, dS read and dS0 written; u read and du written (the kernel
        # also reads the checkpoints, which the function does not need).
        # operations: the token form's 14 a state element and token (the
        # state and state-gradient updates 3 each, four dot products 2
        # each), at TF32's rate (the products run on the tensor cores)
        nbytes = 4 * (9 * r.numel() + 3 * S0.numel() + 2 * u.numel())
        nops = 14 * r.numel() * 64
        ops_per_s = roofline.HW["peak_flops_tf32"]
        exact = False
    else:
        (a, b, h0), _, _ = _rglru_args(B, T, W, stateful, dev)
        h_seq, _ = rglru_scan.rglru_scan_cuda(a, b, h0)
        dh_seq, dh_last = torch.randn(a.shape, generator=g, device=dev), torch.randn(h0.shape, generator=g, device=dev)
        call = lambda: rglru_scan_bwd.rglru_scan_bwd_cuda(a, h0, h_seq, dh_seq, dh_last)  # noqa: E731
        plain = lambda: rglru_scan_bwd.rglru_scan_bwd_plain(a, h0, h_seq, dh_seq, dh_last)  # noqa: E731
        # bytes: a, h_seq, dh_seq read and da, db written once; h0, dh_last
        # read and dh0 written.  operations: an add and two multiplies a step
        nbytes = 4 * (5 * a.numel() + 3 * h0.numel())
        nops = 3 * a.numel()
        exact = True
    got, again = call(), call()
    want = plain()
    torch.cuda.synchronize()
    errs = [(x - w).abs().max().item() / max(w.abs().max().item(), 1e-30) for x, w in zip(got, want)]
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        _fail(f"{kernel} {name}: two runs differ")
    if exact and not all(torch.equal(x, w) for x, w in zip(got, want)):
        _fail(f"{kernel} {name}: differs from its plain version (of max |plain| {errs})")
    if not exact and (max(errs) > WKV_TOL or not all(torch.isfinite(x).all() for x in got)):
        _fail(f"{kernel} {name}: off its plain version by {errs} of max |plain| (limit {WKV_TOL})")
    del got, again, want
    reps = 20 if nbytes > 1e8 else 200
    ms = _cuda_ms(call, reps)
    parts = {n: _device_ms(call, n, 64) for n, k in REC_BWD_KERNELS.items() if k == kernel}
    plain_ms = _cuda_ms(plain, 1)
    bound_ms, bound_by = roofline.bound_ms(nbytes, nops, ops_per_s)
    device_ms = sum(parts.values())
    print(f"  (k) {kernel} {name:26s} {'bit for bit' if exact else 'max |d| ' + ', '.join(f'{e:.2e}' for e in errs) + ' of max |plain|'}, "
          f"the same from run to run; {ms:.4f} ms (device {device_ms:.4f}: "
          + ", ".join(f"{n} {t:.4f}" for n, t in parts.items()) + f"), plain {plain_ms:.3f}, bound {bound_ms:.5f} "
          f"({bound_by}: {nbytes / 1e6:.1f} MB, {nops / 1e9:.3f} GFLOP at {ops_per_s / 1e12:.0f} TFLOP/s), "
          f"{100 * bound_ms / device_ms:.1f}% of it" + (f" (the token form's operations at the f32 rate: "
                                                        f"{nops / roofline.HW['peak_flops_f32'] * 1e3:.4f} ms)"
                                                        if ops_per_s != roofline.HW["peak_flops_f32"] else "")
          + f"; library null: {REC_BWD_NO_LIBRARY}")
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs), ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def train_phase(dev) -> tuple[dict[str, dict], dict[str, int], dict]:
    """Phase 16: training.  Returns flash_bwd's numbers at llama's shape,
    moe_combine_bwd's at qwen3-moe's and the recurrent backwards' at their
    models' own, their launches in (b)'s, (e)'s, (h)'s and (i)'s steps, and
    (b)'s roofline for phase 17."""
    print(f"train phase (a): the launcher, reduced {TRAIN_ARCH}")
    t0 = time.perf_counter()
    _train_launcher()
    print(f"train phase (b): {TRAIN_ARCH} at full width and depth ({time.perf_counter() - t0:.2f} s so far)")
    launches, roof = _train_full(dev)
    print(f"train phase (c): gradients through the kernels against the plain path ({time.perf_counter() - t0:.2f} s)")
    _train_grads(dev)
    print(f"train phase (d): flash_bwd alone; kernel vs plain bf16 <= 2e-2, f32 <= 1e-4 of max |plain| "
          f"({time.perf_counter() - t0:.2f} s)")
    cases = {case[0]: _bwd_case(case, 300 + i, dev) for i, case in enumerate(BWD_CASES)}
    print(f"train phase (e): {MOE_ARCH} at full width ({time.perf_counter() - t0:.2f} s)")
    moe_launches = _moe_train(dev)
    print(f"train phase (f): the MoE layer's gradients through the kernels against the plain path "
          f"({time.perf_counter() - t0:.2f} s)")
    _moe_grads(dev)
    print(f"train phase (g): the MoE backward kernels alone ({time.perf_counter() - t0:.2f} s)")
    moe_cases = [_moe_bwd_case(*case, dev) for case in MOE_CASES]
    rec_launches = {}
    for arch in RECURRENT_ARCHS:
        print(f"train phase ({'h' if arch.startswith('rwkv') else 'i'}): {arch} at full width and depth "
              f"({time.perf_counter() - t0:.2f} s)")
        rec_launches.update(_rec_train(arch, dev))
    print(f"train phase (j): the recurrent models' gradients through the kernels against the plain path "
          f"({time.perf_counter() - t0:.2f} s)")
    for arch in RECURRENT_ARCHS:
        _rec_grads(arch, dev)
    print(f"train phase (k): the recurrent backward kernels alone; WKV <= {WKV_TOL:g} of max |plain|, RG-LRU bit "
          f"for bit ({time.perf_counter() - t0:.2f} s)")
    wkv = [_rec_bwd_case("rwkv_wkv_bwd", *case, dev) for case in WKV_CASES]
    lru = [_rec_bwd_case("rglru_scan_bwd", *case, dev) for case in RGLRU_CASES]
    return ({"flash_bwd": cases["llama"], "moe_combine_bwd": moe_cases[0], "rwkv_wkv_bwd": wkv[0],
             "rglru_scan_bwd": lru[0]},
            {"flash_bwd": launches, "moe_combine_bwd": moe_launches,
             **{k: rec_launches[k] for k in ("rwkv_wkv_bwd", "rglru_scan_bwd")}},
            roof)


# Phase 17 (b): one policy of the standard configuration (phase 5), cut to
# AUDIT_TASKS_PER_TYPE tasks a type: every call of the two placement
# programs runs under the dtype audit's dispatch mode.  "default" waits
# most (24 epoch programs and 84 folds on the CPU at this cut)
AUDIT_POLICY = "default"
AUDIT_TASKS_PER_TYPE = 20  # of CLUSTER_KW's 120


def _audit_grid(wfs, cfg, cold: dict[str, int]) -> None:
    """(a) the warm grid under ``no_rebuilds``, twice."""
    from repro_torch.analysis import trace_audit
    from repro_torch.sim.batch_engine import simulate_grid

    runs = []
    for i in range(2):
        try:
            with trace_audit.no_rebuilds(f"warm grid run {i + 1}", launches=cold,
                                         launching_ops=runs[0].launching_ops if runs else None) as lc:
                simulate_grid(wfs, cfg=cfg)
        except trace_audit.RebuildError as e:
            _fail(f"audit (a): {e}")
        runs.append(lc)
    a = runs[0]
    print(f"  (a) warm grid x 2 under no_rebuilds: launches {a.snapshot()['launches']} (phase 3's cold run: "
          f"{ {k: n for k, n in cold.items() if n} }); launching aten ops {a.launching_ops} and "
          f"{runs[1].launching_ops}; read-backs {a.readbacks}; uploads {len(a.uploads)} "
          f"({a.upload_bytes / 1e6:.3f} MB, largest {max((u.nbytes for u in a.uploads), default=0) / 1e6:.3f} MB); "
          f"operand and result bytes of the launching ops {a.launching_bytes / 1e9:.3f} GB; no library built or "
          "loaded")
    print("      most dispatched launching ops: " + ", ".join(f"{op} {n}" for op, n in a.aten.most_common(8)))


def _audit_cluster_dtypes(wfs) -> None:
    """(b) every floating result of the epoch program and the sweep's fold
    float64."""
    import torch

    from repro_torch.analysis import trace_audit
    from repro_torch.sim import cluster, device_timeline

    calls: collections.Counter = collections.Counter()
    problems: list[str] = []

    def audited(name):
        def make(orig):
            def run(*a, **kw):
                out = []
                found = trace_audit.check_dtypes(lambda: out.append(orig(*a, **kw)), forbid_dtypes=(torch.float32,))
                problems.extend(f"{name}: {p}" for p in found)
                calls[name] += 1
                return out[0]

            return run

        return make

    kw = {**CLUSTER_KW, "max_tasks_per_type": AUDIT_TASKS_PER_TYPE}
    kernel = {"windows": "rangemax", "sweep": "compaction"}
    program = {"windows": "epoch program", "sweep": "sweep fold"}
    with _patched(device_timeline, "_schedule_program", audited("epoch program")), \
            _patched(device_timeline, "_fold_and_compact", audited("sweep fold")):
        for placement in ("windows", "sweep"):
            with trace_audit.LaunchCounter() as lc:
                res = cluster.run_cluster_batched(wfs, (AUDIT_POLICY,), placement=placement, **kw)
            rows = len(res[AUDIT_POLICY].records)
            print(f"  (b) {AUDIT_POLICY} on {placement}, {AUDIT_TASKS_PER_TYPE} tasks a type ({rows} records): "
                  f"{calls[program[placement]]} {program[placement]} calls audited, {kernel[placement]} "
                  f"launches {lc.launches[kernel[placement]]}, read-backs {lc.readbacks}, uploads "
                  f"{len(lc.uploads)}")
            if not calls[program[placement]] or not lc.launches[kernel[placement]]:
                _fail(f"audit (b): the {placement} run did not reach its {program[placement]} and {kernel[placement]}")
    if problems:
        _fail(f"audit (b): float32 results in the float64 placement programs: {problems[:8]}")
    print("      every floating result of both programs float64")


def _audit_roofline(roof: dict, smi: str) -> None:
    """(c) phase 16 (b)'s step against its roofline, at its median wall."""
    from repro_torch.launch import roofline

    rf = roof["roofline"]
    s = rf.summary()
    want = {"flash": (2 if roof["remat"] else 1) * roof["layers"], "flash_bwd": roof["layers"]}
    print(f"  (c) {TRAIN_ARCH} train step, B {TRAIN_BATCH} x T {TRAIN_SEQ}: model flops 6ND "
          f"{rf.model_flops_global:.4e} (N {roof['n_params'] / 1e9:.3f} B); counted at dispatch "
          f"{rf.flops_per_device:.4e} flop, {rf.bytes_per_device:.4e} bytes (useful_flops_ratio "
          f"{s['useful_flops_ratio']:.4f}; compute {1e3 * s['compute_s']:.2f} ms, memory {1e3 * s['memory_s']:.2f} ms, "
          f"the larger {1e3 * s['bound_s']:.2f} ms, {s['dominant']}; mfu_bound {s['mfu_bound']:.4f})")
    print(f"      not counted (launched through ctypes, out of dispatch's sight): "
          + ", ".join(f"{k} {n} launches" for k, n in rf.not_counted.items()))
    print(f"      MFU at the median step wall {roof['step_s']:.4f} s: {100 * rf.mfu(roof['step_s']):.2f}% of "
          f"{roofline.HW['peak_flops_bf16'] / 1e12:.0f} TFLOP/s bf16 (data sheet); card {smi}")
    if rf.not_counted != want or rf.flops_per_device <= 0 or rf.bytes_per_device <= 0:
        _fail(f"audit (c): not counted {rf.not_counted} (want {want}), flops {rf.flops_per_device}, bytes "
              f"{rf.bytes_per_device}")


def audit_phase(wfs, cfg, grid_counts: dict[str, int], roof: dict, smi: str) -> None:
    """Phase 17: the tooling on the card.  Fails the run on any failed audit."""
    t0 = time.perf_counter()
    print("audit phase (a): the warm grid's launches, read-backs and uploads")
    _audit_grid(wfs, cfg, grid_counts)
    print(f"audit phase (b): the placement programs' dtypes ({time.perf_counter() - t0:.2f} s)")
    _audit_cluster_dtypes(wfs)
    print(f"audit phase (c): the llama step's roofline ({time.perf_counter() - t0:.2f} s)")
    _audit_roofline(roof, smi)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic corpus")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.ksegments import KSegmentsConfig
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.sim.simulator import SimConfig
    from repro_torch.sim.traces import generate_suite, pack_traces

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip()
    dev = resolve_device()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({', '.join(built) or 'cached'})")
    for name in build.SOURCES:
        for kernel, regs, spills in _ptxas_summary(build.build_log(name)):
            print(f"  {name}: {kernel}: {regs} registers, {spills}")

    # The paper's corpus and the benchmark's grid configuration: k = 4, bounded
    # insample offsets over 64 executions, fractions 0.25/0.5/0.75.
    t0 = time.perf_counter()
    wfs = generate_suite(seed=args.seed, scale=CORPUS_SCALE)
    cfg = SimConfig(min_executions=20, ksegments=KSegmentsConfig(k=4, error_mode="insample", insample_window=64))
    tasks = [t for wf in wfs for t in wf.eligible_tasks(cfg.min_executions)]
    batches = pack_traces(tasks)
    print(f"corpus: {len(tasks)} eligible tasks in {len(batches)} buckets, "
          f"{sum(b.y.nbytes for b in batches) / 1e6:.1f} MB padded series ({time.perf_counter() - t0:.2f} s)")

    largest = max(batches, key=lambda b: b.y.nbytes)
    per_kernel = kernels_phase(largest, cfg, dev)
    per_kernel["scan"] = scan_phase(largest, cfg, dev)
    counts, _, _ = grid_phase(wfs, cfg)
    grid_counts = dict(counts)
    sweep_phase(wfs, cfg)
    cluster_info = cluster_phase(wfs)
    per_kernel.update(sched_kernels_phase(cluster_info, dev))
    counts.update({k: cluster_info["counts"][k] for k in ("rangemax", "compaction")})
    per_kernel["flash"] = flash_phase(dev)["llama3.2-3b prefill"]
    counts["flash"] = serve_phase(dev)["counts"]["flash"]
    t0 = time.perf_counter()
    per_kernel["fitstats"], counts["fitstats"] = fitstats_phase(wfs, cfg, dev)
    api_phase(dev)
    online_phase(wfs, args.seed)
    print(f"phases 9-11: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    adm_kernels, adm_counts = admission_phase(dev, args.seed)
    per_kernel.update(adm_kernels)
    counts.update(adm_counts)
    print(f"admission phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    moe_kernels, moe_counts = moe_phase(dev)
    per_kernel.update(moe_kernels)
    counts.update(moe_counts)
    print(f"moe phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rec_kernels, rec_counts = recurrent_phase(dev)
    per_kernel.update(rec_kernels)
    counts.update(rec_counts)
    print(f"recurrent phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    frontend_phase(dev)
    print(f"frontend phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    train_kernels, train_counts, roof = train_phase(dev)
    per_kernel.update(train_kernels)
    counts.update(train_counts)
    print(f"train phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    audit_phase(wfs, cfg, grid_counts, roof, smi)
    print(f"audit phase: {time.perf_counter() - t0:.2f} s")

    sources = {
        "segmax": ("src/repro_torch/kernels/csrc/segmax.cu", "src/repro/kernels/segmax.py:55"),
        "wastage": ("src/repro_torch/kernels/csrc/wastage.cu", "src/repro/kernels/wastage.py:77"),
        "rangemax": ("src/repro_torch/kernels/csrc/rangemax.cu", "src/repro/kernels/rangemax.py:85"),
        "compaction": ("src/repro_torch/kernels/csrc/compaction.cu", "src/repro/kernels/compaction.py:92"),
        "fitstats": ("src/repro_torch/kernels/csrc/fitstats.cu", "src/repro/kernels/fitstats.py:53"),
        "flash": ("src/repro_torch/kernels/csrc/flash.cu", "src/repro/kernels/flash.py:77"),
        # no TPU kernel: the reference engine's lax.scan carry and its jnp.cumsum calls
        "scan": ("src/repro_torch/kernels/csrc/scan.cu",
                 "src/repro/sim/jax_sim.py:621 (lax.scan carry); jnp.cumsum at src/repro/sim/jax_sim.py:241, 277, "
                 "278, 295, 319, 347"),
        # no TPU kernel: the reference's batched admission scan
        "admission": ("src/repro_torch/kernels/csrc/admission.cu",
                      "src/repro/sim/device_timeline.py:374 (admission_program's lax.scan)"),
        # no TPU kernel: the reference's carried admission program, vmapped over shards
        "admission_epoch": ("src/repro_torch/kernels/csrc/admission_epoch.cu",
                            "src/repro/sim/device_timeline.py:1292 (admission_epoch), :1080 (_admission_shard)"),
        # no TPU kernel: the reference's MoE dispatch and combine, left to XLA
        "moe_dispatch": ("src/repro_torch/kernels/csrc/moe_dispatch.cu",
                         "src/repro/models/layers.py:544-556 (moe's argsort, bincount, cumsum and scatter into buf; "
                         "_moe_dispatch_compute :431-447)"),
        "moe_combine": ("src/repro_torch/kernels/csrc/moe_combine.cu",
                        "src/repro/models/layers.py:565-566 (moe's weighted gather and scatter-add into out; "
                        "_moe_dispatch_compute :450-451)"),
        # no TPU kernel: the reference's recurrent mixers' recurrences, left to XLA
        "rwkv_wkv": ("src/repro_torch/kernels/csrc/rwkv_wkv.cu",
                     "src/repro/models/recurrent.py:105-126 (rwkv_time_mix's lax.scan of chunk_step), :87-93 "
                     "(its step at T = 1)"),
        "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                       "src/repro/models/recurrent.py:214-224 (rglru_block's lax.associative_scan), :210-212 "
                       "(its step at T = 1)"),
        # no TPU kernel: the reference's MoE combine's gradient, left to JAX's autodiff and XLA
        "moe_combine_bwd": ("src/repro_torch/kernels/csrc/moe_combine_bwd.cu",
                            "src/repro/models/layers.py:565-566 (autodiff of moe's weighted gather and scatter-add; "
                            "_moe_dispatch_compute :450-451)"),
        # no TPU kernel: the reference's recurrences' gradients, left to JAX's autodiff and XLA
        "rwkv_wkv_bwd": ("src/repro_torch/kernels/csrc/rwkv_wkv_bwd.cu",
                         "src/repro/models/recurrent.py:105-126 (autodiff of rwkv_time_mix's lax.scan of "
                         "chunk_step), :87-93 (its step at T = 1)"),
        "rglru_scan_bwd": ("src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
                           "src/repro/models/recurrent.py:214-224 (autodiff of rglru_block's "
                           "lax.associative_scan)"),
        # no TPU kernel: the reference trains through its attention's XLA path
        "flash_bwd": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                      "src/repro/models/layers.py:213-253 (autodiff of flash_attention's KV-chunk lax.scan; no TPU "
                      "kernel: USE_FLASH_KERNEL is False, src/repro/models/flags.py:38)"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": counts[name],
         "library_ms": None, **{k: v for k, v in per_kernel[name].items() if k in keys}}
        for name, (src, rep) in sources.items()
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
