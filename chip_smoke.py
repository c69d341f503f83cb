#!/usr/bin/env python3
"""Drive the PyTorch port's allocation and serve paths on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:

1. the card: its name, and name and power limit from nvidia-smi;
2. build the CUDA kernels from src/repro_torch/csrc (seconds printed; one
   nvcc per source, all started together);
2s. the port's seeded draws are the same on the card and on the CPU: one
   seed's run_scan at the paper's setting and one run_batch seed with
   gauss_markov / gilbert / mmpp, warm coop on "reference" on both devices
   (held to each other by compare_episodes); XLSTMLM.init and
   CausalLM.init at reduced width bitwise equal on both; serve's prompts
   for one seed equal on both; the seconds of each model's full-width
   init on the card (its weights drawn on the CPU); and the host's ms per
   market-scale period of draws, alone, on one intra-op thread and with
   the copy to the card, and per operator under the CPU profiler;
2a. the mLSTM kernel (B7 mlstm_chunk) against its plain version on the
   card, in bfloat16 and float32, with the JAX kernel test's inputs (k /
   sqrt(Dh), i ~ N(0, 0.5), f ~ N(2, 0.5)) and tolerances (rtol = atol =
   5e-4 float32, 5e-2 bfloat16) on y and the final C, n and m: the serve
   shape (B = 4, H = 4, S = 2048, Dh = 1024) from the zero state, a ragged
   shape (2, 2, 1100, 128), and a carry (the serve shape's first 1000
   positions, then the rest from the state they end in, against the whole
   sequence).  In bfloat16 a call is two kernels, each also held to its
   own plain version (mlstm_parts: the chunk states and final state of
   mlstm_states_kernel, the y of mlstm_outputs_kernel) and timed alone.
   Times as in phase 4, no library call (library_ms null), and the bound:
   4 Dh (Dh + 64) operations per (position, head) over the peak for the
   type (64: the first B7 kernel's chunk, kept whatever chunk the kernels
   use, so bounds stay comparable), against
   the inputs, y and the state;
2b. the xLSTM serve path (slice 4's main path), through
   repro_torch.launch.serve.main: full-width xlstm-1.3b in bfloat16 from a
   seeded init, batch 4, prompt 2048, 32 greedy tokens, after a warm-up
   serve of a 256-token prompt.  Counted from 0 just before it: exactly 42
   mlstm_chunk launches (one per mLSTM layer; decode steps run the plain
   recurrent step, as the JAX model does) and no other kernel; finite
   logits and a cache length of 2079; peak memory, one profiled decode
   step, and one mLSTM and one sLSTM block timed over the prompt.  Then
   one no-cache forward of the same prompts, itself a main path: again
   exactly 42 launches, and its last logits within 5e-2 of the prefill's;
2c. the xLSTM kernel path against the plain path end to end: full-width
   xlstm-1.3b in float32 cut to 8 layers (one super-block, 7 mLSTM + 1
   sLSTM), batch 2, prompt 1024, 8 greedy tokens in lockstep, as phase 6;
3. every kernel against its plain PyTorch version on the card, at the
   market shape (N = 8192 services, K = 32 clients, first 10% inactive,
   sample_services on a generator seeded 5, warm seed = cold price x 1.03),
   a ragged shape (N = 8191, K = 45) and the paper's ten services (N = 10,
   K = 45: where B1's and B2's launches come from, so their kernels-line
   times); B1 and B2 bitwise the same over 21 more calls and at every
   speculation depth; mbdf_demand on the prices of
   uniform_truthful_bids (M = 5 at the market shape, M = 3 at the ragged
   one) for alpha_fair 0, 0.5 and 1, its demands >= 0, non-increasing
   along the price grid and 0 on inactive rows.  Per kernel: the largest
   deviation per output (tolerances below), the kernel's device time
   (CUDA events around one call queued behind a device sleep, so the
   host's launch path is hidden; median of 21) with the profiler's mean
   as a cross-check (kernel_profiler_ms: an untimed call inside the
   window and FILLERS tiny kernels at both ends, records from
   prof.events(); the fillers each end lost are tallied over every
   window in the profiler_windows line), the wrapper's and the plain
   version's time per call
   (CUDA events, median of 21 calls, host launch path included), and the
   bound (the larger of float32 operations over 67 TFLOP/s and bytes
   over 3.35 TB/s, counting about 5 operations per valid (row, client,
   trip), 6 for mbdf_demand's per price); market_clear's outputs bitwise
   the same over 21 more calls (lam above all: every block folds the
   same partials in the same order).  Then B1-B4 in parts, through
   their own launch arguments (b12_parts: B1 and B2 with 0 and their full
   trips at 10 x 45, 8192 x 45 and both market shapes, on the market and
   its full copy, the wrapper's time beside the kernel's, and each
   speculation depth over N from 10 to 8192 at K = 45 with the depth the
   launch picks; b3_parts: no trips, 6 trips without
   bisection, plus the 6 x 24 Newton steps, the full call, at both
   shapes and on a copy of each market with every row active and full,
   giving the cost of a trip, of a bisection step and of the zero lanes;
   b4_parts: M = 5 at alpha_fair 0.5 and 0, with 48 and with 0 trips,
   on the market and its full copy), each with the count of divide
   checks and slow-path calls in the kernels' SASS (cuobjdump); and the
   edge matrix (edge_matrix: tests/test_tile_edges.py's shapes mirrored,
   N in {1, 31, 8191} x K in {1, 7, 31, 32, 33, 45, 64, 65, 128, 1024},
   an all-inactive market and one with a single active row, B1 with a
   b = 0 row, B2 on a price per row, B4 at M in
   {1, 5, 8, 9}), each kernel against its plain version within the
   tolerances above, B1 and B2 alike at every depth, B4's demands >= 0,
   non-increasing and 0 on
   inactive rows; before it, the lane group the kernels pick for every
   K up to 1024 (L in 8, 16, 32 and K <= L R <= 32 L);
4. the attention kernels (B5 flash_attention, B6 decode_attention)
   against their plain versions on the card, in bfloat16 and float32:
   B5 at gemma3-1b's prefill shape (B = 4, Hq = 4, Hkv = 1, S = 2048,
   D = 256) with the local window of 1024 and global, and at a ragged
   shape (B = 2, Hq = 8, Hkv = 2, S = 1100, D = 128); B6 at the decode
   shape (cache 2080, valid_len 2079) global, on the local window's slice
   of the cache (the last 1024 positions) and at a ragged valid_len
   (1337); and B5 in bfloat16 once more at the local shape on transposed
   views of (B, S, H, D) tensors, the layout the model hands in.
   Tolerances are the JAX kernel tests' (rtol = atol = 2e-5 in float32,
   2e-2 in bfloat16).  Per case: kernel, profiler (the kernel's own name:
   flash_attention_wgmma_kernel for bf16 B5, flash_attention_kernel for
   float32, decode_attention_kernel, one launch a call), wrapper and plain
   times as in phase 3, the time of one
   F.scaled_dot_product_attention(enable_gqa=True) call on the same inputs
   (library_ms; the port never calls it), the bound: the larger of the
   operations (4 D per live (query, key) pair, counted from the mask) over
   989 TFLOP/s for bfloat16 or 67 TFLOP/s for float32, and the bytes of
   q, the live k and v, and the output over 3.35 TB/s; and the achieved
   rate of what bounds it (TFLOP/s or GB/s) with bound_ms / ms;
5. the serve path (slice 3's main path), through
   repro_torch.launch.serve.main: full-width gemma3-1b in bfloat16 from a
   seeded init, batch 4, prompt 2048, 32 greedy tokens, after one short
   warm-up serve.  Counted from 0 just before it: exactly 26
   flash_attention and 26 x 31 = 806 decode_attention launches and no
   other kernel (no mlstm_chunk); finite logits and a cache filled to 2079; then one more
   decode step under the profiler (its device activities and busy time)
   and one more prefill under it (device busy time and B5's share);
6. the kernel path against the plain path end to end: full-width
   gemma3-1b in float32 cut to 2 layers (one local, one global), one
   parameter set on the card and on the CPU, batch 2, prompt 2048, 8
   greedy tokens stepped in lockstep: last-position logits within
   MODEL_TOL at every step and the same tokens (a flip at a near-tie is
   reported with the CPU's top-2 gap and fails unless that gap is within
   2 atol);
7. the allocation paths, each driven with the launch counts set to 0 just
   before it and read just after:
   a. slice 1: run_scan episodes of coop (warm and cold), es, pp and ec
      at the paper's setting (SimConfig defaults), each with a kernel
      backend and with "reference" on one sampler stream, then a
      market-scale warm coop episode on "megakernel": 8192 services all
      arriving at period 0 with the paper's 1 MHz per service (B = 8192
      MHz) and 100 rounds to finish, 10 periods;
   b. selfish: the auction policy on "pallas" and "megakernel" at the
      paper's setting, then the same market-scale episode on "pallas";
   c. run_batch over 3 seeds with gauss_markov channels, gilbert churn
      and mmpp arrivals, warm coop on "megakernel" against "reference";
   d. cotrain (slice 9): co-trained episodes (fl.cotrain, FedAvg of
      bigram tables paced by each period's allocation) at BENCH_cotrain's
      setting (benchmarks/paper_figs_cotrain.py:81-87: 5 services, K =
      32, B = 2 MHz, T = 4 s, 48 rounds, 64 periods; vocab 32, seq 8,
      batch 4, eval batch 32, rounds_cap 14, lr 0.5): warm coop on
      "megakernel" and "pallas", es, pp and selfish on "pallas", and at
      the paper's setting warm coop on "megakernel" and selfish on
      "pallas", each against the same episode on "reference" on the card
      (durations by compare_episodes; where the two trained the same
      rounds with the same participants, loss and train_loss within
      rtol 1e-4 / atol 1e-5, acc within one eval token, the final tables
      within 1e-4) and against the plain run_scan of its config in the
      same call (durations bitwise; periods/s, the ratio the cost of
      training a period); per episode the host ms of a round's data
      draws and the launches a period by kernel.  Then (cotrain_engines)
      one seed's warm coop co-trained episode on the card against the
      CPU, run_cotrain_batch over seeds 0-2 against run_cotrain_fleet at
      chunk 2 and run_fleet over seeds 0-4 at chunk 2 against run_batch
      (bitwise), the legacy run against run_scan (durations) and resumed
      from its period-2 JSON snapshot against itself uninterrupted;
   e. allocd (slice 10): the live daemon (launch.allocd over
      fl.control_plane, solves in an executor thread).  At the paper's
      network (16 slots, K = 45, 400 rounds, 40 ticks of Poisson(0.5)
      admissions): warm coop on "megakernel" and "pallas", selfish and es
      on "pallas", each against the same daemon on "reference" on the card
      (compare_episodes on the served streams, completions equal) and
      replayed through run_scan on the card bitwise (the ticks before the
      first slot reuse: 19 admissions into 16 slots), warm coop
      "megakernel" on the CPU too; at market capacity (MARKET_N services
      admitted at tick 0, market_setting's network, 100 rounds, 10 ticks)
      warm coop "megakernel" and selfish "pallas", replayed bitwise; each
      with ticks/s, run_scan's periods/s on the same trace and the ms a
      tick draws inline.  Then the poison drill (full planes poisoned at
      NaN, +Inf and -Inf in the channel state and the warm seed, each
      poisoned tick run on "reference" on the same inputs: the same
      rescues and b, f within tolerance), the zero-load drill (clients
      with alpha = 0, a whole row and each row's slowest, on "pallas" and
      "megakernel" against "reference"), bench_fault's storms
      (benchmarks/bench_fault.py:44-46: 16, 64, 256 slots, 40 periods,
      on "megakernel" and "pallas", each twice with equal digests, every
      invariant ok, every poisoned tick probed as above, the trajectory
      against the "reference" storm's), bench_robust's Byzantine
      co-training (benchmarks/bench_robust.py:68-85: sign_flip and nan
      at 20% against fedavg, trimmed_mean, median and krum; durations
      those of the clean episode, training bitwise alike on "megakernel"
      and "reference", card against CPU loss within 1e-5, finite tables
      from the robust aggregators under nan) and the CLI's --check;
   per episode: rounds and durations equal (see compare_episodes for the
   one allowed exception), per-period b and f within tolerance (an
   auction's f beyond it must be the reference's f*(b) at its own b, see
   check_surplus_split), no solver rescue, the kernels each backend
   launched (none for "reference"), and at market scale draw_wait_ms:
   the median ms the period loop waited on a period's draws, periods 1-9
   (the engine's own sampler draws the next periods on host threads
   there); then, outside the counted paths, draw_samplers: the market
   coop episode and the paper's under three samplers in turns
   (prefetching, inline, and drawn before the episode and already on the
   card), their periods/s and equal durations;
8. the auction entry on the card: run_auction at 8192 services, M = 5,
   B = 8192 MHz (b sums to B, charges cover the fairness cost, the same
   call on the CPU agrees), and charges(method="prefix") against "rerun"
   at N = 256 (the rerun builds an (N, N*M) book);
9. the kernels line: per kernel, its launches on the paths of phases 2b,
   5 and 7 (summed; 7d and 7e must each launch each of B1-B4), its
   deviation, times and bound (B1 and B2 at 10 x
   45, B3 and B4 at the market shape); B7's row lists its
   two bf16 kernels under "parts" (a launch count is a call of both).

Tolerances are rtol and atol as in the CPU tests, but atol is never more
than 1e-3 of the mean |value| of the output checked: at the market shape b
is about 1e-3 and a client's split about 5e-5, where a fixed atol would
check nothing.  Charges get atol 1e-4 + 1e-6 of the book's welfare
sum_j F_j(b_j): the prefix charge is a difference of two such sums.  An
auction allocation gives each period's surplus to the services bidding at
the clearing price, which absorb every other service's float deviation:
see check_surplus_split.

The last line is {"ok": true, "device": {...}}; every JSON line is also
written to build/chip_smoke.jsonl.  The script needs a CUDA card and the
repository's src/ beside it, and fails without either.
TF32 is off for every float32 product (set in main and again in phase 6).
Slice 4's phases (2a-2c) run right after the build and slice 3's (4-6)
before the allocation paths, so a fault in either shows within the first
minutes; a "seconds" line before the kernels line gives each phase's wall
time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
B_TOTAL = 10.0
PEAK_F32_OPS = 67e12      # H100 SXM float32 outside the tensor cores, op/s
PEAK_BF16_OPS = 989e12    # H100 SXM bf16 tensor cores, dense, op/s
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s
OPS_PER_CLIENT_TRIP = 5
OPS_PER_CLIENT_TRIP_PRICE = 6   # mbdf_demand
TOL = {"t_star": (1e-4, 0.0), "split": (1e-3, 1e-4), "b": (1e-3, 1e-4),
       "slope": (1e-3, 1e-4), "f": (1e-3, 1e-5), "lam": (1e-4, 0.0),
       "split_sum": (1e-5, 0.0), "demand": (1e-4, 1e-5),
       "price": (1e-4, 0.0)}
ATOL_OF_MEAN = 1e-3      # atol <= this fraction of the output's mean |value|
SLEEP_CYCLES = 2_000_000  # device sleep queued ahead of a timed kernel call
KERNELS = {
    "bisect_alloc": "src/repro/kernels/bisect_alloc.py:29",
    "dual_demand": "src/repro/kernels/dual_demand.py:94",
    "market_clear": "src/repro/kernels/market_clear.py:86",
    "mbdf_demand": "src/repro/kernels/market_clear.py:204",
    "flash_attention": "src/repro/kernels/flash_attention.py:33",
    "decode_attention": "src/repro/kernels/decode_attention.py:28",
    "mlstm_chunk": "src/repro/kernels/mlstm_chunk.py:27",
}
ATTENTION_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # rtol = atol
MLSTM_TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}      # rtol = atol
LOG = ROOT / "build" / "chip_smoke.jsonl"   # every emitted line
MODEL_TOL = 1e-4          # rtol = atol of the float32 end-to-end parity
# Sizes (the phases above).
# (N, K, M of mbdf_demand): the market shape, a ragged one, and the paper's
# ten services, where B1's and B2's launches come from (the kernels line).
KERNEL_SHAPES = ((8192, 32, 5), (8191, 45, 3), (10, 45, 5))
MAIN_PATH_SHAPE = (10, 45)   # B1 and B2 in the kernels line
DEPTHS = (1, 2)              # B1 and B2's speculation depths, the same bits
MARKET_N = 8192
PAPER = {}                   # SimConfig overrides of the paper's setting
AUCTION_N, RERUN_N = 8192, 256
BATCH_SEEDS = (0, 1, 2)
# (B, Hq, Hkv, S, D, window) of B5; (B, Hq, Hkv, cache, D, valid_len, lo) of
# B6, whose kernel sees the cache's positions [lo, valid_len).
FLASH_CASES = {"local": (4, 4, 1, 2048, 256, 1024),
               "global": (4, 4, 1, 2048, 256, 0),
               "ragged": (2, 8, 2, 1100, 128, 0)}
DECODE_CASES = {"global": (4, 4, 1, 2080, 256, 2079, 0),
                "local": (4, 4, 1, 2080, 256, 2079, 1055),
                "ragged": (4, 4, 1, 2080, 256, 1337, 0)}
# B5 on transposed views of (B, S, H, D) tensors, the layout the model
# hands in (bf16 only; the float32 parity phase covers it end to end).
SERVE_LAYOUT_CASES = {"local_serve_layout": (4, 4, 1, 2048, 256, 1024)}
MAIN_CASE = "local"       # the kernels line: 22 of gemma3-1b's 26 layers
SERVE = dict(arch="gemma3-1b", batch=4, prompt_len=2048, gen=32)
PARITY = dict(n_layers=2, batch=2, prompt_len=2048, gen=8)
# (B, H, S, Dh, split) of B7: the carry case runs [0, split) and then
# [split, S) from the state the first half ends in.
MLSTM_CASES = {"serve": (4, 4, 2048, 1024, 0),
               "ragged": (2, 2, 1100, 128, 0),
               "carry": (4, 4, 2048, 1024, 1000)}
XLSTM_SERVE = dict(arch="xlstm-1.3b", batch=4, prompt_len=2048, gen=32,
                   warmup_prompt_len=256)
# B7's bf16 kernels; the bound keeps the first B7 kernel's count of
# 4 Dh (Dh + 64) operations per (position, head), whatever chunk the
# kernels use.
MLSTM_KERNELS = ("mlstm_states_kernel", "mlstm_outputs_kernel")
BOUND_CHUNK = 64
XLSTM_PARITY = dict(n_layers=8, batch=2, prompt_len=1024, gen=8)
SEEDED_SEED = 0           # the seed the card and the CPU both run


def emit(obj) -> None:
    """Print one JSON line, and append it to LOG: the whole record of a
    run, where a terminal may keep only its end."""
    line = json.dumps(obj)
    print(line, flush=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


def event_ms(fn, reps: int = 21, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn``: the device timeline
    from before the call is issued to after its last kernel, so it includes
    any wait of the device on the host's launch path."""
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
    return float(np.median(times))


def device_ms(fn, reps: int = 21, warmup: int = 3) -> float:
    """Median CUDA-event time of the device work of one call of ``fn``.
    A device sleep is queued before the start event, so the host has issued
    the call before the device reaches it: the launch path is hidden."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


FILLERS = 1024  # tiny kernels at each end of a kernel_profiler_ms window
# Per window, its names and the filler records the profiler did not keep
# at its start and at its end: the edge loss the fillers take (see
# _profiled_records).
FILLERS_LOST: list[tuple[str, int, int]] = []


def _profiled_records(fn, reps: int, names) -> dict:
    """One profiler window: FILLERS tiny kernels, an untimed call of ``fn``
    and a synchronise, then ``reps`` calls and FILLERS more tiny kernels.
    After earlier windows in a process, a window can lose the device
    records of its first launches; the fillers take that loss, and how
    many of them each end lost goes to FILLERS_LOST.  Returns, per name,
    the device events whose names contain it."""
    from torch.autograd import DeviceType

    pad = torch.zeros(16, device=DEVICE)
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(FILLERS):
            pad.add_(1.0)
        fn()
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        for _ in range(FILLERS):
            pad.add_(1.0)
        torch.cuda.synchronize()
    device = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    filler = device[-1].name if device else None
    ends = []
    for seq in (device, device[::-1]):
        kept = 0
        while kept < min(FILLERS, len(seq)) and seq[kept].name == filler:
            kept += 1
        ends.append(FILLERS - kept)
    FILLERS_LOST.append((" ".join(names), *ends))
    return {name: [e for e in device if name in e.name] for name in names}


def kernel_profiler_ms(fn, kernel: str, reps: int = 21,
                       names: tuple[str, ...] = (),
                       min_records: int | None = None) -> float:
    """Mean device time per call of the CUDA kernels whose names contain
    ``names`` (default ``{kernel}_kernel``), from the profiler's CUDA
    activity records of ``reps`` + 1 calls (``_profiled_records``: the
    first call is untimed by the events, but its record counts).  At
    least ``min_records`` (default reps // 2) records of each must
    survive."""
    names = names or (f"{kernel}_kernel",)
    least = reps // 2 if min_records is None else min_records
    fn()
    torch.cuda.synchronize()
    records = _profiled_records(fn, reps, names)
    kept = {name: len(recs) for name, recs in records.items()}
    if any(not least <= n <= reps + 1 for n in kept.values()):
        raise AssertionError(f"profiler kept {kept} records of {names}, "
                             f"expected {least}..{reps + 1} each")
    return sum(sum(e.time_range.elapsed_us() for e in recs) / len(recs) / 1e3
               for recs in records.values())


def _np64(x) -> np.ndarray:
    return np.asarray(x.detach().double().cpu().numpy()
                      if torch.is_tensor(x) else x, np.float64)


def check_close(name: str, got, want, key: str, atol=None) -> dict:
    """Raise unless |got - want| <= atol + rtol |want| everywhere, with
    atol no more than ATOL_OF_MEAN of mean |want| (unless given); returns
    the largest absolute deviation and the tolerance applied."""
    rtol, default_atol = TOL[key]
    got, want = _np64(got), _np64(want)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}/{key}: shape {got.shape} vs "
                             f"{want.shape} or non-finite values")
    if atol is None:
        atol = default_atol
        if want.size:
            atol = min(atol, ATOL_OF_MEAN * float(np.mean(np.abs(want))))
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    if bad.any():
        raise AssertionError(f"{name}/{key}: {int(bad.sum())} entries beyond "
                             f"rtol {rtol} atol {atol}; max dev {err.max()}")
    return {"max_dev": float(err.max()) if err.size else 0.0,
            "rtol": rtol, "atol": atol}


def check_surplus_split(name: str, got_b, want_b, got_f, want_f,
                        f_at=None) -> dict:
    """Hold an auction allocation (Eq. 26) to the reference one.  Each
    period's surplus B - sum_j d_j(zeta+) goes to the few services bidding
    exactly at the clearing price, so their b absorbs the summed deviation
    of every other service's demand, which grows with N, and the float32
    rounding of the period's aggregate demand, a fraction of an ulp of B
    in each run.  So: b and f within TOL everywhere except at such
    entries, and in every period the summed |deviation| of the entries
    beyond TOL is at most that of the entries within it plus atol plus 2
    ulps of the period's total; their f is then held by the rounds check
    of compare_episodes.

    A b within its TOL can still move f = f*(b) (Eq. 7) past f's TOL where
    b is small.  Such an entry must then be f*(its own b): ``f_at(mask)``
    gives the reference's plain f*(got_b) at the masked entries, and got_f
    is held to it within TOL["f"] (listed under f/own_b).  Without
    ``f_at`` every f is held to want_f."""
    got_b, want_b = _np64(got_b), _np64(want_b)
    got_f, want_f = _np64(got_f), _np64(want_f)
    n = got_b.shape[-1]
    rtol, atol = TOL["b"]
    atol = min(atol, ATOL_OF_MEAN * float(np.mean(np.abs(want_b))))
    err = np.abs(got_b - want_b)
    out = err > atol + rtol * np.abs(want_b)
    err2, out2 = err.reshape(-1, n), out.reshape(-1, n)
    totals = np.abs(want_b).reshape(-1, n).sum(axis=1).astype(np.float32)
    for row in np.flatnonzero(out2.any(axis=1)):
        carried = float(err2[row][out2[row]].sum())
        absorbed = (float(err2[row][~out2[row]].sum()) + atol
                    + 2.0 * float(np.spacing(totals[row])))
        if carried > absorbed:
            raise AssertionError(
                f"{name}/b: period {row} deviates by {carried} at "
                f"{int(out2[row].sum())} services, more than the "
                f"{absorbed} the others' demands account for")
    keep = ~out
    checks = {"b": check_close(name, got_b[keep], want_b[keep], "b")}
    f_rtol, f_atol = TOL["f"]
    f_atol = min(f_atol, ATOL_OF_MEAN * float(np.mean(np.abs(want_f[keep]))))
    f_err = np.abs(got_f - want_f)
    own_b = keep & (f_err > f_atol + f_rtol * np.abs(want_f))
    if own_b.any() and f_at is None:
        raise AssertionError(f"{name}/f: {int(own_b.sum())} entries beyond "
                             f"rtol {f_rtol} atol {f_atol}; max dev "
                             f"{f_err[keep].max()}")
    checks["f"] = check_close(name, got_f[keep & ~own_b],
                              want_f[keep & ~own_b], "f", atol=f_atol)
    if own_b.any():
        plain = _np64(f_at(own_b))
        checks["f"]["own_b"] = {
            **check_close(f"{name}/f*(own b)", got_f[own_b], plain, "f",
                          atol=f_atol),
            "entries": [{"index": [int(i) for i in idx],
                         "b": float(got_b[idx]),
                         "b_reference": float(want_b[idx]),
                         "f": float(got_f[idx]),
                         "f_reference": float(want_f[idx]),
                         "f_plain_at_b": float(p)}
                        for idx, p in zip(zip(*np.nonzero(own_b)), plain)]}
    checks["b"]["surplus_entries"] = int(out.sum())
    checks["b"]["surplus_max_dev"] = float(err[out].max()) if out.any() else 0.0
    return checks


def bound(ops: float, nbytes: float,
          peak_ops: float = PEAK_F32_OPS) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def market(n: int, k: int):
    from repro_torch.core import network
    from repro_torch.core.types import mask_inactive

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    svc, _ = network.sample_services(gen, n, k_max=k)
    n_off = max(1, round(n * 0.1))
    return mask_inactive(svc, torch.arange(n, device=DEVICE) >= n_off)


def time_row(name: str, kern, plain, work_ops: float, nbytes: float) -> dict:
    bound_ms, bound_by = bound(work_ops, nbytes)
    return {"ms": device_ms(kern), "profiler_ms": kernel_profiler_ms(kern, name),
            "wrapper_ms": event_ms(kern), "plain_ms": event_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by}


def kernel_phase(n: int, k: int, m: int) -> dict:
    """Phase 3 at one shape: every kernel against its plain version."""
    from repro_torch.core import auction, disba
    from repro_torch.kernels import ops
    from repro_torch.kernels.bisect_alloc import bisect_alloc_plain
    from repro_torch.kernels.dual_demand import dual_demand_plain
    from repro_torch.kernels.market_clear import (market_clear_plain,
                                                  mbdf_demand_plain)

    svc = market(n, k)
    a, t, mk = svc.alpha, svc.t_comp, svc.mask
    cold = disba.solve_lambda_newton(svc, B_TOTAL)
    lam_prev = cold.lam * 1.03
    b = cold.b.contiguous()
    valid = float(mk.sum())             # (row, client) pairs with work
    nk = float(n * k)                   # also the mask's bytes
    trips_mc = 6 * disba.WARM_INNER_ITERS + 2 * 48
    cases = {
        "bisect_alloc": (
            lambda: ops.intra_allocate(a, t, mk, b),
            lambda: bisect_alloc_plain(a, t, mk, b),
            ("t_star", "split"),
            valid * 48, 4 * (2 * nk + n) + nk + 4 * (n + nk)),
        "dual_demand": (
            lambda: ops.dual_demand(a, t, mk, lam_prev,
                                    iters=disba.WARM_INNER_ITERS),
            lambda: dual_demand_plain(a, t, mk, lam_prev,
                                      disba.WARM_INNER_ITERS),
            ("b", "slope"),
            valid * disba.WARM_INNER_ITERS, 4 * (2 * nk + 1) + nk + 4 * 2 * n),
        "market_clear": (
            lambda: ops.market_clear(a, t, mk, B_TOTAL, lam_prev),
            lambda: market_clear_plain(a, t, mk, B_TOTAL, lam_prev),
            ("b", "f", "lam"),
            valid * trips_mc, 4 * (2 * nk + 2) + nk + 4 * (2 * n + 1)),
    }
    out = {}
    for name, (kern, plain, keys, work, nbytes) in cases.items():
        launches_before = ops.LAUNCHES[name]
        got, want = kern(), plain()
        torch.cuda.synchronize()
        tag = f"{name}@{n}x{k}"
        checks = {key: check_close(tag, g, w, key)
                  for g, w, key in zip(got, want, keys)}
        if name == "bisect_alloc":
            # the water-filling split of every row sums to its budget
            checks["split_sum"] = check_close(tag, got[1].sum(dim=1), b,
                                              "split_sum")
        if name in ("bisect_alloc", "dual_demand"):
            checks["bitwise_repeats"] = bitwise_repeats(tag, kern, got)
            checks["depths_bitwise"] = depths_bitwise(tag, name, a, t, mk, (
                b if name == "bisect_alloc" else lam_prev), iters=(
                48 if name == "bisect_alloc" else disba.WARM_INNER_ITERS))
        if name == "market_clear":
            checks["b_total"] = check_close(tag, got[0].sum(),
                                            torch.tensor(B_TOTAL), "b")
            checks["bitwise_repeats"] = bitwise_repeats(tag, kern, got)
        row = {"name": name, "n": n, "k": k,
               "max_abs_err": max(checks[key]["max_dev"] for key in keys),
               "checks": checks,
               **time_row(name, kern, plain, OPS_PER_CLIENT_TRIP * work,
                          nbytes),
               "launches": ops.LAUNCHES[name] - launches_before}
        emit({"phase": "kernel_vs_plain", **row})
        out[name] = row

    # mbdf_demand on the bid grids of uniform_truthful_bids.
    name = "mbdf_demand"
    launches_before = ops.LAUNCHES[name]
    inactive = a.sum(dim=1) == 0
    checks = {}
    for alpha_fair in (0.0, 0.5, 1.0):
        prices = auction.uniform_truthful_bids(svc, m, alpha_fair).prices
        got = ops.mbdf_demand(a, t, mk, prices, alpha_fair)
        want = mbdf_demand_plain(a, t, mk, prices, alpha_fair)
        torch.cuda.synchronize()
        tag = f"{name}@{n}x{k}x{m}/a={alpha_fair}"
        checks[f"demand@{alpha_fair}"] = check_close(tag, got, want, "demand")
        if not bool((got >= 0).all()):
            raise AssertionError(f"{tag}: negative demand")
        if not bool((got[:, 1:] <= got[:, :-1]).all()):
            raise AssertionError(f"{tag}: demand rises along the price grid")
        if not bool((got[inactive] == 0).all()):
            raise AssertionError(f"{tag}: inactive rows demand bandwidth")
    prices = auction.uniform_truthful_bids(svc, m, 0.5).prices
    work = valid * 48 * m
    nbytes = 4 * (2 * nk + n * m) + nk + 4 * n * m
    row = {"name": name, "n": n, "k": k, "m": m, "alpha_fair": 0.5,
           "max_abs_err": max(c["max_dev"] for c in checks.values()),
           "checks": checks,
           **time_row(name, lambda: ops.mbdf_demand(a, t, mk, prices, 0.5),
                      lambda: mbdf_demand_plain(a, t, mk, prices, 0.5),
                      OPS_PER_CLIENT_TRIP_PRICE * work, nbytes),
           "launches": ops.LAUNCHES[name] - launches_before}
    emit({"phase": "kernel_vs_plain", **row})
    out[name] = row
    return out


def bitwise_repeats(tag: str, kern, first, reps: int = 21) -> int:
    """Raise unless ``reps`` more calls of ``kern`` give the bits of
    ``first`` in every output (lam above all: every block of the launch
    must fold the same partials in the same order)."""
    for i in range(reps):
        again = kern()
        for j, (x, y) in enumerate(zip(first, again)):
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                raise AssertionError(f"{tag}: call {i + 1} changed output "
                                     f"{j}'s bits")
    return reps


def depths_bitwise(tag: str, name: str, a, t, mk, x, iters: int) -> list:
    """Raise unless B1 (``x`` the budgets) or B2 (``x`` the prices) gives
    the bits of depth 1 at every depth of DEPTHS compiled for its K (depth
    2 where K <= 64); returns those depths."""
    from repro_torch.kernels.bisect_alloc import (bisect_alloc_cuda,
                                                  bisect_alloc_plan)
    from repro_torch.kernels.dual_demand import dual_demand_cuda

    fn = bisect_alloc_cuda if name == "bisect_alloc" else dual_demand_cuda
    depths = []
    for j in DEPTHS:
        with contextlib.suppress(ValueError):   # no kernel at this depth
            depths.append(bisect_alloc_plan(*a.shape, j, device=DEVICE))
    first = fn(a, t, mk, x, iters, depth=depths[0])
    for j in depths[1:]:
        bitwise_repeats(f"{tag}/depth {j}",
                        lambda: fn(a, t, mk, x, iters, depth=j), first, reps=1)
    return depths


# The shape matrix of tests/test_tile_edges.py, mirrored for B3 and B4 on
# the card: every lane-group width and the ragged edges of N and K.
EDGE_K = (1, 7, 31, 32, 33, 45, 64, 65, 128, 1024)
EDGE_N = (1, 31, 8191)
EDGE_M = (1, 5, 8, 9)


def edge_market(n: int, k: int, active: str = "ragged"):
    """An (n, k) market from numpy's generator: alpha ~ U(0.01, 0.3),
    t^C ~ U(0.01, 0.06), each row's clients a ragged prefix, one row in
    ten inactive (rows 5, 15, ...); ``active`` "none" (every row inactive) or "one" (row
    n // 2 alone active)."""
    from repro_torch.core.types import ServiceSet

    rng = np.random.default_rng([n, k])
    alpha = rng.uniform(0.01, 0.3, (n, k)).astype(np.float32)
    t_comp = rng.uniform(0.01, 0.06, (n, k)).astype(np.float32)
    mask = np.arange(k)[None, :] < rng.integers(1, k + 1, (n, 1))
    if active == "ragged":
        mask[5::10] = False
    else:
        mask[:] = False
        if active == "one":
            mask[n // 2, : max(1, k // 2)] = True
    alpha = torch.from_numpy(np.where(mask, alpha, 0.0)).to(DEVICE)
    t_comp = torch.from_numpy(np.where(mask, t_comp, 0.0)).to(DEVICE)
    return ServiceSet(alpha=alpha.contiguous(), t_comp=t_comp.contiguous(),
                      mask=torch.from_numpy(mask).to(DEVICE))


def edge_matrix_phase() -> dict:
    """B1-B4 against their plain versions on the card over the edge
    matrix, after the lane group chosen for every K up to ops.MAX_K is checked
    (L in 8, 16, 32, K <= L R <= 32 L): N x K, an all-inactive and a one-active-row market, and B4 at
    every M of EDGE_M, on price grids 1.15 m p_max / (M + 1): the top
    prices pass p_max (the opt-out), and none lies within 2% of it, where
    the demand jumps to 0 and an ulp of q decides the side.  B3 is seeded
    warm at 1.03 x the plain version's cold price (12 trips of 48 steps); tolerances as in phase 3.
    B1 on budgets U(0.2, 4), 0 on inactive rows and on one active row
    (t* = 1/TINY there, its split 0), its split summing to each budget;
    B2 at 24 trips on a price per row, p_max times U(0.1, 0.9) and 1.15 on
    every seventh row (the opt-out); both bitwise alike at every depth."""
    from repro_torch.core import intra
    from repro_torch.kernels import ops
    from repro_torch.kernels.bisect_alloc import bisect_alloc_plain
    from repro_torch.kernels.dual_demand import dual_demand_plain
    from repro_torch.kernels.market_clear import (grid_limits,
                                                  market_clear_plain,
                                                  mbdf_demand_plain)

    dev = torch.device(DEVICE).index or 0
    for k in range(1, ops.MAX_K + 1):
        lanes, regs = grid_limits(k, dev)[2:]
        if lanes not in (8, 16, 32) or not k <= lanes * regs <= 32 * lanes:
            raise AssertionError(f"lane group ({lanes}, {regs}) for K = {k}")
    cases = [(n, k, "ragged") for n in EDGE_N for k in EDGE_K]
    cases += [(31, 45, "none"), (31, 45, "one")]
    worst = {name: 0.0 for name in ("bisect_alloc", "dual_demand",
                                     "market_clear", "mbdf_demand")}
    groups = set()
    for n, k, active in cases:
        svc = edge_market(n, k, active)
        a, t, mk = svc.alpha, svc.t_comp, svc.mask
        groups.add(grid_limits(k, dev)[2:])
        rng = np.random.default_rng([n, k, 1])
        live = (a.sum(dim=1) > 0).cpu().numpy()
        b = np.where(live, rng.uniform(0.2, 4.0, n), 0.0)
        b[np.flatnonzero(live)[len(np.flatnonzero(live)) // 2:][:1]] = 0.0
        b = torch.tensor(b, dtype=torch.float32, device=DEVICE)
        tag = f"bisect_alloc@{n}x{k}/{active}"
        got = ops.intra_allocate(a, t, mk, b)
        want = bisect_alloc_plain(a, t, mk, b)
        for g, w, key in zip(got, want, ("t_star", "split")):
            worst["bisect_alloc"] = max(worst["bisect_alloc"], check_close(
                tag, g, w, key)["max_dev"])
        check_close(tag, got[1].sum(dim=1), b, "split_sum")
        depths_bitwise(tag, "bisect_alloc", a, t, mk, b, 48)
        u = rng.uniform(0.1, 0.9, n)
        u[::7] = 1.15
        lam = (intra.p_max(svc) * torch.tensor(u, dtype=torch.float32,
                                               device=DEVICE)).contiguous()
        tag = f"dual_demand@{n}x{k}/{active}"
        got = ops.dual_demand(a, t, mk, lam, iters=24)
        want = dual_demand_plain(a, t, mk, lam, 24)
        for g, w, key in zip(got, want, ("b", "slope")):
            worst["dual_demand"] = max(worst["dual_demand"], check_close(
                tag, g, w, key)["max_dev"])
        depths_bitwise(tag, "dual_demand", a, t, mk, lam, 24)
        cold = market_clear_plain(a, t, mk, B_TOTAL, torch.tensor(
            -1.0, device=DEVICE), iters=12, newton_inner_iters=48)[2]
        lam_prev = (cold * 1.03).contiguous()
        tag = f"market_clear@{n}x{k}/{active}"
        got = ops.market_clear(a, t, mk, B_TOTAL, lam_prev)
        want = market_clear_plain(a, t, mk, B_TOTAL, lam_prev)
        for g, w, key in zip(got, want, ("b", "f", "lam")):
            worst["market_clear"] = max(worst["market_clear"], check_close(
                tag, g, w, key)["max_dev"])
        if active != "none":
            check_close(tag, got[0].sum(), torch.tensor(B_TOTAL), "b")
        inactive = a.sum(dim=1) == 0
        pmax = intra.p_max(svc)
        for m in EDGE_M:
            steps = torch.arange(1, m + 1, dtype=torch.float32, device=DEVICE)
            prices = (1.15 * steps[None, :] * pmax[:, None]
                      / (m + 1)).contiguous()
            tag = f"mbdf_demand@{n}x{k}x{m}/{active}"
            got = ops.mbdf_demand(a, t, mk, prices, 0.5)
            want = mbdf_demand_plain(a, t, mk, prices, 0.5)
            worst["mbdf_demand"] = max(worst["mbdf_demand"], check_close(
                tag, got, want, "demand")["max_dev"])
            if not bool((got >= 0).all()):
                raise AssertionError(f"{tag}: negative demand")
            if not bool((got[:, 1:] <= got[:, :-1]).all()):
                raise AssertionError(f"{tag}: demand rises along the grid")
            if not bool((got[inactive] == 0).all()):
                raise AssertionError(f"{tag}: inactive rows demand bandwidth")
    torch.cuda.synchronize()
    row = {"shapes": len(cases), "b4_grids": len(cases) * len(EDGE_M),
           "lane_groups": sorted(groups), "max_dev": worst}
    emit({"phase": "edge_matrix", **row})
    return row


def full_market(n: int, k: int):
    """The market of ``market`` drawn with every row active and full: no
    alpha = 0 anywhere (the zero lanes' share of B3's and B4's time)."""
    from repro_torch.core import network

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    counts = torch.full((n,), k, dtype=torch.int32, device=DEVICE)
    svc, _ = network.sample_services(gen, n, k_max=k, client_counts=counts)
    return svc


def divide_sass(name: str) -> dict | None:
    """The built library's SASS per kernel function (cuobjdump -sass):
    how many divide checks (FCHK) and subroutine calls (CALL, the IEEE
    divide's slow path) each holds.  The text goes to build/sass_{name}.txt.
    None where the toolkit has no cuobjdump."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(_build._library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    (ROOT / "build" / f"sass_{name}.txt").write_text(text)
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"FCHK": 0, "CALL": 0, "MUFU.RCP": 0}
        elif fn is not None:
            for op in counts[fn]:
                if f" {op}" in line:
                    counts[fn][op] += 1
    return counts


def b3_parts() -> dict:
    """B3's time in parts, from its own launch arguments, at both market
    shapes and on the full copy of each: (a) no trips (the barriers of the
    bracket top and the projection, loads, stores), (b) six Newton trips
    without bisection (their reductions and barriers), (c) plus the 6 x 24
    Newton bisection steps, (d) the full call (plus 2 x 48 steps of the
    final demand and the frequency).  Derived: per trip, per bisection
    step (one step of every row), and the full copy's difference."""
    from repro_torch.core import disba
    from repro_torch.kernels import ops

    variants = {"a": (0, 0, 0), "b": (6, 0, 0), "c": (6, 0, 24),
                "d": (6, 48, 24)}
    out = {}
    for n, k, _ in KERNEL_SHAPES[:2]:
        for label, svc in ((f"{n}x{k}", market(n, k)),
                           (f"{n}x{k}_full", full_market(n, k))):
            a, t, mk = svc.alpha, svc.t_comp, svc.mask
            lam_prev = disba.solve_lambda_newton(svc, B_TOTAL).lam * 1.03
            ms = {v: device_ms(lambda it=it: ops.market_clear(
                      a, t, mk, B_TOTAL, lam_prev, iters=it[0],
                      inner_iters=it[1], newton_inner_iters=it[2]))
                  for v, it in variants.items()}
            out[label] = {**ms, "per_trip_ms": (ms["b"] - ms["a"]) / 6,
                          "per_newton_step_ms": (ms["c"] - ms["b"]) / 144,
                          "per_final_step_ms": (ms["d"] - ms["c"]) / 96}
        out[f"{n}x{k}"]["full_minus_market_ms"] = (
            out[f"{n}x{k}_full"]["d"] - out[f"{n}x{k}"]["d"])
    row = {"variants": {v: {"iters": it[0], "inner_iters": it[1],
                            "newton_inner_iters": it[2]}
                        for v, it in variants.items()},
           **out, "sass": divide_sass("market_clear")}
    emit({"phase": "b3_parts", **row})
    return row


def b4_parts() -> dict:
    """B4's time at M = 5 on the market and its full copy, at alpha_fair
    0.5 and 0 (a_fair / (1 + f) divides 0 when alpha_fair is 0), and with
    no bisection trips (iters 0: loads, the final demand, stores)."""
    from repro_torch.core import auction
    from repro_torch.kernels import ops

    n, k, _ = KERNEL_SHAPES[0]
    m = 5
    out = {}
    for label, svc in (("market", market(n, k)), ("full", full_market(n, k))):
        a, t, mk = svc.alpha, svc.t_comp, svc.mask
        for alpha_fair in (0.5, 0.0):
            prices = auction.uniform_truthful_bids(svc, m, alpha_fair).prices
            for iters in (48, 0):
                out[f"{label}@a={alpha_fair},iters={iters}"] = device_ms(
                    lambda: ops.mbdf_demand(a, t, mk, prices, alpha_fair,
                                            iters=iters))
    per_step = {key: (out[f"{key},iters=48"] - out[f"{key},iters=0"]) / 48
                for key in ("market@a=0.5", "market@a=0.0", "full@a=0.5",
                            "full@a=0.0")}
    row = {"n": n, "k": k, "m": m, "ms": out, "per_step_ms": per_step,
           "sass": divide_sass("mbdf_demand")}
    emit({"phase": "b4_parts", **row})
    return row


# B1 and B2 in parts: the main path's shape (10 x 45: the paper's ten
# services, 25 +- sqrt(15) clients, K = simulator._k_cap), B1's market
# selfish shape (8192 x 45), and phase 3's two market shapes.
B12_SHAPES = ((10, 45), (8192, 45), (8191, 45), (8192, 32))
B12_SWEEP_N = (10, 132, 528, 1056, 2112, 8192)   # the depth sweep, K = 45


def b12_parts() -> dict:
    """B1 and B2's time in parts at each of B12_SHAPES, on the market (as
    ``market``: seed 5, 10% of rows inactive, cold coop price and budget)
    and on its full copy: B1 with 0 and 48 trips, B2 with 0, 24 and 48
    (giving the cost of a trip, and the zero lanes' cost as the full copy's
    difference), the wrapper's time per call beside the kernel's, and the
    count of divide checks and slow-path calls in each kernel's SASS.  Then
    B1 (48 trips) and B2 (24 trips) at every speculation depth of
    DEPTHS over B12_SWEEP_N at K = 45, each depth's outputs bitwise
    those of depth 1, and the depth a launch picks by itself (one rule
    for both)."""
    from repro_torch.core import disba
    from repro_torch.kernels import ops
    from repro_torch.kernels.bisect_alloc import (bisect_alloc_cuda,
                                                  bisect_alloc_plan)
    from repro_torch.kernels.dual_demand import dual_demand_cuda

    def inputs(svc):
        cold = disba.solve_lambda_newton(svc, B_TOTAL)
        return (svc.alpha, svc.t_comp, svc.mask, cold.b.contiguous(),
                (cold.lam * 1.03).contiguous())

    out = {}
    for n, k in B12_SHAPES:
        for label, svc in ((f"{n}x{k}", market(n, k)),
                           (f"{n}x{k}_full", full_market(n, k))):
            a, t, mk, b, lam = inputs(svc)
            ms = {f"b1@{it}": device_ms(
                      lambda it=it: bisect_alloc_cuda(a, t, mk, b, it))
                  for it in (0, 48)}
            ms.update({f"b2@{it}": device_ms(
                           lambda it=it: dual_demand_cuda(a, t, mk, lam, it))
                       for it in (0, 24, 48)})
            out[label] = {
                "ms": ms,
                "b1_per_trip_us": 1e3 * (ms["b1@48"] - ms["b1@0"]) / 48,
                "b2_per_trip_us": 1e3 * (ms["b2@24"] - ms["b2@0"]) / 24,
                "wrapper_ms": {
                    "b1@48": event_ms(lambda: ops.intra_allocate(a, t, mk, b)),
                    "b2@24": event_ms(lambda: ops.dual_demand(
                        a, t, mk, lam, iters=disba.WARM_INNER_ITERS))}}
        for key in ("b1@48", "b2@24", "b2@48"):
            out[f"{n}x{k}"].setdefault("full_minus_market_ms", {})[key] = (
                out[f"{n}x{k}_full"]["ms"][key] - out[f"{n}x{k}"]["ms"][key])
    sweep = {}
    for n in B12_SWEEP_N:
        a, t, mk, b, lam = inputs(market(n, 45))
        row, first = {}, {}
        for j in DEPTHS:
            for name, fn in (
                    ("b1@48", lambda: bisect_alloc_cuda(a, t, mk, b, 48,
                                                        depth=j)),
                    ("b2@24", lambda: dual_demand_cuda(a, t, mk, lam, 24,
                                                       depth=j))):
                got = fn()
                if name in first:
                    bitwise_repeats(f"{name}@{n}x45/depth {j}", fn,
                                    first[name], reps=1)
                else:
                    first[name] = got
                row[f"{name}/depth{j}"] = device_ms(fn)
        row["picked"] = bisect_alloc_plan(n, 45, device=DEVICE)
        sweep[f"{n}x45"] = row
    row = {**out, "sweep": sweep,
           "sass": {name: divide_sass(name)
                    for name in ("bisect_alloc", "dual_demand")}}
    emit({"phase": "b12_parts", **row})
    return row


def compare_episodes(name: str, got: dict, want: dict, period_s: float,
                     must_finish: bool, auction: bool = False,
                     f_at=None) -> dict:
    """Hold a kernel-backend episode to the reference one.

    Rounds per period (floor(f T)) and durations must be equal, with one
    exception: where the two runs' f lie on either side of an integer of
    rounds, floor(f T) may differ by one (float32 f from two summation
    orders), and then that service's duration may differ by one.  Every
    such flip is reported.  b and f are within tolerance; for an auction
    policy (``auction``) by ``check_surplus_split`` (with ``f_at``)."""
    if got["periods"] != want["periods"] or (
            must_finish and not (got["finished"] and want["finished"])):
        raise AssertionError(f"{name}: episodes ran {got['periods']} and "
                             f"{want['periods']} periods, finished "
                             f"{got['finished']} and {want['finished']}")
    if got["fallbacks"] or want["fallbacks"]:
        raise AssertionError(f"{name}: the warm solver's rescue ran "
                             f"{got['fallbacks']} and {want['fallbacks']} "
                             f"times")
    h, rh = got["history"], want["history"]
    dev = (check_surplus_split(name, h["b"], rh["b"], h["f"], rh["f"], f_at)
           if auction else {key: check_close(name, h[key], rh[key], key)
                            for key in ("b", "f")})
    f_got = np.float32(period_s) * got["history"]["f"].astype(np.float32)
    f_want = np.float32(period_s) * want["history"]["f"].astype(np.float32)
    r_got, r_want = got["history"]["rounds"], want["history"]["rounds"]
    straddle = np.floor(f_got) != np.floor(f_want)
    differ = r_got != r_want
    flips = np.argwhere(differ & straddle & (np.abs(r_got - r_want) == 1))
    if np.any(differ & ~straddle) or len(flips) != int(differ.sum()):
        raise AssertionError(f"{name}: rounds differ at "
                             f"{np.argwhere(differ)[:10].tolist()}")
    flipped = set(int(svc) for _, svc in flips)
    d_got, d_want = list(got["durations"]), list(want["durations"])
    bad = [i for i, (x, y) in enumerate(zip(d_got, d_want))
           if x != y and not (i in flipped and abs(x - y) == 1)]
    if bad:
        raise AssertionError(f"{name}: durations differ for services {bad}")
    surplus = {key: dev[col][key] for col, key in (
                   ("b", "surplus_entries"), ("b", "surplus_max_dev"),
                   ("f", "own_b")) if key in dev[col]}
    return {"max_dev_b": dev["b"]["max_dev"], "atol_b": dev["b"]["atol"],
            **surplus,
            "max_dev_f": dev["f"]["max_dev"], "atol_f": dev["f"]["atol"],
            "rounds_per_period_max": int(r_want.max()),
            "durations_min_max": [int(min(d_want)), int(max(d_want))],
            "round_flips": [{"period": int(p), "service": int(v),
                             "fT_kernel": float(f_got[p, v]),
                             "fT_reference": float(f_want[p, v])}
                            for p, v in flips]}


# Kernels each kernel backend must launch in an episode of each policy,
# per path of phase 4.
SLICE1 = {("coop", True, "megakernel"): ("market_clear",),
          ("coop", True, "pallas"): ("dual_demand", "bisect_alloc"),
          ("coop", False, "pallas"): ("bisect_alloc",),
          ("es", False, "pallas"): ("bisect_alloc",),
          ("pp", False, "pallas"): ("bisect_alloc",),
          ("ec", False, "pallas"): ()}
SELFISH = {("selfish", False, "pallas"): ("mbdf_demand", "bisect_alloc"),
           ("selfish", False, "megakernel"): ("mbdf_demand", "bisect_alloc")}
EXPECTED = {**SLICE1, **SELFISH}


def _check_launches(label: str, backend: str, key, klaunch: dict,
                    rlaunch: dict) -> None:
    if any(rlaunch.values()):
        raise AssertionError(f"{label}: the reference run launched {rlaunch}")
    missing = [name for name in EXPECTED[key] if not klaunch[name]]
    if missing:
        raise AssertionError(f"{label}: the {backend} run never launched "
                             f"{missing} ({klaunch})")


@contextlib.contextmanager
def recording_sets(policy: str, sets: list):
    """Within the block, ``policy`` appends every service set it is handed
    (masked, as it sees it) to ``sets``; it computes as before."""
    from repro_torch.core import policy as policy_mod

    factory = policy_mod._REGISTRY[policy]

    def recording(**options):
        fn = factory(**options)

        def step(svc, b_total):
            sets.append(svc)
            return fn(svc, b_total)

        return step

    policy_mod.register(policy)(recording)
    try:
        yield sets
    finally:
        policy_mod.register(policy)(factory)


def f_at_own_b(sets: list, b_hist: np.ndarray):
    """``check_surplus_split``'s f_at for an episode: the reference
    backend's plain f*(b) at each period's own b, on the set its policy
    was handed that period."""
    from repro_torch.core import policy as policy_mod

    freq = policy_mod.freq_fn("reference")

    def f_at(mask: np.ndarray) -> np.ndarray:
        out = []
        for period in np.flatnonzero(mask.any(axis=1)):
            b = torch.from_numpy(np.ascontiguousarray(b_hist[period]))
            f = freq(sets[period], b.to(DEVICE)).cpu().numpy()
            out.append(f[mask[period]])
        return np.concatenate(out)

    return f_at


@contextlib.contextmanager
def keeping_samplers(samplers: list):
    """Within the block, every sampler an engine makes for itself (no
    ``sampler`` given) is appended to ``samplers``; its ``waits`` are the
    seconds the period loop waited on each period's draws."""
    from repro_torch.fl import simulator

    real = simulator._PrefetchingSampler

    class Kept(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            samplers.append(self)

    simulator._PrefetchingSampler = Kept
    try:
        yield samplers
    finally:
        simulator._PrefetchingSampler = real


def draw_wait_ms(samplers: list) -> float | None:
    """Median ms the period loop waited on a period's draws, periods 1-9
    (period 0's draws cannot be made ahead); None where the engine drew
    inline (periods under PREFETCH_MIN_SLOTS slots, the paper's)."""
    if not samplers:
        return None
    (sampler,) = samplers
    return 1e3 * float(np.median(sampler.waits[1:10]))


def run_pair(cfg_kw: dict, label: str, must_finish: bool = True,
             net=None, arrivals=None, counts=None) -> dict:
    """One episode with the kernel backend, one with "reference", on the
    same sampler stream; each run's kernel launches are counted.  For
    ``selfish`` the kernel run's service sets are kept for
    ``check_surplus_split``'s f*(own b)."""
    from repro_torch.fl import simulator
    from repro_torch.kernels import ops

    backend = cfg_kw["intra_backend"]
    auction = cfg_kw["policy"] == "selfish"
    runs, sets, waits = {}, [], {}
    for bk in (backend, "reference"):
        cfg = simulator.SimConfig(**{**PAPER, **cfg_kw, "intra_backend": bk},
                                  collect_alloc=True)
        net = net or simulator._default_net(cfg)
        before = dict(ops.LAUNCHES)
        record = (recording_sets(cfg.policy, sets) if auction and bk == backend
                  else contextlib.nullcontext())
        samplers = []
        t0 = time.perf_counter()
        with record, keeping_samplers(samplers):
            res = simulator.run_scan(cfg, net, arrivals=arrivals,
                                     counts=counts, device=DEVICE)
        sec = time.perf_counter() - t0
        runs[bk] = (res, sec, {name: ops.LAUNCHES[name] - before[name]
                               for name in ops.LAUNCHES})
        waits[bk] = (draw_wait_ms(samplers),
                     [1e3 * w for w in samplers[0].waits] if samplers
                     else None)
    (kres, ksec, klaunch), (rres, rsec, rlaunch) = runs[backend], runs["reference"]
    _check_launches(label, backend,
                    (cfg_kw["policy"], cfg_kw["warm_start"], backend),
                    klaunch, rlaunch)
    if auction and len(sets) != kres["periods"]:
        raise AssertionError(f"{label}: {len(sets)} sets kept for "
                             f"{kres['periods']} periods")
    row = {"case": label, "periods": kres["periods"],
           "kernel_s": ksec, "reference_s": rsec,
           "kernel_periods_per_s": kres["periods"] / ksec,
           "reference_periods_per_s": rres["periods"] / rsec,
           "avg_duration": kres["avg_duration"], "launches": klaunch,
           "draw_wait_ms": waits[backend][0],
           "reference_draw_wait_ms": waits["reference"][0],
           "draw_waits_ms": {bk: w[1] for bk, w in waits.items()},
           **compare_episodes(label, kres, rres, net.period_s, must_finish,
                              auction=auction,
                              f_at=f_at_own_b(sets, kres["history"]["b"]))}
    emit({"phase": "episode", **row})
    return row


def market_kw() -> dict:
    return dict(n_services_total=MARKET_N, max_periods=10,
                rounds_required=100)


def market_setting():
    """The market-scale episode's network (the paper's 1 MHz a service),
    arrivals (all at period 0) and client counts."""
    from repro_torch.fl import simulator

    cfg = simulator.SimConfig(**market_kw())
    net = simulator._default_net(cfg)
    net = dataclasses.replace(net, total_bandwidth_mhz=(
        net.total_bandwidth_mhz * cfg.n_services_total
        / simulator.SimConfig().n_services_total))
    _, counts = simulator._static_draws(cfg, net)
    return net, np.zeros(cfg.n_services_total, np.int64), counts


def market_pair(policy: str, warm: bool, backend: str) -> dict:
    """The market-scale episode: every service arrives at period 0 and gets
    the paper's share of 1 MHz (B = 10 MHz over 10 services), so each runs
    several rounds per period; 100 rounds (not 2000) let services finish,
    at different periods, within the 10-period episode."""
    net, arrivals, counts = market_setting()
    return run_pair(dict(policy=policy, warm_start=warm,
                         intra_backend=backend, **market_kw()),
                    f"{policy}{'-warm' if warm else ''}-{backend}"
                    f"-market{MARKET_N}", must_finish=False, net=net,
                    arrivals=arrivals, counts=counts)


def draw_samplers() -> dict:
    """The measure of C6 and the evidence for PREFETCH_MIN_SLOTS: warm coop
    on "megakernel", at market scale and at the paper's setting, under
    three samplers run in turns (ABC CBA; periods/s of each, median of its
    two runs): the prefetching sampler (the engine's own at market scale),
    default_sampler inline (the engine's own at the paper's), and every
    period's draws made before the episode and already on the card (the
    episode with no host draws).  The episodes must agree in every
    duration."""
    from repro_torch.fl import simulator

    out = {}
    for label in ("market", "paper"):
        common = dict(policy="coop", warm_start=True,
                      intra_backend="megakernel", collect_alloc=True)
        if label == "market":
            net, arrivals, counts = market_setting()
            cfg = simulator.SimConfig(**market_kw(), **common)
        else:
            cfg = simulator.SimConfig(**PAPER, **common)
            net = simulator._default_net(cfg)
            arrivals, counts = simulator._static_draws(cfg, net)
        run = functools.partial(simulator.run_scan, cfg, net,
                                arrivals=arrivals, counts=counts,
                                device=DEVICE)
        inline = simulator.default_sampler(cfg, net, counts, DEVICE)
        card = [inline(p) for p in range(run(sampler=inline)["periods"])]
        samplers = {
            "prefetch": lambda: simulator._PrefetchingSampler(
                cfg, net, counts, DEVICE),
            "inline": lambda: inline,
            "on_card": lambda: card.__getitem__}
        rates, durations = {name: [] for name in samplers}, set()
        for name in list(samplers) + list(samplers)[::-1]:
            sampler = samplers[name]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = run(sampler=sampler)
                torch.cuda.synchronize()
            finally:
                if name == "prefetch":
                    sampler.close()
            rates[name].append(res["periods"] / (time.perf_counter() - t0))
            durations.add(tuple(res["durations"]))
        if len(durations) != 1:
            raise AssertionError(f"draw_samplers/{label}: the samplers ran "
                                 f"different episodes")
        out[label] = {"periods": res["periods"],
                      "slots": cfg.n_services_total * simulator._k_cap(cfg),
                      "engine_prefetches": cfg.n_services_total
                      * simulator._k_cap(cfg) >= simulator.PREFETCH_MIN_SLOTS,
                      "periods_per_s": {name: float(np.median(r))
                                        for name, r in rates.items()},
                      "runs": rates}
    emit({"phase": "draw_samplers", **out})
    return out


def batch_pair() -> dict:
    """run_batch over BATCH_SEEDS with correlated scenario processes, warm
    coop on "megakernel" against "reference"; each seed's episode held to
    the reference's by compare_episodes."""
    from repro_torch import scenarios
    from repro_torch.fl import simulator
    from repro_torch.kernels import ops

    cfg_kw = dict(PAPER, policy="coop", warm_start=True,
                  channel_process=scenarios.spec("gauss_markov"),
                  churn_process=scenarios.spec("gilbert"),
                  arrival_process="mmpp", collect_alloc=True)
    runs = {}
    for bk in ("megakernel", "reference"):
        cfg = simulator.SimConfig(**cfg_kw, intra_backend=bk)
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        res = simulator.run_batch(cfg, list(BATCH_SEEDS), device=DEVICE)
        runs[bk] = (res, time.perf_counter() - t0,
                    {name: ops.LAUNCHES[name] - before[name]
                     for name in ops.LAUNCHES})
    (kres, ksec, klaunch), (rres, rsec, rlaunch) = (runs["megakernel"],
                                                    runs["reference"])
    _check_launches("run_batch", "megakernel", ("coop", True, "megakernel"),
                    klaunch, rlaunch)
    period_s = simulator._default_net(cfg).period_s
    rows = []
    for i, seed in enumerate(BATCH_SEEDS):
        per = [_episode(kres, i), _episode(rres, i)]
        rows.append({"seed": seed, "periods": per[0]["periods"],
                     **compare_episodes(f"run_batch/seed {seed}", *per,
                                        period_s, must_finish=True)})
    periods = sum(r["periods"] for r in rows)
    row = {"case": "run_batch-gauss_markov-gilbert-mmpp-coop-warm-megakernel",
           "seeds": list(BATCH_SEEDS), "kernel_s": ksec, "reference_s": rsec,
           "kernel_periods_per_s": periods / ksec,
           "reference_periods_per_s": periods / rsec,
           "launches": klaunch, "per_seed": rows}
    emit({"phase": "episode", **row})
    return row


def drive_path(label: str, fn, keep: bool = False):
    """Run one main path with the launch counts set to 0 just before it,
    and return the counts read just after (with ``keep``, the path's
    result instead; the counts are in PATH_LAUNCHES either way)."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    result = fn()
    launches = dict(ops.LAUNCHES)
    PATH_LAUNCHES[label] = launches
    emit({"phase": "path", "path": label, "launches": launches})
    return result if keep else launches


PATH_LAUNCHES: dict[str, dict] = {}


def path_slice1() -> None:
    for pol, warm, backend in SLICE1:
        run_pair(dict(policy=pol, warm_start=warm, intra_backend=backend),
                 f"{pol}{'-warm' if warm else ''}-{backend}")
    market_pair("coop", True, "megakernel")


def path_selfish() -> None:
    for pol, warm, backend in SELFISH:
        run_pair(dict(policy=pol, warm_start=warm, intra_backend=backend),
                 f"{pol}-{backend}")
    market_pair("selfish", False, "pallas")


# ---------------------------------------------------------------------------
# Slice 9: training paced by allocation (fl.cotrain), run_fleet, legacy run.
# ---------------------------------------------------------------------------

# BENCH_cotrain's setting (benchmarks/paper_figs_cotrain.py:81-87).
COTRAIN_SIM = dict(n_services_total=5, rounds_required=48, p_arrive=3.0,
                   max_periods=64, k_max=32, mean_clients=12.0,
                   var_clients=12.0)
COTRAIN_NET = dict(total_bandwidth_mhz=2.0, period_s=4.0, mean_clients=12.0,
                   var_clients=12.0, t_local_lo=0.15, t_local_hi=0.3)
COTRAIN_TRAIN = dict(vocab=32, seq_len=8, batch_size=4, eval_batch=32,
                     rounds_cap=14, client_lr=0.5)
# (policy, warm, kernel backend), each against "reference" on the card
COTRAIN_CASES = (("coop", True, "megakernel"), ("coop", True, "pallas"),
                 ("es", False, "pallas"), ("pp", False, "pallas"),
                 ("selfish", False, "pallas"))
COTRAIN_PAPER_CASES = (("coop", True, "megakernel"),
                       ("selfish", False, "pallas"))
# The paper-setting cases cut to 40 periods (the whole episodes, 190-205
# periods of up to 139 executed rounds, took 35 s on the card and 55 s on
# "reference"): services arrive and train, none finishes.
COTRAIN_PAPER = {"max_periods": 40}
COTRAIN_SEEDS = (0, 1, 2)   # run_cotrain_batch against run_cotrain_fleet
FLEET_SEEDS = (0, 1, 2, 3, 4)
FLEET_CHUNK = 2
COTRAIN_KERNELS = ("bisect_alloc", "dual_demand", "market_clear",
                   "mbdf_demand")
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5   # loss, train_loss (the CPU tests')
PARAMS_ATOL = 1e-4


class TimedData:
    """A co-trained episode's batch stream with the host seconds of its
    training draws (one call a round; the episode's one eval draw is not
    counted)."""

    def __init__(self, data):
        self.data, self.seconds, self.rounds = data, 0.0, 0

    def batches(self, step, batch_size, client_ids):
        from repro_torch.fl import cotrain

        t0 = time.perf_counter()
        out = self.data.batches(step, batch_size, client_ids)
        if not np.all(np.asarray(step) == cotrain._EVAL_STEP):
            self.seconds += time.perf_counter() - t0
            self.rounds += 1
        return out


def cotrain_setting():
    """(SimConfig kwargs, NetworkConfig, TrainSpec) of BENCH_cotrain."""
    from repro_torch.core import network
    from repro_torch.fl import cotrain

    return (dict(COTRAIN_SIM), network.NetworkConfig(**COTRAIN_NET),
            cotrain.TrainSpec(**COTRAIN_TRAIN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cotrain_run(cfg, train, net, device=None) -> tuple:
    """One co-trained episode: (result, seconds, launches by kernel, the
    timed batch stream)."""
    from repro_torch.fl import cotrain
    from repro_torch.kernels import ops

    device = device or DEVICE
    data = TimedData(cotrain.default_data(train))
    before = dict(ops.LAUNCHES)
    _sync(device)
    t0 = time.perf_counter()
    res = cotrain.run_cotrain_scan(cfg, train, net, data=data, device=device)
    _sync(device)
    sec = time.perf_counter() - t0
    return (res, sec, {name: ops.LAUNCHES[name] - before[name]
                       for name in ops.LAUNCHES}, data)


def training_deviation(label: str, got: dict, want: dict, train) -> dict:
    """Where two co-trained episodes trained the same rounds with the same
    participants: loss and train_loss within TRAIN_RTOL / TRAIN_ATOL, acc
    within one eval token, the final tables within PARAMS_ATOL (raises
    beyond).  Else the check is not made, and the row says so."""
    h, rh = got["history"], want["history"]
    same = (h["trained"].shape == rh["trained"].shape
            and np.array_equal(h["trained"], rh["trained"])
            and np.array_equal(h["participants"], rh["participants"]))
    if not same:
        return {"same_trained_stream": False}
    out = {"same_trained_stream": True}
    for key in ("loss", "train_loss"):
        err = np.abs(h[key].astype(np.float64) - rh[key])
        if np.any(err > TRAIN_ATOL + TRAIN_RTOL * np.abs(rh[key])):
            raise AssertionError(f"{label}: {key} off by {err.max()}")
        out[f"max_dev_{key}"] = float(err.max())
    one_token = 1.0 / (train.eval_batch * train.seq_len)
    acc = float(np.max(np.abs(h["acc"] - rh["acc"])))
    params = float(np.max(np.abs(got["params"] - want["params"])))
    if acc > one_token + 1e-6 or params > PARAMS_ATOL:
        raise AssertionError(f"{label}: acc off by {acc}, params by "
                             f"{params}")
    out.update(max_dev_acc=acc, one_eval_token=one_token,
               max_dev_params=params)
    return out


def cotrain_pair(label: str, cfg_kw: dict, net, train,
                 must_finish: bool) -> dict:
    """A co-trained episode on a kernel backend and on "reference" on the
    card (durations as compare_episodes holds them, training by
    training_deviation), and the plain run_scan of the kernel backend's
    config in the same call: its durations bitwise the co-trained
    episode's, its periods/s the ratio's denominator."""
    from repro_torch.fl import simulator

    backend = cfg_kw["intra_backend"]
    auction = cfg_kw["policy"] == "selfish"
    runs, sets = {}, []
    for bk in (backend, "reference"):
        cfg = simulator.SimConfig(**{**cfg_kw, "intra_backend": bk})
        record = (recording_sets(cfg.policy, sets) if auction and bk == backend
                  else contextlib.nullcontext())
        with record:
            runs[bk] = cotrain_run(cfg, train, net)
    (kres, ksec, klaunch, kdata), (rres, rsec, rlaunch, _) = (
        runs[backend], runs["reference"])
    _check_launches(label, backend,
                    (cfg_kw["policy"], cfg_kw["warm_start"], backend),
                    klaunch, rlaunch)
    cfg = simulator.SimConfig(**cfg_kw)
    _sync(DEVICE)
    t0 = time.perf_counter()
    plain = simulator.run_scan(cfg, net, device=DEVICE)
    _sync(DEVICE)
    plain_s = time.perf_counter() - t0
    if (plain["durations"] != kres["durations"]
            or plain["periods"] != kres["periods"]):
        raise AssertionError(f"{label}: co-trained durations "
                             f"{kres['durations']} differ from run_scan's "
                             f"{plain['durations']}")
    periods = kres["periods"]
    row = {"case": label, "periods": periods,
           "services": cfg.n_services_total, "k_max": simulator._k_cap(cfg),
           "cotrain_s": ksec, "reference_cotrain_s": rsec, "plain_s": plain_s,
           "cotrain_periods_per_s": periods / ksec,
           "plain_periods_per_s": plain["periods"] / plain_s,
           "cotrain_over_plain": (periods / ksec) / (plain["periods"]
                                                    / plain_s),
           "reference_cotrain_periods_per_s": rres["periods"] / rsec,
           "executed_rounds": int(sum(kres["trained_rounds"])),
           "clipped_rounds": kres["clipped_rounds"],
           "rounds_per_period_max": int(kres["history"]["trained"].sum(
               axis=1).max()),
           "training_rounds_drawn": kdata.rounds,
           "host_ms_per_round_draws": (1e3 * kdata.seconds
                                       / max(kdata.rounds, 1)),
           "launches": klaunch,
           "launches_per_period": {name: count / periods
                                   for name, count in klaunch.items()
                                   if count},
           "final_loss": kres["history"]["loss"][-1].tolist(),
           "final_acc": kres["history"]["acc"][-1].tolist(),
           **training_deviation(label, kres, rres, train),
           **compare_episodes(label, kres, rres, net.period_s, must_finish,
                              auction=auction,
                              f_at=f_at_own_b(sets, kres["history"]["b"]))}
    emit({"phase": "cotrain", **row})
    return row


def _bitwise(label: str, got, want) -> None:
    """Every array of two results (nested dicts and lists) equal bit for
    bit."""
    if isinstance(want, dict):
        for key in want:
            _bitwise(f"{label}/{key}", got[key], want[key])
    elif isinstance(want, np.ndarray):
        if not np.array_equal(got, want, equal_nan=want.dtype.kind == "f"):
            raise AssertionError(f"{label} differs")
    elif got != want:
        raise AssertionError(f"{label} differs: {got} and {want}")


def cotrain_engines() -> dict:
    """At BENCH_cotrain's setting: one seed's warm coop co-trained episode
    on the card and on the CPU; run_cotrain_batch over COTRAIN_SEEDS
    against run_cotrain_fleet at chunk 2; run_fleet over FLEET_SEEDS at
    FLEET_CHUNK against run_batch (warm coop on "megakernel"); the legacy
    run against run_scan, and resumed from its period-2 snapshot against
    itself uninterrupted."""
    from repro_torch.fl import cotrain, simulator

    cfg_kw, net, train = cotrain_setting()
    out = {}
    warm_ref = simulator.SimConfig(**cfg_kw, policy="coop", warm_start=True,
                                   seed=SEEDED_SEED)
    (card, card_s, _, _), (cpu, cpu_s, _, _) = (
        cotrain_run(warm_ref, train, net, device=dev)
        for dev in (DEVICE, "cpu"))
    out["card_vs_cpu"] = {
        "case": f"cotrain coop-warm-reference/seed {SEEDED_SEED}",
        "periods": card["periods"], "card_s": card_s, "cpu_s": cpu_s,
        "durations_equal": card["durations"] == cpu["durations"],
        **training_deviation("cotrain card vs cpu", card, cpu, train),
        **compare_episodes("cotrain card vs cpu", card, cpu, net.period_s,
                           must_finish=True)}

    warm = simulator.SimConfig(**cfg_kw, policy="coop", warm_start=True,
                               intra_backend="megakernel")
    t0 = time.perf_counter()
    batch = cotrain.run_cotrain_batch(warm, train, COTRAIN_SEEDS, net,
                                      device=DEVICE)
    t1 = time.perf_counter()
    fleet = cotrain.run_cotrain_fleet(warm, train, COTRAIN_SEEDS, net,
                                      chunk_size=2, device=DEVICE)
    t2 = time.perf_counter()
    _bitwise("run_cotrain_fleet vs run_cotrain_batch",
             {k: v for k, v in fleet.items() if k != "fleet"}, batch)
    out["cotrain_fleet"] = {"seeds": list(COTRAIN_SEEDS),
                            "periods": batch["periods"].tolist(),
                            "batch_s": t1 - t0, "fleet_s": t2 - t1,
                            "fleet": fleet["fleet"], "bitwise": True}

    t0 = time.perf_counter()
    batch = simulator.run_batch(warm, list(FLEET_SEEDS), net, device=DEVICE)
    t1 = time.perf_counter()
    fleet = simulator.run_fleet(warm, FLEET_SEEDS, net,
                                chunk_size=FLEET_CHUNK, device=DEVICE)
    t2 = time.perf_counter()
    _bitwise("run_fleet vs run_batch",
             {k: v for k, v in fleet.items() if k != "fleet"}, batch)
    out["run_fleet"] = {"seeds": list(FLEET_SEEDS), "batch_s": t1 - t0,
                        "fleet_s": t2 - t1, "fleet": fleet["fleet"],
                        "bitwise": True}

    scan = simulator.run_scan(warm, net, device=DEVICE)
    t0 = time.perf_counter()
    full = simulator.run(warm, net, device=DEVICE)
    t1 = time.perf_counter()
    path = ROOT / "build" / "legacy_run.json"
    path.unlink(missing_ok=True)
    simulator.run(dataclasses.replace(warm, max_periods=2), net,
                  checkpoint_path=str(path), device=DEVICE)
    snap = json.loads(path.read_text())
    resumed = simulator.run(warm, net, state=snap, device=DEVICE)
    if full["durations"] != scan["durations"]:
        raise AssertionError(f"legacy run: durations {full['durations']}, "
                             f"run_scan's {scan['durations']}")
    if resumed["durations"] != full["durations"] or (
            resumed["state"] != full["state"]):
        raise AssertionError("legacy run: the resumed run differs from "
                             "the uninterrupted one")
    out["legacy_run"] = {"periods": full["periods"], "run_s": t1 - t0,
                         "durations_equal_run_scan": True,
                         "resumed_from_period": snap["period"],
                         "resume_equal": True,
                         "draw_stream": snap["draw_stream"]}
    emit({"phase": "cotrain_engines", **out})
    return out


def cotrain_phase() -> dict:
    """Slice 9's path: co-trained episodes at BENCH_cotrain's setting
    (COTRAIN_CASES) and at the paper's (COTRAIN_PAPER_CASES), then the
    engines (cotrain_engines)."""
    from repro_torch.fl import simulator

    cfg_kw, net, train = cotrain_setting()
    # warm-up, untimed: the first vmapped grad steps on the card set up
    # cuBLAS and the batching rules (~8 s)
    cotrain_run(simulator.SimConfig(**{**cfg_kw, "max_periods": 4},
                                    policy="coop", warm_start=True,
                                    intra_backend="megakernel"), train, net)
    rows = []
    for pol, warm, backend in COTRAIN_CASES:
        rows.append(cotrain_pair(
            f"cotrain-bench-{pol}{'-warm' if warm else ''}-{backend}",
            dict(cfg_kw, policy=pol, warm_start=warm, intra_backend=backend),
            net, train, must_finish=True))
    paper = simulator.SimConfig(**PAPER, **COTRAIN_PAPER)
    for pol, warm, backend in COTRAIN_PAPER_CASES:
        rows.append(cotrain_pair(
            f"cotrain-paper-{pol}{'-warm' if warm else ''}-{backend}",
            dict(PAPER, **COTRAIN_PAPER, policy=pol, warm_start=warm,
                 intra_backend=backend),
            simulator._default_net(paper), train,
            must_finish=COTRAIN_PAPER.get("max_periods") is None))
    return {"episodes": rows, **cotrain_engines()}


# ---------------------------------------------------------------------------
# Slice 10: the live allocation daemon (allocd), its chaos drills, and
# Byzantine clients in co-training.
# ---------------------------------------------------------------------------

# The paper's network (NetworkConfig(): B = 10 MHz, T = 20 s) at K = 45
# (simulator._k_cap of the paper's SimConfig), 40 ticks of Poisson(0.5)
# admissions (poisson_admissions on default_rng(0)).
ALLOCD_PAPER = dict(capacity=16, k_max=45, rounds_required=400)
ALLOCD_TICKS, ALLOCD_RATE = 40, 0.5
ALLOCD_CASES = (("coop", True, "megakernel"), ("coop", True, "pallas"),
                ("selfish", False, "pallas"), ("es", False, "pallas"))
ALLOCD_MARKET_TICKS = 10
ALLOCD_MARKET_CASES = (("coop", True, "megakernel"),
                       ("selfish", False, "pallas"))
# benchmarks/bench_fault.py:44-46 (its full plan) and :49-55 (the storm's
# config), on the kernel backends.
STORM = dict(capacities=(16, 64, 256), periods=40, k_max=16,
             rounds_required=400, seed=42, save_every=5)
STORM_BACKENDS = ("megakernel", "pallas")
# benchmarks/bench_robust.py:68-85, warm coop on "megakernel".
ROBUST_SIM = dict(policy="coop", warm_start=True, n_services_total=2,
                  rounds_required=40, p_arrive=2.0, max_periods=60, k_max=12,
                  mean_clients=9.0, var_clients=1.0)
ROBUST_NET = dict(period_s=1.0, mean_clients=9.0, var_clients=1.0)
ROBUST_TRAIN = dict(vocab=16, seq_len=6, batch_size=2, eval_batch=32,
                    rounds_cap=3)
ROBUST_ATTACKS = ("sign_flip", "nan")
ROBUST_AGGREGATORS = ("fedavg", "trimmed_mean", "median", "krum")
ROBUST_ATTACK = dict(byz_frac=0.2, scale=20.0, seed=1)
ROBUST_OPTIONS = dict(trim_frac=0.25, byz_f=3)
CARD_CPU_LOSS_ATOL = 1e-5
# The CLI at its defaults but the capacity: 40 periods of Poisson(0.5)
# admit 19 services, and in the default 16 slots the 17th reuses a freed
# slot, which no single run_scan episode replays (the JAX package's CLI
# prints "trace not replayable" at the defaults too).
ALLOCD_CLI = ("--periods", "40", "--check", "--capacity", "24")
ALLOCD_KERNELS = COTRAIN_KERNELS


async def _serve_ticks(daemon, workload: dict, n_ticks: int,
                       prefix: dict, tick_s: list) -> None:
    """allocd's workload loop, keeping in ``prefix`` the last trace that
    still replayed as one run_scan episode, and each tick's seconds."""
    for p in range(n_ticks):
        for req in workload.get(p, ()):
            daemon.submit(req)
        if daemon.plane.replayable:
            prefix.update(period=daemon.plane.period,
                          trace=daemon.plane.trace())
        t0 = time.perf_counter()
        await daemon.step_period()
        tick_s.append(time.perf_counter() - t0)
    await daemon.close()


def daemon_run(cfg, net, workload: dict, n_ticks: int, device=None) -> dict:
    """One daemon serving ``workload`` for ``n_ticks`` ticks (asyncio loop,
    solves in the executor thread), with its seconds, launches by kernel,
    the seconds each tick spent drawing its period inline, and the longest
    replayable prefix of its trace."""
    import asyncio

    from repro_torch.kernels import ops
    from repro_torch.launch import allocd

    device = device or DEVICE
    daemon = allocd.AllocDaemon(cfg, net, device=device)
    draw_s, tick_s, prefix = [], [], {}
    inner = daemon.plane._draws

    def timed_draws(period):
        t0 = time.perf_counter()
        out = inner(period)
        draw_s.append(time.perf_counter() - t0)
        return out

    daemon.plane._draws = timed_draws
    before = dict(ops.LAUNCHES)
    _sync(device)
    t0 = time.perf_counter()
    asyncio.run(_serve_ticks(daemon, workload, n_ticks, prefix, tick_s))
    _sync(device)
    return {"daemon": daemon, "seconds": time.perf_counter() - t0,
            "tick_s": tick_s, "draw_s": draw_s, "prefix": prefix,
            "launches": {name: ops.LAUNCHES[name] - before[name]
                         for name in ops.LAUNCHES}}


def replay_check(label: str, run: dict) -> dict:
    """The daemon's fresh stream against run_scan on its trace, on its
    device, bit for bit: invariants._check_replay where the whole trace
    replays, else the longest replayable prefix (the ticks before the
    first slot reuse) the same way.  Returns run_scan's rate on it."""
    from repro_torch.chaos import invariants
    from repro_torch.fl import simulator

    plane = run["daemon"].plane
    _sync(plane.device)
    t0 = time.perf_counter()
    if plane.replayable:
        res = invariants._check_replay(plane)
        periods = plane.period
    else:
        periods, (arrivals, counts) = (run["prefix"]["period"],
                                       run["prefix"]["trace"])
        cfg = dataclasses.replace(plane.replay_sim_config(),
                                  max_periods=max(periods, 1))
        hist = simulator.run_scan(cfg, plane.net, arrivals=arrivals,
                                  counts=counts,
                                  device=plane.device)["history"]
        done = [d for d in plane.decisions if d.period < len(hist["b"])]
        bad = [d.period for d in done if not all(
            np.array_equal(getattr(d, key), hist[key][d.period])
            for key in ("b", "f", "active"))]
        res = {"ok": not bad, "skipped": False, "checked": len(done),
               "mismatch_periods": bad[:10]}
        periods = len(hist["b"])
    _sync(plane.device)
    sec = time.perf_counter() - t0
    if not res["ok"] or res["skipped"] or not res["checked"]:
        raise AssertionError(f"{label}: the daemon's stream does not "
                             f"replay through run_scan: {res}")
    return {"replay_bitwise_ticks": res["checked"],
            "replay_whole_trace": plane.replayable,
            "unreplayable_reasons": plane.unreplayable_reasons,
            "run_scan_periods_per_s": periods / sec}


def daemon_episode(run: dict, period_s: float) -> dict:
    """A daemon's served stream in compare_episodes's terms: b, f and
    activity per tick, the rounds floor(f T) the tick granted, and per
    slot the ticks it was active."""
    daemon = run["daemon"]
    served = daemon.served
    f = np.stack([d.f for d in served])
    active = np.stack([d.active for d in served])
    return {"periods": len(served), "finished": True,
            "fallbacks": daemon.plane.metrics["solver_fallbacks"],
            "durations": active.sum(axis=0).tolist(),
            "history": {"b": np.stack([d.b for d in served]), "f": f,
                        "active": active,
                        "rounds": np.maximum(np.floor(
                            np.float32(period_s) * f), 0).astype(np.int32)}}


def _retired(run: dict) -> list:
    return [(r.service_id, r.slot, r.retired_period)
            for r in run["daemon"].plane.retired]


def _rates(run: dict) -> dict:
    ticks = len(run["tick_s"])
    return {"ticks_per_s": ticks / run["seconds"],
            "steady_ticks_per_s": (ticks - 1) / sum(run["tick_s"][1:]),
            "tick_ms_median": 1e3 * float(np.median(run["tick_s"])),
            "first_tick_ms": 1e3 * run["tick_s"][0],
            "draw_ms_median": 1e3 * float(np.median(run["draw_s"])),
            "launches_per_tick": {name: n / ticks for name, n in
                                  run["launches"].items() if n}}


def allocd_paper_case(policy: str, warm: bool, backend: str) -> dict:
    """The daemon at the paper's network on a kernel backend and on
    "reference" on the card (served streams held by compare_episodes,
    completions equal), its replay through run_scan, and for warm coop on
    "megakernel" the same daemon on the CPU."""
    from repro_torch.core import network
    from repro_torch.fl import control_plane
    from repro_torch.launch import allocd

    label = f"allocd-paper-{policy}{'-warm' if warm else ''}-{backend}"
    net = network.NetworkConfig()
    workload = allocd.poisson_admissions(
        np.random.default_rng(0), ALLOCD_RATE, ALLOCD_TICKS,
        ALLOCD_PAPER["k_max"])
    auction = policy == "selfish"
    runs, sets = {}, []
    for bk in (backend, "reference"):
        cfg = control_plane.ControlPlaneConfig(
            **ALLOCD_PAPER, policy=policy, warm_start=warm, intra_backend=bk)
        record = (recording_sets(policy, sets) if auction and bk == backend
                  else contextlib.nullcontext())
        with record:
            # the step caches its policy: build it inside the recording
            control_plane._serve_step.cache_clear()
            runs[bk] = daemon_run(cfg, net, workload, ALLOCD_TICKS)
        control_plane._serve_step.cache_clear()
    kern, ref = runs[backend], runs["reference"]
    _check_launches(label, backend, (policy, warm, backend),
                    kern["launches"], ref["launches"])
    got = daemon_episode(kern, net.period_s)
    row = {"case": label, "ticks": ALLOCD_TICKS,
           "admitted": kern["daemon"].plane.metrics["admitted"],
           **_rates(kern),
           "reference_ticks_per_s": ALLOCD_TICKS / ref["seconds"],
           "launches": kern["launches"],
           **replay_check(label, kern),
           **compare_episodes(label, got, daemon_episode(ref, net.period_s),
                              net.period_s, must_finish=False,
                              auction=auction,
                              f_at=f_at_own_b(sets, got["history"]["b"]))}
    row["daemon_over_run_scan"] = (row["ticks_per_s"]
                                   / row["run_scan_periods_per_s"])
    row["retired_equal"] = _retired(kern) == _retired(ref)
    if not row["retired_equal"] and not row["round_flips"]:
        raise AssertionError(f"{label}: services completed at other ticks "
                             f"than on \"reference\" with no round flip")
    if (policy, warm, backend) == ("coop", True, "megakernel"):
        cpu = daemon_run(runs[backend]["daemon"].plane.cfg, net, workload,
                         ALLOCD_TICKS, device="cpu")
        row["card_vs_cpu"] = {
            "cpu_ticks_per_s": ALLOCD_TICKS / cpu["seconds"],
            **compare_episodes(f"{label} card vs cpu", got,
                               daemon_episode(cpu, net.period_s),
                               net.period_s, must_finish=False)}
    emit({"phase": "allocd", **row})
    return row


def allocd_market_case(policy: str, warm: bool, backend: str) -> dict:
    """The daemon at market capacity: MARKET_N services admitted at tick 0
    (market_setting's client counts and 1 MHz a service), 10 ticks; its
    replay through run_scan bitwise, ticks/s against run_scan's periods/s
    on the same trace, and the ms a tick spends drawing its period."""
    from repro_torch.fl import control_plane
    from repro_torch.launch import allocd

    label = f"allocd-market{MARKET_N}-{policy}{'-warm' if warm else ''}" \
            f"-{backend}"
    net, _, counts = market_setting()
    cfg = control_plane.ControlPlaneConfig(
        capacity=MARKET_N, k_max=45, rounds_required=100, policy=policy,
        warm_start=warm, intra_backend=backend)
    workload = {0: [allocd.Admit(i, int(c)) for i, c in enumerate(counts)]}
    run = daemon_run(cfg, net, workload, ALLOCD_MARKET_TICKS)
    missing = [name for name in EXPECTED[policy, warm, backend]
               if not run["launches"][name]]
    if missing:
        raise AssertionError(f"{label}: never launched {missing}")
    row = {"case": label, "ticks": ALLOCD_MARKET_TICKS, **_rates(run),
           "launches": run["launches"],
           "retired": run["daemon"].plane.metrics["retired"],
           **replay_check(label, run)}
    row["daemon_over_run_scan"] = (row["ticks_per_s"]
                                   / row["run_scan_periods_per_s"])
    emit({"phase": "allocd", **row})
    return row


@contextlib.contextmanager
def probing_poisoned_ticks(probes: list):
    """Within the block, every plane built through ``allocd`` runs each
    tick whose carry holds a non-finite value (a chaos poisoning) through
    the same period step on "reference" too, on copies of the same inputs,
    and appends the comparison to ``probes``: the rescue counts, the
    carry's non-finite entries and where b and f are finite must agree,
    and b and f within tolerance there (raises beyond)."""
    from repro_torch import scenarios, tree
    from repro_torch.core import policy as policy_mod
    from repro_torch.fl import control_plane
    from repro_torch.launch import allocd

    def rescues(pol_state) -> int:
        return (int(pol_state.fallbacks)
                if isinstance(pol_state, policy_mod.WarmDualState) else 0)

    class ProbedPlane(control_plane.ControlPlane):
        def __init__(self, cfg, *args, **kwargs):
            super().__init__(cfg, *args, **kwargs)
            inner = self._step
            ref_step = control_plane._serve_step(
                cfg.policy, cfg.n_bids, cfg.alpha_fair, "reference",
                cfg.warm_start, self.net, cfg.rounds_required,
                scenarios.as_spec(cfg.channel_process, "iid"),
                scenarios.as_spec(cfg.churn_process, "none"))[0]

            def step(*args):
                floats = [x for x in tree.leaves(args[:5])
                          if x.is_floating_point()]
                if all(bool(torch.isfinite(x).all()) for x in floats):
                    return inner(*args)
                copy = tree.tree_map(
                    lambda x: x.clone() if torch.is_tensor(x) else x,
                    list(args))
                out = inner(*args)
                want = ref_step(*copy)
                label = f"poisoned tick {args[5]} ({cfg.intra_backend})"
                got_fb, want_fb = rescues(out[4]), rescues(want[4])
                bad = [sum(int((~torch.isfinite(x)).sum()) for x in
                           tree.leaves(o[:5]) if x.is_floating_point())
                       for o in (out, want)]
                if got_fb != want_fb or bad[0] != bad[1]:
                    raise AssertionError(
                        f"{label}: rescues {got_fb} / {want_fb}, non-finite "
                        f"carry entries {bad[0]} / {bad[1]}")
                row = {"period": int(args[5]), "policy": cfg.policy,
                       "backend": cfg.intra_backend, "fallbacks": got_fb,
                       "carry_nonfinite": bad[0]}
                for key in ("b", "f"):
                    g, w = out[6][key].cpu(), want[6][key].cpu()
                    fin = torch.isfinite(w)
                    if not torch.equal(torch.isfinite(g), fin):
                        raise AssertionError(f"{label}: {key} non-finite "
                                             f"at other entries")
                    row[key] = (check_close(label, g[fin], w[fin],
                                            key)["max_dev"]
                                if fin.any() else None)
                    row[f"{key}_nonfinite"] = int((~fin).sum())
                probes.append(row)
                return out

            self._step = step

    real = allocd.ControlPlane
    allocd.ControlPlane = ProbedPlane
    try:
        yield probes
    finally:
        allocd.ControlPlane = real


@contextlib.contextmanager
def keeping_engines(engines: list):
    """Within the block, every chaos engine a storm builds is appended to
    ``engines`` (its served stream, for tracing a divergence)."""
    from repro_torch.chaos import engine as engine_mod

    real = engine_mod.ChaosEngine

    class Kept(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            engines.append(self)

    engine_mod.ChaosEngine = Kept
    try:
        yield engines
    finally:
        engine_mod.ChaosEngine = real


POISON_CASES = (("coop", True, "megakernel"), ("coop", True, "pallas"),
                ("es", False, "pallas"), ("selfish", False, "pallas"))


def poison_drill() -> list:
    """Non-finite inputs on the card, where they reach the kernels: a plane
    at the paper's network with every slot admitted at its full cohort
    (so every channel entry is an active client) ticks, is poisoned as
    SolverChaos poisons (a channel-state entry, for warm coop also the warm
    seed, at NaN, +Inf and -Inf), and ticks twice more: each poisoned tick
    is probed against "reference" on its inputs (probing_poisoned_ticks),
    the decisions served are finite, and the plane's counters equal those
    of the same drill on "reference"."""
    from repro_torch.chaos import injectors
    from repro_torch.core import network
    from repro_torch.fl import control_plane
    from repro_torch.launch import allocd

    rows = []
    for policy, warm, backend in POISON_CASES:
        for poison in ("channel", "seed") if warm else ("channel",):
            for value in (float("nan"), float("inf"), float("-inf")):
                metrics, probes = {}, []
                for bk in (backend, "reference"):
                    cfg = control_plane.ControlPlaneConfig(
                        capacity=16, k_max=45, rounds_required=100_000,
                        policy=policy, warm_start=warm, intra_backend=bk,
                        channel_process="gauss_markov")
                    with probing_poisoned_ticks(probes if bk == backend
                                                else []):
                        plane = allocd.ControlPlane(
                            cfg, network.NetworkConfig(), device=DEVICE)
                        for i in range(cfg.capacity):
                            plane.admit(i, cfg.k_max)
                        plane.tick()
                        if poison == "seed":
                            ev = injectors.poison_warm_seed(plane, None,
                                                            value=value)
                        else:
                            ev = poison_value(plane, value)
                        served = [plane.tick(), plane.tick()]
                    if not all(np.isfinite(d.b).all() and np.isfinite(d.f)
                               .all() for d in served):
                        raise AssertionError(f"poison drill {policy}/{bk}: "
                                             f"a non-finite decision served")
                    metrics[bk] = dict(plane.metrics)
                label = f"poison-{policy}-{backend}-{poison}-{value}"
                if metrics[backend] != metrics["reference"] or not probes:
                    raise AssertionError(f"{label}: counters {metrics}, "
                                         f"{len(probes)} ticks probed")
                rows.append({"case": label, "event": ev,
                             "probes": probes, **{
                                 key: metrics[backend][key] for key in (
                                     "solver_fallbacks", "carry_repairs",
                                     "nonfinite_decisions",
                                     "degraded_decisions")}})
    emit({"phase": "poison_drill", "rows": rows})
    return rows


def zero_load_drill() -> list:
    """Clients with no transmission load (alpha = 0: an infinite rate, as
    a path loss poisoned to -inf dB gives) stay clients on the card: in
    ten sampled services at K = 45, service 0 wholly (``all``), or in
    every service the slowest client, its t^C raised 50-fold so that it
    alone sets max t^C and the round time (``slowest``).  Each policy of
    POISON_CASES and cold coop on "pallas" and "megakernel" (B1-B4 take a
    row's clients from the set's mask) against "reference" on the same
    inputs: b and f within tolerance."""
    from repro_torch.core import network, policy

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    base, _ = network.sample_services(gen, 10, k_max=45)
    rows = []
    for case in ("all", "slowest"):
        alpha, t_comp = base.alpha.clone(), base.t_comp.clone()
        if case == "all":
            alpha[0] = 0.0
        else:
            tc = torch.where(base.mask, t_comp, -torch.inf)
            idx = torch.argmax(tc, dim=1)
            rows_i = torch.arange(alpha.shape[0], device=DEVICE)
            alpha[rows_i, idx] = 0.0
            t_comp[rows_i, idx] *= 50.0
        svc = base._replace(alpha=alpha, t_comp=t_comp)
        for name, warm in sorted({(p, w) for p, w, _ in POISON_CASES}
                                 | {("coop", False)}):
            out = {}
            for backend in ("reference", "pallas", "megakernel"):
                pol = policy.get_stateful_policy(
                    name, warm_start=warm, intra_backend=backend)
                out[backend] = pol.step(svc, B_TOTAL,
                                        pol.init_state(10, device=DEVICE))
            label = f"zero_load-{case}-{name}{'-warm' if warm else ''}"
            devs = {}
            for backend in ("pallas", "megakernel"):
                got, want = out[backend], out["reference"]
                devs[backend] = {
                    "b": check_close(f"{label}/{backend}", got[0], want[0],
                                     "b")["max_dev"],
                    "f": check_close(f"{label}/{backend}", got[1], want[1],
                                     "f")["max_dev"]}
            rows.append({"case": label, "max_dev": devs})
    emit({"phase": "zero_load_drill", "rows": rows})
    return rows


def poison_value(plane, value: float) -> dict:
    """poison_channel_state's write, at a given value: the first float leaf
    of the channel state, entry 0 (an active client's here)."""
    from repro_torch import tree

    carry = list(plane._carry)
    leaves = tree.leaves(carry[2])
    leaf = leaves[0].clone()
    leaf.view(-1)[0] = value
    carry[2] = tree.unflatten(carry[2], [leaf] + leaves[1:])
    plane._carry = tuple(carry)
    return {"action": "poison_channel", "leaf": 0, "index": 0,
            "value": repr(value)}


def storm_once(capacity: int, backend: str, probes: list | None = None):
    """One bench_fault storm on the card: (report, engine, seconds)."""
    import tempfile

    from repro_torch import chaos
    from repro_torch.fl import control_plane

    cfg = control_plane.ControlPlaneConfig(
        capacity=capacity, k_max=STORM["k_max"], policy="coop",
        warm_start=True, rounds_required=STORM["rounds_required"],
        channel_process="gauss_markov", heartbeat_timeout_periods=2, seed=0,
        intra_backend=backend)
    engines = []
    probe = (probing_poisoned_ticks(probes) if probes is not None
             else contextlib.nullcontext())
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt, probe, \
            keeping_engines(engines):
        _sync(DEVICE)
        t0 = time.perf_counter()
        report = chaos.run_storm(cfg, seed=STORM["seed"],
                                 n_periods=STORM["periods"],
                                 checkpoint_dir=ckpt,
                                 save_every=STORM["save_every"],
                                 max_stale_streak=4, device=DEVICE)
        _sync(DEVICE)
    return report, engines[0], time.perf_counter() - t0


def trajectory_against(label: str, got, want, period_s: float) -> dict:
    """A kernel storm's event trajectory against the "reference" storm's:
    equal, or the first divergence with the one-round flip before it that
    explains it (raises when no flip does)."""
    (report, engine), (ref_report, ref_engine) = got, want
    if report["events"] == ref_report["events"]:
        return {"trajectory_equal_reference": True}
    events = (report["events"], ref_report["events"])
    first = next((i for i, (a, b) in enumerate(zip(*events)) if a != b),
                 min(map(len, events)))
    period = min(ev[first]["period"] for ev in events if first < len(ev))
    flips = []
    for t, (d, r) in enumerate(zip(engine.served[:period + 1],
                                   ref_engine.served[:period + 1])):
        a = np.float32(period_s) * d.f
        b = np.float32(period_s) * r.f
        for slot in np.flatnonzero(np.floor(a) != np.floor(b)):
            flips.append({"tick": t, "slot": int(slot),
                          "fT_kernel": float(a[slot]),
                          "fT_reference": float(b[slot])})
    if not flips or any(abs(np.floor(f["fT_kernel"])
                            - np.floor(f["fT_reference"])) != 1
                        for f in flips):
        raise AssertionError(f"{label}: the trajectory leaves the "
                             f"reference's at event {first} (period "
                             f"{period}) with no one-round flip before it")
    return {"trajectory_equal_reference": False, "first_divergence":
            {"event": first, "period": period}, "round_flips": flips}


def storm_phase() -> list:
    """bench_fault's full plan on the card: per capacity the storm on
    "reference" and, per kernel backend, twice (equal digests; the first
    run's poisoned ticks probed against "reference"), every invariant ok,
    the trajectory against the reference's."""
    rows = []
    for capacity in STORM["capacities"]:
        ref_report, ref_engine, ref_s = storm_once(capacity, "reference")
        for backend in STORM_BACKENDS:
            probes = []
            r1, e1, s1 = storm_once(capacity, backend, probes)
            r2, _, s2 = storm_once(capacity, backend)
            label = f"storm-{capacity}-{backend}"
            failed = [k for k, v in r1["invariants"].items() if not v["ok"]]
            if failed or r1["digest"] != r2["digest"]:
                raise AssertionError(f"{label}: invariants failed {failed}, "
                                     f"digests {r1['digest']} / "
                                     f"{r2['digest']}")
            poisoned = sum(e["action"].startswith("poison")
                           for e in r1["events"])
            m = r1["metrics"]
            row = {"case": label, "capacity": capacity, "backend": backend,
                   "periods": STORM["periods"], "seconds": [s1, s2],
                   "reference_seconds": ref_s, "digest": r1["digest"],
                   "digest_repeat_equal": True, "n_events": r1["n_events"],
                   "restarts": r1["restarts"], "served": r1["served"],
                   "decisions_lost": r1["decisions_lost"],
                   "recovery": r1["recovery"],
                   **{key: m[key] for key in (
                       "solver_fallbacks", "nonfinite_decisions",
                       "carry_repairs", "checkpoint_skips", "admit_retries",
                       "heartbeat_drops", "stale_decisions",
                       "degraded_decisions")},
                   "reference_metrics": ref_report["metrics"],
                   "invariants_ok": True, "replay": r1["invariants"][
                       "replay"],
                   "poison_events": poisoned, "poisoned_ticks": probes,
                   **trajectory_against(label, (r1, e1),
                                        (ref_report, ref_engine),
                                        e1.daemon.plane.net.period_s)}
            emit({"phase": "storm", **row})
            rows.append(row)
    return rows


def robust_phase() -> list:
    """bench_robust's Byzantine co-training on the card: warm coop on
    "megakernel" and "reference" and on the CPU, under sign_flip and nan
    at 20% with each aggregator: durations those of the unattacked
    episode, training bitwise alike on both backends, card against CPU
    loss within CARD_CPU_LOSS_ATOL, finite tables from every robust
    aggregator under nan."""
    from repro_torch.chaos import AttackSpec, invariants
    from repro_torch.core import network
    from repro_torch.fl import cotrain, simulator

    net = network.NetworkConfig(**ROBUST_NET)
    train = cotrain.TrainSpec(**ROBUST_TRAIN)
    cfg = simulator.SimConfig(**ROBUST_SIM, intra_backend="megakernel")
    clean = cotrain.run_cotrain_scan(cfg, train, net, device=DEVICE)
    plain = simulator.run_scan(cfg, net, device=DEVICE)
    if clean["durations"] != plain["durations"]:
        raise AssertionError("robust: the clean co-trained durations differ "
                             "from run_scan's")
    rows = []
    for attack in ROBUST_ATTACKS:
        spec_atk = AttackSpec(attack=attack, **ROBUST_ATTACK)
        for aggregator in ROBUST_AGGREGATORS:
            label = f"robust-{attack}-{aggregator}"
            spec = dataclasses.replace(train, aggregator=aggregator,
                                       **ROBUST_OPTIONS)
            runs = {}
            for name, bk, dev in (("card", "megakernel", DEVICE),
                                  ("card_reference", "reference", DEVICE),
                                  ("cpu", "megakernel", "cpu")):
                _sync(DEVICE)
                t0 = time.perf_counter()
                runs[name] = cotrain.run_cotrain_scan(
                    dataclasses.replace(cfg, intra_backend=bk), spec, net,
                    device=dev, attack=spec_atk)
                _sync(DEVICE)
                runs[name]["seconds"] = time.perf_counter() - t0
            got = runs["card"]
            for name, res in runs.items():
                if res["durations"] != clean["durations"]:
                    raise AssertionError(f"{label}/{name}: the attack moved "
                                         f"the durations")
            training = ("loss", "acc", "train_loss", "trained",
                        "participants")
            _bitwise(f"{label} megakernel vs reference",
                     {"history": {k: got["history"][k] for k in training},
                      "params": got["params"]},
                     {"history": {k: runs["card_reference"]["history"][k]
                                  for k in training},
                      "params": runs["card_reference"]["params"]})
            loss_dev = np.abs(got["history"]["loss"].astype(np.float64)
                              - runs["cpu"]["history"]["loss"])
            nan_same = np.array_equal(np.isnan(got["history"]["loss"]),
                                      np.isnan(runs["cpu"]["history"]["loss"]))
            loss_dev = float(np.nanmax(loss_dev)) if np.isfinite(
                loss_dev).any() else 0.0
            if not nan_same or loss_dev > CARD_CPU_LOSS_ATOL:
                raise AssertionError(f"{label}: card against CPU loss off by "
                                     f"{loss_dev} (NaN where the CPU's is: "
                                     f"{nan_same})")
            finite = invariants.params_finite(got["params"])["ok"]
            if attack == "nan" and aggregator != "fedavg" and not finite:
                raise AssertionError(f"{label}: a robust aggregator served "
                                     f"non-finite tables")
            acc = got["history"]["acc"][got["periods"] - 1]
            row = {"case": label, "periods": got["periods"],
                   "card_s": got["seconds"],
                   "reference_s": runs["card_reference"]["seconds"],
                   "cpu_s": runs["cpu"]["seconds"],
                   "durations_equal_clean": True,
                   "training_bitwise_megakernel_reference": True,
                   "card_cpu_loss_max_dev": loss_dev,
                   "params_finite": finite,
                   "final_acc": float(np.mean(acc)),
                   "clean_final_acc": float(np.mean(
                       clean["history"]["acc"][clean["periods"] - 1]))}
            emit({"phase": "robust", **row})
            rows.append(row)
    return rows


def allocd_phase() -> dict:
    """Slice 10's path: the daemon at the paper's network (ALLOCD_CASES)
    and at market capacity (ALLOCD_MARKET_CASES), the chaos storms, the
    Byzantine co-training, and the CLI's replay check."""
    from repro_torch.core import network
    from repro_torch.fl import control_plane
    from repro_torch.launch import allocd

    # warm-up, untimed: the first asyncio loop and executor thread
    daemon_run(control_plane.ControlPlaneConfig(
        **ALLOCD_PAPER, intra_backend="megakernel"), network.NetworkConfig(),
        {0: [allocd.Admit("w", 8)]}, 3)
    out = {"paper": [allocd_paper_case(*case) for case in ALLOCD_CASES],
           "market": [allocd_market_case(*case)
                      for case in ALLOCD_MARKET_CASES],
           "poison": poison_drill(), "zero_load": zero_load_drill(),
           "storms": storm_phase(),
           "robust": robust_phase()}
    t0 = time.perf_counter()
    cli = allocd.main([*ALLOCD_CLI, "--device", DEVICE])
    if not (cli.get("replay") or {}).get("bitwise"):
        raise AssertionError(f"allocd CLI: replay check failed: {cli}")
    out["cli"] = {"argv": [*ALLOCD_CLI, "--device", DEVICE], "seconds":
                  time.perf_counter() - t0, **cli}
    emit({"phase": "allocd_cli", **out["cli"]})
    return out


def auction_phase() -> dict:
    """Phase 8: the auction entry on the card against the same call on the
    CPU, and the prefix charges against the rerun."""
    from repro_torch.core import auction, fairness
    from repro_torch.core.types import ServiceSet

    def welfare_atol(bid, b):
        welfare = float(auction.pseudo_mmvf_integral(
            bid, torch.zeros_like(b), b).sum())
        return 1e-4 + 1e-6 * welfare

    svc = market(AUCTION_N, 32)
    b_total = float(AUCTION_N)            # the paper's 1 MHz per service
    t0 = time.perf_counter()
    res = auction.run_auction(svc, b_total, 5, 0.5, backend="pallas")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = ServiceSet(*(None if x is None else x.cpu() for x in svc))
    t0 = time.perf_counter()
    ref = auction.run_auction(cpu, b_total, 5, 0.5, backend="pallas")
    cpu_s = time.perf_counter() - t0
    tag = f"run_auction@{AUCTION_N}"
    total = check_close(tag, res.b.sum(), torch.tensor(b_total), "split_sum")
    short = res.charges - fairness.fairness_cost(res.f, 0.5)
    if not bool((short >= -1e-6).all()):
        raise AssertionError(f"{tag}: a charge is below its fairness cost "
                             f"by {float(-short.min())}")
    bid = auction.uniform_truthful_bids(cpu, 5, 0.5, backend="pallas")
    atol = welfare_atol(bid, ref.b)
    checks = {"b_total": total,
              "price": check_close(tag, res.price, ref.price, "price"),
              **check_surplus_split(tag, res.b, ref.b, res.f, ref.f),
              "charges": check_close(tag, res.charges, ref.charges, "demand",
                                     atol=atol)}

    small = market(RERUN_N, 32)
    bid = auction.uniform_truthful_bids(small, 5, 0.5, backend="pallas")
    b, _ = auction.allocate(bid, float(RERUN_N))
    args = (small, bid, b, float(RERUN_N), 0.5)
    prefix = auction.charges(*args, method="prefix")
    rerun = auction.charges(*args, method="rerun")
    tag = f"charges@{RERUN_N}"
    checks["prefix_vs_rerun"] = check_close(tag, prefix, rerun, "demand",
                                            atol=welfare_atol(bid, b))
    row = {"n": AUCTION_N, "m": 5, "b_total": b_total,
           "price": float(res.price), "card_s": card_s, "cpu_s": cpu_s,
           "prefix_ms": event_ms(lambda: auction.charges(*args,
                                                         method="prefix")),
           "rerun_ms": event_ms(lambda: auction.charges(*args,
                                                        method="rerun")),
           "checks": checks}
    emit({"phase": "auction", **row})
    return row


# ---------------------------------------------------------------------------
# The serve path of gemma3-1b: attention kernels, serving, parity.
# ---------------------------------------------------------------------------

def _live_pairs(s_len: int, window: int) -> int:
    """(query, key) pairs the causal mask, and the window if > 0, keep."""
    if window <= 0:
        return s_len * (s_len + 1) // 2
    w = min(window, s_len)
    return w * (w + 1) // 2 + (s_len - w) * w


def _heads(gen, dtype, *shapes):
    return [torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
            for shape in shapes]


def _sdpa_mask(s_len: int, window: int):
    rows = torch.arange(s_len, device=DEVICE)[:, None]
    cols = torch.arange(s_len, device=DEVICE)[None, :]
    return (rows >= cols) & (rows - cols < window)


def _max_err(got, want, tol: float, label: str) -> float:
    """Raise unless |got - want| <= tol + tol |want| and got is finite, of
    want's shape and dtype; returns the largest deviation."""
    err = (got.double() - want.double()).abs()
    bad = err > tol + tol * want.double().abs()
    if got.shape != want.shape or got.dtype != want.dtype or bad.any() \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: {int(bad.sum())} entries beyond "
                             f"rtol = atol = {tol}; max dev "
                             f"{float(err.max())}; shapes {tuple(got.shape)}"
                             f" {tuple(want.shape)}")
    return float(err.max())


def attention_row(name: str, case: str, dtype, kern, plain, library,
                  work_ops: float, nbytes: float, names=()) -> dict:
    """One attention case: the deviation from the plain version, the times,
    the bound, and the achieved rate of the resource that bounds the case
    (TFLOP/s of live work, or GB/s of the bytes the bound counts) with
    bound_ms / ms, the kernel's share of its bound."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    tol = ATTENTION_TOL[dtype]
    max_dev = _max_err(got, want, tol, f"{name}/{case}/{dtype}")
    peak = PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_F32_OPS
    bound_ms, bound_by = bound(work_ops, nbytes, peak)
    ms = device_ms(kern)
    rate = ({"tflop_per_s": work_ops / ms / 1e9} if bound_by == "operations"
            else {"gb_per_s": nbytes / ms / 1e6})
    row = {"name": name, "case": case, "dtype": str(dtype).split(".")[-1],
           "max_abs_err": max_dev, "rtol": tol, "atol": tol,
           "ms": ms,
           "profiler_ms": kernel_profiler_ms(kern, name, names=names,
                                             min_records=1),
           "wrapper_ms": event_ms(kern), "plain_ms": event_ms(plain),
           "library_ms": device_ms(library),
           "bound_ms": bound_ms, "bound_by": bound_by, **rate,
           "share_of_bound": bound_ms / ms,
           "gflop": work_ops / 1e9, "mbytes": nbytes / 1e6}
    emit({"phase": "attention_vs_plain", **row})
    return row


def attention_phase() -> dict:
    """Phase 4: B5 and B6 against their plain versions on the card."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain

    gen = torch.Generator(device=DEVICE).manual_seed(13)
    rows = {}
    flash_kernel = {torch.bfloat16: "flash_attention_wgmma_kernel",
                    torch.float32: "flash_attention_kernel"}
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.finfo(dtype).bits // 8
        cases = dict(FLASH_CASES)
        if dtype == torch.bfloat16:
            cases.update(SERVE_LAYOUT_CASES)
        for case, (b, hq, hkv, s_len, d, window) in cases.items():
            if case in SERVE_LAYOUT_CASES:   # (B, S, H, D) -> (B, H, S, D)
                q, k, v = (x.transpose(1, 2) for x in _heads(
                    gen, dtype, (b, s_len, hq, d), (b, s_len, hkv, d),
                    (b, s_len, hkv, d)))
            else:
                q, k, v = _heads(gen, dtype, (b, hq, s_len, d),
                                 (b, hkv, s_len, d), (b, hkv, s_len, d))
            mask = _sdpa_mask(s_len, window) if window else None
            rows["flash_attention", case, dtype] = attention_row(
                "flash_attention", case, dtype,
                lambda: ops.attention(q, k, v, causal=True, window=window),
                lambda: flash_attention_plain(q, k, v, causal=True,
                                              window=window),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=True),
                4.0 * d * b * hq * _live_pairs(s_len, window),
                elt * (2 * b * hq * s_len * d + 2 * b * hkv * s_len * d),
                names=(flash_kernel[dtype],))
        for case, (b, hq, hkv, cache, d, valid, lo) in DECODE_CASES.items():
            q, k, v = _heads(gen, dtype, (b, hq, d), (b, cache, hkv, d),
                             (b, cache, hkv, d))
            kw, vw, n = k[:, lo:valid], v[:, lo:valid], valid - lo
            kt, vt = kw.transpose(1, 2), vw.transpose(1, 2)
            rows["decode_attention", case, dtype] = attention_row(
                "decode_attention", case, dtype,
                lambda: ops.attention_decode(q, kw, vw, n),
                lambda: decode_attention_plain(q, kw, vw, n),
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kt, vt, enable_gqa=True),
                4.0 * d * b * hq * n,
                elt * (2 * b * hq * d + 2 * b * hkv * n * d),
                names=("decode_attention_kernel",))
    return rows


def serve_phase() -> dict:
    """Phase 5: full-width gemma3-1b served through the port's entry point;
    the launch counts of the counted run are checked by main."""
    from repro_torch.launch import serve

    argv = ["--arch", SERVE["arch"], "--no-reduced", "--batch",
            str(SERVE["batch"]), "--prompt-len", str(SERVE["prompt_len"]),
            "--temperature", "0", "--device", DEVICE]
    serve.main(argv + ["--gen", "2"])          # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = drive_path("serve", lambda: serve.main(argv + ["--gen",
                                                         str(SERVE["gen"])]),
                     keep=True)
    wall = time.perf_counter() - t0
    out, info = res["tokens"], res["info"]
    b, gen = SERVE["batch"], SERVE["gen"]
    want_len = SERVE["prompt_len"] + gen - 1
    if out.shape != (b, gen) or info["cache"]["len"] != want_len:
        raise AssertionError(f"serve: tokens {tuple(out.shape)}, cache len "
                             f"{info['cache']['len']}, expected ({b}, {gen}) "
                             f"and {want_len}")
    if not bool(torch.isfinite(info["logits"]).all()):
        raise AssertionError("serve: non-finite logits")
    profile = decode_profile(res["model"], res["params"], info["cache"],
                             out[:, -1:])
    prefill = prefill_profile(res["model"], res["params"], res["prompts"],
                              SERVE["prompt_len"] + gen,
                              "flash_attention_wgmma_kernel")
    row = {"arch": SERVE["arch"], "batch": b, "prompt_len": SERVE["prompt_len"],
           "gen": gen, "dtype": "bfloat16", "prefill_s": info["t_prefill"],
           "decode_steps": info["decode_steps"], "decode_s": info["t_decode"],
           "decode_ms_per_step": 1e3 * info["t_decode"] / info["decode_steps"],
           "decode_tokens_per_s": b * info["decode_steps"] / info["t_decode"],
           "prefill_tokens_per_s": b * SERVE["prompt_len"] / info["t_prefill"],
           "wall_s_with_init": wall, "cache_len": info["cache"]["len"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_step_profile": profile, "prefill_profile": prefill}
    emit({"phase": "serve", **row})
    return row


def decode_profile(model, params, cache, tok) -> dict:
    """One more decode step (the cache has room for it) under the profiler:
    the device activities it records (kernels, copies), their summed
    device time, the top names, and the step's wall time (inflated by the
    profiler; the serve row's decode ms per step is the unprofiled one).
    Informational: the profiler may drop records."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in device:
        entry = by_name.setdefault(e.name[:60], [0, 0.0])
        entry[0] += 1
        entry[1] += e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    busy_ms = sum(v[1] for v in by_name.values())
    return {"device_activities": len(device), "device_busy_ms": busy_ms,
            "profiled_wall_ms": wall_ms,
            "top": [{"name": k, "count": v[0], "ms": v[1]} for k, v in top]}


def prefill_profile(model, params, prompts, max_len: int,
                    kernel: str) -> dict:
    """One more prefill of the served prompts under the profiler (outside
    the counted path): its device activities, their summed device time,
    the device time of the kernels whose names contain ``kernel``, and the
    prefill's wall time (inflated by the profiler; the serve row's
    prefill_s is the unprofiled one).  It says how much of the prefill
    the device is busy, and how much of that the attention kernel takes.
    Informational: the profiler may drop records."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, {"tokens": prompts},
                                  max_len=max_len)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine = [e for e in device if kernel in e.name]
    return {"device_activities": len(device),
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in device) / 1e3,
            "kernel": kernel, "kernel_launches": len(mine),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in mine) / 1e3,
            "profiled_wall_ms": wall_ms}


def lockstep_parity(label: str, cfg, batch: int, prompt_len: int,
                    gen: int) -> dict:
    """The kernel path on the card against the plain path on the CPU: one
    float32 parameter set on both, prefill then greedy decode in lockstep
    (both sides take the CPU's token).  Last-position logits within
    MODEL_TOL at every step; a token that differs is reported with the
    CPU's top-2 gap and fails unless that gap is within 2 atol (a near
    tie)."""
    from repro_torch.launch import serve
    from repro_torch.models import registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = registry.build_model(cfg)
    cpu_params = model.init(0, device="cpu")
    card_params = _to_device(cpu_params)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(3))
    runs = {"card": (card_params, prompts.to(DEVICE)),
            "cpu": (cpu_params, prompts)}
    state = {}
    for dev, (params, toks) in runs.items():
        state[dev] = model.prefill(params, {"tokens": toks},
                                   max_len=prompt_len + gen)
    steps, flips = [], []
    for step in range(gen + 1):
        logits = {dev: state[dev][0][:, -1].double().cpu() for dev in state}
        err = (logits["card"] - logits["cpu"]).abs()
        bad = err > MODEL_TOL + MODEL_TOL * logits["cpu"].abs()
        if bad.any() or not bool(torch.isfinite(logits["card"]).all()):
            raise AssertionError(f"{label} step {step}: {int(bad.sum())} "
                                 f"logits beyond rtol = atol = {MODEL_TOL}; "
                                 f"max dev {float(err.max())}")
        steps.append(float(err.max()))
        if step == gen:
            break
        toks = {dev: serve.sample_token(None, state[dev][0], 0.0)
                for dev in state}
        for row in torch.nonzero(toks["card"].cpu() != toks["cpu"])[:, 0]:
            top2 = torch.topk(logits["cpu"][row], 2).values
            gap = float(top2[0] - top2[1])
            flips.append({"step": step, "row": int(row), "cpu_gap": gap})
            if gap > 2 * MODEL_TOL:
                raise AssertionError(f"{label} step {step}: greedy tokens "
                                     f"differ at row {int(row)} with a top-2 "
                                     f"gap of {gap}")
        tok = toks["cpu"]
        for dev, (params, _) in runs.items():
            state[dev] = model.decode_step(params, state[dev][1],
                                           tok.to(state[dev][0].device))
    row = {"arch": cfg.name, "dtype": "float32", "n_layers": cfg.n_layers,
           "batch": batch, "prompt_len": prompt_len, "gen": gen,
           "rtol": MODEL_TOL, "atol": MODEL_TOL, "max_dev_per_step": steps,
           "max_dev": max(steps), "token_flips": flips}
    return row


def parity_phase() -> dict:
    """Phase 6: gemma3-1b in float32 cut to 2 layers (one local, one
    global), card against CPU."""
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(SERVE["arch"]),
                              n_layers=PARITY["n_layers"], global_every=2,
                              dtype="float32")
    row = lockstep_parity("parity", cfg, PARITY["batch"],
                          PARITY["prompt_len"], PARITY["gen"])
    row["windows"] = [0 if cfg.is_global_layer(i) else cfg.sliding_window
                      for i in range(cfg.n_layers)]
    emit({"phase": "parity", **row})
    return row


# ---------------------------------------------------------------------------
# The xLSTM serve path of xlstm-1.3b: the mLSTM kernel, serving, parity.
# ---------------------------------------------------------------------------

def mlstm_phase() -> dict:
    """B7 against its plain version on the card, bfloat16 and float32:
    the serve shape from the zero state, a ragged shape, and a carry (two
    halves with the state handed across, against the whole sequence).
    Inputs follow the JAX kernel test's recipe (k / sqrt(Dh), i ~ N(0, 0.5),
    f ~ N(2, 0.5)); y and the final C, n and m are checked.  In bfloat16
    each of the two kernels is also held to its own plain version: the
    states kernel's chunk states and final state against
    chunk_states_plain, the outputs kernel's y against chunk_outputs_plain
    on the same (the kernel's) states."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk_plain

    gen = torch.Generator(device=DEVICE).manual_seed(17)

    def draw(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=DEVICE) * scale
                + shift)

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.finfo(dtype).bits // 8
        tol = MLSTM_TOL[dtype]
        for case, (b, h, s_len, dh, split) in MLSTM_CASES.items():
            q, k, v = (draw(b, h, s_len, dh).to(dtype) for _ in range(3))
            k = k / dh ** 0.5
            ig = draw(b, h, s_len, scale=0.5).to(dtype)
            fg = draw(b, h, s_len, scale=0.5, shift=2.0).to(dtype)
            full = (q, k, v, ig, fg)
            want_y, want_state = mlstm_chunk_plain(*full)
            if split:
                first = [x[:, :, :split] for x in full]
                second = [x[:, :, split:] for x in full]
                y1, mid = ops.mlstm(*first)
                y2, got_state = ops.mlstm(*second, mid)
                got_y = torch.cat([y1, y2], dim=2)
                timed, state_in = second, mid
                tokens = s_len - split
            else:
                got_y, got_state = ops.mlstm(*full)
                timed, state_in = full, None
                tokens = s_len
            torch.cuda.synchronize()
            label = f"mlstm_chunk/{case}/{dtype}"
            errs = [_max_err(got_y, want_y, tol, label + "/y")]
            errs += [_max_err(g, w, tol, f"{label}/{key}") for g, w, key in
                     zip(got_state, want_state, ("C", "n", "m"))]
            kern = (lambda: ops.mlstm(*timed, state_in))
            plain = (lambda: mlstm_chunk_plain(*timed, state_in))
            work = 4.0 * dh * (dh + BOUND_CHUNK) * b * h * tokens
            state_bytes = 4 * b * h * (dh * dh + dh + 1)
            nbytes = (elt * (4 * b * h * tokens * dh + 2 * b * h * tokens)
                      + state_bytes * (2 if split else 1))
            peak = PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_F32_OPS
            bound_ms, bound_by = bound(work, nbytes, peak)
            names = (MLSTM_KERNELS if dtype == torch.bfloat16
                     else ("mlstm_chunk_kernel",))
            row = {"name": "mlstm_chunk", "case": case,
                   "shape": [b, h, s_len, dh], "split": split,
                   "dtype": str(dtype).split(".")[-1],
                   "max_abs_err_y_C_n_m": errs, "rtol": tol, "atol": tol,
                   "ms": device_ms(kern),
                   "profiler_ms": kernel_profiler_ms(
                       kern, "mlstm_chunk", names=names, min_records=1),
                   "wrapper_ms": event_ms(kern), "plain_ms": event_ms(plain),
                   "library_ms": None, "bound_ms": bound_ms,
                   "bound_by": bound_by, "gflop": work / 1e9,
                   "mbytes": nbytes / 1e6}
            if dtype == torch.bfloat16:
                row["kernels"] = mlstm_parts(label, timed, state_in, tol)
                errs += [e for part in row["kernels"]
                         for e in part["max_abs_err"]]
            row["max_abs_err"] = max(errs)
            row["share_of_bound"] = bound_ms / row["ms"]
            emit({"phase": "mlstm_vs_plain", **row})
            rows[case, dtype] = row
    return rows


def mlstm_parts(label: str, args, state_in, tol: float) -> list[dict]:
    """B7's two bf16 kernels, each against its own plain version on the
    same inputs: the states kernel's chunk states (C_c in bf16, n_c, m_c)
    and final (C, n, m) against chunk_states_plain, and the outputs
    kernel's y, on the states the states kernel wrote, against
    chunk_outputs_plain on those states.  Per kernel: deviations, the
    kernel's device time and profiler time, its plain version's time."""
    from repro_torch.kernels.mlstm_chunk import (chunk_outputs_plain,
                                                 chunk_states_plain,
                                                 mlstm_outputs_cuda,
                                                 mlstm_states_cuda)

    q, k, v, ig, fg = args
    states, final = mlstm_states_cuda(k, v, ig, fg, state_in)
    y = mlstm_outputs_cuda(q, k, v, ig, fg, states)
    torch.cuda.synchronize()
    want_states, want_final = chunk_states_plain(*args, state_in)
    errs = [_max_err(g.float(), w, tol, f"{label}/states/{key}")
            for g, w, key in zip((*states, *final),
                                 (*want_states, *want_final),
                                 ("C_c", "n_c", "m_c", "C", "n", "m"))]
    y_err = _max_err(y, chunk_outputs_plain(*args, states), tol,
                     f"{label}/outputs/y")
    calls = {"mlstm_states_kernel": (
                 lambda: mlstm_states_cuda(k, v, ig, fg, state_in),
                 lambda: chunk_states_plain(*args, state_in), errs),
             "mlstm_outputs_kernel": (
                 lambda: mlstm_outputs_cuda(q, k, v, ig, fg, states),
                 lambda: chunk_outputs_plain(*args, states), [y_err])}
    return [{"name": name, "max_abs_err": err, "ms": device_ms(kern),
             "profiler_ms": kernel_profiler_ms(kern, name, names=(name,),
                                               min_records=1),
             "plain_ms": event_ms(plain)}
            for name, (kern, plain, err) in calls.items()]


# ---------------------------------------------------------------------------
# One seed, the same draws on every device (the port's own generators).
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, list):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _episode(res: dict, i: int | None = None) -> dict:
    """One episode of run_scan's (i None) or run_batch's (seed i) result in
    compare_episodes' form."""
    if i is None:
        return res
    done = res["history"]["all_done"][i]
    periods = int(np.argmax(done)) + 1 if done.any() else len(done)
    return {"periods": periods, "finished": bool(res["finished"][i]),
            "fallbacks": int(res["fallbacks"][i]),
            "durations": res["durations"][i].tolist(),
            "history": {key: res["history"][key][i][:periods]
                        for key in ("b", "f", "rounds")}}


def seeded_draws_phase() -> dict:
    """The card and the CPU draw the same for one seed: run_scan at the
    paper's setting and a run_batch seed with gauss_markov / gilbert /
    mmpp, warm coop on "reference" on both devices (durations equal, with
    compare_episodes' one straddle exception); XLSTMLM.init and
    CausalLM.init at reduced width bitwise equal on both; serve's prompts
    for one seed equal on both.  Also the seconds of the full-width init
    of each model on the card (every weight drawn on the CPU, then
    copied), and the host's milliseconds per market-scale period of draws
    (on the CPU alone, on one intra-op thread, and with the copy to the
    card), with the CPU's time per operator from the profiler."""
    from repro_torch import configs, scenarios
    from repro_torch.fl import simulator
    from repro_torch.launch import serve
    from repro_torch.models import registry

    out = {"episodes": []}
    warm = dict(policy="coop", warm_start=True, intra_backend="reference",
                collect_alloc=True)
    scan_cfg = simulator.SimConfig(**PAPER, **warm, seed=SEEDED_SEED)
    batch_cfg = simulator.SimConfig(
        **PAPER, **warm, channel_process=scenarios.spec("gauss_markov"),
        churn_process=scenarios.spec("gilbert"), arrival_process="mmpp")
    period_s = simulator._default_net(scan_cfg).period_s
    runs = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        scan = simulator.run_scan(scan_cfg, device=dev)
        t1 = time.perf_counter()
        batch = simulator.run_batch(batch_cfg, [SEEDED_SEED], device=dev)
        runs[dev] = (scan, batch, t1 - t0, time.perf_counter() - t1)
    (scan, batch, scan_s, batch_s), (rscan, rbatch, rscan_s, rbatch_s) = (
        runs[DEVICE], runs["cpu"])
    for label, got, want, sec, rsec in (
            ("run_scan", _episode(scan), _episode(rscan), scan_s, rscan_s),
            ("run_batch-gauss_markov-gilbert-mmpp", _episode(batch, 0),
             _episode(rbatch, 0), batch_s, rbatch_s)):
        row = {"case": f"{label}/seed {SEEDED_SEED}",
               "periods": got["periods"], "card_s": sec, "cpu_s": rsec,
               "durations_equal": got["durations"] == want["durations"],
               **compare_episodes(f"{label} card vs cpu", got, want,
                                  period_s, must_finish=True)}
        out["episodes"].append(row)

    equal = {}
    for arch in (XLSTM_SERVE["arch"], SERVE["arch"]):
        model = registry.build_model(configs.get_smoke_config(arch))
        cpu, card = model.init(0, device="cpu"), model.init(0, device=DEVICE)
        pairs = list(zip(_leaves(cpu), _leaves(card)))
        if not all(c.device.type == "cpu"
                   and g.device.type == torch.device(DEVICE).type
                   and torch.equal(c, g.cpu()) for c, g in pairs):
            raise AssertionError(f"{arch}: init(0) differs between the card "
                                 f"and the CPU")
        equal[arch] = len(pairs)
    argv = ["--batch", "2", "--prompt-len", "16", "--gen", "4",
            "--temperature", "1.0"]
    served = {dev: serve.main(argv + ["--device", dev])
              for dev in (DEVICE, "cpu")}
    if not torch.equal(served[DEVICE]["prompts"].cpu(),
                       served["cpu"]["prompts"]):
        raise AssertionError("serve: one seed gave other prompts on the card")
    out["init_tensors_equal"] = equal
    out["serve_prompts_equal"] = True
    out["serve_tokens_equal"] = bool(torch.equal(
        served[DEVICE]["tokens"].cpu(), served["cpu"]["tokens"]))

    # the host's share of a market-scale period: its draws, then the copy
    market = simulator.SimConfig(n_services_total=MARKET_N)
    market_net = simulator._default_net(market)
    _, market_counts = simulator._static_draws(market, market_net)
    draw_ms = {}
    threads = torch.get_num_threads()
    for label, dev, n_threads in (("cpu", "cpu", threads),
                                  ("cpu_one_thread", "cpu", 1),
                                  (DEVICE, DEVICE, threads)):
        torch.set_num_threads(n_threads)
        sampler = simulator.default_sampler(market, market_net, market_counts,
                                            dev)
        sampler(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for period in range(1, 6):
            sampler(period)
        torch.cuda.synchronize()
        draw_ms[label] = 1e3 * (time.perf_counter() - t0) / 5
    torch.set_num_threads(threads)
    # where the CPU's share goes: per operator, its calls and self time a
    # period; the rest (seeding the generator, Python) outside any operator
    sampler = simulator.default_sampler(market, market_net, market_counts,
                                        "cpu")
    for periods in (range(1), range(1, 6)):  # the first starts the profiler
        t0 = time.perf_counter()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for period in periods:
                sampler(period)
        wall_ms = 1e3 * (time.perf_counter() - t0) / len(periods)
    per_op = {e.key: {"calls": e.count / 5,
                      "ms": e.self_cpu_time_total / 1e3 / 5}
              for e in prof.key_averages() if e.self_cpu_time_total > 0}
    out["market_period_draws_ms"] = {
        "draw_on_cpu": draw_ms["cpu"], "intra_op_threads": threads,
        "draw_on_cpu_one_thread": draw_ms["cpu_one_thread"],
        "draw_and_copy_to_card": draw_ms[DEVICE],
        "profiled_on_cpu": wall_ms,
        "outside_operators": wall_ms - sum(v["ms"] for v in per_op.values()),
        "per_operator": per_op}

    init_s = {}
    for arch in (XLSTM_SERVE["arch"], SERVE["arch"]):
        model = registry.build_model(configs.get_config(arch))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = model.init(0, device=DEVICE)
        torch.cuda.synchronize()
        init_s[arch] = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
    out["full_init_s"] = init_s
    emit({"phase": "seeded_draws", **out})
    return out


def _mlstm_layers(arch: str) -> int:
    from repro_torch import configs
    from repro_torch.models import registry

    n_super, n_m = registry.build_model(configs.get_config(arch))._layout
    return n_super * n_m


def xlstm_serve_phase() -> dict:
    """Full-width xlstm-1.3b in bfloat16 served through the port's entry
    point (batch 4, prompt 2048, 32 greedy tokens, after a short warm-up),
    then one no-cache forward of the same prompts; each is a main path
    counted from 0 (checked by main).  The forward's last logits must
    agree with the prefill's within bf16 tolerance."""
    from repro_torch.launch import serve

    cfg_s = XLSTM_SERVE
    argv = ["--arch", cfg_s["arch"], "--no-reduced", "--batch",
            str(cfg_s["batch"]), "--temperature", "0", "--device", DEVICE]
    serve.main(argv + ["--prompt-len", str(cfg_s["warmup_prompt_len"]),
                       "--gen", "2"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = drive_path("xlstm_serve", lambda: serve.main(
        argv + ["--prompt-len", str(cfg_s["prompt_len"]),
                "--gen", str(cfg_s["gen"])]), keep=True)
    wall = time.perf_counter() - t0
    out, info = res["tokens"], res["info"]
    b, gen = cfg_s["batch"], cfg_s["gen"]
    want_len = cfg_s["prompt_len"] + gen - 1
    if out.shape != (b, gen) or info["cache"]["len"] != want_len:
        raise AssertionError(f"xlstm serve: tokens {tuple(out.shape)}, cache "
                             f"len {info['cache']['len']}, expected "
                             f"({b}, {gen}) and {want_len}")
    if not bool(torch.isfinite(info["logits"]).all()):
        raise AssertionError("xlstm serve: non-finite logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model, params = res["model"], res["params"]
    profile = decode_profile(model, params, info["cache"], out[:, -1:])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = drive_path("xlstm_forward", lambda: model.forward(
        params, res["prompts"], logits_mode="last"), keep=True)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    dev = _max_err(logits, info["prefill_logits"], MLSTM_TOL[torch.bfloat16],
                   "xlstm no-cache forward vs prefill")
    row = {"arch": cfg_s["arch"], "batch": b,
           "prompt_len": cfg_s["prompt_len"], "gen": gen, "dtype": "bfloat16",
           "prefill_s": info["t_prefill"],
           "decode_steps": info["decode_steps"], "decode_s": info["t_decode"],
           "decode_ms_per_step": 1e3 * info["t_decode"] / info["decode_steps"],
           "decode_tokens_per_s": b * info["decode_steps"] / info["t_decode"],
           "prefill_tokens_per_s": b * cfg_s["prompt_len"] / info["t_prefill"],
           "wall_s_with_init": wall, "cache_len": info["cache"]["len"],
           "peak_mem_gb": peak_gb, "no_cache_forward_s": forward_s,
           "forward_vs_prefill_max_dev": dev,
           "block_s": block_times(model, params, res["prompts"]),
           "decode_step_profile": profile}
    emit({"phase": "xlstm_serve", **row})
    return row


def block_times(model, params, prompts) -> dict:
    """Wall seconds of one mLSTM block and one sLSTM block over the whole
    prompt (host clock around synchronized work, median of 3), to split
    the prefill between the two; informational."""
    from repro_torch.models import xlstm

    cfg = model.cfg
    x = params["embed"][prompts].to(cfg.compute_dtype)
    blocks = {"mlstm": lambda: xlstm.apply_mlstm_block(
                  params["m_blocks"][0][0], cfg, x),
              "slstm": lambda: xlstm.apply_slstm_block(
                  params["s_blocks"][0], cfg, x)}
    out = {}
    for name, fn in blocks.items():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = float(np.median(times))
    return out


def xlstm_parity_phase() -> dict:
    """Full-width xlstm-1.3b in float32 cut in depth to one super-block
    (7 mLSTM + 1 sLSTM), card against CPU."""
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(XLSTM_SERVE["arch"]),
                              n_layers=XLSTM_PARITY["n_layers"],
                              dtype="float32")
    row = lockstep_parity("xlstm parity", cfg, XLSTM_PARITY["batch"],
                          XLSTM_PARITY["prompt_len"], XLSTM_PARITY["gen"])
    emit({"phase": "xlstm_parity", **row})
    return row


def _to_device(tree):
    if isinstance(tree, list):
        return [_to_device(x) for x in tree]
    if isinstance(tree, dict):
        return {key: _to_device(x) for key, x in tree.items()}
    return tree.to(DEVICE)


def card_info() -> tuple[str, str]:
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return kind, smi


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    LOG.parent.mkdir(exist_ok=True)
    LOG.write_text("")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, smi = card_info()
    emit({"phase": "card", "name": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    clock = {"start": time.perf_counter()}
    emit({"phase": "build", "seconds": _build.build()})
    clock["build"] = time.perf_counter()

    # --- the port's seeded draws: the same on the card and the CPU --------
    seeded_draws_phase()
    clock["seeded_draws"] = time.perf_counter()

    # --- slice 4 first: B7, then the xLSTM serve path and its parity -------
    mlstm = mlstm_phase()
    clock["mlstm_kernel"] = time.perf_counter()
    xlstm_serve_phase()
    m_layers = _mlstm_layers(XLSTM_SERVE["arch"])
    for path in ("xlstm_serve", "xlstm_forward"):
        expected = {name: 0 for name in KERNELS}
        expected["mlstm_chunk"] = m_layers
        if PATH_LAUNCHES[path] != expected:
            raise AssertionError(f"{path} launched {PATH_LAUNCHES[path]}, "
                                 f"expected {expected}")
    clock["xlstm_serve"] = time.perf_counter()
    xlstm_parity_phase()
    clock["xlstm_parity"] = time.perf_counter()

    per_shape = {(n, k): kernel_phase(n, k, m) for n, k, m in KERNEL_SHAPES}
    b12_parts()
    b3_parts()
    b4_parts()
    edge_matrix_phase()
    clock["allocation_kernels"] = time.perf_counter()
    attention = attention_phase()
    clock["attention_kernels"] = time.perf_counter()

    # --- the gemma3-1b serve path ------------------------------------------
    serve_phase()
    from repro_torch import configs
    n_layers = configs.get_config(SERVE["arch"]).n_layers
    expected = {name: 0 for name in KERNELS}
    expected.update(flash_attention=n_layers,
                    decode_attention=n_layers * (SERVE["gen"] - 1))
    if PATH_LAUNCHES["serve"] != expected:
        raise AssertionError(f"serve launched {PATH_LAUNCHES['serve']}, "
                             f"expected {expected}")
    clock["serve"] = time.perf_counter()
    parity_phase()
    clock["parity"] = time.perf_counter()

    paths = {"xlstm_serve": PATH_LAUNCHES["xlstm_serve"],
             "xlstm_forward": PATH_LAUNCHES["xlstm_forward"],
             "serve": PATH_LAUNCHES["serve"],
             "slice1": drive_path("slice1", path_slice1),
             "selfish": drive_path("selfish", path_selfish),
             "run_batch": drive_path("run_batch", batch_pair)}
    clock["allocation_paths"] = time.perf_counter()
    paths["cotrain"] = drive_path("cotrain", cotrain_phase)
    clock["cotrain"] = time.perf_counter()
    paths["allocd"] = drive_path("allocd", allocd_phase)
    clock["allocd"] = time.perf_counter()
    launches = {name: sum(p[name] for p in paths.values()) for name in KERNELS}
    emit({"phase": "launches", "launches": launches, "per_path": paths})
    missing = [name for name, count in launches.items() if count < 1]
    if missing:
        raise AssertionError(f"main paths never launched {missing}")
    for path, kernels in (("cotrain", COTRAIN_KERNELS),
                          ("allocd", ALLOCD_KERNELS)):
        missing = [name for name in kernels if not PATH_LAUNCHES[path][name]]
        if missing:
            raise AssertionError(f"the {path} path never launched "
                                 f"{missing}")
    draw_samplers()        # after the paths: its episodes count in no path
    clock["draw_samplers"] = time.perf_counter()

    auction_phase()
    clock["auction"] = time.perf_counter()
    lost = np.array([w[1:] for w in FILLERS_LOST]).reshape(-1, 2)
    emit({"phase": "profiler_windows", "windows": len(lost),
          "fillers": FILLERS,
          "lost_at_start": {int(k): int(v) for k, v in
                            zip(*np.unique(lost[:, 0], return_counts=True))},
          "lost_at_end": {int(k): int(v) for k, v in
                          zip(*np.unique(lost[:, 1], return_counts=True))},
          "most_lost": max(FILLERS_LOST, key=lambda w: w[1], default=None)})
    marks = list(clock.items())
    emit({"phase": "seconds", **{name: t - marks[i][1]
                                 for i, (name, t) in enumerate(marks[1:])}})

    rows = dict(per_shape[KERNEL_SHAPES[0][:2]])
    errors = {name: max(per_shape[s][name]["max_abs_err"] for s in per_shape)
              for name in rows}
    for name in ("bisect_alloc", "dual_demand"):   # where their launches are
        rows[name] = per_shape[MAIN_PATH_SHAPE][name]
    for name in ("flash_attention", "decode_attention"):
        rows[name] = attention[name, MAIN_CASE, torch.bfloat16]
        errors[name] = max(row["max_abs_err"] for key, row in attention.items()
                           if key[0] == name)
    rows["mlstm_chunk"] = mlstm["serve", torch.bfloat16]
    errors["mlstm_chunk"] = max(row["max_abs_err"] for row in mlstm.values())
    print(smi, flush=True)
    # B7 is one row: one call (one launch count) runs its two bf16 kernels,
    # listed under "parts" with their own times.
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/csrc/{name}.cu", "replaces": where,
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": rows[name]["ms"], "profiler_ms": rows[name]["profiler_ms"],
         "wrapper_ms": rows[name]["wrapper_ms"],
         "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name].get("library_ms"),
         **({"parts": rows[name]["kernels"]} if "kernels" in rows[name]
            else {})}
        for name, where in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
