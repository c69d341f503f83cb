#!/usr/bin/env python3
"""Drive the PyTorch port's allocation path on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:

1. the card: its name, and name and power limit from nvidia-smi;
2. build the CUDA kernels from src/repro_torch/csrc (seconds printed);
3. every kernel against its plain PyTorch version on the card, at the
   market shape (N = 8192 services, K = 32 clients, first 10% inactive,
   sample_services on a generator seeded 5, warm seed = cold price x 1.03)
   and a ragged shape (N = 8191, K = 45): largest deviation per output
   (tolerances below), that every split row sums to its b, the kernel's
   device time (CUDA events around one call queued behind a device sleep,
   so the host's launch path is hidden; median of 21) with the profiler's
   mean as a cross-check, the wrapper's and the plain version's time per
   call (CUDA events, median of 21 calls, host launch path included), the
   launches this phase made, and the bound (the larger of float32
   operations over 67 TFLOP/s and bytes over 3.35 TB/s, counting about 5
   operations per valid (row, client, trip));
4. run_scan episodes at the paper's setting (SimConfig defaults), each with
   a kernel backend and with "reference" on one sampler stream: per-period
   rounds and durations equal (see compare_episodes for the one allowed
   exception), per-period b and f within tolerance, no solver rescue, and
   the kernels each backend launched (none for "reference");
5. one market-scale episode: 8192 services all arriving at period 0 with
   the paper's 1 MHz per service (B = 8192 MHz) and 100 rounds to finish,
   so rounds per period are nonzero and durations differ between
   services; warm coop on "megakernel" against "reference";
6. the kernels line: per kernel, its launches during phases 4-5 (counts
   reset just before phase 4), its deviation, times and bound.

Tolerances are rtol and atol as in the CPU tests, but atol is never more
than 1e-3 of the mean |value| of the output checked: at the market shape b
is about 1e-3 and a client's split about 5e-5, where a fixed atol would
check nothing.

The last line is {"ok": true, "device": {...}}.  The script needs a CUDA
card and the repository's src/ beside it, and fails without either.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

B_TOTAL = 10.0
PEAK_F32_OPS = 67e12      # H100 SXM float32 outside the tensor cores, op/s
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s
OPS_PER_CLIENT_TRIP = 5
TOL = {"t_star": (1e-4, 0.0), "split": (1e-3, 1e-4), "b": (1e-3, 1e-4),
       "slope": (1e-3, 1e-4), "f": (1e-3, 1e-5), "lam": (1e-4, 0.0),
       "split_sum": (1e-5, 0.0)}
ATOL_OF_MEAN = 1e-3      # atol <= this fraction of the output's mean |value|
SLEEP_CYCLES = 2_000_000  # device sleep queued ahead of a timed kernel call
KERNELS = {
    "bisect_alloc": "src/repro/kernels/bisect_alloc.py:29",
    "dual_demand": "src/repro/kernels/dual_demand.py:94",
    "market_clear": "src/repro/kernels/market_clear.py:86",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def kernel_profiler_ms(fn, kernel: str, reps: int = 21) -> float:
    """Mean device time of the CUDA kernel whose name contains ``kernel``
    over ``reps`` calls, from the profiler's CUDA activity records."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if f"{kernel}_kernel" in e.key]
    # The activity buffer may drop a record; average over those it kept.
    if len(rows) != 1 or not reps // 2 <= rows[0].count <= reps:
        raise AssertionError(f"profiler saw {[(e.key, e.count) for e in rows]}"
                             f" for {kernel}, expected {reps} launches")
    return rows[0].device_time_total / rows[0].count / 1e3


def check_close(name: str, got, want, key: str) -> dict:
    """Raise unless |got - want| <= atol + rtol |want| everywhere, with
    atol no more than ATOL_OF_MEAN of mean |want|; returns the largest
    absolute deviation and the tolerance applied."""
    rtol, atol = TOL[key]
    got = np.asarray(got.detach().double().cpu().numpy()
                     if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want.detach().double().cpu().numpy()
                      if torch.is_tensor(want) else want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}/{key}: shape {got.shape} vs "
                             f"{want.shape} or non-finite values")
    if want.size:
        atol = min(atol, ATOL_OF_MEAN * float(np.mean(np.abs(want))))
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    if bad.any():
        raise AssertionError(f"{name}/{key}: {int(bad.sum())} entries beyond "
                             f"rtol {rtol} atol {atol}; max dev {err.max()}")
    return {"max_dev": float(err.max()) if err.size else 0.0,
            "rtol": rtol, "atol": atol}


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def market(n: int, k: int):
    from repro_torch.core import network
    from repro_torch.core.types import mask_inactive

    gen = torch.Generator(device="cuda").manual_seed(5)
    svc, _ = network.sample_services(gen, n, k_max=k)
    n_off = max(1, round(n * 0.1))
    return mask_inactive(svc, torch.arange(n, device="cuda") >= n_off)


def kernel_phase(n: int, k: int) -> dict:
    """Phase 3 at one shape: every kernel against its plain version."""
    from repro_torch.core import disba
    from repro_torch.kernels import ops
    from repro_torch.kernels.bisect_alloc import bisect_alloc_plain
    from repro_torch.kernels.dual_demand import dual_demand_plain
    from repro_torch.kernels.market_clear import market_clear_plain

    svc = market(n, k)
    a, t = svc.alpha, svc.t_comp
    cold = disba.solve_lambda_newton(svc, B_TOTAL)
    lam_prev = cold.lam * 1.03
    b = cold.b.contiguous()
    valid = float((a > 0).sum())        # (row, client) pairs with work
    nk = float(n * k)
    trips_mc = 6 * disba.WARM_INNER_ITERS + 2 * 48
    cases = {
        "bisect_alloc": (
            lambda: ops.intra_allocate(a, t, b),
            lambda: bisect_alloc_plain(a, t, b),
            ("t_star", "split"),
            valid * 48, 4 * (2 * nk + n) + 4 * (n + nk)),
        "dual_demand": (
            lambda: ops.dual_demand(a, t, lam_prev, iters=disba.WARM_INNER_ITERS),
            lambda: dual_demand_plain(a, t, lam_prev, disba.WARM_INNER_ITERS),
            ("b", "slope"),
            valid * disba.WARM_INNER_ITERS, 4 * (2 * nk + 1) + 4 * 2 * n),
        "market_clear": (
            lambda: ops.market_clear(a, t, B_TOTAL, lam_prev),
            lambda: market_clear_plain(a, t, B_TOTAL, lam_prev),
            ("b", "f", "lam"),
            valid * trips_mc, 4 * (2 * nk + 2) + 4 * (2 * n + 1)),
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
        if name == "market_clear":
            checks["b_total"] = check_close(tag, got[0].sum(),
                                            torch.tensor(B_TOTAL), "b")
        bound_ms, bound_by = bound(OPS_PER_CLIENT_TRIP * work, nbytes)
        row = {"name": name, "n": n, "k": k,
               "max_abs_err": max(checks[key]["max_dev"] for key in keys),
               "checks": checks,
               "ms": device_ms(kern),
               "profiler_ms": kernel_profiler_ms(kern, name),
               "wrapper_ms": event_ms(kern), "plain_ms": event_ms(plain),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "launches": ops.LAUNCHES[name] - launches_before}
        emit({"phase": "kernel_vs_plain", **row})
        out[name] = row
    return out


def compare_episodes(name: str, got: dict, want: dict, period_s: float,
                     must_finish: bool) -> dict:
    """Hold a kernel-backend episode to the reference one.

    Rounds per period (floor(f T)) and durations must be equal, with one
    exception: where the two runs' f, already within tolerance, lie on
    either side of an integer of rounds, floor(f T) may differ by one
    (float32 f from two summation orders), and then that service's
    duration may differ by one.  Every such flip is reported."""
    if got["periods"] != want["periods"] or (
            must_finish and not (got["finished"] and want["finished"])):
        raise AssertionError(f"{name}: episodes ran {got['periods']} and "
                             f"{want['periods']} periods, finished "
                             f"{got['finished']} and {want['finished']}")
    if got["fallbacks"] or want["fallbacks"]:
        raise AssertionError(f"{name}: the warm solver's rescue ran "
                             f"{got['fallbacks']} and {want['fallbacks']} "
                             f"times")
    dev = {key: check_close(name, got["history"][key], want["history"][key],
                            key) for key in ("b", "f")}
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
    d_got, d_want = got["durations"], want["durations"]
    bad = [i for i, (x, y) in enumerate(zip(d_got, d_want))
           if x != y and not (i in flipped and abs(x - y) == 1)]
    if bad:
        raise AssertionError(f"{name}: durations differ for services {bad}")
    return {"max_dev_b": dev["b"]["max_dev"], "atol_b": dev["b"]["atol"],
            "max_dev_f": dev["f"]["max_dev"], "atol_f": dev["f"]["atol"],
            "rounds_per_period_max": int(r_want.max()),
            "durations_min_max": [min(d_want), max(d_want)],
            "round_flips": [{"period": int(p), "service": int(v),
                             "fT_kernel": float(f_got[p, v]),
                             "fT_reference": float(f_want[p, v])}
                            for p, v in flips]}


# Kernels each kernel backend must launch in an episode of each policy.
EXPECTED = {("coop", True, "megakernel"): ("market_clear",),
            ("coop", True, "pallas"): ("dual_demand", "bisect_alloc"),
            ("coop", False, "pallas"): ("bisect_alloc",),
            ("es", False, "pallas"): ("bisect_alloc",),
            ("pp", False, "pallas"): ("bisect_alloc",),
            ("ec", False, "pallas"): ()}


def run_pair(cfg_kw: dict, label: str, must_finish: bool = True,
             net=None, arrivals=None, counts=None) -> dict:
    """One episode with the kernel backend, one with "reference", on the
    same sampler stream; each run's kernel launches are counted."""
    from repro_torch.fl import simulator
    from repro_torch.kernels import ops

    backend = cfg_kw["intra_backend"]
    runs = {}
    for bk in (backend, "reference"):
        cfg = simulator.SimConfig(**{**cfg_kw, "intra_backend": bk},
                                  collect_alloc=True)
        net = net or simulator._default_net(cfg)
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        res = simulator.run_scan(cfg, net, arrivals=arrivals, counts=counts,
                                 device="cuda")
        sec = time.perf_counter() - t0
        runs[bk] = (res, sec, {name: ops.LAUNCHES[name] - before[name]
                               for name in ops.LAUNCHES})
    (kres, ksec, klaunch), (rres, rsec, rlaunch) = runs[backend], runs["reference"]
    if any(rlaunch.values()):
        raise AssertionError(f"{label}: the reference run launched {rlaunch}")
    key = (cfg_kw["policy"], cfg_kw["warm_start"], backend)
    missing = [name for name in EXPECTED[key] if not klaunch[name]]
    if missing:
        raise AssertionError(f"{label}: the {backend} run never launched "
                             f"{missing} ({klaunch})")
    row = {"case": label, "periods": kres["periods"],
           "kernel_s": ksec, "reference_s": rsec,
           "kernel_periods_per_s": kres["periods"] / ksec,
           "reference_periods_per_s": rres["periods"] / rsec,
           "avg_duration": kres["avg_duration"], "launches": klaunch,
           **compare_episodes(label, kres, rres, net.period_s, must_finish)}
    emit({"phase": "episode", **row})
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.fl import simulator
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit({"phase": "card", "name": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    emit({"phase": "build", "seconds": _build.build()})

    per_shape = {(n, k): kernel_phase(n, k)
                 for n, k in ((8192, 32), (8191, 45))}

    # --- the main path: episodes through the entry points a user calls ----
    ops.reset_launches()
    for pol, warm, backend in EXPECTED:
        run_pair(dict(policy=pol, warm_start=warm, intra_backend=backend),
                 f"{pol}{'-warm' if warm else ''}-{backend}")

    # Market scale: every service arrives at period 0 and gets the paper's
    # share of 1 MHz (B = 10 MHz over 10 services), so each runs several
    # rounds per period; 100 rounds (not 2000) let services finish, at
    # different periods, within the 10-period episode.
    market_kw = dict(n_services_total=8192, max_periods=10,
                     rounds_required=100)
    cfg = simulator.SimConfig(**market_kw)
    net = simulator._default_net(cfg)
    net = dataclasses.replace(net, total_bandwidth_mhz=(
        net.total_bandwidth_mhz * cfg.n_services_total
        / simulator.SimConfig().n_services_total))
    _, counts = simulator._static_draws(cfg, net)
    run_pair(dict(policy="coop", warm_start=True, intra_backend="megakernel",
                  **market_kw),
             "coop-warm-megakernel-market8192", must_finish=False, net=net,
             arrivals=np.zeros(cfg.n_services_total, np.int64), counts=counts)
    launches = dict(ops.LAUNCHES)
    emit({"phase": "launches", "launches": launches})
    missing = [name for name, count in launches.items() if count < 1]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    rows = per_shape[(8192, 32)]
    print(smi, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/csrc/{name}.cu", "replaces": where,
         "launches": launches[name],
         "max_abs_err": max(per_shape[s][name]["max_abs_err"]
                            for s in per_shape),
         "ms": rows[name]["ms"], "wrapper_ms": rows[name]["wrapper_ms"],
         "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"], "library_ms": None}
        for name, where in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
