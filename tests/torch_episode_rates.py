#!/usr/bin/env python3
"""Periods per second of the allocation episodes that launch B1
(``bisect_alloc``), B2 (``dual_demand``) and B3 (``market_clear``), for
one or more checkouts of the repo, so two versions compare within one
call on one card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tests/torch_episode_rates.py --roots OLD . . OLD [--reps 5]

Each root (a directory holding the repo's ``src/``) runs in a process of
its own, in the order given (old, new, new, old spreads the host's drift
over both).  A process drives ``chip_smoke.py``'s paper-setting episodes
on the kernel backend "pallas" (SimConfig defaults: 10 services, K = 45):
warm ``coop`` (B2 seven times a period, B1 once), ``es``, ``pp`` and
``selfish`` (B1 once a period), and warm ``coop`` on "megakernel" (B3
once a period), each once untimed (the kernels' build and first calls),
then ``--reps`` rounds of all five in turn.  Per root and
case: periods/s of every rep and their median, the average duration, and
the kernels launched in one episode.  Per case over the roots: the
median of each root's medians, and whether every root's durations agree.

``--cotrain`` drives ``chip_smoke.py``'s co-trained episodes instead
(phase 7d: BENCH_cotrain's setting, ``run_cotrain_scan`` of warm
``coop`` on "megakernel" and on "pallas", ``es``, ``pp`` and ``selfish``
on "pallas"), with the settings of this script's own checkout.

Prints one JSON object (also written to ``--out``).  ``--device cpu``
runs it on the CPU (the kernels' plain versions) as a rehearsal.  A
script, not a test: pytest does not collect it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CASES = {"coop-warm": dict(policy="coop", warm_start=True),
         "es": dict(policy="es"), "pp": dict(policy="pp"),
         "selfish": dict(policy="selfish"),
         "coop-warm-megakernel": dict(policy="coop", warm_start=True,
                                      intra_backend="megakernel")}
COTRAIN_CASES = {"coop-warm-megakernel": dict(policy="coop", warm_start=True,
                                              intra_backend="megakernel"),
                 "coop-warm": dict(policy="coop", warm_start=True),
                 "es": dict(policy="es"), "pp": dict(policy="pp"),
                 "selfish": dict(policy="selfish")}


def worker(root: Path, reps: int, device: str, cotrain: bool) -> dict:
    """The episodes of CASES (COTRAIN_CASES) from ``root``'s ``src/``, in
    this process."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.fl import cotrain as co
    from repro_torch.fl import simulator
    from repro_torch.kernels import ops

    if cotrain:   # repro_torch is bound to root's src/ before this import
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        import chip_smoke
        base, net, train = chip_smoke.cotrain_setting()

    def episode(kw: dict) -> tuple[float, dict, dict]:
        before = dict(ops.LAUNCHES)
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cotrain:
            cfg = simulator.SimConfig(**{**base, "intra_backend": "pallas",
                                         **kw})
            res = co.run_cotrain_scan(cfg, train, net, device=device)
        else:
            cfg = simulator.SimConfig(**{"intra_backend": "pallas", **kw})
            res = simulator.run_scan(cfg, simulator._default_net(cfg),
                                     device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        return (res["periods"] / sec, res,
                {k: v - before[k] for k, v in ops.LAUNCHES.items()
                 if v != before[k]})

    cases = COTRAIN_CASES if cotrain else CASES
    out = {}
    for name, kw in cases.items():
        _, res, launches = episode(kw)
        out[name] = {"rates": [], "avg_duration": float(res["avg_duration"]),
                     "periods": int(res["periods"]), "launches": launches}
    for _ in range(reps):
        for name, kw in cases.items():
            rate, res, _ = episode(kw)
            out[name]["rates"].append(rate)
            if float(res["avg_duration"]) != out[name]["avg_duration"]:
                raise AssertionError(f"{name}: a repeat changed the "
                                     f"average duration")
    for row in out.values():
        row["median"] = statistics.median(row["rates"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cotrain", action="store_true")
    ap.add_argument("--out", default="build/episode_rates.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(Path(args.worker).resolve(), args.reps,
                                args.device, args.cotrain)))
        return 0
    if args.device != "cpu":
        import torch
        if not torch.cuda.is_available():
            print("torch_episode_rates: no CUDA device", file=sys.stderr)
            return 1
    runs = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", root, "--reps",
             str(args.reps), "--device", args.device,
             *(["--cotrain"] if args.cotrain else [])],
            capture_output=True, text=True, check=False)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        runs.append({"root": root,
                     "cases": json.loads(proc.stdout.splitlines()[-1])})
    summary = {}
    for name in (COTRAIN_CASES if args.cotrain else CASES):
        per_root = {}
        for run in runs:
            per_root.setdefault(run["root"], []).append(
                run["cases"][name]["median"])
        durations = {run["cases"][name]["avg_duration"] for run in runs}
        summary[name] = {"median_by_root": {r: statistics.median(v)
                                            for r, v in per_root.items()},
                         "durations_agree": len(durations) == 1}
    result = {"roots": args.roots, "reps": args.reps,
              "cotrain": args.cotrain, "runs": runs,
              "summary": summary}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
