"""The spread of the port's own-draw durations against the reference's.

Queue C4 of ROADMAP.md: each package runs ``es`` on ``reference`` at the
paper's default ``SimConfig`` with its own draws for seeds 0 .. S-1, and
the per-seed ``avg_duration`` samples are compared as distributions (the
two RNG streams cannot be compared draw for draw): the variance ratio
port / reference with its 95% interval (F distribution, and a bootstrap
over seeds), Levene's test (median-centred), and a two-sample
Kolmogorov-Smirnov test.  Both sides run on the CPU.

    PYTHONPATH=src python tests/torch_duration_spread.py --seeds 1024 \\
        --workers 4 --out build/duration_spread.json

Not collected by pytest (about ten minutes at 1024 seeds on four cores).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import time

import numpy as np

CHUNK = 64  # seeds per run_batch call


def _port_chunk(seeds: list[int]) -> list[float]:
    import torch

    from repro_torch.fl import simulator

    torch.set_num_threads(1)
    cfg = simulator.SimConfig(policy="es", collect_history=False)
    return simulator.run_batch(cfg, seeds, device="cpu")[
        "avg_duration"].tolist()


def _reference_chunk(seeds: list[int]) -> list[float]:
    from repro.fl import simulator

    cfg = simulator.SimConfig(policy="es", collect_history=False)
    return np.asarray(simulator.run_batch(cfg, seeds)["avg_duration"]
                      ).tolist()


def _run(fn, seeds: list[int], workers: int) -> np.ndarray:
    chunks = [seeds[i:i + CHUNK] for i in range(0, len(seeds), CHUNK)]
    with mp.get_context("spawn").Pool(workers) as pool:
        parts = pool.map(fn, chunks)
    return np.array([x for part in parts for x in part], np.float64)


def spread_stats(port: np.ndarray, ref: np.ndarray, boot: int = 10000,
                 seed: int = 0) -> dict:
    """Variance ratio port / reference with its 95% intervals, Levene's
    and the two-sample KS test."""
    from scipy import stats

    ratio = float(np.var(port, ddof=1) / np.var(ref, ddof=1))
    d1, d2 = len(port) - 1, len(ref) - 1
    f_ci = [ratio / float(stats.f.ppf(0.975, d1, d2)),
            ratio / float(stats.f.ppf(0.025, d1, d2))]
    rng = np.random.default_rng(seed)
    ratios = [np.var(rng.choice(port, len(port)), ddof=1)
              / np.var(rng.choice(ref, len(ref)), ddof=1)
              for _ in range(boot)]
    ks = stats.ks_2samp(port, ref)
    return {"seeds": [len(port), len(ref)],
            "mean": [float(port.mean()), float(ref.mean())],
            "sd": [float(port.std(ddof=1)), float(ref.std(ddof=1))],
            "variance_ratio": ratio, "f_interval_95": f_ci,
            "bootstrap_interval_95": [float(np.quantile(ratios, 0.025)),
                                      float(np.quantile(ratios, 0.975))],
            "levene_p": float(stats.levene(port, ref, center="median").pvalue),
            "ks_statistic": float(ks.statistic), "ks_p": float(ks.pvalue)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=1024)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    seeds = list(range(args.seeds))
    t0 = time.perf_counter()
    port = _run(_port_chunk, seeds, args.workers)
    t1 = time.perf_counter()
    ref = _run(_reference_chunk, seeds, args.workers)
    out = {**spread_stats(port, ref), "port_s": t1 - t0,
           "reference_s": time.perf_counter() - t1,
           "port_avg_duration": port.tolist(),
           "reference_avg_duration": ref.tolist()}
    summary = {k: v for k, v in out.items() if not k.endswith("duration")}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
