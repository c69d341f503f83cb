#!/usr/bin/env python3
"""Where the market-scale episode's host time goes: its per-period draws.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tests/torch_host_draws.py [--out build/host_draws.json]

Measures, in one process (host rates vary between runs, so compare only
numbers of one run):

1. a market period's raw service draws (8192 services x 45 clients,
   ``simulator._raw_draws``) on one host thread, and 12 periods' on 2, 4
   and 6 threads, each thread at the default intra-op thread count (the
   engine's) and at one;
2. the pageable copy of one period's draws to the card, the card idle;
3. the market warm ``coop`` episode on "megakernel" (every service at
   period 0, 1 MHz each, 100 rounds, 10 periods: ``chip_smoke.py``'s
   market setting) under three samplers in turns, ABC CBA ABC CBA: the
   engine's own prefetching sampler, every period's draws made
   beforehand on the host and copied each period, and made beforehand
   and already on the card.  Per sampler: periods/s (median of 4), the
   ms of each period (from one sampler call to the next), and the
   prefetching sampler's waits.  The episodes must agree in every
   duration.

Prints one JSON object (also written to ``--out``).  ``--device cpu``
with a small ``--services`` runs it on the CPU as a rehearsal.  A script,
not a test: pytest does not collect it.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.fl import simulator  # noqa: E402


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def market(n_services: int):
    """chip_smoke.py's market setting: config, network, arrivals, counts."""
    cfg = simulator.SimConfig(n_services_total=n_services, max_periods=10,
                              rounds_required=100, policy="coop",
                              warm_start=True, intra_backend="megakernel",
                              collect_alloc=True)
    net = simulator._default_net(cfg)
    net = dataclasses.replace(net, total_bandwidth_mhz=(
        net.total_bandwidth_mhz * n_services
        / simulator.SimConfig().n_services_total))
    _, counts = simulator._static_draws(cfg, net)
    return cfg, net, np.zeros(n_services, np.int64), counts


def draw_rates(draw) -> dict:
    """ms of one period's draws on one thread, and of 12 periods' on W
    threads with the default intra-op count and with one."""
    threads = torch.get_num_threads()
    draw(0)
    t0 = time.perf_counter()
    for period in range(1, 7):
        draw(period)
    out = {"one_period_ms": 1e3 * (time.perf_counter() - t0) / 6}
    for label, init in (("default_intra_op", None),
                        ("one_intra_op", lambda: torch.set_num_threads(1))):
        for workers in (2, 4, 6):
            with ThreadPoolExecutor(workers, initializer=init) as pool:
                list(pool.map(lambda _: None, range(workers)))
                t0 = time.perf_counter()
                list(pool.map(draw, range(10, 22)))
                out[f"12_periods_ms_{label}_{workers}_threads"] = (
                    1e3 * (time.perf_counter() - t0))
    torch.set_num_threads(threads)
    return out


class Stamped:
    """A sampler that notes the time of each call."""

    def __init__(self, inner):
        self.inner, self.stamps = inner, []

    def __call__(self, period: int):
        self.stamps.append(time.perf_counter())
        return self.inner(period)


def episodes(cfg, net, arrivals, counts, device: str) -> dict:
    run = functools.partial(simulator.run_scan, cfg, net, arrivals=arrivals,
                            counts=counts, device=device)
    inline = simulator.default_sampler(cfg, net, counts, device)
    periods = run(sampler=inline)["periods"]
    draw = simulator._raw_draws(cfg, net, counts)
    host = [draw(p) for p in range(periods)]
    card = [simulator._placed(raw, cfg, p, device)
            for p, raw in enumerate(host)]
    _sync(device)
    t0 = time.perf_counter()
    for p, raw in enumerate(host):
        simulator._placed(raw, cfg, p, device)
    _sync(device)
    copy_ms = 1e3 * (time.perf_counter() - t0) / periods

    makers = {
        "prefetch": lambda: simulator._PrefetchingSampler(cfg, net, counts,
                                                          device),
        "host_copy": lambda: (lambda p: simulator._placed(host[p], cfg, p,
                                                          device)),
        "on_card": lambda: card.__getitem__}
    rates = {name: [] for name in makers}
    period_ms = {name: [] for name in makers}
    waits, durations = [], set()
    for rep in range(4):
        order = list(makers) if rep % 2 == 0 else list(makers)[::-1]
        for name in order:
            inner = makers[name]()
            sampler = Stamped(inner)
            _sync(device)
            t0 = time.perf_counter()
            try:
                res = run(sampler=sampler)
                _sync(device)
            finally:
                if name == "prefetch":
                    inner.close()
            t1 = time.perf_counter()
            if name == "prefetch":
                waits.append([1e3 * w for w in inner.waits])
            rates[name].append(res["periods"] / (t1 - t0))
            stamps = sampler.stamps + [t1]
            period_ms[name].append([1e3 * (b - a)
                                    for a, b in zip(stamps, stamps[1:])])
            durations.add(tuple(res["durations"]))
    if len(durations) != 1:
        raise AssertionError("the samplers ran different episodes")
    return {"periods": periods, "copy_ms_a_period_card_idle": copy_ms,
            "periods_per_s": {k: float(np.median(v))
                              for k, v in rates.items()},
            "runs": rates, "period_ms": period_ms,
            "prefetch_waits_ms": waits}


def card_info(device: str) -> str | None:
    if device == "cpu":
        return None
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--services", type=int, default=8192)
    ap.add_argument("--out", default=str(ROOT / "build" / "host_draws.json"))
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("host_draws: no CUDA card", file=sys.stderr)
        return 1
    cfg, net, arrivals, counts = market(args.services)
    out = {"card": card_info(args.device), "services": args.services,
           "slots": args.services * simulator._k_cap(cfg),
           "prefetch_workers": simulator.PREFETCH_WORKERS,
           "intra_op_threads": torch.get_num_threads(),
           "draws": draw_rates(simulator._raw_draws(cfg, net, counts)),
           "episode": episodes(cfg, net, arrivals, counts, args.device)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
