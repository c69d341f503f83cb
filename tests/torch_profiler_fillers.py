"""Fillers a ``chip_smoke.py`` profiler window loses at its start, with and
without the host pause that lets tracing start.

    python3 tests/torch_profiler_fillers.py --windows 80 \\
        --out build/profiler_fillers.json

Runs ``chip_smoke._profiled_records`` (FILLERS tiny kernels at each end of
the window) on an elementwise product and a matmul, each window after 50
calls of that work, ``--windows`` times with ``PROFILER_SETTLE_S`` at its
value and at 0 in turns (``FILLERS_LOST_LIMIT`` lifted, so a window that
loses many fillers is counted, not raised), and prints per variant the
fillers each window lost at its start and at its end.  Needs a CUDA card;
run from the root of a checkout.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--windows", type=int, default=80)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profiler_fillers: no CUDA device", file=sys.stderr)
        return 1
    x = torch.randn(1 << 22, device="cuda")
    y = torch.randn(2048, 2048, device="cuda")

    def work():
        x.mul_(1.0000001)
        torch.mm(y, y)

    settle = chip_smoke.PROFILER_SETTLE_S
    chip_smoke.FILLERS_LOST_LIMIT = chip_smoke.FILLERS + 1
    lost: dict[str, list] = {f"settle_{settle}": [], "settle_0": []}
    t0 = time.perf_counter()
    for _ in range(args.windows):
        for name, pause in ((f"settle_{settle}", settle), ("settle_0", 0.0)):
            for _ in range(50):
                work()
            torch.cuda.synchronize()
            chip_smoke.PROFILER_SETTLE_S = pause
            chip_smoke._profiled_records(work, 21, ("elementwise",))
            lost[name].append(list(chip_smoke.FILLERS_LOST[-1][1:]))
    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": chip_smoke.card_info()[1],
           "fillers": chip_smoke.FILLERS, "windows": args.windows,
           "seconds": time.perf_counter() - t0, "variants": {
               name: {"start_max": max(r[0] for r in rows),
                      "start_mean": float(np.mean([r[0] for r in rows])),
                      "windows_losing_100_or_more": sum(r[0] >= 100
                                                        for r in rows),
                      "end_max": max(r[1] for r in rows),
                      "start_lost": [r[0] for r in rows]}
               for name, rows in lost.items()}}
    print(json.dumps(out), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
