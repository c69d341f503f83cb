#!/usr/bin/env python3
"""Where a round of the train path spends its device time: ``chip_smoke.py``'s
train run (phase 6t: full-width gemma3-1b through ``launch.train.main``,
2 clients x 2048 tokens, 2 periods of at most 2 rounds) once, under the
profiler's CUDA activity.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tests/torch_train_profile.py [--top 12] [--out FILE]

Reports B5's backward and forward device ms a round, by kernel; the
device ms of every kernel of the run (its set-up included) over its
rounds; the ``--top`` kernel names (cut to 90 characters) with the most
device time, their ms and launches a round; and the run's median ms a
round with the profiler on (chip_smoke.py's phase 6t gives it without).

Prints one JSON object (also written to ``--out``).  A script, not a
test: pytest does not collect it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

BWD_KERNELS = ("flash_attention_bwd_delta_kernel",
               "flash_attention_bwd_dkdv_wgmma_kernel",
               "flash_attention_bwd_dkdv_sum_kernel",
               "flash_attention_bwd_dq_wgmma_kernel")
FWD_KERNEL = "flash_attention_wgmma_kernel"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    import chip_smoke
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("a CUDA card is needed")
    _build.build(("flash_attention", "flash_attention_bwd", "bisect_alloc"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        res = chip_smoke.train_run()
    rounds = res["rounds_done"][chip_smoke.TRAIN["arch"]]
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total: dict = {}
    for e in device:
        ms, count = total.get(e.name[:90], (0.0, 0))
        total[e.name[:90]] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    per = {name: [e.time_range.elapsed_us() / 1e3 for e in device
                  if name in e.name] for name in BWD_KERNELS + (FWD_KERNEL,)}
    bwd = {name: sum(per[name]) / rounds for name in BWD_KERNELS}
    out = {"card": torch.cuda.get_device_name(0), "rounds": rounds,
           "ms_per_round_profiled": 1e3 * float(np.median(
               res["services"][0]["round_s"])),
           "bwd_ms_per_round": sum(bwd.values()), "bwd_kernels": bwd,
           "bwd_launches": {name: len(per[name]) for name in BWD_KERNELS},
           "fwd_ms_per_round": sum(per[FWD_KERNEL]) / rounds,
           "device_ms_run_over_rounds": sum(
               ms for ms, _ in total.values()) / rounds,
           "launches_run_over_rounds": len(device) / rounds,
           "top_kernels": [
               {"name": name, "ms_per_round": ms / rounds,
                "launches_per_round": count / rounds}
               for name, (ms, count) in sorted(
                   total.items(), key=lambda kv: -kv[1][0])[:args.top]]}
    text = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return out


if __name__ == "__main__":
    main()
