#!/usr/bin/env python3
"""Where a round of a train path spends its device time: one of
``chip_smoke.py``'s train runs (phase 6t) once, under the profiler's CUDA
activity.  ``--arch gemma3-1b`` (the default) is the transformer run:
full-width gemma3-1b through ``launch.train.main``, 2 clients x 2048
tokens, 2 periods of at most 2 rounds.  ``--arch xlstm-1.3b`` is the xLSTM
run: full-width xlstm-1.3b cut to ``chip_smoke.XLSTM_TRAIN``'s layers (8
of 48: 7 mLSTM + 1 sLSTM), 2 clients x 2048 tokens, 2 periods of at most 1
round.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tests/torch_train_profile.py [--arch A] [--top 12] [--out FILE]

Reports the arch's hand-written kernels' backward and forward device ms a
round, by kernel (B5's for gemma3-1b, B7's for xlstm-1.3b); the device ms
of every kernel of the run (its set-up included) over its rounds; the
``--top`` kernel names (cut to 90 characters) with the most device time,
their ms and launches a round; the host ms of the CUDA runtime calls
(``cudaMalloc`` and the like) over the rounds; and the run's median and
last ms a round with the profiler on (chip_smoke.py's phase 6t gives them
without).  For xlstm-1.3b also the host seconds of ``vmap`` over the
clients of ``grad`` through one mLSTM and one sLSTM block of the run (its
first of each, its batch shape, a seeded input, after a warm-up call),
and the share of the profiled last round that the run's mLSTM and sLSTM
blocks would take at those times.

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

# by arch: chip_smoke's run, the kernels to build, and the names of the
# backward's and the forward's kernels
ARCHS = {
    "gemma3-1b": ("TRAIN", ("flash_attention", "flash_attention_bwd",
                            "bisect_alloc"),
                  ("flash_attention_bwd_delta_kernel",
                   "flash_attention_bwd_dkdv_wgmma_kernel",
                   "flash_attention_bwd_dkdv_sum_kernel",
                   "flash_attention_bwd_dq_wgmma_kernel"),
                  ("flash_attention_wgmma_kernel",)),
    "xlstm-1.3b": ("XLSTM_TRAIN", ("mlstm_chunk", "mlstm_chunk_bwd",
                                   "bisect_alloc"),
                   ("mlstm_bwd_scores_kernel", "mlstm_bwd_states_kernel",
                    "mlstm_bwd_grads_kernel", "mlstm_bwd_gates_kernel"),
                   ("mlstm_states_kernel", "mlstm_outputs_kernel")),
}


def block_grad_s(params, cfg, t: dict, device) -> dict:
    """Host seconds of ``vmap`` over the clients of ``grad`` through the
    first mLSTM and the first sLSTM block of an xLSTM train run (its batch
    shape, a seeded input), each after one warm-up call."""
    import time

    import torch
    from torch.func import grad, vmap

    from repro_torch.models import xlstm

    gen = torch.Generator().manual_seed(5)
    x = torch.randn((t["clients"], t["batch"], t["seq"], cfg.d_model),
                    generator=gen).to(device, cfg.compute_dtype)

    def block_loss(apply, p, xc):
        y, _ = apply(p, cfg, xc)
        return y.float().square().mean()

    out = {}
    for name, apply, p in (
            ("mlstm", xlstm.apply_mlstm_block, params["m_blocks"][0][0]),
            ("slstm", xlstm.apply_slstm_block, params["s_blocks"][0])):
        fn = vmap(grad(lambda p_, x_, a=apply: block_loss(a, p_, x_)),
                  in_dims=(None, 0))
        fn(p, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(p, x)
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="gemma3-1b")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    import chip_smoke
    from repro_torch import configs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("a CUDA card is needed")
    run, kernels, bwd_names, fwd_names = ARCHS[args.arch]
    t = getattr(chip_smoke, run)
    _build.build(kernels)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        res = chip_smoke.train_run(t)
    rounds = res["rounds_done"][t["arch"]]
    round_s = res["services"][0]["round_s"]
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    runtime = [e for e in prof.events() if e.device_type == DeviceType.CPU
               and e.name.startswith("cuda")]
    total: dict = {}
    for e in device:
        ms, count = total.get(e.name[:90], (0.0, 0))
        total[e.name[:90]] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    host: dict = {}
    for e in runtime:
        ms, count = host.get(e.name, (0.0, 0))
        host[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    per = {name: [e.time_range.elapsed_us() / 1e3 for e in device
                  if name in e.name] for name in bwd_names + fwd_names}
    bwd = {name: sum(per[name]) / rounds for name in bwd_names}
    out = {"card": torch.cuda.get_device_name(0), "arch": t["arch"],
           "rounds": rounds,
           "ms_per_round_profiled": 1e3 * float(np.median(round_s)),
           "round_ms_profiled": [1e3 * x for x in round_s],
           "bwd_ms_per_round": sum(bwd.values()), "bwd_kernels": bwd,
           "bwd_launches": {name: len(per[name]) for name in bwd_names},
           "fwd_ms_per_round": sum(sum(per[n]) for n in fwd_names) / rounds,
           "device_ms_run_over_rounds": sum(
               ms for ms, _ in total.values()) / rounds,
           "launches_run_over_rounds": len(device) / rounds,
           "runtime_calls_over_rounds": {
               name: {"ms": ms / rounds, "calls": count / rounds}
               for name, (ms, count) in sorted(
                   host.items(), key=lambda kv: -kv[1][0])[:args.top]},
           "top_kernels": [
               {"name": name, "ms_per_round": ms / rounds,
                "launches_per_round": count / rounds}
               for name, (ms, count) in sorted(
                   total.items(), key=lambda kv: -kv[1][0])[:args.top]]}
    if args.arch == "xlstm-1.3b":
        cfg = dataclasses.replace(configs.get_config(t["arch"]),
                                  n_layers=t["n_layers"])
        blocks = block_grad_s(res["params"][t["arch"]], cfg, t,
                              chip_smoke.DEVICE)
        n_m = chip_smoke.XLSTM_TRAIN_MLSTM_LAYERS
        last_s = round_s[-1]
        out["block_grad_s"] = blocks
        out["share_of_profiled_last_round"] = {
            "mlstm_blocks": n_m * t["local_steps"] * blocks["mlstm"] / last_s,
            "slstm_blocks": (t["n_layers"] - n_m) * t["local_steps"]
            * blocks["slstm"] / last_s,
            "b7_bwd_kernels": out["bwd_ms_per_round"] / 1e3 / last_s,
            "b7_fwd_kernels": out["fwd_ms_per_round"] / 1e3 / last_s}
    text = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return out


if __name__ == "__main__":
    main()
