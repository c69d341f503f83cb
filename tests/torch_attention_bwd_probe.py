#!/usr/bin/env python3
"""Where B5's bf16 backward spends its time: device ms of each of its
kernels, built as they are and with parts of their work taken out.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tests/torch_attention_bwd_probe.py [--reps 20] [--out FILE]

Each variant is ``src/repro_torch/csrc/flash_attention_bwd.cu`` with the
text substitutions of VARIANTS applied (each must match exactly once),
compiled with the flags of ``kernels/_build.py`` into
``build/bwd_probe/<variant>/`` (one nvcc per variant, all started
together) and launched through ``flash_attention_bwd_cuda`` at the shapes
of SHAPES, on the forward kernel's output and L and a random dO.  The
variants other than "base" compute wrong gradients: they are for timing
only, and nothing else loads them.  Per variant, shape and kernel: the
median profiler ms over ``--reps`` calls, and its share of "base".

- ``no_exchange``: the dk/dv kernel's two warpgroups skip the named
  barriers around P f (the second reads whatever is in shared memory).
- ``no_elementwise``: the dk/dv kernel forms neither P nor dS (the
  products take S^T and dP^T as they come; no exchange); the dq kernel
  skips its exp pass (dS from S as it comes).
- ``no_stream``: after the ring's first fill the producers load nothing
  (Q and dO in dk/dv, K and V in dq) and only arrive on the full
  barriers; the consumers reuse the stale stages.
- ``products``: both of the last two: the kernels' tensor-core products,
  their waits and the ring's barriers alone.

Prints one JSON object (also written to ``--out``).  A script, not a
test: pytest does not collect it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (B, Hq, Hkv, S, D, window): the train path's shapes and llama4's.
SHAPES = {"train_local": (2, 4, 1, 2048, 256, 1024),
          "train_global": (2, 4, 1, 2048, 256, 0),
          "llama4": (4, 40, 8, 2048, 128, 0)}
KERNELS = ("flash_attention_bwd_delta_kernel",
           "flash_attention_bwd_dkdv_wgmma_kernel",
           "flash_attention_bwd_dkdv_sum_kernel",
           "flash_attention_bwd_dq_wgmma_kernel")

_DKDV_SYNC = [
    ("        if (it > 0)  // role 1 has read the last P f\n"
     "          asm volatile(\"bar.sync 2, 256;\\n\" ::: \"memory\");\n", ""),
    ("        asm volatile(\"bar.arrive 1, 256;\\n\" ::: \"memory\");\n", ""),
    ("        asm volatile(\"bar.sync 1, 256;\\n\" ::: \"memory\");\n", ""),
    ("        if (it + 1 < n_it) asm volatile(\"bar.arrive 2, 256;\\n\" ::: "
     "\"memory\");\n", ""),
]
_DKDV_ELEMENTWISE = [
    ("      if (role == 0) {\n", "      if (false) {\n"),
    ("      } else {\n        asm volatile(\"bar.sync 1, 256;",
     "      } else if (false) {\n        asm volatile(\"bar.sync 1, 256;"),
]
_DQ_ELEMENTWISE = [
    ("      for (int i = 0; i < kKeys / 2; ++i) {\n"
     "        const int key = k0 + 8 * (i / 4) + 2 * tig + (i & 1);\n",
     "      for (int i = 0; i < 0; ++i) {\n"
     "        const int key = k0 + 8 * (i / 4) + 2 * tig + (i & 1);\n"),
]
_DKDV_STREAM = [
    ("        if (lane == 0) {\n"
     "          uint8_t* q_t = qdo_s + stage * 2 * W::kTileBytes;\n",
     "        if (lane == 0 && it < kStages) {\n"
     "          uint8_t* q_t = qdo_s + stage * 2 * W::kTileBytes;\n"),
]
_DQ_STREAM = [
    ("        uint8_t* k_t = kv_s + stage * 2 * W::kDqKVBytes;\n",
     "        uint8_t* k_t = kv_s + stage * 2 * W::kDqKVBytes;\n"
     "        if (it >= kStages) {\n"
     "          repro::mbar_arrive(&full_k[stage]);\n"
     "          repro::mbar_arrive(&full_v[stage]);\n"
     "          continue;\n"
     "        }\n"),
]
VARIANTS = {"base": [],
            "no_exchange": _DKDV_SYNC,
            "no_elementwise": _DKDV_ELEMENTWISE + _DKDV_SYNC
            + _DQ_ELEMENTWISE,
            "no_stream": _DKDV_STREAM + _DQ_STREAM,
            "products": _DKDV_ELEMENTWISE + _DKDV_SYNC + _DQ_ELEMENTWISE
            + _DKDV_STREAM + _DQ_STREAM}


def patched_source(csrc: Path, dest: Path, subs) -> Path:
    """``csrc`` copied to ``dest`` with ``subs`` applied to the backward's
    source; returns the patched file."""
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(csrc, dest)
    path = dest / "flash_attention_bwd.cu"
    text = path.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{path.name}: {old!r} matches "
                               f"{text.count(old)} times")
        text = text.replace(old, new)
    path.write_text(text)
    return path


def build_variants(out_dir: Path) -> dict:
    """One nvcc per variant, all started together, and the forward's
    library of _build beside them."""
    from repro_torch.kernels import _build

    jobs = {}
    for name, subs in VARIANTS.items():
        src = patched_source(_build.CSRC, out_dir / name / "csrc", subs)
        lib = out_dir / name / "libflash_attention_bwd.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               *_build.SOURCE_FLAGS["flash_attention_bwd"], "-I",
               str(src.parent), "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    _build.build(("flash_attention",))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = lib
    return libs


def bind(lib: Path):
    """The variant's entry, typed as flash_attention._bwd_lib types it."""
    from repro_torch.kernels import flash_attention as fa

    fn = ctypes.CDLL(str(lib)).flash_attention_bwd_launch
    fn.argtypes = ([fa._c_void_p] * 10 + [fa._c_int] * 7 + [fa._c_void_p]
                   + [fa._c_int] * 2 + [fa._c_float, fa._c_float,
                                        fa._c_void_p, fa._c_int,
                                        fa._c_void_p])
    fn.restype = fa._c_int
    return fn


def kernel_ms(call, reps: int) -> dict:
    """Median device ms of each of KERNELS over ``reps`` calls (one
    profiler window, 8 filler kernels at each end)."""
    import torch
    from torch.autograd import DeviceType

    pad = torch.zeros(16, device="cuda")
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            pad.add_(1.0)
        for _ in range(reps):
            call()
        for _ in range(8):
            pad.add_(1.0)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {}
    for name in KERNELS:
        times = [e.time_range.elapsed_us() / 1e3 for e in device
                 if name in e.name]
        if times:
            out[name] = statistics.median(times)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        raise SystemExit("a CUDA card is needed")
    libs = build_variants(ROOT / "build" / "bwd_probe")
    fns = {name: bind(lib) for name, lib in libs.items()}
    gen = torch.Generator(device="cuda").manual_seed(23)
    res = {"card": torch.cuda.get_device_name(0), "reps": args.reps,
           "ms": {}, "share_of_base": {}}
    for shape, (b, hq, hkv, s, d, window) in SHAPES.items():
        q, do = (torch.randn((b, hq, s, d), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        o, lse = ops.flash_attention_op(q, k, v, True, window, 0.0)
        ms = {}
        for name, fn in fns.items():
            fa._bwd_lib = lambda fn=fn: fn
            ms[name] = kernel_ms(lambda: fa.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, causal=True, window=window), args.reps)
        res["ms"][shape] = ms
        res["share_of_base"][shape] = {
            name: {kern: t / ms["base"][kern] for kern, t in per.items()
                   if kern in ms["base"]}
            for name, per in ms.items() if name != "base"}
        del q, k, v, do, o, lse
    text = json.dumps(res)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return res


if __name__ == "__main__":
    main()
