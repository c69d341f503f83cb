#!/usr/bin/env python3
"""Hold ``div_fast`` (``src/repro_torch/csrc/rows.cuh``) to the IEEE divide
bit for bit on the card.

``div_fast`` is nvcc's fast path of ``/`` without its range check and
slow-path call; it must give the bits of ``/`` wherever it reports its
operands in range.  This builds a small kernel around it (nvcc, as
``repro_torch.kernels._build`` does), draws operand pairs from a counter
hash, and counts the pairs in range whose quotient differs from ``/``:

- "exponents": |n|, |d| with exponents across [2^-52, 2^52) and random
  signs (some out of range, which are counted apart);
- "kernel": n in [2^-12, 1), d in [2^-107, 2^13), the magnitudes of the
  allocation kernels' dividends and denominators.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tests/torch_div_fast.py [--launches 64] [--out FILE]

It prints one JSON line and exits non-zero on any mismatch.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include "rows.cuh"

__device__ __forceinline__ unsigned mix(unsigned long long x) {
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL; x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL; x ^= x >> 33;
  return (unsigned)x;
}

__device__ __forceinline__ float draw(unsigned h, unsigned lo_exp,
                                      unsigned span) {
  return __uint_as_float(((h >> 9) & 0x7fffffu) | ((lo_exp + h % span) << 23));
}

__global__ void check(unsigned long long base, int mode,
                      unsigned long long* counts) {
  const unsigned long long i =
      base + blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
  unsigned long long bad = 0, out = 0;
  for (int rep = 0; rep < 64; ++rep) {
    const unsigned long long key = 2 * (i * 64 + rep);
    const unsigned h1 = mix(key), h2 = mix(key + 1);
    float n, d;
    if (mode == 0) {
      n = draw(h1, 75u, 105u);
      d = draw(h2, 75u, 105u);
      if (h1 & 0x80000000u) n = -n;
      if ((h2 & 7u) == 0) d = -d;
    } else {
      n = draw(h1, 115u, 12u);
      d = draw(h2, 20u, 120u);
    }
    unsigned far = 0;
    const float q = repro::div_fast(n, d, far);
    if (far >= repro::kFastSpan) { ++out; continue; }
    bad += __float_as_uint(q) != __float_as_uint(n / d);
  }
  atomicAdd(counts, bad);
  atomicAdd(counts + 1, out);
}

extern "C" int run(int mode, int launches, unsigned long long* host) {
  unsigned long long* counts;
  if (cudaMalloc(&counts, 16) != cudaSuccess) return -1;
  cudaMemset(counts, 0, 16);
  for (int l = 0; l < launches; ++l)
    check<<<4096, 256>>>((unsigned long long)l * 4096 * 256, mode, counts);
  cudaMemcpy(host, counts, 16, cudaMemcpyDeviceToHost);
  cudaFree(counts);
  return cudaGetLastError();
}
"""
PAIRS_PER_LAUNCH = 4096 * 256 * 64


def main() -> int:
    from repro_torch.kernels import _build

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--launches", type=int, default=64)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        src, lib = Path(tmp) / "div_fast.cu", Path(tmp) / "libdiv_fast.so"
        src.write_text(SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", str(lib), str(src)],
                       check=True)
        run = ctypes.CDLL(str(lib)).run
        run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        result = {}
        for mode, name in enumerate(("exponents", "kernel")):
            counts = (ctypes.c_ulonglong * 2)()
            if run(mode, args.launches, counts) != 0:
                raise RuntimeError(f"div_fast check {name} failed to run")
            result[name] = {"pairs": args.launches * PAIRS_PER_LAUNCH,
                            "out_of_range": counts[1],
                            "mismatches": counts[0]}
    line = json.dumps({"div_fast": result})
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 1 if any(r["mismatches"] for r in result.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
