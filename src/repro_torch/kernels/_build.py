"""Build ``repro_torch/csrc/*.cu`` into shared libraries and load them.

Each source compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC

into ``build/repro_torch/`` at the root of the checkout, at first use, and
is loaded with ``ctypes``.  The file name carries a digest of the sources
and flags, so an edited kernel is never served from a stale build.  No
``--use_fast_math``: the kernels rely on IEEE float32 division and
denormals (the 1/TINY sentinel and the 1e-30 clamps).  ``decode_attention``
(64 template instances: 2 dtypes x 4 head dims x G = 1..8) also gets
``-split-compile=0``, nvcc's optimization passes run in parallel on every
core: on the card's host it builds in ~40 s instead of ~120 s, where the
other sources take under 20 s.  ``flash_attention_bwd`` (18 kernels:
the float32 pair and the bf16 ``wgmma`` pair at 4 head dims, Delta and
the sum of the dk/dv parts) gets the same flag.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("bisect_alloc", "dual_demand", "market_clear", "mbdf_demand",
           "flash_attention", "flash_attention_bwd", "decode_attention",
           "mlstm_chunk", "mlstm_chunk_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCE_FLAGS = {"decode_attention": ("-split-compile=0",),
                "flash_attention_bwd": ("-split-compile=0",)}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(
        " ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, ())).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=KERNELS) -> float:
    """Compile every missing library among ``names``, one ``nvcc`` per
    source, all started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-I",
               str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, tmp, out, proc))
    errors = []
    for name, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    if name not in _LOADED:
        path = _library_path(name)
        if not path.exists():
            build((name,))
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]


def check(status: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {status}")
