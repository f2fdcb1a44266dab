# SPDX-License-Identifier: Apache-2.0
"""Build the hand-written CUDA kernels at first use, load them with ctypes,
and plan their split-K grids.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launchers that take raw device
pointers, sizes and a ``cudaStream_t`` and return the ``cudaError_t`` of the
launch. ``nvcc`` compiles each source into its own shared library under
``gemlite_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the sources and flags, so an edited kernel is rebuilt and an unchanged one is
reused. Several sources build in parallel, one ``nvcc`` each. The sources
include no PyTorch header, so a build takes seconds and needs no ninja.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["KERNEL_SOURCES", "TARGET_BLOCKS", "build", "load", "check", "split_k", "split_state"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("decode_gemv", "prefill_gemm", "dequantize", "int8_decode", "fused_gemm",
                  "flash_attention", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

TARGET_BLOCKS = 2 * 132   # two blocks per H100 SM

_LOCK = threading.Lock()
_LIBS = {}
_SPLIT_STATE = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cuh")) + [SRC_DIR / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict:
    """Compile every named source that has no up-to-date library, all at once.

    Returns ``{name: ptxas report}`` for the sources compiled by this call
    (registers, shared memory and spills per kernel). Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def split_k(blocks: int, K: int, unit: int, target: int = TARGET_BLOCKS):
    """(splits, k_per_split): K cut in ranges of whole ``unit``s (the last
    range may be shorter) so that a grid of ``blocks`` output tiles, times
    the splits, holds about ``target`` blocks."""
    units = -(-K // unit)
    splits = min(units, max(1, -(-target // blocks)))
    per = -(-units // splits)
    return -(-units // per), per * unit


def split_state(owner: str, device: torch.device, ints: int, floats: int):
    """(int32, float32) scratch of a kernel whose split blocks meet in one
    launch, per owner, device and stream, grown on demand. The int32 part
    (accumulators, arrival counters) is zeroed once and every call leaves it
    0; the float32 part holds partials that each call writes before it reads
    them. So a call allocates no scratch of its own."""
    key = (owner, device.index, torch.cuda.current_stream(device).cuda_stream)
    state = _SPLIT_STATE.get(key)
    if state is None or state[0].numel() < ints or state[1].numel() < floats:
        have = (state[0].numel(), state[1].numel()) if state is not None else (1, 1)
        state = (torch.zeros(max(ints, have[0]), dtype=torch.int32, device=device),
                 torch.empty(max(floats, have[1]), dtype=torch.float32, device=device))
        _SPLIT_STATE[key] = state
    return state
