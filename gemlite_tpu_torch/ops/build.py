# SPDX-License-Identifier: Apache-2.0
"""Build the hand-written CUDA kernels at first use, load them with ctypes,
keep the scratch of the kernels whose K splits meet in one launch, and count
the device operations of a call.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launchers that take raw device
pointers, sizes and a ``cudaStream_t`` and return the ``cudaError_t`` of the
launch. ``nvcc`` compiles each source into its own shared library under
``gemlite_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the sources and flags, so an edited kernel is rebuilt and an unchanged one is
reused. Several sources build in parallel, one ``nvcc`` each; a source with
many instances (``KERNEL_PARTS``) is compiled in parts, one ``nvcc -c`` each
with the defines that pick its instances, all at once, and the objects are
linked into its one library. The sources include no PyTorch header, so no
build needs ninja.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["KERNEL_SOURCES", "KERNEL_PARTS", "build", "load", "check", "graph_ops",
           "split_state", "split_tensors"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("decode_gemv", "decode_modes", "prefill_gemm", "prefill_modes", "dequantize",
                  "int8_decode", "fused_gemm", "fused_float", "flash_attention", "paged_attention",
                  "fp8_gemm", "mx_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# sources compiled in parts: (part name, its defines), each part one nvcc, the
# objects linked into the source's library. prefill_modes.cu's and
# decode_modes.cu's parts hold their code widths (GL_PM_BITS, GL_DM_BITS) and
# the entries (GL_PM_ENTRY, GL_DM_ENTRY); fused_float.cu's its
# weight forms (GL_FF_FORMS, a mask of the forms) and the entry (GL_FF_ENTRY),
# int8_decode.cu's its weight kinds (GL_I8_KINDS) and the entries
# (GL_I8_ENTRY): one nvcc of each whole source took 388 s and 206 s, the
# longest two of the build (on the machine that holds the H100, PERF.md).
KERNEL_PARTS = {
    "decode_modes": (("decode_modes_w4", ("-DGL_DM_BITS=0x4", "-DGL_DM_ENTRY=1")),
                     ("decode_modes_w2", ("-DGL_DM_BITS=0x2",)),
                     ("decode_modes_w1", ("-DGL_DM_BITS=0x1",))),
    "prefill_modes": (("prefill_modes_w4", ("-DGL_PM_BITS=0x4", "-DGL_PM_ENTRY=1")),
                      ("prefill_modes_w2", ("-DGL_PM_BITS=0x2",)),
                      ("prefill_modes_w1", ("-DGL_PM_BITS=0x1",))),
    "fused_float": (("fused_float_i8_16", ("-DGL_FF_FORMS=0x03", "-DGL_FF_ENTRY=1")),
                    ("fused_float_w8", ("-DGL_FF_FORMS=0x04",)),
                    ("fused_float_w1", ("-DGL_FF_FORMS=0x20",)),
                    ("fused_float_w4", ("-DGL_FF_FORMS=0x08",)),
                    ("fused_float_w2", ("-DGL_FF_FORMS=0x10",))),
    "int8_decode": (("int8_decode_dense_u8", ("-DGL_I8_KINDS=0x03", "-DGL_I8_ENTRY=1")),
                    ("int8_decode_nib4", ("-DGL_I8_KINDS=0x04",)),
                    ("int8_decode_nib2", ("-DGL_I8_KINDS=0x08",))),
}

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
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(KERNEL_PARTS.get(name))).encode())
    for src in sorted(SRC_DIR.glob("*.cuh")) + [SRC_DIR / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES, seconds=None) -> dict:
    """Compile every named source that has no up-to-date library, all at once.

    Returns ``{name: ptxas report}`` for the sources compiled by this call
    (registers, shared memory and spills per kernel); with a dict
    ``seconds``, also fills it with each source's wall time and, for a
    source built in parts, each part's. Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}          # process name -> (process, log, output, library)
    libs = {}           # library -> (tmp, out, [part objects])
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = str(SRC_DIR / f"{name}.cu")
        parts = KERNEL_PARTS.get(name)
        if parts is None:
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), src]
            libs[name] = (tmp, out, [])
            log = tempfile.TemporaryFile(mode="w+")
            procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True),
                           log, tmp, name)
            continue
        objs = []
        for part, defines in parts:
            obj = tmp.with_suffix(f".{part}.o")
            objs.append(obj)
            cmd = [nvcc, *(f for f in NVCC_FLAGS if f != "-shared"), *defines, "-c", "-o",
                   str(obj), src]
            log = tempfile.TemporaryFile(mode="w+")
            procs[part] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True),
                           log, obj, name)
        libs[name] = (tmp, out, objs)
    done, texts, failed, linked = {}, {}, [], {}
    while any(key not in done for key in procs):
        for key, (proc, log, _, lib) in procs.items():
            if key in done or proc.poll() is None:
                continue
            done[key] = time.perf_counter() - t0
            log.seek(0)
            text = log.read()
            log.close()
            texts[lib] = texts.get(lib, "") + text
            if proc.returncode != 0:
                failed.append(f"--- {lib}.cu, {key} (nvcc exit {proc.returncode})\n{text}")
            tmp, out, objs = libs[lib]
            if objs and all(k in done for k, v in procs.items() if v[3] == lib):
                # the last part of a source built in parts: link its objects now
                ok = all(v[0].returncode == 0 for v in procs.values() if v[3] == lib)
                if ok:
                    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                         capture_output=True, text=True)
                    if res.returncode != 0:
                        failed.append(f"--- {lib}: link (nvcc exit {res.returncode})\n"
                                      f"{res.stdout}{res.stderr}")
                    linked[lib] = res.returncode == 0
                    done[lib] = time.perf_counter() - t0
                for obj in objs:
                    obj.unlink(missing_ok=True)
        time.sleep(0.05)
    reports = {}
    for name, (tmp, out, objs) in libs.items():
        if linked.get(name, not objs) and all(v[0].returncode == 0 for v in procs.values()
                                              if v[3] == name):
            os.replace(tmp, out)
            reports[name] = texts[name]
    if seconds is not None:
        seconds.update(done)
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


def split_state(owner: str, device: torch.device, ints: int, floats: int, stream=None):
    """(int32, float32) scratch of a kernel whose split blocks meet in one
    launch, per owner, device and stream, grown on demand. The int32 part
    (accumulators, arrival counters) is zeroed once and every call leaves it
    0; the float32 part holds partials that each call writes before it reads
    them. So a call allocates no scratch of its own. ``stream``: the
    caller's ``cuda_stream`` handle, if it has read it already."""
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    key = (owner, device.index, stream)
    state = _SPLIT_STATE.get(key)
    if state is None or state[0].numel() < ints or state[1].numel() < floats:
        have = (state[0].numel(), state[1].numel()) if state is not None else (1, 1)
        state = (torch.zeros(max(ints, have[0]), dtype=torch.int32, device=device),
                 torch.empty(max(floats, have[1]), dtype=torch.float32, device=device))
        _SPLIT_STATE[key] = state
    return state


def split_tensors(stream: int) -> list:
    """Every split-state tensor of one stream (its ``cuda_stream`` handle).
    A CUDA graph captured on that stream writes them at every replay, so it
    keeps a reference to each: a later growth replaces the tensor in the
    state, and the graph's one must not be freed and handed out again."""
    return [t for key, state in _SPLIT_STATE.items() if key[2] == stream for t in state]


# CUgraphNodeType values (cuda.h) of the nodes that do device work
_DEVICE_NODES = {0: "kernel", 1: "memcpy", 2: "memset"}
_CAPTURE_STREAMS = {}


def _node_types(graph: int) -> list:
    """The CUgraphNodeType of every node of a cudaGraph_t, read through the
    driver API."""
    cu = ctypes.CDLL("libcuda.so.1")
    g, n = ctypes.c_void_p(graph), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(0)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        types.append(t.value)
    return types


def graph_ops(fn) -> list:
    """The device operations (kernels, copies, memsets) of one ``fn()``, by
    node type: fn runs once on a side stream (which builds what it needs and
    makes that stream's split state), then a second call is captured into a
    CUDA graph and its nodes are counted, and the graph is replayed once so
    that what fn returned from the captured call holds its results."""
    dev = torch.cuda.current_device()
    stream = _CAPTURE_STREAMS.setdefault(dev, torch.cuda.Stream(dev))
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    types = _node_types(graph.raw_cuda_graph())
    graph.replay()
    torch.cuda.synchronize()
    return [_DEVICE_NODES[t] for t in types if t in _DEVICE_NODES]
