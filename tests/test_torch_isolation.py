# SPDX-License-Identifier: Apache-2.0
"""The port stands alone: no JAX, nothing of the JAX package, no silent CPU
fallback."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "gemlite_tpu", "gemlite", "ml_dtypes"}


def _port_sources():
    return sorted((ROOT / "gemlite_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_import_leaves_jax_out():
    code = ("import sys, gemlite_tpu_torch, gemlite_tpu_torch.ops.dispatch\n"
            "bad = [m for m in ('jax', 'gemlite_tpu', 'gemlite', 'triton', 'ml_dtypes') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _entry_points(files: Path):
    from gemlite_tpu_torch import (A16W4_HQQ_INT, ContinuousBatchingEngine, DType,
                                   GemLiteLinear, LlamaConfig, init_kv_cache, init_llama,
                                   params_from_jax_numpy, quantize_llama)
    from gemlite_tpu_torch.helper import (A16W158_INT, A16W8_FP8, A16W8_INT8, A8W158_INT_dynamic,
                                          A8W4_HQQ_INT_dynamic, A8W8_FP8_dynamic,
                                          A8W8_INT8_dynamic, warmup)
    from gemlite_tpu_torch.checkpoint import load_model, save_model
    from gemlite_tpu_torch.importers import load_hf_llama
    from gemlite_tpu_torch import mx
    cfg = LlamaConfig.tiny(num_layers=1)
    cpu_params = init_llama(cfg, device="cpu")
    save_model({"w": torch.ones(2)}, str(files / "model.npz"))
    GemLiteLinear(4, 64, 128, 128, DType.BF16, DType.BF16, device="cpu").pack(
        torch.zeros((128, 128), dtype=torch.uint8), torch.ones((256, 1), dtype=torch.bfloat16),
        torch.zeros((256, 1), dtype=torch.bfloat16)).save(str(files / "layer.npz"))
    return {
        "GemLiteLinear": lambda **kw: GemLiteLinear(4, 64, 128, 128, DType.BF16, DType.BF16,
                                                     **kw),
        "A16W4_HQQ_INT": lambda **kw: A16W4_HQQ_INT(**kw),
        "A16W8_INT8": lambda **kw: A16W8_INT8(**kw),
        "A8W8_INT8_dynamic": lambda **kw: A8W8_INT8_dynamic(**kw),
        "A16W158_INT": lambda **kw: A16W158_INT(**kw),
        "A8W158_INT_dynamic": lambda **kw: A8W158_INT_dynamic(**kw),
        "A16W8_FP8": lambda **kw: A16W8_FP8(**kw),
        "A8W8_FP8_dynamic": lambda **kw: A8W8_FP8_dynamic(**kw),
        "A8W4_HQQ_INT_dynamic": lambda **kw: A8W4_HQQ_INT_dynamic(**kw),
        "A16W4_MXFP": lambda **kw: mx.A16W4_MXFP(**kw),
        "A16W8_MXFP": lambda **kw: mx.A16W8_MXFP(**kw),
        "A8W8_MXFP_dynamic": lambda **kw: mx.A8W8_MXFP_dynamic(**kw),
        "A8W4_MXFP_dynamic": lambda **kw: mx.A8W4_MXFP_dynamic(**kw),
        "A4W4_MXFP_dynamic": lambda **kw: mx.A4W4_MXFP_dynamic(**kw),
        "A4W4_NVFP_dynamic": lambda **kw: mx.A4W4_NVFP_dynamic(**kw),
        "pack_mxfp_layer": lambda **kw: mx.pack_mxfp_layer(
            torch.zeros((128, 128), dtype=torch.uint8), torch.full((128, 4), 127, dtype=torch.uint8),
            4, **kw),
        "init_llama": lambda **kw: init_llama(cfg, **kw),
        "init_kv_cache": lambda **kw: init_kv_cache(cfg, 1, **kw),
        "quantize_llama": lambda **kw: quantize_llama(cpu_params, group_size=64, **kw),
        "params_from_jax_numpy": lambda **kw: params_from_jax_numpy({}, **kw),
        "ContinuousBatchingEngine": lambda **kw: ContinuousBatchingEngine(
            quantize_llama(cpu_params, group_size=64, device="cpu"), cfg, **kw),
        "load_hf_llama": lambda **kw: load_hf_llama(str(ROOT / "checkpoints" / "tiny_en_5m"),
                                                    **kw),
        "load_model": lambda **kw: load_model(str(files / "model.npz"), **kw),
        "GemLiteLinear.load": lambda **kw: GemLiteLinear.load(str(files / "layer.npz"), **kw),
        "warmup": lambda **kw: warmup(A16W4_HQQ_INT(device="cpu"), [(128, 128)],
                                      batch_sizes=[1], **kw),
    }


ENTRY_POINTS = ("A16W4_HQQ_INT", "A16W8_INT8", "A8W8_INT8_dynamic", "A16W158_INT",
                "A8W158_INT_dynamic", "A16W8_FP8", "A8W8_FP8_dynamic", "A8W4_HQQ_INT_dynamic",
                "A16W4_MXFP", "A16W8_MXFP", "A8W8_MXFP_dynamic", "A8W4_MXFP_dynamic",
                "A4W4_MXFP_dynamic", "A4W4_NVFP_dynamic", "pack_mxfp_layer",
                "ContinuousBatchingEngine", "GemLiteLinear", "init_kv_cache",
                "init_llama", "params_from_jax_numpy", "quantize_llama", "load_hf_llama",
                "load_model", "GemLiteLinear.load", "warmup")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_need_the_card_or_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    make = _entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    make(device="cpu")


def test_build_without_nvcc_raises():
    """A build failure raises; nothing falls back to the plain versions."""
    from gemlite_tpu_torch.ops import build
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists() or \
            os.environ.get("CUDA_HOME"):
        pytest.skip("nvcc is present here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


@pytest.mark.parametrize("module", ["gemlite_tpu_torch.mx", "gemlite_tpu_torch.ops.mx",
                                    "gemlite_tpu_torch.xla_f32"])
def test_mx_modules_import_alone(module):
    """The MX modules import with neither JAX nor triton, each in a fresh
    interpreter."""
    code = (f"import sys, {module}\n"
            "bad = [m for m in ('jax', 'gemlite_tpu', 'gemlite', 'triton', 'ml_dtypes') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_mx_kernels_do_not_fall_back(monkeypatch, tmp_path):
    """Without a built library the MX wrappers raise: a CUDA call never runs
    the plain version. Here no library is built and the build fails as it
    does without nvcc, and each entry's loader raises."""
    from gemlite_tpu_torch.ops import build, dequantize, mx

    def no_build(names=build.KERNEL_SOURCES):
        raise RuntimeError("nvcc not found (test)")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_lib_path", lambda name: tmp_path / f"{name}.so")
    for name, pointers, ints in (("gl_mx_decode", 7, 8), ("gl_mx_decode_stacked", 8, 9),
                                 ("gl_mx_prefill", 8, 10)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            mx._fn(name, pointers, ints)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        dequantize._lib("gl_dequantize_mx", 3, 4)
