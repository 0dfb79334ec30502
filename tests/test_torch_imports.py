"""The PyTorch port stands alone: it imports neither JAX nor lmcache_tpu,
and its entry points run on the CPU only when asked to."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lmcache_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_import_leaves_jax_and_lmcache_tpu_out():
    code = ("import sys, lmcache_tpu_torch, lmcache_tpu_torch.serving, "
            "lmcache_tpu_torch.models, lmcache_tpu_torch.ops, "
            "lmcache_tpu_torch.models.paged, "
            "lmcache_tpu_torch.ops.paged_attention, "
            "lmcache_tpu_torch.ops.quantized_attention, "
            "lmcache_tpu_torch.ops.attention, "
            "lmcache_tpu_torch.serving.engine, "
            "lmcache_tpu_torch.serving.paged_engine; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'lmcache_tpu' "
            "or m.startswith('lmcache_tpu.')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_lmcache_tpu_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "lmcache_tpu"), (
                f"{path}:{node.lineno} imports {name}")


def _entry_points():
    from lmcache_tpu_torch import LMCacheEngineConfig
    from lmcache_tpu_torch.models import llama, paged
    from lmcache_tpu_torch.serving import PagedServingEngine, ServingEngine
    from lmcache_tpu_torch.storage.local_backend import LMCLocalBackend
    cfg = llama.LlamaConfig.tiny(n_layers=1)
    return {
        "paged_pool": lambda: paged.new_paged_kv_pool(cfg, 4, 16),
        "quantized_paged_pool": lambda: paged.new_quantized_paged_pool(
            cfg, 4, 16),
        "paged_serving_engine": lambda: PagedServingEngine(cfg, {},
                                                           num_pages=4),
        "paged_pool_from_jax": lambda: llama.paged_pool_from_jax(
            np.zeros((1, 2, 4, 2, 16, 64), np.float32)),
        "init_params": lambda: llama.init_params(cfg),
        "new_kv_cache": lambda: llama.new_kv_cache(cfg, 1, 16),
        "new_quantized_kv_cache": lambda: llama.new_quantized_kv_cache(
            cfg, 1, 16),
        "quantized_pool_from_jax": lambda: llama.quantized_pool_from_jax(
            {"sym": np.zeros((1, 2, 1, 2, 16, 64), np.int8),
             "scale": np.ones((1, 2, 1, 16), np.float32)}),
        "int8_serving_engine": lambda: ServingEngine(cfg, {},
                                                     kv_dtype="int8"),
        "cuda_tier": lambda: LMCLocalBackend(),
        "serving_engine": lambda: ServingEngine(cfg, {}),
        "default_config_tier": lambda: LMCLocalBackend(
            LMCacheEngineConfig().local_device),
    }


@pytest.mark.parametrize("name", ["init_params", "new_kv_cache", "cuda_tier",
                                  "serving_engine", "default_config_tier",
                                  "paged_pool", "quantized_paged_pool",
                                  "paged_serving_engine",
                                  "paged_pool_from_jax",
                                  "new_quantized_kv_cache",
                                  "quantized_pool_from_jax",
                                  "int8_serving_engine"])
def test_entry_point_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_entry_points_run_on_cpu_when_asked():
    from lmcache_tpu_torch.models import llama
    cfg = llama.LlamaConfig.tiny(n_layers=1)
    params = llama.init_params(cfg, device="cpu")
    assert params["layers"]["wq"].device.type == "cpu"
    assert llama.new_kv_cache(cfg, 1, 16, device="cpu").device.type == "cpu"
    pool = llama.new_quantized_kv_cache(cfg, 1, 16, device="cpu")
    assert pool["sym"].device.type == "cpu" and pool["sym"].shape[4] == 16
    from lmcache_tpu_torch.serving import PagedServingEngine, ServingEngine
    dense = ServingEngine(cfg, params, max_batch=1, max_seq=32,
                          kv_dtype="int8", device="cpu")
    assert dense.kv_pool["scale"].device.type == "cpu"
    for kv_dtype in ("native", "int8"):
        eng = PagedServingEngine(cfg, params, num_pages=4, page_size=16,
                                 max_seq=32, kv_dtype=kv_dtype, device="cpu")
        pool = eng.kv_pool["sym"] if kv_dtype == "int8" else eng.kv_pool
        assert pool.device.type == "cpu" and pool.shape[2] == 4
