"""Causal GQA attention over a (possibly pre-filled) KV buffer.

One kernel serves both serving-phase shapes, as in
``lmcache_tpu/ops/attention.py``:

- **prefill with cached prefix**: ``T`` new query tokens attend to
  ``kv_len`` tokens already resident in the KV buffer (retrieved prefix +
  the new tokens themselves);
- **decode**: ``T == 1``.

Layouts: ``q [B, T, H, D]``; ``k/v [B, S, H_kv, D]`` (token-major) or, with
``kv_head_major=True``, ``[B, H_kv, S, D]`` (the serving pool's layout).
``H = G * H_kv``. Query ``t`` of sequence ``b`` sees key positions
``kpos <= min(q_offset[b] + t, kv_len[b] - 1)``.

:func:`flash_attention` runs the hand-written Hopper kernel
(``csrc/flash_attention.cu``) on CUDA tensors and its plain version,
:func:`mha_reference`, on CPU tensors.
"""

import ctypes
from collections import Counter
from typing import Optional

import torch

from lmcache_tpu_torch.ops import _build

_NEG_INF = -1e30


def mha_reference(q, k, v, q_offset, kv_len, sm_scale=None,
                  sliding_window: Optional[int] = None,
                  zero_dead_rows: bool = False) -> torch.Tensor:
    """Plain PyTorch attention (token-major ``k/v [B, S, H_kv, D]``): the
    kernels' plain version, computed in fp32 with a materialized score
    matrix, and the CPU path of :func:`flash_attention`.

    ``sliding_window``: keys older than that many positions behind the query
    are masked too (``kpos > qpos - sliding_window``). A query that sees no
    key averages V uniformly, as the JAX ``mha_reference`` does; with
    ``zero_dead_rows`` it gives 0, as the kernels do."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D**0.5)

    # [B, Hkv, G, T, D] x [B, Hkv, S, D] -> [B, Hkv, G, T, S]
    qh = q.reshape(B, T, Hkv, G, D).permute(0, 2, 3, 1, 4).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    scores = torch.einsum("bhgtd,bhsd->bhgts", qh, kh) * scale

    ar_t = torch.arange(T, device=q.device)
    kpos = torch.arange(S, device=q.device)[None, None, :]  # [1, 1, S]
    qpos = (q_offset.to(q.device)[:, None] + ar_t[None, :])[:, :, None]
    mask = (kpos <= qpos) & (kpos < kv_len.to(q.device)[:, None, None])
    if sliding_window is not None:
        mask &= kpos > qpos - sliding_window
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(_NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, vh)
    if zero_dead_rows:
        out = out * mask.any(dim=-1)[:, None, None, :, None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)


_lib: Optional[ctypes.CDLL] = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        fn = lib.lmc_flash_attention_bf16
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.lmc_flash_attention_bf16


def _check_cuda_args(q, k, v, q_offset, kv_len, B, Hkv, S):
    dev = q.device
    for name, t in (("k", k), ("v", v), ("q_offset", q_offset),
                    ("kv_len", kv_len)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(
                f"the CUDA kernel takes bfloat16; {name} is {t.dtype}")
        # 16-byte vector loads along D
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"{name} needs unit stride along D and the "
                             f"other strides a multiple of 8: {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    H, D = q.shape[2], q.shape[3]
    if k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if D not in (64, 128):
        raise ValueError(f"head dim {D} not supported (64 or 128)")
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [{B}]")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: torch.Tensor, kv_len: torch.Tensor, *,
                    kv_head_major: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal GQA flash attention; see the module docstring for shapes.

    On CUDA tensors this launches the Hopper kernel (bf16 q/k/v, int32
    ``q_offset``/``kv_len``, D of 64 or 128, any strides with unit stride
    along D) and raises on anything it does not take; on CPU tensors it
    computes :func:`mha_reference`. ``flash_attention.launches`` counts
    kernel launches by phase ("prefill" for T > 1, "decode" for T == 1).
    """
    if q.device.type == "cpu":
        if kv_head_major:
            k, v = k.transpose(1, 2), v.transpose(1, 2)
        return mha_reference(q, k, v, q_offset, kv_len, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, T, H, D = q.shape
    if kv_head_major:
        Hkv, S = k.shape[1], k.shape[2]
        ks = (k.stride(0), k.stride(1), k.stride(2))
        vs = (v.stride(0), v.stride(1), v.stride(2))
    else:
        S, Hkv = k.shape[1], k.shape[2]
        ks = (k.stride(0), k.stride(2), k.stride(1))
        vs = (v.stride(0), v.stride(2), v.stride(1))
    _check_cuda_args(q, k, v, q_offset, kv_len, B, Hkv, S)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    scale = sm_scale if sm_scale is not None else 1.0 / (D**0.5)
    fn = _kernel()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             q_offset.data_ptr(), kv_len.data_ptr(), B, T, H, Hkv, S, D,
             q.stride(0), q.stride(1), q.stride(2), *ks, *vs,
             out.stride(0), out.stride(1), out.stride(2), scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches["decode" if T == 1 else "prefill"] += 1
    return out


flash_attention.launches = Counter()
