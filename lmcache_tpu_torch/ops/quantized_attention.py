"""Flash attention over an int8-quantized KV buffer, dequantized inside the
kernel: the port of ``lmcache_tpu/ops/quantized_attention.py``.

Per-token symmetric quantization (the CacheGen granularity) keeps the KV
cache in device memory at int8, half the bytes of bf16. The per-token scale
never touches the K/V tiles: dequantizing K multiplies *columns* of the
score matrix and dequantizing V multiplies *columns* of the probability
matrix,

    scores[i, j] = (q_i . k_int_j) * k_scale[j] * sm_scale
    out[i]      += sum_j (p[i, j] * v_scale[j]) * v_int_j

Layouts: ``q [B, T, H, D]``; ``k/v_sym`` int8 ``[B, S, H_kv, D]`` or, with
``kv_head_major=True``, ``[B, H_kv, S, D]`` (the serving pool's layout),
symbols in [-127, 127]; ``k/v_scale`` fp32 ``[B, S]`` (absmax / 127 per
token, shared by all heads).

:func:`quantized_flash_attention` runs the hand-written Hopper kernels
(``csrc/quantized_flash_attention.cu``) on CUDA tensors and its plain
version, :func:`quantized_attention_reference`, on CPU tensors: a launch of
more than ``DECODE_ROWS`` rows (T * G) runs the prefill body
(``csrc/flash_sm90.cuh`` over int8 K/V), one of at most ``DECODE_ROWS``
rows, every decode step, the int8 key-split decode and the combine of
``ops.attention`` (plain version :func:`quantized_split_attention_reference`).
"""

from collections import Counter
from typing import Optional, Tuple

import torch

from lmcache_tpu_torch.ops import attention as _attn
from lmcache_tpu_torch.ops.attention import mha_reference


def quantize_tokens(t: torch.Tensor, dims, reduce_absmax=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization over ``dims`` (the head and
    channel axes): ``scale = absmax / 127`` (1/127 for an all-zero token),
    symbols ``x / scale`` rounded half to even and clipped to +-127. Returns
    (int8 symbols, fp32 scales without ``dims``). Identical to the JAX
    package's quantization, symbol for symbol. ``reduce_absmax`` maps the
    local absmax to the token's whole one where ``t`` holds a head slice
    (``parallel.Axis.max`` over the mesh's "model" axis)."""
    t32 = t.float()
    absmax = t32.abs().amax(dim=dims)
    if reduce_absmax is not None:
        absmax = reduce_absmax(absmax)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        absmax) / 127.0
    sym = torch.round(t32 / scale[(..., ) + (None, ) * len(dims)])
    return torch.clamp(sym, -127, 127).to(torch.int8), scale


def quantize_kv_for_cache(k: torch.Tensor, v: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization of token-major KV buffers:
    ``k, v [B, S, H_kv, D]`` -> (k_sym, v_sym int8, k_scale, v_scale fp32
    ``[B, S]``)."""
    k_sym, k_scale = quantize_tokens(k, (2, 3))
    v_sym, v_scale = quantize_tokens(v, (2, 3))
    return k_sym, v_sym, k_scale, v_scale


def dequantize_kv(sym: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[B, S, H, D]`` int8 + ``[B, S]`` scales -> dense KV."""
    return (sym.float() * scale[:, :, None, None]).to(dtype)


def quantized_attention_reference(q, k_sym, v_sym, k_scale, v_scale,
                                  q_offset, kv_len, sliding_window=None,
                                  sm_scale=None, logit_softcap=None,
                                  window_kind="sliding", sinks=None,
                                  zero_dead_rows=False) -> torch.Tensor:
    """The kernel's plain version (token-major ``k/v_sym [B, S, H_kv, D]``):
    dequantize to fp32, then :func:`mha_reference`."""
    return mha_reference(q, dequantize_kv(k_sym, k_scale),
                         dequantize_kv(v_sym, v_scale), q_offset, kv_len,
                         sm_scale=sm_scale, sliding_window=sliding_window,
                         zero_dead_rows=zero_dead_rows,
                         logit_softcap=logit_softcap,
                         window_kind=window_kind, sinks=sinks)


def quantized_split_partials_reference(q, k_sym, v_sym, k_scale, v_scale,
                                       q_offset, kv_len, sm_scale=None,
                                       sliding_window=None,
                                       window_kind="sliding",
                                       logit_softcap=None):
    """Plain version of the int8 key-split decode's first kernel
    (token-major ``k/v_sym [B, S, H_kv, D]``): the partials of
    :func:`~lmcache_tpu_torch.ops.attention.split_partials_reference` over
    the K/V dequantized to fp32. Where the kernel multiplies a score by its
    key's K scale and P by its key's V scale (after the row sum), this
    multiplies the symbols first: the same function."""
    return _attn.split_partials_reference(
        q, dequantize_kv(k_sym, k_scale), dequantize_kv(v_sym, v_scale),
        q_offset, kv_len, sm_scale=sm_scale, sliding_window=sliding_window,
        window_kind=window_kind, logit_softcap=logit_softcap)


def quantized_split_attention_reference(q, k_sym, v_sym, k_scale, v_scale,
                                        q_offset, kv_len, sm_scale=None,
                                        sliding_window=None,
                                        window_kind="sliding",
                                        logit_softcap=None, sinks=None):
    """The plain split-then-combine of the int8 key-split decode:
    :func:`quantized_split_partials_reference`, then
    :func:`~lmcache_tpu_torch.ops.attention.combine_partials_reference`;
    fp32 ``[B, T, H, D]``, 0 for a row that sees no key."""
    part_o, part_ml = quantized_split_partials_reference(
        q, k_sym, v_sym, k_scale, v_scale, q_offset, kv_len,
        sm_scale=sm_scale, sliding_window=sliding_window,
        window_kind=window_kind, logit_softcap=logit_softcap)
    return _attn.combine_partials_reference(
        part_o, part_ml, q.shape[1], q.shape[2] // k_sym.shape[2],
        sinks=sinks)


def quantized_flash_attention(
        q: torch.Tensor, k_sym: torch.Tensor, v_sym: torch.Tensor,
        k_scale: torch.Tensor, v_scale: torch.Tensor,
        q_offset: torch.Tensor, kv_len: torch.Tensor, *,
        kv_head_major: bool = False,
        sliding_window: Optional[int] = None,
        kv_slot: Optional[torch.Tensor] = None,
        sm_scale: Optional[float] = None,
        logit_softcap: Optional[float] = None,
        window_kind: str = "sliding",
        sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention reading int8 KV directly from device memory: the
    contract and options of :func:`lmcache_tpu_torch.ops.flash_attention`
    over ``(k_sym, v_sym, k_scale, v_scale)`` from
    :func:`quantize_kv_for_cache`. With ``kv_slot`` the symbols and the
    scales carry the whole pool.

    On CUDA tensors this launches the Hopper kernels (bf16 q, int8 symbols
    with a 16-byte aligned base and strides a multiple of 16, fp32 scales
    with any strides, D of 64, 96, 128 or 256) and raises on anything they
    do not take: the prefill body above ``DECODE_ROWS`` rows (T * G), else
    the int8 key-split decode and :func:`combine_partials`' kernel. On CPU
    tensors it computes :func:`quantized_attention_reference`.
    ``quantized_flash_attention.launches`` counts launches by phase
    ("prefill" for T > 1, "decode" for T == 1, "+window", "+softcap" and
    "+sinks" appended under those options); a split decode counts once."""
    _attn.check_options(q, sliding_window, window_kind, logit_softcap, sinks,
                        kv_slot, kv_head_major)
    if q.device.type == "cpu":
        if kv_slot is not None:
            k_sym, v_sym, k_scale, v_scale = (
                _attn.slot_row(t, kv_slot)
                for t in (k_sym, v_sym, k_scale, v_scale))
        if kv_head_major:
            k_sym, v_sym = k_sym.transpose(1, 2), v_sym.transpose(1, 2)
        return quantized_attention_reference(
            q, k_sym, v_sym, k_scale, v_scale, q_offset, kv_len,
            sliding_window=sliding_window, sm_scale=sm_scale,
            logit_softcap=logit_softcap, window_kind=window_kind,
            sinks=sinks)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    a, Hkv, S = _attn.fill_args(q, k_sym, v_sym, out, q_offset, kv_len,
                                kv_head_major, sm_scale, sliding_window,
                                window_kind, logit_softcap, sinks, kv_slot,
                                k_scale, v_scale)
    _attn._check_cuda_args(q, k_sym, v_sym, q_offset, kv_len, B, Hkv, S,
                           kv_dtype=torch.int8,
                           pool_rows=kv_slot is not None)
    if T * (H // Hkv) > _attn.DECODE_ROWS:
        _attn.launch(quantized_flash_attention,
                     _attn.load_entry("quantized_flash_attention",
                                      "lmc_qflash_attention_int8"), a, q, Hkv)
        return out
    _attn.split_decode(
        quantized_flash_attention,
        _attn.split_entry("quantized_flash_attention",
                          "lmc_qflash_decode_split_int8"),
        a, q, Hkv, S, sinks, out)
    return out


quantized_flash_attention.launches = Counter()
