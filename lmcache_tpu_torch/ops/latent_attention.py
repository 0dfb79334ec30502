"""Flash attention over the MLA latent cache (DeepSeek-V2/V3): the port of
``lmcache_tpu/ops/latent_attention.py``.

The absorbed-MLA score against token ``s`` is ``q_lat . c_s + q_pe . k_pe_s``
and the value is ``c_s`` itself: both are parts of the same cached latent row
``[c_s ; k_pe_s]`` (``models/mla.py``). With the query concatenated as
``q_full = [q_lat ; q_pe]`` the scores are one product ``q_full @ latents^T``
and the context is ``p @ latents[:, :rank]``, so the kernel reads each latent
tile once for both products, and all H query heads share the one latent
stream: the (head, token) pairs flatten into one axis of score rows.

Shapes: ``q_full [B, T, H, C]`` (C = kv_lora_rank + qk_rope_head_dim),
``latents [B, S, C]`` (one layer of the pool, read in place), int8 latents
with fp32 scales ``[B, S]``; ``q_offset``/``kv_len`` int32 ``[B]``. Query
``t`` of sequence ``b`` sees key positions ``kpos <= min(q_offset[b] + t,
kv_len[b] - 1)``. Out ``[B, T, H, rank]``: the latent-space context, to which
the model applies ``w_kb_v``.

:func:`latent_flash_attention` and :func:`quantized_latent_flash_attention`
run the hand-written Hopper kernel (``csrc/latent_attention.cu``) on CUDA
tensors and their plain versions on CPU tensors; each counts its kernel
launches in ``.launches`` ("prefill" for T > 1, "decode" for T == 1). A row
that sees no key gives 0 from both (the JAX ``*_reference`` functions average
the values uniformly there, as :func:`latent_attention_reference` does unless
``zero_dead_rows``).
"""

import ctypes
from collections import Counter
from typing import Tuple

import torch

from lmcache_tpu_torch.ops import _build
from lmcache_tpu_torch.ops.attention import _NEG_INF
from lmcache_tpu_torch.ops.quantized_attention import quantize_tokens

_SMEM_LIMIT = 232448  # bytes a block may use on sm_90 (227 KB)
DENSE_TILE = 64  # keys per tile of the dense kernel


def latent_attention_reference(q_full, latents, q_offset, kv_len, *, rank,
                               scale, zero_dead_rows=False) -> torch.Tensor:
    """The kernels' plain version, in fp32 with a materialized score matrix:
    ``q_full [B, T, H, C]``, ``latents [B, S, C]`` -> ``[B, T, H, rank]``
    fp32. A row that sees no key averages the values uniformly, as the JAX
    reference does; with ``zero_dead_rows`` it gives 0, as the kernels do."""
    B, T, H, C = q_full.shape
    S = latents.shape[1]
    dev = q_full.device
    lat = latents.float()
    scores = torch.einsum("bthc,bsc->bhts", q_full.float(), lat) * scale
    qpos = q_offset.to(dev)[:, None] + torch.arange(T, device=dev)[None, :]
    kpos = torch.arange(S, device=dev)[None, None, :]
    mask = (kpos <= qpos[:, :, None]) & (kpos < kv_len.to(dev)[:, None, None])
    scores = torch.where(mask[:, None], scores,
                         torch.tensor(_NEG_INF, device=dev))
    out = torch.einsum("bhts,bsr->bthr", torch.softmax(scores, dim=-1),
                       lat[..., :rank])
    if zero_dead_rows:
        out = out * mask.any(dim=-1)[:, :, None, None]
    return out


def quantize_latents(latents: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization of a latent stream:
    ``[..., S, C]`` -> (int8 symbols ``[..., S, C]``, fp32 scales
    ``[..., S]``); ``scale = absmax / 127`` (1/127 for an all-zero token),
    symbols rounded half to even and clipped to +-127, symbol for symbol the
    JAX package's quantization as written."""
    return quantize_tokens(latents, (-1,))


def dequantize_latents(sym: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (sym.float() * scale[..., None]).to(dtype)


def quantized_latent_attention_reference(q_full, lat_sym, lat_scale,
                                         q_offset, kv_len, *, rank, scale,
                                         zero_dead_rows=False
                                         ) -> torch.Tensor:
    """Dequantize to fp32, then :func:`latent_attention_reference`."""
    return latent_attention_reference(
        q_full, dequantize_latents(lat_sym, lat_scale), q_offset, kv_len,
        rank=rank, scale=scale, zero_dead_rows=zero_dead_rows)


# ------------------------------------------------------------ the kernels ---

class LatentArgs(ctypes.Structure):
    """The kernels' argument block (``csrc/latent_common.cuh::LatentArgs``):
    device pointers, sizes and strides in elements."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "kv", "out", "kv_scale", "page_table", "q_offset", "kv_len")]
        + [(n, ctypes.c_int) for n in (
            "T", "H", "C", "r", "S", "NP", "P", "page", "tn")]
        + [("scale", ctypes.c_float)]
        + [(n, ctypes.c_longlong) for n in (
            "qb", "qt", "qh", "kb", "ks", "ob", "ot", "oh", "sb", "ss")])


_entry_points = {}


def load_entry(source: str, symbol: str):
    """The C entry point ``symbol`` of ``csrc/<source>.cu`` (built at first
    use): ``(LatentArgs*, B, BM, stream)``, or for ``*_smem_bytes``
    ``(BM, C, r, tn, stages)``."""
    fn = _entry_points.get(symbol)
    if fn is None:
        fn = getattr(_build.load(source), symbol)
        if symbol.endswith("smem_bytes"):
            fn.argtypes = [ctypes.c_int] * 5
        else:
            fn.argtypes = [ctypes.POINTER(LatentArgs), ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry_points[symbol] = fn
    return fn


def smem_bytes(BM: int, C: int, rank: int, tn: int, stages: int) -> int:
    """Shared memory of one block of the latent kernels, in bytes."""
    return load_entry("latent_attention", "lmc_latent_attention_smem_bytes")(
        BM, C, rank, tn, stages)


def row_block(H: int, T: int, C: int, rank: int, tn: int, stages: int) -> int:
    """Rows of the (head, token) axis per block: 32 where there are more
    than 16 and the block fits shared memory, else 16; raises where neither
    fits."""
    for BM in ((32, 16) if H * T > 16 else (16,)):
        if smem_bytes(BM, C, rank, tn, stages) <= _SMEM_LIMIT:
            return BM
    raise ValueError(f"latent width {C} (rank {rank}) with tiles of {tn} keys "
                     f"needs more than {_SMEM_LIMIT} bytes of shared memory")


def check_cuda_args(q_full, rows, scales, q_offset, kv_len, rank, B):
    """Raise on what the latent kernels do not take: devices, dtypes, widths
    and the 16-byte alignment of their vector loads. ``rows``: the latent
    rows (dense ``[B, S, C']`` or paged ``[P, page, C']``, C' >= C)."""
    dev = q_full.device
    named = [("latents", rows), ("q_offset", q_offset), ("kv_len", kv_len)]
    if scales is not None:
        named.append(("scales", scales))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q_full on {dev}")
    if q_full.dim() != 4 or rows.dim() != 3:
        raise ValueError(f"q_full {tuple(q_full.shape)} must be [B, T, H, C] "
                         f"and the latents {tuple(rows.shape)} 3-d")
    C = q_full.shape[3]
    if C % 16 or rank % 16 or not 0 < rank <= C or rows.shape[2] < C:
        raise ValueError(f"latent width {C} and rank {rank} must be multiples "
                         f"of 16 with rank <= width <= the rows' "
                         f"{rows.shape[2]}")
    row_dtype = torch.int8 if scales is not None else torch.bfloat16
    for name, t, dt in (("q_full", q_full, torch.bfloat16),
                        ("latents", rows, row_dtype)):
        if t.dtype != dt:
            raise ValueError(f"the CUDA kernel takes {name} as "
                             f"{str(dt).split('.')[-1]}; it is {t.dtype}")
        vec = 16 // t.element_size()
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(f"{name} needs unit stride along its last axis "
                             f"and the other strides a multiple of {vec}: "
                             f"{t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != tuple(rows.shape[:2])):
        raise ValueError(f"scales must be float32 {list(rows.shape[:2])}: "
                         f"{scales.dtype} {tuple(scales.shape)}")
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [{B}]")


def fill_args(q_full, rows, scales, out, q_offset, kv_len, scale, tn,
              S) -> LatentArgs:
    """The argument block of one launch (the paged fields left at 0)."""
    B, T, H, C = q_full.shape
    a = LatentArgs()
    a.q, a.kv, a.out = q_full.data_ptr(), rows.data_ptr(), out.data_ptr()
    a.kv_scale = scales.data_ptr() if scales is not None else None
    a.q_offset, a.kv_len = q_offset.data_ptr(), kv_len.data_ptr()
    a.T, a.H, a.C, a.r, a.S, a.tn = T, H, C, out.shape[3], S, tn
    a.scale = scale
    a.qb, a.qt, a.qh = q_full.stride()[:3]
    a.kb, a.ks = rows.stride(0), rows.stride(1)
    a.ob, a.ot, a.oh = out.stride()[:3]
    if scales is not None:
        a.sb, a.ss = scales.stride()
    return a


def launch(wrapper, source, symbol, a, q_full, BM):
    """Launch on q_full's current stream, raise if the launch is refused, and
    add one to ``wrapper.launches`` ("prefill" for T > 1, "decode" for
    T == 1)."""
    err = load_entry(source, symbol)(
        ctypes.byref(a), q_full.shape[0], BM,
        torch.cuda.current_stream(q_full.device).cuda_stream)
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                           f"cudaError {err}")
    wrapper.launches["decode" if q_full.shape[1] == 1 else "prefill"] += 1


def _dense(wrapper, q_full, latents, lat_scale, q_offset, kv_len, rank,
           scale):
    if q_full.device.type == "cpu":
        if lat_scale is None:
            return latent_attention_reference(
                q_full, latents, q_offset, kv_len, rank=rank, scale=scale,
                zero_dead_rows=True)
        return quantized_latent_attention_reference(
            q_full, latents, lat_scale, q_offset, kv_len, rank=rank,
            scale=scale, zero_dead_rows=True)
    if q_full.device.type != "cuda":
        raise ValueError(f"unsupported device {q_full.device}")
    B, T, H, C = q_full.shape
    check_cuda_args(q_full, latents, lat_scale, q_offset, kv_len, rank, B)
    if latents.shape[0] != B or latents.shape[2] != C:
        raise ValueError(f"latents {tuple(latents.shape)} do not fit q_full "
                         f"{tuple(q_full.shape)}")
    BM = row_block(H, T, C, rank, DENSE_TILE, 1)
    out = torch.empty((B, T, H, rank), dtype=q_full.dtype,
                      device=q_full.device)
    a = fill_args(q_full, latents, lat_scale, out, q_offset, kv_len, scale,
                  DENSE_TILE, latents.shape[1])
    kind = "bf16" if lat_scale is None else "int8"
    launch(wrapper, "latent_attention", f"lmc_latent_attention_{kind}", a,
           q_full, BM)
    return out


def latent_flash_attention(q_full: torch.Tensor, latents: torch.Tensor,
                           q_offset: torch.Tensor, kv_len: torch.Tensor, *,
                           rank: int, scale: float) -> torch.Tensor:
    """Absorbed-MLA attention over the dense latent pool; see the module
    docstring. On CUDA tensors this launches ``latent_fwd<BM, bf16>`` (bf16
    q_full and latents, C and rank multiples of 16, any strides with unit
    stride along C) and raises on anything it does not take; on CPU tensors
    it computes :func:`latent_attention_reference` (fp32). Returns
    ``[B, T, H, rank]`` in q_full's dtype on the card."""
    return _dense(latent_flash_attention, q_full, latents, None, q_offset,
                  kv_len, rank, scale)


def quantized_latent_flash_attention(q_full: torch.Tensor,
                                     lat_sym: torch.Tensor,
                                     lat_scale: torch.Tensor,
                                     q_offset: torch.Tensor,
                                     kv_len: torch.Tensor, *, rank: int,
                                     scale: float) -> torch.Tensor:
    """:func:`latent_flash_attention` over an int8 latent pool (symbols
    ``[B, S, C]``, fp32 scales ``[B, S]``): the tile is converted to bf16
    (exact) and the per-token scale multiplies the score and probability
    columns. On CUDA tensors: ``latent_fwd<BM, int8>``."""
    return _dense(quantized_latent_flash_attention, q_full, lat_sym,
                  lat_scale, q_offset, kv_len, rank, scale)


latent_flash_attention.launches = Counter()
quantized_latent_flash_attention.launches = Counter()
