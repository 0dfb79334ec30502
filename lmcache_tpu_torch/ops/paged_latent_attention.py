"""Paged attention over the MLA latent cache (DeepSeek-V2/V3): the port of
``lmcache_tpu/ops/paged_latent_attention.py``.

The paged engine's arena (pages allocated on demand, shared prefixes,
preemption) over the latent cache: a page is ``[page_size, Cp]`` latent rows
with no head axis. The kernels are :mod:`~lmcache_tpu_torch.ops.latent_attention`'s
single-read MQA formulation over rows read through the page table, on the
same Hopper body (``csrc/latent_sm90.cuh``: blocks of 64 (token, head) rows,
TMA boxes of page pieces, wgmma), in ``csrc/paged_latent_attention.cu``:

- :func:`paged_latent_attention` / :func:`quantized_paged_latent_attention`:
  one page per step, the tile is the page (row 9);
- :func:`paged_latent_attention_dma` /
  :func:`quantized_paged_latent_attention_dma`: tiles of ``STREAM_TILE``
  keys streamed across the page slots through a ring of TMA loads (row 10);
  launches of at most ``SPLIT_ROWS`` rows (T * H, every decode step at
  H <= 128) run the key-split decode, partials over splits of
  :func:`split_keys` keys and then :func:`combine_partials`. The names
  are the JAX package's; on the GPU the "dma" is TMA.

Shapes: ``q_full [B, T, H, C]``; ``latent_pool [P, page, Cp]`` (one layer of
the arena, read in place) with ``Cp >= C``: the kernels and the plain
versions read the first C columns of a row, the same function as the JAX
entry points, which zero-pad the query to Cp (the arena's pad columns are
zero); int8 arenas carry fp32 scale pools ``[P, page]``; ``page_table int32
[B, NP]``; ``q_offset``/``kv_len int32 [B]``. Page-table entries past a
sequence's live pages may be any id: they are masked, not read; a live
entry outside the pool reads as zeros on the card. Out ``[B, T, H, rank]``.

CUDA tensors go to the kernels, which raise on what they do not take; CPU
tensors go to the plain versions. A query that sees no key gives 0 on both
(the JAX ``*_reference`` functions average the values uniformly there, as
the plain versions here do unless ``zero_dead_rows``). Each entry point
counts its kernel launches in ``.launches`` ("prefill" for T > 1, "decode"
for T == 1; a split decode once, and once under :func:`combine_partials`).
"""

import ctypes
import math
from collections import Counter

import torch

from lmcache_tpu_torch.ops import attention as _attn
from lmcache_tpu_torch.ops import latent_attention as _lat
from lmcache_tpu_torch.ops.attention import _NEG_INF
from lmcache_tpu_torch.ops.latent_attention import latent_attention_reference

STREAM_TILE = 32  # keys a tile of row 10 (csrc/paged_latent_attention.cu)
# row 10's key-split decode: launches of at most SPLIT_ROWS rows (two row
# blocks of the body) split each sequence's keys at absolute multiples of
# LATENT_SPLIT_KEYS (a multiple of STREAM_TILE) keys a row block of 64 rows
SPLIT_ROWS = 128
LATENT_SPLIT_KEYS = 256
_ROW_BLOCK = 64

def box_rows(tile: int, page: int) -> int:
    """Rows of one TMA box: the largest divisor of the tile that also
    divides the page, so that a box never crosses a page."""
    return math.gcd(tile, page)


def takes_split(T: int, H: int) -> bool:
    """Whether a row-10 launch of T tokens and H heads runs the split
    decode."""
    return T * H <= SPLIT_ROWS


def split_keys(T: int, H: int) -> int:
    """Keys a split of a launch of T * H rows: ``LATENT_SPLIT_KEYS`` for
    each row block of 64, so that a split's fp32 partials (4 * rank bytes a
    row, written and read once more) stay below its latent bytes at H 128
    as at H 16. It depends on the launch's shape, never on its batch."""
    return LATENT_SPLIT_KEYS * -(-T * H // _ROW_BLOCK)


def n_splits(S: int, split: int = LATENT_SPLIT_KEYS) -> int:
    """Splits of ``split`` keys over ``S = NP * page`` key slots: sized from
    the table's width alone (never from ``kv_len``, which lives on the
    device); at least one partial is written."""
    return max(1, -(-S // split))


def split_ranges(S: int, lo: int, hi: int, split: int = LATENT_SPLIT_KEYS):
    """The live splits of a row that sees keys ``[lo, hi]`` of ``S`` slots:
    ``[(split index, first key, last key)]`` at absolute multiples of
    ``split``; every other split gives the row an empty partial."""
    hi = min(hi, S - 1)
    if lo > hi:
        return []
    return [(s, max(lo, s * split), min(hi, (s + 1) * split - 1))
            for s in range(lo // split, hi // split + 1)]


def _gather(pool, page_table, C):
    """[P, page, Cp] arena -> [B, NP * page, C] rows of each sequence."""
    B, NP = page_table.shape
    page = pool.shape[1]
    return pool[page_table.long()][..., :C].reshape(B, NP * page, C)


def paged_latent_attention_reference(q_full, latent_pool, page_table,
                                     q_offset, kv_len, *, rank, scale,
                                     zero_dead_rows=False) -> torch.Tensor:
    """Gather the pages densely, then
    :func:`~lmcache_tpu_torch.ops.latent_attention.latent_attention_reference`
    (fp32): the plain version of :func:`paged_latent_attention` and
    :func:`paged_latent_attention_dma`."""
    lat = _gather(latent_pool, page_table, q_full.shape[3])
    return latent_attention_reference(q_full, lat, q_offset, kv_len,
                                      rank=rank, scale=scale,
                                      zero_dead_rows=zero_dead_rows)


def _dequantized(sym_pool, scale_pool, page_table, C):
    B, NP = page_table.shape
    page = sym_pool.shape[1]
    sym = _gather(sym_pool, page_table, C).float()
    s = scale_pool[page_table.long()].reshape(B, NP * page)
    return sym * s[..., None]


def quantized_paged_latent_attention_reference(q_full, sym_pool, scale_pool,
                                               page_table, q_offset, kv_len,
                                               *, rank, scale,
                                               zero_dead_rows=False
                                               ) -> torch.Tensor:
    """Dequantize the gathered pages to fp32, then dense latent attention:
    the plain version of the two int8 entry points."""
    lat = _dequantized(sym_pool, scale_pool, page_table, q_full.shape[3])
    return latent_attention_reference(q_full, lat, q_offset, kv_len,
                                      rank=rank, scale=scale,
                                      zero_dead_rows=zero_dead_rows)


def paged_latent_split_partials_reference(q_full, latent_pool, page_table,
                                          q_offset, kv_len, *, rank, scale,
                                          scale_pool=None):
    """Plain version of the latent split decode's first kernel: for every
    row f = t * H + h (token-major, as the kernel flattens them) and every
    split of ``split_keys(T, H)`` key slots, the partial ``(m, l, O)`` of
    the online softmax over the row's live keys in the split, unnormalized,
    in fp32 (int8 arenas with ``scale_pool``: the rows dequantized).
    Returns ``part_o [B, n, R, rank]`` and ``part_ml [B, n, R, 2]`` with
    ``n = n_splits(NP * page, split_keys(T, H))`` and R = T * H; a split
    with no live key gives ``m = -1e30, l = 0, O = 0``."""
    B, T, H, C = q_full.shape
    dev = q_full.device
    if scale_pool is None:
        lat = _gather(latent_pool, page_table, C).float()
    else:
        lat = _dequantized(latent_pool, scale_pool, page_table, C)
    S = lat.shape[1]
    R = T * H
    scores = torch.einsum("brc,bsc->brs", q_full.float().reshape(B, R, C),
                          lat) * scale
    qpos = (q_offset.to(dev)[:, None]
            + torch.arange(T, device=dev).repeat_interleave(H)[None])
    kpos = torch.arange(S, device=dev)[None, None]
    mask = (kpos <= qpos[..., None]) & (kpos < kv_len.to(dev)[:, None, None])
    split = split_keys(T, H)
    n = n_splits(S, split)
    pad = n * split - S
    scores = torch.nn.functional.pad(scores, (0, pad)).reshape(
        B, R, n, split)
    mask = torch.nn.functional.pad(mask, (0, pad)).reshape(B, R, n, split)
    v = torch.nn.functional.pad(lat[..., :rank], (0, 0, 0, pad)).reshape(
        B, n, split, rank)
    masked = torch.where(mask, scores, torch.tensor(_NEG_INF, device=dev))
    m = masked.amax(dim=-1)  # [B, R, n]
    p = torch.where(mask, torch.exp(masked - m[..., None]),
                    torch.zeros((), device=dev))
    part_o = torch.einsum("brnk,bnkd->bnrd", p, v)
    part_ml = torch.stack([m, p.sum(dim=-1)], dim=-1).permute(0, 2, 1, 3)
    return part_o.contiguous(), part_ml.contiguous()


def combine_partials_reference(part_o, part_ml, T: int, H: int):
    """Plain version of the latent split decode's combine: the partials of
    each row (``part_o [B, n, R, rank]``, ``part_ml [B, n, R, 2]``,
    R = T * H) merged over the splits, partials with ``l = 0`` skipped.
    Returns fp32 ``[B, T, H, rank]``; a row with no live key gives 0. (Row
    1's combine with one KV head of H query heads.)"""
    return _attn.combine_partials_reference(part_o[:, None],
                                            part_ml[:, None], T, H)


def paged_latent_split_attention_reference(q_full, latent_pool, page_table,
                                           q_offset, kv_len, *, rank, scale,
                                           scale_pool=None) -> torch.Tensor:
    """The plain split-then-combine of row 10's decode:
    :func:`paged_latent_split_partials_reference`, then
    :func:`combine_partials_reference`; fp32 ``[B, T, H, rank]``, 0 for a
    row that sees no key. Equal to the paged plain versions with
    ``zero_dead_rows`` up to fp32 rounding."""
    part_o, part_ml = paged_latent_split_partials_reference(
        q_full, latent_pool, page_table, q_offset, kv_len, rank=rank,
        scale=scale, scale_pool=scale_pool)
    return combine_partials_reference(part_o, part_ml, q_full.shape[1],
                                      q_full.shape[2])


# ------------------------------------------------------------ the kernels ---

_SOURCE = "paged_latent_attention"


def _sizes_entry(symbol: str, nargs: int):
    return _lat.load_entry(_SOURCE, symbol, [ctypes.c_int] * nargs)


def _stream_entry(kind: str):
    """Row 10's entry point ``(LatentArgs*, B, nsplit, stream)``; raises
    where the library's tile is not ``STREAM_TILE``."""
    symbol = f"lmc_paged_latent_stream_attention_{kind}"
    if (symbol not in _lat._entry_points and
            _sizes_entry("lmc_paged_latent_stream_tile", 0)() != STREAM_TILE):
        raise RuntimeError(f"csrc/{_SOURCE}.cu tiles row 10 otherwise than "
                           f"STREAM_TILE")
    return _lat.load_entry(
        _SOURCE, symbol,
        [ctypes.POINTER(_lat.LatentArgs), ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p])


def _combine_entry():
    return _lat.load_entry(
        _SOURCE, "lmc_paged_latent_combine_partials",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
        + [ctypes.c_void_p])


def max_page(quant: bool) -> int:
    """The largest page row 9 takes (its tile is the page, a multiple of
    16): the largest whose ring of one stage fits a block's shared memory
    in the built kernel (112 for bf16 rows, 80 for int8 at every preset's
    widths)."""
    return _sizes_entry("lmc_paged_latent_max_page", 1)(int(quant))


def combine_partials(part_o: torch.Tensor, part_ml: torch.Tensor, T: int,
                     H: int) -> torch.Tensor:
    """The latent split decode's combine (see
    :func:`combine_partials_reference` for the shapes): bf16
    ``[B, T, H, rank]``. On CUDA tensors this launches the combine kernel of
    ``csrc/paged_latent_attention.cu`` (fp32 contiguous partials) and raises
    on anything it does not take; on CPU tensors it computes
    :func:`combine_partials_reference`. ``combine_partials.launches`` counts
    launches by phase."""
    B, n, R, r = part_o.shape
    if R != T * H or tuple(part_ml.shape) != (B, n, R, 2):
        raise ValueError(f"partials {tuple(part_o.shape)} and "
                         f"{tuple(part_ml.shape)} do not hold T {T} x H {H} "
                         f"rows")
    if part_o.device.type == "cpu":
        return combine_partials_reference(part_o, part_ml, T,
                                          H).to(torch.bfloat16)
    for name, t in (("part_o", part_o), ("part_ml", part_ml)):
        if (t.device != part_o.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"the CUDA kernel takes {name} as contiguous "
                             f"float32 on {part_o.device}")
    out = torch.empty((B, T, H, r), dtype=torch.bfloat16,
                      device=part_o.device)
    _combine(part_o, part_ml, T, H, out)
    return out


def _combine(part_o, part_ml, T, H, out):
    """Launch the combine kernel on arguments already checked, and count it
    under :func:`combine_partials`."""
    B, n, _, r = part_o.shape
    _lat.check_error(combine_partials, _combine_entry()(
        part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(), B, T, H, r, n,
        out.stride(0), out.stride(1), out.stride(2),
        torch.cuda.current_stream(part_o.device).cuda_stream))
    _lat.count_launch(combine_partials, T)


combine_partials.launches = Counter()


def _split_decode(wrapper, a, q_full, kind, S, out):
    """Row 10's key-split decode (arguments checked and ``a`` filled): the
    partials into one fp32 scratch allocation, then the combine writes
    ``out``; counted once under ``wrapper``."""
    B, T, H, _ = q_full.shape
    r = out.shape[3]
    split = split_keys(T, H)
    n = n_splits(S, split)
    rows = B * n * T * H
    scratch = torch.empty(rows * (r + 2), dtype=torch.float32,
                          device=q_full.device)
    part_o = scratch[:rows * r].view(B, n, T * H, r)
    part_ml = scratch[rows * r:].view(B, n, T * H, 2)
    a.part_o, a.part_ml = part_o.data_ptr(), part_ml.data_ptr()
    a.split = split
    _lat.check_error(wrapper, _stream_entry(kind)(
        ctypes.byref(a), B, n,
        torch.cuda.current_stream(q_full.device).cuda_stream))
    _combine(part_o, part_ml, T, H, out)
    _lat.count_launch(wrapper, T)


def _paged(wrapper, stream, q_full, pool, scales, page_table, q_offset,
           kv_len, rank, scale):
    if q_full.device.type == "cpu":
        if scales is None:
            return paged_latent_attention_reference(
                q_full, pool, page_table, q_offset, kv_len, rank=rank,
                scale=scale, zero_dead_rows=True)
        return quantized_paged_latent_attention_reference(
            q_full, pool, scales, page_table, q_offset, kv_len, rank=rank,
            scale=scale, zero_dead_rows=True)
    if q_full.device.type != "cuda":
        raise ValueError(f"unsupported device {q_full.device}")
    B, T, H, C = q_full.shape
    _lat.check_cuda_args(q_full, pool, scales, q_offset, kv_len, rank, B)
    if (page_table.device != q_full.device or page_table.dtype != torch.int32
            or page_table.dim() != 2 or page_table.shape[0] != B
            or not page_table.is_contiguous()):
        raise ValueError(f"page_table must be contiguous int32 [{B}, NP] on "
                         f"{q_full.device}")
    if C > _lat.MAX_WIDTH or rank > _lat.MAX_RANK:
        raise ValueError(f"latent width {C} and rank {rank}: the kernel "
                         f"takes at most {_lat.MAX_WIDTH} and "
                         f"{_lat.MAX_RANK}")
    quant = scales is not None
    P, page = pool.shape[:2]
    NP = page_table.shape[1]
    if stream:
        tile = STREAM_TILE
    else:
        most = max_page(quant)
        if page % 16 or page > most:
            raise ValueError(f"page size {page} must be a multiple of 16 "
                             f"and at most {most}: the page is the tile")
        tile = page
    out = torch.empty((B, T, H, rank), dtype=q_full.dtype,
                      device=q_full.device)
    a = _lat.fill_args(q_full, pool, scales, out, q_offset, kv_len, scale,
                       NP * page)
    a.page_table = page_table.data_ptr()
    a.NP, a.P, a.page = NP, P, page
    a.box = box_rows(tile, page)
    kind = "int8" if quant else "bf16"
    if not stream:
        _lat.launch(wrapper, _SOURCE, f"lmc_paged_latent_attention_{kind}", a,
                    q_full)
    elif takes_split(T, H):
        _split_decode(wrapper, a, q_full, kind, NP * page, out)
    else:
        _lat.check_error(wrapper, _stream_entry(kind)(
            ctypes.byref(a), B, 1,
            torch.cuda.current_stream(q_full.device).cuda_stream))
        _lat.count_launch(wrapper, T)
    return out


def paged_latent_attention(q_full, latent_pool, page_table, q_offset, kv_len,
                           *, rank: int, scale: float) -> torch.Tensor:
    """Absorbed-MLA attention over a paged latent arena, one page per step;
    see the module docstring. On CUDA tensors: the Hopper body with the page
    as its tile (bf16, page a multiple of 16 up to :func:`max_page`);
    on CPU tensors :func:`paged_latent_attention_reference`."""
    return _paged(paged_latent_attention, False, q_full, latent_pool, None,
                  page_table, q_offset, kv_len, rank, scale)


def quantized_paged_latent_attention(q_full, sym_pool, scale_pool,
                                     page_table, q_offset, kv_len, *,
                                     rank: int, scale: float) -> torch.Tensor:
    """:func:`paged_latent_attention` over an int8 arena (symbols
    ``[P, page, Cp]``, fp32 scales ``[P, page]``; page at most 80). On CUDA
    tensors: the body over int8 rows, converted to bf16 on the chip."""
    return _paged(quantized_paged_latent_attention, False, q_full, sym_pool,
                  scale_pool, page_table, q_offset, kv_len, rank, scale)


def paged_latent_attention_dma(q_full, latent_pool, page_table, q_offset,
                               kv_len, *, rank: int,
                               scale: float) -> torch.Tensor:
    """:func:`paged_latent_attention` with the live page slots streamed in
    tiles of ``STREAM_TILE`` keys; same contract, any page size. On CUDA
    tensors: the Hopper body, and at most ``SPLIT_ROWS`` rows the key-split
    decode and :func:`combine_partials`."""
    return _paged(paged_latent_attention_dma, True, q_full, latent_pool,
                  None, page_table, q_offset, kv_len, rank, scale)


def quantized_paged_latent_attention_dma(q_full, sym_pool, scale_pool,
                                         page_table, q_offset, kv_len, *,
                                         rank: int,
                                         scale: float) -> torch.Tensor:
    """:func:`quantized_paged_latent_attention` with streamed tiles (any page
    size) and the split decode at most ``SPLIT_ROWS`` rows."""
    return _paged(quantized_paged_latent_attention_dma, True, q_full,
                  sym_pool, scale_pool, page_table, q_offset, kv_len, rank,
                  scale)


for _entry in (paged_latent_attention, quantized_paged_latent_attention,
               paged_latent_attention_dma,
               quantized_paged_latent_attention_dma):
    _entry.launches = Counter()
del _entry
