"""Range encoding of CacheGen streams on the card (kernel row 12).

Port of ``lmcache_tpu/ops/range_encode.py`` (``encode_streams_pallas``, the
TPU kernel). It encodes S independent streams of uint8 symbols, byte-identical
with the host C++ coder (``codec/csrc/lmtc_codec.cc::encode_stream``).

- :func:`encode_streams_raw` launches the hand-written Hopper kernel
  (``csrc/range_encode.cu``: two streams a thread, symbols read 16 at a
  time, coded bytes stored 16 at a time) on CUDA tensors and
  computes its plain version, :func:`encode_streams_reference`, on CPU
  tensors. Each stream is written into its row of a staging buffer; a
  stream that overflows the C++ coder's worst case, ``2 * n + 16`` bytes,
  reports a length of -1.
- :func:`compact` concatenates the rows' coded bytes: on CUDA tensors a
  second kernel of the same source copies each row's bytes to its offset
  (an exclusive scan of the lengths), reading only coded bytes.
- :func:`encode_streams` raises on an overflow (as the C++ coder's wrapper
  does), compacts on the tensors' device and copies only the coded bytes
  and the lengths to the host, from the card into pinned memory.

The TPU path's stride estimates and per-entropy-class strides
(``estimate_stride_rows``, ``stride_classes``) and its host fallback on an
overflowed stride have no counterpart: compaction on the card makes them
moot.
"""

import ctypes
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from lmcache_tpu_torch.ops import _build
from lmcache_tpu_torch.ops.range_decode import (_MASK, KERNEL_BINS,
                                                _cdf_table, renormalize)


def out_stride(n_symbols: int) -> int:
    """Bytes a stream may take: the C++ coder's worst case, about two bytes
    a symbol and the 4-byte flush."""
    return 2 * n_symbols + 16


def row_stride(n_symbols: int) -> int:
    """Bytes between rows of the kernel's staging buffer: the worst case
    rounded up to the 16-byte stores."""
    return (out_stride(n_symbols) + 15) // 16 * 16


def encode_streams_reference(symbols: torch.Tensor, cdf: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch encoder, vectorized over streams: a Python loop over
    symbols and a ``while`` over renormalization rounds, in int64 holding
    the coder's uint32 arithmetic.

    Args:
        symbols: uint8 [S, n].
        cdf: uint16 bits (int16 or uint16) [S, n_bins + 1].

    Returns (out uint8 [S, 2n + 16], lens int32 [S]): stream i's bytes are
    out[i, :lens[i]]; lens[i] is -1 if the stream overflowed its row.
    """
    dev = symbols.device
    S, n = symbols.shape
    n_bins = cdf.shape[1] - 1
    stride = out_stride(n)
    table = _cdf_table(cdf.to(dev))
    out = torch.zeros((S, stride), dtype=torch.uint8, device=dev)
    rows = torch.arange(S, device=dev)
    pos = torch.zeros(S, dtype=torch.int64, device=dev)
    ovf = torch.zeros(S, dtype=torch.bool, device=dev)

    def emit(active, low):
        nonlocal pos, ovf
        ovf = ovf | (active & (pos >= stride))
        put = active & ~ovf
        out[rows[put], pos[put]] = (low[put] >> 24).to(torch.uint8)
        pos = pos + put

    low = torch.zeros(S, dtype=torch.int64, device=dev)
    rng = torch.full((S,), _MASK, dtype=torch.int64, device=dev)
    for t in range(n):
        s = symbols[:, t].to(torch.int64)
        cf = table.gather(1, torch.clamp(s, max=n_bins)[:, None])[:, 0]
        cfn = table.gather(1, torch.clamp(s + 1, max=n_bins)[:, None])[:, 0]
        rng = rng // 65536
        low = (low + cf * rng) & _MASK
        rng = (rng * (cfn - cf)) & _MASK
        low, rng = renormalize(low, rng, emit, lambda r: ovf)
    everyone = torch.ones(S, dtype=torch.bool, device=dev)
    for _ in range(4):
        emit(everyone, low)
        low = (low << 8) & _MASK
    lens = torch.where(ovf, -1, pos).to(torch.int32)
    return out, lens


_entries = {}
# launches of the kernels; each wrapper's ``launches`` attribute is its own
_launches = Counter()
_compact_launches = Counter()


def _load(name):
    if name not in _entries:
        lib = _build.load("range_encode")
        P, I = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, name)
        fn.argtypes = ([P, P, I, I, P, I, I, P, P]
                       if name == "lmc_range_encode" else
                       [P, I, P, P, I, P, P])
        fn.restype = I
        _entries[name] = fn
    return _entries[name]


def encode_streams_raw(symbols: torch.Tensor, cdf: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode S streams into rows of a buffer on the inputs' device; see
    :func:`encode_streams_reference` for arguments and results (on the card
    the rows are :func:`row_stride` bytes apart and their bytes past a
    stream's length are undefined).

    On CUDA tensors this launches the Hopper kernel (contiguous uint8
    symbols, 33-entry uint16 CDFs as int16 or uint16) and raises on anything
    it does not take; on CPU tensors it computes
    :func:`encode_streams_reference`. ``encode_streams_raw.launches["store"]``
    counts kernel launches."""
    if symbols.device.type == "cpu":
        return encode_streams_reference(symbols, cdf)
    if symbols.device.type != "cuda":
        raise ValueError(f"unsupported device {symbols.device}")
    S, n = symbols.shape
    for name, t, dtypes in (("symbols", symbols, (torch.uint8,)),
                            ("cdf", cdf, (torch.int16, torch.uint16))):
        if t.device != symbols.device or t.dtype not in dtypes:
            raise ValueError(f"the CUDA kernel takes {name} as "
                             f"{dtypes[0]} on {symbols.device}: {t.dtype} "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(cdf.shape) != (S, KERNEL_BINS + 1):
        raise ValueError(f"the CUDA kernel takes cdf as [{S}, "
                         f"{KERNEL_BINS + 1}]: {tuple(cdf.shape)}")
    stride = row_stride(n)
    if stride >= 2**31 or S >= 2**31:
        raise ValueError(f"{S} streams of {n} symbols")
    out = torch.empty((S, stride), dtype=torch.uint8, device=symbols.device)
    lens = torch.empty(S, dtype=torch.int32, device=symbols.device)
    if S == 0:
        return out, lens
    err = _load("lmc_range_encode")(
        symbols.data_ptr(), cdf.data_ptr(), S, n, out.data_ptr(), stride,
        out_stride(n), lens.data_ptr(),
        torch.cuda.current_stream(symbols.device).cuda_stream)
    if err:
        raise RuntimeError(f"range_encode kernel launch failed: cudaError "
                           f"{err}")
    _launches["store"] += 1
    return out, lens


encode_streams_raw.launches = _launches


def exclusive_scan(lens: torch.Tensor) -> torch.Tensor:
    """int64 offsets of the streams in the payload: the exclusive scan of
    their lengths."""
    return torch.cumsum(lens, 0, dtype=torch.int64) - lens


def compact_reference(out: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`compact`: the bytes of every row below its
    length, gathered through a mask over the whole buffer."""
    cols = torch.arange(out.shape[1], device=out.device)
    return out[cols[None, :] < lens[:, None].to(torch.int64)]


def compact(out: torch.Tensor, lens: torch.Tensor,
            offsets: Optional[torch.Tensor] = None,
            total: Optional[int] = None) -> torch.Tensor:
    """The rows' coded bytes concatenated in row order (``out[i, :lens[i]]``
    for every i, no length -1), on ``out``'s device.

    On CUDA tensors the copy kernel of ``csrc/range_encode.cu`` writes each
    row's bytes at ``offsets`` (:func:`exclusive_scan` of ``lens``, computed
    here when not given) into a payload of ``total`` bytes (read
    from the card when not given); on CPU tensors this computes
    :func:`compact_reference`. ``compact.launches["store"]`` counts kernel
    launches."""
    if out.device.type == "cpu":
        return compact_reference(out, lens)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    S = out.shape[0]
    if lens.dtype != torch.int32 or lens.device != out.device:
        raise ValueError(f"the copy kernel takes lens as int32 on "
                         f"{out.device}: {lens.dtype} on {lens.device}")
    if not (out.is_contiguous() and lens.is_contiguous()):
        raise ValueError("out and lens must be contiguous")
    if offsets is None:
        offsets = exclusive_scan(lens)
    if total is None:
        total = int(lens.sum()) if S else 0
    payload = torch.empty(total, dtype=torch.uint8, device=out.device)
    if S == 0 or total == 0:
        return payload
    err = _load("lmc_range_compact")(
        out.data_ptr(), out.shape[1], lens.data_ptr(), offsets.data_ptr(), S,
        payload.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        raise RuntimeError(f"range_compact kernel launch failed: cudaError "
                           f"{err}")
    _compact_launches["store"] += 1
    return payload


compact.launches = _compact_launches

def encode_streams(symbols: torch.Tensor, cdf: torch.Tensor
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Entropy-encode S streams where ``symbols`` lie, as
    ``codec.range_coder.encode_streams`` does on the host.

    Returns (payload uint8 numpy array: the streams' bytes concatenated,
    lens int64 numpy [S]). From the card only these cross to the host: one
    read of the lengths, then the compacted payload into pinned memory
    (PyTorch's caching host allocator reuses its blocks across calls).
    Raises ``RuntimeError`` when a stream overflows (a corrupt CDF), as the
    C++ coder's wrapper does."""
    out, lens = encode_streams_raw(symbols, cdf)
    if not out.is_cuda:
        lens_h = lens.numpy().astype(np.int64)
        if (lens_h < 0).any():
            raise RuntimeError("range coder overflow (corrupt CDF?)")
        return compact_reference(out, lens).numpy(), lens_h
    offsets = exclusive_scan(lens)
    lens_h = lens.cpu().numpy().astype(np.int64)
    if (lens_h < 0).any():
        raise RuntimeError("range coder overflow (corrupt CDF?)")
    total = int(lens_h.sum())
    payload = compact(out, lens, offsets, total)
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    host.copy_(payload, non_blocking=True)
    torch.cuda.current_stream(payload.device).synchronize()
    return host.numpy(), lens_h
