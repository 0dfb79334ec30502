"""Range encoding of CacheGen streams on the card (kernel row 12).

Port of ``lmcache_tpu/ops/range_encode.py`` (``encode_streams_pallas``, the
TPU kernel). It encodes S independent streams of uint8 symbols, byte-identical
with the host C++ coder (``codec/csrc/lmtc_codec.cc::encode_stream``).

- :func:`encode_streams_raw` launches the hand-written Hopper kernel
  (``csrc/range_encode.cu``, one thread a stream) on CUDA tensors and
  computes its plain version, :func:`encode_streams_reference`, on CPU
  tensors. Each stream is written into its row of a buffer with the C++
  coder's worst-case stride, ``2 * n + 16``; a stream that overflows it
  reports a length of -1.
- :func:`encode_streams` raises on an overflow (as the C++ coder's wrapper
  does), compacts the rows on the tensors' device and copies only the coded
  bytes and the lengths to the host (into pinned memory from the card).

The TPU path's stride estimates and per-entropy-class strides
(``estimate_stride_rows``, ``stride_classes``) and its host fallback on an
overflowed stride have no counterpart: compaction on the card makes them
moot.
"""

import ctypes
from collections import Counter
from typing import Tuple

import numpy as np
import torch

from lmcache_tpu_torch.ops import _build
from lmcache_tpu_torch.ops.range_decode import (_MASK, KERNEL_BINS,
                                                _cdf_table, renormalize)


def out_stride(n_symbols: int) -> int:
    """Bytes a stream may take: the C++ coder's worst case, about two bytes
    a symbol and the 4-byte flush."""
    return 2 * n_symbols + 16


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


_entry = None
# launches of the kernel; the wrapper's ``launches`` attribute is this object
_launches = Counter()


def _load():
    global _entry
    if _entry is None:
        fn = _build.load("range_encode").lmc_range_encode
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, P, I, P, P]
        fn.restype = I
        _entry = fn
    return _entry


def encode_streams_raw(symbols: torch.Tensor, cdf: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode S streams into rows of a buffer on the inputs' device; see
    :func:`encode_streams_reference` for arguments and results (on the card
    the bytes of a row past its length are left unwritten).

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
    stride = out_stride(n)
    if stride >= 2**31 or S >= 2**31:
        raise ValueError(f"{S} streams of {n} symbols")
    out = torch.empty((S, stride), dtype=torch.uint8, device=symbols.device)
    lens = torch.empty(S, dtype=torch.int32, device=symbols.device)
    if S == 0:
        return out, lens
    err = _load()(symbols.data_ptr(), cdf.data_ptr(), S, n, out.data_ptr(),
                  stride, lens.data_ptr(),
                  torch.cuda.current_stream(symbols.device).cuda_stream)
    if err:
        raise RuntimeError(f"range_encode kernel launch failed: cudaError "
                           f"{err}")
    _launches["store"] += 1
    return out, lens


encode_streams_raw.launches = _launches


def compact(out: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The rows' coded bytes concatenated in row order (``out[i, :lens[i]]``
    for every i), on ``out``'s device."""
    cols = torch.arange(out.shape[1], device=out.device)
    return out[cols[None, :] < lens[:, None].to(torch.int64)]


def encode_streams(symbols: torch.Tensor, cdf: torch.Tensor
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Entropy-encode S streams where ``symbols`` lie, as
    ``codec.range_coder.encode_streams`` does on the host.

    Returns (payload uint8 numpy array: the streams' bytes concatenated,
    lens int64 numpy [S]). From the card only these cross to the host, the
    payload into pinned memory. Raises ``RuntimeError`` when a stream
    overflows (a corrupt CDF), as the C++ coder's wrapper does."""
    out, lens = encode_streams_raw(symbols, cdf)
    lens_h = lens.cpu().numpy().astype(np.int64)
    if (lens_h < 0).any():
        raise RuntimeError("range coder overflow (corrupt CDF?)")
    payload = compact(out, lens)
    if payload.is_cuda:
        host = torch.empty(payload.numel(), dtype=torch.uint8,
                           pin_memory=True)
        host.copy_(payload, non_blocking=True)
        torch.cuda.current_stream(payload.device).synchronize()
        payload = host
    return payload.numpy(), lens_h
