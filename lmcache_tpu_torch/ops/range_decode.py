"""Range decoding of CacheGen streams on the card (kernel row 11).

Port of ``lmcache_tpu/ops/range_decode.py`` (``decode_streams_device``, the
``lax.scan`` version, and ``decode_streams_pallas``, the TPU kernel). It
decodes S independent streams of ``n_symbols`` symbols, symbol-exact with the
host C++ coder (``codec/csrc/lmtc_codec.cc::decode_stream``).

Two entries run the hand-written Hopper kernel (``csrc/range_decode.cu``:
two streams a thread, a 5-step symbol search, payload bytes through
registers) on CUDA tensors:

- :func:`decode_streams` writes the symbols, uint8 [S, n]; its plain
  version, taken for CPU tensors, is :func:`decode_streams_reference`;
- :func:`decode_to_blob` writes the CacheGen serde's dequantized wire blob
  instead, bit-equal with :func:`decode_streams` followed by
  :func:`dequantize_symbols`, which together are its plain version.

The streams are passed concatenated, with int64 offsets, as the container
holds them: nothing is padded to a stride. The kernel's renormalization loop
has no bound, so unlike the TPU kernels it has no overflow flag. A stream
whose range collapses to 0, which only a corrupt CDF can do (a non-monotone
one can decode a zero-width bin) and where the C++ coder never returns,
decodes as zeros from there on.

CDF tables are the container's uint16 bits carried in int16 tensors
(:mod:`lmcache_tpu_torch.ops.quant`).
"""

import ctypes
from collections import Counter

import torch

from lmcache_tpu_torch.ops import _build

_MASK = 0xFFFFFFFF
_TOP = 1 << 24
_BOT = 1 << 16
KERNEL_BINS = 32  # the kernel takes the container's 33-entry CDF only


def _cdf_table(cdf: torch.Tensor) -> torch.Tensor:
    """int64 [S, n_bins + 1] CDF values with the implied 65536 at the
    last index (``lmtc_codec.cc::cdf_at``)."""
    table = cdf.to(torch.int64) & 0xFFFF
    table[:, -1] = 65536
    return table


def renormalize(low, rng, feed, stopped):
    """The coder's carry-less renormalization, vectorized over streams:
    while a stream's ``low`` and ``low + range`` differ in their top byte,
    or its range fell below 2^16 (then clamped to the next 2^16 boundary),
    it shifts out one byte. ``feed(active, low)`` is called once per round
    with the streams that shift (the decoder reads a byte, the encoder
    writes one); streams in ``stopped(rng)`` leave the loop. Returns
    (low, range)."""
    while True:
        run = ~stopped(rng)
        top = (low ^ ((low + rng) & _MASK)) < _TOP
        small = rng < _BOT
        active = run & (top | small)
        if not bool(active.any()):
            return low, rng
        rng = torch.where(active & ~top, (-low) & (_BOT - 1), rng)
        feed(active, low)
        low = torch.where(active, (low << 8) & _MASK, low)
        rng = torch.where(active, (rng << 8) & _MASK, rng)


def decode_streams_reference(payload: torch.Tensor, offsets: torch.Tensor,
                             cdf: torch.Tensor,
                             n_symbols: int) -> torch.Tensor:
    """Plain PyTorch decoder, vectorized over streams: a Python loop over
    symbols and a ``while`` over renormalization rounds, in int64 holding
    the coder's uint32 arithmetic.

    Args:
        payload: uint8 [nbytes], the streams concatenated.
        offsets: int64 [S + 1], stream i is payload[offsets[i]:offsets[i+1]].
        cdf: uint16 bits (int16 or uint16) [S, n_bins + 1].
        n_symbols: symbols per stream.

    Returns uint8 [S, n_symbols].
    """
    dev = payload.device
    S = cdf.shape[0]
    n_bins = cdf.shape[1] - 1
    table = _cdf_table(cdf.to(dev))
    starts = offsets[:-1].to(dev, torch.int64)
    lens = offsets[1:].to(dev, torch.int64) - starts
    # one zero byte past the end keeps every gather in bounds
    buf = torch.cat([payload.reshape(-1).to(torch.int64),
                     torch.zeros(1, dtype=torch.int64, device=dev)])
    pos = torch.zeros(S, dtype=torch.int64, device=dev)
    code = torch.zeros(S, dtype=torch.int64, device=dev)

    def read(active):
        nonlocal pos
        has = active & (pos < lens)
        byte = torch.where(has, buf[torch.where(has, starts + pos, -1)], 0)
        pos = pos + has
        return byte

    everyone = torch.ones(S, dtype=torch.bool, device=dev)
    for _ in range(4):
        code = ((code << 8) | read(everyone)) & _MASK

    def feed(active, low):
        nonlocal code
        code = torch.where(active, ((code << 8) | read(active)) & _MASK,
                           code)

    low = torch.zeros(S, dtype=torch.int64, device=dev)
    rng = torch.full((S,), _MASK, dtype=torch.int64, device=dev)
    dead = torch.zeros(S, dtype=torch.bool, device=dev)
    out = torch.empty((S, n_symbols), dtype=torch.uint8, device=dev)
    for t in range(n_symbols):
        rng = rng // 65536
        target = ((code - low) & _MASK) // torch.clamp(rng, min=1)
        target = torch.clamp(target, max=65535)
        sym = (table[:, 1:n_bins] <= target[:, None]).sum(dim=1)
        out[:, t] = torch.where(dead, 0, sym).to(torch.uint8)
        cf = table.gather(1, sym[:, None])[:, 0]
        cfn = table.gather(1, (sym + 1)[:, None])[:, 0]
        low = (low + cf * rng) & _MASK
        rng = (rng * (cfn - cf)) & _MASK
        low, rng = renormalize(low, rng, feed, lambda r: r == 0)
        # a range of 0 comes only from a corrupt CDF (a decoded zero-width
        # bin), where the C++ coder never returns: the stream decodes as
        # zeros
        dead = dead | (rng == 0)
    return out


_entries = {}
# launches of the kernel by either entry; their ``launches`` attribute is
# this object
_launches = Counter()
_BLOB_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def _load(name):
    if name not in _entries:
        fn = getattr(_build.load("range_decode"), name)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([P, P, P, I, I, P, P] if name == "lmc_range_decode"
                       else [P, P, P, I, P, P] + [I] * 8 + [L] * 4
                       + [P, I, P])
        fn.restype = I
        _entries[name] = fn
    return _entries[name]


def _check_streams(payload, offsets, cdf):
    """The kernel's checks of the coded inputs, shared by both entries."""
    S = cdf.shape[0]
    for name, t, dtypes in (("payload", payload, (torch.uint8,)),
                            ("offsets", offsets, (torch.int64,)),
                            ("cdf", cdf, (torch.int16, torch.uint16))):
        if t.device != payload.device or t.dtype not in dtypes:
            raise ValueError(f"the CUDA kernel takes {name} as "
                             f"{dtypes[0]} on {payload.device}: {t.dtype} "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cdf.dim() != 2 or cdf.shape[1] != KERNEL_BINS + 1:
        raise ValueError(f"the CUDA kernel takes cdf as [S, "
                         f"{KERNEL_BINS + 1}]: {tuple(cdf.shape)}")
    if tuple(offsets.shape) != (S + 1,):
        raise ValueError(f"offsets must be [{S + 1}]: {tuple(offsets.shape)}")
    if S >= 2**31:
        raise ValueError(f"{S} streams")


def _launched(err, what):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    _launches["retrieve"] += 1


def decode_streams(payload: torch.Tensor, offsets: torch.Tensor,
                   cdf: torch.Tensor, n_symbols: int) -> torch.Tensor:
    """Decode S range-coded streams -> uint8 [S, n_symbols] on the inputs'
    device; see :func:`decode_streams_reference` for the arguments.

    On CUDA tensors this launches the Hopper kernel (contiguous uint8
    payload, int64 offsets, 33-entry uint16 CDFs as int16 or uint16) and
    raises on anything it does not take; on CPU tensors it computes
    :func:`decode_streams_reference`. ``decode_streams.launches["retrieve"]``
    counts kernel launches (of both entries)."""
    if payload.device.type == "cpu":
        return decode_streams_reference(payload, offsets, cdf, n_symbols)
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
    _check_streams(payload, offsets, cdf)
    S = cdf.shape[0]
    if not 0 < n_symbols < 2**31:
        raise ValueError(f"{S} streams of {n_symbols} symbols")
    out = torch.empty((S, n_symbols), dtype=torch.uint8,
                      device=payload.device)
    if S == 0:
        return out
    _launched(_load("lmc_range_decode")(
        payload.data_ptr(), offsets.data_ptr(), cdf.data_ptr(), S, n_symbols,
        out.data_ptr(), torch.cuda.current_stream(payload.device).cuda_stream),
        "range_decode")
    return out


decode_streams.launches = _launches


def _blob_shape(L, N, H, D, T_out, hf):
    return (L, N, H, T_out, D) if hf else (L, N, T_out, H, D)


def dequantize_symbols(sym: torch.Tensor, maxes: torch.Tensor,
                       half: torch.Tensor, *, nchunks, L, H, D, T, g, N, hf,
                       dtype, tok_start, tok_stop) -> torch.Tensor:
    """Decoded symbols -> the CacheGen serde's dequantized wire blob, on
    ``sym``'s device (the plain version of :func:`decode_to_blob` after
    :func:`decode_streams`).

    sym: uint8 [nchunks * N * L * Cg, g * T] in coder stream order (chunk,
    half, layer, channel group; symbols: channel in group, token); maxes:
    f32 [nchunks, N, L, T]; half: f32 [N, L] (bins // 2 - 1). Returns
    [L, N, T_out, H, D] (vllm) / [L, N, H, T_out, D] (``hf``) in ``dtype``
    over tokens [tok_start, tok_stop) of the run, computing
    ``(s - half) * max / half`` in fp32 as the JAX package does.
    """
    C = H * D
    Cg = C // g
    x = sym.reshape(nchunks, N, L, Cg, g, T).permute(0, 1, 2, 5, 3, 4)
    x = x.reshape(nchunks, N, L, T, C)
    h = half[None, :, :, None, None]
    x = (x.to(torch.float32) - h) * maxes[..., None] / h
    x = x.permute(2, 1, 0, 3, 4).reshape(L, N, nchunks * T, H, D)
    x = x[:, :, tok_start:tok_stop].to(dtype)
    if hf:
        x = x.transpose(2, 3)
    return x.contiguous()


def decode_to_blob(payload: torch.Tensor, offsets: torch.Tensor,
                   cdf: torch.Tensor, maxes: torch.Tensor,
                   half: torch.Tensor, *, nchunks, L, H, D, T, g, N, hf,
                   dtype, tok_start, tok_stop) -> torch.Tensor:
    """Decode the streams of ``nchunks`` CacheGen chunks and dequantize them
    into the wire blob in one pass; arguments and result as
    :func:`decode_streams` and :func:`dequantize_symbols` (each stream has
    g * T symbols).

    On CUDA tensors this launches the kernel's fused entry (bfloat16,
    float16 or float32 out; maxes and half contiguous float32) and raises
    on anything it does not take; on CPU tensors it computes
    :func:`decode_streams_reference` then :func:`dequantize_symbols`. It
    counts its launches in ``decode_streams.launches["retrieve"]``."""
    geo = dict(nchunks=nchunks, L=L, H=H, D=D, T=T, g=g, N=N, hf=hf,
               dtype=dtype, tok_start=tok_start, tok_stop=tok_stop)
    if payload.device.type == "cpu":
        sym = decode_streams_reference(payload, offsets, cdf, g * T)
        return dequantize_symbols(sym, maxes, half, **geo)
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
    _check_streams(payload, offsets, cdf)
    C = H * D
    if g < 1 or C % g or cdf.shape[0] != nchunks * N * L * (C // g):
        raise ValueError(f"{cdf.shape[0]} streams are not {nchunks} chunks "
                         f"of {N} x {L} x {C} channels in groups of {g}")
    if dtype not in _BLOB_DTYPES:
        raise ValueError(f"the CUDA kernel writes {list(_BLOB_DTYPES)}, "
                         f"not {dtype}")
    for name, t, shape in (("maxes", maxes, (nchunks, N, L, T)),
                           ("half", half, (N, L))):
        if (t.device != payload.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"the CUDA kernel takes {name} as contiguous "
                             f"float32 {list(shape)} on {payload.device}: "
                             f"{t.dtype} {list(t.shape)} on {t.device}")
    if not 0 <= tok_start <= tok_stop <= nchunks * T:
        raise ValueError(f"token window [{tok_start}, {tok_stop}) outside "
                         f"{nchunks * T} tokens")
    T_out = tok_stop - tok_start
    out = torch.empty(_blob_shape(L, N, H, D, T_out, hf), dtype=dtype,
                      device=payload.device)
    S = cdf.shape[0]
    if S == 0 or out.numel() == 0:
        return out
    # strides of the layer, half, token and head axes (a dim's is 1)
    sL, sN = out.stride(0), out.stride(1)
    sT, sH = (out.stride(3), out.stride(2)) if hf else (out.stride(2),
                                                         out.stride(3))
    _launched(_load("lmc_range_decode_blob")(
        payload.data_ptr(), offsets.data_ptr(), cdf.data_ptr(), S,
        maxes.data_ptr(), half.data_ptr(), N, L, H, D, T, g, tok_start,
        tok_stop, sL, sN, sT, sH, out.data_ptr(), _BLOB_DTYPES[dtype],
        torch.cuda.current_stream(payload.device).cuda_stream),
        "range_decode_blob")
    return out
