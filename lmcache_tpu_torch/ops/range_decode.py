"""Range decoding of CacheGen streams on the card (kernel row 11).

Port of ``lmcache_tpu/ops/range_decode.py`` (``decode_streams_device``, the
``lax.scan`` version, and ``decode_streams_pallas``, the TPU kernel). It
decodes S independent streams of ``n_symbols`` symbols, symbol-exact with the
host C++ coder (``codec/csrc/lmtc_codec.cc::decode_stream``).

:func:`decode_streams` launches the hand-written Hopper kernel
(``csrc/range_decode.cu``, one thread a stream) on CUDA tensors and computes
its plain version, :func:`decode_streams_reference`, on CPU tensors. The
streams are passed concatenated, with int64 offsets, as the container holds
them: nothing is padded to a stride. The kernel's renormalization loop has
no bound, so unlike the TPU kernels it has no overflow flag. A stream whose
range collapses to 0, which only a corrupt CDF can do (a non-monotone one
can decode a zero-width bin) and where the C++ coder never returns, decodes
as zeros from there on.

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


_entry = None
# launches of the kernel; the wrapper's ``launches`` attribute is this object
_launches = Counter()


def _load():
    global _entry
    if _entry is None:
        fn = _build.load("range_decode").lmc_range_decode
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, P, P]
        fn.restype = I
        _entry = fn
    return _entry


def decode_streams(payload: torch.Tensor, offsets: torch.Tensor,
                   cdf: torch.Tensor, n_symbols: int) -> torch.Tensor:
    """Decode S range-coded streams -> uint8 [S, n_symbols] on the inputs'
    device; see :func:`decode_streams_reference` for the arguments.

    On CUDA tensors this launches the Hopper kernel (contiguous uint8
    payload, int64 offsets, 33-entry uint16 CDFs as int16 or uint16) and
    raises on anything it does not take; on CPU tensors it computes
    :func:`decode_streams_reference`. ``decode_streams.launches["retrieve"]``
    counts kernel launches."""
    if payload.device.type == "cpu":
        return decode_streams_reference(payload, offsets, cdf, n_symbols)
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
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
    if not 0 < n_symbols < 2**31 or S >= 2**31:
        raise ValueError(f"{S} streams of {n_symbols} symbols")
    out = torch.empty((S, n_symbols), dtype=torch.uint8,
                      device=payload.device)
    if S == 0:
        return out
    err = _load()(payload.data_ptr(), offsets.data_ptr(), cdf.data_ptr(), S,
                  n_symbols, out.data_ptr(),
                  torch.cuda.current_stream(payload.device).cuda_stream)
    if err:
        raise RuntimeError(f"range_decode kernel launch failed: cudaError "
                           f"{err}")
    _launches["retrieve"] += 1
    return out


decode_streams.launches = _launches
