"""CacheGen quantization: per-(layer, token) absmax quantization with
per-layer bin counts, the per-stream symbol CDF, and dequantization.

Port of ``lmcache_tpu/ops/quant.py`` (plain jnp there, so plain torch ops
here, on whatever device the input lies). Every function gives the JAX
function's bits on equal inputs, and the same bits on the CPU and the card:

- each step is one exactly rounded fp32 operation in the JAX order
  (``round(x * (half / safe)) + half``, ``(s - half) * max / half``);
  ``torch.round`` rounds half to even, as ``jnp.round`` does;
- the CDF's division by the stream length divides by a tensor, never by a
  Python scalar, which CUDA would turn into a product with its reciprocal;
- the CDF's cumulative sum over the 32 bins is written out in the order
  XLA's CPU backend uses for ``jnp.cumsum`` on a 32-wide axis (fp32,
  sequential within each block of 16, the first block's total added to the
  second block's prefixes), not ``torch.cumsum``, whose order differs
  between the CPU (an fp64 accumulator) and the card.

uint16 CDF tables are carried in int16 tensors of the same bits (torch's
uint16 supports few operations); :func:`cdf_to_numpy` views them back.
"""

import numpy as np
import torch

MAX_BINS = 32  # fixed CDF width (reference: value_range=32)
_CUMSUM_BLOCK = 16


def _half(bins: torch.Tensor, device) -> torch.Tensor:
    """bins // 2 - 1 as fp32 [L, 1, 1]."""
    bins = torch.as_tensor(bins, device=device)
    return (bins // 2 - 1).to(torch.float32)[:, None, None]


def quantize(x: torch.Tensor, bins):
    """Quantize ``x [L, T, C]`` with per-layer ``bins [L]``.

    Returns (symbols uint8 [L, T, C], maxes f32 [L, T, 1])."""
    x = x.to(torch.float32)
    half = _half(bins, x.device)
    absmax = x.abs().amax(dim=-1, keepdim=True)
    safe = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax)
    sym = torch.round(x * (half / safe)) + half
    sym = torch.minimum(torch.clamp(sym, min=0.0), 2.0 * half)
    return sym.to(torch.uint8), absmax


def dequantize(symbols: torch.Tensor, maxes: torch.Tensor,
               bins) -> torch.Tensor:
    """Inverse of :func:`quantize` -> f32 [L, T, C]."""
    half = _half(bins, symbols.device)
    centered = symbols.to(torch.float32) - half
    return centered * maxes / half


def _cumsum_bins(pdf: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis in XLA's CPU order (see the
    module docstring): blocks of 16, each summed left to right in fp32."""
    out = torch.empty_like(pdf)
    carry = None
    for b0 in range(0, pdf.shape[-1], _CUMSUM_BLOCK):
        acc = torch.zeros_like(pdf[..., 0])
        for i in range(b0, min(b0 + _CUMSUM_BLOCK, pdf.shape[-1])):
            acc = acc + pdf[..., i]
            out[..., i] = acc if carry is None else carry + acc
        carry = out[..., i].clone()
    return out


def stream_cdf(streams: torch.Tensor,
               max_bins: int = MAX_BINS) -> torch.Tensor:
    """Empirical CDF of each row of ``streams`` (uint8 [S, n]) -> the
    uint16 bits as int16 [S, max_bins + 1]: cdf[:, 0] == 0, strictly
    increasing, final bound 65536 stored as 0. One bincount over (stream,
    symbol) pairs gives the histogram."""
    S, n = streams.shape
    idx = (torch.arange(S, device=streams.device,
                        dtype=torch.int32)[:, None] * max_bins
           + streams.to(torch.int32)).reshape(-1)
    counts = torch.bincount(idx, minlength=S * max_bins).to(
        torch.float32).reshape(S, max_bins)
    pdf = counts / torch.tensor(float(n), device=streams.device)
    cdf_f = torch.cat([torch.zeros_like(pdf[:, :1]), _cumsum_bins(pdf)],
                      dim=-1)
    scale = float(2**16 - max_bins)
    cdf_i = torch.round(cdf_f * scale).to(torch.int32) + torch.arange(
        max_bins + 1, dtype=torch.int32, device=streams.device)
    return cdf_i.to(torch.int16)  # 65536 wraps to 0, as in uint16


def compute_cdf(symbols: torch.Tensor,
                max_bins: int = MAX_BINS) -> torch.Tensor:
    """Per-(layer, channel) empirical CDF of ``symbols [L, T, C]``.

    Returns the uint16 bits as int16 [L, C, max_bins + 1] with
    cdf[..., 0] == 0, strictly increasing, and an implied final bound of
    65536 (stored mod 2^16)."""
    L, T, C = symbols.shape
    streams = symbols.transpose(1, 2).reshape(L * C, T)
    return stream_cdf(streams, max_bins).reshape(L, C, max_bins + 1)


def cdf_to_numpy(cdf: torch.Tensor) -> np.ndarray:
    """A CDF table as the numpy uint16 array the container holds."""
    return cdf.cpu().numpy().view(np.uint16)
