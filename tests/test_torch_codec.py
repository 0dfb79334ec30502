"""The port's CacheGen coder and quantizer against the JAX package.

The same symbols and CDFs, made from a seed with numpy, go through the
port's plain range encoder and decoder (the CPU path of kernel rows 12 and
11), the JAX package's C++ coder, its ``lax.scan`` decoder and both Pallas
kernels in interpret mode: bytes, lengths and symbols must be equal. The
quantizer, the CDF and the dequantizer must give the JAX functions' bits,
run as written (``jax.disable_jit``) and compiled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmcache_tpu.codec import range_coder as jax_coder
from lmcache_tpu.ops import quant as jax_quant
from lmcache_tpu.ops.range_decode import (decode_streams_device,
                                          decode_streams_pallas)
from lmcache_tpu.ops.range_encode import (encode_streams_pallas,
                                          words_to_payload)
from lmcache_tpu_torch.codec import range_coder
from lmcache_tpu_torch.ops import quant
from lmcache_tpu_torch.ops import range_decode as rd
from lmcache_tpu_torch.ops import range_encode as re_

KINDS = ("uniform", "skewed", "binary", "extreme", "gauss")


def _symbols(kind, S, T, seed=None):
    """The five symbol distributions of tests/test_range_decode.py."""
    rng = np.random.default_rng(seed if seed is not None
                                else KINDS.index(kind) + 17)
    if kind == "uniform":
        return rng.integers(0, 31, (S, T)).astype(np.uint8)
    if kind == "skewed":
        return np.minimum(rng.geometric(0.5, (S, T)) - 1, 30).astype(np.uint8)
    if kind == "binary":
        return ((rng.random((S, T)) < 0.01) * 30).astype(np.uint8)
    if kind == "extreme":
        sym = np.zeros((S, T), np.uint8)
        sym[:, ::97] = 30
        return sym
    return np.clip(np.round(rng.normal(15, 2, (S, T))), 0,
                   30).astype(np.uint8)


def _cdf(sym):
    """Each row's CDF from the JAX quantizer (uint16 [S, 33])."""
    return np.array(jax_quant.compute_cdf(jnp.asarray(sym.T[None])))[0]


def _port_encode(sym, cdf):
    return re_.encode_streams(torch.from_numpy(sym),
                              torch.from_numpy(cdf.view(np.int16)))


def _port_decode(payload, lens, cdf, T):
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return rd.decode_streams(
        torch.from_numpy(np.frombuffer(payload, np.uint8).copy()),
        torch.from_numpy(offsets), torch.from_numpy(cdf.view(np.int16)),
        T).numpy()


@pytest.mark.parametrize("S, T", [(96, 256), (200, 255)],
                         ids=["96x256", "200x255_odd"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_coder_equals_cpp_coder_and_scan_decoder(kind, S, T):
    """Tolerance 0: bytes, lengths and symbols equal the JAX package's C++
    coder's, and its lax.scan decoder's symbols. 200 streams are a multiple
    of no tile (the kernels' 128, the Pallas 1024); 255 symbols fill no
    4-symbol word."""
    sym = _symbols(kind, S, T)
    cdf = _cdf(sym)
    payload, lens = jax_coder.encode_streams(sym, cdf)
    got, got_lens = _port_encode(sym, cdf)
    assert np.array_equal(got_lens, lens)
    assert got.tobytes() == payload
    dec = _port_decode(payload, lens, cdf, T)
    assert np.array_equal(dec, sym)
    assert np.array_equal(dec, jax_coder.decode_streams(payload, lens, T,
                                                        cdf))
    stride = max(16, (int(lens.max()) + 4 + 15) // 16 * 16)
    scan, ovf = decode_streams_device(jax_coder.pad_streams(payload, lens,
                                                            stride),
                                      lens.astype(np.int32), cdf, T)
    assert not bool(np.asarray(ovf))
    assert np.array_equal(np.asarray(scan), dec)


# one shape and one stride for every kind: the Pallas kernels compile once
PALLAS_S, PALLAS_T = 40, 16


@pytest.mark.parametrize("kind", KINDS)
def test_plain_coder_equals_pallas_kernels_in_interpret_mode(kind):
    """Rows 12 and 11 as the TPU kernels compute them (interpret mode, as
    the JAX package's own tests run them on the CPU): the port's plain
    encoder gives their bytes, its plain decoder their symbols."""
    S, T = PALLAS_S, PALLAS_T
    sym = _symbols(kind, S, T)
    cdf = _cdf(sym)
    stride = (re_.out_stride(T) + 3) // 4 * 4
    words, lens, ovf = encode_streams_pallas(sym, cdf, stride,
                                             interpret=True)
    assert not bool(np.asarray(ovf))
    payload, lens64 = words_to_payload(np.asarray(words), np.asarray(lens),
                                       S)
    got, got_lens = _port_encode(sym, cdf)
    assert np.array_equal(got_lens, lens64)
    assert got.tobytes() == payload
    padded = jax_coder.pad_streams(payload, lens64, stride + 16)
    pallas, ovf = decode_streams_pallas(padded, lens64.astype(np.int32),
                                        cdf, T, interpret=True)
    assert not bool(np.asarray(ovf))
    assert np.array_equal(_port_decode(payload, lens64, cdf, T),
                          np.asarray(pallas))


def test_host_coder_copy_equals_the_jax_packages():
    """The port builds its own copy of lmtc_codec.cc: same bytes."""
    sym = _symbols("gauss", 64, 100, seed=3)
    cdf = _cdf(sym)
    assert range_coder.codec_available()
    payload, lens = range_coder.encode_streams(sym, cdf)
    ref, ref_lens = jax_coder.encode_streams(sym, cdf)
    assert payload == ref and np.array_equal(lens, ref_lens)
    assert np.array_equal(range_coder.decode_streams(payload, lens, 100, cdf),
                          sym)
    assert np.array_equal(range_coder.pad_streams(payload, lens, 96),
                          jax_coder.pad_streams(payload, lens, 96))


def test_overflowed_stream_reports_minus_one_and_raises():
    """A CDF with a zero-width bin makes the coder's range collapse: the
    plain encoder, like the C++ coder, reports -1 and the wrapper raises."""
    sym = np.full((3, 64), 5, np.uint8)
    cdf = _cdf(sym)
    cdf[1, 6] = cdf[1, 5]  # symbol 5 of stream 1 gets no width
    out, lens = re_.encode_streams_reference(
        torch.from_numpy(sym), torch.from_numpy(cdf.view(np.int16)))
    assert lens[1] == -1 and lens[0] > 0 and lens[2] > 0
    with pytest.raises(RuntimeError, match="overflow"):
        _port_encode(sym, cdf)
    with pytest.raises(RuntimeError, match="overflow"):
        jax_coder.encode_streams(sym, cdf)


def _collapsing_cdf_case():
    """Stream 0 valid; stream 1's CDF is not monotone (0, 60000, 50, 50,
    ...), so its first symbol decodes to a zero-width bin: the range
    collapses to 0, where the C++ coder would feed zeros forever."""
    sym = _symbols("gauss", 2, 64, seed=4)
    cdf = _cdf(sym)
    payload, lens = jax_coder.encode_streams(sym[:1], cdf[:1])
    bad = np.concatenate([[0, 60000, 50, 50], 60001 + np.arange(29)])
    cdf[1] = bad.astype(np.uint16)
    payload += bytes([0x10, 0x20, 0x30, 0x40, 0x50])
    return sym, cdf, payload, np.array([lens[0], 5])


def test_collapsed_range_ends_the_stream_with_zeros():
    sym, cdf, payload, lens = _collapsing_cdf_case()
    out = _port_decode(payload, lens, cdf, 64)
    assert np.array_equal(out[0], sym[0])
    assert out[1, 0] == 2 and not out[1, 1:].any()


def test_wrappers_take_the_plain_version_on_cpu_only():
    re_.encode_streams_raw.launches.clear()
    rd.decode_streams.launches.clear()
    sym = _symbols("skewed", 8, 32)
    payload, lens = _port_encode(sym, _cdf(sym))
    _port_decode(payload.tobytes(), lens, _cdf(sym), 32)
    assert not re_.encode_streams_raw.launches
    assert not rd.decode_streams.launches
    meta = torch.zeros(1, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        re_.encode_streams_raw(meta.reshape(1, 1),
                               torch.zeros((1, 33), dtype=torch.int16))


# ---------------------------------------------------------------- quant ---

QUANT_SHAPES = [(3, 70, 40), (2, 256, 64), (4, 96, 16), (1, 33, 5)]


def _quant_inputs(L, T, C, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((L, T, C))
         * rng.random((L, T, 1))).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero token (absmax 0)
    bins = np.array([32, 16, 8, 2][:L], np.int32)
    return x, bins


def _jax_quant(x, bins):
    sym, maxes = jax_quant.quantize(jnp.asarray(x), jnp.asarray(bins))
    cdf = jax_quant.compute_cdf(sym)
    deq = jax_quant.dequantize(sym, maxes, jnp.asarray(bins))
    return [np.asarray(a) for a in (sym, maxes, cdf, deq)]


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["as_written", "jit"])
@pytest.mark.parametrize("shape", QUANT_SHAPES,
                         ids=["x".join(map(str, s)) for s in QUANT_SHAPES])
def test_quant_cdf_dequant_bit_equal_to_jax(shape, compiled):
    """Symbols, maxes, CDF tables and dequantized fp32, bit for bit. T of
    70, 96 and 33 make the CDF's pdf inexact in fp32, so the cumulative
    sum's order shows (the port writes out XLA's)."""
    x, bins = _quant_inputs(*shape)
    if compiled:
        want = _jax_quant(x, bins)
    else:
        with jax.disable_jit():
            want = _jax_quant(x, bins)
    sym, maxes = quant.quantize(torch.from_numpy(x), torch.from_numpy(bins))
    cdf = quant.compute_cdf(sym)
    deq = quant.dequantize(sym, maxes, torch.from_numpy(bins))
    assert np.array_equal(sym.numpy(), want[0])
    assert np.array_equal(maxes.numpy().view(np.int32),
                          want[1].view(np.int32))
    assert np.array_equal(quant.cdf_to_numpy(cdf), want[2])
    assert np.array_equal(deq.numpy().view(np.int32), want[3].view(np.int32))
