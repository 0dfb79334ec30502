"""The port's CacheGen coder and quantizer against the JAX package.

The same symbols and CDFs, made from a seed with numpy, go through the
port's plain range encoder and decoder (the CPU path of kernel rows 12 and
11), the JAX package's C++ coder, its ``lax.scan`` decoder and both Pallas
kernels in interpret mode: bytes, lengths and symbols must be equal. The
encoder's exclusive scan and compaction (the CPU path of row 12's copy
kernel) must give the JAX coder's stream boundaries and payload, and the
fused decode and dequantization (``range_decode.decode_to_blob``, the CPU
path of row 11's blob entry) the blob of the JAX serde's
``_symbols_to_blob_jit`` over the Pallas decoder's symbols, bit for bit.
The quantizer, the CDF and the dequantizer must give the JAX functions'
bits, run as written (``jax.disable_jit``) and compiled.
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
from lmcache_tpu.storage.serde.cachegen_serde import _symbols_to_blob_jit
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


def _offsets(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


@pytest.mark.parametrize("kind", KINDS)
def test_scan_and_compaction_give_the_jax_coders_payload(kind):
    """The plain encoder's rows, scanned and compacted, are the JAX
    package's coded payload: each stream at its offset, nothing between."""
    sym = _symbols(kind, PALLAS_S, PALLAS_T)
    cdf = _cdf(sym)
    payload, lens = jax_coder.encode_streams(sym, cdf)
    out, got_lens = re_.encode_streams_reference(
        torch.from_numpy(sym), torch.from_numpy(cdf.view(np.int16)))
    offsets = re_.exclusive_scan(got_lens)
    assert offsets.dtype == torch.int64
    assert np.array_equal(offsets.numpy(), _offsets(lens)[:-1])
    got = re_.compact(out, got_lens, offsets, int(got_lens.sum()))
    assert got.numpy().tobytes() == payload
    host, host_lens = _port_encode(sym, cdf)
    assert host.tobytes() == payload and np.array_equal(host_lens, lens)


# (nchunks, N, L, H, D, T, g), each stream g * T = PALLAS_T symbols: K/V
# blobs of full chunks (one channel a stream) and of short chunks (g 2), and
# an MLA latent blob (N 1, g 4, one head of 24 latent channels)
BLOB_GEOMETRIES = {
    "kv_g1": (3, 2, 2, 2, 8, 16, 1),
    "kv_g2": (2, 2, 2, 2, 8, 8, 2),
    "latent_g4": (2, 1, 3, 1, 24, 4, 4),
}
# (fmt, dtype, token window as (start, cut from the end))
BLOB_OUTPUTS = [("vllm", "bfloat16", (0, 0)),
                ("huggingface", "float32", (0, 0)),
                ("vllm", "float32", (3, 5)),
                ("huggingface", "bfloat16", (5, 1))]
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _blob_streams(name):
    """Symbols of one geometry in coder stream order (chunk, half, layer,
    group), each plane within its layer's bins; their maxes and halves."""
    nchunks, N, L, H, D, T, g = BLOB_GEOMETRIES[name]
    Cg = H * D // g
    rng = np.random.default_rng(len(name))
    bins = rng.choice([8, 16, 32], (N, L))
    planes = [rng.integers(0, bins[(p // L) % N, p % L] - 1,
                           (Cg, PALLAS_T))
              for p in range(nchunks * N * L)]
    sym = np.concatenate(planes).astype(np.uint8)
    maxes = (rng.random((nchunks, N, L, T)) * 4).astype(np.float32)
    half = (bins // 2 - 1).astype(np.float32)
    return sym, maxes, half


def _pallas_batches(sym):
    """CDFs of ``sym``'s rows and their coding by the JAX C++ coder, and
    the Pallas decoder's symbols (interpret mode), with every JAX call at
    the Pallas test's shape, PALLAS_S streams (the last batch padded with
    empty streams): the compiles are that test's."""
    cdf, payload, lens, dec = [], [], [], []
    stride = (re_.out_stride(PALLAS_T) + 3) // 4 * 4 + 16
    for i in range(0, len(sym), PALLAS_S):
        part = sym[i:i + PALLAS_S]
        k = len(part)
        c = _cdf(np.concatenate(
            [part, np.zeros((PALLAS_S - k, PALLAS_T), np.uint8)]))
        p, n = jax_coder.encode_streams(part, c[:k])
        n_pad = np.concatenate([n, np.zeros(PALLAS_S - k, n.dtype)])
        out, ovf = decode_streams_pallas(
            jax_coder.pad_streams(p, n_pad, stride),
            n_pad.astype(np.int32), c, PALLAS_T, interpret=True)
        assert not bool(np.asarray(ovf))
        cdf.append(c[:k])
        payload.append(p)
        lens.append(n)
        dec.append(np.asarray(out)[:k])
    return (np.concatenate(cdf), b"".join(payload), np.concatenate(lens),
            np.concatenate(dec))


@pytest.fixture(scope="module")
def blob_coded():
    """Every geometry's streams coded by the JAX package's coder and
    decoded by its Pallas decoder in interpret mode."""
    out = {}
    for name in BLOB_GEOMETRIES:
        sym, maxes, half = _blob_streams(name)
        cdf, payload, lens, pallas = _pallas_batches(sym)
        assert np.array_equal(pallas, sym)
        out[name] = (payload, lens, cdf, maxes, half, pallas)
    return out


def _jax_blob(sym, maxes, half, geo, fmt, dtype, window):
    nchunks, N, L, H, D, T, g = geo
    return np.asarray(_symbols_to_blob_jit()(
        jnp.asarray(sym), jnp.asarray(maxes), jnp.asarray(half),
        nchunks=nchunks, L=L, H=H, D=D, T=T, g=g, N=N, fmt=fmt,
        dtype_name=dtype, tok_start=window[0], tok_stop=window[1]))


def _bits(x):
    """The values' bit patterns (a torch tensor or a JAX result)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    return torch.from_numpy(np.array(x).view(
        np.int16 if x.itemsize == 2 else np.int32))


def _blob_args(payload, lens, cdf, maxes, half):
    return (torch.from_numpy(np.frombuffer(payload, np.uint8).copy()),
            torch.from_numpy(_offsets(lens)),
            torch.from_numpy(cdf.view(np.int16)), torch.from_numpy(maxes),
            torch.from_numpy(half))


@pytest.mark.parametrize(
    "out", BLOB_OUTPUTS,
    ids=[f"{f}_{d}_{w[0]}_{w[1]}" for f, d, w in BLOB_OUTPUTS])
@pytest.mark.parametrize("name", BLOB_GEOMETRIES)
def test_fused_decode_gives_the_jax_serdes_blob(blob_coded, name, out):
    """decode_to_blob's plain version (CPU tensors) against the JAX serde's
    blob over the Pallas decoder's symbols: vllm and hf, bf16 and fp32,
    whole runs and token windows cut at both ends."""
    fmt, dtype, (start, cut) = out
    payload, lens, cdf, maxes, half, pallas_sym = blob_coded[name]
    geo = BLOB_GEOMETRIES[name]
    nchunks, N, L, H, D, T, g = geo
    window = (start, nchunks * T - cut)
    want = _jax_blob(pallas_sym, maxes, half, geo, fmt, dtype, window)
    got = rd.decode_to_blob(
        *_blob_args(payload, lens, cdf, maxes, half), nchunks=nchunks, L=L,
        H=H, D=D, T=T, g=g, N=N, hf=fmt == "huggingface",
        dtype=TORCH_DTYPES[dtype], tok_start=window[0], tok_stop=window[1])
    assert got.shape == want.shape and got.dtype == TORCH_DTYPES[dtype]
    assert torch.equal(_bits(got), _bits(want))


def test_fused_decode_of_a_collapsed_stream_ends_in_zeros(blob_coded):
    """A stream whose CDF does not rise decodes a zero-width bin and
    collapses the range (where the C++ coder never returns): the plain
    fused decode writes symbol 0's value for the rest of its channel, as
    the JAX serde's blob of those symbols holds."""
    payload, lens, cdf, maxes, half, sym = blob_coded["kv_g1"]
    geo = BLOB_GEOMETRIES["kv_g1"]
    nchunks, N, L, H, D, T, g = geo
    # stream 5's bytes and CDF: its first target, 4128, falls in the
    # zero-width bin 2
    cdf = cdf.copy()
    cdf[5] = np.concatenate([[0, 60000, 50, 50], 60001 + np.arange(29)])
    offsets = _offsets(lens)
    payload = (payload[:offsets[5]] + bytes([0x10, 0x20, 0x30, 0x40, 0x50])
               + payload[offsets[6]:])
    lens = lens.copy()
    lens[5] = 5
    args = _blob_args(payload, lens, cdf, maxes, half)
    got = rd.decode_to_blob(
        *args, nchunks=nchunks, L=L, H=H, D=D, T=T, g=g, N=N, hf=False,
        dtype=torch.float32, tok_start=0, tok_stop=nchunks * T)
    dec = rd.decode_streams_reference(*args[:3], PALLAS_T).numpy()
    assert dec[5, 0] == 2 and not dec[5, 1:].any()
    assert np.array_equal(np.delete(dec, 5, 0), np.delete(sym, 5, 0))
    want = _jax_blob(dec, maxes, half, geo, "vllm", "float32",
                     (0, nchunks * T))
    assert torch.equal(_bits(got), _bits(want))
    # stream 5 is chunk 0, K, layer 0, channel 5
    h0 = half[0, 0]
    assert np.array_equal(got[0, 0, 1:T, 0, 5].numpy(),
                          (0 - h0) * maxes[0, 0, 0, 1:] / h0)


def test_new_entries_take_the_plain_version_on_cpu_only(blob_coded):
    re_.compact.launches.clear()
    rd.decode_streams.launches.clear()
    payload, lens, cdf, maxes, half, _ = blob_coded["latent_g4"]
    nchunks, N, L, H, D, T, g = BLOB_GEOMETRIES["latent_g4"]
    out = torch.zeros((2, 4), dtype=torch.uint8)
    assert re_.compact(out, torch.tensor([1, 3], dtype=torch.int32)).numel() \
        == 4
    args = _blob_args(payload, lens, cdf, maxes, half)
    geo = dict(nchunks=nchunks, L=L, H=H, D=D, T=T, g=g, N=N, hf=False,
               dtype=torch.bfloat16, tok_start=0, tok_stop=nchunks * T)
    rd.decode_to_blob(*args, **geo)
    assert not re_.compact.launches and not rd.decode_streams.launches
    with pytest.raises(ValueError, match="unsupported device"):
        rd.decode_to_blob(args[0].to("meta"), *args[1:], **geo)


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
