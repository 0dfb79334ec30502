"""The port's int8-KV attention on CPU (its plain path) against the JAX
package's: the quantizer bit for bit, the dequantizer, and
quantized_flash_attention against quantized_attention_reference and the
Pallas kernel in interpret mode, on the same numpy inputs (fp32 queries),
with every option.

Tolerances: 2e-5 against the JAX reference (the same fp32 arithmetic, another
summation order); 2e-4 against the interpret-mode kernel, which applies the
scales to score and probability columns instead of to K and V (the tolerance
of the JAX package's own windowed int8 tests).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.ops import quantized_attention as jq  # noqa: E402
from lmcache_tpu_torch.ops import quantized_attention as tq  # noqa: E402

ATOL_REF = 2e-5
ATOL_KERNEL = 2e-4


def _kv(seed, B, S, Hkv, D):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    k[0, 3] = 0.0  # an all-zero token: scale 1/127, symbols 0
    k[-1, 5] *= 40.0  # a token with an outlier
    return k, v


@pytest.mark.parametrize("shape", [(2, 64, 2, 64), (1, 33, 4, 128),
                                   (3, 16, 1, 96)])
def test_quantize_kv_for_cache_equals_jax_bit_for_bit(shape):
    """Symbols and scales equal to the last bit. The JAX function is run
    as written (``jax.disable_jit``): ``absmax / 127`` is a division, then
    ``x / scale``, rounded half to even."""
    k, v = _kv(sum(shape), *shape)
    with jax.disable_jit():
        want = jq.quantize_kv_for_cache(jnp.asarray(k), jnp.asarray(v))
    got = tq.quantize_kv_for_cache(torch.from_numpy(k), torch.from_numpy(v))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].dtype == torch.int8 and got[2].dtype == torch.float32
    assert float(got[2][0, 3]) == np.float32(1.0) / np.float32(127.0)
    assert int(got[0].abs().max()) == 127


@pytest.mark.parametrize("shape", [(2, 64, 2, 64), (1, 33, 4, 128),
                                   (3, 16, 1, 96)])
def test_quantize_kv_for_cache_against_the_compiled_jax_function(shape):
    """Under ``jit`` XLA's CPU backend turns the division by the constant 127
    into a product with its reciprocal, so a scale may sit one fp32 ulp away
    (rtol 2e-7); a symbol may then move by 1 where the value sat on a
    rounding tie, in at most 1 of 10000 symbols."""
    k, v = _kv(sum(shape), *shape)
    want = jq.quantize_kv_for_cache(jnp.asarray(k), jnp.asarray(v))
    got = tq.quantize_kv_for_cache(torch.from_numpy(k), torch.from_numpy(v))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7,
                                   atol=0)
    for g, w in zip(got[:2], want[:2]):
        diff = np.abs(g.numpy().astype(np.int32) - np.asarray(w, np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() <= 1e-4


def test_quantize_bfloat16_input_equals_jax():
    """bf16 K/V, as the model hands them over: both sides widen to fp32
    first, so symbols and scales are equal here too."""
    k, v = _kv(4, 2, 32, 2, 64)
    kb, vb = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    with jax.disable_jit():
        want = jq.quantize_kv_for_cache(
            jnp.asarray(kb.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(vb.float().numpy()).astype(jnp.bfloat16))
    got = tq.quantize_kv_for_cache(kb, vb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dequantize_kv_equals_jax_and_bounds_the_error():
    k, v = _kv(1, 2, 64, 2, 64)
    k_sym, _, k_scale, _ = tq.quantize_kv_for_cache(torch.from_numpy(k),
                                                    torch.from_numpy(v))
    back = tq.dequantize_kv(k_sym, k_scale)
    want = jq.dequantize_kv(jnp.asarray(k_sym.numpy()),
                            jnp.asarray(k_scale.numpy()))
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    bound = np.abs(k).max(axis=(2, 3))[:, :, None, None] / 127.0
    assert (np.abs(back.numpy() - k) <= bound / 2 + 1e-6).all()
    assert tq.dequantize_kv(k_sym, k_scale,
                            torch.bfloat16).dtype == torch.bfloat16


def _case(seed, B, T, H, D, Hkv, S, q_off, kv_len=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    sym = rng.integers(-127, 128, (2, B, S, Hkv, D)).astype(np.int8)
    scale = rng.uniform(0.01, 0.05, (2, B, S)).astype(np.float32)
    q_off = np.asarray(q_off, np.int32)
    kv_len = (q_off + T if kv_len is None
              else np.asarray(kv_len, np.int32))
    return q, sym[0], sym[1], scale[0], scale[1], q_off, kv_len


def _port(arrays, head_major=False, **kw):
    q, ks, vs, ksc, vsc, q_off, kv_len = (torch.from_numpy(a)
                                          for a in arrays)
    if head_major:
        ks, vs = (ks.transpose(1, 2).contiguous(),
                  vs.transpose(1, 2).contiguous())
    kw = {n: torch.from_numpy(np.asarray(a)) if n in ("sinks", "kv_slot")
          else a for n, a in kw.items()}
    return tq.quantized_flash_attention(q, ks, vs, ksc, vsc, q_off, kv_len,
                                        kv_head_major=head_major,
                                        **kw).numpy()


def _jax_both(arrays, block_k=128, **kw):
    args = [jnp.asarray(a) for a in arrays]
    kw = {n: jnp.asarray(a) if n == "sinks" else a for n, a in kw.items()}
    ref = jq.quantized_attention_reference(*args, **kw)
    out = jq.quantized_flash_attention(*args, block_k=block_k,
                                       interpret=True, **kw)
    return np.asarray(ref), np.asarray(out)


OPTIONS = {
    "plain": dict(),
    "window": dict(sliding_window=100),
    "small_window": dict(sliding_window=4),
    "chunked": dict(sliding_window=64, window_kind="chunked"),
    "softcap": dict(sm_scale=0.21, logit_softcap=30.0),
    "sinks": dict(sinks=np.linspace(-2.0, 4.0, 4).astype(np.float32)),
    "all": dict(sliding_window=100, sm_scale=0.21, logit_softcap=30.0,
                sinks=np.linspace(-2.0, 4.0, 4).astype(np.float32)),
}


@pytest.mark.parametrize("head_major", [False, True],
                         ids=["token_major", "head_major"])
@pytest.mark.parametrize("T,q_off", [(1, (400, 229)), (24, (200, 0))],
                         ids=["decode", "prefill"])
@pytest.mark.parametrize("opt", sorted(OPTIONS))
def test_quantized_flash_attention_matches_jax(opt, T, q_off, head_major):
    arrays = _case(len(opt) + T, 2, T, 4, 64, 2, 512, q_off)
    ref, out = _jax_both(arrays, **OPTIONS[opt])
    got = _port(arrays, head_major=head_major, **OPTIONS[opt])
    np.testing.assert_allclose(got, ref, atol=ATOL_REF, rtol=ATOL_REF)
    np.testing.assert_allclose(got, out, atol=ATOL_KERNEL, rtol=ATOL_KERNEL)


def test_options_change_the_result():
    arrays = _case(3, 2, 24, 4, 64, 2, 512, (200, 0))
    plain = _port(arrays)
    for opt in ("window", "chunked", "softcap", "sinks"):
        assert np.abs(_port(arrays, **OPTIONS[opt]) - plain).max() > 1e-3


def test_ragged_kv_len_shorter_than_the_window():
    """kv_len below q_offset + T and below the window."""
    arrays = _case(8, 2, 16, 8, 128, 2, 256, (40, 10), kv_len=(50, 12))
    ref, out = _jax_both(arrays, sliding_window=200)
    got = _port(arrays, sliding_window=200)
    np.testing.assert_allclose(got, ref, atol=ATOL_REF, rtol=ATOL_REF)
    np.testing.assert_allclose(got, out, atol=ATOL_KERNEL, rtol=ATOL_KERNEL)


@pytest.mark.parametrize("W", [None, 48])
def test_kv_slot_reads_one_pool_row(W):
    """Symbols and scales carry a pool of three rows; the one sequence
    attends to row 1."""
    rng = np.random.default_rng(14)
    Bp, T, H, D, Hkv, S, slot = 3, 1, 4, 64, 2, 256, 1
    sym = rng.integers(-127, 128, (2, Bp, Hkv, S, D)).astype(np.int8)
    scale = rng.uniform(0.01, 0.05, (2, Bp, S)).astype(np.float32)
    q = rng.standard_normal((1, T, H, D)).astype(np.float32)
    q_off = np.asarray([200], np.int32)
    kv_len = q_off + T
    ref = jq.quantized_attention_reference(
        jnp.asarray(q),
        jnp.asarray(sym[0, slot:slot + 1].transpose(0, 2, 1, 3)),
        jnp.asarray(sym[1, slot:slot + 1].transpose(0, 2, 1, 3)),
        jnp.asarray(scale[0, slot:slot + 1]),
        jnp.asarray(scale[1, slot:slot + 1]), jnp.asarray(q_off),
        jnp.asarray(kv_len), sliding_window=W)
    out = jq.quantized_flash_attention(
        jnp.asarray(q), jnp.asarray(sym[0]), jnp.asarray(sym[1]),
        jnp.asarray(scale[0]), jnp.asarray(scale[1]), jnp.asarray(q_off),
        jnp.asarray(kv_len), kv_head_major=True, sliding_window=W,
        kv_slot=jnp.asarray([slot], jnp.int32), block_k=128, interpret=True)
    got = tq.quantized_flash_attention(
        torch.from_numpy(q), torch.from_numpy(sym[0]),
        torch.from_numpy(sym[1]), torch.from_numpy(scale[0]),
        torch.from_numpy(scale[1]), torch.from_numpy(q_off),
        torch.from_numpy(kv_len), kv_head_major=True, sliding_window=W,
        kv_slot=torch.tensor([slot], dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_REF,
                               rtol=ATOL_REF)
    np.testing.assert_allclose(got, np.asarray(out), atol=ATOL_KERNEL,
                               rtol=ATOL_KERNEL)


def test_int8_attention_tracks_full_precision_attention():
    from lmcache_tpu_torch.ops import mha_reference
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, 128)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 128, 4, 128)).astype(
        np.float32)) for _ in range(2))
    zero = torch.zeros(1, dtype=torch.int32)
    n = torch.full((1,), 16, dtype=torch.int32)
    fp = mha_reference(q, k, v, zero, n).numpy()
    out = tq.quantized_flash_attention(
        q, *tq.quantize_kv_for_cache(k, v), zero, n).numpy()
    assert np.corrcoef(fp.ravel(), out.ravel())[0, 1] > 0.999
    assert np.abs(fp - out).max() < 0.1


def test_cpu_path_counts_no_kernel_launch():
    before = sum(tq.quantized_flash_attention.launches.values())
    _port(_case(0, 2, 1, 4, 64, 2, 64, (10, 20)))
    assert sum(tq.quantized_flash_attention.launches.values()) == before


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The argument checks run before any launch (no card needed)."""
    from lmcache_tpu_torch.ops import attention as tattn
    q, ks, vs, ksc, vsc, q_off, kv_len = (
        torch.from_numpy(a) for a in _case(0, 2, 8, 4, 64, 2, 64, (10, 20)))
    ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
    qb = q.bfloat16()
    out = torch.empty_like(qb)

    def check(q=qb, ks=ks, vs=vs, ksc=ksc, vsc=vsc):
        a, Hkv, S = tattn.fill_args(q, ks, vs, out, q_off, kv_len, True,
                                    None, k_scale=ksc, v_scale=vsc)
        tattn._check_cuda_args(q, ks, vs, q_off, kv_len, 2, Hkv, S,
                               kv_dtype=torch.int8)
        return a

    a = check()
    assert (a.ksb, a.kss) == (64, 1) and a.k_scale == ksc.data_ptr()
    # a slot view of a [2, B, S] scale pool keeps its own strides
    pool = torch.ones((2, 2, 80))
    a = check(ksc=pool[0, :, :64], vsc=pool[1, :, :64])
    assert (a.vsb, a.vss) == (80, 1)
    with pytest.raises(ValueError, match="bfloat16"):
        check(q=q)
    with pytest.raises(ValueError, match="int8"):
        check(ks=ks.bfloat16(), vs=vs.bfloat16())
    with pytest.raises(ValueError, match="multiple of 16"):
        wide = torch.zeros((2, 2, 64, 72), dtype=torch.int8)
        check(ks=wide[..., :64], vs=wide[..., :64])  # row pitch 72
    with pytest.raises(ValueError, match="k_scale"):
        check(ksc=ksc.double())
    with pytest.raises(ValueError, match="v_scale"):
        check(vsc=vsc[:, :60])
