"""The port's four paged-attention entry points on CPU (their plain
versions) against the JAX package's ``*_reference`` functions and its Pallas
kernels in interpret mode, on the same numpy inputs (fp32).

Tolerances: ``ATOL_REF`` against the references (the same arithmetic in
another framework), ``ATOL_INTERPRET`` against the Pallas kernels (online
softmax in another summation order)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.ops import paged_attention as jpa  # noqa: E402
from lmcache_tpu_torch.ops import paged_attention as tpa  # noqa: E402


# every test of this file on one torch thread (an autouse fixture)
from torch_test_helpers import one_torch_thread  # noqa: E402,F401


ATOL_REF = 2e-5
ATOL_INTERPRET = 2e-3

B, HKV, G = 2, 2, 2
# (T, page, NP, q_offset, kv_len)
SCENARIOS = {
    "decode": (1, 16, 5, [70, 10], [71, 11]),
    "prefill_over_prefix": (40, 16, 6, [40, 0], [80, 40]),
    "ragged": (8, 32, 3, [0, 30], [5, 38]),
}
TABLES = {
    # distinct pages per sequence: scattered over the pool, or a run
    "fragmented": lambda NP: np.asarray(
        [[3 + 2 * j for j in range(NP)], [2 + 2 * j for j in range(NP)]]),
    "consecutive": lambda NP: np.asarray(
        [list(range(1, NP + 1)), list(range(NP + 1, 2 * NP + 1))]),
}
# entry point of the port -> (JAX kernel, int8 arena)
KERNELS = {
    "paged_attention": (jpa.paged_attention, False),
    "quantized_paged_attention": (jpa.quantized_paged_attention, True),
    "paged_attention_dma": (jpa.paged_attention_dma, False),
    "quantized_paged_attention_dma": (jpa.quantized_paged_attention_dma,
                                      True),
}


def _inputs(scenario, table, D, quant, seed=0):
    T, page, NP, q_off, kv_len = SCENARIOS[scenario]
    rng = np.random.default_rng(seed)
    P = 2 * NP + 3
    q = rng.standard_normal((B, T, G * HKV, D)).astype(np.float32)
    if quant:
        pools = [rng.integers(-127, 128, (P, HKV, page, D)).astype(np.int8)
                 for _ in range(2)]
        pools += [rng.uniform(0.01, 0.05, (P, page)).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.standard_normal((P, HKV, page, D)).astype(np.float32)
                 for _ in range(2)]
    return [q, *pools, TABLES[table](NP).astype(np.int32),
            np.asarray(q_off, np.int32), np.asarray(kv_len, np.int32)]


def _port(name, arrays, **kw):
    out = getattr(tpa, name)(*[torch.from_numpy(a) for a in arrays], **kw)
    return out.numpy()


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_matches_jax_reference(name, scenario, table, D, window):
    quant = KERNELS[name][1]
    arrays = _inputs(scenario, table, D, quant)
    jref = (jpa.quantized_paged_attention_reference if quant
            else jpa.paged_attention_reference)
    ref = jref(*[jnp.asarray(a) for a in arrays], sliding_window=window)
    np.testing.assert_allclose(_port(name, arrays, sliding_window=window),
                               np.asarray(ref), atol=ATOL_REF, rtol=ATOL_REF)


# the Pallas kernels in interpret mode, as tests/test_paged.py and
# tests/test_paged_coalesce.py run them; block_q=16 makes the 40-token
# prefill a multi-block one. The _dma kernels take D 64 and 128 only.
_DECODE = ("decode", "fragmented")
_PREFILL = ("prefill_over_prefix", "consecutive")
_RAGGED = ("ragged", "fragmented")
INTERPRET_CASES = [
    ("paged_attention", 96, 24, *_DECODE),
    ("paged_attention", 64, None, *_PREFILL),
    ("paged_attention", 128, 24, *_RAGGED),
    ("quantized_paged_attention", 96, 24, *_PREFILL),
    ("quantized_paged_attention", 128, None, *_DECODE),
    ("quantized_paged_attention", 64, 24, *_RAGGED),
    ("paged_attention_dma", 64, 24, *_DECODE),
    ("paged_attention_dma", 128, None, *_PREFILL),
    ("paged_attention_dma", 64, None, *_RAGGED),
    ("quantized_paged_attention_dma", 64, 24, *_PREFILL),
    ("quantized_paged_attention_dma", 128, None, *_DECODE),
]


@pytest.mark.parametrize("name, D, window, scenario, table", INTERPRET_CASES)
def test_matches_jax_pallas_interpret(name, D, window, scenario, table):
    jkernel, quant = KERNELS[name]
    arrays = _inputs(scenario, table, D, quant, seed=1)
    out = jkernel(*[jnp.asarray(a) for a in arrays], sliding_window=window,
                  block_q=16, interpret=True)
    np.testing.assert_allclose(_port(name, arrays, sliding_window=window),
                               np.asarray(out), atol=ATOL_INTERPRET,
                               rtol=ATOL_INTERPRET)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_row_without_a_live_key_gives_zero(name):
    """``kv_len == 0``: the port gives 0 (as its kernels and the Pallas
    kernels do; the JAX reference averages V there), and the other sequence
    is untouched."""
    jkernel, quant = KERNELS[name]
    arrays = _inputs("ragged", "fragmented", 64, quant, seed=2)
    arrays[-1] = np.asarray([0, 38], np.int32)
    out = _port(name, arrays)
    assert (out[0] == 0).all()
    assert np.abs(out[1]).max() > 0
    if not quant:  # the int8 kernels share these bodies' live-page logic
        pallas = jkernel(*[jnp.asarray(a) for a in arrays], interpret=True)
        np.testing.assert_allclose(out, np.asarray(pallas),
                                   atol=ATOL_INTERPRET, rtol=ATOL_INTERPRET)


def test_sm_scale_and_dead_table_entries():
    """A custom score scale; table entries past the live pages may name any
    page (here the null page 0) without changing the result."""
    arrays = _inputs("decode", "fragmented", 64, False, seed=3)
    ref = jpa.paged_attention_reference(*[jnp.asarray(a) for a in arrays],
                                        sm_scale=0.07)
    arrays[3][1, 1:] = 0  # sequence 1 has 11 tokens: one live page of 16
    for name in ("paged_attention", "paged_attention_dma"):
        np.testing.assert_allclose(_port(name, arrays, sm_scale=0.07),
                                   np.asarray(ref), atol=ATOL_REF,
                                   rtol=ATOL_REF)


def test_cpu_path_counts_no_kernel_launch():
    for name, (_, quant) in KERNELS.items():
        entry = getattr(tpa, name)
        before = sum(entry.launches.values())
        _port(name, _inputs("decode", "fragmented", 64, quant))
        assert sum(entry.launches.values()) == before


# the options of Gemma-2 (softcap), GPT-OSS (sinks) and Llama-4 (chunks of
# 24 keys over pages of 16: a chunk boundary inside a page)
OPTIONS = {
    "softcap": lambda H: dict(logit_softcap=2.0, sliding_window=24),
    "sinks": lambda H: dict(sinks=np.linspace(-1.0, 2.0, H).astype(
        np.float32), sliding_window=24),
    "chunked": lambda H: dict(sliding_window=24, window_kind="chunked"),
}


def _option_kw(option, to):
    kw = OPTIONS[option](G * HKV)
    if "sinks" in kw:
        kw["sinks"] = to(kw["sinks"])
    return kw


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_options_match_jax_reference(name, option):
    """Each option against the JAX reference, over the 40-token prefill
    over a prefix (the scores softcapped before the mask; the sinks joined
    to the normalization; 24-key chunks, whose boundaries fall inside the
    16-key pages)."""
    quant = KERNELS[name][1]
    arrays = _inputs("prefill_over_prefix", "fragmented", 64, quant, seed=4)
    jref = (jpa.quantized_paged_attention_reference if quant
            else jpa.paged_attention_reference)
    ref = jref(*[jnp.asarray(a) for a in arrays],
               **_option_kw(option, jnp.asarray))
    np.testing.assert_allclose(
        _port(name, arrays, **_option_kw(option, torch.from_numpy)),
        np.asarray(ref), atol=ATOL_REF, rtol=ATOL_REF)


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("name", ["paged_attention",
                                  "quantized_paged_attention"])
def test_options_match_jax_pallas_interpret(name, option):
    """Each option against the one-page-per-step Pallas kernels (rows 4 and
    5) in interpret mode, at D 96 over the ragged batch."""
    jkernel, quant = KERNELS[name]
    arrays = _inputs("ragged", "fragmented", 96, quant, seed=5)
    out = jkernel(*[jnp.asarray(a) for a in arrays], block_q=16,
                  interpret=True, **_option_kw(option, jnp.asarray))
    np.testing.assert_allclose(
        _port(name, arrays, **_option_kw(option, torch.from_numpy)),
        np.asarray(out), atol=ATOL_INTERPRET, rtol=ATOL_INTERPRET)


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_split_options_match_jax_reference(quant, option):
    """The paged split decode's plain split-then-combine with each option
    (the window and softcap on the scores, the sinks at the combine) equals
    the JAX reference at a decode step."""
    arrays = _inputs("decode", "fragmented", 64, quant, seed=6)
    jref = (jpa.quantized_paged_attention_reference if quant
            else jpa.paged_attention_reference)
    ref = jref(*[jnp.asarray(a) for a in arrays],
               **_option_kw(option, jnp.asarray))
    split = (tpa.quantized_paged_split_attention_reference if quant
             else tpa.paged_split_attention_reference)
    out = split(*[torch.from_numpy(a) for a in arrays],
                **_option_kw(option, torch.from_numpy))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_REF,
                               rtol=ATOL_REF)


def test_cuda_wrapper_refuses_what_the_kernels_do_not_take():
    """The argument checks run before any launch (no card needed)."""
    q, kp, vp, table, q_off, kv_len = (
        torch.from_numpy(a)
        for a in _inputs("decode", "fragmented", 96, False))

    def check(q=q, kp=kp, vp=vp, ks=None, vs=None, table=table, q_off=q_off,
              dims=tpa._GRID_HEAD_DIMS):
        tpa._check_cuda_args(q, kp, vp, ks, vs, table, q_off, kv_len, dims)

    with pytest.raises(ValueError, match="bfloat16"):
        check()
    qb, kb, vb = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    check(q=qb, kp=kb, vp=vb)
    with pytest.raises(ValueError, match="head dim 96"):
        check(q=qb, kp=kb, vp=vb, dims=tpa._STREAM_HEAD_DIMS)
    with pytest.raises(ValueError, match="unit stride"):
        wide = torch.zeros((*kb.shape[:3], 192), dtype=torch.bfloat16)
        check(q=qb, kp=wide[..., ::2], vp=wide[..., ::2])
    with pytest.raises(ValueError, match="multiple of H_kv"):
        check(q=qb[:, :, :3], kp=kb, vp=vb)
    with pytest.raises(ValueError, match="int32"):
        check(q=qb, kp=kb, vp=vb, table=table.long())
    with pytest.raises(ValueError, match="int32"):
        check(q=qb, kp=kb, vp=vb, q_off=q_off.long())
    with pytest.raises(ValueError, match="multiple of 16"):
        check(q=qb, kp=kb[:, :, :8], vp=vb[:, :, :8])
    # int8 pools: 16 symbols per 16-byte load, fp32 scale rows
    ki = torch.zeros(kb.shape, dtype=torch.int8)
    sc = torch.ones((kb.shape[0], kb.shape[2]))
    check(q=qb, kp=ki, vp=ki, ks=sc, vs=sc)
    with pytest.raises(ValueError, match="torch.int8"):
        check(q=qb, kp=kb, vp=vb, ks=sc, vs=sc)
    with pytest.raises(ValueError, match="float32"):
        check(q=qb, kp=ki, vp=ki, ks=sc.double(), vs=sc)
