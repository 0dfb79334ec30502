"""The port's Hopper kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels from
``lmcache_tpu_torch/ops/csrc``); they carry the ``cuda`` marker and skip
elsewhere. On a machine with the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""

import pytest
import torch

from lmcache_tpu_torch import ops

pytestmark = pytest.mark.cuda

# bf16 outputs (one ulp near 4 is 1.6e-2); the kernel rounds P to bf16
# before the PV product, the plain version keeps it in fp32
ATOL = 2e-2


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _check(gen, B, T, H, Hkv, D, S, q_off, kv_len, **kw):
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    before = ops.flash_attention.launches["decode" if T == 1 else "prefill"]
    out = ops.flash_attention(q, k, v, qo, kl, kv_head_major=True, **kw)
    ref = ops.mha_reference(q, k.transpose(1, 2), v.transpose(1, 2), qo, kl,
                            **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches[
        "decode" if T == 1 else "prefill"] == before + 1
    assert torch.isfinite(out.float()).all()
    # a sequence that sees no key gets 0 from the kernel (the plain
    # version spreads such a row evenly over the masked keys)
    live = kl > 0
    assert (out[~live] == 0).all()
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("D", [64, 96, 128, 256])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("case", [
    (2, 37, 300, [0, 100], [37, 137]),  # ragged T edge, prefix
    (3, 1, 257, [256, 5, 0], [257, 6, 1]),  # decode
    (2, 70, 128, [0, 0], [0, 70]),  # sequence 0 sees no key
], ids=["prefill", "decode", "empty_seq"])
def test_kernel_matches_plain(gen, case, G, D):
    B, T, S, q_off, kv_len = case
    _check(gen, B, T, 2 * G, 2, D, S, q_off, kv_len)


def test_sm_scale_and_parked_row(gen):
    """A row parked past the pool (q_offset == S - 1, kv_len == S) and a
    custom score scale."""
    _check(gen, 2, 1, 32, 4, 64, 65, [64, 3], [65, 4], sm_scale=0.05)


def test_slot_view_of_a_pool_needs_no_copy(gen):
    """The kernel reads K/V through the strides of one slot of a larger
    pool, as the serving engine passes them."""
    pool = torch.randn((2, 3, 4, 96, 64), generator=gen,
                       device="cuda").bfloat16()  # [2, B, H_kv, S, D]
    q = torch.randn((1, 5, 16, 64), generator=gen, device="cuda").bfloat16()
    qo = torch.tensor([40], dtype=torch.int32, device="cuda")
    kl = torch.tensor([45], dtype=torch.int32, device="cuda")
    k, v = pool[0, 1:2], pool[1, 1:2]
    out = ops.flash_attention(q, k, v, qo, kl, kv_head_major=True)
    ref = ops.mha_reference(q, k.transpose(1, 2), v.transpose(1, 2), qo, kl)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=0)


def test_token_major_kv(gen):
    """K/V as [B, S, H_kv, D] (``kv_head_major=False``), read through
    their strides."""
    q = torch.randn((2, 9, 8, 128), generator=gen, device="cuda").bfloat16()
    k = torch.randn((2, 40, 2, 128), generator=gen, device="cuda").bfloat16()
    v = torch.randn((2, 40, 2, 128), generator=gen, device="cuda").bfloat16()
    qo = torch.tensor([30, 0], dtype=torch.int32, device="cuda")
    kl = torch.tensor([39, 9], dtype=torch.int32, device="cuda")
    out = ops.flash_attention(q, k, v, qo, kl)
    ref = ops.mha_reference(q, k, v, qo, kl)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=0)


def test_kernel_refuses_float32(gen):
    q = torch.zeros((1, 2, 4, 64), device="cuda")
    k = torch.zeros((1, 2, 8, 64), device="cuda")
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention(q, k, k, one, one, kv_head_major=True)


# ------------------------------- the dense kernels' options, rows 2 and 3 ---

from lmcache_tpu_torch.ops import quantized_attention as qa  # noqa: E402

# (B, T, S, q_offset, kv_len): where an off-by-one of the window hides
OPTION_CASES = {
    "decode": (2, 1, 768, [700, 40], [701, 41]),
    "prefix": (2, 16, 768, [100, 380], [116, 396]),
    "prefill_from_0": (2, 128, 768, [0, 250], [128, 378]),
    "short_kv_len": (2, 16, 256, [40, 10], [50, 12]),
}
OPTIONS = {
    "window16": dict(sliding_window=16),
    "window100": dict(sliding_window=100),
    "window128": dict(sliding_window=128),
    "window300": dict(sliding_window=300),
    "window4": dict(sliding_window=4),
    "chunk64": dict(sliding_window=64, window_kind="chunked"),
    "chunk100": dict(sliding_window=100, window_kind="chunked"),
    "softcap": dict(sm_scale=0.21, logit_softcap=30.0),
    "softcap_window": dict(sm_scale=0.21, logit_softcap=30.0,
                           sliding_window=100),
    "sinks": dict(sinks=True),
    "all": dict(sinks=True, logit_softcap=20.0, sliding_window=64,
                window_kind="chunked"),
}


def _dense_inputs(gen, B, T, H, Hkv, D, S, quant):
    dev = "cuda"
    q = torch.randn((B, T, H, D), generator=gen, device=dev).bfloat16()
    if not quant:
        kv = torch.randn((2, B, Hkv, S, D), generator=gen,
                         device=dev).bfloat16()
        return q, (kv[0], kv[1])
    sym = torch.randint(-127, 128, (2, B, Hkv, S, D), generator=gen,
                        device=dev, dtype=torch.int32).to(torch.int8)
    scale = torch.rand((2, B, S), generator=gen, device=dev) * 0.02 + 0.02
    return q, (sym[0], sym[1], scale[0], scale[1])


def _dense_check(gen, quant, B, T, G, D, S, q_off, kv_len, **kw):
    """One launch of flash_attention (or, ``quant``, of
    quantized_flash_attention) against its plain version with
    ``zero_dead_rows`` (the kernels give 0 for a row that sees no key)."""
    Hkv = 2
    q, kv = _dense_inputs(gen, B, T, G * Hkv, Hkv, D, S, quant)
    if kw.get("sinks") is True:
        kw["sinks"] = torch.randn(G * Hkv, generator=gen, device="cuda") * 3
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    entry = qa.quantized_flash_attention if quant else ops.flash_attention
    plain = qa.quantized_attention_reference if quant else ops.mha_reference
    phase = ("decode" if T == 1 else "prefill") + (
        "+window" if kw.get("sliding_window") else "")
    before = entry.launches[phase]
    out = entry(q, *kv, qo, kl, kv_head_major=True, **kw)
    ref = plain(q, *(t.transpose(1, 2) if t.dim() == 4 else t for t in kv),
                qo, kl, zero_dead_rows=True, **kw)
    torch.cuda.synchronize()
    assert entry.launches[phase] == before + 1
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=2.0**-7)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(OPTION_CASES))
@pytest.mark.parametrize("opt", sorted(OPTIONS))
def test_dense_kernel_options_match_plain(gen, opt, case, quant):
    B, T, S, q_off, kv_len = OPTION_CASES[case]
    _dense_check(gen, quant, B, T, 2, 64, S, q_off, kv_len,
                 **dict(OPTIONS[opt]))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("D", [64, 96, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_dense_kernel_head_dims_and_groups(gen, D, G, quant):
    """Every head dim and group size, windowed and not, prefill with a
    ragged last block and decode; a block of 64 rows spans 64 / G tokens,
    so G = 4 and 8 straddle a chunk boundary inside one block."""
    for kw in (dict(), dict(sliding_window=48),
               dict(sliding_window=24, window_kind="chunked")):
        _dense_check(gen, quant, 2, 37, G, D, 300, [0, 100], [37, 137], **kw)
        _dense_check(gen, quant, 3, 1, G, D, 257, [256, 5, 0], [257, 6, 1],
                     **kw)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_dense_kernel_empty_sequence_gives_zero(gen, quant):
    for kw in (dict(), dict(sinks=True), dict(sliding_window=8)):
        _dense_check(gen, quant, 2, 70, 2, 128, 128, [0, 0], [0, 70], **kw)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("W", [None, 48])
def test_kv_slot_reads_the_pool_row_on_the_device(gen, quant, W):
    """K/V (and scales) carry a pool of four rows; the one sequence attends
    to row ``kv_slot[0]``."""
    q, kv = _dense_inputs(gen, 4, 16, 8, 2, 64, 256, quant)
    q = q[:1]
    qo = torch.tensor([100], dtype=torch.int32, device="cuda")
    kl = torch.tensor([116], dtype=torch.int32, device="cuda")
    entry = qa.quantized_flash_attention if quant else ops.flash_attention
    plain = qa.quantized_attention_reference if quant else ops.mha_reference
    for slot in (0, 2, 3):
        out = entry(q, *kv, qo, kl, kv_head_major=True, sliding_window=W,
                    kv_slot=torch.tensor([slot], dtype=torch.int32,
                                         device="cuda"))
        row = [t[slot:slot + 1] for t in kv]
        ref = plain(q, *(t.transpose(1, 2) if t.dim() == 4 else t
                         for t in row), qo, kl, sliding_window=W)
        torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                                   rtol=2.0**-7)


def test_quantized_kernel_on_a_slot_view_and_token_major(gen):
    """Symbols and scales read through the strides of one slot of a serving
    pool ([L, 2, B, H_kv, S, D] and [L, 2, B, S]), and token-major
    symbols."""
    sym = torch.randint(-127, 128, (2, 3, 4, 96, 64), generator=gen,
                        device="cuda", dtype=torch.int32).to(torch.int8)
    scale = torch.rand((2, 3, 96), generator=gen, device="cuda") * 0.03 + 0.01
    q = torch.randn((1, 5, 16, 64), generator=gen, device="cuda").bfloat16()
    qo = torch.tensor([40], dtype=torch.int32, device="cuda")
    kl = torch.tensor([45], dtype=torch.int32, device="cuda")
    args = (sym[0, 1:2], sym[1, 1:2], scale[0, 1:2], scale[1, 1:2])
    out = qa.quantized_flash_attention(q, *args, qo, kl, kv_head_major=True)
    ref = qa.quantized_attention_reference(
        q, args[0].transpose(1, 2), args[1].transpose(1, 2), args[2],
        args[3], qo, kl)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=2.0**-7)
    tm = (args[0].transpose(1, 2).contiguous(),
          args[1].transpose(1, 2).contiguous())
    out_tm = qa.quantized_flash_attention(q, *tm, args[2], args[3], qo, kl)
    torch.testing.assert_close(out_tm, out, atol=0, rtol=0)


def test_quantized_kernel_equals_bf16_kernel_on_dequantized_kv(gen):
    """With scales that are powers of two the dequantized K/V are exact in
    bf16, so the int8 kernel and the bf16 kernel see the same numbers; they
    differ only in where the scales multiply."""
    q, (ks, vs, _, _) = _dense_inputs(gen, 2, 33, 8, 2, 128, 200, True)
    ksc = torch.full((2, 200), 2.0**-5, device="cuda")
    vsc = torch.full((2, 200), 2.0**-6, device="cuda")
    qo = torch.tensor([100, 0], dtype=torch.int32, device="cuda")
    kl = torch.tensor([133, 33], dtype=torch.int32, device="cuda")
    out = qa.quantized_flash_attention(q, ks, vs, ksc, vsc, qo, kl,
                                       kv_head_major=True)
    k = (ks.float() * 2.0**-5).bfloat16()
    v = (vs.float() * 2.0**-6).bfloat16()
    ref = ops.flash_attention(q, k, v, qo, kl, kv_head_major=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=2.0**-7)


@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("case", [
    (2, 300, 512, [100, 0], [400, 300]),  # over a prefix, and from 0
    (1, 700, 700, [0], [700]),  # more tiles than ring stages, ragged end
    (2, 37, 300, [0, 100], [20, 137]),  # kv_len below the causal limit
    (3, 1, 257, [256, 5, 0], [257, 6, 1]),  # decode
    (2, 70, 128, [0, 0], [0, 70]),  # sequence 0 sees no key
], ids=["prefix", "long", "short_kv", "decode", "empty_seq"])
def test_streamed_kernel_matches_plain_and_flash_attention(gen, case, G, D):
    B, T, S, q_off, kv_len = case
    q, (k, v) = _dense_inputs(gen, B, T, 2 * G, 2, D, S, False)
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    phase = "decode" if T == 1 else "prefill"
    before = ops.flash_attention_dma.launches[phase]
    out = ops.flash_attention_dma(q, k, v, qo, kl)
    torch.cuda.synchronize()
    assert ops.flash_attention_dma.launches[phase] == before + 1
    ref = ops.mha_reference(q, k.transpose(1, 2), v.transpose(1, 2), qo, kl,
                            zero_dead_rows=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=2.0**-7)
    # the same steps on the same tiles as flash_attention: equal outputs
    same = ops.flash_attention(q, k, v, qo, kl, kv_head_major=True)
    torch.testing.assert_close(out, same, atol=0, rtol=0)


def test_dense_kernels_refuse_what_they_do_not_take(gen):
    q, (k, v) = _dense_inputs(gen, 1, 4, 4, 2, 256, 32, False)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim 256"):
        ops.flash_attention_dma(q, k, v, one, one)
    ops.flash_attention(q, k, v, one, one, kv_head_major=True)
    with pytest.raises(ValueError, match="int8"):
        scale = torch.ones((1, 32), device="cuda")
        qa.quantized_flash_attention(q, k, v, scale, scale, one, one,
                                     kv_head_major=True)
    with pytest.raises(ValueError, match="sinks"):
        ops.flash_attention(q, k, v, one, one, kv_head_major=True,
                            sinks=torch.zeros(4))  # on the CPU
    with pytest.raises(ValueError, match="kv_slot"):
        ops.flash_attention(q, k, v, one, one, kv_slot=one)


# ------------------------------------------------- paged attention kernels ---

from lmcache_tpu_torch.ops import paged_attention as pa  # noqa: E402

# (entry point, int8 arena, head dims it is instantiated for)
PAGED = {
    "grid_bf16": (pa.paged_attention, False, (64, 96, 128, 256)),
    "grid_int8": (pa.quantized_paged_attention, True, (64, 96, 128, 256)),
    "stream_bf16": (pa.paged_attention_dma, False, (64, 128, 256)),
    "stream_int8": (pa.quantized_paged_attention_dma, True, (64, 128, 256)),
}


def _paged_inputs(gen, B, T, H, Hkv, D, page, NP, P, quant, fragmented):
    """A layer's slice of an arena [2, P, H_kv, page, D] (read in place) and
    a page table of distinct ids per sequence: consecutive, or a seeded
    permutation."""
    dev = "cuda"
    q = torch.randn((B, T, H, D), generator=gen, device=dev).bfloat16()
    if quant:
        arena = torch.randint(-127, 128, (2, P, Hkv, page, D), generator=gen,
                              device=dev, dtype=torch.int32).to(torch.int8)
        scales = (torch.rand((2, P, page), generator=gen, device=dev)
                  * 0.02 + 0.001)
    else:
        arena = torch.randn((2, P, Hkv, page, D), generator=gen,
                            device=dev).bfloat16()
        scales = None
    if fragmented:
        ids = torch.randperm(P - 1, generator=gen, device=dev)[:B * NP] + 1
    else:
        ids = torch.arange(1, B * NP + 1, device=dev)
    table = ids.reshape(B, NP).to(torch.int32).contiguous()
    return q, arena, scales, table


def _paged_check(gen, kind, B, T, G, D, page, q_off, kv_len, window=None,
                 fragmented=True, sm_scale=None):
    entry, quant, _ = PAGED[kind]
    Hkv = 2
    NP = -(-max(kv_len) // page) + 1  # one dead trailing slot
    P = B * NP + 3
    q, arena, scales, table = _paged_inputs(gen, B, T, G * Hkv, Hkv, D, page,
                                            NP, P, quant, fragmented)
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    kw = dict(sliding_window=window, sm_scale=sm_scale)
    phase = "decode" if T == 1 else "prefill"
    before = entry.launches[phase]
    if quant:
        args = (q, arena[0], arena[1], scales[0], scales[1], table, qo, kl)
        ref = pa.quantized_paged_attention_reference(*args, **kw)
    else:
        args = (q, arena[0], arena[1], table, qo, kl)
        ref = pa.paged_attention_reference(*args, **kw)
    out = entry(*args, **kw)
    torch.cuda.synchronize()
    assert entry.launches[phase] == before + 1
    assert torch.isfinite(out.float()).all()
    # bf16 outputs: one ulp is 2**-7 of the value (the int8 values are not
    # of unit size, so the tolerance is relative as well as absolute)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=2.0**-7)


PAGED_CASES = {
    # (B, T, page, q_offset, kv_len, window)
    "decode_ragged": (3, 1, 64, [1000, 63, 0], [1001, 64, 1], None),
    "prefill_over_prefix": (2, 70, 32, [100, 0], [170, 70], None),
    "decode_window": (2, 1, 16, [300, 40], [301, 41], 100),
    "prefill_window": (2, 150, 64, [200, 0], [350, 150], 77),
    "empty_seq": (2, 5, 16, [0, 20], [0, 25], None),
}


@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("kind, D", [(k, D) for k in sorted(PAGED)
                                     for D in PAGED[k][2]])
def test_paged_kernel_matches_plain(gen, kind, D, case, G):
    B, T, page, q_off, kv_len, window = PAGED_CASES[case]
    _paged_check(gen, kind, B, T, G, D, page, q_off, kv_len, window=window)


@pytest.mark.parametrize("kind", sorted(PAGED))
def test_paged_consecutive_ids_and_sm_scale(gen, kind):
    _paged_check(gen, kind, 2, 1, 8, 64, 64, [2000, 511], [2001, 512],
                 fragmented=False, sm_scale=0.07)


@pytest.mark.parametrize("kind", sorted(PAGED))
def test_paged_page_ids_outside_the_pool_are_not_read(gen, kind):
    """A table entry past the pool (a caller's fault) reads as zeros instead
    of touching memory outside the arena: the launch completes and the
    output is finite."""
    entry, quant, _ = PAGED[kind]
    q, arena, scales, table = _paged_inputs(gen, 1, 1, 8, 2, 64, 16, 4, 8,
                                            quant, False)
    table[0, 1] = 1 << 20
    table[0, 2] = -5
    qo = torch.tensor([60], dtype=torch.int32, device="cuda")
    kl = torch.tensor([61], dtype=torch.int32, device="cuda")
    if quant:
        out = entry(q, arena[0], arena[1], scales[0], scales[1], table, qo,
                    kl)
    else:
        out = entry(q, arena[0], arena[1], table, qo, kl)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()


def test_paged_kernels_refuse_what_they_do_not_take(gen):
    q = torch.zeros((1, 1, 4, 64), device="cuda")
    pool = torch.zeros((4, 2, 16, 64), device="cuda")
    table = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        pa.paged_attention(q, pool, pool, table, one, one)
    qb = torch.zeros((1, 1, 4, 96), device="cuda").bfloat16()
    pb = torch.zeros((4, 2, 16, 96), device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dim 96"):
        pa.paged_attention_dma(qb, pb, pb, table, one, one)
    pa.paged_attention(qb, pb, pb, table, one, one)


# ------------------------------------------------------------------------
# kernel rows 11 and 12: the range decoder and encoder

import numpy as np  # noqa: E402

from lmcache_tpu_torch.codec import range_coder  # noqa: E402
from lmcache_tpu_torch.ops import quant  # noqa: E402
from lmcache_tpu_torch.ops import range_decode as rd  # noqa: E402
from lmcache_tpu_torch.ops import range_encode as re_  # noqa: E402

SYMBOL_KINDS = ("uniform", "skewed", "binary", "extreme", "gauss")


def _symbols(kind, S, T, seed):
    """The five symbol distributions of the JAX package's coder tests."""
    rng = np.random.default_rng(seed)
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


def _coder_case(kind, S, T, seed=0):
    """(symbols, CDF) on the card, the CDF from the port's quant module."""
    sym = torch.from_numpy(_symbols(kind, S, T, seed)).cuda()
    return sym, quant.stream_cdf(sym)


@pytest.mark.parametrize("S, T", [(96, 256), (1000, 255), (257, 1024)],
                         ids=["96x256", "1000x255", "257x1024"])
@pytest.mark.parametrize("kind", SYMBOL_KINDS)
def test_range_kernels_match_plain_and_host_coder(gen, kind, S, T):
    if not range_coder.codec_available():
        pytest.skip("needs g++ for the host coder")
    sym, cdf = _coder_case(kind, S, T)
    cdf_h = quant.cdf_to_numpy(cdf)
    payload, lens = range_coder.encode_streams(sym.cpu().numpy(), cdf_h)
    # row 12: byte-identical with the host coder and the plain version
    before = re_.encode_streams_raw.launches["store"]
    got, got_lens = re_.encode_streams(sym, cdf)
    assert re_.encode_streams_raw.launches["store"] == before + 1
    assert np.array_equal(got_lens, lens) and got.tobytes() == payload
    out, raw_lens = re_.encode_streams_raw(sym, cdf)
    ref_out, ref_lens = re_.encode_streams_reference(sym.cpu(), cdf.cpu())
    assert torch.equal(raw_lens.cpu(), ref_lens)
    assert torch.equal(re_.compact(out, raw_lens).cpu(),
                       re_.compact(ref_out, ref_lens))
    # row 11: symbol-exact with the host coder and the plain version
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])).cuda()
    pay = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).cuda()
    before = rd.decode_streams.launches["retrieve"]
    dec = rd.decode_streams(pay, offs, cdf, T)
    torch.cuda.synchronize()
    assert rd.decode_streams.launches["retrieve"] == before + 1
    assert torch.equal(dec, sym)
    assert np.array_equal(
        dec.cpu().numpy(),
        range_coder.decode_streams(payload, lens, T, cdf_h))
    if S * T <= 96 * 256:
        assert torch.equal(rd.decode_streams_reference(
            pay.cpu(), offs.cpu(), cdf.cpu(), T), sym.cpu())


def test_range_kernels_at_a_bench_sized_launch(gen):
    """One decode group of the bench shape (16 chunks x 2 halves x 22
    layers x 256 channels = 180224 streams of 256 symbols) through both
    kernels, held against the host coder."""
    if not range_coder.codec_available():
        pytest.skip("needs g++ for the host coder")
    S, T = 16 * 2 * 22 * 256, 256
    x = torch.randn((S // 256, T, 256), generator=gen, device="cuda")
    bins = torch.full((S // 256,), 16, dtype=torch.int32, device="cuda")
    bins[:64] = 32
    sym, _ = quant.quantize(x, bins)
    streams = sym.transpose(1, 2).reshape(S, T).contiguous()
    cdf = quant.stream_cdf(streams)
    payload, lens = re_.encode_streams(streams, cdf)
    ref_payload, ref_lens = range_coder.encode_streams(
        streams.cpu().numpy(), quant.cdf_to_numpy(cdf))
    assert np.array_equal(lens, ref_lens) and payload.tobytes() == ref_payload
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])).cuda()
    dec = rd.decode_streams(torch.from_numpy(payload).cuda(), offs, cdf, T)
    assert torch.equal(dec, streams)


def test_range_kernels_refuse_what_they_do_not_take(gen):
    sym, cdf = _coder_case("gauss", 8, 16)
    with pytest.raises(ValueError, match="cdf"):
        re_.encode_streams_raw(sym, cdf[:, :17].contiguous())
    with pytest.raises(ValueError, match="cdf"):
        re_.encode_streams_raw(sym, cdf.to(torch.int32))
    offs = torch.zeros(9, dtype=torch.int64, device="cuda")
    pay = torch.zeros(1, dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="offsets"):
        rd.decode_streams(pay, offs.to(torch.int32), cdf, 16)
    with pytest.raises(ValueError, match="offsets"):
        rd.decode_streams(pay, offs[:8], cdf, 16)


def test_range_decoder_ends_a_collapsed_stream_like_its_plain_version(gen):
    """A CDF that is not monotone decodes a zero-width bin and collapses the
    range, where the host coder never returns: kernel and plain version
    end the stream with zeros."""
    T = 64
    cdf = torch.tensor([0, 60000, 50, 50] + list(range(60001, 60030)),
                       dtype=torch.int32).to(torch.int16)[None].cuda()
    payload = torch.tensor([0x10, 0x20, 0x30, 0x40, 0x50],
                           dtype=torch.uint8).cuda()
    offsets = torch.tensor([0, 5], dtype=torch.int64).cuda()
    out = rd.decode_streams(payload, offsets, cdf, T)
    ref = rd.decode_streams_reference(payload.cpu(), offsets.cpu(),
                                      cdf.cpu(), T)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), ref)
    assert ref[0, 0] == 2 and not ref[0, 1:].any()


# ------------------------------------------------------------------------
# kernel rows 8, 9 and 10: MLA latent attention, dense and paged

from lmcache_tpu_torch.ops import latent_attention as la  # noqa: E402
from lmcache_tpu_torch.ops import paged_latent_attention as pla  # noqa: E402

# (H, C, rank, Cp): the tiny test geometry and DeepSeek-V2-Lite's; V2/V3
# share V2-Lite's latent with H = 128
LATENT_GEOMETRY = {"tiny": (4, 80, 64, 128), "v2_lite": (16, 576, 512, 640),
                   "v3_heads": (128, 576, 512, 640)}
LATENT_SCALE = 0.0722  # 1 / sqrt(192), DeepSeek's qk head dim


def _latent_rows(gen, shape, quant):
    """Latent rows of unit size in bf16, or int8 symbols with fp32 scales
    of such rows."""
    if quant:
        sym = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                            dtype=torch.int32).to(torch.int8)
        scale = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.02 \
            + 0.01
        return sym, scale
    return torch.randn(shape, generator=gen, device="cuda").bfloat16(), None


def _assert_latent_close(out, ref, kl):
    """bf16 output against the fp32 plain version (P rounded to bf16 before
    the value product in the kernel only); a sequence that sees no key gives
    0 from both."""
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert (out[kl == 0] == 0).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=2.0**-7)


LATENT_CASES = {
    # (B, T, S, q_offset, kv_len)
    "prefill_over_prefix": (2, 37, 300, [100, 0], [137, 37]),
    "decode_ragged": (3, 1, 257, [256, 5, 0], [257, 6, 1]),
    "empty_seq": (2, 20, 64, [0, 10], [0, 30]),
}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(LATENT_CASES))
@pytest.mark.parametrize("geom", sorted(LATENT_GEOMETRY))
def test_latent_kernel_matches_plain(gen, geom, case, quant):
    H, C, rank, _ = LATENT_GEOMETRY[geom]
    B, T, S, q_off, kv_len = LATENT_CASES[case]
    if geom == "v3_heads":
        T = 1  # H = 128 is held at decode, where the path gives it
    q = torch.randn((B, T, H, C), generator=gen, device="cuda").bfloat16()
    rows, scale = _latent_rows(gen, (B, S, C), quant)
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    entry = (la.quantized_latent_flash_attention if quant
             else la.latent_flash_attention)
    phase = "decode" if T == 1 else "prefill"
    before = entry.launches[phase]
    kw = dict(rank=rank, scale=LATENT_SCALE)
    if quant:
        out = entry(q, rows, scale, qo, kl, **kw)
        ref = la.quantized_latent_attention_reference(
            q, rows, scale, qo, kl, zero_dead_rows=True, **kw)
    else:
        out = entry(q, rows, qo, kl, **kw)
        ref = la.latent_attention_reference(q, rows, qo, kl,
                                            zero_dead_rows=True, **kw)
    assert entry.launches[phase] == before + 1
    assert out.shape == (B, T, H, rank)
    _assert_latent_close(out, ref, kl)


def test_latent_kernel_on_a_slot_view_of_the_pool(gen):
    """A layer's slot of a [L, B, S, C] pool is read in place."""
    pool = torch.randn((3, 4, 200, 80), generator=gen,
                       device="cuda").bfloat16()
    view = pool[1, 2:3]
    q = torch.randn((1, 9, 4, 80), generator=gen, device="cuda").bfloat16()
    qo = torch.tensor([150], dtype=torch.int32, device="cuda")
    kl = torch.tensor([159], dtype=torch.int32, device="cuda")
    out = la.latent_flash_attention(q, view, qo, kl, rank=64, scale=0.1)
    ref = la.latent_attention_reference(q, view.contiguous(), qo, kl,
                                        rank=64, scale=0.1)
    _assert_latent_close(out, ref, kl)


PAGED_LATENT = {
    "grid_bf16": (pla.paged_latent_attention, False),
    "grid_int8": (pla.quantized_paged_latent_attention, True),
    "stream_bf16": (pla.paged_latent_attention_dma, False),
    "stream_int8": (pla.quantized_paged_latent_attention_dma, True),
}
PAGED_LATENT_CASES = {
    # (B, T, page, q_offset, kv_len)
    "decode_ragged": (4, 1, 64, [2100, 63, 0, 700], [2101, 64, 1, 701]),
    "prefill_over_prefix": (2, 70, 16, [100, 0], [170, 70]),
    "prefill_segment": (1, 512, 64, [1536], [2048]),
    "empty_seq": (2, 5, 16, [0, 20], [0, 25]),
}


@pytest.mark.parametrize("case", sorted(PAGED_LATENT_CASES))
@pytest.mark.parametrize("geom", ["tiny", "v2_lite"])
@pytest.mark.parametrize("kind", sorted(PAGED_LATENT))
def test_paged_latent_kernel_matches_plain(gen, kind, geom, case):
    """A layer's slice of a lane-padded arena [L, P, page, Cp], a fragmented
    table whose dead trailing slots hold ids outside the pool, queries of
    the logical width C."""
    entry, quant = PAGED_LATENT[kind]
    H, C, rank, Cp = LATENT_GEOMETRY[geom]
    B, T, page, q_off, kv_len = PAGED_LATENT_CASES[case]
    NP = -(-max(kv_len) // page) + 2
    P = B * NP + 3
    q = torch.randn((B, T, H, C), generator=gen, device="cuda").bfloat16()
    arena, scales = _latent_rows(gen, (2, P, page, Cp), quant)
    arena[..., C:] = 0  # the lane pad, as the model writes it
    ids = torch.randperm(P - 1, generator=gen, device="cuda")[:B * NP] + 1
    table = ids.reshape(B, NP).to(torch.int32)
    for b, n in enumerate(kv_len):
        table[b, -(-n // page):] = -7 if b % 2 else 1 << 20
    table = table.contiguous()
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    kw = dict(rank=rank, scale=LATENT_SCALE)
    phase = "decode" if T == 1 else "prefill"
    before = entry.launches[phase]
    live = table.clamp(0, P - 1)  # the plain version gathers every slot
    if quant:
        out = entry(q, arena[1], scales[1], table, qo, kl, **kw)
        ref = pla.quantized_paged_latent_attention_reference(
            q, arena[1], scales[1], live, qo, kl, zero_dead_rows=True, **kw)
    else:
        out = entry(q, arena[1], table, qo, kl, **kw)
        ref = pla.paged_latent_attention_reference(
            q, arena[1], live, qo, kl, zero_dead_rows=True, **kw)
    assert entry.launches[phase] == before + 1
    _assert_latent_close(out, ref, kl)


@pytest.mark.parametrize("kind", sorted(PAGED_LATENT))
def test_paged_latent_kernel_takes_a_padded_query(gen, kind):
    """The JAX forward zero-pads the query to the arena's width: the same
    result as the query at the logical width."""
    entry, quant = PAGED_LATENT[kind]
    q = torch.randn((2, 3, 4, 80), generator=gen, device="cuda").bfloat16()
    arena, scales = _latent_rows(gen, (9, 16, 128), quant)
    arena[..., 80:] = 0
    table = torch.tensor([[3, 1, 5, 0], [2, 4, 6, 8]], dtype=torch.int32,
                         device="cuda")
    qo = torch.tensor([30, 50], dtype=torch.int32, device="cuda")
    kl = qo + 3
    args = (arena, scales) if quant else (arena,)
    kw = dict(rank=64, scale=0.1)
    out = entry(q, *args, table, qo, kl, **kw)
    padded = entry(torch.nn.functional.pad(q, (0, 48)), *args, table, qo, kl,
                   **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(padded.float(), out.float(), atol=ATOL,
                               rtol=2.0**-7)


def test_latent_kernels_refuse_what_they_do_not_take(gen):
    q = torch.zeros((1, 1, 4, 80), device="cuda")
    lat = torch.zeros((1, 16, 80), device="cuda")
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        la.latent_flash_attention(q, lat, one, one, rank=64, scale=0.1)
    qb, lb = q.bfloat16(), lat.bfloat16()
    with pytest.raises(ValueError, match="multiples of 16"):
        la.latent_flash_attention(qb, lb, one, one, rank=60, scale=0.1)
    with pytest.raises(ValueError, match="int8"):
        la.quantized_latent_flash_attention(qb, lb, torch.ones(
            (1, 16), device="cuda"), one, one, rank=64, scale=0.1)
    pool = torch.zeros((4, 24, 128), device="cuda").bfloat16()
    table = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="page size 24"):
        pla.paged_latent_attention(qb, pool, table, one, one, rank=64,
                                   scale=0.1)
    # the streaming kernel takes any page size
    pla.paged_latent_attention_dma(qb, pool, table, one, one, rank=64,
                                   scale=0.1)
    torch.cuda.synchronize()


# -------------------- row 13: the prefill ablation variants ---------------

VARIANT_GEOMETRY = {  # (B, H_kv, G, D, S)
    "tool_small": (1, 2, 2, 128, 512),  # the tool's --small
    "d64_group8": (2, 2, 8, 64, 384),
}
# (name, q_offset, kv_len, bq, bk)
VARIANT_SCENARIOS = {
    "causal": ([0, 0], None, 128, 128),
    "suffix": ([96, 32], [400, 300], 64, 128),
    "wide_blocks": ([0, 17], [384, 380], 128, 192),
}


def _variant_inputs(gen, geom, scen):
    from lmcache_tpu_torch.ops import prefill_variants as pv
    B, Hkv, G, D, S = VARIANT_GEOMETRY[geom]
    q_off, kv_len, bq, bk = VARIANT_SCENARIOS[scen]
    q_off, kv_len = q_off[:B], (kv_len or [S] * B)[:B]
    Tp = -(-S // bq) * bq
    q = torch.randn((B, Hkv * G, Tp, D), generator=gen,
                    device="cuda").bfloat16()
    k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return pv, (q, k, v, qo, kl), dict(bq=bq, bk=bk)


@pytest.mark.parametrize("variant", ["full", "no_mask", "mxu_only", "pair",
                                     "pair_no_mask", "pair_mxu_only",
                                     "pipelined"])
@pytest.mark.parametrize("scen", sorted(VARIANT_SCENARIOS))
@pytest.mark.parametrize("geom", sorted(VARIANT_GEOMETRY))
def test_prefill_variant_matches_plain(gen, geom, scen, variant):
    """Each variant against its plain version: the bf16 gate of row 1 for
    the softmax variants; mxu_only's unnormalized sums (values of order 10)
    by relative L2 within 1e-2."""
    pv, args, kw = _variant_inputs(gen, geom, scen)
    S, bk = args[1].shape[2], kw["bk"]
    mode = {"pair": "full", "pipelined": "full"}.get(
        variant, variant.replace("pair_", ""))
    pair = variant.startswith("pair")
    if mode != "full" and S % bk:
        with pytest.raises(ValueError, match="multiple of bk"):
            pv.variant_attention(*args, mode=mode, pair=pair, **kw)
        return
    if pair and (-(-S // bk)) % 2:
        with pytest.raises(ValueError, match="odd number of key blocks"):
            pv.variant_attention(*args, mode=mode, pair=True, **kw)
        return
    entry = pv.pipelined_attention if variant == "pipelined" else (
        lambda *a, **k: pv.variant_attention(*a, mode=mode, pair=pair, **k))
    wrapper = (pv.pipelined_attention if variant == "pipelined"
               else pv.variant_attention)
    before = wrapper.launches[variant]
    out = entry(*args, **kw)
    ref = pv.variant_reference(*args, mode=mode, pair=pair, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches[variant] == before + 1
    assert torch.isfinite(out.float()).all()
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 1e-2
    if mode != "mxu_only":
        torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                                   rtol=2.0**-7)


def test_prefill_variants_refuse_what_they_do_not_take(gen):
    pv, (q, k, v, qo, kl), kw = _variant_inputs(gen, "tool_small", "causal")
    with pytest.raises(ValueError, match="group size that divides"):
        pv.variant_attention(q[:, :3], k[:, :1], v[:, :1], qo[:1], kl[:1],
                             **kw)
    with pytest.raises(ValueError, match="bfloat16"):
        pv.variant_attention(q.float(), k, v, qo, kl, **kw)
    with pytest.raises(ValueError, match="head dim"):
        pv.pipelined_attention(q[..., :96], k[..., :96], v[..., :96], qo,
                               kl, **kw)
