"""The port's Hopper kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels from
``lmcache_tpu_torch/ops/csrc``); they carry the ``cuda`` marker and skip
elsewhere. On a machine with the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""

import math

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


def _phase(T, sliding_window=None, logit_softcap=None, sinks=None, **_):
    """The key under which an attention entry point counts a launch of T
    tokens with these options (``attention.count_launch``)."""
    return (("decode" if T == 1 else "prefill")
            + ("+window" if sliding_window else "")
            + ("+softcap" if logit_softcap else "")
            + ("+sinks" if sinks is not None else ""))


def _check(gen, B, T, H, Hkv, D, S, q_off, kv_len, **kw):
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    before = ops.flash_attention.launches[_phase(T, **kw)]
    out = ops.flash_attention(q, k, v, qo, kl, kv_head_major=True, **kw)
    ref = ops.mha_reference(q, k.transpose(1, 2), v.transpose(1, 2), qo, kl,
                            **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches[_phase(T, **kw)] == before + 1
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
    phase = _phase(T, **kw)
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
    to row ``kv_slot[0]``: a 16-token prefill segment, and a decode step
    over three key splits whose window crosses a split edge (the key-split
    decode of either pool)."""
    entry = qa.quantized_flash_attention if quant else ops.flash_attention
    plain = qa.quantized_attention_reference if quant else ops.mha_reference
    for T, S, q_off in ((16, 256, 100), (1, 768, 530)):
        q, kv = _dense_inputs(gen, 4, T, 8, 2, 64, S, quant)
        q = q[:1]
        qo = torch.tensor([q_off], dtype=torch.int32, device="cuda")
        kl = torch.tensor([q_off + T], dtype=torch.int32, device="cuda")
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
    # the same body on the same tiles as flash_attention's prefill: equal
    # outputs (a launch of at most 16 rows takes flash_attention's split
    # decode instead, held above to the plain version)
    if T * 2 * G > ops.attention.DECODE_ROWS:
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


# ------------- rows 1-3 on Hopper: the split decodes and the Hopper body ---

from lmcache_tpu_torch.ops import attention as attn  # noqa: E402


def _split_case(gen, B, T, G, D, S, q_off, kv_len, nan_tail=False,
                quant=False, **kw):
    """flash_attention (and, for a windowless prefill, flash_attention_dma)
    or, ``quant``, quantized_flash_attention at T * G rows against its plain
    version with zero_dead_rows, on K/V (int8: K/V scales) whose rows at and
    past kv_len are NaN where ``nan_tail``: the plain version sees those
    rows as zeros, and the kernels must give the same finite numbers.
    Returns the kernel's output."""
    Hkv = 2
    q, kv = _dense_inputs(gen, B, T, G * Hkv, Hkv, D, S, quant)
    if kw.get("sinks") is True:
        kw["sinks"] = torch.randn(G * Hkv, generator=gen, device="cuda") * 3
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    past = torch.arange(S, device="cuda")[None, :] >= kl[:, None]  # [B, S]
    # the tail of K/V [B, H_kv, S, D] or of the scales [B, S]
    tails = [past[:, None, :, None] if t.dim() == 4 else past for t in kv]
    clean = [t.masked_fill(m, 0) for t, m in zip(kv, tails)]
    if nan_tail:
        # int8 symbols have no NaN: their scales carry it
        kv = [t.masked_fill(m, float("nan")) if t.is_floating_point() else t
              for t, m in zip(kv, tails)]
    entry = qa.quantized_flash_attention if quant else ops.flash_attention
    plain = qa.quantized_attention_reference if quant else ops.mha_reference
    decode = T * G <= attn.DECODE_ROWS
    phase = _phase(T, **kw)
    before = entry.launches[phase]
    combined = attn.combine_partials.launches["decode" if T == 1
                                              else "prefill"]
    out = entry(q, *kv, qo, kl, kv_head_major=True, **kw)
    ref = plain(q, *(t.transpose(1, 2) if t.dim() == 4 else t
                     for t in clean), qo, kl, zero_dead_rows=True, **kw)
    torch.cuda.synchronize()
    assert entry.launches[phase] == before + 1
    assert attn.combine_partials.launches[
        "decode" if T == 1 else "prefill"] == combined + int(decode)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=2.0**-7)
    if not quant and not kw and D != 256:
        streamed = ops.flash_attention_dma(q, *kv, qo, kl)
        assert torch.isfinite(streamed.float()).all()
        torch.testing.assert_close(streamed.float(), ref.float(), atol=ATOL,
                                   rtol=2.0**-7)
    return out


QUANT = pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])


@pytest.mark.parametrize("kv_len", [0, 1, attn.SPLIT_KEYS,
                                    attn.SPLIT_KEYS + 1, 16384],
                         ids=["empty", "one_key", "one_split",
                              "one_past_a_split", "16k"])
@pytest.mark.parametrize("G", [1, 8])
@QUANT
def test_split_decode_edges(gen, kv_len, G, quant):
    """Decode rows at the split edges: no key, one key, exactly one split,
    one key past a split, 16k keys; the pool is longer than the row."""
    _split_case(gen, 2, 1, G, 64, 16385, [max(kv_len - 1, 0), 700],
                [kv_len, 701], quant=quant)


@pytest.mark.parametrize("D", [64, 96, 128, 256])
@QUANT
def test_split_decode_rows_up_to_16(gen, D, quant):
    """T * G = 16 rows (two tokens of a group of 8) and G = 5 (three
    tokens) take the split decode over several splits."""
    _split_case(gen, 2, 2, 8, D, 1300, [1100, 40], [1102, 42], quant=quant)
    _split_case(gen, 2, 3, 5, D, 1300, [1200, 513], [1203, 516],
                quant=quant)


@pytest.mark.parametrize("opt", [
    dict(sliding_window=600),  # a window across split edges
    dict(sliding_window=100),  # inside one split
    dict(sliding_window=attn.SPLIT_KEYS,
         window_kind="chunked"),  # chunks = splits
    dict(sliding_window=300, window_kind="chunked"),  # chunks across edges
    dict(sinks=True),
    dict(sinks=True, sliding_window=700, logit_softcap=20.0),
], ids=["window600", "window100", "chunk_is_split", "chunk300", "sinks",
        "sinks_window_softcap"])
@QUANT
def test_split_decode_windows_chunks_and_sinks(gen, opt, quant):
    _split_case(gen, 3, 1, 4, 128, 2100, [1100, 1024, 1535],
                [1101, 1025, 1536], quant=quant, **dict(opt))


@pytest.mark.parametrize("rows", ["decode", "prefill"])
@pytest.mark.parametrize("D", [64, 96, 128, 256])
@QUANT
def test_nan_tails_past_kv_len_contribute_nothing(gen, D, rows, quant):
    """K and V rows (int8: their scales) past kv_len hold NaN (TMA loads
    whole boxes, and 0 * NaN is NaN): the outputs stay finite and equal the
    plain version's on zeroed tails."""
    if rows == "decode":
        _split_case(gen, 2, 1, 8, D, 1100, [600, 1000], [601, 1001],
                    nan_tail=True, quant=quant)
    else:
        _split_case(gen, 2, 150, 4, D, 1100, [500, 0], [650, 70],
                    nan_tail=True, quant=quant)
        _split_case(gen, 2, 40, 4, D, 1100, [500, 0], [540, 40],
                    nan_tail=True, quant=quant, sinks=True,
                    sliding_window=64)


@pytest.mark.parametrize("T", [1, 300], ids=["decode", "prefill"])
@QUANT
def test_two_launches_give_the_same_bits(gen, T, quant):
    q, kv = _dense_inputs(gen, 2, T, 16, 2, 64, 2048, quant)
    qo = torch.tensor([2040 - T, 1000], dtype=torch.int32, device="cuda")
    kl = qo + T
    entry = qa.quantized_flash_attention if quant else ops.flash_attention
    first = entry(q, *kv, qo, kl, kv_head_major=True)
    again = entry(q, *kv, qo, kl, kv_head_major=True)
    assert torch.equal(first, again)
    if T > 1 and not quant:
        assert torch.equal(ops.flash_attention_dma(q, *kv, qo, kl),
                           ops.flash_attention_dma(q, *kv, qo, kl))


@QUANT
def test_decode_row_does_not_depend_on_its_batch(gen, quant):
    """One decode row gives the same bits alone and among three others of
    other lengths (the serving waves and their greedy-token gates rely on
    it)."""
    q, kv = _dense_inputs(gen, 4, 1, 32, 4, 64, 4097, quant)
    qo = torch.tensor([3000, 4096, 17, 1500], dtype=torch.int32,
                      device="cuda")
    entry = qa.quantized_flash_attention if quant else ops.flash_attention
    together = entry(q, *kv, qo, qo + 1, kv_head_major=True)
    for i in range(4):
        alone = entry(q[i:i + 1], *(t[i:i + 1] for t in kv), qo[i:i + 1],
                      qo[i:i + 1] + 1, kv_head_major=True)
        assert torch.equal(alone, together[i:i + 1])


@pytest.mark.parametrize("sinks", [False, True])
def test_combine_kernel_matches_its_plain_version(gen, sinks):
    """The combine alone: partials of 3 sequences x 2 KV heads x 5 splits
    x 8 rows, some empty (l = 0, m = -1e30, O = NaN, never read) and one
    row with every partial empty."""
    B, Hkv, n, T, G, D = 3, 2, 5, 2, 4, 64
    R = T * G
    part_o = torch.randn((B, Hkv, n, R, D), generator=gen, device="cuda")
    m = torch.randn((B, Hkv, n, R), generator=gen, device="cuda") * 4
    l = torch.rand((B, Hkv, n, R), generator=gen, device="cuda") * 50 + 1
    empty = torch.rand((B, Hkv, n, R), generator=gen, device="cuda") < 0.3
    empty[1, 0, :, 3] = True
    m = m.masked_fill(empty, -1e30)
    l = l.masked_fill(empty, 0.0)
    part_o = part_o.masked_fill(empty[..., None], float("nan"))
    part_ml = torch.stack([m, l], dim=-1).contiguous()
    snk = (torch.randn(Hkv * G, generator=gen, device="cuda") * 3
           if sinks else None)
    before = attn.combine_partials.launches["prefill"]
    out = attn.combine_partials(part_o, part_ml, T, G, sinks=snk)
    ref = attn.combine_partials_reference(part_o, part_ml, T, G, sinks=snk)
    torch.cuda.synchronize()
    assert attn.combine_partials.launches["prefill"] == before + 1
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=2.0**-7)
    assert (out.reshape(B, T, Hkv, G, D)[1, 0, 0, 3] == 0).all()


def test_flash_kernels_refuse_what_tma_cannot_take(gen):
    """No fallback: a K/V base off 16 bytes or a stride that is no multiple
    of 8 elements raises, for the body and the split decode."""
    q, (k, v) = _dense_inputs(gen, 1, 40, 8, 2, 64, 256, False)
    one = torch.tensor([40], dtype=torch.int32, device="cuda")
    wide = torch.randn((1, 2, 256, 72), generator=gen,
                       device="cuda").bfloat16()
    for qq in (q, q[:, :1]):
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops.flash_attention(qq, k, wide[..., 4:68], one, one,
                                kv_head_major=True)
        odd = torch.randn((1, 2, 256, 68), generator=gen,
                          device="cuda").bfloat16()[..., :64]
        with pytest.raises(ValueError, match="multiple of 8"):
            ops.flash_attention(qq, k, odd, one, one, kv_head_major=True)


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
    phase = _phase(T, **kw)
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


# --------- rows 4 and 6 on Hopper: the paged body and the paged split ---

# (bf16 entry point, head dims): flash_sm90.cuh over the arena above
# DECODE_ROWS rows T * G, flash_split.cuh's paged split and row 1's combine
# at or below
HOPPER_PAGED = {
    "grid": (pa.paged_attention, (64, 96, 128, 256)),
    "stream": (pa.paged_attention_dma, (64, 128, 256)),
}


def _hopper_paged_inputs(gen, B, T, G, D, page, q_off, kv_len, Hkv=2,
                         fragmented=True, NP=None):
    """q, a bf16 arena slice pair, a page table of distinct ids (one dead
    trailing slot unless NP is given) and the int32 offsets."""
    NP = NP or -(-max(kv_len) // page) + 1
    P = B * NP + 3
    q, arena, _, table = _paged_inputs(gen, B, T, G * Hkv, Hkv, D, page, NP,
                                       P, False, fragmented)
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return q, arena[0], arena[1], table, qo, kl


def _hopper_paged_check(kind, args, window=None, ref_args=None, **opts):
    """The entry point once against the plain version (on ``ref_args``
    where given), with its launch counted under its phase and, for a split
    decode, once under the combine; int8 (rows 5 and 7) where ``args`` carry
    the scale pools; ``opts``: the other options (``window_kind``,
    ``logit_softcap``, ``sinks``, ``sm_scale``). Returns the output."""
    quant = len(args) == 8
    entry = (HOPPER_INT8 if quant else HOPPER_PAGED)[kind][0]
    plain = (pa.quantized_paged_attention_reference if quant
             else pa.paged_attention_reference)
    q, k_pool = args[0], args[1]
    T = q.shape[1]
    split = pa.takes_split(T, q.shape[2] // k_pool.shape[1])
    phase = _phase(T, sliding_window=window, **opts)
    combined_phase = "decode" if T == 1 else "prefill"
    before = entry.launches[phase]
    combined = attn.combine_partials.launches[combined_phase]
    out = entry(*args, sliding_window=window, **opts)
    ref = plain(*(ref_args or args), sliding_window=window, **opts)
    torch.cuda.synchronize()
    assert entry.launches[phase] == before + 1
    assert (attn.combine_partials.launches[combined_phase]
            == combined + int(split))
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=2.0**-7)
    return out


@pytest.mark.parametrize("G", [1, 5, 8])
@pytest.mark.parametrize("page", [16, 48, 64, 128, 256])
@pytest.mark.parametrize("kind, D", [(k, D) for k in sorted(HOPPER_PAGED)
                                     for D in HOPPER_PAGED[k][1]])
def test_paged_hopper_body_matches_plain(gen, kind, D, page, G):
    """Decode (the split, ragged rows, one of one key) and prefill (the
    body, over a prefix, a ragged second row; windowed too) at every page
    size, head dim and group."""
    dec = _hopper_paged_inputs(gen, 3, 1, G, D, page, [700, 255, 0],
                               [701, 256, 1])
    _hopper_paged_check(kind, dec)
    _hopper_paged_check(kind, dec, window=300)
    pre = _hopper_paged_inputs(gen, 2, 40, G, D, page, [300, 0], [340, 33])
    _hopper_paged_check(kind, pre)
    _hopper_paged_check(kind, pre, window=100)


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("T", [1, 90], ids=["decode", "prefill"])
@pytest.mark.parametrize("kind", sorted(HOPPER_PAGED))
def test_paged_hopper_nan_in_dead_pages_and_past_kv_len(gen, kind, T,
                                                        window):
    """NaN in every page no live slot names, in the rows past kv_len of a
    sequence's last page and, under a window, in the pages wholly before
    every row's window: the outputs stay finite and equal the plain
    version's on zeros there (dead pieces are not read; V's rows that are
    read past kv_len are zeroed before the PV product)."""
    page = 16
    q_off, kv_len = [400, 150], [400 + T, 150 + T]
    q, kp, vp, table, qo, kl = _hopper_paged_inputs(gen, 2, T, 8, 64, page,
                                                    q_off, kv_len)
    dead = torch.ones(kp.shape[0], page, dtype=torch.bool, device="cuda")
    for b in range(2):
        first = (max(q_off[b] - window + 1, 0) if window else 0) // page
        for j in range(first, -(-kv_len[b] // page)):
            pid = int(table[b, j])
            dead[pid] = torch.arange(page, device="cuda") >= (kv_len[b]
                                                              - j * page)
    mask = dead[:, None, :, None]
    clean = [t.masked_fill(mask, 0) for t in (kp, vp)]
    nan = [t.masked_fill(mask, float("nan")) for t in (kp, vp)]
    _hopper_paged_check(kind, (q, *nan, table, qo, kl), window=window,
                        ref_args=(q, *clean, table, qo, kl))


@pytest.mark.parametrize("T", [1, 60], ids=["decode", "prefill"])
@pytest.mark.parametrize("kind", sorted(HOPPER_PAGED))
def test_paged_hopper_ids_outside_the_pool_read_zeros(gen, kind, T):
    """Live table entries past the pool and below 0 read as a page of zeros
    (TMA's fill, the split's zero rows), never as memory outside the
    arena."""
    q, kp, vp, table, qo, kl = _hopper_paged_inputs(gen, 2, T, 8, 64, 16,
                                                    [100, 60], [100 + T,
                                                                60 + T])
    P = kp.shape[0]
    table[0, 1], table[0, 3], table[1, 2] = 1 << 20, -5, P
    # the plain version reads them as one more page of zeros
    zero = torch.zeros_like(kp[:1])
    mapped = torch.where((table < 0) | (table >= P), P, table)
    _hopper_paged_check(kind, (q, kp, vp, table, qo, kl),
                        ref_args=(q, torch.cat([kp, zero]),
                                  torch.cat([vp, zero]), mapped, qo, kl))


@pytest.mark.parametrize("kind", sorted(HOPPER_PAGED))
def test_paged_hopper_bits_repeat_and_a_decode_row_alone(gen, kind):
    """Two launches give the same bits (prefill and decode), and a decode
    row gives the same bits alone and among three others, one parked on the
    null page 0 at position S as the engines park an idle row."""
    pre = _hopper_paged_inputs(gen, 2, 200, 8, 64, 64, [900, 0],
                               [1100, 200])
    entry = HOPPER_PAGED[kind][0]
    assert torch.equal(entry(*pre, sliding_window=300),
                       entry(*pre, sliding_window=300))
    q, kp, vp, table, _, _ = _hopper_paged_inputs(gen, 4, 1, 8, 64, 64,
                                                  [0] * 4, [3000] * 4)
    S = table.shape[1] * 64 - 1
    table[3] = 0
    qo = torch.tensor([2999, 17, 1500, S], dtype=torch.int32, device="cuda")
    together = entry(q, kp, vp, table, qo, qo + 1)
    assert torch.equal(together, entry(q, kp, vp, table, qo, qo + 1))
    for i in range(4):
        alone = entry(q[i:i + 1], kp, vp, table[i:i + 1], qo[i:i + 1],
                      qo[i:i + 1] + 1)
        assert torch.equal(alone, together[i:i + 1])
    _hopper_paged_check(kind, (q, kp, vp, table, qo, qo + 1))


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("T", [1, 300], ids=["decode", "prefill"])
@pytest.mark.parametrize("kind", sorted(HOPPER_PAGED))
def test_paged_hopper_gives_row_1_on_consecutive_pages(gen, kind, T,
                                                       window):
    """The same K/V laid out densely for row 1 and as consecutive pages of
    an arena: the paged body and split give row 1's bits (the same tile and
    split points, the same order of every sum)."""
    B, Hkv, D, page, NP = 2, 2, 64, 64, 9
    S = NP * page
    q = torch.randn((B, T, 8 * Hkv, D), generator=gen,
                    device="cuda").bfloat16()
    k, v = (torch.randn((B, Hkv, S, D), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    qo = torch.tensor([S - T - 20, 3], dtype=torch.int32, device="cuda")
    kl = qo + T
    # arena page 1 + b * NP + j holds keys [j * page, (j + 1) * page) of b
    pools = [torch.cat([torch.zeros_like(t[:1, :, :page]),
                        t.reshape(B, Hkv, NP, page, D).permute(
                            0, 2, 1, 3, 4).reshape(B * NP, Hkv, page, D)])
             for t in (k, v)]
    table = (torch.arange(B * NP, device="cuda", dtype=torch.int32)
             .reshape(B, NP) + 1)
    dense = ops.flash_attention(q, k, v, qo, kl, kv_head_major=True,
                                sliding_window=window)
    paged = HOPPER_PAGED[kind][0](q, *pools, table, qo, kl,
                                  sliding_window=window)
    assert torch.equal(paged, dense)


# the options of Gemma-2 (softcap, window), GPT-OSS (sinks, window) and
# Llama-4 (chunks), each over the paged body (prefill) and the paged split
# (decode), on bf16 and int8 arenas. The scores of these inputs are about
# N(0, 1), which a cap of 20-50 barely moves (by about s^3 / (3 cap^2)): at
# PAGED_CAP the plain version with and without the cap lie at least
# CAP_MOVES times the check's tolerance apart, so that a kernel that
# dropped the cap fails.
PAGED_CAP = 2.0
CAP_MOVES = 4
PAGED_OPTIONS = {
    "softcap_window": dict(window=300, logit_softcap=PAGED_CAP),
    "sinks_window": dict(window=100, sinks=True),
    "chunked": dict(window=200, window_kind="chunked"),
    "sinks_softcap": dict(logit_softcap=PAGED_CAP, sinks=True),
}


def _paged_option_inputs(gen, quant, B, T, G, D, page, q_off, kv_len):
    make = _int8_paged_inputs if quant else _hopper_paged_inputs
    return make(gen, B, T, G, D, page, q_off, kv_len)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("opt", sorted(PAGED_OPTIONS))
@pytest.mark.parametrize("kind, D", [("grid", 96), ("grid", 256),
                                     ("stream", 64), ("stream", 128),
                                     ("stream", 256)])
def test_paged_hopper_options_match_plain(gen, kind, D, opt, quant):
    """Each option through the paged body (a prefill over a prefix, a
    ragged second row) and the paged split (a ragged decode, one row at its
    first key) against the plain version; with the cap, the plain version
    without it lies far outside the check's tolerance."""
    kw = dict(PAGED_OPTIONS[opt])
    window = kw.pop("window", None)
    G = 4
    if kw.get("sinks"):
        kw["sinks"] = torch.randn(G * 2, generator=gen, device="cuda") * 3
    for T, q_off, kv_len in ((60, [700, 0], [760, 45]),
                             (1, [900, 255, 0], [901, 256, 1])):
        args = _paged_option_inputs(gen, quant, len(q_off), T, G, D, 64,
                                    q_off, kv_len)
        out = _hopper_paged_check(kind, args, window=window, **kw)
        if kw.get("logit_softcap"):
            plain = (pa.quantized_paged_attention_reference if quant
                     else pa.paged_attention_reference)
            uncapped = plain(*args, sliding_window=window,
                             **dict(kw, logit_softcap=None)).float()
            excess = ((uncapped - out.float()).abs()
                      - 2.0**-7 * out.float().abs()).max().item()
            assert excess >= CAP_MOVES * ATOL


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 40], ids=["decode", "prefill"])
@pytest.mark.parametrize("kind", sorted(HOPPER_PAGED))
def test_paged_hopper_chunk_boundary_inside_a_page(gen, kind, T, quant):
    """Chunks of 24 keys over pages of 16: a chunk starts inside a page, so
    the piece that holds a block's first visible key is read whole and its
    earlier keys masked; a row at a chunk's first key sees that key alone
    where the chunk starts it."""
    args = _paged_option_inputs(gen, quant, 3, T, 8, 64, 16,
                                [120, 48, 200 - T], [120 + T, 48 + T, 200])
    _hopper_paged_check(kind, args, window=24, window_kind="chunked")


# ------ rows 5 and 7 on Hopper: the int8 paged body and the int8 split ---

# (int8 entry point, head dims): row 3's int8 body over the arena above
# DECODE_ROWS rows T * G, flash_split.cuh's int8 paged split and row 1's
# combine at or below
HOPPER_INT8 = {
    "grid": (pa.quantized_paged_attention, (64, 96, 128, 256)),
    "stream": (pa.quantized_paged_attention_dma, (64, 128, 256)),
}


def _int8_paged_inputs(gen, B, T, G, D, page, q_off, kv_len, Hkv=2,
                       fragmented=True, NP=None):
    """q, an int8 arena slice pair with its scale pools, a page table of
    distinct ids (one dead trailing slot unless NP is given) and the int32
    offsets: the argument list of the int8 entry points."""
    NP = NP or -(-max(kv_len) // page) + 1
    P = B * NP + 3
    q, arena, scales, table = _paged_inputs(gen, B, T, G * Hkv, Hkv, D, page,
                                            NP, P, True, fragmented)
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return q, arena[0], arena[1], scales[0], scales[1], table, qo, kl


@pytest.mark.parametrize("G", [1, 5, 8])
@pytest.mark.parametrize("page", [16, 48, 64])
@pytest.mark.parametrize("kind, D", [(k, D) for k in sorted(HOPPER_INT8)
                                     for D in HOPPER_INT8[k][1]])
def test_paged_hopper_int8_body_matches_plain(gen, kind, D, page, G):
    """Decode (the int8 split, ragged rows, one of one key) and prefill (the
    int8 body, over a prefix, a ragged second row; windowed too) at pages
    16, 48 (boxes of 16 rows) and 64, every head dim and group."""
    dec = _int8_paged_inputs(gen, 3, 1, G, D, page, [700, 255, 0],
                             [701, 256, 1])
    _hopper_paged_check(kind, dec)
    _hopper_paged_check(kind, dec, window=300)
    pre = _int8_paged_inputs(gen, 2, 40, G, D, page, [300, 0], [340, 33])
    _hopper_paged_check(kind, pre)
    _hopper_paged_check(kind, pre, window=100)


@pytest.mark.parametrize("kv_len", [0, 1, attn.SPLIT_KEYS,
                                    attn.SPLIT_KEYS + 1, 16384],
                         ids=["empty", "one_key", "one_split",
                              "one_past_a_split", "16k"])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("kind", sorted(HOPPER_INT8))
def test_paged_hopper_int8_split_edges(gen, kind, G, kv_len):
    """Decode rows at the split edges over the int8 arena: no key, one key,
    exactly one split, one key past a split, 16k keys; the table is wider
    than the row."""
    args = _int8_paged_inputs(gen, 2, 1, G, 64, 64, [max(kv_len - 1, 0), 700],
                              [kv_len, 701], NP=258)
    _hopper_paged_check(kind, args)


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("T", [1, 90], ids=["decode", "prefill"])
@pytest.mark.parametrize("kind", sorted(HOPPER_INT8))
def test_paged_hopper_int8_nan_scales_in_dead_pages_and_past_kv_len(
        gen, kind, T, window):
    """NaN in the scales (int8 symbols have none) of every page no live
    slot names, of the rows past kv_len of a sequence's last page and,
    under a window, of the pages wholly before every row's window: the
    outputs stay finite and equal the plain version's on zero scales there
    (dead pieces are not read, and the scales are selected, not
    multiplied)."""
    page = 16
    q_off, kv_len = [400, 150], [400 + T, 150 + T]
    q, ks, vs, kc, vc, table, qo, kl = _int8_paged_inputs(
        gen, 2, T, 8, 64, page, q_off, kv_len)
    dead = torch.ones(ks.shape[0], page, dtype=torch.bool, device="cuda")
    for b in range(2):
        first = (max(q_off[b] - window + 1, 0) if window else 0) // page
        for j in range(first, -(-kv_len[b] // page)):
            pid = int(table[b, j])
            dead[pid] = torch.arange(page, device="cuda") >= (kv_len[b]
                                                              - j * page)
    clean = [t.masked_fill(dead, 0) for t in (kc, vc)]
    nan = [t.masked_fill(dead, float("nan")) for t in (kc, vc)]
    _hopper_paged_check(kind, (q, ks, vs, *nan, table, qo, kl),
                        window=window,
                        ref_args=(q, ks, vs, *clean, table, qo, kl))


@pytest.mark.parametrize("T", [1, 60], ids=["decode", "prefill"])
@pytest.mark.parametrize("kind", sorted(HOPPER_INT8))
def test_paged_hopper_int8_ids_outside_the_pool_read_zeros(gen, kind, T):
    """Live table entries past the pool and below 0 read as a page of zero
    symbols with zero scales (TMA's fill and the converters' select, the
    split's zero rows), never as memory outside the arena."""
    q, ks, vs, kc, vc, table, qo, kl = _int8_paged_inputs(
        gen, 2, T, 8, 64, 16, [100, 60], [100 + T, 60 + T])
    P = ks.shape[0]
    table[0, 1], table[0, 3], table[1, 2] = 1 << 20, -5, P
    # the plain version reads them as one more page of zeros
    mapped = torch.where((table < 0) | (table >= P), P, table)
    _hopper_paged_check(
        kind, (q, ks, vs, kc, vc, table, qo, kl),
        ref_args=(q, *(torch.cat([t, torch.zeros_like(t[:1])])
                       for t in (ks, vs, kc, vc)), mapped, qo, kl))


@pytest.mark.parametrize("kind", sorted(HOPPER_INT8))
def test_paged_hopper_int8_bits_repeat_and_a_decode_row_alone(gen, kind):
    """Two launches give the same bits (prefill and decode), and a decode
    row gives the same bits alone and among three others, one parked on the
    null page 0 at position S as the engines park an idle row."""
    pre = _int8_paged_inputs(gen, 2, 200, 8, 64, 64, [900, 0], [1100, 200])
    entry = HOPPER_INT8[kind][0]
    assert torch.equal(entry(*pre, sliding_window=300),
                       entry(*pre, sliding_window=300))
    q, ks, vs, kc, vc, table, _, _ = _int8_paged_inputs(
        gen, 4, 1, 8, 64, 64, [0] * 4, [3000] * 4)
    S = table.shape[1] * 64 - 1
    table[3] = 0
    qo = torch.tensor([2999, 17, 1500, S], dtype=torch.int32, device="cuda")
    pools = (ks, vs, kc, vc)
    together = entry(q, *pools, table, qo, qo + 1)
    assert torch.equal(together, entry(q, *pools, table, qo, qo + 1))
    for i in range(4):
        alone = entry(q[i:i + 1], *pools, table[i:i + 1], qo[i:i + 1],
                      qo[i:i + 1] + 1)
        assert torch.equal(alone, together[i:i + 1])
    _hopper_paged_check(kind, (q, *pools, table, qo, qo + 1))


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("T", [1, 300], ids=["decode", "prefill"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kind", sorted(HOPPER_INT8))
def test_paged_hopper_int8_gives_row_3_on_consecutive_pages(gen, kind, D, T,
                                                           window):
    """The same int8 K/V and scales laid out densely for row 3 and as
    consecutive pages of an arena: the int8 paged body and split give row
    3's bits (the same tile and split points, the same order of every
    sum)."""
    B, Hkv, page, NP = 2, 2, 64, 9
    S = NP * page
    q = torch.randn((B, T, 8 * Hkv, D), generator=gen,
                    device="cuda").bfloat16()
    k, v = (torch.randint(-127, 128, (B, Hkv, S, D), generator=gen,
                          device="cuda", dtype=torch.int32).to(torch.int8)
            for _ in range(2))
    ksc, vsc = (torch.rand((B, S), generator=gen, device="cuda") * 0.02
                + 0.001 for _ in range(2))
    qo = torch.tensor([S - T - 20, 3], dtype=torch.int32, device="cuda")
    kl = qo + T
    # arena page 1 + b * NP + j holds keys [j * page, (j + 1) * page) of b
    pools = [torch.cat([torch.zeros_like(t[:1, :, :page]),
                        t.reshape(B, Hkv, NP, page, D).permute(
                            0, 2, 1, 3, 4).reshape(B * NP, Hkv, page, D)])
             for t in (k, v)]
    scales = [torch.cat([torch.zeros_like(t[:1, :page]),
                         t.reshape(B * NP, page)]) for t in (ksc, vsc)]
    table = (torch.arange(B * NP, device="cuda", dtype=torch.int32)
             .reshape(B, NP) + 1)
    dense = qa.quantized_flash_attention(q, k, v, ksc, vsc, qo, kl,
                                         kv_head_major=True,
                                         sliding_window=window)
    paged = HOPPER_INT8[kind][0](q, *pools, *scales, table, qo, kl,
                                 sliding_window=window)
    assert torch.equal(paged, dense)


def test_paged_hopper_int8_refuses_a_box_that_does_not_divide_its_tile(
        gen, monkeypatch):
    """At D 128 the int8 tile is 64 keys, the bf16 tile 128: a box of the
    bf16 rule (128 rows at page 128) would make a tile overrun its staging
    stage, and the launch is refused."""
    args = _int8_paged_inputs(gen, 1, 40, 8, 128, 128, [100], [140])
    pa.quantized_paged_attention(*args)  # the int8 rule: boxes of 64 rows
    monkeypatch.setattr(pa, "box_rows", lambda D, page, quant=False:
                        math.gcd(pa.tile_keys(D), page))
    for entry in (pa.quantized_paged_attention,
                  pa.quantized_paged_attention_dma):
        with pytest.raises(RuntimeError, match="launch failed"):
            entry(*args)


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


@pytest.mark.parametrize("S, T", [(96, 256), (1000, 255), (257, 1024),
                                  (7, 256), (1, 64)],
                         ids=["96x256", "1000x255", "257x1024", "7x256",
                              "1x64"])
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
    before = re_.compact.launches["store"]
    assert torch.equal(re_.compact(out, raw_lens).cpu(),
                       re_.compact_reference(ref_out, ref_lens))
    assert re_.compact.launches["store"] == before + 1
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


def _coded(kind, S, T, seed=0):
    """(symbols, CDF) on the card and the host coder's payload and lens."""
    sym, cdf = _coder_case(kind, S, T, seed)
    payload, lens = range_coder.encode_streams(sym.cpu().numpy(),
                                               quant.cdf_to_numpy(cdf))
    return sym, cdf, payload, lens


def _on_card(payload, lens, shift=0):
    """The payload on the card starting ``shift`` bytes into its
    allocation, and its int64 offsets."""
    buf = torch.zeros(len(payload) + shift, dtype=torch.uint8)
    buf[shift:] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]))
    return buf.cuda()[shift:], offs.cuda()


@pytest.mark.parametrize("S", [256 * 600 + 77, 256 * 600 + 200])
def test_range_kernels_with_a_ragged_last_block(gen, S):
    """A block codes 256 streams, two a thread: 77 streams leave the last
    block's threads with one stream or none, 200 some with two and some
    with one (both kernels and the copy pass)."""
    T = 64
    sym, cdf, payload, lens = _coded("gauss", S, T, seed=3)
    got, got_lens = re_.encode_streams(sym, cdf)
    assert np.array_equal(got_lens, lens) and got.tobytes() == payload
    pay, offs = _on_card(payload, lens)
    assert torch.equal(rd.decode_streams(pay, offs, cdf, T), sym)


@pytest.mark.parametrize("shift", [0, 1, 5, 7])
def test_range_decoder_reads_any_span_and_alignment(gen, shift):
    """Long streams (32 bins, n 1024: about 650 bytes each) from a payload
    that starts off an 8-byte boundary, and a stream of length 0 at its
    very end: the decoder's aligned loads stop at the payload's last word
    and its zero feed covers the rest."""
    S, T = 300, 1024
    sym, cdf, payload, lens = _coded("uniform", S, T, seed=shift)
    assert lens.min() > 600
    pay, offs = _on_card(payload, lens, shift)
    dec = rd.decode_streams(pay, offs, cdf, T)
    assert torch.equal(dec, sym)
    # a last stream of no bytes decodes as the zero feed does on the host
    cdf2 = torch.cat([cdf, cdf[:1]])
    offs2 = torch.cat([offs, offs[-1:]])
    want = range_coder.decode_streams(payload, np.append(lens, 0), T,
                                      quant.cdf_to_numpy(cdf2))
    assert np.array_equal(rd.decode_streams(pay, offs2, cdf2, T).cpu(),
                          want)


def test_range_encoder_overflow_reports_minus_one_and_raises(gen):
    sym = torch.full((300, 64), 5, dtype=torch.uint8, device="cuda")
    cdf = quant.stream_cdf(sym)
    bad = cdf.clone()
    bad[1, 6] = bad[1, 5]  # symbol 5 of stream 1 gets no width
    _, lens = re_.encode_streams_raw(sym, bad)
    _, ref_lens = re_.encode_streams_reference(sym.cpu(), bad.cpu())
    assert lens[1] == -1 and (lens[2:] > 0).all()
    assert torch.equal(lens.cpu(), ref_lens)
    with pytest.raises(RuntimeError, match="overflow"):
        re_.encode_streams(sym, bad)


def test_range_encoder_payloads_outlive_later_calls(gen):
    """Calls of growing and shrinking size each return a payload of their
    own: a later call, which may reuse pinned blocks of PyTorch's host
    cache, leaves the earlier payloads as they were."""
    kept = []
    for S in (400, 50, 2000, 10, 2000):
        sym, cdf, payload, lens = _coded("skewed", S, 256, seed=S)
        got, got_lens = re_.encode_streams(sym, cdf)
        assert np.array_equal(got_lens, lens) and got.tobytes() == payload
        kept.append((got, payload))
    for got, payload in kept:
        assert got.tobytes() == payload


# (nchunks, N, L, H, D, T, g): tinyllama-like K/V of full chunks, a short
# chunk's g 4 streams, and an MLA latent run (N 1, C 576, g 4)
BLOB_GEOMETRIES = {
    "kv_g1": (3, 2, 3, 4, 64, 256, 1),
    "kv_g4": (1, 2, 3, 4, 64, 50, 4),
    "latent": (2, 1, 3, 1, 576, 256, 4),
}


def _blob_case(name, seed=0):
    nchunks, N, L, H, D, T, g = BLOB_GEOMETRIES[name]
    C = H * D
    x = torch.randn((nchunks * N * L, T, C), generator=gen_cpu(seed))
    bins = torch.tensor([32, 16, 8][:L] * (nchunks * N), dtype=torch.int32)
    sym, maxes = quant.quantize(x, bins)
    streams = sym.transpose(1, 2).reshape(-1, g * T).contiguous()
    cdf = quant.stream_cdf(streams)
    payload, lens = range_coder.encode_streams(streams.numpy(),
                                               quant.cdf_to_numpy(cdf))
    half = (bins[:N * L].reshape(N, L) // 2 - 1).float()
    return (streams.cuda(), cdf.cuda(), payload, lens,
            maxes[..., 0].reshape(nchunks, N, L, T).contiguous().cuda(),
            half.cuda())


def gen_cpu(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("window", [(0, 0), (7, 3)], ids=["all", "window"])
@pytest.mark.parametrize("fmt", ["vllm", "huggingface"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("name", BLOB_GEOMETRIES)
def test_fused_decode_is_decode_then_symbols_to_blob(gen, name, dtype, fmt,
                                                     window):
    """The fused entry's blob, bit for bit, against decode_streams and the
    serde's dequantization on the card, over every layout the remote path
    gives it; one launch, counted under row 11."""
    from lmcache_tpu_torch.storage.serde import cachegen_serde as cgs
    from lmcache_tpu_torch.storage.serde.raw_serde import dtype_name
    nchunks, N, L, H, D, T, g = BLOB_GEOMETRIES[name]
    streams, cdf, payload, lens, maxes, half = _blob_case(name)
    pay, offs = _on_card(payload, lens, shift=3)
    geo = dict(nchunks=nchunks, L=L, H=H, D=D, T=T, g=g, N=N,
               tok_start=window[0], tok_stop=nchunks * T - window[1])
    sym = rd.decode_streams(pay, offs, cdf, g * T)
    assert torch.equal(sym, streams)
    want = cgs.symbols_to_blob(sym, maxes, half, fmt=fmt,
                               dtype=dtype_name(dtype), **geo)
    before = rd.decode_streams.launches["retrieve"]
    got = rd.decode_to_blob(pay, offs, cdf, maxes, half,
                            hf=fmt == "huggingface", dtype=dtype, **geo)
    torch.cuda.synchronize()
    assert rd.decode_streams.launches["retrieve"] == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    bits = torch.int16 if dtype != torch.float32 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


def test_fused_decode_of_a_collapsed_stream_ends_in_zeros(gen):
    """The fused entry on a stream whose CDF does not rise: its channel
    holds symbol 0's value after the collapse, as the plain version."""
    streams, cdf, payload, lens, maxes, half = _blob_case("kv_g1")
    nchunks, N, L, H, D, T, g = BLOB_GEOMETRIES["kv_g1"]
    cdf[3] = torch.tensor([0, 60000, 50, 50] + list(range(60001, 60030)),
                          dtype=torch.int32).to(torch.int16)
    offs = np.concatenate([[0], np.cumsum(lens)])
    payload = (payload[:offs[3]] + bytes([0x10, 0x20, 0x30, 0x40, 0x50])
               + payload[offs[4]:])
    lens = lens.copy()
    lens[3] = 5
    pay, offs = _on_card(payload, lens)
    geo = dict(nchunks=nchunks, L=L, H=H, D=D, T=T, g=g, N=N, hf=False,
               dtype=torch.float32, tok_start=0, tok_stop=nchunks * T)
    got = rd.decode_to_blob(pay, offs, cdf, maxes, half, **geo)
    want = rd.decode_to_blob(pay.cpu(), offs.cpu(), cdf.cpu(), maxes.cpu(),
                             half.cpu(), **geo)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    h0 = half[0, 0].item()
    assert torch.equal(got[0, 0, 1:T, 0, 3].cpu(),
                       (0 - h0) * maxes[0, 0, 0, 1:].cpu() / h0)


def test_fused_decode_refuses_what_it_does_not_take(gen):
    streams, cdf, payload, lens, maxes, half = _blob_case("kv_g4")
    nchunks, N, L, H, D, T, g = BLOB_GEOMETRIES["kv_g4"]
    pay, offs = _on_card(payload, lens)
    geo = dict(nchunks=nchunks, L=L, H=H, D=D, T=T, g=g, N=N, hf=False,
               dtype=torch.bfloat16, tok_start=0, tok_stop=nchunks * T)
    with pytest.raises(ValueError, match="maxes"):
        rd.decode_to_blob(pay, offs, cdf, maxes.double(), half, **geo)
    with pytest.raises(ValueError, match="streams"):
        rd.decode_to_blob(pay, offs, cdf, maxes, half, **{**geo, "g": 2})
    with pytest.raises(ValueError, match="window"):
        rd.decode_to_blob(pay, offs, cdf, maxes, half,
                          **{**geo, "tok_stop": nchunks * T + 1})
    with pytest.raises(ValueError, match="writes"):
        rd.decode_to_blob(pay, offs, cdf, maxes, half,
                          **{**geo, "dtype": torch.int8})


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


def _latent_call(quant, q, rows, row_scale, qo, kl, **kw):
    if quant:
        return la.quantized_latent_flash_attention(q, rows, row_scale, qo,
                                                   kl, **kw)
    return la.latent_flash_attention(q, rows, qo, kl, **kw)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("H", [16, 128])
def test_latent_nan_tails_past_kv_len_contribute_nothing(gen, H, quant):
    """Latent rows (int8: their scales) at and past kv_len hold NaN (TMA
    loads whole boxes, and 0 * NaN is NaN): the outputs stay finite and
    equal the plain version's on zeroed tails, for a prefill over a prefix
    (T * H rows no multiple of 64 at H 16) and a ragged decode."""
    _, C, rank, _ = LATENT_GEOMETRY["v2_lite"]
    kw = dict(rank=rank, scale=LATENT_SCALE)
    for B, T, S, q_off in ((2, 37 if H == 16 else 3, 300, [100, 0]),
                           (3, 1, 257, [200, 5, 0])):
        q = torch.randn((B, T, H, C), generator=gen,
                        device="cuda").bfloat16()
        rows, scale = _latent_rows(gen, (B, S, C), quant)
        qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
        kl = qo + T
        past = torch.arange(S, device="cuda")[None, :] >= kl[:, None]
        if quant:
            clean = (rows, scale.masked_fill(past, 0))
            out = _latent_call(True, q, rows, scale.masked_fill(
                past, float("nan")), qo, kl, **kw)
            ref = la.quantized_latent_attention_reference(
                q, *clean, qo, kl, zero_dead_rows=True, **kw)
        else:
            clean = rows.masked_fill(past[..., None], 0)
            out = _latent_call(False, q, rows.masked_fill(
                past[..., None], float("nan")), None, qo, kl, **kw)
            ref = la.latent_attention_reference(q, clean, qo, kl,
                                                zero_dead_rows=True, **kw)
        _assert_latent_close(out, ref, kl)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_latent_launches_repeat_bits_and_a_decode_row_alone(gen, quant):
    """Two launches give the same bits (a prefill over a prefix), and a
    decode row gives the same bits alone and among three others of other
    lengths."""
    H, C, rank, _ = LATENT_GEOMETRY["v2_lite"]
    kw = dict(rank=rank, scale=LATENT_SCALE)
    q = torch.randn((2, 300, H, C), generator=gen, device="cuda").bfloat16()
    rows, scale = _latent_rows(gen, (2, 2048, C), quant)
    qo = torch.tensor([1700, 0], dtype=torch.int32, device="cuda")
    first = _latent_call(quant, q, rows, scale, qo, qo + 300, **kw)
    again = _latent_call(quant, q, rows, scale, qo, qo + 300, **kw)
    assert torch.equal(first, again)
    q = torch.randn((4, 1, H, C), generator=gen, device="cuda").bfloat16()
    rows, scale = _latent_rows(gen, (4, 4097, C), quant)
    qo = torch.tensor([3000, 4096, 17, 1500], dtype=torch.int32,
                      device="cuda")
    together = _latent_call(quant, q, rows, scale, qo, qo + 1, **kw)
    for i in range(4):
        alone = _latent_call(quant, q[i:i + 1], rows[i:i + 1],
                             None if scale is None else scale[i:i + 1],
                             qo[i:i + 1], qo[i:i + 1] + 1, **kw)
        assert torch.equal(alone, together[i:i + 1])


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
    # pages that row 10 takes and row 9 does not: larger than its tile
    # fits, and no multiple of 16
    "prefill_page128": (2, 40, 128, [300, 0], [340, 40]),
    "decode_page24": (3, 1, 24, [500, 23, 0], [501, 24, 1]),
}


def _paged_latent_inputs(gen, quant, geom, B, T, page, kv_len, spare=2):
    """A layer's slice of a lane-padded arena [L, P, page, Cp] and a
    fragmented table whose dead trailing slots hold ids outside the pool
    (-7 or 2**20); returns (q, arena, scales, table, P)."""
    H, C, rank, Cp = LATENT_GEOMETRY[geom]
    NP = -(-max(kv_len) // page) + spare
    P = B * NP + 3
    q = torch.randn((B, T, H, C), generator=gen, device="cuda").bfloat16()
    arena, scales = _latent_rows(gen, (2, P, page, Cp), quant)
    arena[..., C:] = 0  # the lane pad, as the model writes it
    ids = torch.randperm(P - 1, generator=gen, device="cuda")[:B * NP] + 1
    table = ids.reshape(B, NP).to(torch.int32)
    for b, n in enumerate(kv_len):
        table[b, -(-n // page):] = -7 if b % 2 else 1 << 20
    return (q, arena[1], None if scales is None else scales[1],
            table.contiguous(), P)


def _paged_latent_call(entry, quant, q, arena, scales, table, qo, kl, **kw):
    if quant:
        return entry(q, arena, scales, table, qo, kl, **kw)
    return entry(q, arena, table, qo, kl, **kw)


def _paged_latent_plain(quant, q, arena, scales, table, qo, kl, **kw):
    if quant:
        return pla.quantized_paged_latent_attention_reference(
            q, arena, scales, table, qo, kl, zero_dead_rows=True, **kw)
    return pla.paged_latent_attention_reference(
        q, arena, table, qo, kl, zero_dead_rows=True, **kw)


@pytest.mark.parametrize("case", sorted(PAGED_LATENT_CASES))
@pytest.mark.parametrize("geom", sorted(LATENT_GEOMETRY))
@pytest.mark.parametrize("kind", sorted(PAGED_LATENT))
def test_paged_latent_kernel_matches_plain(gen, kind, geom, case):
    """A layer's slice of a lane-padded arena [L, P, page, Cp], a fragmented
    table whose dead trailing slots hold ids outside the pool, queries of
    the logical width C; row 9 refuses the pages its tile does not take."""
    entry, quant = PAGED_LATENT[kind]
    H, C, rank, Cp = LATENT_GEOMETRY[geom]
    B, T, page, q_off, kv_len = PAGED_LATENT_CASES[case]
    if geom == "v3_heads":
        T = 1  # H = 128 is held at decode, where the path gives it
        kv_len = [o + 1 for o in q_off]
    q, arena, scales, table, P = _paged_latent_inputs(
        gen, quant, geom, B, T, page, kv_len)
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    kw = dict(rank=rank, scale=LATENT_SCALE)
    if kind.startswith("grid") and (page % 16 or page > pla.max_page(quant)):
        with pytest.raises(ValueError, match=f"page size {page}"):
            _paged_latent_call(entry, quant, q, arena, scales, table, qo, kl,
                               **kw)
        return
    phase = "decode" if T == 1 else "prefill"
    before = entry.launches[phase]
    out = _paged_latent_call(entry, quant, q, arena, scales, table, qo, kl,
                             **kw)
    # the plain version gathers every slot
    ref = _paged_latent_plain(quant, q, arena, scales, table.clamp(0, P - 1),
                              qo, kl, **kw)
    assert entry.launches[phase] == before + 1
    _assert_latent_close(out, ref, kl)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("page", [7, 12, 20])
def test_paged_latent_stream_takes_pages_of_any_size(gen, page, quant):
    """Row 10 at pages whose TMA box is a few rows (page 12 and 20: 4; page
    7: one row, which int8 rows read without TMA), at prefill and in the
    split decode."""
    entry = (pla.quantized_paged_latent_attention_dma if quant
             else pla.paged_latent_attention_dma)
    H, C, rank, Cp = LATENT_GEOMETRY["v2_lite"]
    kw = dict(rank=rank, scale=LATENT_SCALE)
    for T in (1, 40):
        kv_len = [700, 333]
        q, arena, scales, table, P = _paged_latent_inputs(
            gen, quant, "v2_lite", 2, T, page, kv_len)
        kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        out = _paged_latent_call(entry, quant, q, arena, scales, table,
                                 kl - T, kl, **kw)
        ref = _paged_latent_plain(quant, q, arena, scales,
                                  table.clamp(0, P - 1), kl - T, kl, **kw)
        _assert_latent_close(out, ref, kl)


@pytest.mark.parametrize("kind", sorted(PAGED_LATENT))
def test_paged_latent_nan_past_kv_len_and_in_dead_pages(gen, kind):
    """NaN in the latent rows (int8: their scales) at and past kv_len inside
    the last live page, and in every page that a dead slot names: neither
    is read into the result, which stays finite and equals the plain
    version on clean rows."""
    entry, quant = PAGED_LATENT[kind]
    H, C, rank, Cp = LATENT_GEOMETRY["v2_lite"]
    kw = dict(rank=rank, scale=LATENT_SCALE)
    for B, T, q_off in ((2, 37, [100, 0]), (3, 1, [1300, 40, 0])):
        kv_len = [o + T for o in q_off]
        q, arena, scales, table, P = _paged_latent_inputs(
            gen, quant, "v2_lite", B, T, 64, kv_len)
        dead = torch.ones(P, dtype=torch.bool, device="cuda")
        for b, n in enumerate(kv_len):
            dead[table[b, :-(-n // 64)].long()] = False
        past = torch.zeros((P, 64), dtype=torch.bool, device="cuda")
        for b, n in enumerate(kv_len):
            live = -(-n // 64)
            # in-pool ids for the dead slots: pages of nothing but NaN
            table[b, live:] = torch.nonzero(dead)[b, 0].int()
            if n % 64:
                past[table[b, live - 1].long(), n % 64:] = True
        past |= dead[:, None]
        qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
        kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        if quant:
            clean = scales.masked_fill(past, 0)
            out = entry(q, arena, scales.masked_fill(past, float("nan")),
                        table, qo, kl, **kw)
            ref = _paged_latent_plain(True, q, arena, clean, table, qo, kl,
                                      **kw)
        else:
            clean = arena.masked_fill(past[..., None], 0)
            out = entry(q, arena.masked_fill(past[..., None], float("nan")),
                        table, qo, kl, **kw)
            ref = _paged_latent_plain(False, q, clean, None, table, qo, kl,
                                      **kw)
        _assert_latent_close(out, ref, kl)


@pytest.mark.parametrize("kind", sorted(PAGED_LATENT))
def test_paged_latent_id_outside_the_pool_reads_zeros(gen, kind):
    """A live slot naming a page outside the pool (past it, or negative)
    reads as latent rows of zeros (int8: scale 0), as the old kernels
    did."""
    entry, quant = PAGED_LATENT[kind]
    H, C, rank, Cp = LATENT_GEOMETRY["v2_lite"]
    kw = dict(rank=rank, scale=LATENT_SCALE)
    for T, q_off in ((1, [300, 200]), (40, [250, 150])):
        kv_len = [o + T for o in q_off]
        q, arena, scales, table, P = _paged_latent_inputs(
            gen, quant, "v2_lite", 2, T, 64, kv_len)
        table[0, 1] = P + 5
        table[1, 2] = -3
        # the plain version reads those slots from an appended zero page
        zero_arena = torch.cat([arena, torch.zeros_like(arena[:1])])
        ref_table = table.clone()
        ref_table[0, 1] = ref_table[1, 2] = P
        ref_table = ref_table.clamp(0, P)
        qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
        kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        out = _paged_latent_call(entry, quant, q, arena, scales, table, qo,
                                 kl, **kw)
        zero_scales = (None if scales is None else
                       torch.cat([scales, torch.zeros_like(scales[:1])]))
        ref = _paged_latent_plain(quant, q, zero_arena, zero_scales,
                                  ref_table, qo, kl, **kw)
        _assert_latent_close(out, ref, kl)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("geom", ["tiny", "v2_lite", "v3_heads"])
def test_latent_split_decode_edges(gen, geom, quant):
    """Row 10's split decode at kv_len 0, 1, exactly one split, one key past
    a split, and 16k keys over fragmented pages, each row against the plain
    version, and the partials' combine counted under its own wrapper."""
    entry = (pla.quantized_paged_latent_attention_dma if quant
             else pla.paged_latent_attention_dma)
    H, C, rank, Cp = LATENT_GEOMETRY[geom]
    n = pla.split_keys(1, H)
    kv_len = [0, 1, n, n + 1, 16384]
    q, arena, scales, table, P = _paged_latent_inputs(
        gen, quant, geom, 5, 1, 64, kv_len)
    qo = torch.tensor([max(k - 1, 0) for k in kv_len], dtype=torch.int32,
                      device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    kw = dict(rank=rank, scale=LATENT_SCALE)
    assert pla.takes_split(1, H)
    before = (entry.launches["decode"], pla.combine_partials.launches["decode"])
    out = _paged_latent_call(entry, quant, q, arena, scales, table, qo, kl,
                             **kw)
    assert (entry.launches["decode"],
            pla.combine_partials.launches["decode"]) == (before[0] + 1,
                                                         before[1] + 1)
    ref = _paged_latent_plain(quant, q, arena, scales, table.clamp(0, P - 1),
                              qo, kl, **kw)
    _assert_latent_close(out, ref, kl)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_latent_launches_repeat_bits_and_a_decode_row_alone(gen, quant):
    """Row 10: two launches give the same bits (a prefill over a prefix and a
    split decode), and a decode row gives the same bits alone and among
    three others of other lengths."""
    entry = (pla.quantized_paged_latent_attention_dma if quant
             else pla.paged_latent_attention_dma)
    H, C, rank, Cp = LATENT_GEOMETRY["v2_lite"]
    kw = dict(rank=rank, scale=LATENT_SCALE)
    q, arena, scales, table, P = _paged_latent_inputs(
        gen, quant, "v2_lite", 2, 300, 64, [2000, 300])
    qo = torch.tensor([1700, 0], dtype=torch.int32, device="cuda")
    args = (arena, scales) if quant else (arena,)
    first = entry(q, *args, table, qo, qo + 300, **kw)
    again = entry(q, *args, table, qo, qo + 300, **kw)
    assert torch.equal(first, again)
    kv_len = [3001, 4097, 18, 1501]
    q, arena, scales, table, P = _paged_latent_inputs(
        gen, quant, "v2_lite", 4, 1, 64, kv_len)
    args = (arena, scales) if quant else (arena,)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    together = entry(q, *args, table, kl - 1, kl, **kw)
    assert torch.equal(together, entry(q, *args, table, kl - 1, kl, **kw))
    for i in range(4):
        alone = entry(q[i:i + 1], *args, table[i:i + 1].contiguous(),
                      kl[i:i + 1] - 1, kl[i:i + 1], **kw)
        assert torch.equal(alone, together[i:i + 1])


def test_latent_combine_matches_plain_with_empty_partials(gen):
    """The latent combine alone against its plain version, on partials of
    the plain split over 3k keys in which whole splits of some rows are
    empty (kv_len 0 and 1 among them)."""
    H, C, rank, Cp = LATENT_GEOMETRY["v2_lite"]
    kv_len = [0, 1, 600, 3000]
    q, arena, _, table, P = _paged_latent_inputs(
        gen, False, "v2_lite", 4, 1, 64, kv_len)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    part_o, part_ml = pla.paged_latent_split_partials_reference(
        q, arena, table.clamp(0, P - 1), (kl - 1).clamp(min=0), kl,
        rank=rank, scale=LATENT_SCALE)
    assert (part_ml[..., 1] == 0).any() and (part_ml[..., 1] > 0).any()
    before = pla.combine_partials.launches["decode"]
    out = pla.combine_partials(part_o, part_ml, 1, H)
    assert pla.combine_partials.launches["decode"] == before + 1
    ref = pla.combine_partials_reference(part_o, part_ml, 1, H)
    _assert_latent_close(out, ref, kl)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("page", [16, 32, 64])
def test_paged_latent_prefill_against_the_dense_kernel(gen, page, quant):
    """Row 10 at prefill and row 8 on the same rows laid out densely: tiles
    of the same 32 keys in the same order give the same bits, and so does
    row 9 at page 32; row 9's tile (the page) differs from row 8's at the
    other pages, which hold it within the tolerance."""
    H, C, rank, Cp = LATENT_GEOMETRY["v2_lite"]
    kw = dict(rank=rank, scale=LATENT_SCALE)
    kv_len = [1100, 600]
    q, arena, scales, table, P = _paged_latent_inputs(
        gen, quant, "v2_lite", 2, 100, page, kv_len, spare=0)
    qo = torch.tensor([1000, 500], dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    NP = table.shape[1]
    dense = arena[table.clamp(0, P - 1).long()][..., :C].reshape(
        2, NP * page, C).contiguous()
    if quant:
        dscale = scales[table.clamp(0, P - 1).long()].reshape(2, NP * page)
        row8 = la.quantized_latent_flash_attention(q, dense, dscale, qo, kl,
                                                   **kw)
        row10 = pla.quantized_paged_latent_attention_dma(
            q, arena, scales, table, qo, kl, **kw)
        row9 = pla.quantized_paged_latent_attention(q, arena, scales, table,
                                                    qo, kl, **kw)
    else:
        row8 = la.latent_flash_attention(q, dense, qo, kl, **kw)
        row10 = pla.paged_latent_attention_dma(q, arena, table, qo, kl, **kw)
        row9 = pla.paged_latent_attention(q, arena, table, qo, kl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(row10, row8)
    if page == 32:
        assert torch.equal(row9, row8)
    else:
        _assert_latent_close(row9, row8.float(), kl)


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
    # the dense kernel takes every preset's widths, 576 and 512, at most
    wide = torch.zeros((1, 1, 4, 592), device="cuda").bfloat16()
    with pytest.raises(ValueError, match="at most 576"):
        la.latent_flash_attention(wide, torch.zeros(
            (1, 16, 592), device="cuda").bfloat16(), one, one, rank=512,
            scale=0.1)
    pool = torch.zeros((4, 24, 128), device="cuda").bfloat16()
    table = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="page size 24"):
        pla.paged_latent_attention(qb, pool, table, one, one, rank=64,
                                   scale=0.1)
    # the streaming kernel takes any page size
    pla.paged_latent_attention_dma(qb, pool, table, one, one, rank=64,
                                   scale=0.1)
    torch.cuda.synchronize()
    # row 9's largest pages: one stage of a tile of the page fits
    assert (pla.max_page(False), pla.max_page(True)) == (112, 80)
    big = torch.zeros((4, 128, 128), device="cuda").bfloat16()
    with pytest.raises(ValueError, match="page size 128"):
        pla.paged_latent_attention(qb, big, table, one, one, rank=64,
                                   scale=0.1)


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
    B, Hkv, G, D, S = VARIANT_GEOMETRY[geom]
    q_off, kv_len, bq, bk = VARIANT_SCENARIOS[scen]
    return _variant_case(gen, B, Hkv, G, D, S, q_off[:B],
                         (kv_len or [S] * B)[:B], bq, bk)


def _variant_case(gen, B, Hkv, G, D, S, q_off, kv_len, bq, bk):
    from lmcache_tpu_torch.ops import prefill_variants as pv
    Tp = -(-S // bq) * bq
    q = torch.randn((B, Hkv * G, Tp, D), generator=gen,
                    device="cuda").bfloat16()
    k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return pv, (q, k, v, qo, kl), dict(bq=bq, bk=bk)


def _variant_entry(pv, variant):
    """(mode, pair, entry point, wrapper that counts) of a variant name."""
    mode = {"pair": "full", "pipelined": "full"}.get(
        variant, variant.replace("pair_", ""))
    pair = variant.startswith("pair")
    if variant == "pipelined":
        return mode, pair, pv.pipelined_attention, pv.pipelined_attention
    return mode, pair, (lambda *a, **k: pv.variant_attention(
        *a, mode=mode, pair=pair, **k)), pv.variant_attention


def _hold_variant(pv, args, kw, variant):
    """One launch of the variant held against its plain version: the bf16
    gate of row 1 for the softmax variants; mxu_only's unnormalized sums
    by relative L2 within 1e-2. Returns the output, or None where the
    wrapper refuses the case as it should."""
    S, bk = args[1].shape[2], kw["bk"]
    mode, pair, entry, wrapper = _variant_entry(pv, variant)
    if mode != "full" and S % bk:
        with pytest.raises(ValueError, match="multiple of bk"):
            pv.variant_attention(*args, mode=mode, pair=pair, **kw)
        return None
    if pair and (-(-S // bk)) % 2:
        with pytest.raises(ValueError, match="odd number of key blocks"):
            pv.variant_attention(*args, mode=mode, pair=True, **kw)
        return None
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
    return out


VARIANTS = ["full", "no_mask", "mxu_only", "pair", "pair_no_mask",
            "pair_mxu_only", "pipelined"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("scen", sorted(VARIANT_SCENARIOS))
@pytest.mark.parametrize("geom", sorted(VARIANT_GEOMETRY))
def test_prefill_variant_matches_plain(gen, geom, scen, variant):
    """Each variant against its plain version: the bf16 gate of row 1 for
    the softmax variants; mxu_only's unnormalized sums (values of order 10)
    by relative L2 within 1e-2."""
    pv, args, kw = _variant_inputs(gen, geom, scen)
    _hold_variant(pv, args, kw, variant)


@pytest.mark.parametrize("bk", [64, 192])
@pytest.mark.parametrize("variant", ["no_mask", "mxu_only", "pair_no_mask",
                                     "full"])
def test_prefill_variant_consumers_in_two_query_blocks(gen, variant, bk):
    """G 1 at bq 64: a block's 128 rows are two logical query blocks, so
    its two consumers visit different keys (the unmasked modes every key
    of their own live blocks; at bk 192 the live limit ends inside a
    128-key tile)."""
    pv, args, kw = _variant_case(gen, 2, 2, 1, 128, 384, [0, 40],
                                 [384, 300], 64, bk)
    assert _hold_variant(pv, args, kw, variant) is not None


@pytest.mark.parametrize("D, S", [(64, 128), (64, 256), (64, 384),
                                  (64, 192), (128, 64), (128, 128),
                                  (128, 192), (128, 256)])
@pytest.mark.parametrize("variant", ["pair", "pair_no_mask", "pipelined"])
def test_prefill_variant_one_two_and_three_tiles(gen, variant, D, S):
    """Sequences of one, two, three and four key tiles (128 keys at D 64,
    64 at D 128; one and a half at D 64, S 192): pipelined's drain step
    alone and after one or more steps; pair's two tiles, and its lone last
    tile where the causal limit leaves an odd count. pair over an odd count
    of key blocks of 64 is refused."""
    pv, args, kw = _variant_case(gen, 2, 2, 4, D, S, [0, S // 2],
                                 [S, S - 50], 64, 64)
    _hold_variant(pv, args, kw, variant)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("geom, scen", [("d64_group8", "wide_blocks"),
                                        ("tool_small", "causal")])
def test_prefill_variant_bits_repeat(gen, geom, scen, variant):
    """Two launches of each variant give the same bits (no float atomics,
    a fixed order of every sum): at D 64, where every schedule takes
    128-key tiles, and at D 128, where pair and pipelined take 64-key tiles
    in a ring of four stages."""
    pv, args, kw = _variant_inputs(gen, geom, scen)
    _, _, entry, _ = _variant_entry(pv, variant)
    first = entry(*args, **kw)
    second = entry(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


# the verification shape of spec_lookahead: T = 5 a row over four rows of
# different kv_len, the K/V past each kv_len random (what the rejected
# proposals of earlier verifications leave there)

VERIFY_B, VERIFY_T = 4, 5
VERIFY_OFF = [2080, 1500, 700, 31]
VERIFY_LEN = [o + VERIFY_T for o in VERIFY_OFF]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("G, D", [(8, 64), (1, 96), (4, 128)])
def test_dense_kernels_at_the_verification_shape(gen, G, D, quant):
    """Rows 1 and 3: 40 rows a block at tinyllama's G 8 (the body), 5 at
    G 1 (the key split)."""
    _dense_check(gen, quant, VERIFY_B, VERIFY_T, G, D, 2117, VERIFY_OFF,
                 VERIFY_LEN)


@pytest.mark.parametrize("kind, G, D", [
    (k, G, D) for k in sorted(PAGED) for G, D in ((8, 64), (1, 96))
    if D in PAGED[k][2]])
def test_paged_kernels_at_the_verification_shape(gen, kind, G, D):
    """Rows 4-7 over pages of 64 (Phi-3's window at D 96)."""
    _paged_check(gen, kind, VERIFY_B, VERIFY_T, G, D, 64, VERIFY_OFF,
                 VERIFY_LEN, window=2047 if D == 96 else None)


@pytest.mark.parametrize("kind", ["dense_bf16", "dense_int8"]
                         + sorted(PAGED_LATENT))
def test_latent_kernels_at_the_verification_shape(gen, kind):
    """Rows 8-10 at DeepSeek-V2-Lite's latent (80 rows: row 10's key
    split), the paged arena in pages of 64."""
    H, C, rank, _ = LATENT_GEOMETRY["v2_lite"]
    kw = dict(rank=rank, scale=LATENT_SCALE)
    qo = torch.tensor(VERIFY_OFF, dtype=torch.int32, device="cuda")
    kl = torch.tensor(VERIFY_LEN, dtype=torch.int32, device="cuda")
    if kind.startswith("dense"):
        quant = kind == "dense_int8"
        q = torch.randn((VERIFY_B, VERIFY_T, H, C), generator=gen,
                        device="cuda").bfloat16()
        rows, scale = _latent_rows(gen, (VERIFY_B, 2117, C), quant)
        entry = (la.quantized_latent_flash_attention if quant
                 else la.latent_flash_attention)
        before = entry.launches["prefill"]
        if quant:
            out = entry(q, rows, scale, qo, kl, **kw)
            ref = la.quantized_latent_attention_reference(
                q, rows, scale, qo, kl, zero_dead_rows=True, **kw)
        else:
            out = entry(q, rows, qo, kl, **kw)
            ref = la.latent_attention_reference(q, rows, qo, kl,
                                                zero_dead_rows=True, **kw)
    else:
        entry, quant = PAGED_LATENT[kind]
        q, arena, scales, table, P = _paged_latent_inputs(
            gen, quant, "v2_lite", VERIFY_B, VERIFY_T, 64, VERIFY_LEN)
        before = entry.launches["prefill"]
        out = _paged_latent_call(entry, quant, q, arena, scales, table, qo,
                                 kl, **kw)
        ref = _paged_latent_plain(quant, q, arena, scales,
                                  table.clamp(0, P - 1), qo, kl, **kw)
    assert entry.launches["prefill"] == before + 1
    _assert_latent_close(out, ref, kl)
