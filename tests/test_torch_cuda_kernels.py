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


@pytest.mark.parametrize("D", [64, 128])
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
