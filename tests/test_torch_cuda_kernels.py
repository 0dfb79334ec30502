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
