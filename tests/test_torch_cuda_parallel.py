"""Each rank's kernel launches on its head slice, on the card: rows 1 and 3-7
on contiguous head slices of q and of the pools or arenas give the
unsharded launch's bits (heads are independent and every rank keeps the
query group), rows 8-10 on slices of the query heads hold the plain
version's tolerance, and a mesh engine on a one-rank NCCL group gives the
tokens of the engine without one. ``chip_smoke.py`` phase 22 runs the same
at full width.

These tests need an NVIDIA GPU with ``nvcc``; they carry the ``cuda`` marker
and skip elsewhere:

    python -m pytest --noconftest tests/test_torch_cuda_parallel.py -q -m cuda
"""

import os
import tempfile

import pytest
import torch

from lmcache_tpu_torch import ops
from lmcache_tpu_torch.models import llama
from lmcache_tpu_torch.ops import latent_attention as la
from lmcache_tpu_torch.ops import paged_attention as pa
from lmcache_tpu_torch.ops import paged_latent_attention as pla
from lmcache_tpu_torch.ops import quantized_attention as qa
from lmcache_tpu_torch.parallel.mesh import take_slice

pytestmark = pytest.mark.cuda

# bf16 outputs against the fp32 plain versions (one ulp near 4 is 1.6e-2)
ATOL = 2e-2
PAGE = 64


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _ranks(call, args, axes, tp):
    """Each rank's launch on its contiguous slice of every head axis, the
    outputs put back together along the head axis."""
    return torch.cat([call(*[a if d is None else
                             take_slice(a, d, r, tp).contiguous()
                             for a, d in zip(args, axes)])
                      for r in range(tp)], dim=2)


def _shape(kind):
    """(B, T, q_off, S): a 256-token segment over a 2048-key context, or a
    decode step of two rows."""
    if kind == "prefill":
        return 1, 256, [2048 - 256], 2048
    return 2, 1, [2047, 900], 2048


def _dense_args(gen, kind, H, Hkv, D):
    B, T, q_off, S = _shape(kind)
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").bfloat16()
    kv = torch.randn((2, B, Hkv, S, D), generator=gen,
                     device="cuda").bfloat16()
    sym = torch.randint(-127, 128, (2, B, Hkv, S, D), generator=gen,
                        device="cuda", dtype=torch.int32).to(torch.int8)
    scl = torch.rand((2, B, S), generator=gen, device="cuda") * 0.02 + 0.02
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor([o + T for o in q_off], dtype=torch.int32,
                      device="cuda")
    NP = S // PAGE
    table = (torch.randperm(B * NP, generator=gen, device="cuda") + 1
             ).reshape(B, NP).to(torch.int32).contiguous()

    def paged(x):
        if x.dim() == 2:  # scales [B, S] -> [P, page]
            out = torch.ones((B * NP + 1, PAGE), device="cuda")
            out[table.long()] = x.reshape(B, NP, PAGE)
            return out
        out = torch.zeros((B * NP + 1, Hkv, PAGE, D), dtype=x.dtype,
                          device="cuda")
        out[table.long()] = x.reshape(B, Hkv, NP, PAGE, D).transpose(1, 2)
        return out

    ref = ops.mha_reference(q, kv[0].transpose(1, 2), kv[1].transpose(1, 2),
                            qo, kl)
    ref_q = qa.quantized_attention_reference(
        q, sym[0].transpose(1, 2), sym[1].transpose(1, 2), scl[0], scl[1],
        qo, kl)
    return {
        "flash_attention": (lambda *a: ops.flash_attention(
            *a, kv_head_major=True), (q, kv[0], kv[1], qo, kl), ref),
        "quantized_flash_attention": (
            lambda *a: qa.quantized_flash_attention(*a, kv_head_major=True),
            (q, sym[0], sym[1], scl[0], scl[1], qo, kl), ref_q),
        "paged_attention": (pa.paged_attention,
                            (q, paged(kv[0]), paged(kv[1]), table, qo, kl),
                            ref),
        "paged_attention_dma": (pa.paged_attention_dma,
                                (q, paged(kv[0]), paged(kv[1]), table, qo,
                                 kl), ref),
        "quantized_paged_attention": (
            pa.quantized_paged_attention,
            (q, paged(sym[0]), paged(sym[1]), paged(scl[0]), paged(scl[1]),
             table, qo, kl), ref_q),
        "quantized_paged_attention_dma": (
            pa.quantized_paged_attention_dma,
            (q, paged(sym[0]), paged(sym[1]), paged(scl[0]), paged(scl[1]),
             table, qo, kl), ref_q),
    }


DENSE_ROWS = ["flash_attention", "quantized_flash_attention",
              "paged_attention", "paged_attention_dma",
              "quantized_paged_attention", "quantized_paged_attention_dma"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("H, Hkv, D, tp", [(32, 4, 64, 2), (32, 4, 64, 4),
                                           (32, 8, 128, 8)])
@pytest.mark.parametrize("name", DENSE_ROWS)
def test_rows_1_3_to_7_on_head_slices_give_the_same_bits(gen, name, H, Hkv,
                                                         D, tp, kind):
    call, args, ref = _dense_args(gen, kind, H, Hkv, D)[name]
    axes = (2, 1, 1) + (None,) * (len(args) - 3)
    whole = call(*args)
    got = _ranks(call, args, axes, tp)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), whole.view(torch.int16))
    torch.testing.assert_close(got.float(), ref.float(), atol=ATOL,
                               rtol=2.0**-7)


LATENT_ROWS = ["latent_flash_attention", "quantized_latent_flash_attention",
               "paged_latent_attention", "quantized_paged_latent_attention",
               "paged_latent_attention_dma",
               "quantized_paged_latent_attention_dma"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("tp", [2, 4, 16])
@pytest.mark.parametrize("name", LATENT_ROWS)
def test_rows_8_to_10_on_query_head_slices_hold_the_plain_version(
        gen, name, tp, kind):
    """DeepSeek-V2-Lite's latent geometry (16 heads, latent 576, rank 512):
    a rank's launch of 16 / tp query heads over the whole latents (row 10's
    route by T * H named in the id of its split)."""
    B, T, q_off, S = _shape(kind)
    H, C, R, Cp = 16, 576, 512, 640
    q = torch.randn((B, T, H, C), generator=gen, device="cuda").bfloat16()
    lat = torch.randn((B, S, C), generator=gen, device="cuda").bfloat16()
    sym = torch.randint(-127, 128, (B, S, C), generator=gen, device="cuda",
                        dtype=torch.int32).to(torch.int8)
    scl = torch.rand((B, S), generator=gen, device="cuda") * 0.02 + 0.02
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor([o + T for o in q_off], dtype=torch.int32,
                      device="cuda")
    NP = S // PAGE
    table = (torch.randperm(B * NP, generator=gen, device="cuda") + 1
             ).reshape(B, NP).to(torch.int32).contiguous()
    a_lat = torch.zeros((B * NP + 1, PAGE, Cp), dtype=torch.bfloat16,
                        device="cuda")
    a_lat[table.long(), :, :C] = lat.reshape(B, NP, PAGE, C)
    a_sym = torch.zeros((B * NP + 1, PAGE, Cp), dtype=torch.int8,
                        device="cuda")
    a_sym[table.long(), :, :C] = sym.reshape(B, NP, PAGE, C)
    a_scl = torch.ones((B * NP + 1, PAGE), device="cuda")
    a_scl[table.long()] = scl.reshape(B, NP, PAGE)
    kw = dict(rank=R, scale=C**-0.5)
    quant = name.startswith("quantized")
    args = {"latent_flash_attention": (q, lat, qo, kl),
            "quantized_latent_flash_attention": (q, sym, scl, qo, kl)}.get(
                name, (q, a_sym, a_scl, table, qo, kl) if quant
                else (q, a_lat, table, qo, kl))
    entry = getattr(la if "paged" not in name else pla, name)
    ref = (la.quantized_latent_attention_reference(
        q, sym, scl, qo, kl, zero_dead_rows=True, **kw) if quant
        else la.latent_attention_reference(q, lat, qo, kl,
                                           zero_dead_rows=True, **kw))
    if name.endswith("_dma"):
        # the route of this rank's launch: the split at T * H <= 128 rows
        assert pla.takes_split(T, H // tp) == (kind == "decode")
    got = _ranks(lambda *a: entry(*a, **kw), args,
                 (2,) + (None,) * (len(args) - 1), tp)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=ATOL,
                               rtol=2.0**-7)


def test_mesh_engine_on_a_one_rank_nccl_group(gen):
    """A dense engine with ``mesh=`` on a one-rank NCCL group gives the
    tokens of the engine without a mesh, bit for bit."""
    import torch.distributed as dist
    from lmcache_tpu_torch.parallel import MeshConfig, make_mesh, shard_params
    from lmcache_tpu_torch.serving import SamplingParams, ServingEngine
    cfg = llama.LlamaConfig.tiny(n_layers=2, n_heads=8, n_kv_heads=4,
                                 dim=512, hidden_dim=512, dtype="bfloat16")
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        3))
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device="cuda").cpu().numpy() for n in (40, 70)]
    sp = SamplingParams(max_new_tokens=6)
    want = [r.output_tokens for r in ServingEngine(
        cfg, params, max_batch=2, max_seq=128).generate(prompts, sp)]
    store = tempfile.mktemp(prefix="lmc-nccl-")
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(MeshConfig(1, 1), "cuda")
        got = [r.output_tokens for r in ServingEngine(
            cfg, shard_params(params, mesh), max_batch=2, max_seq=128,
            mesh=mesh).generate(prompts, sp)]
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    assert got == want
