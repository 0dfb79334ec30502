"""The prefill ablation variants (``ops/prefill_variants.py`` of the port)
held against the JAX tool's own Pallas kernels,
``tools/bench_prefill_mfu.py``.

The tool's ``main()`` runs once with ``--small`` (interpret mode on the
CPU) while ``pallas_call`` records every callable it builds, keyed by the
kernel's keywords (``mode``/``pair`` of ``variant_kernel``, ``nkb``/``bq``/
``bk`` of ``pipelined_kernel``). Each recorded callable and the port's entry
point then take the same numpy-seeded bf16 inputs.

Tolerances: the Pallas kernels round P to bf16 per key block against a
running max and write bf16; the port's plain versions keep P in fp32. So
an output may land one bf16 ulp away (2**-7 of its value) plus the P
rounding, |port - jax| <= 4e-3 + 2**-7 |jax|, with the relative L2 error
within 5e-3 (the JAX tool itself reports max|err| 1.95e-3 between its
rebuilt body and production). ``mxu_only`` sums unnormalized bf16 products
into values of order 10, so it is held by relative L2 alone (5e-3): its
bf16-rounded scores tie-break alike unless the two fp32 score sums differ.
"""

import functools
import importlib.util
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lmcache_tpu_torch.ops import prefill_variants as pv  # noqa: E402
from lmcache_tpu_torch.tools import bench_prefill_mfu as tool  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL, REL_L2 = 4e-3, 2.0**-7, 5e-3
# the --small geometry of the JAX tool
B, HKV, G, D, S, BQ, BK = 1, 2, 2, 128, 512, 128, 128
H = HKV * G


@pytest.fixture(scope="module")
def recorded():
    """{kernel keywords: the callable pallas_call built for them}."""
    from jax.experimental import pallas as pl
    spec = importlib.util.spec_from_file_location(
        "jax_bench_prefill_mfu", os.path.join(ROOT, "tools",
                                              "bench_prefill_mfu.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    real = pl.pallas_call
    calls = {}

    def recorder(kernel, *args, **kwargs):
        f = real(kernel, *args, **kwargs)
        kw = getattr(kernel, "keywords", None)
        if kw:
            calls[tuple(sorted(kw.items()))] = f
            if kw.get("mode") == "full" and kw.get("pair"):
                # the tool times no mxu_only with pair: build it on the
                # pair grid the same way
                mxu = functools.partial(kernel.func, mode="mxu_only",
                                        pair=True)
                calls[(("mode", "mxu_only"), ("pair", True))] = real(
                    mxu, *args, **kwargs)
        return f

    argv = sys.argv
    pl.pallas_call, sys.argv = recorder, ["bench_prefill_mfu", "--small"]
    try:
        module.main()
    finally:
        pl.pallas_call, sys.argv = real, argv
    return calls


def _inputs(seed, q_off, kv_len):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, H, S, D), f(B, HKV, S, D), f(B, HKV, S, D),
            np.full(B, q_off, np.int32), np.full(B, kv_len, np.int32))


def _jax_out(fn, q, k, v, qo, kl):
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    out = jax.jit(fn)(jnp.asarray(qo), jnp.asarray(kl), bf(q), bf(k), bf(v))
    return np.asarray(out.astype(jnp.float32))


def _port_out(entry, q, k, v, qo, kl, **kw):
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    out = entry(t(q), t(k), t(v), torch.from_numpy(qo),
                torch.from_numpy(kl), bq=BQ, bk=BK, **kw)
    return out.float().numpy()


def _hold(got, want, elementwise=True):
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert np.isfinite(got).all()
    assert rel <= REL_L2, rel
    if elementwise:
        excess = np.abs(got - want) - RTOL * np.abs(want)
        assert excess.max() <= ATOL, excess.max()


# (name, mode, pair) of variant_kernel, the keywords it was built with
VARIANT_CASES = [
    ("full", "full", False), ("mxu_only", "mxu_only", False),
    ("no_mask", "no_mask", False), ("pair", "full", True),
    ("pair_no_mask", "no_mask", True), ("pair_mxu_only", "mxu_only", True),
]
# (q_offset, kv_len): the tool's own inputs, then a suffix over a cached
# prefix with keys past kv_len inside live blocks
SCENARIOS = [(0, S), (96, 400)]


@pytest.mark.parametrize("q_off,kv_len", SCENARIOS)
@pytest.mark.parametrize("name,mode,pair", VARIANT_CASES)
def test_variant_matches_the_jax_tool(recorded, name, mode, pair, q_off,
                                      kv_len):
    args = _inputs(3, q_off, kv_len)
    want = _jax_out(recorded[(("mode", mode), ("pair", pair))], *args)
    got = _port_out(pv.variant_attention, *args, mode=mode, pair=pair)
    _hold(got, want, elementwise=mode != "mxu_only")
    assert pv.variant_name(mode, pair) == name


@pytest.mark.parametrize("q_off,kv_len", SCENARIOS)
def test_pipelined_matches_the_jax_tool(recorded, q_off, kv_len):
    args = _inputs(5, q_off, kv_len)
    fn = recorded[(("bk", BK), ("bq", BQ), ("nkb", S // BK))]
    _hold(_port_out(pv.pipelined_attention, *args), _jax_out(fn, *args))


def test_full_pair_and_pipelined_are_row_1():
    """full, pair and pipelined compute row 1's causal function: the plain
    versions equal each other and stay within bf16 rounding of row 1's."""
    from lmcache_tpu_torch.ops import flash_attention
    q, k, v, qo, kl = (torch.from_numpy(a) for a in _inputs(7, 32, 480))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    outs = [pv.variant_attention(q, k, v, qo, kl, mode="full", pair=p,
                                 bq=BQ, bk=BK) for p in (False, True)]
    outs.append(pv.pipelined_attention(q, k, v, qo, kl, bq=BQ, bk=BK))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    ref = flash_attention(q.transpose(1, 2), k, v, qo, kl,
                          kv_head_major=True).transpose(1, 2)
    _hold(outs[0].float().numpy(), ref.float().numpy())


def test_unmasked_modes_depend_on_the_blocks():
    """no_mask and mxu_only read whole live blocks, so other blocks give
    another function; full does not."""
    q, k, v, qo, kl = (torch.from_numpy(a) for a in _inputs(9, 0, S))
    for mode, same in (("full", True), ("no_mask", False),
                       ("mxu_only", False)):
        a = pv.variant_reference(q, k, v, qo, kl, mode=mode, bq=128, bk=128)
        b = pv.variant_reference(q, k, v, qo, kl, mode=mode, bq=128, bk=256)
        assert torch.allclose(a, b, atol=1e-5) == same, mode


def test_pair_with_an_odd_block_count_raises():
    q, k, v, qo, kl = (torch.from_numpy(a) for a in _inputs(1, 0, S))
    with pytest.raises(ValueError, match="odd number of key blocks"):
        pv.variant_attention(q, k, v, qo, kl, mode="full", pair=True,
                             bq=128, bk=192)
    # 512 keys in blocks of 256: two blocks, even
    pv.variant_attention(q, k, v, qo, kl, mode="full", pair=True, bq=128,
                         bk=256)
    with pytest.raises(ValueError, match="odd number of key blocks"):
        pv.variant_attention(q[:, :, :384], k[:, :, :384], v[:, :, :384], qo,
                             kl, mode="full", pair=True, bq=128, bk=128)


@pytest.mark.parametrize("kw,match", [
    (dict(bq=96, bk=128), "bq must be a positive multiple of 64"),
    (dict(bq=128, bk=100), "bk must be a positive multiple of 64"),
    (dict(bq=0, bk=128), "bq must be a positive multiple of 64"),
    (dict(bq=128, bk=128, mode="softmax_only"), "unknown mode"),
    (dict(bq=192, bk=128), "not a multiple of bq"),
    (dict(bq=128, bk=384, mode="no_mask"), "multiple of bk"),
])
def test_blocks_the_kernel_does_not_take_raise(kw, match):
    q, k, v, qo, kl = (torch.from_numpy(a) for a in _inputs(1, 0, S))
    with pytest.raises(ValueError, match=match):
        pv.variant_attention(q, k, v, qo, kl, **kw)


def test_cpu_path_counts_no_kernel_launch():
    pv.variant_attention.launches.clear()
    pv.pipelined_attention.launches.clear()
    q, k, v, qo, kl = (torch.from_numpy(a) for a in _inputs(1, 0, S))
    pv.variant_attention(q, k, v, qo, kl, bq=BQ, bk=BK)
    pv.pipelined_attention(q, k, v, qo, kl, bq=BQ, bk=BK)
    assert not pv.variant_attention.launches
    assert not pv.pipelined_attention.launches


def test_port_tool_runs_small_on_the_cpu(capsys):
    tool.main(["--small", "--device", "cpu"])
    out = capsys.readouterr().out
    for name, *_ in tool.VARIANTS:
        assert f"{name:22s}: time not measured (CPU)" in out
    assert "197" not in out
    report = tool.run(small=True, device="cpu")
    for row in report["variants"]:
        assert row["max_abs_err_plain"] == 0.0
        if row["name"] in tool.ROW1_FUNCTION:
            assert row["max_abs_err_row1"] <= 2e-2


def test_tool_counts_the_work_of_the_live_blocks():
    """At the JAX tool's full geometry: the causal work is S(S+1)/2 pairs a
    head, the unmasked modes take 144 live (256-query, 1024-key) block
    pairs a KV head."""
    geo = tool.geometry(False)
    causal, nbytes = tool.work(tool.VARIANTS[0], geo, [0], [8192], 256,
                               1024)
    assert causal == 4.0 * 128 * 32 * 8192 * 8193 / 2
    assert nbytes == 2.0 * (2 * 32 * 8192 * 128 + 2 * 8 * 8192 * 128)
    unmasked, _ = tool.work(tool.VARIANTS[2], geo, [0], [8192], 256, 1024)
    assert unmasked == 144 * 256 * 1024 * 4 * 128 * 4 * 8
    ms, by = tool.bound_ms(causal, nbytes)
    assert by == "operations" and abs(ms - 0.556) < 1e-3
