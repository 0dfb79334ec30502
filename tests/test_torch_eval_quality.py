"""The port's codec quality gate (``lmcache_tpu_torch.tools.eval_quality``)
against the JAX tool (``tools/eval_quality.py``) on the in-repo trained
checkpoints, on the CPU in fp32 at ctx 2048, cont 64: the shortest context
at which both trained models pass (their retrieval distance is ctx/2).

Each JAX gate runs once per file; its exact context blob, its container and
that container's decode are recorded from the JAX serde as it runs. The port's gate codes with
the host C++ coder (``coder="off"``, the same containers) to keep the file
short; its container of the JAX blob is made with the range-coder kernels'
plain versions (``"auto"`` on the CPU).

Under ``jit`` XLA's CPU backend computes the rotary inverse frequencies
``theta ** (-i / rd)`` one fp32 ulp away from the function as written in
10 of the 32 at D 64 (eagerly they are the port's, bit for bit). At
positions up to 2047 that moves the dense model's keys by up to 4.2e-4, so
the port's exact blob is held to the JAX tool's with the jitted frequencies
put into the port's rope, which leaves the fp32 tolerance of
``tests/test_torch_llama.py`` to everything else."""

import os
import sys

import numpy as np
import pytest
import torch

from lmcache_tpu_torch.models import llama as tllama
from lmcache_tpu_torch.models import mla as tmla
from lmcache_tpu_torch.tools import eval_quality as teq
from lmcache_tpu_torch.tools import quality_common as tqc


# every test of this file on one torch thread (an autouse fixture)
from torch_test_helpers import one_torch_thread  # noqa: E402,F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTX, CONT = 2048, 64
ATOL = 1e-4  # fp32 forwards of both packages (tests/test_torch_llama.py)
# KL and perplexity delta: within GATE_RTOL of the JAX tool's, plus one
# step of the rounding both tools apply to them (5 and 4 decimals)
GATE_RTOL = 0.1
KL_STEP, PPL_STEP = 1e-5, 1e-4
CPU = torch.device("cpu")


def _jax_gate(run):
    """Run a JAX gate once, recording the blob its serializer was given, the
    container it made and the deserializer's decode of that container."""
    from lmcache_tpu.storage.serde import cachegen_serde
    seen, decoded = [], []
    to_bytes = cachegen_serde.CacheGenSerializer.to_bytes
    from_bytes = cachegen_serde.CacheGenDeserializer.from_bytes

    def recording(self, blob):
        bs = to_bytes(self, blob)
        seen.append((np.asarray(blob), bs))
        return bs

    def decoding(self, bs):
        out = from_bytes(self, bs)
        decoded.append(np.asarray(out))
        return out

    cachegen_serde.CacheGenSerializer.to_bytes = recording
    cachegen_serde.CacheGenDeserializer.from_bytes = decoding
    try:
        result = run()
    finally:
        cachegen_serde.CacheGenSerializer.to_bytes = to_bytes
        cachegen_serde.CacheGenDeserializer.from_bytes = from_bytes
    [(blob, bs)] = seen
    [out] = decoded
    return result, blob, bs, out


@pytest.fixture(scope="module")
def jax_tool():
    # the JAX tool imports its sibling module by name for the MLA gate
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from tools import eval_quality as jeq
        from tools import quality_common as jqc
        yield jeq, jqc
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))


@pytest.fixture(scope="module")
def dense(jax_tool):
    jeq, _ = jax_tool
    return _jax_gate(lambda: jeq.evaluate("trained", CTX, CONT, 0))


@pytest.fixture(scope="module")
def latent(jax_tool):
    jeq, _ = jax_tool
    return _jax_gate(lambda: jeq.evaluate_mla(CTX, CONT, 0, trained=True))


def test_the_tokens_are_the_jax_tools(jax_tool):
    _, jqc = jax_tool
    for seed in (0, 3, 12345):
        rng = (np.random.default_rng(seed), np.random.default_rng(seed))
        np.testing.assert_array_equal(
            tqc.make_eval_tokens(rng[0], CTX + CONT),
            jqc.make_eval_tokens(rng[1], CTX + CONT))
    cfg, _, tok = tqc.load_mla_checkpoint(CTX, CONT, 0, device="cpu")
    jcfg, _, jtok = jqc.load_mla_checkpoint(CTX, CONT, 0)
    np.testing.assert_array_equal(tok, jtok)
    for a, b in ((tqc.quality_config(), jqc.quality_config()),
                 (cfg, jcfg)):
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "hidden_dim",
                  "max_seq_len", "dtype"):
            assert getattr(a, f) == getattr(b, f), f
    assert cfg.latent_dim == jcfg.latent_dim == 160


def _jitted_inv_freq(monkeypatch):
    """Put into the port's rope the frequencies that the JAX forward gets
    under ``jit``, after checking they are at most one ulp from the port's
    own."""
    import jax

    from lmcache_tpu.models import llama as jllama
    own = tllama.rope_inv_freq

    def jitted(theta, rd, scaling=None, device=None):
        inv, mscale = jax.jit(
            lambda: jllama.rope_inv_freq(theta, rd, scaling))()
        inv = torch.from_numpy(np.array(inv))
        mine = own(theta, rd, scaling)[0]
        assert torch.equal(inv, mine) or (
            (inv - mine).abs() <= torch.finfo(torch.float32).eps * mine
        ).all()
        return inv.to(device), float(mscale)

    monkeypatch.setattr(tllama, "rope_inv_freq", jitted)


@pytest.mark.parametrize("family", ["dense", "mla"])
def test_gate_matches_the_jax_tool(family, request, monkeypatch):
    """The same tokens, the exact blob within the fp32 tolerance, the port's
    container of the JAX blob byte-equal to the JAX container and its decode
    bit-equal to the JAX deserializer's, and the gate's numbers: compression
    exactly, KL and the perplexity delta within GATE_RTOL (plus a rounding
    step), the same verdict (both pass)."""
    want, jblob, jbs, jdecoded = request.getfixturevalue(
        "dense" if family == "dense" else "latent")
    if family == "dense":
        got = teq.evaluate("trained", CTX, CONT, 0, device="cpu",
                           dtype="float32", coder="off")
        cfg = tqc.quality_config()
        params = tqc.load_params(cfg, device="cpu")
        tokens = tqc.make_eval_tokens(np.random.default_rng(0), CTX + CONT)
        mod, name, ratio = tllama, "lmcache-tpu/quality-8l", "compression_x"
    else:
        got = teq.evaluate_mla(CTX, CONT, 0, trained=True, device="cpu",
                               dtype="float32", coder="off")
        cfg, params, tokens = tqc.load_mla_checkpoint(CTX, CONT, 0,
                                                      device="cpu")
        mod, name, ratio = tmla, "trained-mla", "compression_vs_bf16_x"
    with monkeypatch.context() as m:
        _jitted_inv_freq(m)
        blob = teq.context_blob(mod, cfg, params, tokens, CTX, CPU)
    np.testing.assert_allclose(blob.numpy(), jblob, atol=ATOL, rtol=ATOL)
    bs, decoded = teq.codec_round_trip(torch.from_numpy(np.array(jblob)),
                                       name, CPU)
    assert bs == jbs
    assert torch.equal(decoded, torch.from_numpy(np.array(jdecoded)))
    assert got[ratio] == want[ratio]
    for key, step in (("logit_kl", KL_STEP), ("ppl_delta", PPL_STEP)):
        assert abs(got[key] - want[key]) <= GATE_RTOL * abs(want[key]) + step
    assert got["pass"] and want["pass"]
    assert set(got) == set(want)


def test_main_prints_the_jax_tools_lines(capsys):
    """The MLA gate's one line and its exit code, through ``main``."""
    rc = teq.main(["--model", "trained-mla", "--ctx", "256", "--cont", "16",
                   "--device", "cpu", "--dtype", "float32"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("model=trained-mla ctx=256 compression(bf16)=")
    assert line.endswith(f"pass={rc == 0}")
