"""The decode options of the port's four engines against the JAX package's,
on the CPU in fp32: ``spec_lookahead`` (prompt-lookup speculation verified
in one ``K + 1``-token forward), ``decode_block`` (several decode steps with
the sampling on the device) and ``SamplingParams.logprobs``.

The same weights (the JAX ``init_params`` carried across) and prompts go
through the JAX engine of each kind once, with ``logprobs=3`` (which keeps
the JAX engine on its one-token step): its greedy tokens are the golden
tokens, and its ``_token_logprobs`` records the golden logprobs. The port's
engines must give those tokens exactly with ``spec_lookahead=4`` and with
``decode_block=4``, and the logprobs within ``LP_ATOL`` (fp32 log-softmax
over the same logits; the top ids equal, apart from two alternatives whose
logprobs lie within ``LP_ATOL`` of each other, which may come in either
order). The seeded-stream contracts are the port's own: a sampled request
draws the same tokens from its generator in a block or beside a
speculating request as in single steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from lmcache_tpu import serving as jserving  # noqa: E402
from lmcache_tpu.models import llama as jl  # noqa: E402
from lmcache_tpu.models import mla as jm  # noqa: E402
from lmcache_tpu.serving import engine as jengine  # noqa: E402
from lmcache_tpu_torch import serving as tserving  # noqa: E402
from lmcache_tpu_torch.models import llama as tl  # noqa: E402
from lmcache_tpu_torch.models import mla as tm  # noqa: E402
from lmcache_tpu_torch.serving import engine as tengine  # noqa: E402


# every test of this file on one torch thread (an autouse fixture)
from torch_test_helpers import one_torch_thread  # noqa: E402,F401


MAX_SEQ = 128
NEW = 12
LOGPROBS = 3
LP_ATOL = 1e-4  # fp32 log-softmax of logits computed in two frameworks
PAGED = dict(num_pages=32, page_size=16)

# kind -> (model, JAX engine, port engine, engine options)
KINDS = {
    "dense-native": ("llama", jserving.ServingEngine,
                     tserving.ServingEngine, {}),
    "dense-int8": ("llama", jserving.ServingEngine, tserving.ServingEngine,
                   dict(kv_dtype="int8")),
    "paged-native": ("llama", jserving.PagedServingEngine,
                     tserving.PagedServingEngine, PAGED),
    "paged-int8": ("llama", jserving.PagedServingEngine,
                   tserving.PagedServingEngine, dict(PAGED, kv_dtype="int8")),
    "mla-dense": ("mla", jserving.MLAServingEngine,
                  tserving.MLAServingEngine, {}),
    "mla-paged": ("mla", jserving.MLAPagedServingEngine,
                  tserving.MLAPagedServingEngine, PAGED),
}


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(n_layers=2)
    jparams = jl.init_params(jax.random.PRNGKey(7), jcfg)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    mcfg = jm.MLAConfig.tiny(n_layers=3, n_routed_experts=4,
                             n_shared_experts=1, n_experts_per_tok=2,
                             moe_hidden_dim=64, first_k_dense_replace=1)
    mparams = jm.init_params(jax.random.PRNGKey(7), mcfg)
    tmcfg = tm.MLAConfig(**dataclasses.asdict(mcfg))
    tmparams = tm.params_from_jax(jax.tree.map(np.asarray, mparams), tmcfg,
                                  device="cpu")
    return {"llama": ((jcfg, jparams), (tcfg, tparams)),
            "mla": ((mcfg, mparams), (tmcfg, tmparams))}


def _prompts(vocab):
    """A repetitive prompt, on which the n-gram proposer fires, and a
    random one."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, 8, dtype=np.int32)
    return [np.tile(base, 3), rng.integers(0, vocab, 15, dtype=np.int32)]


def _port(models, kind, **kw):
    model, _, cls, opts = KINDS[kind]
    cfg, params = models[model][1]
    return cls(cfg, params, max_batch=2, max_seq=MAX_SEQ, device="cpu",
               **opts, **kw)


_golden = {}


def _jax_golden(models, kind):
    """(prompts, greedy tokens, logprob records) of the JAX engine of
    ``kind``, run once a module."""
    if kind not in _golden:
        model, jcls, _, opts = KINDS[kind]
        cfg, params = models[model][0]
        prompts = _prompts(cfg.vocab_size)
        eng = jcls(cfg, params, max_batch=2, max_seq=MAX_SEQ,
                   use_pallas=False, **opts)
        reqs = eng.generate(prompts, jserving.SamplingParams(
            max_new_tokens=NEW, logprobs=LOGPROBS))
        _golden[kind] = (prompts, [r.output_tokens for r in reqs],
                         [r.logprobs for r in reqs])
    return _golden[kind]


def test_ngram_propose_matches_jax():
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, 6, n, dtype=np.int32) for n in range(0, 40)]
    seqs += [np.tile(rng.integers(0, 50, m, dtype=np.int32), 4)[:n]
             for m in (2, 3, 5) for n in (5, 9, 17)]
    seqs += [np.asarray([5, 6, 7, 9, 1, 5, 6, 7], np.int32),
             np.asarray([1, 2, 8, 1, 2, 9, 1, 2], np.int32)]
    for t in seqs:
        for ngram in (1, 2, 3):
            for k in (1, 4):
                np.testing.assert_array_equal(
                    tengine._ngram_propose(t, ngram, k),
                    jengine._ngram_propose(t, ngram, k))


@pytest.mark.parametrize("kind", list(KINDS))
def test_spec_greedy_tokens_match_jax(models, kind):
    """Speculation never changes greedy output: the port's verification of
    up to four proposals gives the JAX engine's tokens. One-token n-grams,
    so that the random model's repetitive output proposes."""
    prompts, golden, _ = _jax_golden(models, kind)
    eng = _port(models, kind, spec_lookahead=4, spec_ngram=1)
    reqs = eng.generate(prompts, tserving.SamplingParams(max_new_tokens=NEW))
    assert [r.output_tokens for r in reqs] == golden
    assert sum(r.spec_proposed for r in reqs) > 0
    for r in reqs:
        assert 0 <= r.spec_accepted <= r.spec_proposed


@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_block_greedy_tokens_match_jax(models, kind):
    """decode_block=4 gives the JAX engine's tokens (12 new tokens: a
    block ends past the last one), and a stop token mid-block ends the
    request there."""
    prompts, golden, _ = _jax_golden(models, kind)
    eng = _port(models, kind, decode_block=4)
    reqs = eng.generate(prompts, tserving.SamplingParams(max_new_tokens=NEW))
    assert [r.output_tokens for r in reqs] == golden
    stop = golden[0][6]
    first = golden[0].index(stop)
    [r] = eng.generate([prompts[0]], tserving.SamplingParams(
        max_new_tokens=NEW, stop_token_ids=(stop,)))
    assert r.output_tokens == golden[0][:first + 1]


@pytest.mark.parametrize("kind", list(KINDS))
def test_logprobs_match_jax(models, kind):
    prompts, golden, golden_lp = _jax_golden(models, kind)
    eng = _port(models, kind)
    reqs = eng.generate(prompts, tserving.SamplingParams(
        max_new_tokens=NEW, logprobs=LOGPROBS))
    assert [r.output_tokens for r in reqs] == golden
    for r, want_lp in zip(reqs, golden_lp):
        assert len(r.logprobs) == len(want_lp) == NEW
        for got, want in zip(r.logprobs, want_lp):
            assert got["token"] == want["token"]
            assert abs(got["logprob"] - want["logprob"]) <= LP_ATOL
            g_ids, g_lp = zip(*got["top"])
            w_ids, w_lp = zip(*want["top"])
            np.testing.assert_allclose(g_lp, w_lp, rtol=0, atol=LP_ATOL)
            for i, (a, b) in enumerate(zip(g_ids, w_ids)):
                if a != b:  # a near-tie taken in the other order
                    assert b in g_ids and a in w_ids
                    assert abs(g_lp[i] - w_lp[list(w_ids).index(a)]) \
                        <= LP_ATOL
            assert list(g_lp) == sorted(g_lp, reverse=True)


def test_spec_oracle_accepts_every_proposal(models, monkeypatch):
    """With an oracle proposer (the known greedy continuation) every
    proposal is accepted: 16 tokens in at most 5 verification forwards (1
    at admission, 15 in steps of up to 4), as the JAX engine's test."""
    cfg, params = models["llama"][1]
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 20,
                                               dtype=np.int32)
    N = 16
    golden = tserving.ServingEngine(
        cfg, params, max_batch=1, max_seq=256, device="cpu").generate(
            [prompt], tserving.SamplingParams(max_new_tokens=N))[0]
    gold = np.asarray(golden.output_tokens, np.int32)

    def oracle(tokens, ngram, k):
        m = len(tokens) - len(prompt)
        return gold[m:m + k]

    monkeypatch.setattr(tengine, "_ngram_propose", oracle)
    eng = tserving.ServingEngine(cfg, params, max_batch=1, max_seq=256,
                                 device="cpu", spec_lookahead=3)
    calls = []
    forward = eng._spec_forward
    eng._spec_forward = lambda inp, start: calls.append(1) or forward(
        inp, start)
    [r] = eng.generate([prompt], tserving.SamplingParams(max_new_tokens=N))
    assert r.output_tokens == golden.output_tokens
    assert r.spec_accepted == r.spec_proposed > 0
    assert len(calls) <= 5, len(calls)


@pytest.mark.parametrize("kind", ["dense-native", "paged-int8"])
def test_sampled_streams_match_single_step(models, kind):
    """A seeded sampled request draws the same tokens in blocks of 4 and
    beside a speculating greedy request as in single steps."""
    cfg = models[KINDS[kind][0]][1][0]
    rng = np.random.default_rng(6)
    p_greedy = np.tile(rng.integers(0, cfg.vocab_size, 8, dtype=np.int32),
                       3)
    p_sampled = rng.integers(0, cfg.vocab_size, 15, dtype=np.int32)
    sp = tserving.SamplingParams(max_new_tokens=10, temperature=1.2,
                                 top_k=40, seed=99)
    [ref] = _port(models, kind).generate([p_sampled], sp)
    [blocked] = _port(models, kind, decode_block=4).generate([p_sampled], sp)
    assert blocked.output_tokens == ref.output_tokens

    eng = _port(models, kind, spec_lookahead=4, spec_ngram=1)
    a = tserving.Request(p_greedy, tserving.SamplingParams(max_new_tokens=20))
    b = tserving.Request(p_sampled, sp)
    eng.add_request(a)
    eng.add_request(b)
    eng.run()
    assert b.output_tokens == ref.output_tokens
    assert b.spec_proposed == 0 and a.spec_proposed > 0


def test_spec_and_decode_block_are_exclusive(models):
    (jcfg, jparams), (tcfg, tparams) = models["llama"]
    for eng in (lambda **kw: jserving.ServingEngine(jcfg, jparams, **kw),
                lambda **kw: tserving.ServingEngine(tcfg, tparams,
                                                    device="cpu", **kw),
                lambda **kw: tserving.PagedServingEngine(
                    tcfg, tparams, device="cpu", **PAGED, **kw)):
        with pytest.raises(ValueError, match="mutually exclusive"):
            eng(max_seq=64, spec_lookahead=2, decode_block=4)


def _serve_keeping_kv(eng, prompts):
    """Serve ``prompts`` greedily; returns each request's KV (wire blob of
    its total_len - 1 written tokens) read just before its release."""
    kept, store_back = {}, eng._store_back

    def keep(req):
        kept[req.request_id] = eng._read_slot(req.slot,
                                              req.total_len - 1).clone()
        store_back(req)

    eng._store_back = keep
    reqs = eng.generate(prompts, tserving.SamplingParams(max_new_tokens=NEW))
    return [kept[r.request_id] for r in reqs]


@pytest.mark.parametrize("kind", ["dense-native", "dense-int8",
                                  "paged-native", "paged-int8"])
def test_kept_tokens_kv_matches_sequential(models, kind):
    """What a block and a verification leave for the tokens they keep is
    the KV of sequential decode: bit for bit after decode_block (the same
    one-token steps), within fp32 rounding after spec_lookahead (its
    projections run over K + 1 rows a request); the rejected proposals'
    writes, past each request's last token, change none of it (an int8
    arena's scales included)."""
    prompts = _prompts(models[KINDS[kind][0]][1][0].vocab_size)
    want = _serve_keeping_kv(_port(models, kind), prompts)
    blocked = _serve_keeping_kv(_port(models, kind, decode_block=4), prompts)
    spec = _serve_keeping_kv(
        _port(models, kind, spec_lookahead=4, spec_ngram=1), prompts)
    for w, b, s in zip(want, blocked, spec):
        assert torch.equal(b, w)
        torch.testing.assert_close(s, w, atol=1e-5, rtol=0)
