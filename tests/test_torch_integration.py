"""The port's engine hook API (``lmcache_tpu_torch.integration``) on the CPU:
``tests/test_integration.py``'s three cases over the port's cache engine
(``local_device="cpu"``), the same hooks run beside the JAX package's
(``lmcache_tpu.integration``) on the same tokens and blobs in both blob
formats, the config read from ``$LMCACHE_CONFIG_FILE``, and a forward's
stored blob retrieved bit for bit through both retrieve hooks, whose
partial prefill then gives the full prefill's logits."""

import numpy as np
import pytest
import torch

from lmcache_tpu_torch import LMCacheEngineConfig
from lmcache_tpu_torch import integration as itg
from lmcache_tpu_torch.models import llama

jax = pytest.importorskip("jax")

from lmcache_tpu import integration as jitg  # noqa: E402
from lmcache_tpu.config import LMCacheEngineConfig as JaxConfig  # noqa: E402


@pytest.fixture(autouse=True)
def clean_engine():
    itg.close_lmcache_engine()
    jitg.close_lmcache_engine()
    yield
    itg.close_lmcache_engine()
    jitg.close_lmcache_engine()


def _blob(T, L=2, H=2, D=64, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (L, 2, T, H, D)).astype(np.float32))


def test_lifecycle_and_hooks():
    cfg = LMCacheEngineConfig.from_defaults(local_device="cpu",
                                            chunk_size=16)
    eng = itg.init_lmcache_engine("m", config=cfg)
    assert eng is not None
    assert itg.init_lmcache_engine("m", config=cfg) is None  # already up

    tokens = np.arange(48, dtype=np.int32)
    prefill = itg.StepInput(tokens=tokens, is_prefill=True)
    decode = itg.StepInput(tokens=tokens, is_prefill=False)
    profile = itg.StepInput(tokens=tokens, is_prefill=True,
                            is_profile_run=True)

    assert itg.lmcache_should_retrieve(prefill)
    assert not itg.lmcache_should_retrieve(decode)
    assert not itg.lmcache_should_retrieve(profile)
    assert itg.lmcache_should_store(prefill)
    assert not itg.lmcache_should_store(decode)  # save_decode_cache off

    # store, then a second identical prompt prefill retrieves the prefix
    blob = _blob(48)
    itg.lmcache_store_kv(prefill, blob)
    eng.engine_.flush()

    step2 = itg.lmcache_retrieve_kv(prefill)
    assert step2.num_computed_tokens == 47  # >=1 token recomputed
    assert torch.equal(step2.retrieved_kv, blob[:, :, :47])
    suffix = itg.build_partial_prefill_input(step2)
    np.testing.assert_array_equal(suffix, tokens[47:])
    assert not itg.lmcache_should_retrieve(step2)


def test_save_decode_cache_gates_store():
    cfg = LMCacheEngineConfig.from_defaults(local_device="cpu",
                                            save_decode_cache=True)
    itg.init_lmcache_engine("m", config=cfg)
    decode = itg.StepInput(tokens=np.arange(8, dtype=np.int32),
                           is_prefill=False)
    assert itg.lmcache_should_store(decode)


def test_retrieve_kv_stream_pieces_and_early_close():
    cfg = LMCacheEngineConfig.from_defaults(local_device="cpu",
                                            chunk_size=16)
    eng = itg.init_lmcache_engine("m", config=cfg)
    tokens = np.arange(48, dtype=np.int32)
    prefill = itg.StepInput(tokens=tokens, is_prefill=True)
    blob = _blob(48)
    itg.lmcache_store_kv(prefill, blob)
    eng.engine_.flush()

    # pieces are contiguous, cover exactly num_computed_tokens of the
    # non-streaming hook, and the last piece is cut to leave >= 1 token
    pieces = list(itg.lmcache_retrieve_kv_stream(prefill))
    starts = [s for s, _ in pieces]
    lens = [c.shape[2] for _, c in pieces]
    assert starts == [0, 16, 32]
    assert lens == [16, 16, 15]
    rebuilt = torch.cat([c for _, c in pieces], dim=2)
    assert torch.equal(rebuilt, blob[:, :, :47])

    # closing early cancels cleanly (no error, no further pieces), and the
    # engine serves the next retrieval
    gen = itg.lmcache_retrieve_kv_stream(prefill)
    assert next(gen)[0] == 0
    gen.close()
    assert itg.lmcache_retrieve_kv(prefill).num_computed_tokens == 47


def _run_hooks(hooks, config, to_blob, fmt, stored, blob, query):
    """Store ``blob`` for the tokens ``stored`` through one package's hooks,
    then retrieve for ``query`` through both retrieve hooks: (the step's
    computed tokens, its suffix, its blob, the stream's (start, piece)
    list, the first start of a stream closed after one piece, the computed
    tokens of a retrieval after it), blobs as numpy arrays."""
    eng = hooks.init_lmcache_engine("m", fmt=fmt, config=config.from_defaults(
        local_device="cpu", chunk_size=16))
    hooks.lmcache_store_kv(hooks.StepInput(tokens=stored, is_prefill=True),
                           to_blob(blob))
    eng.engine_.flush()
    step = hooks.StepInput(tokens=query, is_prefill=True)
    got = hooks.lmcache_retrieve_kv(step)
    pieces = [(s, np.asarray(c)) for s, c in
              hooks.lmcache_retrieve_kv_stream(step)]
    gen = hooks.lmcache_retrieve_kv_stream(step)
    first = next(gen)[0]
    gen.close()
    again = hooks.lmcache_retrieve_kv(step).num_computed_tokens
    hooks.close_lmcache_engine()
    return (got.num_computed_tokens, hooks.build_partial_prefill_input(got),
            np.asarray(got.retrieved_kv), pieces, first, again)


@pytest.mark.parametrize("fmt", ["vllm", "huggingface"])
@pytest.mark.parametrize("stored,query", [(48, 48), (48, 60), (32, 48)],
                         ids=["whole-prompt", "prompt-plus-suffix",
                              "prefix-of-prompt"])
def test_hooks_match_the_jax_package(fmt, stored, query):
    """Both packages' hooks on the same tokens and blob: the computed
    tokens, the suffix left to prefill, the streamed pieces (starts,
    lengths along the format's token axis, bits) and the early close agree.
    The retrieved blob is the stored one's first ``num_computed_tokens``
    along the token axis in both packages, where the JAX non-streaming hook
    cuts axis 2 whatever the format: in the ``huggingface`` format
    (``[L, 2, H, T, D]``) it cuts the heads, so there the JAX hook hands
    back every head and every stored token, and the port is held to the
    JAX stream's pieces instead."""
    axis = {"vllm": 2, "huggingface": 3}[fmt]
    tokens = np.arange(query, dtype=np.int32)
    blob = _blob(stored).numpy()
    if fmt == "huggingface":
        blob = np.ascontiguousarray(blob.transpose(0, 1, 3, 2, 4))
    j = _run_hooks(jitg, JaxConfig, lambda b: b, fmt, tokens[:stored],
                   blob, tokens)
    t = _run_hooks(itg, LMCacheEngineConfig, torch.from_numpy, fmt,
                   tokens[:stored], blob, tokens)
    hit = min(stored, query - 1)
    assert t[0] == j[0] == hit
    np.testing.assert_array_equal(t[1], j[1])
    assert [s for s, _ in t[3]] == [s for s, _ in j[3]]
    assert ([c.shape[axis] for _, c in t[3]]
            == [c.shape[axis] for _, c in j[3]])
    for (_, a), (_, b) in zip(t[3], j[3]):
        np.testing.assert_array_equal(a, b)
    assert t[4] == j[4] == 0 and t[5] == j[5] == hit
    want = np.take(blob, np.arange(hit), axis=axis)
    np.testing.assert_array_equal(t[2], want)
    np.testing.assert_array_equal(
        t[2], np.concatenate([c for _, c in j[3]], axis=axis))
    if fmt == "vllm":
        np.testing.assert_array_equal(t[2], j[2])
    else:
        np.testing.assert_array_equal(j[2], blob[:, :, :hit])


def test_config_from_environment(tmp_path, monkeypatch):
    path = tmp_path / "lmcache.yaml"
    path.write_text("chunk_size: 32\nlocal_device: cpu\n"
                    "save_decode_cache: true\n")
    monkeypatch.setenv("LMCACHE_CONFIG_FILE", str(path))
    eng = itg.init_lmcache_engine("m")
    assert eng.config.chunk_size == 32
    assert eng.config.local_device == "cpu" and eng.save_decode_cache


def test_outside_loop_reuses_a_forward_prefix():
    """An outside loop: prefill a prompt into a pool, store its blob,
    then for the prompt plus a suffix retrieve the prefix through both
    hooks (bit for bit the stored blob, and each other), inject it and
    prefill only the rest: the logits are the full prefill's."""
    cfg = llama.LlamaConfig.tiny(n_layers=2)
    params = llama.init_params(cfg, device="cpu")
    itg.init_lmcache_engine("tiny", dtype=cfg.dtype,
                            config=LMCacheEngineConfig(local_device="cpu",
                                                       chunk_size=16))
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 64, dtype=np.int32)
    tokens = np.concatenate([prompt, rng.integers(0, cfg.vocab_size, 24,
                                                  dtype=np.int32)])
    zero = torch.zeros(1, dtype=torch.int32)

    def pool():
        return llama.new_kv_cache(cfg, 1, len(tokens), device="cpu")

    cache = pool()
    llama.forward(params, cfg, torch.as_tensor(prompt).long()[None], zero,
                  cache)
    blob = llama.cache_to_blob(cache, 0, len(prompt))
    itg.lmcache_store_kv(itg.StepInput(tokens=prompt, is_prefill=True), blob)
    itg._engine().engine_.flush()

    step = itg.StepInput(tokens=tokens, is_prefill=True)
    assert itg.lmcache_should_retrieve(step)
    step = itg.lmcache_retrieve_kv(step)
    assert step.num_computed_tokens == len(prompt)
    assert torch.equal(step.retrieved_kv, blob)
    pieces = list(itg.lmcache_retrieve_kv_stream(
        itg.StepInput(tokens=tokens, is_prefill=True)))
    assert torch.equal(torch.cat([c for _, c in pieces], dim=2), blob)

    reuse = llama.blob_into_cache(pool(), step.retrieved_kv)
    rest = itg.build_partial_prefill_input(step)
    logits, _ = llama.forward(
        params, cfg, torch.as_tensor(rest).long()[None],
        torch.full((1,), step.num_computed_tokens, dtype=torch.int32), reuse)
    full, _ = llama.forward(params, cfg, torch.as_tensor(tokens).long()[None],
                            zero, pool())
    torch.testing.assert_close(logits[0], full[0, len(prompt):], atol=1e-4,
                               rtol=1e-4)
