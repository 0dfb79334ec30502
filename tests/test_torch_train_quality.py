"""The port's trainer of the quality checkpoints
(``lmcache_tpu_torch/tools/train_quality_model.py``) against the JAX tool
(``tools/train_quality_model.py``), on the CPU.

The JAX step is rebuilt here from the tool's parts, as its ``main`` builds
it: ``forward(..., use_pallas=False, remat=True)``, the masked loss, and
``optax.chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule
(...), weight_decay=0.01))``. Both packages start from the same weights
(the JAX ``init_params`` carried across by ``params_from_jax``) and train on
the same batches (``make_train_batch`` from one numpy seed), all in fp32.

Tolerances (fp32 on the CPU, two frameworks' orders of summation):
- the loss each step: relative 1e-5, the accuracy equal;
- each gradient leaf before the first update: relative L2 1e-5;
- the parameters after 3 steps: max abs 1e-2 x the peak learning rate
  (AdamW's first updates are about lr x sign(g), so a gradient element
  near eps = 1e-8 can move by a fraction of lr between the two).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lmcache_tpu.models import llama as jllama
from lmcache_tpu.models import mla as jmla
from lmcache_tpu_torch.models import llama, mla
from lmcache_tpu_torch.tools import quality_common as qc
from lmcache_tpu_torch.tools import train_quality_model as tq
from tools import quality_common as jqc
from tools import train_quality_model as jtq

STEPS = 3
LR = 2e-3
T, R, B = 64, 8, 4  # the batches' shape: tokens up to qc.VOCAB
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-5
PARAM_ATOL = 1e-2 * LR

# narrow two-layer models; the vocabulary is the corpus's
LLAMA_KW = dict(vocab_size=qc.VOCAB, dim=64, n_layers=2, n_heads=4,
                n_kv_heads=2, hidden_dim=128, max_seq_len=128,
                dtype="float32")
MLA_KW = dict(vocab_size=qc.VOCAB, dim=64, n_layers=2, n_heads=2,
              hidden_dim=128, max_seq_len=128, q_lora_rank=None,
              kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
              v_head_dim=16, dtype="float32")


# every test of this file on one torch thread (an autouse fixture)
from torch_test_helpers import one_torch_thread  # noqa: E402,F401


def _configs(family):
    if family == "llama":
        return jllama, jllama.LlamaConfig(**LLAMA_KW), llama.LlamaConfig(
            **LLAMA_KW)
    return jmla, jmla.MLAConfig(**MLA_KW), mla.MLAConfig(**MLA_KW)


def _jax_loss(jmodel, jcfg, family):
    """The JAX tool's ``loss_fn``."""
    def loss_fn(p, tokens, mask):
        b, t = tokens.shape
        cache = (jllama.new_kv_cache(jcfg, b, t) if family == "llama"
                 else jmla.new_latent_cache(jcfg, b, t))
        logits, _ = jmodel.forward(p, jcfg, tokens, jnp.zeros(b, jnp.int32),
                                   cache, use_pallas=False, remat=True)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32))
        tgt = tokens[:, 1:]
        nll = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
        acc = (logits[:, :-1].argmax(-1) == tgt)
        m = mask[None, :]
        denom = m.sum() * b
        return (nll * m).sum() / denom, (acc * m).sum() / denom
    return loss_fn


def _batches():
    rng = np.random.default_rng(0)
    return [(qc.make_train_batch(rng, B, T, R), qc.target_mask(T, R))
            for _ in range(STEPS)]


_TRAJECTORIES = {}


def _jax_trajectory(family):
    """(initial params as numpy, [(loss, acc)] a step, the first step's
    gradients, the params after STEPS steps) of the JAX tool's step; one
    compile a family per process."""
    if family in _TRAJECTORIES:
        return _TRAJECTORIES[family]
    jmodel, jcfg, _ = _configs(family)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    start = jax.tree.map(np.asarray, params)
    warmup = min(200, max(1, STEPS // 10))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, LR, warmup_steps=warmup, decay_steps=STEPS,
        end_value=LR * 0.15)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=0.01))
    opt_state = tx.init(params)
    loss_fn = _jax_loss(jmodel, jcfg, family)

    @jax.jit
    def train_step(p, o, tokens, mask):
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, tokens, mask)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, acc, grads

    losses, first_grads = [], None
    for tokens, mask in _batches():
        params, opt_state, loss, acc, grads = train_step(
            params, opt_state, jnp.asarray(tokens), jnp.asarray(mask))
        losses.append((float(loss), float(acc)))
        if first_grads is None:
            first_grads = qc.flatten(jax.tree.map(np.asarray, grads))
    out = (start, losses, first_grads,
           qc.flatten(jax.tree.map(np.asarray, params)))
    _TRAJECTORIES[family] = out
    return out


def _port_params(family, tree):
    _, _, cfg = _configs(family)
    module = llama if family == "llama" else mla
    return cfg, module.params_from_jax(tree, cfg, device="cpu")


def test_corpus_and_curriculum_are_the_jax_tools():
    for seed, (b, t, r) in enumerate(((4, 256, 32), (2, 100, 7),
                                      (3, 8256, 2048))):
        got = qc.make_train_batch(np.random.default_rng(seed), b, t, r)
        want = jqc.make_train_batch(np.random.default_rng(seed), b, t, r)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(qc.target_mask(t, r), jqc.target_mask(t, r))
    for name in ("CURRICULUM", "CURRICULUM_FINETUNE",
                 "CURRICULUM_FINETUNE_MLA", "CURRICULUM_MLA"):
        cur = getattr(tq, name)
        assert cur == getattr(jtq, name)
        for total in (10, 1000, 5600):
            assert ([tq.shape_for_step(s, total, cur) for s in range(total)]
                    == [jtq.shape_for_step(s, total, cur)
                        for s in range(total)])
    for family in ("llama", "mla"):
        for base in (1, 32):
            for t in (256, 384, 512, 1024, 2048, 2560, 3072, 4096, 8256):
                assert (tq.batch_for(t, base, family)
                        == jtq.batch_for(t, base, family))
    assert tq.SELF_CHECK_BANDS == {"llama": tuple(
        [(256, 32), (512, 128), (1024, 512), (2112, 1056), (2560, 1280),
         (4096, 2048), (6144, 3072), (8256, 2048)]), "mla": tuple(
        [(256, 32), (512, 128), (1024, 512), (2112, 1056), (4096, 2048),
         (6144, 3072), (8256, 2048)])}


def test_schedule_and_clip_are_optaxs():
    for peak, steps in ((2e-3, 3), (2e-3, 5600), (5e-4, 1400), (1e-3, 25)):
        warmup = min(200, max(1, steps // 10))
        want = optax.warmup_cosine_decay_schedule(
            0.0, peak, warmup_steps=warmup, decay_steps=steps,
            end_value=peak * 0.15)
        got = tq.warmup_cosine_schedule(peak, steps)
        for count in sorted({0, 1, warmup - 1, warmup, warmup + 1,
                             steps // 2, steps - 1, steps, steps + 7}):
            # optax computes in fp32: its warmup's 1 - count / warmup
            # cancels, so the rule holds to 1e-6 of the peak
            assert got(count) == pytest.approx(float(want(count)), rel=0,
                                               abs=1e-6 * peak)
    clip = optax.clip_by_global_norm(1.0)
    rng = np.random.default_rng(3)
    for scale in (0.01, 0.3, 1.0, 7.0):  # below, at and above the norm
        grads = [rng.standard_normal(s).astype(np.float32) * scale
                 for s in ((5, 3), (7,), (2, 2, 2))]
        want, _ = clip.update(grads, clip.init(grads))
        mine = [torch.from_numpy(g.copy()) for g in grads]
        norm = tq.clip_by_global_norm_(mine, 1.0)
        assert float(norm) == pytest.approx(
            float(optax.global_norm(grads)), rel=1e-6)
        for m, w in zip(mine, want):
            np.testing.assert_allclose(m.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def test_save_params_loads_in_both_packages(tmp_path):
    cfg = llama.LlamaConfig(**LLAMA_KW)
    params = llama.init_params(
        cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    path = str(tmp_path / "ckpt" / "q.npz")
    qc.save_params(params, path)
    flat = {k: v.numpy().astype(np.float16)
            for k, v in qc.flatten(params).items()}
    port = qc.flatten(qc.load_tree(path))
    jax_tree = qc.flatten(jax.tree.map(
        np.asarray, jqc.load_params("float32", path)))
    assert set(port) == set(flat) == set(jax_tree)
    for name, want in flat.items():
        assert port[name].dtype == np.float16
        assert np.array_equal(port[name], want)
        assert np.array_equal(jax_tree[name], want.astype(np.float32))
    # and back onto the port's parameters, as eval_quality reads them
    again = qc.load_params(cfg, path, device="cpu")
    assert torch.equal(again["layers"]["wq"],
                       torch.from_numpy(flat["layers/wq"]).float())


@pytest.mark.parametrize("family", ["llama", "mla"])
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_three_steps_match_the_jax_trainer(family, remat):
    start, losses, first_grads, final = _jax_trajectory(family)
    cfg, params = _port_params(family, start)
    trainer = tq.Trainer(cfg, params, tq.warmup_cosine_schedule(LR, STEPS),
                         remat=remat)
    for i, (tokens, mask) in enumerate(_batches()):
        loss, acc = trainer.gradients(tokens, mask)
        assert loss == pytest.approx(losses[i][0], rel=LOSS_RTOL)
        assert acc == losses[i][1]
        if i == 0:
            assert set(first_grads) == {n for n, _ in trainer.named}
            for name, p in trainer.named:
                want = first_grads[name]
                err = np.linalg.norm(p.grad.numpy() - want)
                assert err <= GRAD_REL_L2 * np.linalg.norm(want), name
        trainer.update()
    for name, p in trainer.named:
        np.testing.assert_allclose(p.detach().numpy(), final[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("family", ["llama", "mla"])
def test_self_check_is_the_jax_tools_loss(family):
    """:func:`evaluate` at a short band against the JAX tool's ``loss_fn``
    over the same held-out sequence."""
    jmodel, jcfg, cfg = _configs(family)
    start = _jax_trajectory(family)[0]
    _, params = _port_params(family, start)
    [(t, r, loss, acc)] = tq.evaluate(cfg, params, [(96, 24)])
    rng = np.random.default_rng(tq.SELF_CHECK_SEED)
    tokens = jnp.asarray(jqc.make_sequence(rng, 96, 24))[None, :]
    want = jax.jit(_jax_loss(jmodel, jcfg, family))(
        jax.tree.map(jnp.asarray, start), tokens,
        jnp.asarray(jqc.target_mask(96, 24)))
    assert (t, r) == (96, 24)
    assert loss == pytest.approx(float(want[0]), rel=LOSS_RTOL)
    assert acc == float(want[1])


def test_serving_forward_keeps_its_bits_beside_training():
    """The serving forwards give the same bits before and after training
    code ran in the process, and training leaves their pool untouched by
    the step (the step writes no pool)."""
    cfg = llama.LlamaConfig(**LLAMA_KW)
    params = llama.init_params(
        cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    tokens = torch.as_tensor(qc.make_train_batch(
        np.random.default_rng(5), 2, 48, 12))

    def serve():
        cache = llama.new_kv_cache(cfg, 2, 48, device="cpu")
        logits, cache = llama.forward(params, cfg, tokens,
                                      torch.zeros(2, dtype=torch.int32),
                                      cache, use_kernel=False)
        return logits, cache

    before = serve()
    train = {k: ({n: w.clone() for n, w in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in params.items()}
    trainer = tq.Trainer(cfg, train, lambda count: LR)
    trainer.step(tokens.numpy(), qc.target_mask(48, 12))
    with torch.no_grad():
        logits = llama.forward_train(params, cfg, tokens, remat=True)
    after = serve()
    assert torch.equal(before[0], after[0]) and torch.equal(before[1],
                                                           after[1])
    # the training forward is the serving function: the same logits
    torch.testing.assert_close(logits, before[0], rtol=1e-5, atol=1e-5)
    assert not any(p.requires_grad for p in qc.flatten(params).values())


def test_main_trains_and_self_checks_on_the_cpu(tmp_path, monkeypatch,
                                                capsys):
    """``main --device cpu`` at batch 1 (rows of 2 at T 256): the
    curriculum cut to its first shape and the self-check to its shortest
    band."""
    monkeypatch.setattr(tq, "CURRICULUM_MLA", ((1.0, ((256, 8),)),))
    monkeypatch.setitem(tq.SELF_CHECK_BANDS, "mla", ((256, 32),))
    out = str(tmp_path / "mla.npz")
    assert tq.main(["--family", "mla", "--steps", "2", "--batch", "1",
                    "--out", out, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "step     0  T=  256 R=    8 B=  2" in text
    assert "step     1" in text and "eval T=  256 R=   32" in text
    tree = qc.load_tree(out)
    assert set(qc.flatten(tree)) == set(qc.flatten(qc.load_tree(
        qc.MLA_CKPT_PATH)))


def test_main_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.main(["--out", str(tmp_path / "q.npz")])
    assert not os.path.exists(tmp_path / "q.npz")
