"""The quality checkpoints' training step on the card against the CPU.

``lmcache_tpu_torch/tools/train_quality_model.py``'s ``Trainer`` takes one
step from the committed checkpoint on the card (fp32, TF32 off) and on the
CPU, on the same ``make_train_batch(default_rng(0), 4, 256, 32)``; the loss,
each gradient leaf and the updated parameters must agree. These tests carry
the ``cuda`` marker and skip without a GPU. On a machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda_train.py -q -m cuda

Tolerances (``chip_smoke.py`` phase 21a's; the checkpoints' loss is
0.001-0.003): the loss within 1e-6 (the log of a probability near 1), the
accuracy equal, each gradient leaf within a relative L2 of 2e-3 (sums of
near-cancelling terms; the CPU's fp32 lies 5e-5 from its fp64), the
parameter updates within a relative L2 of 1e-2 (AdamW's first update
flips with the sign of gradient elements smaller than their rounding: 7e-4
between the CPU's fp32 and fp64).
"""

import numpy as np
import pytest
import torch

from lmcache_tpu_torch.tools import quality_common as qc
from lmcache_tpu_torch.tools import train_quality_model as tq

pytestmark = pytest.mark.cuda

LR = 5e-4
LOSS_ATOL = 1e-6
GRAD_REL_L2 = 2e-3
UPDATE_REL_L2 = 1e-2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _step(cfg, path, device, remat):
    tokens = qc.make_train_batch(np.random.default_rng(0), 4, 256, 32)
    mask = qc.target_mask(256, 32)
    trainer = tq.Trainer(cfg, qc.load_params(cfg, path, device=device),
                         lambda count: LR, remat=remat)
    before = [p.detach().to("cpu", copy=True) for _, p in trainer.named]
    loss, acc = trainer.gradients(tokens, mask)
    grads = [p.grad.detach().to("cpu", copy=True) for _, p in trainer.named]
    trainer.update()
    update = torch.cat([(p.detach().cpu() - b).flatten()
                        for (_, p), b in zip(trainer.named, before)])
    return loss, acc, grads, update


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("family", ["llama", "mla"])
def test_train_step_on_the_card_matches_the_cpu(card, family, remat):
    cfg, path = ((qc.quality_config(), qc.CKPT_PATH) if family == "llama"
                 else (qc.quality_mla_config(), qc.MLA_CKPT_PATH))
    loss, acc, grads, update = _step(cfg, path, card, remat)
    loss_c, acc_c, grads_c, update_c = _step(cfg, path, "cpu", remat)
    assert abs(loss - loss_c) <= LOSS_ATOL
    assert acc == acc_c
    for got, want in zip(grads, grads_c):
        assert (got - want).norm() <= GRAD_REL_L2 * want.norm()
    assert (update - update_c).norm() <= UPDATE_REL_L2 * update_c.norm()
