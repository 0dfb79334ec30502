"""Train the quality checkpoints of :mod:`quality_common` on the card.

Port of ``tools/train_quality_model.py``. The models of
:mod:`lmcache_tpu_torch.tools.quality_common` learn the copy-with-offset
corpus until they predict the copied positions at about 100 % accuracy, so
that the codec gate of ``tools/eval_quality.py`` measures the damage that a
codec does to cached KV. The loss is the negative log-likelihood over the
positions the copy rule determines (``t + 1 >= R``); the base segment's
targets are noise. A staged short-to-long curriculum forms the retrieval
mechanism at short repeat distances first, then extends it; ``--init``
resumes from a checkpoint under the long-position finetune curriculum.

The step is the JAX tool's: the differentiable forwards
(``llama.forward_train``, ``mla.forward_train``: the plain attention over
the step's own K/V, each layer recomputed in the backward pass), the masked
loss, and the update of ``optax.chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, steps, 0.15 lr),
weight_decay=0.01))``: :func:`clip_by_global_norm_` and
:func:`warmup_cosine_schedule` write optax's rules out, and
``torch.optim.AdamW`` computes adamw's update. Everything is fp32 (TF32 off,
PyTorch's default for matmuls). PyTorch's generator is not JAX's, so a run
from ``--seed`` starts from other weights than the JAX tool's.

    python -m lmcache_tpu_torch.tools.train_quality_model --out q.npz
    python -m lmcache_tpu_torch.tools.train_quality_model --family mla \\
        --out q_mla.npz
    python -m lmcache_tpu_torch.tools.train_quality_model \\
        --init checkpoints/quality_8l.npz --out q_long.npz

It runs on the card unless ``--device cpu`` is given. ``--out`` is
required: the committed checkpoints are the codec gate's, and a retrained
model is a new file.
"""

import argparse
import math
import os
import sys
import time

import numpy as np
import torch

from lmcache_tpu_torch.models import llama, mla
from lmcache_tpu_torch.tools import quality_common as qc
from lmcache_tpu_torch.utils import resolve_device

# Staged (seq_len, repeat) curricula, copied from the JAX tool, which
# explains each stage: retrieval forms at short repeat distances and extends
# gradually; every later stage replays the short distances; the final stage
# replays every band.
CURRICULUM = (
    (0.16, ((256, 8), (256, 8), (256, 16), (256, 32), (256, 64),
            (256, 8))),
    (0.10, ((384, 96), (256, 32), (512, 128), (256, 8), (512, 192),
            (512, 256), (256, 64), (512, 128))),
    (0.12, ((1024, 512), (256, 32), (1536, 640), (1536, 768),
            (512, 128), (2048, 896))),
    (0.14, ((2048, 896), (2112, 1056), (256, 32), (2560, 1280),
            (1536, 768), (512, 128), (2112, 1056), (1024, 512))),
    (0.20, ((2560, 1280), (3072, 1536), (2112, 1056), (4096, 2048),
            (256, 32), (3584, 1792), (512, 128), (4096, 2048),
            (2112, 1056), (1024, 512))),
    (0.28, ((4096, 2048), (2112, 1056), (2560, 1280), (256, 32),
            (3072, 1536), (512, 128), (4096, 2048), (1024, 512),
            (2112, 1056), (1536, 768), (4096, 2048), (2560, 1280))),
)

# --init: extend a formed mechanism to long absolute positions; long shapes
# dominate, every shorter band stays replayed
CURRICULUM_FINETUNE = (
    (1.0, ((8256, 2048), (6144, 1536), (2112, 1056), (8256, 2048),
           (4096, 2048), (256, 32), (6144, 2048), (512, 128),
           (8256, 2048), (1024, 512), (2560, 1280), (8256, 2048),
           (5120, 2048), (1536, 768), (8256, 2048), (6144, 3072))),
)

CURRICULUM_FINETUNE_MLA = (
    (1.0, ((8256, 2048), (2112, 1056), (6144, 1536), (8256, 2048),
           (2560, 1280), (256, 32), (6144, 2048), (512, 128),
           (8256, 2048), (1024, 512), (2112, 1056), (8256, 2048),
           (5120, 2048), (4096, 2048), (8256, 2048), (6144, 3072))),
)

CURRICULUM_MLA = (
    (0.25, ((256, 8), (256, 8), (256, 16), (256, 32), (256, 64),
            (256, 8))),
    (0.18, ((384, 96), (256, 32), (512, 128), (256, 8), (512, 256),
            (512, 128))),
    (0.22, ((1024, 512), (256, 32), (1536, 640), (1536, 768),
            (512, 128), (2048, 896))),
    (0.35, ((2048, 896), (2112, 1056), (2560, 1280),
            (256, 32), (512, 128), (1024, 512), (2112, 1056))),
)

# the held-out self-check after training: every distance band, through the
# float16 round trip of the saved file
SELF_CHECK_BANDS = {
    "llama": ((256, 32), (512, 128), (1024, 512), (2112, 1056),
              (2560, 1280), (4096, 2048), (6144, 3072), (8256, 2048)),
    "mla": ((256, 32), (512, 128), (1024, 512), (2112, 1056),
            (4096, 2048), (6144, 3072), (8256, 2048)),
}
SELF_CHECK_SEED = 12345


def shape_for_step(step: int, total: int, curriculum):
    """(seq_len, repeat) of ``step`` under the staged curriculum."""
    start = 0
    for frac, shapes in curriculum:
        n = int(round(frac * total))
        if step < start + n or (frac, shapes) == curriculum[-1]:
            return shapes[(step - start) % len(shapes)]
        start += n
    return curriculum[-1][1][0]


def batch_for(T: int, base: int, family: str = "llama") -> int:
    """The batch at length ``T``: doubled at short T (formation needs
    vocabulary coverage), shrunk as T grows so that the fp32 scores of the
    live layer fit (the JAX tool's rule, as measured there)."""
    if family == "mla":
        if T <= 512:
            return base * 2
        return max(2, min(base, int(140e6 / (T * T))))
    if T <= 512:
        return base * 2
    b = max(4, min(base, (base * 2048) // T))
    if T > 2560:
        b = min(b, max(2, int(25 * (2560 / T) ** 2)))
    return b


def warmup_cosine_schedule(peak: float, steps: int):
    """The learning rate at step ``count`` of a ``steps``-step run: optax's
    ``warmup_cosine_decay_schedule(0, peak, warmup, steps, 0.15 peak)`` with
    the JAX tool's warmup ``min(200, max(1, steps // 10))``: linear from 0
    over the warmup, then a cosine to 0.15 of the peak at ``steps``."""
    warmup = min(200, max(1, steps // 10))
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"a run of {steps} steps leaves no decay steps "
                         f"after a warmup of {warmup}")
    alpha = 0.15

    def lr(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, decay)
                                       / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return lr


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float = 1.0) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: leave the gradients as
    they are when their global L2 norm is below ``max_norm``, else scale
    each by ``max_norm / norm`` (``t / norm * max_norm``; PyTorch's
    ``clip_grad_norm_`` divides by ``norm + 1e-6`` instead). Returns the
    norm."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    if not bool(norm < max_norm):
        for g in grads:
            g.copy_(g / norm * max_norm)
    return norm


def family_of(cfg):
    return "mla" if isinstance(cfg, mla.MLAConfig) else "llama"


def masked_loss(logits: torch.Tensor, tokens: torch.Tensor,
                mask: torch.Tensor):
    """(mean NLL, copy accuracy) over the determined targets: the JAX
    tool's ``loss_fn`` after its forward. ``logits`` [B, T, V] fp32,
    ``tokens`` [B, T], ``mask`` [T - 1] bool."""
    B = tokens.shape[0]
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    acc = (logits[:, :-1].argmax(-1) == tgt).float()
    m = mask[None, :].float()
    denom = m.sum() * B
    return (nll * m).sum() / denom, (acc * m).sum() / denom


class Trainer:
    """The training step of a quality model (``cfg`` a ``LlamaConfig`` or
    an ``MLAConfig``) over ``params``, whose leaves it trains in place:
    the masked loss through ``forward_train``, its gradients, optax's
    global-norm clip at 1.0 and AdamW (b1 0.9, b2 0.999, eps 1e-8, weight
    decay 0.01 on every leaf) at ``schedule(step)``."""

    def __init__(self, cfg, params: dict, schedule, remat: bool = True):
        self.cfg, self.params, self.schedule = cfg, params, schedule
        self.remat = remat
        self.model = mla if family_of(cfg) == "mla" else llama
        self.named = list(qc.flatten(params).items())
        for _, p in self.named:
            p.requires_grad_(True)
        self.opt = torch.optim.AdamW([p for _, p in self.named], lr=0.0,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=0.01)
        self.count = 0  # updates applied, the schedule's step

    def loss(self, tokens: np.ndarray, mask: np.ndarray):
        """(loss, copy accuracy) of a batch, differentiable."""
        dev = self.params["embed"].device
        t = torch.as_tensor(tokens, device=dev)
        logits = self.model.forward_train(self.params, self.cfg, t,
                                          remat=self.remat)
        return masked_loss(logits, t, torch.as_tensor(mask, device=dev))

    def gradients(self, tokens: np.ndarray, mask: np.ndarray):
        """The batch's (loss, accuracy) as floats; its gradients land in
        each leaf's ``.grad``."""
        self.opt.zero_grad(set_to_none=True)
        loss, acc = self.loss(tokens, mask)
        loss.backward()
        return float(loss.detach()), float(acc)

    def update(self) -> float:
        """Clip the gradients, apply AdamW at this step's rate. Returns the
        rate."""
        clip_by_global_norm_([p.grad for _, p in self.named], 1.0)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        return lr

    def step(self, tokens: np.ndarray, mask: np.ndarray):
        """One training step; (loss, accuracy) of the batch before it."""
        loss, acc = self.gradients(tokens, mask)
        self.update()
        return loss, acc


@torch.no_grad()
def evaluate(cfg, params: dict, bands, seed: int = SELF_CHECK_SEED):
    """The JAX tool's self-check: (T, R, nll, copy accuracy) of one held-out
    sequence a band, the sequences drawn in order from ``seed``."""
    model = mla if family_of(cfg) == "mla" else llama
    dev = params["embed"].device
    rng = np.random.default_rng(seed)
    out = []
    for T, R in bands:
        tokens = torch.as_tensor(qc.make_sequence(rng, T, R)[None, :],
                                 device=dev)
        mask = torch.as_tensor(qc.target_mask(T, R), device=dev)
        logits = model.forward_train(params, cfg, tokens, remat=False)
        loss, acc = masked_loss(logits, tokens, mask)
        out.append((T, R, float(loss), float(acc)))
        del logits
    return out


def self_check(family: str, path: str, device="cuda", bands=None):
    """:func:`evaluate` over every band of ``family`` of the checkpoint at
    ``path``, read back through its float16 file."""
    cfg = (qc.quality_mla_config() if family == "mla"
           else qc.quality_config())
    params = qc.load_params(cfg, path, device=device)
    return evaluate(cfg, params, bands or SELF_CHECK_BANDS[family])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="llama", choices=["llama", "mla"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True,
                    help="where to write the checkpoint (the committed "
                         "ones stay the codec gate's)")
    ap.add_argument("--init", default=None,
                    help="checkpoint to resume from (switches to the "
                         "long-position finetune curriculum)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.steps is None:
        args.steps = (1400 if args.init and args.family == "llama"
                      else 1000 if args.init
                      else 5600 if args.family == "llama" else 2200)
    if args.init:
        curriculum = (CURRICULUM_FINETUNE if args.family == "llama"
                      else CURRICULUM_FINETUNE_MLA)
    else:
        curriculum = (CURRICULUM if args.family == "llama"
                      else CURRICULUM_MLA)

    cfg = (qc.quality_config() if args.family == "llama"
           else qc.quality_mla_config())
    model = llama if args.family == "llama" else mla
    if args.init:
        params = qc.load_params(cfg, args.init, device=dev)
        args.lr = min(args.lr, 5e-4)  # mechanism formed; extend gently
    else:
        params = model.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
            device=dev)
    trainer = Trainer(cfg, params, warmup_cosine_schedule(args.lr,
                                                          args.steps))

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for step in range(args.steps):
        T, R = shape_for_step(step, args.steps, curriculum)
        B = batch_for(T, args.batch, args.family)
        loss, acc = trainer.step(qc.make_train_batch(rng, B, T, R),
                                 qc.target_mask(T, R))
        if step % 100 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  T={T:5d} R={R:5d} B={B:3d}  "
                  f"loss {loss:.4f}  copy-acc {acc:.4f}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if step and step % 500 == 0:
            qc.save_params(params, args.out)  # crash insurance

    qc.save_params(params, args.out)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    for T, R, loss, acc in self_check(args.family, args.out, dev):
        print(f"eval T={T:5d} R={R:5d}: nll {loss:.4f} "
              f"(ppl {float(np.exp(loss)):.4f})  copy-acc {acc:.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
