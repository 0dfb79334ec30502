"""CacheBlend for Multi-head Latent Attention models.

The port of ``lmcache_tpu/blend_mla.py``. The dense recipe
(:mod:`lmcache_tpu_torch.blend`) carries over to MLA with one difference in
each step:

1. **Position correction**: a latent row is ``[c (r dims), k_pe (p dims)]``.
   The compressed ``c`` carries no positional encoding; only the shared
   rope key ``k_pe`` was roped at chunk-local positions, so moving a chunk
   re-rotates only the ``[r : r + p]`` slice of each row.
2. **Deviation-guided selection**: the cached object per (layer, token) is
   one latent row, so the deviation is the squared distance between the
   true layer-1 latent and the blended one.
3. **Selective recompute**: the selected tokens flow through layers
   1..L-1 (dense and MoE, the MoE layers through ``mla``'s padded expert
   blocks, ``experts.EXPERT_ROWS``) with absorbed-MQA attention over the
   blended latent stream, their healed rows scattered back first.

``recompute_ratio=1.0`` is an exact full prefill. The chunk prefills run
``mla.forward``, whose attention is kernel row 8 on the card; the
gathered-token attention is plain PyTorch, as in the JAX package. On a
``mesh`` the latents are whole on every rank, which selects the tokens
alone; each rank attends with its ``H / tp`` query heads, and the output
projection and the MLPs are summed over "model" as in ``mla.forward``.
"""

from typing import Tuple

import torch

from lmcache_tpu_torch.blend import (ATTEND_ROWS, BlenderBase,
                                     rope_shift_keys, select_tokens)
from lmcache_tpu_torch.models import mla
from lmcache_tpu_torch.ops.attention import _NEG_INF


def shift_latent_positions(lat: torch.Tensor, delta,
                           cfg: mla.MLAConfig) -> torch.Tensor:
    """Re-rotate the rope slice ``[r : r + p]`` of latent rows ``[..., T,
    C]`` by ``delta`` positions (a scalar or per-token ``[T]``) at the
    model's (possibly yarn-scaled) frequencies, without reapplying mscale."""
    r = cfg.kv_lora_rank
    k_pe = rope_shift_keys(lat[..., None, r:], delta, cfg.rope_theta, None,
                           cfg.rope_interleaved,
                           cfg.rope_scaling_spec)[..., 0, :]
    return torch.cat([lat[..., :r], k_pe.to(lat.dtype)], dim=-1)


def assemble_latent_chunks(chunk_blobs, cfg: mla.MLAConfig) -> torch.Tensor:
    """Concatenate independently cached latent chunk blobs (wire format
    ``[L, 1, t_i, 1, C]``, each prefilled at positions 0..t_i) into one
    position-corrected ``[L, T, C]`` latent stream on the first blob's
    device."""
    dev = chunk_blobs[0].device
    parts, offset = [], 0
    for blob in chunk_blobs:
        lat = blob.to(dev)[:, 0, :, 0, :]  # [L, t, C]
        t = lat.shape[1]
        parts.append(shift_latent_positions(
            lat, torch.full((t,), float(offset), device=dev), cfg))
        offset += t
    return torch.cat(parts, dim=1)


def _attend_selected_latent(q_full, lat, qpos, kv_len, rank,
                            scale) -> torch.Tensor:
    """Absorbed-MQA attention for gathered tokens: ``q_full [n, H, C]`` at
    global positions ``qpos [n]`` against latent rows ``lat [T, C]`` (scores
    over the whole row, values its first ``rank`` columns), causal, keys
    valid below ``kv_len``. Plain fp32, :data:`blend.ATTEND_ROWS` query rows
    a score matrix. Returns the context ``[n, H, rank]`` fp32."""
    lat32 = lat.float()
    kpos = torch.arange(lat.shape[0], device=lat.device)
    out = []
    for r0 in range(0, q_full.shape[0], ATTEND_ROWS):
        pos = qpos[r0:r0 + ATTEND_ROWS]
        scores = torch.einsum("nhc,tc->nht",
                              q_full[r0:r0 + ATTEND_ROWS].float(),
                              lat32).mul_(scale)
        mask = (kpos[None, :] <= pos[:, None]) & (kpos[None, :] < kv_len)
        scores.masked_fill_(~mask[:, None, :], _NEG_INF)
        out.append(torch.einsum("nht,tr->nhr", torch.softmax(scores, dim=-1),
                                lat32[:, :rank]))
    return torch.cat(out)


@torch.no_grad()
def mla_blend_prefill(params, cfg: mla.MLAConfig, tokens: torch.Tensor,
                      blended: torch.Tensor, n_recompute: int, mesh=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heal a blended latent stream. tokens: int ``[T]``, the whole prompt;
    ``blended``: ``[L, T, C]`` position-corrected latents
    (:func:`assemble_latent_chunks`). Returns (last-token logits
    ``[vocab]`` fp32, healed latents ``[L, T, C]``, a new tensor). On
    ``mesh``, this rank's parameters (its query heads)."""
    mla.check_supported(cfg)
    tp = mla.model_axis(cfg, mesh)
    dev = blended.device
    tokens = tokens.to(device=dev, dtype=torch.long)
    T = tokens.shape[0]
    r, kd = cfg.kv_lora_rank, cfg.n_dense_layers
    positions = torch.arange(T, device=dev)
    lat = blended.clone()

    def lp_at(i):
        block, j = ("dense_layers", i) if i < kd else ("moe_layers", i - kd)
        return {name: w[j] for name, w in params[block].items()}

    def layer_rest(x, ctx, lp, i):
        """Output projection, residual and the layer's MLP: x [1, n, dim],
        ctx [n, H, r]."""
        return mla._mlp_residual(x, mla._context_out(ctx[None], lp, cfg, x),
                                 lp, cfg, cfg.moe_layer(i), tp)

    # pass 1: exact layer-0 latents for every token, attention over the
    # healed layer-0 stream
    x = params["embed"][tokens][None]  # [1, T, dim]
    lp0 = lp_at(0)
    q0, new0 = mla._mla_project(x, lp0, cfg, positions[None])
    lat[0] = new0[0].to(lat.dtype)
    ctx0 = _attend_selected_latent(q0[0], lat[0], positions, T, r,
                                   cfg.sm_scale)
    x = layer_rest(x, ctx0, lp0, 0)

    # selection by the true layer-1 latents (projections only)
    l1 = min(1, cfg.n_layers - 1)
    _, new1 = mla._mla_project(x, lp_at(l1), cfg, positions[None])
    deviation = ((new1[0].float() - lat[l1].float())**2).sum(dim=-1)
    sel = select_tokens(deviation, n_recompute)

    # pass 2: the selected tokens through layers 1..L-1
    xs = x[:, sel]
    for li in range(1, cfg.n_layers):
        lp = lp_at(li)
        q, new = mla._mla_project(xs, lp, cfg, sel[None])
        lat[li, sel] = new[0].to(lat.dtype)
        ctx = _attend_selected_latent(q[0], lat[li], sel, T, r, cfg.sm_scale)
        xs = layer_rest(xs, ctx, lp, li)
    logits = mla._logits(xs, params, cfg, last_logit_only=True)[0, 0]
    return logits, lat


class MLACacheBlender(BlenderBase):
    """:class:`lmcache_tpu_torch.blend.BlenderBase` for MLA models; the
    wire blob is the latent ``[L, 1, T, 1, C]`` (``mla.cache_to_blob``), so
    the healed result injects through the engines' unchanged hooks."""

    def __init__(self, cfg: mla.MLAConfig, params, cache_engine,
                 recompute_ratio: float = 0.15, mesh=None):
        mla.check_supported(cfg)
        super().__init__(cfg, params, cache_engine, recompute_ratio, mesh)

    def _chunk_prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[1]
        cache = mla.new_latent_cache(self.cfg, 1, t, device=self.device,
                                     mesh=self.mesh)
        mla.forward(self.params, self.cfg, tokens,
                    torch.zeros(1, dtype=torch.int32, device=self.device),
                    cache, last_logit_only=True, mesh=self.mesh)
        return mla.cache_to_blob(cache, 0, t)

    def _assemble(self, blobs):
        return assemble_latent_chunks(blobs, self.cfg)

    def _heal(self, full, blended, n_rec):
        logits, lat = mla_blend_prefill(self.params, self.cfg, full, blended,
                                        n_rec, self.mesh)
        return logits, lat[:, None, :, None, :]
