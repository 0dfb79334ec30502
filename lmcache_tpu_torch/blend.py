"""CacheBlend: non-prefix KV reuse with selective recompute.

The port of ``lmcache_tpu/blend.py``. A RAG prompt is a concatenation of
text chunks whose KV was cached *independently* (each prefilled standalone
at positions 0..t). Naive concatenation is wrong twice over: rotary
embeddings encode the wrong positions, and all cross-chunk attention is
missing. The blend:

1. **Position correction**: RoPE is a rotation, so moving a cached key from
   position p to p + delta multiplies it by the delta rotation; each chunk
   gets one re-rotation of its keys (values carry no positional encoding).
2. **Deviation-guided selection**: layer 0 is recomputed exactly (its KV
   depends only on embeddings), run through attention over the blended
   cache, and true layer-1 K/V are computed for every token; the
   ``ceil(ratio * T)`` tokens whose layer-1 K/V deviate most from the
   cached ones (the cross-chunk-attention victims) are selected, the last
   token always.
3. **Selective recompute**: only the selected tokens flow through layers
   1..L-1; at each layer their recomputed K/V are scattered back into the
   blended cache before attention, so later layers and the decode that
   follows see healed KV.

``recompute_ratio=1.0`` is an exact full prefill; ``0.0`` is naive reuse.
The chunk prefills run ``llama.forward``, whose attention is kernel row 1
on the card; the gathered-token attention of :func:`_attend_selected` is
plain PyTorch, as the JAX package computes it outside any Pallas kernel.
Every ``LlamaConfig`` family blends: the selective recompute runs the
forward's block structure (q/k norms, sandwich norms, MoE MLP, Llama-4's
query traits by each layer's is-global flag), and the key shift spins at
each layer's own rope frequencies where they differ by layer (Gemma-3's
dual theta; Llama-4's NoPE global layers, whose keys do not move).

On a ``mesh`` (``lmcache_tpu_torch.parallel``) each rank blends its head
slice with the parameters of ``parallel.shard_params``: its chunk KV is
stored and read under its own worker key (``parallel.shard_metadata``),
the gathered attention runs on its heads, the output projection and the
MLP are summed over "model" as in ``llama.forward``, and the deviation of
a token is its rank's sum summed over "model", so that every rank selects
the same tokens.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from lmcache_tpu_torch.chunks import hash_tokens
from lmcache_tpu_torch.models import llama
from lmcache_tpu_torch.ops.attention import _NEG_INF
from lmcache_tpu_torch.parallel.mesh import axis
from lmcache_tpu_torch.utils import CacheEngineKey

# gathered query rows per score matrix in the plain attention: the scores
# of a long prompt are [rows, H, T] fp32, so a whole prompt at once would
# take gigabytes
ATTEND_ROWS = 1024


def rope_shift_keys(keys: torch.Tensor, delta, theta: float,
                    rotary_dim=None, interleaved=False, scaling=None,
                    inv_freq=None) -> torch.Tensor:
    """Re-rotate RoPE'd keys by ``delta`` positions.

    keys: ``[..., T, H, D]`` (token axis third from last). delta: a scalar
    or a per-token ``[T]`` offset. ``rotary_dim``, ``interleaved`` and
    ``scaling`` follow ``llama._rope`` (partial interleaved rotary;
    ``LlamaConfig.rope_scaling_spec`` frequency scaling: the shift must spin
    at the *scaled* frequencies). The keys already carry yarn's mscale from
    their first roping, so the shift, a pure rotation, does not apply it
    again. ``inv_freq`` overrides the derived frequencies; it may carry
    leading axes that broadcast against ``delta[..., None]`` (``[L, 1,
    rd/2]``: a layer's own frequencies, :func:`assemble_chunks`)."""
    D = keys.shape[-1]
    rd = rotary_dim or D
    kr = keys[..., :rd].float()
    if inv_freq is None:
        inv_freq, _ = llama.rope_inv_freq(theta, rd, scaling,
                                          device=keys.device)
    delta = torch.as_tensor(delta, dtype=torch.float32, device=keys.device)
    angles = delta[..., None] * inv_freq
    if interleaved:
        cos = torch.repeat_interleave(torch.cos(angles), 2, dim=-1)
        sin = torch.repeat_interleave(torch.sin(angles), 2, dim=-1)
        k1, k2 = kr[..., 0::2], kr[..., 1::2]
        rotated = torch.stack([-k2, k1], dim=-1).reshape(kr.shape)
    else:
        cos = torch.cat([torch.cos(angles)] * 2, dim=-1)
        sin = torch.cat([torch.sin(angles)] * 2, dim=-1)
        k1, k2 = kr[..., :rd // 2], kr[..., rd // 2:]
        rotated = torch.cat([-k2, k1], dim=-1)
    cos, sin = cos[..., None, :], sin[..., None, :]  # over the head axis
    out = (kr * cos + rotated * sin).to(keys.dtype)
    if rd == D:
        return out
    return torch.cat([out, keys[..., rd:]], dim=-1)


def _attend_selected(q, k, v, qpos, kv_len, group, sm_scale=None,
                     logit_softcap=None, sliding_window=None,
                     window_kind="sliding", sinks=None) -> torch.Tensor:
    """Attention for gathered (non-contiguous) query tokens.

    q: ``[n, H, D]`` at global positions ``qpos [n]``; k/v
    ``[T, H_kv, D]``. Causal over global positions, keys valid below
    ``kv_len``; ``logit_softcap``, a ``"sliding"`` or ``"chunked"`` window
    (None for a global layer) and ``sinks`` [H] as in ``mha_reference``.
    Plain fp32, :data:`ATTEND_ROWS` query rows a score matrix. Returns
    ``[n, H * D]`` in q's dtype."""
    n, H, D = q.shape
    T, Hkv = k.shape[0], k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / D**0.5
    kf, vf = k.float(), v.float()
    kpos = torch.arange(T, device=q.device)
    out = []
    for r0 in range(0, n, ATTEND_ROWS):
        qh = q[r0:r0 + ATTEND_ROWS].reshape(-1, Hkv, group, D).float()
        pos = qpos[r0:r0 + ATTEND_ROWS]
        # scale, softcap and mask in place: each pass over the scores is as
        # large as the product that made them
        scores = torch.einsum("nhgd,thd->nhgt", qh, kf).mul_(scale)
        if logit_softcap is not None:
            scores.div_(logit_softcap).tanh_().mul_(logit_softcap)
        mask = (kpos[None, :] <= pos[:, None]) & (kpos[None, :] < kv_len)
        if sliding_window is not None:
            if window_kind == "chunked":
                mask &= (kpos[None, :] // sliding_window
                         == pos[:, None] // sliding_window)
            else:
                mask &= kpos[None, :] > pos[:, None] - sliding_window
        scores.masked_fill_(~mask[:, None, None, :], _NEG_INF)
        if sinks is not None:
            snk = sinks.float().reshape(1, Hkv, group, 1)
            m = torch.maximum(scores.amax(dim=-1, keepdim=True), snk)
            p = torch.exp(scores - m)
            probs = p / (p.sum(dim=-1, keepdim=True) + torch.exp(snk - m))
        else:
            probs = torch.softmax(scores, dim=-1)
        out.append(torch.einsum("nhgt,thd->nhgd", probs, vf))
    return torch.cat(out).reshape(n, H * D).to(q.dtype)


def select_tokens(dev: torch.Tensor, n_recompute: int) -> torch.Tensor:
    """The ``n_recompute`` tokens of largest deviation, the last token
    always, in causal order. Ties go to the lower index, as
    ``jax.lax.top_k`` breaks them (the first chunk's tokens all deviate by
    0)."""
    dev = dev.clone()
    dev[-1] = float("inf")
    order = torch.sort(-dev, stable=True).indices[:n_recompute]
    return torch.sort(order).values


@torch.no_grad()
def blend_prefill(params, cfg: llama.LlamaConfig, tokens: torch.Tensor,
                  blended_kv: torch.Tensor, n_recompute: int, mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heal blended KV. tokens: int ``[T]``, the whole concatenated prompt;
    ``blended_kv``: ``[L, 2, T, H_kv, D]`` position-corrected chunk KV
    (:func:`assemble_chunks`). Returns (last-token logits ``[vocab]`` fp32,
    healed KV ``[L, 2, T, H_kv, D]``, a new tensor). On ``mesh``, this
    rank's parameters and kv heads (``llama.kv_heads``); the logits are
    every rank's."""
    llama.check_supported(cfg)
    tp = axis(mesh, "model")
    split = llama.kv_heads(cfg, mesh) < cfg.n_kv_heads
    dev = blended_kv.device
    tokens = tokens.to(device=dev, dtype=torch.long)
    T = tokens.shape[0]
    group = cfg.n_heads // cfg.n_kv_heads
    positions = torch.arange(T, device=dev)
    windows = llama._layer_windows(cfg)
    # the JAX blend hands each layer its is-global flag as the config gives
    # it (not the forward scan's uniform-pattern False)
    globals_ = [bool(g) for g in cfg.layer_windows()]
    lps = params["layers"]
    kv = blended_kv.clone()

    def lp_at(i):
        return {name: w[i] for name, w in lps.items()}

    def heads(x, li, lp, pos):
        return llama._qkv_heads(llama._attn_input(x, lp, cfg), lp, cfg,
                                pos[None], globals_[li], tp)

    def attend(q, k, v, qpos, li, lp):
        opts = llama._attention_options(cfg, lp, windows[li], tp)
        return _attend_selected(q, k, v, qpos, T, group, **opts)

    # pass 1: exact layer 0 for every token, then true layer-1 K/V
    x = llama._embed(params, cfg, tokens[None])  # [1, T, dim]
    lp0 = lp_at(0)
    q0, k0, v0 = heads(x, 0, lp0, positions)
    kv[0, 0], kv[0, 1] = k0[0].to(kv.dtype), v0[0].to(kv.dtype)
    x = llama._block(
        x, attend(q0[0], k0[0], v0[0], positions, 0, lp0)[None], lp0, cfg,
        tp)

    l1 = min(1, cfg.n_layers - 1)
    _, k1, v1 = heads(x, l1, lp_at(l1), positions)
    deviation = (((k1[0].float() - kv[l1, 0].float())**2).sum(dim=(1, 2))
                 + ((v1[0].float() - kv[l1, 1].float())**2).sum(dim=(1, 2)))
    if split:
        deviation = tp.sum(deviation)
    sel = select_tokens(deviation, n_recompute)

    # pass 2: the selected tokens through layers 1..L-1, their K/V
    # scattered into the blended cache before each layer attends
    xs = x[:, sel]
    for li in range(1, cfg.n_layers):
        lp = lp_at(li)
        q, k, v = heads(xs, li, lp, sel)
        kv[li, 0, sel] = k[0].to(kv.dtype)
        kv[li, 1, sel] = v[0].to(kv.dtype)
        attn = attend(q[0], kv[li, 0], kv[li, 1], sel, li, lp)
        xs = llama._block(xs, attn[None], lp, cfg, tp)
    logits = llama._lm_logits(xs[:, -1:], params, cfg)[0, 0]
    return logits, kv


def assemble_chunks(chunk_blobs: Sequence[torch.Tensor], theta: float,
                    rotary_dim=None, interleaved=False, scaling=None,
                    local_theta=None, global_layers=None,
                    nope_global=False) -> torch.Tensor:
    """Concatenate independently cached chunk KV (wire format
    ``[L, 2, t_i, H, D]``, each prefilled at positions 0..t_i) into one
    position-corrected ``[L, 2, T, H, D]`` buffer on the first blob's
    device.

    Families whose rope differs by layer give ``global_layers`` (the
    per-layer is-global flags [L]) and either ``local_theta`` (Gemma-3: the
    sliding layers' keys were roped at that base, unscaled) or
    ``nope_global`` (Llama-4: the global layers' keys carry no rotation, so
    their shift is the identity); each layer's keys then spin at its own
    frequencies."""
    dev = chunk_blobs[0].device
    inv = None
    if local_theta is not None or nope_global:
        rd = rotary_dim or chunk_blobs[0].shape[-1]
        inv_g, _ = llama.rope_inv_freq(theta, rd, scaling, device=dev)
        if nope_global:
            inv_glb, inv_loc = torch.zeros_like(inv_g), inv_g
        else:
            inv_glb = inv_g
            inv_loc, _ = llama.rope_inv_freq(local_theta, rd, None,
                                             device=dev)
        glb = torch.as_tensor(list(global_layers), device=dev)[:, None, None]
        inv = torch.where(glb, inv_glb, inv_loc)  # [L, 1, rd/2]
    parts, offset = [], 0
    for blob in chunk_blobs:
        blob = blob.to(dev)
        t = blob.shape[2]
        k = rope_shift_keys(blob[:, 0],
                            torch.full((t,), float(offset), device=dev),
                            theta, rotary_dim, interleaved, scaling,
                            inv_freq=inv)
        parts.append(torch.stack([k, blob[:, 1]], dim=1))
        offset += t
    return torch.cat(parts, dim=2)


class BlenderBase:
    """Store / retrieve / blend for the family-specific blenders
    (:class:`CacheBlender` for dense-KV models,
    :class:`lmcache_tpu_torch.blend_mla.MLACacheBlender` for latent-KV
    models).

    Unlike prefix caching (rolling hash chains, ``chunks.py``), blend chunks
    are keyed by their own content hash, ``CacheEngineKey("blend", ...)``,
    so the same document's KV is reusable at any position in any prompt.
    Subclasses supply ``_chunk_prefill(tokens [1, t]) -> wire blob``,
    ``_assemble(blobs) -> position-corrected cache`` and
    ``_heal(full_tokens, blended, n_rec) -> (logits, wire blob)``. Blobs
    are computed on the device of the parameters and stored as the cache
    tier keeps them. On a ``mesh``, ``params`` are this rank's and the
    cache engine's metadata names its worker (``parallel.shard_metadata``).
    """

    def __init__(self, cfg, params, cache_engine,
                 recompute_ratio: float = 0.15, mesh=None):
        self.cfg = cfg
        self.params = params
        self.engine = cache_engine
        self.ratio = recompute_ratio
        self.mesh = mesh
        self.device = params["embed"].device

    def _key(self, tokens: np.ndarray) -> CacheEngineKey:
        m = self.engine.metadata
        return CacheEngineKey("blend", m.model_name, m.world_size,
                              m.worker_id, hash_tokens(tokens))

    def store_chunk(self, tokens) -> None:
        """Prefill a text chunk standalone and cache its KV under a
        position-independent content hash."""
        tokens = np.asarray(tokens, np.int32)
        blob = self._chunk_prefill(
            torch.as_tensor(tokens, dtype=torch.long,
                            device=self.device)[None])
        self.engine.engine_.put(self._key(tokens), blob, blocking=True)

    def blend(self, chunk_tokens: List[np.ndarray]):
        """Blend cached chunks into a healed prompt KV. Returns
        (last logits ``[vocab]`` fp32, wire KV blob, info dict). Chunks
        missing from the cache are prefilled and stored first; on a mesh,
        those that any rank of "model" misses (:meth:`_agreed_misses`)."""
        chunk_tokens = [np.asarray(t, np.int32) for t in chunk_tokens]
        blobs = [self.engine.engine_.get(self._key(t)) for t in chunk_tokens]
        missed = self._agreed_misses([b is None for b in blobs])
        for i, tokens in enumerate(chunk_tokens):
            if missed[i]:
                self.store_chunk(tokens)
                blobs[i] = self.engine.engine_.get(self._key(tokens))
        blobs = [b.to(self.device) for b in blobs]
        full = np.concatenate(chunk_tokens)
        blended = self._assemble(blobs)
        T, n_rec = self.counts(chunk_tokens)
        logits, kv = self._heal(
            torch.as_tensor(full, dtype=torch.long, device=self.device),
            blended, n_rec)
        return logits, kv, {
            "num_chunks": len(chunk_tokens),
            "misses": sum(missed),
            "recomputed_tokens": n_rec,
            "total_tokens": T,
        }

    def _agreed_misses(self, missed: List[bool]) -> List[bool]:
        """The chunks to prefill: on a mesh, those that any rank of "model"
        misses. A chunk prefill is a forward with sums over "model", so the
        ranks of one group must prefill the same chunks; their hits can
        differ, since each rank's tier is its own (a disk tier replays the
        shared directory when it opens, while other ranks store)."""
        if self.mesh is None:
            return missed
        flags = torch.tensor(missed, dtype=torch.int32, device=self.device)
        return [bool(m) for m in axis(self.mesh, "model").max(flags).tolist()]

    def counts(self, chunk_tokens) -> Tuple[int, int]:
        """(prompt tokens, tokens :meth:`blend` recomputes) of a blend of
        ``chunk_tokens``."""
        T = sum(len(t) for t in chunk_tokens)
        return T, max(1, min(T, int(np.ceil(self.ratio * T))))


class CacheBlender(BlenderBase):
    """:class:`BlenderBase` for dense-KV (llama-family) models; the wire
    blob is ``[L, 2, T, H_kv, D]``. The chunk prefills run
    ``llama.forward`` (kernel row 1 on the card)."""

    def __init__(self, cfg: llama.LlamaConfig, params, cache_engine,
                 recompute_ratio: float = 0.15, mesh=None):
        llama.check_supported(cfg)
        super().__init__(cfg, params, cache_engine, recompute_ratio, mesh)

    def _chunk_prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[1]
        cache = llama.new_kv_cache(self.cfg, 1, t, device=self.device,
                                   mesh=self.mesh)
        llama.forward(self.params, self.cfg, tokens,
                      torch.zeros(1, dtype=torch.int32, device=self.device),
                      cache, last_logit_only=True, mesh=self.mesh)
        return llama.cache_to_blob(cache, 0, t)

    def _assemble(self, blobs):
        c = self.cfg
        per_layer = c.rope_local_theta is not None or c.nope_on_global_layers
        return assemble_chunks(
            blobs, c.rope_theta, c.rotary_dim, c.rope_interleaved,
            c.rope_scaling_spec, local_theta=c.rope_local_theta,
            global_layers=tuple(c.layer_windows()) if per_layer else None,
            nope_global=c.nope_on_global_layers)

    def _heal(self, full, blended, n_rec):
        return blend_prefill(self.params, self.cfg, full, blended, n_rec,
                             self.mesh)
