"""Ring (context-parallel) attention over ``torch.distributed``: the port of
``lmcache_tpu/parallel/ring_attention.py``.

The sequence axis is split over a mesh axis (``seq_axis``):

- every rank holds a CONTIGUOUS block of the sequence's q/k/v (``T / p``
  tokens), the contiguous-chunk unit the cache engine stores;
- at each of ``p`` ring steps a rank attends its local queries against the
  KV block it holds, accumulating the online-softmax partials ``(m, l,
  acc)`` in fp32, while the block goes on to the next rank of the ring and
  the previous rank's arrives (``dist.batch_isend_irecv``, issued before
  the step's compute so that the two overlap);
- causality skips the compute, not the pass, of blocks wholly in a query
  block's future, so rank ``i`` does work on ``i + 1`` of the ``p`` steps;
  for a windowed (non-global) layer, blocks wholly outside every query's
  window skip theirs too;
- sliding and chunked windows, the is-global flag that overrides them, the
  score softcap and attention sinks, as in the JAX body.

The per-block attention is plain PyTorch, as the JAX package computes it
outside Pallas. Heads compose with tensor parallelism on ``head_axis``: each
rank passes its own head slice of its block around its ring.
"""

from typing import Optional

import torch
import torch.distributed as dist

from lmcache_tpu_torch.parallel.mesh import Axis, axis, take_slice

_NEG_INF = -1e30


def _rotate(seq: Axis, k, v):
    """Start passing ``k, v`` to the next rank of the ring and receiving
    the previous rank's: (the requests, the buffers that receive)."""
    k, v = k.contiguous(), v.contiguous()
    k_in, v_in = torch.empty_like(k), torch.empty_like(v)
    nxt, prv = seq.peer(seq.index + 1), seq.peer(seq.index - 1)
    ops = [dist.P2POp(dist.isend, k, nxt, seq.group),
           dist.P2POp(dist.irecv, k_in, prv, seq.group),
           dist.P2POp(dist.isend, v, nxt, seq.group),
           dist.P2POp(dist.irecv, v_in, prv, seq.group)]
    return dist.batch_isend_irecv(ops), (k_in, v_in)


def ring_body(q, k, v, q_offset, kv_len, seq: Axis, *, scale: float,
              logit_softcap: Optional[float] = None,
              sliding_window: Optional[int] = None,
              window_kind: str = "sliding", is_global: bool = False,
              sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ring attention of this rank's block: q [B, Tl, H, D], k and v
    [B, Tl, H_kv, D] (its block of the sequence on ``seq``), ``q_offset``
    and ``kv_len`` int [B] (the position of token 0, the valid tokens),
    ``sinks`` [H] of these heads. Key block ``r`` of row b holds positions
    ``q_offset[b] + r * Tl + [0, Tl)``. Returns [B, Tl, H, D] in q's dtype;
    a query with no live key gives 0 (without sinks)."""
    p, my = seq.size, seq.index
    B, Tl, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    dev = q.device
    windowed = sliding_window is not None and not is_global
    q_offset = q_offset.to(device=dev, dtype=torch.long)
    kv_len = kv_len.to(device=dev, dtype=torch.long)
    ar = torch.arange(Tl, device=dev)
    qh = q.reshape(B, Tl, Hkv, G, D).permute(0, 2, 3, 1, 4).float()
    qpos = q_offset[:, None] + my * Tl + ar[None, :]  # [B, Tl]
    if windowed and window_kind == "chunked":
        # chunk boundaries are nonlinear in each row's absolute positions,
        # so a block is skipped only when no row needs it
        qmin = (q_offset + my * Tl).tolist()
        cstart = [o - o % sliding_window for o in qmin]
        offs = q_offset.tolist()

    m = torch.full((B, Hkv, G, Tl, 1), _NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G, Tl, 1), device=dev)
    acc = torch.zeros((B, Hkv, G, Tl, D), device=dev)
    kr, vr = k, v
    for r in range(p):
        pending = _rotate(seq, kr, vr) if r < p - 1 else None
        src = (my - r) % p
        live = src <= my
        if windowed:
            if window_kind == "chunked":
                live &= any(o + (src + 1) * Tl - 1 >= c
                            for o, c in zip(offs, cstart))
            else:
                # q_offset cancels on both sides of a trailing window
                live &= (src + 1) * Tl > my * Tl - sliding_window + 1
        if live:
            kh = kr.permute(0, 2, 1, 3).float()  # [B, Hkv, Tl, D]
            vh = vr.permute(0, 2, 1, 3)
            s = torch.einsum("bhgtd,bhsd->bhgts", qh, kh) * scale
            if logit_softcap is not None:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            kpos = q_offset[:, None] + src * Tl + ar[None, :]  # [B, Tl]
            mask = ((kpos[:, None, :] <= qpos[:, :, None])
                    & (kpos[:, None, :] < kv_len[:, None, None]))
            if windowed:
                if window_kind == "chunked":
                    mask &= (kpos[:, None, :] // sliding_window
                             == qpos[:, :, None] // sliding_window)
                else:
                    mask &= kpos[:, None, :] > qpos[:, :, None] - \
                        sliding_window
            mask = mask[:, None, None]
            s = torch.where(mask, s, torch.tensor(_NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            # masked probabilities are exactly 0: a row that sees no key of
            # this block keeps m at -1e30, where exp(s - m) would be 1
            pr = torch.exp(s - m_new) * mask
            l = alpha * l + pr.sum(dim=-1, keepdim=True)
            acc = alpha * acc + torch.einsum(
                "bhgts,bhsd->bhgtd", pr.to(vh.dtype).float(), vh.float())
            m = m_new
        if pending is not None:
            reqs, (kr, vr) = pending
            for req in reqs:
                req.wait()
    if sinks is not None:
        snk = sinks.to(device=dev, dtype=torch.float32).reshape(
            1, Hkv, G, 1, 1)
        m2 = torch.maximum(m, snk)
        out = acc * torch.exp(m - m2) / (l * torch.exp(m - m2)
                                         + torch.exp(snk - m2))
    else:
        dead = l == 0.0
        out = torch.where(dead, torch.zeros((), device=dev),
                          acc / torch.where(dead, torch.ones((), device=dev),
                                            l))
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tl, H, D).to(q.dtype)


def ring_attention(
    q: torch.Tensor,  # [B, T, H, D], the whole sequence
    k: torch.Tensor,  # [B, T, H_kv, D]
    v: torch.Tensor,
    q_offset: torch.Tensor,  # int [B] position of token 0
    kv_len: torch.Tensor,  # int [B] valid tokens (ragged batches)
    mesh,
    *,
    seq_axis: str = "data",
    head_axis: Optional[str] = "model",
    sm_scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    window_kind: str = "sliding",
    is_global: bool = False,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal ring attention over ``mesh``, the JAX ``ring_attention``'s
    arguments: every rank is given the whole ``q/k/v`` (as the single
    controller is), takes its block of the sequence on ``seq_axis`` and,
    where the heads and kv heads divide ``head_axis``, its head slice on it
    (sinks [H] sliced with the heads), and runs :func:`ring_body`. Returns
    this rank's block of the output, [B, T / p, H', D]. ``T`` must divide
    the ``seq_axis`` size."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    seq = axis(mesh, seq_axis)
    if T % seq.size:
        raise ValueError(f"T ({T}) must divide the {seq_axis!r} axis size "
                         f"({seq.size})")
    tp = axis(mesh, head_axis) if head_axis else Axis()
    Tl = T // seq.size
    blk = slice(seq.index * Tl, (seq.index + 1) * Tl)
    q, k, v = q[:, blk], k[:, blk], v[:, blk]
    if tp.size > 1 and H % tp.size == 0 and Hkv % tp.size == 0:
        q, k, v = (take_slice(t, 2, tp.index, tp.size) for t in (q, k, v))
        if sinks is not None:
            sinks = take_slice(sinks, 0, tp.index, tp.size)
    scale = sm_scale if sm_scale is not None else 1.0 / (D**0.5)
    return ring_body(q, k, v, q_offset, kv_len, seq, scale=scale,
                     logit_softcap=logit_softcap,
                     sliding_window=sliding_window, window_kind=window_kind,
                     is_global=is_global, sinks=sinks)
