"""The prefill ablation variants of row 1's attention body.

The counterpart of the two TPU kernels of ``tools/bench_prefill_mfu.py``:
``variant_kernel`` (modes ``full``, ``mxu_only`` and ``no_mask``, each with
or without ``pair``) and ``pipelined_kernel`` (``full``'s function as a
software pipeline over the key blocks). The tool times them against row 1
to see where a prefill's time goes; the port's own tool is
:mod:`lmcache_tpu_torch.tools.bench_prefill_mfu`.

Layouts, as the TPU kernels take them: ``q [B, H, Tp, D]`` head-major with
``Tp`` a multiple of ``bq``, ``k``/``v [B, H_kv, S, D]``, ``q_offset`` and
``kv_len`` int32 ``[B]``; the output is ``[B, H, Tp, D]`` in q's dtype, the
scale ``1 / sqrt(D)``. Query block ``iq = t // bq``; key block ``kb`` is
*live* for it when ``kb * bk <= q_offset[b] + (iq + 1) * bq - 1``, and only
live blocks are visited. The logical blocks ``bq`` and ``bk`` are part of
the function:

- ``full``: causal attention, ``kpos <= min(qpos, kv_len - 1)``, 0 for a
  row that sees no key: row 1's function, whatever the blocks;
- ``no_mask``: softmax attention over every key of every live block,
  unmasked (keys past the diagonal and past ``kv_len`` included);
- ``mxu_only``: ``sum over live keys of bf16(scale * q.k) * v``, divided by
  the number of live blocks: no max, no exponent;
- ``pair``: two key blocks a step in the TPU kernel, the same function. Its
  grid has ``total_kb // 2`` steps, so with an odd number of key blocks
  the TPU kernel never visits the last one; the port refuses that case;
- :func:`pipelined_attention`: ``full``'s function.

The unmasked modes read every key of a live block, so they need ``S`` to be
a multiple of ``bk``.

On CUDA tensors the entry points launch the hand-written Hopper kernels of
``csrc/prefill_variants.cu`` and raise on what they do not take: one
template on row 1's body (``csrc/flash_sm90.cuh``: a TMA ring of key
tiles, two ``wgmma`` consumer warpgroups of 64 query rows with S, P and O
in registers) with a schedule a variant (row 1's tile at a time; two tiles'
QK products before either update for ``pair``; the next tile's QK product
beside this tile's softmax for ``pipelined``); bf16, D 64 or 128, a group
size that divides 64, ``bq`` and ``bk`` multiples of 64. On CPU tensors
they compute the plain versions, :func:`variant_reference`.
``variant_attention.launches`` and ``pipelined_attention.launches`` count
kernel launches by variant name (``full``, ``no_mask``, ``mxu_only``,
``pair``, ``pair_no_mask``, ``pair_mxu_only``; ``pipelined``).
"""

import ctypes
from collections import Counter

import torch

from lmcache_tpu_torch.ops import _build
from lmcache_tpu_torch.ops.attention import (FlashArgs, _check_cuda_args,
                                             fill_args)

MODES = ("full", "no_mask", "mxu_only")  # the kernel's mode numbers
# bq and bk come in multiples of a consumer warpgroup's 64 query rows
# (which then lie in one logical query block); a key block may end
# inside one of the kernel's key tiles (64 or 128 keys), which is then
# masked
TILE = 64
_entry = None


def variant_name(mode: str, pair: bool) -> str:
    """The tool's name of a variant: ``pair`` for full with pair."""
    if not pair:
        return mode
    return "pair" if mode == "full" else f"pair_{mode}"


def visited_blocks(S: int, bk: int, pair: bool) -> int:
    """Key blocks the variant's walk can reach: every block of the keys,
    ``ceil(S / bk)``; with ``pair`` two a step, which must come out even."""
    total = -(-S // bk)
    if pair and total % 2:
        raise ValueError(
            f"pair with an odd number of key blocks ({total} of {bk}): the "
            f"TPU kernel's grid of total_kb // 2 steps never visits the last "
            f"block, a result no other variant gives")
    return total


def _check(q, k, v, q_offset, kv_len, mode, pair, bq, bk):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    for name, blk in (("bq", bq), ("bk", bk)):
        if blk <= 0 or blk % TILE:
            raise ValueError(f"{name} must be a positive multiple of {TILE}: "
                             f"{blk}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B, H, Tp, D] and k, v [B, H_kv, S, D]: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Tp, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if Tp % bq:
        raise ValueError(f"q's {Tp} positions are not a multiple of bq {bq}")
    if mode != "full" and S % bk:
        raise ValueError(f"{mode} reads every key of a live block: S {S} "
                         f"must be a multiple of bk {bk}")
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be [{B}]: {tuple(t.shape)}")
    return visited_blocks(S, bk, pair)


@torch.no_grad()
def variant_reference(q, k, v, q_offset, kv_len, *, mode="full",
                      pair=False, bq, bk) -> torch.Tensor:
    """Plain PyTorch version of every variant (see the module docstring),
    in fp32 with materialized scores, one logical query block of one
    sequence at a time so that the scores of a long prefill fit in memory.
    ``pair`` only checks the block count: the function is the unpaired
    one. A row that sees no key gives 0, as the kernels do."""
    nkb = _check(q, k, v, q_offset, kv_len, mode, pair, bq, bk)
    B, H, Tp, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / D**0.5
    qo, kl = q_offset.tolist(), kv_len.tolist()
    out = torch.empty_like(q)
    for b in range(B):
        kf, vf = k[b].float(), v[b].float()  # [H_kv, S, D]
        for t0 in range(0, Tp, bq):
            qpos_max = qo[b] + t0 + bq - 1
            nlive = max(0, min(qpos_max // bk + 1, nkb))
            kend = min(nlive * bk, S)
            qh = q[b, :, t0:t0 + bq].float().reshape(Hkv, G, bq, D)
            s = torch.einsum("hgtd,hsd->hgts", qh, kf[:, :kend])
            if mode == "mxu_only":
                p = (s * scale).to(torch.bfloat16).float()
                o = torch.einsum("hgts,hsd->hgtd", p, vf[:, :kend])
                o = o / nlive if nlive else o * 0
            else:
                s = s * scale
                live = None
                if mode == "full":
                    qpos = qo[b] + t0 + torch.arange(bq, device=q.device)
                    kpos = torch.arange(kend, device=q.device)
                    live = kpos[None, :] <= torch.clamp(qpos, max=kl[b] - 1
                                                        )[:, None]
                    s = torch.where(live, s, torch.tensor(
                        -1e30, device=q.device))
                o = torch.einsum("hgts,hsd->hgtd", torch.softmax(s, dim=-1),
                                 vf[:, :kend])
                if live is not None:
                    o = o * live.any(dim=-1)[:, None].to(o.dtype)
            out[b, :, t0:t0 + bq] = o.reshape(H, bq, D).to(q.dtype)
    return out


def _load_entry():
    global _entry
    if _entry is None:
        fn = _build.load("prefill_variants").lmc_prefill_variant
        fn.argtypes = ([ctypes.POINTER(FlashArgs)] + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def _launch(wrapper, q, k, v, q_offset, kv_len, mode, pair, pipelined, bq,
            bk, nkb, name):
    """One launch of the variant kernel on q's current stream: the argument
    block of row 1 with q and out as [B, Tp, H, D] views of the head-major
    tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, Tp, D = q.shape
    Hkv = k.shape[1]
    if TILE % (H // Hkv):
        raise ValueError(f"the CUDA kernel needs a group size that divides "
                         f"{TILE}: {H // Hkv}")
    out = torch.empty_like(q)
    qv = q.transpose(1, 2)
    a, Hkv, S = fill_args(qv, k, v, out.transpose(1, 2), q_offset, kv_len,
                          True, None)
    _check_cuda_args(qv, k, v, q_offset, kv_len, B, Hkv, S,
                     head_dims=(64, 128))
    err = _load_entry()(ctypes.byref(a), B, H, Hkv, D, MODES.index(mode),
                        int(pair), int(pipelined), bq, bk, nkb,
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                           f"cudaError {err}")
    wrapper.launches[name] += 1
    return out


def variant_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_offset: torch.Tensor, kv_len: torch.Tensor, *,
                      mode: str = "full", pair: bool = False, bq: int = 256,
                      bk: int = 1024) -> torch.Tensor:
    """The function of the TPU ``variant_kernel`` (see the module
    docstring): ``mode`` one of ``full``, ``no_mask``, ``mxu_only``, with or
    without ``pair``, at the logical blocks ``bq`` and ``bk``."""
    nkb = _check(q, k, v, q_offset, kv_len, mode, pair, bq, bk)
    if q.device.type == "cpu":
        return variant_reference(q, k, v, q_offset, kv_len, mode=mode,
                                 pair=pair, bq=bq, bk=bk)
    return _launch(variant_attention, q, k, v, q_offset, kv_len, mode, pair,
                   False, bq, bk, nkb, variant_name(mode, pair))


variant_attention.launches = Counter()


def pipelined_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: torch.Tensor, kv_len: torch.Tensor, *,
                        bq: int = 256, bk: int = 1024) -> torch.Tensor:
    """The function of the TPU ``pipelined_kernel``: ``full``'s, computed on
    the card by a kernel that issues each key tile's QK product before the
    previous tile's softmax and PV."""
    nkb = _check(q, k, v, q_offset, kv_len, "full", False, bq, bk)
    if q.device.type == "cpu":
        return variant_reference(q, k, v, q_offset, kv_len, mode="full",
                                 bq=bq, bk=bk)
    return _launch(pipelined_attention, q, k, v, q_offset, kv_len, "full",
                   False, True, bq, bk, nkb, "pipelined")


pipelined_attention.launches = Counter()
