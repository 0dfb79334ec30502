"""Causal GQA attention over a (possibly pre-filled) KV buffer.

One kernel serves both serving-phase shapes, as in
``lmcache_tpu/ops/attention.py``:

- **prefill with cached prefix**: ``T`` new query tokens attend to
  ``kv_len`` tokens already resident in the KV buffer (retrieved prefix +
  the new tokens themselves);
- **decode**: ``T == 1``.

Options, as in the JAX file: a sliding or chunked window, a score softcap,
attention sinks, and a pool row chosen on the device (``kv_slot``).

Layouts: ``q [B, T, H, D]``; ``k/v [B, S, H_kv, D]`` (token-major) or, with
``kv_head_major=True``, ``[B, H_kv, S, D]`` (the serving pool's layout).
``H = G * H_kv``. Query ``t`` of sequence ``b`` sees key positions
``kpos <= min(q_offset[b] + t, kv_len[b] - 1)``.

:func:`flash_attention` runs the hand-written Hopper kernels
(``csrc/flash_attention.cu``) on CUDA tensors and its plain version,
:func:`mha_reference`, on CPU tensors: a launch of more than
``DECODE_ROWS`` rows (T * G) runs the prefill body (``csrc/flash_sm90.cuh``:
TMA, wgmma, S, P and O in registers); one of at most ``DECODE_ROWS`` rows,
every decode step, runs the key-split decode: partials over splits of
``SPLIT_KEYS`` keys, then :func:`combine_partials` (plain versions
:func:`split_partials_reference` and :func:`combine_partials_reference`).
:func:`flash_attention_dma` is the windowless variant with a deeper ring of
K/V stages (``csrc/flash_stream_attention.cu``).
"""

import ctypes
from collections import Counter
from typing import Optional

import torch

from lmcache_tpu_torch.ops import _build

_NEG_INF = -1e30


def mha_reference(q, k, v, q_offset, kv_len, sm_scale=None,
                  sliding_window: Optional[int] = None,
                  zero_dead_rows: bool = False,
                  logit_softcap: Optional[float] = None,
                  window_kind: str = "sliding",
                  sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch attention (token-major ``k/v [B, S, H_kv, D]``): the
    kernels' plain version, computed in fp32 with a materialized score
    matrix, and the CPU path of :func:`flash_attention`.

    ``sliding_window``: keys older than that many positions behind the query
    are masked too (``kpos > qpos - sliding_window``); with
    ``window_kind="chunked"`` the same size bounds block-diagonal chunks
    instead (``kpos // W == qpos // W``, Llama-4). ``logit_softcap`` bounds
    the scores to (-cap, cap) by ``cap * tanh(s / cap)`` before the mask
    (Gemma-2). ``sinks`` [H]: per-head attention-sink logits joined to the
    softmax normalization and then dropped (GPT-OSS). A query that sees no
    key averages V uniformly, as the JAX ``mha_reference`` does (0 with
    sinks); with ``zero_dead_rows`` it gives 0, as the kernels do."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D**0.5)
    if window_kind not in ("sliding", "chunked"):
        raise ValueError(f"unknown window_kind {window_kind!r}")

    # [B, Hkv, G, T, D] x [B, Hkv, S, D] -> [B, Hkv, G, T, S]
    qh = q.reshape(B, T, Hkv, G, D).permute(0, 2, 3, 1, 4).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    scores = torch.einsum("bhgtd,bhsd->bhgts", qh, kh) * scale
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)

    ar_t = torch.arange(T, device=q.device)
    kpos = torch.arange(S, device=q.device)[None, None, :]  # [1, 1, S]
    qpos = (q_offset.to(q.device)[:, None] + ar_t[None, :])[:, :, None]
    mask = (kpos <= qpos) & (kpos < kv_len.to(q.device)[:, None, None])
    if sliding_window is not None:
        if window_kind == "chunked":
            mask &= (kpos // sliding_window) == (qpos // sliding_window)
        else:
            mask &= kpos > qpos - sliding_window
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(_NEG_INF, device=q.device))
    if sinks is not None:
        snk = sinks.to(device=q.device, dtype=torch.float32).reshape(
            1, Hkv, G, 1, 1)
        m = torch.maximum(scores.amax(dim=-1, keepdim=True), snk)
        p = torch.exp(scores - m)
        probs = p / (p.sum(dim=-1, keepdim=True) + torch.exp(snk - m))
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, vh)
    if zero_dead_rows:
        out = out * mask.any(dim=-1)[:, None, None, :, None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)


# the key-split decode: launches of at most DECODE_ROWS rows (T * G) split
# the keys at absolute multiples of SPLIT_KEYS (csrc/flash_attention.cu)
DECODE_ROWS = 16
SPLIT_KEYS = 256


def n_splits(S: int) -> int:
    """Splits of the key-split decode over a K/V buffer of ``S`` keys: the
    grid is sized from S alone (never from ``kv_len``, which lives on the
    device), and at least one partial is written."""
    return max(1, -(-S // SPLIT_KEYS))


def split_ranges(S: int, lo: int, hi: int):
    """The live splits of a row that sees keys ``[lo, hi]`` of a buffer of
    ``S``: ``[(split, first key, last key)]``. Split points are absolute
    multiples of ``SPLIT_KEYS``, so they depend on S and the row's own range
    only, never on the batch or its other rows; every other split of the
    grid gives the row an empty partial."""
    hi = min(hi, S - 1)
    if lo > hi:
        return []
    return [(s, max(lo, s * SPLIT_KEYS), min(hi, (s + 1) * SPLIT_KEYS - 1))
            for s in range(lo // SPLIT_KEYS, hi // SPLIT_KEYS + 1)]


def _rows_mask_scores(q, k, v, q_offset, kv_len, sm_scale, sliding_window,
                      window_kind, logit_softcap):
    """fp32 scores [B, H_kv, R, S] of the rows R = T * G (token-major, as
    the kernels flatten them), their mask and V [B, H_kv, S, D]
    (token-major ``k/v [B, S, H_kv, D]``)."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D**0.5)
    qr = q.reshape(B, T, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, T * G, D).float()
    scores = torch.einsum("bhrd,bhsd->bhrs", qr,
                          k.permute(0, 2, 1, 3).float()) * scale
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    dev = q.device
    qpos = (q_offset.to(dev)[:, None]
            + torch.arange(T, device=dev).repeat_interleave(G)[None])
    qpos = qpos[:, None, :, None]  # [B, 1, R, 1]
    kpos = torch.arange(S, device=dev)[None, None, None]
    mask = (kpos <= qpos) & (kpos < kv_len.to(dev)[:, None, None, None])
    if sliding_window is not None:
        if window_kind == "chunked":
            mask &= (kpos // sliding_window) == (qpos // sliding_window)
        else:
            mask &= kpos > qpos - sliding_window
    return scores, mask.expand_as(scores), v.permute(0, 2, 1, 3).float()


def split_partials_reference(q, k, v, q_offset, kv_len, sm_scale=None,
                             sliding_window: Optional[int] = None,
                             window_kind: str = "sliding",
                             logit_softcap: Optional[float] = None):
    """Plain version of the key-split decode's first kernel (token-major
    ``k/v [B, S, H_kv, D]``): for every row (token, head-in-group) of each
    (sequence, KV head) and every split of ``SPLIT_KEYS`` keys, the partial
    ``(m, l, O)`` of the online softmax over the row's live keys in the
    split, unnormalized, in fp32. Returns ``part_o [B, H_kv, n, R, D]`` and
    ``part_ml [B, H_kv, n, R, 2]`` with ``n = n_splits(S)``; a split with no
    live key gives ``m = -1e30, l = 0, O = 0``."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scores, mask, vh = _rows_mask_scores(q, k, v, q_offset, kv_len, sm_scale,
                                         sliding_window, window_kind,
                                         logit_softcap)
    n = n_splits(S)
    pad = n * SPLIT_KEYS - S
    R = scores.shape[2]
    scores = torch.nn.functional.pad(scores, (0, pad)).reshape(
        B, Hkv, R, n, SPLIT_KEYS)
    mask = torch.nn.functional.pad(mask, (0, pad)).reshape(
        B, Hkv, R, n, SPLIT_KEYS)
    vh = torch.nn.functional.pad(vh, (0, 0, 0, pad)).reshape(
        B, Hkv, n, SPLIT_KEYS, D)
    masked = torch.where(mask, scores,
                         torch.tensor(_NEG_INF, device=q.device))
    m = masked.amax(dim=-1)  # [B, H_kv, R, n]
    p = torch.where(mask, torch.exp(masked - m[..., None]),
                    torch.zeros((), device=q.device))
    part_o = torch.einsum("bhrnk,bhnkd->bhnrd", p, vh)
    part_ml = torch.stack([m, p.sum(dim=-1)], dim=-1).permute(0, 1, 3, 2, 4)
    return part_o.contiguous(), part_ml.contiguous()


def combine_partials_reference(part_o, part_ml, T: int, G: int,
                               sinks: Optional[torch.Tensor] = None):
    """Plain version of the key-split decode's combine: the partials of each
    row (``part_o [B, H_kv, n, R, D]``, ``part_ml [B, H_kv, n, R, 2]``,
    R = T * G) merged over the splits, partials with ``l = 0`` skipped
    (their O is never read), sinks ([H] fp32) joined to the normalization
    once. Returns fp32 ``[B, T, H, D]``; a row with no live key gives 0."""
    B, Hkv, n, R, D = part_o.shape
    m_s, l_s = part_ml[..., 0].float(), part_ml[..., 1].float()
    live = l_s > 0
    neg = torch.tensor(_NEG_INF, device=part_o.device)
    m = torch.where(live, m_s, neg).amax(dim=2)  # [B, H_kv, R]
    w = torch.where(live, torch.exp(m_s - m[:, :, None]),
                    torch.zeros((), device=part_o.device))
    l = (w * l_s).sum(dim=2)
    o = torch.where(live[..., None], w[..., None] * part_o.float(),
                    torch.zeros((), device=part_o.device)).sum(dim=2)
    if sinks is not None:
        snk = sinks.to(device=part_o.device, dtype=torch.float32).reshape(
            Hkv, G).repeat(1, T)[None]  # [1, H_kv, R]
        m2 = torch.maximum(m, snk)
        keep = torch.exp(m - m2)
        inv = keep / (l * keep + torch.exp(snk - m2))
    else:
        inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0),
                          torch.zeros((), device=part_o.device))
    out = o * inv[..., None]  # [B, H_kv, R, D]
    return out.reshape(B, Hkv, T, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, T, Hkv * G, D)


def split_attention_reference(q, k, v, q_offset, kv_len, sm_scale=None,
                              sliding_window: Optional[int] = None,
                              window_kind: str = "sliding",
                              logit_softcap: Optional[float] = None,
                              sinks: Optional[torch.Tensor] = None):
    """The plain split-then-combine of the key-split decode (token-major
    ``k/v``): :func:`split_partials_reference`, then
    :func:`combine_partials_reference`; fp32 ``[B, T, H, D]``, 0 for a row
    that sees no key. Equal to :func:`mha_reference` with
    ``zero_dead_rows`` up to fp32 rounding."""
    part_o, part_ml = split_partials_reference(
        q, k, v, q_offset, kv_len, sm_scale=sm_scale,
        sliding_window=sliding_window, window_kind=window_kind,
        logit_softcap=logit_softcap)
    H = q.shape[2]
    return combine_partials_reference(part_o, part_ml, q.shape[1],
                                      H // k.shape[2], sinks=sinks)


class FlashArgs(ctypes.Structure):
    """The kernels' argument block (``csrc/flash_args.cuh::FlashArgs``):
    device pointers, sizes, options and strides in elements; the page-table
    fields are set for a paged arena only."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "out", "k_scale", "v_scale", "q_offset", "kv_len",
            "sinks", "kv_slot")]
        + [(n, ctypes.c_int) for n in ("T", "G", "S", "window", "chunked")]
        + [("softcap", ctypes.c_float), ("scale", ctypes.c_float)]
        + [(n, ctypes.c_longlong) for n in (
            "qb", "qt", "qh", "kb", "kh", "ks", "vb", "vh", "vs", "ob", "ot",
            "oh", "ksb", "kss", "vsb", "vss")]
        + [("page_table", ctypes.c_void_p)]
        + [(n, ctypes.c_int) for n in ("NP", "P", "page", "box")])


HEAD_DIMS = (64, 96, 128, 256)
_entry_points = {}


def load_entry(source: str, symbol: str):
    """The C entry point ``symbol`` of ``csrc/<source>.cu`` (built at first
    use), taking ``(FlashArgs*, B, H, H_kv, D, stream)``."""
    fn = _entry_points.get(symbol)
    if fn is None:
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = ([ctypes.POINTER(FlashArgs)] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entry_points[symbol] = fn
    return fn


def _check_cuda_args(q, k, v, q_offset, kv_len, B, Hkv, S,
                     kv_dtype=torch.bfloat16, head_dims=HEAD_DIMS,
                     pool_rows=False):
    """Raise on what the kernels do not take. ``kv_dtype``: bfloat16 or int8
    K/V; ``pool_rows``: K/V carry a whole pool (``kv_slot``), so their batch
    need not be q's."""
    dev = q.device
    for name, t in (("k", k), ("v", v), ("q_offset", q_offset),
                    ("kv_len", kv_len)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t, dt in (("q", q, torch.bfloat16), ("k", k, kv_dtype),
                        ("v", v, kv_dtype)):
        if t.dtype != dt:
            raise ValueError(f"the CUDA kernel takes {name} as "
                             f"{str(dt).split('.')[-1]}; it is {t.dtype}")
        # 16-byte vector loads along D; TMA takes 16-byte aligned bases and
        # strides that are multiples of 16 bytes
        vec = 16 // t.element_size()
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(f"{name} needs unit stride along D and the "
                             f"other strides a multiple of {vec}: "
                             f"{t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    H, D = q.shape[2], q.shape[3]
    if (k.shape[0] != B and not pool_rows) or k.shape[3] != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if D not in head_dims:
        raise ValueError(f"head dim {D} not supported {head_dims}")
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [{B}]")


def check_options(q, sliding_window, window_kind, logit_softcap, sinks,
                  kv_slot, kv_head_major):
    """Raise on option values no implementation takes (CPU or CUDA)."""
    B, _, H, _ = q.shape
    if window_kind not in ("sliding", "chunked"):
        raise ValueError(f"unknown window_kind {window_kind!r}")
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError(f"sliding_window must be positive: {sliding_window}")
    if logit_softcap is not None and logit_softcap <= 0:
        raise ValueError(f"logit_softcap must be positive: {logit_softcap}")
    if sinks is not None and tuple(sinks.shape) != (H,):
        raise ValueError(f"sinks must be [{H}]: {tuple(sinks.shape)}")
    if kv_slot is not None:
        if B != 1 or not kv_head_major:
            raise ValueError("kv_slot requires B == 1 and kv_head_major")
        if tuple(kv_slot.shape) != (1,):
            raise ValueError(f"kv_slot must be [1]: {tuple(kv_slot.shape)}")


def fill_args(q, k, v, out, q_offset, kv_len, kv_head_major, sm_scale,
              sliding_window=None, window_kind="sliding", logit_softcap=None,
              sinks=None, kv_slot=None, k_scale=None, v_scale=None):
    """The argument block of one launch, after the option tensors were
    checked against q's device (sinks fp32 [H], kv_slot int32 [1], scales
    fp32 [B, S], all read in place)."""
    B, T, H, D = q.shape
    if kv_head_major:
        Hkv, S = k.shape[1], k.shape[2]
        ks = (k.stride(0), k.stride(1), k.stride(2))
        vs = (v.stride(0), v.stride(1), v.stride(2))
    else:
        S, Hkv = k.shape[1], k.shape[2]
        ks = (k.stride(0), k.stride(2), k.stride(1))
        vs = (v.stride(0), v.stride(2), v.stride(1))
    for name, t, dt, shape in (("sinks", sinks, torch.float32, (H,)),
                               ("kv_slot", kv_slot, torch.int32, (1,))):
        if t is None:
            continue
        if (t.device != q.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"the CUDA kernel takes {name} as contiguous "
                             f"{str(dt).split('.')[-1]} {list(shape)} on "
                             f"{q.device}")
    a = FlashArgs()
    a.q, a.k, a.v, a.out = (t.data_ptr() for t in (q, k, v, out))
    a.q_offset, a.kv_len = q_offset.data_ptr(), kv_len.data_ptr()
    a.sinks = sinks.data_ptr() if sinks is not None else None
    a.kv_slot = kv_slot.data_ptr() if kv_slot is not None else None
    a.T, a.G, a.S = T, H // Hkv, S
    a.window = sliding_window or 0
    a.chunked = int(window_kind == "chunked")
    a.softcap = logit_softcap or 0.0
    a.scale = sm_scale if sm_scale is not None else 1.0 / (D**0.5)
    a.qb, a.qt, a.qh = q.stride(0), q.stride(1), q.stride(2)
    a.kb, a.kh, a.ks = ks
    a.vb, a.vh, a.vs = vs
    a.ob, a.ot, a.oh = out.stride(0), out.stride(1), out.stride(2)
    if k_scale is not None:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (t.device != q.device or t.dtype != torch.float32
                    or tuple(t.shape) != (k.shape[0], S)):
                raise ValueError(
                    f"the CUDA kernel takes {name} as float32 "
                    f"[{k.shape[0]}, {S}] on {q.device}: {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
        a.k_scale, a.v_scale = k_scale.data_ptr(), v_scale.data_ptr()
        a.ksb, a.kss = k_scale.stride()
        a.vsb, a.vss = v_scale.stride()
    return a, Hkv, S


def count_launch(wrapper, T, a=None):
    """Add one to ``wrapper.launches`` under the phase ("prefill" for
    T > 1, "decode" for T == 1), with "+window", "+softcap" and "+sinks"
    appended where the argument block ``a`` sets those options."""
    phase = "decode" if T == 1 else "prefill"
    if a is not None:
        phase += "+window" if a.window > 0 else ""
        phase += "+softcap" if a.softcap > 0 else ""
        phase += "+sinks" if a.sinks else ""
    wrapper.launches[phase] += 1


def check_error(wrapper, err):
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                           f"cudaError {err}")


def launch(wrapper, fn, a, q, Hkv):
    """Launch ``fn`` on q's current stream, raise if the launch is refused,
    and count it (:func:`count_launch`)."""
    B, T, H, D = q.shape
    check_error(wrapper, fn(ctypes.byref(a), B, H, Hkv, D,
                            torch.cuda.current_stream(q.device).cuda_stream))
    count_launch(wrapper, T, a)


def split_entry(source: str, symbol: str):
    """The key-split decode's first kernel ``symbol`` of ``csrc/<source>.cu``
    (built at first use), taking ``(FlashArgs*, B, H, H_kv, D, part_o,
    part_ml, nsplit, stream)``; raises where the source splits the keys
    otherwise than ``SPLIT_KEYS``."""
    fn = _entry_points.get(symbol)
    if fn is None:
        lib = _build.load(source)
        if lib.lmc_flash_split_keys() != SPLIT_KEYS:
            raise RuntimeError(f"csrc/{source}.cu splits the keys otherwise "
                               f"than SPLIT_KEYS")
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.POINTER(FlashArgs)] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                  ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entry_points[symbol] = fn
    return fn


def _combine_entry():
    """The combine kernel of ``csrc/flash_attention.cu``, built at first
    use."""
    fn = _entry_points.get("combine")
    if fn is None:
        fn = _build.load("flash_attention").lmc_flash_combine_partials
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entry_points["combine"] = fn
    return fn


def combine_partials(part_o: torch.Tensor, part_ml: torch.Tensor, T: int,
                     G: int, *, sinks: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The key-split decode's combine (see
    :func:`combine_partials_reference` for the shapes): bf16
    ``[B, T, H, D]``. On CUDA tensors this launches the combine kernel of
    ``csrc/flash_attention.cu`` (fp32 contiguous partials, sinks fp32 [H])
    and raises on anything it does not take; on CPU tensors it computes
    :func:`combine_partials_reference`. ``combine_partials.launches`` counts
    launches by phase, as :func:`flash_attention`'s."""
    B, Hkv, n, R, D = part_o.shape
    if R != T * G or tuple(part_ml.shape) != (B, Hkv, n, R, 2):
        raise ValueError(f"partials {tuple(part_o.shape)} and "
                         f"{tuple(part_ml.shape)} do not hold T {T} x G {G} "
                         f"rows")
    if part_o.device.type == "cpu":
        return combine_partials_reference(part_o, part_ml, T, G,
                                          sinks=sinks).to(torch.bfloat16)
    for name, t in (("part_o", part_o), ("part_ml", part_ml)):
        if (t.device != part_o.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"the CUDA kernel takes {name} as contiguous "
                             f"float32 on {part_o.device}")
    if sinks is not None and (
            sinks.device != part_o.device or sinks.dtype != torch.float32
            or tuple(sinks.shape) != (Hkv * G,) or not sinks.is_contiguous()):
        raise ValueError(f"the CUDA kernel takes sinks as contiguous float32 "
                         f"[{Hkv * G}] on {part_o.device}")
    out = torch.empty((B, T, Hkv * G, D), dtype=torch.bfloat16,
                      device=part_o.device)
    _combine(part_o, part_ml, T, G, sinks, out)
    return out


def _combine(part_o, part_ml, T, G, sinks, out):
    """Launch the combine kernel on arguments already checked, and count
    it under :func:`combine_partials`."""
    B, Hkv, n, _, D = part_o.shape
    check_error(combine_partials, _combine_entry()(
        part_o.data_ptr(), part_ml.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, out.data_ptr(), B,
        T, G, Hkv, D, n, out.stride(0), out.stride(1), out.stride(2),
        torch.cuda.current_stream(part_o.device).cuda_stream))
    count_launch(combine_partials, T)


combine_partials.launches = Counter()


def split_decode(wrapper, split, a, q, Hkv, S, sinks, out):
    """The key-split decode of a launch of at most ``DECODE_ROWS`` rows
    (arguments checked and ``a`` filled): ``split`` (a :func:`split_entry`)
    writes the partials into one fp32 scratch allocation, then
    :func:`combine_partials`' kernel writes ``out``; counted once under
    ``wrapper`` (and once under ``combine_partials``)."""
    B, T, H, D = q.shape
    G = H // Hkv
    n = n_splits(S)
    # one scratch allocation: the partials' O, then their (m, l)
    rows = B * Hkv * n * T * G
    scratch = torch.empty(rows * (D + 2), dtype=torch.float32,
                          device=q.device)
    part_o = scratch[:rows * D].view(B, Hkv, n, T * G, D)
    part_ml = scratch[rows * D:].view(B, Hkv, n, T * G, 2)
    check_error(wrapper, split(
        ctypes.byref(a), B, H, Hkv, D, part_o.data_ptr(), part_ml.data_ptr(),
        n, torch.cuda.current_stream(q.device).cuda_stream))
    _combine(part_o, part_ml, T, G, sinks, out)
    count_launch(wrapper, T, a)


def slot_row(t, kv_slot):
    """Row ``kv_slot[0]`` of a pool tensor, for the plain versions."""
    slot = int(kv_slot[0])
    return t[slot:slot + 1]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: torch.Tensor, kv_len: torch.Tensor, *,
                    kv_head_major: bool = False,
                    sm_scale: Optional[float] = None,
                    sliding_window: Optional[int] = None,
                    window_kind: str = "sliding",
                    logit_softcap: Optional[float] = None,
                    sinks: Optional[torch.Tensor] = None,
                    kv_slot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal GQA flash attention; see the module docstring for shapes and
    :func:`mha_reference` for ``sliding_window``, ``window_kind``,
    ``logit_softcap`` and ``sinks`` ([H] fp32).

    ``kv_slot`` (int32 [1]): K/V carry the whole serving pool and the one
    sequence (B == 1, head-major) attends to pool row ``kv_slot[0]``, which
    the kernel reads on the device.

    On CUDA tensors this launches the Hopper kernels (bf16 q/k/v, int32
    ``q_offset``/``kv_len``, D of 64, 96, 128 or 256, base pointers
    16-byte aligned and strides multiples of 8 elements with unit stride
    along D, as TMA takes them) and raises on anything they do not take:
    the prefill body above ``DECODE_ROWS`` rows (T * G), else the key-split
    decode and :func:`combine_partials`. On CPU tensors it computes
    :func:`mha_reference`. ``flash_attention.launches`` counts launches by
    phase ("prefill" for T > 1, "decode" for T == 1, "+window",
    "+softcap" and "+sinks" appended under those options); a split decode
    counts once.
    """
    check_options(q, sliding_window, window_kind, logit_softcap, sinks,
                  kv_slot, kv_head_major)
    if q.device.type == "cpu":
        if kv_slot is not None:
            k, v = slot_row(k, kv_slot), slot_row(v, kv_slot)
        if kv_head_major:
            k, v = k.transpose(1, 2), v.transpose(1, 2)
        return mha_reference(q, k, v, q_offset, kv_len, sm_scale=sm_scale,
                             sliding_window=sliding_window,
                             window_kind=window_kind,
                             logit_softcap=logit_softcap, sinks=sinks)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    a, Hkv, S = fill_args(q, k, v, out, q_offset, kv_len, kv_head_major,
                          sm_scale, sliding_window, window_kind,
                          logit_softcap, sinks, kv_slot)
    _check_cuda_args(q, k, v, q_offset, kv_len, B, Hkv, S,
                     pool_rows=kv_slot is not None)
    G = H // Hkv
    if T * G > DECODE_ROWS:
        launch(flash_attention,
               load_entry("flash_attention", "lmc_flash_attention_bf16"), a,
               q, Hkv)
        return out
    split_decode(flash_attention,
                 split_entry("flash_attention", "lmc_flash_decode_split_bf16"),
                 a, q, Hkv, S, sinks, out)
    return out


flash_attention.launches = Counter()


def flash_attention_dma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: torch.Tensor, kv_len: torch.Tensor, *,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention` (head-major ``k/v [B, H_kv, S, D]``, causal,
    windowless) with K/V streamed through a ring of asynchronous copies:
    the counterpart of the JAX package's ``flash_attention_dma``, for large
    prefills. Same results as :func:`flash_attention` on the same inputs.

    On CUDA tensors this launches its own Hopper kernel
    (``csrc/flash_stream_attention.cu``; bf16, D of 64, 96 or 128) and
    raises on anything it does not take; on CPU tensors it computes
    :func:`mha_reference`. No serving path calls it (none does in the JAX
    package). ``flash_attention_dma.launches`` counts launches by phase."""
    if q.device.type == "cpu":
        return mha_reference(q, k.transpose(1, 2), v.transpose(1, 2),
                             q_offset, kv_len, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    a, Hkv, S = fill_args(q, k, v, out, q_offset, kv_len, True, sm_scale)
    _check_cuda_args(q, k, v, q_offset, kv_len, B, Hkv, S,
                     head_dims=(64, 96, 128))
    launch(flash_attention_dma,
           load_entry("flash_stream_attention",
                      "lmc_flash_stream_attention_bf16"), a, q, Hkv)
    return out


flash_attention_dma.launches = Counter()
