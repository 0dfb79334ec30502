"""Prefill attention ablation on the card: where row 1's time goes.

    python -m lmcache_tpu_torch.tools.bench_prefill_mfu [--small]
        [--bq N] [--bk N] [--device cuda|cpu]

The port of ``tools/bench_prefill_mfu.py``. It runs the six functions of
that tool through the port's hand-written kernels
(:mod:`lmcache_tpu_torch.ops.prefill_variants`) at its geometry, Llama-3-8B's
attention (B 1, H_kv 8, G 4, D 128, S 8192, logical blocks bq 256, bk 1024;
``--small``: H_kv 2, G 2, S 512, bq = bk = 128), so that each variant
computes the function it computes on the TPU:

- ``full``: row 1's causal function, the rebuilt production body;
- ``mxu_only``: the softmax chain removed, ``acc += bf16(s) V``;
- ``no_mask``: the mask removed (the interior-block model);
- ``pair``, ``pair_no_mask``: two key tiles a step, both QK products
  before either softmax update;
- ``pipelined``: tile j + 1's QK product issued before tile j's softmax
  and PV, which run beside it from tile j's score registers.

For each it prints the time (CUDA events, best of several runs), the
TFLOP/s and the share of the card's dense bf16 peak for the work its live
blocks need, the error against its plain version, and for ``full``,
``pair`` and ``pipelined`` the error against row 1's ``flash_attention``.
Row 1 and SDPA (flash backend, K/V expanded over the heads) are timed at
the same shape. ``--bq``/``--bk`` set the logical blocks (multiples of 64).
With ``--device cpu`` the entry points run their plain versions and no
time is taken.
"""

import argparse
import subprocess
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lmcache_tpu_torch.ops import attention as attn
from lmcache_tpu_torch.ops import prefill_variants as pv
from lmcache_tpu_torch.utils import resolve_device

# H100 SXM (NVIDIA data sheet): dense bf16 FLOP/s, HBM bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

# (name, mode, pair, pipelined), in the JAX tool's order
VARIANTS = (
    ("full", "full", False, False),
    ("mxu_only", "mxu_only", False, False),
    ("no_mask", "no_mask", False, False),
    ("pair", "full", True, False),
    ("pair_no_mask", "no_mask", True, False),
    ("pipelined", "full", False, True),
)
# the variants that compute row 1's function
ROW1_FUNCTION = ("full", "pair", "pipelined")


def geometry(small: bool) -> Dict[str, int]:
    """The JAX tool's shape and default blocks."""
    if small:
        return dict(B=1, Hkv=2, G=2, D=128, S=512, bq=128, bk=128)
    return dict(B=1, Hkv=8, G=4, D=128, S=8192, bq=256, bk=1024)


def make_inputs(geo: Dict[str, int], bq: int,
                device) -> Dict[str, torch.Tensor]:
    """The tool's inputs from seed 4, bf16 on ``device``: q token-major
    ``[B, S, H, D]`` for row 1, its head-major copy ``[B, H, Tp, D]``
    (zero-padded to a multiple of bq) for the variants, K/V
    ``[B, H_kv, S, D]``, q_offset 0 and kv_len S."""
    B, Hkv, G, D, S = (geo[n] for n in ("B", "Hkv", "G", "D", "S"))
    H = Hkv * G
    rng = np.random.default_rng(4)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device=device, dtype=torch.bfloat16)

    q, k, v = bf16((B, S, H, D)), bf16((B, Hkv, S, D)), bf16((B, Hkv, S, D))
    Tp = -(-S // bq) * bq
    qh = torch.zeros((B, H, Tp, D), dtype=torch.bfloat16, device=device)
    qh[:, :, :S] = q.transpose(1, 2)
    return {"q": q, "qh": qh, "k": k, "v": v,
            "q_offset": torch.zeros(B, dtype=torch.int32, device=device),
            "kv_len": torch.full((B,), S, dtype=torch.int32, device=device)}


def call(variant, x, bq: int, bk: int) -> torch.Tensor:
    """One run of ``variant`` through the port's entry point."""
    _, mode, pair, pipelined = variant
    args = (x["qh"], x["k"], x["v"], x["q_offset"], x["kv_len"])
    if pipelined:
        return pv.pipelined_attention(*args, bq=bq, bk=bk)
    return pv.variant_attention(*args, mode=mode, pair=pair, bq=bq, bk=bk)


def plain(variant, x, bq: int, bk: int) -> torch.Tensor:
    """The variant's plain version on the same inputs."""
    _, mode, pair, _ = variant
    return pv.variant_reference(x["qh"], x["k"], x["v"], x["q_offset"],
                                x["kv_len"], mode=mode, pair=pair, bq=bq,
                                bk=bk)


def work(variant, geo: Dict[str, int], q_offset: List[int],
         kv_len: List[int], bq: int, bk: int) -> Tuple[float, float]:
    """(operations, bytes) the variant needs on these inputs. Operations:
    4 * D per (query head, key) pair that it computes, the causal pairs for
    ``full``'s function and every key of the live blocks for the unmasked
    modes. Bytes: q, K, V and the output once each, bf16."""
    _, mode, pair, _ = variant
    B, Hkv, G, D, S = (geo[n] for n in ("B", "Hkv", "G", "D", "S"))
    H = Hkv * G
    Tp = -(-S // bq) * bq
    nkb = pv.visited_blocks(S, bk, pair)
    pairs = 0
    for b in range(B):
        if mode == "full":
            qpos = q_offset[b] + np.arange(Tp)
            pairs += int((np.minimum(qpos, kv_len[b] - 1) + 1).clip(0).sum())
        else:
            for t0 in range(0, Tp, bq):
                nlive = min((q_offset[b] + t0 + bq - 1) // bk + 1, nkb)
                pairs += bq * min(nlive * bk, S)
    flops = 4.0 * D * H * pairs
    nbytes = 2.0 * (2 * B * H * Tp * D + 2 * B * Hkv * S * D)
    return flops, nbytes


def bound_ms(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def cuda_ms(fn, iters: int = 10, trials: int = 3) -> float:
    """Best over ``trials`` of the mean device time (CUDA events) of
    ``iters`` back-to-back calls, after a warm-up call."""
    fn()
    best = float("inf")
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def row1(x) -> torch.Tensor:
    """Row 1's ``flash_attention`` on the token-major q, [B, S, H, D]."""
    return attn.flash_attention(x["q"], x["k"], x["v"], x["q_offset"],
                                x["kv_len"], kv_head_major=True)


def sdpa_flash(x, G: int):
    """SDPA with the flash backend on q [B, H, S, D] and K/V expanded over
    the heads (outside the call), causal: one library call computing row
    1's function. Returns the call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q = x["q"].transpose(1, 2).contiguous()
    k = x["k"].repeat_interleave(G, dim=1)
    v = x["v"].repeat_interleave(G, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def run():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return sdpa(q, k, v, is_causal=True)
    return run


def _speed(flops: float, ms: float) -> str:
    """TFLOP/s and the share of the card's dense bf16 peak."""
    rate = flops / (ms * 1e-3)
    return (f"{rate / 1e12:7.1f} TFLOP/s ({100 * rate / PEAK_BF16_FLOPS:5.2f}"
            f" % of peak)")


def card_line() -> str:
    """``name, power limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run(small: bool = False, bq: Optional[int] = None,
        bk: Optional[int] = None, device="cuda") -> Dict[str, object]:
    """Run every variant; returns the numbers it prints."""
    dev = resolve_device(device)
    timed = dev.type == "cuda"
    geo = geometry(small)
    bq, bk = bq or geo["bq"], bk or geo["bk"]
    G, S = geo["G"], geo["S"]
    x = make_inputs(geo, bq, dev)
    qo, kl = x["q_offset"].tolist(), x["kv_len"].tolist()
    report: Dict[str, object] = {"geometry": dict(geo, bq=bq, bk=bk),
                                 "device": str(dev)}
    if timed:
        report["card"] = card_line()
        print(f"card: {report['card']}")
    print(f"geometry B {geo['B']} H_kv {geo['Hkv']} G {G} D {geo['D']} "
          f"S {S}, bq {bq} bk {bk}, on {dev}")
    ref = row1(x)
    causal = work(VARIANTS[0], geo, qo, kl, bq, bk)
    if timed:
        t_row1 = cuda_ms(lambda: row1(x))
        t_sdpa = cuda_ms(sdpa_flash(x, G))
        report.update(row1_ms=t_row1, sdpa_ms=t_sdpa)
        for name, t in (("row 1 flash_attention", t_row1),
                        ("SDPA (flash)", t_sdpa)):
            print(f"{name:22s}: {t:8.4f} ms {_speed(causal[0], t)}")
    rows = []
    for variant in VARIANTS:
        name = variant[0]
        out = call(variant, x, bq, bk)
        want = plain(variant, x, bq, bk)
        diff = (out.float() - want.float())
        row = {"name": name,
               "max_abs_err_plain": diff.abs().max().item(),
               "rel_l2_plain": (diff.norm() / want.float().norm()).item()}
        if name in ROW1_FUNCTION:
            row["max_abs_err_row1"] = (out.transpose(1, 2)[:, :S].float()
                                       - ref.float()).abs().max().item()
        flops, nbytes = work(variant, geo, qo, kl, bq, bk)
        row["flops"], row["bytes"] = flops, nbytes
        row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
        note = (f"  max|err| vs row 1 {row['max_abs_err_row1']:.2e}"
                if "max_abs_err_row1" in row else "")
        if timed:
            t = cuda_ms(lambda: call(variant, x, bq, bk))
            row["ms"] = t
            speed = f"{t:8.4f} ms {_speed(flops, t)}"
        else:
            speed = "time not measured (CPU)"
        print(f"{name:22s}: {speed}, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); vs plain max|err| "
              f"{row['max_abs_err_plain']:.2e} rel_l2 "
              f"{row['rel_l2_plain']:.2e}{note}")
        rows.append(row)
        del out, want, diff
    report["variants"] = rows
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="the tool's small geometry (H_kv 2, G 2, S 512)")
    ap.add_argument("--bq", type=int, default=None,
                    help="logical query block, a multiple of 64")
    ap.add_argument("--bk", type=int, default=None,
                    help="logical key block, a multiple of 64")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run(args.small, args.bq, args.bk, args.device)


if __name__ == "__main__":
    main()
