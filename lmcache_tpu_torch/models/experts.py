"""The routed-expert dispatch shared by the MoE models of the port
(``models/llama.py``: Mixtral, Qwen3-MoE, GPT-OSS, Llama-4; ``models/mla.py``:
DeepSeek-V2/V3).

The JAX package runs every expert on every token and weights the unselected
ones by exactly 0 (a ``lax.scan`` over the stacked expert weights). Here
each (token, expert) pair that the router picked is scattered into its
expert's block of rows, the blocks padded to one height, and each expert
weight runs as one batched product over the blocks (``torch.bmm``): the same
function, with the work of the routed pairs only. The padded rows are zero
and never read back.
"""

import torch

# every expert's block of routed rows is padded to the same multiple of this:
# one batched product a weight over all experts (a few launches a layer
# whatever the tokens), and a token's product does not depend on how many
# other tokens share its expert, since a decode step's 1 to 4 rows an expert
# all pad to one shape (the GEMM library picks its kernel, and its order of
# summation, by the row count)
EXPERT_ROWS = 16


def dispatch(hf: torch.Tensor, topi: torch.Tensor, n_experts: int,
             scale: "torch.Tensor | None" = None):
    """Scatter tokens ``hf [N, dim]`` routed to experts ``topi [N, k]`` into
    per-expert blocks of M rows (M the largest block, rounded up to
    ``EXPERT_ROWS``; zero rows elsewhere), tokens in order within a block.
    ``scale [N, k]`` multiplies each pair's row in fp32 before the cast back
    to ``hf``'s dtype (Llama-4 scales the expert input by its gate).

    Returns ``(x [E, M, dim], slot [N * k])``: pair ``i`` (token ``i // k``,
    its ``i % k``-th expert) lies in row ``slot[i]`` of ``x.view(E * M,
    dim)``."""
    N, k = topi.shape
    E = n_experts
    flat = topi.reshape(-1)
    # counted and repeated without reading anything back to the host (CUDA's
    # bincount and repeat_interleave size their outputs by a host sync)
    counts = torch.zeros(E, dtype=torch.long, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    # a token's k experts are distinct, so no block holds more than N rows:
    # a decode step pads to EXPERT_ROWS without reading the counts back
    M = EXPERT_ROWS if N <= EXPERT_ROWS else (
        -(-int(counts.max()) // EXPERT_ROWS) * EXPERT_ROWS)
    # each pair's row within its expert's block, tokens in order
    order = torch.argsort(flat, stable=True)
    first = torch.cumsum(counts, 0) - counts
    row = torch.empty_like(flat)
    row[order] = torch.arange(N * k, device=flat.device) - first[flat[order]]
    slot = flat * M + row
    x = hf.new_zeros((E * M, hf.shape[1]))
    rows = hf[:, None].expand(N, k, hf.shape[1]).reshape(N * k, -1)
    if scale is not None:
        rows = (rows.float() * scale.reshape(-1, 1)).to(hf.dtype)
    x[slot] = rows
    return x.view(E, M, -1), slot


def gather(y: torch.Tensor, slot: torch.Tensor, k: int) -> torch.Tensor:
    """The pairs' rows of the experts' output ``y [E, M, d]``, as
    ``[N, k, d]`` in ``y``'s dtype (:func:`dispatch`'s ``slot``)."""
    return y.reshape(-1, y.shape[-1])[slot].view(-1, k, y.shape[-1])
