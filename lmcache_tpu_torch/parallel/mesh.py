"""Mesh construction and sharding rules over ``torch.distributed``: the port
of ``lmcache_tpu/parallel/mesh.py``.

The JAX package's mesh is single-controller: one process drives every
device, arrays carry a ``NamedSharding`` and XLA inserts the collectives.
The port follows PyTorch's idiom instead:

- one process per rank, in a ``torch.distributed`` process group that the
  caller initializes (``init_process_group`` with its own address, world
  size and rank);
- the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the JAX
  mesh's two dims, ``("data", "model")``: rank ``r`` sits at ``(r // model,
  r % model)``;
- each rank holds only its own slices (:func:`shard_params`, the local pools
  of :func:`local_shape`, which the allocators build), and the collectives are written out
  (:class:`Axis`);
- every rank runs the same scheduler over the same requests: the counterpart
  of the single controller's one loop.

``"model"`` is tensor parallelism (attention heads and MLP hidden columns;
the KV pool's head axis, which ``LMCacheEngineMetadata.kv_shard_axis``
names), ``"data"`` splits batch rows. A mesh made for ``"cuda"`` runs over
NCCL and raises without it; a ``"cpu"`` mesh runs over gloo.
"""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from lmcache_tpu_torch.utils import resolve_device

AXES = ("data", "model")
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1

    @property
    def world_size(self) -> int:
        return self.data * self.model


def make_mesh(cfg: Optional[MeshConfig] = None, device="cuda"):
    """The ``("data", "model")`` ``DeviceMesh`` over the initialized process
    group, which must hold exactly ``cfg.world_size`` ranks (default: every
    rank on "model", tensor parallelism first, as in the JAX package).
    ``device="cuda"`` needs CUDA and an NCCL process group, ``"cpu"`` a gloo
    one: a mesh never carries on over another backend than its device's."""
    dev = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group (init_process_group)")
    backend = dist.get_backend()
    if backend != _BACKENDS[dev.type]:
        raise RuntimeError(
            f"a mesh on {dev.type!r} runs over {_BACKENDS[dev.type]}, but "
            f"the process group's backend is {backend!r}")
    world = dist.get_world_size()
    if cfg is None:
        cfg = MeshConfig(data=1, model=world)
    if cfg.world_size != world:
        raise ValueError(f"mesh {cfg} needs {cfg.world_size} ranks, the "
                         f"process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (cfg.data, cfg.model),
                            mesh_dim_names=AXES)


class Axis:
    """One mesh axis as this rank sees it: ``size``, this rank's ``index``
    on it and the collectives over its group, written out. On an axis of
    size 1 (or without a mesh) every collective returns its input as it is,
    so a one-rank mesh computes what no mesh computes, bit for bit."""

    def __init__(self, mesh=None, name: str = "model"):
        if mesh is None:
            self.size, self.index, self.group = 1, 0, None
            return
        dim = mesh.mesh_dim_names.index(name)
        self.size = mesh.size(dim)
        self.index = mesh.get_local_rank(name)
        self.group = mesh.get_group(name)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the axis, in fp32, returned in ``x``'s dtype
        (the partial outputs of a row-parallel product)."""
        if self.size == 1:
            return x
        y = x.float().contiguous()
        dist.all_reduce(y, group=self.group)
        return y.to(x.dtype)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in axis order."""
        if self.size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """The ``x`` of the rank at index ``src`` on every rank (in place)."""
        if self.size == 1:
            return x
        dist.broadcast(x, group=self.group,
                       src=dist.get_global_rank(self.group, src))
        return x

    def peer(self, index: int) -> int:
        """The global rank of the axis member at ``index`` (mod size)."""
        return dist.get_global_rank(self.group, index % self.size)


def axis(mesh, name: str = "model") -> Axis:
    """:class:`Axis` ``name`` of ``mesh`` (None: the one-rank axis)."""
    return Axis(mesh, name)


# the tensor-parallel rules of the JAX package's shard_params, by leaf name:
# stacked [L, in, out] weights (experts [L, E, in, out]) column-parallel on
# the last axis, row-parallel on the second-to-last, MLA's absorbed kv_b
# factors [L, H, ., .] on their head axis
COLUMN = frozenset({"wq", "wk", "wv", "w_gate", "w_up", "e_gate", "e_up",
                    "wq_b", "s_gate", "s_up"})
ROW = frozenset({"wo", "w_down", "e_down", "s_down"})
HEAD = frozenset({"w_kb_k", "w_kb_v"})
# what the JAX package replicates and GSPMD reshards where it is used; an
# explicit slice has to follow the columns it is added to: the biases of
# the column-parallel products, and the per-head sinks [L, H] that follow
# the query heads. A row-parallel product's bias (e_bd, bo) stays whole and
# is added once, after the sum; per-head q/k norms stay whole, and so do
# the flat ones, which the forward slices itself (it needs the whole width)
FOLLOW_COLUMNS = frozenset({"bq", "bk", "bv", "e_bg", "e_bu", "sinks"})


def shard_axis(name: str, ndim: int) -> Optional[int]:
    """The axis of leaf ``name`` (of rank ``ndim``) that "model" splits, or
    None where the leaf is replicated."""
    if name in COLUMN or name in FOLLOW_COLUMNS:
        return ndim - 1
    if name in ROW:
        return ndim - 2
    if name in HEAD:
        return 1
    return None


def take_slice(x: torch.Tensor, dim: int, index: int, parts: int,
               name: str = "tensor") -> torch.Tensor:
    """Part ``index`` of ``parts`` equal parts of ``x`` along ``dim`` (a
    view); raises where the axis does not divide."""
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f"{name}: axis {dim} of {n} does not divide the "
                         f"mesh's model axis ({parts})")
    per = n // parts
    return x.narrow(dim, index * per, per)


def shard_params(params, mesh):
    """This rank's slices of a parameter tree (the llama or the MLA tree of
    the port, as the JAX ``shard_params`` names its leaves): each
    "model"-sharded leaf cut to this rank's part as a contiguous copy, so
    the whole tensor can be freed; replicated leaves returned as they
    are."""
    tp = axis(mesh, "model")

    def place(name, x):
        if isinstance(x, dict):
            return {k: place(k, v) for k, v in x.items()}
        dim = shard_axis(name, x.ndim)
        if dim is None or tp.size == 1:
            return x
        return take_slice(x, dim, tp.index, tp.size, name).contiguous()

    return {k: place(k, v) for k, v in params.items()}


# the JAX package's PartitionSpecs of the live pools and the wire blobs, one
# mesh axis name (or None) a dim
def kv_cache_sharding(mesh=None) -> Tuple[Optional[str], ...]:
    """The head-major KV pool [L, 2, B, H_kv, S, D]: batch on "data", kv
    heads on "model" (the per-worker key shards of the reference)."""
    return (None, None, "data", "model", None, None)


def latent_cache_sharding(mesh=None) -> Tuple[Optional[str], ...]:
    """The MLA latent pool [L, B, S, r + p]: batch on "data", replicated over
    "model" (the latent has no head axis)."""
    return (None, "data", None, None)


def paged_kv_sharding(mesh=None) -> Tuple[Optional[str], ...]:
    """The head-major page arena [L, 2, P, H_kv, page, D]: kv heads on
    "model", replicated over "data" (pages are the cross-request resource;
    the JAX paged engine's spec)."""
    return (None, None, None, "model", None, None)


def kv_blob_sharding(mesh=None, fmt: str = "vllm"
                     ) -> Tuple[Optional[str], ...]:
    """A cache blob [L, 2, T, H, D] (vllm) / [L, 2, H, T, D] (huggingface):
    heads on "model"."""
    if fmt == "vllm":
        return (None, None, None, "model", None)
    return (None, None, "model", None, None)


def local_shape(shape: Sequence[int], spec: Sequence[Optional[str]],
                mesh) -> Tuple[int, ...]:
    """The shape of this rank's block of a ``shape`` array laid out by
    ``spec``. A sharded dim that does not divide its axis stays whole on
    every rank, as the JAX package replicates a batch that does not divide
    "data" and gathers kv heads that do not divide "model"."""
    out = []
    for n, name in zip(shape, spec):
        size = 1 if name is None or mesh is None else axis(mesh, name).size
        out.append(n // size if n % size == 0 else n)
    return tuple(out)


def data_rows(batch: int, local_batch: int, mesh) -> Optional[slice]:
    """The rows of a ``batch``-row step that this rank computes when its
    pool holds ``local_batch`` rows: None where the pool holds every row
    (no mesh, "data" of size 1, or a batch that "data" does not split, which
    every data rank computes, as the JAX package replicates a batch that
    does not divide), else this rank's contiguous share of the rows."""
    dp = axis(mesh, "data")
    if local_batch == batch:
        return None
    if dp.size > 1 and batch % dp.size == 0 \
            and local_batch == batch // dp.size:
        return slice(dp.index * local_batch, (dp.index + 1) * local_batch)
    raise ValueError(f"a pool of {local_batch} rows holds neither the "
                     f"{batch} rows of the step nor their share of the "
                     f"mesh's data axis ({dp.size})")


def shard_blob_slice(blob, fmt: str, shard_idx: int, num_shards: int):
    """The head slice of a blob owned by tensor-parallel shard
    ``shard_idx``: the unit each worker stores and retrieves under its own
    ``worker_id`` key namespace (reference: per-worker keys,
    lmcache/cache_engine.py:37-44; here worker == the mesh's "model"
    index). Works on numpy arrays and torch tensors."""
    head_axis = 3 if fmt == "vllm" else 2
    H = blob.shape[head_axis]
    if H % num_shards:
        raise ValueError(f"{H} heads not divisible by {num_shards} shards")
    per = H // num_shards
    idx = [slice(None)] * blob.ndim
    idx[head_axis] = slice(shard_idx * per, (shard_idx + 1) * per)
    return blob[tuple(idx)]


def shard_metadata(meta, mesh):
    """``meta`` (``LMCacheEngineMetadata``) for this rank's head slice:
    ``world_size`` the size and ``worker_id`` this rank's index on the
    metadata's ``kv_shard_axis``."""
    import dataclasses
    ax = axis(mesh, meta.kv_shard_axis)
    return dataclasses.replace(meta, world_size=ax.size, worker_id=ax.index)

