"""The 1-D data group over torch.distributed (twin of avatarclip_tpu/parallel/mesh.py).

JAX's ``data`` mesh replicates the parameters, shards the ray batch on its
leading axis and lets XLA insert the gradient psum. Here each of N processes
(ranks) holds the whole parameter set and the whole step's host state, draws
every random number of the step for the whole batch (the same seeded
generators on every rank), renders its equal slice of the rays, gathers the
per-ray outputs, and computes the loss replicated; the parameter gradients
are then summed over the ranks by one all-reduce before Adam, so every rank
applies the same bytes. With one rank (``single``) nothing here is called
and the numbers are a run's without a mesh.

Backends are chosen, never switched: NCCL when every rank has a card of its
own; gloo when the caller asks for it (the CPU, or several ranks sharing one
card, which NCCL refuses). More ranks on a host than cards without gloo
raises. Under gloo a CUDA tensor goes through the host for each collective.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Iterable

import torch
import torch.distributed as dist

from ..utils import device as device_mod

# Padded rays (JAX's point_eval_fused_ray, avatarclip_tpu/ops/fused_neus.py:
# 1200-1208): |o| = 10, outside the relaxed sphere, so their eikonal terms are
# zero; d = 0; their outputs are sliced off after the gather, so their
# cotangents are zero.
PAD_ORIGIN = (10.0, 0.0, 0.0)

# How long a collective waits for the other ranks before the group fails.
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the data group (the default process group): its
    rank, the group's size, its device and the backend (None: one rank, no
    process group)."""

    rank: int
    size: int
    device: torch.device
    backend: str | None = None

    @property
    def writer(self) -> bool:
        """Rank 0 writes the logs, checkpoints and validations."""
        return self.rank == 0


def single(device=None) -> DataMesh:
    """One rank and no process group on ``device`` (the card unless the
    caller asks for the CPU)."""
    return DataMesh(0, 1, device_mod.resolve(device, "DataMesh"))


def rank_device(device, backend: str, local_rank: int, local_size: int) -> torch.device:
    """The device of the rank ``local_rank`` of ``local_size`` on this host:
    ``device`` as given when it names an index or the CPU; else card
    ``local_rank`` under NCCL (which needs a card a rank: more ranks than
    cards raise), card ``local_rank % cards`` under gloo."""
    dev = device_mod.resolve(device, "DataMesh")
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: the CPU takes backend='gloo'")
        return dev
    if dev.index is not None:
        return dev
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_size > cards:
        raise ValueError(f"{local_size} ranks on {cards} card(s): NCCL needs a card a rank; "
                         "pass backend='gloo' to share cards")
    return torch.device("cuda", local_rank % cards)


def init(size: int, rank: int, device=None, backend: str | None = None,
         init_method: str = "env://", local_rank: int | None = None,
         local_size: int | None = None) -> DataMesh:
    """Create (joining the other ranks) the default process group of
    ``size`` ranks as ``rank`` and return this rank's mesh. ``backend``:
    "nccl" (the default on the card) or "gloo" (the default and the only
    choice on the CPU). ``local_rank`` / ``local_size`` place the rank among
    its host's (default: ``rank`` of ``size``)."""
    dev0 = device_mod.resolve(device, "DataMesh")
    backend = backend or ("gloo" if dev0.type == "cpu" else "nccl")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dev = rank_device(device, backend, rank if local_rank is None else local_rank,
                      size if local_size is None else local_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank,
                            timeout=TIMEOUT)
    return DataMesh(rank, size, dev, backend)


def from_env(device=None, backend: str | None = None) -> DataMesh:
    """The mesh of a process that ``torchrun`` started (WORLD_SIZE, RANK,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the
    environment); ``single(device)`` when WORLD_SIZE is 1 or unset."""
    size = int(os.environ.get("WORLD_SIZE", "1"))
    if size <= 1:
        return single(device)
    return init(size, int(os.environ["RANK"]), device, backend,
                local_rank=int(os.environ.get("LOCAL_RANK", os.environ["RANK"])),
                local_size=int(os.environ.get("LOCAL_WORLD_SIZE", size)))


def close(mesh: DataMesh) -> None:
    """Leave the process group (nothing for one rank)."""
    if mesh.size > 1 and dist.is_initialized():
        dist.destroy_process_group()


def pad_to_multiple(n: int, mesh=None, granule: int = 8) -> int:
    """Round a batch size up so it divides evenly across the mesh (any
    object with ``.size``; None is one rank), in whole granules a rank."""
    m = (1 if mesh is None else mesh.size) * granule
    return ((n + m - 1) // m) * m


def shard(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """This rank's equal slice of the leading axis."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split evenly over {mesh.size} ranks")
    k = n // mesh.size
    return x[mesh.rank * k:(mesh.rank + 1) * k]


# -- collectives -----------------------------------------------------------


def _host(mesh: DataMesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective takes: gloo's copy on the host for a CUDA
    tensor, else the tensor itself."""
    return t.cpu() if mesh.backend == "gloo" and t.is_cuda else t


def all_gather(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The ranks' x concatenated on the leading axis in rank order."""
    xs = _host(mesh, x.detach().contiguous())
    parts = [torch.empty_like(xs) for _ in range(mesh.size)]
    dist.all_gather(parts, xs)
    return torch.cat(parts).to(x.device)


def all_reduce_(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Sum t over the ranks in place (every rank gets the same bytes)."""
    h = _host(mesh, t)
    dist.all_reduce(h)
    if h is not t:
        t.copy_(h)
    return t


def barrier(mesh: DataMesh) -> None:
    if mesh.size > 1:
        dist.barrier()


class _Gather(torch.autograd.Function):
    """Forward: the ranks' slices concatenated. Backward: this rank's slice
    of the cotangent alone. A loss that every rank computes the same way
    from the gathered tensor has the same cotangent on every rank, and each
    rank's slice carries its own rows' share; reduce-scattering it (what
    torch.distributed.nn.all_gather does) would count it N times."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        r, k = ctx.mesh.rank, ctx.rows
        return g[r * k:(r + 1) * k].contiguous(), None


class _Sum(torch.autograd.Function):
    """Forward: x summed over the ranks. Backward: the cotangent as it is
    (each rank's x adds to the sum with weight one)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(x.detach().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """Forward: x. Backward: the cotangent over N: x is a function of the
    parameters alone, the same on every rank, so each rank's share of its
    gradient is 1/N of it (the all-reduce adds the N shares back)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.n = mesh.size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def gather(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The ranks' x concatenated on the leading axis, differentiable (see
    _Gather)."""
    return x if mesh.size == 1 else _Gather.apply(x, mesh)


def sum_over_ranks(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """x summed over the ranks, differentiable (JAX's psum)."""
    return x if mesh.size == 1 else _Sum.apply(x, mesh)


def replicated(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """x, a function of the replicated parameters alone, with its gradient
    shared out over the ranks (see _Replicated)."""
    return x if mesh.size == 1 else _Replicated.apply(x, mesh)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], mesh: DataMesh) -> None:
    """Sum the parameters' gradients over the ranks, in place, through one
    flat f32 buffer. Every rank runs the same graph, so the same parameters
    have gradients on every rank."""
    if mesh.size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce_(flat, mesh)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def broadcast_(tensors: Iterable[torch.Tensor], mesh: DataMesh) -> None:
    """Overwrite the tensors with rank 0's, through one flat f32 buffer (the
    replicas start from the same bytes)."""
    if mesh.size == 1:
        return
    ts = list(tensors)
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1).float() for t in ts])
        h = _host(mesh, flat)
        dist.broadcast(h, 0)
        off = 0
        for t in ts:
            t.copy_(h[off:off + t.numel()].view_as(t).to(t.device, t.dtype))
            off += t.numel()


# -- sharded rays ------------------------------------------------------------


def shard_rays(mesh: DataMesh, n_rays: int, *rows):
    """Each ``(tensor, pad)`` of ``rows`` has n_rays leading rows: padded to
    pad_to_multiple(n_rays, mesh) rows of ``pad`` (a number, or a row such
    as PAD_ORIGIN) and cut to this rank's equal slice. A None tensor stays
    None."""
    rp = pad_to_multiple(n_rays, mesh)
    out = []
    for t, pad in rows:
        if t is None:
            out.append(None)
            continue
        if t.shape[0] != n_rays:
            raise ValueError(f"a sharded input has {t.shape[0]} rows, not {n_rays}")
        if rp > n_rays:
            fill = t.new_empty((rp - n_rays,) + tuple(t.shape[1:]))
            fill[:] = torch.as_tensor(pad, dtype=t.dtype, device=t.device)
            t = torch.cat([t, fill])
        out.append(shard(t, mesh))
    return out


def gather_rays(x: torch.Tensor, mesh: DataMesh, n_rays: int) -> torch.Tensor:
    """The ranks' per-ray rows of x (each rank's k rays, m rows a ray)
    gathered, the padded rays' rows sliced off: (n_rays m, ...)."""
    m = x.shape[0] // (pad_to_multiple(n_rays, mesh) // mesh.size)
    return gather(x, mesh)[:n_rays * m]
