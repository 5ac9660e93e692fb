"""Data-parallel mesh over a ``torch.distributed`` process group.

Counterpart of the JAX package's ``parallel/mesh.py``. There, one program
sees every device of a ``jax.sharding.Mesh`` and GSPMD inserts the
collectives; here every rank is a process of its own running the same
program (SPMD), and the collectives are explicit. A ``Mesh`` holds the
process group, the axis name ``'data'``, its size D, this rank and this
rank's device (``cuda:{rank % device_count}``, or the CPU when the caller
asks for it).

- ``shard_rows(x, mesh)``: this rank's contiguous row block of a tensor (or
  a tuple, list or dict of them) that every rank holds whole, split as
  ``torch.tensor_split`` splits (the SPMD meaning of JAX's row-sharding
  constraint);
- ``replicate(x, mesh)``: the row blocks all-gathered back into the whole;
- the collectives the data-parallel step uses: ``all_to_all`` (fixed
  capacity, equal blocks), ``all_gather_rows`` and ``all_reduce`` (sum,
  max, min).

With ``mesh=None`` or D = 1 every helper is the identity.

Transport: with NCCL, tensors on the card go to the collective directly.
With gloo, a CUDA tensor is copied to the host and back inside these
collectives and nowhere else (gloo takes host tensors; PyTorch documents
it on CUDA tensors only for ``broadcast`` and ``all_reduce``); a CPU tensor
goes directly. The compute stays on the rank's device either way. Any other
backend or backend/device pair raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch
import torch.distributed as dist

AXIS = "data"
BACKENDS = ("nccl", "gloo")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a data-parallel mesh of ``size`` ranks."""

    group: object  # torch.distributed ProcessGroup
    size: int
    rank: int
    device: torch.device
    backend: str
    axis: str = AXIS

    @property
    def host_staged(self) -> bool:
        """Whether collectives copy this rank's device tensors through the
        host (gloo with a CUDA device)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def row_range(self, n: int):
        """(start, stop) of this rank's block of ``n`` rows, as
        ``torch.tensor_split`` cuts them: the first ``n % size`` blocks
        one row longer."""
        base, extra = divmod(n, self.size)
        start = self.rank * base + min(self.rank, extra)
        return start, start + base + (self.rank < extra)

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS,
              backend: Optional[str] = None, group=None,
              device=None) -> Optional[Mesh]:
    """This rank's ``Mesh`` over an initialised process group: ``group``,
    else the default group, or a sub-group of its first ``n_devices``
    ranks (every rank of the default group must call this then; a rank
    outside the sub-group gets None). ``backend``: the group's, checked
    when given. ``device``: None for ``cuda:{rank % device_count}``, or
    'cpu'."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(init_process_group first)")
    world = dist.get_world_size()
    if group is None:
        n = world if n_devices is None else int(n_devices)
        if not 1 <= n <= world:
            raise ValueError(f"n_devices={n_devices}: the group has {world} "
                             "ranks")
        group = (dist.group.WORLD if n == world
                 else dist.new_group(list(range(n))))
        if dist.get_rank() >= n:
            return None
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    actual = str(dist.get_backend(group)).lower()
    if backend is not None and backend.lower() != actual:
        raise ValueError(f"backend={backend!r}, but the group's is "
                         f"{actual!r}")
    if actual not in BACKENDS:
        raise ValueError(f"backend {actual!r}: the mesh supports "
                         f"{BACKENDS}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass "
                               "device='cpu' for a CPU mesh)")
        device = torch.device("cuda", dist.get_rank()
                              % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if device.type not in ("cuda", "cpu") or (
            actual == "nccl" and device.type != "cuda"):
        raise ValueError(f"backend {actual!r} with device {device}: "
                         "NCCL needs a CUDA device, gloo a CUDA or CPU one")
    mesh = Mesh(group=group, size=size, rank=rank, device=device,
                backend=actual, axis=axis)
    logging.info("mesh %r: rank %d of %d on %s, %s, %s", axis, rank, size,
                 device, actual, "host-staged transport" if mesh.host_staged
                 else "direct transport")
    return mesh


def _inactive(mesh: Optional[Mesh]) -> bool:
    return mesh is None or mesh.size == 1


def _tree_map(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


def _wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` as the backend takes it: contiguous, bool as uint8, on the
    host for gloo."""
    if t.device.type != mesh.device.type:
        raise ValueError(f"tensor on {t.device}, mesh device {mesh.device}")
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if mesh.host_staged:
        t = t.cpu()
    return t.contiguous()


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(device=like.device, dtype=like.dtype)


def all_to_all(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Fixed-capacity all-to-all over the leading axis: ``x`` holds D equal
    blocks of rows, block j for rank j; returns the D blocks received,
    block j from rank j (JAX ``lax.all_to_all`` with ``tiled=True``)."""
    if _inactive(mesh):
        return x
    if x.shape[0] % mesh.size:
        raise ValueError(f"all_to_all: {x.shape[0]} rows is not D = "
                         f"{mesh.size} equal blocks")
    send = _wire(x, mesh)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    return _unwire(recv, x)


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh],
                    total: Optional[int] = None) -> torch.Tensor:
    """The whole tensor from every rank's row block, in rank order. Blocks
    may differ in length by the ``tensor_split`` rule: with ``total`` (the
    whole row count) their lengths follow from it, else they are gathered
    first."""
    if _inactive(mesh):
        return x
    if total is None:
        n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
        sizes = [int(s) for s in all_gather_rows(n, mesh, mesh.size)]
    else:
        base, extra = divmod(int(total), mesh.size)
        sizes = [base + (r < extra) for r in range(mesh.size)]
    if sizes[mesh.rank] != x.shape[0]:
        raise ValueError(f"rank {mesh.rank}: {x.shape[0]} rows, expected "
                         f"{sizes[mesh.rank]}")
    top = max(sizes)
    send = _wire(x, mesh)
    if send.shape[0] < top:
        send = torch.cat([send, send.new_zeros((top - send.shape[0],)
                                               + tuple(send.shape[1:]))])
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send, group=mesh.group)
    return _unwire(torch.cat([p[:s] for p, s in zip(parts, sizes)]), x)


def all_reduce(x, mesh: Optional[Mesh], op: str = "sum") -> torch.Tensor:
    """Elementwise reduction of ``x`` over the ranks (``op``: 'sum', 'max'
    or 'min'); returns a new tensor (``x`` itself without a mesh)."""
    if _inactive(mesh):
        return x
    if op not in _OPS:
        raise ValueError(f"op={op!r}: expected one of {tuple(_OPS)}")
    buf = _wire(x, mesh)
    if buf is x:
        buf = buf.clone()
    dist.all_reduce(buf, op=_OPS[op], group=mesh.group)
    return _unwire(buf, x)


def shard_rows(x, mesh: Optional[Mesh]):
    """This rank's row block of every tensor of ``x`` (0-d tensors and
    non-tensors pass through)."""
    if _inactive(mesh):
        return x

    def block(t):
        if t.dim() == 0:
            return t
        start, stop = mesh.row_range(t.shape[0])
        return t[start:stop]

    return _tree_map(block, x)


def replicate(x, mesh: Optional[Mesh], total: Optional[int] = None):
    """Every tensor of ``x`` (this rank's row blocks) all-gathered into the
    whole; ``total``: the whole row count, where known."""
    if _inactive(mesh):
        return x
    return _tree_map(
        lambda t: t if t.dim() == 0 else all_gather_rows(t, mesh, total), x)
