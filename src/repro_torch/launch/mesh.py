"""Device meshes over ``torch.distributed`` (port of
``repro.launch.mesh``).

One process a rank. A :class:`Mesh` names the axes of a grid of ranks, as
the reference's ``jax.sharding.Mesh`` names the axes of a grid of devices:
rank r sits at the row-major coordinates of r in the grid (the last axis
varies fastest, as ``jax.make_mesh`` lays devices out), and each axis has
one process group a line of the grid, the ranks that differ only in that
axis's coordinate. The explicit-collective code (``models.moe``'s expert
parallelism, ``engine.aggregation``, ``engine.pipeline_parallel``) takes
``mesh.group(axis)`` where the reference's shard_map body names
``axis_name``.

The transport is stated, never guessed (``backend_for``):

* ``"gloo"`` for ranks on the CPU;
* ``"nccl"`` on CUDA when every rank has a card of its own;
* ``"gloo"`` on CUDA when ranks share a card: NCCL refuses two ranks on
  one device ("Duplicate GPU detected"); gloo takes CUDA tensors for
  every collective but send / recv, which ``distributed.collectives``
  stages through host memory (``launch.gloo_probe``).

A mesh is the size it is asked for or nothing: ``make_mesh`` raises when
the world's size differs, and when asked for the card it raises without
one (never a mesh on the CPU instead).

The grid is built here, not on ``torch.distributed.device_mesh``'s
``DeviceMesh``. The explicit-collective code needs only each axis's group
and this rank's coordinate; the placement code
(``distributed.elastic.reshard_state``) needs only the coordinates, which
a stand-in without process groups gives (the tests' ``Grid``); and the
layout is the row-major one of ``jax.make_mesh``, which the tests hold
against the reference. ``DeviceMesh`` has not been tried on gloo ranks
sharing one card.
"""
from __future__ import annotations

import datetime
import itertools
import math
from typing import Dict, Sequence, Tuple

import torch

__all__ = ["Mesh", "backend_for", "rank_device", "init_ranks", "make_mesh",
           "make_production_mesh", "mesh_axis_sizes", "coords"]


def backend_for(device, world_size: int) -> str:
    """The process group backend for ``world_size`` ranks on ``device``'s
    type."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "gloo"
    if kind != "cuda":
        raise ValueError(f"no collective transport for device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    return "nccl" if torch.cuda.device_count() >= world_size else "gloo"


def rank_device(device, rank: int, world_size: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, or on CUDA card ``rank`` when
    there are enough, else consecutive ranks sharing a card (ranks 0-3 on
    card 0 of one)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    return torch.device("cuda", rank if n >= world_size
                        else rank * n // world_size)


def init_ranks(rank: int, world_size: int, *, device, store,
               timeout_s: float = 300.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` with
    ``backend_for(device, world_size)``, through ``store`` (a
    ``torch.distributed.FileStore``, or a ``TCPStore`` for a rendezvous
    over TCP); every collective then waits at most ``timeout_s``. Returns
    this rank's device (``rank_device``), made the current CUDA device."""
    import torch.distributed as dist
    backend = backend_for(device, world_size)
    dev = rank_device(device, rank, world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


class Mesh:
    """A named grid of the default group's ranks. ``shape`` maps each axis
    name to its size, in mesh order (``jax.sharding.Mesh.shape``);
    ``coords`` maps it to this rank's coordinate; ``group(axis)`` is the
    process group of this rank's line along ``axis``."""

    def __init__(self, shape: Dict[str, int], rank: int, groups: Dict,
                 device: torch.device, backend: str):
        self.shape = dict(shape)
        self.rank = rank
        self.device = device
        self.backend = backend
        self._groups = groups
        self.coords = coords(rank, shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        return self._groups[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
        return self.coords[axis]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank} at {self.coords}, "
                f"{self.backend} on {self.device})")


def coords(rank: int, shape: Dict[str, int]) -> Dict[str, int]:
    """Rank ``rank``'s coordinate along each axis of a grid of ``shape``
    (row-major: the last axis varies fastest)."""
    out = {}
    for axis, n in reversed(list(shape.items())):
        out[axis], rank = rank % n, rank // n
    return {axis: out[axis] for axis in shape}


def _rank(at: Sequence[int], dims: Sequence[int]) -> int:
    r = 0
    for c, n in zip(at, dims):
        r = r * n + c
    return r


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` on the default process group,
    whose size must be the grid's (``init_ranks`` first). ``device``
    defaults to CUDA, and a mesh on CUDA raises without a card; each axis's
    groups are created on every rank in one order, as
    ``torch.distributed.new_group`` requires."""
    import torch.distributed as dist
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} vs axes {axes}")
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on CUDA was asked for and there is no "
                           "CUDA device")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (call init_ranks "
                           "on every rank first)")
    world, want = dist.get_world_size(), math.prod(shape)
    if world != want:
        raise ValueError(f"a mesh of {dict(zip(axes, shape))} needs {want} "
                         f"ranks; the world has {world}")
    backend = dist.get_backend()
    if dev.type == "cuda" and backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend} cannot carry CUDA tensors")
    rank = dist.get_rank()
    groups = {}
    for i, axis in enumerate(axes):
        others = [range(n) if j != i else [0] for j, n in enumerate(shape)]
        for base in itertools.product(*others):
            line = [_rank(base[:i] + (c,) + base[i + 1:], shape)
                    for c in range(shape[i])]
            group = dist.new_group(line)
            if rank in line:
                groups[axis] = group
    return Mesh(dict(zip(axes, shape)), rank, groups,
                rank_device(dev, rank, world), backend)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production mesh: 16 x 16 = 256 ranks ("data", "model"), or 2
    pods = 512 ranks ("pod", "data", "model"); raises on any other world
    size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    return dict(mesh.shape)
