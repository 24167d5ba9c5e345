"""Meshes on ``torch.distributed`` — the port's counterpart of
``repro.launch.mesh``.

A ``Mesh`` names its axes and their sizes, as a ``jax.sharding.Mesh``
does, and carries what a process of an SPMD program needs to run its
share: this rank's coordinate on each axis and one process group per
axis (none on an abstract mesh).  One
process runs each rank; every rank runs the same program on its shards
and meets the others at explicit collectives (``distributed.collectives``).

  * ``make_serving_mesh(N)`` — the ``(data=1, model=N)`` mesh of ONE
    sharded serving engine over the ``torch.distributed`` world of N
    ranks, launched one process a rank (``torchrun --nproc-per-node N``);
  * ``make_mesh((data, model))`` or ``((pod, data, model))`` — any mesh
    over the initialized world, ranks in row-major order (the twin of
    ``jax.make_mesh``): what a sharded train step runs on;
  * ``make_host_mesh()`` — the ``(1, 1)`` mesh of one process;
  * ``make_production_mesh(multi_pod)`` — the JAX package's production
    shapes, (16, 16) or (2, 16, 16): abstract (no process group, for the
    sharding policy's shapes), or with ``abstract=False`` over a world
    of exactly 256 or 512 ranks.
  * ``dry_mesh(mesh)`` — any of these shapes as rank 0 sees it, with no
    world: its ``comm`` records each collective (``DryComm``) instead of
    making it, for the dry run (``launch.dryrun``).

Without an initialized world, ``make_host_mesh`` and
``make_serving_mesh(1)`` start a world of one rank in this process
(gloo on the CPU, NCCL on the card).  ``Mesh.comm(axes)`` is the
``distributed.collectives.Comm`` of ``model``, of the data axes
together, or of every axis.  Constructing a mesh is the only thing here
that touches ``torch.distributed``; importing the module does not.
"""

from __future__ import annotations

import datetime
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

# NVIDIA H100 SXM (data sheet), per card, for the roofline model: dense
# bfloat16 tensor-core rate, HBM3 bandwidth, NVLink bandwidth each way
PEAK_FLOPS_BF16 = 989e12        # FLOP/s
HBM_BW = 3.35e12                # B/s
NVLINK_BW = 450e9               # B/s per direction

# how long a collective of a world this module starts may wait
TIMEOUT = datetime.timedelta(minutes=10)


class Mesh:
    """Named axes over the ranks of a ``torch.distributed`` world.

    ``axis_names`` and ``shape`` (name -> size) are a JAX mesh's;
    ``coords`` (name -> this rank's index on the axis) and ``groups``
    (``"model"``, and the tuple of the data axes, -> its process group;
    see ``_world_mesh``) are what an SPMD process adds.  ``host_group``
    is a gloo group over the ``model`` axis for host values (the
    engines' shared clock), whatever backend ``groups`` use.  An abstract mesh (``make_production_mesh``) has
    shapes only."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 *, coords: Optional[Dict[str, int]] = None,
                 groups: Optional[Dict[str, object]] = None,
                 host_group=None, backend: Optional[str] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, (int(s) for s in shape)))
        self.coords = coords
        self.groups = groups or {}
        self.host_group = host_group
        self.backend = backend

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    @property
    def abstract(self) -> bool:
        return self.coords is None

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        where = "abstract" if self.abstract else (
            f"{self.backend}, rank " + ", ".join(
                f"{a}={c}" for a, c in self.coords.items()))
        return f"Mesh({axes}; {where})"

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The axes the batch and FSDP split over: ``pod`` and ``data``."""
        return tuple(a for a in self.axis_names if a != "model")

    def comm(self, axes: Union[str, Tuple[str, ...]]):
        """The ``Comm`` of ``axes``: ``"model"``, the data axes (a name or
        the tuple of them), or every axis.  An axis of one rank and no
        group gives a ``Comm`` of size 1 whose collectives do nothing."""
        from repro_torch.distributed.collectives import Comm
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.abstract:
            raise ValueError(f"{self!r} is abstract: it has no ranks")
        if set(axes) == set(self.axis_names):
            return Comm(dist.group.WORLD, dist.get_rank(), self.size)
        if axes == ("model",):
            return Comm(self.groups["model"], self.coords["model"],
                        self.shape["model"])
        if set(axes) == set(self.data_axes):
            size, index = 1, 0
            for a in self.data_axes:
                size, index = size * self.shape[a], \
                    index * self.shape[a] + self.coords[a]
            return Comm(self.groups.get(self.data_axes), index, size)
        raise ValueError(f"no group for axes {axes} on {self!r}")

    def broadcast_host(self, value: int) -> int:
        """``value`` as the ``model`` axis's rank 0 has it, on every rank
        of the axis (one gloo broadcast of an int64; no collective on a
        one-rank axis).  Every rank must call it at the same point."""
        if self.shape.get("model", 1) == 1:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.broadcast(t, src=dist.get_global_rank(self.host_group, 0),
                       group=self.host_group)
        return int(t.item())


class DryMesh(Mesh):
    """A mesh's shape with rank 0's coordinates on every axis and no
    process group: ``comm(axes)`` is a ``collectives.DryComm`` of the
    axes' size, every axis group's sharing one ``tally`` (bytes and
    counts by collective kind).  One rank's step runs on it as on a
    world of the mesh's shape, each collective recorded in place of
    being made (``dry_mesh``)."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        from repro_torch.distributed.collectives import new_tally
        super().__init__(shape, axis_names,
                         coords={a: 0 for a in axis_names}, backend="dry")
        self.tally = new_tally()

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"DryMesh({axes})"

    def comm(self, axes: Union[str, Tuple[str, ...]]):
        from repro_torch.distributed.collectives import DryComm
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not set(axes) <= set(self.axis_names):
            raise ValueError(f"no group for axes {axes} on {self!r}")
        return DryComm(math.prod(self.shape[a] for a in set(axes)),
                       self.tally)

    def broadcast_host(self, value: int) -> int:
        return int(value)


def dry_mesh(mesh: Union[Mesh, Tuple[int, ...]]) -> DryMesh:
    """The dry run's mesh: ``mesh``'s shape (an abstract
    ``make_production_mesh``, any ``Mesh``, or a shape, named as
    ``make_mesh`` names it) as rank 0 of it sees it, with no world
    behind it (``DryMesh``): a sharded step runs on this rank's slices
    and records its collectives in ``.tally``.  Every rank's shapes are
    the same under the policy's even splits, so rank 0's step stands
    for each."""
    if isinstance(mesh, Mesh):
        return DryMesh(tuple(mesh.shape.values()), mesh.axis_names)
    shape = tuple(int(n) for n in mesh)
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    return DryMesh(shape, names)


def _start_world(device) -> str:
    """A world of one rank in this process, when none is initialized:
    NCCL for the card, gloo for the CPU.  Returns the backend."""
    if dist.is_initialized():
        return dist.get_backend()
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' for a gloo mesh on the CPU")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                             world_size=1, timeout=TIMEOUT)
    return backend


def _world_mesh(data: int, model: int,
                axis_names: Tuple[str, ...] = ("data", "model"),
                shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """The mesh of ``shape`` (default ``(data, model)``) over the
    initialized world, ranks in row-major order (rank = data_index *
    model + model_index, ``data`` the axes before ``model`` taken
    together).  The ``model`` axis always has a group, one rank or more
    (a sharded model meets its collectives on it); the data axes
    together one when they have more than one rank, keyed by their
    tuple."""
    shape = shape or (data, model)
    rank, world = dist.get_rank(), dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {data * model} "
                         f"ranks; the world holds {world}")
    backend = dist.get_backend()
    data_key = tuple(axis_names[:-1])
    groups: Dict[object, object] = {data_key: None}
    host = None
    # every rank creates every group, in the same order
    for d in range(data):
        ranks = list(range(d * model, (d + 1) * model))
        g = dist.group.WORLD if model == world else dist.new_group(ranks)
        h = None
        if model > 1:
            h = g if backend == "gloo" else dist.new_group(ranks,
                                                           backend="gloo")
        if rank in ranks:
            groups["model"], host = g, h
    if data > 1:
        for m in range(model):
            ranks = list(range(m, world, model))
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[data_key] = g
    coords, outer = {"model": rank % model}, rank // model
    for name, n in reversed(list(zip(axis_names[:-1], shape[:-1]))):
        coords[name], outer = outer % n, outer // n
    coords = {a: coords[a] for a in axis_names}
    return Mesh(tuple(shape), tuple(axis_names), coords=coords,
                groups=groups, host_group=host, backend=backend)


def make_mesh(shape: Tuple[int, ...],
              axis_names: Optional[Tuple[str, ...]] = None) -> Mesh:
    """A mesh of ``shape`` over the initialized ``torch.distributed``
    world, ranks in row-major order — the twin of ``jax.make_mesh``:
    ``(data, model)``, or ``(pod, data, model)`` for three axes (the
    names by default).  The world must hold exactly the mesh's ranks
    (``ValueError`` naming the count otherwise); launch one process a
    rank (``torchrun --nproc-per-node N``)."""
    shape = tuple(int(n) for n in shape)
    names = tuple(axis_names or {2: ("data", "model"),
                                 3: ("pod", "data", "model")}[len(shape)])
    if len(names) != len(shape) or names[-1] != "model" or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} over axes {names}: the last "
                         f"axis is 'model', every size >= 1")
    need = math.prod(shape)
    if not dist.is_initialized():
        raise ValueError(f"make_mesh({shape}): torch.distributed is not "
                         f"initialized — launch {need} processes with "
                         f"torchrun --nproc-per-node {need}")
    return _world_mesh(need // shape[-1], shape[-1], names, shape)


def make_host_mesh(device="cuda") -> Mesh:
    """The ``(data=1, model=1)`` mesh of this process, with the
    production axis names (the JAX package's ``make_host_mesh``).
    Starts a world of one rank when none is initialized (``device``
    picks its backend: NCCL for the card, gloo for ``"cpu"``)."""
    _start_world(device)
    if dist.get_world_size() != 1:
        raise ValueError(
            f"make_host_mesh(): the torch.distributed world holds "
            f"{dist.get_world_size()} ranks; the host mesh is one")
    return _world_mesh(1, 1)


def make_serving_mesh(model: int = 1, device="cuda") -> Mesh:
    """A ``(data=1, model=N)`` mesh for ONE sharded serving engine:
    tensor and expert parallelism over ``model``, no data axis (replica
    data-parallelism lives above the engine, in ``ReplicaRouter``), over
    the ``torch.distributed`` world of exactly ``model`` ranks — one
    process a rank, launched with ``torchrun --nproc-per-node N`` (or
    ``init_process_group`` with the world's address, size and rank).
    ``make_serving_mesh(1)`` without a world starts one in this process
    (``device`` picks NCCL or gloo, as ``make_host_mesh``)."""
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    if not dist.is_initialized():
        if model > 1:
            raise ValueError(
                f"make_serving_mesh({model}): torch.distributed is not "
                f"initialized — launch {model} processes with torchrun "
                f"--nproc-per-node {model} (one a rank) and call it in "
                f"each")
        _start_world(device)
    world = dist.get_world_size()
    if world != model:
        raise ValueError(
            f"make_serving_mesh({model}): the torch.distributed world "
            f"holds {world} ranks — launch exactly {model} with torchrun "
            f"--nproc-per-node {model}")
    return _world_mesh(1, model)


def make_production_mesh(*, multi_pod: bool = False,
                         abstract: bool = True) -> Mesh:
    """The JAX package's production mesh shapes: (data=16, model=16), or
    (pod=2, data=16, model=16) multi-pod.  Abstract by default (no
    ranks, no process group: for the sharding policy's shapes and the
    dry run); ``abstract=False`` builds it over the initialized world,
    which must hold exactly 256 (512 multi-pod) ranks — ``ValueError``
    naming the count otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    if not abstract:
        need = math.prod(shape)
        world = dist.get_world_size() if dist.is_initialized() else 0
        if world != need:
            raise ValueError(
                f"the {'multi-pod ' if multi_pod else ''}production mesh "
                f"{shape} needs a world of {need} ranks; it holds {world} "
                f"— launch {need} processes (torchrun), one a card")
        return make_mesh(shape)
    if multi_pod:
        return Mesh(shape, ("pod", "data", "model"))
    return Mesh(shape, ("data", "model"))
