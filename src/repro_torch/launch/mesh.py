"""The layout of a multi-process run over ``torch.distributed``
(``repro.launch.mesh`` in PyTorch): the replicated data-parallel group,
and the data × model mesh of processes that shards the weights.

Without ``--mesh`` every rank of the process group holds the whole model
and one data slot, the rank's own, so the data axis is the group and its
width is the world size (:class:`GroupMesh`).  A rank is a process
(``torchrun`` and the launcher's ``--process-id`` start one a rank), so
process p owns slot p.  The per-host loader samples rows ``[p·B/N,
(p+1)·B/N)`` of every global batch on process p;
:func:`assert_per_host_row_blocks` checks, from the group, that each
process owns that contiguous block of slots, with the reference's
messages.

With ``--mesh DxM`` (or ``PxDxM``) the processes form a :class:`Mesh`
of shape ``{"data": D, "model": M}`` (``"pod"`` first): rank r sits at
the row-major coordinates of r, the model axis fastest, as device r of
``jax.make_mesh``'s ``devices`` array does.  The weights are split by
the reference's ``param_specs`` (:func:`shard_box` is its
``devices_indices_map`` for one rank), the batch by data slot: the
ranks at one (pod, data) coordinate hold the same rows.  The per-host
loader therefore takes ``process_index`` = the rank's data slot and
``process_count`` = P·D, and the plan is checked against P·D.  The
reference's ``assert_per_host_row_blocks`` assumes a process holds
whole data slots; on a 2×2 mesh of four one-device processes a slot is
held by two processes, and the check would refuse the mesh ("does not
divide").  The port's check goes by data slot instead, which is what
the loader feeds.

GSPMD pads a dim its mesh axis does not divide; the port does not:
:func:`shard_box` raises ``ValueError`` naming the leaf, the dim and the
axis.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch.distributed as dist


def data_parallel_size(mesh) -> int:
    """Number of data-parallel shards of the global batch: the product
    of the mesh's ``pod`` and ``data`` axes (1 when no mesh).  Accepts
    any object with a ``.shape`` mapping, so the engine and the per-host
    plan check share one definition of the data width."""
    if mesh is None:
        return 1
    shape = dict(mesh.shape)
    n = 1
    for axis in ("pod", "data"):
        n *= int(shape.get(axis, 1))
    return max(n, 1)


class _Slot(NamedTuple):
    """A data slot of the group: the rank that holds it, as a device
    of the reference's mesh names its process."""
    process_index: int


class GroupMesh:
    """The process group as a data-parallel mesh: ``shape`` is
    ``{"data": world size}``; rank r holds slot r."""

    def __init__(self, world: int):
        self.shape = {"data": int(world)}

    def devices_indices_map(self, shape):
        """Each slot's index into a batch axis of ``shape[0]`` rows
        (the reference's ``NamedSharding.devices_indices_map``)."""
        n, world = shape[0], self.shape["data"]
        per = n // world
        return {_Slot(r): (slice(r * per, (r + 1) * per),)
                for r in range(world)}


def world_size() -> int:
    """The process group's size, or 1 outside a multi-process run."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank in the group, or 0 outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def group_mesh() -> Optional[GroupMesh]:
    """The group's mesh, or None (no mesh) in a single-process run."""
    n = world_size()
    return GroupMesh(n) if n > 1 else None


def _row_blocks_by_process(indices_map, n_rows: int):
    """{process_index: set of data-slot rows it owns} from a
    ``devices_indices_map`` of a length-``n_rows`` batch axis."""
    per: Dict[int, set] = {}
    for dev, idx in indices_map.items():
        sl = idx[0] if idx else slice(0, n_rows)
        start = sl.start or 0
        stop = n_rows if sl.stop is None else sl.stop
        per.setdefault(dev.process_index, set()).update(range(start, stop))
    return per


def check_per_host_row_blocks(per_process, n_rows: int,
                              process_count: int):
    """Pure check behind :func:`assert_per_host_row_blocks`: process
    ``p`` must own exactly the contiguous slot block ``[p*n/N,
    (p+1)*n/N)``, the layout the per-host loader samples (process p
    contributes rows ``[p*B/N, (p+1)*B/N)`` of every global batch)."""
    if n_rows % process_count:
        raise ValueError(
            f"data-parallel width {n_rows} does not divide across "
            f"{process_count} host processes — per-host feeding "
            f"cannot assign whole row blocks")
    per = n_rows // process_count
    for p in range(process_count):
        want = list(range(p * per, (p + 1) * per))
        got = sorted(per_process.get(p, ()))
        if got != want:
            raise ValueError(
                f"process {p} owns data-axis slots {got} but per-host "
                f"feeding requires the contiguous block "
                f"[{want[0]}, {want[-1] + 1}) in process order — this "
                f"mesh's device order breaks the loader's row-block "
                f"assumption (jax.make_mesh layouts satisfy it; custom "
                f"meshes must keep each process's devices contiguous "
                f"along the data axes)")


def assert_per_host_row_blocks(mesh=None,
                               process_count: Optional[int] = None):
    """Assert, from the mesh's own slot map (the process group's when
    ``mesh`` is None), that each process owns one contiguous,
    process-ordered block of the batch axis, so per-host feeding is
    safe.  No-op for a single process; ``ValueError`` otherwise."""
    nproc = world_size() if process_count is None else process_count
    mesh = group_mesh() if mesh is None else mesh
    if mesh is None or nproc <= 1:
        return
    n = data_parallel_size(mesh)
    per = _row_blocks_by_process(mesh.devices_indices_map((n,)), n)
    check_per_host_row_blocks(per, n, nproc)


# --------------------------------------------------------------------- #
# the data × model mesh of processes
# --------------------------------------------------------------------- #

Block = Tuple[Tuple[int, int], ...]     # ((start, stop), ...) a dim


class Mesh:
    """A mesh of processes, ``shape`` its axes in order (``{"data": D,
    "model": M}`` or ``{"pod": P, "data": D, "model": M}``).  Rank r
    sits at the row-major coordinates of r, the last axis fastest.  The
    FSDP group of a rank is the P·D ranks at its model coordinate, its
    model group the M ranks at its (pod, data) coordinate; both are made
    by :meth:`groups`, a collective of every rank of the process group,
    in one fixed order."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self._groups = None

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def coords(self, rank: int) -> Dict[str, int]:
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside the mesh {self.shape}")
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {n: out[n] for n in self.axis_names}

    @property
    def n_fsdp(self) -> int:
        """The data-parallel (FSDP) width, P·D."""
        return data_parallel_size(self)

    @property
    def n_model(self) -> int:
        return self.shape.get("model", 1)

    def fsdp_index(self, rank: int) -> int:
        """The rank's data slot: its (pod, data) coordinate, pod major."""
        c = self.coords(rank)
        return c.get("pod", 0) * self.shape.get("data", 1) + \
            c.get("data", 0)

    def model_index(self, rank: int) -> int:
        return self.coords(rank).get("model", 0)

    def fsdp_ranks(self, model_index: int) -> List[int]:
        """The ranks at one model coordinate, by data slot."""
        return [r for r in range(self.size)
                if self.model_index(r) == model_index]

    def model_ranks(self, fsdp_index: int) -> List[int]:
        """The ranks of one data slot, by model coordinate."""
        return [r for r in range(self.size)
                if self.fsdp_index(r) == fsdp_index]

    def groups(self):
        """(FSDP group, model group) of this process, made on first call:
        every rank makes every group (``new_group`` is collective), the
        FSDP groups first, by model coordinate, then the model groups,
        by data slot.  Needs a process group of the mesh's size."""
        if self._groups is None:
            if world_size() != self.size:
                raise ValueError(
                    f"mesh {self.shape} has {self.size} slots but the "
                    f"process group has {world_size()} processes")
            me = rank()
            fsdp = [dist.new_group(self.fsdp_ranks(m))
                    for m in range(self.n_model)]
            model = [dist.new_group(self.model_ranks(f))
                     for f in range(self.n_fsdp)]
            self._groups = (fsdp[self.model_index(me)],
                            model[self.fsdp_index(me)])
        return self._groups


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def shard_box(shape: Sequence[int], spec, mesh, rank: int, *,
              name: str = "array") -> Block:
    """The block of an array of ``shape`` that ``rank`` holds under
    ``spec`` (the reference's ``NamedSharding(mesh, spec)
    .devices_indices_map(shape)`` for the device at the rank's
    position): a dim whose entry names axes is split into their product
    of equal parts, the first axis major; ``None`` and dims past the
    spec are whole.  A dim the axes do not divide raises ``ValueError``
    naming ``name``, the dim and the axes (GSPMD would pad it)."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"{name}: spec {spec} has more entries than the "
                         f"{len(shape)} dims of {tuple(shape)}")
    coords = mesh.coords(rank)
    box = []
    for dim, n in enumerate(shape):
        axes = _spec_axes(spec[dim]) if dim < len(spec) else ()
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"{name}: spec names axis {a!r}, which "
                                 f"the mesh {mesh.shape} does not have")
        k, idx = 1, 0
        for a in axes:
            k *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coords[a]
        if n % k:
            raise ValueError(
                f"{name}: dim {dim} of size {n} does not divide over mesh "
                f"axis {axes if len(axes) > 1 else axes[0]!r} of {k} (the "
                f"port does not pad an uneven split)")
        per = n // k
        box.append((idx * per, (idx + 1) * per))
    return tuple(box)


def parse_mesh(spec: str) -> Dict[str, int]:
    """A ``--mesh`` spec's shape: "DxM" or "PxDxM"."""
    dims = [int(x) for x in spec.lower().split("x")]
    if len(dims) == 2:
        return dict(zip(("data", "model"), dims))
    if len(dims) == 3:
        return dict(zip(("pod", "data", "model"), dims))
    raise ValueError(f"--mesh {spec!r}: give DxM (data x model) or PxDxM "
                     f"(pod x data x model)")


def make_launch_mesh(spec: Optional[str], *,
                     distributed: bool = False) -> Optional[Mesh]:
    """The launcher's mesh from a ``--mesh`` spec ("DxM" or "PxDxM"),
    checked against the process group (its size when ``distributed``,
    else one process).  No spec is ``None``: the replicated
    data-parallel path (:class:`GroupMesh`) with or without a group."""
    if not spec:
        return None
    m = Mesh(parse_mesh(spec))
    n = world_size() if distributed else 1
    if m.size != n:
        raise ValueError(
            f"--mesh {spec} has {m.size} slots but the run has {n} "
            f"process(es): start one process a slot")
    return m


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, (16, 16) or (2, 16, 16); shape
    only (no process group is made until :meth:`Mesh.groups`)."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_test_mesh(n_data: int = 2, n_model: int = 2,
                   multi_pod: bool = False) -> Mesh:
    """A small mesh for CPU tests (four gloo processes for (2, 2))."""
    if multi_pod:
        return Mesh({"pod": 2, "data": n_data, "model": n_model})
    return Mesh({"data": n_data, "model": n_model})
