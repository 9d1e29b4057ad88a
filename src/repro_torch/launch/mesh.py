"""The data-parallel layout of a multi-process run
(``repro.launch.mesh``'s data-parallel part, over ``torch.distributed``).

The port trains data-parallel only: every rank of the process group
holds the whole model and one data slot, the rank's own, so the data
axis is the group and its width is the world size.  A rank is a process
(``torchrun`` and the launcher's ``--process-id`` start one a rank), so
process p owns slot p.  The per-host loader samples rows ``[p·B/N,
(p+1)·B/N)`` of every global batch on process p;
:func:`assert_per_host_row_blocks` checks, from the group, that each
process owns that contiguous block of slots, with the reference's
messages.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

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
