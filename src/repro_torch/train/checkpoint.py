"""Streaming, async-capable checkpoints (``repro.train.checkpoint`` in
PyTorch), in the reference's on-disk format v2 byte for byte: a
checkpoint the port writes is the one the reference writes for the same
weights and optimizer state, and each restores the other's.

A checkpoint is a **directory** (``path`` with any trailing ``.npz``
stripped)::

    <base>/
      manifest.json     # the commit marker, swapped in by one os.replace:
                        # array index (key -> shape/dtype/block files,
                        # writer, crc32) + the save's generation + meta
      meta.json         # informational copy of the meta
      arrays/<gen>/     # one .npy per distinct block of each leaf
        00042.0.npy     # <leaf index in sorted key order>.<block>

The leaves are the reference's pytree leaves, ``p:<path>`` for the
parameters and ``o:<path>`` for the optimizer state
(``weights.param_tree`` / ``weights.opt_tree`` give that layout over the
port's live tensors).  A per-layer leaf is a :class:`Stacked` of the L
layers' tensors: its ``.npy`` holds them stacked along a leading L, but
the stacked array is never built — layer i's bytes are streamed after
layer i−1's, and a restore reads each layer's slice of the memory-mapped
file straight into its tensor.  Every device→host transfer goes through
:func:`_to_host` in ``chunk_bytes`` slices, so host memory stays bounded
by one slice plus one layer's tensor; each block's crc32 is summed during
the stream and lands in the manifest for ``restore(..., verify=True)``.

Commit: a save streams into a fresh ``arrays/<generation>/`` beside the
committed one, commits the manifest in one ``os.replace``, and only then
removes the previous generation — a save killed at any point leaves the
last committed checkpoint restorable.  :class:`CheckpointManager` runs
the stream and the commit on a writer thread, so the step loop waits
only for an on-device snapshot.  Restore copies into the given tensors
in place, so a trainer whose CUDA graphs were captured over them keeps
replaying the same graphs.  Legacy single-file ``<base>.npz``
checkpoints (:func:`save_npz`) restore through the same code.

Multi-process runs (a ``torch.distributed`` group) save collectively,
as the reference's processes do.  A leaf is one block held by every
rank (replicated data-parallel state), or on a data × model mesh a
:class:`Sharded` leaf: each rank holds one block, and the distinct
blocks of the leaf (sorted by their start) are written once each, as
``<leaf>.<j>.npy`` with the manifest's ``start``/``stop``.  The writer
of a block rotates round-robin over the ranks that hold it, counted over
all blocks in save order, as the reference's ``_plan_writes`` does
(replicated leaves: block j of the save goes to rank ``j mod N``).  A
restore reads, for each rank, the overlap of the saved blocks with its
own block (``_fill_block``), so a checkpoint restores onto any mesh or
one process.  A save agrees on the generation (the
committed manifest, read by all after a barrier); rank 0 clears the
leftovers and makes the directory; every rank streams its leaves and
drops its completion marker ``.save-<gen>.<rank>.json`` with their
crc32s; rank 0 waits for every marker, merges the crc32s, commits the
manifest and clears the markers.  The sync path puts barriers around
the commit (``torch.distributed.barrier``); the async writer thread
issues no collective and commits through the markers alone (the other
ranks wait for the committed generation), so a dead peer surfaces as a
:class:`CheckpointTimeoutError` after ``commit_timeout`` and the
previous generation stays restorable.  The metadata records
``save_process_count``; a checkpoint of N ranks restores on any number.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import mesh

FORMAT_VERSION = 2                     # v2 adds writer + crc32 per block
DEFAULT_CHUNK_BYTES = 1 << 24          # 16 MiB per device->host slice
DEFAULT_COMMIT_TIMEOUT = 600.0         # s to wait on peers before failing

Block = Tuple[Tuple[int, int], ...]    # ((start, stop), ...) per dim

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16, torch.int64: np.int64,
              torch.int32: np.int32, torch.int16: np.int16,
              torch.int8: np.int8, torch.uint8: np.uint8,
              torch.bool: np.bool_}


class CheckpointError(RuntimeError):
    """Base class for checkpoint failures."""


class CheckpointCorruptionError(CheckpointError):
    """A block file's content does not match its manifest checksum."""


class CheckpointTimeoutError(CheckpointError):
    """A peer process never finished its part of a save: it likely died
    mid-save.  The previously committed generation is intact."""


class Stacked(tuple):
    """The L per-layer tensors of one reference leaf, which the reference
    stacks along a leading L dim: written and read layer by layer."""

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self),) + tuple(self[0].shape)

    @property
    def dtype(self):
        return self[0].dtype


class Sharded:
    """One rank's block of a leaf on a mesh: ``local`` (a tensor, or a
    :class:`Stacked` of the layers' blocks), the whole leaf's ``shape``
    and ``boxes``, every rank's block in whole-leaf coordinates (rank
    r's is ``boxes[r]``)."""

    def __init__(self, local, shape, boxes, rank: int):
        self.local, self.shape = local, tuple(shape)
        self.boxes, self.rank = [tuple(b) for b in boxes], int(rank)

    @property
    def box(self) -> Block:
        return self.boxes[self.rank]

    def with_local(self, local) -> "Sharded":
        return Sharded(local, self.shape, self.boxes, self.rank)


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        if dtype not in _NP_DTYPES:
            raise ValueError(f"checkpoint: {dtype} has no numpy dtype; "
                             f"save the float32 master weights")
        return np.dtype(_NP_DTYPES[dtype])
    return np.dtype(dtype)


def _barrier(name: str):
    """Every rank of a multi-process run reaches ``name`` (a no-op for one
    process)."""
    if mesh.world_size() > 1:
        dist.barrier()


def _to_host(x) -> np.ndarray:
    """The single device→host transfer point of the save path.  Every
    call moves at most one ``chunk_bytes`` slice of one tensor — tests
    wrap it to prove no whole leaf is ever fetched at once."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# --------------------------------------------------------------------- #
# pytree <-> flat path-keyed dict
# --------------------------------------------------------------------- #

def _flatten(tree, prefix="") -> Dict[str, Any]:
    """Path-flatten a tree of dicts and lists (the reference's keys:
    sorted dict keys joined by ``/``, list items as ``[i]``); tensors,
    arrays and :class:`Stacked` are leaves."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Stacked):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(template, flat: Dict[str, Any], prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)) and \
            not isinstance(template, Stacked):
        return type(template)(_unflatten(v, flat, f"{prefix}[{i}]/")
                              for i, v in enumerate(template))
    return flat[prefix.rstrip("/")]


def _flat_state(params, opt_state) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    flat.update({f"p:{k}": v for k, v in _flatten(params).items()})
    flat.update({f"o:{k}": v for k, v in _flatten(opt_state).items()})
    return flat


def _base(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def _leaf_meta(leaf) -> Tuple[Tuple[int, ...], np.dtype]:
    """(shape, numpy dtype) of a leaf as the checkpoint stores it (a
    :class:`Sharded` leaf's whole shape)."""
    if isinstance(leaf, Sharded):
        return leaf.shape, _leaf_meta(leaf.local)[1]
    if isinstance(leaf, Stacked):
        first = leaf[0]
        for t in leaf:
            if tuple(t.shape) != tuple(first.shape) or t.dtype != first.dtype:
                raise ValueError(f"Stacked leaf: layer of shape "
                                 f"{tuple(t.shape)} {t.dtype} beside "
                                 f"{tuple(first.shape)} {first.dtype}")
        return leaf.shape, _np_dtype(leaf.dtype)
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), _np_dtype(leaf.dtype)
    arr = np.asarray(leaf)
    return tuple(arr.shape), arr.dtype


def _pieces(leaf) -> List[Any]:
    """The leaf's data as flat pieces in storage order."""
    if isinstance(leaf, Stacked):
        return [t.detach().reshape(-1) for t in leaf]
    if isinstance(leaf, torch.Tensor):
        return [leaf.detach().reshape(-1)]
    return [np.asarray(leaf).reshape(-1)]


def _full_block(shape) -> Block:
    return tuple((0, n) for n in shape)


# --------------------------------------------------------------------- #
# writing
# --------------------------------------------------------------------- #

def _stream_write(path: str, data, chunk_bytes: int) -> int:
    """Write one leaf to a .npy file in bounded slices: each piece (a
    layer of a :class:`Stacked`, or the whole tensor) is viewed flat and
    copied ``chunk_bytes`` at a time behind the previous one.  Returns
    the crc32 of the streamed bytes."""
    shape, dtype = _leaf_meta(data)
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=dtype,
                                   shape=shape)
    crc = 0
    try:
        flat = mm.reshape(-1)             # writes through to the file
        elems = max(1, int(chunk_bytes) // max(dtype.itemsize, 1))
        off = 0
        for src in _pieces(data):
            for i in range(0, src.shape[0], elems):
                h = np.ascontiguousarray(_to_host(src[i:i + elems]))
                flat[off + i:off + i + h.shape[0]] = h
                crc = zlib.crc32(h, crc)
            off += src.shape[0]
        mm.flush()
    finally:
        del mm
    return crc


def _crc_of_file(path: str,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> int:
    """crc32 of a block file's array content, read in bounded slices
    (memory-mapped)."""
    arr = np.load(path, mmap_mode="r")
    flat = np.asarray(arr).reshape(-1) if arr.ndim == 0 \
        else arr.reshape(-1)
    crc = 0
    elems = max(1, int(chunk_bytes) // max(flat.dtype.itemsize, 1))
    for i in range(0, flat.shape[0], elems):
        crc = zlib.crc32(np.ascontiguousarray(flat[i:i + elems]), crc)
    return crc


def _shard_file(gen: int, leaf_i: int, block_j: int) -> str:
    return os.path.join("arrays", str(gen), f"{leaf_i:05d}.{block_j}.npy")


def _committed_generation(base: str) -> int:
    """Generation of the committed manifest, or -1."""
    try:
        with open(os.path.join(base, "manifest.json")) as f:
            return int(json.load(f).get("generation", 0))
    except (FileNotFoundError, json.JSONDecodeError):
        return -1


# --------------------------------------------------------------------- #
# commit coordination (marker files)
# --------------------------------------------------------------------- #

def _marker_path(base: str, gen: int, pid: int) -> str:
    return os.path.join(base, f".save-{gen}.{pid}.json")


def _write_marker(base: str, gen: int, pid: int, crcs: Dict[str, int]):
    """Drop this rank's completion marker in one rename: its blocks are
    on disk, with these checksums."""
    path = _marker_path(base, gen, pid)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"process": pid, "crc32": crcs}, f)
    os.replace(tmp, path)


def _clear_markers(base: str):
    """Remove the per-process save markers (``.save-*``) of a save, or
    those an interrupted save left."""
    try:
        entries = os.listdir(base)
    except FileNotFoundError:
        return
    for name in entries:
        if name.startswith(".save-"):
            try:
                os.remove(os.path.join(base, name))
            except OSError:
                pass


def _apply_crcs(manifest: Dict, crcs: Dict[str, int]):
    for entry in manifest["arrays"].values():
        for sh in entry["shards"]:
            if sh["file"] in crcs:
                sh["crc32"] = crcs[sh["file"]]


def _merge_markers(base: str, gen: int, nproc: int, manifest: Dict, *,
                   timeout: float, poll: float = 0.05):
    """Rank 0: wait until every rank's completion marker exists and merge
    their checksums into the manifest.  A marker that never comes means
    a peer died mid-save: fail with a clear error, the previous committed
    generation untouched."""
    deadline = time.monotonic() + timeout
    seen: set = set()
    while True:
        for pid in range(nproc):
            if pid in seen:
                continue
            p = _marker_path(base, gen, pid)
            if os.path.exists(p):
                try:
                    with open(p) as f:
                        m = json.load(f)
                except (json.JSONDecodeError, OSError):
                    continue               # racing replace; retry
                _apply_crcs(manifest, m.get("crc32", {}))
                seen.add(pid)
        if len(seen) >= nproc:
            return
        if time.monotonic() > deadline:
            raise CheckpointTimeoutError(
                f"timed out after {timeout:.0f}s waiting for save "
                f"markers from processes "
                f"{sorted(set(range(nproc)) - seen)} of generation "
                f"{gen} — a peer likely died mid-save; the previous "
                f"committed checkpoint is still restorable")
        time.sleep(poll)


def _await_commit(base: str, gen: int, timeout: float,
                  poll: float = 0.05):
    """Ranks other than 0 of an async save: wait for rank 0's commit, so
    the next save's generation agrees across ranks."""
    deadline = time.monotonic() + timeout
    while _committed_generation(base) < gen:
        if time.monotonic() > deadline:
            raise CheckpointTimeoutError(
                f"timed out after {timeout:.0f}s waiting for process 0 "
                f"to commit generation {gen} — it likely died "
                f"mid-save; the previous committed checkpoint is "
                f"still restorable")
        time.sleep(poll)


def _prepare(base: str, *, collective: bool = True) -> Tuple[int, int]:
    """Agree on the new generation and (rank 0) clear the leftovers of
    interrupted saves and make its directory; the committed generation
    stays restorable until the new one commits.  ``collective``: every
    rank first enters the save (so none still reads the directory, e.g.
    a slower peer's restore), and none streams before the directory
    exists."""
    committed = _committed_generation(base)
    gen = committed + 1
    arrays_root = os.path.join(base, "arrays")
    if collective:
        _barrier("ckpt-enter")
    if mesh.rank() == 0:
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        if os.path.isdir(arrays_root):
            for entry in os.listdir(arrays_root):
                if entry != str(committed):
                    shutil.rmtree(os.path.join(arrays_root, entry))
        _clear_markers(base)
        os.makedirs(os.path.join(arrays_root, str(gen)), exist_ok=True)
    if collective:
        _barrier("ckpt-prepare")
    return committed, gen


def _block_table(leaf, nproc: int):
    """(distinct blocks of the leaf, sorted; {block: sorted ranks holding
    it}; {block: this rank's data of it}): a :class:`Sharded` leaf's
    blocks by rank, else one whole block every rank holds."""
    if isinstance(leaf, Sharded):
        holders: Dict[Block, List[int]] = {}
        for r, b in enumerate(leaf.boxes):
            holders.setdefault(b, []).append(r)
        return sorted(holders), holders, {leaf.box: leaf.local}
    blk = _full_block(_leaf_meta(leaf)[0])
    return [blk], {blk: list(range(nproc))}, {blk: leaf}


def _plan_writes(flat: Dict[str, Any], gen: int):
    """(manifest ``arrays`` dict, [(block entry, data), ...] of the
    blocks THIS rank writes).  The writer of each block rotates
    round-robin over the ranks holding it, over all blocks in save order
    (the reference's rotation): replicated state spreads over every rank,
    and a model-sharded leaf's blocks over their holders."""
    arrays: Dict[str, Any] = {}
    mine: List[Tuple[Dict, Any]] = []
    nproc, me = mesh.world_size(), mesh.rank()
    rr = 0
    for li, (key, leaf) in enumerate(sorted(flat.items())):
        shape, dtype = _leaf_meta(leaf)
        blocks, holders, local = _block_table(leaf, nproc)
        shards = []
        for j, blk in enumerate(blocks):
            cands = holders[blk]
            ent = {"file": _shard_file(gen, li, j),
                   "start": [a for a, _ in blk],
                   "stop": [b for _, b in blk],
                   "writer": cands[rr % len(cands)]}
            rr += 1
            shards.append(ent)
            if ent["writer"] == me:
                mine.append((ent, local[blk]))
        arrays[key] = {"shape": list(shape), "dtype": dtype.name,
                       "shards": shards}
    return arrays, mine


def _commit(base: str, manifest: Dict, committed: int):
    """The single-rename commit; the superseded generation (and a legacy
    single-file checkpoint at the same base) goes only after it."""
    tmp = os.path.join(base, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(base, "manifest.json"))
    with open(os.path.join(base, "meta.json"), "w") as f:
        json.dump(manifest["meta"], f)
    old_gen = os.path.join(base, "arrays", str(committed))
    if committed >= 0 and os.path.isdir(old_gen):
        shutil.rmtree(old_gen)
    for stale in (base + ".npz", base + ".meta.json"):
        if os.path.exists(stale):
            os.remove(stale)
    _clear_markers(base)


def _run_save(base: str, flat: Dict[str, Any], meta: Dict,
              committed: int, gen: int, *, chunk_bytes: int,
              commit_timeout: float, barriers: bool):
    """Stream this rank's blocks and run the commit.  ``barriers=True``
    is the sync path (barriers around the commit); ``barriers=False``
    the async writer thread's, which issues no collective and commits
    through the marker files alone."""
    nproc, me = mesh.world_size(), mesh.rank()
    meta.setdefault("save_process_count", nproc)
    arrays, mine = _plan_writes(flat, gen)
    manifest = {"format": FORMAT_VERSION, "generation": gen,
                "meta": meta, "arrays": arrays}
    crcs = {ent["file"]: _stream_write(os.path.join(base, ent["file"]),
                                       leaf, chunk_bytes)
            for ent, leaf in mine}
    if nproc > 1:
        _write_marker(base, gen, me, crcs)
        if barriers:
            _barrier("ckpt-shards")
        if me == 0:
            _merge_markers(base, gen, nproc, manifest,
                           timeout=commit_timeout)
            _commit(base, manifest, committed)
        elif not barriers:
            _await_commit(base, gen, commit_timeout)
        if barriers:
            _barrier("ckpt-commit")
    else:
        _apply_crcs(manifest, crcs)
        _commit(base, manifest, committed)


def save(path: str, params, opt_state, step: int, tokens_seen: int,
         extra: Optional[Dict[str, Any]] = None, *,
         chunk_bytes: int = DEFAULT_CHUNK_BYTES,
         commit_timeout: float = DEFAULT_COMMIT_TIMEOUT):
    """Write a checkpoint directory at ``path`` (a trailing ``.npz`` is
    stripped) from the trees ``params`` and ``opt_state`` (tensors on any
    device, numpy arrays, :class:`Stacked`); blocks until committed.
    Collective in a multi-process run: every rank calls it.  For saves
    that overlap training, use :class:`CheckpointManager`."""
    base = _base(path)
    flat = _flat_state(params, opt_state)
    committed, gen = _prepare(base)
    meta = {"step": int(step), "tokens_seen": tokens_seen,
            **(extra or {})}
    _run_save(base, flat, meta, committed, gen, chunk_bytes=chunk_bytes,
              commit_timeout=commit_timeout, barriers=True)


def _materialize(leaf) -> np.ndarray:
    if isinstance(leaf, Sharded):
        raise ValueError("save_npz writes whole leaves; a mesh saves "
                         "with save()")
    if isinstance(leaf, Stacked):
        return np.stack([_to_host(t) for t in leaf])
    return np.array(_to_host(leaf))


def save_npz(path: str, params, opt_state, step: int, tokens_seen,
             extra: Optional[Dict[str, Any]] = None):
    """The legacy writer: one ``<base>.npz`` with every array on the host
    plus ``<base>.meta.json``.  Kept to make old-format fixtures."""
    base = _base(path)
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    flat = {k: _materialize(v)
            for k, v in _flat_state(params, opt_state).items()}
    np.savez(base + ".npz", **flat)
    meta = {"step": step, "tokens_seen": tokens_seen, **(extra or {})}
    with open(base + ".meta.json", "w") as f:
        json.dump(meta, f)


# --------------------------------------------------------------------- #
# async manager
# --------------------------------------------------------------------- #

def snapshot_tree(tree):
    """A copy of every leaf, on its device: the training step updates
    the live tensors in place (a captured graph replay, on the same
    stream), so the writer thread must read a copy made before the next
    step."""
    if isinstance(tree, dict):
        return {k: snapshot_tree(v) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree.with_local(snapshot_tree(tree.local))
    if isinstance(tree, Stacked):
        return Stacked(t.detach().clone() for t in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(snapshot_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return np.array(tree)


def _cuda_device(tree) -> Optional[torch.device]:
    for leaf in _flatten(tree).values():
        if isinstance(leaf, Sharded):
            leaf = leaf.local
        t = leaf[0] if isinstance(leaf, Stacked) else leaf
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            return t.device
    return None


@dataclass
class _SaveJob:
    base: str
    params: Any
    opt_state: Any
    meta: Dict[str, Any]
    chunk_bytes: int
    # recorded on the caller's stream behind the snapshot's copies
    ready: Optional[Any] = None
    device: Optional[torch.device] = None
    # the generation agreed at request time (multi-process); None: the
    # writer thread reads it (one process)
    committed: Optional[int] = None
    gen: Optional[int] = None


class CheckpointManager:
    """Async, at-most-one-in-flight checkpoint writer.

    ``request_save`` copies the state on its device (the snapshot) and
    returns; a writer thread streams the copy device→host→disk and
    commits.  On the card the snapshot's copies are queued on the
    caller's stream ahead of the next step, and the writer reads them on
    a stream of its own once an event behind them has fired, so the
    step loop waits only for the copies' dispatch.  In one process,
    while a save streams only the newest pending request survives
    (requests coalesce to first + newest).  In a multi-process run
    ``request_save`` is collective (every rank calls it at the same
    boundary): each request first joins the one in flight, then agrees
    on the generation on the calling thread, so the writer threads
    issue no collective and every rank saves the same sequence.  A
    writer exception (a :class:`CheckpointTimeoutError` when a peer
    died) is re-raised at the next ``check()`` / ``request_save`` /
    ``finalize`` and then cleared; ``finalize`` joins at exit."""

    def __init__(self, *, plan=None, seq_len: Optional[int] = None,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 commit_timeout: float = DEFAULT_COMMIT_TIMEOUT):
        self.plan = plan
        self.seq_len = seq_len
        self.chunk_bytes = chunk_bytes
        self.commit_timeout = commit_timeout
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[_SaveJob] = None
        self._error: Optional[BaseException] = None
        self.saves_started = 0           # introspection (tests, bench)
        self.saves_committed = 0
        self.last_stall_s = 0.0          # time the caller was blocked
        self.last_write_s = 0.0          # stream + commit of the last save

    # -- error surfacing ------------------------------------------------ #
    def check(self):
        """Re-raise a writer failure (once), e.g. at each chunk boundary
        of the step loop."""
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    @property
    def in_flight(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- requests -------------------------------------------------------- #
    def request_save(self, path: str, params, opt_state, step: int,
                     tokens_seen: int,
                     extra: Optional[Dict[str, Any]] = None, *,
                     block: bool = False):
        """Snapshot the state and schedule its save; ``block=True`` waits
        for the commit."""
        t0 = time.monotonic()
        self.check()
        meta: Dict[str, Any] = {"step": int(step),
                                "tokens_seen": tokens_seen}
        if self.plan is not None:
            ph = _plan_phase(self.plan, exact_tokens(tokens_seen),
                             self.seq_len)
            meta.update({"phase": ph.index,
                         "batch_size": ph.batch_size,
                         "schedule_kind": self.plan.kind,
                         "total_tokens": self.plan.total_tokens})
        meta.update(extra or {})
        multiproc = mesh.world_size() > 1
        if multiproc:
            # every rank's save sequence stays the same whatever its
            # writer's speed: requests run one after another
            self.wait()
            self.check()
        job = _SaveJob(base=_base(path), params=snapshot_tree(params),
                       opt_state=snapshot_tree(opt_state), meta=meta,
                       chunk_bytes=self.chunk_bytes)
        job.device = _cuda_device((params, opt_state))
        if job.device is not None:
            job.ready = torch.cuda.Event()
            job.ready.record(torch.cuda.current_stream(job.device))
        if multiproc:
            job.committed, job.gen = _prepare(job.base)
            with self._lock:
                self._start_locked(job)
        else:
            with self._lock:
                if self._thread is not None and self._thread.is_alive():
                    self._pending = job      # coalesce: newest wins
                else:
                    self._start_locked(job)
        self.last_stall_s = time.monotonic() - t0
        if block:
            self.wait()
            self.check()

    def _start_locked(self, job: _SaveJob):
        self.saves_started += 1
        self._thread = threading.Thread(
            target=self._worker, args=(job,), daemon=True,
            name="ckpt-writer")
        self._thread.start()

    # -- writer thread --------------------------------------------------- #
    def _worker(self, job: _SaveJob):
        while True:
            try:
                self._execute(job)
                with self._lock:
                    self.saves_committed += 1
            except BaseException as e:       # surfaced via check()
                with self._lock:
                    self._error = e
                    self._pending = None
                    self._thread = None
                return
            with self._lock:
                job, self._pending = self._pending, None
                if job is None:
                    self._thread = None
                    return
                self.saves_started += 1

    def _execute(self, job: _SaveJob):
        t0 = time.monotonic()
        if job.gen is None:                  # one process
            committed, gen = _prepare(job.base, collective=False)
        else:
            committed, gen = job.committed, job.gen
        flat = _flat_state(job.params, job.opt_state)
        kw = dict(chunk_bytes=job.chunk_bytes,
                  commit_timeout=self.commit_timeout, barriers=False)
        if job.device is None:
            _run_save(job.base, flat, dict(job.meta), committed, gen, **kw)
        else:
            stream = torch.cuda.Stream(device=job.device)
            stream.wait_event(job.ready)
            with torch.cuda.stream(stream):
                _run_save(job.base, flat, dict(job.meta), committed, gen,
                          **kw)
            stream.synchronize()
        self.last_write_s = time.monotonic() - t0

    # -- joining --------------------------------------------------------- #
    def wait(self, timeout: Optional[float] = None):
        """Join the in-flight save and any pending coalesced request."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            with self._lock:
                t = self._thread
            if t is None or not t.is_alive():
                return
            t.join(0.05 if deadline is None
                   else max(min(deadline - time.monotonic(), 0.05), 0))
            if deadline is not None and time.monotonic() > deadline:
                raise CheckpointTimeoutError(
                    f"async checkpoint writer did not finish within "
                    f"{timeout:.0f}s")

    def finalize(self):
        """Join at exit and surface any writer error."""
        self.wait()
        self.check()


# --------------------------------------------------------------------- #
# restore
# --------------------------------------------------------------------- #

def _fill_block(out: np.ndarray, box: Block, saved_blocks):
    """Fill ``out`` (the box ``box`` of the array) from the saved blocks
    that overlap it; each ``reader()`` memory-maps one block file, so only
    the overlapping bytes are read."""
    for sb, reader in saved_blocks:
        lo = tuple(max(a, c) for (a, _), (c, _) in zip(box, sb))
        hi = tuple(min(b, d) for (_, b), (_, d) in zip(box, sb))
        if any(lo_ >= hi_ for lo_, hi_ in zip(lo, hi)):
            continue
        src_sl = tuple(slice(l_ - c, h_ - c)
                       for l_, h_, (c, _) in zip(lo, hi, sb))
        dst_sl = tuple(slice(l_ - a, h_ - a)
                       for l_, h_, (a, _) in zip(lo, hi, box))
        out[dst_sl] = reader()[src_sl]


def _entry_blocks(entry, base):
    """(saved block, lazy reader) per block file of a manifest entry;
    0-d arrays are read eagerly."""
    out = []
    for sh in entry["shards"]:
        blk = tuple(zip(sh["start"], sh["stop"]))
        fpath = os.path.join(base, sh["file"])
        if blk:
            out.append((blk, lambda p=fpath: np.load(p, mmap_mode="r")))
        else:
            out.append((blk, lambda p=fpath: np.load(p)))
    return out


def _verify_manifest(base: str, manifest: Dict):
    """Check every block file against its manifest crc32 (reads every
    byte of the checkpoint)."""
    unchecked = []
    for key, entry in manifest["arrays"].items():
        for sh in entry["shards"]:
            fpath = os.path.join(base, sh["file"])
            if "crc32" not in sh:
                unchecked.append(sh["file"])
                continue
            try:
                got = _crc_of_file(fpath)
            except FileNotFoundError:
                raise CheckpointCorruptionError(
                    f"block {sh['file']} of {key!r} is named by the "
                    f"manifest but missing on disk") from None
            if got != sh["crc32"]:
                raise CheckpointCorruptionError(
                    f"checksum mismatch in block {sh['file']} of "
                    f"{key!r}: manifest crc32={sh['crc32']}, file "
                    f"crc32={got} — the checkpoint is corrupt; restore "
                    f"an older copy or retrain from the previous "
                    f"checkpoint")
    if unchecked:
        warnings.warn(
            f"{len(unchecked)} block(s) carry no checksum "
            f"(pre-checksum manifest); skipped verification for them",
            stacklevel=3)


def _assign(dst, arr: np.ndarray):
    """``arr`` into ``dst`` in place where ``dst`` is a tensor or a
    writable array of its shape; else a new array."""
    if isinstance(dst, torch.Tensor):
        with torch.no_grad():
            dst.copy_(torch.from_numpy(np.ascontiguousarray(arr))
                      .reshape(dst.shape))
        return dst
    if isinstance(dst, np.ndarray) and dst.flags.writeable and \
            dst.shape == arr.shape:
        dst[...] = arr
        return dst
    return np.array(arr)


def _check_leaf(key: str, template, gshape, saved_blocks):
    """Refuse a leaf before anything is copied: its shape against the
    state's, and each block file's ``.npy`` header (opened, memory-mapped
    and not read) against the block's shape.  The values are cast to the
    state's dtype, as the reference does."""
    shape, _ = _leaf_meta(template)
    if tuple(gshape) != tuple(shape):
        raise ValueError(f"checkpoint leaf {key!r} has shape "
                         f"{tuple(gshape)}, the state {tuple(shape)}")
    for box, reader in saved_blocks:
        want = tuple(b - a for a, b in box)
        try:
            got = tuple(np.shape(reader()))
        except (OSError, ValueError) as e:
            raise CheckpointCorruptionError(
                f"a block of {key!r} is unreadable: {e}") from e
        if got != want:
            raise CheckpointCorruptionError(
                f"a block of {key!r} holds shape {got}, the manifest "
                f"says {want}")


def _restore_leaf(template, saved_blocks):
    """Read one checked leaf into ``template``: a :class:`Stacked` layer
    by layer (one layer's slice of the file at a time), a
    :class:`Sharded` leaf's block (layer by layer when stacked),
    anything else whole."""
    shape, dtype = _leaf_meta(template)
    if isinstance(template, Sharded):
        box = template.box
        if isinstance(template.local, Stacked):
            for i, t in enumerate(template.local):
                layer = np.empty((1,) + tuple(t.shape), dtype)
                _fill_block(layer, ((i, i + 1),) + box[1:], saved_blocks)
                _assign(t, layer[0])
            return template
        out = np.empty(tuple(b - a for a, b in box), dtype)
        _fill_block(out, box, saved_blocks)
        _assign(template.local, out)
        return template
    if isinstance(template, Stacked):
        rest = _full_block(shape[1:])
        for i, t in enumerate(template):
            box = ((i, i + 1),) + rest
            layer = np.empty((1,) + tuple(shape[1:]), dtype)
            _fill_block(layer, box, saved_blocks)
            _assign(t, layer[0])
        return template
    if not shape:                               # scalars: read eagerly
        return _assign(template, np.asarray(saved_blocks[0][1](), dtype))
    out = np.empty(shape, dtype)
    _fill_block(out, _full_block(shape), saved_blocks)
    return _assign(template, out)


def _restore_flat(lookup, params_template, opt_template):
    """Every leaf is looked up and checked before the first is copied,
    so a refused checkpoint leaves the live state as it was."""
    trees = []
    for prefix, template in (("p:", params_template), ("o:", opt_template)):
        leaves = {}
        for k, tmpl in _flatten(template).items():
            try:
                gshape, blocks = lookup(prefix + k)
            except KeyError:
                raise KeyError(f"checkpoint has no leaf {prefix + k!r}"
                               ) from None
            _check_leaf(prefix + k, tmpl, gshape, blocks)
            leaves[k] = (tmpl, blocks)
        trees.append((template, leaves))
    out = [_unflatten(template, {k: _restore_leaf(t, b)
                                 for k, (t, b) in leaves.items()})
           for template, leaves in trees]
    return out[0], out[1]


def _restore_manifest(base: str, params_template, opt_template,
                      verify: bool):
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    if verify:
        _verify_manifest(base, manifest)

    def lookup(key):
        entry = manifest["arrays"][key]
        return tuple(entry["shape"]), _entry_blocks(entry, base)

    p, o = _restore_flat(lookup, params_template, opt_template)
    return p, o, manifest["meta"]


def _restore_legacy_npz(base: str, params_template, opt_template):
    data = np.load(base + ".npz")
    with open(base + ".meta.json") as f:
        meta = json.load(f)

    def lookup(key):
        arr = data[key]
        return arr.shape, [(_full_block(arr.shape), lambda a=arr: a)]

    p, o = _restore_flat(lookup, params_template, opt_template)
    return p, o, meta


def restore(path: str, params_template, opt_template, *,
            verify: bool = False) -> Tuple[Any, Any, Dict[str, Any]]:
    """Restore ``(params, opt_state, meta)`` from a checkpoint directory
    or a legacy ``.npz``.  Tensor leaves of the templates (and writable
    arrays of the right shape) are filled in place and returned as they
    are; other leaves come back as new arrays.  ``verify=True`` checks
    every block against its manifest crc32 first and raises
    :class:`CheckpointCorruptionError` naming the bad block."""
    base = _base(path)
    if os.path.exists(os.path.join(base, "manifest.json")):
        return _restore_manifest(base, params_template, opt_template,
                                 verify)
    if os.path.exists(base + ".npz"):
        if verify:
            warnings.warn("legacy .npz checkpoints carry no "
                          "checksums; --verify-restore skipped",
                          stacklevel=2)
        return _restore_legacy_npz(base, params_template, opt_template)
    raise FileNotFoundError(
        f"no checkpoint at {path!r}: neither {base}/manifest.json "
        f"(sharded directory) nor {base}.npz (legacy single-file)")


def read_meta(path: str) -> Dict[str, Any]:
    """A checkpoint's metadata alone, no array read.  The adaptive
    trainer needs it first: the saved controller state rebuilds the plan
    the phase check must run against."""
    base = _base(path)
    manifest = os.path.join(base, "manifest.json")
    if os.path.exists(manifest):
        with open(manifest) as f:
            return json.load(f)["meta"]
    legacy = base + ".meta.json"
    if os.path.exists(legacy):
        with open(legacy) as f:
            return json.load(f)
    raise FileNotFoundError(
        f"no checkpoint at {path!r}: neither {base}/manifest.json "
        f"(sharded directory) nor {base}.meta.json (legacy)")


def exact_tokens(tokens_seen) -> int:
    """A checkpoint's ``tokens_seen`` as an exact int.  An int passes
    through (JSON ints are exact past 2^53); a legacy float is accepted
    when it is exactly an integer, and otherwise rounded with a
    warning."""
    if isinstance(tokens_seen, int):
        return tokens_seen
    f = float(tokens_seen)
    if not f.is_integer():
        warnings.warn(
            f"legacy checkpoint tokens_seen={f!r} is not exactly "
            f"representable as an int; rounding to {int(round(f))} — "
            f"the resumed data position may be off by up to one step",
            stacklevel=2)
    elif abs(f) >= 2.0 ** 53:
        warnings.warn(
            f"legacy float tokens_seen={f!r} exceeds 2^53: the true "
            f"token count may have been rounded at save time",
            stacklevel=2)
    return int(round(f))


# --------------------------------------------------------------------- #
# phase-aware save/resume
# --------------------------------------------------------------------- #

def _plan_phase(plan, tokens_seen: int, seq_len):
    """Phase the next step belongs to: realized (step-quantized)
    boundaries when ``seq_len`` is known, ideal ones otherwise."""
    if seq_len:
        return plan.realized_phase_at(tokens_seen, seq_len)
    return plan.phase_at_tokens(tokens_seen)


def save_phase_checkpoint(path: str, params, opt_state, step: int,
                          tokens_seen: int, *, plan,
                          seq_len: Optional[int] = None,
                          extra: Optional[Dict[str, Any]] = None,
                          chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                          commit_timeout: float = DEFAULT_COMMIT_TIMEOUT):
    """:func:`save` plus the plan position at ``tokens_seen``: the phase
    of the next step and its batch size."""
    ph = _plan_phase(plan, tokens_seen, seq_len)
    meta = {"phase": ph.index, "batch_size": ph.batch_size,
            "schedule_kind": plan.kind,
            "total_tokens": plan.total_tokens, **(extra or {})}
    save(path, params, opt_state, step, tokens_seen, extra=meta,
         chunk_bytes=chunk_bytes, commit_timeout=commit_timeout)


def restore_phase_checkpoint(path: str, params_template, opt_template,
                             *, plan, seq_len: Optional[int] = None,
                             verify: bool = False
                             ) -> Tuple[Any, Any, Dict[str, Any]]:
    """:func:`restore`, after checking that this plan puts the saved
    ``tokens_seen`` in the recorded phase with the recorded batch size
    (else the resumed run would train with the wrong step or LR).  The
    check reads the metadata alone, so a refused checkpoint leaves the
    templates' tensors as they were."""
    meta = read_meta(path)
    if "phase" in meta:
        tok = exact_tokens(meta["tokens_seen"])
        ph = _plan_phase(plan, tok, seq_len)
        if (ph.index != meta["phase"]
                or ph.batch_size != meta["batch_size"]):
            raise ValueError(
                f"checkpoint was saved in phase {meta['phase']} "
                f"(batch {meta['batch_size']}) but this plan puts "
                f"tokens_seen={tok} in phase "
                f"{ph.index} (batch {ph.batch_size}) — schedule "
                f"mismatch between save and resume")
    return restore(path, params_template, opt_template, verify=verify)
