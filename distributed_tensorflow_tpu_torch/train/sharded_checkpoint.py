"""Sharded checkpoints: every process writes only its own chunks.

Counterpart of ``distributed_tensorflow_tpu/train/sharded_checkpoint.py``,
in its on-disk format, so either package restores the other's:

  * **Save**: every process writes one ``shards-{pid:05d}.npz`` holding
    the chunks of each leaf that it owns, and its chunk index
    ``chunks-{pid:05d}.json`` (each chunk's leaf, ``start``, ``shape``,
    ``pid`` and masked CRC32-C) after it; the chief (pid 0) writes
    ``manifest.json`` (leaf ``keystr`` paths, global shapes, dtypes, the
    process count) last of its files.  A checkpoint is complete when the
    manifest and every process's two files are there (structural
    completeness, no save-time barrier).
  * **Restore**: each process reads the box of each leaf that it holds
    from whatever saved chunks overlap it, so the layout may differ from
    the saved one (fsdp 2 onto 4 or onto 1, the JAX package's data 4 x
    fsdp 2 onto the port's 2 ranks).

The port's state goes through ``models.convert.train_state_to_jax`` as
the plain checkpoint's does: the paths and global shapes are the JAX
tree's, so a decoder leaf is stacked ``[L, ...]`` and a rank's chunk of
it is the box ``[0:L, a:b, ...]`` built from its per-layer blocks.  A
block of a ZeRO, tensor- or expert-parallel layout
(``train.shard_train_state``; a MoE bank's block on ``expert`` x
``tensor`` and the ``fsdp`` part of a tensor block on ``fsdp`` x
``tensor`` are boxes cut along two dims, each dim's start the whole
leaf's) is written by the rank at index 0 of every axis that does not
cut it (the first rank of its ``data`` line for a box cut over every
other axis, and of its ``seq`` line too beside a ``seq`` axis, whose
ranks hold the same blocks: ``replica_id == 0`` in the JAX package), a
whole leaf and
every host value by the chief, so each element is written once.  A
pipeline stage's layers (a ``Stage`` layout) are the box ``[a:b, ...]``
of their stacked leaf, written by the first rank of the stage's
``data`` line: each stage's layers once, and a restore onto another
layout (a whole model on one rank) reads every stage's box.  Restore
writes each block IN PLACE into the target's tensors; the next step's
gather rebuilds the full parameters.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import convert
from ..obs import goodput as goodput_lib
from ..parallel.sharding import ShardedDict, Stage, lines_of
from . import checkpoint as _plain

__all__ = ["save_sharded", "restore_sharded", "is_sharded_checkpoint",
           "is_complete_sharded_checkpoint", "all_sharded_checkpoints",
           "verify_sharded", "restore_latest_good_sharded",
           "AsyncShardedCheckpointer"]

_SHARD_FILE = "shards-{pid:05d}.npz"


def _chunk_key(leaf_i: int, start: Sequence[int]) -> str:
    return f"leaf_{leaf_i}@" + ",".join(str(int(s)) for s in start)


def _process() -> Tuple[int, int]:
    """(this process's rank, the process count) of the initialised
    ``torch.distributed`` group, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True, eq=False)
class _Piece:
    """One leaf of the JAX tree as this process holds it: its chunk
    (``data``: None for a restore target), the leaf's global shape, the
    chunk's start and shape in it, its type, and whether this process
    writes it; a pipeline stage's layer also its index and the layer
    count (its stack's leading dim)."""
    data: Optional[torch.Tensor]
    shape: Tuple[int, ...]
    start: Tuple[int, ...]
    chunk: Tuple[int, ...]
    dtype: torch.dtype
    owner: bool
    layer: Optional[int] = None
    layers: Optional[int] = None


def _blocks(tree, out: Dict[int, Any]) -> None:
    """{id(tensor): (its ``Shard``, ``Blocks`` or ``Stage``, whether this
    rank writes it)} of every block of a ZeRO, tensor- or
    expert-parallel layout and every layer of a pipeline stage in
    ``tree``: the rank at index 0 of every axis that does not cut the
    leaf writes it (the first rank of its ``data`` line, and beside
    ``fsdp`` the first of its ``fsdp`` line too for a leaf that only
    ``tensor`` cuts), so each box is written once."""
    if isinstance(tree, ShardedDict):
        mesh = tree.mesh
        for name, t in tree.items():
            s = tree.layout[name]
            if s is not None:
                lines = lines_of(s)
                out[id(t)] = (s, all(mesh.axis_index(a) == 0
                                     for a in mesh.shape if a not in lines))
        return
    if isinstance(tree, dict):
        for v in tree.values():
            _blocks(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _blocks(v, out)


def _pieces(tree, pid: int, with_data: bool) -> Any:
    """The JAX tree of a port state with a ``_Piece`` a leaf."""
    blocks: Dict[int, Any] = {}
    _blocks(tree, blocks)

    def leaf(t: torch.Tensor) -> _Piece:
        shape = tuple(t.shape)
        data = t if with_data else None
        if id(t) not in blocks:
            return _Piece(data, shape, (0,) * len(shape), shape, t.dtype,
                          pid == 0)
        shard, first = blocks[id(t)]
        if isinstance(shard, Stage):
            return _Piece(data, shape, (0,) * len(shape), shape, t.dtype,
                          first, shard.layer, shard.layers)
        start = [0] * len(shape)
        for part in shard.parts:
            start[part.dim] = part.start
        return _Piece(data, shard.full_shape(shape), tuple(start), shape,
                      t.dtype, first)

    def stack(rows: List[_Piece]) -> _Piece:
        r = rows[0]
        data = (torch.stack([x.data.detach() for x in rows]) if with_data
                else None)
        if r.layer is None:
            return _Piece(data, (len(rows),) + r.shape, (0,) + r.start,
                          (len(rows),) + r.chunk, r.dtype, r.owner)
        if [x.layer for x in rows] != list(range(r.layer,
                                                 r.layer + len(rows))):
            raise ValueError("a pipeline stage's layers are not one run: "
                             f"{[x.layer for x in rows]}")
        return _Piece(data, (r.layers,) + r.shape, (r.layer,) + r.start,
                      (len(rows),) + r.chunk, r.dtype, r.owner)

    return convert.train_state_to_jax(tree, leaf=leaf, stack=stack)


def _dtype_name(dtype: torch.dtype) -> str:
    return _plain._NUMPY.get(dtype) or _plain._BITS[dtype]


def _snapshot_local(tree, pid: int):
    """Device to host copy of this process's chunks (on the caller's
    thread: the next step updates the tensors in place).  Returns (chunk
    arrays, chunk index rows, leaf metadata)."""
    flat = _plain._flatten(_pieces(tree, pid, with_data=True))
    chunks: Dict[str, np.ndarray] = {}
    rows: List[Dict[str, Any]] = []
    metas: List[Dict[str, Any]] = []
    for i, (path, pc) in enumerate(flat):
        metas.append({"path": path, "shape": list(pc.shape),
                      "dtype": _dtype_name(pc.dtype), "kind": "sharded"})
        if not pc.owner:
            continue
        arr, _ = _plain._stored(pc.data.detach().to("cpu", copy=True))
        chunks[_chunk_key(i, pc.start)] = arr
        rows.append({"leaf": i, "start": list(pc.start),
                     "shape": list(arr.shape), "pid": pid,
                     "crc32c": _plain._leaf_crc(arr)})
    return chunks, rows, metas


def _write_local(ckpt_dir: str, step: int, pid: int, nproc: int,
                 chunks: Dict[str, np.ndarray], rows: List[Dict[str, Any]],
                 metas: List[Dict[str, Any]], max_to_keep: int) -> str:
    """The disk half of a save (any thread, no collective): the shard
    file, then the chunk index (this process's commit marker), then on
    the chief the manifest, the index file and the pruning."""
    final = _plain.ckpt_path(ckpt_dir, step)
    os.makedirs(final, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".shard-tmp-", dir=final)
    os.close(fd)
    ctmp = os.path.join(final, f".chunks-tmp-{pid:05d}")
    mtmp = os.path.join(final, ".manifest-tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **chunks)
        os.replace(tmp, os.path.join(final, _SHARD_FILE.format(pid=pid)))
        with open(ctmp, "w") as f:
            json.dump(rows, f)
        os.replace(ctmp, os.path.join(final, f"chunks-{pid:05d}.json"))
        if pid == 0:
            manifest = {"step": int(step), "format": "sharded-v1",
                        "process_count": nproc, "leaves": metas}
            with open(mtmp, "w") as f:
                json.dump(manifest, f, indent=1)
            os.replace(mtmp, os.path.join(final, "manifest.json"))
            _plain.write_index(ckpt_dir, os.path.basename(final))
            if max_to_keep and max_to_keep > 0:
                _prune(ckpt_dir, max_to_keep)
    except Exception:
        for t in (tmp, ctmp, mtmp):
            if os.path.exists(t):
                os.unlink(t)
        raise
    return final


def _prune(ckpt_dir: str, max_to_keep: int) -> None:
    """Delete old checkpoints, incomplete dirs older than the oldest kept
    complete one included (a save torn by a crashed process); a save in
    progress is newer than every complete one and stays."""
    kept = all_sharded_checkpoints(ckpt_dir)[-max_to_keep:]
    if not kept:
        return
    cutoff = int(_plain._CKPT_RE.match(os.path.basename(kept[0])).group(1))
    for name in os.listdir(ckpt_dir):
        m = _plain._CKPT_RE.match(name)
        if m and int(m.group(1)) < cutoff:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def save_sharded(ckpt_dir: str, step: int, tree: Any, max_to_keep: int = 5,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 sync_fn=None) -> str:
    """Write this process's chunks of ``tree`` (a port ``TrainState``,
    plain or placed by ``shard_train_state``).  Every process must call
    it; no barrier is needed (structural completeness).  ``sync_fn``,
    when given, runs after the local write (a barrier, so that "save
    returned" means "complete everywhere").  The process index and count
    default to the ``torch.distributed`` group's.  Returns the
    checkpoint dir."""
    pid, nproc = _process()
    pid = pid if process_index is None else process_index
    nproc = nproc if process_count is None else process_count
    chunks, rows, metas = _snapshot_local(tree, pid)
    final = _write_local(ckpt_dir, step, pid, nproc, chunks, rows, metas,
                         max_to_keep)
    if sync_fn is not None:
        sync_fn()
    return final


class AsyncShardedCheckpointer(_plain.AsyncWriterBase):
    """Background sharded writes: the chunk snapshot on the caller's
    thread, the files on the worker thread.  Needs no collective (the
    format's completeness is structural), so a background save never
    races the training loop's collectives."""

    def __init__(self):
        super().__init__(thread_name_prefix="sharded-ckpt-writer")

    def save(self, ckpt_dir: str, step: int, tree: Any,
             max_to_keep: int = 5, process_index: Optional[int] = None,
             process_count: Optional[int] = None):
        pid, nproc = _process()
        pid = pid if process_index is None else process_index
        nproc = nproc if process_count is None else process_count
        self._raise_failed()
        chunks, rows, metas = _snapshot_local(tree, pid)
        return self._submit(_write_local, ckpt_dir, step, pid, nproc,
                            chunks, rows, metas, max_to_keep)


def _manifest(ckpt_path: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_path, "manifest.json")) as f:
        return json.load(f)


def is_sharded_checkpoint(ckpt_path: str) -> bool:
    if not os.path.exists(os.path.join(ckpt_path, "manifest.json")):
        return False
    return _manifest(ckpt_path).get("format") == "sharded-v1"


def is_complete_sharded_checkpoint(ckpt_path: str) -> bool:
    """The manifest and every process's shard and chunk-index files are
    there (an older manifest embedding its chunk index counts alone)."""
    if not os.path.exists(os.path.join(ckpt_path, "manifest.json")):
        return False
    manifest = _manifest(ckpt_path)
    if manifest.get("format") != "sharded-v1":
        return False
    if "chunks" in manifest:
        return True
    return all(
        os.path.exists(os.path.join(ckpt_path, _SHARD_FILE.format(pid=p)))
        and os.path.exists(os.path.join(ckpt_path, f"chunks-{p:05d}.json"))
        for p in range(int(manifest.get("process_count", 1))))


def all_sharded_checkpoints(ckpt_dir: str) -> List[str]:
    """Complete sharded checkpoints, oldest to newest."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = _plain._CKPT_RE.match(name)
        path = os.path.join(ckpt_dir, name)
        if m and is_complete_sharded_checkpoint(path):
            found.append((int(m.group(1)), path))
    return [p for _, p in sorted(found)]


def _chunk_rows(ckpt_path: str, manifest: Dict[str, Any]) -> List[Dict]:
    if "chunks" in manifest:                   # the older embedded index
        return manifest["chunks"]
    rows = []
    for p in range(int(manifest.get("process_count", 1))):
        with open(os.path.join(ckpt_path, f"chunks-{p:05d}.json")) as f:
            rows.extend(json.load(f))
    return rows


class _ChunkReader:
    """Reads boxes of leaves from every process's shard file."""

    def __init__(self, ckpt_path: str, manifest: Dict[str, Any]):
        self._path = ckpt_path
        self._files: Dict[int, Any] = {}
        self._by_leaf: Dict[int, List[Tuple[Tuple[int, ...],
                                            Tuple[int, ...], int]]] = {}
        for c in _chunk_rows(ckpt_path, manifest):
            self._by_leaf.setdefault(int(c["leaf"]), []).append(
                (tuple(c["start"]), tuple(c["shape"]), int(c["pid"])))

    def _file(self, pid: int):
        if pid not in self._files:
            self._files[pid] = np.load(
                os.path.join(self._path, _SHARD_FILE.format(pid=pid)))
        return self._files[pid]

    def read(self, leaf_i: int, start: Sequence[int],
             shape: Sequence[int]) -> np.ndarray:
        """The box ``[start, start + shape)`` of leaf ``leaf_i``, as stored
        (a bf16 leaf as its bits), assembled from the saved chunks that
        overlap it."""
        stop = [a + n for a, n in zip(start, shape)]
        chunks = self._by_leaf.get(leaf_i, [])
        for cstart, cshape, pid in chunks:
            if cstart == tuple(start) and cshape == tuple(shape):
                # the box is one saved chunk (the layout it was saved
                # from): no assembly
                return self._file(pid)[_chunk_key(leaf_i, cstart)]
        out = filled = None
        for cstart, cshape, pid in chunks:
            lo = [max(a, s) for a, s in zip(start, cstart)]
            hi = [min(b, s + c) for b, s, c in zip(stop, cstart, cshape)]
            if any(x >= y for x, y in zip(lo, hi)):
                continue                                  # no overlap
            chunk = self._file(pid)[_chunk_key(leaf_i, cstart)]
            if out is None:
                out = np.empty(tuple(shape), chunk.dtype)
                filled = np.zeros(tuple(shape), np.bool_)
            src = tuple(slice(x - s, y - s)
                        for x, s, y in zip(lo, cstart, hi))
            dst = tuple(slice(x - a, y - a) for x, a, y in zip(lo, start, hi))
            out[dst] = chunk[src]
            filled[dst] = True
        if out is None or not filled.all():
            raise ValueError(
                f"checkpoint chunks do not cover leaf {leaf_i} at "
                f"{tuple(start)} + {tuple(shape)}: missing shard files?")
        return out

    def close(self):
        for f in self._files.values():
            f.close()


def restore_sharded(target: Any, ckpt_path: str) -> Any:
    """Load a sharded checkpoint into ``target`` (a port state, plain or
    placed by ``shard_train_state``, on any layout): each tensor receives
    its box of its leaf IN PLACE; returns the target's structure with the
    restored host values (step, counts)."""
    manifest = _manifest(ckpt_path)
    if manifest.get("format") != "sharded-v1":
        raise ValueError(f"{ckpt_path} is not a sharded-v1 checkpoint")
    if not is_complete_sharded_checkpoint(ckpt_path):
        raise ValueError(
            f"{ckpt_path} is structurally INCOMPLETE (a process's shard or "
            "chunk files never landed: a crashed or pending save); pick a "
            "complete one with all_sharded_checkpoints()")
    pieces = _pieces(target, 0, with_data=False)
    flat = _plain._flatten(pieces)
    metas = manifest["leaves"]
    if len(flat) != len(metas):
        raise ValueError(f"checkpoint has {len(metas)} leaves but target "
                         f"has {len(flat)}")
    reader = _ChunkReader(ckpt_path, manifest)
    leaves = []
    try:
        for i, ((path, pc), meta) in enumerate(zip(flat, metas)):
            if meta["path"] != path:
                raise ValueError(f"leaf {i} path mismatch: checkpoint "
                                 f"{meta['path']!r} vs target {path!r}")
            if tuple(meta["shape"]) != pc.shape:
                raise ValueError(f"leaf {path}: checkpoint shape "
                                 f"{tuple(meta['shape'])} vs target "
                                 f"{pc.shape}")
            box = reader.read(i, pc.start, pc.chunk)
            leaves.append(_plain._logical(box, meta["dtype"]).to(pc.dtype))
    finally:
        reader.close()
    return convert.train_state_from_jax(
        _plain._unflatten(pieces, iter(leaves)), target)


def verify_sharded(ckpt_path: str) -> Tuple[bool, str]:
    """Integrity check of one sharded checkpoint without restoring it:
    structural completeness, every indexed chunk present in its shard
    file with its recorded shape and masked CRC32-C, inside its leaf, and
    each leaf's chunk volumes summing to the leaf's (owners are disjoint,
    so equal volume is full coverage).  Returns ``(ok, reason)``; never
    raises."""
    try:
        manifest = _manifest(ckpt_path)
    except Exception as e:
        return False, f"unreadable manifest.json: {e!r}"
    if manifest.get("format") != "sharded-v1":
        return False, ("not a sharded-v1 checkpoint: "
                       f"{manifest.get('format')!r}")
    if not is_complete_sharded_checkpoint(ckpt_path):
        return False, ("structurally incomplete: a process's shard/"
                       "chunk-index files are missing")
    metas = manifest["leaves"]
    try:
        rows = _chunk_rows(ckpt_path, manifest)
    except Exception as e:
        return False, f"unreadable chunk index: {e!r}"
    covered = [0] * len(metas)
    files: Dict[int, Any] = {}
    try:
        for row in rows:
            leaf_i, start = int(row["leaf"]), tuple(row["start"])
            shape = tuple(row["shape"])
            if leaf_i >= len(metas):
                return False, f"chunk names leaf {leaf_i} beyond manifest"
            gshape = tuple(metas[leaf_i]["shape"])
            if len(start) != len(gshape) or any(
                    s + c > g for s, c, g in zip(start, shape, gshape)):
                return False, (f"leaf {leaf_i} chunk @{start} shape {shape} "
                               f"outside global shape {gshape}")
            pid = int(row["pid"])
            if pid not in files:
                files[pid] = np.load(os.path.join(
                    ckpt_path, _SHARD_FILE.format(pid=pid)))
            key = _chunk_key(leaf_i, start)
            if key not in files[pid].files:
                return False, (f"chunk {key} indexed but missing from "
                               f"shard file of process {pid}")
            arr = files[pid][key]
            if tuple(arr.shape) != shape:
                return False, (f"chunk {key} shape {tuple(arr.shape)} != "
                               f"indexed {shape}")
            want = row.get("crc32c")
            if want is not None and _plain._leaf_crc(arr) != want:
                return False, f"chunk {key} CRC mismatch"
            covered[leaf_i] += int(np.prod(shape, dtype=np.int64)) or 1
    except Exception as e:
        return False, f"unreadable shard file: {e!r}"
    finally:
        for f in files.values():
            f.close()
    for i, meta in enumerate(metas):
        want = int(np.prod(meta["shape"], dtype=np.int64)) or 1
        if covered[i] != want:
            return False, (f"leaf {i} ({meta['path']}) chunks cover "
                           f"{covered[i]} of {want} elements")
    return True, ""


def restore_latest_good_sharded(target: Any, ckpt_dir: str
                                ) -> Tuple[Optional[Any], Optional[str]]:
    """Walk every ``ckpt-*`` dir newest to oldest, restore the first that
    verifies and restores, quarantine the others (``checkpoint.
    quarantine``: ``corrupt-<name>`` with its reason).  An incomplete dir
    is quarantined too: at restore time no writer is in flight, so a
    missing chunk file is a torn save.  A plain checkpoint sharing the
    dir is skipped, not quarantined.  The walk is goodput's
    ``checkpoint_restore``.  Returns ``(state, path)`` or ``(None,
    None)``."""
    if not os.path.isdir(ckpt_dir):
        return None, None
    with goodput_lib.account("checkpoint_restore"):
        found = []
        for name in os.listdir(ckpt_dir):
            m = _plain._CKPT_RE.match(name)
            if m:
                found.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
        for _, path in sorted(found, reverse=True):
            ok, reason = verify_sharded(path)
            if ok:
                try:
                    return restore_sharded(target, path), path
                except Exception as e:
                    reason = f"restore failed: {e!r}"
            elif reason.startswith("not a sharded-v1"):
                continue
            try:
                _plain.quarantine(path, reason)
            except OSError:             # another process quarantined it
                pass
        return None, None
