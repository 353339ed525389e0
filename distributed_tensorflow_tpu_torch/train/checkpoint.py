"""Checkpoints of a training state, in the JAX package's on-disk format.

Counterpart of ``distributed_tensorflow_tpu/train/checkpoint.py``: the same
files, so a checkpoint written by either package restores into the other.

  * A checkpoint is a directory ``ckpt-{step:010d}`` holding
    ``arrays.npz`` (leaves in the JAX flatten order, ``leaf_{i}``) and
    ``manifest.json`` (each leaf's ``jax.tree_util.keystr`` path, shape,
    dtype and masked CRC32-C of its stored bytes).
  * Writes go to a temp dir and ``os.replace``; the ``checkpoint`` index
    file names the newest (itself tmp + ``os.replace``); ``max_to_keep``
    prunes.
  * ``verify`` checks structure and checksums without building a result;
    ``restore_latest_good`` walks newest to oldest and quarantines what
    fails (renamed ``corrupt-<name>``, with a ``QUARANTINE_REASON`` file).
  * bf16 and other extension dtypes are stored as same-width unsigned
    views, their manifest dtype naming the logical type.

The port's state becomes the JAX tree through
``models.convert.train_state_to_jax``: params-shaped dicts in the JAX GPT
layout (decoder leaves stacked ``[L, ...]``), host counts as int32 and so
on.  The paths are computed here as ``keystr`` prints them (NamedTuple
fields ``.name``, dict keys ``['key']`` in sorted order, sequence items
``[i]``, None holding no leaf), without JAX.

Restore copies IN PLACE into the target state's tensors (the model's own
parameters, the optimizer's moments, the EMA shadow), through
``train_state_from_jax``, and returns the target's structure with the
restored host values: it never rebinds a parameter.

The JAX package's instrumentation sites are here too: the active fault
plan's ``on_save`` (``save_oserror``) at the entry of a write and
``on_saved`` (``corrupt_checkpoint``) after its rename, on the writer's
thread as in the JAX package; the goodput bucket ``checkpoint_restore``
around the whole verified walk of ``restore_latest_good``; and each
quarantine counted in ``dttpu_checkpoints_quarantined_total`` and marked
as a ``checkpoint_quarantine`` trace instant.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..models import convert
from ..obs import goodput as goodput_lib
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..parallel.sharding import ShardedDict
from ..resilience import faults as faults_lib
from ..summary.crc32c import masked_crc32c

log = logging.getLogger(__name__)

__all__ = ["save", "restore", "restore_latest_good", "verify",
           "quarantine", "latest_checkpoint", "latest_step",
           "all_checkpoints", "write_index", "AsyncCheckpointer",
           "AsyncWriterBase", "ckpt_path"]

_CKPT_RE = re.compile(r"^ckpt-(\d+)$")
_QUARANTINE_PREFIX = "corrupt-"
_REASON_FILE = "QUARANTINE_REASON"
CHECKSUM_FORMAT = "masked-crc32c"

# numpy holds these torch types; bf16 is stored through its bits (uint16),
# as the JAX package stores its extension dtypes
_NUMPY = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.int64: "int64",
          torch.int32: "int32", torch.int16: "int16", torch.int8: "int8",
          torch.uint8: "uint8", torch.bool: "bool"}
_BITS = {torch.bfloat16: "bfloat16"}
_TORCH = {**{v: k for k, v in _NUMPY.items()},
          **{v: k for k, v in _BITS.items()}}


def ckpt_path(ckpt_dir: str, step: int) -> str:
    """The checkpoint directory of a step."""
    return os.path.join(ckpt_dir, f"ckpt-{int(step):010d}")


# -- trees ---------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) in the JAX flatten order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [item for f, v in zip(tree._fields, tree)
                for item in _flatten(v, f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, f"{path}[{i}]")]
    if tree is None:
        return []
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (an iterator) in its leaves."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out[k] = _unflatten(tree[k], leaves)
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if tree is None:
        return None
    return next(leaves)


@dataclasses.dataclass(frozen=True)
class _Spec:
    """A leaf's shape and torch dtype, for the structure of a target (a
    leaf itself: not a tuple, which ``_flatten`` would walk into)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _refuse_cut(tree) -> None:
    """Raise for a state holding blocks of a cut ZeRO layout: one rank's
    file would hold only its blocks."""
    if _holds_cut(tree):
        raise ValueError("a ZeRO state cut over its fsdp line is written "
                         "by every rank: use sharded_checkpoint "
                         "(TrainSession(sharded_checkpoint=True))")


def _holds_cut(tree) -> bool:
    if isinstance(tree, ShardedDict):
        return tree.cut
    if isinstance(tree, dict):
        return any(_holds_cut(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_holds_cut(v) for v in tree)
    return False


def _host_tree(tree) -> Any:
    """The JAX tree of ``tree`` with CPU tensor leaves that are copies
    (the device to host copy happens here, and a CPU tensor is cloned:
    the next step updates the parameters in place; the layers of a
    stacked leaf stack on the device first)."""
    _refuse_cut(tree)
    jtree = convert.train_state_to_jax(tree, leaf=lambda t: t.detach(),
                                       stack=torch.stack)
    return _unflatten(jtree, (t.to("cpu", copy=True)
                              for _, t in _flatten(jtree)))


def _spec_tree(tree) -> Any:
    """The JAX tree of ``tree`` with ``_Spec`` leaves (no data moves)."""
    return convert.train_state_to_jax(
        tree, leaf=lambda t: _Spec(tuple(t.shape), t.dtype),
        stack=lambda rows: _Spec((len(rows),) + rows[0].shape,
                                 rows[0].dtype))


def _stored(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array npz stores, the manifest's dtype name) of a leaf."""
    t = t.contiguous()
    if t.dtype in _BITS:
        return t.view(torch.int16).numpy().view(np.uint16), _BITS[t.dtype]
    return t.numpy(), _NUMPY[t.dtype]


def _logical(stored: np.ndarray, dtype: str) -> torch.Tensor:
    """A CPU tensor of a loaded array, viewed back as its manifest dtype
    when it was stored through its bits."""
    want = _TORCH.get(dtype)
    if want in _BITS:
        return torch.from_numpy(stored.view(np.int16)).view(want)
    return torch.from_numpy(stored)


def _leaf_crc(stored: np.ndarray) -> int:
    return masked_crc32c(np.ascontiguousarray(stored))


# -- save ----------------------------------------------------------------

def _write(ckpt_dir: str, step: int, host, max_to_keep: int) -> str:
    plan = faults_lib.active()
    save_index = plan.on_save() if plan is not None else None
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(host)
    stored = [_stored(t) for _, t in flat]
    tmp = tempfile.mkdtemp(prefix=".ckpt-tmp-", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, (a, _) in enumerate(stored)})
        manifest = {
            "step": int(step),
            "checksum": CHECKSUM_FORMAT,
            "leaves": [{"path": p, "shape": list(a.shape), "dtype": dtype,
                        "crc32c": _leaf_crc(a)}
                       for (p, _), (a, dtype) in zip(flat, stored)],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        final = ckpt_path(ckpt_dir, step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if plan is not None:
        plan.on_saved(final, save_index)
    write_index(ckpt_dir, os.path.basename(final))
    if max_to_keep and max_to_keep > 0:
        for old in all_checkpoints(ckpt_dir)[:-max_to_keep]:
            shutil.rmtree(old, ignore_errors=True)
    return final


def save(ckpt_dir: str, step: int, tree: Any, max_to_keep: int = 5) -> str:
    """Atomically write one checkpoint of ``tree`` (a port ``TrainState``,
    or any tree of NamedTuples, dicts, tuples, tensors and host values);
    returns its directory."""
    return _write(ckpt_dir, step, _host_tree(tree), max_to_keep)


def write_index(ckpt_dir: str, name: str) -> None:
    """Atomically (re)write the ``checkpoint`` index file."""
    fd, tmp = tempfile.mkstemp(prefix=".checkpoint-tmp-", dir=ckpt_dir)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(name + "\n")
        os.replace(tmp, os.path.join(ckpt_dir, "checkpoint"))
    except Exception:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def all_checkpoints(ckpt_dir: str) -> List[str]:
    """Checkpoint dirs sorted oldest -> newest."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "arrays.npz")):
            found.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return [p for _, p in sorted(found)]


def _index_entry(ckpt_dir: str) -> Optional[str]:
    """The dir the index names, if it parses, matches ``ckpt-*`` and
    still holds its arrays."""
    try:
        with open(os.path.join(ckpt_dir, "checkpoint")) as f:
            name = f.readline().strip()
    except OSError:
        return None
    if not name or _CKPT_RE.match(name) is None:
        return None
    path = os.path.join(ckpt_dir, name)
    if not os.path.exists(os.path.join(path, "arrays.npz")):
        return None
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The index file's entry when valid, else the newest dir found."""
    path = _index_entry(ckpt_dir)
    if path is not None:
        return path
    ckpts = all_checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return None
    return int(_CKPT_RE.match(os.path.basename(path)).group(1))


class AsyncWriterBase:
    """One worker thread writing in submission order, with loud failures:
    shared by ``AsyncCheckpointer`` and ``sharded_checkpoint.
    AsyncShardedCheckpointer``.  ``wait()`` blocks until all that is
    pending is on disk and raises the first failure (logging the others);
    call it before reading checkpoints back or exiting."""

    def __init__(self, thread_name_prefix: str = "ckpt-writer"):
        import concurrent.futures
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=thread_name_prefix)
        self._pending: List[Any] = []

    def _submit(self, fn, *args):
        self._raise_failed()
        fut = self._executor.submit(fn, *args)
        self._pending.append(fut)
        return fut

    def _raise_failed(self) -> None:
        still = []
        for f in self._pending:
            if f.done():
                f.result()              # re-raise a background failure
            else:
                still.append(f)
        self._pending = still

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        first_error = None
        for f in pending:
            try:
                f.result()
            except Exception as e:
                if first_error is None:
                    first_error = e
                else:
                    log.exception("additional async checkpoint write failed")
        if first_error is not None:
            raise first_error

    def close(self) -> None:
        self.wait()
        self._executor.shutdown(wait=True)


class AsyncCheckpointer(AsyncWriterBase):
    """Background checkpoint writes: the device to host copy happens on
    the caller's thread (the next step updates the parameters in place),
    then the npz, the checksums, the rename and the pruning run on the
    worker thread."""

    def save(self, ckpt_dir: str, step: int, tree: Any,
             max_to_keep: int = 5):
        """Snapshot to the host now, write in the background; returns a
        future resolving to the checkpoint's directory."""
        self._raise_failed()
        return self._submit(_write, ckpt_dir, step, _host_tree(tree),
                            max_to_keep)


# -- restore -------------------------------------------------------------

def _read_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _check_target(metas, flat) -> Optional[str]:
    """Why the manifest does not fit a target's flattened ``_spec_tree``,
    or None."""
    if len(flat) != len(metas):
        return (f"checkpoint has {len(metas)} leaves but target has "
                f"{len(flat)}")
    for i, ((want, spec), meta) in enumerate(zip(flat, metas)):
        if meta["path"] != want:
            return f"leaf {i} path {meta['path']!r} != target {want!r}"
        if list(meta["shape"]) != list(spec.shape):
            return (f"leaf {want}: shape {meta['shape']} != target "
                    f"{list(spec.shape)}")
    return None


def restore(target: Any, ckpt_path: str) -> Any:
    """Load a checkpoint dir into ``target`` in place (see the module
    docstring); returns the restored state."""
    _refuse_cut(target)
    metas = _read_manifest(ckpt_path)["leaves"]
    spec = _spec_tree(target)
    flat = _flatten(spec)
    why = _check_target(metas, flat)
    if why is not None:
        raise ValueError(why)
    leaves = []
    with np.load(os.path.join(ckpt_path, "arrays.npz")) as z:
        for i, (meta, (_, leaf)) in enumerate(zip(metas, flat)):
            leaves.append(_logical(z[f"leaf_{i}"], meta["dtype"]).to(
                leaf.dtype))
    return convert.train_state_from_jax(_unflatten(spec, iter(leaves)),
                                        target)


def verify(path: str, target: Any = None) -> Tuple[bool, str]:
    """Integrity-check one checkpoint dir without building a result:
    manifest, npz members, shapes, each leaf's CRC and, given
    ``target``, its structure.  Returns ``(ok, reason)``; every failure
    comes back as a reason, never as an exception."""
    try:
        metas = _read_manifest(path)["leaves"]
    except Exception as e:
        return False, f"unreadable manifest.json: {e!r}"
    try:
        with np.load(os.path.join(path, "arrays.npz")) as z:
            names = set(z.files)
            if names != {f"leaf_{i}" for i in range(len(metas))}:
                return False, (
                    f"manifest/leaf-count mismatch: manifest has "
                    f"{len(metas)} leaves, npz has {len(names)}")
            for i, meta in enumerate(metas):
                arr = z[f"leaf_{i}"]
                if list(arr.shape) != list(meta["shape"]):
                    return False, (
                        f"leaf {i} shape {list(arr.shape)} != manifest "
                        f"{meta['shape']}")
                want_crc = meta.get("crc32c")
                if want_crc is not None and _leaf_crc(arr) != want_crc:
                    return False, f"leaf {i} ({meta['path']}) CRC mismatch"
    except Exception as e:
        return False, f"unreadable arrays.npz: {e!r}"
    if target is not None:
        why = _check_target(metas, _flatten(_spec_tree(target)))
        if why is not None:
            return False, why
    return True, ""


def quarantine(path: str, reason: str) -> str:
    """Move a bad checkpoint out of the restore path: rename it to
    ``corrupt-<name>`` (made unique) with a ``QUARANTINE_REASON`` file."""
    parent, base = os.path.split(os.path.normpath(path))
    dst = os.path.join(parent, _QUARANTINE_PREFIX + base)
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = os.path.join(parent, f"{_QUARANTINE_PREFIX}{base}.{n}")
    os.rename(path, dst)
    try:
        with open(os.path.join(dst, _REASON_FILE), "w") as f:
            f.write(reason + "\n")
    except OSError:                     # the rename is what matters
        log.exception("could not write %s in %s", _REASON_FILE, dst)
    obs_metrics.REGISTRY.counter(
        "dttpu_checkpoints_quarantined_total",
        "Checkpoint dirs quarantined by verified restore.").inc()
    obs_trace.instant("checkpoint_quarantine", path=dst, reason=reason)
    log.warning("quarantined checkpoint %s -> %s (%s)", path, dst, reason)
    return dst


def restore_latest_good(target: Any, ckpt_dir: str
                        ) -> Tuple[Optional[Any], Optional[str]]:
    """Restore the newest checkpoint that verifies and restores; each
    one that fails is quarantined with its reason.  Returns ``(state,
    path)``, or ``(None, None)`` when none survives.  The whole walk
    (checksums and quarantines included) is goodput's
    ``checkpoint_restore``."""
    _refuse_cut(target)
    with goodput_lib.account("checkpoint_restore"):
        for path in reversed(all_checkpoints(ckpt_dir)):
            ok, reason = verify(path, target=target)
            if ok:
                try:
                    return restore(target, path), path
                except Exception as e:
                    reason = f"restore failed: {e!r}"
            quarantine(path, reason)
        return None, None
