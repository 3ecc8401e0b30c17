"""Atomic, hash-verified checkpoints of nested array trees.

The port of ``repro.checkpoint.manager`` with the same on-disk layout,
so a checkpoint written by either package reads in the other:

  * one directory ``step_%08d`` per step, staged under a unique
    ``step_%08d.{pid}-{tid}.tmp`` name and renamed into place only after
    every leaf and the manifest are on disk — a killed writer never
    leaves a half-checkpoint that restore would pick up;
  * one ``sha1(key)[:16].npy`` file per leaf, where ``key`` joins the
    dict keys and sequence indices on the leaf's path with ``"/"``;
  * ``manifest.json`` with ``step``, ``leaves`` (file, shape, dtype per
    key), the caller's ``metadata`` and ``hash``, the sha256 over the
    sorted keys and each leaf's bytes.

Trees are nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or scalars (``None`` is an empty subtree, as in a JAX pytree).
Tensors leave the device through ``.detach().cpu().numpy()``; a bf16
tensor is written as the reference's ``np.save`` writes a bf16 array
(numpy has no bf16 of its own): its raw 2-byte values as the ``|V2``
dtype, with ``bfloat16`` as its dtype in the manifest.

Sharded trees (one rank's blocks under a
:class:`~repro_torch.runtime.mesh.ProcessMesh`, each leaf's layout a
:class:`~repro_torch.runtime.sharding.NamedSharding`):
``CheckpointManager.save(..., shardings=)`` gathers every leaf on every
rank, the mesh's first rank alone writes the whole arrays, and no rank
returns before the step is published (a failed write raises on every
rank); ``restore_pytree(shardings=)`` gives each rank its block.  The
files are the same either way, so a checkpoint restores onto any mesh
shape and in either package.

Two writers of the same step both return and leave one verified
checkpoint: publishing renames the staged directory into place and, when
the step already exists, first renames the old one aside under a
``.tmp`` name (which every reader skips) and deletes it — no writer ever
deletes a directory another writer has just renamed into place.
"""
from __future__ import annotations

import errno
import hashlib
import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

from repro_torch.obs import meters as meters_mod
from repro_torch.runtime import sharding as sharding_mod


_SEP = "/"


def _fsync_dir(path: str) -> None:
    """fsync a directory so the rename that just landed in it is durable.
    Best-effort — some filesystems refuse O_RDONLY dir fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        # exists but owned by someone else / unknown — assume live
        return True
    return True


def _tmp_writer_pid(name: str) -> int | None:
    """Parse the writer pid out of a ``step_X.{pid}-{tid}.tmp`` staging
    dir name; None if the name doesn't match that convention."""
    if not name.endswith(".tmp"):
        return None
    stem = name[:-len(".tmp")]
    tag = stem.rsplit(".", 1)
    if len(tag) != 2 or "-" not in tag[1]:
        return None
    pid_s = tag[1].split("-", 1)[0]
    return int(pid_s) if pid_s.isdigit() else None


def _items(node):
    """(path component, child) pairs of a container node in the order a
    JAX pytree flattens them (dict keys sorted), or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree) -> dict:
    """``{key: leaf}`` in flatten order; ``key`` joins the path's dict
    keys and sequence indices with ``"/"`` (``None`` has no leaves)."""
    out: dict = {}

    def walk(node, path):
        if node is None:
            return
        items = _items(node)
        if items is None:
            out[_SEP.join(path)] = node
            return
        for name, child in items:
            walk(child, path + [name])

    walk(tree, [])
    return out


def _map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _unflatten(like, leaves: dict):
    """``like`` with every leaf replaced by ``leaves[key]``."""
    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, path + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + [str(i)])
                              for i, v in enumerate(node))
        return leaves[_SEP.join(path)]

    return walk(like, [])


_BF16 = np.dtype("V2")   # how a bf16 array's values lie in a .npy file


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16 else str(arr.dtype)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.as_tensor(arr)


def _publish(tmp: str, final: str) -> None:
    """Rename the staged ``tmp`` to ``final``.  An existing ``final`` (an
    earlier save of the step, or a concurrent writer's) is first renamed
    aside under this writer's own ``.tmp`` name and deleted; whichever
    writer renames into place last wins, and every writer returns."""
    aside = f"{final}.{os.getpid()}-{threading.get_ident()}-old.tmp"
    while True:
        try:
            os.rename(tmp, final)
            return
        except OSError as e:
            if e.errno not in (errno.ENOTEMPTY, errno.EEXIST):
                raise
        try:
            os.rename(final, aside)
        except FileNotFoundError:
            continue            # another writer moved it aside first
        shutil.rmtree(aside, ignore_errors=True)


def save_pytree(tree, directory: str, step: int,
                metadata: dict | None = None) -> str:
    """Atomic synchronous save.  Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    # Unique staging name: concurrent writers of the same step must not
    # clobber each other's staging dir.
    tmp = f"{final}.{os.getpid()}-{threading.get_ident()}.tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten(tree)
    manifest = {"step": step, "leaves": {}, "metadata": metadata or {}}
    hasher = hashlib.sha256()
    for key in sorted(flat):
        arr = _to_numpy(flat[key])
        fname = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        hasher.update(key.encode())
        hasher.update(arr.tobytes())
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape),
            "dtype": _dtype_name(arr)}
    manifest["hash"] = hasher.hexdigest()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _publish(tmp, final)
    # The rename is only crash-durable once the parent directory's inode
    # is on disk.
    _fsync_dir(directory)
    return final


def _load_manifest(path: str):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def verify(path: str) -> bool:
    """Recompute the manifest hash; False for torn/corrupt checkpoints."""
    try:
        manifest = _load_manifest(path)
        hasher = hashlib.sha256()
        for key in sorted(manifest["leaves"]):
            info = manifest["leaves"][key]
            arr = np.load(os.path.join(path, info["file"]))
            hasher.update(key.encode())
            hasher.update(arr.tobytes())
        return hasher.hexdigest() == manifest["hash"]
    except Exception:
        # Any unreadable piece (truncated .npy, mangled JSON, missing
        # file) means the checkpoint is torn.
        return False


def restore_pytree(directory_or_path: str, like=None, shardings=None,
                   step: int | None = None):
    """Restore a checkpoint.  Returns ``(tree, manifest)``.

    ``directory_or_path`` is a ``step_XXXX`` path, or a checkpoint
    directory whose newest verified step (or ``step``) is read.  With
    ``like`` omitted the tree is the flat ``{key: np.ndarray}`` dict;
    otherwise ``like`` (a tree of tensors or arrays of the whole shapes)
    gives the structure, and each restored leaf takes its ``like`` leaf's
    dtype — and, for a tensor, its device.  ``shardings`` (a tree like
    ``like`` of ``NamedSharding``, or ``None`` leaves) gives each leaf as
    this rank's block of it, on the mesh's device where the ``like`` leaf
    is a ``meta`` tensor (a ``meta`` leaf without a sharding lands on the
    CPU).
    """
    path = directory_or_path
    if step is not None:
        path = os.path.join(directory_or_path, f"step_{step:08d}")
    elif not os.path.basename(path).startswith("step_"):
        path = latest_checkpoint(directory_or_path)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {directory_or_path}")
    manifest = _load_manifest(path)
    flat = {key: np.load(os.path.join(path, info["file"]))
            for key, info in manifest["leaves"].items()}
    if like is None:
        return flat, manifest

    flat_like = _flatten(like)
    missing = set(flat_like) - set(flat)
    if missing:
        raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
    flat_sh = {} if shardings is None else _flatten(shardings)
    leaves = {}
    for key, want in flat_like.items():
        arr = flat[key]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{key}: shape {arr.shape} != {want.shape}")
        sh = flat_sh.get(key)
        if isinstance(want, torch.Tensor):
            t, dev = _to_tensor(arr), want.device
            if sh is not None:
                t = sharding_mod.local_block(t, sh)
                if dev.type == "meta":
                    dev = sh.mesh.device
            if dev.type == "meta":
                dev = torch.device("cpu")
            # a block is copied, so the whole array is not kept alive
            leaves[key] = t.to(device=dev, dtype=want.dtype,
                               copy=sh is not None)
        else:
            arr = arr.astype(want.dtype)
            leaves[key] = (arr if sh is None else np.ascontiguousarray(
                arr[sharding_mod.block_slices(sh, arr.shape)]))
    return _unflatten(like, leaves), manifest


def latest_checkpoint(directory: str) -> str | None:
    """Newest checkpoint that passes hash verification (torn checkpoints
    and .tmp directories are skipped — the restart path after a crash)."""
    if not os.path.isdir(directory):
        return None
    cands = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp")
                   and os.path.isdir(os.path.join(directory, d)))
    for d in reversed(cands):
        path = os.path.join(directory, d)
        if verify(path):
            return path
        # Torn/corrupt candidate skipped — the event is the operator's
        # only signal that a checkpoint was silently lost to a crash.
        meters_mod.get_meters().event("checkpoint.corrupt_skipped",
                                      path=path)
        meters_mod.get_meters().inc("checkpoint.corrupt_skipped")
    return None


class CheckpointManager:
    """Async manager with retention (``keep`` newest steps) and
    auto-resume."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._queue: "queue.Queue[tuple]" = queue.Queue()
        self._errors: list = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            tree, step, metadata = item
            try:
                save_pytree(tree, self.directory, step, metadata)
                self._gc()
            except Exception as e:
                # Surface at failure time, not just on wait(): an async
                # save that dies silently means the next crash loses far
                # more progress than the operator believes.
                self._errors.append(e)
                meters_mod.get_meters().event(
                    "checkpoint.save_failed", step=int(step),
                    error=f"{type(e).__name__}: {e}")
                meters_mod.get_meters().inc("checkpoint.save_failed")
            finally:
                self._queue.task_done()

    def _gc(self):
        entries = os.listdir(self.directory)
        cands = sorted(d for d in entries
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in cands[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, d),
                          ignore_errors=True)
        # Stale staging dirs from crashed writers; skip those whose
        # writer pid is still alive (another process mid-save) and our
        # own (this process mid-save).
        for d in entries:
            pid = _tmp_writer_pid(d)
            if pid is None or pid == os.getpid() or _pid_alive(pid):
                continue
            shutil.rmtree(os.path.join(self.directory, d),
                          ignore_errors=True)
            meters_mod.get_meters().inc("checkpoint.stale_tmp_removed")

    def save(self, tree, step: int, metadata: dict | None = None,
             blocking: bool = True, shardings=None):
        """Save ``tree`` as step ``step`` (queued when not ``blocking``).
        ``shardings`` (a tree like ``tree`` of ``NamedSharding``) makes
        ``tree`` one rank's blocks: every rank of the mesh calls this, each
        leaf is gathered whole, the mesh's first rank writes it at once,
        and every rank returns once it is published (a failed write
        raises on every rank)."""
        if shardings is not None:
            return self._save_sharded(tree, step, metadata, shardings)
        # Copy to the host now: the caller may overwrite live tensors as
        # soon as this returns (a CPU tensor's .numpy() shares memory).
        host_tree = _map(lambda x: np.array(_to_numpy(x)), tree)
        if blocking:
            return save_pytree(host_tree, self.directory, step, metadata)
        self._queue.put((host_tree, step, metadata))

    def _save_sharded(self, tree, step: int, metadata, shardings) -> str:
        flat, flat_sh = _flatten(tree), _flatten(shardings)
        mesh = next(iter(flat_sh.values())).mesh
        writer = mesh.index(mesh.axis_names) == 0
        host = {}
        for key in sorted(flat):
            whole = sharding_mod.gather(flat[key], flat_sh[key])
            if writer:
                host[key] = np.array(_to_numpy(whole))
            del whole
        err = None
        if writer:
            try:
                save_pytree(host, self.directory, step, metadata)
                self._gc()
            except Exception as exc:    # agreed below
                err = exc
        mesh.raise_any(err)
        return os.path.join(self.directory, f"step_{step:08d}")

    def wait(self):
        self._queue.join()
        if self._errors:
            raise self._errors.pop()

    def restore_latest(self, like=None, shardings=None):
        path = latest_checkpoint(self.directory)
        if path is None:
            return None
        return restore_pytree(path, like=like, shardings=shardings)

    def close(self):
        self._queue.put(None)
        self._worker.join(timeout=5)
