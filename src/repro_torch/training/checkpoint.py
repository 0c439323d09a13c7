"""Checkpointing (the counterpart of the reference's
``repro/training/checkpoint.py``), on the same on-disk layout, so a
checkpoint of either package restores in the other::

    <ckpt_dir>/step_000123/
        manifest.json            # {"step", "keys": [{key, file, shape, dtype}], "extra"}
        arrays/<key, / -> __>.npy
        COMMIT                   # written last: its presence marks completeness

Keys are the tree's paths joined by "/" (``params/blocks/slot0/ffn/w_up``).
bfloat16 leaves are stored as their uint16 bits with ``"dtype":
"bfloat16"`` in the manifest, as the reference stores them.

Fault-tolerance contract, as the reference's: writes go to ``step_X.tmp``
and are renamed after COMMIT, so a killed writer never corrupts the latest
checkpoint; ``latest_step`` considers committed checkpoints only;
``keep_last`` removes old steps after a commit; ``AsyncCheckpointer`` copies
the tensors to the host synchronously and writes the files on a thread,
with the reference's error contract (see ``AsyncCheckpointer``).  One process writes
whole tensors, in the one-card layout: a tree of DTensors (the sharded
train step's state) is gathered first, every rank taking part, and only
rank 0 writes.  ``restore`` into a tree of DTensors places each leaf as its
like leaf is placed, on any mesh, so a checkpoint crosses between the
one-card loop, the meshed loop and the reference both ways.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.params import map_tree, shard_tensor

__all__ = ["save", "restore", "latest_step", "committed_steps", "AsyncCheckpointer"]

_COMMIT = "COMMIT"
_NP = {torch.float32: np.float32, torch.float16: np.float16, torch.int32: np.int32,
       torch.int64: np.int64, torch.uint8: np.uint8, torch.bool: np.bool_}
_TORCH = {"float32": torch.float32, "float16": torch.float16, "int32": torch.int32,
          "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
          "bfloat16": torch.bfloat16}


def _flatten(tree) -> dict:
    out = {}
    map_tree(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def _writer() -> bool:
    """Whether this process writes: the one process, or rank 0 of ranks."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(the array to store, its true dtype's name).  A DTensor is gathered
    whole (a collective: every rank calls this)."""
    if isinstance(leaf, np.ndarray):
        return leaf, str(leaf.dtype)
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True)  # a copy: the caller updates its tensors in place
    if t.dtype == torch.bfloat16:  # the raw bits, as the reference stores them
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    if t.dtype not in _NP:
        raise TypeError(f"checkpoint: unsupported dtype {t.dtype}")
    return t.numpy(), str(np.dtype(_NP[t.dtype]))


def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None,
         keep_last: int | None = None) -> str:
    """Synchronous atomic save of a tree of tensors (or of host arrays, as
    ``AsyncCheckpointer`` hands them over).  Returns the committed
    directory.  Under ``torch.distributed`` every rank calls it (DTensor
    leaves are gathered) and rank 0 alone writes."""
    final = _step_dir(ckpt_dir, step)
    host = {key: leaf if isinstance(leaf, tuple) else _to_host(leaf)
            for key, leaf in _flatten(tree).items()}
    if not _writer():
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
    manifest = {"step": step, "keys": [], "extra": extra or {}}
    for key, (arr, true_dtype) in host.items():
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, "arrays", fname), arr)
        manifest["keys"].append({"key": key, "file": fname, "shape": list(arr.shape),
                                 "dtype": true_dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if keep_last is not None:
        _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = committed_steps(ckpt_dir)
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


def committed_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, _COMMIT)):
                out.append(int(name[len("step_"):]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like_tree, *, device=None):
    """Restore into the structure of ``like_tree`` (a tree of tensors, or of
    anything with ``shape`` and ``dtype``): each leaf in the checkpoint's
    dtype, on ``device`` (default: the like leaf's, or the CPU).  Where the
    like leaf is a DTensor, the leaf is placed as it is, on its mesh (each
    rank reads the whole array and keeps its shard).  Raises ``ValueError``
    where a shape differs.  Returns ``(tree, extra)``."""
    d = _step_dir(ckpt_dir, step)
    if not os.path.exists(os.path.join(d, _COMMIT)):
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["keys"]}

    def one(key, like):
        entry = by_key[key]
        arr = np.load(os.path.join(d, "arrays", entry["file"]))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint {arr.shape} != expected {tuple(like.shape)}")
        dtype = _TORCH[entry["dtype"]]
        if dtype == torch.bfloat16:  # stored as raw bits
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        dev = device if device is not None else getattr(like, "device", "cpu")
        if isinstance(like, DTensor):
            return shard_tensor(t.to(device=dev), like.device_mesh, like.placements)
        return t.to(device=dev)

    return map_tree(one, like_tree), manifest["extra"]


class AsyncCheckpointer:
    """Double-buffered background writer: the device-to-host copy is
    synchronous, the file IO overlaps the next steps.  Under
    ``torch.distributed`` every rank calls ``save`` (DTensor leaves are
    gathered) and rank 0 alone writes.

    Error contract: background-write failures are queued (never clobbered:
    two failed writes surface as two errors) and raised one per
    ``wait()``/``save()`` call, oldest first.  ``save()`` submits the new
    write before raising a pending error, so a failure of step N's write
    can never silently swallow step N+1's: the caller sees N's error and
    N+1's write is already in flight (its own failure, if any, surfaces on
    the next call).  Call ``wait()`` until it returns cleanly to drain."""

    def __init__(self, ckpt_dir: str, *, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._errors: list[Exception] = []

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _raise_pending(self) -> None:
        if self._errors:
            raise self._errors.pop(0)

    def save(self, step: int, tree, *, extra: dict | None = None) -> None:
        self._join()
        # after _join() every queued error belongs to a prior write; the new
        # write's failure (it may finish before we return) must surface on
        # the next call, not this one
        prior_errors = len(self._errors)
        host_tree = map_tree(lambda _, t: _to_host(t), tree)
        if not _writer():
            return

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra=extra, keep_last=self.keep_last)
            except Exception as e:  # queued; surfaced on the next wait()/save()
                self._errors.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if prior_errors:
            raise self._errors.pop(0)

    def wait(self) -> None:
        self._join()
        self._raise_pending()
