"""Fault-tolerant checkpoint manager of the port (`repro.train.checkpoint`
counterpart), with `repro`'s on-disk format, so that a checkpoint either
package writes restores into the other:

- ``<dir>/step_<8 digits>/manifest.json`` maps each leaf's key (its path
  in the nested tree, dict keys and list indices joined by ``@``) to its
  ``.npy`` file, shape, dtype and a sha256 prefix of its bytes;
- **atomic saves**: written to ``<dir>/tmp.<step>``, then renamed;
- **async saves**: the device-to-host copy happens at ``save``, the disk
  writes on a background thread;
- **integrity**: every leaf's checksum is verified on restore;
- retention of the newest ``keep`` checkpoints, and
  `install_preemption_handler` for an emergency save on SIGTERM / SIGINT;
- **elastic restore**: leaves are stored whole, whatever mesh wrote them,
  and ``restore(shardings=)`` returns each as this rank's shard under a
  `repro_torch.dist.Sharding`, onto a mesh of any size.

A tree is nested dicts (and lists / tuples) of tensors, numpy arrays or
Python numbers.  A bfloat16 leaf, which numpy cannot hold, is stored as
its 16-bit pattern with ``"bfloat16"`` as its manifest dtype, the bytes
`repro` writes for a bfloat16 array.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import signal
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

_SEP = "@"
_BF16 = "bfloat16"


def _items(tree, prefix=()):
    """(path, leaf) pairs of ``tree`` in `jax.tree_util`'s order: dict
    keys sorted, sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array, manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _flatten(tree) -> dict[str, tuple[np.ndarray, str]]:
    return {_SEP.join(p): _host(leaf) for p, leaf in _items(tree)}


def _checksum(a: np.ndarray) -> str:
    """sha256 prefix of the leaf's bytes in C order (hashed in place)."""
    return hashlib.sha256(np.ascontiguousarray(a).data).hexdigest()[:16]


def _pool() -> ThreadPoolExecutor:
    """Threads for the leaves' file reads and checksums, which release
    the GIL: a 10 GB checkpoint hashes at one core's ~0.8 GB/s."""
    return ThreadPoolExecutor(min(8, os.cpu_count() or 1))


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = True) -> str:
        """Snapshot to host, then write (async if blocking=False)."""
        host = _flatten(tree)  # the device-to-host copy happens here
        if blocking:
            return self._write(step, host)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host), daemon=True)
        self._thread.start()
        return os.path.join(self.dir, f"step_{step:08d}")

    def wait(self):
        """Join the background writer, if one runs."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = os.path.join(self.dir, f"tmp.{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        with _pool() as pool:
            shas = pool.map(_checksum, [arr for arr, _ in host.values()])
            for (key, (arr, dtype)), sha in zip(host.items(), shas):
                fname = hashlib.md5(key.encode()).hexdigest()[:20] + ".npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"][key] = {
                    "file": fname,
                    "shape": list(arr.shape),
                    "dtype": dtype,
                    "sha": sha,
                }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, *, shardings: Any = None,
                verify: bool = True) -> Any:
        """Restore into the structure of ``target``: a tensor leaf of
        ``target`` comes back as a tensor on its device (in the stored
        dtype), any other leaf as a numpy array.  ``shardings`` (a tree of
        `repro_torch.dist.Sharding` of ``target``'s structure, as
        `repro_torch.dist.sharding_tree` gives, or one `Sharding` for every
        leaf) returns every leaf instead as this rank's shard under it, a
        tensor on its mesh's device: the elastic restore onto a mesh other
        than the one that wrote the checkpoint.  Checksums are verified
        first either way."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        one = _is_sharding(shardings)
        by_key = {} if shardings is None or one else {
            _SEP.join(p): sh for p, sh in _items(shardings)}

        def load(key):
            meta = manifest["leaves"][key]
            arr = np.load(os.path.join(path, meta["file"]))
            if verify and _checksum(arr) != meta["sha"]:
                raise IOError(f"checksum mismatch for {key}")
            return meta["dtype"], arr

        def leaf(key, like, dtype, arr):
            t = arr
            if dtype == _BF16:
                t = torch.from_numpy(np.ascontiguousarray(
                    arr.view(np.int16))).view(torch.bfloat16)
            elif isinstance(like, torch.Tensor) or shardings is not None:
                t = torch.from_numpy(arr)
            if shardings is None:
                return t.to(like.device) if isinstance(like, torch.Tensor) \
                    else t
            try:
                return (shardings if one else by_key[key]).shard(t)
            except ValueError as e:
                raise ValueError(f"leaf {key!r}: {e}") from None

        items = [(_SEP.join(p), like) for p, like in _items(target)]
        with _pool() as pool:
            loaded = pool.map(load, [k for k, _ in items])
            leaves = [leaf(k, like, *got)
                      for (k, like), got in zip(items, loaded)]
        return _rebuild(target, iter(leaves))


def _is_sharding(x) -> bool:
    return hasattr(x, "mesh") and hasattr(x, "spec")


def install_preemption_handler(save_fn: Callable[[], None]):
    """SIGTERM/SIGINT -> emergency checkpoint, then exit.  Returns a flag
    dict the train loop can poll (``flag["preempted"]``)."""
    flag = {"preempted": False}

    def handler(signum, frame):
        flag["preempted"] = True
        save_fn()
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
    return flag
