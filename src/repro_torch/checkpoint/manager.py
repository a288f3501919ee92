"""Atomic, async, verified checkpointing (port of
`repro/checkpoint/manager.py`; DESIGN.md §8), in the reference's on-disk
format:

    <root>/step_000000042/
        manifest.json        # per-leaf dtype/shape/chunks/crc32, codec,
                             # step, save wall-time ("treedef": null)
        <leaf-id>.c<k>.bin   # chunk k of the leaf, raw little-endian bytes
                             # (zlib-compressed with codec="zlib")
    <root>/step_000000042.COMMITTED   # zero-byte commit marker

  * atomic   — written into `step_X.tmp-<pid>`, fsync'd, renamed, then the
               COMMITTED marker: a crash leaves the old or the new step;
  * chunked  — leaves over 64 MiB are split along axis 0;
  * verified — a CRC32 per chunk; `CheckpointManager.restore_latest` falls
               back to the previous committed step on a mismatch;
  * async    — `save_async` snapshots to host memory, then writes in a
               daemon thread.

Trees are nested dicts, lists, tuples and NamedTuples (AdamW's state) of
tensors, numpy arrays or scalars, flattened in the reference's
(`jax.tree_util`) order: dict keys sorted, sequence and NamedTuple fields
in order, None an empty subtree. The port cannot write or read the
reference's serialized jax treedef: it writes `"treedef": null`, and a load
rebuilds the structure from `like=`. So each package loads the other's
checkpoints with `like=`. `load_checkpoint(device=...)` puts the leaves on
a torch device (the reference's `shardings=`); without one it returns numpy
arrays, as the reference does. numpy has no bfloat16, so bfloat16 tensors
are refused (the training state is float32). A sharded leaf
(`runtime/sharding.Sharded`) is gathered to its whole tensor before it is
written.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

_MANIFEST = "manifest.json"
_COMMIT_SUFFIX = ".COMMITTED"
_CHUNK_BYTES = 64 * 1024 * 1024  # split leaves bigger than this along axis 0

DeviceLike = Union[None, str, torch.device]


# ------------------------------------------------------------------ trees --
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree: Any) -> List[Any]:
    """The leaves of `tree` in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_flatten(x)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """`like`'s structure with `leaves` in `tree_flatten`'s order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("the checkpoint has more leaves than like= has")
    return out


def tree_map(fn, tree: Any) -> Any:
    return tree_unflatten(tree, [fn(x) for x in tree_flatten(tree)])


def _host(x) -> np.ndarray:
    """A leaf as a numpy array that owns its data (a copy: the caller may
    update its tensors in place). A `runtime/sharding.Sharded` leaf is
    gathered whole first, so a checkpoint of sharded state keeps the
    reference's format."""
    if hasattr(x, "shards") and hasattr(x, "gather"):
        x = x.gather()
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: checkpoint bfloat16 tensors as float32")
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


# --------------------------------------------------------------- helpers --
def _leaf_id(i: int) -> str:
    return f"leaf{i:05d}"


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


def _chunk_ranges(shape, itemsize) -> list:
    """Split along axis 0 into chunks of <= _CHUNK_BYTES."""
    if not shape or int(np.prod(shape)) * itemsize <= _CHUNK_BYTES:
        return [(0, shape[0] if shape else 1)]
    row_bytes = int(np.prod(shape[1:])) * itemsize if len(shape) > 1 else itemsize
    rows = max(1, _CHUNK_BYTES // max(row_bytes, 1))
    return [(i, min(i + rows, shape[0])) for i in range(0, shape[0], rows)]


def _encode(buf: bytes, codec: str) -> bytes:
    if codec == "none":
        return buf
    if codec == "zlib":
        return zlib.compress(buf, level=1)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _decode(buf: bytes, codec: str) -> bytes:
    return zlib.decompress(buf) if codec == "zlib" else buf


# ------------------------------------------------------------------ save --
def save_checkpoint(root: str, step: int, tree: Any, codec: str = "none",
                    extra_meta: Optional[dict] = None) -> str:
    """Blocking atomic save. Returns the committed directory path."""
    host = [_host(x) for x in tree_flatten(tree)]
    final = _step_dir(root, step)
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "codec": codec, "saved_unix": time.time(), "treedef": None,
                "leaves": [], "extra": extra_meta or {}}
    for i, arr in enumerate(host):
        files = []
        for k, (lo, hi) in enumerate(_chunk_ranges(arr.shape, arr.dtype.itemsize)):
            payload = np.ascontiguousarray(arr[lo:hi] if arr.ndim else arr).tobytes()
            enc = _encode(payload, codec)
            fname = f"{_leaf_id(i)}.c{k}.bin"
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(enc)
                f.flush()
                os.fsync(f.fileno())
            files.append({"file": fname, "rows": [int(lo), int(hi)], "crc32": zlib.crc32(payload),
                          "enc_bytes": len(enc)})
        manifest["leaves"].append({"id": _leaf_id(i), "dtype": str(arr.dtype),
                                   "shape": list(arr.shape), "chunks": files})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):  # overwrite of an uncommitted leftover
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(final + _COMMIT_SUFFIX, "w") as f:
        f.flush()
        os.fsync(f.fileno())
    return final


# ------------------------------------------------------------------ load --
def committed_steps(root: str) -> list:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.endswith(_COMMIT_SUFFIX):
            base = name[: -len(_COMMIT_SUFFIX)]
            if os.path.isdir(os.path.join(root, base)) and base.startswith("step_"):
                out.append(int(base[len("step_"):]))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    steps = committed_steps(root)
    return steps[-1] if steps else None


def load_checkpoint(root: str, step: int, device: DeviceLike = None, verify: bool = True,
                    like: Optional[Any] = None) -> Any:
    """Load a committed step into `like`'s structure (required: the port
    writes and reads no treedef). Leaves are numpy arrays, or torch tensors
    on `device` when one is given. Raises ValueError on a CRC mismatch."""
    d = _step_dir(root, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    if like is None:
        raise ValueError("the port rebuilds a checkpoint's tree from like= (it reads no jax "
                         "treedef); pass like= to rebuild")
    codec = manifest["codec"]
    leaves = []
    for meta in manifest["leaves"]:
        shape = tuple(meta["shape"])
        arr = np.empty(shape, dtype=np.dtype(meta["dtype"]))
        for ch in meta["chunks"]:
            with open(os.path.join(d, ch["file"]), "rb") as f:
                payload = _decode(f.read(), codec)
            if verify and zlib.crc32(payload) != ch["crc32"]:
                raise ValueError(f"checkpoint corruption in {d}/{ch['file']} (crc mismatch)")
            lo, hi = ch["rows"]
            part = np.frombuffer(payload, dtype=arr.dtype)
            if arr.ndim:
                arr[lo:hi] = part.reshape((hi - lo,) + shape[1:])
            else:
                arr = part.reshape(()).copy()
        leaves.append(arr if device is None else torch.from_numpy(arr).to(torch.device(device)))
    if len(leaves) != len(tree_flatten(like)):
        raise ValueError(f"the checkpoint has {len(leaves)} leaves, like= has {len(tree_flatten(like))}")
    return tree_unflatten(like, leaves)


# ------------------------------------------------------------- manager --
@dataclasses.dataclass
class CheckpointManager:
    """Async, retention-managed checkpointing for the train loop."""

    root: str
    keep: int = 3
    codec: str = "none"
    _thread: Optional[threading.Thread] = dataclasses.field(default=None, repr=False)
    _error: Optional[BaseException] = dataclasses.field(default=None, repr=False)
    #: the structure of the last tree saved, `restore_latest`'s default like=
    _like: Any = dataclasses.field(default=None, repr=False)

    def save_async(self, step: int, tree: Any, extra_meta: Optional[dict] = None) -> None:
        """Snapshot to host synchronously, write in the background."""
        self.wait()  # one in-flight save at a time
        host = tree_map(_host, tree)
        self._like = tree_map(lambda _: 0, tree)

        def work():
            try:
                save_checkpoint(self.root, step, host, self.codec, extra_meta)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, device: DeviceLike = None,
                       like: Optional[Any] = None) -> Tuple[Optional[int], Any]:
        """Load the newest COMMITTED step, falling back past corrupt ones.
        `like` defaults to the structure of the tree this manager saved
        last (the port reads no jax treedef; `runtime/fault.py:
        run_with_restarts` passes none)."""
        self.wait()
        like = self._like if like is None else like
        if like is None:
            raise ValueError("restore_latest needs like= (this manager has saved no tree)")
        for step in reversed(committed_steps(self.root)):
            try:
                return step, load_checkpoint(self.root, step, device, like=like)
            except (ValueError, OSError, KeyError, zlib.error, json.JSONDecodeError):
                continue  # corrupt/torn -> fall back to the previous commit
        return None, None

    def _gc(self) -> None:
        for s in committed_steps(self.root)[: -self.keep]:
            d = _step_dir(self.root, s)
            marker = d + _COMMIT_SUFFIX
            if os.path.exists(marker):
                os.remove(marker)
            if os.path.isdir(d):
                shutil.rmtree(d)
