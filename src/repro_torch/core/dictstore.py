"""Per-topic trained dictionary store (port of `repro/core/dictstore.py`):
training, the versioned registry, residency.

Tdic32 (paper §3.1.4) learns its hash table online, so every stream pays a
cold start of 33-bit literals until the table fills. For topic-sharded
edge traffic the value distribution is stable across streams: one offline
pass over sampled traffic pre-fills the table once for every stream of the
topic. This module provides:

- ``TrainedDict``  — an immutable artifact: the seeded table + valid/ts
  arrays in the Knuth-hash layout B5's kernels read, tagged with
  ``(topic, version)`` and a content hash.
- ``train_dict``   — greedy frequency fill over sampled values, with the
  slots of ``kernels.dict_hash.hash_host``.
- ``DictRegistry`` — versioned publish/get/pin with optional JSON + npz
  persistence and LRU-bounded in-memory residency.

The on-disk format is the reference's: an artifact that either package
publishes loads in the other with an equal ``content_hash``. Frames name a
dictionary by ``dict_id = (topic, version)`` behind ``FEATURE_DICT``
(core/bits.py); decode resolves the id through ``resolve`` against the
process default registry.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import zipfile
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels.dict_hash import hash_host

__all__ = [
    "TrainedDict",
    "train_dict",
    "DictRegistry",
    "DictStoreError",
    "default_registry",
    "set_default_registry",
    "resolve",
    "parse_dict_ref",
]


class DictStoreError(KeyError):
    """Single-line dictionary-store failure naming topic/version/path.

    A KeyError subclass so handlers around ``get``/``resolve`` catch it;
    ``str()`` returns the bare message (KeyError's default repr-quotes it)."""

    def __str__(self) -> str:
        return str(self.args[0]) if self.args else ""


_REF_RE = re.compile(r"^([A-Za-z0-9_.\-]+)(?::(latest|v?\d+))?$")


def parse_dict_ref(ref: str) -> Tuple[str, Optional[int]]:
    """Parse ``"topic"`` / ``"topic:latest"`` / ``"topic:v3"`` -> (topic,
    version); version is None for bare-topic and ``:latest`` refs (the
    registry resolves those to the pinned, else the newest, version)."""
    m = _REF_RE.match(ref or "")
    if m is None:
        raise ValueError(
            f"malformed dictionary ref {ref!r}: expected 'topic', 'topic:latest', "
            f"or 'topic:vN' (topic chars: letters, digits, '_', '.', '-')"
        )
    topic, ver = m.group(1), m.group(2)
    if ver is None or ver == "latest":
        return topic, None
    return topic, int(ver.lstrip("v"))


@dataclass(frozen=True)
class TrainedDict:
    """A trained tdic32 dictionary in the kernels' table layout.

    ``table[h]`` holds the winning value for slot ``h = hash_host(v,
    idx_bits)``; ``valid`` marks occupied slots; ``ts`` is the seed write
    stamp (0 for seeded slots, -1 for empty). Online writes stamp
    ``clock + position``, so traffic overwrites seeded entries in the same
    last-writer-wins order on the encode and the decode side."""

    topic: str
    version: int
    idx_bits: int
    table: np.ndarray = field(repr=False)  # (2**idx_bits,) uint32
    valid: np.ndarray = field(repr=False)  # (2**idx_bits,) bool
    ts: np.ndarray = field(repr=False)     # (2**idx_bits,) int32

    def __post_init__(self) -> None:
        ts_len = 1 << self.idx_bits
        if self.table.shape != (ts_len,) or self.valid.shape != (ts_len,) or self.ts.shape != (ts_len,):
            raise ValueError(
                f"trained dict arrays must all be shape ({ts_len},) for idx_bits={self.idx_bits}; "
                f"got table {self.table.shape}, valid {self.valid.shape}, ts {self.ts.shape}"
            )
        object.__setattr__(self, "table", np.ascontiguousarray(self.table, dtype=np.uint32))
        object.__setattr__(self, "valid", np.ascontiguousarray(self.valid, dtype=bool))
        object.__setattr__(self, "ts", np.ascontiguousarray(self.ts, dtype=np.int32))

    @property
    def dict_id(self) -> Tuple[str, int]:
        return (self.topic, self.version)

    @property
    def ref(self) -> str:
        return f"{self.topic}:v{self.version}"

    @property
    def table_size(self) -> int:
        return 1 << self.idx_bits

    @property
    def n_entries(self) -> int:
        return int(self.valid.sum())

    @property
    def nbytes(self) -> int:
        return int(self.table.nbytes + self.valid.nbytes + self.ts.nbytes)

    @property
    def content_hash(self) -> str:
        h = hashlib.sha256()
        h.update(np.int64(self.idx_bits).tobytes())
        h.update(self.table.tobytes())
        h.update(self.valid.tobytes())
        h.update(self.ts.tobytes())
        return h.hexdigest()[:16]

    def seed_state(
        self, lanes: int, device: Union[None, str, torch.device] = None
    ) -> Dict[str, torch.Tensor]:
        """Tdic32 state seeded from this dictionary on `device` (CUDA when
        None, or raise): every lane starts from the same table, clock 0, so
        encoder and decoder replay in lockstep from the frame's first block.
        The layout of `Tdic32.init_state` (table words as int32 bits)."""
        from repro_torch.core.algorithms import make_codec

        codec = make_codec("tdic32", idx_bits=self.idx_bits).seed_dictionary(self)
        return codec.init_state(lanes, resolve_device(device))

    def summary(self) -> Dict[str, object]:
        return {
            "topic": self.topic,
            "version": self.version,
            "idx_bits": self.idx_bits,
            "entries": self.n_entries,
            "bytes": self.nbytes,
            "hash": self.content_hash,
        }


def train_dict(
    samples: np.ndarray,
    idx_bits: int = 12,
    topic: str = "default",
    version: int = 1,
) -> TrainedDict:
    """Greedy frequency fill: each hash slot keeps its most frequent value.

    One pass over the sample: count distinct values, hash each with the
    kernels' Knuth layout, and give every slot its highest-count claimant
    (value ascending breaks count ties, so training is deterministic for a
    given sample multiset regardless of input order)."""
    s = np.asarray(samples).astype(np.uint32).ravel()
    table_size = 1 << idx_bits
    table = np.zeros(table_size, dtype=np.uint32)
    valid = np.zeros(table_size, dtype=bool)
    ts = np.full(table_size, -1, dtype=np.int32)
    if s.size:
        vals, counts = np.unique(s, return_counts=True)
        h = hash_host(vals, idx_bits)
        # sort by (count desc, value asc); the first occurrence of each slot
        # in that order is the slot's winner
        order = np.lexsort((vals, -counts))
        hs = h[order]
        _, first = np.unique(hs, return_index=True)
        slots = hs[first]
        table[slots] = vals[order][first]
        valid[slots] = True
        ts[slots] = 0
    return TrainedDict(topic=topic, version=version, idx_bits=idx_bits, table=table, valid=valid, ts=ts)


class DictRegistry:
    """Versioned per-topic dictionary registry.

    - ``publish`` assigns the topic's next version, persists (when a
      ``root`` directory is configured: a ``registry.json`` index + one
      ``<topic>_v<version>.npz`` per artifact), and notifies subscribers.
    - ``get`` resolves ``(topic, version)``; ``version=None`` means the
      pinned version if one is set, else the newest published.
    - In-memory residency is LRU-bounded at ``max_resident`` entries, but
      eviction only happens when a persistence root exists to reload from:
      a purely in-memory registry never drops data.
    """

    def __init__(self, root: Optional[str] = None, max_resident: int = 16) -> None:
        if max_resident < 1:
            raise ValueError("max_resident must be >= 1")
        self.root = root
        self.max_resident = max_resident
        self._resident: "OrderedDict[Tuple[str, int], TrainedDict]" = OrderedDict()
        self._index: Dict[str, List[int]] = {}  # topic -> sorted versions
        self._pins: Dict[str, int] = {}
        self._subs: Dict[str, List[Callable[[TrainedDict], None]]] = {}
        self._lock = threading.RLock()
        if root is not None:
            os.makedirs(root, exist_ok=True)
            self._load_index()

    # ---- persistence ------------------------------------------------------

    def _index_path(self) -> str:
        return os.path.join(self.root, "registry.json")

    def _npz_path(self, topic: str, version: int) -> str:
        return os.path.join(self.root, f"{topic}_v{version}.npz")

    def _load_index(self) -> None:
        path = self._index_path()
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                data = json.load(f)
            self._index = {
                t: sorted(int(v) for v in vs)
                for t, vs in data.get("topics", {}).items()
            }
            self._pins = {t: int(v) for t, v in data.get("pins", {}).items()}
        except (json.JSONDecodeError, OSError, ValueError, TypeError, AttributeError) as exc:
            msg = str(exc).replace("\n", " ")
            raise DictStoreError(
                f"dictionary registry index {path} is unreadable "
                f"({type(exc).__name__}: {msg}); repair or delete it and "
                "republish the topic dictionaries"
            ) from exc

    def _save_index(self) -> None:
        if self.root is None:
            return
        tmp = self._index_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"topics": self._index, "pins": self._pins}, f, indent=1, sort_keys=True)
        os.replace(tmp, self._index_path())

    def _persist(self, d: TrainedDict) -> None:
        if self.root is None:
            return
        np.savez_compressed(
            self._npz_path(d.topic, d.version),
            table=d.table,
            valid=d.valid,
            ts=d.ts,
            idx_bits=np.int64(d.idx_bits),
        )
        self._save_index()

    def _load(self, topic: str, version: int) -> TrainedDict:
        path = self._npz_path(topic, version)
        if not os.path.exists(path):
            raise DictStoreError(
                f"registry index lists dictionary '{topic}:v{version}' but {path} is missing; "
                f"republish it or repair the registry root"
            )
        try:
            with np.load(path) as z:
                return TrainedDict(
                    topic=topic,
                    version=version,
                    idx_bits=int(z["idx_bits"]),
                    table=z["table"],
                    valid=z["valid"],
                    ts=z["ts"],
                )
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as exc:
            msg = str(exc).replace("\n", " ")
            raise DictStoreError(
                f"dictionary '{topic}:v{version}' failed to load from {path} "
                f"({type(exc).__name__}: {msg}); republish it or repair the "
                "registry root"
            ) from exc

    # ---- residency --------------------------------------------------------

    def _touch(self, key: Tuple[str, int], d: TrainedDict) -> None:
        self._resident[key] = d
        self._resident.move_to_end(key)
        # only evict when the artifact can be reloaded
        if self.root is not None:
            while len(self._resident) > self.max_resident:
                self._resident.popitem(last=False)

    @property
    def resident_count(self) -> int:
        return len(self._resident)

    # ---- public API -------------------------------------------------------

    def publish(self, trained: TrainedDict) -> TrainedDict:
        """Publish under the topic's next version; returns the stamped artifact."""
        with self._lock:
            versions = self._index.setdefault(trained.topic, [])
            version = (versions[-1] + 1) if versions else 1
            stamped = TrainedDict(
                topic=trained.topic,
                version=version,
                idx_bits=trained.idx_bits,
                table=trained.table,
                valid=trained.valid,
                ts=trained.ts,
            )
            versions.append(version)
            self._touch(stamped.dict_id, stamped)
            self._persist(stamped)
            subs = list(self._subs.get(stamped.topic, ()))
        for fn in subs:
            fn(stamped)
        return stamped

    def get(self, topic: str, version: Optional[int] = None) -> TrainedDict:
        with self._lock:
            versions = self._index.get(topic)
            if not versions:
                known = ", ".join(sorted(self._index)) or "none"
                raise KeyError(
                    f"unknown dictionary topic {topic!r} (registry has: {known}); "
                    f"train one with dictstore.train_dict and publish it"
                )
            explicit = version is not None
            if version is None:
                version = self._pins.get(topic, versions[-1])
            if version not in versions:
                have = ", ".join(f"v{v}" for v in versions)
                raise KeyError(
                    f"unknown dictionary version v{version} for topic {topic!r} (have: {have}); "
                    f"publish it or request '{topic}:latest'"
                )
            key = (topic, version)
            d = self._resident.get(key)
            if d is None:
                try:
                    d = self._load(topic, version)
                except DictStoreError:
                    # backing-store outage: a latest/pinned resolution may
                    # fall back to the NEWEST resident version of the topic
                    # (frames name their dict id, so a decode never picks up
                    # the wrong table this way); an EXPLICIT version refuses
                    if explicit:
                        raise
                    fallback = max(
                        (v for t, v in self._resident if t == topic),
                        default=None,
                    )
                    if fallback is None:
                        raise
                    key = (topic, fallback)
                    d = self._resident[key]
            self._touch(key, d)
            return d

    def pin(self, topic: str, version: Optional[int]) -> None:
        """Pin ``topic``'s default resolution; ``None`` unpins (back to latest)."""
        with self._lock:
            if version is None:
                self._pins.pop(topic, None)
            else:
                if version not in self._index.get(topic, []):
                    have = ", ".join(f"v{v}" for v in self._index.get(topic, [])) or "none"
                    raise KeyError(
                        f"cannot pin {topic!r} to unpublished version v{version} (have: {have})"
                    )
                self._pins[topic] = version
            self._save_index()

    def versions(self, topic: str) -> List[int]:
        with self._lock:
            return list(self._index.get(topic, []))

    def topics(self) -> List[str]:
        with self._lock:
            return sorted(self._index)

    def subscribe(self, topic: str, fn: Callable[[TrainedDict], None]) -> None:
        """Call ``fn(trained)`` after every publish on ``topic``."""
        with self._lock:
            self._subs.setdefault(topic, []).append(fn)

    def unsubscribe(self, topic: str, fn: Callable[[TrainedDict], None]) -> None:
        with self._lock:
            subs = self._subs.get(topic, [])
            if fn in subs:
                subs.remove(fn)

    def summary(self) -> List[Dict[str, object]]:
        """One row per published artifact, with its pin flag."""
        rows: List[Dict[str, object]] = []
        with self._lock:
            pairs = [(t, v) for t in sorted(self._index) for v in self._index[t]]
        for topic, version in pairs:
            row = self.get(topic, version).summary()
            row["pinned"] = self._pins.get(topic) == version
            rows.append(row)
        return rows


_default_registry: Optional[DictRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> DictRegistry:
    """Process-wide registry; root from ``CSTREAM_DICT_ROOT`` when set."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = DictRegistry(root=os.environ.get("CSTREAM_DICT_ROOT"))
        return _default_registry


def set_default_registry(registry: Optional[DictRegistry]) -> Optional[DictRegistry]:
    """Swap the process default (tests, embedding apps); returns the old one."""
    global _default_registry
    with _default_lock:
        old, _default_registry = _default_registry, registry
        return old


def resolve(topic: str, version: Optional[int] = None) -> TrainedDict:
    """Resolve ``(topic, version)`` against the process default registry."""
    return default_registry().get(topic, version)
