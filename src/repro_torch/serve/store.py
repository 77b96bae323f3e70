"""Durable CVPlan checkpoint store — the warm-boot tier under the cache.

The :class:`~repro_torch.serve.cache.PlanCache` makes plan builds amortise
*within* a process; this module makes them amortise *across* processes.
A :class:`CVPlan` is the paper's expensive label-invariant artifact
(§2.7) — O(N²P + N³ + K·m³) to build, pure data thereafter — so a
restarted or autoscaled replica that can read yesterday's plans from
disk skips straight to the O(K·m²) serving regime. :class:`PlanStore`
is that disk tier: a content-addressed directory of serialized plans,
wired into :class:`~repro_torch.serve.engine.CVEngine` as read-through (a
cache miss tries disk before building) and write-behind (fresh builds
are persisted off the request path).

Durability properties (the reference package's commit protocol):

* **atomic** — entries are written to ``<id>.tmp-<pid>-<seq>/`` with the
  manifest last, then renamed into place; a crash mid-write can never
  produce a readable-but-wrong entry, and concurrent writers (two
  engines, one dir) race benignly: entries are content-addressed by
  ``plan_key``, so whichever rename lands first wins and the loser's
  identical bytes are discarded.
* **self-verifying** — the manifest records a schema version, the full
  plan key, and per-leaf shape/dtype/blake2b digests; ``load`` re-hashes
  what it read and rejects any mismatch.
* **fail-soft** — a corrupt, truncated, or version-skewed entry is moved
  to ``quarantine/`` (keeping the bytes for a post-mortem) and reported
  as a miss, never an exception: a damaged store degrades to cold-boot
  behaviour instead of taking the server down.
* **bounded** — ``gc`` evicts oldest-written entries while the store
  exceeds its byte budget, skipping any key in ``protect`` (the engine
  passes its pinned plan keys, so operator-pinned plans survive on disk
  as long as they are pinned in memory).

Layout::

    root/
      <entry id>/              # blake2b(plan_key) hex
        manifest.json          # schema, plan_key, per-leaf integrity
        h.npy  te_idx.npy  tr_idx.npy  chol_ih.npy  [h_tr_te.npy]
      quarantine/
        <entry id>.<n>/        # damaged entries, moved not deleted

The layout, manifest and entry ids are the reference package's
(``serve/store.py``), and ``plan_key`` is equal in both packages for the
same arrays, so a store written by either is read by the other. Leaves
are snapshotted to host NumPy on save (``plan_to_arrays``); ``load``
places a verified plan on the store's device (``plan_from_arrays``),
which the engine sets to its own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from repro_torch.core.fastcv import CVPlan, plan_from_arrays, plan_to_arrays
from repro_torch.kernels.common import resolve_device

__all__ = ["SCHEMA_VERSION", "StoreStats", "PlanStore"]

#: Bumped whenever the on-disk layout or manifest contract changes; a
#: mismatched entry is quarantined (it may belong to a newer binary), not
#: reinterpreted.
SCHEMA_VERSION = 1

_MANIFEST = "manifest.json"
_QUARANTINE = "quarantine"


def _entry_id(key: tuple) -> str:
    """Stable directory name for a plan key.

    ``plan_key`` tuples contain only str/float/bool, all of which
    round-trip JSON exactly (Python float repr is shortest-round-trip),
    so hashing the JSON encoding is deterministic across processes.
    """
    return hashlib.blake2b(json.dumps(list(key)).encode(), digest_size=16).hexdigest()


def _digest(arr: np.ndarray) -> str:
    """Full-content integrity hash (unlike ``fingerprint``, never sampled:
    the array was just read off disk, hashing it is already the cheap
    part of the I/O)."""
    return hashlib.blake2b(np.ascontiguousarray(arr).tobytes(), digest_size=16).hexdigest()


class StoreCorruption(Exception):
    """Internal: an entry failed an integrity check (caught by ``load``)."""


@dataclasses.dataclass
class StoreStats:
    hits: int = 0  # loads that returned a verified plan
    misses: int = 0  # loads that found nothing usable
    writes: int = 0  # entries committed (renamed into place)
    quarantined: int = 0  # damaged entries moved aside by load
    evictions: int = 0  # entries removed by byte-budget GC
    bytes_in_store: int = 0  # committed entry bytes on disk
    byte_budget: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlanStore:
    """Content-addressed ``plan_key -> CVPlan`` directory with integrity
    checks, quarantine, and byte-budget GC.

    Thread-safe: one lock serialises commits/GC/stat updates inside a
    process; *cross*-process safety needs no locking because every
    mutation is an atomic rename and entries are content-addressed.
    ``device`` is where :meth:`load` places plans (``None`` means
    ``cuda``, ``kernels.common.resolve_device``).
    """

    # Concurrency contract, machine-checked by reprolint RL004
    # (write-behind threads and the request path share these).
    _GUARDED_BY = {"_pending": "_lock", "stats": "_lock"}

    def __init__(self, root, byte_budget: int = 4 << 30, *, device=None):
        if byte_budget <= 0:
            raise ValueError("byte_budget must be positive")
        self.device = resolve_device(device)  # where load() places plans
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()
        self._tmp_seq = itertools.count()
        self._pending: list[threading.Thread] = []
        self.stats = StoreStats(byte_budget=byte_budget)
        self.stats.bytes_in_store = sum(self._entry_bytes(d) for d in self._entry_dirs())

    # -- layout helpers ----------------------------------------------------

    def _entry_dirs(self) -> list[Path]:
        return sorted(
            d
            for d in self.root.iterdir()
            if d.is_dir()
            and d.name != _QUARANTINE
            and ".tmp-" not in d.name
            and (d / _MANIFEST).exists()
        )

    @staticmethod
    def _entry_bytes(entry: Path) -> int:
        return sum(f.stat().st_size for f in entry.iterdir() if f.is_file())

    def path_for(self, key: tuple) -> Path:
        return self.root / _entry_id(key)

    def __contains__(self, key: tuple) -> bool:
        return (self.path_for(key) / _MANIFEST).exists()

    def __len__(self) -> int:
        return len(self._entry_dirs())

    def keys(self) -> list[tuple]:
        """Plan keys of every committed entry (read from manifests)."""
        out = []
        for d in self._entry_dirs():
            try:
                out.append(tuple(json.loads((d / _MANIFEST).read_text())["plan_key"]))
            except (OSError, ValueError, KeyError):
                continue  # unreadable manifest: load() will quarantine it
        return out

    def total_bytes(self) -> int:
        return sum(self._entry_bytes(d) for d in self._entry_dirs())

    # -- write path --------------------------------------------------------

    def save(self, key: tuple, plan: CVPlan, *, protect: Iterable[tuple] = ()) -> bool:
        """Persist ``plan`` under ``key`` atomically; returns whether this
        call committed a new entry (False when one already exists — the
        store is content-addressed, identical keys mean identical bytes).
        Runs :meth:`gc` with ``protect`` after a commit."""
        final = self.path_for(key)
        if (final / _MANIFEST).exists():
            return False
        arrays = plan_to_arrays(plan)
        return self._commit(key, final, arrays, protect)

    def save_async(
        self, key: tuple, plan: CVPlan, *, protect: Iterable[tuple] = ()
    ) -> Optional[threading.Thread]:
        """Write-behind :meth:`save`: snapshot to host now (the only
        synchronous part: the device-to-host copy), commit on a background
        thread. ``flush`` joins
        outstanding writes (engine/server shutdown)."""
        final = self.path_for(key)
        if (final / _MANIFEST).exists():
            return None
        arrays = plan_to_arrays(plan)  # host snapshot before returning
        protect = tuple(tuple(k) for k in protect)

        def _write():
            self._commit(key, final, arrays, protect)

        t = threading.Thread(target=_write, daemon=True, name="plan-store-write")
        t.start()
        with self._lock:
            self._pending.append(t)
        return t

    def flush(self) -> None:
        """Block until every outstanding :meth:`save_async` committed."""
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()

    def _commit(self, key: tuple, final: Path, arrays: dict, protect) -> bool:
        tmp = self.root / f"{final.name}.tmp-{os.getpid()}-{next(self._tmp_seq)}"
        tmp.mkdir(parents=True)
        try:
            leaves = []
            for name, arr in arrays.items():
                np.save(tmp / f"{name}.npy", arr)
                leaves.append(
                    {
                        "name": name,
                        "shape": list(arr.shape),
                        "dtype": str(arr.dtype),
                        "digest": _digest(arr),
                        "nbytes": int(arr.nbytes),
                    }
                )
            manifest = {
                "schema": SCHEMA_VERSION,
                "plan_key": list(key),
                "leaves": leaves,
            }
            # manifest last: its presence IS the entry's commit marker
            (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=2))
            with self._lock:
                if (final / _MANIFEST).exists():
                    shutil.rmtree(tmp, ignore_errors=True)
                    return False
                try:
                    tmp.rename(final)
                except OSError:
                    # cross-process race: someone else committed this key
                    shutil.rmtree(tmp, ignore_errors=True)
                    return False
                self.stats.writes += 1
                self.stats.bytes_in_store += self._entry_bytes(final)
            self.gc(protect=protect)
            return True
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    # -- read path ---------------------------------------------------------

    def load(self, key: tuple) -> Optional[CVPlan]:
        """Verified read of ``key``; None on miss *or* damage.

        Every failure mode — unreadable/garbled manifest, schema skew,
        plan-key mismatch (hash collision or tampering), missing leaf
        file, shape/dtype/digest mismatch — quarantines the entry and
        reports a miss. The engine then rebuilds exactly as if the entry
        had never existed.
        """
        entry = self.path_for(key)
        if not (entry / _MANIFEST).exists():
            with self._lock:
                self.stats.misses += 1
            return None
        try:
            plan = self._load_verified(entry, key)
        except (StoreCorruption, OSError, ValueError, KeyError, TypeError) as e:
            self._quarantine(entry, reason=str(e))
            with self._lock:
                self.stats.misses += 1
            return None
        with self._lock:
            self.stats.hits += 1
        return plan

    def _load_verified(self, entry: Path, key: tuple) -> CVPlan:
        manifest = json.loads((entry / _MANIFEST).read_text())
        if manifest.get("schema") != SCHEMA_VERSION:
            raise StoreCorruption(f"schema {manifest.get('schema')!r} != {SCHEMA_VERSION}")
        if tuple(manifest.get("plan_key", ())) != tuple(key):
            raise StoreCorruption("manifest plan_key does not match requested key")
        arrays = {}
        for leaf in manifest["leaves"]:
            path = entry / f"{leaf['name']}.npy"
            if not path.exists():
                raise StoreCorruption(f"missing leaf file {leaf['name']}.npy")
            arr = np.load(path)
            if list(arr.shape) != leaf["shape"] or str(arr.dtype) != leaf["dtype"]:
                raise StoreCorruption(
                    f"leaf {leaf['name']}: shape/dtype mismatch "
                    f"({arr.shape}/{arr.dtype} vs manifest)"
                )
            if _digest(arr) != leaf["digest"]:
                raise StoreCorruption(f"leaf {leaf['name']}: content digest mismatch")
            arrays[leaf["name"]] = arr
        return plan_from_arrays(arrays, device=self.device)

    def _quarantine(self, entry: Path, reason: str = "") -> None:
        qdir = self.root / _QUARANTINE
        qdir.mkdir(exist_ok=True)
        with self._lock:
            size = self._entry_bytes(entry) if entry.exists() else 0
            for n in itertools.count():
                dest = qdir / f"{entry.name}.{n}"
                if not dest.exists():
                    break
            try:
                entry.rename(dest)
            except OSError:
                return  # raced with another quarantine/GC: entry is gone
            self.stats.quarantined += 1
            self.stats.bytes_in_store -= size
            if reason:
                try:
                    (dest / "quarantine-reason.txt").write_text(reason + "\n")
                except OSError:
                    pass

    def remove(self, key: tuple) -> bool:
        """Cleanly delete one entry (released dataset versions).

        Unlike :meth:`_quarantine` this is an intentional removal — the
        bytes are gone, nothing lands in ``quarantine/`` and the
        ``quarantined`` counter does not move. Returns True if an entry
        existed. Tolerant no-op for absent keys.
        """
        entry = self.path_for(key)
        with self._lock:
            if not entry.exists():
                return False
            size = self._entry_bytes(entry)
            shutil.rmtree(entry, ignore_errors=True)
            self.stats.bytes_in_store -= size
        return True

    # -- GC ----------------------------------------------------------------

    def gc(self, protect: Iterable[tuple] = ()) -> int:
        """Evict oldest-written entries while over ``byte_budget``.

        ``protect`` lists plan keys that must survive (the engine passes
        its in-memory pinned set). Returns the number evicted. Protected
        entries never count as victims, so a store whose protected bytes
        alone exceed the budget simply stays over it.
        """
        shielded = {_entry_id(tuple(k)) for k in protect}
        evicted = 0
        with self._lock:
            entries = [(d.stat().st_mtime, d, self._entry_bytes(d)) for d in self._entry_dirs()]
            total = sum(b for _, _, b in entries)
            self.stats.bytes_in_store = total
            for _, d, size in sorted(entries, key=lambda e: e[0]):
                if total <= self.stats.byte_budget:
                    break
                if d.name in shielded:
                    continue
                shutil.rmtree(d, ignore_errors=True)
                total -= size
                evicted += 1
                self.stats.evictions += 1
                self.stats.bytes_in_store -= size
        return evicted
