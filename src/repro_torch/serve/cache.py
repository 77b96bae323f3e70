"""LRU plan cache with a byte-budget eviction policy and pinning.

The :class:`~repro_torch.core.fastcv.CVPlan` is the expensive, label-invariant
half of the paper's economics (§2.7): O(N²P + N³ + K·m³) to build, O(K·m²)
to use. The cache keys plans by the content fingerprint of
(X, folds, λ, mode, train-block) — see :func:`repro_torch.core.fastcv.plan_key` —
so any number of tenants asking about the same dataset share one build.

Eviction is least-recently-used under a *byte* budget (plans from different
datasets differ wildly in size: N=64 LOO vs N=4096 10-fold is a ~4000×
spread, so an entry-count LRU would be meaningless). Admission control: a
single plan larger than the whole budget is *not* admitted — it is served
un-cached (``get_or_build`` still returns it) and counted in
``stats.oversized``, rather than evicting every resident plan to make room
for an entry that can never fit.

Pinning: :meth:`PlanCache.pin` marks a resident plan as a first-class,
pre-warmed resource (the warm-up workflow of the serving engine). Pinned
plans are never LRU-evicted and their bytes are *excluded* from the
byte-budget pressure calculation — pinning is an operator statement that
the plan's memory is budgeted elsewhere — with counts in ``stats.pinned``
/ ``stats.pinned_bytes``. :meth:`PlanCache.unpin` re-subjects the entry to
ordinary LRU pressure.

Thread safety: one coarse lock around all operations. ``get_or_build``
holds it across the build, which doubles as single-flight semantics —
concurrent requests for the same missing plan trigger exactly one build.

The module is the reference package's ``serve/cache.py`` over this
package's :class:`CVPlan`; ``CVPlan.nbytes`` (the bytes of its tensors on
their device) is the budget's unit.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Hashable, Optional

from repro_torch.core.fastcv import CVPlan

__all__ = ["CacheStats", "PlanCache"]


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0  # builds (cached inserts + oversized un-cached)
    evictions: int = 0
    oversized: int = 0  # builds served un-cached (nbytes > byte_budget)
    pinned: int = 0  # entries currently pinned (never evicted)
    pinned_bytes: int = 0  # bytes held by pinned entries (outside pressure)
    bytes_in_use: int = 0
    byte_budget: int = 0

    @property
    def entries_alive(self) -> int:
        # inserts (misses minus un-cached builds) minus removals
        return self.misses - self.oversized - self.evictions

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlanCache:
    """LRU ``plan_key -> CVPlan`` map bounded by device bytes."""

    # Concurrency contract, machine-checked by reprolint RL004: every
    # mutation of the entry map, pin set or stats happens under _lock.
    _GUARDED_BY = {"_entries": "_lock", "_pinned": "_lock", "stats": "_lock"}
    # _evict_over_budget is only reached from put() with _lock held.
    _LOCKED_HELPERS = ("_evict_over_budget",)

    def __init__(self, byte_budget: int = 512 << 20):
        if byte_budget <= 0:
            raise ValueError("byte_budget must be positive")
        self._lock = threading.RLock()
        self._entries: "OrderedDict[Hashable, CVPlan]" = OrderedDict()
        self._pinned: set = set()
        self.stats = CacheStats(byte_budget=byte_budget)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def peek(self, key: Hashable) -> Optional[CVPlan]:
        """Locked lookup without recency refresh or stats — introspection
        (e.g. the engine's ``datasets()`` residency view), not serving."""
        with self._lock:
            return self._entries.get(key)

    def get(self, key: Hashable) -> Optional[CVPlan]:
        """Return the cached plan (refreshing recency) or None on miss.

        Only ``get_or_build`` counts misses: a bare failed probe is not a
        build, and counting it would let lookups double-count with the
        subsequent ``put``.
        """
        with self._lock:
            plan = self._entries.get(key)
            if plan is None:
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return plan

    def put(self, key: Hashable, plan: CVPlan) -> bool:
        """Insert (counted as a miss) and evict LRU entries over budget.

        Admission control: a plan that could never fit (``nbytes`` above
        the whole budget) is rejected — counted as a miss (it was a build)
        *and* in ``stats.oversized``, resident entries untouched. Returns
        whether the plan was admitted.
        """
        with self._lock:
            if plan.nbytes > self.stats.byte_budget:
                self.stats.misses += 1
                self.stats.oversized += 1
                return False
            if key in self._entries:  # replace without re-counting
                old = self._entries.pop(key)
                self.stats.bytes_in_use -= old.nbytes
                self.stats.misses -= 1
                if key in self._pinned:
                    self.stats.pinned_bytes += plan.nbytes - old.nbytes
            self._entries[key] = plan
            self.stats.misses += 1
            self.stats.bytes_in_use += plan.nbytes
            self._evict_over_budget()
            return True

    # -- pinning -----------------------------------------------------------

    def pin(self, key: Hashable) -> bool:
        """Exempt a resident plan from LRU eviction and budget pressure.

        Returns False (no-op) when the key is absent; idempotent when it
        is already pinned.
        """
        with self._lock:
            plan = self._entries.get(key)
            if plan is None:
                return False
            if key not in self._pinned:
                self._pinned.add(key)
                self.stats.pinned += 1
                self.stats.pinned_bytes += plan.nbytes
            return True

    def unpin(self, key: Hashable) -> bool:
        """Re-subject a pinned plan to ordinary LRU pressure.

        The entry stays resident (freshly most-recent) but its bytes count
        against the budget again, so eviction may immediately reclaim
        colder entries. Returns False when the key was not pinned.
        """
        with self._lock:
            if key not in self._pinned:
                return False
            self._pinned.discard(key)
            self.stats.pinned -= 1
            self.stats.pinned_bytes -= self._entries[key].nbytes
            self._entries.move_to_end(key)
            self._evict_over_budget()
            return True

    def pinned_keys(self) -> tuple:
        with self._lock:
            return tuple(self._pinned)

    def remove(self, key: Hashable) -> bool:
        """Explicitly drop one entry (handle-scoped eviction).

        Unpins first if needed; counted as an eviction. Returns whether the
        key was resident.
        """
        with self._lock:
            plan = self._entries.pop(key, None)
            if plan is None:
                return False
            if key in self._pinned:
                self._pinned.discard(key)
                self.stats.pinned -= 1
                self.stats.pinned_bytes -= plan.nbytes
            self.stats.bytes_in_use -= plan.nbytes
            self.stats.evictions += 1
            return True

    def _evict_over_budget(self) -> None:
        # Pressure counts unpinned bytes only; victims are the LRU
        # *unpinned* entries (pinned plans are exempt by contract).
        while self.stats.bytes_in_use - self.stats.pinned_bytes > self.stats.byte_budget:
            victim = next((k for k in self._entries if k not in self._pinned), None)
            if victim is None:
                break
            evicted = self._entries.pop(victim)
            self.stats.bytes_in_use -= evicted.nbytes
            self.stats.evictions += 1

    def get_or_build(
        self,
        key: Hashable,
        build: Callable[[], CVPlan],
        fetch: Optional[Callable[[], Optional[CVPlan]]] = None,
    ) -> tuple[CVPlan, bool]:
        """Return ``(plan, was_hit)``; builds (single-flight) on miss.

        ``fetch`` is the optional second tier between memory and build —
        the engine passes the disk-backed plan store's verified ``load``.
        A fetched plan is admitted like a fresh build (it *was* a cache
        miss, just resolved cheaply) and returned with ``was_hit=False``,
        so cache hit/miss stats keep meaning "resident in memory".

        An oversized build is still returned to the caller — the engine
        must serve it — it just never enters the cache (see ``put``).
        """
        with self._lock:
            plan = self.get(key)
            if plan is not None:
                return plan, True
            if fetch is not None:
                plan = fetch()
                if plan is not None:
                    self.put(key, plan)
                    return plan, False
            plan = build()
            self.put(key, plan)
            return plan, False

    def clear(self) -> None:
        """Drop every entry, pinned ones included (counted as evictions)."""
        with self._lock:
            for plan in self._entries.values():
                self.stats.bytes_in_use -= plan.nbytes
                self.stats.evictions += 1
            self._entries.clear()
            self._pinned.clear()
            self.stats.pinned = 0
            self.stats.pinned_bytes = 0
