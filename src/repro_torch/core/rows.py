"""Dense row registry: the fleet-plane churn discipline, once.

Every batched plane keys dense per-entity arrays by an id -> row map
with the same three rules: rows are handed out in insertion order,
capacity grows by amortized doubling (10k-camera setup must not
reallocate 10k times), and removal swap-compacts with the last live
row so arrays stay dense (capacity is retained; rows beyond len() are
garbage). `FleetDriftDetector` and `FleetTransmissionPlane` both build
on this registry instead of hand-rolling the discipline; the registry
tracks ids and capacity, the owner moves its own array rows on the
(dst, src) swap the registry reports.

Shard-awareness: when the owner's dense arrays are split along the row
axis across devices, capacity must stay divisible by the device count
or every growth/churn event re-pads the global shape and re-lays rows
across devices. `align` pins capacity to a multiple of the shard
count, so the row axis always splits into equal contiguous per-device
blocks; `shard_spans` reports those blocks. Churn then never reshards
the world: adds land in the dense prefix, swap-with-last moves copy one
row between (possibly different) device blocks, and capacity growth
keeps the same block structure. In this port no plane is sharded yet
(the distribution module is queued in ROADMAP.md), so owners keep
align = 1; the registry is copied whole so that a reference plane's
state and this one's stay row-for-row the same.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class RowRegistry:
    """id -> dense row index. Owners size their arrays to `capacity`
    after `add`/`reserve` and apply the row move `remove` returns."""

    def __init__(self, capacity: int = 8, *, align: int = 1):
        self._row: Dict[str, int] = {}
        self._ids: List[str] = []
        self.align = max(1, int(align))
        self.capacity = self._aligned(max(1, int(capacity)))
        #: bumped on every membership change (add/remove); owners use it
        #: to invalidate row-lookup caches cheaply.
        self.generation = 0

    def _aligned(self, n: int) -> int:
        a = self.align
        return ((int(n) + a - 1) // a) * a

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, rid: str) -> bool:
        return rid in self._row

    def __getitem__(self, rid: str) -> int:
        """Row of `rid`; KeyError when absent."""
        return self._row[rid]

    def get(self, rid: str) -> Optional[int]:
        return self._row.get(rid)

    @property
    def ids(self) -> List[str]:
        """row -> id, in row order (a copy)."""
        return list(self._ids)

    def rows_of(self, rids: Sequence[str]) -> Optional[List[int]]:
        """Rows for `rids` in one pass, or None when any id is absent
        (callers fall back to the add path). One dict lookup per id —
        the fleet window loop calls this with the full stream list."""
        row = self._row
        try:
            return [row[r] for r in rids]
        except KeyError:
            return None

    def is_row_order(self, rids: Sequence[str]) -> bool:
        """True when `rids` is exactly the full live id list in row
        order — the fleet window loop's shape. Owners use this to skip
        per-id dict lookups and fancy-indexed gathers (a contiguous
        [0, n) prefix slices instead): at 10k+ rows the lookup+gather
        path is cache-miss-bound and costs more than the math it
        feeds. The check itself is one list compare — identical string
        objects short-circuit to pointer equality."""
        ids = self._ids
        if len(rids) != len(ids):
            return False
        return rids is ids or list(rids) == ids

    def set_align(self, align: int) -> int:
        """Pin capacity to a multiple of `align` (the device count of a
        row-sharded owner). Returns the (possibly grown) capacity for the owner to
        size its arrays against."""
        self.align = max(1, int(align))
        self.capacity = self._aligned(self.capacity)
        return self.capacity

    def shard_spans(self, n_shards: Optional[int] = None
                    ) -> List[Tuple[int, int]]:
        """Half-open [lo, hi) row spans: the contiguous per-device
        blocks a NamedSharding along the row axis produces. Requires
        capacity % n_shards == 0 (use `align`). Live rows occupy the
        dense prefix, so block i holds live rows
        [lo, min(hi, len(self)))."""
        n = self.align if n_shards is None else int(n_shards)
        if n < 1 or self.capacity % n:
            raise ValueError(
                f"capacity {self.capacity} not divisible by {n} shards "
                f"(set align first)")
        blk = self.capacity // n
        return [(i * blk, (i + 1) * blk) for i in range(n)]

    def shard_counts(self, n_shards: Optional[int] = None) -> List[int]:
        """Live rows per shard block (load balance diagnostics)."""
        live = len(self._ids)
        return [max(0, min(hi, live) - lo)
                for lo, hi in self.shard_spans(n_shards)]

    def reserve(self, extra: int) -> int:
        """Grow capacity to hold `extra` more rows (amortized doubling,
        rounded up to the shard alignment); returns the new capacity for
        the owner to size arrays against."""
        need = len(self._ids) + int(extra)
        if need > self.capacity:
            self.capacity = self._aligned(max(need, 2 * self.capacity))
        return self.capacity

    def add(self, rid: str) -> Tuple[int, bool]:
        """(row, is_new). New ids append at the dense end; existing ids
        return their current row. Grows capacity as needed — the owner
        must re-check its array sizes against `capacity` afterwards."""
        row = self._row.get(rid)
        if row is not None:
            return row, False
        self.reserve(1)
        row = len(self._ids)
        self._row[rid] = row
        self._ids.append(rid)
        self.generation += 1
        return row, True

    def remove(self, rid: str) -> Optional[Tuple[int, int]]:
        """Swap-with-last removal. Returns None when `rid` is absent;
        otherwise (dst, src): when dst != src the owner must copy array
        row src into dst (the vacated slot inherits the previous last
        row — never a stale departed entity's state)."""
        row = self._row.pop(rid, None)
        if row is None:
            return None
        last = len(self._ids) - 1
        if row != last:
            moved = self._ids[last]
            self._ids[row] = moved
            self._row[moved] = row
        self._ids.pop()
        self.generation += 1
        return row, last
