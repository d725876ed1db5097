"""Host-side pass checkpoints for fault-tolerant serving.

The port of :mod:`repro.serve.checkpoint` (numpy only). A
:class:`~repro_torch.serve.frame_server.SharedPass` mutates three kinds
of state as it steps: the per-slot shared fold state
(:class:`~repro_torch.aqp.engine._ScanViews` — moments, histogram,
coverage, taint), the per-query interval state
(:class:`~repro_torch.aqp.engine._QueryIntervals` — OptStop lo/hi/est,
activity) and the pass cursor (``pos``/``rounds``/``n_live``/``wrap``).
Every step boundary of the device loop is *fully merged* (a sharded
pass's collective cadence flushes before a step returns: at the end of
every chunk asked for, or once a step with the default chunks has run
the pass to its end; the host loop merges every round), so a snapshot
taken at a round/chunk boundary is a **sound resume point**: restoring
it and stepping forward replays the exact fold/coverage/taint sequence,
and every result produced after resume is bitwise-identical to the
uninterrupted run (``tests/test_torch_scheduler.py`` asserts this).

:class:`PassCheckpoint` is that snapshot: a plain host pytree (numpy
arrays + python scalars, produced by the ``export_state`` methods) plus
the pass metadata needed to rebuild the pass from scratch. Queries are
held **by reference** — ticket identity in the scheduler is ``id(query)``
and the checkpoint preserves it, so a restored pass answers
``result_of(q)`` for the same query objects. Checkpoints never hold
device buffers: restoring re-materializes columns through the frame's
device caches (a cache hit in steady state).

The checkpoint also carries the results already finalized at snapshot
time (including queries whose slots were since retired), so a restore
never loses a finished answer and never re-runs one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.aqp.query import AggQuery, QueryResult

__all__ = ["PassCheckpoint", "SlotCheckpoint"]


@dataclass
class SlotCheckpoint:
    """Frozen state of one pass slot: its queries (by reference), the
    carousel coordinates fixed at admission, and the mutable fold /
    interval state as host pytrees (``_ScanViews.export_state`` /
    ``_QueryIntervals.export_state`` dicts, ``qcs[i]`` belonging to
    ``queries[i]``)."""

    queries: List[AggQuery]
    anchor: int
    join_round: int
    row_offset: int
    lap_done_round: object          # Optional[int]
    metrics: Dict[str, int]
    views: Dict[str, object]
    qcs: List[Dict[str, object]]
    # per-slot cursor (pass coordinates). ``None`` = pre-per-slot-cursor
    # snapshot: restore falls back to the shared pass cursor clamped to
    # the slot's lap end, which is exactly where the shared-cursor loop
    # had this slot.
    pos: object = None              # Optional[int]


@dataclass
class PassCheckpoint:
    """Complete restartable snapshot of a :class:`SharedPass` at a
    round/chunk boundary. ``results``/``t0s`` are keyed by
    ``id(query)`` (the scheduler's ticket identity)."""

    filters: Tuple
    sampling: str
    start: int
    max_rounds: int
    pos: int
    rounds: int
    n_live: int
    wrap: bool
    slots: List[SlotCheckpoint] = field(default_factory=list)
    results: Dict[int, QueryResult] = field(default_factory=dict)
    t0s: Dict[int, float] = field(default_factory=dict)
    # the divided-scan layout (n_shards, shard_rows, merge_every) of the
    # pass that took the snapshot, None when it ran on one device. The
    # snapshot is merged host state, so it restores onto any layout (the
    # unsharded rung resumes a sharded pass's); only a wrapped one
    # refuses a cadence pass.
    layout: Optional[Tuple[int, int, int]] = None

    @property
    def queries(self) -> List[AggQuery]:
        """All live (slot-resident) queries, slot-major order."""
        return [q for s in self.slots for q in s.queries]
