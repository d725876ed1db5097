"""Logical query model for FastFrame.

Covers the paper's query class (§5.1, Figure 5): single-table AVG / SUM /
COUNT aggregates with arbitrary row filters, optional (composite) GROUP BY,
HAVING / ORDER BY ... LIMIT consumed via stopping conditions, and
expression aggregates over multiple columns (Appendix B) with certified
derived range bounds. A copy of :mod:`repro.aqp.query` for the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.derived_bounds import derived_range
from repro_torch.core.optstop import StoppingCondition


@dataclasses.dataclass(frozen=True)
class Filter:
    """Row predicate on one column."""

    column: str
    op: str          # 'eq' | 'ne' | 'gt' | 'ge' | 'lt' | 'le' | 'between' | 'isin'
    value: object

    def evaluate(self, block_cols: Dict[str, np.ndarray]) -> np.ndarray:
        col = block_cols[self.column]
        if self.op == "eq":
            return col == self.value
        if self.op == "ne":
            return col != self.value
        if self.op == "gt":
            return col > self.value
        if self.op == "ge":
            return col >= self.value
        if self.op == "lt":
            return col < self.value
        if self.op == "le":
            return col <= self.value
        if self.op == "between":
            lo, hi = self.value
            return (col >= lo) & (col <= hi)
        if self.op == "isin":
            return np.isin(col, np.asarray(self.value))
        raise ValueError(f"unknown op {self.op}")

    @property
    def categorical_eq(self) -> bool:
        return self.op in ("eq", "isin")

    def key(self) -> Tuple[str, str, str]:
        """Hashable identity of this predicate (array values normalized),
        used to key shared materialization caches and scan signatures."""
        return (self.column, self.op, repr(np.asarray(self.value).tolist()))


@dataclasses.dataclass(frozen=True)
class Expression:
    """Aggregate over f(c_1..c_n) with an Appendix-B range certificate.

    ``fn`` is called with numpy columns to evaluate the aggregate and with
    0-d float32 torch tensors to derive its range, so it must use only
    operators that both accept (arithmetic, comparisons, ``**``)."""

    fn: Callable  # dict of column arrays (numpy, or torch for bounds) -> array
    columns: Tuple[str, ...]
    monotone: Optional[Tuple[int, ...]] = None
    convex: Optional[bool] = None

    def derived_bounds(self, catalog: Dict[str, Tuple[float, float]]
                       ) -> Tuple[float, float]:
        boxes = [catalog[c] for c in self.columns]

        def vec_f(x):
            return self.fn({c: x[i] for i, c in enumerate(self.columns)})

        return derived_range(vec_f, boxes, monotone=self.monotone,
                             convex=self.convex)

    def evaluate(self, block_cols: Dict[str, np.ndarray]) -> np.ndarray:
        return np.asarray(self.fn(block_cols), dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class AggQuery:
    """One aggregate query (one Figure-5 template instance).

    Attributes:
        agg: aggregate function — ``'avg'`` | ``'sum'`` | ``'count'``.
        column: value column name, or an :class:`Expression` over several
            columns (Appendix B); unused for COUNT.
        filters: conjunction of row predicates (:class:`Filter`).
        group_by: optional GROUP BY column, or a tuple of columns for a
            composite grouping.
        stop: the :class:`~repro_torch.core.optstop.StoppingCondition` that ends
            sampling (HAVING / ORDER BY ... LIMIT / accuracy targets are
            all expressed this way); ``None`` forces exact processing.
        bounder: SSI bounder name (see
            :func:`repro_torch.core.bounders.get_bounder`).
        rangetrim: wrap the bounder in the RangeTrim asymmetrization
            (the paper's best configuration with ``'bernstein'``).
        delta: total failure probability budget; the returned intervals
            all hold simultaneously w.p. >= 1 - delta (Theorem 4).
    """

    agg: str                                   # 'avg' | 'sum' | 'count'
    column: Optional[Union[str, Expression]] = None
    filters: Tuple[Filter, ...] = ()
    group_by: Optional[Union[str, Tuple[str, ...]]] = None
    stop: Optional[StoppingCondition] = None   # None -> exact processing
    bounder: str = "bernstein"
    rangetrim: bool = True
    delta: float = 1e-15

    def __post_init__(self):
        if self.agg in ("avg", "sum") and self.column is None:
            raise ValueError(f"{self.agg} needs a column or Expression")

    @property
    def group_cols(self) -> Tuple[str, ...]:
        if self.group_by is None:
            return ()
        if isinstance(self.group_by, str):
            return (self.group_by,)
        return tuple(self.group_by)

    @property
    def needs_hist(self) -> bool:
        """Whether this query's bounder consumes the DKW histogram state
        (single source of truth for the engine, the CI refresh and the
        serving planner)."""
        return self.bounder == "anderson_dkw" and self.agg != "count"

    @property
    def value_key(self):
        """Hashable identity of the value column (None for COUNT, which
        never reads values). :class:`Expression` hashes by its ``fn``
        callable's identity — two lambdas with identical source are
        distinct keys — so serving workloads should construct an
        Expression once and reuse it across queries to share device
        materialization and fold slots."""
        return None if self.agg == "count" else self.column

    def scan_signature(self) -> Tuple:
        """(filters, column, group-by) identity. Two queries with equal
        signatures scan bitwise-identical device-resident value / mask /
        group-code columns, so they can share one fused-scan fold — this
        is the key of :class:`~repro_torch.aqp.engine.FastFrame`'s device
        materialization caches."""
        return (tuple(f.key() for f in self.filters), self.value_key,
                self.group_cols)


@dataclasses.dataclass
class QueryResult:
    """Engine output: per-group estimates + (1-delta) intervals + metrics.

    ``[lo[g], hi[g]]`` contains view ``g``'s true aggregate for ALL groups
    simultaneously w.p. >= 1 - delta (anytime-valid: the guarantee is
    unaffected by the data-dependent stopping rule). ``exact`` views were
    fully covered and collapse to a point; ``tainted`` views lost their
    clean scan prefix to an activity skip and carry the last clean
    (frozen) interval unless the recovery pass finished them exactly.
    The scan metrics (``blocks_*``, ``bitmap_probes``, ``rounds``) feed
    the paper's Table-5/Figure-7 style comparisons.
    """

    group_codes: np.ndarray       # (G,) composite codes (or [0])
    estimate: np.ndarray          # (G,)
    lo: np.ndarray                # (G,)
    hi: np.ndarray                # (G,)
    count_seen: np.ndarray        # (G,) sample rows per view
    nonempty: np.ndarray          # (G,) bool: view observed at least once
    exact: np.ndarray             # (G,) bool: view fully covered (exact)
    tainted: np.ndarray           # (G,) bool: clean scan prefix broken
    rows_covered: int
    blocks_fetched: int
    blocks_skipped_active: int
    blocks_skipped_static: int
    bitmap_probes: int
    rounds: int
    wall_time_s: float
    stopped_early: bool

    def having(self, op: str, threshold: float) -> np.ndarray:
        """Group codes whose TRUE aggregate is on the given side w.h.p."""
        if op == "gt":
            sel = self.lo > threshold
        elif op == "lt":
            sel = self.hi < threshold
        else:
            raise ValueError(op)
        return self.group_codes[sel & self.nonempty]

    def topk(self, k: int, largest: bool = True) -> np.ndarray:
        est = np.where(self.nonempty, self.estimate,
                       -np.inf if largest else np.inf)
        order = np.argsort(-est if largest else est)
        return self.group_codes[order[:k]]

    def order(self, ascending: bool = True) -> np.ndarray:
        idx = np.nonzero(self.nonempty)[0]
        est = self.estimate[idx]
        srt = idx[np.argsort(est if ascending else -est)]
        return self.group_codes[srt]
