"""The paper's FLIGHTS query suite (Figure 5 / Table 4) as AggQuery builders.

Each builder takes the template parameters the paper varies (shown in blue
in Figure 5) plus the bounder configuration under ablation. A copy of
:mod:`repro.aqp.flights_queries` for the port.
"""

from __future__ import annotations

from repro_torch.aqp.query import AggQuery, Filter
from repro_torch.core.optstop import (GroupsOrdered, RelativeWidth, ThresholdSide,
                                TopKSeparated)

DELTA = 1e-15  # paper §5.2


def _bk(bounder: str, rangetrim: bool, delta: float):
    return dict(bounder=bounder, rangetrim=rangetrim, delta=delta)


def f_q1(airport: int, eps: float = 0.5, bounder: str = "bernstein",
         rangetrim: bool = True, delta: float = DELTA) -> AggQuery:
    """AVG delay for $airport; stop at relative accuracy eps (cond. ③)."""
    return AggQuery(agg="avg", column="dep_delay",
                    filters=(Filter("origin", "eq", airport),),
                    stop=RelativeWidth(eps=eps), **_bk(bounder, rangetrim,
                                                       delta))


def f_q2(thresh: float, bounder: str = "bernstein", rangetrim: bool = True,
         delta: float = DELTA) -> AggQuery:
    """Airlines with AVG delay above $thresh (HAVING; cond. ④)."""
    return AggQuery(agg="avg", column="dep_delay", group_by="airline",
                    stop=ThresholdSide(threshold=thresh),
                    **_bk(bounder, rangetrim, delta))


def f_q3(min_dep_time: float, bounder: str = "bernstein",
         rangetrim: bool = True, delta: float = DELTA) -> AggQuery:
    """2 airlines with min AVG delay after $min_dep_time (cond. ⑤)."""
    return AggQuery(agg="avg", column="dep_delay", group_by="airline",
                    filters=(Filter("dep_time", "gt", min_dep_time),),
                    stop=TopKSeparated(k=2, largest=False),
                    **_bk(bounder, rangetrim, delta))


def f_q4(airport: int = 0, thresh: float = 10.0,
         bounder: str = "bernstein", rangetrim: bool = True,
         delta: float = DELTA) -> AggQuery:
    """Whether ORD-analogue has AVG delay > 10 (cond. ④)."""
    return AggQuery(agg="avg", column="dep_delay",
                    filters=(Filter("origin", "eq", airport),),
                    stop=ThresholdSide(threshold=thresh),
                    **_bk(bounder, rangetrim, delta))


def f_q5(bounder: str = "bernstein", rangetrim: bool = True,
         delta: float = DELTA) -> AggQuery:
    """Airports with negative AVG delay (HAVING; cond. ④ at 0)."""
    return AggQuery(agg="avg", column="dep_delay", group_by="origin",
                    stop=ThresholdSide(threshold=0.0),
                    **_bk(bounder, rangetrim, delta))


def f_q6(dep_time: float = 13 * 60 + 50, k: int = 5,
         bounder: str = "bernstein", rangetrim: bool = True,
         delta: float = DELTA) -> AggQuery:
    """5 worst (day, airport) pairs for afternoon delays (cond. ⑤)."""
    return AggQuery(agg="avg", column="dep_delay",
                    group_by=("day_of_week", "origin"),
                    filters=(Filter("dep_time", "gt", dep_time),),
                    stop=TopKSeparated(k=k, largest=True),
                    **_bk(bounder, rangetrim, delta))


def f_q7(airline: int, bounder: str = "bernstein", rangetrim: bool = True,
         delta: float = DELTA) -> AggQuery:
    """AVG delay by day of week for one airline (cond. ⑥: full order)."""
    return AggQuery(agg="avg", column="dep_delay", group_by="day_of_week",
                    filters=(Filter("airline", "eq", airline),),
                    stop=GroupsOrdered(), **_bk(bounder, rangetrim, delta))


def f_q8(bounder: str = "bernstein", rangetrim: bool = True,
         delta: float = DELTA) -> AggQuery:
    """Origin airport with highest AVG delay (cond. ⑤, top-1)."""
    return AggQuery(agg="avg", column="dep_delay", group_by="origin",
                    stop=TopKSeparated(k=1, largest=True),
                    **_bk(bounder, rangetrim, delta))


def f_q9(bounder: str = "bernstein", rangetrim: bool = True,
         delta: float = DELTA) -> AggQuery:
    """Airline with max AVG delay (cond. ⑤, top-1)."""
    return AggQuery(agg="avg", column="dep_delay", group_by="airline",
                    stop=TopKSeparated(k=1, largest=True),
                    **_bk(bounder, rangetrim, delta))


ALL = {
    "F-q1": lambda **kw: f_q1(airport=0, **kw),
    "F-q2": lambda **kw: f_q2(thresh=8.0, **kw),
    "F-q3": lambda **kw: f_q3(min_dep_time=22 * 60 + 50, **kw),
    "F-q4": lambda **kw: f_q4(**kw),
    "F-q5": lambda **kw: f_q5(**kw),
    "F-q6": lambda **kw: f_q6(**kw),
    "F-q7": lambda **kw: f_q7(airline=3, **kw),
    "F-q8": lambda **kw: f_q8(**kw),
    "F-q9": lambda **kw: f_q9(**kw),
}
