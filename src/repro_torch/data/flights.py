"""Synthetic FLIGHTS-schema generator (paper §5.1, Table 3).

The paper evaluates on the public FLIGHTS dump (606M rows x 5 attrs,
replicated 5x). That dump is not redistributable here, so we synthesize a
relation with the same schema and the *data characteristics the paper's
queries exercise*:

  * ``origin``      — ~``n_airports`` categories with Zipf-like frequencies
                      (sparse groups: the F-q1/F-q3/F-q5 bottleneck);
  * ``airline``     — ~``n_airlines`` categories, milder skew;
  * ``dep_delay``   — per-(airline, origin) location shift + heavy-ish
                      right tail (lognormal component), truncated to the
                      catalog range [-60, 1800] minutes. A handful of
                      airports get negative mean delay so F-q5 has a
                      nonempty answer; rare genuine outliers near the top
                      of the range create the PHOS/PMA regime of Figure 2;
  * ``dep_time``    — minutes after midnight, airline-correlated so F-q3's
                      min_dep_time sweep changes group spreads (Figure 8);
  * ``day_of_week`` — 1..7 with weekday/weekend delay interaction (F-q6/7).

Row count is a parameter; benchmarks report the scale they ran.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

DELAY_RANGE = (-60.0, 1800.0)  # catalog range for dep_delay (minutes)


@dataclasses.dataclass
class FlightsDataset:
    columns: Dict[str, np.ndarray]
    airports: np.ndarray        # airport name table
    airlines: np.ndarray
    catalog: Dict[str, tuple]   # continuous-column catalog ranges

    @property
    def n_rows(self) -> int:
        return next(iter(self.columns.values())).shape[0]


def generate(n_rows: int = 1_000_000, n_airports: int = 200,
             n_airlines: int = 14, seed: int = 0) -> FlightsDataset:
    rng = np.random.default_rng(seed)

    # Zipf-ish airport popularity (few hubs, long sparse tail).
    ranks = np.arange(1, n_airports + 1, dtype=np.float64)
    p_airport = (1.0 / ranks**1.1)
    p_airport /= p_airport.sum()
    origin = rng.choice(n_airports, size=n_rows, p=p_airport).astype(np.int32)

    p_airline = rng.dirichlet(np.full(n_airlines, 3.0))
    airline = rng.choice(n_airlines, size=n_rows,
                         p=p_airline).astype(np.int32)

    # Per-entity delay locations: most airports slightly positive. The
    # ahead-of-schedule (negative-mean) airports — the F-q5 bottleneck —
    # and a couple of extreme-delay airports (F-q8's top contenders) are
    # deliberately SPARSE (high Zipf rank), reproducing the paper's
    # "sparse groups bottleneck termination" regime that makes active
    # scanning worthwhile (§5.4.2).
    airport_mu = rng.normal(8.0, 4.0, size=n_airports)
    sparse_half = np.arange(n_airports // 2, n_airports)
    neg = sparse_half[::5]
    airport_mu[neg] = rng.normal(-4.0, 1.0, size=neg.shape)
    hot = sparse_half[3::11]
    airport_mu[hot] = rng.normal(55.0, 2.0, size=hot.shape)
    airline_mu = np.linspace(0.0, 14.0, n_airlines)  # spreads F-q2 aggregates
    rng.shuffle(airline_mu)

    dep_time = (rng.beta(2.2, 1.6, size=n_rows) * 1440.0)
    # later flights delayed more, with airline-dependent slope (Figure 8)
    airline_slope = rng.uniform(0.0, 12.0, size=n_airlines)
    time_effect = airline_slope[airline] * (dep_time / 1440.0)

    base = airport_mu[origin] + airline_mu[airline] + time_effect
    noise = rng.normal(0.0, 9.0, size=n_rows)
    tail = rng.lognormal(2.2, 1.1, size=n_rows) * (rng.random(n_rows) < 0.06)
    outlier = np.where(rng.random(n_rows) < 2e-5,
                       rng.uniform(1200.0, DELAY_RANGE[1], size=n_rows), 0.0)
    dep_delay = np.clip(base + noise + tail + outlier, *DELAY_RANGE)

    day_of_week = rng.integers(1, 8, size=n_rows).astype(np.int32)
    dep_delay += np.where(day_of_week >= 6, -2.0, 1.0)  # weekend relief
    dep_delay = np.clip(dep_delay, *DELAY_RANGE).astype(np.float32)

    columns = {
        "origin": origin,
        "airline": airline,
        "dep_delay": dep_delay,
        "dep_time": dep_time.astype(np.float32),
        "day_of_week": day_of_week,
    }
    catalog = {
        "dep_delay": DELAY_RANGE,
        "dep_time": (0.0, 1440.0),
    }
    airports = np.array([f"A{i:03d}" for i in range(n_airports)])
    airlines_tbl = np.array([f"L{i:02d}" for i in range(n_airlines)])
    return FlightsDataset(columns=columns, airports=airports,
                          airlines=airlines_tbl, catalog=catalog)
