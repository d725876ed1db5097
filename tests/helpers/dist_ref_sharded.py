"""Subprocess: sharded scenarios through the reference's OWN sharded
round loop (``shard_map`` over 2 fake CPU devices), results and
scrambles saved for the port to match.

    XLA_FLAGS=--xla_force_host_platform_device_count=2 \\
        python tests/helpers/dist_ref_sharded.py OUT.npz

Runs ``scenario_groupby_topk``'s and ``scenario_exhaustion_bitwise``'s
query (``tests/helpers/sharded_scenarios.py``) with ``shard_rows=True``,
and the collective cadence in the reference's default (unchunked)
dispatch: ``scenario_cadence_early_stop``'s query at ``merge_every=4``;
over 4-block rounds, so that the port's run crosses several of its
chunks, an AVG by airline whose K=4 stop is decided by the merge at
round 32 (the end of the port's second 16-round chunk), the same query
with a looser width at K=3 (chunks of 18), the integer exhaustion at
K=5 (chunks of 20; CIs bit for bit), and a ``FrameServer.run_batch`` at
K=4 (the pass loop's cadence) on FLIGHTS in 16-row blocks, where a
ThresholdSide AVG by origin, alone in its probe slot, has groups go
inactive at merges between two of the port's chunks, which changes the
next round's probe verdicts. Writes, per run, the scramble's arrays and
each result's exact and CI fields to OUT.npz (no pickles), with a JSON
``meta`` entry that ``tests/helpers/torch_dist_worker.py``'s
``match_reference`` reads.
"""

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=2")
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_enable_x64", True)  # the device loop needs f64

from repro.aqp import (AggQuery, EngineConfig, FastFrame,  # noqa: E402
                       build_scramble)
from repro.core.optstop import (AbsoluteWidth, ThresholdSide,  # noqa: E402
                                TopKSeparated)
from repro.data import flights  # noqa: E402
from repro.serve import FrameServer  # noqa: E402
from tests.helpers import sharded_scenarios as S  # noqa: E402


def topk():
    return AggQuery(agg="avg", column="dep_delay", group_by="origin",
                    stop=TopKSeparated(k=2, largest=True), delta=1e-9)


def exhaustion():
    return AggQuery(agg="avg", column="v", group_by="g",
                    stop=AbsoluteWidth(eps=1e-9), delta=1e-9)


def airline_width(eps):
    return lambda: AggQuery(agg="avg", column="dep_delay",
                            group_by="airline", stop=AbsoluteWidth(eps=eps),
                            delta=1e-6)


def sparse_scramble():
    """FLIGHTS in blocks of 16 rows: an airport is absent from most
    blocks, so a group that goes inactive changes the probe's verdicts."""
    ds = flights.generate(n_rows=60_000, n_airports=30, n_airlines=5,
                          seed=3)
    return build_scramble(ds.columns, catalog=ds.catalog, block_rows=16,
                          seed=4)


def origin_threshold(t):
    return lambda: AggQuery(agg="avg", column="dep_delay",
                            group_by="origin",
                            stop=ThresholdSide(threshold=t), delta=1e-6)


TOPK = (topk, ("topk_query", {}))
EXHAUST = (exhaustion, ("exhaustion_query", {}))
WIDTH = {eps: (airline_width(eps), ("airline_width_query", {"eps": eps}))
         for eps in (60.0, 80.0)}

# (name, scramble, queries as (reference builder, (the port's builder in
# tests/helpers/torch_sharded_scenarios.py, its arguments)), batch (one
# FrameServer.run_batch) or one FastFrame.run, sampling, config over
# S.CFG, bitwise CIs)
RUNS = [
    ("groupby_topk", S.flights_scramble, [TOPK], False, "active_peek", {},
     False),
    ("exhaustion_bitwise", S._integer_scramble, [EXHAUST], False,
     "active_peek", {}, True),
    ("cadence_early_stop", S.flights_scramble, [TOPK], False, "scan",
     dict(merge_every=4), False),
    ("cadence_stop_at_chunk_end", S.flights_scramble, [WIDTH[80.0]], False,
     "scan", dict(merge_every=4, round_blocks=4), False),
    ("cadence_stop_k3", S.flights_scramble, [WIDTH[60.0]], False, "scan",
     dict(merge_every=3, round_blocks=4), False),
    ("cadence_exhaustion_k5", S._integer_scramble, [EXHAUST], False,
     "active_peek", dict(merge_every=5, round_blocks=4), True),
    ("cadence_server_batch", sparse_scramble,
     [(origin_threshold(0.0), ("origin_threshold_query", {"t": 0.0})),
      WIDTH[80.0]], True, "active_peek",
     dict(merge_every=4), False),
]


def main(out: str) -> None:
    assert jax.device_count() == 2, jax.devices()
    arrays, meta = {}, {}
    for name, make_sc, queries, batch, sampling, over, bitwise in RUNS:
        sc = make_sc()
        frame = FastFrame(sc, EngineConfig(shard_rows=True,
                                           **dict(S.CFG, **over)))
        qs = [make_q() for make_q, _ in queries]
        results = (FrameServer(frame).run_batch(
            qs, sampling=sampling, seed=1, start_block=0) if batch
            else [frame.run(qs[0], sampling=sampling, seed=1,
                            start_block=0)])
        for c, a in sc.columns.items():
            arrays[f"{name}/col/{c}"] = np.asarray(a)
        arrays[f"{name}/valid"] = np.asarray(sc.valid)
        for i, res in enumerate(results):
            for f in S.EXACT_FIELDS + S.CI_FIELDS:
                arrays[f"{name}/res/{i}/{f}"] = np.asarray(getattr(res, f))
        meta[name] = dict(
            columns=list(sc.columns), n_rows=int(sc.n_rows),
            block_rows=int(sc.block_rows),
            catalog={k: [float(x) for x in v]
                     for k, v in sc.catalog.items()},
            categorical={k: int(v) for k, v in sc.categorical.items()},
            seed=int(sc.seed), queries=[q for _, q in queries],
            batch=batch, sampling=sampling, config=over, bitwise=bitwise,
            rounds=[int(r.rounds) for r in results])
    np.savez(out, meta=np.asarray(json.dumps(meta)), **arrays)
    print("REF-SHARDED-OK", json.dumps({k: v["rounds"]
                                        for k, v in meta.items()}))


if __name__ == "__main__":
    main(sys.argv[1])
