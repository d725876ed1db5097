"""One rank of a gloo world on the CPU, for the port's sharded-scan tests.

    python -m tests.helpers.torch_dist_worker RANK WORLD STORE TIMEOUT_S

Joins the default group (gloo, a ``FileStore`` at STORE, the group's
timeout TIMEOUT_S seconds, so a collective that a rank never joins fails
instead of hanging), runs torch on one thread, then answers commands, one
JSON object a line on its standard input (``{"op": ..., "args":
{...}}``), each with one line on its standard output after
``torch_dist_world.MARK``: ``{"ok": true, "out": ...}`` or ``{"ok":
false, "error": traceback}``. ``{"op": "exit"}`` leaves. Driven by
:class:`tests.helpers.torch_dist_world.DistWorld`; imports no JAX.
"""

import datetime
import json
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from tests.helpers import torch_sharded_scenarios as scen
from tests.helpers import torch_sharded_serve_ops, torch_sharded_train_ops
from tests.helpers.torch_dist_world import MARK


def op_scenario(name: str):
    t0 = time.perf_counter()
    getattr(scen, name)()
    return {"seconds": time.perf_counter() - t0}


def op_fold_bitwise():
    """The mirror of ``tests/helpers/dist_aqp_bitwise_worker.py``: the
    collective fold over this world's ranks equals the single-device
    ``grouped_moments`` fold bit for bit on exactly representable data,
    with and without the histogram; on general data the counts and
    extremes stay exact and the moments agree to float32 rounding."""
    from repro_torch.aqp.distributed import make_sharded_fold, shard_rows
    from repro_torch.kernels import ops
    g, center = 32, 2.0
    n = dist.get_world_size() * 512
    gids = (np.arange(n) % g).astype(np.int32)
    values = (((np.arange(n) * 7) // 5 + gids) % 5).astype(np.float32)
    mask = np.ones(n, np.float32)
    t = lambda a: torch.from_numpy(a)
    ref = ops.grouped_moments(t(values), t(gids), t(mask), g, center)
    fold = make_sharded_fold(None, g, center)
    merged = fold(*shard_rows(None, t(values), t(gids), t(mask)))
    for name in ("count", "mean", "m2", "vmin", "vmax"):
        np.testing.assert_array_equal(getattr(merged, name).numpy(),
                                      getattr(ref, name).numpy(),
                                      err_msg=name)
    fold_h = make_sharded_fold(None, g, center, with_hist=True,
                               hist_bins=128, hist_range=(0.0, 5.0))
    merged_h, hist = fold_h(*shard_rows(None, t(values), t(gids), t(mask)))
    for name in ("count", "mean", "m2", "vmin", "vmax"):
        np.testing.assert_array_equal(getattr(merged_h, name).numpy(),
                                      getattr(ref, name).numpy(),
                                      err_msg="hist-" + name)
    ref_h = ops.grouped_hist(t(values), t(gids), t(mask), g, 0.0, 5.0,
                             nbins=128)
    np.testing.assert_array_equal(hist.numpy(), ref_h.hist.numpy())
    # general data: counts / extremes exact, moments to f32 rounding
    rng = np.random.default_rng(0)
    values2 = rng.normal(100.0, 25.0, size=n).astype(np.float32)
    mask2 = (rng.random(n) < 0.7).astype(np.float32)
    merged2 = fold(*shard_rows(None, t(values2), t(gids), t(mask2)))
    ref2 = ops.grouped_moments(t(values2), t(gids), t(mask2), g, center)
    for name in ("count", "vmin", "vmax"):
        np.testing.assert_array_equal(getattr(merged2, name).numpy(),
                                      getattr(ref2, name).numpy(),
                                      err_msg=name)
    np.testing.assert_allclose(merged2.mean.numpy(), ref2.mean.numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(merged2.m2.numpy(), ref2.m2.numpy(),
                               rtol=1e-2)
    return {}


def op_match_reference(npz: str):
    """The reference's own sharded loop's results (saved by
    ``tests/helpers/dist_ref_sharded.py``, with the scrambles they ran
    on and the configuration over ``CFG``, the collective cadence
    included) against the port's divided scan on this world, under the
    reference's contract. Returns each run's rounds, a list a run."""
    from repro_torch.aqp import scramble_from_arrays
    from repro_torch.serve import FrameServer
    data = np.load(npz, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    out = {}
    for name, spec in meta.items():
        cols = {c: data[f"{name}/col/{c}"] for c in spec["columns"]}
        sc = scramble_from_arrays(
            cols, data[f"{name}/valid"], spec["n_rows"], spec["block_rows"],
            {k: tuple(v) for k, v in spec["catalog"].items()},
            spec["categorical"], spec["seed"])
        qs = [getattr(scen, q)(**args) for q, args in spec["queries"]]
        frame = scen.frame(sc, shard_rows=True,
                           **dict(scen.CFG, **spec["config"]))
        results = (FrameServer(frame).run_batch(
            qs, sampling=spec["sampling"], seed=1, start_block=0)
            if spec["batch"] else [frame.run(
                qs[0], sampling=spec["sampling"], seed=1, start_block=0)])
        for i, res in enumerate(results):
            ref = type("Ref", (), {
                f: data[f"{name}/res/{i}/{f}"][()]
                for f in scen.EXACT_FIELDS + scen.CI_FIELDS})
            scen.assert_sharded_matches_oracle(res, ref,
                                               bitwise_ci=spec["bitwise"])
        out[name] = [int(r.rounds) for r in results]
    return out


def op_fault_agreement(faults, kinds):
    """A ``QueryScheduler`` burst on a divided frame where only the ranks
    in ``faults`` see injected faults (``kinds``, at step attempts 1, 2,
    3): the ranks agree on each fault, so every rank walks the same
    rungs. Returns this rank's event log and results for the caller to
    compare across ranks."""
    from repro_torch.aqp import AggQuery
    from repro_torch.core.optstop import AbsoluteWidth
    from repro_torch.serve import FrameServer, QueryScheduler, SimClock
    from repro_torch.testing import FaultEvent, FaultInjector
    sc = scen.flights_scramble()
    frame = scen.frame(sc, shard_rows=True, **scen.CFG)
    rank = dist.get_rank()
    hook = (FaultInjector([FaultEvent(i + 1, k, 0.0)
                           for i, k in enumerate(kinds)])
            if rank in faults else None)
    sched = QueryScheduler(FrameServer(frame), SimClock(), chunk_rounds=2,
                           checkpoint_every=1, fault_hook=hook)
    for i, col in enumerate(("dep_delay", "dep_delay", "dep_time")):
        q = AggQuery(agg="avg", column=col, stop=AbsoluteWidth(eps=2.0 + i),
                     delta=1e-6)
        sched.submit(q, at=0.001 * i)
    sched.run_until_idle()
    return {"log": [repr(ev) for ev in sched.log],
            "results": [[float(x) for x in tk.result.estimate]
                        + [float(x) for x in tk.result.lo]
                        + [int(tk.result.rounds)]
                        for tk in sched.tickets],
            "statuses": [tk.status for tk in sched.tickets]}


def op_collective_counts():
    """All-reduces of one exhaustion run (13 rounds in one chunk of 16)
    at merge_every 1 and 4, counted by ``fused_scan.COLLECTIVES``."""
    from repro_torch.kernels import fused_scan
    out = {}
    for k in (1, 4):
        sc = scen.integer_scramble()
        fr = scen.frame(sc, shard_rows=True, merge_every=k, **scen.CFG)
        before = fused_scan.COLLECTIVES["calls"]
        res = fr.run(scen.exhaustion_query(), seed=1, start_block=0)
        out[k] = dict(calls=fused_scan.COLLECTIVES["calls"] - before,
                      rounds=int(res.rounds))
    return out


def op_compressed_psum(shape, seed: int):
    """``grad_compression.compressed_psum`` of this rank's gradient, a
    float32 normal draw of scale ``10 ** rank`` from ``(seed, rank)``:
    the sum as a list, for the test to hold against the numpy formula."""
    from repro_torch.distributed.grad_compression import compressed_psum
    rank = dist.get_rank()
    g = np.random.default_rng([seed, rank]).normal(
        0.0, 10.0 ** rank, shape).astype(np.float32)
    return compressed_psum(torch.from_numpy(g)).numpy().tolist()


OPS = {"scenario": op_scenario, "compressed_psum": op_compressed_psum, "fold_bitwise": op_fold_bitwise,
       "collective_counts": op_collective_counts,
       "match_reference": op_match_reference,
       "fault_agreement": op_fault_agreement}
# the multi-card layout's commands (tests/test_torch_sharded_train.py)
OPS.update(torch_sharded_train_ops.OPS)
# the sharded serving steps' commands (tests/test_torch_sharded_serve.py)
OPS.update(torch_sharded_serve_ops.OPS)


def main(argv):
    rank, world, store_path, timeout_s = (int(argv[1]), int(argv[2]),
                                          argv[3], float(argv[4]))
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["op"] == "exit":
            break
        try:
            ans = {"ok": True, "out": OPS[cmd["op"]](**cmd.get("args", {}))}
        except Exception:  # reported to the driving test, which fails
            ans = {"ok": False, "error": traceback.format_exc()}
        sys.stdout.write(MARK + json.dumps(ans) + "\n")
        sys.stdout.flush()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
