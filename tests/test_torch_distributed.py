"""The port's sharded scan across ranks: gloo worlds of 2 and 4 CPU
processes (``tests/helpers/torch_dist_world.py``), the mirror of
``tests/test_sharded_scan.py``'s mesh scenarios and of
``tests/test_distributed.py``'s AQP workers.

  * each of the reference's 13 scenarios (``tests/helpers/
    sharded_scenarios.py``, ported as ``torch_sharded_scenarios.py``) is
    one case at each world size, plus the 2-D ``mesh_shape`` one at 4
    ranks: every rank holds its divided scan to the single-device port
    run (exact fields equal; CIs bit for bit on the integer scenarios,
    within the reference's ``CI_RTOL`` = 1e-3 relative, ``CI_ATOL`` =
    1e-6, elsewhere; the cadence ones under its ``CADENCE_TOL`` = 1e-5);
  * the bitwise merge: ``make_sharded_fold`` equals ``ops.grouped_moments``
    bit for bit on exact data, with and without the histogram;
  * against the reference: ``scenario_exhaustion_bitwise``'s and
    ``scenario_groupby_topk``'s queries, and five collective-cadence
    runs (K 3, 4 and 5; one whose stop is decided by a merge on the
    port's chunk boundary; one served batch), through the reference's
    own sharded loops
    (``shard_map`` over 2 fake CPU devices, a subprocess) match the
    port's 2-rank run under the same contract;
  * the cadence issues its all-reduces only at its merge slots.

Each case has its own time limit; a rank that fails or hangs fails its
case and the world is restarted for the next one. The ranks run one
torch thread each, with a 60 s group timeout.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.helpers.torch_dist_world import DistWorld

SCENARIOS = [
    "scenario_groupby_topk", "scenario_filtered_sum", "scenario_taint",
    "scenario_exhaustion_bitwise", "scenario_early_stop_bitwise",
    "scenario_uneven_tail", "scenario_server_pass",
    "scenario_carousel_sharded_lap",
    "scenario_cadence_superset_sync", "scenario_cadence_merge_confirm",
    "scenario_cadence_exhaustion", "scenario_cadence_early_stop",
    "scenario_cadence_server_pass",
]
CASE_TIMEOUT_S = 120
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Gloo worlds of 2 and 4 ranks, each started on first use and kept
    for the module."""
    tmp = tmp_path_factory.mktemp("gloo")
    made = {}

    def get(n: int) -> DistWorld:
        if n not in made:
            made[n] = DistWorld(n, tmp)
        return made[n]

    yield get
    for w in made.values():
        w.close()


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_scenario(worlds, n, name):
    worlds(n).run("scenario", timeout=CASE_TIMEOUT_S, name=name)


def test_sharded_2d_mesh(worlds):
    worlds(4).run("scenario", timeout=CASE_TIMEOUT_S,
                  name="scenario_groupby_threshold_2d_mesh")


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_merge_bitwise(worlds, n):
    """The collective fold across ranks == the single-device
    ``grouped_moments`` fold, bit for bit on exact data, with and
    without the histogram (counts and extremes exact, moments within
    float32 rounding on general data)."""
    worlds(n).run("fold_bitwise", timeout=CASE_TIMEOUT_S)


@pytest.mark.parametrize("n", [2, 4])
def test_cadence_merges_only_at_merges(worlds, n):
    """One chunk of 16 rounds (the exhaustion run ends at round 13):
    the per-round merge issues two all-reduces a round, the K=4 cadence
    two a merge slot: at the starts of rounds 1 (nothing pending yet; the
    slot carries the previous chunk's last K rounds in a longer run), 5,
    9 and 13, and the exit flush; the same rounds either way."""
    outs = worlds(n).run("collective_counts", timeout=CASE_TIMEOUT_S)
    for out in outs:
        assert out == outs[0]
        assert out["1"] == dict(calls=2 * 16, rounds=13)
        assert out["4"] == dict(calls=2 * 5, rounds=13)


@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """The reference's sharded loops on 2 fake devices, in a subprocess
    (the device count is fixed before JAX starts), started when the
    module starts so that it runs beside the gloo cases."""
    tmp = tmp_path_factory.mktemp("ref")
    out = tmp / "ref_sharded.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (str(ROOT / "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    with open(tmp / "stdout", "w") as so, open(tmp / "stderr", "w") as se:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "tests/helpers/dist_ref_sharded.py"),
             str(out)], env=env, stdout=so, stderr=se)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference_npz(_reference_run):
    proc, tmp = _reference_run
    proc.wait(timeout=300)
    stdout = (tmp / "stdout").read_text()
    assert proc.returncode == 0 and "REF-SHARDED-OK" in stdout, \
        f"STDOUT:\n{stdout}\nSTDERR:\n{(tmp / 'stderr').read_text()}"
    return tmp / "ref_sharded.npz"


def test_port_matches_reference_sharded_loop(worlds, reference_npz):
    """The reference's own sharded loop against the port's 2-rank run:
    exact fields equal; CIs bit for bit on the integer scramble
    (``exhaustion_bitwise``, ``cadence_exhaustion_k5``), within
    ``CI_RTOL`` on FLIGHTS. The cadence runs go through the port's
    default chunks, which stand in for the reference's one dispatch:
    ``cadence_stop_at_chunk_end`` stops by the merge at the start of
    round 33, at the end of the port's second 16-round chunk, and still
    runs that round, as the reference does; in ``cadence_server_batch``
    (the pass loop's cadence) the round after a merge between chunks
    selects on the probe verdicts from before it, as there."""
    outs = worlds(2).run("match_reference", timeout=CASE_TIMEOUT_S,
                         npz=str(reference_npz))
    assert outs[0] == outs[1]
    assert set(outs[0]) == {
        "groupby_topk", "exhaustion_bitwise", "cadence_early_stop",
        "cadence_stop_at_chunk_end", "cadence_stop_k3",
        "cadence_exhaustion_k5", "cadence_server_batch"}
    assert outs[0]["cadence_stop_at_chunk_end"] == [2 * 16 + 1]
