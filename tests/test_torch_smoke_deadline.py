"""``chip_smoke.py``'s run-wide deadline on the CPU: a spawned rank that
stalls is stopped when the deadline passes, whatever its own join limit,
and the phase records why.

The smoke's other phases need the card; this part is plain
multiprocessing, so it runs here: a deadline 5 s away over
``_spawn_ranks`` with a target that sleeps 60 s and a join limit of
600 s.
"""

import multiprocessing
import time

import pytest

import chip_smoke


@pytest.fixture
def deadline_in_5s():
    start = time.perf_counter()
    chip_smoke.set_deadline(start + 5.0, start)
    yield
    chip_smoke.set_deadline(float("inf"))


def test_a_stalled_rank_is_stopped_at_the_deadline(deadline_in_5s):
    ctx = multiprocessing.get_context("spawn")
    fails = []
    t0 = time.perf_counter()
    codes = chip_smoke._spawn_ranks(ctx, time.sleep, [60], 600,
                                    "stalled", fails)
    took = time.perf_counter() - t0
    assert took < 10.0, took
    assert len(codes) == 1 and codes[0] is not None and codes[0] != 0
    assert [f["check"] for f in fails] == ["smoke deadline"]
    assert fails[0]["phase"] == "stalled"
    assert 4.0 <= fails[0]["elapsed_s"] < 10.0


def test_limits_are_cut_to_the_time_left(deadline_in_5s):
    assert chip_smoke.capped(600) <= 5.0
    assert chip_smoke.capped(2) == pytest.approx(2.0)
    chip_smoke.set_deadline(time.perf_counter() - 1.0)
    assert chip_smoke.capped(600) == 1.0     # never a zero wait
