"""The fused round's head, ``ops.round_select``, on the CPU against the
reference's ``fused_round`` head (``src/repro/kernels/fused_scan.py``:
the cursor window, the static prefilter, the probe through
``repro.kernels.ops.active_blocks(impl="ref")``, ``_budget_select`` and
``_gather_blocks``), from the same cursor over the same scramble order.
Every output is an integer or a bool, so each must be equal: ``ok``,
``flags``, ``new_pos``, the lanes' ``blk`` and ``tvalid``. The cases cut
the window at the end of the scan, leave fewer flags than the budget,
put exactly ``budget`` flags with the last at the window's last
position, take a budget of one, run without the probe, and probe with
all-ones and all-zeros masks, at every word count the kernel's two probe
modes see. The cursor and the ``go`` flag are device scalars: a round with
``go`` false or a cursor outside ``[0, nb]`` selects nothing and leaves
the cursor where it was, and rounds chained through ``new_pos`` walk the
scan as the reference's cursor does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import fused_scan as Rfs
from repro.kernels import ops as Rops

from repro_torch.kernels import bitmap_active, ops

NB, WINDOW = 700, 96
SCENARIOS = ["random", "near_end", "few_flags", "exact_budget_last",
             "budget_1", "no_probe", "active_ones", "active_zeros"]


def _inputs(W: int, scenario: str):
    """``(order_pad, static_ok, words, active, pos, budget, probe)`` as
    numpy arrays (words and active as uint32) and host ints."""
    rng = np.random.default_rng(W * 31 + SCENARIOS.index(scenario))
    order = rng.permutation(NB).astype(np.int32)
    opad = np.zeros(NB + WINDOW, np.int32)
    opad[:NB] = order
    bits = rng.integers(0, 32, (NB, W)).astype(np.uint64)
    words = np.where(rng.random((NB, W)) < 0.05,
                     (np.uint64(1) << bits).astype(np.uint32), np.uint32(0))
    static_ok = rng.random(NB) < 0.8
    active = (rng.random((W, 32)) < 0.3)
    active = (active.astype(np.uint64) << np.arange(32, dtype=np.uint64)
              ).sum(axis=1).astype(np.uint32)
    pos, budget, probe = int(rng.integers(0, NB - WINDOW)), 20, True
    if scenario == "near_end":
        pos = NB - 30                       # in_range cuts the window
    elif scenario == "few_flags":
        budget = WINDOW                     # more than the window can flag
    elif scenario == "exact_budget_last":
        # exactly `budget` flagged positions, the last one at the window's
        # last position: only they pass the prefilter, and every row hits
        win = order[pos:pos + WINDOW]
        chosen = rng.choice(WINDOW - 1, budget - 1, replace=False)
        static_ok[win] = False
        static_ok[win[chosen]] = True
        static_ok[win[-1]] = True
        words[:, 0] |= np.uint32(1)
        active[:] = np.uint32(0xFFFFFFFF)
    elif scenario == "budget_1":
        budget = 1
    elif scenario == "no_probe":
        probe = False
    elif scenario == "active_ones":
        active[:] = np.uint32(0xFFFFFFFF)
    elif scenario == "active_zeros":
        active[:] = np.uint32(0)
    return opad, static_ok, words, active, pos, budget, probe


def _dev_pos(pos: int) -> torch.Tensor:
    return torch.tensor(pos, dtype=torch.int64)


GO = torch.tensor(True)


def _reference_head(opad, static_ok, words, active, pos, budget, probe):
    """The reference ``fused_round`` up to its fold, eagerly: ``(ok,
    flags, new_pos, blk, tvalid)``."""
    offs = jnp.arange(WINDOW, dtype=jnp.int32)
    in_range = (pos + offs) < NB
    win = jnp.asarray(opad)[pos:pos + WINDOW]
    ok = jnp.asarray(static_ok)[win] & in_range
    flags = ok
    if probe:
        act = Rops.active_blocks(jnp.asarray(words)[win], jnp.asarray(active),
                                 impl="ref") > 0
        flags = ok & act
    take, new_pos = Rfs._budget_select(flags, jnp.asarray(pos, jnp.int32),
                                       NB, WINDOW, budget)
    blk, tvalid, _ = Rfs._gather_blocks(take, win, WINDOW, budget)
    return ok, flags, new_pos, blk, tvalid


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("W", [1, 7, 31, 32, 50, 88, 320])
def test_round_select_matches_reference_head(W, scenario):
    opad, static_ok, words, active, pos, budget, probe = _inputs(W, scenario)
    want = _reference_head(opad, static_ok, words, active, pos, budget,
                           probe)
    got = ops.round_select(
        torch.from_numpy(opad), torch.from_numpy(static_ok),
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(active.view(np.int32)), _dev_pos(pos), GO, nb=NB,
        window=WINDOW, budget=budget, probe=probe)
    ok, flags, new_pos, blk, tvalid = got
    assert [t.dtype for t in got] == [torch.bool, torch.bool, torch.int64,
                                      torch.int32, torch.bool]
    assert ok.shape == flags.shape == (WINDOW,)
    assert blk.shape == tvalid.shape == (budget,)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    n_flags = int(flags.sum())
    if scenario == "exact_budget_last":
        assert n_flags == budget and int(new_pos) == pos + WINDOW
        assert bool(tvalid.all())
    if scenario == "few_flags":
        assert n_flags < budget and int(tvalid.sum()) == n_flags
        assert int(new_pos) == pos + WINDOW
    if scenario == "near_end":
        assert not bool(ok[NB - pos:].any()) and int(new_pos) <= NB
    if scenario == "active_zeros":
        assert n_flags == 0 and not bool(tvalid.any())
        assert not bool(blk.any())


def test_round_select_kernel_rejects_cpu_tensors():
    """The CUDA wrapper launches or raises: CPU tensors are refused, not
    handed to the plain version."""
    opad, static_ok, words, active, pos, budget, probe = _inputs(7, "random")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bitmap_active.round_select(
            torch.from_numpy(opad), torch.from_numpy(static_ok),
            torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(active.view(np.int32)), _dev_pos(pos), GO,
            nb=NB, window=WINDOW, budget=budget, probe=probe)


def _torch_inputs(W: int, scenario: str):
    opad, static_ok, words, active, pos, budget, probe = _inputs(W, scenario)
    t = [torch.from_numpy(x) for x in (opad, static_ok, words.view(np.int32),
                                      active.view(np.int32))]
    return t, pos, budget, probe


@pytest.mark.parametrize("why", ["go_false", "pos_past_nb", "pos_negative"])
@pytest.mark.parametrize("W", [7, 88])
def test_round_select_that_does_not_run_selects_nothing(W, why):
    """``go`` false, or a cursor outside ``[0, nb]`` (checked on the
    device, not the host): no position in range, no lane, the cursor
    returned as it came."""
    t, pos, budget, probe = _torch_inputs(W, "active_ones")
    go = torch.tensor(why != "go_false")
    pos = {"go_false": pos, "pos_past_nb": NB + 3, "pos_negative": -5}[why]
    ok, flags, new_pos, blk, tvalid = ops.round_select(
        *t, _dev_pos(pos), go, nb=NB, window=WINDOW, budget=budget,
        probe=probe)
    assert int(new_pos) == pos and new_pos.dtype == torch.int64
    assert not bool(ok.any()) and not bool(flags.any())
    assert not bool(tvalid.any()) and not bool(blk.any())


@pytest.mark.parametrize("W", [1, 50])
def test_round_select_chained_device_cursor_walks_like_reference(W):
    """Rounds chained through the device cursor (each round's ``new_pos``
    is the next round's ``pos``, never read on the host) give, round by
    round, the reference head's outputs from the reference's cursor; a
    round at ``pos == nb`` selects nothing."""
    t, _, budget, probe = _torch_inputs(W, "random")
    opad, static_ok, words, active, _, _, _ = _inputs(W, "random")
    pos_t, ref_pos = _dev_pos(0), 0
    for _ in range(40):
        got = ops.round_select(*t, pos_t, GO, nb=NB, window=WINDOW,
                               budget=budget, probe=probe)
        if ref_pos < NB:
            want = _reference_head(opad, static_ok, words, active, ref_pos,
                                   budget, probe)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            ref_pos = int(want[2])
        else:  # the scan is over: the head selects nothing
            assert int(got[2]) == NB and not bool(got[4].any())
        pos_t = got[2]
    assert ref_pos == NB
