"""The selective-scan forward kernel's launch plan, on the CPU.

``selective_scan.plan`` mirrors the launch constants of
``csrc/selective_scan.cu`` (states a lane, threads and CTAs an SM,
staged steps) and the shared memory its layout takes. No card is
needed: the source's constants are read from the file, and the plan is
checked at every shape that ``chip_smoke.py``'s phase 2 and the card
tests give the kernel."""

import re
from pathlib import Path

import pytest

import chip_smoke
from repro_torch.kernels import selective_scan as kscan
from tests.test_torch_cuda import SCAN_SHAPES as CARD_SHAPES

SOURCE = (Path(kscan.__file__).resolve().parent / "csrc"
          / "selective_scan.cu")
SHAPES = sorted(set(map(tuple, chip_smoke.SCAN_SHAPES + CARD_SHAPES)))
TRAIN_SHAPE = chip_smoke.TRAIN_SCAN_SHAPE
SERVE_SHAPE = (chip_smoke.SERVE_BATCH, chip_smoke.PROMPT_LEN, 8192, 16, 512)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"{name} not found in {SOURCE.name}"
    return int(m.group(1))


@pytest.mark.parametrize("name,value", [
    ("kStates", kscan.SCAN_STATES_PER_LANE),
    ("kThreads", kscan.SCAN_THREADS),
    ("kMinCtas", kscan.SCAN_CTAS_PER_SM),
    ("kSeg", kscan.SCAN_STAGE_STEPS)])
def test_plan_constants_mirror_the_source(name, value):
    assert _constant(name) == value


@pytest.mark.parametrize("B,L,din,n,tc", SHAPES)
def test_plan_shared_memory_fits(B, L, din, n, tc):
    """Every shape the kernel is run at: the CTA's shared memory under
    the 227 KB a CTA may take, two CTAs resident an SM, a channel's
    states split over n / 4 lanes, and the grid covering every channel
    of every batch row."""
    p = kscan.plan(B, L, din, n, tc)
    assert p.smem_bytes <= kscan.SMEM_PER_CTA
    assert p.ctas_per_sm == kscan.SCAN_CTAS_PER_SM
    assert p.lanes_per_channel * kscan.SCAN_STATES_PER_LANE == n
    assert p.lanes_per_channel * p.channels_per_cta == p.threads
    assert (p.ctas // B - 1) * p.channels_per_cta < din
    assert p.ctas // B * p.channels_per_cta >= din
    tcl = min(tc, L)
    assert p.segments == L // tcl * -(-tcl // kscan.SCAN_STAGE_STEPS)


@pytest.mark.parametrize("shape", [TRAIN_SHAPE, SERVE_SHAPE],
                         ids=["train", "serve"])
def test_plan_main_path_fills_whole_waves(shape):
    """The training (2, 4096) and serving (8, 2048) calls at d_inner
    8192, n 16: every SM has a CTA, at least one whole wave of resident
    CTAs, and the last wave at least 95 % full."""
    p = kscan.plan(*shape)
    assert p.ctas >= kscan.H100_SMS
    assert p.waves >= 1
    assert p.ctas > (p.waves - 1) * kscan.H100_SMS * p.ctas_per_sm
    assert p.fill >= 0.95


def test_plan_train_and_serve_numbers():
    """The numbers the source's header states: 64 channels a CTA at n 16,
    72 KB of shared memory, 256 CTAs in one wave for training and 1,024
    in four for serving."""
    t, s = kscan.plan(*TRAIN_SHAPE), kscan.plan(*SERVE_SHAPE)
    assert (t.channels_per_cta, t.smem_bytes) == (64, 73_728)
    assert (t.ctas, t.waves, s.ctas, s.waves) == (256, 1, 1024, 4)
