"""The port's float64 tensor twins of the bound math (bounders, RangeTrim,
COUNT/SUM CIs, the OptStop schedule and stopping conditions, the state
helpers) on the CPU, against the reference's ``*_device`` twins under
64-bit JAX and against the reference's host numpy path, on the same
inputs made from a numpy seed: CI endpoints to <= 1e-9 (the reference's
contract), with the count-0/1 downdate edge lanes; masks and schedules
exactly. The twins refuse a float32 state (in torch a float32 tensor times
a float64 scalar tensor stays float32: a silent demotion that would make
the intervals invalid guarantees)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_sum as Rcs
from repro.core import get_bounder as r_get_bounder
from repro.core import optstop as Ropt
from repro.core import state as Rs
from repro.core.bounders import BernsteinSerflingBounder as RBSB

from repro_torch.core import count_sum as Tcs
from repro_torch.core import get_bounder as t_get_bounder
from repro_torch.core import optstop as Topt
from repro_torch.core import state as Ts
from repro_torch.core.bounders import BernsteinSerflingBounder as TBSB

ATOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _x64(x64_module):
    yield


def make_batch(G=32, hist_bins=None, a=0.0, b=100.0, seed=0):
    """G groups of random samples, incl. empty / singleton edge lanes:
    the reference's host ``StatsBatch`` (its test's generator)."""
    rng = np.random.default_rng(seed)
    counts, means, m2s, vmins, vmaxs, hists = [], [], [], [], [], []
    for g in range(G):
        n = [0, 1, 2][g] if g < 3 else int(rng.integers(3, 5000))
        v = np.clip(rng.normal(50.0, 20.0, n), a, b)
        if n == 0:
            counts.append(0.0)
            means.append(0.0)
            m2s.append(0.0)
            vmins.append(np.inf)
            vmaxs.append(-np.inf)
        else:
            counts.append(float(n))
            means.append(v.mean())
            m2s.append(((v - v.mean()) ** 2).sum())
            vmins.append(v.min())
            vmaxs.append(v.max())
        if hist_bins:
            idx = np.clip(((v - a) * hist_bins / (b - a)).astype(int),
                          0, hist_bins - 1)
            hists.append(np.bincount(idx, minlength=hist_bins)
                         .astype(np.float64))
    return Rs.StatsBatch(
        count=np.asarray(counts), mean=np.asarray(means),
        m2=np.asarray(m2s), vmin=np.asarray(vmins),
        vmax=np.asarray(vmaxs),
        hist=np.stack(hists) if hist_bins else None)


def to_ref(sb):
    return Rs.DevStatsBatch(
        count=jnp.asarray(sb.count), mean=jnp.asarray(sb.mean),
        m2=jnp.asarray(sb.m2), vmin=jnp.asarray(sb.vmin),
        vmax=jnp.asarray(sb.vmax),
        hist=None if sb.hist is None else jnp.asarray(sb.hist))


def to_port(sb, dtype=torch.float64):
    t = lambda x: torch.from_numpy(np.asarray(x)).to(dtype)
    return Ts.DevStatsBatch(
        count=t(sb.count), mean=t(sb.mean), m2=t(sb.m2), vmin=t(sb.vmin),
        vmax=t(sb.vmax), hist=None if sb.hist is None else t(sb.hist))


def _close(got, *wants, atol=ATOL):
    for want in wants:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=atol)


BOUNDER_CASES = [
    ("hoeffding", False, None),
    ("hoeffding", True, None),
    ("hoeffding_serfling", False, None),
    ("hoeffding_serfling", True, None),
    ("bernstein", False, None),
    ("bernstein", True, None),
    ("anderson_dkw", False, 256),
]


# (bounder, N): per-group N for every bounder but Anderson/DKW, whose
# device path takes a scalar N, as the engine passes it
INTERVAL_CASES = [(c, N) for c in BOUNDER_CASES
                  for N in (5000.0, "per-group")
                  if not (c[0] == "anderson_dkw" and N == "per-group")]


@pytest.mark.parametrize("case,N", INTERVAL_CASES,
                         ids=[f"{c[0]}{'+rt' if c[1] else ''}-{N}"
                              for c, N in INTERVAL_CASES])
def test_device_interval_matches_reference(case, N):
    name, rt, hist_bins = case
    a, b = 0.0, 100.0
    sb = make_batch(hist_bins=hist_bins, a=a, b=b)
    if N == "per-group":
        N = np.maximum(sb.count * 2.0 + 10.0, 100.0)
    ref = r_get_bounder(name, rangetrim=rt)
    lo_h, hi_h = ref.interval_batch(sb, a, b, N, 1e-6)
    lo_r, hi_r = jax.jit(lambda s, d: ref.interval_batch_device(
        s, a, b, N, d))(to_ref(sb), jnp.asarray(1e-6, jnp.float64))
    N_t = torch.from_numpy(N) if isinstance(N, np.ndarray) else N
    lo_t, hi_t = t_get_bounder(name, rangetrim=rt).interval_batch_device(
        to_port(sb), a, b, N_t, torch.tensor(1e-6, dtype=torch.float64))
    assert lo_t.dtype == hi_t.dtype == torch.float64
    _close(lo_t, lo_h, lo_r)
    _close(hi_t, hi_h, hi_r)


def test_device_bernstein_serfling_known_sigma():
    sb = make_batch()
    lo_h, hi_h = RBSB(sigma=12.5).interval_batch(sb, 0.0, 100.0, 6000.0,
                                                 1e-4)
    lo_r, hi_r = RBSB(sigma=12.5).interval_batch_device(
        to_ref(sb), 0.0, 100.0, 6000.0, 1e-4)
    lo_t, hi_t = TBSB(sigma=12.5).interval_batch_device(
        to_port(sb), 0.0, 100.0, 6000.0, 1e-4)
    _close(lo_t, lo_h, lo_r)
    _close(hi_t, hi_h, hi_r)


@pytest.mark.parametrize("which", ["max", "min"])
def test_device_downdate_matches_reference(which):
    sb = make_batch(hist_bins=64)
    want = Rs.downdate_extreme_batch(sb, which)
    ref = Rs.downdate_extreme_batch_device(to_ref(sb), which)
    got = Ts.downdate_extreme_batch_device(to_port(sb), which)
    for f in ("count", "mean", "m2", "vmin", "vmax"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                   rtol=0, atol=1e-12, err_msg=f)
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    np.testing.assert_array_equal(got.hist.numpy(), want.hist)
    np.testing.assert_array_equal(got.hist.numpy(), np.asarray(ref.hist))


def test_device_count_sum_twins_match_reference():
    rng = np.random.default_rng(1)
    m_v = rng.integers(0, 900, 64).astype(np.float64)
    r, R, delta = 1000.0, 50_000.0, 1e-7
    m_t = torch.from_numpy(m_v)
    for name in ("selectivity_ci", "count_ci"):
        lo_h, hi_h = getattr(Rcs, name)(m_v, r, R, delta)
        lo_r, hi_r = getattr(Rcs, name + "_device")(jnp.asarray(m_v), r, R,
                                                    delta)
        lo_t, hi_t = getattr(Tcs, name + "_device")(m_t, r, R, delta)
        _close(lo_t, lo_h, lo_r)
        _close(hi_t, hi_h, hi_r)
    got = Tcs.n_plus_device(m_t, r, R, delta)
    _close(got, Rcs.n_plus(m_v, r, R, delta), atol=1e-6)
    _close(got, Rcs.n_plus_device(jnp.asarray(m_v), r, R, delta), atol=1e-6)
    # r as a device scalar, as the loop passes it, and an empty prefix
    for rr in (torch.tensor(1000.0, dtype=torch.float64),
               torch.tensor(0.0, dtype=torch.float64)):
        _close(Tcs.n_plus_device(m_t, rr, R, delta),
               Rcs.n_plus(m_v, float(rr), R, delta), atol=1e-6)
    cci = (m_v * 0.9, m_v * 1.1 + 1.0)
    aci = (m_v - 500.0, m_v + 500.0)
    lo_h, hi_h = Rcs.sum_ci(cci, aci)
    lo_t, hi_t = Tcs.sum_ci_device(tuple(map(torch.from_numpy, cci)),
                                   tuple(map(torch.from_numpy, aci)))
    np.testing.assert_allclose(lo_t.numpy(), lo_h)
    np.testing.assert_allclose(hi_t.numpy(), hi_h)


def test_device_delta_schedule_bitwise():
    for k in (1, 2, 17, 4096):
        want = Ropt.delta_schedule(1e-5, k)
        assert float(Topt.delta_schedule_device(1e-5, k)) == want
        assert float(Topt.delta_schedule_device(
            1e-5, torch.tensor(k, dtype=torch.int64))) == want
        assert want == float(Ropt.delta_schedule_device(1e-5, k))


def test_device_delta_schedule_composes_with_bounder():
    """The schedule's device delta at a device round index flows through
    a bounder twin, as in the loop's round body."""
    sb = make_batch()
    ref = r_get_bounder("bernstein", rangetrim=True)
    port = t_get_bounder("bernstein", rangetrim=True)
    for k in (1, 5):
        dk = Topt.delta_schedule_device(1e-6, torch.tensor(k))
        lo_t, hi_t = port.interval_batch_device(to_port(sb), 0.0, 100.0,
                                                6000.0, dk)
        lo_h, hi_h = ref.interval_batch(sb, 0.0, 100.0, 6000.0,
                                        Ropt.delta_schedule(1e-6, k))
        lo_r, hi_r = ref.interval_batch_device(
            to_ref(sb), 0.0, 100.0, 6000.0,
            Ropt.delta_schedule_device(1e-6, jnp.asarray(k, jnp.int32)))
        _close(lo_t, lo_h, lo_r)
        _close(hi_t, hi_h, hi_r)


@pytest.mark.parametrize("rt", [False, True])
def test_require_x64_refuses_float32_state(rt):
    """A float32 state is refused with a message that names float64,
    float32 and the way out; float64 passes; ``x64_enabled`` is always
    true in torch."""
    sb = make_batch()
    bounder = t_get_bounder("bernstein", rangetrim=rt)
    with pytest.raises(RuntimeError) as ei:
        bounder.interval_batch_device(to_port(sb, torch.float32), 0.0,
                                      100.0, 6000.0, 1e-6)
    msg = str(ei.value)
    assert "float64" in msg and "float32" in msg
    assert "device_loop=False" in msg
    with pytest.raises(RuntimeError, match="float64"):
        Ts.require_x64("test feature", torch.zeros(3, dtype=torch.float32))
    Ts.require_x64("test feature", torch.zeros(3, dtype=torch.float64), None)
    assert Ts.x64_enabled() is True


def _intervals(G, seed):
    """Running intervals, estimates, counts and a validity mask with
    phantom lanes, crossing-zero and point intervals."""
    rng = np.random.default_rng(seed)
    est = rng.normal(10.0, 20.0, G)
    w = rng.exponential(5.0, G)
    lo, hi = est - w * rng.random(G), est + w * rng.random(G)
    lo[:3], hi[:3], est[:3] = 0.0, 0.0, 0.0        # point at zero
    lo[3], hi[3], est[3] = -1.0, 2.0, 0.5           # crosses zero
    counts = rng.integers(0, 6000, G).astype(np.float64)
    valid = rng.random(G) < 0.8
    return lo, hi, est, counts, valid


STOPS = [("fixed", lambda m: m.FixedSamples(m=3000)),
         ("abswidth", lambda m: m.AbsoluteWidth(eps=4.0)),
         ("relwidth", lambda m: m.RelativeWidth(eps=0.3)),
         ("threshold", lambda m: m.ThresholdSide(threshold=10.0)),
         ("topk", lambda m: m.TopKSeparated(k=3, largest=True)),
         ("bottomk", lambda m: m.TopKSeparated(k=2, largest=False)),
         ("topk_all", lambda m: m.TopKSeparated(k=40, largest=True)),
         ("ordered", lambda m: m.GroupsOrdered())]


@pytest.mark.parametrize("name,make", STOPS, ids=[s[0] for s in STOPS])
@pytest.mark.parametrize("seed", [0, 1])
def test_active_device_matches_reference(name, make, seed):
    """Each stopping condition's active mask on the device equals the
    reference's device twin and the host's subset semantics (the mask
    over valid lanes, phantom lanes never active)."""
    lo, hi, est, counts, valid = _intervals(40, seed)
    got = make(Topt).active_device(*map(torch.from_numpy,
                                        (lo, hi, est, counts, valid)))
    ref = make(Ropt).active_device(*map(jnp.asarray,
                                        (lo, hi, est, counts, valid)))
    host = np.zeros(40, bool)
    host[valid] = make(Ropt).active(lo[valid], hi[valid], est[valid],
                                    counts[valid])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), host)


def test_state_helpers_match_reference():
    """init_moments / init_hist / merge_hist / hist_of_batch /
    tree_merge_moments and the scalar downdate against the reference."""
    rng = np.random.default_rng(3)
    v = rng.normal(5.0, 4.0, (7, 33)).astype(np.float32)
    v[0, 0], v[1, 1], v[2, 2] = np.nan, -1e30, 1e30
    m = rng.random((7, 33)) < 0.7
    for got, want in zip(Ts.init_moments((4,)), Rs.init_moments((4,))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert Ts.init_hist((2,), nbins=8).hist.shape == (2, 8)
    h_t = Ts.hist_of_batch(torch.from_numpy(v), torch.from_numpy(m), -3.0,
                           12.0, 17)
    h_r = Rs.hist_of_batch(jnp.asarray(v), jnp.asarray(m), -3.0, 12.0, 17)
    np.testing.assert_array_equal(h_t.hist.numpy(), np.asarray(h_r.hist))
    merged = Ts.merge_hist(h_t, h_t)
    np.testing.assert_array_equal(merged.hist.numpy(),
                                  2 * np.asarray(h_r.hist))
    # a stack of 7 per-device states, merged pairwise
    w = np.where(np.isfinite(v) & (np.abs(v) < 1e3), v, 1.0)
    st_t = Ts.moments_of_batch(torch.from_numpy(w), torch.from_numpy(m),
                               axis=1, dtype=torch.float64)
    st_r = Rs.moments_of_batch(jnp.asarray(w), jnp.asarray(m), axis=1,
                               dtype=jnp.float64)
    got = Ts.tree_merge_moments(st_t)
    want = Rs.tree_merge_moments(st_r)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-12,
                                   atol=1e-12)
    s = Rs.Stats.of_sample(w[0][m[0]], hist_bins=16, hist_range=(-3, 12))
    ts = Ts.Stats.of_sample(w[0][m[0]], hist_bins=16, hist_range=(-3, 12))
    for which in ("max", "min"):
        a, b = Ts.downdate_extreme(ts, which), Rs.downdate_extreme(s, which)
        for f in ("count", "mean", "m2", "vmin", "vmax"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_array_equal(a.hist, b.hist)
    one = Ts.Stats(1.0, 3.0, 0.0, 3.0, 3.0)
    assert Ts.downdate_extreme(one, "max").count == 0.0
