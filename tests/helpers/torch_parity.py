"""Parity helpers for the PyTorch port: one scramble through both
packages, and the comparison of a port result with a reference result.

Equivalence discipline (the reference's own contracts, ROADMAP north
star):

  * scan decisions, cursor, coverage, taint, ``exact`` and every scan
    metric match EXACTLY;
  * on exactly-representable data (integer values, every partial sum
    below 2**24) the f32 folds are bitwise equal, so CI endpoints and
    estimates agree to <= 1e-9;
  * on general f32 data CI endpoints agree to <= 1e-6 relative: both
    packages fold rows in row order on the CPU, so this is slack for f32
    reordering, which any other fold order would bring.
"""

import numpy as np
import pytest
import torch

import repro.aqp as R
import repro_torch.aqp as T


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Import into a test module to run it on one torch thread, the
    previous count restored after it. The plain scans are thousands of
    small ops; on a host whose cores other test processes share, torch's
    intra-op threads cost ~1000x (13 ms for one 8,192-element exp under
    load, 0.01 ms on one thread)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

EXACT_FIELDS = [
    "group_codes", "count_seen", "nonempty", "exact", "tainted",
    "rows_covered", "blocks_fetched", "blocks_skipped_active",
    "blocks_skipped_static", "bitmap_probes", "rounds", "stopped_early",
]
CI_FIELDS = ["estimate", "lo", "hi"]


def port_scramble(sc: R.Scramble) -> T.Scramble:
    """The port's Scramble holding copies of a reference scramble's
    arrays (the state carried across: data, where a model has weights)."""
    return T.scramble_from_arrays(sc.columns, sc.valid, sc.n_rows,
                                  sc.block_rows, sc.catalog, sc.categorical,
                                  sc.seed)


def exact_flights_columns(columns):
    """FLIGHTS columns with ``dep_delay`` quantized to the integers
    0..16 (catalog ``(0, 16)``, centre 8), so every fold term
    ``(v - 8)^k m`` is a small integer and f32 sums are exact."""
    cols = dict(columns)
    q = np.clip(np.round(columns["dep_delay"] / 4.0) + 4.0, 0.0, 16.0)
    cols["dep_delay"] = q.astype(np.float32)
    return cols


def assert_port_matches_ref(r_port, r_ref, exact_data: bool):
    for f in EXACT_FIELDS:
        a, b = getattr(r_port, f), getattr(r_ref, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, (f, a, b)
    for f in CI_FIELDS:
        a, b = getattr(r_port, f), getattr(r_ref, f)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=f)
        fin = np.isfinite(a)
        if exact_data:
            # atol for data-scale endpoints, the tiny rtol for SUM/COUNT
            # endpoints of row-count scale
            np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12,
                                       atol=1e-9, err_msg=f)
        else:
            np.testing.assert_allclose(a[fin], b[fin], rtol=1e-6, atol=0,
                                       err_msg=f)
