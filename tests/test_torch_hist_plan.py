"""The grouped-histogram kernel's launch plan, on the CPU.

``grouped_hist.plan`` mirrors ``grouped_hist_plan`` in
``csrc/grouped_hist.cu``: the regime that the cell space ``C = G *
nbins`` picks (private copies up to 57,344 cells, buckets above), the
launches, their CTAs and shared memory, and the scratch a call needs.
No card is needed: the source's constants are read from the file, and
the plan is checked on each side of every threshold and at every shape
that ``chip_smoke.py``'s phase 2 gives the kernel. (The card tests hold
the compiled plan to this mirror.)"""

import re
from pathlib import Path

import pytest

import chip_smoke
from repro_torch.kernels import grouped_hist as khist

SOURCE = (Path(khist.__file__).resolve().parent / "csrc"
          / "grouped_hist.cu")
MiB = 1 << 20
ROWS = chip_smoke.HIST_ROWS  # one exact-sweep fold: 1,048,576 rows


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE.read_text())
    assert m, f"{name} not found in {SOURCE.name}"
    return int(eval(m.group(1), {"kThreads": khist.THREADS, "kQuad": 4}))


@pytest.mark.parametrize("name,value", [
    ("kThreads", khist.THREADS),
    ("kBucketThreads", khist.BUCKET_THREADS),
    ("kStageRows", khist.STAGE_ROWS),
    ("kMaxCells", khist.MAX_CELLS),
    ("kTargetBuckets", khist.TARGET_BUCKETS),
    ("kChunkTiles", khist.CHUNK_TILES),
    ("kCluster", khist.CLUSTER)])
def test_plan_constants_mirror_the_source(name, value):
    assert _constant(name) == value


def test_max_cells_is_the_shared_memory_of_56_groups():
    """224 KB of counters: G 56 at the engine's 1,024 bins, under the 227
    KB a CTA may take with room for the kernels' static shared memory."""
    assert khist.MAX_CELLS == 56 * 1024
    assert khist.MAX_CELLS * 4 + 4 * (2 * khist.CHUNK_TILES + 32) \
        <= khist.SMEM_PER_CTA


# (G, nbins): the last private and the first bucketed cell space at each
# bin count of the card tests
_BOUNDARY = [(56, 1024, "private"), (57, 1024, "bucketed"),
             (573, 100, "private"), (574, 100, "bucketed"),
             (14, 4096, "private"), (15, 4096, "bucketed")]


@pytest.mark.parametrize("G,nbins,regime", _BOUNDARY)
def test_plan_regime_either_side_of_the_threshold(G, nbins, regime):
    p = khist.plan(ROWS, G, nbins)
    assert p.regime == regime
    assert (G * nbins <= khist.MAX_CELLS) == (regime == "private")


_SHAPES = [(n, G, nbins)
           for n in (0, 1, 4095, 4096, 4097, 200_003, ROWS, 8 * ROWS)
           for G in (1, 14, 56, 57, 200, 800, 2800, 10240)
           for nbins in (100, 1024, 4096)]


@pytest.mark.parametrize("n,G,nbins", _SHAPES)
def test_plan_fits_and_covers(n, G, nbins):
    """Every shape: each launch's shared memory under 227 KB with the
    static part beside it, the buckets cover every cell once with float4
    writes, a bucket's cells fit the sort's 16-bit entries, and the
    scratch holds 2 bytes a row and the (buckets + 1, tiles) table."""
    p = khist.plan(n, G, nbins)
    cells = G * nbins
    stages = -(-n // khist.STAGE_ROWS)
    assert p.count_smem + 4 * (2 * khist.CHUNK_TILES + 32) \
        <= khist.SMEM_PER_CTA
    # the sort's static part: its 2-byte tile and a word a warp
    assert p.sort_smem + 2 * khist.STAGE_ROWS + 4 * 32 \
        <= khist.SMEM_PER_CTA
    if p.regime == "private":
        assert (p.launches, p.sort_ctas, p.sort_smem) == (1, 0, 0)
        k = khist.CLUSTER  # whole clusters, at most one CTA an SM
        assert p.count_ctas % k == 0
        assert p.count_ctas == min(khist.H100_SMS // k * k,
                                   -(-max(1, stages) // k) * k)
        assert p.bucket_cells == cells
        assert p.count_smem == -(-cells // 4) * 16
        # the device copy of every cell, then the grid barrier's count
        assert p.scratch_bytes == (khist.MAX_CELLS + 4) * 4
    else:
        assert p.launches == (2 if n else 1)
        assert p.sort_ctas == stages
        assert p.bucket_cells % 4 == 0 and p.bucket_cells < 1 << 16
        assert p.bucket_cells <= khist.MAX_CELLS
        assert p.count_ctas * p.bucket_cells >= cells \
            > (p.count_ctas - 1) * p.bucket_cells
        assert p.sort_smem == 4 * p.count_ctas
        assert p.scratch_bytes % 16 == 0
        assert p.scratch_bytes >= 2 * stages * khist.STAGE_ROWS \
            + 2 * (p.count_ctas + 1) * stages
    assert khist.STAGE_ROWS < 1 << 16  # the start table's 16-bit offsets


def test_plan_exact_sweep_shape():
    """F-q2's exact sweep (G 14, 1,048,576 rows, 1,024 bins): one launch
    of 132 CTAs (66 clusters of two), 56 KB of counters each, two stages
    of 4,096 rows a CTA (the last CTAs one); the scratch is the 224 KB
    device copy and the barrier's 16 bytes."""
    p = khist.plan(ROWS, 14, 1024)
    assert p == khist.HistPlan("private", 1, 132, 57_344, 0, 0, 14_336,
                               229_392)
    assert -(-ROWS // (p.count_ctas * khist.STAGE_ROWS)) == 2


@pytest.mark.parametrize("n,ctas", [(0, 2), (1, 2), (4096, 2), (8193, 4),
                                    (200_003, 50), (ROWS, 132)])
def test_plan_private_grid_follows_the_rows(n, ctas):
    """A CTA a stage of 4,096 rows, in whole clusters of two, up to the
    CTAs the card holds at once: a small call keeps few private copies
    (each cluster adds its non-zero cells once)."""
    assert khist.CLUSTER == 2
    assert khist.plan(n, 14, 1024).count_ctas == ctas
    assert khist.plan(n, 14, 1024, resident=115).count_ctas == min(ctas, 114)


@pytest.mark.parametrize("G,bucket_cells,buckets,smem", [
    (57, 228, 256, 912), (200, 800, 256, 3_200),
    (2800, 11_200, 256, 44_800), (10240, 40_960, 256, 163_840)])
def test_plan_bucketed_at_1024_bins(G, bucket_cells, buckets, smem):
    """At 1,024 bins and 1M rows: 256 buckets of consecutive cells, 256
    sort tiles; G 2,800's buckets are 11,200 cells (10.9 histogram rows,
    44.8 KB), its scratch 2.2 MB against 11.5 MB of histogram."""
    p = khist.plan(ROWS, G, 1024)
    assert (p.bucket_cells, p.count_ctas, p.count_smem) == (
        bucket_cells, buckets, smem)
    assert (p.sort_ctas, p.sort_smem) == (256, 4 * buckets)
    assert p.scratch_bytes == 256 * 8192 + (buckets + 1) * 256 * 2
    assert p.scratch_bytes < 2.2 * MiB


def test_plan_bucketed_caps_a_bucket_at_max_cells():
    """G 10,240 at 4,096 bins (42M cells): buckets of 57,344 cells, 732
    of them, each at the 224 KB a CTA's counters may take."""
    p = khist.plan(ROWS, 10240, 4096)
    assert (p.bucket_cells, p.count_ctas) == (khist.MAX_CELLS, 732)
    assert p.count_smem == khist.MAX_CELLS * 4


@pytest.mark.parametrize("G", [1, 14, 56, 57, 200, 2800])
def test_plan_covers_the_smoke_shapes(G):
    """chip_smoke.py's phase-2 shapes: the regime each is there to
    exercise."""
    assert G in chip_smoke.HIST_GROUPS
    p = khist.plan(ROWS, G, chip_smoke.HIST_BINS)
    assert p.regime == ("private" if G <= 56 else "bucketed")
    assert p.launches == (1 if G <= 56 else 2)
