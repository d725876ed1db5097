"""repro_torch.core — the paper's contribution: distribution-sensitive SSI
confidence intervals (bounders, RangeTrim, OptStop, COUNT/SUM, derived
ranges), the port of :mod:`repro.core`. Each piece of the bound math has
a float64 numpy host path, run by the per-round host loop, and a float64
tensor twin (the ``*_device`` functions and methods,
:class:`~repro_torch.core.state.DevStatsBatch`), run on the card by the
device-resident round loop."""

from repro_torch.core.bounders import (
    AndersonDKWBounder,
    Bounder,
    BernsteinSerflingBounder,
    EmpiricalBernsteinSerflingBounder,
    HoeffdingBounder,
    HoeffdingSerflingBounder,
    get_bounder,
)
from repro_torch.core.count_sum import count_ci, n_plus, selectivity_ci, sum_ci
from repro_torch.core.derived_bounds import derived_range
from repro_torch.core.lru import LRUCache
from repro_torch.core.optstop import (
    AbsoluteWidth,
    FixedSamples,
    GroupsOrdered,
    RelativeWidth,
    RunningInterval,
    StoppingCondition,
    ThresholdSide,
    TopKSeparated,
    delta_schedule,
    optstop_reference,
)
from repro_torch.core.rangetrim import RangeTrimBounder
from repro_torch.core.state import (
    HistState,
    MomentState,
    Stats,
    StatsBatch,
    downdate_extreme,
    downdate_extreme_batch,
    hist_of_batch,
    init_hist,
    init_moments,
    merge_hist,
    merge_moments,
    moments_of_batch,
    tree_merge_moments,
)

__all__ = [k for k in dir() if not k.startswith("_")]
