"""repro_torch.aqp — FastFrame: the sampling-optimized column store + OptStop
query engine (paper §4), on the card."""

from repro_torch.aqp.bitmap import BlockBitmap, build_bitmap, pack_mask
from repro_torch.aqp.engine import EngineConfig, FastFrame
from repro_torch.aqp.query import AggQuery, Expression, Filter, QueryResult
from repro_torch.aqp.scramble import (Scramble, build_scramble,
                                      scramble_from_arrays)

__all__ = [
    "AggQuery", "BlockBitmap", "EngineConfig", "Expression", "FastFrame",
    "Filter", "QueryResult", "Scramble", "build_bitmap", "build_scramble",
    "pack_mask", "scramble_from_arrays",
]
