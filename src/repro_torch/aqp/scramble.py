"""Scramble: the pre-shuffled, block-structured column store (Definition 4).

A scramble is a randomly permuted copy of a relation laid out in fixed-size
blocks.  Any prefix of a block scan — and any subset of blocks chosen
without looking at the data — is a uniform without-replacement sample
(Definition 5's aggregate views inherit this).  A numpy copy of
:mod:`repro.aqp.scramble`: the same seed gives the same arrays.

Rows are padded up to a whole number of blocks; padding rows carry
``valid = False`` and are masked out of every aggregate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

DEFAULT_BLOCK_ROWS = 1024


@dataclasses.dataclass
class Scramble:
    """Columnar blocks: each column has shape (n_blocks, block_rows)."""

    columns: Dict[str, np.ndarray]
    valid: np.ndarray                  # (n_blocks, block_rows) bool
    n_rows: int                        # real (un-padded) rows
    block_rows: int
    catalog: Dict[str, Tuple[float, float]]
    categorical: Dict[str, int]        # column -> cardinality
    seed: int

    @property
    def n_blocks(self) -> int:
        return self.valid.shape[0]

    def column_block(self, name: str, idx: np.ndarray) -> np.ndarray:
        return self.columns[name][idx]

    def device_shard(self, shard: int, n_shards: int) -> "Scramble":
        """Contiguous block range for one device (blocks are exchangeable
        post-shuffle, so contiguous sharding preserves uniformity)."""
        lo = shard * self.n_blocks // n_shards
        hi = (shard + 1) * self.n_blocks // n_shards
        cols = {k: v[lo:hi] for k, v in self.columns.items()}
        valid = self.valid[lo:hi]
        return dataclasses.replace(
            self, columns=cols, valid=valid,
            n_rows=int(valid.sum()))


def build_scramble(columns: Dict[str, np.ndarray],
                   catalog: Optional[Dict[str, Tuple[float, float]]] = None,
                   categorical: Optional[Dict[str, int]] = None,
                   block_rows: int = DEFAULT_BLOCK_ROWS,
                   seed: int = 0) -> Scramble:
    """One-time global shuffle + blocking (the paper's offline step).

    The catalog is completed with observed min/max for continuous columns
    (the paper's load-time range bounds a, b); categorical cardinalities
    are inferred where not given.
    """
    rng = np.random.default_rng(seed)
    n = next(iter(columns.values())).shape[0]
    perm = rng.permutation(n)
    n_blocks = -(-n // block_rows)
    padded = n_blocks * block_rows

    catalog = dict(catalog or {})
    categorical = dict(categorical or {})
    out_cols = {}
    for name, col in columns.items():
        assert col.shape[0] == n, name
        shuffled = col[perm]
        pad = np.zeros(padded - n, dtype=col.dtype)
        blocked = np.concatenate([shuffled, pad]).reshape(n_blocks,
                                                          block_rows)
        out_cols[name] = blocked
        if np.issubdtype(col.dtype, np.floating):
            if name not in catalog:
                catalog[name] = (float(col.min()), float(col.max()))
        elif np.issubdtype(col.dtype, np.integer):
            if name not in categorical:
                categorical[name] = int(col.max()) + 1

    valid = np.zeros(padded, dtype=bool)
    valid[:n] = True
    valid = valid.reshape(n_blocks, block_rows)
    return Scramble(columns=out_cols, valid=valid, n_rows=n,
                    block_rows=block_rows, catalog=catalog,
                    categorical=categorical, seed=seed)


def scramble_from_arrays(columns: Dict[str, np.ndarray], valid: np.ndarray,
                         n_rows: int, block_rows: int,
                         catalog: Dict[str, Tuple[float, float]],
                         categorical: Dict[str, int],
                         seed: int) -> Scramble:
    """Build a :class:`Scramble` from an already shuffled and blocked
    layout: the numpy fields of another scramble (for instance one built
    by the JAX package), copied so that the two never share a buffer.
    Lets one scramble run through both packages."""
    cols = {k: np.array(v) for k, v in columns.items()}
    valid = np.array(valid, dtype=bool)
    for name, col in cols.items():
        if col.shape != valid.shape:
            raise ValueError(f"column {name!r} has shape {col.shape}, "
                             f"expected {valid.shape}")
    if valid.shape[1] != block_rows:
        raise ValueError(f"valid has {valid.shape[1]} rows per block, "
                         f"expected block_rows={block_rows}")
    return Scramble(columns=cols, valid=valid, n_rows=int(n_rows),
                    block_rows=int(block_rows), catalog=dict(catalog),
                    categorical=dict(categorical), seed=seed)
