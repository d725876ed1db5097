"""Block-level bitmap indexes over categorical attributes (paper §4 / [50]).

``BlockBitmap.words[i, w]`` has bit ``j`` set iff block ``i`` contains at
least one tuple of category ``32*w + j``.  Built once at load time; the
active-scanning lookahead ANDs these words against the packed active-group
mask (``repro_torch.kernels.ops.active_blocks``) to pick the blocks worth fetching.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.aqp.scramble import Scramble


@dataclasses.dataclass
class BlockBitmap:
    words: np.ndarray       # (n_blocks, n_words) uint32
    cardinality: int

    @property
    def n_words(self) -> int:
        return self.words.shape[1]


def unpack_words(words: np.ndarray, cardinality: int) -> np.ndarray:
    """Inverse of the word packing: ``(B, W)`` uint32 words -> ``(B, C)``
    bool presence matrix. The engine uses this to turn a group bitmap
    into the per-block view-presence matrix that drives taint accounting
    and exactness tracking."""
    u8 = words.astype("<u4").view(np.uint8)
    bits = np.unpackbits(u8.reshape(words.shape[0], -1), axis=1,
                         bitorder="little")
    return bits[:, :cardinality].astype(bool)


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """Boolean (C,) category mask -> packed (ceil(C/32),) uint32 words."""
    c = mask.shape[0]
    n_words = -(-c // 32)
    padded = np.zeros(n_words * 32, dtype=bool)
    padded[:c] = mask
    bits = padded.reshape(n_words, 32)
    weights = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint64)
    return (bits.astype(np.uint64) * weights).sum(axis=1).astype(np.uint32)


def build_bitmap(scramble: Scramble, column: str) -> BlockBitmap:
    codes = scramble.columns[column]
    card = scramble.categorical[column]
    n_blocks, block_rows = codes.shape
    n_words = -(-card // 32)
    words = np.zeros((n_blocks, n_words), dtype=np.uint32)
    valid = scramble.valid
    # vectorized per-block presence: one-hot OR-reduce in chunks
    for lo in range(0, n_blocks, 4096):
        hi = min(lo + 4096, n_blocks)
        c = codes[lo:hi]
        v = valid[lo:hi]
        # presence (chunk, card)
        pres = np.zeros((hi - lo, card), dtype=bool)
        rows = np.repeat(np.arange(hi - lo), block_rows)
        pres[rows[v.reshape(-1)], c.reshape(-1)[v.reshape(-1)]] = True
        pad = np.zeros((hi - lo, n_words * 32 - card), dtype=bool)
        bits = np.concatenate([pres, pad], axis=1)
        bits = bits.reshape(hi - lo, n_words, 32)
        weights = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint64)
        words[lo:hi] = (bits.astype(np.uint64) * weights).sum(axis=2)\
            .astype(np.uint32)
    return BlockBitmap(words=words, cardinality=card)
