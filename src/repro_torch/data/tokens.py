"""Synthetic LM token pipeline: deterministic and restart-safe.

The port of :mod:`repro.data.tokens` (numpy only, a copy, not an
import). :func:`train_batch` draws the same tokens as the reference for
the same ``(cfg, shape, step, seed, host)``, from a counter-based RNG
keyed on ``(seed, step, host)``. The token stream is a small
deterministic Markov chain over the vocabulary, so a model can learn it.

Eval sets are materialized once and SCRAMBLED (paper Definition 4) by
:func:`make_eval_scramble`, bitwise the reference's for the same seed,
so :class:`repro_torch.evalx.ApproxEval`'s scan prefixes are uniform
without-replacement samples.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.zoo import input_specs


def _rng(seed: int, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, host]))


def _markov_tokens(rng, shape, vocab: int) -> np.ndarray:
    """Cheap structured stream: next ~ (prev * a + noise) mod vocab."""
    b, t = shape
    a = 6364136223846793005 % vocab or 1
    x = rng.integers(0, vocab, size=(b, 1), dtype=np.int64)
    cols = [x]
    noise = rng.integers(0, max(vocab // 64, 2), size=(b, t - 1))
    for i in range(t - 1):
        x = (x * a + 1 + noise[:, i:i + 1]) % vocab
        cols.append(x)
    return np.concatenate(cols, axis=1).astype(np.int32)


def train_batch(cfg: ArchConfig, shape: ShapeConfig, step: int,
                seed: int = 0, host: int = 0,
                host_count: int = 1) -> Dict[str, np.ndarray]:
    """One (host-slice of a) global batch matching ``input_specs``, as
    numpy arrays (``torch.from_numpy`` them onto the device)."""
    specs = input_specs(cfg, shape)
    rng = _rng(seed, step, host)
    out = {}
    for k, s in specs.items():
        shp = list(s.shape)
        shp[0] = shp[0] // host_count
        if k == "tokens":
            out[k] = _markov_tokens(rng, (shp[0], shp[1]), cfg.vocab)
        elif k == "targets":
            pass  # filled from tokens below
        elif k == "token":
            out[k] = rng.integers(0, cfg.vocab, size=shp).astype(np.int32)
        elif k == "pos":
            out[k] = np.asarray(shape.seq_len // 2, np.int32)
        else:  # frame/patch embeddings stubs
            out[k] = rng.normal(0, 0.02, size=shp).astype(np.float32)
    if "targets" in specs:
        t_shape = list(specs["targets"].shape)
        t_shape[0] //= host_count
        targets = np.full(t_shape, -1, np.int32)
        toks = out["tokens"]
        front = t_shape[1] - (toks.shape[1] - 1)
        targets[:, front:] = toks[:, 1:]
        out["targets"] = targets
    return out


@dataclasses.dataclass
class EvalScramble:
    """Pre-shuffled eval set (tokens) for ApproxEval."""

    tokens: np.ndarray   # (N, T) already permuted
    seed: int

    @property
    def n_examples(self) -> int:
        return self.tokens.shape[0]

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        """Numpy batches of ``batch_size`` examples in scramble order
        (a trailing partial batch is dropped); ``targets`` are the
        tokens shifted left, ``-1`` at the last position."""
        n = self.n_examples // batch_size * batch_size
        for lo in range(0, n, batch_size):
            toks = self.tokens[lo:lo + batch_size]
            targets = np.concatenate(
                [toks[:, 1:], np.full((toks.shape[0], 1), -1, np.int32)],
                axis=1)
            yield {"tokens": toks, "targets": targets}


def make_eval_scramble(cfg: ArchConfig, n_examples: int, seq_len: int,
                       seed: int = 1234) -> EvalScramble:
    rng = np.random.default_rng(seed)
    toks = _markov_tokens(rng, (n_examples, seq_len), cfg.vocab)
    perm = rng.permutation(n_examples)
    return EvalScramble(tokens=toks[perm], seed=seed)
