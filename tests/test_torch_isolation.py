"""The port stands alone: importing the whole slice pulls in neither JAX
nor the JAX package, entry points refuse to run on the CPU unless asked,
the kernel wrappers launch or raise (no silent fallback), the
Anderson/DKW path and the training path run on the CPU when asked, and
the parts of the reference that later slices port raise
NotImplementedError (among them the ``"dots"`` remat policy and the
sharded scan)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.aqp import AggQuery, EngineConfig, FastFrame, build_scramble
from repro_torch.core.optstop import AbsoluteWidth
from repro_torch.configs import get as get_config
from repro_torch.kernels import (bitmap_active, block_agg, fused_fold,
                                 grouped_hist, ops, selective_scan)
from repro_torch.models import build as build_model

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import sys
import repro_torch
import repro_torch.aqp, repro_torch.aqp.engine, repro_torch.aqp.bitmap
import repro_torch.aqp.query, repro_torch.aqp.scramble
import repro_torch.aqp.flights_queries
import repro_torch.core.state, repro_torch.core.bounders
import repro_torch.core.rangetrim, repro_torch.core.count_sum
import repro_torch.core.optstop, repro_torch.core.derived_bounds
import repro_torch.core.lru
import repro_torch.data.flights
import repro_torch.kernels.ops, repro_torch.kernels.ref
import repro_torch.kernels.fused_scan, repro_torch.kernels.block_agg
import repro_torch.kernels.bitmap_active, repro_torch.kernels._build
import repro_torch.kernels.fused_fold, repro_torch.kernels.grouped_hist
import repro_torch.kernels.selective_scan, repro_torch.device
import repro_torch.configs, repro_torch.configs.base
import repro_torch.configs.registry, repro_torch.configs.falcon_mamba_7b
import repro_torch.models, repro_torch.models.layers, repro_torch.models.ssm
import repro_torch.models.lm, repro_torch.models.zoo
import repro_torch.models.convert
import repro_torch.train, repro_torch.train.optimizer
import repro_torch.train.trainer, repro_torch.data.tokens
import repro_torch.serve, repro_torch.serve.frame_server
import repro_torch.serve.checkpoint, repro_torch.serve.scheduler
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("LEAKED", bad)
"""


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def _tiny_scramble():
    rng = np.random.default_rng(0)
    return build_scramble({"v": rng.random(500).astype(np.float32),
                           "g": rng.integers(0, 3, 500).astype(np.int32)},
                          block_rows=64, seed=0)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = _tiny_scramble()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FastFrame(sc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FastFrame(sc, device="cuda")
    assert FastFrame(sc, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(shard_rows=True),
                                dict(mesh_shape=(2,)),
                                dict(merge_every=2)])
def test_later_slices_raise_not_implemented(kw):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        EngineConfig(**kw)


def test_histogram_and_multi_probe_raise_not_implemented():
    """The histogram fold, the Anderson/DKW query and the multi-query
    probe of serving now run on the CPU (plain versions): the probe gives
    each row of the stack its own flags, and launches no kernel."""
    h = ops.grouped_hist(torch.tensor([0.1, 0.6, 0.9, float("nan")]),
                         torch.zeros(4, dtype=torch.int32), None, 1, 0.0,
                         1.0, nbins=2)
    np.testing.assert_array_equal(h.hist.numpy(), [[2.0, 2.0]])
    before = bitmap_active.active_blocks_multi.launches
    flags = ops.active_blocks_multi(
        torch.tensor([[1], [2], [0], [3]], dtype=torch.int32),
        torch.tensor([[1], [2]], dtype=torch.int32))
    np.testing.assert_array_equal(flags.numpy(), [[1, 0, 0, 1],
                                                  [0, 1, 0, 1]])
    assert bitmap_active.active_blocks_multi.launches == before
    q = AggQuery(agg="avg", column="v", bounder="anderson_dkw",
                 rangetrim=False, stop=AbsoluteWidth(eps=0.1))
    res = FastFrame(_tiny_scramble(), EngineConfig(hist_bins=100),
                    device="cpu").run(q)
    assert res.lo[0] <= res.estimate[0] <= res.hi[0]
    assert res.count_seen[0] > 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise; only ops picks the plain version,
    and only because the tensors lie on the CPU."""
    v = torch.zeros((2, 8))
    g = torch.zeros((2, 8), dtype=torch.int32)
    blk = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA"):
        block_agg.block_agg(v, g, v, blk, blk, 0.0, 1)
    with pytest.raises(ValueError, match="needs CUDA"):
        bitmap_active.active_blocks(g, g[0, :1].contiguous())
    with pytest.raises(ValueError, match="needs CUDA"):
        bitmap_active.active_blocks_multi(g, g[:1, :].contiguous())
    with pytest.raises(ValueError, match="needs CUDA"):
        fused_fold.fused_fold(v, g, v, blk, blk, 0.0, 0.0, 1.0, 1, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        grouped_hist.grouped_hist(v, g, v, 0.0, 1.0, 1, 8)
    with pytest.raises(ValueError, match="not supported"):
        ops.grouped_sums(v.to("meta"), g.to("meta"), None, 1)
    x = torch.zeros((1, 4, 8))
    b = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="needs CUDA"):
        selective_scan.selective_scan(x, x, b, b, torch.zeros((8, 8)),
                                      torch.zeros(8), torch.zeros((1, 8, 8)))
    with pytest.raises(ValueError, match="needs CUDA"):
        selective_scan.selective_scan_bwd(
            x, x, b, b, torch.zeros((8, 8)), torch.zeros(8),
            torch.zeros((1, 1, 8, 8)), x, torch.zeros((1, 8, 8)))


def _tiny_model():
    return build_model(get_config("falcon_mamba_7b", reduced=True))


def test_model_init_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _tiny_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(0, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(2, 16)
    lm = model.init(0, device="cpu")
    assert {p.device.type for p in lm.parameters()} == {"cpu"}
    assert model.init_cache(2, 16, device="cpu")["layers"]["h"].device.type \
        == "cpu"


def test_model_loss_and_scan_backward_raise_not_implemented():
    """Training is ported: the loss and the scan's backward (kernel #6)
    run on the CPU with their plain versions and never touch the card's
    counters; the reference's ``"dots"`` remat policy still raises."""
    import dataclasses
    model = _tiny_model()
    lm = model.init(0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    before = (selective_scan.selective_scan.launches,
              selective_scan.selective_scan_bwd.launches)
    loss, metrics = model.loss(lm, {"tokens": toks, "targets": toks})
    loss.backward()
    assert torch.isfinite(loss) and float(metrics["tokens"]) == 8.0
    rng = np.random.default_rng(0)
    B, L, din, n = 1, 16, 128, 8
    x, dt = (torch.tensor(rng.random((B, L, din)), dtype=torch.float32,
                          requires_grad=True) for _ in range(2))
    b, c = (torch.tensor(rng.random((B, L, n)), dtype=torch.float32)
            for _ in range(2))
    a = -torch.ones((din, n))
    y, h = selective_scan.make_trainable_scan()(
        x, dt, b, c, a, torch.ones(din), torch.zeros((B, din, n)))
    assert y.shape == (B, L, din) and h.shape == (B, din, n)
    y.sum().backward()
    assert x.grad.shape == (B, L, din) and torch.isfinite(dt.grad).all()
    assert (selective_scan.selective_scan.launches,
            selective_scan.selective_scan_bwd.launches) == before
    dots = build_model(dataclasses.replace(
        get_config("falcon_mamba_7b", reduced=True), remat_policy="dots"))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        dots.loss(dots.init(0, device="cpu"),
                  {"tokens": toks, "targets": toks})
