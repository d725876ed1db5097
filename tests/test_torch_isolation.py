"""The port stands alone: importing the whole slice pulls in neither JAX
nor the JAX package, entry points refuse to run on the CPU unless asked,
the kernel wrappers launch or raise (no silent fallback), and the parts
of the reference that later slices port raise NotImplementedError."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.aqp import AggQuery, EngineConfig, FastFrame, build_scramble
from repro_torch.core.optstop import AbsoluteWidth
from repro_torch.kernels import bitmap_active, block_agg, ops

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


@pytest.mark.parametrize("kw", [dict(device_loop=True),
                                dict(shard_rows=True),
                                dict(mesh_shape=(2,)),
                                dict(merge_every=2)])
def test_later_slices_raise_not_implemented(kw):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        EngineConfig(**kw)


def test_histogram_and_multi_probe_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="later slice"):
        ops.grouped_hist(torch.zeros(4), torch.zeros(4, dtype=torch.int32),
                         None, 1, 0.0, 1.0)
    with pytest.raises(NotImplementedError, match="serving slice"):
        ops.active_blocks_multi(torch.zeros((4, 1), dtype=torch.int32),
                                torch.zeros((2, 1), dtype=torch.int32))
    q = AggQuery(agg="avg", column="v", bounder="anderson_dkw",
                 rangetrim=False, stop=AbsoluteWidth(eps=0.1))
    with pytest.raises(NotImplementedError):
        FastFrame(_tiny_scramble(), device="cpu").run(q)


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
    with pytest.raises(ValueError, match="not supported"):
        ops.grouped_sums(v.to("meta"), g.to("meta"), None, 1)
