"""``repro_torch.launch.step_cost``, the port of the reference's
``launch/hlo_cost.py``, on the CPU.

  * FLOPs: a reduced config's step (2 x 64 tokens) on meta against the
    reference's ``hlo_cost.analyze`` of the same step jitted and compiled
    for the CPU, EXACTLY. Where the two programs differ, the difference
    is named op by op and held exactly, never with a tolerance:

      - falcon-mamba's train step: the port computes ``dh = dy (x) C``
        of the chunked scan's ``y = einsum("bldn,bln->bld", h, C)``
        backward as a ``bmm`` with a contraction of one element
        (``(B Lc, din, 1) @ (B Lc, 1, n)``), once a layer a chunk; the
        reference's compiled step has no dot for it (XLA rewrites a dot
        that contracts nothing into a broadcast multiply);
      - zamba2's train step: three differences of program, each held to
        its arithmetic (:func:`zamba2_gap`).

  * bytes: ``bytes_accessed`` of a matmul, an add, a view and a sum
    equals the hand arithmetic;
  * peak: ``peak_bytes`` and ``temp_bytes`` on meta equal the same run on
    real CPU tensors, exactly, for reduced steps of each family, and a
    chain of known live set (a view that must not count twice);
  * collectives: a ``fake`` group of 4 gives each kind's ``count`` and
    ``bytes``; the sharded train step on meta in the fake group as rank
    0 (``tests/helpers/torch_step_cost_fake.py``) equals rank 0's real
    step on a gloo world of 4 CPU ranks (``tests/helpers/
    torch_sharded_train_ops.op_step_cost``) in collectives, FLOPs, peak
    and temp bytes, and that step's ``collectives.COLLECTIVES`` tally;
  * kernels: each of the six kernels' reported bytes (``traffic``) equal
    its plain version's operand and result sizes at a small shape, a
    reported launch counts as one op of those bytes and no FLOPs, and
    an unreported one (a stub counter: no kernel runs here) raises.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get as jget
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import hlo_cost
from repro.models import build as jbuild
from repro.models import input_specs as jinput_specs
from repro.models.zoo import window_for as jwindow_for
from repro.train import OptConfig as JOptConfig
from repro.train import abstract_state as jabstract_state
from repro.train import build_train_step as jbuild_train_step
from repro_torch.configs import ShapeConfig, get
from repro_torch.kernels import _build, ref
from repro_torch.kernels import bitmap_active as kbit
from repro_torch.kernels import block_agg as kblock
from repro_torch.kernels import fused_fold as kfused
from repro_torch.kernels import grouped_hist as khist
from repro_torch.kernels import selective_scan as kscan
from repro_torch.launch import dryrun, step_cost
from repro_torch.models import build, lm
from tests.helpers.torch_dist_world import DistWorld
from tests.helpers.torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
B, T = 2, 64
SHARDED_ARCHS = ["qwen3_0_6b", "dbrx_132b", "zamba2_7b"]


def reference_flops(arch: str, kind: str) -> int:
    """``hlo_cost.analyze(...)["flops"]`` of the reference's step of the
    reduced config at ``B x T``, jitted and compiled for the CPU."""
    cfg = jget(arch, reduced=True)
    shape = JShapeConfig("t", T, B, kind)
    model = jbuild(cfg)
    specs = jinput_specs(cfg, shape)
    window = jwindow_for(cfg, T)
    if kind == "train":
        ocfg = JOptConfig.for_arch(cfg)
        fn = jbuild_train_step(model, ocfg, window=window)
        args = (jabstract_state(model, ocfg), specs)
    else:
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        if kind == "prefill":
            def fn(p, b):
                return model.prefill(p, b, window)
            args = (params, specs)
        else:
            cache = jax.eval_shape(lambda: model.init_cache(B, T))

            def fn(p, c, b):
                return model.decode(p, c, b, window)
            args = (params, cache, specs)
    text = jax.jit(fn).lower(*args).compile().as_text()
    return int(hlo_cost.analyze(text)["flops"])


class ProductShapes(TorchDispatchMode):
    """The ``mm`` / ``bmm`` calls of a run that contract one element:
    ``[(op, (lhs shape, rhs shape), flops)]``."""

    def __init__(self):
        super().__init__()
        self.single = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default) \
                and args[0].shape[-1] == 1:
            self.single.append((str(func), (tuple(args[0].shape),
                                             tuple(args[1].shape)),
                                2 * out.numel()))
        return out


def port_cost(arch: str, kind: str) -> dict:
    model = build(get(arch, reduced=True))
    trees, run = dryrun.step_trees(model, ShapeConfig("t", T, B, kind),
                                   "meta")
    return step_cost.analyze(run, inputs=trees)


def zamba2_gap(cfg) -> int:
    """The reference's train-step FLOPs less the port's for reduced
    zamba2 at ``B x T``, by its three named causes:

      1. nested remat: the reference's ``jax.checkpoint`` of the group
         body (around the shared block and a ``jax.checkpoint``-ed scan
         of the group's Mamba2 layers) recomputes each grouped layer's
         forward twice in the backward; the port remats each layer and
         the shared block once (one more forward of every grouped layer);
      2. that outer recompute runs the shared block whole (its output
         feeds the layers' recompute), where the port's checkpoint of
         the shared block stops early, before the block's last product,
         the MLP's down projection, whose output the backward does not
         need (once a group);
      3. in every Mamba2 layer's SSD scan, per chunk: the reference's
         three-operand einsums (``bln,bhpn,blh->blhp`` for ``y_inter``
         and ``blh,bln,blhp->bhpn`` for the state's contribution) form an
         outer product whose transpose is two dots each in the backward
         (contracting the heads or the states), where the port's
         factoring has elementwise products; and the reference's scan
         body, a loop, differentiates every chunk alike: the first
         chunk's ``y_inter`` against its zero carried state (one dot)
         and the last chunk's contribution to a final state the loss
         does not read (two dots), which the port's autograd skips."""
    model = build(cfg)
    params = model.init(0, device="meta")
    n_groups = len(params.layers)
    n_grouped = sum(len(g) for g in params.layers)
    h = torch.empty((B, T, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    with torch.no_grad():
        layer_fwd = step_cost.analyze(
            lambda: lm._ssm_layer(params.layers[0][0], cfg, h))["flops"]
    down_proj = 2 * B * T * cfg.d_ff * cfg.d_model
    lc = min(cfg.ssm_chunk, T)
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    nh = cfg.ssm_expand * cfg.d_model // hd
    outer_t = 2 * B * lc * n * nh                  # a transpose's dot
    first_ds = 2 * B * nh * hd * n * lc            # d(carried state)
    last_contrib = 2 * (2 * B * lc * nh * n * hd)  # its two dots
    per_layer = first_ds + last_contrib + 4 * (T // lc) * outer_t
    return (n_grouped * layer_fwd + n_groups * down_proj
            + cfg.n_layers * per_layer)


@pytest.mark.parametrize("arch,kind", [
    ("qwen3_0_6b", "train"), ("qwen3_0_6b", "prefill"),
    ("qwen3_0_6b", "decode"), ("falcon_mamba_7b", "prefill"),
    ("seamless_m4t_large_v2", "train")])
def test_flops_equal_reference_hlo_cost(one_torch_thread, arch, kind):
    assert port_cost(arch, kind)["flops"] == reference_flops(arch, kind)


def test_falcon_mamba_train_flops_differ_by_named_product(one_torch_thread):
    cfg = get("falcon_mamba_7b", reduced=True)
    model = build(cfg)
    _, run = dryrun.step_trees(model, ShapeConfig("t", T, B, "train"),
                               "meta")
    shapes = ProductShapes()
    with shapes:
        got = step_cost.analyze(run)["flops"]
    lc = min(cfg.ssm_chunk, T)
    din = cfg.ssm_expand * cfg.d_model
    want = [("aten.bmm.default", ((B * lc, din, 1), (B * lc, 1,
                                                     cfg.ssm_state)))]
    assert [s[:2] for s in shapes.single] == want * (cfg.n_layers * T // lc)
    extra = sum(s[2] for s in shapes.single)
    assert extra == 4_194_304
    assert got - extra == reference_flops("falcon_mamba_7b", "train")


def test_zamba2_train_flops_differ_by_named_causes(one_torch_thread):
    cfg = get("zamba2_7b", reduced=True)
    got = port_cost("zamba2_7b", "train")["flops"]
    assert got + zamba2_gap(cfg) == reference_flops("zamba2_7b", "train")


def test_flops_equal_flop_counter_mode(one_torch_thread):
    """The count is FlopCounterMode's (same formulas, same decomposition
    rule), on real CPU tensors."""
    model = build(get("qwen3_0_6b", reduced=True))
    shape = ShapeConfig("t", T, B, "train")
    with FlopCounterMode(display=False) as counter:
        dryrun.step_trees(model, shape, "cpu")[1]()
    want = int(counter.get_total_flops())
    assert step_cost.analyze(
        dryrun.step_trees(model, shape, "cpu")[1])["flops"] == want


# -- bytes and peak -----------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_bytes_of_a_small_function(device):
    x = torch.ones(64, 32, device=device)
    w = torch.ones(32, 16, device=device)

    def run():
        y = x @ w              # reads 8192 + 2048, writes 4096
        z = y + 1              # reads 4096, writes 4096
        v = z.view(-1)         # a view: nothing
        return v.sum()         # reads 4096, writes 4

    cost = step_cost.analyze(run, inputs=(x, w))
    assert cost["bytes_accessed"] == (8192 + 2048 + 4096) + 8192 + 4100
    assert cost["n_ops"] == 3
    assert cost["flops"] == 2 * 64 * 32 * 16
    assert cost["collective_bytes"] == 0
    # x, w, y, z and the sum alive at the end
    assert cost["peak_bytes"] == 8192 + 2048 + 4096 + 4096 + 4
    assert cost["temp_bytes"] == 4096 + 4096 + 4
    assert cost["input_bytes"] == 8192 + 2048


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_peak_of_a_chain_with_known_live_set(device):
    x = torch.ones(1000, device=device)
    a = 4000

    def run():
        y = x * 2
        v = y.view(10, 100)    # the same storage: counts once
        z = v + 1              # x, y, z: the peak, 3 a
        del y, v               # y's storage goes
        w = z * 3              # x, z, w: 3 a again
        del z
        return w.sum()         # x, w and the sum

    cost = step_cost.analyze(run, inputs=(x,))
    assert cost["peak_bytes"] == 3 * a
    assert cost["temp_bytes"] == 2 * a
    assert cost["input_bytes"] == a


def same_cost(arch: str, meta: dict, real: dict) -> bool:
    """Every number equal; for the MoE config all but the bytes and op
    count: ``F.one_hot`` of the router's choices dispatches other ops on
    the CPU (a bounds check through ``aminmax`` and ``item``, then
    ``zeros`` and ``scatter_``) than on meta (``arange`` and ``eq``)."""
    if arch != "dbrx_132b":
        return meta == real
    moved = ("bytes_accessed", "n_ops")
    return ({k: v for k, v in meta.items() if k not in moved}
            == {k: v for k, v in real.items() if k not in moved})


@pytest.mark.parametrize("arch,kind", [
    ("qwen3_0_6b", "train"), ("qwen3_0_6b", "decode"),
    ("dbrx_132b", "train"), ("falcon_mamba_7b", "train"),
    ("falcon_mamba_7b", "prefill"), ("zamba2_7b", "train"),
    ("seamless_m4t_large_v2", "train")])
def test_meta_cost_equals_cpu_cost(one_torch_thread, arch, kind):
    """Every number of a step on meta equals the same step on real CPU
    tensors: peak and temp bytes exactly, as bytes and FLOPs."""
    model = build(get(arch, reduced=True))
    shape = ShapeConfig("t", T, B, kind)
    got = {}
    for dev in ("meta", "cpu"):
        trees, run = dryrun.step_trees(model, shape, dev)
        got[dev] = step_cost.analyze(run, inputs=trees)
    assert same_cost(arch, got["meta"], got["cpu"])
    assert got["cpu"]["temp_bytes"] > 0
    assert got["cpu"]["peak_bytes"] == (got["cpu"]["temp_bytes"]
                                        + got["cpu"]["input_bytes"])


# -- collectives --------------------------------------------------------------


@pytest.fixture(scope="module")
def fake_group():
    """The fake-group helper's record (a process of its own)."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "tests.helpers.torch_step_cost_fake",
         *SHARDED_ARCHS], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def gloo_steps(tmp_path_factory):
    """Rank 0's ``op_step_cost`` record of each config, on a gloo world
    of 4 CPU ranks."""
    world = DistWorld(4, tmp_path_factory.mktemp("gloo4_cost"))
    try:
        out = {}
        for arch in SHARDED_ARCHS:
            recs = world.run("step_cost", 240, arch=arch)
            out[arch] = next(r for r in recs if r["rank"] == 0)
        return out
    finally:
        world.close()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_collective_kinds_in_a_fake_group(fake_group, device):
    colls = fake_group["kinds"][device]["collectives"]
    f32 = 4
    assert colls == {
        # all_gather, all_gather_into_tensor, funcol's: 8 floats each
        "all-gather": {"count": 3, "bytes": 3 * 8 * f32},
        # all_reduce and funcol's: 8 floats each
        "all-reduce": {"count": 2, "bytes": 2 * 8 * f32},
        # reduce_scatter_tensor of 16 floats, reduce_scatter of 4 x 4
        "reduce-scatter": {"count": 2, "bytes": 2 * 16 * f32},
        "all-to-all": {"count": 1, "bytes": 16 * f32},
        # send of 3 floats; the recv and the barrier carry nothing
        "collective-permute": {"count": 1, "bytes": 3 * f32}}
    assert fake_group["kinds"][device]["collective_bytes"] == (
        (24 + 16 + 32 + 16 + 3) * f32)


@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_sharded_step_on_meta_equals_gloo_rank0(fake_group, gloo_steps,
                                                arch):
    meta = fake_group["sharded"][arch]
    real = gloo_steps[arch]
    assert same_cost(arch, meta, real["cost"])
    assert sum(c["count"] for c in meta["collectives"].values()) == \
        real["tally"]["calls"] > 0
    assert meta["collective_bytes"] == real["tally"]["bytes"]


# -- the hand-written kernels -------------------------------------------------


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _fold_inputs(G=5, nb=6, block_rows=32, budget=4):
    g = torch.Generator().manual_seed(0)
    values = torch.randn(nb, block_rows, generator=g)
    gids = torch.randint(0, G, (nb, block_rows), generator=g,
                         dtype=torch.int32)
    mask = torch.ones(nb, block_rows)
    blk = torch.tensor([3, 0, 5, 0], dtype=torch.int32)[:budget]
    tvalid = torch.tensor([1, 1, 1, 0], dtype=torch.int32)[:budget]
    return values, gids, mask, blk, tvalid


def test_fold_and_hist_traffic_is_operands_and_results():
    values, gids, mask, blk, tvalid = _fold_inputs()
    G, nbins = 5, 16
    rows = [t[blk.long()] for t in (values, gids, mask)]
    out = ref.block_agg_blocks_ref(values, gids, mask, blk, tvalid, 0.0,
                                   num_groups=G)
    assert kblock.traffic(values, gids, mask, blk.shape[0], G) == (
        _nbytes(*rows, blk, tvalid), _nbytes(*out))
    out = ref.fused_fold_ref(values, gids, mask, blk, tvalid, 0.0, -3.0,
                             3.0, num_groups=G, nbins=nbins)
    assert kfused.traffic(values, gids, mask, blk.shape[0], G, nbins) == (
        _nbytes(*rows, blk, tvalid), _nbytes(*out))
    hist = ref.grouped_hist_ref(values, gids, mask, -3.0, 3.0,
                                num_groups=G, nbins=nbins)
    assert khist.traffic(values, gids, mask, G, nbins) == (
        _nbytes(values, gids, mask), _nbytes(hist))


def test_probe_and_head_traffic_is_operands_and_results():
    g = torch.Generator().manual_seed(1)
    nb, W, Q, window, budget = 12, 3, 2, 5, 3
    words = torch.randint(0, 2 ** 30, (nb, W), generator=g,
                          dtype=torch.int32)
    act = torch.randint(0, 2 ** 30, (W,), generator=g, dtype=torch.int32)
    stack = torch.randint(0, 2 ** 30, (Q, W), generator=g,
                          dtype=torch.int32)
    win = torch.tensor([4, 1, 7], dtype=torch.int32)
    flags = ref.active_blocks_ref(words, act)
    assert kbit.probe_traffic(words, act) == (_nbytes(words, act),
                                              _nbytes(flags))
    flags = ref.active_blocks_multi_ref(words[win.long()], stack)
    assert kbit.probe_traffic(words, stack, win) == (
        _nbytes(words[win.long()], stack, win), _nbytes(flags))
    order_pad = torch.arange(nb + window, dtype=torch.int32) % nb
    static_ok = torch.ones(nb, dtype=torch.bool)
    pos = torch.zeros((), dtype=torch.int64)
    go = torch.ones((), dtype=torch.bool)
    out = ref.round_select_ref(order_pad, static_ok, words, stack, pos, go,
                               nb=nb, window=window, budget=budget,
                               probe=True)
    # the window's order entries, static verdicts and rows read
    read = _nbytes(order_pad[:window], static_ok[:window], words[:window],
                   stack)
    assert kbit.head_traffic(words, stack, window=window, budget=budget,
                             probe=True) == (read, _nbytes(*out))


def test_scan_traffic_is_operands_and_results():
    g = torch.Generator().manual_seed(2)
    Bs, L, din, n, tc = 2, 16, 8, 4, 8

    def r(*shape):
        return torch.randn(*shape, generator=g)
    x, dt, b, c = r(Bs, L, din), r(Bs, L, din).abs(), r(Bs, L, n), \
        r(Bs, L, n)
    a, d, h0 = -r(din, n).abs(), r(din), r(Bs, din, n)
    outs = ref.selective_scan_ref(x, dt, b, c, a, d, h0, time_chunk=tc)
    assert kscan.traffic(Bs, L, din, n, tc) == (
        _nbytes(x, dt, b, c, a, d, h0), _nbytes(*outs))
    y, _, hseg = outs
    ybar, houtbar = torch.ones_like(y), r(Bs, din, n)
    grads = ref.selective_scan_bwd_ref(x, dt, b, c, a, d, hseg, ybar,
                                       houtbar, time_chunk=tc)
    assert kscan.bwd_traffic(Bs, L, din, n, tc) == (
        _nbytes(x, dt, b, c, a, d, hseg, ybar, houtbar), _nbytes(*grads))


def test_reported_launch_counts_as_one_op(monkeypatch):
    monkeypatch.setattr(kblock.block_agg, "launches", 0)
    values, gids, mask, blk, _ = _fold_inputs()
    read, written = kblock.traffic(values, gids, mask, blk.shape[0], 5)

    def launch():              # a stub of the wrapper's counting
        kblock.block_agg.launches += 1
        _build.report("block_agg", read, written)

    cost = step_cost.analyze(launch)
    assert cost["kernels"] == {"block_agg": {"count": 1,
                                             "bytes": read + written}}
    assert cost["n_ops"] == 1 and cost["bytes_accessed"] == read + written
    assert cost["flops"] == 0
    assert not _build.LAUNCH_REPORTS


def test_unreported_launch_raises(monkeypatch):
    monkeypatch.setattr(kscan.selective_scan, "launches", 0)

    def launch():              # a stub that counts and does not report
        kscan.selective_scan.launches += 1

    with pytest.raises(RuntimeError, match="selective_scan launched 1"):
        step_cost.analyze(launch)
    assert not _build.LAUNCH_REPORTS


def test_products_with_out_dtype_count_their_flops():
    """``mm`` / ``bmm`` of bf16 operands writing float32 (a
    tensor-parallel rank's partial products on a card and on meta)
    count the product's FLOPs, and read and write their bytes."""
    def t(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    a, b, a2, b2 = t(3, 5, 64), t(3, 64, 7), t(10, 64), t(64, 7)
    cost = step_cost.analyze(lambda: (
        torch.bmm(a, b, out_dtype=torch.float32),
        torch.mm(a2, b2, out_dtype=torch.float32)), inputs=(a, b, a2, b2))
    assert cost["flops"] == 2 * 3 * 5 * 64 * 7 + 2 * 10 * 64 * 7
    assert cost["bytes_accessed"] == 2 * (a.numel() + b.numel() + a2.numel()
                                          + b2.numel()) + 4 * (3 * 5 * 7
                                                               + 10 * 7)


def test_meta_scan_reports_its_launch_without_counting(monkeypatch):
    """falcon-mamba's prefill through the hand-written scan on meta: each
    layer's stand-in reports the kernel's bytes (``traffic``), counting
    no launch."""
    monkeypatch.setattr(kscan.selective_scan, "launches", 0)
    cfg = dataclasses.replace(get("falcon_mamba_7b", reduced=True),
                              ssm_impl="pallas")
    trees, run = dryrun.step_trees(build(cfg), ShapeConfig(
        "t", T, B, "prefill"), "meta")
    cost = step_cost.analyze(run, inputs=trees)
    one = sum(kscan.traffic(B, T, cfg.d_inner, cfg.ssm_state, min(512, T)))
    assert cost["kernels"] == {"selective_scan": {
        "count": cfg.n_layers, "bytes": cfg.n_layers * one}}
    assert kscan.selective_scan.launches == 0
    assert not _build.LAUNCH_REPORTS


def test_counters_are_every_kernel_wrapper():
    names = set(step_cost.kernel_counters())
    assert names == {"block_agg", "fused_fold", "grouped_hist",
                     "active_blocks", "active_blocks_multi", "round_select",
                     "selective_scan", "selective_scan_bwd"}
    assert all(isinstance(f.launches, int)
               for f in step_cost.kernel_counters().values())
