"""The port's training stack on the CPU: checkpoints
(``distributed/checkpoint.py``), int8 gradient compression
(``distributed/grad_compression.py``) and the training driver
(``launch/train.py``), the mirror of ``tests/test_train_stack.py`` and
held against the JAX package where both compute the same thing.

Tolerances (``max |port - ref| <= tol * max |ref|``), those of
``tests/test_torch_train.py``: the loss CI state of each step 1e-5; the
AdamW moments after the driver's three steps 1e-4, the parameters 1e-4
plus what AdamW's unit-size update carries over from each element's own
moments at each step (``tests/helpers/torch_train_parity.py``;
measured: a qwen3 embedding element 1.5e-5 off where the leaf's largest
is 4.5e-2, its first moment 3.9e-5 off after the last step).
Checkpoint restores, a resumed run and the compression round trip are
bit for bit.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jax_driver
from repro.distributed import checkpoint as jax_ckpt
from repro.distributed import grad_compression as jgc
from repro_torch.configs import ShapeConfig, get
from repro_torch.data import tokens
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import grad_compression as gc
from repro_torch.launch import train as driver
from repro_torch.models import build, convert
from repro_torch.train import OptConfig, build_train_step, init_state
from tests.helpers.torch_dist_world import DistWorld
from tests.helpers.torch_parity import one_torch_thread  # noqa: F401
from tests.helpers.torch_train_parity import (close_adamw_params,
                                              moments_of)

SCALARS, PARAMS = 1e-5, 1e-4
SHAPE = ShapeConfig("t", 64, 4, "train")
ROOT = Path(__file__).resolve().parents[1]


def _leaves(state):
    return ckpt._leaves(state)


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(_bits(x), _bits(y)), name


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get("qwen3_0_6b", reduced=True),
                              param_dtype="float32",
                              compute_dtype="float32", remat=False)
    model = build(cfg)
    ocfg = OptConfig.for_arch(cfg, lr=5e-3, warmup_steps=5,
                              total_steps=100)
    return cfg, model, ocfg


def _state(setup, seed=0):
    cfg, model, ocfg = setup
    return init_state(model, seed, ocfg, device="cpu")


def _batch(cfg, step):
    return {k: torch.from_numpy(v)
            for k, v in tokens.train_batch(cfg, SHAPE, step).items()}


# -- (d) checkpoints -----------------------------------------------------------


def test_checkpoint_roundtrip_and_resume(tmp_path, setup):
    cfg, model, ocfg = setup
    step = build_train_step(model, ocfg)
    batch = _batch(cfg, 2)
    state1, _ = step(_state(setup), batch)
    join = ckpt.save_checkpoint(tmp_path, 1, state1,
                                meta={"arch": cfg.name}, async_write=True)
    join()
    assert ckpt.latest_step(tmp_path) == 1
    restored, meta = ckpt.restore_checkpoint(tmp_path, 1,
                                             _state(setup, seed=1))
    assert meta["arch"] == cfg.name
    _assert_states_equal(restored, state1)
    # training continues identically from the restore
    _, m_direct = step(state1, batch)
    _, m_restored = step(restored, batch)
    assert torch.equal(m_direct["loss"], m_restored["loss"])


def test_checkpoint_manifest_keeps_the_reference_format(tmp_path, setup):
    state = _state(setup)
    ckpt.save_checkpoint(tmp_path, 7, state, meta={"k": 1})
    d = tmp_path / "step_00000007"
    assert (d / "_COMMITTED").exists()
    import json
    man = json.loads((d / "manifest.json").read_text())
    assert man["step"] == 7 and man["meta"] == {"k": 1}
    names = [e["name"] for e in man["leaves"]]
    assert names[-1] == "step"
    assert "params/embed" in names and "opt/m/embed" in names
    assert [e["file"] for e in man["leaves"]] == [
        f"leaf_{i:05d}.npy" for i in range(len(names))]
    assert set(man["leaves"][0]) == {"name", "file", "shape", "dtype",
                                     "crc32"}


def test_checkpoint_detects_corruption(tmp_path, setup):
    state = _state(setup)
    ckpt.save_checkpoint(tmp_path, 3, state)
    # corrupt one leaf file
    victim = sorted((tmp_path / "step_00000003").glob("leaf_*.npy"))[0]
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        ckpt.restore_checkpoint(tmp_path, 3, state)


def test_checkpoint_atomicity(tmp_path):
    """Uncommitted (interrupted) writes are invisible to readers."""
    tmp_dir = tmp_path / "step_00000009.tmp"
    tmp_dir.mkdir(parents=True)
    (tmp_dir / "manifest.json").write_text("{}")
    assert ckpt.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path, 9, {"x": torch.zeros(1)})


def test_async_write_snapshots_on_the_callers_thread(tmp_path, setup):
    """The trainer updates its parameters in place: an async save holds
    the state as it was when it was called, whatever the steps taken
    before its join."""
    cfg, model, ocfg = setup
    step = build_train_step(model, ocfg)
    state = _state(setup)
    state["step"] += 1                    # lr > 0
    before = {n: t.detach().clone() for n, t in _leaves(state)}
    join = ckpt.save_checkpoint(tmp_path, 1, state, async_write=True)
    state, _ = step(state, _batch(cfg, 0))
    join()
    assert ckpt.latest_step(tmp_path) == 1
    restored, _ = ckpt.restore_checkpoint(tmp_path, 1, _state(setup, 1))
    moved = 0
    for name, t in _leaves(restored):
        assert torch.equal(t, before[name]), name
        moved += not torch.equal(t, dict(_leaves(state))[name])
    assert moved > 0


def test_bfloat16_leaves_restore_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn((5, 7), generator=g).to(torch.bfloat16),
             "n": {"v": torch.tensor([float("inf"), -0.0, 1e-40, 3.0],
                                     dtype=torch.bfloat16)},
             "step": torch.tensor(3, dtype=torch.int32)}
    ckpt.save_checkpoint(tmp_path, 1, state)
    import json
    man = json.loads((tmp_path / "step_00000001" / "manifest.json")
                     .read_text())
    assert [e["dtype"] for e in man["leaves"]] == ["bfloat16", "bfloat16",
                                                   "int32"]
    like = {"w": torch.zeros((5, 7), dtype=torch.bfloat16),
            "n": {"v": torch.zeros(4, dtype=torch.bfloat16)},
            "step": torch.tensor(0, dtype=torch.int32)}
    restored, _ = ckpt.restore_checkpoint(tmp_path, 1, like)
    _assert_states_equal(restored, state)
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore_checkpoint(tmp_path, 1, {**like, "w": torch.zeros(
            (5, 7))})


def test_reference_checkpoint_loses_bfloat16(tmp_path):
    """The reference's defect that the port does not copy: a bfloat16
    leaf comes back from its checkpoint as raw ``|V2`` bytes (shape and
    crc32 pass), which JAX refuses."""
    w = jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3),
                    jnp.bfloat16)
    jax_ckpt.save_checkpoint(tmp_path, 1, {"w": w})
    restored, _ = jax_ckpt.restore_checkpoint(tmp_path, 1, {"w": w})
    assert restored["w"].dtype.kind == "V" and restored["w"].shape == (2, 3)
    with pytest.raises(TypeError):
        jnp.asarray(restored["w"])


# -- (e) gradient compression --------------------------------------------------


def _grads(seed: int):
    rng = np.random.default_rng(seed)
    return {f"g{i}": rng.normal(0, 10.0 ** rng.uniform(-8, 2),
                                (int(rng.integers(1, 40)), 17)).astype(
        np.float32) for i in range(6)}


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_and_roundtrip_bitwise_reference(seed):
    grads = _grads(seed)
    fb = {k: np.random.default_rng(seed + 10).normal(0, 1e-3, v.shape)
          .astype(np.float32) for k, v in grads.items()}
    for k, g in grads.items():
        q, s = gc.quantize(torch.from_numpy(g))
        jq, js = jgc.quantize(jnp.asarray(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy() == np.asarray(js), k
    dq, fb2 = gc.compress_roundtrip(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in fb.items()})
    jdq, jfb2 = jgc.compress_roundtrip(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in fb.items()})
    for k in grads:
        np.testing.assert_array_equal(dq[k].numpy(), np.asarray(jdq[k]))
        np.testing.assert_array_equal(fb2[k].numpy(), np.asarray(jfb2[k]))


def test_grad_compression_roundtrip(setup):
    """``test_grad_compression_roundtrip`` on the port: one model
    gradient through the round trip, within half a quantum of the
    original, the error feedback its residual."""
    cfg, model, ocfg = setup
    lm = model.init(0, device="cpu")
    loss, _ = model.loss(lm, _batch(cfg, 3))
    grads = dict(zip([n for n, _ in lm.named_parameters()],
                     torch.autograd.grad(loss, list(lm.parameters()))))
    eb = gc.init_error_feedback(dict(lm.named_parameters()))
    assert eb.keys() == grads.keys()
    dq, eb2 = gc.compress_roundtrip(grads, eb)
    for k, g in grads.items():
        g, d = g.double().numpy(), dq[k].double().numpy()
        scale = np.abs(g).max() / 127 + 1e-30
        assert np.abs(g - d).max() <= scale * 0.51 + 1e-12
        # error feedback accumulates the quantization residual exactly
        np.testing.assert_allclose(g - d, eb2[k].numpy(), rtol=1e-5,
                                   atol=1e-7)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    made = {}

    def get_world(n: int) -> DistWorld:
        if n not in made:
            made[n] = DistWorld(n, tmp)
        return made[n]

    yield get_world
    for w in made.values():
        w.close()


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_matches_formula(worlds, n):
    """Each rank's gradient (scale ``10 ** rank``) quantized against the
    group's largest magnitude, the int32 sum dequantized: the numpy
    formula bit for bit, on every rank; within the quantum of the plain
    sum."""
    shape, seed = (33, 5), 7
    outs = worlds(n).run("compressed_psum", timeout=60, shape=shape,
                         seed=seed)
    gs = [np.random.default_rng([seed, r]).normal(
        0.0, 10.0 ** r, shape).astype(np.float32) for r in range(n)]
    gmax = np.float32(max(np.abs(g).max() for g in gs))
    scale = np.float32((gmax + np.float32(1e-30)) / np.float32(127.0))
    q = sum(np.clip(np.round(g / scale), -127, 127).astype(np.int32)
            for g in gs)
    want = q.astype(np.float32) * scale
    for out in outs:
        np.testing.assert_array_equal(np.asarray(out, np.float32), want)
    assert np.abs(want - sum(gs)).max() <= n * 0.5 * scale * 1.0001


# -- (f) the driver --------------------------------------------------------------


class _Recording:
    """A ThresholdMonitor class that keeps every state it is fed."""

    def __init__(self, base, seen):
        self.base, self.seen = base, seen

    def __call__(self, *a, **kw):
        mon = self.base(*a, **kw)
        update = mon.update

        def recorded(state):
            self.seen.append([float(np.asarray(x)) for x in state])
            return update(state)
        mon.update = recorded
        return mon


@pytest.fixture
def keep_sigterm():
    """The reference's ``main`` installs a SIGTERM handler and leaves it;
    put the previous one back after the test."""
    prev = signal.getsignal(signal.SIGTERM)
    yield prev
    signal.signal(signal.SIGTERM, prev)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "falcon_mamba_7b"])
def test_driver_matches_reference(arch, tmp_path, monkeypatch,
                                  keep_sigterm):
    """``main --smoke`` for three steps in both packages, the port's
    from the reference's initial state (``train_state_from_jax``; the
    falcon-mamba smoke config runs the ``xla`` scan): every step's loss
    CI state and the final parameters, AdamW moments and step."""
    args = ["--arch", arch, "--smoke", "--steps", "3", "--ckpt-every",
            "100", "--eval-every", "100"]
    init, ref_ci, port_ci = [], [], []
    ref_init_state = jax_driver.init_state

    def ref_init(*a, **kw):
        init.append(ref_init_state(*a, **kw))
        return init[-1]
    monkeypatch.setattr(jax_driver, "init_state", ref_init)
    ref_moments, port_moments = [], []
    ref_build = jax_driver.build_train_step

    def ref_steps(model, ocfg):
        fn = ref_build(model, ocfg)

        def step(state, batch):
            state, met = fn(state, batch)
            jax.debug.callback(lambda *a: ref_moments.append(
                jax.tree.map(np.asarray, a)), met["lr"],
                state["opt"]["m"], state["opt"]["v"])
            return state, met
        return step
    monkeypatch.setattr(jax_driver, "build_train_step", ref_steps)
    monkeypatch.setattr(jax_driver, "ThresholdMonitor",
                        _Recording(jax_driver.ThresholdMonitor, ref_ci))
    want = jax_driver.main(args + ["--ckpt-dir", str(tmp_path / "ref")])
    monkeypatch.undo()
    signal.signal(signal.SIGTERM, keep_sigterm)

    def port_init(model, seed, ocfg, device=None):
        assert seed == 0 and str(device) == "cpu"
        return convert.train_state_from_jax(
            jax.tree.map(np.asarray, init[0]), model.cfg,
            model.init(0, device="cpu"))
    monkeypatch.setattr(driver, "init_state", port_init)

    def port_steps(model, ocfg):
        fn = build_train_step(model, ocfg)

        def step(state, batch):
            state, met = fn(state, batch)
            port_moments.append((float(met["lr"]), moments_of(state["opt"])))
            return state, met
        return step
    monkeypatch.setattr(driver, "build_train_step", port_steps)
    monkeypatch.setattr(driver, "ThresholdMonitor",
                        _Recording(driver.ThresholdMonitor, port_ci))
    got = driver.main(args + ["--ckpt-dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    assert signal.getsignal(signal.SIGTERM) is keep_sigterm
    assert len(port_ci) == len(ref_ci) == 3
    np.testing.assert_allclose(port_ci, ref_ci, rtol=SCALARS)
    want = jax.tree.map(np.asarray, want)
    cfg = driver.smoke_overrides(get(arch))
    assert int(got["step"]) == int(want["step"]) == 3
    ref = {part: convert.params_from_jax(
        want["params"] if part == "params" else want["opt"][part], cfg)
        for part in ("params", "m", "v")}
    for part in ("m", "v"):
        assert got["opt"][part].keys() == ref[part].keys()
        for name, t in got["opt"][part].items():
            err = float((t - ref[part][name]).abs().max())
            assert err <= PARAMS * max(float(ref[part][name].abs().max()),
                                       1e-30), (part, name, err)
    params = dict(got["params"].named_parameters())
    assert params.keys() == ref["params"].keys()
    assert len(port_moments) == len(ref_moments) == 3
    trace = [(lr, mine, [convert.params_from_jax(t, cfg) for t in (m, v)])
             for (lr, mine), (_, m, v) in zip(port_moments, ref_moments)]
    for name, t in params.items():
        close_adamw_params(t, ref["params"][name].numpy(), [
            (lr, mine[name][0], rm[name].numpy(), mine[name][1],
             rv[name].numpy()) for lr, mine, (rm, rv) in trace], PARAMS,
            name)


def test_driver_resume_is_bitwise(tmp_path, capsys):
    """Four steps with a checkpoint every two; then the last checkpoint
    deleted and the run resumed from step 2: the same final state bit for
    bit."""
    args = ["--arch", "qwen3_0_6b", "--smoke", "--steps", "4",
            "--ckpt-every", "2", "--eval-every", "100", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    straight = driver.main(args)
    d = tmp_path / "qwen3_0_6b"
    assert ckpt.latest_step(d) == 4
    import shutil
    shutil.rmtree(d / "step_00000004")
    assert ckpt.latest_step(d) == 2
    resumed = driver.main(args + ["--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    _assert_states_equal(resumed, straight)
    assert ckpt.latest_step(d) == 4


def test_driver_eval_reports_an_interval(tmp_path, monkeypatch):
    """``--eval-every`` runs ``run_eval``: an ApproxEval certificate over
    the scrambled eval set, in batches of 16."""
    reports = []
    run_eval = driver.run_eval
    monkeypatch.setattr(driver, "run_eval",
                        lambda *a: reports.append(run_eval(*a)))
    driver.main(["--smoke", "--steps", "2", "--eval-every", "2",
                 "--ckpt-every", "100", "--device", "cpu", "--ckpt-dir",
                 str(tmp_path)])
    (rep,) = reports
    assert rep.lo <= rep.mean_estimate <= rep.hi
    assert rep.examples_used % driver.EVAL_BATCH == 0
    assert rep.total_examples == driver.EVAL_EXAMPLES


def test_sigterm_flushes_a_checkpoint_and_exits_0(tmp_path):
    """A SIGTERM to a running driver: the step in flight ends, a
    checkpoint is committed, the process exits with code 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "100000", "--ckpt-every", "100000",
         "--eval-every", "100000", "--ckpt-dir", str(tmp_path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 60
        line = ""
        while "step" not in line and time.monotonic() < deadline:
            line = p.stdout.readline()
            assert line or p.poll() is None, p.stderr.read()
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, err
    assert "preemption flush complete" in out
    step = ckpt.latest_step(tmp_path / "qwen3_0_6b")
    assert step is not None and step >= 1
    cfg = driver.smoke_overrides(get("qwen3_0_6b"))
    model = build(cfg)
    like = init_state(model, 0, OptConfig.for_arch(cfg), device="cpu")
    restored, meta = ckpt.restore_checkpoint(tmp_path / "qwen3_0_6b", step,
                                             like)
    assert int(restored["step"]) == step and meta["arch"] == "qwen3_0_6b"
