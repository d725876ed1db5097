"""The CI machinery's other consumers in the port, on the CPU against the
JAX package: the paper's Table 2 as probes (``core.pathologies``), the
straggler and threshold monitors, the scrambled eval set and
``ApproxEval`` (the paper's AVG query over the per-token losses a model
produces).

Tolerances:
  * fed the same float64 per-token losses, the port's ``ApproxEval`` runs
    the reference's host arithmetic: every count, decision and flag
    equal, endpoints within 1e-9;
  * over the reduced falcon-mamba-7b in float32 (the reference's weights
    carried across), the per-token losses differ by the models' float32
    sums (``tests/test_torch_models.py``: 1e-4 of the logits), so the
    reports keep equal rounds and examples and endpoints within 1e-4
    relative;
  * the monitors fed float32 moment states of the same samples (each
    package folds them itself) decide alike at every update; their
    intervals agree within 1e-6 relative (float32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.core import get_bounder as jax_get_bounder
from repro.core.pathologies import exhibits_phos as jax_exhibits_phos
from repro.core.pathologies import exhibits_pma as jax_exhibits_pma
from repro.core.state import moments_of_batch as jax_moments_of_batch
from repro.data import tokens as jax_tokens
from repro.distributed.straggler import StragglerMonitor as JaxStraggler
from repro.evalx import ApproxEval as JaxApproxEval
from repro.evalx import ThresholdMonitor as JaxThresholdMonitor
from repro.models import build as jax_build

from repro_torch.configs import ArchConfig
from repro_torch.core import get_bounder
from repro_torch.core.pathologies import exhibits_phos, exhibits_pma
from repro_torch.core.state import moments_of_batch
from repro_torch.data import tokens
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.evalx import ApproxEval, EvalReport, ThresholdMonitor
from repro_torch.models import build, convert

from tests.helpers.torch_parity import one_torch_thread  # noqa: F401

REPORT_EXACT = ("tokens_used", "examples_used", "total_examples", "rounds",
                "stopped_early", "clip_fraction", "loss_clip")
REPORT_CI = ("mean_estimate", "lo", "hi")


# -- Table 2 -------------------------------------------------------------------

# Paper Table 2: (bounder, RangeTrim, PMA, PHOS), as
# tests/test_pathologies_derived.py holds the reference to it
TABLE2 = [
    ("hoeffding", False, True, True),
    ("hoeffding_serfling", False, True, True),
    ("bernstein", False, False, True),
    ("anderson_dkw", False, True, False),
    ("hoeffding_serfling", True, True, False),   # +RT fixes PHOS only
    ("bernstein", True, False, False),           # the paper's answer to Pb. 1
]


@pytest.mark.parametrize("name,rt,pma,phos", TABLE2)
def test_table2_pathologies(name, rt, pma, phos):
    b = get_bounder(name, rangetrim=rt)
    assert exhibits_pma(b) == pma, f"{b.name}: PMA mismatch"
    assert exhibits_phos(b) == phos, f"{b.name}: PHOS mismatch"
    assert b.has_pma == pma and b.has_phos == phos
    jb = jax_get_bounder(name, rangetrim=rt)
    assert (exhibits_pma(b), exhibits_phos(b)) == (jax_exhibits_pma(jb),
                                                   jax_exhibits_phos(jb))


# -- monitors ------------------------------------------------------------------


def _straggler_streams(seed, slow_host):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        if slow_host is None:
            yield rng.normal(1.0, 0.1, size=4).clip(0.1, 3.0)
            continue
        times = rng.normal(1.0, 0.05, size=4).clip(0.5, 2.0)
        times[slow_host] = rng.normal(3.0, 0.1)
        yield times


@pytest.mark.parametrize("seed,slow_host,flagged", [(0, 2, [2]),
                                                     (1, None, [])])
def test_straggler_monitor_matches_reference(seed, slow_host, flagged):
    """The reference's two streams (a host 3x slower, then none): the
    same flags after every step, the same intervals at the end."""
    mon = StragglerMonitor(n_hosts=4, factor=1.5, delta=1e-6)
    ref = JaxStraggler(n_hosts=4, factor=1.5, delta=1e-6)
    for i, times in enumerate(_straggler_streams(seed, slow_host)):
        mon.record(times)
        ref.record(times)
        if i % 10 == 9 or i < 10:
            assert mon.flagged() == ref.flagged(), i
    assert mon.flagged() == flagged
    assert mon.healthy_quorum() == [h for h in range(4) if h not in flagged]
    np.testing.assert_allclose(mon.intervals(), ref.intervals(),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("mean,fires", [(7.0, True), (2.0, False),
                                        (5.0, None)])
def test_threshold_monitor_matches_reference(mean, fires):
    """Seeded streams of 256 values a step (the reference test's mean 7
    and 2 around a threshold of 5, and one that sits on it): the port's
    and the reference's monitors, each fed its own float32 moments of the
    same values, decide alike at every update."""
    kw = dict(threshold=5.0, value_range=(0.0, 10.0), delta=1e-6,
              direction="above")
    mon, ref = ThresholdMonitor(**kw), JaxThresholdMonitor(**kw)
    rng = np.random.default_rng(2)
    decisions = []
    for _ in range(30):
        vals = rng.normal(mean, 0.5, 256).clip(0, 10)
        got = mon.update(moments_of_batch(torch.from_numpy(vals)))
        want = ref.update(jax_moments_of_batch(jnp.asarray(vals)))
        assert got is want or got == want, (len(decisions), got, want)
        decisions.append(got)
    assert decisions[-1] is fires or decisions[-1] == fires
    lo, hi = mon.interval()
    assert lo <= float(mon._state.mean) <= hi
    if fires is not None:
        assert decisions.index(fires) < 3


def test_threshold_monitor_host_and_tensor_states_agree():
    """A MomentState of tensors and its float64 numpy copy merge alike."""
    rng = np.random.default_rng(3)
    a = ThresholdMonitor(threshold=1.0, value_range=(0.0, 4.0))
    b = ThresholdMonitor(threshold=1.0, value_range=(0.0, 4.0))
    for _ in range(5):
        st = moments_of_batch(torch.from_numpy(rng.uniform(0, 4, 64)))
        assert a.update(st) == b.update(
            type(st)(*(f.numpy().astype(np.float64) for f in st)))
    assert a.interval() == b.interval()


# -- the scrambled eval set ----------------------------------------------------


@pytest.mark.parametrize("n,seq,seed,bs", [(48, 16, 1234, 8),
                                           (37, 33, 7, 5)])
def test_eval_scramble_bitwise_reference(n, seq, seed, bs):
    jcfg = jax_get("falcon_mamba_7b", reduced=True)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    got = tokens.make_eval_scramble(cfg, n, seq, seed=seed)
    want = jax_tokens.make_eval_scramble(jcfg, n, seq, seed=seed)
    assert got.n_examples == want.n_examples == n
    assert got.tokens.dtype == want.tokens.dtype
    np.testing.assert_array_equal(got.tokens, want.tokens)
    gb, wb = list(got.batches(bs)), list(want.batches(bs))
    assert len(gb) == len(wb) == n // bs
    for g, w in zip(gb, wb):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


# -- ApproxEval on given losses ------------------------------------------------


def _loss_stream(seed, n_batches, bsz, seq, vocab):
    """Per-token losses around ln V with a heavy upper tail (some above
    the 2 ln V clip, some negative) and a mask with holes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        l = rng.gamma(4.0, np.log(vocab) / 4.0, (bsz, seq))
        l[rng.random((bsz, seq)) < 0.01] *= 4.0
        l[rng.random((bsz, seq)) < 0.005] = -0.5
        m = rng.random((bsz, seq)) > 0.1
        out.append((l.astype(np.float32), m))
    return out


def _assert_reports_match(got: EvalReport, want, ci_tol, ci_rel=0.0):
    for f in REPORT_EXACT:
        assert getattr(got, f) == getattr(want, f), (f, getattr(got, f),
                                                     getattr(want, f))
    for f in REPORT_CI:
        g, w = getattr(got, f), getattr(want, f)
        assert abs(g - w) <= ci_tol + ci_rel * abs(w), (f, g, w)


@pytest.mark.parametrize("stop", [dict(target_width=0.5),
                                  dict(target_rel=0.05),
                                  dict(target_width=1e-6)])
@pytest.mark.parametrize("vocab", [512, 65024])
def test_approx_eval_on_given_losses_matches_reference(stop, vocab):
    """The same seeded float32 per-token losses (some clipped) through the
    port (as tensors) and the reference (as numpy): every report field
    equal, endpoints within 1e-9. ``target_width=1e-6`` never stops
    early: the whole set is used."""
    bsz, seq = 8, 128
    stream = _loss_stream(vocab, 60, bsz, seq, vocab)
    batches = [{"tokens": np.zeros((bsz, seq), np.int32), "i": i}
               for i in range(len(stream))]

    def port_fn(b):
        l, m = stream[b["i"]]
        return torch.from_numpy(l), torch.from_numpy(m)

    ev = ApproxEval(port_fn, vocab=vocab, delta=1e-6)
    ref = JaxApproxEval(lambda b: stream[b["i"]], vocab=vocab, delta=1e-6)
    got = ev.run(iter(batches), len(batches) * bsz, **stop)
    want = ref.run(iter(batches), len(batches) * bsz, **stop)
    _assert_reports_match(got, want, 1e-9)
    assert got.clip_fraction > 0
    assert got.stopped_early == (stop.get("target_width") != 1e-6)


# -- ApproxEval over the reduced falcon-mamba-7b --------------------------------


def _reduced_jcfg():
    return dataclasses.replace(jax_get("falcon_mamba_7b", reduced=True),
                               param_dtype="float32",
                               compute_dtype="float32", ssm_impl="xla")


def port_loss_fn(model, lm):
    """The per-token loss of ``tests/test_train_stack.py``'s eval in the
    port: logsumexp minus the picked logit, ``targets >= 0`` the mask."""

    @torch.inference_mode()
    def loss_fn(batch):
        toks = torch.from_numpy(batch["tokens"])
        targets = torch.from_numpy(batch["targets"])
        logits, _ = model.forward(lm, {"tokens": toks})
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              targets.clamp(min=0).long()[..., None])[..., 0]
        return logz - picked, targets >= 0

    return loss_fn


@pytest.fixture(scope="module")
def eval_pair():
    """The reduced falcon-mamba-7b (4 layers, d_model 128, vocab 512) in
    float32 in both packages, on the reference's weights."""
    jcfg = _reduced_jcfg()
    # the port on its kernel's path (the plain scan on the CPU), the
    # reference on its XLA scan (its Pallas one is interpret mode here)
    cfg = dataclasses.replace(ArchConfig(**dataclasses.asdict(jcfg)),
                              ssm_impl="pallas")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build(cfg)
    lm = m.init(0, device="cpu")
    lm.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                               cfg))

    @jax.jit
    def jloss(batch):
        logits, _ = jm.forward(jp, batch)
        targets = batch["targets"]
        logz = jax.nn.logsumexp(logits, axis=-1)
        picked = jnp.take_along_axis(
            logits, jnp.clip(targets, 0)[..., None], axis=-1)[..., 0]
        return logz - picked, targets >= 0

    ref_fn = lambda b: jloss({k: jnp.asarray(v) for k, v in b.items()})
    return cfg, m, lm, port_loss_fn(m, lm), ref_fn


def test_approx_eval_model_matches_reference(eval_pair):
    """ApproxEval of the port's model against the reference's over its
    own (same weights, same scramble): the same rounds and examples,
    endpoints within 1e-4 relative."""
    cfg, m, lm, port_fn, ref_fn = eval_pair
    sc = tokens.make_eval_scramble(cfg, n_examples=256, seq_len=32)
    got = ApproxEval(port_fn, vocab=cfg.vocab_padded, delta=1e-6).run(
        sc.batches(16), sc.n_examples, target_width=0.5)
    want = JaxApproxEval(ref_fn, vocab=cfg.vocab_padded, delta=1e-6).run(
        sc.batches(16), sc.n_examples, target_width=0.5)
    for f in ("rounds", "examples_used", "tokens_used", "stopped_early",
              "loss_clip", "total_examples"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.stopped_early and got.rounds > 1
    for f in REPORT_CI:
        g, w = getattr(got, f), getattr(want, f)
        assert abs(g - w) <= 1e-4 * abs(w), (f, g, w)


def test_approx_eval_early_stop_and_coverage(eval_pair):
    """``tests/test_train_stack.py``'s early-stop and coverage test on the
    port alone: the certificate is narrower than 0.5, stops before the
    set's end and covers the full-set mean clipped loss."""
    cfg, m, lm, port_fn, _ = eval_pair
    sc = tokens.make_eval_scramble(cfg, n_examples=2048, seq_len=32)
    ev = ApproxEval(port_fn, vocab=cfg.vocab_padded, delta=1e-6)
    rep = ev.run(sc.batches(batch_size=32), sc.n_examples, target_width=0.5)
    assert rep.lo <= rep.mean_estimate <= rep.hi
    assert rep.hi - rep.lo < 0.5
    assert rep.stopped_early
    assert rep.examples_used < sc.n_examples
    total, count = 0.0, 0
    for b in sc.batches(batch_size=256):
        l, msk = port_fn(b)
        vals = np.clip(l.numpy().astype(np.float64)[msk.numpy()], 0.0,
                       ev.loss_clip)
        total += vals.sum()
        count += vals.size
    true_mean = total / count
    assert rep.lo - 1e-6 <= true_mean <= rep.hi + 1e-6
