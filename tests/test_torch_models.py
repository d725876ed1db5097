"""The port's Mamba1 serving path on the CPU against the JAX package.

Configs carry over field for field; the reference's weights go through
``params_from_jax`` into the port's modules, and the same seeded numpy
inputs run through both packages: one Mamba1 block (``mamba1_apply`` on
both scan paths, ``mamba1_decode``) and the whole LM (``forward``,
``prefill``, ``decode``) of the reduced falcon-mamba-7b.

Tolerances, as ``max |port - ref| <= tol * max |ref|``:
  * float32: 1e-4 for logits, 1e-5 for a block's outputs and caches.
    Both packages compute the same float32 operations in the same order
    except for sums (matmuls, the norm's mean, the sum over the states),
    measured ~1e-6 relative;
  * bfloat16: 1.5e-2 for logits, measured 5.8e-3 (max abs 0.022 on logits
    of max 3.8): the two frameworks round bf16 matmul results after
    different accumulation orders, and 4 layers carry that forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_configs as jax_all_configs
from repro.configs import get as jax_get
from repro.models import build as jax_build
from repro.models import input_specs as jax_input_specs
from repro.models import make_batch as jax_make_batch
from repro.models import ssm as jax_ssm
from repro.models import window_for as jax_window_for
from repro_torch.configs import (ARCH_IDS, PORTED_ARCH_IDS, SHAPES,
                                 ArchConfig, all_configs, get, reduce_config)
from repro_torch.models import (build, convert, input_specs, make_batch,
                                window_for)
from repro_torch.models import ssm

F32_LOGITS, F32_BLOCK, BF16_LOGITS = 1e-4, 1e-5, 1.5e-2


def _close(got, want, tol, what=""):
    got = got.detach().to(torch.float32).numpy() \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= tol * scale, f"{what}: max abs {err} > {tol} * {scale}"


def _port_cfg(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def _reduced(dtype="float32", impl="pallas"):
    return dataclasses.replace(jax_get("falcon_mamba_7b", reduced=True),
                               param_dtype=dtype, compute_dtype=dtype,
                               ssm_impl=impl)


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", JAX_ARCH_IDS)
def test_config_schema_carries_over(arch_id):
    """Every reference config rebuilds as a port config from its fields,
    with the same derived sizes."""
    jcfg = jax_get(arch_id)
    cfg = _port_cfg(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for prop in ("vocab_padded", "attention_free", "d_inner", "ssm_heads"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.shapes() == jcfg.shapes()
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert dataclasses.asdict(reduce_config(cfg)) == dataclasses.asdict(
        jax_get(arch_id, reduced=True))


@pytest.mark.parametrize("reduced", [False, True])
def test_falcon_mamba_config_matches_reference(reduced):
    for alias in ("falcon_mamba_7b", "falcon-mamba-7b"):
        assert dataclasses.asdict(get(alias, reduced)) == dataclasses.asdict(
            jax_get(alias, reduced))
    assert ARCH_IDS == JAX_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch_id", PORTED_ARCH_IDS)
def test_config_matches_reference(arch_id):
    """Every id (and its dashed alias) gives the reference's config, full
    and reduced, and builds: the hybrid zamba2 and the enc-dec seamless
    among them."""
    for reduced in (False, True):
        for alias in (arch_id, arch_id.replace("_", "-")):
            assert dataclasses.asdict(get(alias, reduced)) == \
                dataclasses.asdict(jax_get(alias, reduced))
    assert build(get(arch_id)).cfg == get(arch_id)


@pytest.mark.parametrize("reduced", [False, True])
def test_all_configs_matches_reference(reduced):
    """``all_configs`` gives the reference's configs of all ten ids, in
    its order: every family is ported."""
    got, want = all_configs(reduced), jax_all_configs(reduced)
    assert list(got) == list(want) == list(JAX_ARCH_IDS)
    assert len(got) == 10 and PORTED_ARCH_IDS == ARCH_IDS
    for k, cfg in got.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want[k])


def test_get_of_unknown_arch_raises_key_error():
    with pytest.raises(KeyError):
        get("no_such_arch")


@pytest.mark.parametrize("shape", sorted(JAX_SHAPES))
def test_input_specs_and_make_batch_match_reference(shape):
    jcfg = _reduced()
    cfg = _port_cfg(jcfg)
    want = jax_input_specs(jcfg, JAX_SHAPES[shape])
    got = input_specs(cfg, SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert got[k].shape == s.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(s.dtype), k
    jb = jax_make_batch(jcfg, JAX_SHAPES[shape], seed=3)
    tb = make_batch(cfg, SHAPES[shape], seed=3, device="cpu")
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert window_for(cfg, SHAPES[shape].seq_len) == jax_window_for(
        jcfg, JAX_SHAPES[shape].seq_len)


# -- conversion ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips_every_leaf(dtype):
    """Every leaf lands in the module with its shape, dtype and bits
    (bf16 included; dt_bias, A_log and D stay float32 in a bf16 model),
    and comes back out equal."""
    jcfg = _reduced(dtype)
    cfg = _port_cfg(jcfg)
    jp = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(1)))
    lm = build(cfg).init(0, device="cpu")
    sd = convert.params_from_jax(jp, cfg)
    assert sorted(sd) == sorted(lm.state_dict())
    lm.load_state_dict(sd)
    params = dict(lm.named_parameters())
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in leaves:
        keys = [p.key for p in path]
        layers = range(cfg.n_layers) if keys[0] == "layers" else [None]
        for i in layers:
            name = ".".join(keys) if i is None else \
                ".".join(["layers", str(i)] + keys[1:])
            want = leaf if i is None else leaf[i]
            t = params[name]
            assert tuple(t.shape) == want.shape, name
            assert str(t.dtype).split(".")[-1] == want.dtype.name, name
            if t.dtype == torch.bfloat16:
                back = t.detach().view(torch.int16).numpy().view(
                    want.dtype)
            else:
                back = t.detach().numpy()
            np.testing.assert_array_equal(back.view(np.uint8),
                                          want.view(np.uint8), err_msg=name)
    assert sum(p.numel() for p in lm.parameters()) == sum(
        leaf.size for _, leaf in leaves)


# -- one Mamba1 block ---------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """Reduced falcon-mamba in float32 (d 128, din 256, n 16), one
    block's reference weights, in both packages."""
    jcfg = _reduced("float32", "xla")
    cfg = _port_cfg(jcfg)
    jp = jax_ssm.mamba1_init(jax.random.PRNGKey(0), jcfg)
    p = ssm.mamba1_init(cfg, torch.Generator().manual_seed(0))
    p.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                              cfg))
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("L", [64, 20])
def test_mamba1_apply_matches_reference(block, impl, L):
    jcfg, cfg, jp, p = block
    jcfg = dataclasses.replace(jcfg, ssm_impl=impl)
    cfg = dataclasses.replace(cfg, ssm_impl=impl)
    x = np.random.default_rng(L).normal(0, 1, (2, L, cfg.d_model)).astype(
        np.float32)
    want, wcache = jax_ssm.mamba1_apply(jp, jcfg, jnp.asarray(x),
                                        return_cache=True)
    with torch.inference_mode():
        got, cache = ssm.mamba1_apply(p, cfg, torch.from_numpy(x),
                                      return_cache=True)
        plain = ssm.mamba1_apply(p, cfg, torch.from_numpy(x))
    _close(got, want, F32_BLOCK, "out")
    assert torch.equal(plain, got)
    for k in ("conv", "h"):
        _close(cache[k], wcache[k], F32_BLOCK, k)


def test_mamba1_decode_matches_reference(block):
    jcfg, cfg, jp, p = block
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (3, 1, cfg.d_model)).astype(np.float32)
    jc = {"conv": jnp.asarray(rng.normal(0, 1, (3, 3, cfg.d_inner)),
                              jnp.float32),
          "h": jnp.asarray(rng.normal(0, 0.1, (3, cfg.d_inner, 16)),
                           jnp.float32)}
    want, wcache = jax_ssm.mamba1_decode(jp, jcfg, jnp.asarray(x), jc)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    with torch.inference_mode():
        got, cache = ssm.mamba1_decode(p, cfg, torch.from_numpy(x), tc)
    _close(got, want, F32_BLOCK, "out")
    for k in ("conv", "h"):
        _close(cache[k], wcache[k], F32_BLOCK, k)
    fresh = ssm.mamba1_cache(cfg, 3, torch.float32)
    jfresh = jax_ssm.mamba1_cache(jcfg, 3, jnp.float32)
    for k in fresh:
        assert tuple(fresh[k].shape) == jfresh[k].shape


# -- the whole LM -------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm_pair(request):
    """The reduced falcon-mamba LM (4 layers, vocab 512) in both packages
    on the reference's weights, ``ssm_impl="pallas"`` (the reference's
    Pallas scan runs in interpret mode on the CPU)."""
    jcfg = _reduced(request.param, "pallas")
    cfg = _port_cfg(jcfg)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build(cfg)
    lm = m.init(0, device="cpu")
    lm.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                               cfg))
    tol = F32_LOGITS if request.param == "float32" else BF16_LOGITS
    return jm, jp, m, lm, tol


def test_lm_forward_prefill_decode_match_reference(lm_pair):
    jm, jp, m, lm, tol = lm_pair
    B, T = 2, 32
    toks = np.random.default_rng(0).integers(0, 512, (B, T)).astype(np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, aux = m.forward(lm, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, tol, "forward")
    wl, wc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :T - 1])})
    gl, gc = m.prefill(lm, {"tokens": torch.from_numpy(toks[:, :T - 1])})
    _close(gl, wl, tol, "prefill")
    for k in ("conv", "h"):
        assert tuple(gc["layers"][k].shape) == wc["layers"][k].shape
    _close(gc["layers"]["h"], wc["layers"]["h"], tol, "cache h")
    wd, _ = jm.decode(jp, wc, {"token": jnp.asarray(toks[:, T - 1:]),
                               "pos": jnp.asarray(T - 1, jnp.int32)})
    gd, gc2 = m.decode(lm, gc, {"token": torch.from_numpy(toks[:, T - 1:]),
                                "pos": T - 1})
    _close(gd, wd, tol, "decode")
    assert {k: v.shape for k, v in gc2["layers"].items()} == \
        {k: v.shape for k, v in gc["layers"].items()}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_then_decode_matches_forward(impl):
    """The contract of tests/test_models_smoke.py on the port alone:
    prefill(T-1 tokens) + decode(token T-1) reproduces the forward logits
    at positions T-2 and T-1, within 2e-3; init_cache has the prefill
    cache's structure."""
    cfg = dataclasses.replace(get("falcon_mamba_7b", reduced=True),
                              ssm_impl=impl)
    m = build(cfg)
    lm = m.init(7, device="cpu")
    B, T = 2, 32
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (B, T)))
    with torch.inference_mode():
        full, _ = m.forward(lm, {"tokens": toks})
    logits_p, cache = m.prefill(lm, {"tokens": toks[:, :T - 1]})
    assert logits_p.shape == (B, 1, cfg.vocab_padded)
    np.testing.assert_allclose(logits_p[:, -1].float().numpy(),
                               full[:, T - 2].float().numpy(), rtol=2e-3,
                               atol=2e-3)
    empty = m.init_cache(B, T, device="cpu")
    for k in ("conv", "h"):
        assert empty["layers"][k].shape == cache["layers"][k].shape
        assert empty["layers"][k].dtype == cache["layers"][k].dtype
    dec, _ = m.decode(lm, cache, {"token": toks[:, T - 1:], "pos": T - 1})
    np.testing.assert_allclose(dec[:, 0].float().numpy(),
                               full[:, T - 1].float().numpy(), rtol=2e-3,
                               atol=2e-3)
    assert torch.isfinite(dec).all()


@pytest.mark.parametrize("tie", [False, True])
def test_float32_head_copy_follows_the_weights(tie):
    """The float32 copy of a bf16 head that the logits reuse is made again
    when ``load_state_dict`` changes the head: the logits are then bit for
    bit those of a module built with those weights. With gradients on,
    the logits still reach the head."""
    cfg = dataclasses.replace(get("falcon_mamba_7b", reduced=True),
                              tie_embeddings=tie)
    assert cfg.param_dtype == "bfloat16"
    m = build(cfg)
    lm, other = m.init(0, device="cpu"), m.init(1, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)))
    first, _ = m.prefill(lm, {"tokens": toks})
    lm.load_state_dict(other.state_dict())
    got, _ = m.prefill(lm, {"tokens": toks})
    want, _ = m.prefill(other, {"tokens": toks})
    assert torch.equal(got, want) and not torch.equal(got, first)
    full, _ = m.forward(lm, {"tokens": toks})
    full[:, -1, 0].sum().backward()
    head = lm.embed if tie else lm.lm_head
    assert head.grad is not None and head.grad.abs().sum() > 0
