"""The port's hybrid (zamba2) and enc-dec (seamless-m4t) families on the
CPU against the JAX package.

Configs carry over field for field; the reference's weights go through
``params_from_jax`` into the port's modules, and the same seeded numpy
inputs run through both packages: the Mamba2 / SSD block
(``mamba2_apply`` with and without its cache, over several chunks and
under one, ``mamba2_decode``, ``mamba2_cache``, ``_gated_rmsnorm``), and
the reduced zamba2-7b (7 layers: two groups of 3 and one tail layer) and
seamless-m4t-large-v2 (2 + 2 layers) through ``forward``, ``prefill``
(every cache leaf), ``decode`` and ``loss`` with its gradient. Then the
hybrid's ring-buffer attention cache: equal to the reference below the
wrap, equal to the port's own full-cache windowed decode past it, where
the reference's is not.

Tolerances, as ``max |port - ref| <= tol * max |ref|``:
  * float32 logits, block outputs and caches: 1e-5. Both packages
    compute the same float32 operations in the same order except for
    sums (matmuls, the norms, the SSD einsums and cumsum), a few ulps
    apart (measured 3e-6 on the reduced zamba2's logits);
  * float32 gradients: 1e-4 per parameter;
  * bfloat16: 1.5e-2, the precedent of ``test_torch_models.py`` (the two
    frameworks round bf16 matmul results after different accumulation
    orders);
  * the port against itself (prefill + decode against forward, the ring
    against the full cache, chunked against step by step): 2e-3 absolute
    and relative, ``tests/test_models_smoke.py``'s contract.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get as jax_get
from repro.models import build as jax_build
from repro.models import input_specs as jax_input_specs
from repro.models import make_batch as jax_make_batch
from repro.models import ssm as jax_ssm
from repro_torch.configs import SHAPES, ArchConfig
from repro_torch.models import build, convert, input_specs, make_batch, ssm
from repro_torch.models import encdec, lm as lm_mod
from tests.helpers.torch_parity import one_torch_thread  # noqa: F401

F32, F32_GRAD, BF16, SELF = 1e-5, 1e-4, 1.5e-2, 2e-3
IDS = ("zamba2_7b", "seamless_m4t_large_v2")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= tol * scale, f"{what}: max abs {err} > {tol} * {scale}"


def _self_close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=SELF, atol=SELF,
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch_id, dtype="float32", **kw):
    jcfg = dataclasses.replace(jax_get(arch_id, reduced=True),
                               param_dtype=dtype, compute_dtype=dtype, **kw)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


def _load(module, jparams, cfg):
    module.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg))
    return module


# -- the Mamba2 / SSD block ---------------------------------------------------


def _block_pair(dtype="float32"):
    jcfg, cfg = _cfgs("zamba2_7b", dtype)
    jp = jax_ssm.mamba2_init(jax.random.PRNGKey(1), jcfg)
    # non-zero conv biases, D and norm scale, so that each is exercised
    rng = np.random.default_rng(2)
    jp = {k: (v + jnp.asarray(rng.normal(0, 0.1, v.shape), v.dtype)
              if k in ("conv_x_b", "conv_B_b", "conv_C_b", "D",
                       "norm_scale") else v)
          for k, v in jp.items()}
    p = _load(ssm.mamba2_init(cfg, torch.Generator().manual_seed(0)), jp,
              cfg)
    return jcfg, cfg, jp, p


def test_mamba2_block_has_the_reference_leaves():
    """Names, shapes and dtypes of ``mamba2_init``'s dict; ``A_log``,
    ``D`` and ``dt_bias`` float32 in a bf16 block."""
    jcfg, cfg = _cfgs("zamba2_7b", "bfloat16")
    jp = jax_ssm.mamba2_init(jax.random.PRNGKey(0), jcfg)
    p = ssm.mamba2_init(cfg, torch.Generator().manual_seed(0))
    got = {n: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for n, t in p.state_dict().items()}
    assert got == {k: (v.shape, str(v.dtype)) for k, v in jp.items()}
    _close(p.A_log, jp["A_log"], 1e-7, "A_log")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [96, 20])
@pytest.mark.parametrize("return_cache", [False, True])
def test_mamba2_apply_matches_reference(dtype, L, return_cache):
    """Three chunks of 32 (the state carried twice) and one chunk shorter
    than ``ssm_chunk``; with the cache, every leaf (conv tails in the
    compute dtype, the state in float32)."""
    jcfg, cfg, jp, p = _block_pair(dtype)
    x = np.random.default_rng(3).normal(0, 1, (2, L, cfg.d_model)).astype(
        np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_ssm.mamba2_apply(jp, jcfg, jnp.asarray(x, jdt),
                                return_cache=return_cache)
    with torch.no_grad():
        got = ssm.mamba2_apply(p, cfg, _t(x).to(tdt),
                               return_cache=return_cache)
    tol = F32 if dtype == "float32" else BF16
    if not return_cache:
        got, want = (got, {}), (want, {})
    _close(got[0], want[0], tol, "out")
    assert got[0].dtype == tdt
    assert sorted(got[1]) == sorted(want[1])
    for k, w in want[1].items():
        assert str(got[1][k].dtype).split(".")[-1] == str(w.dtype), k
        _close(got[1][k], w, tol, k)
        assert got[1][k]._base is None, f"{k} is a view"


def test_mamba2_apply_rejects_a_ragged_chunk():
    _, cfg, _, p = _block_pair()
    with pytest.raises(ValueError, match="chunk 32"):
        ssm.mamba2_apply(p, cfg, torch.zeros((1, 40, cfg.d_model)))


def _random_cache(cfg, B, dtype, seed):
    rng = np.random.default_rng(seed)
    cache = ssm.mamba2_cache(cfg, B, dtype)
    return {k: torch.from_numpy(rng.normal(0, 0.5, tuple(v.shape)).astype(
        np.float32)).to(v.dtype) for k, v in cache.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_reference(dtype):
    """One step from a random cache: output and every new cache leaf;
    the input cache is left as it was."""
    jcfg, cfg, jp, p = _block_pair(dtype)
    tdt = getattr(torch, dtype)
    cache = _random_cache(cfg, 2, tdt, 4)
    before = {k: v.clone() for k, v in cache.items()}
    x = np.random.default_rng(5).normal(0, 1, (2, 1, cfg.d_model)).astype(
        np.float32)
    want, wc = jax_ssm.mamba2_decode(
        jp, jcfg, jnp.asarray(x, getattr(jnp, dtype)),
        {k: jnp.asarray(_np(v), getattr(jnp, str(v.dtype).split(".")[-1]))
         for k, v in cache.items()})
    with torch.no_grad():
        got, gc = ssm.mamba2_decode(p, cfg, _t(x).to(tdt), cache)
    tol = F32 if dtype == "float32" else BF16
    _close(got, want, tol, "out")
    for k in wc:
        assert gc[k].dtype == cache[k].dtype, k
        _close(gc[k], wc[k], tol, k)
        assert torch.equal(cache[k], before[k])


def test_mamba2_cache_matches_reference():
    jcfg, cfg = _cfgs("zamba2_7b", "bfloat16")
    want = jax_ssm.mamba2_cache(jcfg, 3, jnp.bfloat16)
    got = ssm.mamba2_cache(cfg, 3, torch.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == {k: (v.shape, str(v.dtype))
                                         for k, v in want.items()}
    assert all(not v.any() for v in got.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm_matches_reference(dtype):
    """eps 1e-5 over the whole of d_inner; ``z`` and the scale in the
    param dtype, ``y`` and the result float32."""
    rng = np.random.default_rng(6)
    y = rng.normal(0, 2, (2, 5, 256)).astype(np.float32)
    z = rng.normal(0, 2, (2, 5, 256)).astype(np.float32)
    scale = rng.normal(1, 0.1, 256).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_ssm._gated_rmsnorm(jnp.asarray(y), jnp.asarray(z, jdt),
                                  jnp.asarray(scale, jdt))
    got = ssm._gated_rmsnorm(_t(y), _t(z).to(tdt), _t(scale).to(tdt))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6, "gated rmsnorm")


def test_mamba2_chunked_equals_step_by_step():
    """The port of ``test_mamba2_ssd_vs_naive``: the chunked SSD over 64
    steps (two chunks) equals 64 decode steps from an empty cache, and
    its cache equals theirs."""
    _, cfg, _, p = _block_pair()
    x = _t(np.random.default_rng(7).normal(0, 1, (1, 64, cfg.d_model))
           .astype(np.float32))
    with torch.no_grad():
        y, cache = ssm.mamba2_apply(p, cfg, x, return_cache=True)
        step = ssm.mamba2_cache(cfg, 1, torch.float32)
        ys = []
        for t in range(64):
            yt, step = ssm.mamba2_decode(p, cfg, x[:, t:t + 1], step)
            ys.append(yt)
    _self_close(y, torch.cat(ys, dim=1), "y")
    for k in cache:
        _self_close(cache[k], step[k], k)


def test_mamba2_gradient_is_finite_and_matches_reference():
    """The masked exponent keeps the SSD's gradient finite (``exp`` of a
    large positive above-diagonal difference would be ``inf`` and its
    ``0 * inf`` NaN); input and parameter gradients against ``jax.grad``
    within 1e-4."""
    jcfg, cfg, jp, p = _block_pair()
    x = np.random.default_rng(8).normal(0, 1, (2, 64, cfg.d_model)).astype(
        np.float32)

    def jloss(params, xx):
        return jnp.sum(jax_ssm.mamba2_apply(params, jcfg, xx) ** 2)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    ssm.mamba2_apply(p, cfg, xt).square().sum().backward()
    _close(xt.grad, jgx, F32_GRAD, "dx")
    for name, g in p.named_parameters():
        assert torch.isfinite(g.grad).all(), name
        _close(g.grad, jg[name], F32_GRAD, f"grad {name}")


# -- the two reduced models ---------------------------------------------------

SMOKE_SHAPE = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                  global_batch=2)
JAX_SMOKE = dataclasses.replace(JAX_SHAPES["train_4k"], seq_len=64,
                                global_batch=2)
DECODE_SHAPE = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                   global_batch=2)
JAX_DECODE = dataclasses.replace(JAX_SHAPES["decode_32k"], seq_len=64,
                                 global_batch=2)


def _pair(arch_id, dtype="float32", **kw):
    jcfg, cfg = _cfgs(arch_id, dtype, **kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build(cfg)
    module = _load(m.init(0, device="cpu"), jp, cfg)
    return jcfg, jm, jp, cfg, m, module


@pytest.fixture(scope="module")
def f32_pair():
    """The float32 pair of an id, built once a module (the tests leave
    its weights as they were)."""
    built = {}

    def get(arch_id):
        if arch_id not in built:
            built[arch_id] = _pair(arch_id)
        return built[arch_id]
    return get


def _jbatch(batch):
    return {k: jnp.asarray(_np(v) if v.is_floating_point() else v.numpy())
            for k, v in batch.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _splice(cache, model, B, S):
    """The hybrid's prefill cache in one with ``S`` attention slots (room
    to decode); the Mamba2 states as they are."""
    room = model.init_cache(B, S, device="cpu")
    T = cache["attn"]["k"].shape[2]
    for k in ("k", "v"):
        room["attn"][k][:, :, :T] = cache["attn"][k]
    return {**cache, "attn": room["attn"]}


def _jsplice(cache, model, B, S):
    room = model.init_cache(B, S)
    T = cache["attn"]["k"].shape[2]
    return {**cache, "attn": {k: room["attn"][k].at[:, :, :T].set(
        cache["attn"][k]) for k in ("k", "v")}}


def test_module_layout_matches_reference(f32_pair):
    """zamba2: ``layers`` as 2 groups of 3, one tail layer, the shared
    block; seamless: ``enc_layers`` and ``dec_layers``. Every leaf
    round-trips."""
    for arch_id in IDS:
        jcfg, jm, jp, cfg, m, module = f32_pair(arch_id)
        want = dict(_leaves(jax.tree.map(np.asarray, jp)))
        sd = module.state_dict()
        assert sum(t.numel() for t in sd.values()) == sum(
            v.size for v in want.values())
        if cfg.family == "hybrid":
            assert isinstance(module, lm_mod.LM)
            assert (len(module.layers), len(module.layers[0]),
                    len(module.tail_layers)) == (2, 3, 1)
            np.testing.assert_array_equal(
                sd["layers.1.2.mamba.in_x"].numpy(),
                want["layers.mamba.in_x"][1, 2])
            np.testing.assert_array_equal(sd["tail_layers.0.ln.scale"],
                                          want["tail_layers.ln.scale"][0])
            np.testing.assert_array_equal(sd["shared.in_proj"],
                                          want["shared.in_proj"])
        else:
            assert isinstance(module, encdec.EncDec)
            np.testing.assert_array_equal(
                sd["dec_layers.1.cross_attn.wk"].numpy(),
                want["dec_layers.cross_attn.wk"][1])
            np.testing.assert_array_equal(sd["enc_layers.0.ln1.bias"],
                                          want["enc_layers.ln1.bias"][0])


def test_params_from_jax_rejects_a_wrong_depth(f32_pair):
    """A stacked leaf whose leading axes are not the config's raises."""
    for arch_id, layers in (("zamba2_7b", 6), ("seamless_m4t_large_v2", 3)):
        jcfg, jm, jp, cfg, m, module = f32_pair(arch_id)
        tree = jax.tree.map(np.asarray, jp)
        with pytest.raises(ValueError, match="leading axes"):
            convert.params_from_jax(tree, dataclasses.replace(
                cfg, n_layers=layers))


def _inputs(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, T)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.from_numpy(
            rng.normal(0, 0.02, (B, T, cfg.d_model)).astype(np.float32))
    return batch


def test_hybrid_forward_prefill_decode_match_reference(f32_pair):
    """float32: forward logits, prefill logits (31 tokens) and every
    cache leaf (attention KV per group, the Mamba2 states per group and
    layer, the tail's), a decode step after the prefill at an int
    position, and a
    decode step of ``make_batch``'s decode batch (a 0-d tensor position)
    against a zero cache."""
    jcfg, jm, jp, cfg, m, module = f32_pair("zamba2_7b")
    batch = make_batch(cfg, SMOKE_SHAPE, seed=1, device="cpu")
    jb = jax_make_batch(jcfg, JAX_SMOKE, seed=1)
    want, _ = jm.forward(jp, jb)
    with torch.no_grad():
        got, aux = m.forward(module, batch)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, F32, "forward")

    # a prefill length must divide by min(ssm_chunk, length): 31 of 32
    T = cfg.ssm_chunk
    pre = {"tokens": batch["tokens"][:, :T - 1]}
    wl, wc = jm.prefill(jp, _jbatch(pre))
    gl, gc = m.prefill(module, pre)
    _close(gl, wl, F32, "prefill")
    want_leaves, got_leaves = dict(_leaves(wc)), dict(_leaves(gc))
    assert sorted(got_leaves) == sorted(want_leaves) == [
        "attn.k", "attn.v", "mamba.conv_B", "mamba.conv_C", "mamba.conv_x",
        "mamba.h", "tail.conv_B", "tail.conv_C", "tail.conv_x", "tail.h"]
    for k, w in want_leaves.items():
        _close(got_leaves[k], w, F32, f"cache {k}")
    assert gc["mamba"]["h"].shape[:2] == (2, 3)
    assert gc["mamba"]["h"].dtype == torch.float32

    B, S = 2, T
    step = {"token": batch["tokens"][:, T - 1:T]}
    wd, wdc = jm.decode(jp, _jsplice(wc, jm, B, S),
                        {**_jbatch(step), "pos": jnp.asarray(T - 1,
                                                             jnp.int32)})
    gd, gdc = m.decode(module, _splice(gc, m, B, S), {**step, "pos": T - 1})
    _close(gd, wd, F32, "decode")
    for k, w in _leaves(wdc):
        _close(dict(_leaves(gdc))[k], w, F32, f"decode {k}")

    db = make_batch(cfg, DECODE_SHAPE, seed=3, device="cpu")
    assert db["pos"].ndim == 0 and int(db["pos"]) == 32
    wd, _ = jm.decode(jp, jm.init_cache(2, 64),
                      jax_make_batch(jcfg, JAX_DECODE, seed=3))
    gd, _ = m.decode(module, m.init_cache(2, 64, device="cpu"), db)
    _close(gd, wd, F32, "decode (tensor pos)")


def test_encdec_forward_prefill_decode_match_reference(f32_pair):
    """float32: forward logits; prefill's last-position logits (the head
    on that position alone) and its memory; a decode step from the
    prefill's memory at position 0, and one of ``make_batch``'s decode
    batch (a tensor position, its own memory) against a zero cache."""
    jcfg, jm, jp, cfg, m, module = f32_pair("seamless_m4t_large_v2")
    batch = make_batch(cfg, SMOKE_SHAPE, seed=1, device="cpu")
    jb = jax_make_batch(jcfg, JAX_SMOKE, seed=1)
    assert sorted(batch) == ["frame_embeds", "targets", "tokens"]
    want, waux = jm.forward(jp, jb)
    with torch.no_grad():
        got, aux = m.forward(module, batch)
    assert got.dtype == torch.float32 and float(aux) == float(waux) == 0.0
    _close(got, want, F32, "forward")

    pre = {k: batch[k] for k in ("frame_embeds", "tokens")}
    wl, wc = jm.prefill(jp, _jbatch(pre))
    gl, gc = m.prefill(module, pre)
    assert list(gc) == ["memory"]
    _close(gl, wl, F32, "prefill")
    _close(gc["memory"], wc["memory"], F32, "memory")

    step = {"token": batch["tokens"][:, :1], "pos": 0}
    wd, wdc = jm.decode(jp, jm.init_cache(2, 8),
                        {"token": jnp.asarray(step["token"].numpy()),
                         "pos": jnp.asarray(0, jnp.int32),
                         "memory": wc["memory"]})
    gd, gdc = m.decode(module, m.init_cache(2, 8, device="cpu"),
                       {**step, "memory": gc["memory"]})
    _close(gd, wd, F32, "decode")
    for k in ("k", "v"):
        _close(gdc["self"][k], wdc["self"][k], F32, f"decode {k}")

    db = make_batch(cfg, DECODE_SHAPE, seed=3, device="cpu")
    assert db["memory"].shape == (2, cfg.decode_memory_len, cfg.d_model)
    wd, _ = jm.decode(jp, jm.init_cache(2, 64),
                      jax_make_batch(jcfg, JAX_DECODE, seed=3))
    gd, _ = m.decode(module, m.init_cache(2, 64, device="cpu"), db)
    _close(gd, wd, F32, "decode (tensor pos)")


@pytest.mark.parametrize("arch_id", IDS)
def test_loss_and_gradient_match_reference(arch_id, f32_pair):
    """``Model.loss`` (with remat, as the reduced configs have it) and
    its gradient against ``jax.grad`` of the reference's, every
    parameter within 1e-4 of its largest reference magnitude; one SGD
    step moves the loss."""
    jcfg, jm, jp, cfg, m, module = f32_pair(arch_id)
    assert cfg.remat
    batch = make_batch(cfg, SMOKE_SHAPE, seed=1, device="cpu")
    jb = jax_make_batch(jcfg, JAX_SMOKE, seed=1)
    (wloss, wmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True)(jp)
    module = copy.deepcopy(module)
    loss, met = m.loss(module, batch)
    loss.backward()
    _close(loss, wloss, F32, "loss")
    for k in ("loss", "z_loss", "aux_loss", "tokens"):
        _close(met[k], wmet[k], F32, k)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    got = {n: p.grad for n, p in module.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], F32_GRAD, f"grad {name}")
    with torch.no_grad():
        for p in module.parameters():
            p -= 0.3 * p.grad
        loss2, _ = m.loss(module, batch)
    assert torch.isfinite(loss2) and float(loss2) != float(loss.detach())


def test_bf16_encdec_forward_matches_reference():
    """seamless's bf16 logits within 1.5e-2."""
    jcfg, jm, jp, cfg, m, module = _pair("seamless_m4t_large_v2",
                                         "bfloat16")
    assert {p.dtype for p in module.parameters()} == {torch.bfloat16}
    batch = make_batch(cfg, SMOKE_SHAPE, seed=2, device="cpu")
    want, _ = jm.forward(jp, jax_make_batch(jcfg, JAX_SMOKE, seed=2))
    with torch.no_grad():
        got, _ = m.forward(module, batch)
    _close(got, want, BF16, "forward bf16")


def test_bf16_shared_block_matches_reference():
    """The hybrid in bf16 a block at a time (the Mamba2 block above):
    the shared attention block on ``concat(h, emb)`` within 1.5e-2
    (measured 6.8e-3)."""
    jcfg, jm, jp, cfg, m, module = _pair("zamba2_7b", "bfloat16")
    rng = np.random.default_rng(10)
    h, emb = (rng.normal(0, 1, (2, 64, cfg.d_model)).astype(np.float32)
              for _ in range(2))
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64)).copy()
    from repro.models import lm as jax_lm
    want = jax_lm._shared_block(jp["shared"], jcfg,
                                jnp.asarray(h, jnp.bfloat16),
                                jnp.asarray(emb, jnp.bfloat16),
                                jnp.asarray(pos), None)
    with torch.no_grad():
        got = lm_mod._shared_block(module.shared, cfg,
                                   _t(h).to(torch.bfloat16),
                                   _t(emb).to(torch.bfloat16), _t(pos), None)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16, "shared block bf16")


def test_bf16_hybrid_forward_is_as_close_to_float32_as_reference():
    """The whole reduced zamba2 in bf16 is held against the float32
    logits of the same (bf16-representable) weights: the port's bf16
    logits must lie no farther from them than 1.5 times the reference's
    bf16 logits do. Across its 7 Mamba2 layers and two shared-block
    calls the random-init hybrid amplifies bf16 rounding: each package's
    bf16 logits sit 3-4 % of the largest logit from float32 (measured:
    port 3.4e-2, reference 4.1e-2) and so 3.2e-2 from each other, while
    every block alone agrees within 1.5e-2 and float32 within 1e-5."""
    jcfg, jm, jp, cfg, m, module = _pair("zamba2_7b", "bfloat16")
    toks = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))}
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    truth, _ = jax_build(dataclasses.replace(
        jcfg, param_dtype="float32", compute_dtype="float32")).forward(
        jp32, _jbatch(toks))
    want, _ = jm.forward(jp, _jbatch(toks))
    with torch.no_grad():
        got, _ = m.forward(module, toks)
    truth = np.asarray(truth)
    scale = float(np.abs(truth).max())
    ref_err = float(np.abs(np.asarray(want) - truth).max()) / scale
    port_err = float(np.abs(_np(got) - truth).max()) / scale
    assert port_err <= 1.5 * ref_err, (port_err, ref_err)


def test_hybrid_prefill_then_decode_matches_forward():
    """``tests/test_models_smoke.py``'s contract on the port alone:
    prefill(T-1 tokens) + decode(token T-1) reproduce the forward logits
    at positions T-2 and T-1 within 2e-3; ``init_cache`` has the prefill
    cache's structure; decode leaves its input cache as it was."""
    _, cfg = _cfgs("zamba2_7b")
    m = build(cfg)
    module = m.init(7, device="cpu")
    B, T = 2, 32
    batch = _inputs(cfg, B, T, 0)
    toks = batch["tokens"]
    with torch.no_grad():
        full, _ = m.forward(module, batch)
    logits_p, cache = m.prefill(module, {"tokens": toks[:, :T - 1]})
    _self_close(logits_p[:, -1], full[:, T - 2], "prefill")
    empty = m.init_cache(B, T, device="cpu")
    for k, v in _leaves(empty):
        c = dict(_leaves(cache))[k]
        assert v.dtype == c.dtype, k
        assert v.shape == c.shape or (k.startswith("attn")
                                      and v.shape[2] == T), k
    spliced = _splice(cache, m, B, T)
    before = {k: v.clone() for k, v in _leaves(spliced)}
    dec, new = m.decode(module, spliced, {"token": toks[:, T - 1:],
                                          "pos": T - 1})
    _self_close(dec[:, 0], full[:, T - 1], "decode")
    for k, v in _leaves(spliced):
        assert torch.equal(v, before[k]), k
        assert dict(_leaves(new))[k].shape == v.shape


@pytest.mark.parametrize("reference", [False, True])
def test_encdec_teacher_forced_decode_matches_decode_train(reference):
    """The port of ``test_seamless_prefill_decode``: tokens 0..T-2
    teacher-forced through decode steps against the encoder's memory
    give ``decode_train``'s logits at every position (2e-3); and each
    step's logits equal the reference's decode steps (1e-5)."""
    jcfg, jm, jp, cfg, m, module = _pair("seamless_m4t_large_v2")
    B, T = 2, 16
    batch = _inputs(cfg, B, T, 1)
    with torch.no_grad():
        memory = encdec.encode(module, cfg, batch["frame_embeds"])
        full = encdec.decode_train(module, cfg, batch["tokens"], memory)
    if reference:
        jmem = jax.numpy.asarray(memory.numpy())
        jcache = jm.init_cache(B, T)
    cache = m.init_cache(B, T, device="cpu")
    toks = batch["tokens"]
    for t in range(T - 1):
        logits, cache = m.decode(module, cache, {
            "token": toks[:, t:t + 1], "pos": t, "memory": memory})
        _self_close(logits[:, 0], full[:, t], f"step {t}")
        if reference:
            wl, jcache = jm.decode(jp, jcache, {
                "token": jnp.asarray(toks[:, t:t + 1].numpy()),
                "pos": jnp.asarray(t, jnp.int32), "memory": jmem})
            _close(logits, wl, F32, f"reference step {t}")


@pytest.mark.parametrize("arch_id", IDS)
@pytest.mark.parametrize("shape", sorted(JAX_SHAPES))
def test_input_specs_and_make_batch_match_reference(arch_id, shape):
    """seamless's stubbed audio frontend: half the positions frame
    embeddings, half text tokens, and the decode step's encoder memory;
    zamba2's plain tokens (its long_500k decode shape included)."""
    jcfg, cfg = _cfgs(arch_id, "bfloat16")
    want = jax_input_specs(jcfg, JAX_SHAPES[shape])
    got = input_specs(cfg, SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert got[k].shape == s.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(s.dtype), k
    if cfg.family == "encdec":
        assert ("memory" in got) == (SHAPES[shape].kind == "decode")
    jb = jax_make_batch(jcfg, JAX_SHAPES[shape], seed=5)
    tb = make_batch(cfg, SHAPES[shape], seed=5, device="cpu")
    for k in jb:
        np.testing.assert_array_equal(_np(tb[k]), np.asarray(jb[k], np.float32)
                                      if tb[k].is_floating_point()
                                      else np.asarray(jb[k]))


# -- the hybrid's ring-buffer attention cache ---------------------------------

RING_WINDOW = 8
RING_STEPS = 20


@pytest.fixture(scope="module")
def ring_pair():
    """The reduced zamba2 in float32 with an 8-token sliding window, in
    both packages on the reference's weights, and 20 tokens to decode."""
    pair = _pair("zamba2_7b", sliding_window=RING_WINDOW)
    toks = np.random.default_rng(9).integers(0, 512, (2, RING_STEPS)).astype(
        np.int32)
    return pair, toks


def _decode_all(m, module, cache, toks, window, tensor_pos=False):
    out = []
    for t in range(toks.shape[1]):
        pos = torch.tensor(t, dtype=torch.int32) if tensor_pos else t
        logits, cache = m.decode(module, cache, {
            "token": torch.from_numpy(toks[:, t:t + 1]), "pos": pos},
            window=window)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1), cache


def _jdecode_all(jm, jp, cache, toks, window):
    decode = jax.jit(jm.decode, static_argnames="window")
    out = []
    for t in range(toks.shape[1]):
        logits, cache = decode(jp, cache, {
            "token": jnp.asarray(toks[:, t:t + 1]),
            "pos": jnp.asarray(t, jnp.int32)}, window=window)
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, axis=1), cache


def test_ring_cache_has_window_slots(ring_pair):
    (jcfg, jm, jp, cfg, m, module), _ = ring_pair
    ring = m.init_cache(2, 100_000, device="cpu")
    assert ring["attn"]["k"].shape == jm.init_cache(2, 100_000)[
        "attn"]["k"].shape == (2, 2, RING_WINDOW, 4, 32)
    assert m.init_cache(2, 99_999, device="cpu")["attn"]["k"].shape[2] == \
        99_999


def test_ring_below_the_wrap_matches_reference(ring_pair):
    """Positions 0..7 of the 8-slot ring: the reference's logits and
    cache, step by step."""
    (jcfg, jm, jp, cfg, m, module), toks = ring_pair
    toks = toks[:, :RING_WINDOW]
    want, wc = _jdecode_all(jm, jp, jm.init_cache(2, 100_000), toks,
                            RING_WINDOW)
    got, gc = _decode_all(m, module, m.init_cache(2, 100_000, device="cpu"),
                          toks, RING_WINDOW)
    _close(got, want, F32, "logits")
    for k, w in _leaves(wc):
        _close(dict(_leaves(gc))[k], w, F32, k)


@pytest.mark.parametrize("tensor_pos", [False, True])
def test_ring_past_the_wrap_matches_full_cache(ring_pair, tensor_pos):
    """20 steps through the 8-slot ring (100,000 positions asked for)
    equal the port's decode through a 32-slot cache with the same 8-token
    window at every step, and the last step equals ``forward(...,
    window=8)`` at the last position: past the wrap, each slot's key
    keeps its RoPE at its true position and the previous lap's keys
    still in the window stay attended. An int position and a 0-d tensor
    one give the same steps."""
    (jcfg, jm, jp, cfg, m, module), toks = ring_pair
    ring, _ = _decode_all(m, module, m.init_cache(2, 100_000, device="cpu"),
                          toks, RING_WINDOW, tensor_pos)
    full, _ = _decode_all(m, module, m.init_cache(2, 32, device="cpu"),
                          toks, RING_WINDOW)
    _self_close(ring, full, "ring vs full cache")
    with torch.no_grad():
        fwd, _ = m.forward(module, {"tokens": torch.from_numpy(toks)},
                           window=RING_WINDOW)
    _self_close(ring[:, -1], fwd[:, -1], "ring vs forward")
    _self_close(full, fwd, "full cache vs forward")


def test_reference_ring_diverges_past_the_wrap(ring_pair):
    """The defect the port does not copy: the reference's ring passes
    ``pos % 8`` as the position once it wraps (RoPE there, and the slots
    after it masked out), so its logits equal its full-cache windowed
    decode at positions 0..7 and leave it from position 8 on (measured
    here 3.5-4.8 max abs at positions 8..19, on logits of max ~4; the
    port's ring stays within 8.3e-6 of its full cache)."""
    (jcfg, jm, jp, cfg, m, module), toks = ring_pair
    ring, _ = _jdecode_all(jm, jp, jm.init_cache(2, 100_000), toks,
                           RING_WINDOW)
    full, _ = _jdecode_all(jm, jp, jm.init_cache(2, 32), toks, RING_WINDOW)
    gap = np.abs(ring - full).max(axis=(0, 2))
    assert gap[:RING_WINDOW].max() <= 1e-4, gap
    assert gap[RING_WINDOW:].min() > 1.0, gap
