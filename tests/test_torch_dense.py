"""The port's dense, vlm and MoE families on the CPU against the JAX
package.

Configs carry over field for field; the reference's weights go through
``params_from_jax`` into the port's modules, and the same seeded numpy
inputs run through both packages: RoPE, the qk-norm, the MLPs, attention
(causal, sliding window, q-chunked, cross, GQA), decode attention, the
GShard dispatch masks, the MoE layer, and the seven reduced models
(qwen3-0.6b, qwen2.5-3b, stablelm-1.6b, phi3-mini-3.8b, pixtral-12b,
dbrx-132b, arctic-480b) through ``forward``, ``prefill``, ``decode`` and
``loss`` with its gradient.

Tolerances, as ``max |port - ref| <= tol * max |ref|``:
  * float32 logits and layer outputs: 1e-5. Both packages compute the
    same float32 operations in the same order except for sums (matmuls,
    the norms' and softmax's sums), a few ulps apart;
  * float32 gradients: 1e-4 per parameter;
  * bfloat16 logits: 1.5e-2, the precedent of ``test_torch_models.py``
    (the two frameworks round bf16 matmul results after different
    accumulation orders);
  * the dispatch tensor is equal bit for bit (0 / 1 from integer
    counts); combine and the aux loss within 1e-6.
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
from repro.models import attention as jax_attn
from repro.models import build as jax_build
from repro.models import input_specs as jax_input_specs
from repro.models import layers as jax_layers
from repro.models import make_batch as jax_make_batch
from repro.models import moe as jax_moe
from repro_torch.configs import SHAPES, ArchConfig
from repro_torch.models import (attention, build, convert, input_specs,
                                layers, make_batch, moe)
from tests.helpers.torch_parity import one_torch_thread  # noqa: F401

F32, F32_GRAD, BF16 = 1e-5, 1e-4, 1.5e-2
DENSE_IDS = ("qwen3_0_6b", "qwen2_5_3b", "stablelm_1_6b", "phi3_mini_3_8b",
             "pixtral_12b", "dbrx_132b", "arctic_480b")


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


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos_shape", ["batched", "shared"])
def test_rope_apply_matches_reference(dtype, pos_shape):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 24, 3, 32)).astype(np.float32)
    pos = (rng.integers(0, 5000, (2, 24)) if pos_shape == "batched"
           else np.arange(24)).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_layers.rope_apply(jnp.asarray(x, jdt), jnp.asarray(pos),
                                 1e4)
    got = layers.rope_apply(_t(x).to(tdt), _t(pos), 1e4)
    assert got.dtype == tdt
    # one bf16 ulp of the largest output where the products round there
    _close(got, want, 1e-5 if dtype == "float32" else 8e-3, "rope")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_norm_apply_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, (2, 5, 4, 32)).astype(np.float32)
    scale = rng.normal(1, 0.1, 32).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_layers.head_norm_apply(jnp.asarray(scale, jdt),
                                      jnp.asarray(x, jdt))
    got = layers.head_norm_apply(_t(scale).to(tdt), _t(x).to(tdt))
    _close(got, want, 1e-6 if dtype == "float32" else 8e-3, "head_norm")


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply_matches_reference(act):
    """Including ``jax.nn.gelu``'s default tanh approximation."""
    jcfg, cfg = _cfgs("phi3_mini_3_8b", act=act)
    jp = jax_layers.mlp_init(jax.random.PRNGKey(3), jcfg)
    p = _load(layers.mlp_init(cfg, torch.Generator().manual_seed(0)), jp,
              cfg)
    assert hasattr(p, "w_gate") == (act == "swiglu")
    x = np.random.default_rng(2).normal(0, 1, (2, 7, cfg.d_model)).astype(
        np.float32)
    want = jax_layers.mlp_apply(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = layers.mlp_apply(p, cfg, _t(x))
    _close(got, want, F32, act)


# -- attention ----------------------------------------------------------------

# (arch, what): qwen3's qk-norm and GQA 4/2, qwen2.5's QKV bias and GQA
# 4/2, stablelm's plain multi-head attention 4/4
ATTN_ARCHS = ("qwen3_0_6b", "qwen2_5_3b", "stablelm_1_6b")


def _attn_pair(arch_id, **kw):
    jcfg, cfg = _cfgs(arch_id, **kw)
    jp = jax_attn.attn_init(jax.random.PRNGKey(4), jcfg)
    # non-zero biases and norm scales, so that both are exercised
    rng = np.random.default_rng(5)
    jp = {k: (v + jnp.asarray(rng.normal(0, 0.1, v.shape), v.dtype)
              if k in ("bq", "bk", "bv", "q_norm", "k_norm") else v)
          for k, v in jp.items()}
    p = _load(attention.attn_init(cfg, torch.Generator().manual_seed(0)),
              jp, cfg)
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("arch_id", ATTN_ARCHS)
@pytest.mark.parametrize("case", ["causal", "window", "chunked",
                                  "bidirectional", "cross"])
def test_attention_matches_reference(arch_id, case):
    jcfg, cfg, jp, p = _attn_pair(
        arch_id, attn_chunk=8 if case == "chunked" else 0)
    rng = np.random.default_rng(6)
    B, T = 2, 32
    x = rng.normal(0, 1, (B, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    kw = dict(causal=case != "bidirectional",
              window=8 if case == "window" else None)
    mem = None
    if case == "cross":
        mem = rng.normal(0, 1, (B, 12, cfg.d_model)).astype(np.float32)
    want, wkv = jax_attn.attention(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos), return_kv=True,
        memory=None if mem is None else jnp.asarray(mem), **kw)
    with torch.no_grad():
        got, kv = attention.attention(
            p, cfg, _t(x), _t(pos), return_kv=True,
            memory=None if mem is None else _t(mem), **kw)
    _close(got, want, F32, case)
    for k in ("k", "v"):
        _close(kv[k], wkv[k], F32, k)


def test_chunked_attention_gradient_matches_unchunked():
    """The chunks are rematerialised where a gradient is wanted; the
    gradient is the unchunked one's."""
    _, cfg, _, p = _attn_pair("qwen3_0_6b", attn_chunk=8)
    plain = dataclasses.replace(cfg, attn_chunk=0)
    x = _t(np.random.default_rng(7).normal(0, 1, (2, 32, cfg.d_model))
           .astype(np.float32))
    pos = torch.arange(32, dtype=torch.int32)[None].expand(2, 32)
    grads = []
    for c in (cfg, plain):
        xi = x.clone().requires_grad_(True)
        attention.attention(p, c, xi, pos).square().sum().backward()
        grads.append(xi.grad)
    _close(grads[0], grads[1], F32, "dx")


def test_repeat_kv_is_jnp_repeat():
    _, cfg = _cfgs("qwen3_0_6b")
    k = np.random.default_rng(8).normal(0, 1, (2, 3, 2, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        attention._repeat_kv(cfg, _t(k)).numpy(),
        np.asarray(jax_attn._repeat_kv(cfg, jnp.asarray(k))))


def _decode_inputs(cfg, B=2, S=12, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    cache = {k: rng.normal(0, 1, shape).astype(np.float32)
             for k in ("k", "v")}
    return x, cache


@pytest.mark.parametrize("arch_id", ATTN_ARCHS)
@pytest.mark.parametrize("pos_kind", ["int", "tensor"])
@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention_matches_reference(arch_id, pos_kind, window):
    """An int position and a 0-d tensor one give the reference's output
    and cache; the input cache is left as it was."""
    jcfg, cfg, jp, p = _attn_pair(arch_id)
    x, cache = _decode_inputs(cfg)
    want, wc = jax_attn.decode_attention(
        jp, jcfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                   cache.items()},
        jnp.asarray(5, jnp.int32), window=window)
    tc = {k: _t(v) for k, v in cache.items()}
    pos = 5 if pos_kind == "int" else torch.tensor(5, dtype=torch.int32)
    with torch.no_grad():
        got, gc = attention.decode_attention(p, cfg, _t(x), tc, pos,
                                             window=window)
    _close(got, want, F32, "out")
    for k in ("k", "v"):
        _close(gc[k], wc[k], F32, k)
        np.testing.assert_array_equal(tc[k].numpy(), cache[k])


def test_decode_attention_past_the_end():
    """The reference's ``dynamic_update_slice`` clamps a position past
    the cache's end and overwrites the last slot (position 7 of 4 slots
    writes slot 3, and every slot is attended). The port raises for an
    int position and, for a tensor position, clamps on the card as the
    reference does (a check would cost a host sync)."""
    jcfg, cfg, jp, p = _attn_pair("qwen2_5_3b")
    x, cache = _decode_inputs(cfg, S=4)
    want, wc = jax_attn.decode_attention(
        jp, jcfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                   cache.items()},
        jnp.asarray(7, jnp.int32))
    np.testing.assert_array_equal(np.asarray(wc["k"])[:, :3],
                                  cache["k"][:, :3])
    assert not np.array_equal(np.asarray(wc["k"])[:, 3], cache["k"][:, 3])
    tc = {k: _t(v) for k, v in cache.items()}
    with torch.no_grad():
        with pytest.raises(ValueError, match="outside the cache"):
            attention.decode_attention(p, cfg, _t(x), tc, 7)
        with pytest.raises(ValueError, match="outside the cache"):
            attention.decode_attention(p, cfg, _t(x), tc, -1)
        got, gc = attention.decode_attention(
            p, cfg, _t(x), tc, torch.tensor(7, dtype=torch.int32))
    _close(got, want, F32, "out")
    for k in ("k", "v"):
        _close(gc[k], wc[k], F32, k)


# -- MoE ----------------------------------------------------------------------


@pytest.mark.parametrize("top_k,capacity", [(1, 4), (2, 4), (2, 16),
                                            (4, 40)])
def test_dispatch_masks_match_reference(top_k, capacity):
    """Dispatch bit for bit, combine and aux within 1e-6. Capacity 4
    drops most tokens (positions past it get an all-zero slot row)."""
    logits = np.random.default_rng(top_k + capacity).normal(
        0, 2, (3, 64, 8)).astype(np.float32)
    gates = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    wd, wc, wa = jax_moe._dispatch_masks(gates, top_k, capacity)
    gd, gc, ga = moe._dispatch_masks(_t(gates), top_k, capacity)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    assert float(gd.sum()) < 3 * 64 * top_k or capacity == 40
    _close(gc, wc, 1e-6, "combine")
    assert abs(float(ga) - float(wa)) <= 1e-6 * abs(float(wa))


@pytest.mark.parametrize("arch_id,act", [("dbrx_132b", "swiglu"),
                                         ("dbrx_132b", "gelu"),
                                         ("arctic_480b", "swiglu")])
def test_moe_apply_matches_reference(arch_id, act):
    """dbrx (no dense residual, both activations) and arctic (the dense
    residual MLP beside the experts)."""
    jcfg, cfg = _cfgs(arch_id, act=act)
    jp = jax_moe.moe_init(jax.random.PRNGKey(10), jcfg)
    p = _load(moe.moe_init(cfg, torch.Generator().manual_seed(0)), jp, cfg)
    assert hasattr(p, "dense") == cfg.moe_dense_residual
    assert p.router.dtype == torch.float32
    x = np.random.default_rng(11).normal(0, 1, (2, 64, cfg.d_model)).astype(
        np.float32)
    want, waux = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, aux = moe.moe_apply(p, cfg, _t(x))
    _close(got, want, F32, "out")
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(waux)) <= 1e-6 * abs(float(waux))


@pytest.mark.parametrize("arch_id", ["dbrx_132b", "arctic_480b"])
def test_bf16_moe_layer_matches_reference(arch_id):
    """One bf16 MoE layer on the same input: within the bf16 logits'
    1.5e-2 (measured 6e-3 / 7e-3), the same experts chosen."""
    jcfg, cfg = _cfgs(arch_id, "bfloat16")
    jp = jax_moe.moe_init(jax.random.PRNGKey(12), jcfg)
    p = _load(moe.moe_init(cfg, torch.Generator().manual_seed(0)), jp, cfg)
    x = np.random.default_rng(13).normal(0, 1, (2, 64, cfg.d_model)).astype(
        np.float32)
    want, _ = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got, _ = moe.moe_apply(p, cfg, _t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16, "moe bf16")


def test_moe_group_size_must_divide_tokens():
    _, cfg = _cfgs("dbrx_132b")
    p = moe.moe_init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="group size 64"):
        moe.moe_apply(p, cfg, torch.zeros((2, 63, cfg.d_model)))


# -- the seven reduced models -------------------------------------------------

SMOKE_SHAPE = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                  global_batch=2)
JAX_SMOKE = dataclasses.replace(JAX_SHAPES["train_4k"], seq_len=64,
                                global_batch=2)
DECODE_SHAPE = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                   global_batch=2)
JAX_DECODE = dataclasses.replace(JAX_SHAPES["decode_32k"], seq_len=64,
                                 global_batch=2)


def _pair(arch_id, dtype="float32"):
    jcfg, cfg = _cfgs(arch_id, dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build(cfg)
    lm = _load(m.init(0, device="cpu"), jp, cfg)
    return jcfg, jm, jp, cfg, m, lm


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
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _splice(cache, model, B, S, device="cpu"):
    """The prefill's KV in a cache of S slots (room to decode)."""
    empty = model.init_cache(B, S, device=device)
    T = cache["layers"]["k"].shape[2]
    out = {}
    for k in ("k", "v"):
        buf = empty["layers"][k].clone()
        buf[:, :, :T] = cache["layers"][k]
        out[k] = buf
    return {"layers": out}


def _jsplice(cache, model, B, S):
    empty = model.init_cache(B, S)
    T = cache["layers"]["k"].shape[2]
    return {"layers": {k: empty["layers"][k].at[:, :, :T].set(
        cache["layers"][k]) for k in ("k", "v")}}


@pytest.mark.parametrize("arch_id", DENSE_IDS)
def test_forward_prefill_decode_match_reference(arch_id, f32_pair):
    """float32: forward logits and aux, prefill logits and its KV cache
    (post-RoPE, pre-repeat; dbrx's B·(T-1) is not a multiple of its group
    size, so its prefill runs on the last group's worth), a decode step
    after the prefill at an int position, and a decode step of
    ``make_batch``'s decode batch (a 0-d tensor position) against a
    zero cache."""
    jcfg, jm, jp, cfg, m, lm = f32_pair(arch_id)
    batch = make_batch(cfg, SMOKE_SHAPE, seed=1, device="cpu")
    jb = _jbatch(jax_make_batch(jcfg, JAX_SMOKE, seed=1))
    for k in batch:
        np.testing.assert_array_equal(_np(batch[k]), np.asarray(jb[k]))
    want, waux = jm.forward(jp, jb)
    with torch.no_grad():
        got, aux = m.forward(lm, batch)
    assert got.dtype == torch.float32
    _close(got, want, F32, "forward")
    assert abs(float(aux) - float(waux)) <= 1e-6 * max(abs(float(waux)), 1)
    assert (float(aux) > 0) == (cfg.family == "moe")

    # prefill on all but the last token: B·(T-1) tokens must fill whole
    # MoE groups, so the MoE configs prefill half the prompt
    T = batch["tokens"].shape[1]
    cut = T // 2 if cfg.family == "moe" else T - 1
    pre = {k: v for k, v in batch.items() if k != "targets"}
    pre["tokens"] = batch["tokens"][:, :cut]
    wl, wc = jm.prefill(jp, {k: jnp.asarray(_np(v) if v.is_floating_point()
                                           else v.numpy())
                             for k, v in pre.items()})
    gl, gc = m.prefill(lm, pre)
    _close(gl, wl, F32, "prefill")
    for k in ("k", "v"):
        _close(gc["layers"][k], wc["layers"][k], F32, f"cache {k}")
    B, S = 2, gc["layers"]["k"].shape[2] + 1
    step = {"token": batch["tokens"][:, cut:cut + 1]}
    wd, wdc = jm.decode(jp, _jsplice(wc, jm, B, S),
                        {"token": jnp.asarray(step["token"].numpy()),
                         "pos": jnp.asarray(S - 1, jnp.int32)})
    gd, gdc = m.decode(lm, _splice(gc, m, B, S), {**step, "pos": S - 1})
    _close(gd, wd, F32, "decode")
    for k in ("k", "v"):
        _close(gdc["layers"][k], wdc["layers"][k], F32, f"decode {k}")

    db = make_batch(cfg, DECODE_SHAPE, seed=3, device="cpu")
    assert db["pos"].ndim == 0 and int(db["pos"]) == 32
    wd, _ = jm.decode(jp, jm.init_cache(2, 64),
                      _jbatch(jax_make_batch(jcfg, JAX_DECODE, seed=3)))
    gd, _ = m.decode(lm, m.init_cache(2, 64, device="cpu"), db)
    _close(gd, wd, F32, "decode (tensor pos)")


def _grads_by_name(jgrads, cfg):
    return convert.params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)


@pytest.mark.parametrize("arch_id", DENSE_IDS)
def test_loss_and_gradient_match_reference(arch_id, f32_pair):
    """The port of ``test_forward_and_train_step``: ``Model.loss`` (with
    remat, as the reduced configs have it) and its gradient against
    ``jax.grad`` of the reference's, every parameter within 1e-4 of its
    largest reference magnitude; one SGD step moves the loss."""
    jcfg, jm, jp, cfg, m, lm = f32_pair(arch_id)
    assert cfg.remat
    batch = make_batch(cfg, SMOKE_SHAPE, seed=1, device="cpu")
    jb = _jbatch(jax_make_batch(jcfg, JAX_SMOKE, seed=1))
    (wloss, wmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True)(jp)
    lm = copy.deepcopy(lm)
    loss, met = m.loss(lm, batch)
    loss.backward()
    _close(loss, wloss, F32, "loss")
    for k in ("loss", "z_loss", "aux_loss", "tokens"):
        _close(met[k], wmet[k], F32, k)
    want = _grads_by_name(jgrads, cfg)
    got = {n: p.grad for n, p in lm.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], F32_GRAD, f"grad {name}")
    with torch.no_grad():
        for p in lm.parameters():
            p -= 0.3 * p.grad
        loss2, _ = m.loss(lm, batch)
    assert torch.isfinite(loss2) and float(loss2) != float(loss.detach())


@pytest.mark.parametrize("arch_id", [a for a in DENSE_IDS
                                     if "132b" not in a and "480b" not in a])
def test_bf16_forward_matches_reference(arch_id):
    """bf16 logits of the dense and vlm models. The MoE models are held
    in bf16 a layer at a time (below): across layers, the two
    frameworks' bf16 roundings move near-tied router logits enough to
    flip a token's expert, and with it the queue slots of the tokens
    after it (measured: 4-43 of 128 rows of the reduced dbrx and arctic
    differ by ~0.1 of the largest logit, dropless or not). The float32
    tests hold the whole MoE models at 1e-5."""
    jcfg, jm, jp, cfg, m, lm = _pair(arch_id, "bfloat16")
    assert {p.dtype for n, p in lm.named_parameters()
            if not n.endswith("router")} == {torch.bfloat16}
    batch = make_batch(cfg, SMOKE_SHAPE, seed=2, device="cpu")
    want, _ = jm.forward(jp, _jbatch(jax_make_batch(jcfg, JAX_SMOKE,
                                                    seed=2)))
    with torch.no_grad():
        got, _ = m.forward(lm, batch)
    _close(got, want, BF16, "forward bf16")


@pytest.mark.parametrize("arch_id", ["qwen3_0_6b", "dbrx_132b"])
def test_prefill_then_decode_matches_forward(arch_id):
    """``tests/test_models_smoke.py``'s contract on the port alone:
    prefill(T-1 tokens) + decode(token T-1) reproduce the forward logits
    at positions T-2 and T-1 within 2e-3; MoE dropless (capacity factor
    16); ``init_cache`` has the prefill cache's structure."""
    cfg = ArchConfig(**dataclasses.asdict(_cfgs(arch_id)[0]))
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    m = build(cfg)
    lm = m.init(7, device="cpu")
    B, T = 2, 32
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (B, T)))
    with torch.no_grad():
        full, _ = m.forward(lm, {"tokens": toks})
    logits_p, cache = m.prefill(lm, {"tokens": toks[:, :T - 1]})
    np.testing.assert_allclose(logits_p[:, -1].numpy(),
                               full[:, T - 2].numpy(), rtol=2e-3, atol=2e-3)
    empty = m.init_cache(B, T, device="cpu")
    for k in ("k", "v"):
        assert empty["layers"][k].shape[:2] == cache["layers"][k].shape[:2]
        assert empty["layers"][k].shape[3:] == cache["layers"][k].shape[3:]
        assert empty["layers"][k].dtype == cache["layers"][k].dtype
    spliced = _splice(cache, m, B, T)
    before = {k: v.clone() for k, v in spliced["layers"].items()}
    dec, new = m.decode(lm, spliced, {"token": toks[:, T - 1:],
                                      "pos": T - 1})
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, T - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    for k in ("k", "v"):
        assert torch.equal(spliced["layers"][k], before[k])
        assert new["layers"][k].shape == before[k].shape


def test_moe_routing_is_balanced_enough():
    """The port of the reference's structural check: the aux loss lies
    in (0.5, E): 1 is perfectly balanced, E fully collapsed."""
    jcfg, cfg = _cfgs("dbrx_132b", remat=False)
    m = build(cfg)
    _, metrics = m.loss(m.init(0, device="cpu"),
                        make_batch(cfg, SMOKE_SHAPE, seed=4, device="cpu"))
    aux = float(metrics["aux_loss"])
    assert 0.5 < aux < cfg.n_experts, aux


@pytest.mark.parametrize("arch_id", ["pixtral_12b", "qwen2_5_3b"])
@pytest.mark.parametrize("shape", sorted(JAX_SHAPES))
def test_input_specs_and_make_batch_match_reference(arch_id, shape):
    """pixtral's stubbed frontend: ``extra_embeds`` of the reference's
    ``_front_len`` rows, the text tokens after them and no loss on them,
    at every workload shape (the reduced width keeps the draws small)."""
    jcfg, cfg = _cfgs(arch_id, "bfloat16")
    want = jax_input_specs(jcfg, JAX_SHAPES[shape])
    got = input_specs(cfg, SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert got[k].shape == s.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(s.dtype), k
    assert ("extra_embeds" in got) == (
        arch_id == "pixtral_12b" and SHAPES[shape].kind != "decode")
    jb = jax_make_batch(jcfg, JAX_SHAPES[shape], seed=5)
    tb = make_batch(cfg, SHAPES[shape], seed=5, device="cpu")
    for k in jb:
        np.testing.assert_array_equal(_np(tb[k]), np.asarray(jb[k], np.float32)
                                      if tb[k].is_floating_point()
                                      else np.asarray(jb[k]))
