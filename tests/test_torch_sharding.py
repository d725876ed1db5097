"""The port's sharding rules against the JAX package's, on the CPU.

``repro_torch.distributed.sharding`` and ``train.optimizer.state_specs``
give, for all ten ids at full size on both production meshes (the
size-only stand-in of ``tests/test_sharding_and_tools.py``: 16 x 16
("data", "model") and 2 x 16 x 16 ("pod", "data", "model")), the
reference's specs entry for entry:

  * parameters: the port's per-layer tensor takes its stacked leaf's spec
    less the stack's entries (which are ``None`` for every id);
  * optimizer state: AdamW's ``m`` / ``v`` by parameter, Adafactor's
    ``vr`` / ``vc`` by the reference's stacked leaf;
  * batch specs of every shape of the id; cache specs at ``decode_32k``
    and, where the family has it, ``long_500k``.

Then the mirrors of ``test_sharding_and_tools.py``'s divisibility,
FSDP-fraction and ``batch_axis`` cases, the placements and local shapes
of a spec, and the repairs that the meta-device dry run needed:
``abstract_state`` for every family (the enc-dec's included) against
the reference's, and ``"meta"`` accepted by the entry points only when
asked for. Comparisons are exact (specs, shapes, dtypes).
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as JSHAPES
from repro.configs import get as jget
from repro.distributed import sharding as jsh
from repro.models import build as jbuild
from repro.models import input_specs as jinput_specs
from repro.train import OptConfig as JOptConfig
from repro.train import abstract_state as jabstract_state
from repro.train import optimizer as jopt
from repro_torch.configs import SHAPES, get
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.models import build, input_specs, make_batch
from repro_torch.train import OptConfig, abstract_state
from repro_torch.train import optimizer as opt
from tests.helpers.torch_parity import one_torch_thread  # noqa: F401


class FakeMesh:
    """Divisibility-logic stand-in with production axis sizes (the
    reference test's)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


PROD = FakeMesh({"data": 16, "model": 16})
PROD_MP = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = pytest.mark.parametrize("mesh", [PROD, PROD_MP],
                                 ids=["1pod", "2pod"])
_CACHE = {}


def _ref(arch):
    """The reference's config, model and abstract train state (cached)."""
    if arch not in _CACHE:
        cfg = jget(arch)
        model = jbuild(cfg)
        _CACHE[arch] = (cfg, model, jabstract_state(
            model, JOptConfig.for_arch(cfg)))
    return _CACHE[arch]


def _port(arch):
    key = ("port", arch)
    if key not in _CACHE:
        cfg = get(arch)
        _CACHE[key] = (cfg, abstract_state(build(cfg),
                                           OptConfig.for_arch(cfg)))
    return _CACHE[key]


def _flat(tree, is_leaf=None):
    """``[(path names, leaf)]`` of a JAX tree."""
    return [(tuple(getattr(p, "key", p) for p in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]]


def _norm(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _port_names(cfg, names):
    """The port's parameter names of a reference leaf path, with the
    length of the stack axes they drop."""
    lead = sh.stacked_axes(cfg).get(names[0], ()) if len(names) > 1 else ()
    return [".".join([names[0], *map(str, i), *names[1:]])
            for i in itertools.product(*map(range, lead))], len(lead)


def _is_spec(x):
    return isinstance(x, JP)


@pytest.mark.parametrize("arch", ARCH_IDS)
@MESHES
def test_param_specs_match_reference(arch, mesh):
    jcfg, _, jstate = _ref(arch)
    cfg, state = _port(arch)
    want = jsh.param_specs(jcfg, mesh, jstate["params"])
    got = sh.param_specs(cfg, mesh, state["params"])
    shapes = dict(_flat(jstate["params"]))
    seen = 0
    for names, spec in _flat(want, _is_spec):
        full = _norm(spec, len(shapes[names].shape))
        ports, lead = _port_names(cfg, names)
        assert full[:lead] == (None,) * lead, (names, full)
        for n in ports:
            assert _norm(got[n], len(full) - lead) == full[lead:], \
                (n, got[n], full)
            seen += 1
    assert seen == len(got)


@pytest.mark.parametrize("arch", ARCH_IDS)
@MESHES
def test_state_specs_match_reference(arch, mesh):
    """AdamW's moments by parameter; Adafactor's factored moments by the
    reference's stacked leaf (``layers.<rest>``)."""
    jcfg, _, jstate = _ref(arch)
    cfg, state = _port(arch)
    jocfg, ocfg = JOptConfig.for_arch(jcfg), OptConfig.for_arch(cfg)
    want = jopt.state_specs(jsh.param_specs(jcfg, mesh, jstate["params"]),
                            jstate["params"], jocfg)
    got = opt.state_specs(sh.param_specs(cfg, mesh, state["params"]),
                          state["params"], ocfg)
    assert sorted(got) == sorted(want)
    for key in want:
        shapes = dict(_flat(jstate["opt"][key]))
        count = 0
        for names, spec in _flat(want[key], _is_spec):
            nd = len(shapes[names].shape)
            if key in ("vr", "vc"):
                port = got[key][".".join(names)]
                assert _norm(port, nd) == _norm(spec, nd), (key, names)
                assert tuple(state["opt"][key][".".join(names)].shape) == \
                    tuple(shapes[names].shape)
                count += 1
                continue
            ports, lead = _port_names(cfg, names)
            for n in ports:
                assert _norm(got[key][n], nd - lead) == \
                    _norm(spec, nd)[lead:], (key, n)
                count += 1
        assert count == len(got[key])


@pytest.mark.parametrize("arch", ARCH_IDS)
@MESHES
def test_batch_specs_match_reference(arch, mesh):
    cfg, jcfg = get(arch), jget(arch)
    for name in cfg.shapes():
        want = jsh.batch_specs(jcfg, mesh, JSHAPES[name],
                               jinput_specs(jcfg, JSHAPES[name]))
        got = sh.batch_specs(cfg, mesh, SHAPES[name],
                             input_specs(cfg, SHAPES[name]))
        assert sorted(got) == sorted(want), name
        for k, spec in want.items():
            nd = len(input_specs(cfg, SHAPES[name])[k].shape)
            assert _norm(got[k], nd) == _norm(spec, nd), (name, k)


@pytest.mark.parametrize("arch", ARCH_IDS)
@MESHES
def test_cache_specs_match_reference(arch, mesh):
    cfg, jcfg = get(arch), jget(arch)
    jmodel, model = jbuild(jcfg), build(cfg)
    for name in ("decode_32k", "long_500k"):
        if name not in cfg.shapes():
            continue
        shape = SHAPES[name]
        jcache = jax.eval_shape(lambda: jmodel.init_cache(
            shape.global_batch, shape.seq_len))
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 device="meta")
        want = jsh.cache_specs(jcfg, mesh, JSHAPES[name], jcache)
        got = sh.cache_specs(cfg, mesh, shape, cache)
        shapes = dict(_flat(jcache))
        leaves = _flat(want, _is_spec)
        assert len(leaves) == len(_flat(got, lambda x: isinstance(
            x, sh.P))), name
        for names, spec in leaves:
            sub, leaf = got, cache
            for n in names:
                sub, leaf = sub[n], leaf[n]
            nd = len(shapes[names].shape)
            assert tuple(leaf.shape) == tuple(shapes[names].shape)
            assert _norm(sub, nd) == _norm(spec, nd), (name, names)


# -- mirrors of tests/test_sharding_and_tools.py --------------------------------


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "arctic_480b",
                                  "falcon_mamba_7b", "zamba2_7b"])
@MESHES
def test_param_specs_divide(arch, mesh):
    """Every spec'd axis must divide its dim (or the rule must drop it)."""
    cfg, state = _port(arch)
    specs = sh.param_specs(cfg, mesh, state["params"])
    params = dict(state["params"].named_parameters())
    assert specs.keys() == params.keys()
    for n, spec in specs.items():
        for dim, want in zip(params[n].shape, tuple(spec)):
            if want is not None:
                size = sh._axis_size(mesh, want)
                assert dim % size == 0, (arch, n, spec)


def test_fsdp_shards_big_params():
    """The dominant weights must actually be sharded (ZeRO-3 posture):
    under 1 % of arctic-480b's bytes replicated, and its bf16 parameters
    under 16e9 bytes a device (the reference's v5e bound)."""
    cfg, state = _port("arctic_480b")
    specs = sh.param_specs(cfg, PROD, state["params"])
    replicated = total = 0
    for n, p in state["params"].named_parameters():
        b = p.numel() * 2
        total += b
        if sh.local_shape(PROD, specs[n], p.shape) == tuple(p.shape):
            replicated += b
    assert replicated / total < 0.01
    assert total / 256 < 16e9


@pytest.mark.parametrize("mesh,batch,want", [
    (PROD, 256, ("data",)), (PROD_MP, 256, ("pod", "data")),
    (PROD_MP, 1, None), (PROD_MP, 16, ("data",))],
    ids=["1pod-256", "2pod-256", "2pod-1", "2pod-16"])
def test_batch_axis_fallbacks(mesh, batch, want):
    assert sh.batch_axis(mesh, batch) == want
    assert sh.batch_axis(mesh, batch) == jsh.batch_axis(mesh, batch)


# -- spec machinery ----------------------------------------------------------------


def test_spec_keeps_one_name_tuples_as_the_name():
    """As JAX's PartitionSpec does."""
    assert sh.P(("data",), ("model", "data"), None) == \
        ("data", ("model", "data"), None)
    assert tuple(JP(("data",))) == tuple(sh.P(("data",)))


@MESHES
def test_local_shape_divides_each_spec_axis(mesh):
    spec = sh.P(None, ("model", "data"))
    n = sh._axis_size(mesh, ("model", "data"))
    assert sh.local_shape(mesh, spec, (8, 4096)) == (8, 4096 // n)
    with pytest.raises(ValueError):
        sh.local_shape(mesh, spec, (8, 100))


def test_shard_slices_are_mesh_dim_major():
    """The multi-axis order (the module docstring): a dim cut over
    ("model", "data") on a (2, 4) ("data", "model") mesh gives rank (d,
    m) chunk ``d * 4 + m``; the chunks tile the dim."""
    mesh = FakeMesh({"data": 2, "model": 4})
    spec = sh.P(None, ("model", "data"))
    seen = []
    for d, m in itertools.product(range(2), range(4)):
        sl = sh.shard_slices(mesh, spec, (3, 16), (d, m))[1]
        assert (sl.start, sl.stop) == ((d * 4 + m) * 2, (d * 4 + m) * 2 + 2)
        seen.append(sl.start)
    assert sorted(seen) == list(range(0, 16, 2))


# -- the repairs the dry run needed ------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_state_matches_reference(arch):
    """Every family, the enc-dec's included, at full size on meta: the
    same leaves (through the stacked-layer mapping), shapes and
    dtypes."""
    jcfg, _, jstate = _ref(arch)
    cfg, state = _port(arch)
    params = dict(state["params"].named_parameters())
    assert all(p.device.type == "meta" for p in params.values())
    names = set()
    for path, leaf in _flat(jstate["params"]):
        ports, lead = _port_names(cfg, path)
        for n in ports:
            assert tuple(params[n].shape) == tuple(leaf.shape[lead:]), n
            assert str(params[n].dtype).split(".")[1] == str(leaf.dtype), n
            names.add(n)
    assert names == set(params)
    for key, tree in jstate["opt"].items():
        for path, leaf in _flat(tree):
            if key in ("vr", "vc"):
                got = state["opt"][key][".".join(path)]
                assert tuple(got.shape) == tuple(leaf.shape), (key, path)
                continue
            ports, lead = _port_names(cfg, path)
            for n in ports:
                got = state["opt"][key][n]
                assert tuple(got.shape) == tuple(leaf.shape[lead:])
                assert str(got.dtype).split(".")[1] == str(leaf.dtype)
    assert state["step"].device.type == "meta"


def test_meta_device_only_when_asked():
    assert resolve_device("meta").type == "meta"
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)          # the card, never meta or CPU


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "zamba2_7b",
                                  "seamless_m4t_large_v2"])
def test_meta_init_cache_and_batch_are_shapes_only(arch):
    """``init``, ``init_cache`` and ``make_batch`` on meta: the shapes and
    dtypes of the CPU's (reduced config), no storage, no draw from the
    global generator."""
    cfg = get(arch, reduced=True)
    model = build(cfg)
    before = torch.random.get_rng_state()
    lm = model.init(0, device="meta")
    cpu = model.init(0, device="cpu")
    assert [(n, p.shape, p.dtype) for n, p in lm.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in cpu.named_parameters()]
    assert all(p.is_meta for p in lm.parameters())
    shape = SHAPES["decode_32k"]
    for name in ("train_4k", "decode_32k"):
        small = type(shape)(name, 64, 2, SHAPES[name].kind)
        mb, cb = make_batch(cfg, small, device="meta"), \
            make_batch(cfg, small, device="cpu")
        assert {k: (v.shape, v.dtype) for k, v in mb.items()} == \
            {k: (v.shape, v.dtype) for k, v in cb.items()}
        assert all(v.is_meta for v in mb.values())
    mc, cc = model.init_cache(2, 64, device="meta"), \
        model.init_cache(2, 64, device="cpu")
    flat = lambda t, p="": sum(([(p + k, v)] if torch.is_tensor(v) else
                                flat(v, p + k + "/") for k, v in t.items()),
                               [])
    assert [(k, v.shape, v.dtype) for k, v in flat(mc)] == \
        [(k, v.shape, v.dtype) for k, v in flat(cc)]
    assert torch.equal(torch.random.get_rng_state(), before)


def test_state_specs_adafactor_unfactored_leaf_is_replicated_column():
    """An unfactored Adafactor leaf (a vector) keeps its spec in ``vr``
    and has ``P()`` for ``vc``."""
    cfg, state = _port("dbrx_132b")
    specs = opt.state_specs(sh.param_specs(cfg, PROD, state["params"]),
                            state["params"], OptConfig.for_arch(cfg))
    assert specs["vc"]["final_ln.scale"] == sh.P()
    assert np.prod(state["opt"]["vc"]["final_ln.scale"].shape) == 1


# -- constrain: the identity off a mesh ------------------------------------------


def test_constrain_outside_a_context_returns_its_argument():
    from repro_torch.distributed.axisctx import (constrain, default_rules,
                                                 logical_axis_rules)
    x = torch.zeros(4, 6, 8)
    assert constrain(x, "batch", "seq", "heads") is x
    with logical_axis_rules(PROD, default_rules(PROD)):
        assert constrain(x, "batch", "seq", "heads") is x   # not a DTensor
    assert constrain(x, "batch") is x


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "dbrx_132b", "zamba2_7b",
                                  "falcon_mamba_7b",
                                  "seamless_m4t_large_v2"])
def test_model_outputs_keep_their_bits_under_the_rules(arch):
    """The constrain calls in the models change no bit: the reduced
    model's loss and gradients, and its prefill logits, are the same
    under the production rules as without them."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.axisctx import (default_rules,
                                                 logical_axis_rules)
    cfg = get(arch, reduced=True)
    model = build(cfg)
    lm = model.init(0, device="cpu")
    batch = make_batch(cfg, ShapeConfig("t", 32, 2, "train"), seed=1,
                       device="cpu")

    def run():
        loss, _ = model.loss(lm, batch)
        grads = torch.autograd.grad(loss, list(lm.parameters()))
        logits, _ = model.prefill(lm, batch)
        return [loss.detach(), logits, *grads]

    plain = run()
    with logical_axis_rules(PROD, default_rules(PROD,
                                                shard_activations=True)):
        ruled = run()
    assert all(torch.equal(a, b) for a, b in zip(plain, ruled))
