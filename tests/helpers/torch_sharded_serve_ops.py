"""Commands of a gloo rank for the port's sharded serving steps
(``tests/test_torch_sharded_serve.py``), run by
``tests/helpers/torch_dist_worker.py`` on each rank of a
:class:`tests.helpers.torch_dist_world.DistWorld` (4 CPU ranks).

``op_sharded_serve`` runs one reduced config (float32, or bfloat16 as
served) on a ``("data", "model")`` mesh: the prefill of
``build_sharded_serve`` (with room for the decode steps) and ``STEPS``
teacher-forced steps of its decode from the weights the test saved, beside the single-process
``prefill`` + ``decode`` of the same weights and tokens. Each rank holds
its cache shards to the slices of the single-process cache (local
shapes and values), records the collectives of the one-time load, of
a steady prefill and of a steady decode call (``collectives.tally``),
the bytes of the parameters it holds (its ``"model"`` cut) and the
shape of every collective operand of the decode steps, and returns its
logits and their checksums for the test to hold against the reference
(single-process and partitioned) and across replicas.

``case_config`` and ``PREFILL`` are shared with the test (which builds
the reference's config from the same fields) and with
``tests/helpers/torch_serve_cost_fake.py`` (the meta prediction).

Imports no JAX.
"""

import dataclasses
import zlib

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ShapeConfig, get
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build
from repro_torch.models.zoo import (build_sharded_serve, cache_with_room,
                                    make_batch)

B, T, STEPS = 8, 32, 8
#: a case's prompt: T positions (the enc-dec's frames and tokens T / 2
#: each); it then decodes into a cache of T + STEPS slots (the enc-dec's
#: self cache of STEPS slots; :func:`decode_shape`)
PREFILL = ShapeConfig("serve_prefill", T, B, "prefill")
RING_WINDOW, RING_LEN = 16, 100_000
# per-case config fields: the dtype; 2 kv heads of 4 wherever there is
# attention (a (2, 2) mesh cuts the heads, a (1, 4) mesh the sequence)
KV2 = dict(n_kv_heads=2)


def case_fields(arch: str, ring: bool = False,
                dtype: str = "float32") -> dict:
    """The fields replaced in ``get(arch, reduced=True)`` for a case."""
    fields = dict(param_dtype=dtype, compute_dtype=dtype)
    if arch not in ("falcon_mamba_7b",):
        fields.update(KV2)
    if ring:
        fields.update(sliding_window=RING_WINDOW)
    return fields


def case_config(arch: str, ring: bool = False, dtype: str = "float32"):
    return dataclasses.replace(get(arch, reduced=True),
                               **case_fields(arch, ring, dtype))


def decode_len(cfg, ring: bool = False) -> int:
    """Slots of the decode cache: room for STEPS after the prompt (the
    enc-dec decodes from position 0), or the ring's ``max_len``."""
    if ring:
        return RING_LEN
    return STEPS if cfg.family == "encdec" else T + STEPS


def decode_shape(cfg, ring: bool = False) -> ShapeConfig:
    return ShapeConfig("serve_decode", decode_len(cfg, ring), B, "decode")


def step_tokens(cfg, seed: int = 7) -> np.ndarray:
    """The STEPS teacher-forced decode tokens (B, STEPS)."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, STEPS)).astype(np.int32)


def window_of(ring: bool):
    return RING_WINDOW if ring else None


class _Operands(TorchDispatchMode):
    """The shapes of every collective's operand dispatched inside."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            src = args[1] if func._overloadpacket.__name__.startswith(
                "allgather") else args[0]
            for t in (src if isinstance(src, (list, tuple)) else [src]):
                if isinstance(t, (list, tuple)):
                    self.shapes += [list(x.shape) for x in t]
                elif isinstance(t, torch.Tensor):
                    self.shapes.append(list(t.shape))
        return func(*args, **(kwargs or {}))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _crc(t: torch.Tensor) -> int:
    return zlib.crc32(t.detach().contiguous().reshape(-1).view(
        torch.uint8).numpy().tobytes())


def _hold_shards(mesh, got: dict, want: dict, spec: dict) -> dict:
    """Each cache shard of ``got`` (DTensors) against the slice of the
    single-process cache ``want``: ``{leaf: [local shape ok, max abs
    err, leaf max]}``."""
    flat_spec = dict(_leaves(spec))
    flat_want = dict(_leaves(want))
    out = {}
    for name, t in _leaves(got):
        s = sh.P(*flat_spec[name]).padded(t.dim())
        loc = t.to_local()
        w = flat_want[name][sh.shard_slices(mesh, s, t.shape,
                                            mesh.get_coordinate())]
        shape_ok = (tuple(loc.shape) == sh.local_shape(mesh, s, t.shape)
                    and tuple(t.shape) == tuple(flat_want[name].shape))
        err = float((loc.float() - w.float()).abs().max()) if shape_ok \
            else float("inf")
        out[name] = [shape_ok, err,
                     float(flat_want[name].float().abs().max())]
    return out


def op_sharded_serve(arch: str, mesh_shape, weights: str, ring: bool = False,
                     masked: bool = False, dtype: str = "float32"):
    """One case (the module docstring). ``masked``: no prefill; one
    decode step at position 0 into an empty cache instead (every
    sequence shard but the first fully masked), at an int and at a
    tensor position."""
    cfg = case_config(arch, ring, dtype)
    model = build(cfg)
    lm = model.init(0, device="cpu")
    lm.load_state_dict(torch.load(weights))
    mesh = make_host_mesh(tuple(mesh_shape), ("data", "model"),
                          device_type="cpu")
    pspec = sh.param_specs(cfg, mesh, lm)
    params = sh.distribute(mesh, pspec, lm)
    dshape = decode_shape(cfg, ring)
    S = dshape.seq_len
    window = window_of(ring)
    pre = make_batch(cfg, PREFILL, seed=1, device="cpu")
    pre.pop("targets")
    toks = torch.from_numpy(step_tokens(cfg))
    rec = {"rank": dist.get_rank(), "coord": list(mesh.get_coordinate())}
    # the single-process run of the same weights and tokens
    enc = cfg.family == "encdec"
    start = 0 if enc else T
    meta_cache = model.init_cache(B, S, device="meta")
    cspec = sh.cache_specs(cfg, mesh, dshape, meta_cache)
    dspec = sh.batch_specs(cfg, mesh, dshape, {
        "token": toks[:, :1], "pos": torch.tensor(0),
        **({"memory": torch.empty(B, 1, cfg.d_model)} if enc else {})})
    bspec = sh.batch_specs(cfg, mesh, PREFILL, pre)
    prefill, decode = build_sharded_serve(
        model, mesh, pspec, {**bspec, **dspec}, cspec, window=window,
        max_len=None if enc else S)
    if masked:
        return _masked(rec, model, lm, mesh, cspec, decode, params, toks)
    want_l, want_c = model.prefill(lm, pre, window)
    extra = {}
    if enc:
        extra = {"memory": want_c["memory"]}
        single = model.init_cache(B, S, device="cpu")
    else:
        single = cache_with_room(cfg, want_c, S)
    c0 = coll.tally()
    prefill.load(params)
    rec["load_collectives"] = _since(c0)
    rec["held_bytes"] = sum(t.numel() * t.element_size()
                            for t in prefill.module.parameters())
    c0 = coll.tally()
    got_l, got_c = prefill(params, pre)
    rec["prefill_collectives"] = _since(c0)
    rows = sh.shard_slices(mesh, sh.P(*bspec["tokens"]).padded(2),
                           pre["tokens"].shape, mesh.get_coordinate())[0]
    rec["rows"] = [rows.start or 0, rows.stop if rows.stop is not None
                   else B]
    rec["prefill_err"] = float((got_l - want_l[rows]).abs().max())
    rec["prefill_shards"] = _hold_shards(
        mesh, got_c, want_c if enc else single, prefill.cache_spec)
    if enc:
        cache = sh.distribute(mesh, cspec,
                              model.init_cache(B, S, device="cpu"))
        batch_extra = {"memory": got_c["memory"]}
    else:
        cache = got_c
        batch_extra = {}
    logits, single_logits, operands = [got_l], [want_l], []
    for i in range(STEPS):
        pos = start + i
        tok = toks[:, i:i + 1]
        c0 = coll.tally()
        with _Operands() as ops:
            lg, cache = decode(params, cache, {"token": tok, "pos": pos,
                                               **batch_extra})
        if i == 1:
            rec["decode_collectives"] = _since(c0)
        operands += ops.shapes
        wl, single = model.decode(lm, single, {"token": tok, "pos": pos,
                                               **extra}, window)
        logits.append(lg)
        single_logits.append(wl)
    got = torch.cat(logits, dim=1)
    want = torch.cat(single_logits, dim=1)[rows]
    rec["single_err"] = float((got - want).abs().max())
    rec["single_max"] = float(want.abs().max())
    rec["one_module"] = decode.module is prefill.module
    if dtype == "bfloat16":
        # the single process's logits, and both runs' distance from the
        # float32 run of the same (upcast) weights
        truth = _float32_logits(arch, ring, lm, pre, toks)[rows]
        rec["single_logits"] = want.tolist()
        rec["f32_err"] = float((got - truth).abs().max())
        rec["single_f32_err"] = float((want - truth).abs().max())
    rec["decode_shards"] = _hold_shards(mesh, cache, single, cspec)
    if mesh_shape[1] == 1 and cfg.family == "moe":
        # "model" of one rank; an MoE's dispatch groups span the whole
        # batch (the rank gathers their rows): the full batch's program
        rec["rows_single_err"] = rec["single_err"]
        rec["rows_cache_err"] = max(e for _, e, _ in
                                    rec["decode_shards"].values())
    elif mesh_shape[1] == 1:
        # "model" of one rank: the single process on this rank's rows
        rec["rows_single_err"], rec["rows_cache_err"] = _rows_single(
            model, lm, pre, toks, rows, window, got, cache, extra, start)
    rec["logits"] = got.tolist()
    rec["logits_crc"] = _crc(got)
    rec["shard_crcs"] = {n: [[[s.start, s.stop] for s in sh.shard_slices(
        mesh, sh.P(*dict(_leaves(cspec))[n]).padded(t.dim()), t.shape,
        mesh.get_coordinate())], _crc(t.to_local())]
        for n, t in _leaves(cache)}
    leaf_shapes = set()
    for _, t in _leaves(cache):
        loc = t.to_local()
        for k in range(loc.dim()):
            leaf_shapes.add(tuple(loc.shape[k:]))
    rec["cache_leaf_operands"] = [s for s in operands
                                  if tuple(s) in leaf_shapes]
    rec["n_operands"] = len(operands)
    return rec


def _rows_single(model, lm, pre, toks, rows, window, got, cache, extra,
                 start):
    """The single-process prefill and decode steps on this rank's rows
    alone (a batch of B_r: the port's matmuls of another batch size may
    round otherwise): the largest differences of the rank's logits and
    final cache leaves from that run's."""
    cfg = model.cfg
    mine = {k: v[rows] for k, v in pre.items()}
    lg, c = model.prefill(lm, mine, window)
    if cfg.family == "encdec":
        extra = {"memory": c["memory"]}
        c = model.init_cache(rows.stop - rows.start, decode_len(cfg),
                             device="cpu")
    else:
        c = cache_with_room(cfg, c, decode_len(cfg, window is not None))
    out = [lg]
    for i in range(STEPS):
        lg, c = model.decode(lm, c, {"token": toks[rows, i:i + 1],
                                     "pos": start + i, **extra}, window)
        out.append(lg)
    err = float((got - torch.cat(out, dim=1)).abs().max())
    flat = dict(_leaves(c))
    cache_err = max(float((t.to_local().float() - flat[n].float()).abs()
                          .max()) for n, t in _leaves(cache))
    return err, cache_err


def _float32_logits(arch: str, ring: bool, lm, pre: dict, toks):
    """The single-process prefill + decode logits (B, 1 + STEPS, V) of
    the float32 config on ``lm``'s weights upcast (an LM, not the
    enc-dec)."""
    cfg = case_config(arch, ring, "float32")
    model = build(cfg)
    lm32 = model.init(0, device="cpu")
    lm32.load_state_dict({k: v.float() for k, v in lm.state_dict().items()})
    window = window_of(ring)
    with torch.no_grad():
        lg, cache = model.prefill(lm32, {k: v.float() if v.is_floating_point()
                                         else v for k, v in pre.items()},
                                  window)
        cache = cache_with_room(cfg, cache, decode_len(cfg, ring))
        out = [lg]
        for i in range(STEPS):
            lg, cache = model.decode(lm32, cache, {
                "token": toks[:, i:i + 1], "pos": T + i}, window)
            out.append(lg)
    return torch.cat(out, dim=1)


def _since(c0: dict) -> dict:
    return coll.tally(since=c0)["by_kind"]


def _masked(rec, model, lm, mesh, cspec, decode, params, toks):
    """One decode step at position 0 into an empty cache, an int and a
    0-d tensor position, against the single-process step."""
    S = T + STEPS
    empty = model.init_cache(B, S, device="cpu")
    tok = toks[:, :1]
    want, want_c = model.decode(lm, empty, {"token": tok, "pos": 0})
    rows = sh.shard_slices(mesh, sh.P(*decode.batch_spec["token"]).padded(
        2), tok.shape, mesh.get_coordinate())[0]
    rec["errs"], rec["finite"] = [], []
    for pos in (0, torch.tensor(0, dtype=torch.int32)):
        cache = sh.distribute(mesh, cspec, model.init_cache(B, S,
                                                            device="cpu"))
        lg, new = decode(params, cache, {"token": tok, "pos": pos})
        rec["errs"].append(float((lg - want[rows]).abs().max()))
        rec["finite"].append(bool(torch.isfinite(lg).all()))
        rec["shards"] = _hold_shards(mesh, new, want_c, cspec)
    rec["scale"] = float(want.abs().max())
    rec["cut"] = decode.shard(decode.cache_spec).cuts["k"]
    return rec


OPS = {"sharded_serve": op_sharded_serve}
