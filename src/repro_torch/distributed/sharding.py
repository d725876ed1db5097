"""Sharding rules: parameter / optimizer / batch / cache placement specs.

The port of :mod:`repro.distributed.sharding`, rule for rule. Posture:
DP + FSDP over the flattened ``("pod", "data")`` axes (ZeRO-3:
parameters and optimizer state sharded over dp), TP / EP over
``"model"``. Every rule is checked for divisibility against the mesh: an
axis that does not divide its dim falls back (a list of candidates a
dim, the first that divides wins) or to replication, never to an error.

A spec is a :class:`P`: one entry a dim, each ``None``, a mesh axis name
or a tuple of names (a dim sharded over several axes); fewer entries
than dims leave the rest replicated, as JAX's ``PartitionSpec`` does.
The rules read only the mesh's axis names and sizes
(:func:`axis_sizes`), so a ``DeviceMesh`` and a size-only stand-in both
work.

Parameters are the port's flat names (``dict(lm.named_parameters())``).
A layer's tensor (``layers.<i>.<rest>``, the hybrid's
``layers.<g>.<i>.<rest>``, ``tail_layers``, ``enc_layers``,
``dec_layers``) has no stack dims, so it takes the reference's spec of
its stacked leaf without the leading ``None``s; the rules key on the
name's last part and on whether it lies under ``moe``.

Placement (:func:`placements`, :func:`distribute`, which takes the place
of the reference's ``named``): a spec becomes one
DTensor placement a mesh dim, ``Shard(d)`` where dim ``d``'s entry names
the axis, else ``Replicate()``. **Order of a dim sharded over several
axes:** DTensor's, mesh-dim-major: with ``("data", "model")`` mesh dims,
the rank at ``(d, m)`` holds chunk ``d * n_model + m`` of such a dim
whatever the order of the names in the spec's tuple. The reference's
JAX mesh lays ``("model", "data")`` out model-major (chunk ``m * n_data
+ d``). Local shapes agree, and every collective of the port
(:mod:`repro_torch.train.trainer`'s sharded step, the checkpoints, which
save whole tensors) works from the placements, so only which rank holds
which chunk differs; ``tests/test_torch_sharding.py`` pins it.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeConfig


class P(tuple):
    """A placement spec: ``P(None, ("model", "data"))`` (the port's
    ``PartitionSpec``). A one-name tuple is kept as the name, as JAX
    keeps it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else tuple(p))
            if isinstance(p, (tuple, list)) else p for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def padded(self, ndim: int) -> "P":
        """This spec with ``None`` up to ``ndim`` entries."""
        return P(*(tuple(self) + (None,) * (ndim - len(self))))


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names`` and
    its shape tuple) or of a stand-in with ``axis_names`` and a
    ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def mesh_dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def _axes(want) -> Tuple[str, ...]:
    if want is None:
        return ()
    return (want,) if isinstance(want, str) else tuple(want)


def _axis_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _axes(axes))


def _div(dim: int, mesh, axes) -> bool:
    return dim % max(_axis_size(mesh, axes), 1) == 0


# base rank of each named leaf (the reference's; extra leading dims are
# the reference's layer stacks, which the port's tensors do not have)
_BASE_RANK = {
    "embed": 2, "lm_head": 2,
    "wq": 2, "wk": 2, "wv": 2, "wo": 2,
    "bq": 1, "bk": 1, "bv": 1,
    "q_norm": 1, "k_norm": 1,
    "scale": 1, "bias": 1,
    "w_gate": 2, "w_up": 2, "w_down": 2,
    "router": 2,
    "in_proj": 2,
    "in_x": 2, "in_z": 2, "in_B": 2, "in_C": 2, "in_dt": 2,
    "conv_w": 2, "conv_b": 1,
    "conv_x_w": 2, "conv_x_b": 1, "conv_B_w": 2, "conv_B_b": 1,
    "conv_C_w": 2, "conv_C_b": 1,
    "proj_dt": 2, "proj_B": 2, "proj_C": 2,
    "dt_proj": 2, "dt_bias": 1, "A_log": None, "D": 1,
    "norm_scale": 1, "out_proj": 2,
}


def _spec_fallback(mesh, shape, wants) -> P:
    """Per-dim candidate lists: the first candidate that divides wins."""
    out = []
    for dim, options in zip(shape, wants):
        got = None
        for want in options:
            if want is None:
                break
            if _div(dim, mesh, want):
                got = want
                break
        out.append(got)
    return P(*out)


def _param_rule(cfg: ArchConfig, mesh, path: Tuple[str, ...], shape) -> P:
    """ZeRO-3 placement, the reference's: FSDP (dp) on the OUTPUT dims
    of projections, so that the step gathers weights rather than
    all-reducing activations; contraction dims sharded only over
    "model", where the TP reduction is meant (wo / w_down / out_proj).
    Each dim carries a fallback list, ``[(model+dp), model, None]`` and
    the like: the first divisible candidate wins."""
    dp = mesh_dp_axes(mesh)
    md = tuple(["model"] + list(dp))  # combined model+dp shard
    name = path[-1]
    in_moe = "moe" in path
    base = _BASE_RANK.get(name)
    if name == "A_log":
        base = 2 if cfg.ssm_kind == "mamba1" else 1
    if base is None:
        return P()
    if in_moe and name in ("w_gate", "w_up", "w_down"):
        base = 3
    stack = len(shape) - base
    tail = shape[stack:]
    kv_ok = _div(cfg.n_kv_heads, mesh, "model")

    OUT = [md, "model", dp, None]          # output-dim preference
    rules = {
        "embed": (["model", None], [dp, None]),
        "lm_head": ([None], OUT),
        "wq": ([None], OUT),
        "wk": ([None], (OUT if kv_ok else [dp, None])),
        "wv": ([None], (OUT if kv_ok else [dp, None])),
        "bq": (["model", None],),
        "bk": ((["model", None] if kv_ok else [None]),),
        "bv": ((["model", None] if kv_ok else [None]),),
        "wo": (["model"], [dp, None]),
        "router": ([None], [None]),
        "in_proj": ([None], [dp, None]),
        "in_x": ([None], OUT),
        "in_z": ([None], OUT),
        "in_B": ([None], ["model", None]),
        "in_C": ([None], ["model", None]),
        "in_dt": ([None], ["model", None]),
        "conv_w": ([None], ["model", None]),
        "conv_x_w": ([None], ["model", None]),
        "conv_B_w": ([None], ["model", None]),
        "conv_C_w": ([None], ["model", None]),
        "proj_dt": (["model"], [dp, None]),
        "proj_B": (["model"], [None]),
        "proj_C": (["model"], [None]),
        "dt_proj": ([None], OUT),
        "out_proj": (["model"], [dp, None]),
    }
    for nm in ("conv_b", "conv_x_b", "conv_B_b", "conv_C_b", "D",
               "dt_bias", "norm_scale"):
        rules[nm] = (["model", None],)
    if in_moe:
        rules["w_gate"] = (["model"], [None], [dp, None])
        rules["w_up"] = (["model"], [None], [dp, None])
        rules["w_down"] = (["model"], [None], [dp, None])
    else:
        rules["w_gate"] = ([None], OUT)
        rules["w_up"] = ([None], OUT)
        rules["w_down"] = (["model"], [dp, None])
    if name == "A_log":
        rules["A_log"] = ((["model", None], [None]) if base == 2
                          else (["model", None],))

    want = rules.get(name)
    if want is None:
        want = tuple([None] for _ in tail)
    want = tuple(want[:len(tail)])
    want = want + tuple([None] for _ in range(len(tail) - len(want)))
    spec = _spec_fallback(mesh, tail, want)
    return P(*([None] * stack + list(spec)))


# a layer index in a port name: ``layers.3.attn.wq``, ``layers.1.2.ln``
_INDEX = re.compile(r"\d+")


def param_path(name: str) -> Tuple[str, ...]:
    """The reference's tree path of a port parameter name: its parts
    without the layer indices (``layers.3.moe.w_up`` -> ``("layers",
    "moe", "w_up")``)."""
    return tuple(p for p in name.split(".") if not _INDEX.fullmatch(p))


def _named_shapes(params) -> Dict[str, Tuple[int, ...]]:
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {n: tuple(p.shape) for n, p in params.items()}


def stacked_axes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """The reference's leading stack axes of each stacked subtree:
    ``layers`` ``(n_layers,)``; the hybrid's ``layers`` ``(n_groups,
    period)`` and ``tail_layers`` ``(tail,)``; the enc-dec's
    ``enc_layers`` and ``dec_layers``."""
    if cfg.family == "hybrid":
        period = cfg.hybrid_attn_period
        n_groups = cfg.n_layers // period
        return {"layers": (n_groups, period),
                "tail_layers": (cfg.n_layers - n_groups * period,)}
    if cfg.family == "encdec":
        return {"enc_layers": (cfg.enc_layers,),
                "dec_layers": (cfg.n_layers,)}
    return {"layers": (cfg.n_layers,)}


def param_spec(cfg: ArchConfig, mesh, name: str, shape) -> P:
    """The spec of the port's parameter ``name``: the reference's rule on
    its stacked leaf (the layer's shape behind the stack's axes), less
    the stack's entries. (No rule of the ten configs shards a stack
    axis; arctic's dense residual ``moe.dense.w_*`` takes the expert rule
    there, as in the reference, and its layer axis does not divide.)"""
    top, _, rest = name.partition(".")
    lead = stacked_axes(cfg).get(top, ()) if rest[:1].isdigit() else ()
    spec = _param_rule(cfg, mesh, param_path(name),
                       tuple(lead) + tuple(shape))
    return P(*tuple(spec.padded(len(lead) + len(shape)))[len(lead):])


def param_specs(cfg: ArchConfig, mesh, params) -> Dict[str, P]:
    """``{name: spec}`` for an LM / EncDec module or a ``{name: tensor
    or shape-holder}`` mapping (:func:`param_spec`)."""
    return {n: param_spec(cfg, mesh, n, shape)
            for n, shape in _named_shapes(params).items()}


# -- batches / caches ----------------------------------------------------------


def batch_axis(mesh, global_batch: int):
    """Largest dp prefix that divides the batch (long_500k has B = 1)."""
    dp = mesh_dp_axes(mesh)
    if _div(global_batch, mesh, dp):
        return dp
    if "data" in dp and global_batch % axis_sizes(mesh)["data"] == 0:
        return ("data",)
    return None


def batch_specs(cfg: ArchConfig, mesh, shape: ShapeConfig,
                specs: Mapping) -> Dict[str, P]:
    """Specs of the input batch, by input name (``specs``' values are
    tensors or :class:`repro_torch.models.zoo.TensorSpec`)."""
    ba = batch_axis(mesh, shape.global_batch)
    out = {}
    for k, s in specs.items():
        nd = len(s.shape)
        if k == "pos" or nd == 0:
            out[k] = P()
        else:
            out[k] = P(*([ba] + [None] * (nd - 1)))
    return out


def cache_specs(cfg: ArchConfig, mesh, shape: ShapeConfig,
                cache_tree: Mapping) -> Dict:
    """Decode-cache specs, the tree of ``cache_tree``. Attention KV:
    batch -> dp; heads -> model when the kv heads divide, else sequence
    -> model. SSM states: channels / heads -> model."""
    ba = batch_axis(mesh, shape.global_batch)
    kv_ok = _div(cfg.n_kv_heads, mesh, "model")

    def fixed(leaf, base: int, spec):
        nd = leaf.dim()
        stack = nd - base
        dims = tuple(leaf.shape[stack:])
        return P(*([None] * stack
                   + [s if s and _div(d, mesh, s) else None
                      for d, s in zip(dims, spec)]))

    def rule(name: str, leaf):
        if name in ("k", "v"):                 # (stack..., B, S, K, hd)
            spec = ([ba, None, "model", None] if kv_ok
                    else [ba, "model", None, None])
            return fixed(leaf, 4, spec)
        if name in ("conv", "conv_x", "conv_B", "conv_C"):
            return fixed(leaf, 3, [ba, None, "model"])
        if name == "h":
            # mamba1 (B, din, n) | mamba2 (B, nh, hd, n)
            base = 3 if cfg.ssm_kind == "mamba1" else 4
            return fixed(leaf, base, [ba, "model"] + [None] * (base - 2))
        if name == "memory":
            return P(ba, None, None)
        return P(*([None] * leaf.dim()))

    def walk(tree):
        return {k: walk(v) if isinstance(v, Mapping) else rule(k, v)
                for k, v in tree.items()}

    return walk(cache_tree)


def activation_spec(mesh, shape: ShapeConfig) -> P:
    """Residual-stream constraint used when cfg.shard_activations is on."""
    ba = batch_axis(mesh, shape.global_batch)
    return P(ba, None, "model")


# -- placement -------------------------------------------------------------------


def placements(mesh, spec: Sequence) -> Tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``):
    for each mesh dim ``Shard(d)`` if dim ``d``'s entry names its axis,
    else ``Replicate()``. Raises on an axis the mesh lacks or one named
    twice."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(axis_sizes(mesh))
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in "
                                 f"{names}")
            if a in dim_of:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in names)


def local_shape(mesh, spec: Sequence, shape: Sequence[int]
                ) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor (every rank's:
    each spec'd axis divides its dim)."""
    shape = tuple(int(s) for s in shape)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _axis_size(mesh, entry)
        if out[d] % n:
            raise ValueError(f"dim {d} of {shape} does not divide over "
                             f"{entry} ({n})")
        out[d] //= n
    return tuple(out)


def shard_slices(mesh, spec: Sequence, shape: Sequence[int],
                 coord: Sequence[int]) -> Tuple[slice, ...]:
    """The index of the shard that the rank at mesh coordinate ``coord``
    holds, in DTensor's mesh-dim-major order (the module docstring)."""
    sizes = axis_sizes(mesh)
    names = tuple(sizes)
    pos = {a: c for a, c in zip(names, coord)}
    loc = local_shape(mesh, spec, shape)
    out = [slice(None)] * len(shape)
    for d, entry in enumerate(spec):
        axes = [a for a in names if a in _axes(entry)]   # mesh order
        if not axes:
            continue
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + pos[a]
        out[d] = slice(idx * loc[d], (idx + 1) * loc[d])
    return tuple(out)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(s), 1)
    return tuple(reversed(stride))


def from_local(mesh, spec: Sequence, local: torch.Tensor,
               shape: Sequence[int]):
    """A DTensor of global ``shape`` whose shard here is ``local`` (no
    communication; every rank must pass its own shard)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def distribute_leaf(mesh, spec: Sequence, t: torch.Tensor):
    """The DTensor of ``t`` laid out by ``spec``, every rank holding the
    same full ``t`` (no communication: each keeps its own slice, a copy).
    A meta tensor gives a meta shard of the local shape."""
    spec = P(*spec).padded(t.dim())
    if t.device.type == "meta":
        local = torch.empty(local_shape(mesh, spec, t.shape),
                            dtype=t.dtype, device="meta")
    else:
        coord = mesh.get_coordinate()
        local = t.detach()[shard_slices(mesh, spec, t.shape,
                                        coord)].contiguous()
        # a contiguous slice (a leaf cut on its first dim) is a view of
        # t's storage: copy it, or the shard keeps the whole leaf alive
        if local.untyped_storage().data_ptr() == \
                t.untyped_storage().data_ptr():
            local = local.clone()
    return from_local(mesh, spec, local, tuple(t.shape))


def distribute(mesh, spec_tree, tree):
    """``tree`` (nested dicts of tensors; a module stands for its
    ``named_parameters()``) with every leaf laid out on ``mesh`` by the
    matching spec of ``spec_tree`` (:func:`distribute_leaf`): the
    counterpart of the reference's ``named`` shardings put to use."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, Mapping):
        if not isinstance(spec_tree, Mapping) or \
                set(spec_tree) != set(tree):
            raise ValueError(f"spec tree keys {sorted(spec_tree)} are not "
                             f"the state's {sorted(tree)}")
        return {k: distribute(mesh, spec_tree[k], v) for k, v in tree.items()}
    return distribute_leaf(mesh, spec_tree, tree)


def spec_of(mesh, placements_, ndim: int) -> P:
    """The spec of DTensor ``placements_`` on ``mesh`` (the inverse of
    :func:`placements`; a dim cut over several axes lists them in mesh
    order)."""
    names = tuple(axis_sizes(mesh))
    parts = [[] for _ in range(ndim)]
    for a, pl in zip(names, placements_):
        if pl.is_shard():
            parts[pl.dim % ndim].append(a)
    return P(*(tuple(p) if p else None for p in parts))


#: local bytes gathered in one all-gather by :func:`full_tensors`
GATHER_CHUNK_BYTES = 256 << 20


def full_tensors(dts: Sequence, out: Optional[list] = None) -> list:
    """The whole tensor of each DTensor of ``dts`` (all on one mesh that
    spans the default group), on every rank: all-gathers of the shards
    (:mod:`repro_torch.distributed.collectives`; leaves of one dtype
    together, up to :data:`GATHER_CHUNK_BYTES` of this rank's a call),
    then each distinct shard put in its place once (replicas hold the
    same bits), in new tensors or in ``out``'s (of the global
    shapes)."""
    out = [None] * len(dts) if out is None else list(out)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(dts):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        chunk, size = [], 0
        for i in idx:
            chunk.append(i)
            loc = dts[i].to_local()
            size += loc.numel() * loc.element_size()
            if size >= GATHER_CHUNK_BYTES or i == idx[-1]:
                _gather_into(dts, chunk, out)
                chunk, size = [], 0
    return out


def _gather_into(dts: Sequence, idx: list, out: list) -> None:
    from repro_torch.distributed.collectives import all_gather
    locs = [dts[i].to_local().detach() for i in idx]
    every = all_gather(torch.cat([t.reshape(-1) for t in locs]))
    mesh = dts[idx[0]].device_mesh
    order = mesh.mesh.reshape(-1)
    if not torch.equal(order, torch.arange(order.numel())):
        every = every[order.to(every.device)]      # mesh-major rows
    lo = 0
    for j, i in enumerate(idx):
        t = dts[i]
        if out[i] is None:
            out[i] = torch.empty(tuple(t.shape), dtype=t.dtype,
                                 device=locs[j].device)
        n = locs[j].numel()
        with torch.no_grad():
            _place(every[:, lo:lo + n], t, out[i])
        lo += n


def _place(rows: torch.Tensor, t, dst: torch.Tensor) -> None:
    """Every rank's shard of DTensor ``t`` (``rows``, one a rank in the
    mesh's row-major order) put in its place in ``dst`` in one copy:
    each distinct shard once (a dim replicated over a mesh dim takes the
    last rank's copy, as a copy a rank would leave it; replicas hold
    the same bits). The source, viewed as (mesh dims..., local dims),
    goes into ``dst`` viewed as each dim split into its mesh chunks
    (mesh-dim-major, DTensor's order) and its local part."""
    mesh_shape = tuple(t.device_mesh.mesh.shape)
    local = tuple(t.to_local().shape)
    src = rows.reshape(*mesh_shape, *local)
    by_dim = [[] for _ in local]
    for m, pl in enumerate(t.placements):
        if pl.is_shard():
            by_dim[pl.dim % len(local)].append(m)
    cut = [m for ms in by_dim for m in ms]
    # the replicated mesh dims: the last index
    src = src[tuple(slice(None) if m in cut else -1
                    for m in range(len(mesh_shape)))]
    kept = [m for m in range(len(mesh_shape)) if m in cut]  # src's order
    split, where = [], {}
    for d, ms in enumerate(by_dim):
        for m in ms:
            where[m] = len(split)
            split.append(mesh_shape[m])
        where[("local", d)] = len(split)
        split.append(local[d])
    perm = [where[m] for m in kept] + [where[("local", d)]
                                        for d in range(len(local))]
    dst.view(split).permute(perm).copy_(src)
