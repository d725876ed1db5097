"""Model zoo facade: one uniform API over all the architectures.

  model = build(cfg)
  lm = model.init(seed)                          # the module, on the card
  loss, metrics = model.loss(lm, batch)          # train
  logits, cache = model.prefill(lm, batch)       # inference-prefill
  logits, cache = model.decode(lm, cache, batch) # one decode step
  logits, aux = model.forward(lm, batch)         # teacher-forced forward

The port of :mod:`repro.models.zoo`: the callables keep the reference's
names and argument order, with the module (an ``LM``, or an ``EncDec``
for the enc-dec family) in place of the params pytree. ``init`` and
``init_cache`` take ``device=None``, meaning the card
(:func:`repro_torch.device.resolve_device`), and raise without CUDA
unless ``device="cpu"`` (or ``"meta"``, shapes only) is passed; the
other calls run where the module lives. ``prefill`` and ``decode`` run under ``torch.inference_mode()``.

``loss`` returns the cross-entropy plus the z-loss and the aux term, and
in its metrics the per-token loss *moment state* (count / mean / m2 /
min / max, :func:`repro_torch.core.state.moments_of_batch`): the mergeable
CI state that :class:`repro_torch.evalx.ThresholdMonitor` takes. For the
ssm family its gradient runs through the selective-scan backward kernel
on the ``"pallas"`` path; the dense, vlm, moe, hybrid and enc-dec
families run plain PyTorch (the reference has no kernel there either).
The enc-dec's ``prefill`` returns ``{"memory": ...}`` and its ``decode``
takes ``batch["memory"]`` and returns ``{"self": ...}``.

``input_specs(cfg, shape)`` returns ``(shape, dtype)`` stand-ins for every
model input of a workload shape; ``make_batch`` materializes small
concrete batches from a numpy RNG, the same numbers as the reference's.

On a mesh (the counterparts of the reference's prefill and decode jitted
with ``in_shardings`` from its parameter, batch and cache specs):

  prefill = build_sharded_prefill(model, mesh, pspec, bspec, max_len=S)
  logits, cache = prefill(params, batch)     # this rank's rows and shards
  decode = build_sharded_decode(model, mesh, pspec, bspec, cspec)
  logits, cache = decode(params, cache, batch)

``build_sharded_serve`` builds the two on one held copy of the weights:
each rank's ``"model"`` cut of them, computed on tensor parallel.

``cache_with_room`` puts a prefill's cache in the slots of a longer one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.state import moments_of_batch
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.collectives import (ModelShard, all_gather,
                                                 all_to_all)
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models.layers import compute_dtype

# copies of the reference's coefficients (repro.models.zoo)
Z_LOSS_COEF = 1e-4
MOE_AUX_COEF = 1e-2


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable          # (seed, device=None) -> LM / EncDec module
    loss: Callable          # (module, batch) -> (loss, metrics)
    forward: Callable       # (module, batch) -> (logits, aux)
    prefill: Callable       # (module, batch) -> (logits, cache)
    init_cache: Callable    # (batch_size, max_len, device=None) -> cache
    decode: Callable        # (module, cache, batch) -> (logits, cache)


def _front_len(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.frontend is None or cfg.family == "encdec":
        return 0
    fl = int(seq_len * cfg.frontend_len_frac) // 16 * 16
    return int(min(max(fl, 16), seq_len // 2))


def window_for(cfg: ArchConfig, seq_len: int) -> Optional[int]:
    """Sub-quadratic rule: the hybrid's shared attention switches to a
    sliding window at long-context shapes (DESIGN.md §4.1)."""
    if cfg.family == "hybrid" and cfg.sliding_window and \
            seq_len > 4 * cfg.sliding_window:
        return cfg.sliding_window
    return None


def _ce_loss(logits: torch.Tensor, targets: torch.Tensor, aux: torch.Tensor,
             cfg: ArchConfig):
    """logits f32 (B, T, V); targets int (B, T), -1 = ignore. Returns
    ``(total, metrics)``: the mean token cross-entropy plus the z-loss and
    the aux term, as the reference computes them; the metrics (loss,
    z_loss, aux_loss, tokens and the per-token loss state
    ``loss_ci_state``) are detached."""
    mask = (targets >= 0).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = targets.clamp(min=0).long()
    picked = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = (logz - picked) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    z_loss = Z_LOSS_COEF * ((logz * mask) ** 2).sum() / denom
    total = loss + z_loss + MOE_AUX_COEF * aux
    # the paper's integration: a mergeable CI state over per-token losses
    ci_state = moments_of_batch(nll.detach().reshape(-1),
                                mask.reshape(-1) > 0)
    metrics = {"loss": loss.detach(), "z_loss": z_loss.detach(),
               "aux_loss": aux.detach(), "loss_ci_state": ci_state,
               "tokens": denom}
    return total, metrics


def build(cfg: ArchConfig) -> Model:
    if cfg.family == "encdec":
        return _build_encdec(cfg)
    return _build_lm(cfg)


def _initializer(make, cfg: ArchConfig):
    def init(seed: int = 0, device=None):
        """The module with weights drawn from a generator seeded with
        ``seed`` on ``device`` (the same seed gives other numbers on the
        card than on the CPU). On ``"meta"`` the weights have shapes and
        dtypes only and nothing is drawn."""
        dev = resolve_device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        return make(cfg, gen, dev)
    return init


def _build_lm(cfg: ArchConfig) -> Model:
    init = _initializer(lm_mod.lm_init, cfg)

    def forward(params, batch, window=None):
        return lm_mod.lm_forward(params, cfg, batch["tokens"],
                                 extra_embeds=batch.get("extra_embeds"),
                                 window=window)

    def loss(params, batch, window=None):
        logits, aux = forward(params, batch, window)
        return _ce_loss(logits, batch["targets"], aux, cfg)

    @torch.inference_mode()
    def prefill(params, batch, window=None):
        return lm_mod.lm_prefill(params, cfg, batch["tokens"],
                                 extra_embeds=batch.get("extra_embeds"),
                                 window=window)

    def init_cache(batch_size, max_len, device=None):
        return lm_mod.lm_init_cache(cfg, batch_size, max_len,
                                    resolve_device(device))

    @torch.inference_mode()
    def decode(params, cache, batch, window=None):
        return lm_mod.lm_decode_step(params, cfg, batch["token"],
                                     batch["pos"], cache, window=window)

    return Model(cfg, init, loss, forward, prefill, init_cache, decode)


def _build_encdec(cfg: ArchConfig) -> Model:
    init = _initializer(encdec_mod.encdec_init, cfg)

    def forward(params, batch, window=None):
        return encdec_mod.encdec_forward(params, cfg, batch["frame_embeds"],
                                         batch["tokens"])

    def loss(params, batch, window=None):
        logits, aux = forward(params, batch)
        return _ce_loss(logits, batch["targets"], aux, cfg)

    @torch.inference_mode()
    def prefill(params, batch, window=None):
        """The last position's logits and ``{"memory": encode(...)}``.
        The reference computes the logits of every position and slices
        the last; the head here sees the last position only, which gives
        the same numbers (the norm and the head act a position at a time)
        without the (B, T, vocab) float32 logits: 8.4 GB at 8 x 1024
        positions of seamless-m4t's 256,256-token vocabulary."""
        memory = encdec_mod.encode(params, cfg, batch["frame_embeds"])
        logits = encdec_mod.decode_train(params, cfg, batch["tokens"],
                                         memory, last_only=True)
        return logits, {"memory": memory}

    def init_cache(batch_size, max_len, device=None):
        return encdec_mod.encdec_init_cache(cfg, batch_size, max_len,
                                            resolve_device(device))

    @torch.inference_mode()
    def decode(params, cache, batch, window=None):
        return encdec_mod.encdec_decode_step(params, cfg, batch["token"],
                                             batch["pos"], cache,
                                             batch["memory"])

    return Model(cfg, init, loss, forward, prefill, init_cache, decode)


# -- serving on a mesh --------------------------------------------------------


def cache_with_room(cfg: ArchConfig, cache: Dict, max_len: int) -> Dict:
    """A prefill's cache in the slots of ``init_cache(B, max_len)``: the
    attention KV of the prompt's ``T`` positions (``layers``, the
    hybrid's ``attn``) at slots ``0 .. T-1``, or, in the hybrid's ring
    (``max_len`` 100,000 on), the last ``S`` positions at slot ``p %
    S``; the SSM states and the enc-dec's ``{"memory"}`` as they are."""
    key = "attn" if "attn" in cache else "layers"
    if key not in cache or "k" not in cache[key]:
        return cache
    k = cache[key]["k"]
    B, T = k.shape[-4], k.shape[-3]
    S = lm_mod.lm_init_cache(cfg, B, max_len, "meta")[key]["k"].shape[-3]
    if S == max_len and T > S:            # not a ring: no room
        raise ValueError(f"a prefill of {T} positions does not fit a "
                         f"cache of {max_len}")
    # the prefill's own kv heads (a tensor-parallel rank's cut)
    room = {name: k.new_zeros((*k.shape[:-3], S, *k.shape[-2:]))
            for name in ("k", "v")}
    first = max(T - S, 0)
    pos = torch.arange(first, T, device=k.device)
    for name in ("k", "v"):
        room[name][..., pos % S, :, :] = cache[key][name][..., first:, :, :]
    return {**cache, key: room}


def _model_dim(spec) -> Optional[int]:
    """The dim that a leaf's spec cuts over ``"model"``, counted from the
    leaf's end, or ``None``."""
    spec = tuple(spec)
    return next((d - len(spec) for d, entry in enumerate(spec)
                 if entry is not None and "model" in sh._axes(entry)), None)


def _leaves(tree: Dict):
    """``(name, leaf)`` of every leaf of ``tree`` (nested dicts)."""
    for k, v in tree.items():
        yield from _leaves(v) if isinstance(v, dict) else [(k, v)]


def _map(fn, tree: Dict, *others: Dict) -> Dict:
    """``fn(name, leaf, *the others' leaves)`` over the leaves of
    ``tree`` (nested dicts) and of trees of the same keys."""
    return {k: _map(fn, v, *(o[k] for o in others)) if isinstance(v, dict)
            else fn(k, v, *(o[k] for o in others)) for k, v in tree.items()}


def _owner(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    """The submodule holding parameter ``name`` and its attribute."""
    path, _, attr = name.rpartition(".")
    return (module.get_submodule(path) if path else module), attr


class _ServeOnMesh:
    """What the sharded prefill and decode share: the mesh and its
    groups, this rank's ``"model"`` cut of the parameters in a module
    held here, and this rank's dp slice of a batch."""

    def __init__(self, model: Model, mesh, param_spec: Dict,
                 batch_spec: Dict, window: Optional[int],
                 held: Optional[Dict] = None):
        self.model, self.cfg, self.mesh = model, model.cfg, mesh
        self.param_spec, self.batch_spec = param_spec, batch_spec
        self.window = window
        # the held module, in a holder that the steps of one
        # build_sharded_serve share
        self._held = {} if held is None else held
        sizes = sh.axis_sizes(mesh)
        names = list(sizes)
        self.coord = tuple(mesh.get_coordinate())
        dp = next((sh._axes(s[0]) for s in batch_spec.values()
                   if len(s) and s[0] is not None), ())
        self.batch_groups = tuple(mesh.get_group(a) for a in names
                                  if a in dp and sizes[a] > 1)
        self.n_model = sizes.get("model", 1)
        self.model_index = (self.coord[names.index("model")]
                            if "model" in sizes else 0)
        self.model_group = (mesh.get_group("model") if self.n_model > 1
                            else None)

    @property
    def module(self) -> Optional[nn.Module]:
        """This rank's cut of the parameters (``None`` before the first
        call)."""
        return self._held.get("module")

    def shard(self, cache_spec: Optional[Dict] = None) -> ModelShard:
        """This rank's :class:`ModelShard`, cutting the leaves that
        ``cache_spec`` cuts over ``"model"``."""
        cuts = {name: d for name, s in _leaves(cache_spec or {})
                if (d := _model_dim(s)) is not None}
        return ModelShard(self.model_index, self.n_model, self.model_group,
                          cuts, self.batch_groups, self._held["cut"])

    def load(self, params: Dict) -> nn.Module:
        """The module of this rank's ``"model"`` cut of the parameters:
        on the first call each DTensor of ``params`` is checked against
        its spec and gathered over the dp axes that cut it, its
        ``"model"`` coordinate's shards (:meth:`_model_cut`), into a
        module of those local shapes held here; nothing is all-gathered
        over ``"model"`` (a dim cut over ``"model"`` and dp together is
        put in block order by one all-to-all over ``"model"``:
        :meth:`_model_block`). A leaf the specs leave uncut over
        ``"model"`` (a
        norm, the router, kv projections whose heads do not divide the
        ranks) is held whole; one that no dp axis cuts is this rank's
        shard itself, not a copy. Later calls return the module as it
        is: a server's weights do not change between calls (the
        reference's jitted step gathers over dp on every call)."""
        if self.module is not None:
            return self.module
        for n, p in params.items():
            want = sh.placements(self.mesh, sh.P(*self.param_spec[n]))
            if tuple(p.placements) != want:
                raise ValueError(f"{n} is laid out {p.placements}, not by "
                                 f"its spec {want}")
        names = list(params)
        module = self.model.init(0, device="meta")
        if [n for n, _ in module.named_parameters()] != names:
            raise ValueError("the parameters are not the model's")
        cut = {}
        for n in names:
            owner, attr = _owner(module, n)
            held = nn.Parameter(self._model_cut(n, params[n]),
                                requires_grad=False)
            setattr(owner, attr, held)
            d = _model_dim(sh.P(*self.param_spec[n]).padded(held.dim()))
            if d is not None and self.n_model > 1:
                cut[id(held)] = d
        # the held leaves cut over "model", from the specs alone: what a
        # layer asks of its shard (collectives.cut_for)
        self._held["cut"] = cut
        self._held["module"] = module
        return module

    def _model_cut(self, name: str, p) -> torch.Tensor:
        """This rank's ``"model"`` cut of DTensor ``p``: its shard joined
        with those of the ranks that differ from it only on the dp axes
        cutting a dim (an all-gather an axis, the innermost first, so
        that the chunks fall in DTensor's mesh-dim-major order), then
        each dim cut over ``"model"`` and dp together put in the block
        order of the dims cut over ``"model"`` alone
        (:meth:`_model_block`)."""
        loc = p.to_local()
        spec = sh.P(*self.param_spec[name]).padded(loc.dim())
        sizes = sh.axis_sizes(self.mesh)
        for a in reversed(list(sizes)):
            d = next((d for d, e in enumerate(spec) if a in sh._axes(e)),
                     None)
            if a == "model" or sizes[a] == 1 or d is None:
                continue
            every = all_gather(loc, group=self.mesh.get_group(a))
            loc = torch.cat(every.unbind(0), dim=d)
        for d, e in enumerate(spec):
            axes = [a for a in sizes if a in sh._axes(e)]
            if "model" in axes and len(axes) > 1:
                loc = self._model_block(loc, d, axes)
        return loc

    def _model_block(self, loc: torch.Tensor, d: int, axes) -> torch.Tensor:
        """Dim ``d`` of ``loc``, cut over ``axes`` (mesh order) of which
        ``"model"`` is one and whose dp chunks are gathered, as block
        ``model_index`` of the dim cut ``n_model`` ways: the block that
        the same rank's leaves cut over ``"model"`` alone meet (``wq``'s
        and ``wo``'s heads, ``w_up``'s and ``w_down``'s ff). DTensor
        orders a dim's chunks mesh-dim-major, so with ``"model"`` the
        inner axis the ranks of one ``"model"`` coordinate hold every
        ``n_model``-th chunk; the block's other chunks come from the
        other ``"model"`` ranks (one all-to-all over the ``"model"``
        subgroup, of the bytes held). The reference's mesh orders them
        model-major, where the dp gather is the block."""
        sizes = sh.axis_sizes(self.mesh)
        M = sizes["model"]
        dps = [a for a in axes if a != "model"]
        D = math.prod(sizes[a] for a in dps)

        def chunk(j: int, m: int) -> int:
            """The dim's chunk at dp index ``j``, ``"model"`` coord ``m``."""
            digit = {"model": m}
            for a in reversed(dps):
                j, digit[a] = divmod(j, sizes[a])
            c = 0
            for a in axes:
                c = c * sizes[a] + digit[a]
            return c
        m = self.model_index
        if M == 1 or D == 1 or all(chunk(j, m) == m * D + j
                                   for j in range(D)):
            return loc
        x = loc.movedim(d, 0)
        rows = x.reshape(D, x.shape[0] // D, *x.shape[1:])
        dest = [chunk(j, m) // D for j in range(D)]
        send = sorted(range(D), key=lambda j: (dest[j], j))
        w = rows.shape[1]
        arrive = [chunk(j, s) for s in range(M) for j in range(D)
                  if chunk(j, s) // D == m]
        got = all_to_all(
            rows[send].reshape(x.shape),
            [dest.count(r) * w for r in range(M)],
            [sum(chunk(j, s) // D == m for j in range(D)) * w
             for s in range(M)], group=self.model_group)
        got = got.reshape(rows.shape)[[arrive.index(m * D + j)
                                       for j in range(D)]]
        return got.reshape(x.shape).movedim(0, d).contiguous()

    def local_batch(self, batch: Dict) -> Dict:
        """This rank's dp slice of each entry: a DTensor's shard, a whole
        tensor cut by its spec, anything else as it is."""
        out = {}
        for k, v in batch.items():
            if hasattr(v, "to_local"):
                out[k] = v.to_local()
            elif isinstance(v, torch.Tensor) and v.dim():
                spec = sh.P(*self.batch_spec.get(k, ())).padded(v.dim())
                out[k] = v[sh.shard_slices(self.mesh, spec, v.shape,
                                           self.coord)]
            else:
                out[k] = v
        return out

    def part_of(self, name: str, spec: sh.P,
                local: torch.Tensor) -> torch.Tensor:
        """This rank's shard of prefill cache leaf ``name`` of this
        rank's rows. The layers make their own cut of a leaf's heads or
        channels; the sequence rule's KV (``k`` / ``v`` cut over
        ``"model"`` on the slots, dim -3) is made whole, and its slots
        are narrowed here (a copy, so that the whole leaf can go)."""
        d = _model_dim(spec)
        if self.n_model == 1 or name not in ("k", "v") or d != -3:
            return local
        return self.shard().part(local, d).clone()

    def distributed(self, spec: sh.P, local: torch.Tensor) -> torch.Tensor:
        """``local`` (this rank's shard) as a DTensor of the global
        shape."""
        shape = list(local.shape)
        for d, entry in enumerate(spec):
            if entry is not None:
                shape[d] *= math.prod(sh.axis_sizes(self.mesh)[a]
                                      for a in sh._axes(entry))
        return sh.from_local(self.mesh, spec, local, tuple(shape))


def build_sharded_prefill(model: Model, mesh, param_spec: Dict,
                          batch_spec: Dict, window: Optional[int] = None,
                          max_len: Optional[int] = None) -> Callable:
    """The prefill on a mesh, one rank a device (the counterpart of the
    reference's prefill jitted with ``in_shardings`` from
    ``param_specs`` and ``batch_specs``). Every rank of ``mesh`` (a
    ``DeviceMesh`` over the whole default group) calls
    ``prefill(params, batch)`` with its shards of the parameters, laid
    out by ``param_spec`` (DTensors, :func:`repro_torch.distributed.
    sharding.distribute`), and the same whole ``batch``:

      * the parameters are checked against their specs and this rank's
        ``"model"`` cut of them (gathered over dp only) is held by the
        step in a module of those local shapes on its first call
        (``prefill.load(params)`` does only that); later calls reuse it.
        A server's weights do not change between calls: after they do,
        build a new step;
      * the rank's dp slice of the batch (``batch_spec``; ranks of one dp
        coordinate take the same one, and every rank the whole batch
        where ``batch_axis`` gives ``None``) runs through the prefill
        tensor parallel over the ``"model"`` ranks (``lm_prefill``; the
        enc-dec's encoder and ``decode_train``, with this rank's
        :class:`~repro_torch.distributed.collectives.ModelShard`): each
        layer on its cut of heads, MLP columns, experts, SSM channels or
        vocab, the partial sums added over the ranks, its MoE layers on
        the whole batch's dispatch groups;
      * its cache, given ``max_len`` slots by :func:`cache_with_room`
        when asked (the room to decode into), is this rank's shard by
        ``sharding.cache_specs`` of the whole batch: the layers make
        their cut of heads and channels, and a cache they make whole
        (the sequence rule's KV) is cut inside the call.

    Returns the slice's last-position logits (B_r, 1, V) and the cache
    as DTensors of the global shapes, each holding this rank's shard.
    ``prefill.module`` is the held module; ``prefill.cache_spec`` the
    last call's cache specs. A server that also decodes builds the two
    steps with :func:`build_sharded_serve`, on one held module."""
    return _ShardedPrefill(model, mesh, param_spec, batch_spec, window,
                           max_len)


class _ShardedPrefill(_ServeOnMesh):

    def __init__(self, model, mesh, param_spec, batch_spec, window,
                 max_len, held=None):
        super().__init__(model, mesh, param_spec, batch_spec, window, held)
        self.max_len = max_len
        self.cache_spec = None

    def __call__(self, params: Dict, batch: Dict):
        module = self.load(params)
        cfg = self.cfg
        mine = self.local_batch(batch)
        shard = self.shard()
        with torch.no_grad():
            if cfg.family == "encdec":
                memory = encdec_mod.encode(module, cfg, mine["frame_embeds"],
                                           shard)
                logits = encdec_mod.decode_train(module, cfg, mine["tokens"],
                                                 memory, last_only=True,
                                                 shard=shard)
                cache = {"memory": memory}
            else:
                logits, cache = lm_mod.lm_prefill(
                    module, cfg, mine["tokens"],
                    extra_embeds=mine.get("extra_embeds"),
                    window=self.window, shard=shard)
                if self.max_len is not None:
                    cache = cache_with_room(cfg, cache, self.max_len)
            B = next(v.shape[0] for v in batch.values() if v.dim())
            T = _cache_len(cache)
            # the whole batch's cache (the enc-dec's memory: its spec does
            # not depend on its shape)
            like = (cache if cfg.family == "encdec"
                    else self.model.init_cache(B, T, device="meta"))
            self.cache_spec = sh.cache_specs(
                cfg, self.mesh, ShapeConfig("prefill", T, B, "prefill"),
                like)
            cache = _map(lambda k, v, s: self.part_of(
                k, sh.P(*s).padded(v.dim()), v), cache, self.cache_spec)
        return logits, _map(lambda k, v, s: self.distributed(
            sh.P(*s).padded(v.dim()), v), cache, self.cache_spec)


def _cache_len(cache: Dict) -> int:
    """The slots of a prefill cache's attention KV (0 for one without)."""
    kv = cache.get("attn", cache.get("layers", {}))
    return int(kv["k"].shape[-3]) if "k" in kv else 0


def build_sharded_decode(model: Model, mesh, param_spec: Dict,
                         batch_spec: Dict, cache_spec: Dict,
                         window: Optional[int] = None) -> Callable:
    """One decode step on a mesh, one rank a device (the counterpart of
    the reference's decode jitted with ``in_shardings`` from
    ``param_specs``, ``cache_specs`` and ``batch_specs``). Every rank of
    ``mesh`` calls ``decode(params, cache, batch)`` with its shards of
    the parameters (as :func:`build_sharded_prefill` takes and holds
    them), its shards of the cache (DTensors laid out by ``cache_spec``,
    ``sharding.cache_specs``' rules: batch over dp, kv heads over
    ``"model"`` where they divide and else the sequence, SSM channels
    and heads over ``"model"``) and the same whole batch (a DTensor
    entry, the prefill's ``memory``, is taken as its shard).

    No cache leaf is gathered. Each layer is tensor parallel on its
    cut of the parameters and its shard of the cache
    (:func:`repro_torch.models.attention.decode_attention`,
    :func:`repro_torch.models.ssm.mamba1_decode` / ``mamba2_decode``,
    :func:`repro_torch.models.layers.mlp_apply`,
    :func:`repro_torch.models.moe.moe_apply` with a
    :class:`repro_torch.distributed.collectives.ModelShard`): it adds
    its partial sums over the mesh's ``"model"`` subgroup (an
    all-reduce, whose result every rank gets bit for bit) and
    all-gathers the small activations that need every head or channel,
    merged in rank order, so that every rank of one dp coordinate ends
    with the same bits. Returns the slice's logits (B_r, 1, V) and the
    new cache, laid out as the old."""
    return _ShardedDecode(model, mesh, param_spec, batch_spec, cache_spec,
                          window)


class _ShardedDecode(_ServeOnMesh):

    def __init__(self, model, mesh, param_spec, batch_spec, cache_spec,
                 window, held=None):
        super().__init__(model, mesh, param_spec, batch_spec, window, held)
        self.cache_spec = cache_spec

    def __call__(self, params: Dict, cache: Dict, batch: Dict):
        module = self.load(params)
        cfg = self.cfg

        def local(name, v, spec):
            want = sh.placements(self.mesh, sh.P(*spec))
            if tuple(v.placements) != want:
                raise ValueError(f"cache leaf {name} is laid out "
                                 f"{v.placements}, not by its spec {want}")
            return v.to_local()
        mine = self.local_batch(batch)
        shard = self.shard(self.cache_spec)
        with torch.no_grad():
            loc = _map(local, cache, self.cache_spec)
            if cfg.family == "encdec":
                logits, new = encdec_mod.encdec_decode_step(
                    module, cfg, mine["token"], mine["pos"], loc,
                    mine["memory"], shard=shard)
            else:
                logits, new = lm_mod.lm_decode_step(
                    module, cfg, mine["token"], mine["pos"], loc,
                    window=self.window, shard=shard)
        return logits, _map(lambda k, v, old, s: sh.from_local(
            self.mesh, sh.P(*s), v, tuple(old.shape)), new, cache,
            self.cache_spec)


def build_sharded_serve(model: Model, mesh, param_spec: Dict,
                        batch_spec: Dict, cache_spec: Dict,
                        window: Optional[int] = None,
                        max_len: Optional[int] = None) -> Tuple:
    """``(prefill, decode)``: :func:`build_sharded_prefill` and
    :func:`build_sharded_decode` on one held module, so that a server
    keeps one copy of the weights a rank. ``batch_spec`` holds the
    specs of the prefill's inputs and of the decode's (one global
    batch)."""
    held: Dict = {}
    return (_ShardedPrefill(model, mesh, param_spec, batch_spec, window,
                            max_len, held),
            _ShardedDecode(model, mesh, param_spec, batch_spec, cache_spec,
                           window, held))


# -- input specs / batches ----------------------------------------------------


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (the reference's
    ``jax.ShapeDtypeStruct`` stand-in; no allocation)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """Stand-ins for the step inputs of a workload shape.

    Modality frontends are stubs: the spec supplies precomputed frame /
    patch embeddings directly."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    cdt = compute_dtype(cfg)
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            half = S // 2
            return {"frame_embeds": TensorSpec((B, half, cfg.d_model), cdt),
                    "tokens": TensorSpec((B, half), i32),
                    "targets": TensorSpec((B, half), i32)}
        fl = _front_len(cfg, S)
        spec = {"tokens": TensorSpec((B, S - fl), i32),
                "targets": TensorSpec((B, S), i32)}
        if fl:
            spec["extra_embeds"] = TensorSpec((B, fl, cfg.d_model), cdt)
        return spec
    # decode: one new token against a seq_len-deep cache
    spec = {"token": TensorSpec((B, 1), i32), "pos": TensorSpec((), i32)}
    if cfg.family == "encdec":
        spec["memory"] = TensorSpec((B, cfg.decode_memory_len, cfg.d_model),
                                    cdt)
    return spec


def make_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """Concrete random batch matching :func:`input_specs`, drawn from
    ``np.random.default_rng(seed)`` in the reference's order, so both
    packages get the same tokens. ``device=None`` means the card; on
    ``"meta"`` the batch is shapes and dtypes only, with no draw."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return {k: torch.empty(s.shape, dtype=s.dtype, device=dev)
                for k, s in input_specs(cfg, shape).items()}
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in input_specs(cfg, shape).items():
        if s.dtype == torch.int32 and k in ("tokens", "targets", "token"):
            arr = rng.integers(0, cfg.vocab, size=s.shape).astype(np.int32)
            fl = _front_len(cfg, shape.seq_len)
            if k == "targets" and fl:
                arr[:, :fl] = -1   # no loss on frontend positions
            out[k] = torch.from_numpy(arr).to(dev)
        elif k == "pos":
            out[k] = torch.tensor(shape.seq_len // 2, dtype=torch.int32,
                                  device=dev)
        else:
            out[k] = torch.from_numpy(
                rng.normal(0, 0.02, size=s.shape).astype(np.float32)
            ).to(device=dev, dtype=s.dtype)
    return out
