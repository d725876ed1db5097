"""Per-device cost of one step from the ATen ops it dispatches: FLOPs,
bytes, collective payloads by kind and peak memory.

The port of :mod:`repro.launch.hlo_cost`, which reads XLA's compiled
per-device HLO. Eager PyTorch has no such program: its counterpart is
the sequence of ops that one call of the step dispatches.
:func:`analyze` runs ``run()`` once under a ``TorchDispatchMode`` (on
meta tensors, the CPU or the card) and returns the reference's keys with
its meanings:

  * ``flops``: matrix products and attention by
    ``torch.utils.flop_counter``'s registered formulas, with
    ``FlopCounterMode``'s own rule (an op that has no formula is
    decomposed when it can be), so the count is ``FlopCounterMode``'s;
    on a ``dot`` the reference's ``2 * prod(result) * prod(contracting)``
    is the same number. Other ops count no FLOPs, as in the reference.
  * ``bytes_accessed``: the operand reads plus result writes of every
    dispatched op, except those that move no data: views (the op's
    ``is_view``, and ``_unsafe_view``), ``lift_fresh``, allocations
    (``empty``, ``empty_like``, ``empty_strided``, ``new_empty``,
    ``new_empty_strided``), ``_to_copy`` onto ``meta`` from another
    device, ``wait_tensor`` and metadata queries (sizes, strides,
    ``is_contiguous``, ``prim.device``): the counterpart of the
    reference's exclusion of ``parameter`` / ``constant`` /
    ``get-tuple-element`` / ``tuple`` / ``bitcast``. Eager runs every op
    as a kernel of its own, so there is no fused interior to leave out:
    this is an HBM-traffic proxy of the eager program, not of a fused
    one. A collective counts its payload read and its results written.
  * ``collectives``: the reference's five kinds, each ``{"bytes",
    "count"}``, and their sum ``collective_bytes``. ``bytes`` is this
    rank's operand (the reference's per-device payload, and what
    :data:`repro_torch.distributed.collectives.COLLECTIVES` tallies).
    They are counted where the dispatcher sees them: ``c10d.*`` (what
    ``torch.distributed``'s calls dispatch, whatever the backend,
    ``fake`` included) and ``_c10d_functional.*``. A point-to-point
    ``send`` is a ``collective-permute`` (the receiver's ``recv_``
    counts nothing: the payload is the sender's); ``barrier`` moves
    nothing; any other collective raises.
  * ``peak_bytes``: the most storage bytes alive at once during
    ``run()``, the inputs included. A storage counts once however many
    views point at it, from the op that made it until its last tensor
    dies (autograd's saved tensors count while they live, as on the
    card). ``temp_bytes`` is ``peak_bytes`` less ``input_bytes``: the
    storages of ``inputs`` and any other storage that the step reads
    but did not make. The counterparts of ``memory_analysis()``'s peak
    and ``temp_size_in_bytes``. The card's caching allocator rounds
    each block up to 512 bytes and libraries take workspaces of their
    own, which no dispatched op shows.
  * ``n_ops``: the ops counted in ``bytes_accessed``, kernel launches
    included (in place of ``n_computations``); ``kernels``: each
    hand-written kernel's launches and bytes.

A ``DTensor`` operand is seen here at its global shape (a dispatch mode
runs before the tensor subclass, and the local ops that DTensor then
dispatches do not reach the mode): it counts by its local shard, so the
numbers stay per device.

The hand-written kernels are bound through ``ctypes``, out of the
dispatcher's sight: each wrapper reports its launch
(:func:`repro_torch.kernels._build.report`: its name and the bytes its
kernel reads and writes, as in phase 2's bounds of ``chip_smoke.py``)
and it counts as one op of no FLOPs, as the reference counts a custom
call that holds no dot. On the CPU the kernels' plain versions are
dispatched op by op and counted as such; on the meta device a wrapper
with a stand-in (the selective scan's forward) reports the launch it
stands for and counts none. A wrapper whose ``launches`` counter moves
during ``run()`` with no report makes :func:`analyze` raise.

  from repro_torch.launch import step_cost
  cost = step_cost.analyze(lambda: step(state, batch),
                           inputs=(state, batch))
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten

# sizes, strides and layout queries (FlopCounterMode's own list)
_METADATA = {
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format,
    _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default}

# ops that allocate or alias and move no data
_NO_MOVE = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "_unsafe_view", "lift_fresh",
            "wait_tensor", "_wrap_tensor_autograd"}

# (kind, index of the payload argument) of each collective op by name;
# c10d's ops that take outputs first read their argument 1
_C10D = {
    "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "allreduce_": ("all-reduce", 0), "allreduce_coalesced_":
        ("all-reduce", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1), "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0), "recv_": (None, 0),
    "recv_any_source_": (None, 0), "barrier": (None, 0)}
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "wait_tensor": None,
    "_wrap_tensor_autograd": None}


def kernel_counters() -> Dict[str, Callable]:
    """Every hand-written kernel's wrapper by the name it reports under;
    each counts its launches in ``.launches``."""
    from repro_torch.kernels import bitmap_active, block_agg, fused_fold
    from repro_torch.kernels import grouped_hist, selective_scan
    fns = (block_agg.block_agg, fused_fold.fused_fold,
           grouped_hist.grouped_hist, bitmap_active.active_blocks,
           bitmap_active.active_blocks_multi, bitmap_active.round_select,
           selective_scan.selective_scan, selective_scan.selective_scan_bwd)
    return {f.__name__: f for f in fns}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard here; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree, out=None) -> list:
    """The tensors (DTensors' shards) in ``tree``: an op's arguments,
    keyword arguments or result (nested tuples, lists and dicts; a list
    that starts with a number is a list of sizes and is not walked)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(_local(tree))
        return out
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return out
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(_local(x))
        elif isinstance(x, (tuple, list)):
            if x and not isinstance(x[0], (int, float)):
                _tensors(x, out)
        elif isinstance(x, dict):
            _tensors(x, out)
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _OpInfo(NamedTuple):
    """What the mode does with an op, decided once an op."""
    decompose: bool              # no formula, a composite kernel
    flops: Optional[Callable]    # its FLOP formula
    kind: Optional[str]          # a collective's kind
    payload: int                 # ... and its payload argument
    counted: Optional[bool]      # bytes counted (None: by device)


def _without_dtype(formula: Callable) -> Callable:
    """``formula`` for a product's ``dtype`` overload (``mm`` / ``bmm``
    with ``out_dtype``: a 16-bit GEMM writing float32), which passes the
    dtype where the formula takes none: the same product's FLOPs."""
    def flops(*args, **kwargs):
        return formula(*(a for a in args if not isinstance(a, torch.dtype)),
                       **kwargs)
    return flops


def _op_info(func) -> _OpInfo:
    """Classify ``func``; raises on a collective with no kind here."""
    ns, name = func.namespace, func._overloadpacket.__name__
    kind, payload, quiet = None, 0, False
    if ns == "c10d":
        if name not in _C10D:
            raise NotImplementedError(f"step_cost: no kind for c10d.{name}")
        kind, payload = _C10D[name]
        quiet = kind is None
    elif ns == "_c10d_functional":
        if name not in _FUNCTIONAL:
            raise NotImplementedError(
                f"step_cost: no kind for _c10d_functional.{name}")
        kind = _FUNCTIONAL[name]
        quiet = kind is None
    formula = flop_registry.get(func._overloadpacket)
    if formula is not None and func._overloadname == "dtype":
        formula = _without_dtype(formula)
    dk = torch._C.DispatchKey.CompositeImplicitAutograd
    decompose = (formula is None and func is not torch.ops.prim.device.default
                 and (dk in func.py_kernels
                      or torch._C._dispatch_has_kernel_for_dispatch_key(
                          func.name(), dk)))
    if quiet or func.is_view or name in _NO_MOVE or \
            func is torch.ops.prim.device.default:
        counted = False
    else:
        counted = None if name == "_to_copy" else True
    return _OpInfo(decompose, formula, kind, payload, counted)


def _to_meta(kwargs, ins) -> bool:
    """A ``_to_copy`` onto meta from another device: it only allocates."""
    dev = kwargs.get("device")
    return (dev is not None and torch.device(dev).type == "meta"
            and ins[0].device.type != "meta")


class _Live:
    """Storage bytes alive now, their peak and the inputs' share."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seen: Dict[int, int] = {}
        self._finalizers = []
        self.now = self.peak = self.inputs = 0

    def add(self, tensors, is_input: bool) -> None:
        new = []
        with self._lock:
            for t in tensors:
                st = t.untyped_storage()
                key = id(st)
                if key in self._seen:
                    continue
                n = st.nbytes()
                self._seen[key] = n
                self.now += n
                if is_input:
                    self.inputs += n
                new.append((st, key))
            self.peak = max(self.peak, self.now)
        for st, key in new:
            f = weakref.finalize(st, self._free, key)
            f.atexit = False
            self._finalizers.append(f)

    def _free(self, key: int) -> None:
        with self._lock:
            self.now -= self._seen.pop(key)

    def close(self) -> None:
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()


class _CostMode(TorchDispatchMode):

    def __init__(self):
        super().__init__()
        self.live = _Live()
        self.flops = self.bytes = self.n_ops = 0
        self.colls = {k: {"bytes": 0, "count": 0} for k in COLLECTIVES}
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.stand_ins: Dict[str, int] = {}
        self._info: Dict[object, _OpInfo] = {}

    def kernel(self, name: str, read_bytes: int, write_bytes: int,
               stand_in: bool = False) -> None:
        if stand_in:
            self.stand_ins[name] = self.stand_ins.get(name, 0) + 1
        k = self.kernels.setdefault(name, {"count": 0, "bytes": 0})
        k["count"] += 1
        k["bytes"] += read_bytes + write_bytes
        self.bytes += read_bytes + write_bytes
        self.n_ops += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _op_info(func)
        if info.decompose:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        ins = _tensors(args)
        if kwargs:
            _tensors(kwargs, ins)
        self.live.add(ins, is_input=True)   # only storages not yet seen
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self.live.add(outs, is_input=False)
        if info.flops is not None:
            self.flops += int(info.flops(*args, **kwargs, out_val=out))
        if info.kind is not None:
            payload = _nbytes(_tensors(args[info.payload]))
            self.colls[info.kind]["bytes"] += payload
            self.colls[info.kind]["count"] += 1
            self.bytes += payload + _nbytes(outs)
            self.n_ops += 1
        elif info.counted or (info.counted is None
                              and not _to_meta(kwargs, ins)):
            self.bytes += _nbytes(ins) + _nbytes(outs)
            self.n_ops += 1
        return out


def _inputs(tree) -> list:
    """The tensors of ``tree``: nested dicts, lists and tuples of tensors
    and modules (their parameters and buffers)."""
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _inputs(x)]
    return [_local(tree)] if isinstance(tree, torch.Tensor) else []


def analyze(run: Callable[[], object], inputs=()) -> Dict:
    """The cost of one call of ``run()`` (its result is dropped; keep it
    through a closure). ``inputs`` (tensors, modules, DTensors in nested
    dicts, lists and tuples) are alive from the start. Raises if a
    kernel launched during the call without reporting it."""
    counters = kernel_counters()
    before = {k: f.launches for k, f in counters.items()}
    mode = _CostMode()
    mode.live.add([_local(t) for t in _inputs(inputs)], is_input=True)
    _build.LAUNCH_REPORTS.append(mode.kernel)
    try:
        with mode:
            run()
    finally:
        _build.LAUNCH_REPORTS.remove(mode.kernel)
        mode.live.close()
    for name, f in counters.items():
        launched = f.launches - before[name]
        reported = (mode.kernels.get(name, {}).get("count", 0)
                    - mode.stand_ins.get(name, 0))
        if launched != reported:
            raise RuntimeError(
                f"step_cost: kernel {name} launched {launched} times in "
                f"the call but reported {reported}: its bytes are unknown")
    live = mode.live
    return {
        "flops": mode.flops,
        "bytes_accessed": mode.bytes,
        "collectives": mode.colls,
        "collective_bytes": sum(v["bytes"] for v in mode.colls.values()),
        "peak_bytes": live.peak,
        "temp_bytes": live.peak - live.inputs,
        "input_bytes": live.inputs,
        "n_ops": mode.n_ops,
        "kernels": mode.kernels,
    }
