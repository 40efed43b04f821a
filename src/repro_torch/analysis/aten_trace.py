"""ATen op recording -> basic-block-labeled memory trace and op census:
the port's graph source for ``model/<arch>/<step>`` workloads.

The reference lowers a model step to optimized HLO
(``jax.jit(...).lower().compile().as_text()``) and reads the text with
``analysis/hlo_trace.py`` and ``analysis/hlo_cost.py``.  The port does
not import JAX, so it records its own graph of the same step: every
ATen op that one call of a family's ``prefill`` or ``decode_step``, or
of its ``loss_fn`` and the gradient of that loss (a ``train`` step),
dispatches, seen by a ``TorchDispatchMode``.  The step runs eagerly on
the **CPU**, through the plain versions of the kernels, with weights
from a seed.  This is host analysis, as XLA's abstract lowering is: it
reads a program and touches no card; it is not a device path that
falls back.  The plain path is the like-for-like program, because the
reference lowers its plain-jnp models, which call no Pallas kernel;
on the card the attention and scan kernels are ctypes launches that a
dispatch recorder cannot see.

The trace follows ``hlo_to_trace`` rule for rule, with ATen ops in
place of HLO instructions:

* an op is a basic block named ``"<op>:main"`` (``mm:main``,
  ``_to_copy:main``); Python loops are unrolled, so every layer's ops
  are emitted, the loop scale is 1.0 and no loop is truncated;
* alias and view ops (``view``, ``permute``, ``expand``, ``select``,
  ``slice``, ``t``, ``unsqueeze``, ``detach``, ``_unsafe_view``, ...:
  any op whose schema returns an alias of an input that it does not
  write, or that writes nothing and returns only tensors in its inputs'
  storages) touch nothing,
  as ``bitcast`` and ``get-tuple-element`` do, and neither do the
  allocations ``empty``/``empty_like``/``empty_strided`` nor a scalar
  read (``_local_scalar_dense``);
* a buffer is a tensor storage: every view of one storage reads and
  writes inside that storage's addresses.  While recording, a storage
  is told apart by its data pointer, and every storage seen is held
  alive so that no later one reuses the pointer (on the meta device,
  where storages have no data, by the storage's own identity, and a
  storage is let go when its last tensor dies: see below); buffers are named and
  placed in first-seen order, never by pointer, so that two processes
  give bit-identical traces.  The step's inputs
  (parameters, module buffers, batch, caches) are named after their
  role and are the shared buffers (the entry parameters of
  ``hlo_to_trace``); every other storage is private.  A write into an
  input's storage (the caches' in-place update) is shared too: an
  address keeps one label;
* each op touches at most its first 6 tensor operands, then its
  results (a mutated argument is a result, not an operand), each
  through :class:`~repro_torch.analysis.hlo_trace._TraceState`
  (``granule``, ``refs_cap``): a view emits the refs a buffer of its
  extent would, from the granule holding its first byte; touched bytes
  count every operand's and result's elements times their size;
* emission stops once ``blocks * refs_cap`` passes :data:`MAX_REFS`.

The census returns ``loop_aware_cost``'s keys, so ``op_class_mix``
applies unchanged:

* ``mm``/``bmm``/``addmm``/``baddbmm``: 2 · result elements · the
  contracted extent, exact (``dot``);
* the transcendental class of ``hlo_cost.py`` (exp, log, pow, tanh,
  logistic, sin, cos, sqrt, rsqrt, divide, with the ATen ops that
  lower to them: ``sigmoid``, ``silu``, ``gelu``, ``erf``,
  ``reciprocal``, ``_softmax``, ``_log_softmax``): 1 FLOP and 1
  transcendental per result element;
* reductions (``sum``, ``mean``, ``amax``, ``max``, ``cumsum``, ...):
  4 FLOPs per result element (``reduce``), the reference's estimate;
* copies, gathers and fills (``_to_copy``, ``clone``, ``copy_``,
  ``cat``, ``index``, ``embedding``, ``zeros``, ``arange``, ...): no
  FLOPs;
* every other op is elementwise: 1 FLOP per result element;
* bytes are operands plus results for every op that touches memory.
  An in-place update (``copy_`` into a cache slice, ``index_add_``)
  writes the view it was given, so an update of an input charges the
  payload only, ``hlo_cost.py``'s fused-DUS rule;
* a kernel's meta-device op (``repro_torch::flash_attention``,
  ``repro_torch::ssd_scan``: one op for one launch) is a ``dot`` whose
  FLOPs are the kernel's own count (:data:`repro_torch.kernels.META_OPS`)
  and whose bytes are its operands plus its results, as for any op; the
  plain versions' intermediates (B4's scores) do not exist there.

On the meta device the recording also follows memory: every storage
that an op makes (allocations included) is live from then until its
last tensor dies (autograd's saved tensors included), and
:attr:`Recording.peak_bytes` is the peak of the live bytes of the
storages that are not the step's inputs (the dry-run's ``temp_bytes``).

A partitioned step (DTensors on a ``DeviceMesh``) is recorded per
partition: the recorder steps aside for every op on DTensors (returns
``NotImplemented``), so it sees the ops DTensor runs on this partition's
local shards, and it records nothing that runs under a
``FakeTensorMode`` (DTensor's own shape propagation, at global shapes
and only on a cache miss), so a second recording equals the first.
Every storage it follows is a local one.  A functional collective
(``_c10d_functional.all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single``, and DTensor's
``_dtensor.shard_dim_alltoall``) is an op of kind
``"collective"`` with no FLOPs: its local result bytes and its group's
size give ``recording_cost``'s collective counts, result bytes and
``ici_bytes`` by the reference's ring model
(:func:`repro_torch.analysis.hlo._traffic`).

:func:`largest_results` ranks op results by bytes, as
``analysis/buffers.py::largest_buffers`` ranks instruction results.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.hlo_trace import _Buffer, _TraceState
from repro_torch.kernels import META_OPS
from repro_torch.core.trace.types import LabeledTrace, trace_from_blocks

#: Operands each op touches in the trace (``hlo_to_trace``'s ``[:6]``).
MAX_OPERANDS = 6
#: References after which emission stops (``hlo_to_trace``'s default).
MAX_REFS = 400_000
#: The seed of a model step's weights and inputs.
SEED = 0

_DOT = {"mm", "bmm", "addmm", "baddbmm"}
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log1p", "pow", "tanh",
    "sigmoid", "sin", "cos", "sqrt", "rsqrt", "div", "reciprocal", "silu",
    "gelu", "erf", "softplus", "_softmax", "_log_softmax",
}
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "any", "all", "cumsum", "logsumexp", "var", "var_mean",
}
_MOVE = {
    "_to_copy", "clone", "copy_", "cat", "stack", "index", "index_select",
    "embedding", "gather", "scatter", "index_put_", "slice_scatter",
    "select_scatter", "repeat", "constant_pad_nd", "flip", "roll",
    "zeros", "ones", "full", "arange", "scalar_tensor", "fill_", "zero_",
    "new_zeros", "new_ones", "new_full", "zeros_like", "ones_like",
    "full_like",
}
_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
}
#: Functional collectives (DTensor's all-to-all of one shard dim for
#: another among them) by the HLO names of the reference's census.
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


@dataclass(frozen=True)
class TensorRef:
    """One tensor an op read or wrote: its storage (index in first-seen
    order), the byte offset of its first element and the byte extent it
    spans there, and its own bytes."""

    storage: int
    offset: int
    span: int
    nbytes: int


@dataclass(frozen=True)
class OpEvent:
    op: str
    kind: str       # dot | transcendental | reduce | move | elementwise | collective
    flops: float
    operands: tuple[TensorRef, ...]
    results: tuple[TensorRef, ...]
    #: A collective's group size (0 for any other op).
    group: int = 0


@dataclass
class Recording:
    """The ops of one recorded call, and its storages in first-seen
    order: ``names[i]``, ``sizes[i]`` bytes, ``shared[i]`` (an input)."""

    events: list[OpEvent] = field(default_factory=list)
    names: list[str] = field(default_factory=list)
    sizes: list[int] = field(default_factory=list)
    shared: list[bool] = field(default_factory=list)
    #: Each storage's device type (``"cpu"``, ``"meta"``).
    devices: list[str] = field(default_factory=list)
    seconds: float = 0.0
    #: Peak live bytes of the storages the call made (meta device only).
    peak_bytes: int = 0
    #: A partitioned step's operands gathered for an op that runs on
    #: local shards, ``{"site: shape": count}``
    #: (:func:`repro_torch.dist.sharding.replicated_ops`).
    replicated: dict = field(default_factory=dict)


_SCHEMAS: dict = {}


def _schema(func) -> tuple:
    """``(is_view, written)`` of an op's schema, read once per op: it
    returns an alias of an input and writes none; the ``(position,
    name, keyword-only)`` of each argument it writes."""
    got = _SCHEMAS.get(func)
    if got is None:
        schema = func._schema
        written = tuple((i, a.name, a.kwarg_only)
                        for i, a in enumerate(schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write)
        view = not written and any(r.alias_info is not None
                                   for r in schema.returns)
        got = _SCHEMAS[func] = (view, written)
    return got


def _is_view(func) -> bool:
    """The op returns an alias of an input and writes none."""
    return _schema(func)[0]


def _mutated(func, args, kwargs) -> list:
    """The tensors the op writes in place (``self`` of ``add_``, ``out=``)."""
    out = []
    for i, name, kwarg_only in _schema(func)[1]:
        val = args[i] if i < len(args) and not kwarg_only else kwargs.get(
            name)
        if isinstance(val, torch.Tensor):
            out.append(val)
    return out


def _tensors(obj) -> list:
    """The tensors in an op's arguments or results (nested lists, tuples
    and dicts)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    if isinstance(obj, dict):
        return [t for x in obj.values() for t in _tensors(x)]
    return []


def _key(st) -> int:
    """A storage's identity while it lives: its data pointer, or on the
    meta device (no data) the address of the storage itself."""
    return st._cdata if st.device.type == "meta" else st.data_ptr()


def _aliases_only(out, inputs: list) -> bool:
    """Every result lies in an input's storage (``_unsafe_view``)."""
    given = {_key(t.untyped_storage()) for t in inputs}
    outs = _tensors(out)
    return bool(outs) and all(
        _key(t.untyped_storage()) in given for t in outs)


def _kind(op: str) -> str:
    if op in _DOT:
        return "dot"
    if op in _TRANSCENDENTAL:
        return "transcendental"
    if op in _REDUCE:
        return "reduce"
    if op in _MOVE:
        return "move"
    return "elementwise"


def _flops(kind: str, op: str, tensors: list, results: list) -> float:
    if kind == "dot":
        a = tensors[1] if op in ("addmm", "baddbmm") else tensors[0]
        return 2.0 * results[0].numel() * a.shape[-1]
    elems = float(sum(t.numel() for t in results))
    if kind == "reduce":
        return 4.0 * elems
    if kind == "move":
        return 0.0
    return elems


def _in_fake_mode() -> bool:
    """A ``FakeTensorMode`` is active (DTensor's shape propagation)."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _group_size(args) -> int:
    """The size of a functional collective's process group, by the group
    name it is given."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


def _is_dtensor_type(cls) -> bool:
    return cls.__name__ == "DTensor" and hasattr(cls, "device_mesh")


class _Recorder(TorchDispatchMode):
    def __init__(self, inputs: dict[str, torch.Tensor]):
        super().__init__()
        self.rec = Recording()
        self._index: dict[int, int] = {}
        self._alive: list = []      # storages seen: no address is reused
        self._inputs = {}
        self._live = 0              # bytes of the meta storages alive
        self._tracked: set = set()
        for name, t in inputs.items():
            if _is_dtensor_type(type(t)):
                t = t.to_local()
            st = t.untyped_storage()
            self._inputs.setdefault(_key(st), (name, st))

    def _alloc(self, t: torch.Tensor) -> None:
        """A meta storage the call made is live until its last tensor
        dies; a later storage at its address is another buffer."""
        st = t.untyped_storage()
        key = _key(st)
        if key in self._tracked or key in self._inputs:
            return
        self._tracked.add(key)
        self._live += st.nbytes()
        self.rec.peak_bytes = max(self.rec.peak_bytes, self._live)
        weakref.finalize(st, self._free, key, st.nbytes())

    def _free(self, key: int, nbytes: int) -> None:
        self._live -= nbytes
        self._tracked.discard(key)
        self._index.pop(key, None)

    def _ref(self, t: torch.Tensor) -> TensorRef | None:
        nbytes = t.numel() * t.element_size()
        if nbytes <= 0:
            return None
        st = t.untyped_storage()
        key = _key(st)
        idx = self._index.get(key)
        if idx is None:
            idx = len(self.rec.names)
            self._index[key] = idx
            if st.device.type != "meta":
                self._alive.append(st)
            given = self._inputs.get(key)
            self.rec.names.append(given[0] if given else f"%t{idx}")
            self.rec.sizes.append(st.nbytes())
            self.rec.shared.append(given is not None)
            self.rec.devices.append(st.device.type)
        size = t.element_size()
        last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
        return TensorRef(idx, t.storage_offset() * size, (last + 1) * size,
                         nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented       # DTensor runs it on local shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_fake_mode():
            return out                  # DTensor's shape propagation
        op = func.overloadpacket.__name__
        outs = _tensors(out)
        for t in outs:
            if t.device.type == "meta":
                self._alloc(t)
        if op in _FREE or _is_view(func):
            return out
        written = _mutated(func, args, kwargs)
        inputs = _tensors(args) + _tensors(kwargs)
        if not written and _aliases_only(out, inputs):
            return out          # a view the schema does not mark
        w_ids = {id(w) for w in written}
        in_ids = {id(t) for t in inputs}
        operands = [t for t in inputs if id(t) not in w_ids]
        results = list(written) + [t for t in outs if id(t) not in in_ids]
        group = 0
        if func.namespace == "repro_torch":     # a kernel's meta op
            kind, flops = "dot", META_OPS[op](args, kwargs)
        elif func.namespace in ("_c10d_functional", "_dtensor"):
            if op not in COLLECTIVES:
                raise NotImplementedError(f"collective {func} not counted")
            kind, flops, group = "collective", 0.0, _group_size(args)
        else:
            kind = _kind(op)
            flops = _flops(kind, op, inputs, results or inputs)
        refs_in = tuple(r for r in map(self._ref, operands) if r is not None)
        refs_out = tuple(r for r in map(self._ref, results) if r is not None)
        self.rec.events.append(OpEvent(op, kind, flops, refs_in, refs_out,
                                       group))
        return out


def record(fn, inputs: dict[str, torch.Tensor]) -> Recording:
    """Run ``fn()`` once under the recorder.  ``inputs`` names the
    step's input tensors (their storages are the shared buffers)."""
    mode = _Recorder(inputs)
    t0 = time.perf_counter()
    with mode:
        fn()
    mode.rec.seconds = time.perf_counter() - t0
    return mode.rec


def _view_refs(state: _TraceState, base: int, ref: TensorRef) -> np.ndarray:
    """The refs a buffer of the view's extent emits, from the granule
    holding its first byte (``_TraceState.refs_for`` for a whole
    storage)."""
    g = state.granule
    start = base + (ref.offset // g) * g
    return state.refs_for(_Buffer(start, ref.span, False))


def recording_to_trace(rec: Recording, granule: int = 512,
                       refs_cap: int = 16) -> tuple[LabeledTrace, dict]:
    """The labeled trace of a recording and ``hlo_to_trace``'s info
    (touched bytes, loop scale 1.0, buffer and block counts)."""
    state = _TraceState(granule, refs_cap)
    for ev in rec.events:
        if len(state.blocks) * refs_cap > MAX_REFS:
            break
        addrs, shared_mask = [], []
        for ref in ev.operands[:MAX_OPERANDS] + ev.results:
            shared = rec.shared[ref.storage]
            buf = state.buffer(rec.names[ref.storage],
                               rec.sizes[ref.storage], shared)
            r = _view_refs(state, buf.base, ref)
            addrs.append(r)
            shared_mask.append(np.full(len(r), shared))
            state.touched_bytes += ref.nbytes
        if addrs:
            state.blocks.append((f"{ev.op}:main", np.concatenate(addrs),
                                 np.concatenate(shared_mask)))
    trace = trace_from_blocks(state.blocks)
    return trace, {
        "touched_bytes": state.touched_bytes,
        "loop_scale": 1.0,
        "num_buffers": len(state.buffers),
        "num_blocks": len(state.blocks),
        "granule": granule,
    }


def recording_cost(rec: Recording) -> dict:
    """``loop_aware_cost``'s dict for a recording: FLOPs, bytes and
    transcendentals of every op, and the collectives (none on one
    device) by the reference's names, with their result bytes and
    ``ici_bytes`` (each collective's ring traffic at its group's size,
    :func:`repro_torch.analysis.hlo._traffic`)."""
    from repro_torch.analysis.hlo import _traffic

    flops = nbytes = transcendental = ici = 0.0
    op_flops: dict[str, float] = {}
    counts: dict[str, int] = {}
    coll_bytes: dict[str, float] = {}
    for ev in rec.events:
        flops += ev.flops
        nbytes += sum(r.nbytes for r in ev.operands + ev.results)
        if ev.kind == "collective":
            name = COLLECTIVES[ev.op]
            rb = sum(r.nbytes for r in ev.results)
            counts[name] = counts.get(name, 0) + 1
            coll_bytes[name] = coll_bytes.get(name, 0) + rb
            ici += _traffic(name, rb, ev.group)
        elif ev.kind == "transcendental":
            transcendental += ev.flops
        elif ev.kind in ("dot", "reduce", "elementwise"):
            op_flops[ev.kind] = op_flops.get(ev.kind, 0.0) + ev.flops
    return {
        "flops": flops,
        "bytes": nbytes,
        "ici_bytes": ici,
        "transcendental": transcendental,
        "collective_counts": {k: float(v) for k, v in counts.items()},
        "collective_bytes": {k: float(v) for k, v in coll_bytes.items()},
        "dominant_flop_ops": dict(sorted(
            op_flops.items(), key=lambda kv: -kv[1])[:8]),
    }


def largest_results(rec: Recording, top: int = 8) -> list[dict]:
    """The ``top`` largest op results: ``{"bytes", "op", "name"}``, as
    ``largest_buffers(min_bytes=0)`` ranks instruction results."""
    out = [{"bytes": r.nbytes, "op": ev.op, "name": rec.names[r.storage]}
           for ev in rec.events for r in ev.results]
    out.sort(key=lambda b: -b["bytes"])
    return out[:top]


# --- model steps ---------------------------------------------------------------


def _named_tensors(prefix: str, obj) -> dict[str, torch.Tensor]:
    """Tensors of a batch dict or a (nested) cache tuple by path."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if isinstance(obj, dict):
        items = obj.items()
    elif hasattr(obj, "_fields"):
        items = zip(obj._fields, obj)
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    else:
        return {}
    out = {}
    for key, val in items:
        out.update(_named_tensors(f"{prefix}.{key}", val))
    return out


def _at_length(caches, length: int):
    """``caches`` with every ``length`` field (nested tuples too) set."""
    if not hasattr(caches, "_fields"):
        return caches
    return caches._replace(**{
        f: (length if f == "length" else _at_length(v, length))
        for f, v in zip(caches._fields, caches)})


def step_call(arch_id: str, step: str, device: str = "cpu"):
    """``(fn, inputs)`` for one model step of ``arch_id``'s reduced
    config at the smoke shape (``configs/reduced.py``), on the CPU with
    weights and inputs from :data:`SEED`: ``fn()`` runs ``prefill`` over
    seeded inputs into empty caches, or ``decode_step`` of one seeded
    token at the cache's last position (``max_len - 1``, caches as a
    prefill of that many tokens leaves them; the plain attention reads
    the whole cache whatever the position, as the reference's masked
    decode does), or (``train``, at ``SMOKE_SHAPE``) the family's
    ``loss_fn`` and ``torch.autograd.grad`` of it with respect to every
    parameter: the reference's ``jax.value_and_grad``.  The backward
    runs on the calling thread (CPU tensors), so the recorder sees its
    ops, the remat recomputation of each checkpointed layer among them.
    ``inputs`` names every input tensor: ``params.*`` (parameters and
    module buffers), ``batch.*`` and ``caches.*``.  ``device="meta"``
    gives the same call on the meta device (the dry-run's form: no
    values, one op per kernel launch)."""
    from repro_torch.configs.reduced import (
        SMOKE_DECODE, SMOKE_PREFILL, SMOKE_SHAPE, reduced_arch,
    )

    shape = {"prefill": SMOKE_PREFILL, "decode": SMOKE_DECODE,
             "train": SMOKE_SHAPE}.get(step)
    if shape is None:
        raise ValueError(f"no recorded form of step {step!r}")
    spec = reduced_arch(arch_id)
    fam, cfg = spec.family, spec.config
    model = fam.init(cfg, device=device, seed=SEED)
    batch = {k: v.to(device)
             for k, v in spec.example_inputs(shape, seed=SEED).items()}
    inputs = {f"params.{n}": t for n, t in model.named_parameters()}
    inputs.update({f"params.{n}": t for n, t in model.named_buffers()})
    inputs.update(_named_tensors("batch", batch))
    if step == "train":
        model.requires_grad_(True)
        params = list(model.parameters())

        def fn():
            loss = fam.loss_fn(model, batch, cfg)
            return loss, torch.autograd.grad(loss, params)
        return fn, inputs
    ckw = spec.cache_kwargs(shape)
    caches = fam.init_caches(cfg, **ckw, device=device)
    if step == "prefill":
        def fn():
            return fam.prefill(model, batch, cfg, caches)
    else:
        length = ckw["max_len"] - 1
        caches = _at_length(caches, length)

        def fn():
            return fam.decode_step(model, batch, cfg, caches, length)
    inputs.update(_named_tensors("caches", caches))
    return fn, inputs


def record_model_step(arch_id: str, step: str,
                      device: str = "cpu") -> Recording:
    """The recording of one model step (:func:`step_call`)."""
    fn, inputs = step_call(arch_id, step, device)
    return record(fn, inputs)
