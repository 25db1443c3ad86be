"""Roofline terms of one step, counted per device while the step runs on
local shards.

    compute term    = FLOPs_per_device / PEAK_FLOPS
    memory term     = bytes_per_device / HBM_BW
    collective term = wire_bytes_per_device / (links * LINK_BW)

The reference compiles each step with XLA and reads the compiler's cost
and memory analysis, and parses the collectives out of the partitioned HLO.
The port has no compiler in the loop: the dry run (``launch/dryrun.py``)
runs the step once on DTensors whose local shards are ``FakeTensorMode``
tensors, under ``StepRecorder``, a dispatch mode that sits below DTensor:
it lets every DTensor op through to DTensor and sees the ops DTensor runs
on the local shards, which are the ops one device runs.

- FLOPs: each local op counted as XLA's ``HloCostAnalysis`` counts it,
  which is what the reference's ``cost_analysis()`` reports
  (``op_cost``): the matrix products and attention ops by the rules of
  ``torch.utils.flop_counter`` (an op outside its table is decomposed first,
  as ``FlopCounterMode`` does); one FLOP per output element of an
  elementwise op (add, mul, compare, select, convert, max, ...; an op that
  XLA expands, such as the logistic or the tanh GELU, its expansion's
  count); a reduction's input elements less its outputs; the
  transcendentals (exp, log, tanh, logistic, sqrt, rsqrt, pow, ...) one per
  output element in a field of their own, left out of the FLOPs; and 0 for
  views, copies, gathers, scatters and index ops (a scatter-add its adds);
  an all-reduce or a reduce-scatter one add per element of its result.
  The products alone are kept as ``product_flops``: a step run on one device
  under ``FlopCounterMode`` counts the same. A ``FlopCounterMode`` above
  DTensor would count the global op (a product sharded 32 ways on its rows
  counts 32 times one device's work).
- Bytes: the local inputs' and outputs' bytes of every op that computes
  (views and allocations move none), op by op, unfused. XLA's ``bytes
  accessed`` counts a fused step, so this figure runs above the reference's.
- Collectives: the ``_c10d_functional`` ops DTensor issues when it
  redistributes a tensor (all-gather, all-reduce, reduce-scatter,
  all-to-all, DTensor's own shard-dim all-to-all): the output's local bytes
  and the group's size, through the reference's ring formulas
  (``wire_bytes``):
      all-gather      out * (g-1)/g
      all-reduce      2 * out * (g-1)/g
      reduce-scatter  out * (g-1)          (operand = out*g)
      all-to-all      out * (g-1)/g
      collective-permute  out
- Memory: ``argument_bytes`` and ``output_bytes`` are the local bytes of
  the step's arguments and outputs; ``temp_bytes`` the peak of the local
  storages live during the step (tracked by storage finalisers, autograd's
  saved tensors included) less the arguments and less the outputs that are
  not arguments (XLA's temp space excludes both); ``alias_bytes`` the
  arguments the step updates in place and hands back (the port's
  optimizers and KV caches write into their arguments, where the
  reference's XLA aliases only what a step donates). The peak is the
  reference's argument + output + temp - alias.

Where an op has no DTensor sharding rule, ``REPLICATED_OPS`` gives it one
that replicates every operand and output (``register_replicated_ops``): the
counterpart of GSPMD gathering an operand, and the gathers it implies are
counted as any other collective.

The constants are an NVIDIA H100 SXM5 80GB's at 700 W, from NVIDIA's H100
Tensor Core GPU datasheet: 989.4 TFLOP/s dense BF16 (the 1,979 with 2:4
sparsity halved), 3.35 TB/s of HBM3, and 900 GB/s of NVLink 4 per card,
450 GB/s per direction, counted as one link. That link is optimistic for a
group that spans more than one 8-card NVLink domain, where traffic crosses
the network between nodes; one constant is kept, as the reference keeps
one.
"""
from __future__ import annotations

import gc
import os
import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989.4e12        # dense BF16 FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
LINK_BW = 450e9              # NVLink 4 bytes/s per direction per card

# ops with no DTensor sharding rule (in torch 2.13, or in the card host's
# 2.11), given one that replicates everything: the segment sums of
# ``models/segment_ops`` over whole rows (a molecule batch's readout, a
# replicated index's gather backward; rows sharded as their index are summed
# shard by shard and reach none of these), their backward and the scatter
# of the sums into their rows (2.11), and the MoE's token repeat (2.11)
REPLICATED_OPS: tuple[str, ...] = (
    "segment_reduce.default", "_segment_reduce_backward.default",
    "index_copy.default", "index_copy_.default",
    "repeat_interleave.self_int")


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)
    wire_bytes: float = 0.0
    by_kind: dict = field(default_factory=dict)

    def add(self, kind: str, b: float):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + b
        self.wire_bytes += b


def wire_bytes(kind: str, out_bytes: float, g: int) -> float | None:
    """Ring-algorithm wire bytes per participant of one collective whose
    output holds ``out_bytes`` on each of ``g`` ranks; None where the
    reference counts nothing (a group of one)."""
    if g <= 1 and kind != "collective-permute":
        return None
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    return out_bytes


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_dev: float
    bytes_per_dev: float
    wire_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float
    useful_ratio: float          # MODEL_FLOPS / (FLOPs_per_dev * n_dev)
    mem_per_dev_gb: float
    collectives: dict
    counts: dict
    product_flops_per_dev: float = 0.0
    transcendentals_per_dev: float = 0.0
    wire_by_kind: dict = field(default_factory=dict)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_ms": round(self.compute_s * 1e3, 3),
            "memory_ms": round(self.memory_s * 1e3, 3),
            "collective_ms": round(self.collective_s * 1e3, 3),
            "bottleneck": self.bottleneck,
            "useful_ratio": round(self.useful_ratio, 3),
            "mem_gb": round(self.mem_per_dev_gb, 2),
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "wire_bytes_per_dev": self.wire_bytes_per_dev,
            "counts": self.counts,
            "product_flops_per_dev": self.product_flops_per_dev,
            "transcendentals_per_dev": self.transcendentals_per_dev,
            "wire_by_kind": self.wire_by_kind,
        }


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops that allocate or describe and move no bytes
_NO_BYTES = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.lift_fresh.default,
    _aten._local_scalar_dense.default, _aten.detach.default,
    _aten.alias.default,
}
# local collective op name -> the reference's kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}


# elementwise ops XLA counts as transcendentals, one per output element
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sqrt", "rsqrt", "pow", "erf", "erfc", "erfinv", "sin", "cos", "tan",
    "asin", "acos", "atan", "atan2", "sinh", "cosh", "asinh", "acosh",
    "atanh", "lgamma", "digamma"})
# (FLOPs, transcendentals) per output element of the elementwise ops that
# XLA expands (the logistic, the tanh GELU, the fused multiply-adds) or
# that the port's autograd runs where jax's runs a select; every other
# pointwise op is (1, 0) and a transcendental (0, 1)
_PER_ELEMENT = {
    "sigmoid": (3, 1), "silu": (4, 1), "gelu": (8, 1),
    "sigmoid_backward": (3, 0), "tanh_backward": (4, 0),
    "silu_backward": (9, 1), "gelu_backward": (20, 1),
    "threshold_backward": (2, 0), "addcmul": (2, 0), "addcdiv": (3, 0),
    "lerp": (3, 0), "clone": (0, 0)}
# the scatters that accumulate: one add per element of their updates (the
# tensor argument at this position)
_SCATTER_ADDS = {"embedding_dense_backward": 0, "index_add": 3,
                 "scatter_add": 3, "index_put": 2}
_PRODUCTS_WITH_BIAS = {"addmm", "baddbmm", "addbmm", "addmv"}


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def op_cost(func, args, kwargs, outs) -> tuple[int, int]:
    """(FLOPs, transcendentals) of one local op that is not a product, as
    XLA's ``HloCostAnalysis`` counts the HLO it lowers to (see the module's
    docstring); (0, 0) for an op that moves data only."""
    name = func._overloadpacket.__name__.rstrip("_")
    ins = [a for a in args if isinstance(a, torch.Tensor)]
    n_out = _numel(outs[0]) if outs else 0
    if name in _PRODUCTS_WITH_BIAS:
        return n_out, 0                    # the product's added operand
    if name in ("_to_copy", "copy"):       # a convert, where types differ
        src = ins[-1] if name == "copy" else ins[0]
        return (n_out if outs and src.dtype != outs[0].dtype else 0), 0
    if name in _SCATTER_ADDS:
        if name == "index_put" and not (
                kwargs.get("accumulate") or (len(args) > 3 and args[3])):
            return 0, 0
        pos = _SCATTER_ADDS[name]
        return (_numel(args[pos]) if len(args) > pos else 0), 0
    n_in = _numel(ins[0]) if ins else 0
    if name in ("_softmax", "_log_softmax"):       # max, sub, exp, sum, div
        rows = n_in // max(1, args[0].shape[args[1]]) if n_in else 0
        logs = rows if name == "_log_softmax" else 0
        return 4 * n_in - 2 * rows, n_in + logs
    if name == "_softmax_backward_data":   # y * (g - sum(g * y))
        rows = n_in // max(1, args[0].shape[args[2]]) if n_in else 0
        return 4 * n_in - rows, 0
    if name == "_log_softmax_backward_data":   # g - exp(y) * sum(g)
        rows = n_in // max(1, args[0].shape[args[2]]) if n_in else 0
        return 3 * n_in - rows, n_in
    if name == "segment_reduce":
        return max(0, n_in - n_out), 0
    if torch.Tag.reduction in func.tags:
        if name == "logsumexp":
            return 3 * n_in + 2 * n_out, n_in + n_out
        if name == "linalg_vector_norm":
            return 2 * n_in - n_out, n_out
        if name == "mean":
            return n_in, 0
        return max(0, n_in - n_out), 0
    if torch.Tag.pointwise in func.tags:
        if name in _PER_ELEMENT:
            f, t = _PER_ELEMENT[name]
            return f * n_out, t * n_out
        if name == "pow" and isinstance(args[-1], int):
            return n_out, 0                # an integer power: products
        if name in _TRANSCENDENTAL:
            return 0, n_out
        return n_out, 0
    return 0, 0


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree of lists, tuples and dicts, in order (no
    recursive closure: its reference cycle would keep them alive until the
    cyclic GC ran)."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(reversed(x))
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
    return out


def local_tensors(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``, a DTensor's local shard in its place."""
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_permute(args) -> bool:
    """Whether an ``all_to_all_single``'s split sizes send every rank's
    tensor to one rank and receive one rank's: a collective-permute
    (``funcol.permute_tensor``'s form; its wire is the tensor's bytes)."""
    outs, ins = args[1], args[2]
    return (isinstance(outs, (list, tuple)) and isinstance(ins, (list, tuple))
            and sum(1 for n in outs if n) <= 1
            and sum(1 for n in ins if n) <= 1)


def _group_size(name: str, args) -> int:
    """The size of the group named by the op's last string argument (its
    ``group_name``; a reduce op's name comes before it)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    if not names:
        raise ValueError(f"collective {name}: no group in its arguments")
    return _resolve_process_group(names[-1]).size()


def _in_dtensor() -> bool:
    """Whether DTensor's own code is on the call stack (it computes its
    layouts with small real tensors of its own)."""
    import torch.distributed.tensor as dtensor
    root = os.path.dirname(dtensor.__file__)
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.startswith(root):
            return True
        f = f.f_back
    return False


class StepRecorder(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live storages of the ops run on
    local tensors (see the module's docstring).

    ``fake_mode``: the ``FakeTensorMode`` of the step's tensors, or None
    for real tensors; an op under another fake mode, or on its tensors
    (DTensor's own shape propagation), is not the device's work and is not
    counted. An op of the step on no fake tensor (``torch.zeros``,
    ``torch.tensor``) runs in ``fake_mode`` and makes a fake tensor; DTensor's
    own bookkeeping on small real tensors stays real and is not counted.
    """

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.product_flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.coll = CollectiveStats()
        self._live: dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- storages ------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key not in self._live:
            n = st.nbytes()
            self._live[key] = (weakref.ref(st, lambda _, k=key: self._drop(k)),
                               n)
            self.live_bytes += n
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
        return key

    def _drop(self, key: int) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[1]

    def storages(self, tensors) -> dict[int, int]:
        """id -> bytes of the distinct storages of ``tensors`` (tracked)."""
        out = {}
        for t in tensors:
            out[self._track(t)] = t.untyped_storage().nbytes()
        return out

    # -- dispatch ------------------------------------------------------------
    def _foreign(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        return any(isinstance(t, FakeTensor) and t.fake_mode is not
                   self.fake_mode for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs it on the local shards
        active = torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE)
        if active is not None and active is not self.fake_mode:
            return func(*args, **kwargs)     # DTensor's shape propagation
        ns = func.namespace
        if (ns == "aten" and func not in flop_registry
                and func._overloadpacket not in flop_registry):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        ins = _tensors((args, kwargs))
        if (self.fake_mode is not None and active is None
                and not any(isinstance(t, FakeTensor) for t in ins)):
            if _in_dtensor():
                return func(*args, **kwargs)   # DTensor's own bookkeeping
            with self.fake_mode:     # the step's new tensors: fake ones
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        if self._foreign(ins + outs):
            return out
        if ns in ("_c10d_functional", "_dtensor"):
            name = func._overloadpacket.__name__
            kind = _COLLECTIVES.get(name)
            if name == "all_to_all_single" and _is_permute(args):
                kind = "collective-permute"
            if kind is not None:
                wire = wire_bytes(kind, sum(map(_nbytes, outs)),
                                  _group_size(name, args))
                if wire is not None:
                    self.coll.add(kind, wire)
                    if kind in ("all-reduce", "reduce-scatter"):
                        # HloCostAnalysis: one add per result element
                        self.flops += sum(map(_numel, outs))
            for t in outs:
                self._track(t)
            return out
        if ns != "aten":
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.product_flops += n
            self.flops += n
        f, t = op_cost(func, args, kwargs, outs)
        self.flops += f
        self.transcendentals += t
        if not func.is_view and func not in _NO_BYTES:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._track(t)
        return out


@dataclass
class StepRecord:
    """What one recorded step counted, per device: ``flops`` as XLA's cost
    analysis counts them, ``product_flops`` the matrix products' alone."""
    flops: float
    bytes: float
    coll: CollectiveStats
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int
    product_flops: float = 0.0
    transcendentals: float = 0.0

    @property
    def peak_bytes(self) -> int:
        return (self.argument_bytes + self.output_bytes + self.temp_bytes
                - self.alias_bytes)


def record_step(step_fn, args: tuple, *,
                fake_mode=None) -> tuple[StepRecord, object]:
    """Run ``step_fn(*args)`` once under a ``StepRecorder``, plain tensors
    taken as replicated DTensors; return (its record, its outputs).

    ``fake_mode`` (the mode of the arguments' fake local shards) is not
    entered around the step: the recorder makes the step's new tensors in
    it, and DTensor's shape propagation, finding no fake mode active, runs
    in a fake mode of its own, whose global-shape tensors are not counted.
    """
    from torch.distributed.tensor.experimental import implicit_replication
    gc.collect()
    rec = StepRecorder(fake_mode)
    arg_st = rec.storages(local_tensors(args))
    gc.disable()             # storages die at their last reference,
    try:                     # at the same op on every run
        with implicit_replication(), rec:
            out = step_fn(*args)
    finally:
        gc.enable()
    out_st = rec.storages(local_tensors(out))
    new_out = sum(n for k, n in out_st.items() if k not in arg_st)
    temp = max(0, rec.peak_bytes - sum(arg_st.values()) - new_out)
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    return StepRecord(flops=float(rec.flops), bytes=float(rec.bytes),
                      coll=rec.coll, argument_bytes=sum(arg_st.values()),
                      output_bytes=sum(out_st.values()), temp_bytes=temp,
                      alias_bytes=alias,
                      product_flops=float(rec.product_flops),
                      transcendentals=float(rec.transcendentals)), out


def register_replicated_ops() -> None:
    """Give every op of ``REPLICATED_OPS`` a DTensor strategy that
    replicates its operands and outputs (once a process)."""
    global _REGISTERED
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.experimental import register_sharding
    for name in REPLICATED_OPS:
        packet, overload = name.split(".")
        op = getattr(getattr(torch.ops.aten, packet), overload)
        n_out = len(op._schema.returns)

        def strategy(*args, _n_out=n_out, **kwargs):
            ins = [Replicate() if isinstance(a, DTensorSpec) else None
                   for a in args]
            ins += [Replicate() for a in kwargs.values()
                    if isinstance(a, DTensorSpec)]
            return [([Replicate()] * _n_out, ins)]
        register_sharding(op)(strategy)
    _REGISTERED = True


_REGISTERED = False


# ---------------------------------------------------------------------------
# the reference's roofline arithmetic
# ---------------------------------------------------------------------------

def extract_raw(record: StepRecord) -> dict:
    """Per-device (flops, bytes, wire bytes, per-kind breakdown; the
    products' FLOPs and the transcendentals beside them)."""
    return {
        "flops": float(record.flops),
        "product_flops": float(record.product_flops),
        "transcendentals": float(record.transcendentals),
        "bytes": float(record.bytes),
        "wire_bytes": record.coll.wire_bytes,
        "by_kind": dict(record.coll.by_kind),
        "counts": dict(record.coll.counts),
    }


def extrapolate_raw(raw1: dict, raw2: dict, n_layers: int) -> dict:
    """Linear layer-count extrapolation from two probes (L=1, L=2):
    t(L) = t(1) + (t(2) - t(1)) * (L - 1). Exact for homogeneous stacks —
    embedding / loss / optimizer are the intercept."""
    L = n_layers
    out = {}
    for k in ("flops", "product_flops", "transcendentals", "bytes",
              "wire_bytes"):
        if k in raw1:
            out[k] = max(0.0, raw1[k] + (raw2[k] - raw1[k]) * (L - 1))
    kinds = set(raw1["by_kind"]) | set(raw2["by_kind"])
    out["by_kind"] = {k: max(0.0, raw1["by_kind"].get(k, 0.0)
                             + (raw2["by_kind"].get(k, 0.0)
                                - raw1["by_kind"].get(k, 0.0)) * (L - 1))
                      for k in kinds}
    out["counts"] = {k: int(max(0, raw1["counts"].get(k, 0)
                                + (raw2["counts"].get(k, 0)
                                   - raw1["counts"].get(k, 0)) * (L - 1)))
                     for k in set(raw1["counts"]) | set(raw2["counts"])}
    return out


def memory_gb(record: StepRecord) -> float:
    return record.peak_bytes / 2.0**30


def roofline_from_raw(raw: dict, *, arch: str, shape: str, mesh_name: str,
                      n_dev: int, model_flops: float, mem_gb: float,
                      links: int = 1) -> Roofline:
    compute_s = raw["flops"] / PEAK_FLOPS
    memory_s = raw["bytes"] / HBM_BW
    collective_s = raw["wire_bytes"] / (links * LINK_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / max(raw["flops"] * n_dev, 1.0)
    return Roofline(arch=arch, shape=shape, mesh=mesh_name,
                    flops_per_dev=raw["flops"], bytes_per_dev=raw["bytes"],
                    wire_bytes_per_dev=raw["wire_bytes"],
                    compute_s=compute_s, memory_s=memory_s,
                    collective_s=collective_s, bottleneck=bottleneck,
                    model_flops_total=model_flops, useful_ratio=useful,
                    mem_per_dev_gb=mem_gb,
                    collectives={k: round(v / 2**20, 2)
                                 for k, v in raw["by_kind"].items()},
                    counts=raw["counts"],
                    product_flops_per_dev=raw.get("product_flops", 0.0),
                    transcendentals_per_dev=raw.get("transcendentals", 0.0),
                    wire_by_kind=dict(raw["by_kind"]))


def analyze(record: StepRecord, *, arch: str, shape: str, mesh_name: str,
            n_dev: int, model_flops: float, links: int = 1) -> Roofline:
    raw = extract_raw(record)
    return roofline_from_raw(raw, arch=arch, shape=shape, mesh_name=mesh_name,
                             n_dev=n_dev, model_flops=model_flops,
                             mem_gb=memory_gb(record), links=links)
