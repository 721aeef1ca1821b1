"""Roofline analysis from a traced step — the counterpart of
``repro/analysis/roofline.py``.

Three terms per (arch x shape) cell, all in seconds:

    compute    = FLOP / (chips x peak FLOP/s)
    memory     = bytes / (chips x HBM rate)
    collective = collective bytes / (chips x link rate x links)

The reference compiles each cell and walks the optimized HLO, multiplying
while-loop bodies by their trip counts. The port has no compiler: its
counterpart of "lower without allocating" is to run the cell's step on the
``meta`` device under :class:`TraceRecorder`, a ``TorchDispatchMode`` that
records every aten op the step executes, with each hand-written kernel's
meta entry (``kernels/build.py:meta_call``) in place of its launch. That
trace stands for the optimized HLO. It is flat, since the step's Python
loops run, so no trip count is parsed; identical records are merged with a
count ``n``.

Costs counted per record, following the reference's rules so that both
count the same work:
  flops       : dots (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
                ``addmv``, ``dot``: 2 x output elements x the contracted
                dim), convolutions (the reference's approximation), each
                kernel's ``cost``
  bytes       : output bytes of the ops that move data; views (an output
                on an input's storage) count 0; in-place updates
                (``copy_`` into a part of a buffer, ``index_copy_``,
                ``index_put_``, ``scatter_``, ``slice_scatter`` and their
                kin) 2 x the update, not the buffer; each kernel's
                ``cost``
  collectives : output bytes of the functional c10d collectives (x2 for
                an all-reduce); a one-device trace has none
"""
from __future__ import annotations

import gzip
import json
import math
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.perfmodel import H100_SXM, HardwareProfile, ModelCost
from repro_torch.kernels import build

DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
               "float8_e4m3fn": 1, "float8_e5m2": 1, "int64": 8,
               "int32": 4, "int16": 2, "int8": 1, "uint8": 1, "bool": 1,
               "complex64": 8, "complex128": 16}

# op -> index of the operand whose last dim is contracted
DOTS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "vdot": 0, "addmm": 1,
        "baddbmm": 1, "addmv": 1}
CONVS = ("convolution", "_convolution", "convolution_backward")
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single", "broadcast")
# in-place updates: op -> the argument holding the update
UPDATES = {"index_copy_": 3, "index_copy": 3, "index_add_": 3,
           "index_add": 3, "slice_scatter": 1, "select_scatter": 1}
SCATTERS = ("scatter_", "scatter", "scatter_add_", "scatter_add",
            "scatter_reduce_", "scatter_reduce")
INDEX_PUTS = ("index_put_", "index_put", "_index_put_impl_")
# factories that allocate without writing
FREE = ("empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided")


def _nbytes(sig) -> int:
    shape, dtype = sig
    return math.prod(shape) * DTYPE_BYTES[dtype]


_DTYPE_NAMES: Dict[torch.dtype, str] = {}


def _sig(t: torch.Tensor) -> tuple:
    name = _DTYPE_NAMES.get(t.dtype)
    if name is None:
        name = _DTYPE_NAMES[t.dtype] = str(t.dtype).removeprefix("torch.")
    return tuple(t.shape), name


def _arg_sig(a):
    if isinstance(a, torch.Tensor):
        return _sig(a)
    if isinstance(a, (list, tuple)) and any(isinstance(x, torch.Tensor)
                                            for x in a):
        return tuple(_arg_sig(x) for x in a)
    return None


def _base(op: str) -> str:
    """``aten.mm.default`` -> ``mm``; ``_c10d_functional.all_reduce.default``
    -> ``all_reduce``."""
    return op.split(".")[1]


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_counts: Dict[str, int] = field(default_factory=dict)

    def __add__(self, o):
        cc = dict(self.coll_counts)
        for k, v in o.coll_counts.items():
            cc[k] = cc.get(k, 0) + v
        return Cost(self.flops + o.flops, self.bytes + o.bytes,
                    self.coll_bytes + o.coll_bytes, cc)

    def scale(self, k: float):
        return Cost(self.flops * k, self.bytes * k, self.coll_bytes * k,
                    {n: int(v * k) for n, v in self.coll_counts.items()})


def _update_elems(rec) -> int:
    """Elements an ``index_put_`` writes: the broadcast index shape times
    the dims the indices leave whole."""
    shape = rec["args"][0][0]
    indices = rec["args"][1]
    idx_shapes = [s[0] for s in indices if s is not None]
    whole = [d for i, d in enumerate(shape)
             if i >= len(indices) or indices[i] is None]
    bshape = torch.broadcast_shapes(*idx_shapes) if idx_shapes else ()
    return math.prod(bshape) * math.prod(whole)


def _conv_flops(rec) -> float:
    """The reference's approximation: 2 x output elements x sqrt(kernel
    elements); a backward counts its input and weight gradients so."""
    if _base(rec["op"]) == "convolution_backward":
        grad_out, inp, weight = (rec["args"][i] for i in range(3))
        return sum(2.0 * math.prod(o[0]) * max(math.prod(k[0]), 1) ** 0.5
                   for o, k in zip(rec["outs"][:2], (weight, grad_out)))
    return 2.0 * math.prod(rec["outs"][0][0]) \
        * max(math.prod(rec["args"][1][0]), 1) ** 0.5


def record_cost(rec) -> Cost:
    """The cost of one trace record, ``n`` times."""
    n = rec.get("n", 1)
    if "kernel" in rec:
        return Cost(rec["flops"], rec["bytes"]).scale(n)
    op = _base(rec["op"])
    out_b = sum(_nbytes(s) for s in rec["outs"])
    c = Cost()
    if op in COLLECTIVES:
        c.coll_bytes = out_b * (2 if op == "all_reduce" else 1)
        c.coll_counts = {op: 1}
        c.bytes = out_b
    elif op in DOTS:
        lhs = rec["args"][DOTS[op]][0]
        c.flops = 2.0 * math.prod(rec["outs"][0][0]) * (lhs[-1] if lhs else 1)
        c.bytes = out_b
    elif op in CONVS:
        c.flops = _conv_flops(rec)
        c.bytes = out_b
    elif op in UPDATES:
        c.bytes = 2 * _nbytes(rec["args"][UPDATES[op]])
    elif op in SCATTERS:
        c.bytes = 2 * math.prod(rec["args"][2][0]) \
            * DTYPE_BYTES[rec["args"][0][1]]
    elif op in INDEX_PUTS:
        c.bytes = 2 * _update_elems(rec) * DTYPE_BYTES[rec["args"][0][1]]
    elif op == "copy_":
        c.bytes = 2 * out_b if rec.get("part") else out_b
    elif not (rec.get("alias") or op in FREE):
        c.bytes = out_b
    return c.scale(n)


def analyze_records(records: Iterable[dict]) -> Cost:
    total = Cost()
    for rec in records:
        if "op" in rec or "kernel" in rec:
            total = total + record_cost(rec)
    return total


def read_trace(path: str) -> List[dict]:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return [json.loads(line) for line in f if line.strip()]


def analyze_file(path: str) -> Cost:
    return analyze_records(read_trace(path))


def kernel_calls(records: Iterable[dict]) -> Counter:
    """Kernel entries by name, as ``build.LAUNCHES`` counts launches."""
    out: Counter = Counter()
    for rec in records:
        if "kernel" in rec:
            out[rec["kernel"]] += rec.get("n", 1)
    return out


def _flat_tensors(values) -> list:
    """The tensors among an aten op's arguments or results: each is a
    tensor, a list or tuple of them (or of None), or not a tensor."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


_MUTATES: Dict[object, bool] = {}
_OP_NAMES: Dict[object, str] = {}


def _op_name(func) -> str:
    name = _OP_NAMES.get(func)
    if name is None:
        name = _OP_NAMES[func] = str(func)
    return name


def _mutates(func) -> bool:
    """Whether the op writes one of its arguments (in place, or ``out=``)."""
    if func not in _MUTATES:
        _MUTATES[func] = any(a.alias_info is not None and a.alias_info.is_write
                             for a in func._schema.arguments)
    return _MUTATES[func]


class TraceRecorder(TorchDispatchMode):
    """Records every aten op executed inside it, and each kernel's meta
    entry, into ``records`` (identical records merged, ``n`` counting
    them), and follows the bytes of live intermediates: each output
    storage that is not one of ``arguments``' is live from the op that
    makes it until the last tensor on it is freed. ``peak_bytes`` is the
    most that were live at once (the step's temporaries, its outputs
    included).

    A record: ``op``, ``args`` (each positional argument's [shape, dtype],
    a list of them, or None), ``outs``, and ``mut`` (the op writes an
    argument), ``part`` (a ``copy_`` into part of a buffer) or ``alias``
    (every output on an input's storage: a view)."""

    def __init__(self, arguments=()):
        super().__init__()
        self.records: Dict[tuple, dict] = {}
        self._arguments = {_storage_key(t) for t in _tensors(arguments)}
        self._live: Dict[int, list] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def __enter__(self):
        build.META_SINKS.append(self._add_kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        build.META_SINKS.remove(self._add_kernel)
        return super().__exit__(*exc)

    def _add(self, key: tuple, make) -> None:
        have = self.records.get(key)
        if have is None:
            self.records[key] = dict(make(), n=1)
        else:
            have["n"] += 1

    def _add_kernel(self, entry: dict) -> None:
        self._add(("kernel", json.dumps(entry, sort_keys=True)),
                  lambda: entry)

    def _release(self, key: int) -> None:
        ent = self._live[key]
        ent[1] -= 1
        if ent[1] == 0:
            self.live_bytes -= ent[0]
            del self._live[key]

    def _track(self, outs, in_keys) -> None:
        for o in outs:
            key = _storage_key(o)
            if key in self._arguments:
                continue
            ent = self._live.get(key)
            if ent is None:
                if key in in_keys:
                    continue
                ent = self._live[key] = [o.untyped_storage().nbytes(), 0]
                self.live_bytes += ent[0]
            ent[1] += 1
            weakref.finalize(o, self._release, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _flat_tensors((out,))
        in_keys = {_storage_key(t) for t in _flat_tensors(
            (*args, *kwargs.values()))}
        op = _op_name(func)
        flag = None
        if _mutates(func):
            dst = args[0]
            flag = "part" if op.startswith("aten.copy_.") and dst.numel() \
                * dst.element_size() < dst.untyped_storage().nbytes() \
                else "mut"
        elif outs and all(_storage_key(t) in in_keys for t in outs):
            flag = "alias"
        arg_sigs = tuple(_arg_sig(a) for a in args)
        out_sigs = tuple(_sig(t) for t in outs)

        def make():
            rec = {"op": op, "args": arg_sigs, "outs": out_sigs}
            if flag is not None:
                rec[flag] = 1
            if flag == "part":
                rec["mut"] = 1
            return rec
        self._add((op, arg_sigs, out_sigs, flag), make)
        self._track(outs, in_keys)
        return out

    def cost(self) -> Cost:
        return analyze_records(self.records.values())

    def write(self, path: str) -> None:
        """The trace as gzipped JSON lines, one record a line."""
        with gzip.open(path, "wt") as f:
            for rec in self.records.values():
                f.write(json.dumps(rec) + "\n")


def _tensors(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@dataclass
class Roofline:
    flops: float
    bytes: float
    coll_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float

    def table_row(self) -> dict:
        return {
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "bottleneck": self.bottleneck,
            "model_flops": self.model_flops, "useful_ratio": self.useful_ratio,
        }


def roofline_from_cost(cost: Cost, *, model_flops_per_device: float,
                       hw: HardwareProfile = H100_SXM,
                       n_links: float = 1) -> Roofline:
    """All quantities are PER DEVICE: ``hw``'s peak FLOP/s, HBM rate and
    ``n_links`` of its scale-up fabric."""
    t_c = cost.flops / hw.flops_peak
    t_m = cost.bytes / hw.hbm_bw
    t_x = cost.coll_bytes / (hw.fabric.peak_bw * n_links)
    term = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
               key=lambda kv: kv[1])
    return Roofline(cost.flops, cost.bytes, cost.coll_bytes, t_c, t_m, t_x,
                    term[0], model_flops_per_device,
                    model_flops_per_device / cost.flops if cost.flops else 0.0)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D (train) or 2*N*D (inference), N = active params."""
    n_active = ModelCost.from_config(cfg).n_params
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch          # decode: one token/seq
