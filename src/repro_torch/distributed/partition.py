"""The partitioned serving and train steps' plumbing: what GSPMD does for
the reference, written out for ``torch.distributed``.

The reference jits ``api.prefill`` / ``api.decode_step`` and its train
step under ``in_shardings`` from ``ShardingRules``
(``repro/launch/dryrun.py``) and lets XLA's SPMD partitioner split them. Here every rank of a process group
runs the step itself on its shards (SPMD), and the layers call the
collectives where the partitioner would put them
(``layers/core.py``, ``layers/attention.py``, ``layers/moe.py``):

* :class:`RankContext` — the rank's place on a mesh: its coordinate on
  each axis (``pod``, ``data``, ``model``), the process group of each axis
  (the ranks that share every other coordinate) and the device it runs
  on. ``launch/mesh.py:rank_context`` builds one from an initialised
  process group.
* ``shard_model`` / ``shard_cache`` / ``shard_batch`` — the rank's slices
  of a model, a dense decode cache and a batch, per ``rules.params``,
  ``rules.cache`` and ``rules.batch_spec`` (a train step's batch by
  micro-batch, as the reference splits it). A rank holds exactly the
  shards its specs name (a whole tensor, shared, where the spec splits
  nothing). A sharded module holds its parameters' specs (``pspecs``,
  read by ``pspec``), a cache leaf its own (``pspec``): the layers read
  the split from them.
* ``RankContext.all_reduce`` / ``all_gather`` / ``reduce_scatter`` /
  ``gather`` — the functional collectives (``torch.ops._c10d_functional``,
  each followed by its ``wait_tensor`` off the ``meta`` device), so that a
  trace records one ``_c10d_functional.*`` op a collective
  (``analysis/roofline.py`` counts their bytes), forward and backward.
  ``gather(t, spec)`` un-shards a tensor over the named axes of its spec
  (FSDP's ``data``). ``enter`` and ``split`` move no bytes forward.

The collectives are differentiable (``torch.autograd.Function``s over the
same ops), under one convention: over ``model`` every rank holds the same
loss, and the gradient a rank holds of a tensor replicated over ``model``
is the whole gradient; over the data-parallel axes the global loss is the
mean of the ranks' losses (``reduce_gradients``). Between a collective
that hands a rank its share of the work and the one that combines the
shares, every rank does work of its own (its heads, columns, rows,
positions or vocabulary slice), so the gradient it computes there is its
part of the whole. Hence the backwards:

* ``all_reduce`` (partial sums -> a sum used alike on every rank): the
  gradient passes through unchanged.
* ``enter`` (a replicated tensor, an activation or a weight, consumed by
  the rank's own work): the identity; its gradient is summed over the
  axis.
* ``all_gather`` (shards -> the whole, consumed by the rank's own work:
  the sequence-parallel stream, FSDP's weights, the projections the
  covered attention route gathers): its gradient reduce-scattered (summed,
  each rank keeping its shard's). With ``alike`` (shards -> the whole,
  consumed by work every rank does alike: RWKV-6's channel-mix output, the
  stream an RWKV-6 layer runs whole under sequence parallelism): the
  gradient is the whole one on every rank already, and each keeps its
  shard's block.
* ``reduce_scatter`` (partial sums -> the rank's shard of the sum): its
  gradient all-gathered.
* ``split`` (a replicated tensor -> the rank's shard, consumed by its own
  work): its gradient all-gathered.

``torch.distributed``'s own autograd collectives take the loss to be the
sum of the ranks' losses instead, which over ``model`` would scale the
gradients by its size.

Two more rules keep a layer's work the rank's own. An all-reduced sum
that only the rank's own work consumes enters it again (``enter``:
Mamba's C.h, read by the rank's rows of ``out_proj``). A term every rank
of ``model`` computes alike from replicated inputs and adds to the loss
(the MoE's aux loss, from the router every rank runs whole) takes its
gradient on the group's first rank alone: the shares then sum to it
once.

Collectives run over an axis whenever a spec names it, a group of one
included, so a step issues the same collectives at any mesh size.

Every family the port serves: attention, MLP and MoE layers
(``layers/core.py``, ``layers/attention.py``, ``layers/moe.py``), MLA
(``layers/mla.py``), Mamba (``layers/mamba.py``), RWKV-6 over a key slice
of its state (``layers/rwkv6.py``) and the encoder-decoder
(``models/encdec.py``). It trains every family the same way
(``training/train_loop.py`` with ``TrainConfig.shard_axes``:
``attention_train_sharded``, the split MLP, the expert-parallel
``moe_apply``, ``mla_train_sharded``, ``mamba_train_sharded`` and
``rwkv_train_sharded`` from a zero state that ``shard_state`` splits, the
latter through the key-slice WKV's backward, and the encoder-decoder's
``encdec.forward``), each rank on its rows of the reference's
micro-batches (``shard_batch``): the rank's gradients reduced over the
data-parallel axes by ``reduce_gradients``, its loss by ``dp_mean``.
"""
from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

AXES = ("pod", "data", "model")


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclass
class RankContext:
    """One rank's view of a mesh. ``sizes`` and ``coords`` hold every axis
    of ``AXES`` (an axis the mesh lacks has size 1, coordinate 0);
    ``groups`` the process group of each mesh axis; ``device`` the card
    the rank runs on."""
    rank: int
    sizes: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object] = field(repr=False)
    device: torch.device

    def index(self, entry) -> Tuple[int, int]:
        """The rank's index along a spec entry (None, an axis, or a tuple
        of axes taken row-major) and the number of shards it makes."""
        i, n = 0, 1
        for a in _axes_of(entry):
            i = i * self.sizes[a] + self.coords[a]
            n *= self.sizes[a]
        return i, n

    @property
    def model_n(self) -> int:
        return self.sizes["model"]

    def range(self, entry, local: int) -> Tuple[int, int]:
        """The global [lo, hi) of a dim the rank holds ``local`` entries of
        under spec entry ``entry``."""
        i, _ = self.index(entry)
        return i * local, (i + 1) * local

    # -- collectives (differentiable; the module docstring's convention) --
    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """The group's tensors reduced (``op``: ``"sum"``, or ``"max"`` of a
        tensor that takes no gradient), used alike on every rank."""
        return _AllReduce.apply(t, self.groups[axis], op)

    def all_gather(self, t: torch.Tensor, dim: int, axis: str,
                   alike: bool = False) -> torch.Tensor:
        """The group's tensors concatenated along ``dim`` in rank order.
        With ``alike`` the whole feeds work every rank does alike (its
        gradient the whole one on every rank): the backward keeps the
        rank's block of it."""
        if alike:
            return _AllGatherAlike.apply(t, dim, self.groups[axis])
        return _AllGather.apply(t, dim, self.groups[axis])

    def reduce_scatter(self, t: torch.Tensor, dim: int,
                       axis: str) -> torch.Tensor:
        """The sum of the group's tensors, the rank's block of it along
        ``dim`` (blocks in rank order)."""
        return _ReduceScatter.apply(t, dim, self.groups[axis])

    def enter(self, t: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """``t``, replicated over ``axis``, consumed by the rank's own
        work: ``t`` itself, its gradient summed over the axis."""
        return _Enter.apply(t, self.groups[axis])

    def split(self, t: torch.Tensor, dim: int,
              axis: str = "model") -> torch.Tensor:
        """The rank's block along ``dim`` of ``t``, replicated over
        ``axis``; its gradient all-gathered."""
        return _Split.apply(t, dim, self.groups[axis])

    def gather(self, t: torch.Tensor, t_spec,
               axes=("data",)) -> torch.Tensor:
        """``t`` (a shard under ``t_spec``) all-gathered along every dim
        whose spec names one of ``axes``: FSDP's gather just before use
        with the default, a replicated copy with every axis."""
        out = t
        for d, entry in enumerate(t_spec):
            for a in _axes_of(entry):
                if a in axes:
                    out = self.all_gather(out, d, a)
        return out


def _wait(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result once it has landed. A meta tensor
    has nothing to wait for: its trace records the collective alone."""
    return t if t.is_meta else torch.ops._c10d_functional.wait_tensor(t)


def _all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    return _wait(torch.ops._c10d_functional.all_reduce(
        t, op, group.group_name))


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group.size()
    out = _wait(torch.ops._c10d_functional.all_gather_into_tensor(
        t.contiguous(), n, group.group_name))
    dim %= t.dim()
    shape = list(t.shape)
    shape[dim] *= n
    if all(d == 1 for d in t.shape[:dim]):
        # the ranks' blocks lie in order along dim already
        return out.view(shape)
    return torch.cat(out.chunk(n, 0), dim)


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group.size()
    dim %= t.dim()
    shape = list(t.shape)
    if shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"{n} ways")
    shape[dim] //= n
    if any(d != 1 for d in t.shape[:dim]):
        # the ranks' blocks in order along dim 0
        t = torch.cat(t.chunk(n, dim), 0)
    out = _wait(torch.ops._c10d_functional.reduce_scatter_tensor(
        t.contiguous().reshape(-1), "sum", n, group.group_name))
    return out.view(shape)


def _block(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group.size()
    c = t.shape[dim] // n
    return t.narrow(dim, dist.get_rank(group) * c, c)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, op):
        return _all_reduce(t, group, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _AllGatherAlike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group).contiguous(), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(t, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def pspec(module: nn.Module, name: str):
    """The spec of a sharded module's parameter ``name``."""
    specs = getattr(module, "pspecs", None)
    if specs is None:
        raise ValueError(f"{type(module).__name__} holds no partition specs: "
                         "shard the model with shard_model")
    return specs[name]


def own_slices(local: torch.Tensor, spec, ctx: RankContext,
               dims) -> tuple:
    """Index of the rank's block in a tensor whose dims ``dims`` are
    global (the others are the rank's already, as a batch of its rows):
    dim d the global [lo, lo + n) of the ``n = local.shape[d]`` entries
    ``local`` holds under ``spec``."""
    idx = [slice(None)] * local.dim()
    for d in dims:
        lo, hi = ctx.range(spec[d], local.shape[d])
        idx[d] = slice(lo, hi)
    return tuple(idx)


def splits(spec, axis: str = "model") -> bool:
    """Whether a spec names ``axis`` in any dim."""
    return any(axis in _axes_of(e) for e in spec)


def attn_route(cache_spec) -> str:
    """A KV cache leaf's (G, B, S, K, hd) spec -> the attention layer's
    route: ``"heads"`` (kv-heads split over ``model``: each rank runs its
    own heads), ``"seq"`` (slots split: each rank holds a slot range and
    decode merges partial softmaxes) or ``"replicated"`` (no split over
    ``model``)."""
    if cache_spec[3] == "model":
        return "heads"
    if cache_spec[2] == "model":
        return "seq"
    return "replicated"


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------
def _own(t: torch.Tensor, spec, ctx: RankContext,
         copy_whole: bool = False) -> torch.Tensor:
    """The rank's block of ``t`` under ``spec``: a copy of its own where
    the spec splits a dim (or ``copy_whole``), else ``t``'s storage."""
    idx = []
    for d, entry in enumerate(spec):
        i, n = ctx.index(entry)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"{n} ways ({spec})")
        c = t.shape[d] // n
        idx.append(slice(i * c, (i + 1) * c))
    part = t[tuple(idx)]
    if part.shape == t.shape and not copy_whole:
        return t.detach()
    return part.clone(memory_format=torch.contiguous_format)


def shard_model(model: nn.Module, rules, ctx: RankContext, *,
                requires_grad: bool = False) -> nn.Module:
    """A module of ``model``'s class whose parameters are the rank's
    slices per ``rules.params(model)``; each module holds its parameters'
    specs in ``pspecs``. Tied parameters stay tied; ``model`` is
    untouched. Frozen shards share a whole tensor's storage with
    ``model``; with ``requires_grad`` (the partitioned train step, which
    updates them in place) every shard is a copy of its own."""
    specs = rules.params(model)
    memo: dict = {}
    for name, p in model.named_parameters():
        if id(p) not in memo:
            memo[id(p)] = nn.Parameter(
                _own(p.detach(), specs[name], ctx, requires_grad),
                requires_grad=requires_grad)
    out = copy.deepcopy(model, memo)
    for prefix, mod in out.named_modules():
        own = {n: specs[f"{prefix}.{n}" if prefix else n]
               for n, q in mod.named_parameters(recurse=False)}
        if own:
            mod.pspecs = own
    return out


def param_specs(model: nn.Module) -> Dict[str, tuple]:
    """``{name: spec}`` of a sharded model's parameters, from the specs
    its modules hold."""
    out = {}
    for name, _ in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        out[name] = pspec(model.get_submodule(mod), leaf)
    return out


@torch.no_grad()
def reduce_gradients(grads: Dict[str, torch.Tensor], specs, ctx: RankContext,
                     dp) -> Dict[str, torch.Tensor]:
    """Data-parallel gradients: the rank's gradients of its own loss
    (``grads``, by parameter name) -> its shards of the gradient of the
    mean loss over the ``dp`` axes. A gradient whose spec names a dp axis
    was reduce-scattered over it by its weight's gather (FSDP); every
    other is summed over the axis, in all-reduces of buckets of such
    gradients concatenated (``BUCKET`` elements at most, besides a larger
    gradient alone); then all are divided by the axes' size (not at a
    size of 1, where the step is the unpartitioned one bit for bit).
    ``grads`` is updated in place and returned: each gradient's earlier
    copy is freed once its bucket lands, so the step holds one set of
    gradients and a bucket, not two sets."""
    n = 1
    for axis in dp:
        n *= ctx.sizes[axis]
        names = [k for k in grads if not splits(specs[k], axis)]
        for bucket in _buckets(names, grads):
            flat = ctx.all_reduce(torch.cat([grads[k].reshape(-1)
                                             for k in bucket]), axis)
            for k, part in zip(bucket, flat.split([grads[k].numel()
                                                   for k in bucket])):
                grads[k] = part.view_as(grads[k])
    if n > 1:
        for g in grads.values():
            g.div_(n)
    return grads


BUCKET = 1 << 25


def _buckets(names, tensors):
    """``names`` in order, cut into runs of at most ``BUCKET`` elements."""
    out, size = [], BUCKET
    for k in names:
        if size + tensors[k].numel() > BUCKET:
            out.append([])
            size = 0
        out[-1].append(k)
        size += tensors[k].numel()
    return out


@torch.no_grad()
def dp_mean(t: torch.Tensor, ctx: RankContext, dp) -> torch.Tensor:
    """The mean over the ``dp`` axes of a value each rank holds (its
    loss), the tensor itself where they are of size 1."""
    n = 1
    for axis in dp:
        n *= ctx.sizes[axis]
        t = ctx.all_reduce(t, axis)
    return t if n == 1 else t / n


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, v, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def shard_cache(cache, rules, ctx: RankContext, batch: int):
    """The rank's slices of a dense decode cache (``init_decode_state``'s
    tree) per ``rules.cache(cache, batch)``, each leaf tagged and its own
    copy (the step writes it in place)."""
    return _zip_map(lambda t, s: _tag(_own(t, s, ctx, True), s), cache,
                    rules.cache(cache, batch))


def shard_batch(tree, rules, ctx: RankContext, batch: int,
                micro_batches: int = 1):
    """The rank's rows of batch-bearing inputs (tokens, positions, a VLM's
    prefix embeddings) per ``rules.batch_spec``: split over the dp axes
    where ``batch`` divides, else whole. With ``micro_batches`` n (the
    train step's), the reference's rows of each micro-batch: it cuts the
    global batch into n micro-batches of ``batch / n`` rows and splits
    each over the dp axes (where they divide it), so the rank holds its
    block of micro-batch 0, then of micro-batch 1, ... (its micro-batch m
    holds rows [m batch / n + r batch / (n dp), ...) on dp rank r)."""
    n = micro_batches

    def own(t):
        if n == 1 or t.shape[0] != batch:
            return _own(t, rules.batch_spec(t, batch), ctx)
        if batch % n:
            raise ValueError(f"a batch of {batch} rows does not split into "
                             f"{n} micro-batches")
        mb = t.reshape(n, batch // n, *t.shape[1:])
        part = _own(mb, (None, *rules.batch_spec(mb[0], batch // n)), ctx)
        return part.reshape(-1, *t.shape[1:])
    return _map(own, tree)


def shard_state(state, rules, ctx: RankContext):
    """A layer's zero recurrent state for the rank's rows (a NamedTuple of
    (B, ...) leaves, as the training forward starts a Mamba layer) ->
    (the rank's blocks of it, their specs): split over ``model`` as
    ``rules.cache`` splits the decode cache's leaves, the rows not
    again."""
    specs = type(state)(*(rules.cache_spec(name, t[None], 0)[1:]
                          for name, t in zip(state._fields, state)))
    return type(state)(*(_own(t, s, ctx, True)
                         for t, s in zip(state, specs))), specs


def _tag(t: torch.Tensor, t_spec) -> torch.Tensor:
    t.pspec = t_spec
    return t


def materialize(tree, device):
    """Zeros shaped like a tree of cache shards (on ``meta``, say) on
    ``device``, each leaf keeping its spec."""
    return _map(lambda t: _tag(torch.zeros(t.shape, dtype=t.dtype,
                                           device=device), t.pspec), tree)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` for the dry run's trace of
    one rank's step and the timing of its local work: its collectives
    move no bytes and return what they are given, or garbage. It never
    serves a served path."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
