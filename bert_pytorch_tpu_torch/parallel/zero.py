"""Data parallelism, ZeRO-1 and fsdp over the ranks, with the model
axis's norms (counterpart of bert_pytorch_tpu/parallel/zero.py, its
make_fsdp_plan, and of the data-parallel half of its train step).

Layout (`FlatLayout`). The parameters are grouped into units, the
buckets of every collective: the embeddings, each encoder layer, and the
heads (pooler, MLM and NSP heads), in the forward's order. A unit is one
run of a flat buffer holding its tensors one after another, each tensor
starting on ALIGN elements, the run padded to a multiple of world x ALIGN.
Rank r owns the r-th of the world's equal slices of every unit, so every
shard boundary falls on ALIGN elements (16 bytes in bf16, 32 in f32) and
the fused LAMB kernels read every piece in place. The gradient buffer has
the same layout, so one unit's reduce-scatter lands rank r exactly its
slice of the unit. This is apex DistributedFusedLAMB's layout: flat,
padded buffers with the named tensors as views into them. It departs on
purpose from the JAX package's per-leaf `zero1_spec` (one dimension of
each leaf split over `data`): the pieces differ, the values do not,
because the update is elementwise once the norms are known, and the norms
are summed from the pieces. No tensor is left replicated, so
`replicated_leaves` (bert_zero1_replicated_leaves) is empty here; JAX's
divisibility fallback has no counterpart.

`DataParallel` runs a step's data-parallel work for
training/pretrain.build_pretrain_step:

- before the forward, the masked-token and NSP counts of every
  microbatch summed over the ranks (one small all-reduce): each rank's
  loss divides its own sums by them, so the ranks' losses add up to the
  global microbatch's and their gradients sum to its gradient;
- the microbatches' gradients accumulated into the flat carry (the
  gradients' dtype up to 128 microbatches, f32 beyond), then one
  reduction a unit after the last: an all-reduce (`--zero1 false`); with
  ZeRO-1 an all-reduce and the rank's slice, or under `reduce_scatter`
  (--zero1_rs) a reduce-scatter into the rank's slice;
- with ZeRO-1 each rank keeps LAMB's moments for its slice alone, LAMB
  runs over the rank's pieces (optim/lamb.Lamb.update's `shards`), and
  the updated f32 masters are all-gathered a unit at a time at the end
  of the step; with `gather_on_use` (--zero1_overlap) they rest as
  slices instead, and the next step casts its slice to the compute dtype
  and issues every unit's all-gather at its start, each awaited where
  the forward first reaches that unit (the embeddings, a layer, the heads
  after the encoder). The gathered values are the same either way.

Meshes (parallel/mesh.py; `axes`, this rank's dist.Axes). Everything
above runs once for each model coordinate, over the model-local tensors
(parallel/tensor.py: a rank of model coordinate m holds its part of the
split tensors); the batch's collectives run over the batch group (data x
fsdp), never over the model peers, which hold the same rows:

- the slicing group: with ZeRO-1 the batch group (JAX appends `data` to
  the fsdp resting spec), else the fsdp group under fsdp, else none (a
  rank owns every unit of its model part);
- fsdp (F > 1): the f32 masters and LAMB's moments rest as the rank's
  slice (`rest_sliced`; so does ZeRO-1 under gather_on_use), and each
  step gathers the compute copy over the slicing group a unit at a time:
  all before the forward (JAX's `blocking` layout), or with
  `fsdp_overlap` each unit awaited where the forward first reaches it;
  the gradients are reduce-scattered over fsdp, then summed over data
  (with ZeRO-1 reduce-scattered, or all-reduced and sliced, over the
  batch group);
- the norms (LAMB's trust norms, the global gradient norm) sum each
  tensor's partials over the slicing group, then a model-split tensor's
  over the model group, in rank order; a tensor whole on every model
  peer counts once. Every peer gets the same bits.

The units are padded to a multiple of (batch group) x ALIGN, so a unit's
slice over the slicing group reduces over the data group whole.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from bert_pytorch_tpu_torch.parallel import dist
from bert_pytorch_tpu_torch.parallel.coalesce import NormReducer

# elements a piece starts on: 16 bytes of bf16, 32 of f32
ALIGN = 8

_LAYER = re.compile(r"^bert\.encoder\.layers\.(\d+)\.")


def unit_of(name: str) -> str:
    """The unit of a pretraining model's parameter: "embeddings",
    "layer_<i>" or "heads"."""
    if name.startswith("bert.embeddings."):
        return "embeddings"
    m = _LAYER.match(name)
    if m:
        return f"layer_{m.group(1)}"
    return "heads"


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class Unit:
    name: str
    offset: int         # first element in the flat buffer
    length: int         # padded: a multiple of world x ALIGN
    shard: int          # length / world: each rank's slice
    compact: int        # first element of this unit's slice in a shard
    tensors: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Piece:
    """The part of tensor `name` in a rank's slice: flat elements
    [lo, hi), which are the tensor's elements [start, start + hi - lo),
    at `compact` in the rank's shard buffers."""
    key: str
    name: str
    tensor: int
    lo: int
    hi: int
    start: int
    compact: int


class FlatLayout:
    """Where each named tensor lives in the flat buffers of `world`
    ranks (module docstring); units padded to a multiple of `pad` x ALIGN
    (`world` when None; a multiple of it)."""

    def __init__(self, names: Sequence[str], shapes: Sequence[torch.Size],
                 world: int, pad: Optional[int] = None):
        self.world = int(world)
        pad = self.world if pad is None else int(pad)
        if pad % self.world:
            raise ValueError(f"pad {pad} is not a multiple of {world}")
        self.names = list(names)
        self.shape = dict(zip(names, (torch.Size(s) for s in shapes)))
        self.index = {n: i for i, n in enumerate(names)}
        order: Dict[str, List[str]] = {}
        for n in names:
            order.setdefault(unit_of(n), []).append(n)
        self.offset: Dict[str, int] = {}
        self.units: List[Unit] = []
        pos = compact = 0
        for uname, members in order.items():
            start, cur = pos, pos
            for n in members:
                self.offset[n] = cur
                cur = _up(cur + self.shape[n].numel(), ALIGN)
            length = _up(cur - start, pad * ALIGN)
            shard = length // self.world
            self.units.append(Unit(uname, start, length, shard, compact,
                                   tuple(members)))
            pos += length
            compact += shard
        self.total = pos
        self.shard_total = compact

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each tensor as a view of the flat buffer `flat`."""
        return {n: flat[self.offset[n]:self.offset[n]
                        + self.shape[n].numel()].view(self.shape[n])
                for n in self.names}

    def pieces(self, rank: int) -> List[Piece]:
        """Rank `rank`'s pieces, in the order of its shard buffers."""
        out = []
        for u in self.units:
            lo_u = u.offset + rank * u.shard
            hi_u = lo_u + u.shard
            for n in u.tensors:
                a = self.offset[n]
                b = a + self.shape[n].numel()
                lo, hi = max(a, lo_u), min(b, hi_u)
                if lo < hi:
                    out.append(Piece(f"{n}@{lo - a}", n, self.index[n], lo,
                                     hi, lo - a, u.compact + lo - lo_u))
        return out

    def own(self, flat: torch.Tensor, rank: int, unit: Unit) -> torch.Tensor:
        """Rank `rank`'s slice of `unit` in the flat buffer `flat`."""
        lo = unit.offset + rank * unit.shard
        return flat[lo:lo + unit.shard]

    def compact(self, shard: torch.Tensor, unit: Unit) -> torch.Tensor:
        """`unit`'s part of a rank's shard buffer."""
        return shard[unit.compact:unit.compact + unit.shard]


def rs_supported(mesh) -> bool:
    """Whether --zero1_rs can run on `mesh`: a data axis above 1 and
    every other axis 1 (JAX's rs_supported)."""
    return (mesh is not None and mesh.data > 1
            and all(n == 1 for a, n in mesh.shape.items() if a != "data"))


def _default_axes():
    """A data-only mesh over the default group's ranks: the batch and
    data groups are the world, fsdp and model of one rank."""
    from bert_pytorch_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(data=dist.get_world_size())
    rank = dist.get_rank()
    return dist.Axes(mesh=mesh, coords=mesh.coords(rank),
                     batch=dist.world_group("batch"),
                     fsdp=dist.Group("fsdp", (rank,), 0),
                     data=dist.world_group("data"),
                     model=dist.Group("model", (rank,), 0))


class DataParallel:
    """A parallel step's collectives, buffers and sharded state for
    `model` on this rank (module docstring). `zero1`: shard LAMB's
    moments and update; `reduce_scatter`: the gradients leave through a
    reduce-scatter (ZeRO-1 only); `gather_on_use`: the masters rest as
    slices and are gathered at the next step's start (ZeRO-1 only);
    `coalesce`: the norm partials travel in buckets (parallel/coalesce).
    `axes` (dist.make_axes; a data-only mesh over the default group when
    None) places the rank on its mesh: an fsdp axis above 1 rests the
    masters and moments sliced over it, gathered at each step's start,
    all before the forward or, with `fsdp_overlap`, each unit where the
    forward first uses it; a model axis above 1 needs `model` built with
    that rank's parallel/tensor.ModelShard. Whenever the state is split
    (`sharded`: ZeRO-1, fsdp or model) the model's parameters become
    views of one flat f32 buffer, or, resting sliced, empty placeholders
    (the step runs on gathered copies; `state_dict()` gathers). Works
    without a process group too (world 1: every collective is a copy)."""

    def __init__(self, model: nn.Module, zero1: bool = False,
                 reduce_scatter: bool = False, gather_on_use: bool = False,
                 coalesce: bool = False, axes=None,
                 fsdp_overlap: bool = False):
        from bert_pytorch_tpu_torch.parallel import rules

        if (reduce_scatter or gather_on_use) and not zero1:
            raise ValueError("reduce_scatter and gather_on_use are ZeRO-1 "
                             "arms: they need zero1")
        self.axes = axes if axes is not None else _default_axes()
        self.mesh = self.axes.mesh
        self.fsdp = self.mesh.fsdp > 1
        self.model_size = self.mesh.model
        shard = getattr(model, "model_shard", None)
        got = (shard.index, shard.size) if shard is not None else (0, 1)
        want = (self.axes.coords["model"], self.model_size)
        if got != want:
            raise ValueError(f"the model holds model part {got} (index, "
                             f"size); this rank is {want}")
        self.zero1 = bool(zero1)
        self.reduce_scatter = bool(reduce_scatter)
        self.gather_on_use = bool(gather_on_use)
        self.fsdp_overlap = bool(fsdp_overlap) and self.fsdp
        self.sharded = self.zero1 or self.fsdp or self.model_size > 1
        if self.zero1:
            self.slice_group = self.axes.batch
        elif self.fsdp:
            self.slice_group = self.axes.fsdp
        else:
            self.slice_group = dist.Group("slice", (dist.get_rank(),), 0)
        self.world = self.slice_group.size
        self.rank = self.slice_group.rank
        # the masters rest as this rank's slice; the step gathers them
        self.rest_sliced = self.gather_on_use or self.fsdp
        # a unit's gather awaited where the forward first uses it
        self.overlap = self.gather_on_use or self.fsdp_overlap
        self.reducer = NormReducer(coalesce, group=self.slice_group)
        named = list(model.named_parameters())
        self.layout = FlatLayout([n for n, _ in named],
                                 [p.shape for _, p in named], self.world,
                                 pad=self.axes.batch.size)
        self.replicated_leaves: Tuple[str, ...] = ()
        self.device = named[0][1].device
        # per tensor: split over the model axis (its norms summed there)
        self.split = torch.tensor(
            [self.model_size > 1 and rules.model_dim(n) is not None
             for n, _ in named], dtype=torch.bool, device=self.device)
        self._carry: Optional[torch.Tensor] = None
        self._pending: Dict[str, object] = {}
        self._hooks: List = []
        self.pieces: List[Piece] = []
        if self.sharded:
            self._flatten_masters(model, named)
            self.pieces = self.layout.pieces(self.rank)
            self.piece_tensor = torch.tensor(
                [p.tensor for p in self.pieces], dtype=torch.long,
                device=self.device)
            if self.overlap:
                self._install_gather_points(model)

    # -- layout ---------------------------------------------------------------

    def _flatten_masters(self, model: nn.Module, named) -> None:
        """Move the f32 parameters into one flat buffer (the model's
        parameters become views of it; values unchanged), or, resting
        sliced, into this rank's shard buffer (the parameters become
        empty placeholders)."""
        full = torch.zeros(self.layout.total, dtype=torch.float32,
                           device=self.device)
        views = self.layout.views(full)
        with torch.no_grad():
            for n, p in named:
                if p.dtype != torch.float32:
                    raise ValueError(f"a sharded state needs f32 masters: "
                                     f"{n} is {p.dtype}")
                views[n].copy_(p)
                p.data = views[n]
        if not self.rest_sliced:
            self.master = full
            return
        self.master = torch.empty(self.layout.shard_total,
                                  dtype=torch.float32, device=self.device)
        for u in self.layout.units:
            self.layout.compact(self.master, u).copy_(
                self.layout.own(full, self.rank, u))
        del views, full
        for _, p in named:
            p.data = torch.empty(0, dtype=torch.float32, device=self.device)

    def piece_views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """This rank's pieces of a full flat buffer, by piece key."""
        return {p.key: flat[p.lo:p.hi] for p in self.pieces}

    def shard_views(self, shard: torch.Tensor) -> Dict[str, torch.Tensor]:
        """This rank's pieces in a shard buffer, by piece key."""
        return {p.key: shard[p.compact:p.compact + p.hi - p.lo]
                for p in self.pieces}

    def own_masters(self) -> Dict[str, torch.Tensor]:
        """This rank's pieces of the f32 masters (what LAMB updates)."""
        return (self.shard_views(self.master) if self.rest_sliced
                else self.piece_views(self.master))

    def init_moments(self) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
        """LAMB's mu and nu for this rank's slice: zero f32 shard buffers,
        by piece key."""
        self.mu = torch.zeros(self.layout.shard_total, dtype=torch.float32,
                              device=self.device)
        self.nu = torch.zeros_like(self.mu)
        return self.shard_views(self.mu), self.shard_views(self.nu)

    def weight_decay_names(self) -> List[str]:
        """The tensor name of every piece, in order (the decay mask is the
        tensor's)."""
        return [p.name for p in self.pieces]

    def resting_f32_bytes(self) -> int:
        """Bytes of the f32 state this rank keeps between steps: the
        masters and LAMB's two moments."""
        if not self.sharded:
            return 12 * sum(self.layout.shape[k].numel()
                            for k in self.layout.names)
        return 4 * (self.master.numel() + 2 * self.layout.shard_total)

    # -- gather-on-use --------------------------------------------------------

    def _install_gather_points(self, model: nn.Module) -> None:
        """Hooks that wait for a unit's all-gather where the forward first
        reaches it: before the embeddings, before each layer, after the
        encoder for the heads. A model without that structure waits for
        every unit before its forward."""
        bert = getattr(model, "bert", None)
        units = {u.name for u in self.layout.units}
        points: List[Tuple[nn.Module, str, List[str]]] = []
        if bert is not None and hasattr(bert, "encoder"):
            points.append((bert.embeddings, "pre", ["embeddings"]))
            for i, layer in enumerate(bert.encoder.layers):
                points.append((layer, "pre", [f"layer_{i}"]))
            points.append((bert.encoder, "post", ["heads"]))
        covered = {u for _, _, us in points for u in us}
        if units - covered:
            points = [(model, "pre", sorted(units))]
        for mod, when, us in points:
            def hook(*_, _us=us):
                for u in _us:
                    self.wait_unit(u)
            self._hooks.append(mod.register_forward_pre_hook(hook)
                               if when == "pre"
                               else mod.register_forward_hook(hook))

    def wait_unit(self, unit: str) -> None:
        work = self._pending.pop(unit, None)
        if work is not None:
            work.wait()

    def wait_all(self) -> None:
        for u in list(self._pending):
            self.wait_unit(u)

    def compute_params(self, params: Dict[str, torch.Tensor],
                       grad_dtype: Optional[torch.dtype]
                       ) -> Optional[Dict[str, torch.Tensor]]:
        """Resting sliced: this rank's slice cast to the compute dtype,
        every unit's all-gather over the slicing group issued (awaited by
        the hooks, or here before the forward without them), and the
        leaves the forward runs against (views of the gathered buffer,
        requiring grad). None otherwise: the caller casts the whole
        masters."""
        if not self.rest_sliced:
            return None
        dtype = grad_dtype or torch.float32
        full = torch.empty(self.layout.total, dtype=dtype,
                           device=self.device)
        shard = self.master if dtype == torch.float32 else \
            self.master.to(dtype)
        for u in self.layout.units:
            self._pending[u.name] = dist.all_gather_into(
                full[u.offset:u.offset + u.length],
                self.layout.compact(shard, u), async_op=True,
                group=self.slice_group)
        if not self.overlap:
            self.wait_all()
        views = self.layout.views(full)
        # `.data`: leaves on the buffer's memory with version counters of
        # their own. The views share the buffer's counter, which the
        # gathers still in flight bump when they land: autograd would
        # take a unit gathered after another unit's weights were saved
        # for the backward as a write to those weights. No write reaches
        # a unit once its hook has waited for it.
        return {n: views[n].data.requires_grad_() for n in params}

    def gather_masters(self) -> None:
        """Every unit's all-gather of the f32 masters from the rank
        slices, awaited (ZeRO-1's end-of-step gather; the masters rest
        whole)."""
        self.wait_all()
        if self.rest_sliced:
            raise RuntimeError("the masters rest sliced: nothing whole to "
                               "gather into")
        shard = torch.empty(self.layout.shard_total, dtype=torch.float32,
                            device=self.device)
        for u in self.layout.units:
            self.layout.compact(shard, u).copy_(
                self.layout.own(self.master, self.rank, u))
        for u in self.layout.units:
            dist.all_gather_into(self.master[u.offset:u.offset + u.length],
                                 self.layout.compact(shard, u),
                                 group=self.slice_group)

    # -- the step -------------------------------------------------------------

    def global_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """Counts (or a loss) of this rank's rows -> summed over the batch
        group (the model peers hold the same rows)."""
        return dist.all_reduce_small(counts, self.axes.batch)

    def carry(self, dtype: torch.dtype) -> Tuple[torch.Tensor,
                                                 Dict[str, torch.Tensor]]:
        """The flat gradient carry in `dtype` (padding zero) and its
        views, made once (again if the dtype changes)."""
        if self._carry is None or self._carry.dtype != dtype:
            self._carry = torch.zeros(self.layout.total, dtype=dtype,
                                      device=self.device)
            self._carry_views = self.layout.views(self._carry)
        return self._carry, self._carry_views

    def reduce_grads(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Sum the accumulated gradients over the batch group, a unit at a
        time: unsharded the whole tensors (views of `flat`, by name);
        sharded this rank's pieces (by piece key): with ZeRO-1 from the
        all-reduce's slice or, under reduce_scatter, from a
        reduce-scatter over the batch group; under fsdp reduce-scattered
        over fsdp, then summed over data; else (the model split alone)
        all-reduced whole."""
        batch = self.axes.batch
        if not (self.zero1 or self.fsdp):
            for u in self.layout.units:
                dist.all_reduce_sum(flat[u.offset:u.offset + u.length],
                                    batch)
            return (self.piece_views(flat) if self.sharded
                    else self._carry_views)
        shard = torch.empty(self.layout.shard_total, dtype=flat.dtype,
                            device=self.device)
        for u in self.layout.units:
            block = flat[u.offset:u.offset + u.length]
            part = self.layout.compact(shard, u)
            if self.zero1 and not self.reduce_scatter:
                dist.all_reduce_sum(block, batch)
                part.copy_(self.layout.own(flat, self.rank, u))
            elif self.zero1:
                dist.reduce_scatter_sum(part, block, group=batch)
            else:
                dist.reduce_scatter_sum(part, block, group=self.axes.fsdp)
                dist.all_reduce_sum(part, self.axes.data)
        return self.shard_views(shard)

    def partials_by_tensor(self, rows: Sequence[torch.Tensor]
                           ) -> torch.Tensor:
        """(k, T) f32: each row's per-piece values summed into the slots of
        their tensors (T tensors; a tensor without a piece here gets 0)."""
        out = torch.zeros((len(rows), len(self.layout.names)),
                          dtype=torch.float32, device=self.device)
        for i, r in enumerate(rows):
            out[i].index_add_(0, self.piece_tensor, r.float())
        return out

    def _totals(self, partials: torch.Tensor) -> torch.Tensor:
        """(k, T) partials of this rank -> each tensor's totals: summed
        over the slicing group, then, for a model-split tensor, over the
        model group in rank order (a whole tensor counts once)."""
        totals = self.reducer.reduce(partials)
        if self.model_size > 1:
            rows = dist.all_gather_rows(totals.reshape(-1).contiguous(),
                                        self.axes.model)
            summed = dist.sum_rows_in_order(rows).view(totals.shape)
            totals = torch.where(self.split[None, :], summed, totals)
        return totals

    def sq_norms(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The pieces' f32 sums of squares (one a piece)."""
        if not tensors:
            return torch.zeros(0, dtype=torch.float32, device=self.device)
        norms = torch._foreach_norm(list(tensors), 2, dtype=torch.float32)
        return torch.stack(norms).square()

    def global_norm(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The f32 L2 norm of every rank's pieces together: per-tensor
        partial sums of squares, the reductions, the tensors' totals
        summed in order."""
        totals = self._totals(
            self.partials_by_tensor([self.sq_norms(tensors)]))
        return torch.sqrt(totals[0].sum())

    def trust_norms(self, ps: Sequence[torch.Tensor],
                    us: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(||p||, ||u||) of each piece's whole tensor: the pieces'
        partials, the reductions, then each tensor's norms handed back to
        its pieces."""
        totals = self._totals(self.partials_by_tensor(
            [self.sq_norms(ps), self.sq_norms(us)]))
        norms = torch.sqrt(totals)
        return (norms[0].index_select(0, self.piece_tensor),
                norms[1].index_select(0, self.piece_tensor))

    def counted(self, pieces: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """The pieces whose non-finite values this rank counts: all on
        model coordinate 0, the model-split tensors' alone on the other
        model peers (a whole tensor counts once)."""
        if self.axes.coords["model"] == 0:
            return pieces
        split = self.split.tolist()
        return {p.key: pieces[p.key] for p in self.pieces
                if split[p.tensor]}

    def nonfinite_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """Per-group non-finite counts of this rank's `counted` pieces,
        summed over the slicing and the model groups (int32 in, int32
        out)."""
        c = dist.all_reduce_small(counts.to(torch.int64), self.slice_group)
        if self.model_size > 1:
            c = dist.all_reduce_small(c, self.axes.model)
        return c.to(torch.int32)

    def end_step(self) -> None:
        """After the update: resting sliced, nothing of the step's
        gathered copy is kept; else ZeRO-1 gathers the updated masters."""
        if self.sharded and not self.rest_sliced and self.zero1:
            self.gather_masters()

    # -- checkpoints ----------------------------------------------------------

    def _gather_shard(self, shard: torch.Tensor) -> Dict[str, torch.Tensor]:
        full = torch.empty(self.layout.total, dtype=shard.dtype,
                           device=self.device)
        for u in self.layout.units:
            dist.all_gather_into(full[u.offset:u.offset + u.length],
                                 self.layout.compact(shard, u),
                                 group=self.slice_group)
        return self.layout.views(full)

    def _whole(self, local: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The one-card tensors from this rank's model parts (each split
        tensor's parts all-gathered over the model group, in order)."""
        from bert_pytorch_tpu_torch.parallel import rules

        if self.model_size == 1:
            return dict(local)
        split = self.split.tolist()
        out = {}
        for i, n in enumerate(self.layout.names):
            t = local[n]
            if not split[i]:
                out[n] = t
                continue
            rows = dist.all_gather_rows(t.reshape(-1).contiguous(),
                                        self.axes.model)
            out[n] = rules.unshard(n, [r.view(t.shape) for r in rows])
        return out

    def global_shape(self, name: str) -> torch.Size:
        """The one-card shape of tensor `name`."""
        from bert_pytorch_tpu_torch.parallel import rules

        shape = list(self.layout.shape[name])
        d = rules.model_dim(name)
        if d is not None and self.model_size > 1:
            shape[d] *= self.model_size
        return torch.Size(shape)

    def full_state_dict(self, state) -> Dict:
        """The one-card state_dict() of a sharded TrainState: the masters
        and the moments all-gathered over the slicing group, then the
        model parts over the model group. Collective: every rank calls
        it."""
        self.wait_all()
        masters = (self._gather_shard(self.master) if self.rest_sliced
                   else self.layout.views(self.master))
        return {"step": int(state.step),
                "params": self._whole(masters),
                "opt_state": {"count": int(state.opt_state.count),
                              "mu": self._whole(self._gather_shard(self.mu)),
                              "nu": self._whole(self._gather_shard(self.nu))}}

    def _check_names_shapes(self, what: str, got: Dict) -> None:
        have = set(self.layout.names)
        if set(got) != have:
            raise ValueError(
                f"checkpoint {what} do not match the model: missing "
                f"{sorted(have - set(got))[:5]}, unexpected "
                f"{sorted(set(got) - have)[:5]}")
        for n in self.layout.names:
            if tuple(got[n].shape) != tuple(self.global_shape(n)):
                raise ValueError(f"checkpoint {what} {n}: shape "
                                 f"{tuple(got[n].shape)}, model "
                                 f"{tuple(self.global_shape(n))}")

    def _local_part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        from bert_pytorch_tpu_torch.parallel import rules

        return rules.shard(name, t, self.axes.coords["model"],
                           self.model_size)

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy one-card parameters (every tensor whole) into this rank's
        masters: its model part, and of that its slice when resting
        sliced."""
        self._check_names_shapes("params", params)
        with torch.no_grad():
            if not self.rest_sliced:
                views = self.layout.views(self.master)
                for n in self.layout.names:
                    views[n].copy_(self._local_part(n, params[n]))
                return
            own = self.shard_views(self.master)
            for p in self.pieces:
                flat = self._local_part(p.name, params[p.name]).reshape(-1)
                own[p.key].copy_(flat[p.start:p.start + p.hi - p.lo])

    def load_full_state_dict(self, state, sd: Dict) -> None:
        """Copy a one-card state_dict() in: this rank's part of the
        masters (whole or sliced as they rest) and its pieces of the
        moments. Any one-card checkpoint restores at any mesh shape."""
        opt = sd["opt_state"]
        for what in ("mu", "nu"):
            self._check_names_shapes(what, opt[what])
        self.load_params(sd["params"])
        mu, nu = self.shard_views(self.mu), self.shard_views(self.nu)
        with torch.no_grad():
            for p in self.pieces:
                sl = slice(p.start, p.start + p.hi - p.lo)
                mu[p.key].copy_(
                    self._local_part(p.name, opt["mu"][p.name]).reshape(-1)[sl])
                nu[p.key].copy_(
                    self._local_part(p.name, opt["nu"][p.name]).reshape(-1)[sl])
        state.step = int(sd["step"])
        state.opt_state.count = int(opt["count"])

    def describe(self) -> Dict:
        """The layout and arms, for the run header."""
        return {"world": dist.get_world_size(), "mesh": self.mesh.shape,
                "zero1": self.zero1,
                "reduce_scatter": self.reduce_scatter,
                "gather_on_use": self.gather_on_use,
                "fsdp_overlap": self.fsdp_overlap,
                "coalesce": self.reducer.coalesce,
                "slice_ranks": self.world, "rest_sliced": self.rest_sliced,
                "units": len(self.layout.units),
                "flat_elements": self.layout.total,
                "shard_elements": self.layout.shard_total,
                "pieces": len(self.pieces),
                "resting_f32_bytes": self.resting_f32_bytes(),
                "replicated_leaves": len(self.replicated_leaves)}

    def close(self) -> None:
        self.wait_all()
        for h in self._hooks:
            h.remove()
        self._hooks.clear()
