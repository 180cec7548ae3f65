"""Data parallelism and ZeRO-1 over the ranks (counterpart of
bert_pytorch_tpu/parallel/zero.py and of the data-parallel half of its
train step).

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
    ranks (module docstring)."""

    def __init__(self, names: Sequence[str], shapes: Sequence[torch.Size],
                 world: int):
        self.world = int(world)
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
            length = _up(cur - start, self.world * ALIGN)
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


class DataParallel:
    """A data-parallel step's collectives, buffers and ZeRO-1 state for
    `model` on this rank (module docstring). `zero1`: shard LAMB's
    moments and update; `reduce_scatter`: the gradients leave through a
    reduce-scatter (ZeRO-1 only); `gather_on_use`: the masters rest as
    slices and are gathered at the next step's start (ZeRO-1 only);
    `coalesce`: the norm partials travel in buckets (parallel/coalesce).
    With ZeRO-1 the model's parameters become views of one flat f32
    buffer. Works without a process group too (world 1: every collective
    is a copy)."""

    def __init__(self, model: nn.Module, zero1: bool = False,
                 reduce_scatter: bool = False, gather_on_use: bool = False,
                 coalesce: bool = False):
        if (reduce_scatter or gather_on_use) and not zero1:
            raise ValueError("reduce_scatter and gather_on_use are ZeRO-1 "
                             "arms: they need zero1")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.zero1 = bool(zero1)
        self.reduce_scatter = bool(reduce_scatter)
        self.gather_on_use = bool(gather_on_use)
        self.reducer = NormReducer(coalesce)
        named = list(model.named_parameters())
        self.layout = FlatLayout([n for n, _ in named],
                                 [p.shape for _, p in named], self.world)
        self.replicated_leaves: Tuple[str, ...] = ()
        self.device = named[0][1].device
        self._carry: Optional[torch.Tensor] = None
        self._pending: Dict[str, object] = {}
        self._hooks: List = []
        self.pieces: List[Piece] = []
        if self.zero1:
            self._flatten_masters(model, named)
            self.pieces = self.layout.pieces(self.rank)
            self.piece_tensor = torch.tensor(
                [p.tensor for p in self.pieces], dtype=torch.long,
                device=self.device)
            self._compute: Dict[torch.dtype, torch.Tensor] = {}
            if self.gather_on_use:
                self._install_gather_points(model)

    # -- layout ---------------------------------------------------------------

    def _flatten_masters(self, model: nn.Module, named) -> None:
        """Move the f32 parameters into one flat buffer (the model's
        parameters become views of it; values unchanged)."""
        self.master = torch.zeros(self.layout.total, dtype=torch.float32,
                                  device=self.device)
        views = self.layout.views(self.master)
        with torch.no_grad():
            for n, p in named:
                if p.dtype != torch.float32:
                    raise ValueError(f"ZeRO-1 needs f32 masters: {n} is "
                                     f"{p.dtype}")
                views[n].copy_(p)
                p.data = views[n]

    def piece_views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """This rank's pieces of a full flat buffer, by piece key."""
        return {p.key: flat[p.lo:p.hi] for p in self.pieces}

    def shard_views(self, shard: torch.Tensor) -> Dict[str, torch.Tensor]:
        """This rank's pieces in a shard buffer, by piece key."""
        return {p.key: shard[p.compact:p.compact + p.hi - p.lo]
                for p in self.pieces}

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

    def _compute_buffer(self, dtype: torch.dtype) -> torch.Tensor:
        buf = self._compute.get(dtype)
        if buf is None:
            buf = torch.zeros(self.layout.total, dtype=dtype,
                              device=self.device)
            self._compute[dtype] = buf
            self._compute_views = self.layout.views(buf)
        return buf

    def compute_params(self, params: Dict[str, torch.Tensor],
                       grad_dtype: Optional[torch.dtype]
                       ) -> Optional[Dict[str, torch.Tensor]]:
        """Under gather_on_use: this rank's slice cast to the compute
        dtype, every unit's all-gather issued (awaited by the hooks), and
        the leaves the forward runs against (views of the gathered buffer,
        requiring grad). None otherwise: the caller casts the whole
        masters."""
        if not self.gather_on_use:
            return None
        dtype = grad_dtype or torch.float32
        full = self.master if dtype == torch.float32 else \
            self._compute_buffer(dtype)
        shard = torch.empty(self.layout.shard_total, dtype=dtype,
                            device=self.device)
        for u in self.layout.units:
            self.layout.compact(shard, u).copy_(
                self.layout.own(self.master, self.rank, u))
        for u in self.layout.units:
            self._pending[u.name] = dist.all_gather_into(
                full[u.offset:u.offset + u.length],
                self.layout.compact(shard, u), async_op=True)
        views = (self.layout.views(full) if dtype == torch.float32
                 else self._compute_views)
        # `.data`: leaves on the buffer's memory with version counters of
        # their own. The views share the buffer's counter, which the
        # gathers still in flight bump when they land: autograd would
        # take a unit gathered after another unit's weights were saved
        # for the backward as a write to those weights. No write reaches
        # a unit once its hook has waited for it.
        return {n: views[n].data.requires_grad_() for n in params}

    def gather_masters(self) -> None:
        """Every unit's all-gather of the f32 masters from the rank
        slices, awaited (the end-of-step gather; before a save or a norm
        over the whole masters under gather_on_use)."""
        self.wait_all()
        shard = torch.empty(self.layout.shard_total, dtype=torch.float32,
                            device=self.device)
        for u in self.layout.units:
            self.layout.compact(shard, u).copy_(
                self.layout.own(self.master, self.rank, u))
        for u in self.layout.units:
            dist.all_gather_into(self.master[u.offset:u.offset + u.length],
                                 self.layout.compact(shard, u))

    # -- the step -------------------------------------------------------------

    def global_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """(accum, 2) masked-token and NSP-label counts of this rank's
        microbatches -> summed over the ranks."""
        return dist.all_reduce_small(counts)

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
        """Sum the accumulated gradients over the ranks, a unit at a time:
        without ZeRO-1 the whole tensors (views of `flat`, by name); with
        it this rank's pieces (by piece key), from the all-reduce's slice
        or, under reduce_scatter, from a reduce-scatter."""
        if not self.zero1:
            for u in self.layout.units:
                dist.all_reduce_sum(flat[u.offset:u.offset + u.length])
            return self._carry_views
        shard = torch.empty(self.layout.shard_total, dtype=flat.dtype,
                            device=self.device)
        for u in self.layout.units:
            block = flat[u.offset:u.offset + u.length]
            if self.reduce_scatter:
                dist.reduce_scatter_sum(self.layout.compact(shard, u), block)
            else:
                dist.all_reduce_sum(block)
                self.layout.compact(shard, u).copy_(
                    self.layout.own(flat, self.rank, u))
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

    def sq_norms(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The pieces' f32 sums of squares (one a piece)."""
        if not tensors:
            return torch.zeros(0, dtype=torch.float32, device=self.device)
        norms = torch._foreach_norm(list(tensors), 2, dtype=torch.float32)
        return torch.stack(norms).square()

    def global_norm(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The f32 L2 norm of every rank's pieces together: per-tensor
        partial sums of squares, one reduction, the tensors' totals summed
        in order."""
        totals = self.reducer.reduce(
            self.partials_by_tensor([self.sq_norms(tensors)]))
        return torch.sqrt(totals[0].sum())

    def trust_norms(self, ps: Sequence[torch.Tensor],
                    us: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(||p||, ||u||) of each piece's whole tensor: the pieces'
        partials, one reduction, then each tensor's norms handed back to
        its pieces."""
        totals = self.reducer.reduce(self.partials_by_tensor(
            [self.sq_norms(ps), self.sq_norms(us)]))
        norms = torch.sqrt(totals)
        return (norms[0].index_select(0, self.piece_tensor),
                norms[1].index_select(0, self.piece_tensor))

    def nonfinite_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """Per-group non-finite counts of this rank's pieces, summed over
        the ranks (int32 in, int32 out)."""
        return dist.all_reduce_small(counts.to(torch.int64)).to(torch.int32)

    # -- checkpoints ----------------------------------------------------------

    def _gather_shard(self, shard: torch.Tensor) -> Dict[str, torch.Tensor]:
        full = torch.empty(self.layout.total, dtype=shard.dtype,
                           device=self.device)
        for u in self.layout.units:
            dist.all_gather_into(full[u.offset:u.offset + u.length],
                                 self.layout.compact(shard, u))
        return self.layout.views(full)

    def full_state_dict(self, state) -> Dict:
        """The one-card state_dict() of a ZeRO-1 TrainState: the masters
        and the moments all-gathered. Collective: every rank calls it."""
        self.gather_masters()
        sd = {"step": int(state.step),
              "params": dict(self.layout.views(self.master)),
              "opt_state": {"count": int(state.opt_state.count),
                            "mu": self._gather_shard(self.mu),
                            "nu": self._gather_shard(self.nu)}}
        return sd

    def load_full_state_dict(self, state, sd: Dict) -> None:
        """Copy a one-card state_dict() in: the whole masters, and this
        rank's pieces of the moments."""
        have = set(self.layout.names)
        for what in ("params",):
            got = set(sd[what])
            if got != have:
                raise ValueError(
                    f"checkpoint {what} do not match the model: missing "
                    f"{sorted(have - got)[:5]}, unexpected "
                    f"{sorted(got - have)[:5]}")
        opt = sd["opt_state"]
        for what in ("mu", "nu"):
            if set(opt[what]) != have:
                raise ValueError(f"checkpoint {what} do not match the model")
        for n in self.layout.names:
            if tuple(sd["params"][n].shape) != tuple(self.layout.shape[n]):
                raise ValueError(f"checkpoint params {n}: shape "
                                 f"{tuple(sd['params'][n].shape)}, model "
                                 f"{tuple(self.layout.shape[n])}")
        views = self.layout.views(self.master)
        mu, nu = self.shard_views(self.mu), self.shard_views(self.nu)
        with torch.no_grad():
            for n in self.layout.names:
                views[n].copy_(sd["params"][n])
            for p in self.pieces:
                sl = slice(p.start, p.start + p.hi - p.lo)
                mu[p.key].copy_(opt["mu"][p.name].reshape(-1)[sl])
                nu[p.key].copy_(opt["nu"][p.name].reshape(-1)[sl])
        state.step = int(sd["step"])
        state.opt_state.count = int(opt["count"])

    def describe(self) -> Dict:
        """The layout and arms, for the run header."""
        return {"world": self.world, "zero1": self.zero1,
                "reduce_scatter": self.reduce_scatter,
                "gather_on_use": self.gather_on_use,
                "coalesce": self.reducer.coalesce,
                "units": len(self.layout.units),
                "flat_elements": self.layout.total,
                "shard_elements": self.layout.shard_total,
                "pieces": len(self.pieces),
                "replicated_leaves": len(self.replicated_leaves)}

    def close(self) -> None:
        self.wait_all()
        for h in self._hooks:
            h.remove()
        self._hooks.clear()
