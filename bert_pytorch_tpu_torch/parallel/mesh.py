"""The mesh of a run: --mesh parsed, sized against the world and checked
(counterpart of bert_pytorch_tpu/parallel/mesh.py and of the JAX entry
point's `parse_mesh_arg`).

The JAX package lays its devices out on four axes, data, fsdp, model and
seq. The port runs one process a card, and the ranks of torch.distributed
are the mesh's devices, in JAX's device order: JAX reshapes its device
list in MESH_AXES order, so rank r sits at (d, f, m, s) with
r = ((d * F + f) * M + m) * S + s (`Mesh.coords`). It implements the
data axis (data parallelism, ZeRO-1), the fsdp axis (the parameters and
LAMB's moments rest sliced, gathered at use) and the model axis (tensor
parallelism over the heads, the MLP and the vocabulary). A mesh with seq
above 1 is refused, naming PARALLEL_GAPS.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from bert_pytorch_tpu_torch import PARALLEL_GAPS

MESH_AXES = ("data", "fsdp", "model", "seq")


def parse_mesh_arg(mesh_arg: str) -> Optional[Dict[str, int]]:
    """"data=2,fsdp=1" -> {"data": 2, "fsdp": 1}; "" -> None (the JAX
    entry point's parse_mesh_arg)."""
    if not mesh_arg:
        return None
    out = {}
    for part in mesh_arg.split(","):
        k, v = part.split("=")
        out[k.strip()] = int(v)
    return out


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes in MESH_AXES order; `shape` as the JAX Mesh's."""
    data: int = 1
    fsdp: int = 1
    model: int = 1
    seq: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in MESH_AXES}

    @property
    def size(self) -> int:
        return self.data * self.fsdp * self.model * self.seq

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank `rank`'s coordinate on each axis (JAX's device order:
        the last axis varies fastest)."""
        out, r = {}, int(rank)
        for a in reversed(MESH_AXES):
            n = getattr(self, a)
            out[a] = r % n
            r //= n
        return {a: out[a] for a in MESH_AXES}

    def rank_of(self, coords: Dict[str, int]) -> int:
        """The rank at `coords` (axes left out are 0)."""
        r = 0
        for a in MESH_AXES:
            r = r * getattr(self, a) + int(coords.get(a, 0))
        return r

    def data_shard_index(self, rank: int) -> int:
        """Which of the batch's data x fsdp parts rank `rank` trains:
        d * F + f (JAX's batch spec over ("data", "fsdp"))."""
        c = self.coords(rank)
        return c["data"] * self.fsdp + c["fsdp"]

    def flat_shard_index(self, rank: int) -> int:
        """(d * F + f) * M + m: the flash kernels' per-shard dropout fold
        (JAX's flat_batch_head_shard)."""
        return (self.data_shard_index(rank) * self.model
                + self.coords(rank)["model"])


def make_mesh(shape: Optional[Dict[str, int]], world_size: int) -> Mesh:
    """The mesh over `world_size` ranks (JAX's make_mesh over its
    devices): unspecified axes are 1; without a `data` entry the data axis
    takes what the others leave; with one, the product must equal the
    world size. An unknown axis raises ValueError, seq above 1
    NotImplementedError."""
    shape = dict(shape or {})
    unknown = sorted(set(shape) - set(MESH_AXES))
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; axes are "
                         f"{list(MESH_AXES)}")
    sizes = {a: int(shape.get(a, 1)) for a in MESH_AXES}
    if "data" not in shape:
        rest = sizes["fsdp"] * sizes["model"] * sizes["seq"]
        if world_size % rest:
            raise ValueError(f"{world_size} ranks not divisible by non-data "
                             f"axes {shape}")
        sizes["data"] = world_size // rest
    mesh = Mesh(**sizes)
    if mesh.size != world_size:
        raise ValueError(f"mesh shape {shape} != rank count {world_size}")
    if mesh.seq > 1:
        raise NotImplementedError(
            f"mesh axis seq={mesh.seq} (ring attention) is not ported yet: "
            f"the port implements the data, fsdp and model axes (see "
            f"{PARALLEL_GAPS})")
    return mesh


def data_shard_count(mesh: Mesh) -> int:
    """Ways the batch is split (data x fsdp)."""
    return mesh.data * mesh.fsdp


def check_model_split(name: str, size: int, model: int) -> None:
    """A width the model axis splits must divide by it: ValueError naming
    the tensor and the sizes otherwise (GSPMD would pad; the port does
    not)."""
    if model > 1 and size % model:
        raise ValueError(f"{name}: {size} does not divide over the model "
                         f"axis of {model} (the port splits evenly)")


def mesh_config(mesh: Optional[Mesh]) -> str:
    """Short name of a mesh's parallelism: the non-trivial axes joined
    ('dp', ...), 'replicated' when every axis is 1 (JAX's
    parallel/rules.mesh_config)."""
    if mesh is None:
        return "replicated"
    short = {"data": "dp", "fsdp": "fsdp", "model": "mp", "seq": "seq"}
    parts = [short[a] for a in MESH_AXES if mesh.shape[a] > 1]
    return "_".join(parts) if parts else "replicated"


PRODUCTION_CONFIG = "production"


def production_qualifies(mesh: Optional[Mesh]) -> bool:
    """Whether --mesh_config auto picks `production` for this mesh: an
    axis the pack can use is above 1 (JAX's production_qualifies)."""
    return mesh is not None and any(
        mesh.shape[a] > 1 for a in ("data", "fsdp", "seq"))


def production_features(mesh: Optional[Mesh]) -> Dict[str, bool]:
    """What `production` turns on for this mesh (JAX's
    production_features): packing always, ZeRO-1 and its gather-on-use
    where the data axis is above 1."""
    data = mesh is not None and mesh.data > 1
    return {"packing": True, "zero1": data, "zero1_overlap": data,
            "fsdp_overlap": mesh is not None and mesh.fsdp > 1,
            "ring_attention": mesh is not None and mesh.seq > 1}
