"""The mesh of a run: --mesh parsed, sized against the world and checked
(counterpart of bert_pytorch_tpu/parallel/mesh.py and of the JAX entry
point's `parse_mesh_arg`).

The JAX package lays its devices out on four axes, data, fsdp, model and
seq. The port runs one process a card, and the ranks of torch.distributed
are the mesh's devices; it implements the data axis (data parallelism,
ZeRO-1). A mesh with fsdp, model or seq above 1 is refused, naming
PARALLEL_GAPS.
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


def make_mesh(shape: Optional[Dict[str, int]], world_size: int) -> Mesh:
    """The mesh over `world_size` ranks (JAX's make_mesh over its
    devices): unspecified axes are 1; without a `data` entry the data axis
    takes what the others leave; with one, the product must equal the
    world size. An unknown axis raises ValueError, fsdp, model or seq
    above 1 NotImplementedError."""
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
    beyond = {a: n for a, n in mesh.shape.items() if a != "data" and n > 1}
    if beyond:
        raise NotImplementedError(
            f"mesh axes {beyond} are not ported yet: the port implements "
            f"the data axis alone (see {PARALLEL_GAPS})")
    return mesh


def data_shard_count(mesh: Mesh) -> int:
    """Ways the batch is split (data x fsdp)."""
    return mesh.data * mesh.fsdp


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
