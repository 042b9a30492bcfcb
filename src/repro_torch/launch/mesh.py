"""Meshes of the port: ``pod``, ``data`` and ``model`` axes, in one process or over a process group.

Port of ``repro.launch.mesh``.  ``pod`` is the data-center axis: what
crosses it rides the WAN.  ``data`` is intra-pod data parallelism with
FSDP sharding and ``model`` tensor parallelism
(:mod:`repro_torch.distributed.sharding` places every leaf on them).  Two
kinds of mesh:

* one process (the world size is 1, or no process group is started): only
  a mesh whose ``data`` and ``model`` are 1.  The pods stay the LEADING
  dimension of the tensors on one device, as
  :mod:`repro_torch.distributed.sync` stacks them.  Such a mesh is a
  :class:`LocalMesh`, which only names its axes and their sizes;
* one rank per device of the mesh (the world size equals the product of
  the axes): a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks,
  pod-major, as the JAX package lays devices out.  The WAN strategies run
  as collectives over its ``pod`` dimension
  (:mod:`repro_torch.distributed.pod_group`), FSDP and tensor parallelism
  as DTensor placements over ``data`` and ``model``.

Any other shape raises a ``ValueError`` that names the mesh's size and the
world's.  No mesh drops an axis it was asked for.

Functions, not module-level meshes: importing this module touches no
process group and no device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A mesh in one process: ``shape`` maps each axis name to its size,
    in order, as ``jax.sharding.Mesh.shape`` does."""

    shape: Dict[str, int]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)


def _world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = "cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks), as
    the JAX package's; a world of another size raises ``ValueError``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = AXES if multi_pod else AXES[1:]
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *, device: DeviceLike = "cuda",
              ranks: Optional[Sequence[int]] = None):
    """A mesh of ``shape`` over ``axes`` (distinct names of ``pod``,
    ``data``, ``model``).  With ``ranks`` (every rank of the started group
    calls this, as a new group needs), a ``DeviceMesh`` over those ranks,
    and None on a rank outside them; else, in a started process group whose
    world size equals the product of ``shape``, a ``DeviceMesh`` over every
    rank on ``device``'s type; in one process, a :class:`LocalMesh` when
    ``data`` and ``model`` are 1.  Any other shape raises ``ValueError``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes) or not set(axes) <= set(AXES):
        raise ValueError(f"mesh shape {shape} over axes {axes}: axes must be distinct names of {AXES}")
    sizes = dict(zip(axes, shape))
    size, world = math.prod(shape), _world_size()
    if ranks is not None:
        ranks = [int(r) for r in ranks]
        if len(ranks) != size:
            raise ValueError(f"a mesh of {size} devices {sizes} over {len(ranks)} ranks {ranks}")
        from torch.distributed.device_mesh import DeviceMesh

        mesh = DeviceMesh(resolve_device(device).type, torch.tensor(ranks).reshape(shape), mesh_dim_names=axes)
        return mesh if dist.get_rank() in ranks else None
    if world == 1 and all(sizes.get(a, 1) == 1 for a in ("data", "model")):
        return LocalMesh(sizes)
    if size != world:
        raise ValueError(f"a mesh of {size} devices {sizes} in a world of {world} ranks: "
                         f"the world size must equal the mesh's")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def make_host_mesh(*, pods: int = 1, data: Optional[int] = None, model: int = 1, device: DeviceLike = "cuda"):
    """The JAX package's host mesh: ``("pod", "data", "model")`` when
    ``pods > 1``, else ``("data", "model")``.  ``data`` defaults to what
    the world size leaves: world / (pods x model)."""
    if data is None:
        data = max(_world_size() // (pods * model), 1)
    if pods > 1:
        return make_mesh((pods, data, model), AXES, device=device)
    return make_mesh((data, model), AXES[1:], device=device)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    if isinstance(mesh, LocalMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def is_group_mesh(mesh) -> bool:
    """Whether the pods of ``mesh`` are ranks of a process group."""
    return mesh is not None and not isinstance(mesh, LocalMesh)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch is split over."""
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def num_pods(mesh) -> int:
    return mesh_shape(mesh).get("pod", 1)


def chips_per_pod(mesh) -> int:
    total = 1
    for size in mesh_shape(mesh).values():
        total *= size
    return total // num_pods(mesh)


def _axis_group(mesh, axis: str):
    if not is_group_mesh(mesh) or axis not in mesh_shape(mesh):
        return None
    return mesh.get_group(axis)


def pod_process_group(mesh):
    """The process group of ``mesh``'s ``pod`` dimension (None in one
    process or without a pod axis)."""
    return _axis_group(mesh, "pod")


def data_process_group(mesh):
    """The process group of ``mesh``'s ``data`` dimension: the rank's FSDP peers."""
    return _axis_group(mesh, "data")


def model_process_group(mesh):
    """The process group of ``mesh``'s ``model`` dimension: the rank's
    tensor-parallel peers."""
    return _axis_group(mesh, "model")


def intra_pod_mesh(mesh):
    """The rank's pod as a ``(data, model)`` ``DeviceMesh`` (the axes the
    mesh has of the two), on which parameters, batch and caches are placed;
    None for a :class:`LocalMesh` or a mesh whose data and model are 1."""
    if not is_group_mesh(mesh) or chips_per_pod(mesh) == 1:
        return None
    names = tuple(a for a in AXES[1:] if a in mesh_shape(mesh))
    return mesh[names] if names != tuple(mesh.mesh_dim_names) else mesh


def pod_index(mesh) -> int:
    """The rank's pod (0 in one process or without a pod axis)."""
    if not is_group_mesh(mesh) or "pod" not in mesh_shape(mesh):
        return 0
    return mesh.get_local_rank("pod")
