"""Meshes of the port: the pod axis on one device, or over a process group.

Port of ``repro.launch.mesh``.  ``pod`` is the data-center axis: what
crosses it rides the WAN.  Two kinds of mesh carry it:

* one process (the world size is 1, or no process group is started): the
  pods stay the LEADING dimension of the tensors on one device, as
  :mod:`repro_torch.distributed.sync` stacks them.  Such a mesh is a
  :class:`LocalMesh`, which only names its axes and their sizes;
* one rank per pod (the world size equals ``pods``): the mesh is a
  ``torch.distributed.device_mesh.DeviceMesh`` whose ``"pod"`` dimension
  spans the ranks, and the WAN strategies run as collectives over it
  (:mod:`repro_torch.distributed.pod_group`).

Intra-pod axes are not ported yet: a ``data`` or ``model`` axis larger than
1, and the production meshes, raise ``NotImplementedError`` naming ROADMAP
queue 1 item 16 (their sharding rules as DTensor placements).  No mesh
drops an axis it was asked for.

Functions, not module-level meshes: importing this module touches no
process group and no device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch.distributed as dist

from ..device import DeviceLike, resolve_device

AXES = ("pod", "data", "model")
PLACEMENT_TODO = "ROADMAP queue 1 item 16 (intra-pod placement: data/model sharding as DTensor placements)"


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


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod or 2x16x16 multi-pod in the JAX package: intra-pod
    axes, which the port does not place yet."""
    raise NotImplementedError(f"make_production_mesh(multi_pod={multi_pod}): {PLACEMENT_TODO}")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *, device: DeviceLike = "cuda"):
    """A mesh of ``shape`` over ``axes`` (a subset of ``pod``, ``data``,
    ``model``).  ``data`` and ``model`` must be 1.  With a ``pod`` axis
    larger than 1 in a started process group whose world size equals it,
    a ``DeviceMesh`` on ``device``'s type; in one process, a
    :class:`LocalMesh`."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes) or not set(axes) <= set(AXES):
        raise ValueError(f"mesh shape {shape} over axes {axes}: axes must be distinct names of {AXES}")
    sizes = dict(zip(axes, shape))
    wide = {a: n for a, n in sizes.items() if a != "pod" and n > 1}
    if wide:
        raise NotImplementedError(f"mesh axes {wide} larger than 1: {PLACEMENT_TODO}")
    pods, world = sizes.get("pod", 1), _world_size()
    if world == 1:
        return LocalMesh(sizes)
    if pods != world:
        raise ValueError(f"a {pods}-pod mesh in a process group of {world} ranks: one rank per pod")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def make_host_mesh(*, pods: int = 1, data: Optional[int] = None, model: int = 1, device: DeviceLike = "cuda"):
    """The JAX package's host mesh: ``("pod", "data", "model")`` when
    ``pods > 1``, else ``("data", "model")``.  One device per pod:
    ``data`` (default 1) and ``model`` larger than 1 raise."""
    data = 1 if data is None else data
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


def pod_process_group(mesh):
    """The process group of ``mesh``'s ``pod`` dimension (None in one process)."""
    if not is_group_mesh(mesh):
        return None
    return mesh.get_group("pod")
