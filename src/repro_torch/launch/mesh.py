"""Production mesh construction on ``torch.distributed``.

The port of the reference's ``launch/mesh.py``. Functions, not module
constants: importing this module touches no process group. Each builder
lays a :class:`~torch.distributed.device_mesh.DeviceMesh` over the default
process group that is already running (the caller starts it, with its
address, world size and rank) and raises ``ValueError`` when the group's
world size does not fit the mesh. The dry run (``launch.dryrun``) starts a
fake group of 256 or 512 ranks on the host and passes ``device_type="cpu"``.

Mesh axes:
  single-pod:  ("data", "model")         = (16, 16)    -> 256 ranks
  multi-pod:   ("pod", "data", "model")  = (2, 16, 16) -> 512 ranks

"model" carries TP/SP/EP; ("pod", "data") carry DP; "data" additionally
carries ZeRO-1 optimizer-state sharding.

:class:`MeshShape` is a mesh's shape and axis names without a group: the
sharding rules (``launch.sharding``) read only those, so they take either.
"""

from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

__all__ = ["MeshShape", "production_shape", "make_production_mesh", "make_host_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim sizes and names, e.g. ``MeshShape((16, 16), ("data", "model"))``."""

    sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """{axis name: size}, as the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @classmethod
    def of(cls, mesh) -> "MeshShape":
        """The shape of a ``DeviceMesh`` (or a ``MeshShape`` as it is)."""
        if isinstance(mesh, MeshShape):
            return mesh
        return cls(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def _init(shape: MeshShape, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError(f"a {shape.sizes} mesh needs a running process group of "
                         f"{shape.size} ranks; none is running")
    world = dist.get_world_size()
    if world != shape.size:
        raise ValueError(f"a {shape.sizes} mesh needs {shape.size} ranks; the process "
                         f"group has {world}")
    return init_device_mesh(device_type, shape.sizes, mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")."""
    return _init(production_shape(multi_pod=multi_pod), device_type)


def make_host_mesh(model_axis: int = 1, *, device_type: str = "cuda"):
    """(world // model_axis, model_axis) ("data", "model") over the running
    group (tests / local runs)."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    if model_axis < 1 or not world or world % model_axis:
        raise ValueError(f"model_axis {model_axis} must divide the running group's "
                         f"world size ({world or 'no group'})")
    return _init(MeshShape((world // model_axis, model_axis), ("data", "model")), device_type)
