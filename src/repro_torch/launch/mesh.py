"""Device-free mesh shapes (the counterpart of the reference's
``repro/launch/mesh.py``).

The reference builds ``jax.sharding.Mesh`` objects over real or fake
devices: a pod is 16 x 16 = 256 chips, and the multi-pod mesh adds a
leading ``pod`` axis (2 pods = 512 chips for the dry-run).  The port's
dry-run (``launch/dryrun.py``) needs only the axes' names and sizes, so a
:class:`MeshShape` holds those and no devices.

``make_device_mesh`` is the counterpart of ``make_test_mesh`` /
``make_production_mesh`` over real ranks: a ``DeviceMesh`` of the world's
ranks, row-major as ``jax.make_mesh`` lays devices out, with the axes as
its ``mesh_dim_names`` (the sharded train step's mesh).

``fake_device_mesh`` builds a ``DeviceMesh`` of a ``MeshShape``'s size
over PyTorch's ``fake`` process-group backend, seen from one rank: every
collective a DTensor program issues on it is dispatched (so a dispatch
mode can count it) and none is sent.  The dry-run runs the reference's
sharded programs on meta tensors over one (``launch/dryrun.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.groups import group_backend, mesh_groups

__all__ = ["MeshShape", "fake_device_mesh", "make_device_mesh", "make_production_mesh",
           "make_test_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, in order (no devices)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} vs shape {self.shape}")

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model")) -> MeshShape:
    """The small mesh of the reference's 8-device CPU tests."""
    return MeshShape(tuple(axes), tuple(shape))


def make_device_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"), device="cpu") -> DeviceMesh:
    """A ``DeviceMesh`` of the world's ranks (``torch.distributed`` set up
    by the caller, one rank a device or a share of one) of ``shape``, rank
    ``r`` at ``np.unravel_index(r, shape)``, its dims named ``axes``, for
    tensors on ``device``.  Its dim groups come from
    ``core.groups.mesh_groups``: on the world's backend, or host-staged
    gloo groups for the card under a gloo world (``group_backend``)."""
    if len(shape) != len(axes):
        raise ValueError(f"axes {tuple(axes)} vs shape {tuple(shape)}")
    device = torch.device(device)
    world = torch.arange(math.prod(shape)).reshape(tuple(shape))
    groups = mesh_groups(tuple(shape), group_backend(device))
    return DeviceMesh.from_group(groups, device.type, mesh=world,
                                 mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def fake_device_mesh(mesh: MeshShape, rank: int = 0, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names, seen from
    ``rank``, over a default process group of the ``fake`` backend of
    ``mesh.size`` ranks, which this block creates and destroys after it.
    A process holds one default group: the block raises if one exists.
    ``device_type`` is the mesh's: DTensor issues some collectives by it
    (a shard-to-shard move is an all-to-all on ``"cuda"``, an all-gather
    and a cut on ``"cpu"``, as on a gloo mesh of CPU tensors).  No device
    of that type is needed: the tensors are the caller's (meta)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("fake_device_mesh: a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=mesh.size)
    try:
        yield DeviceMesh(device_type, torch.arange(mesh.size).reshape(mesh.shape),
                         mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()
