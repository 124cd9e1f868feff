"""Production mesh construction (the assignment's topology).

The port of ``repro/launch/mesh.py``.  FUNCTIONS, not module-level
constants: importing this module starts no process group.  The production
meshes live on the fake world of ``launch/hostsim.py``; their device type
is ``meta``, the tensors the dry run places on them, so DTensor moves
blocks between ranks with the collectives a card's group has (all-to-all
among them), where a ``cpu`` mesh would gather instead.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.launch.hostsim import ensure_fake_world

__all__ = ["make_mesh", "make_production_mesh", "make_host_mesh"]


def make_mesh(shape: Sequence[int], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on a fake world of as
    many ranks (started if need be)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    ensure_fake_world(n)
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips per pod; multi_pod adds a leading pod=2 axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model: int = 1):
    """What this process really has: the ranks of its process group (one,
    in a fake world, without one), as ("data", "model")."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else ensure_fake_world(1)
    model = model if n % model == 0 else 1
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(kind, (n // model, model),
                            mesh_dim_names=("data", "model"))
