"""Production mesh builders, ported from ``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, built over the default process group, whose
world size must equal the mesh's size.  A job across real devices starts
that group itself (``torch.distributed.init_process_group``, its
address, world size and rank given).

For a mesh larger than the processes there are, ``fake_world(n)`` starts
the ``"fake"`` backend as rank 0 of a world of ``n``: the counterpart of
the reference's forced host devices (``launch/dryrun.py:1-2``).  The fake
group's collectives move no data, so the *values* a program computes on
such a mesh are meaningless; only its shapes, placements, bytes, FLOPs
and collectives count, as in the reference's dry run.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import _device


def fake_world(world_size: int) -> None:
    """Make the default process group rank 0 of a fake world of
    ``world_size`` (a group already so is kept; any other is
    destroyed first)."""
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    try:        # registers the "fake" backend with torch.distributed
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
    except ImportError:     # a torch that builds it in
        pass
    # the fake backend needs a store only to start; an in-process one does
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)


def make_mesh(shape, axes, device=None):
    """A DeviceMesh of ``shape`` named ``axes`` on ``device`` (the GPU
    unless the caller names one) over the default process group."""
    dev = _device.resolve(device, "make_mesh")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {n} devices needs a process group of {n}: start "
            f"one (torch.distributed.init_process_group), or fake_world"
            f"({n}) for a dry run")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a mesh of {n} devices on a process group of "
                           f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod: the
    reference's shapes, so that both dry runs describe one deployment."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_local_mesh(device=None):
    """A single-device mesh with the production axis names; starts a
    one-process group when there is none."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh((1, 1), ("data", "model"), device)


def mesh_num_devices(mesh) -> int:
    n = 1
    for s in mesh.shape:
        n *= s
    return n


def model_axis_size(mesh) -> int:
    return mesh.shape[mesh.mesh_dim_names.index("model")]
