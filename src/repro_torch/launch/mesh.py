"""Mesh construction: twin of ``repro/launch/mesh.py`` on
``torch.distributed``'s ``DeviceMesh``.

``make_mapped_mesh`` is the partitioner's hook into mesh construction:
``device_order`` is a ``core.mapping.MeshMapping.device_to_bin`` array
(logical device ``i`` -> physical device, here the rank
``device_order[i]``), so the makespan search over the machine tree
decides which rank backs each logical mesh coordinate. ``None`` is the
identity. The machine model itself is ``core/machine.py``'s
``MachineSpec``.

A ``DeviceMesh`` needs a process group of at least its size.
:func:`fake_world` is the twin of the reference's dry-run placeholder
devices (512 host devices made by ``XLA_FLAGS``): a ``fake`` process group
of ``n`` ranks, this process being rank 0, whose collectives move nothing.
The placement session traces a cell's step on it with meta-tensor
DTensors (``launch/placement.py``). It refuses to start while another
process group is up, and always destroys its own on exit, so a test
process that runs many cells never leaks a world into the next.

:func:`init_world` starts the real one: the world ``torchrun`` describes
(NCCL on the cards, one rank a card; gloo on the CPU), on which the
trainer and the one-shot server lay their runs out as DTensors. These two
are the only places the port calls ``init_process_group``.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.machine import MachineSpec, machine_for_devices


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[int]:
    """A ``fake`` process group of ``n`` ranks (this process is rank 0)
    for the length of the ``with`` block; yields ``n``. Raises when a
    process group is already initialised."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already up; "
                           "the placement trace needs a world of its own")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=int(n),
                            store=FakeStore())
    try:
        yield int(n)
    finally:
        dist.destroy_process_group()


def world_size() -> int:
    """Ranks of the current process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the current process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def say(*parts) -> None:
    """Print a line from rank 0 alone (every line without a process
    group)."""
    if rank() == 0:
        print(*parts, flush=True)


def from_rank0(obj):
    """``obj`` as rank 0 holds it, on every rank of the current process
    group (``broadcast_object_list``); itself without a group or on one
    rank."""
    if world_size() <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def init_world(device: torch.device, *, force: bool = False,
               store=None) -> torch.device:
    """Start the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``) and return this rank's device: ``cuda:LOCAL_RANK``
    under NCCL for a CUDA ``device``, the CPU under gloo for a CPU one.
    With ``WORLD_SIZE`` unset or 1 no group is started and ``device`` is
    returned as it is, unless ``force`` asks for one (a one-rank world,
    rank 0, on ``store`` when given). Where the caller has started a group
    already, none is started and ``device`` is returned once it is of the
    group's device type. Raises when ``device`` is neither CUDA nor the
    CPU, or not of a running group's type: a rank never moves to another
    device type on its own."""
    import os
    if dist.is_initialized():
        if device.type != _device_type():
            raise ValueError(f"a {dist.get_backend()} process group runs on "
                             f"{_device_type()} devices, not on {device}")
        return device
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1 and not force:
        return device
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_world: no backend for device {device}")
    if n <= 1:
        dist.init_process_group(backend, rank=0, world_size=1, store=store
                                or dist.HashStore())
    else:
        dist.init_process_group(backend, device_id=(
            device if backend == "nccl" else None))
    return device


def _device_type() -> str:
    return "cuda" if (dist.is_initialized()
                      and dist.get_backend() == "nccl") else "cpu"


def make_mapped_mesh(mesh_shape: Sequence[int], axes: Sequence[str],
                     device_order: Optional[np.ndarray] = None,
                     devices: Optional[Sequence[int]] = None):
    """``DeviceMesh`` over ``devices`` (ranks; default: the world's) with
    an explicit logical -> physical assignment: logical device ``i``
    (row-major index into ``mesh_shape``) is backed by rank
    ``devices[device_order[i]]``. The mesh's device type is ``cuda`` on an
    NCCL world, ``cpu`` otherwise (the fake world)."""
    from torch.distributed.device_mesh import DeviceMesh
    devs = np.asarray(list(devices) if devices is not None
                      else range(world_size()), dtype=np.int64)
    shape = tuple(int(s) for s in mesh_shape)
    n = int(np.prod(shape))
    if devs.size < n:
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"got {devs.size}")
    devs = devs[:n]
    if device_order is not None:
        order = np.asarray(device_order)
        if sorted(order.tolist()) != list(range(n)):
            raise ValueError("device_order must be a permutation of "
                             f"range({n})")
        devs = devs[order]
    return DeviceMesh(_device_type(), torch.as_tensor(devs.reshape(shape)),
                      mesh_dim_names=tuple(axes))


def make_machine_mesh(machine: MachineSpec,
                      device_order: Optional[np.ndarray] = None,
                      devices: Optional[Sequence[int]] = None):
    """Mesh of a machine model: shape and axis names from the spec, leaves
    backed in (optionally searched) ``device_order``."""
    shape, axes = machine.mesh_spec()
    return make_mapped_mesh(shape, axes, device_order, devices)


def device_order_of(mesh) -> np.ndarray:
    """Inverse of :func:`make_mapped_mesh`: the rank backing each logical
    device, row-major."""
    return np.asarray(mesh.mesh.reshape(-1).tolist(), dtype=np.int64)


def production_machine(multi_pod: bool = False) -> MachineSpec:
    """The machine the reference's historical ``multi_pod`` flag selects."""
    return MachineSpec.preset("tpu_v5e-512" if multi_pod else "tpu_v5e-256")


def local_device_count() -> int:
    """The devices a run can place on (the reference's
    ``len(jax.devices())``): the world's ranks when a process group is up,
    one rank each, else 1, the process's own device."""
    return world_size()


def serving_mesh_spec(n_devices: Optional[int] = None
                      ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) for a serving process: the production machine
    whose device count matches (256 or 512), else a 1-D ``data`` mesh
    over the local devices."""
    n = local_device_count() if n_devices is None else int(n_devices)
    spec = machine_for_devices(n)
    if spec is not None:
        return spec.mesh_spec()
    return (max(n, 1),), ("data",)


def make_smoke_mesh():
    """The world's ranks as a 1-D ``data`` mesh."""
    return make_mapped_mesh((world_size(),), ("data",))
