"""Host meshes over ``torch.distributed`` (port of the host half of
:mod:`repro.launch.mesh`).

The reference is one SPMD process over a device mesh; the port runs one
process a device.  A launcher started by ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in its environment)
joins the process group those variables describe: NCCL on ``cuda``, gloo
on ``cpu``.  With no such environment and no group set up by the caller,
the process runs alone, as the reference runs on its one-device host
mesh.  :func:`make_production_mesh` lays the reference's 256- and
512-chip meshes over a group of that many ranks; the dry run
(:mod:`repro_torch.launch.dryrun`) builds them over a fake group
(:func:`init_fake_group`), in which every collective is a no-op and
every tensor lives on ``meta``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: the backend of each device type: no fallback, a CUDA run never sums
#: its gradients over gloo on the host
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_process_group(device_type: str) -> bool:
    """Join the process group of ``torchrun``'s environment; True when a
    group exists afterwards (one set up by the caller is kept, and must
    use ``device_type``'s backend), False when this process runs alone."""
    want = BACKENDS[device_type]
    if dist.is_initialized():
        got = dist.get_backend()
        if got != want:
            raise RuntimeError(f"the process group runs {got!r}; a "
                               f"{device_type} launcher needs {want!r}")
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(want, init_method="env://")
    return True


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda",
                   n_devices: Optional[int] = None) -> Optional[DeviceMesh]:
    """A ``("data", "model")`` mesh over the first ``n_devices`` ranks of
    the process group (all of them by default); None when this process
    runs alone.

    Every rank of the group must call it (the mesh's sub-groups are made
    by all ranks together); a rank outside the mesh gets one whose
    ``get_coordinate()`` is None.
    """
    if not init_process_group(device_type):
        return None
    n = dist.get_world_size() if n_devices is None else n_devices
    if n % model_axis or n > dist.get_world_size():
        raise ValueError(f"{n} ranks of {dist.get_world_size()} do not "
                         f"form a mesh with a model axis of {model_axis}")
    return DeviceMesh(device_type,
                      torch.arange(n).reshape(n // model_axis, model_axis),
                      mesh_dim_names=("data", "model"))


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks; the leading "pod" axis carries only
    data-parallel traffic (the batch's rows split over ("pod", "data")).
    Over the ranks of the process group, which must hold exactly that
    many: a production mesh never shrinks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"the {'multi-pod' if multi_pod else 'single-pod'}"
                           f" production mesh needs a process group of {n} "
                           f"ranks, not {have}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def init_fake_group(world_size: int) -> None:
    """Be rank 0 of a fake process group of ``world_size`` ranks
    (``torch.testing``'s ``fake`` backend: collectives return at once and
    move nothing), for the dry run and its tests.  A fake group already
    up is replaced; a real one is refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} process group is "
                               f"up: the dry run needs a fake one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def shutdown() -> None:
    """Leave the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
