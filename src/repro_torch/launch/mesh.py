"""Host meshes over ``torch.distributed`` (port of the host half of
:mod:`repro.launch.mesh`).

The reference is one SPMD process over a device mesh; the port runs one
process a device.  A launcher started by ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in its environment)
joins the process group those variables describe: NCCL on ``cuda``, gloo
on ``cpu``.  With no such environment and no group set up by the caller,
the process runs alone, as the reference runs on its one-device host
mesh.  The reference's 256/512-chip ``make_production_mesh`` has no
counterpart (ROADMAP.md, the dry run).
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


def shutdown() -> None:
    """Leave the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
