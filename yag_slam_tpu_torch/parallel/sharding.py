"""Device-mesh helpers on ``torch.distributed``.

Counterpart of ``yag_slam_tpu/parallel/sharding.py``.  The JAX package
scales through a ``jax.sharding.Mesh`` and ``shard_map``; the port runs one
process per device (``torchrun --nproc-per-node N`` on cards, or processes
of its own with gloo on the CPU) and a 1-D
``torch.distributed.device_mesh.DeviceMesh`` over them.  The workload's
parallel axes:

- **dp** (candidate-parallel): loop-closure chains are independent match
  jobs, sharded over the ranks and all-gathered (``loop_search``);
- the global SPA solve all-reduces per-edge normal-equation contributions
  (``dist_spa``).

Multi-host entry: call :func:`initialize_multihost` (or run under
``torchrun``) before building the mesh.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from yag_slam_tpu_torch._device import DEFAULT_DEVICE, resolve_device

# the collective backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _local_rank():
    """This process's card on its host: torchrun's LOCAL_RANK, else the
    global rank modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % torch.cuda.device_count()


def default_mesh(n_devices=None, axis_name="dp", *, device=DEFAULT_DEVICE):
    """1-D data-parallel mesh named `axis_name` over every rank of the
    default process group, on `device`'s type (NCCL on cuda, each rank on
    card LOCAL_RANK; gloo on cpu).

    With no process group and no RANK / WORLD_SIZE in the environment
    (a plain single process), it starts a one-rank group itself; under
    torchrun it joins the launcher's group.  `n_devices` other than None
    or the world size raises ValueError: a mesh spans every rank."""
    dev = resolve_device(device)
    backend = BACKENDS[dev.type]
    if not dist.is_initialized():
        if "RANK" in os.environ or "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, a {dev.type} "
                         f"mesh needs {backend}")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} "
                         "ranks: a mesh spans every rank")
    if dev.type == "cuda":
        torch.cuda.set_device(_local_rank())
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis_name,))


def _mesh_axis(mesh, axis):
    """(process group, size, this process's rank in it) of `mesh`'s
    `axis`."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def initialize_multihost(coordinator=None, num_processes=None, process_id=None,
                         *, device=DEFAULT_DEVICE):
    """Join a `num_processes`-rank process group through the TCP store at
    `coordinator` ("host:port"; rank 0 serves it) as rank `process_id`,
    with `device`'s backend (NCCL on cuda, gloo on cpu).  For None or 1
    process this is a no-op."""
    if num_processes in (None, 1):
        return
    backend = BACKENDS[resolve_device(device).type]
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))
