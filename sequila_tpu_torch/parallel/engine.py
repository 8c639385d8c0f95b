"""Engine-facing mesh acquisition for Partitioned-mode execution (port of
sequila_tpu/parallel/engine.py).

The reference's IntervalJoinExec declares a hash-partitioned required
distribution when PartitionMode::Partitioned is selected and executes a
per-partition build (reference interval_join.rs:385-404, :459-510);
DataFusion picks partition counts from `target_partitions`.  Here, as in
the JAX package, `SET datafusion.execution.target_partitions = N` (or a
verb's ``partitions=N``) makes the join run its count, pairs, nearest,
per-probe-count and coverage paths as shard programs over a (part, probe)
mesh (parallel/partitioned_join.py).

The mesh shrinks to the devices there are, as in the JAX package:
- on CUDA, ``torch.cuda.device_count()`` cards, starting at the named
  card.  One card gives a 1-shard mesh, which still executes the
  partitioned program (the degenerate single-shard case, like the
  reference running Partitioned mode on one core);
- on the CPU, the number of host devices JAX itself would have: the
  ``--xla_force_host_platform_device_count`` of ``XLA_FLAGS``, read
  without importing JAX, else 1.  Every shard then runs on the one host
  device, as JAX's virtual CPU devices share one host, so both packages
  build meshes of the same shape from the same environment.

Once a process group is initialized (parallel/distributed.initialize),
the mesh spans every process's devices: each rank contributes its local
devices (on CUDA its own card, on the CPU its host devices), gathered in
rank order as ``jax.devices()`` orders them, and each shard records the
rank that owns it.  Every rank must then call ``get_engine_mesh`` in the
same order, as every rank of a JAX program builds the same mesh.
"""

from __future__ import annotations

import functools
import os
import re

import torch
import torch.distributed as dist

from sequila_tpu_torch.parallel import distributed
from sequila_tpu_torch.parallel.mesh import Mesh, make_mesh


def host_device_count() -> int:
    """The CPU devices JAX would create: XLA_FLAGS'
    --xla_force_host_platform_device_count, else 1."""
    m = re.search(r"--xla_force_host_platform_device_count=(\d+)",
                  os.environ.get("XLA_FLAGS", ""))
    return max(int(m.group(1)), 1) if m else 1


def global_devices(device: torch.device) -> tuple[tuple, tuple]:
    """(devices, owners): every process's devices of ``device``'s type in
    rank order (this process's first when it is alone) and the rank that
    owns each."""
    local = distributed.local_devices(device)
    world = distributed.world()
    if world[1] == 1:
        return local, (0,) * len(local)
    return _gathered(local, world)


@functools.lru_cache(maxsize=8)
def _gathered(local: tuple, world: tuple[int, int]) -> tuple[tuple, tuple]:
    """Every rank's ``local`` devices in rank order, with their owners: a
    collective once per (local devices, world)."""
    every = [None] * world[1]
    dist.all_gather_object(every, [str(d) for d in local])
    devs = tuple(torch.device(d) for names in every for d in names)
    owners = tuple(r for r, names in enumerate(every) for _ in names)
    return devs, owners


@functools.lru_cache(maxsize=8)
def _cached_mesh(devices: tuple, owners: tuple, part: int | None) -> Mesh:
    return make_mesh(devices, part=part, owners=owners)


def get_engine_mesh(target_partitions: int, device) -> Mesh | None:
    """The engine's execution mesh for Partitioned mode on ``device``'s
    type, or None when single-device execution is configured
    (target_partitions <= 1)."""
    if target_partitions <= 1:
        return None
    devs, owners = global_devices(torch.device(device))
    n = min(target_partitions, len(devs))
    return _cached_mesh(devs[:n], owners[:n], None)


def get_flat_mesh(mesh: Mesh) -> Mesh:
    """A 1-D ('part'=n, 'probe'=1) mesh over the same devices and owners:
    the shuffle exchanges over the 'part' axis only, so the flat layout
    gives it every device as an exchange partner."""
    devs = tuple(mesh.devices.reshape(-1))
    return _cached_mesh(devs, tuple(int(o) for o in mesh.owners.reshape(-1)), len(devs))
