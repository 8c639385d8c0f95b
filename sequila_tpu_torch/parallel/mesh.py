"""Device mesh for the engine's partition parallelism (port of
sequila_tpu/parallel/mesh.py).

The reference parallelizes with DataFusion partitions on a tokio thread
pool (`target_partitions`), with two distribution modes for the interval
join: CollectLeft (single shared build) and Partitioned (hash-partitioned
both sides) — reference interval_join.rs:258-321,385-404.  The JAX package
runs Partitioned mode as shard_map programs over a ('part', 'probe') mesh:

- mesh axis 'part': key-hash partition of the build side;
- mesh axis 'probe': row-parallel split of the probe rows within each
  partition.

The port keeps the axes: a ``Mesh`` is an array of ``torch.device``s
shaped (part, probe) with the rank of the process that owns each shard,
and a shard program is a plain function over tensors placed on its
shard's device (parallel/partitioned_join.py).  Each process runs the
shards it owns (``is_local``); a single-process mesh owns them all.  An
owner cannot be read off its device: two processes sharing a card both
hold ``cuda:0``, and every CPU shard is ``cpu``.  Devices may repeat: a
CPU mesh places every shard on the one host device, as JAX's virtual CPU
devices share one host.
"""

from __future__ import annotations

import numpy as np
import torch

from sequila_tpu_torch.parallel.distributed import world


class Mesh:
    """A (part, probe) array of torch devices with the JAX mesh's axis
    names; ``devices[p, q]`` runs shard (p, q) in process ``owners[p, q]``
    (all 0 when ``owners`` is not given)."""

    axis_names = ("part", "probe")

    def __init__(self, devices: np.ndarray, owners: np.ndarray | None = None):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError("a mesh is a non-empty (part, probe) array of devices")
        if owners is None:
            owners = np.zeros(devices.shape, np.int64)
        if owners.shape != devices.shape:
            raise ValueError(f"owners {owners.shape} do not match devices {devices.shape}")
        self.devices = devices
        self.owners = owners

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, part: int, probe: int = 0) -> torch.device:
        return self.devices[part, probe]

    def is_local(self, part: int, probe: int = 0) -> bool:
        """Whether this process owns shard (part, probe)."""
        return int(self.owners[part, probe]) == world()[0]

    def __repr__(self) -> str:
        names = [str(d) for d in self.devices.reshape(-1)]
        owners = self.owners.reshape(-1).tolist()
        return (f"Mesh(part={self.shape['part']}, probe={self.shape['probe']}, "
                f"devices={names}, owners={owners})")


def make_mesh(devices, part: int | None = None, owners=None) -> Mesh:
    """A (part, probe) mesh over ``devices``, with the JAX package's
    squarest split (the largest part <= sqrt(n) dividing n) unless ``part``
    is given; ``owners`` names each device's process (all 0 by default)."""
    devs = list(devices)
    owners = [0] * len(devs) if owners is None else list(owners)
    if len(owners) != len(devs):
        raise ValueError(f"{len(owners)} owners for {len(devs)} devices")
    n = len(devs)
    if part is None:
        part = 1
        for p in range(int(np.sqrt(n)), 0, -1):
            if n % p == 0:
                part = p
                break
    probe = n // part
    grid = np.empty((part, probe), dtype=object)
    for i, d in enumerate(devs[: part * probe]):
        grid[i // probe, i % probe] = torch.device(d)
    return Mesh(grid, np.asarray(owners[: part * probe], np.int64).reshape(part, probe))
