"""Multi-process runtime over torch.distributed (port of
sequila_tpu/parallel/distributed.py).

The reference is single-process (SURVEY.md section 2: no MPI/NCCL/Gloo).
The JAX package spans hosts with ``jax.distributed``; the port spans OS
processes with a torch.distributed process group: every process calls
``initialize(...)`` with the group's address, size and its own rank
before its first ``get_engine_mesh`` call.  The engine's mesh then spans
every process's devices (parallel/engine.py), each process places and
runs only the shards it owns (``Mesh.is_local``), and the helpers below
carry the shard programs' sums, gathers and exchanges between processes:
NCCL on the cards (one card a rank), Gloo through host memory on the CPU
(or for several ranks that share a card).

Nothing here detects a cluster: with no ``initialize`` call there is no
group, and every helper is the single-process identity.  In a group the
helpers run their collectives whatever its size, so a 1-rank group runs
the same NCCL or Gloo calls as a larger one.  The backend is the
caller's choice or follows the device; it never falls back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import time

import torch
import torch.distributed as dist

from sequila_tpu_torch.errors import ExecutionError

_DTYPES = (torch.int32, torch.int64)


@dataclasses.dataclass
class CollectiveStats:
    """Collectives run by this process since the last ``reset``: calls,
    host seconds inside them (payload copies to and from the collective's
    device included) and payload bytes sent."""

    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0

    def reset(self) -> None:
        self.calls, self.seconds, self.bytes = 0, 0.0, 0


STATS = CollectiveStats()


def initialize(init_method: str, world_size: int, rank: int, backend: str | None = None,
               *, device="cuda", timeout_s: float = 300.0) -> None:
    """Join the process group (idempotent: a second call with the same
    world size and rank returns, another raises).

    ``init_method`` is ``tcp://host:port``, ``file://path`` or ``env://``.
    ``backend`` defaults to nccl for a CUDA ``device`` and gloo for the
    CPU.  On CUDA the rank's card is ``device``'s index, else rank modulo
    the cards there are; it becomes the current device.  ``timeout_s``
    bounds every collective: a rank that waits longer for its peers
    raises.  One all-reduce proves the group before this returns, so a
    backend that cannot start (NCCL on a card it cannot use) fails here."""
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks (rank "
                f"{dist.get_rank()}) is already initialized"
            )
        return
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    dist.all_reduce(torch.zeros(1, dtype=torch.int64, device=collective_device()))


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) with no group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_multihost() -> bool:
    return world()[1] > 1


def in_group() -> bool:
    """Whether this process joined a process group (of any size)."""
    return dist.is_initialized()


def local_devices(device) -> tuple[torch.device, ...]:
    """The devices of ``device``'s type this process contributes to the
    engine's mesh, ``device`` first.

    On CUDA a rank of a multi-process group owns one card (``device``'s
    index, else the current device that ``initialize`` set); a lone
    process owns every card.  On the CPU a process owns the host devices
    JAX would create (parallel/engine.host_device_count), all the one
    host device."""
    from sequila_tpu_torch.parallel.engine import host_device_count

    device = torch.device(device)
    if device.type == "cuda":
        first = device.index if device.index is not None else torch.cuda.current_device()
        if is_multihost():
            return (torch.device("cuda", first),)
        n = torch.cuda.device_count()
        return tuple(torch.device("cuda", (first + i) % n) for i in range(n))
    return (device,) * host_device_count()


def local_host_info(device="cuda") -> dict:
    """The JAX function's keys: this process's rank, the number of
    processes, its devices of ``device``'s type and the global count."""
    rank, size = world()
    local = [str(d) for d in local_devices(device)]
    return {
        "process_id": rank,
        "num_processes": size,
        "local_devices": local,
        "global_devices": int(all_reduce_sum(len(local))),
    }


def collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the CPU under Gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@contextlib.contextmanager
def _timed(nbytes: int):
    t0 = time.perf_counter()
    yield
    if dist.get_backend() == "nccl":
        torch.cuda.synchronize()
    STATS.calls += 1
    STATS.seconds += time.perf_counter() - t0
    STATS.bytes += nbytes


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over every rank, on the host (``t`` itself when there
    is no group)."""
    if not in_group():
        return t
    with _timed(t.numel() * t.element_size()):
        x = t.to(collective_device())
        dist.all_reduce(x, op=op)
        return x.cpu()


def all_reduce_sum(value: int) -> int:
    """An int summed over every rank in int64 (the psum)."""
    return int(all_reduce(torch.tensor([value], dtype=torch.int64))[0])


@contextlib.contextmanager
def agree():
    """Run a block of rank-local work, then agree on its outcome: if any
    rank's block raised, every rank raises (the failing rank its own
    exception, the others an ExecutionError), so no rank waits in a
    collective for a peer that has left.  One all-reduce of a flag; no
    collective with no group."""
    err = None
    try:
        yield
    except Exception as e:  # re-raised below, once the peers know
        if not in_group():
            raise
        err = e
    if in_group():
        failed = all_reduce(torch.tensor([int(err is not None)], dtype=torch.int64))
        if err is not None:
            raise err
        if int(failed[0]):
            raise ExecutionError(f"{int(failed[0])} peer rank(s) failed in a shard program")


def gather_var(local: list[torch.Tensor], owner_of: list[int]) -> list[torch.Tensor]:
    """Every rank's pieces, on the host: ``local`` holds this rank's
    pieces (slot i of ``owner_of`` names the rank that owns piece i, and
    this rank's pieces come in slot order).  The pieces are int32 or
    int64, one dtype for all, of at most 4 dims, each of its own shape.
    The shapes go first (one all-reduce), then one padded all-gather of
    the flat payload.  Returns the pieces of every slot, in slot order."""
    if not in_group():
        return [t.cpu() for t in local]
    rank, size = world()
    mine = [i for i, o in enumerate(owner_of) if o == rank]
    if len(mine) != len(local):
        raise ValueError(f"rank {rank} owns {len(mine)} pieces, was given {len(local)}")
    # header per slot: dtype code (1-based), ndim, up to 4 dims
    header = torch.zeros(len(owner_of), 6, dtype=torch.int64)
    for i, t in zip(mine, local):
        if t.dim() > 4 or t.dtype not in _DTYPES:
            raise ValueError(f"cannot gather a {t.dtype} tensor of {t.dim()} dims")
        header[i, 0] = _DTYPES.index(t.dtype) + 1
        header[i, 1] = t.dim()
        header[i, 2 : 2 + t.dim()] = torch.tensor(t.shape)
    header = all_reduce(header)
    codes = {int(c) for c in header[:, 0] if c}
    if len(codes) > 1:
        raise ValueError("gathered pieces differ in dtype")
    dtype = _DTYPES[codes.pop() - 1] if codes else torch.int64
    shapes = [tuple(int(d) for d in h[2 : 2 + int(h[1])]) for h in header]
    numel = [int(torch.tensor(s).prod()) if s else 1 for s in shapes]
    per_rank = [sum(n for n, o in zip(numel, owner_of) if o == r) for r in range(size)]
    width = max(max(per_rank), 1)
    dev = collective_device()
    flat = torch.zeros(width, dtype=dtype, device=dev)
    if local:
        payload = torch.cat([t.reshape(-1).to(dev, dtype) for t in local])
        flat[: payload.numel()] = payload
    with _timed(width * flat.element_size()):
        out = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(out, flat)
        out = [o.cpu() for o in out]
    pieces, cursor = [], [0] * size
    for s, n, o in zip(shapes, numel, owner_of):
        pieces.append(out[o][cursor[o] : cursor[o] + n].reshape(s))
        cursor[o] += n
    return pieces


def all_to_all_rows(send: dict[int, torch.Tensor], recv_rows: dict[int, int],
                    k: int) -> dict[int, torch.Tensor]:
    """The uneven all_to_all: ``send[r]`` is the int32 [rows, k] block for rank
    r (a missing rank gets nothing), ``recv_rows[r]`` the rows rank r
    sends here (known from counts exchanged first).  One
    ``all_to_all_single`` call; this rank's own block is not sent.
    Returns the received blocks by source rank, on the collective's
    device."""
    rank, size = world()
    dev = collective_device()
    in_splits = [0 if r == rank else int(send[r].shape[0]) if r in send else 0
                 for r in range(size)]
    out_splits = [0 if r == rank else int(recv_rows.get(r, 0)) for r in range(size)]
    blocks = [send[r].to(dev, torch.int32) for r in range(size) if in_splits[r]]
    inp = torch.cat(blocks) if blocks else torch.empty((0, k), dtype=torch.int32, device=dev)
    out = torch.empty((sum(out_splits), k), dtype=torch.int32, device=dev)
    with _timed(inp.numel() * inp.element_size()):
        dist.all_to_all_single(out, inp, out_splits, in_splits)
    recv, lo = {}, 0
    for r, n in enumerate(out_splits):
        recv[r] = out[lo : lo + n]
        lo += n
    return recv
