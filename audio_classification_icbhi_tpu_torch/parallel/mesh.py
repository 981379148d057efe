"""The 1-D data mesh: ranks, their devices and the process group.

Port of `audio_classification_icbhi_tpu/parallel/mesh.py:1-114` onto
torch.distributed. A JAX mesh is one array of devices that one program is
sharded over; here data parallelism runs one process (rank) per device,
and the ranks meet in a process group: NCCL between CUDA devices, gloo
between CPU processes. A `Mesh` is one rank's view of it:

- `device`: the rank's device;
- `rank`, `world_size`: this process's index and the number of processes
  (JAX's `mesh.devices.size`, one device a rank);
- `group`: the process group, or None when no process group exists (one
  process: the single-device path, with no collective at all);
- `hosts`: the machines the group spans, the port's counterpart of
  `jax.process_count()`: a JAX process drives every device of its machine,
  a port rank drives one device, so N ranks on one machine are one JAX
  process. The device cache stays on over the ranks of one machine and is
  turned off over several (`training/trainer.py`).

The helpers keep the JAX names: `get_mesh`, `init_distributed`,
`local_batch_slice`, `shard_batch`, `replicate`. JAX's
`shard_eval_batch_multihost` has no counterpart: each rank's loader decodes
only its own rows (`data/loader.BatchLoader(shard=...)`). The JAX
analyzer's single-process mesh over several devices is a plain list of
devices in the port (`AnalyzerEngine(devices=...)`). torch.distributed is
imported inside the functions that use it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np
import torch

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    device: torch.device
    rank: int = 0
    world_size: int = 1
    group: Any = None
    hosts: int = 1


def _distributed():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _local_index(rank: int) -> int:
    """A rank's GPU on its machine: torchrun's LOCAL_RANK, else the rank
    modulo the visible GPUs."""
    return int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))


def get_mesh(num_devices: int | None = None, device: str | torch.device = "cuda") -> Mesh:
    """This rank's data mesh. Inside a process group (`init_distributed`):
    its rank, world size and GPU (`num_devices`, if given, must be the
    world size) and the number of machines it spans (one all_gather_object
    of the host names, so every rank of the group must call it). Without
    one: a mesh of one device, `device`; more devices need one rank each."""
    dist = _distributed()
    if dist is None:
        if num_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {num_devices} devices is {num_devices} ranks of one device each, and "
                "this process is in no process group: start the ranks with the train entry's "
                "--num-devices, or join each to a group with init_distributed")
        return Mesh(torch.device(device))
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"requested {num_devices} devices, the process group has {world} "
                         "ranks (one device each)")
    import socket

    rank = dist.get_rank()
    local = torch.device("cuda", _local_index(rank)) if torch.device(device).type == "cuda" \
        else torch.device("cpu")
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    return Mesh(local, rank, world, dist.group.WORLD, hosts=len(set(names)))


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, auto: bool = False,
                     device: str | torch.device = "cuda") -> int:
    """Join the process group of a multi-process run; returns this rank.

    - explicit coordinator_address ("host:port" or "tcp://host:port"),
      num_processes and process_id: `init_process_group` at that address
      (how the train entry starts its ranks, and how tests start one);
    - auto=True without them: torchrun's `env://` variables (MASTER_ADDR,
      MASTER_PORT, WORLD_SIZE, RANK);
    - neither: one process, a no-op that returns 0 (this rank, if a group
      already exists).
    The backend is NCCL for `device` cuda (the rank's GPU selected first),
    gloo for the CPU."""
    import torch.distributed as dist

    if coordinator_address is None and num_processes in (None, 1) and not auto:
        return dist.get_rank() if _distributed() else 0
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is None:
        init = dict(init_method="env://")
        rank = int(os.environ.get("RANK", 0))
    else:
        address = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        init = dict(init_method=address, world_size=int(num_processes or 1),
                    rank=int(process_id or 0))
        rank = init["rank"]
    if device.type == "cuda":
        torch.cuda.set_device(_local_index(rank))
    dist.init_process_group(backend, **init)
    return dist.get_rank()


def close_distributed() -> None:
    """Leave the process group, if this process is in one."""
    dist = _distributed()
    if dist is not None:
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on 127.0.0.1 that no one listens on now (rank 0's
    address for ranks started on this machine)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_batch_slice(global_batch: int, mesh: Mesh | None = None) -> slice:
    """This rank's rows of a global batch (each rank feeds only its own)."""
    rank, n_proc = (mesh.rank, mesh.world_size) if mesh is not None else (0, 1)
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count "
            f"{n_proc}: rows would be silently dropped")
    per_rank = global_batch // n_proc
    return slice(rank * per_rank, (rank + 1) * per_rank)


def shard_batch(mesh: Mesh, *arrays, axis: int = 0):
    """This rank's rows of each array along `axis` (the batch axis), as
    tensors on the rank's device."""
    out = []
    for a in arrays:
        sl = (slice(None),) * axis + (local_batch_slice(a.shape[axis], mesh),)
        out.append(torch.as_tensor(np.ascontiguousarray(a[sl]) if isinstance(a, np.ndarray)
                                   else a[sl]).to(mesh.device, non_blocking=True))
    return tuple(out) if len(out) > 1 else out[0]


def replicate(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Make every rank hold rank 0's values of `tensors` (model parameters
    and buffers, optimizer state), in place. No-op without a group."""
    if mesh.group is None:
        return
    import torch.distributed as dist

    for t in tensors:
        buf = t.data.contiguous()  # a restored optimizer moment may be a transposed view
        dist.broadcast(buf, src=0, group=mesh.group)
        if buf.data_ptr() != t.data.data_ptr():
            t.data.copy_(buf)


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank. No-op without a group."""
    if mesh is not None and mesh.group is not None:
        import torch.distributed as dist

        dist.barrier(group=mesh.group)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Σ over the ranks of `t`, in place (no gradient; the BatchNorm
    statistics carry their own, `models/cnn.SyncBatchNorm`). No-op without a
    group."""
    if mesh is not None and mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(t, group=mesh.group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh | None, dim: int = 0) -> torch.Tensor:
    """Every rank's tensor concatenated in rank order along `dim`: (N·b,
    ...) from (b, ...) at dim 0, as a tiled all_gather; (S, N·b) from (S, b)
    at dim 1, the batch axis of a (steps, batch) array. No-op without a
    group."""
    if mesh is None or mesh.group is None:
        return t
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=dim)
