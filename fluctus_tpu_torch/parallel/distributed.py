"""Multi-host launch layer (the reference package's
parallel/distributed.py, on torch.distributed).

The reference has no distributed path at all (SURVEY §2.3: single-GPU
SIMT); this is the scale-out of SURVEY §5: every process initializes the
process group, the global 1-D mesh orders the ranks host by host, and the
renderer's sharding contract (parallel/mesh.py) is unchanged: the "px"
axis spans every host's cards. Scene tables stay replicated (each host
loads its assets itself: deterministic builders, content-hashed caches),
so the only traffic between hosts is the counters' all_reduce and the
final film gather.

One process per card, started by ``torchrun --nproc-per-node N`` with
``FLT_MULTIHOST=1``. ``init_distributed`` is the environment-driven
initialization (plumbing, gated behind FLT_MULTIHOST), and
``host_mesh_layout``, the part that can be wrong, is a pure function
tested on synthetic host lists.
"""

from __future__ import annotations

import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import flags
from ..renderer import resolve_device


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "nccl") -> bool:
    """Initialize the default process group on ``backend`` (nccl: one card
    per process; gloo where the caller asks for it): rendezvous at
    ``tcp://<coordinator>`` ("host:port") when given, else by torchrun's
    environment (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK),
    with ``num_processes`` and ``process_id`` taking the place of the
    world size and rank when given. Under nccl the process then takes card
    ``rank % device_count`` (torchrun numbers each host's ranks
    contiguously). No-op (returns False) unless FLT_MULTIHOST=1:
    single-process sessions never wait on a rendezvous. A failed
    initialization raises."""
    if not flags.MULTIHOST:
        return False
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}" if coordinator
        else "env://", **kw)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return True


def host_mesh_layout(device_host_ids: Sequence[int]) -> np.ndarray:
    """Order a global device list for the 1-D "px" mesh so that devices of
    the same host are CONTIGUOUS along the axis.

    Contiguity is the load-bearing property: the film and pool are sharded
    by leading-dim slices, so contiguous same-host ranges make every
    film-gather boundary that crosses hosts a single transfer per host
    pair, and keep any future hierarchical reduction (within a host, then
    across) expressible as a reshape to [hosts, devs_per_host].

    Input: per-device host id (here one device per rank, in rank order).
    Returns the permutation to apply to the ranks. Raises if hosts have
    unequal device counts (a ragged mesh cannot reshape to [hosts,
    devs_per_host])."""
    ids = np.asarray(device_host_ids)
    hosts, counts = np.unique(ids, return_counts=True)
    if len(set(counts.tolist())) > 1:
        raise ValueError(f"ragged host device counts: {dict(zip(hosts.tolist(), counts.tolist()))}")
    # stable sort by host id keeps intra-host device order
    return np.argsort(ids, kind="stable")


def make_global_mesh(axis: str = "px", device=None) -> DeviceMesh:
    """Global 1-D mesh over every rank of the process group, host-contiguous
    (see host_mesh_layout): each rank's host name is all-gathered and a
    host's id is its lowest rank. On CUDA unless ``device`` is the CPU.
    Single-process: identical to make_mesh()."""
    dev = resolve_device(device)
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    perm = host_mesh_layout([hosts.index(h) for h in hosts])
    return DeviceMesh(dev.type, torch.as_tensor(perm),
                      mesh_dim_names=(axis,))
