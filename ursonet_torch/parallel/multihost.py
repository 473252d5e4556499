"""Several processes, one rank each: bring-up, per-rank input slices and
rank-0 writes, the counterpart of `ursonet_tpu/parallel/multihost.py`.

Every rank runs the same program. `initialize` forms the world
(`torch.distributed.init_process_group`), `make_mesh` lays it out as
(data, model), and EACH RANK LOADS ONLY ITS OWN ROWS of every global
batch: the shuffle stream is the same on every rank, so the global
batch's composition agrees with no communication
(`data_generator(batch_slice=...)`). Rank 0 writes the files, after the
head shards are gathered (`fetch_global`).

Launch:
    python -m torch.distributed.run --nproc_per_node N \\
        -m ursonet_torch.pose_estimator train ... --mesh_data D --mesh_model M

Rank r computes on cuda:{LOCAL_RANK}; two ranks never share a card
unless a caller of the library passes `device=` itself.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ursonet_torch.device import resolve_device
from ursonet_torch.parallel.mesh import AXIS_DATA
from ursonet_torch.parallel.sharding import gather_state

# what torch.distributed.run sets for every rank
_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


def rank_device(device='cuda') -> torch.device:
    """The device of this rank: 'cuda' without an index is
    cuda:{LOCAL_RANK}, which must be a visible card; anything else as
    given (`resolve_device`)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        local = int(os.environ.get('LOCAL_RANK', 0))
        resolve_device(dev)
        n = torch.cuda.device_count()
        if local >= n:
            raise RuntimeError(
                f"LOCAL_RANK {local} but {n} CUDA device(s): ranks do not "
                f"share a card (launch at most {n} ranks a node)")
        dev = torch.device('cuda', local)
    return resolve_device(dev)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> bool:
    """Form the world of ranks. Without arguments it reads the
    environment `torch.distributed.run` sets and returns False when
    there is none (one process, no world), as the JAX function does.
    `coordinator_address`: 'host:port' (TCP), or a URL ('tcp://...',
    'file://...'). `device` (default 'cuda', cuda:{LOCAL_RANK}) picks
    the backend: NCCL for a card, gloo for the CPU; `backend=` overrides
    it (gloo over CUDA tensors: several ranks on one card, which only an
    explicit `device=` allows). Returns True once the world is up."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and num_processes is None:
        if not all(k in os.environ for k in _ENV):
            return False
        init_method, rank, world = 'env://', -1, -1
    else:
        init_method = coordinator_address if '://' in coordinator_address \
            else f'tcp://{coordinator_address}'
        rank, world = int(process_id), int(num_processes)
    dev = rank_device('cuda' if device is None else device)
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    kw = {'device_id': dev} if backend == 'nccl' else {}
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)
    return True


def shutdown() -> None:
    """Leave the world (nothing to do without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch_slice(mesh, batch_size: int):
    """The global batch rows this process must load: (lo, hi) where its
    data rows are contiguous (always, one process a rank), else the
    sorted array of the rows. Raises where the batch does not divide
    over 'data'."""
    n_rows = mesh.shape[AXIS_DATA]
    if batch_size % n_rows:
        raise ValueError(f"batch {batch_size} not divisible by the data "
                         f"axis {n_rows}")
    per_row = batch_size // n_rows
    rows = [r for r in range(n_rows)
            if process_index() in mesh.ranks[r].tolist()]
    if not rows:
        raise ValueError("this process holds no row of the data axis")
    if rows == list(range(rows[0], rows[0] + len(rows))):
        return rows[0] * per_row, (rows[-1] + 1) * per_row
    return np.concatenate([np.arange(r * per_row, (r + 1) * per_row)
                           for r in rows])


def slice_rows(batch_slice, batch_size: int) -> np.ndarray:
    """Normalize a batch_slice (None | (lo, hi) | index array) to the
    sorted array of global batch rows it selects."""
    if batch_slice is None:
        return np.arange(batch_size)
    if isinstance(batch_slice, tuple):
        return np.arange(batch_slice[0], batch_slice[1])
    return np.asarray(batch_slice, np.int64)


def shard_batch_local(mesh, local_batch: dict, batch_size: int,
                      batch_slice=None) -> dict:
    """This rank's part of a global batch from its local rows: the rank
    keeps them (there is no global array to assemble). Checks that every
    field holds the rows `batch_slice` (default `local_batch_slice`)
    names."""
    if batch_slice is None:
        batch_slice = local_batch_slice(mesh, batch_size)
    n = len(slice_rows(batch_slice, batch_size))
    for k, v in local_batch.items():
        if int(np.shape(v)[0]) != n:
            raise ValueError(f"'{k}' holds {np.shape(v)[0]} rows, the "
                             f"slice {n}")
    return local_batch


def fetch_global(state_dict, mesh, split) -> dict:
    """The whole state_dict on the CPU, for rank 0's writes (collective
    over 'model': the head shards are gathered)."""
    return {k: v.detach().cpu()
            for k, v in gather_state(state_dict, mesh, split).items()}
