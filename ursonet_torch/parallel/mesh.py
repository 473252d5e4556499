"""The (data, model) mesh, the counterpart of
`ursonet_tpu/parallel/mesh.py`.

Axes:
  'data'   data parallelism: each data row of the mesh trains or serves
           its rows of the global batch, and the gradients are summed
           over the axis (one all-reduce of one flat bucket a step,
           `parallel/sharding.py::all_reduce_bucket`).
  'model'  tensor parallelism: the head denses are split over it, the
           Megatron pattern (`models/heads.py`).

One process is one rank. The ranks form the grid row-major,
rank = d · MESH_MODEL + m, the layout `init_device_mesh` gives. A
1 × 1 mesh needs no process group (`device_mesh` None): every code path
takes a mesh, and there is no special single-card branch. Under an
initialized process group of one rank the mesh is a real 1 × 1
`DeviceMesh`, and its collectives run over groups of one.

The reference's GPU_COUNT (the number of devices) is MESH_DATA ×
MESH_MODEL (`Config.update`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as dist

AXIS_DATA = 'data'
AXIS_MODEL = 'model'
AXES = (AXIS_DATA, AXIS_MODEL)


class Mesh:
    """This process's place in a (data, model) grid of ranks.

    `shape` {'data': D, 'model': M} and `size` as the JAX mesh has them;
    `device_mesh` the `DeviceMesh` over the world (None for a 1 × 1 mesh
    without a process group); `rank` this process's global rank and
    `index(axis)` its coordinate on an axis; `group(axis)` the process
    group of the axis through this rank (None without a process group);
    `ranks` the grid of global ranks [D, M]."""

    def __init__(self, data: int, model: int, device_mesh=None):
        self.shape = {AXIS_DATA: int(data), AXIS_MODEL: int(model)}
        self.size = int(data) * int(model)
        self.device_mesh = device_mesh
        if device_mesh is None:
            self.rank = 0
            self.ranks = np.zeros((1, 1), np.int64)
        else:
            self.rank = dist.get_rank()
            self.ranks = np.asarray(device_mesh.mesh.tolist(), np.int64)

    def __repr__(self):
        return (f"Mesh(data={self.shape[AXIS_DATA]}, "
                f"model={self.shape[AXIS_MODEL]}, rank={self.rank})")

    def index(self, axis: str) -> int:
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def split(self, axis: str):
        """The group of `axis` where the axis really splits the work (more
        than one rank on it), else None: the paths that change the
        arithmetic (global statistics, a split head, reduced sums) run
        only then, so a mesh of one rank computes the single-process
        step's bits."""
        return self.group(axis) if self.shape[axis] > 1 else None

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes files (rank 0, as the JAX package's
        process 0)."""
        return self.rank == 0


def _device_type() -> str:
    """The DeviceMesh device type of the default process group: 'cuda'
    under NCCL, 'cpu' under gloo (also where gloo carries CUDA tensors:
    the mesh only makes the groups)."""
    return 'cuda' if dist.get_backend() == 'nccl' else 'cpu'


def make_mesh(config=None, data: Optional[int] = None,
              model: Optional[int] = None) -> Mesh:
    """Build the (data, model) mesh over the initialized world.

    Shapes come from the config (MESH_DATA, MESH_MODEL) unless given.
    Without a process group only a 1 × 1 mesh exists; under one, D × M
    must equal the world size."""
    if data is None:
        data = int(getattr(config, 'MESH_DATA', 1)) if config else 1
    if model is None:
        model = int(getattr(config, 'MESH_MODEL', 1)) if config else 1
    if data < 1 or model < 1:
        raise ValueError(f"mesh {data} x {model}: each axis needs >= 1")
    if not (dist.is_available() and dist.is_initialized()):
        if data * model != 1:
            raise RuntimeError(
                f"a {data} x {model} mesh needs torch.distributed with "
                f"{data * model} ranks: launch with `python -m "
                f"torch.distributed.run --nproc_per_node "
                f"{data * model} ...` or call "
                f"parallel.multihost.initialize() first")
        return Mesh(1, 1)
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh {data} x {model} = {data * model} ranks, "
                         f"but the world has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(_device_type(), (data, model),
                          mesh_dim_names=AXES)
    return Mesh(data, model, dm)
