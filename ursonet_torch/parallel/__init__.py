"""Parallelism over `torch.distributed` ranks, the counterpart of
`ursonet_tpu/parallel/`: one process a rank, a (data, model) mesh of
them (`mesh.py`), the batch split over 'data' with the gradients summed
over it, the head denses split over 'model' in the Megatron pattern
(`sharding.py`, `models/heads.py`), and per-rank input slices and rank-0
writes (`multihost.py`).
"""

from ursonet_torch.parallel import multihost
from ursonet_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, Mesh, \
    make_mesh
from ursonet_torch.parallel.sharding import gather_state, replicated, \
    shard_batch, shard_model, shard_state

__all__ = [
    'AXIS_DATA', 'AXIS_MODEL', 'Mesh', 'make_mesh', 'multihost',
    'gather_state', 'replicated', 'shard_batch', 'shard_model',
    'shard_state',
]
