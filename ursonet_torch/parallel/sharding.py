"""What is split over the mesh, and how tensors move between their
shards and their whole: the counterpart of
`ursonet_tpu/parallel/sharding.py` and of the `with_partitioning`
annotations of `ursonet_tpu/models/heads.py`.

Split over 'model' (torch layout, weight [out, in]):
  * every hidden `{prefix}_dense_{i}`: column-parallel, its out features
    split (weight axis 0, bias too), and under TRAIN_BN=True the
    `{prefix}_bn_{i}` after it, whose features follow;
  * the final dense: row-parallel (weight axis 1, bias whole) when
    NR_DENSE_LAYERS > 0, column-parallel (weight and bias axis 0) when
    NR_DENSE_LAYERS == 0;
  * the keypoint head's `k*_final` stay whole.
Everything else is replicated. A width that does not divide over 'model'
is split unevenly (`split_bounds`), as the JAX package serves such
widths too (XLA pads). The batch is split over 'data' (`shard_batch`).

The collectives the split needs are autograd functions over a process
group: the Megatron pair (`copy_to`: identity forward, all-reduce
backward; `reduce_from`: all-reduce forward, identity backward),
`gather_from` (the whole activation from its feature shards, by an
all-reduce of the zero-padded shard: gloo on CUDA tensors has all-reduce
and broadcast, no all-gather), `all_reduce_sum` (all-reduce both ways:
batch statistics over 'data') and `global_sum` (all-reduce forward,
identity backward: a loss over the global batch whose gradient is this
rank's part).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ursonet_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL

# name -> (axis, whole length) of every split tensor of a model
Split = Dict[str, Tuple[int, int]]

_HIDDEN = re.compile(r'(loc|ori)_head\.(loc|ori)_(dense|bn)_\d+\.'
                     r'(weight|bias|running_mean|running_var)')
_FINAL = re.compile(r'(loc|ori)_head\.(loc_final|ori_final|ori_q)\.'
                    r'(weight|bias)')


def split_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of shard `index` of `parts` over a length n (the first
    shards one shorter where n does not divide)."""
    return index * n // parts, (index + 1) * n // parts


def split_axes(state_dict, nr_dense_layers: int) -> Split:
    """{name: (axis, whole length)} of the tensors of a whole model's
    state_dict that split over 'model'."""
    out = {}
    for name, t in state_dict.items():
        if _HIDDEN.fullmatch(name):
            axis = 0
        elif _FINAL.fullmatch(name):
            if nr_dense_layers > 0:
                if name.endswith('.bias'):
                    continue          # row-parallel: the bias stays whole
                axis = 1
            else:
                axis = 0
        else:
            continue
        out[name] = (axis, int(t.shape[axis]))
    return out


def shard_state(state_dict, mesh, split: Split) -> dict:
    """This rank's shards of a whole state_dict (parameters, buffers or
    one optimizer slot); tensors that do not split, or whose length
    differs from the split's whole (a by-name load skips them by shape),
    pass as they are."""
    m, parts = mesh.index(AXIS_MODEL), mesh.shape[AXIS_MODEL]
    out = {}
    for name, t in state_dict.items():
        if name in split and parts > 1:
            axis, n = split[name]
            if t.dim() > axis and t.shape[axis] == n:
                lo, hi = split_bounds(n, parts, m)
                t = t.narrow(axis, lo, hi - lo).contiguous()
        out[name] = t
    return out


def gather_state(state_dict, mesh, split: Split) -> dict:
    """The whole tensors of a sharded state_dict (collective over
    'model': every rank of a model group must call it). Each split
    tensor is zero-padded to its whole and all-reduced, on its own
    device."""
    group, parts = mesh.group(AXIS_MODEL), mesh.shape[AXIS_MODEL]
    m = mesh.index(AXIS_MODEL)
    out = {}
    for name, t in state_dict.items():
        if name in split and parts > 1:
            axis, n = split[name]
            shape = list(t.shape)
            shape[axis] = n
            whole = torch.zeros(shape, dtype=t.dtype, device=t.device)
            lo, hi = split_bounds(n, parts, m)
            whole.narrow(axis, lo, hi - lo).copy_(t)
            dist.all_reduce(whole, group=group)
            t = whole
        out[name] = t
    return out


class Gathered:
    """The whole weights of a sharded model, as `checkpoint/store.py`
    reads a model: `state_dict()` and `named_parameters()` (tensors on
    the CPU). Made by `gathered(model, mesh)`."""

    def __init__(self, state_dict, param_names):
        self._sd = state_dict
        self._params = list(param_names)

    def state_dict(self):
        return dict(self._sd)

    def named_parameters(self):
        return [(n, self._sd[n]) for n in self._params]


def gathered(model, mesh) -> Gathered:
    """A copy of the whole weights of `model` on the CPU (collective over
    'model'; the model as it is where it is not split)."""
    sd = gather_state(model.state_dict(), mesh, model_split(model))
    return Gathered({k: v.detach().to('cpu', copy=True)
                     for k, v in sd.items()},
                    [n for n, _ in model.named_parameters()])


def model_split(model) -> Split:
    """The split a model was sharded with (empty when whole)."""
    return getattr(model, 'tp_split', None) or {}


# ---------------------------------------------------------------------------
# the model


def shard_model(model, mesh, config):
    """Split a whole model (built on every rank from the same seed) over
    `mesh` in place: the heads keep their shards of the denses (and of
    the head batch norms) as column- and row-parallel layers when
    'model' splits, and every batch norm takes its batch statistics over
    'data' when 'data' splits, as every ConvQ8 (TRAIN_ACT_Q8) takes its
    g-scale and its int32 guard. Records the split as `model.tp_split`.
    Returns the model."""
    from ursonet_torch.models.actq import ConvQ8
    from ursonet_torch.models.heads import shard_heads
    from ursonet_torch.models.resnet import FrozenBN
    split = {}
    if mesh.shape[AXIS_MODEL] > 1:
        split = split_axes(model.state_dict(), config.NR_DENSE_LAYERS)
        shard_heads(model, mesh)
    model.tp_split = split
    data = mesh.split(AXIS_DATA)
    for mod in model.modules():
        if isinstance(mod, (FrozenBN, ConvQ8)):
            mod.data_group = data
            mod.data_size = mesh.shape[AXIS_DATA]
    return model


# ---------------------------------------------------------------------------
# the batch


def shard_batch(mesh, batch: dict) -> dict:
    """This rank's rows of a global batch dict (arrays or tensors)."""
    from ursonet_torch.parallel.multihost import local_batch_slice
    first = next(iter(batch.values()))
    lo, hi = local_batch_slice(mesh, len(first))
    return {k: v[lo:hi] for k, v in batch.items()}


def replicated(mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Make `tensor` equal on every rank: broadcast in place from rank 0
    (nothing to do without a process group). Returns it."""
    if mesh.device_mesh is not None and dist.get_world_size() > 1:
        dist.broadcast(tensor, src=int(mesh.ranks.flat[0]))
    return tensor


def gather_rows(x: torch.Tensor, group, via_host: bool = False
                ) -> torch.Tensor:
    """The rows of every rank of `group`, in rank order (collective; all
    ranks hold the same number of rows). Under NCCL an all-gather on the
    card; under gloo an all-gather on the host with `via_host` (the
    tensor comes back on the CPU), else, for a CUDA tensor, an
    all-reduce of the zero-padded rows on its device."""
    parts = dist.get_world_size(group)
    backend = dist.get_backend(group)
    if backend == 'nccl':
        out = torch.empty((parts * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    if via_host or not x.is_cuda:
        x = x.detach().cpu().contiguous()
        got = [torch.empty_like(x) for _ in range(parts)]
        dist.all_gather(got, x, group=group)
        return torch.cat(got)
    i = dist.get_group_rank(group, dist.get_rank())
    n = x.shape[0]
    out = torch.zeros((parts * n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[i * n:(i + 1) * n] = x
    dist.all_reduce(out, group=group)
    return out


# ---------------------------------------------------------------------------
# collectives under autograd


def all_reduce_bucket(tensors, group) -> None:
    """Sum `tensors` over `group` in place, as one flat bucket: one
    all-reduce for all of them (the gradients of a step)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a
    column-parallel layer."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel layer."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """The whole last axis from this rank's [lo, hi) of it (all-reduce of
    the zero-padded shard forward, the shard's slice of the gradient
    backward: what follows is replicated over the group)."""

    @staticmethod
    def forward(ctx, x, group, n, lo, hi):
        ctx.lo, ctx.hi = lo, hi
        out = torch.zeros(tuple(x.shape[:-1]) + (n,), dtype=x.dtype,
                          device=x.device)
        out[..., lo:hi] = x
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.hi].contiguous(), None, None, None, None


class _AllReduceSum(torch.autograd.Function):
    """All-reduce forward and backward (a sum over ranks that each
    rank's loss depends on)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GlobalSum(torch.autograd.Function):
    """All-reduce forward, identity backward: the global batch's value
    on every rank, and this rank's part of its gradient (the gradient
    all-reduce sums the parts)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x, group):
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    return _ReduceFrom.apply(x, group)


def gather_from(x, group, n: int, lo: int, hi: int):
    return _GatherFrom.apply(x, group, n, lo, hi)


def all_reduce_sum(x, group):
    return _AllReduceSum.apply(x, group)


def global_sum(x, group):
    return _GlobalSum.apply(x, group)


def scale_grad(x: torch.Tensor, factor: float) -> torch.Tensor:
    """x forward; its gradient times `factor` backward: a term every data
    rank computes whole (the L2 term, the Kendall log-variances), whose
    gradient the all-reduce over 'data' would otherwise count D times."""
    return x.detach() + (x - x.detach()) * factor


class DataReduce:
    """The losses' reduction over the global batch: `sum(x)` all-reduces
    a rank's partial sum over 'data' (its gradient stays this rank's
    part), `size` is the number of data ranks (each holds the same
    number of rows)."""

    def __init__(self, group, size: int):
        self.group = group
        self.size = int(size)

    def sum(self, x):
        return global_sum(x, self.group)


def data_reduce(mesh) -> Optional[DataReduce]:
    """The DataReduce of a mesh whose 'data' axis splits, else None."""
    group = mesh.split(AXIS_DATA) if mesh is not None else None
    return None if group is None else DataReduce(group,
                                                 mesh.shape[AXIS_DATA])


def slice_draws(draws, lo: int, hi: int):
    """Rows [lo, hi) of one global batch's augmentation draws
    (`DevicePreprocess.draw`): every per-image tensor is sliced;
    sim2real's batch-wide op order ('order' [5], unless per image [B,5])
    is kept whole."""
    if draws is None:
        return None
    out = {}
    for k, v in draws.items():
        if isinstance(v, dict):
            out[k] = slice_draws(v, lo, hi)
        elif k == 'order' and v.dim() == 1:
            out[k] = v
        else:
            out[k] = v[lo:hi]
    return out
