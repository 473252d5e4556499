"""The staged host-to-device copy (`ursonet_torch/utils/staging.py`) on
the CPU: the chunk plan, and the copy loop driven through a ring of host
buffers that logs its waits and records in place of the card's events.
The copy into a card's tensor is checked on the card
(`tests/test_torch_cuda.py`, chip_smoke.py's staging check)."""

import sys
import threading

import numpy as np
import pytest
import torch

from ursonet_torch.utils import staging

FLAGSHIP_BYTES = 128 * 512 * 640 * 3     # a served batch of uint8 images
CONFIG2_BYTES = 1 * 512 * 640 * 3        # config 2's batch of one


class HostRing:
    """`staging.Ring`'s interface on host buffers; `log` holds its waits
    and records in order."""

    def __init__(self, slot_bytes: int, slots: int):
        self.slot_bytes = slot_bytes
        self.bufs = [torch.zeros(slot_bytes, dtype=torch.uint8)
                     for _ in range(slots)]
        self.next = 0
        self.lock = threading.Lock()
        self.log = []

    def wait(self, slot):
        self.log.append(('wait', slot))

    def record(self, slot):
        self.log.append(('record', slot))


@pytest.mark.parametrize('nbytes,slot_bytes,slots,start', [
    (0, 8, 3, 0),
    (1, 8, 3, 0),
    (7, 8, 3, 1),
    (8, 8, 3, 2),
    (9, 8, 2, 0),
    (25, 8, 3, 2),
    (64, 8, 3, 0),
    (CONFIG2_BYTES, staging.SLOT_BYTES, staging.SLOTS, 0),
    (FLAGSHIP_BYTES, staging.SLOT_BYTES, staging.SLOTS, 1),
    (FLAGSHIP_BYTES, 4 << 20, 2, 0),
    (FLAGSHIP_BYTES, 32 << 20, 3, 2),
])
def test_chunk_plan(nbytes, slot_bytes, slots, start):
    plan = staging.chunk_plan(nbytes, slot_bytes, slots, start)
    assert len(plan) == -(-nbytes // slot_bytes)
    # the chunks cover the flat batch in order, with no gap or overlap
    ends = [0] + [hi for _, _, hi in plan]
    assert [lo for _, lo, _ in plan] == ends[:-1]
    assert ends[-1] == nbytes
    # every chunk fills its slot but the last, which may be ragged
    sizes = [hi - lo for _, lo, hi in plan]
    assert all(s == slot_bytes for s in sizes[:-1])
    if plan:
        assert 0 < sizes[-1] <= slot_bytes
        assert (sizes[-1] < slot_bytes) == bool(nbytes % slot_bytes)
    if 0 < nbytes <= slot_bytes:
        assert len(plan) == 1
    # the slots in turn, from `start`
    assert [s for s, _, _ in plan] == [(start + i) % slots
                                      for i in range(len(plan))]


def _source(kind, dtype, shape, seed):
    rng = np.random.RandomState(seed)
    a = (rng.rand(*shape) * 255).astype(dtype)
    if kind == 'numpy':
        return a
    t = torch.from_numpy(a)
    return t if kind == 'tensor' else t.transpose(1, 2)


def _flat(x):
    t = x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(x))
    return staging._flat_bytes(t.contiguous())


@pytest.mark.parametrize('kind', ['numpy', 'tensor', 'transposed'])
@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
@pytest.mark.parametrize('batch', [1, 7])
def test_stage_copies_every_byte_through_the_slots_in_turn(kind, dtype,
                                                            batch):
    x = _source(kind, dtype, (batch, 6, 10, 3), seed=batch)
    src = _flat(x)
    ring = HostRing(slot_bytes=100, slots=3)
    ring.next = 2
    dst = torch.zeros_like(src)
    chunks = staging.stage(src, dst, ring)
    assert torch.equal(dst, src)
    plan = staging.chunk_plan(src.numel(), 100, 3, start=2)
    assert chunks == len(plan)
    # each chunk waits for its slot's last DMA, then records its own
    assert ring.log == [(e, s) for s, _, _ in plan
                        for e in ('wait', 'record')]
    assert ring.next == (plan[-1][0] + 1) % 3
    # a second call takes the next slots, and the first result stands
    # when the caller overwrites its array
    want = dst.clone()
    src2 = torch.flip(src, [0]).contiguous()
    dst2 = torch.zeros_like(src2)
    ring.log = []
    staging.stage(src2, dst2, ring)
    src2.zero_()
    assert ring.log[0] == ('wait', (plan[-1][0] + 1) % 3)
    assert torch.equal(dst, want)
    assert torch.equal(dst2, torch.flip(src, [0]))


def test_numpy_and_tensor_give_equal_bytes():
    a = _source('numpy', np.float32, (3, 8, 8, 3), seed=0)
    got = []
    for x in (a, torch.from_numpy(a)):
        src = _flat(x)
        dst = torch.zeros_like(src)
        staging.stage(src, dst, HostRing(64, 2))
        got.append(dst)
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0].view(torch.float32).view(a.shape),
                       torch.from_numpy(a))


@pytest.mark.parametrize('kind', ['numpy', 'tensor', 'transposed'])
def test_a_cpu_target_passes_through_unchanged(kind):
    x = _source(kind, np.uint8, (2, 4, 6, 3), seed=3)
    before = dict(staging.counts)
    got = staging.to_device(x, 'cpu')
    assert staging.counts['passed'] == before['passed'] + 1
    assert {k: staging.counts[k] for k in ('staged', 'chunks', 'bytes')} \
        == {k: before[k] for k in ('staged', 'chunks', 'bytes')}
    if kind == 'numpy':
        # the array's own memory, as torch.from_numpy gives it
        assert got.data_ptr() == x.ctypes.data
        assert torch.equal(got, torch.from_numpy(x))
    else:
        # a tensor on its target is returned as it is, strides and all
        assert got is x


def test_reset_counts():
    staging.to_device(np.zeros((1, 2, 2, 3), np.uint8), 'cpu')
    staging.reset_counts()
    assert staging.counts == {'staged': 0, 'passed': 0, 'chunks': 0,
                              'bytes': 0}


def test_one_ring_shared_by_threads_keeps_every_copy_whole():
    """More threads than cores stage distinct batches through one ring at
    a short switch interval: every destination equals its source and
    the ring's log stays a rotation of wait/record pairs."""
    ring = HostRing(slot_bytes=4096, slots=3)
    srcs = [torch.full((4096 * 5 + 123,), i, dtype=torch.uint8)
            for i in range(16)]
    dsts = [torch.zeros_like(s) for s in srcs]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda i=i: [staging.stage(srcs[i], dsts[i], ring)
                                for _ in range(20)])
            for i in range(len(srcs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for s, d in zip(srcs, dsts):
        assert torch.equal(s, d)
    slots = [s for e, s in ring.log[::2]]
    assert ring.log[::2] == [('wait', s) for s in slots]
    assert ring.log[1::2] == [('record', s) for s in slots]
    assert slots == [i % 3 for i in range(len(slots))]
    assert len(slots) == 16 * 20 * 6
