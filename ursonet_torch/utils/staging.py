"""The host-to-device copy of a batch through a ring of pinned buffers.

`to_device(x, device)` is `x.to(device)` for every input but one: a host
tensor or numpy array bound for a CUDA device. That one is copied in
chunks of SLOT_BYTES through a ring of SLOTS pinned host buffers (one
ring a device, made at its first use and shared by every caller). For
each chunk the host waits for the DMA that last left the chunk's slot,
copies the chunk into the slot (torch's threaded CPU copy) and issues
the slot's DMA into the device tensor on the current stream, so the host
copy of one chunk runs while the DMA of the one before is on the link.
A pageable `.to()` is staged by CUDA itself through small pinned
buffers of its own from one host thread, with nothing overlapped.

When `to_device` returns, every byte of the input lies in the ring, so
the caller may overwrite or free its array at once; the last chunks'
DMAs may still be on the link, ordered before whatever the caller issues
next on the same stream. The result is a new contiguous tensor of the
input's shape and dtype, the input's bytes unchanged, allocated as
`.to()` allocates it (one block of the caching allocator on the current
stream). Nothing is cached between calls but the ring itself.

`counts` counts calls on the host (no synchronisation): 'staged' (calls
through the ring), 'passed' (calls left to `.to()`), and of the staged
ones 'chunks' and 'bytes'.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

SLOT_BYTES = 16 << 20
SLOTS = 2

counts = {'staged': 0, 'passed': 0, 'chunks': 0, 'bytes': 0}
_rings: dict = {}
_lock = threading.Lock()      # guards `counts` and `_rings`


def reset_counts() -> None:
    with _lock:
        for k in counts:
            counts[k] = 0


def chunk_plan(nbytes: int, slot_bytes: int = SLOT_BYTES,
               slots: int = SLOTS, start: int = 0) -> list:
    """The chunks of a flat batch of `nbytes` bytes, in order: (slot, lo,
    hi), each `slot_bytes` long but the last, the slots taken in turn
    from `start`."""
    return [((start + i) % slots, lo, min(lo + slot_bytes, nbytes))
            for i, lo in enumerate(range(0, nbytes, slot_bytes))]


class Ring:
    """`slots` pinned host buffers of `slot_bytes` on the way to
    `device`, each with the event of the last DMA out of it, and the slot
    the next chunk takes."""

    def __init__(self, device: torch.device, slot_bytes: int = SLOT_BYTES,
                 slots: int = SLOTS):
        self.device = device
        self.slot_bytes = slot_bytes
        self.bufs = [torch.empty(slot_bytes, dtype=torch.uint8,
                                 pin_memory=True) for _ in range(slots)]
        with torch.cuda.device(device):
            self.events = [torch.cuda.Event() for _ in range(slots)]
        self.next = 0
        self.lock = threading.Lock()

    def wait(self, slot: int) -> None:
        """Block the host until the slot's last DMA has left it."""
        self.events[slot].synchronize()

    def record(self, slot: int) -> None:
        """Mark the DMA just issued out of the slot."""
        self.events[slot].record(torch.cuda.current_stream(self.device))


def stage(src: torch.Tensor, dst: torch.Tensor, ring) -> int:
    """Copy the flat bytes `src` (host) into `dst` (the device) through
    `ring`'s slots (module docstring); returns the number of chunks."""
    with ring.lock:
        plan = chunk_plan(src.numel(), ring.slot_bytes, len(ring.bufs),
                          ring.next)
        for slot, lo, hi in plan:
            ring.wait(slot)
            buf = ring.bufs[slot][:hi - lo]
            buf.copy_(src[lo:hi])
            dst[lo:hi].copy_(buf, non_blocking=True)
            ring.record(slot)
        if plan:
            ring.next = (plan[-1][0] + 1) % len(ring.bufs)
    return len(plan)


def _ring(dev: torch.device) -> Ring:
    dev = torch.device('cuda', dev.index if dev.index is not None
                       else torch.cuda.current_device())
    with _lock:
        if dev not in _rings:
            _rings[dev] = Ring(dev)
        return _rings[dev]


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.view(-1).view(torch.uint8)


def to_device(x, device) -> torch.Tensor:
    """`x` (a tensor or numpy array) on `device`: a host input bound for
    a CUDA device through the pinned ring, any other as `.to(device)`
    (module docstring)."""
    dev = torch.device(device)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type != 'cuda' or x.device.type != 'cpu':
        with _lock:
            counts['passed'] += 1
        return x.to(dev)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    chunks = stage(_flat_bytes(x), _flat_bytes(out), _ring(dev))
    with _lock:
        counts['staged'] += 1
        counts['chunks'] += chunks
        counts['bytes'] += x.numel() * x.element_size()
    return out
