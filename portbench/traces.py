"""The device trace of a measured window, reduced to what the per-layer
readers and the breakdown need.

`collect(prof, window)` takes a finished `torch.profiler.profile` (CPU and
CUDA activities) and the name of the harness's span around the window,
and returns a `Trace`: every device operation (kernels, copies, fills)
inside the window with its family, the time the device was busy (the
union of its operations' intervals), the time it ran kernels (the same,
copies and fills left out), the window's length, and the host's
operations, by which the longest idle gaps are named.

Kernel families by substrings of the kernel name, first match wins: the
port's int8 kernels by their template names (`tma_s8_kernel<BN, conv,
...>`: the persistent TMA + wgmma kernel of `gemm_s8` (conv false) and
`conv_s8` (conv true); `gemm_s8_kernel`, `conv_s8_kernel`: their
mma.sync routes; `stem_s8`), the warp, then the float model's batch
norms, layout transposes and reductions before the matrix products, so
that a cuDNN batch-norm or transpose kernel is not counted as a
convolution.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

FAMILIES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ('int8_stem', ('stem_s8',)),
    ('int8_conv', tuple(f'tma_s8_kernel<{bn}, true' for bn in (64, 128, 256))
     + ('conv_s8_kernel',)),
    ('int8_gemm', tuple(f'tma_s8_kernel<{bn}, false' for bn in (64, 128, 256))
     + ('gemm_s8_kernel',)),
    ('warp', ('warp_',)),
    ('batch_norm', ('batch_norm', 'batchnorm', 'bn_fw', 'bn_bw')),
    ('layout', ('nchwToNhwc', 'nhwcToNchw', 'transpose')),
    ('reduce', ('reduce', 'Reduce')),
    ('maxpool', ('max_pool', 'MaxPool')),
    ('matmul', ('gemm', 'Gemm', 'xmma', 'cutlass', 'implicit', 'fprop',
                'dgrad', 'wgrad', 'conv', 'Conv', 'splitK', 'sm90_', 'sm80_',
                'cublas')),
    ('elementwise', ('elementwise', 'vectorized', 'copy', 'Memcpy',
                     'Memset', 'fill', 'index', 'Index', 'gather', 'cat',
                     'CatArray', 'where')),
)


def is_kernel(name: str) -> bool:
    """A kernel, not a copy or a fill (the profiler names those
    'Memcpy ...' and 'Memset ...')."""
    return not name.startswith(('Memcpy', 'Memset'))


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return 'other'


@dataclass
class Trace:
    """Device operations of the window: (name, start_s, end_s), in the
    trace's clock, with the window's bounds in the same clock."""
    ops: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self, keep=None) -> List[Tuple[float, float]]:
        """The union of the intervals of the operations whose name `keep`
        accepts (all of them by default), in order."""
        out: List[Tuple[float, float]] = []
        for name, s, e in sorted(self.ops, key=lambda o: o[1]):
            if keep is not None and not keep(name):
                continue
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        return out

    def busy_of(self, keep) -> float:
        """Seconds in which an operation that `keep` accepts ran."""
        return sum(e - s for s, e in self.busy_intervals(keep))

    @property
    def busy_s(self) -> float:
        """Seconds in which any operation ran: kernels, copies, fills."""
        return sum(e - s for s, e in self.busy_intervals())

    @property
    def kernel_busy_s(self) -> float:
        """Seconds in which a kernel ran."""
        return self.busy_of(is_kernel)

    def seconds_by_family(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.ops:
            fam = family(name)
            out[fam] = out.get(fam, 0.0) + (e - s)
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest spans of the window with no device operation,
        each named by the innermost host operation running at its middle."""
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, min(s, hi)))
            at = max(at, e)
        if at < hi:
            gaps.append((at, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            label, best = 'no host operation', None
            for name, s, e in host[:bisect.bisect_right(starts, mid)]:
                if e >= mid and (best is None or s >= best):
                    label, best = name, s
            out.append([label, b - a])
        return out


def collect(prof, window_span: str) -> Trace:
    """Reduce a finished profiler run to the device operations inside the
    host span `window_span` (a `record_function` around the window)."""
    import torch
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    window, ops, host = None, [], []
    for ev in events:
        s, e = ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
        name = ev.name()
        if ev.device_type() == cuda:
            if ev.is_user_annotation() or name.startswith('portbench.'):
                continue
            ops.append((name, s, e))
        else:
            if name == window_span:
                window = (s, e)
            host.append((name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no span {window_span!r}")
    lo, hi = window
    ops = [(n, max(s, lo), min(e, hi)) for n, s, e in ops if e > lo and s < hi]
    host = [h for h in host if h[2] > lo and h[1] < hi and h[0] != window_span]
    return Trace(ops, window, host)
