"""The program's own spans in a window's trace.

The port wraps its phases in `torch.profiler.record_function` ranges
named `ursonet.*` (`ursonet_torch/utils/profiling.py` lists them). They
are host operations of the kineto trace, so `traces.collect` keeps them
in `Trace.host` with the device operations' clock. Here they are read
back as intervals, and the device's idle time is put down to the span
the host was inside: by time, not by thread (a backward's kernels are
launched from autograd's device thread while the main thread waits
inside its span). Each reader returns None where the trace holds none of
the span, as a trace of a program without spans does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import traces


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def span_intervals(trace, name: str) -> List[Tuple[float, float]]:
    """The merged host intervals of the spans named `name`, cut to the
    window, in order."""
    lo, hi = trace.window
    return _merged((max(s, lo), min(e, hi))
                   for n, s, e in trace.host if n == name)


def _overlap(a: List[Tuple[float, float]],
             b: List[Tuple[float, float]]) -> float:
    """Seconds two sorted lists of disjoint intervals share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_within(trace, name: str, keep=traces.is_kernel) -> Optional[float]:
    """Seconds of the window in which no device operation that `keep`
    accepts (by default: no kernel; copies and fills count as idle) ran
    while the host was inside a span `name`; None without such a span."""
    spans = span_intervals(trace, name)
    if not spans:
        return None
    lo, hi = trace.window
    busy = _merged((max(s, lo), min(e, hi))
                   for s, e in trace.busy_intervals(keep))
    return sum(e - s for s, e in spans) - _overlap(spans, busy)


def idle_share(ctx, kind: str, name: str) -> Optional[float]:
    """The share in % of the traced window in which the card ran no
    kernel while the host was inside `name`, for a run of `kind`."""
    if ctx.kind != kind or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    idle = idle_within(ctx.trace, name)
    return None if idle is None else 100.0 * idle / ctx.trace.window_s
