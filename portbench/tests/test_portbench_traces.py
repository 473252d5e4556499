"""The trace's reduction: the busy time, the kernels' time apart from
copies and fills, and the readers of the idle and copy shares, on a
trace made by hand."""

from __future__ import annotations

import types

import pytest

import cells
import common  # noqa: F401  (the harness's folder on the import path)
import traces

# a 10 s window: a pageable copy 0-4 s, kernels 3-5 s and 6-8 s, a fill
# 8-9 s, nothing 9-10 s
OPS = [('Memcpy HtoD (Pageable -> Device)', 0.0, 4.0),
       ('tma_s8_kernel<256, false, 1>', 3.0, 5.0),
       ('conv_s8_kernel', 6.0, 8.0),
       ('Memset (Device)', 8.0, 9.0)]


def _trace():
    return traces.Trace(list(OPS), (0.0, 10.0))


def test_busy_counts_every_operation_and_kernel_busy_only_kernels():
    tr = _trace()
    assert tr.busy_s == pytest.approx(8.0)
    assert tr.kernel_busy_s == pytest.approx(4.0)
    assert [traces.is_kernel(n) for n, _, _ in OPS] == [False, True, True,
                                                        False]


@pytest.mark.parametrize('name, want', [('serve.idle_share', 60.0),
                                        ('serve.h2d_share', 40.0),
                                        ('train.idle_share', None)])
def test_share_readers(name, want):
    ctx = types.SimpleNamespace(kind='serve', trace=_trace())
    got = cells.load_reader(name)(ctx)
    assert got == (None if want is None else pytest.approx(want))


def test_h2d_share_reads_zero_where_nothing_was_shipped():
    tr = traces.Trace([op for op in OPS if traces.is_kernel(op[0])],
                      (0.0, 10.0))
    ctx = types.SimpleNamespace(kind='serve', trace=tr)
    assert cells.load_reader('serve.h2d_share')(ctx) == 0.0
