"""The readers of the program's spans (`spans.py` and the five metrics
that read it) on traces made by hand; on the card, that a traced window
of each cell kind holds the program's spans on the device operations'
clock and counts none of them as a device operation."""

from __future__ import annotations

import importlib
import time
import types

import pytest
import torch

import common  # first: it puts the harness's folder on the import path
import cells
import spans
import traces

# a 10 s window: kernels 1-3 s and 6-8 s, a copy 3-5 s (idle: no kernel)
OPS = [('tma_s8_kernel<256, false, 1>', 1.0, 3.0),
       ('Memcpy HtoD (Pageable -> Device)', 3.0, 5.0),
       ('conv_s8_kernel', 6.0, 8.0)]
# the host: a span past both bounds of the window, one across the copy's
# end and a kernel's start, the forward with a nested stage span, a span
# cut by the window's end, and a host operation that is no span
HOST = [('ursonet.serve.predict', -1.0, 11.0),
        ('ursonet.serve.h2d', 2.5, 5.5),
        ('ursonet.serve.forward', 5.5, 9.0),
        ('ursonet.qmodel.stem', 5.5, 7.0),
        ('aten::copy_', 3.0, 5.0),
        ('ursonet.train.update', 9.5, 12.0)]


def _trace(host=HOST):
    return traces.Trace(list(OPS), (0.0, 10.0), list(host))


@pytest.mark.parametrize('name, want', [
    ('ursonet.serve.predict', 6.0),     # all of the window's idle time
    ('ursonet.serve.h2d', 2.5),         # 2.5-3 busy, 3-5.5 idle
    ('ursonet.serve.forward', 1.5),     # 5.5-6 and 8-9
    ('ursonet.qmodel.stem', 0.5),       # nested: 5.5-6
    ('ursonet.train.update', 0.5),      # cut to the window: 9.5-10
    ('ursonet.serve.pack', None)])
def test_idle_within_puts_idle_time_down_to_the_span(name, want):
    got = spans.idle_within(_trace(), name)
    assert got == (None if want is None else pytest.approx(want))


def test_idle_within_counts_what_keep_accepts_as_busy():
    # with the copy counted busy, only 5-5.5 of the h2d span is idle
    got = spans.idle_within(_trace(), 'ursonet.serve.h2d',
                            keep=lambda name: True)
    assert got == pytest.approx(0.5)


def test_spans_of_one_name_are_merged_before_they_are_counted():
    tr = _trace([('ursonet.train.backward', 0.0, 2.0),
                 ('ursonet.train.backward', 1.5, 4.0),
                 ('ursonet.train.backward', 5.0, 6.5)])
    assert spans.span_intervals(tr, 'ursonet.train.backward') == [
        (0.0, 4.0), (5.0, 6.5)]
    # 0-1, 3-4 and 5-6
    assert spans.idle_within(tr, 'ursonet.train.backward') \
        == pytest.approx(3.0)


def test_disjoint_spans_partition_the_idle_time():
    tr = _trace()
    idle = tr.window_s - tr.kernel_busy_s
    inside = sum(spans.idle_within(tr, n) for n in
                 ('ursonet.serve.h2d', 'ursonet.serve.forward'))
    outside = 1.0 + 1.0                 # 0-1 and 9-10
    assert inside + outside == pytest.approx(idle)
    assert spans.idle_within(tr, 'ursonet.serve.predict') \
        == pytest.approx(idle)


TRAIN_HOST = [('ursonet.train.forward', 0.0, 3.0),     # 0-1 idle
              ('ursonet.train.backward', 3.0, 6.0),    # 3-6 idle
              ('ursonet.train.update', 8.0, 10.0)]     # 8-10 idle
# each reader's kind, the host it reads, and its value there (2 batches)
READERS = {
    'serve.launch_ms': ('serve', HOST, 1e3 * 3.5 / 2),
    'serve.idle_launch_share': ('serve', HOST, 15.0),
    'train.idle_forward_share': ('train', TRAIN_HOST, 10.0),
    'train.idle_backward_share': ('train', TRAIN_HOST, 30.0),
    'train.idle_update_share': ('train', TRAIN_HOST, 20.0),
}


def _ctx(kind, host):
    return types.SimpleNamespace(kind=kind, trace=_trace(host), traced=2)


@pytest.mark.parametrize('name', sorted(READERS))
def test_reader_reads_its_span(name):
    kind, host, want = READERS[name]
    assert cells.load_reader(name)(_ctx(kind, host)) == pytest.approx(want)


@pytest.mark.parametrize('name', sorted(READERS))
def test_reader_reads_nothing_without_its_span(name):
    kind, host, _ = READERS[name]
    read = cells.load_reader(name)
    # a program without spans: only the harness's own
    assert read(_ctx(kind, [('portbench.serve.call', 0.0, 10.0)])) is None
    other = 'train' if kind == 'serve' else 'serve'
    assert read(_ctx(other, HOST + TRAIN_HOST)) is None
    assert read(types.SimpleNamespace(kind=kind, trace=None,
                                      traced=0)) is None


def _traced_window(name: str):
    """The trace of a run of cell `name` on the card whose traced half
    is 1 s."""
    import program
    import timing
    common.run.setup_paths()
    program.build_kernels()
    cell = cells.load_cell(name)
    traffic = importlib.import_module(cell.kind)
    out = traffic.run(cell, common.SEED, 2.0, True, torch.device('cuda:0'),
                      timing.Phases(time.perf_counter()))
    return cell.kind, out.ctx.trace


def _h2d(name: str) -> bool:
    return name.startswith('Memcpy HtoD')


@pytest.mark.cuda
@pytest.mark.parametrize('name', [common.SERVE, common.TRAIN])
def test_program_spans_share_the_device_clock(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    kind, tr = _traced_window(name)
    assert not [n for n, _, _ in tr.ops if n.startswith('ursonet.')]
    assert spans.span_intervals(tr, f'ursonet.{kind}.forward')
    if kind == 'serve':
        # the batch's copy runs while the host is inside its span
        copies = tr.busy_of(_h2d)
        h2d = spans.span_intervals(tr, 'ursonet.serve.h2d')
        inside = sum(e - s for s, e in h2d) \
            - spans.idle_within(tr, 'ursonet.serve.h2d', keep=_h2d)
        assert copies > 0 and inside >= 0.95 * copies, (inside, copies)
