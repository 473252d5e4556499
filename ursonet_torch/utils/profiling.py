"""Profiling and observability, the counterpart of
`ursonet_tpu/utils/profiling.py` (`cost_analysis`, `get_flops`, `trace`,
`log_tensor_stats`, `initialize_multihost`).

  * cost_analysis / get_flops run the function once under
    `torch.utils.flop_counter.FlopCounterMode`. Stated deviation: the JAX
    package reads XLA's cost model of the compiled program, which counts
    every operation; PyTorch's counter counts aten's convolutions and
    matrix products (2 operations a multiply-add, their backward too when
    the function runs one), not elementwise operations, reductions or
    the port's own CUDA kernels (called through ctypes, they are not aten
    operations).
  * trace writes a `torch.profiler` Chrome trace (CPU and, on the card,
    CUDA activity) of the block it wraps: `<log_dir>/trace.json`.
  * log_tensor_stats prints the JAX package's line, character for
    character (torch tensors are read on the host; bf16 as f32 values
    with the dtype named 'bfloat16').
  * initialize_multihost delegates to `parallel/multihost.initialize`.
  * span(name) is the port's one span primitive: a `record_function`
    range while a `torch.profiler` is recording, else one shared no-op
    context (no allocation, no synchronisation, no device operation). The
    ranges land in the profiler's kineto trace beside the CUDA kernels
    and copies, on the same clock, so a reader of the trace can put each
    stretch of device time, or of device idleness, down to the program
    phase the host was in.

Spans, by name (each host range also gets a GPU-side annotation, which a
reader of device operations leaves out):

  Serving (`engine.py::ServingEngine`, `models/quant.py`), at most 10 a
  served batch:
    ursonet.serve.predict   the whole of `predict_molded`: the host's time
                            for a served batch, short of the heads' copy
                            back.
    ursonet.serve.pack      `served_batch`: the uint8 conversion and the
                            host space-to-depth, host work only.
    ursonet.serve.h2d       the host-to-device copy of the served batch
                            (`QuantizedModel._images`, or the float
                            path's `.to(device)`). `_images` sends a host
                            batch through the pinned staging ring
                            (`utils/staging.py::to_device`): the span
                            holds the host's copies into the ring and
                            the issues of their DMAs, and the last
                            chunk's DMA may end after it, inside
                            ursonet.serve.forward.
    ursonet.serve.forward   the forward on the card, from its first launch
                            to the return of the head tensors (under a
                            mesh the gather is left out): the host issuing
                            the forward, and the card's idle time while it
                            does.
    ursonet.qmodel.stem, ursonet.qmodel.res2 ... res5, ursonet.qmodel.head
                            inside the twin graph (`twin_forward`), under
                            every phase that runs it (serving,
                            calibration, `bias_correct`, `float_twin`):
                            the stem section (stem conv, ReLU +
                            requantize, maxpool; the input step before it
                            launches nothing for a uint8 batch the fused
                            stem reads), each backbone stage (a basic
                            backbone's stage1-4 as res2-5), and the
                            bottleneck conv, flatten, denses and finals.
                            Their GPU-side annotations give each stage's
                            device time inside the real forward.

  Training (`train/step.py`), at most 6 a step:
    ursonet.train.gather      the resident step's index gather of the
                              batch.
    ursonet.train.step        the whole of the train step, holding:
    ursonet.train.preprocess  the on-device augmentation, warp and
                              re-encode (`_model_batch`);
    ursonet.train.forward     the model, the losses and the L2 term;
    ursonet.train.backward    `torch.autograd.grad` (and under a mesh the
                              gradients' all-reduce). Its kernels are
                              launched from autograd's device thread;
                              this span covers their launches in time,
                              since `grad` returns once autograd has issued
                              them all: attribute by time, not by thread;
    ursonet.train.update      the optimizer step, the batch norms'
                              running statistics and the metrics' detach.
    ursonet.train.targets     inside .preprocess, for the landmark model
                              (BACKBONE 'hrnet_w32'): the landmarks'
                              projection and the heatmap targets
                              (`data/loader.py::DevicePreprocess.targets`).

  The landmark model (`models/hrnet.py`, `models/ursonet.py`), in every
  forward that runs it, 2 + 2 a module + 1 (20 a forward):
    ursonet.hrnet.stem        the two 3x3/2 stem convs, their BN and ReLU;
    ursonet.hrnet.stage1      stage 1's four bottlenecks;
    ursonet.hrnet.branch      a module's parallel basic blocks (a REMAT
                              recompute runs in the backward, outside it);
    ursonet.hrnet.fuse        a module's fusion: the 1x1 and strided 3x3
                              convs with their BN, the upsampling, the sums
                              and ReLUs;
    ursonet.hrnet.head        the 1x1 heatmap head.
  The transitions between stages run outside every span.

Counters (host-side, no synchronisation): `utils/staging.py::counts`
(the served batches' copies) and `ops/landmarks.py::counts` (the landmark
model's modules run and fusion sums made; the landmarks rendered into
heatmaps and, as a 0-d device tensor read only when asked, those
dropped as out of view).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


# the context `span` returns while no profiler records
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range `name` around a `with` block while a profiler
    records, else the shared no-op context (module docstring: the
    spans)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def cost_analysis(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run fn(*args, **kwargs) once and count its operations:
    {'flops': total, 'flops_by_op': {aten op name: flops}}."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    by_op = {str(op): int(n) for op, n in
             counter.get_flop_counts().get('Global', {}).items()}
    return {'flops': float(counter.get_total_flops()), 'flops_by_op': by_op}


def get_flops(fn, *args, **kwargs) -> float:
    """The operations of one call of fn (module docstring: what counts)."""
    return float(cost_analysis(fn, *args, **kwargs).get('flops', 0.0))


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a Chrome trace of the block into `log_dir`/trace.json:

        with profiling.trace('/tmp/trace'):
            step(batch)
    """
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def _host_array(array):
    if isinstance(array, torch.Tensor):
        t = array.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), 'bfloat16'
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(array)
    return a, str(a.dtype)


def log_tensor_stats(text: str, array: Optional[Any] = None,
                     log_fn=print):
    """Shape/dtype/min/max printer (the JAX package's format)."""
    if array is not None:
        a, dtype = _host_array(array)
        text = text.ljust(25)
        if a.size:
            text += (f"shape: {str(a.shape):20}  "
                     f"min: {a.min():10.5f}  max: {a.max():10.5f}")
        else:
            text += f"shape: {str(a.shape):20}  min:     empty  max: empty"
        text += f"  {dtype}"
    log_fn(text)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, **kwargs):
    """Form the world of ranks (`parallel/multihost.initialize`)."""
    from ursonet_torch.parallel import multihost
    return multihost.initialize(coordinator_address, num_processes,
                                process_id, **kwargs)
