"""Traffic kind 'serve': a closed loop of one client through the program's
int8 serving engine.

Set-up (timed as `setup_s` from the process's start): the model with
weights made on the card from the seed, the engine's int8 model
quantized as users do it (`quantize`, calibrate on the first
`calib_images` images of the pool, `smooth(smooth_alpha)`,
`bias_correct(passes=bias_correct_passes)`), a pool of `pool_batches`
batches of `batch` uint8 images of the network shape in host memory
(made on the card from the seed, then copied), and `warmup_batches`
served batches. The window: batch n is pool[n mod pool_batches], handed
to `ServingEngine.predict_molded`, its heads brought to the host; the
next batch is sent when they are there. It ends with the first batch
that completes after `--seconds`.

`correct`: once the window has closed and the program's state is freed,
the plain reference (`reference/int8_serve.py`) works the served model
out again from the same weights and calibration images and serves the
pool batches that a seeded sample of `check_batches` window batches
used; the number compared is the largest gap of one answer (a row of a
head) of a sampled batch to the reference's, ||got - ref|| / ||ref||,
against the cell's limit.
"""

from __future__ import annotations

import gc
import random
import time
from types import SimpleNamespace

import torch

import faults
import inputs
import program
import timing
from reference.int8_serve import Int8Reference
from weights import make_weights

# what `faults.fault` can put in the timed call's place
FAULTS = {'control': faults.serve_control,
          'alter_answer': faults.alter_answer,
          'drop_half': faults.drop_half}
WINDOW_SPAN = 'portbench.window'
CALL_SPAN = 'portbench.serve.call'


def answer_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest gap of one answer (a row of a head) to the
    reference's: ||got_i - ref_i|| / ||ref_i||, the norm of a row below a
    thousandth of the head's mean row norm taken as that."""
    g, r = got.double().flatten(1), ref.double().flatten(1)
    if g.shape != r.shape or not torch.isfinite(g).all():
        return float('inf')
    norms = r.norm(dim=1)
    floor = max(float(norms.mean()) * 1e-3, 1e-30)
    return float(((g - r).norm(dim=1) / norms.clamp_min(floor)).max())


def run(cell, seed: int, seconds: float, trace: bool, device, phases,
        fault=None, plain: bool = False) -> SimpleNamespace:
    """One run; `phases` (`timing.Phases`) times set-up from the process's
    start. `plain` serves through the int8 model's plain PyTorch products
    (the CPU tests); `fault` (`faults.py`) wraps the served call."""
    dev = torch.device(device)
    tr = cell.traffic
    keys = dict(cell.config['config'], **tr['config'],
                IMAGES_PER_GPU=tr['batch'])
    cfg = program.make_config(keys)
    bsz = int(cfg.BATCH_SIZE)
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])

    net = program.build_model(cfg, dev)
    weights = make_weights(program.float_shapes(net), seed, dev)
    missing = net.load_state_dict(weights, strict=False).missing_keys
    if missing:
        raise RuntimeError(f"weights not made for {missing[:4]}")
    phases.mark('model')
    pool = inputs.image_pool(seed, tr['pool_batches'], bsz, h, w, dev)
    calib = pool[0][:tr['calib_images']]
    phases.mark('pool')
    engine = program.serving_engine(cfg, dev, net)
    qm = engine.quantize()
    x8 = engine.served_batch(calib)
    qm.calibrate(x8)
    qm.smooth(tr['smooth_alpha'])
    qm.bias_correct(x8, passes=tr['bias_correct_passes'])
    phases.mark('quantize')
    acc = 'bf16' if cfg.F16 else 'f32'

    if plain:
        def serve(batch):
            return qm(engine.served_batch(batch), plain=True)
    else:
        serve = engine.predict_molded
    if fault is not None:
        serve = fault(serve, SimpleNamespace(weights=weights, calib=calib,
                                             device=dev, acc=acc))
    for i in range(tr['warmup_batches']):
        {k: v.cpu() for k, v in serve(pool[i % len(pool)]).items()}
    cuda = dev.type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    phases.mark('warmup')
    setup_s = phases.total()

    rng = random.Random(seed)
    keep, kept = tr['check_batches'], []
    lat, calls, n = [], [], 0

    def loop(secs, prof=None):
        """Serve until `secs` have passed; (batches, seconds)."""
        nonlocal n
        start = time.perf_counter()
        deadline, first = start + secs, n
        while True:
            p = n % len(pool)
            a = time.perf_counter()
            if prof is not None:
                with torch.profiler.record_function(CALL_SPAN):
                    out = serve(pool[p])
            else:
                out = serve(pool[p])
            b = time.perf_counter()
            heads = {k: v.cpu() for k, v in out.items()}
            c = time.perf_counter()
            if prof is None:
                lat.append(c - a)
                calls.append(b - a)
            # a seeded reservoir sample of the window's batches
            if len(kept) < keep:
                kept.append((p, heads))
            else:
                j = rng.randrange(n + 1)
                if j < keep:
                    kept[j] = (p, heads)
            n += 1
            if c >= deadline:
                return n - first, c - start

    tr_data, traced = None, 0
    if trace:
        # host-clock readings from an untraced first half, device ones
        # from a traced second half: the profiler's host overhead slows
        # the loop it records
        batches, window_s = loop(seconds / 2)
        with timing.profiled(WINDOW_SPAN) as prof:
            traced, _ = loop(seconds / 2, prof)
        import traces
        tr_data = traces.collect(prof, WINDOW_SPAN)
        del prof
    else:
        batches, window_s = loop(seconds)
    window_peak = torch.cuda.max_memory_allocated() if cuda else None

    del serve, engine, qm, net, x8
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = Int8Reference(weights, cell.model, dev, acc=acc, qmax=127)
    ref.prepare(torch.from_numpy(calib), tr['smooth_alpha'],
                tr['bias_correct_passes'])
    need = sorted({p for p, _ in kept})
    refs = {p: ref.serve(torch.from_numpy(pool[p]).to(dev), rows=bsz)
            for p in need}
    gap = max(answer_gap(heads[k], refs[p][k])
              for p, heads in kept for k in refs[p])
    checks = {'answer_gap': {'value': gap,
                             'limit': cell.limits['answer_gap']}}

    metrics = {
        'serve_imgs_per_s': {'value': batches * bsz / window_s,
                             'unit': 'imgs/s'},
        'setup_s': {'value': setup_s, 'unit': 's'},
    }
    if cuda:
        metrics['peak_mem_gib'] = {'value': window_peak / 2 ** 30,
                                   'unit': 'GiB'}
    ctx = SimpleNamespace(kind='serve', model=cell.model, traffic=tr,
                          height=h, width=w, batch=bsz, batches=batches,
                          images=batches * bsz, window_s=window_s,
                          call_s=calls, lat_s=lat, trace=tr_data,
                          traced=traced, bf16=bool(cfg.F16))
    return SimpleNamespace(
        metrics=metrics, checks=checks, attempted=n, failed=0, ctx=ctx,
        memory_peak_bytes=(max(setup_peak, window_peak) if cuda else None))
