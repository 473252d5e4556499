"""Traffic kind 'train_landmarks': the program's train step of the landmark
model (BACKBONE 'hrnet_w32', HRNet heatmaps) over a device-resident
dataset of square crops, one step after another. `train.py`'s contract,
with the landmark model's data, reference and checks.

Parameters (`traffic/<name>.json`): `batch`, `frames`, `warmup_steps`,
`check_steps`, `crop` (the crop's side in pixels), `focal` (the camera's
focal length in pixels; the principal point at the crop's centre, no
resize), `depth_m` ([lo, hi] of the drawn distances), `offset` (the
largest lateral offset over the distance), `body_m` (the side of the
cube the landmarks are drawn in), and `config`, the program's keys of
the train step.

Set-up (timed as `setup_s` from the process's start): the model with
weights made on the card from the seed (`weights.py`), the dataset of
`frames` uniform uint8 crops with seeded poses (distance in `depth_m`,
lateral offset within ±`offset` of it, uniform unit quaternions) and the
configuration's landmarks drawn from the seed in a cube of `body_m`, the
optimizer and the on-device preprocess, and the first `warmup_steps`
steps of the window's own call. Step s takes rows perm[(s mod S)·B +
0..B-1] (S = frames // B steps an epoch, a new permutation each epoch)
and its augmentation draws from a generator seeded for s, as `train.py`.
The window: steps until `--seconds` have passed and at least
`check_steps` steps are done, then a synchronize.

`correct`: each of the set-up's steps and of the window's first
`check_steps` steps is compared, once the window has closed and the
program's state is freed, with one step of the plain reference
(`reference/hrnet_landmarks.py`, its blocks under checkpoints) taken
from the program's own state before it (its parameters and AMSGrad
slots, copied to pinned host memory after each checked step with no
wait, as are the batch norms' running means) on the same rows and draws.
Three numbers, each over the checked steps:

- `loss_gap`, the mean of a step's relative loss gap. The forward's
  rounding moves a bf16 step's loss by 1e-4 to 4e-3 of it, step by
  step, so the mean reads the rounding where the largest step reads its
  tail; half a batch left out moves every step's loss by its landmarks'
  visibility.
- `stats_gap`, the median of ‖μ_program − μ_reference‖ / ‖μ_reference‖,
  every batch norm's batch means as one vector: the program's from its
  running means before and after the step (r' = m·r + (1 − m)·μ), the
  reference's as it normalized. They read the whole forward, layer by
  layer, at a few thousandths in bf16.
- `update_gap`, the median over the steps after the first of
  ‖Δw_program − Δw_reference‖ / ‖Δw_reference‖, a step's change of all
  parameters as one vector: 1 where a step leaves the state as it found
  it. The first step is left out: AMSGrad's first update is lr·sign(g)
  whatever g's size, so a rounding that flips a near-zero gradient
  flips that parameter's whole step (0.5 of the change in bf16, 0.06 in
  float32 on the card).

Medians, not the largest step: now and then a state reached in training
is ill-conditioned under bf16, and one step's forward parts from
float32's by ten times its neighbours' (the reference itself, its convs
rounded to bf16, parts by five times there), while a fault moves every
step (PERF.md §2).

Each step from the program's state: with batch-statistics batch norms
many gradients nearly vanish, so two runs that part by rounding alone
part more with every step (two float32 runs that order their sums
otherwise read 3e-3 apart in the loss after three steps from the same
start), and a trajectory from the start would measure that drift
rather than the step. The gradient itself (0.1·g is AMSGrad's new first
moment less 0.9 times the old) is not compared: the batch norms' backward
cancels most of each gradient above them, so a bf16 step's gradient lies
0.05–0.76 of its norm from float32's (a float32 program's 0.001–0.01),
and neither the fp8 control (0.17–1.24) nor half a batch (0.14–1.27)
reads far above that (PERF.md §2).

With `--trace 1`, beside `traces.Trace`: the device seconds of the
kernels launched while the host was inside the program's
`ursonet.hrnet.fuse` span (`fuse_s`: each kernel's launch found by the
profiler's correlation id of the runtime call, kernels launched from
any thread), and the program's landmark counter over the run
(`hrnet_counts`).
"""

from __future__ import annotations

import bisect
import gc
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

import faults
import inputs
import program
import program_landmarks
import timing
from reference.hrnet_landmarks import BN_MOMENTUM, LandmarkReference, \
    heatmap_hw, speed_crop_k
from train import epoch_perm, positions, step_seed
from weights import make_weights

WINDOW_SPAN = 'portbench.window'
STEP_SPAN = 'portbench.train.step'
FUSE_SPAN = 'ursonet.hrnet.fuse'
AMSGRAD_SLOTS = ('mu', 'nu', 'nu_max')


def landmark_control(cell):
    """The fp8 reference stepping in the program's place; the program's
    parameters, AMSGrad slots and batch statistics then hold the
    reference's, so that the harness reads the control where it reads
    the program."""
    def hook(step, env):
        ref = env.reference('fp8')
        params = dict(env.model.named_parameters())
        bufs = dict(env.model.named_buffers())

        def control(data, perm, i, gen):
            idx = perm.index_select(0, env.positions(i))
            out = ref.step({k: v.index_select(0, idx)
                            for k, v in data.items()}, gen)
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(ref.params[n])
                for n, b in bufs.items():
                    b.copy_(ref.buffers[n])
            env.tx.state = {s: [ref.slots[s][n] for n in params]
                            for s in AMSGRAD_SLOTS}
            env.tx.count = ref.count
            return i + 1, dict(out['parts'], loss=out['loss'])
        return control
    return hook


# what `faults.fault` can put in the timed call's place
FAULTS = {'control': landmark_control, 'unchanged': faults.unchanged,
          'half_batch': faults.half_batch}


def body_landmarks(seed: int, k: int, side: float) -> np.ndarray:
    """[k,3] landmarks uniform in a cube of `side` metres about the body's
    origin, from the seed."""
    rng = np.random.default_rng(inputs.derived_seed(seed, 3))
    return ((rng.random((k, 3)) - 0.5) * side).astype(np.float32)


def crop_frames(seed: int, n: int, size: int, depth, offset: float,
                device) -> dict:
    """A resident dataset of n square crops: 'images_u8' [n,S,S,3] uniform,
    'image_meta' [n,12], 'location' [n,3] (z uniform in `depth`, x and y
    within ±offset·z), 'quaternion' [n,4] (uniform unit quaternions,
    scalar last, w >= 0)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(inputs.derived_seed(seed,
                                                                      2))
    images = torch.empty((n, size, size, 3), dtype=torch.uint8, device=dev)
    for lo in range(0, n, 256):
        hi = min(n, lo + 256)
        images[lo:hi] = torch.randint(0, 256, (hi - lo, size, size, 3),
                                      generator=gen, dtype=torch.uint8,
                                      device=dev)
    z = depth[0] + (depth[1] - depth[0]) * torch.rand(n, 1, generator=gen,
                                                      device=dev)
    xy = (torch.rand(n, 2, generator=gen, device=dev) - 0.5) * 2 * offset * z
    q = torch.randn(n, 4, generator=gen, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    q = torch.where(q[:, 3:] < 0, -q, q)
    meta = torch.tensor([0.0, size, size, 3, size, size, 3, 0, 0, size,
                         size, 1.0], device=dev).repeat(n, 1)
    meta[:, 0] = torch.arange(n, device=dev, dtype=torch.float32)
    return {'images_u8': images, 'image_meta': meta,
            'location': torch.cat([xy, z], 1), 'quaternion': q}


def launched_within(prof, span: str, window: tuple) -> float:
    """Device seconds, inside `window` (the trace's clock), of the kernels
    whose runtime launch the host made while inside a span `span`."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, launch_at, kernels = [], {}, []
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
        if ev.device_type() == cuda:
            if not ev.is_user_annotation() and ev.correlation_id():
                kernels.append((ev.correlation_id(), s, e))
        elif ev.name() == span:
            spans.append((s, e))
        elif ev.correlation_id() and 'aunch' in ev.name():
            launch_at[ev.correlation_id()] = s
    spans.sort()
    starts = [s for s, _ in spans]
    lo, hi = window
    total = 0.0
    for cid, s, e in kernels:
        t = launch_at.get(cid)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            total += max(0.0, min(e, hi) - max(s, lo))
    return total


def run(cell, seed: int, seconds: float, trace: bool, device, phases,
        fault=None) -> SimpleNamespace:
    """One run; `phases` (`timing.Phases`) times set-up from the process's
    start. `fault` (`faults.py`) wraps the resident step."""
    dev = torch.device(device)
    tr = cell.traffic
    k_lm = int(cell.config['config']['NUM_LANDMARKS'])
    pts = body_landmarks(seed, k_lm, float(tr['body_m']))
    keys = dict(cell.config['config'], **tr['config'],
                IMAGES_PER_GPU=tr['batch'], LANDMARKS=pts.tolist())
    cfg = program.make_config(keys)
    size = int(tr['crop'])
    if tuple(int(v) for v in cfg.IMAGE_SHAPE[:2]) != (size, size):
        raise RuntimeError(f"network shape {tuple(cfg.IMAGE_SHAPE[:2])} "
                           f"is not the {size}x{size} crop")
    bsz, n_img = int(cfg.BATCH_SIZE), int(tr['frames'])
    warm, check = int(tr['warmup_steps']), int(tr['check_steps'])
    if warm + check < 2:
        raise RuntimeError("update_gap reads the checked steps after the "
                           "first: warmup_steps + check_steps >= 2")
    k_cam = speed_crop_k(size, float(tr['focal']))

    net = program_landmarks.build_model(cfg, dev)
    weights = make_weights(program.float_shapes(net), seed, dev)
    missing = net.load_state_dict(weights, strict=False).missing_keys
    if missing:
        raise RuntimeError(f"weights not made for {missing[:4]}")
    phases.mark('model')
    data = crop_frames(seed, n_img, size, tr['depth_m'], float(tr['offset']),
                       dev)
    phases.mark('dataset')
    program_landmarks.reset_counts()
    step_fn, tx = program_landmarks.resident_train_step(
        cfg, dev, net, n_img, k_cam, (size, size))
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    # the batch norms (by name) and their running means
    bns, means = zip(*[(n[:-len('.running_mean')], b)
                       for n, b in net.named_buffers()
                       if n.endswith('.running_mean')])
    steps_epoch = max(n_img // bsz, 1)

    def reference(precision):
        rec = dict(rot_aug=cfg.ROT_AUG, rot_image_aug=cfg.ROT_IMAGE_AUG,
                   k_net=k_cam, mean=np.asarray(cfg.MEAN_PIXEL, np.float32),
                   landmarks=pts, sigma=float(cfg.HEATMAP_SIGMA),
                   heatmap_hw=heatmap_hw(size, size))
        opt = dict(lr=float(cfg.LEARNING_RATE),
                   clip=float(cfg.GRADIENT_CLIP_NORM),
                   weight_decay=float(cfg.WEIGHT_DECAY))
        return LandmarkReference(weights, names, rec, opt, precision,
                                 checkpointed=dev.type == 'cuda')

    def rows(i):
        return positions(i, steps_epoch, bsz, n_img, dev)

    if fault is not None:
        env = SimpleNamespace(model=net, tx=tx, positions=rows,
                              reference=reference)
        step_fn = fault(step_fn, env)
    phases.mark('step')
    cuda = dev.type == 'cuda'
    draws = torch.Generator(device=dev)
    state = {'s': 0, 'i': 0, 'perm': None, 'epoch': -1}
    losses = []
    n_par = sum(p.numel() for p in params)
    # the state before each checked step: parameters and AMSGrad's slots,
    # flat, in pinned host memory (snaps[0] is the seeded weights')
    snaps = [torch.empty(4 * n_par, dtype=torch.float32, pin_memory=cuda)
             for _ in range(warm + check + 1)]
    snaps[0][:n_par] = torch.cat([weights[n].flatten() for n in names]).cpu()
    snaps[0][n_par:] = 0
    n_mean = sum(b.numel() for b in means)
    mean_snaps = [torch.empty(n_mean, dtype=torch.float32, pin_memory=cuda)
                  for _ in range(warm + check + 1)]
    mean_snaps[0].copy_(torch.cat([weights[n + '.running_mean'].flatten()
                                   for n in bns]))

    def one_step():
        s = state['s']
        epoch = s // steps_epoch
        if epoch != state['epoch']:
            state['perm'] = epoch_perm(seed, epoch, n_img, dev)
            state['epoch'] = epoch
        draws.manual_seed(step_seed(seed, s))
        state['i'], metrics = step_fn(data, state['perm'], state['i'], draws)
        state['s'] = s + 1
        if s < warm + check:
            losses.append(metrics['loss'])
            flat = [p.detach().reshape(-1) for p in params] + [
                t.reshape(-1) for k in AMSGRAD_SLOTS for t in tx.state[k]]
            snaps[s + 1].copy_(torch.cat(flat), non_blocking=True)
            mean_snaps[s + 1].copy_(torch.cat([b.reshape(-1) for b in means]),
                                    non_blocking=True)

    for _ in range(warm):
        one_step()
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    phases.mark('warmup')
    setup_s = phases.total()

    def loop(secs, prof=None):
        start, first = time.perf_counter(), state['s']
        deadline = start + secs
        while True:
            if prof is not None:
                with torch.profiler.record_function(STEP_SPAN):
                    one_step()
            else:
                one_step()
            if time.perf_counter() >= deadline and \
                    state['s'] >= warm + check:
                break
        if cuda:
            torch.cuda.synchronize()
        return state['s'] - first, time.perf_counter() - start

    tr_data, traced, fuse_s = None, 0, None
    if trace:
        n_steps, window_s = loop(seconds / 2)
        with timing.profiled(WINDOW_SPAN) as prof:
            traced, _ = loop(seconds / 2, prof)
        import traces
        tr_data = traces.collect(prof, WINDOW_SPAN)
        fuse_s = launched_within(prof, FUSE_SPAN, tr_data.window)
        del prof
    else:
        n_steps, window_s = loop(seconds)
    window_peak = torch.cuda.max_memory_allocated() if cuda else None
    counts = program_landmarks.counts()

    prog_loss = [float(v) for v in losses]
    del step_fn, tx, net, params, means, losses
    if fault is not None:
        del env
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    notes = [f'hrnet counts: {counts}']
    t_ref = time.perf_counter()
    ref = reference('f32')
    sizes = [weights[n].numel() for n in names]

    def unflat(flat):
        return dict(zip(names, (t.view_as(weights[n]) for t, n in
                                zip(flat.to(dev).split(sizes), names))))

    perm = epoch_perm(seed, 0, n_img, dev)
    loss_gaps, update_gaps, stats_gaps = [], [], []
    for s in range(warm + check):
        if s and s % steps_epoch == 0:
            perm = epoch_perm(seed, s // steps_epoch, n_img, dev)
        idx = perm.index_select(0, rows(s))
        gen = torch.Generator(device=dev).manual_seed(step_seed(seed, s))
        before, after = snaps[s].to(dev), snaps[s + 1].to(dev)
        ref.set_state(unflat(before[:n_par]),
                      {k: unflat(before[(i + 1) * n_par:(i + 2) * n_par])
                       for i, k in enumerate(AMSGRAD_SLOTS)}, s)
        out = ref.step({k: v.index_select(0, idx) for k, v in data.items()},
                       gen)
        with torch.no_grad():
            want = torch.cat([ref.params[n].flatten() for n in names]) \
                - before[:n_par]
            got = after[:n_par] - before[:n_par]
            update_gaps.append(float(torch.linalg.vector_norm(got - want)
                                     / torch.linalg.vector_norm(want)))
            r0, r1 = mean_snaps[s].to(dev), mean_snaps[s + 1].to(dev)
            mu = (r1 - BN_MOMENTUM * r0) / (1.0 - BN_MOMENTUM)
            mu_ref = torch.cat([ref.last_stats[n][0].flatten() for n in bns])
            stats_gaps.append(float(torch.linalg.vector_norm(mu - mu_ref)
                                    / torch.linalg.vector_norm(mu_ref)))
        loss_gaps.append(abs(prog_loss[s] - out['loss'])
                         / max(abs(out['loss']), 1e-30))
        notes.append(f"step {s}: loss {prog_loss[s]:.6g} vs {out['loss']:.6g}"
                     f" (gap {loss_gaps[-1]:.4g}), stats gap "
                     f"{stats_gaps[-1]:.4g}, update gap {update_gaps[-1]:.4g}"
                     f"; global grad norm {out['global_norm']:.4g};"
                     f" largest heatmap {out['out_max']['heatmaps']:.4g}")
    notes.append(f'reference: {warm + check} steps in '
                 f'{time.perf_counter() - t_ref:.3f} s')
    checks = {
        'loss_gap': {'value': sum(loss_gaps) / len(loss_gaps),
                     'limit': cell.limits['loss_gap']},
        'stats_gap': {'value': statistics.median(stats_gaps),
                      'limit': cell.limits['stats_gap']},
        'update_gap': {'value': statistics.median(update_gaps[1:]),
                       'limit': cell.limits['update_gap']},
    }
    metrics = {
        'train_imgs_per_s': {'value': n_steps * bsz / window_s,
                             'unit': 'imgs/s'},
        'setup_s': {'value': setup_s, 'unit': 's'},
    }
    if cuda:
        metrics['peak_mem_gib'] = {'value': window_peak / 2 ** 30,
                                   'unit': 'GiB'}
    ctx = SimpleNamespace(kind='train_landmarks', model=None, traffic=tr,
                          height=size, width=size, batch=bsz,
                          landmarks=k_lm, steps=n_steps,
                          images=n_steps * bsz, window_s=window_s,
                          trace=tr_data, traced=traced, fuse_s=fuse_s,
                          hrnet_counts=counts, bf16=bool(cfg.F16))
    return SimpleNamespace(
        metrics=metrics, checks=checks, attempted=state['s'], failed=0,
        ctx=ctx, notes=notes,
        memory_peak_bytes=(max(setup_peak, window_peak) if cuda else None))
