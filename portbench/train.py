"""Traffic kind 'train': the program's train step over a device-resident
dataset, one step after another.

Set-up (timed as `setup_s` from the process's start): the model with
weights made on the card from the seed, the dataset of `frames` URSO-like
frames made on the card (`inputs.urso_frames`), the optimizer and the
on-device preprocess, and the first `warmup_steps` steps of the window's
own call. Step s takes rows perm[(s mod S)·B + 0..B-1] of the dataset
(S = frames // B steps an epoch, a new permutation each epoch, drawn
from the seed) and its augmentation draws from a generator seeded for s.
The window: steps until `--seconds` have passed and at least
`check_steps` steps are done, then a synchronize; the rate counts the
images of every step in it.

`correct`: the losses of the set-up's steps and of the window's first
`check_steps` steps, and the parameters' change after those (read on the
card once the window's step `check_steps` is queued, with no wait), are
compared, once the window has closed and the program's state is freed,
with the plain reference (`reference/train_step.py`) run over the same
steps from the same weights, rows and draws. Each gap is relative, by
the worst leaf for the change: |program - reference| over the larger of
the reference's value for that leaf and its median leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
rounding alone and are left out of the change's gap. The gradient norms
of the first step as the optimizer took them (its velocity after one
step over -lr) are read the same way and printed, not compared: neither
the control nor a fault reads them far enough above sound runs to hold a
limit.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

import faults
import inputs
import program
import timing
from reference.train_step import TrainReference, net_intrinsics, \
    ori_grid, urso_camera_k
from weights import make_weights

# what `faults.fault` can put in the timed call's place
FAULTS = {'control': faults.train_control, 'unchanged': faults.unchanged,
          'half_batch': faults.half_batch}
WINDOW_SPAN = 'portbench.window'
STEP_SPAN = 'portbench.train.step'
URSO_HW = (960, 1280)


def step_seed(seed: int, step: int) -> int:
    return inputs.derived_seed(seed, 1000 + step)


def epoch_perm(seed: int, epoch: int, n: int, dev):
    gen = torch.Generator(device=dev).manual_seed(
        inputs.derived_seed(seed, 10 ** 6 + epoch))
    return torch.randperm(n, generator=gen, device=dev)


def positions(step: int, steps: int, bsz: int, n: int, dev):
    return ((step % steps) * bsz + torch.arange(bsz, device=dev)) % n


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, median of ref)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in ref]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def run(cell, seed: int, seconds: float, trace: bool, device, phases,
        fault=None) -> SimpleNamespace:
    """One run; `phases` (`timing.Phases`) times set-up from the process's
    start. `fault` (`faults.py`) wraps the resident step."""
    dev = torch.device(device)
    tr = cell.traffic
    keys = dict(cell.config['config'], **tr['config'],
                IMAGES_PER_GPU=tr['batch'])
    cfg = program.make_config(keys)
    bsz, n_img = int(cfg.BATCH_SIZE), int(tr['frames'])
    warm, check = int(tr['warmup_steps']), int(tr['check_steps'])
    if warm < 1:
        raise RuntimeError("warmup_steps: the first gradient is read "
                           "after the first step of set-up")
    hp, wp, window, scale = inputs.pad64_geometry(
        *URSO_HW, cfg.IMAGE_MIN_DIM, cfg.IMAGE_MAX_DIM)
    if (hp, wp) != tuple(int(v) for v in cfg.IMAGE_SHAPE[:2]):
        raise RuntimeError(f"network shape {(hp, wp)} is not the "
                           f"configuration's {cfg.IMAGE_SHAPE[:2]}")

    net = program.build_model(cfg, dev)
    weights = make_weights(program.float_shapes(net), seed, dev)
    missing = net.load_state_dict(weights, strict=False).missing_keys
    if missing:
        raise RuntimeError(f"weights not made for {missing[:4]}")
    phases.mark('model')
    data = inputs.urso_frames(seed, n_img, URSO_HW, (hp, wp), window, scale,
                              dev)
    phases.mark('dataset')
    step_fn, tx = program.resident_train_step(cfg, dev, net, n_img)
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    steps_epoch = max(n_img // bsz, 1)

    def reference(precision):
        return make_reference(cell, cfg, weights, names, window, scale,
                              precision, dev)

    def rows(i):
        return positions(i, steps_epoch, bsz, n_img, dev)

    if fault is not None:
        env = SimpleNamespace(model=net, tx=tx, positions=rows,
                              reference=reference)
        step_fn = fault(step_fn, env)
    phases.mark('step')
    draws = torch.Generator(device=dev)
    state = {'s': 0, 'i': 0, 'perm': None, 'epoch': -1}
    losses, parts, grad, change = [], [], None, None

    def one_step():
        nonlocal grad, change
        s = state['s']
        epoch = s // steps_epoch
        if epoch != state['epoch']:
            state['perm'] = epoch_perm(seed, epoch, n_img, dev)
            state['epoch'] = epoch
        draws.manual_seed(step_seed(seed, s))
        state['i'], metrics = step_fn(data, state['perm'], state['i'], draws)
        state['s'] = s + 1
        if s < warm + check:
            # the checked steps: readings queued on the card, read after
            # the window
            losses.append(metrics['loss'])
            parts.append({k: v for k, v in metrics.items()
                          if k.endswith('_loss')})
        if s == 0:
            lr = tx.lr_at(0)
            grad = torch.stack([torch.linalg.vector_norm(v) / lr
                                for v in tx.state['velocity']])
        if s == warm + check - 1:
            change = torch.stack([torch.linalg.vector_norm(
                p.detach().float() - weights[n])
                for n, p in zip(names, params)])

    for _ in range(warm):
        one_step()
    cuda = dev.type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    phases.mark('warmup')
    setup_s = phases.total()

    def loop(secs, prof=None):
        """Steps until `secs` have passed and the checked steps are done,
        then a synchronize; (steps, seconds)."""
        start, first = time.perf_counter(), state['s']
        deadline = start + secs
        while True:
            if prof is not None:
                with torch.profiler.record_function(STEP_SPAN):
                    one_step()
            else:
                one_step()
            if time.perf_counter() >= deadline and change is not None:
                break
        if cuda:
            torch.cuda.synchronize()
        return state['s'] - first, time.perf_counter() - start

    tr_data, traced = None, 0
    if trace:
        # host-clock readings from an untraced first half, device ones
        # from a traced second half: the profiler's host overhead slows
        # the steps it records
        n_steps, window_s = loop(seconds / 2)
        with timing.profiled(WINDOW_SPAN) as prof:
            traced, _ = loop(seconds / 2, prof)
        import traces
        tr_data = traces.collect(prof, WINDOW_SPAN)
        del prof
    else:
        n_steps, window_s = loop(seconds)
    window_peak = torch.cuda.max_memory_allocated() if cuda else None

    prog = {'loss': [float(v) for v in losses],
            'parts': [{k: float(v) for k, v in p.items()} for p in parts],
            'grad': dict(zip(names, grad.tolist())),
            'change': dict(zip(names, change.tolist()))}
    del step_fn, tx, net, params, grad, change, losses, parts
    if fault is not None:
        del env
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    notes = []
    t_ref = time.perf_counter()
    ref = reference_steps(reference('f32'), seed, data, weights, rows,
                          steps_epoch, dev, warm + check)
    checks = compare(cell.limits, prog, ref, notes)
    notes.append(f'reference: {warm + check} steps in '
                 f'{time.perf_counter() - t_ref:.3f} s')

    metrics = {
        'train_imgs_per_s': {'value': n_steps * bsz / window_s,
                             'unit': 'imgs/s'},
        'setup_s': {'value': setup_s, 'unit': 's'},
    }
    if cuda:
        metrics['peak_mem_gib'] = {'value': window_peak / 2 ** 30,
                                   'unit': 'GiB'}
    ctx = SimpleNamespace(kind='train', model=cell.model, traffic=tr,
                          height=hp, width=wp, batch=bsz, steps=n_steps,
                          images=n_steps * bsz, window_s=window_s,
                          trace=tr_data, traced=traced, bf16=bool(cfg.F16))
    return SimpleNamespace(
        metrics=metrics, checks=checks, attempted=state['s'], failed=0,
        ctx=ctx, notes=notes,
        memory_peak_bytes=(max(setup_peak, window_peak) if cuda else None))


def make_reference(cell, cfg, weights, names, window, scale, precision,
                   dev) -> TrainReference:
    """The plain reference of the program's step for `cfg`, from the seeded
    weights, computing its products at `precision` ('f32', 'fp8')."""
    rec = dict(rot_aug=cfg.ROT_AUG, rot_image_aug=cfg.ROT_IMAGE_AUG,
               k_net=net_intrinsics(urso_camera_k(), window, scale),
               mean=np.asarray(cfg.MEAN_PIXEL, np.float32),
               keypoints=bool(cfg.REGRESS_KEYPOINTS), kp_scale=3.0,
               bins=int(cfg.ORI_BINS_PER_DIM), beta=float(cfg.BETA))
    if not rec['keypoints']:
        q, m = ori_grid(rec['bins'])
        rec['grid'] = (torch.from_numpy(q).to(dev), torch.from_numpy(m)
                       .to(dev))
    opt = dict(lr=float(cfg.LEARNING_RATE),
               momentum=float(cfg.LEARNING_MOMENTUM),
               clip=float(cfg.GRADIENT_CLIP_NORM),
               weight_decay=float(cfg.WEIGHT_DECAY),
               loss_weights=dict(cfg.LOSS_WEIGHTS))
    return TrainReference(weights, names, cell.model, rec, opt, precision)


def reference_steps(ref, seed, data, weights, rows, steps_epoch, dev,
                    n_steps):
    """The reference's first n_steps steps on the run's rows and draws:
    (losses, first gradient norms, change norms, each norm by leaf; each
    step's loss parts, global gradient norm and largest head output)."""
    n_img = int(data['images_u8'].shape[0])
    losses, grad, info = [], None, []
    perm = epoch_perm(seed, 0, n_img, dev)
    for s in range(n_steps):
        if s and s % steps_epoch == 0:
            perm = epoch_perm(seed, s // steps_epoch, n_img, dev)
        idx = perm.index_select(0, rows(s))
        raw = {k: v.index_select(0, idx) for k, v in data.items()}
        gen = torch.Generator(device=dev).manual_seed(step_seed(seed, s))
        out = ref.step(raw, gen)
        losses.append(out['loss'])
        info.append({k: out[k] for k in ('parts', 'global_norm', 'out_max')})
        if s == 0:
            grad = out['grad_norms']
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(ref.params[n]
                                                    - weights[n]))
                  for n in ref.names}
    return losses, grad, change, info


def _worst(got: dict, ref: dict, n: int = 3) -> list:
    med = float(np.median(list(ref.values())))
    gaps = sorted(((abs(got[k] - ref[k]) / max(ref[k], med, 1e-30), k)
                   for k in ref), reverse=True)[:n]
    return [f'{k} {g:.4f} ({got[k]:.4g} vs {ref[k]:.4g})' for g, k in gaps]


def compare(limits: dict, got: dict, ref: tuple, notes: list) -> dict:
    """The gaps of the program's readings `got` to the reference's `ref`
    (`reference_steps`); what they are made of goes to `notes`."""
    r_loss, r_grad, r_change, r_info = ref
    for s, (a, b, i) in enumerate(zip(got['loss'], r_loss, r_info)):
        parts = got['parts'][s]
        notes.append(f"step {s}: loss {a:.6g} vs {b:.6g}; parts "
                     + ", ".join(f"{k} {parts.get(k, float('nan')):.6g}"
                                 f" vs {v:.6g}"
                                 for k, v in i['parts'].items())
                     + f"; global grad norm {i['global_norm']:.4g};"
                     f" largest output {i['out_max']}")
    notes.append('worst gradient leaves: '
                 + '; '.join(_worst(got['grad'], r_grad)))
    notes.append('worst change leaves: '
                 + '; '.join(_worst(got['change'], r_change)))
    med = float(np.median(list(r_grad.values())))
    moving = {k for k, v in r_grad.items() if v >= 1e-3 * med}
    # read, not compared: neither the control nor a fault reads it three
    # or ten times over sound runs (PERF.md)
    notes.append(f'grad_gap (not compared): '
                 f'{leaf_gap(got["grad"], r_grad)!r}')
    return {
        'loss_gap': {'value': max(abs(a - b) / max(abs(b), 1e-30)
                                  for a, b in zip(got['loss'], r_loss)),
                     'limit': limits['loss_gap']},
        'update_gap': {'value': leaf_gap(got['change'], r_change, moving),
                       'limit': limits['update_gap']},
    }
