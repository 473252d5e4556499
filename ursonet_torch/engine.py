"""The engine, the port of `ursonet_tpu/engine.py::UrsoNet`: training
with checkpoints and exact resume (`UrsoNet`), and serving
(`ServingEngine`, which `UrsoNet` serves through).

    ds = Urso(); ds.load_dataset(d, cfg, 'train')
    net = UrsoNet('training', cfg, model_dir)   # device='cuda' by default
    net.train(ds, val_ds, learning_rate, epochs, layers='all')
    net.resume_state(run_dir)                   # weights, velocity, step
    net.quantize(calib_images); net.detect(images)

`UrsoNet.train` runs the epoch loop: the on-device preprocess with the
warp kernel, batches from a device-resident dataset (`use_resident`) or
streamed from disk by `data_generator` in a `Prefetcher` thread, metric
sums kept on the device and read once an epoch, validation, and per
epoch `metrics.jsonl`, a config dump, a weight snapshot and
`state_latest.msgpack` in the run dir (`checkpoint/store.py`, the JAX
package's layout: each package loads and resumes the other's files).

    engine = ServingEngine(config)              # float model, seeded weights
    engine.quantize(calib_images)               # or load_serving_artifact()
    outputs = engine.predict_molded(molded)     # int8 after quantize()
    results = engine.detect(images)             # per-image head outputs

`predict_molded` is the one forward entry point: after `quantize()` or
`load_serving_artifact()` it serves the int8 model, and under
INT8_U8_INPUT it ships the batch as uint8 pixels, rint(molded + mean)
clipped to 0..255; otherwise it runs the float model in eval mode, in
bf16 under F16 with its head outputs widened to f32 (`bench.py`'s
BENCH_QUANT=0 forward). Under
QUANT_HOST_S2D every batch the int8 model sees, served or calibrated, is
packed space-to-depth on the host first (`_host_s2d_maybe`), so the
device reads [B,H/2,W/2,12] pixels straight into the fused stem kernel.
`detect` takes frames at any size: `mold_inputs` resizes them to the
network shape (`ops/image.py::resize_image`). Runs on `device` (default
the card); the CPU only when asked for.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ursonet_torch.checkpoint import store
from ursonet_torch.checkpoint.convert import params_to_jax_layout
from ursonet_torch.checkpoint.quant_store import load_quantized
from ursonet_torch.data import loader
from ursonet_torch.device import resolve_device
from ursonet_torch.models.quant import QuantizedModel
from ursonet_torch.models.resnet import space_to_depth2
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops.image import compose_image_meta, mold_image, \
    resize_image
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_eval_step, \
    make_resident_eval_step, make_resident_train_step, make_train_step
from ursonet_torch.utils.memory import check_train_memory


class ServingEngine:
    """Float and int8 serving of one configuration on one device."""

    def __init__(self, config, device='cuda', model=None,
                 generator: Optional[torch.Generator] = None):
        """`model`: the float model to serve, else one built for
        `config` with weights from `generator` when first needed (an
        engine that serves an artifact never builds it)."""
        self.config = config
        self.device = resolve_device(device)
        self._model = model
        self._generator = generator
        self.qmodel: Optional[QuantizedModel] = None

    @property
    def model(self):
        if self._model is None:
            self._model = build_model(self.config, self.device,
                                      self._generator)
        return self._model.eval()

    # -- int8 -----------------------------------------------------------------

    def quantize(self, calib_images: Optional[Sequence[np.ndarray]] = None,
                 headroom: float = 1.0) -> QuantizedModel:
        """Switch predict_molded() to the int8 model of the current float
        weights. calib_images: raw images for the activation calibration;
        without them it happens on the first served batch."""
        tree = params_to_jax_layout(self.model.state_dict())
        self.qmodel = QuantizedModel.from_variables(
            self.config, tree['params'], tree['batch_stats'], self.device)
        if calib_images is not None:
            molded, _, _ = self.mold_inputs(calib_images)
            self.qmodel.calibrate(self._host_s2d_maybe(molded),
                                  percentile_headroom=headroom)
        return self.qmodel

    def _host_s2d_maybe(self, molded):
        """Space-to-depth reindex of a [B,H,W,3] batch for a model in
        host-s2d mode (QUANT_HOST_S2D): the same bytes as
        [B,H/2,W/2,12], channel order (dy,dx,c). A numpy batch is
        reindexed on the host (by torch's threaded CPU copy, which takes
        a third of numpy's time for a 128x512x640 batch), a tensor where
        it lies. Anything else (no int8 model, another mode, a batch
        already packed) passes through."""
        if not (self.qmodel is not None
                and self.qmodel._mcfg.get('host_s2d')
                and tuple(molded.shape)[-1] == 3):
            return molded
        if isinstance(molded, torch.Tensor):
            return space_to_depth2(molded).contiguous()
        x = torch.from_numpy(np.ascontiguousarray(molded))
        return space_to_depth2(x).contiguous().numpy()

    def load_serving_artifact(self, path: str) -> QuantizedModel:
        """Serve a calibrated int8 artifact (checkpoint/quant_store.py)."""
        self.qmodel = load_quantized(path, self.config, self.device)
        return self.qmodel

    # -- forward --------------------------------------------------------------

    def predict_molded(self, molded) -> dict:
        """Forward a molded [B,H,W,3] batch (or, for the int8 model, raw
        uint8 pixels) through the serving path; returns head outputs as
        tensors on the device."""
        if self.qmodel is not None:
            x = self.served_batch(molded)
            if self.qmodel.act_scales is None:
                self.qmodel.calibrate(x)
            return self.qmodel(x)
        x = molded if isinstance(molded, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(molded))
        x = x.to(self.device, torch.float32).permute(0, 3, 1, 2)
        with torch.no_grad():
            # the model casts to its compute dtype (bf16 under F16) and
            # returns f32 head outputs
            return self.model(x)

    def served_batch(self, molded):
        """The batch the int8 model is given for a molded one: under
        INT8_U8_INPUT the uint8 pixels rint(molded + mean) clipped to
        0..255 (a uint8 batch as it is), packed by `_host_s2d_maybe`."""
        if (getattr(self.config, 'INT8_U8_INPUT', True)
                and tuple(molded.shape)[-1] == 3
                and not (isinstance(molded, np.ndarray)
                         and molded.dtype == np.uint8)
                and not (isinstance(molded, torch.Tensor)
                         and molded.dtype == torch.uint8)):
            mean = np.asarray(self.config.MEAN_PIXEL, np.float32)
            if isinstance(molded, torch.Tensor):
                molded = molded.cpu().numpy()
            molded = np.clip(np.rint(np.asarray(molded, np.float32)
                                     + mean), 0, 255).astype(np.uint8)
        return self._host_s2d_maybe(molded)

    def mold_inputs(self, images: Sequence[np.ndarray]):
        """Resize + pad + mean-subtract + meta for raw frames. Returns
        (molded [B,H,W,3], metas, windows)."""
        cfg = self.config
        molded, metas, windows = [], [], []
        for image in images:
            m, window, scale, _, _ = resize_image(
                image, min_dim=cfg.IMAGE_MIN_DIM,
                min_scale=cfg.IMAGE_MIN_SCALE, max_dim=cfg.IMAGE_MAX_DIM,
                mode=cfg.IMAGE_RESIZE_MODE)
            molded.append(mold_image(m.astype(np.float32), cfg))
            metas.append(compose_image_meta(0, image.shape, m.shape, window,
                                            scale))
            windows.append(window)
        return np.stack(molded), np.stack(metas), np.stack(windows)

    def detect(self, images: Sequence[np.ndarray]) -> List[dict]:
        """Per-image raw head outputs for a batch of BATCH_SIZE images:
        {'loc', 'ori'}, or {'loc', 'k1', 'k2'} for a keypoint model."""
        cfg = self.config
        if len(images) != cfg.BATCH_SIZE:
            raise ValueError(f'len(images) must equal BATCH_SIZE '
                             f'({cfg.BATCH_SIZE}), got {len(images)}')
        molded, _, _ = self.mold_inputs(images)
        outputs = {k: v.cpu().numpy()
                   for k, v in self.predict_molded(molded).items()}
        return [{k: v[i] for k, v in outputs.items()}
                for i in range(len(images))]


class UrsoNet:
    """Training engine of one configuration on one device (default the
    card): the model, its Keras SGD state, the step and epoch counters
    and the run dir. Serves through a `ServingEngine` that shares the
    model."""

    def __init__(self, mode: str, config, model_dir: str, device='cuda'):
        if mode not in ('training', 'inference'):
            raise ValueError(f"mode must be 'training' or 'inference', got "
                             f"{mode!r}")
        if getattr(config, 'CHECKPOINT_FORMAT', 'msgpack') != 'msgpack':
            raise NotImplementedError(
                f"CHECKPOINT_FORMAT={config.CHECKPOINT_FORMAT!r}: the orbax "
                "store is not ported (ROADMAP §1); use 'msgpack'")
        self.mode = mode
        self.config = config
        self.model_dir = model_dir
        self.device = resolve_device(device)
        self.epoch = 0
        self.step = 0
        self.model = None
        self.tx = make_optimizer(config)
        # the optimizer's velocity by parameter name (the tensors the
        # train step updates in place)
        self.velocity = {}
        self.serving = None
        self.set_log_dir()

    # -- bookkeeping ----------------------------------------------------------

    def set_log_dir(self, weights_path: Optional[str] = None):
        """Run dir, checkpoint template and epoch counter; a snapshot path
        of a run dir continues that run."""
        self.log_dir, self.checkpoint_path, self.epoch = store.set_log_dir(
            self.model_dir, self.config.NAME, weights_path)

    def find_last(self) -> str:
        return store.find_last(self.model_dir)

    def get_last_checkpoint(self, model_name: str) -> str:
        return store.get_last_checkpoint(self.model_dir, model_name)

    # -- weights --------------------------------------------------------------

    def initialize(self, seed: Optional[int] = None):
        """Fresh weights from `seed` (default config.SEED), a fresh
        optimizer state."""
        seed = self.config.SEED if seed is None else seed
        self.model = build_model(self.config, self.device,
                                 torch.Generator().manual_seed(int(seed)))
        self._reset_optimizer()
        self.serving = None
        return self.model

    def _reset_optimizer(self):
        self.velocity = {}
        self.tx.velocity = None

    def _drop_qmodel(self):
        """A quantized model derives from the weights it was made from."""
        if self.serving is not None:
            self.serving.qmodel = None

    def load_weights(self, path: str, exclude: Sequence[str] = (),
                     verbose: bool = False):
        """Load a msgpack weight snapshot of either package by layer name,
        skipping layers that fully match a regex of `exclude` and tensors
        of another shape; the optimizer state starts afresh. A snapshot
        of a run dir continues that run's epochs."""
        if path.endswith('.h5'):
            raise NotImplementedError(
                f'{path}: the Keras h5 bridge comes with the h5 slice '
                '(ROADMAP §1)')
        if path.endswith('.orbax'):
            raise NotImplementedError(
                f'{path}: the orbax store is not ported (ROADMAP §1)')
        if self.model is None:
            self.initialize()
        merged, loaded, skipped = store.merge_params(
            self.model.state_dict(), store.load_weights_file(path), exclude)
        self.model.load_state_dict(merged)
        if verbose:
            print(f"loaded {len(loaded)} layers, skipped {skipped}")
        self._drop_qmodel()
        self._reset_optimizer()
        self.set_log_dir(path)
        return self.model

    def save_weights(self, path: str):
        store.save_weights_file(path, self.model.state_dict())

    def resume_state(self, run_dir: Optional[str] = None) -> bool:
        """Exact resume from `state_latest.msgpack` in `run_dir` (default
        the current run dir), written by either package: weights,
        velocity, step and epoch. Returns False when there is none."""
        run_dir = run_dir or self.log_dir
        if os.path.exists(os.path.join(run_dir, 'state_latest.orbax')):
            raise NotImplementedError(
                f'{run_dir}: orbax states are not ported (ROADMAP §1)')
        path = os.path.join(run_dir, 'state_latest.msgpack')
        if not os.path.exists(path):
            return False
        if self.model is None:
            self.initialize()
        tree = store.load_state(path)
        self.model.load_state_dict(tree['state_dict'])
        self._drop_qmodel()
        self._reset_optimizer()
        params = dict(self.model.named_parameters())
        self.velocity = {n: v.to(self.device) for n, v in
                         tree['velocity'].items() if n in params}
        self.step = tree['step']
        self.epoch = tree['epoch']
        self.log_dir = run_dir
        self.checkpoint_path = os.path.join(
            run_dir, os.path.basename(self.checkpoint_path))
        return True

    def _bind_velocity(self, names):
        """Hand the optimizer the velocity of the parameters `names` (in
        the train step's order), zeros where there is none yet."""
        params = dict(self.model.named_parameters())
        for n in names:
            if n not in self.velocity:
                self.velocity[n] = torch.zeros_like(params[n])
        self.tx.velocity = [self.velocity[n] for n in names]

    # -- training -------------------------------------------------------------

    def train(self, train_dataset, val_dataset, learning_rate: float,
              epochs: int, layers: str = 'all', log_fn=print) -> dict:
        """Train from self.epoch up to `epochs`. layers: a preset of
        train.state.LAYER_REGEX or a layer-name regex. Returns the last
        epoch's metric means (validation ones prefixed 'val_')."""
        if self.mode != 'training':
            raise RuntimeError('create the engine in training mode')
        cfg = self.config
        dev = self.device
        if learning_rate is not None and learning_rate != cfg.LEARNING_RATE:
            cfg.LEARNING_RATE = learning_rate
            self.tx = make_optimizer(cfg)
            self._reset_optimizer()
        if self.model is None:
            self.initialize()
        self._drop_qmodel()   # training replaces the weights it serves
        check_train_memory(cfg, dev, log_fn)

        mask = trainable_mask(self.model, layers)
        self._bind_velocity([n for n, _ in self.model.named_parameters()
                             if mask[n]])
        pre = loader.make_device_preprocess(
            cfg, train_dataset.camera, dev, train_dataset.name)
        resident = loader.use_resident(train_dataset, cfg)
        train_gen = val_gen = res_train = res_val = None
        if resident:
            res_train, n_train = loader.load_dataset_resident(
                train_dataset, cfg, dev)
            train_step = make_resident_train_step(
                self.model, cfg, self.tx, n_train, mask, pre, dev)
            if val_dataset is not None:
                res_val, n_val = loader.load_dataset_resident(
                    val_dataset, cfg, dev)
                eval_step = make_resident_eval_step(self.model, cfg, n_val,
                                                    pre, dev)
            log_fn(f"data: device-resident ({n_train} train"
                   + (f" + {n_val} val" if res_val is not None else "")
                   + " images)")
        else:
            train_step = make_train_step(self.model, cfg, self.tx, mask, pre,
                                         dev)
            eval_step = make_eval_step(self.model, cfg, pre, dev)
            train_gen = loader.Prefetcher(loader.data_generator(
                train_dataset, cfg, shuffle=True, batch_size=cfg.BATCH_SIZE,
                seed=cfg.SEED))
            if val_dataset is not None:
                # an epoch takes VALIDATION_STEPS batches: decoding more
                # ahead only competes with the train loader
                val_gen = loader.Prefetcher(loader.data_generator(
                    val_dataset, cfg, shuffle=True,
                    batch_size=cfg.BATCH_SIZE, seed=cfg.SEED + 1),
                    depth=max(1, min(8, int(cfg.VALIDATION_STEPS))))

        os.makedirs(self.log_dir, exist_ok=True)
        cfg.write_to_file(os.path.join(self.log_dir,
                                       f"config_{self.epoch}.json"))
        metrics_path = os.path.join(self.log_dir, 'metrics.jsonl')
        log_every = int(getattr(cfg, 'LOG_EVERY_STEPS', 0) or 0)
        # Every draw is keyed by the step or epoch it belongs to, as the
        # JAX package keys its resident step by fold_in(base_key, step):
        # a resumed run draws what an uninterrupted one would.
        draw_seed = cfg.SEED + (1 << 20)
        draws = torch.Generator(device=dev)
        perms = torch.Generator(device=dev)
        last_means = {}
        try:
            for epoch in range(self.epoch, epochs):
                t0 = time.time()
                if resident:
                    perms.manual_seed(_fold_seed(cfg.SEED, epoch))
                    perm = torch.randperm(n_train, generator=perms, device=dev)
                    i = 0
                sums, n = None, 0
                for _ in range(cfg.STEPS_PER_EPOCH):
                    draws.manual_seed(_fold_seed(draw_seed, self.step))
                    if resident:
                        i, metrics = train_step(res_train, perm, i, draws)
                    else:
                        metrics = train_step(next(train_gen), draws)
                    self.step += 1
                    n += 1
                    sums = metrics if sums is None else \
                        {k: sums[k] + v for k, v in metrics.items()}
                    if log_every and n % log_every == 0:
                        # opting in reads the metrics every log_every steps
                        with open(metrics_path, 'a') as f:
                            f.write(json.dumps(
                                {'step': self.step,
                                 **{k: round(float(v), 6)
                                    for k, v in metrics.items()}}) + '\n')
                vsums, vn = None, 0
                if val_gen is not None or res_val is not None:
                    iv = 0
                    draws.manual_seed(_fold_seed(draw_seed, (1 << 24) + epoch))
                    for _ in range(cfg.VALIDATION_STEPS):
                        if res_val is not None:
                            iv, m = eval_step(res_val, iv, draws)
                        else:
                            m = eval_step(next(val_gen), draws)
                        vn += 1
                        vsums = m if vsums is None else \
                            {k: vsums[k] + v for k, v in m.items()}
                means = _means((sums, n, ''), (vsums, vn, 'val_'))
                dt = time.time() - t0
                record = {'epoch': epoch, 'time_s': round(dt, 2),
                          'imgs_per_s': round(n * cfg.BATCH_SIZE / dt, 2),
                          **{k: round(v, 6) for k, v in means.items()}}
                with open(metrics_path, 'a') as f:
                    f.write(json.dumps(record) + '\n')
                log_fn(f"epoch {epoch}: " + " ".join(
                    f"{k}={v}" for k, v in record.items() if k != 'epoch'))
                self.save_weights(store.checkpoint_epoch(self.checkpoint_path,
                                                         epoch))
                self._prune_snapshots(int(getattr(cfg, 'CHECKPOINT_KEEP', 0)
                                          or 0))
                store.save_state(
                    os.path.join(self.log_dir, 'state_latest.msgpack'),
                    self.model, self.velocity, self.step, epoch + 1)
                self.epoch = epoch + 1
                last_means = means
        finally:
            for gen in (train_gen, val_gen):
                if gen is not None:
                    gen.close()
        return last_means

    def _prune_snapshots(self, keep: int):
        """Keep the newest `keep` per-epoch snapshots (0: all), ordered by
        the epoch parsed from the name; only names that match the
        snapshot template go."""
        if keep <= 0:
            return
        pat = re.compile(re.escape(os.path.basename(self.checkpoint_path))
                         .replace(re.escape('*epoch*'), r'(\d+)') + r'\Z')
        snaps = []
        for p in glob.glob(self.checkpoint_path.replace('*epoch*', '*')):
            m = pat.match(os.path.basename(p))
            if m:
                snaps.append((int(m.group(1)), p))
        for _, old in sorted(snaps)[:-keep]:
            os.remove(old)

    # -- introspection --------------------------------------------------------

    def summary(self, log_fn=print) -> dict:
        """Parameter counts per top-level module, and the total."""
        if self.model is None:
            self.initialize()
        counts = {}
        for name, p in self.model.named_parameters():
            top = name.split('.')[0]
            counts[top] = counts.get(top, 0) + p.numel()
        total = sum(counts.values())
        for k in sorted(counts):
            log_fn(f"{k:20} {counts[k]:>14,}")
        log_fn(f"{'total':20} {total:>14,}")
        return {'per_module': counts, 'total': total}

    # -- inference ------------------------------------------------------------

    def _serving(self) -> ServingEngine:
        if self.model is None:
            self.initialize()
        if self.serving is None:
            self.serving = ServingEngine(self.config, self.device,
                                         model=self.model)
        return self.serving

    def quantize(self, calib_images: Optional[Sequence[np.ndarray]] = None,
                 headroom: float = 1.0) -> QuantizedModel:
        """Serve the int8 model of the current weights from now on
        (until training or a load replaces them)."""
        return self._serving().quantize(calib_images, headroom)

    def predict_molded(self, molded) -> dict:
        return self._serving().predict_molded(molded)

    def mold_inputs(self, images: Sequence[np.ndarray]):
        return self._serving().mold_inputs(images)

    def detect(self, images: Sequence[np.ndarray]) -> List[dict]:
        return self._serving().detect(images)


def _fold_seed(seed: int, data: int) -> int:
    """A 64-bit generator seed derived from (seed, data), the
    counterpart of jax.random.fold_in(PRNGKey(seed), data)."""
    return int(np.random.SeedSequence([seed, data]).generate_state(
        1, np.uint64)[0])


def _means(*groups) -> dict:
    """{prefix + name: sum / n} over (sums, n, prefix) groups of metric
    sums (0-d tensors on the device), read from the device in one copy."""
    names, values, counts = [], [], []
    for sums, n, prefix in groups:
        for k, v in (sums or {}).items():
            names.append(prefix + k)
            values.append(v.float())
            counts.append(n)
    if not values:
        return {}
    got = torch.stack(values).cpu().tolist()
    return {k: v / n for k, v, n in zip(names, got, counts)}
