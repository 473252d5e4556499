"""The engine, the port of `ursonet_tpu/engine.py::UrsoNet`: training
with checkpoints and exact resume (`UrsoNet`), and serving
(`ServingEngine`, which `UrsoNet` serves through).

    ds = Urso(); ds.load_dataset(d, cfg, 'train')
    net = UrsoNet('training', cfg, model_dir)   # device='cuda' by default
    net.train(ds, val_ds, learning_rate, epochs, layers='all')
    net.resume_state(run_dir)                   # weights, optimizer, step
    net.quantize(calib_images); net.detect(images)

`UrsoNet.train` runs the epoch loop: the on-device preprocess with the
warp kernel, batches from a device-resident dataset (`use_resident`) or
streamed from disk by `data_generator` in a `Prefetcher` thread (under
AUGMENT_ON_DEVICE False the host-parity generator's augmented, molded
batches, and no device preprocess), metric
sums kept on the device and read once an epoch, validation, and per
epoch `metrics.jsonl`, a config dump, a weight snapshot (with the
batch norms' running statistics, which train under TRAIN_BN None / True)
and `state_latest.msgpack` in the run dir (`checkpoint/store.py`, the
JAX package's layout: each package loads and resumes the other's
files); under CHECKPOINT_FORMAT='orbax' the snapshots and
`state_latest.orbax` are Orbax directories (`checkpoint/orbax_store.py`)
in the layout the JAX package writes. Under DEBUG_NANS each step's metrics and weights are read for a
NaN (`train/step.py::check_nans`, the counterpart of jax_debug_nans).

    engine = ServingEngine(config)              # float model, seeded weights
    engine.quantize(calib_images)               # or load_serving_artifact()
    outputs = engine.predict_molded(molded)     # int8 after quantize()
    results = engine.detect(images)             # per-image head outputs

`predict_molded` is the one forward entry point: after `quantize()` or
`load_serving_artifact()` it serves the int8 model, and under
INT8_U8_INPUT it ships the batch as uint8 pixels, rint(molded + mean)
clipped to 0..255; otherwise it runs the float model in eval mode, in
bf16 under F16 with its head outputs widened to f32 (`bench.py`'s
BENCH_QUANT=0 forward); the landmark model (BACKBONE 'hrnet_w32')
serves in float only, returning its heatmaps and the landmarks decoded
from them (`ops/landmarks.py::decode`: 'landmarks' [B,K,2] input
pixels, 'landmark_scores' [B,K] the heatmaps' maxima). Under
QUANT_HOST_S2D every batch the int8 model sees, served or calibrated, is
packed space-to-depth on the host first (`_host_s2d_maybe`), so the
device reads [B,H/2,W/2,12] pixels straight into the fused stem kernel.
`detect` takes frames at any size: `mold_inputs` resizes them to the
network shape (`ops/image.py::resize_image`). Runs on `device` (default
the card); the CPU only when asked for.

Over several ranks (`parallel/`: MESH_DATA × MESH_MODEL processes,
launched by `torch.distributed.run`) `UrsoNet` makes the (data, model)
mesh, builds the whole model from the seed on every rank and keeps the
rank's head shards; `train` loads each rank's rows of the global batches
(`data_generator(batch_slice=...)`, or the rank's rows of a resident
dataset replicated on every rank), and rank 0 alone logs and writes the
run dir, `config_*.json`, `metrics.jsonl`, the snapshots and
`state_latest`, all whole: the head shards and their optimizer slots
are gathered first, so either package resumes the files, and a resume
reads the whole tree on every rank and keeps the rank's shards.
`predict_molded` pads a batch to the mesh's data rows, serves each
rank's rows and trims; `quantize` gathers the heads before it folds (the
int8 model is data-parallel only, `QuantizedModel.shard_over`).
"""

from __future__ import annotations

import datetime
import glob
import json
import os
import re
import shutil
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ursonet_torch.checkpoint import h5_import, store
from ursonet_torch.checkpoint.convert import params_to_jax_layout
from ursonet_torch.checkpoint.orbax_store import ORBAX_SUFFIX
from ursonet_torch.checkpoint.quant_store import load_quantized
from ursonet_torch.data import loader
from ursonet_torch.device import resolve_device
from ursonet_torch.models.hrnet import is_hrnet
from ursonet_torch.models.quant import QuantizedModel
from ursonet_torch.models.resnet import space_to_depth2
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops.image import compose_image_meta, mold_image, \
    resize_image
from ursonet_torch.ops.landmarks import HEATMAP_STRIDE
from ursonet_torch.ops.landmarks import decode as decode_landmarks
from ursonet_torch.parallel import make_mesh, multihost
from ursonet_torch.parallel.mesh import AXIS_DATA
from ursonet_torch.parallel.sharding import gather_rows, gathered, \
    model_split, replicated, shard_model, shard_state
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import check_nans, make_eval_step, \
    make_resident_eval_step, make_resident_train_step, make_train_step
from ursonet_torch.utils.memory import check_train_memory
from ursonet_torch.utils.profiling import span


class ServingEngine:
    """Float and int8 serving of one configuration on one device, or on
    each rank of a mesh."""

    def __init__(self, config, device='cuda', model=None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        """`model`: the float model to serve (sharded over `mesh` where
        one is given), else one built for `config` with weights from
        `generator` when first needed (an engine that serves an artifact
        never builds it)."""
        self.config = config
        self.device = resolve_device(device)
        self._model = model
        self._generator = generator
        self.mesh = mesh
        self.qmodel: Optional[QuantizedModel] = None

    @property
    def model(self):
        if self._model is None:
            self._model = build_model(self.config, self.device,
                                      self._generator)
            if self.mesh is not None:
                shard_model(self._model, self.mesh, self.config)
        return self._model.eval()

    @property
    def _data_rows(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[AXIS_DATA]

    # -- int8 -----------------------------------------------------------------

    def quantize(self, calib_images: Optional[Sequence[np.ndarray]] = None,
                 headroom: float = 1.0) -> QuantizedModel:
        """Switch predict_molded() to the int8 model of the current float
        weights. calib_images: raw images for the activation calibration;
        without them it happens on the first served batch. The landmark
        model has no int8 form and raises ValueError."""
        if is_hrnet(self.config.BACKBONE):
            raise ValueError(f"int8 PTQ covers the ResNet backbones; "
                             f"BACKBONE={self.config.BACKBONE!r} serves in "
                             f"float only (predict_molded before quantize)")
        # the heads made whole (collective over 'model')
        tree = params_to_jax_layout(self.model.state_dict(), self.mesh,
                                    model_split(self.model))
        self.qmodel = QuantizedModel.from_variables(
            self.config, tree['params'], tree['batch_stats'], self.device)
        self.qmodel.shard_over(self.mesh)
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
        self.qmodel.shard_over(self.mesh)
        return self.qmodel

    # -- forward --------------------------------------------------------------

    def predict_molded(self, molded) -> dict:
        """Forward a molded [B,H,W,3] batch (or, for the int8 model, raw
        uint8 pixels) through the serving path; returns head outputs as
        tensors on the device. Over a mesh whose 'data' axis splits, the
        batch is padded to a multiple of the data rows (repeating its
        last row), each rank serves its rows, the outputs are gathered
        (the int8 model's on the host under gloo) and trimmed; every
        rank of the mesh calls it with the same batch. Spans
        (`utils/profiling.py`): ursonet.serve.predict around it all,
        .pack, .h2d and .forward inside."""
        with span('ursonet.serve.predict'):
            n, rows = int(molded.shape[0]), self._data_rows
            pad = (-n) % rows
            if pad:
                last = molded[-1:]
                molded = torch.cat([molded] + [last] * pad) \
                    if isinstance(molded, torch.Tensor) \
                    else np.concatenate([molded] + [last] * pad)
            if self.qmodel is not None:
                with span('ursonet.serve.pack'):
                    x = self.served_batch(molded)
                if self.qmodel.act_scales is None:
                    self.qmodel.calibrate(x)
                out = self.qmodel(x)
            else:
                x = molded if isinstance(molded, torch.Tensor) \
                    else torch.from_numpy(np.ascontiguousarray(molded))
                if rows > 1:
                    lo, hi = multihost.local_batch_slice(self.mesh, len(x))
                    x = x[lo:hi]
                with span('ursonet.serve.h2d'):
                    x = x.to(self.device, torch.float32).permute(0, 3, 1, 2)
                with span('ursonet.serve.forward'), torch.no_grad():
                    # the model casts to its compute dtype (bf16 under
                    # F16) and returns f32 head outputs
                    out = self.model(x)
                if rows > 1:
                    group = self.mesh.group(AXIS_DATA)
                    out = {k: gather_rows(v, group) for k, v in out.items()}
                if 'heatmaps' in out:
                    out['landmarks'], out['landmark_scores'] = \
                        decode_landmarks(out['heatmaps'], HEATMAP_STRIDE)
            return {k: v[:n] for k, v in out.items()} if pad else out

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
    card), or on each rank of a (data, model) mesh: the model, its
    optimizer state, the step and epoch counters and the run dir. Serves
    through a `ServingEngine` that shares the model."""

    def __init__(self, mode: str, config, model_dir: str, device='cuda'):
        if mode not in ('training', 'inference'):
            raise ValueError(f"mode must be 'training' or 'inference', got "
                             f"{mode!r}")
        self.mode = mode
        self.config = config
        self.model_dir = model_dir
        self.device = resolve_device(device)
        # MESH_DATA x MESH_MODEL ranks (1 x 1 without a process group)
        self.mesh = make_mesh(config)
        self.epoch = 0
        self.step = 0
        self.model = None
        self.tx = make_optimizer(config)
        # the optimizer's slots by name and parameter name (the tensors
        # the train step updates in place)
        self.slots = {}
        self.serving = None
        self.set_log_dir()

    # -- bookkeeping ----------------------------------------------------------

    @property
    def _orbax(self) -> bool:
        return getattr(self.config, 'CHECKPOINT_FORMAT',
                       'msgpack') == 'orbax'

    def set_log_dir(self, weights_path: Optional[str] = None):
        """Run dir, checkpoint template and epoch counter; a snapshot path
        of a run dir continues that run. Snapshots are `.orbax`
        directories under CHECKPOINT_FORMAT='orbax', else `.msgpack`
        files."""
        ext = ORBAX_SUFFIX if self._orbax else store.WEIGHTS_EXT
        # every rank names the run dir by rank 0's clock
        now = replicated(self.mesh, torch.tensor(
            [int(time.time())], dtype=torch.int64, device=self.device))
        now = datetime.datetime.fromtimestamp(int(now.item()))
        self.log_dir, self.checkpoint_path, self.epoch = store.set_log_dir(
            self.model_dir, self.config.NAME, weights_path, now=now, ext=ext)

    def find_last(self) -> str:
        return store.find_last(self.model_dir)

    def get_last_checkpoint(self, model_name: str) -> str:
        return store.get_last_checkpoint(self.model_dir, model_name)

    # -- weights --------------------------------------------------------------

    def initialize(self, seed: Optional[int] = None):
        """Fresh weights from `seed` (default config.SEED), a fresh
        optimizer state."""
        seed = self.config.SEED if seed is None else seed
        # the whole model from the seed on every rank, then its shards
        self.model = shard_model(
            build_model(self.config, self.device,
                        torch.Generator().manual_seed(int(seed))),
            self.mesh, self.config)
        self._reset_optimizer()
        self.serving = None
        return self.model

    @property
    def velocity(self) -> dict:
        """The SGD velocity by parameter name (empty under Adam)."""
        return self.slots.get('velocity', {})

    def _reset_optimizer(self):
        self.slots = {}
        self.tx.reset()

    def _drop_qmodel(self):
        """A quantized model derives from the weights it was made from."""
        if self.serving is not None:
            self.serving.qmodel = None

    def load_weights(self, path: str, exclude: Sequence[str] = (),
                     verbose: bool = False):
        """Load a weight snapshot of either package (a msgpack file or an
        Orbax directory), or a Keras h5 weight file
        (`checkpoint/h5_import.py`), by layer name, skipping layers that
        fully match a regex of `exclude` and tensors of another shape;
        the optimizer state starts afresh. A snapshot of a run dir
        continues that run's epochs."""
        if self.model is None:
            self.initialize()
        verbose = verbose and self.mesh.is_writer
        whole = self.whole_state_dict()
        if path.endswith('.h5'):
            merged, _ = h5_import.load_keras_h5(path, whole, exclude,
                                                verbose)
        else:
            merged, loaded, skipped = store.merge_params(
                whole, store.load_weights_file(path), exclude)
            if verbose:
                print(f"loaded {len(loaded)} layers, skipped {skipped}")
        self.model.load_state_dict(shard_state(merged, self.mesh,
                                               model_split(self.model)))
        self._drop_qmodel()
        self._reset_optimizer()
        self.set_log_dir(path)
        return self.model

    def _whole(self):
        """The whole weights (`parallel/sharding.py::gathered`; every rank
        must call it)."""
        return gathered(self.model, self.mesh)

    def whole_state_dict(self) -> dict:
        """The model's state_dict with its head shards gathered, on the
        CPU (every rank of the mesh must call it)."""
        return self._whole().state_dict()

    def save_weights(self, path: str):
        """A weight snapshot of the whole model, written by rank 0 (every
        rank must call it)."""
        whole = self.whole_state_dict()
        if self.mesh.is_writer:
            store.save_weights_file(path, whole)

    def resume_state(self, run_dir: Optional[str] = None) -> bool:
        """Exact resume from `state_latest.orbax` or, where there is none,
        `state_latest.msgpack` in `run_dir` (default the current run dir),
        written by either package (the JAX engine's order): weights, the
        optimizer's slots and update count, step and epoch. Returns False
        when there is neither."""
        run_dir = run_dir or self.log_dir
        path = os.path.join(run_dir, 'state_latest' + ORBAX_SUFFIX)
        if not os.path.exists(path):
            path = os.path.join(run_dir, 'state_latest' + store.WEIGHTS_EXT)
        if not os.path.exists(path):
            return False
        if self.model is None:
            self.initialize()
        tree = store.load_state(path, self.mesh, model_split(self.model))
        self.model.load_state_dict(tree['state_dict'])
        self._drop_qmodel()
        self._reset_optimizer()
        params = dict(self.model.named_parameters())
        if set(tree['slots']) != set(self.tx.SLOTS):
            raise ValueError(
                f'{path}: the state holds the slots {sorted(tree["slots"])} '
                f'but OPTIMIZER={self.config.OPTIMIZER!r} keeps '
                f'{sorted(self.tx.SLOTS)}')
        self.slots = {s: {n: v.to(self.device) for n, v in vals.items()
                          if n in params}
                      for s, vals in tree['slots'].items()}
        self.tx.count = tree['count']
        self.step = tree['step']
        self.epoch = tree['epoch']
        self.log_dir = run_dir
        self.checkpoint_path = os.path.join(
            run_dir, os.path.basename(self.checkpoint_path))
        return True

    def _bind_slots(self, names):
        """Hand the optimizer the slots of the parameters `names` (in the
        train step's order), zeros where there are none yet."""
        params = dict(self.model.named_parameters())
        for s in self.tx.SLOTS:
            slot = self.slots.setdefault(s, {})
            for n in names:
                if n not in slot:
                    slot[n] = torch.zeros_like(params[n])
        self.tx.state = {s: [self.slots[s][n] for n in names]
                         for s in self.tx.SLOTS}

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
        mesh = self.mesh
        writer = mesh.is_writer   # rank 0 logs and writes
        if not writer:
            def log_fn(*_):
                pass
        check_train_memory(cfg, dev, log_fn)
        # each rank loads its rows of every global batch
        bslice = multihost.local_batch_slice(mesh, cfg.BATCH_SIZE) \
            if multihost.is_multiprocess() else None

        mask = trainable_mask(self.model, layers)
        self._bind_slots([n for n, _ in self.model.named_parameters()
                          if mask[n]])
        # AUGMENT_ON_DEVICE False: the host-parity generator augments and
        # molds on the host, and the steps take its batches as they are
        host = not getattr(cfg, 'AUGMENT_ON_DEVICE', True)
        pre = None if host else loader.make_device_preprocess(
            cfg, train_dataset.camera, dev, train_dataset.name)
        resident = loader.use_resident(train_dataset, cfg)
        train_gen = val_gen = res_train = res_val = None
        if resident:
            res_train, n_train = loader.load_dataset_resident(
                train_dataset, cfg, dev)
            train_step = make_resident_train_step(
                self.model, cfg, self.tx, n_train, mask, pre, dev, mesh)
            if val_dataset is not None:
                res_val, n_val = loader.load_dataset_resident(
                    val_dataset, cfg, dev)
                eval_step = make_resident_eval_step(self.model, cfg, n_val,
                                                    pre, dev, mesh)
            log_fn(f"data: device-resident ({n_train} train"
                   + (f" + {n_val} val" if res_val is not None else "")
                   + " images)")
        else:
            train_step = make_train_step(self.model, cfg, self.tx, mask, pre,
                                         dev, mesh)
            eval_step = make_eval_step(self.model, cfg, pre, dev, mesh)
            train_gen = loader.Prefetcher(loader.data_generator(
                train_dataset, cfg, shuffle=True, batch_size=cfg.BATCH_SIZE,
                seed=cfg.SEED, batch_slice=bslice))
            if val_dataset is not None:
                # an epoch takes VALIDATION_STEPS batches: decoding more
                # ahead only competes with the train loader
                val_gen = loader.Prefetcher(loader.data_generator(
                    val_dataset, cfg, shuffle=True,
                    batch_size=cfg.BATCH_SIZE, seed=cfg.SEED + 1,
                    batch_slice=bslice),
                    depth=max(1, min(8, int(cfg.VALIDATION_STEPS))))

        if writer:
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
        debug_nans = bool(getattr(cfg, 'DEBUG_NANS', False))

        def batch_of(gen):
            batch = next(gen)
            if bslice is not None:
                batch = multihost.shard_batch_local(mesh, batch,
                                                    cfg.BATCH_SIZE, bslice)
            return loader.molded_to_device(batch, dev) if host else batch

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
                        metrics = train_step(batch_of(train_gen), draws)
                    if debug_nans:
                        check_nans(f'train step {self.step}', metrics,
                                   self.model)
                    self.step += 1
                    n += 1
                    sums = metrics if sums is None else \
                        {k: sums[k] + v for k, v in metrics.items()}
                    if log_every and n % log_every == 0 and writer:
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
                            m = eval_step(batch_of(val_gen), draws)
                        if debug_nans:
                            check_nans(f'validation step {vn} of epoch '
                                       f'{epoch}', m)
                        vn += 1
                        vsums = m if vsums is None else \
                            {k: vsums[k] + v for k, v in m.items()}
                means = _means((sums, n, ''), (vsums, vn, 'val_'))
                dt = time.time() - t0
                record = {'epoch': epoch, 'time_s': round(dt, 2),
                          'imgs_per_s': round(n * cfg.BATCH_SIZE / dt, 2),
                          **{k: round(v, 6) for k, v in means.items()}}
                if writer:
                    with open(metrics_path, 'a') as f:
                        f.write(json.dumps(record) + '\n')
                log_fn(f"epoch {epoch}: " + " ".join(
                    f"{k}={v}" for k, v in record.items() if k != 'epoch'))
                self.save_weights(store.checkpoint_epoch(self.checkpoint_path,
                                                         epoch))
                if writer:
                    self._prune_snapshots(
                        int(getattr(cfg, 'CHECKPOINT_KEEP', 0) or 0))
                self.save_state(epoch + 1)
                self.epoch = epoch + 1
                last_means = means
        finally:
            for gen in (train_gen, val_gen):
                if gen is not None:
                    gen.close()
        return last_means

    def save_state(self, epoch: int):
        """`state_latest` of the run dir at `epoch`: the whole weights and
        optimizer slots, gathered from the head shards and written by
        rank 0 (every rank must call it; the ranks meet once it is
        written)."""
        whole = self._whole()
        split = model_split(self.model)
        slots = {s: multihost.fetch_global(v, self.mesh, split)
                 for s, v in self.slots.items()}
        if self.mesh.is_writer:
            store.save_state(
                os.path.join(self.log_dir, 'state_latest' + (
                    ORBAX_SUFFIX if self._orbax else store.WEIGHTS_EXT)),
                whole, self.tx, slots, self.step, epoch)
        if multihost.is_multiprocess():
            torch.distributed.barrier()

    def _prune_snapshots(self, keep: int):
        """Keep the newest `keep` per-epoch snapshots (0: all), ordered by
        the epoch parsed from the name; only names that match the
        snapshot template go (an Orbax snapshot with its directory)."""
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
            if os.path.isdir(old):
                shutil.rmtree(old)
            else:
                os.remove(old)

    # -- introspection --------------------------------------------------------

    def summary(self, log_fn=print) -> dict:
        """Parameter counts per top-level module, and the total."""
        if self.model is None:
            self.initialize()
        counts = {}
        for name, p in self._whole().named_parameters():
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
                                         model=self.model, mesh=self.mesh)
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
