"""One rank of the gloo worlds that tests/test_torch_parallel.py and
tests/test_torch_multihost.py spawn: `python torch_parallel_worker.py
RANK WORLD DIR CASE...`. It imports no JAX: the parent writes the inputs
(`DIR/in_*.pt`) and holds what the ranks write (`DIR/<case>_r<rank>.pt`)
against the single-process port and the JAX package.

The world forms through a FileStore under DIR (no port to collide on)
and lays out as a 2 x 2 (data, model) mesh, or the mesh that
TORCH_WORKER_MESH names ('2x1': two data ranks); each rank runs on one
CPU thread."""

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ursonet_torch.config import Config  # noqa: E402
from ursonet_torch.parallel import multihost  # noqa: E402
from ursonet_torch.parallel.mesh import make_mesh  # noqa: E402

MESH = tuple(int(v) for v in
             os.environ.get('TORCH_WORKER_MESH', '2x2').split('x'))


def _load(path):
    """An input the parent wrote (numpy arrays inside)."""
    return torch.load(path, weights_only=False)


def tiny_config(**over):
    """The JAX package's tests/test_parallel.py TinyConfig."""
    cfg = Config()
    cfg.BACKBONE = 'resnet18'
    cfg.BOTTLENECK_WIDTH = 8
    cfg.BRANCH_SIZE = 16
    cfg.IMAGE_RESIZE_MODE = 'square'
    cfg.IMAGE_MAX_DIM = cfg.IMAGE_MIN_DIM = 64
    cfg.REGRESS_LOC = True
    cfg.REGRESS_ORI = True
    cfg.ORIENTATION_PARAM = 'quaternion'
    cfg.ROT_AUG = False
    for k, v in over.items():
        setattr(cfg, k, v)
    cfg.update()
    return cfg


def flagship_heads_config(**over):
    """__graft_entry__.py's dry-run shape: ResNet-50, the flagship head
    widths (BRANCH_SIZE 1024, 24^3 orientation bins) at 64 x 64, sim2real
    and rotation augmentation."""
    cfg = Config()
    cfg.BACKBONE = 'resnet50'
    cfg.BOTTLENECK_WIDTH = 16
    cfg.BRANCH_SIZE = 1024
    cfg.IMAGE_RESIZE_MODE = 'square'
    cfg.IMAGE_MIN_DIM = cfg.IMAGE_MAX_DIM = 64
    cfg.REGRESS_LOC = True
    cfg.REGRESS_ORI = False
    cfg.ORI_BINS_PER_DIM = 24
    cfg.SIM2REAL_AUG = True
    cfg.ROT_AUG = True
    for k, v in over.items():
        setattr(cfg, k, v)
    cfg.update()
    return cfg


def molded_batch(batch):
    """numpy molded batch [B,H,W,3] -> the step's tensors."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in batch.items()}
    out['images'] = out['images'].permute(0, 3, 1, 2).contiguous()
    return out


def sharded_model(cfg, mesh, whole):
    """The model of `cfg` with the whole weights `whole`, sharded."""
    from ursonet_torch.models.ursonet import build_model
    from ursonet_torch.parallel.sharding import shard_model
    model = build_model(cfg, device='cpu')
    if whole is not None:
        model.load_state_dict(whole)
    shard_model(model, mesh, cfg)
    if whole is not None:
        assert set(model.state_dict()) == set(whole)
    return model


def whole_params(model, mesh):
    from ursonet_torch.parallel.sharding import gathered
    return gathered(model, mesh).state_dict()


def run_steps(cfg, mesh, inp, n_steps, preprocess=False):
    """n train steps of the sharded model on this rank's rows; returns
    (metrics per step, the whole state_dict after (rank 0 only), this
    rank's shapes)."""
    from ursonet_torch.data.loader import make_device_preprocess
    from ursonet_torch.parallel.sharding import shard_batch
    from ursonet_torch.train.optim import make_optimizer
    from ursonet_torch.train.step import make_train_step
    model = sharded_model(cfg, mesh, inp['whole'])
    pre = make_device_preprocess(cfg, device='cpu') if preprocess else None
    step = make_train_step(model, cfg, make_optimizer(cfg), preprocess=pre,
                           device='cpu', mesh=mesh)
    batch = shard_batch(mesh, inp['batch'])
    if not preprocess:
        batch = molded_batch(batch)
    metrics = []
    for i in range(n_steps):
        gen = torch.Generator().manual_seed(100 + i)
        metrics.append({k: float(v) for k, v in step(batch, gen).items()})
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    whole = whole_params(model, mesh)
    return metrics, whole if mesh.is_writer else None, shapes


def case_step_tiny(mesh, d):
    cfg = tiny_config(IMAGES_PER_GPU=4, MESH_DATA=2, MESH_MODEL=2)
    return run_steps(cfg, mesh, _load(f'{d}/in_step_tiny.pt'), 2)


def case_actq(mesh, d):
    """Two steps under TRAIN_ACT_Q8='wgrad8' over the mesh's data rows."""
    cfg = tiny_config(IMAGES_PER_GPU=8 // MESH[0], MESH_DATA=MESH[0],
                      MESH_MODEL=MESH[1], TRAIN_ACT_Q8='wgrad8')
    return run_steps(cfg, mesh, _load(f'{d}/in_actq.pt'), 2)


def case_step_flagship(mesh, d):
    cfg = flagship_heads_config(IMAGES_PER_GPU=4, MESH_DATA=2,
                                MESH_MODEL=2)
    return run_steps(cfg, mesh, _load(f'{d}/in_step_flagship.pt'), 1,
                     preprocess=True)


def case_train_bn(mesh, d):
    """One step under TRAIN_BN None (global batch 4 and 2: one row a
    rank) and True (head batch norms on sharded features)."""
    inp = _load(f'{d}/in_train_bn.pt')
    out = {}
    for key, (train_bn, per) in inp['cases'].items():
        cfg = tiny_config(TRAIN_BN=train_bn, IMAGES_PER_GPU=per,
                          MESH_DATA=2, MESH_MODEL=2)
        sub = {'whole': inp['whole'][key], 'batch': inp['batch'][key]}
        out[key] = run_steps(cfg, mesh, sub, 1)
    return out


def case_variants(mesh, d):
    """One step of head layouts the flagship does not have: a width that
    does not divide over 'model', no hidden dense (the column-parallel
    final, its output gathered), two hidden denses (the second gathers
    its input), the keypoint head (whole k*_final on the gathered
    hidden activation)."""
    inp = _load(f'{d}/in_variants.pt')
    return {key: run_steps(tiny_config(IMAGES_PER_GPU=2, MESH_DATA=2,
                                       MESH_MODEL=2, **over), mesh,
                           {'whole': inp['whole'][key],
                            'batch': inp['batch'][key]}, 1)
            for key, over in inp['cases'].items()}


def case_clip_l2(mesh, d):
    """The L2 term and the global-norm clip of a sharded model, with the
    parameters as the gradients."""
    from ursonet_torch.parallel.mesh import AXIS_MODEL
    from ursonet_torch.parallel.sharding import gather_state, model_split
    from ursonet_torch.train import losses, optim
    inp = _load(f'{d}/in_clip_l2.pt')
    cfg = tiny_config(IMAGES_PER_GPU=2, MESH_DATA=2, MESH_MODEL=2)
    model = sharded_model(cfg, mesh, inp['whole'])
    split = model_split(model)
    group = mesh.split(AXIS_MODEL)
    l2 = float(losses.l2_regularization(model, 0.3, None, split, group))
    names = [n for n, _ in model.named_parameters()]
    grads = [p.detach().clone() for _, p in model.named_parameters()]
    optim._global_norm_clip(grads, inp['clip'], [n in split for n in names],
                            group)
    clipped = gather_state(dict(zip(names, grads)), mesh, split)
    return {'l2': l2, 'clipped': clipped, 'split': split}


def case_predict(mesh, d):
    """predict_molded of 3 images over 2 data rows (padded, trimmed)."""
    from ursonet_torch.engine import ServingEngine
    inp = _load(f'{d}/in_predict.pt')
    cfg = tiny_config(IMAGES_PER_GPU=2, MESH_DATA=2, MESH_MODEL=2)
    eng = ServingEngine(cfg, 'cpu', model=sharded_model(cfg, mesh,
                                                        inp['whole']),
                        mesh=mesh)
    return {k: v.numpy() for k, v in eng.predict_molded(
        inp['molded']).items()}


def case_shard_over(mesh, d):
    """int8 serving over the 2 data rows against this rank unsharded."""
    from ursonet_torch.models.quant import QuantizedModel
    inp = _load(f'{d}/in_shard_over.pt')
    cfg = Config.from_dict(inp['config'])
    qm = QuantizedModel(cfg, inp['flat'], device='cpu')
    qm.calibrate(inp['images'])
    whole = {k: v.numpy() for k, v in qm(inp['images']).items()}
    sharded = {k: v.numpy()
               for k, v in qm.shard_over(mesh)(inp['images']).items()}
    reverted = {k: v.numpy()
                for k, v in qm.shard_over(None)(inp['images']).items()}
    return {'whole': whole, 'sharded': sharded, 'reverted': reverted}


def case_checkpoint(mesh, d):
    """A rank-0 write of a sharded state with its optimizer slots, in
    both formats, then each resumed by a fresh engine in this world."""
    from ursonet_torch.engine import UrsoNet
    from ursonet_torch.parallel.sharding import model_split, shard_state
    inp = _load(f'{d}/in_checkpoint.pt')
    out = {}
    for fmt in ('msgpack', 'orbax'):
        cfg = tiny_config(IMAGES_PER_GPU=2, MESH_DATA=2, MESH_MODEL=2,
                          CHECKPOINT_FORMAT=fmt, OPTIMIZER=inp['optimizer'])
        eng = UrsoNet('training', cfg, f'{d}/logs_{fmt}', device='cpu')
        eng.initialize()
        split = model_split(eng.model)
        eng.model.load_state_dict(shard_state(inp['whole'], mesh, split))
        names = [n for n, _ in eng.model.named_parameters()]
        eng._bind_slots(names)
        for s in eng.tx.SLOTS:
            shards = shard_state(inp['slots'][s], mesh, split)
            for n in names:
                eng.slots[s][n].copy_(shards[n])
        eng.tx.count, eng.step = 3, 7
        eng.save_state(2)
        back = UrsoNet('training', cfg, f'{d}/elsewhere', device='cpu')
        assert back.resume_state(eng.log_dir)
        # a whole snapshot loaded by name into a sharded model, the
        # location head excluded
        snap = f'{d}/snap_{fmt}.' + fmt
        eng.save_weights(snap)
        other = UrsoNet('training', cfg, f'{d}/other', device='cpu')
        other.initialize(seed=5)
        fresh = other.whole_state_dict()
        other.load_weights(snap, exclude=['loc_.*'])
        loaded = other.whole_state_dict()
        out[fmt] = {
            'log_dir': eng.log_dir,
            'equal': all(torch.equal(a, b) for a, b in zip(
                eng.model.state_dict().values(),
                back.model.state_dict().values())) and all(
                torch.equal(eng.slots[s][n], back.slots[s][n])
                for s in eng.tx.SLOTS for n in names),
            'counts': (back.tx.count, back.step, back.epoch),
            'by_name': all(torch.equal(v, fresh[k] if k.startswith(
                'loc_head.loc_') else inp['whole'][k])
                for k, v in loaded.items()),
            'shapes': {k: tuple(v.shape)
                       for k, v in back.model.state_dict().items()}}
    return out


def case_engine(mesh, d):
    """UrsoNet.train over the mesh from a synthetic dataset, streamed by
    per-rank generators and resident (each rank gathers its rows),
    rank-0 writes; then the whole weights and the means, by key."""
    from ursonet_torch.data.urso import Urso
    from ursonet_torch.engine import UrsoNet
    inp = _load(f'{d}/in_engine.pt')
    out = {}
    for key, conf in inp['configs'].items():
        cfg = Config.from_dict(conf)
        tr, va = Urso(), Urso()
        tr.load_dataset(inp['data'], cfg, 'train')
        va.load_dataset(inp['data'], cfg, 'val')
        eng = UrsoNet('training', cfg, f'{d}/logs_engine_{key}',
                      device='cpu')
        init = whole_params(eng.initialize(), mesh)
        means = eng.train(tr, va, cfg.LEARNING_RATE, epochs=1)
        out[key] = {'init': init, 'means': means,
                    'whole': whole_params(eng.model, mesh),
                    'log_dir': eng.log_dir}
    return out


def case_cli(mesh, d):
    """The port's CLI trains over the 2 x 2 mesh (--mesh_data 2
    --mesh_model 2) in this world."""
    from ursonet_torch import pose_estimator
    inp = _load(f'{d}/in_cli.pt')
    code = pose_estimator.main(inp['argv'], device='cpu')
    return {'code': code}


def main():
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    multihost.initialize(f'file://{d}/store', world, rank, device='cpu')
    mesh = make_mesh(data=MESH[0], model=MESH[1])
    for case in sys.argv[4:]:
        t0 = time.perf_counter()
        torch.save(globals()['case_' + case](mesh, d),
                   f'{d}/{case}_r{rank}.pt')
        print(f"rank {rank} {case}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    multihost.shutdown()


if __name__ == '__main__':
    main()
