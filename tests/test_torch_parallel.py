"""The port's parallel path (`ursonet_torch/parallel/`) in a 2 x 2 gloo
world of four processes on the CPU, against the port's single-process
step and the JAX package's single-device step.

One world runs every case (`torch_parallel_worker.py`, which imports no
JAX): the DP x TP train step at the tiny configuration of the JAX
package's tests/test_parallel.py, one step at the flagship head widths
(BRANCH_SIZE 1024, 24^3 bins, sim2real and rotation drawn for the global
batch), TRAIN_BN None / True with the global batch's statistics (one row
a rank included), the clip and the L2 term of a split head,
`predict_molded` of 3 images on 2 data rows, `shard_over` int8 serving,
and a rank-0 msgpack and Orbax write of a sharded state that the JAX
package's store reads and a fresh engine of the world resumes.

Tolerances: the JAX package's own DP x TP test (tests/test_parallel.py):
loss within 1e-5 relative, parameters rtol 2e-4 / atol 2e-5 against one
process; against the JAX single-device step 1e-3 in update units
(tests/test_torch_train.py). Running statistics 1e-5. The int8 body and
the checkpoints bit for bit; the float finals of sharded serving 1e-5
relative (their rows are computed apart).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ursonet_tpu.checkpoint import orbax_store as jorbax
from ursonet_tpu.checkpoint import store as jstore
from ursonet_tpu.config import Config as JaxConfig
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_tpu.train import state as jstate
from ursonet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ursonet_tpu.train.step import make_train_step as jax_make_train_step
from ursonet_torch.checkpoint.convert import params_to_jax_layout
from ursonet_torch.checkpoint.store import opt_state_tree
from ursonet_torch.engine import ServingEngine
from ursonet_torch.models.quant import QuantizedModel, flatten_folded
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.parallel.sharding import Gathered
from ursonet_torch.train import losses, optim
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.step import make_train_step
from ursonet_torch.data.loader import make_device_preprocess
import torch_parallel_worker as W

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'torch_parallel_worker.py')
CASES = ('step_tiny', 'step_flagship', 'train_bn', 'variants', 'clip_l2',
         'predict', 'shard_over', 'checkpoint')
BN_CASES = {'none_b4': (None, 2), 'none_b2': (None, 1), 'true_b4': (True, 2)}
VARIANTS = {'uneven_branch': dict(BRANCH_SIZE=5),
            'no_hidden': dict(NR_DENSE_LAYERS=0),
            'two_hidden': dict(NR_DENSE_LAYERS=2),
            'keypoints': dict(REGRESS_KEYPOINTS=True)}


def spawn(d, cases, world=4):
    """Start `cases` in a world of `world` ranks; `join(...)` waits."""
    env = dict(os.environ, OMP_NUM_THREADS='1')
    return [subprocess.Popen([sys.executable, WORKER, str(r), str(world),
                              str(d), *cases], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for r in range(world)]


def join(procs, d, cases, timeout=600):
    """The world's results: {case: [per rank]}."""
    outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outs[r][-4000:]}"
    return {c: [torch.load(f'{d}/{c}_r{r}.pt', weights_only=False)
                for r in range(len(procs))] for c in cases}


def jax_tiny_config(**over):
    cfg = JaxConfig()
    for k, v in dict(BACKBONE='resnet18', BOTTLENECK_WIDTH=8, BRANCH_SIZE=16,
                     IMAGE_RESIZE_MODE='square', IMAGE_MAX_DIM=64,
                     IMAGE_MIN_DIM=64, REGRESS_LOC=True, REGRESS_ORI=True,
                     ORIENTATION_PARAM='quaternion', ROT_AUG=False,
                     **over).items():
        setattr(cfg, k, v)
    cfg.update()
    return cfg


def _quats(rng, n):
    q = rng.randn(n, 4)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _molded(rng, n):
    return {'images': (rng.rand(n, 64, 64, 3) * 100).astype(np.float32),
            'gt_loc': (rng.randn(n, 3) + 10.0).astype(np.float32),
            'gt_ori': _quats(rng, n)}


def _one_process(cfg, whole, batch, n_steps, preprocess=False):
    """The port's single-process steps from `whole` (None: the seed's
    weights); (metrics, state_dict)."""
    model = build_model(cfg, device='cpu')
    if whole is not None:
        model.load_state_dict(whole)
    pre = make_device_preprocess(cfg, device='cpu') if preprocess else None
    step = make_train_step(model, cfg, make_optimizer(cfg), preprocess=pre,
                           device='cpu')
    if not preprocess:
        batch = W.molded_batch(batch)
    metrics = [{k: float(v) for k, v in step(
        batch, torch.Generator().manual_seed(100 + i)).items()}
        for i in range(n_steps)]
    return metrics, model.state_dict()


def _rel(a, b):
    return abs(a - b) / abs(b)


def _flat(params):
    leaves = jax.tree_util.tree_leaves_with_path(params)
    return [jax.tree_util.keystr(p) for p, _ in leaves], np.concatenate(
        [np.ravel(np.asarray(v, np.float64)) for _, v in leaves])


def jax_steps(jmodel, tree, batch):
    """The JAX package's single-device steps at the tiny configuration,
    batch 8: [(params, metrics)] after 1 and 2."""
    jcfg = jax_tiny_config(IMAGES_PER_GPU=8)
    tx = jax_make_optimizer(jcfg)
    state = jstate.state_from_params(tree['params'], tree['batch_stats'], tx)
    step = jax_make_train_step(jmodel, jcfg, tx, trainable=jstate.
                               trainable_mask(state.params, 'all'),
                               jit=True)
    out = []
    for _ in range(2):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
        out.append((jax.tree_util.tree_map(np.asarray, state.params),
                    {k: float(v) for k, v in m.items()}))
    return out


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """Inputs written and the world spawned once; the JAX steps run while
    it works. (directory, inputs, results by case, JAX tiny: (initial
    variables, steps))."""
    d = tmp_path_factory.mktemp('world')
    # the port's seeded weights, in the JAX layout for the JAX step
    whole = build_model(W.tiny_config(IMAGES_PER_GPU=8), 'cpu').state_dict()
    tree = params_to_jax_layout(whole)
    batch = _molded(np.random.RandomState(0), 8)
    inp = {}
    inp['step_tiny'] = {'whole': whole, 'batch': batch}

    fcfg = W.flagship_heads_config(IMAGES_PER_GPU=8)
    rng = np.random.RandomState(1)
    inp['step_flagship'] = {
        'whole': None,      # each side builds it from the config's seed
        'batch': {'images_u8': (rng.rand(8, 64, 64, 3) * 255).astype(
                      np.uint8),
                  'location': (rng.randn(8, 3) + [0, 0, 10]).astype(
                      np.float32),
                  'quaternion': _quats(rng, 8),
                  'image_meta': np.zeros((8, fcfg.IMAGE_META_SIZE),
                                         np.float32)}}

    inp['train_bn'] = {'cases': BN_CASES, 'whole': {}, 'batch': {}}
    for i, (key, (train_bn, per)) in enumerate(BN_CASES.items()):
        cfg = W.tiny_config(TRAIN_BN=train_bn, IMAGES_PER_GPU=2 * per)
        gen = torch.Generator().manual_seed(i)
        inp['train_bn']['whole'][key] = build_model(cfg, 'cpu',
                                                    gen).state_dict()
        inp['train_bn']['batch'][key] = _molded(np.random.RandomState(i),
                                                2 * per)

    inp['variants'] = {'cases': VARIANTS, 'whole': {}, 'batch': {}}
    for i, (key, over) in enumerate(VARIANTS.items()):
        cfg = W.tiny_config(IMAGES_PER_GPU=4, **over)
        inp['variants']['whole'][key] = build_model(
            cfg, 'cpu', torch.Generator().manual_seed(10 + i)).state_dict()
        b = _molded(np.random.RandomState(10 + i), 4)
        if over.get('REGRESS_KEYPOINTS'):
            rng = np.random.RandomState(20 + i)
            b = {'images': b['images'], 'gt_loc': b['gt_loc'],
                 'gt_k1': (rng.randn(4, 3) + 10).astype(np.float32),
                 'gt_k2': (rng.randn(4, 3) + 10).astype(np.float32)}
        inp['variants']['batch'][key] = b

    norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(v) for k, v in whole.items()
         if 'running' not in k])))
    inp['clip_l2'] = {'whole': whole, 'clip': norm / 3}
    inp['predict'] = {'whole': whole, 'molded': _molded(
        np.random.RandomState(5), 3)['images']}

    qcfg = W.tiny_config(REGRESS_ORI=False, ORI_BINS_PER_DIM=6)
    qtree = params_to_jax_layout(build_model(qcfg, 'cpu').state_dict())
    inp['shard_over'] = {
        'config': qcfg.to_dict(),
        'flat': flatten_folded(qtree['params'], qtree['batch_stats'], qcfg),
        'images': (np.random.RandomState(6).rand(4, 64, 64, 3)
                   * 255).astype(np.uint8)}

    rng = np.random.RandomState(7)
    inp['checkpoint'] = {
        'optimizer': 'SGD', 'whole': whole,
        'slots': {'velocity': {
            n: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
            for n, v in whole.items() if 'running' not in n}}}
    for case, v in inp.items():
        torch.save(v, d / f'in_{case}.pt')
    procs = spawn(d, CASES)
    try:
        jmodel = jax_build_model(jax_tiny_config(IMAGES_PER_GPU=8))
        jax_tiny = (tree, jax_steps(jmodel, tree, batch))
    finally:
        res = join(procs, d, CASES)
    return d, inp, res, jax_tiny


def test_dp_tp_step_matches_one_process_and_jax(world):
    """(i) The 2 x 2 step, frozen BN, against the port's single-process
    step and the JAX package's single-device step on the same global
    batch; the head denses really are split."""
    _, inp, res, (tree, jsteps) = world
    cfg = W.tiny_config(IMAGES_PER_GPU=8)
    metrics, sd = _one_process(cfg, inp['step_tiny']['whole'],
                               inp['step_tiny']['batch'], 2)
    got_m, got_sd, shapes = res['step_tiny'][0]
    for r in range(4):
        assert res['step_tiny'][r][0] == got_m   # every rank: global loss
    for mo, mw in zip(got_m, metrics):
        for k in mw:
            assert _rel(mo[k], mw[k]) <= 1e-5, k
    for k, v in sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    assert shapes['loc_head.loc_dense_0.weight'] == (8, 8)
    assert shapes['ori_head.ori_q.weight'] == (4, 8)
    assert shapes['ori_head.ori_q.bias'] == (4,)
    # against the JAX step, 1e-3 in update units
    jparams, jm = jsteps[1]
    names_j, wj = _flat(jparams)
    names_t, wt = _flat(params_to_jax_layout(got_sd)['params'])
    assert names_j == names_t
    _, w0 = _flat(tree['params'])
    assert np.linalg.norm(wt - wj) / np.linalg.norm(wj - w0) <= 1e-3
    for k, v in jm.items():
        assert _rel(got_m[1][k], v) <= 1e-5, k


def test_flagship_head_widths_step(world):
    """(ii) One step at the flagship head widths from raw u8 frames (the
    global batch's sim2real and rotation draws, each rank's rows):
    ori_final holds an in-feature shard of 1024 / 2, and the step matches
    one process."""
    _, inp, res, _ = world
    cfg = W.flagship_heads_config(IMAGES_PER_GPU=8)
    metrics, sd = _one_process(cfg, inp['step_flagship']['whole'],
                               inp['step_flagship']['batch'], 1,
                               preprocess=True)
    got_m, got_sd, _ = res['step_flagship'][0]
    for r in range(4):
        shapes = res['step_flagship'][r][2]
        assert shapes['ori_head.ori_final.weight'] == (24 ** 3, 512)
        assert shapes['ori_head.ori_final.bias'] == (24 ** 3,)
        assert shapes['ori_head.ori_dense_0.weight'] == (512, 16)
    for k in metrics[0]:
        assert _rel(got_m[0][k], metrics[0][k]) <= 1e-5, k
    for k, v in sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize('key', list(BN_CASES))
def test_batch_statistics_are_global(world, key):
    """(iii) TRAIN_BN None over 2 data rows (global batch 4, and 2: one
    row a rank) and True (head batch norms on split features): the loss,
    the running statistics and the parameters match one process."""
    _, inp, res, _ = world
    train_bn, per = BN_CASES[key]
    cfg = W.tiny_config(TRAIN_BN=train_bn, IMAGES_PER_GPU=2 * per)
    metrics, sd = _one_process(cfg, inp['train_bn']['whole'][key],
                               inp['train_bn']['batch'][key], 1)
    got_m, got_sd, _ = res['train_bn'][0][key]
    for k in metrics[0]:
        assert _rel(got_m[0][k], metrics[0][k]) <= 1e-5, k
    n_stats = 0
    for k, v in sd.items():
        if 'running' in k:
            n_stats += 1
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            assert not torch.equal(v, inp['train_bn']['whole'][key][k]), k
        else:
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)
    assert n_stats > 0
    if train_bn is True:
        assert res['train_bn'][1][key][2]['loc_head.loc_bn_0.weight'] == (8,)


@pytest.mark.parametrize('key', list(VARIANTS))
def test_head_layouts_step_as_one_process(world, key):
    """Head layouts beyond the flagship's: BRANCH_SIZE 5 over 2 (shards
    of 2 and 3: the JAX package serves widths that do not divide, XLA
    pads), NR_DENSE_LAYERS 0 (the final column-parallel, 3 and 4 outputs
    over 2, gathered) and 2 (the second hidden dense gathers its input),
    the keypoint head (whole k*_final): one step matches one process."""
    _, inp, res, _ = world
    cfg = W.tiny_config(IMAGES_PER_GPU=4, **VARIANTS[key])
    metrics, sd = _one_process(cfg, inp['variants']['whole'][key],
                               inp['variants']['batch'][key], 1)
    got_m, got_sd, _ = res['variants'][0][key]
    for k in metrics[0]:
        assert _rel(got_m[0][k], metrics[0][k]) <= 1e-5, k
    for k, v in sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    shapes = [res['variants'][r][key][2] for r in range(4)]
    if key == 'uneven_branch':
        assert [s['loc_head.loc_dense_0.weight'][0] for s in shapes] == \
            [2, 3, 2, 3]
    if key == 'no_hidden':
        assert [s['loc_head.loc_final.weight'][0] for s in shapes] == \
            [1, 2, 1, 2]
    if key == 'keypoints':
        assert shapes[0]['loc_head.k1_final.weight'] == (3, 16)


def test_clip_and_l2_of_a_split_head(world):
    """(iv) The L2 term and the global-norm clip count a split tensor's
    shards as the whole tensor, and each replicated tensor once."""
    _, inp, res, _ = world
    cfg = W.tiny_config(IMAGES_PER_GPU=2)
    model = build_model(cfg, device='cpu')
    model.load_state_dict(inp['clip_l2']['whole'])
    l2 = float(losses.l2_regularization(model, 0.3).detach())
    grads = [p.detach().clone() for _, p in model.named_parameters()]
    optim._global_norm_clip(grads, inp['clip_l2']['clip'])
    for r in range(4):
        got = res['clip_l2'][r]
        assert 'loc_head.loc_final.weight' in got['split']
        assert _rel(got['l2'], l2) <= 1e-5
        for (n, _), g in zip(model.named_parameters(), grads):
            np.testing.assert_allclose(got['clipped'][n].numpy(), g.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=n)


def test_predict_molded_pads_and_trims(world):
    """(v) 3 images on 2 data rows: padded to 4, each row served, the
    outputs gathered and trimmed to 3, as one process serves them."""
    _, inp, res, _ = world
    cfg = W.tiny_config(IMAGES_PER_GPU=2)
    model = build_model(cfg, device='cpu')
    model.load_state_dict(inp['predict']['whole'])
    want = ServingEngine(cfg, 'cpu', model=model).predict_molded(
        inp['predict']['molded'])
    for r in range(4):
        got = res['predict'][r]
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].shape[0] == 3
            np.testing.assert_allclose(got[k], v.numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=k)


def test_shard_over_serves_each_data_row(world):
    """(vi) int8 serving over 2 data rows: the int8 body (the classified
    orientation) equals a single rank's serving bit for bit, the float
    location final within 1e-5; shard_over(None) reverts."""
    _, inp, res, _ = world
    cfg = W.tiny_config(REGRESS_ORI=False, ORI_BINS_PER_DIM=6)
    qm = QuantizedModel(cfg, inp['shard_over']['flat'], device='cpu')
    qm.calibrate(inp['shard_over']['images'])
    want = {k: v.numpy() for k, v in qm(inp['shard_over']['images']).items()}
    for r in range(4):
        got = res['shard_over'][r]
        for k in want:
            np.testing.assert_array_equal(got['whole'][k], want[k])
            np.testing.assert_array_equal(got['reverted'][k], want[k])
        np.testing.assert_array_equal(got['sharded']['ori'], want['ori'])
        np.testing.assert_allclose(got['sharded']['loc'], want['loc'],
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize('fmt', ['msgpack', 'orbax'])
def test_rank0_checkpoint_is_whole_and_resumes(world, fmt):
    """(vii) Rank 0 writes the whole state of the 2 x 2 world, head
    shards and their velocity gathered, in the JAX layout: the JAX
    package's store reads it bit for bit, and a fresh engine of the world
    resumes it bit for bit, keeping its shards; a whole weight snapshot
    loads by name into a sharded model, an excluded layer keeping its
    weights."""
    _, inp, res, _ = world
    ck = inp['checkpoint']
    got = res['checkpoint'][0][fmt]
    for r in range(4):
        assert res['checkpoint'][r][fmt]['equal']
        assert res['checkpoint'][r][fmt]['by_name']
        assert res['checkpoint'][r][fmt]['counts'] == (3, 7, 2)
    assert res['checkpoint'][3][fmt]['shapes'][
        'ori_head.ori_q.weight'] == (4, 8)
    names = [n for n in ck['whole'] if 'running' not in n]
    assert sorted(os.listdir(got['log_dir'])) == [
        'state_latest.' + fmt]
    path = os.path.join(got['log_dir'], 'state_latest.' + fmt)
    tree = jorbax.load_state_dir(path) if fmt == 'orbax' \
        else jstore.load_state(path)
    want = params_to_jax_layout(ck['whole'])
    cfg = W.tiny_config()
    tx = make_optimizer(cfg)
    tx.count = 3
    want_opt = opt_state_tree(Gathered(ck['whole'], names), tx,
                              ck['slots'])
    for section, ref in (('params', want['params']),
                         ('batch_stats', want['batch_stats']),
                         ('opt_state', want_opt)):
        ref_l = jax.tree_util.tree_leaves_with_path(ref)
        got_l = dict((jax.tree_util.keystr(p), v) for p, v in
                     jax.tree_util.tree_leaves_with_path(tree[section]))
        assert len(ref_l) == len(got_l)
        for p, v in ref_l:
            np.testing.assert_array_equal(np.asarray(got_l[
                jax.tree_util.keystr(p)]), np.asarray(v))
    assert int(tree['step']) == 7 and int(tree['epoch']) == 2
