#!/usr/bin/env python3
"""The command line of the port, the counterpart of the repository's
`pose_estimator.py`: the same commands, flags, names and defaults, on
one NVIDIA card or on a (data, model) mesh of ranks, one card each.

    python -m ursonet_torch.pose_estimator <command> --dataset <name> \
        --weights <source> [flags]

Commands:
  train      train on an URSO or SPEED dataset (`UrsoNet.train`; SPEED
             trains on train_no_val and validates on val)
  test       spot-check 10 random test images (axes overlays under
             --out_dir/overlays), one --image, or a --video (an MJPG AVI
             clip, annotated as --out_dir/<name>_annotated.avi)
  evaluate   full test-set metrics and the CSVs (`evaluate.evaluate`;
             SPEED's labelled set is val)
  export     Keras-h5 weights; with --int8 also the calibrated int8
             serving artifact
  submit     the ESA challenge CSV of SPEED's test and real_test frames
             (`submission.test_and_submit`; --dataset speed only)

Weights: a snapshot path or a Keras .h5 file, 'last', 'none' (random
init), 'imagenet' / 'coco' / the released model names ('soyuz_hard',
'dragon_hard', 'speed'), which resolve to .h5 files under --models_dir
(nothing is downloaded), or a run name whose latest snapshot is used.

Everything runs on the card: without CUDA the command fails at once.
Several ranks, one process and one card each (rank r on
cuda:{LOCAL_RANK}):

    python -m torch.distributed.run --nproc_per_node N \
        -m ursonet_torch.pose_estimator train ... --mesh_data D --mesh_model M

trains data-parallel over D rows with the head denses split over M
(`parallel/`); --mesh_data 0 takes world size // M, and D × M must equal
the world size. Rank 0 alone prints and writes (the run dir; the other
ranks' evaluation, overlay and export outputs go to a temporary
directory that is removed). `test --video` reads and writes
Motion-JPEG AVI only (`data/avi.py`), where the JAX package writes mp4v
through cv2. `--host_augment` trains from the host-parity generator
(AUGMENT_ON_DEVICE False).
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import os
import shutil
import sys
import tempfile

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_LOGS_DIR = os.path.join(ROOT_DIR, "models", "logs")
DEFAULT_DATA_DIR = os.path.join(ROOT_DIR, "datasets")
DEFAULT_MODELS_DIR = os.path.join(ROOT_DIR, "models")

ORIENTATION_PARAM_OPTIONS = {'euler_angles', 'quaternion', 'angle_axis'}
RELEASED_MODELS = {'soyuz_hard', 'dragon_hard', 'speed'}

# camera frame sizes (width, height) the image scale applies to
URSO_WH = (1280, 960)
SPEED_WH = (1920, 1200)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("command", metavar="<command>",
                   help="'train', 'test', 'evaluate', 'submit' or "
                        "'export'")
    p.add_argument('--backbone', default='resnet50',
                   help='resnet18/34/50/101, or hrnet_w32 (landmark '
                        'heatmaps)')
    p.add_argument('--dataset', required=True, help='Dataset name')
    p.add_argument('--epochs', default=100, type=int)
    p.add_argument('--image_scale', default=1.0, type=float)
    p.add_argument('--ori_weight', default=1.0, type=float)
    p.add_argument('--loc_weight', default=1.0, type=float)
    p.add_argument('--bottleneck', default=32, type=int)
    p.add_argument('--branch_size', default=1024, type=int)
    p.add_argument('--learn_rate', default=0.001, type=float)
    p.add_argument('--batch_size', default=4, type=int,
                   help='images per card')
    p.add_argument('--rot_aug', action='store_true')
    p.add_argument('--rot_image_aug', action='store_true')
    p.add_argument('--classify_ori', dest='regress_ori',
                   action='store_false')
    p.add_argument('--regress_ori', dest='regress_ori', action='store_true')
    p.set_defaults(regress_ori=False)
    p.add_argument('--classify_loc', dest='regress_loc',
                   action='store_false')
    p.add_argument('--regress_loc', dest='regress_loc', action='store_true')
    p.set_defaults(regress_loc=True)
    p.add_argument('--regress_keypoints', action='store_true',
                   help='experimental; overrides the two above')
    p.add_argument('--sim2real', action='store_true')
    p.add_argument('--sim2real_per_image_order', action='store_true',
                   help='exact per-image op order for the on-device '
                        'sim2real pipeline')
    p.add_argument('--clr', action='store_true')
    p.add_argument('--f16', action='store_true',
                   help='bfloat16 compute (bf16 epilogues under --int8)')
    p.add_argument('--square_image', action='store_true')
    p.add_argument('--ori_param', default='quaternion',
                   help="'quaternion' 'euler_angles' 'angle_axis'")
    p.add_argument('--ori_resolution', default=16, type=int,
                   help='bins per Euler dim (classification)')
    p.add_argument('--weights', required=True)
    p.add_argument('--logs', default=DEFAULT_LOGS_DIR)
    p.add_argument('--image', help='single image to evaluate')
    p.add_argument('--video', help='MJPG AVI clip to annotate (test '
                                   'command)')
    p.add_argument('--data_dir', default=DEFAULT_DATA_DIR)
    p.add_argument('--models_dir', default=DEFAULT_MODELS_DIR)
    p.add_argument('--mesh_data', default=0, type=int,
                   help='data-parallel mesh axis (0 = all ranks)')
    p.add_argument('--mesh_model', default=1, type=int,
                   help='tensor-parallel mesh axis over the heads')
    p.add_argument('--steps_per_epoch', default=None, type=int)
    p.add_argument('--keep_checkpoints', default=0, type=int,
                   help='keep only the newest N per-epoch snapshots '
                        '(0 = keep all, reference behavior)')
    p.add_argument('--host_augment', action='store_true',
                   help='run augmentation per-image on host (parity mode) '
                        'instead of batched on device')
    p.add_argument('--out_dir', default='.',
                   help='where eval CSVs / overlays / artifacts go')
    p.add_argument('--eval_batch', default=1, type=int,
                   help='inference batch size for test/evaluate (the '
                        'reference runs batch 1)')
    p.add_argument('--seed', default=0, type=int)
    p.add_argument('--multimodal', action='store_true',
                   help='fit a quaternion GMM to the orientation PMF per '
                        'image (EM; classification mode only): test '
                        'prints per-mode quats/priors, evaluate reports '
                        'the best-of-2-modes oracle error')
    p.add_argument('--int8', action='store_true',
                   help='serve inference through the calibrated int8 PTQ '
                        'path (test/evaluate; export writes its artifact)')
    p.add_argument('--calib_batches', default=1, type=int,
                   help='with --int8: number of BATCH_SIZE dataset '
                        'batches to calibrate activation scales on '
                        '(running max; more batches = less clipping)')
    p.add_argument('--calib_headroom', default=1.0, type=float,
                   help='with --int8: scale factor on calibrated '
                        'max-abs activation ranges (<1 clips outliers)')
    p.add_argument('--smooth_quant', nargs='?', const=0.5, default=None,
                   type=float, metavar='ALPHA',
                   help='with --int8: SmoothQuant-style per-channel scale '
                        'migration after calibration (models/quant.py '
                        'smooth), ALPHA in [0,1] (default 0.5). ON by '
                        'default (0.5) when a classification head is '
                        'served; a negative ALPHA disables it')
    p.add_argument('--smooth_max_spread', default=None, type=float,
                   metavar='RATIO',
                   help="with --smooth_quant: cap each migration group's "
                        'channel spread (max/min of the migration vector)')
    p.add_argument('--bias_correct', nargs='?', const=1, default=None,
                   type=int, metavar='PASSES',
                   help='with --int8: subtract the per-channel '
                        'quantization bias measured on the calibration '
                        'batch (models/quant.py bias_correct). ON by '
                        'default (1 pass) when a classification head is '
                        'served; 0 disables it')
    p.add_argument('--int8_float_finals', action='store_true',
                   help='with --int8: run the classification final '
                        'denses in float')
    p.add_argument('--set', dest='config_overrides', action='append',
                   default=[], metavar='KEY=VALUE',
                   help='generic Config override applied before '
                        'update(), value parsed as a Python literal '
                        "(fallback: string), e.g. --set REMAT=True")
    return p


def make_config(args):
    """The Config of the parsed flags, as the JAX package's CLI makes it;
    the mesh's default data axis takes the ranks of the world (one
    without a process group)."""
    import torch.distributed as dist

    from ursonet_torch.config import Config

    if args.ori_param not in ORIENTATION_PARAM_OPTIONS:
        raise SystemExit(
            f"--ori_param must be one of {sorted(ORIENTATION_PARAM_OPTIONS)}"
            f", got '{args.ori_param}'")

    config = Config()
    config.ORIENTATION_PARAM = args.ori_param
    config.ORI_BINS_PER_DIM = args.ori_resolution
    config.NAME = args.dataset
    config.EPOCHS = args.epochs
    config.NR_DENSE_LAYERS = 1
    config.LEARNING_RATE = args.learn_rate
    config.BOTTLENECK_WIDTH = args.bottleneck
    config.BRANCH_SIZE = args.branch_size
    config.BACKBONE = args.backbone
    config.ROT_AUG = args.rot_aug
    config.F16 = args.f16
    config.SIM2REAL_AUG = args.sim2real
    config.SIM2REAL_PER_IMAGE_ORDER = args.sim2real_per_image_order
    config.CLR = args.clr
    config.ROT_IMAGE_AUG = args.rot_image_aug
    config.OPTIMIZER = "SGD"
    config.REGRESS_ORI = args.regress_ori
    config.REGRESS_LOC = args.regress_loc
    config.REGRESS_KEYPOINTS = args.regress_keypoints
    config.LOSS_WEIGHTS['loc_loss'] = args.loc_weight
    config.LOSS_WEIGHTS['ori_loss'] = args.ori_weight
    config.SEED = args.seed
    config.QUANT_FLOAT_CLS_FINAL = getattr(args, 'int8_float_finals', False)
    config.AUGMENT_ON_DEVICE = not args.host_augment
    config.IMAGE_RESIZE_MODE = 'square' if args.square_image else 'pad64'

    w0, h0 = SPEED_WH if args.dataset == "speed" else URSO_WH
    config.IMAGE_MAX_DIM = round(w0 * args.image_scale)
    if config.IMAGE_MAX_DIM % 64 > 0:
        raise SystemExit(
            "Scale problem. Image maximum dimension must be dividable "
            "by 2 at least 6 times.")
    h = round(h0 * args.image_scale)
    config.IMAGE_MIN_DIM = h - h % 64 + 64 if h % 64 else h

    config.IMAGES_PER_GPU = args.batch_size if args.command == 'train' \
        else max(1, args.eval_batch)
    world = dist.get_world_size() if dist.is_initialized() else 1
    config.MESH_MODEL = max(1, args.mesh_model)
    if args.mesh_data > 0:
        config.MESH_DATA = args.mesh_data
    else:
        config.MESH_DATA = max(1, world // config.MESH_MODEL)
    if args.steps_per_epoch:
        config.STEPS_PER_EPOCH = args.steps_per_epoch
    if args.keep_checkpoints:
        config.CHECKPOINT_KEEP = args.keep_checkpoints
    for item in getattr(args, 'config_overrides', []) or []:
        key, sep, raw = item.partition('=')
        key = key.strip()
        if not sep or not key:
            raise SystemExit(f"--set expects KEY=VALUE, got '{item}'")
        if not hasattr(config, key):
            raise SystemExit(f"--set: Config has no attribute '{key}'")
        if key != key.upper() or callable(getattr(config, key)):
            raise SystemExit(
                f"--set: '{key}' is not a config knob (knobs are "
                f"UPPER_CASE attributes, not methods)")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        setattr(config, key, value)
    config.update()
    return config


def resolve_and_load_weights(engine, args):
    """The weight source of --weights (reference
    pose_estimator.py:884-913)."""
    from ursonet_torch.checkpoint.h5_import import check_released_config, \
        find_released_file, released_md5_error

    def load_released(key, path):
        err = released_md5_error(key, path)
        if err:
            print(f"warning: {err} (not the file the reference pins)")
        engine.load_weights(path, verbose=True)

    w = args.weights.lower()
    if w == 'none':
        engine.initialize()
        return
    if w == 'last':
        path = engine.find_last()
        engine.load_weights(path, verbose=True)
        return
    if w == 'coco':
        path = os.path.join(args.models_dir, 'mask_rcnn_coco.h5')
        if not os.path.exists(path):
            raise SystemExit(
                f"COCO weights not found at {path}; download "
                "mask_rcnn_coco.h5 there (no network access here).")
        engine.load_weights(path, exclude=[
            "mrcnn_class_logits", "mrcnn_bbox_fc", "mrcnn_bbox",
            "mrcnn_mask"], verbose=True)
        return
    if w == 'imagenet':
        key = f'imagenet_{engine.config.BACKBONE}'
        path = find_released_file(args.models_dir, key)
        if path is None:
            raise SystemExit(
                f"ImageNet weights not found under {args.models_dir}; "
                f"place the Keras {engine.config.BACKBONE} notop weights "
                "there (tools/verify_artifacts.py lists the filenames).")
        load_released(key, path)
        return
    if w in RELEASED_MODELS:
        err = check_released_config(w, engine.config)
        if err:
            raise SystemExit(err)
        key = w if w != 'speed' else \
            f'speed_{engine.config.BOTTLENECK_WIDTH}_' \
            f'{engine.config.ORI_BINS_PER_DIM}'
        path = find_released_file(args.models_dir, key)
        if path is None:
            raise SystemExit(
                f"Released weights for '{w}' not found under "
                f"{args.models_dir} (tools/verify_artifacts.py lists the "
                "expected filenames).")
        load_released(key, path)
        return
    if os.path.exists(args.weights):
        engine.load_weights(args.weights, verbose=True)
        return
    # a run / model name: its latest snapshot
    engine.load_weights(engine.get_last_checkpoint(args.weights),
                        verbose=True)


def load_datasets(args, config, subsets):
    """The subsets `subsets` of --data_dir/--dataset: SPEED's for
    --dataset speed, else URSO's."""
    from ursonet_torch.data.speed import Speed
    from ursonet_torch.data.urso import Urso

    dataset_dir = os.path.join(args.data_dir, args.dataset)
    out = []
    for subset in subsets:
        ds = Speed() if args.dataset == 'speed' else Urso()
        ds.load_dataset(dataset_dir, config, subset)
        out.append(ds)
    return out


def _labelled_subset(args) -> str:
    """The labelled subset that test, evaluate and export read."""
    return 'val' if args.dataset == 'speed' else 'test'


def _padded_ids(ids, n):
    ids = list(ids[:n])
    return ids + [ids[-1]] * (n - len(ids))


def calibrate_int8(engine, args, dataset, config):
    """Eager, deterministic int8 calibration for the inference commands:
    activation scales from the first --calib_batches × BATCH_SIZE images
    of `dataset` (a fixed sample; more batches only widen the scales),
    then the PTQ refinements."""
    if not args.int8 or args.command in ('train', 'export'):
        return
    n_batches = max(1, getattr(args, 'calib_batches', 1) or 1)
    all_ids = list(dataset.image_ids)
    if not all_ids:
        raise SystemExit("--int8: no images available to calibrate on")
    hr = getattr(args, 'calib_headroom', 1.0) or 1.0
    used = []
    for b in range(n_batches):
        ids = all_ids[b * config.BATCH_SIZE:(b + 1) * config.BATCH_SIZE]
        if not ids:
            break
        ids += [ids[-1]] * (config.BATCH_SIZE - len(ids))
        images = [dataset.load_image(i) for i in ids]
        if b == 0:
            engine.quantize(images, headroom=hr)
        else:
            molded, _, _ = engine.mold_inputs(images)
            engine.serving.qmodel.calibrate(
                engine.serving._host_s2d_maybe(molded),
                percentile_headroom=hr)
        used += ids
    print(f"int8: calibrated on {len(set(used))} fixed images "
          f"({n_batches} batch(es), ids {used[0]}..{max(set(used))})")

    def molded_fn():
        molded, _, _ = engine.mold_inputs(
            [dataset.load_image(i) for i in
             _padded_ids(all_ids, config.BATCH_SIZE)])
        return engine.serving._host_s2d_maybe(molded)

    apply_ptq_refinements(engine, args, config, molded_fn)


def apply_ptq_refinements(engine, args, config, molded_fn):
    """SmoothQuant migration and bias correction on the calibrated
    model: on by default (alpha 0.5, one pass) when a classification
    head is served, off for regression heads; explicit flags win (a
    negative ALPHA, PASSES=0 disable)."""
    qmodel = engine.serving.qmodel
    classification = not (config.REGRESS_ORI and config.REGRESS_LOC)
    alpha = getattr(args, 'smooth_quant', None)
    passes = getattr(args, 'bias_correct', None)
    if classification:
        alpha = 0.5 if alpha is None else alpha
        passes = 1 if passes is None else passes
    if alpha is not None and alpha >= 0:
        cap = getattr(args, 'smooth_max_spread', None)
        report = qmodel.smooth(alpha, max_spread=cap)
        worst = max(report.values()) if report else 1.0
        print(f"int8: SmoothQuant migration applied (alpha={alpha}, "
              f"cap={cap}, {len(report)} groups, worst channel spread "
              f"{worst:.1f}x)")
    passes = passes or 0
    if passes:
        qmodel.bias_correct(molded_fn(), passes=passes)
        print(f"int8: bias correction applied ({passes} pass(es))")


def _export(engine, args, config):
    """Keras-h5 weights and, with --int8, the calibrated int8 artifact."""
    from ursonet_torch.checkpoint.h5_import import save_keras_h5
    from ursonet_torch.checkpoint.quant_store import save_quantized

    if engine.model is None:
        engine.initialize()
    os.makedirs(args.out_dir, exist_ok=True)
    h5_path = os.path.join(args.out_dir, f'{config.NAME}_weights.h5')
    save_keras_h5(h5_path, engine.whole_state_dict())
    print(f"Keras-h5 weights written to {h5_path}")
    if args.int8:
        subset = _labelled_subset(args)
        (dataset,) = load_datasets(args, config, (subset,))
        if not len(dataset.image_ids):
            raise SystemExit(f"export --int8: no images in the '{subset}' "
                             "subset to calibrate on")
        images = [dataset.load_image(i) for i in
                  _padded_ids(list(dataset.image_ids), config.BATCH_SIZE)]
        qmodel = engine.quantize(images)
        molded, _, _ = engine.mold_inputs(images)
        apply_ptq_refinements(
            engine, args, config,
            lambda: engine.serving._host_s2d_maybe(molded))
        q_path = os.path.join(args.out_dir, f'{config.NAME}_int8.msgpack')
        save_quantized(q_path, qmodel)
        print(f"int8 serving artifact written to {q_path}")


def _test_image(engine, args, config, dataset):
    import numpy as np

    from ursonet_torch import evaluate
    from ursonet_torch.data.dataset import load_image_rgb
    from ursonet_torch.ops import viz

    image = load_image_rgb(args.image)
    outputs = engine.detect([image] * config.BATCH_SIZE)
    raw = {k: np.stack([outputs[0][k]]) for k in outputs[0]}
    locs, qs = evaluate.decode_dataset_results(raw, config, dataset)
    print(f"loc: {locs[0]}  quaternion (scalar-last): {qs[0]}")
    os.makedirs(args.out_dir, exist_ok=True)
    out_png = os.path.join(args.out_dir, 'single_image_pose.png')
    viz.save_axes_overlay(
        image, dataset.camera.K, locs[0], qs[0], path=out_png,
        frame='camera' if args.dataset == 'speed' else 'unreal')
    print(f"overlay saved to {out_png}")


def main(argv=None, device='cuda'):
    """Run one command; returns the exit code. `device` is the card
    ('cuda') unless a caller asks for the CPU. Under
    `torch.distributed.run` (its environment) the process joins the
    world first, on cuda:{LOCAL_RANK} (gloo ranks on the CPU for
    device='cpu'), and leaves it at the end; rank 0 alone prints."""
    import torch.distributed as dist

    from ursonet_torch.parallel import multihost

    args = build_parser().parse_args(argv)
    # a world this call forms is also left by it
    joined = not dist.is_initialized() and multihost.initialize(
        device=device)
    dev = multihost.rank_device(device)
    scratch = None
    try:
        with contextlib.ExitStack() as stack:
            if multihost.process_index() != 0:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, 'w'))))
                scratch = tempfile.mkdtemp(prefix='ursonet_rank_')
                args.out_dir = scratch
            return _run(args, dev)
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
        if joined:
            multihost.shutdown()


def _run(args, dev):
    from ursonet_torch import evaluate
    from ursonet_torch.engine import UrsoNet

    print("Command: ", args.command)
    print("Dataset: ", args.dataset)
    print("Logs: ", args.logs)
    if args.command not in ('train', 'test', 'evaluate', 'export',
                            'submit'):
        print("wrong command")
        return 2

    config = make_config(args)
    config.display()

    mode = 'training' if args.command == 'train' else 'inference'
    engine = UrsoNet(mode, config, args.logs, device=dev)
    resolve_and_load_weights(engine, args)
    if args.int8 and args.command == 'train':
        raise SystemExit("--int8 is an inference-serving flag; "
                         "training runs bf16/f32")
    if args.multimodal and config.REGRESS_ORI:
        raise SystemExit("--multimodal requires orientation "
                         "soft-classification (drop --regress_ori)")

    if args.command == 'export':
        _export(engine, args, config)
    elif args.command == 'train':
        train_ds, val_ds = load_datasets(
            args, config, ('train_no_val', 'val') if args.dataset == 'speed'
            else ('train', 'val'))
        n = len(train_ds.image_ids)
        if args.steps_per_epoch is None:
            # the reference's clamp; an explicit --steps_per_epoch wins
            config.STEPS_PER_EPOCH = min(config.STEPS_PER_EPOCH,
                                         max(1, n // config.BATCH_SIZE))
        engine.train(train_ds, val_ds, config.LEARNING_RATE,
                     epochs=config.EPOCHS, layers='all')
    elif args.command == 'test':
        (dataset,) = load_datasets(args, config, (_labelled_subset(args),))
        calibrate_int8(engine, args, dataset, config)
        if args.image:
            _test_image(engine, args, config, dataset)
        elif args.video:
            from ursonet_torch.video import detect_video
            os.makedirs(args.out_dir, exist_ok=True)
            detect_video(engine, dataset, args.video,
                         out_path=os.path.join(
                             args.out_dir, os.path.basename(args.video)
                             + '_annotated.avi'))
        else:
            evaluate.detect_dataset(
                engine, dataset, 10,
                out_dir=os.path.join(args.out_dir, 'overlays'),
                multimodal=args.multimodal)
    elif args.command == 'evaluate':
        (dataset,) = load_datasets(args, config, (_labelled_subset(args),))
        calibrate_int8(engine, args, dataset, config)
        evaluate.evaluate(engine, dataset, out_dir=args.out_dir,
                          multimodal=args.multimodal)
    else:
        from ursonet_torch.submission import test_and_submit
        if args.dataset != 'speed':
            raise SystemExit("submit requires --dataset speed")
        real_ds, virtual_ds = load_datasets(args, config,
                                            ('real_test', 'test'))
        calibrate_int8(engine, args, virtual_ds, config)
        test_and_submit(engine, virtual_ds, real_ds, out_dir=args.out_dir)
    return 0


if __name__ == '__main__':
    sys.exit(main())
