#!/usr/bin/env python3
"""Dataset splitters, the twin of the repository's `split_dataset.py`
without pandas or PIL: the same files from the same seed.

    python -m ursonet_torch.split_dataset --dataset_dir D [--speed]
        [--test_percentage 10] [--val_percentage 10] [--seed S]

URSO (`split_urso`): shuffles the `N_rgb.png` frames and the rows of
`gt.csv` into test / val / train percentage splits, writing
`{subset}_poses_gt.csv` (gt.csv's columns, as pandas writes them) and
`{subset}_images.csv` (`<id>_rgb.png` a line). SPEED (`split_speed`):
shuffles `train.json` into `train_no_val.json` and `val.json`;
`merge_speed` concatenates two annotation files; `average_images` is the
mean pixel of a directory's frames (PNG or JPEG, `data/dataset.py`).
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import random
import re

import numpy as np

from ursonet_torch.data.dataset import load_image_rgb


_POW10 = [float(f'1e{i}') for i in range(309)]
_NUMBER = re.compile(r'\s*[+-]?(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*\Z')


def _pandas_float(text: str) -> float:
    """A decimal string as pandas' default C reader converts it
    (precise_xstrtod): up to 17 significant digits accumulated in
    doubles, then one multiply or divide by a power of ten. It is not
    always the nearest double, and the split files carry its digits."""
    m = _NUMBER.match(text)
    if not m or not (m.group(1) or m.group(2)):
        raise ValueError(f'not a number: {text!r}')
    number, exponent, digits = 0.0, 0, 0
    for c in m.group(1):
        if digits < 17:
            number = number * 10.0 + (ord(c) - 48)
            digits += 1
        else:
            exponent += 1
    for c in (m.group(2) or '')[:max(0, 17 - digits)]:
        number = number * 10.0 + (ord(c) - 48)
        digits += 1
        exponent -= 1
    if text.strip().startswith('-'):
        number = -number
    if m.group(3):
        exponent += int(m.group(3))
    if exponent > 308:
        return float('inf') if number > 0 else float('-inf')
    if exponent >= 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _parse_column(values):
    """A column of CSV text as pandas' reader types it: int64 if every
    field is an integer, else float64 if every field is a number or
    empty (NaN), else the text."""
    try:
        return np.array([int(v) for v in values], np.int64)
    except ValueError:
        pass
    try:
        return np.array([_pandas_float(v) if v != '' else np.nan
                         for v in values], np.float64)
    except ValueError:
        return np.array(values, object)


def _column_text(col):
    """A column as DataFrame.to_csv writes it: numbers in numpy's
    shortest round-trip form, NaN as an empty field."""
    if col.dtype.kind == 'f':
        return np.where(np.isnan(col), '', col.astype(str)).tolist()
    return [str(v) for v in col]


def read_table(path: str):
    """(header, [column arrays]) of a CSV with a header row."""
    with open(path, newline='') as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    cols = [_parse_column([r[j] for r in body]) for j in range(len(header))]
    return header, cols


def write_table(path: str, header, cols, rows) -> None:
    """The rows `rows` (indices) of a table read by `read_table`, as
    `DataFrame.loc[rows].to_csv(path, index=False)` writes them."""
    texts = [_column_text(c[np.asarray(rows, np.int64)]) for c in cols]
    with open(path, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow(header)
        for i in range(len(rows)):
            w.writerow([t[i] for t in texts])


def split_urso(dataset_dir: str, test_percentage: int = 10,
               val_percentage: int = 10, seed=None):
    rgb_list = glob.glob(os.path.join(dataset_dir, '*rgb.png'))
    nr_images = len(rgb_list)
    header, cols = read_table(os.path.join(dataset_dir, 'gt.csv'))
    n_poses = len(cols[0]) if cols else 0
    if nr_images != n_poses:
        raise ValueError(f"{nr_images} images vs {n_poses} poses")

    rng = random.Random(seed)
    shuffle_ids = list(range(nr_images))
    rng.shuffle(shuffle_ids)

    n_test = int(nr_images * test_percentage * 0.01 + 0.5)
    n_nontrain = int(nr_images * (test_percentage + val_percentage) * 0.01
                     + 0.5)
    splits = {
        'test': shuffle_ids[0:n_test],
        'val': shuffle_ids[n_test:n_nontrain],
        'train': shuffle_ids[n_nontrain:nr_images],
    }
    for subset, ids in splits.items():
        write_table(os.path.join(dataset_dir, f'{subset}_poses_gt.csv'),
                    header, cols, ids)
        with open(os.path.join(dataset_dir, f'{subset}_images.csv'),
                  'w') as f:
            for i in ids:
                f.write(f"{i}_rgb.png\n")
    return {k: len(v) for k, v in splits.items()}


def split_speed(dataset_dir: str, val_percentage: float = 0.1, seed=None):
    """Split SPEED's train.json into train_no_val.json and val.json;
    `val_percentage` is a fraction, as the reference uses it."""
    with open(os.path.join(dataset_dir, 'train.json')) as f:
        dataset = json.load(f)
    rng = random.Random(seed)
    rng.shuffle(dataset)
    n_val = len(dataset) * val_percentage
    val_set = [a for i, a in enumerate(dataset) if i < n_val]
    train_set = [a for i, a in enumerate(dataset) if i >= n_val]
    with open(os.path.join(dataset_dir, 'train_no_val.json'), 'w+') as f:
        f.write(json.dumps(train_set))
    with open(os.path.join(dataset_dir, 'val.json'), 'w+') as f:
        f.write(json.dumps(val_set))
    return {'train_no_val': len(train_set), 'val': len(val_set)}


def merge_speed(path_1: str, path_2: str, out_path: str):
    """Concatenate two SPEED annotation files."""
    with open(path_1) as f:
        a = json.load(f)
    with open(path_2) as f:
        b = json.load(f)
    with open(out_path, 'w+') as f:
        f.write(json.dumps(a + b))
    return len(a) + len(b)


def average_images(dataset_dir: str, pattern: str = '*rgb.png'):
    """Mean pixel (RGB) of the frames matching `pattern`."""
    paths = glob.glob(os.path.join(dataset_dir, pattern))
    acc = None
    for p in paths:
        img = load_image_rgb(p).astype(np.float64)
        acc = img if acc is None else acc + img
    mean_image = acc / len(paths)
    return mean_image.mean(axis=(0, 1))


def main(argv=None):
    p = argparse.ArgumentParser(description='Split dataset.')
    p.add_argument('--dataset_dir', required=True)
    p.add_argument('--test_percentage', type=int, default=10)
    p.add_argument('--val_percentage', type=int, default=10)
    p.add_argument('--speed', action='store_true',
                   help='split SPEED train.json instead of URSO CSVs')
    p.add_argument('--seed', type=int, default=None)
    args = p.parse_args(argv)
    if args.speed:
        counts = split_speed(args.dataset_dir,
                             args.val_percentage / 100.0, args.seed)
    else:
        counts = split_urso(args.dataset_dir, args.test_percentage,
                            args.val_percentage, args.seed)
    print(counts)


if __name__ == '__main__':
    main()
