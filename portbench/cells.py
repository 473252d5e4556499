"""Finding a cell's files by name.

A cell `<config>.<traffic>` is `workloads/<cell>.json` (its configuration,
traffic mix, chips, why, and the limits of its correctness check); its
configuration is `configs/<config>.json` (the model's keys as run, the
source, what was changed from it and what was assumed) and its traffic
mix `traffic/<traffic>.json` (the parameters the generator of its kind
reads: `kind` names the module of this folder that drives it). A
per-layer metric `<name>` is read by `metrics/<name>.py`, whose
`read(ctx)` returns a number, or None where the run gave it nothing to
read. Which metrics a cell reports comes from `BENCHMARK.json` at the
root of the checkout: the end-to-end metrics whose `workloads` name the
cell (or that have none), and the per-layer metrics whose `workloads`
name it, or, without that key, whose `moves` the cell reports.

Adding a configuration, a cell, a traffic mix or a per-layer metric is
adding its file (and its entry in `BENCHMARK.json`); no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict          # configs/<config>.json
    traffic_name: str
    traffic: dict         # traffic/<traffic>.json
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @property
    def kind(self) -> str:
        return self.traffic['kind']

    @property
    def model(self) -> dict:
        """The model's shapes, as count.py and the references read them."""
        keys = self.config['config']
        return dict(backbone=keys['BACKBONE'],
                    bottleneck_width=keys['BOTTLENECK_WIDTH'],
                    branch_size=keys['BRANCH_SIZE'],
                    nr_dense_layers=keys['NR_DENSE_LAYERS'],
                    regress_keypoints=bool(keys.get('REGRESS_KEYPOINTS')),
                    ori_bins=keys.get('ORI_BINS_PER_DIM', 0),
                    mean_pixel=tuple(self.config['mean_pixel']))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = HERE) -> dict:
    path = root.parent / 'BENCHMARK.json'
    return _json(path) if path.exists() else {'end_to_end': [],
                                              'per_layer': []}


def load_cell(name: str, root: Path = HERE) -> Cell:
    path = root / 'workloads' / f'{name}.json'
    if not path.exists():
        raise KeyError(f"no cell {name!r} (no {path})")
    w = _json(path)
    bench = benchmark(root)
    e2e = [m for m in bench['end_to_end']
           if name in m.get('workloads', [name])]
    names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if (name in m['workloads'] if 'workloads' in m
                     else m['moves'] in names)]
    return Cell(name=name, config_name=w['config'],
                config=_json(root / 'configs' / f"{w['config']}.json"),
                traffic_name=w['traffic'],
                traffic=_json(root / 'traffic' / f"{w['traffic']}.json"),
                chips=int(w.get('chips', 1)), limits=dict(w['limits']),
                end_to_end=e2e, per_layer=per_layer, root=root)


def load_reader(metric: str, root: Path = HERE) -> Callable:
    """metrics/<metric>.py's `read`."""
    path = root / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + metric.replace('.', '_').replace('-', '_'),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, ctx) -> Dict[str, dict]:
    """{metric: {'value', 'unit'}} of the cell's per-layer metrics that
    found something to read."""
    out = {}
    for m in cell.per_layer:
        value: Optional[float] = load_reader(m['name'], cell.root)(ctx)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out
