"""A configuration, a traffic mix, a cell and a per-layer metric are
added as files of their own: the harness finds them by name, and no file
it already has changes."""

from __future__ import annotations

import hashlib
import json
import shutil
import types

import common  # noqa: F401  (import path)
import cells


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob('*') if p.is_file()
            and '__pycache__' not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / 'portbench'
    shutil.copytree(common.PORTBENCH, root,
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    bench = json.loads((common.REPO / 'BENCHMARK.json').read_text())
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    before = _digests(root)

    cfg = json.loads((root / 'configs' / 'urso_r50_flagship.json')
                     .read_text())
    cfg['name'] = 'tiny_r50'
    cfg['config'].update(IMAGE_MIN_DIM=64, IMAGE_MAX_DIM=128)
    (root / 'configs' / 'tiny_r50.json').write_text(json.dumps(cfg))
    traffic = json.loads((root / 'traffic' / 'serve_int8_b128.json')
                         .read_text())
    traffic['batch'] = 2
    (root / 'traffic' / 'serve_b2.json').write_text(json.dumps(traffic))
    (root / 'workloads' / 'tiny_r50.serve_b2.json').write_text(json.dumps(
        {'config': 'tiny_r50', 'traffic': 'serve_b2', 'chips': 1,
         'why': 'a throwaway cell', 'limits': {'answer_gap': 0.5}}))
    (root / 'metrics' / 'serve.batches.py').write_text(
        "def read(ctx):\n    return float(ctx.batches) if "
        "ctx.kind == 'serve' else None\n")
    bench['workloads'].append({'name': 'tiny_r50.serve_b2',
                               'config': 'tiny_r50', 'traffic': 'serve_b2',
                               'chips': 1, 'why': 'a throwaway cell'})
    for m in bench['end_to_end']:
        if 'workloads' in m and 'serve' in m['name']:
            m['workloads'].append('tiny_r50.serve_b2')
    bench['per_layer'].append({'name': 'serve.batches', 'unit': 'batches',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'serving engine',
                               'moves': 'serve_imgs_per_s'})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))

    cell = cells.load_cell('tiny_r50.serve_b2', root)
    assert cell.kind == 'serve' and cell.traffic['batch'] == 2
    assert cell.model['backbone'] == 'resnet50'
    assert {m['name'] for m in cell.end_to_end} >= {
        'serve_imgs_per_s', 'setup_s', 'peak_mem_gib'}
    # the new metric names no cells: it applies where its 'moves' does
    assert 'serve.batches' in {m['name'] for m in cell.per_layer}
    ctx = types.SimpleNamespace(kind='serve', batches=7, trace=None,
                                call_s=[], window_s=0.0)
    got = cells.read_per_layer(cell, ctx)
    assert got['serve.batches'] == {'value': 7.0, 'unit': 'batches'}
    # readers that find nothing to read are left out
    assert 'serve.idle_share' not in got
    # the existing cells still load, and no existing file changed
    assert cells.load_cell(common.SERVE, root).name == common.SERVE
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_metrics_named_in_benchmark_have_readers():
    bench = cells.benchmark()
    for m in bench['per_layer']:
        assert callable(cells.load_reader(m['name']))
    for w in bench['workloads']:
        cell = cells.load_cell(w['name'])
        assert cell.config_name == w['config']
        assert cell.traffic_name == w['traffic']
        assert cell.chips == w['chips']
