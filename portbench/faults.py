"""What can stand in the program's place under the timed path, to show that
`correct` catches it (the tests, and `control.py --fault` on the card at a
cell's size).

Each driver module names its own in a table `FAULTS` {name: factory};
each factory `f(cell)` makes a hook `hook(target, env)` that the
traffic's driver applies to its timed call once set-up has built the
program: serving wraps the served call (batch -> heads), training the
resident step ((data, perm, i, generator) -> (i + 1, metrics)). `env` is
what the driver made from the seed: the float weights, the calibration
images or the dataset, the device, and for training the program's model
and optimizer and a factory of the plain reference.

`control`, in each kind: the plain reference computed one precision
below the configuration's, put in the program's place (int4 where the
configuration serves int8, fp8 products where it trains in bf16); it
has to come out not correct. Serving's faults: `alter_answer` (the first
answer of every head replaced by the second's), `drop_half` (the second
half of a batch's answers replaced by the first half's: half the batch
left out). Training's: `unchanged` (a step that leaves the model's state
as it found it), `half_batch` (the second half of each batch's rows
replaced by the first half's, so the mean runs over half the batch).
"""

from __future__ import annotations

import importlib

import torch


def serve_control(cell):
    tr = cell.traffic

    def hook(serve, env):
        from reference.int8_serve import Int8Reference
        low = Int8Reference(env.weights, cell.model, env.device,
                            acc=env.acc, qmax=7)
        low.prepare(torch.from_numpy(env.calib), tr['smooth_alpha'],
                    tr['bias_correct_passes'])
        served = {}     # the pool's batches, each worked out once

        def control(batch):
            if id(batch) not in served:
                x = torch.from_numpy(batch).to(env.device)
                served[id(batch)] = low.serve(x, rows=len(batch))
            return served[id(batch)]
        return control
    return hook


def alter_answer(cell):
    def hook(serve, env):
        def served(batch):
            out = serve(batch)
            return {k: torch.cat([v[1:2], v[1:]]) for k, v in out.items()}
        return served
    return hook


def drop_half(cell):
    def hook(serve, env):
        def served(batch):
            out = serve(batch)
            half = len(batch) // 2
            return {k: torch.cat([v[:half], v[:len(v) - half]])
                    for k, v in out.items()}
        return served
    return hook


def train_control(cell):
    def hook(step, env):
        ref = env.reference('fp8')
        params = dict(env.model.named_parameters())

        def control(data, perm, i, gen):
            idx = perm.index_select(0, env.positions(i))
            out = ref.step({k: v.index_select(0, idx)
                            for k, v in data.items()}, gen)
            # the program's state as the reference leaves it, so that the
            # harness reads the control where it reads the program
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(ref.params[n])
            env.tx.state = {'velocity': [ref.velocity[n] for n in params]}
            return i + 1, dict(out['parts'], loss=out['loss'])
        return control
    return hook


def unchanged(cell):
    def hook(step, env):
        def stepped(data, perm, i, gen):
            keep = {k: v.detach().clone()
                    for k, v in env.model.state_dict().items()}
            out = step(data, perm, i, gen)
            env.model.load_state_dict(keep)
            return out
        return stepped
    return hook


def half_batch(cell):
    bsz = int(cell.traffic['batch'])

    def hook(step, env):
        def stepped(data, perm, i, gen):
            idx = env.positions(i)
            p = perm.clone()
            p[idx[bsz // 2:]] = perm[idx[:bsz - bsz // 2]]
            return step(data, p, i, gen)
        return stepped
    return hook


def fault(cell, name: str):
    """The hook that puts `name` in `cell`'s timed path, from the `FAULTS`
    table of the cell's driver module."""
    return importlib.import_module(cell.kind).FAULTS[name](cell)
