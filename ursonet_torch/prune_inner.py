"""Structured inner-channel pruning of a trained bottleneck backbone: the
port's counterpart of `tools/prune_inner.py`.

    python -m ursonet_torch.prune_inner IN.msgpack OUT.msgpack --mult 0.5

Makes the reduced-FLOP variant (Config.INNER_WIDTH_MULT) from a full
flagship weights file by channel selection: every bottleneck block's
inner widths (f1: 2a-out / 2b-in, f2: 2b-out / 2c-in) shrink to
`scale_inner(f, mult)` channels; the residual streams, the stem, the
bottleneck layer and the heads stay, so the pruned tree loads into
`build_model(config)` with INNER_WIDTH_MULT = mult and fine-tunes from
there.

Channel importance, for inner channel c of a conv -> BN -> ReLU -> conv
chain:
    imp(c) = ||W_prod[..., c]||_2 * |gamma_c| * ||W_cons[:, :, c, :]||_2
BN statistics and biases are sliced with the channels, so the pruned
network is the exact restriction of the parent to the kept channels.

The weights file is read and written through the port's own msgpack
codec (`checkpoint/msgpack.py`), in the JAX package's layout: either
package's weights file goes in, and either package loads what comes out.
The choice of channels, ties included, the slices and the report are
those of the JAX package's tool.
"""

from __future__ import annotations

import argparse

import numpy as np

from ursonet_torch.checkpoint.msgpack import msgpack_restore, \
    msgpack_serialize
from ursonet_torch.models.resnet import scale_inner


def _importance(w_prod, gamma, w_cons):
    """Per-inner-channel importance of a producer->BN->consumer chain."""
    p = np.sqrt((np.asarray(w_prod, np.float64) ** 2)
                .sum(axis=tuple(range(w_prod.ndim - 1))))
    g = np.abs(np.asarray(gamma, np.float64))
    c = np.sqrt((np.asarray(w_cons, np.float64) ** 2)
                .sum(axis=(0, 1, 3)))
    return p * g * c


def _keep(imp, k):
    """Indices of the k most important channels, in original order."""
    return np.sort(np.argsort(imp)[::-1][:k])


def prune_block(params_blk, stats_blk, prefix, mult, report):
    """Prune one bottleneck block in place. prefix like 'res3a'."""
    s_b = prefix[3:]                      # '3a'

    def conv(tag):
        return params_blk[f'res{s_b}_branch{tag}']

    def bn_p(tag):
        return params_blk[f'bn{s_b}_branch{tag}']['bn']

    def bn_s(tag):
        return stats_blk[f'bn{s_b}_branch{tag}']['bn']

    def slice_chain(prod_tag, cons_tag):
        wp = np.asarray(conv(prod_tag)['kernel'])
        gp = np.asarray(bn_p(prod_tag)['scale'])
        wc = np.asarray(conv(cons_tag)['kernel'])
        k = scale_inner(wp.shape[-1], mult)
        keep = _keep(_importance(wp, gp, wc), k)
        conv(prod_tag)['kernel'] = wp[..., keep]
        if 'bias' in conv(prod_tag):
            conv(prod_tag)['bias'] = \
                np.asarray(conv(prod_tag)['bias'])[keep]
        for leaf in ('scale', 'bias'):
            bn_p(prod_tag)[leaf] = np.asarray(bn_p(prod_tag)[leaf])[keep]
        for leaf in ('mean', 'var'):
            bn_s(prod_tag)[leaf] = np.asarray(bn_s(prod_tag)[leaf])[keep]
        conv(cons_tag)['kernel'] = wc[:, :, keep, :]
        report.append((f'res{s_b}_branch{prod_tag}', wp.shape[-1], k))

    slice_chain('2a', '2b')   # inner space 1 (f1)
    slice_chain('2b', '2c')   # inner space 2 (f2)


def prune_tree(tree, mult):
    """Prune every bottleneck block of a {'params', 'batch_stats'} tree
    in place; returns [(producer conv, channels before, after)]."""
    params_bb = tree['params']['backbone']
    stats_bb = tree['batch_stats']['backbone']
    report = []
    for name in sorted(params_bb):
        blk = params_bb[name]
        if (name.startswith('res') and isinstance(blk, dict)
                and f'res{name[3:]}_branch2a' in blk):
            prune_block(blk, stats_bb[name], name, mult, report)
    if not report:
        raise SystemExit('no bottleneck blocks found — is this a '
                         'resnet50/101 checkpoint?')
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('src')
    ap.add_argument('dst')
    ap.add_argument('--mult', type=float, default=0.5,
                    help='INNER_WIDTH_MULT of the target architecture')
    args = ap.parse_args(argv)

    with open(args.src, 'rb') as f:
        tree = msgpack_restore(f.read())
    report = prune_tree(tree, args.mult)
    with open(args.dst, 'wb') as f:
        f.write(msgpack_serialize(tree))
    total_in = sum(r[1] for r in report)
    total_out = sum(r[2] for r in report)
    print(f'pruned {len(report)} inner channel spaces: '
          f'{total_in} -> {total_out} channels (mult {args.mult})')
    for site, a, b in report[:6]:
        print(f'  {site}: {a} -> {b}')
    print(f'wrote {args.dst}')


if __name__ == '__main__':
    main()
