"""Operations of HRNet-W32 with its heatmap head, per conv, from the
shapes alone (the landmark configuration's counterpart of `count.py`).

`layers(h, w, k, c)` lists every conv of the model at an input of h x w
pixels (multiples of 32), in graph order, with its shapes and its
multiply-adds per image: the stem, stage 1's bottlenecks, the
transitions, each module's basic blocks and fusion convs, the 1x1 head
to k heatmaps; c is the width of branch 0 (32). `params(k, c)` counts the
parameters (conv kernels, batch-norm scales and shifts, the head's
bias). `train_flops(h, w, k)` gives a train step's float operations per
image: 'forward' (2 x macs of every conv) and 'matmul', the forward with
the weight gradient of every conv and the input gradient of every conv
but the first, whose input needs none. `conv_outputs(h, w, k)` counts the
elements every conv writes for one image, and `fusion_sums(h, w)` the
elements the fusions add.
"""

from __future__ import annotations

from typing import Dict, List


STAGES = ((1, 2), (4, 3), (3, 4))      # (modules, branches) of stages 2-4
BLOCKS = 4                              # basic blocks a branch a module
STAGE1 = 4                              # bottlenecks of stage 1


def layers(h: int, w: int, k: int = 11, c: int = 32) -> List[dict]:
    """Every conv: name, input h, w, ci, output h, w, co, kernel size,
    stride, macs per image."""
    out = []

    def conv(name, hi, wi, ci, co, ks, s=1):
        ho, wo = hi // s, wi // s
        out.append(dict(name=name, h=hi, w=wi, c=ci, ho=ho, wo=wo, co=co,
                        k=ks, stride=s, macs=ho * wo * co * ks * ks * ci))

    conv('conv1', h, w, 3, 64, 3, 2)
    conv('conv2', h // 2, w // 2, 64, 64, 3, 2)
    h4, w4 = h // 4, w // 4
    cin = 64
    for b in range(STAGE1):
        p = f'layer1.{b}'
        conv(p + '.conv1', h4, w4, cin, 64, 1)
        conv(p + '.conv2', h4, w4, 64, 64, 3)
        conv(p + '.conv3', h4, w4, 64, 256, 1)
        if b == 0:
            conv(p + '.downsample', h4, w4, cin, 256, 1)
        cin = 256
    widths = [c << i for i in range(4)]
    res = [(h4 >> i, w4 >> i) for i in range(4)]
    conv('transition1.0', h4, w4, 256, widths[0], 3)
    conv('transition1.1', h4, w4, 256, widths[1], 3, 2)
    for s, (modules, n) in enumerate(STAGES):
        if s:
            hi, wi = res[n - 2]
            conv(f'transition{s + 1}.{n - 1}', hi, wi, widths[n - 2],
                 widths[n - 1], 3, 2)
        for m in range(modules):
            p = f'stage{s + 2}.{m}'
            for i in range(n):
                hi, wi = res[i]
                for b in range(BLOCKS):
                    for j in (1, 2):
                        conv(f'{p}.branches.{i}.{b}.conv{j}', hi, wi,
                             widths[i], widths[i], 3)
            last = s == len(STAGES) - 1 and m == modules - 1
            for i in range(1 if last else n):
                for j in range(n):
                    hj, wj = res[j]
                    if j > i:
                        conv(f'{p}.fuse_layers.{i}.{j}', hj, wj, widths[j],
                             widths[i], 1)
                    for t in range(i - j):
                        co = widths[i] if t == i - j - 1 else widths[j]
                        conv(f'{p}.fuse_layers.{i}.{j}.{t}', hj >> t,
                             wj >> t, widths[j], co, 3, 2)
    conv('final_layer', h4, w4, widths[0], k, 1)
    return out


def params(k: int = 11, c: int = 32) -> int:
    """Parameters: every conv kernel and its batch norm's scale and shift
    (the head: its kernel and bias, no batch norm)."""
    n = 0
    for l in layers(32, 32, k, c):
        n += l['co'] * l['c'] * l['k'] ** 2
        n += l['co'] if l['name'] == 'final_layer' else 2 * l['co']
    return n


def train_flops(h: int, w: int, k: int = 11) -> Dict[str, float]:
    """Float operations of a train step, an image (module docstring)."""
    ls = layers(h, w, k)
    fwd = sum(2.0 * l['macs'] for l in ls)
    return {'forward': fwd, 'matmul': 3.0 * fwd - 2.0 * ls[0]['macs']}


def conv_outputs(h: int, w: int, k: int = 11) -> int:
    return sum(l['ho'] * l['wo'] * l['co'] for l in layers(h, w, k))


def fusion_sums(h: int, w: int, c: int = 32) -> int:
    """Elements the fusions add for one image: each output branch i of a
    module takes n − 1 additions of its own size."""
    res = [(h // 4 >> i) * (w // 4 >> i) * (c << i) for i in range(4)]
    total = 0
    for s, (modules, n) in enumerate(STAGES):
        for m in range(modules):
            last = s == len(STAGES) - 1 and m == modules - 1
            total += sum(res[i] * (n - 1) for i in range(1 if last else n))
    return total
