"""Write tests/data/orbax_fixture.orbax, a small Orbax weights directory
written by the JAX package (`ursonet_tpu/checkpoint/orbax_store.py`,
orbax and tensorstore: zstd level 1, OCDBT) from numpy arrays made from a
seed, for the port's reader to hold against on the CPU and on the card.

    JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py

`fixture_tree()` makes the arrays again with numpy alone: 64 K float32
draws at full precision and 192 K rounded to bfloat16's precision (so
the zstd frames carry Huffman-coded literals and FSE-coded sequences),
int32 and int64 arrays, a run of zeros, small arrays held inline, and an
empty `batch_stats`, in the nesting of a params tree.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

SEED = 20251018
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                    'orbax_fixture.orbax')


def fixture_tree(seed: int = SEED) -> dict:
    """{'params': ..., 'batch_stats': {}} of the fixture."""
    rng = np.random.default_rng(seed)
    full = rng.standard_normal((256, 256)).astype(np.float32)
    coarse = rng.standard_normal((1, 1, 384, 512)).astype(np.float32)
    coarse = (coarse.view(np.uint32) & 0xFFFF0000).view(np.float32)
    return {
        'params': {
            'res2a_branch2b': {'kernel': coarse,
                               'bias': rng.standard_normal(512)
                               .astype(np.float32)},
            'loc_final': {'kernel': full,
                          'bias': np.zeros(4096, np.float32)},
            'counts': {'i32': rng.integers(-2**31, 2**31 - 1, 3000,
                                           dtype=np.int32),
                       'i64': rng.integers(0, 1000, (10, 7),
                                           dtype=np.int64),
                       'scalar': np.asarray(17, np.int32)},
        },
        'batch_stats': {},
    }


def main():
    from ursonet_tpu.checkpoint import orbax_store
    tree = fixture_tree()
    shutil.rmtree(PATH, ignore_errors=True)
    orbax_store.save_weights_dir(PATH, tree['params'], None)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(PATH) for f in fs)
    print(f'{PATH}: {size} bytes')


if __name__ == '__main__':
    main()
