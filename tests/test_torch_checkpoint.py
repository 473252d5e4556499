"""The port's checkpoint codec and int8 artifact writer against the JAX
package's: `checkpoint/msgpack.py::msgpack_serialize` writes flax's
bytes, and `checkpoint/quant_store.py::save_quantized`'s artifact, read
by the JAX package's `load_quantized`, serves the orientation logits bit
for bit against the port's model in both accumulation modes (the other
heads within 1e-3 relative L2, as tests/test_torch_quant.py holds them).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ursonet_tpu.checkpoint import quant_store as jqs
from ursonet_torch.checkpoint import msgpack as tmsgpack
from ursonet_torch.checkpoint.quant_store import save_quantized
from ursonet_torch.engine import UrsoNet
from torch_parity import rel_l2, small_configs

torch.set_num_threads(1)



def _trees_equal(a, b, path=''):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _trees_equal(a[k], b[k], f'{path}/{k}')
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


# --------------------------------------------------------------------------
# artifacts and the codec


@pytest.mark.parametrize('f16', [False, True])
def test_save_quantized_serves_the_same_bits_in_jax(tmp_path, f16):
    """The port's calibrated, smoothed and bias-corrected int8 model saved
    by save_quantized, read back by the JAX package's load_quantized."""
    jcfg, tcfg = small_configs(F16=f16)
    engine = UrsoNet('inference', tcfg, str(tmp_path), device='cpu')
    engine.initialize(seed=5)
    rng = np.random.RandomState(0)
    calib = list(rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8))
    qm = engine.quantize(calib)
    qm.smooth(0.5)
    qm.bias_correct(np.stack(calib), passes=1)
    path = str(tmp_path / 'int8.msgpack')
    save_quantized(path, qm, float_dtype=np.float16)
    jqm = jqs.load_quantized(path, jcfg)
    assert jqm.act_scales == {k: np.float32(v) for k, v in
                              qm.act_scales.items()}
    x = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    want = {k: np.asarray(v) for k, v in jqm(jnp.asarray(x)).items()}
    got = engine.predict_molded(x)
    np.testing.assert_array_equal(got['ori'].numpy(), want['ori'])
    assert rel_l2(got['loc'].numpy(), want['loc']) <= 1e-3
    with pytest.raises(ValueError, match='calibrate'):
        qm.act_scales, saved = None, qm.act_scales
        save_quantized(path, qm)


def test_msgpack_serialize_writes_flax_bytes(monkeypatch):
    from flax import serialization
    tree = {'i': [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 40, -1, -32,
                  -33, -128, -129, -200, -70000, -2 ** 40],
            'f': 1.5, 's': 'x' * 40, 'n': None, 't': True, 'u': False,
            'b': b'\x00\x01', 'big': 'y' * 70000, 'bb': b'z' * 300,
            'arr': np.arange(12, dtype=np.int16).reshape(3, 4),
            'f16': np.ones((2,), np.float16), 'sc': np.float32(2.5),
            'sc64': np.float64(0.1), 'i32': np.asarray(7, np.int32),
            'u8': np.arange(1, dtype=np.uint8), 'bool': np.ones(3, bool),
            'list': list(range(20)), 'm': {str(i): i for i in range(20)},
            'nested': {'z': {'b': np.zeros((0, 3), np.float32)}, 'a': 1}}
    assert tmsgpack.msgpack_serialize(tree) == \
        serialization.msgpack_serialize(tree)
    _trees_equal(tmsgpack.msgpack_restore(tmsgpack.msgpack_serialize(
        {'a': np.arange(5.0), 'b': {'c': np.ones((2, 2), np.float32)}})),
        {'a': np.arange(5.0), 'b': {'c': np.ones((2, 2), np.float32)}})
    # arrays above the chunk size are split as flax splits them
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 24)
    monkeypatch.setattr(tmsgpack, 'MAX_CHUNK_SIZE', 24)
    tree = {'w': np.arange(20, dtype=np.float32), 's': np.arange(3.0)}
    data = tmsgpack.msgpack_serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    _trees_equal(tmsgpack.msgpack_restore(data), tree)
    with pytest.raises(TypeError):
        tmsgpack.msgpack_serialize({'x': object()})
