"""What the TMA + wgmma route of gemm_s8 and conv_s8 decides on the host
(`ursonet_torch/ops/int8_cuda.py`): the route by shape, the tile width,
the pipeline depth within the shared-memory budget, resident weights, the
split over K, and Python mirrors of the shared-memory swizzles. Pure
Python on the CPU: the kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke
from ursonet_torch.ops import int8_cuda as ic

EPILOGUES = list(ic.EPILOGUES)
SERVED_GEMMS = chip_smoke.gemm_cases(None)          # rows of a served batch
SERVED_CONVS = chip_smoke.conv_cases(128)
HEADS = [c for c in SERVED_GEMMS if c[1][0] == 128]


def _conv_mkn(case):
    b, h, w, c, kh, kw, n, stride, pads = case
    oh, ow = ic.conv_out_hw(h, w, kh, kw, stride, pads)
    return b * oh * ow, kh * kw * c, n


# --------------------------------------------------------------------------
# routes


@pytest.mark.parametrize('name,mkn', SERVED_GEMMS, ids=lambda v: str(v))
def test_every_served_gemm_takes_the_tma_route(name, mkn):
    m, k, n = mkn
    for acc in ic.ACC_DTYPES:
        for ep in EPILOGUES:
            assert ic.gemm_route(m, k, n, ep, acc_dtype=acc) == 'tma'
            plan = ic.hopper_plan(m, k, n, ep, acc_dtype=acc)
            assert plan['grid'] <= ic.SM_COUNT \
                and plan['smem'] <= ic.SMEM_LIMIT


@pytest.mark.parametrize('name,case', SERVED_CONVS, ids=lambda v: str(v))
def test_served_convs_take_the_tma_route_but_the_rgb_stem(name, case):
    b, h, w, c, kh, kw, n, stride, pads = case
    (pt, pb), (pl, pr) = pads
    route = ic.conv_route(c, n, kh * kw,
                          b * (h + pt + pb) * (w + pl + pr) * c)
    assert route == ('ragged' if name.startswith('stem') else 'tma')
    if route == 'tma':
        m, k, n = _conv_mkn(case)
        plan = ic.hopper_plan(m, k, n, 'q8_relu', split=False)
        assert plan['splits'] == 1 and plan['smem'] <= ic.SMEM_LIMIT


@pytest.mark.parametrize('m,k,n,ep,route', [
    (77, 147, 13, 's32', 'ragged'),      # odd K
    (300, 64, 200, 'q8', 'ragged'),      # N not a multiple of 16 for int8
    (300, 64, 200, 'f32', 'tma'),        # ... but 4-byte rows are
    (2000, 96, 64, 'join', 'tma'),
    (1500, 40, 136, 'q8_relu', 'ragged'),
    (128, 10240, 3, 's32', 'ragged'),    # N = 3
    (128, 10240, 4, 's32', 'tma'),
    (1, 16, 16, 'q8_relu', 'tma'),
    (64, 24, 16, 'q8_relu', 'ragged'),   # K % 16
])
def test_gemm_route_by_shape(m, k, n, ep, route):
    assert ic.gemm_route(m, k, n, ep) == route
    assert ic.gemm_route(m, k, n, ep, aligned=False) == 'ragged'


@pytest.mark.parametrize('m,k,n,ep,f32_route,bf16_route', [
    (300, 64, 200, 'f32', 'tma', 'tma'),          # 400-byte bf16 rows
    (300, 64, 100, 'f32', 'tma', 'ragged'),       # 200-byte bf16 rows
    (128, 10240, 4, 'f32_relu', 'tma', 'ragged'),
    (128, 1024, 8, 'f32_relu', 'tma', 'tma'),
    (300, 64, 100, 'q8_relu', 'ragged', 'ragged'),  # int8 either way
    (128, 64, 4, 's32', 'tma', 'tma'),            # s32 either way
])
def test_gemm_route_by_output_bytes_per_mode(m, k, n, ep, f32_route,
                                             bf16_route):
    """f32 and f32_relu write 2-byte bf16 rows in the bf16 mode, so the
    TMA route needs N % 8 == 0 there where the f32 mode needs N % 4."""
    assert ic.OUT_BYTES[torch.bfloat16][ep] == \
        (2 if ep in ('f32', 'f32_relu') else ic.OUT_BYTES[torch.float32][ep])
    assert ic.gemm_route(m, k, n, ep) == f32_route
    assert ic.gemm_route(m, k, n, ep, acc_dtype=torch.bfloat16) == bf16_route
    assert ic.OUT_DTYPES[torch.bfloat16][ep] == (
        torch.bfloat16 if ep in ('f32', 'f32_relu')
        else ic.OUT_DTYPES[torch.float32][ep])


@pytest.mark.parametrize('c,n,taps,numel,route', [
    (3, 64, 49, 10 ** 6, 'ragged'),      # the 7x7 RGB stem
    (16, 16, 9, 10 ** 6, 'tma'),
    (2048, 128, 9, 10 ** 8, 'tma'),
    (64, 24, 9, 10 ** 6, 'ragged'),      # N % 16
    (20, 16, 1, 10 ** 6, 'ragged'),      # C % 16
    (16, 16, 49, 10 ** 6, 'ragged'),     # more taps than the 32-bit mask
    (64, 64, 9, 2 ** 31, 'ragged'),      # offsets past 32 bits
])
def test_conv_route_by_shape(c, n, taps, numel, route):
    assert ic.conv_route(c, n, taps, numel) == route
    assert ic.conv_route(c, n, taps, numel, aligned=False) == 'ragged'


def test_forcing_a_route():
    assert ic._pick_route('gemm_s8', None, 'tma') == 'tma'
    assert ic._pick_route('gemm_s8', None, 'ragged') == 'ragged'
    assert ic._pick_route('gemm_s8', 'ragged', 'tma') == 'ragged'
    assert ic._pick_route('gemm_s8', 'tma', 'tma') == 'tma'
    with pytest.raises(ValueError):
        ic._pick_route('gemm_s8', 'tma', 'ragged')
    with pytest.raises(ValueError):
        ic._pick_route('gemm_s8', 'wgmma', 'tma')


@pytest.mark.parametrize('route', [None, 'tma', 'ragged'])
def test_cpu_tensors_take_the_plain_version_whatever_the_route(route):
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randint(-128, 128, (5, 16)).astype(np.int8))
    b = ic.kernel_layout(rng.randint(-128, 128, (16, 16)).astype(np.int8))
    before = dict(ic.launches)
    assert torch.equal(ic.gemm_s8(a, b, route=route), ic.gemm_s8_torch(a, b))
    x = torch.from_numpy(rng.randint(-128, 128, (1, 4, 4, 16))
                         .astype(np.int8))
    w = ic.kernel_layout(rng.randint(-128, 128, (3, 3, 16, 16))
                         .astype(np.int8))
    pads = ((1, 1), (1, 1))
    assert torch.equal(ic.conv_s8(x, w, 1, pads, route=route),
                       ic.conv_s8_torch(x, w, 1, pads))
    assert ic.launches == before


# --------------------------------------------------------------------------
# tiles, depth, resident weights


@pytest.mark.parametrize('m,n,ep,bn', [
    (2621440, 256, 'join', 256), (2621440, 256, 'q8_relu', 256),
    (2621440, 256, 'f32', 128),          # 4-byte outputs stop at 128
    (2621440, 64, 'q8_relu', 64), (655360, 128, 'q8_relu', 128),
    (128, 1024, 'q8_relu', 64),          # few rows: the narrowest tiles
    (128, 13824, 'f32', 128),            # ... that fit one wave of blocks
    (1024, 1024, 'q8', 64), (1024, 2048, 'q8', 128),
    (40960, 2048, 'join', 256),
    (300, 48, 'q8', 64), (300, 16, 's32', 64)])
def test_tile_width(m, n, ep, bn):
    plan = ic.hopper_plan(m, 256, n, ep)
    assert plan['bn'] == bn
    assert plan['n_tiles'] == -(-n // bn) and plan['m_tiles'] == -(-m // 128)


def test_resident_weights_on_the_served_path():
    """Bt stays in shared memory for every C2 and C3 1x1 but C3 branch1,
    and for the C2 3x3 conv."""
    resident = {name for name, (m, k, n) in SERVED_GEMMS
                if ic.hopper_plan(m, k, n, 'q8_relu')['resident']}
    assert resident == {'C2 2a first', 'C2 2a', 'C2 2c', 'C2 branch1',
                        'C3 2a first', 'C3 2a', 'C3 2c'}
    convs = {name for name, case in SERVED_CONVS if case[3] % 16 == 0
             and ic.hopper_plan(*_conv_mkn(case), 'q8_relu',
                                split=False)['resident']}
    assert convs == {'C2 3x3'}


@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 3_000_000), k16=st.integers(1, 1200),
       n4=st.integers(1, 4000), ep=st.sampled_from(EPILOGUES),
       sms=st.sampled_from([108, 114, 132]),
       acc=st.sampled_from(ic.ACC_DTYPES))
def test_every_plan_fits_shared_memory(m, k16, n4, ep, sms, acc):
    k, n = 16 * k16, 4 * n4
    plan = ic.hopper_plan(m, k, n, ep, sms, acc_dtype=acc)
    ob = ic.OUT_BYTES[acc][ep]
    assert plan['smem'] == ic.tma_smem_bytes(
        plan['bn'], ob, plan['stages'], plan['bufs'], plan['resident'],
        plan['ksteps'], plan['n_tiles']) <= ic.SMEM_LIMIT
    assert plan['bn'] in (64, 128, 256) and (ob == 1 or plan['bn'] <= 128)
    assert 1 <= plan['stages'] <= 4 and 1 <= plan['bufs'] <= 3
    assert plan['ksteps'] == -(-k // 128)
    assert plan['ksteps'] % plan['splits'] == 0
    assert 1 <= plan['grid'] <= sms
    assert plan['grid'] == min(
        plan['m_tiles'] * plan['n_tiles'] * plan['splits'], sms)
    if plan['resident']:
        assert plan['splits'] == 1 and plan['ksteps'] * plan['n_tiles'] \
            * plan['bn'] * 128 <= ic.RESIDENT_LIMIT


@pytest.mark.parametrize('bn,ob', [(64, 1), (128, 1), (256, 1), (64, 4),
                                   (128, 4), (64, 2), (128, 2)])
def test_smem_budget_of_each_tile_configuration(bn, ob):
    """Some depth of _DEPTHS fits the 227 KB of a block for every tile
    configuration with streamed weights; the plan takes the first that
    does."""
    assert ic.SMEM_LIMIT == 227 * 1024
    fits = [d for d in ic._DEPTHS
            if ic.tma_smem_bytes(bn, ob, *d, False, 64, 1) <= ic.SMEM_LIMIT]
    ep = 'q8_relu' if ob == 1 else 'f32'
    acc = torch.bfloat16 if ob == 2 else torch.float32
    assert ic.OUT_BYTES[acc][ep] == ob
    plan = ic.hopper_plan(5000, 64 * 128, bn, ep, acc_dtype=acc)
    assert plan['bn'] == bn and not plan['resident']
    assert (plan['stages'], plan['bufs']) == fits[0]


def test_join_keeps_three_buffers_before_a_third_stage():
    """With streamed 256-wide weights three stages and three buffers do
    not fit: `join` gives up a stage (its residual tile is loaded two
    tiles ahead), the other epilogues a buffer."""
    join = ic.hopper_plan(163840, 256, 1024, 'join')
    other = ic.hopper_plan(163840, 256, 1024, 'q8_relu')
    assert (join['bn'], join['stages'], join['bufs']) == (256, 2, 3)
    assert (other['bn'], other['stages'], other['bufs']) == (256, 3, 2)
    assert not join['resident'] and not other['resident']


# (name, m, k, n, epilogue) of a served batch -> (tile width, stages,
# output buffers, splits, resident weights): the plan the card's times in
# PERF.md were measured under
SERVED_PLANS = [
    (('C2 2a first', 2621440, 64, 64, 'q8_relu'), (64, 4, 3, 1, True)),
    (('C2 2a', 2621440, 256, 64, 'q8_relu'), (64, 4, 3, 1, True)),
    (('C2 2c', 2621440, 64, 256, 'join'), (256, 4, 3, 1, True)),
    (('C2 branch1', 2621440, 64, 256, 'q8'), (256, 4, 3, 1, True)),
    (('C3 2a', 655360, 512, 128, 'q8_relu'), (128, 4, 3, 1, True)),
    (('C3 2c', 655360, 128, 512, 'join'), (256, 3, 3, 1, True)),
    (('C4 2a', 163840, 1024, 256, 'q8_relu'), (256, 3, 2, 1, False)),
    (('C4 2c', 163840, 256, 1024, 'join'), (256, 2, 3, 1, False)),
    (('C4 branch1', 163840, 512, 1024, 'q8'), (256, 3, 2, 1, False)),
    (('C5 2a', 40960, 2048, 512, 'q8_relu'), (256, 3, 2, 1, False)),
    (('C5 2c', 40960, 512, 2048, 'join'), (256, 2, 3, 1, False)),
    (('loc_dense_0', 128, 10240, 1024, 'f32_relu'), (64, 4, 3, 5, False)),
    (('ori_final', 128, 1024, 13824, 'f32'), (128, 4, 1, 1, False)),
]


@pytest.mark.parametrize('shape,want', SERVED_PLANS, ids=lambda v: str(v[0]))
def test_plan_of_each_served_gemm(shape, want):
    name, m, k, n, ep = shape
    assert (name, (m, k, n)) in SERVED_GEMMS
    plan = ic.hopper_plan(m, k, n, ep)
    assert (plan['bn'], plan['stages'], plan['bufs'], plan['splits'],
            plan['resident']) == want


def test_every_depth_of_the_tables_is_one_some_plan_takes():
    """_DEPTHS, _DEPTHS_JOIN and _DEPTHS_JOIN_FLOAT (the joins over a
    bf16 or f32 residual) hold no entry that no shape can reach."""
    taken = {'join': set(), 'other': set(), 'float': set()}
    for ep in EPILOGUES:
        for m in (128, 5000):
            for k in (64, 128, 256, 1024, 4096, 16384):
                for n in (64, 128, 256, 512, 2048):
                    plan = ic.hopper_plan(m, k, n, ep)
                    taken['join' if ep in ic.JOINS else 'other'].add(
                        (plan['stages'], plan['bufs']))
                    for rb in (2, 4) if ep in ic.JOINS else ():
                        plan = ic.hopper_plan(m, k, n, ep, res_bytes=rb)
                        taken['float'].add((plan['stages'], plan['bufs']))
    assert taken['join'] == set(ic._DEPTHS_JOIN)
    assert taken['other'] == set(ic._DEPTHS)
    assert taken['float'] == set(ic._DEPTHS_JOIN_FLOAT)


# --------------------------------------------------------------------------
# split K


@pytest.mark.parametrize('name,mkn', HEADS, ids=lambda v: str(v))
def test_split_k_of_the_head_denses(name, mkn):
    """The head denses have one row tile: K is split where that fills
    more SMs than it costs, in one wave of blocks."""
    m, k, n = mkn
    for ep in ('f32', 'f32_relu', 'q8_relu'):
        plan = ic.hopper_plan(m, k, n, ep)
        tiles = plan['m_tiles'] * plan['n_tiles']
        assert plan['ksteps'] % plan['splits'] == 0
        assert tiles * plan['splits'] <= ic.SM_COUNT
        if tiles < ic.SM_COUNT // 4:            # 10240 -> 1024: 8 tiles
            assert plan['splits'] > 1
            assert tiles * plan['splits'] >= ic.SM_COUNT // 4
        assert not plan['resident'] or plan['splits'] == 1
    assert ic.hopper_plan(m, k, n, 'join')['splits'] == 1


@pytest.mark.parametrize('name,mkn', [c for c in SERVED_GEMMS
                                      if c[1][0] > 1024],
                         ids=lambda v: str(v))
def test_no_split_for_many_rows(name, mkn):
    m, k, n = mkn
    assert all(ic.hopper_plan(m, k, n, ep)['splits'] == 1
               for ep in EPILOGUES)


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 4096), tiles=st.integers(1, 300),
       ksteps=st.integers(1, 200), ep=st.sampled_from(EPILOGUES),
       sms=st.integers(1, 200))
def test_split_k_invariants(m, tiles, ksteps, ep, sms):
    d = ic.split_k(m, tiles, ksteps, ep, sms)
    assert 1 <= d <= ksteps and ksteps % d == 0
    if m > ic.SPLIT_K_MAX_M or ep == 'join' or tiles >= sms:
        assert d == 1
    if d > 1:
        assert tiles * d <= sms
        assert ksteps // d + ic.SPLIT_COST_STAGES * d < ksteps


@settings(max_examples=40, deadline=None)
@given(m=st.integers(1, 40), steps=st.integers(1, 12),
       tail=st.sampled_from([0, 16, 48, 112]), n=st.integers(1, 24),
       ep=st.sampled_from(EPILOGUES), seed=st.integers(0, 2 ** 16))
def test_split_sums_in_plan_order_equal_the_unsplit_product(m, steps, tail, n,
                                                            ep, seed):
    """gemm_s8_torch over each K split (s32 partial sums), summed in split
    order and pushed through the epilogue, is the unsplit result bit for
    bit in every epilogue: what the kernel's last block computes."""
    k = 128 * steps - tail
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8))
    b = ic.kernel_layout(rng.randint(-128, 128, (k, n)).astype(np.int8))
    kw = chip_smoke.epilogue_args(torch.device('cpu'), rng, (m, n), k, ep)
    want = ic.gemm_s8_torch(a, b, ep, **kw)
    for splits in {d for d in range(1, steps + 1) if steps % d == 0}:
        per = steps // splits * 128
        total = torch.zeros((m, n), dtype=torch.int32)
        for s in range(splits):
            total += ic.gemm_s8_torch(a[:, s * per:(s + 1) * per],
                                      b[s * per:(s + 1) * per], 's32')
        got = ic.epilogue_torch(total, ep, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want)


# --------------------------------------------------------------------------
# swizzles


def test_swizzle128_permutes_the_chunks_of_every_row():
    for row in range(64):
        assert sorted(ic.swizzle128(row, c) for c in range(8)) \
            == list(range(8))
        # 8-row groups repeat: tiles are cut at multiples of 8 rows
        assert [ic.swizzle128(row, c) for c in range(8)] \
            == [ic.swizzle128(row % 8, c) for c in range(8)]


@pytest.mark.parametrize('chunk', range(8))
def test_swizzle128_spreads_a_chunk_column_over_the_banks(chunk):
    """The 8 rows of one chunk column (what a wgmma or an ldmatrix reads
    together) land in 8 distinct 16-byte bank groups of the 128-byte bank
    line."""
    groups = {(row * 128 + 16 * ic.swizzle128(row, chunk)) % 128 // 16
              for row in range(8)}
    assert groups == set(range(8))


@pytest.mark.parametrize('inner', [64, 128])
def test_out_box_offset_is_a_permutation_that_keeps_chunks(inner):
    offs = [ic.out_box_offset(r, b, inner) for r in range(64)
            for b in range(inner)]
    assert sorted(offs) == list(range(64 * inner))
    for r in range(64):
        for b in range(0, inner, 16):       # 16-byte chunks stay whole
            base = ic.out_box_offset(r, b, inner)
            assert base % 16 == 0
            assert [ic.out_box_offset(r, b + i, inner)
                    for i in range(16)] == list(range(base, base + 16))
    if inner == 128:
        assert all(ic.out_box_offset(r, 16 * c, 128)
                   == r * 128 + 16 * ic.swizzle128(r, c)
                   for r in range(64) for c in range(8))


@pytest.mark.parametrize('ob,inner', [(1, 64), (1, 128), (4, 128)])
def test_fragment_stores_of_a_warp_hit_distinct_banks(ob, inner):
    """One epilogue store instruction of a warp: lane t writes 2 adjacent
    outputs of row t / 4 at column 8 j + 2 (t % 4). For 1-byte outputs no
    two lanes may share a 4-byte bank unless they share the word; the
    8-byte stores of 4-byte outputs take at least 2 passes over the 32
    banks and may take 4 here."""
    for j in range(inner // (8 * ob)):
        words = []
        for t in range(32):
            col = 8 * j + 2 * (t % 4)
            off = ic.out_box_offset(t // 4, col * ob, inner)
            words += [(off + 4 * i) // 4 for i in range(max(1, 2 * ob // 4))]
        per_bank = {}
        for wd in set(words):
            per_bank.setdefault(wd % 32, set()).add(wd)
        worst = max(len(v) for v in per_bank.values())
        assert worst <= (1 if ob == 1 else 2)
