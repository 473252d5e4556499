"""The gather of wgrad_s8's ragged route (`im2col_s8`, csrc/actq.cu
`im2col_kernel`): what its launch plan decides on the host, and a numpy
mirror of the kernel's band walk (the bulk-copied rows, the phase
planes, the 16-byte chunks each block owns, the shifted shared loads,
the byte path across rows, bands and samples, the zero tail) held
against `im2col_torch`. Pure Python on the CPU: the kernel itself runs
only on the card (tests/test_torch_cuda.py, at the same geometries)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ursonet_torch.ops import actq_cuda as aq

SRC = (Path(aq.__file__).resolve().parent.parent / 'csrc' / 'actq.cu') \
    .read_text()

# (n, c, h, w, k, stride, pads): stride 1 and 2, symmetric and one-sided
# pads, C = 1, 3 and 32, N = 1 and 2, output rows that are and are not
# multiples of 16 bytes, ragged kp (N * Ho * Wo not a multiple of 16),
# rows the bulk copy takes (W % 16 == 0) and rows it does not
IM2COL_GEOMETRIES = {
    'stem_like_64': (1, 3, 64, 64, 7, 2, ((3, 3), (3, 3))),
    'stem_like_ragged': (2, 3, 34, 48, 7, 2, ((3, 3), (3, 3))),
    'c1_s1_pad1': (2, 1, 9, 13, 3, 1, ((1, 1), (1, 1))),
    'c32_s2_onesided': (2, 32, 8, 16, 3, 2, ((0, 1), (0, 1))),
    'c3_s1_w32': (1, 3, 12, 32, 3, 1, ((1, 1), (1, 1))),
    'c1_1x1': (1, 1, 5, 7, 1, 1, ((0, 0), (0, 0))),
    'c3_s2_w80': (2, 3, 20, 80, 5, 2, ((2, 2), (2, 2))),
}
# card sizes the plan is mirrored at: one band a block, several, all
SMS = (132, 4, 1)


def plan_for(geo):
    n, c, h, w, k, s, pads = geo
    return aq.wgrad_plan((n, c, h, w), 8, (k, k), s, pads, route='ragged')


def operands(geo, seed=0):
    n, c, h, w = geo[:4]
    rng = np.random.RandomState(seed)
    return rng.randint(-127, 128, (n, c, h, w)).astype(np.int8)


def test_constants_match_the_kernel():
    assert re.search(rf'kThreadsI = {aq.IM2COL_THREADS};', SRC)


def kernel_accepts(plan, ip, aligned=True):
    """The entry point's checks of ursonet_actq_im2col on the plan."""
    s, kw, wo = plan.stride, plan.kw, plan.wo
    return (ip.band > 0 and ip.rows == (ip.band - 1) * s + plan.kh
            and ip.pw % 16 == 0
            and ip.pw >= ((wo - 1 + (kw - 1) // s + 16) // 16 + 1) * 16
            and (ip.raw == 0 or (ip.raw >= ip.rows * plan.w
                                 and plan.w % 16 == 0 and aligned
                                 and ip.raw % 16 == 0))
            and ip.tab >= (ip.band * wo + 15) // 16 + 1
            and ip.smem == ip.raw + ip.rows * s * ip.pw
            + 4 * (plan.kh * kw + ip.tab)
            and plan.kp % 16 == 0
            and 0 <= plan.kp - plan.n * plan.ho * wo < 16)


@pytest.mark.parametrize('sms', SMS)
@pytest.mark.parametrize('name', list(IM2COL_GEOMETRIES))
def test_plan_is_what_the_kernel_takes(name, sms):
    plan = plan_for(IM2COL_GEOMETRIES[name])
    for aligned in (True, False):
        ip = aq.im2col_plan(plan, sms, aligned)
        assert kernel_accepts(plan, ip, aligned)
        assert (ip.raw > 0) == (aligned and plan.w % 16 == 0)
        assert ip.bands == -(-plan.ho // ip.band)
        assert ip.grid == plan.ci * plan.n * ip.bands
        assert ip.smem <= aq.IM2COL_SMEM_CAP


def test_plan_at_config2_stem():
    """Config 2's stem on the H100's 132 SMs: bands of 2 output rows,
    384 blocks (about 3 a SM), 9 staged rows of 640 bytes in one bulk
    copy, two planes of 352 bytes a row."""
    plan = aq.wgrad_plan((1, 3, 512, 640), 64, (7, 7), 2,
                         ((3, 3), (3, 3)), route='ragged')
    ip = aq.im2col_plan(plan, 132)
    assert ip == aq.Im2colPlan(band=2, bands=128, rows=9, pw=352,
                               raw=9 * 640, tab=41,
                               smem=9 * 640 + 9 * 2 * 352 + 4 * (49 + 41),
                               grid=384)
    assert kernel_accepts(plan, ip)


def shift_bytes(v, o):
    """The kernel's shift_bytes: bytes o..o+15 of a 32-byte run."""
    return v[o:o + 16]


def thread_walk(tid, chunks, taps, threads=aq.IM2COL_THREADS):
    """The (tap, chunk) pairs thread `tid` stores, as the kernel's loop
    advances them without a division: i = tid, tid + threads, .. as
    (i // chunks, i % chunks)."""
    if chunks <= 0:
        return []
    tap, c = divmod(tid, chunks)
    step_tap, step_c = divmod(threads, chunks)
    out = []
    while tap < taps:
        if c >= chunks:
            c -= chunks
            tap += 1
            if tap >= taps:
                break
        out.append((tap, c))
        tap, c = tap + step_tap, c + step_c
    return out


@pytest.mark.parametrize('chunks', [1, 2, 7, 40, 41, 255, 256, 257, 600])
def test_thread_walk_is_the_division(chunks):
    taps = 49
    for tid in range(aq.IM2COL_THREADS):
        want = [divmod(i, chunks) for i in
                range(tid, taps * chunks, aq.IM2COL_THREADS)]
        assert thread_walk(tid, chunks, taps) == want


def im2col_mirror(q, plan, ip):
    """P as im2col_kernel writes it, and how many times each byte of P
    was written."""
    n_, c_, h, w = q.shape
    s, kh, kw, pt, pl = plan.stride, plan.kh, plan.kw, plan.pads[0][0], \
        plan.pads[1][0]
    ho, wo, kp, taps = plan.ho, plan.wo, plan.kp, plan.kh * plan.kw
    hw, kvalid = ho * wo, plan.n * ho * wo
    p = np.zeros((c_ * taps, kp), np.int8)
    count = np.zeros((c_ * taps, kp), np.int64)
    for blk in range(ip.grid):
        band, rest = blk % ip.bands, blk // ip.bands
        n, ci = rest % plan.n, rest // plan.n
        oh0, oh1 = band * ip.band, min(band * ip.band + ip.band, ho)
        ih0 = oh0 * s - pt
        rows = (oh1 - oh0 - 1) * s + kh
        assert rows <= ip.rows
        lo, hi = max(ih0, 0), min(ih0 + rows, h)
        # 1. the bulk copy: rows lo..hi-1, contiguous bytes of q[n, ci]
        raw = q[n, ci, lo:hi].reshape(-1) if ip.raw else None
        if ip.raw:
            assert raw.size <= ip.raw and (lo * w) % 16 == 0 \
                and raw.size % 16 == 0
        # 2. the phase planes
        planes = np.zeros(ip.rows * s * ip.pw, np.int8)
        for j in range(rows):
            ih = ih0 + j
            for f in range(s):
                for e in range(ip.pw):
                    iw = e * s + f - pl
                    if 0 <= ih < h and 0 <= iw < w:
                        planes[(j * s + f) * ip.pw + e] = (
                            raw[(ih - lo) * w + iw] if ip.raw
                            else q[n, ci, ih, iw])
        # the tables: each tap's offset into the planes, each chunk's
        # (-1 where it is not one run of one output row of the band)
        k_lo, k_hi = n * hw + oh0 * wo, n * hw + oh1 * wo
        m0 = (k_lo + 15) // 16
        last = n == plan.n - 1 and oh1 == ho
        chunks = (kp // 16 if last else (k_hi + 15) // 16) - m0
        assert 0 <= chunks <= ip.tab
        tap_off = [(t // kw * s + t % kw % s) * ip.pw + t % kw // s
                   for t in range(taps)]
        chunk_off = []
        for c in range(chunks):
            k = (m0 + c) * 16
            oh, ow = divmod(k - n * hw, wo)
            fast = k + 16 <= kvalid and oh < oh1 and ow + 16 <= wo
            chunk_off.append((oh - oh0) * s * s * ip.pw + ow if fast
                             else -1)
        # 3. the chunks that start in the band's columns, each tap, in
        # the kernel's order (thread_walk)
        for tap, c in (tc for t in range(aq.IM2COL_THREADS)
                       for tc in thread_walk(t, chunks, taps)):
            dy, dx = divmod(tap, kw)
            k = (m0 + c) * 16
            out = np.zeros(16, np.int8)
            if chunk_off[c] >= 0:
                oh = (k - n * hw) // wo
                off = chunk_off[c] + tap_off[tap]
                assert off == (((oh - oh0) * s + dy) * s + dx % s) \
                    * ip.pw + (k - n * hw) % wo + dx // s
                base = off & ~15
                assert base + 32 <= ((oh - oh0) * s + dy) * s * ip.pw \
                    + (dx % s + 1) * ip.pw   # inside its plane row
                out = shift_bytes(planes[base:base + 32], off & 15)
            elif k < kvalid:
                for j in range(16):
                    kk = k + j
                    if kk >= kvalid:
                        continue
                    sn, r2 = divmod(kk, hw)
                    oh2, ow2 = divmod(r2, wo)
                    if sn == n and oh0 <= oh2 < oh1:
                        out[j] = planes[(oh2 - oh0) * s * s * ip.pw
                                        + ow2 + tap_off[tap]]
                    else:
                        ih, iw = oh2 * s + dy - pt, ow2 * s + dx - pl
                        if 0 <= ih < h and 0 <= iw < w:
                            out[j] = q[sn, ci, ih, iw]
            row = ci * taps + tap
            p[row, k:k + 16] = out
            count[row, k:k + 16] += 1
    return p, count


@pytest.mark.parametrize('sms', SMS)
@pytest.mark.parametrize('name', list(IM2COL_GEOMETRIES))
def test_band_walk_mirror_matches_plain(name, sms):
    """Every byte of P written exactly once, equal to im2col_torch, with
    and without the bulk copy."""
    geo = IM2COL_GEOMETRIES[name]
    plan = plan_for(geo)
    q = operands(geo, seed=sms)
    want = aq.im2col_torch(torch.from_numpy(q), (plan.kh, plan.kw),
                           plan.stride, plan.pads, plan).numpy()
    for aligned in (True, False):
        ip = aq.im2col_plan(plan, sms, aligned)
        got, count = im2col_mirror(q, plan, ip)
        assert (count == 1).all()
        np.testing.assert_array_equal(got, want)
    assert want.any()


def test_ragged_geometries_take_every_path():
    """The geometries reach the fast path, the byte path and the zero
    tail: output rows not a multiple of 16 bytes, N * Ho * Wo not one."""
    kinds = set()
    for geo in IM2COL_GEOMETRIES.values():
        plan = plan_for(geo)
        kinds.add('ragged_kp' if plan.n * plan.ho * plan.wo % 16 else 'kp')
        kinds.add('rows16' if plan.wo % 16 == 0 else 'rows_ragged')
        kinds.add(f's{plan.stride}')
        kinds.add(f'c{plan.ci}')
        kinds.add(f'n{plan.n}')
    assert {'ragged_kp', 'kp', 'rows16', 'rows_ragged', 's1', 's2', 'c1',
            'c3', 'c32', 'n1', 'n2'} <= kinds
