"""The kernels of TRAIN_ACT_Q8 (`csrc/actq.cu`), their wrappers, their
launch plans and their plain PyTorch versions:

    plan = wgrad_plan(x.shape, co, kernel_hw, stride, pads)
                                          the route and the layouts of one
                                          conv's saved q and qg (below)
    quant_s8(t, 'x', plan=plan)           x [N,...] f32/bf16 -> (q int8 in
                                          the plan's layout, x's shape
                                          without a plan; scale [N] f32)
    quant_s8(t, 'g', scale, ..., plan=plan)
                                          g [N,Co,Ho,Wo] -> (qgt [Co,Kp]
                                          int8, alpha [alpha_len] f32 = sg)
    quant_s8(t, 'dequant', scale, dtype)  q int8 (plain) -> dtype(q) *
                                          dtype(scale)
    wgrad_s8(q, qgt, kernel_hw, stride, pads, alpha=None, plan=plan)
                                          -> dw [Co,Ci,KH,KW]: int32 sums,
                                          or f32(acc) * alpha with alpha
    im2col_s8(q, plan)                    plain q -> P [Ci*KH*KW, Kp] int8,
                                          the 'ragged' route's gather

The formulas are the JAX package's (`ursonet_tpu/models/actq.py`):
'x' is `_quantize_per_sample` (per-sample max|x|, scale =
max(amax, 1e-12) / 127 computed in x's type, so rounded to bf16 for a
bf16 x, then q = clip(rint(f32(x) / scale), +-127)); 'g' the
output-gradient quantize of `_q8w8_bwd` (G = f32(g) * scale[n], sg =
max(max|G|, 1e-30) / 127 over the whole tensor, qg = clip(rint(G / sg),
+-127)); 'dequant' the copy `q.astype(dt) * scale.astype(dt)` of
`_q8_bwd`; wgrad_s8 `_wgrad_conv` at int32 with its rescale f32(acc) *
sg.

Layouts (`WgradPlan`, chosen from the shapes before any launch). q and
qg are private to ConvQ8, so they are stored as the product reads them:
  * the 'ragged' route (the gather + gemm_s8 of csrc/actq.cu; fewer than
    64 input channels), and every call without a plan: q plain NCHW, qgt [Co, Kp] with column n * Ho * Wo + oh * Wo
    + ow and Kp that count rounded up to 16 (`padded_k`);
  * the 'tma' route (the implicit-GEMM kernel): q viewed as [N, Ci, Hk,
    Wk] rows (the input, or for a 1x1 stride-1 unpadded conv its planes
    cut into rows of Wk), each row kept as KW `copies` of `wph` bytes,
    copy dx's byte j = column j * stride + dx - pl (zero outside the
    row; wph >= Wo a multiple of 16): the column output column j reads
    through kernel column dx, so every patch box starts 16-byte aligned.
    Stride 1 (`cmaj`): the copies are planes, [N, Ci, KW, Hk, wph], and
    a stage of K is 128 consecutive bytes of one; qgt column n * Kps +
    oh * wph + ow, Kps = Hok * wph rounded up to 128. Stride 2 and over
    (row-major): [N, Ci, Hk, KW, wph], one box a row; qgt column n * Kps
    + oh * Wop + ow, Wop 32, 64, 128 (or a multiple of 128), Kps = Hop *
    Wop, Hop a multiple of 128 / Wop. qgt is zero where oh >= Hok or ow >=
    Wok, Kp = N * Kps; q is plain NCHW where that is the same bytes.
`to_layout`, `q_of`, `_qgt` and `qg_of` convert between the plain
tensors and the layouts; the plain versions below compute on the plain
tensors.

'g' takes a process `group`: the max|G| of every rank of the group is
all-reduced (MAX) between the reduction and the quantize, so that
data-parallel ranks quantize with the global batch's sg, as the JAX
package's GSPMD step does. It is then two launches of the quantize
kernel (the reduction alone, the quantize alone); 'x' and 'g' without a
group are one launch each (`quant_plan`: a grid of co-resident blocks,
a grid-wide barrier between the reduction and the quantize, each block's
rows read again after it, from L2 where the call fits there). The amax
slots and the barrier counters live in a per-device workspace that the
kernel leaves zero, so no fill precedes a call. 'dequant' is one launch
a call over persistent blocks (`dequant_plan`: 16-element chunks, an
unaligned head and the tail one element a thread; any N).

wgrad_s8's 'tma' route computes dw[co, r] = sum_k qgt[co, k] * P[r, k]
without writing the patch matrix P: TMA brings qgt's tiles and one tap's
patch tile a stage (a 5-D box over q for each output row of the stage)
into shared memory, wgmma
multiplies, the epilogue f32(acc) * alpha[r] (or the int32 sums) is
applied in registers (`wgrad_tiles`: 128 x 256 or 128 x 128 tiles, K
split over blocks where the tiles do not fill the SMs, each part's int32
sums stored to a per-device workspace and added by the tile's last
block; width and parts chosen by `wgrad_split_cost`).
The 'ragged' route gathers P [Ci*KH*KW, Kp] (`im2col_s8`, one launch
of a block a channel, sample and band of output rows: `im2col_plan`)
and multiplies qgt @ P^T with `gemm_s8` in its 's32' or 'f32' epilogue
(alpha = sg, beta = 0). Sums fit int32 where N * Ho * Wo <=
INT32_SAFE_ACC (the caller's guard, JAX's shape branch).

On a CUDA tensor each wrapper launches its kernels or raises; on a CPU
tensor it runs the plain version (wgrad_s8_torch: a float64
`conv2d_weight`, exact since |acc| < 2^31 < 2^53), in the same layouts.
Counts: each wrapper call that launches on the card adds one to
`launches['quant_s8']` (and `mode_launches[mode]`) or
`launches['wgrad_s8']` (and `route_launches[route]`); each kernel launch
adds one to `kernel_launches` ('quant_x', 'quant_g', 'quant_g_group'
(two a call), 'dequant', 'wgrad_tma', 'im2col' (`im2col_s8`: once a
'ragged' wgrad_s8 call); the 'ragged' route's GEMM counts in
`int8_cuda.launches['gemm_s8']`). Each call appends its
arguments to `calls` when that is a list.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ursonet_torch.ops import cuda_build, int8_cuda

MODES = ("x", "g", "dequant")
ROUTES = ("tma", "ragged")
# Largest contraction whose worst case (every |q| = 127, one sign) fits
# int32: floor((2^31 - 1) / 127^2) (`actq.py::_INT32_SAFE_ACC`).
INT32_SAFE_ACC = (2 ** 31 - 1) // (127 * 127)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# csrc/actq.cu's constants (tests/test_torch_actq_plan.py reads them there)
QUANT_THREADS = 1024         # threads of a quantize block
WGRAD_TILE = 128             # rows (Co) of a tile; its columns: wgrad_bn
WGRAD_STAGE_K = 128          # bytes of K a pipeline stage
WGRAD_MIN_CI = 64            # fewer input channels take the ragged route
WGRAD_MIN_WOP = 32           # a k32 step lies in one row of the B tile
WGRAD_MAX_SPLITS = 64
DEQUANT_THREADS = 256        # threads of a dequant block
DEQUANT_BLOCKS = 8           # its blocks a SM (all resident at once)
DEQUANT_UNROLL = 1           # chunks a thread a pass (loaded at once)
DEQUANT_CHUNK = 16           # elements (q bytes) a chunk
IM2COL_THREADS = 256         # threads of a gather block
# The gather's blocks (`im2col_plan`): about IM2COL_BLOCKS_PER_SM a SM,
# each a band of output rows of one (channel, sample), its shared memory
# at most IM2COL_SMEM_CAP bytes.
IM2COL_BLOCKS_PER_SM = 3
IM2COL_SMEM_CAP = 96 * 1024

# Wrapper calls that launched on the card since the last reset_counts().
launches = {"quant_s8": 0, "wgrad_s8": 0}
mode_launches = {m: 0 for m in MODES}
route_launches = {r: 0 for r in ROUTES}
# Kernel launches, by kernel (a 'g' call under a group launches twice).
kernel_launches = {k: 0 for k in ("quant_x", "quant_g", "quant_g_group",
                                  "dequant", "wgrad_tma", "im2col")}
# None, or a list that each call appends (name, arguments) to:
# quant_s8's mode, shape, dtype and plan, wgrad_s8's geometry and route
# (what chip_smoke.py holds against the plain versions and times at the
# main path's shapes).
calls = None


def reset_counts() -> None:
    for d in (launches, mode_launches, route_launches, kernel_launches):
        for k in d:
            d[k] = 0


def _bind(lib) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ursonet_actq_quant.argtypes = [P, I, I, I, P, P, P, P, P] \
        + [I] * 9 + [L, L] + [I] * 6 + [P]
    lib.ursonet_actq_dequant.argtypes = [P, P, I, L, P, I, L, L, I, P]
    lib.ursonet_actq_im2col.argtypes = [P] + [I] * 18 + [P, P]
    lib.ursonet_actq_wgrad_tma.argtypes = [P] * 6 + [I] * 12 \
        + [L, L, I, I, I, P]
    for fn in (lib.ursonet_actq_quant, lib.ursonet_actq_dequant,
               lib.ursonet_actq_im2col, lib.ursonet_actq_wgrad_tma):
        fn.restype = I
    lib.ursonet_actq_error_string.argtypes = [I]
    lib.ursonet_actq_error_string.restype = ctypes.c_char_p


def _lib():
    return cuda_build.load("actq", _bind)


def _raise_if(rc, lib, name) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ursonet_actq_error_string(rc).decode())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def padded_k(k: int) -> int:
    """The contraction length k rounded up to a multiple of 16."""
    return -(-k // 16) * 16


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _bshape(scale, ndim):
    return scale.view((-1,) + (1,) * (ndim - 1))


# --------------------------------------------------------------------------
# plans


class WgradPlan(NamedTuple):
    """One conv's weight-gradient route and the layouts of its saved q
    and qg (module docstring). (h, w, ho, wo) are the conv's; (hk, wk,
    hok, wok) the view the kernel reads, the same but for a 1x1
    stride-1 unpadded conv on the 'tma' route, whose planes it cuts into
    rows of wk; q's rows hold `copies` blocks of `wph` bytes, planes of
    them where `cmaj`; qgt's output row oh of sample n starts at n * kps
    + oh * wst."""
    route: str
    n: int
    ci: int
    h: int
    w: int
    co: int
    kh: int
    kw: int
    stride: int
    pads: tuple
    ho: int
    wo: int
    hk: int
    wk: int
    hok: int
    wok: int
    copies: int
    wph: int
    cmaj: bool
    wst: int
    kps: int
    kp: int

    @property
    def plain_q(self) -> bool:
        """q is plain NCHW (the same bytes as the layout)."""
        return self.route == "ragged" or (
            self.copies == 1 and self.stride == 1 and self.pads[1][0] == 0
            and self.wph == self.wk)

    @property
    def q_shape(self) -> tuple:
        if self.plain_q:
            return (self.n, self.ci, self.h, self.w)
        if self.cmaj:
            return (self.n, self.ci, self.copies * self.hk, self.wph)
        return (self.n, self.ci, self.hk, self.copies * self.wph)

    @property
    def wseg(self) -> int:
        """Bytes of a q row a stage's box reads (row-major; 128 in a
        plane)."""
        return WGRAD_STAGE_K if self.cmaj else min(self.wst, WGRAD_STAGE_K)

    @property
    def hb(self) -> int:
        """Output rows a stage covers (row-major)."""
        return WGRAD_STAGE_K // self.wseg

    @property
    def segs(self) -> int:
        """Stages an output row takes (row-major: Wop over 128)."""
        return 1 if self.cmaj else self.wst // self.wseg


def _wop(wo: int) -> int:
    if wo <= WGRAD_STAGE_K:
        return max(WGRAD_MIN_WOP, 1 << (wo - 1).bit_length())
    return _round_up(wo, WGRAD_STAGE_K)


def wgrad_route(ci: int) -> str:
    """'tma' for 64 or more input channels, else 'ragged' (a 128-channel
    tile of fewer channels is mostly zeros)."""
    return "tma" if ci >= WGRAD_MIN_CI else "ragged"


@functools.lru_cache(maxsize=4096)
def wgrad_plan(q_shape, co: int, kernel_hw, stride: int, pads,
               route=None) -> WgradPlan:
    """The route (`wgrad_route` from the shapes, or `route` forced: a
    forced 'tma' on shapes it does not take raises) and the layouts of a
    conv of input shape `q_shape` [N, Ci, H, W], `co` outputs, kernel
    `kernel_hw`, `stride`, pads ((pt, pb), (pl, pr))."""
    n, ci, h, w = (int(v) for v in q_shape)
    kh, kw = (int(v) for v in kernel_hw)
    pads = tuple(tuple(int(v) for v in p) for p in pads)
    (pt, pb), (pl, pr) = pads
    ho, wo = int8_cuda.conv_out_hw(h, w, kh, kw, stride, pads)
    auto = wgrad_route(ci)
    if route is None:
        route = auto
    elif route not in ROUTES:
        raise ValueError(f"unknown wgrad_s8 route {route!r} {ROUTES}")
    elif route == "tma" and auto != "tma":
        raise ValueError(f"wgrad_s8: the tma route does not take {ci} "
                         "input channels")
    common = (route, n, ci, h, w, co, kh, kw, stride, pads, ho, wo)
    if route == "ragged":
        return WgradPlan(*common, h, w, ho, wo, 1, w, False, wo, ho * wo,
                         padded_k(n * ho * wo))
    if stride > 1:
        wop = _wop(wo)
        hop = _round_up(ho, WGRAD_STAGE_K // min(wop, WGRAD_STAGE_K))
        return WgradPlan(*common, h, w, ho, wo, kw, _round_up(wo, 16),
                         False, wop, hop * wop, n * hop * wop)
    views = [(h, w)]
    if (kh, kw) == (1, 1) and pads == ((0, 0), (0, 0)):
        views += [(h * w // d, d) for d in range(16, h * w + 1, 16)
                  if (h * w) % d == 0]
    best = None
    for hk, wk in views:
        hok, wok = (ho, wo) if (hk, wk) == (h, w) else (hk, wk)
        wph = _round_up(wok, 16)
        kps = _round_up(hok * wph, WGRAD_STAGE_K)
        # least K, then a plain q, then the conv's own view
        key = (kps, wph != wk or kw > 1 or pads[1][0] > 0,
               (hk, wk) != (h, w))
        if best is None or key < best[0]:
            best = (key, hk, wk, hok, wok, wph, kps)
    _, hk, wk, hok, wok, wph, kps = best
    return WgradPlan(*common, hk, wk, hok, wok, kw, wph, True, wph, kps,
                     n * kps)


def plan_of(q, qgt, kernel_hw, stride, pads) -> WgradPlan:
    """The 'ragged' plan of a plain q [N,Ci,H,W] and a dense qgt: the
    layouts of every call without a plan."""
    return wgrad_plan(tuple(q.shape), qgt.shape[0], tuple(kernel_hw),
                      stride, _pads(pads), route="ragged")


def _pads(pads):
    return tuple(tuple(int(v) for v in p) for p in pads)


# What a part of a split K costs the tile's last block, which reads every
# part's int32 sums back, in stages of a 128-wide tile (times bn / 128):
# fitted to CUDA-graph times of every F16-flagship geometry at several
# widths and splits on the H100 (`probes.actq_wgrad8 variants`).
WGRAD_SPLIT_STAGES = 5


def wgrad_split_cost(tiles: int, ksteps: int, bn: int, d: int,
                     sms: int = int8_cuda.SM_COUNT) -> float:
    """The busiest block's time, in stages of a 128-wide tile, for a
    'tma' route call of `tiles` tiles 128 x bn wide and `ksteps` stages
    of K split into `d` parts: its rounds of the grid times a part's
    stages, a 256-wide stage costing what its 128 x 384 bytes of L2 cost
    against a 128-wide stage's 128 x 256, plus WGRAD_SPLIT_STAGES x bn /
    128 a part when K is split."""
    kps = -(-ksteps // d)
    cost = -(-tiles * d // sms) * kps * (WGRAD_TILE + bn) / 256
    if d > 1:
        cost += WGRAD_SPLIT_STAGES * d * bn / 128
    return cost


@functools.lru_cache(maxsize=4096)
def wgrad_tiles(plan: WgradPlan, sms: int = int8_cuda.SM_COUNT,
                bn: int = None, splits: int = None) -> dict:
    """The 'tma' route's tile walk: 128 x bn tiles (Co rows x bn channels
    of one tap; bn 256 where it divides Ci, else 128), `ksteps` stages
    of 128 bytes of K split into `splits` parts of `kps` stages (the last
    may be shorter), the pair with the least `wgrad_split_cost`; `bn`
    and `splits` may be given (a bench's variants)."""
    ksteps = plan.kp // WGRAD_STAGE_K
    m_tiles = -(-plan.co // WGRAD_TILE)
    best = None
    for b in ((bn,) if bn else (128, 256) if plan.ci % 256 == 0 else (128,)):
        tiles = m_tiles * plan.kh * plan.kw * -(-plan.ci // b)
        for d in ((splits,) if splits else
                  range(1, min(ksteps, WGRAD_MAX_SPLITS) + 1)):
            kps = -(-ksteps // d)
            # no empty part; a split K in one round of the grid (more
            # rounds of parts measured slower than the model has them)
            if (d - 1) * kps >= ksteps or (d > 1 and not splits
                                           and tiles * d > sms):
                continue
            cost = wgrad_split_cost(tiles, ksteps, b, d, sms)
            if best is None or cost < best[0]:
                best = (cost, b, d, kps, tiles)
    _, bn, splits, kps, tiles = best
    cblocks = -(-plan.ci // bn)
    items = tiles * splits
    return dict(bn=bn, m_tiles=m_tiles, cblocks=cblocks,
                n_tiles=plan.kh * plan.kw * cblocks, tiles=tiles,
                ksteps=ksteps, splits=splits, kps=kps, items=items,
                grid=min(items, sms))


def _row_len(per: int) -> int:
    """Row length of a plain tensor of `per` elements a sample: 256 down
    to 16 where it divides, else the whole sample."""
    for d in (256, 128, 64, 32, 16):
        if per % d == 0:
            return d
    return per


@functools.lru_cache(maxsize=4096)
def quant_rows(mode: str, shape, plan=None) -> dict:
    """The quantize kernel's view of a call: input rows of `w` elements
    (`rps` a sample), each written as `copies` blocks of `wph` bytes,
    byte v * wph + j from column j * s + v - pl ('x': rows one after
    another, or with `cmaj` copy v of row (nc, h) at ((nc * copies + v) *
    hok + h) * wph; 'g': row (n, co, oh) at column n * kps + oh * wph of
    qgt's row co, kp bytes a row)."""
    n = int(shape[0])
    if mode == "x":
        if plan is not None and not plan.plain_q:
            return dict(rows=n * plan.ci * plan.hk, w=plan.wk,
                        copies=plan.copies, wph=plan.wph, s=plan.stride,
                        pl=plan.pads[1][0], rps=plan.ci * plan.hk, n=n,
                        hok=plan.hk, kps=0, kp=0, cmaj=plan.cmaj)
        per = math.prod(int(v) for v in shape[1:])
        w = _row_len(per)
        return dict(rows=n * per // w, w=w, copies=1, wph=w, s=1, pl=0,
                    rps=per // w, n=n, hok=0, kps=0, kp=0, cmaj=False)
    hok, wok, wst, kps, kp = _qg_dims(plan, *(int(v) for v in shape))
    return dict(rows=n * int(shape[1]) * hok, w=wok, copies=1, wph=wst,
                s=1, pl=0, rps=int(shape[1]) * hok, n=n, hok=hok, kps=kps,
                kp=kp, cmaj=False)


@functools.lru_cache(maxsize=4096)
def quant_plan(rows: int, w: int, esize: int, vec: int,
               sms: int = int8_cuda.SM_COUNT) -> dict:
    """The quantize kernel's schedule: block b of the grid holds the
    chunk_rows rows from b * chunk_rows on (a multiple of the rows that
    make 16 bytes, with `vec`), one block a SM; it reads them for the
    reduction and again after the barrier (csrc/actq.cu)."""
    v = 16 // esize if vec else 1
    gran = v // math.gcd(w, v)
    chunk_rows = _round_up(-(-rows // sms), gran)
    return dict(chunk_rows=chunk_rows, grid=-(-rows // chunk_rows), vec=vec)


@functools.lru_cache(maxsize=4096)
def dequant_plan(n: int, per: int, esize: int, q_mod: int = 0,
                 out_mod: int = 0, sms: int = int8_cuda.SM_COUNT) -> dict:
    """The dequant kernel's schedule over the n * per elements of a call
    whose q and out start `q_mod` and `out_mod` bytes past a 16-byte
    boundary (out's elements `esize` bytes): `head` elements one a
    thread, then `chunks` 16-element chunks (q and out both 16-byte
    aligned; a chunk may span samples), then the `tail`; where q and
    out cannot both be aligned, every element one a thread. `grid`
    persistent blocks, at most DEQUANT_BLOCKS a SM: block b takes chunks
    [(k * grid + b) * span, + span) in its k-th pass (span =
    DEQUANT_THREADS * DEQUANT_UNROLL; a thread loads 8 q bytes a bf16
    group, 4 a f32 one, and stores 16 bytes of it)."""
    total = n * per
    head = -q_mod % 16
    if head >= total or (out_mod + head * esize) % 16:
        head = total
    chunks = (total - head) // DEQUANT_CHUNK
    tail = total - head - DEQUANT_CHUNK * chunks
    scalars = -(-(head + tail) // DEQUANT_THREADS)
    units = -(-chunks // (DEQUANT_THREADS * DEQUANT_UNROLL))
    return dict(head=head, chunks=chunks, tail=tail,
                grid=min(max(units, scalars, 1), sms * DEQUANT_BLOCKS))


# --------------------------------------------------------------------------
# layouts


def _copy_columns(plan):
    """Column j of copy dx reads column j * stride + dx - pl: the source
    column of every (dx, j), and where it lies inside the row."""
    src = torch.arange(plan.wph) * plan.stride
    src = src[None, :] + torch.arange(plan.copies)[:, None] - plan.pads[1][0]
    return src.clamp(0, plan.wk - 1), (src >= 0) & (src < plan.wk)


def to_layout(q, plan):
    """Plain q [N, Ci, H, W] in the plan's q layout (module docstring)."""
    if plan is None or plan.plain_q:
        return q
    n, c = q.shape[:2]
    src, inside = _copy_columns(plan)
    v = q.reshape(n, c, plan.hk, plan.wk)[..., src.to(q.device).reshape(-1)]
    v = v.reshape(n, c, plan.hk, plan.copies, plan.wph)
    v = v * inside.to(q.device).to(q.dtype)
    if plan.cmaj:
        v = v.permute(0, 1, 3, 2, 4)
    return v.contiguous().reshape(plan.q_shape)


def q_of(q, plan):
    """q in the plan's layout back to plain [N, Ci, H, W]: each column
    from a place that holds it, zero for a column no tap reads (a 1x1
    stride-2 conv's odd columns), which adds nothing to the sums."""
    if plan is None or plan.plain_q:
        return q
    n, c = q.shape[:2]
    src, inside = _copy_columns(plan)
    if plan.cmaj:
        q = q.reshape(n, c, plan.copies, plan.hk, plan.wph).permute(
            0, 1, 3, 2, 4)
    flat = F.pad(q.reshape(n, c, plan.hk, plan.copies * plan.wph), (0, 1))
    idx = torch.full((plan.wk,), plan.copies * plan.wph, dtype=torch.long)
    pos = torch.arange(plan.copies * plan.wph).reshape(plan.copies,
                                                       plan.wph)
    idx[src[inside]] = pos[inside]
    return flat[..., idx.to(q.device)].reshape(n, c, plan.h, plan.w)


def _qg_dims(plan, n, co, ho, wo):
    """(hok, wok, wst, kps, kp): output row oh of sample n at n * kps +
    oh * wst of a qgt row of kp bytes."""
    if plan is None:
        return ho, wo, wo, ho * wo, padded_k(n * ho * wo)
    return plan.hok, plan.wok, plan.wst, plan.kps, plan.kp


def _qgt(qg, kp=None, plan=None):
    """qg [N,Co,Ho,Wo] -> qgt [Co, Kp]: the plan's layout, or without one
    column n * Ho * Wo + p of `kp` (zero padded)."""
    n, co, ho, wo = qg.shape
    hok, wok, wst, kps, kpp = _qg_dims(plan, n, co, ho, wo)
    kp = kpp if kp is None else kp
    out = torch.zeros((co, n, kps), dtype=torch.int8, device=qg.device)
    out[:, :, :hok * wst].view(co, n, hok, wst)[..., :wok] = \
        qg.permute(1, 0, 2, 3).reshape(co, n, hok, wok)
    out = out.reshape(co, n * kps)
    if kp == out.shape[1]:
        return out
    full = torch.zeros((co, kp), dtype=torch.int8, device=qg.device)
    full[:, :out.shape[1]] = out
    return full


def qg_of(qgt, n, ho, wo, plan=None):
    """qgt [Co, Kp] (the plan's layout, or without one the dense
    layout) back to qg [N, Co, Ho, Wo]."""
    co = qgt.shape[0]
    hok, wok, wst, kps, _ = _qg_dims(plan, n, co, ho, wo)
    v = qgt[:, :n * kps].reshape(co, n, kps)[:, :, :hok * wst]
    v = v.reshape(co, n, hok, wst)[..., :wok]
    return v.reshape(co, n, ho, wo).permute(1, 0, 2, 3)


# --------------------------------------------------------------------------
# plain versions


def _round_clip(v):
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def _div127(v):
    """v / 127, a true division in v's type: on the card PyTorch turns a
    division by a Python number into a multiply by its reciprocal, which
    can miss JAX's quotient by an ulp; a tensor divisor does not."""
    return v / torch.full_like(v, 127.0)


def quant_x_torch(x, plan=None):
    """(q, scale) of `_quantize_per_sample`: the max and the scale in x's
    type, the quantize in f32; q in the plan's layout."""
    amax = x.abs().amax(dim=tuple(range(1, x.dim())))
    scale = _div127(torch.clamp_min(amax, 1e-12)).to(torch.float32)
    q = _round_clip(x.to(torch.float32) / _bshape(scale, x.dim()))
    return to_layout(q, plan), scale


def quant_g_torch(g, scale, group=None, alpha_len: int = 1, plan=None):
    """(qgt, alpha) of the output-gradient quantize: sg over the whole
    tensor (over `group`'s ranks too), alpha = sg `alpha_len` times."""
    G = g.to(torch.float32) * _bshape(scale, g.dim())
    amax = G.abs().amax().reshape(1)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    sg = _div127(torch.clamp_min(amax, 1e-30))
    qg = _round_clip(G / sg)
    return (_qgt(qg, plan=plan),
            sg.reshape(1).expand(alpha_len).contiguous())


def dequant_torch(q, scale, dtype):
    """dtype(q) * dtype(scale[n]), rounded in dtype."""
    return q.to(dtype) * _bshape(scale.to(dtype), q.dim())


def quant_s8_torch(t, mode, scale=None, dtype=None, group=None,
                   alpha_len: int = 1, plan=None):
    """Plain version of quant_s8."""
    if mode == "x":
        return quant_x_torch(t, plan)
    if mode == "g":
        return quant_g_torch(t, scale, group, alpha_len, plan)
    if mode == "dequant":
        return dequant_torch(t, scale, dtype)
    raise ValueError(f"unknown quant_s8 mode {mode!r} {MODES}")


def wgrad_s8_torch(q, qgt, kernel_hw, stride, pads, plan=None):
    """Plain version of wgrad_s8's sums: int32 [Co, Ci, KH, KW] from a
    float64 `conv2d_weight` (cuDNN off on the card, as conv_s8_torch), q
    and qgt in the plan's layouts (without a plan: plain and dense)."""
    plan = plan or plan_of(q, qgt, kernel_hw, stride, pads)
    q = q_of(q, plan)
    qg = qg_of(qgt, plan.n, plan.ho, plan.wo, plan).to(torch.float64)
    (pt, pb), (pl, pr) = plan.pads
    xd = F.pad(q.to(torch.float64), (pl, pr, pt, pb))
    with torch.backends.cudnn.flags(enabled=False):
        acc = torch.nn.grad.conv2d_weight(
            xd, (plan.co, plan.ci, plan.kh, plan.kw), qg, stride=plan.stride)
    return acc.round().to(torch.int32)


def im2col_torch(q, kernel_hw, stride, pads, plan=None):
    """The patch matrix P [Ci*KH*KW, Kp] int8 of a plain q, with columns
    in the plan's k layout (without a plan, the dense one the gather
    route writes)."""
    n, c, h, w = q.shape
    plan = plan or wgrad_plan(tuple(q.shape), 1, tuple(kernel_hw), stride,
                              _pads(pads), route="ragged")
    kh, kw = plan.kh, plan.kw
    (pt, pb), (pl, pr) = plan.pads
    cols = F.unfold(F.pad(q.to(torch.float32), (pl, pr, pt, pb)),
                    (kh, kw), stride=plan.stride)      # [N, C*KH*KW, HoWo]
    cols = cols.to(torch.int8).reshape(n, c * kh * kw, plan.ho, plan.wo)
    return _qgt(cols, plan=plan)


class Im2colPlan(NamedTuple):
    """The gather's launch (csrc/actq.cu `im2col_kernel`): `band` output
    rows a block, `bands` a (channel, sample), `grid` = C * N * bands
    blocks; each stages `rows` = (band - 1) * stride + KH input rows as
    `stride` phase planes of `pw` bytes a row, after a bulk copy of the
    rows into the first `raw` bytes (0: rows that are not 16-byte
    multiples, read from q directly), beside a table of KH * KW tap
    offsets and one of `tab` chunk offsets (the most 16-byte chunks a
    block writes); `smem` bytes of shared memory."""
    band: int
    bands: int
    rows: int
    pw: int
    raw: int
    tab: int
    smem: int
    grid: int


def im2col_plan(plan: WgradPlan, sms: int, aligned: bool = True
                ) -> Im2colPlan:
    """The gather's blocks for a 'ragged' `plan` on a card of `sms` SMs:
    bands of output rows such that about IM2COL_BLOCKS_PER_SM blocks a SM
    cover the C * N * Ho rows, fewer rows where the shared memory would
    pass IM2COL_SMEM_CAP. `aligned`: q is 16-byte aligned."""
    s, kh, w = plan.stride, plan.kh, plan.w
    pw = _round_up(plan.wo + (plan.kw - 1) // s, 16) + 16
    bulk = aligned and w % 16 == 0

    def shape(band):
        rows = (band - 1) * s + kh
        raw = rows * w if bulk else 0
        tab = (band * plan.wo + 15) // 16 + 1
        return rows, raw, tab, raw + rows * s * pw + 4 * (kh * plan.kw
                                                          + tab)

    rows_all = plan.ci * plan.n * plan.ho
    band = max(1, min(plan.ho, -(-rows_all // (IM2COL_BLOCKS_PER_SM * sms))))
    while band > 1 and shape(band)[3] > IM2COL_SMEM_CAP:
        band -= 1
    rows, raw, tab, smem = shape(band)
    bands = -(-plan.ho // band)
    return Im2colPlan(band, bands, rows, pw, raw, tab, smem,
                      plan.ci * plan.n * bands)


# --------------------------------------------------------------------------
# workspaces, per device (calls on a device are ordered: one stream at a
# time): the amax slots and barrier counters and wgrad_s8's tile counters
# are zero on entry and left zero by the kernels; wgrad_s8's split
# partial sums are written before they are read

_quant_ws: dict = {}
_wgrad_counters: dict = {}
_wgrad_partials: dict = {}


def _workspace(store, dev, numel, fill=True):
    key = (dev.type, dev.index)
    t = store.get(key)
    if t is None or t.numel() < numel:
        t = (torch.zeros if fill else torch.empty)(
            max(numel, 64), dtype=torch.int32, device=dev)
        store[key] = t
    return t


# --------------------------------------------------------------------------
# wrappers


def _check_cuda(name, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _check_float(name, t) -> None:
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name}: float32 or bfloat16, got {t.dtype}")


def _check_plan(t, mode, plan) -> None:
    if plan is None:
        return
    if mode == "x" and tuple(t.shape) != (plan.n, plan.ci, plan.h, plan.w):
        raise ValueError(f"quant_s8 'x': x {tuple(t.shape)} is not the "
                         f"plan's input {(plan.n, plan.ci, plan.h, plan.w)}")
    if mode == "g" and tuple(t.shape) != (plan.n, plan.co, plan.ho,
                                          plan.wo):
        raise ValueError(f"quant_s8 'g': g {tuple(t.shape)} is not the "
                         f"plan's output "
                         f"{(plan.n, plan.co, plan.ho, plan.wo)}")


def _quant_launch(lib, t, mode, phase, scale, out, scale_out, alpha_len,
                  rv, sched, ws, timing_mul: bool = False):
    """One launch of the quantize kernel. `timing_mul` multiplies by the
    scale's reciprocal instead of dividing: other bits than JAX's, for
    the probe's timing of the division alone; quant_s8 never sets it."""
    return lib.ursonet_actq_quant(
        t.data_ptr(), _DTYPES[t.dtype], 0 if mode == "x" else 1, phase,
        None if scale is None else scale.data_ptr(), out.data_ptr(),
        None if scale_out is None else scale_out.data_ptr(),
        ws.data_ptr() + 8, ws.data_ptr(), rv["rows"], rv["w"], rv["copies"],
        rv["wph"], rv["s"], rv["pl"], rv["rps"], rv["n"], rv["hok"],
        rv["kps"], rv["kp"], int(rv["cmaj"]),
        alpha_len, int(sched["vec"]), int(timing_mul), sched["grid"],
        sched["chunk_rows"], _stream(t))


def _dequant_launch(lib, q, scale, out):
    """One launch of the dequant kernel from q [N, ...] into `out` of q's
    shape, at their own alignments (`dequant_plan`)."""
    n = q.shape[0]
    per = q.numel() // n
    plan = dequant_plan(n, per, out.element_size(), q.data_ptr() % 16,
                        out.data_ptr() % 16, int8_cuda._sms(q.device))
    return lib.ursonet_actq_dequant(
        q.data_ptr(), scale.data_ptr(), n, per, out.data_ptr(),
        _DTYPES[out.dtype], plan["head"], plan["chunks"], plan["grid"],
        _stream(q))


def quant_vec(rv, esize, aligned=True) -> int:
    """How the quantize kernel moves a call's bytes: 2 (16-byte loads
    and stores, each unit's columns consecutive), 1 (16-byte loads and
    stores, columns gathered), 0 (one byte a thread)."""
    if not (aligned and rv["wph"] % 16 == 0 and rv["kp"] % 16 == 0
            and (rv["rps"] * rv["w"]) % (16 // esize) == 0):
        return 0
    return 2 if (rv["copies"], rv["s"], rv["pl"]) == (1, 1, 0) \
        and (rv["w"] * esize) % 16 == 0 else 1


def quant_s8(t, mode, scale=None, dtype=None, group=None,
             alpha_len: int = 1, plan=None):
    """The quantize kernels' three modes (module docstring), 'x' and 'g'
    in `plan`'s layouts; on a CPU tensor, quant_s8_torch."""
    if mode not in MODES:
        raise ValueError(f"unknown quant_s8 mode {mode!r} {MODES}")
    if calls is not None:
        calls.append(("quant_s8", dict(mode=mode, shape=tuple(t.shape),
                                       dtype=t.dtype, out_dtype=dtype,
                                       plan=plan, group=group is not None,
                                       alpha_len=alpha_len)))
    _check_plan(t, mode, plan)
    if t.device.type == "cpu":
        return quant_s8_torch(t, mode, scale, dtype, group, alpha_len, plan)
    lib = _lib()
    n = t.shape[0]
    if mode == "dequant":
        _check_cuda("quant_s8", t, scale)
        if t.dtype != torch.int8 or dtype not in _DTYPES \
                or scale.shape != (n,) or scale.dtype != torch.float32:
            raise ValueError("quant_s8 'dequant': int8 q, float32 scale [N] "
                             "and a float32 or bfloat16 dtype")
        out = torch.empty(t.shape, dtype=dtype, device=t.device)
        _raise_if(_dequant_launch(lib, t, scale, out), lib, "quant_s8")
        kernel_launches["dequant"] += 1
        launches["quant_s8"] += 1
        mode_launches[mode] += 1
        return out
    _check_float("quant_s8", t)
    sms = int8_cuda._sms(t.device)
    rv = quant_rows(mode, t.shape, plan)
    if mode == "x":
        _check_cuda("quant_s8", t)
        shape = plan.q_shape if plan is not None else tuple(t.shape)
        out = torch.empty(shape, dtype=torch.int8, device=t.device)
        scale_out = torch.empty(n, dtype=torch.float32, device=t.device)
        result = (out, scale_out)
    else:
        _check_cuda("quant_s8", t, scale)
        if t.dim() != 4 or scale.shape != (n,) \
                or scale.dtype != torch.float32:
            raise ValueError("quant_s8 'g': g [N,Co,Ho,Wo] and scale [N] "
                             "float32")
        out = torch.empty((t.shape[1], rv["kp"]), dtype=torch.int8,
                          device=t.device)
        scale_out = torch.empty(alpha_len, dtype=torch.float32,
                                device=t.device)
        result = (out, scale_out)
    ws = _workspace(_quant_ws, t.device, 2 + n)
    vec = quant_vec(rv, t.element_size(), t.data_ptr() % 16 == 0
                    and out.data_ptr() % 16 == 0)
    sched = quant_plan(rv["rows"], rv["w"], t.element_size(), vec, sms)
    if mode == "g" and group is not None:
        # the reduction, the all-reduce of the slot (MAX on the int32
        # bits: non-negative floats order as their bits), the quantize
        _raise_if(_quant_launch(lib, t, mode, 1, scale, out, None, 0, rv,
                                sched, ws), lib, "quant_s8")
        dist.all_reduce(ws[2:3], op=dist.ReduceOp.MAX, group=group)
        _raise_if(_quant_launch(lib, t, mode, 2, scale, out, scale_out,
                                alpha_len, rv, sched, ws), lib, "quant_s8")
        kernel_launches["quant_g_group"] += 2
    else:
        _raise_if(_quant_launch(lib, t, mode, 3, scale, out, scale_out,
                                alpha_len, rv, sched, ws), lib, "quant_s8")
        kernel_launches["quant_" + mode] += 1
    launches["quant_s8"] += 1
    mode_launches[mode] += 1
    return result


def im2col_s8(q, plan):
    """The gather route's patch matrix P [Ci*KH*KW, Kp] int8 of a plain q
    [N,Ci,H,W] for a 'ragged' `plan` (one launch of the gather kernel);
    on a CPU tensor, im2col_torch."""
    if plan.route != "ragged" or tuple(q.shape) != plan.q_shape:
        raise ValueError(f"im2col_s8: q {tuple(q.shape)} and a ragged plan "
                         f"of {plan.q_shape}")
    geo = ((plan.kh, plan.kw), plan.stride, plan.pads)
    if q.device.type == "cpu":
        return im2col_torch(q, *geo, plan)
    _check_cuda("im2col_s8", q)
    if q.dtype != torch.int8:
        raise ValueError("im2col_s8: int8 q")
    lib = _lib()
    (pt, _), (pl, _) = plan.pads
    ip = im2col_plan(plan, int8_cuda._sms(q.device), q.data_ptr() % 16 == 0)
    p = torch.empty((plan.ci * plan.kh * plan.kw, plan.kp), dtype=torch.int8,
                    device=q.device)
    _raise_if(lib.ursonet_actq_im2col(
        q.data_ptr(), plan.n, plan.ci, plan.h, plan.w, plan.kh, plan.kw,
        plan.stride, pt, pl, plan.ho, plan.wo, plan.kp, ip.band, ip.rows,
        ip.pw, ip.raw, ip.tab, ip.smem, p.data_ptr(), _stream(q)), lib,
        "im2col_s8")
    kernel_launches["im2col"] += 1
    return p


def wgrad_s8(q, qgt, kernel_hw, stride, pads, alpha=None, plan=None):
    """dw [Co, Ci, KH, KW] = sum over n, oh, ow of q[n, ci, oh*s+dy-pt,
    ow*s+dx-pl] * qg[n, co, oh, ow]: int32, or f32(acc) * alpha[r] (r =
    ci*KH*KW + dy*KW + dx) when `alpha` is given. q and qgt in `plan`'s
    layouts (`quant_s8` 'x' and 'g' with the same plan); without a plan
    q plain [N,Ci,H,W], qgt dense [Co, Kp], the 'ragged' route. pads
    ((pt, pb), (pl, pr))."""
    if plan is None:
        if q.dim() != 4:
            raise ValueError(f"wgrad_s8: q [N,Ci,H,W], got {tuple(q.shape)}")
        plan = plan_of(q, qgt, kernel_hw, stride, pads)
    elif (tuple(kernel_hw), stride, _pads(pads)) != (
            (plan.kh, plan.kw), plan.stride, plan.pads):
        raise ValueError("wgrad_s8: the geometry is not the plan's")
    if tuple(q.shape) != plan.q_shape or tuple(qgt.shape) != (plan.co,
                                                               plan.kp):
        raise ValueError(f"wgrad_s8: q {tuple(q.shape)} and qgt "
                         f"{tuple(qgt.shape)} are not the plan's "
                         f"{plan.q_shape} and {(plan.co, plan.kp)}")
    c, kh, kw, co = plan.ci, plan.kh, plan.kw, plan.co
    r = c * kh * kw
    if calls is not None:
        calls.append(("wgrad_s8", dict(q=(plan.n, c, plan.h, plan.w), co=co,
                                       kernel_hw=(kh, kw),
                                       stride=plan.stride, pads=plan.pads,
                                       route=plan.route)))
    if q.device.type == "cpu":
        acc = wgrad_s8_torch(q, qgt, kernel_hw, stride, pads, plan)
        if alpha is None:
            return acc
        return acc.to(torch.float32) * alpha.view(1, c, kh, kw)
    _check_cuda("wgrad_s8", q, qgt)
    if alpha is not None:
        _check_cuda("wgrad_s8", alpha)
        if alpha.shape != (r,) or alpha.dtype != torch.float32:
            raise ValueError(f"wgrad_s8: alpha [{r}] float32")
    if q.dtype != torch.int8 or qgt.dtype != torch.int8:
        raise ValueError("wgrad_s8: int8 q and qgt")
    lib = _lib()
    if plan.route == "ragged":
        p = im2col_s8(q, plan)
        if alpha is None:
            out = int8_cuda.gemm_s8(qgt, p.t(), "s32")
        else:
            beta = torch.zeros(r, dtype=torch.float32, device=q.device)
            out = int8_cuda.gemm_s8(qgt, p.t(), "f32", alpha, beta)
    else:
        tiles = wgrad_tiles(plan, int8_cuda._sms(q.device))
        out = torch.empty((co, r), device=q.device,
                          dtype=torch.int32 if alpha is None
                          else torch.float32)
        ws = counters = None
        if tiles["splits"] > 1:
            ws = _workspace(_wgrad_partials, q.device, tiles["splits"]
                            * tiles["tiles"] * WGRAD_TILE * tiles["bn"],
                            fill=False).data_ptr()
            counters = _workspace(_wgrad_counters, q.device,
                                  2 * tiles["tiles"]).data_ptr()
        _raise_if(lib.ursonet_actq_wgrad_tma(
            q.data_ptr(), qgt.data_ptr(),
            None if alpha is None else alpha.data_ptr(), out.data_ptr(), ws,
            counters, plan.n, c, plan.hk, plan.copies, plan.wph, co, kh, kw,
            plan.stride, plan.pads[0][0], int(plan.cmaj), plan.wst,
            plan.kps, plan.kp, tiles["bn"], tiles["splits"], tiles["grid"],
            _stream(q)), lib, "wgrad_s8")
        kernel_launches["wgrad_tma"] += 1
    launches["wgrad_s8"] += 1
    route_launches[plan.route] += 1
    return out.view(co, c, kh, kw)
