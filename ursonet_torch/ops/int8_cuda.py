"""int8 GEMM, int8 convolution and the fused int8 stem, with fused
epilogues: the CUDA kernels `csrc/int8_gemm.cu`, `csrc/int8_conv.cu` and
`csrc/int8_stem.cu`, their wrappers, and their plain PyTorch versions.

    gemm_s8(a, b, epilogue, ...)   a [M,K] s8 @ b [K,N] s8 -> [M,N]
    conv_s8(x, w, stride, padding, epilogue, ...)
                                   x [B,H,W,C] s8 (NHWC), w [KH,KW,C,N] s8
                                   (HWIO) -> [B,OH,OW,N]
    stem_s8(x, w, alpha, beta, ...)
                                   x [B,H/2,W/2,12] u8 (space-to-depth
                                   pixels) or [B,H,W,3] u8 (the raw
                                   batch), w [4,4,12,64] s8 (HWIO) ->
                                   [B,H/4,W/4,64] s8: input quantize, 4x4/1
                                   conv (the 7x7/2 stem on the raw batch),
                                   ReLU + requant, 3x3/2 max-pool

They are the Hopper ports of the Pallas TPU kernels
`tools/probe_pallas_int8_matmul.py::_matmul_kernel` and
`tools/probe_pallas_c2.py::matmul_requant_kernel` (gemm_s8),
`tools/probe_pallas_conv3.py::_conv_kernel` (conv_s8) and
`tools/probe_pallas_stem.py::_stem_kernel` (stem_s8). The int8 serving
path (`models/quant.py`) reaches these three on the card.

Epilogues, in the f32 accumulation mode (acc_dtype=torch.float32),
with y = fma(f32(acc), alpha[n], beta[n]) (one rounding):

    s32       acc (int32)
    f32       y
    f32_relu  max(y, 0)
    q8_relu   clip(rint(max(y, 0) * inv_s_out), 0, 127)          (int8)
    q8        clip(rint(y * inv_s_out), -127, 127)               (int8)
    join      clip(rint(max(y + f32(res) * res_scale, 0) * inv_s_out),
                   0, 127)                                        (int8)
    join_s8   clip(rint(y * inv_s_out) + rint(f32(res) * res_scale),
                   0, 127)                                        (int8)
    f32_sum   y (the same as f32 in this mode)

That is the arithmetic XLA compiles the JAX package's Int8Ops into
(measured on the CPU against the whole model): it contracts
acc * alpha + beta into an FMA, adds the dequantized residual with its
product and sum rounded separately, and turns the division by a
constant step into a multiply by `inv_s_out` = f32(1 / step). The
probes' pre-scaled form is inv_s_out = 1.

The bf16 accumulation mode (acc_dtype=torch.bfloat16, the JAX package's
F16) is what XLA compiles Int8Ops(acc_dtype=bfloat16) into: every bf16
operation computed in f32 and rounded to bf16 (RNE) right after it, no
FMA. With bf(v) = f32(bf16(v)):

    a = bf(f32(acc))          (s32 -> f32 -> bf16: two roundings)
    s = bf(a * bf(alpha[n])) + bf(beta[n])
    y = bf(s)
    f32       y                                                   (bf16)
    f32_relu  max(y, 0)                                           (bf16)
    q8_relu   clip(rint(max(y, 0) * inv_s_out), 0, 127)
    q8        clip(rint(s * inv_s_out), -127, 127)
    join      clip(rint(max(bf(y + bf(f32(res) * bf(res_scale))), 0)
                        * inv_s_out), 0, 127)

    join_s8   clip(rint(s * inv_s_out) + rint(f32(res) * res_scale),
                   0, 127)
    f32_sum   s                                                   (f32)

q8 and join_s8 multiply the unrounded sum s, and f32_sum writes it:
XLA drops the bf16 round trip of a value whose only use is its widening
back to f32 (excess precision), which is the case where Int8Ops
requantizes a shortcut conv and where it rounds a 2c conv onto the
join's grid. The multiplies by
inv_s_out and by join_s8's res_scale stay in f32 as in the f32 mode
(res_scale is not rounded to bf16 there: JAX multiplies the f32
residual by a weakly typed Python float). f32_sum is the shortcut conv
that join_s8 takes as a float residual: XLA drops its bf16 rounding too
(measured on the CPU against the whole model).

The residual joins (`join`, `join_s8`) take `res` as int8 (a requantized
shortcut, res_scale its step) or as the float output of the shortcut
conv (`f32`: f32, or bf16 in the bf16 mode; `f32_sum`: f32): the
artifacts calibrated before the shortcut requant sites existed.
`join` then takes res_scale 1 (the residual enters the sum as it is),
and JAX's relu(r + sc) followed by the requantize is the formula above.
join_s8 is the JAX package's QUANT_S8_JOIN: both operands rounded onto
the output grid, r_i = rint(r / s_out) and sc_i = rint(sc * ratio) with
ratio = f32(step_sc / s_out) for an int8 shortcut and f32(1 / s_out) for
a float one, then the integer clip of r_i + sc_i (ReLU is its lower
bound).

Layouts the kernels take: `a` and `x` contiguous; the weights
output-channel-major, i.e. `b` is the [K,N] view `wt.t()` of a
contiguous [N,K] tensor and `w` the HWIO view `wo.permute(1,2,3,0)` of
a contiguous [N,KH,KW,C] tensor (`kernel_layout` makes both from numpy
weights once). On a CUDA tensor a wrapper launches its kernel or
raises; on a CPU tensor it runs the plain version, which accumulates in
float64 (exact: |acc| < 2^53) and applies the same epilogue with
PyTorch operations in the same order, the FMA rounded once by
`fma_f32`. Each launch adds one to
`launches[name]`; when `calls` is a list, each launch also appends its
shapes and its route there (what chip_smoke.py times at the serving
path's shapes).

Routes. `gemm_s8` and `conv_s8` each have two hand-written kernels, and
the wrapper picks one from the shapes and the pointers' alignment before
the launch (`gemm_route`, `conv_route`), never by catching a failure:

    'tma'     the persistent TMA + wgmma kernel of `csrc/int8_tma.cuh`
              (Hopper machinery in `csrc/hopper.cuh`): K % 16 == 0 and
              N * out_bytes % 16 == 0 for the GEMM, C % 16 == 0 and
              N % 16 == 0 for the conv, 16-byte aligned operands. Every
              GEMM and every 3x3 conv of the served model takes it.
              `hopper_plan` picks its tile width, the depth of its
              pipeline, whether the weights stay in shared memory, and
              the split over K for outputs of few rows.
    'ragged'  the mma.sync kernel of `csrc/int8_common.cuh`, for any
              shape (C = 3 stem convs the fused stem does not take, odd
              K).

`stem_s8` has two kernels in `csrc/int8_stem.cu`, picked by `stem_route`:

    'tma'     persistent blocks, TMA loads of the packed pixels into a
              ring, resident weights, wgmma with A in registers: W2 % 4
              == 0 and 16-byte aligned pointers (the `host_s2d` batch).
    'ragged'  one block a tile, mma.sync on 32-bit shared loads: any
              width.
    'nhwc'    the 'tma' kernel reading the raw uint8 batch [B,H,W,3]
              and packing each tile as it quantizes it (H even, W % 16
              == 0, 16-byte aligned pointers): the `base` and `s2d`
              variants' served batch, in one launch. Its plain version
              is `stem_s8_nhwc_torch`, the unfused chain with the 7x7
              kernel.

`route=` forces one of the first two on packed pixels (the checks hold
both against the plain version); a forced 'tma' on a shape it does not
take raises. Raw pixels take 'nhwc' or raise.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ursonet_torch.ops import cuda_build

EPILOGUES = {"s32": 0, "f32": 1, "f32_relu": 2, "q8_relu": 3, "q8": 4,
             "join": 5, "join_s8": 6, "f32_sum": 7}
# The epilogues that add a residual.
JOINS = ("join", "join_s8")
# The accumulation modes, by their names in `calls`: the f32 epilogue
# and the bf16 one (F16).
ACC_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
ACC_DTYPES = tuple(ACC_NAMES)
_OUT_F32 = {"s32": torch.int32, "f32": torch.float32,
            "f32_relu": torch.float32, "q8_relu": torch.int8,
            "q8": torch.int8, "join": torch.int8, "join_s8": torch.int8,
            "f32_sum": torch.float32}
# {acc_dtype: {epilogue: output dtype}}: f32 and f32_relu write bf16 in
# the bf16 mode
OUT_DTYPES = {torch.float32: _OUT_F32,
              torch.bfloat16: dict(_OUT_F32, f32=torch.bfloat16,
                                   f32_relu=torch.bfloat16)}
# Kernel launches since the last reset_counts(), by kernel name
# ('stem_s8_nhwc': those of stem_s8's 'nhwc' route, counted under
# 'stem_s8' too), and the joins among them by kernel, epilogue and
# residual type ('s8', 'f32', 'bf16'), e.g. ('gemm_s8', 'join_s8', 's8').
launches = {"gemm_s8": 0, "conv_s8": 0, "stem_s8": 0, "stem_s8_nhwc": 0}
join_launches: dict = {}
# None, or a list that each launch appends (name, shapes, epilogue,
# route, accumulation mode 'f32' or 'bf16', and for a join the
# residual's type) to.
calls = None


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0
    join_launches.clear()


def res_kind(res) -> str:
    """The residual's type as `calls` and `join_launches` name it."""
    return {torch.int8: "s8", torch.float32: "f32",
            torch.bfloat16: "bf16"}[res.dtype]


def _bind_gemm(lib) -> None:
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ursonet_gemm_s8.argtypes = [P, P, I, I, I, I, I, I, I, P, P, Fl, P,
                                    I, Fl, P, I, I, P]
    lib.ursonet_gemm_s8.restype = I
    lib.ursonet_gemm_s8_tma.argtypes = [P, P, I, I, I, I, I, P, P, Fl, P, I,
                                        Fl, P, I, I, I, I, I, P, P, I, I, P]
    lib.ursonet_gemm_s8_tma.restype = I
    lib.ursonet_int8_error_string.argtypes = [I]
    lib.ursonet_int8_error_string.restype = ctypes.c_char_p


def _bind_conv(lib) -> None:
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ursonet_conv_s8.argtypes = [P, P] + [I] * 14 + [I, I, P, P, Fl, P,
                                                        I, Fl, P, I, I, P]
    lib.ursonet_conv_s8.restype = I
    lib.ursonet_conv_s8_tma.argtypes = [P, P] + [I] * 12 + [I, I, P, P, Fl,
                                                            P, I, Fl, P, I, I,
                                                            I, I, I, I, P]
    lib.ursonet_conv_s8_tma.restype = I
    lib.ursonet_int8_error_string.argtypes = [I]
    lib.ursonet_int8_error_string.restype = ctypes.c_char_p


def _bind_stem(lib) -> None:
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.ursonet_stem_s8, lib.ursonet_stem_s8_tma,
               lib.ursonet_stem_s8_nhwc):
        fn.argtypes = [P, P, I, I, I, I, P, Fl, P, P, Fl, I, P, I, P]
        fn.restype = I
    lib.ursonet_int8_error_string.argtypes = [I]
    lib.ursonet_int8_error_string.restype = ctypes.c_char_p


def kernel_layout(w8: np.ndarray) -> torch.Tensor:
    """The layout the kernels take, from a numpy int8 kernel in the JAX
    layout: a dense [K,N] kernel becomes the [K,N] view of a contiguous
    [N,K] tensor, an HWIO conv kernel the HWIO view of a contiguous
    [N,KH,KW,C] tensor."""
    w8 = np.asarray(w8, np.int8)
    if w8.ndim == 2:
        return torch.from_numpy(np.ascontiguousarray(w8.T)).t()
    if w8.ndim == 4:
        return torch.from_numpy(
            np.ascontiguousarray(w8.transpose(3, 0, 1, 2))).permute(1, 2, 3, 0)
    raise ValueError(f"kernel of rank {w8.ndim}")


def tile_for(m: int, n: int) -> int:
    """Tile configuration of csrc/int8_common.cuh (the ragged route) for
    an [m, n] output: 2 (64x64) for few rows (the head denses), 1
    (128x64) for narrow N, else 0 (128x128)."""
    if m <= 1024:
        return 2
    if n <= 64:
        return 1
    return 0


# --------------------------------------------------------------------------
# the TMA + wgmma route: what the host decides (csrc/int8_tma.cuh mirrors
# the sizes)

ROUTES = ("tma", "ragged")
# {acc_dtype: {epilogue: bytes an output element}}
OUT_BYTES = {acc: {ep: dt.itemsize for ep, dt in eps.items()}
             for acc, eps in OUT_DTYPES.items()}
SM_COUNT = 132            # H100 SXM; the wrappers ask the device
SMEM_LIMIT = 232448       # 227 KB a block on sm_90
TILE_M = 128              # rows of an output tile, 64 per warpgroup
STAGE_K = 128             # bytes of K in a pipeline stage
RESIDENT_LIMIT = 65536    # weights kept in shared memory up to this
SPLIT_K_MAX_M = 1024      # outputs of at most this many rows split K
# (stages, output buffers), best first; the first that fits is taken.
# The joins keep three buffers and give up stages instead: the residual
# tile is loaded into the buffer two tiles ahead (measured on the H100:
# PERF.md). A float residual has a slot of its own beside each buffer
# (an s8 one is loaded into the output buffer and transformed in place),
# 2 or 4 times the output tile, so those plans give up buffers too.
_DEPTHS = ((4, 3), (3, 3), (4, 2), (3, 2), (4, 1))
_DEPTHS_JOIN = ((4, 3), (3, 3), (2, 3))
_DEPTHS_JOIN_FLOAT = _DEPTHS_JOIN + ((3, 2),)


def res_bytes(epilogue: str, res_dtype) -> int:
    """Bytes an element of a join's float residual takes in its own
    slot of shared memory: 0 without one (no join, or an int8 residual,
    which shares the output buffer)."""
    if epilogue not in JOINS or res_dtype in (None, torch.int8):
        return 0
    return res_dtype.itemsize


def gemm_route(m: int, k: int, n: int, epilogue: str,
               aligned: bool = True, acc_dtype=torch.float32) -> str:
    """'tma' when TMA can address the operands of an [m,k] @ [k,n]
    product (global strides are multiples of 16 bytes; the output's
    element size depends on the accumulation mode; a join's residual
    has rows of n elements of 1, 2 or 4 bytes), else 'ragged'.
    `aligned`: every pointer is 16-byte aligned."""
    ok = aligned and k % 16 == 0 \
        and (n * OUT_BYTES[acc_dtype][epilogue]) % 16 == 0 \
        and (epilogue not in JOINS or n % 16 == 0)
    return "tma" if ok else "ragged"


def conv_route(c: int, n: int, taps: int = 9, padded_numel: int = 0,
               aligned: bool = True) -> str:
    """'tma' for a conv over c input and n output channels when a 16-byte
    chunk of K lies inside one tap and TMA can address the weights and
    the output (N % 16 == 0 does for every epilogue); the gather keeps a
    row's valid taps in 32 bits (`taps` = KH * KW) and indexes the padded
    input (`padded_numel` elements) with 32-bit offsets."""
    ok = aligned and c % 16 == 0 and n % 16 == 0 and taps <= 32 \
        and padded_numel < 2 ** 31
    return "tma" if ok else "ragged"


def stem_route(w2: int, aligned: bool = True, channels: int = 12,
               h: int = 0):
    """The fused stem's route for packed pixels [B,H2,W2,12] (`w2` =
    W2): 'tma' when TMA can address them as rows of 32-bit words (a row
    of W2 * 12 bytes is a multiple of 16: W2 % 4 == 0) and `aligned`
    (every pointer 16-byte aligned), else 'ragged'. For the raw batch
    [B,H,W,3] (`channels` 3, `w2` = W, `h` = H): 'nhwc' when H is even,
    W % 16 == 0 (a raw row of W * 3 bytes is a multiple of 16) and
    `aligned`, else None: no kernel takes it."""
    if channels == 3:
        ok = aligned and h > 0 and h % 2 == 0 and w2 > 0 and w2 % 16 == 0
        return "nhwc" if ok else None
    return "tma" if aligned and w2 % 4 == 0 else "ragged"


def swizzle128(row: int, chunk: int) -> int:
    """Where 16-byte chunk `chunk` (0..7) of 128-byte row `row` of a tile
    lies in shared memory under the 128-byte swizzle: the chunk index
    within the row (tiles are aligned to 1024 bytes)."""
    return chunk ^ (row % 8)


def out_box_offset(row: int, byte: int, inner: int) -> int:
    """Byte offset of byte `byte` of row `row` inside a [64, inner] box
    of the output buffer (inner = 128 or 64): rows of `inner` bytes with
    the 16-byte chunk index XORed with the 128-byte line index (the 128-
    and 64-byte swizzles of the boxes' tensor maps)."""
    x = row * inner + byte
    return x ^ (((x >> 7) & (7 if inner == 128 else 3)) << 4)


def tma_smem_bytes(bn: int, out_bytes: int, stages: int, bufs: int,
                   resident: bool, ksteps: int, n_tiles: int,
                   res_bytes: int = 0) -> int:
    """Dynamic shared memory of a launch of the TMA route: alignment
    slack, the ring of stages (A 128 x 128 B, and the weights' bn x 128 B
    unless resident), the resident weights, the output buffers (each
    with its float residual's slot of `res_bytes` an element), alpha and
    beta of both warpgroups, barriers."""
    stage = TILE_M * STAGE_K + (0 if resident else bn * STAGE_K)
    bres = ksteps * n_tiles * bn * STAGE_K if resident else 0
    return 1024 + stages * stage + bres \
        + bufs * TILE_M * bn * (out_bytes + res_bytes) + 16 * bn + 256


# What one more split costs the block that sums the partial sums, in
# units of one K stage of the pipeline (measured on the H100: see PERF.md).
SPLIT_COST_STAGES = 2


def split_k(m: int, tiles: int, ksteps: int, epilogue: str,
            sms: int = SM_COUNT) -> int:
    """Into how many parts the K stages of each tile are split: 1 for
    more than SPLIT_K_MAX_M rows, for the joins (the residual is loaded
    per tile) and when the tiles fill the SMs. Else the divisor d of `ksteps`
    with tiles * d <= sms (one wave of blocks) that makes the longest
    block's work least: ksteps / d stages, and SPLIT_COST_STAGES * d for
    the block that sums the d partial sums."""
    if m > SPLIT_K_MAX_M or epilogue in JOINS or tiles >= sms:
        return 1
    best, best_cost = 1, ksteps
    for d in range(2, ksteps + 1):
        if ksteps % d == 0 and tiles * d <= sms:
            cost = ksteps // d + SPLIT_COST_STAGES * d
            if cost < best_cost:
                best, best_cost = d, cost
    return best


@functools.lru_cache(maxsize=4096)
def hopper_plan(m: int, k: int, n: int, epilogue: str,
                sms: int = SM_COUNT, split: bool = True,
                acc_dtype=torch.float32, res_bytes: int = 0) -> dict:
    """Launch configuration of the TMA route for an [m,k] @ [k,n] product
    (a conv: k = KH * KW * C, and `split` False: its kernel does not split
    K): tile width `bn` (256 for wide int8 outputs of many rows, 128, or
    64 for narrow N and for few rows whose 64-wide tiles fit one wave of
    blocks; at most 128 beside a bf16 residual and 64 beside an f32 one),
    K `ksteps`, `splits`, `resident` weights, `stages`, `bufs`, `grid`
    and `smem` bytes. The output buffers hold elements of
    OUT_BYTES[acc_dtype][epilogue] bytes, and a join's float residual
    `res_bytes` an element (`res_bytes()`)."""
    ob = OUT_BYTES[acc_dtype][epilogue]
    if m <= SPLIT_K_MAX_M:      # few rows: more tiles, in one wave
        bn = 64 if n < 128 or -(-m // TILE_M) * -(-n // 64) <= sms else 128
    elif n >= 256 and ob == 1:
        bn = 256
    else:
        bn = 128 if n >= 128 else 64
    if res_bytes:
        bn = min(bn, 128 // res_bytes * 2)
    m_tiles, n_tiles = -(-m // TILE_M), -(-n // bn)
    ksteps = -(-k // STAGE_K)
    splits = split_k(m, m_tiles * n_tiles, ksteps, epilogue, sms) \
        if split else 1
    resident = splits == 1 \
        and ksteps * n_tiles * bn * STAGE_K <= RESIDENT_LIMIT
    depths = _DEPTHS_JOIN_FLOAT if res_bytes else \
        _DEPTHS_JOIN if epilogue in JOINS else _DEPTHS
    for stages, bufs in depths:
        smem = tma_smem_bytes(bn, ob, stages, bufs, resident, ksteps, n_tiles,
                              res_bytes)
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"no pipeline depth fits {m}x{k}x{n} {epilogue} "
                         f"with tiles of {bn} columns")
    items = m_tiles * n_tiles * splits
    return dict(bn=bn, m_tiles=m_tiles, n_tiles=n_tiles, ksteps=ksteps,
                splits=splits, resident=resident, stages=stages, bufs=bufs,
                grid=min(items, sms), smem=smem)


# --------------------------------------------------------------------------
# plain versions


def _f32(v, dev) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=dev)


def fma_f32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """x * y + z rounded once to f32, for f32 tensors (broadcasting),
    as a hardware FMA rounds it. The product is exact in float64 (24 + 24
    significant bits); the sum s = p + z rounds in float64 with an error
    e that TwoSum recovers exactly; s rounds to the right f32 except
    when it lands exactly on a midpoint of two f32 values with e != 0,
    where the sign of e picks the neighbour."""
    p = x.double() * y.double()
    zd = z.double()
    s = p + zd
    pp = s - zd
    e = (p - pp) + (zd - (s - pp))
    r = s.to(torch.float32)
    rd = r.double()
    toward = torch.where(s > rd, torch.full_like(r, float('inf')),
                         torch.full_like(r, float('-inf')))
    other = torch.nextafter(r, toward)
    mid = (rd + other.double()) * 0.5
    up = (s == mid) & (s != rd) & (e != 0) \
        & (torch.sign(e) == torch.sign(s - rd))
    return torch.where(up, other, r)


def bf(x: torch.Tensor) -> torch.Tensor:
    """x widened to f32 first (exact for an integer-valued accumulator
    below 2^24; above it this is the first rounding), then rounded to
    bf16 (RNE) and widened back: f32(bf16(f32(x))), what the bf16 mode
    rounds at each step. Never rounds a wider value straight to bf16."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def _check_acc(acc_dtype) -> None:
    if acc_dtype not in ACC_DTYPES:
        raise ValueError(f"unknown accumulation mode {acc_dtype!r} "
                         f"{ACC_DTYPES}")


def epilogue_sum(acc: torch.Tensor, alpha, beta,
                 acc_dtype=torch.float32) -> torch.Tensor:
    """The epilogues' pre-activation sum s, f32: fma(f32(acc), alpha,
    beta) in the f32 mode (y = s), bf(bf(acc) * bf(alpha)) + bf(beta)
    in the bf16 mode (y = bf(s))."""
    if acc_dtype == torch.bfloat16:
        return bf(bf(acc) * bf(alpha)) + bf(beta)
    return fma_f32(acc.to(torch.float32), alpha, beta)


def epilogue_torch(acc: torch.Tensor, epilogue: str, alpha=None, beta=None,
                   inv_s_out=1.0, res=None, res_scale=1.0,
                   acc_dtype=torch.float32) -> torch.Tensor:
    """The epilogue on an exact accumulator (integer-valued, any dtype
    that holds it exactly, the output channel last), in the accumulation
    mode `acc_dtype` (f32 or bf16)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    _check_acc(acc_dtype)
    if epilogue == "s32":
        return acc.to(torch.int32)
    dev = acc.device
    s = epilogue_sum(acc, alpha, beta, acc_dtype)
    y = bf(s) if acc_dtype == torch.bfloat16 else s
    out = OUT_DTYPES[acc_dtype][epilogue]
    if epilogue == "f32":
        return y.to(out)
    if epilogue == "f32_sum":
        return s
    if epilogue == "f32_relu":
        return torch.clamp_min(y, 0.0).to(out)
    inv = _f32(inv_s_out, dev)
    if epilogue == "q8":
        return torch.clamp(torch.round(s * inv), -127, 127).to(torch.int8)
    if epilogue == "join_s8":
        r_i = torch.round(s * inv)
        sc_i = torch.round(res.to(torch.float32) * _f32(res_scale, dev))
        return torch.clamp(r_i + sc_i, 0, 127).to(torch.int8)
    if epilogue == "join":
        r = res.to(torch.float32)
        if acc_dtype == torch.bfloat16:
            y = bf(y + bf(r * bf(_f32(res_scale, dev))))
        else:
            y = y + r * _f32(res_scale, dev)
    y = torch.clamp_min(y, 0.0)
    return torch.clamp(torch.round(y * inv), 0, 127).to(torch.int8)


def gemm_s8_torch(a, b, epilogue="s32", alpha=None, beta=None,
                  inv_s_out=1.0, res=None, res_scale=1.0,
                  acc_dtype=torch.float32) -> torch.Tensor:
    """Plain version of gemm_s8: float64 accumulation, then the epilogue."""
    acc = a.to(torch.float64) @ b.to(torch.float64)
    return epilogue_torch(acc, epilogue, alpha, beta, inv_s_out, res,
                          res_scale, acc_dtype)


def conv_s8_torch(x, w, stride=1, padding=((0, 0), (0, 0)), epilogue="s32",
                  alpha=None, beta=None, inv_s_out=1.0, res=None,
                  res_scale=1.0, acc_dtype=torch.float32) -> torch.Tensor:
    """Plain version of conv_s8: float64 convolution (cuDNN off on the
    card: its algorithms may transform the operands, the native
    im2col + GEMM does not), then the epilogue."""
    (pt, pb), (pl, pr) = padding
    xd = F.pad(x.to(torch.float64).permute(0, 3, 1, 2), (pl, pr, pt, pb))
    wd = w.to(torch.float64).permute(3, 2, 0, 1)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xd, wd, stride=stride).permute(0, 2, 3, 1)
    return epilogue_torch(acc.contiguous(), epilogue, alpha, beta,
                          inv_s_out, res, res_scale, acc_dtype)


def pool_pads(n: int) -> tuple[int, int]:
    """(low, high) padding of a 3/2 'SAME' window over n elements: (0, 1)
    for even n, (1, 1) for odd n."""
    total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def maxpool_s8(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 'SAME' max over an int8 [B,H,W,C] tensor, padded with -128;
    through an exact float view (f16 on the card, whose max_pool2d takes
    no int8)."""
    ft = torch.float16 if x.is_cuda else torch.float32
    xc = x.permute(0, 3, 1, 2).to(ft)
    (pt, pb), (pl, pr) = pool_pads(xc.shape[2]), pool_pads(xc.shape[3])
    xc = F.pad(xc, (pl, pr, pt, pb), value=-128.0)
    return F.max_pool2d(xc, 3, 2).permute(0, 2, 3, 1).to(torch.int8) \
        .contiguous()


STEM_MODES = {"calibrated": 0, "shift128": 1}


def stem_input_s8(x: torch.Tensor, mode: str, mean, inv_s_in: float):
    """The stem's input quantize on u8 pixels [..., C] (12 packed or 3
    raw channels, `mean` per channel): (s8 tensor, the s8 value per
    channel that fills the conv's padding).
      calibrated  clip(rint((f32(x) - mean[c]) * inv_s_in), -127, 127),
                  the subtraction and the product each rounded to f32;
                  padding 0
      shift128    x - 128 (step 1.0, zero point 128); padding
                  rint(mean[c]) - 128, the value a zero of the molded
                  image maps to"""
    if mode not in STEM_MODES:
        raise ValueError(f"unknown stem mode {mode!r}")
    mean = torch.tensor(np.asarray(mean, np.float32), device=x.device)
    if mode == "shift128":
        q = (x.to(torch.int16) - 128).to(torch.int8)
        return q, (torch.round(mean) - 128).to(torch.int8)
    y = (x.to(torch.float32) - mean) * _f32(inv_s_in, x.device)
    q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return q, torch.zeros_like(mean, dtype=torch.int8)


def stem_s8_torch(x, w, alpha, beta, inv_s_out=1.0, mode="calibrated",
                  mean=(0.0,) * 12, inv_s_in=1.0,
                  acc_dtype=torch.float32) -> torch.Tensor:
    """Plain version of stem_s8, as the unfused composition: input
    quantize (f32 in both modes), the padding written out, conv_s8_torch
    with the q8_relu epilogue in the accumulation mode `acc_dtype`,
    maxpool_s8."""
    q, fill = stem_input_s8(x, mode, mean, inv_s_in)
    b, h, wd, c = q.shape
    xp = fill.expand(b, h + 3, wd + 3, c).contiguous()
    xp[:, 2:h + 2, 2:wd + 2] = q
    y = conv_s8_torch(xp, w, 1, ((0, 0), (0, 0)), "q8_relu", alpha, beta,
                      inv_s_out, acc_dtype=acc_dtype)
    return maxpool_s8(y)


def stem_kernel_7x7(w: torch.Tensor) -> torch.Tensor:
    """The 7x7 stem kernel [7,7,C,O] of an s2d stem kernel [4,4,4C,O]
    (HWIO): the inverse of `models/resnet.py::stem_kernel_to_s2d`,
    W[u, v, c, o] = W'[(u + 1) // 2, (v + 1) // 2, (dy * 2 + dx) * C + c,
    o] with dy = (u + 1) % 2, dx = (v + 1) % 2 (the rewrite's zeros
    dropped)."""
    c = w.shape[2] // 4
    u = torch.arange(7, device=w.device)
    r, d = (u + 1) // 2, (u + 1) % 2
    t = w[r[:, None], r[None, :]]                       # [7,7,4C,O]
    ch = (d[:, None] * 2 + d[None, :])[:, :, None] * c \
        + torch.arange(c, device=w.device)               # [7,7,C]
    return torch.gather(t, 2, ch[..., None].expand(7, 7, c, t.shape[3]))


def stem_s8_nhwc_torch(x, w7, alpha, beta, inv_s_out=1.0,
                       mode="calibrated", mean=(0.0,) * 3, inv_s_in=1.0,
                       acc_dtype=torch.float32) -> torch.Tensor:
    """Plain version of stem_s8's 'nhwc' route, as the `base` variant's
    unfused chain on the raw batch x [B,H,W,3] u8 with the 7x7 stem
    kernel w7 [7,7,3,64]: input quantize (`stem_input_s8`, `mean` per
    pixel channel), the (3,3) pads filled with the mode's value,
    conv_s8_torch 7x7/2 with the q8_relu epilogue in the accumulation
    mode `acc_dtype`, maxpool_s8."""
    q, fill = stem_input_s8(x, mode, mean, inv_s_in)
    b, h, wd, c = q.shape
    xp = fill.expand(b, h + 6, wd + 6, c).contiguous()
    xp[:, 3:h + 3, 3:wd + 3] = q
    y = conv_s8_torch(xp, w7, 2, ((0, 0), (0, 0)), "q8_relu", alpha, beta,
                      inv_s_out, acc_dtype=acc_dtype)
    return maxpool_s8(y)


# --------------------------------------------------------------------------
# wrappers


def _check_epilogue(dev, m, n, epilogue, alpha, beta, res,
                    acc_dtype=torch.float32):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue != "s32":
        for name, v in (("alpha", alpha), ("beta", beta)):
            if not (isinstance(v, torch.Tensor) and v.shape == (n,)
                    and v.dtype == torch.float32 and v.is_contiguous()
                    and v.device == dev):
                raise ValueError(f"{name} must be a contiguous [{n}] float32 "
                                 f"tensor on {dev}")
    if epilogue in JOINS:
        types = (torch.int8, torch.float32, OUT_DTYPES[acc_dtype]["f32"])
        if not (isinstance(res, torch.Tensor) and res.dtype in types
                and res.numel() == m * n and res.shape[-1] == n
                and res.is_contiguous() and res.device == dev):
            raise ValueError(f"res must be a contiguous tensor of {m}x{n} "
                             f"elements of {types} on {dev}")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _raise_if(rc, lib, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ursonet_int8_error_string(rc).decode())


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _pick_route(name, route, auto):
    if route is None:
        return auto
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}")
    if route == "tma" and auto != "tma":
        raise ValueError(f"{name}: the tma route does not take these shapes "
                         "or this alignment")
    return route


def _record(name, epilogue, res, shapes) -> None:
    """Counts a launch: `launches`, `join_launches`, `calls`."""
    launches[name] += 1
    if epilogue in JOINS:
        key = (name, epilogue, res_kind(res))
        join_launches[key] = join_launches.get(key, 0) + 1
        shapes = dict(shapes, res=res_kind(res))
    if calls is not None:
        calls.append((name, shapes))


# The kernels' residual types (csrc/int8_common.cuh ResType).
RES_TYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def _res_type(epilogue, res) -> int:
    """The residual's type code for a join, 0 without a join."""
    return RES_TYPES[res.dtype] if epilogue in JOINS else 0


@functools.lru_cache(maxsize=None)
def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def gemm_s8(a: torch.Tensor, b: torch.Tensor, epilogue: str = "s32",
            alpha=None, beta=None, inv_s_out: float = 1.0, res=None,
            res_scale: float = 1.0, route=None,
            acc_dtype=torch.float32) -> torch.Tensor:
    """out[M,N] = epilogue(a[M,K] s8 @ b[K,N] s8) in the accumulation
    mode `acc_dtype`. `route`: None picks by shape (`gemm_route`), or one
    of ROUTES."""
    _check_acc(acc_dtype)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm_s8_torch(a, b, epilogue, alpha, beta, inv_s_out, res,
                             res_scale, acc_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if a.dim() != 2 or a.dtype != torch.int8 or not a.is_contiguous():
        raise ValueError("a must be a contiguous [M,K] int8 tensor, got "
                         f"{tuple(a.shape)} {a.dtype}")
    m, k = a.shape
    if b.dim() != 2 or b.shape[0] != k or b.dtype != torch.int8 \
            or not b.t().is_contiguous() or b.device != a.device:
        raise ValueError(f"b must be a [{k},N] int8 view of a contiguous "
                         f"[N,{k}] tensor on {a.device} (kernel_layout), got "
                         f"{tuple(b.shape)} {b.dtype} strides {b.stride()}")
    n = b.shape[1]
    if m == 0 or k == 0 or n == 0:
        raise ValueError(f"empty product {m}x{k} @ {k}x{n}")
    _check_epilogue(a.device, m, n, epilogue, alpha, beta, res, acc_dtype)
    rt = _res_type(epilogue, res)
    rb = res_bytes(epilogue, getattr(res, "dtype", None))
    out = torch.empty((m, n), dtype=OUT_DTYPES[acc_dtype][epilogue],
                      device=a.device)
    lib = cuda_build.load("int8_gemm", _bind_gemm)
    route = _pick_route("gemm_s8", route, gemm_route(
        m, k, n, epilogue, _aligned(a, b, out, res), acc_dtype))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    bf16 = int(acc_dtype == torch.bfloat16)
    if route == "tma":
        plan = hopper_plan(m, k, n, epilogue, _sms(a.device),
                           acc_dtype=acc_dtype,
                           res_bytes=rb)
        partial = counters = None
        if plan["splits"] > 1:
            partial = torch.empty((plan["splits"], m, n), dtype=torch.int32,
                                  device=a.device)
            counters = torch.zeros(2 * plan["m_tiles"] * plan["n_tiles"],
                                   dtype=torch.int32, device=a.device)
        rc = lib.ursonet_gemm_s8_tma(
            a.data_ptr(), b.data_ptr(), m, n, k, EPILOGUES[epilogue], bf16,
            _ptr(alpha), _ptr(beta), float(inv_s_out), _ptr(res), rt,
            float(res_scale), out.data_ptr(), plan["bn"], plan["stages"],
            plan["bufs"], int(plan["resident"]), plan["splits"],
            _ptr(partial), _ptr(counters), plan["grid"], a.device.index,
            stream)
    else:
        rc = lib.ursonet_gemm_s8(
            a.data_ptr(), b.data_ptr(), m, n, k,
            int(k % 16 == 0 and a.data_ptr() % 16 == 0),
            int(k % 16 == 0 and b.data_ptr() % 16 == 0),
            EPILOGUES[epilogue], bf16, _ptr(alpha), _ptr(beta),
            float(inv_s_out), _ptr(res), rt, float(res_scale),
            out.data_ptr(), tile_for(m, n), a.device.index, stream)
    _raise_if(rc, lib, "gemm_s8")
    _record("gemm_s8", epilogue, res, dict(
        m=m, k=k, n=n, epilogue=epilogue, route=route,
        acc=ACC_NAMES[acc_dtype]))
    return out


def conv_out_hw(h, w, kh, kw, stride, padding):
    (pt, pb), (pl, pr) = padding
    return (h + pt + pb - kh) // stride + 1, (w + pl + pr - kw) // stride + 1


def conv_s8(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
            padding=((0, 0), (0, 0)), epilogue: str = "s32", alpha=None,
            beta=None, inv_s_out: float = 1.0, res=None,
            res_scale: float = 1.0, route=None,
            acc_dtype=torch.float32) -> torch.Tensor:
    """out[B,OH,OW,N] = epilogue(conv(x NHWC s8, w HWIO s8)) in the
    accumulation mode `acc_dtype`, explicit ((top, bottom), (left,
    right)) zero pads. `route`: None picks by shape (`conv_route`), or
    one of ROUTES."""
    (pt, pb), (pl, pr) = padding
    _check_acc(acc_dtype)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv_s8_torch(x, w, stride, padding, epilogue, alpha, beta,
                             inv_s_out, res, res_scale, acc_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.int8 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [B,H,W,C] int8 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    bsz, h, wd, c = x.shape
    if w.dim() != 4 or w.shape[2] != c or w.dtype != torch.int8 \
            or not w.permute(3, 0, 1, 2).is_contiguous() \
            or w.device != x.device:
        raise ValueError(f"w must be a [KH,KW,{c},N] int8 view of a "
                         f"contiguous [N,KH,KW,{c}] tensor on {x.device} "
                         f"(kernel_layout), got {tuple(w.shape)} {w.dtype}")
    kh, kw, _, n = w.shape
    if stride < 1 or min(pt, pb, pl, pr) < 0:
        raise ValueError(f"bad stride {stride} or padding {padding}")
    oh, ow = conv_out_hw(h, wd, kh, kw, stride, padding)
    if oh < 1 or ow < 1:
        raise ValueError(f"empty output for {h}x{wd} and a {kh}x{kw} kernel")
    m = bsz * oh * ow
    _check_epilogue(x.device, m, n, epilogue, alpha, beta, res, acc_dtype)
    rt = _res_type(epilogue, res)
    rb = res_bytes(epilogue, getattr(res, "dtype", None))
    out = torch.empty((bsz, oh, ow, n),
                      dtype=OUT_DTYPES[acc_dtype][epilogue], device=x.device)
    lib = cuda_build.load("int8_conv", _bind_conv)
    route = _pick_route("conv_s8", route, conv_route(
        c, n, kh * kw, bsz * (h + pt + pb) * (wd + pl + pr) * c,
        _aligned(x, w, out, res)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16 = int(acc_dtype == torch.bfloat16)
    if route == "tma":
        plan = hopper_plan(m, kh * kw * c, n, epilogue, _sms(x.device),
                           split=False, acc_dtype=acc_dtype,
                           res_bytes=rb)
        rc = lib.ursonet_conv_s8_tma(
            x.data_ptr(), w.data_ptr(), bsz, h, wd, c, n, kh, kw, stride,
            pt, pb, pl, pr, EPILOGUES[epilogue], bf16, _ptr(alpha),
            _ptr(beta), float(inv_s_out), _ptr(res), rt, float(res_scale),
            out.data_ptr(),
            plan["bn"], plan["stages"], plan["bufs"], int(plan["resident"]),
            plan["grid"], x.device.index, stream)
    else:
        vec = c % 16 == 0
        rc = lib.ursonet_conv_s8(
            x.data_ptr(), w.data_ptr(), bsz, h, wd, c, n, kh, kw, stride,
            pt, pb, pl, pr, int(vec and x.data_ptr() % 16 == 0),
            int((kh * kw * c) % 16 == 0 and w.data_ptr() % 16 == 0),
            EPILOGUES[epilogue], bf16, _ptr(alpha), _ptr(beta),
            float(inv_s_out), _ptr(res), rt, float(res_scale),
            out.data_ptr(), tile_for(m, n), x.device.index, stream)
    _raise_if(rc, lib, "conv_s8")
    _record("conv_s8", epilogue, res, dict(
        b=bsz, h=h, w=wd, c=c, kh=kh, kw=kw, n=n, stride=stride,
        padding=padding, epilogue=epilogue, route=route,
        acc=ACC_NAMES[acc_dtype]))
    return out


def stem_s8(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
            beta: torch.Tensor, inv_s_out: float = 1.0,
            mode: str = "calibrated", mean=(0.0,) * 12,
            inv_s_in: float = 1.0, route=None,
            acc_dtype=torch.float32) -> torch.Tensor:
    """The fused int8 stem in one launch: out[B,ceil(H2/2),ceil(W2/2),64]
    s8 = maxpool3x3/2_SAME(q8_relu(conv4x4/1(quantize(x)))) for
    space-to-depth u8 pixels x [B,H2,W2,12] and the s2d stem kernel w
    [4,4,12,64] s8 (HWIO view, `kernel_layout`), pads (2,1),(2,1). For
    the raw batch x [B,H,W,3] u8 ('nhwc' route) the same with x packed
    by `space_to_depth2` inside the kernel: the 7x7/2 stem with pads
    (3,3), whose kernel `stem_kernel_7x7(w)` is. `mode` picks the input
    quantize and the padding value (`stem_input_s8`; `mean` per packed
    channel, or per pixel channel for the raw batch); the epilogue is
    q8_relu with alpha, beta and inv_s_out in the accumulation mode
    `acc_dtype`. The 64-wide conv output stays in shared memory.
    `route`: None picks by shape (`stem_route`), or one of ROUTES on
    packed pixels, 'nhwc' on the raw batch."""
    _check_acc(acc_dtype)
    raw = x.dim() == 4 and x.shape[3] == 3
    if x.device.type == "cpu" and w.device.type == "cpu":
        if raw:
            return stem_s8_nhwc_torch(x, stem_kernel_7x7(w), alpha, beta,
                                      inv_s_out, mode, mean, inv_s_in,
                                      acc_dtype)
        return stem_s8_torch(x, w, alpha, beta, inv_s_out, mode, mean,
                             inv_s_in, acc_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if mode not in STEM_MODES:
        raise ValueError(f"unknown stem mode {mode!r}")
    if x.dim() != 4 or x.shape[3] not in (3, 12) or x.dtype != torch.uint8 \
            or not x.is_contiguous() or x.data_ptr() % 4:
        raise ValueError("x must be a contiguous [B,H/2,W/2,12] or [B,H,W,3] "
                         f"uint8 tensor, got {tuple(x.shape)} {x.dtype}")
    if tuple(w.shape) != (4, 4, 12, 64) or w.dtype != torch.int8 \
            or not w.permute(3, 0, 1, 2).is_contiguous() \
            or w.device != x.device or w.data_ptr() % 16:
        raise ValueError("w must be a [4,4,12,64] int8 view of a contiguous "
                         f"[64,4,4,12] tensor on {x.device} (kernel_layout), "
                         f"got {tuple(w.shape)} {w.dtype}")
    mean = np.ascontiguousarray(np.asarray(mean, np.float32))
    if mean.shape != (x.shape[3],):
        raise ValueError(f"mean must hold {x.shape[3]} values, got "
                         f"{mean.shape}")
    bsz, h, wd, _ = x.shape
    if bsz == 0 or h == 0 or wd == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    h2, w2 = (-(-h // 2), -(-wd // 2)) if raw else (h, wd)
    _check_epilogue(x.device, 0, 64, "q8_relu", alpha, beta, None)
    out = torch.empty((bsz, -(-h2 // 2), -(-w2 // 2), 64), dtype=torch.int8,
                      device=x.device)
    if raw:
        if stem_route(wd, _aligned(x, w, out), 3, h) != "nhwc" \
                or route not in (None, "nhwc"):
            raise ValueError(f"stem_s8: the nhwc route does not take "
                             f"{tuple(x.shape)} (H even, W % 16 == 0, "
                             f"16-byte aligned) or route {route!r}")
        route, mean = "nhwc", np.tile(mean, 4)
    else:
        route = _pick_route("stem_s8", route,
                            stem_route(w2, _aligned(x, w, out)))
    lib = cuda_build.load("int8_stem", _bind_stem)
    launch = {"nhwc": lib.ursonet_stem_s8_nhwc,
              "tma": lib.ursonet_stem_s8_tma}.get(route, lib.ursonet_stem_s8)
    rc = launch(
        x.data_ptr(), w.data_ptr(), bsz, h, wd, STEM_MODES[mode],
        mean.ctypes.data, float(inv_s_in), alpha.data_ptr(), beta.data_ptr(),
        float(inv_s_out), int(acc_dtype == torch.bfloat16), out.data_ptr(),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_if(rc, lib, "stem_s8")
    if route == "nhwc":
        launches["stem_s8_nhwc"] += 1
    _record("stem_s8", "q8_relu", None, dict(
        b=bsz, h2=h2, w2=w2, c=x.shape[3], mode=mode, route=route,
        acc=ACC_NAMES[acc_dtype]))
    return out
