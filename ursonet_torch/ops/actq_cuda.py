"""The kernels of TRAIN_ACT_Q8 (`csrc/actq.cu`), their wrappers and their
plain PyTorch versions:

    quant_s8(t, 'x')                      x [N,...] f32/bf16 -> (q int8 of
                                          x's shape, scale [N] f32)
    quant_s8(t, 'g', scale, ...)          g [N,Co,Ho,Wo] -> (qgt [Co,Kp]
                                          int8, alpha [alpha_len] f32 = sg)
    quant_s8(t, 'dequant', scale, dtype)  q int8 -> dtype(q) * dtype(scale)
    wgrad_s8(q, qgt, kernel_hw, stride, pads, alpha=None)
                                          -> dw [Co,Ci,KH,KW]: int32 sums,
                                          or f32(acc) * alpha with alpha

The formulas are the JAX package's (`ursonet_tpu/models/actq.py`):
'x' is `_quantize_per_sample` (per-sample max|x|, scale =
max(amax, 1e-12) / 127 computed in x's type, so rounded to bf16 for a
bf16 x, then q = clip(rint(f32(x) / scale), +-127)); 'g' the
output-gradient quantize of `_q8w8_bwd` (G = f32(g) * scale[n], sg =
max(max|G|, 1e-30) / 127 over the whole tensor, qg = clip(rint(G / sg),
+-127)); 'dequant' the copy `q.astype(dt) * scale.astype(dt)` of
`_q8_bwd`; wgrad_s8 `_wgrad_conv` at int32 with its rescale f32(acc) *
sg. `qgt` is qg in the layout of the wgrad product: [Co, Kp], column
k = n * Ho * Wo + oh * Wo + ow, zero for k >= N * Ho * Wo, Kp that
count rounded up to 16 (`padded_k`).

'g' takes a process `group`: the max|G| of every rank of the group is
all-reduced (MAX) between the reduction and the quantize, so that
data-parallel ranks quantize with the global batch's sg, as the JAX
package's GSPMD step does.

wgrad_s8 on the card gathers the int8 patch matrix P [Ci*KH*KW, Kp]
(`csrc/actq.cu`, one launch) and multiplies qgt @ P^T with `gemm_s8`
(`ops/int8_cuda.py`: the TMA + wgmma route where TMA can address the
shapes, else the mma.sync one) in its 's32' epilogue, or its 'f32'
epilogue with alpha = sg and beta = 0, one rounding of f32(acc) * sg.
Its sums fit int32 where N * Ho * Wo <= INT32_SAFE_ACC (the caller's
guard, JAX's shape branch).

On a CUDA tensor each wrapper launches its kernels or raises; on a CPU
tensor it runs the plain version (wgrad_s8_torch: a float64
`conv2d_weight`, exact since |acc| < 2^31 < 2^53). Each wrapper call
adds one to `launches['quant_s8']` (and to `mode_launches[mode]`) or
`launches['wgrad_s8']` where it launches on the card; each call appends
its arguments to `calls` when that is a list; wgrad_s8's GEMM counts in
`int8_cuda.launches['gemm_s8']` as well.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ursonet_torch.ops import cuda_build, int8_cuda

MODES = ("x", "g", "dequant")
# Largest contraction whose worst case (every |q| = 127, one sign) fits
# int32: floor((2^31 - 1) / 127^2) (`actq.py::_INT32_SAFE_ACC`).
INT32_SAFE_ACC = (2 ** 31 - 1) // (127 * 127)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Wrapper calls that launched on the card since the last reset_counts().
launches = {"quant_s8": 0, "wgrad_s8": 0}
mode_launches = {m: 0 for m in MODES}
# None, or a list that each call appends (name, arguments) to:
# quant_s8's mode, shape and dtype, wgrad_s8's geometry (what chip_smoke.py
# holds against the plain versions and times at the main path's shapes).
calls = None


def reset_counts() -> None:
    for d in (launches, mode_launches):
        for k in d:
            d[k] = 0


def _bind(lib) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ursonet_actq_amax.argtypes = [P, I, P, I, L, P, I, P]
    lib.ursonet_actq_quant_x.argtypes = [P, I, P, I, L, P, P, P]
    lib.ursonet_actq_quant_g.argtypes = [P, I, P, P, I, I, I, I, P, P, I, P]
    lib.ursonet_actq_dequant.argtypes = [P, P, I, L, P, I, P]
    lib.ursonet_actq_im2col.argtypes = [P] + [I] * 12 + [P, P]
    for fn in (lib.ursonet_actq_amax, lib.ursonet_actq_quant_x,
               lib.ursonet_actq_quant_g, lib.ursonet_actq_dequant,
               lib.ursonet_actq_im2col):
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


def _bshape(scale, ndim):
    return scale.view((-1,) + (1,) * (ndim - 1))


# --------------------------------------------------------------------------
# plain versions


def _round_clip(v):
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def quant_x_torch(x):
    """(q, scale) of `_quantize_per_sample`: the max and the scale in x's
    type, the quantize in f32."""
    amax = x.abs().amax(dim=tuple(range(1, x.dim())))
    scale = (torch.clamp_min(amax, 1e-12) / 127.0).to(torch.float32)
    return _round_clip(x.to(torch.float32) / _bshape(scale, x.dim())), scale


def _qgt(qg, kp):
    """qg [N,Co,Ho,Wo] -> [Co, kp] (column n * Ho * Wo + p, zero padded)."""
    n, co = qg.shape[:2]
    k = qg.numel() // co
    out = torch.zeros((co, kp), dtype=torch.int8, device=qg.device)
    out[:, :k] = qg.permute(1, 0, 2, 3).reshape(co, k)
    return out


def quant_g_torch(g, scale, group=None, alpha_len: int = 1):
    """(qgt, alpha) of the output-gradient quantize: sg over the whole
    tensor (over `group`'s ranks too), alpha = sg `alpha_len` times."""
    G = g.to(torch.float32) * _bshape(scale, g.dim())
    amax = G.abs().amax().reshape(1)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    sg = torch.clamp_min(amax, 1e-30) / 127.0
    qg = _round_clip(G / sg)
    return (_qgt(qg, padded_k(qg.numel() // qg.shape[1])),
            sg.reshape(1).expand(alpha_len).contiguous())


def dequant_torch(q, scale, dtype):
    """dtype(q) * dtype(scale[n]), rounded in dtype."""
    return q.to(dtype) * _bshape(scale.to(dtype), q.dim())


def quant_s8_torch(t, mode, scale=None, dtype=None, group=None,
                   alpha_len: int = 1):
    """Plain version of quant_s8."""
    if mode == "x":
        return quant_x_torch(t)
    if mode == "g":
        return quant_g_torch(t, scale, group, alpha_len)
    if mode == "dequant":
        return dequant_torch(t, scale, dtype)
    raise ValueError(f"unknown quant_s8 mode {mode!r} {MODES}")


def qg_of(qgt, n, ho, wo):
    """qgt [Co, Kp] back to qg [N, Co, Ho, Wo]."""
    co = qgt.shape[0]
    return qgt[:, :n * ho * wo].reshape(co, n, ho, wo).permute(1, 0, 2, 3)


def wgrad_s8_torch(q, qgt, kernel_hw, stride, pads):
    """Plain version of wgrad_s8's sums: int32 [Co, Ci, KH, KW] from a
    float64 `conv2d_weight` (cuDNN off on the card, as conv_s8_torch)."""
    n, c, h, w = q.shape
    ho, wo = int8_cuda.conv_out_hw(h, w, *kernel_hw, stride, pads)
    qg = qg_of(qgt, n, ho, wo).to(torch.float64)
    (pt, pb), (pl, pr) = pads
    xd = F.pad(q.to(torch.float64), (pl, pr, pt, pb))
    with torch.backends.cudnn.flags(enabled=False):
        acc = torch.nn.grad.conv2d_weight(
            xd, (qgt.shape[0], c) + tuple(kernel_hw), qg, stride=stride)
    return acc.round().to(torch.int32)


def im2col_torch(q, kernel_hw, stride, pads):
    """Plain version of wgrad_s8's gather: P [Ci*KH*KW, Kp] int8."""
    n, c, h, w = q.shape
    kh, kw = kernel_hw
    ho, wo = int8_cuda.conv_out_hw(h, w, kh, kw, stride, pads)
    (pt, pb), (pl, pr) = pads
    cols = F.unfold(F.pad(q.to(torch.float32), (pl, pr, pt, pb)),
                    (kh, kw), stride=stride)           # [N, C*KH*KW, HoWo]
    k = n * ho * wo
    out = torch.zeros((c * kh * kw, padded_k(k)), dtype=torch.int8,
                      device=q.device)
    out[:, :k] = cols.permute(1, 0, 2).reshape(c * kh * kw, k) \
        .to(torch.int8)
    return out


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


def quant_s8(t, mode, scale=None, dtype=None, group=None,
             alpha_len: int = 1):
    """The quantize kernels' three modes (module docstring); on a CPU
    tensor, quant_s8_torch."""
    if mode not in MODES:
        raise ValueError(f"unknown quant_s8 mode {mode!r} {MODES}")
    if calls is not None:
        calls.append(("quant_s8", dict(mode=mode, shape=tuple(t.shape),
                                       dtype=t.dtype, out_dtype=dtype)))
    if t.device.type == "cpu":
        return quant_s8_torch(t, mode, scale, dtype, group, alpha_len)
    lib = _lib()
    n = t.shape[0]
    per = t.numel() // n
    st = _stream(t)
    if mode == "x":
        _check_cuda("quant_s8", t)
        _check_float("quant_s8", t)
        amax = torch.zeros(n, dtype=torch.int32, device=t.device)
        q = torch.empty(t.shape, dtype=torch.int8, device=t.device)
        out_scale = torch.empty(n, dtype=torch.float32, device=t.device)
        _raise_if(lib.ursonet_actq_amax(t.data_ptr(), _DTYPES[t.dtype], None,
                                        n, per, amax.data_ptr(), 1, st),
                  lib, "quant_s8")
        _raise_if(lib.ursonet_actq_quant_x(
            t.data_ptr(), _DTYPES[t.dtype], amax.data_ptr(), n, per,
            q.data_ptr(), out_scale.data_ptr(), st), lib, "quant_s8")
        out = (q, out_scale)
    elif mode == "g":
        _check_cuda("quant_s8", t, scale)
        _check_float("quant_s8", t)
        if t.dim() != 4 or scale.shape != (n,) \
                or scale.dtype != torch.float32:
            raise ValueError("quant_s8 'g': g [N,Co,Ho,Wo] and scale [N] "
                             "float32")
        co, hw = t.shape[1], t.shape[2] * t.shape[3]
        kp = padded_k(n * hw)
        amax = torch.zeros(1, dtype=torch.int32, device=t.device)
        qgt = torch.empty((co, kp), dtype=torch.int8, device=t.device)
        alpha = torch.empty(alpha_len, dtype=torch.float32, device=t.device)
        _raise_if(lib.ursonet_actq_amax(t.data_ptr(), _DTYPES[t.dtype],
                                        scale.data_ptr(), n, per,
                                        amax.data_ptr(), 0, st),
                  lib, "quant_s8")
        if group is not None:
            # non-negative floats order as their bits: MAX on the int32 bits
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        _raise_if(lib.ursonet_actq_quant_g(
            t.data_ptr(), _DTYPES[t.dtype], scale.data_ptr(),
            amax.data_ptr(), n, co, hw, kp, qgt.data_ptr(), alpha.data_ptr(),
            alpha_len, st), lib, "quant_s8")
        out = (qgt, alpha)
    else:
        _check_cuda("quant_s8", t, scale)
        if t.dtype != torch.int8 or dtype not in _DTYPES \
                or scale.shape != (n,):
            raise ValueError("quant_s8 'dequant': int8 q, scale [N] and a "
                             "float32 or bfloat16 dtype")
        out = torch.empty(t.shape, dtype=dtype, device=t.device)
        _raise_if(lib.ursonet_actq_dequant(
            t.data_ptr(), scale.data_ptr(), n, per, out.data_ptr(),
            _DTYPES[dtype], st), lib, "quant_s8")
    launches["quant_s8"] += 1
    mode_launches[mode] += 1
    return out


def wgrad_s8(q, qgt, kernel_hw, stride, pads, alpha=None):
    """dw [Co, Ci, KH, KW] = sum over n, oh, ow of q[n, ci, oh*s+dy-pt,
    ow*s+dx-pl] * qg[n, co, oh, ow]: int32, or f32(acc) * alpha[r] (r =
    ci*KH*KW + dy*KW + dx) when `alpha` is given. `q` [N,Ci,H,W] int8,
    `qgt` [Co, Kp] int8 (quant_s8 'g'), pads ((pt, pb), (pl, pr))."""
    n, c, h, w = q.shape
    kh, kw = kernel_hw
    ho, wo = int8_cuda.conv_out_hw(h, w, kh, kw, stride, pads)
    co, kp = qgt.shape
    if kp != padded_k(n * ho * wo):
        raise ValueError(f"wgrad_s8: qgt has {kp} columns, the geometry "
                         f"needs {padded_k(n * ho * wo)}")
    r = c * kh * kw
    if calls is not None:
        calls.append(("wgrad_s8", dict(q=tuple(q.shape), co=co,
                                       kernel_hw=(kh, kw), stride=stride,
                                       pads=pads)))
    if q.device.type == "cpu":
        acc = wgrad_s8_torch(q, qgt, kernel_hw, stride, pads)
        if alpha is None:
            return acc
        return acc.to(torch.float32) * alpha.view(1, c, kh, kw)
    _check_cuda("wgrad_s8", q, qgt)
    if q.dtype != torch.int8 or qgt.dtype != torch.int8:
        raise ValueError("wgrad_s8: int8 q and qgt")
    lib = _lib()
    p = torch.empty((r, kp), dtype=torch.int8, device=q.device)
    (pt, _), (pl, _) = pads
    _raise_if(lib.ursonet_actq_im2col(
        q.data_ptr(), n, c, h, w, kh, kw, stride, pt, pl, ho, wo, kp,
        p.data_ptr(), _stream(q)), lib, "wgrad_s8")
    launches["wgrad_s8"] += 1
    if alpha is None:
        out = int8_cuda.gemm_s8(qgt, p.t(), "s32")
    else:
        beta = torch.zeros(r, dtype=torch.float32, device=q.device)
        out = int8_cuda.gemm_s8(qgt, p.t(), "f32", alpha, beta)
    return out.view(co, c, kh, kw)
