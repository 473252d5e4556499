"""int8 GEMM and int8 convolution with fused epilogues: the CUDA kernels
`csrc/int8_gemm.cu` and `csrc/int8_conv.cu`, their wrappers, and their
plain PyTorch versions.

    gemm_s8(a, b, epilogue, ...)   a [M,K] s8 @ b [K,N] s8 -> [M,N]
    conv_s8(x, w, stride, padding, epilogue, ...)
                                   x [B,H,W,C] s8 (NHWC), w [KH,KW,C,N] s8
                                   (HWIO) -> [B,OH,OW,N]

They are the Hopper ports of the Pallas TPU kernels
`tools/probe_pallas_int8_matmul.py::_matmul_kernel` and
`tools/probe_pallas_c2.py::matmul_requant_kernel` (gemm_s8) and
`tools/probe_pallas_conv3.py::_conv_kernel` (conv_s8). The int8 serving
path (`models/quant.py`) reaches only these two on the card.

Epilogues, with y = fma(f32(acc), alpha[n], beta[n]) (one rounding):

    s32       acc (int32)
    f32       y
    f32_relu  max(y, 0)
    q8_relu   clip(rint(max(y, 0) * inv_s_out), 0, 127)          (int8)
    q8        clip(rint(y * inv_s_out), -127, 127)               (int8)
    join      clip(rint(max(y + f32(res) * res_scale, 0) * inv_s_out),
                   0, 127)                                        (int8)

That is the arithmetic XLA compiles the JAX package's Int8Ops into
(measured on the CPU against the whole model): it contracts
acc * alpha + beta into an FMA, adds the dequantized residual with its
product and sum rounded separately, and turns the division by a
constant step into a multiply by `inv_s_out` = f32(1 / step). The
probes' pre-scaled form is inv_s_out = 1.

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
shapes there (what chip_smoke.py times at the serving path's shapes).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ursonet_torch.ops import cuda_build

EPILOGUES = {"s32": 0, "f32": 1, "f32_relu": 2, "q8_relu": 3, "q8": 4,
             "join": 5}
OUT_DTYPES = {"s32": torch.int32, "f32": torch.float32,
              "f32_relu": torch.float32, "q8_relu": torch.int8,
              "q8": torch.int8, "join": torch.int8}
# Kernel launches since the last reset_counts(), by kernel name.
launches = {"gemm_s8": 0, "conv_s8": 0}
# None, or a list that each launch appends (name, shapes, epilogue) to.
calls = None


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0


def _bind_gemm(lib) -> None:
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ursonet_gemm_s8.argtypes = [P, P, I, I, I, I, I, I, P, P, Fl, P, Fl,
                                    P, I, I, P]
    lib.ursonet_gemm_s8.restype = I
    lib.ursonet_int8_error_string.argtypes = [I]
    lib.ursonet_int8_error_string.restype = ctypes.c_char_p


def _bind_conv(lib) -> None:
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ursonet_conv_s8.argtypes = [P, P] + [I] * 14 + [I, P, P, Fl, P, Fl,
                                                        P, I, I, P]
    lib.ursonet_conv_s8.restype = I
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
    """Tile configuration of csrc/int8_common.cuh for an [m, n] output:
    2 (64x64) for few rows (the head denses), 1 (128x64) for narrow N,
    else 0 (128x128)."""
    if m <= 1024:
        return 2
    if n <= 64:
        return 1
    return 0


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


def epilogue_torch(acc: torch.Tensor, epilogue: str, alpha=None, beta=None,
                   inv_s_out=1.0, res=None, res_scale=1.0) -> torch.Tensor:
    """The epilogue on an exact accumulator (integer-valued, any dtype
    that holds it exactly, the output channel last)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue == "s32":
        return acc.to(torch.int32)
    dev = acc.device
    y = fma_f32(acc.to(torch.float32), alpha, beta)
    if epilogue == "f32":
        return y
    if epilogue == "f32_relu":
        return torch.clamp_min(y, 0.0)
    inv = _f32(inv_s_out, dev)
    if epilogue == "q8":
        return torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8)
    if epilogue == "join":
        y = torch.clamp_min(y + res.to(torch.float32) * _f32(res_scale, dev),
                            0.0)
    else:
        y = torch.clamp_min(y, 0.0)
    return torch.clamp(torch.round(y * inv), 0, 127).to(torch.int8)


def gemm_s8_torch(a, b, epilogue="s32", alpha=None, beta=None,
                  inv_s_out=1.0, res=None, res_scale=1.0) -> torch.Tensor:
    """Plain version of gemm_s8: float64 accumulation, then the epilogue."""
    acc = a.to(torch.float64) @ b.to(torch.float64)
    return epilogue_torch(acc, epilogue, alpha, beta, inv_s_out, res,
                          res_scale)


def conv_s8_torch(x, w, stride=1, padding=((0, 0), (0, 0)), epilogue="s32",
                  alpha=None, beta=None, inv_s_out=1.0, res=None,
                  res_scale=1.0) -> torch.Tensor:
    """Plain version of conv_s8: float64 convolution (cuDNN off on the
    card: its algorithms may transform the operands, the native
    im2col + GEMM does not), then the epilogue."""
    (pt, pb), (pl, pr) = padding
    xd = F.pad(x.to(torch.float64).permute(0, 3, 1, 2), (pl, pr, pt, pb))
    wd = w.to(torch.float64).permute(3, 2, 0, 1)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xd, wd, stride=stride).permute(0, 2, 3, 1)
    return epilogue_torch(acc.contiguous(), epilogue, alpha, beta,
                          inv_s_out, res, res_scale)


# --------------------------------------------------------------------------
# wrappers


def _check_epilogue(dev, m, n, epilogue, alpha, beta, res):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue != "s32":
        for name, v in (("alpha", alpha), ("beta", beta)):
            if not (isinstance(v, torch.Tensor) and v.shape == (n,)
                    and v.dtype == torch.float32 and v.is_contiguous()
                    and v.device == dev):
                raise ValueError(f"{name} must be a contiguous [{n}] float32 "
                                 f"tensor on {dev}")
    if epilogue == "join":
        if not (isinstance(res, torch.Tensor) and res.dtype == torch.int8
                and res.numel() == m * n and res.shape[-1] == n
                and res.is_contiguous() and res.device == dev):
            raise ValueError(f"res must be a contiguous int8 tensor of "
                             f"{m}x{n} elements on {dev}")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _raise_if(rc, lib, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ursonet_int8_error_string(rc).decode())


def gemm_s8(a: torch.Tensor, b: torch.Tensor, epilogue: str = "s32",
            alpha=None, beta=None, inv_s_out: float = 1.0, res=None,
            res_scale: float = 1.0) -> torch.Tensor:
    """out[M,N] = epilogue(a[M,K] s8 @ b[K,N] s8)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm_s8_torch(a, b, epilogue, alpha, beta, inv_s_out, res,
                             res_scale)
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
    _check_epilogue(a.device, m, n, epilogue, alpha, beta, res)
    out = torch.empty((m, n), dtype=OUT_DTYPES[epilogue], device=a.device)
    lib = cuda_build.load("int8_gemm", _bind_gemm)
    tile = tile_for(m, n)
    rc = lib.ursonet_gemm_s8(
        a.data_ptr(), b.data_ptr(), m, n, k,
        int(k % 16 == 0 and a.data_ptr() % 16 == 0),
        int(k % 16 == 0 and b.data_ptr() % 16 == 0),
        EPILOGUES[epilogue], _ptr(alpha), _ptr(beta), float(inv_s_out),
        _ptr(res), float(res_scale), out.data_ptr(), tile, a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_if(rc, lib, "gemm_s8")
    launches["gemm_s8"] += 1
    if calls is not None:
        calls.append(("gemm_s8", dict(m=m, k=k, n=n, epilogue=epilogue)))
    return out


def conv_out_hw(h, w, kh, kw, stride, padding):
    (pt, pb), (pl, pr) = padding
    return (h + pt + pb - kh) // stride + 1, (w + pl + pr - kw) // stride + 1


def conv_s8(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
            padding=((0, 0), (0, 0)), epilogue: str = "s32", alpha=None,
            beta=None, inv_s_out: float = 1.0, res=None,
            res_scale: float = 1.0) -> torch.Tensor:
    """out[B,OH,OW,N] = epilogue(conv(x NHWC s8, w HWIO s8)), explicit
    ((top, bottom), (left, right)) zero pads."""
    (pt, pb), (pl, pr) = padding
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv_s8_torch(x, w, stride, padding, epilogue, alpha, beta,
                             inv_s_out, res, res_scale)
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
    _check_epilogue(x.device, m, n, epilogue, alpha, beta, res)
    out = torch.empty((bsz, oh, ow, n), dtype=OUT_DTYPES[epilogue],
                      device=x.device)
    lib = cuda_build.load("int8_conv", _bind_conv)
    vec = c % 16 == 0
    rc = lib.ursonet_conv_s8(
        x.data_ptr(), w.data_ptr(), bsz, h, wd, c, n, kh, kw, stride,
        pt, pb, pl, pr, int(vec and x.data_ptr() % 16 == 0),
        int((kh * kw * c) % 16 == 0 and w.data_ptr() % 16 == 0),
        EPILOGUES[epilogue], _ptr(alpha), _ptr(beta), float(inv_s_out),
        _ptr(res), float(res_scale), out.data_ptr(), tile_for(m, n),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_if(rc, lib, "conv_s8")
    launches["conv_s8"] += 1
    if calls is not None:
        calls.append(("conv_s8", dict(b=bsz, h=h, w=wd, c=c, kh=kh, kw=kw,
                                      n=n, stride=stride, padding=padding,
                                      epilogue=epilogue)))
    return out
