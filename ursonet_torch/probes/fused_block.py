"""A whole int8 identity bottleneck block in one kernel: the CUDA kernel
`csrc/int8_block.cu`, its wrapper, its plain PyTorch version, the unfused
route through `gemm_s8` / `conv_s8`, and the probe entry point

    python -m ursonet_torch.probes.fused_block [--batch 128] [--reps 20]
                                               [--device cuda]

The Hopper port of the Pallas TPU kernel
`tools/probe_fused_block.py::_fused_kernel`, with the operands of its
`fused_block`:

    block_s8(x, w1, w2, w3, ab)
      x  [B,H,W,Cin] s8 (NHWC)
      w1 [Cin,Cmid] s8, w2 [9*Cmid,Cmid] s8 (rows (ky*3+kx)*Cmid + c),
      w3 [Cmid,Cout] s8, Cout = Cin; each the [K,N] view of a contiguous
      [N,K] tensor (`ops.int8_cuda.kernel_layout`)
      ab [8,max(Cmid,Cout)] f32: rows a1, b1, a2, b2, a3, b3, res
    m1  = requant(x . w1 * a1 + b1)             1x1
    m2  = requant(conv3x3_SAME(m1, w2) * a2 + b2)
    out = requant(relu(m2 . w3 * a3 + b3 + f32(x) * res))
    requant(y) = clip(rint(y), 0, 127) -> s8

Rounding order, fixed once for the kernel and its plain version: acc * a
+ b is one FMA (rounded once), the residual product x * res is rounded,
then their sum is rounded: the serving kernels' q8_relu and join
epilogues at a unit output step. `xla_block` of the TPU probe leaves the
contraction to XLA; the two agree to the probe's own gate of 1 LSB. The
kernel takes the C2 identity block's widths (Cin = Cout = 256, Cmid =
64) at any B, H, W and raises otherwise. It is a probe: the JAX package
never served through its fused block, and `models/quant.py` does not
either. On a CUDA tensor the wrapper launches the kernel or raises; on a
CPU tensor it runs the plain version.

The kernel is persistent and warp-specialized: TMA loads of the x halo
tiles into a ring of two stages, the three weight matrices resident in
shared memory as wgmma B operands, wgmma for all three products, the
tile sent out by TMA stores. It takes every x block_s8 accepts (16-byte
aligned: rows of 256 bytes keep every pitch of the tensor map a multiple
of 16; TMA fills the halo outside any B, H, W with zeros). Each launch
adds one to `launches['block_s8']`.

The entry point prints one JSON line for the kernel (the plain version on
the CPU), on the card with the SM clock while it ran, then one for the
unfused route.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from ursonet_torch.device import resolve_device
from ursonet_torch.ops import cuda_build, int8_cuda
from ursonet_torch.probes.timing import (card_label, record, sm_clock_mhz,
                                         time_ms)

launches = {"block_s8": 0}
CIN, CMID = 256, 64


def reset_counts() -> None:
    launches["block_s8"] = 0


def _bind(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ursonet_block_s8.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P, I, P]
    lib.ursonet_block_s8.restype = I
    lib.ursonet_int8_error_string.argtypes = [I]
    lib.ursonet_int8_error_string.restype = ctypes.c_char_p


def _rows(ab, cmid, cout):
    return (ab[0, :cmid].contiguous(), ab[1, :cmid].contiguous(),
            ab[2, :cmid].contiguous(), ab[3, :cmid].contiguous(),
            ab[4, :cout].contiguous(), ab[5, :cout].contiguous(),
            ab[6, :cout].contiguous())


def block_s8_torch(x, w1, w2, w3, ab) -> torch.Tensor:
    """Plain version of block_s8: the three products with exact (float64)
    accumulation through the serving kernels' plain versions, the
    epilogues in the order the module docstring fixes."""
    cin, cmid = w1.shape
    cout = w3.shape[1]
    a1, b1, a2, b2, a3, b3, res = _rows(ab, cmid, cout)
    m1 = int8_cuda.conv_s8_torch(x, w1.reshape(1, 1, cin, cmid), 1,
                                 ((0, 0), (0, 0)), "q8_relu", a1, b1)
    m2 = int8_cuda.conv_s8_torch(m1, w2.reshape(3, 3, cmid, cmid), 1,
                                 ((1, 1), (1, 1)), "q8_relu", a2, b2)
    acc = int8_cuda.conv_s8_torch(m2, w3.reshape(1, 1, cmid, cout), 1,
                                  ((0, 0), (0, 0)), "s32")
    y = int8_cuda.fma_f32(acc.to(torch.float32), a3, b3)
    y = torch.clamp_min(y + x.to(torch.float32) * res, 0.0)
    return torch.clamp(torch.round(y), 0, 127).to(torch.int8)


def block_s8_unfused(x, w1, w2, w3, ab) -> torch.Tensor:
    """The same block as three launches of the serving kernels (gemm_s8
    q8_relu, conv_s8 q8_relu, gemm_s8 join): m1 and m2 travel through
    device memory. The join takes one residual scale, so row `res` of
    `ab` must be uniform."""
    cin, cmid = w1.shape
    cout = w3.shape[1]
    a1, b1, a2, b2, a3, b3, res = _rows(ab, cmid, cout)
    scale = float(res[0])
    if not bool((res == res[0]).all()):
        raise ValueError("the unfused route needs one residual scale")
    bsz, h, w, _ = x.shape
    x2 = x.reshape(-1, cin)
    m1 = int8_cuda.gemm_s8(x2, w1, "q8_relu", a1, b1)
    w2c = w2.t().reshape(cmid, 3, 3, cmid).permute(1, 2, 3, 0)
    m2 = int8_cuda.conv_s8(m1.reshape(bsz, h, w, cmid), w2c, 1,
                           ((1, 1), (1, 1)), "q8_relu", a2, b2)
    out = int8_cuda.gemm_s8(m2.reshape(-1, cmid), w3, "join", a3, b3,
                            res=x2, res_scale=scale)
    return out.reshape(bsz, h, w, cout)


def _is_kn_view(w, k, n):
    return w.dim() == 2 and tuple(w.shape) == (k, n) \
        and w.dtype == torch.int8 and w.t().is_contiguous() \
        and w.data_ptr() % 16 == 0


def block_s8(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
             w3: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """out[B,H,W,Cout] s8: the identity bottleneck block in one launch
    (module docstring). x is read once and out written once; m1 and m2
    stay in shared memory."""
    if x.device.type == "cpu" and all(t.device.type == "cpu"
                                      for t in (w1, w2, w3, ab)):
        return block_s8_torch(x, w1, w2, w3, ab)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.int8 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous [B,H,W,C] int8 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    bsz, h, w, cin = x.shape
    cmid = w1.shape[1] if w1.dim() == 2 else -1
    if cin != CIN or cmid != CMID:
        raise ValueError(f"block_s8 takes Cin = Cout = {CIN}, Cmid = {CMID} "
                         f"(the C2 identity block), got Cin = {cin}, Cmid = "
                         f"{cmid}")
    for name, t, k, n in (("w1", w1, cin, cmid), ("w2", w2, 9 * cmid, cmid),
                          ("w3", w3, cmid, cin)):
        if not _is_kn_view(t, k, n) or t.device != x.device:
            raise ValueError(f"{name} must be a [{k},{n}] int8 view of a "
                             f"contiguous [{n},{k}] tensor on {x.device} "
                             f"(kernel_layout), got {tuple(t.shape)} "
                             f"{t.dtype} strides {t.stride()}")
    if ab.dim() != 2 or ab.shape[0] < 7 or ab.shape[1] < cin \
            or ab.dtype != torch.float32 or not ab.is_contiguous() \
            or ab.device != x.device:
        raise ValueError(f"ab must be a contiguous [8,{cin}] float32 tensor "
                         f"on {x.device}, got {tuple(ab.shape)} {ab.dtype}")
    if bsz == 0 or h == 0 or w == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    out = torch.empty_like(x)
    lib = cuda_build.load("int8_block", _bind)
    rc = lib.ursonet_block_s8(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
        ab.data_ptr(), ab.shape[1], bsz, h, w, cin, cmid, out.data_ptr(),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("block_s8 launch failed: "
                           + lib.ursonet_int8_error_string(rc).decode())
    launches["block_s8"] += 1
    return out


def operands(bsz: int, h: int, w: int, seed: int, device,
             cin: int = CIN, cmid: int = CMID):
    """The TPU probe's operands from a numpy seed: s8 x and weights in
    [-127, 127], a1 = a3 = 3e-4, a2 = 2e-5, biases 5 * N(0, 1), residual
    scale 0.11. Returns (x, w1, w2, w3, ab) on `device`, the weights in
    the kernel's layout."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(-127, 128, (bsz, h, w, cin))
                         .astype(np.int8))
    w1 = rng.randint(-127, 128, (cin, cmid)).astype(np.int8)
    w2 = rng.randint(-127, 128, (9 * cmid, cmid)).astype(np.int8)
    w3 = rng.randint(-127, 128, (cmid, cin)).astype(np.int8)
    ab = np.zeros((8, max(cmid, cin)), np.float32)
    ab[0, :cmid] = 3e-4
    ab[1, :cmid] = rng.randn(cmid) * 5.0
    ab[2, :cmid] = 2e-5
    ab[3, :cmid] = rng.randn(cmid) * 5.0
    ab[4, :cin] = 3e-4
    ab[5, :cin] = rng.randn(cin) * 5.0
    ab[6, :cin] = 0.11
    return (x.to(device),) + tuple(
        int8_cuda.kernel_layout(wk).to(device) for wk in (w1, w2, w3)) \
        + (torch.from_numpy(ab).to(device),)


def block_bytes_ops(bsz: int, h: int, w: int, cin: int = CIN,
                    cmid: int = CMID) -> tuple[int, int]:
    """(bytes, operations) of one block: x read once, out written once,
    the weights and `ab` once; two operations a multiply-add."""
    px = bsz * h * w
    nbytes = 2 * px * cin + 2 * cin * cmid + 9 * cmid * cmid + 8 * 4 * cin
    return nbytes, 2 * px * (2 * cin * cmid + 9 * cmid * cmid)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=128)
    ap.add_argument('--h', type=int, default=128)
    ap.add_argument('--w', type=int, default=160)
    ap.add_argument('--check-batch', type=int, default=4,
                    help='images the plain version is compared on')
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    results: list = []
    ops = operands(args.batch, args.h, args.w, args.seed, dev)
    x = ops[0]
    got = block_s8(*ops)
    unfused = block_s8_unfused(*ops)
    nb = min(args.check_batch, args.batch)
    want = block_s8_torch(x[:nb], *ops[1:])
    d_plain = (got[:nb].to(torch.int32) - want.to(torch.int32)).abs()
    d_unf = (got.to(torch.int32) - unfused.to(torch.int32)).abs()
    nbytes, nops = block_bytes_ops(args.batch, args.h, args.w)
    shape = [args.batch, args.h, args.w, CIN, CMID]
    ms = time_ms(lambda: block_s8(*ops), args.reps, dev)
    record(results, probe='block_s8', shape=shape,
           max_lsb_diff_vs_plain=int(d_plain.max()),
           frac_diff_vs_plain=float((d_plain > 0).float().mean()),
           plain_images=nb, max_lsb_diff_vs_unfused=int(d_unf.max()),
           ms=ms, gbps=nbytes / ms / 1e6, tops=nops / ms / 1e9,
           sm_clock_mhz=sm_clock_mhz(lambda: block_s8(*ops), ms, dev),
           device=card)
    ms_u = time_ms(lambda: block_s8_unfused(*ops), args.reps, dev)
    record(results, probe='unfused gemm_s8+conv_s8+gemm_s8', shape=shape,
           ms=ms_u, tops=nops / ms_u / 1e9, device=card)
    if int(d_plain.max()) or int(d_unf.max()):
        raise RuntimeError("block_s8 differs from its plain version or from "
                           f"the unfused route: {results[0]}")
    return results


if __name__ == '__main__':
    main()
    sys.exit(0)
