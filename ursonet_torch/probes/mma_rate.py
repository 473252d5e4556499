"""Tensor-core rate loop: the CUDA kernel `csrc/mma_rate.cu`, its wrapper
and its plain PyTorch version.

    mma_rate(a, b, iters, kind)   acc = iters * (a [M,K] @ b [K,N])

The Hopper port of the Pallas TPU kernels in `tools/probe_int8_mxu.py`
(`mxu_probe`) and `tools/probe_int4_mxu.py` (`pallas_vmem_loop`): the
product is repeated `iters` times on operands staged once in shared
memory, with nothing read from device memory inside the loop. Kinds:

    s8    int8 operands, int32 accumulator (wraps, as the TPU loop's)
    bf16  bfloat16 operands, float32 accumulator
    s4    int8 operands holding int4 values (their low 4 bits count:
          -8..7), packed two a byte once in the kernel's prologue, int32
          accumulator

An int8 x int8 -> bf16 accumulation has no `mma` form; the probe entry
point records it as unsupported.

`b` is the [K,N] view of a contiguous [N,K] tensor, as for `gemm_s8`
(`ops.int8_cuda.kernel_layout`; for bf16, `bt.t()` of a contiguous
[N,K]). The output is cut into block tiles (`tile_for`) that M and N must
be multiples of. A card has many SMs and a small product few tiles, so
the launch repeats the whole product `replicas` times (default: the
fewest that fill whole waves of SMs); every replica writes its own
result, and the rate of a timed launch is
replicas * 2*M*N*K * iters / time. On a CUDA tensor the wrapper launches
the kernel or raises; on a CPU tensor it runs the plain version. Each
launch adds one to `launches['mma_rate_' + kind]`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ursonet_torch.ops import cuda_build

KINDS = {"s8": 0, "bf16": 1, "s4": 2}
IN_DTYPES = {"s8": torch.int8, "bf16": torch.bfloat16, "s4": torch.int8}
OUT_DTYPES = {"s8": torch.int32, "bf16": torch.float32, "s4": torch.int32}
launches = {"mma_rate_s8": 0, "mma_rate_bf16": 0, "mma_rate_s4": 0}


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ursonet_mma_rate.argtypes = [P, P, I, I, I, I, I, I, P, I, P]
    lib.ursonet_mma_rate.restype = I
    lib.ursonet_mma_rate_error_string.argtypes = [I]
    lib.ursonet_mma_rate_error_string.restype = ctypes.c_char_p


def _wrap_s32(acc: torch.Tensor) -> torch.Tensor:
    """Exact int64 values wrapped to int32 as two's complement adds do."""
    return (((acc + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def mma_rate_torch(a: torch.Tensor, b: torch.Tensor, iters: int,
                   kind: str = "s8") -> torch.Tensor:
    """Plain version of mma_rate: iters * (a @ b). The integer kinds
    accumulate exactly (float64 product, |acc| < 2^53) and wrap to int32
    once, which equals wrapping at every step; s4 keeps the operands' low
    4 bits, as the kernel's packing does; bf16 multiplies in float32."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if kind == "bf16":
        return (a.to(torch.float32) @ b.to(torch.float32)) * float(iters)
    a, b = a.to(torch.int64), b.to(torch.int64)
    if kind == "s4":
        a, b = ((a + 8) % 16) - 8, ((b + 8) % 16) - 8
    acc = (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)
    return _wrap_s32(acc * int(iters))


def tile_for(kind: str, k: int) -> tuple[int, int]:
    """The (BM, BN) block tile `csrc/mma_rate.cu` picks for this kind and
    depth: the largest of 128x128, 64x128, 32x64 whose A rows and B
    columns, all of K, fit in a block's 227 KB of shared memory."""
    kb = {"s8": k, "bf16": 2 * k, "s4": k // 2}[kind]
    for bm, bn in ((128, 128), (64, 128), (32, 64)):
        if (bm + bn) * (kb + 16) <= 232448:
            return bm, bn
    raise ValueError(f"K = {k} is too deep for {kind} operands to be staged "
                     "in shared memory")


def default_replicas(tiles: int, sms: int) -> int:
    """The fewest replicas that make tiles * replicas a multiple of the
    SM count."""
    return sms // math.gcd(tiles, sms)


def mma_rate(a: torch.Tensor, b: torch.Tensor, iters: int, kind: str = "s8",
             replicas: int | None = None, all_replicas: bool = False):
    """acc[M,N] = iters * (a[M,K] @ b[K,N]) through the resident
    tensor-core loop. Returns replica 0's result, or with `all_replicas`
    the [replicas,M,N] tensor of every replica's."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        out = mma_rate_torch(a, b, iters, kind)
        return out[None] if all_replicas else out
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    dt = IN_DTYPES[kind]
    if a.dim() != 2 or a.dtype != dt or not a.is_contiguous() \
            or a.data_ptr() % 16:
        raise ValueError(f"a must be a contiguous [M,K] {dt} tensor, got "
                         f"{tuple(a.shape)} {a.dtype}")
    m, k = a.shape
    if b.dim() != 2 or b.shape[0] != k or b.dtype != dt \
            or not b.t().is_contiguous() or b.device != a.device \
            or b.data_ptr() % 16:
        raise ValueError(f"b must be a [{k},N] {dt} view of a contiguous "
                         f"[N,{k}] tensor on {a.device}, got "
                         f"{tuple(b.shape)} {b.dtype} strides {b.stride()}")
    n = b.shape[1]
    if k % {"s8": 32, "bf16": 16, "s4": 64}[kind]:
        raise ValueError(f"K = {k} is not a whole number of {kind} mma steps")
    bm, bn = tile_for(kind, k)
    if m == 0 or n == 0 or m % bm or n % bn:
        raise ValueError(f"M = {m} and N = {n} must be multiples of the "
                         f"{bm}x{bn} block tile for {kind} at K = {k}")
    if iters < 0:
        raise ValueError(f"iters = {iters}")
    if replicas is None:
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        replicas = default_replicas((m // bm) * (n // bn), sms)
    out = torch.empty((replicas, m, n), dtype=OUT_DTYPES[kind],
                      device=a.device)
    lib = cuda_build.load("mma_rate", _bind)
    rc = lib.ursonet_mma_rate(
        a.data_ptr(), b.data_ptr(), m, n, k, int(iters), KINDS[kind],
        int(replicas), out.data_ptr(), a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mma_rate {kind} launch failed: "
                           + lib.ursonet_mma_rate_error_string(rc).decode())
    launches["mma_rate_" + kind] += 1
    return out if all_replicas else out[0]


def operands(kind: str, m: int, n: int, k: int, seed: int, device):
    """Seeded operands of a kind: (a [M,K], b [K,N] as the kernel takes
    it). int8 in [-127, 127], int4 values in [-7, 7], bf16 unit
    normals."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "bf16":
        a = torch.randn((m, k), generator=gen).to(torch.bfloat16)
        bt = torch.randn((n, k), generator=gen).to(torch.bfloat16)
    else:
        lim = 7 if kind == "s4" else 127
        a = torch.randint(-lim, lim + 1, (m, k), generator=gen,
                          dtype=torch.int8)
        bt = torch.randint(-lim, lim + 1, (n, k), generator=gen,
                           dtype=torch.int8)
    return a.to(device), bt.to(device).t()
