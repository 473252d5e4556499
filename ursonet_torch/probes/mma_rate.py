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
          -8..7), narrowed once in the kernel's prologue (by route,
          below), int32 accumulator

An int8 x int8 -> bf16 accumulation has no `mma` form; the probe entry
point records it as unsupported.

Routes, two kernels of the same source:

    wgmma     (default) warpgroup wgmma with both operands read from
              128-byte-swizzled shared memory, one or two warpgroups a
              block; s4 values sign-extended to s8 while staging (Hopper
              has no int4 wgmma), so the s8 loop gives the same sums
    mma_sync  the mma.sync loop on fragments read by 32-bit shared loads
              (m16n8k32 s8, m16n8k16 bf16, m16n8k64 s4, s4 packed two
              values a byte): the record of what that instruction
              reaches on this card

`b` is the [K,N] view of a contiguous [N,K] tensor, as for `gemm_s8`
(`ops.int8_cuda.kernel_layout`; for bf16, `bt.t()` of a contiguous
[N,K]). The output is cut into block tiles (`tile_for(kind, k, route)`)
that M and N must be multiples of. `rate_route` picks the wgmma route
where its tile divides the shape, else the mma_sync one; `route=` forces
one, and a forced route that does not take the shape raises. A card has
many SMs and a small product few tiles, so the launch repeats the whole
product `replicas` times (default: the fewest that fill whole waves of
SMs); every replica writes its own result, and the rate of a timed
launch is replicas * 2*M*N*K * iters / time. On a CUDA tensor the
wrapper launches a kernel or raises; on a CPU tensor it runs the plain
version. Each launch adds one to `launches[f'mma_rate_{kind}_{route}']`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ursonet_torch.ops import cuda_build

KINDS = {"s8": 0, "bf16": 1, "s4": 2}
IN_DTYPES = {"s8": torch.int8, "bf16": torch.bfloat16, "s4": torch.int8}
OUT_DTYPES = {"s8": torch.int32, "bf16": torch.float32, "s4": torch.int32}
ROUTES = ("wgmma", "mma_sync")
launches = {f"mma_rate_{k}_{r}": 0 for k in KINDS for r in ROUTES}
SMEM_LIMIT = 232448       # 227 KB a block
# Block tiles (BM, BN) of each route, best first: the first whose staged
# operands (all of K) fit in shared memory is taken. (128, 64) beat
# (64, 128), which needs the same shared memory, at every depth timed.
WGMMA_TILES = ((128, 256), (128, 128), (128, 64), (64, 64), (64, 32))
MMA_SYNC_TILES = ((128, 128), (64, 128), (32, 64))


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ursonet_mma_rate.argtypes = [P, P, I, I, I, I, I, I, P, I, P]
    lib.ursonet_mma_rate.restype = I
    lib.ursonet_mma_rate_wgmma.argtypes = [P, P, I, I, I, I, I, I, I, I, P,
                                           I, P]
    lib.ursonet_mma_rate_wgmma.restype = I
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


def staged_row_bytes(kind: str, k: int, route: str = "wgmma") -> int:
    """Bytes of K a staged row holds: s8 one a value, bf16 two, s4 half
    a byte on the mma_sync route (packed) and one on the wgmma route
    (sign-extended to s8)."""
    if kind not in KINDS or route not in ROUTES:
        raise ValueError(f"unknown kind {kind!r} or route {route!r}")
    if kind == "bf16":
        return 2 * k
    return k // 2 if kind == "s4" and route == "mma_sync" else k


def wgmma_smem(bm: int, bn: int, kb: int) -> int:
    """Dynamic shared memory of a wgmma launch (csrc/mma_rate.cu):
    alignment slack and both tiles, kb bytes of K a row."""
    return 1024 + kb * (bm + bn)


def tile_for(kind: str, k: int, route: str = "wgmma") -> tuple[int, int]:
    """The (BM, BN) block tile of `route` for this kind and depth: the
    first of WGMMA_TILES (wgmma) or MMA_SYNC_TILES (mma_sync) whose A
    rows and B columns, all of K, fit in a block's 227 KB of shared
    memory (mma_sync rows carry 16 bytes of padding)."""
    kb = staged_row_bytes(kind, k, route)
    if route == "wgmma":
        fits = [t for t in WGMMA_TILES if wgmma_smem(*t, kb) <= SMEM_LIMIT]
    else:
        fits = [t for t in MMA_SYNC_TILES
                if (t[0] + t[1]) * (kb + 16) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"K = {k} is too deep for {kind} operands to be "
                         f"staged in shared memory on the {route} route")
    return fits[0]


def k_step(kind: str, route: str) -> int:
    """K must be a multiple of this: a k-step of the route's instruction
    (mma_sync) or a 128-byte K-block of a staged row (wgmma)."""
    if route == "mma_sync":
        return {"s8": 32, "bf16": 16, "s4": 64}[kind]
    return {"s8": 128, "bf16": 64, "s4": 128}[kind]


def takes(kind: str, m: int, n: int, k: int, route: str) -> bool:
    """Whether `route` takes an [m,k] @ [k,n] product of this kind."""
    if k <= 0 or k % k_step(kind, route) or m <= 0 or n <= 0:
        return False
    try:
        bm, bn = tile_for(kind, k, route)
    except ValueError:
        return False
    return m % bm == 0 and n % bn == 0


def rate_route(kind: str, m: int, n: int, k: int) -> str:
    """'wgmma' where it takes the shape, else 'mma_sync'."""
    return "wgmma" if takes(kind, m, n, k, "wgmma") else "mma_sync"


def default_replicas(tiles: int, sms: int) -> int:
    """The fewest replicas that make tiles * replicas a multiple of the
    SM count."""
    return sms // math.gcd(tiles, sms)


def mma_rate(a: torch.Tensor, b: torch.Tensor, iters: int, kind: str = "s8",
             replicas: int | None = None, all_replicas: bool = False,
             route: str | None = None):
    """acc[M,N] = iters * (a[M,K] @ b[K,N]) through the resident
    tensor-core loop. Returns replica 0's result, or with `all_replicas`
    the [replicas,M,N] tensor of every replica's. `route`: None picks by
    shape (`rate_route`), or one of ROUTES."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown route {route!r}")
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
    if iters < 0:
        raise ValueError(f"iters = {iters}")
    if route is None:
        route = rate_route(kind, m, n, k)
    if not takes(kind, m, n, k, route):
        raise ValueError(f"the {route} route does not take {m}x{k} @ "
                         f"{k}x{n} {kind}: K must be a multiple of "
                         f"{k_step(kind, route)} and M, N of its block tile")
    bm, bn = tile_for(kind, k, route)
    if replicas is None:
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        replicas = default_replicas((m // bm) * (n // bn), sms)
    out = torch.empty((replicas, m, n), dtype=OUT_DTYPES[kind],
                      device=a.device)
    lib = cuda_build.load("mma_rate", _bind)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if route == "wgmma":
        rc = lib.ursonet_mma_rate_wgmma(
            a.data_ptr(), b.data_ptr(), m, n, k, int(iters), KINDS[kind],
            int(replicas), bm, bn, out.data_ptr(), a.device.index, stream)
    else:
        rc = lib.ursonet_mma_rate(
            a.data_ptr(), b.data_ptr(), m, n, k, int(iters), KINDS[kind],
            int(replicas), out.data_ptr(), a.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"mma_rate {kind} [{route}] launch failed: "
                           + lib.ursonet_mma_rate_error_string(rc).decode())
    launches[f"mma_rate_{kind}_{route}"] += 1
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
