"""Public wrapper of the int8 matmul kernel (``csrc/matmul_int8.cu``).

A CPU tensor goes to the plain version (``ref.matmul_int8_ref``); a CUDA
tensor launches one of the kernel's two paths, or the call raises.  The path
is a function of the shape alone (``matmul_path``): ``"wgmma"`` (TMA ring,
wgmma, tiles and split-K from ``matmul_tiles``) when K and N are multiples
of 16 and the operands are 16-byte aligned, every LM projection among them;
``"mma_sync"`` for the rest.  ``matmul_int8_op.launches`` counts kernel
launches, ``matmul_int8_op.launches_by_path`` the same split by path.

B is either the ``(K, N)`` weight as ``QMatmulParams.wq`` stores it, or a
:class:`PackedWeight`: the same weight packed once as ``(N, K)``, K-major,
the layout the ``wgmma`` path reads (8-bit wgmma has no transpose).  The
LM lowering packs every weight once at lower time; a plain ``(K, N)``
tensor is transposed on the fly for the ``wgmma`` path, and a packed one
back for the ``mma_sync`` path.  ``acc_init`` may be a full ``(M, N)``
tensor or one row broadcast over the rows (a stride-0 ``expand``, the LM's
bias): the kernel reads it with that row stride, never copied to M x N.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul_int8.ref import matmul_int8_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the wgmma path's block tile: 128 rows (two consumer warpgroups of 64) and
# 128 K bytes a stage (kWgBM, kWgBK in csrc/matmul_int8.cu)
TILE_M, TILE_K = 128, 128
TILE_N = (16, 32, 64, 128, 256)     # the instantiated wgmma widths
MIN_BN = 32                         # narrowest tile before splitting K
BUSY = 128                          # thread blocks that keep an H100 busy
ALIGN = 16                          # TMA: 16-byte addresses and strides
PATHS = ("wgmma", "mma_sync")


def matmul_path(M: int, N: int, K: int, aligned: bool = True) -> str:
    """Which kernel path takes an (M, K) @ (K, N) product: ``"wgmma"``
    where TMA can read the operands (K and N multiples of 16, 16-byte
    aligned pointers), else ``"mma_sync"``."""
    if aligned and K % ALIGN == 0 and N % ALIGN == 0 and M > 0:
        return "wgmma"
    return "mma_sync"


SMEM_MAX = 232448                   # shared memory a block may use (227 KB)


def staging_bytes(bn: int) -> int:
    """Epilogue staging of one consumer warpgroup at tile width ``bn``
    (WgCfg::kStageOut + kBias): chunks of 64 rows x up to 64 int32, two
    buffers when a tile has several chunks, and the tile's bias row; for
    the TMA-store epilogue of the widths from 32 up."""
    if bn < 32:
        return 0
    chunk = min(bn, 64)
    return (2 if bn > chunk else 1) * 64 * chunk * 4 + bn * 4


def stages(bn: int) -> int:
    """Ring stages of the wgmma path at tile width ``bn`` (kStages): what
    the epilogue staging leaves of the shared memory, at most 8."""
    free = SMEM_MAX - 1024 - 2 * staging_bytes(bn) - 8 * (2 * 8 + 4)
    return min(8, free // (TILE_M * TILE_K + bn * TILE_K))


def smem_bytes(bn: int) -> int:
    """Dynamic shared memory of one wgmma thread block at tile width
    ``bn`` (WgCfg::kSmem): the ring, the epilogue staging of both
    consumer warpgroups, 1 KB of alignment slack, two mbarriers a stage and
    one a staging buffer."""
    return (stages(bn) * (TILE_M * TILE_K + bn * TILE_K) +
            2 * staging_bytes(bn) + 1024 + 8 * (2 * stages(bn) + 4))


@functools.lru_cache(maxsize=None)
def matmul_tiles(M: int, N: int, K: int) -> Tuple[int, int, int, int]:
    """``(bm, bn, bk, split_k)`` of the wgmma path for an (M, K) @ (K, N)
    product.  bn is the narrowest instantiated width that covers N, at most
    256; while there are fewer than ``BUSY`` output tiles (132 SMs) it
    halves, down to 32.  Only then is K split in two, while fewer than
    ``BUSY // 2`` units would run and each split keeps at least two K
    tiles: a split costs a zeroed output and atomic adds (N = 16)."""
    bm, bk = TILE_M, TILE_K
    bn = next((w for w in TILE_N if w >= N), TILE_N[-1])
    mt = -(-M // bm)

    def tiles(width):
        return mt * -(-N // width)

    while tiles(bn) < BUSY and bn > MIN_BN:
        bn //= 2
    ktiles = -(-K // bk)
    split = 1
    while (tiles(bn) * split < BUSY // 2 and ktiles % (2 * split) == 0
           and ktiles // (2 * split) >= 2):
        split *= 2
    return bm, bn, bk, split


class PackedWeight:
    """A ``(K, N)`` int8 weight packed once as its contiguous ``(N, K)``
    transpose (K-major), with the TMA tensor map of each tile width it has
    been read at (encoded at the first launch, then reused)."""

    def __init__(self, b: torch.Tensor):
        if b.dtype != torch.int8 or b.dim() != 2:
            raise ValueError(f"pack_weight: b must be (K, N) int8 in the "
                             f"(din, dout) layout, got {tuple(b.shape)} "
                             f"{b.dtype}")
        self.k, self.n = b.shape
        self.t = b.t().contiguous()
        self._maps: Dict[int, ctypes.Array] = {}

    @property
    def device(self):
        return self.t.device

    def unpacked(self) -> torch.Tensor:
        """The ``(K, N)`` view of the packed data."""
        return self.t.t()

    def tensor_map(self, lib, bn: int) -> ctypes.Array:
        if bn not in self._maps:
            buf = ctypes.create_string_buffer(128)
            err = lib.matmul_int8_encode_b(self.t.data_ptr(), self.n,
                                           self.k, bn, buf)
            _build.check(lib, err, "matmul_int8 tensor map of B")
            self._maps[bn] = buf
        return self._maps[bn]


def pack_weight(b: torch.Tensor) -> PackedWeight:
    """Pack a ``(K, N)`` weight for the wgmma path (once, at lower time).
    ``pack_weight.calls`` counts the packs."""
    pack_weight.calls += 1
    return PackedWeight(b)


pack_weight.calls = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul_int8")
    lib.matmul_int8_encode_b.argtypes = [_P, _I, _I, _I, _P]
    lib.matmul_int8_encode_b.restype = _I
    lib.matmul_int8_wgmma_launch.argtypes = [_P, _P, _P, _L, _P, _I, _I, _I,
                                             _I, _I, _P]
    lib.matmul_int8_wgmma_launch.restype = _I
    lib.matmul_int8_mma_sync_launch.argtypes = [_P, _P, _P, _L, _P, _I, _I,
                                                _I, _P]
    lib.matmul_int8_mma_sync_launch.restype = _I
    return lib


def _check(a, b, acc_init, config):
    if config is not None:
        raise ValueError(
            f"config={config!r}: the CUDA kernel picks its tiles by shape "
            f"(matmul_tiles); kernel tuning is not available in repro_torch "
            f"yet, pass config=None")
    if a.dtype != torch.int8 or a.dim() != 2:
        raise ValueError(f"a must be (M,K) int8, got {tuple(a.shape)} "
                         f"{a.dtype}")
    K = a.shape[1]
    if isinstance(b, PackedWeight):
        if b.k != K:
            raise ValueError(f"b, packed (N,K) K-major, must have K={K}, got "
                             f"{tuple(b.t.shape)}")
        N = b.n
    else:
        if b.dtype != torch.int8 or b.dim() != 2 or b.shape[0] != K:
            raise ValueError(f"b must be ({K},N) int8 in the (K,N) = (din, "
                             f"dout) layout, got {tuple(b.shape)} {b.dtype}")
        N = b.shape[1]
    shape = (a.shape[0], N)
    if acc_init is not None and (acc_init.dtype != torch.int32 or
                                 tuple(acc_init.shape) != shape):
        raise ValueError(f"acc_init must be {shape} int32, got "
                         f"{tuple(acc_init.shape)} {acc_init.dtype}")
    devs = {t.device for t in (a, b, acc_init) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{sorted(map(str, devs))}")
    return N


def _init_rows(acc_init, N):
    """``(tensor, row stride in elements)`` the kernel reads acc_init with:
    a broadcast row (row stride 0) and a row-major tensor are read in
    place; any other view, or one not 16-byte aligned (TMA), is copied."""
    if acc_init is None:
        return None, 0
    s0, s1 = acc_init.stride()
    if s1 == 1 and s0 in (0, N) and acc_init.data_ptr() % ALIGN == 0:
        return acc_init, s0
    return acc_init.clone(memory_format=torch.contiguous_format), N


def _launch(lib, path, a, b, init, init_ld, out, dev) -> int:
    """One launch of ``path`` on the current stream of device ``dev`` (the
    raw handle, read without building a Stream object: the LM forward
    makes a few hundred of these calls).  Returns the CUDA error code."""
    stream = torch._C._cuda_getCurrentRawStream(dev)
    (M, K), N = a.shape, out.shape[1]
    init_ptr = init.data_ptr() if init is not None else None
    if path == "wgmma":
        w = b if isinstance(b, PackedWeight) else PackedWeight(b)
        _, bn, _, split = matmul_tiles(M, N, K)
        return lib.matmul_int8_wgmma_launch(
            a.data_ptr(), w.tensor_map(lib, bn), init_ptr, init_ld,
            out.data_ptr(), M, N, K, bn, split, stream)
    bk = b.unpacked().contiguous() if isinstance(b, PackedWeight) else b
    return lib.matmul_int8_mma_sync_launch(
        a.data_ptr(), bk.data_ptr(), init_ptr, init_ld, out.data_ptr(), M,
        N, K, stream)


def matmul_int8_op(a: torch.Tensor, b, acc_init: torch.Tensor = None,
                   config=None) -> torch.Tensor:
    """a: (M,K) int8 row-major; b: (K,N) int8 row-major (``(din, dout)``,
    as ``QMatmulParams.wq`` stores it) or its :class:`PackedWeight`;
    acc_init: optional (M,N) int32 (a broadcast row is read in place).
    Returns (M,N) int32 = a @ b (+ acc_init), exact."""
    N = _check(a, b, acc_init, config)
    packed = isinstance(b, PackedWeight)
    if a.device.type == "cpu":
        return matmul_int8_ref(a, b.unpacked() if packed else b, acc_init)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_int8_op: unsupported device {a.device}")
    if not a.is_contiguous():
        raise ValueError("matmul_int8_op: a must be contiguous")
    if not packed and not b.is_contiguous():
        raise ValueError("matmul_int8_op: b must be contiguous")
    M, K = a.shape
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    init, init_ld = _init_rows(acc_init, N)
    path = matmul_path(M, N, K, a.data_ptr() % ALIGN == 0)
    lib = _lib()
    dev = a.get_device()
    if dev == torch.cuda.current_device():
        err = _launch(lib, path, a, b, init, init_ld, out, dev)
    else:
        with torch.cuda.device(dev):
            err = _launch(lib, path, a, b, init, init_ld, out, dev)
    _build.check(lib, err, f"matmul_int8 launch ({path})")
    matmul_int8_op.launches += 1
    matmul_int8_op.launches_by_path[path] += 1
    return out


matmul_int8_op.launches = 0
matmul_int8_op.launches_by_path = dict.fromkeys(PATHS, 0)
