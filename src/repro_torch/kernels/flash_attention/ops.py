"""Public wrapper of the flash-attention kernel
(``csrc/flash_attention.cu``), in the JAX package's public layout
``(B, S, H, hd)``.

A CPU tensor goes to the plain version (``ref.flash_attention_plain``, the
tiled mirror on the kernel's own tiles after the GQA head repeat); a CUDA
tensor launches the kernel, or the call raises.  The kernel reads every
operand in place: kv head ``h // (H // KV)`` serves query head ``h``, so
grouped K/V are never repeated in memory, and one thread block takes the
query heads of a kv group together (``block_rows``).
``flash_attention_op.launches`` counts kernel launches,
``flash_attention_op.launches_by_config`` the same by resolved knobs
(``"bk=64,bm=<positions>"``).

Knobs (``config``, a ``tune.config.KernelConfig``): ``bm``, the query
positions one thread block takes (the launch's ``pos``, 1 .. 64; the
block then takes ``min(group, 64 // bm)`` heads of the kv group), and
``bk``, only 0 or 64 (the K/V tile).  0 is the rule (``block_rows``).
:func:`attn_knobs` is the one legality check, and :func:`attn_tiles` the
one home of the tile choice for the kernel, its plain version and the
``torch-int`` backend.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import config_knobs, count_config, knob_key
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the q rows and keys of a thread block's tile (kRows, kBK in
# csrc/flash_attention.cu) and its limits
BQ, BK = 64, 64
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [_P] * 4 + [_I] * 9 + [_F, _I, _P]
    lib.flash_attention_launch.restype = _I
    lib.flash_attention_smem_bytes.argtypes = [_I]
    lib.flash_attention_smem_bytes.restype = _I
    lib.flash_attention_blocks_per_sm.argtypes = [_I, _I,
                                                  ctypes.POINTER(_I)]
    lib.flash_attention_blocks_per_sm.restype = _I
    return lib


def block_rows(group: int):
    """``(heads, positions)`` of one thread block's ``BQ`` q rows when
    ``group = H // KV`` query heads share a kv head: as many heads of the
    group as fit, times as many positions as fill the rows (8 x 8 for
    gemma-2b's MQA, 1 x 64 without grouping)."""
    heads = min(group, BQ)
    return heads, BQ // heads


KNOBS = ("bm", "bk")


def attn_knobs(group: int, config=None):
    """``(heads, positions)`` of one thread block under ``config`` when
    ``group`` query heads share a kv head: ``bm`` positions (0: the rule,
    :func:`block_rows`) and ``min(group, BQ // bm)`` heads.  The one
    legality check of the knobs: raises ``ValueError`` naming a knob the
    kernel does not have, a ``bm`` outside 1 .. ``BQ`` or a ``bk`` other
    than ``BK``."""
    knobs = config_knobs("flash_attention", config, KNOBS)
    if "bk" in knobs and knobs["bk"] != BK:
        raise ValueError(
            f"flash_attention: bk={knobs['bk']}: the kernel's K/V tile is "
            f"{BK} keys; bk may be only 0 or {BK}")
    if "bm" not in knobs:
        return block_rows(group)
    pos = knobs["bm"]
    if not 1 <= pos <= BQ:
        raise ValueError(
            f"flash_attention: bm={pos}: the query positions a thread block "
            f"takes must be in 1..{BQ}")
    return min(group, BQ // pos), pos


def attn_tiles(Sq: int, Sk: int, group: int = 1, config=None):
    """The (bq, bk) tile pair one attention call runs with under
    ``config``, for one query head: the positions of a thread block
    (:func:`attn_knobs`) and the keys of a K/V tile, capped at the
    sequence lengths.  One home for the choice, so the kernel, its plain
    version and ``torch-int`` walk the same tiles."""
    return min(attn_knobs(group, config)[1], Sq), min(BK, Sk)


def _check(q, k, v, causal):
    if q.dtype not in _DTYPES or q.dim() != 4:
        raise ValueError(f"q must be (B,Sq,H,hd) float32/bfloat16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    B, Sq, H, hd = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dim() != 4 or t.shape[0] != B or \
                t.shape[3] != hd or H % max(t.shape[2], 1) or t.shape[2] == 0:
            raise ValueError(
                f"{name} must be (B,Sk,KV,hd) {q.dtype} with KV dividing "
                f"H={H}, got {tuple(t.shape)} {t.dtype}")
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if causal and Sq > k.shape[1]:
        raise ValueError(
            f"causal attention needs Sq <= Sk (q is the kv suffix); got "
            f"Sq={Sq} Sk={k.shape[1]}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on different devices: q {q.device}, "
                         f"k {k.device}, v {v.device}")


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, config=None) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd) float32 or bfloat16 ->
    (B,Sq,H,hd) of q's type, computed in float32.  ``Sq < Sk`` means
    decode with a prefilled cache (the q rows are the kv suffix).
    ``config``: the knobs (:func:`attn_knobs`)."""
    _check(q, k, v, causal)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    gh, pos = attn_knobs(H // KV, config)
    if q.device.type == "cpu":
        bq, bk = attn_tiles(Sq, Sk, H // KV, config)
        return flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_op: unsupported device {q.device}")
    if hd % 16 or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_op: head_dim {hd} must be a "
                         f"multiple of 16 and at most {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_op: {name} must be contiguous")
    # the kernel copies 16 bytes at a time: a view that starts off a
    # 16-byte boundary is copied to a fresh (aligned) allocation
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KV, hd, gh, pos, int(causal), 1.0 / math.sqrt(hd),
            _DTYPES[q.dtype], stream)
    _build.check(lib, err, "flash_attention launch")
    flash_attention_op.launches += 1
    count_config(flash_attention_op, knob_key(bm=pos, bk=BK))
    return out


def padded_hd(hd: int) -> int:
    """The head dim the kernel is instantiated at for ``hd``."""
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def block_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one thread block at head dim ``hd``
    (``Tile<HD>::kFloats`` in ``csrc/flash_attention.cu``: the q tile, the
    K and V tiles, the transposed p tile and the row rescales), without
    the library; :func:`smem_bytes` asks the library for the same."""
    p = padded_hd(hd)
    ld, ldp = p + 4, BQ + 4
    return 4 * (BQ * ld + BK * ld + BK * p + BK * ldp + 2 * BQ)


def smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one thread block at head dim ``hd`` (the
    kernel's own formula; needs the built library)."""
    return _lib().flash_attention_smem_bytes(hd)


def blocks_per_sm(hd: int, dtype=torch.float32) -> int:
    """Thread blocks one SM holds at head dim ``hd``, as the CUDA occupancy
    calculator gives it for the kernel's registers and shared memory
    (needs a GPU)."""
    lib = _lib()
    n = _I(0)
    _build.check(lib, lib.flash_attention_blocks_per_sm(
        hd, _DTYPES[dtype], ctypes.byref(n)), "flash_attention occupancy")
    return n.value


flash_attention_op.launches = 0
flash_attention_op.launches_by_config = {}
