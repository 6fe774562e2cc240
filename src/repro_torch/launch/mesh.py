"""Meshes and the process group, and the hardware constants of one NVIDIA
H100 SXM (80 GB HBM3) for the roofline terms of ``launch.analytic`` and
the dry-run (the port's counterpart of the reference's per-chip TPU
constants, under the same names).

The port is SPMD: one process a rank, launched by ``torchrun`` (tests
spawn the ranks), with a process group started by
:func:`init_process_group`; a mesh is a ``DeviceMesh`` over that group
with the reference's axis names.  The constructors are functions (never
module-level meshes), so importing this module touches no device and no
process group.

Constants: NVIDIA's H100 Tensor Core GPU data sheet, SXM part, dense
rates (no sparsity), at its 700 W limit; NVLink 4 is 900 GB/s a GPU in
both directions together.
"""
from __future__ import annotations

import datetime
import os

import torch

PEAK_BF16_FLOPS = 989e12          # FLOP/s, bf16 tensor cores
PEAK_INT8_OPS = 1979e12           # int8 Op/s
HBM_BW = 3.35e12                  # bytes/s
ICI_BW = 450e9                    # bytes/s, NVLink, one direction
HBM_BYTES = 80 * 10 ** 9          # 80 GB

# the process-group backend of a device type (the dry-run's is "fake")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_process_group(device="cuda", init_method=None, rank=None,
                       world_size=None, timeout_s: float = 600.0):
    """Start the default process group for ``device`` (``nccl`` on
    ``cuda``, ``gloo`` on ``cpu``) and return this rank's device.

    Without ``init_method`` the ``torchrun`` environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
    names the rendezvous; otherwise ``init_method`` (``tcp://...`` or
    ``file://...``) with ``rank`` and ``world_size``.  On ``cuda`` the
    rank's card is ``LOCAL_RANK`` (default: ``rank`` modulo the cards)."""
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for a gloo group")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    kw = dict(backend=BACKENDS[dev.type], rank=rank, world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout_s))
    if init_method is not None:
        kw["init_method"] = init_method
    if dev.type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return dev


def rank_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card on a ``cuda``
    mesh (``init_process_group`` set it)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _device_type(device) -> str:
    return torch.device(device).type


def _mesh(shape, names, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} {names} mesh needs a process "
            f"group of world size {n}; "
            + ("no process group is started" if world is None
               else f"the process group has world size {world}"))
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``: a world of 256 or 512 ranks (the dry-run's ``fake``
    group)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_local_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ``(data, model)`` ``("data", "model")`` mesh over the started
    process group, whose world size must be ``data * model``."""
    return _mesh((data, model), ("data", "model"), device)
