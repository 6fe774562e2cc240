"""Drive the multi-pod dry-run for one cell and print its roofline
summary: rank 0's program of the SPMD step traced under the ``fake``
process group on the two-pod production mesh (512 ranks), with fake
tensors only (``launch.dryrun.run_cell``).

Run:  PYTHONPATH=src python -m repro_torch.examples.multipod_dryrun \\
          [--arch gemma-2b] [--shape train_4k] [--device cpu]

A process holds one fake group: run one cell a process.  gemma-2b
train_4k takes a few minutes of host time; ``--arch`` / ``--shape`` pick
a cheaper cell (internvl2-1b decode_32k takes seconds).
"""
from __future__ import annotations

import argparse

from repro_torch.compile.compiler import resolve_device
from repro_torch.configs import base as cbase
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import run_cell


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.multipod_dryrun")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--shape", default="train_4k", choices=list(cbase.SHAPES))
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default: the GPU, "
                         "which must be present)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    res = run_cell(args.arch, args.shape, multi_pod=True, device=dev.type)
    print(f"cell: {args.arch} x {args.shape} on {res['chips']} chips "
          f"(2 pods)")
    print(f"  compute  {res['an_compute_s']:.4f}s | memory "
          f"{res['an_memory_s']:.4f}s | collective "
          f"{res['an_collective_s']:.4f}s -> {res['an_bottleneck']}")
    print(f"  collectives: {res['collective_counts']}")
    print(f"  flops/device over model flops/device: "
          f"{1 / res['useful_flops_ratio']:.3f}; split over 'model': "
          f"{res['model_split']['split']}, whole on every 'model' rank: "
          f"{res['model_split']['repeat']}")
    print(f"  fits {mesh_lib.HBM_BYTES / 1e9:.0f}G HBM: {res['fits_hbm']} "
          f"(temp {res['temp_bytes_per_device'] / 2**30:.2f} GiB/device)")
    return res


if __name__ == "__main__":
    main()
