"""Spawned gloo worlds for the port's multi-rank tests on the CPU.

``run_world(fn, world, tmp_path, *args)`` starts ``world`` processes
(``torch.multiprocessing``, spawn), each starting a ``gloo`` group whose
rendezvous is a file under ``tmp_path`` (never a fixed port: test workers
run side by side), calls ``fn(rank, world, *args)`` and returns rank 0's
result.  A world costs seconds to start, so a test file groups its checks
into one world whose result holds one entry a check (``checks``: name ->
value, or the traceback text of a check that raised), and parametrised
tests read the entries.  This module imports neither ``jax`` nor
``repro``: the children import it, and only what the checks need.
"""
import os
import pickle
import traceback

import torch
import torch.multiprocessing as mp


def _child(rank, world, rdzv, out, fn, args):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_process_group("cpu", init_method=f"file://{rdzv}",
                                rank=rank, world_size=world, timeout_s=120)
    try:
        res = fn(rank, world, *args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_world(fn, world, tmp_path, *args):
    rdzv = os.path.join(str(tmp_path), "rdzv")
    out = os.path.join(str(tmp_path), "rank0.pkl")
    mp.start_processes(_child, args=(world, rdzv, out, fn, args),
                       nprocs=world, start_method="spawn", join=True)
    with open(out, "rb") as f:
        return pickle.load(f)


def checks(pairs):
    """Run ``(name, thunk)`` pairs in order: name -> the thunk's value,
    or ``("raised", traceback text)``."""
    out = {}
    for name, thunk in pairs:
        try:
            out[name] = thunk()
        except Exception:           # the test of that name reports it
            out[name] = ("raised", traceback.format_exc())
    return out


def value(results, name):
    """A check's value; a check that raised fails the test with its
    traceback."""
    v = results[name]
    if isinstance(v, tuple) and len(v) == 2 and v[0] == "raised":
        raise AssertionError(f"{name} raised on rank 0:\n{v[1]}")
    return v
