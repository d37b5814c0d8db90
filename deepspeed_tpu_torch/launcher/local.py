"""A data-parallel world of processes on one host.

:func:`run_local_world` spawns ``world_size`` processes (the ``spawn``
start method: each starts from a fresh interpreter and imports only what
``target`` needs), joins them into one ``torch.distributed`` group through
a file store under ``store_dir``, runs ``target(rank, *args)`` in each and
returns the results in rank order. ``target`` must be a module-level
function; its arguments and result are pickled.

A rank that raises, or dies, fails the world: the others are killed (a
peer blocked in a collective would otherwise wait for its timeout) and
:func:`run_local_world` raises with every rank's error. Every process it
starts has ended when it returns or raises.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Any, Callable, List, Sequence


def _rank_main(target: Callable, rank: int, world_size: int, backend: str,
               init_method: str, args: Sequence[Any], threads: int,
               results) -> None:
    import torch

    from .. import comm

    if threads:
        torch.set_num_threads(threads)
    try:
        comm.init_distributed(backend, init_method=init_method,
                              world_size=world_size, rank=rank)
        results.put((rank, True, target(rank, *args)))
    except BaseException:  # reported to the parent, which fails the world
        results.put((rank, False, traceback.format_exc()))
    finally:
        comm.destroy_process_group()


def run_local_world(target: Callable, world_size: int, args: Sequence = (),
                    *, store_dir: str, backend: str = "gloo",
                    threads: int = 1, timeout_s: float = 600.0) -> List[Any]:
    """Run ``target(rank, *args)`` on each rank of a ``world_size`` world.

    ``backend`` is the process group's (``"gloo"``: CPU tensors, or ranks
    sharing one GPU; ``"nccl"``: one GPU per rank). ``threads`` sets each
    rank's ``torch.set_num_threads`` (0 leaves it). → the ranks' results,
    in rank order."""
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store-{os.getpid()}-{time.time_ns()}")
    init_method = f"file://{store}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(target, rank, world_size, backend,
                               init_method, tuple(args), threads, results),
                         daemon=True)
             for rank in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    errors: List[str] = []
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) + len(errors) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    errors.append(f"rank(s) {dead} died (exit codes "
                                  f"{[procs[r].exitcode for r in dead]})")
                    break
                if time.monotonic() > deadline:
                    errors.append(f"the world did not finish in "
                                  f"{timeout_s:.0f} s")
                    break
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            if errors:
                p.kill()
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        results.close()
        if os.path.exists(store):
            os.remove(store)
    if errors:
        raise RuntimeError("local world failed:\n" + "\n".join(errors))
    return [out[r] for r in range(world_size)]
