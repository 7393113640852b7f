"""Run one program in W ranks on this machine — the counterpart of the 8
virtual devices that fhe_study_tpu's multi-chip code runs on, and of
tests/test_distributed.py's launcher.

    results = spawn(pipeline.dryrun, world=8, device="cpu", backend="gloo",
                    timeout_s=300, args=(8,))

Each rank is a process of the ``spawn`` start method (a fork after CUDA is
initialized breaks it).  The ranks meet through a ``FileStore`` in a fresh
temporary directory, not a port, so that calls in parallel processes never
collide.  ``fn(*args)`` runs in every rank after ``init_process_group``
and its return value comes back to the caller, one per rank, in rank
order.  ``fn`` is called by reference, so it must be a module-level
function of this package: a rank imports neither a test module nor jax.

Arguments and results cross as pickles; ``to_rank`` / ``from_rank`` turn
numpy arrays into tensors on the rank's device and back, through tuples,
lists, dicts and NamedTuples.  ``calls`` is a rank program of plain calls
of the package's functions, a ``MeshOf`` standing for a mesh built in the
rank.

On a CUDA device a rank never builds the kernels: ``spawn`` builds (or
loads) them in the caller first, and a rank that finds no built library
raises.  Every rank takes the device ``cuda:rank % device_count``, so on one
card all ranks share it (NCCL refuses that; gloo stages through the host,
parallel/comm.py).  Any rank's failure, or ``timeout_s`` passing, kills
every rank and raises; the collectives get the same timeout.
"""

import datetime
import multiprocessing
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist


def to_rank(obj, device):
    """numpy arrays -> tensors on ``device``, through containers."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj)).to(device)
    return _map(obj, lambda v: to_rank(v, device))


def from_rank(obj):
    """tensors -> numpy arrays (on the host), through containers."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return _map(obj, from_rank)


def _map(obj, f):
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(f(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(f(v) for v in obj)
    if isinstance(obj, dict):
        return {k: f(v) for k, v in obj.items()}
    return obj


class MeshOf(NamedTuple):
    """Stands, among the arguments of a ``calls`` step, for the mesh that
    ``build(*args)`` makes in the rank."""
    build: Callable
    args: tuple = ()


def calls(*steps) -> list:
    """A rank program of plain calls: each step (fn, args) in order, a
    ``MeshOf`` among the arguments replaced by its mesh (built once a
    step); returns the results in order."""
    out = []
    for fn, args in steps:
        out.append(fn(*(a.build(*a.args) if isinstance(a, MeshOf) else a
                        for a in args)))
    return out


def rank_device(device: str, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank, world, device, backend, store_path, timeout_s,
               call_path, results):
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        dev = rank_device(device, rank)
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        if dev.type == "cuda":
            from ..ops import _cuda
            if not (_cuda.build_dir() / _cuda.LIB_NAME).is_file():
                raise RuntimeError("no built kernel library: the launching "
                                   "process builds it before the ranks start")
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*to_rank(args, dev))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            dist.destroy_process_group()
        # pickled here, so that a result that does not pickle is this
        # rank's failure (Queue.put pickles in a thread of its own)
        results.put((rank, True, pickle.dumps(from_rank(out))))
    except BaseException:  # reported to the caller, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, device: str = "cuda", backend: str | None = None,
          timeout_s: float = 300.0, args: tuple = ()) -> list:
    """``fn(*args)`` in ``world`` ranks; returns their results by rank.
    ``backend`` None: NCCL on CUDA, gloo on the CPU."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if torch.device(device).type == "cuda":
        from ..ops import _cuda
        _cuda.library()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="fhe_spawn_") as tmp:
        store = os.path.join(tmp, "store")
        # the call goes by a file: a start() blocks until its child has read
        # the process's pickle, and a large one would start them one by one
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, device, backend, store,
                                   timeout_s, call, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout_s
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{fn.__name__} in {world} ranks: ranks "
                        f"{sorted(set(range(world)) - set(got))} gave no "
                        f"result within {timeout_s} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        # a result may still be in the pipe: one more look
                        try:
                            rank, ok, out = results.get(timeout=1.0)
                        except queue_mod.Empty:
                            raise RuntimeError(
                                f"{fn.__name__}: ranks {dead} exited "
                                f"({[procs[r].exitcode for r in dead]}) "
                                "without a result") from None
                    else:
                        continue
                if not ok:
                    raise RuntimeError(f"{fn.__name__}: rank {rank} of "
                                       f"{world} failed:\n{out}")
                got[rank] = pickle.loads(out)
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=5.0)
            results.close()
    return [got[r] for r in range(world)]
