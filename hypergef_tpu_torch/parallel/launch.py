"""Spawn a world of ranks on this host, run a function in each, gather the
results.

The port's launcher, with no JAX counterpart (JAX's single controller needs
none). The CLI's ``--shards``, the tests and ``chip_smoke.py`` start their
worlds here:

* each rank is a fresh process (``multiprocessing``'s spawn: no state of the
  parent, JAX's included, is inherited) that joins the group through a
  ``file://`` store in a temporary directory of its own, so that worlds of
  concurrent test workers never meet, with a timeout on every collective;
* the function is a picklable module-level callable; it runs after
  :func:`~.mesh.init_distributed`, so ``mesh.make_mesh()`` gives its view;
* the function and its arguments are pickled once, to a file each rank
  reads when it starts: a spawned child unpickles what its parent hands it
  through a pipe while it imports the modules that names (torch among
  them), and the parent blocks on that pipe, so a plan handed that way
  starts the ranks one after another (on an H100 host four ranks took
  33-37 s to join, against 9-12 s with no plan);
* each rank writes its result (pickled) or its traceback to a file, and the
  parent joins the world with a deadline: a rank that fails or outlives it
  ends the world (the others are terminated) with an error naming each
  rank's traceback, never a hang;
* a world is one host, so its ranks talk over the loopback interface
  (``GLOO_SOCKET_IFNAME``/``NCCL_SOCKET_IFNAME`` ``lo`` unless set), and
  resolve no host name;
* :data:`last_world` holds the last world's timeline: each rank's seconds
  from the spawn to its function's start (imports and the group joined) and
  to its end.

Build what every rank needs in the parent first (the CUDA kernels, the
native host library, the plans), so that the ranks do not each build it.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

from hypergef_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S


# the last world's timeline (seconds since its spawn), see the module's notes
last_world: dict = {}


class RankError(RuntimeError):
    """A rank of a spawned world failed, or the world outlived its deadline."""


def _rank_main(call: str, rank: int, world: int, backend: str, platform: str, store: str,
               out_dir: str, timeout_s: float, threads: int) -> None:
    import torch
    import torch.distributed as dist

    from hypergef_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(threads)
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        os.environ.setdefault(var, "lo")
    try:
        with open(call, "rb") as fh:
            fn, args = pickle.load(fh)
        init_distributed(backend, platform, init_method=f"file://{store}", world_size=world,
                         rank=rank, local_rank=rank, local_world=world, timeout_s=timeout_s)
        joined = time.time()
        result = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.times"), "w") as fh:
            fh.write(f"{joined} {time.time()}")
        tmp = os.path.join(out_dir, f"rank{rank}.pkl.tmp")
        with open(tmp, "wb") as fh:
            pickle.dump(result, fh)
        os.replace(tmp, os.path.join(out_dir, f"rank{rank}.pkl"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        os._exit(1)


def spawn(fn: Callable[..., Any], world: int, backend: str = "gloo", platform: str = "cpu",
          args: Sequence = (), timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` in each of ``world`` ranks; returns their results in
    rank order. ``platform`` is ``"cpu"`` or ``"cuda"`` (see
    :func:`~.mesh.rank_device` for the backend's rule); ``timeout_s`` bounds
    each collective and the whole world. Raises :class:`RankError` if a rank
    fails or the world is not done by then. A CPU rank computes on one
    thread, a CUDA rank's host on two, so a world does not oversubscribe
    the host's cores."""
    if world < 1:
        raise ValueError(f"world must be at least 1, got {world}")
    global last_world
    threads = 1 if platform == "cpu" else 2
    root = tempfile.mkdtemp(prefix="hypergef_world_")
    t0 = time.time()
    ctx = mp.get_context("spawn")
    call = os.path.join(root, "call.pkl")
    with open(call, "wb") as fh:
        pickle.dump((fn, tuple(args)), fh)
    procs = [ctx.Process(target=_rank_main, daemon=False,
                         args=(call, r, world, backend, platform, os.path.join(root, "store"),
                               root, timeout_s, threads))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (0,)]
        if failed:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.exitcode is None:
                    p.kill()
                    p.join()
            errs = []
            for r in range(world):
                path = os.path.join(root, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as fh:
                        errs.append(f"rank {r}:\n{fh.read()}")
            what = ("ranks failed" if any(procs[r].exitcode not in (None, -15, -9)
                                          for r in failed) else
                    f"the world outlived its {timeout_s} s deadline")
            raise RankError(f"{what} (exit codes {[p.exitcode for p in procs]})\n"
                            + "\n".join(errs))
        results, times = [], []
        for r in range(world):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
            with open(os.path.join(root, f"rank{r}.times")) as fh:
                joined, done = (float(v) for v in fh.read().split())
            times.append({"joined_s": joined - t0, "done_s": done - t0})
        last_world = {"world": world, "backend": backend, "platform": platform,
                      "joined_s": max(t["joined_s"] for t in times),
                      "wall_s": time.time() - t0, "ranks": times}
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)


def _counters():
    from hypergef_tpu_torch.ops import (
        aligned_band, aligned_max, bitstream, ell_gather, fused_dense, segment_sum,
    )

    return {"fused": (fused_dense, "launches"), "gather": (ell_gather, "launches"),
            "band": (aligned_band, "launches"), "argmax": (aligned_max, "argmax_launches"),
            "argsum": (aligned_max, "argsum_launches"), "bitmm": (bitstream, "launches"),
            "segsum": (segment_sum, "launches"), "recsum": (segment_sum, "record_launches")}


def kernel_launches() -> dict:
    """This process's launch count of each kernel (the wrappers' counters),
    for a rank to report to its parent."""
    return {k: getattr(m, a) for k, (m, a) in _counters().items()}


def reset_kernel_launches() -> None:
    for m, a in _counters().values():
        setattr(m, a, 0)
