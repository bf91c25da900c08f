"""Start a world of ranks on one host, one process a rank, and collect
what each returns.

``run_world(fn, world_size, args, backend=...)`` spawns ``world_size``
processes (the ``spawn`` start method: each child imports the module of
``fn`` afresh, so that module must import neither JAX nor the JAX
package), joins them into one process group through a ``FileStore`` in a
temporary directory (``file://`` init: no TCP port, so worlds of several
test workers never collide), calls ``fn(*args)`` in each and returns the
ranks' return values in rank order, passed back through files.  A rank
that raises fails the whole world: the others are killed (they would wait
in their next collective for ever) and the rank's traceback is raised.
``torchrun`` is the launcher for a user's run across cards; this one is for
the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Sequence

__all__ = ["run_world"]


def _rank_main(fn: Callable, args: Sequence, rank: int, world_size: int, backend: str, tmp: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=rank, world_size=world_size)
        out = fn(*args)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    part = os.path.join(tmp, f"rank{rank}.part")
    with open(part, "wb") as f:
        pickle.dump(out, f)
    os.replace(part, os.path.join(tmp, f"rank{rank}.pkl"))


def _tracebacks(tmp: str) -> str:
    """The tracebacks that the failed ranks wrote, the first written first
    (a rank whose peer died fails in its next collective, after it)."""
    errs = sorted(Path(tmp).glob("*.err"), key=lambda f: f.stat().st_mtime)
    return "\n".join(f"{f.stem}: {f.read_text()}" for f in errs) or "(no traceback)"


def run_world(fn: Callable, world_size: int, args: Sequence = (), *, backend: str = "gloo",
              timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` on every rank of a new world of ``world_size``
    processes over ``backend``; returns the ranks' results in rank order.
    Raises RuntimeError if a rank fails and TimeoutError after ``timeout``
    seconds; no rank outlives the call."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pt_world_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(fn, tuple(args), rank, world_size, backend, tmp))
                 for rank in range(world_size)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            while not all(p.exitcode == 0 for p in procs):
                failed = [(rank, p.exitcode) for rank, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"ranks of a world of {world_size} exited with {failed}:\n{_tracebacks(tmp)}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world_size} ranks did not finish in {timeout} s")
                time.sleep(0.05)
            results = []
            for rank in range(world_size):
                with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            for p in procs:
                if p.exitcode is None and p.pid is not None:
                    p.kill()
                if p.pid is not None:
                    p.join()
