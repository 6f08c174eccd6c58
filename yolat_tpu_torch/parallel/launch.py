"""Start one process per local rank and collect what each returns.

The port's counterpart of starting a JAX process per host: the CLIs and
the tests run `fn(local_rank, store_path, *args)` in `n_ranks` processes
started by `torch.multiprocessing.spawn`, each of which joins the run
through `distributed.initialize_from_config(..., store_path=)` (a
FileStore in a temporary directory, so ranks on one node need no port).
A rank that raises ends the others and its traceback is raised here; past
`join_timeout_s` every rank is killed and TimeoutError raised, so a hung
collective fails its caller instead of holding it.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.multiprocessing as mp


def _rank_main(local_rank: int, fn, workdir: str, args: tuple) -> None:
    out = fn(local_rank, os.path.join(workdir, "store"), *args)
    torch.save(out, os.path.join(workdir, f"rank{local_rank}.pt"))


def spawn_ranks(fn, n_ranks: int, args: tuple = (),
                join_timeout_s: float | None = None) -> list:
    """fn's return values, by local rank. fn must be importable by name
    (a module-level function): each process imports it afresh."""
    with tempfile.TemporaryDirectory(prefix="yolat_ranks_") as workdir:
        ctx = mp.spawn(_rank_main, args=(fn, workdir, args), nprocs=n_ranks,
                       join=False)
        deadline = (None if join_timeout_s is None
                    else time.monotonic() + join_timeout_s)
        try:
            while not ctx.join(timeout=5.0 if deadline is None else max(
                    0.0, min(5.0, deadline - time.monotonic()))):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{n_ranks} ranks still running after "
                                       f"{join_timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        # written by the ranks above, read back here only
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]
