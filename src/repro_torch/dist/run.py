"""The rank worker: spawn a hybrid-parallel world and run a job on every rank.

``run_ranks(fn, world, backend, device, args)`` refuses a world the backend
cannot run, spawns ``world`` processes through
``torch.multiprocessing.spawn`` (they meet through a ``FileStore`` in a
fresh temp dir), runs ``fn(rank, device, *args)`` on each and returns each
rank's result in rank order.  A rank that raises makes ``run_ranks`` raise:
no failure is caught here.  Each spawned process imports the module that
owns ``fn`` (by name, on the parent's ``sys.path``) and this one, so this
one imports neither a test module nor JAX.  :func:`launch` and
:func:`launch_rank` are ``launch/train.py --ranks`` and ``launch/serve.py
--ranks``.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from repro_torch.device import DeviceLike
from repro_torch.dist import group

__all__ = ["launch", "launch_rank", "run_ranks"]


def run_ranks(fn: Callable[..., Any], world: int, backend: str = "gloo",
              device: DeviceLike = None, args: Sequence[Any] = (),
              threads: Optional[int] = None) -> List[Any]:
    """``fn(rank, device, *args)`` on ``world`` spawned ranks; their results
    in rank order.  ``threads`` sets each rank's torch CPU threads."""
    group.check_world(backend, world, device)
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as d:
        # the job reaches the ranks through a file, not the spawn pipe: a
        # spawned process reads its spawn arguments only after its imports,
        # and the parent's write of a large one blocks until then, so each
        # rank would start only once the one before it had imported
        with open(os.path.join(d, "job.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f, protocol=pickle.HIGHEST_PROTOCOL)
        mp.spawn(_entry, args=(world, backend, d, device, threads), nprocs=world, join=True)
        return [torch.load(os.path.join(d, f"result_{r}.pt"), weights_only=False)
                for r in range(world)]


def _entry(rank: int, world, backend, d, device, threads) -> None:
    if threads:
        torch.set_num_threads(threads)
    with open(os.path.join(d, "job.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    dev = group.init_ranks(backend, rank, world, d, device)
    try:
        torch.save(fn(rank, dev, *args), os.path.join(d, f"result_{rank}.pt"))
    finally:
        group.close_ranks()


# ----- the launcher -------------------------------------------------------------


def launch(launcher: str, ranks: int, backend: str, device: DeviceLike,
           argv: Sequence[str]) -> Any:
    """``launch/<launcher>.py --ranks``: where ``RANK`` and ``WORLD_SIZE``
    are set, join torchrun's world as that rank and run the launcher's
    ``run_rank`` here; else spawn the ranks and return their results."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != ranks:
            raise SystemExit(f"--ranks {ranks} in a torchrun world of {world}")
        dev = group.init_ranks(backend, int(os.environ["RANK"]), world, None, device)
        try:
            return launch_rank(int(os.environ["RANK"]), dev, launcher, argv)
        finally:
            group.close_ranks()
    return run_ranks(launch_rank, ranks, backend, device, (launcher, list(argv)))


def launch_rank(rank: int, dev: torch.device, launcher: str, argv: Sequence[str]) -> Any:
    """One rank of ``launch/<launcher>.py --ranks`` (``train`` or ``serve``):
    the launcher's run on this rank's mesh (its ``run_rank``)."""
    import importlib

    return importlib.import_module(f"repro_torch.launch.{launcher}").run_rank(list(argv), dev)
