"""Process-group bring-up for the hybrid-parallel ranks.

The backend is the caller's choice and is never found by trying one:

* ``"nccl"``: one card a rank, ``cuda:{rank}``.  NCCL refuses two ranks on
  one GPU, so a world larger than the host's card count raises before any
  rank starts.
* ``"gloo"``: CPU ranks (``device="cpu"``), or ranks sharing the card(s),
  rank ``r`` on ``cuda:{r % cards}``.  Gloo takes CUDA tensors in the
  collectives the exchange uses (``all_gather`` of a tensor list,
  ``broadcast``) and stages them through the host itself.

Ranks meet through a ``FileStore`` in a directory the launcher makes (or,
with no directory, through torchrun's ``env://``).  Every collective has a
timeout of :data:`TIMEOUT_S`, so a rank whose peer died fails instead of
waiting for ever.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["BACKENDS", "TIMEOUT_S", "check_world", "close_ranks", "init_ranks", "rank_device"]

BACKENDS = ("gloo", "nccl")
TIMEOUT_S = 300


def check_world(backend: str, world: int, device: DeviceLike = None) -> None:
    """Refuse a world the backend cannot run, before any rank starts."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: choose one of {BACKENDS}")
    if world < 1:
        raise ValueError(f"a world of {world} ranks")
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"backend nccl runs one card a rank; device {device!r} takes gloo")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(f"backend nccl with {world} ranks needs {world} cards and this host "
                             f"has {cards}: NCCL refuses two ranks on one GPU (gloo shares one)")


def rank_device(rank: int, device: DeviceLike = None) -> torch.device:
    """Rank ``rank``'s device: ``cuda:{rank % cards}`` unless the caller
    names one (``"cpu"``, or a CUDA index); no card raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_ranks(backend: str, rank: int, world: int, rendezvous_dir: Optional[str] = None,
               device: DeviceLike = None, timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the world as ``rank`` of ``world`` and return the rank's device
    (made current on a card)."""
    check_world(backend, world, device)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if rendezvous_dir is None:
        kw["init_method"] = "env://"
    else:
        kw["store"] = dist.FileStore(os.path.join(rendezvous_dir, "store"), world)
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return dev


def close_ranks() -> None:
    """Leave the world (safe to call when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
