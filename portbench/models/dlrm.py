"""The program side of the DLRM cells: ``repro_torch``'s DLRM built from a
configuration file's sizes, its state restored from the benchmark's
weights, and the reads that the checks and the counters need.

The configuration file, not ``repro_torch/configs``, gives every size, so a
later edit of the program's configs cannot move the yardstick.  The state
is the program's own (``DLRM.init`` with the stream's frequency counts, as
the paper's deployment ranks its rows), then overwritten leaf by leaf, as a
checkpoint restore does: the MLPs, the pinned host table (each global id's
row at its ranked host row, ``idx_map``), and the arena rows that the
warm-up filled, read back from the restored table.
"""
from __future__ import annotations

import gc
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["Program"]


def program_config(cfg: Mapping):
    """The ``DLRMConfig`` of a configuration file."""
    from repro_torch.core.policies import Policy
    from repro_torch.models.dlrm import DLRMConfig

    return DLRMConfig(
        vocab_sizes=tuple(int(v) for v in cfg["vocab_sizes"]), n_dense=int(cfg["n_dense"]),
        embed_dim=int(cfg["embed_dim"]), bottom_mlp=tuple(cfg["bottom_mlp"]),
        top_mlp=tuple(cfg["top_mlp"]), batch_size=int(cfg["batch_size"]),
        cache_ratio=float(cfg["cache_ratio"]), buffer_rows=int(cfg["buffer_rows"]),
        max_unique_per_step=int(cfg["max_unique_per_step"]), lr=float(cfg["lr"]),
        policy=Policy(cfg["policy"]), use_pallas_plan=bool(cfg["use_pallas_plan"]),
        host_precision=cfg["host_precision"], arena_precision=cfg["arena_precision"],
    )


class Program:
    """One DLRM of the program, its state, and (for serving) its engine."""

    def __init__(self, cfg: Mapping, mlp: Mapping[str, torch.Tensor],
                 table_chunks: Iterator[Tuple[int, torch.Tensor]], device: torch.device,
                 counts: Optional[np.ndarray] = None):
        from repro_torch.core.collection import SHARED_ARENA
        from repro_torch.models.dlrm import DLRM

        self.cfg, self.device = cfg, device
        self.model = DLRM(program_config(cfg))
        state = self.model.init(0, counts=counts, device=device)
        slab = state["emb"].slabs[SHARED_ARENA]
        self._row = slab.idx_map.to(torch.int64).cpu()  # global id -> host row
        with torch.no_grad():
            for name, value in mlp.items():
                self._leaf(state, name).copy_(value)
            for r0, rows in table_chunks:
                slab.full.write_at(self._row[r0 : r0 + rows.shape[0]], {"weight": rows})
            arena = slab.cache.cached_rows
            if not isinstance(arena, dict):
                raise ValueError("the adapter restores an fp32 arena only")
            slots = torch.nonzero(slab.cache.slot_to_row >= 0)[:, 0]
            rows = slab.cache.slot_to_row[slots].to(torch.int64).cpu()
            arena["weight"][slots] = slab.full.decode_rows(rows)["weight"].to(device)
        self.state = state
        self.engine = None
        self._slab = SHARED_ARENA
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @staticmethod
    def _leaf(state, name: str) -> torch.Tensor:
        tower, i, kind = name.split(".")
        return state["params"][tower][f"l{i}"][kind]

    # ----- the timed paths ---------------------------------------------------
    def train_step(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """One ``DLRM.train_step``; returns its loss on the device."""
        self.state, m = self.model.train_step(self.state, batch)
        return m["loss"]

    def serve_engine(self):
        """The ``ServeEngine`` over ``DLRM.serve_step`` at the configured batch."""
        from repro_torch.serve.engine import ServeEngine

        cfg = self.cfg
        pad = {"dense": np.zeros((cfg["n_dense"],), np.float32),
               "sparse": np.zeros((len(cfg["vocab_sizes"]),), np.int32),
               "label": np.zeros((), np.float32)}
        self.engine = ServeEngine(self.model.serve_step, self.state,
                                  batch_size=int(cfg["batch_size"]), pad_example=pad,
                                  device=self.device)
        return self.engine

    # ----- reads -------------------------------------------------------------
    def _state(self):
        return self.engine.state if self.engine is not None else self.state

    def params(self) -> Dict[str, torch.Tensor]:
        """A copy of every MLP tensor, by the benchmark's names."""
        out = {}
        for tower, layers in self._state()["params"].items():
            for lname, leaves in layers.items():
                for kind, v in leaves.items():
                    out[f"{tower}.{lname[1:]}.{kind}"] = v.detach().clone()
        return out

    def flush(self) -> None:
        """The cache barrier: the host table takes every resident row."""
        self.state = self.model.flush(self.state)

    def host_rows(self, gids: torch.Tensor) -> torch.Tensor:
        """Host-table rows of global ids (after :meth:`flush`: the
        program's rows), on the device."""
        full = self._state()["emb"].slabs[self._slab].full
        return full.decode_rows(self._row[gids.to(torch.int64).cpu()])["weight"].to(self.device)

    def host_block(self, r0: int, n: int) -> torch.Tensor:
        """The host-table rows of global ids ``r0 .. r0 + n``, on the device."""
        full = self._state()["emb"].slabs[self._slab].full
        return full.decode_rows(self._row[r0 : r0 + n])["weight"].to(self.device)

    def counters(self, writeback: bool) -> Dict[str, int]:
        """The cache's cumulative counters (int32, wrapping): id hits, row
        misses, and the rows moved over the host link with their bytes a
        row (misses, plus write-backs when ``writeback``)."""
        from repro_torch.obs.hub import fetch_ints

        m = self.model.collection.metrics(self._state()["emb"], writeback=writeback)
        got = fetch_ints({"hits": m["slab_hits"], "misses": m["cache_misses"],
                          "moved": m["host_moved_rows"], "row_bytes": m["host_row_bytes"]})
        return {"hits": sum(got["hits"].values()), "misses": got["misses"],
                "moved_rows": sum(got["moved"].values()),
                "row_bytes": max(got["row_bytes"].values())}

    def close(self) -> None:
        """Unpin the host table and drop the state."""
        self._state()["emb"].slabs[self._slab].full.close()
        self.state = self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
