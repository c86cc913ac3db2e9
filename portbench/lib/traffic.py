"""The general traffic generator: a mix file's parameters, a configuration's
sizes and ``--seed`` give every batch of a run.

A mix (``portbench/traffic/<mix>.json``) names its ``generator`` and the
``mode`` that drives it; this module holds the generators.  ``zipf`` is the
formula of ``repro_torch.data.synth.sparse_batch``, rewritten in torch so
that it runs on the card: one id per field, field ``f``'s ids drawn from a
truncated Zipf of exponent ``zipf_a`` over its vocabulary by the inverse of
the continuous CDF (the id is the popularity rank; ``zipf_a`` 1.2 sends
about 90 % of the accesses to under 1 % of the ids), dense features
N(0, 1), and a click label that follows a hidden function of the hashed ids
plus N(0, ``label_noise``) noise.  Batch ``i`` is a pure function of
(seed, i): each batch draws from its own generator, seeded by a hash of
both, so it can be made again after the run for the checks.

:meth:`Zipf.counts` gives the frequency counts that the paper's one scan of
the dataset would give this stream: each id's expected occurrences, from
the same formula.  The program ranks its rows by them (FREQ_LFU), so an id
ranks by its popularity over the whole table, not by its global id.

:class:`Ahead` makes batch ``i + 1`` on a side stream of the card while the
caller runs batch ``i``, so the host never paces generation.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["Ahead", "Zipf", "stream_seed", "make"]


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed from the run's seed and a stream's name and
    index (any Python ints; the driver's seeds exceed 32 bits)."""
    text = ":".join(str(p) for p in (int(seed),) + parts).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


SCAN_SAMPLES = 1 << 60  # the notional scan's length: an id seen once in 1e9 still counts ~1e9


class Zipf:
    """Criteo-style batches of ``cfg``'s fields under a ``zipf`` mix."""

    def __init__(self, cfg: Mapping, mix: Mapping, seed: int, device: torch.device,
                 batch_size: Optional[int] = None):
        self.vocabs = [int(v) for v in cfg["vocab_sizes"]]
        self.n_dense = int(cfg["n_dense"])
        self.batch = int(batch_size or cfg["batch_size"])
        self.a = float(mix["zipf_a"])
        self.noise = float(mix["label_noise"])
        self.seed = int(seed)
        self.device = device
        v = torch.tensor(self.vocabs, dtype=torch.float64, device=device)
        one_a = 1.0 - self.a
        # inverse CDF of the truncated Zipf: ((u h (1 - a)) + 1)^(1 / (1 - a)) - 1
        self._scale = (v ** one_a - 1.0)  # h (1 - a), one per field
        self._exp = 1.0 / one_a
        self._vmax = torch.tensor(self.vocabs, dtype=torch.int64, device=device) - 1
        self._mult = torch.arange(1, len(self.vocabs) + 1, dtype=torch.int64, device=device)

    def batch_at(self, i: int) -> Dict[str, torch.Tensor]:
        """Batch ``i``: ``sparse`` int32 [B, F] (field-local ids), ``dense``
        float32 [B, n_dense], ``label`` float32 [B], on the device."""
        gen = torch.Generator(device=self.device).manual_seed(stream_seed(self.seed, "batch", i))
        b, f = self.batch, len(self.vocabs)
        u = torch.rand((b, f), generator=gen, dtype=torch.float64, device=self.device)
        ids = torch.pow(u * self._scale + 1.0, self._exp) - 1.0
        ids = torch.minimum(ids.to(torch.int64).clamp_min_(0), self._vmax)
        out = {"sparse": ids.to(torch.int32)}
        if self.n_dense:
            out["dense"] = torch.randn((b, self.n_dense), generator=gen, dtype=torch.float32,
                                       device=self.device)
        h = ((ids * self._mult) % 97).sum(1).to(torch.float64) / (97.0 * f)
        noise = torch.randn((b,), generator=gen, dtype=torch.float64, device=self.device)
        out["label"] = ((h + self.noise * noise) > 0.5).to(torch.float32)
        return out

    def counts(self, samples: int = SCAN_SAMPLES) -> np.ndarray:
        """Each global id's expected occurrences in ``samples`` samples of
        the stream (int64 [sum(vocab)]): field ``f``'s id ``r`` comes up with
        probability ``((r + 2)^(1 - a) - (r + 1)^(1 - a)) / ((V_f)^(1 - a) - 1)``,
        the mass of ``[r, r + 1)`` under the inverse CDF :meth:`batch_at` draws
        by (its last id only at ``u = 1``, so never)."""
        one_a = 1.0 - self.a
        out = []
        for v in self.vocabs:
            if v == 1:
                out.append(np.full((1,), samples, np.int64))
                continue
            r = np.arange(v, dtype=np.float64)
            p = ((r + 2.0) ** one_a - (r + 1.0) ** one_a) / (v ** one_a - 1.0)
            p[-1] = 0.0
            out.append(np.floor(p * samples).astype(np.int64))
        return np.concatenate(out)

    def global_ids(self, sparse: torch.Tensor) -> torch.Tensor:
        """Field-local ids [B, F] -> ids into the concatenated table (int64)."""
        off = torch.tensor([0] + self.vocabs[:-1], dtype=torch.int64,
                           device=sparse.device).cumsum(0)
        return sparse.to(torch.int64) + off


GENERATORS = {"zipf": Zipf}


def make(cfg: Mapping, mix: Mapping, seed: int, device: torch.device, **kw):
    """The mix's generator over the configuration's sizes."""
    name = mix["generator"]
    if name not in GENERATORS:
        raise ValueError(f"traffic generator {name!r} unknown; have {sorted(GENERATORS)}")
    return GENERATORS[name](cfg, mix, seed, device, **kw)


class Ahead:
    """Batches of a generator, one made ahead on a side stream of the card
    (on the CPU, made when asked).  ``get(i)`` returns batch ``i``, ready on
    the current stream, and starts batch ``i + 1``."""

    def __init__(self, gen, start: int = 0):
        self.gen = gen
        self.cuda = gen.device.type == "cuda"
        self.side = torch.cuda.Stream(device=gen.device) if self.cuda else None
        self.next_i, self.next = None, None
        self._start(start)

    def _start(self, i: int) -> None:
        self.next_i = i
        if self.cuda:  # no wait on the current stream: the two overlap
            with torch.cuda.stream(self.side):
                self.next = self.gen.batch_at(i)
        else:
            self.next = self.gen.batch_at(i)

    def get(self, i: int) -> Dict[str, torch.Tensor]:
        if i != self.next_i:
            self._start(i)
        out = self.next
        if self.cuda:
            main = torch.cuda.current_stream(self.gen.device)
            main.wait_stream(self.side)
            for t in out.values():
                t.record_stream(main)
        self._start(i + 1)
        return out
