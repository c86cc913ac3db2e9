"""The plain reference of the DLRM cells, and the weights they start from.

DLRM as Naumov et al. (2019, arXiv:1906.00091) describe it, with the dot
interaction: a bottom MLP (ReLU after every layer) over the dense features,
one embedding row per sparse field, the pairwise dot products of the
bottom output and the field rows (the strict upper triangle, row-major),
concatenated with the bottom output, then a top MLP (ReLU between the
layers) to one logit.  The loss is the mean binary cross-entropy on the
logit; training is plain SGD at one learning rate for the MLPs and the
rows.  Everything is fp32 with TF32 off; ``tf32=True`` gives the control,
whose matrix products round their operands to TF32 (``lib/tf32.py``).

The embedding table is one dense fp32 ``[sum(vocab), dim]`` tensor on the
device (17.3 GB for Criteo): a row is read by its global id, the field's
local id plus the field's offset.  A training step reads the batch's
distinct rows, differentiates the loss w.r.t. them and the MLPs, and
writes the stepped rows back.

The weights are the benchmark's inputs: drawn on the device from the run's
seed, in a few large calls, and handed to the program (by its adapter,
``portbench/models/dlrm.py``) and to this reference alike.  Weights are
uniform in +-1/sqrt(fan_in) (biases too), rows uniform in +-1/sqrt(dim).
This module imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import torch

from portbench.lib import tf32 as tf32_lib
from portbench.lib.traffic import stream_seed

__all__ = ["TABLE_CHUNK_ROWS", "bce", "dense_table", "draw_mlp", "forward", "mlp_dims",
           "leaf_norms", "offsets", "scores", "state_readings", "table_chunks",
           "train_readings"]

TABLE_CHUNK_ROWS = 1 << 22  # rows a call draws (2 GiB at dim 128): the draw's fixed split


def mlp_dims(cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Layer widths of both towers, inputs first."""
    f1 = len(cfg["vocab_sizes"]) + 1
    top_in = cfg["embed_dim"] + f1 * (f1 - 1) // 2
    return {"bottom": (cfg["n_dense"],) + tuple(cfg["bottom_mlp"]),
            "top": (top_in,) + tuple(cfg["top_mlp"]) + (1,)}


def offsets(cfg: Mapping, device) -> torch.Tensor:
    """Each field's first global id (int64 [F])."""
    v = torch.tensor([0] + list(cfg["vocab_sizes"][:-1]), dtype=torch.int64, device=device)
    return v.cumsum(0)


def draw_mlp(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Both towers' weights, ``{"bottom.0.w": [in, out], "bottom.0.b": [out], ...}``."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "mlp"))
    out = {}
    for tower, dims in mlp_dims(cfg).items():
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            bound = d_in ** -0.5
            wb = torch.rand((d_in + 1, d_out), generator=gen, dtype=torch.float32, device=device)
            wb = wb * (2 * bound) - bound
            out[f"{tower}.{i}.w"] = wb[:d_in].contiguous()
            out[f"{tower}.{i}.b"] = wb[d_in].contiguous()
    return out


def table_chunks(cfg: Mapping, seed: int, device) -> Iterator[Tuple[int, torch.Tensor]]:
    """The table's rows in global-id order, ``(first_id, rows)`` chunks of
    ``TABLE_CHUNK_ROWS`` drawn on ``device``."""
    vocab, dim = sum(cfg["vocab_sizes"]), cfg["embed_dim"]
    bound = dim ** -0.5
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "table"))
    for r0 in range(0, vocab, TABLE_CHUNK_ROWS):
        n = min(TABLE_CHUNK_ROWS, vocab - r0)
        rows = torch.rand((n, dim), generator=gen, dtype=torch.float32, device=device)
        yield r0, rows.mul_(2 * bound).sub_(bound)


def dense_table(cfg: Mapping, seed: int, device) -> torch.Tensor:
    """The whole initial table on ``device``."""
    out = torch.empty((sum(cfg["vocab_sizes"]), cfg["embed_dim"]), dtype=torch.float32,
                      device=device)
    for r0, rows in table_chunks(cfg, seed, device):
        out[r0 : r0 + rows.shape[0]] = rows
    return out


def forward(p: Mapping[str, torch.Tensor], dense: torch.Tensor, emb: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """Logits [B] from the weights ``p``, dense features [B, n_dense] and the
    field rows [B, F, D]."""
    mm = tf32_lib.matmul if tf32 else torch.matmul
    bmm = tf32_lib.matmul if tf32 else torch.bmm
    n_bottom = sum(1 for k in p if k.startswith("bottom.") and k.endswith(".w"))
    n_top = sum(1 for k in p if k.startswith("top.") and k.endswith(".w"))
    x = dense
    for i in range(n_bottom):
        x = torch.relu(mm(x, p[f"bottom.{i}.w"]) + p[f"bottom.{i}.b"])
    z = torch.cat([x[:, None, :], emb], dim=1)  # [B, F + 1, D]
    zz = bmm(z, z.transpose(1, 2))
    f1 = z.shape[1]
    iu, ju = torch.triu_indices(f1, f1, 1, device=z.device)
    t = torch.cat([x, zz[:, iu, ju]], dim=-1)
    for i in range(n_top):
        t = mm(t, p[f"top.{i}.w"]) + p[f"top.{i}.b"]
        if i < n_top - 1:
            t = torch.relu(t)
    return t[:, 0]


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits (the numerically stable form)."""
    z = logits
    return torch.mean(torch.clamp_min(z, 0) - z * labels + torch.log1p(torch.exp(-z.abs())))


def scores(cfg: Mapping, table: torch.Tensor, p: Mapping[str, torch.Tensor],
           batch: Mapping[str, torch.Tensor], tf32: bool = False) -> torch.Tensor:
    """The logits of a served batch."""
    gid = batch["sparse"].to(torch.int64) + offsets(cfg, table.device)
    with torch.no_grad():
        return forward(p, batch["dense"], table[gid], tf32)


def leaf_norms(p: Mapping[str, torch.Tensor], rows: torch.Tensor) -> Dict[str, float]:
    """The norm of each leaf of the state: every MLP tensor of ``p``, and
    the embedding table (``emb``), of which ``rows`` are the rows that can
    differ from zero."""
    out = {k: float(v.double().norm()) for k, v in p.items()}
    out["emb"] = float(rows.double().norm())
    return out


def state_readings(cfg: Mapping, p0: Mapping[str, torch.Tensor],
                   p1: Mapping[str, torch.Tensor], pn: Mapping[str, torch.Tensor],
                   e0_first: torch.Tensor, e1_first: torch.Tensor,
                   e0_union: torch.Tensor, en_union: torch.Tensor) -> Dict[str, Dict[str, float]]:
    """Each leaf's first gradient as the optimizer got it, worked out from
    the state after one step (``(p0 - p1) / lr``), and its change after
    the last step (``pn - p0``), as norms.  ``e*_first`` are the rows of
    the first batch's distinct ids before and after the first step, and
    ``e*_union`` the rows of all the steps' distinct ids at the start and at
    the end: no other row of the table can move.  The same arithmetic reads
    the program's states and the reference's.  ``change_rows`` keeps each
    of those rows' change, for the row-by-row check."""
    lr = float(cfg["lr"])
    grad = leaf_norms({k: (p0[k] - p1[k]) / lr for k in p0}, (e0_first - e1_first) / lr)
    change_rows = en_union - e0_union
    change = leaf_norms({k: pn[k] - p0[k] for k in p0}, change_rows)
    return {"grad_norms": grad, "change_norms": change, "change_rows": change_rows}


def train_readings(cfg: Mapping, table: torch.Tensor, p0: Mapping[str, torch.Tensor],
                   batches: Sequence[Mapping[str, torch.Tensor]], tf32: bool = False,
                   frozen: Optional[Tuple[int, int]] = None) -> Dict[str, object]:
    """SGD through ``batches`` from ``(table, p0)`` (the table is stepped in
    place): the loss of each step and :func:`state_readings`.  The rows of
    the global ids in ``frozen`` (``[lo, hi)``) keep their values: a
    dropped write-back, for the controls."""
    lr = float(cfg["lr"])
    off = offsets(cfg, table.device)
    gids = [b["sparse"].to(torch.int64) + off for b in batches]
    union = torch.unique(torch.cat([g.reshape(-1) for g in gids]))
    first_ids = torch.unique(gids[0])
    e0_union, e0_first = table[union].clone(), table[first_ids].clone()
    p, p1, e1_first, losses = dict(p0), None, None, []
    for step, (b, gid) in enumerate(zip(batches, gids)):
        uniq, inv = torch.unique(gid, return_inverse=True)
        leaf = {k: v.detach().requires_grad_() for k, v in p.items()}
        rows = table[uniq].requires_grad_()
        loss = bce(forward(leaf, b["dense"], rows[inv], tf32), b["label"])
        grads = torch.autograd.grad(loss, list(leaf.values()) + [rows])
        with torch.no_grad():
            p = {k: v.detach() - lr * g for (k, v), g in zip(leaf.items(), grads[:-1])}
            stepped = rows.detach() - lr * grads[-1]
            if frozen is not None:
                live = (uniq < frozen[0]) | (uniq >= frozen[1])
                uniq, stepped = uniq[live], stepped[live]
            table[uniq] = stepped
        losses.append(loss.item())
        if step == 0:
            p1, e1_first = p, table[first_ids].clone()
    out = state_readings(cfg, p0, p1, p, e0_first, e1_first, e0_union, table[union])
    return {"losses": losses, **out}
