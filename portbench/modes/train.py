"""Training cells: the program's train step driven back to back by one
closed-loop client, its loss fetched each step (the step's one sync, as the
program's ``Trainer`` does).

Set-up builds the program from the benchmark's weights and drives it
through the first three steps of the stream, through the window's own call
and feed; those steps warm every shape the window uses, and the reference
follows them after the run.  The window then runs steps ``3, 4, ...`` until
``--seconds`` have passed.  The traced run adds two profiled windows of
``TRACED_STEPS`` more steps each (``lib/trace.py``).

After the window (and after ``memory_peak_bytes`` is read) the program's
host table is flushed and compared, row by row, with the initial table:
a row that no step of the run touched must be unchanged (``stray_rows``).
Then the program is freed and the reference runs the first three steps.
"""
from __future__ import annotations

import math
import time

import torch

from portbench.lib import compare, flops, trace, traffic
from portbench.lib.harness import Run, sync

CHECKED_STEPS = 3  # the steps the reference follows
TRACED_STEPS = 8


def run(r: Run) -> dict:
    cfg, dev, ref = r.cfg, r.device, r.reference
    mlp = ref.draw_mlp(cfg, r.seed, dev)
    gen = traffic.make(cfg, r.mix, r.seed, dev)
    first = [gen.batch_at(i) for i in range(CHECKED_STEPS)]
    gids = [gen.global_ids(b["sparse"]) for b in first]
    union = torch.unique(torch.cat([g.reshape(-1) for g in gids]))
    first_ids = torch.unique(gids[0])
    e0 = {}

    def chunks():  # the table, with the first steps' rows kept as they start
        for r0, rows in ref.table_chunks(cfg, r.seed, dev):
            for name, ids in (("union", union), ("first", first_ids)):
                mine = ids[(ids >= r0) & (ids < r0 + rows.shape[0])]
                e0.setdefault(name, []).append(rows[mine - r0])
            yield r0, rows

    prog = r.model.Program(cfg, mlp, chunks(), dev, counts=gen.counts())
    e0 = {k: torch.cat(v) for k, v in e0.items()}
    step = r.hooks["train_step"](prog) if "train_step" in r.hooks else prog.train_step
    feed = traffic.Ahead(gen)

    def one(i: int):
        """Step ``i``: (its loss, its seconds from the call to the loss)."""
        b = feed.get(i)
        t = time.perf_counter()
        with torch.profiler.record_function("train_step"):
            loss = step(b)
        with torch.profiler.record_function("loss_fetch"):
            loss = float(loss)
        return loss, time.perf_counter() - t

    # set-up: the first steps, read for the checks (the reads are not set-up)
    losses, reads_s = [], 0.0
    for i in range(CHECKED_STEPS):
        losses.append(one(i)[0])
        if i in (0, CHECKED_STEPS - 1):
            t = time.perf_counter()
            p = prog.params()
            prog.flush()
            if i == 0:
                p1, e1_first = p, prog.host_rows(first_ids)
            else:
                pn, en_union = p, prog.host_rows(union)
            sync(dev)
            reads_s += time.perf_counter() - t
    prog_read = ref.state_readings(cfg, mlp, p1, pn, e0["first"], e1_first, e0["union"],
                                   en_union)
    prog_read["change_rows"] = prog_read["change_rows"].cpu()  # off the card until the checks
    del p1, pn, e1_first, en_union, e0
    sync(dev)
    setup_s = time.perf_counter() - r.t0 - reads_s
    if dev.type == "cuda":  # the peak of the served state, not of the weights' draw
        torch.cuda.reset_peak_memory_stats(dev)

    # the window
    c0 = prog.counters(writeback=True)
    times, bad, i = [], 0, CHECKED_STEPS
    w0 = time.perf_counter()
    while True:
        loss, dt = one(i)
        times.append(dt)
        bad += not math.isfinite(loss)
        i += 1
        if time.perf_counter() - w0 >= r.seconds:
            break
    window_s = time.perf_counter() - w0
    c1 = prog.counters(writeback=True)
    steps = len(times)

    traced = None
    if r.trace:
        base = i
        traced = trace.profile(lambda k: one(base + k), TRACED_STEPS, dev)
        i += 2 * TRACED_STEPS
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the checks: stray rows in the program's table, then the reference
    prog.flush()
    touched = torch.zeros(sum(cfg["vocab_sizes"]), dtype=torch.bool, device=dev)
    for k in range(i):
        touched[gen.global_ids(gen.batch_at(k)["sparse"]).reshape(-1)] = True
    stray = 0
    for r0, rows in ref.table_chunks(cfg, r.seed, dev):
        n = rows.shape[0]
        changed = (prog.host_block(r0, n) != rows).any(1) & ~touched[r0 : r0 + n]
        stray += int(changed.sum())
    del touched
    prog.close()
    table = ref.dense_table(cfg, r.seed, dev)
    ref_read = ref.train_readings(cfg, table, mlp, first)
    del table
    gaps = compare.train_gaps(losses, prog_read, ref_read)
    gaps["stray_rows"] = stray
    return {
        "kind": "train", "setup_s": setup_s, "window_s": window_s, "times_s": times,
        "items": steps * int(cfg["batch_size"]), "steps": steps,
        "flops_per_step": flops.dlrm_flops(cfg, "train"), "key_bytes": flops.victim_key_bytes(cfg),
        "counters": {k: (c1[k] - c0[k]) % (1 << 32) for k in ("hits", "misses", "moved_rows")},
        "row_bytes": c1["row_bytes"], "trace": traced, "memory_peak_bytes": memory_peak,
        "attempted": steps, "failed": bad, "checks": gaps,
    }


def control(r: Run, count: int = 0, variant: str = "tf32") -> dict:
    """The reference put in the program's place and read against the fp32
    reference on the same steps: computed in TF32 (``variant`` "tf32", the
    control), with half of each batch left out, the mean taken over the
    rest ("half", a fault), or with the smallest field's rows never written
    back ("field", a fault).  ``count`` is unused: a training cell compares
    its first steps."""
    cfg, dev, ref = r.cfg, r.device, r.reference
    mlp = ref.draw_mlp(cfg, r.seed, dev)
    gen = traffic.make(cfg, r.mix, r.seed, dev)
    first = [gen.batch_at(i) for i in range(CHECKED_STEPS)]
    want = ref.train_readings(cfg, ref.dense_table(cfg, r.seed, dev), mlp, first)
    if variant == "tf32":
        got = ref.train_readings(cfg, ref.dense_table(cfg, r.seed, dev), mlp, first, tf32=True)
    elif variant == "half":
        halves = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in first]
        got = ref.train_readings(cfg, ref.dense_table(cfg, r.seed, dev), mlp, halves)
    elif variant == "field":
        vocabs = [int(v) for v in cfg["vocab_sizes"]]
        f = vocabs.index(min(vocabs))
        lo = sum(vocabs[:f])
        got = ref.train_readings(cfg, ref.dense_table(cfg, r.seed, dev), mlp, first,
                                 frozen=(lo, lo + vocabs[f]))
    else:
        raise ValueError(f"a training cell's variants are tf32, half and field, not {variant!r}")
    return compare.train_gaps(got["losses"], got, want)
