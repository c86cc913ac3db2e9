"""The checks that decide ``correct``, driven through the whole harness on
the CPU at a tiny size: the program (``repro_torch``'s DLRM) agrees with the
plain reference, the TF32 control fails each cell's limits, and a run whose
timed path is broken underneath comes out not correct, once for each fault
a cell can have (a step that returns its state unchanged; half of the batch
left out, the mean taken over the rest; an answer altered where it is
produced)."""
import json
import time

import pytest
import torch

from portbench.lib import harness, traffic

TINY = dict(vocab_sizes=[64, 200, 3, 500], n_dense=5, embed_dim=8, bottom_mlp=[16, 8],
            top_mlp=[16, 8], batch_size=32, cache_ratio=0.2, max_unique_per_step=128,
            buffer_rows=24)
CELLS = {  # a cell's configuration and mix; its limits are limits/<cell>.json
    "avazu-train-zipf": ("dlrm-avazu", "zipf-train"),
    "avazu-serve-zipf": ("dlrm-avazu", "zipf-serve"),
    "criteo-serve-zipf": ("dlrm-criteo", "zipf-serve"),
}
TRAIN = ("avazu-train-zipf",)
SERVE = ("avazu-serve-zipf", "criteo-serve-zipf")
SEED = 2**33 + 7  # the driver's seeds exceed 32 bits


def _cell(workload):
    """The cell resolved as ``BENCHMARK.json`` would name it, at ``TINY``."""
    with open(harness.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    config, mix = CELLS[workload]
    bench["configs"] = [{"name": config, "file": f"portbench/configs/{config}.json"}]
    bench["workloads"] = [{"name": workload, "config": config, "traffic": mix, "chips": 1}]
    cell = harness.resolve(bench, workload)
    cell["cfg"] = dict(cell["cfg"], **TINY)
    return cell


def _run(workload, hooks=None, seed=SEED, trace=False):
    cell = _cell(workload)
    return harness.execute(cell, seed, 0.2, trace, torch.device("cpu"), time.perf_counter(),
                           hooks)


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_program_agrees_with_the_reference(workload):
    line = _run(workload, trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["checks"]["stray_rows"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_tf32_control_fails_the_limits(workload):
    cell = _cell(workload)
    for seed in (11, 12, 13):
        r = harness.Run(workload=workload, cfg=cell["cfg"], mix=cell["mix"],
                        limits=cell["limits"], model=cell["model"],
                        reference=cell["reference"], seed=seed, seconds=0.0, trace=False,
                        device=torch.device("cpu"), t0=0.0)
        got = cell["mode"].control(r)
        assert any(got[k] > lim for k, lim in cell["limits"].items() if k in got), got


def _control(workload, variant, seed=5):
    cell = _cell(workload)
    r = harness.Run(workload=workload, cfg=cell["cfg"], mix=cell["mix"], limits=cell["limits"],
                    model=cell["model"], reference=cell["reference"], seed=seed, seconds=0.0,
                    trace=False, device=torch.device("cpu"), t0=0.0)
    return cell["limits"], cell["mode"].control(r, variant=variant)


@pytest.mark.parametrize("workload", TRAIN)
def test_half_batch_fault_in_the_reference_fails_the_limits(workload):
    limits, got = _control(workload, "half")
    assert all(got[k] > limits[k] for k in ("loss_gap", "grad_gap", "change_gap")), got


@pytest.mark.parametrize("workload", TRAIN)
def test_a_dropped_field_fails_the_row_check(workload):
    """The smallest field's rows never written back: the rows' own check
    reads it far above the TF32 control, however little the table's norm
    moves."""
    _, tf32 = _control(workload, "tf32")
    limits, got = _control(workload, "field")
    assert got["row_gap"] > 100 * tf32["row_gap"] > 0, (got, tf32)
    assert got["row_gap"] > limits["row_gap"], (got, limits)


def test_the_program_ranks_rows_by_the_scan_and_reads_them_by_id():
    """The program's host rows are ranked by the stream's counts (not by
    global id), and the adapter reads each id's row through that ranking."""
    cell = _cell("avazu-serve-zipf")
    cfg, dev, ref = cell["cfg"], torch.device("cpu"), cell["reference"]
    gen = traffic.make(cfg, cell["mix"], SEED, dev)
    prog = cell["model"].Program(cfg, ref.draw_mlp(cfg, SEED, dev),
                                 ref.table_chunks(cfg, SEED, dev), dev, counts=gen.counts())
    try:
        vocab = sum(cfg["vocab_sizes"])
        assert not torch.equal(prog._row, torch.arange(vocab))
        table = ref.dense_table(cfg, SEED, dev)
        gids = torch.tensor([0, 63, 64, 263, 264, vocab - 1])
        assert torch.equal(prog.host_rows(gids), table[gids])
        assert torch.equal(prog.host_block(0, vocab), table)
    finally:
        prog.close()


def _unchanged(prog):
    """A step that returns its state unchanged: the loss of the forward alone."""
    def step(batch):
        logits, _ = prog.model.serve_step(prog.state, batch)
        return torch.nn.functional.binary_cross_entropy_with_logits(logits, batch["label"])
    return step


def _half_batch(prog):
    """Half of the batch left out, the mean taken over the rest."""
    def step(batch):
        half = batch["label"].shape[0] // 2
        return prog.train_step({k: v[:half] for k, v in batch.items()})
    return step


def _altered(engine):
    """One answer of each request altered where it is produced: two swapped."""
    def score(req):
        s = engine.score(req).copy()
        s[[0, 1]] = s[[1, 0]]
        return s
    return score


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_broken_train_step_is_not_correct(workload, fault):
    line = _run(workload, {"train_step": fault})
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", SERVE)
def test_altered_answer_is_not_correct(workload):
    line = _run(workload, {"score": _altered})
    assert not line["correct"], line["checks"]
    assert line["failed"] == line["attempted"]
