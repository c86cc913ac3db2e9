"""Stable step signatures of the port's trainers, the counterpart of
``tests/test_recompile_guard.py``.

The reference counts jit traces: a retrace costs a compile a step and
serialises the pipelined trainer's overlap.  The port compiles nothing;
what a CUDA-graph replay of its step would need is that every state leaf
keeps its shape, dtype and device from step to step, and that the arena
and the host table (updated in place, as the reference donates them) keep
their storage.  These tests run the production wiring and read the state
after each step.  Also here: the CI job's observability smoke, against the
port's launcher.
"""
import copy
import json
import os
import re
import subprocess
import sys

from repro_torch.analysis.checks import signature, tree_leaves
from repro_torch.analysis.contracts import TABLE_LEAVES
from repro_torch.data import synth
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.train.trainer import PipelinedTrainer, Trainer, TrainerConfig

CFG = DLRMConfig(
    vocab_sizes=(512, 128), n_dense=13, embed_dim=8, batch_size=16,
    cache_ratio=0.25, lr=0.1, bottom_mlp=(16, 8), top_mlp=(16,),
)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _make_batch(cfg):
    spec = synth.ZipfSparseSpec(vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)
    return lambda step: synth.sparse_batch(spec, cfg.batch_size, 0, step)


def _tables(state):
    pat = re.compile(TABLE_LEAVES)
    return {p: (t.data_ptr(), tuple(t.shape), t.dtype) for p, t in tree_leaves(state)
            if pat.search(p)}


def _watch(seen):
    """Wraps a stage so that the state it returns is recorded: (every
    leaf's shape, dtype and device; the table leaves' storage)."""
    def wrap(fn, pick=lambda out: out):
        def run(*a):
            out = fn(*a)
            seen.append((signature((pick(out),)), _tables(pick(out))))
            return out
        return run
    return wrap


def _assert_stable(seen, from_step=1):
    sig0, tab0 = seen[from_step]
    assert tab0, "no table leaf found in the state"
    for i, (sig, tab) in enumerate(seen[from_step:], from_step):
        assert sig == sig0, (i, {p: (sig0.get(p), sig.get(p)) for p in set(sig) | set(sig0)
                                 if sig0.get(p) != sig.get(p)})
        assert tab == tab0, (i, sorted(p for p in tab if tab[p] != tab0.get(p)))


def test_serial_trainer_state_is_stable_over_six_steps():
    model = DLRM(CFG)
    seen = []
    trainer = Trainer(TrainerConfig(max_steps=6), init_fn=lambda: model.init(0, device="cpu"),
                      step_fn=_watch(seen)(model.train_step, pick=lambda out: out[0]),
                      make_batch=_make_batch(CFG), device="cpu")
    trainer.run()
    assert len(trainer.history) == 6 and len(seen) == 6
    _assert_stable(seen)


def test_pipelined_trainer_depth3_state_is_stable():
    model = DLRM(CFG)
    computed, applied = [], []
    trainer = PipelinedTrainer(
        TrainerConfig(max_steps=6, pipeline_depth=3),
        init_fn=lambda: model.init(0, device="cpu"),
        plan_fn=model.plan_step,
        compute_fn=_watch(computed)(model.compute_step, pick=lambda out: out[0]),
        apply_fn=_watch(applied)(model.apply_step),
        make_batch=_make_batch(CFG), device="cpu",
    )
    trainer.run()
    assert len(trainer.history) == 6 and len(computed) == 6 and len(applied) == 2
    _assert_stable(computed)
    _assert_stable(applied, from_step=0)
    # the apply and the compute hand the same tables along
    assert applied[0][1] == computed[1][1]


def test_in_place_state_trains_as_a_copied_one():
    """Updating the arena and the host table in place is the port's
    counterpart of donation, not a change of result: the losses equal those
    of a run that copies the whole state before every step."""
    mk = _make_batch(CFG)

    def run(copied):
        model = DLRM(CFG)
        step = ((lambda s, b: model.train_step(copy.deepcopy(s), b)) if copied
                else model.train_step)
        t = Trainer(TrainerConfig(max_steps=4), init_fn=lambda: model.init(0, device="cpu"),
                    step_fn=step, make_batch=mk, device="cpu")
        t.run()
        return [h["loss"] for h in t.history]

    assert run(copied=True) == run(copied=False)


def test_obs_smoke_through_the_port_launcher(tmp_path):
    """The CI job's observability smoke: the port's train launcher with an
    obs directory, then its report of the JSONL, and the Chrome trace."""
    env = dict(os.environ, PYTHONPATH=SRC)
    obs = tmp_path / "obs"
    subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                    "--arch", "dlrm-criteo", "--steps", "6", "--batch", "128",
                    "--pipeline-depth", "2", "--refresh-interval", "3", "--obs-dir", str(obs),
                    "--history-limit", "4"], env=env, check=True, capture_output=True,
                   timeout=600)
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                          str(obs / "train.jsonl"), "--json"], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    s = json.loads(out.stdout)
    assert s["train"]["n_steps"] == 6, s
    assert isinstance(s["counters"].get("cache_hits"), int), s
    with open(obs / "train.trace.json") as f:
        assert json.load(f)["traceEvents"], "empty chrome trace"
