"""The port's hot-path contract gate (``repro_torch.analysis``), the
counterpart of ``tests/test_analysis.py``: every check and AST rule fires on
a fixture built to break exactly it and is quiet on a clean one, the gate's
exit codes, the real tree clean against its baseline, and the registry one
for one with the JAX package's."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import ast_lint, checks, run
from repro_torch.analysis import contracts as contracts_mod
from repro_torch.analysis.contracts import INT_COUNTERS, Contract, Violation, contract, registry
from repro_torch.analysis.smoke import SmokeCase
from repro_torch.core import transmitter
from repro_torch.optim import optimizers, schedules

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _case(fn, args, advance=None, in_place=()):
    return SmokeCase("fixture", fn, lambda: tuple(args() if callable(args) else args),
                     advance=advance, in_place=in_place)


def _check(fn, args, advance=None, in_place=(), **kw):
    found, _ = checks.check_case(_case(fn, args, advance, in_place), Contract("fixture", **kw),
                                 "cpu")
    return found


def _kinds(found):
    return [v.check for v in found]


# ---------------------------------------------------------------------------
# each check fires on its injected fault and is quiet on a clean function
# ---------------------------------------------------------------------------

X = torch.arange(8, dtype=torch.int32)


@pytest.mark.parametrize("fault", [
    lambda x: x.sum().item(),  # .item()
    lambda x: x[x > 3],  # a boolean-mask index
    lambda x: int(x.max()),  # int() of a tensor
    lambda x: 1 if x.any() else 0,  # `if tensor:`
    lambda x: torch.nonzero(x),
    lambda x: torch.unique(x),
    lambda x: x + torch.tensor(1, dtype=torch.int32),  # built from Python data
])
def test_host_transfer_fires(fault):
    found = _check(fault, (X,))
    assert _kinds(found) == ["host-transfer"], found
    assert "fixture" in found[0].entry and "test_torch_analysis.py" in found[0].detail


def test_clean_function_has_no_finding():
    def clean(state):
        key = torch.where(state["w"] > 0, state["w"], 0).sum(0)
        return {"hits": state["hits"] + 1, "key": torch.sort(key).values}

    def args():
        return ({"w": torch.randn(4, 8), "hits": torch.zeros((), dtype=torch.int32)},)

    assert _check(clean, args, advance=lambda s: (dict(s, hits=clean(s)["hits"]),),
                  int_counters=(r"\['hits'\]",), max_sort_size=8) == []


def test_f64_fires_on_a_double_cast():
    found = _check(lambda x: x.to(torch.float64).sum(), (X,))
    assert _kinds(found) == ["f64"] and "_to_copy" in found[0].detail
    assert _check(lambda x: x.to(torch.float64).sum(), (X,), no_f64=False) == []


def test_int_counter_fires_on_a_float_counter():
    def bad(s):
        return {"hits": s["hits"].to(torch.float32) + 1}

    found = _check(bad, ({"hits": torch.zeros((), dtype=torch.int32)},),
                   int_counters=(r"\['hits'\]",))
    assert _kinds(found) == ["int-counter"] and "float32" in found[0].detail


def test_sort_bound_fires_on_a_full_capacity_argsort():
    found = _check(lambda k: torch.argsort(k, descending=True), (torch.randn(4096),),
                   max_sort_size=64)
    assert _kinds(found) == ["sort-bound"] and "4096" in found[0].detail
    found = _check(lambda k: torch.topk(k, 3), (torch.randn(8),), max_sort_size=0)
    assert _kinds(found) == ["sort-bound"]
    assert _check(lambda k: torch.sort(k), (torch.randn(64),), max_sort_size=64) == []


def test_stable_signature_fires_on_a_dtype_drift():
    found = _check(lambda x: x + 1, (X,), advance=lambda x: (x.to(torch.float32),))
    assert _kinds(found) == ["stable-signature"]
    assert "int32" in found[0].detail and "float32" in found[0].detail
    found = _check(lambda x: x + 1, (X,), advance=lambda x: (torch.cat([x, x]),))
    assert _kinds(found) == ["stable-signature"] and "(16,)" in found[0].detail


def test_in_place_fires_on_a_reallocated_leaf():
    def state():
        return ({"weight": torch.zeros(16, 8)},)

    found = checks.check_case(_case(lambda s: {"weight": s["weight"] + 1}, state, in_place=(0,)),
                              Contract("fixture", in_place=("state",)), "cpu")[0]
    assert _kinds(found) == ["in-place"] and "['weight']" in found[0].detail
    ok = checks.check_case(_case(lambda s: {"weight": s["weight"].add_(1)}, state,
                                 in_place=(0,)), Contract("fixture", in_place=("state",)), "cpu")
    assert ok[0] == []


def test_documented_syncs_count_against_allowed_syncs():
    """The transmitter's lane copy counts once a move: within the contract's
    allowance it is reported as documented (for the baseline); past it, or
    with none allowed, it is a host-transfer finding."""
    def args():
        return ({"weight": torch.randn(32, 4)}, {"weight": torch.zeros(16, 4)},
                torch.arange(8, dtype=torch.int32), torch.arange(8, dtype=torch.int32),
                torch.ones(8, dtype=torch.bool))

    def two_moves(src, dst, si, di, act):
        transmitter.move_rows(src, dst, si, di, act, buffer_rows=4)
        return transmitter.move_rows(src, dst, si + 8, di + 8, act, buffer_rows=4)

    found = _check(two_moves, args, allowed_syncs=2)
    assert _kinds(found) == ["documented-sync"] and "_active_lanes': 2" in found[0].detail
    found = _check(two_moves, args, allowed_syncs=1)
    assert sorted(_kinds(found)) == ["documented-sync", "host-transfer"]


def _port_function(path, name, body):
    """A function whose code claims to live at ``repro_torch/<path>``, so
    that the census keys its frames as the port's."""
    src = f"def {name}(warn):\n" + "".join(f"    {line}\n" for line in body)
    ns = {}
    exec(compile(src, str(SRC / "repro_torch" / path), "exec"), ns)
    return ns[name]


def test_sync_census_keys_each_warning_by_its_port_site(monkeypatch):
    """The census without a card: the sync debug mode stubbed, the warnings
    raised by hand.  Every warning counts (not once per location), its site
    is the innermost port frame, one under a documented function counts as
    documented, and the mode is restored when the block raises."""
    import warnings

    from repro_torch.analysis import census

    modes = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    msg = "called a synchronizing CUDA operation"
    lane_copy = _port_function("core/transmitter.py", "_active_lanes", ["warn()"])
    step = _port_function("models/fake.py", "step", ["for _ in range(3):", "    warn()",
                                                     "lane_copy(warn)"])
    step.__globals__["lane_copy"] = lane_copy
    with census.sync_census() as c:
        step(lambda: warnings.warn(msg))
        warnings.warn(msg)  # the caller's own
        warnings.warn("another warning")  # passed through, not counted
    assert c.by_site() == {"models/fake.py:3": 3, "core/transmitter.py:2": 1,
                           f"<caller> test_torch_analysis.py:{_caller_line()}": 1}, c.by_site()
    assert c.summary()["documented"] == 1 and modes == ["warn", 0]
    assert c.port_sites() == {"models/fake.py:3": "models/fake.py:step",
                              "core/transmitter.py:2": "core/transmitter.py:_active_lanes"}
    with pytest.raises(RuntimeError), census.sync_census():
        raise RuntimeError("the block fails")
    assert modes == ["warn", 0, "warn", 0]


def _caller_line():
    """The line of this file where the census test warns as the caller."""
    lines = Path(__file__).read_text().splitlines()
    return next(i for i, line in enumerate(lines, 1) if "# the caller's own" in line)


# ---------------------------------------------------------------------------
# the AST rules
# ---------------------------------------------------------------------------


def _lint(src, module="fixture"):
    return ast_lint.lint_source(src, path="fixture.py", module=module)


@pytest.mark.parametrize("call", ["x.sum().item()", "x.tolist()", "x.cpu()", "x.numpy()",
                                  "torch.cuda.synchronize()", "float(x)", "int(x)", "bool(x)"])
def test_ast_host_sync_fires_and_is_suppressed(call):
    src = ("from repro_torch.analysis.contracts import contract\n"
           "@contract()\n"
           f"def step(x, n: int):\n    return {call}\n")
    assert _kinds(_lint(src)) == ["ast-host-sync"]
    assert _lint(src.replace(f"return {call}", f"return {call}  # torchlint: ok")) == []
    # the same body in a step module is linted without the decorator, and
    # in a host module not at all
    plain = src.replace("@contract()\n", "")
    assert _kinds(_lint(plain, module="repro_torch.models.fake")) == ["ast-host-sync"]
    assert _lint(plain, module="repro_torch.data.fake") == []


def test_ast_static_uses_are_clean():
    assert _lint(
        "@contract()\n"
        "def step(cfg, x: torch.Tensor, n: int, rows=None):\n"
        "    if cfg.writeback:\n        x = x * 2\n"
        "    if rows is None:\n        x = x + 1\n"
        "    if isinstance(x, tuple) or len(x) > 2:\n        x = x[0]\n"
        "    if n > 4:\n        x = int(n) + x\n"
        "    return torch.full((), 1.0, device=x.device) + x\n") == []


def test_ast_tensor_branch_fires():
    vs = _lint("@contract()\ndef step(x: torch.Tensor):\n"
               "    if x > 0:\n        return x\n"
               "    while x < 3:\n        x = x + 1\n    return x\n")
    assert _kinds(vs) == ["ast-tensor-branch", "ast-tensor-branch"]


def test_ast_scalar_to_device_fires_on_the_adamw_pattern():
    src = ("@contract()\ndef correction(t: torch.Tensor, b: float):\n"
           "    return torch.tensor(float(b), dtype=torch.float64, device=t.device) ** t\n")
    assert _kinds(_lint(src)) == ["ast-scalar-to-device"]
    assert _kinds(_lint(src.replace("torch.tensor", "torch.as_tensor"))) == ["ast-scalar-to-device"]
    # a tensor parameter moved to its device is no Python value
    assert _lint("@contract()\ndef f(x: torch.Tensor, y: torch.Tensor):\n"
                 "    return torch.as_tensor(x, device=y.device)\n") == []
    assert _lint(src.replace("** t\n", "** t  # torchlint: ok\n")) == []


def test_ast_obs_host_sync_outside_the_documented_points():
    src = "def record(self, m):\n    return m['loss'].cpu().tolist()\n"
    vs = ast_lint.lint_source(src, path="t.py", module="repro_torch.train.trainer")
    assert _kinds(vs) == ["ast-obs-host-sync", "ast-obs-host-sync"]
    assert ast_lint.lint_source(src, path="t.py", module="repro_torch.data.synth") == []
    for point in ("_post_step", "_check_window", "score", "summary", "fetch_ints"):
        assert ast_lint.lint_source(src.replace("record", point), path="t.py",
                                    module="repro_torch.obs.hub") == []


def test_ast_extra_entries_are_linted_as_step_code():
    src = "class Coll:\n    def gather(self, w):\n        return w.sum().item()\n"
    assert ast_lint.lint_source(src, path="x.py", module="repro_torch.fake") == []
    vs = ast_lint.lint_source(src, path="x.py", module="repro_torch.fake",
                              extra={"repro_torch.fake.Coll.gather"})
    assert _kinds(vs) == ["ast-host-sync"]


# ---------------------------------------------------------------------------
# registry, baseline and the runner
# ---------------------------------------------------------------------------


def test_contract_registers_without_wrapping():
    try:
        @contract(max_sort_size=7, allowed_syncs=2, name="tests.fixture_entry")
        def entry(x):
            return x

        fn, c = registry()["tests.fixture_entry"]
        assert fn is entry and entry.__contract__ is c
        assert (c.max_sort_size, c.allowed_syncs, c.in_place) == (7, 2, ())
    finally:  # a registered entry with no smoke case is a no-smoke finding
        contracts_mod._REGISTRY.pop("tests.fixture_entry", None)


def test_baseline_matches_by_device_and_marks_stale_entries():
    report = {"entries": [], "device": "cpu", "ast_files": 0, "per_entry": {},
              "violations": [Violation("f64", "a.b", "x", "cpu"),
                             Violation("sort-bound", "c.d", "y", "cpu")]}
    out = run.apply_baseline(report, [
        {"check": "f64", "entry": "a.b", "device": "any", "rationale": "known"},
        {"check": "sort-bound", "entry": "c.d", "device": "cuda", "rationale": "card only"},
        {"check": "f64", "entry": "gone", "device": "cpu", "rationale": "fixed"},
        {"check": "f64", "entry": "other", "device": "cuda", "rationale": "not judged here"},
    ])
    assert [v["entry"] for v in out["baselined"]] == ["a.b"]
    assert [v["entry"] for v in out["new"]] == ["c.d"] and not out["ok"]
    assert [b["entry"] for b in out["stale_baseline"]] == ["gone"]


def test_main_exit_codes_and_json(tmp_path, capsys):
    bad_root = tmp_path / "bad"
    (bad_root / "src" / "repro_torch").mkdir(parents=True)
    (bad_root / "src" / "repro_torch" / "bad.py").write_text(
        "from repro_torch.analysis.contracts import contract\n\n"
        "@contract()\ndef bad(x):\n    return x.item()\n")
    base = run._DEFAULT_BASELINE
    # a new finding -> 1 (the bad tree's AST finding; the real registry's
    # runtime findings are all in the baseline)
    assert run.main(["--json", "--root", str(bad_root)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert {v["check"] for v in out["new"]} == {"ast-host-sync"}
    # the checked-in baseline on the real tree -> 0, also under --strict
    assert run.main(["--json", "--strict", "--root", str(ROOT)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["device"] == "cpu" and not rep["stale_baseline"]
    assert len(rep["entries"]) == 27 and rep["ast_files"] > 90
    # a stale entry -> 2 under --strict, 0 without
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"known_issues": json.loads(base.read_text())["known_issues"]
                                 + [{"check": "f64", "entry": "no.such.entry", "device": "any",
                                     "rationale": "fixed"}]}))
    assert run.main(["--strict", "--skip-ast", "--baseline", str(stale)]) == 2
    assert run.main(["--skip-ast", "--baseline", str(stale)]) == 0
    capsys.readouterr()


def test_gate_passes_strict_on_the_tree():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.run", "--strict",
                          "--device", "cpu"], env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK: 0 new" in out.stdout and ", 0 stale" in out.stdout


def test_every_baseline_entry_has_a_rationale_and_sites_point_into_their_function():
    data = json.loads(run._DEFAULT_BASELINE.read_text())
    for b in data["known_issues"]:
        assert b["device"] in ("cpu", "cuda", "any") and len(b["rationale"]) > 20, b
    for s in data["sync_sites"]:
        path, line = s["site"].rsplit(":", 1)
        tree = ast.parse((SRC / "repro_torch" / path).read_text())
        fns = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
               and n.name == s["function"].rsplit(":", 1)[1].rsplit(".", 1)[-1]]
        assert any(f.lineno <= int(line) <= f.end_lineno for f in fns), s
        assert "ROADMAP" in s["rationale"] or "documented" in s["rationale"], s


# JAX name -> the port's counterparts: the port split arena_gather in two (the
# encode entry), and chunked_move is the transmitter's chunked move
# the port's entries with no reference counterpart: the exchange between
# ranks, which the reference leaves to XLA's collectives under its mesh
PORT_ONLY = ("repro_torch.dist.exchange.slot_leg", "repro_torch.dist.exchange.row_leg")

NAME_MAP = {
    "repro.core.cache.apply_plan": ("repro_torch.core.cache.apply_plan",),
    "repro.core.cache.flush": ("repro_torch.core.cache.flush",),
    "repro.core.cache.plan_prepare": ("repro_torch.core.cache.plan_prepare",),
    "repro.core.cache.warmup": ("repro_torch.core.cache.warmup",),
    **{f"repro.core.collection.EmbeddingCollection.{m}":
       (f"repro_torch.core.collection.EmbeddingCollection.{m}",)
       for m in ("apply_grads", "gather", "metrics")},
    "repro.core.refresh._apply_rebalance": ("repro_torch.core.refresh.apply_rebalance",),
    "repro.core.refresh._apply_swaps": ("repro_torch.core.refresh.apply_swaps",),
    "repro.core.refresh._apply_swaps_sharded": ("repro_torch.core.refresh.apply_swaps_sharded",),
    **{f"repro.core.sharded.ShardedEmbeddingCollection.{m}":
       (f"repro_torch.core.sharded.ShardedEmbeddingCollection.{m}",)
       for m in ("apply_grads", "apply_plan", "gather", "metrics", "plan_prepare")},
    "repro.kernels.cache_ops.ops.arena_gather": (
        "repro_torch.kernels.cache_ops.ops.arena_gather_impl",
        "repro_torch.kernels.cache_ops.ops.arena_gather_encode_impl"),
    "repro.kernels.cache_ops.ops.chunked_move": ("repro_torch.core.transmitter.move_rows",),
    "repro.kernels.cache_ops.ops.plan_image": (
        "repro_torch.kernels.cache_ops.ops.plan_image_impl",),
    "repro.kernels.cache_ops.ops.shard_bucketize": (
        "repro_torch.kernels.cache_ops.ops.shard_bucketize",),
    "repro.kernels.cache_ops.ops.victim_topk": (
        "repro_torch.kernels.cache_ops.ops.victim_topk_impl",),
    "repro.kernels.embedding_bag.ops.embedding_bag": (
        "repro_torch.kernels.embedding_bag.ops.embedding_bag",),
    "repro.kernels.flash_attention.ops.flash_attention": (
        "repro_torch.kernels.flash_attention.ops.flash_attention",),
    "repro.kernels.fm_interaction.ops.fm_interaction": (
        "repro_torch.kernels.fm_interaction.kernel.fm_interaction",),
    "repro.models.common.CollectionTrainStep.compute_step": (
        "repro_torch.models.common.CollectionTrainStep.compute_step",),
}


def test_registry_is_one_for_one_with_the_jax_package():
    import repro.analysis.smoke  # noqa: F401  (importing it fills the JAX registry)
    from repro.analysis.contracts import registry as jax_registry
    from repro_torch.analysis import smoke

    jreg, preg = jax_registry(), registry()
    assert set(NAME_MAP) == set(jreg) and len(jreg) == 24
    mapped = {p for ps in NAME_MAP.values() for p in ps}
    assert mapped | set(PORT_ONLY) == set(preg) and set(smoke.build_cases()) == set(preg)
    for j, ports in NAME_MAP.items():
        jc = jreg[j][1]
        for p in ports:
            pc = preg[p][1]
            assert (pc.max_sort_size, pc.int_counters, pc.in_place) == (
                jc.max_sort_size, jc.int_counters, jc.donates), (j, p)


# ---------------------------------------------------------------------------
# AdamW builds its bias correction on the device
# ---------------------------------------------------------------------------


def test_adamw_update_builds_nothing_from_python_data():
    opt = optimizers.adamw(schedules.linear_warmup_cosine(1e-3, 10, 100))
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.standard_normal((8, 4), np.float32)),
              "b": torch.from_numpy(rng.standard_normal(4, np.float32))}
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    state, step = opt.init(params), torch.zeros((), dtype=torch.int32)
    with checks.Recorder() as rec:
        opt.update(grads, state, params, step)
    assert rec.seen.syncs == {}, rec.seen.syncs  # no lift_fresh, no .item()
    found = _check(lambda g, s, p, t: opt.update(g, s, p, t), (grads, state, params, step),
                   no_f64=False)
    assert found == []
    # a float learning rate is filled, not lifted from Python data
    with checks.Recorder() as rec:
        optimizers.adamw(1e-3).update(grads, state, params, step)
    assert rec.seen.syncs == {}, rec.seen.syncs


def test_int_counters_regex_matches_the_cache_counters():
    import re

    pats = [re.compile(p) for p in INT_COUNTERS]
    assert any(p.search(".cache.hits") for p in pats)
    assert not any(p.search("['step']") for p in pats)


def test_launch_counts_read_and_zero_every_wrapper():
    """``kernels.counters`` reads every wrapper's count (the flash kernel's
    by route too) and zeroes them all; the gate's ``kernel_counts`` takes
    the fused entries and the flash routes apart from the same table."""
    from repro_torch.kernels import counters
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    table = counters.counters()
    routes = fa_kernel.flash_attention.route_launches
    saved = ([getattr(fn, attr) for _, fn, attr in table], dict(routes))
    try:
        for i, (_, fn, attr) in enumerate(table):
            setattr(fn, attr, 10 * (i + 1))
        routes.update({r: 100 + i for i, r in enumerate(routes)})
        got = counters.launch_counts()
        assert {k: got[k] for k, _, _ in table} == {k: 10 * (i + 1)
                                                    for i, (k, _, _) in enumerate(table)}
        assert {r: got[f"flash_{r}"] for r in routes} == dict(routes)
        split = run.kernel_counts()
        assert split["gather_decode"] == got["gather_decode"] - got["gather_decode_encode"]
        assert split["bucketize"] == got["bucketize"] - got["route_bucketize"]
        assert "flash_attention" not in split and split["flash_wgmma"] == routes["wgmma"]
        counters.zero_launch_counts()
        assert set(counters.launch_counts().values()) == {0}
    finally:
        for (_, fn, attr), n in zip(table, saved[0]):
            setattr(fn, attr, n)
        routes.update(saved[1])
