"""The public surface of the port against the JAX package's.

* The names that the ported modules gained last (``freq.collect_counts``,
  ``collection.exact_metric_bytes`` / ``ExactCounterTotals`` /
  ``PlacementPlan.placement`` / ``METRICS_INT_COUNTERS``,
  ``codec.Fp32Codec``, ``launch.train.cache_policy``,
  ``analysis.smoke.registered_without_smoke``), each held to the
  reference on the same inputs.
* A guard read from the sources alone (no import of either package): every
  public top-level name of every module of ``src/repro/`` exists in the
  same module of ``src/repro_torch/``, or sits in :data:`LEFT_OUT`, whose
  every entry quotes its line of ``ROADMAP.md``'s "Left out by decision".
"""
import ast
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# (module under src/repro/, name or "*" for the whole module) -> the text
# of its entry in ROADMAP.md's "Left out by decision" list
_SPECS = "`shard_specs` of the unsharded collection and the single table"
_CONFIGS = "`build_cell`, `PAPER_SHAPES`, `ARCH`, `MODEL_CLS` and `smoke()` of the configs"
_PARTITIONING = "the rest\n  of `dist/partitioning.py`'s XLA rule scopes"
_REGISTRY = "`configs/__init__.py` `REGISTRY` / `get` / `ASSIGNED`"
_PALLAS = "the Pallas wrappers' `INTERPRET`, `kernels_enabled`, `densify`"
_JIT = "the `kernels/cache_ops/ops.py` jit wrappers `victim_topk`, `plan_image`"
_XLA = "`launch/perf.py`, `launch/report.py`, `analysis/hlo_checks.py`"
LEFT_OUT = {
    ("analysis/hlo_checks.py", "*"): _XLA,
    ("analysis/jaxpr_checks.py", "*"): "`analysis/jaxpr_checks.py`: XLA lowering, HLO parsing",
    ("launch/dryrun.py", "*"): "`launch/dryrun.py`, `launch/hlo_analyzer.py`",
    ("launch/hlo_analyzer.py", "*"): "`launch/dryrun.py`, `launch/hlo_analyzer.py`",
    ("launch/roofline.py", "*"): "`launch/hlo_analyzer.py`, `launch/roofline.py`",
    ("launch/perf.py", "*"): _XLA,
    ("launch/report.py", "*"): _XLA,
    ("configs/base.py", "*"): "`lm_rules`, `make_lm_arch`, `Arch` / `Cell`, `configs/base.py`",
    ("configs/__init__.py", "ASSIGNED"): _REGISTRY,
    ("configs/__init__.py", "REGISTRY"): _REGISTRY,
    ("configs/__init__.py", "get"): _REGISTRY,
    ("configs/lm_common.py", "lm_rules"): "`lm_rules`, `make_lm_arch`",
    ("configs/lm_common.py", "make_lm_arch"): "`lm_rules`, `make_lm_arch`",
    **{(f"configs/{m}.py", n): _CONFIGS
       for m, names in {
           "dien": ("ARCH", "build_cell", "smoke"),
           "din": ("ARCH", "MODEL_CLS", "build_cell", "smoke"),
           "dlrm_avazu": ("ARCH", "PAPER_SHAPES", "build_cell", "smoke"),
           "dlrm_criteo": ("ARCH", "PAPER_SHAPES", "build_cell", "smoke"),
           "fm": ("ARCH", "build_cell", "smoke"),
           "gatedgcn": ("ARCH", "build_cell", "smoke"),
           "mind": ("ARCH", "build_cell", "smoke"),
           "gemma3_27b": ("ARCH",), "grok_1_314b": ("ARCH",), "internlm2_20b": ("ARCH",),
           "olmoe_1b_7b": ("ARCH",), "smollm_360m": ("ARCH",),
       }.items() for n in names},
    ("core/cached_embedding.py", "shard_specs"): _SPECS,
    ("core/freq.py", "tracker_spec"): "`freq.tracker_spec`",
    **{("dist/partitioning.py", n): _PARTITIONING
       for n in ("AxisName", "MeshAxes", "current_mesh", "current_rules", "prepend_axis",
                 "resolve", "spec", "specs_for_axes")},
    ("dist/partitioning.py", "Param"): "`dist_part.constrain`, `Param`, `split_params`",
    ("dist/partitioning.py", "axis_rules"): "`split_params`, `axis_rules`",
    ("dist/partitioning.py", "constrain"): "`dist_part.constrain`",
    ("dist/partitioning.py", "split_params"): "`Param`, `split_params`",
    ("nn/transformer.py", "init_lm_tree"): "`init_lm_tree` / `lm_param_axes`",
    ("nn/transformer.py", "lm_param_axes"): "`init_lm_tree` / `lm_param_axes`",
    ("launch/mesh.py", "make_mesh"): "`make_production_mesh` / `make_mesh` (pod meshes",
    ("launch/mesh.py", "make_production_mesh"): "`make_production_mesh` / `make_mesh`",
    **{(f"kernels/{k}/kernel.py", f"{n}_pallas"): _PALLAS
       for k, n in (("cache_ops", "victim_threshold"), ("cache_ops", "bucketize"),
                    ("cache_ops", "gather_decode"), ("embedding_bag", "embedding_bag"),
                    ("fm_interaction", "fm_interaction"),
                    ("flash_attention", "flash_attention"))},
    ("kernels/flash_attention/kernel.py", "NEG_INF"): "Pallas flash kernel's mask value `NEG_INF`",
    **{(f"kernels/{k}/ops.py", "INTERPRET"): _PALLAS
       for k in ("cache_ops", "embedding_bag", "fm_interaction", "flash_attention")},
    ("kernels/cache_ops/ops.py", "kernels_enabled"): _PALLAS,
    ("kernels/embedding_bag/ops.py", "densify"): _PALLAS,
    **{("kernels/cache_ops/ops.py", n): _JIT
       for n in ("victim_topk", "plan_image", "arena_gather", "chunked_move")},
}


def _public_names(path, with_imports):
    """Public top-level names a module binds: defs, classes, assignments
    (and, with ``with_imports``, names it imports: a re-export counts)."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                out.update(n.id for n in ast.walk(t) if isinstance(n, ast.Name))
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")}


def _missing():
    """{(module, name)} public in the reference and absent from the port."""
    out = set()
    ref_root = os.path.join(SRC, "repro")
    for dirpath, _, files in os.walk(ref_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ref_root).replace(os.sep, "/")
            twin = os.path.join(SRC, "repro_torch", rel)
            if not os.path.exists(twin):
                out.add((rel, "*"))
                continue
            ref = _public_names(os.path.join(ref_root, rel), with_imports=False)
            out.update((rel, n) for n in ref - _public_names(twin, with_imports=True))
    return out


def _left_out_block():
    text = open(os.path.join(ROOT, "ROADMAP.md")).read()
    start = text.index("**Left out by decision.**")
    return text[start:text.index("Nothing in the port raises", start)]


def test_every_public_name_is_ported_or_left_out_by_decision():
    missing = _missing()
    assert missing - set(LEFT_OUT) == set(), "ported modules lack these public names"
    assert set(LEFT_OUT) - missing == set(), "LEFT_OUT entries the port now has"
    block = _left_out_block()
    for key, quote in LEFT_OUT.items():
        assert quote in block, (key, quote)
        name = key[1] if key[1] != "*" else key[0]
        if name.endswith("_pallas"):
            assert "`*_pallas`" in block, key
        else:  # the entry names it: `name`, `name()` or `module.name`
            assert re.search(rf"[`.]{re.escape(name)}\b", block), key


def test_left_out_kernel_wrappers_map_to_the_ports_entries():
    """A ``*_pallas`` kernel's port is its wrapper of the same name without
    the suffix; an ``ops.py`` jit wrapper's is its ``*_impl`` entry (the
    transmitter's ``move_rows`` for ``chunked_move``)."""
    port = os.path.join(SRC, "repro_torch")
    for (mod, name) in LEFT_OUT:
        names = (_public_names(os.path.join(port, mod), True)
                 if os.path.exists(os.path.join(port, mod)) else set())
        if name.endswith("_pallas"):
            assert name.removesuffix("_pallas") in names, (mod, name)
        elif mod == "kernels/cache_ops/ops.py" and name in ("victim_topk", "plan_image",
                                                            "arena_gather"):
            assert f"{name}_impl" in names, (mod, name)
    assert "move_rows" in _public_names(os.path.join(port, "core", "transmitter.py"), True)


def test_guard_reads_sources_without_importing_jax():
    """The guard itself is a source walk: it finds the names item 20 named
    as ported (each present now) and imports nothing."""
    missing = _missing()
    for key in (("core/freq.py", "collect_counts"), ("core/collection.py", "exact_metric_bytes"),
                ("core/collection.py", "ExactCounterTotals"), ("store/codec.py", "Fp32Codec"),
                ("launch/train.py", "cache_policy"),
                ("analysis/smoke.py", "registered_without_smoke"),
                ("core/collection.py", "METRICS_INT_COUNTERS")):
        assert key not in missing, key
    assert ("launch/dryrun.py", "*") in missing


# ----- the names, held to the reference --------------------------------------


def test_collect_counts_matches_reference():
    from repro.core import freq as jfreq
    from repro_torch.core import freq
    from repro_torch.data import synth

    spec = synth.ZipfSparseSpec(vocab_sizes=(1000, 500, 37), n_dense=13)
    vocab = sum(spec.vocab_sizes)
    batches = list(synth.count_stream(spec, 256, 6, seed=3))
    got = freq.collect_counts(iter(batches), vocab)
    want = jfreq.collect_counts(iter(batches), vocab)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 6 * 256 * 3
    # 2-D batches are flattened, as in the reference
    grid = np.arange(12).reshape(3, 4) % 5
    np.testing.assert_array_equal(freq.collect_counts([grid], 5),
                                  jfreq.collect_counts([grid], 5))


def _wrapping_metrics(step):
    """Per-slab cumulative int32 counters past 2^31 (they wrap negative)."""
    rows = {"a": np.int64(2**31 - 7 + 1000 * step), "b": np.int64(123 + step)}
    return ({k: np.asarray(v).astype(np.int32) for k, v in rows.items()},
            {"a": np.int32(512), "b": np.int32(136)})


def test_exact_metric_bytes_matches_reference():
    from repro.core import collection as jcol
    from repro_torch.core import collection as col

    for step in range(3):
        counts, unit = _wrapping_metrics(step)
        jm = {"host_moved_rows": {k: jnp.asarray(v) for k, v in counts.items()},
              "host_row_bytes": {k: jnp.asarray(v) for k, v in unit.items()}}
        tm = {"host_moved_rows": {k: torch.from_numpy(np.asarray(v)) for k, v in counts.items()},
              "host_row_bytes": {k: torch.tensor(int(v), dtype=torch.int32)
                                 for k, v in unit.items()}}
        want = jcol.exact_metric_bytes(jm, "host_moved_rows", "host_row_bytes")
        got = col.exact_metric_bytes(tm, "host_moved_rows", "host_row_bytes")
        assert isinstance(got, int) and got == want
    assert step and counts["a"] < 0  # the counter wrapped
    assert col.exact_metric_bytes(tm, "host_moved_rows", "absent") is None
    assert jcol.exact_metric_bytes(jm, "host_moved_rows", "absent") is None


def test_exact_counter_totals_match_reference_across_a_wrap():
    from repro.core import collection as jcol
    from repro_torch.core import collection as col

    got, want = col.ExactCounterTotals("rows"), jcol.ExactCounterTotals("rows")
    for step in range(4):
        counts, _ = _wrapping_metrics(step)
        g = got.update({k: torch.from_numpy(np.asarray(v)) for k, v in counts.items()})
        w = want.update({k: jnp.asarray(v) for k, v in counts.items()})
        assert g == w
    assert got.value == want.value == (2**31 - 7 + 3000) + 126  # exact past the wrap
    from repro_torch.obs.hub import ExactCounter

    assert isinstance(got, ExactCounter)


def test_placement_of_every_criteo_table_matches_reference():
    """``PlacementPlan.placement`` for each of the 26 tables of the Criteo
    plan at 1 GiB (int8 tiers: 21 DEVICE, 5 CACHED)."""
    import dataclasses

    from repro.configs.dlrm_criteo import CONFIG as JCONFIG
    from repro.models.dlrm import DLRM as JDLRM
    from repro_torch.configs.dlrm_criteo import CONFIG
    from repro_torch.models.dlrm import DLRM

    kw = dict(device_budget_bytes=1 << 30, host_precision="int8", arena_precision="int8",
              use_pallas_plan=True)
    jplan = JDLRM(dataclasses.replace(JCONFIG, **kw)).collection.plan
    plan = DLRM(dataclasses.replace(CONFIG, **kw)).collection.plan
    assert set(plan.placements) == set(jplan.placements) and len(plan.placements) == 26
    got = {n: plan.placement(n).value for n in plan.placements}
    assert got == {n: jplan.placement(n).value for n in jplan.placements}
    assert sorted(got.values()).count("device") == 21


def test_fp32_codec_matches_reference():
    from repro.store import codec as jcodec
    from repro_torch.store import codec

    c = codec.get_codec("fp32")
    assert isinstance(c, codec.Fp32Codec) and c is codec.CODECS["fp32"]
    assert c.name == jcodec.Fp32Codec().name == "fp32"
    assert isinstance(jcodec.get_codec("fp32"), jcodec.Fp32Codec)
    rows = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    payload, side = c.encode(torch.from_numpy(rows))
    jpayload, jside = jcodec.Fp32Codec().encode(jnp.asarray(rows))
    assert side is None and jside is None
    np.testing.assert_array_equal(payload.numpy(), np.asarray(jpayload))
    back = c.decode(payload, side, torch.float32)
    np.testing.assert_array_equal(back.numpy(), rows)
    for shape in ((32,), (128,), (4, 11)):
        assert c.row_bytes(shape, torch.float32) == jcodec.Fp32Codec().row_bytes(shape,
                                                                                jnp.float32)
    assert c.sideband_row_shape() is None and c.payload_dtype(torch.float32) == torch.float32


@pytest.mark.parametrize("name", [None, "", "freq_lfu", "lru", "runtime_lfu", "uvm_row"])
def test_cache_policy_matches_reference(name):
    from repro.launch.train import cache_policy as jcache_policy
    from repro_torch.core.policies import Policy
    from repro_torch.launch.train import cache_policy

    got, want = cache_policy(name), jcache_policy(name)
    if want is None:
        assert got is None
    else:
        assert isinstance(got, Policy) and got.value == want.value


def test_cache_policy_refuses_an_unknown_name_as_reference():
    from repro.launch.train import cache_policy as jcache_policy
    from repro_torch.launch.train import cache_policy

    for fn in (cache_policy, jcache_policy):
        with pytest.raises(ValueError):
            fn("fifo")


def test_registered_without_smoke_is_empty():
    """Every entry point the port registers with the gate has a smoke case."""
    from repro_torch.analysis.contracts import registry
    from repro_torch.analysis.smoke import build_cases, registered_without_smoke

    assert registered_without_smoke() == ()
    assert set(registry()) <= set(build_cases("cpu")) and len(registry()) >= 25


def test_metrics_int_counters_have_one_definition():
    from repro.core import collection as jcol
    from repro_torch.analysis import contracts
    from repro_torch.core import collection as col

    assert col.METRICS_INT_COUNTERS is contracts.METRICS_INT_COUNTERS
    assert "METRICS_INT_COUNTERS" in col.__all__
    assert col.METRICS_INT_COUNTERS == jcol.METRICS_INT_COUNTERS
    keys = ["['slab_hits']", "['host_moved_rows']", "['cache_misses']",
            "['exchange_routed_lanes']"]
    for k in keys:
        assert any(re.search(p, k) for p in col.METRICS_INT_COUNTERS), k
