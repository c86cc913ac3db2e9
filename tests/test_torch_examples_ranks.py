"""``examples/torch_multi_device_scaling.py`` against its JAX twin
``examples/multi_device_scaling.py`` on the CPU.

The twin runs in a child process (it emulates 8 XLA CPU devices, a flag
read once per process, and lays a ``(data=2, model=4)`` mesh over them);
the child also takes the twin's initial state and the metrics of each of
its five steps, replayed through the twin's own jitted, sharded step.  The
port's example spawns 8 gloo CPU ranks on the same mesh, each taking its
shard of that initial state (``convert.state_from_numpy``).  Held: the
rows a shard and the traffic imbalance of ``assignments`` exactly,
``device_bytes()`` exactly, each step's miss, eviction, overflow and hit
counts, host rows and exchange bytes exactly, the live imbalance within
rtol 1e-6, losses within rtol 1e-5, on every rank.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
TESTS = os.path.join(ROOT, "tests")
if EXAMPLES not in sys.path:  # the spawned ranks import the example by name
    sys.path.insert(0, EXAMPLES)

import torch_multi_device_scaling as mds  # noqa: E402

# the twin first: it sets XLA_FLAGS before JAX is imported
DRIVER = textwrap.dedent(
    """
    import pickle, runpy, sys
    g = runpy.run_path(sys.argv[1], run_name="jax_multi_device_scaling")
    import jax
    import jax.numpy as jnp
    import repro.dist.partitioning as dist
    from repro.data import synth
    from torch_parity import jax_to_numpy

    model = g["model"]
    init = model.init(jax.random.PRNGKey(0), counts=g["counts"])
    out = {"init": jax_to_numpy(jax.device_get(init)), "steps": []}
    state = jax.device_put(init, g["sh"](g["state_specs"]))
    with dist.axis_rules(g["mesh"], dist.hybrid_rules()):
        for i in range(5):
            batch = {k: jnp.asarray(v) for k, v in synth.sparse_batch(g["spec"], 512, 0, i).items()}
            state, m = g["step"](state, batch)
            out["steps"].append(jax_to_numpy(jax.device_get(m)))
    out["assignments"] = {n: (a.shard_rows.tolist(), a.imbalance())
                          for n, a in model.collection.assignments.items()}
    out["device_bytes"] = model.collection.device_bytes()
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    """
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the twin's numbers and printed lines, the port's and its lines)."""
    path = tmp_path_factory.mktemp("twin") / "twin.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), TESTS]))
    twin = subprocess.run([sys.executable, "-c", DRIVER,
                           os.path.join(EXAMPLES, "multi_device_scaling.py"), str(path)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert twin.returncode == 0, twin.stderr[-4000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)
    return ref, twin.stdout


def test_multi_device_scaling_matches_reference(runs, capsys):
    ref, twin_out = runs
    got = mds.main(["--device", "cpu"], init_state=ref["init"])
    out = capsys.readouterr().out
    for prefix in ("slab ", "per-shard device bytes"):
        lines = [ln for ln in out.splitlines() if ln.startswith(prefix)]
        assert lines and lines == [ln for ln in twin_out.splitlines() if ln.startswith(prefix)]
    ranks = got["ranks"]
    assert [r["rank"] for r in ranks] == list(range(8))
    assert {r["mesh"] for r in ranks} == {(2, 4)} and {r["backend"] for r in ranks} == {"gloo"}
    assert {r["shard_shape"] for r in ranks} == {(1, 1875, 32)}
    want_steps = ref["steps"]
    for r in ranks:
        assert r["assignments"] == ref["assignments"]
        for k, v in ref["device_bytes"].items():
            if k != "per_slab":
                assert r["device_bytes"][k] == v, k
        # one rank holds one shard: its process's device bytes are a shard's
        assert r["device_bytes"]["device_process"] == ref["device_bytes"]["device_per_shard"]
        assert len(r["steps"]) == len(want_steps) == 5
        for g, w in zip(r["steps"], want_steps):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, atol=0)
            np.testing.assert_allclose(g["shard_imbalance"], w["shard_imbalance"], rtol=1e-6)
            assert g["hit_rate"] == float(w["hit_rate"])
            assert g["exchange_bytes"] == float(w["exchange_bytes"])
            for key in mds._EXACT:
                want = w[key]
                want = ({n: int(v) for n, v in want.items()} if isinstance(want, dict)
                        else int(want))
                assert g[key] == want, key
    assert ranks[0]["steps"][-1]["exchange_bytes"] > 0
    # every rank reads every wrapper's count; the CPU route launches none
    from repro_torch.kernels import counters

    assert all(r["launches"] == dict.fromkeys(counters.launch_counts(), 0) for r in ranks)
    assert got["p50_ms"] > 0
