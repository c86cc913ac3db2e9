"""The yardstick's arithmetic: the model flops and the threshold kernel's
bytes equal the figures the benchmark states, and the trace reduction
counts overlapping device work once and names each idle gap."""
import pytest

from portbench.lib import flops, harness, trace


def _cfg(name):
    import json
    with open(harness.BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_dlrm_flops_are_the_stated_figures():
    criteo, avazu = _cfg("dlrm-criteo"), _cfg("dlrm-avazu")
    assert flops.dlrm_flops(criteo, "train") / 1e9 == pytest.approx(241.68, abs=0.005)
    assert flops.dlrm_flops(criteo, "serve") / 1e9 == pytest.approx(80.56, abs=0.005)
    assert flops.dlrm_flops(avazu, "train") / 1e9 == pytest.approx(834.20, abs=0.005)
    assert flops.dlrm_flops(avazu, "serve") / 1e9 == pytest.approx(278.07, abs=0.005)


def test_threshold_key_bytes_are_one_read_of_the_arena_key():
    criteo, avazu = _cfg("dlrm-criteo"), _cfg("dlrm-avazu")
    assert flops.arena_slots(criteo) == 506_438 and flops.arena_slots(avazu) == 851_968
    assert flops.victim_key_bytes(criteo) == 4 * 506_438 + 12  # 2.03 MB
    assert flops.victim_key_bytes(avazu) == 4 * 851_968 + 12  # 3.41 MB
    assert flops.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    assert flops.peak("some other card", "fp32_flops") is None


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce_unions_streams_and_names_gaps():
    events = [
        _ev("kernel", "spin_kernel", 0, 1), _ev("kernel", "spin_kernel", 5, 1),  # fences
        _ev("kernel", "gemm", 10, 20), _ev("kernel", "gen", 15, 10),  # overlap: counted once
        _ev("gpu_memcpy", "Memcpy DtoH", 40, 10),
        _ev("kernel", "spin_kernel", 60, 1),
        _ev("cpu_op", "aten::nonzero", 28, 10),  # running over the gap 30..40
        _ev("cuda_runtime", "cudaMemcpyAsync", 49, 9),  # over the gap 50..60
        _ev("user_annotation", "train_step", 0, 100),
    ]
    out = trace.reduce(events)
    assert out["window_s"] == pytest.approx(54e-6)  # from the fence ending at 6 to the one at 60
    assert out["busy_s"] == pytest.approx(30e-6)  # 10..30 and 40..50
    assert out["device_ops"][0] == ["gemm", pytest.approx(20e-6)]
    gaps = dict((n, s) for n, s in out["idle_gaps"])
    assert gaps["aten::nonzero"] == pytest.approx(10e-6)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(10e-6)
    assert gaps["train_step"] == pytest.approx(4e-6)  # 6..10: the innermost running
    assert out["kernels"]["gemm"] == (1, pytest.approx(20e-6))
    assert "spin_kernel" not in out["kernels"]


def test_reduce_without_device_work_uses_the_window_span():
    events = [_ev("user_annotation", trace.WINDOW, 100, 50), _ev("cpu_op", "aten::mm", 100, 50)]
    out = trace.reduce(events)
    assert out["window_s"] == pytest.approx(50e-6) and out["busy_s"] == 0.0
    assert out["idle_gaps"] == [["aten::mm", pytest.approx(50e-6)]]
