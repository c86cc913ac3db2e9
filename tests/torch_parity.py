"""Shared helpers of the ``test_torch_*`` parity tests: JAX pytrees to numpy
dicts (the layout ``repro_torch.convert`` reads) and leaf-by-leaf equality.

Tolerance: the frequency tracker's float32 leaves (``score``,
``win_hits``, ``win_misses``) come from ``exp2`` and a multiply-add that
torch and XLA may round differently in the last ulp, so they are compared
within ``TRACKER_RTOL``; every other leaf is compared bitwise.
"""
import dataclasses

import numpy as np

TRACKER_RTOL = 1e-6  # a few fp32 ulps
TRACKER_FLOATS = ("score", "win_hits", "win_misses")


def jax_to_numpy(obj):
    """JAX state -> nested dicts of numpy arrays under the dataclass field names."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: jax_to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: jax_to_numpy(v) for k, v in obj.items()}
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        return np.asarray(obj)
    return obj


def assert_tree_equal(want, got, path="", skip=()):
    """``want`` (JAX side) and ``got`` (port side) agree leaf by leaf: bitwise,
    except the tracker floats within ``TRACKER_RTOL``."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        keys = set(want) - set(skip)
        assert keys <= set(got), (path, sorted(keys - set(got)))
        for k in keys:
            assert_tree_equal(want[k], got[k], f"{path}/{k}", skip)
        return
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert want.shape == got.shape, (path, want.shape, got.shape)
        if path.rsplit("/", 1)[-1] in TRACKER_FLOATS:
            np.testing.assert_allclose(got, want, rtol=TRACKER_RTOL, atol=0, err_msg=path)
        else:
            assert want.dtype == got.dtype, (path, want.dtype, got.dtype)
            assert np.array_equal(want, got), path
        return
    assert want == got, (path, want, got)
