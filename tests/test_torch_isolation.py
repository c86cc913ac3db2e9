"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor the JAX package, and its entry points never fall back to
the CPU when no card is present."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import smollm_360m
from repro_torch.device import resolve_device
from repro_torch.configs import dien, din, gatedgcn, mind
from repro_torch.launch import serve, train
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.gatedgcn import GatedGCNModel
from repro_torch.models.lm import LMModel
from repro_torch.nn import transformer
from repro_torch.models.recsys_models import DIENModel, DINModel, FMConfig, FMModel, MINDModel
from repro_torch.train.trainer import Trainer, TrainerConfig

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def test_port_imports_no_jax_and_no_reference_package():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        assert len(names) > 20, names
        for need in ("optim.optimizers", "train.trainer", "train.checkpoint", "store.arena",
                     "data.pipeline", "models.common", "launch.train",
                     "kernels.fm_interaction.ops", "kernels.fm_interaction.kernel",
                     "kernels.embedding_bag.ops", "kernels.embedding_bag.kernel",
                     "models.recsys_models", "nn.recsys", "nn.embedding_bag", "nn.indexing",
                     "configs.fm", "core.sharded",
                     "kernels.flash_attention.ops", "kernels.flash_attention.kernel",
                     "kernels.flash_attention.ref", "nn.layers", "nn.moe", "nn.transformer",
                     "models.lm", "configs.lm_common", "configs.smollm_360m",
                     "configs.gemma3_27b", "configs.internlm2_20b",
                     "core.cached_embedding", "configs.dlrm_avazu", "obs.report",
                     "configs.din", "configs.dien", "configs.mind", "configs.shapes",
                     "data.synth", "launch.serve", "optim.compression", "optim.schedules",
                     "configs.olmoe_1b_7b", "configs.grok_1_314b", "nn.gnn", "data.graphs",
                     "models.gatedgcn", "configs.gatedgcn"):
            assert "repro_torch." + need in names, need
        print(len(names))
        """
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_silent_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    cfg = DLRMConfig(vocab_sizes=(16, 8), embed_dim=8, batch_size=4, cache_ratio=0.5,
                     bottom_mlp=(8,), top_mlp=(8,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DLRM(cfg).init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainerConfig(max_steps=1), init_fn=dict, step_fn=None, make_batch=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1", "--batch", "4", "--arena-precision", "int8"])
    fm = FMModel(FMConfig(vocab_sizes=(16, 8), embed_dim=4, batch_size=4, cache_ratio=0.5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fm.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "fm", "--steps", "1", "--batch", "4"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_sharded_dlrm_has_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    cfg = DLRMConfig(vocab_sizes=(16, 8), embed_dim=8, batch_size=4, cache_ratio=0.5,
                     bottom_mlp=(8,), top_mlp=(8,), model_shards=2, replicate_top_k=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DLRM(cfg).init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1", "--batch", "4", "--model-shards", "2"])


def test_lm_has_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMModel(smollm_360m.SMOKE).init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_numpy({"head": {"w": np.zeros((2, 3), np.float32)}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_decode_caches(smollm_360m.SMOKE, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_state_from_numpy({"params": {}, "opt": {}, "step": np.int32(0)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "olmoe-1b-7b", "--steps", "1"])


def test_gnn_has_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GatedGCNModel(gatedgcn.SMOKE).init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.gatedgcn_state_from_numpy({"params": {}, "opt": {}, "step": np.int32(0)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "gatedgcn", "--steps", "1"])
    assert GatedGCNModel(gatedgcn.SMOKE).init(0, device="cpu")["step"].device.type == "cpu"


@pytest.mark.parametrize("arch", ["din", "dien", "mind"])
def test_recsys_families_have_no_silent_cpu_fallback(arch):
    """DIN, DIEN and MIND: ``init`` and both launchers raise without a card
    unless given ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    cls, smoke = {"din": (DINModel, din.SMOKE), "dien": (DIENModel, dien.SMOKE),
                  "mind": (MINDModel, mind.SMOKE)}[arch]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(smoke).init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", arch, "--steps", "1", "--batch", "4"])
    if arch != "dien":  # the serve launcher's archs are the reference's: mind, din, dlrm-criteo
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", arch, "--requests", "4", "--batch", "4"])
    state = cls(smoke).init(0, device="cpu")
    assert state["emb"].slabs["__shared__"].idx_map.device == torch.device("cpu")
