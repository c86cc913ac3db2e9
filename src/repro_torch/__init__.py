"""PyTorch/CUDA port of the frequency-aware embedding cache (``repro``).

Each module sits at the same relative path as its JAX counterpart under
``repro/`` and computes the same thing: index state, plans, victim order and
fp32 row movement bit for bit, float math within fp32 tolerance.  The port
imports torch, numpy and the standard library only.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`); the hand-written Hopper
kernels live under ``kernels/`` next to their plain PyTorch versions, which
the CPU takes.
"""
