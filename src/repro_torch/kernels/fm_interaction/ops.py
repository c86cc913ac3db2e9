"""Entry point of the FM-interaction kernel (port of
``repro.kernels.fm_interaction.ops``): ``fm_interaction(v)``, v [B, F, D]
-> [B] in ``v``'s dtype, which dispatches by the device of ``v``.  The
reference pads the batch to its block size; the CUDA kernel guards its own
tail, so nothing is padded here."""
from __future__ import annotations

from repro_torch.kernels.fm_interaction.kernel import fm_interaction

__all__ = ["fm_interaction"]
