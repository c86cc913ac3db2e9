"""The hot-path contract gate of the port (port of ``repro.analysis``).

The paper's claim rests on the cache being a pure on-device data-movement
layer: one hidden host sync inside ``plan_prepare`` or ``apply_plan``
removes the overlap, while the losses still look right.  Eager PyTorch
syncs silently (``.item()``, ``int()`` of a tensor, ``if tensor:``,
``nonzero``, a boolean-mask index, ``unique``, a tensor built from Python
data on the card), so the port checks its entry points for them:

* ``contracts`` — the ``@contract`` registry the entry points declare on;
* ``smoke``     — one small case per registered entry, built by the real
                  ``init`` paths on a given device;
* ``checks``    — each case run once under an operation recorder (and, on
                  the card, under the sync census);
* ``census``    — host syncs on the card by the site in the port;
* ``ast_lint``  — a torch-aware AST pass over ``src/repro_torch``;
* ``run``       — the gate: ``python -m repro_torch.analysis.run
                  [--json] [--strict] [--skip-ast] [--device cpu|cuda]``.

Only ``contracts`` is imported here: the covered modules import it.
"""
from repro_torch.analysis.contracts import Contract, Violation, contract, registry

__all__ = ["Contract", "Violation", "contract", "registry"]
