"""Torch-aware AST pass over ``src/repro_torch`` (port of
``repro.analysis.ast_lint``): what a linter cannot see because it is
PyTorch semantics.

Three rules hold in step code: the bodies of ``@contract`` functions (and
functions nested in them), the registry's entries passed in ``extra``, and
every function of the step modules ``optim/``, ``nn/`` and ``models/``.

* ``ast-host-sync``: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()`` or any ``.synchronize()``, and ``float()`` /
  ``int()`` / ``bool()`` of a tensor parameter: each blocks the host on the
  card.  The recorder of ``analysis.checks`` cannot see ``.tolist()``,
  ``.cpu()`` or ``.numpy()`` of a CPU tensor, so this pass covers them.
* ``ast-tensor-branch``: ``if`` / ``while`` on a tensor parameter by bare
  name (``bool()`` of it: a sync).  Attribute access (``x.shape``,
  ``cfg.writeback``), ``isinstance`` / ``len`` / ``getattr`` calls and
  ``is None`` tests are static and left out.
* ``ast-scalar-to-device``: ``torch.tensor(...)`` or ``torch.as_tensor(...)``
  of a Python value with ``device=`` taken from a tensor (``x.device``): a
  blocking copy from pageable memory each call.  ``torch.full`` builds the
  same scalar on the card with no copy.

One rule holds in the host modules that collect metrics (``train/trainer.py``,
``serve/engine.py``, ``obs/``):

* ``ast-obs-host-sync``: a sync primitive (``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``.synchronize()``) outside the documented
  points: the trainer's ``_post_step`` (the step's loss, overflow guard and
  telemetry fetches), ``PipelinedTrainer._check_window`` (a group's one
  residency fetch), the engine's ``score`` (the response is the fetch) and
  ``summary`` (on-demand reporting), and the hub's one batched fetch
  (``fetch_ints``).

A tensor parameter is one annotated with a ``Tensor`` type, or left
unannotated under a name that is not static (``self``, ``cls``, ``cfg``, ...);
parameters annotated as Python scalars, configs or other types are static.
A line containing ``torchlint: ok`` suppresses its findings.

The reference's ``ast-state-mutation`` and ``ast-unregistered-dataclass``
have no counterpart: the port updates its arena and tables in place on
purpose (the ``in_place`` contracts check it), and a torch dataclass needs
no pytree registration.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.contracts import Violation

__all__ = ["lint_file", "lint_source", "lint_tree"]

_STATIC_NAMES = {"self", "cls", "cfg", "config", "ccfg", "scfg", "spec"}
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")
_STATIC_CALLS = {"isinstance", "len", "getattr", "hasattr", "callable", "type"}
_STEP_PACKAGES = ("repro_torch.optim", "repro_torch.nn", "repro_torch.models")
_OBS_MODULES = ("repro_torch.train.trainer", "repro_torch.serve.engine", "repro_torch.obs")
_OBS_SYNC_OK = {"_post_step", "_check_window", "score", "summary", "fetch_ints"}
_SUPPRESS = "torchlint: ok"


def _unparse(node: Optional[ast.AST]) -> str:
    return "" if node is None else ast.unparse(node)


def _is_contract(dec: ast.AST) -> bool:
    head = _unparse(dec).split("(", 1)[0]
    return head == "contract" or head.endswith(".contract")


def _tensor_params(fn: ast.AST) -> Set[str]:
    a = fn.args
    out = set()
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        ann = _unparse(p.annotation)
        if "Tensor" in ann or (not ann and p.arg not in _STATIC_NAMES):
            out.add(p.arg)
    return out


class _Refs(ast.NodeVisitor):
    """Bare-name references to tensor parameters, static contexts left out."""

    def __init__(self, names: Set[str]):
        self.names, self.hits = names, []

    def visit_Attribute(self, node):  # x.shape, cfg.flag: static
        return

    def visit_Call(self, node):
        if isinstance(node.func, ast.Name) and node.func.id in _STATIC_CALLS:
            return
        self.generic_visit(node)

    def visit_Compare(self, node):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return
        self.generic_visit(node)

    def visit_Name(self, node):
        if node.id in self.names:
            self.hits.append(node.id)


def _refs(node: ast.AST, names: Set[str]) -> List[str]:
    r = _Refs(names)
    r.visit(node)
    return r.hits


def _sync_call(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS and not node.args:
        return f"{_unparse(f)}()" if f.attr == "synchronize" else f".{f.attr}()"
    return None


@dataclasses.dataclass
class _Ctx:
    path: str
    lines: Sequence[str]
    module: str
    extra: Set[str]
    out: List[Violation]

    def add(self, check: str, node: ast.AST, detail: str) -> None:
        line = node.lineno
        if 0 < line <= len(self.lines) and _SUPPRESS in self.lines[line - 1]:
            return
        self.out.append(Violation(check, f"{self.path}:{line}", detail))


def _lint_body(fn: ast.AST, ctx: _Ctx, tensors: Set[str]) -> None:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            sync = _sync_call(node)
            f = node.func
            if sync:
                ctx.add("ast-host-sync", node, f"{sync} blocks the host on the card")
            elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool"):
                refs = [r for a in node.args for r in _refs(a, tensors)]
                if refs:
                    ctx.add("ast-host-sync", node,
                            f"{f.id}() of tensor parameter '{refs[0]}' blocks the host")
            elif _unparse(f) in ("torch.tensor", "torch.as_tensor") and node.args:
                dev = next((k.value for k in node.keywords if k.arg == "device"), None)
                arg = node.args[0]
                if (isinstance(dev, ast.Attribute) and dev.attr == "device"
                        and not (isinstance(arg, ast.Name) and arg.id in tensors)):
                    ctx.add("ast-scalar-to-device", node,
                            f"{_unparse(f)}(<Python value>, device={_unparse(dev)}) is a "
                            "blocking host-to-device copy; build it with torch.full")
        elif isinstance(node, (ast.If, ast.While)):
            refs = _refs(node.test, tensors)
            if refs:
                kind = "if" if isinstance(node, ast.If) else "while"
                ctx.add("ast-tensor-branch", node,
                        f"Python `{kind}` on tensor parameter '{refs[0]}' syncs the host; "
                        "use torch.where")


def _walk(node: ast.AST, ctx: _Ctx, qual: str, step: bool) -> None:
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            q = f"{qual}.{child.name}" if qual else child.name
            here = (step or any(_is_contract(d) for d in child.decorator_list)
                    or f"{ctx.module}.{q}" in ctx.extra)
            if here:
                _lint_body(child, ctx, _tensor_params(child))
            else:
                _walk(child, ctx, q, False)
        elif isinstance(child, ast.ClassDef):
            _walk(child, ctx, f"{qual}.{child.name}" if qual else child.name, step)
        else:
            _walk(child, ctx, qual, step)


def _lint_obs(tree: ast.AST, ctx: _Ctx) -> None:
    def walk(node: ast.AST, fname: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(child, child.name)
                continue
            if isinstance(child, ast.Call):
                sync = _sync_call(child)
                if sync and fname not in _OBS_SYNC_OK:
                    ctx.add("ast-obs-host-sync", child,
                            f"{sync} in '{fname}': metric collection adds no host sync outside "
                            f"the documented points ({', '.join(sorted(_OBS_SYNC_OK))})")
            walk(child, fname)

    walk(tree, "<module>")


def _in(module: str, packages: Sequence[str]) -> bool:
    return any(module == m or module.startswith(m + ".") for m in packages)


def lint_source(source: str, path: str = "<string>", module: str = "",
                extra: Iterable[str] = ()) -> List[Violation]:
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation("ast-parse-error", f"{path}:{e.lineno}", str(e))]
    ctx = _Ctx(path=path, lines=source.splitlines(), module=module, extra=set(extra), out=[])
    # a function linted as step code also covers the functions nested in it
    _walk(tree, ctx, "", _in(module, _STEP_PACKAGES))
    if _in(module, _OBS_MODULES):
        _lint_obs(tree, ctx)
    return sorted(set(ctx.out), key=lambda v: (v.entry, v.check))


def _module_name(path: Path, root: Path) -> str:
    parts = list(path.resolve().relative_to(root.resolve()).with_suffix("").parts)
    return ".".join(parts[1:] if parts and parts[0] == "src" else parts)


def lint_file(path: Path, root: Path, extra: Iterable[str] = ()) -> List[Violation]:
    rel = str(path.resolve().relative_to(root.resolve()))
    return lint_source(path.read_text(), path=rel, module=_module_name(path, root), extra=extra)


def lint_tree(root: Path, extra: Iterable[str] = ()) -> Tuple[List[Violation], int]:
    """Lint every ``.py`` under ``root/src/repro_torch``; (findings, files)."""
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    out: List[Violation] = []
    for f in files:
        out.extend(lint_file(f, root, extra))
    return out, len(files)
