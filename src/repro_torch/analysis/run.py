"""The gate: ``python -m repro_torch.analysis.run [--json] [--strict]
[--skip-ast] [--device cpu|cuda]`` (port of ``repro.analysis.run``).

Runs every registered entry point's smoke case on ``--device`` under the
checks of ``analysis.checks``, and the AST pass over ``src/repro_torch``,
diffs the findings against the known-issue baseline
(``analysis/baseline.json``) and exits:

* 0 — clean (every finding is in the baseline);
* 1 — a new finding (not in the baseline);
* 2 — ``--strict`` only: a stale baseline entry (listed, but it no longer
  fires: the fix landed, so delete its line).

A baseline entry is keyed by ``(check, entry, device)``, where ``device``
is ``cpu``, ``cuda`` or ``any``, and carries a one-line rationale; a run
judges the entries of its own device and ``any``.  An entry that is a sync
on the card names the ROADMAP item that would remove it.  On ``--device
cuda`` the report also gives each case's kernel launches, by wrapper.
``--json`` prints the whole report on stdout.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence

from repro_torch.analysis import ast_lint, checks
from repro_torch.analysis.contracts import Violation, registry

_DEFAULT_BASELINE = Path(__file__).with_name("baseline.json")
_ROOT = Path(__file__).resolve().parents[3]


def load_baseline(path: Path) -> List[Dict[str, str]]:
    if not path.exists():
        return []
    return json.loads(path.read_text()).get("known_issues", [])


def kernel_counts() -> Dict[str, int]:
    """Every hand-written kernel's launch count, by wrapper (the fused
    entries and the flash routes apart)."""
    from repro_torch.kernels import counters

    c = counters.launch_counts()
    out = {k: n for k, n in c.items() if k != "flash_attention"}  # its routes apart
    out["gather_decode"] -= c["gather_decode_encode"]
    out["bucketize"] -= c["route_bucketize"]
    return out


def _launches(into: Dict[str, int]) -> Callable:
    """A ``run`` hook for ``checks.check_case``: the kernels launched by the
    call, added to ``into``."""
    def run(fn):
        before = kernel_counts()
        try:
            return fn()
        finally:
            after = kernel_counts()
            into.update({k: after[k] - before[k] for k in after if after[k] != before[k]})
    return run


def analyze(root: Path, device: str = "cpu", ast: bool = True) -> Dict[str, Any]:
    """Every smoke case's checks on ``device`` and the AST pass; returns
    the raw (un-baselined) report."""
    from repro_torch.analysis import smoke  # imports every covered module

    reg = registry()
    cases = smoke.build_cases(device)
    violations: List[Violation] = []
    per_entry: Dict[str, Any] = {}
    for name in sorted(set(reg) - set(cases)):
        violations.append(Violation("no-smoke", name, "registered entry point has no smoke "
                                    "case (add one in analysis/smoke.py)", device))
    for name in sorted(set(reg) & set(cases)):
        launches: Dict[str, int] = {}
        try:
            found, seen = checks.check_case(cases[name], reg[name][1], device,
                                            run=_launches(launches) if device == "cuda" else None)
        except Exception:  # the gate reports a case that fails and runs the rest
            found, seen = [Violation("smoke-error", name, traceback.format_exc(limit=-3),
                                     device)], {}
        violations += found
        per_entry[name] = dict(seen, launches=launches)
    n_files = 0
    if ast:
        ast_found, n_files = ast_lint.lint_tree(root, set(reg))
        violations += ast_found
    return {"entries": sorted(reg), "device": device, "ast_files": n_files,
            "per_entry": per_entry, "violations": violations}


def apply_baseline(report: Dict[str, Any], baseline: List[Dict[str, str]]) -> Dict[str, Any]:
    """Split the findings into new and baselined; list the stale entries of
    this run's device (and of ``any``)."""
    dev = report["device"]
    known = {(b["check"], b["entry"], b.get("device", "any")): b for b in baseline
             if b.get("device", "any") in (dev, "any")}
    new, suppressed, fired = [], [], set()
    for v in report["violations"]:
        k = next((k for k in ((v.check, v.entry, dev), (v.check, v.entry, "any"))
                  if k in known), None)
        if k is None:
            new.append(v.to_dict())
        else:
            fired.add(k)
            suppressed.append(dict(v.to_dict(), rationale=known[k]["rationale"]))
    stale = [known[k] for k in sorted(set(known) - fired)]
    return {"entries": report["entries"], "device": dev, "ast_files": report["ast_files"],
            "per_entry": report["per_entry"], "new": new, "baselined": suppressed,
            "stale_baseline": stale, "ok": not new}


def main(argv: Sequence[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.analysis.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json", action="store_true", help="machine-readable report")
    p.add_argument("--strict", action="store_true",
                   help="also fail (exit 2) on stale baseline entries")
    p.add_argument("--baseline", type=Path, default=_DEFAULT_BASELINE)
    p.add_argument("--root", type=Path, default=_ROOT,
                   help="repo root (the AST pass reads src/repro_torch under it)")
    p.add_argument("--skip-ast", action="store_true", help="skip the AST pass")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = p.parse_args(argv)

    if args.device == "cuda":
        from repro_torch.device import resolve_device

        resolve_device("cuda")  # raises without a card: no fallback to the CPU
    report = apply_baseline(analyze(args.root, args.device, ast=not args.skip_ast),
                            load_baseline(args.baseline))
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(f"analyzed {len(report['entries'])} entry points on {report['device']}, "
              f"{report['ast_files']} source files")
        for v in report["new"]:
            print(f"  NEW   {v['check']:18s} {v['entry']}: {v['detail']}")
        for v in report["baselined"]:
            print(f"  known {v['check']:18s} {v['entry']} ({v['rationale']})")
        for b in report["stale_baseline"]:
            print(f"  STALE baseline entry {b['check']}::{b['entry']} ({b.get('device', 'any')})"
                  " no longer fires: delete it from baseline.json")
        print(f"{'OK' if report['ok'] else 'FAIL'}: {len(report['new'])} new, "
              f"{len(report['baselined'])} baselined, {len(report['stale_baseline'])} stale")
    if not report["ok"]:
        return 1
    if args.strict and report["stale_baseline"]:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
