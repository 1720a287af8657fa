"""``python -m repro_torch.analysis.conformance_all`` -- the launch-plan
sweep (``repro.analysis.conformance_all``'s counterpart).

The companion of ``verify_all``: where that sweep proves the derived
schedules, this one checks what the port launches for them.  For every
``verify_all._forms()`` entry that ``kernels.ops._plan`` routes (K1 or K9:
the normal forms) x hardware table x ``verify_all._DTYPE_MATRIX`` pair, it
derives the bundle, makes the launch plan and checks it against the bundle
with ``conformance.kernel_findings`` (K1's route and k split, K9's
descriptor: coverage, bounds, pad value, accumulator, roles).  Nothing is
launched and no card is needed.

A combination the registries refuse (an illegal semiring / accumulator
pair, a table with no path for the dtype, infeasible blocks) counts as
``refused``.  The recurrent forms (attention, SSD, RG-LRU, paged decode:
K2-K8, whose launch is their own wrapper's and takes no plan) are counted
apart, under ``not_planned``, and are neither checked nor refused.  Any
error finding on a plan fails the sweep (exit 1).

``--hardware NAME`` restricts the sweep to one table (``h100``,
``tpu_v5e``); ``--json out.json`` writes the report (summary counts, each
case's status under ``cases`` and a row per error finding); ``-v`` prints
every case.
"""
from __future__ import annotations

import json
import sys

from repro_torch.analysis import conformance
from repro_torch.analysis.verify import errors
from repro_torch.analysis.verify_all import (_DTYPE_MATRIX, BLOCK_OVERRIDES,
                                             TABLES, _forms)
from repro_torch.core import expr as E
from repro_torch.core import schedule as sched_mod
from repro_torch.kernels import emit


def _tables(hardware):
    if hardware is None:
        return TABLES
    found = [t for t in TABLES if t.name == hardware]
    if not found:
        raise ValueError(f"unknown hardware table {hardware!r}; the sweep "
                         f"takes {[t.name for t in TABLES]}")
    return found


def run_sweep(hardware=None, verbose=False):
    """Sweep; returns the report dict ``--json`` serializes."""
    tables = _tables(hardware)
    checked = refused = not_planned = 0
    failures: list[str] = []
    rows: list[dict] = []
    cases: dict[str, str] = {}
    for table in tables:
        for label, form in _forms():
            for dtype, acc in _DTYPE_MATRIX:
                case = f"{table.name}/{label}/{dtype}+{acc}"
                if not isinstance(form, E.Expr):
                    not_planned += 1
                    cases[case] = "not_planned"
                    continue
                nf = E.normal_form(form)
                dtypes = (dtype,) * len(nf.leaves)
                try:
                    bundle = None if emit.is_chain(nf) else \
                        sched_mod.get_schedule(
                            nf, dtype=dtype, hardware=table, acc_dtype=acc,
                            blocks=BLOCK_OVERRIDES.get(label))
                    findings = conformance.kernel_findings(
                        bundle, nf, dtypes, hardware=table,
                        blocks=BLOCK_OVERRIDES.get(label), acc_dtype=acc)
                except (ValueError, AssertionError) as exc:
                    refused += 1
                    cases[case] = "refused"
                    if verbose:
                        print(f"  refused {case}: {exc}")
                    continue
                checked += 1
                cases[case] = "checked"
                errs = errors(findings)
                if errs:
                    failures.append(case)
                    for f in errs:
                        rows.append({"case": case, "rule": f.rule,
                                     "level": f.level, "subject": f.subject,
                                     "message": f.message})
                        print(f"FAIL {case}: {f}")
                elif verbose:
                    print(f"  ok {case}")
    return {
        "sweep": "conformance_all",
        "hardware": [t.name for t in tables],
        "checked": checked,
        "refused": refused,
        "not_planned": not_planned,
        "failed": len(failures),
        "failures": failures,
        "findings": rows,
        "cases": cases,
    }


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    hardware = args[args.index("--hardware") + 1] \
        if "--hardware" in args else None
    json_path = args[args.index("--json") + 1] if "--json" in args else None
    report = run_sweep(hardware=hardware, verbose="-v" in args)
    if json_path:
        with open(json_path, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
    print(f"conformance_all: {report['checked']} launch plans checked, "
          f"{report['refused']} refused at derivation, "
          f"{report['not_planned']} recurrent cases not planned, "
          f"{report['failed']} failures across "
          f"{len(report['hardware'])} hardware tables")
    return 1 if report["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
