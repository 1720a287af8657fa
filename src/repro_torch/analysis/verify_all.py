"""``python -m repro_torch.analysis.verify_all`` -- the registry sweep.

Derives and statically verifies every registered form x hardware table
(``H100``, the card the port runs on, and the ``TPU_V5E`` copy the tests
hold against the reference) x dtype x accumulation, and the distributed
plans of ``_plan_cases`` on each table (``verify_sharded``; cases
``<table>/<plan>/<dtype>``).  Pure derivation and
verification on the host: no kernel launches and no card is needed.

A combination the registries refuse to derive (a dtype / accumulator pair
the table has no path for, blocks that cannot fit the table's fast
memory, a paged view the solved block would pad) is correct static
behaviour and counts as ``refused``, not a failure.  Any error finding on
a derivation that succeeded fails the sweep (exit 1).

``--json out.json`` writes the report: summary counts, each case's status
(``cases``: ``"checked"`` or ``"refused"``) and a row per error finding.
``-v`` prints every case.
"""
from __future__ import annotations

import json
import sys
import warnings

from repro_torch import analysis
from repro_torch.core import expr as E
from repro_torch.core.mesh import MeshShape
from repro_torch.distributed.plan import ReplicationFallbackWarning
from repro_torch.hardware import H100, TPU_V5E

#: the tables the sweep derives on
TABLES = (H100, TPU_V5E)


def _forms():
    """(label, form) for every registered schedule shape, at sizes that
    exercise padding on both output and reduce axes."""
    yield "matmul", E.matmul_expr(300, 200, 160)
    yield "matmul_tb", E.matmul_expr(300, 200, 160, transpose_b=True)
    yield "expert_gemm", E.expert_gemm_expr(4, 60, 96, 72)
    yield "hadamard", E.hadamard_expr(200, 300)
    yield "head_gemm", E.head_gemm_expr(4, 48, 32, 40)
    yield "head_gemm_tb", E.head_gemm_expr(4, 48, 32, 40, transpose_b=True)
    yield "max_plus", E.inner("max", "add", E.arr("A", (100, 60)),
                              E.arr("B", (60, 80)))
    yield "min_plus", E.inner("min", "add", E.arr("A", (100, 60)),
                              E.arr("B", (60, 80)))
    yield "attention", E.attention_form(1, 2, 2, 300, 300, 64)
    yield "attention_stats", E.attention_stats_form(1, 2, 2, 300, 300, 64)
    yield "attention_windowed", E.attention_form(1, 1, 1, 256, 256, 64,
                                                 window=128)
    yield "flash_dq", E.attention_dq_form(1, 1, 1, 300, 300, 64)
    yield "flash_dkv", E.attention_dkv_form(1, 1, 1, 300, 300, 64)
    yield "ssd", E.ssd_form(1, 4, 64, 2, 16, 16)
    yield "ssd_chk", E.ssd_chk_form(1, 4, 64, 2, 16, 16)
    yield "ssd_bwd", E.ssd_bwd_form(1, 4, 64, 2, 16, 16)
    yield "rglru", E.rglru_form(1, 4, 64, 32)
    yield "rglru_bwd", E.rglru_bwd_form(1, 4, 64, 32)
    # the paged decode step: a scrambled page table into a larger slab pool
    yield "windowed_decode", E.windowed_decode_form(
        2, 4, 64, page=16, view_pages=4, pool_pages=6,
        page_table=(0, 3, 1, 5), window=32)
    # batched multi-slot decode: the slot axis lifted, a stacked [slot, k]
    # table into one shared pool
    yield "batched_decode", E.batched_decode_form(
        3, 2, 4, 64, page=16, view_pages=4, pool_pages=8,
        page_tables=((0, 3, 1, 5), (2, 4, 6, 7), (1, 0, 3, 2)), window=32)


#: (input dtype, accumulation dtype) -- legality is decided per table by
#: the semiring registry and the table's accumulators at derivation time
_DTYPE_MATRIX = (("float32", "float32"),
                 ("bfloat16", "float32"),
                 ("bfloat16", "bfloat16"),
                 ("int8", "int32"))

#: forms whose streamed axis only derives with pinned blocks: batched
#: decode pins (group rows, page size) as the serving engine does; the
#: generic solver has no page-alignment constraint
BLOCK_OVERRIDES = {"batched_decode": (4, 16)}


def _plan_cases():
    """(label, form, mesh, shard, keywords) of the distributed plans the
    sweep derives and verifies (``verify_sharded``)."""
    mesh = MeshShape((("x", 2),))
    mesh2 = MeshShape((("dx", 2), ("dy", 2)))
    m, k, n = 64, 96, 32
    f = E.matmul_expr(m, k, n)
    yield "plan_row", f, mesh, {"i": "x"}, {}
    yield "plan_col", f, mesh, {"j": "x"}, {}
    yield "plan_sigma", f, mesh, {"k": "x"}, {}
    yield "plan_both", f, mesh2, {"i": "dx", "j": "dy"}, {}
    yield "plan_gather", f, mesh, {"i": "x"}, {"replicate_out": True}
    yield "plan_scatter", f, mesh, {"k": "x"}, {"scatter_axis": "i"}
    yield ("plan_fallback", E.matmul_expr(31, 96, 32), mesh, {"i": "x"}, {})
    yield ("plan_expert", E.expert_gemm_expr(4, 60, 96, 72), mesh,
           {"i": "x"}, {})
    yield ("plan_bf16_acc", f, mesh, {"k": "x"},
           {"dtype": "bfloat16", "acc_dtype": "bfloat16"})


def _record(case, findings, rows, failures, verbose) -> int:
    """Add one checked case's error findings to the report; returns its
    warnings."""
    errs = analysis.errors(findings)
    if errs:
        failures.append(case)
        for f in errs:
            rows.append({"case": case, "rule": f.rule, "level": f.level,
                         "subject": f.subject, "message": f.message})
            print(f"FAIL {case}: {f}")
    elif verbose:
        print(f"  ok {case}")
    return len(findings) - len(errs)


def run_sweep(verbose=False):
    """Sweep every table; returns the report dict ``--json`` serializes."""
    checked = refused = warned = 0
    failures: list[str] = []
    rows: list[dict] = []
    cases: dict[str, str] = {}

    for table in TABLES:
        for label, form in _forms():
            for dtype, acc in _DTYPE_MATRIX:
                case = f"{table.name}/{label}/{dtype}+{acc}"
                try:
                    findings = analysis.verify_expr(
                        form, dtype=dtype, hardware=table, acc_dtype=acc,
                        blocks=BLOCK_OVERRIDES.get(label), strict=False)
                except (ValueError, AssertionError) as exc:
                    # the registries refusing an illegal or infeasible
                    # combination is the derivation-time failure wanted
                    refused += 1
                    cases[case] = "refused"
                    if verbose:
                        print(f"  refused {case}: {exc}")
                    continue
                checked += 1
                cases[case] = "checked"
                warned += _record(case, findings, rows, failures, verbose)

        for label, form, mesh, shard, kw in _plan_cases():
            kw = dict(kw)
            dtype = kw.pop("dtype", "float32")
            case = f"{table.name}/{label}/{dtype}"
            try:
                with warnings.catch_warnings():
                    # the fallback case's warning is its finding
                    warnings.simplefilter("ignore",
                                          ReplicationFallbackWarning)
                    findings = analysis.verify_sharded(
                        form, mesh, shard, hardware=table, dtype=dtype,
                        strict=False, **kw)
            except (ValueError, AssertionError) as exc:
                refused += 1
                cases[case] = "refused"
                if verbose:
                    print(f"  refused {case}: {exc}")
                continue
            checked += 1
            cases[case] = "checked"
            warned += _record(case, findings, rows, failures, verbose)

    return {
        "sweep": "verify_all",
        "hardware": [t.name for t in TABLES],
        "forms": len(list(_forms())),
        "plans": len(list(_plan_cases())),
        "dtypes": [f"{d}+{a}" for d, a in _DTYPE_MATRIX],
        "checked": checked,
        "refused": refused,
        "warned": warned,
        "failed": len(failures),
        "failures": failures,
        "findings": rows,
        "cases": cases,
    }


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    json_path = args[args.index("--json") + 1] if "--json" in args else None
    report = run_sweep(verbose="-v" in args)
    if json_path:
        with open(json_path, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
    print(f"verify_all: {report['checked']} combinations verified, "
          f"{report['refused']} refused at derivation, "
          f"{report['warned']} warnings, {report['failed']} failures "
          f"across {len(report['hardware'])} hardware tables")
    return 1 if report["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
