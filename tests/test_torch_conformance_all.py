"""``python -m repro_torch.analysis.conformance_all``: the launch-plan sweep
over every ``verify_all`` form that ``ops._plan`` routes, on the H100 and
v5e tables, each dtype pair (no JAX: the sweep is the port's own)."""
import json

import pytest

from repro_torch.analysis import conformance_all, verify_all
from repro_torch.core import expr as E

#: (mul, add) forms of ``verify_all._forms()``; the tropical ones refuse
#: int32
MUL_ADD = ("matmul", "matmul_tb", "expert_gemm", "hadamard", "head_gemm",
           "head_gemm_tb")


@pytest.fixture(scope="module")
def h100_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("conformance") / "out.json"
    assert conformance_all.main(["--hardware", "h100", "--json",
                                 str(out)]) == 0
    return json.loads(out.read_text())


def test_h100_sweep_counts_and_no_failure(h100_report):
    """8 planned forms x 4 dtype pairs: the bf16 accumulator refused on
    every one (the H100 table has none), int32 on the two tropical forms;
    the 12 recurrent forms apart, 48 cases; no error finding."""
    r = h100_report
    assert r["sweep"] == "conformance_all" and r["hardware"] == ["h100"]
    assert r["failed"] == 0 and r["failures"] == [] and r["findings"] == []
    assert (r["checked"], r["refused"], r["not_planned"]) == (22, 10, 48)
    planned = sum(isinstance(f, E.Expr) for _, f in verify_all._forms())
    assert planned == 8 and r["checked"] + r["refused"] == planned * 4


@pytest.mark.parametrize("form", MUL_ADD)
def test_int32_row_is_checked_on_every_mul_add_form(h100_report, form):
    """int8 + int32 is checked, not refused, on every (mul, add) form: K1's
    int8 form or K9's integer accumulator plans it."""
    assert h100_report["cases"][f"h100/{form}/int8+int32"] == "checked"


@pytest.mark.parametrize("form", ["max_plus", "min_plus"])
def test_int32_row_is_refused_off_mul_add(h100_report, form):
    assert h100_report["cases"][f"h100/{form}/int8+int32"] == "refused"


def test_both_tables_sweep_clean(tmp_path, capsys):
    """Both tables: the v5e's bf16 accumulator derives but has no kernel
    path in the port (``ops._plan`` refuses it), so it counts as refused,
    not as a plan that ignores its bundle."""
    out = tmp_path / "all.json"
    assert conformance_all.main(["--json", str(out)]) == 0
    r = json.loads(out.read_text())
    assert r["hardware"] == ["h100", "tpu_v5e"] and r["failed"] == 0
    assert (r["checked"], r["refused"], r["not_planned"]) == (44, 20, 96)
    assert r["cases"]["tpu_v5e/matmul/bfloat16+bfloat16"] == "refused"
    assert "0 failures" in capsys.readouterr().out


def test_unknown_table_raises():
    with pytest.raises(ValueError, match="unknown hardware table"):
        conformance_all.run_sweep(hardware="v100")
