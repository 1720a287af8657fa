"""The port's package boundary and set-up: no JAX or ``repro`` import, the
device policy, the copied block solver against the reference's, the H100
page-size derivation, the kernel build command, and ``chip_smoke.py``
refusing to run without a card."""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.blocking import solve_recurrence_blocks
from repro_torch.hardware import H100, TPU_V5E
from repro_torch.kernels import build, ops

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert len(mods) >= 50, mods\n"
        "assert {'repro_torch.models.rglru', 'repro_torch.configs.minicpm3_4b', "
        "'repro_torch.analysis.conformance_all', "
        "'repro_torch.launch.dryrun', 'repro_torch.models.common', "
        "'repro_torch.models.encdec', 'repro_torch.models.registry', "
        "'repro_torch.configs.paligemma_3b', "
        "'repro_torch.configs.whisper_base', "
        "'repro_torch.train.serve_step', 'repro_torch.core.expr', "
        "'repro_torch.core.schedule', 'repro_torch.kernels.emit'} "
        "<= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    from repro_torch.configs import gemma_2b
    from repro_torch.models import transformer
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gemma_2b.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_lm(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_paged_pools(cfg, 8)
    assert resolve_device("cpu") == torch.device("cpu")
    params = transformer.init_lm(cfg, torch.Generator(), device="cpu")
    assert params["embed"]["table"].device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_ssm_caches_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    from repro_torch.configs import mamba2_780m
    from repro_torch.models import ssm, transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = mamba2_780m.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ssm.init_ssm_cache(cfg, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_cache(cfg, 2, 32)
    cache = ssm.init_ssm_cache(cfg, 2, device="cpu")
    assert cache.conv.device.type == cache.state.device.type == "cpu"


def test_hybrid_entry_points_need_a_card_unless_cpu_is_asked_for(
        monkeypatch):
    """The RG-LRU cache, the hybrid decode cache and the parameters
    default to the card; ``greedy_generate`` runs where the caller's
    tensors are, here on the CPU because they were made there."""
    from repro_torch.configs import recurrentgemma_9b
    from repro_torch.models import rglru, transformer
    from repro_torch.train import serve_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = recurrentgemma_9b.reduced().with_(n_layers=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rglru.init_rglru_cache(cfg, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_lm(cfg, torch.Generator())
    cache = rglru.init_rglru_cache(cfg, 2, device="cpu")
    assert cache.h.device.type == cache.conv.device.type == "cpu"
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    out = serve_step.greedy_generate(params, cfg,
                                     torch.zeros(2, 3, dtype=torch.long), 2,
                                     16)
    assert out.shape == (2, 5) and out.device.type == "cpu"


def test_training_entry_points_need_a_card_unless_cpu_is_asked_for(
        monkeypatch):
    from repro_torch.configs import gemma_2b
    from repro_torch.models import transformer
    from repro_torch.train import train_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gemma_2b.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_lm(cfg, torch.Generator(), trainable=True)
    params = transformer.init_lm(cfg, torch.Generator(), device="cpu",
                                 trainable=True)
    assert all(p.requires_grad for p in params.parameters())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_step.init_state(cfg, params)
    state = train_step.init_state(cfg, params, device="cpu")
    assert state.step.device.type == "cpu"


def _grid():
    for s in (64, 256, 512, 4096):
        for token_elems, state_elems, quad, lin in (
                (512, 8 * 258, 8, 8 * 256),        # gemma-2b decode page
                (64, 4 * 34, 4, 4 * 32),           # reduced gemma-2b
                (2 * 128 + 24 * 65, 2 * 24 * 64 * 128, 25, 96)):   # SSD
            for dtype in ("float32", "bfloat16"):
                yield s, token_elems, state_elems, quad, lin, dtype


@pytest.mark.parametrize("table", ["v5e", "h100"])
def test_block_solver_copy_matches_reference(table):
    """Over a grid of shapes, the copied solver picks the reference's
    chunk on the v5e table and on the port's H100 table (handed to the
    reference as its own HardwareShape)."""
    pytest.importorskip("jax")
    from repro.core import blocking as jb
    from repro.core import lifting as jl
    port_hw = TPU_V5E if table == "v5e" else H100
    ref_hw = jl.HardwareShape(
        **{f.name: getattr(port_hw, f.name)
           for f in dataclasses.fields(port_hw)
           if f.name not in ("vmem", "hbm")},
        vmem=jl.MemoryLevel(**dataclasses.asdict(port_hw.vmem)),
        hbm=jl.MemoryLevel(**dataclasses.asdict(port_hw.hbm)))
    if table == "v5e":
        assert ref_hw == jl.TPU_V5E
    for s, te, se, quad, lin, dtype in _grid():
        kw = dict(token_elems=te, state_elems=se, quad_elems=quad,
                  lin_elems=lin, dtype=dtype)
        got = solve_recurrence_blocks(s, hardware=port_hw, **kw)
        want = jb.solve_recurrence_blocks(s, hardware=ref_hw, **kw)
        assert (got.bs, got.vmem_bytes) == (want.bs, want.vmem_bytes)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("max_len", [64, 512, 4096])
def test_h100_page_size_is_the_smallest_aligned_chunk(dtype, max_len):
    """At gemma-2b widths the decode working set (~180 KB) exceeds a
    quarter of the H100's 227 KB of shared memory at every candidate, so
    the solver degrades to its smallest aligned chunk: 16 tokens."""
    assert ops.default_decode_page(max_len, 1, 8, 256, dtype=dtype) == 16


def test_nvcc_command_and_build_directory():
    assert build.BUILD_DIR == ROOT / "build" / "kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert build.sources() == ["flash_bwd", "flash_fwd", "gated_scan",
                               "gemm", "paged_decode", "semiring", "ssd"]
    out = build.library_path("gemm")
    assert out.parent == build.BUILD_DIR
    assert out.name.startswith("gemm-") and out.suffix == ".so"
    cmd = build.nvcc_command("gemm", out, nvcc="/x/nvcc")
    assert cmd[0] == "/x/nvcc"
    flags = " ".join(cmd)
    for flag in ("-gencode arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler -fPIC"):
        assert flag in flags
    assert cmd[-3:] == ["-o", str(out), str(build.CSRC / "gemm.cu")]


def _smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table_step(read_rows: int, pad_rows: int, bad_row=None):
    """One AdamW step of a (rows, 32) table in two runs, as
    ``_hold_moments`` takes them: ``read_rows`` rows a token read (m
    ~ N(0, 1), the runs' m 1e-3 apart, the update -1e-3 m / sqrt(v)),
    then ``pad_rows`` rows no token read (exact zeros in both runs);
    ``bad_row`` a read row whose m and update have the other sign in the
    first run (a row-local error)."""
    rng = np.random.default_rng(3)
    m_p = torch.tensor(rng.standard_normal((read_rows, 32)),
                       dtype=torch.float32)
    m_k = m_p + 1e-3 * torch.tensor(rng.standard_normal(m_p.shape),
                                    dtype=torch.float32)
    if bad_row is not None:
        m_k[bad_row] = -m_k[bad_row]
    v = m_p.square() + 1e-2
    pad = lambda t: torch.cat([t, torch.zeros(pad_rows, 32)])
    upd = lambda m: pad(-1e-3 * m / v.sqrt())
    start = {"t": torch.zeros(read_rows + pad_rows, 32)}
    return ([{"t": (upd(m_k), pad(m_k), pad(v))}],
            {"start": start, "moments": [{"t": (upd(m_p), pad(m_p),
                                                pad(v))}]})


@pytest.mark.parametrize("bad_row", [None, 5])
def test_dist_moment_check_is_blind_to_never_read_rows(bad_row):
    """``chip_smoke._hold_moments`` takes the m noise over the elements
    either run touched: a table's never-read rows (exact zeros in both
    runs, 1960 of 2000 here) change none of its errors, so they neither
    hide a row-local error nor widen the update check.  A read row of
    the other sign fails the update check (``upd_err`` over GRAD_TOL)
    with those rows as without them; a clean table passes both."""
    smoke = _smoke_module()
    alone, padded = (smoke._hold_moments(
        torch, *_table_step(40, pad, bad_row))["t"][0] for pad in (0, 1960))
    assert padded["touched"] == pytest.approx(40 / 2000)
    for key in ("m_err", "v_err", "upd_err", "flipped", "flip_m_med",
                "flip_m_max"):
        assert padded[key] == pytest.approx(alone[key], rel=1e-9), key
    assert (padded["upd_err"] > smoke.GRAD_TOL) == (bad_row is not None)
    if bad_row is None:
        assert padded["m_err"] <= smoke.GRAD_TOL
        assert padded["sign_agree"] >= smoke.DIST_SIGN_AGREE


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without a card (and, separately, alone in a directory without the
    package) the smoke exits non-zero and prints no result line."""
    runs = [(ROOT / "chip_smoke.py", ROOT)]
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs.append((alone, tmp_path))
    for script, cwd in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
