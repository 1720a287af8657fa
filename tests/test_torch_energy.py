"""The port's energy and cost model against the JAX package on the CPU.

The same inputs (seeded numpy arrays, shapes and block choices) go through
``repro.core.{moa,onf,lifting,energy,cost}`` and their copies in
``repro_torch``: floats equal within 1e-12 relative on every table both
packages hold (``TPU_V5E``, ``TPU_V5E_2POD``, ``V100``, ``GPU_A100``),
the normal forms' renderings, keys, innermost strides and executions
equal, and the reference's five energy relations
(``tests/test_energy.py``) through the port on ``TPU_V5E``.  On ``H100``
(the port's own table) the report's bound names its largest term and the
energy is at least the static power times the time.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import cost as jcost
from repro.core import energy as jenergy
from repro.core import lifting as jl
from repro.core import moa as jmoa
from repro.core import onf as jonf
from repro.core import blocking as jblk

from repro_torch import hardware as phw
from repro_torch.core import blocking as pblk
from repro_torch.core import cost as pcost
from repro_torch.core import energy as penergy
from repro_torch.core import lifting as pl_
from repro_torch.core import moa as pmoa
from repro_torch.core import onf as ponf

REL = 1e-12
TABLES = ["TPU_V5E", "TPU_V5E_2POD", "V100", "GPU_A100"]


def _tables(name):
    return getattr(jl, name), getattr(phw, name)


def _close(a, b):
    assert abs(a - b) <= REL * max(abs(a), abs(b)), (a, b)


def _same_report(a, b):
    assert a.bound == b.bound
    for f in ("time_s", "energy_J", "power_W", "flops", "hbm_bytes",
              "vmem_bytes", "ici_bytes"):
        _close(getattr(a, f), getattr(b, f))


# -- hardware tables ---------------------------------------------------------

@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_the_reference(name):
    j, p = _tables(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert j.n_chips == p.n_chips and j.mesh_shape() == p.mesh_shape()
    assert j.mesh_axis_names() == p.mesh_axis_names()


def test_h100_table_counts_its_sms():
    assert phw.H100.n_chips == 132 and phw.H100.mesh_shape() == (132,)


# -- moa ---------------------------------------------------------------------

def _arr(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("shape", [(3,), (2, 3), (2, 3, 4), ()])
def test_moa_shape_functions(shape):
    x = _arr(0, *shape)
    assert pmoa.rho(x) == jmoa.rho(x) and pmoa.dim(x) == jmoa.dim(x)
    idxs = jmoa.iota(shape).reshape(-1, len(shape))[:7] if shape else [()]
    for idx in idxs:
        for g in ("gamma_row", "gamma_col"):
            got = pmoa.psi_flat(tuple(idx), x, gamma=getattr(pmoa, g))
            want = jmoa.psi_flat(tuple(idx), x, gamma=getattr(jmoa, g))
            assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moa_operators_equal_the_reference(seed):
    a, b = _arr(seed, 4, 5), _arr(seed + 10, 4, 5)
    c = _arr(seed + 20, 5, 3)
    assert np.array_equal(pmoa.hadamard(a, b), jmoa.hadamard(a, b))
    assert np.array_equal(pmoa.outer_product(a, c), jmoa.outer_product(a, c))
    assert np.array_equal(pmoa.outer_product(a, c, op=np.add),
                          jmoa.outer_product(a, c, op=np.add))
    for axis in (0, 1):
        assert np.array_equal(pmoa.reduce_add(a, axis), jmoa.reduce_add(a, axis))
    assert np.array_equal(pmoa.inner_product(a, c), jmoa.inner_product(a, c))
    assert np.array_equal(pmoa.inner_product(a, 2.0),
                          jmoa.inner_product(a, 2.0))
    assert np.array_equal(pmoa.kron(a, c), jmoa.kron(a, c))
    with pytest.raises(ValueError):
        pmoa.hadamard(a, c)
    with pytest.raises(ValueError):
        pmoa.inner_product(a, a)


@pytest.mark.parametrize("m,n,p", [(1, 1, 1), (3, 5, 4), (6, 2, 7)])
def test_onf_and_classical_gemm_equal_the_reference(m, n, p):
    a, b = _arr(m, m * n), _arr(p, n * p)
    for fn in ("onf_gemm", "classical_gemm"):
        got = getattr(pmoa, fn)(a, b, m, n, p)
        want = getattr(jmoa, fn)(a, b, m, n, p)
        assert np.array_equal(got, want)
    np.testing.assert_allclose(pmoa.onf_gemm(a, b, m, n, p),
                               (a.reshape(m, n) @ b.reshape(n, p)).ravel(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m,n,p", [(64, 64, 64), (100, 30, 7), (8, 8, 1)])
@pytest.mark.parametrize("line", [1, 8, 32])
def test_access_traces_and_cacheline_traffic(m, n, p, line):
    for fn in ("moa_access_trace", "classical_access_trace"):
        jt, pt = getattr(jmoa, fn)(m, n, p), getattr(pmoa, fn)(m, n, p)
        assert dataclasses.asdict(jt) == dataclasses.asdict(pt)
        assert jt.contiguous == pt.contiguous
        assert pmoa.cacheline_traffic(pt, m, n, p, line) == \
            jmoa.cacheline_traffic(jt, m, n, p, line)


@pytest.mark.parametrize("total", [1, 12, 97, 4096, 5040])
def test_divisors_pairs(total):
    assert pmoa.divisors_pairs(total) == jmoa.divisors_pairs(total)


# -- onf -----------------------------------------------------------------------

ONF_BUILDERS = [
    ("gemm_classical_onf", (4, 6, 8), {}),
    ("gemm_lifted_rows", (4, 6, 8, 2), {}),
    ("gemm_lifted_cols", (4, 6, 8, 4), {}),
    ("gemm_fully_lifted", (8, 8, 8), dict(procs=2, bk=4, bn=4)),
    ("gemm_fully_lifted", (6, 6, 6), dict(procs=3, bk=8, bn=8)),
    ("expert_gemm_onf", (3, 4, 6, 5), {}),
    ("expert_gemm_fully_lifted", (2, 4, 8, 6), dict(bm=2, bk=4, bn=3)),
    ("hadamard_lifted", (6, 8), dict(bm=3, bn=4)),
]


@pytest.mark.parametrize("name,args,kw", ONF_BUILDERS)
def test_onf_builders_equal_the_reference(name, args, kw):
    j = getattr(jonf, name)(*args, **kw)
    p = getattr(ponf, name)(*args, **kw)
    assert p.render_c() == j.render_c()
    assert p.out.render() == j.out.render()
    assert [a.render() for a in p.ins] == [a.render() for a in j.ins]
    assert p.key() == j.key()
    assert p.innermost_strides() == j.innermost_strides()
    rng = np.random.default_rng(len(name))
    last = {l.index: l.extent - 1 for l in j.loops}
    ins = [rng.standard_normal(1 + acc.offset(last)) for acc in j.ins]
    n_out = 1 + j.out.offset(last)
    got = p.execute(p.init_out(n_out, np.float64), *ins)
    want = j.execute(j.init_out(n_out, np.float64), *ins)
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)


def test_lifted_cols_refuses_a_group_that_does_not_divide():
    with pytest.raises(ValueError):
        ponf.gemm_lifted_cols(4, 6, 8, 3)


# -- lifting -------------------------------------------------------------------

def _lifted(x):
    return ([dataclasses.asdict(a) for a in x.axes], x.grid(),
            x.block_shape(), x.local_shape())


@pytest.mark.parametrize("name", TABLES)
def test_batch_and_model_lifting(name):
    j, p = _tables(name)
    for batch in (32, 64, 256):
        assert _lifted(pl_.batch_lifting(p, batch, ("seq", 16), ("d", 8))) \
            == _lifted(jl.batch_lifting(j, batch, ("seq", 16), ("d", 8)))
    for size in (16, 256):
        assert _lifted(pl_.model_lifting(p, "d_ff", size, ("d", 4))) == \
            _lifted(jl.model_lifting(j, "d_ff", size, ("d", 4)))


def test_h100_lifting_keeps_every_axis_whole():
    got = pl_.batch_lifting(phw.H100, 8, ("d", 4))
    assert got.local_shape() == (8, 4)
    assert pl_.model_lifting(phw.H100, "f", 12).local_shape() == (12,)


# -- energy ----------------------------------------------------------------------

def _blocks(bm, bk, bn):
    args = dict(bm=bm, bk=bk, bn=bn, vmem_bytes=3 * bm * bk * 2,
                arithmetic_intensity=1.5, utilization=1.0)
    return jblk.BlockChoice(**args), pblk.BlockChoice(**args)


GEMMS = [(1024, 1024, 1024, (128, 128, 128)), (4096, 512, 2048, (256, 64, 512)),
         (300, 70, 130, (64, 32, 16)), (8192, 8192, 8192, (96, 96, 96))]


@pytest.mark.parametrize("name", TABLES)
@pytest.mark.parametrize("m,k,n,blk", GEMMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gemm_traffic_and_energy(name, m, k, n, blk, dtype):
    j, p = _tables(name)
    jb, pb = _blocks(*blk)
    for a, b in zip(penergy.gemm_traffic(m, k, n, pb, dtype),
                    jenergy.gemm_traffic(m, k, n, jb, dtype)):
        _close(a, b)
    _close(penergy.gemm_unblocked_traffic(m, k, n, dtype),
           jenergy.gemm_unblocked_traffic(m, k, n, dtype))
    _close(penergy.gemm_unblocked_traffic(m, k, n, dtype, burst_elems=8),
           jenergy.gemm_unblocked_traffic(m, k, n, dtype, burst_elems=8))
    for ici in (0.0, 1e9):
        _same_report(penergy.gemm_energy(m, k, n, pb, dtype, p, ici),
                     jenergy.gemm_energy(m, k, n, jb, dtype, j, ici))


@pytest.mark.parametrize("name", TABLES)
@pytest.mark.parametrize("b,hq,sq,sk,hd,vd,bq,bk", [
    (1, 8, 4096, 4096, 128, 128, 512, 512), (2, 40, 300, 300, 96, 64, 64, 128),
    (4, 16, 1000, 2000, 256, 0, 128, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_traffic_and_energy(name, b, hq, sq, sk, hd, vd, bq, bk,
                                      causal):
    j, p = _tables(name)
    args = dict(bq=bq, bk=bk, vmem_bytes=1, arithmetic_intensity=1.0,
                utilization=1.0)
    jb, pb = jblk.StreamBlockChoice(**args), pblk.StreamBlockChoice(**args)
    for a, c in zip(penergy.attention_traffic(b, hq, sq, sk, hd, vd or hd,
                                              pb, causal=causal),
                    jenergy.attention_traffic(b, hq, sq, sk, hd, vd or hd,
                                              jb, causal=causal)):
        _close(a, c)
    _same_report(
        penergy.attention_energy(b, hq, sq, sk, hd, pb, vd=vd,
                                 causal=causal, hardware=p),
        jenergy.attention_energy(b, hq, sq, sk, hd, jb, vd=vd,
                                 causal=causal, hardware=j))


@pytest.mark.parametrize("name", TABLES)
@pytest.mark.parametrize("b,s,h,p_,n,bs", [(2, 2048, 48, 64, 128, 256),
                                           (1, 300, 4, 16, 32, 16)])
@pytest.mark.parametrize("materialized", [False, True])
def test_scan_traffic_and_energy(name, b, s, h, p_, n, bs, materialized):
    j, p = _tables(name)
    args = dict(bs=bs, vmem_bytes=1, arithmetic_intensity=1.0,
                utilization=1.0)
    jb = jblk.RecurrenceBlockChoice(**args)
    pb = pblk.RecurrenceBlockChoice(**args)
    for a, c in zip(penergy.scan_traffic(b, s, h, p_, n, pb,
                                         materialized=materialized),
                    jenergy.scan_traffic(b, s, h, p_, n, jb,
                                         materialized=materialized)):
        _close(a, c)
    _same_report(penergy.scan_energy(b, s, h, p_, n, pb,
                                     materialized=materialized, hardware=p),
                 jenergy.scan_energy(b, s, h, p_, n, jb,
                                     materialized=materialized, hardware=j))


@pytest.mark.parametrize("name", TABLES)
def test_energy_vs_blocksize(name):
    j, p = _tables(name)
    got = penergy.energy_vs_blocksize(4096, [64, 96, 128, 512], hardware=p)
    want = jenergy.energy_vs_blocksize(4096, [64, 96, 128, 512], hardware=j)
    assert [b for b, _ in got] == [b for b, _ in want]
    for (_, a), (_, c) in zip(got, want):
        _same_report(a, c)


@pytest.mark.parametrize("name", TABLES)
def test_solved_blocks_model_the_same_energy(name):
    """The port's ``solve_blocks`` on each table, fed to both models."""
    j, p = _tables(name)
    for n in (1024, 4096):
        pb = pblk.solve_blocks(n, n, n, "float32", p)
        jb = jblk.solve_blocks(n, n, n, "float32", j)
        assert pb.as_tuple() == jb.as_tuple()
        _same_report(penergy.gemm_energy(n, n, n, pb, "float32", p),
                     jenergy.gemm_energy(n, n, n, jb, "float32", j))


# -- the reference's relations (tests/test_energy.py), through the port --------

def test_energy_tracks_time_across_block_sizes():
    res = dict(penergy.energy_vs_blocksize(8192, [64, 128, 256, 512, 1024],
                                           hardware=phw.TPU_V5E))
    t_min = min(r.time_s for r in res.values())
    e_min = min(r.energy_J for r in res.values())
    best_e = min(res, key=lambda b: res[b].energy_J)
    best_t = min(res, key=lambda b: res[b].time_s)
    assert res[best_e].time_s <= 1.05 * t_min
    assert res[best_t].energy_J <= 1.10 * e_min
    assert res[64].time_s == max(r.time_s for r in res.values())
    assert res[64].energy_J == max(r.energy_J for r in res.values())


def test_power_flat_while_time_varies():
    res = [r for _, r in penergy.energy_vs_blocksize(
        8192, [64, 128, 256, 512, 1024], hardware=phw.TPU_V5E)]
    p = [r.power_W for r in res]
    t = [r.time_s for r in res]
    power_ratio, time_ratio = max(p) / min(p), max(t) / min(t)
    assert power_ratio < 1.6
    assert time_ratio > 2.0
    assert time_ratio > 2 * power_ratio


def test_energy_linear_in_matrix_size_when_bandwidth_bound():
    blocks = lambda n: penergy.energy_vs_blocksize(
        n, [128], hardware=phw.TPU_V5E)[0][1]
    e1, e2 = blocks(4096), blocks(8192)
    assert e1.bound == "memory" and e2.bound == "memory"
    assert 3.0 < e2.energy_J / e1.energy_J < 9.0


def test_blocked_traffic_beats_unblocked():
    n = 4096
    bc = pblk.solve_blocks(n, n, n, "bfloat16", phw.TPU_V5E)
    hbm_blocked, _ = penergy.gemm_traffic(n, n, n, bc)
    assert hbm_blocked < penergy.gemm_unblocked_traffic(n, n, n) / 10


def test_solver_block_is_energy_optimal_among_squares():
    n = 16384
    res = dict(penergy.energy_vs_blocksize(
        n, [64, 128, 256, 512, 1024, 2048], hardware=phw.TPU_V5E))
    bc = pblk.solve_blocks(n, n, n, "bfloat16", phw.TPU_V5E)
    solver_e = penergy.gemm_energy(n, n, n, bc, hardware=phw.TPU_V5E)
    assert solver_e.energy_J <= min(r.energy_J for r in res.values()) * 1.05


# -- the H100 table --------------------------------------------------------------

@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_h100_report_bound_and_static_floor(n, dtype):
    """On the port's table (its default): ``bound`` names the largest of
    the compute, memory and collective times, the time is that term, and
    the energy is at least the static power times the time."""
    h = phw.H100
    bc = pblk.solve_blocks(n, n, n, dtype, h)
    for ici in (0.0, 1e12):
        r = penergy.gemm_energy(n, n, n, bc, dtype, ici_bytes=ici)
        terms = {"compute": r.flops / h.peak_flops,
                 "memory": r.hbm_bytes / h.hbm.bandwidth_Bps,
                 "collective": r.ici_bytes / h.ici_Bps}
        assert r.bound == max(terms, key=terms.get)
        assert r.time_s == terms[r.bound]
        assert r.energy_J >= h.sa_power_W * r.time_s
        assert r.power_W >= h.sa_power_W


# -- cost ------------------------------------------------------------------------

STATS = [{"all-reduce": 10 * 2**20}, {"all-gather": 1000, "all-reduce": 1000,
                                      "collective-permute": 1000,
                                      "reduce-scatter": 7, "all-to-all": 3},
         {}]


@pytest.mark.parametrize("name", TABLES + ["H100"])
@pytest.mark.parametrize("stats", STATS)
@pytest.mark.parametrize("n_chips", [1, 4, 256])
def test_roofline_equals_the_reference(name, stats, n_chips):
    p = getattr(phw, name)
    j = getattr(jl, name) if name != "H100" else jl.HardwareShape(
        **dataclasses.asdict(p) | {"vmem": jl.MemoryLevel(
            **dataclasses.asdict(p.vmem)), "hbm": jl.MemoryLevel(
            **dataclasses.asdict(p.hbm))})
    js = jcost.CollectiveStats(bytes_by_op=dict(stats),
                               count_by_op={k: 1 for k in stats})
    ps = pcost.CollectiveStats(bytes_by_op=dict(stats),
                               count_by_op={k: 1 for k in stats})
    assert ps.total_bytes == js.total_bytes
    assert ps.total_count == js.total_count
    _close(pcost.wire_bytes(ps, n_chips), jcost.wire_bytes(js, n_chips))
    kw = dict(n_chips=n_chips, per_device_flops=1e12,
              per_device_hbm_bytes=1e9, model_flops=2e14)
    pr = pcost.from_quantities("x", collective_stats=ps, hardware=p, **kw)
    jr = jcost.from_quantities("x", collective_stats=js, hardware=j, **kw)
    assert pr.dominant == jr.dominant
    for f in ("compute_s", "memory_s", "collective_s", "step_time_s",
              "step_time_noverlap_s", "useful_flops_ratio",
              "roofline_fraction", "global_flops", "global_hbm_bytes",
              "collective_op_bytes", "collective_wire_bytes"):
        _close(getattr(pr, f), getattr(jr, f))
    jd, pd = jr.to_dict(), pr.to_dict()
    assert pd.pop("peak_flops") == p.peak_flops
    assert pd == jd


def test_roofline_carries_its_own_peak():
    """Two rooflines on two tables keep their own peaks (the reference's
    module-level peak is the last call's)."""
    st = pcost.CollectiveStats()
    kw = dict(n_chips=1, per_device_flops=1e12, per_device_hbm_bytes=1.0,
              collective_stats=st)
    a = pcost.from_quantities("a", hardware=phw.TPU_V5E, **kw)
    b = pcost.from_quantities("b", hardware=phw.H100, **kw)
    _close(a.roofline_fraction, 1e12 / a.step_time_s / phw.TPU_V5E.peak_flops)
    _close(b.roofline_fraction, 1.0)
    assert pcost.from_quantities("c", **kw).peak_flops == phw.H100.peak_flops


@pytest.mark.parametrize("n,d,active,training", [
    (1e9, 1e6, None, True), (1e9, 1e6, 1e8, True), (1e9, 1e6, None, False),
    (16_380_000_000, 4096, 2_800_000_000, False)])
def test_model_flops(n, d, active, training):
    assert pcost.model_flops_lm(n, d, active_params=active,
                                training=training) == \
        jcost.model_flops_lm(n, d, active_params=active, training=training)
