"""The recurrent derivation of the port (``core.expr``'s ``RecurrentForm``
families, ``core.schedule``'s recurrent schedules, ``core.blocking``'s
stream and square solvers, ``kernels.ops``' derived SSD and gated-scan
chunks, int32 accumulation) against the JAX package on the CPU.  The
port's ``TPU_V5E`` copy is held against the reference's v5e-shaped
``cpu`` entry; the ``H100`` table's own derivations are pinned.  Inputs
are drawn with numpy from seeds."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import blocking as jblocking  # noqa: E402
from repro.core import expr as JE  # noqa: E402
from repro.core import hardware as jhw  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import blocking, schedule  # noqa: E402
from repro_torch.core import expr as PE  # noqa: E402
from repro_torch.hardware import H100, TPU_V5E  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

JHW = jhw.get_entry("cpu")          # the reference's v5e-shaped entry
#: f32 on both sides, differing in summation order (tests/test_torch_ssm.py
#: and tests/test_torch_hybrid.py hold the same functions so)
TOL = 1e-5
GATED_TOL = 1e-5
#: the H100 table's fast-memory capacity (one block's shared memory)
H100_SMEM = 232_448


def _forms(E, sizes: str):
    """(label, form) for each of the eleven recurrent forms, at
    ``verify_all``'s sizes or at the reduced configs' (gemma-2b's
    attention: 4 query heads on 1 KV head of 32; mamba2-780m's SSD: 8
    heads of 16, state 16, chunk 8; recurrentgemma-9b's lru width 128)."""
    if sizes == "verify_all":
        att, ssd, w = (1, 2, 2, 300, 300, 64), (1, 4, 64, 2, 16, 16), 32
        dec = dict(hkv=2, g=4, hd=64)
    else:
        att, ssd, w = (2, 1, 4, 13, 13, 32), (2, 3, 8, 8, 16, 16), 128
        dec = dict(hkv=1, g=4, hd=32)
    yield "attention", E.attention_form(*att)
    yield "attention_stats", E.attention_stats_form(*att)
    yield "attention_windowed", E.attention_form(*att, window=8)
    yield "attention_prefix", E.attention_form(*att, prefix_len=5)
    yield "flash_dq", E.attention_dq_form(*att)
    yield "flash_dkv", E.attention_dkv_form(*att, window=8)
    yield "ssd", E.ssd_form(*ssd)
    yield "ssd_chk", E.ssd_chk_form(*ssd)
    yield "ssd_bwd", E.ssd_bwd_form(*ssd)
    yield "rglru", E.rglru_form(1, 4, 64, w)
    yield "rglru_bwd", E.rglru_bwd_form(2, 3, 16, w)
    yield "windowed_decode", E.windowed_decode_form(
        dec["hkv"], dec["g"], dec["hd"], page=16, view_pages=4,
        pool_pages=6, page_table=(0, 3, 1, 5), window=32)
    yield "windowed_decode_pow2", E.windowed_decode_form(
        dec["hkv"], dec["g"], dec["hd"], page=256, view_pages=2,
        pool_pages=3, page_table=(2, 0))
    yield "batched_decode", E.batched_decode_form(
        3, dec["hkv"], dec["g"], dec["hd"], page=16, view_pages=4,
        pool_pages=8, page_tables=((0, 3, 1, 5), (2, 4, 6, 7), (1, 0, 3, 2)),
        window=32)


CASES = [(sizes, label) for sizes in ("verify_all", "reduced")
         for label, _ in _forms(PE, sizes)]
#: batched decode derives only with the engine's pinned (group, page)
BLOCKS = {"batched_decode": (4, 16)}


def _plain(x):
    """A dataclass tree as nested (class name, (field, value)...) tuples,
    so the port's and the reference's classes compare field for field; a
    state monoid by its key."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        if type(x).__name__ == "StateSpec":
            return ("StateSpec",) + x.key()
        return (type(x).__name__,) + tuple(
            (f.name, _plain(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    return x


def _form(E, sizes, label):
    return dict(_forms(E, sizes))[label]


def _derive(E, sched, hardware, sizes, label, dtype="float32"):
    """The bundle of one form, or the error a refused derivation raises
    (type and message)."""
    try:
        return sched.get_schedule(_form(E, sizes, label), dtype=dtype,
                                  hardware=hardware,
                                  blocks=BLOCKS.get(label))
    except (ValueError, AssertionError) as exc:
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("sizes,label", CASES)
def test_recurrent_form_keys_and_schedules_match_reference(sizes, label):
    """Each recurrent form's ``key()`` (its stages, stream axis, state
    monoid, aux leaves, masking and page-table metadata) equals the
    reference's, and ``get_schedule`` on the v5e copy gives the same
    bundle field for field: grid, operand specs (page tables included),
    intermediates, exported states, stage plans, blocks and shapes, or
    the same refusal."""
    port, want = _form(PE, sizes, label), _form(JE, sizes, label)
    assert port.key() == want.key()
    assert _plain(port.state) == _plain(want.state)
    for dtype in ("float32", "bfloat16"):
        got = _derive(PE, schedule, TPU_V5E, sizes, label, dtype)
        ref = _derive(JE, jsched, JHW, sizes, label, dtype)
        assert _plain(got) == _plain(ref), (label, dtype)


@pytest.mark.parametrize("sizes,label", CASES)
def test_recurrent_schedules_on_the_h100_table(sizes, label):
    """On the H100 table every form derives within 227 KB of shared
    memory, its folding blocks aligned to the tensor-core fragment's 16,
    or is refused exactly where the solved stream block is not the page
    (a paged view the table could not drive)."""
    got = _derive(PE, schedule, H100, sizes, label)
    if isinstance(got, tuple):
        assert label.startswith("windowed_decode"), got
        assert "must not pad" in got[1] or "page table has" in got[1], got
        return
    assert got.schedule.working_set_bytes("float32") <= H100_SMEM
    if isinstance(got.blocks, blocking.StreamBlockChoice) and \
            label not in BLOCKS:
        assert got.blocks.bq % 16 == 0 and got.blocks.bk % 16 == 0


def test_recurrent_schedule_shares_the_cache():
    """Recurrent bundles are cached on the same LRU as the contractions,
    keyed on the composite key: a second derivation is a hit."""
    schedule.reset_schedule_cache()
    form = PE.ssd_form(1, 4, 64, 2, 16, 16)
    first = schedule.get_schedule(form, dtype="float32", hardware=H100)
    again = schedule.get_schedule(form, dtype="float32", hardware=H100)
    assert again is first
    assert schedule.schedule_cache_stats()["hits"] == 1
    with pytest.raises(ValueError, match="floating accumulator"):
        schedule.get_schedule(form, dtype="int8", hardware=H100,
                              acc_dtype="int32")


def test_streaming_form_alias_warns_and_welds():
    scores = PE.attention_form(1, 1, 1, 64, 64, 32).stages
    with pytest.warns(DeprecationWarning):
        rf = PE.StreamingForm("s", scores[0], scores[1], "j")
    assert rf.folding and rf.state is PE.SOFTMAX_STATE


STREAM_SHAPES = [(512, 512, 128, None), (4096, 4096, 64, None),
                 (300, 300, 64, 32), (13, 13, 32, None), (2048, 1, 256, 512),
                 (64, 8192, 96, 64)]


@pytest.mark.parametrize("sq,sk,hd,vd", STREAM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_solver_matches_reference(sq, sk, hd, vd, dtype):
    """``solve_stream_blocks`` (forward and backward models) equals the
    reference's on the v5e copy; on the H100 table each choice fits 227
    KB and is 16-aligned, or is refused where no 16 x 16 block fits."""
    for kw in ({}, dict(q_extra=hd, k_extra=hd + 3, n_inter=4,
                        n_row_state=4)):
        got = blocking.solve_stream_blocks(sq, sk, hd, vd, dtype,
                                           hardware=TPU_V5E, **kw)
        want = jblocking.solve_stream_blocks(sq, sk, hd, vd, dtype,
                                             hardware=JHW.shape, **kw)
        assert _plain(got)[1:] == _plain(want)[1:]
        try:
            h = blocking.solve_stream_blocks(sq, sk, hd, vd, dtype,
                                             hardware=H100, **kw)
        except AssertionError:
            # refused only where even the smallest aligned block is over
            # half of 227 KB (the solver's budget)
            assert blocking.stream_working_set(
                16, 16, hd, vd or hd, blocking.dtype_size(dtype), 4,
                **kw) > H100_SMEM // 2
            continue
        assert h.vmem_bytes <= H100_SMEM
        assert h.bq % 16 == 0 and h.bk % 16 == 0
        assert blocking.stream_working_set(
            h.bq, h.bk, hd, vd or hd, blocking.dtype_size(dtype), 4,
            **kw) == h.vmem_bytes


@pytest.mark.parametrize("dtype,n_arrays,buffering",
                         [("float64", 3, 1), ("float32", 3, 2),
                          ("bfloat16", 2, 2), ("int8", 3, 1)])
def test_square_solver_matches_reference(dtype, n_arrays, buffering):
    """``solve_blocks_square`` equals the reference's on the v5e copy and
    on the reference's V100 and A100 tables rebuilt in the port's schema;
    on the H100 table the square fits 227 KB and is 32-aligned (a warp)."""
    from repro.core.lifting import GPU_A100, V100
    from repro_torch.hardware import HardwareShape, MemoryLevel

    def port_table(t):
        return HardwareShape(
            t.name, t.mesh_axes, MemoryLevel(*dataclasses.astuple(t.vmem)),
            MemoryLevel(*dataclasses.astuple(t.hbm)), t.ici_Bps,
            t.ici_energy_pJ_per_byte, t.peak_flops, t.flop_energy_pJ,
            t.mxu_tile, t.vreg_tile, t.sa_power_W, t.acc_dtypes)

    for jtable, table in ((JHW.shape, TPU_V5E), (V100, port_table(V100)),
                          (GPU_A100, port_table(GPU_A100))):
        assert blocking.solve_blocks_square(table, dtype, n_arrays,
                                            buffering) == \
            jblocking.solve_blocks_square(jtable, dtype, n_arrays, buffering)
    b = blocking.solve_blocks_square(H100, dtype, n_arrays, buffering)
    assert b % 32 == 0
    assert n_arrays * b * b * blocking.dtype_size(dtype) * buffering \
        <= H100_SMEM


SSD_GRID = [(s, h, p, n) for s in (1, 100, 2048, 4096)
            for h, p, n in ((1, 4, 2), (8, 16, 16), (24, 64, 128),
                            (48, 64, 128), (4, 32, 64))]
GATED_GRID = [(s, w) for s in (1, 5, 300, 4096) for w in (8, 128, 2560,
                                                          4096)]


@pytest.mark.parametrize("s,h,p,n", SSD_GRID)
def test_derived_ssd_chunk_matches_reference(s, h, p, n):
    """``default_ssd_chunk`` is the reference's formula: equal on the v5e
    copy; on the H100 table a multiple of 16 whose working set fits a
    quarter of 227 KB, or 16 where no chunk fits (the carried state
    alone is over the budget)."""
    assert ops.default_ssd_chunk(s, h, p, n, hardware=TPU_V5E) == \
        jops.default_ssd_chunk(s, h, p, n, hardware=JHW)
    q = ops.default_ssd_chunk(s, h, p, n)
    assert q % 16 == 0 and q <= 1024
    state = 2 * h * p * n * 4
    if state > H100_SMEM // 4:
        assert q == 16


@pytest.mark.parametrize("s,w", GATED_GRID)
def test_derived_gated_chunk_matches_reference(s, w):
    assert ops.default_gated_chunk(s, w, hardware=TPU_V5E) == \
        jops.default_gated_chunk(s, w, hardware=JHW)
    q = ops.default_gated_chunk(s, w)
    assert q % 16 == 0 and q <= ops.GATED_MAX_CHUNK


def test_derived_chunks_at_the_model_widths():
    """mamba2-780m (S 2048, 48 heads of 64, state 128) and recurrentgemma-9b
    (lru width 4096, S 4096) derive 16 on the H100 table (the smallest
    aligned chunk: the carried state is 3 MB against 58,112 B), 128 on the
    v5e copy, as the reference does on its v5e table."""
    assert ops.default_ssd_chunk(2048, 48, 64, 128) == 16
    assert ops.default_gated_chunk(4096, 4096) == 16
    assert ops.default_ssd_chunk(2048, 48, 64, 128, hardware=TPU_V5E) == \
        jops.default_ssd_chunk(2048, 48, 64, 128, hardware=JHW) == 128
    assert ops.default_gated_chunk(4096, 4096, hardware=TPU_V5E) == \
        jops.default_gated_chunk(4096, 4096, hardware=JHW) == 128


def _np(t):
    return np.asarray(t)


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("s", [5, 40])
def test_scan_ssd_derives_its_chunk(s):
    """``scan_ssd(chunk=None)`` on both sides (the port derives 16 on the
    H100 table, the reference 8.. on its own entry): the same function,
    within the SSD tests' tolerance, and its gradients through K7's plain
    version against the reference's derived VJP."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 4, 5
    ins = [rng.standard_normal((b, s, h, p)),
           -0.3 * np.abs(rng.standard_normal((b, s, h))),
           rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n)),
           0.1 * rng.standard_normal((b, h, p, n))]
    ins = [np.asarray(a, np.float32) for a in ins]
    yj, fj = jops.scan_ssd(*map(jnp.asarray, ins[:4]),
                           init_state=jnp.asarray(ins[4]), interpret=True)
    tin = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, f = ops.scan_ssd(*tin[:4], init_state=tin[4])
    _close(y.detach(), yj, TOL)
    _close(f.detach(), fj, TOL)
    gy = rng.standard_normal(y.shape).astype(np.float32)
    gf = rng.standard_normal(f.shape).astype(np.float32)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                              + (f * torch.from_numpy(gf)).sum(), tin)

    def jloss(*a):
        yy, ff = jops.scan_ssd(*a[:4], init_state=a[4], interpret=True)
        return (yy * gy).sum() + (ff * gf).sum()

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, ins))
    for g, w in zip(got, want):
        _close(g, w, TOL)


@pytest.fixture(scope="module")
def mamba0():
    """Reduced mamba2-780m with ``ssm_chunk = 0`` (the derived chunk) on
    both sides, the reference's parameters carried across."""
    cfg = get_config("mamba2-780m", reduced=True).with_(ssm_chunk=0)
    params, _ = registry.init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu",
                           trainable=True)
    tcfg = port_config("mamba2-780m", reduced=True).with_(ssm_chunk=0)
    return cfg, params, tcfg, tp


def test_mamba2_with_derived_chunk_forward_loss_and_grads(mamba0):
    """The reduced mamba2 model at ``ssm_chunk = 0``: the port's forward
    logits, loss and every gradient against the reference's (the port
    derives on the H100 table, the reference on its own entry; the chunk
    changes no value but in summation order)."""
    cfg, params, tcfg, tp = mamba0
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24))
    jl = jt.forward(params, cfg, jnp.asarray(tokens))
    jl = jl[0] if isinstance(jl, tuple) else jl
    with torch.no_grad():
        tl = tt.forward(tp, tcfg, torch.from_numpy(tokens))
    tl = tl[0] if isinstance(tl, tuple) else tl
    _close(tl, jl, TOL)
    batch = {"tokens": tokens.astype(np.int32),
             "targets": np.roll(tokens, -1, 1).astype(np.int32),
             "mask": np.ones(tokens.shape, np.float32)}
    loss_fn = lambda p, b: registry.loss(p, cfg, b)
    (jloss, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, jax.tree.map(jnp.asarray, batch))
    loss, _, grads = ts.loss_and_grads(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, name)
            else:
                flat[name] = np.asarray(v)

    walk(jgrads)
    assert grads.keys() == flat.keys()
    for k, g in grads.items():
        _close(g, flat[k], TOL)


@pytest.mark.parametrize("s,w", [(37, 70), (300, 24)])
def test_gated_scan_derives_its_chunk(s, w):
    """``gated_scan(chunk=None)`` on both sides (the port's derived chunk
    on the H100 table, the reference's on its own entry, interpret mode),
    with an entering state, within the hybrid tests' tolerance; its
    gradients through the reverse walk against the reference's VJP."""
    rng = np.random.default_rng(w)
    la = (-0.5 * np.abs(rng.standard_normal((2, s, w)))).astype(np.float32)
    bb = rng.standard_normal((2, s, w)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((2, w))).astype(np.float32)
    hj, fj = jops.gated_scan(jnp.asarray(la), jnp.asarray(bb),
                             init_state=jnp.asarray(h0), interpret=True)
    tin = [torch.from_numpy(a).requires_grad_() for a in (la, bb, h0)]
    h, f = ops.gated_scan(tin[0], tin[1], init_state=tin[2])
    _close(h.detach(), hj, GATED_TOL)
    _close(f.detach(), fj, GATED_TOL)
    gy = rng.standard_normal(h.shape).astype(np.float32)
    got = torch.autograd.grad((h * torch.from_numpy(gy)).sum(), tin)

    def jloss(a, b, c):
        hh, _ = jops.gated_scan(a, b, init_state=c, interpret=True)
        return (hh * gy).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(la), jnp.asarray(bb), jnp.asarray(h0))
    for g, wnt in zip(got, want):
        _close(g, wnt, GATED_TOL)


INT_SHAPES = [(37, 53, 29), (130, 200, 129), (1, 300, 7), (64, 1, 64)]


@pytest.mark.parametrize("m,k,n", INT_SHAPES)
@pytest.mark.parametrize("tb", [False, True])
def test_int32_accumulation_matches_reference_bit_for_bit(m, k, n, tb):
    """``apply`` with int8 operands and ``acc_dtype="int32"`` (K1's int8
    form's plain version: exact int64 sums checked into int32) equals the
    reference's interpret-mode kernel bit for bit, at shapes off every
    tile multiple; the reference pads with zeros, the port masks."""
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (n, k) if tb else (k, n)).astype(np.int8)
    expr_p = PE.matmul_expr(m, k, n, transpose_b=tb)
    expr_j = JE.matmul_expr(m, k, n, transpose_b=tb)
    want = jops.apply(expr_j, jnp.asarray(a), jnp.asarray(b),
                      acc_dtype="int32", out_dtype=jnp.int32, interpret=True)
    got = ops.apply(expr_p, torch.from_numpy(a), torch.from_numpy(b),
                    acc_dtype="int32", out_dtype=torch.int32, verify=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int32_accumulation_is_exact_past_f32_integers():
    """All -128 over k = 2048: each sum is 2^25, past f32's exact integers;
    the int32 accumulation holds it exactly, and an int32 overflow raises
    on the plain version (its sums are checked)."""
    a = torch.full((3, 2048), -128, dtype=torch.int8)
    b = torch.full((2048, 5), -128, dtype=torch.int8)
    got = ops.apply(PE.matmul_expr(3, 2048, 5), a, b, acc_dtype="int32",
                    out_dtype=torch.int32)
    assert torch.equal(got, torch.full((3, 5), 2 ** 25, dtype=torch.int32))
    big = torch.full((1, 2 ** 17 + 8), -128, dtype=torch.int8)
    with pytest.raises(OverflowError):
        ops.apply(PE.matmul_expr(1, 2 ** 17 + 8, 1), big, big.t().clone(),
                  acc_dtype="int32", out_dtype=torch.int32)


@pytest.mark.parametrize("verify", [False, True, "kernel"])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_int8_operands_refuse_other_accumulators(acc, verify):
    """int8 operands accumulate in int32 only: under another accumulator
    ``apply`` raises, verified or not, before any product (an f32 sum
    rounds past 2^24; the H100 table has no bf16 accumulator)."""
    a = torch.full((3, 2048), -128, dtype=torch.int8)
    b = torch.full((2048, 5), -128, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        ops.apply(PE.matmul_expr(3, 2048, 5), a, b, acc_dtype=acc,
                  verify=verify)


def test_int32_expert_form_and_refused_forms():
    """The expert form's int32 accumulation equals the reference's; so do
    the head form's, bit for bit: both layouts at k = 32 on K1's int8
    decode rows (``("K1", False, tb, "head")``), and at k = 40 (no
    multiple of 32: refused by K1) on K9's integer accumulator; bf16
    accumulation raises the reference's own table error on the H100."""
    rng = np.random.default_rng(9)
    x = rng.integers(-128, 128, (3, 20, 33)).astype(np.int8)
    w = rng.integers(-128, 128, (3, 33, 17)).astype(np.int8)
    want = jops.apply(JE.expert_gemm_expr(3, 20, 33, 17), jnp.asarray(x),
                      jnp.asarray(w), acc_dtype="int32", out_dtype=jnp.int32,
                      interpret=True)
    got = ops.apply(PE.expert_gemm_expr(3, 20, 33, 17), torch.from_numpy(x),
                    torch.from_numpy(w), acc_dtype="int32",
                    out_dtype=torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for tb, k in ((False, 32), (True, 32), (False, 40)):
        hx = rng.integers(-128, 128, (4, 2, k)).astype(np.int8)
        hw_ = rng.integers(-128, 128, (16, 2, k) if tb else (k, 2, 16)
                           ).astype(np.int8)
        want = jops.apply(JE.head_gemm_expr(2, 4, k, 16, transpose_b=tb),
                          jnp.asarray(hx), jnp.asarray(hw_),
                          acc_dtype="int32", out_dtype=jnp.int32,
                          interpret=True)
        expr = PE.head_gemm_expr(2, 4, k, 16, transpose_b=tb)
        nf = PE.normal_form(expr)
        plan = ops._plan(nf, ("int8", "int8"), torch.int32, H100, None,
                         "int32")
        if k % 32:
            assert plan[0] == "K9"
        else:
            assert plan == ("K1", False, tb, "head")
        got = ops.apply(expr, torch.from_numpy(hx), torch.from_numpy(hw_),
                        acc_dtype="int32", out_dtype=torch.int32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    a = torch.zeros(4, 6)
    expr = PE.matmul_expr(4, 6, 5)
    with pytest.raises(ValueError) as port_err:
        ops.apply(expr, a.bfloat16(), torch.zeros(6, 5).bfloat16(),
                  acc_dtype="bfloat16")
    from repro.core.lifting import V100
    with pytest.raises(ValueError) as ref_err:
        jblocking.solve_blocks(4, 6, 5, "bfloat16", hardware=V100,
                               acc_dtype="bfloat16")
    msg = "has no 'bfloat16' accumulation path"
    assert msg in str(port_err.value) and msg in str(ref_err.value)
