"""The design of K6 and K7 (``src/repro_torch/kernels/csrc/ssd.cu``) on the
CPU, where the CUDA kernels cannot run:

- the split of each f32 operand into bf16 parts that the kernels' tensor-
  core products use (``ops.SSD_SPLIT_PARTS``), emulated in plain PyTorch at
  mamba2-780m's widths (q = 256, n = 128, p = 64), against the exact
  products: two parts hold the card tests' tolerance with a 4x margin, one
  part misses it;
- the chunk-parallel decomposition the kernels run (per-chunk work in
  parallel, one pass over the chunks for the states and one reverse pass
  for their cotangents, dB / dC / dG summed per head group), written here
  as a plain function, against the port's plain ``ref.ssd_scan`` /
  ``ref.ssd_bwd`` and the JAX ``repro.kernels.ops.scan_ssd`` and its VJP
  in interpret mode;
- the head groups (``ops.ssd_head_groups``): every head once, in order.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

#: K6/K7 against their plain versions on the card, relative to the largest
#: plain entry of each output (``SSD_REL`` of tests/test_torch_kernels.py)
SSD_REL = 1e-4
#: the margin the chosen split must keep below that tolerance
MARGIN = 4
#: the decomposition (float64) against the f32 plain versions and the JAX
#: kernel: summation order only, relative to the largest entry
TOL = 1e-5


# ---------------------------------------------------------------------------
# (a) the split products
# ---------------------------------------------------------------------------

def _parts(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """``x`` (f32) as ``parts`` bf16 values, each the rounding of what the
    earlier ones leave (the kernel's ``split2``), returned as f32."""
    out, rest = [], x
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out.append(part)
        rest = rest - part
    return out


def _split_product(a: torch.Tensor, b: torch.Tensor,
                   parts: int) -> torch.Tensor:
    """``a @ b`` as the kernels compute it: products of bf16 parts (exact
    in f32) whose part indices sum to less than ``parts``, accumulated in
    f32 -- with two parts lo.hi + hi.lo + hi.hi, three products."""
    pa, pb = _parts(a, parts), _parts(b, parts)
    out = torch.zeros(a.shape[0], b.shape[1])
    for i, x in enumerate(pa):
        for j, y in enumerate(pb):
            if i + j < parts:
                out = out + x @ y
    return out


def _model_products():
    """The products of one chunk and head at mamba2-780m's widths, from
    the reference tests' inputs (unit normals, a log decay of
    -0.3|N(0, 1)|, a 0.1-normal state): name -> (a, b) f32."""
    rng = np.random.default_rng(0)
    q, n, p = 256, 128, 64
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.standard_normal(s)).astype(np.float32))
    C, B, X, dY = f(q, n), f(q, n), f(q, p), f(q, p)
    h = f(p, n, sc=0.1)
    dA = -0.3 * f(q).abs()
    csh = torch.cumsum(dA, 0)
    tril = torch.ones(q, q, dtype=torch.bool).tril()
    L = torch.exp(torch.where(tril, csh[:, None] - csh[None, :],
                              float("-inf")))
    G = (C.double() @ B.double().T).float()
    P = G * L
    dec = torch.exp(csh[-1] - csh)
    dG = (dY.double() @ X.double().T).float() * L
    return {"scores C.B'": (C, B.T.contiguous()),
            "P.X": (P, X),
            "state B'.(dec X)": ((X * dec[:, None]).T.contiguous(), B),
            "readout C.h'": (C, h.T.contiguous()),
            "dP = dY.X'": (dY, X.T.contiguous()),
            "P'.dY": (P.T.contiguous(), dY),
            "dG.B": (dG, B)}


@pytest.mark.parametrize("name", list(_model_products()))
def test_split_holds_the_tolerance_with_margin(name):
    """Two bf16 parts a operand (three tensor-core products) stay below
    SSD_REL / MARGIN at mamba2's widths; one part (a plain bf16 product)
    misses SSD_REL itself, so two is the fewest."""
    a, b = _model_products()[name]
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()
    errs = {k: (_split_product(a, b, k).double() - exact).abs().max().item()
            / scale for k in (1, 2)}
    assert ops.SSD_SPLIT_PARTS == 2
    assert errs[2] * MARGIN <= SSD_REL, errs
    assert errs[1] > SSD_REL, errs


def test_split_parts_rebuild_the_operand():
    """hi + lo of the two-part split holds each f32 value to 2^-16 of its
    magnitude (the kernel's split2)."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32)) * 1e3
    hi, lo = _parts(x, 2)
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -16).all()


# ---------------------------------------------------------------------------
# (b) the chunk-parallel decomposition
# ---------------------------------------------------------------------------

def _chunked(t: torch.Tensor, q: int) -> torch.Tensor:
    """``(b, S, ...)`` -> ``(b, S // q, q, ...)``."""
    return t.reshape(t.shape[0], t.shape[1] // q, q, *t.shape[2:])


def _decays(dA: torch.Tensor, q: int):
    """Per chunk, in parallel: ``csh (b, nc, q, h)``, ``total (b, nc,
    h)``, ``ind``, ``dec`` and ``L (b, nc, h, i, j)`` (0 off the causal
    triangle)."""
    csh = torch.cumsum(_chunked(dA, q), dim=2)
    total = csh[:, :, -1]
    ind = torch.exp(csh)
    dec = torch.exp(total[:, :, None] - csh)
    seg = csh.permute(0, 1, 3, 2)
    seg = seg[..., :, None] - seg[..., None, :]
    tril = torch.ones(q, q, dtype=torch.bool).tril()
    L = torch.exp(torch.where(tril, seg, float("-inf")))
    return csh, total, ind, dec, L


def decomposed_scan(xdt, dA, B, C, h0, q):
    """The forward as K6 runs it, on a sequence padded to a multiple of
    ``q``: the scores once per chunk and each chunk's diagonal output and
    state contribution in parallel, one pass over the chunks for the
    entering states, then each chunk's readout in parallel.  Returns ``(y,
    final, h_in)``."""
    b, s, h, p = xdt.shape
    x, Bc, Cc = _chunked(xdt, q), _chunked(B, q), _chunked(C, q)
    _, total, ind, dec, L = _decays(dA, q)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)              # once a chunk
    y = torch.einsum("bchij,bcjhp->bcihp", G[:, :, None] * L, x)
    contrib = torch.einsum("bcjn,bcjhp->bchpn", Bc, x * dec[..., None])
    states, hc = [], h0
    for c in range(s // q):                                  # the one pass
        states.append(hc)
        hc = torch.exp(total[:, c])[..., None, None] * hc + contrib[:, c]
    h_in = torch.stack(states, dim=1)
    y = y + torch.einsum("bcin,bchpn->bcihp", Cc, h_in) * ind[..., None]
    return y.reshape(b, s, h, p), hc, h_in


def _group_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over heads (axis ``dim``) as K7 takes it: each of
    ``ops.ssd_head_groups`` in head order, then the groups in order."""
    total = 0
    for first, count in ops.ssd_head_groups(t.shape[dim]):
        part = 0
        for hh in range(first, first + count):
            part = part + t.select(dim, hh)
        total = total + part
    return total


def decomposed_bwd(C, B, dY, X, dA, Hin, dHf):
    """The reverse scan as K7 runs it, in forward order: each chunk's share
    C' (ind dY) in parallel, one reverse pass over the chunks for the
    cotangent of each chunk's exit state and dh0, then every cotangent per
    chunk in parallel from the saved ``Hin``, dB / dC / dG summed per head
    group.  Returns ``(dX, dh0, dB, dC, ddA)``."""
    b, s, h, p = X.shape
    nc = Hin.shape[1]
    q = s // nc
    Cc, Bc, dYc, Xc = (_chunked(C, q), _chunked(B, q), _chunked(dY, q),
                       _chunked(X, q))
    _, total, ind, dec, L = _decays(dA, q)
    dti = dYc * ind[..., None]
    share = torch.einsum("bcin,bcihp->bchpn", Cc, dti)
    exits, dh = [None] * nc, dHf
    for c in reversed(range(nc)):                            # the one pass
        exits[c] = dh
        dh = torch.exp(total[:, c])[..., None, None] * dh + share[:, c]
    dhx = torch.stack(exits, dim=1)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    P = G[:, :, None] * L
    t_off = torch.einsum("bcin,bchpn->bcihp", Cc, Hin)
    din = (dYc * t_off).sum(-1)
    dXd = torch.einsum("bcjn,bchpn->bcjhp", Bc, dhx)
    ddec = (dXd * Xc).sum(-1)
    dX = dXd * dec[..., None] + torch.einsum("bchij,bcihp->bcjhp", P, dYc)
    dP = torch.einsum("bcihp,bcjhp->bchij", dYc, Xc)
    dG = _group_sum(dP * L, 2)
    tril = torch.ones(q, q, dtype=torch.bool).tril()
    dseg = torch.where(tril, dP * G[:, :, None] * L, 0.0)
    dB = _group_sum(torch.einsum("bchpn,bcjhp->bcjhn", dhx,
                                 Xc * dec[..., None]), 3) + \
        torch.einsum("bcij,bcin->bcjn", dG, Cc)
    dC = _group_sum(torch.einsum("bcihp,bchpn->bcihn", dti, Hin), 3) + \
        torch.einsum("bcij,bcjn->bcin", dG, Bc)
    dtotal = torch.exp(total) * (dhx * Hin).sum((-2, -1)) + \
        (ddec * dec).sum(2)
    dcsh = -ddec * dec + din * ind + dseg.sum(-1).transpose(2, 3) \
        - dseg.sum(-2).transpose(2, 3)
    dcsh[:, :, -1] += dtotal
    ddA = torch.flip(torch.cumsum(torch.flip(dcsh, (2,)), 2), (2,))
    return (dX.reshape(b, s, h, p), dh, dB.reshape(b, s, -1),
            dC.reshape(b, s, -1), ddA.reshape(b, s, h))


def _inputs(rng, b, s, h, p, n):
    """The reference tests' SSD inputs (normals, a log decay of
    -0.3|N(0, 1)|, a 0.1-normal entering state) and the cotangents of y
    and the final state, f32 numpy."""
    f = lambda *shape, sc=1.0: (sc * rng.standard_normal(shape)).astype(
        np.float32)
    return (f(b, s, h, p), -np.abs(f(b, s, h, sc=0.3)), f(b, s, n),
            f(b, s, n), f(b, h, p, n, sc=0.1), f(b, s, h, p), f(b, h, p, n))


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


#: (S, q): three whole chunks, a padded tail, one chunk, seven chunks of a
#: ragged q with a padded tail; h = 20 heads make two head groups (10, 10)
DECOMP = [(24, 8), (21, 8), (16, 16), (40, 6)]


@pytest.mark.parametrize("s,q", DECOMP)
def test_decomposed_scan_matches_plain_and_jax(s, q):
    b, h, p, n = 2, 20, 4, 6
    xdt, dA, B, C, h0, _, _ = _inputs(np.random.default_rng(s + q), b, s, h,
                                      p, n)
    pad = (-s) % q
    t32 = [ops._pad_seq(torch.from_numpy(a), pad) for a in (xdt, dA, B, C)]
    y, final, h_in = decomposed_scan(*[t.double() for t in t32],
                                     torch.from_numpy(h0).double(), q)
    yr, fr, hr = ref.ssd_scan(*t32, torch.from_numpy(h0), q, True)
    yj, fj = jops.scan_ssd(*map(jnp.asarray, (xdt, dA, B, C)),
                           init_state=jnp.asarray(h0), chunk=q,
                           interpret=True)
    assert h_in.shape == (b, (s + pad) // q, h, p, n)
    assert torch.equal(h_in[:, 0], torch.from_numpy(h0).double())
    for got, want in ((y, yr), (final, fr), (h_in, hr)):
        _close(got, want)
    _close(y[:, :s], yj)
    _close(final, fj)


@pytest.mark.parametrize("s,q", DECOMP)
def test_decomposed_bwd_matches_plain_and_jax(s, q):
    """Seeded with a non-zero final-state cotangent from a non-zero entering
    state; against ``ref.ssd_bwd`` on the same padded operands and against
    ``jax.grad`` through the reference's derived VJP (unpadded)."""
    b, h, p, n = 2, 20, 4, 6
    xdt, dA, B, C, h0, gy, gf = _inputs(np.random.default_rng(7 * s + q), b,
                                        s, h, p, n)
    pad = (-s) % q
    t32 = [ops._pad_seq(torch.from_numpy(a), pad)
           for a in (xdt, dA, B, C, gy)]
    x, a, Bt, Ct, dy = t32
    _, _, h_in = ref.ssd_scan(x, a, Bt, Ct, torch.from_numpy(h0), q, True)
    got = decomposed_bwd(Ct.double(), Bt.double(), dy.double(), x.double(),
                         a.double(), h_in.double(),
                         torch.from_numpy(gf).double())
    want = ref.ssd_bwd(Ct, Bt, dy, x, a, h_in, torch.from_numpy(gf))

    def jloss(x_, a_, b_, c_, h_):
        y, f = jops.scan_ssd(x_, a_, b_, c_, init_state=h_, chunk=q,
                             interpret=True)
        return jnp.sum(y * gy) + jnp.sum(f * gf)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (xdt, dA, B, C, h0)))
    names = ("dX", "dh0", "dB", "dC", "ddA")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        _close(g, w)
    # the JAX VJP's (xdt, dA, B, C, h0) order; the padded tail sliced off
    for name, g, w in zip(("dX", "ddA", "dB", "dC", "dh0"),
                          (got[0], got[4], got[2], got[3], got[1]),
                          jgrads):
        _close(g if name == "dh0" else g[:, :s], w)


def test_decomposed_bwd_sums_heads_by_group():
    """dB's per-head terms summed per group then over groups (three groups
    of 12, 11, 11 at h = 34) equal the plain sum over all heads (f32) to
    summation order, and the decomposition at h = 1 (one group of one head)
    matches too."""
    assert len(ops.ssd_head_groups(34)) == 3
    for h in (34, 1):
        b, s, q, p, n = 1, 12, 4, 4, 3
        xdt, dA, B, C, h0, gy, gf = _inputs(np.random.default_rng(h), b, s,
                                            h, p, n)
        t = [torch.from_numpy(a).double() for a in (xdt, dA, B, C, h0, gy,
                                                    gf)]
        _, _, h_in = decomposed_scan(*t[:5], q)
        got = decomposed_bwd(t[3], t[2], t[5], t[0], t[1], h_in, t[6])
        want = ref.ssd_bwd(t[3], t[2], t[5], t[0], t[1], h_in, t[6])
        for g, w in zip(got, want):
            _close(g, w)


# ---------------------------------------------------------------------------
# (c) the head groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h", range(1, 65))
def test_head_groups_cover_every_head_once_in_order(h):
    groups = ops.ssd_head_groups(h)
    heads = [hh for first, count in groups for hh in
             range(first, first + count)]
    assert heads == list(range(h))
    sizes = [count for _, count in groups]
    assert min(sizes) >= 1 and max(sizes) <= ops.SSD_GROUP_HEADS
    assert max(sizes) - min(sizes) <= 1
    assert len(groups) == -(-h // ops.SSD_GROUP_HEADS)
