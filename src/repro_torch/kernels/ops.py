"""Model-facing kernel entries: the same signatures and layouts as the JAX
package's ``repro.kernels.ops``, each backed by a hand-written CUDA kernel.

Dispatch is by the device of the tensors: a CUDA tensor launches the
kernel (and counts the launch in ``LAUNCHES``), a CPU tensor computes the
plain PyTorch version from ``kernels/ref.py``, anything else raises.  There
is no fallback: a kernel that cannot take its inputs raises.  Inside
:func:`reference_mode` every tensor takes the plain version, which is how
``chip_smoke.py`` computes the reference it holds the kernels against on
the card.

``matmul``, ``attention``, ``scan_ssd`` and ``gated_scan`` are
differentiable (``torch.autograd.Function``, the counterparts of the
reference's ``jax.custom_vjp`` rules): the matmul's gradients are two more
K1 products, the attention's forward saves K2's exported (m, l) statistics
for the K3/K4 backward, the SSD scan's forward saves K6's exported
per-chunk states for the K7 reverse scan, and the gated scan's backward
is K8's reverse walk.

================  =======================  =============================
entry             kernel (``csrc/``)       replaces (``repro``)
================  =======================  =============================
``matmul``        K1 ``gemm.cu``           ``emit_pallas`` (mul, add);
                                           VJP ``ops._gemm_tb``,
                                           ``ops._gemm_ta``
``expert_gemm``,  K1 ``gemm.cu``, its      ``emit_pallas`` on
``expert_         expert form              ``expert_gemm_expr`` (the
matmul``                                   forward of
                                           ``_pallas_expert_f32``)
``attention``,    K2 ``flash_fwd.cu``      ``emit._softmax_kind`` (with
``attention_                               its (m, l) export)
stats``
``flash_dq``      K3 ``flash_bwd.cu``      ``emit._flash_dq_kind``
``flash_dkv``     K4 ``flash_bwd.cu``      ``emit._flash_dkv_kind``
``paged_decode_   K5 ``paged_decode.cu``   ``emit._windowed_decode_kind``
batched``,                                 (every slot in one launch;
``paged_decode``                           one sequence: the same kernel
                                           at one slot)
``scan_ssd``      K6 ``ssd.cu``            ``emit._ssd_kind`` (with its
                                           per-chunk ``h_in`` export)
(its backward)    K7 ``ssd.cu``            ``emit._ssd_backward_kind``
``gated_scan``    K8 ``gated_scan.cu``     ``emit._gated_kind`` (and its
(and backward)                             ``gated_backward`` kind)
``apply`` and     K9 ``semiring.cu``       ``emit_pallas`` with any other
its builders                               semiring, ``_general_combine``
================  =======================  =============================

K1 takes one of its routes by :func:`gemm_route`, a shape rule applied
before launch: the TMA + wgmma tile path (bf16), its split form (one f32
operand as three bf16 parts, made once by :func:`split_bf16` for both of a
backward's products, which is no K1 launch of its own), the decode rows'
weight stream (at most 16 rows) or, where TMA cannot read an operand, the
first kernels.  K4's bf16 tensor-core form splits each key tile's row
stream over :func:`dkv_splits` blocks.  Either counts one launch a call.

``apply(expr, *arrays)`` is the MoA expression entry (the paper's
pipeline): the expression is psi-reduced to its normal form
(``core.expr``), lifted and scheduled (``core.schedule.get_schedule``, on
the ``H100`` table by default), and run.  A (mul, add) normal form that is
one 2-D product of stored operands goes to K1 with its transpose flags,
and a stack of them over a shared leading (expert) axis to K1's expert
form where :func:`expert_route` allows (aligned bf16); every other normal
form goes to K9 through its launch descriptor (``kernels/emit.py``),
which reads every leaf in place.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from collections import OrderedDict

import torch

from repro_torch.core import expr as E
from repro_torch.core import schedule as sched_mod
from repro_torch.core.blocking import solve_recurrence_blocks
from repro_torch.hardware import H100, HardwareShape
from repro_torch.kernels import build, emit, ref

#: kernel launches since import (or the caller's last reset), by kernel id;
#: a wrapper adds one exactly where it launches its kernel
LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0,
            "K8": 0, "K9": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN = False
_C = ctypes.c_int
_P = ctypes.c_void_p
_F = ctypes.c_float
#: C entry point -> (library, argument types before the trailing stream)
_SIGNATURES = {
    "repro_gemm": ("gemm", [_P, _P, _P] + [_C] * 9),
    "repro_gemm_tc": ("gemm", [_P] * 7 + [_C] * 5),
    "repro_gemv": ("gemm", [_P] * 4 + [_C] * 5),
    "repro_expert_gemm": ("gemm", [_P] * 4 + [_C] * 6),
    "repro_split_bf16": ("gemm", [_P] * 4 + [ctypes.c_longlong]),
    "repro_flash_fwd": ("flash_fwd", [_P] * 6 + [_C] * 6 + [_F, _C, _C, _C]),
    "repro_flash_dq": ("flash_bwd", [_P] * 8 + [_C] * 6 + [_F, _C, _C, _C]),
    "repro_flash_dkv": ("flash_bwd", [_P] * 10 + [_C] * 6
                        + [_F, _C, _C, _C, _C]),
    "repro_paged_decode": ("paged_decode", [_P] * 7 + [_C] * 7
                           + [_F, _C, _C]),
    "repro_ssd_workspace": ("ssd", [_C] * 7),
    "repro_ssd_scan": ("ssd", [_P] * 9 + [ctypes.c_longlong] + [_C] * 6),
    "repro_ssd_bwd": ("ssd", [_P] * 13 + [ctypes.c_longlong] + [_C] * 7),
    "repro_gated_workspace": ("gated_scan", [_C] * 4),
    "repro_gated_scan": ("gated_scan", [_P] * 6 + [ctypes.c_longlong]
                         + [_C] * 5),
    "repro_semiring": ("semiring", [_P, _C] + [_P] * 6 + [_C] * 2),
}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


@contextlib.contextmanager
def reference_mode():
    """Within this block every wrapper computes its plain PyTorch version,
    on whatever device its tensors are, and counts no launch: the
    yardstick the card's kernels are held against."""
    global _PLAIN
    prev, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = prev


def _use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors or
    inside :func:`reference_mode` (plain version); raises on a mix or on
    any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda" and not _PLAIN


#: C entry points that launch nothing: no stream, a size returned
_QUERIES = {"repro_ssd_workspace", "repro_gated_workspace"}
#: C entry point -> (function, library), bound on first use
_ENTRIES: dict = {}


def _entry(name: str):
    found = _ENTRIES.get(name)
    if found is not None:
        return found
    lib, argtypes = _SIGNATURES[name]
    handle = build.load(lib)
    fn = getattr(handle, name)
    if fn.argtypes is None:
        query = name in _QUERIES
        fn.argtypes = argtypes if query else argtypes + [_P]
        fn.restype = ctypes.c_longlong if query else ctypes.c_int
        handle.repro_error_string.argtypes = [ctypes.c_int]
        handle.repro_error_string.restype = ctypes.c_char_p
    _ENTRIES[name] = (fn, handle)
    return fn, handle


#: torch's raw accessor of the current stream's handle, which its own
#: kernel launchers use: the public ``current_stream()`` builds a Stream
#: object, several microseconds a launch on the host's critical path
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream() -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def _launch(name: str, *args) -> None:
    fn, handle = _entry(name)
    code = fn(*args, _stream())
    if code != 0:
        msg = handle.repro_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def _check_kernel_dtype(what: str, *tensors: torch.Tensor,
                        mixed: bool = False) -> int:
    """The kernels' dtype code (0 f32, 1 bf16) of operands of one dtype;
    with ``mixed``, also an (f32, bf16) pair, whose code is the first
    operand's.  Operands must be contiguous."""
    dtypes = {t.dtype for t in tensors}
    if not dtypes <= set(_DTYPE_CODE) or (len(dtypes) != 1 and not mixed):
        raise TypeError(f"{what} kernel takes float32 or bfloat16 operands "
                        f"of one dtype{' or one of each' if mixed else ''}, "
                        f"got {sorted(map(str, dtypes))}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous operands")
    return _DTYPE_CODE[tensors[0].dtype]


def _aligned16(t: torch.Tensor, row: int) -> bool:
    return t.data_ptr() % 16 == 0 and (row * t.element_size()) % 16 == 0


# ---------------------------------------------------------------------------
# K1: matmul
# ---------------------------------------------------------------------------

#: K1's decode-row path takes products of at most this many rows (the
#: serving steps' 1-4 slots, padded to mma.sync's 16)
K1_DECODE_ROWS = 16
#: the k granule of the decode-row kernel (one 16-byte load a thread)
K1_GEMV_UNIT = 32
#: the SMs a grid must fill (H100's mesh axis)
SM_COUNT = dict(H100.mesh_axes)["sm"]


@functools.lru_cache(maxsize=4096)
def gemm_route(m: int, n: int, k: int, a_dtype, b_dtype,
               transpose_a: bool = False, transpose_b: bool = False,
               a_base_ok: bool = True, b_base_ok: bool = True) -> str:
    """K1's kernel for one product, chosen from its shapes before launch:

    - ``"fma"``: f32 x f32 (exact f32 FMA, ``gemm_fma``);
    - ``"wmma"`` / ``"fma"``: the first kernels (``gemm_bf16``, bf16 x
      bf16 without ``transpose_a``; ``gemm_fma`` otherwise) where TMA
      cannot read an operand: a stored row length (``m`` or ``k`` of A,
      ``k`` or ``n`` of B) not a multiple of 8 elements, a base not
      16-byte aligned (``*_base_ok``), or ``k == 0``;
    - ``"gemv"``: bf16 x bf16 with at most ``K1_DECODE_ROWS`` rows,
      no ``transpose_a`` and ``k % 32 == 0`` (the weight-streaming decode
      kernel, split over k by :func:`gemv_splits`);
    - ``"tile"``: the other bf16 x bf16 products (TMA + wgmma);
    - ``"split"``: one f32 and one bf16 operand: the f32 one as its three
      bf16 parts (:func:`split_bf16`), three wgmmas a k-step on the tile
      path."""
    f32, bf16 = torch.float32, torch.bfloat16
    if a_dtype == f32 and b_dtype == f32:
        return "fma"
    a_row = m if transpose_a else k
    b_row = k if transpose_b else n
    aligned = (k > 0 and a_row % 8 == 0 and b_row % 8 == 0 and a_base_ok
               and b_base_ok)
    if not aligned:
        return "wmma" if a_dtype == b_dtype == bf16 and not transpose_a \
            else "fma"
    if a_dtype != b_dtype:
        return "split"
    if m <= K1_DECODE_ROWS and not transpose_a and k % K1_GEMV_UNIT == 0:
        return "gemv"
    return "tile"


@functools.lru_cache(maxsize=1024)
def gemv_splits(m: int, n: int, k: int, e: int = 1) -> int:
    """The decode-row kernel's split of k: enough blocks of 64 columns (of
    each of the ``e`` experts of the expert form) for four a SM (``n``
    alone fills the card at the vocab head, ``e x n`` at a MoE layer's
    experts: no split), at least four units of 32 k a split, and no empty
    split."""
    units = k // K1_GEMV_UNIT
    tiles = e * -(-n // 64)
    want = max(1, min(-(-4 * SM_COUNT // tiles), units // 4))
    per = -(-units // want)
    return -(-units // per)


def split_bf16(g: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``(hi, mid, lo)`` bf16 of an f32 tensor (``ref.split_bf16``): ``g
    = hi + mid + lo`` within 2^-24 of ``|g|`` (a hand-written elementwise
    pass on the card, not a K1 launch)."""
    if not _use_kernel(g):
        return ref.split_bf16(g)
    if g.dtype != torch.float32 or not g.is_contiguous() or \
            g.data_ptr() % 16:
        raise ValueError("split_bf16 takes a contiguous, 16-byte aligned "
                         "float32 tensor")
    parts = torch.empty((3,) + tuple(g.shape), device=g.device,
                        dtype=torch.bfloat16)
    _launch("repro_split_bf16", g.data_ptr(), parts[0].data_ptr(),
            parts[1].data_ptr(), parts[2].data_ptr(), g.numel())
    return tuple(parts)


def _route(a: torch.Tensor, b: torch.Tensor, transpose_a: bool,
           transpose_b: bool) -> str:
    k, m = a.shape if transpose_a else a.shape[::-1]
    n = b.shape[0] if transpose_b else b.shape[1]
    return gemm_route(m, n, k, a.dtype, b.dtype, transpose_a, transpose_b,
                      a.data_ptr() % 16 == 0, b.data_ptr() % 16 == 0)


def _gemm(a: torch.Tensor, b: torch.Tensor, transpose_a: bool = False,
          transpose_b: bool = False, split=None) -> torch.Tensor:
    """Launch K1 on 2-D operands; returns the f32 ``op(a) @ op(b)``, where
    ``op(a)`` reads a stored ``(k, m)`` as its transpose when
    ``transpose_a`` and ``op(b)`` a stored ``(n, k)`` when
    ``transpose_b``.  Operands may be f32, bf16 or one of each; the route
    is :func:`gemm_route`'s.  ``split``: the three bf16 parts of the f32
    operand of a mixed product, when the caller has made them (else they
    are made here)."""
    code_a = _check_kernel_dtype("gemm", a, b, mixed=True)
    code_b = _DTYPE_CODE[b.dtype]
    k, m = a.shape if transpose_a else a.shape[::-1]
    n = b.shape[0] if transpose_b else b.shape[1]
    out = torch.empty((m, n), device=a.device, dtype=torch.float32)
    if not (m and n):
        return out
    route = _route(a, b, transpose_a, transpose_b)
    if route in ("tile", "split"):
        a_ptrs, b_ptrs = (a.data_ptr(), None, None), (b.data_ptr(), None,
                                                      None)
        if route == "split":
            parts = split if split is not None else \
                split_bf16(a if code_a == 0 else b)
            ptrs = tuple(t.data_ptr() for t in parts)
            a_ptrs, b_ptrs = (ptrs, b_ptrs) if code_a == 0 else (a_ptrs,
                                                                 ptrs)
        _launch("repro_gemm_tc", *a_ptrs, *b_ptrs, out.data_ptr(), m, n, k,
                int(transpose_a), int(transpose_b))
    elif route == "gemv":
        nsplit = gemv_splits(m, n, k)
        ws = torch.empty((nsplit, m, n), device=a.device,
                         dtype=torch.float32) if nsplit > 1 else None
        _launch("repro_gemv", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), m, n, k,
                int(transpose_b), nsplit)
    else:
        vec_a = _aligned16(a, m if transpose_a else k)
        vec_b = _aligned16(b, k if transpose_b else n)
        _launch("repro_gemm", a.data_ptr(), b.data_ptr(), out.data_ptr(), m,
                n, k, int(transpose_a), int(transpose_b), code_a, code_b,
                int(vec_a), int(vec_b))
    LAUNCHES["K1"] += 1
    return out


def _product(a: torch.Tensor, b: torch.Tensor, transpose_a: bool = False,
             transpose_b: bool = False, split=None) -> torch.Tensor:
    """The f32 2-D product through K1 (CUDA) or its plain version (which
    ignores ``split`` and multiplies the f32 operand exactly)."""
    if _use_kernel(a, b):
        return _gemm(a, b, transpose_a, transpose_b, split)
    return ref.matmul(a, b, transpose_b, transpose_a=transpose_a)


class _MatmulF32(torch.autograd.Function):
    """``y = x2 @ w2`` (or ``x2 @ w2.T``) in f32, the counterpart of the
    reference's ``_pallas_matmul_f32`` custom VJP.  Both gradients are two
    more K1 products that read every transposed operand in its stored
    layout (no transpose copy of a weight, an activation or the
    vocab-sized logits gradient).  The cotangent ``g`` is f32 (the cast to
    the out dtype sits outside), so the products are mixed (f32, bf16)
    under bf16 weights: on the card ``g`` is split once, for both of its
    products, into three bf16 parts (:func:`split_bf16`), and each product
    runs as three bf16 tensor-core products into one f32 accumulator (K1's
    "split" route; the parts hold ``g`` within 2^-24 of its magnitude, so
    only the order of the f32 sums differs from the reference's).  Their
    f32 results are cast to ``x2.dtype`` / ``w2.dtype``, as
    ``_pallas_matmul_bwd`` does."""

    @staticmethod
    def forward(ctx, x2, w2, transpose_b):
        ctx.save_for_backward(x2, w2)
        ctx.transpose_b = transpose_b
        return _product(x2, w2, transpose_b=transpose_b)

    @staticmethod
    def backward(ctx, g):
        x2, w2 = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_w = ctx.needs_input_grad[:2]
        if ctx.transpose_b:
            # y = x w^T: dx = g @ w (stored layout); dw = g^T @ x
            forms = ((g, w2, False, False), (g, x2, True, False))
        else:
            # dx = g @ w^T; dw = x^T @ g
            forms = ((g, w2, False, True), (x2, g, True, False))
        forms = [f if need else None
                 for f, need in zip(forms, (need_x, need_w))]
        split = None
        if _use_kernel(g, x2, w2) and any(
                f is not None and _route(*f) == "split" for f in forms):
            split = split_bf16(g)
        dx, dw = (None if f is None else _product(*f, split=split)
                  for f in forms)
        return (None if dx is None else dx.to(x2.dtype),
                None if dw is None else dw.to(w2.dtype), None)


def matmul(x: torch.Tensor, w: torch.Tensor, *, transpose_b: bool = False,
           out_dtype=None) -> torch.Tensor:
    """``y[..., :] = x[..., k] @ w[k, ...]``, accumulated and returned in
    f32, then cast to ``out_dtype`` (default ``x.dtype``).

    Leading dims of ``x`` and trailing dims of ``w`` collapse to one 2-D
    product.  ``transpose_b`` contracts against the stored layout of a
    ``(..., k)`` weight, ``y = x @ w.T``, with no transpose copy (the tied
    logits head).  Differentiable in ``x`` and ``w``."""
    kdim = x.shape[-1]
    if transpose_b:
        if w.shape[-1] != kdim:
            raise ValueError(f"matmul(transpose_b) contraction mismatch "
                             f"{tuple(x.shape)} @ {tuple(w.shape)}.T")
        w2 = w.reshape(-1, kdim)
        out_tail = w.shape[:-1]
    else:
        if w.shape[0] != kdim:
            raise ValueError(f"matmul contraction mismatch {tuple(x.shape)} "
                             f"@ {tuple(w.shape)}")
        w2 = w.reshape(kdim, -1)
        out_tail = w.shape[1:]
    # K1 reads row-major operands: an activation that arrives strided
    # (e.g. an einsum's permuted result) is copied, never a weight
    x2 = x.reshape(-1, kdim).contiguous()
    if torch.is_grad_enabled() and (x2.requires_grad or w2.requires_grad):
        y = _MatmulF32.apply(x2, w2, transpose_b)
    else:          # serving: no autograd node per product
        y = _product(x2, w2, transpose_b=transpose_b)
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], *out_tail)


# ---------------------------------------------------------------------------
# K1's expert form: the capacity-padded MoE GEMM
# ---------------------------------------------------------------------------

def expert_route(e: int, cap: int, d: int, f: int, x_dtype, w_dtype,
                 base_ok: bool = True) -> str:
    """The kernel of one expert form ``(e, cap, d) @ (e, d, f)``, from
    :func:`gemm_route` on one expert's product ``(cap, f, d)``: K1's
    ``"gemv"`` (bf16 x bf16, ``cap <= K1_DECODE_ROWS``, ``d % 32 == 0``)
    or ``"tile"`` (the other bf16 x bf16 forms whose rows TMA reads) with
    the expert axis, else ``"K9"`` (its batched TILE path: any other
    dtype, a row of ``d`` or ``f`` not a multiple of 8 elements, or a base
    not 16-byte aligned).  Dtypes are torch dtypes or their names."""
    names = {str(t).removeprefix("torch.") for t in (x_dtype, w_dtype)}
    if names != {"bfloat16"} or not (e and cap and f):
        return "K9"
    bf16 = torch.bfloat16
    route = gemm_route(cap, f, d, bf16, bf16, False, False, base_ok, base_ok)
    return route if route in ("gemv", "tile") else "K9"


def _expert_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch K1's expert form on ``x (e, cap, d)``, ``w (e, d, f)`` bf16
    (a route of :func:`expert_route`); returns the f32 ``(e, cap, f)``."""
    _check_kernel_dtype("expert gemm", x, w)
    e, m, k = x.shape
    n = w.shape[2]
    route = expert_route(e, m, k, n, x.dtype, w.dtype,
                         x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    if route == "K9":
        raise ValueError(f"K1's expert form takes aligned bf16 operands; "
                         f"{tuple(x.shape)} {x.dtype} x {tuple(w.shape)} "
                         f"{w.dtype} is K9's (ops.expert_route)")
    out = torch.empty((e, m, n), device=x.device, dtype=torch.float32)
    nsplit = gemv_splits(m, n, k, e) if route == "gemv" else 1
    ws = torch.empty((nsplit, e, m, n), device=x.device,
                     dtype=torch.float32) if nsplit > 1 else None
    _launch("repro_expert_gemm", x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), e, m, n, k,
            int(route == "gemv"), nsplit)
    LAUNCHES["K1"] += 1
    return out


def _expert_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The f32 expert form through K1 (CUDA) or its plain version."""
    if _use_kernel(x, w):
        return _expert_gemm(x, w)
    return ref.expert_gemm(x, w)


@functools.lru_cache(maxsize=256)
def _expert_expr(e: int, cap: int, d: int, f: int) -> "E.Expr":
    return E.expert_gemm_expr(e, cap, d, f)


def expert_gemm(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None,
                blocks=None, hardware: HardwareShape = H100) -> torch.Tensor:
    """``(E, cap, d) x (E, d, f) -> (E, cap, f)``, the capacity-padded
    expert GEMM (``repro.kernels.ops.expert_gemm``): the MoA expression
    ``expert_gemm_expr`` through :func:`apply`, the expert axis one more
    lift of the blocked product.  Its plan runs K1's expert form or K9 by
    :func:`expert_route`; accumulated in f32, returned in ``out_dtype``
    (default ``x.dtype``)."""
    e, cap, d = x.shape
    e2, d2, f = w.shape
    if e != e2 or d != d2:
        raise ValueError(f"expert gemm mismatch {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    return apply(_expert_expr(e, cap, d, f), x, w,
                 out_dtype=out_dtype or x.dtype, blocks=blocks,
                 hardware=hardware)


class _ExpertMatmulF32(torch.autograd.Function):
    """``y = x @ w`` per expert in f32, the counterpart of the reference's
    ``_pallas_expert_f32`` custom VJP.  Its backward is two more expert
    forms (``dx = g wᵀ``, ``dw = xᵀ g``), which K1 does not have on the
    card yet: there it raises; on the CPU it computes them plainly."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return expert_gemm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if _use_kernel(g, x, w):
            raise NotImplementedError(
                "expert_matmul's backward (K1's expert VJP forms dx = g wᵀ, "
                "dw = xᵀ g) is not ported to the card yet (ROADMAP.md, "
                "Queue 1, MoE training)")
        dx = ref.expert_gemm(g, w.transpose(1, 2), x.dtype)
        dw = ref.expert_gemm(x.transpose(1, 2), g, w.dtype)
        return dx, dw


def expert_matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None,
                  mesh=None, shard=None) -> torch.Tensor:
    """The batched expert contraction ``ecd,edf->ecf``
    (``repro.kernels.ops.expert_matmul``), the MoE dispatch's hot path:
    :func:`expert_gemm` in f32, cast to ``out_dtype`` (default
    ``x.dtype``).  Differentiable in ``x`` and ``w`` on the CPU; on the
    card its backward raises (the MoE training slice).  ``mesh=`` /
    ``shard=`` (expert parallelism) raise."""
    if mesh is not None or shard is not None:
        raise NotImplementedError(
            "expert_matmul(mesh=/shard=) runs a distributed plan; it is not "
            "ported yet (ROADMAP.md, Queue 1, Distributed)")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _ExpertMatmulF32.apply(x, w)
    else:
        y = expert_gemm(x, w, out_dtype=torch.float32)
    return y.to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# K2: attention (prefill and training forward); K3, K4: its backward
# ---------------------------------------------------------------------------

def _check_attention(q, k, v, causal, window, prefix_len) -> None:
    if prefix_len:
        raise NotImplementedError(
            "prefix_len > 0 (the VLM prefix-LM mask) is not ported yet; see "
            "ROADMAP.md, Queue 1, the enc-dec/VLM families")
    if not causal and window:
        raise ValueError(f"window={window} requires causal attention")
    b, sq, kv, g, hd = q.shape
    if k.shape[0] != b or k.shape[2] != kv or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"attention shape mismatch q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")


def _check_flash(what: str, tensors, hd: int) -> int:
    # the common case in one pass over the operands (host time of small
    # calls); anything off falls through to the checks that name it
    code = _DTYPE_CODE.get(tensors[0].dtype)
    if code is not None and hd in (64, 128, 256):
        for t in tensors:
            if t.dtype != tensors[0].dtype or t.shape[-1] != hd or \
                    not t.is_contiguous() or t.data_ptr() % 16:
                break
        else:
            return code
    dtype = _check_kernel_dtype(what, *tensors)
    if hd not in (64, 128, 256) or any(t.shape[-1] != hd for t in tensors):
        raise ValueError(f"{what} kernel takes hd = vd in (64, 128, 256), "
                         f"got {[tuple(t.shape) for t in tensors]}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} kernel takes 16-byte aligned operands")
    return dtype


def _check_stats(what: str, shape, *stats: torch.Tensor) -> None:
    for t in stats:
        if t.shape != shape or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous float32 "
                             f"statistics of shape {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _flash_fwd(q, k, v, scale, causal, window, export: bool):
    """K2 or its plain version: ``out``, plus ``(m, l)`` when ``export``."""
    if not _use_kernel(q, k, v):
        if export:
            return ref.attention_stats(q, k, v, scale=scale, causal=causal,
                                       window=window)
        return ref.attention(q, k, v, scale=scale, causal=causal,
                             window=window)
    b, sq, kv, g, hd = q.shape
    dtype = _check_flash("flash_fwd", (q, k, v), hd)
    out = torch.empty((b, sq, kv * g, hd), device=q.device, dtype=q.dtype)
    m = l = None
    if export:
        m = torch.empty((b, kv, g, sq), device=q.device, dtype=torch.float32)
        l = torch.empty_like(m)
    _launch("repro_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), m.data_ptr() if export else None,
            l.data_ptr() if export else None, b, sq, k.shape[1], kv, g, hd,
            float(scale), int(causal), int(window), dtype)
    LAUNCHES["K2"] += 1
    return (out, m, l) if export else out


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's derived VJP
    (``_flash_grouped_fwd``/``_flash_grouped_bwd``): the forward runs K2
    with the (m, l) export and saves ``(q, k, v, out, m, l)``; the
    backward computes ``delta = rowsum(dO * out)`` in plain PyTorch (the
    reference's one jnp reduction) and runs K3 for dq and K4 for dk, dv,
    the latter already summed over the query heads of each KV head."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        out, m, l = _flash_fwd(q, k, v, scale, causal, window, export=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (scale, causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        scale, causal, window = ctx.args
        b, sq, kv, g, _ = q.shape
        do = dout.contiguous().reshape(b, sq, kv, g, -1)
        delta = (do.float() * out.reshape(do.shape).float()).sum(-1)
        delta = delta.permute(0, 2, 3, 1).contiguous()     # (b, kv, g, sq)
        args = dict(scale=scale, causal=causal, window=window)
        dq = flash_dq(q, k, v, do, m, l, delta, **args)
        dk, dv = flash_dkv(q, k, v, do, m, l, delta, **args)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = True, window: int = 0,
              prefix_len: int = 0) -> torch.Tensor:
    """Grouped-query attention, the flash forward.

    ``q (B, Sq, KV, G, hd)`` (K/V heads never repeated), ``k/v (B, Sk, KV,
    hd)`` -> ``(B, Sq, KV*G, hd)`` in ``q.dtype``.  ``window`` (causal
    only) drops keys more than ``window`` behind the query.
    Differentiable: when a gradient is wanted the forward exports (m, l)
    and the backward runs K3 and K4."""
    _check_attention(q, k, v, causal, window, prefix_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                     int(window))
    return _flash_fwd(q, k, v, scale, causal, window, export=False)


def attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 with its state export: ``(out, m, l)``, ``out`` as
    :func:`attention` returns it (the same bits), ``m, l (B, KV, G, Sq)``
    f32 the final running max and denominator of each row."""
    _check_attention(q, k, v, causal, window, 0)
    return _flash_fwd(q, k, v, scale, causal, window, export=True)


def _bwd_args(what, q, k, v, do, m, l, delta):
    b, sq, kv, g, hd = q.shape
    if do.shape != q.shape[:4] + (v.shape[-1],):
        raise ValueError(f"{what}: dO {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)} / v {tuple(v.shape)}")
    dtype = _check_flash(what, (q, k, v, do), hd)
    _check_stats(what, (b, kv, g, sq), m, l, delta)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            m.data_ptr(), l.data_ptr(), delta.data_ptr()), dtype


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
             delta: torch.Tensor, *, scale: float, causal: bool = True,
             window: int = 0) -> torch.Tensor:
    """K3: dq ``(B, Sq, KV, G, hd)`` in ``q.dtype`` from ``do (B, Sq, KV,
    G, vd)`` and the saved ``m, l`` with ``delta = rowsum(dO * out)``, all
    three ``(B, KV, G, Sq)`` f32."""
    if not _use_kernel(q, k, v, do, m, l, delta):
        return ref.flash_dq(q, k, v, do, m, l, delta, scale=scale,
                            causal=causal, window=window)
    ptrs, dtype = _bwd_args("flash_dq", q, k, v, do, m, l, delta)
    b, sq, kv, g, hd = q.shape
    dq = torch.empty_like(q)
    _launch("repro_flash_dq", *ptrs, dq.data_ptr(), b, sq, k.shape[1], kv,
            g, hd, float(scale), int(causal), int(window), dtype)
    LAUNCHES["K3"] += 1
    return dq


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
              delta: torch.Tensor, *, scale: float, causal: bool = True,
              window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(dk, dv)``, each ``(B, Sk, KV, hd)`` in k's / v's dtype,
    summed over the G query heads that share each KV head."""
    if not _use_kernel(q, k, v, do, m, l, delta):
        return ref.flash_dkv(q, k, v, do, m, l, delta, scale=scale,
                             causal=causal, window=window)
    ptrs, dtype = _bwd_args("flash_dkv", q, k, v, do, m, l, delta)
    b, sq, kv, g, hd = q.shape
    sk = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # the tensor-core form (bf16, G dividing its row tile) with its row
    # stream split over nsplit blocks a key tile, whose f32 partials a
    # second pass sums in split order; nsplit = 0 takes the FMA kernel
    nsplit = dkv_splits(b, sq, sk, kv, g, bool(causal), int(window)) \
        if dtype == 1 and DKV_ROWS % g == 0 else 0
    ws = torch.empty((2, nsplit, b, sk, kv, hd), device=q.device,
                     dtype=torch.float32) if nsplit > 1 else None
    _launch("repro_flash_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(),
            None if ws is None else ws.data_ptr(), b, sq, sk, kv, g, hd,
            float(scale), int(causal), int(window), dtype, nsplit)
    LAUNCHES["K4"] += 1
    return dk, dv


#: K4's tensor-core blocks: keys of a block, streamed rows of a tile
DKV_KEYS = DKV_ROWS = 64


def dkv_row_tiles(j0: int, sq: int, sk: int, g: int, causal: bool,
                  window: int) -> tuple[int, int]:
    """``(first, count)``: the 64-row tiles of the streamed (position,
    group head) rows that can see a key of the tile starting at ``j0``
    (the kernel's ``dkv_row_tiles``): the forward's causal and window
    block-skip with the roles swapped."""
    rows = sq * g
    rstart, rend = 0, rows
    if causal:
        rstart = j0 * g
        if window > 0:
            jmax = min(sk, j0 + DKV_KEYS) - 1
            rend = min(rows, (jmax + window) * g)
    t0 = rstart // DKV_ROWS
    return t0, max(0, -(-rend // DKV_ROWS) - t0)


@functools.lru_cache(maxsize=256)
def dkv_splits(b: int, sq: int, sk: int, kv: int, g: int, causal: bool,
               window: int) -> int:
    """How many blocks share each key tile's row stream in K4's
    tensor-core form: enough for two blocks a SM over the grid, at most a
    key tile's row tiles.  Split ``s`` of a key tile with ``count`` row
    tiles takes ``[first + s * per, first + min(count, (s + 1) * per))``,
    ``per = ceil(count / nsplit)``."""
    key_tiles = -(-sk // DKV_KEYS)
    most = max((dkv_row_tiles(j * DKV_KEYS, sq, sk, g, causal, window)[1]
                for j in range(key_tiles)), default=0)
    base = key_tiles * kv * b
    return max(1, min(most, -(-2 * SM_COUNT // base)))


# ---------------------------------------------------------------------------
# K5: paged decode, every slot in one launch or one sequence
# ---------------------------------------------------------------------------

def default_decode_page(view_tokens: int, hkv: int, g: int, hd: int,
                        dtype="float32") -> int:
    """The derived KV page size: ``solve_recurrence_blocks`` over the
    streamed key axis with the carried (m, l, acc) state, one K and one V
    row per key as the token operands and the (g, page) score block as the
    quadratic intermediate (the reference's ``ops.default_decode_page``,
    here on the H100 table)."""
    choice = solve_recurrence_blocks(
        view_tokens,
        token_elems=hkv * 2 * hd,
        state_elems=g * (hd + 2),
        quad_elems=g,
        lin_elems=g * hd,
        dtype=str(dtype).removeprefix("torch."), hardware=H100)
    return choice.bs


#: blocks a SM that K5's page splits aim for: a block's warps stage their
#: pages in most of a SM's shared memory (206 KB in bf16), one block a SM
DECODE_BLOCKS_PER_SM = 1


@functools.lru_cache(maxsize=256)
def decode_splits(slots: int, kv: int, width: int) -> int:
    """How many blocks share each (slot, KV head)'s pages in K5: enough
    for ``DECODE_BLOCKS_PER_SM`` blocks a SM over the grid, at most one a
    page.  Split ``s`` takes pages ``[s * per, min(width, (s + 1) *
    per))``, ``per = ceil(width / n)``, and the count is trimmed so that no
    split is empty.  A rule on the table's width alone: ``pos`` is device
    data, and reading it here would sync the host each decode step."""
    want = -(-DECODE_BLOCKS_PER_SM * SM_COUNT // (slots * kv))
    per = -(-width // max(1, min(width, want)))
    return -(-width // per)


def paged_decode_batched(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, pos: torch.Tensor,
                         tables: torch.Tensor, *, page: int, scale: float,
                         window: int = 0) -> torch.Tensor:
    """One decode step for every serving slot in one launch.

    ``q (slots, KV, G, hd)``: one query token per slot; ``k_pool/v_pool
    (pool_tokens, KV, hd)``: the shared slab pools; ``pos (slots,)`` int32:
    each slot's position (-1 marks a dead slot, whose row is 0);
    ``tables (slots, width)`` int32: slot ``s``'s view page ``p`` lives in
    pool rows ``[tables[s, p] * page, (tables[s, p] + 1) * page)``.  The
    reference's POS aux is ``(slots, 2)`` with the position in column 0;
    here it is the position vector itself, and the table is runtime data
    (a device tensor), not executor metadata.  Returns ``(slots, KV, G,
    vd)`` f32."""
    slots, kv, g, hd = q.shape
    if k_pool.shape != v_pool.shape[:2] + (hd,) or k_pool.shape[1] != kv:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_pool.shape[0] % page:
        raise ValueError(f"pool token extent {k_pool.shape[0]} is not a "
                         f"multiple of page={page}")
    if tables.dim() != 2 or tables.shape[0] != slots or not tables.shape[1]:
        raise ValueError(f"tables must be (slots={slots}, width >= 1), got "
                         f"{tuple(tables.shape)}")
    if pos.shape != (slots,):
        raise ValueError(f"pos must be ({slots},), got {tuple(pos.shape)}")
    if not _use_kernel(q, k_pool, v_pool, pos, tables):
        return ref.paged_decode_batched(q, k_pool, v_pool, pos, tables,
                                        page=page, scale=scale,
                                        window=window)
    dtype = _check_kernel_dtype("paged_decode", q, k_pool, v_pool)
    if pos.dtype != torch.int32 or tables.dtype != torch.int32:
        raise TypeError("paged_decode kernel takes int32 pos and tables")
    if not (pos.is_contiguous() and tables.is_contiguous()):
        raise ValueError("paged_decode kernel takes contiguous pos/tables")
    if g > 16 or hd > 256 or hd % 8 or v_pool.shape[-1] != hd:
        raise ValueError(f"paged_decode kernel takes G <= 16 and hd = vd <= "
                         f"256, a multiple of 8; got q {tuple(q.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_decode kernel takes 16-byte aligned operands")
    width = tables.shape[1]
    nsplit = decode_splits(slots, kv, width)
    out = torch.empty((slots, kv, g, hd), device=q.device,
                      dtype=torch.float32)
    # the splits' (acc, m, l) partials, folded in split order into out
    part = torch.empty(nsplit * slots * kv * g * (hd + 2), device=q.device,
                       dtype=torch.float32)
    _launch("repro_paged_decode", q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), pos.data_ptr(), tables.data_ptr(),
            out.data_ptr(), part.data_ptr(), slots, kv, g, hd, int(page),
            width, nsplit, float(scale), int(window), dtype)
    LAUNCHES["K5"] += 1
    return out


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 pos: torch.Tensor, table: torch.Tensor, *, page: int,
                 scale: float, window: int = 0) -> torch.Tensor:
    """One decode step of ONE sequence (the reference's ``paged_decode``):
    ``q (KV, G, hd)``, the slab pools as in :func:`paged_decode_batched`,
    ``pos (1,)`` int32 the query's position (>= 0) and ``table (width,)``
    int32 its view->slab map, both on the device.  The same K5 kernel at
    one slot (its splits are :func:`decode_splits` at one slot, so its
    keys may be summed in another order than the same slot's in a batched
    launch); the plain version is ``ref.paged_decode_batched`` at one slot.
    Returns ``(KV, G, vd)`` f32."""
    if q.dim() != 3 or table.dim() != 1 or pos.shape != (1,):
        raise ValueError(f"paged_decode takes q (KV, G, hd), pos (1,) and "
                         f"a 1-D table; got q {tuple(q.shape)}, pos "
                         f"{tuple(pos.shape)}, table {tuple(table.shape)}")
    return paged_decode_batched(q[None], k_pool, v_pool, pos, table[None],
                                page=page, scale=scale, window=window)[0]


# ---------------------------------------------------------------------------
# K6: the SSD chunked scan; K7: its reverse scan
# ---------------------------------------------------------------------------

#: the head width the SSD kernels are written for (every Mamba-2 size),
#: the widest state and the longest chunk they take
SSD_HEAD_DIM, SSD_MAX_STATE, SSD_MAX_CHUNK = 64, 128, 256
#: bf16 parts of each f32 operand of the kernels' tensor-core products:
#: hi = bf16(x), lo = bf16(x - hi), and a.b = lo.hi + hi.lo + hi.hi
SSD_SPLIT_PARTS = 2
#: K7 sums dB's and dC's per-head terms, and dG, over groups of at most
#: this many heads in registers (see :func:`ssd_head_groups`): three groups
#: at mamba2-780m's 48 heads; fewer, longer groups move fewer partials
#: through device memory and ran K7 faster on an H100 (PERF.md)
SSD_GROUP_HEADS = 16


def ssd_head_groups(h: int) -> list[tuple[int, int]]:
    """K7's head groups, ``(first head, count)`` in order: the fewest
    groups of at most ``SSD_GROUP_HEADS`` heads, of sizes that differ by at
    most one (group ``g`` of ``ng`` starts at ``g * h // ng``, the kernel's
    ``group_first``).  Each group's blocks sum its heads' terms in head
    order; ``ssd_bwd_sum`` then sums the groups in order."""
    ng = -(-h // SSD_GROUP_HEADS)
    return [(g * h // ng, (g + 1) * h // ng - g * h // ng)
            for g in range(ng)]


def _ssd_workspace(backward: bool, b: int, s: int, h: int, n: int, q: int,
                   device: torch.device) -> torch.Tensor:
    """The scratch of one K6 (``backward`` False) or K7 call, its size from
    the kernels' own layout (``repro_ssd_workspace``)."""
    fn, _ = _entry("repro_ssd_workspace")
    floats = fn(int(backward), b, s, h, n, q, len(ssd_head_groups(h)))
    return torch.empty(floats, device=device, dtype=torch.float32)


def _check_ssd(what: str, tensors, p: int, n: int, q: int) -> None:
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} kernel takes float32 operands, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous operands")
    if p != SSD_HEAD_DIM or not 0 < n <= SSD_MAX_STATE or \
            not 0 < q <= SSD_MAX_CHUNK:
        raise ValueError(f"{what} kernel takes head_dim {SSD_HEAD_DIM}, "
                         f"state <= {SSD_MAX_STATE} and chunk <= "
                         f"{SSD_MAX_CHUNK}, got p={p} n={n} q={q}")


def ssd_scan_chunked(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, h0: torch.Tensor, chunk: int,
                     export_h_in: bool = False):
    """K6 or its plain version on a sequence already padded to a multiple
    of ``chunk``: ``xdt (b, S, h, p)``, ``dA (b, S, h)``, ``B/C (b, S,
    n)``, ``h0 (b, h, p, n)``, f32 and contiguous.  Returns ``(y (b, S, h,
    p), final (b, h, p, n), h_in (b, S // chunk, h, p, n) | None)``.

    The kernel is the chunked-SSD decomposition over a chunk-parallel grid
    (``csrc/ssd.cu``): the decays and the scores ``C B'`` once per chunk;
    ``y``'s diagonal part ``(G . L) X`` per (chunk, head, 64-row tile)
    while, on a second stream, each chunk's state contribution (a GEMM per
    chunk with the heads side by side) and one pass over the chunks give
    the entering states; then the readout ``ind (C h_in')``.  Its products
    run on the tensor cores at f32 accuracy (each f32 operand in
    ``SSD_SPLIT_PARTS`` bf16 parts).  The entering states are always
    computed, so the ``h_in`` export changes neither ``y`` nor ``final``
    by a bit."""
    if not _use_kernel(xdt, dA, B, C, h0):
        return ref.ssd_scan(xdt, dA, B, C, h0, chunk, export_h_in)
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    _check_ssd("ssd_scan", (xdt, dA, B, C, h0), p, n, chunk)
    if s % chunk:
        raise ValueError(f"ssd_scan kernel takes S = {s} a multiple of the "
                         f"chunk {chunk}")
    y = torch.empty_like(xdt)
    final = torch.empty_like(h0)
    h_in = torch.empty((b, s // chunk, h, p, n), device=xdt.device,
                       dtype=torch.float32)
    ws = _ssd_workspace(False, b, s, h, n, chunk, xdt.device)
    _launch("repro_ssd_scan", C.data_ptr(), B.data_ptr(), xdt.data_ptr(),
            dA.data_ptr(), h0.data_ptr(), y.data_ptr(), final.data_ptr(),
            h_in.data_ptr(), ws.data_ptr(), ws.numel(), b, s, h, p, n, chunk)
    LAUNCHES["K6"] += 1
    return y, final, (h_in if export_h_in else None)


def ssd_bwd_chunked(C: torch.Tensor, B: torch.Tensor, dY: torch.Tensor,
                    X: torch.Tensor, dA: torch.Tensor, Hin: torch.Tensor,
                    dHf: torch.Tensor):
    """K7 or its plain version: the reverse scan over a padded sequence in
    forward order (``C/B (b, S, n)``, ``dY/X (b, S, h, p)``, ``dA (b, S,
    h)``, ``Hin (b, nc, h, p, n)`` from K6's export, ``dHf (b, h, p,
    n)``; the chunk is ``S // nc``).  Returns ``(dX, dh0, dB, dC, ddA)``
    f32.

    The kernel reads every tensor in forward order (no flipped copies): per
    chunk in parallel ``C' (ind dY)``, one reverse pass over the chunks for
    each chunk's exit-state cotangent and ``dh0``, then per chunk and tile
    the cotangents from the saved ``Hin``, on the tensor cores at f32
    accuracy as K6, the dG / dB / dC chain on a second stream.  ``dG``,
    ``dB`` and ``dC``, sums over every head, are summed over each of
    :func:`ssd_head_groups` in registers in head order and the groups'
    partials in group order: no atomics, so reruns are bit-identical."""
    if not _use_kernel(C, B, dY, X, dA, Hin, dHf):
        return ref.ssd_bwd(C, B, dY, X, dA, Hin, dHf)
    b, s, h, p = X.shape
    n = B.shape[-1]
    nc = Hin.shape[1]
    if not nc or s % nc or Hin.shape != (b, nc, h, p, n):
        raise ValueError(f"ssd_bwd kernel: Hin {tuple(Hin.shape)} does not "
                         f"split S = {s} into chunks")
    _check_ssd("ssd_bwd", (C, B, dY, X, dA, Hin, dHf), p, n, s // nc)
    dX, dh0 = torch.empty_like(X), torch.empty_like(dHf)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    ddA = torch.empty_like(dA)
    ws = _ssd_workspace(True, b, s, h, n, s // nc, X.device)
    _launch("repro_ssd_bwd", C.data_ptr(), B.data_ptr(), dY.data_ptr(),
            X.data_ptr(), dA.data_ptr(), Hin.data_ptr(), dHf.data_ptr(),
            dX.data_ptr(), dh0.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            ddA.data_ptr(), ws.data_ptr(), ws.numel(), b, s, h, p, n,
            s // nc, len(ssd_head_groups(h)))
    LAUNCHES["K7"] += 1
    return dX, dh0, dB, dC, ddA


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` zero-padded by ``pad`` positions along its sequence axis (dim
    1), contiguous."""
    if not pad:
        return t.contiguous()
    shape = list(t.shape)
    shape[1] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=1)


def _scan_padded(xdt, dA, B, C, h0, chunk, export_h_in):
    """The ops-level pad/slice contract around K6: the sequence pads to a
    multiple of the chunk with the identity step (zero input, zero log
    decay) and ``y`` is sliced back."""
    s = xdt.shape[1]
    pad = (-s) % chunk
    y, final, h_in = ssd_scan_chunked(
        *(_pad_seq(t, pad) for t in (xdt, dA, B, C)), h0.contiguous(),
        chunk, export_h_in)
    return y[:, :s], final, h_in


class _ScanSSD(torch.autograd.Function):
    """The SSD scan with the reference's derived VJP (``_ssd_kernel_fwd``
    / ``_ssd_kernel_bwd``): the forward runs K6 with the per-chunk state
    export and saves ``(xdt, dA, B, C, h_in)``; the backward runs K7,
    seeded with the final-state cotangent."""

    @staticmethod
    def forward(ctx, xdt, dA, B, C, h0, chunk):
        y, final, h_in = _scan_padded(xdt, dA, B, C, h0, chunk, True)
        ctx.save_for_backward(xdt, dA, B, C, h_in)
        ctx.pad = (-xdt.shape[1]) % chunk
        return y, final

    @staticmethod
    def backward(ctx, gy, gfinal):
        xdt, dA, B, C, h_in = ctx.saved_tensors
        pad, s = ctx.pad, xdt.shape[1]
        dX, dh0, dB, dC, ddA = ssd_bwd_chunked(
            *(_pad_seq(t, pad) for t in (C, B, gy.float(), xdt, dA)), h_in,
            gfinal.float().contiguous())
        return (dX[:, :s].to(xdt.dtype), ddA[:, :s].to(dA.dtype),
                dB[:, :s].to(B.dtype), dC[:, :s].to(C.dtype), dh0, None)


def scan_ssd(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, init_state: torch.Tensor | None = None,
             chunk: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 SSD chunked scan (``repro.kernels.ops.scan_ssd``).

    ``xdt (B, S, H, P)`` the dt-folded input, ``dA (B, S, H)`` the log
    decay, ``B/C (B, S, N)`` the state projections, all f32; returns ``(y
    (B, S, H, P), final state (B, H, P, N))`` f32.  Any ``S``: the
    sequence pads to a multiple of the chunk with the identity step (zero
    input, zero log decay) and ``y`` is sliced back.  Differentiable in
    all five inputs: when a gradient is wanted the forward exports the
    per-chunk entering states and the backward runs K7."""
    b, s, h, p = xdt.shape
    if chunk is None:
        raise NotImplementedError(
            "the derived SSD chunk (ssm_chunk = 0, ops.default_ssd_chunk) "
            "is not ported; pass the config's chunk (ROADMAP.md, Queue 1)")
    chunk = max(1, min(int(chunk), s))
    if init_state is None:
        init_state = xdt.new_zeros((b, h, p, B.shape[-1]))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xdt, dA, B, C, init_state)):
        return _ScanSSD.apply(xdt, dA, B, C, init_state, chunk)
    y, final, _ = _scan_padded(xdt, dA, B, C, init_state, chunk, False)
    return y, final


# ---------------------------------------------------------------------------
# K8: the RG-LRU gated scan, forward and reverse
# ---------------------------------------------------------------------------

#: channels a K8 block walks (the kernel's ``STRIP``, a thread each) and
#: the chunk lengths it takes, longest first
GATED_STRIP = 64
GATED_CHUNKS = (64, 32, 16)


@functools.lru_cache(maxsize=256)
def gated_chunks(b: int, s: int, w: int) -> int:
    """K8's chunk length at ``(b, s, w)``: the longest of
    ``GATED_CHUNKS`` that still gives four blocks a SM over the grid of
    (batch row, ``GATED_STRIP``-channel strip, chunk), else the shortest.
    Chunk ``c`` covers steps ``[c L, min(s, (c + 1) L))``.  (The
    reference's ``default_gated_chunk`` sizes a full-width TPU block, not
    a channel strip: not ported, ROADMAP Queue 2.)"""
    strips = -(-w // GATED_STRIP)
    for chunk in GATED_CHUNKS[:-1]:
        if b * strips * -(-s // chunk) >= 4 * SM_COUNT:
            return chunk
    return GATED_CHUNKS[-1]


def gated_recurrence(log_a: torch.Tensor, b_in: torch.Tensor,
                     h0: torch.Tensor | None = None, reverse: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8 or its plain version: ``h_t = exp(log_a_t) h_{t-1} + b_t`` over
    ``log_a/b_in (B, S, w)`` f32 contiguous, from ``h0 (B, w)`` (zeros when
    None); ``reverse`` walks backwards with the gate one step ahead (see
    ``ref.gated_scan``).  Returns ``(h (B, S, w), final (B, w))`` f32.  The
    kernel takes any ``S`` and ``w`` without padding: its last chunk
    (:func:`gated_chunks`) and channel strip may be short."""
    if log_a.dim() != 3 or b_in.shape != log_a.shape or (
            h0 is not None and h0.shape != (log_a.shape[0],
                                            log_a.shape[2])):
        raise ValueError(f"gated scan shapes log_a {tuple(log_a.shape)}, b "
                         f"{tuple(b_in.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    operands = (log_a, b_in) if h0 is None else (log_a, b_in, h0)
    if not _use_kernel(*operands):
        return ref.gated_scan(log_a, b_in, h0, reverse)
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError(f"gated_scan kernel takes float32 operands, got "
                        f"{sorted({str(t.dtype) for t in operands})}")
    if any(not t.is_contiguous() for t in operands):
        raise ValueError("gated_scan kernel takes contiguous operands")
    b, s, w = log_a.shape
    chunk = gated_chunks(b, s, w)
    h = torch.empty_like(b_in)
    final = torch.empty((b, w), device=b_in.device, dtype=torch.float32)
    nbytes = _entry("repro_gated_workspace")[0](b, s, w, chunk)
    ws = torch.empty(nbytes, device=b_in.device, dtype=torch.uint8)
    _launch("repro_gated_scan", log_a.data_ptr(), b_in.data_ptr(),
            None if h0 is None else h0.data_ptr(), h.data_ptr(),
            final.data_ptr(), ws.data_ptr(), nbytes, b, s, w, chunk,
            int(reverse))
    LAUNCHES["K8"] += 1
    return h, final


class _GatedScan(torch.autograd.Function):
    """The gated scan with the reference's derived VJP
    (``_gated_kernel_fwd`` / ``_gated_kernel_bwd``): the forward runs K8
    and saves ``(log_a, h0, h)``; the backward folds the final-state
    cotangent into the last step's, runs K8's reverse walk for ``dbar``,
    and forms the per-token cotangents elementwise in plain PyTorch, as
    the reference does in jnp outside its kernel: ``dlog_a = dbar a
    h_prev``, ``db = dbar``, ``dh0 = a_0 dbar_0``."""

    @staticmethod
    def forward(ctx, log_a, b_in, h0):
        h, final = gated_recurrence(log_a, b_in, h0)
        ctx.save_for_backward(log_a, h0, h)
        return h, final

    @staticmethod
    def backward(ctx, gy, gfin):
        log_a, h0, h = ctx.saved_tensors
        dy = gy.float().clone(memory_format=torch.contiguous_format)
        dy[:, -1] += gfin.float()
        dbar, _ = gated_recurrence(log_a, dy, reverse=True)
        a = torch.exp(log_a.float())
        first = h.new_zeros(h[:, :1].shape) if h0 is None else \
            h0.float()[:, None]
        h_prev = torch.cat([first, h[:, :-1]], dim=1)
        dlog_a = (dbar * a * h_prev).to(log_a.dtype)
        dh0 = None
        if h0 is not None and ctx.needs_input_grad[2]:
            dh0 = (a[:, 0] * dbar[:, 0]).to(h0.dtype)
        return dlog_a, dbar, dh0


def gated_scan(log_a: torch.Tensor, b_in: torch.Tensor, *,
               init_state: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU gated linear scan (``repro.kernels.ops.gated_scan``):
    ``h_t = exp(log_a_t) h_{t-1} + b_t`` over ``log_a/b_in (B, S, w)`` f32
    from ``init_state (B, w)`` f32 (zeros when None).  Returns ``(h (B, S,
    w), final (B, w))`` f32, at any ``S``.  Differentiable in all three
    inputs: the backward runs K8's reverse walk (the reference's
    ``gated_backward`` kind)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (log_a, b_in, init_state)):
        return _GatedScan.apply(log_a, b_in, init_state)
    return gated_recurrence(log_a, b_in, init_state)


# ---------------------------------------------------------------------------
# the MoA expression entry: normal form -> derived schedule -> K1 or K9
# ---------------------------------------------------------------------------

_PLANS: "OrderedDict[tuple, tuple]" = OrderedDict()
_PLANS_LOCK = threading.Lock()
_PLANS_SIZE = 512


def _k1_form(nf: "E.NormalForm"):
    """``(transpose_a, transpose_b, batched)`` when ``nf`` is one (mul,
    add) 2-D product of stored operands, each read row-wise or column-wise
    (K1's forms), or a stack of such products over one leading axis that
    both row-major leaves and the output share, read untransposed (the
    lifted expert axis of ``expert_gemm_expr``: ``batched``); None
    otherwise."""
    if (nf.combine, nf.reduce_op) != ("mul", "add") or \
            len(nf.leaves) != 2 or len(nf.out_axes) not in (2, 3) or \
            len(nf.reduce_axes) != 1:
        return None
    batched = len(nf.out_axes) == 3
    lead = nf.out_axes[:1] if batched else ()
    (i, j), k = nf.out_axes[-2:], nf.reduce_axes[0]
    flags = []
    for leaf, rows in zip(nf.leaves, (i, k)):
        syms = tuple(t for t, _ in leaf.dims)
        if leaf.layout == "col":
            syms = syms[::-1]                     # the storage order
        if syms[:len(lead)] != lead:
            return None
        syms = syms[len(lead):]
        cols = j if rows == k else k
        if syms == (rows, cols):
            flags.append(False)
        elif syms == (cols, rows) and not batched:
            flags.append(True)
        else:
            return None
    return (*flags, batched)


def _plan(nf: "E.NormalForm", dtypes: tuple, out_dtype, hardware,
          blocks, acc_dtype: str, aligned: bool = True) -> tuple:
    """The memoised route of one normal form: ``("K1", transpose_a,
    transpose_b, batched)`` or ``("K9", launch descriptor)``; derives (or
    re-reads from the schedule cache) its bundle first, whose padding
    policy the descriptor applies (a chain has none).  A batched (expert)
    form takes K1 where :func:`expert_route` gives it one of K1's routes
    (``aligned``: every base 16-byte aligned), else K9."""
    block_key = blocks.as_tuple() if hasattr(blocks, "as_tuple") else (
        tuple(blocks) if isinstance(blocks, (list, tuple)) else blocks)
    key = (nf.key(), dtypes, out_dtype, hardware.name, block_key, acc_dtype,
           aligned)
    with _PLANS_LOCK:
        plan = _PLANS.get(key)
        if plan is not None:
            _PLANS.move_to_end(key)
            return plan
    # K9 contracts a chain pairwise and reads no schedule blocks (the
    # derived working set models the reference's nest, which the H100's
    # 227 KB refuse for tropical chains from a few dozen elements on): a
    # chain takes the semiring's inert element for its padding
    bundle = None if emit.is_chain(nf) else sched_mod.get_schedule(
        nf, dtype=dtypes[0], hardware=hardware, blocks=blocks,
        acc_dtype=acc_dtype)
    flags = _k1_form(nf)
    if flags is not None and flags[2]:
        (e, cap, d), (_, _, f) = nf.leaf_storage_shapes()
        if expert_route(e, cap, d, f, *dtypes[:2], aligned) == "K9":
            flags = None
    plan = ("K1",) + flags if flags is not None else (
        "K9", emit.describe(bundle, nf))
    with _PLANS_LOCK:
        _PLANS[key] = plan
        while len(_PLANS) > _PLANS_SIZE:
            _PLANS.popitem(last=False)
    return plan


def semiring_contract(launch: "emit.Launch", *arrays: torch.Tensor,
                      out_dtype=torch.float32) -> torch.Tensor:
    """K9 or its plain version (``ref.eval_nf``) on the leaves' storage
    buffers: the normal form ``launch.nf`` in f32, returned in
    ``out_dtype``.  On the card one call runs the launch's path (a
    chain's two stages, a split's fold) on scratch buffers allocated
    here."""
    if not _use_kernel(*arrays):
        return ref.eval_nf(launch.nf, *arrays).to(out_dtype)
    dtypes = tuple(t.dtype for t in arrays)
    for t in arrays:
        if not t.is_contiguous():
            raise ValueError("K9 takes contiguous storage buffers")
    dev = arrays[0].device
    ptrs = [t.data_ptr() for t in arrays]
    scratch = [torch.empty(n, device=dev, dtype=torch.float32) if n else None
               for n in (launch.tmp_elems, launch.work_elems)]
    descs = launch.c_descs(dtypes, out_dtype, ptrs, scratch[0].data_ptr()
                           if scratch[0] is not None else 0)
    out = torch.empty(launch.out_ext, device=dev, dtype=out_dtype)
    if out.numel():
        _launch("repro_semiring", ctypes.addressof(descs), len(descs),
                *(ptrs + [None] * (3 - len(arrays))), out.data_ptr(),
                *(None if t is None else t.data_ptr() for t in scratch),
                emit.COMBINE_CODE[launch.combine],
                emit.REDUCE_CODE[launch.reduce_op])
        LAUNCHES["K9"] += 1
    return out


def apply(expr: "E.Expr", *arrays: torch.Tensor, out_dtype=None,
          blocks=None, acc_dtype: str = "float32",
          hardware: HardwareShape = H100, mesh=None, shard=None,
          verify=False) -> torch.Tensor:
    """Evaluate a composed MoA expression (``repro.kernels.ops.apply``).

    ``arrays`` bind the expression's leaves in composition order by their
    *storage* shapes: a row-major leaf takes its logical shape, a
    column-major leaf the reversed (physical buffer) shape, so
    ``transpose(arr((n, k)))`` and ``arr((k, n), layout="col")`` bind the
    same ``(n, k)`` array, as they share a normal form.  The normal form is
    scheduled on ``hardware`` (cached per normal form) and run on K1 or K9
    (CUDA tensors) or their plain versions (CPU tensors); the result is in
    ``out_dtype`` (default the first array's dtype), accumulated in f32.
    A strided view binds like its contiguous copy (it is copied first).
    """
    if mesh is not None or shard is not None:
        raise NotImplementedError(
            "apply(mesh=/shard=) runs a distributed plan; it is not ported "
            "yet (ROADMAP.md, Queue 1, Distributed)")
    if verify:
        raise NotImplementedError(
            "apply(verify=) runs the static verifier of repro.analysis; it "
            "is not ported yet (ROADMAP.md, Queue 1)")
    nf = E.normal_form(expr)
    shapes = nf.leaf_storage_shapes()
    if len(arrays) != len(shapes):
        raise ValueError(f"expression has {len(shapes)} leaves, got "
                         f"{len(arrays)} arrays")
    for i, (a, s) in enumerate(zip(arrays, shapes)):
        if tuple(a.shape) != s:
            raise ValueError(f"leaf {i} ({nf.leaves[i].array!r}) expects "
                             f"storage shape {s}, got {tuple(a.shape)}")
    # the kernels read row-major storage buffers: a strided view (a
    # transpose, a slice) is copied, as the reference takes any array
    arrays = tuple(a.contiguous() for a in arrays)
    out_dtype = out_dtype or arrays[0].dtype
    dtypes = tuple(str(a.dtype).removeprefix("torch.") for a in arrays)
    plan = _plan(nf, dtypes, out_dtype, hardware, blocks, str(acc_dtype),
                 all(a.data_ptr() % 16 == 0 for a in arrays))
    if plan[0] == "K1":
        if plan[3]:
            return _expert_product(*arrays).to(out_dtype)
        return _product(*arrays, transpose_a=plan[1],
                        transpose_b=plan[2]).to(out_dtype)
    return semiring_contract(plan[1], *arrays, out_dtype=out_dtype)


def moa_gemm(a: torch.Tensor, b: torch.Tensor, *, blocks=None,
             out_dtype=None, hardware: HardwareShape = H100) -> torch.Tensor:
    """C = A @ B through the derived MoA schedule (K1)."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    return apply(E.matmul_expr(m, k, n), a, b, blocks=blocks,
                 out_dtype=out_dtype or a.dtype, hardware=hardware)


def hadamard(a: torch.Tensor, b: torch.Tensor, *, block=None,
             hardware: HardwareShape = H100) -> torch.Tensor:
    """The elementwise product through K9, in ``a.dtype``.  ``block`` pins
    the schedule's (bm, bn); by default the elementwise policy derives it
    (the reference's fixed (256, 256) does not fit the H100's shared
    memory)."""
    if a.shape != b.shape:
        raise ValueError(f"hadamard shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    m, n = a.shape
    return apply(E.hadamard_expr(m, n), a, b, blocks=block,
                 out_dtype=a.dtype, hardware=hardware)


def semiring_matmul(a: torch.Tensor, b: torch.Tensor, *, plus: str,
                    times: str, blocks=None,
                    hardware: HardwareShape = H100) -> torch.Tensor:
    """A matmul over any registered semiring, e.g. ``plus="min",
    times="add"`` (tropical shortest path), f32 out: the same derived
    schedule as ``moa_gemm``, run by K9 (K1 for (add, mul))."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} . "
                         f"{tuple(b.shape)}")
    expr = E.inner(plus, times, E.arr("A", (m, k)), E.arr("B", (k, n)))
    return apply(expr, a, b, blocks=blocks, out_dtype=torch.float32,
                 hardware=hardware)


@functools.lru_cache(maxsize=256)
def _outer_expr(m: int, n: int, p: int, q: int) -> "E.Expr":
    """The outer product of (m, n) and (p, q) as the degenerate inner
    product of (m, n, 1) and (1, p, q): contracted extent 1."""
    return E.inner("add", "mul", E.arr("A", (m, n, 1)),
                   E.arr("B", (1, p, q)))


def outer(a: torch.Tensor, b: torch.Tensor, *,
          hardware: HardwareShape = H100) -> torch.Tensor:
    """The outer product of matrices, ``(m, n, p, q)``, through K9: the MoA
    degenerate inner product (contracted extent 1), in ``a.dtype``."""
    m, n = a.shape
    p, q = b.shape
    return apply(_outer_expr(m, n, p, q), a.reshape(m, n, 1),
                 b.reshape(1, p, q), out_dtype=a.dtype, hardware=hardware)


def kron(a: torch.Tensor, b: torch.Tensor, *,
         hardware: HardwareShape = H100) -> torch.Tensor:
    """The Kronecker product: the outer product read through the gamma
    re-layout ``(m, n, p, q) -> (m, p, n, q)``, which the normal form
    folds into the output's indexing, so K9 writes the ``(m p, n q)``
    result directly (one launch, no transpose copy)."""
    m, n = a.shape
    p, q = b.shape
    return apply(_kron_expr(m, n, p, q), a.reshape(m, n, 1),
                 b.reshape(1, p, q), out_dtype=a.dtype,
                 hardware=hardware).reshape(m * p, n * q)


@functools.lru_cache(maxsize=256)
def _kron_expr(m: int, n: int, p: int, q: int) -> "E.Expr":
    return E.transpose(_outer_expr(m, n, p, q), (0, 2, 1, 3))


def ipophp(a: torch.Tensor, b: torch.Tensor, mode: str, *,
           hardware: HardwareShape = H100) -> torch.Tensor:
    """The unified inner / outer / Hadamard / Kronecker operator (one
    blocked circuit: 'ip' the full schedule, 'op'/'kp' its contraction-
    degenerate form, 'hp' its pairing-degenerate form)."""
    if mode == "ip":
        return moa_gemm(a, b, hardware=hardware)
    if mode == "op":
        return outer(a, b, hardware=hardware)
    if mode == "kp":
        return kron(a, b, hardware=hardware)
    if mode == "hp":
        return hadamard(a, b, hardware=hardware)
    raise ValueError(f"unknown ipophp mode {mode!r}")
