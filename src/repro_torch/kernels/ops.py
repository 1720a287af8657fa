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
                                           ``_pallas_expert_f32``; its
                                           VJP ``_pallas_expert_bwd``)
``head_matmul``   K1 ``gemm.cu``, its      ``emit_pallas`` on
                  head form                ``head_gemm_expr``
                                           (``ops.head_matmul``)
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
weight stream (at most 16 rows) or, where TMA cannot read a bf16 operand
and for every f32 x f32 product, the exact-f32 FMA kernel (tiles sized by
the width, k split over :func:`fma_splits` blocks where the tiles do not
fill the card, a row form at most 16 rows), or ``gemm_bf16``; int8 x int8
takes its int8 form (``mma.sync`` s8 x s8 into exact int32 sums, the
route of ``apply(..., acc_dtype="int32")``).  K4's bf16 tensor-core form
splits each key tile's row stream over :func:`dkv_splits` blocks.  Either
counts one launch a call.

``apply``, ``matmul`` and ``expert_matmul`` take a ``mesh=`` (a
``torch.distributed`` ``DeviceMesh``) and ``shard=``: the normal form is
lifted onto the mesh (``distributed.plan.derive_plan``) and run by
``emit.emit_shard_map``, each rank its shard on the route below, then the
plan's collectives; they return DTensors.

``scan_ssd`` and ``gated_scan`` take the chunk the H100 table derives
(:func:`default_ssd_chunk`, :func:`default_gated_chunk`: the reference's
formulas through ``core.blocking.solve_recurrence_blocks``) when none is
given; ``apply(verify=...)`` runs the static verifier
(``repro_torch.analysis``) before its launch.

``apply(expr, *arrays)`` is the MoA expression entry (the paper's
pipeline): the expression is psi-reduced to its normal form
(``core.expr``), lifted and scheduled (``core.schedule.get_schedule``, on
the ``H100`` table by default), and run.  A (mul, add) normal form that is
one 2-D product of stored operands goes to K1 with its transpose flags,
a stack of them over a shared leading (expert) axis to K1's expert form
where :func:`expert_route` allows (aligned bf16), and a stack over a head
axis in the middle of both operands (``head_gemm_expr``) to K1's head
form where :func:`head_route` allows, reading both operands through
their strides; every other normal form goes to K9 through its launch
descriptor (``kernels/emit.py``), which reads every leaf in place.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import threading
from collections import OrderedDict

import torch

from repro_torch.core import expr as E
from repro_torch.core import schedule as sched_mod
from repro_torch.core import semiring
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
    "repro_gemm": ("gemm", [_P] * 4 + [_C] * 11),
    "repro_gemm_tc": ("gemm", [_P] * 7 + [_C] * 7),
    "repro_gemm_int8": ("gemm", [_P] * 3 + [_C] * 6),
    "repro_gemv": ("gemm", [_P] * 4 + [_C] * 5),
    "repro_expert_gemm": ("gemm", [_P] * 4 + [_C] * 6),
    "repro_expert_gemm_split": ("gemm", [_P] * 7 + [_C] * 6),
    "repro_head_gemm": ("gemm", [_P] * 4 + [_C] * 6
                        + [ctypes.c_longlong] * 4),
    "repro_split_bf16": ("gemm", [_P] * 4 + [ctypes.c_longlong, _C, _C]),
    "repro_flash_fwd": ("flash_fwd", [_P] * 6 + [_C] * 7 + [_F] + [_C] * 4),
    "repro_flash_dq": ("flash_bwd", [_P] * 8 + [_C] * 7 + [_F] + [_C] * 4),
    "repro_flash_dkv": ("flash_bwd", [_P] * 10 + [_C] * 7 + [_F] + [_C] * 5),
    "repro_paged_decode": ("paged_decode", [_P] * 7 + [_C] * 7
                           + [_F, _C, _C]),
    "repro_ssd_workspace": ("ssd", [_C] * 7),
    "repro_ssd_scan": ("ssd", [_P] * 9 + [ctypes.c_longlong] + [_C] * 6),
    "repro_ssd_bwd": ("ssd", [_P] * 13 + [ctypes.c_longlong] + [_C] * 7),
    "repro_gated_workspace": ("gated_scan", [_C] * 4),
    "repro_gated_scan": ("gated_scan", [_P] * 6 + [ctypes.c_longlong]
                         + [_C] * 5),
    "repro_semiring": ("semiring", [_P, _C, _P, _C] + [_P] * 3
                       + [_C] * 2),
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


#: K1's routes (``gemm_route``; the expert and head forms take some of them)
K1_ROUTES = ("tile", "split", "gemv", "fma", "wmma", "int8")


@functools.lru_cache(maxsize=4096)
def gemm_route(m: int, n: int, k: int, a_dtype, b_dtype,
               transpose_a: bool = False, transpose_b: bool = False,
               a_base_ok: bool = True, b_base_ok: bool = True) -> str:
    """K1's kernel for one product, chosen from its shapes before launch:

    - ``"fma"``: f32 x f32 (exact f32 FMA on the CUDA cores,
      ``gemm_fma``: tiles by :func:`fma_form`, k split by
      :func:`fma_splits`), and every other form where TMA cannot read a
      bf16 operand (a stored row length, ``m`` or ``k`` of A, ``k`` or
      ``n`` of B, not a multiple of 8 elements, a base not 16-byte
      aligned, ``*_base_ok``, or ``k == 0``), but for:
    - ``"wmma"``: bf16 x bf16 without ``transpose_a`` that TMA cannot
      read (``gemm_bf16``);
    - ``"gemv"``: bf16 x bf16 with at most ``K1_DECODE_ROWS`` rows,
      no ``transpose_a`` and ``k % 32 == 0`` (the weight-streaming decode
      kernel, split over k by :func:`gemv_splits`);
    - ``"tile"``: the other bf16 x bf16 products (TMA + wgmma);
    - ``"split"``: one f32 and one bf16 operand whose bf16 operand TMA can
      read: the f32 one as its three bf16 parts (:func:`split_bf16`,
      written at a row pitch of a multiple of 8 elements, so its own
      stored row and base do not matter), three wgmmas a k-step on the
      tile path;
    - ``"int8"``: int8 x int8, the int8 form (``gemm_int8``: mma.sync
      s8 x s8 into exact int32 sums, any shape and transposes); an int8
      operand takes no other route of K1, and no other operand this one.
      Its accumulator is int32: ``apply`` refuses int8 operands under any
      other ``acc_dtype`` (``_plan``), and sends the int8 forms K1 does
      not take (the head form, every K9 path) to K9's integer
      accumulator.

    float16 operands take no route of K1: ``_plan`` sends every form with
    a float16 operand to K9, which loads them beside f32 and bf16."""
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    if i8 in (a_dtype, b_dtype):
        if a_dtype != b_dtype:
            raise TypeError(f"K1's int8 form takes int8 x int8, got "
                            f"{a_dtype} x {b_dtype}")
        return "int8"
    if a_dtype == f32 and b_dtype == f32:
        return "fma"
    a_row = m if transpose_a else k
    b_row = k if transpose_b else n
    if a_dtype != b_dtype:
        row, ok = (b_row, b_base_ok) if a_dtype == f32 else (a_row,
                                                              a_base_ok)
        return "split" if k > 0 and row % 8 == 0 and ok else "fma"
    aligned = (k > 0 and a_row % 8 == 0 and b_row % 8 == 0 and a_base_ok
               and b_base_ok)
    if not aligned:
        return "fma" if transpose_a else "wmma"
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


#: the FMA kernel's forms (``gemm.cu``, ``exact::Form``): the row form, then
#: its output tiles (rows, columns)
FMA_ROWS, FMA_TILES = 0, {1: (256, 16), 2: (128, 64), 3: (128, 128)}
#: the FMA tiles' k-step; the row form's columns a block (by
#: ``transpose_b``), the fewest k a split of it takes and its most splits
#: (the blocks of one cluster, which fold the partials)
FMA_K, FMA_ROW_COLS, FMA_ROW_SPLIT_MIN = 32, {False: 128, True: 32}, 256
FMA_ROW_CLUSTER = 8


@functools.lru_cache(maxsize=1024)
def fma_form(m: int, n: int, transpose_a: bool = False,
             f32: bool = True) -> int:
    """The FMA kernel's form for a product (``f32``: both operands f32):
    the row form (``FMA_ROWS``) for at most ``K1_DECODE_ROWS`` rows
    without ``transpose_a`` (the decode routers); else a tile by the
    width, 256 x 16 for ``n <= 16`` (llama4's 16 experts), 128 x 64 for
    ``n <= 64`` (deepseek's 64), 128 x 128 otherwise.  A bf16 or mixed
    product (the rare forms TMA cannot read) takes the 128 x 128 tile or
    the row form."""
    if m <= K1_DECODE_ROWS and not transpose_a:
        return FMA_ROWS
    if not f32 or n > 64:
        return 3
    return 1 if n <= 16 else 2


@functools.lru_cache(maxsize=1024)
def fma_splits(m: int, n: int, k: int, transpose_a: bool = False,
               transpose_b: bool = False, f32: bool = True) -> int:
    """The FMA kernel's split of k over blocks, whose partials are added in
    split order (a tile's through a workspace and a second pass, the row
    form's in the cluster of its splits): where the form's blocks
    without a split (output tiles, or the row form's column blocks) are
    fewer than the card's SMs, as many splits as bring them to two a SM,
    each of at least two k-steps of 32 (the row form: at most
    ``FMA_ROW_CLUSTER`` splits of at least ``FMA_ROW_SPLIT_MIN`` k), and
    no empty split."""
    form = fma_form(m, n, transpose_a, f32)
    most = k
    if form == FMA_ROWS:
        blocks = -(-n // FMA_ROW_COLS[transpose_b])
        unit, least, most = 1, FMA_ROW_SPLIT_MIN, FMA_ROW_CLUSTER
    else:
        bm, bn = FMA_TILES[form]
        blocks, unit, least = -(-m // bm) * -(-n // bn), FMA_K, 2
    units = -(-k // unit)
    if blocks >= SM_COUNT or units < 2 * least:
        return 1
    want = min(-(-2 * SM_COUNT // blocks), units // least, most)
    per = -(-units // want)
    return -(-units // per)


def split_bf16(g: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``(hi, mid, lo)`` bf16 of an f32 tensor (``ref.split_bf16``): ``g
    = hi + mid + lo`` within 2^-24 of ``|g|`` (a hand-written elementwise
    pass on the card, not a K1 launch).  On the card each part is a view
    of rows padded to a multiple of 8 elements (zeros past the last
    column), so TMA can read the parts of an operand whose own rows it
    cannot (whisper's 51865-wide logits gradient); ``stride(-2)`` is the
    pitch."""
    if not _use_kernel(g):
        return ref.split_bf16(g)
    if g.dtype != torch.float32 or not g.is_contiguous() or g.dim() == 0:
        raise ValueError("split_bf16 takes a contiguous float32 tensor of "
                         "at least one axis")
    cols = g.shape[-1]
    pitch = -(-cols // 8) * 8
    parts = torch.empty((3,) + tuple(g.shape[:-1]) + (pitch,),
                        device=g.device, dtype=torch.bfloat16)
    _launch("repro_split_bf16", g.data_ptr(), parts[0].data_ptr(),
            parts[1].data_ptr(), parts[2].data_ptr(), g.numel() // max(
                cols, 1), cols, pitch)
    return tuple(parts[..., :cols]) if pitch != cols else tuple(parts)


def _route(a: torch.Tensor, b: torch.Tensor, transpose_a: bool,
           transpose_b: bool) -> str:
    k, m = a.shape if transpose_a else a.shape[::-1]
    n = b.shape[0] if transpose_b else b.shape[1]
    return gemm_route(m, n, k, a.dtype, b.dtype, transpose_a, transpose_b,
                      a.data_ptr() % 16 == 0, b.data_ptr() % 16 == 0)


def _gemm_int8(a: torch.Tensor, b: torch.Tensor, transpose_a: bool = False,
               transpose_b: bool = False) -> torch.Tensor:
    """Launch K1's int8 form on ``op(a) @ op(b)``, 2-D operands or a stack
    of experts ``(e, ., .)``, contiguous int8; returns the exact int32
    ``(m, n)`` or ``(e, m, n)`` (wrapping past 2^31, as an int32
    accumulator does)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or \
            not (a.is_contiguous() and b.is_contiguous()):
        raise TypeError("K1's int8 form takes contiguous int8 operands")
    e = a.shape[0] if a.dim() == 3 else 1
    k, m = a.shape[-2:] if transpose_a else a.shape[-2:][::-1]
    n = b.shape[-2] if transpose_b else b.shape[-1]
    out = torch.empty(a.shape[:-2] + (m, n), device=a.device,
                      dtype=torch.int32)
    _launch("repro_gemm_int8", a.data_ptr(), b.data_ptr(), out.data_ptr(), e,
            m, n, k, int(transpose_a), int(transpose_b))
    LAUNCHES["K1"] += 1
    return out


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
        a_ld, b_ld = a.stride(0), b.stride(0)
        if route == "split":
            parts = split if split is not None else \
                split_bf16(a if code_a == 0 else b)
            ptrs = tuple(t.data_ptr() for t in parts)
            if code_a == 0:
                a_ptrs, a_ld = ptrs, parts[0].stride(0)
            else:
                b_ptrs, b_ld = ptrs, parts[0].stride(0)
        _launch("repro_gemm_tc", *a_ptrs, *b_ptrs, out.data_ptr(), m, n, k,
                int(transpose_a), int(transpose_b), a_ld, b_ld)
    elif route == "gemv":
        nsplit = gemv_splits(m, n, k)
        ws = torch.empty((nsplit, m, n), device=a.device,
                         dtype=torch.float32) if nsplit > 1 else None
        _launch("repro_gemv", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), m, n, k,
                int(transpose_b), nsplit)
    else:
        form, nsplit, ws = _fma_plan(a, b, m, n, k, transpose_a,
                                     transpose_b, route)
        _launch("repro_gemm", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), m, n, k,
                int(transpose_a), int(transpose_b), code_a, code_b,
                int(_aligned16(a, m if transpose_a else k)),
                int(_aligned16(b, k if transpose_b else n)), form, nsplit)
    LAUNCHES["K1"] += 1
    return out


def _fma_plan(a, b, m, n, k, transpose_a, transpose_b, route):
    """``(form, nsplit, workspace)`` of the FMA kernel for a product on the
    ``"fma"`` route (``form`` -1 and no split for ``"wmma"``): the
    partials' workspace is ``(nsplit, m, n)`` f32 for a split tile, else
    None (the row form folds its split in a cluster)."""
    if route != "fma":
        return -1, 1, None
    f32 = a.dtype == b.dtype == torch.float32
    form = fma_form(m, n, transpose_a, f32)
    nsplit = fma_splits(m, n, k, transpose_a, transpose_b, f32)
    ws = torch.empty((nsplit, m, n), device=a.device, dtype=torch.float32) \
        if nsplit > 1 and form != FMA_ROWS else None
    return form, nsplit, ws


def _product(a: torch.Tensor, b: torch.Tensor, transpose_a: bool = False,
             transpose_b: bool = False, split=None) -> torch.Tensor:
    """The f32 2-D product through K1 (CUDA) or its plain version (which
    ignores ``split`` and multiplies the f32 operand exactly); int8
    operands give the exact int32 product (K1's int8 form)."""
    if a.dtype == torch.int8 or b.dtype == torch.int8:
        gemm_route(1, 1, 1, a.dtype, b.dtype)        # int8 x int8 only
        if _use_kernel(a, b):
            return _gemm_int8(a, b, transpose_a, transpose_b)
        return ref.matmul_int8(a, b, transpose_a, transpose_b)
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
    ``_pallas_matmul_bwd`` does.

    ``saved``, the product's output kept by the "dots" memo
    (:func:`dots_contexts`), makes the forward return it and launch
    nothing; its cotangent arrives in the saved dtype and is cast to f32
    first, as the cast after the product would have done."""

    @staticmethod
    def forward(ctx, x2, w2, transpose_b, saved=None):
        ctx.save_for_backward(x2, w2)
        ctx.transpose_b = transpose_b
        if saved is not None:
            return saved
        return _product(x2, w2, transpose_b=transpose_b)

    @staticmethod
    def backward(ctx, g):
        x2, w2 = ctx.saved_tensors
        g = g.float().contiguous()
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
                None if dw is None else dw.to(w2.dtype), None, None)


#: the "dots" remat memo of the layer being run in this thread (the
#: recompute runs in autograd's own thread): None, or ``(list, None)``
#: while a checkpointed layer's forward records its products' outputs,
#: ``(list, [index])`` while its recompute replays them
_DOTS: contextvars.ContextVar = contextvars.ContextVar("dots", default=None)


@contextlib.contextmanager
def _dots_mode(memo: list, replay: bool):
    token = _DOTS.set((memo, [0] if replay else None))
    try:
        yield
    finally:
        _DOTS.reset(token)


def dots_contexts():
    """The ``context_fn`` of ``torch.utils.checkpoint`` for
    ``remat_policy="dots"`` (the reference's
    ``dots_with_no_batch_dims_saveable``): in the layer's forward every
    differentiable :func:`matmul` (a 2-D K1 product) keeps its output; in
    the recompute it returns them in order through :class:`_MatmulF32`,
    launching nothing, while attention, norms, activations and the
    expert and head products (which carry a batch axis) run again.  A
    fresh memo per checkpointed call."""
    memo: list = []
    return _dots_mode(memo, False), _dots_mode(memo, True)


def _dots_matmul(dots, x2, w2, transpose_b: bool, dtype) -> torch.Tensor:
    memo, at = dots
    if at is None:
        y = _MatmulF32.apply(x2, w2, transpose_b).to(dtype)
        memo.append((y, y._version))
        return y
    if at[0] >= len(memo):
        raise RuntimeError("remat 'dots': the recompute ran more products "
                           "than the forward recorded")
    y, version = memo[at[0]]
    at[0] += 1
    rows = x2.shape[0]
    cols = w2.shape[0] if transpose_b else w2.shape[1]
    if y.shape != (rows, cols) or y.dtype != dtype or y._version != version:
        raise RuntimeError(
            f"remat 'dots': the recompute's product {at[0] - 1} "
            f"({rows}, {cols}) {dtype} does not match the recorded "
            f"{tuple(y.shape)} {y.dtype}, or the output was modified in "
            f"place")
    return _MatmulF32.apply(x2, w2, transpose_b, y)


def _matmul_local(transpose_b: bool):
    """The single-device 2-D product in f32 that a matmul plan runs per
    shard: differentiable (:class:`_MatmulF32`) when a gradient is due."""
    def local(a, b):
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MatmulF32.apply(a, b, transpose_b)
        return _product(a, b, transpose_b=transpose_b)
    return local


def _matmul_sharded(x2, w2, transpose_b, mesh, shard, replicate_out,
                    out_dtype):
    """The mesh path of :func:`matmul`: the 2-D product's plan
    (``matmul_plan``'s roles) through ``emit_shard_map``, K1 per shard."""
    from repro_torch.distributed.plan import MATMUL_ROLES, _translate
    m, kdim = x2.shape
    n = w2.shape[0] if transpose_b else w2.shape[1]
    if shard is None:                      # rows over the first mesh axis,
        names = tuple(mesh.mesh_dim_names)  # columns over the second
        shard = {"m": names[0]}
        if len(names) > 1:
            shard["n"] = names[1]
    nf = E.normal_form(E.matmul_expr(m, kdim, n, transpose_b=transpose_b),
                       name="matmul")
    fn = _sharded_callable(nf, str(x2.dtype).removeprefix("torch."),
                           out_dtype, H100, mesh,
                           _translate(shard, MATMUL_ROLES), replicate_out,
                           None, "float32", _matmul_local(transpose_b),
                           ("matmul", transpose_b))
    return fn(x2, w2)


def matmul(x: torch.Tensor, w: torch.Tensor, *, transpose_b: bool = False,
           out_dtype=None, mesh=None, shard=None,
           replicate_out: bool = False) -> torch.Tensor:
    """``y[..., :] = x[..., k] @ w[k, ...]``, accumulated and returned in
    f32, then cast to ``out_dtype`` (default ``x.dtype``).

    Leading dims of ``x`` and trailing dims of ``w`` collapse to one 2-D
    product.  ``transpose_b`` contracts against the stored layout of a
    ``(..., k)`` weight, ``y = x @ w.T``, with no transpose copy (the tied
    logits head).  Differentiable in ``x`` and ``w``.

    ``mesh`` / ``shard`` / ``replicate_out`` lift the 2-D product to named
    device axes (roles ``{"m", "n", "k"}``, default rows over the mesh's
    first axis and columns over its second; sharding "k" derives the
    tensor-parallel psum) and run the same differentiable product per
    shard through the derived plan (:func:`apply`'s mesh path).  The
    operands are then 2-D DTensors placed as the plan reads them, or
    whole tensors every rank holds, and the result the ``(rows, cols)``
    DTensor placed as the plan leaves it."""
    if mesh is not None or shard is not None:
        if mesh is None:
            raise ValueError("matmul(shard=...) needs a mesh")
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            x = x.reshape(-1, x.shape[-1])
        if not isinstance(w, DTensor):
            w = w.reshape(-1, w.shape[-1]) if transpose_b else \
                w.reshape(w.shape[0], -1)
        if x.dim() != 2 or w.dim() != 2:
            raise ValueError("matmul(mesh=...) takes 2-D DTensors")
        if (w.shape[1] if transpose_b else w.shape[0]) != x.shape[1]:
            raise ValueError(f"matmul contraction mismatch {tuple(x.shape)} "
                             f"@ {tuple(w.shape)}"
                             f"{'.T' if transpose_b else ''}")
        return _matmul_sharded(x, w, transpose_b, mesh, shard,
                               replicate_out, out_dtype or x.dtype)
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
        dots = _DOTS.get()
        if dots is not None:
            y = _dots_matmul(dots, x2, w2, transpose_b, out_dtype or x.dtype)
        else:
            y = _MatmulF32.apply(x2, w2, transpose_b)
    else:          # serving: no autograd node per product
        y = _product(x2, w2, transpose_b=transpose_b)
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], *out_tail)


# ---------------------------------------------------------------------------
# K1's expert form: the capacity-padded MoE GEMM
# ---------------------------------------------------------------------------

def expert_route(e: int, cap: int, d: int, f: int, x_dtype, w_dtype,
                 base_ok: bool = True, transpose_a: bool = False,
                 transpose_b: bool = False) -> str:
    """The kernel of one expert form ``op(x) (e, cap, d) @ op(w) (e, d,
    f)``, from :func:`gemm_route` on one expert's product ``(cap, f,
    d)`` (``transpose_a``: x stored ``(e, d, cap)``; ``transpose_b``: w
    stored ``(e, f, d)``).  K1 takes three forms where TMA reads every
    row (a multiple of 8 elements, bases 16-byte aligned, ``base_ok``):

    - the forward, bf16 x bf16 with no transpose: ``"gemv"`` (``cap <=
      K1_DECODE_ROWS``, ``d % 32 == 0``) or ``"tile"``;
    - the two VJP forms of :func:`expert_matmul`, whose f32 cotangent
      meets a bf16 operand: ``dx = g wᵀ`` (f32 x bf16, ``transpose_b``)
      and ``dw = xᵀ g`` (bf16 x f32, ``transpose_a``), on ``"split"``
      (the f32 operand as three bf16 parts, read by rank-3 maps without
      the 2-D route's row pitch, so its rows too must be a multiple of 8
      elements; never ``"gemv"``).

    int8 x int8 with no transpose takes the int8 form (``"int8"``, any
    shape and alignment).  Everything else is ``"K9"`` (its batched TILE
    path, which takes each operand's own dtype): other dtypes or
    transposes, unaligned rows or bases.  Dtypes are torch dtypes or their
    names."""
    names = tuple(str(t).removeprefix("torch.") for t in (x_dtype, w_dtype))
    if not (e and cap and f and d):
        return "K9"
    form = (names, bool(transpose_a), bool(transpose_b))
    if form == (("int8", "int8"), False, False):
        return "int8"
    dts = tuple(getattr(torch, n) for n in names)
    if form == (("bfloat16", "bfloat16"), False, False):
        route = gemm_route(cap, f, d, *dts, False, False, base_ok, base_ok)
        return route if route in ("gemv", "tile") else "K9"
    if form in ((("float32", "bfloat16"), False, True),
                (("bfloat16", "float32"), True, False)):
        route = gemm_route(cap, f, d, *dts, transpose_a, transpose_b,
                           base_ok, base_ok)
        # the expert form's rank-3 maps read the f32 operand's parts
        # unpitched: its row (g's d for dx, f for dw) must suit TMA too
        f32_row = d if transpose_b else f
        return "split" if route == "split" and f32_row % 8 == 0 else "K9"
    return "K9"


def _expert_shape(a: torch.Tensor, b: torch.Tensor, transpose_a: bool,
                  transpose_b: bool) -> tuple[int, int, int, int]:
    """``(e, m, k, n)`` of ``op(a) (e, m, k) @ op(b) (e, k, n)``."""
    e = a.shape[0]
    m, k = (a.shape[2], a.shape[1]) if transpose_a else a.shape[1:]
    n = b.shape[1] if transpose_b else b.shape[2]
    return e, m, k, n


def _expert_gemm(a: torch.Tensor, b: torch.Tensor, transpose_a: bool = False,
                 transpose_b: bool = False, split=None) -> torch.Tensor:
    """Launch K1's expert form on ``op(a) (e, m, k) @ op(b) (e, k, n)``
    (a K1 route of :func:`expert_route`: bf16 x bf16, or a VJP form on
    the split route, whose f32 operand's three bf16 parts ``split`` the
    caller may have made); returns the f32 ``(e, m, n)``."""
    code_a = _check_kernel_dtype("expert gemm", a, b, mixed=True)
    e, m, k, n = _expert_shape(a, b, transpose_a, transpose_b)
    route = expert_route(e, m, k, n, a.dtype, b.dtype,
                         a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0,
                         transpose_a, transpose_b)
    if route == "K9":
        raise ValueError(f"K1's expert form takes aligned bf16 operands or "
                         f"a VJP form; {tuple(a.shape)} {a.dtype} x "
                         f"{tuple(b.shape)} {b.dtype} (transpose_a="
                         f"{transpose_a}, transpose_b={transpose_b}) is "
                         f"K9's (ops.expert_route)")
    out = torch.empty((e, m, n), device=a.device, dtype=torch.float32)
    if route == "split":
        parts = split if split is not None else \
            split_bf16(a if code_a == 0 else b)
        ptrs = tuple(t.data_ptr() for t in parts)
        a_ptrs, b_ptrs = (a.data_ptr(), None, None), (b.data_ptr(), None,
                                                      None)
        a_ptrs, b_ptrs = (ptrs, b_ptrs) if code_a == 0 else (a_ptrs, ptrs)
        _launch("repro_expert_gemm_split", *a_ptrs, *b_ptrs, out.data_ptr(),
                e, m, n, k, int(transpose_a), int(transpose_b))
    else:
        nsplit = gemv_splits(m, n, k, e) if route == "gemv" else 1
        ws = torch.empty((nsplit, e, m, n), device=a.device,
                         dtype=torch.float32) if nsplit > 1 else None
        _launch("repro_expert_gemm", a.data_ptr(), b.data_ptr(),
                out.data_ptr(), None if ws is None else ws.data_ptr(), e, m,
                n, k, int(route == "gemv"), nsplit)
    LAUNCHES["K1"] += 1
    return out


def _expert_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The f32 expert form through K1 (CUDA) or its plain version; int8
    experts give the exact int32 product (K1's int8 form)."""
    if x.dtype == torch.int8 or w.dtype == torch.int8:
        gemm_route(1, 1, 1, x.dtype, w.dtype)        # int8 x int8 only
        if _use_kernel(x, w):
            return _gemm_int8(x, w)
        return ref.matmul_int8(x, w)
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
    forms, ``dx = g wᵀ`` and ``dw = xᵀ g``, each reading its transposed
    operand in its stored layout.  The cotangent ``g`` is f32 (the cast to
    the out dtype sits outside), so under bf16 weights both are mixed: on
    the card ``g`` is split once, for both, into three bf16 parts
    (:func:`split_bf16`), and each form runs on K1's split route (three
    bf16 tensor-core products into one f32 accumulator, as
    ``_MatmulF32``'s).  A form that K1 cannot read (a row not a multiple
    of 8 elements; f32 weights) runs on K9's batched TILE path, on the
    transposed operand's row-major copy (``expert_gemm``), which takes the
    mixed pair as it is.  Results are cast to ``x.dtype`` / ``w.dtype``,
    as ``_pallas_expert_bwd`` does; on the CPU both are the plain
    ``ref.expert_gemm``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return expert_gemm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        need = ctx.needs_input_grad[:2]
        if not _use_kernel(g, x, w):
            dx = ref.expert_gemm(g, w.transpose(1, 2), x.dtype) \
                if need[0] else None
            dw = ref.expert_gemm(x.transpose(1, 2), g, w.dtype) \
                if need[1] else None
            return dx, dw
        # dx = g wᵀ (w stored (e, d, f)); dw = xᵀ g (x stored (e, cap, d))
        forms = [form if want else None for form, want in zip(
            ((g, w, False, True), (x, g, True, False)), need)]
        routes = [None if form is None else expert_route(
            *_expert_shape(*form), form[0].dtype, form[1].dtype,
            form[0].data_ptr() % 16 == 0 and form[1].data_ptr() % 16 == 0,
            *form[2:]) for form in forms]
        split = split_bf16(g) if "split" in routes else None
        out = []
        for form, route, dtype in zip(forms, routes, (x.dtype, w.dtype)):
            if form is None:
                out.append(None)
                continue
            a, b, ta, tb = form
            if route == "split":
                r = _expert_gemm(a, b, ta, tb, split=split)
            else:
                r = expert_gemm(a.transpose(1, 2) if ta else a,
                                b.transpose(1, 2) if tb else b,
                                out_dtype=torch.float32)
            out.append(r.to(dtype))
        return tuple(out)


def _expert_local(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The single-device expert product in f32, differentiable
    (:class:`_ExpertMatmulF32`) when a gradient is due."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _ExpertMatmulF32.apply(a, b)
    return expert_gemm(a, b, out_dtype=torch.float32)


def expert_matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None,
                  mesh=None, shard=None) -> torch.Tensor:
    """The batched expert contraction ``ecd,edf->ecf``
    (``repro.kernels.ops.expert_matmul``), the MoE dispatch's hot path:
    :func:`expert_gemm` in f32, cast to ``out_dtype`` (default
    ``x.dtype``).  Differentiable in ``x`` and ``w`` (K1's expert VJP
    forms on the card).  ``mesh`` / ``shard`` lift it across device axes
    (roles ``{"e", "m", "n", "k"}``, default ``{"e": first axis}``:
    expert parallelism) through the derived plan, K1's expert form per
    shard; operands and result as :func:`matmul`'s mesh path."""
    if mesh is not None or shard is not None:
        if mesh is None:
            raise ValueError("expert_matmul(shard=...) needs a mesh")
        from repro_torch.distributed.plan import EXPERT_ROLES, _translate
        e, cap, d = x.shape
        f = w.shape[2]
        if shard is None:
            shard = {"e": tuple(mesh.mesh_dim_names)[0]}
        nf = E.normal_form(E.expert_gemm_expr(e, cap, d, f),
                           name="expert_gemm")
        fn = _sharded_callable(nf, str(x.dtype).removeprefix("torch."),
                               out_dtype or x.dtype, H100, mesh,
                               _translate(shard, EXPERT_ROLES), False,
                               None, "float32", _expert_local, "expert")
        return fn(x, w)
    return _expert_local(x, w).to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# K1's head form: the per-head GEMM over a head-middle weight (MLA decode)
# ---------------------------------------------------------------------------

def head_aligned(*tensors: torch.Tensor) -> bool:
    """True when K1's head form can read every operand in place: the last
    axis contiguous, every other stride (of an axis longer than 1) a
    multiple of 16 bytes, and the base 16-byte aligned."""
    for t in tensors:
        if t.data_ptr() % 16 or (t.shape[-1] > 1 and t.stride(-1) != 1):
            return False
        es = t.element_size()
        if any(size > 1 and (stride * es) % 16
               for size, stride in zip(t.shape[:-1], t.stride()[:-1])):
            return False
    return True


def head_route(h: int, m: int, k: int, n: int, x_dtype, w_dtype,
               transpose_b: bool = False, aligned: bool = True) -> str:
    """The kernel of one head form ``x (m, h, k) @ w (k, h, n) -> (h, m,
    n)`` (``transpose_b``: w stored ``(n, h, k)``): ``"gemv"``, K1's
    decode-row kernel with a head grid axis, reading both operands in
    place through their row and head strides, where :func:`gemm_route`
    gives one head's product ``"gemv"`` (bf16 x bf16, ``m <=
    K1_DECODE_ROWS``, ``k % 32 == 0``, rows of a multiple of 8 elements)
    and every operand is ``aligned`` (:func:`head_aligned`); ``"K9"``
    otherwise (its batched path on row-major copies): f32, float16 and
    mixed operands under its f32 accumulator, int8 ones under its int32
    accumulator (exact).  Dtypes are torch dtypes or their names."""
    names = tuple(str(t).removeprefix("torch.") for t in (x_dtype, w_dtype))
    if not (h and m and k and n) or names != ("bfloat16", "bfloat16"):
        return "K9"
    bf = torch.bfloat16
    route = gemm_route(m, n, k, bf, bf, False, bool(transpose_b), aligned,
                       aligned)
    return "gemv" if route == "gemv" else "K9"


def _head_gemm(x: torch.Tensor, w: torch.Tensor,
               transpose_b: bool = False) -> torch.Tensor:
    """Launch K1's head form on ``x (m, h, k)`` and ``w (k, h, n)`` (``(n,
    h, k)`` with ``transpose_b``), strided views read in place; returns the
    f32 ``(h, m, n)``.  The k range is split over :func:`gemv_splits`
    blocks, whose partials a second pass sums in split order."""
    m, h, k = x.shape
    n = w.shape[0] if transpose_b else w.shape[2]
    route = head_route(h, m, k, n, x.dtype, w.dtype, transpose_b,
                       head_aligned(x, w))
    if route != "gemv":
        raise ValueError(f"K1's head form takes aligned bf16 operands of at "
                         f"most {K1_DECODE_ROWS} rows and k % "
                         f"{K1_GEMV_UNIT} == 0; {tuple(x.shape)} {x.dtype} "
                         f"x {tuple(w.shape)} {w.dtype} (transpose_b="
                         f"{transpose_b}) is K9's (ops.head_route)")
    nsplit = gemv_splits(m, n, k, h)
    out = torch.empty((h, m, n), device=x.device, dtype=torch.float32)
    ws = torch.empty((nsplit, h, m, n), device=x.device,
                     dtype=torch.float32) if nsplit > 1 else None
    # the stride of an axis of one element is never stepped
    st = lambda t, i: t.stride(i) if t.shape[i] > 1 else 0
    _launch("repro_head_gemm", x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), h, m, n, k,
            int(transpose_b), nsplit, st(x, 0), st(x, 1), st(w, 0),
            st(w, 1))
    LAUNCHES["K1"] += 1
    return out


def _head_product(x: torch.Tensor, w: torch.Tensor,
                  transpose_b: bool = False) -> torch.Tensor:
    """The f32 head form through K1 (CUDA) or its plain version."""
    if _use_kernel(x, w):
        return _head_gemm(x, w, transpose_b)
    return ref.head_gemm(x, w, transpose_b)


@functools.lru_cache(maxsize=256)
def _head_expr(h: int, m: int, k: int, n: int, transpose_b: bool):
    return E.head_gemm_expr(h, m, k, n, transpose_b=transpose_b)


def head_matmul(x: torch.Tensor, w: torch.Tensor, *,
                transpose_b: bool = False, out_dtype=None,
                hardware: HardwareShape = H100) -> torch.Tensor:
    """Per-head contraction ``bshk,khn->bshn`` (``bshk,nhk->bshn`` with
    ``transpose_b``), MLA decode's absorbed products
    (``repro.kernels.ops.head_matmul``): the MoA expression
    ``head_gemm_expr`` through :func:`apply`, the head axis one more lift
    of the blocked product.  The head-middle weight is read in its stored
    layout, a strided view of the ``(kv_rank, heads, dim)`` table included
    (no per-step relayout copy), on K1's head form or K9 by
    :func:`head_route`; accumulated in f32, returned in ``out_dtype``
    (default ``x.dtype``)."""
    b, s, h, kdim = x.shape
    if transpose_b:
        n, h2, k2 = w.shape
    else:
        k2, h2, n = w.shape
    if h2 != h or k2 != kdim:
        raise ValueError(f"head_matmul mismatch {tuple(x.shape)} . "
                         f"{tuple(w.shape)}{'.T' if transpose_b else ''}")
    y = apply(_head_expr(h, b * s, kdim, n, bool(transpose_b)),
              x.reshape(b * s, h, kdim), w, out_dtype=torch.float32,
              hardware=hardware)                        # (h, b*s, n)
    return y.transpose(0, 1).reshape(b, s, h, n).to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# K2: attention (prefill and training forward); K3, K4: its backward
# ---------------------------------------------------------------------------

def _check_attention(q, k, v, causal, window, prefix_len) -> None:
    # the reference's honor-or-raise contract (emit.py:289-292): a window
    # or a prefix is a refinement of the causal mask
    if not causal and (window or prefix_len):
        raise ValueError(f"window={window} / prefix_len={prefix_len} "
                         f"require causal attention")
    b, sq, kv, g, hd = q.shape
    if k.shape[0] != b or k.shape[2] != kv or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"attention shape mismatch q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")


#: the (q.k width, value width) pairs K2-K4 are built for
#: (``REPRO_FLASH_WIDTHS`` in ``csrc/hopper.cuh``): MLA's (96, 64) beside
#: the equal widths
FLASH_WIDTHS = ((64, 64), (128, 128), (256, 256), (96, 64))
#: the widest q.k or value width K2-K4 take (one wgmma's N)
FLASH_MAX_WIDTH = 256


def flash_widths(hd: int, vd: int) -> tuple[int, int]:
    """The pair of :data:`FLASH_WIDTHS` that K2-K4 run a q.k width ``hd``
    and value width ``vd`` at: the pair itself where it is built, else the
    smallest built pair that covers both (least ``hd + vd``), to which
    ``ops`` zero-pads the operands (exact: a zero column adds nothing to a
    score, and the padded output columns are cut off).  Widths above 256
    raise: that is a form the port does not build."""
    if (hd, vd) in FLASH_WIDTHS:
        return hd, vd
    if min(hd, vd) < 1 or max(hd, vd) > FLASH_MAX_WIDTH:
        raise ValueError(f"K2-K4 take q.k and value widths from 1 to "
                         f"{FLASH_MAX_WIDTH}, got (hd, vd) = ({hd}, {vd}): "
                         f"wider heads are a flash form the port does not "
                         f"build")
    return min((p for p in FLASH_WIDTHS if p[0] >= hd and p[1] >= vd),
               key=lambda p: (p[0] + p[1], p[0]))


def _pad_width(t: torch.Tensor, width: int) -> torch.Tensor:
    if t.shape[-1] == width:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def _check_flash(what: str, tensors, hd: int, vd: int) -> int:
    """The dtype code of K2-K4's operands: ``tensors[:2]`` (q, k) of
    width ``hd``, the rest (v, dO) of width ``vd``, ``(hd, vd)`` a built
    pair, one dtype, contiguous and 16-byte aligned."""
    # the common case in one pass over the operands (host time of small
    # calls); anything off falls through to the checks that name it
    code = _DTYPE_CODE.get(tensors[0].dtype)
    if code is not None and (hd, vd) in FLASH_WIDTHS:
        for i, t in enumerate(tensors):
            if t.dtype != tensors[0].dtype or \
                    t.shape[-1] != (hd if i < 2 else vd) or \
                    not t.is_contiguous() or t.data_ptr() % 16:
                break
        else:
            return code
    dtype = _check_kernel_dtype(what, *tensors)
    if (hd, vd) not in FLASH_WIDTHS or \
            any(t.shape[-1] != (hd if i < 2 else vd)
                for i, t in enumerate(tensors)):
        raise ValueError(f"{what} kernel takes (hd, vd) in {FLASH_WIDTHS} "
                         f"(q, k at hd; v, dO at vd), got "
                         f"{[tuple(t.shape) for t in tensors]}")
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


def _flash_fwd(q, k, v, scale, causal, window, prefix_len, export: bool):
    """K2 or its plain version: ``out``, plus ``(m, l)`` when ``export``."""
    if not _use_kernel(q, k, v):
        args = dict(scale=scale, causal=causal, window=window,
                    prefix_len=prefix_len)
        if export:
            return ref.attention_stats(q, k, v, **args)
        return ref.attention(q, k, v, **args)
    b, sq, kv, g, hd = q.shape
    vd = v.shape[-1]
    wide = flash_widths(hd, vd)
    if wide != (hd, vd):
        res = _flash_fwd(_pad_width(q, wide[0]), _pad_width(k, wide[0]),
                         _pad_width(v, wide[1]), scale, causal, window,
                         prefix_len, export)
        return (res[0][..., :vd], *res[1:]) if export else res[..., :vd]
    dtype = _check_flash("flash_fwd", (q, k, v), hd, vd)
    out = torch.empty((b, sq, kv * g, vd), device=q.device, dtype=q.dtype)
    m = l = None
    if export:
        m = torch.empty((b, kv, g, sq), device=q.device, dtype=torch.float32)
        l = torch.empty_like(m)
    _launch("repro_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), m.data_ptr() if export else None,
            l.data_ptr() if export else None, b, sq, k.shape[1], kv, g, hd,
            vd, float(scale), int(causal), int(window), int(prefix_len),
            dtype)
    LAUNCHES["K2"] += 1
    return (out, m, l) if export else out


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's derived VJP
    (``_flash_grouped_fwd``/``_flash_grouped_bwd``): the forward runs K2
    with the (m, l) export and saves ``(q, k, v, out, m, l)``; the
    backward computes ``delta = rowsum(dO * out)`` in plain PyTorch (the
    reference's one jnp reduction) and runs K3 for dq and K4 for dk, dv,
    the latter already summed over the query heads of each KV head.  q
    and k keep their width hd, v, out and dO theirs, vd; a pair that is
    not built is padded once, in :func:`attention`, before this."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, prefix_len):
        out, m, l = _flash_fwd(q, k, v, scale, causal, window, prefix_len,
                               export=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (scale, causal, window, prefix_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        scale, causal, window, prefix_len = ctx.args
        b, sq, kv, g, _ = q.shape
        do = dout.contiguous().reshape(b, sq, kv, g, -1)
        delta = (do.float() * out.reshape(do.shape).float()).sum(-1)
        delta = delta.permute(0, 2, 3, 1).contiguous()     # (b, kv, g, sq)
        args = dict(scale=scale, causal=causal, window=window,
                    prefix_len=prefix_len)
        dq = flash_dq(q, k, v, do, m, l, delta, **args)
        dk, dv = flash_dkv(q, k, v, do, m, l, delta, **args)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = True, window: int = 0,
              prefix_len: int = 0) -> torch.Tensor:
    """Grouped-query attention, the flash forward.

    ``q (B, Sq, KV, G, hd)`` (K/V heads never repeated), ``k (B, Sk, KV,
    hd)``, ``v (B, Sk, KV, vd)`` -> ``(B, Sq, KV*G, vd)`` in ``q.dtype``;
    on the card ``(hd, vd)`` runs at :func:`flash_widths`' pair.
    ``causal=False`` is the bidirectional form (any Sq, Sk: the encoder,
    cross-attention); ``window`` (causal only) drops keys more than
    ``window`` behind the query; ``prefix_len`` (causal only, the
    prefix-LM) makes the leading
    ``prefix_len`` positions attend to each other both ways.
    Differentiable: when a gradient is wanted the forward exports (m, l)
    and the backward runs K3 and K4."""
    _check_attention(q, k, v, causal, window, prefix_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        hd, vd = q.shape[-1], v.shape[-1]
        wide = flash_widths(hd, vd) if _use_kernel(q, k, v) else (hd, vd)
        out = _FlashAttention.apply(
            _pad_width(q, wide[0]), _pad_width(k, wide[0]),
            _pad_width(v, wide[1]), float(scale), bool(causal), int(window),
            int(prefix_len))
        return out if wide[1] == vd else out[..., :vd]
    return _flash_fwd(q, k, v, scale, causal, window, prefix_len,
                      export=False)


def attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = 0,
                    prefix_len: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 with its state export: ``(out, m, l)``, ``out`` as
    :func:`attention` returns it (the same bits), ``m, l (B, KV, G, Sq)``
    f32 the final running max and denominator of each row."""
    _check_attention(q, k, v, causal, window, prefix_len)
    return _flash_fwd(q, k, v, scale, causal, window, prefix_len,
                      export=True)


def _bwd_args(what, q, k, v, do, m, l, delta):
    b, sq, kv, g, hd = q.shape
    if do.shape != q.shape[:4] + (v.shape[-1],):
        raise ValueError(f"{what}: dO {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)} / v {tuple(v.shape)}")
    dtype = _check_flash(what, (q, k, v, do), hd, v.shape[-1])
    _check_stats(what, (b, kv, g, sq), m, l, delta)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            m.data_ptr(), l.data_ptr(), delta.data_ptr()), dtype


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
             delta: torch.Tensor, *, scale: float, causal: bool = True,
             window: int = 0, prefix_len: int = 0) -> torch.Tensor:
    """K3: dq ``(B, Sq, KV, G, hd)`` in ``q.dtype`` from ``do (B, Sq, KV,
    G, vd)`` and the saved ``m, l`` with ``delta = rowsum(dO * out)``, all
    three ``(B, KV, G, Sq)`` f32; the mask as :func:`attention`'s."""
    _check_attention(q, k, v, causal, window, prefix_len)
    if not _use_kernel(q, k, v, do, m, l, delta):
        return ref.flash_dq(q, k, v, do, m, l, delta, scale=scale,
                            causal=causal, window=window,
                            prefix_len=prefix_len)
    b, sq, kv, g, hd = q.shape
    vd = v.shape[-1]
    wide = flash_widths(hd, vd)
    if wide != (hd, vd):
        return flash_dq(_pad_width(q, wide[0]), _pad_width(k, wide[0]),
                        _pad_width(v, wide[1]), _pad_width(do, wide[1]), m,
                        l, delta, scale=scale, causal=causal, window=window,
                        prefix_len=prefix_len)[..., :hd]
    ptrs, dtype = _bwd_args("flash_dq", q, k, v, do, m, l, delta)
    dq = torch.empty_like(q)
    _launch("repro_flash_dq", *ptrs, dq.data_ptr(), b, sq, k.shape[1], kv,
            g, hd, vd, float(scale), int(causal), int(window),
            int(prefix_len), dtype)
    LAUNCHES["K3"] += 1
    return dq


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
              delta: torch.Tensor, *, scale: float, causal: bool = True,
              window: int = 0, prefix_len: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(dk, dv)``, ``(B, Sk, KV, hd)`` and ``(B, Sk, KV, vd)`` in
    k's / v's dtype,
    summed over the G query heads that share each KV head; the mask as
    :func:`attention`'s."""
    _check_attention(q, k, v, causal, window, prefix_len)
    if not _use_kernel(q, k, v, do, m, l, delta):
        return ref.flash_dkv(q, k, v, do, m, l, delta, scale=scale,
                             causal=causal, window=window,
                             prefix_len=prefix_len)
    b, sq, kv, g, hd = q.shape
    vd = v.shape[-1]
    wide = flash_widths(hd, vd)
    if wide != (hd, vd):
        dk, dv = flash_dkv(_pad_width(q, wide[0]), _pad_width(k, wide[0]),
                           _pad_width(v, wide[1]), _pad_width(do, wide[1]),
                           m, l, delta, scale=scale, causal=causal,
                           window=window, prefix_len=prefix_len)
        return dk[..., :hd], dv[..., :vd]
    ptrs, dtype = _bwd_args("flash_dkv", q, k, v, do, m, l, delta)
    sk = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # the tensor-core form (bf16, G dividing its row tile) with its row
    # stream split over nsplit blocks a key tile, whose f32 partials a
    # second pass sums in split order; nsplit = 0 takes the FMA kernel
    nsplit = dkv_splits(b, sq, sk, kv, g, bool(causal), int(window),
                        int(prefix_len)) \
        if dtype == 1 and DKV_ROWS % g == 0 else 0
    # the partials: nsplit dk planes (B, Sk, KV, hd), then nsplit dv
    # planes of vd
    ws = torch.empty(nsplit * b * sk * kv * (hd + vd), device=q.device,
                     dtype=torch.float32) if nsplit > 1 else None
    _launch("repro_flash_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(),
            None if ws is None else ws.data_ptr(), b, sq, sk, kv, g, hd, vd,
            float(scale), int(causal), int(window), int(prefix_len), dtype,
            nsplit)
    LAUNCHES["K4"] += 1
    return dk, dv


#: K4's tensor-core blocks: keys of a block, streamed rows of a tile
DKV_KEYS = DKV_ROWS = 64


def dkv_row_tiles(j0: int, sq: int, sk: int, g: int, causal: bool,
                  window: int, prefix_len: int = 0) -> tuple[int, int]:
    """``(first, count)``: the 64-row tiles of the streamed (position,
    group head) rows that can see a key of the tile starting at ``j0``
    (the kernel's ``dkv_row_tiles``): the forward's causal, window and
    prefix block-skip with the roles swapped (a key tile that starts below
    the prefix is seen from row 0)."""
    rows = sq * g
    rstart, rend = 0, rows
    if causal:
        rstart = j0 * g
        if window > 0:
            jmax = min(sk, j0 + DKV_KEYS) - 1
            rend = min(rows, (jmax + window) * g)
        if j0 < prefix_len:
            rstart = 0
            rend = max(rend, min(rows, prefix_len * g))
    t0 = rstart // DKV_ROWS
    return t0, max(0, -(-rend // DKV_ROWS) - t0)


@functools.lru_cache(maxsize=256)
def dkv_splits(b: int, sq: int, sk: int, kv: int, g: int, causal: bool,
               window: int, prefix_len: int = 0) -> int:
    """How many blocks share each key tile's row stream in K4's
    tensor-core form: enough for two blocks a SM over the grid, at most a
    key tile's row tiles.  Split ``s`` of a key tile with ``count`` row
    tiles takes ``[first + s * per, first + min(count, (s + 1) * per))``,
    ``per = ceil(count / nsplit)``."""
    key_tiles = -(-sk // DKV_KEYS)
    most = max((dkv_row_tiles(j * DKV_KEYS, sq, sk, g, causal, window,
                              prefix_len)[1]
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


def default_ssd_chunk(s: int, h: int, p: int, n: int, dtype="float32",
                      hardware: HardwareShape = H100) -> int:
    """The derived SSD chunk length (``repro.kernels.ops.default_ssd_chunk``,
    its formula verbatim): ``solve_recurrence_blocks`` with the carried
    ``(h, p, n)`` state (and the entering state operand), the
    double-buffered per-token operands and the quadratic segsum
    intermediates (scores and the per-head decay mask) in the working-set
    model, on ``hardware`` (the H100 table by default).  On the H100's 227
    KB of shared memory mamba2-780m's 3 MB carried state fits no chunk,
    and the solver returns its smallest aligned chunk, 16."""
    return solve_recurrence_blocks(
        s,
        token_elems=2 * n + h * (p + 1) + h * p,     # B, C, x, dA in + y out
        state_elems=2 * h * p * n,                   # carried h + H0 operand
        quad_elems=1 + h,                            # scores G + decay L
        lin_elems=4 * h,                             # cumsum/decay vectors
        dtype=dtype, hardware=hardware).bs


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
    per-chunk entering states and the backward runs K7.  ``chunk=None``
    derives the chunk on the H100 table (:func:`default_ssd_chunk`), as
    the reference derives it on its own."""
    b, s, h, p = xdt.shape
    if chunk is None:
        chunk = default_ssd_chunk(s, h, p, B.shape[-1],
                                  str(xdt.dtype).removeprefix("torch."))
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

#: the longest chunk K8 takes (it stages a chunk 64 steps at a time)
GATED_MAX_CHUNK = 1024


def default_gated_chunk(s: int, w: int, dtype="float32",
                        hardware: HardwareShape = H100) -> int:
    """The derived RG-LRU chunk length (``repro.kernels.ops.
    default_gated_chunk``, its formula verbatim): per-channel state, three
    per-token streams (gate log, input, output) and linear scan
    intermediates in ``solve_recurrence_blocks``'s working-set model, on
    ``hardware`` (the H100 table by default: 16 at recurrentgemma-9b's
    width 4096).  Chunk ``c`` covers steps ``[c L, min(s, (c + 1) L))``."""
    return solve_recurrence_blocks(
        s, token_elems=3 * w, state_elems=2 * w, quad_elems=0,
        lin_elems=2 * w, dtype=dtype, hardware=hardware).bs


def gated_recurrence(log_a: torch.Tensor, b_in: torch.Tensor,
                     h0: torch.Tensor | None = None, reverse: bool = False,
                     chunk: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8 or its plain version: ``h_t = exp(log_a_t) h_{t-1} + b_t`` over
    ``log_a/b_in (B, S, w)`` f32 contiguous, from ``h0 (B, w)`` (zeros when
    None); ``reverse`` walks backwards with the gate one step ahead (see
    ``ref.gated_scan``).  Returns ``(h (B, S, w), final (B, w))`` f32.  The
    kernel takes any ``S`` and ``w`` without padding, in chunks of
    ``chunk`` steps (``None``: :func:`default_gated_chunk`; at most ``S``
    and ``GATED_MAX_CHUNK``; the last chunk and channel strip may be
    short).  The plain walk takes no chunk."""
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
    if chunk is None:
        chunk = default_gated_chunk(s, w)
    chunk = max(1, min(int(chunk), s))
    if chunk > GATED_MAX_CHUNK:
        raise ValueError(f"gated_scan kernel takes chunks of at most "
                         f"{GATED_MAX_CHUNK} steps, got {chunk}")
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
    def forward(ctx, log_a, b_in, h0, chunk):
        h, final = gated_recurrence(log_a, b_in, h0, chunk=chunk)
        ctx.save_for_backward(log_a, h0, h)
        ctx.chunk = chunk
        return h, final

    @staticmethod
    def backward(ctx, gy, gfin):
        log_a, h0, h = ctx.saved_tensors
        dy = gy.float().clone(memory_format=torch.contiguous_format)
        dy[:, -1] += gfin.float()
        dbar, _ = gated_recurrence(log_a, dy, reverse=True, chunk=ctx.chunk)
        a = torch.exp(log_a.float())
        first = h.new_zeros(h[:, :1].shape) if h0 is None else \
            h0.float()[:, None]
        h_prev = torch.cat([first, h[:, :-1]], dim=1)
        dlog_a = (dbar * a * h_prev).to(log_a.dtype)
        dh0 = None
        if h0 is not None and ctx.needs_input_grad[2]:
            dh0 = (a[:, 0] * dbar[:, 0]).to(h0.dtype)
        return dlog_a, dbar, dh0, None


def gated_scan(log_a: torch.Tensor, b_in: torch.Tensor, *,
               init_state: torch.Tensor | None = None,
               chunk: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU gated linear scan (``repro.kernels.ops.gated_scan``):
    ``h_t = exp(log_a_t) h_{t-1} + b_t`` over ``log_a/b_in (B, S, w)`` f32
    from ``init_state (B, w)`` f32 (zeros when None).  Returns ``(h (B, S,
    w), final (B, w))`` f32, at any ``S``.  K8 runs in chunks of ``chunk``
    steps, derived on the H100 table when None (:func:`default_gated_chunk`,
    the reference's derivation on its own table).  Differentiable in all
    three inputs: the backward runs K8's reverse walk (the reference's
    ``gated_backward`` kind) at the same chunk."""
    if chunk is None:
        chunk = default_gated_chunk(log_a.shape[1], log_a.shape[2],
                                    str(log_a.dtype).removeprefix("torch."))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (log_a, b_in, init_state)):
        return _GatedScan.apply(log_a, b_in, init_state, chunk)
    return gated_recurrence(log_a, b_in, init_state, chunk=chunk)


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
    lifted expert axis of ``expert_gemm_expr``: ``batched`` True); or
    ``(False, transpose_b, "head")`` for a stack over an axis in the
    middle of both stored leaves, x ``(m, h, k)`` and w ``(k, h, n)`` or
    ``(n, h, k)`` (the lifted head axis of ``head_gemm_expr``); None
    otherwise."""
    if (nf.combine, nf.reduce_op) != ("mul", "add") or \
            len(nf.leaves) != 2 or len(nf.out_axes) not in (2, 3) or \
            len(nf.reduce_axes) != 1:
        return None
    batched = len(nf.out_axes) == 3
    lead = nf.out_axes[:1] if batched else ()
    (i, j), k = nf.out_axes[-2:], nf.reduce_axes[0]
    stored = []
    for leaf in nf.leaves:
        syms = tuple(t for t, _ in leaf.dims)
        stored.append(syms[::-1] if leaf.layout == "col" else syms)
    if batched and stored[0] == (i, lead[0], k) and \
            stored[1] in ((k, lead[0], j), (j, lead[0], k)):
        return (False, stored[1][0] == j, "head")
    flags = []
    for syms, rows in zip(stored, (i, k)):
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
    (``aligned``: every base 16-byte aligned), a head form (``batched``
    ``"head"``) where :func:`head_route` does (``aligned``: the views'
    strides as :func:`head_aligned` reads them), else K9.  A form with a
    float16 operand takes K9 (K1 has no float16 form; K9 loads float16
    beside f32 and bf16 under its f32 accumulator).  An accumulator other
    than f32 or int32 (a table's bf16) raises: no kernel has one.  int8 operands take an
    int32 accumulator only (an f32 accumulator would round past 2^24), on
    (mul, add) only: any other raises.  K1's int8 form sums the 2-D and
    expert products exactly; every other int8 form (the head form, every
    K9 path) takes K9's integer accumulator, exact too."""
    block_key = blocks.as_tuple() if hasattr(blocks, "as_tuple") else (
        tuple(blocks) if isinstance(blocks, (list, tuple)) else blocks)
    key = (nf.key(), dtypes, out_dtype, hardware.name, block_key, acc_dtype,
           aligned)
    with _PLANS_LOCK:
        plan = _PLANS.get(key)
        if plan is not None:
            _PLANS.move_to_end(key)
            return plan
    if "int8" in dtypes and acc_dtype != "int32":
        raise ValueError(
            f"int8 operands accumulate in int32 (exact), not in "
            f"{acc_dtype}: pass acc_dtype='int32'")
    # K9 contracts a chain pairwise and reads no schedule blocks (the
    # derived working set models the reference's nest, which the H100's
    # 227 KB refuse for tropical chains from a few dozen elements on): a
    # chain takes the semiring's inert element for its padding
    chain = emit.is_chain(nf)
    if chain:
        # the schedule's own check of the (input, accumulator, semiring)
        # triple, which a chain does not derive
        for dt in set(dtypes):
            semiring.check_accum(acc_dtype, dt, nf.combine, nf.reduce_op)
    bundle = None if chain else sched_mod.get_schedule(
        nf, dtype=dtypes[0], hardware=hardware, blocks=blocks,
        acc_dtype=acc_dtype)
    if acc_dtype not in ("float32", "int32"):
        # a table with a narrower accumulator (the v5e's bf16) derives it;
        # K1 and K9 have none, and would not honour the bundle
        raise ValueError(
            f"K1 and K9 accumulate in float32 (int32 for int8 operands); "
            f"a {acc_dtype} accumulation has no kernel path")
    flags = None if "float16" in dtypes else _k1_form(nf)
    if flags is not None and flags[2] == "head":
        (m, h, k), w_shape = nf.leaf_storage_shapes()
        n = w_shape[0] if flags[1] else w_shape[2]
        if head_route(h, m, k, n, *dtypes[:2], flags[1], aligned) == "K9":
            flags = None
    elif flags is not None and flags[2]:
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
    # the kernel writes what its accumulator stores (int32 or f32 from
    # int32; f32, bf16 or f16 from f32), other dtypes by a cast after
    outs = emit.INT_OUT_DTYPES if emit.k9_acc(
        dtypes, launch.combine, launch.reduce_op) == torch.int32 \
        else emit.FLOAT_DTYPES
    k_dtype = out_dtype if out_dtype in outs else outs[0]
    emit.check_scratch(launch, torch.cuda.get_device_properties(
        dev).total_memory)
    scratch = [torch.empty(n, device=dev, dtype=torch.float32) if n else None
               for n in (launch.tmp_elems, launch.work_elems)]
    descs = launch.c_descs(dtypes, k_dtype, ptrs, scratch[0].data_ptr()
                           if scratch[0] is not None else 0)
    out = torch.empty(launch.out_shape, device=dev, dtype=k_dtype)
    ins = (ctypes.c_void_p * len(ptrs))(*ptrs)
    if out.numel():
        _launch("repro_semiring", ctypes.addressof(descs), len(descs),
                ctypes.addressof(ins), len(ptrs), out.data_ptr(),
                *(None if t is None else t.data_ptr() for t in scratch),
                emit.COMBINE_CODE[launch.combine],
                emit.REDUCE_CODE[launch.reduce_op])
        LAUNCHES["K9"] += 1
    return out.to(out_dtype)


def apply(expr: "E.Expr", *arrays: torch.Tensor, out_dtype=None,
          blocks=None, acc_dtype: str = "float32",
          hardware: HardwareShape = H100, mesh=None, shard=None,
          replicate_out: bool = False, scatter_axis=None,
          verify=False) -> torch.Tensor:
    """Evaluate a composed MoA expression (``repro.kernels.ops.apply``).

    ``arrays`` bind the expression's leaves in composition order by their
    *storage* shapes: a row-major leaf takes its logical shape, a
    column-major leaf the reversed (physical buffer) shape, so
    ``transpose(arr((n, k)))`` and ``arr((k, n), layout="col")`` bind the
    same ``(n, k)`` array, as they share a normal form.  The normal form is
    scheduled on ``hardware`` (cached per normal form) and run on K1 or K9
    (CUDA tensors) or their plain versions (CPU tensors); the result is in
    ``out_dtype`` (default the first array's dtype), accumulated in
    ``acc_dtype``: f32, or int32 for int8 operands under (mul, add),
    summed exactly by K1's int8 form (a 2-D product, either operand
    transposed, or the expert form) or by K9's integer accumulator (every
    other form).  float16 operands run on K9 under the f32 accumulator.
    A strided view binds like its contiguous copy: it is copied first,
    but by K1's head form, which reads it in place.

    With ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``) the normal
    form is lifted one level further: ``shard`` maps its axis symbols to
    mesh axes, and the derived ``DistributedPlan``
    (``distributed.plan.derive_plan``; ``replicate_out`` and
    ``scatter_axis`` as there) runs through ``emit.emit_shard_map``: each
    rank runs the per-shard normal form on the same route as here, then
    the plan's collectives.  Operands are DTensors placed as the plan
    reads them, or whole tensors every rank holds; the result is a
    DTensor placed as the plan leaves it.  ``blocks=`` is refused there:
    the plan derives the per-shard blocks.

    ``verify=True`` runs the static verifier (``repro_torch.analysis.
    verify_expr``, or ``verify_sharded`` on the mesh path) on the derived
    schedule before the launch and raises ``VerificationError`` on an
    error finding; ``verify="kernel"`` also checks the launch plan
    (``analysis.conformance``: K1's route, K9's descriptor; single-device
    path only).  Both cache on the schedule's key, so a repeated call
    pays a dictionary lookup.
    """
    nf = E.normal_form(expr)
    if mesh is not None or shard is not None:
        if mesh is None:
            raise ValueError("apply(shard=...) needs a mesh")
        if blocks is not None:
            raise ValueError(
                "apply(mesh=...) derives per-shard blocks from the plan; "
                "pinning blocks= is not supported on the sharded path")
        _check_leaves(nf, arrays)
        dtype_s = str(arrays[0].dtype).removeprefix("torch.")
        if verify:
            from repro_torch import analysis
            analysis.verify_sharded(nf, mesh, shard or {}, hardware=hardware,
                                    dtype=dtype_s,
                                    replicate_out=replicate_out,
                                    scatter_axis=scatter_axis,
                                    acc_dtype=acc_dtype)
        fn = _sharded_callable(nf, dtype_s, out_dtype or arrays[0].dtype,
                               hardware, mesh, shard or {}, replicate_out,
                               scatter_axis, acc_dtype)
        return fn(*arrays)
    return apply_normal_form(nf, *arrays, out_dtype=out_dtype, blocks=blocks,
                             acc_dtype=acc_dtype, hardware=hardware,
                             verify=verify)


def _check_leaves(nf: "E.NormalForm", arrays) -> None:
    shapes = nf.leaf_storage_shapes()
    if len(arrays) != len(shapes):
        raise ValueError(f"expression has {len(shapes)} leaves, got "
                         f"{len(arrays)} arrays")
    for i, (a, s) in enumerate(zip(arrays, shapes)):
        if tuple(a.shape) != s:
            raise ValueError(f"leaf {i} ({nf.leaves[i].array!r}) expects "
                             f"storage shape {s}, got {tuple(a.shape)}")


#: memoised sharded executables, per (normal form, mesh, sharding, dtypes)
_SHARDED: "OrderedDict[tuple, object]" = OrderedDict()


def _sharded_callable(nf: "E.NormalForm", dtype_s: str, out_dtype,
                      hardware: HardwareShape, mesh, shard: dict,
                      replicate_out: bool, scatter_axis, acc_dtype: str,
                      local_fn=None, local_tag=None):
    """The memoised ``emit_shard_map`` executable of one (normal form,
    mesh, sharding, dtypes): derives (or re-reads from the plan cache)
    the ``DistributedPlan`` and wraps its collectives around the
    per-shard product (``local_fn``, tagged ``local_tag`` in the key, or
    the normal form's own route).  The gradient axes the active
    ``planned_mesh`` defers are part of the key."""
    from repro_torch.distributed import plan as dplan
    defer = dplan.deferred_axes(mesh)
    key = (nf.key(), dtype_s, str(out_dtype), hardware.name, id(mesh),
           tuple(sorted(shard.items())), bool(replicate_out), scatter_axis,
           str(acc_dtype), local_tag, defer)
    with _PLANS_LOCK:
        fn = _SHARDED.get(key)
        if fn is not None and fn[0] is mesh:
            _SHARDED.move_to_end(key)
            return fn[1]
    plan = dplan.derive_plan(nf, mesh, shard=shard, hardware=hardware,
                             dtype=dtype_s, replicate_out=replicate_out,
                             scatter_axis=scatter_axis, acc_dtype=acc_dtype)
    if local_fn is None:
        local_fn = functools.partial(apply_normal_form, plan.local_nf,
                                     out_dtype=torch.float32,
                                     acc_dtype=acc_dtype, hardware=hardware)
    fn = emit.emit_shard_map(plan, mesh, local_fn, out_dtype=out_dtype,
                             defer=defer)
    with _PLANS_LOCK:
        _SHARDED[key] = (mesh, fn)
        while len(_SHARDED) > _PLANS_SIZE:
            _SHARDED.popitem(last=False)
    return fn


def apply_normal_form(nf: "E.NormalForm", *arrays: torch.Tensor,
                      out_dtype=None, blocks=None, acc_dtype: str = "float32",
                      hardware: HardwareShape = H100,
                      verify=False) -> torch.Tensor:
    """:func:`apply` on a normal form, on one device (the per-shard
    product of a plan runs here)."""
    _check_leaves(nf, arrays)
    out_dtype = out_dtype or arrays[0].dtype
    dtypes = tuple(str(a.dtype).removeprefix("torch.") for a in arrays)
    acc_dtype = str(acc_dtype).removeprefix("torch.")
    head = (_k1_form(nf) or (None,) * 3)[2] == "head"
    if not head:
        # the other kernels read row-major storage buffers: a strided view
        # (a transpose, a slice) is copied, as the reference takes any
        # array
        arrays = tuple(a.contiguous() for a in arrays)
    # K1's head form reads its operands through their strides (a slice of
    # a weight table is not copied)
    aligned = head_aligned(*arrays) if head else all(
        a.data_ptr() % 16 == 0 for a in arrays)
    if verify:
        from repro_torch import analysis
        analysis.verify_expr(nf, dtype=dtypes[0], hardware=hardware,
                             blocks=blocks, acc_dtype=acc_dtype,
                             kernel=verify == "kernel", dtypes=dtypes,
                             aligned=aligned)
    plan = _plan(nf, dtypes, out_dtype, hardware, blocks, acc_dtype, aligned)
    if head:
        if plan[0] == "K1":
            return _head_product(*arrays, plan[2]).to(out_dtype)
        return semiring_contract(plan[1], *(a.contiguous() for a in arrays),
                                 out_dtype=out_dtype)
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
