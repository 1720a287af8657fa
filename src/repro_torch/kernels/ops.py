"""Model-facing kernel entries: the same signatures and layouts as the JAX
package's ``repro.kernels.ops``, each backed by a hand-written CUDA kernel.

Dispatch is by the device of the tensors: a CUDA tensor launches the
kernel (and counts the launch in ``LAUNCHES``), a CPU tensor computes the
plain PyTorch version from ``kernels/ref.py``, anything else raises.  There
is no fallback: a kernel that cannot take its inputs raises.  Inside
:func:`reference_mode` every tensor takes the plain version, which is how
``chip_smoke.py`` computes the reference it holds the kernels against on
the card.

================  =======================  =============================
entry             kernel (``csrc/``)       replaces (``repro``)
================  =======================  =============================
``matmul``        K1 ``gemm.cu``           ``emit_pallas`` (mul, add)
``attention``     K2 ``flash_fwd.cu``      ``emit._softmax_kind``
``paged_decode_   K5 ``paged_decode.cu``   ``emit._windowed_decode_kind``
batched``
================  =======================  =============================
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.core.blocking import solve_recurrence_blocks
from repro_torch.hardware import H100
from repro_torch.kernels import build, ref

#: kernel launches since import (or the caller's last reset), by kernel id;
#: a wrapper adds one exactly where it launches its kernel
LAUNCHES = {"K1": 0, "K2": 0, "K5": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN = False
_C = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {
    "gemm": ("repro_gemm", [_P, _P, _P, _C, _C, _C, _C, _C, _C, _C, _P]),
    "flash_fwd": ("repro_flash_fwd", [_P, _P, _P, _P, _C, _C, _C, _C, _C,
                                      _C, ctypes.c_float, _C, _C, _C, _P]),
    "paged_decode": ("repro_paged_decode", [_P, _P, _P, _P, _P, _P, _C, _C,
                                            _C, _C, _C, _C, ctypes.c_float,
                                            _C, _C, _P]),
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


def _entry(lib: str):
    name, argtypes = _SIGNATURES[lib]
    handle = build.load(lib)
    fn = getattr(handle, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        handle.repro_error_string.argtypes = [ctypes.c_int]
        handle.repro_error_string.restype = ctypes.c_char_p
    return fn, handle


def _launch(lib: str, *args) -> None:
    fn, handle = _entry(lib)
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = handle.repro_error_string(code).decode()
        raise RuntimeError(f"{lib} kernel launch failed: {msg} ({code})")


def _check_kernel_dtype(what: str, *tensors: torch.Tensor) -> int:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 operands "
                        f"of one dtype, got {sorted(map(str, dtypes))}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous operands")
    return _DTYPE_CODE[tensors[0].dtype]


def _aligned16(t: torch.Tensor, row: int) -> bool:
    return t.data_ptr() % 16 == 0 and (row * t.element_size()) % 16 == 0


# ---------------------------------------------------------------------------
# K1: matmul
# ---------------------------------------------------------------------------

def _gemm(x2: torch.Tensor, w2: torch.Tensor, transpose_b: bool
          ) -> torch.Tensor:
    """Launch K1 on 2-D operands; returns the f32 ``(m, n)`` product."""
    dtype = _check_kernel_dtype("gemm", x2, w2)
    m, k = x2.shape
    n = w2.shape[0] if transpose_b else w2.shape[1]
    out = torch.empty((m, n), device=x2.device, dtype=torch.float32)
    if m and n:
        vec_a = _aligned16(x2, k)
        vec_b = _aligned16(w2, k if transpose_b else n)
        _launch("gemm", x2.data_ptr(), w2.data_ptr(), out.data_ptr(), m, n,
                k, int(transpose_b), dtype, int(vec_a), int(vec_b))
        LAUNCHES["K1"] += 1
    return out


def matmul(x: torch.Tensor, w: torch.Tensor, *, transpose_b: bool = False,
           out_dtype=None) -> torch.Tensor:
    """``y[..., :] = x[..., k] @ w[k, ...]``, accumulated and returned in
    f32, then cast to ``out_dtype`` (default ``x.dtype``).

    Leading dims of ``x`` and trailing dims of ``w`` collapse to one 2-D
    product.  ``transpose_b`` contracts against the stored layout of a
    ``(..., k)`` weight, ``y = x @ w.T``, with no transpose copy (the tied
    logits head)."""
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
    x2 = x.reshape(-1, kdim)
    if _use_kernel(x2, w2):
        y = _gemm(x2, w2, transpose_b)
    else:
        y = ref.matmul(x2, w2, transpose_b)
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], *out_tail)


# ---------------------------------------------------------------------------
# K2: attention (prefill)
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = True, window: int = 0,
              prefix_len: int = 0) -> torch.Tensor:
    """Grouped-query attention, the flash forward.

    ``q (B, Sq, KV, G, hd)`` (K/V heads never repeated), ``k/v (B, Sk, KV,
    hd)`` -> ``(B, Sq, KV*G, hd)`` in ``q.dtype``.  ``window`` (causal
    only) drops keys more than ``window`` behind the query."""
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
    if not _use_kernel(q, k, v):
        return ref.attention(q, k, v, scale=scale, causal=causal,
                             window=window)
    dtype = _check_kernel_dtype("flash_fwd", q, k, v)
    if hd not in (64, 128, 256) or k.shape[-1] != hd or v.shape[-1] != hd:
        raise ValueError(f"flash_fwd kernel takes hd = vd in (64, 128, 256), "
                         f"got q {tuple(q.shape)} v {tuple(v.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd kernel takes 16-byte aligned operands")
    out = torch.empty((b, sq, kv * g, hd), device=q.device, dtype=q.dtype)
    _launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, sq, k.shape[1], kv, g, hd, float(scale),
            int(causal), int(window), dtype)
    LAUNCHES["K2"] += 1
    return out


# ---------------------------------------------------------------------------
# K5: batched paged decode
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
    out = torch.empty((slots, kv, g, hd), device=q.device,
                      dtype=torch.float32)
    _launch("paged_decode", q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), pos.data_ptr(), tables.data_ptr(),
            out.data_ptr(), slots, kv, g, hd, int(page), tables.shape[1],
            float(scale), int(window), dtype)
    LAUNCHES["K5"] += 1
    return out
