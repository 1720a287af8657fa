"""Gradient compression for data-parallel reduction
(``repro.distributed.compression``): int8 block quantization with error
feedback, formula for formula.

The compression is a *quantize -> (reduce) -> dequantize* transform of the
gradients, with each leaf's quantization residual carried in the train
state and added back the next step (error feedback keeps the scheme
convergent: the compression error stays bounded, it does not accumulate).

A leaf is quantized in block-aligned slices of its flattened elements
(each a multiple of ``block_size`` long, at most about ``CHUNK``), so the
blocks are the reference's blocks and the f32 temporaries stay bounded:
the MLP's stacked ``wi`` alone has 1.2 B elements at gemma-2b width.  Only
a leaf's last slice is padded.  Like AdamW, :func:`compress_grads` works
IN PLACE: it overwrites the error state and the gradients.

This is elementwise work that the reference computes outside any Pallas
kernel; it runs as plain PyTorch on the gradients' device.

Wire-byte accounting: int8 payload + one f32 scale per block of
``block_size`` values => 4x reduction vs f32 (+1.6% scale overhead)
(:func:`compressed_bytes`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: elements per slice of a leaf, rounded down to a multiple of the block
CHUNK = 1 << 26


class CompressionConfig(NamedTuple):
    enabled: bool = False
    block_size: int = 256


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_error_state(params) -> dict:
    """f32 zeros shaped as each parameter (a ``{name: tensor}`` dict or the
    parameter tree), on its device."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in _named(params).items()}


def _quant_dequant(g: torch.Tensor, block: int) -> torch.Tensor:
    """Each block of ``block`` consecutive elements of ``g`` (flattened,
    the last block zero-padded) rounded to int8 steps of max|block| / 127
    and scaled back, in f32, shaped as ``g``."""
    flat = g.reshape(-1).float()
    n = flat.numel()
    pad = (-n) % block
    fp = (torch.nn.functional.pad(flat, (0, pad)) if pad else flat
          ).reshape(-1, block)
    # a true division by a device tensor: divided by a Python number,
    # PyTorch's CUDA kernel multiplies by the reciprocal, an ulp off the
    # reference's quotient on some blocks
    scale = torch.linalg.vector_norm(fp, float("inf"), dim=1, keepdim=True
                                     ).div_(fp.new_full((), 127.0))
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.div(fp, scale).round_().clamp_(-127, 127).to(torch.int8)
    deq = q.float().mul_(scale)
    return deq.reshape(-1)[:n].reshape(g.shape)


def _slice_len(block: int) -> int:
    return max(CHUNK // block, 1) * block


def compress_grads(cfg: CompressionConfig, grads: dict, err_state: dict
                   ) -> tuple[dict, dict]:
    """``(decompressed grads as seen after the all-reduce, new error
    state)``, both ``{name: tensor}``: per leaf ``gf = g_f32 + e``, the
    gradient becomes ``_quant_dequant(gf)`` in ``g``'s dtype and the error
    ``gf - deq``.  Written in place into ``grads``' and ``err_state``'s
    tensors (a non-contiguous gradient is copied first), which are
    returned.  Disabled, returns its arguments unchanged."""
    if not cfg.enabled:
        return grads, err_state
    n = _slice_len(cfg.block_size)
    out = {}
    with torch.no_grad():
        for name, g in grads.items():
            e = err_state[name]
            g = g.contiguous()
            gv, ev = g.view(-1), e.view(-1)
            for i in range(0, gv.numel(), n):
                gf = gv[i:i + n].float() + ev[i:i + n]     # error feedback
                deq = _quant_dequant(gf, cfg.block_size)
                torch.sub(gf, deq, out=ev[i:i + n])
                gv[i:i + n].copy_(deq)
            out[name] = g
    return out, err_state


def compressed_bytes(n_params: int, block_size: int = 256) -> int:
    """Wire bytes for one compressed DP reduction of n_params f32 grads."""
    return n_params + (n_params // block_size) * 4


def _block_aligned(shape, placements, mesh, block: int) -> bool:
    """True when every contiguous run of a rank's chunk in the whole
    leaf's flat order is a multiple of ``block`` long, so the chunk's
    blocks are the whole leaf's."""
    inner = None
    for i, pl in enumerate(placements):
        if pl.is_shard() and mesh.size(i) > 1:
            inner = pl.dim if inner is None else max(inner, pl.dim)
    if inner is None:
        return True
    c = shape[inner]
    for i, pl in enumerate(placements):
        if pl.is_shard() and pl.dim == inner:
            c //= mesh.size(i)
    run = c
    for s in shape[inner + 1:]:
        run *= s
    return run % block == 0


def compress_sharded(cfg: CompressionConfig, grads: dict, err_state: dict,
                     shapes: dict, placements: dict, mesh
                     ) -> tuple[dict, dict]:
    """:func:`compress_grads` on this rank's chunks of sharded leaves
    (``shapes``: each whole leaf's shape; ``placements``: its DTensor
    placements on ``mesh``), with the whole leaf's blocks: a chunk whose
    runs are whole blocks (``_block_aligned``) is compressed where it is;
    any other leaf's gradient and error are gathered, compressed whole
    (every rank alike) and cut back to the chunk.  In place, as
    :func:`compress_grads`."""
    from repro_torch.distributed import comm
    if not cfg.enabled:
        return grads, err_state
    for name, g in grads.items():
        pl = placements[name]
        if _block_aligned(shapes[name], pl, mesh, cfg.block_size):
            grads[name] = compress_grads(cfg, {name: g},
                                         {name: err_state[name]})[0][name]
            continue
        full_g = comm.gather_full(g, mesh, pl)
        full_e = comm.gather_full(err_state[name], mesh, pl)
        compress_grads(cfg, {name: full_g}, {name: full_e})
        with torch.no_grad():
            g.copy_(comm.local_chunk(full_g, mesh, pl))
            err_state[name].copy_(comm.local_chunk(full_e, mesh, pl))
    return grads, err_state
