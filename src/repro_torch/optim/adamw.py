"""AdamW with f32 master weights, global-norm clipping and decoupled weight
decay (``repro.optim.adamw``), formula for formula.

Mixed precision: model parameters may be bf16; the optimizer keeps f32
masters plus f32 m and v and recasts the updated masters into the
parameter dtype each step.  This is deliberately not ``torch.optim.AdamW``,
which places ``eps`` and the decay differently: here ``eps`` is added
outside the square root of the bias-corrected ``v``, and the decay is
``lr * weight_decay * master``, inside the same step.

Parameters, gradients and the optimizer state are ``{name: tensor}``
dicts (``dict(params.named_parameters())`` of the port's parameter
tree).  ``update`` works IN PLACE: it overwrites
the masters, m, v and the parameters' storage, and returns the same
objects, so a step holds no second copy of the state.  The clip scale,
the learning rate and the step count stay device tensors: an update reads
nothing back to the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

#: elements per slice of the in-place update: bounds the f32 temporaries
#: of one leaf (the MLP's stacked ``wi`` alone has 1.2 B elements at
#: gemma-2b width)
CHUNK = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor         # () int32
    master: dict               # f32 copies of the parameters
    m: dict
    v: dict


class AdamWConfig(NamedTuple):
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init(params: dict) -> AdamWState:
    """f32 master copies of ``params``, zero m and v, step 0, all on the
    parameters' device."""
    dev = next(iter(params.values())).device
    master = {k: p.detach().float().clone() for k, p in params.items()}
    zeros = lambda: {k: torch.zeros_like(t) for k, t in master.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      master, zeros(), zeros())


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to lr_min (f32 device tensor)."""
    step = step.float()
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _slices(t: torch.Tensor):
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x_f32 ** 2), as a device
    tensor."""
    total = None
    for x in tree.values():
        for part in _slices(x.contiguous()):
            sq = part.float().square().sum()
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def update(cfg: AdamWConfig, grads: dict, state: AdamWState,
           params: dict, gnorm: torch.Tensor = None
           ) -> tuple[dict, AdamWState, dict]:
    """One AdamW step, in place.  ``grads``: in the parameters' names
    (any float dtype).  Returns ``(params, state, {"grad_norm", "lr"})``,
    the params and the state's tensors being those passed in, updated.
    ``gnorm``, the norm to clip by, defaults to :func:`global_norm` of
    ``grads`` (a sharded step passes the norm over every shard)."""
    step = state.step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    with torch.no_grad():
        for name, g in grads.items():
            p = params[name]
            parts = zip(*(_slices(t) for t in (
                g.contiguous(), state.m[name], state.v[name],
                state.master[name], p)))
            for g_, m_, v_, ma_, p_ in parts:
                g_ = g_.float() * scale
                m_.copy_(cfg.b1 * m_ + (1 - cfg.b1) * g_)
                v_.copy_(cfg.b2 * v_ + (1 - cfg.b2) * g_ * g_)
                mh = m_ / b1c
                vh = v_ / b2c
                ma_.copy_(ma_ - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                      + cfg.weight_decay * ma_))
                p_.copy_(ma_)
    state = AdamWState(step, state.master, state.m, state.v)
    return params, state, {"grad_norm": gnorm, "lr": lr}
