"""The training step (``repro.train.train_step``): loss and gradients
through the port's kernels, gradient accumulation over microbatches, and
AdamW.

The step has the reference's ``make_train_step`` semantics without a
planned mesh: the forward rematerializes each layer when ``cfg.remat`` is
set (``remat_policy`` "full" or "dots"), every product runs on K1 (its VJP
forms for the gradients), attention on K2 with its (m, l) export and the
K3/K4 backward; the gradients pass through the int8 compression with
error feedback (``distributed.compression``) when it is enabled, then
AdamW.  The state is updated IN PLACE (parameters, masters, m, v, the
error state): the returned state holds the same tensors.  Metrics stay
device tensors.

    state = init_state(cfg, params, device, comp)
    step = make_train_step(cfg, opt_cfg, comp, microbatches=...)
    state, metrics = step(state, batch)      # batch: {"tokens", "targets"}
                                             # (+ "patches" / "frames")
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import compression
from repro_torch.models import registry
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: object              # the parameter tree (nn.ModuleDict)
    opt: adamw.AdamWState
    err_fb: Optional[dict]      # gradient-compression error feedback
    step: torch.Tensor          # () int32


def init_state(cfg: ArchConfig, params, device="cuda",
               comp: compression.CompressionConfig =
               compression.CompressionConfig()) -> TrainState:
    """The train state around ``params`` (made trainable in place), with a
    fresh AdamW state and, when ``comp`` is enabled, a zero error state,
    on ``device`` (default the card; raises without one unless
    ``device="cpu"``)."""
    device = resolve_device(device)
    for name, p in params.named_parameters():
        if p.device.type != device.type:
            raise ValueError(f"parameter {name} lives on {p.device}, not "
                             f"{device}")
        p.requires_grad_(True)
    named = dict(params.named_parameters())
    err = compression.init_error_state(named) if comp.enabled else None
    return TrainState(params, adamw.init(named), err,
                      torch.zeros((), dtype=torch.int32, device=device))


def loss_and_grads(params, cfg: ArchConfig, batch: dict
                   ) -> tuple[torch.Tensor, dict, dict]:
    """``(loss, metrics, {name: gradient})`` of the family's loss
    (``registry.loss``) on one batch; each gradient in its parameter's
    dtype."""
    names, leaves = zip(*params.named_parameters())
    loss, metrics = registry.loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, dict(zip(names, grads))


def make_train_step(cfg: ArchConfig,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    comp: compression.CompressionConfig =
                    compression.CompressionConfig(),
                    microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    With ``microbatches > 1`` the batch splits along its first axis and
    the gradients of the microbatches are summed into f32 accumulators
    and averaged; the loss and metrics are the microbatches' means."""

    def train_step(state: TrainState, batch: dict):
        if comp.enabled and state.err_fb is None:
            raise ValueError("gradient compression is enabled but the state "
                             "has no error feedback; make it with "
                             "init_state(..., comp=comp)")
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(state.params, cfg, batch)
        else:
            for name, t in batch.items():
                if t.shape[0] % microbatches:
                    raise ValueError(
                        f"batch[{name!r}] has {t.shape[0]} rows, which "
                        f"{microbatches} microbatches do not divide")
            mbs = [dict(zip(batch, parts)) for parts in zip(
                *(t.chunk(microbatches, dim=0) for t in batch.values()))]
            grads, losses, ms = None, [], []
            for mb in mbs:
                loss, m, g = loss_and_grads(state.params, cfg, mb)
                if grads is None:
                    grads = {k: t.float() for k, t in g.items()}
                else:
                    for k, t in g.items():
                        grads[k].add_(t)
                losses.append(loss)
                ms.append(m)
            grads = {k: t / microbatches for k, t in grads.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        grads, err = compression.compress_grads(comp, grads, state.err_fb)
        _, opt, opt_m = adamw.update(opt_cfg, grads, state.opt,
                                     dict(state.params.named_parameters()))
        metrics = dict(metrics, loss=loss, **opt_m)
        return TrainState(state.params, opt, err, state.step + 1), metrics

    return train_step
