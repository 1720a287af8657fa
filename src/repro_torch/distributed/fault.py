"""Fault tolerance (``repro.distributed.fault``): the step watchdog
(straggler detection) and the elastic re-mesh policy.

The policies are real and unit-tested; the actuation (stopping a worker,
rescheduling a host) sits behind the ``Coordinator`` interface that a
cluster runtime implements.

* ``StepWatchdog``: an EMA of the step latency; a step over ``factor x
  EMA + slack`` records a straggler event and calls the coordinator's
  ``report_straggler``.
* ``best_mesh_shape``: the largest model-parallel width from a divisor
  ladder that divides the devices; the rest is data-parallel.
* ``ElasticManager``: on a membership change, rebuild the mesh over the
  world's ranks through ``best_mesh_shape`` and re-derive every
  placement from the same rule table (``distributed.sharding``);
  ``Checkpointer.restore`` then fills the new chunks.  Data order is kept:
  the pipeline is a function of the step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch


class Coordinator:
    """Cluster-runtime interface; the default implementation just records."""

    def __init__(self):
        self.events: list[dict] = []

    def report_straggler(self, step: int, latency_s: float, ema_s: float):
        self.events.append({"kind": "straggler", "step": step,
                            "latency_s": latency_s, "ema_s": ema_s})

    def report_failure(self, step: int, detail: str):
        self.events.append({"kind": "failure", "step": step, "detail": detail})


@dataclass
class StepWatchdog:
    coordinator: Coordinator
    factor: float = 3.0
    slack_s: float = 0.5
    ema_alpha: float = 0.1
    ema_s: Optional[float] = None
    stragglers: int = 0
    _t0: float = 0.0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> float:
        """The step's latency since :meth:`start`, observed."""
        dt = time.monotonic() - self._t0
        self.observe(step, dt)
        return dt

    def observe(self, step: int, latency_s: float) -> bool:
        """Observe one step's latency (also for simulated traces).
        Returns True if the step was flagged as a straggler."""
        flagged = False
        if self.ema_s is None:
            self.ema_s = latency_s
        else:
            if latency_s > self.factor * self.ema_s + self.slack_s:
                self.stragglers += 1
                self.coordinator.report_straggler(step, latency_s, self.ema_s)
                flagged = True
            self.ema_s = ((1 - self.ema_alpha) * self.ema_s
                          + self.ema_alpha * latency_s)
        return flagged


def best_mesh_shape(n_devices: int,
                    model_divisors: tuple[int, ...] = (16, 8, 4, 2, 1)
                    ) -> tuple[int, int]:
    """Elastic re-mesh policy: largest model-parallel width from the allowed
    divisor ladder that divides n_devices; the rest becomes data-parallel."""
    for tp in model_divisors:
        if n_devices % tp == 0:
            return (n_devices // tp, tp)
    return (n_devices, 1)


@dataclass
class ElasticManager:
    """Rebuilds the mesh and the placements after membership changes."""
    axis_names: tuple[str, str] = ("data", "model")

    def make_mesh(self, device_type="cuda"):
        """A ``(dp, tp)`` ``DeviceMesh`` over the world's ranks, shaped by
        :func:`best_mesh_shape`."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.device import resolve_device
        n = dist.get_world_size()
        dp, tp = best_mesh_shape(n)
        ranks = torch.arange(n).reshape(dp, tp)
        return DeviceMesh(resolve_device(device_type).type, ranks,
                          mesh_dim_names=self.axis_names)

    def reshard(self, tree, axes_tree, mesh) -> dict:
        """``{name: DTensor}``: this rank's chunk of each whole tensor of
        ``tree`` (every rank holds it, e.g. restored on the host) under
        the rule table's placements on ``mesh``."""
        from torch.distributed.tensor import DTensor

        from repro_torch.distributed import comm
        from repro_torch.distributed.sharding import param_placements
        if isinstance(tree, torch.nn.Module):
            tree = dict(tree.named_parameters())
        pls = param_placements(tree, axes_tree, mesh)
        return {k: DTensor.from_local(
                    comm.local_chunk(t.detach(), mesh, pls[k]).clone(),
                    mesh, pls[k], run_check=False)
                for k, t in tree.items()}
