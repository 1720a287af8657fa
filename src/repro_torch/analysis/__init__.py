"""Static verification of derived schedules and of the port's launch plans.

The paper's claim is that static information (types, shapes, the lifted
psi-calculus indexing) fully determines a correct layout.  This package
makes "derived => correct" a checkable property without launching a
kernel:

* ``verify_schedule`` / ``verify_bundle`` / ``verify_expr``
  (``analysis.verify``, a copy of the reference's schedule layer):
  coverage and disjointness over the grid x block index maps, grid
  write-write races, pad guard and pad value (semiring inertness), psi and
  page-table bounds, and the fast-memory certificate at the real
  accumulation width;
* ``kernel_findings`` / ``plan_findings`` (``analysis.conformance``): the
  port's counterpart of the reference's kernel-body conformance, on the
  launch plan the host makes (K1's route, K9's descriptor) rather than a
  traced body;
* ``python -m repro_torch.analysis.verify_all``: the sweep over every form
  x {H100, TPU_V5E} x the dtype matrix.

``kernels.ops.apply(..., verify=True)`` runs the schedule checks before
the launch (``verify="kernel"`` adds the plan checks); results are
LRU-cached on the normal-form keys, so ``verify=False`` paths pay nothing.
``verify_plan`` / ``verify_sharded`` check a distributed plan (its
per-shard bundle, the collective order, the replication fallbacks) and
run before ``apply(mesh=..., verify=True)``; the reference's jaxpr lint
has no JAX program to read in the port.
"""
from repro_torch.analysis.verify import (Finding, VerificationError, errors,
                                         reset_verification_cache,
                                         verification_cache_stats,
                                         verify_bundle, verify_expr,
                                         verify_plan, verify_schedule,
                                         verify_sharded)
from repro_torch.analysis.conformance import kernel_findings, plan_findings

__all__ = [
    "Finding",
    "VerificationError",
    "errors",
    "kernel_findings",
    "plan_findings",
    "reset_verification_cache",
    "verification_cache_stats",
    "verify_bundle",
    "verify_expr",
    "verify_plan",
    "verify_schedule",
    "verify_sharded",
]
