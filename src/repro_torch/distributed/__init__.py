"""Distribution layer (``repro.distributed`` counterparts): the sharding
rule table, the derived plans and their collectives on
``torch.distributed`` (one process a rank), the overlapped collective
matmuls, gradient compression, and the fault-tolerance policies with the
elastic re-mesh."""
