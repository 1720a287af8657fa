"""Distribution layer (``repro.distributed`` counterparts): gradient
compression and the fault-tolerance policies.  The mesh, the sharding
rules, the planned collectives and the elastic re-mesh wait for the
multi-card slice (ROADMAP.md, Queue 1 item 4)."""
