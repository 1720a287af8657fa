"""The part of the reference's derivation the port uses: MoA layouts
(``moa``), the semiring registry, dimension lifting, ONF loop nests, the
expression algebra and its normal forms, the block solvers and the
derived schedules."""
