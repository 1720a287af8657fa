"""The part of the reference's derivation the port uses: the block solver."""
