"""Model assembly for the port: layers, attention, the Mamba-2 block and
the decoder LM of the dense and ssm families (``repro.models``
counterparts)."""
