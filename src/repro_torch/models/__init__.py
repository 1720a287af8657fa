"""Model assembly for the port: layers, attention and the dense decoder LM
(``repro.models`` counterparts)."""
