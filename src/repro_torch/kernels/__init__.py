"""The port's kernels: hand-written CUDA C++ for Hopper under ``csrc/``,
built by ``build.py``, called through ``ops.py``, each beside its plain
PyTorch version in ``ref.py``."""
