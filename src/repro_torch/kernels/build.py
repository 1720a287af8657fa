"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is a translation unit with a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes); the flash
kernels share ``csrc/hopper.cuh`` (TMA, mbarriers, wgmma).  It compiles
for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the repo root
(git-ignored) on first use; the hash is the SHA-256 of the source and the
shared headers, so an edit rebuilds and an unchanged one is loaded as
built.  All missing libraries build in parallel, one ``nvcc`` per
source.

Each C entry point takes pointers and the CUDA stream as ``void*`` and
sizes as ``int``, launches on that stream and returns
``cudaGetLastError()``; each library also exports ``repro_error_string``
for the message (``kernels/ops.py`` raises with it).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: ``<repo>/build/kernels``: the repo root is three levels above this
#: package's ``kernels/`` directory (``src/repro_torch/kernels``)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """The ``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``, the toolkit's standard location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels are built with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed on the hash of the source
    and of the shared headers (``csrc/*.cuh``) it may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


#: sources whose many independent kernels nvcc optimises in parallel
#: (``--split-compile``, one thread a core): K9's, the longest build, its
#: tile alone instantiated for 7 semirings x one or several contracted
#: axes; split, it no longer outlasts ``gemm.cu``
SPLIT_COMPILE = ("semiring",)


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> list[str]:
    """The command line that compiles ``csrc/<name>.cu`` into ``out``."""
    split = ("--split-compile=0",) if name in SPLIT_COMPILE else ()
    return [nvcc, *NVCC_FLAGS, *split, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names=None) -> dict[str, str]:
    """Compile every missing library among ``names`` (default: all
    sources), all ``nvcc`` processes at once.  Returns ``{name: ptxas
    report}`` for the ones built now.  Raises with the compiler's output
    when a build fails."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    reports, failed = {}, []
    with contextlib.ExitStack() as logs:
        for n in todo:
            tmp = library_path(n).with_suffix(f".tmp{os.getpid()}.so")
            # each compiler's report into a file of its own: a pipe read one
            # process at a time stalls the others once their reports pass
            # the pipe's 64 KB (K9's ptxas report is larger)
            log = logs.enter_context(
                tempfile.TemporaryFile(mode="w+", dir=BUILD_DIR))
            procs[n] = (tmp, log, subprocess.Popen(
                nvcc_command(n, tmp, nvcc), stdout=log,
                stderr=subprocess.STDOUT))
        for n, (tmp, log, proc) in procs.items():
            proc.wait()
            log.seek(0)
            out = log.read()
            if proc.returncode != 0:
                failed.append(
                    f"--- {n}.cu (nvcc exit {proc.returncode})\n{out}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, library_path(n))
            reports[n] = out
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if its
    current source has not been built."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def build_all() -> tuple[float, dict[str, str]]:
    """Build (in parallel) and load every kernel; returns the seconds it
    took and the ptxas reports of what was compiled."""
    t0 = time.perf_counter()
    reports = build()
    for n in sources():
        load(n)
    return time.perf_counter() - t0, reports

