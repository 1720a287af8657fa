"""Fault-tolerant checkpointing (``repro.checkpoint.checkpointer``):
atomic, integrity-checked, async, keep-k, in the reference's on-disk
format, so that each package restores the other's checkpoints.

Layout per step:  <dir>/step_<N:010d>/arrays.npz  +  manifest.json
(the manifest carries ``step``, the sha256 ``digest`` of the npz, each
leaf's ``dtypes`` tag and the caller's ``metadata``).  A leaf's name is
its path in the tree joined by "/", as the reference's ``_flatten``
writes it: a ``TrainState`` gives ``params/layers/attn/wq``,
``opt/step``, ``opt/master/...``, ``opt/m/...``, ``opt/v/...``,
``err_fb/...`` (with compression) and ``step``.  The port's dotted
parameter names (``layers.attn.wq``) are split on their dots.  npz cannot
hold bf16: such a leaf is stored as its ``uint16`` view tagged
``"bfloat16"``.

Guarantees:

* atomicity: written to ``step_<N>.tmp-partial`` and then renamed, so a
  crash mid-write never corrupts the latest valid checkpoint;
* integrity: ``restore`` verifies the digest and falls back to the newest
  valid earlier checkpoint when the latest is torn;
* async: ``save_async`` copies every leaf to the host before it returns
  (the port's train step and AdamW update the state IN PLACE, so a later
  step must not reach the file) and writes the file on a worker thread;
  ``wait()`` joins it.

``restore`` copies into the tensors of ``like`` in place, so that the
parameters, the optimizer's dicts and a train step built on them keep
pointing at the same storage.

Sharded trees (the DTensor leaves of ``train_step.init_sharded_state``):
``save`` gathers every DTensor leaf whole on every rank (each rank of the
mesh calls it) and rank 0 of the world writes the same npz + manifest,
so a checkpoint holds no trace of the mesh it was saved at; the ranks
then wait for the file.  ``restore`` reads the whole leaves and copies
this rank's chunk into each DTensor leaf under its own placements, or
under ``shardings`` (``{name: (mesh, placements)}``, the reference's
re-shard argument) into a plain leaf of the chunk's shape: a checkpoint
saved at one mesh restores at another, and in one process.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _leaves(tree, prefix: str = ""):
    """``(name, tensor)`` for every tensor in ``tree``: a NamedTuple by
    its fields, a dict by its keys, a module by its named parameters;
    None holds no leaf."""
    join = lambda k: f"{prefix}/{k}" if prefix else k
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, torch.nn.Module):
        for k, p in tree.named_parameters():
            yield join(k.replace(".", "/")), p
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), join(k))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, join(str(k).replace(".", "/")))
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                        f"{prefix!r}")


def _whole(leaf: torch.Tensor) -> torch.Tensor:
    """A DTensor leaf gathered whole (every rank of its mesh calls this);
    any other leaf as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        from repro_torch.distributed import comm
        return comm.gather_full(leaf.to_local(), leaf.device_mesh,
                                leaf.placements)
    return leaf


def _writer() -> bool:
    """Rank 0 of the world writes (every process, with no world)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _wait_for_writer() -> None:
    """Every rank of the world waits here for rank 0's write: an
    all-reduce on the host for gloo (its barrier after collectives of
    CUDA tensors is not relied on), on the card for NCCL."""
    import torch.distributed as dist
    if dist.is_initialized():
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == dist.Backend.NCCL else "cpu")
        dist.all_reduce(torch.zeros(1, device=dev))


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A copy of ``leaf`` on the host as npz can hold it, and its tag."""
    t = _whole(leaf).detach()
    if t.dtype == torch.bfloat16:
        host = t.view(torch.int16).to("cpu", copy=True)
        return host.numpy().view(np.uint16), "bfloat16"
    return (t.to("cpu", copy=True).numpy(),
            str(t.dtype).removeprefix("torch."))


def _flatten(tree) -> dict[str, tuple[np.ndarray, str]]:
    flat = {}
    for name, leaf in _leaves(tree):
        if name in flat:
            raise ValueError(f"two leaves named {name!r}")
        flat[name] = _to_host(leaf)
    return flat


def _from_host(arr: np.ndarray, tag: str) -> torch.Tensor:
    if tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None):
        self.wait()
        flat = _flatten(tree)
        if _writer():
            self._save_impl(step, flat, metadata or {})
        _wait_for_writer()

    def save_async(self, step: int, tree: Any,
                   metadata: Optional[dict] = None):
        """Snapshot ``tree`` to the host now, write it on a thread (rank
        0's; the other ranks of a world return once they have gathered)."""
        self.wait()
        host = _flatten(tree)
        if not _writer():
            return
        self._thread = threading.Thread(
            target=self._save_thread, args=(step, host, metadata or {}),
            daemon=True)
        self._thread.start()

    def _save_thread(self, step, host, metadata):
        try:
            self._save_impl(step, host, metadata)
        except BaseException as e:              # raised again by wait()
            self._error = e

    def wait(self):
        """Join the pending asynchronous save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _save_impl(self, step: int, flat: dict, metadata: dict):
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp-partial"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        npz = os.path.join(tmp, "arrays.npz")
        np.savez(npz, **{k: arr for k, (arr, _) in flat.items()})
        manifest = {"step": step, "digest": _digest(npz),
                    "dtypes": {k: tag for k, (_, tag) in flat.items()},
                    "metadata": metadata}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)                     # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp-partial"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _load_step(self, step: int) -> tuple[dict, dict]:
        base = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        npz = os.path.join(base, "arrays.npz")
        if _digest(npz) != manifest["digest"]:
            raise IOError(f"checkpoint step {step} failed integrity check")
        with np.load(npz) as data:
            flat = {k: _from_host(data[k], manifest["dtypes"][k])
                    for k in data.files}
        return flat, manifest

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Optional[dict] = None) -> tuple[Any, dict]:
        """Copy the newest valid checkpoint (or ``step``'s) into the
        tensors of ``like`` in place, each leaf found by its name and held
        to its shape and dtype; falls back to older checkpoints on
        corruption.  A DTensor leaf takes this rank's chunk under its
        placements; a leaf named in ``shardings`` (``{leaf name: (mesh,
        placements)}``, by the checkpoint's names, ``params/layers/...``)
        its chunk under those.  Returns ``(like, manifest)``."""
        from torch.distributed.tensor import DTensor

        from repro_torch.distributed import comm
        shardings = shardings or {}
        steps = self.all_steps()
        if step is not None:
            steps = [s for s in steps if s == step]
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        last_err: Exception | None = None
        for s in reversed(steps):
            try:
                flat, manifest = self._load_step(s)
                break
            except Exception as e:                 # torn checkpoint: fall back
                last_err = e
        else:
            raise IOError(f"all checkpoints corrupt; last error: {last_err}")

        with torch.no_grad():
            for name, leaf in _leaves(like):
                if name not in flat:
                    raise KeyError(f"checkpoint step {manifest['step']} has "
                                   f"no leaf {name!r}")
                src = flat[name]
                if isinstance(leaf, DTensor) or name in shardings:
                    mesh, pl = shardings[name] if name in shardings else (
                        leaf.device_mesh, leaf.placements)
                    if isinstance(leaf, DTensor):
                        if tuple(pl) != tuple(leaf.placements):
                            raise ValueError(
                                f"{name}: placed {tuple(leaf.placements)}, "
                                f"the shardings say {tuple(pl)}")
                        leaf = leaf.to_local()
                    src = comm.local_chunk(src, mesh, pl)
                if src.shape != leaf.shape or src.dtype != leaf.dtype:
                    raise ValueError(
                        f"{name}: checkpoint holds {tuple(src.shape)} "
                        f"{src.dtype}, the state {tuple(leaf.shape)} "
                        f"{leaf.dtype}")
                leaf.copy_(src)
        return like, manifest
