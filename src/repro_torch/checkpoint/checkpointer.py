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
pointing at the same storage.  The reference's ``shardings`` argument
(restore onto another mesh) waits for the multi-card slice (ROADMAP.md,
Queue 1 item 4).
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


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A copy of ``leaf`` on the host as npz can hold it, and its tag."""
    t = leaf.detach()
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
        self._save_impl(step, _flatten(tree), metadata or {})

    def save_async(self, step: int, tree: Any,
                   metadata: Optional[dict] = None):
        """Snapshot ``tree`` to the host now, write it on a thread."""
        self.wait()
        host = _flatten(tree)
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

    def restore(self, like: Any, step: Optional[int] = None
                ) -> tuple[Any, dict]:
        """Copy the newest valid checkpoint (or ``step``'s) into the
        tensors of ``like`` in place, each leaf found by its name and held
        to its shape and dtype; falls back to older checkpoints on
        corruption.  Returns ``(like, manifest)``."""
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
                if src.shape != leaf.shape or src.dtype != leaf.dtype:
                    raise ValueError(
                        f"{name}: checkpoint holds {tuple(src.shape)} "
                        f"{src.dtype}, the state {tuple(leaf.shape)} "
                        f"{leaf.dtype}")
                leaf.copy_(src)
        return like, manifest
