"""Checkpointing: an npz per host + a JSON manifest, atomic, async.

The port of ``repro/checkpoint/manager.py``, with its on-disk format:
``<dir>/step_%010d/host_{id}.npz`` and ``manifest.json``, written into
``step_%010d.tmp`` and renamed into place, the oldest steps pruned past
``keep``.  Arrays are saved in logical (unsharded) form.  A leaf's key is
the ``/``-joined path of dict keys, list indices and ``OptState`` field
names (``step``, ``mu``, ``nu``, as the reference names them) through the
port's state tree, so ``numpy.load`` alone reads a checkpoint back.
bfloat16 leaves (numpy has no such dtype) are saved as float32, which
holds them exactly, and restored to the template's dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _items(node: Any) -> Iterator[Tuple[str, Any]]:
    """(key, child) of an inner node of a state tree, in the order the
    reference's ``tree_flatten_with_path`` visits them (dict keys sorted)."""
    if isinstance(node, dict):
        return ((str(k), node[k]) for k in sorted(node))
    if _is_namedtuple(node):
        return ((f, getattr(node, f)) for f in node._fields)
    return ((str(i), v) for i, v in enumerate(node))


def _walk(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, (dict, list, tuple)):
        for key, child in _items(tree):
            yield from _walk(child, f"{prefix}/{key}" if prefix else key)
    else:
        yield prefix, tree


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # a copy, also of a CPU tensor: the snapshot is taken at save
        dtype = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return leaf.detach().to("cpu", dtype, copy=True).numpy()
    return np.array(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _walk(tree)}


def _unflatten(template: Any, flat: Dict[str, np.ndarray],
               prefix: str = "") -> Any:
    """A tree shaped like ``template`` holding ``flat``'s arrays as tensors
    of each template leaf's dtype, on its device."""
    if isinstance(template, (dict, list, tuple)):
        children = {key: _unflatten(child, flat,
                                    f"{prefix}/{key}" if prefix else key)
                    for key, child in _items(template)}
        if isinstance(template, dict):
            return {k: children[str(k)] for k in template}
        if _is_namedtuple(template):
            return type(template)(**children)
        return [children[str(i)] for i in range(len(template))]
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    arr = flat[prefix]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {prefix}: ckpt {arr.shape} "
                         f"vs template {tuple(template.shape)}")
    if isinstance(template, torch.Tensor):
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = np.array(arr)
        return torch.from_numpy(arr).to(device=template.device,
                                        dtype=template.dtype)
    return arr.astype(template.dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, host_id: int = 0):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # ---- paths ---------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _steps(self):
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    yield int(name.split("_")[1])
                except ValueError:
                    pass

    def latest_step(self) -> Optional[int]:
        return max(self._steps(), default=None)

    # ---- save ----------------------------------------------------------
    def save(self, step: int, state: Any, metadata: Optional[Dict] = None,
             blocking: bool = True) -> None:
        """Copy ``state`` to host memory now, then write it (in a thread
        when ``blocking`` is False; one write in flight at a time)."""
        flat = _flatten(state)
        if blocking:
            self._write(step, flat, metadata or {})
        else:
            self.wait()
            self._async_thread = threading.Thread(
                target=self._write, args=(step, flat, metadata or {}),
                daemon=True)
            self._async_thread.start()

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               metadata: Dict) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"host_{self.host_id}.npz"), **flat)
        manifest = {"step": step, "time": time.time(),
                    "n_leaves": len(flat), **metadata}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _prune(self) -> None:
        for s in sorted(self._steps())[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---- restore -------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None,
                ) -> Tuple[Any, Dict]:
        """Restore into the structure, dtypes and devices of ``template``
        (the latest step unless ``step`` is given) -> (state, manifest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, f"host_{self.host_id}.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten(template, flat), manifest
