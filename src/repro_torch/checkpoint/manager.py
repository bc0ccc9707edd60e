"""Checkpointing, ported from ``repro.checkpoint.manager``: async save,
atomic manifest promote, keep-last-k, restore into a template's
structure, and a template-free restore for self-describing state.

The on-disk layout is the reference's, bit for bit, so each package
restores the other's checkpoints: ``<dir>/step_%08d/`` holds one ``.npy``
per flattened leaf (its key, the dict keys and list indices joined with
``/`` in ``jax.tree`` order, with ``/`` written as ``__``) and a
``manifest.json`` naming each leaf's file, shape and dtype.  A bfloat16
leaf, which numpy lacks, is written as the reference writes an
``ml_dtypes`` one: its raw 2-byte values under a ``<V2`` header, named
``bfloat16`` in the manifest.  Such a leaf comes back from
``restore_flat`` as that raw ``V2`` array and makes ``restore`` raise
``TypeError``, as in the reference.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import _device, _dtypes, _tree


class _Bfloat16:
    """A bfloat16 leaf on the host, as its bits (uint16)."""

    def __init__(self, bits: np.ndarray) -> None:
        self.bits = bits


def _to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _Bfloat16(t.contiguous().view(torch.int16).numpy()
                             .view(np.uint16))
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":            # an ml_dtypes array
        return _Bfloat16(np.ascontiguousarray(arr).view(np.uint16))
    return arr


def _key(path: Tuple[Any, ...]) -> str:
    return "/".join(str(p) for p in path)


def _save_leaf(path: str, leaf) -> Dict[str, Any]:
    """Write one leaf's ``.npy``; returns its manifest's shape and
    dtype."""
    if isinstance(leaf, _Bfloat16):
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": leaf.bits.shape})
            f.write(np.ascontiguousarray(leaf.bits).tobytes())
        return {"shape": list(leaf.bits.shape), "dtype": "bfloat16"}
    arr = np.asarray(leaf)
    np.save(path, arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}


def _restored_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A loaded leaf as ``jnp.asarray`` (x64 off) would take it: numeric
    dtypes narrowed to 32 bits; anything else (a bfloat16 leaf's raw
    ``V2`` values, strings) is refused."""
    if arr.dtype.kind not in "biufc":
        raise TypeError(f"Dtype {arr.dtype} is not a valid array type: "
                        f"only arrays of numeric types restore into a "
                        f"template")
    return _dtypes.as_tensor(arr, device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        # serializes _write (tmp dir + promote + keep-last-k prune): a
        # blocking save overlapping an async one must never let _gc
        # prune a sibling's half-written .tmp or race two promotes
        self._write_lock = threading.Lock()

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state, *, blocking: bool = True) -> str:
        """Write state under <dir>/step_<n>.tmp then atomically promote.

        The state is copied to the host first; then any still-pending
        async save is joined, for both modes, so saves stay strictly
        ordered and a keep-last-k prune never deletes an in-flight
        checkpoint."""
        host_state = _tree.tree_map(_to_host, state)
        self.wait()
        if blocking:
            return self._write(step, host_state)
        self._pending = threading.Thread(
            target=self._write, args=(step, host_state), daemon=True)
        self._pending.start()
        return os.path.join(self.directory, f"step_{step:08d}")

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host_state) -> str:
        # crash points let the durability tests kill a save between the
        # tmp write, the atomic promote, and the prune (late import:
        # runtime.fault imports this module)
        from repro_torch.runtime.fault import crash_point

        with self._write_lock:
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": {}, "time": time.time()}
            pairs, _ = _tree.tree_flatten_with_path(host_state)
            for keypath, leaf in pairs:
                key = _key(keypath)
                fname = key.replace("/", "__") + ".npy"
                meta = _save_leaf(os.path.join(tmp, fname), leaf)
                manifest["leaves"][key] = {"file": fname, **meta}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            crash_point("checkpoint/promote")   # tmp complete, not live
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)              # atomic promote
            crash_point("checkpoint/gc")        # promoted, not pruned
            self._gc()
            return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: Optional[int]) -> Tuple[int, str, dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            return step, path, json.load(f)

    def restore(self, template, step: Optional[int] = None, device=None):
        """Restore into the structure of ``template``: (tree of tensors,
        step).  Each leaf lands on ``device`` when one is given, else on
        its template leaf's device when that is a tensor, else on the
        GPU (``device="cpu"`` for the CPU)."""
        step, path, manifest = self._manifest(step)
        pairs, treedef = _tree.tree_flatten_with_path(template)
        restored = []
        for keypath, like in pairs:
            if device is not None:
                where = torch.device(device)
            elif isinstance(like, torch.Tensor):
                where = like.device
            else:
                where = _device.resolve(None, "CheckpointManager.restore")
            meta = manifest["leaves"][_key(keypath)]
            arr = np.load(os.path.join(path, meta["file"]))
            restored.append(_restored_tensor(arr, where))
        return _tree.tree_unflatten(treedef, restored), step

    def restore_flat(self, step: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
        """Template-free restore: the manifest's leaves as a flat
        {key: host array} dict.  This is the recovery entry point for
        callers that serialize self-describing state (the stream
        durability layer): after a crash there is no live object to
        borrow a template from."""
        _, path, manifest = self._manifest(step)
        return {key: np.load(os.path.join(path, meta["file"]))
                for key, meta in manifest["leaves"].items()}
