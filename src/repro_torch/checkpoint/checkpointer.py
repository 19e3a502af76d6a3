"""Atomic, async checkpointing (port of ``repro.checkpoint.checkpointer``).

The on-disk format is the reference's: every leaf of the state tree is one
``<i>_<name>.npy`` (raw little-endian bytes, ``np.save``) plus one JSON
manifest, the leaf names joined from the leaf's tree path by ``_`` as the
reference's ``_flatten`` joins JAX's paths (``tree.leaves_with_path``), so
one step's manifest and file names are the same from either package, and
the port restores a checkpoint the reference wrote.

* **Atomic**: writes land in ``<dir>/tmp.<step>``, fsynced, then renamed to
  ``step_<n>``; a crash mid-save never corrupts the latest checkpoint.
* **Async**: ``save_async`` copies the state to host memory synchronously,
  then writes on a background thread so the train loop keeps stepping.
* **bfloat16**: numpy has no bfloat16 without ``ml_dtypes`` (which the GPU
  machine lacks), so a bf16 leaf is written as its uint16 bits with
  ``"dtype": "bfloat16"`` in the manifest and read back bit for bit. The
  reference's own bf16 files (``ml_dtypes`` arrays) are not read.
* **Sharded restore**: ``restore(..., specs=, mesh=)`` reads every leaf
  to the host and keeps, through ``distributed.elastic.reshard_state``,
  the slice this rank of ``mesh`` owns, on its device; restoring onto
  another mesh than the one that saved is the elastic-scaling path.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tr

__all__ = ["Checkpointer"]

_BF16 = "bfloat16"


def _flatten(state: Any) -> List[Tuple[str, Any]]:
    """[(name, leaf)] in leaf order, the reference's names."""
    return [("_".join(str(p) for p in path) or "leaf", leaf)
            for path, leaf in tr.leaves_with_path(state)]


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the bytes to write as an array, the manifest's dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, like: Any) -> Any:
    """A loaded array as the template's leaf: a tensor on the leaf's
    device where the leaf is a tensor, else the array."""
    if dtype == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr)
    else:
        return arr
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.saves = 0

    # ----------------------------------------------------------- listing
    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any,
             extra: Optional[Dict] = None) -> str:
        return self._write(step, self._host(state), extra or {})

    def save_async(self, step: int, state: Any,
                   extra: Optional[Dict] = None) -> None:
        self.wait()  # at most one in-flight save
        self._thread = threading.Thread(
            target=self._write, args=(step, self._host(state), extra or {}),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _host(state: Any) -> List[Tuple[str, np.ndarray, str]]:
        return [(name, *_to_host(leaf)) for name, leaf in _flatten(state)]

    def _write(self, step: int, host: List[Tuple[str, np.ndarray, str]],
               extra: Dict) -> str:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for i, (key, arr, dtype) in enumerate(host):
            fname = f"{i:05d}_{key[:80]}.npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"].append(
                {"file": fname, "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)  # atomic publish
        self.saves += 1
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def restore(self, template: Any, step: Optional[int] = None,
                specs: Any = None, mesh=None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``template``: each tensor leaf
        comes back as a tensor on the template leaf's device, in the dtype
        it was saved in. With ``specs`` and ``mesh`` each leaf comes back
        as this rank's slice under its spec, on the mesh's device (one
        of the two alone restores whole leaves, as the reference does)."""
        sharded = specs is not None and mesh is not None
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        like = tr.leaves(template)
        if len(like) != len(manifest["leaves"]):
            raise ValueError(f"checkpoint has {len(manifest['leaves'])} "
                             f"leaves, template has {len(like)}")
        if sharded:  # whole leaves on the host, then each slice
            like = [torch.empty(0)] * len(like)
        arrays = [_from_host(np.load(os.path.join(d, meta["file"])),
                             meta["dtype"], leaf)
                  for meta, leaf in zip(manifest["leaves"], like)]
        if sharded:
            from repro_torch.distributed.elastic import reshard_state
            return (reshard_state(tr.unflatten(template, arrays), specs,
                                  mesh), manifest["extra"])
        return tr.unflatten(template, arrays), manifest["extra"]
