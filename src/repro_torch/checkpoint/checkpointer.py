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
* **Sharded restore**: ``restore(..., specs=, mesh=)`` reads, leaf by
  leaf from a memory map, the slice this rank of ``mesh`` owns
  (``distributed.elastic.local_index``) onto its device; restoring onto
  another mesh than the one that saved is the elastic-scaling path.
* **Save over a mesh**: ``save(..., specs=, mesh=)`` writes the same
  mesh-independent files a single process writes, whole leaves under the
  same names: rank 0 alone writes, leaf by leaf, each split leaf's blocks
  gathered to it through host memory (along the line of the one mesh axis
  that splits it; from every rank, each block put in place by that rank's
  coordinates, for a leaf split over two axes under FSDP; host memory
  bounded by about twice the largest leaf), between two barriers so that
  no rank reads or saves again before the publish.
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
    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             specs: Any = None, mesh=None) -> str:
        """Write ``state`` as step ``step``; with ``specs`` and ``mesh``
        every rank calls it with its slices and the whole leaves are
        written (the module's "Save over a mesh")."""
        if specs is not None and mesh is not None:
            return self._save_mesh(step, state, extra or {}, specs, mesh)
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

    def _write(self, step: int, host, extra: Dict) -> str:
        """Write the (name, array, dtype) triples ``host`` yields, in
        order, then publish."""
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
            del arr
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)  # atomic publish
        self.saves += 1
        self._gc()
        return final

    def _save_mesh(self, step: int, state: Any, extra: Dict, specs: Any,
                   mesh) -> str:
        import torch.distributed as dist
        named, spec_leaves = _flatten(state), tr.leaves(specs)
        if len(named) != len(spec_leaves):
            raise ValueError(f"state has {len(named)} leaves, specs "
                             f"{len(spec_leaves)}")
        leaves = list(zip(named, spec_leaves))

        def whole():  # rank 0's stream of whole leaves; the others' none
            for (name, leaf), spec in leaves:
                full = _gather_leaf(leaf, spec, mesh)
                if mesh.rank == 0:
                    yield (name, *_to_host(full))
                del full

        dist.barrier()
        final = os.path.join(self.dir, f"step_{step}")
        if mesh.rank == 0:
            final = self._write(step, whole(), extra)
        else:
            for _ in whole():
                pass
        dist.barrier()
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
        if sharded:  # each leaf's slice, read from a memory map
            from repro_torch.distributed.elastic import local_index
            on = torch.empty(0, device=mesh.device)
            arrays = []
            for meta, spec in zip(manifest["leaves"], tr.leaves(specs)):
                mm = np.load(os.path.join(d, meta["file"]), mmap_mode="r")
                part = np.array(mm[local_index(mm.shape, spec, mesh)],
                                order="C")
                arrays.append(_from_host(part, meta["dtype"], on))
                del mm, part
            return tr.unflatten(template, arrays), manifest["extra"]
        arrays = [_from_host(np.load(os.path.join(d, meta["file"])),
                             meta["dtype"], leaf)
                  for meta, leaf in zip(manifest["leaves"], like)]
        return tr.unflatten(template, arrays), manifest["extra"]


def _gather_leaf(leaf: torch.Tensor, spec, mesh) -> Optional[torch.Tensor]:
    """The whole leaf on mesh rank 0 (on the host where it was split),
    None on the others: a leaf split along one mesh axis has its blocks
    gathered along the line of that axis through rank 0; a leaf split
    over several (FSDP's data axis and the model axis) has every rank's
    block gathered to rank 0, each put where ``local_index`` places that
    rank's; a leaf whole on every rank is rank 0's own."""
    import types

    import torch.distributed as dist

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.elastic import local_index, split_axes
    from repro_torch.launch.mesh import coords
    axes = [a for _, names in split_axes(spec) for a in names]
    if not axes:
        return leaf if mesh.rank == 0 else None
    if len(axes) > 1:
        blocks = coll.gather_to_first(leaf, dist.group.WORLD)
        if not blocks:
            return None
        shape = list(leaf.shape)
        for dim, names in split_axes(spec):
            for a in names:
                shape[dim] *= mesh.shape[a]
        whole = blocks[0].new_empty(shape)
        for rank, block in enumerate(blocks):
            at = types.SimpleNamespace(  # rank's place, as local_index reads
                shape=mesh.shape, index=coords(rank, mesh.shape).__getitem__)
            whole[local_index(shape, spec, at)] = block
        return whole
    (dim, (axis,)), = split_axes(spec)
    if any(mesh.index(a) for a in mesh.shape if a != axis):
        return None  # not on rank 0's line along the axis
    blocks = coll.gather_to_first(leaf, mesh.group(axis))
    return torch.cat(blocks, dim) if blocks else None
