"""Asynchronous checkpointing of tensor trees — the port of
``repro.checkpoint.checkpointer``, on the reference's on-disk layout.

- save: each leaf -> one ``leaf_%05d.npy``, plus a ``manifest.json``
  holding ``step`` and each leaf's ``{file, path, shape, dtype}``.  Leaves
  are numbered in JAX's flatten order (``repro_torch.tree``: sorted dict
  keys) and their paths printed as JAX prints a key path, so a checkpoint
  written by either package restores in the other.  The leaves are copied
  to host memory before ``save`` returns; one writer thread writes them
  into ``.tmp_step_*`` and publishes the step with a rename.  A step
  already written or pending is not written again.  Steps past the last
  ``max_to_keep`` are deleted.
- restore: the tree of a template's structure, each leaf checked against
  the template's shape and dtype, on the template leaf's device or the
  one given; with ``shardings`` (a tree of DTensor placements, as
  ``launch.shardings.named_tree`` gives) and ``mesh``, each leaf is placed
  on that mesh from its host copy (elastic restore onto any mesh).  A
  DTensor leaf is saved whole (``full_tensor``), so a checkpoint stays
  mesh-free and the same bytes as the reference writes.
- preemption: ``install_preemption_hook`` writes a blocking checkpoint on
  SIGTERM.
"""
from __future__ import annotations

import json
import re
import shutil
import signal
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.tree import tree_flatten_with_paths, tree_unflatten

_STEP_DIR = re.compile(r"step_\d+")


def _to_host(t) -> np.ndarray:
    """A leaf as a numpy copy on the host (the caller may go on to write
    the tensor)."""
    if not isinstance(t, torch.Tensor):
        return np.array(t)
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        raise TypeError("checkpoint leaves are numpy dtypes: a bf16 leaf "
                        "has none (training keeps fp32 parameters)")
    return t.detach().to("cpu", copy=True).numpy()


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pool = ThreadPoolExecutor(max_workers=1)  # serialized writes
        self._pending = []
        self._pending_steps = set()

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = False) -> Path:
        ckpt_dir = self.dir / f"step_{step:08d}"
        if ckpt_dir.exists() or step in self._pending_steps:
            if blocking:
                self.wait()
            return ckpt_dir  # idempotent
        self._pending_steps.add(step)
        leaves, paths = tree_flatten_with_paths(tree)
        host_leaves = [_to_host(x) for x in leaves]

        def _write():
            tmp = self.dir / f".tmp_step_{step:08d}"
            tmp.mkdir(parents=True, exist_ok=True)
            manifest = {"step": step, "leaves": []}
            for i, (arr, path) in enumerate(zip(host_leaves, paths)):
                fn = f"leaf_{i:05d}.npy"
                np.save(tmp / fn, arr)
                manifest["leaves"].append(
                    {"file": fn, "path": path, "shape": list(arr.shape),
                     "dtype": str(arr.dtype)})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if ckpt_dir.exists():
                shutil.rmtree(ckpt_dir)
            tmp.rename(ckpt_dir)  # atomic publish
            self._pending_steps.discard(step)
            self._gc()

        fut = self._pool.submit(_write)
        self._pending.append(fut)
        if blocking:
            fut.result()
        return ckpt_dir

    def wait(self) -> None:
        for f in self._pending:
            f.result()
        self._pending.clear()

    def _gc(self) -> None:
        steps = sorted(p for p in self.dir.glob("step_*")
                       if _STEP_DIR.fullmatch(p.name))
        for old in steps[: -self.max_to_keep]:
            shutil.rmtree(old, ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = sorted(p for p in self.dir.glob("step_*")
                       if _STEP_DIR.fullmatch(p.name))
        if not steps:
            return None
        return int(steps[-1].name.split("_")[1])

    def restore(self, template: Any, *, step: Optional[int] = None,
                device=None, shardings: Any = None, mesh=None) -> Any:
        """The checkpoint of ``step`` (default the latest) as a tree of
        ``template``'s structure, each leaf a tensor of the template leaf's
        shape and dtype on ``device`` (default the template leaf's).  With
        ``shardings`` (placements for each leaf, a tree of the template's
        structure) each leaf is a DTensor on ``mesh`` instead: every rank
        reads the file and keeps its own shard."""
        if shardings is not None:
            if mesh is None:
                raise ValueError("restore(shardings=...) needs the mesh")
            from repro_torch.launch.shardings import zip_map

            shard_leaves = tree_flatten_with_paths(
                zip_map(lambda _, pl: _Leaf(pl), template, shardings))[0]
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        ckpt_dir = self.dir / f"step_{step:08d}"
        manifest = json.loads((ckpt_dir / "manifest.json").read_text())
        leaves, paths = tree_flatten_with_paths(template)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(f"tree mismatch: {len(leaves)} leaves, the "
                             f"checkpoint {len(manifest['leaves'])}")
        out = []
        for i, (meta, ref, path) in enumerate(zip(manifest["leaves"], leaves,
                                                  paths)):
            arr = np.load(ckpt_dir / meta["file"])
            t = torch.from_numpy(arr)
            if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
                raise ValueError(f"{path}: checkpoint {tuple(t.shape)} "
                                 f"{t.dtype}, template {tuple(ref.shape)} "
                                 f"{ref.dtype}")
            if shardings is not None:
                out.append(distribute_tensor(
                    t.to(mesh.device_type), mesh,
                    shard_leaves[i].placements, src_data_rank=None))
            else:
                out.append(t.to(device if device is not None
                                else ref.device))
        return tree_unflatten(template, out)


class _Leaf:
    """One leaf's placements, boxed so a tree walk does not enter them."""

    def __init__(self, placements):
        self.placements = placements


def install_preemption_hook(ckpt: Checkpointer, get_state,
                            signals=(signal.SIGTERM,)):
    """On preemption, write a final blocking checkpoint of ``get_state()``
    -> (step, tree).  Returns the handler."""

    def _handler(signum, frame):
        step, tree = get_state()
        ckpt.save(step, tree, blocking=True)

    for s in signals:
        signal.signal(s, _handler)
    return _handler
