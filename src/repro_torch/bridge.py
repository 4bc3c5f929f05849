"""Carry parameter trees across from numpy into the port's tensors.

``to_torch`` turns a numpy tree (nested dicts/lists of arrays, as
``jax.device_get`` returns a JAX parameter tree) into torch tensors on a
chosen device.  fp32 converts bit-exact; bf16 leaves (``ml_dtypes``'
bfloat16, which ``torch.from_numpy`` rejects) go through a ``uint16`` view
and ``.view(torch.bfloat16)``, which round-trips bit-exact too.  With
``repro_torch.serving.demo.zoo_from_params`` this yields a port zoo whose
block ids, chains and equivalence edges equal the JAX zoo's for the same
parameters.  The bridge takes numpy only: getting arrays off a JAX device
is the caller's business.
"""
from __future__ import annotations

import numpy as np
import torch


def leaf_to_torch(x: np.ndarray, device="cpu") -> torch.Tensor:
    if not isinstance(x, np.ndarray):
        raise TypeError(f"bridge takes numpy arrays, got {type(x).__name__}")
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:  # e.g. from jax.device_get: torch wants its own
        x = x.copy()
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return t.to(device)


def to_torch(tree, device="cpu"):
    """Map a numpy tree of dicts/lists/tuples to torch tensors on
    ``device``, keeping its structure."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return leaf_to_torch(tree, device)
