"""Block equivalence (paper §4.1, C1) — the port of the parametric
equivalence of ``repro.core.equivalence``.

Identical architecture: weighted parameter cosine similarity
Eq(A_i, B_i) = sum_p s(A_i^p) cos(A_i^p, B_i^p) / sum_p s(A_i^p),
with each cosine taken in float64 on the tensors' own device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.blocks import _flatten_with_path, _path_str


def _as_f64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().reshape(-1).double()
    return torch.from_numpy(np.asarray(x, np.float64).ravel())


def _cos(a, b) -> float:
    a, b = _as_f64(a), _as_f64(b)
    na, nb = float(torch.linalg.vector_norm(a)), float(torch.linalg.vector_norm(b))
    if na == 0.0 or nb == 0.0:
        return 1.0 if na == nb else 0.0
    return float(torch.dot(a, b.to(a.device))) / (na * nb)


def param_equivalence(params_a: dict, params_b: dict) -> float:
    """Weighted average of per-parameter cosine similarities (Eq. §4.1)."""
    flat_a = {_path_str(p): x for p, x in _flatten_with_path(params_a)}
    flat_b = {_path_str(p): x for p, x in _flatten_with_path(params_b)}
    num = den = 0.0
    for key, a in flat_a.items():
        b = flat_b.get(key)
        if b is None or tuple(b.shape) != tuple(a.shape):
            return 0.0  # structurally different -> not parametric-equivalent
        s = int(np.prod(a.shape))
        num += s * _cos(a, b)
        den += s
    return num / max(den, 1.0)

