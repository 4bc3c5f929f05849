"""Block equivalence (paper §4.1, C1) — the port of
``repro.core.equivalence``.

- Identical architecture: weighted parameter cosine similarity
  Eq(A_i, B_i) = sum_p s(A_i^p) cos(A_i^p, B_i^p) / sum_p s(A_i^p),
  with each cosine taken in float64 on the tensors' own device.
- Output distributions: cosine similarity of vocabulary probabilities, in
  float64 on the host (adaptive serving, paper Fig. 20).
- Different embedding sizes: the same similarity of the vocabulary
  probabilities each model's prefix gives under a shared probe set, each
  side projected through its own lm_head (paper Fig. 10).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.blocks import _flatten_with_path, _path_str
from repro_torch.models import transformer as T


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


def _host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def vocab_probability_similarity(probs_a, probs_b) -> float:
    """Mean per-token cosine of two vocab-probability tensors (B, S, V),
    torch or numpy — V may differ only if a shared probe tokenizer is
    used; here V matches (same tokenizer family)."""
    a = _host_f64(probs_a)
    b = _host_f64(probs_b)
    a = a.reshape(-1, a.shape[-1])
    b = b.reshape(-1, b.shape[-1])
    dot = (a * b).sum(-1)
    denom = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12
    return float((dot / denom).mean())


def layerwise_vocab_probs(model, params, cfg, tokens, upto_layer: int, *,
                          attn_impl: str = "auto"):
    """Run the first ``upto_layer`` layers and project through this model's
    own lm_head -> fp32 vocab probabilities (B, S, V) (the §4.1 cross-size
    probe), in ``model``'s compute dtype."""
    from repro_torch.core.stitching import _hidden_at_layer  # imports this

    h = _hidden_at_layer(params, cfg, tokens, upto_layer, attn_impl=attn_impl,
                         compute_dtype=model.compute_dtype)
    return torch.softmax(T._logits(params, cfg, h).float(), dim=-1)


def cross_size_equivalence(model_a, params_a, cfg_a, model_b, params_b, cfg_b,
                           tokens, frac: float = 0.5, *,
                           attn_impl: str = "auto") -> float:
    """Equivalence between same-depth-fraction prefixes of two models with
    different embedding sizes (paper Fig. 10)."""
    la = max(1, int(cfg_a.num_layers * frac))
    lb = max(1, int(cfg_b.num_layers * frac))
    pa = layerwise_vocab_probs(model_a, params_a, cfg_a, tokens, la,
                               attn_impl=attn_impl)
    pb = layerwise_vocab_probs(model_b, params_b, cfg_b, tokens, lb,
                               attn_impl=attn_impl)
    return vocab_probability_similarity(pa, pb)
