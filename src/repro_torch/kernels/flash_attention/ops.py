"""Dispatching wrapper for flash attention forward — the port of
``repro.kernels.flash_attention.ops``, in the JAX layout: q
``(B, Hq, S, hd)``, k/v ``(B, KVH, S, hd)``.

``impl``: ``auto`` picks by the tensors' device — a CPU tensor goes to the
plain PyTorch version (``ref``), a CUDA tensor to the hand-written CUDA
kernel.  ``cuda`` on a CPU tensor raises, and a CUDA launch that fails
raises: nothing falls back to ``ref`` behind the caller's back.  The
kernel takes strided views (the serving path hands it ``(B, S, H, hd)``
tensors transposed), so no copy is made.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

IMPLS = ("auto", "ref", "cuda")


def flash_attention(q, k, v, *, causal: bool = True, sm_scale=None,
                    window: int = 0, impl: str = "auto"):
    """Returns (B, Hq, S, hd) in q's dtype (and, from the kernel, in q's
    memory layout).  ``window`` > 0 (causal only): row i attends to keys
    i - window < j <= i."""
    if impl not in IMPLS:
        raise ValueError(f"flash_attention impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "ref"
    if impl == "ref":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                   window=window)
    if not q.is_cuda:
        raise ValueError("flash_attention impl='cuda' needs CUDA tensors; "
                         f"got q on {q.device}")
    return kernel.flash_attention_cuda(q, k, v, causal=causal,
                                       sm_scale=sm_scale, window=window)
