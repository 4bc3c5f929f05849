"""Plain PyTorch segment-aligned batched LoRA — the port of
``repro.kernels.batched_lora.ref``: per-row adapter ids from the tile ids,
the base product and both low-rank products in fp32, one cast at the end.
T need not be a multiple of ``bt`` (the last tile is ragged).

The CUDA kernel rounds where this does (products of bf16 inputs are exact
in fp32, one cast at the end) but sums in its own fixed order: chunks of
128 along D, each from 0, added in order (in bf16 each chunk is eight
tensor-core k16 steps), so the two agree at tolerance, not bitwise."""
import torch


def batched_lora_ref(x, w, a, b, tile_groups, *, bt: int = 128,
                     scaling: float = 1.0):
    """x: (T, D); w: (D, F); a: (G, D, r); b: (G, r, F); tile_groups:
    (ceil(T / bt),) adapter id per row tile.  Returns (T, F) in x's dtype."""
    T = x.shape[0]
    bt = min(bt, T)
    groups = tile_groups.long().repeat_interleave(bt)[:T]  # (T,) per row
    x32 = x.float()
    base = x32 @ w.float()
    xa = torch.einsum("td,tdr->tr", x32, a[groups].float())
    delta = torch.einsum("tr,trf->tf", xa, b[groups].float())
    return (base + scaling * delta).to(x.dtype)
