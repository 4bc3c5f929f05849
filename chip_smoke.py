#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the
script exits non-zero without printing a result:

1. environment: the card (``nvidia-smi``), torch and CUDA versions, and the
   build of the three hand-written CUDA kernels from this checkout's
   sources (one ``nvcc`` per source, all at once); then gemm_rows: whether
   a row of cuBLAS's bf16 products at the engine's shapes is bitwise the
   same whatever the call's row count M (decode widths 1-16; a request's
   prompt alone against its padded prefill group), which the recompute
   below relies on;
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, in bf16 and fp32 (TF32 off), with the tolerances of
   ``tests/test_kernels.py`` -- paged decode attention (2e-2 / 2e-5, bf16
   within one bf16 ulp of the plain version), attend only and as the fused
   decode step (one launch that stores the new token's K/V in its page,
   pages bitwise equal to ``write_token_to_pages``'), at the demo,
   TinyLlama, main-path (plain and, tables widened by speculation's
   headroom, ``main_spec``), long and long_prefill-decode shapes, and at split
   lengths of 64-512 positions at the main-path and long shapes (timed for
   ``SPLIT_TOKENS``); flash attention forward
   (2e-2 / 2e-5, bf16 within two bf16 ulps of the plain version and, at
   S >= 1,000, each row within 1e-2 of it in relative L2 norm) at a B=4
   prefill of 128 and of 2,048 tokens, ragged lengths, the demo heads,
   one non-causal case and the sliding window past itself (mixtral-8x22b's
   and zamba2-2.7b's heads at 8,192 tokens in their window of 4,096,
   mixtral's at 32,768, each also timed without the window: at 32,768,
   where the window keeps 0.234 of the causal pairs, its time must be under
   half the causal time, as the tiles before each window are skipped;
   SDPA with the boolean window mask as the library yardstick); batched
   LoRA (5e-2 / 1e-4) at decode and prefill widths, four adapters packed
   by ``pack_segments`` and a T off the row tile, and both of its paths
   (split-D and tiled, forced) at T = 128, 256, 512 and 1,024, bitwise
   equal, timed for the split threshold; and
   flash and LoRA at every shape the main paths below give them
   (``main_*`` cases: one per prefill group, as the executor groups
   requests by chain and length bucket, and one per app-lora decode batch
   width) -- each with its time beside the plain version's, a library
   call's (a yardstick the port never calls: SDPA, or ``addmm`` with the
   two low-rank products) and the least time the card could take (the
   bound);
3. engine: the block zoo's three apps (base, vicuna FPFT, app-lora PEFT)
   served through ``BlockEngine.submit/drain`` at TinyLlama-1.1B width
   (22 layers, d_model 2048; random weights from seed 0), 12 requests;
   every kernel's launch count is set to 0 just before and read just
   after, and must equal the executor's calls (paged attention per decode
   hop, flash attention per prefill hop, LoRA q/v per app-lora hop); the
   traffic served twice more on fresh engines (same tokens; step wall
   only, which moves with the host); then eight steady decode steps of
   the same traffic under ``torch.profiler``
   for the device's busy share and the time by kernel;
4. long_prefill: eight requests of 512-2,000 prompt tokens across the
   three apps, served once cold (timed apart), once as they come and once
   with one app-lora request spilled to host memory and one base request
   preempted for recompute after four decode steps; all three runs' tokens
   must be bitwise equal, the recomputed request's too (its prompt is
   prefilled again at its unpadded length, where the flash kernel is then
   held against its plain version, and each emitted position is rebuilt by
   the decode step that first wrote it);
5. speculation: the engine phase's 12 requests on fresh engines with
   lookahead 4 -- spec-OFF, spec-ON at the default prune ratio, forced
   accept (prune 0: every draft a hit) and forced reject (each surrogate
   lm_head negated: no hit, until the accept-rate gate turns each
   signature off), then spill and recalc preemption of a request whose
   group holds speculative commits not yet synced; every run's tokens
   must equal spec-OFF's, except a flip of a request not preempted where
   the ref path's top-2 logit margin is not clear (reported with the calls
   that computed the token in both runs and their group widths; the
   preempted request must be bitwise), every kernel's launches must
   equal its executor counter (flash: plus the gates' fidelity probe,
   the surrogates' build inside the counted run) and the paged launches
   the chain walks
   counted from the calls (2k - 1 per speculative call); with tokens/s,
   step wall, accept rate, each signature's probe fidelity and gate,
   peak memory and two profiled forced-accept steps;
6. adaptive: ``adaptive_serving_similarity`` on vicuna (its FPFT layer
   swapped for the equivalent base layer) over four 24-token prompts, six
   tokens each, on the CUDA route and on the kernels' plain versions
   (similarities within 1e-2), with ``shared_param_fraction`` of app-lora;
   then launch: ``repro_torch.launch.serve``'s real backend at
   TinyLlama-1.1B width (its own demo zoo, speculation on, 12 requests)
   and its sim backend at 20 apps, each printing the launcher's JSON (the
   sim's times are modeled from H100 constants, not measured); every
   kernel's launches equal the engine's calls in both real runs (flash:
   the executor's and the speculation gates' probe);
7. parity on the card: the fused megastep against the per-hop path, token
   for token, and ``attn_impl="cuda"`` against ``attn_impl="ref"`` (the
   three kernels' plain versions), equal wherever the ref run's top-2
   logit margin is clear;
8. the Model API of the dense family and the zoo's cross-size tools:
   model_api -- ``build_model`` at TinyLlama-1.1B's full width and depth
   (the zoo's base weights), 4 prompts of 64-512 tokens padded to 512 and
   64 greedy decode steps, flash once per layer in prefill and paged once
   per layer per step (the stacked cache's layer slice as one page of 576
   tokens per sequence), held against ``attn_impl="ref"`` (teacher-forced:
   probabilities within 2e-2, tokens equal at a clear margin) and against
   a ``BlockEngine`` serving app base (flips only below a top-2 margin of
   0.1), four decode steps under ``torch.profiler``, then
   ``zoo.profile_block``;
   model_api_int8 -- qwen1.5-32b's full width cut to 2 layers, its int8
   cache on the reference's plain route (counted), flash in prefill;
   cross_size -- qwen1.5-32b against qwen2-72b, full widths cut to 2
   layers: ``cross_size_equivalence``, ``train_stitching_block`` (the
   deepest loss under half the untrained stitch's), the stitched head
   similarity above the untrained one's, ``add_stitch`` + ``apply_block``,
   the peak memory;
9. the MoE family and the encoder-decoder on the Model API: moe_dbrx and
   moe_mixtral -- dbrx-132b and mixtral-8x22b at their published widths,
   depth cut to 2 layers, 4 padded prompts and 32 greedy steps on the
   dense expert scan (flash once per layer in prefill, the fused paged
   step in decode, mixtral's sliding window too), launches equal to the
   route counters, then teacher-forced against the kernels' plain
   versions, the top-k decode gather and lossless capacity dispatch (both
   runs' routing logged: rows whose own token took other experts counted,
   at most a quarter, the rest held to the chain bound; a first flip at a
   clear router gap fails), capacity 1.25's dropped
   fraction, one profiled step against the weights' read floor; then
   mixtral's window run: prompts of 8,192 and 6,000 tokens padded to
   8,192 (two windows) into the ring of 4,096 slots, 32 steps: flash with
   the window 2, the ring's insert and the attend-only paged launch 2 a
   step, held against the ref route as above; encdec --
   seamless-m4t-medium whole: the encoder on flash non-causal, the
   decoder's self-attention on flash and the fused paged step, its
   cross-attention on the attend-only paged kernel at ``src_len`` (the
   cross cache bitwise unchanged), against the ref route.  Each reports
   its resident bytes at the start and its peak;
10. the hybrid and SSM families, stablelm's head dim: hybrid --
   zamba2-2.7b whole (54 mamba layers, the shared attention block applied
   9 times, head dim 80, G = 1), 4 prompts padded to 512, 64 greedy
   steps: flash 9 a prefill, the fused paged step 9 a decode step, every
   shared-block application held against the ref route's from the same
   input, the whole runs by their tokens; then the ring run (one
   4,080-token prompt in the 4,096-slot window, 32 steps: the fused step,
   then the ring's insert and the attend-only launch at hd 80), held the
   same way; then the window run (one 8,192-token prompt, two windows,
   into the ring of 4,096 slots, 32 steps: flash with the window 9, the
   attend-only launch 9 a step), held the same way; ssm --
   xlstm-125m whole, 4 prompts padded to 512, 64 greedy steps, no kernel
   launched, an fp32 run of the same weights on the card held against the
   same run on the host's CPU (tokens at a clear margin), the bf16 run
   against fp32 reported, the prefill's launches (its two time loops')
   profiled;
   stablelm -- stablelm-12b's widths (head dim 160, G = 4) cut to 2
   layers, 4 prompts padded to 256, 32 steps: flash 2, paged 64, held
   against ref.  The kernels phase holds flash and paged at these shapes
   too;
11. training and checkpoints: train_dense -- TinyLlama-1.1B whole from
   the port's init (seed 0), 8 x 512-token batches of the data pipeline,
   the default AdamW in bf16 compute: 12 steps, then 4 at microbatches=2
   with bf16 gradients, an async checkpoint after step 8; no kernel
   launched (the train loss's attention on the plain route, counted once
   a layer a forward), every loss finite, the loss of step 1's batch
   fallen by ``TRAIN_FIXED_DROP``; step wall, tokens/s, model FLOPs and
   their share of the bf16 peak, peak memory, two profiled steps;
   train_resume -- that checkpoint restored into fresh tensors and steps
   9-12 trained again, losses and parameters bitwise the uninterrupted
   run's, then a SIGTERM to the process writing a blocking checkpoint;
   train_parity -- one fp32 ``value_and_grad`` on the card against the
   host's CPU (TinyLlama's widths at 2 layers and a reduced config of each
   other family): loss within 1e-5, every gradient within 1e-4 in
   relative L2; train_handoff -- the trained weights registered in a
   fresh zoo with a LoRA app, ``profile_block``, 8 requests served through
   the three kernels (launches equal to the executor's counters), the
   base app's tokens equal to the Model API's on a fresh copy of the
   weights at a clear margin;
12. the mesh code: mesh -- a real one-rank ``nccl`` process group and
   ``make_local_mesh()``'s (1, 1) ``DeviceMesh``; TinyLlama-1.1B whole
   through ``launch.steps.build_cell`` on DTensors: the train cell at
   train_dense's shape (8 x 512, default AdamW) for two steps of the
   pipeline's batches, held against ``make_train_step`` on the same
   batches and initial state (losses and every parameter and moment
   bitwise); the prefill and decode cells at model_api's traffic (4
   prompts of seed 11 padded to 512, the cache padded to 576, 64 greedy
   steps), the prefill logits and the 256 tokens held against the Model
   API called directly, flash 22 a prefill and paged 22 a step; the
   trained state saved whole and restored with ``shardings=`` onto the
   mesh, bitwise; then the dry-run records of two production cells
   (``launch.dryrun``, each in its own process, started with the script
   and traced on the ``meta`` device under a ``fake`` group of 256 or 512
   ranks: nothing runs on the card) with their per-device FLOPs, bytes,
   collective bytes by kind and trace time, and the roofline table over
   them.

The line before the last two gives each kernel's launches on the main
paths, its largest error against its plain version at their shapes, and
its times at the main-path shape named in ``case`` (all of its main-path
shapes' times in ``main_path_ms``; for paged attention, the fused decode
step the main paths launch, beside the plain scatter + attend); the last
line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing anything.
"""
import dataclasses
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.checkpoint import (  # noqa: E402
    Checkpointer,
    install_preemption_hook,
)
from repro_torch.configs import (  # noqa: E402
    ShapeConfig,
    get_config,
    get_reduced_config,
)
from repro_torch.core import peft  # noqa: E402
from repro_torch.core.peft import shared_param_fraction  # noqa: E402
from repro_torch.core.blocks import (  # noqa: E402
    apply_block,
    chain_prefill_fused,
    chain_signature,
    tree_leaves,
)
from repro_torch.core.equivalence import cross_size_equivalence  # noqa: E402
from repro_torch.core.stitching import (  # noqa: E402
    _hidden_at_layer,
    apply_stitch,
    make_stitch_block,
    stitched_head_similarity,
    train_stitching_block,
)
from repro_torch.core.zoo import BlockZoo  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.batched_lora import kernel as lora_kernel  # noqa: E402
from repro_torch.kernels.batched_lora.ops import (  # noqa: E402
    batched_lora,
    pack_segments,
)
from repro_torch.kernels.batched_lora.ref import batched_lora_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref,
)
from repro_torch.kernels.paged_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention,
    paged_decode_step,
    write_token_to_pages,
)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref,
)
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.launch.steps import build_cell, place  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.models.mamba2 import mamba_dims  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.moe_dispatch import dropped_fraction  # noqa: E402
from repro_torch.serving.api import ServeRequest  # noqa: E402
from repro_torch.serving.demo import build_demo_zoo  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    BlockEngine,
    EngineConfig,
    adaptive_serving_similarity,
)
from repro_torch.serving.executor import _bucket  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    adamw_update,
)
from repro_torch.training.train_loop import (  # noqa: E402
    TrainConfig,
    make_train_step,
    value_and_grad,
)
from repro_torch.tree import tree_flatten_with_paths, tree_map  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; dense bf16 tensor-core
# FLOP/s; fp32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
LORA_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}
# the flash kernel keeps P as a bf16 hi/lo pair (to ~2^-17) and its plain
# version in fp32, and both round the output once, so in bf16 they also
# agree within two bf16 ulps of the output
BF16_ULPS2 = dict(rtol=2.0 ** -6, atol=1e-5)
# the paged kernel does the same (P as a hi/lo pair, one rounding), and
# holds its bf16 output within one bf16 ulp of the fp32 plain version's
# (near zero, within 1e-5: the floor of BF16_ULPS2)
ULP_FLOOR = 1e-5
# at S >= 1,000 a bf16 output row averages ~1,000 keys and its elements
# are ~0.03-0.05, where the absolute 2e-2 barely constrains it: hold each
# row also by ||o - ref|| / ||ref||
ROW_REL_TOL, ROW_REL_MIN_S = 1e-2, 1000
# T of the split-threshold sweep: both LoRA paths timed at each, q and v
SPLIT_SWEEP_T = (128, 256, 512, 1024)
# paged attention's split lengths timed at the main path and the long shape
SPLIT_SWEEP_TOKENS = (64, 128, 256, 512)
LORA_RANK, LORA_BT = 8, 128  # peft.create_lora's rank; blocks' row tile
CLEAR_MARGIN = 0.25  # top-2 logit gap (~16 bf16 ulps at |logit| 2-4)
MODEL = "tinyllama-1.1b"
MAX_LEN = 256
PAGE = 16
N_REQUESTS, GEN_LEN = 12, 32
APPS = ("base", "vicuna", "app-lora")
# kernel name: (wrapper module with its launch count, source, TPU kernel)
KERNELS = {
    "paged_attention": (
        pa_kernel, "src/repro_torch/kernels/paged_attention/csrc/"
        "paged_attention.cu", "src/repro/kernels/paged_attention/kernel.py:71"),
    "flash_attention": (
        fa_kernel, "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:73"),
    "batched_lora": (
        lora_kernel, "src/repro_torch/kernels/batched_lora/csrc/"
        "batched_lora.cu", "src/repro/kernels/batched_lora/kernel.py:46"),
}
# engine counters whose sum each kernel's launches must equal on the main
# path: the executor's calls, and for flash also the speculation gate's
# fidelity probe (block and surrogate of each pruned attention hop)
KERNEL_COUNTERS = {"paged_attention": ("attn_calls",),
                   "flash_attention": ("prefill_attn_calls",
                                       "probe_attn_calls"),
                   "batched_lora": ("lora_calls",)}
LONG_MAX, LONG_GEN, LONG_REQUESTS = 2048, 16, 8
LONG_PROMPTS = (512, 2000)  # drawn from this range, plus one at its top
DEVICE = "cuda"
SPIN_CYCLES = 2_000_000  # ~1 ms at H100 clocks: longer than any enqueue here
PROFILE_STEPS = 8
ENGINE_REPEATS = 2  # more serves of the engine traffic, step wall only
SPEC_LOOKAHEAD = 4  # tokens per speculative call (1 pending + 3 drafts)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_launches() -> None:
    for module, _, _ in KERNELS.values():
        module.launches = 0


def read_launches() -> dict:
    return {name: module.launches for name, (module, _, _) in KERNELS.items()}


def engine_calls(stats) -> dict:
    """The engine counters of ``KERNEL_COUNTERS``, read from ``stats``."""
    return {c: stats[c] for cs in KERNEL_COUNTERS.values() for c in cs}


def check_launches(launches: dict, stats, what: str, off_path=()) -> None:
    """Each kernel launched exactly as often as the engine issued its
    calls, and at least once unless it is ``off_path`` (then never)."""
    for name, counters in KERNEL_COUNTERS.items():
        calls = sum(stats[c] for c in counters)
        if (calls == 0) != (name in off_path) or launches[name] != calls:
            raise RuntimeError(f"{what}: {name} launches {launches[name]} != "
                               f"engine {counters} {calls}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# gemm_rows: does a row of cuBLAS's bf16 GEMM depend on M?
# ---------------------------------------------------------------------------


DECODE_M = tuple(range(1, 17))  # decode group widths (max_block_batch 16)


def gemm_shapes(cfg):
    """(K, N) of every dense product of a hop: q and o, k and v, gate and
    up, down, lm_head."""
    D, hd = cfg.d_model, cfg.resolved_head_dim
    return sorted({(D, cfg.num_heads * hd), (D, cfg.num_kv_heads * hd),
                   (D, cfg.d_ff), (cfg.d_ff, D), (D, cfg.vocab_size)})


def row_classes(x, w, ms):
    """Group the row counts ``ms``: M joins the class of the first M' whose
    product ``x[:M'] @ w`` agrees bitwise with ``x[:M] @ w`` on the rows
    both have.  One class: rows do not depend on M."""
    outs = {m: x[:m] @ w for m in ms}
    classes = []
    for m in ms:
        for c in classes:
            n = min(m, c[0])
            if torch.equal(outs[m][:n], outs[c[0]][:n]):
                c.append(m)
                break
        else:
            classes.append([m])
    return classes


def gemm_rows_phase(cfg, paths, smi):
    """Whether a row of the engine's bf16 products is bitwise the same
    whatever the number of rows M in the call: at decode widths 1-16, and
    in prefill, a request's S rows alone against the same rows inside its
    group's padded (B x bucket) call, for every prefill group of
    ``paths``.  A recompute that rebuilds KV at another M than the one
    that first wrote it is bitwise only if every shape is independent."""
    g = torch.Generator(DEVICE).manual_seed(11)
    shapes = []
    for K, N in gemm_shapes(cfg):
        w = (torch.randn(K, N, generator=g, device=DEVICE) / K ** 0.5).to(
            torch.bfloat16)
        x = torch.randn(max(DECODE_M), K, generator=g,
                        device=DEVICE).to(torch.bfloat16)
        prefill = []
        for reqs in paths:
            groups = {}
            for r in reqs:
                key = (r.app, _bucket(r.prompt_len))
                groups.setdefault(key, []).append(r.prompt_len)
            for (_, bucket), lens in sorted(groups.items()):
                xb = torch.randn(len(lens) * bucket, K, generator=g,
                                 device=DEVICE).to(torch.bfloat16)
                yb = xb @ w
                for b, S in enumerate(lens):
                    rows = slice(b * bucket, b * bucket + S)
                    ys = xb[rows] @ w
                    differ = int((ys != yb[rows]).any(dim=1).sum())
                    prefill.append({"M": len(lens) * bucket, "S": S,
                                    "rows_differ": differ})
        classes = row_classes(x, w, DECODE_M)
        shapes.append({"K": K, "N": N, "decode_classes": classes,
                       "prefill": prefill,
                       "independent": len(classes) == 1
                       and not any(p["rows_differ"] for p in prefill)})
        del w, x
    torch.cuda.synchronize()
    row = {"phase": "gemm_rows", "dtype": "torch.bfloat16",
           "decode_M": list(DECODE_M), "shapes": shapes,
           "independent": all(s["independent"] for s in shapes), "card": smi}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_inputs(B, Hq, KVH, hd, nps, seq_lens, num_pages, dtype, seed):
    """q, page slabs, shuffled disjoint page tables padded with trash page 0
    past each row's last page, and the int32 lengths, on the card."""
    g = torch.Generator(DEVICE).manual_seed(seed)
    dev = torch.device(DEVICE)
    q = torch.randn(B, Hq, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(num_pages, PAGE, KVH, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(num_pages, PAGE, KVH, hd, generator=g, device=dev).to(dtype)
    rng = np.random.RandomState(seed)
    pages = rng.permutation(num_pages - 1)[:B * nps] + 1
    tables = pages.reshape(B, nps).astype(np.int32)
    for b, n in enumerate(seq_lens):
        tables[b, -(-n // PAGE):] = 0
    return (q, k, v, torch.from_numpy(tables).to(dev),
            torch.tensor(seq_lens, dtype=torch.int32, device=dev))


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of one call of ``fn``, with the L2 cache flushed
    before each call (the serving engine finds a layer's pages cold: 22
    layers' worth of KV and weights pass through the 50 MB L2 between two
    visits).  A spin kernel keeps the card busy while the host enqueues the
    start event, the call and the end event, so the events bracket device
    work only, not the Python wrapper's host time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(q, seq_lens, KVH, dtype, fused=False, page=PAGE):
    """Least time for this call: bytes each input read once and the output
    written once (K/V only for the valid tokens, table entries only for the
    pages those tokens use) over HBM bandwidth, against 4*len*Hq*hd flops
    over the dtype's peak.  The fused step reads the new token's K/V row
    from k_new/v_new instead of the pages and writes it to them.  Returns
    (ms, "bytes" | "operations")."""
    B, Hq, hd = q.shape
    item = q.element_size()
    total = int(sum(seq_lens))
    nbytes = (2 * q.numel() * item                    # q in, out
              + 2 * total * KVH * hd * item            # K and V
              + 4 * sum(-(-n // page) for n in seq_lens)  # table entries
              + 4 * B)                                 # seq_lens / kv_len
    if fused:
        nbytes += 2 * B * KVH * hd * item              # the new rows, stored
    return peak_bound(nbytes, 4.0 * total * Hq * hd, dtype)


def bf16_ulp_err(got, want) -> float:
    """Largest |got - want| in units of one bf16 ulp of ``want`` (at least
    ``ULP_FLOOR``)."""
    w = want.float()
    _, e = torch.frexp(w)  # w = m * 2^e, 0.5 <= |m| < 1
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      torch.ldexp(torch.ones_like(w), e - 8))
    return float(((got.float() - w).abs() / ulp.clamp_min(ULP_FLOOR)).max())


def peak_bound(nbytes: float, flops: float, dtype):
    """(ms, "bytes" | "operations"): the larger of bytes over HBM
    bandwidth and operations over the dtype's peak."""
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_yardstick(q, k, v, tables, seq_lens):
    """One SDPA call on K/V gathered beforehand (GQA enabled, boolean mask):
    a library yardstick timed here only; the port never calls it."""
    B, Hq, hd = q.shape
    _, page, KVH, _ = k.shape
    n = tables.shape[1]
    kd = k[tables.long()].reshape(B, n * page, KVH, hd).transpose(1, 2)
    vd = v[tables.long()].reshape(B, n * page, KVH, hd).transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    pos = torch.arange(n * page, device=q.device)
    mask = (pos[None, :] < seq_lens[:, None])[:, None, None, :]
    qd = q[:, :, None, :]

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True)

    return call


def decode_inputs(q, k, lens, seed):
    """The fused step's extra inputs for a case: the new token's K/V rows
    and kv_len = seq_len - 1, so the step attends over ``lens``."""
    g = torch.Generator(DEVICE).manual_seed(seed)
    B, KVH, hd = q.shape[0], k.shape[2], q.shape[2]
    k_new, v_new = (torch.randn(B, KVH, hd, generator=g, device=DEVICE)
                    .to(q.dtype) for _ in range(2))
    return k_new, v_new, lens - 1


def check_bf16_ulp(got, want, what):
    if got.dtype == torch.bfloat16 and not bf16_ulp_err(got, want) <= 1.0:
        raise RuntimeError(f"{what}: {bf16_ulp_err(got, want)} bf16 ulps "
                           "from the plain version (at most 1)")


def kernel_phase(cases, flush):
    """Paged decode attention at each case, bf16 and fp32: the attend-only
    launch and the fused decode step (one launch: store the new token's
    K/V at kv_len, attend over kv_len + 1) against their plain versions
    (``paged_attention_ref``; ``write_token_to_pages`` + it, pages bitwise),
    each timed beside SDPA on K/V gathered beforehand."""
    rows = []
    for name, (B, Hq, KVH, hd, nps, seq_lens, num_pages) in cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, tables, lens = kernel_inputs(
                B, Hq, KVH, hd, nps, seq_lens, num_pages, dtype, seed=len(rows))
            k_new, v_new, kv_len = decode_inputs(q, k, lens,
                                                 seed=len(rows))
            got = paged_attention(q, k, v, tables, lens, impl="cuda")
            torch.cuda.synchronize()
            want = paged_attention_ref(q, k, v, tables, lens)
            err = float((got.float() - want.float()).abs().max())
            tol = TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            check_bf16_ulp(got, want, f"paged {name}")
            # the fused step on copies of the pages, against the plain
            # scatter + attend on other copies
            kf, vf = k.clone(), v.clone()
            kr, vr = write_token_to_pages(k.clone(), v.clone(), tables,
                                          kv_len, k_new, v_new)
            fused = paged_decode_step(q, k_new, v_new, kf, vf, tables, kv_len,
                                      impl="cuda")[0]
            torch.cuda.synchronize()
            want_f = paged_attention_ref(q, kr, vr, tables, lens)
            if not (torch.equal(kf, kr) and torch.equal(vf, vr)):
                raise RuntimeError(f"paged {name}: the fused step's pages "
                                   "differ from write_token_to_pages'")
            del kr, vr
            f_err = float((fused.float() - want_f.float()).abs().max())
            torch.testing.assert_close(fused.float(), want_f.float(),
                                       rtol=tol, atol=tol)
            check_bf16_ulp(fused, want_f, f"paged {name} fused")
            iters = 50 if max(seq_lens) <= MAX_LEN else 20
            k_ms = time_ms(lambda: paged_attention(q, k, v, tables, lens,
                                                   impl="cuda"), iters, flush)
            f_ms = time_ms(lambda: paged_decode_step(
                q, k_new, v_new, kf, vf, tables, kv_len, impl="cuda"), iters,
                flush)
            r_ms = time_ms(lambda: paged_attention_ref(q, k, v, tables, lens),
                           iters, flush)
            s_ms = time_ms(lambda: paged_decode_step(
                q, k_new, v_new, kf, vf, tables, kv_len, impl="ref"), iters,
                flush)
            lib = sdpa_yardstick(q, k, v, tables, lens)
            lib_err = float((lib()[:, :, 0].float() - want.float()).abs().max())
            l_ms = time_ms(lib, iters, flush)
            b_ms, b_by = bound(q, seq_lens, KVH, dtype)
            fb_ms, fb_by = bound(q, seq_lens, KVH, dtype, fused=True)
            del kf, vf
            row = {"phase": "kernels", "kernel": "paged_attention",
                   "case": name, "dtype": str(dtype),
                   "B": B, "Hq": Hq, "KVH": KVH, "hd": hd, "page": PAGE,
                   "pages_per_seq": nps, "num_pages": num_pages,
                   "split_tokens": pa_kernel.SPLIT_TOKENS,
                   "splits": pa_kernel.num_splits(nps, PAGE),
                   "seq_len_sum": int(sum(seq_lens)),
                   "seq_len_max": int(max(seq_lens)), "tol": tol,
                   "max_abs_err": max(err, f_err), "attend_max_abs_err": err,
                   "fused_max_abs_err": f_err,
                   "bf16_ulps": bf16_ulp_err(got, want)
                   if dtype == torch.bfloat16 else None,
                   "fused_bf16_ulps": bf16_ulp_err(fused, want_f)
                   if dtype == torch.bfloat16 else None,
                   "pages_bitwise_equal": True,
                   "library_max_abs_err": lib_err,
                   "kernel_ms": k_ms, "fused_ms": f_ms, "ref_ms": r_ms,
                   "plain_step_ms": s_ms, "library_ms": l_ms,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "fused_bound_ms": fb_ms, "fused_bound_by": fb_by}
            emit(row)
            rows.append(row)
    return rows


def paged_split_sweep(cases, flush):
    """The split length's measurement: bf16 paged attention at each of
    ``SPLIT_SWEEP_TOKENS``, attend only and the fused step, each held
    against the plain version; ``pa_kernel.SPLIT_TOKENS`` is what the
    wrapper uses."""
    for name, (B, Hq, KVH, hd, nps, seq_lens, num_pages) in cases.items():
        q, k, v, tables, lens = kernel_inputs(
            B, Hq, KVH, hd, nps, seq_lens, num_pages, torch.bfloat16, seed=7)
        k_new, v_new, kv_len = decode_inputs(q, k, lens, seed=7)
        kf, vf = k.clone(), v.clone()  # the fused step writes these
        want = paged_attention_ref(q, k, v, tables, lens)
        iters = 50 if max(seq_lens) <= MAX_LEN else 20
        for split in SPLIT_SWEEP_TOKENS:
            got = pa_kernel.paged_attention_cuda(q, k, v, tables, lens,
                                                 split_tokens=split)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOL[torch.bfloat16],
                                       atol=TOL[torch.bfloat16])
            check_bf16_ulp(got, want, f"paged sweep {name} {split}")
            a_ms = time_ms(lambda s=split: pa_kernel.paged_attention_cuda(
                q, k, v, tables, lens, split_tokens=s), iters, flush)
            f_ms = time_ms(lambda s=split: pa_kernel.paged_decode_cuda(
                q, k_new, v_new, kf, vf, tables, kv_len, split_tokens=s),
                iters, flush)
            emit({"phase": "kernels", "kernel": "paged_attention",
                  "case": f"split_sweep_{name}_S{split}",
                  "dtype": str(torch.bfloat16), "B": B,
                  "seq_len_max": int(max(seq_lens)), "split_tokens": split,
                  "splits": pa_kernel.num_splits(nps, PAGE, split),
                  "kernel_ms": a_ms, "fused_ms": f_ms,
                  "wrapper_split": pa_kernel.SPLIT_TOKENS})


def paged_attention_cases(cfg):
    """Paged cases: (B, Hq, KVH, hd, pages per seq, seq_lens, pool pages).
    The demo and TinyLlama heads at ragged lengths, the engine's decode
    batch (``main_path``: four of its requests at prompt + half the
    generation, in a pool the size of the engine's; ``main_spec``: the same
    under speculation, tables widened by its headroom), a long-context
    batch and the long_prefill path's decode groups."""
    H, G_kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    nps = MAX_LEN // PAGE
    engine_pages = 1 + 16 * nps * cfg.num_layers
    spec_nps = -(-(MAX_LEN + SPEC_LOOKAHEAD) // PAGE)
    rng = np.random.RandomState(0)
    ragged = [1, 16, 17, MAX_LEN]
    main_lens = [int(r.prompt_tokens.shape[0]) + GEN_LEN // 2
                 for r in traffic(cfg)[:4]]

    def lens(edge, n, hi):
        return edge + [int(x) for x in rng.randint(1, hi + 1, n)]

    return {
        "demo": (8, 8, 4, 32, nps, lens(ragged, 4, MAX_LEN), 1 + 8 * nps),
        "tinyllama": (16, H, G_kv, hd, nps,
                      lens(ragged, 12, MAX_LEN), 1 + 16 * nps),
        "main_path": (4, H, G_kv, hd, nps, main_lens, engine_pages),
        # the same batch under speculation: slots and tables widened by the
        # lookahead headroom (17 pages a row, 3 splits instead of 2)
        "main_spec": (4, H, G_kv, hd, spec_nps, main_lens,
                      1 + 16 * spec_nps * cfg.num_layers),
        "long": (16, H, G_kv, hd, 4096 // PAGE,
                 lens([1, 16, 17, 4096], 12, 4096), 1 + 16 * 4096 // PAGE),
        **long_decode_cases(cfg, long_traffic(cfg)),
    }


def long_decode_cases(cfg, reqs):
    """Paged cases at the long_prefill path's decode shapes: one decode
    group per app (its own chain), each row at its prompt plus half the
    generation, the table as wide as the group's longest lifetime slot
    (prompt + generation, as the engine allocates)."""
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cases = {}
    for app in sorted({r.app for r in reqs}):
        group = [r for r in reqs if r.app == app]
        nps = max(-(-(r.prompt_len + r.gen_len) // PAGE) for r in group)
        lens = [r.prompt_len + LONG_GEN // 2 for r in group]
        cases[f"main_long_{app}_B{len(group)}"] = (
            len(group), H, KVH, hd, nps, lens, 1 + len(group) * nps)
    return cases


def window_pairs(S: int, W: int) -> int:
    """Query-key pairs a causal prefill of S keeps: sum_i min(i + 1, W)
    under a window W > 0, S (S + 1) / 2 without."""
    if not W or W >= S:
        return S * (S + 1) // 2
    return W * (W + 1) // 2 + (S - W) * W


def window_sdpa(q, k, v, window):
    """One SDPA call with an explicit boolean window mask (key j kept for
    row i iff i - W < j <= i), ``enable_gqa=True``, on K/V expanded to q's
    heads beforehand (its GQA path takes no mask): a library yardstick
    timed here only; the port never calls it.  The math backend, which
    would build the (B, Hq, S, S) scores, is not allowed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    G = q.shape[1] // k.shape[1]
    qc = q.contiguous()
    kc, vc = (t.repeat_interleave(G, dim=1).contiguous() for t in (k, v))
    i = torch.arange(q.shape[2], device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=mask, enable_gqa=True)

    return call


def flash_phase(cases, flush):
    """Flash attention forward: the kernel on (B, S, H, hd) tensors seen
    as (B, H, S, hd) views, as the serving path hands them over; a case's
    optional seventh field is its sliding window (0: none).  A windowed
    case also times the kernel without the window at its shape, and where
    the window keeps under a quarter of the causal pairs its bf16 time
    must be under half the causal time (the tiles before each window are
    skipped, not masked)."""
    rows = []
    for name, (B, Hq, KVH, S, hd, causal, *opt) in cases.items():
        window = opt[0] if opt else 0
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(DEVICE).manual_seed(len(rows))
            q, k, v = (torch.randn(B, S, h, hd, generator=g, device=DEVICE)
                       .to(dtype).transpose(1, 2) for h in (Hq, KVH, KVH))
            got = flash_attention(q, k, v, causal=causal, window=window,
                                  impl="cuda")
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, causal=causal, window=window)
            err = float((got.float() - want.float()).abs().max())
            row_rel = float(((got.float() - want.float()).norm(dim=-1)
                             / want.float().norm(dim=-1)).max())
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOL[dtype], atol=TOL[dtype])
            if dtype == torch.bfloat16:
                torch.testing.assert_close(got.float(), want.float(),
                                           **BF16_ULPS2)
                if S >= ROW_REL_MIN_S and not row_rel <= ROW_REL_TOL:
                    raise RuntimeError(f"flash {name}: row relative error "
                                       f"{row_rel} > {ROW_REL_TOL}")
            del want
            iters = 2 if S >= 16384 else 3 if S >= 8192 else 5 \
                if S >= 1024 else 20
            k_ms = time_ms(lambda: flash_attention(
                q, k, v, causal=causal, window=window, impl="cuda"), iters,
                flush)
            r_ms = time_ms(lambda: flash_attention_ref(
                q, k, v, causal=causal, window=window), iters, flush)
            if window:
                sdpa = window_sdpa(q, k, v, window)
            else:
                qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()

                def sdpa():  # library yardstick, timed only
                    return torch.nn.functional.scaled_dot_product_attention(
                        qc, kc, vc, is_causal=causal, enable_gqa=True)

            lib_err = float((sdpa().float() - got.float()).abs().max())
            l_ms = time_ms(sdpa, iters, flush)
            del sdpa
            extra = {}
            if window:  # the same shape without the window
                c_ms = time_ms(lambda: flash_attention(q, k, v, impl="cuda"),
                               iters, flush)
                ratio = window_pairs(S, window) / window_pairs(S, 0)
                extra = {"window": window, "causal_kernel_ms": c_ms,
                         "pairs_over_causal": ratio,
                         "ms_over_causal": k_ms / c_ms}
                if dtype == torch.bfloat16 and ratio < 0.25 \
                        and not k_ms < 0.5 * c_ms:
                    raise RuntimeError(
                        f"flash {name}: {k_ms} ms with the window against "
                        f"{c_ms} ms causal: the window keeps {ratio} of the "
                        "pairs, so its skipped tiles should halve the time")
            item = q.element_size()
            pairs = window_pairs(S, window) if causal else S * S
            b_ms, b_by = peak_bound(
                (2 * B * Hq + 2 * B * KVH) * S * hd * item,
                4.0 * B * Hq * hd * pairs, dtype)
            row = {"phase": "kernels", "kernel": "flash_attention",
                   "case": name, "dtype": str(dtype), "B": B, "Hq": Hq,
                   "KVH": KVH, "S": S, "hd": hd, "causal": causal,
                   "tol": TOL[dtype], "max_abs_err": err,
                   "max_row_rel_err": row_rel,
                   "row_rel_tol": ROW_REL_TOL if dtype == torch.bfloat16
                   and S >= ROW_REL_MIN_S else None,
                   "library_max_abs_err": lib_err, "kernel_ms": k_ms,
                   "ref_ms": r_ms, "library_ms": l_ms, "bound_ms": b_ms,
                   "bound_by": b_by, **extra}
            emit(row)
            rows.append(row)
    return rows


def lora_inputs(T, D, F, G, r, dtype, seed):
    g = torch.Generator(DEVICE).manual_seed(seed)

    def arr(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=DEVICE)
                * scale).to(dtype)

    return (arr(T, D), arr(D, F, scale=D ** -0.5),
            arr(G, D, r, scale=D ** -0.5), arr(G, r, F, scale=r ** -0.5))


def lora_phase(cases, flush):
    """Batched LoRA: G = 1 at the serving path's widths (TinyLlama q and v
    projections, rank 8), four adapters in ragged segments packed by
    ``pack_segments``, and a T off the 128-row tile."""
    rows = []
    for name, (T, D, F, G, r, bt) in cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            x, w, a, b = lora_inputs(T, D, F, G, r, dtype, seed=len(rows))
            if G == 1:
                tiles = torch.zeros(-(-T // bt), dtype=torch.int32,
                                    device=DEVICE)
            else:  # T rows of G adapters in ragged segments, tile-aligned
                gid = np.random.RandomState(len(rows)).randint(0, G, size=T)
                order, tiles_np, padded = pack_segments(gid, bt=bt)
                keep = torch.from_numpy(order >= 0).to(DEVICE)
                x = x[torch.from_numpy(np.maximum(order, 0)).long()
                      .to(DEVICE)] * keep[:, None].to(dtype)
                tiles = torch.from_numpy(tiles_np).to(DEVICE)
            rows_in = x.shape[0]
            got = batched_lora(x, w, a, b, tiles, bt=bt, scaling=0.5,
                               impl="cuda")
            torch.cuda.synchronize()
            want = batched_lora_ref(x, w, a, b, tiles, bt=bt, scaling=0.5)
            err = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=LORA_TOL[dtype],
                                       atol=LORA_TOL[dtype])
            del want
            iters = 10 if rows_in * F >= 1 << 24 else 50
            k_ms = time_ms(lambda: batched_lora(
                x, w, a, b, tiles, bt=bt, scaling=0.5, impl="cuda"), iters,
                flush)
            r_ms = time_ms(lambda: batched_lora_ref(
                x, w, a, b, tiles, bt=bt, scaling=0.5), iters, flush)
            l_ms = lib_err = None
            if G == 1:
                def addmm():  # library yardstick, timed only
                    return torch.addmm(x @ w, x @ a[0], b[0], alpha=0.5)

                lib_err = float((addmm().float() - got.float()).abs().max())
                l_ms = time_ms(addmm, iters, flush)
            item = x.element_size()
            used = len(set(tiles.tolist()))
            b_ms, b_by = peak_bound(
                (rows_in * D + D * F + used * r * (D + F) + rows_in * F)
                * item + 4 * tiles.numel(),
                2.0 * rows_in * (D * F + r * (D + F)), dtype)
            row = {"phase": "kernels", "kernel": "batched_lora",
                   "case": name, "dtype": str(dtype), "T": rows_in, "D": D,
                   "F": F, "G": G, "r": r, "bt": bt,
                   "tol": LORA_TOL[dtype], "max_abs_err": err,
                   "library_max_abs_err": lib_err, "kernel_ms": k_ms,
                   "ref_ms": r_ms, "library_ms": l_ms, "bound_ms": b_ms,
                   "bound_by": b_by}
            emit(row)
            rows.append(row)
    return rows


def split_sweep(D, widths, flush):
    """The split threshold's measurement: bf16 LoRA at each T of
    ``SPLIT_SWEEP_T`` and each projection width, through the split path and
    the tiled one (forced), each held against the plain version and the
    two against each other bit for bit, with ``addmm`` beside them.  The
    wrapper takes the split path for T <= ``lora_kernel.SPLIT_T``."""
    for T in SPLIT_SWEEP_T:
        for proj, F in widths.items():
            x, w, a, b = lora_inputs(T, D, F, 1, LORA_RANK, torch.bfloat16,
                                     seed=T + F)
            tiles = torch.zeros(-(-T // LORA_BT), dtype=torch.int32,
                                device=DEVICE)
            want = batched_lora_ref(x, w, a, b, tiles, bt=LORA_BT)
            outs = {p: lora_kernel.batched_lora_cuda(x, w, a, b, tiles,
                                                      bt=LORA_BT, split=p)
                    for p in (True, False)}
            torch.cuda.synchronize()
            for out in outs.values():
                torch.testing.assert_close(
                    out.float(), want.float(), rtol=LORA_TOL[torch.bfloat16],
                    atol=LORA_TOL[torch.bfloat16])
            if not torch.equal(outs[True], outs[False]):
                raise RuntimeError(f"LoRA T={T} {proj}: the split and tiled "
                                   "paths differ")
            ms = {p: time_ms(lambda p=p: lora_kernel.batched_lora_cuda(
                x, w, a, b, tiles, bt=LORA_BT, split=p), 50, flush)
                for p in (True, False)}
            l_ms = time_ms(lambda: torch.addmm(x @ w, x @ a[0], b[0]), 50,
                           flush)
            emit({"phase": "kernels", "kernel": "batched_lora",
                  "case": f"split_sweep_{proj}_T{T}",
                  "dtype": str(torch.bfloat16), "T": T, "D": D, "F": F,
                  "split_ms": ms[True], "tiled_ms": ms[False],
                  "library_ms": l_ms, "paths_bitwise_equal": True,
                  "wrapper_path": "split" if T <= lora_kernel.SPLIT_T
                  else "tiled"})


def prefill_groups(reqs) -> dict:
    """The batched prefill calls the engine makes for ``reqs`` admitted
    together, grouped as the executor groups them: one call per (chain,
    length bucket), each app its own chain.  Returns {(app, bucket): B}."""
    groups = {}
    for r in reqs:
        key = (r.app, _bucket(len(r.prompt_tokens)))
        groups[key] = groups.get(key, 0) + 1
    return groups


def main_path_cases(cfg, paths):
    """Flash and LoRA cases at the shapes the main paths give the kernels:
    for each prefill group (B, bucket), flash at (B, bucket) and, for an
    app-lora group, the q and v projections at T = B * bucket; for each
    app-lora decode batch width T = 1 .. (the path's app-lora requests),
    and each lane bucket a merged walk over the three apps' lanes runs
    (``executor._bucket`` of 1 .. the path's requests, capped at the
    engine's ``max_block_batch`` of 16), the q and v projections at T."""
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    width = {"q": H * hd, "v": KVH * hd}
    flash, lora = {}, {}
    for reqs in paths:
        for (app, S), B in sorted(prefill_groups(reqs).items()):
            flash[f"main_B{B}_S{S}"] = (B, H, KVH, S, hd, True)
            if app == "app-lora":
                for proj, F in width.items():
                    lora[f"main_prefill_{proj}_T{B * S}"] = (
                        B * S, cfg.d_model, F, 1, LORA_RANK, LORA_BT)
        merged = {min(_bucket(n), 16) for n in range(1, 1 + len(reqs))}
        for T in sorted(set(range(1, 1 + sum(r.app == "app-lora"
                                             for r in reqs))) | merged):
            for proj, F in width.items():
                lora[f"main_decode_{proj}_T{T}"] = (
                    T, cfg.d_model, F, 1, LORA_RANK, LORA_BT)
    return flash, lora


def check_prefill_calls(stats, reqs, n_attn: int, what: str,
                        recalcs: int = 0) -> None:
    """The prefill groups the main-path cases were built from are the calls
    the executor made: one flash launch per attention hop of each group's
    chain call and of each recompute prefill."""
    want = n_attn * (len(prefill_groups(reqs)) + recalcs)
    if stats["prefill_attn_calls"] != want:
        raise RuntimeError(f"{what}: prefill_attn_calls "
                           f"{stats['prefill_attn_calls']} != {want} from the "
                           f"derived groups {prefill_groups(reqs)}")


# ---------------------------------------------------------------------------
# phase 3: the engine at TinyLlama-1.1B width
# ---------------------------------------------------------------------------


def build_zoo():
    """The demo zoo at full width, with app-lora re-registered on LoRA
    adapters whose B matrices are nonzero (the recipe starts them at zero,
    which would make app-lora numerically the base model)."""
    cfg, _, zoo = build_demo_zoo(0, config=MODEL, device=DEVICE)
    lora = peft.create_lora(cfg, torch.Generator(DEVICE).manual_seed(2))
    g = torch.Generator(DEVICE).manual_seed(100)
    for layer in lora:
        layer["b_q"].normal_(0.0, 0.05, generator=g)
        layer["b_v"].normal_(0.0, 0.05, generator=g)
    zoo.register_peft("app-lora", cfg, "base", "lora", lora)
    torch.cuda.synchronize()
    return cfg, zoo


def traffic(cfg, n=N_REQUESTS, gen_len=GEN_LEN, seed=0):
    rng = np.random.RandomState(seed)
    return [ServeRequest(app=APPS[i % 3], gen_len=gen_len,
                         prompt_tokens=rng.randint(
                             0, cfg.vocab_size, size=int(rng.randint(16, 129))
                         ).astype(np.int32)) for i in range(n)]


def engine(zoo, **kw):
    return BlockEngine(zoo, max_len=MAX_LEN, config=EngineConfig(
        max_active=16, max_block_batch=16, page_size=PAGE, device=DEVICE,
        **kw))


def serve(eng, reqs, interleave=False):
    """Submit copies of ``reqs`` and drain; with ``interleave`` the second
    half joins one step after the first.  Returns results in request order."""
    reqs = [ServeRequest(app=r.app, gen_len=r.gen_len,
                         prompt_tokens=r.prompt_tokens) for r in reqs]
    half = len(reqs) // 2 if interleave else len(reqs)
    rids = [eng.submit(r) for r in reqs[:half]]
    done = {}
    if interleave:
        done.update({r.rid: r for r in eng.step()})
        rids += [eng.submit(r) for r in reqs[half:]]
    done.update({r.rid: r for r in eng.drain()})
    torch.cuda.synchronize()
    if sorted(done) != sorted(rids):
        raise RuntimeError(f"requests lost: {sorted(set(rids) - set(done))}")
    return [done[r] for r in rids]


def engine_phase(cfg, zoo, smi):
    reqs = traffic(cfg)
    # warm-up on a separate engine: cuBLAS handles, the per-block bf16
    # weight copies, the allocator's pools
    serve(engine(zoo), traffic(cfg, n=3, gen_len=4, seed=1))
    eng = engine(zoo)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    results = serve(eng, reqs)
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = dict(eng.stats)
    for r in results:
        if len(r.tokens) != GEN_LEN or r.tokens.min() < 0 \
                or r.tokens.max() >= cfg.vocab_size:
            raise RuntimeError(f"rid {r.rid}: bad tokens {r.tokens}")
        if r.probs_last is None or not np.isfinite(r.probs_last).all() \
                or abs(float(r.probs_last.sum()) - 1.0) > 1e-3:
            raise RuntimeError(f"rid {r.rid}: bad final distribution")
    check_launches(launches, stats, "engine")
    check_prefill_calls(stats, reqs, cfg.num_layers, "engine")
    snap = eng.metrics.snapshot()["histograms"]
    # the step wall moves with the host between calls: the same traffic
    # again on fresh engines, in this call, must give the same tokens
    repeats = []
    for _ in range(ENGINE_REPEATS):
        again = engine(zoo)
        t1 = time.perf_counter()
        out = serve(again, reqs)
        took = time.perf_counter() - t1
        for r, want in zip(out, results):
            if not np.array_equal(r.tokens, want.tokens):
                raise RuntimeError(f"engine repeat: tokens {r.tokens} != "
                                   f"{want.tokens}")
        repeats.append({"tok_per_s": sum(len(r.tokens) for r in out) / took,
                        "step_wall_p50_s": again.metrics.snapshot()[
                            "histograms"]["step_wall_s"]["p50"]})
    tokens = sum(len(r.tokens) for r in results)
    row = {"phase": "engine", "model": MODEL, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "requests": len(results),
           "apps": sorted({r.app for r in results}), "gen_len": GEN_LEN,
           "prompt_lens": [int(r.prompt_tokens.shape[0]) for r in reqs],
           "tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
           "step_wall_p50_s": snap["step_wall_s"]["p50"],
           "step_wall_p95_s": snap["step_wall_s"]["p95"],
           "ttft_p50_s": snap["ttft_s"]["p50"],
           "group_calls_per_token": stats["group_calls"]
           / max(stats["decode_tokens"], 1),
           "host_syncs": stats["host_syncs"], "steps": stats["steps"],
           "repeats": repeats,
           "launches": launches,
           "engine_calls": engine_calls(stats),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "card": smi}
    emit(row)
    return reqs, results, launches, row


def profiled(run):
    """Run ``run()`` (a list of engine steps) under ``torch.profiler``,
    kernels only.  Returns ([(device us, launches, kernel name)] sorted by
    time, the number of steps run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steps = len(run())
        torch.cuda.synchronize()
    return sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True), steps


def profile_phase(zoo, reqs, step_wall_p50):
    """Where the engine's time goes in steady decode: the same traffic on a
    fresh engine, ``PROFILE_STEPS`` engine steps after admission and
    prefill recorded with ``torch.profiler`` (kernels only).  The device's
    busy share is the device time per step over the measured (unprofiled)
    run's median step wall; the profiler's own host cost slows the
    profiled steps, not the device work they record."""
    eng = engine(zoo)
    for r in reqs:
        eng.submit(ServeRequest(app=r.app, gen_len=r.gen_len,
                                prompt_tokens=r.prompt_tokens))
    for _ in range(4):  # admission + prefill, then the decode groups form
        eng.step()
    torch.cuda.synchronize()
    by_kernel, _ = profiled(lambda: [eng.step()
                                     for _ in range(PROFILE_STEPS)])
    eng.drain()
    device_s = sum(us for us, _, _ in by_kernel) / 1e6 / PROFILE_STEPS

    def seconds(match):
        return sum(us for us, _, k in by_kernel if match(k)) / 1e6 \
            / PROFILE_STEPS

    split = {name: seconds(lambda k, n=name: n in k) for name in KERNELS}
    split["gemm"] = seconds(lambda k: "nvjet" in k or "gemm" in k.lower())
    row = {"phase": "profile", "steps": PROFILE_STEPS,
           "device_s_per_step": device_s, "step_wall_p50_s": step_wall_p50,
           "device_busy_share": device_s / step_wall_p50,
           "s_per_step": split,
           "share_of_device": {k: v / max(device_s, 1e-12)
                               for k, v in split.items()},
           "kernel_launches_per_step": sum(n for _, n, _ in by_kernel)
           / PROFILE_STEPS,
           "top": [{"kernel": k[:80], "device_ms_per_step":
                    us / 1e3 / PROFILE_STEPS, "calls_per_step":
                    n / PROFILE_STEPS} for us, n, k in by_kernel[:8]]}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 4: long prompts, spill and recalc preemption
# ---------------------------------------------------------------------------


def long_traffic(cfg, seed=3):
    """Eight requests, three of them app-lora, prompts drawn from
    512-2,000 tokens plus one of exactly 2,000."""
    rng = np.random.RandomState(seed)
    apps = ["app-lora", "base", "vicuna"] * 3
    lo, hi = LONG_PROMPTS
    lens = [int(n) for n in rng.randint(lo, hi + 1, LONG_REQUESTS - 1)]
    lens.append(hi)
    return [ServeRequest(app=apps[i], gen_len=LONG_GEN,
                         prompt_tokens=rng.randint(0, cfg.vocab_size, size=n)
                         .astype(np.int32))
            for i, n in enumerate(lens)]


def long_engine(zoo):
    return BlockEngine(zoo, max_len=LONG_MAX + LONG_GEN, config=EngineConfig(
        max_active=LONG_REQUESTS, max_block_batch=LONG_REQUESTS,
        page_size=PAGE, device=DEVICE))


def long_prefill_phase(cfg, zoo, smi):
    """The traffic once as it comes, then again with one app-lora request
    spilled to host memory and one base request preempted for recompute
    after four decode steps; the tokens must not change by a bit.

    A first, cold run on its own engine goes before the measured one: the
    first long-prompt prefill in the process also pays one-time costs
    (the allocator growing to the long path's activations, library set-up)
    whose size depends on what ran before it, so its TTFT is reported
    apart (``cold_ttft_p95_s``) and its tokens must equal the measured
    run's."""
    reqs = long_traffic(cfg)
    cold = serve(long_engine(zoo), reqs)
    cold_ttft = max(r.info["ttft_s"] for r in cold)
    eng = long_engine(zoo)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    plain = serve(eng, reqs)
    wall = time.perf_counter() - t0
    launches = {"unpreempted": read_launches()}
    check_launches(launches["unpreempted"], eng.stats, "long_prefill")
    check_prefill_calls(eng.stats, reqs, cfg.num_layers, "long_prefill")
    peak = torch.cuda.max_memory_allocated()
    ttft = sorted(r.info["ttft_s"] for r in plain)
    prompt_tokens = sum(r.prompt_len for r in reqs)
    prefill_s = ttft[-1]  # all eight are admitted and prefilled together
    decoded = sum(len(r.tokens) for r in plain)

    eng = long_engine(zoo)
    reset_launches()
    rids = [eng.submit(ServeRequest(app=r.app, gen_len=r.gen_len,
                                    prompt_tokens=r.prompt_tokens))
            for r in reqs]
    done = {}
    for _ in range(4):  # admission + prefill, then decode steps
        done.update({r.rid: r for r in eng.step()})
    spilled = rids[[r.app for r in reqs].index("app-lora")]
    recalc = rids[[r.app for r in reqs].index("base")]
    if not (eng.preempt(spilled, "spill") and eng.preempt(recalc, "recalc")):
        raise RuntimeError("long_prefill: preemption found no resident "
                           "request")
    emitted = next(m["tokens_done"] for n, _, m in
                   eng.tracer.trace(recalc).events if n == "preempt")
    before = dict(read_launches(), calls=eng.stats["prefill_attn_calls"])
    done.update({r.rid: r for r in eng.step()})  # both readmit here
    readmit_flash = read_launches()["flash_attention"] - before[
        "flash_attention"]
    readmit_calls = eng.stats["prefill_attn_calls"] - before["calls"]
    done.update({r.rid: r for r in eng.drain()})
    torch.cuda.synchronize()
    launches["preempted"] = read_launches()
    stats = dict(eng.stats)
    check_launches(launches["preempted"], stats, "long_prefill preempted")
    check_prefill_calls(stats, reqs, cfg.num_layers,
                        "long_prefill preempted", recalcs=1)
    if sorted(done) != sorted(rids):
        raise RuntimeError(f"long_prefill: requests lost "
                           f"{sorted(set(rids) - set(done))}")
    for r, c, want in zip(reqs, cold, plain):
        if not np.array_equal(c.tokens, want.tokens):
            raise RuntimeError(f"long_prefill: {r.app} tokens {c.tokens} on "
                               f"a fresh engine != {want.tokens}")
    # bitwise, the recomputed request too: its prompt is prefilled again at
    # its unpadded length (flash's rows and the GEMMs' at these shapes do
    # not depend on the call's width: phase gemm_rows) and each emitted
    # position is rebuilt by the decode step that first wrote it
    for rid, r, want in zip(rids, reqs, plain):
        if not np.array_equal(done[rid].tokens, want.tokens):
            raise RuntimeError(f"long_prefill: rid {rid} ({r.app}) tokens "
                               f"{done[rid].tokens} != unpreempted "
                               f"{want.tokens}")
    if stats["spills"] != 1 or stats["recalc_readmits"] != 1:
        raise RuntimeError(f"long_prefill: spills {stats['spills']}, "
                           f"recalc_readmits {stats['recalc_readmits']}")
    recalc_events = [e["meta"] for e in done[recalc].info["trace"]["events"]
                     if e["name"] == "recalc"]
    prompt_len = reqs[rids.index(recalc)].prompt_len
    n_attn = cfg.num_layers
    if recalc_events != [{"tokens": prompt_len + emitted,
                          "prefilled": prompt_len, "replayed": emitted}] \
            or readmit_flash != n_attn or readmit_calls != n_attn:
        raise RuntimeError(f"long_prefill: recalc {recalc_events}, "
                           f"{readmit_flash} flash launches, want one chain "
                           f"of {n_attn} at the unpadded {prompt_len} prompt "
                           f"tokens and {emitted} replayed")
    spill_bytes = [e["meta"]["kv_bytes"]
                   for e in done[spilled].info["trace"]["events"]
                   if e["name"] == "spill"]
    row = {"phase": "long_prefill", "model": MODEL, "layers": cfg.num_layers,
           "requests": len(reqs), "apps": [r.app for r in reqs],
           "prompt_lens": [r.prompt_len for r in reqs], "gen_len": LONG_GEN,
           "prompt_tokens": prompt_tokens, "wall_s": wall,
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p95_s": float(np.percentile(ttft, 95)),
           "cold_ttft_p95_s": cold_ttft,
           "prefill_tok_per_s": prompt_tokens / prefill_s,
           "decode_tok_per_s": decoded / max(wall - prefill_s, 1e-9),
           "max_memory_allocated_bytes": peak, "spill_bytes": spill_bytes,
           "spilled": {"rid": spilled, "app": "app-lora"},
           "recalc": {"rid": recalc, "app": "base",
                      "prefilled": prompt_len, "replayed": emitted,
                      "flash_launches": readmit_flash},
           "bitwise_equal": True,
           "launches": launches,
           "engine_calls": engine_calls(stats),
           "card": smi}
    emit(row)
    return launches, row


# ---------------------------------------------------------------------------
# phase 5: speculation (draft-verify decoding)
# ---------------------------------------------------------------------------


def spec_engine(zoo, **kw):
    return engine(zoo, spec_lookahead=SPEC_LOOKAHEAD, **kw)


def log_calls(eng) -> dict:
    """Wrap ``eng``'s executor to record its decode calls: how many plain
    fused and speculative calls ran, and per request, for each call that
    advanced it, (kind, group width, index of the first token the call
    computed, how many it computed).  Token 0 comes from prefill; a plain
    call computes one token, a speculative call as many as it commits."""
    ex = eng.executor
    log = {"plain": 0, "spec": 0, "by_rid": {}}
    done: dict = {}  # rid -> tokens decode calls have computed so far
    fused, spec = ex.fused_step, ex.spec_step

    def note(kind, states, counts):
        log[kind] += 1
        for st, c in zip(states, counts):
            e = done.get(st.rid, 0)
            log["by_rid"].setdefault(st.rid, []).append(
                (kind, len(states), e + 1, int(c)))
            done[st.rid] = e + int(c)

    def fused_step(states, kv):
        out = fused(states, kv)
        note("plain", states, [1] * len(states))
        return out

    def spec_step(states, kv, *args, **kw):
        att, acc, cnt = spec(states, kv, *args, **kw)
        note("spec", states, cnt)
        return att, acc, cnt

    ex.fused_step, ex.spec_step = fused_step, spec_step
    return log


def computed_by(log, rid, j):
    """(kind, group width) of the call that computed token ``j`` of
    ``rid``."""
    if j == 0:
        return ("prefill", None)
    for kind, width, first, n in log["by_rid"].get(rid, []):
        if first <= j < first + n:
            return (kind, width)
    return (None, None)


def spec_gates(eng) -> dict:
    """Each app's signature: its worst probe fidelity over the pruned hops
    and whether the ``spec_min_fidelity`` gate let it on."""
    out = {}
    for app in APPS:
        steps = eng._steps(eng.zoo.chains[app], None)[0]
        ss = eng._spec_state(chain_signature(steps), steps)
        out[app] = {"fidelity": ss.fidelity, "enabled": ss.enabled}
    return out


def negate_drafts(eng) -> None:
    """Replace every app's surrogate lm_head with a negated copy: drafts
    become the model's argmin, so verification rejects them all (as
    tests/test_spec_decode.py forces rejection)."""
    for app in APPS:
        steps = eng._steps(eng.zoo.chains[app], None)[0]
        ss = eng._spec_state(chain_signature(steps), steps)
        head, adapters = ss.sur_steps[-1]
        p = dict(head.params, lm_head=-head.params["lm_head"])
        ss.sur_steps[-1] = (dataclasses.replace(
            head, id=head.id + "-neg", params=p, _compute={}, _scaling={}),
            adapters)


def spec_flips(zoo, reqs, got, want, logs, what, exact=()):
    """Tokens of ``got`` against spec-OFF's ``want``: each request whose
    stream differs is reported with the first differing token, the calls
    that computed it in both runs (kind, group width: cuBLAS may round a
    row differently at another M) and the ref path's top-2 logit margin
    there; a flip at a clear margin fails, and any flip of a request in
    ``exact`` (a preempted one: readmitted bitwise by design) fails."""
    flips = []
    for r, g, w in zip(reqs, got, want):
        diff = np.nonzero(g.tokens != w.tokens)[0]
        if not len(diff):
            continue
        j = int(diff[0])
        if g.rid in exact:
            raise RuntimeError(f"speculation {what}: preempted rid {g.rid} "
                               f"({r.app}) diverges from spec-OFF at token "
                               f"{j}: {g.tokens} != {w.tokens}")
        margin = ref_margin(zoo, r.app, np.concatenate(
            [r.prompt_tokens, w.tokens[:j]]))
        flips.append({"rid": g.rid, "app": r.app, "at": j,
                      "call": computed_by(logs[0], g.rid, j),
                      "spec_off_call": computed_by(logs[1], w.rid, j),
                      "ref_margin": margin})
        if margin > CLEAR_MARGIN:
            raise RuntimeError(f"speculation {what}: rid {g.rid} ({r.app}) "
                               f"diverges from spec-OFF at token {j} where "
                               f"the ref margin {margin} is clear: "
                               f"{flips[-1]}")
    return flips


def spec_row(name, eng, results, wall, log, launches, peak):
    stats = dict(eng.stats)
    snap = eng.metrics.snapshot()["histograms"]
    tokens = sum(len(r.tokens) for r in results)
    return {"run": name, "tokens": tokens, "wall_s": wall,
            "tok_per_s": tokens / wall,
            "step_wall_p50_s": snap["step_wall_s"]["p50"],
            "steps": stats["steps"],
            "group_calls_per_token": stats["group_calls"]
            / max(stats["decode_tokens"], 1),
            "host_syncs": stats["host_syncs"],
            "spec_attempts": stats["spec_attempts"],
            "spec_hits": stats["spec_hits"],
            "accept_rate": stats["spec_hits"]
            / max(stats["spec_attempts"], 1),
            "plain_calls": log["plain"], "spec_calls": log["spec"],
            "launches": launches,
            "engine_calls": engine_calls(stats),
            "max_memory_allocated_bytes": peak}


def check_walks(stats, log, n_attn, what, replayed=0):
    """Every decode call walked the chain as counted: one walk per plain
    call, 2k - 1 per speculative call, one per token a recompute replayed,
    n_attn paged launches per walk."""
    walks = log["plain"] + (2 * SPEC_LOOKAHEAD - 1) * log["spec"] + replayed
    if stats["attn_calls"] != n_attn * walks:
        raise RuntimeError(f"speculation {what}: attn_calls "
                           f"{stats['attn_calls']} != {n_attn} x {walks} "
                           f"walks ({log['plain']} plain, {log['spec']} "
                           f"speculative calls, {replayed} replayed)")


def spec_preempt_run(cfg, zoo, reqs, want, off_log, strategy):
    """Speculation forced on (prune 0: every draft a hit) over ``reqs``
    (one request of each app, as tests/test_spec_decode.py preempts three),
    the base request preempted after two engine steps while its group
    holds speculative commits not yet synced, readmitted by ``strategy``;
    ``want``/``off_log`` are spec-OFF's run of the same requests."""
    eng = spec_engine(zoo, speculation=True, spec_prune_ratio=0.0)
    reset_launches()  # the gates' probes launch flash: counted too
    spec_gates(eng)
    log = log_calls(eng)
    rids = [eng.submit(ServeRequest(app=r.app, gen_len=r.gen_len,
                                    prompt_tokens=r.prompt_tokens))
            for r in reqs]
    done = {}
    for _ in range(2):  # admission + prefill + a speculative call, then one
        done.update({r.rid: r for r in eng.step()})
    victim = rids[0]
    buffered = eng.executor.buffered(victim)
    if reqs[0].app != "base" or buffered < 2:
        raise RuntimeError(f"speculation {strategy}: rid {victim} holds "
                           f"{buffered} unsynced tokens (want >= 2)")
    if not eng.preempt(victim, strategy):
        raise RuntimeError(f"speculation {strategy}: rid {victim} not "
                           "resident")
    if eng._spec_churn != eng.config.spec_churn_steps:
        raise RuntimeError("speculation: preemption did not pause it")
    emitted = next(m["tokens_done"] for n, _, m in
                   eng.tracer.trace(victim).events if n == "preempt")
    done.update({r.rid: r for r in eng.drain()})
    torch.cuda.synchronize()
    launches = read_launches()
    stats = dict(eng.stats)
    what = f"speculation {strategy}"
    recalc = [m for n, _, m in eng.tracer.trace(victim).events
              if n == "recalc"]
    if strategy == "recalc" and recalc != [
            {"tokens": reqs[0].prompt_len + emitted,
             "prefilled": reqs[0].prompt_len, "replayed": emitted}]:
        raise RuntimeError(f"{what}: recompute {recalc}, want the "
                           f"{reqs[0].prompt_len}-token prompt prefilled and "
                           f"{emitted} emitted tokens replayed")
    check_launches(launches, stats, what)
    check_walks(stats, log, cfg.num_layers, what,
                replayed=sum(m["replayed"] for m in recalc))
    check_prefill_calls(stats, reqs, cfg.num_layers, what,
                        recalcs=int(strategy == "recalc"))
    key = "spills" if strategy == "spill" else "recalc_readmits"
    if stats[key] != 1 or not stats["spec_attempts"] \
            or stats["spec_hits"] != stats["spec_attempts"]:
        raise RuntimeError(f"{what}: {key} {stats[key]}, spec "
                           f"{stats['spec_hits']}/{stats['spec_attempts']}")
    got = [done[r] for r in rids]
    flips = spec_flips(zoo, reqs, got, want, (log, off_log), what,
                       exact=(victim,))
    return {"run": strategy, "rid": victim, "app": reqs[0].app,
            "unsynced_tokens": buffered, "tokens_done": emitted,
            "recalc": recalc[0] if recalc else None,
            "spec_attempts": stats["spec_attempts"],
            "spec_hits": stats["spec_hits"], "bitwise_equal": not flips,
            "flips": flips, "launches": launches}


def speculation_phase(cfg, zoo, smi):
    """The engine phase's traffic on fresh engines, lookahead 4: spec-OFF,
    spec-ON at the default prune ratio, forced accept (prune 0: each
    surrogate is its parent, every draft a hit) and forced reject (prune 0
    with each app's surrogate lm_head negated: no hit, until the
    accept-rate gate turns each signature off); then spill and recalc
    preemption in the middle of forced-accept speculation.  Every run's
    tokens must equal spec-OFF's (a flip only where the ref margin is not
    clear, reported), every kernel's launches its executor counter (flash
    plus the gates' fidelity probe), and attn_calls the walks counted from
    the calls; a run's counts are zeroed before its surrogates are built
    (and timed), so the probe's flash launches are counted."""
    reqs = traffic(cfg)
    n_attn = cfg.num_layers
    # The zoo's default cache of 32 surrogates is smaller than this zoo's
    # 45 FFN-bearing blocks (22 base layers, vicuna's layer 1, app-lora's
    # 22 FFN halves), so at the default every fresh engine rebuilt the
    # ones the last evicted (9-13 s an engine on the H100's host); hold
    # both prune ratios' sets, and restore the default after the phase.
    n_ffn = len({s.block_id for c in zoo.chains.values() for s in c.steps
                 if "w_gate" in zoo.blocks[s.block_id].params})
    cache_default = zoo.surrogate_cache_max
    zoo.surrogate_cache_max = max(cache_default, 2 * n_ffn)
    # warm-up: the surrogate FFN's GEMM shapes, the spec path's allocations
    serve(spec_engine(zoo, speculation=True, spec_prune_ratio=0.0),
          traffic(cfg, n=3, gen_len=8, seed=1))
    torch.cuda.reset_peak_memory_stats()
    runs = {"spec_off": dict(speculation=False),
            "spec_on": dict(speculation=True),
            "forced_accept": dict(speculation=True, spec_prune_ratio=0.0),
            "forced_reject": dict(speculation=True, spec_prune_ratio=0.0)}
    rows, results, logs, gates, launches_by_run = {}, {}, {}, {}, {}
    build_s = {}
    for name, kw in runs.items():
        eng = spec_engine(zoo, **kw)
        reset_launches()  # the gates' probes launch flash: counted too
        t0 = time.perf_counter()
        if eng.config.speculation:
            gates[name] = spec_gates(eng)
            if name == "forced_reject":
                negate_drafts(eng)
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        log = logs[name] = log_calls(eng)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = results[name] = serve(eng, reqs)
        wall = time.perf_counter() - t0
        if name == "forced_reject":  # every signature's gate tripped
            for app, gate in spec_gates(eng).items():
                gates[name][app]["enabled_at_end"] = gate["enabled"]
        launches = launches_by_run[name] = read_launches()
        stats = dict(eng.stats)
        check_launches(launches, stats, f"speculation {name}")
        check_walks(stats, log, n_attn, name)
        check_prefill_calls(stats, reqs, n_attn, f"speculation {name}")
        for r in out:
            if len(r.tokens) != GEN_LEN or r.probs_last is None \
                    or not np.isfinite(r.probs_last).all():
                raise RuntimeError(f"speculation {name}: rid {r.rid} bad "
                                   "output")
        rows[name] = spec_row(name, eng, out, wall, log, launches,
                              torch.cuda.max_memory_allocated())
    off = rows["spec_off"]
    if off["spec_attempts"] or logs["spec_off"]["spec"]:
        raise RuntimeError("speculation: spec-OFF ran speculative calls")
    acc, rej = rows["forced_accept"], rows["forced_reject"]
    if not 0 < acc["spec_hits"] == acc["spec_attempts"]:
        raise RuntimeError(f"forced accept: hits {acc['spec_hits']} of "
                           f"{acc['spec_attempts']} attempts")
    if rej["spec_attempts"] <= 0 or rej["spec_hits"] != 0 \
            or rej["steps"] != off["steps"] \
            or any(g["enabled_at_end"] for g in gates["forced_reject"].values()):
        raise RuntimeError(f"forced reject: hits {rej['spec_hits']} of "
                           f"{rej['spec_attempts']}, steps {rej['steps']} "
                           f"(spec-OFF {off['steps']}), gates "
                           f"{gates['forced_reject']}")
    flips = {name: spec_flips(zoo, reqs, results[name], results["spec_off"],
                              (logs[name], logs["spec_off"]), name)
             for name in runs if name != "spec_off"}
    few = reqs[:len(APPS)]  # one request of each app, base first
    off_eng = spec_engine(zoo)
    off_log = log_calls(off_eng)
    few_off = serve(off_eng, few)
    preempt = [spec_preempt_run(cfg, zoo, few, few_off, off_log, s)
               for s in ("spill", "recalc")]
    peak = max([r["max_memory_allocated_bytes"] for r in rows.values()]
               + [torch.cuda.max_memory_allocated()])
    profile = spec_profile(zoo, reqs, acc["step_wall_p50_s"])
    row = {"phase": "speculation", "model": MODEL, "layers": cfg.num_layers,
           "requests": len(reqs), "gen_len": GEN_LEN,
           "lookahead": SPEC_LOOKAHEAD, "runs": list(rows.values()),
           "gates": gates, "surrogate_build_s": build_s,
           "surrogate_cache": {"max": zoo.surrogate_cache_max,
                               "default": cache_default, "ffn_blocks": n_ffn,
                               "held": len(zoo._surrogate_cache)},
           "flips": flips, "bitwise_equal": not any(flips.values()),
           "preemption": preempt, "profile_forced_accept": profile,
           "max_memory_allocated_bytes": peak, "card": smi}
    emit(row)
    zoo.surrogate_cache_max = cache_default
    launches = {f"speculation_{k}": v for k, v in launches_by_run.items()}
    launches.update({f"speculation_{p['run']}": p["launches"]
                     for p in preempt})
    return launches, row


def spec_profile(zoo, reqs, step_wall_p50):
    """Two steady forced-accept engine steps under ``torch.profiler``
    (kernels only): device time per step and kernel launches per
    speculative call."""
    eng = spec_engine(zoo, speculation=True, spec_prune_ratio=0.0)
    spec_gates(eng)
    log = log_calls(eng)
    for r in reqs:
        eng.submit(ServeRequest(app=r.app, gen_len=r.gen_len,
                                prompt_tokens=r.prompt_tokens))
    for _ in range(2):  # admission + prefill + a first call, then another
        eng.step()
    torch.cuda.synchronize()
    before = log["spec"]
    by_kernel, prof_steps = profiled(lambda: [eng.step() for _ in range(2)])
    calls = log["spec"] - before
    eng.drain()
    device_s = sum(us for us, _, _ in by_kernel) / 1e6 / prof_steps
    paged = sum(n for _, n, k in by_kernel if "paged_attention" in k)
    return {"steps": prof_steps, "spec_calls": calls,
            "device_s_per_step": device_s, "step_wall_p50_s": step_wall_p50,
            "device_busy_share": device_s / step_wall_p50,
            "kernel_launches_per_spec_call":
            sum(n for _, n, _ in by_kernel) / max(calls, 1),
            "paged_launches_per_spec_call": paged / max(calls, 1)}


# ---------------------------------------------------------------------------
# phase 6: adaptive assembly (paper Fig. 20) and the serving launcher
# ---------------------------------------------------------------------------


ADAPTIVE_PROMPTS, ADAPTIVE_LEN, ADAPTIVE_GEN = 4, 24, 6
SIM_NOTE = ("modeled: the discrete-event simulator's times come from the "
            "H100 SXM constants of repro_torch.serving.cluster, not from "
            "this card")


def adaptive_phase(cfg, zoo, smi):
    """``adaptive_serving_similarity`` on vicuna: its own chain against
    the chain with its FPFT layer swapped for the equivalent base layer,
    output distributions compared; the CUDA route's similarity must be
    within 1e-2 of the kernels' plain versions' (``attn_impl="ref"``), and
    the kernels' launches equal the executor's calls (vicuna has no LoRA
    hop, so the LoRA kernel is off this path)."""
    prompts = np.random.RandomState(7).randint(
        0, cfg.vocab_size, size=(ADAPTIVE_PROMPTS, ADAPTIVE_LEN)).astype(
            np.int32)
    eng = engine(zoo)
    reset_launches()
    t0 = time.perf_counter()
    sim, swapped = adaptive_serving_similarity(zoo, eng, "vicuna", prompts,
                                               gen_len=ADAPTIVE_GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = dict(eng.stats)
    check_launches(launches, stats, "adaptive", off_path=("batched_lora",))
    ref_sim, ref_swapped = adaptive_serving_similarity(
        zoo, engine(zoo, attn_impl="ref"), "vicuna", prompts,
        gen_len=ADAPTIVE_GEN)
    if swapped < 1 or ref_swapped != swapped \
            or not abs(sim - ref_sim) <= 1e-2:
        raise RuntimeError(f"adaptive: {swapped} swapped, similarity {sim} "
                           f"against the ref route's {ref_sim} "
                           f"({ref_swapped} swapped)")
    base = [zoo.blocks[st.block_id].params for st in zoo.chains["base"].steps]
    adapters = [zoo.blocks[a].params for st in zoo.chains["app-lora"].steps
                for a in st.adapter_ids]
    row = {"phase": "adaptive", "model": MODEL, "app": "vicuna",
           "prompts": ADAPTIVE_PROMPTS, "prompt_len": ADAPTIVE_LEN,
           "gen_len": ADAPTIVE_GEN, "similarity": sim,
           "ref_similarity": ref_sim, "blocks_swapped": swapped,
           "shared_param_fraction_app_lora":
           shared_param_fraction(base, adapters),
           "wall_s": wall, "launches": launches,
           "engine_calls": engine_calls(stats),
           "card": smi}
    emit(row)
    return launches, row


LAUNCH_REQUESTS, LAUNCH_GEN = 12, 16


def launch_phase(smi):
    """``repro_torch.launch.serve`` as a user runs it: the real backend at
    TinyLlama-1.1B width on the card with the launcher's defaults
    otherwise (its own demo zoo, speculation on), 12 requests; its JSON,
    with every kernel's launches equal to the engine's counters; then the
    sim backend's JSON at 20 apps, whose times are modeled."""
    argv = ["--backend", "real", "--config", MODEL, "--device", DEVICE,
            "--requests", str(LAUNCH_REQUESTS), "--gen-len", str(LAUNCH_GEN),
            "--max-len", "64"]
    args = launcher.build_parser().parse_args(argv)
    reset_launches()
    real = launcher.run_real(args)
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches(launches, real["engine_stats"], "launch")
    if real["completed"] != LAUNCH_REQUESTS \
            or real["generated_tokens"] != LAUNCH_REQUESTS * LAUNCH_GEN:
        raise RuntimeError(f"launch: {real['completed']} completed, "
                           f"{real['generated_tokens']} tokens")
    sim = launcher.run_sim(launcher.build_parser().parse_args(
        ["--backend", "sim", "--apps", "20"]))
    if sim["completed"] != sim["completed_via_api"] or not sim["completed"]:
        raise RuntimeError(f"launch sim: {sim}")
    row = {"phase": "launch", "argv": argv, "real": real,
           "launches": launches, "sim_argv": ["--backend", "sim", "--apps",
                                              "20"],
           "sim": sim, "sim_note": SIM_NOTE, "card": smi}
    emit(row)
    return launches, row


# ---------------------------------------------------------------------------
# phase 7: parity on the card
# ---------------------------------------------------------------------------


def fused_vs_per_hop(cfg, zoo):
    """A single-app group (two app-lora requests, the second joining one
    step later so each prefill runs at the same shape on both paths):
    fused megastep and per-hop dispatch must give identical tokens."""
    rng = np.random.RandomState(7)
    reqs = [ServeRequest(app="app-lora", gen_len=12,
                         prompt_tokens=rng.randint(0, cfg.vocab_size, size=n)
                         .astype(np.int32)) for n in (32, 64)]
    fused = serve(engine(zoo), reqs, interleave=True)
    hop = serve(engine(zoo, fused=False), reqs, interleave=True)
    for f, h in zip(fused, hop):
        if not np.array_equal(f.tokens, h.tokens):
            raise RuntimeError(f"fused {f.tokens} != per-hop {h.tokens}")
    out = {"phase": "parity_fused_vs_per_hop", "app": "app-lora",
           "requests": len(reqs), "tokens_each": 12, "identical": True}
    emit(out)
    return out


def ref_margin(zoo, app, prefix):
    """Top-2 logit gap of the ref path's next token after ``prefix``
    (a prefill replay; log-probabilities differ from logits by a constant)."""
    chain = zoo.chains[app]
    steps = [(zoo.blocks[s.block_id],
              tuple(zoo.blocks[a] for a in s.adapter_ids))
             for s in chain.steps]
    tok = torch.as_tensor(prefix[None], dtype=torch.int32, device=DEVICE)
    lens = torch.tensor([len(prefix)], dtype=torch.int32, device=DEVICE)
    _, probs, _ = chain_prefill_fused(steps, tok, lens, attn_impl="ref")
    top2 = torch.log(probs[0]).topk(2).values
    return float(top2[0] - top2[1])


def cuda_vs_ref(zoo, reqs, cuda_results):
    ref = serve(engine(zoo, attn_impl="ref"), reqs)
    agree = compared = identical = 0
    divergences = []
    for req, c, r in zip(reqs, cuda_results, ref):
        diff = np.nonzero(c.tokens != r.tokens)[0]
        if not len(diff):
            identical += 1
            agree += len(c.tokens)
            compared += len(c.tokens)
            continue
        j = int(diff[0])
        agree += j
        compared += j + 1
        prefix = np.concatenate([req.prompt_tokens, r.tokens[:j]])
        divergences.append({"app": req.app, "at": j,
                            "ref_margin": ref_margin(zoo, req.app, prefix)})
    out = {"phase": "parity_cuda_vs_ref", "requests": len(reqs),
           "identical_streams": identical, "tokens_compared": compared,
           "tokens_agree": agree, "agreement": agree / max(compared, 1),
           "clear_margin": CLEAR_MARGIN, "divergences": divergences}
    emit(out)
    clear = [d for d in divergences if d["ref_margin"] > CLEAR_MARGIN]
    if clear:
        raise RuntimeError(f"cuda and ref disagree at a clear margin: {clear}")
    return out


# ---------------------------------------------------------------------------
# phase 8: the Model API (dense family), its cross-size tools
# ---------------------------------------------------------------------------

# model_api: TinyLlama-1.1B at full width and depth, 4 prompts of 64-512
# tokens padded to 512, a cache of 576, 64 greedy decode steps
API_B, API_S, API_MAX, API_GEN, API_SEED = 4, 512, 576, 64, 11
API_PROMPTS = (64, 512)
API_MARGIN = 0.1  # top-2 gap below which the Model API and engine may flip
# a whole bf16 chain's logits against the ref route's, in per-hop bounds:
# sound runs drift by a bf16 ulp or two, flat across the steps (1.57 at
# TinyLlama's 22 layers, 0.53 at 2 layers), where a fault in the cache, the
# positions or a kernel moves logits by whole units
API_CHAIN_BOUND = 3.0
API_PROFILE_STEPS = 4
# model_api_int8 and cross_size: full widths, depth cut to 2 layers
INT8_MODEL, CROSS_B_MODEL, CUT_LAYERS = "qwen1.5-32b", "qwen2-72b", 2
INT8_B, INT8_S, INT8_GEN = 2, 256, 16
CROSS_B, CROSS_S, CROSS_POINTS = 4, 128, ((1, 1), (2, 2))


def reset_routes() -> None:
    for routes in (T.PREFILL_ROUTES, T.DECODE_ROUTES):
        for k in routes:
            routes[k] = 0


def all_routes() -> dict:
    """Both route counters in one dict, the prefill's keys prefixed."""
    return {**{f"prefill_{k}": v for k, v in T.PREFILL_ROUTES.items()},
            **T.DECODE_ROUTES}


def settle() -> int:
    """Free what earlier phases left for the cyclic collector (engines and
    their executors refer to each other, and hold KV pools and zoos), so a
    phase's peak memory is its own and the resident set's.  Returns the
    bytes still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def api_prompts(cfg, B, S, lens, seed):
    """(tokens (B, S) right-padded with 0, prompt lengths (B,)) from a
    numpy seed, on the card: lengths drawn from the range ``lens``, or
    given per row where ``B`` is None."""
    rng = np.random.RandomState(seed)
    if B is None:
        n = np.asarray(lens, np.int32)
    else:
        n = rng.randint(lens[0], lens[1] + 1, size=B).astype(np.int32)
    tok = rng.randint(0, cfg.vocab_size, size=(len(n), S)).astype(np.int32)
    tok[np.arange(S)[None, :] >= n[:, None]] = 0
    return (torch.from_numpy(tok).to(DEVICE),
            torch.from_numpy(n).to(DEVICE))


def api_run(model, params, tokens, lens, max_len, steps, attn_impl,
            forced=None, frames=None, src_len=None):
    """Prefill, then ``steps`` decode steps through the Model API; greedy,
    or teacher-forced on ``forced`` (B, steps + 1); ``frames`` and
    ``src_len`` go to the encoder-decoder's prefill and decode.  Returns
    (tokens (B, steps + 1), fp32 logits (steps + 1, B, V), prefill s, step
    s)."""
    batch = {"tokens": tokens, "prompt_lens": lens}
    if frames is not None:
        batch["frames"] = frames
    extra = {} if src_len is None else {"src_len": src_len}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, _ = model.prefill(params, batch, max_len=max_len,
                                     attn_impl=attn_impl)
    nxt = logits.argmax(-1) if forced is None else forced[:, 0]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    toks, out, step_s = [nxt], [logits.float()], []
    for j in range(steps):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(
            params, cache, {"tokens": nxt[:, None].to(torch.int32),
                            "kv_len": lens + j, **extra}, attn_impl=attn_impl)
        nxt = logits.argmax(-1) if forced is None else forced[:, j + 1]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        toks.append(nxt)
        out.append(logits.float())
    del cache
    return torch.stack(toks, 1), torch.stack(out), prefill_s, step_s


def top2_margin(logits):
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def hop_ratio(got, want, keep):
    """(|got - want| on the rows ``keep`` marks, the worst ratio of it to
    the per-hop bound 2e-2 + 2e-2 |want| + one bf16 ulp at the row's
    largest |logit|)."""
    mag = want.abs().amax(dim=-1, keepdim=True)
    _, e = torch.frexp(mag)
    bound = 2e-2 + 2e-2 * want.abs() + torch.ldexp(torch.ones_like(mag),
                                                   e - 8)
    err = (got - want).abs() * keep[..., None]
    return err, float((err / bound).max())


def hold_logits(got, want, what, keep=None):
    """A whole bf16 chain against the same chain on the kernels' plain
    versions, teacher-forced on the same tokens: every logit within
    ``API_CHAIN_BOUND`` times the per-hop bound (2e-2 + 2e-2 |x| + one
    bf16 ulp at the row's largest |logit|), and greedy tokens equal where
    ``want``'s top-2 gap exceeds 0.1 (each kernel is held elementwise at
    these shapes in the kernels phase); only the rows (step, sequence)
    ``keep`` marks, if given.  Returns the logits' largest error per step,
    their worst ratio to the per-hop bound and the tokens compared."""
    if keep is None:
        keep = torch.ones(want.shape[:-1], dtype=torch.bool,
                          device=want.device)
    err, worst = hop_ratio(got, want, keep)
    clear = (top2_margin(want) > API_MARGIN) & keep
    flips = int((got.argmax(-1) != want.argmax(-1))[clear].sum())
    if not worst <= API_CHAIN_BOUND or flips:
        raise RuntimeError(f"{what}: kernel route against ref: logits at "
                           f"{worst} x the per-hop bound (at most "
                           f"{API_CHAIN_BOUND}), {flips} token flips at a "
                           "clear margin")
    return {"logits_max_abs_err_per_step":
            err.amax(dim=(1, 2)).tolist(),
            "logits_worst_err_over_hop_bound": worst,
            "tokens_compared_at_clear_margin": int(clear.sum())}


def model_api_phase(cfg, zoo, smi):
    """``build_model(cfg)`` at TinyLlama-1.1B's full width and depth on the
    card, random weights from seed 0 (the demo zoo's base app's own):
    prefill B = 4 padded prompts, then 64 greedy decode steps; flash
    launches 22 per prefill, paged 22 per step (the cache's layer slice as
    one page per sequence), LoRA none.  Then the kernel route against
    ``attn_impl="ref"`` (teacher-forced on the same tokens), the Model
    API's stream against a ``BlockEngine`` serving app ``base`` on the
    same weights, and ``zoo.profile_block`` on one layer block."""
    resident = settle()
    model = build_model(cfg)
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    base = [zoo.blocks[s.block_id] for s in zoo.chains["base"].steps]
    if not (torch.equal(params["embed"], base[0].params["embed"])
            and torch.equal(params["layers"]["wq"][0],
                            base[1].params["wq"])):
        raise RuntimeError("model_api: weights differ from the zoo's base")
    tokens, lens = api_prompts(cfg, API_B, API_S, API_PROMPTS, API_SEED)
    # warm-up: the weights' bf16 casts, the allocator, cuBLAS
    api_run(model, params, tokens, lens, API_MAX, 2, "auto")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_routes()
    got_tok, got, prefill_s, step_s = api_run(model, params, tokens, lens,
                                              API_MAX, API_GEN, "auto")
    launches = read_launches()
    routes = dict(T.DECODE_ROUTES)
    peak = torch.cuda.max_memory_allocated()
    L_ = cfg.num_layers
    want_launches = {"paged_attention": L_ * API_GEN, "flash_attention": L_,
                     "batched_lora": 0}
    if launches != want_launches or routes["paged"] != L_ * API_GEN \
            or sum(routes.values()) != L_ * API_GEN:
        raise RuntimeError(f"model_api: launches {launches}, routes {routes};"
                           f" want {want_launches}")
    if not torch.isfinite(got).all() or got.shape != (
            API_GEN + 1, API_B, cfg.vocab_size):
        raise RuntimeError(f"model_api: logits {tuple(got.shape)} not finite")
    _, want, _, _ = api_run(model, params, tokens, lens, API_MAX, API_GEN,
                            "ref", forced=got_tok)
    vs_ref = hold_logits(got, want, "model_api")
    # the engine on the same weights, app base, the unpadded prompts
    eng = BlockEngine(zoo, max_len=API_MAX, config=EngineConfig(
        max_active=16, max_block_batch=16, page_size=PAGE, device=DEVICE))
    host_tok, host_lens = tokens.cpu().numpy(), lens.cpu().numpy()
    served = serve(eng, [ServeRequest(app="base", gen_len=API_GEN,
                                      prompt_tokens=host_tok[b, :n])
                         for b, n in enumerate(host_lens)])
    api_tok = got_tok[:, :API_GEN].cpu().numpy()
    margins = top2_margin(want).cpu().numpy()  # (steps + 1, B)
    equal, flips = 0, []
    for b, r in enumerate(served):
        diff = np.nonzero(r.tokens != api_tok[b])[0]
        j = int(diff[0]) if len(diff) else API_GEN
        equal += j
        if len(diff):
            flips.append({"request": b, "at": j,
                          "ref_margin": float(margins[j, b])})
    if any(f["ref_margin"] >= API_MARGIN for f in flips):
        raise RuntimeError(f"model_api: Model API and engine flip at a "
                           f"clear margin: {flips}")
    del eng, served
    # four steady decode steps under torch.profiler: device time and
    # launches a step, against the unprofiled run's step wall
    _, cache, _ = model.prefill(params, {"tokens": tokens,
                                         "prompt_lens": lens},
                                max_len=API_MAX)
    nxt = got_tok[:, 0]

    def steps():
        return [model.decode_step(params, cache, {
            "tokens": nxt[:, None].to(torch.int32), "kv_len": lens + j})[0]
            for j in range(API_PROFILE_STEPS)]

    by_kernel, n = profiled(steps)
    del cache
    device_s = sum(us for us, _, _ in by_kernel) / 1e6 / n
    step_p50 = float(np.percentile(step_s, 50))
    # the block profiler on the base's first layer block
    prof = zoo.profile_block(base[1].id, batch_sizes=(1, 8, 32), seq_len=64)
    prompt_tokens = int(lens.sum())
    decode_s = sum(step_s)
    row = {"phase": "model_api", "model": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "batch": API_B, "padded_S": API_S,
           "max_len": API_MAX, "prompt_lens": host_lens.tolist(),
           "decode_steps": API_GEN, "launches": launches, "routes": routes,
           "prefill_s": prefill_s,
           "prefill_tok_per_s": prompt_tokens / prefill_s,
           "decode_tok_per_s": API_B * API_GEN / decode_s,
           "decode_step_wall_p50_s": step_p50,
           "decode_step_wall_p95_s": float(np.percentile(step_s, 95)),
           "decode_profile": {
               "steps": n, "device_ms_per_step": device_s * 1e3,
               "device_busy_share": device_s / step_p50,
               "kernel_launches_per_step":
               sum(c for _, c, _ in by_kernel) / n,
               "paged_ms_per_step": sum(
                   us for us, _, k in by_kernel if "paged_attention" in k)
               / 1e3 / n},
           "max_memory_allocated_bytes": peak,
           "resident_bytes_at_start": resident,
           "vs_ref": vs_ref,
           "vs_engine": {"tokens_equal": equal,
                         "tokens_compared": API_B * API_GEN,
                         "flips": flips, "allowed_below": API_MARGIN},
           "profile_block": {"block": base[1].id, "seq_len": 64,
                             "bytes": prof.bytes,
                             "us_per_token": {
                                 bs: t * 1e6 for bs, t in
                                 prof.compute_time_per_token.items()}},
           "card": smi}
    emit(row)
    del params
    return launches, row


def cut_config(name):
    """A config at its published widths with its depth cut to
    ``CUT_LAYERS``."""
    return get_config(name).replace(num_layers=CUT_LAYERS)


def init_params(cfg, seed):
    """Random weights from ``seed`` on the card, the qkv biases drawn too
    (the init's are zero)."""
    params = build_model(cfg).init(torch.Generator(DEVICE).manual_seed(seed))
    if cfg.qkv_bias:
        g = torch.Generator(DEVICE).manual_seed(seed + 1000)
        for name in ("bq", "bk", "bv"):
            params["layers"][name].normal_(0.0, 0.1, generator=g)
    return params


def model_api_int8_phase(smi):
    """qwen1.5-32b's full width (d 5120, 40 MHA heads, hd 128, qkv bias,
    int8 KV), depth cut to 2: prefill B = 2 x 256 through flash, then 16
    greedy decode steps on the int8 route the config picks (the reference's
    plain dequantize-and-attend: no paged launch), held against the ref
    route.  Returns (launches, row, cfg, params) for cross_size."""
    resident = settle()
    cfg = cut_config(INT8_MODEL)
    model = build_model(cfg)
    params = init_params(cfg, 0)
    tokens, lens = api_prompts(cfg, INT8_B, INT8_S, (INT8_S, INT8_S), 12)
    api_run(model, params, tokens, lens, INT8_S + INT8_GEN, 1, "auto")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_routes()
    got_tok, got, prefill_s, step_s = api_run(
        model, params, tokens, lens, INT8_S + INT8_GEN, INT8_GEN, "auto")
    launches = read_launches()
    routes = dict(T.DECODE_ROUTES)
    peak = torch.cuda.max_memory_allocated()
    want_launches = {"paged_attention": 0, "flash_attention": CUT_LAYERS,
                     "batched_lora": 0}
    if launches != want_launches or routes["int8"] != CUT_LAYERS * INT8_GEN \
            or sum(routes.values()) != CUT_LAYERS * INT8_GEN:
        raise RuntimeError(f"model_api_int8: launches {launches}, routes "
                           f"{routes}; want {want_launches}")
    if not torch.isfinite(got).all():
        raise RuntimeError("model_api_int8: logits not finite")
    _, want, _, _ = api_run(model, params, tokens, lens, INT8_S + INT8_GEN,
                            INT8_GEN, "ref", forced=got_tok)
    vs_ref = hold_logits(got, want, "model_api_int8")
    row = {"phase": "model_api_int8", "model": cfg.name,
           "layers": cfg.num_layers,
           "cut": f"depth {get_config(INT8_MODEL).num_layers} -> "
           f"{CUT_LAYERS} layers", "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "kv_cache_dtype": cfg.kv_cache_dtype,
           "qkv_bias": cfg.qkv_bias, "batch": INT8_B, "S": INT8_S,
           "decode_steps": INT8_GEN, "launches": launches, "routes": routes,
           "prefill_s": prefill_s,
           "prefill_tok_per_s": INT8_B * INT8_S / prefill_s,
           "decode_tok_per_s": INT8_B * INT8_GEN / sum(step_s),
           "decode_step_wall_p50_s": float(np.percentile(step_s, 50)),
           "max_memory_allocated_bytes": peak,
           "resident_bytes_at_start": resident,
           "vs_ref": vs_ref,
           "card": smi}
    emit(row)
    return launches, row, cfg, params


def stitch_mse(w, h_a, h_b, pos_value):
    return float(torch.mean(torch.square(
        apply_stitch(w, h_a, pos_value).float() - h_b.float())))


def cross_size_phase(cfg_a, params_a, smi):
    """qwen1.5-32b (A, d 5120) against qwen2-72b (B, d 8192, 64/8 heads),
    full widths, the same 152,064 vocab, depth cut to 2 each, 4 x 128
    tokens: ``cross_size_equivalence`` at half depth; a stitch trained over
    points (1, 1) then (2, 2) at 120 steps a point, whose loss at the
    deepest point must be under half its untrained start's and whose
    stitched head similarity must beat the untrained one's; then
    ``add_stitch`` + ``apply_block``.  Every layer's attention is a flash
    launch."""
    resident = settle()
    cfg_b = cut_config(CROSS_B_MODEL)
    torch.cuda.reset_peak_memory_stats()
    params_b = init_params(cfg_b, 1)
    ma, mb = build_model(cfg_a), build_model(cfg_b)
    tokens = torch.from_numpy(np.random.RandomState(13).randint(
        0, cfg_a.vocab_size, size=(CROSS_B, CROSS_S)).astype(np.int32)).to(
            DEVICE)
    w0 = L.dense_init(torch.Generator(DEVICE).manual_seed(14),
                      (cfg_a.d_model + 1, cfg_b.d_model))
    # warm-up: casts and kernels of both models
    cross_size_equivalence(ma, params_a, cfg_a, mb, params_b, cfg_b, tokens)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eq = cross_size_equivalence(ma, params_a, cfg_a, mb, params_b, cfg_b,
                                tokens, frac=0.5)
    torch.cuda.synchronize()
    eq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w, losses = train_stitching_block(params_a, cfg_a, params_b, cfg_b,
                                      list(CROSS_POINTS), tokens, w_init=w0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    deep = CROSS_POINTS[-1]
    sim = stitched_head_similarity(params_a, cfg_a, params_b, cfg_b, w, deep,
                                   tokens)
    sim0 = stitched_head_similarity(params_a, cfg_a, params_b, cfg_b, w0,
                                    deep, tokens)
    launches = read_launches()
    with torch.no_grad():
        h_a = _hidden_at_layer(params_a, cfg_a, tokens, deep[0])
        h_b = _hidden_at_layer(params_b, cfg_b, tokens, deep[1])
    mse, mse0 = (stitch_mse(x, h_a, h_b, float(sum(deep))) for x in (w, w0))
    zoo = BlockZoo()
    blk = make_stitch_block(w, cfg_a.name, cfg_b.name, cfg_a.d_model,
                            cfg_b.d_model, float(sum(deep)))
    zoo.add_stitch(blk)
    with torch.no_grad():
        out = apply_block(zoo.blocks[zoo.stitches[(cfg_a.d_model,
                                                   cfg_b.d_model)]], h_a)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    # flash launches: half depth of each model (1 + 1), the training's
    # hidden states per point (1 + 1, then 2 + 2), and each similarity's
    # A prefix, B's tail after the stitch and B's own pass (2 + 0 + 2)
    want_flash = 2 + sum(a + b for a, b in CROSS_POINTS) + 2 * (
        deep[0] + (cfg_b.num_layers - deep[1]) + cfg_b.num_layers)
    want_launches = {"paged_attention": 0, "flash_attention": want_flash,
                     "batched_lora": 0}
    if launches != want_launches:
        raise RuntimeError(f"cross_size: launches {launches}, want "
                           f"{want_launches}")
    if not (0.0 <= eq <= 1.0) or not mse < 0.5 * mse0 or not sim > sim0 \
            or out.shape != (CROSS_B, CROSS_S, cfg_b.d_model) \
            or not torch.isfinite(out.float()).all():
        raise RuntimeError(f"cross_size: equivalence {eq}, stitch loss "
                           f"{mse} against untrained {mse0}, similarity "
                           f"{sim} against untrained {sim0}, stitch output "
                           f"{tuple(out.shape)}")
    n_params = {c.name: sum(t.numel() for t in tree_leaves(p))
                for c, p in ((cfg_a, params_a), (cfg_b, params_b))}
    row = {"phase": "cross_size", "a": cfg_a.name, "b": cfg_b.name,
           "cut": f"depth {get_config(INT8_MODEL).num_layers} -> "
           f"{CUT_LAYERS} (A), {get_config(CROSS_B_MODEL).num_layers} -> "
           f"{CUT_LAYERS} (B) layers",
           "d_model": [cfg_a.d_model, cfg_b.d_model],
           "heads_b": [cfg_b.num_heads, cfg_b.num_kv_heads,
                       cfg_b.resolved_head_dim], "d_ff_b": cfg_b.d_ff,
           "params": n_params, "tokens": [CROSS_B, CROSS_S],
           "cross_size_equivalence": eq, "equivalence_s": eq_s,
           "stitch_points": [list(p) for p in CROSS_POINTS],
           "steps_per_point": 120, "losses": losses, "train_s": train_s,
           "deepest_loss": mse, "untrained_loss": mse0,
           "stitched_head_similarity": sim, "untrained_similarity": sim0,
           "stitch_block": blk.id, "launches": launches,
           "max_memory_allocated_bytes": peak,
           "resident_bytes_at_start": resident, "card": smi}
    emit(row)
    return launches, row


# ---------------------------------------------------------------------------
# phase 9: the MoE family and the encoder-decoder on the Model API
# ---------------------------------------------------------------------------

# moe_dbrx / moe_mixtral: published widths, depth cut to 2 layers (the
# weights in fp32 and their bf16 casts: ~45 and ~32 GB); B = 4 prompts
# padded to S, a cache of S + 32, 32 greedy decode steps
MOE_B, MOE_GEN = 4, 32
MOE_RUNS = {  # model: (padded S, prompt lengths drawn from, numpy seed)
    "dbrx-132b": (256, (64, 256), 15),
    "mixtral-8x22b": (512, (128, 512), 16),
}
# moe_mixtral's window run: prompts of 8,192 and 6,000 tokens padded to
# 8,192 (two windows of 4,096), a cache of 8,224 (a ring of the window's
# 4,096 slots), 32 greedy steps, every one past the window
WIN_S, WIN_LENS, WIN_MAX, WIN_GEN, WIN_SEED = 8192, (8192, 6000), 8224, 32, 23
# a router-logit gap (the k-th against the (k+1)-th expert's logit) under
# which two bf16 runs of the same tokens may take different experts: a few
# bf16 ulps of logits of size 1-3.  The rows (a step's logits of one
# sequence) whose own token routed under it are counted; the rows whose own
# token took other experts in some layer differ by a whole expert, not by
# rounding, and are not held
ROUTE_EPS = 0.05
# at most this share of a comparison's rows may go unheld (the CPU test's
# cap on its rows at an unclear gap)
MAX_UNHELD_SHARE = 0.25
MOE_PROFILE_STEPS = 2
# encdec: seamless-m4t-medium whole (12 + 12 layers), frames 0.1 N(0, 1)
# of (4, 256, 1024), target prompts of 16-64 tokens padded to 64, a cache
# of 96, 32 greedy steps; src_len below S_src for two rows
ENC_B, ENC_SRC, ENC_S, ENC_MAX, ENC_GEN = 4, 256, 64, 96, 32
ENC_PROMPTS, ENC_SRC_LEN, ENC_SEED = (16, 64), (256, 256, 200, 137), 17
ENCDEC_MODEL = "seamless-m4t-medium"


def logged_run(*args, **kw):
    """``api_run`` with ``moe.margin_log`` on: returns (its logits, its
    decode step walls, the routing of every MoE layer call in call
    order)."""
    M.margin_log = []
    try:
        _, logits, _, step_s = api_run(*args, **kw)
        return logits, step_s, M.margin_log
    finally:
        M.margin_log = None


def routing_rows(got_log, want_log, lens, n_layers: int):
    """Which logits rows two runs of the same tokens hold to rounding: per
    call group (the prefill, then each decode step), the rows whose own
    token (the last prompt token, then the step's) took the same experts in
    both runs in every layer.  Two sound runs take other experts only where
    the router logits nearly tie, so this raises where a token first took
    other experts (it had routed the same in every earlier layer of the
    call) at a gap of ``ROUTE_EPS`` or more in ``want``; once a token has
    flipped it differs by a whole expert, and its later layers may flip at
    any gap.  Returns (keep (calls, B) bool, a report: the routing flips
    over all tokens and layers, the largest gap of a first flip and of any
    flip, the smallest gap, the rows whose own token flipped, and the rows
    whose own token routed at a gap under ``ROUTE_EPS`` in ``want``)."""
    B = lens.shape[0]
    rows = torch.arange(B, device=lens.device)
    last = lens.long() - 1
    flips, tokens, flip_gap, first_gap = 0, 0, 0.0, 0.0
    min_gap = float("inf")
    own_flip, own_low = [], []
    for i in range(0, len(want_log), n_layers):
        flipped = torch.zeros(B, dtype=torch.bool, device=lens.device)
        low = torch.zeros_like(flipped)
        before = None  # the call's tokens that flipped in an earlier layer
        for a, b in zip(got_log[i:i + n_layers], want_log[i:i + n_layers]):
            diff = (a["experts"] != b["experts"]).any(-1)  # (B, S)
            gap = b["margin"]
            tokens += gap.numel()
            flips += int(diff.sum())
            first = diff if before is None else diff & ~before
            if diff.any():
                flip_gap = max(flip_gap, float(gap[diff].max()))
            if first.any():
                first_gap = max(first_gap, float(gap[first].max()))
            before = diff if before is None else before | diff
            min_gap = min(min_gap, float(gap.min()))
            own = (lambda t: t[rows, last]) if i == 0 else (lambda t: t[:, 0])
            flipped |= own(diff)
            low |= own(gap < ROUTE_EPS)
        own_flip.append(flipped)
        own_low.append(low)
    if first_gap >= ROUTE_EPS:
        raise RuntimeError(f"a token took other experts at a router gap of "
                           f"{first_gap} (two sound runs differ only under "
                           f"{ROUTE_EPS})")
    keep = ~torch.stack(own_flip)
    return keep, {"route_eps": ROUTE_EPS, "token_layers": tokens,
                  "routing_flips": flips,
                  "largest_gap_first_flip": first_gap,
                  "largest_gap_flipped": flip_gap, "smallest_gap": min_gap,
                  "rows_own_token_flipped": int((~keep).sum()),
                  "rows_own_gap_under_eps": int(torch.stack(own_low).sum()),
                  "rows": keep.numel()}


def hold_routed(got, want, got_log, want_log, lens, n_layers, what):
    """``hold_logits`` on the rows ``routing_rows`` keeps, failing where
    more than ``MAX_UNHELD_SHARE`` of the rows go unheld or no token is
    compared at a clear margin."""
    keep, routing = routing_rows(got_log, want_log, lens, n_layers)
    unheld = routing["rows_own_token_flipped"]
    if unheld > MAX_UNHELD_SHARE * keep.numel():
        raise RuntimeError(f"{what}: {unheld} of {keep.numel()} rows' own "
                           "tokens took other experts")
    held = hold_logits(got, want, what, keep)
    if not held["tokens_compared_at_clear_margin"]:
        raise RuntimeError(f"{what}: no token compared at a clear margin")
    return dict(held, routing=routing)


def decode_floor(params, cfg):
    """(bytes, ms): the weights one dense-scan decode step must read once
    -- every layer's weights (bf16; the norms and the router fp32) and the
    bf16 lm_head -- over the HBM bandwidth (the KV cache, the embedding
    rows and the activations are under 0.1% of it here)."""
    nbytes = sum(t.numel() * (4 if k in M.FP32_PARAMS else 2)
                 for k, t in params["layers"].items())
    nbytes += params["lm_head"].numel() * 2
    return nbytes, nbytes / HBM_BW * 1e3


def profile_decode(model, params, tokens, lens, max_len, nxt, frames=None,
                   src_len=None):
    """``MOE_PROFILE_STEPS`` steady decode steps under ``torch.profiler``
    (``frames`` and ``src_len`` as in ``api_run``): (device ms a step,
    launches a step, paged ms a step)."""
    batch = {"tokens": tokens, "prompt_lens": lens}
    if frames is not None:
        batch["frames"] = frames
    extra = {} if src_len is None else {"src_len": src_len}
    _, cache, _ = model.prefill(params, batch, max_len=max_len)

    def steps():
        return [model.decode_step(params, cache, {
            "tokens": nxt[:, None].to(torch.int32), "kv_len": lens + j,
            **extra})[0] for j in range(MOE_PROFILE_STEPS)]

    by_kernel, n = profiled(steps)
    del cache
    return (sum(us for us, _, _ in by_kernel) / 1e3 / n,
            sum(c for _, c, _ in by_kernel) / n,
            sum(us for us, _, k in by_kernel if "paged_attention" in k)
            / 1e3 / n)


def check_api_launches(what, launches, routes, want_launches, want_routes):
    """Launches equal to the wanted counts and the route counters equal to
    theirs (every other route 0)."""
    got = {k: v for k, v in routes.items() if v}
    if launches != want_launches or got != want_routes:
        raise RuntimeError(f"{what}: launches {launches}, routes {got}; "
                           f"want {want_launches}, {want_routes}")


def moe_window_run(name, cfg, model, params):
    """A prompt past the sliding window: ``WIN_LENS`` prompts padded to
    ``WIN_S`` into a ring of the window's slots, ``WIN_GEN`` greedy steps
    on the dense expert scan; flash with the window once a layer in
    prefill, the ring's insert and the attend-only paged launch once a
    layer a step, launches equal to the route counters; then held
    teacher-forced against the ``ref`` route as the phase's first run is
    (``hold_routed``).  Returns (launches, row)."""
    torch.cuda.reset_peak_memory_stats()
    tokens, lens = api_prompts(cfg, None, WIN_S, WIN_LENS, WIN_SEED)
    api_run(model, params, tokens, lens, WIN_MAX, 1, "auto")  # warm-up
    reset_launches()
    reset_routes()
    got_tok, got, prefill_s, step_s = api_run(model, params, tokens, lens,
                                              WIN_MAX, WIN_GEN, "auto")
    launches = read_launches()
    routes = all_routes()
    L_, W = cfg.num_layers, min(WIN_MAX, cfg.sliding_window)
    check_api_launches(f"{name} window", launches, routes, {
        "paged_attention": L_ * WIN_GEN, "flash_attention": L_,
        "batched_lora": 0}, {"prefill_flash": L_, "paged": L_ * WIN_GEN})
    if min(WIN_LENS) <= W or not torch.isfinite(got).all() or got.shape != (
            WIN_GEN + 1, len(WIN_LENS), cfg.vocab_size):
        raise RuntimeError(f"{name} window: prompts {WIN_LENS} in a window "
                           f"of {W}; logits {tuple(got.shape)} finite "
                           f"{bool(torch.isfinite(got).all())}")
    _, _, scan_log = logged_run(model, params, tokens, lens, WIN_MAX,
                                WIN_GEN, "auto", forced=got_tok)
    want, _, want_log = logged_run(model, params, tokens, lens, WIN_MAX,
                                   WIN_GEN, "ref", forced=got_tok)
    vs_ref = hold_routed(got, want, scan_log, want_log, lens, L_,
                         f"{name} window vs ref")
    return launches, ring_row(lens, WIN_MAX, W, launches, routes, prefill_s,
                              step_s, torch.cuda.max_memory_allocated(),
                              padded_S=WIN_S, vs_ref=vs_ref)


def moe_phase(name, smi):
    """``build_model(name)`` at its published widths, depth cut to 2, random
    weights from seed 0 on the card: prefill 4 padded prompts, then 32
    greedy decode steps on the dense expert scan; flash once per layer in
    prefill; decode through the fused paged step (mixtral's sliding window
    too: its ring buffer holds the whole cache here).  Then, on the same
    weights and teacher-forced on the same tokens: the ``ref`` route (held
    to the chain bound), the top-k decode gather and lossless capacity
    dispatch against the scan (``hold_routed``: rows whose own token took
    other experts counted, not held, failing past a quarter of the rows or
    at a first flip at a clear gap; rows at a gap under ``ROUTE_EPS``
    counted).  A config with a sliding window then runs ``moe_window_run``
    (its row under ``window``).  Returns ({path: launches}, row)."""
    resident = settle()
    cfg = cut_config(name)
    S, prompt_range, seed = MOE_RUNS[name]
    max_len = S + MOE_GEN
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = init_params(cfg, 0)
    tokens, lens = api_prompts(cfg, MOE_B, S, prompt_range, seed)
    api_run(model, params, tokens, lens, max_len, 1, "auto")  # casts, warm-up
    reset_launches()
    reset_routes()
    got_tok, got, prefill_s, step_s = api_run(model, params, tokens, lens,
                                              max_len, MOE_GEN, "auto")
    launches = read_launches()
    routes = all_routes()
    L_ = cfg.num_layers
    check_api_launches(name, launches, routes, {
        "paged_attention": L_ * MOE_GEN, "flash_attention": L_,
        "batched_lora": 0}, {"prefill_flash": L_, "paged": L_ * MOE_GEN})
    if not torch.isfinite(got).all() or got.shape != (
            MOE_GEN + 1, MOE_B, cfg.vocab_size):
        raise RuntimeError(f"{name}: logits {tuple(got.shape)} not finite")
    # the routing of the kernel run, and the ref route's, teacher-forced
    scan, _, scan_log = logged_run(model, params, tokens, lens, max_len,
                                   MOE_GEN, "auto", forced=got_tok)
    want, _, want_log = logged_run(model, params, tokens, lens, max_len,
                                   MOE_GEN, "ref", forced=got_tok)
    vs_ref = hold_routed(got, want, scan_log, want_log, lens, L_,
                         f"{name} vs ref")
    # the top-k decode gather against the dense scan
    gmodel = build_model(cfg.replace(moe_decode_gather=True))
    gathered, gather_step_s, gather_log = logged_run(
        gmodel, params, tokens, lens, max_len, MOE_GEN, "auto",
        forced=got_tok)
    vs_gather = dict(hold_routed(gathered, scan, gather_log, scan_log,
                                 lens, L_, f"{name} gather"),
                     decode_step_wall_p50_s=float(np.percentile(
                         gather_step_s, 50)))
    # lossless capacity dispatch (E / k) against the scan
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    dmodel = build_model(cfg.replace(moe_impl="dispatch",
                                     capacity_factor=E / k))
    dispatched, _, d_log = logged_run(dmodel, params, tokens, lens, max_len,
                                      MOE_GEN, "auto", forced=got_tok)
    vs_dispatch = hold_routed(dispatched, scan, d_log, scan_log, lens, L_,
                              f"{name} dispatch")
    # the fraction capacity 1.25 would drop, per layer, of the scan's prefill
    lossy = cfg.replace(capacity_factor=1.25)
    dropped = []
    for entry in scan_log[:L_]:
        gates = torch.zeros(entry["experts"].shape[:-1] + (E,),
                            device=DEVICE).scatter_(-1, entry["experts"], 1.0)
        dropped.append(float(dropped_fraction(gates, lossy)))
        if float(dropped_fraction(gates, cfg.replace(
                capacity_factor=E / k))) != 0.0:
            raise RuntimeError(f"{name}: capacity E/k dropped tokens")
    device_ms, per_step, paged_ms = profile_decode(
        model, params, tokens, lens, max_len, got_tok[:, 0])
    floor_bytes, floor_ms = decode_floor(params, cfg)
    peak = torch.cuda.max_memory_allocated()
    full = get_config(name)
    prompt_tokens = int(lens.sum())
    row = {"phase": f"moe_{name.split('-')[0]}", "model": cfg.name,
           "layers": L_, "cut": f"depth {full.num_layers} -> {L_} layers",
           "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim], "d_ff": cfg.d_ff,
           "experts": [E, k], "vocab": cfg.vocab_size,
           "sliding_window": cfg.sliding_window,
           "params": sum(t.numel() for t in tree_leaves(params)),
           "batch": MOE_B, "padded_S": S, "max_len": max_len,
           "prompt_lens": lens.cpu().tolist(), "decode_steps": MOE_GEN,
           "launches": launches, "routes": {k_: v for k_, v in routes.items()
                                            if v},
           "prefill_ms": prefill_s * 1e3,
           "prefill_tok_per_s": prompt_tokens / prefill_s,
           "decode_tok_per_s": MOE_B * MOE_GEN / sum(step_s),
           "decode_step_wall_p50_s": float(np.percentile(step_s, 50)),
           "decode_step_wall_p95_s": float(np.percentile(step_s, 95)),
           "decode_profile": {
               "steps": MOE_PROFILE_STEPS, "device_ms_per_step": device_ms,
               "kernel_launches_per_step": per_step,
               "paged_ms_per_step": paged_ms,
               "weight_bytes_per_step": floor_bytes,
               "floor_ms_per_step": floor_ms},
           "vs_ref": vs_ref, "gather_vs_scan": vs_gather,
           "dispatch_lossless_vs_scan": vs_dispatch,
           "dropped_fraction_cf_1.25_per_layer": dropped,
           "max_memory_allocated_bytes": peak,
           "resident_bytes_at_start": resident, "card": smi}
    paths = {row["phase"]: launches}
    if cfg.sliding_window:
        paths[f"{row['phase']}_window"], row["window"] = moe_window_run(
            name, cfg, model, params)
    emit(row)
    return paths, row


def encdec_phase(smi):
    """``build_model("seamless-m4t-medium")`` whole, random weights from seed
    0 on the card: encode 4 x 256 frames (flash, non-causal, once per
    encoder layer), prefill the decoder on 4 padded prompts (flash, causal,
    once per layer; cross-attention on its plain route), then 32 greedy
    decode steps (a fused paged step and an attend-only paged launch over
    the cross cache per layer, ``src_len`` below 256 for two rows).  Held
    against the ``ref`` route; the cross cache bitwise unchanged by decode.
    Returns (launches, row)."""
    resident = settle()
    cfg = get_config(ENCDEC_MODEL)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = init_params(cfg, 0)
    tokens, lens = api_prompts(cfg, ENC_B, ENC_S, ENC_PROMPTS, ENC_SEED)
    frames = torch.from_numpy((0.1 * np.random.RandomState(ENC_SEED + 1)
                               .standard_normal((ENC_B, ENC_SRC, cfg.d_model)))
                              .astype(np.float32)).to(DEVICE)
    src_len = torch.tensor(ENC_SRC_LEN, dtype=torch.int32, device=DEVICE)
    io = dict(frames=frames, src_len=src_len)
    api_run(model, params, tokens, lens, ENC_MAX, 1, "auto", **io)
    reset_launches()
    reset_routes()
    got_tok, got, prefill_s, step_s = api_run(model, params, tokens, lens,
                                              ENC_MAX, ENC_GEN, "auto", **io)
    launches = read_launches()
    routes = all_routes()
    Le, Ld = cfg.encoder_layers, cfg.decoder_layers
    check_api_launches("encdec", launches, routes, {
        "paged_attention": 2 * Ld * ENC_GEN, "flash_attention": Le + Ld,
        "batched_lora": 0},
        {"prefill_flash": Le + Ld, "prefill_cross_plain": Ld,
         "paged": Ld * ENC_GEN, "cross_paged": Ld * ENC_GEN})
    if not torch.isfinite(got).all() or got.shape != (
            ENC_GEN + 1, ENC_B, cfg.vocab_size):
        raise RuntimeError(f"encdec: logits {tuple(got.shape)} not finite")
    _, want, _, _ = api_run(model, params, tokens, lens, ENC_MAX, ENC_GEN,
                            "ref", forced=got_tok, **io)
    vs_ref = hold_logits(got, want, "encdec")
    # decode only reads the cross cache
    _, cache, _ = model.prefill(params, {"tokens": tokens,
                                         "prompt_lens": lens,
                                         "frames": frames}, max_len=ENC_MAX)
    xk, xv = cache["xk"].clone(), cache["xv"].clone()
    for j in range(ENC_GEN):
        model.decode_step(params, cache, {
            "tokens": got_tok[:, j, None].to(torch.int32),
            "kv_len": lens + j, "src_len": src_len})
    torch.cuda.synchronize()
    if not (torch.equal(cache["xk"], xk) and torch.equal(cache["xv"], xv)):
        raise RuntimeError("encdec: decode wrote the cross cache")
    del cache, xk, xv
    device_ms, per_step, paged_ms = profile_decode(
        model, params, tokens, lens, ENC_MAX, got_tok[:, 0], frames=frames,
        src_len=src_len)
    peak = torch.cuda.max_memory_allocated()
    row = {"phase": "encdec", "model": cfg.name,
           "layers": [Le, Ld], "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size,
           "params": sum(t.numel() for t in tree_leaves(params)),
           "batch": ENC_B, "frames": [ENC_B, ENC_SRC, cfg.d_model],
           "src_len": list(ENC_SRC_LEN), "padded_S": ENC_S,
           "max_len": ENC_MAX, "prompt_lens": lens.cpu().tolist(),
           "decode_steps": ENC_GEN, "launches": launches,
           "routes": {k: v for k, v in routes.items() if v},
           "prefill_ms": prefill_s * 1e3,
           "prefill_tok_per_s": int(lens.sum()) / prefill_s,
           "prefill_frames_per_s": ENC_B * ENC_SRC / prefill_s,
           "decode_tok_per_s": ENC_B * ENC_GEN / sum(step_s),
           "decode_step_wall_p50_s": float(np.percentile(step_s, 50)),
           "decode_step_wall_p95_s": float(np.percentile(step_s, 95)),
           "decode_profile": {
               "steps": MOE_PROFILE_STEPS, "device_ms_per_step": device_ms,
               "kernel_launches_per_step": per_step,
               "paged_ms_per_step": paged_ms},
           "vs_ref": vs_ref, "cross_cache_bitwise_unchanged": True,
           "max_memory_allocated_bytes": peak,
           "resident_bytes_at_start": resident, "card": smi}
    emit(row)
    return launches, row


# ---------------------------------------------------------------------------
# phase 10: the hybrid and SSM families, stablelm's head dim
# ---------------------------------------------------------------------------

# hybrid: zamba2-2.7b whole (54 mamba layers, the shared block applied 9
# times, 2.44 B parameters); B = 4 prompts padded to 512, a cache of 576, 64
# greedy steps; then the ring run: one prompt of 4,080 tokens in a cache of
# the window (4,096 slots), 32 steps, the last 16 past the window
HYB_MODEL = "zamba2-2.7b"
HYB_B, HYB_S, HYB_MAX, HYB_GEN, HYB_SEED = 4, 512, 576, 64, 18
HYB_PROMPTS = (128, 512)
RING_S, RING_MAX, RING_GEN, RING_SEED = 4080, 4112, 32, 19
# then the window run: one prompt of 8,192 tokens (two windows) into the
# ring of 4,096 slots (a cache of 8,224), 32 steps, every one past it
HWIN_S, HWIN_MAX, HWIN_GEN, HWIN_SEED = 8192, 8224, 32, 24
# ssm: xlstm-125m whole (12 blocks); B = 4 prompts padded to 512, 64 steps
SSM_MODEL = "xlstm-125m"
SSM_B, SSM_S, SSM_GEN, SSM_SEED = 4, 512, 64, 20
SSM_PROMPTS = (128, 512)
# stablelm: stablelm-12b's published widths (head dim 160, G = 4), depth
# cut to 2 layers; B = 4 prompts padded to 256, a cache of 288, 32 steps
STABLE_MODEL = "stablelm-12b"
STABLE_B, STABLE_S, STABLE_GEN, STABLE_SEED = 4, 256, 32, 21
STABLE_PROMPTS = (64, 256)


def hybrid_floor(params, cfg, B, positions):
    """(bytes, ms): what one zamba2 decode step must move at least, over
    the HBM bandwidth: every mamba layer's weights once (``w_in``/``w_out``
    in bf16, the rest fp32), the shared block's bf16 weights once per
    application (118 M parameters: no L2 holds them between two), the bf16
    head, the SSM and conv states read and written, and ``positions`` K/V
    rows (summed over the rows) per application read."""
    from repro_torch.models.mamba2 import MAMBA_CAST, SHARED_FP32

    n_super = cfg.num_layers // cfg.shared_attn_every
    nbytes = sum(t.numel() * (2 if k in MAMBA_CAST else 4)
                 for k, t in params["mamba"].items())
    nbytes += n_super * sum(t.numel() * (4 if k in SHARED_FP32 else 2)
                            for k, t in params["shared_attn"].items())
    nbytes += params["lm_head"].numel() * 2
    d_inner, H, N, conv_ch, _ = mamba_dims(cfg)
    per_layer = B * (H * cfg.ssm_head_dim * N * 4
                     + (cfg.ssm_conv_width - 1) * conv_ch * 2)
    nbytes += 2 * cfg.num_layers * per_layer
    nbytes += n_super * positions * 2 * cfg.num_kv_heads \
        * cfg.resolved_head_dim * 2
    return nbytes, nbytes / HBM_BW * 1e3


def ring_row(lens, max_len, window, launches, routes, prefill_s, step_s,
             peak, **extra):
    """The JSON of a run that prefills or decodes past a sliding window:
    its lengths, how many steps attend past the window (some row's
    kv_len + 1 over it), launches and routes, prefill and decode speed,
    its own peak memory."""
    n = lens.cpu().tolist()
    past = sum(max(n) + j >= window for j in range(len(step_s)))
    row = {"prompt_lens": n, "max_len": max_len, "window": window,
           "decode_steps": len(step_s), "steps_past_window": past,
           "launches": launches,
           "routes": {k: v for k, v in routes.items() if v},
           "prefill_ms": prefill_s * 1e3,
           "prefill_tok_per_s": sum(n) / prefill_s,
           "decode_step_wall_p50_s": float(np.percentile(step_s, 50)),
           "decode_tok_per_s": len(n) * len(step_s) / sum(step_s),
           "max_memory_allocated_bytes": peak, **extra}
    return row


def api_row(cfg, tokens, lens, max_len, steps, launches, routes, prefill_s,
            step_s, profile, peak, resident, smi, **extra):
    """The JSON line of a Model API run: widths, lengths, launches and
    routes, prefill and decode speed, the profile, memory."""
    return {"model": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim], "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "batch": tokens.shape[0],
            "padded_S": tokens.shape[1], "max_len": max_len,
            "prompt_lens": lens.cpu().tolist(), "decode_steps": steps,
            "launches": launches,
            "routes": {k: v for k, v in routes.items() if v},
            "prefill_ms": prefill_s * 1e3,
            "prefill_tok_per_s": int(lens.sum()) / prefill_s,
            "decode_tok_per_s": tokens.shape[0] * steps / sum(step_s),
            "decode_step_wall_p50_s": float(np.percentile(step_s, 50)),
            "decode_step_wall_p95_s": float(np.percentile(step_s, 95)),
            "decode_profile": profile,
            "max_memory_allocated_bytes": peak,
            "resident_bytes_at_start": resident, **extra, "card": smi}


def decode_profile(model, params, tokens, lens, max_len, nxt, floor=None):
    """``profile_decode``'s numbers as a dict, with the weight-read floor
    (bytes, ms) where given."""
    device_ms, per_step, paged_ms = profile_decode(model, params, tokens,
                                                   lens, max_len, nxt)
    out = {"steps": MOE_PROFILE_STEPS, "device_ms_per_step": device_ms,
           "kernel_launches_per_step": per_step,
           "paged_ms_per_step": paged_ms}
    if floor is not None:
        out["floor_bytes_per_step"], out["floor_ms_per_step"] = floor
    return out


def hybrid_vs_ref(model, params, tokens, lens, max_len, forced, what):
    """The kernel route held against the ``ref`` route hop by hop on the
    main path: a run of the kernel route teacher-forced on ``forced`` in
    which every application of the shared block (the only hop whose routes
    differ) is also computed on the ref route from the same input (in
    decode, on a copy of its cache layer, taken before the kernel route
    writes it), each output within the per-hop bound (2e-2 + 2e-2 |x| +
    one bf16 ulp at the token's largest |x|).  A recurrent state
    integrates each step's rounding, so two whole runs drift apart with
    the steps: the whole ref run, teacher-forced too, is held by its
    tokens (no flip where its top-2 gap exceeds 0.1: a fault in a kernel
    or a cache write moves whole units) and its logits' drift reported."""
    from repro_torch.models import mamba2 as Z

    block = Z.shared_attn_block
    hops = []

    def twin(x, h0, p, cfg, positions, *, attn_impl="auto", cache=None,
             attn=None, layer_idx=None, compute_dtype=L.COMPUTE_DTYPE,
             shd=None):
        if cache is None:
            want, _ = block(x, h0, p, cfg, positions, attn_impl="ref",
                            shd=shd)
        else:
            one = {k: v[layer_idx:layer_idx + 1].clone()
                   for k, v in cache.items()}
            plan = T.DecodeAttention.plan(cfg, x, "ref", one, attn.kv_len)
            want, _ = block(x, h0, p, cfg, positions, cache=one, attn=plan,
                            layer_idx=0, compute_dtype=compute_dtype,
                            shd=shd)
        out = block(x, h0, p, cfg, positions, attn_impl=attn_impl,
                    cache=cache, attn=attn, layer_idx=layer_idx,
                    compute_dtype=compute_dtype, shd=shd)
        keep = torch.ones(want.shape[:-1], dtype=torch.bool,
                          device=want.device)
        err, ratio = hop_ratio(out[0].float(), want.float(), keep)
        hops.append((ratio, float(err.max())))
        return out

    Z.shared_attn_block = twin
    try:
        _, got, _, _ = api_run(model, params, tokens, lens, max_len,
                               forced.shape[1] - 1, "auto", forced=forced)
    finally:
        Z.shared_attn_block = block
    worst = max(r for r, _ in hops)
    if not worst <= 1.0:
        raise RuntimeError(f"{what}: a shared block on the kernel route at "
                           f"{worst} x the per-hop bound from ref")
    _, whole, _, _ = api_run(model, params, tokens, lens, max_len,
                             forced.shape[1] - 1, "ref", forced=forced)
    _, drift = hop_ratio(got, whole, torch.ones(got.shape[:-1],
                                                dtype=torch.bool,
                                                device=got.device))
    clear = top2_margin(whole) > API_MARGIN
    flips = int((got.argmax(-1) != whole.argmax(-1))[clear].sum())
    if flips or not clear.any():
        raise RuntimeError(f"{what}: the whole kernel run against the whole "
                           f"ref run: {flips} token flips at a clear margin "
                           f"of {int(clear.sum())}")
    return {"hops_held": len(hops), "hop_worst_err_over_bound": worst,
            "hop_max_abs_err": max(e for _, e in hops),
            "whole_run_worst_err_over_hop_bound": drift,
            "whole_run_tokens_compared_at_clear_margin": int(clear.sum()),
            "whole_run_token_flips_at_clear_margin": flips}


def hybrid_ring_run(model, params, cfg, S, max_len, steps, seed, what):
    """One prompt of S tokens into a cache of ``min(max_len, window)``
    slots, then ``steps`` greedy steps: flash once per shared-block
    application in prefill (with the window), the fused paged step or,
    once the row has reached the ring's end, its insert and the
    attend-only launch, once per application a step; held against the
    ``ref`` route (``hybrid_vs_ref``).  Returns (launches, ``ring_row``
    with the run's own peak memory)."""
    n_super = cfg.num_layers // cfg.shared_attn_every
    torch.cuda.reset_peak_memory_stats()
    tok, lens = api_prompts(cfg, 1, S, (S, S), seed)
    api_run(model, params, tok, lens, max_len, 1, "auto")  # warm-up
    reset_launches()
    reset_routes()
    got_tok, logits, prefill_s, step_s = api_run(model, params, tok, lens,
                                                 max_len, steps, "auto")
    launches = read_launches()
    routes = all_routes()
    check_api_launches(what, launches, routes, {
        "paged_attention": n_super * steps, "flash_attention": n_super,
        "batched_lora": 0}, {"prefill_flash": n_super,
                             "paged": n_super * steps})
    if not torch.isfinite(logits).all():
        raise RuntimeError(f"{what}: logits not finite")
    vs_ref = hybrid_vs_ref(model, params, tok, lens, max_len, got_tok, what)
    return launches, ring_row(lens, max_len,
                              min(max_len, cfg.sliding_window), launches,
                              routes, prefill_s, step_s,
                              torch.cuda.max_memory_allocated(),
                              vs_ref=vs_ref)


def hybrid_phase(smi):
    """``build_model("zamba2-2.7b")`` whole, random weights from seed 0 on
    the card: prefill 4 padded prompts (the shared block's attention on
    flash, 9 launches), 64 greedy decode steps (the fused paged step, 9 a
    step), held against the ``ref`` route hop by hop (``hybrid_vs_ref``);
    then the ring run (B = 1, 4,080 prompt tokens, a
    cache of the 4,096-slot window, 32 steps: the fused step until the row
    reaches the window, then the ring's insert and the attend-only launch
    at hd 80), held the same way; then the window run (B = 1, 8,192
    prompt tokens, two windows, into the ring: flash with the window 9
    times, then the ring's insert and the attend-only launch 9 a step, 32
    steps), held the same way.  Returns ({path: launches}, row)."""
    resident = settle()
    cfg = get_config(HYB_MODEL)
    n_super = cfg.num_layers // cfg.shared_attn_every
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = init_params(cfg, 0)
    tokens, lens = api_prompts(cfg, HYB_B, HYB_S, HYB_PROMPTS, HYB_SEED)
    api_run(model, params, tokens, lens, HYB_MAX, 1, "auto")  # casts, warm-up
    reset_launches()
    reset_routes()
    got_tok, got, prefill_s, step_s = api_run(model, params, tokens, lens,
                                              HYB_MAX, HYB_GEN, "auto")
    launches = read_launches()
    routes = all_routes()
    check_api_launches("hybrid", launches, routes, {
        "paged_attention": n_super * HYB_GEN, "flash_attention": n_super,
        "batched_lora": 0}, {"prefill_flash": n_super,
                             "paged": n_super * HYB_GEN})
    if not torch.isfinite(got).all() or got.shape != (
            HYB_GEN + 1, HYB_B, cfg.vocab_size):
        raise RuntimeError(f"hybrid: logits {tuple(got.shape)} not finite")
    vs_ref = hybrid_vs_ref(model, params, tokens, lens, HYB_MAX, got_tok,
                           "hybrid")
    positions = int(lens.sum()) + HYB_B * HYB_GEN // 2
    profile = decode_profile(model, params, tokens, lens, HYB_MAX,
                             got_tok[:, 0],
                             hybrid_floor(params, cfg, HYB_B, positions))
    peak = torch.cuda.max_memory_allocated()
    # the ring run: decode crosses the window; the window run: a prompt of
    # two windows, every step past it
    ring_launches, ring = hybrid_ring_run(model, params, cfg, RING_S,
                                          RING_MAX, RING_GEN, RING_SEED,
                                          "hybrid_ring")
    win_launches, window = hybrid_ring_run(model, params, cfg, HWIN_S,
                                           HWIN_MAX, HWIN_GEN, HWIN_SEED,
                                           "hybrid_window")
    if not 0 < ring["steps_past_window"] < RING_GEN \
            or window["steps_past_window"] != HWIN_GEN:
        raise RuntimeError(f"hybrid: {ring['steps_past_window']} of "
                           f"{RING_GEN} ring steps and "
                           f"{window['steps_past_window']} of {HWIN_GEN} "
                           "window steps past the window")
    row = {"phase": "hybrid", **api_row(
        cfg, tokens, lens, HYB_MAX, HYB_GEN, launches, routes, prefill_s,
        step_s, profile, peak, resident, smi,
        shared_attn_applications=n_super,
        params=sum(t.numel() for t in tree_leaves(params)),
        vs_ref=vs_ref, ring=ring, window=window)}
    emit(row)
    del params
    return {"hybrid": launches, "hybrid_ring": ring_launches,
            "hybrid_window": win_launches}, row


def ssm_block_errors(params, cfg, tokens, forced):
    """Each xlstm block in bf16 against the same block in fp32 (its fp32
    weights) on the same input, along the bf16 run (the prefill of
    ``tokens``, then each decode step teacher-forced on ``forced``, from
    the bf16 run's own states): per block index, the largest relative
    error in norm, ||bf16 - fp32|| / ||fp32||, and the largest output."""
    bf16, f32 = torch.bfloat16, torch.float32
    rel = [0.0] * cfg.num_layers
    top = [0.0] * cfg.num_layers
    states = []

    def run(h, i, raw, state=None, collect=False):
        out, new = X._block(h, raw, cfg, i, state=state, collect=collect,
                            compute_dtype=bf16)
        want, _ = X._block(h.float(), raw, cfg, i, state=state,
                           compute_dtype=f32)
        rel[i] = max(rel[i], float((out.float() - want).norm()
                                   / want.norm()))
        top[i] = max(top[i], float(want.abs().max()))
        return out, new

    h = params["embed"][tokens.long()].to(bf16)
    for i, raw in enumerate(params["blocks"]):
        h, st = run(h, i, raw, collect=True)
        states.append(st)
    for j in range(forced.shape[1] - 1):
        h = params["embed"][forced[:, j, None].long()].to(bf16)
        for i, raw in enumerate(params["blocks"]):
            h, states[i] = run(h, i, raw, state=states[i])
    return rel, top


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)


def ssm_phase(smi):
    """``build_model("xlstm-125m")`` whole, random weights from seed 0 on
    the card: prefill 4 padded prompts (the mLSTM's parallel form and its
    final-state recurrence, the sLSTM's scan: Python loops over the 512
    positions), 64 greedy decode steps; no kernel launches, no attention
    route.  An fp32 run of the same weights on the card, teacher-forced on
    the bf16 run's tokens, is held against the same fp32 run on the host's
    CPU (the port there is what the CPU tests hold against JAX): greedy
    tokens equal where the CPU run's top-2 gap exceeds 0.1, the logits'
    largest difference reported.  The bf16 run against the fp32 run is
    reported, not held: with these random weights the residual stream
    grows to ~10^3 by the last block (the sLSTM's FFN reads it
    unnormalized, as in the reference) and the mLSTM divides by
    max(|q . n|, exp(-m)), which cancels in some rows, so whole-run bf16
    logits differ from fp32 by up to a unit while each block's output is
    within bf16 rounding in norm (``ssm_block_errors``).  The prefill
    profiled (its launches, the two loops' included).  Returns (launches,
    row)."""
    resident = settle()
    cfg = get_config(SSM_MODEL)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = init_params(cfg, 0)
    tokens, lens = api_prompts(cfg, SSM_B, SSM_S, SSM_PROMPTS, SSM_SEED)
    api_run(model, params, tokens, lens, SSM_S, 1, "auto")  # warm-up
    reset_launches()
    reset_routes()
    for k in X.LOOP_STEPS:
        X.LOOP_STEPS[k] = 0
    got_tok, got, prefill_s, step_s = api_run(model, params, tokens, lens,
                                              SSM_S, SSM_GEN, "auto")
    launches = read_launches()
    routes = all_routes()
    loops = dict(X.LOOP_STEPS)
    check_api_launches("ssm", launches, routes, {
        "paged_attention": 0, "flash_attention": 0, "batched_lora": 0}, {})
    n_m = (cfg.num_layers + 1) // 2
    n_s = cfg.num_layers - n_m
    if loops != {"mlstm_final_state": n_m * SSM_S,
                 "slstm_scan": n_s * (SSM_S + SSM_GEN)}:
        raise RuntimeError(f"ssm: time-loop steps {loops}")
    if not torch.isfinite(got).all() or got.shape != (
            SSM_GEN + 1, SSM_B, cfg.vocab_size):
        raise RuntimeError(f"ssm: logits {tuple(got.shape)} not finite")
    # fp32 on the same weights, teacher-forced on the bf16 run's tokens, on
    # the card and on the host's CPU
    m32 = build_model(cfg, compute_dtype=torch.float32)
    _, want, _, _ = api_run(m32, params, tokens, lens, SSM_S, SSM_GEN,
                            "auto", forced=got_tok)
    t0 = time.perf_counter()
    _, host, _, _ = api_run(m32, to_device(params, "cpu"), tokens.cpu(),
                            lens.cpu(), SSM_S, SSM_GEN, "auto",
                            forced=got_tok.cpu())
    host_s = time.perf_counter() - t0
    host = host.to(want.device)
    clear = top2_margin(host) > API_MARGIN
    flips = int((want.argmax(-1) != host.argmax(-1))[clear].sum())
    if flips or not clear.any() or not torch.isfinite(want).all():
        raise RuntimeError(f"ssm: fp32 on the card against fp32 on the host: "
                           f"{flips} token flips at a clear margin of "
                           f"{int(clear.sum())}")
    margin = top2_margin(want)
    flipped = got.argmax(-1) != want.argmax(-1)
    rel, top = ssm_block_errors(params, cfg, tokens, got_tok)
    vs_fp32 = {"card_vs_host_fp32_tokens_at_clear_margin": int(clear.sum()),
               "card_vs_host_fp32_token_flips_at_clear_margin": flips,
               "card_vs_host_fp32_logits_max_abs_err": float(
                   (want - host).abs().max()),
               "host_fp32_run_s": host_s,
               "bf16_vs_fp32_logits_max_abs_err": float((got - want).abs()
                                                        .max()),
               "bf16_vs_fp32_token_flips": int(flipped.sum()),
               "bf16_vs_fp32_largest_margin_flipped": float(
                   margin[flipped].max()) if flipped.any() else 0.0,
               "bf16_vs_fp32_tokens": flipped.numel(),
               "bf16_vs_fp32_block_rel_err": rel,
               "fp32_block_largest_output": top}
    batch = {"tokens": tokens, "prompt_lens": lens}
    by_kernel, _ = profiled(lambda: [model.prefill(params, batch)])
    prefill_profile = {"device_ms": sum(us for us, _, _ in by_kernel) / 1e3,
                       "kernel_launches": sum(c for _, c, _ in by_kernel)}
    profile = decode_profile(model, params, tokens, lens, SSM_S,
                             got_tok[:, 0])
    peak = torch.cuda.max_memory_allocated()
    row = {"phase": "ssm", **api_row(
        cfg, tokens, lens, SSM_S, SSM_GEN, launches, routes, prefill_s,
        step_s, profile, peak, resident, smi,
        params=sum(t.numel() for t in tree_leaves(params)),
        time_loop_steps=loops, prefill_profile=prefill_profile,
        vs_fp32=vs_fp32)}
    emit(row)
    return launches, row


def stablelm_phase(smi):
    """stablelm-12b's published widths (d 5120, 32/8 heads, head dim 160),
    depth cut to 2: prefill 4 padded prompts on flash at hd 160, then 32
    greedy decode steps on the fused paged step at hd 160 (G = 4), held
    against the ``ref`` route.  Returns (launches, row)."""
    resident = settle()
    cfg = cut_config(STABLE_MODEL)
    max_len = STABLE_S + STABLE_GEN
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = init_params(cfg, 0)
    tokens, lens = api_prompts(cfg, STABLE_B, STABLE_S, STABLE_PROMPTS,
                               STABLE_SEED)
    api_run(model, params, tokens, lens, max_len, 1, "auto")  # warm-up
    reset_launches()
    reset_routes()
    got_tok, got, prefill_s, step_s = api_run(model, params, tokens, lens,
                                              max_len, STABLE_GEN, "auto")
    launches = read_launches()
    routes = all_routes()
    L_ = cfg.num_layers
    check_api_launches("stablelm", launches, routes, {
        "paged_attention": L_ * STABLE_GEN, "flash_attention": L_,
        "batched_lora": 0}, {"prefill_flash": L_, "paged": L_ * STABLE_GEN})
    if not torch.isfinite(got).all():
        raise RuntimeError("stablelm: logits not finite")
    _, want, _, _ = api_run(model, params, tokens, lens, max_len, STABLE_GEN,
                            "ref", forced=got_tok)
    vs_ref = hold_logits(got, want, "stablelm")
    profile = decode_profile(model, params, tokens, lens, max_len,
                             got_tok[:, 0])
    peak = torch.cuda.max_memory_allocated()
    row = {"phase": "stablelm", **api_row(
        cfg, tokens, lens, max_len, STABLE_GEN, launches, routes, prefill_s,
        step_s, profile, peak, resident, smi,
        cut=f"depth {get_config(STABLE_MODEL).num_layers} -> {L_} layers",
        vs_ref=vs_ref)}
    emit(row)
    return launches, row


def one_page_case(name, B, Hq, KVH, hd, S, lens, flush):
    """Paged attention as the Model API's decode launches it: a stacked
    cache's layer slice (B, S, KVH, hd) as B pages of S tokens, table
    arange(B).  The fused step against ``write_token_to_pages`` + the plain
    version (pages bitwise) and attend only against the plain version, bf16
    and fp32, timed beside SDPA on the same cache."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(DEVICE).manual_seed(len(rows) + 21)
        q, k_new, v_new = (torch.randn(*shp, generator=g, device=DEVICE)
                           .to(dtype) for shp in ((B, Hq, hd), (B, KVH, hd),
                                                  (B, KVH, hd)))
        k, v = (torch.randn(B, S, KVH, hd, generator=g, device=DEVICE)
                .to(dtype) for _ in range(2))
        tables = torch.arange(B, dtype=torch.int32, device=DEVICE)[:, None]
        seq = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        kv_len = seq - 1
        got = paged_attention(q, k, v, tables, seq, impl="cuda")
        kf, vf = k.clone(), v.clone()
        fused = paged_decode_step(q, k_new, v_new, kf, vf, tables, kv_len,
                                  impl="cuda")[0]
        torch.cuda.synchronize()
        want = paged_attention_ref(q, k, v, tables, seq)
        kr, vr = write_token_to_pages(k.clone(), v.clone(), tables, kv_len,
                                      k_new, v_new)
        want_f = paged_attention_ref(q, kr, vr, tables, seq)
        if not (torch.equal(kf, kr) and torch.equal(vf, vr)):
            raise RuntimeError(f"paged {name}: the fused step's pages differ "
                               "from write_token_to_pages'")
        tol = TOL[dtype]
        for a, b_ in ((got, want), (fused, want_f)):
            torch.testing.assert_close(a.float(), b_.float(), rtol=tol,
                                       atol=tol)
            check_bf16_ulp(a, b_, f"paged {name}")
        err = float((got.float() - want.float()).abs().max())
        f_err = float((fused.float() - want_f.float()).abs().max())
        k_ms = time_ms(lambda: paged_attention(q, k, v, tables, seq,
                                               impl="cuda"), 50, flush)
        f_ms = time_ms(lambda: paged_decode_step(
            q, k_new, v_new, kf, vf, tables, kv_len, impl="cuda"), 50, flush)
        r_ms = time_ms(lambda: paged_attention_ref(q, k, v, tables, seq), 50,
                       flush)
        s_ms = time_ms(lambda: paged_decode_step(
            q, k_new, v_new, kf, vf, tables, kv_len, impl="ref"), 50, flush)
        lib = sdpa_yardstick(q, k, v, tables, seq)
        l_ms = time_ms(lib, 50, flush)
        b_ms, b_by = bound(q, lens, KVH, dtype, page=S)
        fb_ms, fb_by = bound(q, lens, KVH, dtype, fused=True, page=S)
        row = {"phase": "kernels", "kernel": "paged_attention", "case": name,
               "dtype": str(dtype), "B": B, "Hq": Hq, "KVH": KVH, "hd": hd,
               "page": S, "pages_per_seq": 1, "num_pages": B,
               "split_tokens": pa_kernel.SPLIT_TOKENS,
               "splits": pa_kernel.num_splits(1, S),
               "seq_len_sum": int(sum(lens)), "seq_len_max": int(max(lens)),
               "tol": tol, "max_abs_err": max(err, f_err),
               "attend_max_abs_err": err, "fused_max_abs_err": f_err,
               "pages_bitwise_equal": True, "kernel_ms": k_ms,
               "fused_ms": f_ms, "ref_ms": r_ms, "plain_step_ms": s_ms,
               "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
               "fused_bound_ms": fb_ms, "fused_bound_by": fb_by}
        emit(row)
        rows.append(row)
    return rows


def api_cases(cfg):
    """Flash and paged cases at the shapes the Model API phases give the
    kernels: model_api's prefill (B, 512) and its decode at the prompts
    plus half the generation in a cache of 576; model_api_int8's prefill;
    cross_size's two models' prefills of 4 x 128; the MoE,
    encoder-decoder, hybrid and stablelm phases' prefills and decodes (hd
    80 and 160), mixtral's and zamba2's with their sliding window, and
    their window runs' prefill past it and decode over the ring."""
    a, b = cut_config(INT8_MODEL), cut_config(CROSS_B_MODEL)

    def heads(c):
        return c.num_heads, c.num_kv_heads

    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    flash = {
        f"main_model_api_B{API_B}_S{API_S}": (API_B, H, KVH, API_S, hd, True),
        f"main_int8_B{INT8_B}_S{INT8_S}": (INT8_B, *heads(a), INT8_S,
                                           a.resolved_head_dim, True),
        f"main_cross_a_B{CROSS_B}_S{CROSS_S}": (CROSS_B, *heads(a), CROSS_S,
                                                a.resolved_head_dim, True),
        f"main_cross_b_B{CROSS_B}_S{CROSS_S}": (CROSS_B, *heads(b), CROSS_S,
                                                b.resolved_head_dim, True),
    }
    _, lens = api_prompts(cfg, API_B, API_S, API_PROMPTS, API_SEED)
    paged = {f"main_model_api_page{API_MAX}": (
        API_B, H, KVH, hd, API_MAX,
        [int(n) + API_GEN // 2 for n in lens.cpu().numpy()])}
    # moe_dbrx, moe_mixtral: prefill (B, S); decode at the prompts plus
    # half the generation in a cache of S + 32
    for name, (S, prompt_range, seed) in MOE_RUNS.items():
        c, short = cut_config(name), name.split("-")[0]
        flash[f"main_{short}_B{MOE_B}_S{S}"] = (
            MOE_B, *heads(c), S, c.resolved_head_dim, True, c.sliding_window)
        _, lens = api_prompts(c, MOE_B, S, prompt_range, seed)
        paged[f"main_{short}_page{S + MOE_GEN}"] = (
            MOE_B, *heads(c), c.resolved_head_dim, S + MOE_GEN,
            [int(n) + MOE_GEN // 2 for n in lens.cpu().numpy()])
        if c.sliding_window:  # the window run: prefill, attend-only decode
            W, B = min(WIN_MAX, c.sliding_window), len(WIN_LENS)
            flash[f"main_{short}_window_B{B}_S{WIN_S}_W{W}"] = (
                B, *heads(c), WIN_S, c.resolved_head_dim, True,
                c.sliding_window)
            paged[f"main_{short}_window_page{W}"] = (
                B, *heads(c), c.resolved_head_dim, W, [W] * B)
    # encdec: the encoder (non-causal) and the decoder's prefill; decode's
    # self-attention (fused) in a cache of 96 and its cross-attention
    # (attend only) over 256 frames at src_len
    e = get_config(ENCDEC_MODEL)
    flash[f"main_encdec_enc_B{ENC_B}_S{ENC_SRC}"] = (
        ENC_B, *heads(e), ENC_SRC, e.resolved_head_dim, False)
    flash[f"main_encdec_dec_B{ENC_B}_S{ENC_S}"] = (
        ENC_B, *heads(e), ENC_S, e.resolved_head_dim, True)
    _, lens = api_prompts(e, ENC_B, ENC_S, ENC_PROMPTS, ENC_SEED)
    paged[f"main_encdec_page{ENC_MAX}"] = (
        ENC_B, *heads(e), e.resolved_head_dim, ENC_MAX,
        [int(n) + ENC_GEN // 2 for n in lens.cpu().numpy()])
    paged[f"main_encdec_cross_page{ENC_SRC}"] = (
        ENC_B, *heads(e), e.resolved_head_dim, ENC_SRC, list(ENC_SRC_LEN))
    # hybrid: zamba2's shared attention (hd 80, G = 1, its window): the
    # prefill, the ring run's and the window run's; decode fused in a cache
    # of 576 at the prompts plus half the generation, and attend only over
    # the ring's 4,096 slots (the ring and window runs)
    z = get_config(HYB_MODEL)
    hd_z = z.resolved_head_dim
    Wz = z.sliding_window
    flash[f"main_hybrid_B{HYB_B}_S{HYB_S}"] = (HYB_B, *heads(z), HYB_S, hd_z,
                                                True, Wz)
    flash[f"main_hybrid_ring_B1_S{RING_S}"] = (1, *heads(z), RING_S, hd_z,
                                               True, Wz)
    flash[f"main_hybrid_window_B1_S{HWIN_S}_W{Wz}"] = (
        1, *heads(z), HWIN_S, hd_z, True, Wz)
    _, lens = api_prompts(z, HYB_B, HYB_S, HYB_PROMPTS, HYB_SEED)
    paged[f"main_hybrid_page{HYB_MAX}"] = (
        HYB_B, *heads(z), hd_z, HYB_MAX,
        [int(n) + HYB_GEN // 2 for n in lens.cpu().numpy()])
    W = min(RING_MAX, z.sliding_window)
    paged[f"main_hybrid_ring_page{W}"] = (1, *heads(z), hd_z, W, [W])
    # stablelm: hd 160, G = 4: the prefill; decode fused in a cache of 288
    st = cut_config(STABLE_MODEL)
    flash[f"main_stablelm_B{STABLE_B}_S{STABLE_S}"] = (
        STABLE_B, *heads(st), STABLE_S, st.resolved_head_dim, True)
    _, lens = api_prompts(st, STABLE_B, STABLE_S, STABLE_PROMPTS, STABLE_SEED)
    paged[f"main_stablelm_page{STABLE_S + STABLE_GEN}"] = (
        STABLE_B, *heads(st), st.resolved_head_dim, STABLE_S + STABLE_GEN,
        [int(n) + STABLE_GEN // 2 for n in lens.cpu().numpy()])
    return flash, paged


# ---------------------------------------------------------------------------
# phase 11: training, checkpoints and the handoff to serving
# ---------------------------------------------------------------------------

# train: TinyLlama-1.1B whole from the port's init (seed 0), B = 8 x 512
# tokens from the data pipeline (seed 0), the default AdamW, bf16 compute:
# 12 steps, then 4 at the reference example's microbatches=2 with bf16
# gradients; an async checkpoint after step 8
TRAIN_MODEL = "tinyllama-1.1b"
TRAIN_B, TRAIN_S, TRAIN_SEED = 8, 512, 0
TRAIN_STEPS, TRAIN_MB_STEPS, TRAIN_SAVE_AT = 12, 4, 8
TRAIN_PROFILE_STEPS = 2
# the loss of step 1's batch after the 16 steps, below its value at init
# by at least this much (PERF.md §6 predicts it): the batches draw
# new tokens each step, so the fixed batch is what shows learning in 16
# steps
TRAIN_FIXED_DROP = 0.5
# written by the train phases and removed after them (gitignored)
TRAIN_CKPT = ROOT / ".train_ckpt"
# train_parity: fp32, TF32 off, one value_and_grad on the card against
# the host's CPU; TinyLlama's widths cut to 2 layers, then one reduced
# config of each other family
PARITY_B, PARITY_S = 1, 64
PARITY_LOSS_RTOL, PARITY_GRAD_RTOL = 1e-5, 1e-4
PARITY_CASES = {  # case: (config, reduced, fields replaced)
    "tinyllama-1.1b-2l": ("tinyllama-1.1b", False, {"num_layers": 2}),
    "mixtral-8x22b-reduced": ("mixtral-8x22b", True, {}),
    "mixtral-8x22b-reduced-dispatch": ("mixtral-8x22b", True,
                                       {"moe_impl": "dispatch"}),
    "seamless-m4t-medium-reduced": ("seamless-m4t-medium", True, {}),
    "zamba2-2.7b-reduced": ("zamba2-2.7b", True, {}),
    "xlstm-125m-reduced": ("xlstm-125m", True, {}),
}
# train_handoff: the trained weights served from a fresh zoo, two apps
HANDOFF_APPS = ("trained-base", "trained-lora")
HANDOFF_REQUESTS, HANDOFF_SEED = 8, 22


def train_step_flops(cfg, B, S):
    """(model FLOPs of one train step, N): PaLM's count, the recomputed
    forward of the checkpointed layers not counted -- 6 N a token over
    the N matmul weights (every layer's and the head's; the embedding is
    a gather), plus attention's 12 L H hd S a token (the scores and their
    product with V, forward and backward, over the whole S x S: the plain
    attention computes the masked half too)."""
    H, KVH, hd, D = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                     cfg.d_model)
    layer = D * (H + 2 * KVH) * hd + H * hd * D + 3 * D * cfg.d_ff
    n = cfg.num_layers * layer + D * cfg.vocab_size
    tokens = B * S
    return 6 * n * tokens + 12 * cfg.num_layers * H * hd * S * tokens, n


# kernel classes of a train step's profile, first match wins
KERNEL_CLASSES = (("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
                  ("softmax", ("softmax",)),
                  ("reduce", ("reduce",)),
                  ("index_scatter_gather", ("index", "scatter", "gather")),
                  ("copy_cast", ("copy",)))


def kernel_classes(by_kernel, n) -> dict:
    """Device ms a step by kernel class (``KERNEL_CLASSES``; the rest:
    ``elementwise_other``)."""
    out = {c: 0.0 for c, _ in KERNEL_CLASSES}
    out["elementwise_other"] = 0.0
    for us, _, k in by_kernel:
        low = k.lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(key in low for key in keys)), "elementwise_other")
        out[cls] += us / 1e3 / n
    return out


def device_batch(pipe, step):
    return {k: torch.from_numpy(v).to(DEVICE)
            for k, v in pipe.batch_at(step).items()}


def run_train_steps(step_fn, carry: dict, pipe, steps, after=None):
    """``step_fn`` over the pipeline's batches of ``steps``, the training
    state in ``carry`` (``params``, ``opt``) replaced after each step, so
    no caller keeps an earlier step's state alive.  Returns (losses, step
    walls: each step's host wall with its loss read back);
    ``after(step count, carry)`` runs after each step, outside its
    wall."""
    losses, walls = [], []
    for step in steps:
        batch = device_batch(pipe, step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry["params"], carry["opt"], m = step_fn(carry["params"],
                                                   carry["opt"], batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
        if after is not None:
            after(step + 1, carry)
    return losses, walls


def fixed_loss(model, params, batch) -> float:
    with torch.no_grad():
        return float(model.train_loss(params, batch))


def train_dense_phase(smi):
    """TinyLlama-1.1B trained whole: 12 steps, then 4 at microbatches=2
    with bf16 gradients, an async checkpoint after step 8 written while
    the steps go on; no kernel launches (the train loss's attention is the
    plain route, counted once a layer a forward); every loss finite, and
    the loss of step 1's batch after the 16 steps below its loss at init
    by ``TRAIN_FIXED_DROP``; then two steps under ``torch.profiler``."""
    resident = settle()
    cfg = get_config(TRAIN_MODEL)
    model = build_model(cfg)
    carry = {"params": model.init(
        torch.Generator(DEVICE).manual_seed(TRAIN_SEED))}
    carry["opt"] = adamw_init(carry["params"])
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_B, TRAIN_S,
                                    seed=TRAIN_SEED))
    batch0 = device_batch(pipe, 0)
    fixed_before = fixed_loss(model, carry["params"], batch0)
    one = make_train_step(model, TrainConfig())
    two = make_train_step(model, TrainConfig(microbatches=2,
                                             grad_compress="bf16"))
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    ckpt = Checkpointer(str(TRAIN_CKPT))
    save = {}

    def save_at(step, state):
        if step == TRAIN_SAVE_AT:
            t0 = time.perf_counter()
            ckpt.save(step, dict(state))
            save["save_call_s"] = time.perf_counter() - t0

    settle()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_routes()
    losses, walls = run_train_steps(one, carry, pipe, range(TRAIN_STEPS),
                                    save_at)
    peak_12 = torch.cuda.max_memory_allocated()
    # the update returns new tensors: step 12's are kept as they are
    params_12 = carry["params"]
    torch.cuda.reset_peak_memory_stats()
    mb_losses, mb_walls = run_train_steps(
        two, carry, pipe, range(TRAIN_STEPS, TRAIN_STEPS + TRAIN_MB_STEPS))
    params, opt = carry["params"], carry["opt"]
    launches = read_launches()
    routes = all_routes()
    peak_mb = torch.cuda.max_memory_allocated()
    n_fwd = TRAIN_STEPS + 2 * TRAIN_MB_STEPS  # forwards of the loss
    want_routes = {k: 0 for k in routes}
    want_routes["prefill_plain"] = cfg.num_layers * n_fwd
    if any(launches.values()) or routes != want_routes:
        raise RuntimeError(f"train_dense: launches {launches}, routes "
                           f"{routes}; want none and {want_routes}")
    all_losses = losses + mb_losses
    if not np.isfinite(all_losses).all():
        raise RuntimeError(f"train_dense: losses {all_losses}")
    fixed_after = fixed_loss(model, params, batch0)
    if not fixed_after <= fixed_before - TRAIN_FIXED_DROP:
        raise RuntimeError(f"train_dense: step 1's batch at {fixed_after} "
                           f"after {n_fwd} forwards, {fixed_before} at init "
                           f"(want a drop of {TRAIN_FIXED_DROP})")
    by_kernel, n = profiled(lambda: run_train_steps(
        one, dict(carry), pipe,
        range(TRAIN_STEPS + TRAIN_MB_STEPS,
              TRAIN_STEPS + TRAIN_MB_STEPS + TRAIN_PROFILE_STEPS))[0])
    device_s = sum(us for us, _, _ in by_kernel) / 1e6 / n
    # the step's two halves apart: the peak of the loss and its gradient,
    # then of the functional update (old and new params and moments)
    settle()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _, grads = value_and_grad(model, params, batch0)
    peak_grad = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    adamw_update(grads, opt, params, AdamWConfig())
    peak_update = torch.cuda.max_memory_allocated()
    del grads
    p50 = float(np.percentile(walls, 50))
    flops, n_params = train_step_flops(cfg, TRAIN_B, TRAIN_S)
    tokens = TRAIN_B * TRAIN_S
    row = {"phase": "train_dense", "model": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "batch": TRAIN_B, "seq_len": TRAIN_S,
           "compute_dtype": str(model.compute_dtype),
           "opt": dataclasses.asdict(AdamWConfig()),
           "steps": TRAIN_STEPS, "microbatch_steps": TRAIN_MB_STEPS,
           "losses": losses, "microbatch_losses": mb_losses,
           "first_loss": all_losses[0],
           "last_four_mean_loss": float(np.mean(all_losses[-4:])),
           "fixed_batch_loss": {"at_init": fixed_before,
                                "after_16_steps": fixed_after,
                                "drop_held_at_least": TRAIN_FIXED_DROP},
           "step_wall_p50_s": p50,
           "step_wall_p95_s": float(np.percentile(walls, 95)),
           "microbatch_step_wall_p50_s": float(np.percentile(mb_walls, 50)),
           "tokens_per_s": tokens / p50,
           "model_flops_per_step": flops, "matmul_params": n_params,
           "flops_count": "6 N tokens + 12 L H hd S tokens (PaLM); the "
                          "checkpointed layers' recompute not counted",
           "model_flops_share_of_bf16_peak":
           flops / p50 / PEAK_FLOPS[torch.bfloat16],
           "profile": {"steps": n, "device_ms_per_step": device_s * 1e3,
                       "device_busy_share": device_s / p50,
                       "kernel_launches_per_step":
                       sum(c for _, c, _ in by_kernel) / n,
                       "ms_per_step_by_class": kernel_classes(by_kernel, n),
                       "top": [{"kernel": k[:120], "device_ms_per_step":
                                us / 1e3 / n, "calls_per_step": c / n}
                               for us, c, k in by_kernel[:8]]},
           "launches": launches, "routes": {k: v for k, v in routes.items()
                                            if v},
           "checkpoint_save_call_s": save["save_call_s"],
           "max_memory_allocated_bytes": max(peak_12, peak_mb),
           "peak_bytes": {"steps_1_12": peak_12,
                          "microbatch_steps_with_step_12_kept": peak_mb,
                          "held_before_one_step": held,
                          "value_and_grad": peak_grad,
                          "adamw_update": peak_update},
           "resident_bytes_at_start": resident, "card": smi}
    emit(row)
    state = {"cfg": cfg, "model": model, "pipe": pipe, "ckpt": ckpt,
             "one": one, "params_12": params_12,
             "losses_9_12": losses[TRAIN_SAVE_AT:], "params": params}
    return launches, row, state


def train_resume_phase(state, smi):
    """The step-8 checkpoint (saved asynchronously during train_dense)
    waited for, restored into fresh tensors on the card, and steps 9-12
    trained again: the losses and the final parameters bitwise the
    uninterrupted run's, with no deterministic mode set (the step's
    reductions on the card run in a fixed order; the embedding's backward,
    an accumulating ``index_put_``, sorts the token ids).  Then the
    SIGTERM hook: a blocking checkpoint of the resumed run's step 12
    appears when the process signals itself."""
    model, ckpt, pipe = state["model"], state["ckpt"], state["pipe"]
    t0 = time.perf_counter()
    ckpt.wait()
    wait_s = time.perf_counter() - t0
    if ckpt.latest_step() != TRAIN_SAVE_AT:
        raise RuntimeError(f"train_resume: latest step {ckpt.latest_step()}")
    meta = model.param_shapes()
    t0 = time.perf_counter()
    restored = ckpt.restore({"params": meta, "opt": adamw_init(meta)},
                            device=DEVICE)
    restore_s = time.perf_counter() - t0
    if int(restored["opt"]["step"]) != TRAIN_SAVE_AT:
        raise RuntimeError(f"train_resume: restored step "
                           f"{int(restored['opt']['step'])}")
    losses, walls = run_train_steps(state["one"], restored, pipe,
                                    range(TRAIN_SAVE_AT, TRAIN_STEPS))
    params, opt = restored["params"], restored["opt"]
    want = state["params_12"]
    diffs = [float((a - b).abs().max()) for a, b in
             zip(tree_leaves(params), tree_leaves(want))]
    if losses != state["losses_9_12"] or any(diffs):
        raise RuntimeError(f"train_resume: losses {losses} against "
                           f"{state['losses_9_12']}, params off by "
                           f"{max(diffs)}")
    old = signal.getsignal(signal.SIGTERM)
    tree = {"params": params, "opt": opt}
    t0 = time.perf_counter()
    try:
        install_preemption_hook(ckpt, lambda: (TRAIN_STEPS, tree))
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, old)
    sigterm_s = time.perf_counter() - t0
    step_dir = TRAIN_CKPT / f"step_{TRAIN_STEPS:08d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    leaves, paths = tree_flatten_with_paths(tree)
    head = paths.index("(DictKey(key='params'), DictKey(key='lm_head'))")
    on_disk = np.load(step_dir / manifest["leaves"][head]["file"])
    if ckpt.latest_step() != TRAIN_STEPS or manifest["step"] != TRAIN_STEPS \
            or len(manifest["leaves"]) != len(leaves) \
            or not np.array_equal(on_disk, leaves[head].cpu().numpy()):
        raise RuntimeError(f"train_resume: no checkpoint of step "
                           f"{TRAIN_STEPS} after SIGTERM")
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    shutil.rmtree(TRAIN_CKPT)
    row = {"phase": "train_resume", "saved_at_step": TRAIN_SAVE_AT,
           "checkpoint_bytes": nbytes, "leaves": len(leaves),
           "wait_s": wait_s, "restore_s": restore_s,
           "resumed_losses": losses, "losses_bitwise": True,
           "params_bitwise": True,
           "step_wall_p50_s": float(np.percentile(walls, 50)),
           "sigterm_checkpoint": {"step": TRAIN_STEPS, "s": sigterm_s},
           "card": smi}
    emit(row)
    return row


def parity_case(case):
    name, reduced, fields = PARITY_CASES[case]
    cfg = (get_reduced_config if reduced else get_config)(name)
    cfg = dataclasses.replace(cfg, **fields)
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(DataConfig(
        cfg.vocab_size, PARITY_B, PARITY_S)).batch_at(0).items()}
    if cfg.family == "encdec":
        batch["frames"] = 0.1 * torch.randn(
            PARITY_B, 24, cfg.d_model,
            generator=torch.Generator().manual_seed(1))
    return cfg, model, params, batch


def train_parity_phase(smi):
    """One fp32 ``value_and_grad`` (TF32 off) on the card against the same
    on the host's CPU, for TinyLlama's widths cut to 2 layers (B = 1,
    S = 64) and one reduced config of each other family: the loss within
    1e-5 (relative), every leaf's gradient within 1e-4 in relative L2
    norm, no kernel launched."""
    rows = []
    for case in PARITY_CASES:
        cfg, model, params, batch = parity_case(case)
        want_loss, want = value_and_grad(model, params, batch)
        reset_launches()
        reset_routes()
        M.margin_log = [] if cfg.family == "moe" else None
        try:
            loss, grads = value_and_grad(model, to_device(params, DEVICE),
                                         to_device(batch, DEVICE))
            gaps = [float(x["margin"].detach().min())
                    for x in M.margin_log or []]
        finally:
            M.margin_log = None
        launches = read_launches()
        rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        errs = {p: float((g.cpu() - w).norm()) / max(float(w.norm()), 1e-30)
                for g, w, p in zip(tree_leaves(grads), tree_leaves(want),
                                   tree_flatten_with_paths(want)[1])}
        worst = max(errs, key=errs.get)
        if any(launches.values()) or T.PREFILL_ROUTES["flash"] \
                or not rel <= PARITY_LOSS_RTOL \
                or not errs[worst] <= PARITY_GRAD_RTOL:
            raise RuntimeError(f"train_parity {case}: launches {launches}, "
                               f"loss {float(loss)} vs {float(want_loss)}, "
                               f"{worst} at {errs[worst]}")
        rows.append({"case": case, "family": cfg.family,
                     "d_model": cfg.d_model, "layers": cfg.num_layers,
                     "loss_card": float(loss), "loss_cpu": float(want_loss),
                     "loss_rel_err": rel, "leaves": len(errs),
                     "worst_grad_rel_l2": errs[worst], "worst_leaf": worst,
                     **({"min_router_gap": min(gaps)} if gaps else {})})
    row = {"phase": "train_parity", "batch": PARITY_B, "seq_len": PARITY_S,
           "dtype": "float32", "tf32": False, "cases": rows,
           "loss_rtol": PARITY_LOSS_RTOL, "grad_rel_l2_tol": PARITY_GRAD_RTOL,
           "card": smi}
    emit(row)
    return row


def handoff_traffic(cfg):
    rng = np.random.RandomState(HANDOFF_SEED)
    return [ServeRequest(app=HANDOFF_APPS[i % 2], gen_len=GEN_LEN,
                         prompt_tokens=rng.randint(
                             0, cfg.vocab_size, size=int(rng.randint(16, 129))
                         ).astype(np.int32))
            for i in range(HANDOFF_REQUESTS)]


def train_handoff_phase(state, smi):
    """The trained TinyLlama registered in a fresh ``BlockZoo`` as
    foundation ``trained-base``, with ``trained-lora`` (its LoRA B
    matrices nonzero); ``profile_block`` on its first layer block; 8
    requests served through ``BlockEngine.submit/drain``, each kernel's
    launches equal to its executor counter; the base app's greedy tokens
    equal to the Model API's ``prefill`` + ``decode_step`` on a fresh copy
    of the trained weights wherever the Model API's top-2 margin is
    clear (serving reads the trained weights, through no stale cast)."""
    cfg, model, params = state["cfg"], state["model"], state["params"]
    resident = settle()
    zoo = BlockZoo()
    zoo.register_foundation(HANDOFF_APPS[0], cfg, params)
    lora = peft.create_lora(cfg, torch.Generator(DEVICE).manual_seed(2))
    g = torch.Generator(DEVICE).manual_seed(100)
    for layer in lora:
        layer["b_q"].normal_(0.0, 0.05, generator=g)
        layer["b_v"].normal_(0.0, 0.05, generator=g)
    zoo.register_peft(HANDOFF_APPS[1], cfg, HANDOFF_APPS[0], "lora", lora)
    base = [zoo.blocks[s.block_id] for s in zoo.chains[HANDOFF_APPS[0]].steps]
    if base[0].params["embed"] is not params["embed"] or \
            base[1].params["wq"].data_ptr() != \
            params["layers"]["wq"][0].data_ptr():
        raise RuntimeError("train_handoff: the zoo does not hold the "
                           "trained weights")
    prof = zoo.profile_block(base[1].id, batch_sizes=(1, 8, 32), seq_len=64)
    reqs = handoff_traffic(cfg)
    serve(engine(zoo), [ServeRequest(app=a, gen_len=4, prompt_tokens=np.arange(
        20, dtype=np.int32)) for a in HANDOFF_APPS])  # warm-up
    eng = engine(zoo)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    results = serve(eng, reqs)
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = dict(eng.stats)
    for r in results:
        if len(r.tokens) != GEN_LEN or r.tokens.min() < 0 \
                or r.tokens.max() >= cfg.vocab_size:
            raise RuntimeError(f"train_handoff: rid {r.rid}: bad tokens")
    check_launches(launches, stats, "train_handoff")
    check_prefill_calls(stats, reqs, cfg.num_layers, "train_handoff")
    peak = torch.cuda.max_memory_allocated()
    # the Model API on a fresh copy of the trained weights, app base's
    # prompts right-padded to the longest
    mine = [(r, q) for r, q in zip(results, reqs) if q.app == HANDOFF_APPS[0]]
    lens_np = np.array([len(q.prompt_tokens) for _, q in mine], np.int32)
    tok_np = np.zeros((len(mine), int(lens_np.max())), np.int32)
    for b, (_, q) in enumerate(mine):
        tok_np[b, :lens_np[b]] = q.prompt_tokens
    fresh = tree_map(torch.clone, params)
    api_tok, api_logits, _, _ = api_run(
        model, fresh, torch.from_numpy(tok_np).to(DEVICE),
        torch.from_numpy(lens_np).to(DEVICE), MAX_LEN, GEN_LEN - 1, "auto")
    del fresh
    api_tok = api_tok.cpu().numpy()
    margins = top2_margin(api_logits).cpu().numpy()  # (steps, B)
    equal, flips = 0, []
    for b, (r, _) in enumerate(mine):
        diff = np.nonzero(r.tokens != api_tok[b])[0]
        j = int(diff[0]) if len(diff) else GEN_LEN
        equal += j
        if len(diff):
            flips.append({"request": b, "at": j,
                          "api_margin": float(margins[j, b])})
    if any(f["api_margin"] >= API_MARGIN for f in flips):
        raise RuntimeError(f"train_handoff: engine and Model API flip at a "
                           f"clear margin: {flips}")
    tokens = sum(len(r.tokens) for r in results)
    row = {"phase": "train_handoff", "model": cfg.name,
           "apps": list(HANDOFF_APPS), "requests": len(results),
           "prompt_lens": [len(q.prompt_tokens) for q in reqs],
           "gen_len": GEN_LEN, "tokens": tokens, "wall_s": wall,
           "tok_per_s": tokens / wall, "launches": launches,
           "engine_calls": engine_calls(stats),
           "vs_model_api": {"tokens_equal": equal,
                            "tokens_compared": len(mine) * GEN_LEN,
                            "flips": flips, "allowed_below": API_MARGIN},
           "profile_block": {"block": base[1].id, "seq_len": 64,
                             "us_per_token": {
                                 bs: t * 1e6 for bs, t in
                                 prof.compute_time_per_token.items()}},
           "zoo_blocks": len(zoo.blocks),
           "max_memory_allocated_bytes": peak,
           "resident_bytes_at_start": resident, "card": smi}
    emit(row)
    del eng, zoo
    return launches, row


def train_phases(smi):
    """train_dense, train_resume, train_parity, train_handoff.  Returns
    ({path: launches}, {phase: row}, {phase: seconds})."""
    took, rows = {}, {}
    t0 = time.perf_counter()
    dense_launches, rows["train_dense"], state = train_dense_phase(smi)
    took["train_dense"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows["train_resume"] = train_resume_phase(state, smi)
    took["train_resume"] = time.perf_counter() - t0
    for k in ("params_12", "one", "ckpt"):
        del state[k]
    t0 = time.perf_counter()
    rows["train_parity"] = train_parity_phase(smi)
    took["train_parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    handoff_launches, rows["train_handoff"] = train_handoff_phase(state, smi)
    took["train_handoff"] = time.perf_counter() - t0
    return ({"train_dense": dense_launches,
             "train_handoff": handoff_launches}, rows, took)


# mesh: TinyLlama-1.1B's cells through build_cell on the (1, 1) mesh, two
# train steps; the dry-run's cells, each traced in its own process
MESH_TRAIN_STEPS = 2
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", "single"),
                ("mixtral-8x22b", "decode_32k", "multi"))
DRYRUN_TAG = "chip_smoke"
DRYRUN_TIMEOUT_S = 900
MESH_CKPT = ROOT / ".train_ckpt" / "mesh"


def start_dryruns():
    """The dry-run cells, one process each, started together: they trace
    on the host's CPU (``meta`` tensors under a ``fake`` group) while the
    card's phases run.  Returns [(cell, Popen, start time)]."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = []
    for arch, shape, mesh in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--tag", DRYRUN_TAG]
        out.append(((arch, shape, mesh),
                    subprocess.Popen(cmd, env=env, cwd=ROOT,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    time.perf_counter()))
    return out


def finish_dryruns(procs):
    """Wait for each dry-run process (killed at ``DRYRUN_TIMEOUT_S`` after
    its start) and read its record; any failure raises."""
    recs = []
    for (arch, shape, mesh), proc, t0 in procs:
        left = max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0))
        try:
            stdout, stderr = proc.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise RuntimeError(f"dryrun {arch} {shape} {mesh}: no record "
                               f"after {DRYRUN_TIMEOUT_S} s")
        if proc.returncode != 0:
            raise RuntimeError(f"dryrun {arch} {shape} {mesh}: exit "
                               f"{proc.returncode}\n{stdout[-2000:]}\n"
                               f"{stderr[-4000:]}")
        path = roofline.DRYRUN_DIR / \
            f"{DRYRUN_TAG}__{arch}__{shape}__{mesh}.json"
        rec = json.loads(path.read_text())
        h = rec["hlo_per_device"]
        if not (h["flops"] > 0 and h["bytes"] > 0
                and rec["model_flops"] > 0):
            raise RuntimeError(f"dryrun {arch} {shape} {mesh}: record {h}")
        recs.append(rec)
    return recs


def full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def first_diff(got, want) -> dict:
    """Where two trees of tensors differ: the count of leaves not bitwise
    equal and the largest difference."""
    bad, worst = 0, 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = full(a), full(b)
        if not torch.equal(a, b):
            bad += 1
            worst = max(worst, float((a.float() - b.float()).abs().max()))
    return {"leaves_not_bitwise": bad, "max_abs_diff": worst}


def mesh_train(mesh, smi):
    """The train cell at train_dense's shape for ``MESH_TRAIN_STEPS`` steps
    of the pipeline's batches, then ``make_train_step`` on the same
    batches from the same initial state: losses and state bitwise.
    Returns (launches, row part, the cell's final state, its placements)."""
    cfg = get_config(TRAIN_MODEL)
    model = build_model(cfg)
    params = model.init(torch.Generator(DEVICE).manual_seed(TRAIN_SEED))
    opt = adamw_init(params)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_B, TRAIN_S,
                                    seed=TRAIN_SEED))
    shape = ShapeConfig("train_dense", TRAIN_S, TRAIN_B, "train")
    t0 = time.perf_counter()
    fn, structs, in_pl, out_pl, donate = build_cell(cfg, shape, mesh)
    build_s = time.perf_counter() - t0
    if donate != (0, 1):
        raise RuntimeError(f"mesh train: donated {donate}")
    settle()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_routes()
    carry = {"params": place(params, in_pl[0], mesh),
             "opt": place(opt, in_pl[1], mesh)}

    def cell(p, o, batch):
        p, o, loss = fn(p, o, place(batch, in_pl[2], mesh))
        return p, o, {"loss": full(loss)}

    losses, walls = run_train_steps(cell, carry, pipe,
                                    range(MESH_TRAIN_STEPS))
    launches = read_launches()
    routes = all_routes()
    peak = torch.cuda.max_memory_allocated()
    want_routes = {k: 0 for k in routes}
    want_routes["prefill_plain"] = cfg.num_layers * MESH_TRAIN_STEPS
    if any(launches.values()) or routes != want_routes:
        raise RuntimeError(f"mesh train: launches {launches}, routes "
                           f"{routes}; want none and {want_routes}")
    ref = {"params": params, "opt": opt}
    ref_losses, ref_walls = run_train_steps(
        make_train_step(model, TrainConfig()), ref, pipe,
        range(MESH_TRAIN_STEPS))
    diff = first_diff((carry["params"], carry["opt"]),
                      (ref["params"], ref["opt"]))
    bitwise = losses == ref_losses and diff["leaves_not_bitwise"] == 0
    if not bitwise:
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        if not (np.isfinite(losses).all()
                and rel <= TOL[torch.bfloat16]):
            raise RuntimeError(f"mesh train: cell losses {losses}, "
                               f"make_train_step {ref_losses}; {diff}")
    del ref, params, opt
    tokens = TRAIN_B * TRAIN_S
    part = {"train": {
        "shape": [TRAIN_B, TRAIN_S], "steps": MESH_TRAIN_STEPS,
        "build_cell_s": build_s, "losses": losses,
        "make_train_step_losses": ref_losses,
        "step_walls_s": walls, "make_train_step_walls_s": ref_walls,
        "tokens_per_s_last_step": tokens / walls[-1],
        "make_train_step_tokens_per_s_last_step": tokens / ref_walls[-1],
        "bitwise_vs_make_train_step": bitwise, **diff,
        "max_memory_allocated_bytes": peak, "launches": launches,
        "routes": {k: v for k, v in routes.items() if v},
        "placements": {"wq": str(in_pl[0]["layers"]["wq"]),
                       "tokens": str(in_pl[2]["tokens"])}}}
    return launches, part, carry, in_pl


def mesh_serve(mesh):
    """The prefill and decode cells at model_api's traffic against the
    Model API on the same weights.  Returns ({path: launches}, row
    part)."""
    cfg = get_config(MODEL)
    model = build_model(cfg)
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    tokens, lens = api_prompts(cfg, API_B, API_S, API_PROMPTS, API_SEED)
    pre = build_cell(cfg, ShapeConfig("api_prefill", API_S, API_B,
                                      "prefill"), mesh)
    dec = build_cell(cfg, ShapeConfig("api_decode", API_MAX, API_B,
                                      "decode"), mesh)
    p_pre = place(params, pre[2][0], mesh)
    p_dec = place(params, dec[2][0], mesh)
    batch = place({"tokens": tokens, "prompt_lens": lens}, pre[2][1], mesh)
    L_ = cfg.num_layers

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, _ = pre[0](p_pre, batch)
        # the decode cell's cache: the prefill's, padded from S to API_MAX
        cache = place({k: torch.nn.functional.pad(
            full(v), (0, 0, 0, 0, 0, API_MAX - API_S)) for k, v in
            cache.items()}, dec[2][1], mesh)
        logits = full(logits)
        nxt = logits.argmax(-1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        toks, out, step_s = [nxt], [logits.float()], []
        for j in range(API_GEN):
            t1 = time.perf_counter()
            step = place({"tokens": nxt[:, None].to(torch.int32),
                          "kv_len": lens + j}, dec[2][2], mesh)
            logits, cache = dec[0](p_dec, cache, step)
            nxt = full(logits).argmax(-1)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            toks.append(nxt)
            out.append(full(logits).float())
        return torch.stack(toks, 1), torch.stack(out), prefill_s, step_s

    run()  # warm-up: DTensor's sharding rules, the casts, cuBLAS
    settle()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_routes()
    logits, cache, _ = pre[0](p_pre, batch)
    torch.cuda.synchronize()
    pre_launches, pre_routes = read_launches(), all_routes()
    reset_launches()
    reset_routes()
    del logits, cache
    got_tok, got, prefill_s, step_s = run()
    launches = read_launches()
    routes = dict(T.DECODE_ROUTES)
    peak = torch.cuda.max_memory_allocated()
    want_pre = {"paged_attention": 0, "flash_attention": L_,
                "batched_lora": 0}
    # run() prefills once more before its decode steps
    want_dec = {"paged_attention": L_ * API_GEN, "flash_attention": L_,
                "batched_lora": 0}
    if pre_launches != want_pre or pre_routes["prefill_flash"] != L_ \
            or launches != want_dec or routes["paged"] != L_ * API_GEN:
        raise RuntimeError(f"mesh serve: prefill launches {pre_launches} "
                           f"(want {want_pre}), prefill + decode "
                           f"{launches} (want {want_dec}), routes {routes}")
    want_tok, want, _, _ = api_run(model, params, tokens, lens, API_MAX,
                                   API_GEN, "auto")
    logits_bitwise = torch.equal(got[0], want[0])
    tokens_equal = int((got_tok[:, :API_GEN] == want_tok[:, :API_GEN])
                       .sum())
    if not (torch.isfinite(got).all() and got.shape == want.shape):
        raise RuntimeError(f"mesh serve: logits {tuple(got.shape)}")
    if logits_bitwise and tokens_equal == API_B * API_GEN \
            and torch.equal(got, want):
        held = {"bitwise": True}
    else:  # DTensor changed some op's order: the Model API's chain bound
        held = {"bitwise": False, **hold_logits(got, want, "mesh serve")}
    prompt_tokens = int(lens.sum())
    part = {"serve": {
        "batch": API_B, "padded_S": API_S, "max_len": API_MAX,
        "decode_steps": API_GEN, "prompt_lens": lens.tolist(),
        "prefill_logits_bitwise": logits_bitwise,
        "tokens_equal": tokens_equal, "tokens_compared": API_B * API_GEN,
        "vs_model_api": held,
        "prefill_s": prefill_s, "prefill_tok_per_s": prompt_tokens / prefill_s,
        "decode_step_wall_p50_s": float(np.percentile(step_s, 50)),
        "decode_tok_per_s": API_B * API_GEN / sum(step_s),
        "max_memory_allocated_bytes": peak,
        "prefill_launches": pre_launches, "decode_launches": {
            k: v - want_pre[k] for k, v in launches.items()},
        "routes": routes,
        "placements": {"wq": str(pre[2][0]["layers"]["wq"]),
                       "cache_k": str(dec[2][1]["k"])}}}
    del p_pre, p_dec, params
    return {"mesh_prefill": pre_launches,
            "mesh_decode": {k: v - want_pre[k] for k, v in launches.items()}
            }, part


def mesh_restore(mesh, state, placements):
    """The trained cell state saved whole and restored with
    ``shardings=`` onto the mesh: bitwise, and placed as it was."""
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    ckpt = Checkpointer(str(MESH_CKPT))
    t0 = time.perf_counter()
    ckpt.save(MESH_TRAIN_STEPS, state, blocking=True)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ckpt.restore(state, shardings=placements, mesh=mesh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    diff = first_diff(back, state)
    placed = all(isinstance(b, DTensor) and b.placements == a.placements
                 for a, b in zip(tree_leaves(state), tree_leaves(back)))
    nbytes = sum(full(t).numel() * full(t).element_size()
                 for t in tree_leaves(state))
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    if diff["leaves_not_bitwise"] or not placed:
        raise RuntimeError(f"mesh restore: {diff}, placements kept: "
                           f"{placed}")
    return {"restore": {"bytes": nbytes, "leaves": len(tree_leaves(state)),
                        "save_s": save_s, "restore_s": restore_s,
                        "bitwise": True, "placements_kept": placed}}


def mesh_phase(dryruns, smi):
    """A real one-rank nccl group and its (1, 1) mesh; TinyLlama-1.1B's
    train, prefill and decode cells through ``build_cell``, the restore
    onto the mesh, then the dry-run records and their roofline.  Returns
    ({path: launches}, row)."""
    resident = settle()
    MESH.init_local_process_group("nccl")
    try:
        mesh = MESH.make_local_mesh()
        if mesh.shape != (1, 1) or \
                mesh.device_type != torch.device(DEVICE).type:
            raise RuntimeError(f"mesh: {mesh}")
        train_launches, row, state, in_pl = mesh_train(mesh, smi)
        row.update(mesh_restore(mesh, {"params": state["params"],
                                       "opt": state["opt"]},
                                {"params": in_pl[0], "opt": in_pl[1]}))
        del state
        serve_launches, part = mesh_serve(mesh)
        row.update(part)
    finally:
        torch.distributed.destroy_process_group()
    recs = finish_dryruns(dryruns)
    table = "\n".join(
        [roofline.table(DRYRUN_TAG, m)[0] for m in ("single", "multi")])
    print(table, flush=True)
    row = {"phase": "mesh", "model": MODEL, "mesh": [1, 1],
           "backend": "nccl", **row,
           "dryrun": [{
               "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
               "chips": r["chips"], "trace_s": r["trace_s"],
               "flops_per_device": r["hlo_per_device"]["flops"],
               "bytes_per_device": r["hlo_per_device"]["bytes"],
               "collective_bytes_per_device":
               r["hlo_per_device"]["collectives"],
               "collective_counts": r["hlo_per_device"]["collective_counts"],
               "model_flops": r["model_flops"],
               "roofline": roofline.terms(r)} for r in recs],
           "resident_bytes_at_start": resident, "card": smi}
    emit(row)
    return {"mesh_train": train_launches, **serve_launches}, row


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on an NVIDIA GPU")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    dryruns = start_dryruns()  # on the host's CPU, beside the card's work
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    _build.build_all(Path(ROOT / src) for _, src, _ in KERNELS.values())
    for module, _, _ in KERNELS.values():
        module.load()
    build_s = time.perf_counter() - t0
    emit({"phase": "env", "card": smi,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "kernel_libraries": [str(m.library_path().relative_to(ROOT))
                               for m, _, _ in KERNELS.values()]})

    cfg = get_config(MODEL)
    t0 = time.perf_counter()
    gemm_rows_phase(cfg, (traffic(cfg), long_traffic(cfg)), smi)
    phase_s = {"gemm_rows": time.perf_counter() - t0}
    G_kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    H = cfg.num_heads
    paged_cases = paged_attention_cases(cfg)
    main_flash, main_lora = main_path_cases(
        cfg, (traffic(cfg), long_traffic(cfg)))
    flash_cases = {  # B, Hq, KVH, S, hd, causal
        "b4_s128": (4, H, G_kv, 128, hd, True),
        "b4_s2048": (4, H, G_kv, LONG_MAX, hd, True),
        "ragged_1": (2, H, G_kv, 1, hd, True),
        "ragged_17": (2, H, G_kv, 17, hd, True),
        "ragged_129": (2, H, G_kv, 129, hd, True),
        "ragged_1000": (2, H, G_kv, 1000, hd, True),
        "demo_heads": (4, 8, 4, 256, 32, True),
        "non_causal": (2, H, G_kv, 256, hd, False),
        **main_flash,
    }
    # the sliding window past itself at the windowed configs' heads: two
    # windows, and the reference's prefill_32k length (eight)
    for name, S in (("mixtral-8x22b", 8192), ("zamba2-2.7b", 8192),
                    ("mixtral-8x22b", 32768)):
        c = get_config(name)
        W = c.sliding_window
        flash_cases[f"window_{name.split('-')[0]}_B1_S{S}_W{W}"] = (
            1, c.num_heads, c.num_kv_heads, S, c.resolved_head_dim, True, W)
    D, r = cfg.d_model, LORA_RANK
    lora_cases = {  # T, D, F, G, r, bt
        "decode_q": (16, D, H * hd, 1, r, LORA_BT),
        "decode_v": (16, D, G_kv * hd, 1, r, LORA_BT),
        "prefill_q": (4 * LONG_MAX, D, H * hd, 1, r, LORA_BT),
        "packed_g4": (700, D, H * hd, 4, r, LORA_BT),
        "ragged_t": (1000, D, G_kv * hd, 1, r, LORA_BT),
        **main_lora,
    }
    api_flash, api_paged = api_cases(cfg)
    flash_cases.update(api_flash)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    t0 = time.perf_counter()
    rows = kernel_phase(paged_cases, flush)
    for name, case in api_paged.items():
        rows += one_page_case(name, *case, flush)
    paged_split_sweep({c: paged_cases[c] for c in ("main_path", "long")},
                      flush)
    rows += flash_phase(flash_cases, flush)
    rows += lora_phase(lora_cases, flush)
    split_sweep(D, {"q": H * hd, "v": G_kv * hd}, flush)
    del flush
    torch.cuda.empty_cache()
    phase_s["kernels"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg, zoo = build_zoo()
    zoo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    emit({"phase": "zoo", "model": MODEL, "build_s": zoo_s,
          "blocks": len(zoo.blocks), "zoo_bytes": zoo.zoo_bytes(),
          "equivalences": len(zoo.equivalences) // 2})
    reqs, results, eng_launches, eng_row = engine_phase(cfg, zoo, smi)
    phase_s["engine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    profile_phase(zoo, reqs, eng_row["step_wall_p50_s"])
    phase_s["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    long_launches, long_row = long_prefill_phase(cfg, zoo, smi)
    # the recompute prefill's unpadded length, known only now
    n = long_row["recalc"]["prefilled"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    rows += flash_phase({f"main_recalc_B1_S{n}": (1, H, G_kv, n, hd, True)},
                        flush)
    del flush
    phase_s["long_prefill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec_launches, spec = speculation_phase(cfg, zoo, smi)
    # the spec recompute prefill's unpadded length, known only now
    n = next(p["recalc"]["prefilled"] for p in spec["preemption"]
             if p["run"] == "recalc")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    rows += flash_phase({f"main_spec_recalc_B1_S{n}":
                         (1, H, G_kv, n, hd, True)}, flush)
    del flush
    phase_s["speculation"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    adaptive_launches, _ = adaptive_phase(cfg, zoo, smi)
    phase_s["adaptive"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launch_launches, launch = launch_phase(smi)
    phase_s["launch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused_vs_per_hop(cfg, zoo)
    cuda_vs_ref(zoo, reqs, results)
    phase_s["parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    api_launches, api = model_api_phase(cfg, zoo, smi)
    phase_s["model_api"] = time.perf_counter() - t0
    del zoo  # the engine phases' zoo: the cross-size models need the room
    t0 = time.perf_counter()
    int8_launches, int8, cfg_a, params_a = model_api_int8_phase(smi)
    phase_s["model_api_int8"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cross_launches, cross = cross_size_phase(cfg_a, params_a, smi)
    del params_a
    phase_s["cross_size"] = time.perf_counter() - t0
    moe_launches, moe_rows = {}, {}
    for name in MOE_RUNS:
        t0 = time.perf_counter()
        phase = f"moe_{name.split('-')[0]}"
        paths, moe_rows[phase] = moe_phase(name, smi)
        moe_launches.update(paths)
        phase_s[phase] = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc_launches, enc = encdec_phase(smi)
    phase_s["encdec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hyb_launches, hyb = hybrid_phase(smi)
    phase_s["hybrid"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssm_launches, ssm = ssm_phase(smi)
    phase_s["ssm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stable_launches, stable = stablelm_phase(smi)
    phase_s["stablelm"] = time.perf_counter() - t0
    train_launches, train, train_s = train_phases(smi)
    phase_s.update(train_s)
    t0 = time.perf_counter()
    mesh_launches, mesh = mesh_phase(dryruns, smi)
    phase_s["mesh"] = time.perf_counter() - t0

    # each main-path run: counts set to 0 just before, read just after
    by_path = {"engine": eng_launches, **{
        f"long_prefill_{k}": v for k, v in long_launches.items()},
        **spec_launches, "adaptive": adaptive_launches,
        "launch": launch_launches, "model_api": api_launches,
        "model_api_int8": int8_launches, "cross_size": cross_launches,
        **moe_launches, "encdec": enc_launches, **hyb_launches,
        "ssm": ssm_launches, "stablelm": stable_launches, **train_launches,
        **mesh_launches}
    # the shape each kernel's ms stands for: paged attention's decode
    # batch; flash's costliest prefill call (the long path's largest
    # group); LoRA's decode q projection at the lane bucket of the merged
    # walk over the engine's three apps, where most of its launches run
    (_, S), B = max(prefill_groups(long_traffic(cfg)).items(),
                    key=lambda kv: kv[0][1] * kv[1])
    main_case = {"paged_attention": "main_path",
                 "flash_attention": f"main_B{B}_S{S}",
                 "batched_lora": f"main_decode_q_T{min(_bucket(len(reqs)), 16)}"}
    # paged attention runs on the main paths as the fused decode step (one
    # launch: page write and attention), so its line gives that call's
    # time, bound and plain version (scatter + attend); SDPA attends only
    keys = {name: ("kernel_ms", "ref_ms", "bound_ms", "bound_by")
            for name in KERNELS}
    keys["paged_attention"] = ("fused_ms", "plain_step_ms", "fused_bound_ms",
                               "fused_bound_by")
    line = []
    for name, (_, source, replaces) in KERNELS.items():
        ms, plain, bnd, by = keys[name]
        mine = [x for x in rows if x["kernel"] == name
                and x["case"].startswith("main")]
        bf16 = next(x for x in mine if x["dtype"] == "torch.bfloat16"
                    and x["case"] == main_case[name])
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {p: v[name] for p, v in by_path.items()},
            "case": main_case[name],
            "max_abs_err": max(x["max_abs_err"] for x in mine),
            "main_path_ms": {x["case"]: x[ms] for x in mine
                             if x["dtype"] == "torch.bfloat16"},
            "ms": bf16[ms], "plain_ms": bf16[plain],
            "bound_ms": bf16[bnd], "bound_by": bf16[by],
            "library_ms": bf16["library_ms"]}
        if name == "paged_attention":
            entry["attend_only_ms"] = bf16["kernel_ms"]
            # the encoder-decoder's cross-attention launches attend only
            entry["main_path_attend_only_ms"] = {
                x["case"]: x["kernel_ms"] for x in mine
                if x["dtype"] == "torch.bfloat16"}
        line.append(entry)
    emit({"phase": "done", "total_s": time.perf_counter() - t_start,
          "kernel_build_s": build_s, "zoo_build_s": zoo_s,
          "phase_s": phase_s, "tok_per_s": eng_row["tok_per_s"],
          "long_prefill_tok_per_s": long_row["prefill_tok_per_s"],
          "speculation_tok_per_s": {r["run"]: r["tok_per_s"]
                                    for r in spec["runs"]},
          "launch_tok_per_s": launch["real"]["tokens_per_s"],
          "model_api_decode_tok_per_s": api["decode_tok_per_s"],
          "model_api_int8_decode_tok_per_s": int8["decode_tok_per_s"],
          "cross_size_peak_bytes": cross["max_memory_allocated_bytes"],
          **{f"{k}_decode_tok_per_s": v["decode_tok_per_s"]
             for k, v in moe_rows.items()},
          **{f"{k}_window_decode_tok_per_s": v["window"]["decode_tok_per_s"]
             for k, v in moe_rows.items() if "window" in v},
          "encdec_decode_tok_per_s": enc["decode_tok_per_s"],
          "hybrid_decode_tok_per_s": hyb["decode_tok_per_s"],
          "hybrid_ring_decode_tok_per_s": hyb["ring"]["decode_tok_per_s"],
          "hybrid_window_decode_tok_per_s":
          hyb["window"]["decode_tok_per_s"],
          "ssm_decode_tok_per_s": ssm["decode_tok_per_s"],
          "stablelm_decode_tok_per_s": stable["decode_tok_per_s"],
          "train_step_wall_p50_s": train["train_dense"]["step_wall_p50_s"],
          "train_tokens_per_s": train["train_dense"]["tokens_per_s"],
          "train_handoff_tok_per_s": train["train_handoff"]["tok_per_s"],
          "mesh_train_tokens_per_s":
          mesh["train"]["tokens_per_s_last_step"],
          "mesh_decode_tok_per_s": mesh["serve"]["decode_tok_per_s"]})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
