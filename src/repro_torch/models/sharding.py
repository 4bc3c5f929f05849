"""Sharding rules: param/activation/cache specs per (family, mode) — the
port of ``repro.models.sharding``.

Strategy (DESIGN.md §5):
- train: batch over (pod, data); params + optimizer FSDP over `data` and TP
  over `model` (ZeRO-3 x TP); residual stream sequence-parallel over `model`;
  attention/ffn internals head/ffn-sharded over `model`.
- prefill: batch over `data`, TP over `model` (params replicated over data:
  weight-stationary, activation-heavy).
- decode: batch over `data`; KV cache sharded kv_head-over-`model` when
  kv_heads % |model| == 0, else head_dim-over-`model` (GQA with few KV heads);
  params TP over `model` only.

A spec is the reference's ``PartitionSpec`` as a tuple (``Spec``) with one
entry per tensor dim: ``None`` (replicated), an axis name, or a tuple of axis
names (the dim sharded over each, major first).  ``placements`` turns a
spec into DTensor placements, the other way round: one entry per *mesh*
dim, ``Shard(i)`` where the spec names that axis on tensor dim ``i``, else
``Replicate()``.  A dim sharded over ``("pod", "data")`` becomes two
``Shard`` placements on the same dim, split in mesh order; that agrees
with JAX's order because every spec lists its axes in mesh order
(``dp_axes`` does).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``launch.mesh``); the rules read only its axis names and sizes.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig

MODEL_AXIS = "model"

# one spec entry: replicated, one axis, or several axes (major first)
Axis = Union[None, str, Tuple[str, ...]]


class Spec(tuple):
    """A spec: a tuple of ``Axis`` entries, one per tensor dim.  Its own
    type, so a tree walk stops at it as at a leaf (``launch.shardings``)."""

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


def P(*axes: Axis) -> Spec:
    """A spec, written as the reference writes ``PartitionSpec(...)``."""
    return Spec(axes)


def mesh_shape(mesh) -> dict:
    """{axis name: size}, as the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of ``spec`` on ``mesh``.  An
    axis of size 1 splits nothing: its placement is ``Replicate()`` (the
    same bytes on its one device), so DTensor never refuses an op for a
    split that is not there."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for dim, axis in enumerate(spec):
        for a in ((axis,) if isinstance(axis, str) else axis or ()):
            if a not in names:
                raise ValueError(f"spec {spec}: no axis {a!r} in {names}")
            if mesh.shape[names.index(a)] > 1:
                out[names.index(a)] = Shard(dim)
    return tuple(out)


def dp_axes(mesh) -> Axis:
    """Data-parallel axes: ('pod','data') on the multi-pod mesh."""
    axes = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return axes if len(axes) > 1 else axes[0]


class ShardingCtx:
    """Activation-sharding hook threaded through model forward functions.

    ``None`` ctx (smoke tests, single device) makes every constraint a no-op,
    and so does a tensor that is not a DTensor.  On a DTensor a constraint
    redistributes it to the spec's placements (the reference's
    ``with_sharding_constraint``).
    """

    def __init__(self, mesh, mode: str, cfg: ModelConfig,
                 sequence_parallel: bool = True):
        self.mesh = mesh
        self.mode = mode  # train | prefill | decode
        self.cfg = cfg
        self.dp = dp_axes(mesh)
        self.sp = sequence_parallel and mode == "train"
        msize = mesh_shape(mesh)[MODEL_AXIS]
        self.kv_head_sharded = cfg.num_kv_heads % msize == 0
        # §Perf: seq-sharded (ring-style) prefill attention when head counts
        # don't divide the TP axis (avoids multi-GB score psums)
        self.seq_shard = (cfg.seq_shard_attn and mode == "prefill"
                          and cfg.num_heads % msize != 0)

    @property
    def msize(self) -> int:
        return mesh_shape(self.mesh)[MODEL_AXIS]

    def _c(self, x, spec: Spec):
        if not isinstance(x, DTensor):
            return x
        want = placements(spec, self.mesh)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    # ---- residual stream (B, S, D) ----
    def residual(self, h):
        if self.sp:
            return self._c(h, P(self.dp, MODEL_AXIS, None))
        return self._c(h, P(self.dp, None, None))

    # ---- attention internals ----
    def heads(self, x):  # (B, S, H, hd)
        msize = self.msize
        if (self.mode == "decode" and not self.kv_head_sharded) or \
                x.shape[2] % msize != 0:
            if x.shape[3] % msize == 0:
                return self._c(x, P(self.dp, None, None, MODEL_AXIS))
            return self._c(x, P(self.dp, None, None, None))
        return self._c(x, P(self.dp, None, MODEL_AXIS, None))

    def ffn(self, x):  # (B, S, F)
        return self._c(x, P(self.dp, None, MODEL_AXIS))

    def scores(self, x):  # (B, H, G, C, S) attention scores/probs
        msize = self.msize
        if self.seq_shard and x.shape[-1] % msize == 0:
            return self._c(x, P(self.dp, None, None, None, MODEL_AXIS))
        h = MODEL_AXIS if x.shape[1] % msize == 0 else None
        return self._c(x, P(self.dp, h, None, None, None))

    def kv_seq(self, x):  # (B, S, KVH, hd) keys/values, seq-sharded path
        if self.seq_shard and x.shape[1] % self.msize == 0:
            return self._c(x, P(self.dp, MODEL_AXIS, None, None))
        return x

    def q_rep(self, x):  # query chunk, replicate inner dims (seq-shard path)
        if self.seq_shard:
            return self._c(x, P(self.dp, None, None, None, None))
        return x

    def logits(self, x):  # (B, S, V) or (B, V)
        v = MODEL_AXIS if x.shape[-1] % self.msize == 0 else None
        if x.dim() == 3:
            return self._c(x, P(self.dp, None, v))
        return self._c(x, P(self.dp, v))


def constrain(shd: Optional[ShardingCtx], kind: str, x):
    if shd is None:
        return x
    return getattr(shd, kind)(x)


# ---------------------------------------------------------------------------
# Param specs.  ``mode``: "train" -> FSDP(data) x TP(model); "serve" -> TP.
# ---------------------------------------------------------------------------


def _fsdp(mode, mesh):
    return "data" if (mode == "train"
                      and "data" in mesh.mesh_dim_names) else None


def dense_layer_specs(cfg: ModelConfig, mesh, mode: str) -> dict:
    f = _fsdp(mode, mesh)
    m = MODEL_AXIS
    kv_hd = None
    kv_h = m
    if mode != "train" and cfg.num_kv_heads % mesh_shape(mesh)[m] != 0:
        kv_h, kv_hd = None, m  # head_dim-sharded KV path
    specs = {
        "ln1": P(None, None),
        "ln2": P(None, None),
        "wq": P(None, f, m, None) if kv_hd is None else P(None, f, None, m),
        "wk": P(None, f, kv_h, kv_hd),
        "wv": P(None, f, kv_h, kv_hd),
        "wo": P(None, m, None, f) if kv_hd is None else P(None, None, m, f),
        "w_gate": P(None, f, m),
        "w_up": P(None, f, m),
        "w_down": P(None, m, f),
    }
    if cfg.qkv_bias:
        specs["bq"] = P(None, m, None) if kv_hd is None else P(None, None, m)
        specs["bk"] = P(None, kv_h, kv_hd)
        specs["bv"] = P(None, kv_h, kv_hd)
    return specs


def moe_layer_specs(cfg: ModelConfig, mesh, mode: str) -> dict:
    """``moe_impl="ep"`` is a sharding rule only: experts over `model`; the
    compute stays the dense expert scan in both packages."""
    specs = dense_layer_specs(cfg, mesh, mode)
    f = _fsdp(mode, mesh)
    m = MODEL_AXIS
    for k in ("w_gate", "w_up", "w_down"):
        del specs[k]
    if cfg.moe_impl == "ep":
        # expert-parallel: experts over `model`
        specs.update({
            "router": P(None, None, None),
            "e_gate": P(None, m, f, None),
            "e_up": P(None, m, f, None),
            "e_down": P(None, m, None, f),
        })
    else:
        specs.update({
            "router": P(None, None, None),
            "e_gate": P(None, None, f, m),
            "e_up": P(None, None, f, m),
            "e_down": P(None, None, m, f),
        })
    return specs


def mamba_layer_specs(cfg: ModelConfig, mesh, mode: str) -> dict:
    f = _fsdp(mode, mesh)
    m = MODEL_AXIS
    return {
        "ln": P(None, None),
        "w_in": P(None, f, m),       # (L, D, 2*d_inner + 2N + H)
        "conv_w": P(None, None, m),  # (L, width, d_inner + 2N)
        "conv_b": P(None, m),
        "A_log": P(None, m),         # (L, H_m)
        "dt_bias": P(None, m),
        "D_skip": P(None, m),
        "w_out": P(None, m, f),      # (L, d_inner, D)
        "ln_gate": P(None, m),
    }


def embed_specs(cfg: ModelConfig, mesh, mode: str) -> dict:
    f = _fsdp(mode, mesh)
    return {
        "embed": P(MODEL_AXIS, f),
        "final_ln": P(None),
        "lm_head": P(f, MODEL_AXIS),
    }


def batch_pspec(mesh) -> Spec:
    return P(dp_axes(mesh), None)


def cache_pspec(cfg: ModelConfig, mesh) -> Spec:
    """(L, B, S, KVH, hd)"""
    if cfg.num_kv_heads % mesh_shape(mesh)[MODEL_AXIS] == 0:
        return P(None, "data", None, MODEL_AXIS, None)
    return P(None, "data", None, None, MODEL_AXIS)


# ---------------------------------------------------------------------------
# local shards: the port's kernels (ctypes, plain tensors only) and the
# in-place cache writes run on each device's shard of a DTensor
# ---------------------------------------------------------------------------


def replicate_partial(x):
    """``x`` with any pending reduction (``Partial``) done: a DTensor whose
    placements are all ``Shard`` or ``Replicate``."""
    if not isinstance(x, DTensor):
        return x
    pl = tuple(p if isinstance(p, (Shard, Replicate)) else Replicate()
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def project(placement: tuple, dims: dict) -> tuple:
    """Placements for another tensor: ``Shard(d)`` becomes ``Shard(dims[d])``
    where the other tensor has that dim, else ``Replicate()``."""
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in placement)


def local_as(x, placement: tuple, mesh):
    """This device's shard of ``x`` under ``placement``: a DTensor is
    redistributed (a no-op where it already is so placed), a plain tensor
    is taken as the full value on every device."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) != tuple(placement):
        x = x.redistribute(mesh, placement)
    return x.to_local()


def sharded_dims(placement: tuple, mesh) -> dict:
    """{tensor dim: number of shards} of ``placement`` on ``mesh``."""
    out = {}
    for size, p in zip(mesh.shape, placement):
        if isinstance(p, Shard):
            out[p.dim] = out.get(p.dim, 1) * size
    return out


def pointwise(fn, x):
    """``fn`` (elementwise) of ``x``; on a DTensor, of each device's shard
    (for an op DTensor has no rule for, such as ``logsigmoid``'s
    backward), differentiable through the shards."""
    if not isinstance(x, DTensor):
        return fn(x)
    x = replicate_partial(x)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False)



def _view_groups(a, b):
    """The (input dims, output dims) groups of a reshape from ``a`` to
    ``b``: each group's sizes multiply to the same number."""
    groups, i, j = [], 0, 0
    while i < len(a) or j < len(b):
        I, O = [i] if i < len(a) else [], [j] if j < len(b) else []
        pa, pb = (a[i] if I else 1), (b[j] if O else 1)
        i, j = i + len(I), j + len(O)
        while pa != pb:
            if pa < pb:
                pa, i = pa * a[i], i + 1
                I.append(i - 1)
            else:
                pb, j = pb * b[j], j + 1
                O.append(j - 1)
        groups.append((I, O))
    return groups


def _reshapable(x, shape):
    """``x`` with every sharded dim that the reshape would merge behind
    another dim, or split unevenly, gathered first: DTensor keeps a shard
    only on the leading dim of a group, split evenly."""
    split = sharded_dims(x.placements, x.device_mesh)
    gather = set()
    for I, O in _view_groups(tuple(x.shape), tuple(shape)):
        if len(I) == 1 and len(O) == 1:
            continue
        for d in I:
            if d in split and (d != I[0] or not O or shape[O[0]] % split[d]):
                gather.add(d)
    if not gather:
        return x
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in gather else p
               for p in x.placements)
    return x.redistribute(x.device_mesh, pl)


def _contiguous(x):
    """A DTensor whose local shard is contiguous (``DTensor.contiguous``
    looks at the global strides and may leave a strided shard, which a
    view then refuses)."""
    local = x.to_local()
    if local.is_contiguous():
        return x
    return DTensor.from_local(local.contiguous(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _contiguous(_reshapable(x, shape)).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return (_contiguous(_reshapable(g, ctx.in_shape))
                .reshape(ctx.in_shape), None)


def reshape(x, *shape):
    """``x.reshape(shape)``; on a DTensor, the dims DTensor cannot carry
    through the reshape are gathered first (``_reshapable``), in forward
    and in backward."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    shape = list(shape[0] if len(shape) == 1 and isinstance(
        shape[0], (tuple, list)) else shape)
    if -1 in shape:
        k = shape.index(-1)
        rest = 1
        for n in shape[:k] + shape[k + 1:]:
            rest *= n
        shape[k] = x.numel() // rest
    return _Reshape.apply(x, tuple(shape))


def linear(x, w):
    """``x (..., K) @ w (K, N)``.  A DTensor ``x`` of more than two dims is
    folded to (rows, K) first by ``reshape``, as matmul folds a plain
    tensor: a sharded dim other than the leading one (the sequence of the
    sequence-parallel residual) is gathered, as the reference's GSPMD
    gathers it before the product, where DTensor's own fold would refuse."""
    if not isinstance(x, DTensor) or x.dim() <= 2:
        return x @ w
    return reshape(reshape(x, -1, x.shape[-1]) @ w, *x.shape[:-1],
                   w.shape[-1])


def head_shards(q, *others, head_dim: int = 2):
    """The placements q and ``others`` are computed under on each device's
    shard, and their local shards: q's own placements (any pending
    reduction done), which may split the batch (dim 0) and the heads
    (``head_dim``) and nothing else; the heads only where every tensor's
    head count divides, so each device's query heads are the GQA groups of
    its KV heads.  Raises ``NotImplementedError`` for any other
    placement."""
    q = replicate_partial(q)
    pl, mesh = q.placements, q.device_mesh
    split = sharded_dims(pl, mesh)
    if set(split) - {0, head_dim} or any(
            t.shape[head_dim] % split.get(head_dim, 1) for t in (q,) + others):
        raise NotImplementedError(
            f"placements {pl} of shapes "
            f"{[tuple(t.shape) for t in (q,) + others]}: only shards of the "
            "batch and of whole GQA groups are computed on local shards")
    return pl, mesh, [local_as(t, pl, mesh) for t in (q,) + others]


def on_head_shards(fn, q, *others, head_dim: int = 2):
    """``fn(q, *others)`` for attention that splits over the batch and the
    heads: on DTensors placed so (``head_shards``), computed on each
    device's shards (no communication, as GSPMD computes it) and returned
    as a DTensor of q's placements; ``None`` for DTensors placed
    otherwise, which the caller computes on the DTensors."""
    try:
        pl, mesh, local = head_shards(q, *others, head_dim=head_dim)
    except NotImplementedError:
        return None
    return DTensor.from_local(fn(*local), mesh, pl, run_check=False)


def along(fn, x, dim: int):
    """``fn(x)`` for an op along ``dim`` alone that keeps x's shape (a
    cumulative sum); a DTensor is computed on its shards, gathered on
    ``dim`` first if split there (DTensor has no rule for some such ops'
    backward, e.g. cumsum's ``flip``)."""
    if not isinstance(x, DTensor):
        return fn(x)
    x = replicate_partial(x)
    dim = dim % x.dim()
    if dim in sharded_dims(x.placements, x.device_mesh):
        x = x.redistribute(x.device_mesh, tuple(
            Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in x.placements))
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False)


def batch_only(x):
    """A DTensor with every split but the batch's (dim 0) gathered, any
    pending reduction done; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def on_batch_shards(fn, batched, shared=()):
    """``fn(*batched, *shared)`` for a computation independent across the
    batch (a recurrence over time): on DTensors, computed on each device's
    rows of ``batched`` (each split over its dim 0 alone, other splits
    gathered) with ``shared`` whole, and every output tensor (batch-major)
    returned as a DTensor split the same way.  Its many small steps then
    run as plain tensor ops, not DTensor dispatches."""
    ref = next((x for x in batched if isinstance(x, DTensor)), None)
    if ref is None:
        return fn(*batched, *shared)
    mesh = ref.device_mesh
    pl = tuple(batch_only(ref).placements)
    whole = (Replicate(),) * mesh.ndim
    out = fn(*(local_as(x, pl, mesh) for x in batched),
             *(local_as(x, whole, mesh) for x in shared))

    def wrap(t):
        if isinstance(t, (tuple, list)):
            return type(t)(wrap(u) for u in t)
        return DTensor.from_local(t, mesh, pl, run_check=False)

    return wrap(out)
