"""Specs and placements for every (arch x shape x mesh) cell — the port of
``repro.launch.shardings``.

Param specs are rule-based on leaf names (we control every param name in
``repro_torch.models``); stacked leading dims get ``None`` prepended
automatically.  The functions walk the port's ``meta`` trees
(``Model.param_shapes``, ``batch_specs``, ``cache_specs``) and return a
tree of the same structure with a ``models.sharding.Spec`` at each leaf; a
leaf's name is the last dict key on its path (``repro_torch.tree``).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.sharding import P, Spec, mesh_shape, placements

M = "model"

_REPLICATED_NAMES = {
    "final_ln", "enc_final_ln", "ln", "ln1", "ln2", "ln_x", "ln_concat",
    "ln_cell", "ln_out", "b_gates", "b_i", "b_f", "step",
}


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, keeping
    its structure; ``path`` is the tuple of keys and indices to the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def zip_map(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over ``tree`` and the spec tree of its structure."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, v, s) for v, s in zip(tree, spec_tree))
    return fn(tree, spec_tree)


def _leaf_name(path) -> str:
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return ""


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= shape[a]
        return n
    return shape[axis]


def _fit(core, shape, mesh):
    """Drop axes that do not divide the corresponding dim (the reference's
    jit in_shardings require exact divisibility; DTensor would allow uneven
    shards, but the specs stay the reference's)."""
    out = list(core)
    for i, ax in enumerate(out):
        if ax is not None and shape[i] % _axis_size(mesh, ax) != 0:
            out[i] = None
    return out


def leaf_spec(name: str, shape, cfg: ModelConfig, mesh, mode: str) -> Spec:
    """Core spec by param name; leading stacked dims padded with None;
    non-divisible axes dropped (with head->head_dim fallback for attention)."""
    ndim = len(shape)
    fsdp_modes = ("train", "decode") if cfg.decode_2d_params else ("train",)
    f = "data" if (mode in fsdp_modes
                   and "data" in mesh.mesh_dim_names) else None
    msize = mesh_shape(mesh)[M]
    hd_mode = mode == "decode" and cfg.num_kv_heads % msize != 0

    def finish(core):
        pad = ndim - len(core)
        if pad < 0:
            core = core[-ndim:]
            pad = 0
        core = [None] * pad + list(core)
        return P(*_fit(core, shape, mesh))

    if name in _REPLICATED_NAMES or name.startswith("ln"):
        return P(*([None] * ndim))

    table = {
        "embed": [M, f],
        "lm_head": [f, M],
        "w_gate": [f, M], "w_up": [f, M], "ffn_gate": [f, M], "ffn_up": [f, M],
        "w_down": [M, f], "ffn_down": [M, f],
        "router": [f, None],
        "w_in": [f, M],
        "conv_w": [None, M],
        "conv_b": [M], "A_log": [M], "dt_bias": [M], "D_skip": [M],
        "ln_gate": [M],
        "w_out": [M, f],
        "w_concat": [f, None],
        "w_i": [f, None], "w_f": [f, None],
        "w_gates": [f, None, None, M],
        "r_gates": [None, None, M, None],
    }
    if cfg.moe_impl == "ep":
        table.update({"e_gate": [M, f, None], "e_up": [M, f, None],
                      "e_down": [M, None, f]})
    else:
        table.update({"e_gate": [None, f, M], "e_up": [None, f, M],
                      "e_down": [None, M, f]})

    qkv = {"wq", "wk", "wv", "xwq", "xwk", "xwv"}
    if name in qkv:
        if ndim >= 3:  # (..., D, H, hd)
            heads = shape[-2]
            if hd_mode or heads % msize != 0:
                core = [f, None, M]  # head_dim-sharded fallback
            else:
                core = [f, M, None]
        else:
            core = [f, M]  # xlstm 2-D projections
        return finish(core)
    if name in ("wo", "xwo"):
        heads = shape[-3] if ndim >= 3 else 0
        if ndim >= 3 and (hd_mode or heads % msize != 0):
            core = [None, M, f]
        else:
            core = [M, None, f]
        return finish(core)
    if name in ("bq", "bk", "bv"):
        heads = shape[-2]
        core = [None, M] if (hd_mode or heads % msize != 0) else [M, None]
        return finish(core)
    if name in table:
        return finish(table[name])
    # default: replicate
    return P(*([None] * ndim))


def param_specs(params_shapes, cfg: ModelConfig, mesh, mode: str):
    def spec(path, leaf):
        return leaf_spec(_leaf_name(path), tuple(leaf.shape), cfg, mesh, mode)

    return map_with_path(spec, params_shapes)


def _dp(mesh, B: int):
    """Joint DP axes over which B divides; falls back data-only, then None."""
    names = mesh.mesh_dim_names
    shape = mesh_shape(mesh)
    axes = tuple(a for a in ("pod", "data") if a in names)
    size = 1
    for a in axes:
        size *= shape[a]
    if B % size == 0:
        return axes if len(axes) > 1 else axes[0]
    if "data" in names and B % shape["data"] == 0:
        return "data"
    return None


def batch_specs(batch_shapes, cfg: ModelConfig, mesh, shape: ShapeConfig):
    def spec(path, leaf):
        db = _dp(mesh, leaf.shape[0]) if leaf.dim() >= 1 else None
        return P(*([db] + [None] * (leaf.dim() - 1)))

    return map_with_path(spec, batch_shapes)


def cache_specs_tree(cache_shapes, cfg: ModelConfig, mesh, shape: ShapeConfig):
    """Decode-cache shardings (DESIGN.md §5): batch over data; kv_head over
    model when divisible else head_dim over model; SSM/recurrent states shard
    their largest model-divisible inner dim."""
    msize = mesh_shape(mesh)[M]
    B = shape.global_batch
    db = _dp(mesh, B)
    kv_on_heads = cfg.num_kv_heads % msize == 0

    def spec(path, leaf):
        name = _leaf_name(path)
        nd = leaf.dim()
        if name in ("k", "v", "xk", "xv"):
            # (L, B, S, KVH, hd)
            if kv_on_heads:
                return P(None, db, None, M, None)
            return P(None, db, None, None, M)
        if name in ("k_scale", "v_scale"):
            if kv_on_heads:
                return P(None, db, None, M, None)
            return P(None, db, None, None, None)
        if name == "conv":  # (n_super, every, B, W-1, C)
            return P(None, None, db, None, M)
        if name == "ssm":  # (n_super, every, B, H, P, N)
            return P(None, None, db, M, None, None)
        # xlstm recurrent states: tuples -> no dict names; shard batch +
        # first inner dim divisible by model axis
        spec_list = [db] + [None] * (nd - 1)
        for i in range(2, nd):  # skip batch and head dims
            if leaf.shape[i] % msize == 0 and leaf.shape[i] >= msize:
                spec_list[i] = M
                break
        return P(*spec_list)

    return map_with_path(spec, cache_shapes)


def named_tree(mesh, spec_tree):
    """The DTensor placements of each spec (the reference's
    ``NamedSharding`` tree)."""
    return map_with_path(lambda _, s: placements(s, mesh), spec_tree)
