"""The port's sharding rules (``repro_torch.models.sharding``,
``repro_torch.launch.shardings``, ``repro_torch.launch.mesh``) against the
JAX reference's.

The reference side runs in one subprocess on a forced 512-device CPU host:
for every registered config it builds the param, batch and cache
``PartitionSpec`` trees of each kind (train, prefill, decode) on the
(16, 16) mesh, and on the (2, 16, 16) mesh for one config per family; and
it records the spec that ``ShardingCtx._c`` receives for each activation
kind, mode and shape.  The port builds the same trees on ``DeviceMesh``es
of the same shapes under torch's ``fake`` process group (set up and torn
down inside each test), and each spec must equal the reference's leaf for
leaf.
"""
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.launch import mesh as MESH
from repro_torch.launch import shardings as SH
from repro_torch.models import layers as L
from repro_torch.models import sharding as SHD
from repro_torch.models.model import build_model
from repro_torch.tree import tree_flatten_with_paths
from test_torch_model_api import jax_fp32_pickle

KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
# one config per family for the multi-pod mesh
MULTI = ("tinyllama-1.1b", "mixtral-8x22b", "zamba2-2.7b", "xlstm-125m",
         "seamless-m4t-medium")
ACT_KINDS = ("residual", "heads", "ffn", "scores", "kv_seq", "q_rep",
             "logits")

_JAX_SPECS = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import pickle
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import SHAPES, get_config, list_configs
from repro.launch import shardings as SH
from repro.models import sharding as SHD
from repro.models.model import build_model

KINDS = {kinds!r}
MULTI = {multi!r}
ACT_KINDS = {act_kinds!r}
devs = np.array(jax.devices())
meshes = {{
    "single": Mesh(devs[:256].reshape(16, 16), ("data", "model")),
    "multi": Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model")),
}}

def flat(tree):
    pairs, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [(str(p), tuple(s)) for p, s in pairs]

out = {{"configs": list_configs(), "trees": {{}}, "acts": {{}}}}
for mesh_kind, mesh in meshes.items():
    for name in list_configs():
        if mesh_kind == "multi" and name not in MULTI:
            continue
        cfg = get_config(name)
        model = build_model(cfg)
        pshapes = model.param_shapes()
        for kind, shape_name in KINDS.items():
            shape = SHAPES[shape_name]
            key = (mesh_kind, name, kind)
            out["trees"][key + ("params",)] = flat(
                SH.param_specs(pshapes, cfg, mesh, kind))
            out["trees"][key + ("batch",)] = flat(
                SH.batch_specs(model.batch_specs(shape), cfg, mesh, shape))
            if kind != "train":
                out["trees"][key + ("cache",)] = flat(SH.cache_specs_tree(
                    model.cache_specs(shape), cfg, mesh, shape))

rec = []
SHD.ShardingCtx._c = lambda self, x, spec: (rec.append(tuple(spec)), x)[1]
mesh = meshes["single"]
for name in list_configs():
    for seq_shard in (False, True):
        cfg = get_config(name).replace(seq_shard_attn=seq_shard)
        for mode in ("train", "prefill", "decode"):
            shd = SHD.ShardingCtx(mesh, mode, cfg)
            for kind, shapes in {act_shapes}(cfg).items():
                for shp in shapes:
                    rec.clear()
                    getattr(shd, kind)(jax.ShapeDtypeStruct(shp, np.float32))
                    out["acts"][(name, seq_shard, mode, kind, shp)] = list(rec)
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
'''


def act_shapes(cfg):
    """Representative activation shapes of each kind for ``cfg``: its own
    head counts and widths (some divide the 16-wide model axis, some do
    not), at the dry-run's batch and sequence."""
    B, S, C = 256, 4096, 512
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G = max(H // KVH, 1)
    return {
        "residual": [(B, S, cfg.d_model)],
        "heads": [(B, S, H, hd), (B, S, KVH, hd), (B, 1, H, hd),
                  (B, S, 12, 24)],
        "ffn": [(B, S, cfg.d_ff)],
        "scores": [(B, KVH, G, C, S), (B, H, 1, C, S), (B, 6, 2, C, 4000)],
        "kv_seq": [(B, S, KVH, hd), (B, 4000, KVH, hd)],
        "q_rep": [(B, C, KVH, G, hd)],
        "logits": [(B, S, cfg.vocab_size), (B, cfg.vocab_size),
                   (B, 50_001)],
    }


@pytest.fixture(scope="module")
def ref():
    import inspect

    src = inspect.getsource(act_shapes).replace("{", "{{").replace("}", "}}")
    script = _JAX_SPECS.replace("{act_shapes}", "act_shapes").replace(
        "\nrec = []", "\n" + src + "\nrec = []", 1)
    return jax_fp32_pickle(script, kinds=KINDS, multi=MULTI,
                           act_kinds=ACT_KINDS)


class fake_mesh:
    """A production ``DeviceMesh`` under a ``fake`` default group of its
    size, torn down on exit."""

    def __init__(self, multi: bool):
        self.multi = multi

    def __enter__(self):
        MESH.init_fake_process_group(
            MESH.production_world_size(multi_pod=self.multi))
        return MESH.make_production_mesh(multi_pod=self.multi)

    def __exit__(self, *exc):
        dist.destroy_process_group()


class _Box:
    def __init__(self, spec):
        self.spec = spec


def flat_specs(meta_tree, spec_tree):
    """(path, spec) pairs in JAX's flatten order, paths as JAX prints
    them."""
    boxed = SH.zip_map(lambda _, s: _Box(s), meta_tree, spec_tree)
    leaves, paths = tree_flatten_with_paths(boxed)
    return [(p, tuple(b.spec)) for p, b in zip(paths, leaves)]


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


def port_trees(mesh, mesh_kind, names):
    out = {}
    for name in names:
        cfg = get_config(name)
        model = build_model(cfg)
        pshapes = model.param_shapes()
        for kind, shape_name in KINDS.items():
            shape = SHAPES[shape_name]
            key = (mesh_kind, name, kind)
            out[key + ("params",)] = flat_specs(
                pshapes, SH.param_specs(pshapes, cfg, mesh, kind))
            bshapes = model.batch_specs(shape)
            out[key + ("batch",)] = flat_specs(
                bshapes, SH.batch_specs(bshapes, cfg, mesh, shape))
            if kind != "train":
                cshapes = model.cache_specs(shape)
                out[key + ("cache",)] = flat_specs(
                    cshapes, SH.cache_specs_tree(cshapes, cfg, mesh, shape))
    return out


def _compare_trees(got: dict, want: dict, mesh_kind: str):
    keys = [k for k in want if k[0] == mesh_kind]
    assert sorted(k for k in got) == sorted(keys)
    n = 0
    for key in keys:
        g, w = got[key], want[key]
        assert [p for p, _ in g] == [p for p, _ in w], key
        for (path, gs), (_, ws) in zip(g, w):
            width = max(len(gs), len(ws))
            assert _pad(gs, width) == _pad(ws, width), (key, path, gs, ws)
            n += 1
    return n


def test_registered_configs_match(ref):
    assert list_configs() == ref["configs"]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_spec_trees_match_reference(ref, mesh_kind):
    """Param, batch and cache specs of every registered config x {train,
    prefill, decode} on (16, 16) (one config per family on (2, 16, 16))
    equal the reference's ``PartitionSpec`` trees leaf for leaf."""
    names = list_configs() if mesh_kind == "single" else MULTI
    with fake_mesh(mesh_kind == "multi") as mesh:
        got = port_trees(mesh, mesh_kind, names)
    n = _compare_trees(got, ref["trees"], mesh_kind)
    assert n > (800 if mesh_kind == "single" else 300)


def test_activation_specs_match_reference(ref):
    """Each ``ShardingCtx`` kind, in each mode, with and without the
    sequence-sharded prefill, hands ``_c`` the reference's spec (or, where
    the reference leaves the tensor as it is, nothing)."""
    rec = []

    class Recording(SHD.ShardingCtx):
        def _c(self, x, spec):
            rec.append(tuple(spec))
            return x

    seen = set()
    with fake_mesh(False) as mesh:
        for name in list_configs():
            for seq_shard in (False, True):
                cfg = get_config(name).replace(seq_shard_attn=seq_shard)
                for mode in ("train", "prefill", "decode"):
                    shd = Recording(mesh, mode, cfg)
                    for kind, shapes in act_shapes(cfg).items():
                        for shp in shapes:
                            rec.clear()
                            getattr(shd, kind)(torch.empty(shp,
                                                           device="meta"))
                            key = (name, seq_shard, mode, kind, shp)
                            assert rec == ref["acts"][key], key
                            seen.add(key)
    assert seen == set(ref["acts"])


@pytest.mark.parametrize("spec", [
    (None, None), ("data", None), (("pod", "data"), None, "model"),
    (None, "model", "data"), ("model",),
])
def test_placements_of_specs(spec):
    """A spec becomes one placement per mesh dim (a dim over two axes: two
    ``Shard`` of it, in mesh order); on an axis of size 1, ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    with fake_mesh(True) as mesh:
        pl = SHD.placements(SHD.P(*spec), mesh)
        assert len(pl) == 3
        for name, p in zip(mesh.mesh_dim_names, pl):
            dims = [i for i, a in enumerate(spec)
                    if a == name or (isinstance(a, tuple) and name in a)]
            assert p == (Shard(dims[0]) if dims else Replicate())
    MESH.init_local_process_group("gloo")
    try:
        one = MESH.make_local_mesh()  # (1, 1): nothing is split
        assert SHD.placements(SHD.P(*[a for a in spec if a != "pod"
                                      and not isinstance(a, tuple)]),
                              one) == (Replicate(), Replicate())
    finally:
        dist.destroy_process_group()


def test_constrain_is_identity_off_dtensor():
    """``constrain`` with no context, or on a plain tensor, returns the
    tensor itself (the reference's ``None`` context)."""
    x = torch.randn(4, 8, 16)
    assert SHD.constrain(None, "residual", x) is x
    with fake_mesh(False) as mesh:
        shd = SHD.ShardingCtx(mesh, "train", get_config("tinyllama-1.1b"))
        for kind in ("residual", "ffn", "logits"):
            assert SHD.constrain(shd, kind, x) is x


_REF_KV = r'''
import pickle
from repro.models.layers import kv_replication_factor
grid = {grid!r}
with open({out!r}, "wb") as f:
    pickle.dump({{g: kv_replication_factor(*g) for g in grid}}, f)
'''


def test_kv_replication_factor_matches_reference():
    grid = [(h, kvh, m) for h in (1, 4, 8, 12, 14, 16, 28, 32, 40, 48, 64)
            for kvh in (1, 2, 4, 7, 8, 16) if h % kvh == 0
            for m in (1, 2, 4, 8, 16, 32)]
    want = jax_fp32_pickle(_REF_KV, grid=grid)
    got = {g: L.kv_replication_factor(*g) for g in grid}
    assert got == want
    assert all(r >= 1 and (g[0] // g[1]) % r == 0 for g, r in got.items())


def test_mesh_shapes():
    """The production meshes' shapes and names, and the constants the
    roofline divides by (the H100's, from ``serving.cluster``)."""
    from repro_torch.serving import cluster

    with fake_mesh(False) as mesh:
        assert SHD.mesh_shape(mesh) == {"data": 16, "model": 16}
    with fake_mesh(True) as mesh:
        assert SHD.mesh_shape(mesh) == {"pod": 2, "data": 16, "model": 16}
    assert MESH.PEAK_FLOPS == cluster.PEAK_FLOPS == 989e12
    assert MESH.HBM_BW == cluster.HBM_BW
    assert MESH.INTRA_SERVER_BW == cluster.INTRA_SERVER_BW
    assert math.prod(MESH.SINGLE_POD[0]) == 256
    assert not np.isnan(MESH.INTER_SERVER_BW)
