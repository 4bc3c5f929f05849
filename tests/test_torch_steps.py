"""The port's cell builder (``repro_torch.launch.steps.build_cell``) run for
real on a (1, 1) CPU mesh, and ``Checkpointer.restore(shardings=...)``.

The port's counterpart of ``tests/test_system.py::test_dryrun_cell_on_tiny_mesh``:
the reduced TinyLlama's train, prefill and decode cells run in fp32 on
DTensors over a one-rank ``gloo`` group (set up by a module fixture and
torn down after it) and are held

- against the port's Model API on the same inputs, bitwise (a (1, 1) mesh
  moves nothing, and every op is the one the Model API runs);
- against the reference's ``build_cell``, jitted with its in/out shardings
  on an Auto-axis (1, 1) mesh in a JAX subprocess (fp32), at 2e-5.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeConfig, get_reduced_config
from repro_torch.launch import mesh as MESH
from repro_torch.launch import shardings as SH
from repro_torch.launch.steps import build_cell, place
from repro_torch.models.model import build_model, params_from_numpy
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.tree import tree_flatten_with_paths, tree_leaves, tree_map
from test_torch_model_api import jax_fp32_pickle

ARCH = "tinyllama-1.1b"
B, S = 2, 32
TOL = 2e-5
PROMPT_LENS = [S - 4, S - 9]

_JAX_CELLS = r'''
import pickle
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import ShapeConfig, get_reduced_config
from repro.launch.steps import build_cell
from repro.models.model import build_model
from repro.training.optimizer import adamw_init

B, S = {B}, {S}
cfg = get_reduced_config({arch!r})
mesh = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
params = build_model(cfg).init(jax.random.PRNGKey(0))
rng = np.random.default_rng(7)
tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
labels[:, -3:] = -1

def run(kind, *args):
    fn, _, in_sh, out_sh, donate = build_cell(cfg, ShapeConfig("c", S, B, kind),
                                              mesh)
    with mesh:
        return jax.device_get(jax.jit(fn, in_shardings=in_sh,
                                      out_shardings=out_sh)(*args))

out = {{"params": jax.device_get(params), "tokens": tokens, "labels": labels}}
p2, opt2, loss = run("train", params, adamw_init(params),
                     {{"tokens": tokens, "labels": labels}})
out["train"] = (p2, loss)
plens = np.array({plens!r}, np.int32)
logits, cache, kv_len = run("prefill", params,
                            {{"tokens": tokens, "prompt_lens": plens}})
out["prefill"] = (logits, cache)
nxt = np.argmax(logits, -1).astype(np.int32)[:, None]
out["decode"] = run("decode", params, cache,
                    {{"tokens": nxt, "kv_len": plens}})
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
'''


@pytest.fixture(scope="module")
def ref():
    return jax_fp32_pickle(_JAX_CELLS, B=B, S=S, arch=ARCH,
                           plens=PROMPT_LENS)


@pytest.fixture(scope="module")
def mesh():
    torch.set_num_threads(2)
    MESH.init_local_process_group("gloo")
    try:
        yield MESH.make_local_mesh()
    finally:
        dist.destroy_process_group()


class _Box:
    def __init__(self, pl):
        self.pl = pl


def _t(x):
    return torch.from_numpy(np.array(x))


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _cell(cfg, kind, mesh):
    return build_cell(cfg, ShapeConfig("c", S, B, kind), mesh,
                      compute_dtype=torch.float32)


def _close(got, want, what):
    got = _full(got).detach().numpy()
    want = np.asarray(want, np.float32)
    err = float(np.max(np.abs(got - want) / (np.abs(want) + 1.0)))
    assert err <= TOL, (what, err)


def test_local_mesh_is_one_by_one(mesh):
    assert mesh.shape == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")


def test_train_cell(ref, mesh):
    """Two things: the cell's step is bitwise the Model API's
    ``make_train_step``, and its loss and params are the reference cell's."""
    cfg = get_reduced_config(ARCH)
    model = build_model(cfg, compute_dtype=torch.float32)
    params = params_from_numpy(cfg, ref["params"], "cpu")
    batch = {"tokens": _t(ref["tokens"]), "labels": _t(ref["labels"])}
    opt = adamw_init(params)
    fn, structs, in_pl, out_pl, donate = _cell(cfg, "train", mesh)
    assert donate == (0, 1)
    assert [tuple(x.shape) for x in tree_leaves(structs[0])] == \
        [tuple(x.shape) for x in tree_leaves(params)]
    new_p, new_opt, loss = fn(*(place(x, pl, mesh) for x, pl in
                                zip((params, opt, batch), in_pl)))
    want_p, want_opt, met = make_train_step(model, TrainConfig())(
        params, opt, batch)
    assert torch.equal(_full(loss), met["loss"])
    for got, want in zip(tree_leaves(new_p) + tree_leaves(new_opt),
                         tree_leaves(want_p) + tree_leaves(want_opt)):
        assert torch.equal(_full(got), want)
    jp, jloss = ref["train"]
    _close(loss, jloss, "loss")
    _, paths = tree_flatten_with_paths(jp)
    for path, got, want in zip(paths, tree_leaves(new_p), tree_leaves(jp)):
        _close(got, want, path)


def test_prefill_and_decode_cells(ref, mesh):
    """The prefill cell's logits and cache, then one decode step's logits
    and cache from it: bitwise the Model API's, and the reference cells'
    within 2e-5."""
    cfg = get_reduced_config(ARCH)
    model = build_model(cfg, compute_dtype=torch.float32)
    params = params_from_numpy(cfg, ref["params"], "cpu")
    plens = torch.tensor(PROMPT_LENS, dtype=torch.int32)
    batch = {"tokens": _t(ref["tokens"]), "prompt_lens": plens}
    fn, _, in_pl, out_pl, donate = _cell(cfg, "prefill", mesh)
    assert donate == ()
    logits, cache, kv_len = fn(*(place(x, pl, mesh) for x, pl in
                                 zip((params, batch), in_pl)))
    want_logits, want_cache, _ = model.prefill(params, batch)
    assert torch.equal(_full(logits), want_logits)
    assert torch.equal(_full(kv_len), plens)
    for got, want in zip(tree_leaves(cache), tree_leaves(want_cache)):
        assert torch.equal(_full(got), want)
    jlogits, jcache = ref["prefill"]
    _close(logits, jlogits, "prefill logits")
    for got, want in zip(tree_leaves(cache), tree_leaves(jcache)):
        _close(got, want, "prefill cache")

    nxt = torch.argmax(want_logits, -1).to(torch.int32)[:, None]
    step = {"tokens": nxt, "kv_len": plens}
    fn, _, in_pl, _, donate = _cell(cfg, "decode", mesh)
    assert donate == (1,)
    placed = [place(x, pl, mesh) for x, pl in
              zip((params, tree_map(torch.clone, want_cache), step), in_pl)]
    logits, new_cache = fn(*placed)
    # the donated cache, written in place
    assert all(a is b for a, b in zip(tree_leaves(new_cache),
                                      tree_leaves(placed[1])))
    want_logits, want_cache = model.decode_step(params, want_cache, step)
    assert torch.equal(_full(logits), want_logits)
    for got, want in zip(tree_leaves(new_cache), tree_leaves(want_cache)):
        assert torch.equal(_full(got), want)
    jlogits, jcache = ref["decode"]
    _close(logits, jlogits, "decode logits")
    for got, want in zip(tree_leaves(new_cache), tree_leaves(jcache)):
        _close(got, want, "decode cache")


def test_restore_onto_mesh_round_trips(mesh, tmp_path):
    """A tree of DTensors saves whole (the same files as its full tensors
    save), and ``restore(shardings=...)`` puts each leaf back on the mesh
    with its placements, bitwise."""
    cfg = get_reduced_config(ARCH)
    model = build_model(cfg, compute_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(3))
    state = {"params": params, "opt": adamw_init(params)}
    fn, _, in_pl, _, _ = _cell(cfg, "train", mesh)
    placements = {"params": in_pl[0], "opt": in_pl[1]}
    placed = place(state, placements, mesh)
    a, b = Checkpointer(str(tmp_path / "dt")), Checkpointer(str(tmp_path / "pl"))
    a.save(5, placed, blocking=True)
    b.save(5, state, blocking=True)
    for f in sorted((tmp_path / "pl" / "step_00000005").iterdir()):
        assert f.read_bytes() == (tmp_path / "dt" / "step_00000005" /
                                  f.name).read_bytes(), f.name
    back = a.restore(state, shardings=placements, mesh=mesh)
    got, want = tree_leaves(back), tree_leaves(state)
    pls = [b.pl for b in tree_leaves(SH.zip_map(lambda _, pl: _Box(pl),
                                                 state, placements))]
    assert len(got) == len(want) == len(pls)
    for g, w, pl in zip(got, want, pls):
        assert isinstance(g, DTensor) and tuple(g.placements) == tuple(pl)
        assert torch.equal(g.full_tensor(), w)
    with pytest.raises(ValueError):
        a.restore(state, shardings=placements)
