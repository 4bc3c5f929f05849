"""Import hygiene of the PyTorch port: it never imports JAX nor anything of
the JAX package ``repro``, and its kernels build for Hopper (sm_90a)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


# names the port keeps beside the JAX package's, module by module
PORTED_NAMES = {
    "repro_torch.core.prng": ("PRNGKey", "split", "random_bits", "normal"),
    "repro_torch.core.equivalence": ("vocab_probability_similarity",
                                     "param_equivalence",
                                     "layerwise_vocab_probs",
                                     "cross_size_equivalence"),
    "repro_torch.core.stitching": ("_hidden_at_layer", "apply_stitch",
                                   "make_stitch_block",
                                   "stitched_head_similarity",
                                   "train_stitching_block"),
    "repro_torch.core.zoo": ("BlockZoo", "ProfileRecord"),
    "repro_torch.core.blocks": ("block_prefill", "block_decode",
                                "apply_block", "run_chain"),
    "repro_torch.configs.base": ("ShapeConfig", "SHAPES", "ModelConfig",
                                 "get_config", "get_reduced_config",
                                 "list_configs", "applicable_shapes"),
    "repro_torch.models.layers": (
        "decode_attention", "quantize_kv", "dequantize_kv", "init_kv_cache",
        "cache_insert", "finalize_prefill_cache", "cache_kv_arrays",
        "cache_insert_layer", "cache_layer_arrays", "swiglu", "gelu_mlp",
        "kv_replication_factor"),
    "repro_torch.models.sharding": (
        "MODEL_AXIS", "dp_axes", "ShardingCtx", "constrain",
        "dense_layer_specs", "moe_layer_specs", "mamba_layer_specs",
        "embed_specs", "batch_pspec", "cache_pspec"),
    "repro_torch.launch.mesh": ("make_production_mesh", "make_local_mesh"),
    "repro_torch.launch.shardings": ("leaf_spec", "param_specs", "_dp",
                                     "batch_specs", "cache_specs_tree",
                                     "named_tree"),
    "repro_torch.launch.steps": ("build_cell",),
    "repro_torch.launch.hlo_analysis": ("DeviceCost",),
    "repro_torch.launch.dryrun": ("ARCHS", "input_specs", "run_cell",
                                  "cell_list", "main"),
    "repro_torch.launch.roofline": ("load_records", "terms", "table",
                                    "pick_hillclimb_cells", "main"),
    "repro_torch.models.transformer": (
        "init_dense", "dense_prefill", "dense_decode_step",
        "init_cache_shape", "_embed_tokens", "_positions", "_qkv",
        "_attn_layer_full", "_dense_layer_fwd", "cross_entropy",
        "dense_train_loss"),
    "repro_torch.models.model": ("Model", "build_model",
                                 "params_from_numpy", "cache_from_numpy"),
    "repro_torch.models.moe": ("init_moe_layer", "init_moe",
                               "router_weights", "_moe_mlp",
                               "_moe_layer_fwd", "moe_prefill",
                               "moe_decode_step", "moe_train_loss"),
    "repro_torch.models.moe_dispatch": ("moe_dispatch_mlp",
                                        "dropped_fraction"),
    "repro_torch.models.mamba2": ("mamba_dims", "init_mamba_layer",
                                  "init_zamba", "_conv1d_causal", "ssd_scan",
                                  "mamba_forward", "shared_attn_block",
                                  "_zamba_trunk", "zamba_prefill",
                                  "zamba_decode_step", "zamba_train_loss"),
    "repro_torch.models.xlstm": ("_dims", "init_mlstm_block",
                                 "init_slstm_block", "init_xlstm",
                                 "_mlstm_parallel", "_mlstm_step",
                                 "mlstm_block", "mlstm_final_state",
                                 "_slstm_scan", "slstm_block", "_trunk",
                                 "xlstm_prefill", "xlstm_decode_step",
                                 "xlstm_train_loss"),
    "repro_torch.models.encdec": ("init_enc_layer", "init_dec_layer",
                                  "init_encdec", "bidir_attention", "_mlp",
                                  "encode", "_dec_layer_full",
                                  "encdec_prefill", "encdec_decode_step",
                                  "encdec_train_loss"),
    "repro_torch.examples.quickstart": ("main",),
    "repro_torch.core.peft": ("shared_param_fraction",),
    "repro_torch.serving.request": ("Request", "generate_trace",
                                    "as_serve_requests"),
    "repro_torch.serving.cluster": ("Cluster", "Device", "paper_cluster"),
    "repro_torch.serving.cost_model": (
        "BlockCost", "kv_cache_bytes", "t_revisit_owner", "t_move_with_kv",
        "t_recalc", "best_kv_strategy", "estimate_latency",
        "preempt_readmit_strategy"),
    "repro_torch.serving.simulator": ("build_serving_config",
                                      "SchedulerConfig", "Simulation"),
    "repro_torch.serving.engine": ("adaptive_serving_similarity",),
    "repro_torch.launch.serve": ("run_sim", "run_real", "main"),
    "repro_torch.examples.serve_multitenant": ("main",),
    "repro_torch.data.pipeline": ("DataConfig", "TokenPipeline"),
    "repro_torch.training.optimizer": ("AdamWConfig", "adamw_init",
                                       "global_norm", "adamw_update"),
    "repro_torch.training.train_loop": ("TrainConfig", "_compress",
                                        "make_train_step", "train"),
    "repro_torch.checkpoint": ("Checkpointer", "install_preemption_hook"),
    "repro_torch.checkpoint.checkpointer": ("Checkpointer",
                                            "install_preemption_hook"),
    "repro_torch.launch.train": ("main",),
    "repro_torch.examples.train_and_partition": ("main",),
}


@pytest.mark.parametrize("module", sorted(PORTED_NAMES))
def test_ported_module_has_its_names(module):
    import importlib

    mod = importlib.import_module(module)
    for name in PORTED_NAMES[module]:
        assert hasattr(mod, name), f"{module}.{name}"
    assert module in _modules()  # so the import checks above cover it


def test_every_family_has_a_train_loss():
    """No module of the port raises ``NotImplementedError`` for training:
    ``build_model`` wires a train loss for every family."""
    from repro_torch.configs import get_config, list_configs
    from repro_torch.models import model

    assert not hasattr(model, "TRAINING_ITEM")
    families = set()
    for name in list_configs():
        m = model.build_model(get_config(name))
        assert callable(m._fns["train_loss"]), name
        families.add(get_config(name).family)
    assert families == {"dense", "moe", "hybrid", "ssm", "encdec"}
    for path in sorted(PKG.rglob("*.py")):
        assert "training is not ported" not in path.read_text(), path


def test_zoo_has_equivalent_blocks():
    from repro_torch.core.zoo import BlockZoo

    assert callable(BlockZoo.equivalent_blocks)


def test_zoo_has_stitches_and_profiler():
    from repro_torch.core.blocks import Block
    from repro_torch.core.zoo import BlockZoo

    assert callable(BlockZoo.add_stitch) and callable(BlockZoo.profile_block)
    assert isinstance(Block.bytes, property)


def test_every_reference_config_module_has_its_copy():
    """The port registers every config of ``src/repro/configs`` (read as
    files: the port may not import the JAX package)."""
    ref = sorted(p.name for p in (ROOT / "src" / "repro" / "configs")
                 .glob("*.py") if p.name not in ("__init__.py", "base.py"))
    mine = sorted(p.name for p in (PKG / "configs").glob("*.py")
                  if p.name not in ("__init__.py", "base.py"))
    assert mine == ref and len(ref) == 11


KERNEL_MODULES = ("paged_attention", "flash_attention", "batched_lora")


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_kernel_build_targets_sm90a(name):
    import importlib

    from repro_torch.kernels import _build

    kernel = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
    cmd = _build.nvcc_command(kernel.SOURCE, Path("/tmp/x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and str(kernel.SOURCE) in cmd
    assert kernel.SOURCE.parent.name == "csrc"
    src = kernel.SOURCE.read_text()
    assert 'extern "C"' in src and "__global__" in src
    # the source note names the TPU kernel it replaces
    assert f"src/repro/kernels/{name}/kernel.py" in src
    assert kernel.library_path().parent == _build.BUILD_DIR
    assert kernel.library_path().name.startswith(f"lib{name}-")
    assert _build.BUILD_DIR.name == "_build"
    gitignore = (ROOT / ".gitignore").read_text().split()
    assert "src/repro_torch/_build/" in gitignore


def test_kernel_library_name_follows_included_headers(tmp_path):
    """A library is named by its source and the local headers the source
    includes, so editing the shared header rebuilds every kernel."""
    from repro_torch.kernels import _build

    (tmp_path / "common").mkdir()
    (tmp_path / "k" / "csrc").mkdir(parents=True)
    header = tmp_path / "common" / "sm90.cuh"
    src = tmp_path / "k" / "csrc" / "k.cu"
    header.write_text("// v1\n")
    src.write_text('#include <cuda_runtime.h>\n#include "../../common/sm90.cuh"\n')
    assert _build._sources(src) == [src, src.parent / "../../common/sm90.cuh"]
    before = _build.library_path(src)
    header.write_text("// v2\n")
    assert _build.library_path(src) != before
    assert _build.library_path(src).name.startswith("libk-")


def test_paged_attention_kernel_keeps_its_names():
    from repro_torch.kernels.paged_attention import kernel

    for name in ("load", "library_path", "launches", "paged_attention_cuda",
                 "SOURCE"):
        assert hasattr(kernel, name), name


def test_importing_the_port_builds_and_loads_nothing():
    """Every module imports on a machine without nvcc; no library is built
    or loaded, and no compiler is started."""
    code = (
        "import importlib, subprocess\n"
        "started = []\n"
        "real = subprocess.Popen\n"
        "subprocess.Popen = lambda *a, **k: started.append(a) or real(*a, **k)\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._loaded, _build._loaded\n"
        "assert not started, started\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_calls_no_library_attention(path):
    """The port never reaches for SDPA, cuDNN or torch.compile (cuDNN is
    touched only to turn TF32 off)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        name = _dotted(node)
        assert not name.endswith("scaled_dot_product_attention"), name
        assert name != "torch.compile", name
        if ".cudnn." in name + ".":
            assert name in ("torch.backends.cudnn",
                            "torch.backends.cudnn.allow_tf32"), name
