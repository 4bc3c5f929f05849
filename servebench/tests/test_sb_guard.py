"""Nothing the benchmark runs loads JAX or the JAX package: every module
of the harness imported in a fresh process, then sys.modules compared by
whole top-level names (the port's name begins with the JAX package's)."""
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

SCRIPT = r"""
import importlib, importlib.util, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
spec = importlib.util.spec_from_file_location("sb_run", root / "servebench" / "run.py")
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
spec = importlib.util.spec_from_file_location("sb_knee", root / "servebench" / "knee.py")
knee = importlib.util.module_from_spec(spec); spec.loader.exec_module(knee)
from servebench import harness
for sub in ("drivers", "reference", "traffic"):
    for f in sorted((root / "servebench" / sub).glob("*.py")):
        importlib.import_module(f"servebench.{sub}.{f.stem}")
for f in sorted((root / "servebench" / "metrics").glob("*.py")):
    if not f.stem.startswith("_"):
        harness.load_reader(f.stem)
import servebench.check, servebench.counts, servebench.trace, servebench.window
print(sorted({m.split(".")[0] for m in sys.modules}))
print("FORBIDDEN", harness.forbidden_modules())
"""


def test_no_jax_or_jax_package_is_loaded():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    tops = eval(out.splitlines()[-2])
    assert "repro_torch" in tops and "servebench" in tops
    for bad in ("jax", "jaxlib", "flax", "repro"):
        assert bad not in tops
    assert out.splitlines()[-1] == "FORBIDDEN []"


def test_forbidden_compares_whole_names(monkeypatch):
    from servebench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtools", sys)
    assert "repro_torch_like" not in harness.forbidden_modules()
    assert "jaxtools" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.x", sys)
    assert "repro.x" in harness.forbidden_modules()
