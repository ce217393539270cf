"""Nothing the benchmark runs imports JAX or the JAX package, top-level
module names compared whole (the port's name begins with the JAX
package's), and nothing reads the JAX package's benchmark folder."""
import ast
import os
import subprocess
import sys
from pathlib import Path

from palmbench import harness

ROOT = Path(__file__).resolve().parents[2]
SOURCES = [p for p in (ROOT / "palmbench").rglob("*.py") if "tests" not in p.parts]


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"repro_torch": 1, "repro_torch.core": 1,
                                         "reprox": 1, "numpy": 1})
    assert harness._forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"repro.core": 1, "jaxlib.xla": 1,
                                         "flax": 1, "repro_torch": 1})
    assert harness._forbidden_modules() == ["flax", "jaxlib", "repro"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in SOURCES:
        text = path.read_text()
        assert "benchmarks/" not in text and '"benchmarks"' not in text, path
        for node in ast.walk(ast.parse(text, str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_importing_every_harness_module_loads_neither():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from palmbench import harness\n"
        "for p in sorted(Path(harness.HERE, 'drivers').glob('*.py')):\n"
        "    harness.driver(p.stem)\n"
        "for p in sorted(Path(harness.HERE, 'metrics').glob('[a-z]*.py')):\n"
        "    harness.metric(p.name[:-3])\n"
        "import repro_torch.core, repro_torch.kernels.ops\n"
        "print(','.join(harness._forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == ""
