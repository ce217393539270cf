"""The port stands alone: no ``repro_torch`` module imports JAX or the JAX
package, and its entry points run on the card unless the caller asks for
the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

PKG = Path(repro_torch.__file__).resolve().parent


def _modules():
    """Every module of the port; a package's ``__main__`` runs a program
    when imported, and is left out."""
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)],
                                                        prefix="repro_torch.")
                  if not m.name.endswith(".__main__"))


def test_importing_every_module_loads_neither_jax_nor_repro():
    names = _modules()
    for name in ("core.verify_engine", "core.adsplus", "kernels.ops",
                 "kernels.ref", "kernels._build", "launch.serve",
                 "core.recommender", "core.autotune", "core.gateway",
                 "core.distributed", "models.transformer", "models.weights",
                 "configs", "train.optimizer", "train.checkpoint",
                 "train.compression", "data.pipeline", "launch.train",
                 "launch.dryrun", "launch.specs", "launch.mesh",
                 "launch.hlo_analysis", "models.shardctx", "analysis",
                 "analysis.base", "analysis.cli", "analysis.checkers",
                 "analysis.lock_discipline", "analysis.snapshot_immutability",
                 "analysis.precision", "analysis.trace_safety",
                 "analysis.sanitize"):
        assert f"repro_torch.{name}" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == ""


def test_no_source_imports_jax_or_repro():
    found = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "ml_dtypes"):
                    found.append(f"{path.relative_to(PKG)}:{node.lineno} {name}")
    assert found == []


def _imported(node):
    """The module names an import statement reads, relative ones as
    written (``from . import execute`` gives ``.execute``)."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    base = "." * node.level + (node.module or "")
    return [base] + [f"{base}.{a.name}" if node.module else base + a.name
                     for a in node.names]


def test_verify_engine_imports_nothing_of_the_executor():
    """Imports point one way: the executor uses the engine, the engine the
    host screens; the engine imports nothing of the executor, and the
    executor imports the engine at module top, not inside a function."""
    engine = ast.parse((PKG / "core" / "verify_engine.py").read_text())
    found = [name for node in ast.walk(engine)
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for name in _imported(node)
             if name.split(".")[-1] == "execute"]
    assert found == []
    executor = ast.parse((PKG / "core" / "execute.py").read_text())
    top = [name for node in executor.body
           if isinstance(node, (ast.Import, ast.ImportFrom))
           for name in _imported(node)]
    assert ".verify_engine" in top
    nested = [name for fn in ast.walk(executor)
              if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
              for node in ast.walk(fn)
              if isinstance(node, (ast.Import, ast.ImportFrom))
              for name in _imported(node)
              if name.split(".")[-1] == "verify_engine"]
    assert nested == []


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default resolves")


def test_entry_points_default_to_cuda_and_raise_without_a_card(no_card):
    from repro_torch.core import (
        CLSM, ADSConfig, ADSIndex, CLSMConfig, CTree, CTreeConfig, RawStore,
        StreamConfig, StreamingIndex, VerifyEngine, get_engine)
    from repro_torch.launch import serve, train

    for make in (VerifyEngine, get_engine, lambda: RawStore(16),
                 lambda: CTree(CTreeConfig()), lambda: CLSM(CLSMConfig()),
                 lambda: StreamingIndex(StreamConfig()),
                 lambda: ADSIndex(ADSConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert StreamConfig().device == "cuda"
    for argv in (["--batches", "1"], ["--gateway", "--batches", "1"],
                 ["--mode", "lm"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])
    # asked for explicitly, the CPU runs the plain versions
    assert VerifyEngine(device="cpu").device.type == "cpu"
    assert StreamingIndex(StreamConfig(device="cpu")).raw.device.type == "cpu"


def test_only_cpu_tensors_run_the_plain_versions(no_card):
    """Dispatch is by tensor device: a CPU tensor runs the plain version, and
    no other device does (there is no silent fallback path)."""
    from repro_torch.kernels import ops

    q = torch.zeros((2, 8))
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        ops.screen_select(q.to("meta"), x, torch.zeros(4, device="meta"), 2)
    with pytest.raises(ValueError):
        ops.topk_ed(q.to("meta"), x, 2)
    with pytest.raises(ValueError):
        ops.topk_ed(q, x, 2)  # tensors on two devices
    from repro_torch.core import SummarizationConfig

    cfg = SummarizationConfig(series_len=8, n_segments=4, card_bits=4)
    for fn, a in ((ops.paa, x), (ops.sax_and_keys, torch.zeros((4, 4), device="meta"))):
        with pytest.raises(ValueError):
            fn(a, cfg)
    with pytest.raises(ValueError):
        ops.min_ed(q.to("meta"), x)
    with pytest.raises(ValueError):
        ops.mindist(torch.zeros(4, device="meta"), x[:, :4], x[:, :4], cfg)


def test_every_kernel_source_is_built():
    """Each CUDA source under csrc/ goes into the library, and each kernel
    wrapper has a launch count."""
    from repro_torch.kernels import _build, ops

    assert sorted(p.name for p in _build.SOURCES) == sorted(
        p.name for p in (PKG / "kernels" / "csrc").glob("*.cu"))
    assert set(ops.LAUNCHES) == {"screen_select", "screen_select_quant",
                                 "topk_ed", "paa", "sax_pack", "min_ed", "mindist"}


def test_the_lm_path_runs_no_library_attention_or_compiler():
    """The model stack, the trainer and its optimizer compute what the
    reference computes, with plain torch ops: no fused attention of a
    library, no ``torch.compile``, no ``torch.optim`` optimizer."""
    found = []
    paths = [*(PKG / "models").glob("*.py"), *(PKG / "train").glob("*.py"),
             PKG / "launch" / "train.py", PKG / "data" / "pipeline.py"]
    for path in sorted(paths):
        text = path.read_text()
        for name in ("scaled_dot_product_attention", "torch.compile", "flash_attn",
                     "xformers", "torch.optim", "from torch import optim"):
            if name in text:
                found.append(f"{path.name}: {name}")
    assert found == []
