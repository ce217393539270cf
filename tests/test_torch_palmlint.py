"""The port's palmlint (``repro_torch.analysis``): each port rule against
its good and bad fixtures (``tests/torch_palmlint_fixtures/``), the copied
rules against the reference's own fixtures and findings, the port's tree
clean with its suppressions visible, the CLI, and every class name the
rules and the sanitizer key on found in ``src/repro_torch/``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import build_project as ref_build_project
from repro.analysis import run_project as ref_run_project
from repro_torch.analysis import (
    CHECKERS, RULES, build_project, collect_files, lint_source, run_project,
)
from repro_torch.analysis import lock_discipline, snapshot_immutability
from repro_torch.analysis.cli import main as palmlint_main

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_palmlint_fixtures"
REF_FIXTURES = REPO / "tests" / "palmlint_fixtures"
PORT = REPO / "src" / "repro_torch"


def lint_fixture(path, select=None):
    project, errors = build_project([path], root=REPO)
    assert not errors, errors
    return run_project(project, select)


def as_tuples(findings):
    return [(f.rule, f.line) for f in findings]


def test_all_six_rules_registered():
    assert set(CHECKERS) == {
        "lock-discipline", "snapshot-immutability", "trace-safety",
        "precision-discipline", "collective-divergence", "tf32",
    }
    for name in CHECKERS:
        assert RULES[name]


# --------------------------------------------- the copied rules, unchanged
@pytest.mark.parametrize("name", [
    "lock_bad.py", "lock_good.py", "snapshot_bad.py", "snapshot_good.py",
    "snapshot_decisions_bad.py", "snapshot_decisions_good.py", "escape_hatch.py",
])
def test_copied_rules_match_the_reference_on_its_fixtures(name):
    """lock-discipline and snapshot-immutability are copies: on the
    reference's own fixtures they give its findings, live and suppressed."""
    select = ["lock-discipline", "snapshot-immutability"]
    live, quiet = lint_fixture(REF_FIXTURES / name, select)
    project, _ = ref_build_project([REF_FIXTURES / name], root=REPO)
    ref_live, ref_quiet = ref_run_project(project, select)
    assert [(f.path, f.line, f.col, f.rule, f.message) for f in live + quiet] == \
        [(f.path, f.line, f.col, f.rule, f.message) for f in ref_live + ref_quiet]
    if name.endswith("_bad.py"):
        assert live


# ---------------------------------------------------- collective-divergence
def test_collective_bad_fixture_exact_findings():
    live, _ = lint_fixture(FIXTURES / "collective_bad.py")
    assert as_tuples(live) == [
        ("collective-divergence", 8),   # only rank 0 all-gathers
        ("collective-divergence", 14),  # returns early on a file's existence
        ("collective-divergence", 22),  # loop trip count from .item()
        ("collective-divergence", 31),  # continue before the next gather
        ("collective-divergence", 37),  # assert on .item() before a reduce
    ]
    assert "only some ranks call it" in live[0].message
    assert "leaves early" in live[1].message


def test_collective_good_fixture_is_clean():
    live, suppressed = lint_fixture(FIXTURES / "collective_good.py")
    assert live == [] and suppressed == []


def test_collective_reached_through_the_call_graph():
    src = (
        "import torch.distributed as dist\n"
        "def inner(t):\n"
        "    dist.barrier()\n"
        "def outer(t):\n"
        "    if t.item():\n"
        "        return t\n"
        "    inner(t)\n"
    )
    assert as_tuples(lint_source(src)) == [("collective-divergence", 5)]
    # torch.gather is not a collective, nor a project function of that name
    src2 = (
        "import torch\n"
        "def gather(w):\n"
        "    return w.redistribute(w.device_mesh, w.placements)\n"
        "def pick(x, i):\n"
        "    if x.any():\n"
        "        return x\n"
        "    return torch.gather(x, 0, i)\n"
    )
    assert lint_source(src2) == []


# ----------------------------------------------------------- trace-safety
def test_launch_bad_fixture_exact_findings():
    live, _ = lint_fixture(FIXTURES / "kernels" / "launch_bad.py")
    assert as_tuples(live) == [
        ("trace-safety", 13),  # instance lock in _launch_screen
        ("trace-safety", 19),  # host RNG in a LAUNCHES-counting wrapper
        ("trace-safety", 26),  # host RNG one call away
    ]
    assert "reachable from launch wrapper `screen`" in live[-1].message


def test_launch_good_fixture_is_clean():
    live, suppressed = lint_fixture(FIXTURES / "kernels" / "launch_good.py")
    assert live == [] and suppressed == []


# ------------------------------------------------------ precision-discipline
def test_precision_bad_fixture_exact_findings():
    live, _ = lint_fixture(FIXTURES / "core" / "precision_bad.py")
    assert as_tuples(live) == [
        ("precision-discipline", 6),   # dtype-less torch.zeros
        ("precision-discipline", 7),   # dtype-less torch.arange
        ("precision-discipline", 8),   # dtype-less torch.full
        ("precision-discipline", 14),  # .double() operand in a screen matmul
        ("precision-discipline", 18),  # certify-path einsum without f64
        ("precision-discipline", 23),  # torch.bfloat16 rows into certify
        ("precision-discipline", 27),  # .to(dtype=dt) in a quant helper
    ]
    assert "bf16/int8 operand" in live[5].message
    assert "dtype-less cast in a quantization helper" in live[6].message


def test_precision_good_fixture_is_clean():
    live, suppressed = lint_fixture(FIXTURES / "core" / "precision_good.py")
    assert live == [] and suppressed == []


def test_precision_dtype_rule_is_path_scoped():
    src = "import torch\n\ndef f(n):\n    return torch.zeros((n,))\n"
    assert lint_source(src, path="tools/helper.py") == []
    for path in ("src/repro_torch/core/x.py", "src/repro_torch/kernels/x.py"):
        assert [f.rule for f in lint_source(src, path=path)] == ["precision-discipline"]


# --------------------------------------------------------------------- tf32
def test_tf32_bad_fixture_exact_findings():
    live, _ = lint_fixture(FIXTURES / "core" / "tf32_bad.py")
    assert as_tuples(live) == [("tf32", 6), ("tf32", 7), ("tf32", 8)]


def test_tf32_good_fixture_is_clean():
    live, suppressed = lint_fixture(FIXTURES / "core" / "tf32_good.py")
    assert live == [] and suppressed == []


def test_tf32_rule_covers_core_kernels_and_launch_only():
    src = "import torch\ntorch.backends.cuda.matmul.allow_tf32 = True\n"
    for path in ("src/repro_torch/core/x.py", "src/repro_torch/kernels/x.py",
                 "src/repro_torch/launch/x.py"):
        assert [f.rule for f in lint_source(src, path=path)] == ["tf32"]
    assert lint_source(src, path="scripts/bench.py") == []


# ------------------------------------------------------------ escape hatch
def test_escape_hatch_is_rule_specific():
    src = (
        "import torch.distributed as dist\n"
        "def f(t):\n"
        "    if dist.get_rank():  # palmlint: ignore[tf32]\n"
        "        dist.barrier()\n"
        "def g(t):\n"
        "    if dist.get_rank():  # palmlint: ignore[collective-divergence]\n"
        "        dist.barrier()\n"
    )
    assert as_tuples(lint_source(src)) == [("collective-divergence", 3)]


# --------------------------------------------------------------- clean tree
def test_port_tree_is_clean_with_suppressions_visible():
    files = collect_files([str(PORT)])
    assert len(files) > 60
    project, errors = build_project(files, root=REPO)
    assert not errors
    live, suppressed = run_project(project)
    assert live == [], "\n".join(f.render() for f in live)
    assert {f.rule for f in suppressed} == {"precision-discipline", "lock-discipline"}


def test_every_checked_class_name_is_defined_in_the_port():
    """A rename in the port must not drop a check silently."""
    defined = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.ClassDef):
                defined.add(node.name)
    protected = {"RunSet", "QueryPlan", "SourceOps", "Recommendation",
                 "TierDecision", "RationaleEntry", "DecisionRecord", "Knobs",
                 "WorkloadKey", "GatewayStats"}
    assert all(snapshot_immutability._is_protected_type(n) for n in protected)
    sealed = {"SortedRun", "QueryPlan", "SourceOps", "DenseSource", "BlockSource",
              "RangeSource", "GroupSource", "RunSet", "RunRegistry", "VerifyEngine"}
    wanted = (set(lock_discipline.GUARDED_CLASSES) | protected
              | set(snapshot_immutability.MUST_BE_FROZEN) | sealed)
    assert wanted - defined == set()


# ---------------------------------------------------------------------- CLI
def test_cli_exit_codes_and_list_rules(capsys):
    assert palmlint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in CHECKERS:
        assert rule in out
    assert palmlint_main([str(FIXTURES / "collective_good.py")]) == 0
    assert palmlint_main([str(FIXTURES / "collective_bad.py")]) == 1
    assert palmlint_main([str(FIXTURES / "collective_bad.py"),
                          "--select", "tf32"]) == 0
    assert palmlint_main([str(FIXTURES / "collective_bad.py"),
                          "--select", "no-such-rule"]) == 2
    assert palmlint_main([str(FIXTURES / "no_such_dir")]) == 2
    capsys.readouterr()


def test_github_format_and_suppressed_listing(capsys):
    assert palmlint_main([str(FIXTURES / "core" / "tf32_bad.py"), "--format", "github"]) == 1
    out = capsys.readouterr().out
    assert "::error file=tests/torch_palmlint_fixtures/core/tf32_bad.py" in out
    assert palmlint_main([str(PORT), "--show-suppressed"]) == 0
    out = capsys.readouterr().out
    assert "suppressed: src/repro_torch/core/" in out


def test_module_entry_point_runs_without_torch_or_numpy(tmp_path):
    """``python -m repro_torch.analysis`` stays stdlib-only: with torch and
    numpy poisoned it lints the port's tree and exits 0."""
    poison = "raise ImportError('palmlint must stay stdlib-only')\n"
    for name in ("numpy.py", "torch.py"):
        (tmp_path / name).write_text(poison)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(REPO / "src")]))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "src/repro_torch"],
                          capture_output=True, text=True, env=env, cwd=str(REPO),
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stderr


def test_sanitize_env_arms_at_core_import():
    code = ("import sys, repro_torch.core\n"
            "from repro_torch.analysis import sanitize\n"
            "print(sanitize.installed())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    for value, want in (("1", "True"), ("0", "False")):
        env["REPRO_SANITIZE"] = value
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, env=env, check=True, timeout=120)
        assert out.stdout.strip() == want
