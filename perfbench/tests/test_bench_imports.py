"""Nothing the benchmark runs imports JAX or the JAX package: the imports
of every file under ``perfbench/`` and of every ``instruct_tpu_torch``
module they reach, read from the source (an interpreter whose site
customization imports ``jax`` at start-up makes ``sys.modules`` useless).  Each
import's top-level name is compared whole: ``instruct_tpu_torch`` passes,
``instruct_tpu`` does not.  The plain reference imports nothing of the
port."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "instruct_tpu"}


def imported(path: Path):
    """Module names imported anywhere in ``path`` (relative imports
    resolved against its package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    pkg = path.relative_to(ROOT).with_suffix("").parts[:-1]
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                head = pkg[:len(pkg) - node.level + 1]
                base = ".".join([*head, base] if base else head)
            out.append(base)
            out.extend(f"{base}.{a.name}" for a in node.names)
    return out


def module_file(name: str):
    parts = name.split(".")
    for cand in (ROOT.joinpath(*parts).with_suffix(".py"),
                 ROOT.joinpath(*parts, "__init__.py")):
        if cand.is_file():
            return cand
    return None


def reached(start):
    """Files reached from ``start`` through imports of the repo's own
    modules (the packages' ``__init__`` along each name included)."""
    seen, todo = set(), list(start)
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in imported(f):
            parts = name.split(".")
            for i in range(1, len(parts) + 1):
                m = module_file(".".join(parts[:i]))
                if m is not None and m not in seen:
                    todo.append(m)
    return seen


def test_top_level_names_compared_whole():
    assert "instruct_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "instruct_tpu.mcmc".split(".")[0] in FORBIDDEN


def test_no_jax_anywhere_the_benchmark_reaches():
    files = reached(sorted(BENCH.rglob("*.py")))
    assert any("instruct_tpu_torch" in str(f) for f in files)
    bad = []
    for f in files:
        for name in imported(f):
            if name.split(".")[0] in FORBIDDEN:
                bad.append((str(f.relative_to(ROOT)), name))
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (BENCH / "reference").rglob("*.py"))
    + ["perfbench/check.py"])
def test_reference_imports_nothing_of_the_port(path):
    files = reached([ROOT / path])
    names = {n.split(".")[0] for f in files for n in imported(f)}
    assert not names & (FORBIDDEN | {"instruct_tpu_torch"}), names
