"""Nothing under cfl_bench/ imports jax, jaxlib, flax or the JAX package
`repro` (top-level names compared whole: `repro_torch` is not `repro`),
and nothing the plain reference runs imports the port."""
import ast
from pathlib import Path

import pytest

from cfl_bench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(spec.BENCH.rglob("*.py"))


def imported(path: Path) -> set[str]:
    """Full names of the modules `path` imports (relative imports are
    resolved inside cfl_bench)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                pkg = path.relative_to(spec.ROOT).with_suffix("").parts
                base = ".".join(pkg[:len(pkg) - node.level]
                                + ((base,) if base else ()))
            names.add(base)
            names |= {f"{base}.{a.name}" for a in node.names}
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(spec.BENCH)))
def test_no_jax_or_jax_package(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert not tops & FORBIDDEN


def _module_path(name: str) -> Path | None:
    rel = Path(*name.split("."))
    for cand in (spec.ROOT / rel.with_suffix(".py"),
                 spec.ROOT / rel / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def test_reference_imports_nothing_of_the_port():
    todo = sorted((spec.BENCH / "reference").glob("*.py"))
    seen: set[Path] = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imported(path):
            assert name.split(".")[0] != "repro_torch", (path, name)
            if name.split(".")[0] == "cfl_bench":
                found = _module_path(name)
                if found is not None:
                    todo.append(found)
    assert spec.BENCH / "traffic.py" in seen
