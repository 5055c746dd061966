"""What the benchmark's files import, by whole top-level names: nothing
under portbench/ imports JAX or the JAX package `contexture_nerf_tpu` (whose
name the port's begins with), and the frozen reference imports nothing of
the port."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "contexture_nerf_tpu"}
PORT = "contexture_nerf_tpu_torch"


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def sources(root: Path):
    return sorted(p for p in root.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_jax_anywhere_in_the_benchmark():
    found = {str(p.relative_to(BENCH)): sorted(top_level_imports(p) & JAX_SIDE)
             for p in sources(BENCH)}
    assert not {k: v for k, v in found.items() if v}


def test_reference_imports_nothing_of_the_port():
    found = {str(p.relative_to(BENCH)): PORT in top_level_imports(p)
             for p in sources(BENCH / "reference")}
    assert found and not [k for k, v in found.items() if v]


def test_names_are_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import contexture_nerf_tpu_torch.ops\nimport jax.numpy\n"
                 "from contexture_nerf_tpu.core import config\n")
    names = top_level_imports(p)
    assert names & JAX_SIDE == {"jax", "contexture_nerf_tpu"}
    assert PORT in names
