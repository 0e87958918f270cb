"""No file of the benchmark imports JAX or the JAX package (top-level
module names compared whole: `sdslam_tpu_torch` is not `sdslam_tpu`), and
the reference side imports nothing of the program."""

import ast
from pathlib import Path

from perf_bench import harness

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "sdslam_tpu"}
# the yardstick: truth, reference, generator, statistics, counting
REFERENCE = ("scene.py", "orb_ref.py", "traffic.py", "stats.py", "check.py", "roofline.py",
             "trace.py", "manifest.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not top_level_imports(f) & BANNED, f


def test_the_reference_imports_nothing_of_the_program():
    for name in REFERENCE:
        assert "sdslam_tpu_torch" not in top_level_imports(BENCH / name), name


def test_the_top_level_check_compares_whole_names():
    assert harness.no_jax_loaded(["sdslam_tpu_torch", "sdslam_tpu_torch.system", "torch"]) == []
    assert harness.no_jax_loaded(["jax.numpy", "sdslam_tpu.system", "jaxlib"]) == [
        "jax", "jaxlib", "sdslam_tpu"]
    assert top_level_imports.__name__  # the AST walk sees `import a.b` as `a`
