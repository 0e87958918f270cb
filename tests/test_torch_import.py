"""The PyTorch port imports without JAX and without the JAX package: the
machine with the card has no JAX, so chip_smoke.py depends on this."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sdslam_tpu_torch"

_BLOCKED = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["sdslam_tpu"] = None   # likewise for the JAX package
import importlib
for name in {mods!r}:
    importlib.import_module(name)
print("ok")
"""


def _sources():
    """The package's .py files (not the build directory's contents)."""
    return [p for p in sorted(PKG.rglob("*.py")) if "_build" not in p.relative_to(PKG).parts]


def _module_names():
    names = []
    for p in _sources():
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


@pytest.mark.parametrize(
    "mods",
    [["sdslam_tpu_torch", "sdslam_tpu_torch.pipeline.tracking"], _module_names()],
    ids=["tracking", "every_module"],
)
def test_imports_with_jax_blocked(mods):
    code = _BLOCKED.format(mods=mods)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_module_names_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b|sdslam_tpu\.", re.M)
    offenders = []
    for p in _sources():
        text = p.read_text()
        text = text.replace("sdslam_tpu_torch", "")
        for m in pat.finditer(text):
            line = text[: m.start()].count("\n") + 1
            offenders.append(f"{p.relative_to(ROOT)}:{line}")
    assert not offenders, offenders


def test_chip_smoke_imports_no_jax():
    text = (ROOT / "chip_smoke.py").read_text().replace("sdslam_tpu_torch", "")
    assert not re.search(r"^\s*(import|from)\s+(jax|sdslam_tpu)\b", text, re.M)
