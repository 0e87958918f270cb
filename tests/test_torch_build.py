"""The kernel build's own decisions, checked without nvcc: the robust-kernel
thresholds reach the CUDA sources from one definition, and a library's
cache key covers the flags that carry them."""

import ctypes
import re

import pytest

from sdslam_tpu.solvers import ba_const as jconst
from sdslam_tpu_torch.kernels import _build
from sdslam_tpu_torch.kernels import pose_kernel
from sdslam_tpu_torch.solvers import ba_const

NAMES = ("CHI2_MONO", "CHI2_STEREO", "HUBER_MONO", "HUBER_STEREO")


@pytest.mark.parametrize("name", NAMES)
def test_threshold_reaches_kernels_from_ba_const(name):
    value = getattr(ba_const, name)
    # the same threshold as the JAX package's, exactly
    assert value == getattr(jconst, name)
    flags = [f for f in _build.NVCC_FLAGS if f.startswith(f"-DSD_{name}=")]
    assert len(flags) == 1
    assert float(flags[0].split("=", 1)[1].rstrip("f")) == value
    # the plain versions read the same module
    if hasattr(pose_kernel, name):
        assert getattr(pose_kernel, name) is value


def test_sources_hold_no_threshold_of_their_own():
    pat = re.compile(r"#define\s+\w*(CHI2|HUBER)\w*\s|5\.991|7\.815|2\.4477|2\.7955")
    offenders = [f"{p.name}:{m.group(0)}" for p in sorted(_build.CSRC.glob("*.cu*"))
                 for m in pat.finditer(p.read_text())]
    assert not offenders, offenders


def test_cache_key_covers_flags(monkeypatch):
    before = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert len(set(before.values())) == len(_build.SOURCES)
    flags = tuple(f.replace("-DSD_HUBER_MONO=", "-DSD_HUBER_MONO=1") for f in _build.NVCC_FLAGS)
    monkeypatch.setattr(_build, "NVCC_FLAGS", flags)
    after = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)


def test_bind_sets_argtypes_once(monkeypatch):
    """bind() caches the bound function per (library, symbol): a second
    bind returns the same object without loading or setting argtypes again."""
    class Fn:
        sets = 0

        def __setattr__(self, name, value):
            if name == "argtypes":
                Fn.sets += 1
            object.__setattr__(self, name, value)

    class Lib:
        sd_f, sd_g = Fn(), Fn()

    loads = []
    monkeypatch.setattr(_build, "_FNS", {})
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or Lib)
    a = _build.bind("k", "sd_f", [ctypes.c_void_p])
    b = _build.bind("k", "sd_f", [ctypes.c_void_p])
    assert a is b is Lib.sd_f
    assert (loads, Fn.sets) == (["k"], 1)
    assert a.restype is ctypes.c_int
    assert _build.bind("k", "sd_g", [ctypes.c_int]) is Lib.sd_g  # another symbol: bound anew
    assert (loads, Fn.sets) == (["k", "k"], 2)
