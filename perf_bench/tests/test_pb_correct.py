"""`correct` at a test size on the CPU: each cell's sound run comes out
correct; its control (the program told a broken guarantee) and each fault
planted in the timed path come out not correct. The run is the harness's
own (`harness.run_cell`), without the look for a card, on a 320x240 copy
of each configuration and a shorter lap, held to the cell's own limits.

Faults: the step returns its state unchanged (the pose stays its
reference keyframe's and the map takes no keyframe); half of the batch
left out (the second half of every frame's keypoints dropped); an answer
altered where it is produced (the tracked pose moved 30 cm). One card: no
exchange between chips."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from perf_bench import check, harness
from perf_bench.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]
SECONDS = 8.0


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """The benchmark's files with every configuration at half width (320 x
    240), 500 features over 4 levels, a 32-slot pool, and every lap cut to
    48 frames of the localizing cell's motion."""
    dst = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "perf_bench", dst / "perf_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        p = dst / c["file"]
        d = json.loads(p.read_text())
        s = d["settings"]
        for k in ("fx", "fy", "cx", "cy", "bf"):
            if f"Camera.{k}" in s:
                s[f"Camera.{k}"] /= 2
        s["Camera.Width"] //= 2
        s["Camera.Height"] //= 2
        s.update({"ORBextractor.nFeatures": 500, "ORBextractor.nLevels": 4,
                  "Map.MaxKeyframes": 32, "Map.MaxPoints": 4096})
        p.write_text(json.dumps(d))
    for w in bench["workloads"]:
        p = dst / "perf_bench" / "traffic" / f"{w['traffic']}.json"
        t = json.loads(p.read_text())
        t["lap"].update(lap_frames=48, radius_m=0.12, yaw_amp_rad=0.08)
        t["setup_frames"] = min(t["setup_frames"], 8)
        t["orb_sample_frames"] = 1
        p.write_text(json.dumps(t))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(autouse=True, scope="module")
def four_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def run(root, cell, seed=20261017, control=False):
    m = Manifest(root)
    res = harness.run_cell(m, cell, seed, SECONDS, False, device="cpu", control=control)
    ok, checks = check.judge(res["numbers"], m.limits(cell))
    return ok, checks


def _stuck(orig):
    def core(cam, ms, *a, **kw):
        out = orig(cam, ms, *a, **kw)
        ref_slot = a[6]
        return out._replace(Tcw=ms.kf_Tcw[ref_slot.long()].clone())
    return core


def _no_keyframe(orig):
    def keyframe(self, ms, need_kf_d, *a):
        return orig(self, ms, torch.zeros_like(need_kf_d), *a)
    return keyframe


def _moved(orig):
    def core(*a, **kw):
        out = orig(*a, **kw)
        T = out.Tcw.clone()
        T[0, 3] += 0.30
        return out._replace(Tcw=T)
    return core


def _half(orig):
    def extract(self, img):
        f, pyr = orig(self, img)
        n = f.valid.shape[0]
        keep = torch.arange(n, device=f.valid.device) < n // 2
        return f._replace(valid=f.valid & keep), pyr
    return extract


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    ok, checks = run(tiny_root, cell)
    assert ok, json.dumps(checks)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    ok, checks = run(tiny_root, cell, control=True)
    assert not ok, checks


@pytest.mark.parametrize("fault", ["stuck", "half", "moved"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny_root, cell, fault, monkeypatch):
    from sdslam_tpu_torch.features import frame
    from sdslam_tpu_torch.pipeline import tracking

    if fault == "half":
        monkeypatch.setattr(frame.ORBExtractor, "extract", _half(frame.ORBExtractor.extract))
    else:
        wrap = _stuck if fault == "stuck" else _moved
        monkeypatch.setattr(tracking, "_track_core", wrap(tracking._track_core))
    if fault == "stuck":
        monkeypatch.setattr(tracking.RGBDTracker, "_keyframe",
                            _no_keyframe(tracking.RGBDTracker._keyframe))
    ok, checks = run(tiny_root, cell)
    assert not ok, checks

