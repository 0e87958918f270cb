"""The port's entry points run on the card unless the caller asks for the
CPU: no public function or method of sdslam_tpu_torch defaults a `device`
parameter to "cpu", and a `device=None` default (which torch's factories
read as the CPU) stands only where it is listed below with its reason.
The walk is over the sources' syntax trees, so it needs no card."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sdslam_tpu_torch"

# qualified name -> why its device=None default stays
NONE_ALLOWED = {
    "geometry.lie.quat_identity":
        "a tensor factory: device=None means torch's default device, as in torch.eye",
    "geometry.lie.se3_identity":
        "a tensor factory: device=None means torch's default device, as in torch.eye",
    "geometry.camera.CameraModel.K":
        "a tensor factory of a camera's intrinsics; every caller passes its tensors' device",
}


def _sources():
    return [p for p in sorted(PKG.rglob("*.py")) if "_build" not in p.relative_to(PKG).parts]


def _public(name: str) -> bool:
    return not name.startswith("_") or name in ("__init__", "__call__")


def _device_defaults(path: pathlib.Path):
    """(qualified name, default) of every `device` parameter with a
    constant default in the module's public functions and methods."""
    mod = ".".join(path.relative_to(PKG).with_suffix("").parts)
    tree = ast.parse(path.read_text())
    out = []

    def visit(body, prefix):
        for node in body:
            if isinstance(node, ast.ClassDef) and _public(node.name):
                visit(node.body, f"{prefix}{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
                a = node.args
                pos = a.posonlyargs + a.args
                pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
                pairs += [(k, d) for k, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
                for arg, d in pairs:
                    if arg.arg == "device" and isinstance(d, ast.Constant):
                        out.append((f"{prefix}{node.name}", d.value))

    visit(tree.body, f"{mod}.")
    return out


def _all_defaults():
    return [x for p in _sources() for x in _device_defaults(p)]


def test_no_device_defaults_to_cpu():
    found = _all_defaults()
    assert len(found) >= 10  # the walk sees the entry points
    cpu = [n for n, d in found if isinstance(d, str) and d.split(":")[0] == "cpu"]
    assert not cpu, f"device defaults to the CPU in {cpu}"


def test_device_none_only_where_listed():
    found = _all_defaults()
    none = sorted(n for n, d in found if d is None)
    assert none == sorted(NONE_ALLOWED), f"device=None defaults: {none}"
    # the constructors of the state a caller carries in default to the card
    cuda = {n for n, d in found if d == "cuda"}
    for name in ("interop.map_state_from_numpy", "interop.ekf_state_from_numpy",
                 "interop.imu_state_from_numpy", "interop.device_state_from_numpy",
                 "interop.consistency_state_from_numpy", "pipeline.sensors.ekf_init",
                 "pipeline.sensors.imu_init", "system.SDSlamSystem.__init__",
                 "pipeline.tracking.RGBDTracker.__init__"):
        assert name in cuda, name
