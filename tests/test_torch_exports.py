"""The public names the JAX modules export, in the port: each against the
JAX function on the same seeded inputs (np.random.default_rng per case),
including the non-dyadic pyramid and the ORB extractor at scale factor 1.2.
A comparison of the two trees' syntax keeps every public name and every
parameter of the JAX API present in the port, apart from the design
differences listed with their reasons.
"""

import ast
import logging
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.features import matching as jmatching
from sdslam_tpu.features.frame import ORBExtractor as JExtractor
from sdslam_tpu.geometry import camera as jcam
from sdslam_tpu.geometry import lie as jlie
from sdslam_tpu.geometry.camera import CameraModel as JCam
from sdslam_tpu.io import synthetic as jsyn
from sdslam_tpu.ops import hamming as jham
from sdslam_tpu.ops import interp as jinterp
from sdslam_tpu.ops import orb as jorb
from sdslam_tpu.ops import pyramid as jpyr
from sdslam_tpu.ops import sample as jsample
from sdslam_tpu.pipeline import sensors as jsensors
from sdslam_tpu.solvers import pose_opt as jpose
from sdslam_tpu.utils import profiling as jprof
from sdslam_tpu.utils.config import ORBConfig as JORB
from sdslam_tpu_torch.features import matching as tmatching
from sdslam_tpu_torch.features.frame import ORBExtractor as TExtractor
from sdslam_tpu_torch.geometry import camera as tcam
from sdslam_tpu_torch.geometry import lie as tlie
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.ops import hamming as tham
from sdslam_tpu_torch.ops import interp as tinterp
from sdslam_tpu_torch.ops import orb as torb
from sdslam_tpu_torch.ops import pyramid as tpyr
from sdslam_tpu_torch.ops import sample as tsample
from sdslam_tpu_torch.pipeline import sensors as tsensors
from sdslam_tpu_torch.solvers import pose_opt as tpose
from sdslam_tpu_torch.utils import profiling as tprof
from sdslam_tpu_torch.utils.config import ORBConfig as TORB

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _lie_case(name, rng):
    """(jax value, port value) of one lie export on seeded inputs."""
    if name == "quat_identity":
        return jlie.quat_identity(), tlie.quat_identity()
    if name == "se3_identity":
        return jlie.se3_identity(), tlie.se3_identity()
    if name == "quat_conj":
        q = _quats(rng, 16)
        return jlie.quat_conj(jnp.asarray(q)), tlie.quat_conj(torch.from_numpy(q))
    if name == "quat_rotate":
        q, v = _quats(rng, 16), rng.normal(size=(16, 3)).astype(np.float32)
        return (jlie.quat_rotate(jnp.asarray(q), jnp.asarray(v)),
                tlie.quat_rotate(torch.from_numpy(q), torch.from_numpy(v)))
    if name == "quat_rotate_broadcast":  # one quaternion, many vectors
        q, v = _quats(rng, 1)[0], rng.normal(size=(16, 3)).astype(np.float32)
        return (jlie.quat_rotate(jnp.asarray(q), jnp.asarray(v)),
                tlie.quat_rotate(torch.from_numpy(q), torch.from_numpy(v)))
    if name == "vee":
        phi = rng.normal(size=(16, 3)).astype(np.float32)
        return (jlie.vee(jlie.hat(jnp.asarray(phi))),
                tlie.vee(tlie.hat(torch.from_numpy(phi))))
    if name == "project_jacobian":
        X = rng.normal(size=(32, 3)).astype(np.float32)
        X[:, 2] = np.abs(X[:, 2]) + 0.5
        X[0, 2] = 1e-8  # the near-zero depth guard
        return (jcam.project_jacobian(JCam(**CAM), jnp.asarray(X)),
                tcam.project_jacobian(TCam(**CAM), torch.from_numpy(X)))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["quat_identity", "se3_identity", "quat_conj", "quat_rotate",
                                  "quat_rotate_broadcast", "vee", "project_jacobian"])
def test_geometry_exports(name):
    a, b = _lie_case(name, np.random.default_rng(1))
    assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) == str(b.dtype).split(".")[-1]
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=1e-6)


def _image(rng, h=60, w=80):
    return rng.uniform(0, 255, (h, w)).astype(np.float32)


@pytest.mark.parametrize("fn", ["interp.bilinear_sample", "sample.sample_bilinear"])
def test_bilinear_sample(fn):
    rng = np.random.default_rng(2)
    img = _image(rng)
    # inside, on the last valid row / column, and outside the image
    uv = np.concatenate([rng.uniform(-3, 83, (200, 2)),
                         [[78.5, 58.5], [79.0, 10.0], [-0.5, 3.0], [10.0, 59.0]]]).astype(np.float32)
    jf, tf = ((jinterp.bilinear_sample, tinterp.bilinear_sample) if fn.startswith("interp")
              else (jsample.sample_bilinear, tsample.sample_bilinear))
    jv, jok = jf(jnp.asarray(img), jnp.asarray(uv))
    tv, tok = tf(torch.from_numpy(img), torch.from_numpy(uv))
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=1e-4)
    assert tok.numpy().sum() > 100


def test_extract_patches():
    rng = np.random.default_rng(3)
    img = _image(rng)
    uv = rng.uniform(-4, 84, (64, 2)).astype(np.float32)
    a = jorb.extract_patches(jnp.asarray(img), jnp.asarray(uv), 3)
    b = torb.extract_patches(torch.from_numpy(img), torch.from_numpy(uv), 3)
    assert tuple(b.shape) == (64, 7, 7)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_best2():
    rng = np.random.default_rng(4)
    d = rng.integers(0, 40, (50, 30)).astype(np.int32)  # many ties
    d[3] = 17  # a whole row tied
    for x, y in zip(jham.best2(jnp.asarray(d)), tham.best2(torch.from_numpy(d))):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_level_scales():
    for n, s in ((5, 2.0), (8, 1.2), (1, 1.5)):
        assert tpyr.level_scales(n, s) == jpyr.level_scales(n, s)


@pytest.fixture(scope="module")
def frame640():
    cam = JCam(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480, bf=40.0)
    seq = jsyn.SyntheticSequence(cam, n_frames=4, trajectory="orbit", radius=0.06, yaw_amp=0.04)
    return np.asarray(seq.frame(1)[1])


def test_pyramid_non_dyadic(frame640):
    """Scale factor 1.2 at 640x480, 5 levels: blur (sigma 0.8) and an
    antialiased linear resize per level. The two resizes round their
    float32 filter weights differently, so levels agree to 1e-4 of the
    intensity range (255), not bit for bit."""
    a = jpyr.build_pyramid(jnp.asarray(frame640), 5, 1.2)
    b = tpyr.build_pyramid(torch.from_numpy(frame640.copy()), 5, 1.2)
    assert [tuple(x.shape) for x in a] == [tuple(y.shape) for y in b]
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), atol=1e-4 * 255)


def test_orb_extractor_call_non_dyadic():
    """ORBExtractor.__call__ at scale factor 1.2 against JAX, at the
    tolerances of tests/test_torch_extract.py."""
    seq = jsyn.SyntheticSequence(JCam(**CAM), n_frames=16, trajectory="orbit", radius=0.06,
                                 yaw_amp=0.04)
    img = np.asarray(seq.frame(3)[1])
    jf, jp = JExtractor(JCam(**CAM), JORB(max_keypoints=512, n_levels=4, scale_factor=1.2))(img)
    tf, tp = TExtractor(TCam(**CAM), TORB(max_keypoints=512, n_levels=4, scale_factor=1.2))(img)
    assert len(jp) == len(tp) == 4
    valid = np.asarray(jf.valid)
    np.testing.assert_array_equal(valid, tf.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jf.octave), tf.octave.numpy())
    for f in ("uv", "uv_und", "score", "angle"):
        np.testing.assert_allclose(np.asarray(getattr(jf, f)), getattr(tf, f).numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(jf.desc), tf.desc.numpy().view(np.uint32))
    assert valid.sum() > 200 and set(np.asarray(jf.octave)[valid]) == {0, 1, 2, 3}


def test_constant_velocity_ekf():
    """The host filter through restart, a gated-out jump and noisy motion."""
    rng = np.random.default_rng(5)
    ja, tb = jsensors.ConstantVelocityEKF(), tsensors.ConstantVelocityEKF()
    T = np.eye(4, dtype=np.float32)
    for k in range(24):
        xi = np.concatenate([[0.01, 0.0, 0.02], [0.0, 0.01, 0.0]]) + rng.normal(0, 0.002, 6)
        T = (jsensors._np_se3_exp(xi) @ T).astype(np.float32)
        if k == 12:
            T = T.copy()
            T[:3, 3] += 1.0  # inconsistent with the motion model
        if k == 18:
            ja.restart()
            tb.restart()
        pa, pb = ja.predict(1 / 30), tb.predict(1 / 30)
        assert (pa is None) == (pb is None)
        if pa is not None:
            np.testing.assert_allclose(pa, pb, atol=1e-6)
        assert ja.update(T, 1 / 30) == tb.update(T, 1 / 30)
        np.testing.assert_allclose(ja.x, tb.x, atol=1e-9)
        np.testing.assert_allclose(ja.P, tb.P, atol=1e-9)


ROOT = pathlib.Path(__file__).resolve().parent.parent
JPKG, TPKG = ROOT / "sdslam_tpu", ROOT / "sdslam_tpu_torch"

# (module, function or Class.method, parameter) of the JAX API the port
# leaves out by design, each with its reason
PARAM_ALLOWED = {
    **{("ops/sample.py", f, "precision"): "TPU-only matmul precision switch" for f in (
        "sample_nearest", "sample_bilinear", "sample_bilinear_patch",
        "sample_bilinear_with_grad")},
    ("ops/orb.py", "extract_patches", "precision"): "TPU-only matmul precision switch",
    ("solvers/image_align.py", "align", "fused"):
        "TPU-only Pallas kernel switch; the port takes its kernel for tensors on the card",
    ("solvers/pose_opt.py", "optimize_pose", "fused"): "TPU-only Pallas kernel switch, as align's",
    **{(m, f, "key"): "JAX PRNG key; the port draws from a seeded torch generator" for m, f in (
        ("pipeline/loop_closing.py", "verify_loop_sim3"),
        ("pipeline/relocalization.py", "relocalize"), ("solvers/epnp.py", "ransac_epnp"),
        ("solvers/sim3_solver.py", "ransac_sim3"),
        ("solvers/initializer.py", "initialize_two_view"))},
    ("solvers/initializer.py", "initialize_two_view", "n_iters"):
        "the port takes the RANSAC draws as `samples`, whose length is the iteration count",
    **{(m, f, "mesh"): "a jax.sharding.Mesh; the port's solvers take a process group" for m, f in (
        ("parallel/dist_align.py", "distributed_align_scan"),
        ("parallel/dist_ba.py", "make_distributed_gn_step"),
        ("parallel/dist_ba.py", "distributed_bundle_adjust"),
        ("parallel/dist_pose_graph.py", "distributed_pose_graph"),
        ("parallel/multihost.py", "global_put"))},
    ("parallel/multihost.py", "global_mesh", "axis"): "a mesh axis name; the port's group has none",
    **{("parallel/multihost.py", "init_multihost", a): "a jax.distributed.initialize argument; "
       "the port's process group takes its address, world size and rank" for a in (
           "coordinator_address", "num_processes", "process_id", "local_device_count",
           "platform")},
    ("parallel/pipelined.py", "PipelinedRGBDTracker.__init__", "track_device"):
        "the port's `device`",
}


def _public(name: str) -> bool:
    return not name.startswith("_") or name in ("__init__", "__call__")


def _api(path: pathlib.Path, with_imports: bool):
    """(public names, {function or Class.method: parameter names}) of a
    module; with_imports counts names a module re-exports by import."""
    names, funcs = set(), {}

    def params(fn):
        a = fn.args
        return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if _public(node.name):
                names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                names |= {n.id for n in ast.walk(t) if isinstance(n, ast.Name) and _public(n.id)}
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            funcs[node.name] = params(node)
        if isinstance(node, ast.ClassDef) and _public(node.name):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(m.name):
                    funcs[f"{node.name}.{m.name}"] = params(m)
    return names, funcs


def test_api_covers_jax_modules():
    """Every module pair outside ops/pallas/: each public name of the JAX
    module exists in the port's, and each parameter of a public JAX
    function or method in the port's counterpart, or stands in
    PARAM_ALLOWED."""
    missing, seen = [], set()
    pairs = [p for p in sorted(JPKG.rglob("*.py"))
             if p.relative_to(JPKG).parts[:2] != ("ops", "pallas")]
    for jp in pairs:
        rel = jp.relative_to(JPKG).as_posix()
        tp = TPKG / rel
        if not tp.exists():
            missing.append(f"module {rel}")
            continue
        jn, jf = _api(jp, with_imports=False)
        tn, tf = _api(tp, with_imports=True)
        missing += [f"{rel}: {n}" for n in sorted(jn - tn)]
        for fn, ps in jf.items():
            for prm in ps:
                if fn not in tf or prm in tf[fn] or prm in ("self", "cls"):
                    continue
                if (rel, fn, prm) in PARAM_ALLOWED:
                    seen.add((rel, fn, prm))
                else:
                    missing.append(f"{rel}: {fn}({prm}=)")
    assert len(pairs) > 40
    assert not missing, missing
    # the allow-list holds only differences that exist
    assert seen == set(PARAM_ALLOWED), sorted(set(PARAM_ALLOWED) - seen)


def test_pose_opt_constants_and_log():
    for k in ("CHI2_MONO", "CHI2_STEREO", "HUBER_MONO", "HUBER_STEREO"):
        assert getattr(tpose, k) == getattr(jpose, k), k
    assert isinstance(tprof.log, logging.Logger) and isinstance(jprof.log, logging.Logger)
    assert tprof.log.name == "sdslam_tpu_torch" and jprof.log.name == "sdslam_tpu"


def _brute_force_descs(rng):
    """Targets [96] and queries [80] (uint32 [.,8]) where each gate of
    search_brute_force decides some matches: queries 0-39 are noisy copies
    of targets 0-39; for k < 8, query 40+k (B) lies 5 bits from target
    40+k (T) and from its near twin 48+k, so it fails the ratio test, and
    query 48+k (A) lies 8 bits from T and passes it, but T's own best is
    B; query 56+k (D) lies 2 bits from target 56+k (V) and 4 from 64+k (U),
    query 64+k (C) 6 bits from U, whose own best is D; 72-79 are random."""
    t = rng.integers(0, 2**32, size=(96, 8), dtype=np.uint64).astype(np.uint32)

    def flip(d, bits):
        d = d.copy()
        for b in bits:
            d[b // 32] ^= np.uint32(1 << (b % 32))
        return d

    q = rng.integers(0, 2**32, size=(80, 8), dtype=np.uint64).astype(np.uint32)
    for i in range(40):
        q[i] = flip(t[i], rng.permutation(256)[:rng.integers(0, 13)])
    for k in range(8):
        bits = rng.permutation(256)
        t[48 + k] = flip(t[40 + k], bits[:10])
        q[40 + k] = flip(t[40 + k], bits[:5])
        q[48 + k] = flip(t[40 + k], bits[10:18])
        t[64 + k] = flip(t[56 + k], bits[20:26])
        q[56 + k] = flip(t[56 + k], bits[20:22])
        q[64 + k] = flip(t[64 + k], bits[30:36])
    return q, t


@pytest.mark.parametrize("ratio", [0.75, None])
@pytest.mark.parametrize("mutual", [True, False])
def test_search_brute_force_options(ratio, mutual):
    """`ratio=None` skips the ratio test, `mutual=False` the back-check:
    the same target -> query assignment as JAX, and the matches of the
    constructed cases as each combination of the gates decides them."""
    rng = np.random.default_rng(6)
    q, t = _brute_force_descs(rng)
    qv, tv = np.ones(80, bool), np.ones(96, bool)
    qv[79], tv[95] = False, False
    kw = dict(th_desc=50, ratio=ratio, mutual=mutual)
    a = jmatching.search_brute_force(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(t),
                                     jnp.asarray(tv), **kw)
    b = tmatching.search_brute_force(torch.from_numpy(q.view(np.int32)), torch.from_numpy(qv),
                                     torch.from_numpy(t.view(np.int32)), torch.from_numpy(tv), **kw)
    np.testing.assert_array_equal(np.asarray(a.kp_to_query), b.kp_to_query.numpy())
    np.testing.assert_array_equal(np.asarray(a.kp_dist), b.kp_dist.numpy())
    m = b.kp_to_query.numpy()
    np.testing.assert_array_equal(m[:40], np.arange(40))
    k = np.arange(8)
    want_T = {(0.75, True): -1, (0.75, False): 48 + k, (None, True): 40 + k, (None, False): 40 + k}
    want_U = {(0.75, True): -1, (0.75, False): 64 + k, (None, True): -1, (None, False): 64 + k}
    np.testing.assert_array_equal(m[40:48], np.broadcast_to(want_T[ratio, mutual], 8))
    np.testing.assert_array_equal(m[64:72], np.broadcast_to(want_U[ratio, mutual], 8))
    np.testing.assert_array_equal(m[56:64], 56 + k)  # D -> V under every gate
