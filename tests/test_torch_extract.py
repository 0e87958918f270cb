"""ORB extraction parity: pyramid, FAST score map, keypoints, orientations
and steered-BRIEF descriptors of the port against sdslam_tpu (320x240,
512 keypoints, 4 levels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.features.frame import ORBExtractor as JExtractor
from sdslam_tpu.geometry.camera import CameraModel as JCam
from sdslam_tpu.io import synthetic as jsyn
from sdslam_tpu.ops import fast as jfast
from sdslam_tpu.ops import pyramid as jpyr
from sdslam_tpu.utils.config import ORBConfig as JORB
from sdslam_tpu_torch.features.frame import ORBExtractor as TExtractor
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.ops import fast as tfast
from sdslam_tpu_torch.ops import orb as torb
from sdslam_tpu_torch.ops import pyramid as tpyr
from sdslam_tpu_torch.utils.config import ORBConfig as TORB

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)


@pytest.fixture(scope="module")
def frame():
    seq = jsyn.SyntheticSequence(JCam(**CAM), n_frames=16, trajectory="orbit", radius=0.06,
                                 yaw_amp=0.04)
    _, img, depth = seq.frame(3)
    return np.asarray(img), np.asarray(depth)


@pytest.fixture(scope="module")
def extracted(frame):
    img, depth = frame
    jx = JExtractor(JCam(**CAM), JORB(max_keypoints=512, n_levels=4))
    tx = TExtractor(TCam(**CAM), TORB(max_keypoints=512, n_levels=4))
    jf, jp, jd, ju = jx._run_depth(jnp.asarray(img), jnp.asarray(depth), 1.0)
    tf, tp, td, tu = tx.core(torch.from_numpy(img), torch.from_numpy(depth), 1.0)
    return (jf, jp, jd, ju), (tf, tp, td, tu)


def test_brief_pattern_identical():
    from sdslam_tpu.ops import orb as jorb

    np.testing.assert_array_equal(jorb.brief_pattern(), torb.brief_pattern())


def test_pyramid(frame):
    img = frame[0]
    a = jpyr.build_pyramid(jnp.asarray(img), 4)
    b = tpyr.build_pyramid(torch.from_numpy(img), 4)
    for x, y in zip(a, b):
        # separable blur taps summed in the same order; XLA may fuse them
        # into FMAs, so levels agree to float32 rounding of ~255
        np.testing.assert_allclose(np.asarray(x), y.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(jpyr.gaussian_blur(jnp.asarray(img))),
                               tpyr.gaussian_blur(torch.from_numpy(img)).numpy(), atol=1e-4)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_fast_score_map_exact(frame, level):
    # the same level image into both detectors (levels from the JAX pyramid)
    lvl = np.asarray(jpyr.build_pyramid(jnp.asarray(frame[0]), 4)[level])
    a = np.asarray(jfast.fast_score_map(jnp.asarray(lvl)))
    b = tfast.fast_score_map(torch.from_numpy(lvl)).numpy()
    np.testing.assert_array_equal(a, b)
    a = np.asarray(jfast.nms3(jnp.asarray(a)))
    b = tfast.nms3(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(a, b)


def test_detect_keypoints_exact(frame):
    img = frame[0]
    a = jfast.detect_keypoints(jnp.asarray(img), 256)
    b = tfast.detect_keypoints(torch.from_numpy(img), 256)
    np.testing.assert_array_equal(np.asarray(a[2]), b[2].numpy())
    np.testing.assert_array_equal(np.asarray(a[1]), b[1].numpy())
    np.testing.assert_allclose(np.asarray(a[0]), b[0].numpy(), atol=1e-5)


def test_orb_extractor_core(extracted):
    (jf, jp, jd, ju), (tf, tp, td, tu) = extracted
    valid = np.asarray(jf.valid)
    np.testing.assert_array_equal(valid, tf.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jf.octave), tf.octave.numpy())
    # keypoint positions: integer FAST maxima + quadratic subpixel offsets
    np.testing.assert_allclose(np.asarray(jf.uv), tf.uv.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(jf.uv_und), tf.uv_und.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(jf.score), tf.score.numpy(), atol=1e-4)
    # intensity-centroid angles: prefix sums in another order -> ~1e-6 rad
    np.testing.assert_allclose(np.asarray(jf.angle), tf.angle.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ju), tu.numpy(), atol=1e-4)
    assert valid.sum() > 200


def test_descriptors_exact(extracted):
    (jf, _, _, _), (tf, _, _, _) = extracted
    a = np.asarray(jf.desc)
    b = tf.desc.numpy().view(np.uint32)
    np.testing.assert_array_equal(a, b)
