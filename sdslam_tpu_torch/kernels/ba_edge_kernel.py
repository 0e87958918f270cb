"""K7: the flat per-edge bundle-adjustment pass (csrc/ba_edge.cu).

Port of sdslam_tpu/ops/pallas/ba_edge_kernel.py::ba_edge_terms, with the
same channel maps (copied from that module), edges flat on the last axis:

input  [27, E]:
    0-15  camera row-major T (16)          16-18  point world position X
    19-20 observed (u, v)                  21     observed u_r
    22    inv_sigma2 (information)         23     stereo flag (0/1)
    24    edge valid (0/1)                 25     camera-active (0/1)
    26    point-active (0/1)
output [55, E]:
    0-17  W = Jc^T w Jp (i*3+j)            18-38  upper-tri Jc^T w Jc (21)
    39-44 -Jc^T w r (6)                    45-50  upper-tri Jp^T w Jp (6)
    51-53 -Jp^T w r (3)                    54     robust cost rho (masked)

Neither package calls it on a tracking path (K3 superseded it); the JAX
package's diagnostic scripts and the port's chip_smoke.py run it. The
Huber deltas come from solvers/ba_const.py, as the kernel's -DSD_HUBER_*
flags do.
"""

from __future__ import annotations

import ctypes

import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch.kernels import _build, count_launch
from sdslam_tpu_torch.solvers.ba_const import HUBER_MONO, HUBER_STEREO

LAUNCHES = 0
N_IN = 27
N_OUT = 55


def ba_edge_terms_plain(packed, fx: float, fy: float, cx: float, cy: float, bf: float,
                        use_huber: bool):
    """The kernel's math elementwise on the [27, E] planes -> [55, E]."""
    g = packed
    r00, r01, r02, t0 = g[0], g[1], g[2], g[3]
    r10, r11, r12, t1 = g[4], g[5], g[6], g[7]
    r20, r21, r22, t2 = g[8], g[9], g[10], g[11]
    X0, X1, X2 = g[16], g[17], g[18]
    u_obs, v_obs, ur_obs = g[19], g[20], g[21]
    info, st, obs_ok = g[22], g[23], g[24]
    cam_act, pt_act = g[25], g[26]

    x = r00 * X0 + r01 * X1 + r02 * X2 + t0
    y = r10 * X0 + r11 * X1 + r12 * X2 + t1
    z = r20 * X0 + r21 * X1 + r22 * X2 + t2
    zi = 1.0 / torch.clamp(z, min=1e-6)
    zi2 = zi * zi
    u = fx * x * zi + cx
    v = fy * y * zi + cy
    ur = u - bf * zi
    res = (u - u_obs, v - v_obs, st * (ur - ur_obs))
    ok = obs_ok * (z > 0.05).to(z.dtype)
    chi2 = (res[0] * res[0] + res[1] * res[1] + res[2] * res[2]) * info
    hub = torch.where(st > 0, torch.full_like(z, HUBER_STEREO), torch.full_like(z, HUBER_MONO))
    d2 = hub * hub
    sq = torch.sqrt(chi2 + 1e-12)
    rho = torch.where(chi2 <= d2, chi2, 2.0 * hub * sq - d2)
    w = info * ok
    if use_huber:
        w = w * torch.clamp(hub / torch.clamp(sq, min=1e-9), max=1.0)

    zero = torch.zeros_like(zi)
    JX = ((fx * zi, zero, -fx * x * zi2),
          (zero, fy * zi, -fy * y * zi2),
          (st * fx * zi, zero, st * (-fx * x * zi2 + bf * zi2)))
    Jc, Jp = [], []
    for (a, b, c_) in JX:
        Jc.append(tuple(cam_act * q for q in (a, b, c_, c_ * y - b * z, a * z - c_ * x,
                                               b * x - a * y)))
        Jp.append(tuple(pt_act * q for q in (a * r00 + b * r10 + c_ * r20,
                                              a * r01 + b * r11 + c_ * r21,
                                              a * r02 + b * r12 + c_ * r22)))

    def wsum(A, B, i, j):
        return w * (A[0][i] * B[0][j] + A[1][i] * B[1][j] + A[2][i] * B[2][j])

    def wres(A, i):
        return -w * (A[0][i] * res[0] + A[1][i] * res[1] + A[2][i] * res[2])

    planes = [wsum(Jc, Jp, i, j) for i in range(6) for j in range(3)]
    planes += [wsum(Jc, Jc, i, j) for i in range(6) for j in range(i, 6)]
    planes += [wres(Jc, i) for i in range(6)]
    planes += [wsum(Jp, Jp, i, j) for i in range(3) for j in range(i, 3)]
    planes += [wres(Jp, i) for i in range(3)]
    planes.append(rho * ok)
    return torch.stack(planes)


def ba_edge_terms(packed, fx: float, fy: float, cx: float, cy: float, bf: float,
                  use_huber: bool):
    """packed [27, E] f32 channel-major per-edge inputs -> [55, E] f32."""
    if not _device.use_kernel(packed):
        return ba_edge_terms_plain(packed, fx, fy, cx, cy, bf, use_huber)
    _device.check_tensor("packed", packed, torch.float32, (N_IN, None))
    E = packed.shape[1]
    out = torch.empty((N_OUT, E), dtype=torch.float32, device=packed.device)
    vp, cf = ctypes.c_void_p, ctypes.c_float
    fn = _build.bind("ba_edge", "sd_ba_edge_terms",
                     [vp, ctypes.c_int, cf, cf, cf, cf, cf, ctypes.c_int, vp, vp])
    rc = fn(packed.data_ptr(), E, float(fx), float(fy), float(cx), float(cy), float(bf),
            int(use_huber), out.data_ptr(), _device.stream_ptr(packed))
    _build.check(rc, "sd_ba_edge_terms")
    count_launch(__name__)
    return out
