"""K3: BA edge pass + landmark elimination + Schur-factor scatter
(csrc/ba_schur.cu).

Port of sdslam_tpu/ops/pallas/ba_schur_kernel.py::ba_edge_schur, with the
same channel maps (copied from that module):

input  [28, Mo, P]:
    0-15  camera row-major T (16)          16-18  point world position X
    19-20 observed (u, v)                  21     observed u_r
    22    inv_sigma2                       23     stereo flag (0/1)
    24    edge valid (0/1)                 25     camera-active (0/1)
    26    point-active (0/1)               27     camera index (f32)
edge out [51, Mo, P] (emit_zt) or [69, Mo, P]:
    0-17  W = Jc^T w Jp (i*3+j)            18-38  upper-tri Jc^T w Jc (21)
    39-44 -Jc^T w r (6)                    45-50  V.ybp edge terms (6)
    51-68 (only when the Z-scatter is off) Ze = W Linv^T (channel j*6+i)
rows out [10, P]:
    0-5   Hpp^-1 sym comps (s00,s01,s02,s11,s12,s22)
    6-8   ybp = Hpp^-1 bp                  9      robust cost rho (per point)
zt out [18K, P] (emit_zt only): Zt[j][k*6+i] at row j*6K + k*6 + i.

The plain version is the flat-edge math of the XLA fallback in
sdslam_tpu/solvers/ba.py:_schur_terms, laid out on the kernel's planes.
"""

from __future__ import annotations

import ctypes

import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch._util import as_device
from sdslam_tpu_torch.kernels import _build, count_launch
from sdslam_tpu_torch.solvers.ba_const import HUBER_MONO, HUBER_STEREO

LAUNCHES = 0
N_IN = 28
N_EDGE = 51
ZT_MAX_K = 64
MAX_MO = 62  # observations per point whose edges fit the kernel's shared memory


def _chol3x3_inv(h00, h01, h02, h11, h12, h22):
    """Closed-form Cholesky L of a batched SPD 3x3 and the entries of
    Linv (lower): returns (i00, i10, i11, i20, i21, i22)."""
    l00 = torch.sqrt(torch.clamp(h00, min=1e-30))
    l10 = h01 / l00
    l20 = h02 / l00
    l11 = torch.sqrt(torch.clamp(h11 - l10 * l10, min=1e-30))
    l21 = (h12 - l10 * l20) / l11
    l22 = torch.sqrt(torch.clamp(h22 - l20 * l20 - l21 * l21, min=1e-30))
    i00, i11, i22 = 1.0 / l00, 1.0 / l11, 1.0 / l22
    i10 = -l10 * i00 * i11
    i20 = (l10 * l21 - l20 * l11) * i00 * i11 * i22
    i21 = -l21 * i11 * i22
    return i00, i10, i11, i20, i21, i22


def ba_edge_schur_plain(packed, lm_lambda, fx: float, fy: float, cx: float, cy: float,
                        bf: float, use_huber: bool, K: int, emit_zt: bool = True):
    """Returns (edge [51|69, Mo, P], rows [10, P], zt [18K, P] | None)."""
    g = packed
    r00, r01, r02, t0 = g[0], g[1], g[2], g[3]
    r10, r11, r12, t1 = g[4], g[5], g[6], g[7]
    r20, r21, r22, t2 = g[8], g[9], g[10], g[11]
    X0, X1, X2 = g[16], g[17], g[18]
    u_obs, v_obs, ur_obs = g[19], g[20], g[21]
    info, st, obs_ok = g[22], g[23], g[24]
    cam_act, pt_act, cam_id = g[25], g[26], g[27]
    stereo = st > 0

    x = r00 * X0 + r01 * X1 + r02 * X2 + t0
    y = r10 * X0 + r11 * X1 + r12 * X2 + t1
    z = r20 * X0 + r21 * X1 + r22 * X2 + t2
    zi = 1.0 / torch.clamp(z, min=1e-6)
    zi2 = zi * zi
    u = fx * x * zi + cx
    v = fy * y * zi + cy
    ur = u - bf * zi
    zero = torch.zeros_like(zi)
    res = (u - u_obs, v - v_obs, torch.where(stereo, ur - ur_obs, zero))
    ok = obs_ok * (z > 0.05).to(z.dtype)
    chi2 = (res[0] * res[0] + res[1] * res[1] + res[2] * res[2]) * info
    hub = torch.where(stereo, torch.full_like(z, HUBER_STEREO), torch.full_like(z, HUBER_MONO))
    d2 = hub * hub
    sq = torch.sqrt(chi2 + 1e-12)
    rho = torch.where(chi2 <= d2, chi2, 2.0 * hub * sq - d2)
    w = info * ok
    if use_huber:
        w = w * torch.clamp(hub / torch.clamp(sq, min=1e-9), max=1.0)

    stf = stereo.to(z.dtype)
    JX = ((fx * zi, zero, -fx * x * zi2),
          (zero, fy * zi, -fy * y * zi2),
          (stf * fx * zi, zero, stf * (-fx * x * zi2 + bf * zi2)))
    Jc, Jp = [], []
    for (a, b, c_) in JX:
        Jc.append(tuple(cam_act * q for q in (a, b, c_, c_ * y - b * z, a * z - c_ * x, b * x - a * y)))
        Jp.append(tuple(pt_act * q for q in (a * r00 + b * r10 + c_ * r20,
                                              a * r01 + b * r11 + c_ * r21,
                                              a * r02 + b * r12 + c_ * r22)))

    def wsum(A, B, i, j):
        return w * (A[0][i] * B[0][j] + A[1][i] * B[1][j] + A[2][i] * B[2][j])

    def wres(A, i):
        return -w * (A[0][i] * res[0] + A[1][i] * res[1] + A[2][i] * res[2])

    W = [[wsum(Jc, Jp, i, j) for j in range(3)] for i in range(6)]
    planes = [W[i][j] for i in range(6) for j in range(3)]
    planes += [wsum(Jc, Jc, i, j) for i in range(6) for j in range(i, 6)]
    planes += [wres(Jc, i) for i in range(6)]

    h00, h01, h02, h11, h12, h22 = (
        wsum(Jp, Jp, i, j).sum(0) for i in range(3) for j in range(i, 3)
    )
    bp = [wres(Jp, i).sum(0) for i in range(3)]
    damp = lm_lambda * torch.clamp((h00 + h11 + h22) / 3.0, min=1e-8) + 1e-9
    i00, i10, i11, i20, i21, i22 = _chol3x3_inv(h00 + damp, h01, h02, h11 + damp, h12, h22 + damp)
    s00 = i00 * i00 + i10 * i10 + i20 * i20
    s01 = i10 * i11 + i20 * i21
    s02 = i20 * i22
    s11 = i11 * i11 + i21 * i21
    s12 = i21 * i22
    s22 = i22 * i22
    y0 = s00 * bp[0] + s01 * bp[1] + s02 * bp[2]
    y1 = s01 * bp[0] + s11 * bp[1] + s12 * bp[2]
    y2 = s02 * bp[0] + s12 * bp[1] + s22 * bp[2]
    rows = torch.stack([s00, s01, s02, s11, s12, s22, y0, y1, y2, (rho * ok).sum(0)])

    planes += [W[i][0] * y0 + W[i][1] * y1 + W[i][2] * y2 for i in range(6)]
    Ze = [[W[i][0] * i00 for i in range(6)],
          [W[i][0] * i10 + W[i][1] * i11 for i in range(6)],
          [W[i][0] * i20 + W[i][1] * i21 + W[i][2] * i22 for i in range(6)]]
    if not emit_zt:
        planes += [Ze[j][i] for j in range(3) for i in range(6)]
        return torch.stack(planes), rows, None
    Mo, P = packed.shape[1], packed.shape[2]
    onehot = (cam_id[..., None] == torch.arange(K, device=packed.device)).to(z.dtype)
    Zs = torch.stack([torch.stack(Ze[j]) for j in range(3)])  # [3,6,Mo,P]
    zt = torch.einsum("jimp,mpk->jkip", Zs, onehot).reshape(18 * K, P)
    return torch.stack(planes), rows, zt


def ba_edge_schur(packed, lm_lambda, fx: float, fy: float, cx: float, cy: float,
                  bf: float, use_huber: bool, K: int, emit_zt: bool = True):
    """packed [28, Mo, P] f32, lm_lambda 0-d f32 tensor. Returns
    (edge [51|69, Mo, P], rows [10, P], zt [18K, P] | None)."""
    lam = as_device(lm_lambda, torch.float32, packed.device)
    if not _device.use_kernel(packed, lam):
        return ba_edge_schur_plain(packed, lam, fx, fy, cx, cy, bf, use_huber, K, emit_zt)
    if emit_zt and K > ZT_MAX_K:
        raise ValueError(f"emit_zt needs K <= {ZT_MAX_K}, got {K}")
    if not 1 <= packed.shape[1] <= MAX_MO:
        raise ValueError(f"the kernel takes 1 to {MAX_MO} observations per point, "
                         f"got {packed.shape[1]}")
    _device.check_tensor("packed", packed, torch.float32, (N_IN, None, None))
    lam = lam.reshape(1).contiguous()
    _, Mo, P = packed.shape
    n_edge = N_EDGE if emit_zt else N_EDGE + 18
    edge = torch.empty((n_edge, Mo, P), dtype=torch.float32, device=packed.device)
    rows = torch.empty((10, P), dtype=torch.float32, device=packed.device)
    zt = torch.empty((18 * K if emit_zt else 1, P), dtype=torch.float32, device=packed.device)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.bind(
        "ba_schur", "sd_ba_edge_schur",
        [vp, ci, ci, vp, cf, cf, cf, cf, cf, ci, ci, ci, vp, vp, vp, vp],
    )
    rc = fn(packed.data_ptr(), Mo, P, lam.data_ptr(), float(fx), float(fy), float(cx),
            float(cy), float(bf), int(use_huber), int(K), int(emit_zt), edge.data_ptr(),
            rows.data_ptr(), zt.data_ptr(), _device.stream_ptr(packed))
    _build.check(rc, "sd_ba_edge_schur")
    count_launch(__name__)
    return edge, rows, (zt if emit_zt else None)
