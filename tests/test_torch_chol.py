"""K6 (dense SPD Cholesky factor + solve): the port's chol_solve_dense on
the CPU (its plain version) against sdslam_tpu's Pallas kernel in
interpret mode, as tests/test_pallas_kernels.py runs it, and against
jax.scipy's cho_solve beyond the Pallas kernel's interpret-mode sizes; on
local BA's reduced camera systems with the fixed-camera prior; the gate in
solvers/ba.py that sends 6K <= N_MAX to the kernel and larger systems to
the library; and the kernel source's bound against the wrapper's."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.ops.pallas import chol_kernel as jchol
from sdslam_tpu_torch.kernels import _build
from sdslam_tpu_torch.kernels import chol_kernel as tchol
from sdslam_tpu_torch.solvers import ba as tba

RTOL, ATOL = 2e-4, 2e-5


# Interpret mode compiles the Pallas kernel once per padded size, and that
# compile (seconds at 32 rows, a minute at 232 on the CPU) is most of this
# file's time. The systems of 33..232 rows are therefore solved by the Pallas
# kernel inside one 232-row system: S in the top-left block, the identity
# below, b padded with zeros. That is how the wrapper itself pads a ragged
# system, and the top-left block of the solution is S^-1 b.
PALLAS_N = 232


def _pallas(S, b):
    """The Pallas kernel's x = S^-1 b in interpret mode."""
    n = S.shape[0]
    if n > 32:
        Sp = np.eye(PALLAS_N, dtype=np.float32)
        Sp[:n, :n] = S
        S, b = Sp, np.concatenate([b, np.zeros(PALLAS_N - n, np.float32)])
    x = jchol.chol_solve_dense(jnp.asarray(S), jnp.asarray(b), interpret=True)
    return np.asarray(x)[:n]


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    return (A @ A.T + n * np.eye(n, dtype=np.float32)).astype(np.float32), \
        rng.normal(size=n).astype(np.float32)


@pytest.mark.parametrize("n", [30, 144])
def test_chol_solve_matches_pallas_interpret(n):
    """N = 30 takes the Pallas wrapper's padding path, N = 144 is local
    BA's reduced system (24 keyframes x 6)."""
    S, b = _spd(n, n)
    before = tchol.LAUNCHES
    x = tchol.chol_solve_dense(torch.from_numpy(S), torch.from_numpy(b))
    assert tchol.LAUNCHES == before  # CPU tensors take the plain version
    np.testing.assert_allclose(x.numpy(), _pallas(S, b), rtol=RTOL, atol=ATOL)


def test_chol_solve_matches_cho_solve_at_384():
    S, b = _spd(384, 384)
    x = tchol.chol_solve_dense(torch.from_numpy(S), torch.from_numpy(b))
    c = jax.scipy.linalg.cho_factor(jnp.asarray(S), lower=True)
    ref = np.asarray(jax.scipy.linalg.cho_solve(c, jnp.asarray(b)))
    np.testing.assert_allclose(x.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("K", [24, tchol.N_MAX // 6 + 1])
def test_ba_solve_gate(K, monkeypatch):
    """solvers/ba.py solves [6K, 6K] with the kernel's wrapper up to N_MAX
    and with the library above it, decided from the shape alone; both give
    the library's numbers on the CPU."""
    calls = []
    wrapper = tchol.chol_solve_dense
    monkeypatch.setattr(tchol, "chol_solve_dense",
                        lambda S, b: calls.append(S.shape[0]) or wrapper(S, b))
    rng = np.random.default_rng(K)
    A = rng.normal(size=(6 * K, 6 * K)).astype(np.float32)
    S0 = torch.from_numpy(A @ A.T + 6 * K * np.eye(6 * K, dtype=np.float32))
    bs = torch.from_numpy(rng.normal(size=(K, 6)).astype(np.float32))
    cam_active = torch.from_numpy(np.arange(K) > 0)
    dc = tba._apply_prior_and_solve(S0, bs, cam_active, torch.tensor(1e-4), K)
    assert calls == ([6 * K] if 6 * K <= tchol.N_MAX else [])
    assert dc.shape == (K, 6) and torch.all(dc[0] == 0)
    prior = torch.where(cam_active, 1e-4 * torch.clamp(
        torch.diagonal(S0).reshape(K, 6).sum(1) / 6.0, min=1e-6), torch.tensor(tba.FIXED_PRIOR))
    S = S0 + torch.diag(prior.repeat_interleave(6))
    ref = tchol.chol_solve_dense_plain(S, bs.reshape(-1)).reshape(K, 6) * cam_active[:, None]
    torch.testing.assert_close(dc, ref, rtol=0, atol=0)


def _ba_system(K, n_fixed=2, lm_lambda=1e-4):
    """Local BA's reduced camera system [6K, 6K] as solvers/ba.py builds it
    before the solve: a Schur-like SPD S0 plus FIXED_PRIOR on the diagonal
    of the first n_fixed cameras and lm_lambda x (the camera block's trace
    / 6) on the others."""
    n = 6 * K
    S0, b = _spd(n, 1000 + K)
    tr = np.diagonal(S0).reshape(K, 6).sum(1)
    prior = np.where(np.arange(K) >= n_fixed, lm_lambda * np.maximum(tr / 6.0, 1e-6),
                     tba.FIXED_PRIOR)
    return (S0 + np.diag(np.repeat(prior, 6))).astype(np.float32), b


@pytest.mark.parametrize("K", [5, 14, 24, 38])
def test_ba_system_matches_pallas_and_cho_solve(K):
    """N = 30, 84, 144, 228: ragged panels for the card's 16-column blocks,
    local BA's [144, 144], and the largest 6K under N_MAX. Both fixed
    cameras sit under the 1e12 prior."""
    S, b = _ba_system(K)
    x = tchol.chol_solve_dense(torch.from_numpy(S), torch.from_numpy(b)).numpy()
    pallas = _pallas(S, b)
    c = jax.scipy.linalg.cho_factor(jnp.asarray(S), lower=True)
    lib = np.asarray(jax.scipy.linalg.cho_solve(c, jnp.asarray(b)))
    np.testing.assert_allclose(x, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x, lib, rtol=RTOL, atol=ATOL)
    resid = np.linalg.norm(S.astype(np.float64) @ x - b) / np.linalg.norm(b)
    assert resid <= 1e-4


def test_kernel_bound_matches_wrapper():
    """csrc/chol_solve.cu bounds N where kernels/chol_kernel.py does, and a
    launch at that N fits one block's shared memory (S at the kernel's
    row stride, the least LD >= N with LD = 4 mod 8, plus the vector)."""
    src = (_build.CSRC / "chol_solve.cu").read_text()
    assert int(re.search(r"#define CS_N_MAX (\d+)", src).group(1)) == tchol.N_MAX
    n = tchol.N_MAX
    ld = ((n + 3) // 8) * 8 + 4
    assert ld >= n and ld % 8 == 4
    assert (n * ld + n) * 4 <= 232448
