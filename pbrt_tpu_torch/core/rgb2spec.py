"""RGB -> spectrum upsampling via sigmoid polynomials (Jakob & Hanika 2019).

Port of pbrt_tpu/core/rgb2spec.py. Coefficients are fitted at scene-build
time on the host by the reference's own float32 numpy damped-Newton solve
(`_fit_albedo_np`), so a port scene carries the same coefficients as the
JAX scene; evaluation at sampled wavelengths is tensor arithmetic. Texture
values are fitted per ray on the rays' device (`fit_albedo_rays`, the
reference's traced `_fit_albedo_jnp`).

A fitted spectrum is s(lam) = sigmoid(c0 x^2 + c1 x + c2) with x the
wavelength normalized to the visible range and
sigmoid(z) = 1/2 + z / (2 sqrt(1 + z^2)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cie, colorspace
from .floats import grad_flows, scalar

# Quadrature grid for the round-trip projection (2 nm over the render range).
_QUAD_N = 156


def _normalize_lambda(lam):
    return (lam - cie.LAMBDA_MIN) / (cie.LAMBDA_MAX - cie.LAMBDA_MIN)


def sigmoid(z):
    return 0.5 + 0.5 * z / torch.sqrt(1.0 + z * z)


def eval_sigmoid(coeffs, lam):
    """Evaluate a fitted spectrum. coeffs: (..., 3); lam: (..., S) -> (..., S)."""
    x = _normalize_lambda(lam)
    z = (coeffs[..., 0:1] * x + coeffs[..., 1:2]) * x + coeffs[..., 2:3]
    return sigmoid(z)


@functools.cache
def _projection(cs_name: str):
    """(3, K) matrix taking spectrum samples on the quad grid to linear RGB,
    normalized so reflectance 1 under D65 maps to RGB (1, 1, 1)."""
    cs = colorspace.COLOR_SPACES[cs_name]
    lam = np.linspace(cie.LAMBDA_MIN, cie.LAMBDA_MAX, _QUAD_N)
    cmf = cie.cie_xyz_np(lam)  # (K, 3)
    illum = cie.illuminant_d65_np(lam)  # (K,)
    norm = float(np.sum(cmf[:, 1] * illum))
    xyz_from_s = (cmf * illum[:, None]).T / norm  # (3, K)
    white_xyz = colorspace._xyy_to_xyz(*cs.white_xy)
    xyz_from_s = xyz_from_s * (white_xyz / xyz_from_s.sum(axis=1))[:, None]
    rgb_from_s = cs.rgb_from_xyz @ xyz_from_s
    return (
        np.asarray(rgb_from_s, dtype=np.float32),
        np.asarray(lam, dtype=np.float32),
    )


def _solve3_np(m, b):
    """Closed-form (adjugate/Cramer) batched 3x3 solve, singular -> 0."""
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    inv_det = np.where(np.abs(det) > 1e-20, 1.0 / np.where(det == 0, 1, det), 0.0)
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    adj = np.stack(
        [
            np.stack([c00, c10, c20], axis=-1),
            np.stack([c01, c11, c21], axis=-1),
            np.stack([c02, c12, c22], axis=-1),
        ],
        axis=-2,
    )
    return np.einsum("...ij,...j->...i", adj, b) * inv_det[..., None]


def _fit_albedo_np(rgb, cs_name: str, iters: int) -> np.ndarray:
    """Damped Newton fit (float32 numpy) of reflectance RGBs in [0, 1]."""
    rgb_from_s, lam = _projection(cs_name)
    x = np.asarray(_normalize_lambda(lam), np.float32)
    basis = np.stack([x * x, x, np.ones_like(x)], axis=-1)  # (K, 3)
    rgb = np.asarray(rgb, dtype=np.float32)
    shape = rgb.shape
    target = np.clip(rgb, 1e-4, 0.9999).reshape(-1, 3)

    # Start from the constant spectrum matching the channel mean.
    m = np.clip(np.mean(target, axis=-1, keepdims=True), 1e-3, 0.999)
    z0 = (m - 0.5) / np.sqrt(np.maximum(m * (1.0 - m), 1e-6))
    c0 = np.concatenate([np.zeros_like(z0), np.zeros_like(z0), z0], axis=-1)

    damp = (1e-6 * np.eye(3)).astype(np.float32)
    c = c0.astype(np.float32)
    for _ in range(iters):
        z = c @ basis.T  # (N, K)
        s = 0.5 + 0.5 * z / np.sqrt(1.0 + z * z)
        r = s @ rgb_from_s.T - target  # (N, 3)
        ds = (0.5 / np.sqrt((1.0 + z * z) ** 3)).astype(np.float32)
        J = np.einsum("ik,nk,kj->nij", rgb_from_s, ds, basis)  # (N, 3, 3)
        JtJ = np.einsum("nij,nik->njk", J, J) + damp
        Jtr = np.einsum("nij,ni->nj", J, r)
        delta = _solve3_np(JtJ, Jtr)
        c = c - np.clip(delta, -50.0, 50.0)
    return c.reshape(shape)


def fit_albedo(rgb, cs_name: str = "srgb", iters: int = 40) -> torch.Tensor:
    """Sigmoid-polynomial coefficients (..., 3) for reflectance RGBs (...,3).

    Host-side fit; returns a float32 CPU tensor.
    """
    return torch.from_numpy(
        np.ascontiguousarray(_fit_albedo_np(rgb, cs_name, iters), np.float32)
    )


def _solve3(m, b):
    """Closed-form (adjugate) batched 3x3 solve of tensors, singular -> 0."""
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    ok = torch.abs(det) > 1e-20
    if grad_flows(det):
        # The division sees 1 where det is singular, so that its gradient
        # there is 0 and not 0 * inf (the reference's where passes NaN;
        # its damped Newton matrices are never singular).
        det = torch.where(ok, det, 1.0)
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    x0 = c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2]
    x1 = c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2]
    x2 = c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]
    return torch.stack([x0, x1, x2], dim=-1) * inv_det[..., None]


def _clip(x, lo: float, hi: float):
    """jnp.clip: the values of torch.clamp, but under a gradient a tie
    with a bound passes half of it, as the reference's minimum(maximum(x,
    lo), hi) does (torch.clamp passes all of it)."""
    if not grad_flows(x):
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, scalar(lo, x.device)),
                         scalar(hi, x.device))


@functools.cache
def _fit_tables(cs_name: str, device: torch.device):
    """The per-ray fit's constants on `device`, made once per device: a
    copy from pageable host memory would synchronize the stream at every
    call. Returns (basis^T (3, K), rgb_from_s^T (K, 3), jac (K, 9)) with
    jac[k, 3 i + j] = rgb_from_s[i, k] basis[k, j]."""
    rgb_from_s, lam = _projection(cs_name)
    x = _normalize_lambda(lam.astype(np.float32))
    basis = np.stack([x * x, x, np.ones_like(x)], axis=-1)  # (K, 3)
    jac = (rgb_from_s.T[:, :, None] * basis[:, None, :]).reshape(-1, 9)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                 for a in (basis.T, rgb_from_s.T, jac))


def fit_albedo_rays(rgb: torch.Tensor, cs_name: str = "srgb",
                    iters: int = 12) -> torch.Tensor:
    """The damped Newton fit of `fit_albedo` as tensor code on rgb's
    device, for per-ray values (..., 3) -> (..., 3): the reference's
    traced `_fit_albedo_jnp`. The Jacobian M diag(sigmoid'(z)) [x^2 x 1]
    is one (N, K) x (K, 9) product; sums run in another order than XLA's
    einsums, so coefficients agree with the reference's to a tolerance,
    not bit for bit. Autograd differentiates through the 12 steps as JAX
    does through the reference's."""
    dev = rgb.device
    basis_t, proj_t, jac = _fit_tables(cs_name, dev)
    shape = rgb.shape
    target = _clip(rgb.to(torch.float32), 1e-4, 0.9999).reshape(-1, 3)

    # Start from the constant spectrum matching the channel mean.
    m = _clip(torch.mean(target, dim=-1, keepdim=True), 1e-3, 0.999)
    z0 = (m - 0.5) / torch.sqrt(torch.maximum(m * (1.0 - m),
                                              scalar(1e-6, dev)))
    c = torch.cat([torch.zeros_like(z0), torch.zeros_like(z0), z0], dim=-1)
    damp = 1e-6 * torch.eye(3, dtype=torch.float32, device=dev)
    for _ in range(iters):
        z = c @ basis_t  # (N, K)
        r = sigmoid(z) @ proj_t - target  # (N, 3)
        ds = 0.5 * torch.rsqrt((1.0 + z * z) ** 3)  # sigmoid'(z)
        J = (ds @ jac).reshape(-1, 3, 3)
        JtJ = torch.sum(J[:, :, :, None] * J[:, :, None, :], dim=1) + damp
        Jtr = torch.sum(J * r[:, :, None], dim=1)
        c = c - _clip(_solve3(JtJ, Jtr), -50.0, 50.0)
    return c.reshape(shape)


def fit_unbounded(rgb, cs_name: str = "srgb"):
    """Fit RGBs outside [0, 1] (e.g. emission): returns (coeffs, scale).

    Spectrum value = scale * sigmoid_poly(lam) (RGBUnboundedSpectrum).
    """
    rgb = np.asarray(rgb, dtype=np.float32)
    m = np.max(rgb, axis=-1, keepdims=True)
    scale = 2.0 * m
    safe = np.where(scale > 0.0, rgb / np.where(scale == 0.0, 1.0, scale), 0.0)
    return fit_albedo(safe, cs_name), torch.from_numpy(
        np.ascontiguousarray(scale[..., 0], np.float32)
    )


def eval_unbounded(coeffs, scale, lam):
    return scale[..., None] * eval_sigmoid(coeffs, lam)


def eval_illuminant(coeffs, scale, lam):
    """Unbounded sigmoid modulated by D65, normalized so RGB (1, 1, 1) is a
    unit-luminance D65-shaped emitter (RGBIlluminantSpectrum)."""
    d65 = cie.illuminant_d65(lam) * (1.0 / 100.0)
    return scale[..., None] * eval_sigmoid(coeffs, lam) * d65
