"""GGX microfacet lobes (Walter et al. 2007; the reference package's
bsdf/ggx.py, a vectorized port of src/ggx.cl): rough reflection (GTR2 D,
Smith G, half-vector Jacobian pdf) and rough dielectric transmission with
the refraction half-vector and focus term. Plain tensor functions over a
batch. dir_in points toward the surface; alpha is the material's Ns after
the toRoughness remap (scene.cpp:13-16).
"""

from __future__ import annotations

import torch

from ..sampling import PI, TWO_PI, make_ortho_basis
from ..vec import Vec3, dot, normalize, reflect0, refract1
from ..vec import where as vwhere
from .fresnel import fresnel_dielectric, fresnel_dielectric_cos_t


def _safe_div(num, den):
    """num / den where den != 0, else 0 (the reference's where pairs)."""
    return torch.where(den != 0.0,
                       num / torch.where(den == 0.0, 1.0, den), 0.0)


def ggx_sample_lobe(alpha, n: Vec3, u1, u2) -> Vec3:
    """Importance-sample the half-vector lobe (ggx.cl:20-39, eq. 35-36)."""
    x, y = make_ortho_basis(n)
    theta = torch.atan2(alpha * torch.sqrt(u1),
                        torch.sqrt(torch.clamp_min(1.0 - u1, 0.0)))
    phi = TWO_PI * u2
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    return x * (st * cp) + y * (st * sp) + n * ct


def ggx_g1(alpha, v: Vec3, n: Vec3, m: Vec3):
    """Unidirectional Smith shadowing (ggx.cl:43-56, eq. 34)."""
    m_dot_v = dot(m, v)
    n_dot_v = dot(n, v)
    cos_sq = n_dot_v * n_dot_v
    tan_sq = torch.where(cos_sq > 0.0,
                         (1.0 - cos_sq) / torch.clamp_min(cos_sq, 1e-30), 0.0)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * tan_sq))
    return torch.where(n_dot_v * m_dot_v <= 0.0, 0.0, g)


def ggx_g(alpha, d_in: Vec3, d_out: Vec3, n: Vec3, m: Vec3):
    return ggx_g1(alpha, d_in, n, m) * ggx_g1(alpha, d_out, n, m)


def ggx_d(alpha, n: Vec3, m: Vec3):
    """GTR2 microfacet distribution (ggx.cl:65-81, eq. 33)."""
    n_dot_m = dot(n, m)
    nm_sq = n_dot_m * n_dot_m
    tan_sq = (1.0 - nm_sq) / torch.clamp_min(nm_sq, 1e-30)
    a_sq = alpha * alpha
    denom = PI * nm_sq * nm_sq * (a_sq + tan_sq) ** 2
    return torch.where(n_dot_m <= 0.0, 0.0,
                       a_sq / torch.clamp_min(denom, 1e-30))


def ggx_pdf_reflect(alpha, d_out: Vec3, n: Vec3, h: Vec3):
    """pdf of a sampled reflection direction (ggx.cl:84-91, eq. 24+14)."""
    n_dot_h = dot(n, h)
    o_dot_h = dot(d_out, h)
    pdf = ggx_d(alpha, n, h) * torch.abs(
        n_dot_h * 0.25 / torch.where(o_dot_h == 0.0, 1.0, o_dot_h))
    return torch.where(o_dot_h == 0.0, 0.0, pdf)


def ggx_pdf_refract(alpha, eta_i, eta_o, d_in: Vec3, d_out: Vec3, n: Vec3,
                    h: Vec3):
    """pdf of a sampled refraction direction (ggx.cl:150-157, eq. 24+17)."""
    n_dot_h = torch.abs(dot(n, h))
    i_dot_h = torch.abs(dot(d_in, h))
    o_dot_h = torch.abs(dot(d_out, h))
    sqrt_j_inv = eta_i * i_dot_h + eta_o * o_dot_h
    pdf = (ggx_d(alpha, n, h) * n_dot_h * o_dot_h * eta_o * eta_o
           / torch.clamp_min(sqrt_j_inv * sqrt_j_inv, 1e-30))
    return torch.where(sqrt_j_inv == 0.0, 0.0, pdf)


# ---------------------------------------------------------------------------
# Rough reflection (ggx.cl:93-147)
# ---------------------------------------------------------------------------

def sample_reflect(n: Vec3, ks: Vec3, alpha, ni, dir_in: Vec3, u1, u2):
    """Returns (d_out, pdf, brdf)."""
    h = ggx_sample_lobe(alpha, n, u1, u2)
    d_out = reflect0(dir_in, h)
    pdf = ggx_pdf_reflect(alpha, d_out, n, h)
    brdf = _eval_reflect_with_h(n, ks, alpha, ni, -dir_in, d_out, h)
    return d_out, pdf, brdf


def _eval_reflect_with_h(n, ks, alpha, ni, d_in_n, d_out, h):
    i_dot_n = dot(d_in_n, n)
    o_dot_n = dot(d_out, n)
    f = torch.where(ni > 1.0, fresnel_dielectric(
        i_dot_n, 1.0, torch.clamp_min(ni, 1.0 + 1e-6)), 1.0)
    d = ggx_d(alpha, n, h)
    g = ggx_g(alpha, d_in_n, d_out, n, h)
    return ks * _safe_div(f * g * d * 0.25, i_dot_n * o_dot_n)


def eval_reflect(n: Vec3, ks: Vec3, alpha, ni, dir_in: Vec3, dir_out: Vec3):
    h = normalize(dir_out - dir_in)
    return _eval_reflect_with_h(n, ks, alpha, ni, -dir_in, dir_out, h)


def pdf_reflect(n: Vec3, alpha, dir_in: Vec3, dir_out: Vec3):
    h = normalize(dir_out - dir_in)
    return ggx_pdf_reflect(alpha, dir_out, n, h)


# ---------------------------------------------------------------------------
# Rough dielectric (ggx.cl:159-305)
# ---------------------------------------------------------------------------

def _focus(eta_i, eta_o, i_dot_n, o_dot_n, i_dot_h, o_dot_h):
    den = i_dot_n * o_dot_n * (eta_i * i_dot_h + eta_o * o_dot_h) ** 2
    return _safe_div(eta_o * eta_o * i_dot_h * o_dot_h, den)


def sample_refract(n: Vec3, ks: Vec3, alpha, ni, backface, dir_in: Vec3,
                   u1, u2, u3):
    """Fresnel-weighted choice of reflection (u3 < F) or refraction about a
    sampled half-vector (ggx.cl:159-228). Returns (d_out, pdf, bsdf)."""
    d_in_n = -dir_in
    eta_i = torch.where(backface, ni, 1.0)
    eta_o = torch.where(backface, 1.0, ni)
    i_dot_n = dot(d_in_n, n)

    h = ggx_sample_lobe(alpha, n, u1, u2)
    f, cos_theta_t = fresnel_dielectric_cos_t(i_dot_n, eta_i, eta_o)
    choose_reflect = u3 < f

    # reflection
    d_refl = reflect0(dir_in, h)
    pdf_refl = ggx_pdf_reflect(alpha, d_refl, n, h)
    s = _safe_div(f * ggx_g(alpha, d_in_n, d_refl, n, h) * ggx_d(alpha, n, h)
                  * 0.25, i_dot_n * dot(d_refl, n))
    bsdf_refl = Vec3(s, s, s)

    # refraction
    eta = eta_i / eta_o
    d_refr = refract1(dir_in, n, eta, i_dot_n, cos_theta_t)
    n_side = vwhere(backface, -n, n)
    h2 = normalize(dir_in * eta_i - d_refr * eta_o)
    pdf_refr = ggx_pdf_refract(alpha, eta_i, eta_o, d_in_n, d_refr, n_side,
                               h2)
    focus = _focus(eta_i, eta_o, i_dot_n, dot(d_refr, n),
                   torch.abs(dot(dir_in, h2)), torch.abs(dot(d_refr, h2)))
    d_t = ggx_d(alpha, n_side, h2)
    g_t = ggx_g(alpha, d_in_n, d_refr, n_side, h2)
    bsdf_refr = ks * ((1.0 - f) * (eta * eta) * d_t * g_t * focus)

    return (vwhere(choose_reflect, d_refl, d_refr),
            torch.where(choose_reflect, pdf_refl, pdf_refr),
            vwhere(choose_reflect, bsdf_refl, bsdf_refr))


def eval_refract(n: Vec3, ks: Vec3, alpha, ni, backface, dir_in: Vec3,
                 dir_out: Vec3):
    """Two-sided eval (ggx.cl:230-285): a front face evaluates reflection,
    a back face transmission, as the reference's branches."""
    d_in_n = -dir_in
    eta_i = torch.where(backface, ni, 1.0)
    eta_o = torch.where(backface, 1.0, ni)
    i_dot_n = dot(d_in_n, n)
    o_dot_n = dot(dir_out, n)
    f = fresnel_dielectric(i_dot_n, eta_i, eta_o)

    h_r = normalize(dir_out - dir_in)
    s = _safe_div(f * ggx_g(alpha, d_in_n, dir_out, n, h_r)
                  * ggx_d(alpha, n, h_r) * 0.25, i_dot_n * o_dot_n)
    refl = Vec3(s, s, s)

    h_t = normalize(dir_in * eta_i - dir_out * eta_o)
    eta = eta_i / eta_o
    focus = _focus(eta_i, eta_o, i_dot_n, o_dot_n,
                   torch.abs(dot(dir_in, h_t)), torch.abs(dot(dir_out, h_t)))
    neg_n = -n
    refr = ks * ((1.0 - f) * (eta * eta) * ggx_d(alpha, neg_n, h_t)
                 * ggx_g(alpha, d_in_n, dir_out, neg_n, h_t) * focus)
    return vwhere(backface, refr, refl)


def pdf_refract(n: Vec3, alpha, ni, backface, dir_in: Vec3, dir_out: Vec3):
    """ggx.cl:287-305."""
    h_r = normalize(dir_out - dir_in)
    p_refl = ggx_pdf_reflect(alpha, dir_out, n, h_r)
    eta_i = torch.where(backface, ni, 1.0)
    eta_o = torch.where(backface, 1.0, ni)
    h_t = normalize(dir_in * eta_i - dir_out * eta_o)
    p_refr = ggx_pdf_refract(alpha, eta_i, eta_o, -dir_in, dir_out, -n, h_t)
    return torch.where(backface, p_refr, p_refl)
