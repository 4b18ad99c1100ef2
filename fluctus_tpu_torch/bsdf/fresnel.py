"""Dielectric Fresnel terms (src/fresnel.cl)."""

from __future__ import annotations

import torch


def fresnel_dielectric(cos_th_i, eta_i, eta_t):
    """Exact unpolarized dielectric Fresnel (fresnel.cl:5-32); 1.0 under
    total internal reflection."""
    f, _ = fresnel_dielectric_cos_t(cos_th_i, eta_i, eta_t)
    return f


def fresnel_dielectric_cos_t(cos_th_i, eta_i, eta_t):
    """Variant also returning cosThetaT (fresnel.cl:35-62)."""
    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_th_i * cos_th_i, 0.0))
    sin_t = eta_i / eta_t * sin_i
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 0.0))

    etat_cosi = eta_t * cos_th_i
    etai_cost = eta_i * cos_t
    parl = (etat_cosi - etai_cost) / torch.where(
        etat_cosi + etai_cost == 0.0, 1.0, etat_cosi + etai_cost)
    etai_cosi = eta_i * cos_th_i
    etat_cost = eta_t * cos_t
    perp = (etai_cosi - etat_cost) / torch.where(
        etai_cosi + etat_cost == 0.0, 1.0, etai_cosi + etat_cost)

    f = 0.5 * (parl * parl + perp * perp)
    return torch.where(sin_t >= 1.0, 1.0, f), cos_t
