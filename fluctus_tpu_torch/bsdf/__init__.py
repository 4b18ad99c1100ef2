from .dispatch import (ShadingParams, apply_textures, bsdf_shade, bxdf_eval,
                       bxdf_pdf, bxdf_sample, resolve_material)
from .fresnel import fresnel_dielectric, fresnel_dielectric_cos_t

__all__ = ["ShadingParams", "apply_textures", "bsdf_shade", "bxdf_eval",
           "bxdf_pdf", "bxdf_sample", "fresnel_dielectric",
           "fresnel_dielectric_cos_t", "resolve_material"]
