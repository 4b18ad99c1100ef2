from .dispatch import (ShadingParams, apply_textures, bxdf_eval, bxdf_pdf,
                       bxdf_sample, check_lobes)
from .fresnel import fresnel_dielectric, fresnel_dielectric_cos_t

__all__ = ["ShadingParams", "apply_textures", "bxdf_eval", "bxdf_pdf",
           "bxdf_sample", "check_lobes", "fresnel_dielectric",
           "fresnel_dielectric_cos_t"]
