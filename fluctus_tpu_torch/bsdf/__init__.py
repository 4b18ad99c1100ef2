from .dispatch import (ShadingParams, apply_textures, bxdf_eval, bxdf_pdf,
                       bxdf_sample)
from .fresnel import fresnel_dielectric, fresnel_dielectric_cos_t

__all__ = ["ShadingParams", "apply_textures", "bxdf_eval", "bxdf_pdf",
           "bxdf_sample", "fresnel_dielectric", "fresnel_dielectric_cos_t"]
