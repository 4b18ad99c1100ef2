from .material import HostMaterial, default_material, infer_type, to_roughness
from .scene import ModelTransform, Scene
from .texture import HostTexture, TextureAtlas, atlas_from_numpy, pack_atlas

__all__ = ["HostMaterial", "HostTexture", "ModelTransform", "Scene",
           "TextureAtlas", "atlas_from_numpy", "default_material",
           "infer_type", "pack_atlas", "to_roughness"]
