from .material import HostMaterial, default_material, infer_type, to_roughness
from .scene import ModelTransform, Scene

__all__ = ["HostMaterial", "ModelTransform", "Scene", "default_material",
           "infer_type", "to_roughness"]
