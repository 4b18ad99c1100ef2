from .material import HostMaterial, default_material, infer_type, to_roughness
from .scene import Scene

__all__ = ["HostMaterial", "Scene", "default_material", "infer_type",
           "to_roughness"]
