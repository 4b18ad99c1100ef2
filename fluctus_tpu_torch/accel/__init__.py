from .bvh import BVHArrays, build_bvh, export_bvh, import_bvh

__all__ = ["BVHArrays", "build_bvh", "export_bvh", "import_bvh"]
