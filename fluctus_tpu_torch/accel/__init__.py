from .bvh import BVHArrays, SplitMode, build_bvh, export_bvh, import_bvh

__all__ = ["BVHArrays", "SplitMode", "build_bvh", "export_bvh", "import_bvh"]
