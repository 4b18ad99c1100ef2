from .bvh import BVHArrays, build_bvh

__all__ = ["BVHArrays", "build_bvh"]
