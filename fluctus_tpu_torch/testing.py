"""Small built-in scenes for smoke tests and the sharded checks (the
reference package's testing.py), on the port's own builders: the BVH
(``accel.build_bvh``), the cluster tables (``MXUScene.build`` uploaded by
``tables_from_numpy``) and ``EnvironmentMap``. ``quad_scene`` and
``egyptcat_scene`` trace through the bitstack BVH (no tables, as the
reference's), ``mxu_block_scene`` through the cluster tables. Each
returns tensors on ``device``: CUDA unless the caller passes the CPU."""

from __future__ import annotations

import os

import numpy as np
import torch

from . import bxdf_types as bx
from .accel import build_bvh
from .accel import mxu_trace as mt
from .accel.traverse import BVHDevice
from .core import pixel_ring
from .core.trace import DeviceScene, TrianglesDevice, make_tri_frames
from .envmap import EnvironmentMap
from .geom import (AreaLight, Camera, PostProcessParams, RenderConfig,
                   RenderParams)
from .renderer import resolve_device
from .scene import Scene, default_material, pack_atlas
from .scene.material import materials_to_soa


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def _tables(p, n, uv, mid, materials, device, atlas=None, cluster_size=256):
    host, statics = mt.MXUScene.build(p, build_bvh(p),
                                      cluster_size=cluster_size, normals=n,
                                      uvs=uv, mat_ids=mid,
                                      materials=materials, atlas=atlas)
    return mt.tables_from_numpy(host, statics, device)


def _uniform_env(device):
    return EnvironmentMap.from_array(
        np.ones((16, 32, 3), np.float32)).device_tables(device)


def quad_arrays(kd: float = 0.5, size: float = 50.0):
    """quad_scene's host arrays: (positions, normals, uvs, material ids,
    materials)."""
    p = np.array([
        [[-size, -size, 0.0], [size, -size, 0.0], [size, size, 0.0]],
        [[-size, -size, 0.0], [size, size, 0.0], [-size, size, 0.0]],
    ], np.float32)
    n = np.zeros_like(p)
    n[..., 2] = 1.0
    t = np.zeros((2, 3, 2), np.float32)
    mat = default_material()
    mat.Kd = (kd, kd, kd)
    return p, n, t, np.zeros(2, np.int32), [mat]


def bitstack_scene(p, n, uv, mid, materials, material_types, device, *,
                   env=None, atlas=None, tri_frames=None) -> DeviceScene:
    """A DeviceScene without tables: the triangle arrays, the SAH BVH of
    ``p`` and the materials, traced through the bitstack BVH."""
    return DeviceScene(
        material_types=material_types, env=env,
        atlas=atlas if atlas is not None else pack_atlas([], device=device),
        tri_frames=tri_frames,
        tris=TrianglesDevice.from_arrays(p, n, uv, mid, device=device),
        mats=materials_to_soa(materials, device=device),
        bvh=BVHDevice.from_host(build_bvh(p), device=device))


def quad_scene(kd: float = 0.5, size: float = 50.0, with_env: bool = True,
               device=None) -> DeviceScene:
    """A large diffuse quad at z=0 facing +z under a uniform env map,
    traced through its BVH (no tables, as the reference's)."""
    dev = resolve_device(device)
    return bitstack_scene(*quad_arrays(kd, size), bx.BXDF_DIFFUSE, dev,
                          env=_uniform_env(dev) if with_env else None)


def quad_setup(width: int = 32, height: int = 32, max_bounces: int = 3,
               use_area_light: bool = False, device=None, **cfg_kw):
    """quad_scene's camera, light, params and config: the flat pixel ring
    (the reference's default) unless ``cfg_kw`` says otherwise. Returns
    (params, config)."""
    dev = resolve_device(device)
    cam = Camera.make(pos=(0, 0, 5), dir=(0, 0, -1), up=(0, 1, 0),
                      right=(1, 0, 0), fov=40.0, device=dev)
    light = AreaLight.make(pos=(0, 0, 4), N=(0, 0, -1), right=(1, 0, 0),
                           up=(0, 1, 0), E=(10, 10, 10), size=(0.5, 0.5),
                           device=dev)
    params = RenderParams(camera=cam, area_light=light,
                          world_radius=_f32(80.0, dev),
                          pp=PostProcessParams(_f32(1.0, dev), 0),
                          env_map_strength=_f32(1.0, dev))
    cfg_kw.setdefault("block_ring", False)
    config = RenderConfig(width=width, height=height, max_bounces=max_bounces,
                          use_env_map=True, use_area_light=use_area_light,
                          material_types=bx.BXDF_DIFFUSE, **cfg_kw)
    return params, config


def mxu_block_scene(width: int = 32, height: int = 16, groups: int = 16,
                    num_tasks: int = 2048, max_bounces: int = 3,
                    device=None):
    """The production configuration at test size: the cluster-table trace
    and the winner resolve (baked materials) on the block-bound pool with
    its per-group film splat, over multi-cluster geometry (a 16x16 relief
    grid of quads from a numpy seed, 512 triangles in 4 clusters of 128,
    as the reference's) with diffuse and GGX rough reflection cells under
    a uniform env map. The sharded checks split its groups over ranks.
    The cluster size keeps it on the plain versions: the card's trace
    kernels take clusters of 256.

    Returns (scene, params, config)."""
    dev = resolve_device(device)
    cells = 16
    size = 8.0
    step = 2 * size / cells
    tris, norms = [], []
    rng = np.random.default_rng(7)
    zs = rng.random((cells, cells)).astype(np.float32) * 0.8
    for i in range(cells):
        for j in range(cells):
            x0 = -size + i * step
            y0 = -size + j * step
            z = float(zs[i, j])
            a = [x0, y0, z]
            b = [x0 + step, y0, z]
            c = [x0 + step, y0 + step, z]
            e = [x0, y0 + step, z]
            tris += [[a, b, c], [a, c, e]]
            norms += [[[0, 0, 1]] * 3] * 2
    p = np.asarray(tris, np.float32)
    n = np.asarray(norms, np.float32)
    uv = np.zeros((len(p), 3, 2), np.float32)
    mid = (np.arange(len(p)) // 2 % 2).astype(np.int32)

    m0 = default_material()
    m0.Kd = (0.6, 0.5, 0.4)
    m1 = default_material()
    m1.Kd = (0.05, 0.05, 0.05)
    m1.Ks = (0.8, 0.8, 0.8)
    m1.Ns = 80.0
    m1.type = bx.BXDF_GGX_ROUGH_REFLECTION
    mats = [m0, m1]
    mtypes = bx.BXDF_DIFFUSE | bx.BXDF_GGX_ROUGH_REFLECTION
    scene = DeviceScene(
        mxu=_tables(p, n, uv, mid, mats, dev, cluster_size=128),
        material_types=mtypes, env=_uniform_env(dev),
        atlas=pack_atlas([], device=dev))
    cam = Camera.make(pos=(0, -14, 10), dir=(0, 0.7, -0.55), up=(0, 0, 1),
                      right=(1, 0, 0), fov=55.0, device=dev)
    light = AreaLight.make(pos=(0, 0, 6), N=(0, 0, -1), right=(1, 0, 0),
                           up=(0, 1, 0), E=(10, 10, 10), size=(0.5, 0.5),
                           device=dev)
    params = RenderParams(camera=cam, area_light=light,
                          world_radius=_f32(3.0 * size, dev),
                          pp=PostProcessParams(_f32(1.0, dev), 0),
                          env_map_strength=_f32(1.0, dev))
    config = RenderConfig(width=width, height=height,
                          max_bounces=max_bounces, use_env_map=True,
                          use_area_light=False, material_types=mtypes,
                          block_ring=True, groups=groups)
    pixel_ring.geometry(config, num_tasks)   # validate it eagerly
    return scene, params, config


def egyptcat_scene(assets: str, width: int = 64, height: int = 32,
                   max_bounces: int = 3, device=None, **cfg_kw):
    """The flagship scene at test size: ``egyptcat/egyptcat.obj`` (GGX and
    textures) under ``env_maps/night.hdr``, both read from the asset
    directory ``assets`` (a missing file raises, as the reference's), with
    the texture atlas, the env map's tables and the BVH on the device
    (traced through the BVH, as the reference's).

    Returns (scene, params, config)."""
    dev = resolve_device(device)
    sc = Scene()
    sc.load_model(os.path.join(assets, "egyptcat", "egyptcat.obj"))
    sc.load_env_map(os.path.join(assets, "env_maps", "night.hdr"))
    p, n, uv, mid = sc.triangle_arrays()
    atlas = sc.device_textures(device=dev)
    normal_maps = atlas.count > 0 and atlas.has_n
    scene = bitstack_scene(
        p, n, uv, mid, sc.materials, sc.material_types, dev,
        env=sc.envmap.device_tables(dev), atlas=atlas,
        tri_frames=(make_tri_frames(p, uv, device=dev) if normal_maps
                    else None))
    cam = Camera.make(pos=(0.0, 1.1, 3.2), dir=(0.0, -0.25, -1.0),
                      up=(0, 1, 0), right=(1, 0, 0), fov=50.0, device=dev)
    light = AreaLight.make(pos=(0, 3, 0), N=(0, -1, 0), right=(1, 0, 0),
                           up=(0, 0, 1), E=(10, 10, 10), size=(0.5, 0.5),
                           device=dev)
    params = RenderParams(camera=cam, area_light=light,
                          world_radius=_f32(sc.world_radius(), dev),
                          pp=PostProcessParams(_f32(1.0, dev), 0),
                          env_map_strength=_f32(1.0, dev))
    cfg_kw.setdefault("block_ring", False)
    config = RenderConfig(width=width, height=height,
                          max_bounces=max_bounces, use_env_map=True,
                          use_area_light=False,
                          material_types=sc.material_types, **cfg_kw)
    return scene, params, config
