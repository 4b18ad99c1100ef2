"""High-level renderer (src/tracer.cpp; the reference package's
renderer.py): scene load -> BVH (behind the hierarchy cache) -> cluster
tables (behind the table cache) -> device upload, render
parameters, the free-running wavefront loop, exact-spp rendering
(``render_single``: the capped wavefront, or the microkernel megastep
under ``flags.FORCE_MK``), saved render state (``state_io``) and film
checkpoints, the denoiser, picking and image output.

``Renderer`` runs on ``"cuda"`` unless the caller passes ``device="cpu"``
(the CPU tests, which then run each kernel's plain PyTorch version).
Without CUDA and without ``device="cpu"`` it raises.

The caches live under ``data_dir`` (default ``data``, as the reference),
keyed by the scene's content hash: ``hierarchies/hierarchy_<hash>.bin``
(the BVH, the reference's binary format) and ``mxu_tables/mxu_<hash>_...
.npz`` (the host tables, the reference's npz layout). Both packages read
and write the same files. A miss builds and writes; a hit builds nothing.
So do the saved render states (``states/state_<hash>.dat``) and the film
checkpoints (npz).
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import flags, state_io
from .accel import build_bvh, export_bvh, import_bvh
from .accel import mxu_trace as mt
from .native import build_bvh_native, build_sbvh_native
from .core.camera import generate_camera_rays
from .core.denoise import atrous_denoise
from .core.integrator_mk import FeatureFilm, Film, RenderStats, render_sample
from .core.integrator_wf import (pad_pixels, padded_to_true_pid,
                                 salt_seeds, unpad_pixels, wf_reset,
                                 wf_segment, wf_shade_phase, wf_trace_phase)
from .core.tonemap import postprocess
from .core.trace import (DeviceScene, TrianglesDevice, make_tri_frames,
                         trace_extension)
from .geom import AreaLight, Camera, PostProcessParams, RenderConfig, RenderParams
from .image_io import save_hdr, save_png
from .profiling import span
from .progress import ProgressView
from .scene import Scene
from .settings import Settings
from .vec import Vec3


def resolve_device(device=None) -> torch.device:
    """The render device: CUDA by default; CPU only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def table_cache_path(data_dir: str, scene: Scene, split_mode: str,
                     slim: bool) -> str:
    """The reference's table-cache file name (renderer.py:118-131): scene
    hash, a blake2b-48 of the materials (their parameters are baked into
    the tables, so an edit misses the cache), split mode, cluster size and
    supercluster granularity, slim, TABLE_VERSION."""
    mh = hashlib.blake2b(repr([m.__dict__ for m in scene.materials])
                         .encode(), digest_size=6).hexdigest()
    return os.path.join(
        data_dir, "mxu_tables",
        f"mxu_{scene.hash}_{mh}_{split_mode}_c256s{mt.SC_CLUSTERS}"
        f"{'_slim' if slim else ''}_v{mt.TABLE_VERSION}.npz")


def _tree_map(fn, tree):
    """``fn`` on every tensor of a Film, FeatureFilm or Vec3."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_tree_map(fn, x) for x in tree))


class CappedStats(NamedTuple):
    """The capped ring's counters over one exact-spp wavefront call."""
    segments: int      # segments run
    lanes: int         # the pool's lanes
    held: int          # lane-segments held idle: the pixel had its target
    admitted: int      # splat records admitted (K7, or the flat ring's)


def _restored_samples(film: Film) -> int:
    """The samples a restored film holds (its weights' sum, exact)."""
    return int(film.weight.to(torch.int64).sum())


class Renderer:
    def __init__(self, width: int, height: int,
                 settings: Optional[Settings] = None,
                 data_dir: str = "data", device=None):
        """A film of width x height, each scaled by
        ``settings.render_scale``."""
        self.device = resolve_device(device)
        self.settings = settings or Settings()
        s = self.settings
        self.data_dir = data_dir
        self.width = int(width * s.render_scale)
        self.height = int(height * s.render_scale)
        self.scene: Optional[Scene] = None
        self.device_scene: Optional[DeviceScene] = None
        self.config: Optional[RenderConfig] = None
        self.params: Optional[RenderParams] = None
        self.film: Optional[Film] = None
        self.features: Optional[FeatureFilm] = None
        self.seed = None
        self.stats = RenderStats.zeros()
        self.env_map_strength = 1.0
        self.exposure = 1.0
        self._wf_state = None
        self._wf_cfg: Optional[RenderConfig] = None
        self._wf_total = None        # int64[4] counters (RenderStats order)
        self._wf_segments = 0        # segments counted in _wf_total
        self._wf_exact_mode = False
        self._wf_held = None         # int64 0-d: capped lanes held idle
        self._film_src = "mk"

    # -- scene lifecycle (Tracer::init) -------------------------------------
    def load_scene(self, scene_file: str, env_map: Optional[str] = None,
                   use_saved_state: bool = True):
        """Load an OBJ, PLY, PBRT or ``.sc.json`` scene; the env map
        ``env_map`` (else ``settings.env_map_name``), which switches the env
        map on when the file exists and prints a WARNING when it does not
        (the reference's renderer.py:58-70); the camera a PBRT file
        carries, into ``settings.camera`` (renderer.py:72-80); then, with
        ``use_saved_state``, the scene's saved
        render state, ``data_dir/states/state_<hash>.dat``, when it exists:
        camera, area light, depth, light and sampling switches, env map
        strength and exposure, its ``use_env_map`` deciding the env map
        (renderer.py:82-90); its BVH from the hierarchy cache or built
        (``_init_hierarchy``); and its device tables
        (``_upload_device_scene``). ``load_seconds`` keeps the host time of
        each step and ``cache_hit`` whether the BVH and the tables came
        from the caches. Ends with ``reset()``."""
        s = self.settings
        t0 = time.perf_counter()
        scene = Scene()
        scene.load_model(scene_file)
        env_name = env_map or s.env_map_name
        use_env = s.use_env_map
        if env_name and os.path.exists(env_name):
            scene.load_env_map(env_name)
            use_env = True
        elif env_name:
            print(f"WARNING: env map not found: {env_name}")
        self.scene = scene
        co = scene.camera_override
        if co is not None:      # a PBRT camera, before the saved state
            c = s.camera
            c.pos, c.dir, c.up, c.right, c.fov = (co.pos, co.dir, co.up,
                                                  co.right, co.fov)
            s._calc_camera_rotation()
        spath = state_io.state_path(self.data_dir, scene.hash)
        if use_saved_state and scene.hash and os.path.exists(spath):
            self.env_map_strength, self.exposure = state_io.load_state(spath,
                                                                       s)
            use_env = s.use_env_map
            print(f"Loaded render state: {spath}")
        t1 = time.perf_counter()
        self._bvh_host, bvh_hit = self._init_hierarchy(scene)
        t2 = time.perf_counter()
        tables_hit = self._upload_device_scene(use_env)
        t3 = time.perf_counter()
        self.load_seconds = dict(load=t1 - t0, bvh=t2 - t1,
                                 **self._upload_seconds)
        self.cache_hit = dict(bvh=bvh_hit, tables=tables_hit)
        self.world_radius = scene.world_radius()
        self.params = self._make_params()
        self.reset()

    def _upload_device_scene(self, use_env: bool) -> bool:
        """The scene's cluster tables (slim past 65,536 triangles) from the
        table cache or built and cached (``MXUScene.build_cached``, with
        the texture atlas's descriptors baked in; a cache that baked other
        texture sizes is rebuilt), uploaded with the atlas and, when a
        material has a normal map, the triangles' tangent frames
        (``make_tri_frames``); the tables' content picks the resolve kernel
        (``resolve_hits_mxu``), and tables with neither ``attrs`` nor B16
        upload the triangle arrays and materials for the trace's third
        branch instead. Then ``_derive_config``. Also the material
        re-upload path (``reload_materials``). Returns whether the tables
        came from the cache."""
        scene = self.scene
        t0 = time.perf_counter()
        p, nrm, uv, mid = scene.triangle_arrays()
        slim = p.shape[0] > 65536
        cache = (table_cache_path(self.data_dir, scene,
                                  self.settings.split_mode, slim)
                 if scene.hash else None)
        atlas = scene.device_textures(device=self.device)
        tables_hit = mt.table_cache_fresh(cache, atlas)
        host, statics = mt.MXUScene.build_cached(
            cache, p, self._bvh_host, normals=nrm, uvs=uv, mat_ids=mid,
            materials=scene.materials, atlas=atlas, slim=slim)
        t1 = time.perf_counter()
        if slim:
            print(f"MXU tables: {statics['n_clusters']} clusters, "
                  f"{statics['n_superclusters']} supers ({t1 - t0:.2f}s)")
        normal_maps = atlas.count > 0 and atlas.has_n
        mxu = mt.tables_from_numpy(host, statics, self.device)
        # tables with neither attrs nor B16 (a table cache that stores B16
        # absent, on slim tables) take the trace's third branch, which
        # reads the triangle arrays and the materials
        bare = mxu.attrs is None and mxu.b16r is None
        self.device_scene = DeviceScene(
            mxu=mxu, material_types=scene.material_types,
            env=(scene.envmap.device_tables(self.device) if scene.envmap
                 else None),
            atlas=atlas,
            tri_frames=(make_tri_frames(p, uv, device=self.device)
                        if normal_maps else None),
            tris=(TrianglesDevice.from_arrays(p, nrm, uv, mid,
                                              device=self.device)
                  if bare else None),
            mats=(scene.device_materials(device=self.device) if bare
                  else None))
        self._upload_seconds = dict(tables=t1 - t0,
                                    upload=time.perf_counter() - t1)
        self._derive_config(use_env)
        return tables_hit

    def _init_hierarchy(self, scene: Scene):
        """BVH behind the binary hierarchy cache (Tracer::initHierarchy,
        tracer.cpp:934-952; the reference's renderer.py:234-274): a hit on
        ``data_dir/hierarchies/hierarchy_<hash>[_sbvh].bin`` builds
        nothing; a miss builds and writes the cache, unless the scene has
        no hash. ``split_mode == "sbvh"`` builds the spatial-split BVH
        natively at every size (``build_sbvh_native``); "sah" builds with
        the native SAH builder past 20,000 triangles and the numpy one
        below. A progress line shows on a terminal. Prints the reference's
        "BVH cache hit" / "BVH built" line. Returns (bvh, hit)."""
        cache_dir = os.path.join(self.data_dir, "hierarchies")
        sbvh = self.settings.split_mode == "sbvh"
        cache = os.path.join(cache_dir, f"hierarchy_{scene.hash}"
                             f"{'_sbvh' if sbvh else ''}.bin")
        t0 = time.time()
        if scene.hash and os.path.exists(cache):
            bvh = import_bvh(cache)
            print(f"BVH cache hit: {cache} ({time.time()-t0:.2f}s)")
            return bvh, True
        p = scene.triangle_arrays()[0]
        pv = ProgressView(enabled=sys.stderr.isatty())
        m = max(p.shape[0], 1)
        if sbvh:
            pv.show("Building SBVH")
            bvh = build_sbvh_native(p)
        elif p.shape[0] > 20000:
            pv.show("Building BVH")
            bvh = build_bvh_native(p)
        else:
            bvh = build_bvh(p, progress=lambda k: pv.show("Building BVH",
                                                          k / m))
        pv.hide()
        print(f"BVH built: {bvh.num_nodes} nodes, depth {bvh.depth()} "
              f"({time.time()-t0:.2f}s)")
        if scene.hash:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{cache}.{os.getpid()}.tmp"
            export_bvh(bvh, tmp)
            os.replace(tmp, cache)
        return bvh, False

    def _derive_config(self, use_env: bool):
        """Static RenderConfig from the settings and film size. The env map
        is on when ``use_env`` and the scene has one; on CUDA it takes the
        single-read forms (``fast_env``), as the reference on its TPU. The
        pool group count: a power of two with >= 4 pixels per group
        dividing the pool, at most 1/16 of its lanes on empty tail groups
        (target ~512 pixels per group). The block ring runs when such a
        count > 1 exists and ``FLT_BLOCK_RING`` (over
        ``settings.wf_block_ring``) is on; otherwise the flat pixel ring
        (the reference's renderer.py:177-178). The reference also takes the
        flat ring whenever it runs off its TPU; the port runs the block
        ring on both devices, so its CPU tests hold the card's path."""
        s = self.settings
        npx = self.width * self.height
        ntasks = s.wf_buffer_size

        def _lane_waste(g):
            p = -(-npx // g)
            return (g - -(-npx // p)) / g
        groups = 4096
        while groups > 1 and (npx < 4 * groups or ntasks % groups
                              or _lane_waste(groups) > 1 / 16):
            groups //= 2
        block = groups > 1 and flags.env_bool("BLOCK_RING", s.wf_block_ring)
        self.config = RenderConfig(
            width=self.width, height=self.height,
            max_bounces=s.max_path_depth,
            use_env_map=use_env and self.scene.envmap is not None,
            use_area_light=s.use_area_light,
            sample_impl=s.sample_implicit, sample_expl=s.sample_explicit,
            use_roulette=s.use_russian_roulette,
            fast_env=self.device.type == "cuda", max_spp=s.max_spp,
            material_types=self.scene.material_types,
            denoiser=s.use_denoiser, block_ring=block, groups=groups)

    def rebuild_config(self):
        """Re-derive the config's settings-driven fields (``use_env_map``,
        ``use_area_light``, ``sample_impl``, ``sample_expl``,
        ``use_roulette``, ``max_bounces``, ``max_spp``, ``denoiser``) and
        re-make the params from the current settings (the reference's
        rebuild_config, the paramsUpdatePending -> recompileKernels path,
        tracer.cpp:216-240): the call that picks up settings edits made
        after load_scene. As the reference's, it sets the env map from
        ``settings.use_env_map`` (and the scene having one); as the
        reference's, it leaves the pixel ring as load_scene chose it."""
        s = self.settings
        self.config = self.config.replace(
            use_env_map=s.use_env_map and self.scene.envmap is not None,
            use_area_light=s.use_area_light, sample_impl=s.sample_implicit,
            sample_expl=s.sample_explicit,
            use_roulette=s.use_russian_roulette,
            max_bounces=s.max_path_depth, max_spp=s.max_spp,
            denoiser=s.use_denoiser)
        self.params = self._make_params()

    def resize(self, width: int, height: int):
        """Re-create the film at a new resolution (the render-scale slider,
        tracer_ui.cpp:256-303): re-derives the pixel-dependent config,
        rebuilds the params and restarts accumulation; the wavefront pool
        is dropped (``init_wavefront`` makes a new one)."""
        self.width, self.height = max(1, int(width)), max(1, int(height))
        self._derive_config(self.config.use_env_map)
        self.params = self._make_params()
        self.reset()
        self._wf_state = None

    def reload_materials(self):
        """Re-upload materials and textures after host-side edits of
        ``scene.materials`` (a material type change re-derives
        ``RenderConfig.material_types``); the table cache's key holds the
        materials, so edited ones rebuild the tables. Restarts
        accumulation."""
        self.scene.material_types = 0
        for m in self.scene.materials:
            self.scene.material_types |= m.type
        self._upload_device_scene(self.config.use_env_map)
        self.params = self._make_params()
        self.reset()

    def _make_params(self) -> RenderParams:
        s = self.settings
        c = s.camera
        a = s.area_light
        dev = self.device
        cam = Camera.make(c.pos, c.dir, c.up, c.right, fov=c.fov,
                          aperture_size=c.aperture_size,
                          focal_dist=c.focal_dist, device=dev)
        light = AreaLight.make(a.pos, a.N, a.right, a.up, a.E, a.size,
                               device=dev)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        return RenderParams(
            camera=cam, area_light=light,
            world_radius=f32(self.world_radius),
            pp=PostProcessParams(exposure=f32(self.exposure),
                                 tm_operator=int(s.tonemap)),
            max_spp=torch.tensor(s.max_spp, dtype=torch.int32, device=dev),
            env_map_strength=f32(self.env_map_strength))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def save_state(self) -> str:
        """Save the camera, light and switches under the scene's hash
        (Tracer::saveState, tracer.cpp:1087-1090; F2 in the original
        renderer); ``load_scene`` restores them. Returns the path."""
        path = state_io.state_path(self.data_dir, self.scene.hash)
        state_io.save_state(path, self.settings, self.env_map_strength,
                            self.exposure)
        return path

    # -- film checkpoints ---------------------------------------------------
    def save_checkpoint(self, path: str) -> str:
        """Write the accumulation to ``path`` (npz, the reference's keys):
        scene hash, width, height, the film (true pixel layout), with a
        wavefront state its per-pixel spp, and the guide features when the
        denoiser is on. A later ``load_checkpoint`` resumes it. Returns
        the path."""
        film = (self.wavefront_film() if self._wf_state is not None
                else self.film)
        n = lambda a: a.detach().cpu().numpy()
        arrs = dict(
            scene_hash=np.asarray(self.scene.hash),
            width=np.int32(self.width), height=np.int32(self.height),
            color_x=n(film.color.x), color_y=n(film.color.y),
            color_z=n(film.color.z), weight=n(film.weight))
        if self._wf_state is not None:
            arrs["spp"] = n(unpad_pixels(self._wf_state.spp, self._wf_cfg))
        if self.features is not None:
            f = self.features
            arrs.update(feat_alb_x=n(f.albedo.x), feat_alb_y=n(f.albedo.y),
                        feat_alb_z=n(f.albedo.z), feat_alb_w=n(f.albedo_w),
                        feat_nrm_x=n(f.normal.x), feat_nrm_y=n(f.normal.y),
                        feat_nrm_z=n(f.normal.z), feat_nrm_w=n(f.normal_w))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, **arrs)
        return path

    def load_checkpoint(self, path: str) -> bool:
        """Restore a checkpoint into ``self.film`` (which
        ``render_single`` then continues) and, when a wavefront state is
        live, into its film, spp (padded on the block ring, dead slots
        parked at 2^29) and guide features. False, with a message, when
        the scene hash or the resolution differ.

        The samples that follow draw a stream of their own: the megastep's
        seeds and a live pool's are salted with the restored sample count
        (``salt_seeds``), as is the pool ``render_single`` starts on the
        restored film. The reference's restore keeps the fresh seeds
        (lane and pixel ids), so its resumed samples repeat the
        checkpointed ones: a render resumed from 8 spp to 16 is the first
        8 doubled."""
        z = np.load(path, allow_pickle=False)
        if str(z["scene_hash"]) != self.scene.hash or \
                int(z["width"]) != self.width or \
                int(z["height"]) != self.height:
            print("checkpoint mismatch (scene/resolution); ignoring")
            return False
        t = lambda k: torch.from_numpy(np.array(z[k])).to(self.device)
        film = Film(color=Vec3(t("color_x"), t("color_y"), t("color_z")),
                    weight=t("weight"))
        self.film = film
        salt = _restored_samples(film)
        self.seed = salt_seeds(self.seed, salt)
        if self._wf_state is not None:
            cfg = self._wf_cfg
            pool = self._wf_state.pool
            st = self._wf_state._replace(
                film=_tree_map(lambda a: pad_pixels(a, cfg), film),
                pool=pool._replace(seed=salt_seeds(pool.seed, salt)))
            if "spp" in z.files:
                st = st._replace(spp=pad_pixels(t("spp"), cfg,
                                                fill=1 << 29))
            self._wf_state = st
        if "feat_alb_x" in z.files and self.features is not None:
            self.features = FeatureFilm(
                albedo=Vec3(t("feat_alb_x"), t("feat_alb_y"),
                            t("feat_alb_z")),
                albedo_w=t("feat_alb_w"),
                normal=Vec3(t("feat_nrm_x"), t("feat_nrm_y"),
                            t("feat_nrm_z")),
                normal_w=t("feat_nrm_w"))
            if self._wf_state is not None and \
                    self._wf_state.features is not None:
                cfg = self._wf_cfg
                self._wf_state = self._wf_state._replace(features=_tree_map(
                    lambda a: pad_pixels(a, cfg), self.features))
        return True

    # -- exact-spp rendering (Tracer::renderSingle) ---------------------------
    def reset(self):
        """Accumulation reset (wf_reset analogue): a zero film (and zero
        guide features with the denoiser), seeds = pixel ids (int64 holding
        uint32), zero stats, and a fresh start for the exact-spp
        wavefront's accumulation."""
        n = self.config.num_pixels
        self.film = Film.zeros(n, self.device)
        self.seed = torch.arange(n, dtype=torch.int64, device=self.device)
        self.stats = RenderStats.zeros()
        self.features = (FeatureFilm.zeros(n, self.device)
                         if self.config.denoiser else None)
        self._wf_exact_state = None
        self._wf_exact_target = 0

    def render_single(self, spp: int, progress: bool = False):
        """Exact-spp batch render (Tracer::renderSingle): ``spp`` more
        samples for every pixel, accumulated into ``self.film`` (and the
        guide features into ``self.features`` with the denoiser). The
        exact-spp wavefront (``render_single_wavefront``), or with
        ``flags.FORCE_MK`` the microkernel megastep, one ``render_sample``
        per sample. Russian roulette is off in both, as the reference turns
        it off there (renderer.py:409, 620). With ``progress`` it prints
        the reference's "Rendered: k/N" line."""
        if not flags.FORCE_MK:
            return self.render_single_wavefront(spp, accumulate=True,
                                                progress=progress)
        cfg = self.config.replace(use_roulette=False)
        for sample in range(spp):
            if cfg.denoiser:
                self.film, self.seed, st, self.features = render_sample(
                    self.device_scene, self.params, self.film, self.seed,
                    cfg, self.features)
            else:
                self.film, self.seed, st = render_sample(
                    self.device_scene, self.params, self.film, self.seed,
                    cfg)
            self.stats = self.stats + st
            if progress and sample % 10 == 0:
                print(f"\rRendered: {sample}/{spp}", end="", flush=True)
        self._sync()
        self._film_src = "mk"
        if progress:
            print(f"\rRendered: {spp}/{spp}")
        return self.film

    def render_single_wavefront(self, spp: int,
                                num_tasks: Optional[int] = None,
                                max_segments: int = 100000,
                                accumulate: bool = False,
                                progress: bool = False):
        """Exact-spp render on the wavefront with the CHECK_SPP cap
        (wf_logic.cl:76-84): segments run, 16 between checks of the least
        per-pixel spp, until every pixel has its target. With
        ``accumulate`` the call continues the persistent exact state for
        ``spp`` more samples per pixel (renderSingle's progressive
        contract); otherwise it starts from a fresh pool. A fresh pool
        under ``accumulate`` takes over a film restored into ``self.film``
        (``load_checkpoint``): its weights become the pixels' spp and the
        target counts on from their least (renderer.py:629-643), and its
        seeds are salted with the restored sample count, so the new
        samples are independent of the restored ones. Leaves
        the film in ``self.film`` and adds the segments' counters to
        ``self.stats``. With ``progress`` it prints "Rendered: k/N" after
        every 16 segments. A pool size the config's groups do not divide
        renders on the flat pixel ring (the reference's renderer.py:
        622-623). The capped ring's counters of the call are
        ``capped_stats()``."""
        with span("flt::job"):
            cfg = self.config.replace(max_spp=1, use_roulette=False)
            n_tasks = num_tasks or self.settings.wf_buffer_size
            if cfg.block_ring and n_tasks % cfg.groups:
                # the pool fits no groups
                cfg = cfg.replace(block_ring=False)
            state = self._wf_exact_state
            if not accumulate or state is None or \
                    state.pool.seed.shape[0] != n_tasks:
                state = wf_reset(cfg, n_tasks,
                                 world_radius=self.world_radius,
                                 device=self.device)
                self._wf_exact_target = 0
                if accumulate and self.film is not None:
                    w = self.film.weight
                    if float(w.max()) > 0:
                        pool = state.pool
                        state = state._replace(
                            pool=pool._replace(seed=salt_seeds(
                                pool.seed, _restored_samples(self.film))),
                            film=_tree_map(lambda a: pad_pixels(a, cfg),
                                           self.film),
                            spp=pad_pixels(w.to(torch.int32), cfg,
                                           fill=1 << 29))
                        self._wf_exact_target = int(w.min())
            target = self._wf_exact_target + spp
            params = self.params._replace(max_spp=torch.tensor(
                target, dtype=torch.int32, device=self.device))
            done = 0
            self._clear_counters()
            self._wf_held = torch.zeros((), dtype=torch.int64,
                                        device=self.device)
            while done < max_segments:
                for _ in range(16):
                    state, c = wf_segment(self.device_scene, params, state,
                                          cfg, held=self._wf_held)
                    self._count(c)
                    done += 1
                with span("flt::job.check"):
                    cur = int(state.spp.min())
                if progress:
                    print(f"\rRendered: {min(cur, target)}/{target}",
                          end="", flush=True)
                if cur >= target:
                    if progress:
                        print()
                    break
            self.film = _tree_map(lambda a: unpad_pixels(a, cfg),
                                  state.film)
            self._film_src = "mk"
            self._wf_exact_state = state
            self._wf_exact_target = target
            self._wf_state = state
            self._wf_cfg = cfg
            self._wf_exact_mode = True      # render_wavefront must re-init
            if state.features is not None:
                self.features = _tree_map(lambda a: unpad_pixels(a, cfg),
                                          state.features)
            self.stats = self.stats + self.wavefront_stats()
            return self.film

    # -- wavefront (throughput) mode ------------------------------------------
    def init_wavefront(self, num_tasks: Optional[int] = None):
        """Reset the persistent path pool (wf_reset analogue). A pool size
        the config's groups do not divide renders on the flat pixel ring
        (the reference's renderer.py:436-437). The params stay as they
        are: settings edits since load_scene take effect through
        ``rebuild_config``."""
        self.num_tasks = num_tasks or self.settings.wf_buffer_size
        cfg = self.config
        if cfg.block_ring and self.num_tasks % cfg.groups:
            cfg = cfg.replace(block_ring=False)
        self._wf_cfg = cfg
        self._wf_exact_mode = False
        self._wf_state = wf_reset(cfg, self.num_tasks,
                                  world_radius=self.world_radius,
                                  device=self.device)
        self._clear_counters()

    def render_wavefront(self, segments: int, sync: bool = True):
        """Advance the wavefront `segments` steps: per segment the trace
        phase, then the shade phase (resolve fused with the logic). After
        an exact-spp render the pool is re-initialized first (the capped
        state would block every splat), as the reference does."""
        self._film_src = "wf"
        if self._wf_exact_mode:
            self.init_wavefront(getattr(self, "num_tasks", None))
        cfg = self._wf_cfg
        for _ in range(segments):
            with span("flt::segment"):
                raw, occ = wf_trace_phase(self.device_scene,
                                          self._wf_state.pool, self.params,
                                          cfg)
                self._wf_state, cnt = wf_shade_phase(
                    self.device_scene, self.params, self._wf_state, cfg, raw,
                    occ)
                self._count(cnt)
        if sync:
            self._sync()
        return self._wf_state

    def _clear_counters(self):
        self._wf_total = torch.zeros(4, dtype=torch.int64, device=self.device)
        self._wf_segments = 0

    def _count(self, c):
        """Add one segment's counters to the running total: two device
        operations (the stack and the add), no sync."""
        self._wf_total += torch.stack([c.raygen, c.extension, c.shadow,
                                       c.splatted])
        self._wf_segments += 1

    def wavefront_stats(self) -> RenderStats:
        """Counters summed over the segments since init_wavefront (or of
        the last exact-spp wavefront call), fetched in one transfer."""
        if not self._wf_segments:
            return RenderStats.zeros()
        return RenderStats(*self._wf_total.tolist())

    def capped_stats(self) -> CappedStats:
        """The capped ring's counters over the last exact-spp wavefront
        call (zeros before one), fetched in one transfer: read once a
        job."""
        if self._wf_held is None:
            return CappedStats(0, 0, 0, 0)
        held, admitted = torch.stack([self._wf_held,
                                      self._wf_total[3]]).tolist()
        lanes = self._wf_exact_state.pool.seed.shape[0]
        return CappedStats(self._wf_segments, lanes, held, admitted)

    def wavefront_film(self) -> Film:
        """The wavefront state's film in the true pixel layout; with the
        denoiser its guide features go to ``self.features``."""
        cfg = self._wf_cfg
        if self._wf_state.features is not None:
            self.features = _tree_map(lambda a: unpad_pixels(a, cfg),
                                      self._wf_state.features)
        return _tree_map(lambda a: unpad_pixels(a, cfg), self._wf_state.film)

    def wavefront_preview_film(self) -> Film:
        """Incomplete-path preview (mk_splat_preview.cl:13-25): the film
        plus, for every in-flight path (path_len >= 1), the radiance it
        has gathered so far as one provisional sample of its pixel, summed
        with ``index_add_`` (the reference's segment_sum). A view: the
        accumulation is untouched."""
        film = self.wavefront_film()
        pool = self._wf_state.pool
        cfg = self._wf_cfg
        npx = cfg.num_pixels
        pid = padded_to_true_pid(cfg, pool.pixel_index)
        pid = torch.clamp(torch.remainder(pid, npx), 0, npx - 1).long()
        live = (pool.path_len >= 1).to(torch.float32)

        def add(v):
            z = torch.zeros(npx, dtype=torch.float32, device=self.device)
            return z.index_add_(0, pid, v)
        cnt = add(live)
        color = Vec3(*(a + add(c * live) for c, a in zip(pool.Ei,
                                                         film.color)))
        return Film(color=color, weight=film.weight + cnt)

    # -- output --------------------------------------------------------------
    def current_film(self) -> Film:
        """The live accumulation: the wavefront state's film while the last
        render call was a free-running ``render_wavefront``, else the
        ``self.film`` both render_single routes keep."""
        if self._film_src == "wf" and self._wf_state is not None:
            return self.wavefront_film()
        return self.film

    def ldr_image(self, film: Optional[Film] = None) -> np.ndarray:
        """Postprocessed [H, W, 3] float in [0, 1] of ``film`` (default the
        current film); row 0 of the film is the bottom scanline, images
        store top-first."""
        film = self.current_film() if film is None else film
        return self._ldr(film.color, film.weight)

    def _ldr(self, color: Vec3, weight) -> np.ndarray:
        """Tonemap a flat film (bottom scanline first) to the [H, W, 3]
        top-first image in [0, 1]."""
        with span("flt::frame.tonemap"):
            rgb = postprocess(color, weight, self.params.pp.exposure,
                              self.params.pp.tm_operator)
            img = torch.stack([rgb.x, rgb.y, rgb.z], dim=-1)
        with span("flt::frame.copy"):       # waits for the queued work
            arr = img.cpu().numpy()
        with span("flt::frame.host"):
            return np.clip(arr.reshape(self.height, self.width, 3)[::-1],
                           0.0, 1.0)

    def _vec_image(self, v3: Vec3, w) -> torch.Tensor:
        """An accumulated Vec3 buffer over its weights: the [H, W, 3] mean
        image, top-first, on the render device."""
        wc = torch.clamp_min(w, 1e-30)
        arr = torch.stack([v3.x / wc, v3.y / wc, v3.z / wc], dim=-1)
        return torch.flip(arr.reshape(self.height, self.width, 3), (0,))

    def hdr_image(self, film: Optional[Film] = None) -> np.ndarray:
        """The mean radiance per pixel of ``film`` (default the current
        film), [H, W, 3] top-first."""
        film = self.current_film() if film is None else film
        img = self._vec_image(film.color, film.weight)
        with span("flt::frame.copy"):
            return img.cpu().numpy()

    def save_image(self, path: str, film: Optional[Film] = None):
        """Write ``film`` (default the current film): Radiance .hdr for a
        ``.hdr`` path, else an 8-bit PNG."""
        with span("flt::frame"):
            if path.endswith(".hdr"):
                img, write = self.hdr_image(film), save_hdr
            else:
                img, write = self.ldr_image(film), save_png
            with span("flt::frame.encode"):
                write(path, img)

    # -- denoiser (OptixDenoiser stand-in; tracer.cpp:339-356 gating) ---------
    def _feature_tensors(self):
        f = self.features
        if f is None:
            raise RuntimeError("denoiser features not accumulated; set "
                               "settings.use_denoiser before load_scene")
        return (self._vec_image(f.albedo, f.albedo_w),
                self._vec_image(f.normal, f.normal_w))

    def feature_images(self):
        """The denoiser's guide buffers as images, (albedo, normal), each
        [H, W, 3] top-first (the denoiserAlbedo/denoiserNormal PBOs).
        Raises RuntimeError without the denoiser."""
        return tuple(a.cpu().numpy() for a in self._feature_tensors())

    def denoised_tensor(self, blend: Optional[float] = None) -> torch.Tensor:
        """``atrous_denoise`` of the current HDR film, guided by the
        accumulated albedo and normal when the denoiser is on, with
        ``blend`` (default ``settings.denoiser_blend``); [H, W, 3] on the
        render device."""
        blend = self.settings.denoiser_blend if blend is None else blend
        film = self.current_film()
        hdr = self._vec_image(film.color, film.weight)
        albedo = normal = None
        if self.features is not None:
            albedo, normal = self._feature_tensors()
        return atrous_denoise(hdr, albedo, normal, blend=blend)

    def denoised_image(self, blend: Optional[float] = None) -> np.ndarray:
        """The denoised HDR film (DenoiserOptix::denoise + setBlend),
        [H, W, 3] top-first (``denoised_tensor`` on the host)."""
        return self.denoised_tensor(blend).cpu().numpy()

    def save_denoised(self, path: str, blend: Optional[float] = None):
        """renderSingle's denoised output (tracer.cpp:173-178): Radiance
        .hdr for a ``.hdr`` path, else tonemapped to an 8-bit PNG."""
        img = self.denoised_tensor(blend)
        with span("flt::frame"):
            if path.endswith(".hdr"):
                with span("flt::frame.copy"):
                    arr = img.cpu().numpy()
                write = save_hdr
            else:
                n = self.height * self.width
                flat = torch.flip(img, (0,)).reshape(n, 3)
                arr = self._ldr(
                    Vec3(flat[:, 0], flat[:, 1], flat[:, 2]),
                    torch.ones(n, dtype=torch.float32, device=self.device))
                write = save_png
            with span("flt::frame.encode"):
                write(path, arr)

    # -- picking (kernel_pick.cl / Tracer::pickDofDepth) ----------------------
    def pick_single(self, ndc_x: float, ndc_y: float):
        """Cast one camera ray through NDC coords (clamped to [0, 1]);
        returns (hit, t, tri) (CLContext::pickSingle, clcontext.cpp:
        934-949)."""
        px = int(min(max(ndc_x, 0.0), 1.0) * (self.width - 1))
        py = int(min(max(ndc_y, 0.0), 1.0) * (self.height - 1))
        dev = self.device
        pixel = torch.tensor([py * self.width + px], dtype=torch.int32,
                             device=dev)
        orig, d, _ = generate_camera_rays(
            pixel, self.params.camera, self.width, self.height,
            self.params.world_radius, torch.zeros(1, dtype=torch.int64,
                                                  device=dev))
        hit = trace_extension(orig, d, self.device_scene, None, False)
        t, tri = float(hit.t[0]), int(hit.i[0])
        return tri >= 0, t, tri

    def pick_dof_depth(self, ndc_x: float, ndc_y: float) -> bool:
        """Set the focal distance from a scene pick (tracer.cpp:
        1073-1085)."""
        ok, t, _ = self.pick_single(ndc_x, ndc_y)
        if ok:
            self.settings.camera.focal_dist = t
            self.params = self._make_params()
        return ok

    # -- perf (clcontext.cpp:666-674 definitions) ----------------------------
    def perf_mrays(self, elapsed_s: float) -> dict:
        """Millions of rays (and samples) per second of ``self.stats``."""
        st = self.stats
        scale = 1e6 * max(elapsed_s, 1e-9)
        prim = st.primary_rays / scale
        ext = st.extension_rays / scale
        shdw = st.shadow_rays / scale
        samp = st.samples / scale
        return dict(primary=prim, extension=ext, shadow=shdw, samples=samp,
                    total=prim + ext + shdw)
