"""Russian roulette and the sampling toggles of the port against the JAX
package, on the CPU, on the production luxball (textured, every GGX
lobe; chip_smoke.write_production_scene with small maps):

  wavefront   7 segments at depth 7 (roulette acts only past path length
              MIN_PATH_LENGTH = 5) with use_roulette on, sample_impl off
              and sample_expl off, each from one wf_reset; and the exact
              spp cap (K7, K8) with roulette on. Each segment starts the
              port from the reference's state (check_wavefront's
              ``resync``), so that over seven segments a path that
              last-bit differences send elsewhere is caught in the
              segment where it happens
  megastep    one sample at depth 7 for each switch
  renderer    render_single(2) with Settings.use_russian_roulette on:
              every pixel exactly 2 samples, roulette turned off on both
              exact routes as the reference turns it off there

Held as test_torch_wavefront.py and test_torch_mk.py hold luxball: the
integer state and counters bit-equal, film weight exact, rgb rtol 1e-5
(atol 1e-6) (test_torch_texture.check_wavefront and check_megastep)."""

import os
import sys

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu.core import block_splat as jbs

from fluctus_tpu_torch import flags
from fluctus_tpu_torch.core import block_splat as tbs
from fluctus_tpu_torch.core import integrator_mk as tmk
from fluctus_tpu_torch.core.integrator_wf import unpad_pixels
from fluctus_tpu_torch.geom import MIN_PATH_LENGTH
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import write_production_scene  # noqa: E402

from test_torch_mk import reference_route  # noqa: F401
from test_torch_texture import (CAM, LIGHT, MAP_SIZES, check_megastep,
                                check_wavefront, scene_setup)
from test_torch_wavefront import reference_kernels  # noqa: F401

DEPTH = 7
SEGMENTS = 7
PATHS = 512     # one pool size: the reference compiles its segment once
SWITCHES = {"roulette": dict(use_roulette=True),
            "no_implicit": dict(sample_impl=False),
            "no_explicit": dict(sample_expl=False)}


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("production"))
    return write_production_scene(d, MAP_SIZES, seed=3)


@pytest.fixture(scope="module")
def setup(scene_file):
    return scene_setup(scene_file, 32, 16, DEPTH)


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_wavefront_switch_matches_reference(setup, reference_kernels,
                                            switch):
    a = check_wavefront(setup, PATHS, SEGMENTS, resync=True,
                        **SWITCHES[switch])
    assert (a["pool"]["path_len"] >= MIN_PATH_LENGTH).any()
    if switch == "no_explicit":
        assert not a["pool"]["shadow_pending"].any()


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_megastep_switch_matches_reference(setup, reference_route, switch):
    st = check_megastep(setup, **SWITCHES[switch])
    assert (st.shadow_rays > 0) == (switch != "no_explicit")


def test_capped_wavefront_with_roulette(setup, reference_kernels,
                                        monkeypatch):
    """The exact spp cap at 2 samples with roulette on: spp per pixel
    bit-equal each segment, through K7's and K8's plain versions (the
    reference's fetch in interpret mode)."""
    fetch = jbs.fetch
    monkeypatch.setattr(jbs, "fetch",
                        lambda *a, **k: fetch(*a, **{**k, "interpret": True}))
    tbs.K7.plain_runs = tbs.K8.plain_runs = 0
    a = check_wavefront(setup, PATHS, SEGMENTS, cap=2, resync=True,
                        use_roulette=True)
    assert (tbs.K7.plain_runs, tbs.K8.plain_runs) == (SEGMENTS, SEGMENTS)
    live = a["spp"] < (1 << 29)
    assert a["spp"][live].max() == 2
    np.testing.assert_array_equal(a["film"]["weight"][live], a["spp"][live])


def _renderer(scene_file, data_dir):
    s = Settings()
    s.camera.pos, s.camera.dir = CAM["pos"], CAM["dir"]
    a = s.area_light
    a.pos, a.N, a.right, a.up = (LIGHT["pos"], LIGHT["N"], LIGHT["right"],
                                 LIGHT["up"])
    a.E, a.size = LIGHT["E"], LIGHT["size"]
    s.use_russian_roulette = True
    s.max_path_depth = DEPTH
    s.wf_buffer_size = 512
    r = Renderer(16, 8, settings=s, data_dir=str(data_dir), device="cpu")
    r.load_scene(scene_file)
    return r


def test_render_single_with_roulette_exact(scene_file, tmp_path,
                                           monkeypatch):
    """render_single(2) with use_russian_roulette on: the capped wavefront
    runs with roulette off (renderer.py:620 of the reference) and every
    pixel has spp = weight = 2; the megastep (FORCE_MK) runs with it off
    too (renderer.py:409): its film equals render_sample's without
    roulette."""
    r = _renderer(scene_file, tmp_path)
    assert r.config.use_roulette and r.device_scene.atlas.count == 3
    film = r.render_single(2)
    assert not r._wf_cfg.use_roulette
    spp = unpad_pixels(r._wf_state.spp, r.config)
    assert bool((spp == 2).all()) and bool((film.weight == 2).all())
    for c in film.color:
        assert torch.isfinite(c).all()

    monkeypatch.setattr(flags, "FORCE_MK", True)
    r.reset()
    seed = r.seed.clone()
    film = r.render_single(1)
    want, _, _ = tmk.render_sample(
        r.device_scene, r.params, tmk.Film.zeros(128, "cpu"), seed,
        r.config.replace(use_roulette=False))
    for a, b in zip((*film.color, film.weight), (*want.color, want.weight)):
        assert torch.equal(a, b)
