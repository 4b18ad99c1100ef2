"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its renderer needs CUDA unless asked for the CPU, and its kernel
wrappers take the plain version for CPU tensors only."""

import os
import re
import subprocess
import sys

import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "fluctus_tpu_torch")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import fluctus_tpu_torch
for m in pkgutil.walk_packages(fluctus_tpu_torch.__path__,
                               "fluctus_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                    "fluctus_tpu"))
print(len([m for m in sys.modules if m.startswith("fluctus_tpu_torch")]))
print("bad:" + ",".join(bad))
"""


def test_import_leaves_out_jax():
    """Importing the package and every submodule, in a fresh interpreter
    (this process already holds JAX), loads no jax, jaxlib, ml_dtypes or
    fluctus_tpu module."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, check=True,
                         timeout=300)
    count, bad = out.stdout.strip().splitlines()
    assert int(count) >= 20
    assert bad == "bad:"


def test_source_scan():
    """No source of the port (nor chip_smoke.py) names the JAX package or
    imports JAX."""
    pat = re.compile(r"fluctus_tpu\.|from fluctus_tpu\b|import fluctus_tpu\b"
                     r"|import jax|from jax|import ml_dtypes")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    assert len(files) > 20
    for f in files:
        with open(f) as fh:
            for no, line in enumerate(fh, 1):
                assert not pat.search(line), f"{f}:{no}: {line.strip()}"


_KNOB = re.compile(r"env(?:_bool|_int)?\(\s*[\"']([A-Z0-9_]+)[\"']")


def _sources(root):
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(d, n)) as fh:
                    yield os.path.relpath(os.path.join(d, n), root), fh.read()


def test_no_knob_the_reference_lacks():
    """Every FLT_* override the port reads is one the JAX package reads; the
    port reads no other environment variable but the CUDA toolkit's
    location; and every field of its Settings is a field of the JAX
    package's, with the same default. So K10's route is reached through the
    tables' content alone."""
    import dataclasses
    import inspect
    from fluctus_tpu import settings as jsettings
    from fluctus_tpu_torch import kernel_build
    from fluctus_tpu_torch import settings as tsettings
    ref = set()
    for _, text in _sources(os.path.join(ROOT, "fluctus_tpu")):
        ref |= set(_KNOB.findall(text))
    ours = set()
    readers = set()
    for path, text in _sources(PKG):
        ours |= set(_KNOB.findall(text))
        if "os.environ" in text or "getenv(" in text:
            readers.add(path)
    assert {"SORT_RAYS", "ROL", "FORCE_MK", "SEED_SALT"} <= ours
    assert ours <= ref, ours - ref
    # outside flags.py only nvcc_path reads the environment: the CUDA
    # toolkit's location (CUDA_HOME, CUDA_PATH), not a switch
    assert readers == {"flags.py", "kernel_build.py"}, readers
    src = inspect.getsource(kernel_build)
    fn = inspect.getsource(kernel_build.nvcc_path)
    assert "os.environ" not in src.replace(fn, "")
    assert set(re.findall(r'"([A-Z_]+)"', fn)) == {"CUDA_HOME", "CUDA_PATH"}

    def fields(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING
                         else f.default_factory())
                for f in dataclasses.fields(cls)}
    for ours_cls, ref_cls in ((tsettings.Settings, jsettings.Settings),
                              (tsettings.CameraSettings,
                               jsettings.CameraSettings),
                              (tsettings.AreaLightSettings,
                               jsettings.AreaLightSettings)):
        mine, theirs = fields(ours_cls), fields(ref_cls)
        for name, default in mine.items():
            assert name in theirs, f"{ours_cls.__name__}.{name}"
            if not dataclasses.is_dataclass(default):
                assert default == theirs[name], name


def test_renderer_requires_cuda(monkeypatch, tmp_path):
    """Without CUDA the renderer raises unless the caller asks for the
    CPU; there is no silent fallback."""
    from fluctus_tpu_torch.renderer import Renderer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(16, 16, data_dir=d)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(16, 16, data_dir=d, device="cuda")
    assert Renderer(16, 16, data_dir=d, device="cpu").device.type == "cpu"


def test_wrappers_route_by_device():
    """CPU tensors run the plain version (counted as such, no launch);
    tensors on any other non-CUDA device are refused."""
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core import block_splat as bs
    kb.reset_counts()
    local = torch.tensor([0, -1, 1, 0], dtype=torch.int32)
    data = torch.ones((4, 4))
    film = torch.zeros((4, 2 * 128))
    out = bs.splat(local, data, film, groups=2)
    assert out[3, 0] == 1.0 and out[3, 1] == 0.0 and out[3, 128] == 1.0
    assert bs.K4.plain_runs == 1 and bs.K4.launches == 0
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        bs.splat(local.to("meta"), data.to("meta"), film.to("meta"),
                 groups=2)
    from fluctus_tpu_torch.accel import mxu_trace as mt
    col = torch.tensor([0, -1], dtype=torch.int32)
    rays = torch.zeros((2, 4))
    b16r = torch.zeros((1, 128), dtype=torch.bfloat16)
    t16r = torch.zeros((1, 16))
    assert mt.resolve_v5s(col, rays, rays, b16r, t16r).shape == (40, 2)
    assert mt.K6.plain_runs == 1 and mt.K6.launches == 0
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        mt.resolve_v5s(*(t.to("meta") for t in (col, rays, rays, b16r,
                                                 t16r)))
    assert set(kb.KERNELS) == {"tile_order", "trace_rol", "resolve_v5",
                               "block_splat", "trace_rol_sc", "resolve_v5s",
                               "block_splat_capped", "fetch", "trace_ros",
                               "resolve_v1"}
    rem = torch.zeros((1, 2 * 128))
    assert bs.splat(local, data, film, groups=2, remaining=rem).sum() == 0
    assert bs.fetch(local, film[3:], groups=2).shape == (4,)
    assert (bs.K7.plain_runs, bs.K8.plain_runs, bs.K4.plain_runs) == (1, 1, 1)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        bs.fetch(local.to("meta"), film[3:].to("meta"), groups=2)


def test_helpers_require_a_device():
    """The constructors of render state take the device as a required
    keyword: leaving it out is a TypeError, never a CPU default."""
    from fluctus_tpu_torch.core import integrator_wf as wf
    from fluctus_tpu_torch.geom import AreaLight, Camera, RenderConfig
    from fluctus_tpu_torch.scene import Scene
    from fluctus_tpu_torch.scene.material import (default_material,
                                                  materials_to_soa)
    cfg = RenderConfig(width=16, height=8, groups=4)
    calls = [
        lambda **k: wf.wf_reset(cfg, 64, **k),
        lambda **k: wf.wf_state_from_numpy(wf.wf_state_to_numpy(
            wf.wf_reset(cfg, 64, device="cpu")), **k),
        lambda **k: Camera.make((0, 0, 0), (0, 0, -1), (0, 1, 0), (1, 0, 0),
                                **k),
        lambda **k: AreaLight.make((0, 1, 0), (0, -1, 0), (1, 0, 0),
                                   (0, 0, 1), (1, 1, 1), (1, 1), **k),
        lambda **k: materials_to_soa([default_material()], **k),
        lambda **k: Scene().device_materials(**k),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="device"):
            call()
        call(device="cpu")
