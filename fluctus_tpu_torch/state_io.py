"""Render state save/load (the reference package's state_io.py): the
``data/states/state_<hash>.dat`` format of the original renderer
(Tracer::iterateStateItems, tracer.cpp:995-1054), byte for byte: camera
rotation, speed, fov, depth of field and basis, the area light, the env
map strength, the sampling flags and the post-processing. A file written
by either package reads back field for field in the other.
"""

from __future__ import annotations

import os
import struct

from .settings import Settings


class _Stream:
    """Little-endian float32 / uint32 fields, in order."""

    def __init__(self, data: bytes = b""):
        self.data = bytearray(data)
        self.off = 0

    def _read(self, fmt):
        v = struct.unpack_from(fmt, self.data, self.off)[0]
        self.off += 4
        return v

    def rf(self):
        return self._read("<f")

    def ru(self):
        return self._read("<I")

    def rvec(self):
        return (self.rf(), self.rf(), self.rf())

    def wf(self, v):
        self.data += struct.pack("<f", float(v))

    def wu(self, v):
        self.data += struct.pack("<I", int(v))

    def wvec(self, v):
        for c in v:
            self.wf(c)


def state_path(data_dir: str, scene_hash: str) -> str:
    return os.path.join(data_dir, "states", f"state_{scene_hash}.dat")


def save_state(path: str, s: Settings, env_map_strength: float = 1.0,
               exposure: float = 1.0):
    """Write the state of ``s`` (field order of tracer.cpp:1007-1046)."""
    st = _Stream()
    c, a = s.camera, s.area_light
    st.wf(c.camera_rotation[0])
    st.wf(c.camera_rotation[1])
    st.wf(c.camera_speed)
    st.wf(c.fov)
    st.wf(c.focal_dist)
    st.wf(c.aperture_size)
    for v in (c.dir, c.pos, c.right, c.up, a.N, a.pos, a.right, a.up, a.E):
        st.wvec(v)
    st.wf(a.size[0])
    st.wf(a.size[1])
    st.wf(env_map_strength)
    st.wu(s.max_path_depth)
    for flag in (s.use_area_light, s.use_env_map, s.sample_explicit,
                 s.sample_implicit, s.use_russian_roulette):
        st.wu(int(flag))
    st.wf(exposure)
    st.wu(s.tonemap)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(bytes(st.data))


def load_state(path: str, s: Settings):
    """Read a state file into ``s`` (in place). Returns (env map strength,
    exposure)."""
    with open(path, "rb") as f:
        st = _Stream(f.read())
    c, a = s.camera, s.area_light
    c.camera_rotation = (st.rf(), st.rf())
    c.camera_speed = st.rf()
    c.fov = st.rf()
    c.focal_dist = st.rf()
    c.aperture_size = st.rf()
    c.dir = st.rvec()
    c.pos = st.rvec()
    c.right = st.rvec()
    c.up = st.rvec()
    a.N = st.rvec()
    a.pos = st.rvec()
    a.right = st.rvec()
    a.up = st.rvec()
    a.E = st.rvec()
    a.size = (st.rf(), st.rf())
    env_map_strength = st.rf()
    s.max_path_depth = st.ru()
    s.use_area_light = bool(st.ru())
    s.use_env_map = bool(st.ru())
    s.sample_explicit = bool(st.ru())
    s.sample_implicit = bool(st.ru())
    s.use_russian_roulette = bool(st.ru())
    exposure = st.rf()
    s.tonemap = st.ru()
    return env_map_strength, exposure
