"""Headless interactive session (the reference package's interactive.py;
the original renderer's GL window and Tracer-UI key handler,
tracer.cpp:389-1090, window.cpp).

A line-oriented REPL: each command changes the render state as the
original key handler does (movement scaled by cameraSpeed, rotation in
degrees), restarts the accumulation, renders a few wavefront segments on
the Renderer's device and writes the frame as a PNG (a temporary file and
``os.replace``, so a reader of the file never sees half a frame).

Commands:
  w/s/a/d/r/f        move camera (forward/back/left/right/up/down)
  look <dx> <dy>     rotate camera (degrees, like arrow keys)
  speed <v>          set cameraSpeed (reference '+'/'-')
  fov <deg>          vertical field of view
  spp <n>            segments rendered per preview refresh
  more [n]           refine: n more segments WITHOUT restarting
                     accumulation (idle iteration, Tracer::update)
  preview [0|1]      toggle fast force-splat preview: two segments +
                     incomplete-path splat (splatPreview,
                     mk_splat_preview.cl:13-25) for instant feedback
  save | load        render state to/from data/states (F2 / F1)
  mats               list materials (index, name, type, Kd, Ns, Ni)
  mat <i> <f> <v..>  edit material field (kd/ks/ke/kt: 3 floats;
                     ns/ni/d: 1) and re-upload (the UI sliders + F5)
  scene <1-6|path>   quick-load a shortcut scene from settings (keys 1-6)
                     or any scene file (full lifecycle swap)
  sampling           cycle light-sampling mode MIS/explicit/implicit
  light              cycle light sources env/area/both
  pick <x> <y>       set DoF focal distance from a scene pick (NDC
                     coords in [0,1]; the right-click analogue)
  tonemap [0-3]      tonemap operator (0 linear, 1 Reinhard, 2 UC2
                     filmic, 3 raw) or cycle; postprocess-only — no
                     accumulation restart (tracer_ui.cpp:355-366)
  depth <n>          maximum path depth (tracer_ui.cpp:213 slider)
  rr [0|1]           Russian roulette toggle (tracer_ui.cpp:181)
  maxspp <n>         accumulation cap, 0 = unbounded (tracer_ui.cpp:233)
  scale <f>          render scale: re-create the film at f x the launch
                     resolution (tracer_ui.cpp:256-303)
  aperture <f>       thin-lens aperture size (tracer_ui.cpp:320)
  envstrength <f>    environment-map emission multiplier
                     (tracer_ui.cpp:434)
  arealight size <f> | int <f> | color <r> <g> <b>
                     area-light edits (tracer_ui.cpp:448-486): size sets
                     the half-extents, int rescales E's peak, color
                     re-tints E preserving the peak
  denoise [0|1]      denoiser enable (tracer_ui.cpp:388)
  integrator [wf|mk] preview integrator: wavefront segments vs the
                     exact-spp path (tracer_ui.cpp:129-150)
  exposure <f>       exposure multiplier (tracer_ui exposure slider);
                     postprocess-only
  blend <f>          denoiser blend 0..1 (0 = original, 1 = fully
                     denoised; DenoiserOptix::setBlend) — rewrites the
                     frame denoised when the denoiser is active
  png <path>         write the current accumulation
  q                  quit

Two faults of the reference are repaired here (ROADMAP C7, C8): the frame
is the image of ``renderer.film``, so with ``preview 1`` it shows the
preview film whose spp the echo line reports (the reference writes the
accumulation); and ``load`` restores the state file's env map strength and
exposure as well (the reference drops them).
"""

from __future__ import annotations

import os
import shlex
import sys

from . import state_io
from .profiling import span


def run_interactive(renderer, out_path: str = "preview.png",
                    input_stream=None, echo: bool = True):
    """Drive ``renderer`` from a command stream (stdin by default).
    Returns the number of commands processed."""
    stream = input_stream or sys.stdin
    segments = 8
    fast_preview = False
    mode_mk = False
    renderer.preview_integrator = "wf"   # the viewer's /state.json reads it
    processed = 0
    # launch resolution = scale-1.0 reference for the `scale` command
    s0 = max(getattr(renderer.settings, "render_scale", 1.0), 1e-6)
    base_w = int(round(renderer.width / s0))
    base_h = int(round(renderer.height / s0))

    def tmp_path():
        return out_path + ".tmp" + os.path.splitext(out_path)[1]

    def refresh():
        with span("flt::refresh"):
            with span("flt::refresh.restart"):
                # recompileKernels analogue: the sampling/light toggles
                # change the config's switches
                renderer.rebuild_config()
                renderer.reset()
                if not mode_mk:
                    renderer.init_wavefront(
                        renderer.num_tasks
                        if getattr(renderer, "num_tasks", None) else None)
            if mode_mk:
                # exact-spp preview (integrator combo, tracer_ui.cpp:129)
                with span("flt::refresh.render"):
                    renderer.render_single(spp=max(1, min(segments, 16)))
            elif fast_preview:
                # splatPreview role (mk_splat_preview.cl:13-25): two
                # segments (camera rays + first NEE resolve), then blend the
                # incomplete paths in for instant (biased) feedback during
                # camera motion
                with span("flt::refresh.render"):
                    renderer.render_wavefront(2)
                with span("flt::refresh.preview"):
                    renderer.film = renderer.wavefront_preview_film()
            else:
                with span("flt::refresh.render"):
                    renderer.render_wavefront(segments)
                with span("flt::refresh.preview"):
                    renderer.film = renderer.wavefront_film()
            _save_frame()

    def _save_frame():
        # the frame is renderer.film's image (C7: the preview film when it
        # holds one); atomic swap, as the --serve viewer reads the file
        tmp = tmp_path()
        renderer.save_image(tmp, film=renderer.film)
        os.replace(tmp, out_path)
        if echo:
            spp = renderer.film.weight.mean().item()
            print(f"  -> {out_path} (avg {spp:.1f} spp)")

    def repost(denoised=False):
        # postprocess params (exposure/tonemap/blend) are render params,
        # not config switches: re-make the params and re-save the frame
        # from the existing accumulation, no restart (the reference's
        # PostProcessParams update path, tracer_ui.cpp:355-366)
        renderer.params = renderer._make_params()
        if denoised:
            tmp = tmp_path()
            renderer.save_denoised(tmp)
            os.replace(tmp, out_path)
            if echo:
                print(f"  -> {out_path} (denoised, blend="
                      f"{renderer.settings.denoiser_blend:g})")
        else:
            _save_frame()

    def move(axis, sign):
        c = renderer.settings.camera
        step = c.camera_speed * sign
        base = {"fwd": c.dir, "right": c.right, "up": c.up}[axis]
        c.pos = (c.pos[0] + base[0] * step, c.pos[1] + base[1] * step,
                 c.pos[2] + base[2] * step)

    def look(dx, dy):
        s = renderer.settings
        rx, ry = s.camera.camera_rotation
        s.camera.camera_rotation = (rx + dx, ry + dy)
        s._calc_camera_matrix()

    if echo:
        print("interactive mode — w/s/a/d/r/f, look, speed, fov, spp, "
              "save, load, png, q")
    for line in stream:
        try:
            cmd = shlex.split(line.strip())
        except ValueError as e:      # an unbalanced quote must not end the
            print(f"  parse error: {e}")   # REPL (or the --serve session)
            continue
        if not cmd:
            continue
        op = cmd[0].lower()
        processed += 1
        # a typo or a bad argument must not end the session: every error
        # is reported on an "error:" line and the loop goes on
        try:
            if op == "q":
                break
            elif op in ("w", "s"):
                move("fwd", +1 if op == "w" else -1)
                refresh()
            elif op in ("d", "a"):
                move("right", +1 if op == "d" else -1)
                refresh()
            elif op in ("r", "f"):
                move("up", +1 if op == "r" else -1)
                refresh()
            elif op == "look":
                look(float(cmd[1]), float(cmd[2]) if len(cmd) > 2 else 0.0)
                refresh()
            elif op == "speed":
                renderer.settings.camera.camera_speed = float(cmd[1])
            elif op == "fov":
                renderer.settings.camera.fov = float(cmd[1])
                refresh()
            elif op == "spp":
                segments = max(1, int(cmd[1]))
            elif op == "preview":
                fast_preview = bool(int(cmd[1])) if len(cmd) > 1 \
                    else not fast_preview
                if echo:
                    print(f"  fast preview {'on' if fast_preview else 'off'}")
            elif op == "save":
                print(f"  saved: {renderer.save_state()}")
            elif op == "load":
                path = state_io.state_path(renderer.data_dir,
                                           renderer.scene.hash)
                # C8: the file's env map strength and exposure too
                renderer.env_map_strength, renderer.exposure = \
                    state_io.load_state(path, renderer.settings)
                renderer.params = renderer._make_params()
                refresh()
            elif op == "mats":
                for i, m in enumerate(renderer.scene.materials):
                    print(f"  [{i}] {m.name or '<unnamed>'} type={m.type} "
                          f"Kd={tuple(round(c, 3) for c in m.Kd)} "
                          f"Ns={m.Ns:.3f} Ni={m.Ni:.3f}")
            elif op == "mat":
                i = int(cmd[1])
                field = cmd[2].lower()
                m = renderer.scene.materials[i]
                if field in ("kd", "ks", "ke", "kt"):
                    setattr(m, {"kd": "Kd", "ks": "Ks", "ke": "Ke",
                                "kt": "Kt"}[field],
                            (float(cmd[3]), float(cmd[4]), float(cmd[5])))
                elif field in ("ns", "ni", "d"):
                    setattr(m, {"ns": "Ns", "ni": "Ni", "d": "d"}[field],
                            float(cmd[3]))
                else:
                    print(f"  ? unknown material field: {field}")
                    continue
                renderer.reload_materials()   # re-bake and re-upload (F5)
                refresh()
            elif op == "scene":
                # keys 1-6 quick-load (tracer.cpp:1198-1203) or a path
                # (selectScene): the full scene lifecycle
                arg = cmd[1]
                path = (renderer.settings.shortcuts.get(int(arg))
                        if arg.isdigit() else arg)
                if not path:
                    print(f"  ? no shortcut {arg} in settings")
                    continue
                env = renderer.scene.envmap.name \
                    if getattr(renderer.scene, "envmap", None) else None
                renderer.load_scene(path, env_map=env)
                if echo:
                    print(f"  scene: {path} "
                          f"({renderer.scene.num_triangles} tris)")
                refresh()
            elif op == "sampling":
                # cycle MIS -> explicit -> implicit -> MIS
                # (toggleSamplingMode, tracer.cpp:1206-1224)
                s = renderer.settings
                if s.sample_implicit and s.sample_explicit:
                    s.sample_implicit = False
                    mode = "explicit"
                elif s.sample_explicit:
                    s.sample_explicit, s.sample_implicit = False, True
                    mode = "implicit"
                else:
                    s.sample_explicit = s.sample_implicit = True
                    mode = "MIS"
                if echo:
                    print(f"  sampling mode: {mode}")
                refresh()
            elif op == "light":
                # cycle env -> area -> both (toggleLightSourceMode,
                # tracer.cpp:1226-1248); needs a loaded env map
                s = renderer.settings
                if not getattr(renderer.scene, "envmap", None):
                    print("  no environment map loaded")
                    continue
                if s.use_area_light and s.use_env_map:
                    s.use_area_light, mode = False, "environment"
                elif s.use_env_map:
                    s.use_env_map, s.use_area_light = False, True
                    mode = "area light"
                else:
                    s.use_env_map = s.use_area_light = True
                    mode = "both"
                if echo:
                    print(f"  light mode: {mode}")
                refresh()
            elif op == "pick":
                # right-click DoF focal pick (tracer.cpp:1427-1433)
                ok = renderer.pick_dof_depth(float(cmd[1]), float(cmd[2]))
                if echo:
                    print(f"  focalDist = "
                          f"{renderer.settings.camera.focal_dist:.4f}"
                          if ok else "  no hit")
                if ok:
                    refresh()
            elif op == "more":
                # continue accumulating without a restart (the reference
                # keeps iterating while idle, Tracer::update)
                n_more = int(cmd[1]) if len(cmd) > 1 else segments
                if mode_mk:
                    # renderSingle accumulates progressively: n more spp
                    renderer.render_single(spp=max(1, n_more))
                    _save_frame()
                    continue
                if getattr(renderer, "_wf_state", None) is None:
                    refresh()          # nothing accumulated yet
                    continue
                renderer.render_wavefront(n_more)
                renderer.film = renderer.wavefront_film()
                _save_frame()
            elif op == "tonemap":
                # operator select or cycle (tracer_ui.cpp:355-366)
                s = renderer.settings
                s.tonemap = (int(cmd[1]) % 4 if len(cmd) > 1
                             else (s.tonemap + 1) % 4)
                if echo:
                    names = ("linear", "Reinhard", "UC2 filmic", "raw")
                    print(f"  tonemap: {s.tonemap} ({names[s.tonemap]})")
                repost()
            elif op == "exposure":
                renderer.exposure = float(cmd[1])
                if echo:
                    print(f"  exposure: {renderer.exposure:g}")
                repost()
            elif op == "blend":
                s = renderer.settings
                s.denoiser_blend = min(1.0, max(0.0, float(cmd[1])))
                if echo:
                    print(f"  denoiser blend: {s.denoiser_blend:g}")
                # with the denoiser active the frame is the blended result
                # (tracer.cpp:339-356 gating + setBlend)
                has_feat = renderer.features is not None
                repost(denoised=renderer.config.denoiser and has_feat)
            elif op == "depth":
                renderer.settings.max_path_depth = max(1, int(cmd[1]))
                if echo:
                    print(f"  max path depth: "
                          f"{renderer.settings.max_path_depth}")
                refresh()
            elif op == "rr":
                s = renderer.settings
                s.use_russian_roulette = (bool(int(cmd[1]))
                                          if len(cmd) > 1
                                          else not s.use_russian_roulette)
                if echo:
                    print("  russian roulette "
                          f"{'on' if s.use_russian_roulette else 'off'}")
                refresh()
            elif op == "maxspp":
                renderer.settings.max_spp = max(0, int(cmd[1]))
                refresh()
            elif op == "scale":
                fct = float(cmd[1])
                renderer.settings.render_scale = fct
                renderer.resize(max(1, int(base_w * fct)),
                                max(1, int(base_h * fct)))
                if echo:
                    print(f"  render scale {fct:g}: "
                          f"{renderer.width}x{renderer.height}")
                refresh()
            elif op == "aperture":
                renderer.settings.camera.aperture_size = float(cmd[1])
                refresh()
            elif op == "envstrength":
                renderer.env_map_strength = float(cmd[1])
                refresh()
            elif op == "denoise":
                s = renderer.settings
                s.use_denoiser = (bool(int(cmd[1])) if len(cmd) > 1
                                  else not s.use_denoiser)
                if echo:
                    print(f"  denoiser {'on' if s.use_denoiser else 'off'}")
                refresh()
            elif op == "arealight":
                a = renderer.settings.area_light
                sub = cmd[1].lower()
                peak = max(max(a.E), 1e-9)
                if sub == "size":
                    v = float(cmd[2])
                    a.size = (v, v)
                elif sub in ("int", "intensity"):
                    v = float(cmd[2])
                    a.E = tuple(e / peak * v for e in a.E)
                elif sub == "color":
                    c = (float(cmd[2]), float(cmd[3]), float(cmd[4]))
                    cpk = max(max(c), 1e-9)
                    a.E = tuple(x / cpk * peak for x in c)
                else:
                    print(f"  ? unknown arealight field: {sub}")
                    continue
                refresh()
            elif op == "integrator":
                mode_mk = ((cmd[1].lower() in ("mk", "microkernel"))
                           if len(cmd) > 1 else not mode_mk)
                renderer.settings.use_wavefront = not mode_mk
                renderer.preview_integrator = "mk" if mode_mk else "wf"
                if echo:
                    print(f"  integrator: "
                          f"{'microkernel' if mode_mk else 'wavefront'}")
                refresh()
            elif op == "png":
                if not mode_mk:
                    renderer.film = renderer.wavefront_film()
                renderer.save_image(cmd[1])
            else:
                print(f"  ? unknown command: {op}")
                processed -= 1
        except Exception as e:
            print(f"  error: {e}")
    return processed
