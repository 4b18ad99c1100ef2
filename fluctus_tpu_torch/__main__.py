"""CLI entry (the reference package's __main__.py; the original
renderer's main.cpp, headless).

    python -m fluctus_tpu_torch [scene files...] [options]

Renders on the GPU; ``FLT_FORCE_CPU=1`` runs the same job on the CPU
(each kernel's plain PyTorch version). Without CUDA and without that
switch the Renderer raises: there is no silent fallback.

Options mirror src/main.cpp:24-46: -x/-y render size, -s spp (an exact-spp
batch render, the default mode), --wavefront N segments of the
free-running wavefront with --preview-every numbered preview frames and
the max_render_time / max_spp stops, --checkpoint (resumed before a
wavefront run when the file exists, written after every render) and
--save-state. Each render writes the image as .png and .hdr.
--benchmark, .bm.json inputs, --serve and --interactive are not ported:
they exit with status 2 and a message.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _parser():
    ap = argparse.ArgumentParser(prog="fluctus_tpu_torch")
    ap.add_argument("scenes", nargs="*", help=".obj/.ply/.sc.json scene files "
                    "or .bm.json benchmark files")
    ap.add_argument("-x", "--width", type=int, default=1024)
    ap.add_argument("-y", "--height", type=int, default=768)
    ap.add_argument("-s", "--spp", type=int, default=0,
                    help="render N spp in batch (exact-spp) mode and exit")
    ap.add_argument("--wavefront", type=int, default=0, metavar="SEGMENTS",
                    help="run N wavefront segments (throughput mode)")
    ap.add_argument("--tasks", type=int, default=1 << 20,
                    help="wavefront path pool size (wfBufferSize)")
    ap.add_argument("--env", default=None, help="environment map (.hdr)")
    ap.add_argument("--preview-every", type=int, default=0, metavar="N",
                    help="in wavefront mode, write a numbered preview frame "
                    "and print stats every N segments (progressive preview, "
                    "the headless stand-in for the GL window)")
    ap.add_argument("--save-state", action="store_true",
                    help="save the render state (camera/light/flags) per "
                    "scene hash after rendering (F2 in the reference)")
    ap.add_argument("-b", "--batch", action="store_true",
                    help="batch mode (main.cpp -b; already the default on "
                    "a headless host — accepted for parity)")
    ap.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="browser-based live viewer (not ported)")
    ap.add_argument("--interactive", action="store_true",
                    help="headless interactive REPL (not ported)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="film checkpoint: resumed before rendering if it "
                    "exists, written after (long-render preemption "
                    "recovery)")
    ap.add_argument("--settings", default="settings.json")
    ap.add_argument("--benchmark", action="store_true",
                    help="run the fixed benchmark protocol (not ported)")
    ap.add_argument("-o", "--output", default=None, help="output image path")
    return ap


def _unported(args):
    """The first option of this invocation the port does not implement."""
    if args.benchmark:
        return "--benchmark"
    if args.serve:
        return "--serve"
    if args.interactive:
        return "--interactive"
    for scene in args.scenes:
        if scene.endswith(".bm.json"):
            return f"benchmark file {scene}"
    return None


def _render_wavefront(r, args, settings, scene_file, out):
    """--wavefront: N segments with the preview frames and the stops of
    Tracer::shouldSkipRender (tracer.cpp:202-213)."""
    r.init_wavefront(args.tasks)
    if args.checkpoint and os.path.exists(args.checkpoint):
        if r.load_checkpoint(args.checkpoint):
            print(f"resumed checkpoint: {args.checkpoint}")
    t0 = time.time()
    done = 0
    frame = 0
    chunk = args.preview_every or args.wavefront
    while done < args.wavefront:
        n = min(chunk, args.wavefront - done)
        r.render_wavefront(n)
        done += n
        if settings.max_render_time > 0 and \
                time.time() - t0 > settings.max_render_time:
            print(f"  maxRenderTime ({settings.max_render_time}s) reached")
            break
        if settings.max_spp > 0 and \
                float(r.wavefront_film().weight.min()) >= settings.max_spp:
            print(f"  maxSpp ({settings.max_spp}) reached")
            break
        if args.preview_every and done < args.wavefront:
            # progressive preview: numbered frame + stats (Tracer::update
            # display loop, tracer.cpp:184-200)
            frame += 1
            fpath = f"{os.path.splitext(out)[0]}_f{frame:04d}.png"
            r.save_image(fpath)
            dt = time.time() - t0
            st = r.wavefront_stats()
            tot = (st.primary_rays + st.extension_rays
                   + st.shadow_rays) / (1e6 * dt)
            spp = float(r.current_film().weight.mean())
            print(f"  [{done}/{args.wavefront}] {dt:6.1f}s "
                  f"{tot:6.1f} MRays/s  avg spp {spp:.1f}  -> {fpath}")
    dt = time.time() - t0
    st = r.wavefront_stats()
    total = (st.primary_rays + st.extension_rays
             + st.shadow_rays) / (1e6 * dt)
    print(f"{scene_file}: {args.wavefront} segments in {dt:.2f}s "
          f"-> {total:.1f} MRays/s")


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    missing = _unported(args)
    if missing:
        print(f"fluctus_tpu_torch: {missing} is not ported", file=sys.stderr)
        return 2

    from . import flags
    from .renderer import Renderer
    from .settings import Settings
    device = "cpu" if flags.env_bool("FORCE_CPU", False) else None
    settings = Settings.load(args.settings)
    scenes = args.scenes or ([settings.shortcuts[min(settings.shortcuts)]]
                             if settings.shortcuts else [])
    if not scenes:
        ap.print_help()
        return 1

    for scene_file in scenes:
        r = Renderer(args.width, args.height, settings=settings,
                     device=device)
        r.load_scene(scene_file, env_map=args.env)
        base = os.path.splitext(os.path.basename(scene_file))[0]
        out = args.output or f"output_{base}.png"
        if args.wavefront > 0:
            _render_wavefront(r, args, settings, scene_file, out)
        else:
            spp = args.spp or 16
            t0 = time.time()
            r.render_single(spp, progress=True)
            dt = time.time() - t0
            perf = r.perf_mrays(dt)
            print(f"{scene_file}: {spp} spp in {dt:.2f}s "
                  f"-> {perf['total']:.1f} MRays/s")
        r.save_image(out)
        r.save_image(os.path.splitext(out)[0] + ".hdr")
        print(f"wrote {out}")
        if args.checkpoint:
            print(f"checkpoint: {r.save_checkpoint(args.checkpoint)}")
        if args.save_state:
            print(f"saved state: {r.save_state()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
