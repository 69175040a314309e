"""CLI: render a heightmap to an image (SURVEY.md C1/L6).

The reference's main() parses args, loads the map, builds the pyramid, runs
the frame loop and displays via GL; this one renders to a PNG (or an .npy
flythrough stack) — SURVEY.md L4 note.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="hmrt-render",
        description="heightmap raytracer (capability parity with the "
                    "GPU-Heightmap-Raytracer reference)")
    p.add_argument("heightmap", nargs="?", default=None,
                   help="heightmap file (.png/.pgm/.npy/.npz/.raw/.r32/.asc); "
                        "omit for procedural terrain")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--size", type=int, default=1024,
                   help="procedural terrain size (when no file given)")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--eye", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--target", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--fov", type=float, default=55.0)
    p.add_argument("--sun", type=float, nargs=3, default=(0.4, 0.3, 0.85))
    p.add_argument("--traversal", choices=["maxmip", "dda"], default="maxmip")
    p.add_argument("--intersect", choices=["triangle", "bilinear", "flat"],
                   default="triangle")
    p.add_argument("--shading", choices=["lambert", "phong"], default="phong")
    p.add_argument("--albedo", default=None, metavar="IMAGE",
                   help="albedo texture image draped over the terrain "
                        "(C18); resampled to the heightmap resolution")
    p.add_argument("--shadows", action="store_true")
    p.add_argument("--fog", action="store_true")
    p.add_argument("--aux", action="store_true",
                   help="also write depth (.npy) and normal buffers")
    p.add_argument("--flythrough", type=int, default=0, metavar="FRAMES",
                   help="render an orbiting flythrough to <output>.npy")
    p.add_argument("--sharded", action="store_true",
                   help="shard over all devices: the framebuffer "
                        "(row bands) for stills, the frame axis for "
                        "--flythrough")
    p.add_argument("--zscale", type=float, default=None)
    p.add_argument("--tile", type=int, default=0, metavar="CELLS",
                   help="out-of-core tiled render (SURVEY.md C5): stream "
                        "the map as CELLS^2-cell sub-scenes and composite "
                        "by depth — for maps too large for device memory. "
                        "A .raw/.r32 file is mmap'd and never fully loaded "
                        "(heights are used as-is, no normalization). "
                        "Incompatible with --sharded/--flythrough.")
    p.add_argument("--tile-cache", type=int, default=0, metavar="N",
                   help="keep up to N tile sub-scenes resident across the "
                        "shadow sweep (pixel-neutral; ~40 MB of device "
                        "memory per 2048-cell tile)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import hmrt as H
    from hmrt.io.image import write_png
    from hmrt.utils.cache import enable_compile_cache

    enable_compile_cache()

    source = None  # out-of-core source (RawTileMap or ndarray)
    if (args.tile and args.heightmap
            and args.heightmap.lower().endswith((".raw", ".r32"))):
        from hmrt.io.native import RawTileMap
        source = RawTileMap(args.heightmap)
        n = source.side
        # camera defaults need a height estimate; sample a coarse grid
        probe = source.tile(0, 0, min(n, 512), min(n, 512))
        zmax, zmean = float(probe.max()), float(probe.mean())
        terr = None
    elif args.heightmap:
        terr = H.load_heightmap(args.heightmap, z_scale=args.zscale)
        if terr.shape[0] != terr.shape[1]:
            side = min(terr.shape)
            terr = terr[:side, :side]
    else:
        terr = H.procedural_terrain(args.size, seed=args.seed,
                                    z_scale=args.zscale)
    light = H.Light.create(sun_dir=tuple(args.sun))
    albedo = None
    if args.albedo:
        from hmrt.io.heightmap import load_texture
        if terr is None:
            print("--albedo needs an in-memory heightmap (not --tile on "
                  "a raw mmap)", file=sys.stderr)
            return 2
        albedo = load_texture(args.albedo, terr.shape[0])
    if terr is not None:
        n = terr.shape[0]
        zmax, zmean = float(terr.max()), float(terr.mean())
        if args.tile:
            source = terr
        else:
            scene = H.make_scene(terr, albedo=albedo, light=light)
    eye = tuple(args.eye) if args.eye else (n * 0.5, -n * 0.25, zmax + n * 0.06)
    target = tuple(args.target) if args.target else (n * 0.5, n * 0.5, zmean)
    cam = H.Camera.create(eye=eye, target=target, fov_y_deg=args.fov)
    cfg = H.RenderConfig(width=args.width, height=args.height,
                         traversal=args.traversal,
                         cell_intersect=args.intersect,
                         shading=args.shading, shadows=args.shadows,
                         fog=args.fog, texture=albedo is not None,
                         aux_buffers=args.aux)

    if args.flythrough:
        from hmrt.api.flythrough import orbit_flythrough, frame_camera
        cams = orbit_flythrough(n, zmax, args.flythrough)
        t0 = time.time()
        if args.tile:
            if args.sharded:
                print("--tile is incompatible with --sharded",
                      file=sys.stderr)
                return 2
            # out-of-core animation: the tile-scene cache keeps the
            # working set resident so later frames skip the rebuilds
            from hmrt.api.tiled import TileSceneCache, render_frame_tiled
            cache = TileSceneCache(args.tile_cache or 16)
            frames = []
            for i in range(args.flythrough):
                fr = render_frame_tiled(source, frame_camera(cams, i), cfg,
                                        tile=args.tile, light=light,
                                        albedo=albedo, cache=cache)
                frames.append(np.asarray(fr.color))
            stack = np.stack(frames)
        elif args.sharded:
            # frame-axis DP: whole frames per device, one device program
            from hmrt.distrib.mesh import (make_mesh, replicate_scene,
                                           render_flythrough_sharded)
            mesh = make_mesh(axis_name="frames")
            sc = replicate_scene(scene, mesh)
            stack = np.asarray(
                render_flythrough_sharded(sc, cams, cfg, mesh))
        else:
            frames = []
            for i in range(args.flythrough):
                fr = H.render_frame(scene, frame_camera(cams, i), cfg)
                frames.append(np.asarray(fr.color))
            stack = np.stack(frames)
        dt = time.time() - t0
        out = args.output if args.output.endswith(".npy") else args.output + ".npy"
        np.save(out, stack)
        print(f"wrote {len(stack)} frames to {out} "
              f"({dt / args.flythrough * 1e3:.1f} ms/frame incl. host loop)")
        return 0

    t0 = time.time()
    if args.tile:
        if args.sharded:
            print("--tile is incompatible with --sharded",
                  file=sys.stderr)
            return 2
        from hmrt.api.tiled import render_frame_tiled
        fr = render_frame_tiled(source, cam, cfg, tile=args.tile,
                                light=light, albedo=albedo,
                                cache=args.tile_cache)
    elif args.sharded:
        from hmrt.distrib.mesh import (make_mesh, render_frame_sharded,
                                       replicate_scene)
        mesh = make_mesh()
        fr = render_frame_sharded(replicate_scene(scene, mesh), cam, cfg, mesh)
    else:
        fr = H.render_frame(scene, cam, cfg)
    img = np.asarray(fr.color)
    dt = time.time() - t0
    write_png(args.output, img)
    print(f"wrote {args.output} ({args.width}x{args.height}, map {n}^2, "
          f"{dt:.2f}s incl. compile)")
    if args.aux:
        base = args.output.rsplit(".", 1)[0]
        np.save(base + "_depth.npy", np.asarray(fr.depth))
        write_png(base + "_normal.png",
                  np.asarray(fr.normal) * 0.5 + 0.5)
        print(f"wrote {base}_depth.npy, {base}_normal.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
