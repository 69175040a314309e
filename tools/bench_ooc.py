#!/usr/bin/env python
"""Out-of-core tiled-render timing at B4 scale.

Generates (once) an 8192^2 raw-f32 terrain on disk, mmaps it through
RawTileMap, and times `api.tiled.render_frame_tiled` — the path for maps
too large for HBM — with tile culling on, reporting per-view ms/frame and
how many tiles the cull actually rendered/marched. Wall-clock timing is
honest here by construction: the tiled path is host-orchestrated (every
tile render fetches its composite to host), so the host clock sees the
whole render; the camera shifts a little per rep.

Usage: python tools/bench_ooc.py [--side 8192] [--tile 2048] [--reps 1]
       [--shadows] [--no-cull] [--raw existing.raw]
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=8192)
    ap.add_argument("--tile", type=int, default=2048)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--shadows", action="store_true")
    ap.add_argument("--no-cull", action="store_true")
    ap.add_argument("--cache", type=int, default=0, metavar="N",
                    help="TileSceneCache size (persists across reps of a "
                         "view: rep 0 = cold, rep 1+ = warm)")
    ap.add_argument("--raw", default=None, help="existing raw-f32 file")
    args = ap.parse_args()

    import hmrt as H
    from hmrt.api.tiled import render_frame_tiled
    from hmrt.io.native import RawTileMap

    from hmrt.utils.device import device_record

    print(json.dumps({"device": device_record()}), flush=True)
    path = args.raw or os.path.join(tempfile.gettempdir(),
                                    f"ooc_{args.side}.raw")
    if not os.path.exists(path):
        t0 = time.time()
        terr = H.procedural_terrain(args.side, seed=3)  # B4's terrain
        np.asarray(terr, np.float32).tofile(path)
        print(f"# generated {path} in {time.time() - t0:.1f}s", flush=True)

    src = RawTileMap(path)
    n = src.side
    probe = src.tile(0, 0, min(n, 512), min(n, 512))
    zmax, zmean = float(probe.max()), float(probe.mean())
    cfg = H.RenderConfig(width=args.width, height=args.height,
                         shading="phong", fog=True, shadows=args.shadows)

    views = {
        # B4's still camera: sees most of the map (cull win small)
        "high-oblique": ((n * 0.5, -n * 0.25, zmax + n * 0.06),
                         (n * 0.5, n * 0.5, zmean)),
        # low corner shot: most tiles behind/occluded (cull win large)
        "low-corner": ((n * 0.08, n * 0.08, zmax + n * 0.01),
                       (n * 0.5, n * 0.5, zmean)),
    }
    from hmrt.api.tiled import TileSceneCache
    for name, (eye, tgt) in views.items():
        cache = TileSceneCache(args.cache)
        for rep in range(args.reps):
            shift = 0.37 * rep
            cam = H.Camera.create(eye=(eye[0] + shift, eye[1], eye[2]),
                                  target=tgt)
            stats = {}
            t0 = time.time()
            fr = render_frame_tiled(src, cam, cfg, tile=args.tile,
                                    cull=not args.no_cull, cache=cache,
                                    _stats=stats)
            hit_frac = float(np.asarray(fr.hit).mean())
            dt = time.time() - t0
            print(json.dumps({
                "view": name, "rep": rep, "side": n, "tile": args.tile,
                "resolution": [cfg.width, cfg.height],
                "shadows": args.shadows, "cull": not args.no_cull,
                "ms_per_frame": round(dt * 1e3, 1),
                "hit_frac": round(hit_frac, 4), **stats,
            }), flush=True)


if __name__ == "__main__":
    main()
