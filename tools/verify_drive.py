#!/usr/bin/env python
"""End-to-end drive of the library surface on the current backend
(the .claude/skills/verify recipe, scripted): render the recipe frame,
write the PNG, and run the skill's probe set. Prints one summary line
per check; exits nonzero on any failure."""
import os
import sys
import tempfile

import numpy as np

import hmrt as H

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import jax
    print("backend:", jax.default_backend(), flush=True)
    terr = H.procedural_terrain(1024, seed=3)
    scene = H.make_scene(terr)
    cam = H.Camera.create(eye=(512, -200, float(terr.max()) + 80),
                          target=(512, 512, float(terr.mean())))
    cfg = H.RenderConfig(width=640, height=360, shading="phong",
                         shadows=True)
    fr = H.render_frame(scene, cam, cfg)
    col = np.asarray(fr.color)
    hitf = float(np.asarray(fr.hit).mean())
    ok = np.isfinite(col).all() and 0.0 <= col.min() and col.max() <= 1.0
    print(f"main frame: hit_frac={hitf:.3f} finite+bounded={bool(ok)}",
          flush=True)
    assert ok and 0.25 <= hitf <= 0.75, (hitf, ok)
    from hmrt.io.image import write_png
    png = os.path.join(tempfile.gettempdir(), "verify_out.png")
    write_png(png, col)
    print(f"wrote {png}", flush=True)

    # probe: camera under the terrain — must terminate, majority hits
    # (rays that exit the box sides below the surface are legitimate
    # misses; measured 0.62 on this seed)
    cam_u = H.Camera.create(eye=(512, 512, float(terr.min()) - 5),
                            target=(700, 700, float(terr.mean())))
    hit_u = float(np.asarray(H.render_frame(scene, cam_u, cfg).hit).mean())
    print(f"under-terrain: hit_frac={hit_u:.3f}", flush=True)
    assert hit_u > 0.5, hit_u

    # probe: outside the box looking away — all sky
    cam_s = H.Camera.create(eye=(-2000, -2000, float(terr.max()) + 500),
                            target=(-4000, -4000, float(terr.max()) + 900))
    hit_s = float(np.asarray(H.render_frame(scene, cam_s, cfg).hit).mean())
    print(f"all-sky: hit_frac={hit_s:.3f}", flush=True)
    assert hit_s == 0.0, hit_s

    # probe: dda vs maxmip pixel-for-pixel
    cfg_d = H.RenderConfig(width=320, height=180, shading="phong",
                           shadows=True, traversal="dda")
    cfg_m = H.RenderConfig(width=320, height=180, shading="phong",
                           shadows=True, traversal="maxmip")
    fd = H.render_frame(scene, cam, cfg_d)
    fm = H.render_frame(scene, cam, cfg_m)
    same = np.array_equal(np.asarray(fd.hit), np.asarray(fm.hit))
    cdiff = float(np.abs(np.asarray(fd.color)
                         - np.asarray(fm.color)).max())
    print(f"dda-vs-maxmip: hits_equal={same} color_maxdiff={cdiff:.2e}",
          flush=True)
    assert same and cdiff < 5e-5

    # driver hook: entry() compiles and runs
    sys.path.insert(0, REPO)
    import __graft_entry__ as g
    fn, a = g.entry()
    jax.block_until_ready(fn(*a))
    print("entry() ok", flush=True)
    print("VERIFY_DRIVE_OK", flush=True)


if __name__ == "__main__":
    main()
