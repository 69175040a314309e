#!/usr/bin/env python
"""Smoke test of the renderer on a GPU, through the entry points a user calls.

    python chip_smoke.py             # one card: phases (a)-(f) below
    python chip_smoke.py --cards 4   # four cards: only the multi-card path

One card, one process, at the full size of the B3 benchmark config (4096^2
map, 1920x1080, Phong and shadows):

  (a) JAX must find a GPU; without one the script exits non-zero.
  (b) three B3 frames through `render_frame`: finite colors in [0, 1] and
      a plausible hit fraction.
  (c) the chosen path against `render_frame_oracle` on the card at
      1920x1080, and the card against the CPU oracle at 480x270 on the
      same scene and camera.
  (d) the three 64^2 goldens, at most 1 LSB off.
  (e) `hmrt.cli.render.main` with --size 4096 --shadows, and a
      `hmrt.cli.serve` handler on localhost answering 3 /frame requests.
  (f) frame times of the chosen path and of the XLA oracle at B3 and B2,
      and of B3's primary march at block sizes 128, 256 and 512.
  (g) the tests marked `gpu` (pytest, in this process).

With --cards 4: `render_frame_sharded` at 3840x2160 over a 1-D mesh of the
four cards and `render_flythrough_sharded` with 8 frames, each against
single-card renders.

Tolerances. The renderer has no matrix product, so TF32 plays no part.
Two paths differ where rounding differs: Triton or XLA contracting a
multiply and an add into an FMA, and `pow`/`exp` in Phong and fog. Such a
difference flips a hit only on a ray that grazes the terrain, or one
whose hit lies on a cell edge, where world coordinates in f32 leave the
cell test a crack. So at most `FLIP_FRACTION` of the pixels may differ in
hit; each such ray must be grazing — a vertical shift of its origin by at
most `GRAZE_TOL` world units moves it across the hit/miss boundary — or
hit within `EDGE_TOL` cells of an edge in the frame where it hits; and at
most `FLIP_FRACTION` of the pixels may differ in color by more than
`COLOR_TOL` (hit or shadow flips). Any failed check exits non-zero; the
last line of a passing run is the JSON result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

import hmrt as H

REPO = os.path.dirname(os.path.abspath(__file__))

#: Largest share of pixels whose hit (or color, beyond COLOR_TOL) may differ.
FLIP_FRACTION = 1e-4
#: Color difference that counts a pixel as changed: two 8-bit levels.
COLOR_TOL = 2.0 / 255.0
#: Vertical origin shifts (world units; cells are 1 unit wide) tried by
#: `grazing_margins`, and the largest a hit flip may need.
GRAZE_LADDER = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
GRAZE_TOL = 1e-2
#: Largest distance (cells) of a flipped hit from a cell edge or diagonal.
#: f32 world x, y near 4096 carry ~2e-4 of rounding, far above the cell
#: test's 1e-6 slack; a random hit lies this close to an edge 0.6% of the
#: time.
EDGE_TOL = 1e-3


def compare_frames(hit_a, color_a, hit_b, color_b) -> dict:
    """Agreement of two renders of one view; `ok` applies the count bounds."""
    hit_a, hit_b = np.asarray(hit_a), np.asarray(hit_b)
    n = hit_a.size
    dc = np.abs(np.asarray(color_a, np.float64)
                - np.asarray(color_b, np.float64)).max(axis=-1)
    out = {"pixels": int(n), "hit_flips": int((hit_a != hit_b).sum()),
           "color_changed": int((dc > COLOR_TOL).sum()),
           "max_color_diff": float(dc.max()),
           "max_color_diff_unchanged": float(
               np.where(dc > COLOR_TOL, 0.0, dc).max())}
    bound = FLIP_FRACTION * n
    out["ok"] = bool(out["hit_flips"] <= bound
                     and out["color_changed"] <= bound)
    return out


def grazing_margins(scene, eye, dirs, max_steps, ladder=GRAZE_LADDER):
    """For each ray from `eye` along `dirs` (k, 3): the smallest vertical
    shift of its origin in `ladder` for which the XLA march decides the
    ray shifted up and the ray shifted down differently — how close the
    ray passes to a hit/miss boundary — or inf if no shift in the ladder
    separates them."""
    import jax.numpy as jnp
    from hmrt.traversal.march import march_maxmip

    dirs = jnp.asarray(dirs, jnp.float32)
    k = dirs.shape[0]
    o = [jnp.broadcast_to(jnp.asarray(eye[i], jnp.float32), (k,))
         for i in range(3)]
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels,
              max_steps=max_steps)
    out = np.full(k, np.inf)
    for delta in ladder:
        up, down = (np.asarray(march_maxmip(
            o[0], o[1], o[2] + s, dirs[:, 0], dirs[:, 1], dirs[:, 2],
            scene.pyr_flat, scene.heights.reshape(-1), **kw).hit)
            for s in (delta, -delta))
        out[(up != down) & np.isinf(out)] = delta
    return out


def edge_distance(px, py):
    """Distance, in cell units, of world points (px, py) from the nearest
    cell edge or the cell's triangle diagonal (the (1,0)-(0,1) split)."""
    u, v = px - np.floor(px), py - np.floor(py)
    return np.minimum.reduce([np.minimum(u, 1 - u), np.minimum(v, 1 - v),
                              np.abs(u + v - 1) / np.sqrt(2)])


def check_flips(name, scene, cam, render, fa, fb):
    """Every pixel whose hit differs between frames `fa` and `fb` (both
    rendered with aux buffers) must be a rounding case: a grazing ray that
    a vertical shift of at most GRAZE_TOL moves across the hit/miss
    boundary, or a ray whose hit, in the frame that has one, lies within
    EDGE_TOL of a cell edge or diagonal, where f32 world coordinates leave
    the cell test a crack that rounding decides."""
    ha, hb = (np.asarray(f.hit).reshape(-1) for f in (fa, fb))
    flips = np.flatnonzero(ha != hb)
    if flips.size == 0:
        return
    eye, dirs = cam.rays(render.height, render.width)
    eye = np.asarray(eye, np.float64)
    d = np.asarray(dirs, np.float64).reshape(-1, 3)[flips]
    t = np.where(ha[flips], np.asarray(fa.depth).reshape(-1)[flips],
                 np.asarray(fb.depth).reshape(-1)[flips])
    edge = edge_distance(eye[0] + t * d[:, 0], eye[1] + t * d[:, 1])
    margin = grazing_margins(scene, eye, d, render.steps_for(scene.n_cells))
    rows, cols = np.divmod(flips, render.width)
    detail = [f"({int(r)},{int(c)}) graze {m:g} edge {e:.1e}"
              for r, c, m, e in zip(rows, cols, margin, edge)]
    _check(f"{name}: every hit flip grazes (<= {GRAZE_TOL:g}) or sits on "
           f"an edge (<= {EDGE_TOL:g})",
           bool(((margin <= GRAZE_TOL) | (edge <= EDGE_TOL)).all()),
           "; ".join(detail))


def result_line(devices) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def _check(name, ok, detail):
    print(f"{name}: {'ok' if ok else 'FAILED'} {detail}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} failed")


def _median_ms(fn, reps=5):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2], ts[-1]


def _b3():
    from hmrt.bench.configs import BENCH_CONFIGS, bench_scene
    cfg = BENCH_CONFIGS["B3"]
    scene, cam, _ = bench_scene(cfg)
    return scene, cam, cfg.render


def phase_frames(scene, cam, render):
    hits = []
    for k in range(3):
        # three views: the camera moves by a quarter cell per 256 samples
        shift = np.float32(scene.n / 1024 * k)
        c = dataclasses.replace(cam, eye=cam.eye + shift)
        fr = H.render_frame(scene, c, render)
        col = np.asarray(fr.color)
        hits.append(float(np.asarray(fr.hit).mean()))
        _check(f"(b) B3 frame {k}",
               col.shape == (render.height, render.width, 3)
               and np.isfinite(col).all()
               and col.min() >= 0.0 and col.max() <= 1.0
               and 0.15 <= hits[-1] <= 0.45,
               f"hit_frac={hits[-1]:.4f} color in "
               f"[{col.min():.3f}, {col.max():.3f}]")


def phase_paths(scene, cam, render, small=(480, 270)):
    import jax
    from hmrt.core.renderer import render_frame_oracle

    # aux buffers give each hit's depth (check_flips); hits and colors
    # are those of `render`
    render = dataclasses.replace(render, aux_buffers=True)
    fk = H.render_frame(scene, cam, render)
    fo = render_frame_oracle(scene, cam, render)
    r = compare_frames(fk.hit, fk.color, fo.hit, fo.color)
    name = (f"(c) chosen path vs XLA oracle on the card, "
            f"{render.width}x{render.height}")
    _check(name, r["ok"], json.dumps(r))
    check_flips(name, scene, cam, render, fk, fo)

    small = dataclasses.replace(render, width=small[0], height=small[1])
    cpu = jax.devices("cpu")[0]
    fg = H.render_frame(scene, cam, small)
    with jax.default_device(cpu):
        sc_cpu = jax.device_put(scene, cpu)
        cam_cpu = jax.device_put(cam, cpu)
        fc = render_frame_oracle(sc_cpu, cam_cpu, small)
    r = compare_frames(fg.hit, fg.color, fc.hit, fc.color)
    name = f"(c) card vs CPU oracle, {small.width}x{small.height}"
    _check(name, r["ok"], json.dumps(r))
    check_flips(name, scene, cam, small, fg, fc)


def phase_goldens():
    from hmrt.bench.goldens import golden_diff, golden_render
    for name in ("b1", "b2", "b3"):
        diff = golden_diff(name, golden_render(name))
        _check(f"(d) golden {name}_64", int(diff.max()) <= 1,
               f"max diff {int(diff.max())} LSB")


def phase_cli(out_dir, map_size=4096, serve_size=1024):
    from http.server import ThreadingHTTPServer
    from urllib.request import Request, urlopen

    from hmrt.cli import render as cli_render
    from hmrt.cli import serve as cli_serve
    from hmrt.io.image import read_png

    png = os.path.join(out_dir, "cli_render.png")
    rc = cli_render.main(["--size", str(map_size), "--shadows", "-o", png])
    img = read_png(png)
    _check(f"(e) cli.render --size {map_size} --shadows", rc == 0
           and img.shape == (720, 1280, 3) and img.max() > 0,
           f"rc={rc} image {img.shape}")

    args = cli_serve.build_parser().parse_args(["--size", str(serve_size),
                                                "--shadows"])
    session = cli_serve.make_session(args)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                cli_serve.make_handler(session))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        state = json.loads(urlopen(url + "/state", timeout=600).read())
        for k, draft in enumerate((True, True, False)):
            body = dict(state, draft=draft)
            body["eye"] = [state["eye"][0] + 3.0 * k] + state["eye"][1:]
            req = Request(url + "/frame", data=json.dumps(body).encode(),
                          headers={"Content-Type": "application/json"})
            with urlopen(req, timeout=600) as resp:
                data = resp.read()
                status = resp.status
            path = os.path.join(out_dir, f"served_{k}.png")
            with open(path, "wb") as f:
                f.write(data)
            shape = read_png(path).shape
            want = ((session.draft_config if draft else session.config)
                    .resolution)
            _check(f"(e) served /frame {k}", status == 200
                   and shape[:2] == want, f"status={status} image {shape}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join()


def phase_times(scene3, cam3, render3, blocks=(128, 256, 512)):
    import jax.numpy as jnp
    from hmrt.bench.configs import BENCH_CONFIGS, bench_scene
    from hmrt.core.renderer import render_frame_oracle
    from hmrt.traversal.march_pallas import march_maxmip_pallas

    scene2, cam2, _ = bench_scene(BENCH_CONFIGS["B2"])
    for name, scene, cam, render in (
            ("B3", scene3, cam3, render3),
            ("B2", scene2, cam2, BENCH_CONFIGS["B2"].render)):
        k_med, k_max = _median_ms(lambda: H.render_frame(scene, cam, render))
        o_med, o_max = _median_ms(
            lambda: render_frame_oracle(scene, cam, render))
        print(f"(f) {name} frame ms, median/max of 5: chosen path "
              f"{k_med:.3f}/{k_max:.3f}, XLA oracle {o_med:.3f}/{o_max:.3f}",
              flush=True)

    # the primary march alone at each block size (rays per block)
    eye, dirs = cam3.rays(render3.height, render3.width)
    d = dirs.reshape(-1, 3)
    o = [jnp.broadcast_to(eye[i], d.shape[:1]) for i in range(3)]
    args = (*o, d[:, 0], d[:, 1], d[:, 2], scene3.pyr_flat,
            scene3.heights.reshape(-1))
    kw = dict(n=scene3.n, m=scene3.m, levels=scene3.levels,
              max_steps=render3.steps_for(scene3.n_cells))
    for b in blocks:
        med, mx = _median_ms(lambda: march_maxmip_pallas(*args, block=b,
                                                         **kw))
        print(f"(f) B3 primary march, block {b}: median/max of 5 "
              f"{med:.3f}/{mx:.3f} ms", flush=True)


def phase_gpu_tests():
    """(g) the tests marked `gpu`, in this process (one process per card).
    Last: the test harness turns the compile cache off."""
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    _check("(g) pytest -m gpu", rc == 0, f"exit code {int(rc)}")


def phase_cards(scene, cam, band=(3840, 2160), fly=(1920, 1080)):
    import jax
    from hmrt.api.flythrough import frame_camera, orbit_flythrough
    from hmrt.distrib.mesh import (make_mesh, render_flythrough_sharded,
                                   render_frame_sharded, replicate_scene)

    devs = jax.devices()
    render = H.RenderConfig(width=band[0], height=band[1], shading="phong",
                            shadows=True, aux_buffers=True)
    mesh = make_mesh(devs)
    scene_rep = replicate_scene(scene, mesh)
    fs = render_frame_sharded(scene_rep, cam, render, mesh)
    on = sorted(s.device.id for s in fs.color.addressable_shards)
    _check("(cards) band output on every card",
           on == sorted(d.id for d in devs), f"devices {on}")
    f1 = H.render_frame(scene, cam, render)
    r = compare_frames(fs.hit, fs.color, f1.hit, f1.color)
    name = (f"(cards) render_frame_sharded {band[0]}x{band[1]} over "
            f"{len(devs)} cards vs one card")
    _check(name, r["ok"], json.dumps(r))
    check_flips(name, scene, cam, render, fs, f1)
    s_med, s_max = _median_ms(lambda: render_frame_sharded(
        scene_rep, cam, render, mesh))
    o_med, o_max = _median_ms(lambda: H.render_frame(scene, cam, render))
    print(f"(cards) {band[0]}x{band[1]} frame ms, median/max of 5: "
          f"{len(devs)} cards {s_med:.3f}/{s_max:.3f}, one card "
          f"{o_med:.3f}/{o_max:.3f}", flush=True)

    n = scene.n
    zmax = float(np.asarray(scene.heights).max())
    cams = orbit_flythrough(n, zmax, 8)
    fcfg = H.RenderConfig(width=fly[0], height=fly[1], shading="phong",
                          shadows=True)
    fmesh = make_mesh(devs, axis_name="frames")
    stack = render_flythrough_sharded(replicate_scene(scene, fmesh), cams,
                                      fcfg, fmesh)
    shards = sorted((s.index[0].start, s.device.id)
                    for s in stack.addressable_shards)
    per = 8 // len(devs)
    _check("(cards) flythrough frames sharded one block per card",
           [d for _, d in shards] == [d.id for d in fmesh.devices.flat]
           and [i for i, _ in shards] == list(range(0, 8, per)),
           f"(first frame, device) {shards}")
    stack = np.asarray(stack)
    for i in range(8):
        fr = H.render_frame(scene, frame_camera(cams, i), fcfg)
        # the stack holds colors only, so only colors are compared
        r = compare_frames(np.ones(stack.shape[1:3], bool), stack[i],
                           np.ones(stack.shape[1:3], bool),
                           np.asarray(fr.color))
        _check(f"(cards) flythrough frame {i} vs one card", r["ok"],
               json.dumps(r))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card path on four cards")
    args = ap.parse_args(argv)

    import jax
    from hmrt.utils.cache import enable_compile_cache
    from hmrt.utils.device import card_name_and_power_limit

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devs[0].platform!r})", file=sys.stderr)
        return 2
    if len(devs) != args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX found "
              f"{len(devs)} GPUs", file=sys.stderr)
        return 2
    print(f"(a) {len(devs)} x {devs[0].device_kind}; card: "
          f"{card_name_and_power_limit()}", flush=True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    t0 = time.perf_counter()
    scene, cam, render = _b3()
    print(f"B3 scene built in {time.perf_counter() - t0:.1f}s", flush=True)
    if args.cards == 4:
        phase_cards(scene, cam)
    else:
        phase_frames(scene, cam, render)
        phase_paths(scene, cam, render)
        phase_goldens()
        with tempfile.TemporaryDirectory() as out_dir:
            phase_cli(out_dir)
        phase_times(scene, cam, render)
        phase_gpu_tests()
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    print(result_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
