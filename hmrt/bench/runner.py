"""Benchmark runner: executes the B1-B5 configs and emits metric rows
matching BASELINE.json:2's schema (SURVEY.md section 5, observability)."""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import jax

from hmrt.api.flythrough import orbit_flythrough
from hmrt.bench.configs import BENCH_CONFIGS, BenchConfig, bench_scene
from hmrt.bench.timing import time_animation
from hmrt.types import Camera
from hmrt.utils.cache import enable_compile_cache
from hmrt.utils.device import device_record


def _write_row(out_path, row):
    """Row persistence: the orchestrator (bench.py) kills a config
    subprocess at its deadline, so everything measured so far must already
    be on disk."""
    if not out_path:
        return
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(row, f)
    os.replace(tmp, out_path)


def run_bench(name: str, frames: int | None = None, scale: float = 1.0,
              reps: int = 3, frame_sharded: bool = False,
              out_path: str | None = None) -> dict:
    """Run one named benchmark config; returns a metric row dict.

    `scale` < 1 shrinks the framebuffer (CI smoke mode, SURVEY.md 4.5).
    `frame_sharded`: for animated configs on a multi-device mesh, shard the
    FRAME axis (distrib.mesh.render_flythrough_sharded) instead of timing
    one device — the natural B4 scaling strategy.
    `out_path`: write the row JSON to this file as soon as timing lands,
    so a caller-imposed deadline never loses the measurement.
    The row names the device it ran on; the number is that device's.
    """
    cfg = BENCH_CONFIGS[name]
    render = cfg.render
    if scale != 1.0:
        render = dataclasses.replace(
            render,
            width=max(64, int(render.width * scale) // 64 * 64),
            height=max(64, int(render.height * scale) // 64 * 64),
        )
    n_frames = frames or cfg.frames
    frame_sharded = (cfg.animated and frame_sharded
                     and len(jax.devices()) > 1)
    if frame_sharded:
        # the frame axis must divide the mesh: round the count to it
        ndev = len(jax.devices())
        n_frames = max(ndev, n_frames // ndev * ndev)

    t_setup = time.perf_counter()
    scene, cam, terr = bench_scene(cfg)
    zmax = float(terr.max())
    setup_s = time.perf_counter() - t_setup

    if cfg.animated:
        cams = orbit_flythrough(cfg.map_n, zmax, n_frames)
    else:
        # static camera repeated
        cams = Camera(
            eye=jax.numpy.broadcast_to(cam.eye, (n_frames, 3)),
            target=jax.numpy.broadcast_to(cam.target, (n_frames, 3)),
            up=jax.numpy.broadcast_to(cam.up, (n_frames, 3)),
            fov_y=jax.numpy.broadcast_to(cam.fov_y, (n_frames,)),
        )

    # hit fraction from one real frame (shadow rays exist only for hit
    # pixels — this keeps the Mrays/s metric honest on sky-heavy views)
    hit_frac = None
    if render.shadows:
        import numpy as np
        from hmrt.core.renderer import render_frame
        fr = render_frame(scene, cam, render)
        hit_frac = float(np.asarray(fr.hit).mean())

    note = None
    strategy = None
    if frame_sharded:
        from hmrt.distrib.mesh import make_mesh, replicate_scene
        from hmrt.distrib.bench import time_flythrough_frames
        mesh = make_mesh(axis_name="frames")
        scene = replicate_scene(scene, mesh)
        stats = time_flythrough_frames(scene, cams, render, n_frames,
                                       mesh, reps=reps, hit_frac=hit_frac)
        chips = len(jax.devices())
        strategy = "frame-dp"
    elif cfg.sharded and len(jax.devices()) > 1:
        from hmrt.distrib.mesh import make_mesh, replicate_scene
        from hmrt.distrib.bench import time_animation_sharded
        mesh = make_mesh()
        scene = replicate_scene(scene, mesh)
        stats = time_animation_sharded(scene, cams, render, n_frames,
                                       mesh, reps=reps, hit_frac=hit_frac)
        chips = len(jax.devices())
    else:
        if cfg.sharded:
            note = ("config is multi-device but only one device is "
                    "attached; the number is one device's")
        stats = time_animation(scene, cams, render, n_frames, reps=reps,
                               hit_frac=hit_frac)
        chips = 1

    row = {
        "config": name,
        "description": cfg.description,
        "resolution": [render.width, render.height],
        "map": cfg.map_n,
        "chips": chips,
        **device_record(),
        "setup_s": setup_s,
        **stats,
    }
    if hit_frac is not None:
        row["hit_frac"] = hit_frac
    if strategy:
        row["strategy"] = strategy
    if note:
        row["note"] = note
    _write_row(out_path, row)
    return row


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="hmrt benchmarks (B1-B5)")
    p.add_argument("configs", nargs="*", default=["B1", "B2", "B3"],
                   help="which configs to run")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--frame-sharded", action="store_true",
                   help="shard animated configs over the frame axis "
                        "(multi-device B4 strategy)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace here (SURVEY.md sec. 5)")
    p.add_argument("--out", default=None,
                   help="also write each row JSON to this file as soon as "
                        "it is measured (deadline-safe persistence)")
    args = p.parse_args(argv)
    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"hmrt benchmarks measure a GPU; JAX found {platform!r}")
    enable_compile_cache()
    from hmrt.utils.profiling import maybe_trace
    for name in args.configs:
        with maybe_trace(args.profile_dir):
            row = run_bench(name, frames=args.frames, scale=args.scale,
                            reps=args.reps, frame_sharded=args.frame_sharded,
                            out_path=args.out)
        print(json.dumps(row))


if __name__ == "__main__":
    main()
