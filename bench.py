#!/usr/bin/env python
"""Benchmark: one JSON line per config (B3 first, and again last).

Each config runs in its own subprocess (`python -m hmrt.bench.runner`),
one at a time, so one process holds the card; this parent never imports
JAX. A config's subprocess refuses to run without a GPU, so with no card
every config fails and this script exits non-zero. Every row names the
device, its kind and count, the card's name and power limit, and
XLA_FLAGS.

    python bench.py [--quick]
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.monotonic()

# (config, frames, reps, deadline_s); B3 leads — it is the headline row
_PLAN = [("B3", 4, 5, 1200), ("B1", 2, 5, 480), ("B2", 3, 5, 420),
         ("B4", 3, 3, 900), ("B5", 2, 3, 800)]


def _env():
    env = dict(os.environ)
    parts = [p for p in env.get("PYTHONPATH", "").split(":") if p]
    if REPO not in parts:
        parts.insert(0, REPO)
    env["PYTHONPATH"] = ":".join(parts)
    return env


def _log(msg):
    sys.stderr.write(f"[bench +{time.monotonic() - T0:6.0f}s] {msg}\n")
    sys.stderr.flush()


def run_config(name, frames, reps, deadline_s, scale=1.0):
    """One config in a subprocess with a wall-time box. Returns the row
    dict, or None."""
    fd, out_path = tempfile.mkstemp(prefix=f"bench_{name}_", suffix=".json")
    os.close(fd)
    os.unlink(out_path)
    cmd = [sys.executable, "-m", "hmrt.bench.runner", name,
           "--frames", str(frames), "--reps", str(reps),
           "--out", out_path]
    if scale != 1.0:
        cmd += ["--scale", str(scale)]
    try:
        r = subprocess.run(cmd, timeout=deadline_s, capture_output=True,
                           text=True, env=_env())
        if r.returncode != 0:
            _log(f"{name} subprocess rc={r.returncode}: "
                 f"{(r.stderr or '').strip()[-400:]}")
    except subprocess.TimeoutExpired:
        _log(f"{name} hit its {deadline_s}s deadline")
    try:
        with open(out_path) as f:
            row = json.load(f)
        os.unlink(out_path)
        return row
    except (OSError, ValueError):
        return None


def emit(name, row):
    line = {
        "metric": f"ms_per_frame_{name}",
        "value": row["ms_per_frame"],
        "unit": "ms",
        "detail": row,
    }
    if name == "B3":
        line["metric"] = ("ms_per_frame_B3_4096sq_1920x1080_shadows_"
                          f"phong_{row.get('chips', 1)}card")
    print(json.dumps(line), flush=True)
    return line


def main():
    quick = "--quick" in sys.argv
    scale = 0.25 if quick else 1.0
    b3_line = None
    failed = []
    for name, frames, reps, deadline in _PLAN:
        if quick:
            frames, reps = 2, 1
        row = run_config(name, frames, reps, deadline, scale=scale)
        if row is None:
            _log(f"{name} produced no row")
            failed.append(name)
            continue
        line = emit(name, row)
        if name == "B3":
            b3_line = line
    if b3_line is not None:
        print(json.dumps(b3_line), flush=True)
    if failed:
        sys.exit(3)


if __name__ == "__main__":
    main()
