"""Benchmark runner smoke tests at reduced resolution (SURVEY.md 4.5)."""

import json

import pytest

from hmrt.bench.configs import BENCH_CONFIGS, bench_scene
from hmrt.bench.runner import run_bench


def test_all_five_configs_pinned():
    assert set(BENCH_CONFIGS) == {"B1", "B2", "B3", "B4", "B5"}
    assert BENCH_CONFIGS["B1"].render.traversal == "dda"
    assert BENCH_CONFIGS["B3"].render.shadows
    assert BENCH_CONFIGS["B3"].render.shading == "phong"
    assert BENCH_CONFIGS["B4"].render.texture and BENCH_CONFIGS["B4"].render.fog
    assert BENCH_CONFIGS["B4"].animated
    assert BENCH_CONFIGS["B5"].sharded
    assert BENCH_CONFIGS["B5"].render.resolution == (2160, 3840)


def test_b1_smoke_metric_row():
    row = run_bench("B1", frames=2, scale=0.125, reps=1)
    # schema per BASELINE.json:2 (SURVEY.md section 5 observability)
    for key in ("config", "resolution", "map", "chips", "ms_per_frame",
                "fps", "mrays_per_s", "platform"):
        assert key in row, key
    assert row["config"] == "B1"
    assert row["ms_per_frame"] > 0
    json.dumps(row)  # row is JSON-serializable


def test_bench_scene_textured():
    scene, cam, terr = bench_scene(BENCH_CONFIGS["B4"].__class__(
        name="t", description="", map_n=64,
        render=BENCH_CONFIGS["B4"].render))
    assert scene.albedo is not None


def test_runner_out_file_persists_row(tmp_path):
    """--out persistence: the row must be on disk the moment timing lands,
    so bench.py's per-config deadline can never lose a measurement."""
    out = tmp_path / "row.json"
    row = run_bench("B1", frames=2, scale=0.125, reps=1,
                    out_path=str(out))
    on_disk = json.loads(out.read_text())
    assert on_disk["config"] == "B1"
    assert on_disk["ms_per_frame"] == pytest.approx(row["ms_per_frame"])


def test_runner_main_refuses_without_gpu():
    """The benchmark measures a GPU: with none, its entry point exits
    non-zero instead of timing the CPU under a device metric's name."""
    from hmrt.bench.runner import main
    with pytest.raises(SystemExit) as e:
        main(["B1", "--scale", "0.125", "--frames", "1", "--reps", "1"])
    assert "GPU" in str(e.value.code)


def test_row_names_its_device():
    row = run_bench("B1", frames=1, scale=0.125, reps=1)
    for key in ("platform", "device_kind", "device_count", "card",
                "xla_flags", "ms_per_frame_max"):
        assert key in row, key
    assert row["platform"] == "cpu" and row["card"] is None


def test_bench_cli_emit_schema():
    """bench.py's emitted line schema: metric/value/unit/detail, with the
    card count in B3's metric name; there is no CPU fallback line."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "bench_main", os.path.join(os.path.dirname(__file__), "..",
                                   "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    row = {"ms_per_frame": 2000.0, "chips": 1}
    line = mod.emit("B3", row)
    assert line["metric"].endswith("_1card")
    assert line["value"] == 2000.0 and line["detail"] is row
    assert "vs_baseline" not in line
    assert not hasattr(mod, "probe_backend")
    line = mod.emit("B2", row)
    assert line["metric"] == "ms_per_frame_B2"
