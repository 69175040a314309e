"""chip_smoke.py's comparison and result-line helpers, and its refusal to
run without a GPU (the card phases themselves run only on the card)."""

import json

import jax
import numpy as np
import pytest

import chip_smoke as cs


def _frame(h=40, w=60):
    """A horizon view: terrain below row 20, sky above."""
    hit = np.zeros((h, w), bool)
    hit[20:] = True
    color = np.where(hit[..., None], 0.4, 0.8) * np.ones((h, w, 3))
    return hit, color


def test_identical_frames_agree():
    hit, color = _frame()
    r = cs.compare_frames(hit, color, hit, color)
    assert r["ok"] and r["hit_flips"] == 0 and r["max_color_diff"] == 0.0


def test_one_flip_is_within_the_count_bound():
    hit, color = _frame(120, 200)        # 24,000 pixels: bound 2.4
    hit2, color2 = hit.copy(), color.copy()
    hit2[30, 7] = False
    color2[30, 7] = 0.8
    r = cs.compare_frames(hit2, color2, hit, color)
    assert r["hit_flips"] == 1 and r["color_changed"] == 1 and r["ok"]


def test_too_many_flips_or_color_changes_fail():
    hit, color = _frame()
    hit2 = hit.copy()
    hit2[20, :] = False          # 60 flips of 2,400 pixels
    assert not cs.compare_frames(hit2, color, hit, color)["ok"]
    color2 = color.copy()
    color2[30:33] += 0.1         # 180 pixels changed beyond COLOR_TOL
    r = cs.compare_frames(hit, color2, hit, color)
    assert not r["ok"] and r["hit_flips"] == 0
    color3 = color + 0.5 * cs.COLOR_TOL   # rounding-level: unchanged
    r = cs.compare_frames(hit, color3, hit, color)
    assert r["ok"] and r["color_changed"] == 0
    assert r["max_color_diff_unchanged"] == pytest.approx(0.5 * cs.COLOR_TOL)


def test_grazing_margin_of_a_ray_tangent_to_a_peak():
    """A flat map with one spike of height 1: a level ray at z = 1 through
    the spike's vertex is decided by the smallest vertical shift; a ray one
    unit higher by none, and one through the ground by none either."""
    from hmrt.api.scene import make_scene
    h = np.zeros((17, 17), np.float32)
    h[8, 8] = 1.0
    scene = make_scene(h)
    d = np.asarray([[1.0, 0.0, 0.0]], np.float32)
    margins = [cs.grazing_margins(scene, np.asarray([-3.0, 8.0, z],
                                                    np.float32), d, 512)[0]
               for z in (1.0, 2.0, 0.5)]
    assert margins[0] == cs.GRAZE_LADDER[0]
    assert np.isinf(margins[1]) and np.isinf(margins[2])


def test_result_line_is_the_contract_json():
    line = cs.result_line(jax.devices()[:1])
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind, "count": 1}}


def test_main_exits_nonzero_without_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_edge_distance_to_cell_edges_and_diagonal():
    px = np.asarray([3.0, 3.5, 3.25, 7.9995, 3.5])
    py = np.asarray([0.5, 0.5, 0.25, 2.4, 1.5004])
    e = cs.edge_distance(px, py)
    np.testing.assert_allclose(e[:2], [0.0, 0.0], atol=1e-12)  # edge, diag
    assert e[2] == pytest.approx(0.25)
    assert e[3] == pytest.approx(5e-4, rel=1e-3)
    assert e[4] == pytest.approx(4e-4 / np.sqrt(2), rel=1e-2)
