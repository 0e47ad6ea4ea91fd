"""The plain reference agrees with the port at a small size on the CPU.

The port is imported here only to be compared with; the reference itself
imports nothing of it (``test_bench_imports.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import reference, scene


@pytest.fixture(scope="module")
def room():
    rng = np.random.default_rng(3)
    sc = scene.make_scene(rng, (6.0, 4.0, 3.0), 2, floor_at_zero=True)
    xyz, rgb = scene.scene_cloud(sc, rng, 4000)
    t, ypr = scene.scene_pose(sc, rng, z_range=(1.3, 1.7))
    img = scene.raycast_pano(sc, t, ypr, (48, 96), "cpu").numpy()
    return sc, xyz, rgb, t, ypr, img


def test_raycast_matches_the_ports_oracle(room):
    from piccolo_tpu_torch import testing

    sc, _, _, t, ypr, img = room
    port = testing.RoomScene(size=sc.size, texture=sc.texture,
                             occluders=sc.occluders,
                             occluder_hues=sc.occluder_hues, center=sc.center)
    want = (testing.raycast_pano(port, t, ypr, (48, 96)) * 255).astype(
        np.uint8)
    assert np.mean(np.abs(img.astype(int) - want.astype(int)) > 1) < 0.01


def test_scene_draws_the_ports_numbers():
    from piccolo_tpu_torch import testing

    a = scene.scene_cloud(scene.make_scene(np.random.default_rng(9),
                                           (5.0, 5.0, 2.8), 2),
                          np.random.default_rng(1), 2000)
    b = testing.scene_cloud(testing.make_scene(np.random.default_rng(9),
                                               (5.0, 5.0, 2.8), 2),
                            np.random.default_rng(1), 2000)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_sampling_loss_equals_the_ports(room):
    from piccolo_tpu_torch.loss import Pose, sampling_loss

    _, xyz, rgb, t, ypr, img = room
    f = torch.as_tensor(img).float() / 255.0
    rng = np.random.default_rng(0)
    ts = torch.as_tensor(t + rng.normal(0, 0.1, (5, 3)), dtype=torch.float32)
    yprs = torch.as_tensor(ypr + rng.normal(0, 0.1, (5, 3)),
                           dtype=torch.float32)
    x, c = torch.as_tensor(xyz), torch.as_tensor(rgb)
    want = sampling_loss(Pose(ts, yprs[:, 0], yprs[:, 1], yprs[:, 2]), x, c, f)
    got = reference.sampling_loss(ts, reference.rot_from_ypr(yprs), x, c, f)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_colour_preparation_equals_the_ports(room):
    from piccolo_tpu_torch.color import color_match, color_mod

    _, _, rgb, _, _, img = room
    want = (color_match(img.astype(np.float32) / 255.0, rgb) * 255).astype(
        np.uint8)
    got = reference.match_color(torch.as_tensor(img), torch.as_tensor(rgb))
    assert np.mean(got.numpy() != want) < 0.002
    wi, wc = color_mod(img.astype(np.float32) / 255.0, rgb)
    gi, gc = reference.sharpen_color(torch.as_tensor(img).float() / 255.0,
                                     torch.as_tensor(rgb))
    np.testing.assert_allclose(gi.numpy(), wi, atol=1.5 / 255)
    np.testing.assert_allclose(gc.numpy(), wc, atol=1.5 / 255)


@pytest.mark.parametrize("ini", [
    dict(num_trans=150, xy_only=True, yaw_only=True, z_prior=1.5, num_yaw=8),
    dict(num_trans=50, xy_only=False, yaw_only=False, num_yaw=4, num_pitch=4,
         num_roll=4)])
def test_grids_equal_the_ports(room, ini):
    from piccolo_tpu_torch.init.candidates import (
        default_init_dict,
        generate_rot_points,
        generate_trans_points,
    )
    from piccolo_tpu_torch.ops.quantile import cloud_bounds

    xyz = room[1]
    d = default_init_dict(**ini)
    np.testing.assert_allclose(reference.trans_grid(xyz, ini),
                               generate_trans_points(xyz, d), atol=1e-6)
    np.testing.assert_allclose(reference.rot_grid(ini),
                               generate_rot_points(d), atol=1e-6)
    for a, b in zip(reference.clamp_box(xyz, 0.05), cloud_bounds(xyz, 0.05)):
        np.testing.assert_array_equal(a, b)


def test_descent_follows_the_ports(room):
    from piccolo_tpu_torch.solver import descend_starts

    _, xyz, rgb, t, ypr, img = room
    f = torch.as_tensor(img).float() / 255.0
    t0 = np.stack([t + [0.1, -0.05, 0.0], t + [-0.08, 0.06, 0.02]]).astype(
        np.float32)
    y0 = np.stack([ypr + [0.05, 0, 0], ypr - [0.04, 0, 0]]).astype(np.float32)
    lo, hi = reference.clamp_box(xyz, 0.05)
    x, c = torch.as_tensor(xyz), torch.as_tensor(rgb)
    params, losses, _, _ = descend_starts(
        f, x, c, torch.as_tensor(t0), torch.as_tensor(y0),
        torch.as_tensor(lo), torch.as_tensor(hi), None, 40, 0.1, 5, 0.8,
        "float32")
    rt, rypr, rloss = reference.descend(f, x, c, t0, y0, lo, hi, 40, 0.1, 5,
                                        0.8)
    np.testing.assert_allclose(rt.numpy(), params.t.numpy(), atol=2e-3)
    np.testing.assert_allclose(rloss.numpy(), losses.numpy(), rtol=2e-3)


def test_hist_score_ranks_as_the_port(room):
    from piccolo_tpu_torch.init.refine import hist_scores

    _, xyz, rgb, t, ypr, img = room
    f = torch.as_tensor(img).float() / 255.0
    rng = np.random.default_rng(2)
    ts = torch.as_tensor(t + rng.normal(0, 0.3, (6, 3)), dtype=torch.float32)
    yp = torch.as_tensor(ypr + rng.normal(0, 0.5, (6, 3)) * [1, 0, 0],
                         dtype=torch.float32)
    want = hist_scores(f, torch.as_tensor(xyz), torch.as_tensor(rgb), ts, yp,
                       num_split_h=4, num_split_w=4).numpy()
    got = np.array([reference.hist_score(
        f, ts[i], reference.rot_from_ypr(yp[i]), torch.as_tensor(xyz),
        torch.as_tensor(rgb), 4, 4) for i in range(6)])
    np.testing.assert_allclose(got, want, atol=0.02)
    assert np.argmax(got) == np.argmax(want)
