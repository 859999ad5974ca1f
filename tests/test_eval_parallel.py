"""Eval harnesses + distributed helpers on the virtual mesh."""
import numpy as np
import pytest

import jax

from imagestitch_tpu.eval import scaling, synthetic
from imagestitch_tpu.parallel import distributed, pipeline
from imagestitch_tpu.parallel.mesh import make_mesh


def test_synthetic_grid_solver_beats_chain():
    res = synthetic.run(10, 10, n_devices=8, iters=300, seed=3)
    assert res.n_tiles == 100
    assert res.mean_abs_err_px < 2.0
    assert res.mean_abs_err_px < res.chain_mean_abs_err_px / 3


def test_scaling_harness_runs():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (50 * 9 + 128, 256), np.uint8)
    images = np.stack([base[50 * i:50 * i + 128] for i in range(9)])
    rep = scaling.run(images, device_counts=[1, 8], repeats=1)
    assert len(rep.points) == 2
    assert all(p.frames_per_s > 0 for p in rep.points)


def test_host_shard_overlap():
    ctx = distributed.RuntimeContext(mesh=make_mesh(8), process_index=1,
                                     process_count=4)
    files = [f"f{i}" for i in range(10)]
    shard = distributed.host_shard(files, ctx)
    # host 1 of 4: per=3 -> files 3..6 inclusive of one overlap frame
    assert shard == ["f3", "f4", "f5", "f6"]
    ctx0 = distributed.RuntimeContext(mesh=make_mesh(8), process_index=0,
                                      process_count=1)
    assert distributed.host_shard(files, ctx0) == files


def test_distributed_stitch_step_end_to_end():
    mesh = make_mesh(8, axis="pairs")
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (60 * 17 + 128, 256), np.uint8)
    images = np.stack([base[60 * i:60 * i + 128] for i in range(17)])
    poses = pipeline.distributed_stitch_step(images, mesh, direction=1,
                                             ratio=0.6, cg_iters=64)
    assert poses.shape == (17, 2)
    # true inter-frame offset is (60, 0); poses ~ i*60
    steps = np.diff(poses[:, 0])
    assert np.abs(steps - 60).max() < 1.5
    assert np.abs(poses[:, 1]).max() < 1.5


def _blob_strip_sequence(rng, n, h=128, w=192, step=60):
    """Textured frames cut from one blob field: true offset (step, 0)."""
    base = np.zeros((step * n + h, w), np.float32)
    ys = rng.integers(3, base.shape[0] - 3, 3000)
    xs = rng.integers(3, w - 3, 3000)
    for y, x, a in zip(ys, xs, rng.uniform(60, 200, 3000)):
        base[y - 2:y + 3, x - 2:x + 3] += a
    base = np.clip(base, 0, 255).astype(np.uint8)
    return np.stack([base[step * i:step * i + h] for i in range(n)])


def test_feature_step_sharded_matches_unsharded():
    """The flagship feature pipeline runs sharded over the mesh and agrees
    with the single-device result."""
    rng = np.random.default_rng(5)
    images = _blob_strip_sequence(rng, 9)
    mesh = make_mesh(8, axis="pairs")
    sh = pipeline.register_pairs_sharded_features(images, mesh,
                                                  direction=1, ratio=0.6)
    un = pipeline.register_pairs_sharded_features(images, None,
                                                  direction=1, ratio=0.6)
    for a, b in zip(sh, un):
        np.testing.assert_allclose(a, b, atol=1e-3)
    dr, dc, nv = sh[0], sh[1], sh[2]
    assert np.all(nv >= 3)
    assert np.all(np.abs(dr - 60) <= 1) and np.all(np.abs(dc) <= 1)


def test_distributed_feature_step_end_to_end():
    rng = np.random.default_rng(6)
    images = _blob_strip_sequence(rng, 11)
    mesh = make_mesh(8, axis="pairs")
    poses = pipeline.distributed_stitch_step_features(
        images, mesh, direction=1, ratio=0.6, cg_iters=64)
    assert poses.shape == (11, 2)
    steps = np.diff(poses[:, 0])
    assert np.abs(steps - 60).max() < 1.5
    assert np.abs(poses[:, 1]).max() < 1.5


def test_scaling_harness_feature_mode():
    rng = np.random.default_rng(7)
    images = _blob_strip_sequence(rng, 9)
    rep = scaling.run(images, device_counts=[1, 8], repeats=1,
                      mode="feature")
    assert rep.mode == "feature"
    assert len(rep.points) == 2
    assert all(p.frames_per_s > 0 for p in rep.points)
