"""Tensor-parallel sharded FFT phase correlation."""
import numpy as np
import jax.numpy as jnp
import pytest

from imagestitch_tpu.ops import phase_corr
from imagestitch_tpu.parallel import tp_fft
from imagestitch_tpu.parallel.mesh import make_mesh


def _pair(rng, h=256, w=320, shift=(40, -17)):
    base = rng.integers(0, 255, (h + 128, w + 128), np.uint8).astype(np.float32)
    # smooth for a clean correlation peak
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(np.convolve, ax, base, k, mode="same")
    a = base[64:64 + h, 64:64 + w]
    b = base[64 + shift[0]:64 + shift[0] + h, 64 + shift[1]:64 + shift[1] + w]
    return a, b


@pytest.mark.parametrize("d", [4, 8])
def test_sharded_matches_single_device(d):
    rng = np.random.default_rng(31)
    a, b = _pair(rng)
    mesh = make_mesh(d, axis="tp")
    sx_s, sy_s, r_s = tp_fft.phase_correlate_sharded(a, b, mesh)
    hp = tp_fft._pad_to(phase_corr.optimal_dft_size(a.shape[0]), d)
    wp = tp_fft._pad_to(phase_corr.optimal_dft_size(a.shape[1]), d)
    sx, sy, r = phase_corr._phase_correlate_one(
        jnp.asarray(a), jnp.asarray(b), hp, wp)
    assert abs(sx_s - float(sx)) < 0.05 and abs(sy_s - float(sy)) < 0.05
    assert abs(r_s - float(r)) < 1e-3
    # and both recover the true shift: cv2 convention reports its negation
    assert abs(-sy_s - 40) < 0.5 and abs(-sx_s - (-17)) < 0.5


def test_auto_dispatch_uses_sharded_over_budget():
    rng = np.random.default_rng(32)
    a, b = _pair(rng, shift=(12, 5))
    mesh = make_mesh(8, axis="tp")
    # tiny budget forces the sharded path; huge budget the single-chip path
    s_shard = tp_fft.phase_correlate_auto(a, b, mesh,
                                          per_chip_budget_bytes=1)
    s_one = tp_fft.phase_correlate_auto(a, b, mesh,
                                        per_chip_budget_bytes=1 << 40)
    assert abs(s_shard[0] - s_one[0]) < 0.05
    assert abs(s_shard[1] - s_one[1]) < 0.05
    assert abs(-s_one[1] - 12) < 0.5 and abs(-s_one[0] - 5) < 0.5


def test_whole_phase_routes_through_tp_fft_over_budget():
    """Driver wiring: with a mesh and a tiny HBM budget
    the whole-image phase path runs the tensor-parallel sharded FFT and
    matches the single-device offsets."""
    import numpy as np
    from imagestitch_tpu import StitchConfig
    from imagestitch_tpu.core import registration as reg
    from imagestitch_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(3)
    base = np.clip(rng.normal(128, 40, (420, 300)), 0, 255).astype(np.uint8)
    ys = rng.integers(3, 417, 3000)
    xs = rng.integers(3, 297, 3000)
    base[ys, xs] = 255
    images = np.stack([base[0:256, 0:256], base[97:353, 2:258]])
    cfg = StitchConfig(registration="phase", direction=1, direct_incre=0)
    single = reg.register_sequence_phase_whole(images, cfg)
    mesh = make_mesh(8, axis="pairs")
    tiny = cfg.replace(phase_hbm_budget=1)   # force the sharded route
    sharded = reg.register_sequence_phase_whole(images, tiny, mesh=mesh)
    assert single[0].ok and sharded[0].ok
    assert single[0].offset == sharded[0].offset == (97, 2)
    assert abs(single[0].confidence - sharded[0].confidence) < 1e-3
