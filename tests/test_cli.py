"""End-to-end CLI test on a synthetic project tree.

Exercises the full L5->L1 stack the way a user would: a project directory
laid out like the reference's (``<project>/1/*.png``, reference
Stitcher.py:167-168), driven through ``imagestitch_tpu.cli`` argv parsing,
with outputs written as ``stitching_result_1.png`` (Stitcher.py:175-180
naming).
"""
import os

import numpy as np
import pytest

from imagestitch_tpu import cli
from imagestitch_tpu.io import codec


def _make_strip_project(tmp_path, n=4, h=96, w=128, step=60, seed=7,
                        smooth=False):
    """n vertically-overlapping frames cut from one textured master image."""
    rng = np.random.default_rng(seed)
    master = rng.integers(0, 256, ((n - 1) * step + h, w), np.uint8)
    if smooth:  # correlated texture (feature detectors need gradients)
        m = master.astype(np.float32)
        m = (m + np.roll(m, 1, 0) + np.roll(m, 1, 1)) / 3.0
        master = m.astype(np.uint8)
    proj = tmp_path / "proj" / "1"
    proj.mkdir(parents=True)
    for k in range(n):
        frame = master[k * step:k * step + h]
        codec.imwrite(str(proj / f"img-{k:03d}.png"), frame)
    return str(tmp_path / "proj"), master


def test_cli_stitch_phase_roundtrip(tmp_path):
    proj, master = _make_strip_project(tmp_path)
    out = str(tmp_path / "out")
    rc = cli.main([
        "stitch", proj, out,
        "--file-extension", "png", "--output-extension", "png",
        "--registration", "phase_incre", "--direction", "1",
        "--direct-incre", "0", "--roi-ratio", "0.4", "--gray",
        "--fuse-method", "notFuse",
    ])
    assert rc == 0
    result = os.path.join(out, "stitching_result_1.png")
    assert os.path.exists(result)
    pano = codec.imread(result, color=False)
    # phase centroid + int() truncation (reference semantics,
    # Stitcher.py:231-232) can lose 1 px per pair
    n_pairs = 3
    assert pano.shape[1] == master.shape[1]
    assert abs(pano.shape[0] - master.shape[0]) <= n_pairs
    # first frame is pasted verbatim at the canvas origin; rows strictly
    # above the earliest possible second-frame paste row (step-1) are its own
    np.testing.assert_array_equal(pano[:59], master[:59])


def test_cli_stitch_feature_path(tmp_path):
    proj, master = _make_strip_project(tmp_path, n=3, h=128, w=160, step=70,
                                       smooth=True)
    out = str(tmp_path / "outf")
    rc = cli.main([
        "stitch", proj, out,
        "--file-extension", "png", "--output-extension", "png",
        "--registration", "feature_incre", "--direction", "1",
        "--direct-incre", "0", "--roi-ratio", "0.3", "--gray",
        "--fuse-method", "fadeInAndFadeOut",
        "--offset-evaluate", "3",
    ])
    assert rc == 0
    pano = codec.imread(os.path.join(out, "stitching_result_1.png"),
                        color=False)
    # feature path recovers the exact integer shifts -> master-shaped pano
    assert pano.shape == master.shape


def test_cli_bad_project_is_graceful(tmp_path, capsys):
    out = str(tmp_path / "out")
    empty = tmp_path / "empty" / "1"
    empty.mkdir(parents=True)
    rc = cli.main(["stitch", str(tmp_path / "empty"), out,
                   "--file-extension", "png"])
    assert rc == 0
    assert "skipping" in capsys.readouterr().out


def test_cli_platform_flag_selects_backend(tmp_path):
    """--platform pins the jax backend before the first dispatch.

    Runs in a SUBPROCESS: jax caches backends on first use, so an in-process
    assertion after the suite has already dispatched would only ever see the
    conftest's backend.  The child asserts the backend itself after the
    stitch."""
    import subprocess
    import sys

    proj, _ = _make_strip_project(tmp_path)
    out = str(tmp_path / "out")
    code = (
        "import sys\n"
        "from imagestitch_tpu import cli\n"
        f"rc = cli.main(['stitch', {proj!r}, {out!r},\n"
        "    '--file-extension', 'png', '--output-extension', 'png',\n"
        "    '--registration', 'phase_incre', '--direction', '1',\n"
        "    '--direct-incre', '0', '--roi-ratio', '0.4', '--gray',\n"
        "    '--fuse-method', 'notFuse', '--platform', 'cpu'])\n"
        "import jax\n"
        "assert rc == 0, rc\n"
        "assert jax.default_backend() == 'cpu', jax.default_backend()\n"
        "print('BACKEND_OK')\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)   # the FLAG must do the pinning
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BACKEND_OK" in res.stdout
    assert os.path.exists(os.path.join(out, "stitching_result_1.png"))


def test_cli_platform_flag_fails_loudly_after_backend_init(tmp_path):
    """Once a backend is initialized in-process, --platform for a DIFFERENT
    platform must error instead of silently doing nothing."""
    import jax
    import jax.numpy as jnp

    np.asarray(jnp.zeros(1))       # force backend init (cpu via conftest)
    proj, _ = _make_strip_project(tmp_path)
    with pytest.raises(SystemExit, match="already"):
        cli.main(["stitch", proj, str(tmp_path / "out"),
                  "--file-extension", "png", "--platform", "gpu"])


def test_cli_platform_flag_accepts_the_live_backend(tmp_path):
    """With the backend already up, naming that same platform is valid
    and the stitch runs in-process."""
    import jax
    import jax.numpy as jnp

    np.asarray(jnp.zeros(1))
    proj, master = _make_strip_project(tmp_path)
    out = str(tmp_path / "out")
    rc = cli.main(["stitch", proj, out, "--file-extension", "png",
                   "--output-extension", "png", "--registration",
                   "phase_incre", "--direct-incre", "0", "--roi-ratio", "0.4",
                   "--gray", "--fuse-method", "notFuse", "--quiet",
                   "--platform", jax.devices()[0].platform])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "stitching_result_1.png"))
