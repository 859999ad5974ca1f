"""REAL multi-process bring-up of the multi-host runtime.

Spawns two OS processes that run ``jax.distributed.initialize`` against a
local coordinator (CPU backend, 4 virtual devices each = 8 global), execute
``host_shard`` -> per-host decode -> ``make_global_batch`` -> one jitted
sharded registration step -> a cross-process reduction ->
``all_gather_records``, and asserts both hosts gather identical records that
equal the single-process run.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "multiproc_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _load_worker_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("multiproc_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_process_runtime(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)        # worker sets its own device count
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), "2", str(pid), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}"

    recs = []
    for pid in (0, 1):
        with open(tmp_path / f"proc{pid}.json") as f:
            recs.append(json.load(f))
    assert recs[0]["process_count"] == recs[1]["process_count"] == 2
    assert recs[0]["global_devices"] == 8
    assert recs[0]["local_devices"] == 4
    # disjoint pair ownership covering all 8 pairs
    assert sorted(recs[0]["my_pairs"] + recs[1]["my_pairs"]) == list(range(8))
    # both hosts gathered the SAME global record table over DCN
    r0 = np.asarray(recs[0]["records"])
    r1 = np.asarray(recs[1]["records"])
    np.testing.assert_array_equal(r0, r1)
    assert r0.shape == (8, 3)
    # cross-process reduction agrees on both hosts and with the records
    assert recs[0]["mean_resp"] == pytest.approx(recs[1]["mean_resp"])
    assert recs[0]["mean_resp"] == pytest.approx(float(r0[:, 2].mean()),
                                                 abs=1e-5)

    # --- equals the single-process run -------------------------------------
    from imagestitch_tpu.ops import phase_corr
    frames = _load_worker_module().make_frames(0, 9, 9)
    a = np.stack([frames[k] for k in range(8)])
    b = np.stack([frames[k + 1] for k in range(8)])
    sx, sy, resp = phase_corr.phase_correlate_batch(a, b)
    np.testing.assert_allclose(r0[:, 0], sx, atol=1e-4)
    np.testing.assert_allclose(r0[:, 1], sy, atol=1e-4)
    np.testing.assert_allclose(r0[:, 2], resp, atol=1e-4)
    # the registration is correct: true offset (40, 0) -> sy ~ -40 or 40
    assert np.all(np.abs(np.abs(sy) - 40) < 1.5)
