"""Collective-bytes model vs compiled HLO.

The analytic model's payload assumptions must match what XLA actually
compiles, at several mesh widths.  Before round 5 the feature step FAILED
this (auto-sharded adjacent-slice matching compiled to full-pool
all-gathers, 33-127x the modeled halo); the explicit-halo shard_map step
brought it to exactly 1.0.
"""
import json
import os

import pytest

from imagestitch_tpu.eval import hlo_validation


def test_model_payloads_match_compiled_hlo():
    rows = hlo_validation.run((2, 4, 8))
    assert len(rows) == 9
    for r in rows:
        assert 0.9 <= r.ratio <= 1.1, (r.subsystem, r.n_devices, r.ratio,
                                       r.collectives)


def test_feature_step_has_only_the_halo_permute():
    """No all-gather/all-reduce may appear in the sharded feature step —
    outputs stay sharded and the only exchange is the boundary halo."""
    row = hlo_validation._feature_row(4)
    assert set(row.collectives) == {"collective-permute"}, row.collectives


def test_committed_baseline_is_current():
    """baselines/hlo_bytes_validation.json mirrors a live run (regenerate
    with python -m imagestitch_tpu.eval.hlo_validation if this fails)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "baselines",
        "hlo_bytes_validation.json")
    if not os.path.exists(path):
        pytest.skip("baseline not generated yet")
    with open(path) as f:
        committed = json.load(f)
    live = {(r.subsystem, r.n_devices): r.ratio
            for r in hlo_validation.run((2, 4, 8))}
    for row in committed["rows"]:
        key = (row["subsystem"], row["n_devices"])
        assert key in live
        assert abs(live[key] - row["ratio"]) < 0.15, (key, live[key], row)
