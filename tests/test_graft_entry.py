"""Driver entry-point contract: entry() compiles single-chip and
dryrun_multichip() jits the full sharded step over an 8-device mesh."""
import os
import sys

import jax
import pytest


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_entry_compiles_and_runs():
    import __graft_entry__ as g
    fn, args = g.entry()
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    out = compiled(*args)
    jax.block_until_ready(out)


def test_dryrun_multichip_eight_devices():
    import __graft_entry__ as g
    assert len(jax.devices()) >= 8
    g.dryrun_multichip(8)


def test_dryrun_multichip_fails_with_too_few_devices():
    """No silent fallback: asking for more devices than exist is an error."""
    import __graft_entry__ as g
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        g.dryrun_multichip(64)
