"""The L2 ratio test against a float64 reference on near-ties.

Unit-norm descriptors put |a|^2 + |b|^2 near 2 while good matches have
d^2 << 1, so the matcher's product must run at full float32 precision
(HIGHEST): a TF32 product would err by ~1e-3 in a.b, the size of the
margins below.  Each case places the best and second-best train
descriptors so that d0/d1 sits a relative ``margin`` inside or outside
the 0.75 ratio.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from imagestitch_tpu.ops.features import match


def _case(rng, d1, margin, inside, dim=128, n_other=30):
    q = rng.normal(size=dim)
    q /= np.linalg.norm(q)

    def at_distance(d):
        v = rng.normal(size=dim)
        v -= v.dot(q) * q
        v /= np.linalg.norm(v)
        # unit vector at chord distance d from q
        c = 1.0 - d * d / 2.0
        return c * q + np.sqrt(1.0 - c * c) * v

    d0 = 0.75 * d1 * (1.0 - margin if inside else 1.0 + margin)
    train = [at_distance(d0), at_distance(d1)]
    train += [at_distance(rng.uniform(1.0, 1.4)) for _ in range(n_other)]
    return q[None], np.stack(train)


def _ref_ok(qa, tb, ratio=0.75):
    d = ((qa[:, None, :] - tb[None, :, :]) ** 2).sum(-1)   # float64
    s = np.sort(d, axis=1)
    return np.argmin(d, axis=1), s[:, 0] < ratio * ratio * s[:, 1]


@pytest.mark.parametrize("d1", [0.05, 0.2])
@pytest.mark.parametrize("margin", [2e-3, 1e-2])
@pytest.mark.parametrize("inside", [True, False])
def test_ratio_test_matches_float64_on_near_ties(d1, margin, inside):
    rng = np.random.default_rng(int(d1 * 1000 + margin * 1e5 + inside))
    qa, tb = _case(rng, d1, margin, inside)
    want_i, want_ok = _ref_ok(qa, tb)
    assert bool(want_ok[0]) == inside
    i, ok = match.match_ratio(jnp.asarray(qa, jnp.float32),
                              jnp.asarray(tb, jnp.float32),
                              jnp.ones(1, bool), jnp.ones(len(tb), bool), 0.75)
    assert bool(ok[0]) == bool(want_ok[0])
    if inside:
        assert int(i[0]) == int(want_i[0]) == 0
