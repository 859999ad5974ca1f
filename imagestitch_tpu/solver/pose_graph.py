"""Distributed 2-D translation pose-graph solver.

New capability over the reference (SURVEY §2.3 "global solver parallel"):
the reference chains pairwise offsets by prefix sum with unbounded drift
(reference: Stitcher.py:404-405).  Here pairwise offsets + confidences form a
pose graph solved by weighted least squares:

    minimize  sum_k w_k || p[b_k] - p[a_k] - m_k ||^2      (p[0] pinned)

The normal equations are a weighted graph Laplacian (two independent systems,
row/col, solved simultaneously).  Matvec = edge-parallel scatter-adds;
under ``shard_map`` the edge set is sharded over the mesh and partial
products are combined with ``psum`` — the Schur/reduction pattern of
distributed bundle adjustment specialized to translation-only poses.

Conjugate gradients converge in O(graph diameter) iterations for chains and
fast for grids; everything is fixed-shape and jittable.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..parallel.mesh import make_mesh, pad_to_multiple


@dataclasses.dataclass
class PoseGraph:
    """Edge list with measurements (drow, dcol) and confidence weights."""
    edges_a: np.ndarray        # (E,) int32 source node
    edges_b: np.ndarray        # (E,) int32 target node
    measurements: np.ndarray   # (E, 2) float32
    weights: np.ndarray        # (E,) float32 (0 = disabled/padding)
    n_nodes: int

    @classmethod
    def from_chain(cls, offsets: Sequence[Tuple[float, float]],
                   confidences: Optional[Sequence[float]] = None) -> "PoseGraph":
        """Sequential chain graph — the reference's prefix-sum structure."""
        e = len(offsets)
        w = np.ones(e, np.float32) if confidences is None else \
            np.asarray(confidences, np.float32)
        return cls(edges_a=np.arange(e, dtype=np.int32),
                   edges_b=np.arange(1, e + 1, dtype=np.int32),
                   measurements=np.asarray(offsets, np.float32).reshape(e, 2),
                   weights=w, n_nodes=e + 1)

    def with_extra_edges(self, a, b, m, w) -> "PoseGraph":
        return PoseGraph(
            edges_a=np.concatenate([self.edges_a, np.asarray(a, np.int32)]),
            edges_b=np.concatenate([self.edges_b, np.asarray(b, np.int32)]),
            measurements=np.concatenate(
                [self.measurements, np.asarray(m, np.float32).reshape(-1, 2)]),
            weights=np.concatenate([self.weights, np.asarray(w, np.float32)]),
            n_nodes=self.n_nodes)


_PIN = 1e6  # gauge prior stiffness on node 0


def _edge_matvec(p, ea, eb, w):
    """y = L @ p restricted to local edges; (N,2) -> (N,2)."""
    d = p[ea] - p[eb]                       # (E, 2)
    wd = w[:, None] * d
    y = jnp.zeros_like(p)
    y = y.at[ea].add(wd)
    y = y.at[eb].add(-wd)
    return y


def _edge_rhs(ea, eb, m, w, n):
    wm = w[:, None] * m
    b = jnp.zeros((n, 2), m.dtype)
    b = b.at[ea].add(-wm)
    b = b.at[eb].add(wm)
    return b


@functools.partial(jax.jit, static_argnames=("n_nodes", "iters"))
def _solve_single(ea, eb, m, w, n_nodes: int, iters: int):
    b = _edge_rhs(ea, eb, m, w, n_nodes)

    def matvec(p):
        y = _edge_matvec(p, ea, eb, w)
        return y.at[0].add(_PIN * p[0])

    return _cg(matvec, b, iters)


def _cg(matvec, b, iters: int):
    """Plain CG; fixed iteration count with early-exit on residual."""
    x0 = jnp.zeros_like(b)
    r0 = b
    p0 = r0
    rs0 = jnp.sum(r0 * r0)

    def body(state):
        i, x, r, p, rs = state
        ap = matvec(p)
        alpha = rs / (jnp.sum(p * ap) + 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.sum(r * r)
        beta = rs_new / (rs + 1e-30)
        p = r + beta * p
        return i + 1, x, r, p, rs_new

    def cond(state):
        i, x, r, p, rs = state
        return jnp.logical_and(i < iters, rs > 1e-10)

    _, x, _, _, _ = jax.lax.while_loop(cond, body, (0, x0, r0, p0, rs0))
    return x


def solve(graph: PoseGraph, iters: Optional[int] = None,
          mesh: Optional[Mesh] = None) -> np.ndarray:
    """Solve for absolute poses; pose[0] == (0, 0).

    With ``mesh``, edges are sharded over the mesh's first axis and the
    Laplacian matvec partial-sums ride ``psum``.
    """
    n = graph.n_nodes
    iters = iters if iters is not None else max(2 * n, 64)
    if mesh is None:
        x = _solve_single(jnp.asarray(graph.edges_a), jnp.asarray(graph.edges_b),
                          jnp.asarray(graph.measurements),
                          jnp.asarray(graph.weights), n, iters)
        return np.asarray(x - x[0:1])

    d = mesh.devices.size
    e_pad = pad_to_multiple(max(len(graph.edges_a), d), d)
    pad = e_pad - len(graph.edges_a)
    ea = np.pad(graph.edges_a, (0, pad))
    eb = np.pad(graph.edges_b, (0, pad))
    m = np.pad(graph.measurements, ((0, pad), (0, 0)))
    w = np.pad(graph.weights, (0, pad))       # zero weight disables padding

    x = sharded_solve_fn(mesh, n, iters)(ea, eb, m, w)
    return np.asarray(x - x[0:1])


def sharded_solve_fn(mesh: Mesh, n: int, iters: int):
    """The edge-sharded CG solve as a jitted callable (exposed separately
    so the HLO validator can lower it; eval/hlo_validation.py)."""
    axis = mesh.axis_names[0]

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False)
    def sharded_solve(ea_l, eb_l, m_l, w_l):
        b = jax.lax.psum(_edge_rhs(ea_l, eb_l, m_l, w_l, n), axis)

        def matvec(p):
            y = jax.lax.psum(_edge_matvec(p, ea_l, eb_l, w_l), axis)
            return y.at[0].add(_PIN * p[0])

        return _cg(matvec, b, iters)

    return jax.jit(sharded_solve)


def chain_positions(offsets: Sequence[Tuple[float, float]]) -> np.ndarray:
    """Prefix-sum baseline (the reference's accumulation) for comparison."""
    return np.concatenate([np.zeros((1, 2)),
                           np.cumsum(np.asarray(offsets, np.float64), axis=0)])
