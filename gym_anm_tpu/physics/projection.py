"""Exact Euclidean projection onto small 2-D polytopes.

Device-side replacement for the per-device cvxpy QPs of the reference
(``gym_anm/simulator/components/devices.py:282-306`` for generators and
``:474-524`` for storage units).  Each device's feasible (P, Q) region is a
convex polygon described by at most ~10 half-planes; the projection of a
point onto such a region is either

* the point itself (if feasible),
* its orthogonal projection onto the supporting line of one facet, or
* a vertex (intersection of two supporting lines).

Enumerating all of these candidates with static shapes and picking the
feasible one with minimum distance yields the EXACT minimizer of
``min ‖x − point‖²  s.t.  A·x ≤ b`` — equal to the reference's interior-point
(ECOS/OSQP) answer up to the latter's solver tolerance, while being a few
fused element-wise ops instead of a host round-trip.  Fully vmappable over
devices and environment lanes.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def make_pair_indices(k):
    """Static upper-triangular pair indices for a K-constraint polytope."""
    iu = np.triu_indices(k, 1)
    return np.asarray(iu[0]), np.asarray(iu[1])


# ---------------------------------------------------------------------------
# Specialized box + sloped-line projector
# ---------------------------------------------------------------------------
#
# Every device polytope the reference builds (devices.py:282-306, 474-524) has
# the same template: an axis-aligned box (p/q bounds, potential caps, SoC-rate
# caps) intersected with a few NON-axis-aligned half-planes that are always
# upper or lower bounds on q along a line:
#
#     upper:  q <= t·p + r      (generator row [-τ₁, 1]·x <= ρ₁, etc.)
#     lower:  q >= t·p + r      (generator row [ τ₂,-1]·x <= -ρ₂, etc.)
#
# For this shape the exact Euclidean projection needs no candidate
# enumeration at all.  Let y = clip(x, box):
#
# * if y satisfies every sloped row, then y ∈ R and (projection onto a
#   superset landing inside the subset) y = P_R(x) — done;
# * otherwise the sloped rows cannot all be inactive at the solution (an
#   inactive-slope KKT point would equal y, which is infeasible), so the
#   solution lies on the EDGE of some active sloped line: the segment of
#   {q = t·p + r} inside the remaining constraints.  The projection onto a
#   segment is the foot of the perpendicular with its line parameter clamped
#   to the segment — and since every other constraint is linear in p along
#   the line, the segment is a p-interval computed by interval
#   intersection.  Each edge projection that exists is feasible, and the
#   true solution is one of them, so the distance-argmin over edges is
#   exact.
#
# Cost: ~60 fused elementwise ops with NO candidate axis, versus the general
# enumeration's [1 + K + K(K-1)/2] candidates × K feasibility checks
# (29×7 for generators, 56×10 for storage).  Results equal
# :func:`project_polytope_2d` up to float rounding (the general path builds
# the same feet/vertices through different expressions); equality is pinned
# in tests/test_projection.py at 1e-9 in float64.


def _ival_ge(c, d, lo, hi, empty):
    """Intersect the p-interval [lo, hi] with {p : c·p >= d} (branchless).

    ``d = -inf`` encodes "no constraint" (inactive rows); NaN ``c`` (from
    inactive-row slope arithmetic) compares False everywhere and is a no-op.
    """
    safe = jnp.where(c != 0, c, 1.0)
    v = d / safe
    lo = jnp.where(c > 0, jnp.maximum(lo, v), lo)
    hi = jnp.where(c < 0, jnp.minimum(hi, v), hi)
    empty = empty | ((c == 0) & (d > 0))
    return lo, hi, empty


def _edge_project(i, lines, px, py, p_lo, p_hi, q_lo, q_hi):
    """Project (px, py) onto the feasible segment of sloped line ``i``.

    ``lines`` = [(t, r, act, is_upper), ...]; returns (d2, p*, q*) with
    d2 = +inf where the edge is empty or the line inactive.
    """
    t, r, act, _ = lines[i]
    resid = py - (t * px + r)
    foot_p = px + t * resid / (1.0 + t * t)

    shape = jnp.broadcast_shapes(jnp.shape(px), jnp.shape(p_lo), jnp.shape(p_hi))
    lo = jnp.broadcast_to(p_lo, shape)
    hi = jnp.broadcast_to(p_hi, shape)
    empty = jnp.zeros(shape, bool)
    # q-box along the line:  q_lo <= t·p + r <= q_hi.
    lo, hi, empty = _ival_ge(t, q_lo - r, lo, hi, empty)
    lo, hi, empty = _ival_ge(-t, r - q_hi, lo, hi, empty)
    for j, (tj, rj, actj, upper_j) in enumerate(lines):
        if j == i:
            continue
        if upper_j:  # this line's q must stay <= line j:  (tj - t)·p >= r - rj
            lo, hi, empty = _ival_ge(tj - t, jnp.where(actj, r - rj, -jnp.inf), lo, hi, empty)
        else:        # ... and >= lower line j:  (t - tj)·p >= rj - r
            lo, hi, empty = _ival_ge(t - tj, jnp.where(actj, rj - r, -jnp.inf), lo, hi, empty)

    p_star = jnp.clip(foot_p, lo, hi)
    q_star = t * p_star + r
    valid = act & (lo <= hi) & ~empty
    d2 = jnp.where(valid, (p_star - px) ** 2 + (q_star - py) ** 2, jnp.inf)
    return d2, p_star, q_star


def _box_slopes_core(px, py, p_lo, p_hi, q_lo, q_hi, lines):
    """Elementwise exact projection (see module comment).  All arguments
    broadcast; ``lines`` entries are (t, r, act, is_upper)."""
    yx = jnp.clip(px, p_lo, p_hi)
    yy = jnp.clip(py, q_lo, q_hi)
    feas = ~((p_lo > p_hi) | (q_lo > q_hi))
    for t, r, act, is_upper in lines:
        tol = 1e-11 * (1.0 + jnp.abs(r))
        viol = (yy - (t * yx + r)) if is_upper else ((t * yx + r) - yy)
        feas &= jnp.where(act, viol <= tol, True)

    # Best edge projection (falls back to the unprojected point when every
    # edge is empty — i.e. the region itself is empty, matching the general
    # enumeration's all-candidates-infeasible behavior).
    best_d2 = jnp.full(jnp.broadcast_shapes(jnp.shape(px), jnp.shape(p_lo)),
                       jnp.inf, dtype=jnp.result_type(px))
    bx, by = jnp.broadcast_to(px, best_d2.shape), jnp.broadcast_to(py, best_d2.shape)
    for i in range(len(lines)):
        d2, cx, cy = _edge_project(i, lines, px, py, p_lo, p_hi, q_lo, q_hi)
        take = d2 < best_d2
        best_d2 = jnp.where(take, d2, best_d2)
        bx = jnp.where(take, cx, bx)
        by = jnp.where(take, cy, by)

    out_x = jnp.where(feas, yx, bx)
    out_y = jnp.where(feas, yy, by)
    return out_x, out_y


def make_box_slopes_projector(q_lo, q_hi, uppers, lowers):
    """Bind a device family's static rows into a projector
    ``project(point [G,2], p_lo [G], p_hi [G]) -> [G,2]``.

    ``q_lo``/``q_hi``: [G] static q bounds (±inf when the row is absent).
    ``uppers``/``lowers``: sequences of (t [G], r [G], active [G]) static
    sloped rows (q <= t·p + r resp. q >= t·p + r).

    The p bounds stay dynamic arguments because the devices' p caps move at
    runtime (generator potential, storage SoC-rate rows).  vmap over a
    leading lane axis dispatches to a batch-minor [G, B] layout — the same
    trick as :func:`project_polytope_2d`: batch-leading [B, G] tails with
    G ≈ 5 would leave the minor dimension almost empty.
    """
    q_lo = np.asarray(q_lo)
    q_hi = np.asarray(q_hi)
    lines = [(np.asarray(t), np.asarray(r), np.asarray(a), True) for t, r, a in uppers]
    lines += [(np.asarray(t), np.asarray(r), np.asarray(a), False) for t, r, a in lowers]

    def run(point, p_lo, p_hi, batched):
        if batched:
            # -> [G, B] batch-minor layouts; statics broadcast as [G, 1].
            px = jnp.transpose(point[..., 0], (1, 0))
            py = jnp.transpose(point[..., 1], (1, 0))
            expand = lambda a: jnp.asarray(a)[:, None] if jnp.ndim(a) == 1 else jnp.transpose(a, (1, 0))
            p_lo_b, p_hi_b = expand(p_lo), expand(p_hi)
            ql, qh = q_lo[:, None], q_hi[:, None]
            ls = [(t[:, None], r[:, None], a[:, None], u) for t, r, a, u in lines]
            ox, oy = _box_slopes_core(px, py, p_lo_b, p_hi_b, ql, qh, ls)
            return jnp.stack([ox.T, oy.T], axis=-1)
        ox, oy = _box_slopes_core(point[..., 0], point[..., 1], p_lo, p_hi, q_lo, q_hi, lines)
        return jnp.stack([ox, oy], axis=-1)

    @jax.custom_batching.custom_vmap
    def project(point, p_lo, p_hi):
        return run(point, p_lo, p_hi, batched=False)

    @project.def_vmap
    def _rule(axis_size, in_batched, point, p_lo, p_hi):
        pb, lb, hb = in_batched

        def bcast(x, batched):
            return x if batched else jnp.broadcast_to(x, (axis_size,) + jnp.shape(x))

        out = run(bcast(point, pb), bcast(p_lo, lb), bcast(p_hi, hb), batched=True)
        return out, True

    return project


def _project_batched(point, A, b, pair_i, pair_j):
    """Batch-minor projection: point [B,G,2], A [B,G,K,2], b [B,G,K].

    Same candidate enumeration as :func:`_project_impl`, but every
    intermediate keeps the LANE axis on the minor (last) dimension.  Under
    plain vmap the per-lane [n_cand, K] intermediates land batch-leading,
    so each op's tiny (n_cand, K) tail is the minor dimension.  With
    [n_cand, K, G, B] layouts the lane dim is minor and dense instead.
    (Chosen for the previous accelerator's tiled layouts; ROADMAP's Speed
    queue decides it again on the GPU.)
    """
    pair_i = np.asarray(pair_i)
    pair_j = np.asarray(pair_j)
    # -> [K, G, B] / [G, B] layouts.
    px = jnp.transpose(point[..., 0], (1, 0))            # [G, B]
    py = jnp.transpose(point[..., 1], (1, 0))
    ax = jnp.transpose(A[..., 0], (2, 1, 0))             # [K, G, B]
    ay = jnp.transpose(A[..., 1], (2, 1, 0))
    bt = jnp.transpose(b, (2, 1, 0))                     # [K, G, B]

    finite_A = jnp.isfinite(ax) & jnp.isfinite(ay)
    nonzero_A = (jnp.abs(ax) + jnp.abs(ay)) > 0
    active = jnp.isfinite(bt) & finite_A & nonzero_A
    tol = 1e-11 * (1.0 + jnp.abs(bt))

    nrm2 = ax * ax + ay * ay
    resid = ax * px[None] + ay * py[None] - bt
    scale = resid / jnp.where(nrm2 > 0, nrm2, 1.0)
    lp_x = jnp.where(active, px[None] - ax * scale, jnp.inf)
    lp_y = jnp.where(active, py[None] - ay * scale, jnp.inf)

    aix, aiy, bi = ax[pair_i], ay[pair_i], bt[pair_i]    # [P, G, B]
    ajx, ajy, bj = ax[pair_j], ay[pair_j], bt[pair_j]
    det = aix * ajy - aiy * ajx
    ok = (jnp.abs(det) > 1e-30) & active[pair_i] & active[pair_j]
    safe_det = jnp.where(ok, det, 1.0)
    vx = jnp.where(ok, (bi * ajy - bj * aiy) / safe_det, jnp.inf)
    vy = jnp.where(ok, (aix * bj - ajx * bi) / safe_det, jnp.inf)

    Cx = jnp.concatenate([px[None], lp_x, vx], axis=0)   # [C, G, B]
    Cy = jnp.concatenate([py[None], lp_y, vy], axis=0)

    K = ax.shape[0]
    feas = jnp.isfinite(Cx) & jnp.isfinite(Cy)
    for k in range(K):                                    # static unroll
        viol_k = Cx * ax[k][None] + Cy * ay[k][None] - bt[k][None]
        feas &= jnp.where(active[k][None], viol_k <= tol[k][None], True)

    d2 = (Cx - px[None]) ** 2 + (Cy - py[None]) ** 2
    d2 = jnp.where(feas, d2, jnp.inf)
    best = jnp.argmin(d2, axis=0)                        # [G, B]
    out_x = jnp.take_along_axis(Cx, best[None], axis=0)[0]
    out_y = jnp.take_along_axis(Cy, best[None], axis=0)[0]
    return jnp.stack([out_x.T, out_y.T], axis=-1)        # [B, G, 2]


@partial(jnp.vectorize, excluded=(3, 4), signature="(two),(k,two),(k)->(two)")
def _project_impl(point, A, b, pair_i, pair_j):
    # NOTE on style: every "A·x" below is written as explicit 2-term
    # broadcast arithmetic (ax·x + ay·y), NOT as @/dot.  Under vmap over
    # lanes×devices the dot form becomes a huge batch of [29,2]@[2,K]
    # tiny matmuls, each a separate kernel; the expanded form is plain
    # fused elementwise work.
    ax, ay = A[:, 0], A[:, 1]
    px, py = point[0], point[1]

    # Row k is "active" if it describes a real constraint: finite b, finite
    # non-zero normal.  Rows with b=+inf (unbounded sides) or NaN data
    # (degenerate tau/rho from infinite bounds) never bind.
    finite_A = jnp.isfinite(ax) & jnp.isfinite(ay)
    nonzero_A = (jnp.abs(ax) + jnp.abs(ay)) > 0
    active = jnp.isfinite(b) & finite_A & nonzero_A

    # Feasibility tolerance: tight (the candidates are exact up to rounding).
    tol = 1e-11 * (1.0 + jnp.abs(b))

    # Candidates 1..K: projection onto each supporting line
    #   c = x − a (aᵀx − b) / ‖a‖².
    nrm2 = ax * ax + ay * ay
    resid = ax * px + ay * py - b
    scale = resid / jnp.where(nrm2 > 0, nrm2, 1.0)
    lp_x = jnp.where(active, px - ax * scale, jnp.inf)
    lp_y = jnp.where(active, py - ay * scale, jnp.inf)

    # Candidates: pairwise intersections (vertices).
    aix, aiy, bi = ax[pair_i], ay[pair_i], b[pair_i]
    ajx, ajy, bj = ax[pair_j], ay[pair_j], b[pair_j]
    det = aix * ajy - aiy * ajx
    ok = (jnp.abs(det) > 1e-30) & active[pair_i] & active[pair_j]
    safe_det = jnp.where(ok, det, 1.0)
    vx = jnp.where(ok, (bi * ajy - bj * aiy) / safe_det, jnp.inf)
    vy = jnp.where(ok, (aix * bj - ajx * bi) / safe_det, jnp.inf)

    # All candidates: the point, K line projections, K(K−1)/2 vertices.
    Cx = jnp.concatenate([px[None], lp_x, vx])
    Cy = jnp.concatenate([py[None], lp_y, vy])

    viol = Cx[:, None] * ax[None, :] + Cy[:, None] * ay[None, :] - b[None, :]
    feas = jnp.all(jnp.where(active[None, :], viol <= tol[None, :], True), axis=1)
    feas &= jnp.isfinite(Cx) & jnp.isfinite(Cy)
    d2 = (Cx - px) ** 2 + (Cy - py) ** 2
    d2 = jnp.where(feas, d2, jnp.inf)
    best = jnp.argmin(d2)
    return jnp.stack([Cx[best], Cy[best]])


def _make_project_cv(pair_i, pair_j):
    """A custom-vmap projection bound to one static pair-index set: per
    lane it is the vectorized candidate enumeration; under ``vmap`` the
    whole batch dispatches to the batch-minor kernel (same candidates,
    same tie-breaking order)."""

    @jax.custom_batching.custom_vmap
    def project(point, A, b):
        return _project_impl(point, A, b, pair_i, pair_j)

    @project.def_vmap
    def _rule(axis_size, in_batched, point, A, b):
        pb, Ab, bb = in_batched

        def bcast(x, batched):
            return x if batched else jnp.broadcast_to(x, (axis_size,) + x.shape)

        out = _project_batched(bcast(point, pb), bcast(A, Ab), bcast(b, bb),
                               pair_i, pair_j)
        return out, True

    return project


_PROJECT_CV_CACHE = {}


def project_polytope_2d(point, A, b, pair_idx):
    """Project ``point`` [G, 2] onto {x : A x ≤ b} per device.

    A: [G, K, 2], b: [G, K]; ``pair_idx`` from :func:`make_pair_indices`.
    vmap over a leading lane axis dispatches to a batch-minor layout
    (see :func:`_project_batched`).
    """
    pi = np.asarray(pair_idx[0])
    pj = np.asarray(pair_idx[1])
    key = (pi.tobytes(), pj.tobytes())
    fn = _PROJECT_CV_CACHE.get(key)
    if fn is None:
        fn = _make_project_cv(np.asarray(pair_idx[0]), np.asarray(pair_idx[1]))
        _PROJECT_CV_CACHE[key] = fn
    return fn(point, A, b)
