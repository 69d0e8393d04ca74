"""On-device batched N-stage DC-OPF MPC.

The host tier (:mod:`gym_anm_tpu.agents.mpc`) solves one LP per env step
with scipy HiGHS — the shape of the reference's cvxpy agent
(``gym_anm/agents/mpc.py:161-393``), one host round-trip per action.  This
module solves the SAME LP (the two tiers share one
:class:`~gym_anm_tpu.agents.mpc.DCOPFStructure` assembly) for thousands of
lanes at once, inside ``jit``/``vmap``/``lax.scan``, so MPC-in-the-loop
rollouts and dataset generation run entirely on the device.

The solver is an OSQP-style ADMM.  The key fit to this problem family —
and to a batched accelerator — is that the constraint matrix is *lane-invariant*: across
a batch of grids only the bound vector varies (pinned load forecasts,
renewable potential caps, the stage-0 SoC), so the ADMM's quasi-definite
KKT system ``(σI + Aᵀdiag(ρ)A) x̃ = rhs`` is factorized ONCE on the host
and every device iteration is four shared-matrix matvecs — batched into
``[B,·]@[·,·]`` matmuls under ``vmap``, exactly the pattern of the
chord load-flow solver (docs/performance.md).  Warm-starting from the
previous env step's scaled ADMM state (passed back verbatim — the
successive LPs differ only in a few bound entries, so no stage shift is
applied) makes the steady-state iteration count a small fraction of the
cold solve.

Scaling follows OSQP: modified Ruiz equilibration of A plus cost
normalization, computed host-side in float64.  Convergence is declared on
UNSCALED primal/dual residuals with absolute+relative tolerances, checked
every iteration inside the ``while_loop`` (the residual terms fall out of
matvecs the iteration already needs).

**Alternate optima.** The DC-OPF LP is frequently degenerate (a zero-cost
DES/renewable power trade leaves a whole optimal face): HiGHS returns a
vertex while ADMM converges to some other point of the face, so stage-0
actions can differ by O(1) MW between the two solvers *at equal objective
and feasibility* (measured on a 20-step ANM6Easy rollout: objective gap
≤ 4e-4, constraint violation ≤ 2e-5, action gap up to 2.2 MW on the
degenerate steps, ≤ 3e-3 MW on the unique-optimum ones).  Tests therefore
pin action parity on non-degenerate instances and objective parity +
feasibility along rollouts (tests/test_vec_mpc.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..agents.mpc import DCOPFStructure

_BIG = 1e20
_HIGHEST = jax.lax.Precision.HIGHEST


class VecDCOPF(NamedTuple):
    """Host-prefactorized, device-resident batched DC-OPF solver spec.

    All arrays are jnp in the compute dtype except the static numpy index
    maps (which become constants of the compiled program).
    """

    # Scaled problem data (OSQP form: min q̄ᵀx̄ s.t. l̄ ≤ Āx̄ ≤ ū).
    A_bar: jax.Array      # [m, n]
    M_inv: jax.Array      # [n, n] = (σI + Āᵀdiag(ρ)Ā)⁻¹
    # [n+m, n] = [M⁻¹; Ā·M⁻¹] (f64 host product): one matvec per sweep
    # yields x̃ AND Āx̃ together — the sweep's 3 shared-matrix matmuls
    # become 2.  Ā·(M⁻¹·rhs) re-associated as (Ā·M⁻¹)·rhs changes only
    # f32 rounding (the product itself is exact f64); the ADMM fixed
    # point is unchanged and the exit rule tests true residuals.
    P_pack: jax.Array
    q_bar: jax.Array      # [n]
    rho: jax.Array        # [m] per-row step size (equality rows ×rho_eq_factor)
    inv_rho: jax.Array    # [m]
    D: jax.Array          # [n] column scaling (x = D·x̄)
    D_inv: jax.Array      # [n]
    E: jax.Array          # [m] row scaling
    E_inv: jax.Array      # [m]
    c_scale: jax.Array    # scalar cost scaling
    # Unscaled bound templates + per-lane slot rows (static indices).
    l_tmpl: jax.Array     # [m]
    u_tmpl: jax.Array     # [m]
    load_rows: np.ndarray  # [n_load, N] rows of l/u pinned to the load forecast
    gen_rows: np.ndarray   # [n_gen_ns, N] rows of u capped by the potential
    soc_rows: np.ndarray   # [n_des] equality rows carrying init_soc
    gen_pmax: jax.Array    # [n_gen_ns] static generator upper bounds
    # Solution extraction.
    act_idx: np.ndarray    # stage-0 P variable indices (gens then DES)
    baseMVA: float
    # ADMM constants.
    sigma: float
    alpha: float
    max_iter: int
    eps_abs: float
    eps_rel: float
    n: int
    m: int
    # Plateau exit (see solve_dcopf): accept after this many iterations in
    # which NEITHER residual improved, provided the primal meets its
    # STRICT tolerance and the dual is within its reference scale
    # (dual_plateau_cap × d_ref) — a lane still orders of magnitude above
    # scale must never be declared converged by the stall rule.
    # feas_band_factor bounds the primal band of DCOPFSolution.feasible
    # (informative; the controller's idle gate is bounds_ok).
    dual_stall_limit: int = 100
    dual_plateau_cap: float = 1.0
    feas_band_factor: float = 10.0
    # Residual/exit evaluation cadence: the convergence check (6 max-
    # reductions + the stall/strict/plateau select chain) costs ~40% of a
    # bare ADMM iteration, and solves run 1e2-4e3 iterations — so the
    # check runs every `check_every` iterations (delaying an exit by at
    # most check_every-1 cheap iterations).  1 reproduces the
    # check-every-iteration program exactly.
    check_every: int = 8


class DCOPFSolution(NamedTuple):
    x: jax.Array          # [n] unscaled primal solution
    warm: tuple           # (x̄, ȳ, z̄, Āx̄) — pass back in to warm-start
    iterations: jax.Array  # int32
    r_prim: jax.Array     # unscaled ∞-norm primal residual
    r_dual: jax.Array     # unscaled ∞-norm dual residual
    converged: jax.Array  # bool — optimality confirmed (strict or plateau)
    # bool — the LP data itself is solvable: no crossed bound row (a
    # pinned load outside its box, a potential cap below a positive gen
    # p_min).  This is what makes the host tier's HiGHS call FAIL and take
    # the idle fallback — the gate make_vec_mpc mirrors.  On an
    # unsolvable lane the ADMM loop is skipped entirely (0 iterations).
    bounds_ok: jax.Array
    # bool — the iterate is additionally inside the primal measurement
    # band (feas_band_factor × the strict tolerance).  Informative, and a
    # stricter optional gate: on stiff multi-stage f32 problems the
    # residual MEASUREMENTS floor above the strict tolerances while the
    # iterate sits at the true optimum (converged stays False), and on
    # borderline lanes the band flickers — which is why the controller
    # does NOT idle on it (a near-feasible near-optimal dispatch beats a
    # zero dispatch, and the env projects actions onto the device
    # polytopes anyway).
    feasible: jax.Array


def _ruiz_equilibrate(A, q, iters=15):
    """OSQP's modified Ruiz scaling (∞-norm), host float64.

    Returns (D, E, c) with Ā = diag(E)·A·diag(D), q̄ = c·D·q.
    """
    m, n = A.shape
    D = np.ones(n)
    E = np.ones(m)
    c = 1.0
    q = np.asarray(q, dtype=np.float64)
    for _ in range(iters):
        Ab = E[:, None] * A * D[None, :]
        col = np.max(np.abs(Ab), axis=0)
        row = np.max(np.abs(Ab), axis=1)
        col[col == 0] = 1.0
        row[row == 0] = 1.0
        D *= 1.0 / np.sqrt(col)
        E *= 1.0 / np.sqrt(row)
        # Cost normalization (P = 0, so only the linear term matters).
        qn = np.max(np.abs(c * D * q))
        if qn > 0:
            gamma = 1.0 / np.sqrt(qn)
            c *= gamma
    return D, E, c


def make_vec_dcopf(
    structure: DCOPFStructure,
    dtype=jnp.float32,
    rho: float = 1.0,
    rho_eq_factor: float = 1e2,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    max_iter: int = 4000,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    dual_stall_limit: int = 100,
    dual_plateau_cap: float = 1.0,
    feas_band_factor: float = 10.0,
    check_every: int = 8,
) -> VecDCOPF:
    """Prefactorize a :class:`DCOPFStructure` into a device solver spec."""
    n = structure.n_var
    A_eq = structure.A_eq.toarray().astype(np.float64)
    n_eq = A_eq.shape[0]
    if structure.A_ub is not None:
        A_ub = structure.A_ub.toarray().astype(np.float64)
        b_ub = np.asarray(structure.b_ub, dtype=np.float64)
    else:
        A_ub = np.zeros((0, n))
        b_ub = np.zeros(0)
    n_ub = A_ub.shape[0]
    A = np.vstack([A_eq, A_ub, np.eye(n)])
    m = A.shape[0]

    l_tmpl = np.concatenate([structure.b_eq, np.full(n_ub, -np.inf), structure.lb])
    u_tmpl = np.concatenate([structure.b_eq, b_ub, structure.ub])
    l_tmpl = np.where(np.isfinite(l_tmpl), l_tmpl, -_BIG)
    u_tmpl = np.where(np.isfinite(u_tmpl), u_tmpl, _BIG)

    D, E, c_scale = _ruiz_equilibrate(A, structure.c)
    A_bar = E[:, None] * A * D[None, :]
    q_bar = c_scale * D * structure.c

    # ρ is problem-regime dependent (measured on ANM6Easy, f32, HiGHS
    # cross-checked): warm-started N=1 rollouts run ~40% fewer iterations
    # at ρ=0.1 (mean/max 316/660 vs 527/1110 at ρ=1.0, objective gap
    # 3.5e-4), but the stiffer COLD N=4 problem's primal stalls at ~1e-4
    # under ρ=0.1 (never converges) while ρ=1.0 finishes in ~4.8k
    # iterations — so the robust 1.0 stays the default and callers tune
    # per workload.  OSQP-style per-lane adaptive ρ was considered and
    # rejected: each lane would select its own KKT inverse, putting a
    # [B, n, n] gather on the hot path (the architecture invariant the
    # chord solver is built around — CLAUDE.md).
    # Per-row step size: equality rows (template l == u; the load-pin rows
    # are l == u at runtime too) take a stiffer rho_eq_factor·ρ, like
    # OSQP.  OSQP's own 1e3 was the round-3 default and is the measured
    # CAUSE of the f32 long-horizon failure: at eq=1e3 the cold N=16
    # ANM6Easy problem exits max_iter (40k) structurally INFEASIBLE
    # (objective 2.7e-3 below the LP optimum) and cold N=8 needs 13.6k
    # iterations, while eq=1e2 converges every documented stress problem
    # (N=16: 2.6k iters, obj gap -2.4e-5, violation 1.4e-5; N=8: 0.95k)
    # and cuts warm N=1 rollout iterations — the 1e3 spread inflates
    # κ(σI+ĀᵀρĀ) past what f32 matvecs can serve.  Sweep evidence:
    # scripts/exp_admm_conditioning.py, docs/performance.md.
    is_eq = np.abs(u_tmpl - l_tmpl) < 1e-12
    rho_v = np.where(is_eq, rho_eq_factor * rho, rho)

    M = sigma * np.eye(n) + A_bar.T @ (rho_v[:, None] * A_bar)
    M_inv = np.linalg.inv(M)
    P_pack = np.concatenate([M_inv, A_bar @ M_inv], axis=0)

    bound0 = n_eq + n_ub  # first identity (variable-bound) row
    return VecDCOPF(
        A_bar=jnp.asarray(A_bar, dtype=dtype),
        M_inv=jnp.asarray(M_inv, dtype=dtype),
        P_pack=jnp.asarray(P_pack, dtype=dtype),
        q_bar=jnp.asarray(q_bar, dtype=dtype),
        rho=jnp.asarray(rho_v, dtype=dtype),
        inv_rho=jnp.asarray(1.0 / rho_v, dtype=dtype),
        D=jnp.asarray(D, dtype=dtype),
        D_inv=jnp.asarray(1.0 / D, dtype=dtype),
        E=jnp.asarray(E, dtype=dtype),
        E_inv=jnp.asarray(1.0 / E, dtype=dtype),
        c_scale=jnp.asarray(c_scale, dtype=dtype),
        l_tmpl=jnp.asarray(l_tmpl, dtype=dtype),
        u_tmpl=jnp.asarray(u_tmpl, dtype=dtype),
        load_rows=bound0 + structure.load_pin_idx,
        gen_rows=bound0 + structure.gen_cap_idx,
        soc_rows=structure.soc_rows,
        gen_pmax=jnp.asarray(structure.gen_pmax, dtype=dtype),
        act_idx=structure.act_idx,
        baseMVA=float(structure.baseMVA),
        sigma=float(sigma),
        alpha=float(alpha),
        max_iter=int(max_iter),
        eps_abs=float(eps_abs),
        eps_rel=float(eps_rel),
        n=int(n),
        m=int(m),
        dual_stall_limit=int(dual_stall_limit),
        dual_plateau_cap=float(dual_plateau_cap),
        feas_band_factor=float(feas_band_factor),
        check_every=int(check_every),
    )


def lane_bounds(spec: VecDCOPF, P_load, P_pot, init_soc):
    """Per-lane UNSCALED (l, u) from the current grid state (all p.u.).

    ``P_load`` [n_load] or [n_load, N] (constant forecast broadcast when
    1-D); likewise ``P_pot`` [n_gen_ns(, N)]; ``init_soc`` [n_des].
    """
    N = spec.load_rows.shape[1]
    dt = spec.l_tmpl.dtype
    P_load = jnp.asarray(P_load, dtype=dt)
    P_pot = jnp.asarray(P_pot, dtype=dt)
    init_soc = jnp.asarray(init_soc, dtype=dt)
    if P_load.ndim == 1:
        P_load = jnp.broadcast_to(P_load[:, None], spec.load_rows.shape)
    if P_pot.ndim == 1:
        P_pot = jnp.broadcast_to(P_pot[:, None], spec.gen_rows.shape)
    gen_cap = jnp.minimum(spec.gen_pmax[:, None], P_pot)

    l = spec.l_tmpl.at[spec.load_rows.ravel()].set(P_load.ravel())
    u = spec.u_tmpl.at[spec.load_rows.ravel()].set(P_load.ravel())
    u = u.at[spec.gen_rows.ravel()].set(gen_cap.ravel())
    l = l.at[spec.soc_rows].set(init_soc)
    u = u.at[spec.soc_rows].set(init_soc)
    return l, u


def make_shift_warm(spec: VecDCOPF, structure: DCOPFStructure, planning_steps: int):
    """Receding-horizon warm-start shift: ``shift(warm) -> warm``.

    At env time t the N-stage plan's stage k targets t+k; at t+1 the new
    stage k targets what was stage k+1 — so the previous solution shifted
    UP one stage block is the aligned initialization (the last stage is
    duplicated).  Both the variable vector and the constraint rows are
    stage-blocked contiguously (``MPCAgent._build_structure`` appends
    per-stage: eq rows = n_bus + 2·n_des per stage, ub rows = 2 per
    finite-rate branch per stage, identity rows = the variable layout), so
    the shift is a static gather.  Scaled-space bookkeeping: with
    x = D·x̄, z̄ = E·z, y = E·ȳ/c the shifted scaled iterates pick up the
    per-index scale ratios D[src]/D[dst], E[dst]/E[src], E[src]/E[dst]
    (host-precomputed constants); Āx̄ is recomputed with one matvec.

    For ``planning_steps == 1`` there is nothing to shift — returns
    identity (the in-place warm start).
    """
    if planning_steps == 1:
        return lambda warm: warm
    n = structure.n_var
    stage_n = n // planning_steps
    n_eq = structure.A_eq.shape[0]
    n_ub = 0 if structure.A_ub is None else structure.A_ub.shape[0]
    eq_ps = n_eq // planning_steps
    ub_ps = n_ub // planning_steps
    assert stage_n * planning_steps == n and eq_ps * planning_steps == n_eq
    assert ub_ps * planning_steps == n_ub

    def src_of(count, per_stage):
        idx = np.arange(count)
        return np.where(idx < count - per_stage, idx + per_stage, idx)

    var_src = src_of(n, stage_n)
    row_src = np.concatenate(
        [src_of(n_eq, eq_ps), n_eq + src_of(n_ub, ub_ps), n_eq + n_ub + var_src]
    )
    D = np.asarray(spec.D, np.float64)
    E = np.asarray(spec.E, np.float64)
    dt = spec.l_tmpl.dtype
    x_ratio = jnp.asarray(D[var_src] / D, dtype=dt)
    z_ratio = jnp.asarray(E / E[row_src], dtype=dt)
    y_ratio = jnp.asarray(E[row_src] / E, dtype=dt)
    var_src = jnp.asarray(var_src)
    row_src = jnp.asarray(row_src)

    def shift(warm):
        x, y, z, _ = warm
        x2 = x[var_src] * x_ratio
        y2 = y[row_src] * y_ratio
        z2 = z[row_src] * z_ratio
        Ax2 = jnp.dot(spec.A_bar, x2, precision=_HIGHEST)
        return (x2, y2, z2, Ax2)

    return shift


def init_warm(spec: VecDCOPF):
    """Cold-start ADMM state (scaled space): zeros."""
    dt = spec.l_tmpl.dtype
    z = jnp.zeros(spec.m, dtype=dt)
    return (jnp.zeros(spec.n, dtype=dt), jnp.zeros(spec.m, dtype=dt), z, z)


def solve_dcopf(spec: VecDCOPF, l, u, warm=None) -> DCOPFSolution:
    """Solve one lane's DC-OPF by ADMM; ``vmap`` for a batch.

    ``l``/``u`` are the unscaled per-lane bounds from :func:`lane_bounds`;
    ``warm`` is a previous solution's ``.warm`` tuple (scaled space).
    """
    if warm is None:
        warm = init_warm(spec)
    x, y, z, Ax = warm

    # Scale the bounds; infinities stay ±BIG so clip() passes them through.
    l_bar = jnp.where(l <= -_BIG, -_BIG, spec.E * l)
    u_bar = jnp.where(u >= _BIG, _BIG, spec.E * u)

    q_ref = jnp.max(jnp.abs(spec.D_inv * spec.q_bar)) / spec.c_scale

    def cond(carry):
        it, done = carry[4], carry[-1]
        return jnp.logical_and(it < spec.max_iter, jnp.logical_not(done))

    def sweep(_, s):
        """One bare ADMM iteration (no residuals): 3 shared-matrix
        matvecs (the matmul work; HIGHEST: convergence-feeding) + the
        relax/clip/dual elementwise chain.  The KKT rhs needs only
        Āᵀ(ρz − y) — one matvec, not the two (Āᵀρz, Āᵀy) the textbook
        form suggests; Āᵀy alone is needed only by the dual residual,
        which is evaluated once per check, not per sweep."""
        x, y, z, Ax = s
        t = jnp.dot(spec.rho * z - y, spec.A_bar, precision=_HIGHEST)
        rhs = spec.sigma * x - spec.q_bar + t
        # One packed matvec yields x̃ and Āx̃ (see P_pack): 2 matmuls per
        # sweep instead of 3, re-association exact in the f64 host product.
        w = jnp.dot(spec.P_pack, rhs, precision=_HIGHEST)
        xt = w[: spec.n]
        zt = w[spec.n:]                                               # Āx̃

        x_new = spec.alpha * xt + (1.0 - spec.alpha) * x
        Ax_new = spec.alpha * zt + (1.0 - spec.alpha) * Ax
        z_pre = spec.alpha * zt + (1.0 - spec.alpha) * z + spec.inv_rho * y
        z_new = jnp.clip(z_pre, l_bar, u_bar)
        y_new = spec.rho * (z_pre - z_new)
        return (x_new, y_new, z_new, Ax_new)

    K = spec.check_every

    def body(carry):
        x, y, z, Ax, it, _, _, best_rp, best_rd, stall, _ = carry
        # K bare sweeps per convergence check: the residual reductions +
        # exit select chain cost a large share of a sweep, and solves run 1e2-4e3
        # iterations, so checking every iteration wastes real time.  An
        # exit is delayed by at most K-1 sweeps.  K=1 is the original
        # check-every-iteration program (modulo the dual residual now
        # being CURRENT rather than one iteration late).
        x_new, y_new, z_new, Ax_new = jax.lax.fori_loop(
            0, K, sweep, (x, y, z, Ax)
        )

        # Unscaled residuals of the NEW iterate; Āᵀy_new computed here,
        # once per check.
        t_y = jnp.dot(y_new, spec.A_bar, precision=_HIGHEST)
        r_prim = jnp.max(jnp.abs(spec.E_inv * (Ax_new - z_new)))
        r_dual = jnp.max(jnp.abs(spec.D_inv * (spec.q_bar + t_y))) / spec.c_scale
        p_ref = jnp.maximum(
            jnp.max(jnp.abs(spec.E_inv * Ax_new)), jnp.max(jnp.abs(spec.E_inv * z_new))
        )
        d_ref = jnp.maximum(jnp.max(jnp.abs(spec.D_inv * t_y)) / spec.c_scale, q_ref)
        # Exit rule, same best-so-far plateau-acceptance design as the
        # chord load-flow solver (physics/power_flow.py): STRICT exit when
        # both residuals meet their tolerances, PLATEAU exit when neither
        # residual has improved for dual_stall_limit iterations AND the
        # iterate is inside the acceptance bands (detailed below).
        # Improvement threshold scales with the check cadence: over K
        # sweeps a converging iterate should improve ~K times the
        # per-iteration factor.
        improved = jnp.logical_or(
            r_dual < best_rd * (1.0 - 1e-3 * K),
            r_prim < best_rp * (1.0 - 1e-3 * K),
        )
        best_rp_new = jnp.minimum(best_rp, r_prim)
        best_rd_new = jnp.minimum(best_rd, r_dual)
        stall_new = jnp.where(improved, 0, stall + 1).astype(jnp.int32)
        tol_p = spec.eps_abs + spec.eps_rel * p_ref
        strict = jnp.logical_and(
            r_prim <= tol_p,
            r_dual <= spec.eps_abs + spec.eps_rel * d_ref,
        )
        # Plateau: STRICT primal (primal polish is what sets action
        # quality — the degenerate DES coordinates drift inside a looser
        # band) + dual within its reference scale.  This is the rule the
        # parity tolerances were measured under, plus the scale cap: a
        # dual still orders of magnitude above d_ref (gross suboptimality)
        # is never accepted, while a dual that merely floors high in f32
        # (N=4 floors at ~8e-2·d_ref with the iterate at the HiGHS
        # optimum) is.  Stiff multi-stage f32 problems whose PRIMAL
        # measurement also floors (N=8: r_prim ~1e-4 with the iterate AT
        # the HiGHS objective; f64 confirms true convergence at r_dual
        # ~1e-3) exit at max_iter with converged=False — still a usable
        # dispatch, which is why the controller idles only on bounds_ok
        # (the host tier's HiGHS-failure semantic), not on this flag.
        # dual_stall_limit is specified in ITERATIONS; stall counts
        # checks, so convert (ceil — never exit earlier than asked).
        stall_checks = -(-spec.dual_stall_limit // K)
        plateau = jnp.logical_and(
            stall_new >= stall_checks,
            jnp.logical_and(r_prim <= tol_p,
                            r_dual <= spec.dual_plateau_cap * d_ref),
        )
        done = jnp.logical_or(strict, plateau)
        return (x_new, y_new, z_new, Ax_new, it + K, r_prim, r_dual,
                best_rp_new, best_rd_new, stall_new, done)

    dt = spec.l_tmpl.dtype
    inf = jnp.asarray(jnp.inf, dt)
    # Structurally infeasible lanes (a crossed bound row, e.g. a pinned
    # load outside the variable's box, or a potential cap below a positive
    # gen p_min) can never satisfy the primal test: skip their loop
    # entirely (done at entry) and report converged=False so callers can
    # apply their idle fallback — the host tier's res.success branch
    # (agents/mpc.py).  Under vmap this also keeps one bad lane from
    # dragging the batch through max_iter.
    bounds_ok = jnp.all(l <= u)
    carry0 = (x, y, z, Ax, jnp.int32(0), inf, inf, inf, inf, jnp.int32(0),
              jnp.logical_not(bounds_ok))
    x, y, z, Ax, it, r_prim, r_dual, _, _, _, done = jax.lax.while_loop(cond, body, carry0)
    # Usable-dispatch gate: primal within feas_band_factor × its strict
    # tolerance (p_ref recomputed from the exit iterate).
    p_ref_exit = jnp.maximum(
        jnp.max(jnp.abs(spec.E_inv * Ax)), jnp.max(jnp.abs(spec.E_inv * z))
    )
    feasible = jnp.logical_and(
        bounds_ok,
        r_prim <= spec.feas_band_factor * (spec.eps_abs + spec.eps_rel * p_ref_exit),
    )
    return DCOPFSolution(
        x=spec.D * x,
        warm=(x, y, z, Ax),
        iterations=it,
        r_prim=r_prim,
        r_dual=r_dual,
        converged=jnp.logical_and(done, bounds_ok),
        bounds_ok=bounds_ok,
        feasible=feasible,
    )


# ----------------------------------------------------------------------
# VecEnv controller wrapper
# ----------------------------------------------------------------------

def make_vec_mpc(
    env,
    gamma: float,
    safety_margin: float = 0.9,
    planning_steps: int = 1,
    rho: float = 1.0,
    rho_eq_factor: float = 1e2,
    max_iter: int = 48,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    dual_stall_limit: int = 100,
    check_every: int = 8,
    forecast_fn=None,
    receding_warm: Optional[bool] = None,
    name: Optional[str] = None,
):
    """An on-device π_MPC-N^constant for a :class:`~gym_anm_tpu.vec.VecEnv`.

    Returns a ``Controller(name, init_carry, act)`` (the vec controller
    protocol): ``act(key, state, obs, carry)`` solves the N-stage DC-OPF
    for the lane's current loads/potentials/SoC — the constant-forecast
    policy of the reference ``MPCAgentConstant`` (mpc_constant.py:7-35) —
    entirely inside the compiled step.  The carry holds the lane's scaled
    ADMM state, so successive env steps warm-start from the previous
    (near-identical) program's solution.

    **Real-time iteration**: the controller default is a BOUNDED per-step
    budget (``max_iter=48``), not solve-to-convergence.  Because the
    ADMM state carries across env steps, an un-polished iterate keeps
    converging over the next steps while the plant acts on the current
    one.  Measured full-day closed-loop reward (B=256 × 96 steps,
    ANM6Easy N=1 constant) is FLAT from budget 16 up —
    −0.594/−0.594/−0.600/−0.593/−0.601/−0.598 at max_iter
    16/24/32/48/96/200 — with a quality CLIFF at 8 (−0.648); budget 48
    sits 6× above the cliff at a quarter of the old 200 default's
    per-step iteration cap.  On
    IEEE33-renewable N=1 the budget is quality-neutral (−0.00873 at both
    48 and 200), and at N=8 perfect small budgets are strictly BETTER
    (−0.270 at 48 vs −0.342 at 200 — unbounded per-step polish chases
    degenerate vertices).  The batched farm pays the worst lane each
    step, so the budget also caps step time.  Pass a large ``max_iter``
    for solve-to-convergence behavior; one-shot LP solves via
    :func:`solve_dcopf`/:func:`make_vec_dcopf` keep their own 4000
    default.  ``scripts/exp_rti_budget.py`` reproduces the curve;
    tests/test_vec_mpc.py pins budget-48 quality against a
    high-budget rollout.

    ``forecast_fn(state) -> (P_load, P_pot)`` (p.u.; ``[n_load(, N)]`` /
    ``[n_gen_ns(, N)]``) overrides the constant forecast — the hook
    :func:`make_vec_mpc_perfect` uses for known future profiles.
    """
    from ..agents.mpc import MPCAgent
    from ..env.simulator import Simulator
    from .controllers import Controller

    sim = Simulator(env.task.network, env.task.delta_t, env.task.lamb)
    # The base agent is used only for its problem assembly (structure,
    # ID maps) — forecast/act stay untouched.
    agent = MPCAgent(sim, action_space=None, gamma=gamma,
                     safety_margin=safety_margin, planning_steps=planning_steps)
    spec = env.spec

    # The EnvState arrays are position-ordered; pin the agent's id-ordered
    # views to the same layout before wiring them together.
    dm = agent.dev_id_mapping
    assert np.array_equal([dm[i] for i in agent.load_ids], spec.load_pos)
    assert np.array_equal([dm[i] for i in agent.non_slack_gen_ids], spec.gen_nonslack_pos)
    assert np.array_equal([dm[i] for i in agent.des_ids], spec.des_pos)

    dc = make_vec_dcopf(
        agent.structure, dtype=env.dtype, rho=rho, rho_eq_factor=rho_eq_factor,
        max_iter=max_iter, eps_abs=eps_abs, eps_rel=eps_rel,
        dual_stall_limit=dual_stall_limit, check_every=check_every,
    )
    n_g = len(agent.non_slack_gen_ids)
    load_pos = np.asarray(spec.load_pos)
    sl = env._action_slices
    # Receding-horizon warm start: shift the previous plan one stage so
    # stages stay aligned with the times they target.  Defaults on for
    # N > 1 (measured iteration win on the perfect-forecast rollouts);
    # identity at N = 1.
    if receding_warm is None:
        receding_warm = planning_steps > 1
    shift = (make_shift_warm(dc, agent.structure, planning_steps)
             if receding_warm else (lambda w: w))

    def init_carry(key):
        return init_warm(dc)

    def act(key, state, obs, carry):
        if forecast_fn is None:
            P_load, P_pot = state.dev_p[load_pos], state.p_pot
        else:
            P_load, P_pot = forecast_fn(state)
        l, u = lane_bounds(dc, P_load, P_pot, state.soc)
        sol = solve_dcopf(dc, l, u, warm=shift(carry))
        # Idle fallback ONLY on structurally unsolvable lanes (crossed
        # bound rows — exactly what makes the host tier's HiGHS call fail
        # into its zero-action branch, agents/mpc.py).  NOT gated on
        # convergence or the residual band: a near-feasible near-optimal
        # iterate beats a zero dispatch (measured: band-gating idled
        # borderline N=8 lanes and cost 0.5 reward/step on 30-step
        # windows), and the env projects actions onto the device polytopes
        # regardless.
        P = jnp.where(sol.bounds_ok, sol.x[dc.act_idx], 0.0) * dc.baseMVA
        a = jnp.zeros(env.n_action, dtype=env.dtype)
        a = a.at[sl["P_gen"]].set(P[:n_g].astype(env.dtype))
        a = a.at[sl["P_des"]].set(P[n_g:].astype(env.dtype))
        a = a.at[sl["tap"]].set(1.0)
        a = jnp.clip(a, env.action_low, env.action_high)
        return a, sol.warm

    return Controller(name or f"MPC{planning_steps}_constant", init_carry, act)


def profile_forecast_fn(env, planning_steps: int, tables_mw: Optional[tuple] = None):
    """``forecast_fn(state)`` gathering the next N stages of a task's
    periodic profile tables (p.u.), indexed by the ``aux`` time-of-day.

    Stage offsets start at +1: the agent plans for the vars the env will
    draw NEXT (reference ``mpc_perfect.py``: ``t_start = state[-1] + 1``,
    wrapping by table concatenation ≡ mod T here).
    """
    if tables_mw is None:
        if env.task.name != "anm6easy":
            raise ValueError(
                "profile_forecast_fn needs explicit tables_mw for task "
                f"{env.task.name!r} (only anm6easy has built-in profiles)"
            )
        from ..networks.anm6 import _get_gen_time_series, _get_load_time_series

        tables_mw = (_get_load_time_series(), _get_gen_time_series())

    base = float(env.spec.baseMVA)
    loads_mw, maxs_mw = (np.asarray(t) for t in tables_mw)
    if loads_mw.shape[1] != maxs_mw.shape[1]:
        # jit gathers clamp out-of-range indices SILENTLY — a period
        # mismatch would otherwise plan against a frozen wrong profile.
        raise ValueError(
            "tables_mw periods differ: P_loads has "
            f"{loads_mw.shape[1]} columns, P_maxs {maxs_mw.shape[1]}"
        )
    loads_pu = jnp.asarray(loads_mw / base, dtype=env.dtype)
    maxs_pu = jnp.asarray(maxs_mw / base, dtype=env.dtype)
    T = loads_pu.shape[1]
    offs = jnp.arange(1, planning_steps + 1, dtype=jnp.int32)

    def forecast_fn(state):
        idx = jnp.mod(state.aux[-1].astype(jnp.int32) + offs, T)
        return loads_pu[:, idx], maxs_pu[:, idx]

    return forecast_fn


def make_vec_mpc_perfect(
    env,
    gamma: float,
    safety_margin: float = 0.9,
    planning_steps: int = 8,
    tables_mw: Optional[tuple] = None,
    **kw,
):
    """π_MPC-N^perfect for a :class:`~gym_anm_tpu.vec.VecEnv` over a task
    with KNOWN periodic profiles — the vec analogue of
    :class:`~gym_anm_tpu.agents.mpc.MPCAgentPerfect`
    (reference ``mpc_perfect.py:7-40``, which is likewise ANM6-specific:
    it reads ``env.P_loads``/``env.P_maxs``).

    The forecast for stage k is the profile column ``(aux + k) mod T`` —
    a static-shape gather from trace-time constant tables, so the act
    program stays one compiled solve.  ``tables_mw = (P_loads [n_load, T],
    P_maxs [n_gen_ns, T])`` in MW (loads negative); defaults to the
    ANM6Easy daily profiles when the env runs the ``anm6easy`` task.
    """
    forecast_fn = profile_forecast_fn(env, planning_steps, tables_mw)
    return make_vec_mpc(
        env, gamma, safety_margin=safety_margin, planning_steps=planning_steps,
        forecast_fn=forecast_fn, name=f"MPC{planning_steps}_perfect", **kw,
    )
