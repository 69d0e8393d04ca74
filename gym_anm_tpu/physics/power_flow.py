"""Batched Newton–Raphson AC load-flow solver.

Accelerator-resident replacement for ``gym_anm/simulator/solve_load_flow.py:7-226``.
The algorithm is the same iterate-for-iterate (this is what makes single-env
trajectories match the reference):

* polar unknowns x = [θ₁..θ_{N-1}, |V|₁..|V|_{N-1}], flat start θ=0, |V|=1,
  slack anchored at V₀ = 1+0j (solve_load_flow.py:42,111-112,167-173);
* mismatch f(x) = (V ∘ (YV)*)[1:] − (p + jq), split into re/im;
* analytic Jacobian from the dS/dθ and dS/d|V| diagonal-matrix identities
  (solve_load_flow.py:146-162);
* undamped updates x ← x − J⁻¹F until ‖F‖∞ ≤ xtol or 100 iterations;
* converged = ¬isnan(diff); stable = converged ∧ diff ≤ xtol.

Differences from the reference are purely representational: dense
split-complex arithmetic instead of scipy sparse (at ≤33 buses the dense
real matmuls batch across lanes), a `lax.while_loop` instead of a Python
loop (so the whole solve jits/vmaps), and a batched dense solve in place of
SuperLU's `spsolve`.  Under `vmap`, JAX's while-loop batching
applies per-lane masked updates, so each environment lane stops exactly when
the reference would.
"""

import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .complexops import cmatvec

# Anderson depth of the chord accelerator (a trace-time constant; programs
# must be re-jitted after changing it).  1 is the shipped default; 2 adds a
# second history pair — measured by scripts/exp_aa_order.py before any
# default change (see docs/performance.md: acceleration tweaks sit right on
# the acceptance cliff).
_AA_ORDER = int(os.environ.get("GYM_ANM_AA_ORDER", "1"))


class NRResult(NamedTuple):
    v_re: jax.Array      # [N] full complex bus voltage (slack included)
    v_im: jax.Array
    n_iter: jax.Array    # scalar int
    diff: jax.Array      # final ‖F‖∞
    converged: jax.Array  # bool: no NaN encountered
    stable: jax.Array    # bool: converged and diff <= xtol
    # Final mismatch [2(N−1)] = [Re(S)−p; Im(S)−q] at the returned iterate:
    # lets callers recover exact bus powers S (and currents I = conj(S/V))
    # WITHOUT re-evaluating Y·V — the f32 transition epilogue uses this to
    # skip four HIGHEST-precision matvecs per step.
    F: jax.Array = None


def _assemble_v(theta, vm, dtype):
    """V = [1+0j, |V|·e^{jθ}]."""
    one = jnp.ones((1,), dtype=dtype)
    zero = jnp.zeros((1,), dtype=dtype)
    v_re = jnp.concatenate([one, vm * jnp.cos(theta)])
    v_im = jnp.concatenate([zero, vm * jnp.sin(theta)])
    return v_re, v_im


def _mismatch(x, p, q, Yre, Yim, n):
    """F(x) = [Re(S−s); Im(S−s)] with S = V ∘ conj(YV), rows 1..N−1.

    The matvec runs at HIGHEST precision: F is the convergence criterion,
    and a reduced-precision default (TF32 or bf16 inputs) would floor ‖F‖∞
    far above the 1e-5 tolerance.
    """
    theta, vm = x[:n], x[n:]
    v_re, v_im = _assemble_v(theta, vm, x.dtype)
    yv_re, yv_im = cmatvec(Yre, Yim, v_re, v_im, precision=jax.lax.Precision.HIGHEST)
    # V * conj(YV)
    s_re = v_re * yv_re + v_im * yv_im
    s_im = v_im * yv_re - v_re * yv_im
    F = jnp.concatenate([s_re[1:] - p, s_im[1:] - q])
    return F, (v_re, v_im, yv_re, yv_im)


def _jacobian(v_re, v_im, yv_re, yv_im, Yre, Yim, n):
    """Analytic Jacobian of the mismatch w.r.t. [θ, |V|] (rows/cols 1..N−1).

    dS/dθ  = j·diag(V)·conj(diag(YV) − Y·diag(V))
    dS/d|V| = diag(V/|V|)·conj(diag(YV)) + diag(V)·conj(Y·diag(V/|V|))
    """
    N = v_re.shape[0]
    eye = jnp.eye(N, dtype=v_re.dtype)

    # M = diag(YV) − Y·diag(V)
    M_re = yv_re * eye - Yre * v_re[None, :] + Yim * v_im[None, :]
    M_im = yv_im * eye - Yre * v_im[None, :] - Yim * v_re[None, :]
    # A = diag(V)·conj(M)  →  row k scaled by V_k, M conjugated
    A_re = v_re[:, None] * M_re + v_im[:, None] * M_im
    A_im = v_im[:, None] * M_re - v_re[:, None] * M_im
    # dS/dθ = j·A
    dSdA_re, dSdA_im = -A_im, A_re

    vabs = jnp.sqrt(v_re * v_re + v_im * v_im)
    vn_re, vn_im = v_re / vabs, v_im / vabs
    # B = Y·diag(Vnorm); C = diag(V)·conj(B)
    B_re = Yre * vn_re[None, :] - Yim * vn_im[None, :]
    B_im = Yre * vn_im[None, :] + Yim * vn_re[None, :]
    C_re = v_re[:, None] * B_re + v_im[:, None] * B_im
    C_im = v_im[:, None] * B_re - v_re[:, None] * B_im
    # + diag(Vnorm · conj(YV))
    d_re = vn_re * yv_re + vn_im * yv_im
    d_im = vn_im * yv_re - vn_re * yv_im
    dSdM_re = C_re + d_re * eye
    dSdM_im = C_im + d_im * eye

    J = jnp.block(
        [
            [dSdA_re[1:, 1:], dSdM_re[1:, 1:]],
            [dSdA_im[1:, 1:], dSdM_im[1:, 1:]],
        ]
    )
    return J


def numpy_nr_solve(Y, p, q, xtol=1e-10, lim_iter=50):
    """Host-side float64 Newton-Raphson (pure numpy; no JAX involvement,
    so it never touches the accelerator at table-build time).  Returns the
    polar state x* = [θ₁.., |V|₁..] of the solved operating point, or the flat
    start if the solve does not converge.  Used to pick a chord
    linearization point for tasks whose typical loading is far from the
    flat start."""
    Y = np.asarray(Y, complex)
    N = Y.shape[0]
    n = N - 1
    s = np.asarray(p, float) + 1j * np.asarray(q, float)
    x = np.concatenate([np.zeros(n), np.ones(n)])
    for _ in range(lim_iter):
        V = np.concatenate([[1.0 + 0.0j], x[n:] * np.exp(1j * x[:n])])
        YV = Y @ V
        F_c = (V * np.conj(YV))[1:] - s
        F = np.concatenate([F_c.real, F_c.imag])
        if np.max(np.abs(F)) <= xtol:
            return x
        dSdA = 1j * np.diag(V) @ np.conj(np.diag(YV) - Y @ np.diag(V))
        Vn = V / np.abs(V)
        dSdM = np.diag(Vn) @ np.conj(np.diag(YV)) + np.diag(V) @ np.conj(Y @ np.diag(Vn))
        J = np.block([[dSdA[1:, 1:].real, dSdM[1:, 1:].real],
                      [dSdA[1:, 1:].imag, dSdM[1:, 1:].imag]])
        try:
            x = x - np.linalg.solve(J, F)
        except np.linalg.LinAlgError:
            break
        if not np.all(np.isfinite(x)):
            break
    V = np.concatenate([[1.0 + 0.0j], x[n:] * np.exp(1j * x[:n])]) if np.all(np.isfinite(x)) else None
    if V is not None:
        YV = Y @ V
        F_c = (V * np.conj(YV))[1:] - s
        if np.max(np.abs(np.concatenate([F_c.real, F_c.imag]))) <= 1e-6:
            return x
    return np.concatenate([np.zeros(n), np.ones(n)])


def _numpy_jacobian_inv(Y, x):
    """inv(J(x)) at an arbitrary polar state, float64 numpy."""
    Y = np.asarray(Y, complex)
    N = Y.shape[0]
    n = N - 1
    V = np.concatenate([[1.0 + 0.0j], x[n:] * np.exp(1j * x[:n])])
    YV = Y @ V
    dSdA = 1j * np.diag(V) @ np.conj(np.diag(YV) - Y @ np.diag(V))
    Vn = V / np.abs(V)
    dSdM = np.diag(Vn) @ np.conj(np.diag(YV)) + np.diag(V) @ np.conj(Y @ np.diag(Vn))
    J = np.block([[dSdA[1:, 1:].real, dSdM[1:, 1:].real],
                  [dSdA[1:, 1:].imag, dSdM[1:, 1:].imag]])
    return np.linalg.inv(J)


def flat_start_inv_jacobian(Yre, Yim):
    """Precompute inv(J(x0)) at the flat start x0 = (θ=0, |V|=1) for a fixed
    admittance matrix — the constant matrix of the chord-Newton fast path.

    Host-side, float64; call once per network at table-build time (nominal
    taps).  The returned [2(N−1), 2(N−1)] inverse is shared by every lane of
    an environment batch, so under ``vmap`` each chord iteration is a single
    large ``[B, 2n] @ [2n, 2n]`` matmul instead of a per-lane Jacobian
    factorization.
    """
    Yre = jnp.asarray(Yre, jnp.float64)
    Yim = jnp.asarray(Yim, jnp.float64)
    N = Yre.shape[-1]
    n = N - 1
    x0 = jnp.concatenate([jnp.zeros(n, jnp.float64), jnp.ones(n, jnp.float64)])
    _, (v_re, v_im, yv_re, yv_im) = _mismatch(
        x0, jnp.zeros(n, jnp.float64), jnp.zeros(n, jnp.float64), Yre, Yim, n
    )
    J0 = _jacobian(v_re, v_im, yv_re, yv_im, Yre, Yim, n)
    return np.linalg.inv(np.asarray(J0))


class ChordConst(NamedTuple):
    """Trace-time constants of the chord-Newton fast path (all shared across
    the environment batch; see :func:`make_chord_const`)."""

    Y0re: np.ndarray    # [N, N] nominal-tap admittance matrix
    Y0im: np.ndarray
    invJ0: np.ndarray   # [2n, 2n] inverse Jacobian at the linearization
    #                     point (flat start by default) and nominal tap
    G: np.ndarray       # [2n, 2] = invJ0 · U  (U = [e_{P_t}, e_{Q_t}])
    H: np.ndarray       # [2, 2n] = Eᵀ · invJ0 (E = [e_{θ_t}, e_{|V|_t}])
    C: np.ndarray       # [2, 2]  = Eᵀ · invJ0 · U
    t_bus: int          # regulated branch's to-bus (from-bus is the slack)
    # V at the regulated bus AT THE LINEARIZATION POINT — enters the tap
    # Woodbury's W(a) (1+0j for the flat start, reproducing the original
    # formula exactly).
    vstar_re: float = 1.0
    vstar_im: float = 0.0


def make_chord_const(Y0re, Y0im, t_bus, dtype=np.float32, x_star=None) -> ChordConst:
    """Build the shared constants of the tap-aware chord-Newton solver.

    The chord iteration is x ← x − J(x0, a)⁻¹ F(x), where J(x0, a) is the
    flat-start Jacobian at the lane's actual OLTC tap magnitude ``a``.  A
    tap change on a branch whose from-bus is the slack perturbs the Y-bus in
    exactly three entries — Y[f,f], Y[f,t], Y[t,f] (ybus.py:34-36) — and
    because slack rows/columns are excluded from the mismatch, the
    flat-start Jacobian (affine in Y at V ≡ 1) changes by a RANK-2 term
    confined to rows (P_t, Q_t) and columns (θ_t, |V|_t):

        J(x0, a) = J0 + U · W(a) · Eᵀ,
        W(a) = [[Im δ, Re δ], [Re δ, −Im δ]],
        δ = ΔY[t,f] = −y·e^{−jθ_shift}·(1/a − 1/a₀).

    The Sherman–Morrison–Woodbury identity then gives the per-lane inverse
    using only the SHARED invJ0 plus 2-dimensional per-lane corrections:

        J(x0,a)⁻¹ F = invJ0·F − G · [W(I + C·W)⁻¹] · (H·F)

    so under ``vmap`` every chord iteration is one [B,2n]@[2n,2n]
    matmul, one [B,2n]@[2n,2]+[B,2]@[2,2n] correction, and one shared-Y0
    mismatch matmul — no per-lane [2n,2n] matrices touch HBM at all.  The
    identity is exact (no tap grid, no quantization), and valid at a = a₀
    where W = 0.
    """
    n = Y0re.shape[-1] - 1
    if x_star is None:
        invJ0 = flat_start_inv_jacobian(Y0re, Y0im)
        vstar_re, vstar_im = 1.0, 0.0
    else:
        # Linearize at an arbitrary solved state x* (pure-numpy, host).
        # The tap perturbation's rank-2 structure survives: ΔS depends
        # only on V_t (times the PINNED slack voltage), so ΔJ stays
        # confined to rows (P_t, Q_t) × columns (θ_t, |V_t|); only W(a)'s
        # entries pick up V*_t (see chord_solve).
        x_star = np.asarray(x_star, float)
        Yc = np.asarray(Y0re, float) + 1j * np.asarray(Y0im, float)
        invJ0 = _numpy_jacobian_inv(Yc, x_star)
        it_t = int(t_bus) - 1
        vm_t = x_star[n + it_t]
        th_t = x_star[it_t]
        vstar_re = float(vm_t * np.cos(th_t))
        vstar_im = float(vm_t * np.sin(th_t))
    it = int(t_bus) - 1
    rows = [it, n + it]
    return ChordConst(
        Y0re=np.asarray(Y0re, dtype),
        Y0im=np.asarray(Y0im, dtype),
        invJ0=invJ0.astype(dtype),
        G=invJ0[:, rows].astype(dtype),
        H=invJ0[rows, :].astype(dtype),
        C=invJ0[np.ix_(rows, rows)].astype(dtype),
        t_bus=int(t_bus),
        vstar_re=vstar_re,
        vstar_im=vstar_im,
    )


def _chord_lane_core(const: ChordConst, dtype, xtol, lim_iter, stall_tol_factor):
    """Per-lane building blocks of the chord-Newton iteration
    (:func:`chord_solve`).  Returns ``(init, cond, body, epilogue)``:

    * ``init(p, q, w_a, w_b, dtf_re, dtf_im, x0) -> (data, carry)`` — fold
      the Woodbury W(a) into the scalar K coefficients and evaluate the
      starting residual; ``data`` is the loop-invariant per-lane problem
      (p, q, δ, K) and ``carry`` the iteration state;
    * ``cond(carry) -> bool`` — the lane's while-loop condition (the
      region-dependent stall budget included);
    * ``body(data, carry) -> carry`` — one chord+Anderson iteration;
    * ``epilogue(data, carry) -> (x, F, diff, n_iter, accepted)`` — the
      acceptance / flat-start-reset exit logic.

    The per-lane MATH is identical regardless of which driver runs the
    loop: JAX's vmapped while_loop applies exactly body-then-select with
    the per-lane cond, which is what the batch driver replicates.  Bitwise
    equality across drivers is NOT guaranteed, though — XLA blocks a
    [C, 2n]@[2n, 2n] dot differently from [B, 2n]@[2n, 2n], and that
    low-bit f32 drift can shift a plateau exit by an iteration.  The
    solver CONTRACT (stop on the true mismatch residual; acceptance at
    xtol / plateau ≤ 10·xtol) is driver-independent — pinned in
    tests/test_chord_solver.py.
    """
    Y0re = jnp.asarray(const.Y0re, dtype)
    Y0im = jnp.asarray(const.Y0im, dtype)
    invJ0 = jnp.asarray(const.invJ0, dtype)
    G = jnp.asarray(const.G, dtype)
    H = jnp.asarray(const.H, dtype)
    C = jnp.asarray(const.C, dtype)
    n = Y0re.shape[-1] - 1
    # Polynomial sin/cos for the f32 iteration: a fused Taylor form in
    # place of XLA's native trig, whose cost on the GPU is not yet
    # measured against it (ROADMAP, Speed queue).  For |θ| ≤ 0.5 rad the
    # truncation error (sin ≤ 5e-9, cos ≤ 1e-7) sits at the f32 rounding
    # floor, so iterates, the residual, and the acceptance behavior are
    # unchanged to solver noise.  Validity is ENFORCED, not assumed: the
    # epilogue flat-resets any lane whose final |θ| exceeds the radius
    # (below), handing it to the exact-NR fallback whose native trig owns
    # the out-of-range regime.  Distribution-feeder angles are ≪ 0.1 rad,
    # so the bench distribution never triggers the guard (acceptance
    # stays total — the cliff tests).  f64 instantiations keep native
    # trig: that tier's contract is exactness, not speed.
    fast_trig = np.dtype(dtype) == np.float32
    trig_radius = 0.5
    # Packed mismatch matvec: the four real [B, N]@[N, N] HIGHEST products
    # of the complex Y·V become two [B, N]@[N, 2N] matmuls against the
    # constant [Y0ᵀ | Y0imᵀ] block, so the LHS streams once per product
    # pair.  Results are BIT-IDENTICAL to the four-product form (each
    # output element keeps its own dot's summation order; packing the
    # BATCH operand instead would change summation order — a different
    # scheme).
    W_pack = jnp.concatenate([Y0re.T, Y0im.T], axis=1)

    def sincos(t):
        if not fast_trig:
            return jnp.sin(t), jnp.cos(t)
        t2 = t * t
        s = t * (1.0 + t2 * (-1.0 / 6.0 + t2 * (1.0 / 120.0 - t2 * (1.0 / 5040.0))))
        c = 1.0 + t2 * (-0.5 + t2 * (1.0 / 24.0 - t2 * (1.0 / 720.0)))
        return s, c
    t = const.t_bus
    # One-hot row for the ΔY tap correction: a fused multiply-add in the
    # mismatch instead of a dynamic-update-slice per iteration (scatters
    # break XLA's elementwise fusion chains; launch count is the floor).
    e_t = jnp.zeros(n + 1, dtype).at[t].set(1.0)
    g_col0, g_col1 = G[:, 0], G[:, 1]
    c00, c01, c10, c11 = C[0, 0], C[0, 1], C[1, 0], C[1, 1]
    va, vb = const.vstar_re, const.vstar_im
    vmag = float(np.hypot(va, vb))
    flat = jnp.concatenate([jnp.zeros(n, dtype=dtype), jnp.ones(n, dtype=dtype)])
    stall_limit = 3

    def mismatch(x, p, q, dtf_re, dtf_im):
        theta, vm = x[:n], x[n:]
        sn, cs = sincos(theta)
        one = jnp.ones((1,), dtype=dtype)
        zero = jnp.zeros((1,), dtype=dtype)
        v_re = jnp.concatenate([one, vm * cs])
        v_im = jnp.concatenate([zero, vm * sn])
        # HIGHEST precision: this is the convergence criterion (see
        # _mismatch); the chord UPDATE matmuls below stay at the fast
        # default — they only shape the iteration path, not its fixed
        # point.
        A = jnp.matmul(v_re, W_pack, precision=jax.lax.Precision.HIGHEST)
        Bp = jnp.matmul(v_im, W_pack, precision=jax.lax.Precision.HIGHEST)
        yv_re = A[: n + 1] - Bp[n + 1:] + e_t * dtf_re
        yv_im = Bp[: n + 1] + A[n + 1:] + e_t * dtf_im
        s_re = v_re * yv_re + v_im * yv_im
        s_im = v_im * yv_re - v_re * yv_im
        return jnp.concatenate([s_re[1:] - p, s_im[1:] - q])

    def init(p, q, w_a, w_b, dtf_re, dtf_im, x0):
        # K = W (I + C W)⁻¹, 2×2 per lane in closed form.  W(a) at the
        # linearization point V*: ΔS_t = V*_t·conj(δ) (slack pinned at
        # 1+0j), so with δ = d_r + j·d_i = (w_b + j·w_a) and V*_t = va+j·vb:
        #   dP_t/dθ_t = Re(j V* conj δ) = va·d_i − vb·d_r
        #   dP_t/d|V_t| = Re(V̂* conj δ) = (va·d_r + vb·d_i)/|V*|
        #   dQ_t/dθ_t = Im(j V* conj δ) = va·d_r + vb·d_i
        #   dQ_t/d|V_t| = Im(V̂* conj δ) = (vb·d_r − va·d_i)/|V*|
        # At the flat start (V* = 1) this is exactly [[Im δ, Re δ],
        # [Re δ, −Im δ]], the original formula.
        # K is unrolled to SCALAR algebra.  Per-lane [2, 2] tensors would
        # make the [B, 2, 2] K a batched-dot operand of the while body, with
        # layout-conversion copies around it; as [B] scalars the whole
        # correction chain fuses into elementwise f32 work (the fixed point
        # is unchanged — the stopping rule tests the true mismatch).
        d_i, d_r = w_a, w_b
        w00 = va * d_i - vb * d_r
        w01 = (va * d_r + vb * d_i) / vmag
        w10 = va * d_r + vb * d_i
        w11 = (vb * d_r - va * d_i) / vmag
        m00 = 1.0 + c00 * w00 + c01 * w10
        m01 = c00 * w01 + c01 * w11
        m10 = c10 * w00 + c11 * w10
        m11 = 1.0 + c10 * w01 + c11 * w11
        det = m00 * m11 - m01 * m10
        k00 = (w00 * m11 - w01 * m10) / det
        k01 = (w01 * m00 - w00 * m01) / det
        k10 = (w10 * m11 - w11 * m10) / det
        k11 = (w11 * m00 - w10 * m01) / det
        if x0 is None:
            x0 = flat
        else:
            x0 = jnp.where(jnp.all(jnp.isfinite(x0)), x0.astype(dtype), flat)
        F0 = mismatch(x0, p, q, dtf_re, dtf_im)
        diff0 = jnp.max(jnp.abs(F0))
        data = (p, q, dtf_re, dtf_im, k00, k01, k10, k11)
        carry = (x0, F0, diff0, diff0, jnp.zeros((), jnp.int32),
                 jnp.zeros((), jnp.int32), x0, jnp.zeros_like(F0))
        if _AA_ORDER == 2:
            carry = carry + (x0, jnp.zeros_like(F0))
        return data, carry

    def cond(carry):
        x, F, diff, best, it, stall = carry[:6]
        active = jnp.logical_and(diff > xtol, it < lim_iter)
        # Lanes already inside the plateau-acceptance band (≤ 10·xtol) exit
        # after ONE non-improving iteration instead of three: they are
        # accepted either way, and they are disproportionately the batch's
        # slowest lanes — under vmap every lane runs until the last one
        # stops, so every saved floor-bouncing iteration is saved for the
        # whole batch.  Measured (CPU A/B, 30 warm-started steps × 2048
        # lanes, random actions): worst-lane iterations 11.4 → 9.1 (base)
        # / 9.4 (multicap) with the worst exit residual unchanged at
        # ~4.4e-5 and the mean-lane count IMPROVED (warm starts don't
        # degrade).  Lanes above the band keep the full stall budget
        # (their exit would be UNaccepted and trigger the NR fallback).
        limit = jnp.where(diff <= stall_tol_factor * xtol, stall_limit - 2, stall_limit)
        return jnp.logical_and(active, stall < limit)

    def body(data, carry):
        p, q, dtf_re, dtf_im, k00, k01, k10, k11 = data
        x, F, diff, best, it, stall, g_prev, f_prev, *hist2 = carry
        # Chord direction f and map value g = x + f.  The rank-2 Woodbury
        # correction G·K·(H·F) runs as scalar algebra: u = H·F is a tiny
        # shared-matrix matvec, K·u two fused multiply-adds, and the G
        # column combination two broadcasts — no [B, 2, 2] tensors (see
        # the K construction above).
        u = H @ F
        t0 = k00 * u[0] + k01 * u[1]
        t1 = k10 * u[0] + k11 * u[1]
        f = -(invJ0 @ F) + (t0 * g_col0 + t1 * g_col1)
        g = x + f
        # Anderson(1) acceleration: extrapolate along the last two
        # chord-map evaluations.  For the linear error model e ← M·e of
        # a chord iteration this is the secant/ORTHOMIN step — it cuts
        # the iteration count ~25-30%, and helps MOST on the slow lanes
        # (contraction rate near 1) that dominate the batched
        # while_loop's wall clock (every lane runs until the worst lane
        # converges).  The stopping rule is untouched: acceleration
        # only shapes the path, the fixed point F(x)=0 and its
        # true-residual test are identical.
        # Elementwise multiply+reduce, NOT jnp.vdot: vdot lowers to a
        # dot_general whose accelerator default may multiply in reduced
        # precision (TF32/bf16), adding noise to γ that only shows up on
        # hardware (the acceptance-cliff regression test runs on CPU).
        # The elementwise form is f32-exact on 2n-vectors.
        # First iteration has no history; clamp extrapolation for
        # safety (runaway γ near a stagnating pair).  CRITICAL: disable
        # the acceleration once the residual is within ~100x of xtol —
        # AA's non-monotone path can otherwise stall a rare lane JUST
        # above the 10·xtol plateau-acceptance bound (measured: ~1 lane
        # in 8192), and a single unaccepted lane drags the whole
        # vmapped batch through the exact-NR fallback body every step.
        # Below the gate, plain chord
        # contracts monotonically (~0.25/iter) into the plateau rule
        # exactly as before.
        use_aa = jnp.logical_and(it > 0, diff > 100.0 * xtol)
        if _AA_ORDER == 1:
            df = f - f_prev
            denom = jnp.sum(df * df)
            gamma = jnp.where(denom > 1e-30, jnp.sum(f * df) / denom, 0.0)
            gamma = jnp.where(use_aa, jnp.clip(gamma, -5.0, 5.0), 0.0)
            x = g - gamma * (g - g_prev)
        else:
            # AA(2): least-squares combine the last TWO history pairs,
            # min‖f − [df1 df2]γ‖², by 2×2 normal equations.  When the
            # pairs are near-collinear (or only one exists: it == 1) the
            # determinant term vanishes and the lane falls back to the
            # AA(1) secant step.  Same elementwise f32-exact sums as AA(1) (no vdot).
            g_prev2, f_prev2 = hist2
            df1 = f - f_prev
            df2 = f_prev - f_prev2
            a11 = jnp.sum(df1 * df1)
            a12 = jnp.sum(df1 * df2)
            a22 = jnp.sum(df2 * df2)
            b1 = jnp.sum(f * df1)
            b2 = jnp.sum(f * df2)
            det = a11 * a22 - a12 * a12
            ok2 = jnp.logical_and(it > 1, det > 1e-10 * a11 * a22)
            safe_det = jnp.where(ok2, det, 1.0)
            g1_aa1 = jnp.where(a11 > 1e-30, b1 / a11, 0.0)
            gamma1 = jnp.where(ok2, (b1 * a22 - b2 * a12) / safe_det, g1_aa1)
            gamma2 = jnp.where(ok2, (a11 * b2 - a12 * b1) / safe_det, 0.0)
            gamma1 = jnp.where(use_aa, jnp.clip(gamma1, -5.0, 5.0), 0.0)
            gamma2 = jnp.where(use_aa, jnp.clip(gamma2, -5.0, 5.0), 0.0)
            x = g - gamma1 * (g - g_prev) - gamma2 * (g_prev - g_prev2)
        F = mismatch(x, p, q, dtf_re, dtf_im)
        new_diff = jnp.max(jnp.abs(F))
        # Chord convergence is linear (typical rate ~0.25/iter here).
        # "Stalled" = 3 consecutive iterations without beating the best
        # residual so far by ≥20% — at the f32 rounding floor the
        # residual bounces around its plateau, so comparing against
        # best-so-far (not the previous iterate) is what terminates
        # reliably.
        improving = new_diff < best * 0.8
        stall = jnp.where(improving, 0, stall + 1)
        best = jnp.minimum(best, new_diff)
        out = (x, F, new_diff, best, it + 1, stall, g, f)
        return out + ((g_prev, f_prev) if _AA_ORDER == 2 else ())

    def epilogue(data, carry):
        p, q, dtf_re, dtf_im = data[:4]
        x, F, diff, _, n_iter, stall = carry[:6]
        # Sanitize the exit for the NR fallback.  Two failure shapes:
        # (a) the iteration overflowed to inf/NaN — `diff > xtol` is then
        #     False for NaN, so without a reset the fallback's loop
        #     condition would never fire and the lane would be marked
        #     unstable even though exact Newton from flat start may converge
        #     (a false network collapse the f64 reference path would not
        #     produce);
        # (b) the iteration wandered to a finite iterate WORSE than the flat
        #     start (violent excursion inside the stall window) — the f32
        #     fallback's own stall rule can then give up from that basin
        #     while flat-start Newton would converge.
        # Reset both to the flat start with a recomputed residual; at V ≡ 1
        # the mismatch is S = conj(Y·1) = conj(row sums), so this costs one
        # reduction, not a matvec — the row sums of Y0 constant-fold at
        # trace time.  Accepted lanes are never reset (their x is the
        # answer).
        finite = jnp.logical_and(jnp.isfinite(diff), jnp.all(jnp.isfinite(x)))
        # Polynomial-trig validity guard: beyond |θ| ≤ trig_radius the
        # fast sincos (and hence F/diff) is untrustworthy, so the lane is
        # treated exactly like a non-finite iterate — never accepted, and
        # flat-reset below so the NR fallback re-solves it with native
        # trig from a state whose residual (the analytic row sums) is
        # exact.  The guard folds into `finite` because the downstream
        # logic is identical.
        if fast_trig:
            finite = jnp.logical_and(
                finite, jnp.max(jnp.abs(x[:n])) <= trig_radius)
        rs_re = jnp.sum(Y0re, axis=-1) + e_t * dtf_re
        rs_im = jnp.sum(Y0im, axis=-1) + e_t * dtf_im
        F_flat = jnp.concatenate([rs_re[1:] - p, -rs_im[1:] - q])
        diff_flat = jnp.max(jnp.abs(F_flat))
        # Accept at xtol, or at the plateau tolerance only when the lane
        # actually plateaued (stall-limit exit).  A lane that hits lim_iter
        # while still improving is NOT accepted — it proceeds to the
        # exact-NR polish, matching nr_solve's f32 rule.
        # Mirror cond's region-dependent stall budget: inside the acceptance
        # band a stall of (stall_limit − 2) is a completed plateau exit.
        eff_limit = jnp.where(diff <= stall_tol_factor * xtol, stall_limit - 2, stall_limit)
        plateaued = jnp.logical_and(finite, stall >= eff_limit)
        accepted = jnp.logical_or(
            jnp.logical_and(finite, diff <= xtol),
            jnp.logical_and(plateaued, diff <= stall_tol_factor * xtol),
        )
        # ~(diff <= diff_flat) is True for NaN diff, covering (a) within
        # (b); the explicit `finite` term also catches non-finite x at
        # finite diff.
        reset = jnp.logical_and(
            jnp.logical_not(accepted),
            jnp.logical_or(jnp.logical_not(finite),
                           jnp.logical_not(diff <= diff_flat)),
        )
        x = jnp.where(reset, flat, x)
        F = jnp.where(reset, F_flat, F)
        diff = jnp.where(reset, diff_flat, diff)
        n_iter = jnp.where(reset, 0, n_iter)
        return x, F, diff, n_iter, accepted

    return init, cond, body, epilogue


def chord_solve(p, q, w_a, w_b, dtf_re, dtf_im, const: ChordConst,
                xtol=1e-5, lim_iter=48, stall_tol_factor=10.0, x0=None):
    """Chord-Newton phase of the load-flow solve (single lane; vmap it).

    Parameters
    ----------
    p, q : [N−1] — non-slack bus injections (as in :func:`nr_solve`).
    w_a, w_b : scalars — W(a) entries Im δ and Re δ (0 when the lane's tap
        is nominal or the network has no OLTC).
    dtf_re, dtf_im : scalars — ΔY[t,f] = δ, the per-lane Y-bus correction;
        the true mismatch is evaluated as V∘conj(Y0·V + ΔY·V) where
        (ΔY·V)_t = δ·V_slack = δ (slack pinned at 1+0j).
    const : :class:`ChordConst` — shared matrices (closed over at trace
        time).
    x0 : optional [2(N−1)] — warm-start iterate (e.g. the previous step's
        solution); lanes whose guess contains non-finite entries fall back
        to the flat start.  The fixed point is guess-independent (stopping
        on the true residual), so this only changes iteration counts.

    Returns ``(x, F, diff, n_iter, accepted)`` — a warm start for
    :func:`nr_solve`; ``accepted`` lanes already satisfy the residual
    criterion (diff ≤ xtol, or within the float32 rounding floor
    ``stall_tol_factor·xtol`` after the residual plateaus) and skip the NR
    loop entirely.
    """
    init, cond, body, epilogue = _chord_lane_core(
        const, p.dtype, xtol, lim_iter, stall_tol_factor)
    data, carry0 = init(p, q, w_a, w_b, dtf_re, dtf_im, x0)
    out = jax.lax.while_loop(cond, lambda c: body(data, c), carry0)
    return epilogue(data, out)


def nr_solve_lazy(ybus_fn, p, q, xtol=1e-5, lim_iter=100, init=None) -> NRResult:
    """Exact-NR fallback whose admittance matrix is built INSIDE the loop
    body by ``ybus_fn() -> (Yre, Yim)``.

    With a chord warm start (``init``) the loop usually never executes, and
    because Y only exists inside the body, XLA materializes no [B, N, N]
    tensors at all on the fast path — the point of this variant.  Per
    executed iteration the Y rebuild adds ~N² work on top of the Jacobian,
    irrelevant for the rare fallback lanes.  Semantics identical to
    :func:`nr_solve`.
    """
    assert init is not None, "nr_solve_lazy is the post-chord fallback; pass init"
    x, F, diff, it0, accepted = init
    dtype = p.dtype
    n = p.shape[-1]

    f32_mode = dtype != jnp.float64
    stall_limit = 3
    stall_tol = 10.0 * xtol

    def cond(carry):
        x, F, diff, it, stall = carry
        active = jnp.logical_and(diff > xtol, it < lim_iter)
        active = jnp.logical_and(active, jnp.logical_not(accepted))
        if f32_mode:
            active = jnp.logical_and(active, stall < stall_limit)
        return active

    def body(carry):
        x, F, diff, it, stall = carry
        Yre, Yim = ybus_fn()
        _, (v_re, v_im, yv_re, yv_im) = _mismatch(x, p, q, Yre, Yim, n)
        J = _jacobian(v_re, v_im, yv_re, yv_im, Yre, Yim, n)
        x = x - jnp.linalg.solve(J, F)
        F, _ = _mismatch(x, p, q, Yre, Yim, n)
        new_diff = jnp.max(jnp.abs(F))
        improving = new_diff < diff * 0.5
        stall = jnp.where(improving, 0, stall + 1)
        return x, F, new_diff, it + 1, stall

    x, F, diff, n_iter, stall = jax.lax.while_loop(
        cond, body, (x, F, diff, it0.astype(jnp.int32), jnp.zeros((), jnp.int32))
    )

    v_re, v_im = _assemble_v(x[:n], x[n:], dtype)
    converged = jnp.logical_not(jnp.isnan(diff))
    ok = jnp.logical_or(diff <= xtol, accepted)
    if f32_mode:
        ok = jnp.logical_or(ok, jnp.logical_and(stall >= stall_limit, diff <= stall_tol))
    stable = jnp.logical_and(converged, ok)
    return NRResult(v_re=v_re, v_im=v_im, n_iter=n_iter, diff=diff,
                    converged=converged, stable=stable, F=F)


@partial(jax.jit, static_argnames=("xtol", "lim_iter"))
def nr_solve(Yre, Yim, p, q, xtol=1e-5, lim_iter=100, init=None) -> NRResult:
    """Solve the power-flow equations for one network.

    Parameters
    ----------
    Yre, Yim : [N, N] — split-complex admittance matrix.
    p, q : [N-1] — net active/reactive injections at buses 1..N−1 (p.u.).
    xtol : float — ‖F‖∞ convergence tolerance (1e-5 in the reference's
        ``Simulator.transition``, simulator.py:591).
    lim_iter : int — iteration cap (solve_load_flow.py:176).
    init : optional warm start ``(x, F, diff, n_iter, accepted)`` from
        :func:`chord_solve` (the float32 throughput tier's fast path).
        ``accepted`` lanes already satisfy the residual criterion and skip
        the NR loop; the rest (diverging physics, chord-slow excursions)
        continue with exact Newton from the chord iterate.  When every lane
        of a vmapped batch is accepted, the NR loop body never executes.
        The fixed point is the same either way (both phases stop on the
        true-mismatch residual), so results agree with plain NR to solver
        tolerance.

    vmap over leading batch axes of (Yre, Yim, p, q) for the env farm.
    """
    dtype = p.dtype
    N = Yre.shape[-1]
    n = N - 1

    x0 = jnp.concatenate([jnp.zeros(n, dtype=dtype), jnp.ones(n, dtype=dtype)])
    F0, _ = _mismatch(x0, p, q, Yre, Yim, n)
    diff0 = jnp.max(jnp.abs(F0))

    # In float32, a rare lane's residual can plateau just above xtol (the
    # f32 rounding floor of the mismatch/solve).  Exit after 3 consecutive
    # near-non-improving iterations and accept the plateau when it is within
    # 10x of xtol — float64 keeps the reference's exact loop semantics
    # (true NR either converges or diverges; it does not plateau there).
    f32_mode = dtype != jnp.float64
    stall_limit = 3
    stall_tol = 10.0 * xtol

    # Warm start from the chord phase (float32 throughput tier).
    if init is not None:
        x, F, diff, it0, accepted = init
        it0 = it0.astype(jnp.int32)
    else:
        x, F, diff = x0, F0, diff0
        it0 = jnp.zeros((), jnp.int32)
        accepted = jnp.zeros((), bool)

    def cond(carry):
        x, F, diff, it, stall = carry
        active = jnp.logical_and(diff > xtol, it < lim_iter)
        active = jnp.logical_and(active, jnp.logical_not(accepted))
        if f32_mode:
            active = jnp.logical_and(active, stall < stall_limit)
        return active

    # The Newton step is a pivoted LU solve (jnp.linalg.solve) in both
    # dtypes: the same factorization family as the reference's sparse LU,
    # and under vmap one batched library call — faster on the GPU than
    # plain-XLA Gauss-Jordan at the fallback's [B, 64, 64] (PERF.md).
    def body(carry):
        x, F, diff, it, stall = carry
        _, (v_re, v_im, yv_re, yv_im) = _mismatch(x, p, q, Yre, Yim, n)
        J = _jacobian(v_re, v_im, yv_re, yv_im, Yre, Yim, n)
        x = x - jnp.linalg.solve(J, F)
        F, _ = _mismatch(x, p, q, Yre, Yim, n)
        new_diff = jnp.max(jnp.abs(F))
        improving = new_diff < diff * 0.5
        stall = jnp.where(improving, 0, stall + 1)
        return x, F, new_diff, it + 1, stall

    x, F, diff, n_iter, stall = jax.lax.while_loop(
        cond, body, (x, F, diff, it0, jnp.zeros((), jnp.int32))
    )

    v_re, v_im = _assemble_v(x[:n], x[n:], dtype)
    converged = jnp.logical_not(jnp.isnan(diff))
    ok = jnp.logical_or(diff <= xtol, accepted)
    if f32_mode:
        ok = jnp.logical_or(ok, jnp.logical_and(stall >= stall_limit, diff <= stall_tol))
    stable = jnp.logical_and(converged, ok)
    return NRResult(v_re=v_re, v_im=v_im, n_iter=n_iter, diff=diff,
                    converged=converged, stable=stable, F=F)
