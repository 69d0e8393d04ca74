"""NaN / divergence debugging tools (SURVEY §5 "race detection" analogue).

The reference's CUDA debugging story is compute-sanitizer-style tooling;
the XLA equivalent failure mode is a NaN/Inf produced inside one
fused kernel and only OBSERVED many fusions downstream (or swallowed
entirely — ``diff > xtol`` is False for NaN, which is why the solvers
sanitize their exits, power_flow.py).  Three tools:

* :func:`debug_nans` — a context manager around ``jax_debug_nans``: inside
  it, the FIRST op producing a non-finite value raises with that op's
  location, instead of the corruption surfacing downstream.  Debug-only
  (it disables donation/async and re-runs kernels; never leave it on in
  a benchmark).
* :func:`validate_state` — host-side invariant audit of an
  :class:`~gym_anm_tpu.vec.core.EnvState` (single lane or batch): every
  float field finite on live lanes, SoC inside its box, voltages in a
  plausible band, timestep/terminated dtypes.  Returns a dict report;
  raises only if ``strict=True``.
* :func:`explain_divergence` — classify a step's per-lane outcomes from
  its ``info`` dict: healthy / genuinely-collapsed (done, huge residual
  — valid physics on aggressive actions, see CLAUDE.md) / NON-converged
  live lanes (the bug class: live lane with residual above tolerance).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import jax
import numpy as np

__all__ = ["debug_nans", "validate_state", "explain_divergence"]


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise at the first op that produces a NaN/Inf inside the block.

    Wraps ``jax.config.jax_debug_nans`` with save/restore so test code
    can nest it.  Compiled functions are re-run op-by-op on failure, so
    the error points at the producing op — the XLA analogue of running
    under a sanitizer.
    """
    prev = jax.config.jax_debug_nans
    try:
        jax.config.update("jax_debug_nans", bool(enable))
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def _as_batch(x):
    a = np.asarray(x)
    return a[None] if a.ndim == 0 else a


def validate_state(state, spec=None, *, v_band=(0.2, 2.0), strict: bool = False):
    """Audit an EnvState (vec tier) for physical-invariant violations.

    Parameters
    ----------
    state : EnvState — single lane or vmapped batch (leading batch dim).
    spec : optional NetworkSpec — enables the SoC-box check
        (``spec.soc_max``/``soc_min`` indexed at ``spec.des_pos``).
    v_band : plausibility band for live-lane voltage magnitudes (p.u.);
        the default is far outside any operating band but catches the
        solver-divergence signature (|V| → 0 or explosion).
    strict : raise ``AssertionError`` on any violation.

    Returns a dict ``{check_name: bad_lane_index_array}`` containing ONLY
    failing checks (empty dict == clean).  Terminated lanes are exempt
    from value checks (collapse legitimately leaves extreme values).
    """
    report = {}
    term = _as_batch(state.terminated).astype(bool)
    if term.ndim > 1:  # single lane passed: fields unbatched
        term = term.reshape(-1)
    live = ~term

    def check(name, bad_mask):
        bad_mask = np.asarray(bad_mask)
        if bad_mask.ndim > 1:
            bad_mask = bad_mask.reshape(bad_mask.shape[0], -1).any(axis=1)
        bad = np.nonzero(bad_mask & live)[0]
        if bad.size:
            report[name] = bad

    for field in ("soc", "dev_p", "dev_q", "p_pot", "bus_vm", "v_guess",
                  "oltc_tap"):
        arr = _as_batch(getattr(state, field))
        if arr.ndim == 1:
            arr = arr[None] if live.shape[0] == 1 else arr[:, None]
        check(f"{field}_nonfinite", ~np.isfinite(arr))

    vm = _as_batch(state.bus_vm)
    if vm.ndim == 1:
        vm = vm[None]
    check("bus_vm_outside_band", (vm < v_band[0]) | (vm > v_band[1]))

    if spec is not None:
        soc = _as_batch(state.soc)
        if soc.ndim == 1:
            soc = soc[None]
        soc_max = np.asarray(spec.soc_max)[np.asarray(spec.des_pos)]
        soc_min = getattr(spec, "soc_min", None)
        soc_min = (np.asarray(soc_min)[np.asarray(spec.des_pos)]
                   if soc_min is not None else np.zeros_like(soc_max))
        tol = 1e-4
        check("soc_outside_box",
              (soc < soc_min - tol) | (soc > soc_max + tol))

    t = np.asarray(state.t)
    if not np.issubdtype(t.dtype, np.integer):
        report["t_not_integer"] = np.arange(term.shape[0])

    if strict and report:
        raise AssertionError(f"EnvState invariant violations: "
                             f"{ {k: v[:8] for k, v in report.items()} }")
    return report


def explain_divergence(info, done, xtol: float = 1e-4,
                       state: Optional[object] = None):
    """Classify a step's lanes from its ``info``/``done`` outputs.

    Returns a dict with index arrays:

    * ``collapsed`` — done lanes with residual above ``xtol``: the load
      flow genuinely diverged (valid physics under aggressive actions —
      ANM6Easy terminates ~17% of lanes under extreme random actions in
      f64 too; CLAUDE.md);
    * ``terminated_converged`` — done lanes whose solve converged (e.g.
      V-bound termination);
    * ``unhealthy`` — LIVE lanes with residual above ``xtol``: the bug
      class (a probe must never see these — chip_smoke.py);
    * plus scalars ``n_iter_max`` and ``worst_live_diff``.
    """
    done = np.asarray(done).astype(bool).reshape(-1)
    diff = np.asarray(info["diff"]).reshape(-1)
    out = {
        "collapsed": np.nonzero(done & (diff > xtol))[0],
        "terminated_converged": np.nonzero(done & (diff <= xtol))[0],
        "unhealthy": np.nonzero(~done & (diff > xtol))[0],
        "n_iter_max": int(np.max(np.asarray(info["n_iter"]))),
        "worst_live_diff": float(diff[~done].max()) if (~done).any() else 0.0,
    }
    if state is not None:
        out["state_report"] = validate_state(state)
    return out
