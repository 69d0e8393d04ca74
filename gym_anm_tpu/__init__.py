"""gym-anm-tpu: an accelerator-native framework for RL on Active Network Management tasks.

A ground-up JAX/XLA re-design with the capabilities of ``gym-anm``
(halduaij fork): AC power-flow simulation of electricity distribution
networks, Gymnasium environments (ANM6-Easy, the IEEE-33 voltage-control
family), an L0-L5 controller hierarchy, heuristic expert policies, MPC
DC-OPF agents and offline-RL dataset utilities — with the physics expressed
as pure, batched, jit/vmap/shard_map-compatible kernels so thousands of
grid instances step in lockstep on one accelerator.

Two API tiers:

* :mod:`gym_anm_tpu.compat` — drop-in Gymnasium environments matching the
  reference's single-env API and numerics (float64).
* :mod:`gym_anm_tpu.vec` / :mod:`gym_anm_tpu.tasks` — pure-functional
  vectorized environments for on-device rollouts at scale.
"""

import jax as _jax

# The parity tier needs float64 (the reference is float64 numpy throughout).
# Performance-tier code pins float32 explicitly, so enabling x64 globally
# costs nothing on the hot paths.
_jax.config.update("jax_enable_x64", True)

# Persist XLA compiles across processes (utils/compile_cache.py).
from .utils.compile_cache import enable_persistent_cache as _enable_cache  # noqa: E402

_enable_cache()

from . import errors  # noqa: E402
from .specs import NetworkSpec, check_network_specs, load_network  # noqa: E402

# Register the canonical tasks with Gymnasium under the reference's IDs.
# Gymnasium is needed only by the compat tier and GymVectorEnv; the vec
# tier, the learners and the benchmarks run without it.
try:
    from gymnasium.envs.registration import register as _register, registry as _registry
except ImportError:
    _registry = None
if _registry is not None:
    for _id, _ep in (
        ("ANM6Easy-v0", "gym_anm_tpu.compat:ANM6Easy"),
        ("IEEE33-v0", "gym_anm_tpu.compat:IEEE33Env"),
    ):
        if _id not in _registry:
            _register(id=_id, entry_point=_ep)

__version__ = "0.1.0"

__all__ = [
    "errors",
    "NetworkSpec",
    "check_network_specs",
    "load_network",
]


def __getattr__(name):
    # Lazy imports keep `import gym_anm_tpu` light and avoid circular deps.
    if name in ("ANMEnv", "ANM6", "ANM6Easy", "IEEE33Env", "IEEE33RenewableEnv",
                "IEEE33MultiCapacitorEnv", "IEEE33UnequalCapacitorsEnv"):
        from . import compat

        return getattr(compat, name)
    if name in ("MPCAgent", "MPCAgentConstant", "MPCAgentPerfect"):
        from . import agents

        return getattr(agents, name)
    if name in (
        "generate_dataset",
        "generate_mixed_dataset",
        "behavior_cloning",
        "evaluate_policy",
    ):
        from . import offline

        return getattr(offline, name)
    raise AttributeError(f"module 'gym_anm_tpu' has no attribute {name!r}")
