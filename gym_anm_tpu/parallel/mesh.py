"""Device-mesh utilities for the sharded environment farm.

The env lanes are fully independent (no cross-env coupling exists anywhere
in the physics), so the farm is embarrassingly parallel: a 1-D mesh over an
``env`` axis with every per-lane array sharded on its leading dimension.
Collectives appear only at the learner boundary (gradient/metric psum,
inserted by GSPMD from the sharding annotations); on GPUs XLA hands them
to NCCL.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_env_mesh(devices=None, axis_name="env"):
    """A 1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def env_sharding(mesh, axis_name="env"):
    """Sharding for per-lane batched arrays: leading dim over the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh):
    """Sharding for parameters/broadcast constants."""
    return NamedSharding(mesh, P())


def shard_env_state(state, mesh, axis_name="env"):
    """Place a batched EnvState pytree with lanes sharded over the mesh."""
    sh = env_sharding(mesh, axis_name)

    def place(x):
        return jax.device_put(x, sh)

    return jax.tree_util.tree_map(place, state)
