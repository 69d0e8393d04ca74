"""Gymnasium-compatible single-env tier (reference API parity, float64)."""

from .anm_env import ANMEnv
from .ieee33 import IEEE33Env

__all__ = ["ANMEnv", "IEEE33Env"]


def __getattr__(name):
    if name in ("ANM6", "ANM6Easy"):
        from . import anm6_easy

        return getattr(anm6_easy, name)
    if name == "IEEE33RenewableEnv":
        from .ieee33_renewable import IEEE33RenewableEnv

        return IEEE33RenewableEnv
    if name == "IEEE33MultiCapacitorEnv":
        from .ieee33_multi_capacitor import IEEE33MultiCapacitorEnv

        return IEEE33MultiCapacitorEnv
    if name == "IEEE33UnequalCapacitorsEnv":
        from .ieee33_unequal_capacitors import IEEE33UnequalCapacitorsEnv

        return IEEE33UnequalCapacitorsEnv
    if name == "IEEE33ProperEnvironment":
        from .ieee33_proper import IEEE33ProperEnvironment

        return IEEE33ProperEnvironment
    if name == "FinalCorrectEnv":
        from .ieee33_legacy import FinalCorrectEnv

        return FinalCorrectEnv
    raise AttributeError(f"module 'gym_anm_tpu.compat' has no attribute {name!r}")
