"""Test configuration.

All tests run on CPU, which is the reference backend of the parity tier,
and the multi-device sharding tests use 8 virtual CPU devices.  These
settings must land before the JAX backend initializes.  Tests marked
``gpu`` skip here; chip_smoke.py runs their checks on the card.
"""

import os
import sys
import types

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

REFERENCE_PATH = "/root/reference"


def _install_reference_stubs():
    """Make the reference package importable without its optional deps.

    cvxpy is replaced by :mod:`tests.minicvxpy` — a scipy-backed modeling
    layer that actually SOLVES everything the reference builds: the
    per-device projection QPs (so reference rollouts work for golden
    parity) and the MPC DC-OPF LP (so the reference MPC agents execute
    live for action-level parity, tests/test_mpc_reference_parity.py).

    Two interchangeable projection-QP backends (cv._qp_backend, default
    "enumeration"):

    - "enumeration": exact closed-form candidate enumeration — fast, but
      the same algorithm family as gym_anm_tpu.physics.projection, so
      golden rollouts through it are partly self-referential.
    - "slsqp": scipy.optimize SLSQP — an iterative SQP method, algorithm-
      family independent of the shipped projection.  Used by the
      end-to-end QP-validation parity test (switch with
      tests.conftest.qp_backend("slsqp")).
    """
    if "cvxpy" not in sys.modules:
        from . import minicvxpy

        sys.modules["cvxpy"] = minicvxpy

    for name in ("websocket_server", "websocket", "requests"):
        if name not in sys.modules:
            sys.modules[name] = types.ModuleType(name)
    if not hasattr(sys.modules["websocket_server"], "WebsocketServer"):
        sys.modules["websocket_server"].WebsocketServer = object
    if not hasattr(sys.modules["websocket"], "create_connection"):
        sys.modules["websocket"].create_connection = lambda *a, **k: None


import contextlib  # noqa: E402


@contextlib.contextmanager
def qp_backend(name):
    """Temporarily switch the reference cvxpy stub's QP solver backend
    ("enumeration" or "slsqp")."""
    cv = sys.modules["cvxpy"]
    prev = cv._qp_backend
    cv._qp_backend = name
    try:
        yield
    finally:
        cv._qp_backend = prev


def reference_available():
    return os.path.isdir(REFERENCE_PATH)


@pytest.fixture(scope="session")
def reference():
    """Import the reference gym_anm package (read-only upstream)."""
    if not reference_available():
        pytest.skip("reference implementation not available")
    _install_reference_stubs()
    if REFERENCE_PATH not in sys.path:
        sys.path.insert(0, REFERENCE_PATH)
    import gym_anm as ref_pkg  # noqa: F401

    return ref_pkg


requires_reference = pytest.mark.skipif(
    not reference_available(), reason="reference implementation not available"
)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU.  Decided when the test
    runs, never at import, so every xdist worker collects the same tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")
