"""Multi-process (multi-host) smoke worker: the real distributed init path.

Runs ``jax.distributed.initialize`` and one sharded PPO training step with
the environment farm split across processes — the same code path a real
≥2-host GPU deployment uses (there, NCCL replaces Gloo and each process
sees its host's cards; nothing else changes).

Launched by ``tests/test_multihost.py`` as 2 CPU processes × 2 virtual
devices each; also usable manually:

    python scripts/multihost_smoke.py <proc_id> <n_procs> <coordinator_port>

Prints ``RESULT <proc_id> <loss> <mean_reward>`` — the test asserts the
values are identical across processes (the psum makes them global) and
match a single-process run of the same computation.
"""

import os
import sys


def main(proc_id: int, n_procs: int, port: str, devices_per_proc: int = 2):
    # Force CPU before JAX initializes.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={devices_per_proc}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_procs,
        process_id=proc_id,
    )

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from gym_anm_tpu.parallel import PPOConfig, init_train_state, make_train_step
    from gym_anm_tpu.vec import VecEnv, make_ieee33_task

    devs = jax.devices()
    assert len(devs) == n_procs * devices_per_proc, devs
    mesh = Mesh(np.array(devs), ("env",))
    env_sh = NamedSharding(mesh, P("env"))
    rep_sh = NamedSharding(mesh, P())

    env = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    cfg = PPOConfig(hidden=16, rollout_len=2)
    B = len(devs) * 2  # 2 lanes per device

    # Each process resets ITS lanes (same global key schedule on all
    # processes, sliced to the local block), then assembles global arrays.
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    lanes_per_proc = B // n_procs
    lo = proc_id * lanes_per_proc
    local_keys = keys[lo : lo + lanes_per_proc]
    with jax.default_device(jax.local_devices()[0]):
        state_local, obs_local = jax.vmap(env.reset)(local_keys)

    def to_global(x):
        return jax.make_array_from_process_local_data(env_sh, np.asarray(x))

    state = jax.tree_util.tree_map(to_global, state_local)
    obs = to_global(obs_local)

    # Parameters: identical on every process (same seed) -> replicated.
    ts = init_train_state(jax.random.PRNGKey(1), env.n_state, env.n_action, cfg)
    ts = jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(rep_sh, np.asarray(x)), ts
    )

    train_step = jax.jit(
        make_train_step(env, cfg),
        in_shardings=(rep_sh, env_sh, env_sh),
        out_shardings=(rep_sh, env_sh, env_sh, rep_sh),
    )
    ts2, state2, obs2, metrics = train_step(ts, state, obs)
    loss = float(metrics["loss"].addressable_data(0))
    mean_r = float(metrics["mean_reward"].addressable_data(0))
    print(f"RESULT {proc_id} {loss:.8f} {mean_r:.8f}", flush=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
