"""Multi-host smoke demo: a (data, freq) mesh spanning two processes.

Run BOTH of these (different terminals or backgrounded), each sees 4 local
virtual CPU devices and an 8-device global mesh:

    python examples/multihost_demo.py 0 2 127.0.0.1:9731
    python examples/multihost_demo.py 1 2 127.0.0.1:9731

On a real cluster each host runs its own process with the same code and
``init_multihost(coordinator, n_processes, process_id)``; the mesh then
spans all hosts' devices.  The epoch-mean ``pmean`` is the only
cross-process collective.
"""
import os
import sys


def main(proc: int, nproc: int, coordinator: str) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=4")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from ninwavelets_tpu import parallel as par
    par.init_multihost(coordinator_address=coordinator,
                       num_processes=nproc, process_id=proc)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    import ninwavelets_tpu as nw
    from ninwavelets_tpu.ops.bank import make_fft_bank

    n_global = jax.device_count()
    print(f"proc {proc}: local={jax.local_device_count()} "
          f"global={n_global}", flush=True)

    mesh = par.make_mesh(data=n_global // 2, freq=2)
    morse = nw.Morse(1000.0)
    bank = jnp.asarray(np.asarray(
        make_fft_bank(morse._wdef(), jnp.arange(10.0, 42.0), 512, 1000.0),
        np.float32))
    sig = np.random.default_rng(0).standard_normal((8, 2, 512)).astype(
        np.float32)
    dev = par.shard_batch(jnp.asarray(sig), mesh, P(par.DATA_AXIS))
    out = par.sharded_mean_power(dev, bank, mesh=mesh)
    ok = bool(jnp.isfinite(out).all())
    print(f"proc {proc}: TFR {out.shape} finite={ok}", flush=True)
    assert ok

    # Full distributed TRAINING step across the processes: the cotangent
    # is freq-sharded like the power; the bank gradient's data-psum is a
    # second cross-process collective.
    g = par.shard_batch(jnp.ones_like(out), mesh,
                        P(None, par.FREQ_AXIS, None))
    p, ds, db = par.sharded_mean_power_grad(dev, bank, g, mesh=mesh)
    ok2 = bool(jnp.isfinite(ds).all()) and bool(jnp.isfinite(db).all())
    print(f"proc {proc}: train step ds{ds.shape} db{db.shape} "
          f"finite={ok2}", flush=True)
    assert ok2


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]),
         sys.argv[3] if len(sys.argv) > 3 else "127.0.0.1:9731")
