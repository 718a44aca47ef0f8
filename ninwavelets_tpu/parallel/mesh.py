"""Device-mesh construction for the sharded CWT engine.

The reference has no distributed backend at all (SURVEY §2.2: its only
parallel code is an *unused* ``multiprocessing`` pool,
``/root/reference/ninwavelets/tooltip.py:29-58``).  This build scales the
workload's three embarrassing/structured axes over a ``jax.sharding.Mesh``:

* ``data`` — epochs x channels (pure data parallel; the reference loops these
  in Python, ``mneutils.py:37-40``),
* ``freq`` — the analysis-frequency axis of the (F, N) bank (bank/tensor
  parallel: each device synthesizes its own frequency slice —
  recompute beats transfer),
* ``time`` — the signal's time axis for long recordings (sequence parallel:
  chunked overlap-save convolution with ``ppermute`` halo exchange, see
  ``ninwavelets_tpu.parallel.chunked``).

All collectives are XLA's (`psum`/`ppermute` inside ``shard_map``), which
hands them to the device's collective library (NCCL on GPUs); there is no
communicator to manage by hand.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

DATA_AXIS = "data"
FREQ_AXIS = "freq"
TIME_AXIS = "time"


def make_mesh(data: int = 1, freq: int = 1, time: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, freq, time) mesh over ``data * freq * time`` devices.

    Axis sizes of 1 are kept in the mesh (size-1 axes are free), so the same
    program text works for any factorization.
    """
    if devices is None:
        devices = jax.devices()
    n = data * freq * time
    if len(devices) < n:
        raise ValueError(
            f"mesh {data}x{freq}x{time} needs {n} devices, "
            f"have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(data, freq, time)
    return Mesh(dev, (DATA_AXIS, FREQ_AXIS, TIME_AXIS))


def flat_mesh(axis: str = TIME_AXIS,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over all (or the given) devices along a single axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def auto_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Factor ``n_devices`` into (data, freq) with data >= freq — the default
    layout for the epochs/TFR workload (data parallelism is the cheap axis:
    the epoch-mean ``psum`` is the only collective it costs).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    freq = 1
    for cand in range(int(math.isqrt(n_devices)), 0, -1):
        if n_devices % cand == 0:
            freq = cand
            break
    return make_mesh(data=n_devices // freq, freq=freq, time=1,
                     devices=devices[:n_devices])


def shard_batch(x, mesh: Mesh, spec: PartitionSpec):
    """Place a host array onto the mesh with the given PartitionSpec."""
    return jax.device_put(x, NamedSharding(mesh, spec))


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int) -> np.ndarray:
    """Zero-pad ``axis`` up to the next multiple (host-side helper for making
    batch axes divisible by their mesh axis)."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX (``jax.distributed.initialize``) so a mesh
    can span hosts; no-op when already initialized.  Pass the coordinator
    address (``host:port``), process count and this process's id unless
    the cluster environment supplies them.
    """
    import jax.distributed as jd
    try:
        jd.initialize(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    except RuntimeError as e:  # already initialized
        if "already" not in str(e):
            raise
