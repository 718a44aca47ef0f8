"""Test configuration: run everything on CPU with 8 virtual XLA devices so
sharding/collective tests exercise a real (fake) mesh without accelerator
hardware.  Must run before the first jax import anywhere in the test
session.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

assert jax.devices()[0].platform == "cpu", (
    "tests must run on the virtual CPU mesh, got " + str(jax.devices()[:1]))
assert len(jax.devices()) == 8

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def example_signal():
    """The reference's de-facto golden input (``test.py:17-27``): 60 Hz sine
    + amplitude-modulated 160 Hz + time-windowed 300 Hz burst, 1 s @ 1 kHz.
    """
    return make_example(1.0)


def make_example(length: float = 3.0) -> np.ndarray:
    """Composite validation signal, float64, same construction as the
    reference demo driver (``/root/reference/ninwavelets/test.py:17-27``).
    """
    time = np.arange(0, length, 0.001)
    burst_t = np.pad(np.arange(0, length / 2, 0.001),
                     [int(length * 250), int(length * 250)], 'constant')
    return (np.sin(time * 60 * 2 * np.pi)
            + np.sin(time * 160 * 2 * np.pi) * np.sin(time * np.pi)
            + np.sin(burst_t * 300 * 2 * np.pi))


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    The full suite compiles thousands of XLA CPU programs; each live
    executable holds JIT code mappings, and the process walks into the
    kernel's 65530-mapping ceiling (`vm.max_map_count`) near the end of
    a single-process run — observed as a segfault inside
    `backend_compile_and_load` at ~93% in rounds 3-4, at a *different*
    test each time (cumulative resource, not a bad test).  Clearing the
    jit caches per module keeps the mapping count bounded; modules
    recompile their own programs, which costs ~nothing relative to the
    crash it prevents.
    """
    yield
    import jax as _jax

    _jax.clear_caches()
    try:
        with open("/proc/self/maps") as fh:
            n_maps = sum(1 for _ in fh)
        if n_maps > 55000:  # pragma: no cover - early warning only
            import sys

            print("WARNING: %d memory mappings (ceiling 65530)" % n_maps,
                  file=sys.stderr)
    except OSError:  # pragma: no cover - non-Linux
        pass
