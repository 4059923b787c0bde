"""Test configuration.

By default every test runs on the CPU with an 8-device virtual mesh:
device-decoder correctness is validated on CPU (jit semantics are
identical), and multi-device sharding logic runs on the virtual devices
via --xla_force_host_platform_device_count.

``--chip`` leaves the accelerator in place for the tests marked ``chip``
(``python -m pytest tests/ -m chip --chip`` on a machine with a GPU).
Those tests find out inside a fixture whether a GPU is present and skip
when none is, so every worker collects the same tests.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--chip",
        action="store_true",
        default=False,
        help="keep JAX's default accelerator (for the tests marked chip)",
    )


def pytest_configure(config):
    if config.getoption("--chip"):
        return
    # Before JAX initializes a backend: CPU only, with 8 virtual devices.
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables between test modules.

    The suite compiles hundreds of jitted programs across 8 virtual CPU
    devices; accumulated executables/thread pools eventually segfault the
    CPU client deep into the run (observed repeatedly in full-suite runs
    at the same test while every module passes in isolation).  Dropping
    executable caches per module keeps the process footprint flat; jitted
    functions recompile lazily if reused.
    """
    yield
    import jax

    jax.clear_caches()


@pytest.fixture
def gpu():
    """The first GPU, or a skip when JAX has none (tests marked chip)."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: run with --chip on a machine with one")
    return devs[0]
