"""Test configuration: 8 virtual CPU devices so sharding tests run without
accelerator hardware (see SURVEY.md section 2). The backend itself is chosen
by the caller: the CPU suite runs under ``JAX_PLATFORMS=cpu``, and the
card-only tests (marker ``gpu``) skip wherever no GPU is present."""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where none is present. Decided
    here, at run time, never while a module is imported."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with `python -m pytest "
                    "tests/ -m gpu -p no:xdist` on the card)")
    return devs[0]


@pytest.fixture(scope="session")
def synth_case(tmp_path_factory):
    """A small synthetic Case1-analog dataset written to disk once per
    session: 2 stations, 3 repeating sources x 3 events + 2 singles, 8 hours
    of continuous data with 3 hidden (unlisted) repeats planted."""
    from detex_tpu.data.synth import SynthCatalog
    root = tmp_path_factory.mktemp("case1")
    cat = SynthCatalog(n_sources=2, events_per_source=3, n_singles=1,
                       n_stations=2, sr=25.0, span_hours=20, seed=1,
                       noise=0.04)
    cat.add_hidden_events(n=2, mag=1.4, sources=[0, 1])
    paths = cat.write_directories(str(root), tb4=10, taft=60)
    paths["cat"] = cat
    return paths
