"""Test env: CPU with 8 virtual devices (multi-chip tests run on a
virtual mesh, per SURVEY.md §4). Must run before jax imports."""

import os
import sys

# CPU unless the caller named a platform (chip_smoke.py runs the
# gpu-marked tests in its own GPU process with JAX_PLATFORMS=cuda).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# jax may have been imported already, in which case the env var is too
# late — force the config directly before any backend is initialized.
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def box_glb(tmp_path_factory):
    from assets.procedural import make_box

    path = tmp_path_factory.mktemp("scenes") / "box.glb"
    make_box(str(path))
    return str(path)


@pytest.fixture(scope="session")
def cornell_glb(tmp_path_factory):
    from assets.procedural import make_cornell

    path = tmp_path_factory.mktemp("scenes") / "cornell.glb"
    make_cornell(str(path))
    return str(path)


@pytest.fixture(scope="session")
def sphere_glb(tmp_path_factory):
    from assets.procedural import make_textured_sphere

    path = tmp_path_factory.mktemp("scenes") / "sphere.glb"
    make_textured_sphere(str(path), lat=16, lon=32)
    return str(path)


@pytest.fixture(scope="session")
def columns_glb(tmp_path_factory):
    from assets.procedural import make_columns

    path = tmp_path_factory.mktemp("scenes") / "columns.glb"
    make_columns(str(path), grid=4, segments=3, n_materials=4)
    return str(path)


@pytest.fixture(scope="session")
def rng_np():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import,
    so every xdist worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
