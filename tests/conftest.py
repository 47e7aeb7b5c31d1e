import os
import sys

# The suite runs on XLA's CPU backend with 8 virtual devices (the sharding
# tests build meshes on them); set before jax is imported.
# USEARCH_GPU_TESTS=1 leaves the backend to JAX, so that the tests marked
# `gpu` run on the card: USEARCH_GPU_TESTS=1 python -m pytest tests -m gpu
if os.environ.get("USEARCH_GPU_TESTS") != "1":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs the GPU (runs with USEARCH_GPU_TESTS=1)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: USEARCH_GPU_TESTS=1 on a machine "
                    "with one")


REF_BIN_SRC = "/root/reference/tmp/usearch_linux_x86_12.0-beta"
REF_BIN = "/tmp/usearch_ref_test"


@pytest.fixture(scope="session")
def ref_bin():
    """Executable copy of the reference binary (skip if unavailable)."""
    import shutil
    import stat
    if not os.path.exists(REF_BIN):
        if not os.path.exists(REF_BIN_SRC):
            pytest.skip("reference binary not available")
        shutil.copy(REF_BIN_SRC, REF_BIN)
        os.chmod(REF_BIN, os.stat(REF_BIN).st_mode | stat.S_IXUSR)
    return REF_BIN


@pytest.fixture(scope="session")
def amplicons_fa(tmp_path_factory):
    from tests.genseqs import make_amplicons, write_fasta
    path = str(tmp_path_factory.mktemp("data") / "amplicons.fa")
    write_fasta(path, make_amplicons())
    return path


@pytest.fixture(scope="session")
def amplicons_small_fa(tmp_path_factory):
    from tests.genseqs import make_amplicons, write_fasta
    path = str(tmp_path_factory.mktemp("data") / "amplicons_small.fa")
    write_fasta(path, make_amplicons(n_templates=6, reads_per_template=5,
                                     seed=11))
    return path


@pytest.fixture(autouse=True)
def fresh_options():
    from usearch12_tpu.config import reset_options
    reset_options()
    yield
