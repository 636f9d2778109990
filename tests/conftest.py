"""Test configuration: CPU-only JAX with an 8-device virtual mesh and x64.

Tests never use an accelerator: kernels run through XLA:CPU, and
multi-device sharding is validated on the virtual CPU mesh — the strategy
SURVEY.md section 4 prescribes. Keeping the suite off the GPU also keeps
its parallel workers from each reserving the card. Must run before any
jax import, hence the env mutation at module import time.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def random_csr(rng, n, m, density=0.05, dtype=np.float64):
    """Small random CSR fixture with at least one entry per row."""
    nnz_row = np.maximum(1, rng.binomial(m, density, size=n))
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_row)
    cols = np.concatenate(
        [rng.choice(m, size=k, replace=False) for k in nnz_row]
    ).astype(np.int64)
    vals = rng.normal(size=len(rows)).astype(dtype)
    from lilac.formats.convert import coo_to_csr_arrays

    return coo_to_csr_arrays(rows, cols, vals, (n, m)), (n, m)


@pytest.fixture
def small_csr(rng):
    return random_csr(rng, 57, 43, 0.1)
