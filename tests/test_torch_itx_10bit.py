"""B7 (`ops/kernels/itx.py`) at 10 bits: `residual_bucket`,
`inverse_transform_batch` and `dequant_batch` equal the JAX package's on
the `tests/test_itx_kernels.py` subset below 64 points, with extreme
levels (`tests/test_torch_itx.py` holds the 8-bit cases)."""
import pytest

from test_torch_itx import SUBSET_BELOW_64, check_against_jax


@pytest.mark.parametrize("tsz,tt", SUBSET_BELOW_64)
def test_b7_matches_jax_10bit(tsz, tt):
    check_against_jax(tsz, tt, 10)
