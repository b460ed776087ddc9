"""B7 (`ops/kernels/itx.py`) on the 64x64 DCT of the
`tests/test_itx_kernels.py` subset, at 8 and 10 bits, with extreme
levels: `residual_bucket`, `inverse_transform_batch` and `dequant_batch`
equal the JAX package's (its `residual_bucket` as its body: the JAX
`inverse_transform_batch` of the JAX `dequant_batch`, so that JAX
compiles each 64-point transform once)."""
import pytest

from test_torch_itx import SUBSET, check_against_jax


@pytest.mark.parametrize("bd", [8, 10])
def test_b7_matches_jax_64(bd):
    assert (4, 0) in SUBSET
    check_against_jax(4, 0, bd, composed=True)
