"""Port parity: colour science, rounding and the transfer functions of
phaneron_tpu_torch against phaneron_tpu on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.ops import colour_maths as jcm
from phaneron_tpu.ops import gamma as jgamma
from phaneron_tpu.ops import quant as jquant
from phaneron_tpu_torch.ops import colour_maths as tcm
from phaneron_tpu_torch.ops import gamma as tgamma
from phaneron_tpu_torch.ops import quant as tquant
from torch_parity import ulps

torch.set_num_threads(1)

SPECS = sorted(jcm.COLOUR_SPECS)


@pytest.mark.parametrize("col", SPECS)
def test_colour_tables_equal(col):
    assert vars(tcm.COLOUR_SPECS[col]) == vars(jcm.COLOUR_SPECS[col])
    assert np.array_equal(tcm.gamma2linear_lut(col), jcm.gamma2linear_lut(col))
    assert np.array_equal(tcm.linear2gamma_lut(col), jcm.linear2gamma_lut(col))
    for ranges in ((10, 64, 940, 896), (8, 16, 235, 224)):
        assert np.array_equal(tcm.ycbcr2rgb_matrix(col, *ranges), jcm.ycbcr2rgb_matrix(col, *ranges))
        assert np.array_equal(tcm.rgb2ycbcr_matrix(col, *ranges), jcm.rgb2ycbcr_matrix(col, *ranges))
    for dst in SPECS:
        assert np.array_equal(tcm.rgb2rgb_matrix(col, dst), jcm.rgb2rgb_matrix(col, dst))


TIES = np.array(
    [-2.5, -1.5, -0.5, -0.0, 0.5, 1.5, 2.5, 3.5, 254.5, 255.5, 256.5, 1023.5,
     65534.5, 65535.5, 65536.5, 1e6, -1e6, 0.49999997, 1.4999999],
    dtype=np.float32,
)


@pytest.mark.parametrize(
    "name",
    ["u16_sat_rte", "u16_sat_rtz", "u16_sat_round_half_away", "u10_sat_rte",
     "u8_sat_rte", "round_half_away"],
)
def test_quant_ties_equal(name):
    want = np.asarray(getattr(jquant, name)(jnp.asarray(TIES)))
    got = getattr(tquant, name)(torch.from_numpy(TIES)).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


IDX = np.arange(65536, dtype=np.int32)


@pytest.mark.parametrize("col", SPECS)
def test_gamma2linear_within_one_ulp(col):
    """gamma' -> linear over every LUT index: within 1 float32 ulp of JAX
    (exact since the table takes the C library's powf, which is XLA's:
    test_gamma2linear_table_equals_jax)."""
    want = np.asarray(jgamma.gamma2linear_at_index(col, jnp.asarray(IDX)))
    got = tgamma.gamma2linear_at_index(col, torch.from_numpy(IDX)).numpy()
    assert ulps(got, want).max() <= 1


@pytest.mark.parametrize("col", SPECS)
def test_gamma2linear_table_equals_jax(col):
    """The gamma'->linear table (the C library's powf for the power term)
    equals JAX's gamma2linear_at_index at all 65536 indices, and the
    analytic Gamma of the port's loaders gathers from it."""
    want = np.asarray(jgamma.gamma2linear_at_index(col, jnp.asarray(IDX)))
    table = tgamma.g2l_table(col)
    assert table.dtype == np.float32 and table.shape == (65536,)
    assert int((table != want).sum()) == 0
    idx = torch.from_numpy(IDX)
    assert torch.equal(tgamma.gamma2linear_at_index(col, idx), torch.from_numpy(want.copy()))


@pytest.mark.parametrize("col", SPECS)
def test_gamma2linear_power_branch_equals_jax_programs(col):
    """Inside a compiled JAX program the power branch keeps these values
    (XLA's float32 pow is the C library's powf); only the linear branch
    moves, by at most 2 ulps, where XLA folds fi * (1/65535) * (1/delta)
    into one constant product."""
    p = jcm.COLOUR_SPECS[col]
    want = np.asarray(jax.jit(lambda i: jgamma.gamma2linear_at_index(col, i))(jnp.asarray(IDX)))
    table = tgamma.g2l_table(col)
    fi = IDX.astype(np.float32) * np.float32(1.0 / 65535)
    power = fi >= np.float32(p.beta * p.delta)
    assert np.array_equal(table[power], want[power])
    assert ulps(table[~power], want[~power]).max() <= 2


@pytest.mark.parametrize("col", SPECS)
def test_linear2gamma_power_term_within_one_ulp(col):
    """linear -> gamma' over every LUT index.  The float32 power term
    x**gamma is within 1 ulp of JAX's (not exact, as for gamma' ->
    linear).  Scaled by alpha and rounded, that ulp becomes at most 2
    ulps of the product alpha*x**gamma; the subtraction of alpha-1 then
    cancels up to two leading bits, so the result is held to 2 ulps of
    the product (up to 4 ulps of the result itself)."""
    p = jcm.COLOUR_SPECS[col]
    want = np.asarray(jgamma.linear2gamma_at_index(col, jnp.asarray(IDX)))
    got = tgamma.linear2gamma_at_index(col, torch.from_numpy(IDX)).numpy()
    fi = IDX.astype(np.float32) * np.float32(1.0 / 65535)
    pw_j = np.asarray(jnp.power(jnp.asarray(fi), np.float32(p.gamma)))
    pw_t = torch.pow(torch.from_numpy(fi), float(np.float32(p.gamma))).numpy()
    assert ulps(pw_t, pw_j).max() <= 1
    product_ulp = np.spacing(np.abs(np.float32(p.alpha) * pw_j)).astype(np.float32)
    assert (np.abs(got - want) <= 2 * product_ulp).all()


@pytest.mark.parametrize("col", ["709", "sRGB"])
def test_gamma_lut_apply_equal(col):
    x = np.linspace(-0.1, 1.1, 4099, dtype=np.float32)
    lut = jcm.gamma2linear_lut(col)
    want = np.asarray(jgamma.gamma_lut_apply(jnp.asarray(lut), jnp.asarray(x)))
    got = tgamma.gamma_lut_apply(torch.from_numpy(lut), torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
