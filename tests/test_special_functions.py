"""Special-function accuracy: float64-grade Bessel K against scipy.

The reference uses std::cyl_bessel_k (double) for the thermal Faraday
coefficients (simulation_coefficients.cpp:526-556); the jnp
implementation (series + Steed CF2) must match library-grade values so
polarized Q/U/V parity is not limited by special functions.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from blacklight.models.synchrotron import _bessel_k

scipy_special = pytest.importorskip("scipy.special")


@pytest.mark.parametrize("order", [0, 1, 2])
def test_bessel_k_matches_scipy(order):
    x = np.concatenate([
        np.logspace(-6, np.log10(3.0), 200),
        np.linspace(3.001, 100.0, 300),
        np.linspace(100.0, 690.0, 50),
    ])
    ours = np.asarray(_bessel_k(order, jnp.asarray(x)))
    ref = scipy_special.kve(order, x) * np.exp(-x)
    ok = ref > 0
    rel = np.abs(ours[ok] - ref[ok]) / np.abs(ref[ok])
    assert rel.max() < 1e-12, (rel.max(), x[ok][rel.argmax()])


def test_bessel_k2_recurrence():
    x = np.linspace(0.5, 50.0, 100)
    k0 = np.asarray(_bessel_k(0, jnp.asarray(x)))
    k1 = np.asarray(_bessel_k(1, jnp.asarray(x)))
    k2 = np.asarray(_bessel_k(2, jnp.asarray(x)))
    np.testing.assert_allclose(k2, k0 + 2.0 * k1 / x, rtol=1e-14)
