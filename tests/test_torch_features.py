"""Port parity: Hermite feature maps (tneq_tpu_torch.ops.features vs
tneq_tpu.ops.features).

The same numpy data go through both packages.  Both run the normalised
recurrence in float32 with the same float32 coefficients; they differ only
in the rounding of exp and of the products, so values agree to
max|diff| <= 2e-6 * max(1, max|ref|).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tneq_tpu.ops import features as jf
from tneq_tpu_torch.ops import features as tf

torch.set_num_threads(1)

TOL = 2e-6


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * max(1.0, float(np.abs(ref).max()))


def _x(B, D, amp, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-amp, amp, size=(B, D)).astype(np.float32)
    x[0, 0], x[-1, -1] = amp, -amp  # the ends of the range
    return x


@pytest.mark.parametrize("K", [1, 2, 4, 16])
@pytest.mark.parametrize("amp", [1.0, 5.0])
def test_hermite_phi_and_measurements_match_jax(K, amp):
    x = _x(9, 5, amp)
    _close(tf.hermite_phi(torch.as_tensor(x), K), jf.hermite_phi(jnp.asarray(x), K))
    _close(tf.measurement_matrices(torch.as_tensor(x), K),
           jf.measurement_matrices(jnp.asarray(x), K))


def test_hermite_weights_match_jax():
    _close(tf.hermite_weights(20, device="cpu"), jf.hermite_weights(20))
    w = tf.hermite_weights(3, torch.float64, device="cpu")
    assert w.dtype == torch.float64 and w.shape == (4,)


def test_complex_input_takes_the_real_part():
    x = _x(4, 3, 2.0)
    xc = x + 1j * np.ones_like(x)
    _close(tf.hermite_phi(torch.as_tensor(xc), 4), tf.hermite_phi(torch.as_tensor(x), 4))


@pytest.mark.parametrize("dtype,jdtype", [(None, None), (torch.complex64, jnp.complex64)])
def test_generate_data_matches_jax(dtype, jdtype):
    x = _x(6, 4, 3.0, seed=2)
    mx_t, phi_t = tf.generate_data(torch.as_tensor(x), 3, dtype=dtype)
    mx_j, phi_j = jf.generate_data(jnp.asarray(x), 3, dtype=jdtype)
    assert len(mx_t) == len(mx_j) == 4
    for a, b in zip(mx_t, mx_j):
        assert a.shape == (6, 3, 3)
        _close(a, b)
    _close(phi_t, phi_j)
    if dtype is not None:
        assert phi_t.dtype == dtype and mx_t[0].dtype == dtype


def test_features_stay_on_the_input_device():
    phi = tf.hermite_phi(torch.zeros(2, 3), 3)
    assert phi.device.type == "cpu" and phi.dtype == torch.float32
