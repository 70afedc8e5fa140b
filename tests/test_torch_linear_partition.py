"""The port's `models.linear` and `data.partition` against the JAX
package's, on the CPU: the partitions bit-equal from the same
`np.random.default_rng(seed)` (host NumPy in both), the linear model's
prediction and loss on the same float32 inputs within rtol 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import partition_iid as j_partition_iid
from repro.data import partition_noniid as j_partition_noniid
from repro.models import linreg_loss as j_linreg_loss
from repro.models import linreg_predict as j_linreg_predict
from repro_torch.data import partition_iid, partition_noniid
from repro_torch.models import linreg_loss, linreg_predict


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("n_items,n_clients", [(100, 7), (7200, 24), (5, 8)])
def test_partition_iid_is_the_reference_s(n_items, n_clients):
    got = partition_iid(n_items, n_clients, np.random.default_rng(3))
    _same(got, j_partition_iid(n_items, n_clients, np.random.default_rng(3)))
    assert np.array_equal(np.sort(np.concatenate(got)), np.arange(n_items))


@pytest.mark.parametrize("alpha", [0.1, 1.0, 100.0])
def test_partition_noniid_is_the_reference_s(alpha):
    """Dirichlet(alpha) label skew over 10 classes of 2000 labels, 8
    clients: the same index arrays, which cover every item once; the
    generator is left in the same state."""
    labels = np.random.default_rng(0).integers(0, 10, 2000)
    rng, j_rng = np.random.default_rng(5), np.random.default_rng(5)
    got = partition_noniid(labels, 8, alpha, rng)
    _same(got, j_partition_noniid(labels, 8, alpha, j_rng))
    assert np.array_equal(np.sort(np.concatenate(got)), np.arange(2000))
    assert rng.random() == j_rng.random()


def test_linreg_matches_jax():
    """The §IV shape: X (7200, 500), beta (500,), y (7200,)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((7200, 500)).astype(np.float32)
    beta = rng.standard_normal(500).astype(np.float32)
    y = (x @ beta + 0.1 * rng.standard_normal(7200)).astype(np.float32)
    beta_t = torch.from_numpy(beta)
    x_t, y_t = torch.from_numpy(x), torch.from_numpy(y)
    pred = linreg_predict(beta_t, x_t)
    want = np.asarray(j_linreg_predict(jnp.asarray(beta), jnp.asarray(x)))
    np.testing.assert_allclose(pred.numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))
    loss = linreg_loss(beta_t, x_t, y_t)
    j_loss = float(j_linreg_loss(jnp.asarray(beta), jnp.asarray(x),
                                 jnp.asarray(y)))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-6)
