"""Public names the port exports under the reference's names, on the CPU.

`repro_torch.core`'s package-level names (resolved on first use, so that
importing the package imports no submodule), the kernel families' plain
oracles `kernels.{coded_grad,encode,flash_attn,ssd}.ops.reference`,
`kernels.encode.ops.reference_fleet` and `generator_values`, and
`kernels.encode.ref.encode_fleet`, each against the reference's name on
the same NumPy inputs.

Every name of `repro_torch.core` is the object its submodule defines
(`test_core_exports_the_references_names`), and each is called here
through the package against `repro.core`'s, except where the two
packages cannot take the same inputs, and those are held to the
reference in the submodules' tests:

  * `solve_redundancy` and its `RedundancyPlan`: the reference's batched
    solver does not run on the installed JAX, so the port's planner is
    held to `repro.plan.reference.solve_redundancy_reference`
    (`tests/test_torch_plan.py`); `RedundancyPlan` and its `delta` also
    in `tests/test_torch_host_layer.py::test_systematic_weights_bit_equal`;
  * `generator_matrix`, `encode_fleet` and `setup` draw from a
    `torch.Generator` where the reference draws from a JAX key: the
    fleet encode on explicit generators against `encode_fleet` of
    `repro.kernels.encode.ref`
    (`tests/test_torch_kernels.py::test_encode_fleet_streamed_matches_explicit_oracle`,
    and `reference_fleet` here), the generator's moments and its draw
    order (`test_generator_matrix`, `test_encode_fleet_draws_clients_in_order`),
    and `setup`'s weights and load mask bit-equal to the reference's
    (`tests/test_torch_cfl.py::test_setup_weights_and_mask_bit_equal`);
  * `CFLState` and `epoch_gradient`: the reference's state carried across
    (`repro_torch.interop.cfl_state`) and `epoch_gradient` epoch by epoch
    against the reference's (`tests/test_torch_legacy.py`);
  * `ClientParity`, the type `encode_client` returns, with it here.

Bounds: float32 expressions of the same function in another framework,
rtol 1e-5 / atol 1e-6 * max(1, max|ref|) (the SSD step and the
attention core, whose sums run longer, rtol 1e-4 / atol 1e-4 *
max(1, max|ref|), as `tests/test_torch_ssd.py` and
`tests/test_torch_flash_attn.py` hold them); the NumPy delay model and
the generators as `tests/test_torch_prng.py` holds them (Rademacher
entries bit-equal, normal ones within rtol 1e-6 / atol 1e-7).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as j_core
import repro_torch.core as t_core
from repro.kernels.coded_grad import ops as j_cg_ops
from repro.kernels.encode import ops as j_enc_ops
from repro.kernels.encode import ref as j_enc_ref
from repro.kernels.flash_attn import ops as j_fa_ops
from repro.kernels.ssd import ops as j_ssd_ops
from repro_torch.kernels.coded_grad import ops as t_cg_ops
from repro_torch.kernels.encode import ops as t_enc_ops
from repro_torch.kernels.encode import prng
from repro_torch.kernels.encode import ref as t_enc_ref
from repro_torch.kernels.flash_attn import ops as t_fa_ops
from repro_torch.kernels.ssd import ops as t_ssd_ops


def _close(got, want, rtol=1e-5, atol=1e-6):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_core_exports_the_references_names():
    """The same 22 names as `repro.core`, each the object its submodule
    defines."""
    assert sorted(t_core.__all__) == sorted(j_core.__all__)
    for name in t_core.__all__:
        got = getattr(t_core, name)
        module = sys.modules[f"repro_torch.core.{t_core._SOURCES[name]}"]
        assert got is getattr(module, name), name
    assert set(t_core.__all__) <= set(dir(t_core))
    with pytest.raises(AttributeError, match="no attribute"):
        t_core.not_a_name  # noqa: B018


def test_importing_core_imports_no_submodule():
    """In a fresh process: `import repro_torch.core` loads none of its
    submodules; `from repro_torch.core import nmse` loads only its own."""
    code = ("import sys; import repro_torch.core; "
            "before = sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.core.')); "
            "from repro_torch.core import nmse; "
            "after = sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.core.')); "
            "print(before, after)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[] ['repro_torch.core.aggregation']"


def test_core_names_match_the_reference():
    """Package-level names against the reference's package-level names:
    the delay model and expected returns (NumPy), and the GD update, NMSE
    and deadline-masked combination (float32)."""
    rng = np.random.default_rng(31)
    n = 6
    fields = dict(a=rng.uniform(1e-3, 1e-2, n), mu=rng.uniform(50, 200, n),
                  tau=rng.uniform(1e-3, 1e-2, n), p=rng.uniform(0, 0.2, n))
    tp = t_core.DeviceDelayParams(**fields)
    jp = j_core.DeviceDelayParams(**fields)
    ell = rng.integers(0, 300, n)
    for t in (0.5, 2.0, 10.0):
        np.testing.assert_allclose(t_core.compute_cdf(tp, ell, t),
                                   j_core.compute_cdf(jp, ell, t),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(t_core.expected_return(tp, ell, t),
                                   j_core.expected_return(jp, ell, t),
                                   rtol=1e-12, atol=1e-12)
    beta, grad, true = (_f32(rng, 50) for _ in range(3))
    _close(t_core.gd_update(torch.from_numpy(beta), torch.from_numpy(grad),
                            torch.tensor(0.3), 200),
           j_core.gd_update(jnp.asarray(beta), jnp.asarray(grad), 0.3, 200))
    _close(t_core.nmse(torch.from_numpy(beta), torch.from_numpy(true)),
           j_core.nmse(jnp.asarray(beta), jnp.asarray(true)))
    partial = _f32(rng, n, 50)
    received = (rng.random(n) < 0.6).astype(np.float32)
    g_par = _f32(rng, 50)
    for parity_received in (0.0, 1.0):
        _close(t_core.combine(torch.from_numpy(partial),
                              torch.from_numpy(received),
                              torch.from_numpy(g_par),
                              torch.tensor(parity_received)),
               j_core.combine(jnp.asarray(partial), jnp.asarray(received),
                              jnp.asarray(g_par),
                              jnp.float32(parity_received)))


def _core_call(name, rng):
    """(port's, reference's) result of the package-level `name` on one set
    of NumPy inputs, and the bound: "equal" (NumPy on both sides) or
    float32 (rtol, atol)."""
    n, ell, d = 5, 12, 7
    fields = dict(a=rng.uniform(1e-3, 1e-2, n), mu=rng.uniform(50, 200, n),
                  tau=rng.uniform(1e-3, 1e-2, n), p=rng.uniform(0, 0.2, n))
    tp = t_core.DeviceDelayParams(**fields)
    jp = j_core.DeviceDelayParams(**fields)
    if name == "total_cdf":
        ell_ = rng.integers(0, 300, n)
        return (np.stack([t_core.total_cdf(tp, ell_, t) for t in (0.5, 3.0)]),
                np.stack([j_core.total_cdf(jp, ell_, t) for t in (0.5, 3.0)]),
                "equal")
    if name == "sample_total":
        loads = rng.integers(1, 300, n)
        return (t_core.sample_total(tp, loads, np.random.default_rng(8), 4),
                j_core.sample_total(jp, loads, np.random.default_rng(8), 4),
                "equal")
    if name == "optimal_loads":
        caps = rng.integers(1, 80, n)
        return (np.stack(t_core.optimal_loads(tp, caps, 1.0, chunk=16)),
                np.stack(j_core.optimal_loads(jp, caps, 1.0, chunk=16)),
                "equal")
    if name == "systematic_weights":
        plan = dict(loads=rng.integers(0, ell + 1, n), c=4, t_star=1.0,
                    p_return=rng.uniform(0, 1, n + 1), expected_agg=50.0,
                    loads_cap_total=n * ell)
        sizes = np.full(n, ell)
        return (np.stack(t_core.systematic_weights(
                    t_core.RedundancyPlan(**plan), sizes)),
                np.stack(j_core.systematic_weights(
                    j_core.RedundancyPlan(**plan), sizes)), "equal")
    xs, ys, beta = _f32(rng, n, ell, d), _f32(rng, n, ell), _f32(rng, d)
    t, j = (lambda a: torch.from_numpy(a)), jnp.asarray
    if name == "client_partial_gradients":
        mask = (rng.random((n, ell)) < 0.7).astype(np.float32)
        args = (xs, ys, mask, beta)
        return (t_core.client_partial_gradients(*map(t, args)),
                j_core.client_partial_gradients(*map(j, args)), (1e-5, 1e-6))
    if name == "parity_gradient":
        args = (xs[0], ys[0], beta)
        return (t_core.parity_gradient(*map(t, args), use_kernel=False),
                j_core.parity_gradient(*map(j, args), use_kernel=False),
                (1e-5, 1e-6))
    if name == "uncoded_full_gradient":
        args = (xs, ys, beta)
        return (t_core.uncoded_full_gradient(*map(t, args)),
                j_core.uncoded_full_gradient(*map(j, args)), (1e-5, 1e-6))
    assert name == "encode_client"
    args = (_f32(rng, 4, ell), _f32(rng, ell), xs[0], ys[0])
    got = t_core.encode_client(*map(t, args))
    want = j_core.encode_client(*map(j, args))
    assert isinstance(got, t_core.ClientParity)
    return (torch.cat([got.x_parity, got.y_parity[:, None]], 1),
            jnp.concatenate([want.x_parity, want.y_parity[:, None]], 1),
            (1e-5, 1e-6))


@pytest.mark.parametrize("name", [
    "total_cdf", "sample_total", "optimal_loads", "systematic_weights",
    "client_partial_gradients", "parity_gradient", "uncoded_full_gradient",
    "encode_client"])
def test_core_name_against_the_reference(name):
    """The package-level name against `repro.core`'s on the same inputs:
    the NumPy delay model, returns and weights bit-equal (as
    `tests/test_torch_host_layer.py` holds them), the float32 gradients
    and the encode within rtol 1e-5 / atol 1e-6 * max(1, max|ref|)."""
    got, want, bound = _core_call(name, np.random.default_rng(41))
    if bound == "equal":
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    else:
        _close(got, want, *bound)


def test_lsq_gradient_reference():
    rng = np.random.default_rng(1)
    a, y, beta = _f32(rng, 70, 13), _f32(rng, 70), _f32(rng, 13)
    _close(t_cg_ops.reference(*map(torch.from_numpy, (a, y, beta))),
           j_cg_ops.reference(*map(jnp.asarray, (a, y, beta))))


def test_encode_references():
    """`reference` (P = G diag(w) X) and `reference_fleet` (the composite
    from an explicit generator stack), the latter also as
    `kernels.encode.ref.encode_fleet`."""
    rng = np.random.default_rng(2)
    g, w, x = _f32(rng, 9, 17), _f32(rng, 17), _f32(rng, 17, 5)
    _close(t_enc_ops.reference(*map(torch.from_numpy, (g, w, x))),
           j_enc_ops.reference(*map(jnp.asarray, (g, w, x))))
    gs, ws = _f32(rng, 4, 9, 17), _f32(rng, 4, 17)
    xs, ys = _f32(rng, 4, 17, 5), _f32(rng, 4, 17)
    want = j_enc_ref.encode_fleet(*map(jnp.asarray, (gs, ws, xs, ys)))
    assert t_enc_ops.reference_fleet is t_enc_ref.encode_fleet
    got = t_enc_ops.reference_fleet(*map(torch.from_numpy, (gs, ws, xs, ys)))
    assert j_enc_ops.reference_fleet is j_enc_ref.encode_fleet
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("kind", ["normal", "bernoulli"])
def test_generator_values_reference(kind):
    key = np.asarray(jax.random.PRNGKey(5))
    want = np.asarray(j_enc_ops.generator_values(jnp.asarray(key), 33, 20,
                                                 kind))
    got = t_enc_ops.generator_values(key, 33, 20, kind).numpy()
    assert t_enc_ops.generator_values is prng.generator_values
    if kind == "bernoulli":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_flash_attn_reference():
    """37 rows, one query head a key/value head (the reference's oracle
    takes equal head counts), and two: the port's grouped call against the
    reference's on K and V repeated."""
    rng = np.random.default_rng(3)
    q, k, v = (_f32(rng, 2, 4, 37, 16) for _ in range(3))
    _close(t_fa_ops.reference(*map(torch.from_numpy, (q, k, v))),
           j_fa_ops.reference(*map(jnp.asarray, (q, k, v))),
           rtol=1e-4, atol=1e-4)
    k2, v2 = k[:, ::2], v[:, ::2]
    _close(t_fa_ops.reference(*map(torch.from_numpy, (q, k2, v2))),
           j_fa_ops.reference(jnp.asarray(q),
                              *(jnp.repeat(jnp.asarray(t), 2, axis=1)
                                for t in (k2, v2))),
           rtol=1e-4, atol=1e-4)


def test_ssd_reference():
    rng = np.random.default_rng(4)
    B, nc, Q, H, P, N = 1, 2, 16, 2, 8, 4
    xc = _f32(rng, B, nc, Q, H, P)
    dtc = np.log1p(np.exp(_f32(rng, B, nc, Q, H))).astype(np.float32)
    da = (-0.1 * np.abs(_f32(rng, B, nc, Q, H))).astype(np.float32)
    bc, cc = _f32(rng, B, nc, Q, H, N), _f32(rng, B, nc, Q, H, N)
    ops = (xc, dtc, da, bc, cc)
    got = t_ssd_ops.reference(*map(torch.from_numpy, ops))
    want = j_ssd_ops.reference(*map(jnp.asarray, ops))
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-4, atol=1e-4)
