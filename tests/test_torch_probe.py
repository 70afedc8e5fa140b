"""`python -m repro_torch.coded_head_probe` at reduced width on the CPU,
against the reference example `examples/coded_head_probe.py`.

Both packages get the same inputs: the reduced granite-8b's JAX
`init_params(PRNGKey(0))` carried across by `interop.lm_params`, and the
tokens, true head and label noise drawn with NumPy.  The features (the
example's `feats_one`: `_embed`, `_run_backbone`, the mean over the
sequence, mapped over the clients) are held to the reference's within
rtol 1e-4 / atol 1e-4 * max|ref| (`tests/test_torch_lm_serve.py`'s
bound), and so are the features the entry point normalises.  The heads
go through the reference's `train_coded_head` with the harness of
`tests/test_torch_coded_head.py` (its planner and `Session.run` fail on
this JAX, ROADMAP R1 and R2: the oracle plan and the jitted epoch step
stand in, and the port's CodedFL takes the reference's planned state):
times identical and NMSE within rtol 1e-4, epoch by epoch, at the
example's 300 epochs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fed.coded_head as j_coded_head
from repro.configs import get_config as j_get_config
from repro.models import transformer as JT
from repro.plan.reference import solve_redundancy_reference
from repro.sim.network import paper_fleet as j_paper_fleet
from repro_torch import coded_head_probe as probe
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.fed import coded_head, extract_features
from test_torch_coded_head import _crossed_strategies, _EpochStepSession
from test_torch_slice import _assert_same_run

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def probe_inputs():
    """(JAX config, JAX params, port params, tokens, beta, noise, the
    example's features before and after its normalisation)."""
    jcfg = j_get_config(probe.ARCH).reduced()
    jparams = jax.tree.map(np.asarray,
                           JT.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (probe.N_CLIENTS, probe.ELL,
                                        probe.SEQ))
    beta = rng.standard_normal(jcfg.d_model).astype(np.float32)
    noise = rng.standard_normal((probe.N_CLIENTS, probe.ELL)).astype(
        np.float32)
    jparams = jax.tree.map(jnp.asarray, jparams)
    return (jcfg, jparams, interop.lm_params(jparams, CPU), toks, beta,
            noise, _reference_features(jcfg, jparams, toks))


def _reference_features(jcfg, jparams, toks):
    """The example's features, before and after its normalisation."""
    seq = toks.shape[-1]

    def feats_one(client_toks):
        x = JT._embed(jcfg, jparams, client_toks, jnp.float32)
        positions = jnp.broadcast_to(jnp.arange(seq)[None, :],
                                     (client_toks.shape[0], seq))
        x, _ = JT._run_backbone(jcfg, jparams, x, positions, {})
        return jnp.mean(x, axis=1)

    feats = jax.jit(jax.vmap(feats_one))(jnp.asarray(toks, jnp.int32))
    return feats, feats / (jnp.std(feats) + 1e-6)


def _close(got, want, rtol=1e-4):
    want = np.asarray(want, np.float64)
    got = got.double().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def test_extract_features_batched_applies_the_backbone_to_every_row():
    """batched=True calls a row-wise backbone once on all n * ell rows,
    and each client's features equal its own call's within float32
    rounding."""
    w = torch.tensor(np.random.default_rng(0).standard_normal((4, 3)),
                     dtype=torch.float32)
    calls = []

    def backbone(x):
        calls.append(tuple(x.shape))
        return torch.tanh(x @ w)

    xs = torch.tensor(np.random.default_rng(1).standard_normal((5, 7, 4)),
                      dtype=torch.float32)
    f = extract_features(backbone, xs, batched=True)
    assert calls == [(35, 4)] and f.shape == (5, 7, 3)
    for i in range(5):
        torch.testing.assert_close(f[i], torch.tanh(xs[i] @ w), rtol=1e-6,
                                   atol=1e-7)


def test_probe_features_match_the_example(probe_inputs):
    _, _, params, toks, _, _, (want, want_n) = probe_inputs
    cfg = get_config(probe.ARCH).reduced()
    got = probe.probe_features(cfg, params, torch.as_tensor(toks))
    assert got.shape == (probe.N_CLIENTS, probe.ELL, cfg.d_model)
    assert not got.requires_grad
    _close(got, want)
    _close(probe.normalise(got), want_n)


def test_probe_heads_match_the_example(probe_inputs, monkeypatch):
    """The entry point's heads against the example's, epoch by epoch."""
    _, _, params, toks, beta, noise, (_, feats) = probe_inputs
    ys = jnp.einsum("nld,d->nl", feats, jnp.asarray(beta)) \
        + probe.NOISE * jnp.asarray(noise)
    n, ell, d = feats.shape
    jf = j_paper_fleet(0.2, 0.2, seed=0, n=n, d=d)
    c = int(0.3 * n * ell)
    plan = solve_redundancy_reference(jf.edge, jf.server, np.full(n, ell),
                                      fixed_c=c)
    _EpochStepSession.runs.clear()
    monkeypatch.setattr(j_coded_head, "Session", _EpochStepSession)
    monkeypatch.setattr(j_coded_head, "CodedFL", functools.partial(
        j_coded_head.CodedFL, redundancy_plan=plan))
    want = j_coded_head.train_coded_head(
        jf, None, feats, ys, jnp.asarray(beta), lr=probe.LR,
        epochs=probe.EPOCHS, key=jax.random.PRNGKey(probe.KEY_SEED),
        rng=np.random.default_rng(0), fixed_c=c)

    crossed_cfl, _ = _crossed_strategies()
    monkeypatch.setattr(coded_head, "CodedFL", crossed_cfl)
    out = probe.run(reduced=True, device="cpu", params=params,
                    tokens=torch.as_tensor(toks),
                    beta_true=torch.as_tensor(beta),
                    noise=torch.as_tensor(noise))
    _close(out["feats"], feats)
    _close(out["ys"], ys)
    got = out["reports"]
    assert sorted(got) == sorted(want) == ["cfl", "uncoded"]
    for arm in want:
        _assert_same_run(got[arm], want[arm])
        assert got[arm].setup_time == want[arm].setup_time
    assert got["cfl"].final_nmse() < got["cfl"].nmse[0]
    assert out["target"] == 5 * got["uncoded"].final_nmse()
    assert np.isfinite(out["gain"]) and out["gain"] > 1.0


def test_probe_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.run(reduced=True, epochs=1)


def test_gain_target_is_the_examples_unless_met_at_the_start():
    """Five times the uncoded head's final NMSE where that lies below its
    first NMSE (the example's target), else the midpoint of the two (an
    underdetermined head, where both arms would meet the example's
    target at t = 0)."""
    from repro_torch.api.report import TraceReport

    def report(nmse):
        nmse = np.asarray(nmse)
        return TraceReport(times=np.arange(len(nmse), dtype=float),
                           nmse=nmse, epoch_durations=np.ones(len(nmse) - 1),
                           label="uncoded", setup_time=0.0,
                           uplink_bits_total=0.0)

    assert probe.gain_target(report([1.0, 0.5, 0.1])) == 0.5
    assert probe.gain_target(report([1.0, 0.9, 0.8])) == 0.9
