"""The port's strategy registry (`repro_torch.api.make_strategy`), the
cases of `tests/test_registry.py`, and `uplink_bits` of all six
strategies against the reference's, on the CPU.

The port's keys are int seeds of a `torch.Generator`, so `key_seed=`
becomes `key=int(key_seed)` where the reference builds a PRNGKey.

The reference's strategies plan with its NumPy oracles (its batched
planner fails on this JAX, ROADMAP "Reference state" R1); uplink bits
are equal as floats (the same float64 expressions).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as j_api
from repro.plan.reference import solve_redundancy_reference
from repro.core.delay_model import mec_total_cdf as j_mec_total_cdf
from repro.plan.reference_schemes import (solve_codedfedl_reference,
                                          solve_lowlatency_reference,
                                          solve_stochastic_reference)
from repro.sim.network import wireless_fleet as j_wireless_fleet
from repro_torch import interop
from repro_torch.api import (CodedFL, GradientCodingFL, UncodedFL,
                             available_strategies, make_strategy,
                             register_strategy)
from repro_torch.fleet import FleetTopology, HierarchicalCFL
from repro_torch.schemes import CodedFedL, LowLatencyCFL, StochasticCodedFL
from repro_torch.sim.network import wireless_fleet
from test_torch_schemes import port_plan

N, ELL, D = 12, 40, 30


def test_builtin_names_construct_the_right_classes():
    assert isinstance(make_strategy("uncoded"), UncodedFL)
    assert isinstance(make_strategy("cfl", key_seed=1, fixed_c=10), CodedFL)
    assert isinstance(make_strategy("gradcode", r=2), GradientCodingFL)
    assert isinstance(make_strategy("stochastic", key_seed=1),
                      StochasticCodedFL)
    assert isinstance(make_strategy("lowlatency", key_seed=1), LowLatencyCFL)
    topo = FleetTopology.uniform(4, 2)
    hier = make_strategy("hierarchical", base=make_strategy("uncoded"),
                         topology=topo)
    assert isinstance(hier, HierarchicalCFL) and hier.topology is topo


@pytest.mark.parametrize("alias,cls", [("scfl", StochasticCodedFL),
                                       ("lowlat", LowLatencyCFL)])
def test_aliases_resolve(alias, cls):
    assert isinstance(make_strategy(alias, key_seed=1), cls)


@pytest.mark.parametrize("alias", ["hier", "fleet"])
def test_hierarchical_aliases_resolve(alias):
    s = make_strategy(alias, base=make_strategy("gradcode", r=2),
                      topology=FleetTopology.uniform(4, 2))
    assert isinstance(s, HierarchicalCFL) and s.label == "hier[gradcode]"


@pytest.mark.parametrize("name", ["codedfedl", "cfedl"])
def test_codedfedl_is_refused_naming_its_roadmap_item(name):
    """CodedFedL is ported (ROADMAP §1 item 4): both names construct from
    key_seed=, with the key as an int seed, and need a key.  The name is
    the one this test had while it asserted the refusal; it is kept so
    that the test's record stays traceable."""
    s = make_strategy(name, key_seed=1, d_feat=16)
    assert isinstance(s, CodedFedL) and s.d_feat == 16
    assert s.key == 1 and isinstance(s.key, int) and s.label == "cfedl"
    assert s == make_strategy(name, key=1, d_feat=16)
    with pytest.raises(ValueError, match="PRNG key"):
        make_strategy(name, d_feat=16)
    assert "codedfedl" in available_strategies()


def test_kwargs_pass_through():
    s = make_strategy("stochastic", key_seed=3, fixed_c=42,
                      noise_multiplier=0.25, sample_frac=0.5)
    assert s.fixed_c == 42 and s.noise_multiplier == 0.25
    assert s.sample_frac == 0.5
    ll = make_strategy("lowlatency", key_seed=3, chunks=16)
    assert ll.chunks == 16
    g = make_strategy("gradcode", r=3, grad_path="reference")
    assert g.r == 3 and g.grad_path == "reference"


def test_key_seed_equals_explicit_key():
    a = make_strategy("cfl", key_seed=9, fixed_c=5)
    b = make_strategy("cfl", key=9, fixed_c=5)
    assert a == b and a.key == 9 and isinstance(a.key, int)


def test_missing_key_raises_instead_of_silent_default():
    """Key-carrying strategies must not silently share a default key."""
    with pytest.raises(ValueError, match="PRNG key"):
        make_strategy("cfl", fixed_c=10)
    with pytest.raises(ValueError, match="PRNG key"):
        make_strategy("stochastic")
    with pytest.raises(ValueError, match="PRNG key"):
        make_strategy("lowlatency")


def test_key_seed_rejected_for_keyless_and_double_key():
    with pytest.raises(ValueError, match="key_seed"):
        make_strategy("uncoded", key_seed=1)
    with pytest.raises(ValueError, match="key_seed"):
        make_strategy("gradcode", r=2, key_seed=1)
    with pytest.raises(ValueError, match="key_seed"):
        make_strategy("cfl", key=0, key_seed=1, fixed_c=5)


def test_unknown_name_lists_available():
    with pytest.raises(ValueError, match="unknown strategy"):
        make_strategy("nope")
    names = available_strategies()
    for expected in ("uncoded", "cfl", "gradcode", "stochastic",
                     "lowlatency", "hierarchical"):
        assert expected in names
    assert names == tuple(sorted(names))


def test_register_custom_strategy():
    class MyScheme:
        label = "mine"

        def __init__(self, knob=1):
            self.knob = knob

    register_strategy("myscheme_torch", MyScheme)
    s = make_strategy("myscheme_torch", knob=7)
    assert isinstance(s, MyScheme) and s.knob == 7
    assert "myscheme_torch" in available_strategies()

    @register_strategy("myscheme_torch_deco")
    @dataclasses.dataclass(frozen=True)
    class Keyed:
        key: int
        label: str = "keyed"

    assert make_strategy("myscheme_torch_deco", key_seed=4).key == 4


def test_register_rejects_builtin_names_and_aliases():
    """Built-ins and their aliases cannot be shadowed by user schemes."""
    for name in ("cfl", "scfl", "codedfedl", "cfedl", "hier"):
        with pytest.raises(ValueError, match="built-in"):
            register_strategy(name, object)


# ---------------------------------------------------------------------------
# uplink_bits of the six strategies against the reference
# ---------------------------------------------------------------------------

def _pairs():
    """(label, jax strategy, jax state, port strategy, port state) for the
    five strategies of `tests/test_uplink_properties.py` and CodedFedL
    (at d_feat 16, its MEC oracle plan's p_return from mec_total_cdf)."""
    jf = j_wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, n=N, d=D)
    tf = wireless_fleet(0.2, 0.2, nu_erasure=0.3, seed=0, n=N, d=D)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((N, ELL, D)).astype(np.float32)
    beta = rng.standard_normal(D).astype(np.float32)
    ys = (xs @ beta).astype(np.float32)
    jdata = j_api.TrainData(jnp.asarray(xs), jnp.asarray(ys),
                            jnp.asarray(beta))
    tdata = interop.train_data(xs, ys, beta, device="cpu")
    sizes = np.full(N, ELL)
    c = int(0.25 * N * ELL)
    plans = {
        "cfl": solve_redundancy_reference(jf.edge, jf.server, sizes,
                                          fixed_c=c),
        "scfl": solve_stochastic_reference(jf.edge, jf.server, sizes,
                                           srv_weight=0.8 / 1.25,
                                           fixed_c=c),
        "lowlat": solve_lowlatency_reference(jf.edge, jf.server, sizes, 4,
                                             fixed_c=c),
        "cfedl": solve_codedfedl_reference(jf.edge, jf.server, sizes,
                                           fixed_c=c),
    }
    mec = plans["cfedl"]
    plans["cfedl"] = dataclasses.replace(mec, p_return=np.append(
        j_mec_total_cdf(jf.edge, mec.loads, mec.t_star), mec.p_return[-1]))
    kws = {"uncoded": {}, "gradcode": {"r": 3},
           "cfl": {"key_seed": 3, "fixed_c": c},
           "scfl": {"key_seed": 3, "fixed_c": c, "noise_multiplier": 0.5,
                    "sample_frac": 0.8},
           "lowlat": {"key_seed": 3, "fixed_c": c, "chunks": 4},
           "cfedl": {"key_seed": 3, "fixed_c": c, "d_feat": 16,
                     "rff_gamma": 0.05}}
    names = {"uncoded": "uncoded", "gradcode": "gradcode", "cfl": "cfl",
             "scfl": "stochastic", "lowlat": "lowlatency",
             "cfedl": "codedfedl"}
    out = []
    for label, kw in kws.items():
        j_s = j_api.make_strategy(names[label], **kw)
        t_s = make_strategy(names[label], **kw)
        if label in plans:
            jstate = j_s.plan_with(jf, jdata, plans[label])
            tstate = t_s.plan_with(tf, tdata, port_plan(plans[label]))
        else:
            jstate, tstate = j_s.plan(jf, jdata), t_s.plan(tf, tdata)
        out.append((label, j_s, jstate, t_s, tstate))
    return jf, tf, out


def test_uplink_bits_of_all_five_strategies_equal_the_reference():
    """`uplink_bits` of all six strategies, CodedFedL with them, equal to
    the reference's at 0, 1, 7 and 200 epochs.  The name is the one this
    test had before CodedFedL was ported; it is kept so that the test's
    record stays traceable."""
    jf, tf, pairs = _pairs()
    assert [p[0] for p in pairs] == ["uncoded", "gradcode", "cfl", "scfl",
                                     "lowlat", "cfedl"]
    for label, j_s, jstate, t_s, tstate in pairs:
        assert t_s.label == j_s.label == label
        for epochs in (0, 1, 7, 200):
            assert t_s.uplink_bits(tstate, tf, epochs) == \
                j_s.uplink_bits(jstate, jf, epochs), (label, epochs)
        # a one-time term exactly when the schedule reports set-up time
        sched = t_s.sample_epochs(tstate, tf, 2, np.random.default_rng(0))
        assert (t_s.uplink_bits(tstate, tf, 0) > 0) == \
            (sched.setup_time > 0), label
        if label in ("cfl", "scfl", "lowlat", "cfedl"):
            assert t_s.uplink_bits(tstate, tf, 0) == \
                float(np.sum(tstate.parity_upload_bits()))
