"""Heterogeneous fleet generation with the paper's §IV constants.

NumPy copy of `repro/sim/network.py` (`FleetSpec`, `make_fleet`,
`paper_fleet`, `mega_fleet`, `wireless_fleet`), bit-for-bit on the same
seeds.

n = 24 edge devices + 1 server.  Heterogeneity factors nu_comp, nu_link in
[0, 1) generate geometric ladders of MAC rates and link throughputs that are
randomly assigned to devices:

    MACR_i = (1 - nu_comp)^i * 1536 KMAC/s,      i = 0..23
    LINK_i = (1 - nu_link)^i * 216  kbit/s,      i = 0..23

Each training point costs d MACs => a_i = d / MACR_i seconds; memory access
overhead is 50% of the MAC time per point => mu_i = 2 / a_i points/sec.
The server's MAC rate is 10x the *fastest* edge device and it has no
communication leg.  Packets carry a d-vector of 32-bit floats + 10% header.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.delay_model import DeviceDelayParams

KMAC = 1e3  # the paper's MAC rates are given in KMAC/s


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """A generated fleet: edge + server delay params and bookkeeping."""

    edge: DeviceDelayParams
    server: DeviceDelayParams
    mac_rates: np.ndarray      # (n,) MACs/sec actually assigned
    link_rates: np.ndarray     # (n,) bits/sec actually assigned
    packet_bits: float         # uplink/downlink packet size (model/gradient)
    d: int
    nu_comp: float
    nu_link: float


def make_fleet(n: int, d: int, nu_comp: float, nu_link: float,
               rng: np.random.Generator,
               base_mac_kmacs: float = 1536.0,
               base_link_kbps: float = 216.0,
               erasure_p=0.1,
               server_speedup: float = 10.0,
               header_overhead: float = 0.10,
               bits_per_value: int = 32) -> FleetSpec:
    """Generate a fleet per §IV. `rng` drives the random ladder assignment.

    `erasure_p` may be a scalar (the paper's homogeneous wireless links) or
    an (n,) array of per-device erasure probabilities (the heterogeneous
    scenario of `wireless_fleet`).
    """
    ladder = np.arange(n)
    mac_rates = (1.0 - nu_comp) ** ladder * base_mac_kmacs * KMAC  # MAC/s
    link_rates = (1.0 - nu_link) ** ladder * base_link_kbps * 1e3  # bit/s
    mac_rates = rng.permutation(mac_rates)
    link_rates = rng.permutation(link_rates)

    a = d / mac_rates                        # sec per training point
    mu = 2.0 / a                             # 50% memory overhead => rate 2/a
    packet_bits = d * bits_per_value * (1.0 + header_overhead)
    tau = packet_bits / link_rates           # sec per packet
    p = np.broadcast_to(np.asarray(erasure_p, dtype=np.float64), (n,)).copy()

    edge = DeviceDelayParams(a=a, mu=mu, tau=tau, p=p)

    server_mac = server_speedup * mac_rates.max()
    a_s = np.array([d / server_mac])
    server = DeviceDelayParams(a=a_s, mu=2.0 / a_s, tau=np.zeros(1),
                               p=np.zeros(1))
    return FleetSpec(edge=edge, server=server, mac_rates=mac_rates,
                     link_rates=link_rates, packet_bits=packet_bits, d=d,
                     nu_comp=nu_comp, nu_link=nu_link)


def paper_fleet(nu_comp: float = 0.2, nu_link: float = 0.2,
                seed: int = 0, n: int = 24, d: int = 500) -> FleetSpec:
    """The exact §IV configuration (24 devices, d=500)."""
    return make_fleet(n=n, d=d, nu_comp=nu_comp, nu_link=nu_link,
                      rng=np.random.default_rng(seed))


def mega_fleet(n: int, d: int = 32, nu_comp: float = 0.2,
               nu_link: float = 0.2, seed: int = 0,
               ladder_period: int = 24, **kw) -> FleetSpec:
    """A fleet-scale (1e5+ clients) heterogeneous fleet.

    The §IV geometric ladders underflow long before fleet scale —
    `(1 - 0.2)^n` reaches denormal territory around n = 3000, giving
    devices with infinite epoch times.  Production fleets are better
    modelled as many devices drawn from a BOUNDED heterogeneity range, so
    the ladder exponent tiles modulo `ladder_period` (default: the
    paper's 24 rungs): every block of `ladder_period` clients spans the
    same §IV speed range, randomly assigned across the whole fleet.
    """
    rng = np.random.default_rng(seed)
    ladder = np.arange(n) % ladder_period
    mac = (1.0 - nu_comp) ** ladder
    link = (1.0 - nu_link) ** ladder
    # reuse make_fleet's §IV constants/derivations on the tiled ladders by
    # overriding its internal ladder: simplest is to inline the same math
    base_mac = kw.pop("base_mac_kmacs", 1536.0)
    base_link = kw.pop("base_link_kbps", 216.0)
    erasure_p = kw.pop("erasure_p", 0.1)
    server_speedup = kw.pop("server_speedup", 10.0)
    header_overhead = kw.pop("header_overhead", 0.10)
    bits_per_value = kw.pop("bits_per_value", 32)
    if kw:
        raise TypeError(f"unexpected arguments: {sorted(kw)}")
    mac_rates = rng.permutation(mac * base_mac * KMAC)
    link_rates = rng.permutation(link * base_link * 1e3)

    a = d / mac_rates
    mu = 2.0 / a
    packet_bits = d * bits_per_value * (1.0 + header_overhead)
    tau = packet_bits / link_rates
    p = np.broadcast_to(np.asarray(erasure_p, dtype=np.float64), (n,)).copy()
    edge = DeviceDelayParams(a=a, mu=mu, tau=tau, p=p)

    server_mac = server_speedup * mac_rates.max()
    a_s = np.array([d / server_mac])
    server = DeviceDelayParams(a=a_s, mu=2.0 / a_s, tau=np.zeros(1),
                               p=np.zeros(1))
    return FleetSpec(edge=edge, server=server, mac_rates=mac_rates,
                     link_rates=link_rates, packet_bits=packet_bits, d=d,
                     nu_comp=nu_comp, nu_link=nu_link)


def wireless_fleet(nu_comp: float = 0.2, nu_link: float = 0.2,
                   nu_erasure: float = 0.3, seed: int = 0,
                   n: int = 24, d: int = 500,
                   base_erasure_p: float = 0.3,
                   min_erasure_p: float = 0.02, **kw) -> FleetSpec:
    """Heterogeneous wireless fleet (the arXiv:2011.06223 scenario).

    On top of the §IV compute/link ladders, per-device erasure
    probabilities follow their own geometric ladder

        p_i = max((1 - nu_erasure)^i * base_erasure_p, min_erasure_p)

    randomly assigned to devices, so links differ in BOTH rate (tau_i) and
    reliability (p_i).  `nu_erasure = 0` recovers a homogeneous
    `base_erasure_p` fleet.
    """
    rng = np.random.default_rng(seed)
    ladder = (1.0 - nu_erasure) ** np.arange(n) * base_erasure_p
    p = rng.permutation(np.maximum(ladder, min_erasure_p))
    return make_fleet(n=n, d=d, nu_comp=nu_comp, nu_link=nu_link,
                      rng=rng, erasure_p=p, **kw)
