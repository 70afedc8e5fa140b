"""Carry the reference's state into the port.

The functions take the values of the JAX package (`repro`) as NumPy
arrays and plain fields and return the port's objects, so the parity
tests run both packages on identical operands: the same data, fleet,
plan, encoded (and noised) parity and topology.  Nothing of `repro` is
imported here — callers convert with `np.asarray` and pass the fields.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.strategy import GradCodingState, TrainData
from repro_torch.core.cfl import CFLState
from repro_torch.core.delay_model import DeviceDelayParams
from repro_torch.core.gradient_coding import GradCodingPlan
from repro_torch.core.redundancy import RedundancyPlan
from repro_torch.fleet.topology import FleetTopology
from repro_torch.optim.optimizers import OptState
from repro_torch.schemes.codedfedl import CodedFedLState
from repro_torch.schemes.lowlatency import LowLatencyState
from repro_torch.schemes.stochastic import StochasticState
from repro_torch.sim.network import FleetSpec


def _f32(arr, device) -> torch.Tensor:
    return torch.tensor(np.asarray(arr, dtype=np.float32), device=device)


def train_data(xs, ys, beta_true, device) -> TrainData:
    """`TrainData` from (n, ell, d) features, (n, ell) labels, (d,) truth."""
    return TrainData(xs=_f32(xs, device), ys=_f32(ys, device),
                     beta_true=_f32(beta_true, device))


def delay_params(a, mu, tau, p) -> DeviceDelayParams:
    """`DeviceDelayParams` from the four (n,) parameter arrays."""
    return DeviceDelayParams(a=np.array(a, dtype=np.float64),
                             mu=np.array(mu, dtype=np.float64),
                             tau=np.array(tau, dtype=np.float64),
                             p=np.array(p, dtype=np.float64))


def fleet_spec(edge: DeviceDelayParams, server: DeviceDelayParams,
               mac_rates, link_rates, packet_bits: float, d: int,
               nu_comp: float, nu_link: float) -> FleetSpec:
    """`FleetSpec` from its fields (edge/server built with `delay_params`)."""
    return FleetSpec(edge=edge, server=server,
                     mac_rates=np.array(mac_rates, dtype=np.float64),
                     link_rates=np.array(link_rates, dtype=np.float64),
                     packet_bits=float(packet_bits), d=int(d),
                     nu_comp=float(nu_comp), nu_link=float(nu_link))


def redundancy_plan(loads, c: int, t_star: float, p_return,
                    expected_agg: float,
                    loads_cap_total: int) -> RedundancyPlan:
    """`RedundancyPlan` from its fields."""
    return RedundancyPlan(loads=np.array(loads, dtype=np.int64), c=int(c),
                          t_star=float(t_star),
                          p_return=np.array(p_return, dtype=np.float64),
                          expected_agg=float(expected_agg),
                          loads_cap_total=int(loads_cap_total))


def cfl_state(plan: RedundancyPlan, weights, load_mask, x_parity, y_parity,
              edge: DeviceDelayParams, server: DeviceDelayParams,
              device) -> CFLState:
    """`CFLState` from the reference's (n, ell) weights and load mask and
    its (c, d) / (c,) composite parity, placed on `device`."""
    return CFLState(plan=plan, weights=_f32(weights, device),
                    load_mask=_f32(load_mask, device),
                    x_parity=_f32(x_parity, device),
                    y_parity=_f32(y_parity, device), edge=edge, server=server)


def stochastic_state(plan: RedundancyPlan, load_mask, x_parity, y_parity,
                     edge: DeviceDelayParams, server: DeviceDelayParams,
                     noise_scale_x: float, noise_scale_y: float,
                     srv_weight: float, device) -> StochasticState:
    """`StochasticState` from the reference's (n, ell) load mask, its
    noised (c, d) / (c,) composite parity and its float64 noise scales
    and server weight, placed on `device`."""
    return StochasticState(plan=plan, load_mask=_f32(load_mask, device),
                           x_parity=_f32(x_parity, device),
                           y_parity=_f32(y_parity, device), edge=edge,
                           server=server, noise_scale_x=float(noise_scale_x),
                           noise_scale_y=float(noise_scale_y),
                           srv_weight=float(srv_weight))


def gradcoding_state(r: int, groups, n_groups: int, ell: int,
                     share_bits: float, shard_time: float) -> GradCodingState:
    """`GradCodingState` from the reference's replication factor, (n,)
    group ids and its float64 sharing cost and time."""
    return GradCodingState(
        plan=GradCodingPlan(r=int(r),
                            groups=np.array(groups, dtype=np.int64)),
        n_groups=int(n_groups), ell=int(ell), share_bits=float(share_bits),
        shard_time=float(shard_time))


def lowlatency_state(plan: RedundancyPlan, load_mask, x_parity, y_parity,
                     edge: DeviceDelayParams, server: DeviceDelayParams,
                     chunk_probs, row_chunk, device) -> LowLatencyState:
    """`LowLatencyState` from the reference's (n, ell) load mask, its
    (c, d) / (c,) composite parity, its (n, Q) chunk probabilities and
    (n, ell) chunk ids, placed on `device`."""
    return LowLatencyState(plan=plan, load_mask=_f32(load_mask, device),
                           x_parity=_f32(x_parity, device),
                           y_parity=_f32(y_parity, device), edge=edge,
                           server=server,
                           chunk_probs=np.array(chunk_probs,
                                                dtype=np.float64),
                           row_chunk=np.array(row_chunk, dtype=np.int32))


def codedfedl_state(plan: RedundancyPlan, load_mask, x_parity, y_parity,
                    edge: DeviceDelayParams, server: DeviceDelayParams,
                    features, device) -> CodedFedLState:
    """`CodedFedLState` from the reference's (n, ell) load mask, its
    (c, d_feat) / (c,) composite parity and its (n, ell, d_feat)
    features, placed on `device`."""
    return CodedFedLState(plan=plan, load_mask=_f32(load_mask, device),
                          x_parity=_f32(x_parity, device),
                          y_parity=_f32(y_parity, device), edge=edge,
                          server=server, features=_f32(features, device))


def fleet_topology(tier_of, sample_frac) -> FleetTopology:
    """`FleetTopology` from the (n,) tier ids and (T,) participation."""
    return FleetTopology(tier_of=np.array(tier_of, dtype=np.int32),
                         sample_frac=np.array(sample_frac, dtype=np.float64))


def lm_params(tree, device) -> dict:
    """The LM parameter tree of `models.transformer` from the reference's
    `init_params` tree with its leaves as NumPy arrays, key for key (the
    two trees have the same keys and stacked shapes), on `device`."""
    if isinstance(tree, dict):
        return {k: lm_params(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def _leaf(arr, device) -> torch.Tensor:
    """A NumPy leaf as a tensor of its dtype; bfloat16 (`ml_dtypes`, which
    torch does not read) goes across as its 16-bit pattern."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def opt_state(state, device):
    """The optimizer state of `optim.optimizers` from the reference's
    `OptState` with its leaves as NumPy arrays: (step, mu, nu) in that
    order, mu and nu parameter trees or None, on `device`, dtypes kept
    (bfloat16 moments included)."""
    step, mu, nu = state
    return OptState(
        _leaf(np.asarray(step, dtype=np.int32), device),
        None if mu is None else lm_params(mu, device),
        None if nu is None else lm_params(nu, device))
