"""CodedFedL: coded federated learning for non-linear regression and
classification in multi-access edge computing (counterpart of
`repro/schemes/codedfedl.py`; arXiv:2007.03273 on the source paper's
substrate).

Two ideas ride on the CFL machinery:

  1. **Kernel embedding.**  Each client pushes its raw inputs through a
     shared random-Fourier-feature map (`repro_torch.data.rff_map`) and
     runs least squares in the `d_feat`-wide feature space, so the parity
     construction, the Eq.-17 weights and the deadline-t* epochs apply
     unchanged: the encode (kernel 2), the fused round gradient (kernel
     1) and, under `HierarchicalCFL`, the tiered one (kernel 5) run on the
     (m, d_feat) feature matrix.  `d_feat=None` skips the map and the
     strategy is `CodedFL` bit for bit (the same plan, encoding draws and
     arrival stream).
  2. **MEC delay model.**  Uploads cross a multi-access edge network: the
     communication leg is a shifted exponential (shift `2 tau`, rate
     `(1-p)/(2 tau p)`) instead of a retransmission mixture.  The load
     allocation solves on the port's grid planner with
     `PlanRequest.mec_comm=True`, the Eq.-17 weights read the same
     probabilities (`core.delay_model.mec_total_cdf`), and epochs sample
     from `sample_total_mec`.

The classification recipe: labels from `data.classification_dataset`,
±1 targets from `data.one_vs_rest_targets`, and `TrainData.beta_true` a
feature-space reference head, so the NMSE trace measures distance to
the kernel regressor (the model has `d_feat` dimensions while `data.xs`
keeps the raw width `d`).

The feature map's seed.  The port's keys are int seeds: `key` seeds the
generator that draws the clients' G_i (as in `CodedFL`), and the map
draws its W from a generator of its own, seeded by `rff_key`, or when
that is omitted by `rff_seed(key)`: the first uint64 word of
`np.random.SeedSequence([key mod 2**64, 0x52FF])`.  0x52FF is the
reference's fold-in tweak (`_RFF_FOLD`), which derives its map key as
`jax.random.fold_in(key, 0x52FF)`; the two derivations give different
numbers, so parity tests hand the reference's features across.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, ClassVar, Dict, Hashable, Optional

import numpy as np
import torch

from repro_torch.api.strategy import CodedFL, TrainData
from repro_torch.core import aggregation, cfl
from repro_torch.core.delay_model import sample_total, sample_total_mec
from repro_torch.core.redundancy import RedundancyPlan
from repro_torch.data.rff import rff_map
from repro_torch.plan import PlanRequest, solve_redundancy_batched

from .base import CodedSchemeState

if TYPE_CHECKING:
    from repro_torch.sim.network import FleetSpec

# the reference's fold-in tweak for the feature-map key, here the second
# entropy word of the seed derivation (see the module docstring)
_RFF_FOLD = 0x52FF


def rff_seed(key: int) -> int:
    """The feature map's seed derived from the strategy's int `key`."""
    seq = np.random.SeedSequence([int(key) % 2**64, _RFF_FOLD])
    return int(seq.generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class CodedFedLState(CodedSchemeState):
    """`CodedSchemeState` + the client-resident feature tensor.

    features: (n, ell, d_feat) RFF embeddings (`data.xs` itself when the
    map is the identity) — the matrices the epochs train on.
    """

    features: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CodedFedL:
    """CodedFedL (arXiv:2007.03273): RFF kernel regression + MEC delays.

    key:        int seed of the `torch.Generator` (on the data's device)
                that draws the clients' private generator matrices
    d_feat:     random-Fourier-feature width (even, >= 2); None = identity
                map, which is `CodedFL` bit for bit
    rff_key:    int seed of the shared feature map's generator (on the
                data's device); None derives it from `key` (`rff_seed`)
    rff_gamma:  Gaussian-kernel bandwidth of the feature map
    mec_comm:   use the MEC shifted-exponential communication model for
                the load solve and epoch sampling; None = `d_feat` set
    fixed_c / c_up / include_upload_delay / server_always_returns /
    use_kernel / generator / redundancy_plan / grad_path: as in `CodedFL`
    """

    key: int
    d_feat: Optional[int] = None
    rff_key: Optional[int] = None
    rff_gamma: float = 1.0
    mec_comm: Optional[bool] = None
    fixed_c: Optional[int] = None
    c_up: Optional[int] = None
    include_upload_delay: bool = True
    server_always_returns: bool = False
    use_kernel: bool = False
    generator: str = "normal"
    label: str = "cfedl"
    redundancy_plan: Optional[RedundancyPlan] = None
    grad_path: str = aggregation.FUSED

    # knobs that only shape the plan, the host-side sampling or operand
    # VALUES (rff_gamma and the seeds move feature values, never shapes);
    # d_feat stays keyed — it sets the operand widths
    engine_value_fields: ClassVar[frozenset] = frozenset(
        {"key", "rff_key", "fixed_c", "c_up", "include_upload_delay",
         "server_always_returns", "generator", "mec_comm", "rff_gamma"})
    # y and the row ids are pure functions of the TrainData; x is NOT — it
    # depends on the lane's feature map — so each lane keeps its own
    data_device_keys: ClassVar[frozenset] = frozenset({"y", "row_client"})

    def __post_init__(self):
        if self.d_feat is not None and (self.d_feat < 2 or self.d_feat % 2):
            raise ValueError(
                f"d_feat must be an even integer >= 2, got {self.d_feat}")

    def _grad_path(self) -> str:
        return aggregation.resolve_grad_path(self.grad_path,
                                             self.use_kernel)

    # -- feature map --------------------------------------------------------

    def _mec(self) -> bool:
        if self.mec_comm is None:
            return self.d_feat is not None
        return bool(self.mec_comm)

    def _feature_seed(self) -> int:
        return int(self.rff_key) if self.rff_key is not None \
            else rff_seed(self.key)

    def features(self, data: TrainData) -> torch.Tensor:
        """The (n, ell, d_feat) training matrices: RFF embeddings of the
        raw inputs, or `data.xs` itself for the identity map."""
        if self.d_feat is None:
            return data.xs
        return rff_map(data.xs, self.d_feat, self._feature_seed(),
                       gamma=self.rff_gamma)

    # -- planning -----------------------------------------------------------

    def plan_request(self, fleet: "FleetSpec",
                     data: TrainData) -> PlanRequest:
        """The (MEC) redundancy problem `plan` would solve."""
        return PlanRequest(edge=fleet.edge, server=fleet.server,
                           data_sizes=np.full(data.n, data.ell,
                                              dtype=np.int64),
                           c_up=self.c_up, fixed_c=self.fixed_c,
                           mec_comm=self._mec())

    def plan_with(self, fleet: "FleetSpec", data: TrainData,
                  plan: Optional[RedundancyPlan]) -> CodedFedLState:
        """Map the features, solve (unless `plan` is given) on the data's
        device, then the Eq.-17 encode of the feature matrices."""
        phi = self.features(data)
        if plan is None:
            plan = solve_redundancy_batched(
                [self.plan_request(fleet, data)], device=data.device)[0]
        st = cfl.setup(self.key, phi, data.ys, fleet.edge, fleet.server,
                       fixed_c=self.fixed_c, c_up=self.c_up,
                       generator=self.generator, use_kernel=self.use_kernel,
                       plan=plan)
        return CodedFedLState(plan=st.plan, load_mask=st.load_mask,
                              x_parity=st.x_parity, y_parity=st.y_parity,
                              edge=fleet.edge, server=fleet.server,
                              features=phi)

    def plan(self, fleet: "FleetSpec", data: TrainData) -> CodedFedLState:
        return self.plan_with(fleet, data, self.redundancy_plan)

    # -- epoch sampling -----------------------------------------------------

    def _sampler(self):
        """The MEC sampler when `mec_comm` holds, else the base one."""
        return sample_total_mec if self._mec() else sample_total

    # CodedFL's epoch sampling through `_sampler`: the parity upload
    # first, then per epoch the edge draws and (c > 0) the server's
    sample_epochs = CodedFL.sample_epochs

    # -- epoch hooks --------------------------------------------------------

    def device_state(self, state: CodedFedLState,
                     data: TrainData) -> Dict[str, torch.Tensor]:
        """`CodedFL`'s operands over the (m, d_feat) feature matrix."""
        x = state.features.reshape(data.m, int(state.features.shape[-1]))
        if self._grad_path() == aggregation.FUSED:
            return cfl.fused_coded_device_state(state, data, x=x)
        dev = cfl.coded_device_state(state, data)
        dev["x"] = x
        return dev

    # the epoch's gradient is CodedFL's over the feature operands: the
    # packed systematic rows through kernel 1 (kernel 5 under tiers) and
    # the Gram-folded parity on the fused path, the two-pass expressions
    # on the reference path
    round_contributions = CodedFL.round_contributions
    tiered_contributions = CodedFL.tiered_contributions

    def uplink_bits(self, state: CodedFedLState, fleet: "FleetSpec",
                    epochs: int) -> float:
        # parity shards are (c, d_feat + 1): encoding happens in feature
        # space, so the one-time upload is priced at the feature width
        return cfl.coded_uplink_bits(state, fleet, epochs)

    def engine_key(self, state: CodedFedLState) -> Hashable:
        return (state.c > 0, self.use_kernel, self.d_feat,
                self._grad_path())

    def sweep_inputs(self, state: CodedFedLState, fleet: "FleetSpec",
                     epochs: int, rng: np.random.Generator) -> EpochSchedule:
        """One sweep lane's inputs: `received (epochs, n)` and
        `parity_ok (epochs,)`; draws are exactly `sample_epochs`."""
        return self.sample_epochs(state, fleet, epochs, rng)

    def serve_convergence(self, state: CodedFedLState, criterion):
        """Kernel-regression NMSE plateaus at the RFF approximation floor
        rather than reaching an absolute target, so a served lane with no
        plateau clause would spend its whole epoch budget: arm a tight
        relative-plateau exit when the user left it off."""
        if self.d_feat is None or criterion.rel_delta is not None:
            return criterion
        return dataclasses.replace(criterion, rel_delta=1e-4)

    def report_extras(self, state: CodedFedLState) -> Dict[str, float]:
        return {"d_feat": float(self.d_feat or 0),
                "rff_gamma": float(self.rff_gamma),
                "mec_comm": float(self._mec()),
                "t_star": float(state.plan.t_star)}
