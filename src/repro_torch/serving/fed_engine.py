"""Always-on federated serving engine: continuous session batching with
convergence-based early exit (counterpart of
`repro/serving/fed_engine.py`).

`run_sweep` executes a STATIC list of sessions; production traffic is
sessions arriving and departing.  `FedServeEngine` is the long-lived
counterpart: training jobs are submitted at arrival times on a virtual
clock, admitted into warm, shape-bucketed **lane slots**, trained in
chunks of epochs, and harvested the epoch their convergence predicate
fires — a converged lane frees its slot for the next pending job
instead of running to the fixed epoch count.

  * **Shape buckets.**  A lane group is keyed by the sweep engine's own
    `_bucket_key` — strategy static structure + `engine_key` + operand
    shapes — so the jobs that would share one `run_sweep` engine share
    one serve group.  Each group holds `lane_width` slots; its epoch
    step comes from the process-wide engine cache under ("serve", key,
    lane_width, chunk), and the group pins its own reference, so an
    eviction never breaks an in-flight group.
  * **One epoch program.**  The step is `repro_torch.api.make_epoch_step`
    over the group's first state — the function the sweep engine runs —
    applied to each lane's own operands plus one copy of the data-only
    ones.  A served lane therefore runs the same launches on the same
    tensors as a solo `Session.run`, and its trace is bit-equal, as a
    prefix up to its exit epoch, to the solo trace.
  * **Early exit, one sync per group-epoch.**  A group advances its live
    lanes one epoch at a time, lanes in turn; each lane's predicate
    (`ConvergenceCriterion`: NMSE target or relative plateau) is
    evaluated on the device, and after the group-epoch the host reads
    the live lanes' predicates in one transfer (none while every live
    lane is below `min_epochs`).  A lane stops computing the epoch it
    converges, so the kernels launch exactly once per epoch served.  The
    epoch budget (`min(session.epochs, max_epochs)`, tightened through
    the strategy's `serve_convergence` hook — epsilon-budget exhaustion
    for `StochasticCodedFL`) is host arithmetic.  `chunk` is the
    harvest/admission granularity: a group runs up to `chunk` epochs per
    engine step, and a freed slot is noticed at the step's end, as in
    the reference.
  * **Host work at submission.**  Planning (one batched `plan_sweep`),
    epoch pre-sampling, the operand layout and the arrival tensors'
    copy to the device happen in `submit_many`, so admitting a job into
    a freed slot enqueues no host-to-device copy.
  * **The lane mesh.**  A group's slots are split evenly over its lane
    mesh (`launch.mesh.make_lane_mesh(lane_width, devices)`, every card
    of the engine's device type by default, the engine's first, as the
    reference's): each card holds one copy of the group's shared
    operands and `beta_true`, a lane admitted into one of its slots gets
    its operands and arrivals copied there (card to card; none on the
    engine's own card), and the predicates come back in one transfer per
    card a group-epoch.

The exit point lands on `TraceReport.extras["serve_exit_epoch"]` (with
`serve_converged`, `serve_uid`), and a truncated run's durations,
times, `uplink_bits_total` and, for a DP lane, `epsilon_schedule` /
`epsilon_spent` / `accounting_rounds` are those of the epochs served.

Entry points: `submit`/`submit_many` + `step`/`drain` for long-lived
use, `serve(sessions, arrivals=...)` for the admit-everything-and-drain
pattern (`python -m repro_torch.launch.fedserve` drives it).  The engine
runs on the card unless `device="cpu"` is asked for, and requires the
data and every session to live there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api import Session, TraceReport, plan_sweep
from repro_torch.api.session import (_bucket_key, _check_device,
                                     cache_engine, make_epoch_step,
                                     shared_operands)
from repro_torch.api.strategy import EpochSchedule
from repro_torch.core import aggregation
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import local_devices, make_lane_mesh
from repro_torch.launch.sharding import shard_lanes

from .scheduler import ConvergenceCriterion, FifoScheduler, ServeRequest


def _fired(hits: List[torch.Tensor]) -> np.ndarray:
    """The live lanes' predicates, read back in one transfer per
    device."""
    out = np.zeros(len(hits), dtype=bool)
    by_device: Dict[torch.device, List[int]] = {}
    for i, hit in enumerate(hits):
        by_device.setdefault(hit.device, []).append(i)
    for idxs in by_device.values():
        out[idxs] = torch.stack([hits[i] for i in idxs]).cpu().numpy()
    return out


@dataclasses.dataclass
class _Prepared:
    """A submitted request with its host-side work done: planned state,
    pre-sampled epoch schedule, device operands, the arrival tensors on
    the device, bucket key and resolved epoch budget."""

    request: ServeRequest
    state: Any
    sched: EpochSchedule
    dev: Dict[str, torch.Tensor]
    arr: Dict[str, torch.Tensor]
    key: Hashable
    criterion: ConvergenceCriterion
    budget: int


@dataclasses.dataclass
class _Lane:
    """One occupied slot: the lane's operands and arrivals on its card
    and its carry (beta, the epoch counter, the previous NMSE, the trace,
    the stop flags)."""

    prep: _Prepared
    dev: Dict[str, torch.Tensor]
    arr: Dict[str, torch.Tensor]
    lr: torch.Tensor
    nmse_target: torch.Tensor
    rel_delta: torch.Tensor
    beta: torch.Tensor
    prev: torch.Tensor
    trace: torch.Tensor
    t: int = 0
    t_hi: int = 0
    stop: bool = False
    converged: bool = False


class _LaneGroup:
    """One shape bucket's warm slots and its epoch step (shared through
    the process-wide cache, pinned here)."""

    def __init__(self, engine: "FedServeEngine", key: Hashable,
                 template: _Prepared):
        strategy = template.request.session.strategy
        shared = shared_operands(strategy, template.dev)
        mesh = make_lane_mesh(engine.lane_width, engine.devices)
        # each slot's card; the shared operands, beta_true and the t = 0
        # probe once per card
        self.cards = [card for card, lanes in shard_lanes(
            mesh, engine.lane_width) for _ in lanes]
        self.shared = {card: {k: v.to(card) for k, v in shared.items()}
                       for card in mesh}
        self.beta_true = {card: engine.data.beta_true.to(card)
                          for card in mesh}
        self.nmse0 = {card: engine._nmse0.to(card) for card in mesh}
        self.slots: List[Optional[_Lane]] = [None] * engine.lane_width
        self.step_fn = cache_engine(
            ("serve", key, engine.lane_width, engine.chunk),
            lambda: make_epoch_step(strategy, template.state,
                                    engine.data.m))

    def free_slot(self) -> Optional[int]:
        for i, occ in enumerate(self.slots):
            if occ is None:
                return i
        return None

    @property
    def running(self) -> bool:
        return any(occ is not None for occ in self.slots)

    def admit(self, engine: "FedServeEngine", prep: _Prepared,
              slot: int) -> None:
        data, dev = engine.data, self.cards[slot]
        dtype = data.xs.dtype
        crit = prep.criterion
        epochs = int(np.asarray(prep.sched.durations).shape[0])
        trace = torch.zeros(epochs + 1, dtype=dtype, device=dev)
        trace[0] = self.nmse0[dev]
        rel = -1.0 if crit.rel_delta is None else float(crit.rel_delta)

        def scalar(value):  # a fill, not a host-to-device copy
            return torch.full((), value, dtype=dtype, device=dev)

        self.slots[slot] = _Lane(
            prep=prep,
            dev={**{k: v.to(dev) for k, v in prep.dev.items()},
                 **self.shared[dev]},
            arr={k: v.to(dev) for k, v in prep.arr.items()},
            lr=scalar(prep.request.session.lr),
            nmse_target=scalar(crit.nmse_target), rel_delta=scalar(rel),
            beta=torch.zeros(data.model_dim, dtype=dtype, device=dev),
            prev=self.nmse0[dev].clone(), trace=trace)

    def step(self, engine: "FedServeEngine") -> List[_Lane]:
        """Advance every live lane by up to `chunk` epochs, each stopping
        the epoch its predicate fires or its budget runs out; returns
        (and frees) the finished lanes."""
        lanes = [lane for lane in self.slots if lane is not None]
        for lane in lanes:
            lane.t_hi = min(lane.t + engine.chunk, lane.prep.budget)
        for _ in range(engine.chunk):
            live = [lane for lane in lanes
                    if not lane.stop and lane.t < lane.t_hi]
            if not live:
                break
            hits = []
            for lane in live:
                arr_t = {k: v[lane.t] for k, v in lane.arr.items()}
                lane.beta, nm = self.step_fn(lane.beta, lane.dev, lane.lr,
                                             self.beta_true[lane.beta.device],
                                             arr_t)
                lane.t += 1
                lane.trace[lane.t] = nm
                # the early-exit predicate, on the device: the NMSE target
                # OR a one-epoch relative plateau (rel_delta < 0 never
                # fires)
                hits.append((nm <= lane.nmse_target)
                            | (torch.abs(lane.prev - nm)
                               <= lane.rel_delta * lane.prev))
                lane.prev = nm
            gated = [lane.t >= lane.prep.criterion.min_epochs
                     for lane in live]
            # one read-back per group-epoch, none below min_epochs
            fired = _fired(hits) if any(gated) \
                else np.zeros(len(live), dtype=bool)
            for lane, ok, hit in zip(live, gated, fired):
                lane.converged = bool(ok and hit)
                lane.stop = lane.converged or lane.t >= lane.prep.budget
        finished = []
        for slot, lane in enumerate(self.slots):
            if lane is not None and lane.stop:
                finished.append(lane)
                self.slots[slot] = None
        return finished


class FedServeEngine:
    """The always-on serving loop over a fixed `TrainData` problem.

    data:       the training problem every served session runs on
    lane_width: slots per shape bucket
    chunk:      epochs advanced per engine step — the harvest/admission
                granularity.  Convergence still exits a lane at the exact
                epoch the predicate fires; `chunk` only bounds how long a
                freed slot waits to be noticed.
    criterion:  engine-default `ConvergenceCriterion` (per-request
                overrides via `ServeRequest.criterion`; strategies
                tighten it via `serve_convergence`)
    max_groups: cap on the number of lane groups (None: no cap)
    device:     where the engine runs (None: the CUDA device, which must
                exist); the data and every session must live there
    devices:    the devices the groups' lane meshes are made from
                (default: every card of `device`'s type, `device` first;
                see `launch.mesh.make_lane_mesh`)
    """

    def __init__(self, data, *, lane_width: int = 4, chunk: int = 25,
                 criterion: ConvergenceCriterion = ConvergenceCriterion(),
                 max_groups: Optional[int] = None, device=None,
                 devices: Optional[Sequence[torch.device]] = None):
        if lane_width < 1:
            raise ValueError(f"lane_width must be >= 1, got {lane_width}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.device = resolve_device(device)
        if data.device != self.device:
            raise ValueError(f"data lives on {data.device}, the engine "
                             f"runs on {self.device}")
        self.data = data
        self.devices = local_devices(self.device) if devices is None \
            else list(devices)
        self.lane_width = lane_width
        self.chunk = chunk
        self.criterion = criterion
        self.max_groups = max_groups
        self.now = 0.0
        self._scheduler = FifoScheduler()
        self._groups: Dict[Hashable, _LaneGroup] = {}
        self._prepared: Dict[int, _Prepared] = {}
        self._done: Dict[int, TraceReport] = {}
        self._uids: List[int] = []
        self._next_uid = 0
        self.steps = 0
        # the t = 0 probe, the expression a solo run's trace starts with
        self._nmse0 = aggregation.nmse(
            torch.zeros(data.model_dim, dtype=data.xs.dtype,
                        device=self.device), data.beta_true)

    # -- submission --------------------------------------------------------

    def submit(self, session: Session, *, uid: Optional[int] = None,
               arrival: Optional[float] = None, state: Any = None,
               rng_seed: Optional[int] = None,
               criterion: Optional[ConvergenceCriterion] = None) -> int:
        """Queue one session; returns its uid.  The host-side preparation
        (planning, epoch pre-sampling, operand layout) happens here."""
        return self.submit_many(
            [session], uids=None if uid is None else [uid],
            arrivals=None if arrival is None else [arrival],
            states=None if state is None else [state],
            rng_seeds=None if rng_seed is None else [rng_seed],
            criteria=None if criterion is None else [criterion])[0]

    def submit_many(self, sessions: Sequence[Session], *,
                    uids: Optional[Sequence[int]] = None,
                    arrivals: Optional[Sequence[float]] = None,
                    states: Optional[Sequence[Any]] = None,
                    rng_seeds: Optional[Sequence[int]] = None,
                    criteria: Optional[
                        Sequence[ConvergenceCriterion]] = None) -> List[int]:
        """Queue a batch of sessions.  Unplanned strategies are planned
        through ONE batched `plan_sweep` call."""
        sessions = list(sessions)
        for sess in sessions:
            _check_device(sess, self.data)
        if states is None:
            states = plan_sweep(sessions, self.data)
        out_uids: List[int] = []
        for i, (sess, st) in enumerate(zip(sessions, states)):
            uid = self._next_uid if uids is None else int(uids[i])
            if uid in self._prepared or uid in self._done:
                raise ValueError(f"duplicate serve uid {uid}")
            self._next_uid = max(self._next_uid, uid) + 1
            req = ServeRequest(
                session=sess, uid=uid,
                arrival=self.now if arrivals is None else float(arrivals[i]),
                rng_seed=None if rng_seeds is None else rng_seeds[i],
                state=st,
                criterion=None if criteria is None else criteria[i])
            prep = self._prepare(req)
            self._prepared[uid] = prep
            self._uids.append(uid)
            self._scheduler.push(req, prep.key)
            out_uids.append(uid)
        return out_uids

    def _prepare(self, req: ServeRequest) -> _Prepared:
        """Host work for one request: pre-sample the epoch randomness with
        the request's IDENTITY-keyed generator (never a shared engine
        stream), lay out the operands, copy the arrivals to the device,
        resolve the bucket key and the epoch budget."""
        sess = req.session
        state = req.state
        if state is None:
            state = sess.strategy.plan(sess.fleet, self.data)
        sample = getattr(sess.strategy, "sweep_inputs",
                         sess.strategy.sample_epochs)
        sched = sample(state, sess.fleet, sess.epochs, req.make_rng())
        dev = sess.strategy.device_state(state, self.data)
        arr = {k: np.asarray(v) for k, v in sched.arrivals.items()}
        key = _bucket_key(sess.strategy, state, self.data, dev, arr)
        crit = req.criterion if req.criterion is not None else self.criterion
        hook = getattr(sess.strategy, "serve_convergence", None)
        if hook is not None:
            crit = hook(state, crit)
        return _Prepared(
            request=req, state=state, sched=sched, dev=dev,
            arr={k: torch.as_tensor(v, device=self.device)
                 for k, v in arr.items()},
            key=key, criterion=crit, budget=crit.budget(sess.epochs))

    # -- the serving loop --------------------------------------------------

    def _admit_arrived(self) -> int:
        # capacity accounting is scoped to ONE admission scan: slots
        # handed out earlier in the scan are reserved so a burst of
        # same-bucket arrivals never overfills a group
        reserved: Dict[Hashable, int] = {}

        def capacity(key: Hashable) -> bool:
            group = self._groups.get(key)
            if group is not None:
                free = sum(s is None for s in group.slots)
            else:
                new = {k for k in reserved if k not in self._groups}
                if self.max_groups is not None and key not in new \
                        and len(self._groups) + len(new) >= self.max_groups:
                    return False
                free = self.lane_width
            if reserved.get(key, 0) >= free:
                return False
            reserved[key] = reserved.get(key, 0) + 1
            return True

        admitted = self._scheduler.pop_admissible(self.now, capacity)
        for req, key in admitted:
            prep = self._prepared[req.uid]
            group = self._groups.get(key)
            if group is None:
                group = _LaneGroup(self, key, prep)
                self._groups[key] = group
            group.admit(self, prep, group.free_slot())
        return len(admitted)

    def step(self) -> List[TraceReport]:
        """One engine iteration: admit everything that has arrived (whole
        queue scan — no head-of-line blocking), advance every busy group
        one chunk, harvest finished lanes.  Returns the harvest."""
        self._admit_arrived()
        if not any(g.running for g in self._groups.values()):
            nxt = self._scheduler.next_arrival(self.now)
            if nxt is not None:  # idle: fast-forward to the next arrival
                self.now = nxt
                self._admit_arrived()
        harvested: List[TraceReport] = []
        for group in self._groups.values():
            if not group.running:
                continue
            for lane in group.step(self):
                report = self._report(lane)
                uid = lane.prep.request.uid
                self._done[uid] = report
                del self._prepared[uid]
                harvested.append(report)
        self.steps += 1
        self.now += self.chunk
        return harvested

    def drain(self, max_steps: int = 100_000) -> List[TraceReport]:
        """Serve until queue and lanes are empty; reports in submit
        order."""
        for _ in range(max_steps):
            if not len(self._scheduler) and \
                    not any(g.running for g in self._groups.values()):
                break
            self.step()
        else:
            raise RuntimeError(f"drain did not finish in {max_steps} steps")
        return [self._done[uid] for uid in self._uids if uid in self._done]

    def serve(self, sessions: Sequence[Session], *,
              arrivals: Optional[Sequence[float]] = None,
              states: Optional[Sequence[Any]] = None) -> List[TraceReport]:
        """Admit everything, drain: the batch entry point.  Reports come
        back in `sessions` order regardless of arrival interleaving."""
        uids = self.submit_many(sessions, arrivals=arrivals, states=states)
        self.drain()
        return [self._done[uid] for uid in uids]

    # -- reporting ---------------------------------------------------------

    def _report(self, lane: _Lane) -> TraceReport:
        """The truncated-run TraceReport: a PREFIX of the solo report up
        to the exit epoch, with the early-exit point (and a truncated
        privacy schedule) on `extras`."""
        prep, t_exit = lane.prep, lane.t
        sess = prep.request.session
        sched = prep.sched
        trace = lane.trace[:t_exit + 1]
        flat = torch.cat([trace, lane.beta]).cpu().numpy()
        durations = np.asarray(sched.durations)[:t_exit]
        times = sched.t0 + np.concatenate([[0.0], np.cumsum(durations)])
        extras_fn = getattr(sess.strategy, "report_extras", None)
        extras = dict(extras_fn(prep.state)) if extras_fn is not None else {}
        eps_sched = extras.get("epsilon_schedule")
        if eps_sched is not None and t_exit < len(np.asarray(eps_sched)):
            # an early-exited lane only SPENDS the rounds it ran: the
            # cumulative schedule and composed total truncate with it
            cut = np.asarray(eps_sched)[:t_exit]
            extras["epsilon_schedule"] = cut
            extras["epsilon_spent"] = float(cut[-1]) if t_exit else 0.0
            extras["accounting_rounds"] = int(t_exit)
        extras["serve_exit_epoch"] = int(t_exit)
        extras["serve_converged"] = bool(lane.converged)
        extras["serve_uid"] = int(prep.request.uid)
        return TraceReport(
            times=times,
            nmse=flat[:t_exit + 1],
            epoch_durations=durations,
            label=sess.strategy.label,
            setup_time=sched.setup_time,
            uplink_bits_total=sess.strategy.uplink_bits(
                prep.state, sess.fleet, t_exit),
            extras=extras,
            beta=flat[t_exit + 1:])

    # -- introspection -----------------------------------------------------

    @property
    def n_groups(self) -> int:
        return len(self._groups)

    @property
    def n_pending(self) -> int:
        return len(self._scheduler)

    @property
    def n_active(self) -> int:
        return sum(sum(s is not None for s in g.slots)
                   for g in self._groups.values())
