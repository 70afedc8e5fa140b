"""`Session` and the sweep engine (counterpart of `repro/api/session.py`:
the engine cache, the bucket keys, `make_epoch_step`, `Session.run`,
`plan_sweep` and `run_sweep`).

The strategy pre-samples every epoch's delays and arrivals on the host
(NumPy, in the reference's draw order); the epoch loop runs on the
device: gradient round, GD update (Eq. 3), NMSE.  β, the arrival tensors
and the NMSE trace stay on the device, and nothing inside the loop reads
a value back to the host — no `.item()`, no `.cpu()` — so the host only
enqueues work.

One code path serves solo runs and sweeps: `Session.run` is a size-1
lane of `_execute_lanes`, as in the reference.  Lanes (sessions) are
grouped into shape buckets — same strategy static structure, same
operand shapes — and each bucket fetches ONE engine from the module
cache: the epoch step of `make_epoch_step` over the bucket's first
state.  Nothing is compiled.  The lanes of a bucket run one after
another on the session's device (the counterpart of the reference's
`lax.map`, which it chose over `vmap` so that a lane's arithmetic does
not depend on the lane count), each on its own operands plus ONE copy of
the operands its strategy declares data-only (`data_device_keys`).  A
sweep lane therefore runs the same launches on the same tensors as the
same session run solo, and its trace is bit-equal to the solo trace.
The host syncs once per call, after every lane is enqueued.

    fleet   = paper_fleet(0.2, 0.2, seed=0)
    data    = TrainData.linreg(0, n=24, ell=300, d=500)   # on the card
    session = Session(strategy=CodedFL(key=1, fixed_c=2016),
                      fleet=fleet, lr=0.0085, epochs=600)
    report  = session.run(data)          # -> TraceReport

    # a whole sweep: one batched planning solve, one engine per bucket
    reports = run_sweep([session_a, session_b, ...], data)

A bucket's lanes are split evenly over the lane mesh
(`launch.mesh.make_lane_mesh`: the largest count of the local cards
that divides the bucket's lanes, as the reference's): each card gets
one copy of the shared operands and of `beta_true`, its lanes' own
operands and arrivals, and runs its lanes in turn.  A lane runs the same
launches on the same values on any card, so its trace is the same at
every mesh size.  The traces and final betas come back in one transfer
per card, after every lane of the call is enqueued.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import (TYPE_CHECKING, Any, Callable, Dict, Hashable, List,
                    Optional, Sequence)

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import local_devices, make_lane_mesh
from repro_torch.launch.sharding import shard_lanes

from .report import TraceReport
from .strategy import EpochSchedule, Strategy, TrainData

if TYPE_CHECKING:
    from repro_torch.sim.network import FleetSpec

# Engines shared by every Session in the process, one entry per bucket
# key.  Each engine's closure pins its bucket's first strategy state
# (which can hold MB-scale parity tensors), so the cache is a BOUNDED
# LRU: least-recently-used entries evict once the cap is exceeded.  The
# cap defaults to _ENGINE_CACHE_MAX; REPRO_ENGINE_CACHE_MAX overrides it
# per process.  All lookups go through `cache_engine`, shared with the
# serving engine (`repro_torch.serving.fed_engine`).
_ENGINE_CACHE: "OrderedDict[Hashable, Callable]" = OrderedDict()
_ENGINE_CACHE_MAX = 64


def engine_cache_max() -> int:
    """Effective LRU capacity (env override, floor 1)."""
    try:
        return max(1, int(os.environ["REPRO_ENGINE_CACHE_MAX"]))
    except (KeyError, ValueError):
        return _ENGINE_CACHE_MAX


def cache_engine(key: Hashable, build: Callable[[], Callable]) -> Callable:
    """Fetch (or build) an engine through the shared LRU.

    A hit refreshes the key's recency; a miss builds, inserts, and evicts
    least-recently-used entries past the cap.  Evicted engines keep
    working for holders of a direct reference (the serving engine's lane
    groups pin their own, sessions mirror theirs in `_engines`), so an
    eviction never breaks an in-flight bucket."""
    engine = _ENGINE_CACHE.get(key)
    if engine is not None:
        _ENGINE_CACHE.move_to_end(key)
        return engine
    engine = build()
    _ENGINE_CACHE[key] = engine
    cap = engine_cache_max()
    while len(_ENGINE_CACHE) > cap:
        _ENGINE_CACHE.popitem(last=False)
    return engine


_PRIMITIVES = (bool, int, float, str, bytes, type(None))


def _static_strategy_key(strategy: Strategy) -> Hashable:
    """Full static identity of a strategy's epoch program.

    The class (module-qualified) and every primitive-valued dataclass
    field, EXCEPT `label` (display only) and the fields the strategy
    declares in `engine_value_fields` — knobs that only change operand
    VALUES (plan inputs, host-side sampling, the int seeds of the
    generators, report metadata), never the program.  Tensor- and
    generator-valued fields are skipped.  Keying on every other field
    means a strategy whose `engine_key` under-reports still never shares
    an engine across program differences."""
    cls = type(strategy)
    parts: List[Any] = [f"{cls.__module__}.{cls.__qualname__}"]
    skip = set(getattr(strategy, "engine_value_fields", ())) | {"label"}
    if dataclasses.is_dataclass(strategy):
        fields = [f.name for f in dataclasses.fields(strategy)]
    else:  # non-dataclass user strategies: their primitive attributes
        fields = sorted(k for k in getattr(strategy, "__dict__", {}))
    for name in fields:
        if name in skip:
            continue
        value = getattr(strategy, name)
        if isinstance(value, _PRIMITIVES):
            parts.append((name, type(value).__name__, value))
    return tuple(parts)


def _tree_shape_key(tree: Dict[str, Any]) -> Hashable:
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in tree.items()))


def _bucket_key(strategy: Strategy, state: Any, data: TrainData,
                dev: Dict[str, torch.Tensor],
                arrivals: Dict[str, np.ndarray]) -> Hashable:
    """Sessions with equal keys run as lanes of one engine."""
    return (_static_strategy_key(strategy),
            strategy.engine_key(state),
            data.m, data.d, data.model_dim, str(data.xs.dtype),
            _tree_shape_key(dev), _tree_shape_key(arrivals))


def make_epoch_step(strategy: Strategy, state: Any, m: int) -> Callable:
    """Build THE per-epoch training program for one strategy state.

    Returns `step(beta, dev, lr, beta_true, arr_t) -> (beta', nmse')`:
    one gradient round (`round_contributions`), one GD update (Eq. 3),
    one NMSE probe — all tensors, no host sync.  The sweep engine and the
    serving engine (`repro_torch.serving.fed_engine`) both run this one
    function, which is what makes a served lane's trace prefix-equal to
    the same session's solo run."""

    def step(beta: torch.Tensor, dev: Dict[str, torch.Tensor],
             lr: torch.Tensor, beta_true: torch.Tensor,
             arr_t: Dict[str, torch.Tensor]) -> tuple:
        g = strategy.round_contributions(state, dev, beta, arr_t)
        beta = aggregation.gd_update(beta, g, lr, m)
        return beta, aggregation.nmse(beta, beta_true)

    return step


def _check_device(session: "Session", data: TrainData) -> None:
    if data.device != session.device:
        raise ValueError(f"data lives on {data.device}, the session "
                         f"runs on {session.device}")


def shared_operands(strategy: Strategy,
                    dev: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The operands of `dev` that `strategy` declares pure functions of
    the data (`data_device_keys`): one copy serves every lane of a call."""
    keys = set(getattr(strategy, "data_device_keys", ())) & set(dev)
    return {k: dev[k] for k in keys}


def _to(tree: Dict[str, torch.Tensor],
        device: torch.device) -> Dict[str, torch.Tensor]:
    """The tensors of a flat dict on `device` (no copy where they are)."""
    return {k: v.to(device) for k, v in tree.items()}


def _run_lane(step: Callable, dev: Dict[str, torch.Tensor],
              arr: Dict[str, torch.Tensor], lr: float,
              data: TrainData, epochs: int, device: torch.device,
              beta_true: torch.Tensor) -> tuple:
    """Enqueue one lane's epoch loop on `device`, over its operands and
    arrival tensors and `beta_true` (already there); returns its
    ((epochs+1,) NMSE trace, final beta) as device tensors, unsynced."""
    dtype = data.xs.dtype
    lr_t = torch.full((), lr, dtype=dtype, device=device)  # a fill, no copy
    beta = torch.zeros(data.model_dim, dtype=dtype, device=device)
    trace = torch.empty(epochs + 1, dtype=dtype, device=device)
    trace[0] = aggregation.nmse(beta, beta_true)
    for e in range(epochs):
        arr_t = {k: v[e] for k, v in arr.items()}
        beta, trace[e + 1] = step(beta, dev, lr_t, beta_true, arr_t)
    return trace, beta


def _read_back(pending: Sequence[tuple]) -> List[tuple]:
    """Each lane's (trace, beta) device tensors as NumPy arrays, in one
    transfer per device."""
    by_device: Dict[torch.device, List[int]] = {}
    for i, (trace, _) in enumerate(pending):
        by_device.setdefault(trace.device, []).append(i)
    out: List[Optional[tuple]] = [None] * len(pending)
    for idxs in by_device.values():
        flat = torch.cat([t for i in idxs for t in pending[i]]).cpu().numpy()
        at = 0
        for i in idxs:
            n_t, n_b = (t.numel() for t in pending[i])
            out[i] = (flat[at:at + n_t], flat[at + n_t:at + n_t + n_b])
            at += n_t + n_b
    return out  # type: ignore[return-value]


def _execute_lanes(entries: Sequence[tuple], data: TrainData,
                   devices: Optional[Sequence[torch.device]] = None
                   ) -> List[tuple]:
    """Run every (session, state, schedule) lane through the sweep core.

    Lanes are grouped into shape buckets; each bucket fetches (or builds)
    its engine from the module cache, takes the shared operands from its
    first lane, splits its lanes over its lane mesh (`make_lane_mesh`
    over `devices`, default every card of the data's device type, the
    data's first) and runs each card's lanes in turn.  Every lane's
    arrivals reach its card before the first epoch is enqueued, so no
    copy waits on a queued lane.  Returns each lane's ((epochs+1,) NMSE
    trace, (model_dim,) final beta) as NumPy arrays, in order, read back
    once per card."""
    devices = local_devices(data.device) if devices is None \
        else list(devices)
    devs: List[Dict[str, torch.Tensor]] = []
    arrs: List[Dict[str, np.ndarray]] = []
    buckets: Dict[Hashable, List[int]] = {}
    for i, (sess, state, sched) in enumerate(entries):
        _check_device(sess, data)
        dev = sess.strategy.device_state(state, data)
        arr = {k: np.asarray(v) for k, v in sched.arrivals.items()}
        key = _bucket_key(sess.strategy, state, data, dev, arr)
        buckets.setdefault(key, []).append(i)
        devs.append(dev)
        arrs.append(arr)

    # each lane's card, and its arrivals there before any epoch
    placed: Dict[Hashable, list] = {}
    arr_on: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(entries)
    for key, idxs in buckets.items():
        mesh = make_lane_mesh(len(idxs), devices)
        placed[key] = [(card, [idxs[j] for j in lanes])
                       for card, lanes in shard_lanes(mesh, len(idxs))]
        for card, lanes in placed[key]:
            for i in lanes:
                arr_on[i] = {k: torch.as_tensor(v, device=card)
                             for k, v in arrs[i].items()}

    pending: List[Optional[tuple]] = [None] * len(entries)
    for key, idxs in buckets.items():
        sess0, state0, _ = entries[idxs[0]]
        shared0 = shared_operands(sess0.strategy, devs[idxs[0]])
        engine = cache_engine(
            ("sweep", key),
            lambda: make_epoch_step(sess0.strategy, state0, data.m))
        for card, lanes in placed[key]:
            shared = _to(shared0, card)  # once per card
            beta_true = data.beta_true.to(card)
            for i in lanes:
                sess = entries[i][0]
                lane_dev = {**_to(devs[i], card), **shared}
                pending[i] = _run_lane(engine, lane_dev, arr_on[i], sess.lr,
                                       data, sess.epochs, card, beta_true)
                # per-session mirror: introspection + lifetime of the
                # session
                sess._engines[("sweep", key)] = engine
    return _read_back(pending)


def _lane_report(session: "Session", state: Any, sched: EpochSchedule,
                 nmse_trace: np.ndarray,
                 label: Optional[str] = None,
                 beta: Optional[np.ndarray] = None) -> TraceReport:
    """Assemble the TraceReport for one lane — ONE code path for solo runs
    and sweep lanes, so their reports cannot drift."""
    times = sched.t0 + np.concatenate([[0.0], np.cumsum(sched.durations)])
    extras_fn = getattr(session.strategy, "report_extras", None)
    return TraceReport(
        times=times,
        nmse=nmse_trace,
        epoch_durations=np.asarray(sched.durations),
        label=label if label is not None else session.strategy.label,
        setup_time=sched.setup_time,
        uplink_bits_total=session.strategy.uplink_bits(
            state, session.fleet, session.epochs),
        extras=dict(extras_fn(state)) if extras_fn is not None else {},
        beta=beta)


@dataclasses.dataclass
class Session:
    """Runs one strategy over one fleet with an on-device epoch loop.

    strategy: the coding scheme (UncodedFL / CodedFL / any user Strategy)
    fleet:    delay + link parameters of the simulated fleet
    lr:       GD step size (Eq. 3)
    epochs:   number of training epochs per run
    seed:     default NumPy seed for delay sampling when `run` is not
              handed an explicit generator
    device:   where the run executes (None: the CUDA device, which must
              exist); `run` requires the data to live there
    """

    strategy: Strategy
    fleet: "FleetSpec"
    lr: float
    epochs: int
    seed: int = 0
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.epochs < 0:
            raise ValueError(f"epochs must be >= 0, got {self.epochs}")
        self.device = resolve_device(self.device)
        # local view into the shared module-level engine cache
        self._engines: Dict[Hashable, Callable] = {}

    def plan(self, data: TrainData):
        """Run the strategy's one-time setup."""
        return self.strategy.plan(self.fleet, data)

    def run(self, data: TrainData,
            rng: Optional[np.random.Generator] = None,
            label: Optional[str] = None, state=None) -> TraceReport:
        """Plan (unless a pre-planned `state` is given), pre-sample, and
        execute the full training trace on the session's device — a
        size-1 lane of the sweep engine."""
        _check_device(self, data)
        if rng is None:
            rng = np.random.default_rng(self.seed)
        if state is None:
            state = self.strategy.plan(self.fleet, data)
        sched: EpochSchedule = self.strategy.sample_epochs(
            state, self.fleet, self.epochs, rng)
        nmse_trace, beta = _execute_lanes([(self, state, sched)], data)[0]
        return _lane_report(self, state, sched, nmse_trace, label, beta=beta)


def plan_sweep(sessions: Sequence[Session], data: TrainData) -> List[Any]:
    """Plan every session's strategy, solving all redundancy problems in
    ONE batched call on the data's device.

    Strategies with the batched-planning hooks (`plan_request(fleet,
    data) -> repro_torch.plan.PlanRequest` and `plan_with(fleet, data,
    plan) -> state`) and no pre-solved `redundancy_plan` have their solves
    collected into one `repro_torch.plan.solve_redundancy_batched` call;
    every other strategy runs its own `plan`.  Returns one state per
    session, in order, for `Session.run(data, state=...)` or
    `run_sweep(..., states=...)`."""
    states: List[Any] = [None] * len(sessions)
    batched: List[int] = []
    requests = []
    for i, sess in enumerate(sessions):
        strat = sess.strategy
        if hasattr(strat, "plan_request") and hasattr(strat, "plan_with") \
                and getattr(strat, "redundancy_plan", None) is None:
            requests.append(strat.plan_request(sess.fleet, data))
            batched.append(i)
    if requests:
        from repro_torch.plan import solve_redundancy_batched
        plans = solve_redundancy_batched(requests, device=data.device)
        for i, plan in zip(batched, plans):
            states[i] = sessions[i].strategy.plan_with(
                sessions[i].fleet, data, plan)
    for i, sess in enumerate(sessions):
        if states[i] is None:
            states[i] = sess.plan(data)
    return states


def run_sweep(sessions: Sequence[Session], data: TrainData,
              rngs: Optional[Sequence[np.random.Generator]] = None,
              states: Optional[Sequence[Any]] = None,
              devices: Optional[Sequence[torch.device]] = None
              ) -> List[TraceReport]:
    """Execute a whole sweep of sessions.

      1. planning — `plan_sweep` collects every session's allocation solve
         into one batched call (skipped for pre-planned `states`);
      2. sampling — each lane pre-samples its own epoch randomness on the
         host through the strategy's `sweep_inputs` hook (falling back to
         `sample_epochs`) with a PER-LANE generator, so the draw order is
         a solo `Session.run`'s;
      3. training — lanes are grouped into shape buckets and each bucket
         runs its lanes on one engine, split over the lane mesh.

    Per-lane results — NMSE trace, wall-clock times, `TraceReport.extras`
    — are bit-for-bit those of running each session solo with the same
    generator.

    rngs:   one generator per session (default: a fresh
            `np.random.default_rng(session.seed)` each, the solo default)
    states: pre-planned strategy states (e.g. from `plan_sweep`)
    devices: the devices the lane mesh is made from (default: every card
            of the data's device type, the data's first; see
            `launch.mesh.make_lane_mesh`)
    """
    sessions = list(sessions)
    for sess in sessions:
        _check_device(sess, data)
    if states is None:
        states = plan_sweep(sessions, data)
    elif len(states) != len(sessions):
        raise ValueError(
            f"got {len(states)} states for {len(sessions)} sessions")
    if rngs is None:
        rngs = [np.random.default_rng(sess.seed) for sess in sessions]
    elif len(rngs) != len(sessions):
        raise ValueError(
            f"got {len(rngs)} generators for {len(sessions)} sessions")

    entries = []
    for sess, state, rng in zip(sessions, states, rngs):
        sample = getattr(sess.strategy, "sweep_inputs",
                         sess.strategy.sample_epochs)
        entries.append((sess, state,
                        sample(state, sess.fleet, sess.epochs, rng)))
    results = _execute_lanes(entries, data, devices)
    return [_lane_report(sess, state, sched, trace, beta=beta)
            for (sess, state, sched), (trace, beta) in zip(entries, results)]
