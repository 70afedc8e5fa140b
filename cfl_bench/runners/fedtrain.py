"""Federated training of a deep model: a closed loop of rounds, each the
round of `launch.train --federated` (the port's `fed.trainer.
round_weights`, then the step of `launch.steps.make_fed_train_step`,
then the loss read back).

Set-up builds the one training state the window goes on with and drives
it through its first `check_steps` rounds, which the reference follows:
their losses, each leaf's first gradient (from AdamW's first moment after
one step: m = (1 - b1) g) and each leaf's change after the last of them.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from cfl_bench import spec, weights
from cfl_bench import traffic as gen
from cfl_bench import runners as base
from cfl_bench.runners import (Context, Tracer, full_precision, peak,
                               release, reset_peak, sync)
from cfl_bench.reference import check, fedplan, fedtrain


class Runner(base.Runner):
    def __init__(self, ctx: Context) -> None:
        super().__init__(ctx)
        t = ctx.traffic
        self.clients = np.repeat(np.arange(t["clients"]),
                                 t["sequences_per_client"])
        self.batch, self.seq = self.clients.size, t["seq_len"]

    def setup(self) -> None:
        from repro_torch.core.delay_model import DeviceDelayParams
        from repro_torch.fed import trainer
        from repro_torch.launch import steps
        from repro_torch.optim import optimizers

        c, t = self.ctx, self.ctx.traffic
        self.trainer = trainer
        with c.spans("setup.weights"):
            self.params = self._params()
            sync(c.device)
        o = t["optimizer"]
        self.opt = optimizers.make_optimizer(
            o["name"], o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
            weight_decay=o["weight_decay"])
        self.opt_state = self.opt.init(self.params)
        self.edge = gen.paper_edge(c.seed, t["clients"], c.model["d_model"],
                                   t["nu"], t["nu"])
        self.fed = trainer.fed_setup(
            DeviceDelayParams(**self.edge),
            trainer.FedConfig(t["clients"], t["sequences_per_client"],
                              self.batch))
        self.step = steps.make_fed_train_step(c.program_config, self.opt)
        self.arrivals = gen.rng(c.seed, 1)
        self.stream = gen.token_stream([c.seed, 0], self.batch, self.seq,
                                       c.model["vocab"],
                                       t["induction_prob"])
        self.first = {"batches": [], "losses": []}
        for k in range(t["check_steps"]):
            t1 = time.perf_counter()
            b, loss = self._round()
            self.first["batches"].append(b)
            self.first["losses"].append(loss)
            c.spans.seconds[f"setup.round{k + 1}"].append(
                time.perf_counter() - t1)
            if k == 0:
                self.first["grad_norms"] = {
                    n: float(m.norm()) / (1 - o["b1"])
                    for n, m in weights.flat_leaves(self.opt_state.mu)}
        start = dict(weights.flat_leaves(self._params()))
        self.first["change_norms"] = {
            n: float((p - start[n]).norm())
            for n, p in weights.flat_leaves(self.params)}
        del start
        self.setup_peak = peak(c.device)

    def _round(self) -> tuple[dict, float]:
        c = self.ctx
        b = next(self.stream)
        batch = {k: torch.from_numpy(v).to(c.device) for k, v in b.items()}
        self.attempted += 1
        with c.spans("round_weights"):
            w, _ = self.trainer.round_weights(self.fed, self.arrivals,
                                              self.clients)
        with c.spans("fed_step"):
            self.params, self.opt_state, m = self.step(
                self.params, self.opt_state, batch,
                torch.as_tensor(w, dtype=torch.float32).to(c.device))
            loss = float(m["loss"])
        return b, loss

    def window(self, seconds: float, trace=None) -> None:
        """Rounds until `seconds` have passed (and, traced, until the
        traced rounds after `skip_units` have run); a traced run's
        per-layer rates are taken over the other rounds, which the
        profiler does not slow."""
        c, tr = self.ctx, self.ctx.traffic["trace"]
        self.trace = Tracer(trace, tr["skip_units"], tr["units"],
                            tr["host_units"])
        reset_peak(c.device)
        sync(c.device)
        rounds = 0
        self.clean_rounds, self.clean_s = 0, 0.0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not self.trace.done():
            self.trace.before(rounds)
            traced = self.trace.active()
            t1 = time.perf_counter()
            self._round()
            if not traced:
                self.clean_rounds += 1
                self.clean_s += time.perf_counter() - t1
            self.trace.after(rounds)
            rounds += 1
        self.trace.close()
        self.window_s = time.perf_counter() - t0
        self.rounds = rounds
        self.window_peak = peak(c.device)

    def end_to_end(self) -> dict:
        return {"train_tokens_per_s":
                self.rounds * self.batch * self.seq / self.window_s,
                "train_peak_gib": self.window_peak / 2**30}

    def layer_record(self) -> dict:
        return {"rounds": self.clean_rounds, "seconds": self.clean_s,
                "batch": self.batch, "seq": self.seq}

    def release(self) -> None:
        del self.params, self.opt_state, self.step
        release(self.ctx.device)

    def checks(self) -> dict:
        """The numbers compared: the program's first rounds against the
        reference's, in full float32."""
        numbers = compare(self.first, self.reference())
        detail = numbers.pop("detail")
        print(f"cfl_bench: worst leaves: grad {detail['grad_leaf']}, "
              f"change {detail['change_leaf']}", file=sys.stderr)
        return numbers

    def control(self, tf32: bool = False, fault: str | None = None) -> dict:
        """The same numbers with the reference put in the program's place,
        computed in TF32 (`tf32`) or with one of `reference.fedtrain.
        train`'s faults planted: the upper readings of the limits."""
        if getattr(self, "_full", None) is None:
            self._full = self.reference()
        return compare(self.reference(tf32, fault), self._full)

    def reference(self, tf32: bool = False, fault: str | None = None) -> dict:
        c, t = self.ctx, self.ctx.traffic
        forward = spec.reference(c.family).forward
        sizes = np.full(t["clients"], t["sequences_per_client"])
        plan = fedplan.plan(self.edge, sizes, self.batch)
        arrivals = gen.rng(c.seed, 1)
        steps = t["check_steps"]
        w = [torch.as_tensor(fedplan.round_client_weights(
            self.edge, plan, arrivals)[self.clients],
            dtype=torch.float32, device=c.device) for _ in range(steps)]
        batches = [{k: torch.from_numpy(v).to(c.device) for k, v in b.items()}
                   for b in self.first["batches"]]
        with full_precision(tf32):
            out = fedtrain.train(
                lambda p, tok: forward(c.model, p, tok), self._params,
                batches, w, t["optimizer"], steps, fault=fault)
        release(c.device)
        return out


def compare(program: dict, reference: dict) -> dict:
    """The numbers compared, and under "detail" each step's loss gap and
    each leaf's gaps (the worst leaves named)."""
    skip = check.unmoved(reference["grad_norms"])
    grad_gap, grad_leaf = check.norm_gap(program["grad_norms"],
                                         reference["grad_norms"])
    change_gap, change_leaf = check.norm_gap(program["change_norms"],
                                             reference["change_norms"], skip)
    detail = {"grad_leaf": grad_leaf, "change_leaf": change_leaf,
              "skipped": sorted(skip),
              "losses": [program["losses"], reference["losses"]],
              "grad_norms": [program["grad_norms"], reference["grad_norms"]],
              "change_norms": [program["change_norms"],
                               reference["change_norms"]]}
    return {"loss_gap": check.loss_gap(program["losses"],
                                       reference["losses"]),
            "grad_gap": grad_gap, "change_gap": change_gap,
            "detail": detail}
