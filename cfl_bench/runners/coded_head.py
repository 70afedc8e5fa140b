"""CFL on a deep model's features: a closed loop of the port's
`coded_head_probe.run` experiments, each on fresh seeded tokens: the
backbone over all clients' sequences in one batch (mean-pooled last
hidden states), then the coded and uncoded heads on those features.

The probe's own settings (clients, sequences, length, learning rate,
generator key, label noise, parity share) are the traffic file's; set-up
checks that the port's module states the same ones.  The window ends when
the last experiment started inside it finishes.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from cfl_bench import spec, weights
from cfl_bench import traffic as gen
from cfl_bench import runners as base
from cfl_bench.runners import (Tracer, full_precision, peak, release,
                               reset_peak, sync)
from cfl_bench.reference import cflhead


class Runner(base.Runner):
    def setup(self) -> None:
        c, t = self.ctx, self.ctx.traffic
        with c.spans("setup.import"):
            from repro_torch import coded_head_probe as probe
        self.probe = probe
        stated = {"clients": probe.N_CLIENTS, "sequences": probe.ELL,
                  "seq_len": probe.SEQ, "lr": probe.LR,
                  "key": probe.KEY_SEED, "noise": probe.NOISE,
                  "epochs": probe.EPOCHS}
        differ = {k: v for k, v in stated.items() if t[k] != v}
        if differ or probe.FIXED_C != int(
                t["parity_share"] * t["clients"] * t["sequences"]):
            raise ValueError(f"the port's probe settings {differ} differ "
                             f"from the traffic file's")
        with c.spans("setup.weights"):
            self.params = self._params()
            sync(c.device)
        with c.spans("setup.warm"):
            self._experiment(-1)
            sync(c.device)
        self.kept = {}
        self.setup_peak = peak(c.device)

    def _inputs(self, k: int) -> dict:
        """Experiment k's tokens (clients, sequences, seq_len), true head
        (d_model,) and label noise (clients, sequences), on the device."""
        c, t = self.ctx, self.ctx.traffic
        g = weights.generator(c.seed, c.device, stream=2 + k)
        shape = (t["clients"], t["sequences"])
        return {"tokens": torch.randint(0, c.model["vocab"],
                                        (*shape, t["seq_len"]), generator=g,
                                        device=c.device),
                "beta_true": torch.randn(c.model["d_model"], generator=g,
                                         device=c.device),
                "noise": torch.randn(shape, generator=g, device=c.device)}

    def _experiment(self, k: int) -> dict:
        c, t = self.ctx, self.ctx.traffic
        inputs = self._inputs(k)
        self.attempted += 1
        with c.spans("experiment"):
            out = self.probe.run(
                arch=c.program_config.name, epochs=t["epochs"],
                device=c.device, seed=c.seed, params=self.params, **inputs)
        return {"inputs": inputs, "out": out}

    def window(self, seconds: float, trace=None) -> None:
        c, tr = self.ctx, self.ctx.traffic["trace"]
        self.trace = Tracer(trace, tr["skip_units"], tr["units"],
                            tr["host_units"])
        reset_peak(c.device)
        sync(c.device)
        self.clean = []
        results = []
        k = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not self.trace.done():
            self.trace.before(k)
            traced = self.trace.active()
            results.append(self._experiment(k))
            seconds_k = results[-1]["out"]["seconds"]
            if not traced:
                self.clean.append((seconds_k["features"], seconds_k["heads"]))
            self.trace.after(k)
            k += 1
        self.trace.close()
        self.window_s = time.perf_counter() - t0
        self.experiments = k
        self.window_peak = peak(c.device)
        pick = int(gen.rng(c.seed, 6).integers(k))
        self.kept = _keep(results[pick])
        self.traced_experiments = min(tr["units"], max(k - tr["skip_units"],
                                                       0))

    def end_to_end(self) -> dict:
        t = self.ctx.traffic
        return {"probe_seqs_per_s": self.experiments * t["clients"]
                * t["sequences"] / self.window_s}

    def layer_record(self) -> dict:
        t = self.ctx.traffic
        return {"backbone_s": [f for f, _ in self.clean],
                "heads_s": [h for _, h in self.clean],
                "rows": t["clients"] * t["sequences"],
                "seq_len": t["seq_len"],
                "traced_experiments": self.traced_experiments}

    def release(self) -> None:
        del self.params
        release(self.ctx.device)

    def checks(self) -> dict:
        """The checked experiment's backbone features against the
        reference's, its deadline against the least one that meets the
        plan's target, and both heads' NMSE and time traces against the
        reference's heads on the same features at that deadline."""
        out = self.kept
        ref_feats = self.features(out["inputs"]["tokens"], tf32=False)
        feat_gap = float((out["feats"] - ref_feats).abs().max()
                         / ref_feats.abs().max())
        return {"feat_gap": feat_gap, **self.head_gaps(out)}

    def features(self, tokens: torch.Tensor, tf32: bool) -> torch.Tensor:
        """The reference's mean-pooled last hidden states, in blocks of
        sequences."""
        c = self.ctx
        ref = spec.reference(c.family)
        params = self._params()
        rows = tokens.reshape(-1, tokens.shape[-1])
        block = self.ctx.traffic["reference_block"]
        with torch.no_grad(), full_precision(tf32):
            feats = torch.cat([ref.hidden(c.model, params,
                                          rows[i:i + block]).mean(1)
                               for i in range(0, rows.shape[0], block)])
        del params
        release(c.device)
        return feats.reshape(*tokens.shape[:2], -1)

    def _heads(self, raw: torch.Tensor, out: dict,
                setting: dict | None = None) -> dict:
        """The reference's heads on backbone features `raw`, normalised
        as the probe does, at the checked run's deadline."""
        t = setting or self.ctx.traffic
        raw = raw.to(torch.float64)
        feats = raw / (raw.std(correction=0) + 1e-6)
        inputs = out["inputs"]
        ys = torch.einsum("nld,d->nl", feats, inputs["beta_true"].double()) \
            + t["noise"] * inputs["noise"].double()
        return cflhead.heads(feats, ys, inputs["beta_true"],
                             float(out["cfl_durations"][0]), t, t["epochs"])

    def _least(self, out: dict, more_rows: int = 0) -> float:
        """The reference's least deadline that meets the plan's target at
        the checked run's sizes, with `more_rows` parity rows added."""
        t = self.ctx.traffic
        n, ell, d = out["feats"].shape
        edge, server = cflhead.fleet(n, d, t["nu"], t["fleet_seed"])
        return cflhead.least_deadline(
            edge, server, ell, int(t["parity_share"] * n * ell) + more_rows)

    def head_gaps(self, out: dict) -> dict:
        least = self._least(out)
        t_star = float(out["cfl_durations"][0])
        return {"plan_gap": abs(t_star - least) / least,
                **_trace_gaps(out, self._heads(out["feats"], out))}

    def plan_fault(self) -> dict:
        """`plan_gap` of a plan off by one step of its redundancy: the
        port's planner on the run's device at one parity row fewer, and at
        one more, then the reference's least deadline there, each in the
        program's place."""
        from repro_torch.core.redundancy import solve_redundancy
        from repro_torch.sim.network import paper_fleet

        t = self.ctx.traffic
        n, ell, d = self.kept["feats"].shape
        c = int(t["parity_share"] * n * ell)
        least = self._least(self.kept)
        fleet = paper_fleet(t["nu"], t["nu"], seed=t["fleet_seed"], n=n, d=d)
        out = {}
        for k in (-1, 1):
            plan = solve_redundancy(fleet.edge, fleet.server,
                                    np.full(n, ell, dtype=np.int64),
                                    c_up=None, fixed_c=c + k,
                                    device=self.ctx.device)
            out[f"program_c{k:+d}"] = abs(float(plan.t_star) - least) / least
            out[f"reference_c{k:+d}"] = abs(self._least(self.kept, k)
                                            - least) / least
        return out

    def control(self, fault: bool = False) -> dict:
        """The same numbers with the reference in TF32 in the program's
        place: its features, and both heads trained on them; or, with
        `fault`, the reference's heads with each epoch's answer (the
        arrivals and the slowest client's time) drawn from another
        generator: an answer altered where it is produced."""
        out = self.kept
        if fault:
            moved = {**self.ctx.traffic,
                     "arrival_seed": self.ctx.traffic["arrival_seed"] + 1}
            return _trace_gaps(self._heads(out["feats"], out, moved),
                               self._heads(out["feats"], out))
        tokens = out["inputs"]["tokens"]
        full = self.features(tokens, tf32=False)
        low = self.features(tokens, tf32=True)
        ref_heads = self._heads(full, out)
        low_heads = self._heads(low, out)
        return {"feat_gap": float((low - full).abs().max() / full.abs().max()),
                **_trace_gaps(low_heads, ref_heads)}


def _keep(result: dict) -> dict:
    """What the check reads of one experiment, off the port's objects."""
    out = result["out"]
    reports = out["reports"]
    kept = {"inputs": result["inputs"],
            "feats": out["backbone_feats"].detach().clone(),
            "cfl_durations": np.asarray(reports["cfl"].epoch_durations)}
    for k in ("uncoded", "cfl"):
        kept[k] = {"nmse": np.asarray(reports[k].nmse, dtype=np.float64),
                   "times": np.asarray(reports[k].times, dtype=np.float64)}
    return kept


def _trace_gaps(program: dict, reference: dict) -> dict:
    """The widest relative gaps of the two runs' NMSE and time traces."""
    def gap(key, first):
        return max(float(np.max(np.abs(program[k][key][first:]
                                       - reference[k][key][first:])
                                / reference[k][key][first:]))
                   for k in ("uncoded", "cfl"))
    return {"nmse_gap": gap("nmse", 0), "time_gap": gap("times", 1)}
