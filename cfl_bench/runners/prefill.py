"""Time to first token: an open loop of prompts into the port's
`serving.engine.ServeEngine`, each request ending at its first token
(`try_admit`: the prefill, the splice of its state into the slot, the
argmax read back to the host), after which the harness empties the slot
as the engine's `step` does for a finished request.  No decode step runs.

Request i is due at i / rate from the window's start; its time to first
token runs from then to its token on the host, so a request that waits
behind a long one pays the wait.  Each request's prompt length is drawn
log-uniform from the run's seed (`traffic.prompt_lengths`); set-up
prefills only the traffic file's few `warm_lengths`, so the window's
lengths are new to the engine.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from cfl_bench import spec, weights
from cfl_bench import traffic as gen
from cfl_bench import runners as base
from cfl_bench.runners import (Context, Tracer, full_precision, peak,
                               release, reset_peak, sync)


class Runner(base.Runner):
    def setup(self) -> None:
        c, t = self.ctx, self.ctx.traffic
        with c.spans("setup.import"):
            from repro_torch.serving import engine as serving
        self.serving = serving
        with c.spans("setup.weights"):
            params = self._params()
            sync(c.device)
        with c.spans("setup.engine"):
            self.engine = serving.ServeEngine(c.program_config, params,
                                              n_slots=t["slots"],
                                              max_seq=t["max_seq"],
                                              device=c.device)
        with c.spans("setup.warm"):
            for j, n in enumerate(t["warm_lengths"]):
                self._serve(-1 - j, gen.prompt_tokens(c.seed, j, int(n),
                                                      c.model["vocab"],
                                                      stream=4))
            sync(c.device)
        self.setup_peak = peak(c.device)

    def _serve(self, uid: int, prompt: np.ndarray, keep: bool = False):
        """One request through `try_admit`; with `keep`, the last
        position's logits that the engine's prefill step hands to its
        argmax are kept in `self.logits`."""
        req = self.serving.Request(uid=uid, prompt=prompt, max_new_tokens=1)
        if not keep:
            ok = self.engine.try_admit(req)
        else:
            prefill = self.engine._prefill

            def kept(params, batch):
                logits, cache = prefill(params, batch)
                self.logits = logits[0, -1].clone()
                return logits, cache
            self.engine._prefill = kept
            try:
                ok = self.engine.try_admit(req)
            finally:
                self.engine._prefill = prefill
        if ok:
            del self.engine.active[req.slot]
        return ok, req

    def window(self, seconds: float, trace=None) -> None:
        c, t = self.ctx, self.ctx.traffic
        tr = t["trace"]
        rate = t["rate_per_s"]
        n = max(1, int(seconds * rate))
        self.lengths = gen.prompt_lengths(c.seed, n, t["prompt_min"],
                                          t["prompt_max"])
        self.prompts = [gen.prompt_tokens(c.seed, i, int(self.lengths[i]),
                                          c.model["vocab"])
                        for i in range(n)]
        self.sample = self._sample(n)
        self.kept: dict[int, tuple] = {}
        self.ttft, clean = [], []
        traced: list[int] = []
        spans: list[tuple[float, float]] = []
        # the traced requests end the window: the profiler's cost delays
        # no request that the per-layer numbers read
        self.trace = Tracer(trace, max(n - tr["units"] - tr["host_units"], 0),
                            tr["units"], tr["host_units"])
        reset_peak(c.device)
        sync(c.device)
        t0 = time.perf_counter()
        for i in range(n):
            due = t0 + i / rate
            while (wait := due - time.perf_counter()) > 0:
                time.sleep(wait)
            self.trace.before(i)
            ts = time.perf_counter()
            self.attempted += 1
            with c.spans("try_admit"):
                ok, req = self._serve(i, self.prompts[i],
                                      keep=i in self.sample)
            tf = time.perf_counter()
            if not ok:
                self.failed += 1
                self.trace.after(i)
                continue
            self.ttft.append(tf - due)
            if not self.trace.active():
                clean.append((int(self.lengths[i]), tf - ts, tf - due))
            elif not self.trace.tracing_host():
                traced.append(int(self.lengths[i]))
                spans.append((ts, tf))
            if i in self.sample:
                self.kept[i] = (req.out_tokens[0], self.logits, {
                    p: v[:, req.slot].clone()
                    for p, v in weights.flat_leaves(self.engine.cache)})
            self.trace.after(i)
        self.trace.close()
        self.window_s = time.perf_counter() - t0
        self.clean, self.traced = clean, traced
        self.traced_spans = [(a - spans[0][0], b - spans[0][0])
                             for a, b in spans]
        self.window_peak = peak(c.device)

    def _sample(self, n: int) -> set:
        """The requests checked: the first of the longest, and others drawn
        from the seed."""
        k = min(self.ctx.traffic["check_requests"], n)
        longest = int(np.argmax(self.lengths))
        rest = np.delete(np.arange(n), longest)
        pick = gen.rng(self.ctx.seed, 5).choice(rest, size=k - 1,
                                                replace=False)
        return {longest, *(int(i) for i in pick)}

    def end_to_end(self) -> dict:
        return {"ttft_p95_ms": 1e3 * float(np.percentile(self.ttft, 95))}

    def layer_record(self) -> dict:
        return {"lengths": [n for n, _, _ in self.clean],
                "service_s": [s for _, s, _ in self.clean],
                "ttft_s": [w for _, _, w in self.clean],
                "traced_lengths": self.traced,
                "traced_spans": self.traced_spans}

    def release(self) -> None:
        del self.engine
        release(self.ctx.device)

    def _reference(self, tokens: np.ndarray, params: dict, tf32: bool):
        c = self.ctx
        ref = spec.reference(c.family)
        with torch.no_grad(), full_precision(tf32):
            return ref.prefill(c.model, params,
                               torch.as_tensor(tokens, device=c.device)[None])

    def checks(self) -> dict:
        """At the sampled requests: the served token's gap below the
        reference's best logit, the served position's logits against the
        reference's, and the state each request left in its slot against
        the reference's."""
        params = self._params()
        token_gap = logit_gap = state_gap = 0.0
        for i in sorted(self.kept):
            token, served, state = self.kept[i]
            logits, ref_state = self._reference(self.prompts[i], params,
                                                False)
            token_gap = max(token_gap, float(logits.max() - logits[token]))
            logit_gap = max(logit_gap, _logit_gap(served, logits))
            state_gap = max(state_gap, _state_gap(state, ref_state))
        del params
        release(self.ctx.device)
        return {"token_gap": token_gap, "logit_gap": logit_gap,
                "state_gap": state_gap}

    def control(self, tf32: bool = True) -> dict:
        """The same numbers with the reference in TF32 in the program's
        place: the gap of the token that TF32 puts first at every position
        of the sampled prompts; the logits and the state at the served
        position, as `checks` reads them."""
        c = self.ctx
        ref = spec.reference(c.family)
        params = self._params()
        token_gap = logit_gap = state_gap = 0.0
        for i in sorted(self.kept):
            toks = torch.as_tensor(self.prompts[i], device=c.device)[None]
            with torch.no_grad():
                with full_precision(True):
                    low = ref.forward(c.model, params, toks)[0]
                    low_last, low_state = ref.prefill(c.model, params, toks)
                with full_precision(False):
                    full = ref.forward(c.model, params, toks)[0]
                    full_last, full_state = ref.prefill(c.model, params,
                                                        toks)
            first = low.argmax(-1)
            gaps = full.max(-1).values - full.gather(-1, first[:, None])[:, 0]
            token_gap = max(token_gap, float(gaps.max()))
            logit_gap = max(logit_gap, _logit_gap(low_last, full_last))
            state_gap = max(state_gap, _state_gap(low_state, full_state))
            del low, full
        del params
        release(c.device)
        return {"token_gap": token_gap, "logit_gap": logit_gap,
                "state_gap": state_gap}


def _logit_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """max |program - reference| over max |reference| of one position's
    logits."""
    ref = reference.to(torch.float32)
    return float((program.to(ref.dtype) - ref).abs().max() / ref.abs().max())


def _state_gap(program: dict, reference: dict) -> float:
    """The widest gap over the state's leaves and layers: max |program -
    reference| over max |reference| of that layer's leaf."""
    worst = 0.0
    for path, ref in reference.items():
        got = program[path].to(ref.dtype)
        dims = tuple(range(1, ref.dim()))
        gap = (got - ref).abs().amax(dim=dims) / ref.abs().amax(dim=dims)
        worst = max(worst, float(gap.max()))
    return worst
