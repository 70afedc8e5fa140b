"""The comparison that decides `correct` fails a run whose timed path is
broken underneath: a tiny CPU run of each cell (the harness's look for a
card skipped) with one fault planted in the port, once for each fault the
cell can have."""
import pytest
import torch

from cfl_bench import run
from cfl_bench.test_bench_lastline import tiny_run


def _frozen_step(monkeypatch):
    from repro_torch.launch import steps

    make = steps.make_fed_train_step

    def make_frozen(cfg, opt, *a, **k):
        step = make(cfg, opt, *a, **k)

        def frozen(params, opt_state, batch, w):
            leaves = [p for _, p in run.weights.flat_leaves(params)]
            start = [p.clone() for p in leaves]
            out = step(params, opt_state, batch, w)
            with torch.no_grad():
                for p, old in zip(leaves, start):
                    p.copy_(old)
            return out
        return frozen
    monkeypatch.setattr(steps, "make_fed_train_step", make_frozen)


def _half_batch(monkeypatch):
    from repro_torch.launch import steps

    make = steps.make_fed_train_step

    def make_half(cfg, opt, *a, **k):
        step = make(cfg, opt, *a, **k)

        def half(params, opt_state, batch, w):
            w = w.clone()
            w[w.shape[0] // 2:] = 0
            return step(params, opt_state, batch, w)
        return half
    monkeypatch.setattr(steps, "make_fed_train_step", make_half)


def _altered_token(monkeypatch):
    from repro_torch.serving import engine

    admit = engine.ServeEngine.try_admit

    def altered(self, req):
        ok = admit(self, req)
        if ok:
            req.out_tokens[0] = (req.out_tokens[0] + 1) % self.cfg.vocab
        return ok
    monkeypatch.setattr(engine.ServeEngine, "try_admit", altered)


def _scaled_logits(monkeypatch):
    from repro_torch.serving import engine

    make = engine.make_prefill_step

    def make_scaled(cfg, *a, **k):
        step = make(cfg, *a, **k)

        def scaled(params, batch):
            logits, cache = step(params, batch)
            return logits * 1.01, cache
        return scaled
    monkeypatch.setattr(engine, "make_prefill_step", make_scaled)


def _plan_off_by_one(monkeypatch):
    from repro_torch.api import strategy

    setup = strategy.cfl.setup

    def one_fewer(*a, fixed_c, **k):
        return setup(*a, fixed_c=fixed_c - 1, **k)
    monkeypatch.setattr(strategy.cfl, "setup", one_fewer)


def _altered_answer(monkeypatch):
    from repro_torch import coded_head_probe

    probe = coded_head_probe.run

    def altered(*a, **k):
        out = probe(*a, **k)
        feats = out["backbone_feats"]
        feats[0, 0, 0] += 0.01 * feats.abs().max()
        return out
    monkeypatch.setattr(coded_head_probe, "run", altered)


# (cell, fault, the number that has to catch it, or None for any)
FAULTS = [("mamba2-1.3b.fedtrain", _frozen_step, None),
          ("mamba2-1.3b.fedtrain", _half_batch, None),
          ("mamba2-1.3b.prefill", _altered_token, "token_gap"),
          ("mamba2-1.3b.prefill", _scaled_logits, "logit_gap"),
          ("granite-8b.coded-head", _altered_answer, None),
          ("granite-8b.coded-head", _plan_off_by_one, "plan_gap")]


@pytest.mark.parametrize("workload,plant,number", FAULTS,
                         ids=[f.__name__.strip("_") for _, f, _ in FAULTS])
def test_planted_fault_reads_not_correct(workload, plant, number,
                                         monkeypatch):
    plant(monkeypatch)
    result = tiny_run(workload, seed=2**31 + 11)
    assert result["correct"] is False
    failed = [n for n, c in result["checks"].items()
              if not c["value"] <= c["limit"]]
    assert failed
    assert number is None or number in failed
