"""CFL on a deep model: exact coded training of a linear readout head on
frozen-backbone features (the counterpart of
`examples/coded_head_probe.py`, the bridge between the paper's
linear-regression technique and the assigned architectures).

A granite-8b backbone (full width and depth by default, 36 layers at
d_model 4096 in float32; `--reduced` for the CPU) embeds each client's
token sequences; each sequence's mean-pooled final hidden state is one
row of its client's regression data; the full CFL protocol (redundancy
optimisation, private parity upload, deadline-clipped epochs) then
trains the head, against the uncoded baseline that waits for every
straggler.

    PYTHONPATH=src python -m repro_torch.coded_head_probe
        [--reduced] [--epochs 300] [--seed 0] [--device cuda]

The weights, the tokens, the true head and the label noise are drawn from
a `torch.Generator` seeded `--seed` on the chosen device (another stream
on the card than on the CPU for one seed).  The backbone runs under
`torch.no_grad()` on all 12 x 64 sequences in one batch, its causal
attention through kernel 8 on the card; the coded head encodes each
client's parity through kernel 2 and takes each epoch's round gradient
through kernel 1 at D = d_model.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import coding_gain
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.fed import extract_features, train_coded_head
from repro_torch.models import transformer as T
from repro_torch.sim.network import paper_fleet

ARCH = "granite-8b"
N_CLIENTS, ELL, SEQ = 12, 64, 32
LR, EPOCHS, KEY_SEED = 0.05, 300, 4
FIXED_C = int(0.3 * N_CLIENTS * ELL)  # 230 parity rows
NOISE = 0.1


def probe_features(cfg, params: dict, tokens: torch.Tensor,
                   use_kernel: bool = True) -> torch.Tensor:
    """Mean-pooled final hidden states of the frozen backbone (the
    reference example's `feats_one`): tokens (n, ell, seq) -> (n, ell,
    d_model) float32, all n * ell sequences in one batch, no gradient
    recorded."""
    seq = tokens.shape[-1]

    def backbone(toks: torch.Tensor) -> torch.Tensor:  # (rows, seq)
        x = T._embed(cfg, params, toks, torch.float32)
        positions = torch.arange(seq, device=toks.device)[None, :].expand(
            toks.shape[0], seq)
        x, _ = T._run_backbone(cfg, params, x, positions, {},
                               use_kernel=use_kernel)
        return torch.mean(x, dim=1)

    with torch.no_grad():
        return extract_features(backbone, tokens, batched=True)


def normalise(feats: torch.Tensor) -> torch.Tensor:
    """Features over their (population) standard deviation, as the
    reference example scales them."""
    return feats / (torch.std(feats, correction=0) + 1e-6)


def gain_target(uncoded) -> float:
    """The NMSE the coding gain is timed to: the reference example's five
    times the uncoded head's final NMSE, or, where that is not below the
    starting NMSE, the midpoint of the uncoded head's first and final
    NMSE.  The second case is the full-width head: 4096 features over 768
    rows leave it underdetermined, its NMSE to the true head stays near
    1, and both arms would meet the example's target at t = 0, a 0 / 0
    that `coding_gain` (the reference's expression) raises on."""
    target = 5 * uncoded.final_nmse()
    if target < uncoded.nmse[0]:
        return target
    return 0.5 * (float(uncoded.nmse[0]) + uncoded.final_nmse())


def run(arch: str = ARCH, reduced: bool = False, epochs: int = EPOCHS,
        device=None, seed: int = 0, params: dict | None = None,
        tokens: torch.Tensor | None = None,
        beta_true: torch.Tensor | None = None,
        noise: torch.Tensor | None = None) -> dict:
    """Extract the features and train both heads; returns the config,
    the parameters and tokens, the backbone's features and their
    normalised copy, the targets, the fleet, the reports ({"uncoded",
    "cfl"}), the NMSE target (`gain_target`) and coding gain, and the
    host seconds of each phase (each ending in a device sync).
    `params`, `tokens` (n, ell, seq), `beta_true` (d_model,) and `noise`
    (n, ell) replace the seeded draws where given (the CPU tests hand
    both packages the same ones)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    gen = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = T.init_params(cfg, gen, device=dev)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab, (N_CLIENTS, ELL, SEQ),
                               generator=gen, device=dev)
    lap("draw")
    raw = probe_features(cfg, params, tokens)
    feats = normalise(raw)
    lap("features")

    n, ell, d = feats.shape
    if beta_true is None:
        beta_true = torch.randn((d,), generator=gen, device=dev)
    if noise is None:
        noise = torch.randn((n, ell), generator=gen, device=dev)
    ys = torch.einsum("nld,d->nl", feats, beta_true) + NOISE * noise
    fleet = paper_fleet(0.2, 0.2, seed=0, n=n, d=d)
    out = train_coded_head(fleet, None, feats, ys, beta_true, lr=LR,
                           epochs=epochs, key=KEY_SEED,
                           rng=np.random.default_rng(0),
                           fixed_c=int(0.3 * n * ell))
    lap("heads")
    target = gain_target(out["uncoded"])
    return {"cfg": cfg, "params": params, "tokens": tokens,
            "backbone_feats": raw, "feats": feats, "ys": ys,
            "beta_true": beta_true, "fleet": fleet, "reports": out,
            "target": target,
            "gain": coding_gain(out["uncoded"], out["cfl"], target),
            "seconds": seconds}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced width and depth (CPU)")
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    out = run(args.arch, args.reduced, args.epochs, args.device, args.seed)
    cfg, rep = out["cfg"], out["reports"]
    print(f"backbone {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}; features {tuple(out['feats'].shape)} on "
          f"{out['feats'].device}")
    print(f"uncoded head: NMSE {rep['uncoded'].final_nmse():.3e} "
          f"in {rep['uncoded'].times[-1]:.0f}s")
    print(f"coded head:   NMSE {rep['cfl'].final_nmse():.3e} "
          f"in {rep['cfl'].times[-1]:.0f}s")
    print(f"coding gain (to NMSE {out['target']:.1e}): {out['gain']:.2f}x")
    print("host seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["seconds"].items()))
    return out


if __name__ == "__main__":
    main()
