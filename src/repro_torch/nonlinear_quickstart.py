"""Non-linear quickstart: CodedFedL kernel classification end to end.

The counterpart of `examples/nonlinear_quickstart.py`: a small
multi-access-edge fleet, a classification problem whose decision regions
are non-linear (an RBF-network teacher), CodedFedL's shared
random-Fourier-feature map, the MEC load allocation, and the coded
one-vs-rest head trained through the Strategy/Session API — then the head
against the best linear model on held-out data.

    PYTHONPATH=src python -m repro_torch.nonlinear_quickstart
        [--epochs 300] [--device cuda]

The data and the feature map come from `torch.Generator`s on the chosen
device (another stream on the card than on the CPU for the same seeds).
The parity encode goes through kernel 2 and each epoch's round gradient
through kernel 1 on the card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import Session, TrainData, make_strategy
from repro_torch.data import classification_dataset, one_vs_rest_targets
from repro_torch.device import resolve_device
from repro_torch.fed import head_accuracy, reference_head
from repro_torch.sim.network import wireless_fleet

N, ELL, ELL_TEST, D_RAW, D_FEAT = 12, 100, 50, 6, 256
TEACHER_GAMMA = 2.0
LR = 0.5
DATA_SEED, KEY_SEED = 2, 7
FIXED_C = int(0.3 * N * ELL)


def best_linear_accuracy(xs_tr, y_tr, xs_te, y_te) -> float:
    """Held-out accuracy of the closed-form least-squares head on the raw
    inputs with a bias column: the best any linear model can do."""
    d = xs_tr.shape[-1]
    x_tr = xs_tr.cpu().numpy().astype(np.float64).reshape(-1, d)
    x_te = xs_te.cpu().numpy().astype(np.float64).reshape(-1, d)
    b, *_ = np.linalg.lstsq(
        np.c_[x_tr, np.ones(len(x_tr))],
        y_tr.cpu().numpy().astype(np.float64).reshape(-1), rcond=None)
    pred = np.c_[x_te, np.ones(len(x_te))] @ b
    return float(np.mean((pred > 0) == (y_te.cpu().numpy().reshape(-1) > 0)))


def run(epochs: int = 300, device=None) -> dict:
    """Plan and train the coded kernel head; returns the fleet, data,
    strategy, state, report, held-out features and labels, both
    accuracies and the host seconds of each phase (each ending in a
    device sync)."""
    dev = resolve_device(device)
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    fleet = wireless_fleet(0.3, 0.3, nu_erasure=0.3, seed=0, n=N, d=D_FEAT)
    # non-linear classification data, split train / held-out per client
    xs, labels = classification_dataset(
        torch.Generator(device=dev).manual_seed(DATA_SEED), N,
        ELL + ELL_TEST, D_RAW, n_classes=2, centers=32, gamma=TEACHER_GAMMA)
    ys = one_vs_rest_targets(labels, 1)          # ±1 one-vs-rest targets
    xs_tr, xs_te = xs[:, :ELL].contiguous(), xs[:, ELL:].contiguous()
    y_tr, y_te = ys[:, :ELL].contiguous(), ys[:, ELL:].contiguous()

    # RFF kernel regression through the coded linear machinery, planned
    # under the MEC shifted-exponential delay model
    strategy = make_strategy("codedfedl", key_seed=KEY_SEED, d_feat=D_FEAT,
                             rff_gamma=TEACHER_GAMMA / D_RAW,
                             fixed_c=FIXED_C, use_kernel=True)
    # feature-space reference head (what the NMSE trace measures against)
    data = TrainData(xs=xs_tr, ys=y_tr,
                     beta_true=reference_head(strategy, xs_tr, y_tr))
    lap("data")

    session = Session(strategy=strategy, fleet=fleet, lr=LR, epochs=epochs,
                      device=dev)
    state = session.plan(data)
    lap("plan")
    report = session.run(data, rng=np.random.default_rng(0), state=state)
    lap("coded_run")

    # held-out accuracy of the trained head vs the best linear model
    acc = head_accuracy(strategy, report.beta, xs_te, y_te)
    acc_lin = best_linear_accuracy(xs_tr, y_tr, xs_te, y_te)
    return {"fleet": fleet, "data": data, "strategy": strategy,
            "state": state, "report": report, "xs_te": xs_te, "y_te": y_te,
            "accuracy": acc, "linear_accuracy": acc_lin,
            "seconds": seconds}


def main(epochs: int = 300, device=None) -> None:
    print("=== CodedFedL non-linear quickstart (PyTorch) ===")
    out = run(epochs, device)
    plan, report = out["state"].plan, out["report"]
    print(f"plan: c={plan.c} t*={plan.t_star:.2f}s "
          f"(MEC delay model, d_feat={D_FEAT})")
    print(f"\ncoded kernel head: NMSE {report.final_nmse():.3f} to the "
          f"kernel regressor after {report.times[-1]:.0f}s simulated")
    print(f"held-out accuracy: kernel {out['accuracy']:.3f} vs best-linear "
          f"{out['linear_accuracy']:.3f}")
    assert out["accuracy"] > out["linear_accuracy"], \
        "kernel head should beat the linear ceiling"


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    main(**vars(ap.parse_args()))
