"""Weights made from the seed on the device, and the port's config for a
configuration file.

All random leaves are views into one float32 buffer drawn by a single
`torch.randn` call from a generator on the device, each view scaled in
place: one large draw, not one a leaf, and nothing made on the host."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cfl_bench import spec

SEED_MASK = 2**63 - 1


def generator(seed: int, device: torch.device, stream: int = 0
              ) -> torch.Generator:
    """A generator on `device` for `seed`; `stream` picks one of several
    independent draws of one run (weights 0, inputs 1, ...)."""
    state = np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & SEED_MASK)


def make_params(family: str, model: dict, seed: int,
                device: torch.device) -> dict:
    """The parameter tree of `model` (nested dicts, the port's keys) in
    float32 on `device`, drawn from `seed`."""
    leaves = spec.family(family).leaves(model)
    total = sum(_numel(shape) for _, shape, init in leaves
                if init[0] == "normal")
    flat = torch.randn(total, generator=generator(seed, device),
                       dtype=torch.float32, device=device)
    tree: dict = {}
    offset = 0
    for path, shape, init in leaves:
        if init[0] == "normal":
            n = _numel(shape)
            leaf = flat[offset:offset + n].view(shape).mul_(init[1])
            offset += n
        elif init[0] == "ones":
            leaf = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            leaf = torch.zeros(shape, device=device)
        elif init[0] == "log_linspace":
            row = torch.log(torch.linspace(init[1], init[2], shape[-1],
                                           device=device))
            leaf = row.expand(shape).clone()
        else:
            raise ValueError(f"unknown init {init!r} of {path}")
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def flat_leaves(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += flat_leaves(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def program_config(name: str, model: dict):
    """The port's registered config `name` with the file's "model" entries
    in place of its own, field by field: the run uses what the file
    states.  Where the two differ, the run's config is registered with the
    port as `<name>.bench` (the coded-head probe looks its model up by
    name).  A key the port's config has no field for raises."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    repl = {}
    for key, want in model.items():
        if not hasattr(cfg, key):
            raise ValueError(f"config {name}: the port's config has no "
                             f"field {key!r}")
        got = getattr(cfg, key)
        if isinstance(want, dict):
            have = dataclasses.asdict(got) if got is not None else {}
            if set(want) - set(have):
                raise ValueError(f"config {name}: the port's {key} has no "
                                 f"field {sorted(set(want) - set(have))}")
            if any(have[k] != v for k, v in want.items()):
                repl[key] = dataclasses.replace(got, **want)
        elif got != want:
            repl[key] = want
    if not repl:
        return cfg
    return registered(dataclasses.replace(cfg, name=f"{name}.bench", **repl))


def registered(cfg):
    """`cfg`, registered with the port under its name unless an equal
    config of that name is there already."""
    from repro_torch.configs import get_config, register

    try:
        have = get_config(cfg.name)
    except KeyError:
        return register(cfg)
    if have != cfg:
        raise ValueError(f"the port already registers another {cfg.name}")
    return have


def check_tree(family: str, model: dict, cfg) -> None:
    """Raise unless the family's leaves for `model` have the keys and
    shapes of the port's own parameter tree for `cfg` (its init on the
    meta device).  The tests hold every configuration to it; a run does
    not, since the port's init on the meta device takes some 12 s of
    imports the first time."""
    from repro_torch.models import transformer as T

    want = {p: tuple(v.shape) for p, v in
            flat_leaves(T.init_params(cfg, None, device="meta"))}
    have = {p: tuple(int(n) for n in shape)
            for p, shape, _ in spec.family(family).leaves(model)}
    if want != have:
        raise ValueError(f"{cfg.name}: the benchmark's parameter tree "
                         f"differs from the port's: {sorted(set(want) ^ set(have))} "
                         f"{[p for p in want if p in have and want[p] != have[p]]}")
