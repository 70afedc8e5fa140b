"""Kernel-family descriptors: what the autotuner can tune.

The counterpart of `repro/tune/families.py`.  A family packages what the
tuner needs to treat one hand-written kernel generically:

  * `name`           — the cache-key family component;
  * `kernel`         — its `roofline.kernel_terms` family;
  * `default_block(shape)` — the tile `block="auto"` falls back to (the
    launch of a wrapper without tiles; for the round gradients (0,), the
    kernel's own partition, which depends on the row count);
  * `candidate_blocks(shape, backend)` — the tiles to search: on
    `cuda-sm90` the tiles the port's CUDA kernels launch with (kernel 2's
    instantiations, each of which the library asserts fits a CTA's
    227 KB of shared memory, the counterpart of the TPU's VMEM budget);
    on `cpu`, where the wrappers compute the plain versions and a tile
    means nothing, the default alone;
  * `bind(shape, block)` — the wrapper with that tile, a function of the
    operands `make_args` returns;
  * `make_args(shape, seed, device)` — operands drawn from an explicit
    `torch.Generator` on `device`.

To add a family: implement these members and register the instance in
`FAMILIES`; `block="auto"` in its wrapper is one `resolve_block` call.
Kernel 3 (the encode with G hashed in the kernel) launches one tile, so
it has no family until it has a second: the reference's "encode_prng"
family tunes how often generator tiles are re-hashed, and the port's
kernel spans 512 columns a CTA pair, hashing each entry once at d <= 511.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.round_grad import ops as rg_ops

# row tiles (rows a CTA owns, multiples of the 8 warps) the round-gradient
# kernels are tuned over, beside the kernel's own partition
ROW_TILES = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


class _RowTileFamily:
    """A round-gradient kernel: one row tile (block_m,), the rows a CTA
    owns, or (0,), the kernel's own partition (`rows_per_cta`, a function
    of the row count: the default, and the first candidate, so that a
    tie keeps it).  A row tile sets only the depth of the warps' rings,
    which the kernel lowers until they fit shared memory, so every tile
    fits at every D."""

    name = kernel = ""

    def default_block(self, shape) -> tuple:
        return (0,)

    def candidate_blocks(self, shape, backend: str) -> list[tuple]:
        default = self.default_block(shape)
        if backend != "cuda-sm90":
            return [default]
        top = -(-int(shape[0]) // rg_ops.WARPS) * rg_ops.WARPS  # one CTA
        return [default] + [(t,) for t in ROW_TILES if t <= top]


class RoundGradFamily(_RowTileFamily):
    """Kernel 1, the masked round gradient g = (w (X beta - y)) X.  The
    coded (kernel 4) and tier-masked (kernel 5) variants resolve against
    the same family and shape (their systematic row streams are the
    flat one's), so one tuned tile serves all three launches."""

    name = kernel = "round_grad"

    def bind(self, shape, block):
        def fn(x, y, w, beta):
            return rg_ops.masked_round_gradient(x, y, w, beta,
                                                block_m=int(block[0]))
        return fn

    def make_args(self, shape, seed: int = 0, device="cuda"):
        m, d = shape
        gen = _generator(seed, device)
        return (torch.randn((m, d), generator=gen, device=device),
                torch.randn((m,), generator=gen, device=device),
                torch.rand((m,), generator=gen, device=device),
                torch.randn((d,), generator=gen, device=device))


class CodedGradFamily(_RowTileFamily):
    """Kernel 6, the least-squares gradient A^T (A beta - y)."""

    name = kernel = "coded_grad"

    def bind(self, shape, block):
        def fn(a, y, beta):
            return rg_ops.lsq_gradient(a, y, beta, block_m=int(block[0]))
        return fn

    def make_args(self, shape, seed: int = 0, device="cuda"):
        m, d = shape
        gen = _generator(seed, device)
        return (torch.randn((m, d), generator=gen, device=device),
                torch.randn((m,), generator=gen, device=device),
                torch.randn((d,), generator=gen, device=device))


class EncodeFamily:
    """Kernel 2, P = G diag(w) X, CTA tile (bc, bd, bl): the
    instantiations of csrc/encode.cu whose shared memory fits a CTA."""

    name = kernel = "encode"

    def default_block(self, shape) -> tuple:
        return enc_ops.DEFAULT_BLOCK

    def candidate_blocks(self, shape, backend: str) -> list[tuple]:
        if backend != "cuda-sm90":
            return [self.default_block(shape)]
        return list(enc_ops.TILES)

    def bind(self, shape, block):
        def fn(g, w, x):
            return enc_ops.encode_parity(g, w, x, block=tuple(block))
        return fn

    def make_args(self, shape, seed: int = 0, device="cuda"):
        c, ell, d = shape
        gen = _generator(seed, device)
        return (torch.randn((c, ell), generator=gen, device=device),
                torch.rand((ell,), generator=gen, device=device),
                torch.randn((ell, d), generator=gen, device=device))


FAMILIES = {f.name: f for f in
            (EncodeFamily(), CodedGradFamily(), RoundGradFamily())}

# The shapes `python -m repro_torch.tune --ci-defaults` tunes on the card
# and commits to `defaults.json`: shapes that the port's driven paths
# launch (chip_smoke.py's phases), not the reference's CPU CI shapes.
# Shapes of one bucket share an entry: the tile whose times, summed over
# the bucket's shapes, are least (`tuner.tune_shapes`).
CI_SHAPES: dict[str, list[tuple]] = {
    "round_grad": [(5632, 500), (7200, 500), (5632, 512), (1200, 256)],
    "coded_grad": [(2016, 500)],
    "encode": [(2016, 300, 501), (2160, 300, 513), (359, 100, 257),
               (3600, 300, 501)],
}
