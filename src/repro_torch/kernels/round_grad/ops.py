"""Wrappers of the round-gradient CUDA kernels (`csrc/round_grad.cu`).

Three kernels, one per TPU kernel of `repro.kernels.round_grad`: the flat
masked round gradient, the coded (systematic + parity rows in one
launch) and the tier-masked ((T, D) tier partials from one pass over X);
and the least-squares gradient of `repro.kernels.coded_grad`, which is
the flat one at w = 1 behind a C entry point of its own
(`kernels.coded_grad` re-exports it).  CPU tensors take the plain
versions (`ref.py`); CUDA tensors launch the kernel on the current
stream or raise.  There is no fallback from a CUDA tensor to a plain
version, and a CUDA call with an operand that requires grad raises (the
kernels have no backward; `common.refuse_grad`).  Each kernel has its own launch counter: `COUNTER` (flat),
`CODED_COUNTER`, `TIER_COUNTER`, `LSQ_COUNTER`.  Each launch sums its
CTAs' float64 partials itself, in a fixed order, behind a ticket counter
and a generation word: two zeroed int32 per (device, stream); every
launch leaves the counter at 0.  The kernels sum in float64 and round
once to float32.  They take any D, by the route `route` states: up to
the widest D whose whole rows fit the CTA's ring (3220) the row-resident
launch; past it, up to 16 column chunks of 512 (D <= 8192; the coded
kernel to D <= 4096), one launch over thread-block clusters along D
that reads X once; wider, a residual pass into a float64 (M,) scratch
before the column-chunked launch (the only route that takes the
scratch).

Row tiles: each wrapper takes `block_m`, the rows a CTA owns (a positive
multiple of 8, the CTA's warps), or 0 for the kernel's own partition
(`rows_per_cta`).  `block_m="auto"` (the default) reads
the tune cache (`repro_torch.tune`): the three round-gradient variants
resolve against the family "round_grad" at the systematic block's
`(m, d)`, so the flat, coded and tiered launches of one workload share a
tile (T = 1 stays bit-equal to flat, a sweep lane to its solo run), and
`lsq_gradient` against "coded_grad" at `(m, d)`.  A cold miss passes 0,
bit for bit the launch of a wrapper without tiles.  The coded kernel uses a given tile for both
of its row blocks.  On the CPU the tile means nothing and is ignored.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (AUTO, LaunchCounter,
                                        check_cuda_operand, on_card,
                                        refuse_grad, resolve_block)

from . import ref

COUNTER = LaunchCounter()
CODED_COUNTER = LaunchCounter()
TIER_COUNTER = LaunchCounter()
LSQ_COUNTER = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES: build.Signatures = {
    "rg_masked_round_gradient": ([_P] * 7 + [_I, _I, _I, _P, _P], _I),
    "rg_tier_round_gradient": ([_P] * 4 + [_I] + [_P] * 4
                               + [_I, _I, _I, _P, _P], _I),
    "rg_coded_round_gradient": ([_P] * 3 + [_I] + [_P] * 3 + [_I]
                                + [_P] * 4 + [_I, _I, _P, _P], _I),
    "rg_lsq_gradient": ([_P] * 6 + [_I, _I, _I, _P, _P], _I),
    "rg_num_ctas": ([_I], _I),
    "rg_residual_rows": ([_I, _I], _I),
    "rg_route": ([_I, _I], _I),
    "rg_cluster_capacity": ([_I, _I, _I], _I),
}

# the CTA's warps (a row tile is a multiple of them) and the CTAs the
# kernels' own partition aims at (csrc/round_grad.cu: kWarps, kTargetCtas)
WARPS = 8
TARGET_CTAS = 128
# the routes past the row-resident width (csrc/round_grad.cu:
# resident_max_d(), kChunk, kMaxCluster, kPortableCluster)
RESIDENT_MAX_D = 3220
CHUNK = 512
MAX_CLUSTER = 16
PORTABLE_CLUSTER = 8
ROUTES = ("resident", "cluster", "two_launch")  # rg_route's 0, 1, 2


def route(d: int, coded: bool = False) -> str:
    """How a call over D columns runs on the card, a pure function of D
    and the variant (`coded`: the coded kernel), mirrored by the
    library's `rg_route`:

    * "resident": D <= 3220, whole rows in each warp's ring;
    * "cluster": up to 16 column chunks of 512 (D <= 8192; the coded
      kernel up to 8, D <= 4096), one launch of clusters of
      ceil(D / 512) CTAs along D that reads X once (a cluster past 8
      CTAs is a non-portable size, which the H100 runs);
    * "two_launch": wider, the residual pass into a float64 (M,) scratch
      and the column-chunked launch.

    The coded kernel's bound is 8 chunks because at 768 + 230 rows and
    D = 8192 its clusters of 16 ran slower than the two-launch route on
    an H100 (the card holds 7 such clusters at once; the two blocks take
    8).  Tier count and alignment choose no route: more than four tiers
    run in launches of four on every route, and a view that is not
    16-byte aligned (or D % 4 != 0) takes each route's 4-byte copies."""
    if d <= RESIDENT_MAX_D:
        return "resident"
    chunks = -(-d // CHUNK)
    return "cluster" if chunks <= (PORTABLE_CLUSTER if coded
                                   else MAX_CLUSTER) else "two_launch"


def rows_per_cta(m: int) -> int:
    """Rows a CTA owns in the kernels' own partition: ~m / 128 rounded up
    to a multiple of the 8 warps, at least 8 (`rows_per_cta` of
    csrc/round_grad.cu at tile 0, the partition block_m=0 launches)."""
    r = -(-m // TARGET_CTAS)
    return max(WARPS, -(-r // WARPS) * WARPS)


def _tile(family: str, x: torch.Tensor, block_m) -> int:
    """The row tile a launch over x takes: `block_m` resolved against the
    tune cache at x's (m, d) and checked; 0 for the kernel's own
    partition."""
    tile = resolve_block(family, tuple(x.shape), block_m, 0, x.device)
    if isinstance(tile, (tuple, list)):  # a family's (block_m,)
        (tile,) = tile
    tile = int(tile)
    if tile < 0 or tile % WARPS:
        raise ValueError(f"block_m must be 0 or a positive multiple of "
                         f"{WARPS}, got {tile}")
    return tile


def _n_ctas(lib, rows: int, tile: int) -> int:
    """CTAs (float64 partials) over `rows` rows at `tile`."""
    return lib.rg_num_ctas(rows) if tile == 0 else max(1, -(-rows // tile))


def _residuals(rows: int, d: int, device: torch.device,
               coded: bool = False):
    """The float64 row-coefficient scratch of a launch over `rows` rows at
    this D: (rows,) on the two-launch route (the kernel then runs its
    residual pass first), else None."""
    if route(d, coded=coded) != "two_launch" or rows == 0:
        return None
    return torch.empty(rows, dtype=torch.float64, device=device)


def _dispatch(device: torch.device):
    """The loaded kernel library for `device`, or None for the CPU.

    CUDA devices get the library (a failed build raises `BuildFailure`);
    any other device type raises."""
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"no round_grad kernel for device {device}")
    return build.load("round_grad", _SIGNATURES)


def _check_rows(lib, x: torch.Tensor, y: torch.Tensor,
                w: torch.Tensor | None, beta: torch.Tensor,
                name: str = "x") -> tuple[int, int]:
    """Check one row block (x (M, D), y/w (M,), beta (D,)); return M, D."""
    if x.dim() != 2:
        raise ValueError(
            f"{name} must be (M, D), got shape {tuple(x.shape)}")
    m, d = x.shape
    check_cuda_operand(name, x, (m, d), x.device)
    check_cuda_operand(f"y of {name}", y, (m,), x.device)
    check_cuda_operand("beta", beta, (d,), x.device)
    if w is not None:
        check_cuda_operand(f"w of {name}", w, (m,), x.device)
    return m, d


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# the in-launch reduce's (ticket counter, generation), one pair per
# (device, stream)
_TICKETS: dict[tuple[str, int], torch.Tensor] = {}


def _ticket(device: torch.device) -> int:
    """Address of the (ticket counter, generation) pair of `device`'s
    current stream: two int32 zeroed once, on first use; every launch
    leaves the counter at 0, and calls on two streams never share one."""
    key = (str(device), _stream(device))
    counter = _TICKETS.get(key)
    if counter is None:
        counter = _TICKETS[key] = torch.zeros(2, dtype=torch.int32,
                                              device=device)
    return counter.data_ptr()


def masked_round_gradient(x: torch.Tensor, y: torch.Tensor,
                          w: torch.Tensor | None, beta: torch.Tensor,
                          block_m=AUTO) -> torch.Tensor:
    """g = (w * (X beta - y)) @ X in one pass over X; w=None means w = 1.

    x: (M, D), y/w: (M,), beta: (D,), all float32 -> (D,) float32.
    block_m: the row tile (see the module docstring).
    """
    lib = _dispatch(x.device)
    if lib is None:
        return ref.masked_round_gradient(x, y, w, beta)
    refuse_grad("masked_round_gradient", x, y, w, beta)
    m, d = _check_rows(lib, x, y, w, beta)
    tile = _tile("round_grad", x, block_m)
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    if d == 0:
        return out
    res = _residuals(m, d, x.device)
    partials = torch.empty((_n_ctas(lib, m, tile), d), dtype=torch.float64,
                           device=x.device)
    with on_card(x.device):
        status = lib.rg_masked_round_gradient(
            x.data_ptr(), y.data_ptr(), _ptr(w), beta.data_ptr(),
            partials.data_ptr(), out.data_ptr(), _ticket(x.device), m, d, tile,
            _ptr(res), _stream(x.device))
    build.check_status(lib, status, "masked_round_gradient")
    COUNTER.add((tile,))
    return out


def lsq_gradient(a: torch.Tensor, y: torch.Tensor, beta: torch.Tensor,
                 block_m=AUTO) -> torch.Tensor:
    """g = A^T (A beta - y) in one pass over A (the least-squares gradient).

    a: (M, D), y: (M,), beta: (D,), all float32 -> (D,) float32.  The
    kernel is the flat one's one-tier instance with no weights, so the
    result is bit-equal to `masked_round_gradient(a, y, None, beta)` at
    the same row tile.  block_m="auto" resolves against the family
    "coded_grad".
    """
    lib = _dispatch(a.device)
    if lib is None:
        return ref.lsq_gradient(a, y, beta)
    refuse_grad("lsq_gradient", a, y, beta)
    m, d = _check_rows(lib, a, y, None, beta, name="a")
    tile = _tile("coded_grad", a, block_m)
    out = torch.empty(d, dtype=torch.float32, device=a.device)
    if d == 0:
        return out
    res = _residuals(m, d, a.device)
    partials = torch.empty((_n_ctas(lib, m, tile), d), dtype=torch.float64,
                           device=a.device)
    with on_card(a.device):
        status = lib.rg_lsq_gradient(
            a.data_ptr(), y.data_ptr(), beta.data_ptr(), partials.data_ptr(),
            out.data_ptr(), _ticket(a.device), m, d, tile, _ptr(res),
            _stream(a.device))
    build.check_status(lib, status, "lsq_gradient")
    LSQ_COUNTER.add((tile,))
    return out


def coded_round_gradient(x: torch.Tensor, y: torch.Tensor,
                         w: torch.Tensor | None, x_par: torch.Tensor,
                         y_par: torch.Tensor, w_par, beta: torch.Tensor,
                         block_m=AUTO) -> torch.Tensor:
    """g_sys + g_par = (w * (X beta - y)) @ X + (w_par * (X~ beta - y~)) @ X~
    in one launch over both row blocks.

    x: (M, D), y/w: (M,), x_par: (C, D), y_par: (C,), w_par: (C,) or a
    scalar (0-d tensor or number, broadcast over the parity rows), beta:
    (D,), all float32 -> (D,) float32.  An empty parity block (C == 0)
    runs the flat masked kernel instead, as the reference does.  The row
    tile resolves at the systematic block's (M, D) and, given, serves
    both blocks.
    """
    if x_par.shape[0] == 0:
        return masked_round_gradient(x, y, w, beta, block_m=block_m)
    w_par = torch.broadcast_to(
        torch.as_tensor(w_par, dtype=y_par.dtype, device=y_par.device),
        y_par.shape).contiguous()
    lib = _dispatch(x.device)
    if lib is None:
        return ref.coded_round_gradient(x, y, w, x_par, y_par, w_par, beta)
    refuse_grad("coded_round_gradient", x, y, w, x_par, y_par, w_par, beta)
    m, d = _check_rows(lib, x, y, w, beta)
    c, _ = _check_rows(lib, x_par, y_par, w_par, beta, name="x_par")
    if x_par.shape[1] != d:
        raise ValueError(f"x_par has D={x_par.shape[1]}, x has D={d}")
    tile = _tile("round_grad", x, block_m)
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    if d == 0:
        return out
    n_parts = _n_ctas(lib, m, tile) + _n_ctas(lib, c, tile)
    res = _residuals(m + c, d, x.device, coded=True)
    partials = torch.empty((n_parts, d), dtype=torch.float64,
                           device=x.device)
    with on_card(x.device):
        status = lib.rg_coded_round_gradient(
            x.data_ptr(), y.data_ptr(), _ptr(w), m, x_par.data_ptr(),
            y_par.data_ptr(), w_par.data_ptr(), c, beta.data_ptr(),
            partials.data_ptr(), out.data_ptr(), _ticket(x.device), d, tile,
            _ptr(res), _stream(x.device))
    build.check_status(lib, status, "coded_round_gradient")
    CODED_COUNTER.add((tile,))
    return out


def tier_masked_round_gradient(x: torch.Tensor, y: torch.Tensor,
                               w: torch.Tensor | None,
                               tier_masks: torch.Tensor, beta: torch.Tensor,
                               block_m=AUTO) -> torch.Tensor:
    """(T, D) tier partials, partial[t] = ((w * mask_t) * (X beta - y)) @ X,
    with one pass over X shared by all T tiers; w=None means w = 1.

    x: (M, D), y/w: (M,), tier_masks: (T, M), beta: (D,), all float32.
    At T = 1 with an all-ones mask the result is bit-equal to
    `masked_round_gradient` at the same row tile (one kernel body, the
    same row ranges and reduction order, and w * 1.0 is exact).
    """
    lib = _dispatch(x.device)
    if lib is None:
        return ref.tier_masked_round_gradient(x, y, w, tier_masks, beta)
    refuse_grad("tier_masked_round_gradient", x, y, w, tier_masks, beta)
    m, d = _check_rows(lib, x, y, w, beta)
    if tier_masks.dim() != 2 or tier_masks.shape[0] < 1:
        raise ValueError(
            f"tier_masks must be (T, M), T >= 1, got shape "
            f"{tuple(tier_masks.shape)}")
    nt = int(tier_masks.shape[0])
    check_cuda_operand("tier_masks", tier_masks, (nt, m), x.device)
    tile = _tile("round_grad", x, block_m)
    out = torch.empty((nt, d), dtype=torch.float32, device=x.device)
    if d == 0:
        return out
    res = _residuals(m, d, x.device)
    partials = torch.empty((nt, _n_ctas(lib, m, tile), d),
                           dtype=torch.float64, device=x.device)
    with on_card(x.device):
        status = lib.rg_tier_round_gradient(
            x.data_ptr(), y.data_ptr(), _ptr(w), tier_masks.data_ptr(), nt,
            beta.data_ptr(), partials.data_ptr(), out.data_ptr(),
            _ticket(x.device), m, d, tile, _ptr(res), _stream(x.device))
    build.check_status(lib, status, "tier_masked_round_gradient")
    TIER_COUNTER.add((tile,))
    return out
