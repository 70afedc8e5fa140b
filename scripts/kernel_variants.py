"""Build and time variants of a kernel source, for the kernel-variant
timing scripts (`flash_attn_variants.py`, `encode_variants.py`,
`encode_prng_variants.py`, `round_grad_variants.py`).

`build_variants` makes variants of one source of
`src/repro_torch/kernels/csrc/` by replacing lines of it and compiles
them, one `nvcc` per variant through `kernels.build.start_nvcc`, all
started together.  `library_function` opens one entry point of a built
variant with the C signature of its wrapper's table; `opcode_histogram`
counts the SASS opcodes of one of its kernels.  `median_ms` times
a launch with CUDA events around back-to-back launches (on the same
operands, warm in L2, unless the launch rotates over copies), queued
behind a sleep kernel.  `print_card` prints the card's name, power
limit and SM clock.  Needs a CUDA card (sm_90a) and `nvcc`.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402


def build_variants(source: str, variants: dict[str, dict[str, str]],
                   out: Path, every: frozenset[str] = frozenset()
                   ) -> dict[str, tuple[Path, str]]:
    """Compile each variant of `csrc/<source>.cu` into `out`.

    `variants` maps a variant's name to its edits, {text of the source:
    its replacement}.  Each text must occur exactly once in the source,
    except a text in `every`, which is replaced at each of its occurrences
    and must occur at least once; anything else stops the script, so an
    edit never lands on a line it was not written for.  Returns {name:
    (library, its `-Xptxas=-v` log)}.
    """
    text0 = (build.CSRC / f"{source}.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = text0
        for old, new in edits.items():
            n = text.count(old)
            if n == 0 or (n != 1 and old not in every):
                raise RuntimeError(f"{name}: {old!r} occurs {n} times in "
                                   f"{source}.cu")
            text = text.replace(old, new)
        src = out / f"{name}.cu"
        src.write_text(text)
        lib = out / f"lib{name}.so"
        procs[name] = (build.start_nvcc(src, lib), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        libs[name] = (lib, log)
    return libs


def library_function(library: Path, name: str, signatures):
    """Entry point `name` of a built variant, declared with its C
    signature from a wrapper's `_SIGNATURES` table."""
    fn = getattr(ctypes.CDLL(str(library)), name)
    fn.argtypes, fn.restype = signatures[name]
    return fn


def opcode_histogram(library: Path, mangled: str) -> str:
    """The opcodes of the kernel whose mangled name starts with `mangled`
    in `library` (`cuobjdump -sass`), most frequent first, as one line."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    body = sass.split(mangled, 1)[1].split("Function :", 1)[0]
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                     r"(?:\.[\w.]*)?", body)
    counts = {}
    for op in ops:
        counts[op] = counts.get(op, 0) + 1
    return f"{len(ops)} instructions; " + ", ".join(
        f"{op} {n}" for op, n in sorted(counts.items(), key=lambda kv: -kv[1]))


def print_card() -> None:
    """Print the card's name and power limit as `nvidia-smi` gives them,
    and the SM clock a spin kernel runs at: `torch.cuda._sleep` spins a
    given number of clock cycles, timed with CUDA events (median of 5)."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cycles, ghz = 2**22, []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        ghz.append(cycles / start.elapsed_time(end) / 1e6)
    print(f"SM clock under a spin kernel: {statistics.median(ghz)!r} GHz",
          flush=True)


def median_ms(launch, runs: int = 7, calls: int = 20) -> tuple[float, float]:
    """(median, min) over `runs` of the time of one `launch()` in ms, each
    run `calls` launches between two CUDA events behind a sleep kernel."""
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2**24)
        start.record()
        for _ in range(calls):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), min(times)
