"""3xTF32 tensor-core arithmetic emulated in plain torch on the CPU: the
helpers that kernel 8's (`test_torch_flash_attn.py`) and kernel 2's
(`test_torch_encode_tf32.py`) arithmetic tests share.

  * `rna_tf32`: float32 rounded to TF32 as `cvt.rna.tf32.f32` and
    `csrc/mma_tf32.cuh`'s `tf32::rna` round it;
  * `split_tf32`: x = big + small, both TF32 (`tf32::split`);
  * `toward_zero`: a float64 sum rounded to float32 toward zero, as a
    tensor core truncates its sums (the worse of the two roundings);
  * `product3`: acc + a @ b as `tf32::mma3` forms it over k-steps of 8.
"""
import torch


def rna_tf32(x):
    """float32 `x` rounded to TF32 as `cvt.rna.tf32.f32` rounds it (to
    nearest, ties away from zero): 0x1000 added to the bits, the low 13
    cleared."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    big = rna_tf32(x)
    return big, rna_tf32(x - big)


def toward_zero(x64):
    """float64 `x64` rounded to float32 toward zero, as a tensor core
    truncates its sums (the worse of the two roundings)."""
    x32 = x64.float()
    over = x32.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)),
                       x32)


def product3(a, b, acc, split=True):
    """acc + a @ b as `tf32::mma3` forms it over k-steps of 8: in each,
    small.big, big.small, big.big, each an exact sum of exact products
    added to the float32 accumulator and truncated (split=False: big.big
    alone, plain TF32).  Each operand element is split once."""
    (a_big, a_small), (b_big, b_small) = split_tf32(a), split_tf32(b)
    terms = (((a_small, b_big), (a_big, b_small)) if split else ()) + (
        (a_big, b_big),)
    for kk in range(0, a.shape[-1], 8):
        ka, kb = (..., slice(kk, kk + 8)), (..., slice(kk, kk + 8),
                                            slice(None))
        for x, y in terms:
            acc = toward_zero(acc.double()
                              + x[ka].double() @ y[kb].double())
    return acc
