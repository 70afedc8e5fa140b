"""Operations and bytes, counted from shapes: the yardstick of the mfu
and roofline metrics.

A frozen copy of the arithmetic of `repro_torch.roofline.analysis`
(`kernel_terms` for kernels 7 and 8) over the H100 SXM data sheet's
rates, with each count unpadded: what the inputs need, not what a padded
launch issues.  Model counts are the products of the forward pass (2
flops a multiply-add) plus the SSD's operations; a training step is three
forward passes' worth (forward, and a backward of twice its products).
Element-wise work is not counted.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # HBM3
FP32_FLOPS_PER_S = 67e12    # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12   # dense TF32 tensor cores
TF32_PRODUCTS = 3           # 3xTF32: three TF32 products a float32 one


def _tri(q: int) -> int:
    return q * (q + 1) // 2


def ssd_chunk_ops(q: int, heads: int, headdim: int, d_state: int,
                  groups: int) -> int:
    """One chunk of q tokens of the SSD's intra-chunk step (kernel 7):
    C B^T once per group over the causal half, then per head the causal
    half of its product with dt x, and the chunk's carried state."""
    tri = _tri(q)
    return (groups * tri * 2 * d_state
            + heads * (tri * 2 * headdim + 2 * q * headdim * d_state))


def ssd_seq_ops(seq: int, chunk: int, heads: int, headdim: int,
                d_state: int, groups: int) -> int:
    """The SSD over one sequence: every chunk's intra-chunk step (the last
    one partial, unpadded) and, past the first chunk, each position's
    read of the carried-in state (2 P N a head)."""
    full, rest = divmod(seq, chunk)
    ops = full * ssd_chunk_ops(chunk, heads, headdim, d_state, groups)
    if rest:
        ops += ssd_chunk_ops(rest, heads, headdim, d_state, groups)
    return ops + max(seq - chunk, 0) * heads * 2 * headdim * d_state


def ssd_kernel_terms(seq: int, chunk: int, heads: int, headdim: int,
                     d_state: int, groups: int) -> dict:
    """Kernel 7's least work over one sequence of `seq` tokens: its
    operations on the 3xTF32 route, and its bytes (x, dt, dA and y a
    token and head; B and C a token and group; one state a chunk and
    head), each read or written once."""
    nc = -(-seq // chunk)
    full, rest = divmod(seq, chunk)
    flops = full * ssd_chunk_ops(chunk, heads, headdim, d_state, groups)
    if rest:
        flops += ssd_chunk_ops(rest, heads, headdim, d_state, groups)
    nbytes = 4 * (seq * heads * (2 * headdim + 2) + 2 * seq * groups * d_state
                  + nc * heads * headdim * d_state)
    return _terms(flops, nbytes)


def attention_kernel_terms(batch: int, hq: int, hkv: int, seq: int,
                           d: int) -> dict:
    """Kernel 8's least work: the causal half of Q K^T and of P V for
    every query head; Q and O a query head, K and V a key/value head,
    each read or written once."""
    flops = 4 * batch * hq * d * _tri(seq)
    nbytes = 4 * (2 * batch * hq * seq * d + 2 * batch * hkv * seq * d)
    return _terms(flops, nbytes)


def _terms(flops: float, nbytes: float) -> dict:
    t_ops = TF32_PRODUCTS * flops / TF32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"flops": float(flops), "bytes": float(nbytes),
            "least_s": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ssm_layer_matmul_ops(model: dict) -> int:
    """Products of one Mamba2 layer, one token: in and out projections."""
    s, d = model["ssm"], model["d_model"]
    heads = s["expand"] * d // s["headdim"]
    inner = heads * s["headdim"]
    in_w = 2 * inner + 2 * s["n_groups"] * s["d_state"] + heads
    return 2 * d * in_w + 2 * inner * d


def dense_layer_matmul_ops(model: dict, seq: int) -> float:
    """Products of one dense layer, one token of a sequence of `seq`:
    Q, K, V, O and the SwiGLU MLP, and the causal attention's two
    products averaged over the sequence's positions."""
    d, ff = model["d_model"], model["d_ff"]
    hd = model.get("head_dim") or d // model["n_heads"]
    q_w, kv_w = model["n_heads"] * hd, model["n_kv_heads"] * hd
    proj = 2 * d * (2 * q_w + 2 * kv_w) + 2 * 3 * d * ff
    attn = 4 * model["n_heads"] * hd * _tri(seq) / seq
    return proj + attn


def forward_ops(model: dict, batch: int, seq: int,
                logits_rows: int | None = None) -> float:
    """Operations of one forward pass over (batch, seq) tokens, with the
    output head over `logits_rows` rows (default every token; 0 for a
    backbone's hidden states)."""
    tokens = batch * seq
    rows = tokens if logits_rows is None else logits_rows
    head = 2 * model["d_model"] * model["vocab"] * rows
    if model["arch_type"] == "ssm":
        s = model["ssm"]
        heads = s["expand"] * model["d_model"] // s["headdim"]
        per_layer = (tokens * ssm_layer_matmul_ops(model)
                     + batch * ssd_seq_ops(seq, s["chunk"], heads,
                                           s["headdim"], s["d_state"],
                                           s["n_groups"]))
        return model["n_layers"] * per_layer + head
    if model["arch_type"] == "dense":
        return (model["n_layers"] * tokens
                * dense_layer_matmul_ops(model, seq) + head)
    raise ValueError(f"no operation count for {model['arch_type']!r}")


def train_ops(model: dict, batch: int, seq: int) -> float:
    """One training step: forward, and a backward of twice its work."""
    return 3 * forward_ops(model, batch, seq)
