"""Where the vlm's float32 backward departs from the float64 one, block
by block, in the port and in the JAX package.

    PYTHONPATH=src python scripts/vlm_grad_shares.py

The input of `tests/test_torch_vlm_audio.py::
test_forward_loss_and_gradients_match_jax`: the reduced
llama-3.2-vision-11b at 6 layers with cross_every 3 (two groups of two
self blocks and one gated cross block), 16 patches of d_vision 192,
JAX's `init_params(PRNGKey(0))` with every gate 0.5 + U(0, 1)
(`default_rng(7)`), tokens `default_rng(0).integers(0, 512, (2, 13))`,
patches 0.1 x N(0, 1) from `default_rng(1)`, on the CPU.

Prints, as shares of `tests/test_torch_train.py`'s bound (rtol 1e-4 /
atol 1e-6 * max(1, max|ref|)):
  1. the cotangent of the loss at the input of every block (the head
     first), port float32 and reference float32 against the reference's
     float64, and port against reference float32;
  2. each block's own backward: its VJP on the same float32 input and the
     float64 cotangent at its output, rounded to float32;
  3. the same for the parts of the first self block (its attention half,
     its MLP half, its attention norm and its attention core alone);
  4. the embedding leaf of the whole gradient, as the test computes it
     (`launch.steps.value_and_grad` of `loss_fn` against the jitted
     `jax.value_and_grad` of the reference's, and its float64 gradient
     under `jax.enable_x64`), for the port as it is and for a variant
     whose self blocks' attention core (scores, softmax, P.V and their
     backward) runs in float64, its output rounded once to float32 (the
     causal cores of `models.layers.gqa_scores_apply`, swapped in this
     process only), and for two variants whose first self block's whole
     attention half (its norm, the Q/K/V and output projections and the
     core, forward and backward) runs in float64: (a) its output rounded
     once to float32 and added to the float32 residual, (b) added to the
     residual in float64 and the sum rounded once (`T._self_block`
     swapped in this process only): shares against float64 and against
     the reference's float32 gradient.
The blocks of 1-3 run one by one here (each package's block functions),
so the reference's float32 numbers there differ slightly from its
scanned, jitted `loss_fn`'s, which 4 uses.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import VLMSpec as JVLMSpec
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import VLMSpec, get_config
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCH, LAYERS, CROSS_EVERY, N_PATCHES, D_VISION = (
    "llama-3.2-vision-11b", 6, 3, 16, 192)


def share(got, want) -> float:
    bound = 1e-4 * np.abs(want) + 1e-6 * max(1.0, float(np.abs(want).max()))
    return float((np.abs(got - want) / bound).max())


def main() -> None:
    torch.set_num_threads(2)
    spec = dict(cross_every=CROSS_EVERY, n_patches=N_PATCHES,
                d_vision=D_VISION)
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), n_layers=LAYERS,
                               vlm=JVLMSpec(**spec))
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=LAYERS,
                              vlm=VLMSpec(**spec))
    jp = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    gate = jp["cross_blocks"]["gate"]
    jp["cross_blocks"]["gate"] = (0.5 + np.random.default_rng(7).random(
        gate.shape)).astype(np.float32)
    toks = np.random.default_rng(0).integers(0, 512, (2, 13))
    patches = (0.1 * np.random.default_rng(1).standard_normal(
        (2, N_PATCHES, D_VISION))).astype(np.float32)
    tok_in, tgt = toks[:, :-1], toks[:, 1:]
    B, S = tok_in.shape
    n_self = CROSS_EVERY - 1

    def j_stages(params, dtype):
        """[(name, x -> x)] of the blocks in order, and the head x ->
        loss, in `dtype`."""
        pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
        mem = jnp.asarray(patches, dtype)
        out = []
        for g in range(LAYERS // CROSS_EVERY):
            for j in range(n_self):
                i = g * n_self + j
                bp = jax.tree.map(lambda a, i=i: a[i], params["blocks"])
                out.append((f"self {i}", lambda x, bp=bp: JT._self_block(
                    jcfg, bp, x, pos)))
            cb = jax.tree.map(lambda a, g=g: a[g], params["cross_blocks"])
            out.append((f"cross {g}", lambda x, cb=cb: JT._cross_block(
                jcfg, cb, x, mem)))

        def head(x):
            logp = jax.nn.log_softmax(JT._unembed(jcfg, params, x), -1)
            return -jnp.mean(jnp.take_along_axis(
                logp, jnp.asarray(tgt)[..., None], -1))
        return out, head

    def j_cotangents(dtype):
        params = jax.tree.map(lambda a: jnp.asarray(a, dtype), jp)
        stages, head = j_stages(params, dtype)
        x = params["embed"][jnp.asarray(tok_in)]
        xs = [x]
        for _, f in stages:
            x = jax.jit(f)(x)
            xs.append(x)
        ct = jax.grad(head)(x)
        cts = [ct]
        for (_, f), xin in zip(reversed(stages), reversed(xs[:-1])):
            ct = jax.vjp(f, xin)[1](ct)[0]
            cts.append(ct)
        return [np.asarray(c, np.float64) for c in reversed(cts)], xs

    with jax.enable_x64(True):
        c64, _ = j_cotangents(jnp.float64)
    c32, x32 = j_cotangents(jnp.float32)

    params = interop.lm_params(jp, torch.device("cpu"))
    pos = torch.arange(S)[None].expand(B, S)
    mem = torch.from_numpy(patches)
    stages = []
    for g, (selfs, cb) in enumerate(T._cross_groups(cfg, params)):
        for j, bp in enumerate(selfs):
            stages.append((f"self {g * n_self + j}", lambda x, bp=bp:
                           T._self_block(cfg, bp, x, pos, False)[0]))
        stages.append((f"cross {g}", lambda x, cb=cb:
                       T._cross_block(cfg, cb, x, mem)))
    x = params["embed"][torch.as_tensor(tok_in)].detach().requires_grad_()
    xs, h = [x], x
    for _, f in stages:
        h = f(h)
        h.retain_grad()
        xs.append(h)
    torch.mean(T.token_nll(T._unembed(cfg, params, h),
                           torch.as_tensor(tgt))).backward()
    cp = [t.grad.double().numpy() for t in xs]

    names = [n for n, _ in stages] + ["head"]
    print("1. cotangent at each input: port/f64, reference f32/f64, "
          "port/reference f32")
    for i, n in enumerate(names):
        print(f"   input of {n:8s} {share(cp[i], c64[i]):.3f} "
              f"{share(c32[i], c64[i]):.3f} {share(cp[i], c32[i]):.3f}")

    def local(label, f64, f32, fp, xin, ct):
        """One stage's VJP on float32 `xin` and cotangent `ct`."""
        xin, ct = np.asarray(xin, np.float32), np.asarray(ct, np.float32)
        want = np.asarray(jax.vjp(f64, jnp.asarray(xin, jnp.float64))[1](
            jnp.asarray(ct, jnp.float64))[0])
        ref = np.asarray(jax.vjp(jax.jit(f32), jnp.asarray(xin))[1](
            jnp.asarray(ct))[0], np.float64)
        xt = torch.tensor(xin, requires_grad=True)
        fp(xt).backward(torch.from_numpy(ct))
        got = xt.grad.double().numpy()
        print(f"   {label:12s} {share(got, want):.3f} {share(ref, want):.3f} "
              f"{share(got, ref):.3f}")

    print("2. each block's own backward: port/f64, reference f32/f64, "
          "port/reference f32")
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
        p32 = jax.tree.map(jnp.asarray, jp)
        s64, _ = j_stages(p64, jnp.float64)
        s32, _ = j_stages(p32, jnp.float32)
        for k, ((name, f64), (_, f32), (_, fp)) in enumerate(
                zip(s64, s32, stages)):
            local(name, f64, f32, fp, x32[k], c64[k + 1])

        print("3. the first self block's parts: port/f64, reference "
              "f32/f64, port/reference f32")
        heads = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                     head_dim=cfg.hd, theta=cfg.rope_theta)
        jpos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
        bp = T._cross_groups(cfg, params)[0][0][0]

        def j_parts(params):
            jb = jax.tree.map(lambda a: a[0], params["blocks"])
            norm = lambda x: JL.apply_norm(jb["attn_norm"], x, "rms")  # noqa
            core = lambda h: JL.self_attention(  # noqa
                jb["attn"], h, jpos, **heads)
            return {"attn half": lambda x: x + core(norm(x)),
                    "mlp half": lambda x: x + JL.mlp(
                        jb["mlp"], JL.apply_norm(jb["mlp_norm"], x, "rms")),
                    "attn norm": norm, "attn core": core}
        norm = lambda x: L.apply_norm(bp["attn_norm"], x, "rms")  # noqa
        core = lambda h: L.self_attention(  # noqa
            bp["attn"], h, pos, use_kernel=False, **heads)
        port = {"attn half": lambda x: x + core(norm(x)),
                "mlp half": lambda x: x + L.mlp(
                    bp["mlp"], L.apply_norm(bp["mlp_norm"], x, "rms")),
                "attn norm": norm, "attn core": core}
        f64, f32 = j_parts(p64), j_parts(p32)
        x0 = np.asarray(x32[0], np.float32)
        xm = np.asarray(f64["attn half"](jnp.asarray(x0, jnp.float64)),
                        np.float32)
        ct_m = c64[1]
        ct_a = np.asarray(jax.vjp(f64["mlp half"], jnp.asarray(
            xm, jnp.float64))[1](jnp.asarray(ct_m))[0])
        hn = np.asarray(f64["attn norm"](jnp.asarray(x0, jnp.float64)),
                        np.float32)
        ct_n = np.asarray(jax.vjp(f64["attn core"], jnp.asarray(
            hn, jnp.float64))[1](jnp.asarray(ct_a))[0])
        inputs = {"attn half": (x0, ct_a), "mlp half": (xm, ct_m),
                  "attn norm": (x0, ct_n), "attn core": (hn, ct_a)}
        for name, (xin, ct) in inputs.items():
            print(f"   max|input| {np.abs(xin).max():.3g}:", end="")
            local(name, f64[name], f32[name], port[name], xin, ct)


    whole_gradient(jcfg, cfg, jp, toks, patches)


def float64_causal_core(q, k, v, mask, impl="grouped",
                        softmax_dtype=torch.float32):
    """`gqa_scores_apply` with a masked (causal) core in float64: q, k, v
    widened, scores, softmax and P.V in float64 (their backward too), the
    output rounded once to q's dtype.  Unmasked cores (the cross blocks)
    are the plain float32 expression."""
    if mask is None:
        return _GQA(q, k, v, mask, impl, softmax_dtype)
    return _GQA(q.double(), k.double(), v.double(), mask, impl,
                torch.float64).to(q.dtype)


_GQA = L.gqa_scores_apply
_SELF_BLOCK = T._self_block


def _float64(tree):
    if isinstance(tree, dict):
        return {k: _float64(v) for k, v in tree.items()}
    return tree.double()


def float64_attention_half(w0: torch.Tensor, residual_f64: bool):
    """`T._self_block` with the attention half of the block whose query
    projection equals `w0` (self block 0) in float64: its norm, the
    Q/K/V and output projections and the core (scores, softmax and P.V
    in float64), forward and backward; the half's output is rounded once,
    before the float32 residual add (`residual_f64` False) or with it,
    the residual added in float64 (True).  Every other block, and the
    prefill's block, is the port's."""
    def block(cfg, bp, x, positions, use_kernel, return_kv=False,
              causal=True):
        if return_kv or not torch.equal(bp["attn"]["wq"], w0):
            return _SELF_BLOCK(cfg, bp, x, positions, use_kernel, return_kv,
                               causal)
        h = L.apply_norm(_float64(bp["attn_norm"]), x.double(), cfg.norm)
        attn = L.self_attention(
            _float64(bp["attn"]), h, positions, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, theta=cfg.rope_theta,
            causal=causal, window=cfg.sliding_window if causal else None,
            use_kernel=False, impl=cfg.attn_impl,
            softmax_dtype=torch.float64)
        x = ((x.double() + attn).to(x.dtype) if residual_f64
             else x + attn.to(x.dtype))
        h = L.apply_norm(bp["mlp_norm"], x, cfg.norm)
        y, aux = T._ffn(cfg, bp, h)
        return x + y, aux, None
    return block


def whole_gradient(jcfg, cfg, jp, toks, patches) -> None:
    """Section 4: the embedding leaf of the whole gradient."""
    tokens = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in tokens.items()}
    jb["patches"] = jnp.asarray(patches)
    b = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in tokens.items()}
    b["patches"] = torch.from_numpy(patches)
    _, j32 = jax.jit(jax.value_and_grad(
        lambda q, bb: (JT.loss_fn(jcfg, q, bb)[0],
                       JT.forward_train(jcfg, q, bb)[0]),
        has_aux=True))(jp, jb)
    j32 = np.asarray(j32["embed"], np.float64)
    with jax.enable_x64(True):
        to64 = lambda a: (jnp.asarray(np.asarray(a), jnp.float64)  # noqa
                          if np.asarray(a).dtype == np.float32 else a)
        g64 = np.asarray(jax.jit(jax.grad(lambda q, bb: JT.loss_fn(
            jcfg, q, bb, compute_dtype=jnp.float64)[0]))(
                jax.tree.map(to64, jp), jax.tree.map(to64, jb))["embed"])
    params = interop.lm_params(jp, torch.device("cpu"))
    print("4. the embedding leaf of the whole gradient: against the "
          "reference's float64, against its float32")
    print(f"   reference float32      {share(j32, g64):.3f}")
    w0 = params["blocks"]["attn"]["wq"][0]
    for label, core, block in (
            ("port", _GQA, _SELF_BLOCK),
            ("port, f64 self cores", float64_causal_core, _SELF_BLOCK),
            ("port, f64 attn half 0 (a)", _GQA,
             float64_attention_half(w0, residual_f64=False)),
            ("port, f64 attn half 0 (b)", _GQA,
             float64_attention_half(w0, residual_f64=True))):
        L.gqa_scores_apply, T._self_block = core, block
        try:
            _, _, grads = steps.value_and_grad(
                lambda q: T.loss_fn(cfg, q, b), params)
        finally:
            L.gqa_scores_apply, T._self_block = _GQA, _SELF_BLOCK
        got = grads["embed"].double().numpy()
        print(f"   {label:26s} {share(got, g64):.3f} {share(got, j32):.3f}"
              f" (|port - reference f32| {np.linalg.norm(got - j32):.3e})",
              flush=True)


if __name__ == "__main__":
    main()
